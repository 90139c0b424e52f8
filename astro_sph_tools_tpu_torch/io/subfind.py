"""EAGLE SUBFIND catalogue backend.

Parity target: ``CatalogueSUBFIND``
(`astro_sph_tools/io/EAGLE/_CatalogueSUBFIND.py`):
operates over two multi-file HDF5 sets — membership
(``eagle_subfind_particles_*``) and properties (``eagle_subfind_tab_*``) —
with per-file offset tables from ``NumPart_ThisFile`` / ``FOF.Ngroups``
cumulative sums (`:66-104`), a mismatched ``TotNgroups`` tolerated with a
warning (`:97-99`), per-type "FOF group contains particle type" masks
(`:111-137`, skipped in ``LimitedMode``), FOF field access with h/a/CGS
attrs (`:334-386`), and per-snapshot-particle halo maps via ID-matched
reordering (`:287-308`).

Fixes vs reference: the ``get_halo_masses``/``get_halo_radii`` isinstance
ladder tested ``CriticalSphericalOverdensityAperture`` three times, crashing
for Mean/TopHat definitions (`:236-246,270-277`, SURVEY.md §2.9.6) — here
each flavour maps to its own field specifier (Crit/Mean/TopHat). The
root-gather ``mpi_gather_array`` all-ranks variants give every rank the
whole array (see :func:`_allgather_concat`).

Counterpart: ``astro_sph_tools_tpu/io/subfind.py`` (copied; ``h5py`` is
imported on first use; the cross-process gather runs over
``torch.distributed`` and, unlike the JAX package's, lets its errors
through).
"""

from __future__ import annotations

import glob
from typing import Optional

from ._lazy import h5py
import numpy as np

from ..data_structures.particle_types import ParticleType
from ..ops.reorder import ArrayReorder
from ..units import UnitArray
from ..utils.console import Stopwatch, print_debug, print_verbose_info, print_warning, settings
from .catalogue import (
    BasicHaloDefinitions,
    CatalogueBase,
    CriticalSphericalOverdensityAperture,
    FOFGroup,
    IHaloDefinition,
    MeanSphericalOverdensityAperture,
    SphericalOverdensityAperture,
    TopHatSphericalOverdensityAperture,
)
from .eagle import EAGLE_MAX_GROUP_NUMBER, SnapshotEAGLE

_SUPPORTED_MASS_DEFS = (
    BasicHaloDefinitions.FOF_GROUP.value,
    BasicHaloDefinitions.SO_200_CRIT.value,
    BasicHaloDefinitions.SO_500_CRIT.value,
    BasicHaloDefinitions.SO_2500_CRIT.value,
    BasicHaloDefinitions.SO_200_MEAN.value,
    BasicHaloDefinitions.SO_500_MEAN.value,
    BasicHaloDefinitions.SO_2500_MEAN.value,
    BasicHaloDefinitions.SO_200_TOP_HAT.value,
)
_SUPPORTED_RADIUS_DEFS = _SUPPORTED_MASS_DEFS[1:]


def _so_field_specifier(halo_type: SphericalOverdensityAperture) -> str:
    """Crit/Mean/TopHat field-name component — the corrected ladder."""
    if isinstance(halo_type, CriticalSphericalOverdensityAperture):
        return "Crit"
    if isinstance(halo_type, MeanSphericalOverdensityAperture):
        return "Mean"
    if isinstance(halo_type, TopHatSphericalOverdensityAperture):
        return "TopHat"
    raise RuntimeError("Unreachable: unknown spherical-overdensity flavour.")


def _discover_files(first_path: str) -> list[str]:
    stem, _, ext = first_path.rsplit(".", 2)[0], None, first_path.rsplit(".", 1)[1]
    return sorted(
        glob.glob(f"{glob.escape(stem)}.*.{ext}"),
        key=lambda p: int(p.rsplit(".", 2)[1]),
    )


class CatalogueSUBFIND(CatalogueBase):
    """EAGLE SUBFIND FOF-group catalogue reader."""

    LimitedMode: bool = False  # skip the per-type membership scan (`:29,38-39`)

    def __init__(
        self,
        membership_filepaths,
        properties_filepaths,
        snapshot: SnapshotEAGLE,
    ) -> None:
        watch = Stopwatch("CatalogueSUBFIND.__init__") if settings.debug else None
        if isinstance(membership_filepaths, str):
            membership_filepaths = _discover_files(membership_filepaths)
        if isinstance(properties_filepaths, str):
            properties_filepaths = _discover_files(properties_filepaths)
        self._membership_files = list(membership_filepaths)
        self._properties_files = list(properties_filepaths)

        # per-file particle offsets from NumPart_ThisFile (`:66-76`)
        counts = []
        for path in self._membership_files:
            with h5py.File(path, "r") as f:
                counts.append(np.asarray(f["Header"].attrs["NumPart_ThisFile"], dtype=np.int64))
        self._membership_counts = np.asarray(counts)  # (n_files, 6)
        self._membership_offsets = np.concatenate(
            [np.zeros((1, 6), np.int64), np.cumsum(self._membership_counts, axis=0)]
        )
        if watch:
            watch.lap("membership offsets")

        # per-file group offsets from FOF.Ngroups (`:86-104`)
        group_counts = []
        tot_from_header = None
        for path in self._properties_files:
            with h5py.File(path, "r") as f:
                group_counts.append(int(f["FOF"].attrs["Ngroups"]) if "FOF" in f else 0)
                if tot_from_header is None and "TotNgroups" in f["Header"].attrs:
                    tot_from_header = int(f["Header"].attrs["TotNgroups"])
        self._group_counts = np.asarray(group_counts, dtype=np.int64)
        self._group_offsets = np.concatenate([[0], np.cumsum(self._group_counts)])
        self._n_total_FOF_groups = int(self._group_offsets[-1])
        if tot_from_header is not None and tot_from_header != self._n_total_FOF_groups:
            # tolerated with a warning (`:97-99`)
            print_warning(
                f"SUBFIND TotNgroups header ({tot_from_header}) does not match the "
                f"sum of per-file Ngroups ({self._n_total_FOF_groups}); using the sum."
            )
        if watch:
            watch.lap("group offsets")

        # per-type group-contains-type masks from membership GroupNumber (`:111-137`)
        self._groups_containing: dict[Optional[ParticleType], np.ndarray] = {
            None: np.ones(self._n_total_FOF_groups, dtype=bool)
        }
        self._n_haloes: dict[Optional[ParticleType], int] = {None: self._n_total_FOF_groups}
        if not CatalogueSUBFIND.LimitedMode:
            for pt in ParticleType.get_all():
                try:
                    gn, *_ = self.get_membership_field(pt, "GroupNumber", np.int32)
                    present = np.zeros(self._n_total_FOF_groups, dtype=bool)
                    bound = (gn > 0) & (gn < EAGLE_MAX_GROUP_NUMBER)
                    idx = gn[bound].astype(np.int64) - 1
                    idx = idx[idx < self._n_total_FOF_groups]
                    present[idx] = True
                except (OSError, KeyError):
                    # missing particle type -> all-False mask (`:124-132`)
                    present = np.zeros(self._n_total_FOF_groups, dtype=bool)
                self._groups_containing[pt] = present
                self._n_haloes[pt] = int(present.sum())
            if watch:
                watch.lap("membership scan")

        super().__init__(
            membership_filepath=self._membership_files[0],
            properties_filepath=self._properties_files[0],
            snapshot=snapshot,
        )

    # -- raw access (`:334-386`) -----------------------------------------------
    def get_membership_field(
        self, particle_type: ParticleType, field: str, dtype=np.float64
    ) -> tuple[np.ndarray, float, float, float]:
        """Concatenate a membership dataset over files + its unit attrs."""
        print_verbose_info(
            f'Reading catalogue membership {particle_type.display_name} particle dataset "{field}".'
        )
        parts = []
        attrs = (0.0, 0.0, 1.0)
        for path in self._membership_files:
            with h5py.File(path, "r") as f:
                key = f"{particle_type.common_hdf5_name}/{field}"
                if key in f:
                    parts.append(np.asarray(f[key], dtype=dtype))
                    a = f[key].attrs
                    attrs = (
                        float(a.get("h-scale-exponent", 0.0)),
                        float(a.get("aexp-scale-exponent", 0.0)),
                        float(a.get("CGSConversionFactor", 1.0)),
                    )
        if not parts:
            raise KeyError(f"{particle_type.common_hdf5_name}/{field}")
        return np.concatenate(parts, axis=0), *attrs

    def get_FOF_field(
        self, field: str, dtype=np.float64, particle_type: Optional[ParticleType] = None
    ) -> tuple[np.ndarray, float, float, float]:
        """Concatenate a FOF group dataset over property files; rows filtered
        by the contains-particle-type mask (`:363-386`)."""
        parts = []
        attrs = (0.0, 0.0, 1.0)
        for path in self._properties_files:
            with h5py.File(path, "r") as f:
                key = f"FOF/{field}"
                if key in f:
                    parts.append(np.asarray(f[key], dtype=dtype))
                    a = f[key].attrs
                    attrs = (
                        float(a.get("h-scale-exponent", 0.0)),
                        float(a.get("aexp-scale-exponent", 0.0)),
                        float(a.get("CGSConversionFactor", 1.0)),
                    )
        if not parts:
            raise KeyError(f"FOF/{field}")
        data = np.concatenate(parts, axis=0)
        mask = self._groups_containing.get(particle_type)
        if particle_type is not None:
            if CatalogueSUBFIND.LimitedMode:
                raise RuntimeError(
                    "CatalogueSUBFIND object in limited mode - unable to use particle "
                    "type arguments other than None."
                )
            data = data[mask]
        return data, *attrs

    # -- hierarchy: FOF groups are flat (`:194-199`) -----------------------------
    def _get_hierarchy_IDs(self) -> tuple[np.ndarray, np.ndarray]:
        ids = self.get_halo_IDs()
        return ids, np.full_like(ids, -1)

    # -- halo API -----------------------------------------------------------------
    def get_number_of_haloes(self, particle_type: Optional[ParticleType] = None) -> int:
        if CatalogueSUBFIND.LimitedMode and particle_type is not None:
            raise RuntimeError(
                "CatalogueSUBFIND object in limited mode - unable to use particle "
                "type arguments other than None."
            )
        return self._n_haloes[particle_type]

    def get_halo_IDs(self, particle_type: Optional[ParticleType] = None) -> np.ndarray:
        # FOF group numbers are indexes + 1 (`:186-188`)
        return self.get_halo_indexes(particle_type) + 1

    def get_halo_indexes(self, particle_type: Optional[ParticleType] = None) -> np.ndarray:
        if CatalogueSUBFIND.LimitedMode and particle_type is not None:
            raise RuntimeError(
                "CatalogueSUBFIND object in limited mode - unable to use particle "
                "type arguments other than None."
            )
        return np.arange(self._n_total_FOF_groups, dtype=np.int64)[
            self._groups_containing[particle_type]
        ]

    def get_halo_parent_IDs(self, particle_type: Optional[ParticleType] = None) -> np.ndarray:
        raise NotImplementedError("FOF groups in EAGLE SUBFIND catalogues have no parent structure.")

    def get_halo_parent_indexes(self, particle_type: Optional[ParticleType] = None) -> np.ndarray:
        raise NotImplementedError("FOF groups in EAGLE SUBFIND catalogues have no parent structure.")

    def get_halo_top_level_parent_IDs(self, particle_type=None) -> np.ndarray:
        return self.get_halo_IDs(particle_type)

    def get_halo_top_level_parent_indexes(self, particle_type=None) -> np.ndarray:
        return self.get_halo_indexes(particle_type)

    def get_halo_centres_of_mass(self, particle_type=None, use_proper_units=False) -> UnitArray:
        raise NotImplementedError("No centre of mass data in SUBFIND catalogues.")

    def get_halo_centres_of_potential(self, particle_type=None, use_proper_units=False) -> UnitArray:
        data, h_exp, a_exp, cgs = self.get_FOF_field(
            "GroupCentreOfPotential", np.float64, particle_type
        )
        return self.snapshot.make_cgs_data(
            "cm", data, h_exp=h_exp, cgs_conversion_factor=cgs,
            a_exp=a_exp if use_proper_units else 0,
        ).to("Mpc")

    def get_halo_masses(
        self, halo_type: IHaloDefinition, particle_type: Optional[ParticleType] = None
    ) -> UnitArray:
        if halo_type not in _SUPPORTED_MASS_DEFS:
            raise halo_type.make_error(CatalogueSUBFIND)
        if isinstance(halo_type, FOFGroup):
            field_name = "GroupMass"
        else:
            spec = _so_field_specifier(halo_type)
            field_name = f"Group_M_{spec}{halo_type.overdensity_limit}"
        data, h_exp, _, cgs = self.get_FOF_field(field_name, np.float64, particle_type)
        return self.snapshot.make_cgs_data(
            "g", data, h_exp=h_exp, cgs_conversion_factor=cgs
        ).to("Msun")

    def get_halo_radii(
        self,
        halo_type: IHaloDefinition,
        particle_type: Optional[ParticleType] = None,
        use_proper_units: bool = False,
    ) -> UnitArray:
        if halo_type not in _SUPPORTED_RADIUS_DEFS:
            raise halo_type.make_error(CatalogueSUBFIND)
        spec = _so_field_specifier(halo_type)
        field_name = f"Group_R_{spec}{halo_type.overdensity_limit}"
        data, h_exp, a_exp, cgs = self.get_FOF_field(field_name, np.float64, particle_type)
        return self.snapshot.make_cgs_data(
            "cm", data, h_exp=h_exp, cgs_conversion_factor=cgs,
            a_exp=a_exp if use_proper_units else 0,
        ).to("Mpc")

    # -- per-snapshot-particle maps (`:287-308`) -----------------------------------
    def get_halo_IDs_by_snapshot_particle(
        self, particle_type: ParticleType, snapshot_particle_ids: Optional[np.ndarray] = None
    ) -> np.ndarray:
        group_numbers = self.snapshot.get_group_ID(
            particle_type=particle_type, include_nearby_unattached_particles=False
        )
        if snapshot_particle_ids is None:
            return group_numbers.astype(np.int64)
        result = ArrayReorder.create(
            self.snapshot.get_IDs(particle_type), snapshot_particle_ids
        )(group_numbers.astype(np.int64), default_value=EAGLE_MAX_GROUP_NUMBER)
        print_debug("Done reordering.")
        return result

    def get_halo_indexes_by_snapshot_particle(
        self, particle_type: ParticleType, snapshot_particle_ids: Optional[np.ndarray] = None
    ) -> np.ndarray:
        numbers = self.get_halo_IDs_by_snapshot_particle(particle_type, snapshot_particle_ids)
        numbers = np.where(numbers == EAGLE_MAX_GROUP_NUMBER, 0, numbers)
        return numbers - 1

    def get_halo_IDs_by_all_snapshot_particles(
        self, particle_type: ParticleType, snapshot_particle_ids: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """All-process concatenation of the per-particle halo map.

        The reference root-gathers with ``mpi_gather_array`` (non-root gets
        None, `:304-308`); here every process would receive the full array
        (:func:`_allgather_concat` over the default process group).
        """
        local = self.get_halo_IDs_by_snapshot_particle(particle_type, snapshot_particle_ids)
        return _allgather_concat(local)

    def get_halo_indexes_by_all_snapshot_particles(
        self, particle_type: ParticleType, snapshot_particle_ids: Optional[np.ndarray] = None
    ) -> np.ndarray:
        local = self.get_halo_indexes_by_snapshot_particle(particle_type, snapshot_particle_ids)
        return _allgather_concat(local)

    def get_particle_IDs(
        self, particle_type: ParticleType, include_unbound: bool = True
    ) -> np.ndarray:
        if not include_unbound:
            raise NotImplementedError("include_unbound param not supported for EAGLE data.")
        return self.get_membership_field(particle_type, "ParticleIDs", np.int64)[0]


def _allgather_concat(local: np.ndarray) -> np.ndarray:
    """Concatenate a per-process array across all processes, in rank order.

    Gathers over the default ``torch.distributed`` group when it is
    initialised with more than one rank (``all_gather_object``, which both
    the gloo and the NCCL backends take); otherwise the local array is the
    whole array. A failure of the gather propagates.
    """
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return local
    parts: list = [None] * dist.get_world_size()
    dist.all_gather_object(parts, np.asarray(local))
    return np.concatenate(parts)
