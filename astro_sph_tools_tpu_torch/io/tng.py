"""IllustrisTNG snapshot + group-catalogue backend — pure h5py.

Parity target: ``SnapshotTNG``
(`astro_sph_tools/io/TNG/_SnapshotTNG.py`), with the
``illustris_python`` dependency replaced by direct multi-file reads
(``snapdir_NNN/snap_NNN.K.hdf5``):

- header attrs use TNG names: Time (= a), BoxSize in ckpc/h, MassTable in
  1e10 Msun/h (`_SnapshotTNG.py:75-93`);
- unit conventions are fixed by the format (files carry no per-field attrs):
  lengths ckpc/h (h_scaling -1, a_scaling 1), masses 1e10 Msun/h
  (h_scaling -1), velocities km sqrt(a)/s, density = mass/length^3
  (`_SnapshotTNG.py:104`);
- solar metallicity constant 0.0127 (`_SnapshotTNG.py:103`);
- smoothing lengths from ``SubfindHsml`` (`:224-225`); metallicity
  ``GFM_Metallicity``; abundances as columns of ``GFM_Metals`` (`:282-330`);
- **temperature derived from internal energy**: mu = 4 m_p / (1 + 3 X_H +
  4 X_H x_e), T = (gamma - 1) * u * mu / k_B with gamma = 5/3 and u
  converted from (km/s)^2 via 1e10 (`:332-346`).

``CatalogueTNG`` is written from scratch (the reference's TNG catalogue file
is a byte-identical copy of the snapshot module — broken, SURVEY.md §2.9.3):
``groups_NNN/fof_subhalo_tab_NNN.K.hdf5`` with Group fields (GroupPos,
GroupMass, Group_M/R_Crit200/500/Mean200/TopHat200, GroupLenType) and
per-particle membership derived from the cumulative ``GroupLenType`` offsets
(TNG snapshots store particles sorted by FOF group).

Counterpart: ``astro_sph_tools_tpu/io/tng.py`` (copied; ``h5py`` is imported
on first use). One fault of the copy is not carried over: without
``ElectronAbundance``, :meth:`SnapshotTNG.get_temperatures` raises
:class:`SnapshotFormatError` instead of assuming x_e = 0.
"""

from __future__ import annotations

import glob
import re
from typing import Optional

from ._lazy import h5py
import numpy as np

from .. import constants as C
from ..data_structures.particle_types import ParticleType
from ..units import UnitArray, unit_array
from .catalogue import (
    CatalogueBase,
    CriticalSphericalOverdensityAperture,
    FOFGroup,
    IHaloDefinition,
    MeanSphericalOverdensityAperture,
    SphericalOverdensityAperture,
    TopHatSphericalOverdensityAperture,
)
from .errors import SnapshotFormatError
from .snapshot import SnapshotBase

TNG_SOLAR_METALLICITY = C.TNG_SOLAR_METALLICITY  # 0.0127
GAMMA = 5.0 / 3.0

# GFM_Metals column order
TNG_ELEMENT_ORDER = ("H", "He", "C", "N", "O", "Ne", "Mg", "Si", "Fe")

_TNG_PATTERN = re.compile(
    r".*snapdir_(?P<number>\d{3})[\\/]snap_(?P=number)\.(?P<index>\d+)\.hdf5$"
)


class SnapshotTNG(SnapshotBase):
    """Multi-file TNG snapshot reader."""

    def __init__(self, filepath: str, process_index: int = 0, n_processes: int = 1) -> None:
        m = _TNG_PATTERN.match(filepath)
        if not m:
            raise SnapshotFormatError(
                f'Snapshot filepath "{filepath}" does not conform to the TNG naming '
                "scheme snapdir_NNN/snap_NNN.K.hdf5."
            )
        number = m.group("number")
        stem = filepath.rsplit(".", 2)[0]
        self._file_paths = sorted(
            glob.glob(f"{glob.escape(stem)}.*.hdf5"),
            key=lambda p: int(p.rsplit(".", 2)[1]),
        )
        self._my_files = self._file_paths[process_index::n_processes]

        with h5py.File(self._file_paths[0], "r") as f:
            hdr = f["Header"].attrs
            redshift = float(hdr["Redshift"])
            hubble = float(hdr["HubbleParam"])
            a = float(hdr["Time"])
            omega_b = float(hdr.get("OmegaBaryon", 0.0486))
            self._num_part_total = np.asarray(hdr["NumPart_Total"], dtype=np.int64)
            self._box_ckpc_h = float(hdr["BoxSize"])
            self._mass_table = np.asarray(hdr["MassTable"], dtype=np.float64)

        self._per_file_counts = np.zeros((len(self._file_paths), 6), dtype=np.int64)
        for i, path in enumerate(self._file_paths):
            with h5py.File(path, "r") as f:
                self._per_file_counts[i] = np.asarray(
                    f["Header"].attrs["NumPart_ThisFile"], dtype=np.int64
                )

        #: per type: global (start, stop) particle-row range restriction, or
        #: absent for whole-snapshot reads (illustris loadHalo-style cutouts)
        self._row_ranges: dict[ParticleType, tuple[int, int]] = {}

        box_mpc = self._box_ckpc_h / hubble / 1.0e3  # ckpc/h -> comoving Mpc
        super().__init__(
            filepath=filepath,
            number=number,
            redshift=redshift,
            hubble_param=hubble,
            omega_baryon=omega_b,
            expansion_factor=a,
            box_size=unit_array(np.full(3, box_mpc), "Mpc"),
            tracked_elements=TNG_ELEMENT_ORDER,
            snipshot=False,
        )

    # -- unit helpers (format-fixed conventions) -------------------------------
    def _length_mpc(self, data_ckpc_h: np.ndarray) -> np.ndarray:
        return data_ckpc_h / self.h / 1.0e3

    def _mass_msun(self, data_1e10_h: np.ndarray) -> np.ndarray:
        return data_1e10_h / self.h * 1.0e10

    # -- counts -----------------------------------------------------------------
    def _get_number_of_particles(self) -> dict[ParticleType, int]:
        return {pt: int(self._num_part_total[pt.value]) for pt in ParticleType.get_all()}

    def _file_row_overlaps(self, particle_type: ParticleType):
        """Yield ``(path, local_lo, local_hi, global_lo)`` for every
        this-process file slice an active row restriction selects (whole
        files when unrestricted). The single source of truth walked by
        reads, counts, and global-row-index queries — keeping them in
        lockstep by construction."""
        rng = self._row_ranges.get(particle_type)
        my = set(self._my_files)
        file_start = 0
        for i, path in enumerate(self._file_paths):
            n_i = int(self._per_file_counts[i, particle_type.value])
            file_end = file_start + n_i
            if path in my and n_i > 0:
                if rng is None:
                    yield path, 0, n_i, file_start
                else:
                    lo = max(rng[0], file_start) - file_start
                    hi = min(rng[1], file_end) - file_start
                    if hi > lo:
                        yield path, lo, hi, file_start + lo
            file_start = file_end

    def global_row_indexes(self, particle_type: ParticleType) -> np.ndarray:
        """Global snapshot row index of each particle this process's reads
        return (honouring any active row restriction) — the coordinate the
        GroupLenType membership offsets are defined in."""
        parts = [
            np.arange(g_lo, g_lo + (hi - lo), dtype=np.int64)
            for _, lo, hi, g_lo in self._file_row_overlaps(particle_type)
        ]
        if not parts:
            return np.empty((0,), dtype=np.int64)
        return np.concatenate(parts)

    def _get_number_of_particles_this_rank(self) -> dict[ParticleType, int]:
        return {
            pt: sum(
                hi - lo for _, lo, hi, _ in self._file_row_overlaps(pt)
            )
            for pt in ParticleType.get_all()
        }

    # -- row-range restriction (illustris loadHalo-style cutouts) ----------------
    def restrict_to_row_ranges(
        self, ranges: dict[ParticleType, tuple[int, int]]
    ) -> None:
        """Restrict subsequent reads to global particle-row ranges.

        TNG snapshots store particles in FoF-group order (members of group
        0 first, then group 1, ..., then the outer fuzz), so one halo's
        particles are a single contiguous slice per type — the layout
        illustris_python's ``snapshot.loadHalo`` exploits. With a range
        set, ``_read_dataset`` reads only the intersecting file slices:
        a halo cutout costs O(halo), not O(box). Use
        :meth:`CatalogueTNG.restrict_snapshot_to_halo` to derive ranges
        from GroupLenType offsets."""
        for pt, (start, stop) in ranges.items():
            if stop < start or start < 0:
                raise ValueError(f"invalid row range {(start, stop)} for {pt}")
        self._row_ranges = dict(ranges)
        self._update_number_of_particles()

    def clear_row_restriction(self) -> None:
        self._row_ranges = {}
        self._update_number_of_particles()

    # -- raw reads -----------------------------------------------------------------
    def _read_dataset(self, particle_type: ParticleType, field: str, dtype=np.float64, trailing=(), required: bool = False):
        parts = []
        n_groups = n_found = 0
        for path, lo, hi, _ in self._file_row_overlaps(particle_type):
            with h5py.File(path, "r") as f:
                key = f"{particle_type.common_hdf5_name}/{field}"
                if particle_type.common_hdf5_name in f:
                    n_groups += 1
                if key in f:
                    n_found += 1
                    parts.append(f[key][lo:hi])
        if 0 < n_found < n_groups:
            # a dataset present in SOME files only would silently
            # concatenate short and misalign against every other field
            # (schema-fuzz finding, round 5)
            raise SnapshotFormatError(
                f'Dataset "{field}" is present in only {n_found} of '
                f"{n_groups} {particle_type.common_hdf5_name} file groups "
                "of this snapshot."
            )
        if not parts:
            if required and n_groups:
                raise SnapshotFormatError(
                    f'Dataset "{field}" is missing from the '
                    f"{particle_type.common_hdf5_name} groups of this "
                    "snapshot's files."
                )
            return np.empty((0, *trailing), dtype=dtype)
        return np.concatenate(parts, axis=0)

    # -- field getters ----------------------------------------------------------------
    def _get_IDs(self, particle_type: ParticleType) -> np.ndarray:
        return self._read_dataset(particle_type, "ParticleIDs", np.int64).astype(np.int64)

    def _get_positions(self, particle_type, use_proper_units) -> UnitArray:
        pos = self._length_mpc(self._read_dataset(particle_type, "Coordinates", trailing=(3,)))
        if use_proper_units:
            pos = pos * self.a
        return unit_array(pos, "Mpc")

    def _get_velocities(self, particle_type, use_proper_units) -> UnitArray:
        # TNG stores km sqrt(a)/s; peculiar velocity = raw * sqrt(a)
        raw = self._read_dataset(particle_type, "Velocities", trailing=(3,))
        return unit_array(raw * np.sqrt(self.a), "km/s")

    def _get_masses(self, particle_type: ParticleType) -> UnitArray:
        table_mass = self._mass_table[particle_type.value]
        if table_mass > 0:
            n = self.number_of_particles_this_rank(particle_type)
            return unit_array(np.full(n, self._mass_msun(table_mass)), "Msun")
        return unit_array(self._mass_msun(self._read_dataset(particle_type, "Masses")), "Msun")

    def _get_black_hole_subgrid_masses(self) -> UnitArray:
        return unit_array(
            self._mass_msun(self._read_dataset(ParticleType.black_hole, "BH_Mass")), "Msun"
        )

    def _get_black_hole_dynamical_masses(self) -> UnitArray:
        return unit_array(
            self._mass_msun(self._read_dataset(ParticleType.black_hole, "Masses")), "Msun"
        )

    def _get_smoothing_lengths(self, particle_type, use_proper_units) -> UnitArray:
        h = self._length_mpc(self._read_dataset(particle_type, "SubfindHsml"))
        if use_proper_units:
            h = h * self.a
        return unit_array(h, "Mpc")

    def _get_sfr(self) -> UnitArray:
        return unit_array(
            self._read_dataset(ParticleType.gas, "StarFormationRate"), "Msun/yr"
        )

    def _get_metallicities(self, particle_type, solar_units, solar_metallicity) -> UnitArray:
        z = unit_array(
            self._read_dataset(particle_type, "GFM_Metallicity", required=True),
            "",
        )
        if not solar_units:
            return z
        return z / (solar_metallicity if solar_metallicity is not None else TNG_SOLAR_METALLICITY)

    @property
    def solar_metallicity(self) -> float:
        return TNG_SOLAR_METALLICITY

    def _get_mean_enrichment_redshift(self, particle_type: ParticleType) -> UnitArray:
        # TNG stores the formation scale factor for stars; not defined for gas
        raise NotImplementedError("TNG snapshots carry no metal-mass-weighted redshift field.")

    def _get_densities(self, particle_type, use_proper_units) -> UnitArray:
        # raw in 1e10 Msun/h / (ckpc/h)^3 -> Msun/Mpc^3 (comoving, h-free)
        raw = self._read_dataset(particle_type, "Density")
        rho = raw * 1.0e10 * self.h**2 * 1.0e9  # (Msun/h)/(ckpc^3/h^3) -> Msun/Mpc^3... see below
        # derivation: raw * (1e10 Msun/h) / (ckpc/h)^3 = raw * 1e10 * h^2 Msun/ckpc^3
        #           = raw * 1e10 * h^2 * 1e9 Msun/Mpc^3
        if use_proper_units:
            rho = rho / self.a**3
        return unit_array(rho, "Msun/Mpc**3")

    def _get_number_densities(
        self, particle_type, element, use_proper_units, default_abundance
    ) -> UnitArray:
        rho = self._get_densities(particle_type, use_proper_units).in_cgs().value
        if default_abundance is not None:
            abundance = default_abundance
        else:
            abundance = self._get_elemental_abundance(particle_type, element).value
        atomic_weight_g = C.ATOMIC_WEIGHTS[element] * C.ATOMIC_MASS_UNIT_CGS_REFERENCE
        return unit_array(rho * abundance / atomic_weight_g, "cm**-3")

    def _get_temperatures(self, particle_type: ParticleType) -> UnitArray:
        """T = (gamma - 1) * u * mu / k_B with mu = 4 m_p / (1 + 3 X_H + 4 X_H x_e)
        (`_SnapshotTNG.py:332-346`; u converted from (km/s)^2 with 1e10)."""
        u = self._read_dataset(particle_type, "InternalEnergy") * 1.0e10  # cm^2/s^2
        # no silent x_e = 0 when the dataset is absent (the JAX copy assumes
        # neutral gas there, which moves T by up to ~2x): a format error
        x_e = self._read_dataset(particle_type, "ElectronAbundance", required=True)
        metals = self._read_dataset(
            particle_type, "GFM_Metals", trailing=(len(TNG_ELEMENT_ORDER),)
        )
        x_h = metals[:, 0] if metals.size else np.full_like(u, C.PRIMORDIAL_HYDROGEN_ABUNDANCE)
        mu = 4.0 * C.PROTON_MASS_CGS / (1.0 + 3.0 * x_h + 4.0 * x_h * x_e)
        temperature = (GAMMA - 1.0) * u * mu / C.BOLTZMANN_CONSTANT_CGS
        return unit_array(temperature, "K")

    def _get_elemental_abundance(self, particle_type: ParticleType, element: str) -> UnitArray:
        if element not in TNG_ELEMENT_ORDER:
            raise ValueError(f'Element "{element}" not tracked in TNG snapshots.')
        metals = self._read_dataset(
            particle_type, "GFM_Metals", trailing=(len(TNG_ELEMENT_ORDER),)
        )
        return unit_array(metals[:, TNG_ELEMENT_ORDER.index(element)], "")


_TNG_GROUPCAT_PATTERN = re.compile(
    r".*groups_(?P<number>\d{3})[\\/]fof_subhalo_tab_(?P=number)\.(?P<index>\d+)\.hdf5$"
)


class CatalogueTNG(CatalogueBase):
    """TNG FOF group catalogue (written from scratch; see module docstring)."""

    _SO_FIELDS = {
        CriticalSphericalOverdensityAperture: "Crit",
        MeanSphericalOverdensityAperture: "Mean",
        TopHatSphericalOverdensityAperture: "TopHat",
    }

    def __init__(self, catalogue_filepath: str, snapshot: SnapshotTNG) -> None:
        m = _TNG_GROUPCAT_PATTERN.match(catalogue_filepath)
        if not m:
            raise SnapshotFormatError(
                f'Catalogue filepath "{catalogue_filepath}" does not conform to the '
                "TNG naming scheme groups_NNN/fof_subhalo_tab_NNN.K.hdf5."
            )
        stem = catalogue_filepath.rsplit(".", 2)[0]
        self._files = sorted(
            glob.glob(f"{glob.escape(stem)}.*.hdf5"),
            key=lambda p: int(p.rsplit(".", 2)[1]),
        )
        with h5py.File(self._files[0], "r") as f:
            self._n_groups_total = int(f["Header"].attrs["Ngroups_Total"])
        super().__init__(catalogue_filepath, catalogue_filepath, snapshot)
        self._len_type: Optional[np.ndarray] = None

    def _group_field(self, field: str, trailing=()):
        parts = []
        for path in self._files:
            with h5py.File(path, "r") as f:
                key = f"Group/{field}"
                if key in f:
                    parts.append(np.asarray(f[key]))
        if not parts:
            raise KeyError(f"Group/{field}")
        return np.concatenate(parts, axis=0)

    # -- hierarchy: FOF groups are flat --------------------------------------------
    def _get_hierarchy_IDs(self):
        ids = self.get_halo_IDs()
        return ids, np.full_like(ids, -1)

    def get_number_of_haloes(self, particle_type: Optional[ParticleType] = None) -> int:
        if particle_type is None:
            return self._n_groups_total
        lens = self._group_field("GroupLenType")
        return int((lens[:, particle_type.value] > 0).sum())

    def get_halo_IDs(self, particle_type=None) -> np.ndarray:
        return self.get_halo_indexes(particle_type) + 1

    def get_halo_indexes(self, particle_type=None) -> np.ndarray:
        idx = np.arange(self._n_groups_total, dtype=np.int64)
        if particle_type is None:
            return idx
        lens = self._group_field("GroupLenType")
        return idx[lens[:, particle_type.value] > 0]

    def get_halo_parent_IDs(self, particle_type=None) -> np.ndarray:
        raise NotImplementedError("TNG FOF groups have no parent structure.")

    def get_halo_parent_indexes(self, particle_type=None) -> np.ndarray:
        raise NotImplementedError("TNG FOF groups have no parent structure.")

    def get_halo_top_level_parent_IDs(self, particle_type=None) -> np.ndarray:
        return self.get_halo_IDs(particle_type)

    def get_halo_top_level_parent_indexes(self, particle_type=None) -> np.ndarray:
        return self.get_halo_indexes(particle_type)

    def get_halo_centres_of_mass(self, particle_type=None, use_proper_units=False) -> UnitArray:
        data = self.snapshot._length_mpc(self._group_field("GroupCM", trailing=(3,)))
        if use_proper_units:
            data = data * self.snapshot.a
        return unit_array(data, "Mpc")

    def get_halo_centres_of_potential(self, particle_type=None, use_proper_units=False) -> UnitArray:
        data = self.snapshot._length_mpc(self._group_field("GroupPos", trailing=(3,)))
        if use_proper_units:
            data = data * self.snapshot.a
        return unit_array(data, "Mpc")

    def get_halo_masses(self, halo_type: IHaloDefinition, particle_type=None) -> UnitArray:
        if isinstance(halo_type, FOFGroup):
            field = "GroupMass"
        elif isinstance(halo_type, SphericalOverdensityAperture):
            spec = self._SO_FIELDS.get(type(halo_type))
            if spec is None:
                raise halo_type.make_error(CatalogueTNG)
            field = f"Group_M_{spec}{halo_type.overdensity_limit}"
        else:
            raise halo_type.make_error(CatalogueTNG)
        try:
            data = self._group_field(field)
        except KeyError:
            raise halo_type.make_error(CatalogueTNG) from None
        return unit_array(self.snapshot._mass_msun(data), "Msun")

    def get_halo_radii(self, halo_type, particle_type=None, use_proper_units=False) -> UnitArray:
        if not isinstance(halo_type, SphericalOverdensityAperture):
            raise halo_type.make_error(CatalogueTNG)
        spec = self._SO_FIELDS.get(type(halo_type))
        if spec is None:
            raise halo_type.make_error(CatalogueTNG)
        try:
            data = self._group_field(f"Group_R_{spec}{halo_type.overdensity_limit}")
        except KeyError:
            raise halo_type.make_error(CatalogueTNG) from None
        data = self.snapshot._length_mpc(data)
        if use_proper_units:
            data = data * self.snapshot.a
        return unit_array(data, "Mpc")

    def _membership_offsets(self, particle_type: ParticleType) -> np.ndarray:
        if self._len_type is None:
            self._len_type = self._group_field("GroupLenType")
        lens = self._len_type[:, particle_type.value]
        return np.concatenate([[0], np.cumsum(lens)])

    def restrict_snapshot_to_halo(
        self, halo_index: int, particle_types=None
    ) -> None:
        """O(halo) cutout: restrict the attached snapshot's reads to this
        FoF group's contiguous particle slices (GroupLenType offsets —
        illustris_python ``snapshot.loadHalo`` semantics). Every snapshot
        getter then returns just the halo's particles; call
        ``snapshot.clear_row_restriction()`` to undo."""
        if not 0 <= halo_index < self._n_groups_total:
            raise IndexError(
                f"halo index {halo_index} outside [0, {self._n_groups_total})"
            )
        ranges = {}
        for pt in particle_types or ParticleType.get_all():
            offsets = self._membership_offsets(pt)
            ranges[pt] = (int(offsets[halo_index]), int(offsets[halo_index + 1]))
        self.snapshot.restrict_to_row_ranges(ranges)

    def get_halo_indexes_by_snapshot_particle(
        self, particle_type: ParticleType, snapshot_particle_ids=None
    ) -> np.ndarray:
        """Halo index per particle from cumulative GroupLenType offsets (TNG
        snapshots store particles grouped by halo, FOF members first).

        Uses the snapshot's GLOBAL row indexes, so results stay correct
        while a row restriction (halo cutout) is active — the offsets are
        defined in global snapshot rows, not in this process's local
        ordering."""
        offsets = self._membership_offsets(particle_type)
        idx = self.snapshot.global_row_indexes(particle_type)
        halo_index = np.searchsorted(offsets, idx, side="right") - 1
        halo_index[idx >= offsets[-1]] = -1  # outer fuzz beyond all groups
        if snapshot_particle_ids is None:
            return halo_index
        from ..ops.reorder import ArrayReorder

        return ArrayReorder.create(
            self.snapshot.get_IDs(particle_type), snapshot_particle_ids
        )(halo_index, default_value=-1)

    def get_halo_IDs_by_snapshot_particle(
        self, particle_type: ParticleType, snapshot_particle_ids=None
    ) -> np.ndarray:
        idx = self.get_halo_indexes_by_snapshot_particle(particle_type, snapshot_particle_ids)
        return np.where(idx >= 0, idx + 1, -1)

    def get_particle_IDs(self, particle_type: ParticleType, include_unbound: bool = True) -> np.ndarray:
        """IDs of FoF-bound particles (global rows below the last offset) —
        restriction-aware: with an active cutout this returns the bound
        subset of the restricted rows."""
        offsets = self._membership_offsets(particle_type)
        ids = self.snapshot.get_IDs(particle_type)
        rows = self.snapshot.global_row_indexes(particle_type)
        return ids[rows < offsets[-1]]
