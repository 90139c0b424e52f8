"""EAGLE snapshot backend — pure h5py, multi-file, region-restrictable.

Counterpart: ``astro_sph_tools_tpu/io/eagle.py`` (copied). ``h5py`` is
imported on first use (``io/_lazy.py``).

Parity target: ``SnapshotEAGLE``
(`astro_sph_tools/io/EAGLE/_SnapshotEAGLE.py`), with the
C ``pyread_eagle`` dependency replaced by direct multi-file h5py reads:

- filepath naming scheme ``sn[ai]pshot_NNN_zXpY/sn[ai]p_NNN_zXpY.K.hdf5``
  (`_SnapshotEAGLE.py:69-74`); the ``a``/``i`` letter distinguishes snapshots
  from snipshots.
- header scrape: cosmology attrs, NumPart_Total, DM mass from MassTable[1],
  per-field h/a-exponent + CGS attrs, Units group cross-checks
  (`_SnapshotEAGLE.py:78-113`).
- unit recipe ``physical = raw * h^h_exp * a^a_exp * cgs`` with a_exp = 0
  for co-moving user data (`_SnapshotEAGLE.py:422-427`).
- field vocabulary incl. DM constant masses, BH subgrid vs dynamical masses,
  elemental number densities with the 1.661e-24 g atomic mass unit, FOF
  group-number semantics (negatives = near-but-unbound,
  EAGLE_MAX_GROUP_NUMBER clamp) (`_SnapshotEAGLE.py:481-641`).
- region restriction with periodic handling (`_SnapshotEAGLE.py:176-310`),
  re-expressed as wrapped-interval masks (which also fixes the reference's
  x-wrap ``min_y`` mutation bug, SURVEY.md §2.9.8).

Parallelism: instead of ``pyread_eagle.split_selection`` over MPI ranks
(`_SnapshotEAGLE.py:119-130`), multi-process runs split the *file list* over
the caller's ``process_index`` — each process reads a disjoint chunk set
feeding its local shard of a distributed array.
"""

from __future__ import annotations

import glob
import re
import threading
from typing import Optional, Sequence, Union

from ._lazy import h5py
import numpy as np

from .. import constants as C
from ..data_structures.particle_types import ParticleType
from ..units import UnitArray, unit_array
from .errors import SnapshotFormatError, SnipshotFieldError, SnipshotOperationError
from .snapshot import SnapshotBase

EAGLE_MAX_GROUP_NUMBER = 2**30

_SNAP_PATTERN = re.compile(
    r".*sn(?P<letter>[ai])pshot_(?P<number>\d{3})_z(?P<zint>\d+)p(?P<zdec>\d+)"
    r"[\\/]sn(?P=letter)p_(?P=number)_z(?P=zint)p(?P=zdec)\.(?P<index>\d+)\.(?P<ext>\w+)$"
)

ELEMENT_FULL_NAMES = {
    "H": "Hydrogen", "He": "Helium", "C": "Carbon", "N": "Nitrogen",
    "O": "Oxygen", "Ne": "Neon", "Mg": "Magnesium", "Si": "Silicon", "Fe": "Iron",
}


#: rows per spatial-index block: one bounding box is kept per this many
#: consecutive rows of each file's Coordinates dataset. 64Ki rows keeps the
#: index ~3000x smaller than the data while EAGLE's Peano-Hilbert on-disk
#: ordering keeps each block spatially compact.
SPATIAL_INDEX_BLOCK_ROWS = 1 << 16


# shared periodic-selection helpers; the leading-underscore names stay as
# this module's public-ish test surface
from .spatial import (  # noqa: E402
    axis_intervals as _axis_intervals,
    interval_overlap_mask as _interval_overlap_mask,
    region_membership_mask as _region_membership_mask,
    wrapped_interval_mask as _wrapped_interval_mask,
)


class SnapshotEAGLE(SnapshotBase):
    """Multi-file EAGLE snapshot reader (h5py)."""

    EAGLE_MAX_GROUP_NUMBER = EAGLE_MAX_GROUP_NUMBER

    def __init__(self, filepath: str, process_index: int = 0, n_processes: int = 1) -> None:
        match = _SNAP_PATTERN.match(filepath)
        if not match:
            raise SnapshotFormatError(
                f'Snapshot filepath "{filepath}" does not conform to the naming scheme '
                "of an EAGLE snapshot. EAGLE snapshot files must have a clear snapshot "
                "number component in both the folder and file names."
            )
        snap_num = match.group("number")
        is_snipshot = match.group("letter") == "i"

        # discover all parallel files of this snapshot
        stem = filepath.rsplit(".", 2)[0]
        ext = match.group("ext")
        self._file_paths = sorted(
            glob.glob(f"{glob.escape(stem)}.*.{ext}"),
            key=lambda p: int(p.rsplit(".", 2)[1]),
        )
        if not self._file_paths:
            raise FileNotFoundError(filepath)
        # multi-process data parallelism: this process reads files i::P
        self._my_files = self._file_paths[process_index::n_processes]
        self._n_processes = n_processes

        try:
            self._scrape_header(self._file_paths[0])
        except KeyError as err:
            # graceful failure for schema-variant files (missing Units
            # group, absent cosmology attrs, ...): name the gap instead of
            # leaking a bare KeyError (reference schema spec:
            # `_SnapshotEAGLE.py:78-113`)
            raise SnapshotFormatError(
                f'EAGLE snapshot "{self._file_paths[0]}" is missing a '
                f"required header attribute/group: {err}"
            ) from err
        redshift = self._hdr_redshift
        hubble_param = self._hdr_hubble_param
        expansion_factor = self._hdr_expansion_factor
        omega_baryon = self._hdr_omega_baryon

        self._per_file_counts = np.zeros((len(self._file_paths), 6), dtype=np.int64)
        for i, path in enumerate(self._file_paths):
            with h5py.File(path, "r") as f:
                self._per_file_counts[i] = np.asarray(
                    f["Header"].attrs["NumPart_ThisFile"], dtype=np.int64
                )

        self._region_masks: dict[ParticleType, Optional[np.ndarray]] = {}
        #: per type: per-my-file merged (start, stop) row ranges selected by
        #: the spatial index, or None for whole-file reads
        self._region_rows: dict[ParticleType, Optional[list]] = {}
        self._regions: Optional[list[tuple]] = None
        #: per type: per-my-file (n_rows, block_rows, mins, maxs) coordinate
        #: bounding boxes (internal units); built lazily on first
        #: region-restricted access OF THAT TYPE (a gas-only regional read
        #: never scans DM/star/BH coordinates)
        self._spatial_index: dict[ParticleType, Optional[list]] = {}
        #: guards the lazy per-type region-selection build (read_async can
        #: drive _read_dataset from multiple threads); RLock because the
        #: build itself reads coordinates through _read_dataset
        self._region_lock = threading.RLock()

        box_mpc = (
            self._box_internal
            * hubble_param**self._length_h_exp
            * self._length_cgs
            / C.MEGAPARSEC_CGS
        )
        super().__init__(
            filepath=filepath,
            number=snap_num,
            redshift=redshift,
            hubble_param=hubble_param,
            omega_baryon=omega_baryon,
            expansion_factor=expansion_factor,
            box_size=unit_array(np.full(3, box_mpc), "Mpc"),
            tracked_elements=C.EAGLE_TRACKED_ELEMENTS,
            snipshot=is_snipshot,
        )

    def _scrape_header(self, path: str) -> None:
        """Header scrape (`_SnapshotEAGLE.py:78-113`): cosmology attrs,
        counts (with HighWord), unit exponents/CGS factors, cross-checks."""
        with h5py.File(path, "r") as f:
            hdr = f["Header"].attrs
            self._hdr_redshift = float(hdr["Redshift"])
            self._hdr_hubble_param = float(hdr["HubbleParam"])
            self._hdr_expansion_factor = float(hdr["ExpansionFactor"])
            self._hdr_omega_baryon = float(hdr["OmegaBaryon"])
            # real EAGLE headers split counts into a uint32 low word plus
            # NumPart_Total_HighWord; production boxes exceed 2^32 particles
            # (reference evidence: 3.4-5.19e9-element reorders,
            # `tools/_ArrayReorder.py:536-548`), so the high word is not
            # optional at scale
            self._num_part_total = np.asarray(
                hdr["NumPart_Total"], dtype=np.int64
            )
            if "NumPart_Total_HighWord" in hdr:
                self._num_part_total = self._num_part_total + (
                    np.asarray(
                        hdr["NumPart_Total_HighWord"], dtype=np.int64
                    )
                    << 32
                )
            self._dm_mass_internal = float(hdr["MassTable"][1])
            self._box_internal = float(hdr["BoxSize"])
            self._solar_metallicity = float(f["Constants"].attrs["Z_Solar"])

            coords = f["PartType1/Coordinates"].attrs
            self._length_h_exp = float(coords["h-scale-exponent"])
            self._length_a_exp = float(coords["aexp-scale-exponent"])
            self._length_cgs = float(coords["CGSConversionFactor"])
            try:
                mass_attrs = f["PartType0/Mass"].attrs
                self._mass_h_exp = float(mass_attrs["h-scale-exponent"])
                self._mass_cgs = float(mass_attrs["CGSConversionFactor"])
            except KeyError:
                # no gas particles: the reference falls back to EAGLE's
                # standard values (`_SnapshotEAGLE.py:90-98`)
                self._mass_h_exp = -1.0
                self._mass_cgs = 1.989e43
            vel = f["PartType1/Velocity"].attrs
            self._velocity_h_exp = float(vel["h-scale-exponent"])
            self._velocity_a_exp = float(vel["aexp-scale-exponent"])
            self._velocity_cgs = float(vel["CGSConversionFactor"])

            units = f["Units"].attrs
            self._density_cgs = float(units["UnitDensity_in_cgs"])
            # consistency cross-checks (`_SnapshotEAGLE.py:111-113`)
            assert self._length_cgs == float(units["UnitLength_in_cm"])
            assert self._mass_cgs == float(units["UnitMass_in_g"])
            assert self._velocity_cgs == float(units["UnitVelocity_in_cm_per_s"])

    # -- counts --------------------------------------------------------------
    def _get_number_of_particles(self) -> dict[ParticleType, int]:
        return {pt: int(self._num_part_total[pt.value]) for pt in ParticleType.get_all()}

    def _get_number_of_particles_this_rank(self) -> dict[ParticleType, int]:
        return {
            pt: self._get_number_of_particles_this_rank_single(pt)
            for pt in ParticleType.get_all()
        }

    def _get_number_of_particles_this_rank_single(
        self, particle_type: ParticleType
    ) -> int:
        self._ensure_region_selection(particle_type)
        mask = self._region_masks.get(particle_type)
        if mask is not None:
            return int(mask.sum())
        my_idx = [self._file_paths.index(p) for p in self._my_files]
        return int(self._per_file_counts[my_idx, particle_type.value].sum())

    # -- raw reads -----------------------------------------------------------
    def _read_dataset(
        self, particle_type: ParticleType, field: str, dtype=np.float64, trailing: tuple = ()
    ) -> np.ndarray:
        """Concatenate a field over this process's files, applying any active
        region restriction (`_SnapshotEAGLE.py:481-491` analogue).

        With a region restriction active, only the spatially-selected row
        ranges are read (files with no intersecting blocks are never
        opened), matching pyread_eagle's hash-cell ``select_region``
        semantics (`_SnapshotEAGLE.py:115-117,176-310`): a 1%-volume cutout
        costs ~1% of the box's IO, not 100%."""
        self._ensure_region_selection(particle_type)
        ranges = self._region_rows.get(particle_type)
        parts = []
        group_seen = False
        n_groups = n_found = 0
        for fidx, path in enumerate(self._my_files):
            if ranges is not None and not ranges[fidx]:
                continue  # no selected rows: do not even open the file
            with h5py.File(path, "r") as f:
                key = f"{particle_type.common_hdf5_name}/{field}"
                if particle_type.common_hdf5_name in f:
                    n_groups += 1
                if key not in f:
                    group_seen |= particle_type.common_hdf5_name in f
                    continue
                n_found += 1
                ds = f[key]
                if ranges is None:
                    parts.append(np.asarray(ds))
                else:
                    for start, stop in ranges[fidx]:
                        parts.append(ds[start:stop])
        if not parts:
            if group_seen:
                # the particle group exists but lacks this dataset — a
                # schema gap (snipshot field subset or corrupt file), not
                # an empty particle type; silence here would propagate
                # empty arrays into science results
                if self.is_snipshot:
                    raise SnipshotFieldError(
                        field,
                        "Unable to read this field - snipshots store a "
                        "reduced field set.",
                    )
                raise SnapshotFormatError(
                    f'Dataset "{field}" is missing from the '
                    f"{particle_type.common_hdf5_name} groups of this "
                    "snapshot's files."
                )
            return np.empty((0, *trailing), dtype=dtype)
        if n_found < n_groups:
            # present in SOME files only: concatenating would silently
            # misalign this field against every other (schema-fuzz
            # finding, round 5)
            raise SnapshotFormatError(
                f'Dataset "{field}" is present in only {n_found} of '
                f"{n_groups} {particle_type.common_hdf5_name} file groups "
                "of this snapshot."
            )
        data = np.concatenate(parts, axis=0)
        mask = self._region_masks.get(particle_type)
        if mask is not None:
            data = data[mask]
        return data

    def _field_attrs(self, particle_type: ParticleType, field: str) -> tuple[float, float, float]:
        for path in self._my_files + self._file_paths:
            with h5py.File(path, "r") as f:
                key = f"{particle_type.common_hdf5_name}/{field}"
                if key in f:
                    a = f[key].attrs
                    return (
                        float(a["h-scale-exponent"]),
                        float(a["aexp-scale-exponent"]),
                        float(a["CGSConversionFactor"]),
                    )
        raise KeyError(field)

    # -- unit materialisation (`_SnapshotEAGLE.py:422-453`) --------------------
    def make_cgs_data(
        self, cgs_units: str, data: np.ndarray, h_exp: float, cgs_conversion_factor: float,
        a_exp: float = 0.0,
    ) -> UnitArray:
        """physical = raw * h^h_exp * a^a_exp * cgs; a_exp = 0 keeps co-moving.

        The conversion runs in f64 regardless of the on-disk dtype (EAGLE
        files store f32 datasets, and e.g. particle masses overflow f32 once
        expressed in grams: 1e6 Msun ~ 2e39 g > f32 max), fused into ONE
        numpy pass — the factors combine into a scalar first, because each
        extra elementwise pass over a 1e8-row array costs seconds of host
        memory bandwidth."""
        scale = (self.h**h_exp) * (self.a**a_exp) * cgs_conversion_factor
        return unit_array(np.multiply(data, scale, dtype=np.float64), cgs_units)

    #: dtype of returned field arrays. The default f64 preserves the full
    #: on-disk precision through the unit algebra; large streaming pipelines
    #: can set ``snap.output_dtype = np.float32`` — safe because the fused
    #: conversion goes straight to user units (Mpc/Msun/...) without ever
    #: materialising CGS magnitudes, and each host pass over a 1e8-row array
    #: costs seconds of (single-core) memory bandwidth.
    output_dtype = np.float64

    def _fused_unit_data(
        self, data: np.ndarray, h_exp: float, cgs: float, a_exp: float,
        unit_cgs_size: float, units: str,
    ) -> UnitArray:
        """Raw -> user units in a single fused numpy pass (see make_cgs_data)."""
        scale = (self.h**h_exp) * (self.a**a_exp) * cgs / unit_cgs_size
        return unit_array(np.multiply(data, scale, dtype=self.output_dtype), units)

    def _convert_to_cgs_length(self, data, proper=False) -> UnitArray:
        return self.make_cgs_data(
            "cm", data, h_exp=self._length_h_exp, cgs_conversion_factor=self._length_cgs,
            a_exp=self._length_a_exp if proper else 0.0,
        )

    def _convert_to_cgs_mass(self, data) -> UnitArray:
        return self.make_cgs_data(
            "g", data, h_exp=self._mass_h_exp, cgs_conversion_factor=self._mass_cgs
        )

    def _convert_to_cgs_velocity(self, data, proper=False) -> UnitArray:
        return self.make_cgs_data(
            "cm/s", data, h_exp=self._velocity_h_exp, cgs_conversion_factor=self._velocity_cgs,
            a_exp=self._velocity_a_exp if proper else 0.0,
        )

    @property
    def dark_matter_particle_mass(self) -> UnitArray:
        return self._convert_to_cgs_mass(np.float64(self._dm_mass_internal)).to("Msun")

    # -- region restriction (`_SnapshotEAGLE.py:176-418`) ----------------------
    def restrict_data_comoving_loading_region(
        self,
        min_x: Union[float, UnitArray, Sequence],
        max_x: Union[float, UnitArray, Sequence],
        min_y: Union[float, UnitArray, Sequence],
        max_y: Union[float, UnitArray, Sequence],
        min_z: Union[float, UnitArray, Sequence],
        max_z: Union[float, UnitArray, Sequence],
    ) -> None:
        """Restrict subsequent reads to axis-aligned co-moving box region(s).

        Accepts scalars (Mpc or UnitArray lengths) or equal-length sequences
        of region bounds (`_SnapshotEAGLE.py:312-418` batch wrappers).
        Inverted ranges wrap across the periodic boundary.
        """
        def to_mpc_list(v):
            if isinstance(v, UnitArray):
                v = v.to_value("Mpc")
            arr = np.atleast_1d(np.asarray(v, dtype=np.float64))
            return arr

        bounds = [to_mpc_list(b) for b in (min_x, max_x, min_y, max_y, min_z, max_z)]
        n_regions = bounds[0].shape[0]
        if any(b.shape[0] != n_regions for b in bounds):
            raise ValueError("All region bound sequences must have the same length.")
        self._regions = [tuple(b[i] for b in bounds) for i in range(n_regions)]
        self._region_masks = {}
        self._region_rows = {}
        # selection (spatial index + membership mask) is built lazily per
        # particle type on first access — see _ensure_region_selection
        self._update_number_of_particles()

    def restrict_data_proper_loading_region(self, min_x, max_x, min_y, max_y, min_z, max_z):
        """Proper-coordinate variant: bounds are converted to co-moving."""
        conv = lambda v: (
            self.to_comoving_length(v if not isinstance(v, UnitArray) else v.to_value("Mpc"))
        )
        self.restrict_data_comoving_loading_region(
            conv(min_x), conv(max_x), conv(min_y), conv(max_y), conv(min_z), conv(max_z)
        )

    def clear_region_restriction(self) -> None:
        self._regions = None
        self._region_masks = {}
        self._region_rows = {}
        self._update_number_of_particles()

    # -- spatial index: per-block coordinate bounding boxes ---------------------
    def build_spatial_index(
        self,
        block_rows: int = SPATIAL_INDEX_BLOCK_ROWS,
        particle_types: Optional[Sequence[ParticleType]] = None,
    ) -> None:
        """One streaming pass per (file, particle type) over ``Coordinates``,
        recording a bounding box per ``block_rows`` consecutive rows.

        Region-restricted reads then prune to the intersecting row ranges
        only — the pyread_eagle ``select_region`` capability
        (`_SnapshotEAGLE.py:115-117,176-310`) without assuming on-disk hash
        tables: EAGLE's Peano-Hilbert storage order makes row blocks
        spatially compact, so block bounding boxes prune nearly as sharply
        as hash cells. The index is cached on the instance; the pass is
        O(box) once per type, after which every restriction and field read
        is O(region). Built automatically — per particle type, on that
        type's first region-restricted access — so a gas-only regional
        read never streams DM/star/BH coordinates. Pass ``particle_types``
        to index a subset explicitly; the default indexes every type."""
        if getattr(self, "_spatial_index_block_rows", None) not in (
            None, block_rows
        ):
            # granularity changed: a stale coarser index would silently
            # keep pruning at the old block size
            self._spatial_index = {}
        self._spatial_index_block_rows = block_rows
        for pt in particle_types or ParticleType.get_all():
            if pt in self._spatial_index:
                continue
            if self._num_part_total[pt.value] == 0:
                self._spatial_index[pt] = None
                continue
            per_file = []
            for path in self._my_files:
                with h5py.File(path, "r") as f:
                    key = f"{pt.common_hdf5_name}/Coordinates"
                    if key not in f:
                        per_file.append(
                            (0, block_rows, np.empty((0, 3)), np.empty((0, 3)))
                        )
                        continue
                    ds = f[key]
                    n = int(ds.shape[0])
                    nb = -(-n // block_rows)
                    mins = np.empty((nb, 3))
                    maxs = np.empty((nb, 3))
                    for b in range(nb):
                        blk = ds[b * block_rows : (b + 1) * block_rows]
                        mins[b] = blk.min(axis=0)
                        maxs[b] = blk.max(axis=0)
                    per_file.append((n, block_rows, mins, maxs))
            self._spatial_index[pt] = per_file

    def _selected_block_ranges(self, pt: ParticleType) -> Optional[list]:
        """Merged (start, stop) row ranges per this-process file whose block
        bounding box intersects any active region (periodic-aware)."""
        idx = self._spatial_index.get(pt)
        if self._regions is None or idx is None:
            return None
        box = float(self.box_size.value[0])
        # internal -> Mpc scale for the stored bounding boxes
        scale = (self.h**self._length_h_exp) * self._length_cgs / C.MEGAPARSEC_CGS
        ranges_per_file = []
        for n_rows, block_rows, mins, maxs in idx:
            nb = mins.shape[0]
            if nb == 0:
                ranges_per_file.append([])
                continue
            sel = _interval_overlap_mask(
                mins * scale, maxs * scale, self._regions, box
            )
            # merge adjacent selected blocks into contiguous row ranges
            ranges = []
            b = 0
            while b < nb:
                if sel[b]:
                    b1 = b
                    while b1 + 1 < nb and sel[b1 + 1]:
                        b1 += 1
                    ranges.append(
                        (b * block_rows, min((b1 + 1) * block_rows, n_rows))
                    )
                    b = b1 + 1
                else:
                    b += 1
            ranges_per_file.append(ranges)
        return ranges_per_file

    def _ensure_region_selection(self, pt: ParticleType) -> None:
        """Build the spatial index, pruned row ranges, and exact membership
        mask for ONE particle type on its first region-restricted access.

        Lazy per type: a restriction itself costs nothing, and a gas-only
        regional render never pays the whole-box coordinate scan for
        DM/star/BH. Thread-safe under ``read_async`` — the RLock serializes
        builds while allowing the build's own internal coordinate read to
        re-enter ``_read_dataset``."""
        if self._regions is None:
            return
        with self._region_lock:
            if pt in self._region_masks:
                return
            if self._num_part_total[pt.value] == 0:
                self._region_rows[pt] = None
                self._region_masks[pt] = None
                return
            box = float(self.box_size.value[0])
            # preserve a user-chosen index granularity: the default would
            # otherwise clobber and rebuild a custom-block_rows index
            self.build_spatial_index(
                getattr(self, "_spatial_index_block_rows", None)
                or SPATIAL_INDEX_BLOCK_ROWS,
                particle_types=(pt,),
            )
            self._region_rows[pt] = self._selected_block_ranges(pt)
            # read the selected rows' raw coordinates with the mask marked
            # built-but-absent, so the re-entrant read applies row pruning
            # only (other threads are held at the lock until the real mask
            # is in place)
            self._region_masks[pt] = None
            try:
                raw = self._read_dataset(pt, "Coordinates", trailing=(3,))
                pos = (
                    raw * (self.h**self._length_h_exp)
                    * self._length_cgs / C.MEGAPARSEC_CGS
                )
                self._region_masks[pt] = _region_membership_mask(
                    pos, self._regions, box
                )
            except BaseException:
                # a failed build must not leave the sentinel behind: it
                # would read as "restriction built, no mask" and silently
                # return unmasked data on the next access
                self._region_masks.pop(pt, None)
                self._region_rows.pop(pt, None)
                raise

    # -- field getters ----------------------------------------------------------
    def _get_IDs(self, particle_type: ParticleType) -> np.ndarray:
        return self._read_dataset(particle_type, "ParticleIDs", dtype=np.int64)

    def _get_smoothing_lengths(self, particle_type: ParticleType, use_proper_units: bool) -> UnitArray:
        data = self._read_dataset(particle_type, "SmoothingLength")
        return self._fused_unit_data(
            data, self._length_h_exp, self._length_cgs,
            self._length_a_exp if use_proper_units else 0.0,
            C.MEGAPARSEC_CGS, "Mpc",
        )

    def _get_masses(self, particle_type: ParticleType) -> UnitArray:
        if particle_type == ParticleType.dark_matter:
            n = self.number_of_particles_this_rank(ParticleType.dark_matter)
            return unit_array(
                np.full(n, self.dark_matter_particle_mass.value), "Msun"
            )
        return self._fused_unit_data(
            self._read_dataset(particle_type, "Mass"),
            self._mass_h_exp, self._mass_cgs, 0.0, C.SOLAR_MASS_CGS, "Msun",
        )

    def _get_black_hole_subgrid_masses(self) -> UnitArray:
        return self._convert_to_cgs_mass(
            self._read_dataset(ParticleType.black_hole, "BH_Mass")
        ).to("Msun")

    def _get_black_hole_dynamical_masses(self) -> UnitArray:
        return self._convert_to_cgs_mass(
            self._read_dataset(ParticleType.black_hole, "Mass")
        ).to("Msun")

    def _get_positions(self, particle_type: ParticleType, use_proper_units: bool) -> UnitArray:
        data = self._read_dataset(particle_type, "Coordinates", trailing=(3,))
        return self._fused_unit_data(
            data, self._length_h_exp, self._length_cgs,
            self._length_a_exp if use_proper_units else 0.0,
            C.MEGAPARSEC_CGS, "Mpc",
        )

    def _get_velocities(self, particle_type: ParticleType, use_proper_units: bool) -> UnitArray:
        data = self._read_dataset(particle_type, "Velocity", trailing=(3,))
        return self._fused_unit_data(
            data, self._velocity_h_exp, self._velocity_cgs,
            self._velocity_a_exp if use_proper_units else 0.0,
            1.0e5, "km/s",
        )

    def _get_sfr(self) -> UnitArray:
        raw = self._read_dataset(ParticleType.gas, "StarFormationRate")
        try:
            _, _, cgs = self._field_attrs(ParticleType.gas, "StarFormationRate")
        except KeyError:
            cgs = C.SOLAR_MASS_CGS / C.YEAR_CGS
        return unit_array(raw * cgs, "g/s").to("Msun/yr")

    def _get_metallicities(self, particle_type, solar_units, solar_metallicity) -> UnitArray:
        result = unit_array(self._read_dataset(particle_type, "Metallicity"), "")
        if not solar_units:
            return result
        return result / (
            solar_metallicity if solar_metallicity is not None else self._solar_metallicity
        )

    @property
    def solar_metallicity(self) -> float:
        """File-provided Z_Solar (`_SnapshotEAGLE.py:534-539`)."""
        return self._solar_metallicity

    def _get_mean_enrichment_redshift(self, particle_type: ParticleType) -> UnitArray:
        return unit_array(self._read_dataset(particle_type, "MetalMassWeightedRedshift"), "")

    def _get_densities(self, particle_type: ParticleType, use_proper_units: bool) -> UnitArray:
        # h_exp is hard-coded 2.0 in the reference (`_SnapshotEAGLE.py:544-551`)
        return self.make_cgs_data(
            "g/cm**3",
            self._read_dataset(particle_type, "Density"),
            h_exp=2.0,
            cgs_conversion_factor=self._density_cgs,
            a_exp=-3 if use_proper_units else 0,
        ).to("Msun/Mpc**3")

    def _get_number_densities(
        self, particle_type: ParticleType, element: str, use_proper_units: bool,
        default_abundance: Optional[float],
    ) -> UnitArray:
        """n = rho * X / (A * 1.661e-24 g) in cm^-3 (`_SnapshotEAGLE.py:553-585`)."""
        if self.is_snipshot and default_abundance is None:
            raise SnipshotOperationError(
                "get_number_densities",
                'Unable to read abundance data - snipshots do not contain this '
                'information. A "default_abundance" value must be specified.',
            )
        if element not in ELEMENT_FULL_NAMES:
            raise ValueError(f'Element "{element}" not tracked as part of EAGLE.')
        atomic_weight_g = C.ATOMIC_WEIGHTS[element] * C.ATOMIC_MASS_UNIT_CGS_REFERENCE
        rho = self.make_cgs_data(
            "g/cm**3",
            self._read_dataset(particle_type, "Density"),
            h_exp=2.0,
            cgs_conversion_factor=self._density_cgs,
            a_exp=-3 if use_proper_units else 0,
        )
        if self.is_snipshot:
            abundance = default_abundance
        else:
            abundance = self._read_dataset(
                particle_type, f"ElementAbundance/{ELEMENT_FULL_NAMES[element]}"
            )
        return unit_array(rho.value * abundance / atomic_weight_g, "cm**-3")

    def _get_temperatures(self, particle_type: ParticleType) -> UnitArray:
        return unit_array(self._read_dataset(particle_type, "Temperature"), "K")

    def _get_elemental_abundance(self, particle_type: ParticleType, element: str) -> UnitArray:
        if self.is_snipshot:
            raise SnipshotFieldError(
                f"{particle_type}ElementAbundance",
                "Unable to read abundance data - snipshots do not contain this information.",
            )
        if element not in ELEMENT_FULL_NAMES:
            raise ValueError(f'Element "{element}" not tracked as part of EAGLE.')
        return unit_array(
            self._read_dataset(particle_type, f"ElementAbundance/{ELEMENT_FULL_NAMES[element]}"),
            "",
        )

    # -- FOF membership straight from the snapshot (`_SnapshotEAGLE.py:615-641`) --
    def get_group_ID(
        self, particle_type: ParticleType, include_nearby_unattached_particles: bool = False
    ) -> np.ndarray:
        """Per-particle FOF group numbers. Negative on-disk values mark "near
        but unbound" particles: negated when included, else clamped to
        EAGLE_MAX_GROUP_NUMBER."""
        gn = self._read_dataset(particle_type, "GroupNumber", dtype=np.int32).copy()
        unbound = gn < 0
        if include_nearby_unattached_particles:
            gn[unbound] = -gn[unbound]
        else:
            gn[unbound] = self.EAGLE_MAX_GROUP_NUMBER
        return gn

    def get_group_index(
        self, particle_type: ParticleType, include_nearby_unattached_particles: bool = False
    ) -> np.ndarray:
        """Group index = group number - 1; non-members become -1."""
        gn = self.get_group_ID(particle_type, include_nearby_unattached_particles)
        gn[gn == self.EAGLE_MAX_GROUP_NUMBER] = 0
        return gn - 1
