"""SWIFT snapshot + SOAP catalogue backend — pure h5py, working end to end.

The reference's SWIFT package is broken (wrong relative imports, stale base
signatures, a KDTree chunking bug — `io/SWIFT/*`, SURVEY.md §2.9.4); per the
survey it is treated here as a *capability requirement* with the EAGLE
semantics as the behavioural spec. This module reads SWIFT's on-disk schema
directly (replacing the ``swiftsimio`` dependency):

- ``Header``: BoxSize, Redshift, Scale-factor, NumPart_Total/ThisFile;
  ``Cosmology``: h, Omega_b; per-field attrs "Conversion factor to CGS (not
  including cosmological corrections)" + "a-scale exponent" ("h-scale
  exponent" is 0 — SWIFT data is h-free on disk; values are converted to the
  framework's co-moving h-full-free user convention identically to EAGLE's
  final Mpc/Msun form).
- field vocabulary: Coordinates, Velocities, Masses, SmoothingLengths,
  Densities, Temperatures, ParticleIDs, StarFormationRates,
  MetalMassFractions, ElementMassFractions (+ SubgridMasses/DynamicalMasses
  for black holes).
- **computed DM smoothing lengths**: SWIFT stores none for dark matter; the
  reference computes the 32nd-nearest-neighbour distance with a periodic
  scipy KDTree in 1e4-particle chunks (`_SnapshotSWIFT.py:58-85`; its chunk
  slice used ``max`` where ``min`` was meant — fixed here).

``CatalogueSOAP`` reads SOAP/VELOCIraptor catalogues per
`io/SWIFT/_CatalogueSOAP.py`: a ``VR`` group with IDs/parents/centres, SO
subgroups for masses/radii, per-type ``GroupNr_all``/``GroupNr_bound``
membership, and SOAP's "Conversion factor to CGS (including/not including
cosmological corrections)" attrs (`:163-172`).

Counterpart: ``astro_sph_tools_tpu/io/swift.py``
(copied; ``h5py`` is imported on first use).
"""

from __future__ import annotations

import glob
import os
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
)
from .errors import SnapshotFormatError
from .snapshot import SnapshotBase
from .spatial import interval_overlap_mask, region_membership_mask

SWIFT_ELEMENT_ORDER = ("H", "He", "C", "N", "O", "Ne", "Mg", "Si", "Fe")
_CGS_KEY = "Conversion factor to CGS (not including cosmological corrections)"
_CGS_KEY_COSMO = "Conversion factor to CGS (including cosmological corrections)"

DM_NEIGHBOUR_COUNT = 32
DM_CHUNK = 10_000
# the DM k-NN's crossover: from this many particles "auto" takes the device
# grid (ops.neighbors.knn_distances_grid), below it the host KDTree. On an
# NVIDIA H100 80GB HBM3 (700 W) with an 8-core host, chip_smoke.py phase 22
# found the grid faster at every size it measures, 3e3 to 3e6 clustered
# points (1.1 vs 20 ms at 3e3, 30 vs 69 ms at 3e4, 0.64 vs 13.3 s at 3e6
# with the KDTree built once), so the threshold is the smallest size
# measured. (The JAX package's 3e5 was the TPU's, KNN_CROSSOVER.json.)
DM_HSML_DEVICE_THRESHOLD = 3_000


def dm_smoothing_lengths(pos, box: float, engine: str = "auto", device="cuda",
                         stats: Optional[dict] = None) -> np.ndarray:
    """32nd-nearest-neighbour distance (periodic) of every DM particle, f64
    in the positions' units: ``engine="grid"`` runs the k-NN cascade on
    ``device``, ``"kdtree"`` scipy's KDTree on the host (in 1e4-particle
    chunks over all cores), ``"auto"`` the grid from
    ``DM_HSML_DEVICE_THRESHOLD`` particles. ``pos`` is (N, 3), NumPy or a
    tensor. ``stats``, when given, receives the engine taken and the grid's
    stages (``knn_distances_grid``)."""
    n = pos.shape[0]
    if engine == "auto":
        engine = "grid" if n >= DM_HSML_DEVICE_THRESHOLD else "kdtree"
    if stats is not None:
        stats["engine"] = engine
    if engine == "grid":
        from ..ops.neighbors import _knn_grid

        d = _knn_grid(pos, pos, DM_NEIGHBOUR_COUNT, periodic_box=box, device=device, stats=stats)
        return d[:, -1].double().cpu().numpy()
    if engine != "kdtree":
        raise ValueError(f"Unknown DM smoothing-length engine {engine!r} (auto | grid | kdtree)")
    from scipy.spatial import KDTree

    pos = np.mod(pos.cpu().numpy() if hasattr(pos, "cpu") else np.asarray(pos), box)
    tree = KDTree(pos, boxsize=box)
    out = np.empty(n, dtype=np.float64)
    for start in range(0, n, DM_CHUNK):
        stop = min(start + DM_CHUNK, n)  # reference used max() here
        d, _ = tree.query(pos[start:stop], k=DM_NEIGHBOUR_COUNT, workers=-1)
        out[start:stop] = d[:, -1]
    return out


class SnapshotSWIFT(SnapshotBase):
    """SWIFT snapshot reader (single- or multi-file)."""

    def __init__(self, filepath: str, process_index: int = 0, n_processes: int = 1) -> None:
        stem, ext = os.path.splitext(filepath)
        multi = re.match(r"(.*)\.(\d+)$", stem)
        if multi:
            self._file_paths = sorted(
                glob.glob(f"{glob.escape(multi.group(1))}.*{ext}"),
                key=lambda p: int(os.path.splitext(p)[0].rsplit(".", 1)[1]),
            )
        else:
            self._file_paths = [filepath]
        if not self._file_paths:
            raise FileNotFoundError(filepath)
        self._my_files = self._file_paths[process_index::n_processes]

        with h5py.File(self._file_paths[0], "r") as f:
            hdr = f["Header"].attrs
            cosmo = f["Cosmology"].attrs
            redshift = float(np.atleast_1d(hdr["Redshift"])[0])
            scale_factor = float(np.atleast_1d(hdr.get("Scale-factor", 1.0 / (1 + redshift)))[0])
            hubble = float(np.atleast_1d(cosmo["h"])[0])
            omega_b = float(np.atleast_1d(cosmo["Omega_b"])[0])
            self._num_part_total = np.asarray(hdr["NumPart_Total"], dtype=np.int64)
            box_internal = np.atleast_1d(np.asarray(hdr["BoxSize"], dtype=np.float64))
            if box_internal.shape[0] == 1:
                box_internal = np.repeat(box_internal, 3)
            # length CGS factor from the Coordinates attrs of any present type
            length_cgs = None
            for pt in ParticleType.get_all():
                key = f"{pt.common_hdf5_name}/Coordinates"
                if key in f:
                    length_cgs = float(f[key].attrs[_CGS_KEY])
                    break
            if length_cgs is None:
                raise SnapshotFormatError(f"No particle coordinates found in {filepath}")
            self._length_cgs = length_cgs

        self._per_file_counts = np.zeros((len(self._file_paths), 6), dtype=np.int64)
        for i, path in enumerate(self._file_paths):
            with h5py.File(path, "r") as f:
                self._per_file_counts[i] = np.asarray(
                    f["Header"].attrs["NumPart_ThisFile"], dtype=np.int64
                )

        number = "000"
        m = re.search(r"_(\d{3,4})(?:\.\d+)?\.hdf5$", filepath)
        if m:
            number = m.group(1)

        self._region_masks = {}
        #: per type: per-my-file merged (start, stop) row ranges selected by
        #: the Cells index, or None for whole-file reads
        self._region_rows = {}
        self._regions = None
        self._cells_cache = None  # lazy: False (absent) or (centres, size, per_type)

        box_mpc = box_internal * length_cgs / C.MEGAPARSEC_CGS
        super().__init__(
            filepath=filepath,
            number=number,
            redshift=redshift,
            hubble_param=hubble,
            omega_baryon=omega_b,
            expansion_factor=scale_factor,
            box_size=unit_array(box_mpc, "Mpc"),
            tracked_elements=SWIFT_ELEMENT_ORDER,
            snipshot=False,
        )
        self._dm_hsml_cache: Optional[np.ndarray] = None

    # -- counts ------------------------------------------------------------------
    def _get_number_of_particles(self) -> dict[ParticleType, int]:
        return {pt: int(self._num_part_total[pt.value]) for pt in ParticleType.get_all()}

    def _get_number_of_particles_this_rank(self) -> dict[ParticleType, int]:
        my_idx = [self._file_paths.index(p) for p in self._my_files]
        out = {}
        for pt in ParticleType.get_all():
            mask = self._region_masks.get(pt)
            if mask is not None:
                out[pt] = int(mask.sum())
            else:
                out[pt] = int(self._per_file_counts[my_idx, pt.value].sum())
        return out

    # -- raw reads ----------------------------------------------------------------
    def _read_dataset(self, particle_type: ParticleType, field: str, trailing=()):
        """Concatenate a field over this process's files. With a region
        restriction active, only the Cells-selected row ranges are read and
        non-intersecting files are never opened — the native SWIFT spatial
        masking the (broken) reference SWIFT backend left on the table."""
        ranges = self._region_rows.get(particle_type)
        parts = []
        a_exp = 0.0
        cgs = 1.0
        attrs_seen = False
        n_groups = n_found = 0
        for fidx, path in enumerate(self._my_files):
            if ranges is not None and not ranges[fidx]:
                continue  # no selected rows: do not even open the file
            with h5py.File(path, "r") as f:
                key = f"{particle_type.common_hdf5_name}/{field}"
                if particle_type.common_hdf5_name in f:
                    n_groups += 1
                if key in f:
                    n_found += 1
                    ds = f[key]
                    if ranges is None:
                        parts.append(np.asarray(ds))
                    else:
                        for start, stop in ranges[fidx]:
                            parts.append(ds[start:stop])
                    cgs = float(ds.attrs.get(_CGS_KEY, 1.0))
                    a_exp = float(np.atleast_1d(ds.attrs.get("a-scale exponent", 0.0))[0])
                    attrs_seen = True
        if not attrs_seen:
            # every data-bearing file was pruned: still need the unit attrs
            for path in self._file_paths:
                with h5py.File(path, "r") as f:
                    key = f"{particle_type.common_hdf5_name}/{field}"
                    if key in f:
                        ds = f[key]
                        cgs = float(ds.attrs.get(_CGS_KEY, 1.0))
                        a_exp = float(
                            np.atleast_1d(ds.attrs.get("a-scale exponent", 0.0))[0]
                        )
                        break
        if 0 < n_found < n_groups:
            # present in SOME files only: concatenating would silently
            # misalign this field against every other (schema-fuzz
            # finding, round 5)
            raise SnapshotFormatError(
                f'Dataset "{field}" is present in only {n_found} of '
                f"{n_groups} {particle_type.common_hdf5_name} file groups "
                "of this snapshot."
            )
        if not parts:
            return np.empty((0, *trailing)), a_exp, cgs
        data = np.concatenate(parts, axis=0)
        mask = self._region_masks.get(particle_type)
        if mask is not None:
            data = data[mask]
        return data, a_exp, cgs

    # -- region restriction (native Cells metadata) -------------------------------
    def _load_cells(self):
        """SWIFT top-level cell metadata from file 0 (global across files):
        ``Cells/Meta-data`` (size), ``Cells/Centres``, per-type
        ``Counts``/``OffsetsInFile``/``Files``. Returns False when absent."""
        if self._cells_cache is not None:
            return self._cells_cache
        with h5py.File(self._file_paths[0], "r") as f:
            if "Cells" not in f:
                self._cells_cache = False
                return False
            c = f["Cells"]
            size = np.atleast_1d(np.asarray(c["Meta-data"].attrs["size"], np.float64))
            if size.shape[0] == 1:
                size = np.repeat(size, 3)
            centres = np.asarray(c["Centres"], np.float64)
            per_type = {}
            for pt in ParticleType.get_all():
                name = pt.common_hdf5_name
                if f"Counts/{name}" in c:
                    counts = np.asarray(c[f"Counts/{name}"], np.int64)
                    offsets = np.asarray(c[f"OffsetsInFile/{name}"], np.int64)
                    if f"Files/{name}" in c:
                        files = np.asarray(c[f"Files/{name}"], np.int64)
                    elif len(self._file_paths) == 1:
                        # single-file snapshot: every cell trivially lives
                        # in file 0
                        files = np.zeros(centres.shape[0], np.int64)
                    else:
                        # multi-file snapshot with no Files/<type> map:
                        # cell->file attribution is unknown, and assuming
                        # file 0 would make the row ranges for files 1..N-1
                        # empty — in-region particles in those files would
                        # be silently dropped. Skip Cells pruning for this
                        # type; the exact membership mask over whole-file
                        # reads still applies.
                        continue
                    per_type[pt] = (counts, offsets, files)
            self._cells_cache = (centres, size, per_type)
        return self._cells_cache

    def restrict_data_comoving_loading_region(
        self, min_x, max_x, min_y, max_y, min_z, max_z
    ) -> None:
        """Restrict subsequent reads to co-moving Mpc box region(s), pruned
        through SWIFT's native ``Cells`` metadata when present (exact masks
        either way; same semantics as the EAGLE backend, inverted ranges
        wrap the periodic boundary)."""
        def to_mpc_list(v):
            if isinstance(v, UnitArray):
                v = v.to_value("Mpc")
            return np.atleast_1d(np.asarray(v, dtype=np.float64))

        bounds = [to_mpc_list(b) for b in (min_x, max_x, min_y, max_y, min_z, max_z)]
        n_regions = bounds[0].shape[0]
        if any(b.shape[0] != n_regions for b in bounds):
            raise ValueError("All region bound sequences must have the same length.")
        self._regions = [tuple(b[i] for b in bounds) for i in range(n_regions)]
        self._region_masks = {}
        self._region_rows = {}
        self._dm_hsml_cache = None  # k-NN h depends on the loaded subset
        self._build_region_selection()
        self._update_number_of_particles()

    def restrict_data_proper_loading_region(self, min_x, max_x, min_y, max_y, min_z, max_z):
        conv = lambda v: self.to_comoving_length(
            v if not isinstance(v, UnitArray) else v.to_value("Mpc")
        )
        self.restrict_data_comoving_loading_region(
            conv(min_x), conv(max_x), conv(min_y), conv(max_y), conv(min_z), conv(max_z)
        )

    def clear_region_restriction(self) -> None:
        self._regions = None
        self._region_masks = {}
        self._region_rows = {}
        self._dm_hsml_cache = None
        self._update_number_of_particles()

    def _build_region_selection(self) -> None:
        box = float(self.box_size.value[0])
        scale = self._length_cgs / C.MEGAPARSEC_CGS  # internal -> Mpc
        cells = self._load_cells()
        for pt in ParticleType.get_all():
            if self._num_part_total[pt.value] == 0:
                self._region_masks[pt] = None
                self._region_rows[pt] = None
                continue
            if cells:
                centres, size, per_type = cells
                if pt in per_type:
                    counts, offsets, files = per_type[pt]
                    mins = (centres - 0.5 * size[None, :]) * scale
                    maxs = (centres + 0.5 * size[None, :]) * scale
                    sel = interval_overlap_mask(mins, maxs, self._regions, box)
                    ranges_per_file = []
                    for path in self._my_files:
                        g = self._file_paths.index(path)
                        in_file = sel & (files == g) & (counts > 0)
                        cidx = np.flatnonzero(in_file)
                        cidx = cidx[np.argsort(offsets[cidx], kind="stable")]
                        ranges = []
                        for ci in cidx:
                            start = int(offsets[ci])
                            stop = start + int(counts[ci])
                            if ranges and start <= ranges[-1][1]:
                                ranges[-1] = (ranges[-1][0], max(stop, ranges[-1][1]))
                            else:
                                ranges.append((start, stop))
                        ranges_per_file.append(ranges)
                    self._region_rows[pt] = ranges_per_file
            # exact membership mask over the (possibly pruned) rows
            saved = self._region_masks
            self._region_masks = {}
            raw, _, _ = self._read_dataset(pt, "Coordinates", trailing=(3,))
            self._region_masks = saved
            self._region_masks[pt] = region_membership_mask(
                raw * scale, self._regions, box
            )

    def _cgs_field(
        self, particle_type: ParticleType, field: str, cgs_units: str,
        use_proper_units: bool = False, trailing=(),
    ) -> UnitArray:
        data, a_exp, cgs = self._read_dataset(particle_type, field, trailing)
        factor = cgs * (self.a**a_exp if use_proper_units else 1.0)
        return unit_array(data * factor, cgs_units)

    # -- field getters ---------------------------------------------------------------
    def _get_IDs(self, particle_type: ParticleType) -> np.ndarray:
        data, *_ = self._read_dataset(particle_type, "ParticleIDs")
        return data.astype(np.int64)

    def _get_positions(self, particle_type, use_proper_units) -> UnitArray:
        return self._cgs_field(
            particle_type, "Coordinates", "cm", use_proper_units, trailing=(3,)
        ).to("Mpc")

    def _get_velocities(self, particle_type, use_proper_units) -> UnitArray:
        return self._cgs_field(
            particle_type, "Velocities", "cm/s", use_proper_units, trailing=(3,)
        ).to("km/s")

    def _get_masses(self, particle_type: ParticleType) -> UnitArray:
        return self._cgs_field(particle_type, "Masses", "g").to("Msun")

    def _get_black_hole_subgrid_masses(self) -> UnitArray:
        return self._cgs_field(ParticleType.black_hole, "SubgridMasses", "g").to("Msun")

    def _get_black_hole_dynamical_masses(self) -> UnitArray:
        return self._cgs_field(ParticleType.black_hole, "DynamicalMasses", "g").to("Msun")

    def _get_smoothing_lengths(self, particle_type, use_proper_units) -> UnitArray:
        if particle_type == ParticleType.dark_matter:
            return self._dm_smoothing_lengths(use_proper_units)
        return self._cgs_field(
            particle_type, "SmoothingLengths", "cm", use_proper_units
        ).to("Mpc")

    # "auto" picks by DM_HSML_DEVICE_THRESHOLD; "grid" / "kdtree" force an
    # engine; the grid runs on dm_hsml_device
    dm_hsml_engine: str = "auto"
    dm_hsml_device = "cuda"
    DM_HSML_DEVICE_THRESHOLD: int = DM_HSML_DEVICE_THRESHOLD

    def _dm_hsml_pick_engine(self, n: int) -> str:
        """Engine for an n-particle DM k-NN pass: the device grid from
        ``DM_HSML_DEVICE_THRESHOLD`` particles, the host KDTree below,
        unless ``dm_hsml_engine`` forces one."""
        engine = self.dm_hsml_engine
        if engine == "auto":
            return "grid" if n >= self.DM_HSML_DEVICE_THRESHOLD else "kdtree"
        return engine

    def _dm_smoothing_lengths(self, use_proper_units: bool) -> UnitArray:
        """k-NN derived DM smoothing lengths (`_SnapshotSWIFT.py:58-85`,
        with the chunk-slice bug fixed): :func:`dm_smoothing_lengths` with
        the engine ``_dm_hsml_pick_engine`` names."""
        if self._dm_hsml_cache is None:
            pos = self.get_positions(ParticleType.dark_matter).to_value("Mpc")
            box = float(self.box_size.value[0])
            engine = self._dm_hsml_pick_engine(pos.shape[0])
            self._dm_hsml_cache = dm_smoothing_lengths(pos, box, engine, self.dm_hsml_device)
        result = unit_array(self._dm_hsml_cache.copy(), "Mpc")
        return result * self.a if use_proper_units else result

    def _get_sfr(self) -> UnitArray:
        return self._cgs_field(ParticleType.gas, "StarFormationRates", "g/s").to("Msun/yr")

    def _get_metallicities(self, particle_type, solar_units, solar_metallicity) -> UnitArray:
        data, *_ = self._read_dataset(particle_type, "MetalMassFractions")
        result = unit_array(data, "")
        if not solar_units:
            return result
        if solar_metallicity is None:
            raise ValueError(
                "SWIFT snapshots carry no Z_Solar; pass solar_metallicity explicitly."
            )
        return result / solar_metallicity

    def _get_mean_enrichment_redshift(self, particle_type: ParticleType) -> UnitArray:
        data, *_ = self._read_dataset(particle_type, "MeanMetalWeightedRedshifts")
        return unit_array(data, "")

    def _get_densities(self, particle_type, use_proper_units) -> UnitArray:
        return self._cgs_field(
            particle_type, "Densities", "g/cm**3", use_proper_units
        ).to("Msun/Mpc**3")

    def _get_temperatures(self, particle_type: ParticleType) -> UnitArray:
        data, *_ = self._read_dataset(particle_type, "Temperatures")
        return unit_array(data, "K")

    def _get_elemental_abundance(self, particle_type: ParticleType, element: str) -> UnitArray:
        if element not in SWIFT_ELEMENT_ORDER:
            raise ValueError(f'Element "{element}" not tracked in SWIFT snapshots.')
        data, *_ = self._read_dataset(
            particle_type, "ElementMassFractions", trailing=(len(SWIFT_ELEMENT_ORDER),)
        )
        return unit_array(data[:, SWIFT_ELEMENT_ORDER.index(element)], "")

    def _get_number_densities(
        self, particle_type, element, use_proper_units, default_abundance
    ) -> UnitArray:
        rho = self._cgs_field(particle_type, "Densities", "g/cm**3", use_proper_units)
        if default_abundance is not None:
            abundance = default_abundance
        else:
            abundance = self._get_elemental_abundance(particle_type, element).value
        atomic_weight_g = C.ATOMIC_WEIGHTS[element] * C.ATOMIC_MASS_UNIT_CGS_REFERENCE
        return unit_array(rho.value * abundance / atomic_weight_g, "cm**-3")

    # -- filepath generate/scrape utilities ---------------------------------
    # Semantics follow `io/SWIFT/_SnapshotSWIFT.py:115-283`; candidates are
    # validated by HDF5 header shape (h5py) rather than a full swiftsimio
    # load, and the parallel-rank branch of generate_filepaths returns a
    # {rank: path} dict as its signature documents (the reference calls
    # os.path.abspath on a tuple there, which raises).

    @staticmethod
    def generate_filepaths(
        *snapshot_number_strings: str,
        directory: str,
        basename: str,
        file_extension: str = "hdf5",
        parallel_ranks: Optional[list[int]] = None,
    ) -> dict:
        """Build snapshot filepaths from name components
        (`_SnapshotSWIFT.py:115-134`). Returns {number: path} or, with
        ``parallel_ranks``, {number: {rank: path}}."""
        file_extension = file_extension.strip(".")
        results: dict = {}
        for num in snapshot_number_strings:
            if parallel_ranks is None:
                results[num] = os.path.abspath(
                    os.path.join(directory, f"{basename}{num}.{file_extension}")
                )
            else:
                results[num] = {
                    p: os.path.abspath(
                        os.path.join(directory, f"{basename}{num}.{p}.{file_extension}")
                    )
                    for p in parallel_ranks
                }
        return results

    @staticmethod
    def _is_swift_snapshot_file(path: str) -> bool:
        try:
            with h5py.File(path, "r") as f:
                return "Header" in f and "Cosmology" in f
        except OSError:
            return False

    @staticmethod
    def scrape_filepaths(
        directory: str,
    ) -> tuple[tuple[str, tuple[str, ...], Optional[tuple[int, ...]], str], ...]:
        """Identify snapshot naming-scheme groups in *directory*
        (`_SnapshotSWIFT.py:136-204`): one entry per basename as
        (basename, number strings, parallel ids or None, extension)."""
        pattern = re.compile(
            r"(?P<basename>[^/]+?)(?P<file_number>\d+)"
            r"(?:\.(?P<parallel_id>(?:[1-9]\d*|0)))?\.(?P<extension>\w+)$"
        )
        file_groups: dict[str, dict] = {}
        for filename in sorted(os.listdir(directory)):
            m = pattern.match(filename)
            if not m:
                continue
            basename = m.group("basename")
            extension = m.group("extension")
            if extension in ("siminfo", "units"):
                continue
            group = file_groups.setdefault(
                basename,
                {"extension": extension, "number_strings": [], "parallel_ids": None},
            )
            if extension != group["extension"]:
                raise IOError(
                    "Inconsistent file extension for snapshots with the same basename."
                )
            parallel_id = m.group("parallel_id")
            if parallel_id is not None:
                if len(group["number_strings"]) == 0:
                    group["parallel_ids"] = []
                elif group["parallel_ids"] is None:
                    raise IOError(
                        "Inconsistent parallel snapshot format for snapshots "
                        "with the same basename."
                    )
                if int(parallel_id) not in group["parallel_ids"]:
                    group["parallel_ids"].append(int(parallel_id))
            if m.group("file_number") not in group["number_strings"]:
                group["number_strings"].append(m.group("file_number"))

        valid = []
        for basename, group in file_groups.items():
            parallel_component = (
                "" if group["parallel_ids"] is None else f".{group['parallel_ids'][-1]}"
            )
            test_file = os.path.join(
                directory,
                f"{basename}{group['number_strings'][-1]}"
                f"{parallel_component}.{group['extension']}",
            )
            if SnapshotSWIFT._is_swift_snapshot_file(test_file):
                valid.append(basename)
        return tuple(
            (
                basename,
                tuple(file_groups[basename]["number_strings"]),
                tuple(file_groups[basename]["parallel_ids"])
                if file_groups[basename]["parallel_ids"] is not None
                else None,
                file_groups[basename]["extension"],
            )
            for basename in valid
        )

    @staticmethod
    def generate_filepaths_from_partial_info(
        directory: str,
        basename: Optional[str] = None,
        snapshot_number_strings: Optional[list[str]] = None,
        file_extension: Optional[str] = None,
        parallel_ranks: Optional[list[int]] = None,
    ) -> dict:
        """Scrape *directory* and narrow to one naming scheme
        (`_SnapshotSWIFT.py:206-263`)."""
        scraped = SnapshotSWIFT.scrape_filepaths(directory)
        candidates = [
            info
            for info in scraped
            if (basename is None or info[0] == basename)
            and (file_extension is None or info[3] == file_extension)
            and (parallel_ranks is None or info[2] is not None)
        ]
        if not candidates:
            raise FileNotFoundError("No snapshots match the partial specification.")
        if len(candidates) > 1:
            raise IOError(
                "Partial specification too general; more than one valid "
                "snapshot basename detected."
            )
        info = candidates[0]
        locations = SnapshotSWIFT.generate_filepaths(
            *info[1],
            directory=directory,
            basename=info[0],
            file_extension=info[3],
            parallel_ranks=info[2] if parallel_ranks is None else parallel_ranks,
        )
        if snapshot_number_strings is not None:
            missing = set(snapshot_number_strings) - set(locations)
            if missing:
                raise FileNotFoundError(
                    "Snapshot numbers provided not all present in directory."
                )
            locations = {
                k: v for k, v in locations.items() if k in snapshot_number_strings
            }
        if parallel_ranks is not None:
            scraped_ranks = set(info[2] or ())
            if not set(parallel_ranks) <= scraped_ranks:
                raise FileNotFoundError(
                    "Snapshot parallel chunk indexes provided not all present "
                    "in directory."
                )
        return locations

    @staticmethod
    def get_snapshot_order(snapshot_file_info, reverse: bool = False) -> list[str]:
        """Number strings sorted numerically (`_SnapshotSWIFT.py:279-283`)."""
        return sorted(snapshot_file_info, key=int, reverse=reverse)


class CatalogueSOAP(CatalogueBase):
    """SOAP/VELOCIraptor catalogue reader (`io/SWIFT/_CatalogueSOAP.py`)."""

    def __init__(self, catalogue_filepath: str, membership_filepath: str, snapshot: SnapshotSWIFT):
        self._catalogue_file = catalogue_filepath
        with h5py.File(catalogue_filepath, "r") as f:
            if "VR" not in f:
                raise SnapshotFormatError(
                    f"SOAP catalogue {catalogue_filepath} has no VR group."
                )
            self._halo_ids = np.asarray(f["VR/ID"], dtype=np.int64)
            parents = np.asarray(f["VR/Parent_halo_ID"], dtype=np.int64)
            hosts = np.asarray(f["VR/Host_halo_ID"], dtype=np.int64)
            # -1 sentinel: top-level haloes parent themselves (`:42-54`)
            self._parent_ids = np.where(parents == -1, self._halo_ids, parents)
            self._host_ids = np.where(hosts == -1, self._halo_ids, hosts)
        super().__init__(membership_filepath, catalogue_filepath, snapshot)
        self._membership_cache: dict[ParticleType, tuple[np.ndarray, np.ndarray]] = {}

    def _soap_field(self, field: str, cosmological: bool = False) -> tuple[np.ndarray, float]:
        with h5py.File(self._catalogue_file, "r") as f:
            ds = f[field]
            key = _CGS_KEY_COSMO if cosmological else _CGS_KEY
            cgs = float(np.atleast_1d(ds.attrs.get(key, 1.0))[0])
            return np.asarray(ds), cgs

    def _get_hierarchy_IDs(self):
        parents = np.where(self._parent_ids == self._halo_ids, -1, self._parent_ids)
        return self._halo_ids, parents

    def get_number_of_haloes(self, particle_type: Optional[ParticleType] = None) -> int:
        if particle_type is not None:
            raise NotImplementedError(
                "Per-particle-type halo counts not supported for SOAP catalogues."
            )
        return len(self._halo_ids)

    def get_halo_IDs(self, particle_type=None) -> np.ndarray:
        return self._halo_ids.copy()

    def get_halo_indexes(self, particle_type=None) -> np.ndarray:
        return np.arange(len(self._halo_ids), dtype=np.int64)

    def get_halo_parent_IDs(self, particle_type=None) -> np.ndarray:
        return self._parent_ids.copy()

    def get_halo_parent_indexes(self, particle_type=None) -> np.ndarray:
        order = np.argsort(self._halo_ids)
        pos = np.searchsorted(self._halo_ids[order], self._parent_ids)
        return order[np.clip(pos, 0, len(order) - 1)]

    def get_halo_top_level_parent_IDs(self, particle_type=None) -> np.ndarray:
        return self._host_ids.copy()

    def get_halo_top_level_parent_indexes(self, particle_type=None) -> np.ndarray:
        order = np.argsort(self._halo_ids)
        pos = np.searchsorted(self._halo_ids[order], self._host_ids)
        return order[np.clip(pos, 0, len(order) - 1)]

    def get_halo_centres_of_mass(self, particle_type=None, use_proper_units=False) -> UnitArray:
        data, cgs = self._soap_field("VR/CentreOfMass")
        factor = cgs * (self.snapshot.a if use_proper_units else 1.0)
        return unit_array(data * factor, "cm").to("Mpc")

    def get_halo_centres_of_potential(self, particle_type=None, use_proper_units=False) -> UnitArray:
        data, cgs = self._soap_field("VR/CentreOfPotential")
        factor = cgs * (self.snapshot.a if use_proper_units else 1.0)
        return unit_array(data * factor, "cm").to("Mpc")

    def get_halo_masses(self, halo_type: IHaloDefinition, particle_type=None) -> UnitArray:
        if isinstance(halo_type, CriticalSphericalOverdensityAperture):
            field = f"SO/{halo_type.overdensity_limit}_crit/TotalMass"
        elif isinstance(halo_type, FOFGroup):
            field = "BoundSubhalo/TotalMass"
        else:
            raise halo_type.make_error(CatalogueSOAP)
        data, cgs = self._soap_field(field)
        # f64 conversion: f32 on-disk data overflows in CGS grams
        return unit_array(np.asarray(data, np.float64) * cgs, "g").to("Msun")

    def get_halo_radii(self, halo_type, particle_type=None, use_proper_units=False) -> UnitArray:
        if not isinstance(halo_type, CriticalSphericalOverdensityAperture):
            raise halo_type.make_error(CatalogueSOAP)
        field = f"SO/{halo_type.overdensity_limit}_crit/SORadius"
        data, cgs = self._soap_field(field)
        factor = cgs * (self.snapshot.a if use_proper_units else 1.0)
        return unit_array(data * factor, "cm").to("Mpc")

    def _membership(self, particle_type: ParticleType) -> tuple[np.ndarray, np.ndarray]:
        """(GroupNr_all, GroupNr_bound) halo indexes per snapshot particle
        (-1 = none), concatenated per type (`_CatalogueSOAP.py:72-101`)."""
        if particle_type not in self._membership_cache:
            with h5py.File(self.membership_filepath, "r") as f:
                g = f[particle_type.common_hdf5_name]
                self._membership_cache[particle_type] = (
                    np.asarray(g["GroupNr_all"], dtype=np.int64),
                    np.asarray(g["GroupNr_bound"], dtype=np.int64),
                )
        return self._membership_cache[particle_type]

    def get_halo_indexes_by_snapshot_particle(
        self, particle_type: ParticleType, snapshot_particle_ids=None, bound_only: bool = False
    ) -> np.ndarray:
        gnr_all, gnr_bound = self._membership(particle_type)
        result = (gnr_bound if bound_only else gnr_all).copy()
        if snapshot_particle_ids is None:
            return result
        from ..ops.reorder import ArrayReorder

        return ArrayReorder.create(
            self.snapshot.get_IDs(particle_type), snapshot_particle_ids
        )(result, default_value=-1)

    def get_halo_IDs_by_snapshot_particle(
        self, particle_type: ParticleType, snapshot_particle_ids=None
    ) -> np.ndarray:
        idx = self.get_halo_indexes_by_snapshot_particle(particle_type, snapshot_particle_ids)
        out = np.full_like(idx, -1)
        valid = idx >= 0
        out[valid] = self._halo_ids[idx[valid]]
        return out

    def get_particle_IDs(self, particle_type: ParticleType, include_unbound: bool = True) -> np.ndarray:
        gnr_all, gnr_bound = self._membership(particle_type)
        member = (gnr_all if include_unbound else gnr_bound) >= 0
        return self.snapshot.get_IDs(particle_type)[member]
