"""Particle-filter sidecar file format (HDF5 ID allowlists + masks).

Parity target: ``ParticleFilterFile``
(`astro_sph_tools/io/_ParticleFilter.py:28-441` — broken
in-tree via dead imports, SURVEY.md §2.9.5, but documenting a real
capability): an HDF5 sidecar that records, per snapshot and per sightline,
the particle-ID allowlist and boolean mask selected by some analysis, with a
versioned header (version, creation date, description, source file,
simulation type, data directories), write-once protection with an explicit
parallel-append mode, a version-skew warning on read (`:258-261`), and a
file-lock retry loop for contended parallel writes (10-minute budget,
10-second poll — `:24,337-351`).

On-disk layout::

    /Header            attrs: Version, Date, Description, SourceFile,
                              SimulationType, SnapshotsDirectory, LineOfSightDirectory
    /SnapshotFilters/<file_key>/<PartTypeN>/{AllowedIDs, Mask}
                               attrs: Redshift, SnapshotNumber, Filepath
    /LineOfSightFilters/<file_key>/LOS<i>/<PartTypeN>/{AllowedIDs, Mask}
                               attrs: Redshift, FileName, Index, Filepath

Counterpart: ``astro_sph_tools_tpu/io/particle_filter.py``
(copied; ``h5py`` is imported on first use).
"""

from __future__ import annotations

import datetime
import os
import time
from dataclasses import dataclass, field
from typing import Optional

from ._lazy import h5py
import numpy as np

from ..__about__ import __version__
from ..data_structures.particle_types import ParticleType
from ..utils.console import print_warning

FILE_LOCK_TIMEOUT_SECONDS = 600.0  # reference: 10 min budget
FILE_LOCK_POLL_SECONDS = 10.0  # reference: 10 s poll


@dataclass
class SnapshotParticleFilter:
    """Filter for one (snapshot, particle type) (`_ParticleFilter.py:28-55`)."""

    particle_type: ParticleType
    redshift: float
    snapshot_number: str
    filepath: str
    allowed_ids: np.ndarray
    mask: np.ndarray


@dataclass
class LineOfSightParticleFilter:
    """Filter for one (LOS file, sightline, type) (`_ParticleFilter.py:58-90`)."""

    particle_type: ParticleType
    redshift: float
    file_name: str
    line_of_sight_index: int
    filepath: str
    allowed_ids: np.ndarray
    mask: np.ndarray


def _file_key(path: str) -> str:
    return os.path.basename(path).replace("/", "_")


@dataclass
class ParticleFilterFile:
    """Read/write access to a particle-filter sidecar.

    Opening an existing file loads it read-only (write-once protection,
    `_ParticleFilter.py:146-161`) unless ``allow_parallel_write`` is set,
    which enables appending new filter groups from multiple processes.
    """

    filepath: str
    allow_parallel_write: bool = False
    description: str = ""
    source_file: str = ""
    simulation_type: str = ""
    snapshots_directory: Optional[str] = None
    line_of_sight_directory: Optional[str] = None
    date: Optional[datetime.date] = None
    version: str = __version__
    snapshot_filters: dict = field(default_factory=dict)
    line_of_sight_filters: dict = field(default_factory=dict)

    def __post_init__(self):
        if os.path.exists(self.filepath) and not self.allow_parallel_write:
            self._writable = False
            self._read()
        else:
            self._writable = True
            if self.date is None:
                self.date = datetime.date.today()

    @property
    def writable(self) -> bool:
        return self._writable

    # -- in-memory mutation -----------------------------------------------------
    def add_snapshot_filter(self, f: SnapshotParticleFilter) -> None:
        if not self._writable:
            raise PermissionError(
                "ParticleFilterFile opened from an existing file is read-only "
                "(write-once protection)."
            )
        self.snapshot_filters.setdefault(_file_key(f.filepath), {})[f.particle_type] = f

    def add_line_of_sight_filter(self, f: LineOfSightParticleFilter) -> None:
        if not self._writable:
            raise PermissionError(
                "ParticleFilterFile opened from an existing file is read-only "
                "(write-once protection)."
            )
        self.line_of_sight_filters.setdefault(_file_key(f.filepath), {}).setdefault(
            f.line_of_sight_index, {}
        )[f.particle_type] = f

    def get_snapshot_filter(self, filepath_or_key: str, particle_type: ParticleType):
        return self.snapshot_filters[_file_key(filepath_or_key)][particle_type]

    def get_line_of_sight_filter(
        self, filepath_or_key: str, index: int, particle_type: ParticleType
    ):
        return self.line_of_sight_filters[_file_key(filepath_or_key)][index][particle_type]

    # -- persistence ----------------------------------------------------------------
    def save(self) -> None:
        """Write (or append) the sidecar, retrying on contended access
        (`_ParticleFilter.py:337-351`)."""
        deadline = time.monotonic() + FILE_LOCK_TIMEOUT_SECONDS
        while True:
            try:
                self._write()
                return
            except (BlockingIOError, OSError) as err:
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"Could not acquire write access to {self.filepath} within "
                        f"{FILE_LOCK_TIMEOUT_SECONDS:.0f}s."
                    ) from err
                time.sleep(FILE_LOCK_POLL_SECONDS)

    def _write(self) -> None:
        mode = "a" if (self.allow_parallel_write and os.path.exists(self.filepath)) else "w"
        with h5py.File(self.filepath, mode) as f:
            hdr = f.require_group("Header")
            hdr.attrs["Version"] = self.version
            hdr.attrs["Date"] = self.date.isoformat()
            hdr.attrs["Description"] = self.description
            hdr.attrs["SourceFile"] = self.source_file
            hdr.attrs["SimulationType"] = self.simulation_type
            if self.snapshots_directory is not None:
                hdr.attrs["SnapshotsDirectory"] = self.snapshots_directory
            if self.line_of_sight_directory is not None:
                hdr.attrs["LineOfSightDirectory"] = self.line_of_sight_directory

            snaps = f.require_group("SnapshotFilters")
            for key, by_type in self.snapshot_filters.items():
                g_file = snaps.require_group(key)
                for pt, flt in by_type.items():
                    if pt.common_hdf5_name in g_file:
                        continue  # parallel append: keep existing
                    g = g_file.create_group(pt.common_hdf5_name)
                    g.attrs["Redshift"] = flt.redshift
                    g.attrs["SnapshotNumber"] = flt.snapshot_number
                    g.attrs["Filepath"] = flt.filepath
                    g.create_dataset("AllowedIDs", data=np.asarray(flt.allowed_ids, np.int64))
                    g.create_dataset("Mask", data=np.asarray(flt.mask, bool))

            los = f.require_group("LineOfSightFilters")
            for key, by_index in self.line_of_sight_filters.items():
                g_file = los.require_group(key)
                for index, by_type in by_index.items():
                    g_los = g_file.require_group(f"LOS{index}")
                    for pt, flt in by_type.items():
                        if pt.common_hdf5_name in g_los:
                            continue
                        g = g_los.create_group(pt.common_hdf5_name)
                        g.attrs["Redshift"] = flt.redshift
                        g.attrs["FileName"] = flt.file_name
                        g.attrs["Index"] = flt.line_of_sight_index
                        g.attrs["Filepath"] = flt.filepath
                        g.create_dataset("AllowedIDs", data=np.asarray(flt.allowed_ids, np.int64))
                        g.create_dataset("Mask", data=np.asarray(flt.mask, bool))

    def _read(self) -> None:
        with h5py.File(self.filepath, "r") as f:
            hdr = f["Header"].attrs
            self.version = _as_str(hdr["Version"])
            if self.version.split(".")[:2] != __version__.split(".")[:2]:
                # version-skew warning on read (`_ParticleFilter.py:258-261`)
                print_warning(
                    f"Particle filter file {self.filepath} was written by version "
                    f"{self.version}; reader is {__version__}."
                )
            self.date = datetime.date.fromisoformat(_as_str(hdr["Date"]))
            self.description = _as_str(hdr["Description"])
            self.source_file = _as_str(hdr["SourceFile"])
            self.simulation_type = _as_str(hdr["SimulationType"])
            self.snapshots_directory = (
                _as_str(hdr["SnapshotsDirectory"]) if "SnapshotsDirectory" in hdr else None
            )
            self.line_of_sight_directory = (
                _as_str(hdr["LineOfSightDirectory"]) if "LineOfSightDirectory" in hdr else None
            )

            self.snapshot_filters = {}
            for key, g_file in f.get("SnapshotFilters", {}).items():
                for pt_name, g in g_file.items():
                    pt = ParticleType(int(pt_name.removeprefix("PartType")))
                    self.snapshot_filters.setdefault(key, {})[pt] = SnapshotParticleFilter(
                        particle_type=pt,
                        redshift=float(g.attrs["Redshift"]),
                        snapshot_number=_as_str(g.attrs["SnapshotNumber"]),
                        filepath=_as_str(g.attrs["Filepath"]),
                        allowed_ids=np.asarray(g["AllowedIDs"]),
                        mask=np.asarray(g["Mask"]),
                    )

            self.line_of_sight_filters = {}
            for key, g_file in f.get("LineOfSightFilters", {}).items():
                for los_name, g_los in g_file.items():
                    index = int(los_name.removeprefix("LOS"))
                    for pt_name, g in g_los.items():
                        pt = ParticleType(int(pt_name.removeprefix("PartType")))
                        self.line_of_sight_filters.setdefault(key, {}).setdefault(index, {})[
                            pt
                        ] = LineOfSightParticleFilter(
                            particle_type=pt,
                            redshift=float(g.attrs["Redshift"]),
                            file_name=_as_str(g.attrs["FileName"]),
                            line_of_sight_index=index,
                            filepath=_as_str(g.attrs["Filepath"]),
                            allowed_ids=np.asarray(g["AllowedIDs"]),
                            mask=np.asarray(g["Mask"]),
                        )


def _as_str(v) -> str:
    return v.decode() if isinstance(v, bytes) else str(v)
