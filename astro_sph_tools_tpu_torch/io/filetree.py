"""Simulation file-tree discovery: generic protocol + EAGLE scraper.

Parity targets:
- tree/leaf protocol (`astro_sph_tools/io/data_structures/
  _tree_structures.py:15-89`) and ``FileTreeScraperBase``
  (`_FileTreeScraper.py:20-56`);
- EAGLE scraper (`io/EAGLE/_EAGLE.py`): ``os.walk`` + regex over the
  snapshot / snipshot / catalogue-membership / catalogue-properties naming
  schemes (`:57-58,237-240`), parallel indices grouped per tag, lazy
  ``load()`` leaves, lookup by number/tag/redshift with the closest-z >=
  query semantics and distance warnings (`:141-151`), and the
  path-relocation helpers (`:426-474`).

Design: one generic ``TaggedFileSet`` handles scrape/group/sort/lookup for
any (directory pattern, file pattern) naming scheme — the reference's four
near-identical scraper classes collapse into configurations of it.

Counterpart: ``astro_sph_tools_tpu/io/filetree.py`` (copied).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Callable, Generic, Iterable, Iterator, Optional, TypeVar

import numpy as np

from ..utils.console import print_verbose_warning

T = TypeVar("T")


def tag_redshift(tag: str) -> float:
    """Redshift from a tag like '012_z000p503'."""
    z_part = tag.split("_z")[1]
    integer, _, decimal = z_part.partition("p")
    return float(f"{integer}.{decimal}")


def tag_expansion_factor(tag: str) -> float:
    return 1.0 / (1.0 + tag_redshift(tag))


@dataclass
class FileSetLeaf:
    """One output (snapshot/snipshot/catalogue) discovered on disk."""

    number: str
    tag: str
    filepaths: tuple[str, ...]
    loader: Optional[Callable[["FileSetLeaf"], object]] = None
    # catalogue leaves carry a second file set + their snapshot leaf
    secondary_filepaths: tuple[str, ...] = ()
    snapshot_leaf: Optional["FileSetLeaf"] = None

    def __len__(self) -> int:
        return len(self.filepaths)

    @property
    def filepath(self) -> str:
        return self.filepaths[0]

    @property
    def number_numerical(self) -> int:
        return int(self.number)

    @property
    def tag_redshift(self) -> float:
        return tag_redshift(self.tag)

    @property
    def tag_expansion_factor(self) -> float:
        return tag_expansion_factor(self.tag)

    # catalogue aliases (`_EAGLE.py:223-233`)
    @property
    def membership_filepaths(self) -> tuple[str, ...]:
        return self.filepaths

    @property
    def membership_filepath(self) -> str:
        return self.filepaths[0]

    @property
    def properties_filepaths(self) -> tuple[str, ...]:
        return self.secondary_filepaths

    @property
    def properties_filepath(self) -> str:
        return self.secondary_filepaths[0]

    def load(self):
        if self.loader is None:
            raise NotImplementedError("No loader attached to this leaf.")
        return self.loader(self)


class TaggedFileSet(Generic[T]):
    """Scrape a directory for tag-grouped parallel file sets.

    ``pattern`` must expose groups ``number``, ``redshift_int``,
    ``redshift_dec``, ``parallel_index``; files group by tag
    ``{number}_z{int}p{dec}`` with sorted parallel indices.
    """

    def __init__(
        self,
        directory: str,
        pattern: re.Pattern,
        kind: str,
        skip_numbers: Optional[Iterable[str]] = None,
        loader: Optional[Callable[[FileSetLeaf], object]] = None,
    ) -> None:
        self._directory = os.path.realpath(directory)
        self._kind = kind
        skip = set(skip_numbers or ())
        groups: dict[str, list[tuple[int, str]]] = {}
        numbers: dict[str, str] = {}
        for root, _, files in os.walk(self._directory):
            for filename in files:
                path = os.path.join(root, filename)
                m = pattern.match(path)
                if not m:
                    continue
                number = m.group("number")
                if number in skip:
                    continue
                tag = f"{number}_z{m.group('redshift_int')}p{m.group('redshift_dec')}"
                groups.setdefault(tag, []).append((int(m.group("parallel_index")), path))
                numbers[tag] = number

        self._leaves: list[FileSetLeaf] = []
        for tag, entries in groups.items():
            entries.sort()
            self._leaves.append(
                FileSetLeaf(
                    number=numbers[tag],
                    tag=tag,
                    filepaths=tuple(p for _, p in entries),
                    loader=loader,
                )
            )
        self._leaves.sort(key=lambda leaf: leaf.number_numerical)
        self._by_number = {leaf.number: leaf for leaf in self._leaves}
        self._by_tag = {leaf.tag: leaf for leaf in self._leaves}

    @property
    def directory(self) -> str:
        return self._directory

    def __iter__(self) -> Iterator[FileSetLeaf]:
        return iter(self._leaves)

    def __len__(self) -> int:
        return len(self._leaves)

    def __getitem__(self, key):
        if isinstance(key, slice):
            return tuple(self._leaves[key])
        return self._leaves[key]

    def get_info(self) -> tuple[FileSetLeaf, ...]:
        return tuple(self._leaves)

    def get_numbers(self) -> tuple[str, ...]:
        return tuple(leaf.number for leaf in self._leaves)

    def get_tags(self) -> tuple[str, ...]:
        return tuple(leaf.tag for leaf in self._leaves)

    def get_by_number(self, number: str) -> FileSetLeaf:
        if number not in self._by_number:
            raise KeyError(
                f'{self._kind.title()} number "{number}" not available '
                "(make sure the input datatype is a string)."
            )
        return self._by_number[number]

    def get_by_numbers(self, numbers: Iterable[str]) -> tuple[FileSetLeaf, ...]:
        return tuple(self.get_by_number(n) for n in numbers)

    def get_by_tag(self, tag: str) -> FileSetLeaf:
        if tag not in self._by_tag:
            raise KeyError(f'{self._kind.title()} tag "{tag}" not available.')
        return self._by_tag[tag]

    def get_by_redshift(self, redshift: float) -> FileSetLeaf:
        return self.get_by_number(self.find_file_number_from_redshift(redshift))

    def find_file_number_from_redshift(self, redshift: float) -> str:
        """Closest file with z_file >= z_query; warns if the gap exceeds 0.5
        (z >= 1) or 0.1 (z < 1) (`_EAGLE.py:141-151`)."""
        numbers = np.array(self.get_numbers(), dtype=str)
        numbers = numbers[np.argsort([float(v) for v in numbers])]
        redshifts = np.array(
            [self.get_by_number(n).tag_redshift for n in numbers], dtype=float
        )
        prior = redshifts >= redshift
        if prior.sum() == 0:
            raise FileNotFoundError(
                f"Unable to find search data for a file with a redshift of (or "
                f"exceeding) {redshift}.\nThe first file has a redshift of {redshifts[0]}."
            )
        selected = redshifts[prior][-1]
        if (redshift >= 1.0 and redshift - selected > 0.5) or (
            redshift < 1.0 and redshift - selected > 0.1
        ):
            print_verbose_warning(
                f"Attempted to find data at z={redshift} but only managed to "
                f"retrieve data for z=~{selected}."
            )
        return str(numbers[prior][-1])


class FileTreeScraperBase:
    """Root-directory bookkeeping (`_FileTreeScraper.py:20-56`)."""

    def __init__(
        self,
        root_directories: dict[str, str],
        skip_snapshot_numbers: Optional[Iterable[str]] = None,
        skip_snipshot_numbers: Optional[Iterable[str]] = None,
    ) -> None:
        self._root_directories = dict(root_directories)
        self._skip_snapshots = tuple(skip_snapshot_numbers or ())
        self._skip_snipshots = tuple(skip_snipshot_numbers or ())

    @property
    def root_directories(self) -> dict[str, str]:
        return dict(self._root_directories)

    @property
    def skipped_snapshot_numbers(self) -> tuple[str, ...]:
        return self._skip_snapshots

    @property
    def skipped_snipshot_numbers(self) -> tuple[str, ...]:
        return self._skip_snipshots


# --- EAGLE naming schemes (`_EAGLE.py:57-58,237-240`) -------------------------

_EAGLE_SNAPSHOT = re.compile(
    r".*snapshot_(?P<number>\d{3})_z(?P<redshift_int>\d+)p(?P<redshift_dec>\d+)"
    r"[\\/]snap_(?P=number)_z(?P=redshift_int)p(?P=redshift_dec)\.(?P<parallel_index>\d+)\.(?P<extension>\w+)$"
)
_EAGLE_SNIPSHOT = re.compile(
    r".*snipshot_(?P<number>\d{3})_z(?P<redshift_int>\d+)p(?P<redshift_dec>\d+)"
    r"[\\/]snip_(?P=number)_z(?P=redshift_int)p(?P=redshift_dec)\.(?P<parallel_index>\d+)\.(?P<extension>\w+)$"
)
_EAGLE_MEMBERSHIP = re.compile(
    r".*particledata_(?P<number>\d{3})_z(?P<redshift_int>\d+)p(?P<redshift_dec>\d+)"
    r"[\\/]eagle_subfind_particles_(?P=number)_z(?P=redshift_int)p(?P=redshift_dec)\.(?P<parallel_index>\d+)\.(?P<extension>\w+)$"
)
_EAGLE_SNIP_MEMBERSHIP = re.compile(
    r".*particledata_snip_(?P<number>\d{3})_z(?P<redshift_int>\d+)p(?P<redshift_dec>\d+)"
    r"[\\/]eagle_subfind_snip_particles_(?P=number)_z(?P=redshift_int)p(?P=redshift_dec)\.(?P<parallel_index>\d+)\.(?P<extension>\w+)$"
)
_EAGLE_PROPERTIES = re.compile(
    r".*groups_(?P<number>\d{3})_z(?P<redshift_int>\d+)p(?P<redshift_dec>\d+)"
    r"[\\/]eagle_subfind_tab_(?P=number)_z(?P=redshift_int)p(?P=redshift_dec)\.(?P<parallel_index>\d+)\.(?P<extension>\w+)$"
)
_EAGLE_SNIP_PROPERTIES = re.compile(
    r".*groups_snip_(?P<number>\d{3})_z(?P<redshift_int>\d+)p(?P<redshift_dec>\d+)"
    r"[\\/]eagle_subfind_snip_tab_(?P=number)_z(?P=redshift_int)p(?P=redshift_dec)\.(?P<parallel_index>\d+)\.(?P<extension>\w+)$"
)


def _load_snapshot(leaf: FileSetLeaf):
    from .eagle import SnapshotEAGLE

    return SnapshotEAGLE(leaf.filepath)


def _load_catalogue(leaf: FileSetLeaf):
    """Construct the catalogue *and* its snapshot (`_EAGLE.py:199-200`)."""
    from .subfind import CatalogueSUBFIND

    snapshot = leaf.snapshot_leaf.load()
    return CatalogueSUBFIND(
        list(leaf.membership_filepaths), list(leaf.properties_filepaths), snapshot
    )


def _catalogue_file_set(
    directory: str,
    membership_pattern: re.Pattern,
    properties_pattern: re.Pattern,
    snapshots: TaggedFileSet,
    kind: str,
    skip_numbers,
) -> TaggedFileSet:
    membership = TaggedFileSet(directory, membership_pattern, kind, skip_numbers)
    properties = TaggedFileSet(directory, properties_pattern, kind, skip_numbers)
    # merge: membership files are primary, properties secondary, paired with
    # the matching snapshot leaf by tag
    merged_leaves = []
    for tag in properties.get_tags():
        prop_leaf = properties.get_by_tag(tag)
        try:
            memb_leaf = membership.get_by_tag(tag)
        except KeyError:
            continue
        try:
            snap_leaf = snapshots.get_by_tag(tag)
        except KeyError:
            snap_leaf = None
        merged_leaves.append(
            FileSetLeaf(
                number=prop_leaf.number,
                tag=tag,
                filepaths=memb_leaf.filepaths,
                secondary_filepaths=prop_leaf.filepaths,
                snapshot_leaf=snap_leaf,
                loader=_load_catalogue,
            )
        )
    result = properties  # reuse lookup machinery
    result._leaves = sorted(merged_leaves, key=lambda l: l.number_numerical)
    result._by_number = {l.number: l for l in result._leaves}
    result._by_tag = {l.tag: l for l in result._leaves}
    return result


# --- TNG naming schemes -------------------------------------------------------
# The reference's TNG scraper cloned the EAGLE machinery but left EAGLE-style
# snapshot patterns while its constructor expected snapdir_NNN/snap_NNN.K.hdf5
# (`io/TNG/_TNG.py:57-58` vs `_SnapshotTNG.py:64` — stale, SURVEY.md §2.5).
# These patterns match the real TNG layout. TNG names carry no redshift, so
# the tag is synthesised from the header when leaves load.

_TNG_SNAPSHOT = re.compile(
    r".*snapdir_(?P<number>\d{3})[\\/]snap_(?P=number)\.(?P<parallel_index>\d+)\.(?P<extension>hdf5)$"
)
_TNG_GROUPCAT = re.compile(
    r".*groups_(?P<number>\d{3})[\\/]fof_subhalo_tab_(?P=number)\.(?P<parallel_index>\d+)\.(?P<extension>hdf5)$"
)


class _NumberedFileSet(TaggedFileSet):
    """TaggedFileSet for schemes without a redshift in the name (TNG)."""

    def __init__(self, directory, pattern, kind, skip_numbers=None, loader=None):
        self._directory = os.path.realpath(directory)
        self._kind = kind
        skip = set(skip_numbers or ())
        groups: dict[str, list[tuple[int, str]]] = {}
        for root, _, files in os.walk(self._directory):
            for filename in files:
                path = os.path.join(root, filename)
                m = pattern.match(path)
                if not m:
                    continue
                number = m.group("number")
                if number in skip:
                    continue
                # single-file schemes (e.g. SWIFT) have no parallel index
                parallel = m.groupdict().get("parallel_index")
                groups.setdefault(number, []).append(
                    (int(parallel) if parallel is not None else 0, path)
                )
        leaves = []
        for number, entries in groups.items():
            entries.sort()
            leaves.append(
                FileSetLeaf(
                    number=number,
                    tag=number,  # no redshift encoded in the filename
                    filepaths=tuple(p for _, p in entries),
                    loader=loader,
                )
            )
        self._finish_init(leaves)

    def _finish_init(self, leaves: list[FileSetLeaf]) -> None:
        self._leaves = sorted(leaves, key=lambda leaf: leaf.number_numerical)
        self._by_number = {leaf.number: leaf for leaf in self._leaves}
        self._by_tag = {leaf.tag: leaf for leaf in self._leaves}
        self._redshift_cache: dict[str, float] = {}

    def _leaf_redshift(self, leaf: FileSetLeaf) -> float:
        if leaf.number not in self._redshift_cache:
            import h5py

            with h5py.File(leaf.filepath, "r") as f:
                self._redshift_cache[leaf.number] = float(
                    np.ravel(f["Header"].attrs["Redshift"])[0]
                )
        return self._redshift_cache[leaf.number]

    def find_file_number_from_redshift(self, redshift: float) -> str:
        numbers = np.array(self.get_numbers(), dtype=str)
        numbers = numbers[np.argsort([float(v) for v in numbers])]
        redshifts = np.array(
            [self._leaf_redshift(self.get_by_number(n)) for n in numbers], dtype=float
        )
        prior = redshifts >= redshift
        if prior.sum() == 0:
            raise FileNotFoundError(
                f"Unable to find search data for a file with a redshift of (or "
                f"exceeding) {redshift}.\nThe first file has a redshift of {redshifts[0]}."
            )
        selected = redshifts[prior][-1]
        if (redshift >= 1.0 and redshift - selected > 0.5) or (
            redshift < 1.0 and redshift - selected > 0.1
        ):
            print_verbose_warning(
                f"Attempted to find data at z={redshift} but only managed to "
                f"retrieve data for z=~{selected}."
            )
        return str(numbers[prior][-1])


def _load_tng_snapshot(leaf: FileSetLeaf):
    from .tng import SnapshotTNG

    return SnapshotTNG(leaf.filepath)


def _load_tng_catalogue(leaf: FileSetLeaf):
    from .tng import CatalogueTNG

    snapshot = leaf.snapshot_leaf.load()
    return CatalogueTNG(leaf.filepath, snapshot)


class FileTreeScraper_TNG(FileTreeScraperBase):
    """TNG simulation directory index (working replacement for the stale
    reference scraper, `io/TNG/_TNG.py`)."""

    def __init__(self, filepath: str, skip_snapshot_numbers=None) -> None:
        super().__init__({"root": filepath}, skip_snapshot_numbers, None)
        skips = list(self.skipped_snapshot_numbers)
        self._snapshots = _NumberedFileSet(
            filepath, _TNG_SNAPSHOT, "snapshot", skips, _load_tng_snapshot
        )
        self._catalogues = _NumberedFileSet(
            filepath, _TNG_GROUPCAT, "catalogue", skips, _load_tng_catalogue
        )
        for leaf in self._catalogues:
            try:
                leaf.snapshot_leaf = self._snapshots.get_by_number(leaf.number)
            except KeyError:
                leaf.snapshot_leaf = None

    @property
    def directory(self) -> str:
        return self.root_directories["root"]

    @property
    def snapshots(self) -> _NumberedFileSet:
        return self._snapshots

    @property
    def catalogues(self) -> _NumberedFileSet:
        return self._catalogues


# --- SWIFT discovery ----------------------------------------------------------

_SWIFT_SNAPSHOT = re.compile(
    r".*[\\/](?P<stem>[\w\-]+?)_(?P<number>\d{3,4})(?:\.(?P<parallel_index>\d+))?\.hdf5$"
)


def discover_swift_snapshots(directory: str) -> dict[str, list[str]]:
    """Find SWIFT snapshot files grouped by output number.

    Replacement for the reference's scrape/generate utilities
    (`io/SWIFT/_SnapshotSWIFT.py:114-283`), validating candidates by header
    shape rather than a full ``swiftsimio`` load.
    """
    import h5py

    found: dict[str, list[str]] = {}
    for root, _, files in os.walk(os.path.realpath(directory)):
        for filename in files:
            path = os.path.join(root, filename)
            m = _SWIFT_SNAPSHOT.match(path)
            if not m:
                continue
            try:
                with h5py.File(path, "r") as f:
                    if "Header" not in f or "Cosmology" not in f:
                        continue
            except OSError:
                continue
            found.setdefault(m.group("number"), []).append(path)
    for paths in found.values():
        paths.sort()
    return found


_SWIFT_CATALOGUE = re.compile(
    r".*[\\/](?P<stem>[\w\-]+?)_(?P<number>\d{3,4})(?:\.(?P<parallel_index>\d+))?\.hdf5$"
)


def discover_soap_catalogues(directory: str) -> dict[str, dict[str, list[str]]]:
    """Find SOAP catalogue files grouped by output number.

    The reference has no SOAP discovery (`CatalogueSOAP` paths are caller
    supplied, `io/SWIFT/_CatalogueSOAP.py:31-36`); this classifies candidate
    ``*_NNNN.hdf5`` files by content: files whose stem contains
    "membership" are membership files, files with a ``VR`` group are
    property catalogues. Returns ``{number: {"properties": [...],
    "membership": [...]}}`` with only numbers that have a properties file.
    """
    import h5py

    found: dict[str, dict[str, list[str]]] = {}
    for root, _, files in os.walk(os.path.realpath(directory)):
        for filename in files:
            path = os.path.join(root, filename)
            m = _SWIFT_CATALOGUE.match(path)
            if not m:
                continue
            number = m.group("number")
            entry = found.setdefault(number, {"properties": [], "membership": []})
            if "membership" in m.group("stem").lower():
                entry["membership"].append(path)
                continue
            try:
                with h5py.File(path, "r") as f:
                    if "VR" in f:
                        entry["properties"].append(path)
            except OSError:
                continue
    out = {}
    for number, entry in found.items():
        if entry["properties"]:
            entry["properties"].sort()
            entry["membership"].sort()
            out[number] = entry
    return out


def _load_swift_snapshot(leaf: FileSetLeaf):
    from .swift import SnapshotSWIFT

    return SnapshotSWIFT(leaf.filepath)


def _load_soap_catalogue(leaf: FileSetLeaf):
    from .swift import CatalogueSOAP

    if leaf.snapshot_leaf is None:
        raise FileNotFoundError(
            f"No SWIFT snapshot paired with catalogue number {leaf.number}."
        )
    snapshot = leaf.snapshot_leaf.load()
    return CatalogueSOAP(
        leaf.properties_filepath, leaf.membership_filepath, snapshot
    )


class _SwiftSnapshotFileSet(_NumberedFileSet):
    """SWIFT snapshot leaves, content-validated: SOAP catalogue/membership
    files match the same ``*_NNNN.hdf5`` naming, so candidates must prove a
    ``Header`` + ``Cosmology`` HDF5 shape (cf. the reference validating via
    ``sw.load``, `_SnapshotSWIFT.py:186-194`)."""

    def __init__(self, directory: str, skip_numbers=None) -> None:
        from .swift import SnapshotSWIFT

        self._directory = os.path.realpath(directory)
        self._kind = "snapshot"
        skip = set(skip_numbers or ())
        groups: dict[str, list[tuple[int, str]]] = {}
        for root, _, files in os.walk(self._directory):
            for filename in files:
                path = os.path.join(root, filename)
                m = _SWIFT_SNAPSHOT.match(path)
                if not m or m.group("number") in skip:
                    continue
                if not SnapshotSWIFT._is_swift_snapshot_file(path):
                    continue
                parallel = m.group("parallel_index")
                groups.setdefault(m.group("number"), []).append(
                    (int(parallel) if parallel is not None else 0, path)
                )
        leaves = []
        for number, entries in groups.items():
            entries.sort()
            leaves.append(
                FileSetLeaf(
                    number=number,
                    tag=number,
                    filepaths=tuple(p for _, p in entries),
                    loader=_load_swift_snapshot,
                )
            )
        self._finish_init(leaves)


class _SwiftCatalogueFileSet(_NumberedFileSet):
    """SOAP catalogue leaves; redshift comes from the paired snapshot."""

    def __init__(self, directory: str, skip_numbers=None) -> None:
        self._directory = os.path.realpath(directory)
        self._kind = "catalogue"
        skip = set(skip_numbers or ())
        leaves = []
        for number, entry in discover_soap_catalogues(self._directory).items():
            if number in skip:
                continue
            leaves.append(
                FileSetLeaf(
                    number=number,
                    tag=number,
                    filepaths=tuple(entry["membership"]),
                    secondary_filepaths=tuple(entry["properties"]),
                    loader=_load_soap_catalogue,
                )
            )
        self._finish_init(leaves)

    def _leaf_redshift(self, leaf: FileSetLeaf) -> float:
        if leaf.number not in self._redshift_cache:
            import h5py

            if leaf.snapshot_leaf is None:
                raise FileNotFoundError(
                    f"No SWIFT snapshot paired with catalogue number {leaf.number}."
                )
            with h5py.File(leaf.snapshot_leaf.filepath, "r") as f:
                self._redshift_cache[leaf.number] = float(
                    np.ravel(f["Header"].attrs["Redshift"])[0]
                )
        return self._redshift_cache[leaf.number]


class FileTreeScraper_SWIFT(FileTreeScraperBase):
    """SWIFT simulation directory index: snapshots + SOAP catalogues.

    Capability replacement for the reference's broken SWIFT tree
    (`io/SWIFT/_SWIFT.py:4-7` imports nonexistent modules); mirrors the
    EAGLE/TNG scraper surface so the CLI tools can dispatch on it.
    """

    def __init__(self, filepath: str, skip_snapshot_numbers=None) -> None:
        super().__init__({"root": filepath}, skip_snapshot_numbers, None)
        skips = list(self.skipped_snapshot_numbers)
        self._snapshots = _SwiftSnapshotFileSet(filepath, skips)
        self._catalogues = _SwiftCatalogueFileSet(filepath, skips)
        for leaf in self._catalogues:
            try:
                leaf.snapshot_leaf = self._snapshots.get_by_number(leaf.number)
            except KeyError:
                leaf.snapshot_leaf = None

    @property
    def directory(self) -> str:
        return self.root_directories["root"]

    @property
    def snapshots(self) -> _NumberedFileSet:
        return self._snapshots

    @property
    def catalogues(self) -> _SwiftCatalogueFileSet:
        return self._catalogues


class FileTreeScraper_EAGLE(FileTreeScraperBase):
    """EAGLE simulation directory index (`_EAGLE.py:398-474`)."""

    def __init__(
        self,
        filepath: str,
        skip_snapshot_numbers: Optional[Iterable[str]] = None,
        skip_snipshot_numbers: Optional[Iterable[str]] = None,
    ) -> None:
        super().__init__({"root": filepath}, skip_snapshot_numbers, skip_snipshot_numbers)
        skips_snap = list(self.skipped_snapshot_numbers)
        skips_snip = list(self.skipped_snipshot_numbers)
        self._snapshots = TaggedFileSet(
            filepath, _EAGLE_SNAPSHOT, "snapshot", skips_snap, _load_snapshot
        )
        self._snipshots = TaggedFileSet(
            filepath, _EAGLE_SNIPSHOT, "snipshot", skips_snip, _load_snapshot
        )
        self._snapshot_catalogues = _catalogue_file_set(
            filepath, _EAGLE_MEMBERSHIP, _EAGLE_PROPERTIES, self._snapshots,
            "snapshot catalogue", skips_snap,
        )
        self._snipshot_catalogues = _catalogue_file_set(
            filepath, _EAGLE_SNIP_MEMBERSHIP, _EAGLE_SNIP_PROPERTIES, self._snipshots,
            "snipshot catalogue", skips_snip,
        )

    @property
    def directory(self) -> str:
        return self.root_directories["root"]

    @property
    def snapshots(self) -> TaggedFileSet:
        return self._snapshots

    @property
    def snipshots(self) -> TaggedFileSet:
        return self._snipshots

    @property
    def catalogues(self) -> TaggedFileSet:
        return self._snapshot_catalogues

    @property
    def snipshot_catalogues(self) -> TaggedFileSet:
        return self._snipshot_catalogues

    # -- path relocation helpers (`_EAGLE.py:426-474`) --------------------------
    @staticmethod
    def split_filepath(filepath: str) -> tuple[str, str]:
        absolute = os.path.abspath(filepath)
        folder, filename = os.path.split(absolute)
        root, folder = os.path.split(folder)
        return (root, os.path.join(folder, filename))

    @staticmethod
    def directory_from_filepath(filepath: str) -> str:
        return FileTreeScraper_EAGLE.split_filepath(filepath)[0]

    @staticmethod
    def relative_filepath(filepath: str) -> str:
        return FileTreeScraper_EAGLE.split_filepath(filepath)[1]

    @staticmethod
    def make_filepath_with_root(directory: str, relative_filepath: str) -> str:
        return os.path.join(directory, relative_filepath)

    def make_filepath(self, relative_filepath: str) -> str:
        return self.make_filepath_with_root(self.directory, relative_filepath)

    @staticmethod
    def get_alternative_filepath_with_root(directory: str, filepath: str) -> str:
        return FileTreeScraper_EAGLE.make_filepath_with_root(
            directory, FileTreeScraper_EAGLE.relative_filepath(filepath)
        )

    def get_alternative_filepath(self, filepath: str) -> str:
        return self.get_alternative_filepath_with_root(self.directory, filepath)
