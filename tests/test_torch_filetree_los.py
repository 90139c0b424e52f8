"""Port vs JAX: dataset discovery (``io/filetree.py``), line-of-sight files
(``io/los.py``), particle-filter sidecars (``io/particle_filter.py``) and
the interface markers (``data_structures/interface.py``).

Mirrors ``tests/test_swift_filetree.py``, ``tests/test_filetree_tng_swift.py``,
``tests/test_los_filetree.py`` and ``tests/test_particle_filter.py``. The
modules are copied, so on the same directory trees and files (the JAX
package's fixture writers) the port must find the same outputs, numbers,
tags, paths and redshifts, read the same arrays exactly, and load leaves
into its own reader classes. A sidecar written by either package reads back
the same through the other.
"""

import os

import numpy as np
import pytest

import astro_sph_tools_tpu.io.filetree as jft
import astro_sph_tools_tpu.io.los as jlos
import astro_sph_tools_tpu.io.particle_filter as jpf
from astro_sph_tools_tpu.data_structures import ParticleType as JParticleType
from astro_sph_tools_tpu.io.synthetic import (
    SyntheticSnapshotSpec,
    write_catalogue,
    write_los_file,
    write_snapshot,
    write_soap_catalogue,
    write_swift_snapshot,
    write_tng_snapshot,
)
from astro_sph_tools_tpu.io.swift import SnapshotSWIFT as JSnapshotSWIFT
from astro_sph_tools_tpu_torch import io
from astro_sph_tools_tpu_torch.data_structures import ParticleType
from astro_sph_tools_tpu_torch.data_structures import interface
from astro_sph_tools_tpu_torch.io import filetree, los, particle_filter
from astro_sph_tools_tpu_torch.io.eagle import SnapshotEAGLE
from astro_sph_tools_tpu_torch.io.subfind import CatalogueSUBFIND
from astro_sph_tools_tpu_torch.io.swift import CatalogueSOAP, SnapshotSWIFT
from astro_sph_tools_tpu_torch.io.tng import CatalogueTNG, SnapshotTNG


def same(t, j):
    if hasattr(j, "units"):
        assert t.units.symbol == j.units.symbol
        t, j = t.value, j.value
    assert np.array_equal(np.asarray(t), np.asarray(j))


def same_set(port, ref):
    """Two TaggedFileSets list the same leaves."""
    assert port.get_numbers() == ref.get_numbers()
    assert port.get_tags() == ref.get_tags()
    for a, b in zip(port, ref):
        assert a.number == b.number and a.tag == b.tag
        assert list(a.filepaths) == list(b.filepaths)


@pytest.fixture(scope="module")
def eagle_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_eagle_tree")
    specs = [SyntheticSnapshotSpec(n_gas=256, n_dm=128, n_star=32, n_bh=2, n_files=2, snapshot_number=num,
                                   redshift=z) for num, z in [(10, 1.0), (11, 0.5), (12, 0.1)]]
    for spec in specs:
        _, truth = write_snapshot(str(root), spec)
        write_catalogue(str(root), spec, truth)
    los_path, los_truth = write_los_file(str(root), specs[1])
    return str(root), los_path, los_truth


@pytest.fixture(scope="module")
def swift_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_swift_tree")
    for num, z, seed in [(10, 1.0, 3), (12, 0.25, 4)]:
        spec = SyntheticSnapshotSpec(n_gas=512, n_dm=256, n_star=32, n_bh=2, n_groups=5, snapshot_number=num,
                                     redshift=z, seed=seed)
        _, particles = write_swift_snapshot(str(root), spec)
        write_soap_catalogue(str(root), spec, particles)
    return str(root)


@pytest.fixture(scope="module")
def tng_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_tng_tree")
    for num, z in [(50, 1.0), (99, 0.0)]:
        write_tng_snapshot(str(root), SyntheticSnapshotSpec(n_gas=256, n_dm=128, n_star=32, n_bh=2, n_files=2,
                                                           snapshot_number=num, redshift=z, n_groups=4))
    return str(root)


class TestEAGLETree:
    @pytest.mark.parametrize("skip", [None, ["011"]])
    def test_discovery_matches_jax(self, eagle_dir, skip):
        root, *_ = eagle_dir
        kw = {} if skip is None else {"skip_snapshot_numbers": skip}
        port, ref = filetree.FileTreeScraper_EAGLE(root, **kw), jft.FileTreeScraper_EAGLE(root, **kw)
        same_set(port.snapshots, ref.snapshots)
        same_set(port.catalogues, ref.catalogues)
        for a, b in zip(port.catalogues, ref.catalogues):
            assert a.membership_filepath == b.membership_filepath
            assert a.properties_filepath == b.properties_filepath
        for z in (0.3, 0.05, 0.5):
            assert port.snapshots.find_file_number_from_redshift(z) == ref.snapshots.find_file_number_from_redshift(z)
        with pytest.raises(FileNotFoundError):
            port.snapshots.find_file_number_from_redshift(5.0)
        with pytest.raises(KeyError):
            port.snapshots.get_by_number("099")

    def test_leaves_load_port_readers(self, eagle_dir):
        root, *_ = eagle_dir
        tree = filetree.FileTreeScraper_EAGLE(root)
        snap = tree.snapshots.get_by_number("010").load()
        assert isinstance(snap, SnapshotEAGLE) and snap.redshift == pytest.approx(1.0)
        cat = tree.catalogues.get_by_number("011").load()
        assert isinstance(cat, CatalogueSUBFIND) and cat.snapshot.redshift == pytest.approx(0.5)
        assert len(cat) == len(jft.FileTreeScraper_EAGLE(root).catalogues.get_by_number("011").load())

    def test_path_helpers(self):
        path = "/data/sim/snapshot_012_z000p100/snap_012_z000p100.0.hdf5"
        assert filetree.FileTreeScraper_EAGLE.split_filepath(path) == jft.FileTreeScraper_EAGLE.split_filepath(path)
        rel = "snapshot_012_z000p100/snap_012_z000p100.0.hdf5"
        assert filetree.FileTreeScraper_EAGLE.make_filepath_with_root("/new", rel) == "/new/" + rel
        for tag in ("012_z000p503", "005_z003p125"):
            assert filetree.tag_redshift(tag) == jft.tag_redshift(tag)


class TestSWIFTTree:
    def test_discovery_matches_jax(self, swift_dir):
        assert filetree.discover_swift_snapshots(swift_dir) == jft.discover_swift_snapshots(swift_dir)
        assert filetree.discover_soap_catalogues(swift_dir) == jft.discover_soap_catalogues(swift_dir)
        port, ref = filetree.FileTreeScraper_SWIFT(swift_dir), jft.FileTreeScraper_SWIFT(swift_dir)
        same_set(port.snapshots, ref.snapshots)
        same_set(port.catalogues, ref.catalogues)
        for z in (0.25, 0.9):
            assert port.snapshots.find_file_number_from_redshift(z) == ref.snapshots.find_file_number_from_redshift(z)
        assert port.catalogues.find_file_number_from_redshift(0.2) == "0012"
        skipped = filetree.FileTreeScraper_SWIFT(swift_dir, skip_snapshot_numbers=["0010"])
        assert skipped.snapshots.get_numbers() == ("0012",)

    def test_catalogue_leaf_loads_port_readers(self, swift_dir):
        cat = filetree.FileTreeScraper_SWIFT(swift_dir).catalogues.get_by_number("0012").load()
        assert isinstance(cat, CatalogueSOAP) and isinstance(cat.snapshot, SnapshotSWIFT)
        assert cat.snapshot.redshift == pytest.approx(0.25) and cat.get_number_of_haloes() == 5

    def test_filepath_utilities_match_jax(self, swift_dir, tmp_path):
        assert SnapshotSWIFT.scrape_filepaths(swift_dir) == JSnapshotSWIFT.scrape_filepaths(swift_dir)
        assert (SnapshotSWIFT.generate_filepaths_from_partial_info(swift_dir)
                == JSnapshotSWIFT.generate_filepaths_from_partial_info(swift_dir))
        kw = dict(directory=str(tmp_path), basename="snap_", parallel_ranks=[0, 1])
        assert SnapshotSWIFT.generate_filepaths("0010", **kw) == JSnapshotSWIFT.generate_filepaths("0010", **kw)
        assert SnapshotSWIFT.get_snapshot_order(["0012", "0002", "0010"]) == ["0002", "0010", "0012"]
        with pytest.raises(FileNotFoundError):
            SnapshotSWIFT.generate_filepaths_from_partial_info(swift_dir, basename="nonexistent_")
        (tmp_path / "snap_0001.hdf5").write_bytes(b"x")
        (tmp_path / "snap_0002.h5").write_bytes(b"x")
        with pytest.raises(IOError):
            SnapshotSWIFT.scrape_filepaths(str(tmp_path))

    def test_decoy_file_ignored(self, tmp_path):
        write_swift_snapshot(str(tmp_path), SyntheticSnapshotSpec(n_gas=64, n_dm=32, n_star=8, n_bh=2,
                                                                  snapshot_number=7))
        (tmp_path / "random_0001.hdf5").write_bytes(b"not hdf5")
        found = filetree.discover_swift_snapshots(str(tmp_path))
        assert found == jft.discover_swift_snapshots(str(tmp_path)) and set(found) == {"0007"}


class TestTNGTree:
    def test_discovery_matches_jax(self, tng_dir):
        port, ref = filetree.FileTreeScraper_TNG(tng_dir), jft.FileTreeScraper_TNG(tng_dir)
        same_set(port.snapshots, ref.snapshots)
        same_set(port.catalogues, ref.catalogues)
        for z in (0.4, 0.0):
            assert port.snapshots.find_file_number_from_redshift(z) == ref.snapshots.find_file_number_from_redshift(z)
        assert filetree.FileTreeScraper_TNG(tng_dir, skip_snapshot_numbers=["050"]).snapshots.get_numbers() == ("099",)

    def test_leaves_load_port_readers(self, tng_dir):
        tree = filetree.FileTreeScraper_TNG(tng_dir)
        snap = tree.snapshots.get_by_number("099").load()
        assert isinstance(snap, SnapshotTNG) and snap.number_of_particles(ParticleType.gas) == 256
        cat = tree.catalogues.get_by_number("099").load()
        assert isinstance(cat, CatalogueTNG) and len(cat) == 4


class TestLineOfSight:
    def test_file_and_sightlines_match_jax(self, eagle_dir):
        _, los_path, truth = eagle_dir
        port, ref = los.LineOfSightFileEAGLE(los_path), jlos.LineOfSightFileEAGLE(los_path)
        assert port.number_of_sightlines == ref.number_of_sightlines == len(port) == 4
        assert port.redshift == ref.redshift and port.expansion_factor == ref.expansion_factor
        for i in range(len(port)):
            same(port.get_sightline_start_position(i), ref.get_sightline_start_position(i))
            same(port.get_sightline_direction_vector(i), ref.get_sightline_direction_vector(i))
            sl, jsl = port.get_sightline(i), ref.get_sightline(i)
            assert sl.number_of_particles == jsl.number_of_particles
            for field in ("positions_comoving", "positions_proper", "velocities_comoving", "velocities_proper",
                          "masses", "temperatures", "densities_comoving", "densities_proper",
                          "smoothing_lengths_comoving", "smoothing_lengths_proper", "metallicities"):
                same(getattr(sl, field), getattr(jsl, field))
        np.testing.assert_allclose(port.get_sightline(0).masses.value, truth["sightlines"][0]["masses"], rtol=1e-6)

    def test_cache_and_file_order(self, eagle_dir, tmp_path):
        _, los_path, _ = eagle_dir
        sl = los.LineOfSightFileEAGLE(los_path).get_sightline(0, cache_data=True)
        first = sl.masses
        assert sl.masses is first
        sl.cache_data = False
        assert sl.masses is not first
        for z in ["3.000", "0.500", "1.250"]:
            (tmp_path / f"part_los_z{z}.hdf5").touch()
        assert los.LineOfSightFileEAGLE.get_files(str(tmp_path)) == jlos.LineOfSightFileEAGLE.get_files(str(tmp_path))


def _write_filters(module, pt_enum, path, rng):
    pf = module.ParticleFilterFile(filepath=str(path), description="haloes above 1e12",
                                   source_file="contra_output.hdf5", simulation_type="EAGLE",
                                   snapshots_directory="/data/sim")
    mask = rng.random(100) > 0.5
    pf.add_snapshot_filter(module.SnapshotParticleFilter(
        particle_type=pt_enum.gas, redshift=0.5, snapshot_number="012",
        filepath="/data/sim/snapshot_012_z000p503/snap_012_z000p503.0.hdf5",
        allowed_ids=np.nonzero(mask)[0].astype(np.int64) + 1000, mask=mask))
    los_mask = rng.random(50) > 0.3
    pf.add_line_of_sight_filter(module.LineOfSightParticleFilter(
        particle_type=pt_enum.gas, redshift=0.5, file_name="part_los_z0.500.hdf5", line_of_sight_index=3,
        filepath="/data/sim/los/part_los_z0.500.hdf5", allowed_ids=np.nonzero(los_mask)[0].astype(np.int64),
        mask=los_mask))
    pf.save()
    return mask, los_mask


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_particle_filter_round_trip_across_packages(tmp_path, rng, writer):
    path = tmp_path / "filters.hdf5"
    w_mod, w_pt = (particle_filter, ParticleType) if writer == "port" else (jpf, JParticleType)
    mask, los_mask = _write_filters(w_mod, w_pt, path, rng)
    for module, pt in ((particle_filter, ParticleType), (jpf, JParticleType)):
        loaded = module.ParticleFilterFile(filepath=str(path))
        assert (loaded.description, loaded.simulation_type, loaded.snapshots_directory) == (
            "haloes above 1e12", "EAGLE", "/data/sim")
        assert not loaded.writable
        snap_f = loaded.get_snapshot_filter("snap_012_z000p503.0.hdf5", pt.gas)
        np.testing.assert_array_equal(snap_f.mask, mask)
        np.testing.assert_array_equal(snap_f.allowed_ids, np.nonzero(mask)[0] + 1000)
        los_f = loaded.get_line_of_sight_filter("part_los_z0.500.hdf5", 3, pt.gas)
        np.testing.assert_array_equal(los_f.mask, los_mask)
        assert los_f.line_of_sight_index == 3 and los_f.redshift == 0.5


def test_particle_filter_protection_and_append(tmp_path, rng):
    from astro_sph_tools_tpu_torch.__about__ import __version__

    path = tmp_path / "filters.hdf5"
    _write_filters(particle_filter, ParticleType, path, rng)
    loaded = particle_filter.ParticleFilterFile(filepath=str(path))
    assert loaded.version == __version__
    extra = particle_filter.SnapshotParticleFilter(
        ParticleType.star, 0.5, "012", "/data/sim/snapshot_012_z000p503/snap_012_z000p503.0.hdf5",
        np.arange(5, dtype=np.int64), np.ones(5, bool))
    with pytest.raises(PermissionError):
        loaded.add_snapshot_filter(extra)
    appender = particle_filter.ParticleFilterFile(filepath=str(path), allow_parallel_write=True)
    appender.add_snapshot_filter(extra)
    appender.save()
    again = jpf.ParticleFilterFile(filepath=str(path))
    assert {pt.name for pt in again.snapshot_filters["snap_012_z000p503.0.hdf5"]} == {"gas", "star"}


def test_interface_markers():
    class Thing(interface.Interface):
        def __init__(self):
            interface.ensure_not_interface(Thing, Thing)

    with pytest.raises(Exception):
        Thing()
    assert issubclass(interface.SimType_EAGLE, interface.ISimulation)
    assert {n for n in dir(interface) if n.startswith("SimType")} == {"SimType_EAGLE", "SimType_SWIFT", "SimType_TNG"}


def test_exported():
    for name in ("FileTreeScraper_EAGLE", "FileTreeScraper_SWIFT", "LineOfSightFileEAGLE", "ParticleFilterFile",
                 "discover_soap_catalogues", "TaggedFileSet"):
        assert getattr(io, name) is not None
    assert os.path.basename(io.filetree.__file__) == "filetree.py"
