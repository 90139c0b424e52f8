"""Port vs JAX: the SWIFT snapshot reader and the SOAP catalogue
(``io/swift.py``).

Mirrors ``tests/test_io_swift.py`` and ``TestSWIFTHeaderVariants`` of
``tests/test_schema_tolerance.py``. The module is copied, so on the same
files (the JAX package's fixture writers) every field, catalogue array and
region-restricted read must equal JAX's exactly (``np.array_equal``, units
included), and every refusal must raise the same error. The DM smoothing
lengths' engines are held to JAX's and to each other in
``test_torch_swift_dm_hsml.py``.
"""

import h5py
import numpy as np
import pytest

import astro_sph_tools_tpu.io.catalogue as jcat
from astro_sph_tools_tpu.data_structures import ParticleType as JParticleType
from astro_sph_tools_tpu.io.swift import CatalogueSOAP as JCatalogueSOAP
from astro_sph_tools_tpu.io.swift import SnapshotSWIFT as JSnapshotSWIFT
from astro_sph_tools_tpu.io.synthetic import SyntheticSnapshotSpec, write_soap_catalogue, write_swift_snapshot
from astro_sph_tools_tpu_torch import io
from astro_sph_tools_tpu_torch.data_structures import ParticleType
from astro_sph_tools_tpu_torch.io.catalogue import BasicHaloDefinitions
from astro_sph_tools_tpu_torch.io.errors import SnapshotFormatError
from astro_sph_tools_tpu_torch.io.swift import CatalogueSOAP, SnapshotSWIFT

TYPES = ["gas", "dark_matter", "star", "black_hole"]


def same(t, j):
    if hasattr(j, "units"):
        assert t.units.symbol == j.units.symbol
        t, j = t.value, j.value
    assert np.array_equal(np.asarray(t), np.asarray(j))


def both(port, ref, method, *args, **kw):
    """Call ``method`` on the port and JAX objects with the same arguments
    (particle-type and halo-definition names translated to each package's
    enums) and require equal results, or errors of the same class."""
    def conv(a, pkg_pt, pkg_def):
        if isinstance(a, tuple) and a[0] == "pt":
            return pkg_pt[a[1]]
        if isinstance(a, tuple) and a[0] == "def":
            return pkg_def[a[1]].value
        return a

    targs = [conv(a, ParticleType, BasicHaloDefinitions) for a in args]
    jargs = [conv(a, JParticleType, jcat.BasicHaloDefinitions) for a in args]
    try:
        expected = getattr(ref, method)(*jargs, **kw)
    except Exception as err:
        with pytest.raises(Exception) as info:
            getattr(port, method)(*targs, **kw)
        assert type(info.value).__name__ == type(err).__name__
        return None
    got = getattr(port, method)(*targs, **kw)
    same(got, expected)
    return got


@pytest.fixture(scope="module")
def swift(tmp_path_factory):
    spec = SyntheticSnapshotSpec(n_gas=1024, n_dm=1500, n_star=128, n_bh=4)
    root = tmp_path_factory.mktemp("torch_swift_sim")
    path, truth = write_swift_snapshot(str(root), spec)
    cat_path, memb_path, cat_truth = write_soap_catalogue(str(root), spec, truth)
    return path, truth, spec, cat_path, memb_path, cat_truth


SNAPSHOT_CALLS = [
    ("number_of_particles", True, {}), ("get_IDs", True, {}), ("get_positions", True, {}),
    ("get_positions", True, {"use_proper_units": True}), ("get_velocities", True, {}),
    ("get_masses", True, {}), ("get_smoothing_lengths", True, {}), ("get_total_mass", True, {}),
    ("get_metallicities", True, {}), ("get_metallicities", True, {"solar_units": True, "solar_metallicity": 0.0134}),
    ("get_densities", True, {}), ("get_temperatures", True, {}), ("get_volumes", True, {}),
    ("get_mean_enrichment_redshift", True, {}), ("get_sfr", False, {}),
    ("get_black_hole_subgrid_masses", False, {}), ("get_black_hole_dynamical_masses", False, {}),
]


@pytest.mark.parametrize("method,typed,kw", SNAPSHOT_CALLS, ids=lambda v: str(v) if isinstance(v, str) else "")
def test_snapshot_fields_match_jax(swift, method, typed, kw):
    path, *_ = swift
    port, ref = SnapshotSWIFT(path), JSnapshotSWIFT(path)
    results = [both(port, ref, method, *([("pt", pt)] if typed else []), **kw) for pt in (TYPES if typed else [None])]
    assert any(r is not None for r in results)


def test_metadata_and_abundances(swift):
    path, truth, spec, *_ = swift
    port, ref = SnapshotSWIFT(path), JSnapshotSWIFT(path)
    for attr in ("redshift", "h", "a", "omega_baryon", "number"):
        assert getattr(port, attr) == getattr(ref, attr)
    same(port.box_size, ref.box_size)
    for element in ("H", "He", "C", "O", "Fe"):
        both(port, ref, "get_elemental_abundance", ("pt", "gas"), element)
    both(port, ref, "get_number_densities", ("pt", "gas"), "H")


def test_dm_smoothing_lengths_from_the_kdtree(swift):
    """DM h = the 32nd-neighbour distance (periodic), from scipy's KDTree
    below the device crossover, equal to JAX's (whose "auto" takes the same
    branch below 3e5)."""
    from scipy.spatial import KDTree

    path, truth, spec, *_ = swift
    port = SnapshotSWIFT(path)
    assert port._dm_hsml_pick_engine(spec.n_dm) == "kdtree"
    hs = port.get_smoothing_lengths(ParticleType.dark_matter)
    same(hs, JSnapshotSWIFT(path).get_smoothing_lengths(JParticleType.dark_matter))
    pos = truth.positions[JParticleType.dark_matter]
    box = spec.box_size_mpc
    d, _ = KDTree(np.mod(pos, box), boxsize=box).query(np.mod(pos, box), k=32)
    np.testing.assert_allclose(hs.value, d[:, -1], rtol=1e-8)


def test_dm_grid_engine_raises(tmp_path):
    """The grid engine refuses fewer DM particles than neighbours, as JAX's
    does (the KDTree would pad with inf); it does not fall back to the
    KDTree."""
    path, _ = write_swift_snapshot(str(tmp_path), SyntheticSnapshotSpec(n_gas=64, n_dm=16, n_star=8, n_bh=2))
    port, ref = SnapshotSWIFT(path), JSnapshotSWIFT(path)
    port.dm_hsml_engine = ref.dm_hsml_engine = "grid"
    port.dm_hsml_device = "cpu"
    with pytest.raises(ValueError, match="exceeds"):
        port.get_smoothing_lengths(ParticleType.dark_matter)
    both(port, ref, "get_smoothing_lengths", ("pt", "dark_matter"))


def test_soap_catalogue_matches_jax(swift):
    path, truth, spec, cat_path, memb_path, cat_truth = swift
    snap, jsnap = SnapshotSWIFT(path), JSnapshotSWIFT(path)
    port, ref = CatalogueSOAP(cat_path, memb_path, snap), JCatalogueSOAP(cat_path, memb_path, jsnap)
    assert len(port) == len(ref) == spec.n_groups
    for method in ("get_halo_IDs", "get_halo_indexes", "get_halo_parent_IDs", "get_halo_parent_indexes",
                   "get_halo_top_level_parent_IDs", "get_halo_top_level_parent_indexes",
                   "get_halo_centres_of_potential", "get_halo_centres_of_mass"):
        both(port, ref, method)
    same(port.number_of_children, ref.number_of_children)
    same(port.number_of_descendants, ref.number_of_descendants)
    for d in BasicHaloDefinitions:
        both(port, ref, "get_halo_masses", ("def", d.name))
        both(port, ref, "get_halo_radii", ("def", d.name))
    for pt in TYPES:
        both(port, ref, "get_number_of_haloes", ("pt", pt))
        both(port, ref, "get_halo_indexes_by_snapshot_particle", ("pt", pt))
        both(port, ref, "get_halo_indexes_by_snapshot_particle", ("pt", pt), bound_only=True)
        both(port, ref, "get_halo_IDs_by_snapshot_particle", ("pt", pt))
        both(port, ref, "get_particle_IDs", ("pt", pt))
    np.testing.assert_array_equal(port.get_halo_IDs(), cat_truth["halo_ids"])


@pytest.fixture()
def cells_path(tmp_path):
    spec = SyntheticSnapshotSpec(n_gas=4096, n_dm=512, n_star=64, n_bh=2, swift_cells_dim=4)
    path, truth = write_swift_snapshot(str(tmp_path), spec)
    return path, truth, spec


@pytest.mark.parametrize("region", [(1.0, 4.0, 2.0, 6.0, 0.0, 10.0), (0.1, 2.4, 0.1, 2.4, 0.1, 2.4),
                                    (9.0, 11.0, 0.0, 10.0, 0.0, 10.0)], ids=["slab", "one_cell", "wrapped"])
def test_cells_region_reads_match_jax(cells_path, region):
    path, truth, spec = cells_path
    port, ref = SnapshotSWIFT(path), JSnapshotSWIFT(path)
    port.restrict_data_comoving_loading_region(*region)
    ref.restrict_data_comoving_loading_region(*region)
    for pt in ("gas", "star"):
        for method in ("get_positions", "get_IDs", "get_masses", "number_of_particles_this_rank"):
            both(port, ref, method, ("pt", pt))
    p = truth.positions[JParticleType.gas]
    lo, hi = region[0], region[1]
    sel = ((p[:, 0] >= lo) & (p[:, 0] < hi)) | ((p[:, 0] >= lo - 10.0) & (p[:, 0] < hi - 10.0))
    sel &= (p[:, 1] >= region[2]) & (p[:, 1] < region[3]) & (p[:, 2] >= region[4]) & (p[:, 2] < region[5])
    assert port.number_of_particles_this_rank(ParticleType.gas) == sel.sum() > 0
    port.clear_region_restriction()
    assert port.number_of_particles_this_rank(ParticleType.gas) == spec.n_gas


def _mutated(tmp_path, mutate, **kw):
    spec = SyntheticSnapshotSpec(n_gas=256, n_dm=64, n_star=16, n_bh=2, **kw)
    path, truth = write_swift_snapshot(str(tmp_path), spec)
    with h5py.File(path, "r+") as f:
        mutate(f)
    return path, truth


def _drop_scale_factor(f):
    del f["Header"].attrs["Scale-factor"]


def _scalar_boxsize(f):
    f["Header"].attrs["BoxSize"] = float(np.atleast_1d(f["Header"].attrs["BoxSize"])[0])


def _scalar_attrs(f):
    f["Cosmology"].attrs["h"] = float(np.atleast_1d(f["Cosmology"].attrs["h"])[0])
    f["Header"].attrs["Redshift"] = float(np.atleast_1d(f["Header"].attrs["Redshift"])[0])


def _drop_gas_cell_counts(f):
    del f["Cells/Counts/PartType0"]


@pytest.mark.parametrize("mutate,kw", [(_drop_scale_factor, {}), (_scalar_boxsize, {}), (_scalar_attrs, {}),
                                       (_drop_gas_cell_counts, {"swift_cells_dim": 4})],
                         ids=["no_scale_factor", "scalar_boxsize", "scalar_attrs", "cells_without_counts"])
def test_header_variants_match_jax(tmp_path, mutate, kw):
    path, truth = _mutated(tmp_path, mutate, **kw)
    port, ref = SnapshotSWIFT(path), JSnapshotSWIFT(path)
    assert port.a == ref.a and port.redshift == ref.redshift
    same(port.box_size, ref.box_size)
    port.restrict_data_comoving_loading_region(2.0, 8.0, 0.0, 10.0, 0.0, 10.0)
    ref.restrict_data_comoving_loading_region(2.0, 8.0, 0.0, 10.0, 0.0, 10.0)
    both(port, ref, "get_positions", ("pt", "gas"))
    p = truth.positions[JParticleType.gas]
    assert port.number_of_particles_this_rank(ParticleType.gas) == ((p[:, 0] >= 2.0) & (p[:, 0] < 8.0)).sum()


def test_no_coordinates_is_format_error(tmp_path):
    def drop(f):
        for pt in list(f):
            if pt.startswith("PartType") and "Coordinates" in f[pt]:
                del f[pt]["Coordinates"]

    path, _ = _mutated(tmp_path, drop)
    with pytest.raises(SnapshotFormatError, match="coordinates"):
        SnapshotSWIFT(path)


def test_exported():
    assert io.SnapshotSWIFT is SnapshotSWIFT and io.CatalogueSOAP is CatalogueSOAP
