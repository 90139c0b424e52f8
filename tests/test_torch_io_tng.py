"""Port vs JAX: the IllustrisTNG snapshot reader and group catalogue
(``io/tng.py``).

Mirrors ``tests/test_io_tng.py`` and ``TestTNGHeaderVariants`` of
``tests/test_schema_tolerance.py``. The module is copied, so on the same
files (the JAX package's fixture writer) every field, catalogue array and
halo-cutout read must equal JAX's exactly (``np.array_equal``, units
included), and every refusal must raise the same error. One fault is not
copied: without ``ElectronAbundance`` the port's temperatures raise
``SnapshotFormatError`` naming the dataset, where the JAX reader assumes
x_e = 0 (moving T by up to ~2x).
"""

import glob
import os

import h5py
import numpy as np
import pytest

import astro_sph_tools_tpu.io.catalogue as jcat
from astro_sph_tools_tpu.data_structures import ParticleType as JParticleType
from astro_sph_tools_tpu.io.synthetic import SyntheticSnapshotSpec, write_tng_snapshot
from astro_sph_tools_tpu.io.tng import CatalogueTNG as JCatalogueTNG
from astro_sph_tools_tpu.io.tng import SnapshotTNG as JSnapshotTNG
from astro_sph_tools_tpu_torch import io
from astro_sph_tools_tpu_torch.data_structures import ParticleType
from astro_sph_tools_tpu_torch.io.catalogue import BasicHaloDefinitions
from astro_sph_tools_tpu_torch.io.errors import SnapshotFormatError
from astro_sph_tools_tpu_torch.io.tng import CatalogueTNG, SnapshotTNG

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
def tng(tmp_path_factory):
    spec = SyntheticSnapshotSpec(n_gas=1024, n_dm=1024, n_star=128, n_bh=4, n_files=3, n_groups=6)
    root = tmp_path_factory.mktemp("torch_tng_sim")
    snap_path, cat_path, truth, extra = write_tng_snapshot(str(root), spec)
    return snap_path, cat_path, truth, extra, spec


SNAPSHOT_CALLS = [
    ("number_of_particles", True, {}), ("get_IDs", True, {}), ("get_positions", True, {}),
    ("get_positions", True, {"use_proper_units": True}), ("get_velocities", True, {}),
    ("get_masses", True, {}), ("get_smoothing_lengths", True, {}), ("get_total_mass", True, {}),
    ("get_metallicities", True, {}), ("get_metallicities", True, {"solar_units": True}),
    ("get_densities", True, {}), ("get_temperatures", True, {}), ("get_volumes", True, {}),
    ("get_sfr", False, {}), ("get_black_hole_subgrid_masses", False, {}),
    ("get_black_hole_dynamical_masses", False, {}),
]


@pytest.mark.parametrize("method,typed,kw", SNAPSHOT_CALLS, ids=lambda v: str(v) if isinstance(v, str) else "")
def test_snapshot_fields_match_jax(tng, method, typed, kw):
    path, *_ = tng
    port, ref = SnapshotTNG(path), JSnapshotTNG(path)
    results = [both(port, ref, method, *([("pt", pt)] if typed else []), **kw) for pt in (TYPES if typed else [None])]
    assert any(r is not None for r in results)


def test_metadata_and_abundances(tng):
    path, *_ = tng
    port, ref = SnapshotTNG(path), JSnapshotTNG(path)
    for attr in ("redshift", "h", "a", "omega_baryon", "number"):
        assert getattr(port, attr) == getattr(ref, attr)
    same(port.box_size, ref.box_size)
    for pt in ("gas", "star"):
        for element in ("H", "He", "C", "O", "Fe"):
            both(port, ref, "get_elemental_abundance", ("pt", pt), element)
    with pytest.raises(ValueError):
        port.get_elemental_abundance(ParticleType.gas, "Ca")


def test_bad_path(tmp_path):
    with pytest.raises(SnapshotFormatError):
        SnapshotTNG(str(tmp_path / "not_a_tng_file.hdf5"))


def test_catalogue_matches_jax(tng):
    path, cat_path, truth, extra, spec = tng
    snap, jsnap = SnapshotTNG(path), JSnapshotTNG(path)
    port, ref = CatalogueTNG(cat_path, snap), JCatalogueTNG(cat_path, jsnap)
    assert len(port) == len(ref) == spec.n_groups
    for method in ("get_halo_IDs", "get_halo_indexes", "get_halo_parent_IDs", "get_halo_parent_indexes",
                   "get_halo_top_level_parent_IDs", "get_halo_top_level_parent_indexes",
                   "get_halo_centres_of_potential", "get_halo_centres_of_mass"):
        both(port, ref, method)
    for d in BasicHaloDefinitions:
        both(port, ref, "get_halo_masses", ("def", d.name))
        both(port, ref, "get_halo_radii", ("def", d.name))
    for pt in TYPES:
        both(port, ref, "get_number_of_haloes", ("pt", pt))
        both(port, ref, "get_halo_indexes_by_snapshot_particle", ("pt", pt))
        both(port, ref, "get_halo_IDs_by_snapshot_particle", ("pt", pt))
        both(port, ref, "get_particle_IDs", ("pt", pt))
    np.testing.assert_allclose(port.get_halo_masses(BasicHaloDefinitions.FOF_GROUP.value).value,
                               extra["masses"], rtol=1e-10)


@pytest.mark.parametrize("halo", [0, "largest"])
def test_halo_cutout_matches_jax(tng, halo):
    """O(halo) reads through GroupLenType offsets, and membership under the
    cutout, as the JAX reader gives them."""
    path, cat_path, truth, extra, spec = tng
    snap, jsnap = SnapshotTNG(path), JSnapshotTNG(path)
    port, ref = CatalogueTNG(cat_path, snap), JCatalogueTNG(cat_path, jsnap)
    gn = truth.group_numbers[JParticleType.gas]
    member = (gn > 0) & (gn < 2**30)
    target = int(np.bincount(gn[member] - 1, minlength=spec.n_groups).argmax()) if halo == "largest" else 0
    port.restrict_snapshot_to_halo(target)
    ref.restrict_snapshot_to_halo(target)
    for pt in ("gas", "dark_matter", "star"):
        for method in ("get_IDs", "get_positions", "get_masses", "number_of_particles_this_rank"):
            both(snap, jsnap, method, ("pt", pt))
        both(port, ref, "get_halo_indexes_by_snapshot_particle", ("pt", pt))
        both(port, ref, "get_particle_IDs", ("pt", pt))
    labels = port.get_halo_indexes_by_snapshot_particle(ParticleType.gas)
    assert len(labels) > 0 and (labels == target).all()
    snap.clear_row_restriction()
    assert snap.number_of_particles_this_rank(ParticleType.gas) == spec.n_gas
    with pytest.raises(IndexError):
        port.restrict_snapshot_to_halo(10**9)


def _tng_files(first_path):
    return sorted(glob.glob(os.path.join(os.path.dirname(first_path), "snap_*.hdf5")))


def _mutated(tmp_path, mutate):
    spec = SyntheticSnapshotSpec(n_gas=256, n_dm=64, n_star=16, n_bh=2)
    path, *_ = write_tng_snapshot(str(tmp_path), spec)
    for p in _tng_files(path):
        with h5py.File(p, "r+") as f:
            mutate(f, p == path)
    return path


def test_missing_electron_abundance_raises(tmp_path):
    """The x_e fault not copied: the JAX reader returns T for x_e = 0; the
    port names the missing dataset."""
    def drop(f, first):
        if "PartType0/ElectronAbundance" in f:
            del f["PartType0/ElectronAbundance"]

    path = _mutated(tmp_path, drop)
    with pytest.raises(SnapshotFormatError, match="ElectronAbundance"):
        SnapshotTNG(path).get_temperatures(ParticleType.gas)
    jax_t = JSnapshotTNG(path).get_temperatures(JParticleType.gas).to_value("K")
    assert np.isfinite(jax_t).all() and (jax_t > 0).all()
    # the rest of the gas fields still read as JAX reads them
    both(SnapshotTNG(path), JSnapshotTNG(path), "get_densities", ("pt", "gas"))


def test_missing_gfm_metallicity_is_format_error(tmp_path):
    def drop(f, first):
        if "PartType0/GFM_Metallicity" in f:
            del f["PartType0/GFM_Metallicity"]

    path = _mutated(tmp_path, drop)
    with pytest.raises(SnapshotFormatError):
        SnapshotTNG(path).get_metallicities(ParticleType.gas)
    both(SnapshotTNG(path), JSnapshotTNG(path), "get_metallicities", ("pt", "gas"))


def test_scalar_header_attrs(tmp_path):
    def scalar(f, first):
        if first:
            hdr = f["Header"].attrs
            hdr["Redshift"] = float(np.atleast_1d(hdr["Redshift"])[0])
            hdr["HubbleParam"] = float(np.atleast_1d(hdr["HubbleParam"])[0])

    path = _mutated(tmp_path, scalar)
    port, ref = SnapshotTNG(path), JSnapshotTNG(path)
    assert port.redshift == ref.redshift and port.h == ref.h
    both(port, ref, "get_positions", ("pt", "gas"))


def test_exported():
    assert io.SnapshotTNG is SnapshotTNG and io.CatalogueTNG is CatalogueTNG
