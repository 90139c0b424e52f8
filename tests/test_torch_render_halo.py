"""Port vs JAX: ``render_halo_maps``, halo-centred map stacks.

Mirrors ``tests/test_render.py:79-135`` on the port (``device="cpu"``: the
sorted engine runs its plain kernel version) and holds it to the JAX
package:

- both port engines (``pallas``, the sorted tile engine; ``xla``, the
  stencil engine) against JAX's ``engine="xla"`` (the XLA twin of its Pallas
  engine) within 2e-5 * max, the whole-engine f32 bound; ``mean_*`` maps
  where the surface density exceeds 1e-3 of its maximum (elsewhere they
  divide two near-zero maps);
- each cutout against the f64 oracle ``tests/oracles.py::project_oracle_fast``
  on positions recentred in f64, within 1e-5 * max;
- a halo whose cutout crosses the periodic corner against the render of the
  same particles translated by a box fraction first (2e-5 * max);
- a small cutout in a 100 Mpc box, where the JAX package's f32 recentring
  (x64 off) costs it accuracy: the port is held to the oracle, JAX's error
  is recorded;
- SOAP (SWIFT) and TNG catalogues, one case each, against JAX.
"""

import numpy as np
import pytest
import torch

from astro_sph_tools_tpu.io.eagle import SnapshotEAGLE as JSnapshotEAGLE
from astro_sph_tools_tpu.io.subfind import CatalogueSUBFIND as JCatalogueSUBFIND
from astro_sph_tools_tpu.io.synthetic import (
    SyntheticSnapshotSpec,
    write_catalogue,
    write_snapshot,
    write_soap_catalogue,
    write_swift_snapshot,
    write_tng_snapshot,
)
from astro_sph_tools_tpu.render import render_halo_maps as j_render
from astro_sph_tools_tpu_torch import render_halo_maps as t_render
from astro_sph_tools_tpu_torch.data_structures import ParticleType
from astro_sph_tools_tpu_torch.io.eagle import SnapshotEAGLE
from astro_sph_tools_tpu_torch.io.subfind import CatalogueSUBFIND
from astro_sph_tools_tpu_torch.units import unit_array
from oracles import project_oracle_fast

PATH_TOL = 2e-5  # whole-engine f32 runs: twice the 1e-5 budget
ORACLE_TOL = 1e-5


def rel_err(got, ref, where=None):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if where is not None:
        got, ref = got[where], ref[where]
    return np.abs(got - ref).max() / np.abs(ref).max()


def assert_stacks_match(got, ref, tol=PATH_TOL):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert set(g.keys()) == set(r.keys())
        assert g.spec.extent == pytest.approx(r.spec.extent, rel=1e-12)
        assert g.spec.shape == r.spec.shape and not g.spec.periodic_wrap
        covered = r["surface_density"] > 1e-3 * r["surface_density"].max()
        for name in r.keys():
            where = covered if name.startswith("mean_") else None
            assert rel_err(g[name], r[name], where) <= tol, name


def oracle_cutout(pos, h, m, centre, box, stack):
    """f64 oracle of one cutout: positions recentred in f64 (single wrap)."""
    rec = pos[:, :2] + (box / 2 - centre[:2])
    rec = np.where((rec < 0) | (rec >= box), rec - np.sign(rec) * box, rec)
    return project_oracle_fast(rec[:, 0], rec[:, 1], h, m, stack.spec.shape, stack.spec.extent)


@pytest.fixture(scope="module")
def eagle(tmp_path_factory):
    spec = SyntheticSnapshotSpec(n_gas=4096, n_dm=256, n_star=64, n_bh=2, clustered=True, n_groups=5)
    root = tmp_path_factory.mktemp("torch_halo_sim")
    path, truth = write_snapshot(str(root), spec)
    memb, prop = write_catalogue(str(root), spec, truth)
    snap = SnapshotEAGLE(path)
    jsnap = JSnapshotEAGLE(path)
    return (snap, CatalogueSUBFIND(memb, prop, snap)), (jsnap, JCatalogueSUBFIND(memb, prop, jsnap))


class TestRenderHaloMaps:
    def test_halo_cutouts(self, eagle):
        (snap, cat), _ = eagle
        stacks = t_render(snap, cat, [0, 2], fields=("density", "temperature"), resolution=32,
                          engine="xla", device="cpu")
        assert len(stacks) == 2
        for stack in stacks:
            sd = stack["surface_density"]
            assert sd.shape == (32, 32) and np.isfinite(sd).all()
            assert "mean_temperature" in stack.keys()
            assert {"recentre", "select", "deposit", "derive", "to_host"} <= set(stack.timings)
        assert "io" in stacks[0].timings and "io" not in stacks[1].timings
        lo, hi, *_ = stacks[0].spec.extent
        assert lo < 5.0 < hi

    def test_halo_centre_is_densest_region(self, tmp_path):
        spec = SyntheticSnapshotSpec(n_gas=8192, n_dm=64, n_star=16, n_bh=2, clustered=True, n_groups=3, seed=5)
        path, truth = write_snapshot(str(tmp_path), spec)
        memb, prop = write_catalogue(str(tmp_path), spec, truth)
        snap = SnapshotEAGLE(path)
        (stack,) = t_render(snap, CatalogueSUBFIND(memb, prop, snap), [1], radius_multiple=4.0,
                            resolution=48, engine="pallas", device="cpu")
        sd = stack["surface_density"]
        n = sd.shape[0]
        inner = sd[n // 4:-n // 4, n // 4:-n // 4]
        outer = (sd.sum() - inner.sum()) / (sd.size - (n // 2) ** 2)
        assert inner.mean() > outer

    @pytest.mark.parametrize("engine", ["pallas", "xla"])
    def test_matches_jax_and_oracle(self, eagle, engine):
        (snap, cat), (jsnap, jcat) = eagle
        kw = dict(fields=("density", "temperature", "metallicity"), resolution=32, radius_multiple=2.5)
        ref = j_render(jsnap, jcat, [0, 2, 4], engine="xla", **kw)
        got = t_render(snap, cat, [0, 2, 4], engine=engine, device="cpu", **kw)
        assert_stacks_match(got, ref)
        pos = snap.get_positions(ParticleType.gas).to_value("Mpc")
        h = snap.get_smoothing_lengths(ParticleType.gas).to_value("Mpc")
        m = snap.get_masses(ParticleType.gas).to_value("Msun")
        centres = cat.get_halo_centres_of_potential().to_value("Mpc")
        for k, stack in zip([0, 2, 4], got):
            expected = oracle_cutout(pos, h, m, centres[k], 10.0, stack)
            assert rel_err(stack["surface_density"], expected) <= ORACLE_TOL

    def test_mesh_raises(self, eagle):
        """``mesh`` takes a parallel.Mesh (the mesh path itself runs in
        tests/test_torch_parallel_multiprocess.py); anything else raises."""
        (snap, cat), _ = eagle
        with pytest.raises(TypeError, match="make_mesh"):
            t_render(snap, cat, [0], mesh=object(), device="cpu")

    def test_bad_field_and_engine(self, eagle):
        (snap, cat), _ = eagle
        with pytest.raises(ValueError, match="field"):
            t_render(snap, cat, [0], fields=("entropy",), device="cpu")
        with pytest.raises(ValueError, match="engine"):
            t_render(snap, cat, [0], engine="coherent", device="cpu")

    @pytest.mark.skipif(torch.cuda.is_available(), reason="checks the failure without a card")
    def test_no_card_fails_loudly(self, eagle):
        """The default device is the card: without one the call raises
        (there is no silent CPU fallback)."""
        (snap, cat), _ = eagle
        with pytest.raises((RuntimeError, AssertionError)):
            t_render(snap, cat, [0], resolution=16)


# ---------------------------------------------------------------------------
# In-memory cases: the halo centre and the box are chosen by the test
# ---------------------------------------------------------------------------


class MemorySnapshot:
    """What both packages' ``render_halo_maps`` read of a snapshot."""

    def __init__(self, pos, h, m, t, z, box):
        self.box_size = unit_array(np.full(3, box), "Mpc")
        self._f = dict(pos=pos, h=h, m=m, t=t, z=z)

    def get_positions(self, pt):
        return unit_array(self._f["pos"], "Mpc")

    def get_smoothing_lengths(self, pt):
        return unit_array(self._f["h"], "Mpc")

    def get_masses(self, pt):
        return unit_array(self._f["m"], "Msun")

    def get_temperatures(self, pt):
        return unit_array(self._f["t"], "K")

    def get_metallicities(self, pt):
        return unit_array(self._f["z"], "")


class MemoryCatalogue:
    def __init__(self, centres, radii):
        self._c, self._r = np.asarray(centres, np.float64), np.asarray(radii, np.float64)

    def get_halo_centres_of_potential(self):
        return unit_array(self._c, "Mpc")

    def get_halo_radii(self, definition):
        # SO 200 crit, the default of both packages
        assert type(definition).__name__ == "CriticalSphericalOverdensityAperture"
        assert definition.overdensity_limit == 200
        return unit_array(self._r, "Mpc")


def blob(rng, n, centre, sigma, box, h_range):
    pos = np.mod(centre + rng.normal(0.0, sigma, (n, 3)), box)
    h = rng.uniform(*h_range, n)
    return pos, h, rng.uniform(0.5, 2.0, n), rng.uniform(1e4, 1e6, n), rng.uniform(0.0, 0.02, n)


@pytest.mark.parametrize("engine", ["pallas", "xla"])
def test_periodic_corner_matches_translated_render(engine):
    """A cutout across the box corner (0, 0) equals the render of the same
    particles (and centre) translated by 0.37 box first."""
    rng = np.random.default_rng(31)
    box = 10.0
    centre = np.array([0.08, 9.95, 4.0])
    pos, h, m, t, z = blob(rng, 4000, centre, 0.4, box, (0.02, 0.12))
    shift = 0.37 * box
    kw = dict(fields=("density", "temperature", "metallicity"), resolution=48, engine=engine, device="cpu")
    (edge,) = t_render(MemorySnapshot(pos, h, m, t, z, box), MemoryCatalogue([centre], [0.3]), [0], **kw)
    moved = MemorySnapshot(np.mod(pos + shift, box), h, m, t, z, box)
    (inner,) = t_render(moved, MemoryCatalogue([np.mod(centre + shift, box)], [0.3]), [0], **kw)
    assert edge["surface_density"].sum() > 0
    assert_stacks_match([edge], [inner])
    expected = oracle_cutout(pos, h, m, centre, box, edge)
    assert rel_err(edge["surface_density"], expected) <= ORACLE_TOL


def test_f64_recentring_in_a_large_box():
    """A 0.4 Mpc cutout at x = 67 Mpc in a 100 Mpc box: the port recentres
    in f64 and deposits in coordinates from the cutout's centre, and holds
    the f64 oracle at 1e-5 * max; the JAX package recentres in f32 (ulp of
    ~4e-6 Mpc at box/2, ~1e-3 px here) and misses it. JAX's error is
    recorded, not bounded."""
    rng = np.random.default_rng(47)
    box = 100.0
    centre = np.array([67.123456789, 33.2109876, 50.5])
    pos, h, m, t, z = blob(rng, 3000, centre, 0.08, box, (0.004, 0.03))
    snap = MemorySnapshot(pos, h, m, t, z, box)
    cat = MemoryCatalogue([centre], [0.1])
    (got,) = t_render(snap, cat, [0], resolution=64, engine="pallas", device="cpu")
    (ref,) = j_render(snap, cat, [0], resolution=64, engine="xla")
    expected = oracle_cutout(pos, h, m, centre, box, got)
    port_err = rel_err(got["surface_density"], expected)
    jax_err = rel_err(ref["surface_density"], expected)
    print(f"f64 oracle: port {port_err:.3e}, JAX (f32 recentring) {jax_err:.3e}")
    assert port_err <= ORACLE_TOL
    assert jax_err > 10 * port_err


# ---------------------------------------------------------------------------
# SOAP (SWIFT) and TNG catalogues
# ---------------------------------------------------------------------------


def test_soap_catalogue_halo_maps(tmp_path):
    from astro_sph_tools_tpu.io.swift import CatalogueSOAP as JCatalogueSOAP
    from astro_sph_tools_tpu.io.swift import SnapshotSWIFT as JSnapshotSWIFT
    from astro_sph_tools_tpu_torch.io.swift import CatalogueSOAP, SnapshotSWIFT

    spec = SyntheticSnapshotSpec(n_gas=4096, n_dm=128, n_star=32, n_bh=2, clustered=True, n_groups=4)
    path, truth = write_swift_snapshot(str(tmp_path), spec)
    cat_path, memb_path, _ = write_soap_catalogue(str(tmp_path), spec, truth)
    snap = SnapshotSWIFT(path)
    jsnap = JSnapshotSWIFT(path)
    kw = dict(fields=("density", "temperature"), resolution=32, radius_multiple=3.0)
    got = t_render(snap, CatalogueSOAP(cat_path, memb_path, snap), [0, 3], engine="pallas", device="cpu", **kw)
    ref = j_render(jsnap, JCatalogueSOAP(cat_path, memb_path, jsnap), [0, 3], engine="xla", **kw)
    assert got[0]["surface_density"].sum() > 0
    assert_stacks_match(got, ref)


def test_tng_catalogue_halo_maps(tmp_path):
    from astro_sph_tools_tpu.io.tng import CatalogueTNG as JCatalogueTNG
    from astro_sph_tools_tpu.io.tng import SnapshotTNG as JSnapshotTNG
    from astro_sph_tools_tpu_torch.io.tng import CatalogueTNG, SnapshotTNG

    spec = SyntheticSnapshotSpec(n_gas=4096, n_dm=128, n_star=32, n_bh=2, clustered=True, n_groups=4)
    path, cat_path, _, _ = write_tng_snapshot(str(tmp_path), spec)
    snap = SnapshotTNG(path)
    jsnap = JSnapshotTNG(path)
    kw = dict(fields=("density", "temperature"), resolution=32, radius_multiple=3.0)
    got = t_render(snap, CatalogueTNG(cat_path, snap), [1, 2], engine="pallas", device="cpu", **kw)
    ref = j_render(jsnap, JCatalogueTNG(cat_path, jsnap), [1, 2], engine="xla", **kw)
    assert got[0]["surface_density"].sum() > 0
    assert_stacks_match(got, ref)


@pytest.mark.parametrize("engine", ["pallas", "xla"])
def test_empty_cutout_gives_zero_maps(engine):
    """A halo whose cutout holds no particle support: every map is zero
    (the weighted means too), on both engines."""
    rng = np.random.default_rng(3)
    pos = np.c_[rng.uniform(0.0, 2.0, (100, 2)), np.zeros(100)]
    snap = MemorySnapshot(pos, np.full(100, 0.05), np.ones(100), np.ones(100), np.full(100, 0.01), 10.0)
    (stack,) = t_render(snap, MemoryCatalogue([[7.0, 7.0, 0.0]], [0.2]), [0], fields=("density", "temperature"),
                        resolution=16, engine=engine, device="cpu")
    assert set(stack.keys()) == {"surface_density", "mass_weighted_temperature", "mean_temperature"}
    for m in stack.maps.values():
        assert m.shape == (16, 16) and not m.any()
