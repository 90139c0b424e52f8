"""The port's sharded deposits (``astro_sph_tools_tpu_torch.parallel``)
over gloo on the CPU, held to the JAX package's.

Four ranks are spawned once for the file (``torch_dist.RankPool``); each
case runs on the four (``world`` 4) and on one rank alone (``world`` 1,
its single-rank group, where the halo ring is local). The JAX references
run here on ``make_mesh(4)`` and ``make_mesh(1)`` of the 8 virtual CPU
devices. Tolerances: whole-engine f32 runs against JAX's ``engine="xla"``
2e-5 * max, each engine against the f64 oracle of ``tests/oracles.py``
1e-5 * max; the coherent engines against the port's single-device engine
1e-5 * max and against the f64 oracle of the particles where the sorted
layout places them (their f32 tile-local coordinates, within 2^-16 px of
the input: footprints here go down to 0.05 px, where that rounding alone
moves a peak by ~4e-5 of the max, in the JAX package's engines as in the
port's). ``test_torch_parallel_coherent.py`` holds them to JAX's sharded
coherent engine and to the oracle of the input coordinates.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_tasks as T
from astro_sph_tools_tpu.ops.deposit import MapSpec as JMapSpec
from astro_sph_tools_tpu.ops.grid3d import GridSpec as JGridSpec
from astro_sph_tools_tpu.parallel.sharded import (
    deposit_2d_sharded as j_deposit_2d_sharded,
    deposit_3d_sharded as j_deposit_3d_sharded,
    make_mesh as j_make_mesh,
)
from astro_sph_tools_tpu_torch.ops import MapSpec, deposit_2d_coherent, tile_particles
from astro_sph_tools_tpu_torch.ops.grid3d import GridSpec
from astro_sph_tools_tpu_torch.parallel import (
    Mesh,
    make_mesh,
    pad_for_mesh,
    pad_particles_mesh,
    partition_particles_by_slab,
)
from oracles import grid3d_oracle, project_oracle
from torch_dist import RankError, RankPool

JAX_TOL = 2e-5
ORACLE_TOL = 1e-5
PLACE_TOL = 2.0**-16  # px: an f32 ulp of a tile-local coordinate below 128 px


def rel_err(got, ref):
    return float(np.abs(np.asarray(got, np.float64) - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(4, str(tmp_path_factory.mktemp("gloo")))
    yield p
    p.close()


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(1, device="cpu")


@pytest.mark.parametrize("world", [4, 1])
def test_ring_shift(pool, world):
    got = pool.run(T.ring, (world,))
    if world == 1:  # the ring at one rank returns its own input
        assert got == [(0.0, 0.0, True)] * 4
    else:
        assert got == [(float((r - 1) % 4), float((r + 1) % 4), False) for r in range(4)]


# ---------------------------------------------------------------------------
# 2D: the shapes of tests/test_parallel.py
# ---------------------------------------------------------------------------


def _case_2d(rng, name):
    box = 10.0 if name != "periodic" else 8.0
    if name == "open":
        n, shape, hval, fields = 5000, (64, 64), 0.22, 1
    elif name == "multifield":
        n, shape, hval, fields = 2048, (32, 32), 0.2, 2
    else:
        n, shape, hval, fields = 3000, (64, 64), 0.2, 1
    x = rng.uniform(0, box, n)
    y = rng.uniform(0, box, n)
    if name == "periodic":
        x[:200] = rng.uniform(0, 0.05, 200)  # edge hugging
    h = np.full(n, hval)
    m = rng.uniform(0.5, 2.0, n)
    v = m if fields == 1 else np.stack([m, m * rng.uniform(1e4, 1e6, n)], axis=1)
    periodic = name == "periodic"
    return x, y, h, v, shape, (0.0, box, 0.0, box), periodic


@pytest.mark.parametrize("world", [4, 1])
@pytest.mark.parametrize("name", ["open", "multifield", "periodic"])
def test_deposit_2d_sharded_matches_jax_and_oracle(pool, rng, world, name):
    x, y, h, v, shape, extent, periodic = _case_2d(rng, name)
    chunk = 256
    xp, yp, hp, vp = (a.astype(np.float32) for a in pad_for_mesh([x, y, h, v], 4, chunk, pad_values=[0, 0, 1.0, 0]))
    jspec = JMapSpec(shape=shape, extent=extent, periodic_wrap=periodic)
    ref = np.asarray(j_deposit_2d_sharded(
        jnp.asarray(xp), jnp.asarray(yp), jnp.asarray(hp), jnp.asarray(vp), jspec, j_make_mesh(world),
        K=8, chunk=chunk, engine="xla", precision="f32",
    ))
    m = v if v.ndim == 1 else v[:, 0]
    oracle = project_oracle(x, y, h, m, shape, extent, periodic=periodic)
    spec = MapSpec(shape=shape, extent=extent, periodic_wrap=periodic)
    for engine in ("pallas", "xla"):
        got = pool.run(T.deposit_2d, (world, xp, yp, hp, vp, spec, dict(K=8, chunk=chunk, engine=engine)),
                       ranks=range(4 if world == 4 else 1))
        for g in got[1:]:  # the same map on every rank
            np.testing.assert_array_equal(g, got[0])
        assert got[0].shape == ref.shape
        assert rel_err(got[0], ref) <= JAX_TOL, engine
        assert rel_err(got[0] if v.ndim == 1 else got[0][..., 0], oracle) <= ORACLE_TOL, engine


def test_deposit_2d_sharded_validation(pool, rng):
    x, y, h, v, shape, extent, _ = _case_2d(rng, "open")
    spec = MapSpec(shape=shape, extent=extent)
    for kw, match in ((dict(K=80), "no pallas level"), (dict(engine="mosaic"), "engine"),
                      (dict(precision="fp32"), "precision")):
        got = pool.run(T.deposit_2d, (1, x, y, h, v, spec, kw), ranks=[0])[0]
        assert isinstance(got, RankError) and got.kind == "ValueError" and match in got.message


# ---------------------------------------------------------------------------
# 3D: slabs and the halo ring
# ---------------------------------------------------------------------------


def _case_3d(rng, periodic):
    box = 8.0
    if periodic:
        n, shape = 1500, (32, 16, 16)
        pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
        # edge-hugging particles in every axis: x and y wrap inside the
        # rank, z wraps round the ring
        pos[:100, 2] = rng.uniform(0, 0.05, 100)
        pos[100:200, 0] = rng.uniform(0, 0.02, 100)
        pos[200:300, 1] = rng.uniform(box - 0.02, box, 100).astype(np.float32)
        m = np.ones(n, np.float32)
    else:
        n, shape = 3000, (32, 24, 24)
        pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
        m = rng.uniform(0.5, 2.0, n).astype(np.float32)
    # K = 4: the support 2h must stay within (K - 2) / 2 = 1 voxel (0.25)
    h = np.full(n, 0.11, np.float32)
    return pos, h, m, shape, (0.0, box) * 3, periodic


@pytest.mark.parametrize("world", [4, 1])
@pytest.mark.parametrize("periodic", [False, True])
def test_deposit_3d_sharded_matches_jax_and_oracle(pool, rng, world, periodic):
    pos, h, m, shape, extent, periodic = _case_3d(rng, periodic)
    chunk = 256
    jspec = JGridSpec(shape=shape, extent=extent, periodic_wrap=periodic)
    pp, hp, mp = partition_particles_by_slab(pos, h, m, jspec, world, chunk=chunk)
    ref = np.asarray(j_deposit_3d_sharded(
        jnp.asarray(pp), jnp.asarray(hp), jnp.asarray(mp), jspec, j_make_mesh(world),
        K=4, chunk=chunk, engine="xla", precision="f32",
    ))
    oracle = grid3d_oracle(pos.astype(np.float64), h.astype(np.float64), m.astype(np.float64), shape, extent,
                           periodic=periodic)
    spec = GridSpec(shape=shape, extent=extent, periodic_wrap=periodic)
    for engine in ("pallas", "xla"):
        slabs = pool.run(T.deposit_3d, (world, pp, hp, mp, spec, dict(K=4, chunk=chunk, engine=engine)),
                         ranks=range(world))
        got = np.concatenate(slabs)
        assert got.shape == shape
        assert rel_err(got, ref) <= JAX_TOL, engine
        assert rel_err(got, oracle) <= ORACLE_TOL, engine


def test_deposit_3d_sharded_slab_thinner_than_halo(pool, rng):
    pos, h, m, _, extent, _ = _case_3d(rng, False)
    spec = GridSpec(shape=(8, 24, 24), extent=extent)
    got = pool.run(T.deposit_3d, (0, pos[:8], h[:8], m[:8], spec, dict(K=8)))  # slabs of 2 planes, halo 4
    assert all(isinstance(g, RankError) and "thinner than its halo" in g.message for g in got)


# ---------------------------------------------------------------------------
# the coherent engines against the port's single-device engine
# ---------------------------------------------------------------------------


def coherent_set(rng, n, box, px, h_clip=12.0):
    """Cell-ordered (snapshot-like) clustered particles with density-
    correlated smoothing lengths (tests/test_deposit_coherent.py's)."""
    cx = rng.uniform(0, box, n)
    cy = rng.uniform(0, box, n)
    cell = np.floor(cy / (box / 32)).astype(int) * 32 + np.floor(cx / (box / 32)).astype(int)
    order = np.argsort(cell, kind="stable")
    x, y = cx[order].astype(np.float32), cy[order].astype(np.float32)
    dens = rng.uniform(0.3, 3.0, 1024)[cell[order]]
    h = np.clip(0.6 * px * dens ** (-1 / 3) * np.exp(0.6 * rng.normal(size=n)), 0.05 * px, h_clip * px)
    m = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return x, y, h.astype(np.float32), m


def placed_oracle(x, y, h, values, spec):
    """The (F, ny, nx) f64 oracle of the particles (N,) with ``values``
    (F, N) where the sorted layout places them: the world coordinates of
    their f32 tile-local coordinates and their tile's origin, checked here
    to lie within PLACE_TOL px of the input."""
    tp = tile_particles(x, y, h, values, spec, need_perm=True, device="cpu")
    x0, x1, y0, y1 = spec.extent
    ny, nx = spec.shape
    psx, psy = (x1 - x0) / nx, (y1 - y0) / ny
    u, v = tp.sorted_u.double().clone(), tp.sorted_v.double().clone()
    for geom, lo, count in tp.geoms:
        tile = tp.sorted_tile[lo:lo + count].long()
        u[lo:lo + count] += (tile % geom.n_tiles_x) * geom.tx - geom.cfg.M
        v[lo:lo + count] += (tile // geom.n_tiles_x) * geom.cfg.TY - geom.cfg.M
    perm = tp.perm.numpy()
    px_, py_ = x0 + u.numpy() * psx, y0 + v.numpy() * psy
    assert np.abs(px_ - np.asarray(x, np.float64)[perm]).max() <= PLACE_TOL * psx
    assert np.abs(py_ - np.asarray(y, np.float64)[perm]).max() <= PLACE_TOL * psy
    ph, pv = tp.sorted_h.double().numpy(), tp.sorted_values.double().numpy()
    return np.stack([project_oracle(px_, py_, ph, f, spec.shape, spec.extent, periodic=spec.periodic_wrap)
                     for f in pv])


def within_oracle(got, oracle):
    """Each field of the map stack ``got`` within ORACLE_TOL * max of its oracle."""
    got = np.asarray(got).reshape(oracle.shape)
    for f in range(oracle.shape[0]):
        assert rel_err(got[f], oracle[f]) <= ORACLE_TOL, f


@pytest.fixture(scope="module")
def coherent_case():
    rng = np.random.default_rng(31)
    box = 10.0
    spec = MapSpec(shape=(64, 64), extent=(0, box, 0, box), periodic_wrap=True)
    x, y, h, m = coherent_set(rng, 4 * 3 * 2048 - 700, box, box / 64)
    fields = np.stack([m, m * rng.uniform(1, 2, m.size).astype(np.float32)])
    xp, yp, hp, vp = pad_particles_mesh(x, y, h, fields, spec, 4)
    refs = {prep: deposit_2d_coherent(xp, yp, hp, vp, spec, prep=prep, device="cpu").numpy()
            for prep in ("pallas", "xla")}
    return spec, (xp, yp, hp, vp), refs, placed_oracle(x, y, h, fields, spec)


@pytest.mark.parametrize("world", [4, 1])
@pytest.mark.parametrize("prep", ["pallas", "xla"])
def test_coherent_sharded_matches_single_device(pool, coherent_case, world, prep):
    spec, (xp, yp, hp, vp), refs, oracle = coherent_case
    ref = refs[prep]
    got = pool.run(T.coherent, (world, xp, yp, hp, vp, spec, dict(prep=prep)), ranks=range(4 if world == 4 else 1))
    for g in got:
        assert g.shape == ref.shape
        np.testing.assert_array_equal(g, got[0])
    assert rel_err(got[0], ref) <= ORACLE_TOL
    within_oracle(got[0], oracle)
    if world == 1:  # one rank renders what the single-device engine does
        np.testing.assert_array_equal(got[0], ref)


@pytest.mark.parametrize("world", [4, 1])
def test_coherent_fused_matches_single_device(pool, coherent_case, world):
    spec, (xp, yp, hp, vp), refs, oracle = coherent_case
    ref = refs["xla"]  # the CPU's default row prep
    got = pool.run(T.coherent_fused, (world, xp, yp, hp, vp, spec, -1), ranks=range(4 if world == 4 else 1))
    assert all(ok for _, ok, _ in got)
    assert len({c for _, _, c in got}) == 1  # one set of capacities on every rank
    for img, _, _ in got:
        np.testing.assert_array_equal(img, got[0][0])
    assert rel_err(got[0][0], ref) <= ORACLE_TOL
    within_oracle(got[0][0], oracle)


def test_coherent_fused_overflow_on_one_rank_fails_every_rank(pool, coherent_case):
    spec, (xp, yp, hp, vp), _, _ = coherent_case
    got = pool.run(T.coherent_fused, (0, xp, yp, hp, vp, spec, 2))
    assert [ok for _, ok, _ in got] == [False] * 4


@pytest.mark.parametrize("what", ["oversize", "rows"])
def test_coherent_bad_rank_raises_on_every_rank(pool, coherent_case, what):
    spec, (xp, yp, hp, vp), _, _ = coherent_case
    got = pool.run(T.coherent_bad_rank, (xp, yp, hp, vp, spec, 1, what))
    match = "oversize" if what == "oversize" else "multiple of 2048"
    assert all(isinstance(g, RankError) and g.kind == "ValueError" and match in g.message for g in got), got
    # the pool is still usable: no rank was left in a collective
    assert pool.run(T.ring, (4,))[0] == (3.0, 1.0, False)


@pytest.mark.parametrize("what", ["oversize", "rows"])
def test_coherent_fused_bad_rank_fails_every_rank(pool, coherent_case, what):
    """The fused engine makes no host sync, so it does not raise: one rank's
    oversize smoothing length or shard not in whole rows makes ``ok`` False
    on every rank, and every rank joins both reductions."""
    spec, (xp, yp, hp, vp), _, _ = coherent_case
    got = pool.run(T.coherent_bad_rank, (xp, yp, hp, vp, spec, 1, what, "fused"))
    assert not any(isinstance(g, RankError) for g in got), got
    assert [ok for _, ok in got] == [False] * 4
    for img, _ in got:
        assert img.shape == (2, *spec.shape)
    assert pool.run(T.ring, (4,))[0] == (3.0, 1.0, False)


def test_mesh_is_a_dataclass_of_the_rank():
    m = Mesh(group=None, rank=2, size=4, device=torch.device("cpu"))
    assert m.axis_name == "data" and m.global_rank(3) == 3


@pytest.mark.parametrize("world", [4, 1])
def test_render_halo_maps_sharded_matches_oracle(pool, rng, world):
    """The shape of tests/test_parallel.py::TestShardedHaloMaps: catalogue
    centres, cutouts, the sharded render; each map against the f64 oracle
    of the particles recentred in f64."""
    box, n = 16.0, 4000
    pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
    h = np.full(n, 0.15, np.float32)
    m = rng.uniform(0.5, 2.0, n).astype(np.float32)
    centres = rng.uniform(0, box, (3, 3)).astype(np.float32)
    radii = np.array([1.2, 0.8, 1.5], np.float32)
    got = pool.run(T.halo_maps_sharded, (world, pos, h, m, centres, radii, [0, 2], box, 64),
                   ranks=range(4 if world == 4 else 1))
    for maps in got:
        for k, hi in enumerate([0, 2]):
            rc = (pos.astype(np.float64) - centres[hi] + box / 2) % box
            hw = 2.0 * float(radii[hi])
            lo, top = box / 2 - hw, box / 2 + hw
            exp = project_oracle(rc[:, 0], rc[:, 1], h, m, (64, 64), (lo, top, lo, top))
            assert rel_err(maps[k], exp) <= ORACLE_TOL


def test_collectives_with_uneven_and_empty_pieces(pool):
    for r, (gathered, got, counts) in enumerate(pool.run(T.comm)):
        assert [g.tolist() for g in gathered] == [list(range(k * 10, k * 10 + k)) for k in range(4)]
        assert counts == [r] * 4
        assert got.tolist() == [100 * k + r for k in range(4) for _ in range(r)]


def test_a_rank_without_particles(pool, coherent_case):
    """The last rank holds no particle: every engine still joins its
    collectives and the maps are the other ranks' sums."""
    spec, (xp, yp, hp, vp), _, _ = coherent_case
    x, y, h, m = xp[:3 * 2048], yp[:3 * 2048], hp[:3 * 2048], vp[0, :3 * 2048]
    rng = np.random.default_rng(3)
    pos, h3, m3, shape, extent, _ = _case_3d(rng, True)
    spec3 = GridSpec(shape=shape, extent=extent, periodic_wrap=True)
    caps = (8192, (64,) * 12, (4096,) * 4)
    got = pool.run(T.empty_last_rank, (x, y, h, m, spec, pos, h3, m3, spec3, caps))
    ref2 = deposit_2d_coherent(x, y, h, m, spec, device="cpu").numpy()
    oracle2 = placed_oracle(x, y, h, m[None], spec)
    kept = np.clip((pos[:, 2] / (extent[5] / 4)).astype(int), 0, 3) < 3  # the last slab's particles are left out
    oracle3 = grid3d_oracle(pos[kept].astype(np.float64), h3[kept].astype(np.float64), m3[kept].astype(np.float64),
                            shape, extent, periodic=True)
    for g in got:
        for name in ("2d", "coherent", "fused"):
            assert rel_err(g[name], ref2) <= ORACLE_TOL, name
        for name in ("coherent", "fused"):
            within_oracle(g[name], oracle2)
        assert g["ok"]
    assert rel_err(np.concatenate([g["3d"] for g in got]), oracle3) <= ORACLE_TOL


def test_default_device_is_the_ranks_card(monkeypatch):
    from astro_sph_tools_tpu_torch.parallel import mesh as M

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M._default_device(0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert M._default_device(3) == torch.device("cuda", 1)
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert M._default_device(3) == torch.device("cuda", 0)


def test_host_staging_is_chosen_by_the_backend():
    """A CUDA tensor on a gloo group goes through the host; NCCL, and any
    CPU tensor, never stage."""
    from astro_sph_tools_tpu_torch.parallel._comm import _staged

    class FakeTensor:
        def __init__(self, device):
            self.device = torch.device(device)

    def mesh_of(backend):
        return type("BackendMesh", (Mesh,), {"backend": backend})(None, 0, 1, torch.device("cpu"))

    assert _staged(FakeTensor("cuda"), mesh_of("gloo"))
    assert not _staged(FakeTensor("cuda"), mesh_of("nccl"))
    assert not _staged(FakeTensor("cpu"), mesh_of("gloo"))


def test_exports_the_jax_packages_names():
    import astro_sph_tools_tpu.parallel as jax_parallel
    import astro_sph_tools_tpu_torch.parallel as port_parallel

    assert set(jax_parallel.__all__) | {"Mesh"} <= set(port_parallel.__all__)
    for name in port_parallel.__all__:
        assert getattr(port_parallel, name) is not None
