"""Port vs JAX: the shear grouping (stage A, the gang append, the fine
(level, tile) layout, the coarse bucketing) and the random-order render
``deposit_2d_bucketed``.

The JAX package's append runs its Pallas kernel in interpret mode on the CPU
(``_shear_append(..., interpret=True)``); the port runs the kernel's plain
torch version, which is what its wrapper takes for a CPU tensor. Inputs are
NumPy arrays made from a seed and handed to both. Bounds:

- run geometry (stage A), per-level counts, tile sequences and pad
  positions: equal (they depend on the keys alone, whatever order the
  unstable sorts leave within equal keys);
- appended gangs, fed the same stage-A output: equal on every gang in
  [0, n_gang_total);
- grouped records: equal as multisets (the order within a run is free);
- maps against the f64 oracle and the port's sorted engine: 1e-5 * max.

The JAX stage A reshapes each band into 512-record slabs and cannot run at
band lengths >= 512 that 512 does not divide (ROADMAP §3), so parity sizes
keep L = N / 2048 below 512; the port alone runs at L = 600 against a NumPy
grouping. The CUDA tests need a card and skip here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from astro_sph_tools_tpu.ops import layout_shear as J
from astro_sph_tools_tpu.ops.deposit import MapSpec as JMapSpec
from astro_sph_tools_tpu.ops.deposit_pallas import tile_particles as j_tile_particles
from astro_sph_tools_tpu_torch.ops import MapSpec, deposit_2d_auto, deposit_tiled, tile_particles
from astro_sph_tools_tpu_torch.ops import layout_shear as P
from astro_sph_tools_tpu_torch.ops.deposit_tiled import tiled_particles_from_arrays
from oracles import project_oracle

STRIDE = 1 << 22
BOX = 10.0
TOL = 1e-5
SEEDS = {"skewed": 3, "single": 4, "one_record_runs": 5}
GEOMETRY = ("src_gang", "head", "ngang", "cum_ngang", "cnt", "cum_nsub", "per_key_gangs",
            "n_gang_total", "n_sub_total")


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def t(a):
    return torch.from_numpy(np.array(a))


def stage_a_keys(rng, case):
    """(int32 keys, n_keys) for a stage-A case: skewed keys over 100, one
    key (a single giant run per band), or a 4096-key space with 8-record
    bands (runs of one record)."""
    if case == "skewed":
        n, nk = 2048 * 16, 100
        key = np.minimum(rng.geometric(0.05, n) - 1, nk - 1)
    elif case == "single":
        n, nk = 2048 * 8, 1
        key = np.zeros(n)
    else:
        n, nk = 2048 * 8, 4096
        key = rng.integers(0, nk, n)
    return key.astype(np.int32), nk


@pytest.mark.parametrize("case", ["skewed", "single", "one_record_runs"])
def test_stage_a_geometry_matches_jax(case):
    """Stage A: the run geometry and totals equal JAX's, and each key's
    records hold the same payload multiset."""
    rng = np.random.default_rng(SEEDS[case])
    key, nk = stage_a_keys(rng, case)
    n = key.shape[0]
    u = rng.uniform(0, 1, n).astype(np.float32)
    perm = np.arange(n, dtype=np.int32)
    jout = J._shear_stage_a([jnp.asarray(key), jnp.asarray(u), jnp.asarray(perm)], n_keys=nk)
    pout = P._shear_stage_a([t(key), t(u), t(perm)], n_keys=nk)
    for name, a, b in zip(GEOMETRY, jout[1:], pout[1:]):
        assert np.array_equal(np.asarray(a), b.numpy()), name
        assert b.dtype == torch.int32, name
    gangs = pout[0]
    assert tuple(gangs.shape) == (n // 128, 2, 128)  # real channels only, no slack
    # band-major records: each run's source records, as in the reference
    rec_perm = gangs[:, 1].contiguous().view(torch.int32).reshape(-1).numpy()
    rec_u = gangs[:, 0].reshape(-1).numpy()
    assert np.array_equal(np.sort(rec_perm), perm)
    assert np.array_equal(u[rec_perm], rec_u)
    jrec = np.asarray(jout[0])[: n // 128, :2]
    src, cnt = np.asarray(jout[1]) * 128 + np.asarray(jout[2]), np.asarray(jout[5])
    jp = jrec[:, 1].view(np.int32).reshape(-1)
    for r in np.flatnonzero(cnt)[:200]:
        seg = slice(src[r], src[r] + cnt[r])
        assert np.array_equal(np.sort(rec_perm[seg]), np.sort(jp[seg]))
        assert (key[rec_perm[seg]] == r // 2048).all()


@pytest.mark.parametrize("case", ["skewed", "single", "one_record_runs"])
def test_append_plain_matches_jax_interpret(case):
    """append_gangs_plain (through the port's schedule) vs the JAX Pallas
    append in interpret mode, fed the same stage-A output: equal on every
    gang in [0, n_gang_total)."""
    rng = np.random.default_rng(10 + SEEDS[case])
    key, nk = stage_a_keys(rng, case)
    n = key.shape[0]
    pays = [rng.uniform(0, 1, n).astype(np.float32) for _ in range(3)]
    gangs, src_gang, _, ngang, cum_ngang, _, cum_nsub, _, ng, ns = J._shear_stage_a(
        [jnp.asarray(key)] + [jnp.asarray(p) for p in pays], n_keys=nk
    )
    ng, ns = int(ng), int(ns)
    port_gangs = t(np.asarray(gangs)[: n // 128, :3])
    geo = [t(a) for a in (src_gang, ngang, cum_ngang, cum_nsub)]
    ref = np.asarray(J._shear_append(
        gangs, src_gang, ngang, cum_ngang, cum_nsub,
        sub_cap=max(J._next_pow2(ns), J._RPB), g_alloc=ng + J._WG + 1, interpret=True,
    ))
    sched = P._shear_schedule(*geo, ns)
    assert tuple(sched.shape) == (ns, 3) and sched.dtype == torch.int32
    assert int(sched[:, 2].min()) >= 1 and int(sched[:, 2].max()) <= 16
    assert int(sched[:, 2].sum()) == ng  # exact lengths: the sub-runs tile the destination
    got = P._shear_append(port_gangs, *geo, n_gang=ng, n_sub=ns)
    assert tuple(got.shape) == (ng, 3, 128)
    assert np.array_equal(got.numpy(), ref[:ng, :3])


def tile_inputs(rng, n, level_n_tiles, order):
    """Composite (level, tile) keys skewed like a real adaptive layout
    (mostly level 0, some oversize), with u, v, h and two fields >= 1."""
    n_levels = len(level_n_tiles)
    level = np.minimum(rng.geometric(0.97, n) - 1, n_levels).astype(np.int32)
    tile = np.zeros(n, np.int32)
    for li, nt in enumerate(level_n_tiles):
        sel = level == li
        if nt == 0:
            level[sel] = n_levels
        else:
            tile[sel] = rng.integers(0, nt, sel.sum())
    key = (level * STRIDE + tile).astype(np.int32)
    if order == "sorted":
        key = np.sort(key)
    u = rng.uniform(0, 100, n).astype(np.float32)
    v = rng.uniform(0, 100, n).astype(np.float32)
    h = rng.uniform(0.1, 3.0, n).astype(np.float32)
    values = rng.uniform(1.0, 2.0, (2, n)).astype(np.float32)
    return key, u, v, h, values


def port_tile_sort(key, u, v, h, values, level_n_tiles, need_perm=True):
    out = P.shear_tile_sort(
        t(key), t(u), t(v), t(h), t(values), level_stride=STRIDE, level_n_tiles=level_n_tiles,
        n_fields=values.shape[0], need_perm=need_perm, n_valid=key.shape[0],
    )
    return [None if a is None else a.numpy() for a in out]


def check_grouping(key, u, values, out, level_n_tiles):
    """Each level segment is tile-sorted across its pad slots, and its valid
    slots hold exactly the level's (tile, u, value) records (NumPy
    reference grouping)."""
    s_tile, su, _, sh, s_values, _, counts = out
    n_levels = len(level_n_tiles)
    level = np.minimum(key // STRIDE, n_levels)
    tile = np.where(level < n_levels, key % STRIDE, 0)
    assert counts.shape == (n_levels + 1,) and (counts % 128 == 0).all()
    assert s_tile.shape[0] == su.shape[0] == int(counts.sum())  # no slack
    lo = 0
    for li in range(n_levels + 1):
        seg = slice(lo, lo + int(counts[li]))
        assert (np.diff(s_tile[seg]) >= 0).all(), f"level {li} tiles not sorted"
        valid = s_values[0, seg] != 0
        got = np.stack([s_tile[seg][valid], su[seg][valid], s_values[0, seg][valid]]).astype(np.float64)
        sel = level == li
        ref = np.stack([tile[sel], u[sel], values[0][sel]]).astype(np.float64)
        assert got.shape == ref.shape, f"level {li}"
        assert np.array_equal(got[:, np.lexsort(got)], ref[:, np.lexsort(ref)]), f"level {li}"
        assert (sh[seg][~valid] == np.float32(1e-6)).all()
        lo += int(counts[li])


@pytest.mark.parametrize("order", ["random", "sorted"])
def test_shear_tile_sort_matches_jax(order):
    """Counts, tile sequences and pad positions equal JAX's; the records
    equal the reference grouping as multisets; perm re-gathers the values."""
    rng = np.random.default_rng(11 if order == "random" else 12)
    level_n_tiles = (24, 12, 0, 4)
    n = 1 << 13
    key, u, v, h, values = tile_inputs(rng, n, level_n_tiles, order)
    out = port_tile_sort(key, u, v, h, values, level_n_tiles)
    check_grouping(key, u, values, out, level_n_tiles)
    jout = J.shear_tile_sort(
        jnp.asarray(key), jnp.asarray(u), jnp.asarray(v), jnp.asarray(h), jnp.asarray(values),
        level_stride=STRIDE, level_n_tiles=level_n_tiles, n_fields=2, need_perm=True,
        n_valid=n, interpret=True,
    )
    s_tile, _, _, _, s_values, perm, counts = out
    total = int(counts.sum())
    assert np.array_equal(counts, np.asarray(jout[6]))
    assert np.array_equal(s_tile, np.asarray(jout[0])[:total])
    assert np.array_equal(s_values[0] == 0, np.asarray(jout[4])[0, :total] == 0)
    # with_values semantics: pads point at n_valid and re-gather as 0
    regather = np.concatenate([values, np.zeros((2, 1), np.float32)], axis=1)[:, perm]
    assert np.array_equal(regather, s_values)
    assert (perm[s_values[0] == 0] == n).all()


def test_shear_tile_sort_single_key_and_no_perm():
    """Everything in one tile: one giant run per band, still exact."""
    rng = np.random.default_rng(13)
    n = 1 << 12
    u = rng.uniform(0, 10, n).astype(np.float32)
    vals = rng.uniform(1, 2, (1, n)).astype(np.float32)
    out = port_tile_sort(np.zeros(n, np.int32), u, u, u, vals, (4,), need_perm=False)
    s_values, perm, counts = out[4], out[5], out[6]
    assert perm is None
    assert int(counts[0]) >= n and int(counts[1]) == 0
    valid = s_values[0] != 0
    assert valid.sum() == n
    assert np.array_equal(np.sort(out[1][valid]), np.sort(u))


def test_shear_tile_sort_long_bands_port_only():
    """n = 600 * 2048 (band length 600, where the reference's histogram
    reshape fails) against the NumPy grouping; also an n that 2048 does not
    divide."""
    rng = np.random.default_rng(17)
    level_n_tiles = (24, 12, 0, 4)
    for n in (600 * 2048, 600 * 2048 - 999):
        key, u, v, h, values = tile_inputs(rng, n, level_n_tiles, "random")
        check_grouping(key, u, values, port_tile_sort(key, u, v, h, values, level_n_tiles), level_n_tiles)


def coarse_inputs(rng, n, n_fields=2, n_cx=2, n_cy=128):
    """Positions drawn away from coarse-cell edges (XLA's f32 division
    rounds differently from torch's near them, ROADMAP §3)."""
    ci = rng.integers(0, n_cx, n)
    cj = rng.integers(0, n_cy, n)
    x = ((ci + rng.uniform(0.05, 0.95, n)) * (BOX / n_cx)).astype(np.float32)
    y = ((cj + rng.uniform(0.05, 0.95, n)) * (BOX / n_cy)).astype(np.float32)
    h = rng.uniform(0.01, 0.3, n).astype(np.float32)
    vals = rng.uniform(0.5, 2.0, (n_fields, n)).astype(np.float32)
    return x, y, h, vals


def test_shear_coarse_group_matches_jax():
    """The coarse grouping equals JAX's: the same slots, the same cell
    sequence over valid slots, the same record multiset."""
    rng = np.random.default_rng(19)
    n = 2048 * 8
    x, y, h, vals = coarse_inputs(rng, n)
    ext = (0.0, BOX, 0.0, BOX)
    gx, gy, gh, gv = (a.numpy() for a in P.shear_coarse_group(
        x, y, h, vals, MapSpec((64, 64), ext, periodic_wrap=True), device="cpu"))
    jx, jy, jh, jv = (np.asarray(a) for a in J.shear_coarse_group(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(h), jnp.asarray(vals),
        JMapSpec((64, 64), ext, periodic_wrap=True), interpret=True))
    # the reference appends into 17 gangs of slack past the data, all pads
    slots = gx.shape[0]
    assert jx.shape[0] == slots + 17 * 128 and (jv[:, slots:] == 0).all()
    jx, jy, jh, jv = jx[:slots], jy[:slots], jh[:slots], jv[:, :slots]
    assert gv.shape == jv.shape == (2, slots)
    valid = gv[0] != 0
    assert np.array_equal(valid, jv[0] != 0) and valid.sum() == n
    assert (gh[~valid] == np.float32(1e-6)).all() and (gx[~valid] == 0).all()
    cell_of = lambda xx, yy: (yy // (BOX / 128)).astype(int) * 2 + (xx // (BOX / 2)).astype(int)
    assert np.array_equal(cell_of(gx[valid], gy[valid]), cell_of(jx[valid], jy[valid]))
    assert (np.diff(cell_of(gx[valid], gy[valid])) >= 0).all()
    got = np.stack([gx[valid], gy[valid], gh[valid], *gv[:, valid]])
    ref = np.stack([jx[valid], jy[valid], jh[valid], *jv[:, valid]])
    assert np.array_equal(got[:, np.lexsort(got)], ref[:, np.lexsort(ref)])
    inp = np.stack([x, y, h, *vals])
    assert np.array_equal(got[:, np.lexsort(got)], inp[:, np.lexsort(inp)])


def test_shear_coarse_group_donate_and_limits():
    """donate=True gives the same grouping and leaves the caller's tensors
    intact; more than 5 fields is refused."""
    rng = np.random.default_rng(23)
    n = 5000  # not a multiple of 2048
    x, y, h, vals = coarse_inputs(rng, n, n_fields=3)
    spec = MapSpec((64, 64), (0.0, BOX, 0.0, BOX))
    ref = P.shear_coarse_group(x, y, h, vals, spec, device="cpu")
    tx, ty, th, tv = (torch.tensor(a) for a in (x, y, h, vals))
    got = P.shear_coarse_group(tx, ty, th, tv, spec, donate=True, device="cpu")
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    for a, b in zip((tx, ty, th, tv), (x, y, h, vals)):
        assert np.array_equal(a.numpy(), b)
    assert int((ref[3][0] != 0).sum()) == n
    with pytest.raises(ValueError, match="at most 5 fields"):
        P.shear_coarse_group(x, y, h, np.ones((6, n), np.float32), spec, device="cpu")


def bucketed_particles(rng, n, order):
    px = BOX / 64
    x = rng.uniform(0, BOX, n).astype(np.float32)
    y = rng.uniform(0, BOX, n).astype(np.float32)
    if order == "sorted_x":
        o = np.argsort(x)
        x, y = x[o], y[o]
    h = (10.0 ** rng.uniform(-0.4, 1.0, n) * px).astype(np.float32)
    return x, y, h


@pytest.mark.parametrize("order", ["random", "sorted_x"])
def test_deposit_2d_bucketed_matches_oracle_and_sorted_engine(order):
    rng = np.random.default_rng(29 if order == "random" else 31)
    spec = MapSpec(shape=(64, 64), extent=(0.0, BOX, 0.0, BOX), periodic_wrap=True)
    n = 5000
    x, y, h = bucketed_particles(rng, n, order)
    m = rng.uniform(0.5, 2.0, n).astype(np.float32)
    img = P.deposit_2d_bucketed(x, y, h, m, spec, precision="f32", device="cpu")
    assert tuple(img.shape) == (64, 64)
    exp = project_oracle(x, y, h, m, spec.shape, spec.extent, periodic=True)
    assert rel_err(img, exp) <= TOL
    assert rel_err(img, deposit_2d_auto(x, y, h, m, spec, device="cpu")) <= TOL


def test_deposit_2d_bucketed_multifield():
    rng = np.random.default_rng(37)
    spec = MapSpec(shape=(64, 64), extent=(0.0, BOX, 0.0, BOX), periodic_wrap=True)
    n = 4000
    x, y, h = bucketed_particles(rng, n, "random")
    vals = rng.uniform(0.5, 2.0, (2, n)).astype(np.float32)
    img = P.deposit_2d_bucketed(x, y, h, vals, spec, precision="f32", device="cpu")
    assert tuple(img.shape) == (2, 64, 64)
    ref = deposit_2d_auto(x, y, h, vals, spec, device="cpu")
    for f in range(2):
        exp = project_oracle(x, y, h, vals[f], spec.shape, spec.extent, periodic=True)
        assert rel_err(img[f], exp) <= TOL
        assert rel_err(img[f], ref[f]) <= TOL
    with pytest.raises(ValueError, match="unknown precision"):
        P.deposit_2d_bucketed(x, y, h, vals, spec, precision="fp32", device="cpu")


@pytest.mark.slow
@pytest.mark.parametrize("order", ["random", "sorted_x"])
def test_deposit_2d_bucketed_matches_jax_interpret(order):
    """The whole JAX random-order render (coherent kernels in interpret
    mode) against the port's."""
    rng = np.random.default_rng(41)
    n = 3000
    x, y, h = bucketed_particles(rng, n, order)
    m = rng.uniform(0.5, 2.0, n).astype(np.float32)
    ext = (0.0, BOX, 0.0, BOX)
    got = P.deposit_2d_bucketed(x, y, h, m, MapSpec((64, 64), ext, periodic_wrap=True), device="cpu")
    ref = np.asarray(J.deposit_2d_bucketed(x, y, h, m, JMapSpec((64, 64), ext, periodic_wrap=True),
                                           precision="f32", interpret=True))
    assert rel_err(got, ref) <= 2 * TOL  # two f32 engines, each within the budget of the oracle


def test_jax_shear_layout_rendered_by_port():
    """A JAX tile_particles(layout="shear") layout, pads and all, carried
    into the port: rendered by the port's deposit_tiled and re-rendered
    through its perm, each against the f64 oracle."""
    rng = np.random.default_rng(43)
    npix = 64
    px = BOX / npix
    n = 3000
    x = rng.uniform(0, BOX, n).astype(np.float32)
    y = rng.uniform(0, BOX, n).astype(np.float32)
    h = (10.0 ** rng.uniform(-0.3, 1.2, n) * px).astype(np.float32)
    m = rng.uniform(0.5, 2.0, n).astype(np.float32)
    ext = (0.0, BOX, 0.0, BOX)
    jtp = j_tile_particles(*(jnp.asarray(a) for a in (x, y, h, m)), JMapSpec((npix, npix), ext), layout="shear")
    assert jtp.n_oversize > 0 and jtp.n_sorted > n
    tp = tiled_particles_from_arrays(
        MapSpec((npix, npix), ext), "cubic_spline", [(g.cfg.K, g.cfg.TY, lo, c) for g, lo, _, c in jtp.geoms],
        *(np.asarray(a) for a in (jtp.sorted_u, jtp.sorted_v, jtp.sorted_h, jtp.sorted_values,
                                  jtp.sorted_tile, jtp.perm)),
        jtp.n_sorted, jtp.n_oversize, jtp.n_valid, device="cpu",
    )
    got = deposit_tiled(tp, precision="f32")[0]
    assert rel_err(got, project_oracle(x, y, h, m, (npix, npix), ext)) <= TOL
    m2 = rng.uniform(1.0, 3.0, n).astype(np.float32)
    got2 = deposit_tiled(tp.with_values(m2))[0]
    assert rel_err(got2, project_oracle(x, y, h, m2, (npix, npix), ext)) <= TOL


def test_shear_layout_counts_match_jax():
    """tile_particles(layout="shear"): per-level counts (pads included) and
    the oversize count equal the JAX shear layout's at an input size that
    the JAX package does not pad (2 * 2048 particles)."""
    rng = np.random.default_rng(47)
    npix = 64
    n = 4096
    x, y = (rng.uniform(0, BOX, n).astype(np.float32) for _ in range(2))
    h = (10.0 ** rng.uniform(-0.3, 1.2, n) * BOX / npix).astype(np.float32)
    m = rng.uniform(0.5, 2.0, n).astype(np.float32)
    ext = (0.0, BOX, 0.0, BOX)
    jtp = j_tile_particles(*(jnp.asarray(a) for a in (x, y, h, m)), JMapSpec((npix, npix), ext), layout="shear")
    tp = tile_particles(x, y, h, m, MapSpec((npix, npix), ext), layout="shear", device="cpu")
    assert jtp.n_sorted - jtp.n_valid > 0 and jtp.n_valid == n
    assert [(g.cfg.K, lo, c) for g, lo, c in tp.geoms] == [(g.cfg.K, lo, c) for g, lo, _, c in jtp.geoms]
    assert (tp.n_sorted, tp.n_oversize) == (jtp.n_sorted, jtp.n_oversize)
    assert np.array_equal(tp.sorted_tile.numpy(), np.asarray(jtp.sorted_tile)[: tp.n_sorted])


def test_append_wrapper_takes_plain_version_only_on_cpu():
    rng = np.random.default_rng(53)
    key, nk = stage_a_keys(rng, "skewed")
    u = rng.uniform(0, 1, key.shape[0]).astype(np.float32)
    gangs, src_gang, _, ngang, cum_ngang, _, cum_nsub, _, ng, ns = P._shear_stage_a([t(key), t(u)], n_keys=nk)
    sched = P._shear_schedule(src_gang, ngang, cum_ngang, cum_nsub, int(ns))
    before = P.append_gangs.launches
    assert torch.equal(P.append_gangs(gangs, sched, int(ng)), P.append_gangs_plain(gangs, sched, int(ng)))
    assert P.append_gangs.launches == before  # no kernel launched on the CPU
    with pytest.raises(ValueError, match="no gang append kernel"):
        P.append_gangs(gangs.to("meta"), sched.to("meta"), int(ng))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA gang append kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["skewed", "single", "one_record_runs"])
def test_cuda_append_matches_plain(cuda_device, case):
    """The CUDA kernel against its plain version on the card, bit for bit."""
    rng = np.random.default_rng(59)
    key, nk = stage_a_keys(rng, case)
    pays = [t(rng.uniform(0, 1, key.shape[0]).astype(np.float32)).to(cuda_device) for _ in range(4)]
    gangs, src_gang, _, ngang, cum_ngang, _, cum_nsub, _, ng, ns = P._shear_stage_a(
        [t(key).to(cuda_device), *pays], n_keys=nk
    )
    sched = P._shear_schedule(src_gang, ngang, cum_ngang, cum_nsub, int(ns))
    got = P.append_gangs(gangs, sched, int(ng))
    ref = P.append_gangs_plain(gangs, sched, int(ng))
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_cuda_bucketed_moves_launch_counter(cuda_device):
    rng = np.random.default_rng(61)
    spec = MapSpec(shape=(128, 128), extent=(0.0, BOX, 0.0, BOX), periodic_wrap=True)
    x, y, h = bucketed_particles(rng, 20000, "random")
    m = rng.uniform(0.5, 2.0, 20000).astype(np.float32)
    before = P.append_gangs.launches
    got = P.deposit_2d_bucketed(x, y, h, m, spec, device=cuda_device)
    torch.cuda.synchronize()
    assert P.append_gangs.launches - before == 1
    ref = deposit_2d_auto(x, y, h, m, spec, device=cuda_device)
    assert rel_err(got.cpu(), ref.cpu()) <= TOL
