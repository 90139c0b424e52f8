"""Port vs JAX: the sorted tile engine and its deposit kernel.

The JAX package's engine runs its Pallas kernel in interpret mode on the CPU
(as ``tests/test_render.py`` does); the port runs the kernel's plain torch
version, which is what its wrapper takes for a CPU tensor. Inputs are NumPy
arrays made from a seed and handed to both. Bounds:

- kernel vs kernel on identical sorted inputs, and the JAX layout rendered
  by both engines: max |port - jax| <= 1e-5 * max |jax|;
- whole engine against the f64 oracle (``oracles.project_oracle``):
  1e-5 * max, the fidelity budget; against JAX the same for host-f64 inputs
  and twice it for f32 inputs, which both engines convert to f32 pixel
  coordinates with different rounding (XLA on the CPU does not round f32
  division and sqrt as IEEE does; see ``test_torch_deposit.py``).

The CUDA tests need a card and skip here. The card's machine has no JAX:
there they run alone, ``python -m pytest --noconftest -m cuda
tests/test_torch_deposit_tiled.py``.
"""

import importlib
from collections import Counter

import numpy as np
import pytest
import torch

from astro_sph_tools_tpu_torch.ops import MapSpec
from astro_sph_tools_tpu_torch.ops._device import PRECISIONS_2D, tile_ranges
from oracles import project_oracle

try:
    import jax.numpy as jnp

    from astro_sph_tools_tpu.ops import deposit_pallas as J
    from astro_sph_tools_tpu.ops.deposit import MapSpec as JMapSpec
except ImportError:  # only the CUDA tests, which need no JAX, can run
    jnp = J = JMapSpec = None

T = importlib.import_module("astro_sph_tools_tpu_torch.ops.deposit_tiled")

BOX = 10.0
TOL = 1e-5


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def level_inputs(rng, li, n, n_fields, spec):
    """Tile-sorted tile-local inputs of level ``li`` with h inside it."""
    cfg = T.PALLAS_LEVELS[li]
    lo = 0.05 if li == 0 else T.PALLAS_LEVELS[li - 1].max_s_pix
    px = BOX / spec.shape[1]
    x = rng.uniform(0, BOX, n)
    y = rng.uniform(0, BOX, n)
    h = rng.uniform(lo, cfg.max_s_pix, n) * px / 2.0
    vals = rng.uniform(0.5, 2.0, (n_fields, n))
    geom = T._level_geometry(cfg, spec)
    tile, u, v = T._tile_local_coords(torch.from_numpy(x), torch.from_numpy(y), geom, spec)
    order = torch.argsort(tile, stable=True)
    h32 = torch.as_tensor(h, dtype=torch.float32)[order]
    vals32 = torch.as_tensor(vals, dtype=torch.float32)[:, order].contiguous()
    return geom, tile[order], u[order], v[order], h32, vals32


# (K level index, F, projection): every level in both projections, and
# every field count in both projections at K = 8
KERNEL_CASES = [
    (0, 1, "kernel3d"), (0, 2, "kernel3d"), (0, 5, "kernel3d"),
    (0, 1, "integrated"), (0, 2, "integrated"), (0, 5, "integrated"),
    (1, 2, "kernel3d"), (1, 1, "integrated"),
    (2, 5, "kernel3d"), (2, 2, "integrated"),
    (3, 1, "kernel3d"), (3, 5, "integrated"),
]


@pytest.mark.parametrize("li,n_fields,projection", KERNEL_CASES)
def test_plain_kernel_matches_pallas_kernel(li, n_fields, projection):
    """(a) deposit_tiles_plain vs the JAX Pallas kernel, identical inputs."""
    rng = np.random.default_rng(10 * li + n_fields)
    spec = MapSpec(shape=(64, 64), extent=(0.0, BOX, 0.0, BOX))
    n = J._CHUNK  # the Pallas kernel takes whole 2048-particle chunk rows
    geom, tile, u, v, h, vals = level_inputs(rng, li, n, n_fields, spec)
    px = BOX / 64
    pstart, pcount = tile_ranges(tile, geom.n_tiles)
    got = T.deposit_tiles(
        u, v, h, vals, pstart, pcount, cfg=geom.cfg, kernel="cubic_spline",
        projection=projection, psx=px, psy=px, offset=0.5,
    )

    C = J._CHUNK
    n_rows = n // C
    jps, jpc, block_start, nchunks = J._tile_ranges(jnp.asarray(tile.numpy()), geom.n_tiles, C)
    n_steps = n_rows + 2 * geom.n_tiles
    sched, tile_off = J._step_schedule(nchunks, geom.n_tiles, n_steps)
    ops = [jnp.asarray(a.numpy()) for a in (u, v, h)] + [jnp.asarray(vals[f].numpy()) for f in range(n_fields)]
    packed = J._pack_channels(ops, n_fields, n_rows, C)
    call = J._cached_deposit_call(
        J.PALLAS_LEVELS[li], geom.n_tiles_x, geom.n_tiles_y, n_steps, n_rows, n_fields,
        geom.tx, "cubic_spline", 2.0, px, px, 0.5, "f32", True, projection,
    )
    ref = np.asarray(call(sched, block_start, tile_off, jps, jpc, packed))
    assert tuple(got.shape) == ref.shape == (geom.n_tiles, n_fields * geom.cfg.R, 128)
    assert np.array_equal(pstart.numpy(), np.asarray(jps))
    assert np.array_equal(pcount.numpy(), np.asarray(jpc))
    assert rel_err(got, ref) <= TOL


def mixed_particles(rng, n, npix, h_hi=1.35):
    px = BOX / npix
    x = rng.uniform(0, BOX, n)
    y = rng.uniform(0, BOX, n)
    x[:60] = rng.uniform(0, 0.1, 60)  # edge hugging
    h = 10.0 ** rng.uniform(-0.3, h_hi, n) * px  # K = 8..64 and oversize
    m = rng.uniform(0.5, 2.0, n)
    return x, y, h, m


def test_jax_layout_rendered_by_port():
    """(b) the JAX layout, carried over, renders as JAX renders it."""
    rng = np.random.default_rng(21)
    npix = 64
    x, y, h, m = mixed_particles(rng, 2500, npix)
    t = rng.uniform(1e4, 1e6, 2500)
    fields = np.stack([m, m * t])
    jspec = JMapSpec(shape=(npix, npix), extent=(0.0, BOX, 0.0, BOX))
    jtp = J.tile_particles(x, y, h, fields, jspec)
    assert jtp.n_oversize > 0 and len(jtp.geoms) == 4
    ref = np.asarray(J.deposit_tiled(jtp, precision="f32"))

    tp = T.tiled_particles_from_arrays(
        MapSpec(shape=(npix, npix), extent=(0.0, BOX, 0.0, BOX)), "cubic_spline",
        [(g.cfg.K, g.cfg.TY, lo, c) for g, lo, _, c in jtp.geoms],
        *(np.asarray(a) for a in (jtp.sorted_u, jtp.sorted_v, jtp.sorted_h,
                                  jtp.sorted_values, jtp.sorted_tile, jtp.perm)),
        jtp.n_sorted, jtp.n_oversize, jtp.n_valid, device="cpu",
    )
    assert tp.sorted_u.shape[0] == jtp.n_sorted  # slack trimmed
    got = T.deposit_tiled(tp, precision="f32")
    assert rel_err(got, ref) <= TOL
    # new fields through the carried-over perm, no re-sort
    m2 = rng.uniform(1.0, 3.0, 2500)
    got2 = T.deposit_tiled(tp.with_values(m2))[0]
    ref2 = project_oracle(x, y, h, m2, (npix, npix), (0.0, BOX, 0.0, BOX))
    assert rel_err(got2, ref2) <= TOL


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("periodic", [False, True])
def test_deposit_2d_auto_matches_jax_and_oracle(dtype, periodic):
    """(c) the whole engine, f32 device path and host-f64 quality path."""
    rng = np.random.default_rng(31 + periodic)
    npix = 64
    x, y, h, m = mixed_particles(rng, 1500, npix, h_hi=1.2)
    cast = (lambda a: a.astype(np.float32)) if dtype == "f32" else (lambda a: a)
    args = [cast(a) for a in (x, y, h, m)]
    ext = (0.0, BOX, 0.0, BOX)
    got = T.deposit_2d_auto(*args, MapSpec((npix, npix), ext, periodic_wrap=periodic), device="cpu")
    ref = np.asarray(J.deposit_2d_auto(*args, JMapSpec((npix, npix), ext, periodic_wrap=periodic), precision="f32"))
    assert tuple(got.shape) == (npix, npix)
    # f64 inputs: both engines assign in f64 on the host and agree to ~1e-7;
    # f32 inputs: each engine's f32 pixel conversion (XLA's rounding is not
    # IEEE's) puts it within the budget of the oracle, so the two may differ
    # by up to twice the budget
    assert rel_err(got, ref) <= (TOL if dtype == "f64" else 2 * TOL)
    oracle = project_oracle(*(a.astype(np.float64) for a in args), (npix, npix), ext, periodic=periodic)
    assert rel_err(got, oracle) <= TOL


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_level_counts_match_jax(dtype):
    """(d) the same particles per level and the same oversize count."""
    rng = np.random.default_rng(41)
    npix = 64
    x, y, h, m = mixed_particles(rng, 3000, npix)
    cast = (lambda a: a.astype(np.float32)) if dtype == "f32" else (lambda a: a)
    x, y, h = cast(x), cast(y), cast(h)
    ext = (0.0, BOX, 0.0, BOX)
    jtp = J.tile_particles(x, y, h, m, JMapSpec((npix, npix), ext))
    tp = T.tile_particles(x, y, h, m, MapSpec((npix, npix), ext), device="cpu")
    # the JAX layout pads to a size class with zero-weight particles that
    # land in the smallest level; the port keeps exactly the real particles
    pads = jtp.n_sorted - jtp.n_valid
    jcounts = {g.cfg.K: c for g, _, _, c in jtp.geoms}
    jcounts[8] -= pads
    assert {g.cfg.K: c for g, _, c in tp.geoms} == jcounts
    assert tp.n_oversize == jtp.n_oversize > 0
    assert tp.n_sorted == tp.n_valid == 3000
    # every level segment is tile-sorted and holds its own level's tiles
    for geom, lo, c in tp.geoms:
        seg = tp.sorted_tile[lo:lo + c]
        assert bool((seg[1:] >= seg[:-1]).all()) and int(seg.max()) < geom.n_tiles


def test_single_level_pallas_entry_matches_jax():
    rng = np.random.default_rng(51)
    npix = 64
    px = BOX / npix
    x, y = rng.uniform(0, BOX, 1000), rng.uniform(0, BOX, 1000)
    h = rng.uniform(1.6, 3.4, 1000) * px
    fields = rng.uniform(0.5, 2.0, (2, 1000))
    ext = (0.0, BOX, 0.0, BOX)
    got = T.deposit_2d_pallas(x, y, h, fields, MapSpec((npix, npix), ext), level=T.PALLAS_LEVELS[1], device="cpu")
    ref = np.asarray(J.deposit_2d_pallas(
        x, y, h, fields, JMapSpec((npix, npix), ext), level=J.PALLAS_LEVELS[1], precision="f32"
    ))
    assert rel_err(got, ref) <= TOL


def test_unknown_precision_and_unported_options_raise():
    """(e) unknown precision strings fail loudly; unported options say so."""
    spec = MapSpec(shape=(64, 64), extent=(0.0, 1.0, 0.0, 1.0))
    x = np.array([0.5])
    h = np.array([0.05])
    m = np.array([1.0])
    with pytest.raises(ValueError, match="unknown precision"):
        T.deposit_2d_pallas(x, x, h, m, spec, precision="fp32", device="cpu")
    with pytest.raises(ValueError, match="unknown precision"):
        T.deposit_2d_auto(x, x, h, m, spec, precision="bf16x22", device="cpu")
    tp = T.tile_particles(x, x, h, m, spec, device="cpu")
    with pytest.raises(ValueError, match="unknown precision"):
        T.deposit_tiled(tp, precision="f64")
    for p in PRECISIONS_2D:  # every accepted string renders the same f32 sums
        assert torch.equal(T.deposit_tiled(tp, precision=p), T.deposit_tiled(tp))
    with pytest.raises(ValueError, match="unknown layout"):
        T.tile_particles(x, x, h, m, spec, layout="shaer", device="cpu")
    tp_lean = T.tile_particles(x, x, h, m, spec, need_perm=False, device="cpu")
    with pytest.raises(ValueError, match="need_perm"):
        tp_lean.with_values(m)


@pytest.mark.parametrize("periodic", [False, True])
def test_shear_layout_renders_as_sort_layout(periodic):
    """tile_particles(layout="shear") renders the same map as the sort
    layout and the f64 oracle (multi-level footprints, oversize, pad slots),
    and re-renders new fields through its perm; host-f64 input keeps the
    sort."""
    rng = np.random.default_rng(91 + periodic)
    npix = 64
    x, y, h, m = (a.astype(np.float32) for a in mixed_particles(rng, 3000, npix, h_hi=1.2))
    spec = MapSpec((npix, npix), (0.0, BOX, 0.0, BOX), periodic_wrap=periodic)
    tp = T.tile_particles(x, y, h, m, spec, layout="shear", device="cpu")
    tp_sort = T.tile_particles(x, y, h, m, spec, layout="sort", device="cpu")
    assert tp.n_sorted > tp.n_valid == tp_sort.n_sorted == 3000  # pad slots
    assert tp.n_oversize >= tp_sort.n_oversize > 0
    got = T.deposit_tiled(tp)[0]
    assert rel_err(got, T.deposit_tiled(tp_sort)[0]) <= TOL
    ext = (0.0, BOX, 0.0, BOX)
    assert rel_err(got, project_oracle(x, y, h, m, (npix, npix), ext, periodic=periodic)) <= TOL
    m2 = rng.uniform(1.0, 3.0, 3000)
    got2 = T.deposit_tiled(tp.with_values(m2))[0]
    assert rel_err(got2, project_oracle(x, y, h, m2, (npix, npix), ext, periodic=periodic)) <= TOL
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    assert T.tile_particles(x64, y64, h, m, spec, layout="shear", device="cpu").n_sorted == 3000


def test_wrapper_takes_plain_version_only_on_cpu():
    rng = np.random.default_rng(61)
    spec = MapSpec(shape=(64, 64), extent=(0.0, BOX, 0.0, BOX))
    geom, tile, u, v, h, vals = level_inputs(rng, 0, 300, 2, spec)
    pstart, pcount = tile_ranges(tile, geom.n_tiles)
    kw = dict(cfg=geom.cfg, kernel="cubic_spline", projection="kernel3d", psx=BOX / 64, psy=BOX / 64, offset=0.5)
    before = T.deposit_tiles.launches
    assert torch.equal(T.deposit_tiles(u, v, h, vals, pstart, pcount, **kw),
                       T.deposit_tiles_plain(u, v, h, vals, pstart, pcount, **kw))
    assert T.deposit_tiles.launches == before  # no kernel launched on the CPU
    meta = [a.to("meta") for a in (u, v, h, vals, pstart, pcount)]
    with pytest.raises(ValueError, match="no deposit kernel"):
        T.deposit_tiles(*meta, **kw)
    # zero-h pads deposit exactly 0, not NaN
    h0 = torch.zeros_like(h)
    out = T.deposit_tiles(u, v, h0, vals, pstart, pcount, **kw)
    assert bool((out == 0).all())


# ---------------------------------------------------------------------------
# The CUDA kernel's split of a tile over a cluster of blocks, mirrored in torch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("group", [8, 1])
@pytest.mark.parametrize("C", [1, 2, 8])
def test_cluster_split_covers_each_item_once(C, group):
    """cluster_rank and cluster_share_sizes (mirrored by
    csrc/deposit_common.cuh::cluster_groups and the kernels' share counts):
    every item of a tile in exactly one rank's share, rank r taking groups
    r, r + C, ... of ``group`` items, shares within one group of even;
    empty and one-item tiles included."""
    rng = np.random.default_rng(90 + C + group)
    count = torch.as_tensor(np.concatenate([[0, 1, 0, 2, 7, 8, 9, 63, 64, 65, 1000], rng.integers(0, 300, 40)]))
    sizes = T.cluster_share_sizes(count, C, group)
    assert sizes.shape == (count.shape[0], C)
    for t, n in enumerate(count.tolist()):
        ranks = T.cluster_rank(torch.arange(n), C, group).tolist()
        for r in range(C):
            # brute force: the groups r, r + C, ... and their items
            mine = [o for g in range(r, -(-n // group), C) for o in range(g * group, min(n, (g + 1) * group))]
            assert mine == [o for o in range(n) if ranks[o] == r]
            assert int(sizes[t, r]) == len(mine)
        assert int(sizes[t].sum()) == n
        assert int(sizes[t].max() - sizes[t].min()) <= group


@pytest.mark.parametrize("C", range(1, 9))
@pytest.mark.parametrize("li", [2, 3])
def test_register_pixels_cover_each_pixel_once(li, C):
    """register_pixels, register_walks and register_warps (mirrored by
    csrc/deposit2d.cu::deposit2d_register's row pairs, warps, lanes and
    walks, and deposit2d_launch's block size): at a K >= 32 level every
    pixel of the R x 128 accumulator, so every pixel of the R x (tx + K)
    region at the periodic 1024^2 map's and the open map's tile width, is
    owned by exactly one thread of the tile's C blocks, and each thread's
    pixels fall in the walks counted, the last walk used; also at an odd
    row count."""
    cfg = T.PALLAS_LEVELS[li]
    for R in (cfg.R, cfg.R + 1):
        owned = Counter()
        walks, warps = T.register_walks(R, C), T.register_warps(R, C)
        assert warps <= 12 and (walks - 1) * warps * C < (R + 1) // 2 <= walks * warps * C
        used = set()
        for rank in range(C):
            for warp in range(warps):
                for lane in range(32):
                    for walk, r, c in T.register_pixels(R, C, rank, warp, lane):
                        assert 0 <= walk < walks
                        used.add(walk)
                        owned[r, c] += 1
        assert set(owned.values()) == {1}
        assert set(owned) == {(r, c) for r in range(R) for c in range(cfg.S)}
        for tx in (T._choose_tx(cfg, 1024, True), cfg.default_tx):
            assert all(owned[r, c] == 1 for r in range(R) for c in range(tx + cfg.K))
        assert max(used) == walks - 1
    # the box maps' levels at two blocks a tile: 12 warps, one walk at K = 32, two at K = 64
    assert (T.register_warps(cfg.R, 2), T.register_walks(cfg.R, 2)) == (12, 1 if cfg.K == 32 else 2)


def dense_level_inputs(rng, li, n, n_fields, spec, n_tiles_used=3):
    """Tile-sorted tile-local inputs of level ``li``: ``n`` particles in
    Morton order clustered on a few tiles, tens a pixel, h inside the level."""
    cfg = T.PALLAS_LEVELS[li]
    geom = T._level_geometry(cfg, spec)
    px = BOX / spec.shape[1]
    w, hgt = min(geom.tx, spec.shape[1]) * px, n_tiles_used * cfg.TY * px  # a column of tiles
    x = np.clip(w * (0.5 + rng.normal(0, 0.2, n)), 0, w * (1 - 1e-6))
    y = np.clip(hgt * (0.5 + rng.normal(0, 0.2, n)), 0, hgt * (1 - 1e-6))
    ix, iy = (x / w * 1024).astype(np.int64), (y / hgt * 1024).astype(np.int64)
    key = np.zeros(n, np.int64)
    for b in range(10):
        key |= ((ix >> b) & 1) << (2 * b) | ((iy >> b) & 1) << (2 * b + 1)
    order = np.argsort(key, kind="stable")
    x, y = x[order], y[order]
    lo = 0.05 if li == 0 else T.PALLAS_LEVELS[li - 1].max_s_pix
    h = rng.uniform(lo, cfg.max_s_pix, n) * px / 2.0
    vals = rng.uniform(0.5, 2.0, (n_fields, n))
    tile, u, v = T._tile_local_coords(torch.from_numpy(x), torch.from_numpy(y), geom, spec)
    order = torch.argsort(tile, stable=True)
    h32 = torch.as_tensor(h, dtype=torch.float32)[order]
    vals32 = torch.as_tensor(vals, dtype=torch.float32)[:, order].contiguous()
    return geom, tile[order], u[order], v[order], h32, vals32


def split_deposit_emulated(u, v, h, vals, pstart, pcount, C, **kw):
    """Torch emulation of the kernel's cluster split: rank r's share of every
    tile (its groups of 8 particles, ``cluster_rank``) through the plain
    version, the C partial accumulators summed in rank order, as
    csrc/deposit_common.cuh::cluster_reduce_store sums them."""
    n_tiles = pstart.shape[0]
    counts = pcount.to(torch.int64)
    tile_of = torch.repeat_interleave(torch.arange(n_tiles), counts)
    offset = torch.arange(int(counts.sum())) - torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    index = torch.repeat_interleave(pstart.to(torch.int64), counts) + offset
    rank = T.cluster_rank(offset, C)
    total = None
    for r in range(C):
        sel = index[rank == r]  # tile-sorted: the tile order is kept
        ps, pc = tile_ranges(tile_of[rank == r], n_tiles)
        part = T.deposit_tiles_plain(u[sel], v[sel], h[sel], vals[:, sel], ps, pc, **kw)
        total = part if total is None else total + part
    return total


@pytest.mark.parametrize("li,C", [(0, 2), (0, 8), (1, 8)])
def test_split_sum_matches_plain_and_pallas_kernel(li, C):
    """The split sum on dense clustered tiles equals the unsplit plain
    version and the JAX Pallas kernel (interpret mode) on the same inputs."""
    rng = np.random.default_rng(95 + li + C)
    spec = MapSpec(shape=(64, 64), extent=(0.0, BOX, 0.0, BOX))
    n, n_fields = J._CHUNK, 2  # the Pallas kernel takes whole 2048-particle chunk rows
    geom, tile, u, v, h, vals = dense_level_inputs(rng, li, n, n_fields, spec)
    px = BOX / 64
    pstart, pcount = tile_ranges(tile, geom.n_tiles)
    assert int((pcount > 0).sum()) >= 2 and int(pcount.max()) > 8 * C  # dense tiles, every rank busy
    kw = dict(cfg=geom.cfg, kernel="cubic_spline", projection="kernel3d", psx=px, psy=px, offset=0.5)
    got = split_deposit_emulated(u, v, h, vals, pstart, pcount, C, **kw)
    plain = T.deposit_tiles_plain(u, v, h, vals, pstart, pcount, **kw)
    assert rel_err(got, plain) <= TOL

    jps, jpc, block_start, nchunks = J._tile_ranges(jnp.asarray(tile.numpy()), geom.n_tiles, n)
    n_steps = 1 + 2 * geom.n_tiles
    sched, tile_off = J._step_schedule(nchunks, geom.n_tiles, n_steps)
    ops = [jnp.asarray(a.numpy()) for a in (u, v, h)] + [jnp.asarray(vals[f].numpy()) for f in range(n_fields)]
    packed = J._pack_channels(ops, n_fields, 1, n)
    call = J._cached_deposit_call(
        J.PALLAS_LEVELS[li], geom.n_tiles_x, geom.n_tiles_y, n_steps, 1, n_fields,
        geom.tx, "cubic_spline", 2.0, px, px, 0.5, "f32", True, "kernel3d",
    )
    ref = np.asarray(call(sched, block_start, tile_off, jps, jpc, packed))
    assert rel_err(got, ref) <= TOL


def test_cluster_argument_is_checked(monkeypatch):
    """The cluster size is one constant of the geometry, shared by both 2D
    deposit kernels, and not a caller's argument; on the CPU any size gives
    the plain version's sums."""
    rng = np.random.default_rng(97)
    spec = MapSpec(shape=(64, 64), extent=(0.0, BOX, 0.0, BOX))
    geom, tile, u, v, h, vals = level_inputs(rng, 0, 300, 1, spec)
    pstart, pcount = tile_ranges(tile, geom.n_tiles)
    kw = dict(cfg=geom.cfg, kernel="cubic_spline", projection="kernel3d", psx=BOX / 64, psy=BOX / 64, offset=0.5)
    with pytest.raises(TypeError, match="cluster"):
        T.deposit_tiles(u, v, h, vals, pstart, pcount, cluster=8, **kw)
    TC = importlib.import_module("astro_sph_tools_tpu_torch.ops.deposit_coherent")
    assert T._CLUSTER == TC._CLUSTER == 2
    monkeypatch.setattr(T, "_CLUSTER", 8)
    assert torch.equal(T.deposit_tiles(u, v, h, vals, pstart, pcount, **kw),
                       T.deposit_tiles_plain(u, v, h, vals, pstart, pcount, **kw))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA deposit kernel has no CPU mode")
    return torch.device("cuda")


# the register path's cases on the card: fields, and blocks a tile
WIDE_FIELDS = (2, 3, 5)
WIDE_CLUSTERS = (1, 2, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("projection", ["kernel3d", "integrated"])
def test_cuda_kernel_matches_plain(cuda_device, monkeypatch, projection):
    """(f) the CUDA kernel against its plain version on the card, every
    level, supports drawn across each level's range; the K >= 32 levels
    (the register path) at F = 2, 3, 5 and C = 1, 2, 8."""
    rng = np.random.default_rng(71)
    spec = MapSpec(shape=(256, 256), extent=(0.0, BOX, 0.0, BOX), periodic_wrap=True)
    for li, cfg in enumerate(T.PALLAS_LEVELS):
        wide = cfg.K >= T.REGISTER_MIN_K
        for n_fields in WIDE_FIELDS if wide else (5,):
            geom, tile, u, v, h, vals = level_inputs(rng, li, 20000, n_fields, spec)
            args = [a.to(cuda_device) for a in (u, v, h, vals)]
            pstart, pcount = tile_ranges(tile.to(cuda_device), geom.n_tiles)
            kw = dict(cfg=geom.cfg, kernel="cubic_spline", projection=projection,
                      psx=BOX / 256, psy=BOX / 256, offset=0.5)
            ref = T.deposit_tiles_plain(*args, pstart, pcount, **kw)
            for C in WIDE_CLUSTERS if wide else (T._CLUSTER,):
                monkeypatch.setattr(T, "_CLUSTER", C)
                got = T.deposit_tiles(*args, pstart, pcount, **kw)
                torch.cuda.synchronize()
                assert rel_err(got.cpu(), ref.cpu()) <= TOL, (cfg.K, n_fields, C)


@pytest.mark.cuda
def test_cuda_call_moves_launch_counter(cuda_device):
    rng = np.random.default_rng(81)
    x, y, h, m = mixed_particles(rng, 5000, 128, h_hi=1.0)
    spec = MapSpec(shape=(128, 128), extent=(0.0, BOX, 0.0, BOX))
    before = T.deposit_tiles.launches
    register_before = T.deposit_tiles.register_launches
    got = T.deposit_2d_auto(x, y, h, m, spec, device=cuda_device)
    torch.cuda.synchronize()
    tp = T.tile_particles(x, y, h, m, spec, device=cuda_device)
    assert T.deposit_tiles.launches - before == len(tp.geoms) > 0
    wide = sum(g.cfg.K >= T.REGISTER_MIN_K for g, _, _ in tp.geoms)
    assert T.deposit_tiles.register_launches - register_before == wide > 0
    ref = T.deposit_2d_auto(x, y, h, m, spec, device=cuda_device, plain=True)
    assert rel_err(got.cpu(), ref.cpu()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 2, 8])
@pytest.mark.parametrize("li", [0, 2, 3])
def test_cuda_dense_tile_split_matches_plain(cuda_device, monkeypatch, li, C):
    """(g) a dense tile split over C blocks (and not split) on the card,
    both projections: at K = 8 the cluster's particle split at F = 5 (in
    field groups of shared memory) against the plain version; at K >= 32
    the register path's row split at F = 2, 3 and 5 against the f64 sum of
    the plain version's terms (``chip_smoke.plain_f64_sum``: a pixel sums
    thousands of terms there, and the plain version's own f32 sum, with
    atomics, strays near 1e-5 of the max)."""
    import chip_smoke

    monkeypatch.setattr(T, "_CLUSTER", C)
    wide = T.PALLAS_LEVELS[li].K >= T.REGISTER_MIN_K
    spec = MapSpec(shape=(256, 256), extent=(0.0, BOX, 0.0, BOX), periodic_wrap=True)
    rng = np.random.default_rng(73 + li)
    for n_fields in WIDE_FIELDS if wide else (5,):
        geom, tile, u, v, h, vals = dense_level_inputs(rng, li, 60000, n_fields, spec, n_tiles_used=2)
        args = [a.to(cuda_device) for a in (u, v, h, vals)]
        pstart, pcount = tile_ranges(tile.to(cuda_device), geom.n_tiles)
        for projection in ("kernel3d", "integrated"):
            kw = dict(cfg=geom.cfg, kernel="cubic_spline", projection=projection,
                      psx=BOX / 256, psy=BOX / 256, offset=0.5)
            before = T.deposit_tiles.launches
            got = T.deposit_tiles(*args, pstart, pcount, **kw)
            if wide:
                ref = chip_smoke.plain_f64_sum(torch, T.deposit_tiles_plain, (*args, pstart, pcount), kw)
            else:
                ref = T.deposit_tiles_plain(*args, pstart, pcount, **kw)
            torch.cuda.synchronize()
            assert T.deposit_tiles.launches == before + 1
            assert rel_err(got.cpu(), ref.cpu()) <= TOL, (n_fields, projection)


@pytest.mark.cuda
@pytest.mark.parametrize("li", [2, 3])
def test_cuda_register_path_is_repeatable(cuda_device, li):
    """A K >= 32 level sums each pixel's terms in the tile's particle order,
    with no atomics: two launches give the same bits."""
    rng = np.random.default_rng(77 + li)
    spec = MapSpec(shape=(256, 256), extent=(0.0, BOX, 0.0, BOX), periodic_wrap=True)
    geom, tile, u, v, h, vals = dense_level_inputs(rng, li, 60000, 2, spec, n_tiles_used=2)
    args = [a.to(cuda_device) for a in (u, v, h, vals)]
    pstart, pcount = tile_ranges(tile.to(cuda_device), geom.n_tiles)
    kw = dict(cfg=geom.cfg, kernel="wendland_c2", projection="kernel3d", psx=BOX / 256, psy=BOX / 256, offset=0.5)
    assert torch.equal(T.deposit_tiles(*args, pstart, pcount, **kw), T.deposit_tiles(*args, pstart, pcount, **kw))
