"""Port vs JAX: the coherent-order engine (coherent deposit kernel, layout,
synced and fused renders, capacities).

The JAX package's coherent deposit runs its Pallas kernel in interpret mode
on the CPU (``_cached_coherent_call(..., interpret=True)``) on the port's own
packed rows; the port runs the kernel's plain torch version, which is what
its wrapper takes for a CPU tensor. Layout statistics are held against the
JAX package's ``tile_particles_coherent(prep="xla")`` at 12 rows of 2048
particles (a size at which neither package pads). Whole renders, whose JAX
counterpart is in the slow lane, are held against the port's sorted engine
(itself held against JAX in ``test_torch_deposit_tiled.py``) and the f64
oracle. Inputs are NumPy arrays made from a seed. Bounds:

- kernel vs kernel on identical rows: max |port - jax| <= 1e-5 * max |jax|;
- layout statistics and capacities: equal;
- coherent vs sorted engine: 5e-6 * max (both place every particle with the
  same assignment; only the summation order differs); vs the oracle: 1e-5.

The CUDA tests need a card and skip here.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from astro_sph_tools_tpu_torch.ops import (
    CoherentCaps,
    MapSpec,
    caps_from_layout,
    caps_union,
    deposit_2d_auto,
    deposit_2d_coherent,
    deposit_2d_coherent_fused,
    tile_particles_coherent,
)
from astro_sph_tools_tpu_torch.ops.coherent_prep import _stage_a_prep, prep_rows
from astro_sph_tools_tpu_torch.ops.deposit_tiled import deposit_tiles
from oracles import project_oracle
from test_torch_coherent_prep import as_torch, prep_inputs

# both packages export a function named like the module: import the modules
JC = importlib.import_module("astro_sph_tools_tpu.ops.deposit_coherent")
TC = importlib.import_module("astro_sph_tools_tpu_torch.ops.deposit_coherent")
T = importlib.import_module("astro_sph_tools_tpu_torch.ops.deposit_tiled")

TOL = 1e-5
ENGINE_TOL = 5e-6


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def coherent_set(rng, n, box, px, h_sigma=0.6, h_clip=12.0):
    """Cell-ordered (snapshot-like) clustered particles with density-
    correlated smoothing lengths (as ``tests/test_deposit_coherent.py``
    draws them)."""
    cx = rng.uniform(0, box, n)
    cy = rng.uniform(0, box, n)
    cell = np.floor(cy / (box / 32)).astype(int) * 32 + np.floor(cx / (box / 32)).astype(int)
    order = np.argsort(cell, kind="stable")
    x, y = cx[order].astype(np.float32), cy[order].astype(np.float32)
    dens = rng.uniform(0.3, 3.0, 1024)[cell[order]]
    h = np.clip(
        0.6 * px * dens ** (-1 / 3) * np.exp(h_sigma * rng.normal(size=n)), 0.05 * px, h_clip * px
    ).astype(np.float32)
    m = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return x, y, h, m


# ---------------------------------------------------------------------------
# (c) the coherent deposit kernel
# ---------------------------------------------------------------------------

KERNEL_CASES = [
    (f, projection, kclass)
    for f in (1, 2, 4) for projection in ("kernel3d", "integrated") for kclass in (True, False)
]


@pytest.mark.parametrize("n_fields,projection,kclass", KERNEL_CASES)
def test_plain_coherent_kernel_matches_pallas(n_fields, projection, kclass):
    """deposit_coherent_tiles_plain vs the JAX Pallas coherent kernel on the
    same packed rows and candidates (kclass: the TPU's K4 column loop)."""
    spec, x, y, h, vals = prep_inputs(40 + n_fields, 4, periodic=True, n_fields=n_fields)
    st = TC._setup(spec, "cubic_spline", TC.PALLAS_LEVELS, TC._D_MAX)
    packed, sk, sr, sk4, _, _, counts = _stage_a_prep(*as_torch(x, y, h, vals), st)
    n_cand = int(counts[0])
    assert n_cand > 0
    cand_tile, cand_row, cand_k4 = sk[:n_cand], sr[:n_cand], sk4[:n_cand]
    g0 = st.geom0
    n_rows = packed.shape[0]
    psy, psx = spec.pixel_size
    got = TC.deposit_coherent_tiles(
        packed, cand_tile, cand_row, n_fields=n_fields, n_tiles=g0.n_tiles, cfg=g0.cfg,
        kernel="cubic_spline", projection=projection, psx=psx, psy=psy, offset=0.5,
    )

    row_bits = max(1, max(1, n_rows - 1).bit_length())
    n_steps = n_cand + g0.n_tiles
    sched = JC._coherent_schedule(
        jnp.asarray(cand_tile.numpy()), jnp.asarray(cand_row.numpy()), g0.n_tiles, n_steps, row_bits,
        jnp.asarray(cand_k4.numpy()) if kclass else None,
    )
    call = JC._cached_coherent_call(
        JC.PALLAS_LEVELS[0], g0.n_tiles, n_steps, n_rows, n_fields, row_bits, "cubic_spline",
        2.0, psx, psy, 0.5, "f32", True, projection, 0, kclass,
    )
    ref = np.asarray(call(sched, jnp.asarray(packed.numpy())))
    assert tuple(got.shape) == ref.shape == (g0.n_tiles, n_fields * g0.cfg.R, 128)
    assert rel_err(got, ref) <= TOL


def dense_coherent_inputs(seed, n_rows, n_fields=2):
    """Morton-ordered clustered particles on 2 x 2 level-0 tiles of a 128^2
    periodic map, support radii log-uniform in the K = 8 level: every tile
    named by several candidate rows."""
    rng = np.random.default_rng(seed)
    npix, box = 128, 10.0
    px = box / npix
    n = n_rows * 2048
    w, hgt = 128.0, 16.0  # pixels: two 64-wide tiles across, two 8-high tiles up
    u = np.clip(w * (0.5 + rng.normal(0, 0.25, n)), 0, w - 1e-3)
    v = np.clip(hgt * (0.5 + rng.normal(0, 0.25, n)), 0, hgt - 1e-3)
    iu, iv = (u * 8).astype(np.int64), (v * 64).astype(np.int64)
    key = np.zeros(n, np.int64)
    for b in range(11):
        key |= ((iu >> b) & 1) << (2 * b) | ((iv >> b) & 1) << (2 * b + 1)
    order = np.argsort(key, kind="stable")
    x = (u[order] * px).astype(np.float32)
    y = (v[order] * px).astype(np.float32)
    h = (0.05 * 60.0 ** rng.uniform(0, 1, n) * px / 2.0).astype(np.float32)
    vals = rng.uniform(0.5, 2.0, (n_fields, n)).astype(np.float32)
    spec = MapSpec(shape=(npix, npix), extent=(0.0, box, 0.0, box), periodic_wrap=True)
    return spec, x, y, h, vals


def _candidate_ranges(cand_tile, n_tiles):
    tr = torch.arange(n_tiles, dtype=torch.int32)
    cstart = torch.searchsorted(cand_tile, tr)
    return cstart, torch.searchsorted(cand_tile, tr, right=True) - cstart


@pytest.mark.parametrize("C", [1, 2, 8])
def test_candidate_row_shares_cover_each_row_once(C):
    """The kernel splits each tile's candidate rows over its C blocks with
    the sorted engine's cluster_rank in groups of one row: every candidate
    in one share, shares within one row of even; tiles without candidates
    and with one included."""
    spec, x, y, h, vals = dense_coherent_inputs(61, 16)
    st = TC._setup(spec, "cubic_spline", TC.PALLAS_LEVELS, TC._D_MAX)
    _, sk, _, _, _, _, counts = _stage_a_prep(*as_torch(x, y, h, vals), st)
    cand_tile = sk[:int(counts[0])]
    cstart, per_tile = _candidate_ranges(cand_tile, st.geom0.n_tiles)
    assert int((per_tile == 0).sum()) > 0 and int(per_tile.max()) >= 4
    sizes = T.cluster_share_sizes(per_tile, C, 1)
    for t, n in enumerate(per_tile.tolist()):
        ranks = T.cluster_rank(torch.arange(n), C, 1).tolist()
        assert sorted(ranks) == sorted(r for r in range(C) for _ in range(int(sizes[t, r])))
        assert ranks == [i % C for i in range(n)]  # rank r: rows r, r + C, ...
        assert int(sizes[t].max() - sizes[t].min()) <= 1


def split_coherent_emulated(packed, cand_tile, cand_row, C, **kw):
    """Torch emulation of the coherent kernel's cluster split: rank r's
    candidate rows of every tile (every C-th from the r-th, ``cluster_rank``
    with groups of one) through the plain version, the C partial
    accumulators summed in rank order."""
    cstart, per_tile = _candidate_ranges(cand_tile, kw["n_tiles"])
    counts = per_tile.to(torch.int64)
    offset = torch.arange(cand_tile.shape[0]) - torch.repeat_interleave(cstart[counts > 0], counts[counts > 0])
    rank = T.cluster_rank(offset, C, 1)
    total = None
    for r in range(C):
        part = TC.deposit_coherent_tiles_plain(packed, cand_tile[rank == r], cand_row[rank == r], **kw)
        total = part if total is None else total + part
    return total


@pytest.mark.parametrize("C", [2, 8])
def test_split_coherent_sum_matches_plain_and_pallas(C):
    """The split sum on dense tiles equals the unsplit plain version and the
    JAX Pallas coherent kernel (interpret mode) on the same packed rows."""
    spec, x, y, h, vals = dense_coherent_inputs(62, 16)
    st = TC._setup(spec, "cubic_spline", TC.PALLAS_LEVELS, TC._D_MAX)
    packed, sk, sr, _, _, _, counts = _stage_a_prep(*as_torch(x, y, h, vals), st)
    n_cand = int(counts[0])
    cand_tile, cand_row = sk[:n_cand], sr[:n_cand]
    g0 = st.geom0
    psy, psx = spec.pixel_size
    kw = dict(n_fields=2, n_tiles=g0.n_tiles, cfg=g0.cfg, kernel="cubic_spline",
              projection="kernel3d", psx=psx, psy=psy, offset=0.5)
    assert int(counts[1]) == 0 and int(_candidate_ranges(cand_tile, g0.n_tiles)[1].max()) >= 4
    got = split_coherent_emulated(packed, cand_tile, cand_row, C, **kw)
    assert rel_err(got, TC.deposit_coherent_tiles_plain(packed, cand_tile, cand_row, **kw)) <= TOL

    n_rows = packed.shape[0]
    row_bits = max(1, max(1, n_rows - 1).bit_length())
    n_steps = n_cand + g0.n_tiles
    sched = JC._coherent_schedule(
        jnp.asarray(cand_tile.numpy()), jnp.asarray(cand_row.numpy()), g0.n_tiles, n_steps, row_bits, None,
    )
    call = JC._cached_coherent_call(
        JC.PALLAS_LEVELS[0], g0.n_tiles, n_steps, n_rows, 2, row_bits, "cubic_spline",
        2.0, psx, psy, 0.5, "f32", True, "kernel3d", 0, False,
    )
    ref = np.asarray(call(sched, jnp.asarray(packed.numpy())))
    assert rel_err(got, ref) <= TOL


# ---------------------------------------------------------------------------
# (d) layout statistics and capacities
# ---------------------------------------------------------------------------

STAT_KEYS = ("n_candidates", "heavy_rows", "tail_particles", "routed_particles",
             "tail_bucket_rows", "level_tail_counts")


@pytest.fixture(scope="module")
def jax_layout_12_rows():
    spec, x, y, h, vals = prep_inputs(77, 12, periodic=True, heavy_rows=(2, 9))
    jspec = JC.MapSpec(spec.shape, spec.extent, periodic_wrap=True)
    return (spec, x, y, h, vals), JC.tile_particles_coherent(x, y, h, vals, jspec, prep="xla")


@pytest.mark.parametrize("prep", ["xla", "pallas"])
def test_layout_stats_and_caps_match_jax(jax_layout_12_rows, prep):
    (spec, x, y, h, vals), jlay = jax_layout_12_rows
    lay = tile_particles_coherent(x, y, h, vals, spec, prep=prep, device="cpu")
    for key in STAT_KEYS:
        assert lay.stats[key] == jlay.stats[key], key
    assert lay.stats["n_rows"] == jlay.stats["n_rows"] == 12
    assert lay.stats["heavy_rows"] >= 2 and lay.n_cand > 0
    for slack in (None, 1.3):
        got = dataclasses.astuple(caps_from_layout(lay, slack=slack))
        assert got == dataclasses.astuple(JC.caps_from_layout(jlay, slack=slack))
    # the routed tail holds exactly the counted particles, key-sorted
    assert lay.n_tail_sorted == lay.stats["tail_particles"] == lay.tail[4].shape[0]
    assert bool((lay.tail[4][1:] >= lay.tail[4][:-1]).all())


# ---------------------------------------------------------------------------
# (e) whole renders
# ---------------------------------------------------------------------------


def _multi_fields(rng, m):
    return np.stack([m, (m * rng.uniform(1, 2, m.size)).astype(np.float32)])


@pytest.mark.parametrize("prep", ["xla", "pallas"])
def test_coherent_order_matches_sorted_engine(prep):
    rng = np.random.default_rng(11)
    box = 10.0
    spec = MapSpec(shape=(128, 128), extent=(0, box, 0, box), periodic_wrap=True)
    x, y, h, m = coherent_set(rng, 30001, box, box / 128)  # not chunk-aligned
    fields = _multi_fields(rng, m)
    lay = tile_particles_coherent(x, y, h, fields, spec, prep=prep, device="cpu")
    assert lay.stats["coherent_fraction"] > 0.7  # snapshot-like order: most rows in place
    img = TC.deposit_coherent(lay, precision="f32")
    ref = deposit_2d_auto(x, y, h, fields, spec, device="cpu")
    assert tuple(img.shape) == (2, 128, 128)
    assert rel_err(img, ref) <= ENGINE_TOL


@pytest.mark.parametrize("prep", ["xla", "pallas"])
def test_oversize_nonperiodic_matches_sorted_and_oracle(prep):
    rng = np.random.default_rng(12)
    box = 8.0
    spec = MapSpec(shape=(64, 64), extent=(0, box, 0, box))
    px = box / 64
    x, y, h, m = coherent_set(rng, 9000, box, px, h_clip=8.0)
    h[::1500] = 40 * px  # beyond the K = 64 window: the oversize path
    lay = tile_particles_coherent(x, y, h, m, spec, prep=prep, device="cpu")
    assert lay.n_tail_oversize == 6
    img = deposit_2d_coherent(x, y, h, m, spec, prep=prep, device="cpu")
    assert tuple(img.shape) == (64, 64)  # a single field unpacks
    assert rel_err(img, deposit_2d_auto(x, y, h, m, spec, device="cpu")) <= ENGINE_TOL
    assert rel_err(img, project_oracle(x, y, h, m, spec.shape, spec.extent)) <= TOL


def test_random_order_degrades_to_tail():
    rng = np.random.default_rng(13)
    box = 10.0
    spec = MapSpec(shape=(128, 128), extent=(0, box, 0, box), periodic_wrap=True)
    x, y, h, m = coherent_set(rng, 20000, box, box / 128)
    # f32 positions at 128 px carry ~1e-5 px of rounding, which a 0.05 px
    # particle turns into ~2e-5 of its peak; a 0.3 px floor keeps both
    # engines inside the oracle budget
    h = np.maximum(h, 0.3 * box / 128).astype(np.float32)
    p = rng.permutation(x.size)
    lay = tile_particles_coherent(x[p], y[p], h[p], m[p], spec, device="cpu")
    assert lay.stats["coherent_fraction"] < 0.2  # incoherent input routes rows whole
    img = TC.deposit_coherent(lay)[0]
    ref = deposit_2d_auto(x, y, h, m, spec, device="cpu")
    assert rel_err(img, ref) <= ENGINE_TOL
    oracle = project_oracle(x, y, h, m, spec.shape, spec.extent, periodic=True)
    assert rel_err(img, oracle) <= TOL


@pytest.mark.parametrize("order", ["coherent", "random"])
def test_fused_matches_synced_and_sorted(order):
    rng = np.random.default_rng(14)
    box = 10.0
    spec = MapSpec(shape=(128, 128), extent=(0, box, 0, box), periodic_wrap=True)
    x, y, h, m = coherent_set(rng, 25000, box, box / 128)
    if order == "random":
        p = rng.permutation(x.size)
        x, y, h, m = x[p], y[p], h[p], m[p]
    fields = _multi_fields(rng, m)
    lay = tile_particles_coherent(x, y, h, fields, spec, device="cpu")
    img, ok = deposit_2d_coherent_fused(x, y, h, fields, spec, caps_from_layout(lay), device="cpu")
    assert ok.dtype == torch.bool and bool(ok)
    synced = TC.deposit_coherent(lay)
    assert rel_err(img, synced) <= 1e-6
    assert rel_err(img, deposit_2d_auto(x, y, h, fields, spec, device="cpu")) <= ENGINE_TOL


def test_fused_without_tail_capacity():
    """All sub-pixel h: no routed tail, and zero tail capacity is exact."""
    rng = np.random.default_rng(15)
    box = 10.0
    spec = MapSpec(shape=(128, 128), extent=(0, box, 0, box), periodic_wrap=True)
    x, y, h, m = coherent_set(rng, 12000, box, box / 128, h_clip=0.9)
    lay = tile_particles_coherent(x, y, h, m, spec, device="cpu")
    caps = caps_from_layout(lay)
    assert not any(caps.level_caps[1:])
    img, ok = deposit_2d_coherent_fused(x, y, h, m, spec, caps, device="cpu")
    assert bool(ok) and tuple(img.shape) == (128, 128)
    assert rel_err(img, TC.deposit_coherent(lay)[0]) <= 1e-6


# ---------------------------------------------------------------------------
# (f) contracts
# ---------------------------------------------------------------------------


def test_fused_overflow_flag():
    rng = np.random.default_rng(16)
    box = 10.0
    spec = MapSpec(shape=(128, 128), extent=(0, box, 0, box), periodic_wrap=True)
    x, y, h, m = coherent_set(rng, 20000, box, box / 128)
    tiny = CoherentCaps(b0=4096, bucket_caps=tuple(0 for _ in range(12)), level_caps=(0, 0, 0, 0))
    img, ok = deposit_2d_coherent_fused(x, y, h, m, spec, tiny, device="cpu")
    assert not bool(ok)
    assert bool(torch.isfinite(img).all())


def test_caps_reuse_across_chunks():
    """The streaming pattern: caps from chunk 0 serve chunk 1 (same
    distribution), and the render stays exact."""
    rng = np.random.default_rng(17)
    box = 10.0
    spec = MapSpec(shape=(128, 128), extent=(0, box, 0, box), periodic_wrap=True)
    x0, y0, h0, m0 = coherent_set(rng, 24000, box, box / 128)
    caps = caps_from_layout(tile_particles_coherent(x0, y0, h0, m0, spec, device="cpu"))
    x1, y1, h1, m1 = coherent_set(rng, 24000, box, box / 128)
    img1, ok1 = deposit_2d_coherent_fused(x1, y1, h1, m1, spec, caps, device="cpu")
    assert bool(ok1)
    ref1 = deposit_2d_coherent(x1, y1, h1, m1, spec, device="cpu")
    assert rel_err(img1, ref1) <= 1e-6


def test_caps_union():
    a = CoherentCaps(b0=4096, bucket_caps=(8, 0, 16), level_caps=(100, 0))
    b = CoherentCaps(b0=8192, bucket_caps=(0, 9, 4), level_caps=(50, 70))
    assert caps_union(a, b) == CoherentCaps(b0=8192, bucket_caps=(8, 9, 16), level_caps=(100, 70))
    with pytest.raises(ValueError, match="mismatched level_caps"):
        caps_union(a, CoherentCaps(b0=4096, bucket_caps=(8, 0, 16), level_caps=(1, 2, 3)))
    with pytest.raises(ValueError, match="at least one"):
        caps_union()


def test_bad_arguments_raise():
    spec = MapSpec(shape=(64, 64), extent=(0.0, 1.0, 0.0, 1.0))
    x = np.array([0.5], np.float32)
    h = np.array([0.05], np.float32)
    caps = CoherentCaps(b0=4096, bucket_caps=(0,) * 12, level_caps=(0,) * 4)
    with pytest.raises(ValueError, match="at most 4 fields"):
        deposit_2d_coherent(x, x, h, np.ones((5, 1)), spec, device="cpu")
    with pytest.raises(ValueError, match="at most 4 fields"):
        deposit_2d_coherent_fused(x, x, h, np.ones((5, 1)), spec, caps, device="cpu")
    with pytest.raises(ValueError, match="unknown prep"):
        tile_particles_coherent(x, x, h, x, spec, prep="mosaic", device="cpu")
    with pytest.raises(ValueError, match="unknown precision"):
        deposit_2d_coherent(x, x, h, x, spec, precision="fp32", device="cpu")
    with pytest.raises(ValueError, match="unknown precision"):
        deposit_2d_coherent_fused(x, x, h, x, spec, caps, precision="bf16x22", device="cpu")
    with pytest.raises(ValueError, match="prep"):
        deposit_2d_coherent(x, x, h, x, spec, window=256, prep="pallas", device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        tile_particles_coherent(x, x, h, x, spec, window=100, device="cpu")
    with pytest.raises(ValueError, match="d_max"):
        tile_particles_coherent(x, x, h, x, spec, d_max=0, device="cpu")
    with pytest.raises(ValueError, match="no coherent deposit kernel"):
        TC.deposit_coherent_tiles(
            torch.zeros((1, 8, 2048), device="meta"), torch.zeros(1, dtype=torch.int32, device="meta"),
            torch.zeros(1, dtype=torch.int32, device="meta"), n_fields=1, n_tiles=1,
            cfg=TC.PALLAS_LEVELS[0], kernel="cubic_spline", projection="kernel3d", psx=1.0, psy=1.0, offset=0.5,
        )


def test_wrappers_take_plain_versions_only_on_cpu():
    rng = np.random.default_rng(18)
    box = 10.0
    spec = MapSpec(shape=(128, 128), extent=(0, box, 0, box), periodic_wrap=True)
    x, y, h, m = coherent_set(rng, 8192, box, box / 128)
    before = (prep_rows.launches, TC.deposit_coherent_tiles.launches, deposit_tiles.launches)
    deposit_2d_coherent(x, y, h, m, spec, prep="pallas", device="cpu")
    assert (prep_rows.launches, TC.deposit_coherent_tiles.launches, deposit_tiles.launches) == before


# ---------------------------------------------------------------------------
# (h) on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA coherent kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("projection", ["kernel3d", "integrated"])
def test_cuda_coherent_kernel_matches_plain(cuda_device, projection):
    spec, x, y, h, vals = prep_inputs(91, 12, periodic=True, heavy_rows=(5,), n_fields=4)
    lay = tile_particles_coherent(x, y, h, vals, spec, device=cuda_device)
    g0 = lay.geom0
    psy, psx = spec.pixel_size
    kw = dict(n_fields=4, n_tiles=g0.n_tiles, cfg=g0.cfg, kernel="cubic_spline",
              projection=projection, psx=psx, psy=psy, offset=0.5)
    before = TC.deposit_coherent_tiles.launches
    got = TC.deposit_coherent_tiles(lay.packed, lay.cand_tile, lay.cand_row, **kw)
    ref = TC.deposit_coherent_tiles_plain(lay.packed, lay.cand_tile, lay.cand_row, **kw)
    torch.cuda.synchronize()
    assert TC.deposit_coherent_tiles.launches == before + 1
    assert rel_err(got.cpu(), ref.cpu()) <= TOL


@pytest.mark.cuda
def test_cuda_engine_moves_launch_counters(cuda_device):
    rng = np.random.default_rng(92)
    box = 10.0
    spec = MapSpec(shape=(128, 128), extent=(0, box, 0, box), periodic_wrap=True)
    x, y, h, m = coherent_set(rng, 40000, box, box / 128)
    before = (prep_rows.launches, TC.deposit_coherent_tiles.launches, deposit_tiles.launches)
    img = deposit_2d_coherent(x, y, h, m, spec, device=cuda_device)
    torch.cuda.synchronize()
    after = (prep_rows.launches, TC.deposit_coherent_tiles.launches, deposit_tiles.launches)
    assert all(a > b for a, b in zip(after, before))
    ref = deposit_2d_auto(x, y, h, m, spec, device=cuda_device)
    assert rel_err(img.cpu(), ref.cpu()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 8])
def test_cuda_dense_tile_split_matches_plain(cuda_device, monkeypatch, C):
    """Dense tiles, each named by several candidate rows, split over C
    blocks (and not split) against the plain version on the card."""
    monkeypatch.setattr(TC, "_CLUSTER", C)
    spec, x, y, h, vals = dense_coherent_inputs(93, 24, n_fields=4)
    lay = tile_particles_coherent(x, y, h, vals, spec, device=cuda_device)
    g0 = lay.geom0
    psy, psx = spec.pixel_size
    for projection in ("kernel3d", "integrated"):
        kw = dict(n_fields=4, n_tiles=g0.n_tiles, cfg=g0.cfg, kernel="cubic_spline",
                  projection=projection, psx=psx, psy=psy, offset=0.5)
        before = TC.deposit_coherent_tiles.launches
        got = TC.deposit_coherent_tiles(lay.packed, lay.cand_tile, lay.cand_row, **kw)
        ref = TC.deposit_coherent_tiles_plain(lay.packed, lay.cand_tile, lay.cand_row, **kw)
        torch.cuda.synchronize()
        assert TC.deposit_coherent_tiles.launches == before + 1
        assert rel_err(got.cpu(), ref.cpu()) <= TOL
