"""Port vs JAX: the tiled 3D voxel engine and its deposit kernel.

The same seeded NumPy inputs go to the JAX package's 3D engines and to the
port on the CPU, where the port's wrapper ``deposit_3d_tiles`` runs the
kernel's plain torch version. The JAX Pallas engine runs in interpret mode
in one case (16^3, 1500 particles); elsewhere the port is held against the
JAX plain stencil engine ``deposit_3d``, its level/tile layout against
JAX's ``tile_particles_3d``, and both against the f64 oracle
``oracles.grid3d_oracle``. Bounds: 1e-5 * max against the oracle (the
fidelity budget), 2e-5 * max against JAX (each engine rounds f32 voxel
coordinates its own way; XLA on the CPU does not round f32 division and sqrt
as IEEE does).

The CUDA tests need a card and skip here.
"""

import importlib

import numpy as np
import pytest
import torch

from astro_sph_tools_tpu.ops import grid3d as JG
from astro_sph_tools_tpu.ops import grid3d_pallas as JP
from astro_sph_tools_tpu_torch.ops import GridSpec, deposit_3d
from oracles import grid3d_oracle

T = importlib.import_module("astro_sph_tools_tpu_torch.ops.grid3d_tiled")

BOX = 8.0
EXT = (0.0, BOX) * 3
TOL = 1e-5
PATH_TOL = 2e-5


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def oracle(pos, h, values, shape, periodic=False):
    """(F, nz, ny, nx) f64 oracle of (F, n) values."""
    return np.stack([grid3d_oracle(pos, h, v, shape, EXT, periodic=periodic) for v in values])


def jax_plain(pos, h, values, shape, periodic=False):
    """(F, nz, ny, nx) from the JAX stencil engine."""
    out = np.asarray(JG.deposit_3d(pos, h, values.T, JG.GridSpec(shape, EXT, periodic_wrap=periodic)))
    return np.moveaxis(out, -1, 0)


def level_particles(rng, li, n, n_fields, npix, *, spread=0.0):
    """Positions (reaching ``spread`` box lengths past each face), h inside
    level ``li`` (at least 0.4 voxel of support: f32 voxel coordinates keep
    smaller footprints' weights only to ~1e-5) and (F, n) values."""
    lo = 0.4 if li == 0 else T.PALLAS_3D_LEVELS[li - 1].max_s_vox
    vox = BOX / npix
    pos = rng.uniform(-spread * BOX, (1 + spread) * BOX, (n, 3))
    h = rng.uniform(lo, T.PALLAS_3D_LEVELS[li].max_s_vox, n) * vox / 2.0
    vals = rng.uniform(0.5, 2.0, (n_fields, n))
    return pos, h, vals


def sorted_level_inputs(pos, h, vals, spec, cfg):
    """Tile-sorted tile-local inputs of one level, as the engine builds them."""
    geom = T._geometry_3d(cfg, spec.shape)
    u, v, w = T._voxel_coords(torch.as_tensor(pos, dtype=torch.float32), spec)
    _, tile, ul, vl, wl = T._multi_level_assign_3d(u, v, w, torch.zeros_like(u), (np.inf,), (geom,))
    order = torch.argsort(tile, stable=True)
    pstart, pcount = T._tile_ranges(tile[order], geom.n_tiles)
    h32 = torch.as_tensor(h, dtype=torch.float32)[order]
    vals32 = torch.as_tensor(vals, dtype=torch.float32)[:, order].contiguous()
    return geom, (ul[order], vl[order], wl[order], h32, vals32, pstart, pcount)


# (level index, F, periodic): every level x {1, 4} fields x {periodic, open}
KERNEL_CASES = [(li, f, p) for li in range(3) for f in (1, 4) for p in (True, False)]


@pytest.mark.parametrize("li,n_fields,periodic", KERNEL_CASES)
def test_plain_kernel_matches_jax_and_oracle(li, n_fields, periodic):
    """deposit_3d_tiles (plain on the CPU) at one level against the JAX
    stencil engine and the oracle, with particles 3 % past the faces (wrapped
    when periodic, clipped into the edge tiles when open). At 16^3 the K = 16
    box (24 voxels) folds over the periodic grid."""
    rng = np.random.default_rng(100 + 10 * li + n_fields + 5 * periodic)
    npix = 16
    pos, h, vals = level_particles(rng, li, 300, n_fields, npix, spread=0.03)
    spec = GridSpec((npix,) * 3, EXT, periodic_wrap=periodic)
    geom, args = sorted_level_inputs(pos, h, vals, spec, T.PALLAS_3D_LEVELS[li])
    grid = torch.zeros((n_fields, npix, npix, npix))
    before = T.deposit_3d_tiles.launches
    out = T.deposit_3d_tiles(*args, grid, **T._level_args(geom, spec, "cubic_spline"))
    assert out is grid and T.deposit_3d_tiles.launches == before
    wrapped = np.mod(pos, BOX) if periodic else pos
    assert rel_err(grid, oracle(wrapped, h, vals, spec.shape, periodic)) < TOL
    assert rel_err(grid, jax_plain(wrapped, h, vals, spec.shape, periodic)) < PATH_TOL


def mixed_particles(rng, n, npix, lo=-0.5, hi=0.9):
    vox = BOX / npix
    pos = rng.uniform(0, BOX, (n, 3))
    h = 10.0 ** rng.uniform(lo, hi, n) * vox * 0.4  # K = 4..16 and, at hi = 0.9, oversize
    m = rng.uniform(0.5, 2.0, n)
    return pos, h, m


AUTO_CASES = {
    # name: (grid, periodic, fields, h exponent range). The rectangular grid's
    # z voxels are twice its x voxels, so its smallest footprints start at
    # 0.4 z-voxel; the oversize case's supports (up to 12.7 voxels) stay
    # under half the periodic box, where the stencil engine and the oracle
    # (nearest image only) agree.
    "mixed_open": ((16, 16, 16), False, 1, (-0.3, 0.8)),
    "periodic_k16_folds": ((16, 16, 16), True, 2, (-0.3, 0.8)),
    "four_fields_rect": ((8, 12, 16), False, 4, (0.0, 0.7)),
    "oversize": ((32, 32, 32), True, 1, (-0.3, 1.2)),
}


@pytest.mark.parametrize("name", sorted(AUTO_CASES))
def test_deposit_3d_auto_matches_jax_and_oracle(name):
    shape, periodic, n_fields, (lo, hi) = AUTO_CASES[name]
    rng = np.random.default_rng(sorted(AUTO_CASES).index(name) + 30)
    pos, h, m = mixed_particles(rng, 500, shape[2], lo, hi)
    vals = np.stack([m * rng.uniform(0.5, 2.0, m.shape[0]) ** f for f in range(n_fields)])
    spec = GridSpec(shape, EXT, periodic_wrap=periodic)
    tp = T.tile_particles_3d(pos, h, vals, spec, device="cpu")
    assert len(tp.geoms) == 3
    assert (tp.n_oversize > 0) == (name == "oversize")
    got = T.deposit_3d_auto(pos, h, vals if n_fields > 1 else vals[0], spec, device="cpu")
    assert tuple(got.shape) == ((n_fields, *shape) if n_fields > 1 else shape)
    got = got.reshape(n_fields, *shape)
    assert rel_err(got, oracle(pos, h, vals, shape, periodic)) < TOL
    assert rel_err(got, jax_plain(pos, h, vals, shape, periodic)) < PATH_TOL


def test_deposit_3d_auto_matches_jax_pallas_interpret():
    """Against the JAX Pallas engine itself (interpret mode), 16^3 periodic."""
    rng = np.random.default_rng(41)
    pos, h, m = mixed_particles(rng, 1500, 16, -0.3, 0.8)
    pos, h, m = (a.astype(np.float32) for a in (pos, h, m))
    ref = np.asarray(JP.deposit_3d_auto(pos, h, m, JG.GridSpec((16,) * 3, EXT, periodic_wrap=True), precision="f32"))
    got = T.deposit_3d_auto(pos, h, m, GridSpec((16,) * 3, EXT, periodic_wrap=True), device="cpu")
    assert rel_err(got, ref) < PATH_TOL


@pytest.mark.parametrize("li", range(3))
def test_single_level_pallas_entry(li):
    rng = np.random.default_rng(51 + li)
    pos, h, vals = level_particles(rng, li, 400, 2, 16)
    spec = GridSpec((16,) * 3, EXT)
    got = T.deposit_3d_pallas(pos, h, vals, spec, level=T.PALLAS_3D_LEVELS[li], precision="f32", device="cpu")
    assert tuple(got.shape) == (2, 16, 16, 16)
    assert rel_err(got, oracle(pos, h, vals, spec.shape)) < TOL
    assert rel_err(got, jax_plain(pos, h, vals, spec.shape)) < PATH_TOL
    single = T.deposit_3d_pallas(pos, h, vals[0], spec, level=T.PALLAS_3D_LEVELS[li], device="cpu")
    assert torch.equal(single, got[0])


def test_level_counts_match_jax():
    """The same particles per level and the same oversize count as JAX's
    tile_particles_3d, whose K = 4 level also holds its power-of-two pads."""
    rng = np.random.default_rng(61)
    pos, h, m = mixed_particles(rng, 3000, 16, -0.5, 1.0)
    pos, h = pos.astype(np.float32), h.astype(np.float32)
    jtp = JP.tile_particles_3d(pos, h, m[None], JG.GridSpec((16,) * 3, EXT))
    tp = T.tile_particles_3d(pos, h, m, GridSpec((16,) * 3, EXT), device="cpu")
    jcounts = {g.cfg.K: c for g, _, _, c in jtp.geoms}
    jcounts[4] -= jtp.n_sorted - jtp.n_valid
    assert {g.cfg.K: c for g, _, c in tp.geoms} == jcounts
    assert tp.n_oversize == jtp.n_oversize > 0
    assert tp.n_sorted == tp.n_valid == 3000
    for geom, lo, c in tp.geoms:  # each level's segment is tile-sorted
        seg = tp.sorted_tile[lo:lo + c]
        assert bool((seg[1:] >= seg[:-1]).all()) and int(seg.max()) < geom.n_tiles
    assert [c.K for c in T.PALLAS_3D_LEVELS] == [c.K for c in JP.PALLAS_3D_LEVELS] == [4, 8, 16]
    assert [c.max_s_vox for c in T.PALLAS_3D_LEVELS] == [c.max_s_vox for c in JP.PALLAS_3D_LEVELS]


def test_unknown_precision_and_too_many_fields_raise():
    spec = GridSpec((8, 8, 8), EXT)
    pos = np.full((1, 3), 4.0)
    h = np.array([0.3])
    m = np.array([1.0])
    for bad in ("fp32", "bf16x3"):  # the 2D engine's fourth string is not a 3D one
        with pytest.raises(ValueError, match="unknown precision"):
            T.deposit_3d_auto(pos, h, m, spec, precision=bad, device="cpu")
        with pytest.raises(ValueError, match="unknown precision"):
            T.deposit_3d_pallas(pos, h, m, spec, precision=bad, device="cpu")
    tp = T.tile_particles_3d(pos, h, m, spec, device="cpu")
    with pytest.raises(ValueError, match="unknown precision"):
        T.deposit_3d_tiled(tp, precision="f64")
    for p in T._PRECISIONS_3D:  # every accepted string renders the same f32 sums
        assert torch.equal(T.deposit_3d_tiled(tp, precision=p), T.deposit_3d_tiled(tp))
    five = np.ones((5, 1))
    with pytest.raises(ValueError, match="at most 4 fields"):
        T.deposit_3d_auto(pos, h, five, spec, device="cpu")
    with pytest.raises(ValueError, match="at most 4 fields"):
        T.tile_particles_3d(pos, h, five, spec, device="cpu")
    with pytest.raises(ValueError, match="at most 4 fields"):
        T.deposit_3d_pallas(pos, h, five, spec, device="cpu")
    with pytest.raises(ValueError, match="composite-key stride"):
        T.tile_particles_3d(pos, h, m, GridSpec((2048,) * 3, EXT), device="cpu")


def test_wrapper_takes_plain_version_only_on_cpu():
    rng = np.random.default_rng(71)
    spec = GridSpec((16,) * 3, EXT)
    pos, h, vals = level_particles(rng, 1, 200, 2, 16)
    geom, args = sorted_level_inputs(pos, h, vals, spec, T.PALLAS_3D_LEVELS[1])
    kw = T._level_args(geom, spec, "cubic_spline")
    before = T.deposit_3d_tiles.launches
    a = T.deposit_3d_tiles(*args, torch.zeros((2, 16, 16, 16)), **kw)
    b = T.deposit_3d_tiles_plain(*args, torch.zeros((2, 16, 16, 16)), **kw)
    assert torch.equal(a, b) and float(a.sum()) > 0
    assert T.deposit_3d_tiles.launches == before  # no kernel launched on the CPU
    meta = [x.to("meta") for x in args]
    with pytest.raises(ValueError, match="no 3D deposit kernel"):
        T.deposit_3d_tiles(*meta, torch.zeros((2, 16, 16, 16), device="meta"), **kw)
    # zero-h particles deposit exactly 0, not NaN
    h0 = (args[0], args[1], args[2], torch.zeros_like(args[3]), *args[4:])
    assert bool((T.deposit_3d_tiles(*h0, torch.zeros((2, 16, 16, 16)), **kw) == 0).all())


@pytest.mark.parametrize("shape,periodic", [((20, 20, 20), True), ((4, 6, 20), True), ((5, 13, 7), False)])
def test_tiles_need_not_divide_the_grid(shape, periodic):
    """Tiles cover each axis with overhang; the flush wraps or drops what lies
    past the grid (the JAX engine needs T | n on periodic axes)."""
    rng = np.random.default_rng(81 + shape[0])
    vox = BOX / max(shape)
    pos = rng.uniform(0, BOX, (300, 3))
    h = 10.0 ** rng.uniform(-0.2, 0.75, 300) * vox * 0.4
    m = rng.uniform(0.5, 2.0, 300)
    ext = (0.0, BOX) * 3
    got = T.deposit_3d_auto(pos, h, m, GridSpec(shape, ext, periodic_wrap=periodic), device="cpu")
    assert rel_err(got, grid3d_oracle(pos, h, m, shape, ext, periodic=periodic)) < TOL


@pytest.mark.parametrize("tiles", [(16, 8, 8), (16, 16, 16), (4, 8, 32)])
def test_other_tile_geometries_match_oracle(tiles):
    """Kernel results do not depend on the tile geometry."""
    rng = np.random.default_rng(91)
    pos, h, m = mixed_particles(rng, 400, 32, -0.3, 0.8)
    spec = GridSpec((32,) * 3, EXT, periodic_wrap=True)
    levels = tuple(T.Pallas3DConfig(K=c.K, TZ=tiles[0], TY=tiles[1], TX=tiles[2]) for c in T.PALLAS_3D_LEVELS)
    got = T.deposit_3d_tiled(T.tile_particles_3d(pos, h, m, spec, levels=levels, device="cpu"))[0]
    assert rel_err(got, grid3d_oracle(pos, h, m, spec.shape, EXT, periodic=True)) < TOL


def test_work_items_split_dense_tiles():
    per = T._ITEM_PARTICLES
    pcount = torch.tensor([0, 2 * per + 88, 3, per, per + 1], dtype=torch.int32)
    pstart = torch.cumsum(pcount, 0, dtype=torch.int32) - pcount
    tile, start, count = T._work_items(pstart, pcount)
    assert tile.tolist() == [1, 1, 1, 2, 3, 4, 4]
    assert count.tolist() == [per, per, 88, 3, per, per, 1]
    assert start.tolist() == [0, per, 2 * per, 2 * per + 88, 2 * per + 91, 3 * per + 91, 4 * per + 91]
    assert tile.dtype == start.dtype == count.dtype == torch.int32


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA 3D deposit kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("periodic", [True, False])
def test_cuda_kernel_matches_plain(cuda_device, periodic):
    """The CUDA kernel against its plain version on the card, every level."""
    rng = np.random.default_rng(101)
    spec = GridSpec((64,) * 3, EXT, periodic_wrap=periodic)
    for li in range(3):
        pos, h, vals = level_particles(rng, li, 20000, 4, 64, spread=0.02)
        geom, args = sorted_level_inputs(pos, h, vals, spec, T.PALLAS_3D_LEVELS[li])
        args = [a.to(cuda_device) for a in args]
        kw = T._level_args(geom, spec, "cubic_spline")
        got = T.deposit_3d_tiles(*args, torch.zeros((4, 64, 64, 64), device=cuda_device), **kw)
        ref = T.deposit_3d_tiles_plain(*args, torch.zeros((4, 64, 64, 64), device=cuda_device), **kw)
        torch.cuda.synchronize()
        assert rel_err(got.cpu(), ref.cpu()) <= TOL


@pytest.mark.cuda
def test_cuda_call_moves_launch_counter(cuda_device):
    rng = np.random.default_rng(111)
    pos, h, m = mixed_particles(rng, 5000, 32, -0.3, 1.0)
    spec = GridSpec((32,) * 3, EXT, periodic_wrap=True)
    before = T.deposit_3d_tiles.launches
    got = T.deposit_3d_auto(pos, h, m, spec, device=cuda_device)
    torch.cuda.synchronize()
    tp = T.tile_particles_3d(pos, h, m, spec, device=cuda_device)
    assert T.deposit_3d_tiles.launches - before == len(tp.geoms) > 0 and tp.n_oversize > 0
    ref = deposit_3d(pos, h, m, spec, device=cuda_device)  # the plain stencil engine
    assert rel_err(got.cpu(), ref.cpu()) <= PATH_TOL
