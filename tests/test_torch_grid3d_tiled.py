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

The CUDA tests need a card and skip here. The card's machine has no JAX:
there they run alone, ``python -m pytest --noconftest -m cuda
tests/test_torch_grid3d_tiled.py``.
"""

import importlib

import numpy as np
import pytest
import torch

from astro_sph_tools_tpu_torch.ops import GridSpec, deposit_3d
from astro_sph_tools_tpu_torch.ops._device import PRECISIONS_3D, tile_ranges
from oracles import grid3d_oracle

try:
    from astro_sph_tools_tpu.ops import grid3d as JG
    from astro_sph_tools_tpu.ops import grid3d_pallas as JP
except ImportError:  # only the CUDA tests, which need no JAX, can run
    JG = JP = None

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
    pstart, pcount = tile_ranges(tile[order], geom.n_tiles)
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
    for p in PRECISIONS_3D:  # every accepted string renders the same f32 sums
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


def _brute_pairs(n, T, M, periodic):
    """For every box voxel (tile t', box index j) that lands on the grid: the
    region that owns it and the region-local index, by direct wrapping."""
    nt = -(-n // T)
    out = []
    for t2 in range(nt):
        for j in range(T + 2 * M):
            g = t2 * T - M + j
            if periodic:
                g %= n
            elif not 0 <= g < n:
                continue
            out.append((t2, j, g // T, g % T))
    return out


# (n, T, M, periodic): dividing and non-dividing, open and periodic, and
# boxes longer than the grid (K = 16 on 4 and 6 voxels)
AXIS_CASES = [(512, 8, 8, True), (20, 8, 8, True), (20, 8, 8, False), (16, 8, 8, True), (4, 8, 8, True),
              (6, 8, 4, True), (13, 8, 2, False), (40, 16, 8, True)]


@pytest.mark.parametrize("n,T_,M,periodic", AXIS_CASES)
def test_axis_pairs_map_every_box_voxel_once(n, T_, M, periodic):
    """Every box voxel that lands on the grid reaches its owning region
    through exactly one (source tile, shift) pair, and no pair maps a box
    voxel anywhere else. Where T divides a large grid each region has its
    three neighbours in tile-index space; a partial edge tile's wrapped box
    reaches regions that are not."""
    tab = T._axis_pairs(n, T_, M, periodic)
    nt = -(-n // T_)
    assert tab.shape[0] == nt and tab.dtype == np.int32
    pairs = [[tuple(tab[r, 1 + 2 * c: 3 + 2 * c]) for c in range(tab[r, 0])] for r in range(nt)]
    for t2, j, r, loc in _brute_pairs(n, T_, M, periodic):
        assert sum(1 for tt, d in pairs[r] if tt == t2 and j + d == loc) == 1
    for r in range(nt):
        R = min(T_, n - r * T_)
        assert tab[r, 1 + 2 * tab[r, 0]:].tolist() == [-1, 0] * (tab.shape[1] // 2 - tab[r, 0])
        for tt, d in pairs[r]:
            for j in range(T_ + 2 * M):
                if 0 <= j + d < R:
                    g = tt * T_ - M + j
                    assert (g % n if periodic else g) == r * T_ + j + d
    if n == 512:
        assert all(sorted(tt for tt, _ in pairs[r]) == sorted({(r - 1) % nt, r, (r + 1) % nt}) for r in range(nt))


def test_region_items_split_dense_regions(monkeypatch):
    """Candidate counts per region sum each candidate tile once per pair;
    blocks run the regions heaviest first, a region past the split is shared
    by blocks that add with atomics, and empty regions get no block."""
    geom = T._geometry_3d(T.PALLAS_3D_LEVELS[1], (24, 24, 24))  # 3 x 3 x 3 tiles, periodic
    pcount = torch.zeros(27, dtype=torch.int32)
    pcount[13] = 300  # the centre tile, past the old 256-particle split
    pcount[0] = 5
    tables = T._candidate_tables(geom, (24, 24, 24), True, "cpu")
    counts = T._region_candidates(pcount, geom, tables)
    assert counts.tolist() == [305] * 27  # 3 tiles a side: every region sees every tile once
    monkeypatch.setattr(T, "_REGION_CANDIDATES", 128)
    items, max_count, candidates = T._region_items(pcount, geom, tables)
    assert max_count == 305 and candidates == 305 * 27 and items.dtype == torch.int32
    assert items.shape[0] == 27 * 3 and bool((items[:, 3] == 1).all())
    for r in range(27):
        mine = items[items[:, 0] == r]
        assert mine[:, 1:3].tolist() == [[0, 128], [128, 256], [256, 305]]
    # open 5 x 5 x 5 tiles, two busy tiles: only their neighbours get
    # blocks, heaviest first (ties in region order)
    geom = T._geometry_3d(T.PALLAS_3D_LEVELS[1], (40, 40, 40))
    pcount = torch.zeros(125, dtype=torch.int32)
    pcount[62] = 40  # tile (2, 2, 2): regions (1..3)^3
    pcount[0] = 3  # tile (0, 0, 0): regions (0..1)^3, no wrap
    tables = T._candidate_tables(geom, (40, 40, 40), False, "cpu")
    items, max_count, candidates = T._region_items(pcount, geom, tables)
    assert max_count == 43 and candidates == 43 + 40 * 26 + 3 * 7 and bool((items[:, 3] == 0).all())
    near_62 = sorted((z * 5 + y) * 5 + x for z in (1, 2, 3) for y in (1, 2, 3) for x in (1, 2, 3))
    near_0 = sorted((z * 5 + y) * 5 + x for z in (0, 1) for y in (0, 1) for x in (0, 1))
    assert items[:, 0].tolist() == [31] + [r for r in near_62 if r != 31] + [r for r in near_0 if r != 31]
    assert items[:, 2].tolist() == [43] + [40] * 26 + [3] * 7 and bool((items[:, 1] == 0).all())


def _staged(u, v, w, h, pstart, pcount, shape, *, geom, kernel, periodic, psx, psy, psz, offset):
    """The kernel's stage, block by block of its work list: the region
    (tz, ty, tx), its extent R per axis, and the candidates it keeps (every
    particle of every (z, y, x) candidate pair, in the kernel's order,
    sliced to the block's range; those with h > 0 whose clipped range is
    non-empty on every axis): their particle indices, shifts (n, 3), and
    per axis (z, y, x) the normalised distance a voxel and the box-local
    clipped range [lo, hi] (``T._axis_range`` within the region)."""
    cfg = geom.cfg
    Ts, Bs = (cfg.TZ, cfg.TY, cfg.TX), cfg.box
    tables = T._candidate_tables(geom, shape, periodic, u.device)
    items, _, _ = T._region_items(pcount, geom, tables)
    lim = T.get_kernel(kernel).support_factor
    coords, cell = (w, v, u), (psz, psy, psx)
    for region, lo, hi, _ in items.tolist():
        tz, rem = divmod(region, geom.nty * geom.ntx)
        t3 = (tz, *divmod(rem, geom.ntx))
        rows = [tables[a][t3[a]].tolist() for a in range(3)]
        cand, shift = [], []
        for cz in range(rows[0][0]):
            for cy in range(rows[1][0]):
                for cx in range(rows[2][0]):
                    tt = [rows[a][1 + 2 * c] for a, c in enumerate((cz, cy, cx))]
                    tile = (tt[0] * geom.nty + tt[1]) * geom.ntx + tt[2]
                    s0, n0 = int(pstart[tile]), int(pcount[tile])
                    cand += range(s0, s0 + n0)
                    shift += [[rows[a][2 + 2 * c] for a, c in enumerate((cz, cy, cx))]] * n0
        idx = torch.tensor(cand[lo:hi], dtype=torch.long)
        d = torch.tensor(shift[lo:hi], dtype=torch.long).reshape(-1, 3)
        R = [min(Ts[a], shape[a] - t3[a] * Ts[a]) for a in range(3)]
        inv_h = torch.where(h[idx] > 0, 1.0 / h[idx], 0.0)
        scale, ranges = [], []
        keep = h[idx] > 0
        for a in range(3):
            sc = cell[a] * inv_h
            reach = torch.tensor(lim, dtype=torch.float32) / torch.tensor(cell[a], dtype=torch.float32)
            blo, bhi = T._axis_range(coords[a][idx], h[idx] * reach, cfg.K, Bs[a], offset)
            blo, bhi = torch.maximum(blo, -d[:, a]), torch.minimum(bhi, R[a] - 1 - d[:, a])
            keep &= blo <= bhi
            scale.append(sc)
            ranges.append((blo, bhi))
        yield t3, R, idx[keep], d[keep], [sc[keep] for sc in scale], [(a[keep], b[keep]) for a, b in ranges]


def _columns(idx, d, scale, ranges, coords, Ts, offset, lim2):
    """Each staged candidate's walk over the region's (x, y) columns:
    normalised offsets per axis (z, y, x) at the region's voxels (n, T),
    dxy2 (n, TY, TX) as the kernel sums it, whether the column lies in the
    clipped range and meets the support, and the chord's box-local z range
    (``T._chord_range``, (n, TY, TX) each)."""
    dn, box = [], []
    for a in range(3):
        j = torch.arange(Ts[a])[None, :] - d[:, a:a + 1]  # box-local index of the region's voxels
        dn.append(((j.float() + offset) - coords[a][idx][:, None]) * scale[a][:, None])
        box.append(j)
    _, dy, dx = dn
    dxy2 = (dx * dx)[:, None, :] + (dy * dy)[:, :, None]
    inside = [(box[a] >= ranges[a][0][:, None]) & (box[a] <= ranges[a][1][:, None]) for a in range(3)]
    col = inside[1][:, :, None] & inside[2][:, None, :] & (dxy2 < lim2)
    zlo, zhi = (r[:, None, None] for r in ranges[0])
    k_lo, k_hi = T._chord_range(coords[0][idx][:, None, None], scale[0][:, None, None], dxy2, zlo, zhi,
                                lim2=lim2, offset=offset)
    return dn, box, dxy2, inside, col, (k_lo, k_hi)


def _pull_emulated(u, v, w, h, values, pstart, pcount, grid, *, geom, kernel, periodic, psx, psy, psz, offset):
    """The CUDA kernel's algorithm in torch: per block of the work list, its
    staged candidates (``_staged``); per (x, y) column of the region that a
    candidate's clipped range holds and its support meets, the voxels of
    the chord (``_columns``) inside the support, summed into the region's
    voxels."""
    cfg = geom.cfg
    Ts = (cfg.TZ, cfg.TY, cfg.TX)
    shape = tuple(grid.shape[1:])
    ks = T.get_kernel(kernel)
    lim2 = ks.support_factor**2
    kw = dict(geom=geom, kernel=kernel, periodic=periodic, psx=psx, psy=psy, psz=psz, offset=offset)
    for t3, R, idx, d, scale, ranges in _staged(u, v, w, h, pstart, pcount, shape, **kw):
        dn, box, dxy2, _, col, (k_lo, k_hi) = _columns(idx, d, scale, ranges, (w, v, u), Ts, offset, lim2)
        jz = box[0][:, :, None, None]
        q2 = dxy2[:, None] + (dn[0] * dn[0])[:, :, None, None]  # (n, Tz, Ty, Tx)
        walk = col[:, None] & (jz >= k_lo[:, None]) & (jz <= k_hi[:, None]) & (q2 < lim2)
        wgt = torch.where(walk, ks.shape_q(torch.sqrt(q2)), 0.0)
        inv_h = 1.0 / h[idx]
        vals = values[:, idx] * ((ks.norm_3d * inv_h) * (inv_h * inv_h))
        blk = torch.einsum("fp,pzyx->fzyx", vals, wgt)
        o = [t3[a] * Ts[a] for a in range(3)]
        grid[:, o[0]:o[0] + R[0], o[1]:o[1] + R[1], o[2]:o[2] + R[2]] += blk[:, :R[0], :R[1], :R[2]]
    return grid


# (grid, periodic, level index, split): a non-dividing periodic grid whose
# K = 16 boxes fold over it, the (20, 20, 20) open grid, per-axis periodicity,
# a box longer than a 4-voxel periodic axis, and regions split over blocks
PULL_CASES = {
    "periodic_20_k16": ((20, 20, 20), True, 2, 2048),
    "open_20_k16": ((20, 20, 20), False, 2, 2048),
    "per_axis_k16": ((24, 16, 40), (True, False, True), 2, 2048),
    "folded_4x6x20_k8": ((4, 6, 20), True, 1, 2048),
    "split_regions_k4": ((5, 13, 7), False, 0, 50),
}


@pytest.mark.parametrize("name", sorted(PULL_CASES))
def test_pull_work_list_matches_plain_and_jax(name, monkeypatch):
    """The kernel's owner-computes work list (candidate pairs, shifts, block
    slices), emulated in torch, against deposit_3d_tiles_plain and the JAX
    stencil engine on the same particles."""
    shape, periodic, li, split = PULL_CASES[name]
    rng = np.random.default_rng(sorted(PULL_CASES).index(name) + 150)
    pos, h, vals = level_particles(rng, li, 400, 2, max(shape), spread=0.03)
    spec = GridSpec(shape, EXT, periodic_wrap=periodic if isinstance(periodic, bool) else False)
    geom, args = sorted_level_inputs(pos, h, vals, spec, T.PALLAS_3D_LEVELS[li])
    kw = T._level_args(geom, spec, "cubic_spline")
    kw["periodic"] = periodic
    ref = T.deposit_3d_tiles_plain(*args, torch.zeros((2, *shape)), **kw)
    monkeypatch.setattr(T, "_REGION_CANDIDATES", split)
    got = _pull_emulated(*args, torch.zeros((2, *shape)), **kw)
    assert rel_err(got, ref) < TOL
    if isinstance(periodic, bool):
        wrapped = np.mod(pos, BOX) if periodic else pos
        assert rel_err(got, jax_plain(wrapped, h, vals, shape, periodic)) < PATH_TOL


def test_pull_work_list_dense_tile(monkeypatch):
    """A dense tile well past the old 256-particle split: 1500 particles in
    one 8^3 tile of a periodic 32^3 grid, regions split over blocks."""
    rng = np.random.default_rng(171)
    npix = 32
    pos, h, vals = level_particles(rng, 2, 1600, 2, npix)
    pos[:1500] = rng.uniform(3.0 * BOX / 8, 4.0 * BOX / 8, (1500, 3))  # tile (1, 1, 1)'s voxels 12..15
    spec = GridSpec((npix,) * 3, EXT, periodic_wrap=True)
    geom, args = sorted_level_inputs(pos, h, vals, spec, T.PALLAS_3D_LEVELS[2])
    assert int(args[6].max()) > 256
    kw = T._level_args(geom, spec, "cubic_spline")
    ref = T.deposit_3d_tiles_plain(*args, torch.zeros((2, npix, npix, npix)), **kw)
    monkeypatch.setattr(T, "_REGION_CANDIDATES", 512)
    got = _pull_emulated(*args, torch.zeros((2, npix, npix, npix)), **kw)
    assert rel_err(got, ref) < TOL
    assert rel_err(got, jax_plain(pos, h, vals, spec.shape, True)) < PATH_TOL


# (grid, periodic): the CUDA tests' awkward grids, the folded 4 x 6 x 20
# periodic box among them
CHORD_GRIDS = {
    "periodic_20": ((20, 20, 20), True),
    "open_20": ((20, 20, 20), False),
    "folded_4x6x20": ((4, 6, 20), True),
    "per_axis": ((24, 16, 40), (True, False, True)),
}


@pytest.mark.parametrize("li", range(3))
@pytest.mark.parametrize("name", sorted(CHORD_GRIDS))
def test_chords_hold_every_support_voxel(name, li):
    """Brute force over every staged (candidate, column) of the work list:
    each voxel of the candidate's clipped box with q^2 < lim^2 (the kernel's
    f32 sums) lies in a column that the column test keeps, and inside the
    chord the thread walks, also with half the slack (the other half covers
    the card's own rounding of dxy2, the root and the division). Supports at
    the level's upper edge (s = 1, 3, 7 voxels), just above its lower edge,
    and between."""
    shape, periodic = CHORD_GRIDS[name]
    rng = np.random.default_rng(sorted(CHORD_GRIDS).index(name) * 3 + li + 190)
    npix = max(shape)
    vox = BOX / npix
    pos, h, vals = level_particles(rng, li, 300, 1, npix, spread=0.03)
    lo_s = 0.4 if li == 0 else T.PALLAS_3D_LEVELS[li - 1].max_s_vox
    h[:100] = T.PALLAS_3D_LEVELS[li].max_s_vox * vox / 2.0
    h[100:150] = np.nextafter(lo_s, np.inf) * vox / 2.0
    spec = GridSpec(shape, EXT, periodic_wrap=periodic if isinstance(periodic, bool) else False)
    geom, args = sorted_level_inputs(pos, h, vals, spec, T.PALLAS_3D_LEVELS[li])
    kw = T._level_args(geom, spec, "cubic_spline")
    kw["periodic"] = periodic
    u, v, w, hh, _, pstart, pcount = args
    Ts = (geom.cfg.TZ, geom.cfg.TY, geom.cfg.TX)
    lim2 = T.get_kernel("cubic_spline").support_factor ** 2
    support = walked = 0
    for _, _, idx, d, scale, ranges in _staged(u, v, w, hh, pstart, pcount, shape, **kw):
        dn, box, dxy2, inside, col, (k_lo, k_hi) = _columns(idx, d, scale, ranges, (w, v, u), Ts, kw["offset"], lim2)
        q2 = dxy2[:, None] + (dn[0] * dn[0])[:, :, None, None]
        sup = inside[0][:, :, None, None] & inside[1][:, None, :, None] & inside[2][:, None, None, :] & (q2 < lim2)
        assert not bool((sup & ~col[:, None]).any())
        jz = box[0][:, :, None, None]
        for lo, hi in ((k_lo, k_hi), T._chord_range(
                w[idx][:, None, None], scale[0][:, None, None], dxy2, ranges[0][0][:, None, None],
                ranges[0][1][:, None, None], lim2=lim2, offset=kw["offset"], slack=T._CHORD_SLACK / 2)):
            assert not bool((sup & ((jz < lo[:, None]) | (jz > hi[:, None]))).any())
        support += int(sup.sum())
        walked += int(torch.where(col, (k_hi - k_lo + 1).clamp(min=0), 0).sum())
    # every support voxel walked; the chords' slack adds few others
    assert 0 < support <= walked <= 1.25 * support + 1000


def test_wrapper_counts_its_work_lists(monkeypatch):
    """``deposit_3d_tiles.candidates`` grows by the sum of
    ``_region_candidates`` over the active regions and ``.blocks`` by the
    work list's blocks (on the CPU too, where the plain version runs), here
    with regions split over blocks whose slices cover each region's
    candidates once."""
    monkeypatch.setattr(T, "_REGION_CANDIDATES", 256)
    rng = np.random.default_rng(181)
    spec = GridSpec((24, 24, 24), EXT, periodic_wrap=True)
    pos, h, vals = level_particles(rng, 1, 3000, 1, 24)
    pos[:2000] = rng.uniform(0.0, BOX / 3, (2000, 3))  # one busy tile
    geom, args = sorted_level_inputs(pos, h, vals, spec, T.PALLAS_3D_LEVELS[1])
    tables = T._candidate_tables(geom, spec.shape, True, "cpu")
    counts = T._region_candidates(args[6], geom, tables)
    items, max_count, candidates = T._region_items(args[6], geom, tables)
    assert candidates == int(counts[counts > 0].sum()) == int((items[:, 2] - items[:, 1]).sum())
    assert max_count > 256 and int(items[:, 3].sum()) > 0
    before = T.deposit_3d_tiles.candidates, T.deposit_3d_tiles.blocks, T.deposit_3d_tiles.launches
    T.deposit_3d_tiles(*args, torch.zeros((1, 24, 24, 24)), **T._level_args(geom, spec, "cubic_spline"))
    after = T.deposit_3d_tiles.candidates, T.deposit_3d_tiles.blocks, T.deposit_3d_tiles.launches
    assert tuple(b - a for a, b in zip(before, after)) == (candidates, items.shape[0], 0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA 3D deposit kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_fields", [1, 2, 3, 4])
@pytest.mark.parametrize("periodic", [True, False])
def test_cuda_kernel_matches_plain(cuda_device, periodic, n_fields):
    """The CUDA kernel against its plain version on the card, every level,
    F = 1-4, and two launches bit for bit (no region is split here)."""
    rng = np.random.default_rng(101 + n_fields)
    spec = GridSpec((64,) * 3, EXT, periodic_wrap=periodic)
    for li in range(3):
        pos, h, vals = level_particles(rng, li, 20000, n_fields, 64, spread=0.02)
        geom, args = sorted_level_inputs(pos, h, vals, spec, T.PALLAS_3D_LEVELS[li])
        args = [a.to(cuda_device) for a in args]
        kw = T._level_args(geom, spec, "cubic_spline")
        got = T.deposit_3d_tiles(*args, torch.zeros((n_fields, 64, 64, 64), device=cuda_device), **kw)
        again = T.deposit_3d_tiles(*args, torch.zeros_like(got), **kw)
        ref = T.deposit_3d_tiles_plain(*args, torch.zeros_like(got), **kw)
        torch.cuda.synchronize()
        assert rel_err(got.cpu(), ref.cpu()) <= TOL
        assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("n_fields", [1, 2, 3, 4])
@pytest.mark.parametrize("shape,periodic", [
    ((20, 20, 20), True), ((20, 20, 20), False), ((4, 6, 20), True), ((24, 16, 40), (True, False, True)),
])
def test_cuda_kernel_matches_plain_on_awkward_grids(cuda_device, shape, periodic, n_fields):
    """Grids the tiles do not divide, boxes that fold over a small periodic
    axis, and per-axis periodicity, every level, F = 1-4, with regions whole
    and split over blocks: the kernel against its plain version on the
    card."""
    rng = np.random.default_rng(121 + n_fields)
    spec = GridSpec(shape, EXT, periodic_wrap=periodic if isinstance(periodic, bool) else False)
    for li in range(3):
        pos, h, vals = level_particles(rng, li, 3000, n_fields, max(shape), spread=0.02)
        geom, args = sorted_level_inputs(pos, h, vals, spec, T.PALLAS_3D_LEVELS[li])
        args = [a.to(cuda_device) for a in args]
        kw = T._level_args(geom, spec, "cubic_spline")
        kw["periodic"] = periodic
        for split in (T._REGION_CANDIDATES, 512):
            T._REGION_CANDIDATES, default = split, T._REGION_CANDIDATES
            try:
                got = T.deposit_3d_tiles(*args, torch.zeros((n_fields, *shape), device=cuda_device), **kw)
            finally:
                T._REGION_CANDIDATES = default
            ref = T.deposit_3d_tiles_plain(*args, torch.zeros_like(got), **kw)
            torch.cuda.synchronize()
            assert rel_err(got.cpu(), ref.cpu()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", [(16, 8, 8), (16, 16, 16), (4, 8, 32)])
def test_cuda_kernel_on_other_tile_geometries(cuda_device, tiles):
    """Tiles deeper than the registers hold (their sums in each thread's own
    shared-memory column) and shallower ones, every level, F = 2 and 4,
    against the plain version on the card."""
    rng = np.random.default_rng(131)
    spec = GridSpec((32,) * 3, EXT, periodic_wrap=True)
    for li, base in enumerate(T.PALLAS_3D_LEVELS):
        cfg = T.Pallas3DConfig(K=base.K, TZ=tiles[0], TY=tiles[1], TX=tiles[2])
        for n_fields in (2, 4):
            pos, h, vals = level_particles(rng, li, 5000, n_fields, 32, spread=0.02)
            geom, args = sorted_level_inputs(pos, h, vals, spec, cfg)
            args = [a.to(cuda_device) for a in args]
            kw = T._level_args(geom, spec, "cubic_spline")
            got = T.deposit_3d_tiles(*args, torch.zeros((n_fields, 32, 32, 32), device=cuda_device), **kw)
            ref = T.deposit_3d_tiles_plain(*args, torch.zeros_like(got), **kw)
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
