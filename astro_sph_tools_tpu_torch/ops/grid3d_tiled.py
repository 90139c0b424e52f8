"""Tiled 3D voxel deposit: adaptive-h cubes through a hand-written CUDA kernel.

Counterpart: ``astro_sph_tools_tpu/ops/grid3d_pallas.py`` (BASELINE config
3). The pipeline and its values are the JAX engine's; its TPU workarounds
are gone:

1. **Assign**: each particle gets a footprint level (by ``support_factor *
   h`` in voxels of the smallest edge; levels K = 4/8/16 of
   :data:`PALLAS_3D_LEVELS`) and a tile of that level's (TZ, TY, TX)
   tiling, by its *centre*, with TILE-LOCAL voxel coordinates (relative to
   the tile's box origin, ``tile * T - K/2`` per axis). Particles outside an
   open extent are clipped into the edge tiles; oversize particles keep
   global voxel coordinates.
2. **Sort**: one ``torch.sort`` of the composite key ``level * 2^22 +
   tile`` and one permutation gather. No power-of-two padding and no slack:
   eager PyTorch reuses nothing compiled, so arrays keep their real length.
3. **Deposit**: per populated level, :func:`deposit_3d_tiles` adds the
   level's particles into the (F, nz, ny, nx) cube — the CUDA kernel
   ``csrc/deposit3d.cu`` on a CUDA tensor, the plain torch version
   :func:`deposit_3d_tiles_plain` on a CPU tensor. Each block owns one
   tile's voxels of the cube and pulls into them the particles of every
   (source tile, periodic image) whose box meets the tile
   (:func:`_axis_pairs`, :func:`_region_items`), wrapping periodic axes and
   dropping off-grid voxels of open ones: this takes the place of the TPU's
   halo'd tile stack and its 27-band overlap-add, so peak memory stays near
   the cube itself.
4. **Oversize** stragglers (footprint beyond the K = 16 level) go through
   the oversize route (``ops/grid3d_wide.py``): on a CUDA tensor its binning
   and the hand-written kernel ``csrc/deposit3d_wide.cu``, on a CPU tensor
   the plain stencil engine (``ops/grid3d.py::deposit_3d``).

Spans (``utils/profiling.py``): ``layout.grid3d`` (particles, K4/K8/K16 per
populated level, n_oversize), ``deposit3d.levels`` (#6 over the levels;
launches, particles, and the work lists' candidates and blocks) and
``deposit3d.oversize`` (the route, binning included; particles, and on the
card launches and tile_pairs).

Not ported (TPU-only): the SMEM/HBM budget adaptation of the tile heights,
the packed schedule words and 8-channel packing, and the compile caches.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from .. import _build
from ..kernels.splines import get_kernel
from ..utils.profiling import span
from ._device import (
    LEVEL_STRIDE,
    PRECISIONS_3D,
    as_f32,
    as_field_matrix,
    check_precision,
    device_const,
    tile_ranges,
)
from .grid3d import GridSpec, _per_axis
from .grid3d_wide import deposit_3d_wide

Tensor = torch.Tensor

_MAX_FIELDS_3D = 4
# candidates of one output region that one thread block takes: a denser
# region is shared by several blocks, which add their sums with atomics
_REGION_CANDIDATES = 8192


@dataclass(frozen=True)
class Pallas3DConfig:
    """Static geometry of one 3D footprint level (name kept from the JAX
    package). A tile holds (TZ, TY, TX) output voxels; its box adds a
    margin of K/2 voxels on each side."""

    K: int  # voxel window per axis = max footprint diameter + slack
    TZ: int = 8
    TY: int = 8
    TX: int = 8

    @property
    def M(self) -> int:
        return self.K // 2

    @property
    def box(self) -> tuple[int, int, int]:
        """(z, y, x) voxels of a tile's box."""
        return (self.TZ + self.K, self.TY + self.K, self.TX + self.K)

    @property
    def max_s_vox(self) -> float:
        """Largest support radius (voxels) this level hosts: 2s + 2 <= K."""
        return (self.K - 2) / 2


# 8^3-voxel tiles at every level: the kernel's block holds one tile's sums
# (8 KiB at four fields) in shared memory
PALLAS_3D_LEVELS: tuple[Pallas3DConfig, ...] = (
    Pallas3DConfig(K=4),
    Pallas3DConfig(K=8),
    Pallas3DConfig(K=16),
)


@dataclass(frozen=True)
class _Geometry3D:
    cfg: Pallas3DConfig
    ntx: int
    nty: int
    ntz: int

    @property
    def n_tiles(self) -> int:
        return self.ntx * self.nty * self.ntz


def _geometry_3d(cfg: Pallas3DConfig, shape) -> _Geometry3D:
    """Tiles cover each axis (the last one may overhang the grid; the
    flush wraps or drops what lies past it), so every level tiles every
    grid, periodic or not."""
    nz, ny, nx = shape
    g = _Geometry3D(
        cfg=cfg,
        ntx=-(-nx // cfg.TX),
        nty=-(-ny // cfg.TY),
        ntz=-(-nz // cfg.TZ),
    )
    # composite sort keys are level * LEVEL_STRIDE + tile: a level whose
    # tile count reaches the stride would alias into the next level's keys
    if g.n_tiles >= LEVEL_STRIDE:
        raise ValueError(
            f"{g.n_tiles} tiles at the K={cfg.K} level exceed the "
            f"composite-key stride ({LEVEL_STRIDE}); grid the cube in sub-extents"
        )
    return g


# ---------------------------------------------------------------------------
# The per-level kernel: tile-sorted particles -> the cube
# ---------------------------------------------------------------------------


def _tile_origins(tile: Tensor, geom: _Geometry3D) -> tuple[Tensor, Tensor, Tensor]:
    """Global voxel index of each tile's box origin, per axis (z, y, x)."""
    cfg = geom.cfg
    t = tile.to(torch.int64)
    tz = t // (geom.nty * geom.ntx)
    rem = t - tz * (geom.nty * geom.ntx)
    ty = rem // geom.ntx
    tx = rem - ty * geom.ntx
    return tz * cfg.TZ - cfg.M, ty * cfg.TY - cfg.M, tx * cfg.TX - cfg.M


def deposit_3d_tiles_plain(
    u: Tensor, v: Tensor, w: Tensor, h: Tensor, values: Tensor,
    pstart: Tensor, pcount: Tensor, grid: Tensor,
    *,
    geom: _Geometry3D,
    kernel: str,
    periodic,
    psx: float,
    psy: float,
    psz: float,
    offset: float,
) -> Tensor:
    """Plain torch version of :func:`deposit_3d_tiles`: the same inputs and
    the same sums added into ``grid`` (F, nz, ny, nx), evaluated with tensor
    operations over blocks of particles (each particle's K^3 window, masked
    to its support and its tile's box). A block's temporaries hold 2^22
    elements on the CPU, 2^25 on a GPU."""
    cfg = geom.cfg
    K = cfg.K
    BZ, BY, BX = cfg.box
    per_x, per_y, per_z = _per_axis(periodic)
    dev = u.device
    n_fields = values.shape[0]
    nz, ny, nx = grid.shape[1:]
    kspec = get_kernel(kernel)
    lim2 = kspec.support_factor**2
    grid_flat = grid.view(n_fields, -1)
    counts = pcount.to(torch.int64)
    total = int(counts.sum())
    if not total:
        return grid
    tile_of = torch.repeat_interleave(torch.arange(pstart.shape[0], device=dev), counts)
    seg0 = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    idx = torch.repeat_interleave(pstart.to(torch.int64), counts) + (torch.arange(total, device=dev) - seg0)
    ks = torch.arange(K, dtype=torch.int64, device=dev)
    step = max(1, (1 << (22 if dev.type == "cpu" else 25)) // (K**3 * max(1, n_fields)))

    def axis(c: Tensor, origin: Tensor, B: int, n_ax: int, per: bool, scale: Tensor):
        """Window voxels (P, K) of one axis: normalised offsets, in-box and
        in-grid mask, global index."""
        j = (torch.floor(c - offset + 0.5).to(torch.int64) - K // 2)[:, None] + ks[None, :]
        d = ((j.to(torch.float32) + offset) - c[:, None]) * scale[:, None]
        g = origin[:, None] + j
        ok = (j >= 0) & (j < B)
        if per:
            g = torch.remainder(g, n_ax)
        else:
            ok = ok & (g >= 0) & (g < n_ax)
            g = torch.clamp(g, 0, n_ax - 1)
        return d, ok, g

    for c0 in range(0, total, step):
        sel = idx[c0:c0 + step]
        oz, oy, ox = _tile_origins(tile_of[c0:c0 + step], geom)
        ul, vl, wl, hl = u[sel], v[sel], w[sel], h[sel]
        # per-particle factors; h <= 0 gives exactly 0
        inv_h = torch.where(hl > 0.0, 1.0 / hl, 0.0)
        val_scale = (kspec.norm_3d * inv_h) * (inv_h * inv_h)
        vals_eff = values[:, sel] * val_scale  # (F, P)
        dz, okz, gz = axis(wl, oz, BZ, nz, per_z, psz * inv_h)
        dy, oky, gy = axis(vl, oy, BY, ny, per_y, psy * inv_h)
        dx, okx, gx = axis(ul, ox, BX, nx, per_x, psx * inv_h)
        q2 = (
            (dz * dz)[:, :, None, None] + (dy * dy)[:, None, :, None]
        ) + (dx * dx)[:, None, None, :]  # (P, Kz, Ky, Kx)
        ok = (q2 < lim2) & okz[:, :, None, None] & oky[:, None, :, None] & okx[:, None, None, :]
        wgt = torch.where(ok, kspec.shape_q(torch.sqrt(q2)), 0.0)
        flat = ((gz[:, :, None, None] * ny + gy[:, None, :, None]) * nx + gx[:, None, None, :]).reshape(-1)
        for f in range(n_fields):
            grid_flat[f].index_add_(0, flat, (wgt * vals_eff[f][:, None, None, None]).reshape(-1))
    return grid


@lru_cache(maxsize=256)
def _axis_pairs(n: int, T: int, M: int, periodic: bool) -> np.ndarray:
    """Candidate (source tile, shift) pairs of every output region along one
    axis: ``(n_t, 1 + 2 W)`` int32 rows ``[count, t_0, d_0, t_1, d_1, ...]``
    (unused pairs ``(-1, 0)``), ``n_t = ceil(n / T)``.

    Region ``t`` owns the voxels ``[t T, min(t T + T, n))``. Tile ``t'``'s
    box holds box-local indices ``j`` in ``[0, T + 2M)`` at global voxel
    ``t' T - M + j``, wrapped modulo ``n`` on a periodic axis. A pair is
    listed for every periodic image of the region (shifted by ``m n``) that
    the box meets, with the shift ``d = t' T - M - t T - m n`` that maps
    ``j`` to the region-local index ``j + d``. Every box voxel that lands in
    the region does so through exactly one pair, so the pairs come from the
    geometry alone: a last tile that overhangs the grid, or a box longer than
    a small periodic grid, needs no special case."""
    nt = -(-n // T)
    rows = []
    for t in range(nt):
        r0 = t * T
        R = min(T, n - r0)
        if periodic:
            # images that some box [t' T - M, t' T + T + M) can meet
            ms = range(-(-(-M - R - r0 + 1) // n), (nt * T + M - 1 - r0) // n + 1)
        else:
            ms = (0,)
        pairs = []
        for m in ms:
            a = r0 + m * n
            for t2 in range(nt):
                if t2 * T - M < a + R and t2 * T + T + M > a:
                    pairs.append((t2, t2 * T - M - a))
        rows.append(pairs)
    width = max(len(p) for p in rows)
    tab = np.zeros((nt, 1 + 2 * width), dtype=np.int32)
    tab[:, 1::2] = -1
    for t, pairs in enumerate(rows):
        tab[t, 0] = len(pairs)
        for c, (t2, d) in enumerate(pairs):
            tab[t, 1 + 2 * c : 3 + 2 * c] = (t2, d)
    return tab


def _candidate_tables(geom: _Geometry3D, shape, periodic, device) -> tuple[Tensor, Tensor, Tensor]:
    """The (z, y, x) tables of :func:`_axis_pairs` for one level, on
    ``device`` (uploaded once per process)."""
    cfg = geom.cfg
    per_x, per_y, per_z = _per_axis(periodic)
    out = []
    for n, T, per in zip(shape, (cfg.TZ, cfg.TY, cfg.TX), (per_z, per_y, per_x)):
        tab = _axis_pairs(int(n), T, cfg.M, bool(per))
        out.append(device_const(tuple(tab.ravel().tolist()), torch.int32, device).view(tab.shape))
    return tuple(out)


def _region_candidates(pcount: Tensor, geom: _Geometry3D, tables) -> Tensor:
    """(n_tiles,) int64 candidate count of every output region: the particles
    of all its (z, y, x) candidate pairs, a tile counted once per pair."""
    tz, ty, tx = (t[:, 1::2].long() for t in tables)  # source tile per pair, -1 unused
    pc = torch.zeros((geom.ntz + 1, geom.nty + 1, geom.ntx + 1), dtype=torch.int64, device=pcount.device)
    pc[:-1, :-1, :-1] = pcount.view(geom.ntz, geom.nty, geom.ntx)  # index -1: the zero slot
    s = pc[:, :, tx].sum(-1)  # (ntz + 1, nty + 1, ntx)
    s = s[:, ty].sum(2)  # (ntz + 1, nty, ntx)
    return s[tz].sum(1).reshape(-1)  # (ntz, nty, ntx)


def _region_items(pcount: Tensor, geom: _Geometry3D, tables):
    """Thread-block work of one level: ``(items, max_candidates,
    candidates)``, items ``(n_items, 4)`` int32 ``[region, first candidate,
    end candidate, atomic]``, ``candidates`` the sum of every region's
    count, the candidates the blocks stage. Regions without candidates get
    no block; the rest run heaviest first, and a region with more than
    ``_REGION_CANDIDATES`` candidates is shared by ``ceil(count /
    _REGION_CANDIDATES)`` blocks that add with atomics (flag 1). One host
    sync (four counts)."""
    split = _REGION_CANDIDATES
    counts = _region_candidates(pcount, geom, tables)
    n_split = (counts + (split - 1)) // split
    n_active, max_count, total, candidates = (int(c) for c in torch.stack(
        [(counts > 0).sum(), counts.max(), n_split.sum(), counts.sum()]).tolist())
    dev = pcount.device
    order = torch.argsort(counts, descending=True, stable=True)[:n_active]
    n_split = n_split[order]
    region = torch.repeat_interleave(order, n_split, output_size=total)
    first = torch.repeat_interleave(torch.cumsum(n_split, 0) - n_split, n_split, output_size=total)
    lo = (torch.arange(total, device=dev) - first) * split
    hi = torch.minimum(counts[region], lo + split)
    atomic = (torch.repeat_interleave(n_split, n_split, output_size=total) > 1).long()
    items = torch.stack([region, lo, hi, atomic], dim=1).to(torch.int32).contiguous()
    return items, max_count, candidates


#: voxels a column's chord is widened by (``csrc/deposit3d.cu``'s kSlack)
_CHORD_SLACK = 0.01


def _axis_range(c: Tensor, r: Tensor, K: int, B: int, offset: float) -> tuple[Tensor, Tensor]:
    """The box-local index range ``[lo, hi]`` of one axis that the kernel
    clips a staged candidate to (``csrc/deposit3d.cu::axis_range``, in its
    f32 arithmetic): the K window around the nearest sample, the box
    ``[0, B)`` and the support ``c - offset +- r`` rounded outwards, ``r``
    the support radius in voxels (``h`` times support_factor over the
    voxel edge)."""
    j0 = torch.clamp(torch.floor(c - offset + 0.5), -2 * K - 4, B + 2 * K + 4).long() - K // 2
    lo = torch.maximum(j0.clamp(min=0), torch.floor(c - offset - r).clamp(-1, B).long())
    hi = torch.minimum((j0 + K - 1).clamp(max=B - 1), torch.ceil(c - offset + r).clamp(-1, B).long())
    return lo, hi


def _chord_range(w: Tensor, sz: Tensor, dxy2: Tensor, lo: Tensor, hi: Tensor, *, lim2: float, offset: float,
                 slack: float = _CHORD_SLACK) -> tuple[Tensor, Tensor]:
    """The box-local z indices ``[k_lo, k_hi]`` that a thread walks for a
    candidate whose support meets its column at ``dxy2`` (the squared
    normalised offset in x and y), as ``csrc/deposit3d.cu`` bounds them in
    f32: the indices k of the candidate's clipped range ``[lo, hi]`` with
    ``|k + offset - w| < sqrt(lim2 - dxy2) / sz + slack`` (none where
    ``k_lo > k_hi``). The card takes the root by the reciprocal root,
    multiplies by ``1 / sz`` and compares region-local indices with the
    centre's region-local index: a few ulp of the chord, which the slack
    covers."""
    half = torch.sqrt(lim2 - dxy2) / sz + slack
    zc = w - offset
    k_lo = torch.ceil(torch.maximum(zc - half, lo.float())).long()
    k_hi = torch.floor(torch.minimum(zc + half, hi.float())).long()
    return k_lo, k_hi


def _check_cuda_inputs(u, v, w, h, values, pstart, pcount, grid) -> None:
    dev = u.device
    n = u.shape[0]
    for name, a in (("u", u), ("v", v), ("w", w), ("h", h)):
        if a.dtype != torch.float32 or a.device != dev or a.ndim != 1 or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D float32 tensor on {dev}")
        if a.shape[0] != n:
            raise ValueError(f"{name} has {a.shape[0]} entries, u has {n}")
    if (
        values.dtype != torch.float32 or values.device != dev or values.ndim != 2
        or values.shape[1] != n or values.stride(1) != 1
    ):
        raise ValueError(f"values must be a (F, {n}) float32 tensor on {dev} with unit column stride")
    if not 1 <= values.shape[0] <= _MAX_FIELDS_3D:
        raise ValueError(f"the 3D deposit kernel takes 1..{_MAX_FIELDS_3D} fields, got {values.shape[0]}")
    for name, a in (("pstart", pstart), ("pcount", pcount)):
        if a.dtype != torch.int32 or a.device != dev or a.ndim != 1 or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor on {dev}")
    if pstart.shape != pcount.shape:
        raise ValueError("pstart and pcount differ in length")
    if (
        grid.dtype != torch.float32 or grid.device != dev or grid.ndim != 4
        or grid.shape[0] != values.shape[0] or not grid.is_contiguous()
    ):
        raise ValueError(f"grid must be a contiguous ({values.shape[0]}, nz, ny, nx) float32 tensor on {dev}")
    if n >= 2**31:
        raise ValueError("the 3D deposit kernel indexes particles with int32")


def deposit_3d_tiles(
    u: Tensor, v: Tensor, w: Tensor, h: Tensor, values: Tensor,
    pstart: Tensor, pcount: Tensor, grid: Tensor,
    *,
    geom: _Geometry3D,
    kernel: str,
    periodic,
    psx: float,
    psy: float,
    psz: float,
    offset: float,
) -> Tensor:
    """Add one level's particles into the cube ``grid`` (F, nz, ny, nx) f32,
    in place, and return it:

        grid[f, z, y, x] += sum_i val_f(i) * norm_3d / h_i^3 * shape_q(|r_i| / h_i)

    over the voxel centres inside particle i's support (and inside its K^3
    window and its tile's box). ``u, v, w, h`` (n,) and ``values`` (F, n) are
    the level's tile-sorted particles in tile-local voxel coordinates; tile
    t owns ``[pstart[t], pstart[t] + pcount[t])``. Periodic axes (a bool, or
    an (x, y, z) tuple) wrap; open axes drop off-grid voxels. h <= 0
    contributes nothing.

    On a CUDA tensor this launches the hand-written kernel
    ``csrc/deposit3d.cu`` (built at first use) and raises if the build or
    the launch fails; on a CPU tensor it runs :func:`deposit_3d_tiles_plain`.
    The kernel sums in f32 FMA arithmetic whatever ``precision=`` the caller
    chose. On either device the level's work list (:func:`_region_items`)
    adds its candidates and blocks to ``deposit_3d_tiles.candidates`` and
    ``.blocks``.
    """
    args = dict(geom=geom, kernel=kernel, periodic=periodic, psx=psx, psy=psy, psz=psz, offset=offset)
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no 3D deposit kernel for device {u.device}")
    if u.device.type == "cuda":
        _check_cuda_inputs(u, v, w, h, values, pstart, pcount, grid)
    cfg = geom.cfg
    nz, ny, nx = grid.shape[1:]
    tables = _candidate_tables(geom, (nz, ny, nx), periodic, u.device)
    items, _, candidates = _region_items(pcount, geom, tables)
    deposit_3d_tiles.candidates += candidates
    deposit_3d_tiles.blocks += items.shape[0]
    if u.device.type == "cpu":
        return deposit_3d_tiles_plain(u, v, w, h, values, pstart, pcount, grid, **args)
    if items.shape[0] == 0:
        return grid
    widths = [(t.shape[1] - 1) // 2 for t in tables]
    kspec = get_kernel(kernel)
    lib, _ = _build.load("deposit3d")
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        code = lib.deposit3d_launch(
            u.data_ptr(), v.data_ptr(), w.data_ptr(), h.data_ptr(), values.data_ptr(),
            values.stride(0), values.shape[0], pstart.data_ptr(), pcount.data_ptr(),
            tables[0].data_ptr(), tables[1].data_ptr(), tables[2].data_ptr(), *widths,
            items.data_ptr(), items.shape[0], grid.data_ptr(),
            cfg.K, cfg.TZ, cfg.TY, cfg.TX, geom.ntx, geom.nty, nz, ny, nx,
            float(offset), float(psx), float(psy), float(psz),
            kspec.kernel_id, float(kspec.norm_3d), float(kspec.support_factor),
            stream,
        )
    _build.check(lib, code, "deposit3d kernel")
    deposit_3d_tiles.launches += 1
    return grid


#: kernel launches made by :func:`deposit_3d_tiles` in this process (CUDA only)
deposit_3d_tiles.launches = 0
#: candidates its work lists staged, summed over their blocks (either device)
deposit_3d_tiles.candidates = 0
#: thread blocks of its work lists (either device)
deposit_3d_tiles.blocks = 0


# ---------------------------------------------------------------------------
# Inputs and assignment
# ---------------------------------------------------------------------------


def _placement_coords(pos, device) -> Tensor:
    """Positions for the level/tile assignment on ``device``: f64 input
    (NumPy or tensor) stays f64, so the tile-local f32 voxel coordinates
    carry f64's precision (f32 voxel coordinates round ~1.5e-5 voxel once
    they pass 256, past the 1e-5 budget for sub-voxel footprints); anything
    else becomes f32, as in the JAX package."""
    if (isinstance(pos, Tensor) and pos.dtype == torch.float64) or (
        isinstance(pos, np.ndarray) and pos.dtype == np.float64
    ):
        return torch.as_tensor(pos, device=device)
    return as_f32(pos, device)


def _voxel_coords(pos: Tensor, spec: GridSpec) -> tuple[Tensor, Tensor, Tensor]:
    """Voxel-space (u, v, w) = (x, y, z) coordinates in the dtype of
    ``pos``, wrapped into the grid on periodic axes."""
    nz, ny, nx = spec.shape
    x0, x1, y0, y1, z0, z1 = (float(e) for e in spec.extent)
    u = (pos[:, 0] - x0) / ((x1 - x0) / nx)
    v = (pos[:, 1] - y0) / ((y1 - y0) / ny)
    w = (pos[:, 2] - z0) / ((z1 - z0) / nz)
    if spec.periodic_wrap:
        u = torch.remainder(u, nx)
        v = torch.remainder(v, ny)
        w = torch.remainder(w, nz)
    return u, v, w


def _multi_level_assign_3d(u, v, w, s_vox, bounds, geoms):
    """(level, tile id, tile-LOCAL voxel coords) per particle under each
    level's geometry. Oversize particles keep GLOBAL voxel coordinates
    (tile 0) so the dense route can recover world positions."""
    n_levels = len(bounds)
    level = torch.full(u.shape, n_levels, dtype=torch.int32, device=u.device)
    for li in range(n_levels - 1, -1, -1):
        level = torch.where(s_vox <= bounds[li], li, level)
    tile = torch.zeros(u.shape, dtype=torch.int32, device=u.device)
    u_loc, v_loc, w_loc = u, v, w
    for li, g in enumerate(geoms):
        cfg = g.cfg
        txi = torch.clamp((u / cfg.TX).to(torch.int32), 0, g.ntx - 1)
        tyi = torch.clamp((v / cfg.TY).to(torch.int32), 0, g.nty - 1)
        tzi = torch.clamp((w / cfg.TZ).to(torch.int32), 0, g.ntz - 1)
        sel = level == li
        tile = torch.where(sel, (tzi * g.nty + tyi) * g.ntx + txi, tile)
        u_loc = torch.where(sel, u - (txi * cfg.TX - cfg.M), u_loc)
        v_loc = torch.where(sel, v - (tyi * cfg.TY - cfg.M), v_loc)
        w_loc = torch.where(sel, w - (tzi * cfg.TZ - cfg.M), w_loc)
    return level, tile, u_loc, v_loc, w_loc


def _level_args(geom: _Geometry3D, spec: GridSpec, kernel: str) -> dict:
    nz, ny, nx = spec.shape
    x0, x1, y0, y1, z0, z1 = spec.extent
    return dict(
        geom=geom, kernel=kernel, periodic=spec.periodic_wrap,
        psx=(x1 - x0) / nx, psy=(y1 - y0) / ny, psz=(z1 - z0) / nz,
        offset=spec.sample_offset,
    )


# ---------------------------------------------------------------------------
# Single-level entry point
# ---------------------------------------------------------------------------


def deposit_3d_pallas(
    pos, h, values, spec: GridSpec,
    *,
    kernel: str = "cubic_spline",
    precision: str = "bf16x2",
    level: Optional[Pallas3DConfig] = None,
    device="cuda",
) -> Tensor:
    """Single-level tiled 3D deposit (name kept from the JAX package):
    (nz, ny, nx) or (F, nz, ny, nx) on ``device``.

    Footprints must fit the level (``support_factor * h / voxel <=
    level.max_s_vox``); use :func:`deposit_3d_auto` for mixed footprints.
    """
    cfg = level or PALLAS_3D_LEVELS[0]
    check_precision(precision, PRECISIONS_3D)
    get_kernel(kernel)
    device = torch.device(device)
    geom = _geometry_3d(cfg, spec.shape)
    values, single = as_field_matrix(values, device, _MAX_FIELDS_3D)
    u, v, w = _voxel_coords(as_f32(pos, device), spec)
    _, tile, u_loc, v_loc, w_loc = _multi_level_assign_3d(u, v, w, torch.zeros_like(u), (np.inf,), (geom,))
    tile_sorted, perm = torch.sort(tile, stable=True)
    pstart, pcount = tile_ranges(tile_sorted, geom.n_tiles)
    grid = torch.zeros((values.shape[0], *spec.shape), dtype=torch.float32, device=device)
    deposit_3d_tiles(
        u_loc[perm], v_loc[perm], w_loc[perm], as_f32(h, device)[perm], values[:, perm].contiguous(),
        pstart, pcount, grid, **_level_args(geom, spec, kernel),
    )
    return grid[0] if single else grid


# ---------------------------------------------------------------------------
# Multi-level layout (Tiled3DParticles)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Tiled3DParticles:
    """Device-resident multi-level 3D tile-sorted layout, built once by
    :func:`tile_particles_3d`. Arrays hold exactly the real particles,
    (level, tile)-sorted."""

    spec: GridSpec
    kernel: str
    geoms: tuple  # per populated level: (_Geometry3D, lo, count)
    sorted_u: Tensor  # (N,) tile-local voxel coords; global for oversize
    sorted_v: Tensor
    sorted_w: Tensor
    sorted_h: Tensor
    sorted_values: Tensor  # (F, N)
    sorted_tile: Tensor  # (N,) int32 tile id within the particle's own level
    n_sorted: int
    n_oversize: int  # trailing segment routed to the oversize route
    n_valid: int

    @property
    def n_fields(self) -> int:
        return self.sorted_values.shape[0]


def tile_particles_3d(
    pos, h, values, spec: GridSpec,
    *,
    kernel: str = "cubic_spline",
    levels: tuple[Pallas3DConfig, ...] = PALLAS_3D_LEVELS,
    device="cuda",
) -> Tiled3DParticles:
    """Build the multi-level 3D layout on ``device`` with one sort of the
    composite key ``level * 2^22 + tile``, in the span ``layout.grid3d``.
    The only host sync is the handful of per-level counts. ``values`` is
    (F, N) or (N,), F <= 4."""
    with span("layout.grid3d") as sp:
        kspec = get_kernel(kernel)
        device = torch.device(device)
        values, _ = as_field_matrix(values, device, _MAX_FIELDS_3D)
        geoms = [_geometry_3d(cfg, spec.shape) for cfg in levels]
        bounds = tuple(g.cfg.max_s_vox for g in geoms)
        pos = _placement_coords(pos, device)
        h = as_f32(h, device)
        n_valid = int(h.shape[0])
        u, v, w = _voxel_coords(pos, spec)
        s_vox = kspec.support_factor * h / min(spec.voxel_size)
        level, tile, u_loc, v_loc, w_loc = _multi_level_assign_3d(u, v, w, s_vox, bounds, geoms)
        key = level * LEVEL_STRIDE + tile
        del u, v, w, s_vox, level, tile

        sorted_key, perm = torch.sort(key, stable=True)
        del key
        su, sv, sw = (a[perm].to(torch.float32) for a in (u_loc, v_loc, w_loc))
        del u_loc, v_loc, w_loc
        sh = h[perm]
        s_values = values[:, perm].contiguous()
        lv = torch.arange(len(geoms) + 2, dtype=sorted_key.dtype, device=device) * LEVEL_STRIDE
        starts = torch.searchsorted(sorted_key, lv).tolist()  # host sync: a few ints
        counts = [starts[i + 1] - starts[i] for i in range(len(geoms) + 1)]
        s_tile = torch.remainder(sorted_key, LEVEL_STRIDE).to(torch.int32)

        level_meta = []
        lo = 0
        for li, g in enumerate(geoms):
            if counts[li] > 0:
                level_meta.append((g, lo, counts[li]))
            lo += counts[li]
        sp.count(particles=n_valid, n_oversize=counts[len(geoms)], **{f"K{g.cfg.K}": c for g, _, c in level_meta})
    return Tiled3DParticles(
        spec=spec, kernel=kernel, geoms=tuple(level_meta),
        sorted_u=su, sorted_v=sv, sorted_w=sw, sorted_h=sh, sorted_values=s_values,
        sorted_tile=s_tile, n_sorted=int(sorted_key.shape[0]),
        n_oversize=counts[len(geoms)], n_valid=n_valid,
    )


def deposit_3d_tiled(
    tp: Tiled3DParticles,
    *,
    precision: str = "bf16x2",
) -> Tensor:
    """Render the adaptive-h voxel cube from a :class:`Tiled3DParticles`
    layout, on the layout's device: (F, nz, ny, nx). Every populated level
    goes through :func:`deposit_3d_tiles` (span ``deposit3d.levels``);
    oversize stragglers through the oversize route
    (:func:`.grid3d_wide.deposit_3d_wide`, span ``deposit3d.oversize``) on
    the same device. ``precision`` is validated; the sums are f32
    throughout."""
    check_precision(precision, PRECISIONS_3D)
    nz, ny, nx = tp.spec.shape
    dev = tp.sorted_u.device
    grid = torch.zeros((tp.n_fields, nz, ny, nx), dtype=torch.float32, device=dev)
    launches, candidates, blocks = deposit_3d_tiles.launches, deposit_3d_tiles.candidates, deposit_3d_tiles.blocks
    with span("deposit3d.levels", particles=sum(count for _, _, count in tp.geoms)) as sp:
        for geom, lo, count in tp.geoms:
            sl = slice(lo, lo + count)
            pstart, pcount = tile_ranges(tp.sorted_tile[sl], geom.n_tiles)
            deposit_3d_tiles(
                tp.sorted_u[sl], tp.sorted_v[sl], tp.sorted_w[sl], tp.sorted_h[sl],
                tp.sorted_values[:, sl], pstart, pcount, grid,
                **_level_args(geom, tp.spec, tp.kernel),
            )
        sp.count(launches=deposit_3d_tiles.launches - launches, candidates=deposit_3d_tiles.candidates - candidates,
                 blocks=deposit_3d_tiles.blocks - blocks)

    if tp.n_oversize:
        # oversize stragglers live at the end of the sorted layout with
        # global voxel coordinates
        with span("deposit3d.oversize", particles=tp.n_oversize):
            sl = slice(tp.n_sorted - tp.n_oversize, tp.n_sorted)
            deposit_3d_wide(tp.sorted_u[sl], tp.sorted_v[sl], tp.sorted_w[sl], tp.sorted_h[sl],
                            tp.sorted_values[:, sl], tp.spec, kernel=tp.kernel, out=grid)
    return grid


def deposit_3d_auto(
    pos, h, values, spec: GridSpec,
    *,
    kernel: str = "cubic_spline",
    precision: str = "bf16x2",
    device="cuda",
) -> Tensor:
    """Adaptive-h 3D deposit: level/tile partition (one sort), one kernel
    launch per populated footprint level, oversize stragglers routed to the
    oversize route. ``values`` is (N,) or (F, N), F <= 4. Returns
    (nz, ny, nx) or (F, nz, ny, nx) on ``device``."""
    check_precision(precision, PRECISIONS_3D)
    values, single = as_field_matrix(values, device, _MAX_FIELDS_3D)
    tp = tile_particles_3d(pos, h, values, spec, kernel=kernel, device=device)
    total = deposit_3d_tiled(tp, precision=precision)
    return total[0] if single else total
