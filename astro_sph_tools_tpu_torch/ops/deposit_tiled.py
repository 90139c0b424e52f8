"""Sorted tile engine: adaptive-h 2D deposit through a hand-written CUDA kernel.

Counterpart: ``astro_sph_tools_tpu/ops/deposit_pallas.py``. The pipeline and
its values are the JAX engine's; its TPU workarounds are gone:

1. **Assign**: each particle gets a footprint level (by ``support_factor * h``
   in pixels, levels K = 8/16/32/64 of :data:`PALLAS_LEVELS`) and a tile of
   that level's (TY x tx) tiling, by its *centre*, with TILE-LOCAL pixel
   coordinates (relative to the tile's extended origin): global f32 pixel
   coordinates at 1024^2 carry ~6e-5 px of quantisation, which busts the
   1e-5 budget for sub-pixel footprints. Host f64 NumPy coordinates are
   assigned in f64 on the CPU (the quality path); anything else is assigned
   in f32 on the device.
2. **Sort**: one ``torch.sort`` of the composite key ``level * 2^22 + tile``
   and one permutation gather of (u, v, h, values, perm) — in place of the
   TPU's multi-operand ``lax.sort``. No size-class padding and no slack:
   eager PyTorch reuses nothing compiled, so arrays keep their real length.
   ``layout="shear"`` groups by the same (compact) key with the two-pass
   layout of :mod:`.layout_shear` instead, pad slots included.
3. **Deposit**: per populated level, :func:`deposit_tiles` fills the
   (n_tiles, F*R, 128) extended tile accumulators — the CUDA kernel
   ``csrc/deposit2d.cu`` on a CUDA tensor (``_CLUSTER`` thread blocks a
   tile: at K = 8 and 16 a cluster splitting the tile's particles in groups
   of 8, :func:`cluster_rank`; from :data:`REGISTER_MIN_K` blocks owning
   the tile's rows, :func:`register_pixels`), the plain torch version
   :func:`deposit_tiles_plain` on a CPU tensor.
4. **Overlap-add**: extended tiles are summed into the (F, ny, nx) image
   with nine band adds (:func:`_overlap_add`).
5. **Oversize** stragglers (footprint beyond the largest window) go through
   the oversize route (:mod:`.deposit_wide`: the CUDA kernel
   ``csrc/deposit_wide.cu`` on a CUDA tensor, the plain torch stencil
   engine ``ops/deposit.py::deposit_2d`` on a CPU tensor) on the same
   device.

The schedule word, the channel packing and the chunk geometry of the TPU
kernel exist only for its sequential grid and DMA blocks, and are not ported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from .. import _build
from ..kernels.splines import get_kernel, integrated_kernel_chebyshev, kernel_weight_q2
from ..utils.profiling import span
from ._device import LEVEL_STRIDE, as_field_matrix, check_precision, device_const, tile_ranges
from .deposit import MapSpec
from .deposit_wide import deposit_wide, deposit_wide_plain
from .layout_shear import shear_tile_sort

Tensor = torch.Tensor

_LANES = 128  # accumulator width S
_MAX_FIELDS = 5


@dataclass(frozen=True)
class PallasDepositConfig:
    """Static geometry of one footprint level (name kept from the JAX
    package so that user code ports by changing the import)."""

    K: int  # column window = max footprint diameter + slack
    TY: int = 8  # tile output rows
    S: int = _LANES  # accumulator lane width

    @property
    def M(self) -> int:
        """Margin (pixels) on each side of the tile's output region."""
        return self.K // 2

    @property
    def R(self) -> int:
        """Accumulator rows: output rows plus both margins."""
        return self.TY + self.K

    @property
    def default_tx(self) -> int:
        """Tile output cols so the accumulator is exactly S lanes wide."""
        return self.S - self.K

    @property
    def max_s_pix(self) -> float:
        """Largest support radius (pixels) this level hosts: the K-window must
        cover the footprint diameter (2s + 2 <= K) and the margin the spill."""
        return (self.K - 2) / 2


PALLAS_LEVELS: tuple[PallasDepositConfig, ...] = (
    PallasDepositConfig(K=8),
    PallasDepositConfig(K=16),
    PallasDepositConfig(K=32, TY=16),
    PallasDepositConfig(K=64, TY=32),
)


def _choose_tx(cfg: PallasDepositConfig, nx: int, periodic: bool) -> int:
    """Tile output width. Non-periodic: S - K (accumulator exactly S lanes).
    Periodic overlap-add wraps whole tile periods, so tx must divide nx."""
    if not periodic:
        return cfg.default_tx
    tx = min(cfg.default_tx, nx)
    while tx > cfg.M and nx % tx != 0:
        tx -= 1
    if tx <= cfg.M or nx % tx:
        raise ValueError(
            f"no valid periodic tile width for nx={nx}, level K={cfg.K}"
        )
    return tx


@dataclass(frozen=True)
class _LevelGeometry:
    """Static per-level tiling geometry for one MapSpec."""

    cfg: PallasDepositConfig
    tx: int
    n_tiles_x: int
    n_tiles_y: int

    @property
    def n_tiles(self) -> int:
        return self.n_tiles_x * self.n_tiles_y


def _level_geometry(cfg: PallasDepositConfig, spec: MapSpec) -> _LevelGeometry:
    ny, nx = spec.shape
    tx = _choose_tx(cfg, nx, spec.periodic_wrap)
    if spec.periodic_wrap and ny % cfg.TY:
        raise ValueError("periodic tiled deposit requires TY | ny")
    return _LevelGeometry(
        cfg=cfg,
        tx=tx,
        n_tiles_x=(nx + tx - 1) // tx,
        n_tiles_y=(ny + cfg.TY - 1) // cfg.TY,
    )


# ---------------------------------------------------------------------------
# The per-level kernel: tile-sorted particles -> extended tile accumulators
# ---------------------------------------------------------------------------


def deposit_tiles_plain(
    u: Tensor, v: Tensor, h: Tensor, values: Tensor,
    pstart: Tensor, pcount: Tensor,
    *,
    cfg: PallasDepositConfig,
    kernel: str,
    projection: str,
    psx: float,
    psy: float,
    offset: float,
) -> Tensor:
    """Plain torch version of :func:`deposit_tiles`: the same inputs and the
    same (n_tiles, F*R, S) f32 output, evaluated with tensor operations over
    blocks of particles (every particle's full R x K window, masked). A
    block's (particles x R x K) temporaries hold 2^22 elements on the CPU,
    2^25 on a GPU."""
    K, R, S = cfg.K, cfg.R, cfg.S
    dev = u.device
    n_fields = values.shape[0]
    n_tiles = pstart.shape[0]
    kspec = get_kernel(kernel)
    out = torch.zeros(n_tiles * n_fields * R * S, dtype=torch.float32, device=dev)
    counts = pcount.to(torch.int64)
    total = int(counts.sum())
    if total:
        # every particle in a tile's range, with its tile id
        tile_of = torch.repeat_interleave(torch.arange(n_tiles, device=dev), counts)
        seg0 = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
        idx = torch.repeat_interleave(pstart.to(torch.int64), counts) + (
            torch.arange(total, device=dev) - seg0
        )
        # slots that add exactly 0 are skipped, as the kernel skips h <= 0:
        # zero-h slots, and slots whose values are all 0 (the pad slots of
        # the shear layouts, most of a small layout's slots)
        live = (h[idx] > 0.0) & (values[:, idx] != 0.0).any(dim=0)
        idx, tile_of = idx[live], tile_of[live]
        total = idx.shape[0]
        rows =torch.arange(R, dtype=torch.float32, device=dev)
        rows_i = torch.arange(R, dtype=torch.int64, device=dev)
        ks = torch.arange(K, dtype=torch.int32, device=dev)
        step = max(1, (1 << (22 if dev.type == "cpu" else 25)) // (R * K))
        for c0 in range(0, total, step):
            sel = idx[c0:c0 + step]
            t = tile_of[c0:c0 + step]
            ul, vl, hl = u[sel], v[sel], h[sel]
            col0 = torch.floor(ul - offset + 0.5).to(torch.int32) - (K // 2)
            # per-particle factors
            inv_h = torch.where(hl > 0.0, 1.0 / hl, 0.0)
            if projection == "integrated":
                inv_n = inv_h * (1.0 / kspec.support_factor)
                val_scale = inv_h * inv_h
            else:
                inv_n = inv_h
                val_scale = (kspec.norm_3d * inv_h) * (inv_h * inv_h)
            vals_eff = values[:, sel] * val_scale  # (F, P)
            dyn = (rows[None, :] + offset - vl[:, None]) * (psy * inv_n)[:, None]  # (P, R)
            colk = col0[:, None] + ks[None, :]  # (P, K)
            # off-extent columns are masked, never clipped or wrapped
            col_ok = ((colk >= 0) & (colk < S)).to(torch.float32)
            dxn = (colk.to(torch.float32) + offset - ul[:, None]) * (psx * inv_n)[:, None]
            q2 = (dyn * dyn)[:, :, None] + (dxn * dxn)[:, None, :]  # (P, R, K)
            w = kernel_weight_q2(q2, kernel, projection) * col_ok[:, None, :]
            flat = (
                (t[:, None, None] * (n_fields * R) + rows_i[None, :, None]) * S
                + torch.clamp(colk, 0, S - 1).to(torch.int64)[:, None, :]
            ).reshape(-1)
            for f in range(n_fields):
                out.index_add_(
                    0, flat + f * R * S, (w * vals_eff[f][:, None, None]).reshape(-1)
                )
    return out.view(n_tiles, n_fields * R, S)


# thread blocks a tile's work is split over on the card, in both 2D deposit
# kernels (csrc/deposit2d.cu, csrc/coherent.cu) and at every level: fixed,
# never taken from particle counts, so that a render sized from capacities
# needs no count on the host. A thread-block cluster sharing the tile's
# particles at K = 8 and 16 and in #2, blocks sharing its rows from
# REGISTER_MIN_K. Two blocks halve the densest tile's walk; more blocks walk
# it faster but cost every light tile their zeroing and their share of the
# cluster's sum (PERF.md section 6)
_CLUSTER = 2


#: particles a group of the sorted engine's cluster split: one 32-byte
#: sector of each input array; the coherent engine splits candidate rows one
#: by one
CLUSTER_GROUP = 8


def cluster_rank(offset: Tensor, C: int, group: int = CLUSTER_GROUP) -> Tensor:
    """The block of a tile's C-block cluster that deposits the item at
    ``offset`` in the tile: the items form groups of ``group``, and rank r
    takes groups r, r + C, r + 2 C, ..., so that every block's share covers
    the whole tile (``csrc/deposit_common.cuh::cluster_groups``)."""
    return torch.div(offset, group, rounding_mode="floor") % C


def cluster_share_sizes(count: Tensor, C: int, group: int = CLUSTER_GROUP) -> Tensor:
    """Items each rank of each tile's cluster deposits, (n_tiles, C) int64,
    step for step as the kernels count them: the rank's groups
    (``cluster_groups``), all full but the tile's last, which may be short.
    The shares differ by at most ``group`` items."""
    count = count.to(torch.int64)[:, None]
    r = torch.arange(C, dtype=torch.int64, device=count.device)[None, :]
    n_groups = (count + group - 1) // group
    mine = torch.where(r < n_groups, (n_groups - r + C - 1) // C, 0)
    last = n_groups - 1
    short = torch.where((mine > 0) & (last % C == r), (last + 1) * group - count, 0)
    return mine * group - short


#: levels from this K sum output-stationary in registers on the card
#: (``csrc/deposit2d.cu::deposit2d_register``): each thread owns fixed
#: pixels of its tile's accumulator; the narrower levels split the tile's
#: particles over the cluster (:func:`cluster_rank`) and add with shared
#: float atomics
REGISTER_MIN_K = 32
_REGISTER_WARPS = 12  # the most warps a block of the register path
_REGISTER_COL_GROUP = 16  # columns a half-warp takes in one step


def register_walks(R: int, C: int) -> int:
    """Walks over a tile's particles each block of the register path makes:
    the fewest that its C blocks of at most 12 warps need for the R / 2 row
    pairs, one pair a warp a walk (``deposit2d_launch``'s ``walks``)."""
    n_pairs = (R + 1) // 2
    return -(-n_pairs // (C * _REGISTER_WARPS))


def register_warps(R: int, C: int) -> int:
    """Warps a block of the register path: the fewest that take the row
    pairs in :func:`register_walks` walks (``deposit2d_launch``'s
    ``threads`` / 32)."""
    return -(-((R + 1) // 2) // (C * register_walks(R, C)))


def register_pixels(R: int, C: int, rank: int, warp: int, lane: int) -> list:
    """The (walk, row, column) pixels of a tile's R x 128 accumulator that
    lane ``lane`` of warp ``warp`` of block ``rank`` (of C) owns on the
    register path, step for step as ``csrc/deposit2d.cu::deposit2d_register``
    deals them: the R rows form row pairs, pair p belongs to rank p mod C
    and to its warp (p / C) mod W (W = :func:`register_warps`), a warp's
    k-th pair to its k-th walk; lane l takes row 2p + l // 16 of its pairs
    and the columns l mod 16 + 16 j."""
    n_pairs = (R + 1) // 2
    stride = register_warps(R, C) * C
    pixels = []
    for walk, pair in enumerate(range(warp * C + rank, n_pairs, stride)):
        row = 2 * pair + lane // _REGISTER_COL_GROUP
        if row < R:
            pixels += [(walk, row, lane % _REGISTER_COL_GROUP + _REGISTER_COL_GROUP * j)
                       for j in range(_LANES // _REGISTER_COL_GROUP)]
    return pixels


def _check_cuda_inputs(u, v, h, values, pstart, pcount) -> None:
    dev = u.device
    for name, a in (("u", u), ("v", v), ("h", h)):
        if a.dtype != torch.float32 or a.device != dev or a.ndim != 1 or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D float32 tensor on {dev}")
        if a.shape[0] != u.shape[0]:
            raise ValueError(f"{name} has {a.shape[0]} entries, u has {u.shape[0]}")
    if (
        values.dtype != torch.float32 or values.device != dev or values.ndim != 2
        or values.shape[1] != u.shape[0] or values.stride(1) != 1
    ):
        raise ValueError(f"values must be a (F, {u.shape[0]}) float32 tensor on {dev} with unit column stride")
    if not 1 <= values.shape[0] <= _MAX_FIELDS:
        raise ValueError(f"the deposit kernel takes 1..{_MAX_FIELDS} fields, got {values.shape[0]}")
    for name, a in (("pstart", pstart), ("pcount", pcount)):
        if a.dtype != torch.int32 or a.device != dev or a.ndim != 1 or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor on {dev}")
    if pstart.shape != pcount.shape:
        raise ValueError("pstart and pcount differ in length")
    if u.shape[0] >= 2**31:
        raise ValueError("the deposit kernel indexes particles with int32")


def deposit_tiles(
    u: Tensor, v: Tensor, h: Tensor, values: Tensor,
    pstart: Tensor, pcount: Tensor,
    *,
    cfg: PallasDepositConfig,
    kernel: str,
    projection: str,
    psx: float,
    psy: float,
    offset: float,
) -> Tensor:
    """One level's extended tile accumulators, (n_tiles, F*R, 128) f32.

    ``u, v, h`` (n,) and ``values`` (F, n) are the level's tile-sorted,
    tile-local particles; tile t owns ``[pstart[t], pstart[t] + pcount[t])``.
    On a CUDA tensor this launches the hand-written kernel
    ``csrc/deposit2d.cu`` (built at first use) with ``_CLUSTER`` thread
    blocks a tile (from :data:`REGISTER_MIN_K` the register path, counted
    in ``deposit_tiles.register_launches`` too) and raises if the build or
    the launch fails, naming the cluster size; on a CPU tensor it runs
    :func:`deposit_tiles_plain`.

    Precision: the kernel sums in f32 FMA arithmetic whatever ``precision=``
    the caller chose — at least as accurate as each of the TPU engine's bf16
    limb splits, so every accepted precision string is honoured.
    """
    if projection not in ("kernel3d", "integrated"):
        raise ValueError(f"projection must be 'kernel3d' or 'integrated', got {projection!r}")
    args = dict(cfg=cfg, kernel=kernel, projection=projection, psx=psx, psy=psy, offset=offset)
    if u.device.type == "cpu":
        return deposit_tiles_plain(u, v, h, values, pstart, pcount, **args)
    if u.device.type != "cuda":
        raise ValueError(f"no deposit kernel for device {u.device}")
    _check_cuda_inputs(u, v, h, values, pstart, pcount)
    kspec = get_kernel(kernel)
    n_tiles = pstart.shape[0]
    out = torch.empty((n_tiles, values.shape[0] * cfg.R, cfg.S), dtype=torch.float32, device=u.device)
    if n_tiles == 0:
        return out
    lib, _ = _build.load()
    integrated = projection == "integrated"
    cheb = device_const(integrated_kernel_chebyshev(kernel), torch.float32, u.device) if integrated else None
    C = _CLUSTER
    # the register path takes the tiles heaviest first, so that a dense
    # tile's blocks do not start last
    order = torch.argsort(pcount, descending=True).to(torch.int32) if cfg.K >= REGISTER_MIN_K else None
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        code = lib.deposit2d_launch(
            u.data_ptr(), v.data_ptr(), h.data_ptr(), values.data_ptr(),
            values.stride(0), values.shape[0],
            pstart.data_ptr(), pcount.data_ptr(), n_tiles,
            out.data_ptr(), cfg.K, cfg.R,
            float(offset), float(psx), float(psy),
            kspec.kernel_id, int(integrated), float(kspec.norm_3d), float(kspec.support_factor),
            cheb.data_ptr() if integrated else None, cheb.numel() if integrated else 0,
            C, None if order is None else order.data_ptr(), stream,
        )
    _build.check(lib, code, f"deposit2d kernel (clusters of {C} blocks, K={cfg.K}, F={values.shape[0]})")
    deposit_tiles.launches += 1
    if cfg.K >= REGISTER_MIN_K:
        deposit_tiles.register_launches += 1
    return out


#: kernel launches made by :func:`deposit_tiles` in this process (CUDA only)
deposit_tiles.launches = 0
#: those of them that took the register path (levels from
#: :data:`REGISTER_MIN_K`)
deposit_tiles.register_launches = 0


def _overlap_add(
    tiles: Tensor,  # (n_tiles, F*R, S)
    cfg: PallasDepositConfig,
    tx: int,
    n_tiles_y: int,
    n_tiles_x: int,
    n_fields: int,
    ny: int,
    nx: int,
    periodic: bool,
) -> Tensor:
    """Sum extended tiles into the (F, ny, nx) image with 9 band adds."""
    R, TY, M = cfg.R, cfg.TY, cfg.M
    t = tiles.reshape(n_tiles_y, n_tiles_x, n_fields, R, cfg.S)
    t = t[:, :, :, :, : tx + 2 * M]  # drop lane padding
    t = t.permute(2, 0, 1, 3, 4)  # (F, nty, ntx, R, tx+2M)

    img = torch.zeros((n_fields, n_tiles_y, TY, n_tiles_x, tx), dtype=tiles.dtype, device=tiles.device)

    def bands(margin: int, period: int):
        """Partition accumulator offsets [-margin, period + margin) into
        period-aligned bands: (slice start in acc, height, period shift,
        sub-offset within period). Handles margins spanning multiple periods
        (e.g. the K=32 level whose M=16 exceeds TY=8)."""
        out = []
        o = -margin
        while o < period + margin:
            p = o // period  # floor division (negative-safe)
            end = min((p + 1) * period, period + margin)
            out.append((o + margin, end - o, p, o - p * period))
            o = end
        return out

    def shift(a: Tensor, axis: int, p: int) -> Tensor:
        if p == 0:
            return a
        if periodic:
            return torch.roll(a, p, dims=axis)
        n = a.shape[axis]
        out = torch.zeros_like(a)
        if abs(p) < n:
            if p > 0:
                out.narrow(axis, p, n - p).copy_(a.narrow(axis, 0, n - p))
            else:
                out.narrow(axis, 0, n + p).copy_(a.narrow(axis, -p, n + p))
        return out

    for r0, rh, rps, roff in bands(M, TY):
        for c0, cw, cps, coff in bands(M, tx):
            band = t[:, :, :, r0 : r0 + rh, c0 : c0 + cw]
            band = shift(band, 1, rps)
            band = shift(band, 2, cps)
            img[:, :, roff : roff + rh, :, coff : coff + cw] += band.permute(0, 1, 3, 2, 4)

    img = img.reshape(n_fields, n_tiles_y * TY, n_tiles_x * tx)
    return img[:, :ny, :nx]


def _render_level(
    geom: _LevelGeometry, spec: MapSpec, kernel: str, projection: str,
    u: Tensor, v: Tensor, h: Tensor, values: Tensor, tile: Tensor,
    plain: bool = False,
) -> Tensor:
    """(F, ny, nx) image of one level's tile-sorted segment."""
    ny, nx = spec.shape
    x0, x1, y0, y1 = spec.extent
    pstart, pcount = tile_ranges(tile, geom.n_tiles)
    tiles = (deposit_tiles_plain if plain else deposit_tiles)(
        u, v, h, values, pstart, pcount, cfg=geom.cfg, kernel=kernel,
        projection=projection, psx=(x1 - x0) / nx, psy=(y1 - y0) / ny,
        offset=spec.sample_offset,
    )
    return _overlap_add(
        tiles, geom.cfg, geom.tx, geom.n_tiles_y, geom.n_tiles_x,
        values.shape[0], ny, nx, spec.periodic_wrap,
    )


# ---------------------------------------------------------------------------
# Inputs and assignment
# ---------------------------------------------------------------------------


def _is_host_f64(x) -> bool:
    return isinstance(x, np.ndarray) and x.dtype == np.float64


def _is_f64(x) -> bool:
    return _is_host_f64(x) or (isinstance(x, Tensor) and x.dtype == torch.float64)


def _coords(x, y, device) -> tuple[Tensor, Tensor]:
    """World coordinates for assignment: f64 coordinates stay f64 (host
    NumPy on the CPU: the quality path; an f64 tensor on its own device),
    so the tile-local f32 coordinates carry f64's precision; anything else
    becomes f32 on ``device``."""
    if _is_host_f64(x):
        return torch.from_numpy(x), torch.from_numpy(np.asarray(y, np.float64))
    if _is_f64(x):
        return x, torch.as_tensor(y, dtype=torch.float64, device=x.device)
    if not isinstance(x, Tensor):
        x, y = np.asarray(x), np.asarray(y)
    return (
        torch.as_tensor(x, dtype=torch.float32, device=device),
        torch.as_tensor(y, dtype=torch.float32, device=device),
    )


def _pixel_coords(x: Tensor, y: Tensor, spec: MapSpec) -> tuple[Tensor, Tensor]:
    ny, nx = spec.shape
    x0, x1, y0, y1 = (float(e) for e in spec.extent)
    u = (x - x0) / ((x1 - x0) / nx)
    v = (y - y0) / ((y1 - y0) / ny)
    if spec.periodic_wrap:
        u = torch.remainder(u, nx)
        v = torch.remainder(v, ny)
    return u, v


def _tile_local_coords(x: Tensor, y: Tensor, geom: _LevelGeometry, spec: MapSpec):
    """(tile id, tile-local f32 pixel coords) for one level's geometry,
    computed in the dtype of ``x``. Host f64 coordinates (the quality path)
    go through the native assignment, which equals this formulation bit for
    bit."""
    cfg, tx = geom.cfg, geom.tx
    if _on_host_f64(x):
        geom_tuples = ((geom.n_tiles_x,), (cfg.TY,), (tx,), (geom.n_tiles_y,), (cfg.M,))
        # one level that takes every particle: s_pix = 0 never exceeds it
        zero_h = torch.zeros(x.shape[0], dtype=torch.float32)
        return _native_assign(x, y, zero_h, spec, 0.0, (math.inf,), geom_tuples)
    u, v = _pixel_coords(x, y, spec)
    tx_i = torch.clamp((u / tx).to(torch.int32), 0, geom.n_tiles_x - 1)
    ty_i = torch.clamp((v / cfg.TY).to(torch.int32), 0, geom.n_tiles_y - 1)
    tile_id = ty_i * geom.n_tiles_x + tx_i
    u_loc = (u - (tx_i * tx - cfg.M)).to(torch.float32)
    v_loc = (v - (ty_i * cfg.TY - cfg.M)).to(torch.float32)
    return tile_id, u_loc, v_loc


def _on_host_f64(x: Tensor) -> bool:
    return x.device.type == "cpu" and x.dtype == torch.float64


def _assign_keys(xs: Tensor, ys: Tensor, h: Tensor, spec: MapSpec, support_factor: float, bounds, geom_tuples):
    """(composite key level * LEVEL_STRIDE + tile, tile-local f32 u, v) per
    particle, in the dtype and on the device of ``xs``: the plain version
    of the native host assignment (:func:`_native_assign`)."""
    # s_pix from the f32 smoothing lengths, in the coordinates' precision
    s_pix = support_factor * h.to(xs.device, xs.dtype) / min(spec.pixel_size)
    u, v = _pixel_coords(xs, ys, spec)
    level, tile, u_loc, v_loc = _multi_level_assign(u, v, s_pix, bounds, *geom_tuples)
    return level * LEVEL_STRIDE + tile, u_loc.to(torch.float32), v_loc.to(torch.float32)


def _native_assign(xs: Tensor, ys: Tensor, h: Tensor, spec: MapSpec, support_factor: float, bounds, geom_tuples):
    """:func:`_assign_keys` of host f64 coordinates in one pass of the
    native library (``native/hostops.c``), bit for bit."""
    from .. import native

    ny, nx = spec.shape
    x0, x1, y0, y1 = (float(e) for e in spec.extent)
    ntx, ty, tx, nty, marg = geom_tuples
    key, u_loc, v_loc = native.assign_tiles_f64(
        xs.numpy(), ys.numpy(), h.to("cpu", torch.float32).numpy(),
        x0=x0, y0=y0, psx=(x1 - x0) / nx, psy=(y1 - y0) / ny, nx=nx, ny=ny,
        periodic=spec.periodic_wrap, support_factor=support_factor,
        bounds=bounds, ntx=ntx, nty=nty, tw=tx, th=ty, marg=marg, stride=LEVEL_STRIDE,
    )
    return torch.from_numpy(key), torch.from_numpy(u_loc), torch.from_numpy(v_loc)


def _multi_level_assign(u, v, s_pix, bounds, n_tiles_x_t, ty_t, tx_t, n_tiles_y_t, m_t):
    """(level, tile id, tile-LOCAL coords) per particle, each under its own
    level's geometry. Oversize/disabled-level particles keep GLOBAL pixel
    coordinates (tile 0) so the dense fallback can recover world positions.
    Runs in the dtype and on the device of ``u``."""
    n_levels = len(bounds)
    level = torch.full(u.shape, n_levels, dtype=torch.int32, device=u.device)
    for li in range(n_levels - 1, -1, -1):
        if bounds[li] >= 0:
            level = torch.where(s_pix <= bounds[li], li, level)
    tile = torch.zeros(u.shape, dtype=torch.int32, device=u.device)
    u_loc = u
    v_loc = v
    for li in range(n_levels):
        if bounds[li] < 0:
            continue
        tx_i = torch.clamp((u / tx_t[li]).to(torch.int32), 0, n_tiles_x_t[li] - 1)
        ty_i = torch.clamp((v / ty_t[li]).to(torch.int32), 0, n_tiles_y_t[li] - 1)
        sel = level == li
        tile = torch.where(sel, ty_i * n_tiles_x_t[li] + tx_i, tile)
        u_loc = torch.where(sel, u - (tx_i * tx_t[li] - m_t[li]), u_loc)
        v_loc = torch.where(sel, v - (ty_i * ty_t[li] - m_t[li]), v_loc)
    return level, tile, u_loc, v_loc


# ---------------------------------------------------------------------------
# Single-level entry point
# ---------------------------------------------------------------------------


def deposit_2d_pallas(
    x, y, h, values, spec: MapSpec,
    *,
    kernel: str = "cubic_spline",
    precision: str = "bf16x2",
    level: Optional[PallasDepositConfig] = None,
    projection: str = "kernel3d",
    device="cuda",
) -> Tensor:
    """Single-level tiled deposit (name kept from the JAX package).

    f64 NumPy coordinates take the quality path (tile-local coordinates
    computed in f64 on the host); anything else is converted to f32 on
    ``device``. Every particle footprint must fit the level's K-window
    (``support_factor * h / pixel <= level.max_s_pix``); mixed-footprint
    callers should use :func:`deposit_2d_auto`. Returns (ny, nx) or
    (F, ny, nx) on ``device``.
    """
    cfg = level or PALLAS_LEVELS[0]
    check_precision(precision)
    get_kernel(kernel)
    device = torch.device(device)
    values, single = as_field_matrix(values, device, _MAX_FIELDS)
    geom, *layout = _level_layout(x, y, h, values, spec, cfg, device)
    img = _render_level(geom, spec, kernel, projection, *layout)
    return img[0] if single else img


def _level_layout(x, y, h, values: Tensor, spec: MapSpec, cfg: PallasDepositConfig, device):
    """One level's tile-sorted particles as :func:`deposit_2d_pallas`
    renders them: (geom, u, v, h, values (F, N), tile), sorted by tile."""
    geom = _level_geometry(cfg, spec)
    xs, ys = _coords(x, y, device)
    tile_id, u_loc, v_loc = _tile_local_coords(xs, ys, geom, spec)
    h = torch.as_tensor(h if isinstance(h, Tensor) else np.asarray(h), dtype=torch.float32, device=device)
    tile_sorted, perm = torch.sort(tile_id.to(device), stable=True)
    return (geom, u_loc.to(device)[perm], v_loc.to(device)[perm], h[perm], values[:, perm].contiguous(),
            tile_sorted)


# ---------------------------------------------------------------------------
# Multi-level layout (TiledParticles)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TiledParticles:
    """Device-resident multi-level tile-sorted particle layout.

    Built once per (particle set, extent) by :func:`tile_particles`; every
    field rendered from the same positions reuses the sorted layout — a new
    field is a gather through ``perm``, not a re-sort (``with_values``).
    Arrays hold exactly the real particles, (level, tile)-sorted.
    """

    spec: MapSpec
    kernel: str
    geoms: tuple  # per populated level: (_LevelGeometry, lo, count)
    sorted_u: Tensor  # (N,) tile-local pixel coords; global for oversize
    sorted_v: Tensor
    sorted_h: Tensor
    sorted_values: Tensor  # (F, N)
    sorted_tile: Tensor  # (N,) int32 tile id within the particle's own level
    perm: Optional[Tensor]  # (N,) original index of each sorted slot; None
    # when built with need_perm=False (with_values is then unavailable)
    n_sorted: int  # sorted length N
    n_oversize: int  # trailing segment routed to the oversize route
    n_valid: int  # real particle count

    @property
    def n_fields(self) -> int:
        return self.sorted_values.shape[0]

    def with_values(self, values) -> "TiledParticles":
        """Same layout, new deposit payloads (gather, no re-sort)."""
        if self.perm is None:
            raise ValueError(
                "layout was built with need_perm=False; rebuild with "
                "tile_particles(..., need_perm=True) to re-render new fields"
            )
        values, _ = as_field_matrix(values, self.sorted_values.device, _MAX_FIELDS)
        n = values.shape[1]
        if n != self.n_valid:
            raise ValueError(f"expected {self.n_valid} per-particle values, got {n}")
        if self.perm.shape[0] > n:  # a carried-over layout may hold pad slots
            values = torch.nn.functional.pad(values, (0, self.perm.shape[0] - n))
        return TiledParticles(
            spec=self.spec, kernel=self.kernel, geoms=self.geoms,
            sorted_u=self.sorted_u, sorted_v=self.sorted_v, sorted_h=self.sorted_h,
            sorted_values=values[:, self.perm].contiguous(),
            sorted_tile=self.sorted_tile, perm=self.perm,
            n_sorted=self.n_sorted, n_oversize=self.n_oversize,
            n_valid=self.n_valid,
        )


def _level_geometries(spec: MapSpec, levels) -> list[Optional[_LevelGeometry]]:
    """Geometry per level; a level that cannot tile this (small/periodic)
    map is None and routes its particles to the oversize route."""
    geoms: list[Optional[_LevelGeometry]] = []
    for cfg in levels:
        try:
            geoms.append(_level_geometry(cfg, spec))
        except ValueError:
            geoms.append(None)
    # composite sort keys are level * LEVEL_STRIDE + tile: a level whose
    # tile count reaches the stride would alias into the next level's keys
    for g in geoms:
        if g is not None and g.n_tiles >= LEVEL_STRIDE:
            raise ValueError(
                f"{g.n_tiles} tiles at the K={g.cfg.K} level exceed the "
                f"composite-key stride ({LEVEL_STRIDE}); render this map "
                "in sub-extents (the adaptive tile layout caps at "
                "2^22 tiles per level)"
            )
    return geoms


def _assign_setup(spec: MapSpec, levels):
    """(geometry per level or None, each level's footprint bound, the
    per-level geometry tuples of :func:`_multi_level_assign`)."""
    geoms = _level_geometries(spec, levels)
    bounds = tuple((g.cfg.max_s_pix if g is not None else -1.0) for g in geoms)
    geom_tuples = (
        tuple(g.n_tiles_x if g else 1 for g in geoms),
        tuple(g.cfg.TY if g else 1 for g in geoms),
        tuple(g.tx if g else 1 for g in geoms),
        tuple(g.n_tiles_y if g else 1 for g in geoms),
        tuple(g.cfg.M if g else 0 for g in geoms),
    )
    return geoms, bounds, geom_tuples


def tile_particles(
    x, y, h, values, spec: MapSpec,
    *,
    kernel: str = "cubic_spline",
    levels: tuple[PallasDepositConfig, ...] = PALLAS_LEVELS,
    need_perm: bool = True,
    layout: str = "auto",
    device="cuda",
) -> TiledParticles:
    """Build the multi-level layout on ``device``.

    Each particle is assigned a footprint level (by ``support_factor * h`` in
    pixels) and its tile id under that level's geometry, then grouped by the
    composite key so every level's segment is internally tile-sorted. The
    only host sync is the handful of per-level counts.

    ``layout`` picks the grouping on the device path: ``"sort"`` (and
    ``"auto"``) sort the composite key; ``"shear"`` groups with the two-pass
    row-sort / band-sort / gang-append layout (:mod:`.layout_shear`, CUDA
    kernel ``csrc/layout_shear.cu``), whose level segments carry
    interleaved zero-value pad slots that the counts, ``n_sorted`` and
    ``n_oversize`` include (pads re-gather as 0 in :meth:`with_values`).
    f64 coordinates keep the sort whatever ``layout`` says.
    """
    with span("layout.sorted") as sp:
        if layout not in ("auto", "sort", "shear"):
            raise ValueError(f"unknown layout {layout!r}; expected 'auto', 'sort' or 'shear'")
        kspec = get_kernel(kernel)
        device = torch.device(device)
        values, _ = as_field_matrix(values, device, _MAX_FIELDS)
        geoms, bounds, geom_tuples = _assign_setup(spec, levels)
        xs, ys = _coords(x, y, device)
        h = torch.as_tensor(h if isinstance(h, Tensor) else np.asarray(h), dtype=torch.float32)
        n_valid = int(h.shape[0])
        if layout == "shear" and xs.dtype != torch.float64:
            assign, level_n_tiles = _shear_assign(spec, kspec.support_factor, geoms, bounds, geom_tuples)
            s_tile, su, sv, sh, s_values, perm, counts = shear_tile_sort(
                None, None, None, h.to(device), values, raw_xy=(xs, ys), assign=assign,
                level_stride=LEVEL_STRIDE, level_n_tiles=level_n_tiles,
                n_fields=values.shape[0], need_perm=need_perm, n_valid=n_valid,
            )
            # the counts include the interleaved pad slots: the data region is
            # their total, not the input length
            counts = counts.tolist()  # host sync: a few ints
            perm = None if perm is None else perm.long()
        else:
            # host f64 coordinates (the quality path): one native pass, bit for
            # bit the torch formulation that every other input takes
            assign = _native_assign if _on_host_f64(xs) else _assign_keys
            key, u_loc, v_loc = assign(xs, ys, h, spec, kspec.support_factor, bounds, geom_tuples)
            key = key.to(device)

            sorted_key, perm = torch.sort(key, stable=True)
            del key
            su = u_loc.to(device)[perm]
            sv = v_loc.to(device)[perm]
            del u_loc, v_loc
            sh = h.to(device)[perm]
            s_values = values[:, perm].contiguous()
            lv = torch.arange(len(geoms) + 2, dtype=sorted_key.dtype, device=device) * LEVEL_STRIDE
            starts = torch.searchsorted(sorted_key, lv).tolist()  # host sync: a few ints
            counts = [starts[i + 1] - starts[i] for i in range(len(geoms) + 1)]
            s_tile = torch.remainder(sorted_key, LEVEL_STRIDE).to(torch.int32)
            perm = perm if need_perm else None

        level_meta = []
        lo = 0
        for li, g in enumerate(geoms):
            c = counts[li]
            if g is not None and c > 0:
                level_meta.append((g, lo, c))
            lo += c
        sp.count(particles=n_valid, n_oversize=counts[len(geoms)], **{f"K{g.cfg.K}": c for g, _, c in level_meta})
        return TiledParticles(
            spec=spec, kernel=kernel, geoms=tuple(level_meta),
            sorted_u=su, sorted_v=sv, sorted_h=sh, sorted_values=s_values,
            sorted_tile=s_tile, perm=perm,
            n_sorted=sum(counts), n_oversize=counts[len(geoms)],
            n_valid=n_valid,
        )


def _shear_assign(spec: MapSpec, support_factor: float, geoms, bounds, geom_tuples):
    """The fine (level, tile) assignment of the shear layout: an
    ``assign(x, y, h)`` returning the COMPACT key ``bases[level] + tile``
    (the oversize key last) and the tile-local coordinates, by the sorted
    engine's own ``_pixel_coords`` and ``_multi_level_assign``; and the
    per-level tile counts (0 for a level that cannot tile the map)."""
    level_n_tiles = tuple((g.n_tiles if g is not None else 0) for g in geoms)
    key_bases = tuple(int(b) for b in np.concatenate([[0], np.cumsum(level_n_tiles)]))

    def assign(x, y, h):
        u, v = _pixel_coords(x, y, spec)
        s_pix = support_factor * h / min(spec.pixel_size)
        level, tile, u_loc, v_loc = _multi_level_assign(u, v, s_pix, bounds, *geom_tuples)
        return device_const(key_bases, torch.int32, x.device)[level] + tile, u_loc, v_loc

    return assign, level_n_tiles


def tiled_particles_from_arrays(
    spec: MapSpec,
    kernel: str,
    geoms: Sequence[tuple[int, int, int, int]],
    sorted_u, sorted_v, sorted_h, sorted_values, sorted_tile, perm,
    n_sorted: int,
    n_oversize: int,
    n_valid: int,
    *,
    device="cuda",
) -> TiledParticles:
    """Carry a layout built elsewhere (e.g. by the JAX package's
    ``tile_particles``) into a :class:`TiledParticles` on ``device``.

    ``geoms`` holds one ``(K, TY, lo, count)`` per populated level; the
    arrays are NumPy (or tensors) whose first ``n_sorted`` entries are the
    sorted layout — any trailing slack is dropped here. Pad slots inside the
    counts (zero-valued particles) are kept and deposit nothing.
    """
    device = torch.device(device)

    def arr(a, dtype):
        a = a if isinstance(a, Tensor) else torch.from_numpy(np.array(a))
        return a[..., :n_sorted].to(device=device, dtype=dtype).contiguous()

    level_meta = tuple(
        (_level_geometry(PallasDepositConfig(K=int(K), TY=int(TY)), spec), int(lo), int(c))
        for K, TY, lo, c in geoms
    )
    return TiledParticles(
        spec=spec, kernel=kernel, geoms=level_meta,
        sorted_u=arr(sorted_u, torch.float32), sorted_v=arr(sorted_v, torch.float32),
        sorted_h=arr(sorted_h, torch.float32),
        sorted_values=arr(sorted_values, torch.float32),
        sorted_tile=arr(sorted_tile, torch.int32),
        perm=None if perm is None else arr(perm, torch.int64),
        n_sorted=int(n_sorted), n_oversize=int(n_oversize), n_valid=int(n_valid),
    )


def deposit_tiled(
    tp: TiledParticles,
    *,
    precision: str = "bf16x2",
    projection: str = "kernel3d",
    plain: bool = False,
) -> Tensor:
    """Render the full adaptive-h map stack from a :class:`TiledParticles`
    layout, on the layout's device. Every populated level goes through
    :func:`deposit_tiles`; oversize-footprint stragglers (footprint > the
    largest K-window) go through the oversize route
    (:func:`.deposit_wide.deposit_wide`). Returns (F, ny, nx). ``precision``
    is validated; the sums are f32 throughout (see :func:`deposit_tiles`).
    ``plain=True`` runs every level through :func:`deposit_tiles_plain` and
    the oversize stragglers through :func:`.deposit_wide.deposit_wide_plain`
    on any device: the reference the kernels are checked against on the
    card.
    """
    check_precision(precision)
    ny, nx = tp.spec.shape
    dev = tp.sorted_u.device
    total = torch.zeros((tp.n_fields, ny, nx), dtype=torch.float32, device=dev)
    launches, register_launches = deposit_tiles.launches, deposit_tiles.register_launches
    with span("deposit.levels", particles=sum(count for _, _, count in tp.geoms)) as sp:
        for geom, lo, count in tp.geoms:
            sl = slice(lo, lo + count)
            total += _render_level(
                geom, tp.spec, tp.kernel, projection,
                tp.sorted_u[sl], tp.sorted_v[sl], tp.sorted_h[sl],
                tp.sorted_values[:, sl], tp.sorted_tile[sl], plain,
            )
        sp.count(launches=deposit_tiles.launches - launches,
                 register_launches=deposit_tiles.register_launches - register_launches)

    if tp.n_oversize:
        # oversize stragglers live at the end of the sorted layout with
        # global pixel coordinates: the oversize route on the same device
        with span("deposit.oversize", particles=tp.n_oversize):
            sl = slice(tp.n_sorted - tp.n_oversize, tp.n_sorted)
            route = deposit_wide_plain if plain else deposit_wide
            route(tp.sorted_u[sl], tp.sorted_v[sl], tp.sorted_h[sl], tp.sorted_values[:, sl], tp.spec,
                  kernel=tp.kernel, projection=projection, out=total)
    return total


def deposit_2d_auto(
    x, y, h, values, spec: MapSpec,
    *,
    kernel: str = "cubic_spline",
    precision: Optional[str] = None,
    projection: str = "kernel3d",
    device="cuda",
    plain: bool = False,
) -> Tensor:
    """Adaptive-h deposit: level/tile partition (one sort), one kernel pass
    per populated footprint level, oversize stragglers routed to the
    oversize route.

    ``projection``: 'kernel3d' reproduces the reference convention (3D kernel
    at the projected radius); 'integrated' uses the analytically
    line-integrated kernel (physically-correct column densities).
    ``precision`` defaults to 'bf16x3' for f64 coordinates and 'bf16x2'
    otherwise, as in the JAX package; it is validated, and the sums are f32
    for every choice. ``plain`` is passed to :func:`deposit_tiled`.
    Returns (ny, nx) for single-field input, else (F, ny, nx), on ``device``.
    """
    if precision is None:
        precision = "bf16x3" if _is_f64(x) else "bf16x2"
    check_precision(precision)
    values, single = as_field_matrix(values, device, _MAX_FIELDS)
    tp = tile_particles(x, y, h, values, spec, kernel=kernel, device=device)
    total = deposit_tiled(tp, precision=precision, projection=projection, plain=plain)
    return total[0] if single else total
