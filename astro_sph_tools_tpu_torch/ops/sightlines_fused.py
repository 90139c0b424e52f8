"""Fused sightline engine: per-ray columns through a hand-written CUDA kernel.

Counterpart: ``astro_sph_tools_tpu/ops/sightlines_pallas.py`` (public name
``column_integrate_pallas`` kept). The pipeline and its values are the JAX
engine's; its TPU workarounds are gone:

1. **Level/cell partition** (device): each particle gets a footprint level
   (support halving per level) and a cell under that level's grid (cells at
   least the level's max support, so a ray's candidates lie in its own and
   the 1-ring cells); one ``torch.sort`` of the int32 composite key
   ``level * 2^25 + cell`` and one gather leave every level's cell rows
   contiguous in a (channels, N) array, and ``torch.searchsorted`` gives the
   per-cell bounds table.
2. **Ray blocks** (host, NumPy): per populated level the rays are
   cell-sorted and cut into blocks of ``B``; each block's candidates are up
   to ``_U = 10`` [lo, hi) spans — the x-windowed 1-ring of its rays' cells
   per wrapped row, plus an x-wrap span (:func:`_level_schedule`). Copying
   the bounds table to the host is the one host sync of a call besides the
   smoothing-length maximum, as in the JAX engine.
3. **One kernel pass** over every level's ray blocks: :func:`columns_tiles`
   (``csrc/sightlines.cu``, TPU kernel #4) gives each block's (B, F)
   column totals; one ``index_add_`` per populated level takes them back to
   the caller's ray order and sums the levels.

The TPU kernel's packed 24-bit schedule words, empty-unit compaction and
power-of-two step padding existed for its SMEM and its sequential grid; the
pow2 particle padding for its compiled-program cache. None is ported: the
kernel reads the (n_blocks, 10) span table directly, one thread block per
ray block.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from .. import _build
from ..kernels.splines import clenshaw, get_kernel, integrated_kernel_chebyshev
from .deposit_tiled import device_const
from .sightlines import _f32, _host

Tensor = torch.Tensor

_B = 8  # rays per block (the column kernel's register tile)
_U = 10  # spans per ray block: 5 wrapped rows x (main + x-wrap)
_LEVEL_STRIDE = 1 << 25  # composite key: level * STRIDE + cell id
_MAX_LEVELS = 6
_MAX_GRID = 4096
_MAX_CELLS = 1 << 20  # per-level cell cap (bounds table stays searchable)
_MAX_FIELDS = 5
_RAY_BATCH = 1 << 20  # rays per pass; larger ray sets are processed in batches


def _choose_grids(Lx: float, Ly: float, s_max: float) -> tuple[tuple[int, int], ...]:
    """Per-level (ncx, ncy): power-of-two grids whose cells are >= the
    level's max support ``s_max / 2^level`` (so 1-ring coverage holds), as
    the JAX engine chooses them."""
    grids = []
    for l in range(_MAX_LEVELS):
        cell = max(s_max, 1e-30) / (1 << l)
        ncx = min(_MAX_GRID, max(1, 1 << int(np.floor(np.log2(max(Lx / cell, 1.0))))))
        ncy = min(_MAX_GRID, max(1, 1 << int(np.floor(np.log2(max(Ly / cell, 1.0))))))
        # keep the per-cell bounds table (ncx*ncy + 1 entries) tractable;
        # coarser-than-support cells only widen candidate windows (still
        # correct, 1-ring coverage is preserved)
        while ncx * ncy > _MAX_CELLS:
            if ncx >= ncy:
                ncx //= 2
            else:
                ncy //= 2
        grids.append((ncx, ncy))
    return tuple(grids)


# ---------------------------------------------------------------------------
# Device prep: composite (level, cell) sort + channel gather + bounds table
# ---------------------------------------------------------------------------


def _prep(x: Tensor, y: Tensor, h: Tensor, channels: Sequence[Tensor], grids, support_factor: float,
          extent: tuple[float, float, float, float], periodic: bool) -> tuple[Tensor, np.ndarray]:
    """Sorted (3 + C, N) f32 channels [x, y, h, *channels] and the host
    per-cell bounds table: level l contributes ncx*ncy + 1 entries, cell c's
    particles are [bounds[c], bounds[c + 1])."""
    x0, y0, Lx, Ly = extent
    if periodic:
        x = x - torch.floor(x / Lx) * Lx + x0
        y = y - torch.floor(y / Ly) * Ly + y0
    s = support_factor * h
    # finest level whose cells (both axes) still cover the support
    level = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for l in range(1, len(grids)):
        ncx, ncy = grids[l]
        # 0.999: a hair of slack so f32 cell assignment (vs the rays' f64
        # host cells) cannot break 1-ring coverage at s == cell
        level = torch.where(s <= 0.999 * min(Lx / ncx, Ly / ncy), l, level)
    cid = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for l, (ncx, ncy) in enumerate(grids):
        cx = torch.clamp(((x - x0) * (ncx / Lx)).to(torch.int32), 0, ncx - 1)
        cy = torch.clamp(((y - y0) * (ncy / Ly)).to(torch.int32), 0, ncy - 1)
        cid = torch.where(level == l, cy * ncx + cx, cid)
    key = level * _LEVEL_STRIDE + cid
    del level, cid, s
    sorted_key, perm = torch.sort(key)  # grouping needs key order only
    packed = torch.stack([x, y, h, *channels])[:, perm].contiguous()
    bound_keys = np.concatenate([
        l * _LEVEL_STRIDE + np.arange(g[0] * g[1] + 1, dtype=np.int64) for l, g in enumerate(grids)
    ]).astype(np.int32)
    bk = torch.as_tensor(bound_keys, device=x.device)
    bounds = torch.searchsorted(sorted_key, bk).to(torch.int32).cpu().numpy()  # host sync
    return packed, bounds


# ---------------------------------------------------------------------------
# Host schedule: per ray block, up to _U [lo, hi) spans
# ---------------------------------------------------------------------------


def _level_schedule(r_rows, r_cols, cells, ncx: int, ncy: int, periodic: bool, B: int = _B):
    """Per-block (lo, hi) sorted-particle spans for one level's ray blocks,
    ``_U`` per block, (nb, _U) each.

    A block of ``B`` cell-sorted rays covers rows [r0-1, r1+1] and the x
    window [cx_min-1, cx_max+1]. Narrow blocks (<= 3 raw rows, the common
    case) emit per-row X-WINDOWED spans — up to 5 wrapped rows x (main +
    x-wrap) — which is what makes small ray blocks pay: the window is a few
    cells, not the full row. Wide blocks (coarse grids where few rays share
    a row) take one contiguous full-row span + y-wrap rows.

    ``cells`` is the level's per-cell boundary table (ncx*ncy + 1,).
    """
    nb = r_rows.shape[0] // B
    rr = r_rows.reshape(nb, B).astype(np.int64)
    rc = r_cols.reshape(nb, B).astype(np.int64)
    r0, r1 = rr[:, 0], rr[:, -1]  # rows are non-decreasing within a block
    cxlo = rc.min(axis=1) - 1
    cxhi = rc.max(axis=1) + 1
    full_x = (cxhi - cxlo + 1) >= ncx
    narrow = (r1 - r0) <= 2

    cells = cells.astype(np.int64)
    row_start = cells[np.arange(ncy, dtype=np.int64) * ncx]
    row_end = cells[(np.arange(ncy, dtype=np.int64) + 1) * ncx]

    lo = np.zeros((nb, _U), np.int64)
    hi = np.zeros((nb, _U), np.int64)

    # --- narrow blocks: per-row x-windowed spans ---------------------------
    a = np.where(full_x, 0, np.maximum(cxlo, 0))
    b = np.where(full_x, ncx - 1, np.minimum(cxhi, ncx - 1))
    # x-wrap window (periodic, not full width; an interval can only stick
    # out on ONE side without covering the whole row)
    wa = np.where(cxlo < 0, ncx + cxlo, 0)
    wb = np.where(cxlo < 0, ncx - 1, cxhi - ncx)
    x_wrap = (~full_x) & ((cxlo < 0) | (cxhi > ncx - 1)) if periodic else np.zeros(nb, bool)
    n_raw = r1 - r0 + 3  # raw 1-ring row count (distinct before wrapping)
    for i in range(5):
        rr_i = r0 - 1 + i
        if periodic:
            # first min(n_raw, ncy) consecutive rows stay distinct mod ncy
            act = narrow & (i < np.minimum(n_raw, ncy))
            wr = np.mod(rr_i, ncy)
        else:
            act = narrow & (i < n_raw) & (rr_i >= 0) & (rr_i < ncy)
            wr = np.clip(rr_i, 0, ncy - 1)
        base = wr * ncx
        mlo = cells[base + a]
        mhi = cells[base + b + 1]
        lo[:, 2 * i] = np.where(act, mlo, 0)
        hi[:, 2 * i] = np.where(act, np.maximum(mhi, mlo), 0)
        if periodic:
            wlo = cells[base + np.clip(wa, 0, ncx - 1)]
            whi = cells[base + np.clip(wb, -1, ncx - 1) + 1]
            actw = act & x_wrap
            lo[:, 2 * i + 1] = np.where(actw, wlo, 0)
            hi[:, 2 * i + 1] = np.where(actw, np.maximum(whi, wlo), 0)

    # --- wide blocks: contiguous full-row span + y wraps -------------------
    wide = ~narrow
    if wide.any():
        loA = row_start[np.maximum(r0 - 1, 0)]
        hiA = row_end[np.minimum(r1 + 1, ncy - 1)]
        lo[wide, 0] = loA[wide]
        hi[wide, 0] = np.maximum(hiA, loA)[wide]
        if periodic:
            top = wide & (r0 == 0) & (r1 + 1 < ncy - 1)
            bot = wide & (r1 == ncy - 1) & (r0 - 1 > 0)
            lo[top, 1] = row_start[ncy - 1]
            hi[top, 1] = max(row_end[ncy - 1], row_start[ncy - 1])
            lo[bot, 2] = row_start[0]
            hi[bot, 2] = max(row_end[0], row_start[0])
        lo[wide, 3:] = 0
        hi[wide, 3:] = 0

    return lo, hi


def _stage_ray_levels(rays, grids, bounds, x0, y0, Lx, Ly, periodic, B, n_rays):
    """Per populated level: cell-sort the rays and build the x-windowed
    block spans (shared by the columns and spectra engines).

    Returns (rorders, rx_blocks, ry_blocks, lo, hi): the per-level ray sort
    orders, the ray blocks (n_pop * nb, B) f32 and their spans
    (n_pop * nb, _U) int64, nb = ceil(n_rays / B) blocks per level, stacked
    over levels in level order; rorders is empty when no level holds
    particles.
    """
    nb = max(1, (n_rays + B - 1) // B)
    r_pad = nb * B
    rorders, rx_parts, ry_parts, lo_parts, hi_parts = [], [], [], [], []
    boff = 0
    for l in range(_MAX_LEVELS):
        ncx, ncy = grids[l]
        cells = bounds[boff: boff + ncx * ncy + 1]
        boff += ncx * ncy + 1
        if int(cells[-1]) - int(cells[0]) == 0:
            continue
        rcx = np.clip(((rays[0] - x0) * (ncx / Lx)).astype(np.int64), 0, ncx - 1)
        rcy = np.clip(((rays[1] - y0) * (ncy / Ly)).astype(np.int64), 0, ncy - 1)
        rorder = np.argsort(rcy * ncx + rcx, kind="stable")
        # pad the last block with copies of the last ray (their results are
        # dropped at the unsort)
        pad = np.concatenate([rorder, np.full(r_pad - n_rays, rorder[-1])])
        lo, hi = _level_schedule(rcy[pad], rcx[pad], cells, ncx, ncy, periodic, B=B)
        rorders.append(rorder)
        rx_parts.append(rays[0][pad].astype(np.float32).reshape(nb, B))
        ry_parts.append(rays[1][pad].astype(np.float32).reshape(nb, B))
        lo_parts.append(lo)
        hi_parts.append(hi)
    if not rorders:
        return [], None, None, None, None
    return (
        rorders, np.concatenate(rx_parts), np.concatenate(ry_parts),
        np.concatenate(lo_parts), np.concatenate(hi_parts),
    )


@dataclass(frozen=True)
class RayLayout:
    """Device inputs of one fused pass (columns or spectra): the sorted
    particle channels, the ray blocks of every populated level and their
    candidate spans, and what it takes to return to the caller's ray order."""

    packed: Tensor  # (3 + C, N) f32: x, y, h, channels..., (level, cell)-sorted
    rx: Tensor  # (n_blocks, B) f32 ray coordinates per block
    ry: Tensor
    lo: Tensor  # (n_blocks, _U) int32 span starts into packed's columns
    hi: Tensor  # (n_blocks, _U) int32 span ends (lo == hi: empty)
    rorders: tuple  # per populated level: (n_rays,) int64 caller index of each sorted ray
    n_rays: int
    periodic: bool
    Lx: float
    Ly: float

    @property
    def n_blocks(self) -> int:
        return self.rx.shape[0]


def _domain(x: Tensor, y: Tensor, h: Tensor, rays: np.ndarray, S: float, periodic_box):
    """(rays, x0, y0, Lx, Ly, s_max): the periodic box, or the bounding box of
    particles and rays padded by the largest support. Reads the particles'
    extremes from the device in one copy."""
    n = h.shape[0]
    if n:
        if periodic_box is None:
            hmax, xmin, xmax, ymin, ymax = torch.stack(
                [h.max(), x.min(), x.max(), y.min(), y.max()]).tolist()
        else:
            hmax = float(h.max())
        s_max = S * hmax
    else:
        s_max = 1.0
    if periodic_box is not None:
        L = float(periodic_box)
        return np.mod(rays, L), 0.0, 0.0, L, L, s_max
    pad = s_max if n else 1.0
    x0 = min(xmin if n else 0.0, rays[0].min()) - pad
    y0 = min(ymin if n else 0.0, rays[1].min()) - pad
    Lx = max(xmax if n else 1.0, rays[0].max()) + pad - x0
    Ly = max(ymax if n else 1.0, rays[1].max()) + pad - y0
    return rays, x0, y0, Lx, Ly, s_max


def stage_rays(x: Tensor, y: Tensor, h: Tensor, channels: Sequence[Tensor], ray_x, ray_y, *,
               support_factor: float, periodic_box: Optional[float], B: int) -> Optional[RayLayout]:
    """Build a :class:`RayLayout` on the particles' device (None when no
    level holds a particle). ``x, y, h`` and each channel are (N,) f32."""
    dev = x.device
    n_rays = len(ray_x)
    rays = np.stack([_host(ray_x, np.float64), _host(ray_y, np.float64)])
    rays, x0, y0, Lx, Ly, s_max = _domain(x, y, h, rays, support_factor, periodic_box)
    grids = _choose_grids(Lx, Ly, s_max)
    periodic = periodic_box is not None
    packed, bounds = _prep(x, y, h, channels, grids, support_factor, (x0, y0, Lx, Ly), periodic)
    rorders, rxb, ryb, lo, hi = _stage_ray_levels(rays, grids, bounds, x0, y0, Lx, Ly, periodic, B, n_rays)
    if not rorders:
        return None
    return RayLayout(
        packed=packed,
        rx=torch.as_tensor(rxb, device=dev), ry=torch.as_tensor(ryb, device=dev),
        lo=torch.as_tensor(lo.astype(np.int32), device=dev),
        hi=torch.as_tensor(hi.astype(np.int32), device=dev),
        rorders=tuple(torch.as_tensor(r, device=dev) for r in rorders),
        n_rays=n_rays, periodic=periodic, Lx=Lx, Ly=Ly,
    )


def unsort_sum(out: Tensor, layout: RayLayout) -> Tensor:
    """(n_blocks, B, ...) per-block results -> (n_rays, ...) in the caller's
    ray order, summed over levels: one ``index_add_`` per populated level."""
    n_pop = len(layout.rorders)
    per_level = out.reshape(n_pop, -1, *out.shape[2:])
    total = torch.zeros((layout.n_rays, *out.shape[2:]), dtype=out.dtype, device=out.device)
    for i, rorder in enumerate(layout.rorders):
        total.index_add_(0, rorder, per_level[i, : layout.n_rays])
    return total


# ---------------------------------------------------------------------------
# The kernel (TPU kernel #4) and its plain torch version
# ---------------------------------------------------------------------------


def _span_entries(lo: Tensor, hi: Tensor) -> tuple[Tensor, Tensor]:
    """(block id, particle index) of every entry of every span, in order."""
    n_blocks, U = lo.shape
    counts = (hi.to(torch.int64) - lo.to(torch.int64)).clamp_min(0).reshape(-1)
    total = int(counts.sum())
    dev = lo.device
    seg0 = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    idx = torch.repeat_interleave(lo.reshape(-1).to(torch.int64), counts) + (
        torch.arange(total, device=dev) - seg0
    )
    blk = torch.repeat_interleave(torch.arange(n_blocks * U, device=dev) // U, counts)
    return blk, idx


def _pair_geometry(packed: Tensor, rx: Tensor, ry: Tensor, blk: Tensor, idx: Tensor,
                   periodic: bool, Lx: float, Ly: float):
    """(b2 (E, B), h (E,), inverse h (E,)) of each span entry against its
    block's rays, with the kernel's minimum-image arithmetic."""
    xs, ys, hs = packed[0, idx], packed[1, idx], packed[2, idx]
    dx = rx[blk] - xs[:, None]
    dy = ry[blk] - ys[:, None]
    if periodic:
        dx = dx - torch.round(dx * (1.0 / Lx)) * Lx
        dy = dy - torch.round(dy * (1.0 / Ly)) * Ly
    inv_h = torch.where(hs > 0.0, 1.0 / hs, 0.0)
    return dx * dx + dy * dy, hs, inv_h


def columns_tiles_plain(
    packed: Tensor, rx: Tensor, ry: Tensor, lo: Tensor, hi: Tensor,
    *,
    n_fields: int,
    kernel: str,
    projection: str,
    periodic: bool,
    Lx: float,
    Ly: float,
) -> Tensor:
    """Plain torch version of :func:`columns_tiles`: the same inputs and the
    same (n_blocks, B, F) f32 output, evaluated over every (span entry, ray)
    pair in blocks of 2^22 (CPU) or 2^25 (GPU) pairs."""
    kspec = get_kernel(kernel)
    S = kspec.support_factor
    n_blocks, B = rx.shape
    out = torch.zeros((n_blocks, B * n_fields), dtype=torch.float32, device=packed.device)
    blk_all, idx_all = _span_entries(lo, hi)
    cheb = integrated_kernel_chebyshev(kernel) if projection == "integrated" else None
    step = max(1, (1 << (22 if packed.device.type == "cpu" else 25)) // B)
    for c0 in range(0, blk_all.shape[0], step):
        blk, idx = blk_all[c0:c0 + step], idx_all[c0:c0 + step]
        b2, hs, inv_h = _pair_geometry(packed, rx, ry, blk, idx, periodic, Lx, Ly)
        inv_h = inv_h[:, None]
        if cheb is not None:
            inv_sh = inv_h * (1.0 / S)
            tq = b2 * (inv_sh * inv_sh)
            yv = clenshaw(2.0 * torch.clamp(tq, 0.0, 1.0) - 1.0, cheb)
            w = torch.where(tq < 1.0, yv * (inv_h * inv_h), 0.0)
        else:
            qn = torch.sqrt(b2) * inv_h
            fac = (kspec.norm_3d * inv_h) * (inv_h * inv_h)
            w = torch.where(qn < S, kspec.shape_q(qn) * fac, 0.0)
        w = torch.where((hs > 0.0)[:, None], w, 0.0)  # h <= 0: no contribution
        vals = packed[3:3 + n_fields, idx].T  # (E, F)
        out.index_add_(0, blk, (w[:, :, None] * vals[:, None, :]).reshape(-1, B * n_fields))
    return out.view(n_blocks, B, n_fields)


def _check_layout(packed: Tensor, rx: Tensor, ry: Tensor, lo: Tensor, hi: Tensor, B: int, n_chan: int) -> None:
    dev = packed.device
    if packed.dtype != torch.float32 or packed.ndim != 2 or packed.stride(1) != 1 or packed.shape[0] < n_chan:
        raise ValueError(f"packed must be a (>= {n_chan}, N) float32 tensor with unit column stride")
    for name, a in (("rx", rx), ("ry", ry)):
        if a.dtype != torch.float32 or a.device != dev or a.shape != (rx.shape[0], B) or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (n_blocks, {B}) float32 tensor on {dev}")
    for name, a in (("lo", lo), ("hi", hi)):
        if a.dtype != torch.int32 or a.device != dev or a.shape != (rx.shape[0], _U) or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (n_blocks, {_U}) int32 tensor on {dev}")
    if packed.shape[1] >= 2**31:
        raise ValueError("the sightline kernels index particles with int32")
    if lo.numel():
        lo_min, hi_max = torch.stack([lo.min(), hi.max()]).tolist()
        if lo_min < 0 or hi_max > packed.shape[1]:
            raise ValueError(f"spans [{lo_min}, {hi_max}) reach outside the {packed.shape[1]} particles")


def columns_tiles(
    packed: Tensor, rx: Tensor, ry: Tensor, lo: Tensor, hi: Tensor,
    *,
    n_fields: int,
    kernel: str,
    projection: str,
    periodic: bool,
    Lx: float,
    Ly: float,
) -> Tensor:
    """Column totals of every ray block, (n_blocks, B, F) f32.

    ``packed`` holds the (level, cell)-sorted channels [x, y, h, v_0 ..
    v_{F-1}] as rows; block ``k`` sums over the particles of its spans
    ``[lo[k, u], hi[k, u])`` against its rays ``(rx[k], ry[k])``. On a CUDA
    tensor this launches the hand-written kernel ``csrc/sightlines.cu``
    (built at first use) and raises if the build or the launch fails; on a
    CPU tensor it runs :func:`columns_tiles_plain`.
    """
    if projection not in ("kernel3d", "integrated"):
        raise ValueError(f"projection must be 'kernel3d' or 'integrated', got {projection!r}")
    if not 1 <= n_fields <= _MAX_FIELDS:
        raise ValueError(f"the column kernel takes 1..{_MAX_FIELDS} fields, got {n_fields}")
    args = dict(n_fields=n_fields, kernel=kernel, projection=projection, periodic=periodic, Lx=Lx, Ly=Ly)
    if packed.device.type == "cpu":
        return columns_tiles_plain(packed, rx, ry, lo, hi, **args)
    if packed.device.type != "cuda":
        raise ValueError(f"no sightline kernel for device {packed.device}")
    _check_layout(packed, rx, ry, lo, hi, _B, 3 + n_fields)
    kspec = get_kernel(kernel)
    n_blocks = rx.shape[0]
    out = torch.empty((n_blocks, _B, n_fields), dtype=torch.float32, device=packed.device)
    if n_blocks == 0:
        return out
    lib, _ = _build.load("sightlines")
    integrated = projection == "integrated"
    cheb = device_const(integrated_kernel_chebyshev(kernel), torch.float32, packed.device) if integrated else None
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        code = lib.sightline_columns_launch(
            packed.data_ptr(), packed.stride(0), n_fields,
            rx.data_ptr(), ry.data_ptr(), lo.data_ptr(), hi.data_ptr(), n_blocks,
            out.data_ptr(), int(periodic), float(Lx), float(Ly),
            kspec.kernel_id, int(integrated), float(kspec.norm_3d), float(kspec.support_factor),
            cheb.data_ptr() if integrated else None, cheb.numel() if integrated else 0,
            stream,
        )
    if code != 0:
        raise RuntimeError(
            f"sightline columns kernel launch failed: {lib.cuda_error_string(code).decode()} ({code})"
        )
    columns_tiles.launches += 1
    return out


#: kernel launches made by :func:`columns_tiles` in this process (CUDA only)
columns_tiles.launches = 0


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def column_integrate_pallas(
    x, y, h, values, ray_x, ray_y,
    *,
    kernel: str = "cubic_spline",
    projection: str = "integrated",
    periodic_box: Optional[float] = None,
    device="cuda",
) -> Tensor:
    """Per-ray column totals at BASELINE config-4 scale (fused kernel pass;
    name kept from the JAX package).

    Matches :func:`ops.sightlines.column_integrate`; ``values`` (N,) or
    (N, F) with F <= 5; returns (R,) or (F, R) on ``device``. Particle
    inputs are converted to f32 on ``device``; ray positions are taken to
    the host in f64, as in the JAX engine.
    """
    device = torch.device(device)
    n_rays_in = len(ray_x)
    if n_rays_in == 0:
        v_shape = values.shape if hasattr(values, "shape") else np.asarray(values).shape
        return torch.zeros((*v_shape[1:], 0), dtype=torch.float32, device=device)
    if n_rays_in > _RAY_BATCH:
        # columns are independent per ray: large ray sets run in batches
        rx_all, ry_all = _host(ray_x, np.float64), _host(ray_y, np.float64)
        parts = [
            column_integrate_pallas(
                x, y, h, values, rx_all[i:i + _RAY_BATCH], ry_all[i:i + _RAY_BATCH],
                kernel=kernel, projection=projection, periodic_box=periodic_box, device=device,
            )
            for i in range(0, n_rays_in, _RAY_BATCH)
        ]
        return torch.cat(parts, dim=-1)
    layout, n_fields, single = _columns_layout(
        x, y, h, values, ray_x, ray_y, kernel=kernel, periodic_box=periodic_box, device=device,
    )
    if layout is None:
        zero = torch.zeros((n_fields, n_rays_in), dtype=torch.float32, device=device)
        return zero[0] if single else zero
    out = columns_tiles(
        layout.packed, layout.rx, layout.ry, layout.lo, layout.hi, n_fields=n_fields,
        kernel=kernel, projection=projection, periodic=layout.periodic, Lx=layout.Lx, Ly=layout.Ly,
    )
    totals = unsort_sum(out, layout).T.contiguous()  # (F, n_rays)
    return totals[0] if single else totals


def _columns_layout(x, y, h, values, ray_x, ray_y, *, kernel: str, periodic_box, device):
    """(RayLayout or None, n_fields, single) of a columns pass on ``device``."""
    values = _f32(values, device)
    single = values.ndim == 1
    if single:
        values = values[:, None]
    n_fields = values.shape[1]
    if n_fields > _MAX_FIELDS:
        raise ValueError(f"the fused sightline engine supports at most {_MAX_FIELDS} fields per pass")
    layout = stage_rays(
        _f32(x, device), _f32(y, device), _f32(h, device), list(values.T), ray_x, ray_y,
        support_factor=get_kernel(kernel).support_factor, periodic_box=periodic_box, B=_B,
    )
    return layout, n_fields, single
