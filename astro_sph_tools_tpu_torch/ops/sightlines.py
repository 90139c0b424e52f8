"""Sightline integration: ray x particle SPH kernel integrals (config 4).

Counterpart: ``astro_sph_tools_tpu/ops/sightlines.py``. The same three plain
engines, written with torch operations in place of ``jax.numpy`` and Python
loops in place of ``lax.scan`` / ``fori_loop``:

- :func:`column_integrate` (dense): per-ray column totals
  ``sum_i q_i * Y(b_i, h_i)`` over every particle, O(R * N), in (rays x
  particles) blocks — ``Y`` the line-integrated kernel table
  (``projection="integrated"``, physical column densities) or the 3D kernel
  at the projected radius (``"kernel3d"``, the reference map convention).
- :func:`los_profiles`: per-ray 1-D profiles along the LOS axis, the 3D
  kernel sampled at the true 3D distance of each bin centre.
- :func:`column_integrate_binned`: particles split into footprint levels and
  cell-sorted per level on the host (cell >= the level's max support); each
  block of cell-sorted rays reads only the contiguous particle span of its
  1-ring cell rows, O(R * N_local).

These are the oracles the fused engine (``ops/sightlines_fused.py``, TPU
kernel #4's port) is held against. Their block sizes bound the temporaries
(2^22 elements on the CPU, 2^25 on a GPU); the JAX package's macro-batching
existed to keep one XLA program short on the TPU and has no counterpart.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from ..kernels.splines import get_kernel, integrated_kernel_lookup, integrated_kernel_table
from ._device import as_f32

Tensor = torch.Tensor

_DEF_CHUNK = 2048
_BLOCK_RAYS = 128
_BIN_CHUNK = 1024
_MAX_BIN_LEVELS = 6


def _block_elems(device: torch.device) -> int:
    """Elements of one block's temporaries: 2^22 on the CPU, 2^25 on a GPU."""
    return 1 << (22 if device.type == "cpu" else 25)


def _field_matrix(values, device) -> tuple[Tensor, bool]:
    """(N, F) f32 values on ``device`` and whether the input was 1-D."""
    values = as_f32(values, device)
    single = values.ndim == 1
    return (values[:, None] if single else values), single


def _lut(kernel: str, projection: str, device) -> Optional[Tensor]:
    if projection == "integrated":
        return torch.as_tensor(integrated_kernel_table(kernel), dtype=torch.float32, device=device)
    return None


def _min_image(d: Tensor, box: float) -> Tensor:
    return d - torch.round(d / box) * box


def _column_weights(kspec, lut: Optional[Tensor], b2: Tensor, h: Tensor) -> Tensor:
    """Kernel column weight at squared impact parameter ``b2`` (masked to
    the support), as the JAX dense and binned engines evaluate it."""
    S = kspec.support_factor
    b = torch.sqrt(b2)
    w = integrated_kernel_lookup(lut, b, h, S) if lut is not None else kspec.w(b, h)
    return torch.where(b2 < (S * h) ** 2, w, 0.0)


def column_integrate(
    x, y, h, values, ray_x, ray_y,
    *,
    kernel: str = "cubic_spline",
    projection: str = "integrated",
    chunk: int = _DEF_CHUNK,
    periodic_box: Optional[float] = None,
    device="cuda",
) -> Tensor:
    """Per-ray column totals over all particles.

    ``values`` (N,) or (N, F); returns (R,) or (F, R) on ``device``. With
    ``projection='integrated'`` and values = masses the result is the
    physical column density (mass / area); ``'kernel3d'`` reproduces the
    reference map convention. ``chunk`` is the least number of particles per
    block.
    """
    device = torch.device(device)
    kspec = get_kernel(kernel)
    x, y, h = as_f32(x, device), as_f32(y, device), as_f32(h, device)
    values, single = _field_matrix(values, device)
    rx, ry = as_f32(ray_x, device), as_f32(ray_y, device)
    lut = _lut(kernel, projection, device)
    n, n_rays = x.shape[0], rx.shape[0]
    totals = torch.zeros((values.shape[1], n_rays), dtype=torch.float32, device=device)
    rt = 1024
    step = max(chunk, _block_elems(device) // rt)
    for r0 in range(0, n_rays, rt):
        r1 = min(r0 + rt, n_rays)
        for c0 in range(0, n, step):
            c1 = min(c0 + step, n)
            dx = rx[r0:r1, None] - x[None, c0:c1]
            dy = ry[r0:r1, None] - y[None, c0:c1]
            if periodic_box is not None:
                dx = _min_image(dx, periodic_box)
                dy = _min_image(dy, periodic_box)
            w = _column_weights(kspec, lut, dx * dx + dy * dy, h[None, c0:c1])  # (R, C)
            totals[:, r0:r1] += (w @ values[c0:c1]).T
    return totals[0] if single else totals


def los_profiles(
    pos, h, values, ray_x, ray_y,
    *,
    z_range: tuple[float, float],
    n_bins: int,
    kernel: str = "cubic_spline",
    chunk: int = 512,
    periodic_box: Optional[float] = None,
    device="cuda",
) -> Tensor:
    """1-D field profiles along each ray (projection axis = z; pre-rotate
    positions for other axes via ``CoordinateAxes.projection_plane``).

    Returns (R, B) for single-field input, else (F, R, B): the 3D kernel
    evaluated at each bin sample point, i.e. ``profile[r, b] = sum_i q_i *
    W(|ray_point_rb - pos_i|, h_i)`` — density-run semantics matching the
    map engine; divide weighted fields by a mass profile for averages.
    """
    device = torch.device(device)
    kspec = get_kernel(kernel)
    S = kspec.support_factor
    pos = as_f32(pos, device)
    h = as_f32(h, device)
    values, single = _field_matrix(values, device)
    rx, ry = as_f32(ray_x, device), as_f32(ray_y, device)
    z_edges = torch.linspace(z_range[0], z_range[1], n_bins + 1, dtype=torch.float32, device=device)
    zc = 0.5 * (z_edges[:-1] + z_edges[1:])
    R, F, n = rx.shape[0], values.shape[1], pos.shape[0]
    prof = torch.zeros((F, R, n_bins), dtype=torch.float32, device=device)
    step = max(1, min(chunk, _block_elems(device) // max(1, R * n_bins)))
    for c0 in range(0, n, step):
        c1 = min(c0 + step, n)
        cx, cy, cz = pos[c0:c1, 0], pos[c0:c1, 1], pos[c0:c1, 2]
        ch = h[c0:c1]
        dx = rx[:, None] - cx[None, :]
        dy = ry[:, None] - cy[None, :]
        dz = zc[:, None] - cz[None, :]  # (B, C)
        if periodic_box is not None:
            dx = _min_image(dx, periodic_box)
            dy = _min_image(dy, periodic_box)
            dz = _min_image(dz, periodic_box)
        r2 = (dx * dx + dy * dy)[:, None, :] + (dz * dz)[None, :, :]  # (R, B, C)
        w = kspec.w(torch.sqrt(r2), ch[None, None, :])
        w = torch.where(r2 < (S * ch[None, None, :]) ** 2, w, 0.0)
        prof += torch.einsum("cf,rbc->frb", values[c0:c1], w)
    return prof[0] if single else prof


# ---------------------------------------------------------------------------
# Tile-binned engine (host cell sort, device ray-block passes)
# ---------------------------------------------------------------------------


def _host(a, dtype) -> np.ndarray:
    if isinstance(a, Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def _binned_levels(
    x: np.ndarray, y: np.ndarray, s: np.ndarray, rays: np.ndarray,
    x0: float, y0: float, Lx: float, Ly: float, ray_block: int, periodic: bool,
) -> Iterator[tuple]:
    """Per populated footprint level: the level's particles in cell order
    (``sel``), and for every block of ``ray_block`` cell-sorted rays its
    (ray order slice, list of [lo, hi) spans into ``sel``).

    Levels halve the support: a particle of support ``s`` sits at level
    ``floor(log2(s_max / s))`` (clipped to the last), whose cells are at
    least ``s_max / 2^level`` wide, so a ray's candidates lie in its own and
    the 1-ring cell rows. Yields ``(sel, rorder, blocks)`` with ``blocks`` a
    list of ``(r_start, r_stop, spans)``.
    """
    n_rays = rays.shape[1]
    s_max = float(s.max()) if s.size else 1.0
    level = np.zeros(x.shape[0], np.int64)
    if s.size:
        with np.errstate(divide="ignore"):
            level = np.floor(np.log2(s_max / np.maximum(s, 1e-30))).astype(np.int64)
        level = np.clip(level, 0, _MAX_BIN_LEVELS - 1)
    for li in range(_MAX_BIN_LEVELS):
        sel = np.nonzero(level == li)[0]
        if sel.size == 0:
            continue
        cell = s_max / (1 << li)  # >= this level's max support
        ncx = min(max(1, int(Lx / cell)), 4096)
        ncy = min(max(1, int(Ly / cell)), 4096)
        cx = np.clip(((x[sel] - x0) / (Lx / ncx)).astype(np.int64), 0, ncx - 1)
        cy = np.clip(((y[sel] - y0) / (Ly / ncy)).astype(np.int64), 0, ncy - 1)
        cid = cy * ncx + cx
        order = np.argsort(cid, kind="stable")
        sel, cid = sel[order], cid[order]
        row_start = np.searchsorted(cid, np.arange(ncy, dtype=np.int64) * ncx)
        row_end = np.searchsorted(cid, (np.arange(ncy, dtype=np.int64) + 1) * ncx)

        rcx = np.clip(((rays[0] - x0) / (Lx / ncx)).astype(np.int64), 0, ncx - 1)
        rcy = np.clip(((rays[1] - y0) / (Ly / ncy)).astype(np.int64), 0, ncy - 1)
        rorder = np.argsort(rcy * ncx + rcx, kind="stable")
        rrow = rcy[rorder]
        blocks = []
        for b0 in range(0, n_rays, ray_block):
            b1 = min(b0 + ray_block, n_rays)
            r0, r1 = int(rrow[b0]), int(rrow[b1 - 1])
            spans = [(row_start[max(r0 - 1, 0)], row_end[min(r1 + 1, ncy - 1)])]
            if periodic:
                # wrap rows only when not already inside the clamped main
                # span (coarse grids: r1 + 1 can reach ncy - 1)
                if r0 == 0 and r1 + 1 < ncy - 1:
                    spans.append((row_start[ncy - 1], row_end[ncy - 1]))
                if r1 == ncy - 1 and r0 - 1 > 0:
                    spans.append((row_start[0], row_end[0]))
            blocks.append((b0, b1, [(int(a), int(b)) for a, b in spans if b > a]))
        yield sel, rorder, blocks


def _binned_domain(x, y, s, rays, periodic_box):
    """(x, y, rays, x0, y0, Lx, Ly): the periodic box (coordinates wrapped
    into it) or the bounding box of everything padded by the largest
    support."""
    if periodic_box is not None:
        L = float(periodic_box)
        return np.mod(x, L), np.mod(y, L), np.mod(rays, L), 0.0, 0.0, L, L
    pad = float(s.max()) if s.size else 1.0
    x0 = min(x.min() if x.size else 0.0, rays[0].min()) - pad
    y0 = min(y.min() if y.size else 0.0, rays[1].min()) - pad
    Lx = max(x.max() if x.size else 1.0, rays[0].max()) + pad - x0
    Ly = max(y.max() if y.size else 1.0, rays[1].max()) + pad - y0
    return x, y, rays, x0, y0, Lx, Ly


def column_integrate_binned(
    x, y, h, values, ray_x, ray_y,
    *,
    kernel: str = "cubic_spline",
    projection: str = "integrated",
    periodic_box: Optional[float] = None,
    chunk: int = _BIN_CHUNK,
    ray_block: int = _BLOCK_RAYS,
    device="cuda",
) -> Tensor:
    """Cell-binned per-ray column totals (the JAX package's production XLA
    engine; the oracle of the fused engine at scale).

    Same result as :func:`column_integrate` at O(R * N_local): the
    level/cell partition and the ray blocks are built on the host in f64,
    each block's spans are evaluated on ``device`` in f32 blocks of at least
    ``chunk`` particles. Returns (R,) or (F, R) on ``device``.
    """
    device = torch.device(device)
    kspec = get_kernel(kernel)
    xh, yh = _host(x, np.float64), _host(y, np.float64)
    hh = _host(h, np.float32)
    vh = _host(values, np.float32)
    single = vh.ndim == 1
    if single:
        vh = vh[:, None]
    lut = _lut(kernel, projection, device)
    rays = np.stack([_host(ray_x, np.float64), _host(ray_y, np.float64)])
    n_rays, F = rays.shape[1], vh.shape[1]
    s = kspec.support_factor * hh.astype(np.float64)
    xh, yh, rays, x0, y0, Lx, Ly = _binned_domain(xh, yh, s, rays, periodic_box)
    periodic = periodic_box is not None

    totals = torch.zeros((n_rays, F), dtype=torch.float32, device=device)
    for sel, rorder, blocks in _binned_levels(xh, yh, s, rays, x0, y0, Lx, Ly, ray_block, periodic):
        px = torch.as_tensor(xh[sel].astype(np.float32), device=device)
        py = torch.as_tensor(yh[sel].astype(np.float32), device=device)
        ph = torch.as_tensor(hh[sel], device=device)
        pv = torch.as_tensor(vh[sel], device=device)
        rxs = torch.as_tensor(rays[0][rorder].astype(np.float32), device=device)
        rys = torch.as_tensor(rays[1][rorder].astype(np.float32), device=device)
        ro = torch.as_tensor(rorder, device=device)
        step = max(chunk, _block_elems(device) // ray_block)
        for b0, b1, spans in blocks:
            rxb, ryb = rxs[b0:b1, None], rys[b0:b1, None]
            tot = torch.zeros((b1 - b0, F), dtype=torch.float32, device=device)
            for lo, hi in spans:
                for c0 in range(lo, hi, step):
                    c1 = min(c0 + step, hi)
                    dx = rxb - px[None, c0:c1]
                    dy = ryb - py[None, c0:c1]
                    if periodic:
                        dx = _min_image(dx, Lx)
                        dy = _min_image(dy, Ly)
                    w = _column_weights(kspec, lut, dx * dx + dy * dy, ph[None, c0:c1])
                    tot += w @ pv[c0:c1]
            totals.index_add_(0, ro[b0:b1], tot)
    totals = totals.T
    return totals[0] if single else totals
