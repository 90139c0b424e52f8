"""The plain reference projection: a particle scatter in blocks on the card.

A frozen rewrite in PyTorch of ``tests/oracles.py``'s ``wendland_c2_w``,
``cubic_spline_w`` and ``project_oracle`` (per pixel sample point p, the sum
over particles of ``value_i * W(|r_2d(p, particle_i)|, h_i)`` where
``r^2 < (support_factor * h_i)^2``, pixel centres at (i + 1/2) pixels), as a
scatter over each particle's window of pixels. Nothing of the program is
imported.

Two precisions. The reference places, evaluates and sums in float64. The
control is the same code one precision below the configurations' float32:
the pixel placement in float32, every per-pair step (offsets, r^2, the
support test, the kernel, the product with the payload) in bfloat16, and
the sums in float32.
"""

from __future__ import annotations

import math

import torch


def wendland_c2_w(r, h):
    """Wendland C2, 3D norm, support H = 2h."""
    u = torch.clamp(r / (2.0 * h), 0.0, 1.0)
    return (21.0 / (16.0 * math.pi)) / (h * h * h) * (1 - u) ** 4 * (1 + 4 * u)


def cubic_spline_w(r, h):
    """M4 cubic spline, 3D norm, support 2h."""
    q = r / h
    inner = (1 - 1.5 * q * q + 0.75 * q * q * q)
    outer = 0.25 * torch.clamp(2 - q, min=0.0) ** 3
    return torch.where(q < 1.0, inner, outer) / (math.pi * h * h * h)


KERNELS = {"wendland_c2": wendland_c2_w, "cubic_spline": cubic_spline_w}


def _pow2(n):
    """The smallest power of two >= n, elementwise (n >= 1)."""
    return torch.pow(2, torch.ceil(torch.log2(n.double())).long())


def project(x, y, h, values, shape, extent, *, kernel: str, periodic: bool, support_factor: float = 2.0,
            control: bool = False, block: int = 1 << 24):
    """(F, ny, nx) maps of ``values`` (F, N) projected at pixel centres of
    ``extent`` = (x0, x1, y0, y1), float64 (float32 for the control), on the
    particles' device. ``periodic`` wraps pixel indexes (a window wider than
    the map raises); otherwise windows are clipped to the map."""
    place = torch.float32 if control else torch.float64
    pair = torch.bfloat16 if control else torch.float64
    acc = torch.float32 if control else torch.float64
    w_fn = KERNELS[kernel]
    ny, nx = shape
    x0, x1, y0, y1 = (float(v) for v in extent)
    psx, psy = (x1 - x0) / nx, (y1 - y0) / ny
    dev = x.device
    n_fields = values.shape[0]
    out = torch.zeros(n_fields, ny * nx, dtype=acc, device=dev)

    u = (x.to(place) - x0) / psx
    v = (y.to(place) - y0) / psy
    hp = h.to(place)
    sx, sy = support_factor * hp / psx, support_factor * hp / psy
    # every pixel whose centre (i + 1/2) can lie inside the support
    ix0 = torch.floor(u - 0.5 - sx).long()
    ix1 = torch.ceil(u - 0.5 + sx).long()
    iy0 = torch.floor(v - 0.5 - sy).long()
    iy1 = torch.ceil(v - 0.5 + sy).long()
    del sx, sy
    if periodic:
        if bool(((ix1 - ix0 + 1) > nx).any()) or bool(((iy1 - iy0 + 1) > ny).any()):
            raise ValueError("a support wider than the periodic map would count pixels twice")
    else:
        ix0, ix1 = torch.clamp(ix0, min=0), torch.clamp(ix1, max=nx - 1)
        iy0, iy1 = torch.clamp(iy0, min=0), torch.clamp(iy1, max=ny - 1)
    keep = torch.nonzero((ix1 >= ix0) & (iy1 >= iy0)).squeeze(1)
    kx = _pow2(ix1[keep] - ix0[keep] + 1)
    ky = _pow2(iy1[keep] - iy0[keep] + 1)
    group = kx * (1 << 20) + ky
    order = torch.argsort(group)
    keep, group = keep[order], group[order]
    del kx, ky, order
    keys, counts = torch.unique_consecutive(group, return_counts=True)
    del group
    start = 0
    for key, count in zip(keys.tolist(), counts.tolist()):
        Kx, Ky = key >> 20, key & ((1 << 20) - 1)
        members = keep[start:start + count]
        start += count
        ax, ay = torch.arange(Kx, device=dev), torch.arange(Ky, device=dev)
        chunk = max(1, block // (Kx * Ky))
        for lo in range(0, count, chunk):
            sel = members[lo:lo + chunk]
            jx = ix0[sel, None] + ax  # (c, Kx)
            jy = iy0[sel, None] + ay  # (c, Ky)
            ok = (jy <= iy1[sel, None])[:, :, None] & (jx <= ix1[sel, None])[:, None, :]
            dx = (((jx.to(place) + 0.5) - u[sel, None]) * psx).to(pair)
            dy = (((jy.to(place) + 0.5) - v[sel, None]) * psy).to(pair)
            r2 = dy[:, :, None] * dy[:, :, None] + dx[:, None, :] * dx[:, None, :]
            hh = h[sel].to(pair)[:, None, None]
            inside = ok & (r2 < (support_factor * hh) * (support_factor * hh))
            w = torch.where(inside, w_fn(torch.sqrt(r2), hh), torch.zeros((), dtype=pair, device=dev))
            del r2, inside, ok, dx, dy
            if periodic:
                flat = torch.remainder(jy, ny)[:, :, None] * nx + torch.remainder(jx, nx)[:, None, :]
            else:
                flat = torch.clamp(jy, max=ny - 1)[:, :, None] * nx + torch.clamp(jx, max=nx - 1)[:, None, :]
            contrib = values[:, sel].to(pair)[:, :, None, None] * w[None]
            out.index_add_(1, flat.reshape(-1), contrib.reshape(n_fields, -1).to(acc))
            del w, flat, contrib
    return out.reshape(n_fields, ny, nx)
