"""The work a product needs, counted from its inputs' shapes, and the least
time the card could take for it.

A frozen copy of ``chip_smoke.py``'s counts (``bound``, ``nbytes``,
``support_points``, ``pair_ops``) with Wendland C2's operation count added.
The count is of the problem, not of any kernel's launches: each input byte
read once, each map byte written once, and one kernel evaluation for every
(particle, pixel) pair inside a support.
"""

from __future__ import annotations

import math

import torch

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth and dense FP32 outside the
#: tensor cores, at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

#: FP32 operations per (particle, pixel) pair of the 3D kernel at the
#: projected radius, before the payloads: the offsets, r^2 and the support
#: test (6), then the kernel. Cubic spline: sqrt and the piecewise
#: polynomial (6). Wendland C2, W = norm / h^3 (1 - u)^4 (1 + 4u) with
#: u = r / 2h: sqrt, u, 1 - u, two squarings, 1 + 4u (2), the product and
#: the norm (8).
_KERNEL_OPS = {"cubic_spline": 12, "wendland_c2": 14}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def pair_ops(n_fields: int, kernel: str) -> int:
    """FP32 operations per pair inside a support: the kernel's, then one
    multiply-add per field."""
    return _KERNEL_OPS[kernel] + 2 * n_fields


def support_points(h, support_factor: float, cell: float) -> float:
    """Expected number of pixel centres inside the particles' supports: a
    disc of radius s = support_factor * h / cell pixels holds pi s^2 of them
    on average over its sub-pixel offset (a periodic map, s below half the
    map)."""
    s = support_factor * h.double() / cell
    return float((math.pi * s * s).sum())


def clipped_support_points(cx, cy, s, nx: int, ny: int, block: int = 1 << 16, rows: int = 256) -> float:
    """Expected number of pixel centres of an open ``nx`` x ``ny`` map inside
    discs of radius ``s`` px centred at (``cx``, ``cy``) px from the map's
    corner: the area of each disc within the map. Discs wholly inside count
    pi s^2; the others are integrated over ``rows`` strips (midpoint rule,
    within 0.1% of the area)."""
    cx, cy, s = cx.double(), cy.double(), s.double()
    inside = (cx - s >= 0) & (cx + s <= nx) & (cy - s >= 0) & (cy + s <= ny)
    total = float((math.pi * s[inside] ** 2).sum())
    part = torch.nonzero(~inside).squeeze(1)
    frac = (torch.arange(rows, dtype=torch.float64, device=s.device) + 0.5) / rows
    for lo in range(0, part.numel(), block):
        idx = part[lo:lo + block]
        px, py, ps = cx[idx, None], cy[idx, None], s[idx, None]
        y0 = torch.clamp(py - ps, 0.0, float(ny))
        y1 = torch.clamp(py + ps, 0.0, float(ny))
        t = y0 + (y1 - y0) * frac  # strip centres within the map
        w = torch.sqrt(torch.clamp(ps * ps - (t - py) ** 2, min=0.0))
        chord = torch.clamp(torch.minimum(px + w, torch.full_like(w, float(nx)))
                            - torch.clamp(px - w, min=0.0), min=0.0)
        total += float((chord.mean(dim=1) * (y1 - y0)[:, 0]).sum())
    return total


def least_seconds(moved_bytes: float, ops: float) -> dict:
    """Least time on the card for ``moved_bytes`` and ``ops`` FP32
    operations, and which of the two sets it."""
    t_bytes = moved_bytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_FP32_PER_S
    return {"seconds": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": moved_bytes, "ops": ops}
