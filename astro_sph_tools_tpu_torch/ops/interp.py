"""N-D regular-grid multilinear interpolation and a natural cubic spline.

Counterpart: ``astro_sph_tools_tpu/ops/interp.py``. The device-side
replacement for ``scipy.interpolate.RegularGridInterpolator`` over the
ionisation tables: linear interpolation over a rectilinear grid with
strictly increasing axes, ``bounds_error=False`` semantics and an
out-of-bounds fill value (-inf for the log-space tables), as plain torch on
the points' device.

The JAX package's one-hot matrix form (``method="mxu"``) worked around the
TPU's slow general gather (~60M elements/s there); a CUDA card gathers at
memory speed, so every ``method`` takes the corner gather here. The
argument keeps its three accepted strings so that callers port unchanged.
"""

from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np
import torch
from torch import Tensor

_METHODS = ("auto", "gather", "mxu")


def _as_tensor(a, device, dtype=None) -> Tensor:
    if isinstance(a, Tensor):
        return a.to(device=device, dtype=dtype or a.dtype)
    return torch.as_tensor(np.asarray(a), device=device, dtype=dtype)


def regular_grid_interpolate(
    axes: Sequence,
    table,
    points,
    fill_value: float = -float("inf"),
    method: str = "auto",
    device=None,
) -> Tensor:
    """Multilinear interpolation of ``table`` at ``points``.

    Parameters
    ----------
    axes : D arrays of strictly increasing coordinates (len = table.shape[d]).
    table : D-dimensional value grid.
    points : (N, D) query coordinates (a single point may be a (D,) array).
    fill_value : value returned for points outside the grid hull.
    method : ``"auto"``, ``"gather"`` or ``"mxu"``; all take the corner
        gather (see the module's docstring).
    device : where to compute; by default the device of ``points`` when it
        is a tensor, else ``"cuda"``.

    Returns (N,) interpolated values in the table's dtype.
    """
    if method not in _METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of {_METHODS}")
    if device is None:
        device = points.device if isinstance(points, Tensor) else "cuda"
    table = _as_tensor(table, device)
    ndim = table.ndim
    if len(axes) != ndim:
        raise ValueError(f"{len(axes)} axes for a {ndim}-D table")
    points = _as_tensor(points, device)
    if points.ndim == 1:
        points = points[None, :]
    n = points.shape[0]

    idx_lo = []
    weights_hi = []
    in_bounds = torch.ones(n, dtype=torch.bool, device=table.device)
    for d in range(ndim):
        ax = _as_tensor(axes[d], device, points.dtype).contiguous()
        p = points[:, d].contiguous()
        i = torch.clamp(torch.searchsorted(ax, p, right=True) - 1, 0, ax.shape[0] - 2)
        x0 = ax[i]
        x1 = ax[i + 1]
        idx_lo.append(i)
        weights_hi.append((p - x0) / (x1 - x0))
        in_bounds &= (p >= ax[0]) & (p <= ax[-1])

    result = torch.zeros(n, dtype=table.dtype, device=table.device)
    for corner in itertools.product((0, 1), repeat=ndim):
        weight = torch.ones(n, dtype=table.dtype, device=table.device)
        idx = []
        for d, hi in enumerate(corner):
            w = weights_hi[d].to(table.dtype)
            weight = weight * (w if hi else (1.0 - w))
            idx.append(idx_lo[d] + hi)
        result = result + weight * table[tuple(idx)]
    return torch.where(in_bounds, result, torch.full_like(result, fill_value))


def cubic_spline_1d(x, y, xq, device=None) -> Tensor:
    """Natural cubic-spline interpolation of the knots (x, y) at ``xq``.

    The tridiagonal system for the second derivatives (natural ends, as
    the JAX package's) is solved on the host in f64 by the Thomas sweep;
    the evaluation runs on ``device`` (by default that of ``xq`` when it is
    a tensor, else ``"cuda"``) in f64. Used for the HM01 Gamma_HI(z) curve.
    """
    if device is None:
        device = xq.device if isinstance(xq, Tensor) else "cuda"
    xh = np.asarray(x.cpu() if isinstance(x, Tensor) else x, np.float64)
    yh = np.asarray(y.cpu() if isinstance(y, Tensor) else y, np.float64)
    n = xh.shape[0]
    h = xh[1:] - xh[:-1]
    rhs = 6.0 * ((yh[2:] - yh[1:-1]) / h[1:] - (yh[1:-1] - yh[:-2]) / h[:-1])
    diag = 2.0 * (h[:-1] + h[1:])
    lower = np.concatenate([[0.0], h[1:-1]])
    upper = h[1:]
    # Thomas algorithm: forward sweep, then back substitution
    c_p = np.zeros(n - 2)
    d_p = np.zeros(n - 2)
    c_prev = d_prev = 0.0
    for k in range(n - 2):
        m = diag[k] - lower[k] * c_prev
        c_prev = c_p[k] = upper[k] / m
        d_prev = d_p[k] = (rhs[k] - lower[k] * d_prev) / m
    m_inner = np.zeros(n - 2)
    m_next = 0.0
    for k in range(n - 3, -1, -1):
        m_next = m_inner[k] = d_p[k] - c_p[k] * m_next
    m2 = np.concatenate([[0.0], m_inner, [0.0]])  # natural ends

    xt = torch.as_tensor(xh, device=device)
    yt = torch.as_tensor(yh, device=device)
    mt = torch.as_tensor(m2, device=device)
    xq = _as_tensor(xq, device, torch.float64)
    i = torch.clamp(torch.searchsorted(xt, xq.contiguous(), right=True) - 1, 0, n - 2)
    hi = xt[i + 1] - xt[i]
    t_up = xt[i + 1] - xq
    t_lo = xq - xt[i]
    return (
        mt[i] * t_up**3 / (6 * hi)
        + mt[i + 1] * t_lo**3 / (6 * hi)
        + (yt[i] / hi - mt[i] * hi / 6) * t_up
        + (yt[i + 1] / hi - mt[i + 1] * hi / 6) * t_lo
    )
