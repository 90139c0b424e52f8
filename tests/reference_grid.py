"""The plain reference of a gridded stack (``render_grid_stack``), in plain
torch and float64.

Per voxel sample point p (centres at (i + 1/2) voxels of the extent), the
sum over particles of ``value_i * W(|r(p, particle_i)|, h_i)`` where
``|r| < 2 h_i``, with W the 3D kernel (Wendland C2 or the M4 cubic
spline); on a periodic grid the offsets are taken at the nearest image per
axis. Evaluated as a scatter over each particle's window of voxels (every
voxel whose centre can lie inside its support), windows grouped by their
width. Payloads as the render has them (``density``: the mass;
``temperature``: the mass times the temperature) and each ``mean_*`` cube
the weighted cube over the density where that is positive, else 0.
Imports neither JAX nor the port.
"""

from __future__ import annotations

import math

import torch

SUPPORT = 2.0


def wendland_c2(r, h):
    u = torch.clamp(r / (2.0 * h), 0.0, 1.0)
    return (21.0 / (16.0 * math.pi)) / h**3 * (1 - u) ** 4 * (1 + 4 * u)


def cubic_spline(r, h):
    q = r / h
    inner = 1 - 1.5 * q * q + 0.75 * q**3
    outer = 0.25 * torch.clamp(2 - q, min=0.0) ** 3
    return torch.where(q < 1.0, inner, outer) / (math.pi * h**3)


KERNELS = {"wendland_c2": wendland_c2, "cubic_spline": cubic_spline}


def grid(pos, h, values, shape, extent, *, kernel: str, periodic: bool, block: int = 1 << 22) -> torch.Tensor:
    """(F, nz, ny, nx) float64 cubes of ``values`` (F, N) for ``pos`` (N, 3)
    and ``h`` (N,), over ``extent`` = (x0, x1, y0, y1, z0, z1)."""
    pos, h, values = (torch.as_tensor(a, dtype=torch.float64) for a in (pos, h, values))
    nz, ny, nx = shape
    n_fields = values.shape[0]
    out = torch.zeros(n_fields, nz * ny * nx, dtype=torch.float64)
    axes = []
    for a, n in enumerate((nx, ny, nz)):
        lo_e, hi_e = float(extent[2 * a]), float(extent[2 * a + 1])
        ps = (hi_e - lo_e) / n
        c = (pos[:, a] - lo_e) / ps
        s = SUPPORT * h / ps
        first, last = torch.floor(c - 0.5 - s).long(), torch.ceil(c - 0.5 + s).long()
        if periodic:
            last = torch.minimum(last, first + n - 1)  # the nearest image picks one offset a voxel
        axes.append((c, first, last, ps, n))
    width = [last - first + 1 for _, first, last, _, _ in axes]
    group = (width[0] << 24) + (width[1] << 12) + width[2]
    order = torch.argsort(group)
    keys, counts = torch.unique_consecutive(group[order], return_counts=True)
    start = 0
    for key, count in zip(keys.tolist(), counts.tolist()):
        ks = (key >> 24, (key >> 12) & 4095, key & 4095)
        members = order[start:start + count]
        start += count
        chunk = max(1, block // (ks[0] * ks[1] * ks[2]))
        for c0 in range(0, count, chunk):
            sel = members[c0:c0 + chunk]
            d2, idx, ok = [], [], []
            for (c, first, _, ps, n), k in zip(axes, ks):
                j = first[sel, None] + torch.arange(k)
                d = (j + 0.5) - c[sel, None]
                if periodic:
                    d = d - n * torch.round(d / n)
                    idx.append(torch.remainder(j, n))
                    ok.append(torch.ones_like(j, dtype=torch.bool))
                else:
                    idx.append(torch.clamp(j, 0, n - 1))
                    ok.append((j >= 0) & (j < n))
                d2.append((d * ps) ** 2)
            r2 = (d2[2][:, :, None, None] + d2[1][:, None, :, None]) + d2[0][:, None, None, :]
            hh = h[sel][:, None, None, None]
            inside = (r2 < (SUPPORT * hh) ** 2) & ok[2][:, :, None, None] & ok[1][:, None, :, None] \
                & ok[0][:, None, None, :]
            w = torch.where(inside, KERNELS[kernel](torch.sqrt(r2), hh), 0.0)
            flat = (idx[2][:, :, None, None] * ny + idx[1][:, None, :, None]) * nx + idx[0][:, None, None, :]
            out.index_add_(1, flat.reshape(-1), (values[:, sel][:, :, None, None, None] * w[None]).reshape(n_fields, -1))
    return out.reshape(n_fields, nz, ny, nx)


def grid_stack(fields: dict, shape, extent, *, kernel: str, periodic: bool) -> dict:
    """{name: (nz, ny, nx) float64 cube} of ``render_grid_stack(fields=
    ("density", "temperature"))`` from the snapshot's arrays ``fields``
    (positions, smoothing_lengths, masses, temperatures)."""
    mass = torch.as_tensor(fields["masses"], dtype=torch.float64)
    temp = torch.as_tensor(fields["temperatures"], dtype=torch.float64)
    density, weighted = grid(fields["positions"], fields["smoothing_lengths"], torch.stack([mass, mass * temp]),
                             shape, extent, kernel=kernel, periodic=periodic)
    mean = torch.where(density > 0, weighted / torch.where(density > 0, density, 1.0), 0.0)
    return {"density": density, "mass_weighted_temperature": weighted, "mean_temperature": mean}
