"""Reference of a ``box_cube`` product: whole-box 3D voxel cubes.

The same semantics as the entry's product, worked out again from the
inputs the harness hands both sides: the payload of each field in float64
(``density``: the mass; ``temperature``: the mass times the temperature),
the sum over particles of ``value_i * W(|r(voxel centre, particle_i)|, h_i)``
where ``|r| < 2 h_i``, at voxel centres (i + 1/2), periodic on every axis,
and each derived ``mean_*`` cube as the weighted cube over the density
where that is positive, else 0. A scatter over each particle's window of
voxels on the card, windows grouped by their exact width; nothing of the
program is imported.

``compare.py`` reads 2D maps and weights the mean maps by the reference's
``surface_density``: each cube is handed over as its (nz * ny, nx) view,
the density cube under the name ``surface_density``, so that a 32 x 32
block is a 32 x 32 patch of one z plane.

Two precisions, as ``scatter.py`` has them. The reference places,
evaluates and sums in float64. The control is the same code one precision
below the configurations' float32: the voxel placement in float32, every
per-pair step (offsets, r^2, the support test, the kernel, the product
with the payload) in bfloat16, and the sums in float32.
"""

from __future__ import annotations

import math

import torch

from sphbench.counting import least_seconds, pair_ops
from sphbench.reference.box_map import derive, payloads
from sphbench.reference.scatter import KERNELS

#: the support radius in units of h of the configurations' kernels
SUPPORT = 2.0


def scatter(pos, h, values, shape, box: float, *, kernel: str, control: bool = False, block: int = 1 << 25):
    """(F, nz, ny, nx) cubes of ``values`` (F, N) at the voxel centres of
    the periodic cube of side ``box``, float64 (float32 for the control), on
    the particles' device. A window wider than the cube raises (it would
    count voxels twice)."""
    place = torch.float32 if control else torch.float64
    pair = torch.bfloat16 if control else torch.float64
    acc = torch.float32 if control else torch.float64
    w_fn = KERNELS[kernel]
    nz, ny, nx = shape
    dev = pos.device
    n_fields = values.shape[0]
    out = torch.zeros(n_fields, nz * ny * nx, dtype=acc, device=dev)
    hp = h.to(place)
    axes = []  # per axis (x, y, z): coordinate (voxels), first and last voxel of the window, voxel edge
    for a, n in enumerate((nx, ny, nz)):
        ps = box / n
        c = pos[:, a].to(place) / ps
        s = SUPPORT * hp / ps
        # every voxel whose centre (i + 1/2) can lie inside the support
        lo, hi = torch.floor(c - 0.5 - s).long(), torch.ceil(c - 0.5 + s).long()
        if bool(((hi - lo + 1) > n).any()):
            raise ValueError("a support wider than the periodic cube would count voxels twice")
        axes.append((c, lo, hi, ps))
    del hp
    width = [hi - lo + 1 for _, lo, hi, _ in axes]
    group = (width[0] << 24) + (width[1] << 12) + width[2]  # widths below 4096
    del width
    order = torch.argsort(group)
    group = group[order]
    keys, counts = torch.unique_consecutive(group, return_counts=True)
    del group
    start = 0
    for key, count in zip(keys.tolist(), counts.tolist()):
        kx, ky, kz = key >> 24, (key >> 12) & 4095, key & 4095
        members = order[start:start + count]
        start += count
        chunk = max(1, block // (kx * ky * kz))
        for lo in range(0, count, chunk):
            sel = members[lo:lo + chunk]
            d2, js = [], []
            for (c, first, _, ps), k, n in zip(axes, (kx, ky, kz), (nx, ny, nz)):
                j = first[sel, None] + torch.arange(k, device=dev)  # (c, k)
                d = (((j.to(place) + 0.5) - c[sel, None]) * ps).to(pair)
                d2.append(d * d)
                js.append(torch.remainder(j, n))
            jx, jy, jz = js
            flat = (jz[:, :, None, None] * ny + jy[:, None, :, None]) * nx + jx[:, None, None, :]
            del js, jx, jy, jz
            r2 = (d2[2][:, :, None, None] + d2[1][:, None, :, None]) + d2[0][:, None, None, :]
            del d2
            hh = h[sel].to(pair)[:, None, None, None]
            inside = r2 < (SUPPORT * hh) * (SUPPORT * hh)
            w = torch.where(inside, w_fn(torch.sqrt(r2), hh), torch.zeros((), dtype=pair, device=dev))
            del r2, inside
            contrib = values[:, sel].to(pair)[:, :, None, None, None] * w[None]
            del w
            out.index_add_(1, flat.reshape(-1), contrib.reshape(n_fields, -1).to(acc))
            del flat, contrib
    return out.reshape(n_fields, nz, ny, nx)


def maps(inputs: dict, config: dict, device, *, control: bool = False) -> list:
    """The one answer: {cube name: (nz * ny, nx) float64 NumPy view}, the
    density cube named ``surface_density`` (see the module's doc)."""
    product = config["product"]
    res = int(product["resolution"])
    names, values = payloads(inputs, product["fields"], device)
    cubes = scatter(inputs["positions"].to(device), inputs["smoothing_lengths"].to(device), values, (res,) * 3,
                    float(inputs["box"]), kernel=config["kernel"], control=control)
    del values
    result = derive({name: c.double() for name, c in zip(names, cubes)})
    del cubes
    return [{k: v.reshape(res * res, res).cpu().numpy() for k, v in result.items()}]


def work(inputs: dict, config: dict, device) -> dict:
    """The least time of one product (``counting.least_seconds``): each
    particle's coordinates, h and payloads read once as float32, the cubes
    (each field's and each derived mean) written once as float32, and one
    kernel evaluation for each voxel centre inside a support, a sphere of
    (4/3) pi (2h / voxel)^3 of them on average over its sub-voxel offset."""
    product = config["product"]
    n_fields = len(product["fields"])
    n_cubes = n_fields + sum(f != "density" for f in product["fields"])
    res = int(product["resolution"])
    h = inputs["smoothing_lengths"].to(device).double()
    n = h.shape[0]
    voxel = float(inputs["box"]) / res
    points = float(((SUPPORT * h / voxel) ** 3).sum()) * 4.0 * math.pi / 3.0
    moved = 4.0 * n * (4 + n_fields) + 4.0 * n_cubes * res ** 3
    return least_seconds(moved, points * pair_ops(n_fields, config["kernel"]))
