"""Reference of a ``halo_maps`` product: one map stack per halo cutout.

The cutout geometry worked out again from the inputs: each halo's cutout is
the square of half-width ``radius_multiple * R200`` about its centre, open
(not periodic); particles are placed by their nearest periodic image of the
offset from the centre, in float64, and every particle whose support can
reach a pixel centre of the cutout is projected. Payloads and derived means
as in ``box_map``.
"""

from __future__ import annotations

import torch

from sphbench.counting import clipped_support_points, least_seconds, pair_ops
from sphbench.reference.box_map import AXES, derive, payloads
from sphbench.reference.scatter import project


def _cutouts(inputs: dict, config: dict, device):
    """Per halo: (half width, in-plane offsets (n, 2) float64 of the
    particles that can reach the cutout, their indexes)."""
    product = config["product"]
    i, j = AXES[product["axis"]]
    box = float(inputs["box"])
    pos = inputs["positions"].to(device)
    plane = torch.stack([pos[:, i], pos[:, j]], dim=1).double()
    del pos
    h = inputs["smoothing_lengths"].to(device).double()
    for k in range(len(inputs["halo_r200"])):
        centre, r200 = inputs["halo_centres"][k], inputs["halo_r200"][k]
        hw = float(product["radius_multiple"]) * float(r200)
        d = plane - torch.tensor([centre[i], centre[j]], dtype=torch.float64, device=device)
        d = d - box * torch.round(d / box)
        reach = hw + 2.0 * h
        index = torch.nonzero((d[:, 0].abs() < reach) & (d[:, 1].abs() < reach)).squeeze(1)
        yield hw, d[index], index


def maps(inputs: dict, config: dict, device, *, control: bool = False) -> list:
    """One answer a halo, in order: {map name: (ny, nx) float64 NumPy
    map}."""
    product = config["product"]
    res = int(product["resolution"])
    h = inputs["smoothing_lengths"].to(device)
    out = []
    for hw, d, index in _cutouts(inputs, config, device):
        names, values = payloads(inputs, product["fields"], device, index)
        projected = project(d[:, 0], d[:, 1], h[index], values, (res, res), (-hw, hw, -hw, hw),
                            kernel=config["kernel"], periodic=False, control=control)
        result = derive({name: m.double() for name, m in zip(names, projected)})
        out.append({k: v.cpu().numpy() for k, v in result.items()})
    return out


def work(inputs: dict, config: dict, device) -> dict:
    """The least time of one product, summed over the cutouts: the inputs of
    the particles whose support reaches each cutout read once as float32,
    its maps written once, one kernel evaluation for each pair of such a
    particle and a pixel of the cutout inside its support."""
    product = config["product"]
    n_fields = len(product["fields"])
    res = int(product["resolution"])
    h = inputs["smoothing_lengths"].to(device).double()
    moved = ops = 0.0
    for hw, d, index in _cutouts(inputs, config, device):
        px = 2.0 * hw / res
        moved += 4.0 * index.numel() * (3 + n_fields) + 4.0 * n_fields * res * res
        ops += clipped_support_points((d[:, 0] + hw) / px, (d[:, 1] + hw) / px, 2.0 * h[index] / px, res, res) \
            * pair_ops(n_fields, config["kernel"])
    return least_seconds(moved, ops)
