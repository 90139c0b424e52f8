"""Reference of a ``box_map`` product: full-box maps along an axis.

The same semantics as the entry's product, worked out again from the
inputs the harness hands both sides: the payload of each field in float64
(``density``: the mass; ``temperature``, ``metallicity``: the mass times the
quantity), the periodic projection over the whole box, and each derived
``mean_*`` map as the weighted map over the surface density where that is
positive, else 0.
"""

from __future__ import annotations

import torch

from sphbench.counting import least_seconds, pair_ops, support_points
from sphbench.reference.scatter import project

#: the (horizontal, vertical) axes of the map along each line of sight
AXES = {"x": (1, 2), "y": (0, 2), "z": (0, 1)}
#: field -> (map name, quantity multiplied by the mass, or None for the mass)
FIELDS = {
    "density": ("surface_density", None),
    "temperature": ("mass_weighted_temperature", "temperatures"),
    "metallicity": ("mass_weighted_metallicity", "metallicities"),
}


def payloads(inputs: dict, fields, device, index=None) -> tuple:
    """(map names, (F, N) float64 payloads) of ``fields``, for the
    particles ``index`` (all by default)."""
    mass = inputs["masses"].to(device).double()
    if index is not None:
        mass = mass[index]
    names, rows = [], []
    for name in fields:
        map_name, quantity = FIELDS[name]
        names.append(map_name)
        if quantity is None:
            rows.append(mass)
        else:
            q = inputs[quantity].to(device).double()
            rows.append(mass * (q if index is None else q[index]))
    return names, torch.stack(rows)


def derive(maps: dict) -> dict:
    """Each ``mass_weighted_*`` map's ``mean_*`` map, over the surface
    density where it is positive."""
    sd = maps["surface_density"]
    out = dict(maps)
    for name, m in maps.items():
        if name.startswith("mass_weighted_"):
            out[name.replace("mass_weighted", "mean")] = torch.where(sd > 0, m / torch.where(sd > 0, sd, 1.0), 0.0)
    return out


def maps(inputs: dict, config: dict, device, *, control: bool = False) -> list:
    """The one answer: {map name: (ny, nx) float64 NumPy map}."""
    product = config["product"]
    i, j = AXES[product["axis"]]
    box = float(inputs["box"])
    res = int(product["resolution"])
    pos = inputs["positions"].to(device)
    names, values = payloads(inputs, product["fields"], device)
    out = project(pos[:, i], pos[:, j], inputs["smoothing_lengths"].to(device), values, (res, res),
                  (0.0, box, 0.0, box), kernel=config["kernel"], periodic=True, control=control)
    del pos, values
    result = derive({name: m.double() for name, m in zip(names, out)})
    return [{k: v.cpu().numpy() for k, v in result.items()}]


def work(inputs: dict, config: dict, device) -> dict:
    """The least time of one product (``counting.least_seconds``): each
    particle's coordinates, h and payloads read once as float32, the maps
    written once as float32, one kernel evaluation a pair inside a
    support."""
    product = config["product"]
    n_fields = len(product["fields"])
    res = int(product["resolution"])
    h = inputs["smoothing_lengths"].to(device)
    n = h.shape[0]
    moved = 4.0 * n * (3 + n_fields) + 4.0 * n_fields * res * res
    ops = support_points(h, 2.0, float(inputs["box"]) / res) * pair_ops(n_fields, config["kernel"])
    return least_seconds(moved, ops)
