"""Sightline columns and spectra from particle shards (config 4 over a mesh).

Counterpart: ``astro_sph_tools_tpu/parallel/sightlines.py``. Columns and
velocity-space spectra are sums over particles, so the decomposition is
data-parallel with no halo exchange: each shard runs the single-device
engine against the whole (small) ray set — the column kernel and the
spectra kernel of ``csrc/sightlines.cu`` — and the partials add. In one
process, ``shards`` may hold several shards, each run on its device of
``devices``; over a mesh, each rank passes its own shard(s) and ``mesh``,
and one ``all_reduce`` sums the ranks' partials.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.sightlines_fused import column_integrate_pallas
from ..ops.spectra_fused import absorption_spectra_pallas
from ._comm import all_reduce_
from .mesh import Mesh

Tensor = torch.Tensor


def _devices(devices, mesh: Optional[Mesh]) -> list:
    if devices is not None:
        return [torch.device(d) for d in devices]
    return [mesh.device if mesh is not None else torch.device("cuda")]


def _sum(partials: list, device, mesh: Optional[Mesh]) -> Tensor:
    total = partials[0].to(device)
    for p in partials[1:]:
        total = total + p.to(device)
    return all_reduce_(total.contiguous(), mesh) if mesh is not None else total


def column_integrate_sharded(
    shards: Sequence[tuple],  # per-shard (x, y, h, values)
    ray_x,
    ray_y,
    *,
    kernel: str = "cubic_spline",
    projection: str = "integrated",
    periodic_box: Optional[float] = None,
    devices: Optional[Sequence] = None,
    mesh: Optional[Mesh] = None,
) -> Tensor:
    """Per-ray columns from particle shards: the fused engine
    (``column_integrate_pallas``) per shard, shard i on ``devices[i %
    len(devices)]`` (default: ``mesh.device``, or ``cuda``), the partials
    summed on the first device, then over ``mesh`` when given. Returns (R,)
    or (F, R)."""
    devs = _devices(devices, mesh)
    partials = [
        column_integrate_pallas(
            x, y, h, values, ray_x, ray_y, kernel=kernel, projection=projection,
            periodic_box=periodic_box, device=devs[si % len(devs)],
        )
        for si, (x, y, h, values) in enumerate(shards)
    ]
    return _sum(partials, devs[0], mesh)


def absorption_spectra_sharded(
    shards: Sequence[tuple],  # per-shard (pos, h, values, v_los, T)
    ray_x,
    ray_y,
    *,
    cosmology=None,
    box_size: Optional[float] = None,
    atomic_weight: float = 1.008,
    n_bins: int = 512,
    kernel: str = "cubic_spline",
    periodic: bool = True,
    devices: Optional[Sequence] = None,
    mesh: Optional[Mesh] = None,
) -> tuple[Tensor, np.ndarray]:
    """Per-ray spectra from particle shards (additive over particles): the
    fused engine (``absorption_spectra_pallas``) per shard, summed as in
    :func:`column_integrate_sharded`. Returns (spectra (R, n_bins),
    velocity bin centres in km/s).

    Requires ``cosmology`` and ``box_size`` so that every shard uses the
    same box-derived velocity bins; data-dependent bin ranges would differ
    per shard and the partials could not be summed.
    """
    if cosmology is None or box_size is None:
        raise ValueError(
            "sharded spectra need cosmology and box_size (shared, box-derived "
            "velocity bins); per-shard data-dependent ranges cannot be summed"
        )
    devs = _devices(devices, mesh)
    partials, v_centres = [], None
    for si, (pos, h, values, v_los, T) in enumerate(shards):
        tau, v_centres = absorption_spectra_pallas(
            pos, h, values, v_los, T, ray_x, ray_y,
            cosmology=cosmology, box_size=box_size, atomic_weight=atomic_weight,
            n_bins=n_bins, kernel=kernel, periodic=periodic, device=devs[si % len(devs)],
        )
        partials.append(tau)
    return _sum(partials, devs[0], mesh), v_centres
