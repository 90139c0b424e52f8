"""The coherent-order engine over a process mesh.

Counterpart: ``astro_sph_tools_tpu/parallel/coherent.py``. Real snapshots
arrive as per-process file splits, each in snapshot order, so every rank's
shard is coherent (cf. the reference's rank-striped ``pyread_eagle`` reads
and MPI reduction). Each rank runs the single-device engine of
``ops/deposit_coherent.py`` on its shard (the row-prep and coherent
deposit kernels of ``csrc/coherent.cu``, the routed tails on
``csrc/deposit2d.cu``), then one ``all_reduce`` sums the map stacks.

- :func:`deposit_2d_coherent_sharded`, synced: before it renders, one
  ``all_reduce`` of (a shard whose N is not a multiple of 2048, oversize
  particles) makes every rank raise together when any rank would, so that no
  rank is left waiting in a collective.
- :func:`deposit_2d_coherent_sharded_fused`, zero host sync with pinned
  capacities: ``ok`` is True only when every rank's counts fit and every
  rank's N is a multiple of 2048; under NCCL neither the render nor the two
  reductions wait for the host.

The JAX package's three ``shard_map`` stages, the capacities and bucket
sizes maxed over shards, the stacked host sync of every shard's counts and
the extra slack for its per-level buckets exist for one compiled program on
all chips, and are not ported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops._device import as_field_matrix, check_precision
from ..ops.deposit import MapSpec
from ..ops.deposit_coherent import (
    _CHUNK,
    _D_MAX,
    _MAX_FIELDS,
    CoherentCaps,
    deposit_2d_coherent_fused,
    deposit_coherent,
    tile_particles_coherent,
)
from ..ops.deposit_tiled import PALLAS_LEVELS
from ._comm import all_reduce_
from .mesh import Mesh

Tensor = torch.Tensor


def pad_particles_mesh(x, y, h, values, spec: MapSpec, n_dev: int):
    """Host-side: pad N to a multiple of ``n_dev * 2048`` (the coherent
    chunk) so the arrays split evenly. Padding parks at the extent max with
    weight 0 and sub-pixel h (lands in the coherent level, contributes
    nothing). Keeps snapshot order. ``values`` (N,) or (F, N) comes back
    (F, N) f32, as in the JAX package."""
    values = np.asarray(values, np.float32)
    if values.ndim == 1:
        values = values[None, :]
    if values.shape[0] > 5:
        raise ValueError("pallas deposit supports at most 5 fields per pass")
    n = x.shape[0]
    unit = n_dev * _CHUNK
    n_pad = max(unit, ((n + unit - 1) // unit) * unit) - n
    if n_pad:
        x0, x1, y0, y1 = spec.extent
        pad_h = 0.1 * min(spec.pixel_size)
        x = np.concatenate([np.asarray(x, np.float32), np.full(n_pad, x1, np.float32)])
        y = np.concatenate([np.asarray(y, np.float32), np.full(n_pad, y1, np.float32)])
        h = np.concatenate([np.asarray(h, np.float32), np.full(n_pad, pad_h, np.float32)])
        values = np.concatenate([values, np.zeros((values.shape[0], n_pad), np.float32)], axis=1)
    return x, y, h, values


def _rows_error(n: int) -> ValueError:
    return ValueError(
        f"N must be a multiple of {_CHUNK} on every rank (this rank's N = {n}); use pad_particles_mesh"
    )


def deposit_2d_coherent_sharded(
    x,
    y,
    h,
    values,  # (N,) or (F, N): this rank's shard
    spec: MapSpec,
    mesh: Mesh,
    *,
    kernel: str = "cubic_spline",
    levels=PALLAS_LEVELS,
    d_max: int = _D_MAX,
    axis_name: str = "data",
    precision: str = "bf16x2",
    projection: str = "kernel3d",
    prep: Optional[str] = None,
) -> Tensor:
    """Particle-sharded coherent-order adaptive deposit: the (ny, nx) or
    (F, ny, nx) map stack summed over the mesh, on ``mesh.device``.

    Each rank's N must be a multiple of 2048 (:func:`pad_particles_mesh`)
    and its shard should be in snapshot order (any order is *correct*:
    incoherent shards route everything through the tail). Smoothing lengths
    must fit the largest footprint level: oversize particles on any rank
    make every rank raise, as a shard whose N is not a multiple of 2048
    does (one ``all_reduce`` of both flags comes first). ``precision`` is
    validated; the sums are f32.
    """
    check_precision(precision)
    device = mesh.device
    values, single = as_field_matrix(values, device, _MAX_FIELDS)
    n = int(values.shape[1])
    layout = None
    if n % _CHUNK == 0:
        layout = tile_particles_coherent(
            x, y, h, values, spec, kernel=kernel, levels=levels, d_max=d_max, prep=prep, device=device
        )
    flags = torch.tensor(
        [0 if layout else 1, layout.n_tail_oversize if layout else 0], dtype=torch.int64, device=device
    )
    bad_rows, oversize = all_reduce_(flags, mesh, "max").tolist()
    if bad_rows:
        raise _rows_error(n)
    if oversize:
        raise ValueError(
            "oversize smoothing lengths on the sharded path; clip h to the "
            "largest footprint level or use the single-device engine"
        )
    total = deposit_coherent(layout, precision=precision, projection=projection)
    all_reduce_(total, mesh)
    return total[0] if single else total


def deposit_2d_coherent_sharded_fused(
    x,
    y,
    h,
    values,  # (N,) or (F, N): this rank's shard
    spec: MapSpec,
    mesh: Mesh,
    caps: CoherentCaps,
    *,
    kernel: str = "cubic_spline",
    levels=PALLAS_LEVELS,
    d_max: int = _D_MAX,
    axis_name: str = "data",
    precision: str = "bf16x2",
    projection: str = "kernel3d",
    prep: Optional[str] = None,
) -> tuple[Tensor, Tensor]:
    """Zero-host-sync coherent render over the mesh with pinned capacities.

    Each rank runs ``deposit_2d_coherent_fused`` on its shard with ``caps``
    (calibrate each rank with ``caps_from_layout`` and merge them over the
    mesh with :func:`caps_union_mesh`), then the maps are summed and the
    ``ok`` flags counted over the mesh. Returns ``(maps, ok)``: ``ok``, a
    0-d bool tensor on ``mesh.device``, is True iff every rank's counts fit
    ``caps`` and no rank met an oversize smoothing length; on False
    re-render through :func:`deposit_2d_coherent_sharded`. Under NCCL
    nothing here waits for the host.

    Each rank's N must be a multiple of 2048: a rank whose N is not renders
    nothing and reports not ok, so that ``ok`` is False on every rank and
    every rank still joins both reductions (a raise on that rank alone would
    leave the others waiting in them).
    """
    check_precision(precision)
    device = mesh.device
    n = int(values.shape[-1])
    if n % _CHUNK == 0:
        total, ok = deposit_2d_coherent_fused(
            x, y, h, values, spec, caps, kernel=kernel, levels=levels, precision=precision,
            projection=projection, d_max=d_max, prep=prep, device=device,
        )
    else:
        fields, single = as_field_matrix(values, device, _MAX_FIELDS)
        lead = () if single else (fields.shape[0],)
        total = torch.zeros((*lead, *spec.shape), dtype=torch.float32, device=device)
        ok = torch.zeros((), dtype=torch.bool, device=device)
    total = all_reduce_(total.contiguous(), mesh)
    n_ok = all_reduce_(ok.to(torch.int32).reshape(1), mesh)
    return total, (n_ok == mesh.size).reshape(())


def caps_union_mesh(caps: CoherentCaps, mesh: Mesh) -> CoherentCaps:
    """The elementwise max of every rank's capacities (``caps_union`` over
    the mesh; one ``all_reduce``). Every rank must calibrate with the same
    levels."""
    flat = [caps.b0, *caps.bucket_caps, *caps.level_caps]
    t = all_reduce_(torch.tensor(flat, dtype=torch.int64, device=mesh.device), mesh, "max")
    vals = [int(v) for v in t.tolist()]
    nb = len(caps.bucket_caps)
    return CoherentCaps(b0=vals[0], bucket_caps=tuple(vals[1:1 + nb]), level_caps=tuple(vals[1 + nb:]))
