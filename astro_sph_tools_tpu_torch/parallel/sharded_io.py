"""Rank-parallel snapshot reads into sharded device tensors.

Counterpart: ``astro_sph_tools_tpu/parallel/sharded_io.py``, the
replacement for the reference's MPI data-parallel reads (SURVEY.md §2.8
row 1: ``pyread_eagle.split_selection`` hands each rank disjoint file
chunks, `io/EAGLE/_SnapshotEAGLE.py:119-130`). Each rank opens its stripe
of the snapshot's file set (``SnapshotEAGLE(path, process_index=rank,
n_processes=size)``), reads its particles, and the helpers here pad its
block to the length every rank shares and put it on the rank's device.
Where the JAX package assembles one global array, each rank here keeps its
own block.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..data_structures.particle_types import ParticleType
from ..io.snapshot import SnapshotBase
from ..units import UnitArray
from ._comm import all_gather_v
from .mesh import Mesh

Tensor = torch.Tensor


def open_process_local_snapshot(snapshot_cls, filepath: str, mesh: Optional[Mesh] = None, **kwargs):
    """Open a snapshot with this rank's stripe of the file set: rank and
    size from ``mesh``, else from the default process group, else one
    process."""
    if mesh is not None:
        rank, size = mesh.rank, mesh.size
    elif dist.is_available() and dist.is_initialized():
        rank, size = dist.get_rank(), dist.get_world_size()
    else:
        rank, size = 0, 1
    return snapshot_cls(filepath, process_index=rank, n_processes=size, **kwargs)


def sharded_from_local(
    local,
    mesh: Mesh,
    axis_name: str = "data",
    pad_value: float = 0.0,
    pad_to_multiple: int = 1,
) -> Tensor:
    """This rank's block on ``mesh.device``, padded with ``pad_value`` to
    the longest rank's length (gathered over the mesh) rounded up to
    ``pad_to_multiple``, so that every rank's block has one length."""
    t = local if isinstance(local, Tensor) else torch.from_numpy(np.ascontiguousarray(local))
    t = t.to(mesh.device)
    lengths = all_gather_v(torch.tensor([t.shape[0]], dtype=torch.int64, device=mesh.device), mesh)
    n_max = max(int(n) for n in torch.cat(lengths).tolist())
    unit = max(1, pad_to_multiple)
    n_max = ((n_max + unit - 1) // unit) * unit
    if t.shape[0] == n_max:
        return t.contiguous()
    out = torch.full((n_max, *t.shape[1:]), pad_value, dtype=t.dtype, device=mesh.device)
    out[: t.shape[0]] = t
    return out


def load_particle_fields_sharded(
    snapshot: SnapshotBase,
    particle_type: ParticleType,
    fields: Sequence[str],
    mesh: Mesh,
    axis_name: str = "data",
    dtype: torch.dtype = torch.float32,
    pad_to_multiple: int = 512,
) -> dict:
    """Read fields from this rank's stripe and return its padded blocks.

    ``fields`` name ``get_*`` getters without the prefix (e.g. "positions",
    "masses", "smoothing_lengths"). Smoothing lengths are padded with 1.0
    and everything else with 0, the deposit engines' padding conventions,
    so the blocks feed them directly; the valid count of this rank is
    ``snapshot.number_of_particles_this_rank(particle_type)``.
    """
    out = {}
    for name in fields:
        value = getattr(snapshot, f"get_{name}")(particle_type)
        if isinstance(value, UnitArray):
            value = value.value
        value = torch.as_tensor(value if isinstance(value, Tensor) else np.asarray(value), dtype=dtype)
        out[name] = sharded_from_local(
            value, mesh, axis_name=axis_name, pad_value=1.0 if name == "smoothing_lengths" else 0.0,
            pad_to_multiple=pad_to_multiple,
        )
    return out
