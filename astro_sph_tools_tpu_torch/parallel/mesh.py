"""The process mesh: one ``torch.distributed`` rank per card.

Counterpart: ``make_mesh`` of ``astro_sph_tools_tpu/parallel/sharded.py``.
The JAX package drives a whole ``jax.sharding.Mesh`` from one process and
its functions take global arrays; here each process (``torchrun
--nproc-per-node=N``, one rank a card) holds one rank of an initialised
process group, and every function of :mod:`astro_sph_tools_tpu_torch.parallel`
takes that rank's own shard. A :class:`Mesh` names the group, the rank's
place in it and the device its tensors live on.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D data-parallel mesh.

    ``group`` is the process group (``None``: the default group), ``rank``
    and ``size`` this rank's index in it and its size, ``device`` where this
    rank's tensors live, ``axis_name`` the mesh axis (kept from the JAX
    package, where it names the ``shard_map`` axis)."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device
    axis_name: str = "data"

    @property
    def backend(self) -> str:
        """The group's backend (``"nccl"``, ``"gloo"``, ...)."""
        return str(dist.get_backend(self.group))

    def global_rank(self, group_rank: int) -> int:
        """The default group's rank of this group's rank ``group_rank``."""
        if self.group is None:
            return group_rank
        return dist.get_global_rank(self.group, group_rank)


def _default_device(rank: int) -> torch.device:
    """``cuda:{LOCAL_RANK}``, or ``cuda:{rank % device_count()}`` when
    ``LOCAL_RANK`` is not set; raises when there is no card."""
    n_cards = torch.cuda.device_count()
    if n_cards == 0:
        raise RuntimeError(
            "make_mesh found no CUDA device; pass device='cpu' to run the mesh on the CPU"
        )
    local = os.environ.get("LOCAL_RANK")
    return torch.device("cuda", int(local) if local is not None else rank % n_cards)


def make_mesh(
    n_devices: Optional[int] = None,
    axis_name: str = "data",
    device=None,
    group: Optional[dist.ProcessGroup] = None,
) -> Mesh:
    """This rank's :class:`Mesh` over ``group`` (default: the default group).

    ``torch.distributed`` must be initialised (``init_process_group``, as
    ``torchrun`` arranges); without it this raises, as it does when
    ``n_devices`` is given and is not the group's size. ``device`` defaults
    to this rank's card (``_default_device``); the CPU is used only when the
    caller asks for it (``device="cpu"``, with the gloo backend)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialised torch.distributed process group "
            "(torch.distributed.init_process_group, or launch with torchrun)"
        )
    rank = dist.get_rank(group)
    size = dist.get_world_size(group)
    if rank < 0:
        raise ValueError("this process is not a member of the group")
    if n_devices is not None and n_devices != size:
        raise ValueError(f"n_devices={n_devices} but the process group has {size} ranks")
    device = _default_device(rank) if device is None else torch.device(device)
    return Mesh(group=group, rank=rank, size=size, device=device, axis_name=axis_name)
