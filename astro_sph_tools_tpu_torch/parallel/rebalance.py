"""Even shard rebalancing over a process mesh.

Counterpart: ``rebalance_evenly`` of
``astro_sph_tools_tpu/parallel/rebalance.py``, parity for the reference's
``mpi_redistribute_array_evenly`` (`io/EAGLE/_SnapshotEAGLE.py:19,132-142`):
a halo-centric or region-restricted read leaves ranks with unequal counts,
and every sharded engine then runs at the slowest rank's pace.

The repartition keeps the global order. Each valid element's global index
g (the rank's offset plus its local index) goes to rank ``d`` with
``bounds[d] <= g < bounds[d + 1]``; what one rank sends to one destination
is a contiguous slice of its block, so one ``all_to_all_v`` with exact
split sizes moves everything, and each rank receives its new block already
in order. The plan is int64 host arithmetic (:func:`rebalance_plan`): the
JAX package carries it as int32 device metadata, which wraps once the
total passes 2^31; its roll-and-mask buckets of a whole shard per
destination exist for static shapes and are not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ._comm import all_to_all_v
from .mesh import Mesh

Tensor = torch.Tensor


class RebalancePlan(NamedTuple):
    """The even repartition of ``counts`` (int64 arrays)."""

    counts: np.ndarray  # (n,) valid elements per rank before
    offsets: np.ndarray  # (n,) global index of each rank's first element
    new_counts: np.ndarray  # (n,) after: total // n, the first total % n ranks one more
    bounds: np.ndarray  # (n + 1,) global index of each rank's first element after

    def send_counts(self, rank: int) -> np.ndarray:
        """Elements ``rank`` sends to each destination (contiguous slices
        of its block, in destination order)."""
        lo = np.clip(self.bounds[:-1] - self.offsets[rank], 0, self.counts[rank])
        hi = np.clip(self.bounds[1:] - self.offsets[rank], 0, self.counts[rank])
        return hi - lo

    def recv_counts(self, rank: int) -> np.ndarray:
        """Elements ``rank`` receives from each source, in source order."""
        lo = np.maximum(self.offsets, self.bounds[rank])
        hi = np.minimum(self.offsets + self.counts, self.bounds[rank + 1])
        return np.maximum(hi - lo, 0)


def rebalance_plan(counts, n_dev: int) -> RebalancePlan:
    """The int64 plan of :func:`rebalance_evenly` for per-rank ``counts``.
    Host arithmetic only: it allocates nothing on a device."""
    counts = np.asarray(counts, dtype=np.int64).reshape(-1)
    if counts.shape != (n_dev,):
        raise ValueError(f"counts must be ({n_dev},), got {counts.shape}")
    if (counts < 0).any():
        raise ValueError(f"counts must be non-negative, got {counts}")
    total = int(counts.sum())
    new_counts = np.full(n_dev, total // n_dev, np.int64)
    new_counts[: total % n_dev] += 1
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    bounds = np.concatenate([[0], np.cumsum(new_counts)]).astype(np.int64)
    return RebalancePlan(counts, offsets, new_counts, bounds)


def rebalance_evenly(
    arrays: Sequence,
    counts,
    mesh: Mesh,
    *,
    axis_name: str = "data",
    pad_values: Optional[Sequence[float]] = None,
):
    """Repartition this rank's blocks so that every rank holds an equal
    share of the valid elements, in the same global order.

    ``arrays``: this rank's blocks (tensors or NumPy arrays of one leading
    length, the shard capacity), each holding its ``counts[rank]`` valid
    elements first and padding after (the :mod:`.sharded_io` layout).
    ``counts``: (size,) valid count of every rank. ``pad_values``: per-array
    fill for the slots past the new count (default 0; pass 1.0 for
    smoothing lengths).

    Returns ``(blocks, new_counts)``: this rank's new blocks, same shapes
    and dtypes, on ``mesh.device``, and the (size,) int64 even partition
    (``total // size``, the first ``total % size`` ranks one more). Raises
    when the even share exceeds the shard capacity.
    """
    plan = rebalance_plan(counts, mesh.size)
    blocks = [
        (a if isinstance(a, Tensor) else torch.from_numpy(np.asarray(a))).to(mesh.device) for a in arrays
    ]
    shard_len = blocks[0].shape[0]
    if any(b.shape[0] != shard_len for b in blocks):
        raise ValueError(
            "all arrays must share the sharded leading dimension; got "
            f"{[b.shape[0] for b in blocks]}"
        )
    if plan.new_counts.max() > shard_len:
        raise ValueError(
            f"even share {int(plan.new_counts.max())} exceeds the shard capacity "
            f"{shard_len}; grow the global padding before rebalancing"
        )
    if pad_values is None:
        pad_values = [0.0] * len(blocks)
    if plan.counts.max() > shard_len:
        raise ValueError(f"counts {plan.counts.tolist()} exceed the shard capacity {shard_len}")
    rank = mesh.rank
    c = int(plan.counts[rank])
    send = plan.send_counts(rank).tolist()
    recv = plan.recv_counts(rank).tolist()
    n_new = int(plan.new_counts[rank])
    out = []
    for block, pad in zip(blocks, pad_values):
        got, _ = all_to_all_v(block[:c], send, mesh, recv)
        new = torch.full_like(block, pad)
        new[:n_new] = got
        out.append(new)
    return out, plan.new_counts
