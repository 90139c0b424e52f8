"""Distributed ID-matched reorder over a process mesh.

Counterpart: ``distributed_reorder`` of
``astro_sph_tools_tpu/parallel/reorder.py``, the replacement for the
reference's ``ArrayReorder_MPI`` (`tools/_ArrayReorder.py:262-656`: a
root gather of both ID orders and a round-robin ``sendrecv`` tournament).
Here the plan is the exchange:

1. every ID has an owner rank, derived from the ID (:func:`_owner_of`);
2. each rank sends its (source ID, value) pairs to their owners
   (``all_to_all_v`` with exact split sizes);
3. each rank sends its wanted target IDs to their owners the same way;
   the owner answers each by a sort-join (one stable sort of its IDs and a
   ``searchsorted``);
4. the answers travel back by the reverse exchange and land in the
   requester's order.

IDs are int64 throughout (int32 inputs are widened); the JAX package's
(hi, lo) int32 pairs and its buckets padded to a capacity exist for a
32-bit device with static shapes and are not ported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ._comm import all_reduce_, all_to_all_v
from .mesh import Mesh

Tensor = torch.Tensor

_INT32_MIN = -(1 << 31)


def _ids(ids, device) -> tuple[Tensor, bool]:
    """(int64 tensor on ``device``, whether the IDs came as int64)."""
    t = ids if isinstance(ids, Tensor) else torch.from_numpy(np.asarray(ids))
    if t.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"IDs must be int32 or int64, got {t.dtype}")
    return t.to(device=device, dtype=torch.int64).reshape(-1), t.dtype == torch.int64


def _abs_int32(v: Tensor) -> Tensor:
    """``abs`` of int32 values held in int64, wrapping as int32 does
    (|-2^31| stays -2^31)."""
    return torch.where(v == _INT32_MIN, v, v.abs())


def _owner_of(ids: Tensor, wide: bool, n_dev: int) -> Tensor:
    """Owner rank of each ID: the JAX package's hash, so that the bucket
    counts (and the ``overflow`` flag of ``capacity_factor``) agree with it.
    int32 IDs: ``|id| % n``; int64 IDs: ``|lo ^ hi| % n`` over the ID's
    two 32-bit halves read as int32."""
    if not wide:
        return torch.remainder(_abs_int32(ids), n_dev)
    hi = ids >> 32  # arithmetic shift: the high half as a signed int32 value
    lo = ids & 0xFFFFFFFF
    lo = torch.where(lo >= (1 << 31), lo - (1 << 32), lo)  # the low half read as int32
    return torch.remainder(_abs_int32(lo ^ hi), n_dev)


def _send_plan(owner: Tensor, n_dev: int) -> tuple[Tensor, list[int]]:
    """(stable order grouping the elements by owner, count per owner)."""
    order = torch.sort(owner, stable=True).indices
    counts = torch.bincount(owner, minlength=n_dev)
    return order, [int(c) for c in counts.tolist()]


def distributed_reorder(
    source_ids,
    source_data,
    target_ids,
    mesh: Mesh,
    *,
    axis_name: str = "data",
    default_value: float = 0.0,
    capacity_factor: Optional[float] = None,
) -> tuple[Tensor, Tensor, bool]:
    """Reorder ``source_data`` (ordered by ``source_ids``) into the order of
    ``target_ids``; each rank passes its own shards of the three (their
    lengths may differ between ranks) and gets its targets' values.

    IDs are int32 or int64 (NumPy arrays or tensors); int64 IDs keep their
    full range. Returns ``(values, matched, overflow)`` on ``mesh.device``:
    unmatched target slots carry ``default_value``. When a source ID occurs
    more than once over the mesh, a target takes the value of its first
    occurrence in global source order (rank by rank, then position in the
    shard); the JAX package's choice there is unspecified.

    The exchanges are sized exactly, so the values are always complete.
    ``overflow`` keeps the JAX package's meaning: with ``capacity_factor``
    given, it is True when a rank's elements for one owner exceed
    ``ceil(n_local / size * capacity_factor)`` — where the JAX engine would
    have dropped them — on any rank; without it, False.
    """
    device = mesh.device
    n_dev = mesh.size
    src, src_wide = _ids(source_ids, device)
    tgt, tgt_wide = _ids(target_ids, device)
    if src_wide != tgt_wide:
        raise ValueError("source and target IDs must share a dtype family")
    data = source_data if isinstance(source_data, Tensor) else torch.from_numpy(np.asarray(source_data))
    data = data.to(device)
    if data.shape[0] != src.shape[0]:
        raise ValueError(f"{data.shape[0]} data rows for {src.shape[0]} source IDs")

    # 1) sources -> owners
    src_order, src_counts = _send_plan(_owner_of(src, src_wide, n_dev), n_dev)
    owned_ids, owned_from = all_to_all_v(src[src_order], src_counts, mesh)
    owned_data, _ = all_to_all_v(data[src_order], src_counts, mesh, owned_from)

    # 2) targets -> owners
    tgt_order, tgt_counts = _send_plan(_owner_of(tgt, tgt_wide, n_dev), n_dev)
    queries, query_from = all_to_all_v(tgt[tgt_order], tgt_counts, mesh)

    # 3) owners answer by a sort-join; the stable sort keeps duplicates in
    # global source order, and searchsorted finds the first
    s_ids, s_order = torch.sort(owned_ids, stable=True)
    answers = torch.full((queries.shape[0], *data.shape[1:]), default_value, dtype=data.dtype, device=device)
    hit = torch.zeros(queries.shape[0], dtype=torch.bool, device=device)
    if s_ids.shape[0]:
        pos = torch.clamp(torch.searchsorted(s_ids, queries), max=s_ids.shape[0] - 1)
        hit = s_ids[pos] == queries
        answers[hit] = owned_data[s_order[pos[hit]]]

    # 4) answers back, in the requester's owner-grouped order, then unsorted
    back, _ = all_to_all_v(answers, query_from, mesh, tgt_counts)
    back_hit, _ = all_to_all_v(hit.to(torch.uint8), query_from, mesh, tgt_counts)
    out = torch.empty_like(back)
    out[tgt_order] = back
    matched = torch.empty(tgt.shape[0], dtype=torch.bool, device=device)
    matched[tgt_order] = back_hit.bool()

    overflow = False
    if capacity_factor is not None:
        cap_s = max(1, int(np.ceil(src.shape[0] / n_dev * capacity_factor)))
        cap_t = max(1, int(np.ceil(tgt.shape[0] / n_dev * capacity_factor)))
        local = int(max(src_counts) > cap_s or max(tgt_counts) > cap_t)
        flag = all_reduce_(torch.tensor([local], dtype=torch.int64, device=device), mesh, "max")
        overflow = bool(flag.item())
    return out, matched, overflow
