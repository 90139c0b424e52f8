"""The collectives every module of :mod:`.parallel` uses.

They take a rank's tensor and a :class:`.mesh.Mesh`. Gloo takes CUDA
tensors for few of its operations, so on a gloo group a CUDA tensor goes
through a host copy (``_staged``); the choice is made from the group's
backend, never by trying the call. NCCL takes the device tensors as they
are. A ring shift at one rank returns its own input without calling the
backend (gloo cannot send a rank to itself), as ``lax.ppermute`` over one
device does.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from .mesh import Mesh

Tensor = torch.Tensor

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def _staged(t: Tensor, mesh: Mesh) -> bool:
    """True when ``t`` must go through the host: a CUDA tensor on a gloo group."""
    return t.device.type == "cuda" and mesh.backend == "gloo"


def all_reduce_(t: Tensor, mesh: Mesh, op: str = "sum") -> Tensor:
    """Reduce ``t`` over the mesh in place (``op``: sum, max or min) and
    return it. ``t`` must be contiguous."""
    if op not in _OPS:
        raise ValueError(f"unknown reduction {op!r}; expected sum | max | min")
    if _staged(t, mesh):
        host = t.cpu()
        dist.all_reduce(host, op=_OPS[op], group=mesh.group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=_OPS[op], group=mesh.group)
    return t


def all_gather_v(t: Tensor, mesh: Mesh) -> list[Tensor]:
    """Every rank's ``t`` (their leading lengths may differ; the trailing
    shapes and dtypes must agree), in rank order, on ``t``'s device. The
    lengths are gathered first, then the tensors padded to the longest."""
    lengths = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
    parts = [torch.empty_like(lengths) for _ in range(mesh.size)]
    _all_gather(parts, lengths, mesh)
    n = [int(p) for p in torch.cat(parts).tolist()]
    longest = max(n)
    padded = t
    if t.shape[0] < longest:
        padded = torch.cat([t, t.new_zeros((longest - t.shape[0], *t.shape[1:]))])
    out = [torch.empty_like(padded) for _ in range(mesh.size)]
    _all_gather(out, padded.contiguous(), mesh)
    return [o[:k] for o, k in zip(out, n)]


def _all_gather(out: list, t: Tensor, mesh: Mesh) -> None:
    if _staged(t, mesh):
        host = [torch.empty_like(t, device="cpu") for _ in out]
        dist.all_gather(host, t.cpu(), group=mesh.group)
        for o, h in zip(out, host):
            o.copy_(h)
    else:
        dist.all_gather(out, t, group=mesh.group)


def all_to_all_v(
    t: Tensor, send_counts: Sequence[int], mesh: Mesh, recv_counts: Sequence[int] | None = None
) -> tuple[Tensor, list[int]]:
    """Send ``t[start_d : start_d + send_counts[d]]`` (along dim 0, in rank
    order) to each rank d; return what every rank sent here, concatenated in
    rank order, and the counts. ``recv_counts`` may be given when the caller
    knows them; otherwise they are exchanged first."""
    send_counts = [int(c) for c in send_counts]
    if len(send_counts) != mesh.size or sum(send_counts) != t.shape[0]:
        raise ValueError(f"send_counts {send_counts} do not split {t.shape[0]} rows over {mesh.size} ranks")
    if recv_counts is None:  # one all_to_all of the counts first
        counts = torch.tensor(send_counts, dtype=torch.int64, device=t.device)
        recv = torch.empty_like(counts)
        _all_to_all(recv, counts, None, None, mesh)
        recv_counts = recv.tolist()
    recv_counts = [int(c) for c in recv_counts]
    out = t.new_empty((sum(recv_counts), *t.shape[1:]))
    _all_to_all(out, t.contiguous(), recv_counts, send_counts, mesh)
    return out, recv_counts


def _all_to_all(out: Tensor, t: Tensor, recv_counts, send_counts, mesh: Mesh) -> None:
    if _staged(t, mesh):
        host = torch.empty_like(out, device="cpu")
        dist.all_to_all_single(host, t.cpu(), recv_counts, send_counts, group=mesh.group)
        out.copy_(host)
    else:
        dist.all_to_all_single(out, t, recv_counts, send_counts, group=mesh.group)


def ring_shift(t: Tensor, mesh: Mesh, shift: int = 1) -> Tensor:
    """Send ``t`` to rank ``rank + shift`` and return what rank ``rank -
    shift`` sent (both modulo the mesh size; every rank's ``t`` has the same
    shape and dtype). At one rank this is ``t`` itself, with no call to the
    backend."""
    if mesh.size == 1:
        return t
    dst = mesh.global_rank((mesh.rank + shift) % mesh.size)
    src = mesh.global_rank((mesh.rank - shift) % mesh.size)
    staged = _staged(t, mesh)
    send = t.cpu() if staged else t.contiguous()
    recv = torch.empty_like(send)
    ops = [
        dist.P2POp(dist.isend, send, dst, group=mesh.group),
        dist.P2POp(dist.irecv, recv, src, group=mesh.group),
    ]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(t.device) if staged else recv
