"""Determinism checking: stable digests and repeat-run checks.

Counterpart: ``astro_sph_tools_tpu/utils/determinism.py``.

- :func:`hash_array` — stable digest of an array's bytes (a tensor on any
  device, or a NumPy array);
- :func:`hash_pytree` — the digest of a nested container of arrays (lists,
  tuples, dicts, dataclasses), leaf by leaf in a fixed order;
- :func:`assert_deterministic` — run a function n times and require
  bitwise-identical outputs (a first call that differs from the next, as a
  cold CPU worker thread once gave, fails here);
- :func:`assert_consistent_across_processes` — every process of an
  initialised ``torch.distributed`` group must hold the same digest; a
  no-op in a single process, as the JAX package's ``process_count() == 1``
  branch.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable

import numpy as np
import torch


def _host(array) -> tuple[str, np.ndarray]:
    """(dtype name, contiguous host array) of a tensor or array-like."""
    if isinstance(array, torch.Tensor):
        t = array.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:  # NumPy has no bfloat16: digest its bits
            return "bfloat16", t.view(torch.int16).numpy()
        host = t.numpy()
    else:
        host = np.ascontiguousarray(np.asarray(array))
    return str(host.dtype), host


def hash_array(array) -> str:
    """sha256 of the array's dtype, shape and raw bytes (device tensors are
    copied to the host). A tensor and the NumPy array of the same values
    and dtype give the same digest, on every device."""
    dtype, host = _host(array)
    digest = hashlib.sha256()
    digest.update(dtype.encode())
    digest.update(str(host.shape).encode())
    digest.update(host.tobytes())
    return digest.hexdigest()


def _leaves(tree):
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for item in tree:
            yield from _leaves(item)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))
    else:
        yield tree


def hash_pytree(tree) -> str:
    """sha256 over the digests of every leaf of a nested container."""
    digest = hashlib.sha256()
    for leaf in _leaves(tree):
        digest.update(hash_array(leaf).encode())
    return digest.hexdigest()


def assert_deterministic(fn: Callable, *args, n_runs: int = 2, **kwargs) -> str:
    """Run ``fn(*args, **kwargs)`` n times; raise if outputs differ bitwise.

    Returns the common digest on success.
    """
    digests = [hash_pytree(fn(*args, **kwargs)) for _ in range(n_runs)]
    if len(set(digests)) != 1:
        raise AssertionError(f"Nondeterministic outputs across {n_runs} runs: digests {digests}")
    return digests[0]


def assert_consistent_across_processes(value) -> None:
    """All processes of the default ``torch.distributed`` group must hold
    bitwise-identical data; a no-op when no group is initialised."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return
    digest = hash_pytree(value)
    gathered: list = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, digest)
    if any(g != gathered[0] for g in gathered):
        raise AssertionError(
            "Cross-process inconsistency: processes hold different data "
            f"(digest mismatch on process set of {dist.get_world_size()})."
        )
