"""A pool of CPU ranks over gloo for the tests of the port's ``parallel``
package.

``RankPool(n, store_dir)`` spawns ``n`` processes once (a module-scoped
fixture per test file), each initialising a gloo process group through a
``FileStore`` under ``store_dir`` (no port, so xdist workers cannot clash)
and one single-rank group per rank. ``pool.run(fn, args)`` sends one task
to every rank (or to ``ranks``) and returns each rank's result in rank
order; ``fn`` is a module-level function taking a :class:`RankContext`
first. A task that raises comes back as a :class:`RankError`. A rank that
does not answer within ``timeout`` fails the call and the pool is closed:
nothing waits for a hung rank.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence


@dataclass
class RankContext:
    rank: int
    size: int
    single: Any  # this rank's one-rank process group

    def mesh(self, world: int = 0):
        """The port's mesh over the whole pool (``world`` = size) or over
        this rank alone (``world`` = 1), on the CPU."""
        from astro_sph_tools_tpu_torch.parallel import make_mesh

        if world in (0, self.size):
            return make_mesh(self.size, device="cpu")
        if world == 1:
            return make_mesh(1, device="cpu", group=self.single)
        raise ValueError(f"no mesh of {world} ranks in a pool of {self.size}")


@dataclass
class RankError:
    kind: str
    message: str
    trace: str


def _worker(rank: int, size: int, store: str, timeout: float, tasks, results) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, size), rank=rank, world_size=size,
        timeout=datetime.timedelta(seconds=timeout),
    )
    singles = [dist.new_group([r]) for r in range(size)]
    ctx = RankContext(rank, size, singles[rank])
    try:
        while True:
            item = tasks.get()
            if item is None:
                break
            fn, args = item
            try:
                results.put((rank, "ok", fn(ctx, *args)))
            except Exception as exc:  # reported to the test, which decides
                results.put((rank, "err", RankError(type(exc).__name__, str(exc), traceback.format_exc())))
    finally:
        dist.destroy_process_group()


class RankPool:
    def __init__(self, n: int, store_dir: str, timeout: float = 120.0) -> None:
        ctx = mp.get_context("spawn")
        self.n = n
        self.timeout = timeout
        self.results = ctx.Queue()
        self.tasks = [ctx.Queue() for _ in range(n)]
        store = os.path.join(store_dir, "store")
        self.procs = [
            ctx.Process(target=_worker, args=(r, n, store, timeout, self.tasks[r], self.results), daemon=True)
            for r in range(n)
        ]
        for p in self.procs:
            p.start()

    def run(self, fn: Callable, args: Sequence = (), per_rank: Optional[Sequence] = None,
            ranks: Optional[Sequence[int]] = None, timeout: Optional[float] = None) -> list:
        """``fn(ctx, *args)`` (or ``fn(ctx, *per_rank[r])``) on each rank of
        ``ranks`` (default: all); each rank's result, in rank order."""
        ranks = list(range(self.n)) if ranks is None else list(ranks)
        for r in ranks:
            self.tasks[r].put((fn, tuple(per_rank[r]) if per_rank is not None else tuple(args)))
        out: dict = {}
        deadline = (timeout or 2 * self.timeout + 60)
        while len(out) < len(ranks):
            try:
                rank, status, value = self.results.get(timeout=deadline)
            except queue.Empty:
                self.close()
                raise TimeoutError(f"ranks {sorted(set(ranks) - set(out))} did not answer {fn.__name__}")
            out[rank] = value
        return [out[r] for r in ranks]

    def close(self) -> None:
        for q, p in zip(self.tasks, self.procs):
            if p.is_alive():
                q.put(None)
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
