"""Device traces and phase timing for the render path.

Counterpart: ``astro_sph_tools_tpu/utils/profiling.py``. PyTorch launches
device work asynchronously, so a phase timed on a CUDA device ends with
``torch.cuda.synchronize()``: the wall clock then covers the device work the
phase enqueued, not only the enqueue. ``device_trace`` records a block with
``torch.profiler`` and reads from it the device's busy and idle share and
its top operations. Eager torch compiles nothing, so the JAX package's
``count_compilations`` has no counterpart.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Iterator, Optional

import torch


@dataclass
class DeviceTrace:
    """What :func:`device_trace` read from its block's trace.

    ``busy_ms``: the time at least one device operation (kernel, copy) ran,
    the union of their intervals, so that copies on a side stream that
    overlap kernels count once; None when the trace holds no device
    operation (a CPU block, or a profiler that saw no device). ``wall_ms``:
    the host clock around the block and a final device synchronise.
    ``top_ms``: the device operations with the most summed time, by name.
    """

    wall_ms: float = 0.0
    busy_ms: Optional[float] = None
    top_ms: dict = field(default_factory=dict)

    @property
    def busy_share(self) -> Optional[float]:
        return None if self.busy_ms is None else self.busy_ms / self.wall_ms

    @property
    def idle_share(self) -> Optional[float]:
        return None if self.busy_ms is None else 1.0 - self.busy_ms / self.wall_ms


def _union_ms(intervals: list) -> float:
    total = 0.0
    end = -float("inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total / 1e3


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None, *, top: int = 8, device=None) -> Iterator[DeviceTrace]:
    """Record the block with ``torch.profiler`` (CPU and, where there is
    one, CUDA activity) and fill the yielded :class:`DeviceTrace` on exit.
    With ``log_dir`` the trace is also written there as a Chrome trace
    (``trace.json``, for Perfetto). Usage::

        with device_trace() as tr:
            image = deposit_2d_auto(...)
        print(tr.busy_ms, tr.idle_share, tr.top_ms)
    """
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available() and (device is None or torch.device(device).type == "cuda")
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    result = DeviceTrace()
    if cuda:
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        yield result
        if cuda:
            torch.cuda.synchronize(device)
        result.wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if events:
        result.busy_ms = _union_ms([(e.time_range.start, e.time_range.end) for e in events])
        by_name: dict = {}
        for e in events:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        result.top_ms = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:top])
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class PhaseTimer:
    """Accumulating per-phase wall-clock: IO, sort, deposit, derive.

    Phases are re-enterable; ``report()`` returns {phase: seconds}. With a
    CUDA ``device`` every phase synchronises that device before it stops the
    clock.
    """

    def __init__(self, device="cpu") -> None:
        self._device = torch.device(device)
        self._totals: dict[str, float] = {}
        self._counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._device.type == "cuda":
                torch.cuda.synchronize(self._device)
            dt = time.perf_counter() - t0
            self._totals[name] = self._totals.get(name, 0.0) + dt
            self._counts[name] = self._counts.get(name, 0) + 1

    def report(self) -> dict[str, float]:
        return dict(self._totals)

    def summary(self) -> str:
        total = sum(self._totals.values()) or 1.0
        lines = [
            f"  {name:<20s} {secs:8.3f}s ({secs / total * 100:5.1f}%)  x{self._counts[name]}"
            for name, secs in sorted(self._totals.items(), key=lambda kv: -kv[1])
        ]
        return "phase timings:\n" + "\n".join(lines)
