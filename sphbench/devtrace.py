"""Read a traced window from ``torch.profiler``: the device's busy time, its
top operations and its idle gaps by what the host was doing.

The union of device intervals is a frozen copy of the program's
``utils/profiling.py::_union_ms``: copies on a side stream that overlap
kernels count once.
"""

from __future__ import annotations

import contextlib
import heapq
from dataclasses import dataclass, field

import torch

WINDOW = "sphbench.window"


@dataclass
class Trace:
    """Device operations and host operations of one traced window, as
    (start_us, end_us, name) on the profiler's clock, and the window's own
    interval."""

    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    window: tuple = (0.0, 0.0)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, clipped to the
        window, as sorted disjoint (start_us, end_us)."""
        w0, w1 = self.window
        merged: list = []
        for a, b in sorted((max(a, w0), min(b, w1)) for a, b, _ in self.device):
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def device_ops(self, top: int = 10) -> list:
        """[[name, seconds]] of the device operations with the most summed
        time, most first."""
        by_name: dict = {}
        for a, b, name in self.device:
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[[host operation, seconds]]: the window's idle gaps, each named by
        the innermost host operation running at its middle ("python" where
        none is), summed by name, most first."""
        w0, w1 = self.window
        edges = [w0]
        for a, b in self.busy_intervals():
            edges += [a, b]
        edges.append(w1)
        gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2) if edges[k + 1] > edges[k]]
        host = sorted((a, b, n) for a, b, n in self.host if n != WINDOW)
        by_name: dict = {}
        active: list = []  # (duration, end, name) of host operations begun, shortest first
        k = 0
        for a, b in gaps:
            mid = 0.5 * (a + b)
            while k < len(host) and host[k][0] <= mid:
                ha, hb, hn = host[k]
                heapq.heappush(active, (hb - ha, hb, hn))
                k += 1
            while active and active[0][1] < mid:  # ended before this gap: before every later one too
                heapq.heappop(active)
            name = active[0][2] if active else "python"
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]


@contextlib.contextmanager
def traced(enabled: bool, device):
    """Record the block with ``torch.profiler`` (host and, on a CUDA
    ``device``, device activity) when ``enabled``; yields a :class:`Trace`
    that is filled when the block ends, or None."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    result = Trace()
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            yield result
            if cuda:
                torch.cuda.synchronize(device)
    # the raw events: building the profiler's event tree takes minutes for
    # the hundreds of thousands of a long window
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        span = (start, start + e.duration_ns() / 1e3, e.name())
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():  # an annotation's mirror on the device's timeline
                result.device.append(span)
        else:
            result.host.append(span)
            if span[2] == WINDOW:
                result.window = span[:2]
