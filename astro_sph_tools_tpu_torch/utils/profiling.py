"""The port's tracing: spans and counters on the profiler's clock, device
traces and the render's phase timing.

Counterpart: ``astro_sph_tools_tpu/utils/profiling.py``. PyTorch launches
device work asynchronously, so a phase timed on a CUDA device ends with
``torch.cuda.synchronize()``: the wall clock then covers the device work the
phase enqueued, not only the enqueue. ``device_trace`` records a block with
``torch.profiler`` and reads from it the device's busy and idle share and
its top operations. Eager torch compiles nothing, so the JAX package's
``count_compilations`` has no counterpart.

**Spans.** ``with span(name, **counts) as sp:`` marks a layer of the render
path. While no ``torch.profiler`` session runs, it reads one flag and
returns a shared object that does nothing. While one runs, the span opens a
``torch.profiler.record_function`` of its name, so it lies in the trace on
the profiler's clock and names the device's idle gaps, and keeps a record:
its name, id, parent, ``product`` (the id of its root span: every span of
one top-level render call shares it), host start and end
(``time.time_ns()``, the clock kineto stamps its events with, read just
before the ``record_function`` opens and just after it closes, so that the
span's interval holds its event's however long the thread is held up
between the two stamps), its counters
and, once CUDA is initialised, two timing events on the current stream,
whose interval is the span's time on the device's timeline. Counters are
numbers the caller already holds on the host, or one-element tensors that a
kernel fills on the device, read only when :func:`spans` resolves the
window (so that counting adds no synchronise); ``sp.count(...)`` adds some
once they are known, and :func:`count` adds to the innermost open span.
:func:`recording` says whether a profiler runs, for a caller whose
counting costs work of its own.
:func:`spans` returns the records of the latest profiled window with each
span's device time and self device time (less its child spans').
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Iterator, Optional

import torch
from torch.autograd import profiler as _profiler

#: records one profiled window keeps; spans past it record nothing
MAX_SPANS = 1 << 16


class _Off:
    """The span while no profiler runs: one shared object that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def count(self, **counts) -> None:
        pass


_OFF = _Off()


class _Window:
    """The records of one profiled window, and each thread's open spans.
    A window ends when :func:`spans` reads it with the profiler off (or
    :func:`device_trace` starts); the next span then begins a new one."""

    def __init__(self) -> None:
        self.records: list = []
        self.ids = itertools.count(1)
        self.local = threading.local()
        self.read = False

    def open_spans(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def reset(self) -> None:
        self.records = []
        self.read = False


_window = _Window()


class _Span:
    """A span recorded while the profiler runs (see the module's doc)."""

    __slots__ = ("name", "id", "parent", "product", "counts", "start_ns", "end_ns", "device_ms", "_rf",
                 "_events")

    def __init__(self, name: str, counts: dict) -> None:
        self.name = name
        self.counts = counts
        self.end_ns = None
        self.device_ms = None
        self._events = None

    def __enter__(self):
        w = _window
        stack = w.open_spans()
        if w.read and not stack:
            w.reset()
        parent = stack[-1] if stack else None
        self.id = next(w.ids)
        self.parent = parent.id if parent is not None else None
        self.product = parent.product if parent is not None else self.id
        self._rf = torch.profiler.record_function(self.name)
        self.start_ns = time.time_ns()  # just before the event's own stamp
        self._rf.__enter__()
        if torch.cuda.is_initialized():
            self._events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        stack.append(self)
        if len(w.records) < MAX_SPANS:
            w.records.append(self)
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record()
        _window.open_spans().pop()
        self._rf.__exit__(*exc)
        self.end_ns = time.time_ns()  # just after the event's own stamp
        return None

    def count(self, **counts) -> None:
        self.counts.update(counts)

    def resolve(self) -> Optional[float]:
        """The span's device time (ms), read once from its events, which
        are waited for (the caller has synchronised; this is after the
        window)."""
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            self.device_ms = start.elapsed_time(end)
            self._events = None
        return self.device_ms


def span(name: str, **counts):
    """A span named ``name`` carrying ``counts`` (see the module's doc):
    the shared no-op while no profiler runs, else a recording span."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, counts)


def recording() -> bool:
    """Whether a profiler runs, so that spans and counters record."""
    return bool(_profiler._is_profiler_enabled)


def count(**counts) -> None:
    """Add ``counts`` to the innermost open span of this thread (nothing
    while no profiler runs)."""
    if not _profiler._is_profiler_enabled:
        return
    stack = _window.open_spans()
    if stack:
        stack[-1].counts.update(counts)


def _host(c):
    """A counter as a host number (a device tensor's one value)."""
    return c.item() if isinstance(c, torch.Tensor) else c


def spans() -> list[dict]:
    """The closed spans of the latest profiled window, in the order they
    opened: ``name``, ``id``, ``parent`` (None for a root), ``product``,
    ``start_ns`` and ``end_ns`` (``time.time_ns()``, the profiler's clock),
    ``counts``, ``device_ms`` and ``self_device_ms`` (None off a CUDA
    device). Call it after the profiled block, once the device has been
    synchronised; read with the profiler off, it ends the window."""
    w = _window
    if not _profiler._is_profiler_enabled:
        w.read = True
    closed = [s for s in w.records if s.end_ns is not None]
    child_ms: dict = {}
    for s in closed:
        ms = s.resolve()
        if s.parent is not None and ms is not None:
            child_ms[s.parent] = child_ms.get(s.parent, 0.0) + ms
    return [
        {"name": s.name, "id": s.id, "parent": s.parent, "product": s.product, "start_ns": s.start_ns,
         "end_ns": s.end_ns, "counts": {k: _host(c) for k, c in s.counts.items()}, "device_ms": s.device_ms,
         "self_device_ms": None if s.device_ms is None else s.device_ms - child_ms.get(s.id, 0.0)}
        for s in closed
    ]


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
def device_trace(*, top: int = 8, device=None) -> Iterator[DeviceTrace]:
    """Record the block with ``torch.profiler`` (CPU and, where there is
    one, CUDA activity) and fill the yielded :class:`DeviceTrace` on exit;
    the block's spans are then :func:`spans`. Usage::

        with device_trace() as tr:
            image = deposit_2d_auto(...)
        print(tr.busy_ms, tr.idle_share, tr.top_ms, spans())
    """
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available() and (device is None or torch.device(device).type == "cuda")
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    result = DeviceTrace()
    if cuda:
        torch.cuda.synchronize(device)
    _window.reset()
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


class PhaseTimer:
    """The render's per-phase wall clock: IO, recentre, select, deposit,
    derive, to_host.

    Phases are re-enterable; ``report()`` returns {phase: seconds}. With a
    CUDA ``device`` every phase synchronises that device before it stops the
    clock. Each phase is the span ``render.<phase>``.
    """

    def __init__(self, device="cpu") -> None:
        self._device = torch.device(device)
        self._totals: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        with span("render." + name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if self._device.type == "cuda":
                    torch.cuda.synchronize(self._device)
                self._totals[name] = self._totals.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> dict[str, float]:
        return dict(self._totals)
