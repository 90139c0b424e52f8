"""Console logging, settings, and timing utilities.

Counterpart: ``astro_sph_tools_tpu/utils/console.py``, copied, with the
process index and the lap skew taken from ``torch.distributed`` when a
process group is initialised (one process otherwise). It replaces the
reference's external ``QuasarCode`` Console/Settings/Stopwatch surface
(used throughout, e.g. `_SnapshotEAGLE.py:483-489`,
`_CatalogueSUBFIND.py:41-64`): verbosity-gated printing with root-rank-only
mode, plus a lap-timing Stopwatch whose laps can be aggregated across
processes (the analogue of the reference's "MPI barrier delay" probe that
gathers per-rank lap skew).
"""

from __future__ import annotations

import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Settings:
    """Global verbosity/debug switches (parity: QuasarCode Settings)."""

    verbose: bool = False
    debug: bool = False
    show_times: bool = False
    root_only_output: bool = True


settings = Settings()


def _distributed():
    """``torch.distributed`` when a process group is initialised, else None."""
    try:
        import torch.distributed as dist
    except ImportError:  # pragma: no cover - torch built without distributed
        return None
    return dist if dist.is_available() and dist.is_initialized() else None


def _process_index() -> int:
    dist = _distributed()
    return dist.get_rank() if dist is not None else 0


def _stamp() -> str:
    if not settings.show_times:
        return ""
    return time.strftime("[%H:%M:%S] ")


def _emit(prefix: str, message: str, stream=None) -> None:
    if settings.root_only_output and _process_index() != 0:
        return
    stream = stream or sys.stdout
    print(f"{_stamp()}{prefix}{message}", file=stream, flush=True)


def print_info(message: str) -> None:
    _emit("", message)


def print_verbose_info(message: str) -> None:
    if settings.verbose or settings.debug:
        _emit("INFO: ", message)


def print_debug(message: str) -> None:
    if settings.debug:
        _emit("DEBUG: ", message)


def print_warning(message: str) -> None:
    _emit("WARNING: ", message, stream=sys.stderr)


def print_verbose_warning(message: str) -> None:
    if settings.verbose or settings.debug:
        print_warning(message)


def print_error(message: str) -> None:
    _emit("ERROR: ", message, stream=sys.stderr)


def show_times(enable: bool = True) -> None:
    settings.show_times = enable


@dataclass
class Stopwatch:
    """Lap timer (parity: QuasarCode Stopwatch, `_CatalogueSUBFIND.py:41-49`).

    ``lap()`` records and returns the elapsed seconds since the previous lap.
    ``process_skew()`` gathers the latest lap across the processes of the
    ``torch.distributed`` group and returns (min, max) — the replacement for
    the reference's MPI barrier-delay probe.
    """

    name: str = "stopwatch"
    _start: float = field(default_factory=time.perf_counter)
    _last: float = 0.0
    laps: list = field(default_factory=list)

    def __post_init__(self):
        self._last = self._start

    def lap(self, label: Optional[str] = None) -> float:
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self.laps.append((label or f"lap{len(self.laps)}", dt))
        if settings.debug:
            print_debug(f"{self.name}: {label or 'lap'} took {dt * 1e3:.2f} ms")
        return dt

    def total(self) -> float:
        return time.perf_counter() - self._start

    def process_skew(self) -> tuple[float, float]:
        """(min, max) of the last lap across processes (one process: the lap twice)."""
        last = self.laps[-1][1] if self.laps else 0.0
        dist = _distributed()
        if dist is not None and dist.get_world_size() > 1:
            gathered = [None] * dist.get_world_size()
            dist.all_gather_object(gathered, last)
            return float(min(gathered)), float(max(gathered))
        return last, last


def print_timing(name: str, seconds: float) -> None:
    """Print a phase's wall clock when verbose, debug or time stamps are on."""
    if settings.verbose or settings.debug or settings.show_times:
        _emit("TIMING: ", f"{name}: {seconds:.3f}s")


@contextmanager
def timed_phase(name: str):
    """Wall-clock a pipeline phase (IO, layout, kernel pass ...); printed
    when verbose, debug or time stamps are on (:func:`print_timing`). Device
    work that the phase enqueues is covered only if the phase ends in a
    synchronising call."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        print_timing(name, time.perf_counter() - t0)
