"""Console output and phase timing for the command-line tools.

Counterpart: ``astro_sph_tools_tpu/utils/console.py``; the part the ported
CLI uses: ``print_info``, ``timed_phase`` and the verbosity ``settings``
that gate the timing lines. The port runs one process, so there is no
root-rank gating.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass


@dataclass
class Settings:
    """Global verbosity/debug switches (parity: QuasarCode Settings)."""

    verbose: bool = False
    debug: bool = False
    show_times: bool = False


settings = Settings()


def _emit(prefix: str, message: str) -> None:
    stamp = time.strftime("[%H:%M:%S] ") if settings.show_times else ""
    print(f"{stamp}{prefix}{message}", flush=True)


def print_info(message: str) -> None:
    _emit("", message)


@contextmanager
def timed_phase(name: str):
    """Wall-clock a pipeline phase (IO, layout, kernel pass ...); printed
    when verbose, debug or time stamps are on. Device work that the phase
    enqueues is covered only if the phase ends in a synchronising call."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if settings.verbose or settings.debug or settings.show_times:
            _emit("TIMING: ", f"{name}: {dt:.3f}s")
