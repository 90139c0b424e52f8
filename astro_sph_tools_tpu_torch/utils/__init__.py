"""Utilities: console output, settings and phase timing.

Counterpart: ``astro_sph_tools_tpu/utils/__init__.py`` (the ported part:
the console module and ``PhaseTimer``; ``device_trace`` and the determinism
helpers are still to port)."""

from .console import (
    Settings,
    Stopwatch,
    print_debug,
    print_error,
    print_info,
    print_verbose_info,
    print_verbose_warning,
    print_warning,
    settings,
    show_times,
    timed_phase,
)
from .profiling import PhaseTimer

__all__ = [
    "PhaseTimer",
    "Settings",
    "Stopwatch",
    "print_debug",
    "print_error",
    "print_info",
    "print_verbose_info",
    "print_verbose_warning",
    "print_warning",
    "settings",
    "show_times",
    "timed_phase",
]
