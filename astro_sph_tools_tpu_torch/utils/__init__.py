"""Utilities: console output, settings and phase timing.

Counterpart: ``astro_sph_tools_tpu/utils/__init__.py`` (the JAX package's
``count_compilations`` has no counterpart in eager torch)."""

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
from .determinism import (
    assert_consistent_across_processes,
    assert_deterministic,
    hash_array,
    hash_pytree,
)
from .profiling import DeviceTrace, PhaseTimer, device_trace

__all__ = [
    "DeviceTrace",
    "PhaseTimer",
    "assert_consistent_across_processes",
    "assert_deterministic",
    "device_trace",
    "hash_array",
    "hash_pytree",
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
