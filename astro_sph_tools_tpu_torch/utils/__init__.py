"""Utilities: console output and phase timing.

Counterpart: ``astro_sph_tools_tpu/utils/__init__.py`` (the ported part:
``print_info``, ``timed_phase``, ``settings`` and ``PhaseTimer``)."""

from .console import Settings, print_info, settings, timed_phase
from .profiling import PhaseTimer

__all__ = ["PhaseTimer", "Settings", "print_info", "settings", "timed_phase"]
