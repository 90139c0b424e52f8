"""``h5py``, imported on first use.

The readers of this package (``io.eagle``, ``io.subfind``, ``io.swift``,
``io.tng``, ``io.los``, ``io.particle_filter``) name ``h5py`` at module
level as the JAX package's copies do, but through this proxy: importing
them does not import ``h5py``, which a machine that only renders from
memory need not have. The first attribute read (``h5py.File``, ...)
imports it.
"""

from __future__ import annotations

import importlib


class _LazyModule:
    def __init__(self, name: str) -> None:
        self._name = name

    def __getattr__(self, attr: str):
        return getattr(importlib.import_module(self._name), attr)


h5py = _LazyModule("h5py")
