"""Native (C) host-staging kernels, built at first use and loaded via ctypes.

Counterpart: ``astro_sph_tools_tpu/native/__init__.py``. The device path is
PyTorch and the CUDA kernels of ``csrc/``; this package covers the host side
of ingest with the port's own ``hostops.c``, compiled by
``_build.build_host`` (``cc -O3 -shared -fPIC``) into the package's
``_build/`` at first use:

- :func:`assign_tiles_f64` — the sorted engine's fused (footprint level,
  tile, tile-local f32 coordinates) assignment of host f64 coordinates, bit
  for bit the torch formulation of ``ops/deposit_tiled.py``
  (``_pixel_coords``, ``_multi_level_assign``), which stays as its plain
  version, split over the host's cores (each call releases the GIL);
- :func:`scale_cast` — one-pass ``(src * scale).astype(float32)``;
- :func:`morton_delta_encode_u16` — the Morton-delta position encoder of
  ``io/packing.py``, bit for bit with its NumPy formulation.

Unlike the JAX package, nothing here returns None to fall back to NumPy: a
machine without a C compiler, or a failed build, raises with the
compiler's message.
"""

from __future__ import annotations

import ctypes
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
_F64 = ctypes.c_double
_PD = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_PF = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_PI = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_PI16 = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
_PI64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_PU16 = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
_PU32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")

_SIGNATURES = {
    "assign_tiles_f64": [
        _PD, _PD, _PF, _I64,  # x, y, h, n
        _F64, _F64, _F64, _F64, _F64,  # x0, y0, psx, psy, ps_min
        _I64, _I64, _I32, _F64,  # nx, ny, periodic, support factor
        _I32, _PD, _PI, _PI, _PI, _PI, _PI, _I64,  # levels, bounds, ntx, nty, tw, th, marg, stride
        _PI, _PF, _PF,  # key, u_loc, v_loc
    ],
    "scale_cast_f64": [_PD, _I64, _F64, _PF],
    "scale_cast_f32": [_PF, _I64, _F64, _PF],
    "morton_delta_encode_u16": [
        _PU16, _PU16, _I64, _I64, _PI16, _PU32, _PI64, _PU32, ctypes.POINTER(ctypes.c_int64),
    ],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_MIN_SPAN = 1 << 16  # particles a thread takes at least


def _spans(n: int) -> list[tuple[int, int]]:
    """[lo, hi) spans of ``n`` items, one per core this process may run on
    (at most ``n / _MIN_SPAN`` of them)."""
    parts = max(1, min(len(os.sched_getaffinity(0)), n // _MIN_SPAN))
    edges = np.linspace(0, n, parts + 1).astype(np.int64)
    return [(int(a), int(b)) for a, b in zip(edges[:-1], edges[1:])]


def get_lib() -> ctypes.CDLL:
    """The compiled host library (built on first use; raises if it cannot
    be built)."""
    global _lib
    with _lock:
        if _lib is None:
            from .. import _build

            lib, _ = _build.load_host()
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = None
            _lib = lib
        return _lib


def assign_tiles_f64(
    x: np.ndarray,
    y: np.ndarray,
    h: np.ndarray,
    *,
    x0: float,
    y0: float,
    psx: float,
    psy: float,
    nx: int,
    ny: int,
    periodic: bool,
    support_factor: float,
    bounds: Sequence[float],  # per-level max s_pix, < 0 for disabled levels
    ntx: Sequence[int],
    nty: Sequence[int],
    tw: Sequence[int],
    th: Sequence[int],
    marg: Sequence[int],
    stride: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(composite key int32, tile-local u f32, tile-local v f32) of every
    particle, each under its own level's geometry; oversize particles get
    the key ``len(bounds) * stride`` and global pixel coordinates."""
    lib = get_lib()
    x = np.ascontiguousarray(x, np.float64)
    y = np.ascontiguousarray(y, np.float64)
    h = np.ascontiguousarray(h, np.float32)
    n = x.shape[0]
    if y.shape[0] != n or h.shape[0] != n:
        raise ValueError(f"x, y and h differ in length: {n}, {y.shape[0]}, {h.shape[0]}")
    n_levels = len(bounds)
    geom = [np.ascontiguousarray(g, np.int32) for g in (ntx, nty, tw, th, marg)]
    if any(g.shape != (n_levels,) for g in geom):
        raise ValueError(f"every per-level geometry array needs {n_levels} entries")
    key = np.empty(n, np.int32)
    u_loc = np.empty(n, np.float32)
    v_loc = np.empty(n, np.float32)
    bounds = np.ascontiguousarray(bounds, np.float64)

    def run(span):
        lo, hi = span
        lib.assign_tiles_f64(
            x[lo:hi], y[lo:hi], h[lo:hi], hi - lo,
            float(x0), float(y0), float(psx), float(psy), float(min(psx, psy)),
            int(nx), int(ny), int(bool(periodic)), float(support_factor),
            n_levels, bounds, *geom, int(stride),
            key[lo:hi], u_loc[lo:hi], v_loc[lo:hi],
        )

    spans = _spans(n)
    if len(spans) == 1:
        run(spans[0])
    else:
        with ThreadPoolExecutor(len(spans), thread_name_prefix="ast-assign") as pool:
            list(pool.map(run, spans))
    return key, u_loc, v_loc


def scale_cast(src: np.ndarray, scale: float) -> np.ndarray:
    """One-pass ``(src * scale).astype(float32)`` of an f32 or f64 array,
    the product taken in f64."""
    src = np.ascontiguousarray(src)
    if src.dtype == np.float64:
        fn = get_lib().scale_cast_f64
    elif src.dtype == np.float32:
        fn = get_lib().scale_cast_f32
    else:
        raise TypeError(f"scale_cast takes float32 or float64 arrays, got {src.dtype}")
    out = np.empty(src.shape, np.float32)
    flat = src.reshape(-1)
    fn(flat, flat.shape[0], float(scale), out.reshape(-1))
    return out


def morton_delta_encode_u16(x_q: np.ndarray, y_q: np.ndarray, seg: int):
    """One-pass Morton-delta encode (``io/packing.py`` semantics):
    ``(deltas int16, bases uint32, exc_idx int64, exc_corr uint32, n)``."""
    lib = get_lib()
    x_q = np.ascontiguousarray(x_q, np.uint16)
    y_q = np.ascontiguousarray(y_q, np.uint16)
    n = x_q.shape[0]
    if y_q.shape[0] != n:
        raise ValueError(f"x_q and y_q differ in length: {n}, {y_q.shape[0]}")
    n_seg = -(-n // seg)
    deltas = np.empty(n_seg * seg, np.int16)
    bases = np.empty(n_seg, np.uint32)
    exc_idx = np.empty(n_seg * seg, np.int64)
    exc_corr = np.empty(n_seg * seg, np.uint32)
    ne = ctypes.c_int64(0)
    lib.morton_delta_encode_u16(x_q, y_q, n, seg, deltas, bases, exc_idx, exc_corr, ctypes.byref(ne))
    k = int(ne.value)
    return deltas, bases, exc_idx[:k].copy(), exc_corr[:k].copy(), n
