"""Build and load the package's CUDA kernel libraries.

Every ``csrc/<name>.cu`` holds kernels with a plain C interface (today
``deposit2d.cu``, the sorted engine's deposit; ``coherent.cu``, the
coherent engine's row prep and deposit; ``sightlines.cu``, the sightline
columns and spectra; ``deposit3d.cu``, the 3D voxel deposit, these four
including ``csrc/deposit_common.cuh``; ``layout_shear.cu``, the gang append
of the random-order grouping). At first
use each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into its
own shared library under
``_build/``, named by a hash of the source, of every ``csrc/*.cuh`` it
includes (directly or through another header) and of the flags, and loaded
with ``ctypes``. A build that fails, or a machine without ``nvcc``, raises
with the compiler's message: nothing falls back to another path.

The host-side C library ``native/hostops.c`` (the f64 tile assignment, the
scale-and-cast pass and the Morton-delta encoder of the streamed ingest) is
built the same way beside them, with the system C compiler
(``cc -O3 -shared -fPIC``), by :func:`load_host`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent
_SRC_DIR = _PKG_DIR / "csrc"
_BUILD_DIR = _PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_HOST_SRC = _PKG_DIR / "native" / "hostops.c"
# no FMA contraction: the host assignment repeats the torch formulation's
# f64 arithmetic operation by operation
CC_FLAGS = ("-O3", "-shared", "-fPIC", "-ffp-contract=off")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong

# C signatures per library; every function returns an int (a cudaError_t)
_SIGNATURES = {
    "deposit2d": {
        "deposit2d_launch": [
            _P, _P, _P, _P, _LL, _I,  # u, v, h, values, values row stride, n_fields
            _P, _P, _I,  # pstart, pcount, n_tiles
            _P,  # out (n_tiles, F*R, 128)
            _I, _I,  # K, R
            _F, _F, _F,  # offset, psx, psy
            _I, _I, _F, _F,  # kernel id, integrated, norm_3d, support_factor
            _P, _I,  # chebyshev coefficients, count
            _I,  # blocks a tile (cluster size)
            _P,  # cudaStream_t
        ],
    },
    "coherent": {
        "coherent_prep_launch": [
            _P, _P, _P, _P, _LL, _I,  # x, y, h, values, values row stride, n_fields
            _I, _P, _P,  # n_rows, packed (n_rows, 8, 2048), aux (n_rows, 128)
            ctypes.POINTER(_F), ctypes.POINTER(_I),  # host float / int parameters
            _P,  # cudaStream_t
        ],
        "coherent_deposit_launch": [
            _P, _I,  # packed rows, n_fields
            _P, _P, _P, _I,  # cand_row, cstart, cend, n_tiles
            _P,  # out (n_tiles, F*R, 128)
            _I, _I, _F, _F, _F,  # K, R, offset, psx, psy
            _I, _I, _F, _F,  # kernel id, integrated, norm_3d, support_factor
            _P, _I,  # chebyshev coefficients, count
            _I,  # blocks a tile (cluster size)
            _P,  # cudaStream_t
        ],
        "coherent_prep_param_counts": [ctypes.POINTER(_I), ctypes.POINTER(_I)],
    },
    "sightlines": {
        "sightline_columns_launch": [
            _P, _LL, _I, _I,  # packed channel rows, row stride, particles, n_fields
            _P, _P, _P, _P, _I,  # bounds, rx, ry (n_rays,), rays (2, n_levels, n_rays), n_rays
            ctypes.POINTER(_I), _I,  # host grids (n_levels x (ncx, ncy, offset)), n_levels
            _P, _P,  # item sums (n_rays, n_levels * 3, F), out (F, n_rays)
            _I, _F, _F,  # periodic, Lx, Ly
            _I, _I, _F, _F,  # kernel id, integrated, norm_3d, support_factor
            _P, _I,  # chebyshev coefficients, count
            _P,  # cudaStream_t
        ],
        "sightline_spectra_launch": [
            _P, _LL,  # packed channel rows, row stride
            _P, _P, _P, _P, _P, _I,  # rx, ry (n_blocks, 32), lo, hi (n_blocks, 10), block order, n_blocks
            _P, _I, _P,  # v_centres, n_bins, out (n_blocks, 32, n_bins)
            _I, _F, _F, _F,  # periodic, Lx, Ly, support_factor
            _P, _I,  # chebyshev coefficients, count
            _I, _F, _I,  # wrap velocities, v_box, n_images
            _I, _F,  # voigt, voigt_k
            _P,  # cudaStream_t
        ],
    },
    "deposit3d": {
        "deposit3d_launch": [
            _P, _P, _P, _P, _P, _LL, _I,  # u, v, w, h, values, values row stride, n_fields
            _P, _P,  # pstart, pcount per tile
            _P, _P, _P, _I, _I, _I,  # z, y, x candidate-pair tables and their widths
            _P, _I,  # items (n_items, 4), n_items
            _P,  # out (F, nz, ny, nx), added into
            _I, _I, _I, _I, _I, _I,  # K, TZ, TY, TX, tiles per x row, tiles per y column
            _I, _I, _I,  # nz, ny, nx
            _F, _F, _F, _F,  # offset, psx, psy, psz
            _I, _F, _F,  # kernel id, norm_3d, support_factor
            _P,  # cudaStream_t
        ],
    },
    "layout_shear": {
        "append_gangs_launch": [
            _P, _P, _P, _I, _I,  # src gangs, dst gangs, schedule (n_sub, 3), n_sub, channels
            _I,  # log2 of the warps per sub-run
            _P,  # cudaStream_t
        ],
    },
}

LIBRARIES = tuple(_SIGNATURES)


@dataclass(frozen=True)
class BuildInfo:
    """Where a library is, and what building it took (0 s when cached)."""

    path: Path
    seconds: float
    built: bool
    log: str


_lock = threading.Lock()
_loaded: dict[str, tuple[ctypes.CDLL, BuildInfo]] = {}

_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+\.cuh)"', re.M)


def _find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (searched PATH and $CUDA_HOME/bin): the CUDA kernels "
        "of astro_sph_tools_tpu_torch need the CUDA toolkit to build"
    )


def _headers(src: Path, src_dir: Path) -> list[Path]:
    """Every ``src_dir/*.cuh`` that ``src`` includes, directly or not, in a
    stable order."""
    seen: dict[str, Path] = {}
    todo = [src]
    while todo:
        for inc in _INCLUDE.findall(todo.pop().read_bytes()):
            name = inc.decode()
            path = src_dir / name
            if name not in seen and path.exists():
                seen[name] = path
                todo.append(path)
    return [seen[k] for k in sorted(seen)]


def library_path(name: str, src_dir: Path = _SRC_DIR, build_dir: Path = _BUILD_DIR) -> Path:
    """The library ``csrc/<name>.cu`` builds into: named by a hash of the
    source, of the headers it includes and of the flags."""
    src = src_dir / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for hdr in _headers(src, src_dir):
        h.update(hdr.name.encode() + b"\0" + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir / f"lib{name}_{h.hexdigest()[:16]}.so"


def _build(name: str) -> BuildInfo:
    src = _SRC_DIR / f"{name}.cu"
    lib_path = library_path(name)
    if lib_path.exists():
        return BuildInfo(lib_path, 0.0, False, "")
    nvcc = _find_nvcc()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {src}:\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib_path)
    return BuildInfo(lib_path, seconds, True, proc.stdout + proc.stderr)


def _open(name: str, info: BuildInfo) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(info.path))
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def load(name: str = "deposit2d") -> tuple[ctypes.CDLL, BuildInfo]:
    """Build ``csrc/<name>.cu`` if needed, load it, and declare its C
    signatures. Cached per process."""
    if name not in _SIGNATURES:
        raise ValueError(f"unknown kernel library {name!r}; expected one of {LIBRARIES}")
    with _lock:
        if name not in _loaded:
            info = _build(name)
            _loaded[name] = (_open(name, info), info)
        return _loaded[name]


def load_all() -> dict[str, tuple[ctypes.CDLL, BuildInfo]]:
    """Build every library at once (one ``nvcc`` per source, all started
    together) and load them. Raises with the first failing build's output."""
    with _lock:
        todo = [n for n in LIBRARIES if n not in _loaded]
        with ThreadPoolExecutor(max_workers=max(1, len(todo))) as pool:
            infos = dict(zip(todo, pool.map(_build, todo)))
        for name, info in infos.items():
            _loaded[name] = (_open(name, info), info)
        return {n: _loaded[n] for n in LIBRARIES}


def _find_cc() -> str:
    for name in ("cc", "gcc", "clang"):
        cand = shutil.which(name)
        if cand:
            return cand
    raise RuntimeError(
        "no C compiler found (cc, gcc, clang on PATH): the host library "
        "native/hostops.c of astro_sph_tools_tpu_torch needs one to build"
    )


def host_library_path(src: Path = _HOST_SRC, build_dir: Path = _BUILD_DIR) -> Path:
    """The library ``src`` builds into: named by a hash of the source and
    of the flags."""
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(CC_FLAGS).encode())
    return build_dir / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build_host(src: Path = _HOST_SRC, build_dir: Path = _BUILD_DIR) -> BuildInfo:
    """Compile a plain C source into a shared library under ``build_dir``
    (once: an existing library of the same hash is reused). Raises with the
    compiler's message when the build fails."""
    lib_path = host_library_path(src, build_dir)
    if lib_path.exists():
        return BuildInfo(lib_path, 0.0, False, "")
    cc = _find_cc()
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cc, *CC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"{os.path.basename(cc)} failed ({proc.returncode}) building {src}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib_path)  # atomic: concurrent builders race benignly
    return BuildInfo(lib_path, seconds, True, proc.stdout + proc.stderr)


def load_host() -> tuple[ctypes.CDLL, BuildInfo]:
    """Build ``native/hostops.c`` if needed and load it (cached per
    process); the caller declares its C signatures."""
    with _lock:
        if "hostops" not in _loaded:
            info = build_host()
            _loaded["hostops"] = (ctypes.CDLL(str(info.path)), info)
        return _loaded["hostops"]
