"""Row prep for the coherent-order engine: one pass over each 2048-lane row.

Counterpart: ``astro_sph_tools_tpu/ops/coherent_prep_pallas.py``. The
coherent deposit masks lanes by key equality, so stage A does not need a row
sort, only

1. every row's level >= 1 lanes moved to the row end (the tail gather takes
   each row's last ``tail_eff`` lanes),
2. key and payload channels kept lane-aligned for the in-place deposit, and
3. each row's distinct level-0 keys (the candidate list, <= d_max of them).

(1) is a stable two-sided partition, (3) up to d_max rounds of a min over
the masked keys. :func:`prep_rows` runs them in the hand-written CUDA kernel
``csrc/coherent.cu::coherent_prep_kernel`` on a CUDA tensor, and its plain
torch version :func:`prep_rows_plain` on a CPU tensor; both return the same
``packed`` (n_rows, 8, 2048) and ``aux`` (n_rows, 128) f32 arrays, bit for
bit. The kernel loads each thread's lanes (:func:`prep_lanes`) as float4s,
builds each row in shared memory and stores it whole, and stops a row's
candidate rounds at its last distinct head key (:func:`prep_rounds`).
:func:`_stage_a_prep` adds the small torch glue (candidate sort, bucket
grouping, counts vector) and returns the output tuple of
``deposit_coherent._assign_and_rowsort``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from .deposit import MapSpec
from .deposit_coherent import (
    _AUX_W,
    _CHUNK,
    _D_MAX,
    _K4_MAX_S,
    _MAX_FIELDS,
    _assign,
    _Setup,
    _setup,
    _stage_a_glue,
)
from .deposit_tiled import PALLAS_LEVELS

Tensor = torch.Tensor

_MAX_LEVELS = 4  # levels the kernel's parameter block holds


def prep_rows_plain(x: Tensor, y: Tensor, h: Tensor, values: Tensor, st: _Setup) -> tuple[Tensor, Tensor]:
    """Plain torch version of :func:`prep_rows` (same outputs, bit for bit).

    ``packed[r]`` holds [u_loc, v_loc, h, values..., ckey, 0...] with the
    row's level-0 lanes first and the rest last, each side in lane order.
    ``aux[r]`` holds: the row's d_max smallest distinct level-0 keys in
    ascending order (the pad key when it has fewer, or for every slot of a
    heavy row), tail_eff (C for a heavy row), n_l0, heavy, the lane counts
    of levels 1..n_levels (the last is oversize), one K4 flag per candidate
    slot (1 = no lane with that key has s_pix > 1), then zeros."""
    C, d_max, nl = _CHUNK, st.d_max, st.n_levels
    n_rows = x.shape[0] // C
    n_fields = values.shape[0]
    dev = x.device
    level, _, u_loc, v_loc, s_pix, ckey = _assign(x, y, h, st)

    def to2(a):
        return a.reshape(n_rows, C)

    key2 = to2(ckey)
    is_tail = key2 >= st.bases[1]
    tail_i = is_tail.to(torch.int32)
    incl = torch.cumsum(tail_i, 1, dtype=torch.int32)
    n_tail = incl[:, -1:]
    excl = incl - tail_i  # tails before each lane
    lane = torch.arange(C, dtype=torch.int32, device=dev)
    dest = torch.where(is_tail, C - n_tail + excl, lane - excl).to(torch.int64)
    src = torch.stack([to2(a) for a in (u_loc, v_loc, h, *values)] + [key2.to(torch.float32)], dim=1)
    packed = torch.zeros((n_rows, 8, C), dtype=torch.float32, device=dev)
    packed[:, :4 + n_fields].scatter_(2, dest[:, None, :].expand(-1, 4 + n_fields, -1), src)

    pad = st.pad_key
    masked = torch.where(is_tail, pad, key2)
    big = ~is_tail & (to2(s_pix) > _K4_MAX_S)
    cands, k4 = [], []
    for _ in range(d_max):
        m = masked.min(1, keepdim=True).values
        cands.append(m)
        k4.append(~((key2 == m) & big).any(1, keepdim=True))
        masked = torch.where(masked == m, pad, masked)
    heavy = masked.min(1, keepdim=True).values < st.bases[1]
    lev_cap = torch.clamp(to2(level), max=nl)
    cols = (
        [torch.where(heavy, pad, torch.cat(cands, 1)),
         torch.where(heavy, C, n_tail), C - n_tail, heavy]
        + [(lev_cap == li).sum(1, keepdim=True) for li in range(1, nl + 1)]
        + [torch.cat(k4, 1)]
    )
    aux_row = torch.cat([c.to(torch.float32) for c in cols], 1)
    aux = torch.zeros((n_rows, _AUX_W), dtype=torch.float32, device=dev)
    aux[:, :aux_row.shape[1]] = aux_row
    return packed, aux


def prep_lanes() -> Tensor:
    """(256, 8) int64: the lanes of a row that each of the kernel's 256
    threads loads, in the order it takes them. Thread t of warp w owns two
    runs of 4 lanes, one float4 each: from 256 w + 4 t and 128 lanes
    later, so that a warp's float4 load reads 512 contiguous bytes."""
    t = torch.arange(256)
    j = torch.arange(8)
    return ((t // 32) * 256 + (t % 32) * 4)[:, None] + (j // 4) * 128 + j % 4


def prep_rounds(aux: Tensor, st: _Setup) -> Tensor:
    """(n_rows,) int64: the candidate rounds the kernel takes for each row,
    read from the row's aux. A round takes one distinct head key; the rounds
    stop after the last one (after d_max of them for a heavy row, or one
    with d_max keys) and at least one runs. Each round is one block barrier
    (the scan adds one more)."""
    d = st.d_max
    n_keys = (aux[:, :d] != float(st.pad_key)).sum(1)
    return torch.where(aux[:, d + 2] > 0.5, d, n_keys.clamp_min(1))


def _vector_ready(a: Tensor) -> Tensor:
    """``a`` itself when the kernel's float4 loads can read it (16-byte
    aligned, rows a multiple of 4 floats apart), else an aligned contiguous
    copy, whose time the kernel's call then includes."""
    if a.data_ptr() % 16 == 0 and (a.ndim == 1 or a.stride(0) % 4 == 0):
        return a
    return a.clone(memory_format=torch.contiguous_format)


def _recip32(v: float) -> float:
    """1 / v rounded as f32: torch's CUDA division by a Python scalar
    multiplies by this reciprocal, and so does the kernel."""
    return float(np.float32(1.0) / np.float32(v))


def _kernel_params(st: _Setup):
    """The kernel's host parameter block: floats (x0, y0, 1/psx, 1/psy, nx,
    ny, support_factor, 1/min pixel, bound[4], 1/tx[4], 1/TY[4]) and ints
    (periodic, n_levels, d_max, n_tiles_x[4], n_tiles_y[4], tx[4], TY[4],
    M[4], bases[5]), from which the kernel repeats the f32 arithmetic of
    :func:`deposit_coherent._assign` on a CUDA tensor."""
    spec = st.spec
    ny, nx = spec.shape
    x0, _, y0, _ = spec.extent
    psy, psx = spec.pixel_size
    def pad4(vals, fill):
        return list(vals) + [fill] * (_MAX_LEVELS - len(vals))

    g = st.geoms
    floats = (
        [x0, y0, _recip32(psx), _recip32(psy), nx, ny, st.support_factor, _recip32(min(spec.pixel_size))]
        + pad4(st.bounds, -1.0)
        + pad4([_recip32(c.tx) if c else 0.0 for c in g], 0.0)
        + pad4([_recip32(c.cfg.TY) if c else 0.0 for c in g], 0.0)
    )
    ints = (
        [int(spec.periodic_wrap), st.n_levels, st.d_max]
        + pad4([c.n_tiles_x if c else 1 for c in g], 1)
        + pad4([c.n_tiles_y if c else 1 for c in g], 1)
        + pad4([c.tx if c else 1 for c in g], 1)
        + pad4([c.cfg.TY if c else 1 for c in g], 1)
        + pad4([c.cfg.M if c else 0 for c in g], 0)
        + list(st.bases) + [st.bases[-1]] * (_MAX_LEVELS + 1 - len(st.bases))
    )
    return (ctypes.c_float * len(floats))(*floats), (ctypes.c_int * len(ints))(*ints)


def _prep_rows(x: Tensor, y: Tensor, h: Tensor, values: Tensor, st: _Setup) -> tuple[Tensor, Tensor]:
    if x.device.type == "cpu":
        return prep_rows_plain(x, y, h, values, st)
    if x.device.type != "cuda":
        raise ValueError(f"no row-prep kernel for device {x.device}")
    dev = x.device
    n = x.shape[0]
    for name, a in (("x", x), ("y", y), ("h", h)):
        if a.dtype != torch.float32 or a.device != dev or a.ndim != 1 or not a.is_contiguous() or a.shape[0] != n:
            raise ValueError(f"{name} must be a contiguous 1-D float32 tensor of {n} entries on {dev}")
    if (
        values.dtype != torch.float32 or values.device != dev or values.ndim != 2
        or values.shape[1] != n or values.stride(1) != 1
    ):
        raise ValueError(f"values must be a (F, {n}) float32 tensor on {dev} with unit column stride")
    n_fields = values.shape[0]
    if not 1 <= n_fields <= _MAX_FIELDS:
        raise ValueError(f"the row-prep kernel takes 1..{_MAX_FIELDS} fields, got {n_fields}")
    if n % _CHUNK:
        raise ValueError(f"the row-prep kernel takes whole {_CHUNK}-lane rows, got {n} particles")
    if st.n_levels > _MAX_LEVELS:
        raise ValueError(f"the row-prep kernel takes at most {_MAX_LEVELS} levels, got {st.n_levels}")
    n_rows = n // _CHUNK
    x, y, h, values = (_vector_ready(a) for a in (x, y, h, values))
    packed = torch.empty((n_rows, 8, _CHUNK), dtype=torch.float32, device=dev)
    aux = torch.empty((n_rows, _AUX_W), dtype=torch.float32, device=dev)
    if n_rows == 0:
        return packed, aux
    lib, _ = _build.load("coherent")
    fparams, iparams = _kernel_params(st)
    nf, ni = ctypes.c_int(), ctypes.c_int()
    lib.coherent_prep_param_counts(ctypes.byref(nf), ctypes.byref(ni))
    if (nf.value, ni.value) != (len(fparams), len(iparams)):
        raise RuntimeError(f"row-prep parameter block mismatch: the library takes {nf.value}/{ni.value}")
    with torch.cuda.device(dev):
        code = lib.coherent_prep_launch(
            x.data_ptr(), y.data_ptr(), h.data_ptr(), values.data_ptr(),
            values.stride(0), n_fields, n_rows, packed.data_ptr(), aux.data_ptr(),
            fparams, iparams, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, code, "row-prep kernel")
    prep_rows.launches += 1
    return packed, aux


def prep_rows(
    x: Tensor, y: Tensor, h: Tensor, values: Tensor, spec: MapSpec,
    *,
    kernel: str = "cubic_spline",
    levels=PALLAS_LEVELS,
    d_max: int = _D_MAX,
) -> tuple[Tensor, Tensor]:
    """Row prep of f32 particles ``x, y, h`` (n,) and ``values`` (F, n),
    with n a multiple of 2048: returns ``packed`` (n_rows, 8, 2048) and
    ``aux`` (n_rows, 128) f32 (see :func:`prep_rows_plain`). On a CUDA
    tensor this launches the hand-written kernel ``csrc/coherent.cu`` (built
    at first use) and raises if the build or the launch fails; on a CPU
    tensor it runs :func:`prep_rows_plain`. An input the kernel's float4
    loads cannot read (not 16-byte aligned, or ``values`` rows not a
    multiple of 4 floats apart) is copied first."""
    return _prep_rows(x, y, h, values, _setup(spec, kernel, levels, d_max))


#: kernel launches made by :func:`prep_rows` in this process (CUDA only)
prep_rows.launches = 0


def _stage_a_prep(x: Tensor, y: Tensor, h: Tensor, values: Tensor, st: _Setup):
    """Stage A with ``prep="pallas"``: the row prep (kernel or plain), then
    the small torch glue. Same output tuple as
    ``deposit_coherent._assign_and_rowsort``."""
    packed, aux = _prep_rows(x, y, h, values, st)
    d, nl = st.d_max, st.n_levels
    return (packed, *_stage_a_glue(
        aux[:, :d].to(torch.int32),  # candidate keys, ascending + pad key
        aux[:, d + 3 + nl:2 * d + 3 + nl].to(torch.int32),  # K4 flags
        aux[:, d].to(torch.int32),  # tail_eff
        aux[:, d + 2] > 0.5,  # heavy
        aux[:, d + 1].to(torch.int32),  # n_l0
        aux[:, d + 3:d + 3 + nl].to(torch.int64).sum(0),  # lanes per level 1..n_levels
        st,
    ))
