"""Compact host->device particle payloads for streaming ingest.

Counterpart: ``astro_sph_tools_tpu/io/packing.py``. The deposit consumes
f32 positions, smoothing lengths and field values; full-width f32 on the
wire is wasted precision:

- positions quantise to fixed-point ``uint16`` per axis (box/65536 cells,
  decoded at the cell centre: unbiased), or to a Morton-delta stream of
  ~2 B/particle when the storage order follows a space-filling curve
  (:func:`morton_delta_encode`);
- smoothing lengths ride IEEE ``float16``;
- field values ride ``float16`` with a caller-chosen power-of-two scale, or
  ``uint8`` logarithms per 4096-record segment (positive fields only).

Not copied: the JAX package's u8 tier quantises ``log2(fields[f])`` and
ignores ``field_scales``, while its unpack multiplies by
``field_unpack_scales`` (which default to ``field_scales``). So a u8 field
packed with a non-1 scale comes back multiplied by it: the JAX package's
``benchmarks/e2e_1e8.py`` "packdelta" wire, which passes its f16 prescales
(2^-14 for masses, 2^16 for temperatures) with ``field_dtype="u8"``,
decodes masses 2^-14 times and temperatures 2^16 times too large. Here the
u8 tier quantises ``log2(fields[f] / field_scales[f])``, as the f16 tier
stores ``fields[f] / field_scales[f]``; with unit scales the two packages
pack the same bits.

:func:`pack_particles_host` is NumPy on the host, bit for bit the JAX
package's (its Morton-delta pass runs in the native library,
``native/hostops.c``; :func:`morton_delta_encode_plain` is the NumPy
formulation it equals). :func:`unpack_particles_device` is a plain torch
pass on the leaves' device, in the JAX package's f32 operation order.

Torch has little arithmetic on CUDA for ``uint16`` and ``uint32``, so the
tensor form of a packed block (:func:`packed_to_tensors`) carries the
``uint16`` leaves as their ``int16`` bits (widened on the device with
``.to(int32) & 0xFFFF``) and the ``uint32`` leaves as ``int64``.

The u8-log fields decode in f64 through :func:`exp2_exact`, a polynomial of
plain multiplies and adds rounded once to f32, so that a decode on the card
equals the decode on the CPU bit for bit (``torch.exp2`` in f32 is rounded
differently by the two devices' math libraries) and lies within an ulp of
the exact value. The JAX package's decode (f32 ``lo + q * step``, which XLA
fuses into one FMA, then XLA's f32 ``exp2``) is up to ~30 ulps off it.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
from torch import Tensor

from ..ops.deposit_tiled import device_const

__all__ = [
    "PackedParticles",
    "pack_particles_host",
    "unpack_particles_device",
]

_DELTA_CHUNK = 4096  # records per delta segment (absolute base per segment)


@dataclass
class PackedParticles:
    """Quantised particle block (host NumPy or torch tensor leaves).

    ``x_q``/``y_q``: uint16 fixed point over [x0, x0+box) / [y0, y0+box)
    (int16 bits as tensors). ``h_q``: float16 smoothing lengths.
    ``fields_q``: (F, N) float16, value = fields_q * field_scales[f] after
    unpack, or (F, n_seg * 4096) uint8 logarithms with ``field_log_meta``.
    """

    x_q: Optional[np.ndarray]
    y_q: Optional[np.ndarray]
    h_q: np.ndarray
    fields_q: np.ndarray
    x0: float
    y0: float
    box: float
    field_scales: tuple
    #: scalar applied to h at unpack (fold a raw->user unit conversion into
    #: the device pass: pack h in on-disk internal units, unpack in Mpc)
    h_scale: float = 1.0
    #: scalar applied to decoded positions at unpack (same folding for x/y
    #: when ``box``/``x0``/``y0`` were given in raw internal units)
    pos_scale: float = 1.0
    #: Morton-delta position stream (deltas, bases, exc_idx, exc_corr, n);
    #: replaces x_q/y_q (None) when the storage order is curve-coherent
    pos_delta: Optional[tuple] = None
    #: per-segment u8-log field metadata (lo (F, n_seg) f32, step (F,
    #: n_seg) f32) when ``fields_q`` is uint8
    field_log_meta: Optional[tuple] = None

    @property
    def n_particles(self) -> int:
        return self.pos_delta[4] if self.pos_delta else self.x_q.shape[0]

    @property
    def nbytes(self) -> int:
        if self.pos_delta is not None:
            d, b, ei, ec, _ = self.pos_delta
            pos = d.nbytes + b.nbytes + ei.nbytes + ec.nbytes
        else:
            pos = self.x_q.nbytes + self.y_q.nbytes
        meta = sum(a.nbytes for a in self.field_log_meta) if self.field_log_meta is not None else 0
        return pos + self.h_q.nbytes + self.fields_q.nbytes + meta


def pack_particles_host(
    x: np.ndarray,
    y: np.ndarray,
    h: np.ndarray,
    fields: Sequence[np.ndarray],
    *,
    box: float,
    x0: float = 0.0,
    y0: float = 0.0,
    field_scales: Optional[Sequence[float]] = None,
    field_unpack_scales: Optional[Sequence[float]] = None,
    h_scale: float = 1.0,
    pos_scale: float = 1.0,
    pos_encoding: str = "u16",
    field_dtype: str = "f16",
) -> PackedParticles:
    """Quantise one particle block on the host (one pass per channel).

    ``field_scales[f]`` should be a power of two bringing ``fields[f] /
    scale`` into f16 range; defaults to 1.0 per field. Unit conversion can
    ride the unpack: pass raw on-disk arrays with ``box``/``x0``/``y0`` in
    the same raw units and set ``pos_scale``, ``h_scale`` and
    ``field_unpack_scales`` to the raw->user conversions (times
    ``field_scales``). ``pos_encoding``: ``"u16"``, ``"delta"`` or
    ``"auto"`` (the delta stream when at most a tenth of the records are
    exceptions); ``field_dtype``: ``"f16"`` or ``"u8"`` (log, positive
    fields).
    """
    n = x.shape[0]
    inv = np.float64(65536.0) / box
    # u = floor((x - x0) / box * 65536), clipped into the box. The upper
    # clip must be exactly representable in float32: a bound like
    # 65535.999 rounds up to 65536.0f for f32 positions, which
    # .astype(np.uint16) would wrap to 0. 65535.0 is exact in f32 and floors
    # to the same last cell.
    x_q = np.clip((x - x0) * inv, 0, 65535.0).astype(np.uint16)
    y_q = np.clip((y - y0) * inv, 0, 65535.0).astype(np.uint16)
    pos_delta = None
    if pos_encoding not in ("u16", "delta", "auto"):
        raise ValueError(f"unknown pos_encoding {pos_encoding!r}")
    if pos_encoding in ("delta", "auto"):
        pd = morton_delta_encode(x_q, y_q)
        if pos_encoding == "delta" or pd[2].size <= 0.1 * n:
            pos_delta = pd
            x_q = y_q = None
    h_q = np.asarray(h, dtype=np.float16)
    if field_scales is None:
        field_scales = (1.0,) * len(fields)
    if len(field_scales) != len(fields):
        raise ValueError("field_scales must match fields")
    if field_unpack_scales is None:
        field_unpack_scales = field_scales
    if len(field_unpack_scales) != len(fields):
        raise ValueError("field_unpack_scales must match fields")
    field_log_meta = None
    if field_dtype == "u8":
        # per-segment log quantisation: 1 B/particle/field, relative step
        # (local log2 range)/255 per 4096-record segment. The logarithm is
        # of fields[f] / field_scales[f], as the f16 tier stores it, so that
        # the unpack's multiply by field_unpack_scales gives the value back
        # (the JAX package takes log2(fields[f]) and ignores field_scales
        # here, so a non-1 field_scales comes back multiplied in)
        n_seg = -(-n // _DELTA_CHUNK)
        pad = n_seg * _DELTA_CHUNK - n
        fields_q = np.empty((len(fields), n_seg * _DELTA_CHUNK), np.uint8)
        lo_m = np.empty((len(fields), n_seg), np.float32)
        st_m = np.empty((len(fields), n_seg), np.float32)
        for fi, (f, s) in enumerate(zip(fields, field_scales)):
            f = np.asarray(f, np.float64)
            if f.min() <= 0:
                raise ValueError("field_dtype='u8' log packing needs positive fields")
            if s != 1.0:
                f = f / s
            lg = np.pad(np.log2(f), (0, pad), mode="edge").reshape(n_seg, _DELTA_CHUNK)
            lo = lg.min(axis=1)
            step = np.maximum((lg.max(axis=1) - lo) / 255.0, 1e-12)
            q = np.rint((lg - lo[:, None]) / step[:, None])
            fields_q[fi] = np.clip(q, 0, 255).reshape(-1).astype(np.uint8)
            lo_m[fi] = lo
            st_m[fi] = step
        field_log_meta = (lo_m, st_m)
    elif field_dtype == "f16":
        fields_q = np.empty((len(fields), n), dtype=np.float16)
        for fi, (f, s) in enumerate(zip(fields, field_scales)):
            np.multiply(f, 1.0 / s, out=fields_q[fi], casting="unsafe")
    else:
        raise ValueError(f"unknown field_dtype {field_dtype!r}")
    return PackedParticles(
        x_q=x_q, y_q=y_q, h_q=h_q, fields_q=fields_q,
        x0=float(x0), y0=float(y0), box=float(box),
        field_scales=tuple(float(s) for s in field_unpack_scales),
        h_scale=float(h_scale),
        pos_scale=float(pos_scale),
        pos_delta=pos_delta,
        field_log_meta=field_log_meta,
    )


def host_leaf_to_tensor(a) -> Tensor:
    """A host NumPy leaf as a CPU tensor torch can compute with on any
    device: uint16 as its int16 bits, uint32 widened to int64, everything
    else as it is (no copy where the dtype allows)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint16:
        a = a.view(np.int16)
    elif a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(a)


def packed_to_tensors(packed: PackedParticles, device="cuda") -> PackedParticles:
    """The same block with every array leaf a tensor on ``device``
    (:func:`host_leaf_to_tensor`'s dtypes)."""
    def leaf(a):
        if isinstance(a, Tensor):
            return a.to(device)
        return host_leaf_to_tensor(a).to(device)

    def opt(a):
        return None if a is None else leaf(a)

    return dataclasses.replace(
        packed,
        x_q=opt(packed.x_q), y_q=opt(packed.y_q),
        h_q=leaf(packed.h_q), fields_q=leaf(packed.fields_q),
        pos_delta=None if packed.pos_delta is None else (
            *(leaf(a) for a in packed.pos_delta[:4]), packed.pos_delta[4],
        ),
        field_log_meta=None if packed.field_log_meta is None else tuple(
            leaf(a) for a in packed.field_log_meta
        ),
    )


def _u16(q: Tensor) -> Tensor:
    """uint16 values (carried as int16 bits, or already widened) as int32."""
    if q.dtype == torch.int16:
        return q.to(torch.int32) & 0xFFFF
    return q.to(torch.int32)


# 2^r = exp(r ln 2) for r in [-1/2, 1/2]: Taylor coefficients (ln 2)^k / k!,
# k = 0..14 (truncation < 1e-18, far under f64's rounding)
_EXP2_COEFFS = tuple(math.log(2.0) ** k / math.factorial(k) for k in range(15))


def exp2_exact(lg: Tensor) -> Tensor:
    """``2 ** lg`` as f32, through an f64 polynomial of plain multiplies and
    adds and one exact power-of-two scale: the same bits on every device
    (IEEE f64 arithmetic, one rounding to f32), within an ulp of the exact
    value. ``lg`` must keep 2 ** lg inside f32's normal range (the u8-log
    fields do)."""
    x = lg.to(torch.float64)
    k = torch.round(x)
    r = x - k  # exact, |r| <= 1/2
    p = torch.full_like(r, _EXP2_COEFFS[-1])
    for c in _EXP2_COEFFS[-2::-1]:
        p = p * r + c
    # 2^k built from its exponent bits, exact
    scale = ((k.to(torch.int64) + 1023) << 52).view(torch.float64)
    return (p * scale).to(torch.float32)


def unpack_particles_device(packed: PackedParticles, device="cuda"):
    """Quantised block -> (x, y, h, fields) f32 tensors on ``device``.

    NumPy leaves are moved to ``device`` first; tensor leaves already there
    stay. Fixed-point cells decode at their centre ((q + 0.5) * box /
    65536), in the JAX package's f32 operation order
    ``((q + 0.5) * cw + x0) * pos_scale``.
    """
    packed = packed_to_tensors(packed, device)
    cw = packed.box / 65536.0
    ps = packed.pos_scale
    if packed.pos_delta is not None:
        x_q, y_q = morton_delta_decode_device(*packed.pos_delta)
    else:
        x_q, y_q = _u16(packed.x_q), _u16(packed.y_q)
    x = ((x_q.to(torch.float32) + 0.5) * cw + packed.x0) * ps
    y = ((y_q.to(torch.float32) + 0.5) * cw + packed.y0) * ps
    h = packed.h_q.to(torch.float32) * packed.h_scale
    n = h.shape[0]
    # a constant uploaded once per device: no host sync per block
    scales = device_const(packed.field_scales, torch.float32, h.device)[:, None]
    if packed.field_log_meta is not None:
        lo_m, st_m = packed.field_log_meta
        F, n_seg = lo_m.shape
        # lo + q * step in f64 (the product is exact), then 2 ** lg in f64
        # and one rounding to f32: within an ulp of the exact value
        q = packed.fields_q.to(torch.float64).reshape(F, n_seg, _DELTA_CHUNK)
        lg = lo_m.to(torch.float64)[:, :, None] + q * st_m.to(torch.float64)[:, :, None]
        fields = exp2_exact(lg).reshape(F, n_seg * _DELTA_CHUNK)[:, :n] * scales
    else:
        fields = packed.fields_q.to(torch.float32) * scales
    return x, y, h, fields


# ---------------------------------------------------------------------------
# Morton-delta position wire
# ---------------------------------------------------------------------------


def _interleave16(x_q: np.ndarray, y_q: np.ndarray) -> np.ndarray:
    """(u16, u16) -> u32 Morton code, vectorised bit spreading."""
    def spread(v):
        v = v.astype(np.uint32)
        v = (v | (v << 8)) & np.uint32(0x00FF00FF)
        v = (v | (v << 4)) & np.uint32(0x0F0F0F0F)
        v = (v | (v << 2)) & np.uint32(0x33333333)
        v = (v | (v << 1)) & np.uint32(0x55555555)
        return v

    return spread(x_q) | (spread(y_q) << np.uint32(1))


def morton_delta_encode(x_q: np.ndarray, y_q: np.ndarray):
    """Delta-encode quantised positions along the snapshot's storage order.

    Space-filling-curve-ordered snapshots put consecutive particles close
    in Morton space, so the u32 Morton code's first differences almost
    always fit int16: 2 B/particle of deltas, one u32 base per 4096-record
    segment and a sparse exception list for the rare jumps. Returns
    ``(deltas_i16, bases_u32, exc_idx_i64, exc_corr_u32, n)``, exact for
    any input order (a shuffled input fills the exception list). One pass
    of the native library; :func:`morton_delta_encode_plain` is the NumPy
    formulation it equals bit for bit.
    """
    from .. import native

    return native.morton_delta_encode_u16(x_q, y_q, _DELTA_CHUNK)


def morton_delta_encode_plain(x_q: np.ndarray, y_q: np.ndarray):
    """NumPy formulation of :func:`morton_delta_encode` (the same outputs)."""
    n = int(x_q.shape[0])
    m = _interleave16(x_q, y_q)
    n_seg = -(-n // _DELTA_CHUNK)
    pad = n_seg * _DELTA_CHUNK - n
    mp = np.pad(m, (0, pad), mode="edge").reshape(n_seg, _DELTA_CHUNK)
    d = np.zeros_like(mp, dtype=np.int64)
    d[:, 1:] = mp[:, 1:].astype(np.int64) - mp[:, :-1].astype(np.int64)
    bases = mp[:, 0].copy()
    flat = d.reshape(-1)
    over = (flat > 32767) | (flat < -32768)
    exc_idx = np.flatnonzero(over)
    flat = np.where(over, 0, flat)
    deltas = flat.astype(np.int16)
    # exception corrections: the decoder adds, from each exception on (a
    # segmented running sum), the gap between the true code and the
    # stored-delta cumsum, relative to the previous exception in the same
    # segment so that several exceptions a segment compose exactly
    if exc_idx.size:
        m0 = bases[:, None].astype(np.int64) + np.cumsum(flat.reshape(n_seg, _DELTA_CHUNK), axis=1, dtype=np.int64)
        gap = mp.reshape(-1)[exc_idx].astype(np.int64) - m0.reshape(-1)[exc_idx]
        seg = exc_idx // _DELTA_CHUNK
        corr = np.diff(gap, prepend=np.int64(0))
        first_of_seg = np.diff(seg, prepend=np.int64(-1)) != 0
        corr = np.where(first_of_seg, gap, corr)
        exc_corr = (corr & np.int64(0xFFFFFFFF)).astype(np.uint32)
    else:
        exc_corr = np.zeros(0, np.uint32)
    return deltas, bases, exc_idx, exc_corr, n


_U32 = 0xFFFFFFFF


def morton_delta_decode_device(deltas, bases, exc_idx, exc_corr, n: int, device=None):
    """Decode on the leaves' device (or ``device`` for NumPy leaves):
    segmented cumsum + sparse corrections + bit de-interleave. Returns
    (x_q, y_q) int32 tensors of length n, the encoder's inputs.

    The codes are summed in int64 and masked to 32 bits, which is the JAX
    decode's int32 wrap-around modulo 2^32 (``torch.cumsum`` of int32
    returns int64, so the wrap has to be explicit)."""
    def t(a):
        if isinstance(a, Tensor):
            return a if device is None else a.to(device)
        return host_leaf_to_tensor(a).to(device or "cuda")

    deltas, bases, exc_idx, exc_corr = t(deltas), t(bases), t(exc_idx), t(exc_corr)
    n_seg = bases.shape[0]
    d = deltas.to(torch.int64).reshape(n_seg, _DELTA_CHUNK)
    m = torch.cumsum(d, dim=1) + bases.to(torch.int64)[:, None]
    if exc_idx.shape[0]:
        # the corrections apply from each exception on: a second segmented
        # cumsum over a sparse array (exception indices are unique)
        corr = torch.zeros(n_seg * _DELTA_CHUNK, dtype=torch.int64, device=m.device)
        corr[exc_idx.to(torch.int64)] = exc_corr.to(torch.int64)
        m = m + torch.cumsum(corr.reshape(n_seg, _DELTA_CHUNK), dim=1)
    m = (m.reshape(-1) & _U32)[:n]

    def unspread(v):
        v = v & 0x55555555
        v = (v | (v >> 1)) & 0x33333333
        v = (v | (v >> 2)) & 0x0F0F0F0F
        v = (v | (v >> 4)) & 0x00FF00FF
        v = (v | (v >> 8)) & 0x0000FFFF
        return v

    return unspread(m).to(torch.int32), unspread(m >> 1).to(torch.int32)
