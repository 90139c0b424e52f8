"""Shear (two-pass) grouping: the random-order path.

Counterpart: ``astro_sph_tools_tpu/ops/layout_shear.py``. Groups particles
by an integer key without a global sort:

1. **Stage A** (:func:`_shear_stage_a`): view the key and the payload
   channels as (N/2048, 2048) rows and sort each row by key; transpose to
   2048 *bands* of N/2048 records (column j of the row-sorted rows is each
   row's j-th order statistic, so a band spans a narrow quantile of the
   keys); sort each band. Equal keys now form few long runs. An exact
   per-band key histogram (integer counts) locates every (key, band) run;
   the records are packed into *gangs*, 128 consecutive records x C f32
   channels, (G, C, 128).
2. **Append** (:func:`_shear_append`): a schedule of sub-runs of at most 16
   gangs, built on the device, and the hand-written CUDA kernel
   ``csrc/layout_shear.cu`` (:func:`append_gangs`, TPU kernel #7) copy every
   run's gangs to its key's contiguous destination region.
3. **Cleanup** (:func:`_shear_cleanup`, :func:`_coarse_cleanup`): a run's
   first and last gangs carry records of the neighbouring runs (head
   *strays*) and tail pad slots; the run metadata, expanded per gang by a
   cumsum of scattered deltas, masks them. Pad slots get zero payload,
   ``h = 1e-6`` and ``perm = n_valid``; the tile channel is rebuilt from the
   run structure.

Two users: :func:`shear_tile_sort` groups by the fine (level, tile) key of
the sorted engine (``deposit_tiled.tile_particles(layout="shear")``), and
:func:`shear_coarse_group` by 128 x 2 coarse cells in front of the coherent
engine (:func:`deposit_2d_bucketed`, the random-order render).

Not ported, because only a TPU needed them: the byte-split one-hot bf16
matmul histogram (and its ``(B, L // 512, 512)`` reshape, which breaks the
reference whenever L = N/2048 >= 512 is not a multiple of 512), the padding
of the payload to 8 channels, the 16 zero gangs of source slack, the
power-of-two schedule bucket with its dump slab for dead slots, the level
dynamic-slice slack, and the ``ASTSPH_SHEAR_PROFILE`` print. The port sizes
the schedule and the destination exactly from one host read of the total
gang and sub-run counts (the two scalars the reference syncs too).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import _build
from .deposit import MapSpec
from .deposit_tiled import _check_precision, device_const

Tensor = torch.Tensor

_C0 = 2048  # pass-1 row length = number of bands
_GANG = 128  # records per gang
_WG = 16  # gangs per sub-run
_MAX_CHANNELS = 8  # payload channels a gang carries
_PAD_H = 1e-6  # smoothing length of the pad slots


# ---------------------------------------------------------------------------
# Stage A: sorts + run geometry + gang packing
# ---------------------------------------------------------------------------


def _shear_stage_a(ops, *, n_keys: int, assign=None):
    """Row sort, transpose, band sort, per-band key histogram, run geometry
    and gang packing.

    ``ops``: list of (N,) tensors on one device. With ``assign=None``,
    ``ops[0]`` is the int32 key in [0, n_keys) and the rest are payload
    channels (f32, or the int32 ``perm`` carried bit for bit). With an
    ``assign`` callable, ops are raw ``(x, y, h, *fields, [perm])`` and
    ``assign(x, y, h)`` returns ``(key, u, v)``; the payload is then
    ``(u, v, h, *fields, [perm])``. The key does not ride into the gangs.

    Any N: when N is not a multiple of 2048, pad records with key
    ``n_keys`` and zero payload fill the last row. They sort after every
    real key and their runs are dropped from the geometry, so they are never
    appended and every returned array is the one N = 2048 * L would give.

    Returns ``(gangs (G, C, 128) f32, src_gang, head, ngang, cum_ngang, cnt,
    cum_nsub, per_key_gangs, n_gang_total, n_sub_total)``, int32, runs in
    (key-major, band) order: run ``k * 2048 + b`` is key k's records in band
    b; the totals are 0-dim tensors on the device.
    """
    if assign is not None:
        key, u, v = assign(ops[0], ops[1], ops[2])
        ops = [key, u, v, *ops[2:]]
    key, pay = ops[0], list(ops[1:])
    dev = key.device
    n = key.shape[0]
    pad = (-n) % _C0
    if n + pad >= 2**31:
        raise ValueError("the shear grouping indexes records with int32: group fewer than 2^31 at once")
    if pad:
        key = torch.cat([key, key.new_full((pad,), n_keys)])
        pay = [torch.cat([p, p.new_zeros(pad)]) for p in pay]
    del ops
    nk = n_keys + (1 if pad else 0)
    n_rows = (n + pad) // _C0  # pass-1 rows; also the band length
    B = _C0

    k_rows, order = torch.sort(key.reshape(n_rows, _C0), dim=1)
    pay = [torch.gather(p.reshape(n_rows, _C0), 1, order) for p in pay]
    del key, order
    # transpose to (B, n_rows) bands; contiguous, so that the band gathers
    # stay inside a row
    key2, order = torch.sort(k_rows.t().contiguous(), dim=1)
    pay = [torch.gather(p.t().contiguous(), 1, order) for p in pay]
    del k_rows, order

    # exact per-band key counts: one integer histogram of band * nk + key
    flat = (torch.arange(B, dtype=torch.int64, device=dev)[:, None] * nk + key2).reshape(-1)
    counts = torch.zeros(B * nk, dtype=torch.int32, device=dev)
    counts.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    counts = counts.view(B, nk)
    del flat, key2

    # run geometry, (key-major, band) order; the pad key's runs are dropped
    start_in_band = torch.cumsum(counts, 1, dtype=torch.int32) - counts
    band0 = torch.arange(B, dtype=torch.int32, device=dev)[:, None] * n_rows
    src_rec = (band0 + start_in_band).t().reshape(-1)[: n_keys * B]
    cnt = counts.t().reshape(-1)[: n_keys * B]
    src_gang = torch.div(src_rec, _GANG, rounding_mode="floor")
    head = src_rec - src_gang * _GANG
    ngang = torch.where(cnt > 0, torch.div(head + cnt + _GANG - 1, _GANG, rounding_mode="floor"), 0)
    cum_ngang = torch.cumsum(ngang, 0, dtype=torch.int32)
    nsub = torch.div(ngang + _WG - 1, _WG, rounding_mode="floor")
    cum_nsub = torch.cumsum(nsub, 0, dtype=torch.int32)
    # per-key gangs (pads included): runs are key-major, so a key's gangs
    # are the difference of cum_ngang at its last band
    key_end = cum_ngang[B - 1 :: B]
    per_key_gangs = torch.diff(key_end, prepend=key_end.new_zeros(1))

    chans = [p if p.dtype == torch.float32 else p.view(torch.float32) for p in pay]
    gangs = torch.stack([c.reshape(-1, _GANG) for c in chans], dim=1)
    return (
        gangs, src_gang, head, ngang, cum_ngang, cnt, cum_nsub, per_key_gangs,
        cum_ngang[-1], cum_nsub[-1],
    )


# ---------------------------------------------------------------------------
# Kernel #7: the gang append
# ---------------------------------------------------------------------------


def _gang_indices(sched: Tensor, n_dest: int) -> tuple[Tensor, Tensor]:
    """(source gang, destination gang) int64 of every gang a schedule
    copies, expanded with ``repeat_interleave``. For a schedule in
    destination order that tiles [0, n_dest), the destination index is
    ``arange(n_dest)`` and the source index alone defines the copy."""
    n = sched[:, 2].long()
    offs = torch.arange(n_dest, device=sched.device) - torch.repeat_interleave(
        torch.cumsum(n, 0) - n, n, output_size=n_dest
    )
    src = torch.repeat_interleave(sched[:, 0].long(), n, output_size=n_dest) + offs
    dst = torch.repeat_interleave(sched[:, 1].long(), n, output_size=n_dest) + offs
    return src, dst


def append_gangs_plain(gangs: Tensor, sched: Tensor, n_dest: int) -> Tensor:
    """Plain torch version of :func:`append_gangs`: the per-gang source and
    destination indices (:func:`_gang_indices`), then one advanced-indexing
    copy. The same inputs and the same (n_dest, C, 128) output."""
    src, dst = _gang_indices(sched, n_dest)
    dest = gangs.new_empty((n_dest, *gangs.shape[1:]))
    dest[dst] = gangs[src]
    return dest


def append_gangs(gangs: Tensor, sched: Tensor, n_dest: int) -> Tensor:
    """Copy every scheduled sub-run of gangs to its destination:
    ``dest[sched[j, 1] + g] = gangs[sched[j, 0] + g]`` for ``g <
    sched[j, 2]``. Returns (n_dest, C, 128) f32; the sub-runs must tile
    [0, n_dest) exactly, as :func:`_shear_schedule` builds them.

    On a CUDA tensor this launches the hand-written kernel
    ``csrc/layout_shear.cu`` (built at first use) and raises if the build or
    the launch fails; on a CPU tensor it runs :func:`append_gangs_plain`.
    """
    if gangs.device.type == "cpu":
        return append_gangs_plain(gangs, sched, n_dest)
    if gangs.device.type != "cuda":
        raise ValueError(f"no gang append kernel for device {gangs.device}")
    dev = gangs.device
    if (
        gangs.dtype != torch.float32 or gangs.ndim != 3 or gangs.shape[2] != _GANG
        or not 1 <= gangs.shape[1] <= _MAX_CHANNELS or not gangs.is_contiguous()
    ):
        raise ValueError(f"gangs must be a contiguous (G, 1..{_MAX_CHANNELS}, {_GANG}) float32 tensor")
    if (
        sched.dtype != torch.int32 or sched.device != dev or sched.ndim != 2 or sched.shape[1] != 3
        or not sched.is_contiguous()
    ):
        raise ValueError(f"sched must be a contiguous (n_sub, 3) int32 tensor on {dev}")
    if max(gangs.shape[0], n_dest) >= 2**31 or sched.shape[0] >= 2**31:
        raise ValueError("the gang append kernel indexes gangs and sub-runs with int32")
    dest = torch.empty((n_dest, *gangs.shape[1:]), dtype=torch.float32, device=dev)
    if sched.shape[0] == 0:
        return dest
    lib, _ = _build.load("layout_shear")
    with torch.cuda.device(dev):
        code = lib.append_gangs_launch(
            gangs.data_ptr(), dest.data_ptr(), sched.data_ptr(), sched.shape[0], gangs.shape[1],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if code != 0:
        raise RuntimeError(f"gang append kernel launch failed: {lib.cuda_error_string(code).decode()} ({code})")
    append_gangs.launches += 1
    return dest


#: kernel launches made by :func:`append_gangs` in this process (CUDA only)
append_gangs.launches = 0


def _shear_schedule(src_gang: Tensor, ngang: Tensor, cum_ngang: Tensor, cum_nsub: Tensor, n_sub: int) -> Tensor:
    """(n_sub, 3) int32 sub-run schedule [source gang, destination gang,
    gang count], in destination order: sub-run j belongs to run
    ``searchsorted(cum_nsub, j, right=True)`` and copies that run's gangs
    ``[16 w, min(16 (w + 1), ngang))``, w its index within the run. Exact
    lengths: no sub-run reaches past its run."""
    j = torch.arange(n_sub, dtype=torch.int32, device=ngang.device)
    run = torch.searchsorted(cum_nsub, j, right=True)
    first_sub = torch.cat([cum_nsub.new_zeros(1), cum_nsub[:-1]])
    w = (j - first_sub[run]) * _WG
    src = src_gang[run] + w
    dst = (cum_ngang - ngang)[run] + w
    count = torch.clamp(ngang[run] - w, max=_WG)
    return torch.stack([src, dst, count], dim=1).contiguous()


def _shear_append(gangs, src_gang, ngang, cum_ngang, cum_nsub, *, n_gang: int, n_sub: int) -> Tensor:
    """The sub-run schedule and the append: (n_gang, C, 128) destination
    gangs, every one of them written."""
    sched = _shear_schedule(src_gang, ngang, cum_ngang, cum_nsub, n_sub)
    return append_gangs(gangs, sched, n_gang)


def _host_totals(n_gang_total: Tensor, n_sub_total: Tensor) -> list:
    """The one host read of the grouping: the total gang and sub-run counts
    that size the destination and the schedule."""
    return torch.stack([n_gang_total, n_sub_total]).tolist()


# ---------------------------------------------------------------------------
# Cleanups
# ---------------------------------------------------------------------------


def _valid_lanes(head: Tensor, ngang: Tensor, cum_ngang: Tensor, cnt: Tensor, n_gang: int) -> Tensor:
    """(n_gang, 128) mask of the slots that hold a record of the gang's own
    run: a run's first gang starts at lane ``head`` (earlier lanes are head
    strays), its last gang ends after ``head + cnt - 128 (ngang - 1)`` lanes
    (later lanes are tail pads). Dead runs scatter onto a dropped index."""
    dev = head.device
    live = cnt > 0
    gs = (cum_ngang - ngang).long()
    first = torch.where(live, gs, n_gang)
    last = torch.where(live, gs + torch.clamp(ngang, min=1) - 1, n_gang)
    lo = torch.zeros(n_gang + 1, dtype=torch.int32, device=dev).index_put_((first,), head)
    hi_end = head + cnt - (ngang - 1) * _GANG
    hi = torch.full((n_gang + 1,), _GANG, dtype=torch.int32, device=dev).index_put_((last,), hi_end)
    lane = torch.arange(_GANG, dtype=torch.int32, device=dev)
    return (lane >= lo[:n_gang, None]) & (lane < hi[:n_gang, None])


def _shear_cleanup(dest, head, ngang, cum_ngang, cnt, *, n_fields: int, need_perm: bool, n_valid: int,
                   level_key_bases: tuple):
    """Per-gang key, level and tile rebuilt from the run structure; head
    strays and tail pads masked; channels unpacked. Returns ``(s_tile, u, v,
    h, values (F, n), perm or None)`` over the n_gang * 128 slots."""
    n_runs = ngang.shape[0]
    n_gang = dest.shape[0]
    dev = dest.device
    # key_of_gang: key deltas scattered at each run's first gang, summed
    # over gangs. Empty runs share their first gang with their successor;
    # adding (not setting) collapses their deltas correctly.
    key_r = torch.div(torch.arange(n_runs, device=dev), _C0, rounding_mode="floor")
    delta = torch.diff(key_r, prepend=key_r.new_zeros(1))
    gs = (cum_ngang - ngang).long()
    key_of_gang = torch.zeros(n_gang + 1, dtype=torch.int64, device=dev).index_add_(0, gs, delta)[:-1]
    key_of_gang = torch.cumsum(key_of_gang, 0)
    bases = device_const(level_key_bases, torch.int64, dev)  # (n_levels + 2,)
    level_of_gang = torch.searchsorted(bases[1:], key_of_gang, right=True)
    tile_of_gang = (key_of_gang - bases[level_of_gang]).to(torch.int32)

    valid = _valid_lanes(head, ngang, cum_ngang, cnt, n_gang)
    u = torch.where(valid, dest[:, 0], 0.0).reshape(-1)
    v = torch.where(valid, dest[:, 1], 0.0).reshape(-1)
    h = torch.where(valid, dest[:, 2], _PAD_H).reshape(-1)
    values = torch.stack([torch.where(valid, dest[:, 3 + f], 0.0).reshape(-1) for f in range(n_fields)])
    s_tile = tile_of_gang[:, None].expand(n_gang, _GANG).reshape(-1)
    perm = None
    if need_perm:
        # pad slots gather index n_valid: with_values zero-pads new values
        # beyond n_valid, so pads re-gather as 0
        perm = torch.where(valid, dest[:, 3 + n_fields].view(torch.int32), n_valid).reshape(-1)
    return s_tile, u, v, h, values, perm


def _coarse_cleanup(dest, head, ngang, cum_ngang, cnt, *, n_fields: int):
    """Stray/pad slots zeroed (``h = 1e-6``) and raw ``(x, y, h, fields
    (F, n))`` unpacked."""
    valid = _valid_lanes(head, ngang, cum_ngang, cnt, dest.shape[0])
    x = torch.where(valid, dest[:, 0], 0.0).reshape(-1)
    y = torch.where(valid, dest[:, 1], 0.0).reshape(-1)
    h = torch.where(valid, dest[:, 2], _PAD_H).reshape(-1)
    fields = torch.stack([torch.where(valid, dest[:, 3 + f], 0.0).reshape(-1) for f in range(n_fields)])
    return x, y, h, fields


# ---------------------------------------------------------------------------
# Fine (level, tile) grouping
# ---------------------------------------------------------------------------


def shear_tile_sort(
    key_strided, u_loc, v_loc, h, values, *,
    level_stride: int, level_n_tiles: tuple, n_fields: int,
    need_perm: bool, n_valid: int,
    raw_xy=None, assign=None, donate: bool = False,
):
    """Group particles by (level, tile): the shear counterpart of the sorted
    engine's key sort, on the device of the inputs (tensors).

    ``key_strided`` is the composite ``level * level_stride + tile`` key
    (int32); ``level_n_tiles`` the per-level tile counts (0 for disabled
    levels), the oversize key implicit at the end. Alternatively pass
    ``raw_xy=(x, y)`` and an ``assign(x, y, h)`` callable returning the
    COMPACT key ``bases[level] + tile`` and the tile-local coordinates (with
    ``key_strided``, ``u_loc`` and ``v_loc`` None). ``donate`` is accepted
    for the reference's signature and ignored: the caller's tensors are
    never freed.

    Returns ``(s_tile, su, sv, sh, s_values, perm, counts)``: per-level
    segments, contiguous and tile-sorted, with interleaved pad slots (zero
    values, ``h = 1e-6``, ``perm = n_valid``) that ``counts`` (n_levels + 1,
    int32) includes. The arrays hold exactly ``counts.sum()`` slots. One
    host read: the total gang and sub-run counts.
    """
    bases = np.concatenate([[0], np.cumsum(level_n_tiles)]).astype(np.int64)
    n_keys = int(bases[-1]) + 1  # + oversize
    level_key_bases = tuple(int(b) for b in bases) + (n_keys,)
    if assign is not None:
        x, y = raw_xy
        ops = [x, y, h]
    else:
        level = torch.div(key_strided, level_stride, rounding_mode="floor")
        compact = device_const(level_key_bases, torch.int32, key_strided.device)[level] + (
            key_strided - level * level_stride
        )
        ops = [compact.to(torch.int32), u_loc, v_loc, h]
    n_payload = 3 + n_fields + int(need_perm)
    if n_payload > _MAX_CHANNELS:
        raise ValueError(
            f"shear layout carries at most {_MAX_CHANNELS} payload channels "
            f"(got {n_payload}); use the sort layout"
        )
    ops += [values[f] for f in range(n_fields)]
    if need_perm:
        ops.append(torch.arange(h.shape[0], dtype=torch.int32, device=h.device))

    (gangs, src_gang, head, ngang, cum_ngang, cnt, cum_nsub,
     per_key_gangs, n_gang_total, n_sub_total) = _shear_stage_a(
        ops, n_keys=n_keys, assign=assign
    )
    del ops
    n_gang, n_sub = _host_totals(n_gang_total, n_sub_total)
    dest = _shear_append(gangs, src_gang, ngang, cum_ngang, cum_nsub, n_gang=n_gang, n_sub=n_sub)
    del gangs
    s_tile, su, sv, sh, s_values, perm = _shear_cleanup(
        dest, head, ngang, cum_ngang, cnt, n_fields=n_fields, need_perm=need_perm,
        n_valid=n_valid, level_key_bases=level_key_bases,
    )
    # per-level slot counts (pads included), from the per-key gang counts
    key_end = torch.cat([per_key_gangs.new_zeros(1), torch.cumsum(per_key_gangs, 0, dtype=torch.int32)])
    kb = device_const(level_key_bases, torch.int64, key_end.device)
    counts = (key_end[kb[1:]] - key_end[kb[:-1]]) * _GANG
    return s_tile, su, sv, sh, s_values, perm, counts


# ---------------------------------------------------------------------------
# Coarse spatial bucketing -> coherent engine (the random-order render)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=64)
def _cached_coarse_assign(extent, periodic, n_cx, n_cy):
    """The coarse-cell key: row-major (cj, ci) over n_cy x n_cx cells; the
    payload keeps the raw (x, y). Cached per geometry (one callable per
    cell layout, as in the reference)."""
    x0, x1, y0, y1 = extent

    def assign(xx, yy, hh):
        u = (xx - x0) / (x1 - x0) * n_cx
        v = (yy - y0) / (y1 - y0) * n_cy
        if periodic:
            u = torch.remainder(u, n_cx)
            v = torch.remainder(v, n_cy)
        ci = torch.clamp(u.to(torch.int32), 0, n_cx - 1)
        cj = torch.clamp(v.to(torch.int32), 0, n_cy - 1)
        # the key order is the output order: row-major cells keep the
        # stream spatially coherent for the coherent engine
        return cj * n_cx + ci, xx, yy

    return assign


def _as_fields(values, device) -> tuple[Tensor, bool]:
    values = torch.as_tensor(
        values if isinstance(values, Tensor) else np.asarray(values), dtype=torch.float32, device=device
    )
    if values.ndim == 1:
        return values[None, :], True
    return values, False


def _f32(a, device) -> Tensor:
    return torch.as_tensor(a if isinstance(a, Tensor) else np.asarray(a), dtype=torch.float32, device=device)


def shear_coarse_group(
    x, y, h, values, spec: MapSpec, *,
    n_cy: int = 128, n_cx: int = 2, donate: bool = False,
    device="cuda",
):
    """Group shuffled particles into coarse spatial cells (the shear
    machinery over an n_cy x n_cx key space), on ``device``.

    Returns RAW ``(x, y, h, fields (F, n))`` in row-major cell order with
    interleaved pad slots (x = y = 0, h = 1e-6, zero fields; ~3 % at 2^27
    on a 1024^2-scale clustered field). With 128 x 2 cells (each cell one
    K = 8 tile row tall) the bands stay a few keys wide, so runs are long,
    and the stream is coherent enough for the coherent engine's in-place
    rows to do the fine grouping. ``donate`` is accepted for the reference's
    signature and ignored: the caller's tensors are never freed.
    """
    device = torch.device(device)
    values, _ = _as_fields(values, device)
    n_fields = values.shape[0]
    if 3 + n_fields > _MAX_CHANNELS:
        raise ValueError("coarse grouping carries at most 5 fields")
    assign = _cached_coarse_assign(
        tuple(float(e) for e in spec.extent), bool(spec.periodic_wrap), n_cx, n_cy,
    )
    ops = [_f32(x, device), _f32(y, device), _f32(h, device)] + [values[f] for f in range(n_fields)]
    (gangs, src_gang, head, ngang, cum_ngang, cnt, cum_nsub,
     _, n_gang_total, n_sub_total) = _shear_stage_a(ops, n_keys=n_cy * n_cx, assign=assign)
    del ops
    n_gang, n_sub = _host_totals(n_gang_total, n_sub_total)
    dest = _shear_append(gangs, src_gang, ngang, cum_ngang, cum_nsub, n_gang=n_gang, n_sub=n_sub)
    del gangs
    return _coarse_cleanup(dest, head, ngang, cum_ngang, cnt, n_fields=n_fields)


def deposit_2d_bucketed(
    x, y, h, values, spec: MapSpec, *,
    kernel: str = "cubic_spline",
    precision: str = "bf16x2",
    projection: str = "kernel3d",
    donate: bool = False,
    device="cuda",
) -> Tensor:
    """Random-order render: coarse shear bucketing, then the coherent engine
    (:func:`..deposit_coherent.deposit_2d_coherent`), on ``device``.

    Exact for any input order (the coherent engine is order-agnostic; the
    bucketing only restores the locality its rows exploit). Pad slots ride
    as zero-value sub-pixel particles. Returns (ny, nx) or (F, ny, nx).
    ``donate`` is accepted for the reference's signature and ignored.
    """
    from .deposit_coherent import deposit_2d_coherent

    _check_precision(precision)
    device = torch.device(device)
    values, single = _as_fields(values, device)
    gx, gy, gh, gv = shear_coarse_group(x, y, h, values, spec, device=device)
    total = deposit_2d_coherent(
        gx, gy, gh, gv, spec, kernel=kernel, precision=precision, projection=projection, device=device,
    )
    return total[0] if single else total

