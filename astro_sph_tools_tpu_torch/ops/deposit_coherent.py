"""Coherent-order engine: render snapshot-ordered particles without a global
sort.

Counterpart: ``astro_sph_tools_tpu/ops/deposit_coherent.py``. Snapshots
store particles in space-filling-curve order, so consecutive particles are
spatial neighbours. The sorted engine (``ops/deposit_tiled.py``) sorts every
particle by (level, tile); this engine works on rows of C = 2048
consecutive particles instead:

1. **Stage A** (``prep``): each particle gets its footprint level, its tile
   and the composite key ``bases[level] + tile``; each row is rearranged so
   its level-0 lanes ("heads") come first and the rest ("tails") last, and
   it is classified. A row whose heads touch at most ``d_max`` distinct
   level-0 tiles is *coherent*: its heads deposit in place. Otherwise it is
   *heavy* and routes whole. ``prep="pallas"`` (name kept from the JAX
   package) runs the hand-written CUDA row-prep kernel (``ops/
   coherent_prep.py``, ``csrc/coherent.cu``), a stable two-sided partition;
   ``prep="xla"`` runs :func:`_assign_and_rowsort`, a plain torch batched
   row sort. Both give valid layouts; their lane orders differ.
2. **Coherent pass**: a cluster of CUDA blocks per level-0 tile deposits
   the lanes of its candidate rows whose key equals the tile, reading the
   rows in place, each block every C-th of the tile's candidate rows, a
   warp a row at a time (:func:`deposit_coherent_tiles`,
   ``csrc/coherent.cu``). In window mode (``window`` = W) the row sort keeps
   each candidate's lanes in one segment and the kernel's window branch
   reads only the W-lane windows that cover it
   (:func:`deposit_coherent_windows`).
3. **Tail**: each row's last ``tail_eff`` lanes (its level >= 1 lanes, or
   all C for a heavy row) are pulled into one compact array, sorted by key,
   and rendered per level through the sorted engine's kernel
   (``deposit_tiles``, ``csrc/deposit2d.cu``); oversize particles go through
   the oversize route (:func:`.deposit_wide.deposit_wide`).

The TPU engine's bucketed row windows, slack padding, 4096-step schedule
granularity and size-class padding exist for DMA and compiled-program reuse
and are not ported: particles are padded only to a multiple of C, and
arrays keep their real length. :func:`deposit_2d_coherent_fused` sizes
everything from pinned :class:`CoherentCaps` and makes no host sync.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import _build
from ..kernels.splines import get_kernel, integrated_kernel_chebyshev
from ..utils.profiling import span
from ._device import as_field_matrix, check_precision, device_const, tile_ranges
from .deposit import MapSpec
from .deposit_tiled import (
    PALLAS_LEVELS,
    PallasDepositConfig,
    _CLUSTER,
    _level_geometry,
    _LevelGeometry,
    _multi_level_assign,
    _overlap_add,
    _pixel_coords,
    deposit_tiles,
    deposit_tiles_plain,
)
from .deposit_wide import deposit_wide

Tensor = torch.Tensor

_CHUNK = 2048  # C: lanes per row
_D_MAX = 8  # distinct level-0 tiles a row may touch before it routes whole
# tail buckets: a row's tail is counted in the smallest bucket T >= tail_eff
# (T = C for heavy rows and rows with no level-0 lanes). The TPU gathers the
# tails as row windows of these widths; here they only size the fused
# render's tail capacity and feed caps_from_layout.
_TAIL_BUCKETS = (
    32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048
)
# largest support radius (pixels) of the TPU's short K4 column loop; the
# layout keeps the per-candidate K4 flag (1 = no lane of the candidate's key
# is wider), which the card's support-bounded deposit does not need
_K4_MAX_S = 1.0
_K4 = 4
_AUX_W = 128  # width of the row prep's aux row
_MAX_FIELDS = 4  # the key channel takes the 8th slot of a packed row
_PREPS = ("pallas", "xla")
_WINDOW_MIN = 128  # the least window (the JAX package's least TPU lane block)


def _next_size_class(n: int, bits: int = 3) -> int:
    """Smallest ``m * 2^e >= n`` with ``m`` carrying ``bits`` significant
    bits after the leading one (copied from the JAX package's
    ``deposit_pallas._next_size_class``): monotone, and a fixed point on its
    own values."""
    if n <= (1 << bits):
        return max(0, n)
    e = (n - 1).bit_length() - 1 - bits
    return -(-n >> e) << e


def _ckey_bases(geoms) -> tuple[int, ...]:
    """Cumulative tile-offset key bases per level + [oversize, pad] tails.

    Composite keys ``base[level] + tile`` stay below 2^24, so they are exact
    in the f32 key channel the deposit compares against."""
    bases = [0]
    for g in geoms:
        bases.append(bases[-1] + (g.n_tiles if g is not None else 0))
    # bases[n_levels] = oversize key, +1 = padding sentinel
    return tuple(bases)


@dataclass(frozen=True)
class _Setup:
    """Static geometry of one coherent render: each level's tiling (None
    where a level cannot tile the map) and the composite-key bases."""

    spec: MapSpec
    geoms: tuple  # Optional[_LevelGeometry] per level
    bases: tuple
    support_factor: float
    d_max: int

    @property
    def n_levels(self) -> int:
        return len(self.geoms)

    @property
    def geom0(self) -> _LevelGeometry:
        return self.geoms[0]

    @property
    def bounds(self) -> tuple:
        return tuple(g.cfg.max_s_pix if g is not None else -1.0 for g in self.geoms)

    @property
    def pad_key(self) -> int:
        return self.bases[self.n_levels] + 1


def _setup(spec: MapSpec, kernel: str, levels, d_max: int) -> _Setup:
    geoms = []
    for cfg in levels:
        try:
            geoms.append(_level_geometry(cfg, spec))
        except ValueError:
            geoms.append(None)
    if geoms[0] is None:
        raise ValueError("coherent deposit requires the smallest footprint level to tile the map")
    bases = _ckey_bases(geoms)
    if bases[-1] + 1 >= 1 << 24:
        raise ValueError(
            f"{bases[-1]} composite keys exceed the 2^24 that the f32 key "
            "channel holds exactly; render this map in sub-extents"
        )
    if d_max < 1 or 2 * d_max + 3 + len(geoms) > _AUX_W:
        raise ValueError(f"d_max={d_max} does not fit the {_AUX_W}-wide aux row")
    return _Setup(spec, tuple(geoms), bases, get_kernel(kernel).support_factor, int(d_max))


def _assign(x: Tensor, y: Tensor, h: Tensor, st: _Setup):
    """(level, tile, u_loc, v_loc, s_pix, ckey) per particle, in f32 on the
    device of ``x``: the sorted engine's own assignment (``_pixel_coords``
    and ``_multi_level_assign`` of ``ops/deposit_tiled.py``), so both
    engines place every particle alike, plus the composite key. The
    row-prep kernel (``csrc/coherent.cu``) repeats the arithmetic torch does
    for these on a CUDA tensor, bit for bit. Oversize particles keep global
    pixel coordinates and tile 0."""
    nl = st.n_levels
    g = st.geoms
    u, v = _pixel_coords(x, y, st.spec)
    s_pix = st.support_factor * h / min(st.spec.pixel_size)
    level, tile, u_loc, v_loc = _multi_level_assign(
        u, v, s_pix, st.bounds,
        tuple(c.n_tiles_x if c else 1 for c in g), tuple(c.cfg.TY if c else 1 for c in g),
        tuple(c.tx if c else 1 for c in g), tuple(c.n_tiles_y if c else 1 for c in g),
        tuple(c.cfg.M if c else 0 for c in g),
    )
    ckey = torch.where(level < nl, tile, 0)
    for li in range(1, nl + 1):
        if st.bases[li]:
            ckey = torch.where(level == li, ckey + st.bases[li], ckey)
    return level, tile, u_loc, v_loc, s_pix, ckey


def _stage_a_glue(cand_keys, cand_k4, tail_eff, heavy, n_l0, lev_counts, st: _Setup, cand_win=()):
    """The small per-row work after the row prep, on the device: candidate
    sort, bucket grouping and the counts vector
    ``[n_cand, n_heavy, n_tail, rows per tail bucket..., lc0, routed lanes
    per level 1..n_levels (the last is oversize)]``, where lc0 counts the
    heavy rows' level-0 lanes; in window mode (``cand_win``: the (n_rows,
    d_max) window geometry (wb0, nw, k4n)) the vector ends with the window
    step count. Returns (sk, sr, sk4, tail_eff, rows_by_bucket, counts),
    then the sorted window geometry in window mode."""
    n_rows, d_max = cand_keys.shape
    dev = cand_keys.device
    sk, order = torch.sort(cand_keys.reshape(-1))
    sr = torch.div(order, d_max, rounding_mode="floor").to(torch.int32)
    sk4 = cand_k4.reshape(-1).index_select(0, order)
    s_win = tuple(a.reshape(-1).index_select(0, order).to(torch.int32) for a in cand_win)
    n_cand = (sk < st.bases[1]).sum()
    thr = device_const(_TAIL_BUCKETS, torch.int32, dev)
    bucket = torch.searchsorted(thr, tail_eff)
    bucket = torch.where(tail_eff > 0, bucket, len(_TAIL_BUCKETS))
    rows_by_bucket = torch.argsort(bucket, stable=True).to(torch.int32)
    nb = (bucket[None, :] == torch.arange(len(_TAIL_BUCKETS), device=dev)[:, None]).sum(1)
    lc0 = torch.where(heavy, n_l0, 0).sum()
    counts = torch.cat([
        torch.stack([n_cand, heavy.sum(), tail_eff.sum()]),
        nb, lc0[None], lev_counts,
    ] + ([cand_win[1].sum()[None]] if cand_win else [])).to(torch.int64)
    return (sk, sr, sk4, tail_eff, rows_by_bucket, counts) + s_win


def _assign_and_rowsort(x, y, h, values, st: _Setup, window: int = 0):
    """Stage A with ``prep="xla"``, in plain torch: assignment, a stable
    batched row sort by key, row classification, candidates, candidate sort,
    bucket grouping and the counts vector. Returns (packed (n_rows, 8, C):
    [u_loc, v_loc, h, values..., ckey, 0...], sk, sr, sk4, tail_eff,
    rows_by_bucket, counts).

    With ``window`` = W (a power of two below C; 0 = whole-row mode), as
    the JAX package's stage A: the row sort key is ``2 * ckey + big``
    (``big``: a level-0 lane wider than the K4 bound, s_pix > 1), so each
    candidate's lanes are one segment [sub-pixel | wider]; the key channel
    still holds ``ckey``. Each candidate also gets its W-lane window
    geometry (wb0, nw, k4n): its first window, its window count, and the
    count of its leading windows whose lanes are all sub-pixel. The return
    then ends with the three, in candidate order, and ``counts`` with
    their Σ nw."""
    C, d_max, nl = _CHUNK, st.d_max, st.n_levels
    n_rows = x.shape[0] // C
    n_fields = values.shape[0]
    level, _, u_loc, v_loc, s_pix, ckey = _assign(x, y, h, st)
    dev = x.device

    def to2(a):
        return a.reshape(n_rows, C)

    big2 = to2((level == 0) & (s_pix > _K4_MAX_S))
    if window:
        rk2, order = torch.sort(to2(ckey) * 2 + big2.to(ckey.dtype), dim=1, stable=True)
        cls2 = rk2 & 1
        k2 = rk2 >> 1
    else:
        k2, order = torch.sort(to2(ckey), dim=1, stable=True)
    chans = [torch.gather(to2(a), 1, order) for a in [u_loc, v_loc, h, *values]]
    is_first = torch.cat(
        [torch.ones((n_rows, 1), dtype=torch.bool, device=dev), k2[:, 1:] != k2[:, :-1]], dim=1
    )
    is_l0 = k2 < st.bases[1]
    coherent = (is_first & is_l0).sum(1) <= d_max
    n_l0 = is_l0.sum(1)
    tail_eff = torch.where(coherent, C - n_l0, C).to(torch.int32)
    live_first = is_first & is_l0 & coherent[:, None]
    masked = torch.where(live_first, k2, st.pad_key)
    # first d_max distinct head keys per row (each appears once in masked)
    cand_keys = torch.topk(masked, d_max, dim=1, largest=False, sorted=True).values
    ck2 = to2(ckey)
    cand_k4 = torch.stack(
        [~((ck2 == cand_keys[:, j:j + 1]) & big2).any(1) for j in range(d_max)], dim=1
    ).to(torch.int32)
    cand_win = ()
    if window:
        # the row is key-sorted, so ascending candidate keys have ascending
        # first lanes: the d_max least first lanes align with cand_keys
        lane = torch.arange(C, dtype=torch.int64, device=dev).expand(n_rows, C)
        starts = torch.topk(torch.where(live_first, lane, C), d_max, dim=1, largest=False, sorted=True).values
        head_len = (C - tail_eff).to(torch.int64)[:, None]  # level-0 lanes of a coherent row
        ends = torch.minimum(torch.cat([starts[:, 1:], torch.full_like(starts[:, :1], C)], dim=1), head_len)
        real = starts < head_len
        # sub-pixel lanes come first in a candidate's segment: its count of
        # them is a prefix sum over the lanes, differenced at the bounds
        small_l0 = is_l0 & (cls2 == 0) & coherent[:, None]
        spre = torch.cat([torch.zeros_like(starts[:, :1]), torch.cumsum(small_l0, dim=1)], dim=1)
        mids = starts + (torch.gather(spre, 1, ends) - torch.gather(spre, 1, starts))
        wb0 = torch.where(real, starts, 0) // window
        nw = torch.where(real, torch.div(ends - 1, window, rounding_mode="floor") - wb0 + 1, 0)
        k4n = torch.where(ends <= mids, nw, torch.clamp(mids // window - wb0, min=torch.zeros_like(nw), max=nw))
        cand_win = (wb0, nw, k4n)
    zeros = [torch.zeros_like(k2, dtype=torch.float32)] * (8 - 4 - n_fields)
    packed = torch.stack(chans + [k2.to(torch.float32)] + zeros, dim=1)
    lev = torch.clamp(level, max=nl)
    lev_counts = torch.stack([(lev == li).sum() for li in range(1, nl + 1)])
    return (packed, *_stage_a_glue(cand_keys, cand_k4, tail_eff, ~coherent, n_l0, lev_counts, st, cand_win))


def _stage_a(prep: str, x, y, h, values, st: _Setup, window: int = 0):
    if prep == "pallas":
        from .coherent_prep import _stage_a_prep  # late import: it imports this module

        return _stage_a_prep(x, y, h, values, st)
    return _assign_and_rowsort(x, y, h, values, st, window)


def _resolve_prep(prep: Optional[str], device: torch.device, window: int = 0) -> str:
    """``None`` picks the CUDA row-prep kernel on a card and the plain torch
    row sort elsewhere or in window mode, as the JAX package picks its
    Pallas prep on a TPU outside window mode. Window mode needs the row
    sort: the row-prep kernel is a stable two-sided partition, not a key
    sort, so it leaves a candidate's lanes in more than one segment."""
    if window:
        if window & (window - 1) or not _WINDOW_MIN <= window < _CHUNK:
            raise ValueError(f"window must be a power of two in [{_WINDOW_MIN}, {_CHUNK}), got {window}")
        if prep == "pallas":
            raise ValueError(
                "window mode requires prep='xla' (the row-prep kernel does not "
                "emit window-step geometry)"
            )
    if prep is None:
        return "pallas" if device.type == "cuda" and not window else "xla"
    if prep not in _PREPS:
        raise ValueError(f"unknown prep engine {prep!r}; use 'pallas'|'xla'")
    return prep


def _device_inputs(x, y, h, values: Tensor, spec: MapSpec, device):
    """f32 inputs on ``device``, padded to a multiple of C with particles at
    the extent max, h = 0.1 px and zero values (as the JAX package places
    its pads). Returns (x, y, h, values, n_valid)."""

    def conv(a):
        return torch.as_tensor(a if isinstance(a, Tensor) else np.asarray(a), dtype=torch.float32, device=device)

    x, y, h = conv(x), conv(y), conv(h)
    n = h.shape[0]
    if values.shape[1] != n:
        raise ValueError(f"values has {values.shape[1]} columns for {n} particles")
    pad = (-n) % _CHUNK
    if pad:
        _, x1, _, y1 = spec.extent
        x = torch.cat([x, x.new_full((pad,), float(x1))])
        y = torch.cat([y, y.new_full((pad,), float(y1))])
        h = torch.cat([h, h.new_full((pad,), 0.1 * min(spec.pixel_size))])
        values = torch.nn.functional.pad(values, (0, pad))
    return x.contiguous(), y.contiguous(), h.contiguous(), values.contiguous(), n


# ---------------------------------------------------------------------------
# Tail: gather, sort
# ---------------------------------------------------------------------------


def _tail_gather(packed: Tensor, tail_eff: Tensor, n_slots: int, n_fields: int, st: _Setup):
    """Pull each row's last ``tail_eff`` lanes into one compact tail of
    ``n_slots`` slots (row by row, in lane order); slots past the true tail
    length hold the pad key, and a tail longer than ``n_slots`` loses its
    end. Returns (flat lane index into ``packed``, int32 key) per slot."""
    C = _CHUNK
    n_rows = packed.shape[0]
    dev = packed.device
    te = tail_eff.to(torch.int64)
    cum = torch.cumsum(te, 0)
    j = torch.arange(n_slots, device=dev)
    row = torch.searchsorted(cum, j, right=True)
    live = row < n_rows
    row = torch.clamp(row, max=n_rows - 1)
    te_r = te.index_select(0, row)
    lane = torch.where(live, C - te_r + (j - (cum.index_select(0, row) - te_r)), 0)
    flat = row * (8 * C) + lane
    key = packed.view(-1).index_select(0, flat + (3 + n_fields) * C)
    key = torch.where(live, key.to(torch.int32), st.pad_key)
    return flat, key


def _tail_sort_dense(packed: Tensor, flat: Tensor, key: Tensor, n_fields: int):
    """Sort the compact tail by key (one ``torch.sort`` and one permutation
    of the lane indices) and gather its channels. Returns (u, v, h,
    values (F, n), sorted int32 key)."""
    C = _CHUNK
    skey, perm = torch.sort(key)
    src = flat.index_select(0, perm)
    pv = packed.view(-1)
    tu, tv, th = (pv.index_select(0, src + c * C) for c in range(3))
    t_values = torch.stack([pv.index_select(0, src + (3 + f) * C) for f in range(n_fields)])
    return tu, tv, th, t_values, skey


def _tail_level_ranges(skey: Tensor, base: int, geom: _LevelGeometry, cap: Optional[int]):
    """(pstart, pcount) int32 per tile of the level whose keys start at
    ``base``, in the key-sorted tail, found by searching the sorted keys (no
    slicing, no host sync). With ``cap`` the level keeps at most its first
    ``cap`` particles."""
    keys = torch.arange(geom.n_tiles, dtype=skey.dtype, device=skey.device) + base
    pstart = torch.searchsorted(skey, keys)
    pend = torch.searchsorted(skey, keys, right=True)
    if cap is not None:
        lim = pstart[:1] + cap  # the level starts at its first tile's start
        pstart = torch.minimum(pstart, lim)
        pend = torch.minimum(pend, lim)
    return pstart.to(torch.int32), (pend - pstart).to(torch.int32)


# ---------------------------------------------------------------------------
# Kernel #2: the coherent deposit
# ---------------------------------------------------------------------------


def deposit_coherent_tiles_plain(
    packed: Tensor, cand_tile: Tensor, cand_row: Tensor,
    *,
    n_fields: int,
    n_tiles: int,
    cfg: PallasDepositConfig,
    kernel: str,
    projection: str,
    psx: float,
    psy: float,
    offset: float,
) -> Tensor:
    """Plain torch version of :func:`deposit_coherent_tiles`: the lanes of
    each candidate row whose key equals the candidate's tile are gathered in
    tile order and deposited by the sorted engine's plain version
    (``deposit_tiles_plain``, the same footprint math)."""
    return _plain_deposit(packed, cand_tile, cand_row, None, n_fields=n_fields, n_tiles=n_tiles, cfg=cfg,
                          kernel=kernel, projection=projection, psx=psx, psy=psy, offset=offset)


def _plain_deposit(packed, cand_tile, cand_row, lane_ok, *, n_fields, n_tiles, cfg, kernel, projection,
                   psx, psy, offset) -> Tensor:
    """Both plain versions of kernel #2: ``lane_ok`` (B, C) bool, or None
    for every lane, restricts each candidate's lanes."""
    C = _CHUNK
    rows = cand_row.to(torch.int64)
    live = cand_tile < n_tiles
    keys = packed[rows, 3 + n_fields, :]  # (B, C)
    match = (keys == cand_tile.to(torch.float32)[:, None]) & live[:, None]
    if lane_ok is not None:
        match &= lane_ok
    ci, lane = torch.nonzero(match, as_tuple=True)  # candidate-major: tile order
    src = rows[ci] * (8 * C) + lane
    pv = packed.reshape(-1)
    u, v, h = (pv[src + c * C] for c in range(3))
    values = torch.stack([pv[src + (3 + f) * C] for f in range(n_fields)])
    pstart, pcount = tile_ranges(cand_tile[ci], n_tiles)
    return deposit_tiles_plain(
        u, v, h, values, pstart, pcount, cfg=cfg, kernel=kernel,
        projection=projection, psx=psx, psy=psy, offset=offset,
    )


def _check_kernel_inputs(packed: Tensor, n_fields: int, **candidates: Tensor) -> None:
    """What both branches of kernel #2 take: a CUDA tensor of contiguous
    (n_rows, 8, C) f32 rows, 1..4 fields, and contiguous 1-D int32
    candidate arrays of one length on its device; raises otherwise."""
    if packed.device.type != "cuda":
        raise ValueError(f"no coherent deposit kernel for device {packed.device}")
    dev = packed.device
    if (
        packed.dtype != torch.float32 or packed.ndim != 3 or tuple(packed.shape[1:]) != (8, _CHUNK)
        or not packed.is_contiguous()
    ):
        raise ValueError(f"packed must be a contiguous (n_rows, 8, {_CHUNK}) float32 tensor")
    for name, a in candidates.items():
        if a.dtype != torch.int32 or a.device != dev or a.ndim != 1 or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor on {dev}")
    if len({a.shape for a in candidates.values()}) > 1:
        raise ValueError(f"{', '.join(candidates)} differ in length")
    if not 1 <= n_fields <= _MAX_FIELDS:
        raise ValueError(f"the coherent deposit kernel takes 1..{_MAX_FIELDS} fields, got {n_fields}")


def _footprint_consts(kernel: str, projection: str, dev):
    """(kernel spec, integrated flag, Chebyshev table on ``dev`` or None)."""
    integrated = projection == "integrated"
    cheb = device_const(integrated_kernel_chebyshev(kernel), torch.float32, dev) if integrated else None
    return get_kernel(kernel), integrated, cheb


def _launch(packed, rows, lane0, start, end, *, window, n_fields, n_tiles, cfg, kernel, projection, psx, psy,
            offset) -> Tensor:
    """One launch of ``csrc/coherent.cu``'s ``coherent_launch``, the entry
    point of both branches of kernel #2: tile t reads items [start[t],
    end[t]) of ``rows`` (and, in the window branch, of ``lane0``, None for
    whole rows at ``window`` = 2048). Raises, naming the window and the
    cluster size, if the build or the launch fails."""
    dev = packed.device
    out = torch.empty((n_tiles, n_fields * cfg.R, cfg.S), dtype=torch.float32, device=dev)
    if n_tiles == 0:
        return out
    kspec, integrated, cheb = _footprint_consts(kernel, projection, dev)
    lib, _ = _build.load("coherent")
    C = _CLUSTER
    with torch.cuda.device(dev):
        code = lib.coherent_launch(
            packed.data_ptr(), n_fields, rows.data_ptr(), lane0.data_ptr() if lane0 is not None else None,
            start.data_ptr(), end.data_ptr(), n_tiles, window, out.data_ptr(), cfg.K, cfg.R,
            float(offset), float(psx), float(psy),
            kspec.kernel_id, int(integrated), float(kspec.norm_3d), float(kspec.support_factor),
            cheb.data_ptr() if integrated else None, cheb.numel() if integrated else 0,
            C, torch.cuda.current_stream(dev).cuda_stream,
        )
    branch = f"window kernel at window {window}" if lane0 is not None else "deposit kernel"
    _build.check(lib, code, f"coherent {branch} (clusters of {C} blocks, F={n_fields})")
    return out


def deposit_coherent_tiles(
    packed: Tensor, cand_tile: Tensor, cand_row: Tensor,
    *,
    n_fields: int,
    n_tiles: int,
    cfg: PallasDepositConfig,
    kernel: str,
    projection: str,
    psx: float,
    psy: float,
    offset: float,
) -> Tensor:
    """The level-0 tiles' extended accumulators, (n_tiles, F*R, 128) f32,
    from packed rows read in place.

    ``packed`` (n_rows, 8, 2048) holds [u_loc, v_loc, h, values..., key] per
    lane; ``cand_tile``/``cand_row`` (int32, sorted by tile; pads carry tile
    ``n_tiles``) list each (tile, row) pair whose row holds lanes of that
    tile. On a CUDA tensor this launches the hand-written kernel
    ``csrc/coherent.cu`` (built at first use) over clusters of
    ``_CLUSTER`` thread blocks a tile, rank r taking every C-th of the
    tile's candidate rows from the r-th (``cluster_rank(..., group=1)``),
    and raises if the build or the launch fails, naming the
    cluster size; on a CPU tensor it runs
    :func:`deposit_coherent_tiles_plain`. The sums are f32.
    """
    if projection not in ("kernel3d", "integrated"):
        raise ValueError(f"projection must be 'kernel3d' or 'integrated', got {projection!r}")
    args = dict(n_fields=n_fields, n_tiles=n_tiles, cfg=cfg, kernel=kernel,
                projection=projection, psx=psx, psy=psy, offset=offset)
    if packed.device.type == "cpu":
        return deposit_coherent_tiles_plain(packed, cand_tile, cand_row, **args)
    _check_kernel_inputs(packed, n_fields, cand_tile=cand_tile, cand_row=cand_row)
    tr = torch.arange(n_tiles, dtype=torch.int32, device=packed.device)
    cstart = torch.searchsorted(cand_tile, tr).to(torch.int32)
    cend = torch.searchsorted(cand_tile, tr, right=True).to(torch.int32)
    out = _launch(packed, cand_row, None, cstart, cend, window=_CHUNK, **args)
    deposit_coherent_tiles.launches += 1
    return out


#: kernel launches made by :func:`deposit_coherent_tiles` in this process (CUDA only)
deposit_coherent_tiles.launches = 0


def deposit_coherent_windows_plain(
    packed: Tensor, cand_tile: Tensor, cand_row: Tensor, cand_wb0: Tensor, cand_nw: Tensor,
    *,
    window: int,
    n_fields: int,
    n_tiles: int,
    cfg: PallasDepositConfig,
    kernel: str,
    projection: str,
    psx: float,
    psy: float,
    offset: float,
) -> Tensor:
    """Plain torch version of :func:`deposit_coherent_windows`: the plain
    whole-row deposit restricted to each candidate's windows, lanes
    ``[wb0 * W, (wb0 + nw) * W)`` of its row. It does not expand window
    steps, so the kernel's step list is checked against it."""
    lane = torch.arange(_CHUNK, device=packed.device)[None, :]
    lo = cand_wb0.to(torch.int64)[:, None] * window
    lane_ok = (lane >= lo) & (lane < lo + cand_nw.to(torch.int64)[:, None] * window)
    return _plain_deposit(packed, cand_tile, cand_row, lane_ok, n_fields=n_fields, n_tiles=n_tiles, cfg=cfg,
                          kernel=kernel, projection=projection, psx=psx, psy=psy, offset=offset)


def window_steps(cand_tile: Tensor, cand_row: Tensor, cand_wb0: Tensor, cand_nw: Tensor, *,
                 window: int, n_steps: int, n_tiles: int):
    """The window kernel's step list, on the candidates' device: each
    candidate (in tile order) expands into its ``nw`` window steps. Returns
    (step_row, step_lane0, wstart, wend), int32: step j reads ``window``
    lanes of row ``step_row[j]`` from lane ``step_lane0[j]``, and tile t
    owns steps ``[wstart[t], wend[t])``. ``n_steps`` is Σ nw (the layout's
    ``b0w``), so that no count comes back to the host."""
    dev = cand_tile.device
    nw = cand_nw.to(torch.int64)
    cnw = torch.cumsum(nw, 0)  # steps up to and including each candidate
    g = torch.arange(n_steps, dtype=torch.int64, device=dev)
    ci = torch.searchsorted(cnw, g, right=True)  # zero-width candidates are skipped
    j = g - (cnw.index_select(0, ci) - nw.index_select(0, ci))
    step_row = cand_row.index_select(0, ci).to(torch.int32)
    step_lane0 = ((cand_wb0.to(torch.int64).index_select(0, ci) + j) * window).to(torch.int32)
    tr = torch.arange(n_tiles, dtype=cand_tile.dtype, device=dev)
    cnw0 = torch.cat([cnw.new_zeros(1), cnw])
    wstart = cnw0.index_select(0, torch.searchsorted(cand_tile, tr)).to(torch.int32)
    wend = cnw0.index_select(0, torch.searchsorted(cand_tile, tr, right=True)).to(torch.int32)
    return step_row.contiguous(), step_lane0.contiguous(), wstart, wend


def deposit_coherent_windows(
    packed: Tensor, cand_tile: Tensor, cand_row: Tensor, cand_wb0: Tensor, cand_nw: Tensor, steps: tuple,
    *,
    window: int,
    n_fields: int,
    n_tiles: int,
    cfg: PallasDepositConfig,
    kernel: str,
    projection: str,
    psx: float,
    psy: float,
    offset: float,
) -> Tensor:
    """Kernel #2's window branch: the level-0 tiles' extended accumulators,
    (n_tiles, F*R, 128) f32, from the candidates' W-lane windows only.

    The candidates are as :func:`deposit_coherent_tiles` takes them, plus
    each one's first window ``cand_wb0`` and window count ``cand_nw``
    (int32), and ``steps``, their window steps as :func:`window_steps`
    expands them (the layout's ``win_steps``). On a CUDA tensor this
    launches ``csrc/coherent.cu``'s window kernel over the steps, clusters
    of ``_CLUSTER`` blocks a tile, and raises, naming the window, if the
    build or the launch fails; on a CPU tensor it runs
    :func:`deposit_coherent_windows_plain` on the candidates. The TPU
    kernel's per-window K4 column class (the layout's ``k4n``) changes no
    value on the card and is not taken."""
    if projection not in ("kernel3d", "integrated"):
        raise ValueError(f"projection must be 'kernel3d' or 'integrated', got {projection!r}")
    args = dict(n_fields=n_fields, n_tiles=n_tiles, cfg=cfg, kernel=kernel,
                projection=projection, psx=psx, psy=psy, offset=offset)
    if packed.device.type == "cpu":
        return deposit_coherent_windows_plain(packed, cand_tile, cand_row, cand_wb0, cand_nw, window=window, **args)
    step_row, step_lane0, wstart, wend = steps
    _check_kernel_inputs(packed, n_fields, step_row=step_row, step_lane0=step_lane0)
    _check_kernel_inputs(packed, n_fields, wstart=wstart, wend=wend)
    out = _launch(packed, step_row, step_lane0, wstart, wend, window=window, **args)
    deposit_coherent_windows.launches += 1
    return out


#: kernel launches made by :func:`deposit_coherent_windows` in this process (CUDA only)
deposit_coherent_windows.launches = 0


# ---------------------------------------------------------------------------
# Layout and synced render
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CoherentLayout:
    """Row-prepped channel layout, candidate list and sorted routed tail."""

    spec: MapSpec
    kernel: str
    geom0: _LevelGeometry  # coherent (smallest footprint) level geometry
    bases: tuple  # composite-key bases per level (+ oversize, pad)
    packed: Tensor  # (n_rows, 8, C): [u, v, h, val.., ckey, 0..]
    cand_tile: Tensor  # (n_cand,) int32 tile of each candidate, ascending
    cand_row: Tensor  # (n_cand,) int32 packed row of each candidate
    n_cand: int
    tail: Optional[tuple]  # key-sorted routed tail (u, v, h, values, key)
    tail_metas: tuple  # per populated tail level: (level index, geom, lo, count)
    n_tail_oversize: int
    n_tail_sorted: int  # routed tail length
    n_fields: int
    n_valid: int
    stats: dict  # row/candidate diagnostics (coherent_fraction etc.)
    cand_k4: Optional[Tensor] = None  # (n_cand,) 1 = every lane sub-pixel
    window: int = 0  # W-lane window steps (0 = whole-row steps)
    cand_win: tuple = ()  # (wb0, nw, k4n) (n_cand,) int32 each, window mode only
    b0w: int = 0  # window steps, Σ nw (the TPU pads this count to 4096s; here it is exact)
    win_steps: tuple = ()  # window_steps(...): (step_row, step_lane0, wstart, wend), window mode only


def tile_particles_coherent(
    x, y, h, values, spec: MapSpec,
    *,
    kernel: str = "cubic_spline",
    levels: tuple[PallasDepositConfig, ...] = PALLAS_LEVELS,
    d_max: int = _D_MAX,
    prep: Optional[str] = None,
    window: int = 0,
    device="cuda",
) -> CoherentLayout:
    """Build the coherent-order layout on ``device``. One small host sync:
    the stage-A counts vector carries the candidate, heavy-row, bucket and
    per-level routed-tail counts, so the tail gather and sort follow
    without another.

    ``prep``: stage-A engine — ``"pallas"`` (the CUDA row-prep kernel; its
    plain torch version on the CPU), ``"xla"`` (the plain torch row sort),
    or ``None``: the kernel on a CUDA device outside window mode, the row
    sort elsewhere.

    ``window``: 0 renders each candidate as whole-row steps; a power of two
    W in [128, 2048) renders only the W-lane windows that cover each
    candidate's lane segment (kernel #2's window branch,
    :func:`deposit_coherent_windows`). It needs ``prep="xla"`` (``None``
    resolves to it; ``"pallas"`` raises). Exact for any value.
    """
    with span("layout.coherent") as sp:
        device = torch.device(device)
        prep = _resolve_prep(prep, device, window)
        st = _setup(spec, kernel, levels, d_max)
        values, _ = as_field_matrix(values, device, _MAX_FIELDS)
        x, y, h, values, n_valid = _device_inputs(x, y, h, values, spec, device)
        n_rows = x.shape[0] // _CHUNK
        n_fields = values.shape[0]
        packed, sk, sr, sk4, tail_eff, _, counts, *cand_win = _stage_a(prep, x, y, h, values, st, window)
        cvec = counts.tolist()  # the ONLY host sync
        n_wsteps = cvec[-1] if window else 0
        n_cand, n_heavy, n_tail = cvec[:3]
        nb = len(_TAIL_BUCKETS)
        nbs = cvec[3:3 + nb]
        lc = cvec[3 + nb:3 + nb + st.n_levels + 1]

        tail, metas = None, []
        if n_tail:
            flat, key = _tail_gather(packed, tail_eff, n_tail, n_fields, st)
            tail = _tail_sort_dense(packed, flat, key, n_fields)
            lo = 0
            for li, g in enumerate(st.geoms):
                if g is not None and lc[li] > 0:
                    metas.append((li, g, lo, lc[li]))
                lo += lc[li]
        n_coh_rows = n_rows - n_heavy
        sp.count(particles=n_valid, n_rows=n_rows, coherent_rows=n_coh_rows, n_candidates=n_cand,
                 routed_particles=sum(lc), n_tail_oversize=lc[st.n_levels])
        cand_win = tuple(a[:n_cand] for a in cand_win)
        win_steps = window_steps(sk[:n_cand], sr[:n_cand], *cand_win[:2], window=window, n_steps=n_wsteps,
                                 n_tiles=st.geom0.n_tiles) if window else ()
        return CoherentLayout(
            spec=spec, kernel=kernel, geom0=st.geom0, bases=st.bases, packed=packed,
            cand_tile=sk[:n_cand], cand_row=sr[:n_cand], cand_k4=sk4[:n_cand],
            window=window, cand_win=cand_win, b0w=n_wsteps, win_steps=win_steps,
            n_cand=n_cand, tail=tail, tail_metas=tuple(metas),
            n_tail_oversize=lc[st.n_levels], n_tail_sorted=sum(lc),
            n_fields=n_fields, n_valid=n_valid,
            stats={
                "n_rows": n_rows,
                "coherent_rows": n_coh_rows,
                "coherent_fraction": n_coh_rows / max(1, n_rows),
                "n_candidates": n_cand,
                "heavy_rows": n_heavy,
                "tail_particles": n_tail,
                "routed_particles": sum(lc),
                "tail_bucket_rows": dict(zip(_TAIL_BUCKETS, nbs)),
                # per-level routed-tail particle counts (+ oversize last); the
                # fused engine's caps_from_layout reads these
                "level_tail_counts": list(lc),
                "n_window_steps": n_wsteps,
            },
        )


def _render(packed, cand_tile, cand_row, tail, tail_levels, *, spec, kernel, projection,
            geom0, bases, n_fields, win=None) -> Tensor:
    """(F, ny, nx): the coherent pass over the candidates (whole rows, or
    with ``win`` = (W, wb0, nw, steps) their W-lane windows), then each
    routed tail level ``(li, geom, cap)`` through the sorted engine's
    kernel."""
    ny, nx = spec.shape
    psy, psx = spec.pixel_size
    kw = dict(kernel=kernel, projection=projection, psx=psx, psy=psy, offset=spec.sample_offset)
    total = torch.zeros((n_fields, ny, nx), dtype=torch.float32, device=packed.device)
    if cand_tile is not None and cand_tile.numel():
        launches = deposit_coherent_windows.launches + deposit_coherent_tiles.launches
        with span("deposit.coherent", candidates=cand_tile.shape[0]) as sp:
            if win is not None:
                W, wb0, nw, steps = win
                tiles = deposit_coherent_windows(
                    packed, cand_tile, cand_row, wb0, nw, steps, window=W,
                    n_fields=n_fields, n_tiles=geom0.n_tiles, cfg=geom0.cfg, **kw
                )
            else:
                tiles = deposit_coherent_tiles(
                    packed, cand_tile, cand_row, n_fields=n_fields, n_tiles=geom0.n_tiles, cfg=geom0.cfg, **kw
                )
            total += _overlap_add(
                tiles, geom0.cfg, geom0.tx, geom0.n_tiles_y, geom0.n_tiles_x, n_fields, ny, nx, spec.periodic_wrap
            )
            sp.count(launches=deposit_coherent_windows.launches + deposit_coherent_tiles.launches - launches)
    if tail is not None:
        tu, tv, th, t_values, skey = tail
        launches, register_launches = deposit_tiles.launches, deposit_tiles.register_launches
        with span("deposit.tail", particles=tu.shape[0]) as sp:
            for li, geom, cap in tail_levels:
                pstart, pcount = _tail_level_ranges(skey, bases[li], geom, cap)
                tiles = deposit_tiles(tu, tv, th, t_values, pstart, pcount, cfg=geom.cfg, **kw)
                total += _overlap_add(
                    tiles, geom.cfg, geom.tx, geom.n_tiles_y, geom.n_tiles_x, n_fields, ny, nx, spec.periodic_wrap
                )
            sp.count(launches=deposit_tiles.launches - launches,
                     register_launches=deposit_tiles.register_launches - register_launches)
    return total


def deposit_coherent(
    layout: CoherentLayout,
    *,
    precision: str = "bf16x2",
    projection: str = "kernel3d",
) -> Tensor:
    """Render the full adaptive map stack from a :class:`CoherentLayout`, on
    the layout's device: the coherent pass (kernel ``csrc/coherent.cu``, its
    window branch for a window-mode layout),
    each routed tail level (kernel ``csrc/deposit2d.cu``), and oversize
    particles through the oversize route (:func:`.deposit_wide.deposit_wide`)
    on the same device.
    Returns (F, ny, nx). ``precision`` is validated; the sums are f32."""
    check_precision(precision)
    spec = layout.spec
    total = _render(
        layout.packed, layout.cand_tile, layout.cand_row, layout.tail,
        tuple((li, g, None) for li, g, _, _ in layout.tail_metas),
        spec=spec, kernel=layout.kernel, projection=projection, geom0=layout.geom0,
        bases=layout.bases, n_fields=layout.n_fields,
        win=(layout.window, *layout.cand_win[:2], layout.win_steps) if layout.window else None,
    )
    if layout.n_tail_oversize:
        # oversize particles end the sorted tail, in global pixel coordinates
        with span("deposit.oversize", particles=layout.n_tail_oversize):
            tu, tv, th, t_values, _ = layout.tail
            sl = slice(layout.n_tail_sorted - layout.n_tail_oversize, layout.n_tail_sorted)
            deposit_wide(tu[sl], tv[sl], th[sl], t_values[:, sl], spec, kernel=layout.kernel,
                         projection=projection, out=total)
    return total


def deposit_2d_coherent(
    x, y, h, values, spec: MapSpec,
    *,
    kernel: str = "cubic_spline",
    precision: str = "bf16x2",
    projection: str = "kernel3d",
    d_max: int = _D_MAX,
    window: int = 0,
    prep: Optional[str] = None,
    device="cuda",
) -> Tensor:
    """Adaptive-h deposit for snapshot-ordered input: coherent rows deposit
    in place (no global sort), the rest route through the sorted engine's
    kernel. Correct for any input order; fastest when consecutive particles
    are spatially adjacent. Returns (ny, nx) or (F, ny, nx) on ``device``."""
    check_precision(precision)
    values, single = as_field_matrix(values, device, _MAX_FIELDS)
    layout = tile_particles_coherent(
        x, y, h, values, spec, kernel=kernel, d_max=d_max, window=window, prep=prep, device=device
    )
    total = deposit_coherent(layout, precision=precision, projection=projection)
    return total[0] if single else total


# ---------------------------------------------------------------------------
# Zero-sync fused render with pinned capacities
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CoherentCaps:
    """Static capacities for the zero-sync fused coherent render.

    The synced engine (:func:`tile_particles_coherent` +
    :func:`deposit_coherent`) reads the data-dependent counts on the host
    once per render to size its arrays. With capacities pinned ahead of
    time, :func:`deposit_2d_coherent_fused` sizes every buffer and launch
    from them and makes no host sync; the counts stay on the device and are
    checked against the capacities there, giving an ``ok`` flag.

    Capacities are stable across the macro-chunks of a snapshot: derive
    them from a first (synced) render via :func:`caps_from_layout` and
    reuse; on overflow re-render through the synced engine (exact).
    """

    b0: int  # candidate capacity
    bucket_caps: tuple[int, ...]  # rows per tail bucket _TAIL_BUCKETS[1:]
    level_caps: tuple[int, ...]  # routed-tail particles per footprint level


def caps_from_layout(layout: CoherentLayout, *,
                     slack: Optional[float] = None,
                     levels=PALLAS_LEVELS) -> CoherentCaps:
    """Derive fused-render capacities from a synced first render, with
    headroom for chunk-to-chunk drift.

    ``slack=None`` (default) sizes each capacity from its own measured
    occupancy: count + ``6 * sqrt(count)`` + a small floor (the drift of a
    count that aggregates many independent row/particle events is
    sqrt-scale). A float ``slack`` multiplies instead, for workloads whose
    chunk statistics drift (e.g. calibrating on a small first chunk).

    Floors: a populated bucket (or one adjacent to a populated bucket —
    rows drift across half-octave boundaries) never caps below 8 rows, and
    every level up to the deepest populated one gets at least one chunk of
    tail capacity, so capacities derived from a small first chunk are safe
    to reuse. Same arithmetic as the JAX package's ``caps_from_layout``."""
    if slack is None:
        def grow(v):
            return int(v + 6.0 * np.sqrt(v) + 8) if v else 0

        def bucket_grow(v):
            return grow(v) + 8
    else:
        def grow(v):
            return int(np.ceil(v * slack)) if v else 0

        def bucket_grow(v):
            return grow(v) + 8 + int(2.0 * np.sqrt(v))
    stats = layout.stats
    b0 = max(4096, -(-grow(stats["n_candidates"]) // 4096) * 4096)
    raw = [stats["tail_bucket_rows"][t] for t in _TAIL_BUCKETS[1:]]
    nb = len(raw)
    active = [any(raw[j] for j in range(max(0, i - 1), min(nb, i + 2))) for i in range(nb)]
    bucket_caps = tuple(bucket_grow(v) if act else 0 for v, act in zip(raw, active))
    lc = stats["level_tail_counts"][: len(levels)]
    lmax = max((li for li, v in enumerate(lc) if v), default=-1)
    level_caps = tuple((grow(v) + _CHUNK) if li <= lmax else 0 for li, v in enumerate(lc))
    return CoherentCaps(b0=b0, bucket_caps=bucket_caps, level_caps=level_caps)


def caps_union(*all_caps: CoherentCaps) -> CoherentCaps:
    """Elementwise max of capacities — merge per-shard (or per-chunk)
    calibrations into one set every render can share."""
    if not all_caps:
        raise ValueError("caps_union needs at least one CoherentCaps")
    for name in ("bucket_caps", "level_caps"):
        lengths = {len(getattr(c, name)) for c in all_caps}
        if len(lengths) > 1:
            # zip would silently truncate to the shortest — an
            # under-capacity union that drops deep-level tail work
            raise ValueError(
                f"caps_union: mismatched {name} lengths {sorted(lengths)} "
                "(calibrate every shard with the same levels)"
            )
    return CoherentCaps(
        b0=max(c.b0 for c in all_caps),
        bucket_caps=tuple(max(vs) for vs in zip(*(c.bucket_caps for c in all_caps))),
        level_caps=tuple(max(vs) for vs in zip(*(c.level_caps for c in all_caps))),
    )


def deposit_2d_coherent_fused(
    x, y, h, values, spec: MapSpec, caps: CoherentCaps,
    *,
    kernel: str = "cubic_spline",
    levels: tuple[PallasDepositConfig, ...] = PALLAS_LEVELS,
    precision: str = "bf16x2",
    projection: str = "kernel3d",
    d_max: int = _D_MAX,
    prep: Optional[str] = None,
    device="cuda",
):
    """Zero-host-sync coherent render with pinned capacities.

    Returns ``(maps, ok)`` where ``ok`` is an on-device bool: True iff
    every data-dependent count fit ``caps`` (and no oversize smoothing
    lengths appeared), i.e. the map is exact. **Callers MUST check
    ``ok``** — an over-capacity render silently drops the excess, so a
    caller that ignores the flag gets a corrupt map with no other signal.
    On ``ok == False`` re-render through :func:`deposit_2d_coherent`
    (synced, always exact) and derive fresh capacities via
    :func:`caps_from_layout`.

    Streaming loops over macro-chunks: macro-chunks of a spatially-ordered
    snapshot sample systematically different regions, so caps calibrated
    on chunk 0 alone can overflow on later chunks. Calibrate on a few
    representative chunks, combine with :func:`caps_union`, and treat the
    synced re-render as the correctness backstop.

    Every buffer and launch is sized from ``caps`` and the input length;
    the counts never come back to the host. Inputs already on ``device``
    make no copy; constants (bucket bounds, capacities, the Chebyshev table)
    are uploaded once per process and device.
    """
    check_precision(precision)
    device = torch.device(device)
    prep = _resolve_prep(prep, device)
    st = _setup(spec, kernel, levels, d_max)
    values, single = as_field_matrix(values, device, _MAX_FIELDS)
    x, y, h, values, _ = _device_inputs(x, y, h, values, spec, device)
    C, nl = _CHUNK, st.n_levels
    n_rows = x.shape[0] // C
    n_fields = values.shape[0]
    packed, sk, sr, _, tail_eff, _, counts = _stage_a(prep, x, y, h, values, st)
    nb = len(_TAIL_BUCKETS)
    n_cand = counts[0]
    nbs = counts[3:3 + nb]
    lc = counts[3 + nb:3 + nb + nl + 1]

    b0 = min(caps.b0, n_rows * st.d_max)
    cap_rows = tuple(_next_size_class(c) if c else 0 for c in caps.bucket_caps)
    ok = (n_cand <= b0) & (nbs[1:] <= device_const(cap_rows, torch.int64, device)).all()
    tail_levels, lev_caps = [], []
    for li, g in enumerate(st.geoms):
        cap = caps.level_caps[li] if li < len(caps.level_caps) else 0
        if g is not None and cap > 0:
            cap = C * _next_size_class(-(-cap // C))
            tail_levels.append((li, g, cap))
            lev_caps.append(cap)
    sel = [t[0] for t in tail_levels]
    if sel:
        lc_sel = lc.index_select(0, device_const(sel, torch.int64, device))
        ok = ok & (lc_sel <= device_const(lev_caps, torch.int64, device)).all()
    # levels without capacity, and oversize, must be empty
    unsel = [li for li in range(nl + 1) if li not in sel]
    ok = ok & (lc.index_select(0, device_const(unsel, torch.int64, device)) == 0).all()

    tail = None
    if tail_levels or any(caps.bucket_caps):
        n_slots = min(
            n_rows * C,
            n_rows * _TAIL_BUCKETS[0] + sum(t * c for t, c in zip(_TAIL_BUCKETS[1:], cap_rows)),
        )
        flat, key = _tail_gather(packed, tail_eff, n_slots, n_fields, st)
        tail = _tail_sort_dense(packed, flat, key, n_fields)
    else:
        ok = ok & (counts[2] == 0)  # no tail without tail capacity

    cand_tile = cand_row = None
    if b0:
        live = torch.arange(b0, device=device) < n_cand
        cand_tile = torch.where(live, sk[:b0], st.geom0.n_tiles).to(torch.int32)
        cand_row = torch.where(live, sr[:b0], 0).to(torch.int32)
    total = _render(
        packed, cand_tile, cand_row, tail, tuple(tail_levels),
        spec=spec, kernel=kernel, projection=projection, geom0=st.geom0,
        bases=st.bases, n_fields=n_fields,
    )
    return (total[0] if single else total), ok
