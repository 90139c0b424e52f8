"""The 2D deposit's oversize route: footprints wider than kernel #1's widest
level, through a hand-written CUDA kernel.

A particle whose support reaches past 31 px (``deposit_tiled``'s K = 64
level) is *oversize*; the sorted layout keeps such particles at the end of
its arrays, and the coherent layout at the end of its tail, in GLOBAL f32
pixel coordinates. Halo cutouts much finer than their particles' h are
mostly oversize.

On a CUDA tensor :func:`deposit_wide` runs ``csrc/deposit_wide.cu``
(replacing no TPU kernel; see its head): per batch of particles, the
binning kernel counts each 32 x 32 output tile's particles, torch scans the
counts into list starts (the one number read back: the lists' total), the
binning kernel fills the per-tile lists in particle order, and the deposit
kernel sums each tile's list in registers, over a cluster of
:data:`CLUSTER` blocks a tile, and adds the tile into the image once. On a CPU tensor it runs :func:`deposit_wide_plain`, the plain torch
stencil engine's wide windows and dense pass (``ops/deposit.py::
deposit_2d``) on the same particles, which is also what the kernel is held
to on the card.

:func:`deposit_wide_tiled` is the tiled algorithm on any device:
``plain=True`` runs its plain torch version (:func:`tile_counts_plain`,
:func:`tile_lists_plain`, :func:`deposit_lists_plain`), which repeats the
kernels' arithmetic.
"""

from __future__ import annotations

import torch

from .. import _build
from ..kernels.splines import get_kernel, integrated_kernel_chebyshev, kernel_weight_q2
from ..utils.profiling import count
from ._device import device_const
from .deposit import MapSpec, deposit_2d

Tensor = torch.Tensor

#: side of an output tile (px); csrc/deposit_wide.cu's kTile
TILE = 32
#: px the binning shortens each gap by (csrc/deposit_wide.cu's kBinSlack)
BIN_SLACK = 0.01
#: thread blocks a tile's list is split over on the card (a thread-block
#: cluster, whose parts are summed in rank order): fixed, never taken from
#: the counts. A cutout's central tiles hold several times the mean list
#: (4.4x in the halo cell's largest cutout), and one block would walk them
#: alone while the rest of the card idles
CLUSTER = 4
#: scratch a call may hold at once: per-particle geometry (20 B), per-tile
#: counts and starts (12 B) and the lists (4 B an entry); past it the
#: particles go in batches over the same image
SCRATCH_BYTES = 256 << 20
_GEO_BYTES = 20
_TILE_BYTES = 12
_ENTRY_BYTES = 4


def tile_grid(spec: MapSpec) -> tuple[int, int]:
    """(tiles a row, tile rows) of the map."""
    ny, nx = spec.shape
    return -(-nx // TILE), -(-ny // TILE)


def particle_geometry(u: Tensor, v: Tensor, h: Tensor, *, kernel: str, projection: str,
                      psx: float, psy: float) -> tuple[Tensor, Tensor, float]:
    """The per-particle inputs of the binning and the deposit: ``geo`` (n, 4)
    f32 (u, v, sx, sy), where sx and sy are the normalised distance a pixel
    (NaN for h <= 0, which then reaches no tile); ``scale`` (n,) f32, the
    factor of the values (the kernel's normalisation); and ``lim2``, the
    squared normalised support. The same factors as kernel #1's
    ``particle_setup``."""
    kspec = get_kernel(kernel)
    inv_h = 1.0 / h
    if projection == "integrated":
        inv_n = inv_h * (1.0 / kspec.support_factor)
        scale = inv_h * inv_h
        lim2 = 1.0
    elif projection == "kernel3d":
        inv_n = inv_h
        scale = (kspec.norm_3d * inv_h) * (inv_h * inv_h)
        lim2 = kspec.support_factor ** 2
    else:
        raise ValueError(f"projection must be 'kernel3d' or 'integrated', got {projection!r}")
    inv_n = torch.where(h > 0.0, inv_n, float("nan"))
    geo = torch.stack([u, v, psx * inv_n, psy * inv_n], dim=1)
    return geo.to(torch.float32).contiguous(), scale.to(torch.float32).contiguous(), lim2


def _spans(n_px: int, offset: float, device) -> tuple[Tensor, Tensor]:
    """Each tile's first and last sample point along an axis of ``n_px``."""
    lo = torch.arange(0, n_px, TILE, device=device)
    hi = torch.clamp(lo + TILE, max=n_px) - 1
    return lo.to(torch.float32) + offset, hi.to(torch.float32) + offset


def _axis_gap(c: Tensor, a: Tensor, b: Tensor, period: float) -> Tensor:
    """csrc/deposit_wide.cu's ``axis_gap``, operation by operation: the gap
    between each coordinate and each tile's sample points (0 inside), the
    least over the images on a periodic axis (``period``), shortened by the
    slack. ``c`` (1, n), ``a`` and ``b`` (T, 1) give (T, n)."""
    zero = torch.zeros((), dtype=torch.float32, device=c.device)

    def gap(x):
        return torch.maximum(torch.maximum(a - x, x - b), zero)

    g = gap(c)
    if period:
        g = torch.minimum(torch.minimum(g, gap(c - period)), gap(c + period))
    return torch.maximum(g - BIN_SLACK, zero)


def tile_hits_plain(geo: Tensor, lim2: float, spec: MapSpec, tiles: slice) -> Tensor:
    """(T, n) bool: whether each particle of ``geo`` reaches each tile of the
    range ``tiles`` (row-major tile ids), by the binning kernel's test."""
    ny, nx = spec.shape
    ntx, _ = tile_grid(spec)
    ids = torch.arange(tiles.start, tiles.stop, device=geo.device)
    ax, bx = (s[ids % ntx, None] for s in _spans(nx, spec.sample_offset, geo.device))
    ay, by = (s[ids // ntx, None] for s in _spans(ny, spec.sample_offset, geo.device))
    per = spec.periodic_wrap
    gx = _axis_gap(geo[None, :, 0], ax, bx, float(nx) if per else 0.0) * geo[None, :, 2]
    gy = _axis_gap(geo[None, :, 1], ay, by, float(ny) if per else 0.0) * geo[None, :, 3]
    return gx * gx + gy * gy < lim2


def _tile_blocks(n: int, n_tiles: int):
    """Tile ranges whose (tiles x particles) tests hold ~2^24 elements."""
    step = max(1, (1 << 24) // max(1, n))
    for t0 in range(0, n_tiles, step):
        yield slice(t0, min(t0 + step, n_tiles))


def tile_counts_plain(geo: Tensor, lim2: float, spec: MapSpec) -> Tensor:
    """Plain version of the binning's count pass: (n_tiles,) int32."""
    ntx, nty = tile_grid(spec)
    parts = [tile_hits_plain(geo, lim2, spec, ts).sum(dim=1) for ts in _tile_blocks(geo.shape[0], ntx * nty)]
    return torch.cat(parts).to(torch.int32)


def tile_lists_plain(geo: Tensor, lim2: float, spec: MapSpec) -> Tensor:
    """Plain version of the binning's fill pass: every tile's particle
    indices (int32), tile by tile, each tile's in particle order."""
    ntx, nty = tile_grid(spec)
    parts = [torch.nonzero(tile_hits_plain(geo, lim2, spec, ts))[:, 1]
             for ts in _tile_blocks(geo.shape[0], ntx * nty)]
    return torch.cat(parts).to(torch.int32)


def deposit_lists_plain(geo: Tensor, scale: Tensor, values: Tensor, starts: Tensor, lists: Tensor,
                        spec: MapSpec, *, kernel: str, projection: str, lim2: float, out: Tensor) -> Tensor:
    """Plain version of the deposit kernel: each tile's list (``starts``
    (n_tiles + 1,), ``lists``) summed over the tile's pixels, with the
    kernel's normalised offsets, minimum image and support test, added into
    ``out`` (F, ny, nx). Evaluates every (entry, tile pixel) pair in blocks
    of ~2^22."""
    ny, nx = spec.shape
    ntx, _ = tile_grid(spec)
    off = spec.sample_offset
    dev = geo.device
    counts = starts[1:] - starts[:-1]
    tile_of = torch.repeat_interleave(torch.arange(counts.shape[0], device=dev), counts)
    k = torch.arange(TILE, device=dev)
    flat_out = out.view(out.shape[0], -1)
    step = max(1, (1 << 22) // (TILE * TILE))
    for e0 in range(0, lists.shape[0], step):
        t = tile_of[e0:e0 + step]
        p = lists[e0:e0 + step].long()
        col = (t % ntx)[:, None] * TILE + k  # (E, TILE)
        row = (t // ntx)[:, None] * TILE + k
        dx = (col.to(torch.float32) + off) - geo[p, 0, None]
        dy = (row.to(torch.float32) + off) - geo[p, 1, None]
        if spec.periodic_wrap:
            dx = dx - nx * torch.round(dx * (1.0 / nx))
            dy = dy - ny * torch.round(dy * (1.0 / ny))
        dxn = dx * geo[p, 2, None]
        dyn = dy * geo[p, 3, None]
        q2 = (dyn * dyn)[:, :, None] + (dxn * dxn)[:, None, :]  # (E, rows, cols)
        w = torch.where(q2 < lim2, kernel_weight_q2(q2, kernel, projection), 0.0)
        inside = (row < ny)[:, :, None] & (col < nx)[:, None, :]
        w = torch.where(inside, w, 0.0)
        flat = (torch.clamp(row, max=ny - 1)[:, :, None] * nx + torch.clamp(col, max=nx - 1)[:, None, :]).reshape(-1)
        vals = values[:, p] * scale[p]  # (F, E)
        for f in range(values.shape[0]):
            flat_out[f].index_add_(0, flat, (w * vals[f][:, None, None]).reshape(-1))
    return out


def deposit_wide_plain(u: Tensor, v: Tensor, h: Tensor, values: Tensor, spec: MapSpec, *, kernel: str,
                       projection: str, out: Tensor) -> Tensor:
    """The plain route: world coordinates from the global pixel coordinates,
    then the plain torch stencil engine (``deposit_2d``: its wide windows and
    dense pass, and their counters on the innermost open span) on the same
    device, added into ``out`` (F, ny, nx)."""
    x0, _, y0, _ = spec.extent
    psy, psx = spec.pixel_size
    img = deposit_2d(u * psx + x0, v * psy + y0, h, values.T, spec, kernel=kernel, projection=projection,
                     device=u.device)
    out += img.permute(2, 0, 1)
    return out


def _bin_counts(geo: Tensor, lim2: float, spec: MapSpec, plain: bool) -> Tensor:
    if plain:
        return tile_counts_plain(geo, lim2, spec)
    ny, nx = spec.shape
    ntx, nty = tile_grid(spec)
    counts = torch.empty(ntx * nty, dtype=torch.int32, device=geo.device)
    lib, _ = _build.load("deposit_wide")
    code = lib.wide_bin_launch(geo.data_ptr(), geo.shape[0], nx, ny, float(spec.sample_offset),
                               int(spec.periodic_wrap), float(lim2), counts.data_ptr(), None, None,
                               torch.cuda.current_stream(geo.device).cuda_stream)
    _build.check(lib, code, "deposit_wide binning count")
    deposit_wide.launches += 1
    return counts


def _bin_lists(geo: Tensor, lim2: float, spec: MapSpec, starts: Tensor, total: int, plain: bool) -> Tensor:
    if plain:
        return tile_lists_plain(geo, lim2, spec)
    ny, nx = spec.shape
    lists = torch.empty(total, dtype=torch.int32, device=geo.device)
    lib, _ = _build.load("deposit_wide")
    code = lib.wide_bin_launch(geo.data_ptr(), geo.shape[0], nx, ny, float(spec.sample_offset),
                               int(spec.periodic_wrap), float(lim2), None, starts.data_ptr(), lists.data_ptr(),
                               torch.cuda.current_stream(geo.device).cuda_stream)
    _build.check(lib, code, "deposit_wide binning fill")
    deposit_wide.launches += 1
    return lists


def _deposit(geo, scale, values, starts, lists, spec, *, kernel, projection, lim2, out, plain: bool) -> None:
    if plain:
        deposit_lists_plain(geo, scale, values, starts, lists, spec, kernel=kernel, projection=projection,
                            lim2=lim2, out=out)
        return
    ny, nx = spec.shape
    kspec = get_kernel(kernel)
    integrated = projection == "integrated"
    cheb = device_const(integrated_kernel_chebyshev(kernel), torch.float32, geo.device) if integrated else None
    lib, _ = _build.load("deposit_wide")
    code = lib.wide_deposit_launch(
        geo.data_ptr(), scale.data_ptr(), values.data_ptr(), values.stride(0), values.shape[0],
        starts.data_ptr(), lists.data_ptr(), nx, ny, float(spec.sample_offset), int(spec.periodic_wrap),
        float(lim2), out.data_ptr(), kspec.kernel_id, int(integrated),
        cheb.data_ptr() if integrated else None, cheb.numel() if integrated else 0, CLUSTER,
        torch.cuda.current_stream(geo.device).cuda_stream,
    )
    _build.check(lib, code, f"deposit_wide deposit (clusters of {CLUSTER} blocks)")
    deposit_wide.launches += 1


def _check_inputs(u, v, h, values, out, spec: MapSpec) -> None:
    n = u.shape[0]
    for name, a in (("u", u), ("v", v), ("h", h)):
        if a.dtype != torch.float32 or a.ndim != 1 or a.shape[0] != n or a.device != u.device:
            raise ValueError(f"{name} must be a 1-D float32 tensor of {n} entries on {u.device}")
    if values.dtype != torch.float32 or values.ndim != 2 or values.shape[1] != n or values.device != u.device:
        raise ValueError(f"values must be a (F, {n}) float32 tensor on {u.device}")
    ny, nx = spec.shape
    if (out.dtype != torch.float32 or out.shape != (values.shape[0], ny, nx) or not out.is_contiguous()
            or out.device != u.device):
        raise ValueError(f"out must be a contiguous ({values.shape[0]}, {ny}, {nx}) float32 tensor on {u.device}")
    if n >= 2**31:
        raise ValueError("the oversize route indexes particles with int32")
    if u.device.type == "cuda" and values.stride(1) != 1:
        raise ValueError("values must have unit column stride for the oversize-route kernel")


def deposit_wide_tiled(u: Tensor, v: Tensor, h: Tensor, values: Tensor, spec: MapSpec, *, kernel: str,
                       projection: str, out: Tensor, scratch_bytes: int = SCRATCH_BYTES,
                       plain: bool = False) -> list[tuple[int, int, int]]:
    """The tiled oversize route, added into ``out`` (F, ny, nx): ``u, v``
    (n,) global f32 pixel coordinates, ``h`` (n,), ``values`` (F, n). The
    particles go in batches whose scratch stays within ``scratch_bytes``
    (a batch whose lists would not fit is halved and binned again), each
    batch over the same image: binning counts, their scan, one host read
    of the lists' total, the lists, the deposit. ``plain=True`` runs the
    plain torch versions (any device); else the kernels (CUDA). Returns
    each batch's (first particle, end, list entries)."""
    _check_inputs(u, v, h, values, out, spec)
    ntx, nty = tile_grid(spec)
    n_tiles = ntx * nty
    tile_bytes = _TILE_BYTES * (n_tiles + 1)
    # one particle's lists (at most every tile) must fit beside its geometry
    if scratch_bytes < tile_bytes + _GEO_BYTES + _ENTRY_BYTES * n_tiles:
        raise ValueError(f"scratch_bytes={scratch_bytes} cannot hold the lists of one particle over {n_tiles} tiles")
    psy, psx = spec.pixel_size
    step = max(1, (scratch_bytes - tile_bytes) // (2 * _GEO_BYTES))  # geometry within half the scratch
    n = u.shape[0]
    todo = [(p0, min(p0 + step, n)) for p0 in range(0, n, step)][::-1]
    batches = []
    while todo:
        p0, p1 = todo.pop()
        geo, scale, lim2 = particle_geometry(u[p0:p1], v[p0:p1], h[p0:p1], kernel=kernel, projection=projection,
                                             psx=psx, psy=psy)
        counts = _bin_counts(geo, lim2, spec, plain)
        starts = torch.nn.functional.pad(torch.cumsum(counts, 0, dtype=torch.int64), (1, 0))
        total = int(starts[-1])  # the one host read a batch
        if p1 - p0 > 1 and tile_bytes + _GEO_BYTES * (p1 - p0) + _ENTRY_BYTES * total > scratch_bytes:
            mid = (p0 + p1) // 2
            todo += [(mid, p1), (p0, mid)]
            continue
        if total:
            lists = _bin_lists(geo, lim2, spec, starts, total, plain)
            _deposit(geo, scale, values[:, p0:p1], starts, lists, spec, kernel=kernel, projection=projection,
                     lim2=lim2, out=out, plain=plain)
        batches.append((p0, p1, total))
    return batches


def deposit_wide(u: Tensor, v: Tensor, h: Tensor, values: Tensor, spec: MapSpec, *, kernel: str,
                 projection: str, out: Tensor) -> Tensor:
    """Add the oversize particles (``u, v`` (n,) global f32 pixel
    coordinates, ``h`` (n,), ``values`` (F, n) with unit column stride) into
    ``out`` (F, ny, nx) and return it. On a CUDA tensor: the kernels of
    ``csrc/deposit_wide.cu`` (built at first use; a failed build or launch
    raises), counting ``launches`` and ``tile_pairs`` (the lists' entries) on
    the innermost open span. On a CPU tensor: :func:`deposit_wide_plain`."""
    if u.device.type == "cpu":
        return deposit_wide_plain(u, v, h, values, spec, kernel=kernel, projection=projection, out=out)
    if u.device.type != "cuda":
        raise ValueError(f"no oversize-route kernel for device {u.device}")
    launches = deposit_wide.launches
    with torch.cuda.device(u.device):
        batches = deposit_wide_tiled(u, v, h, values, spec, kernel=kernel, projection=projection, out=out)
    count(launches=deposit_wide.launches - launches, tile_pairs=sum(b[2] for b in batches))
    return out


#: kernel launches made by the oversize route in this process (CUDA only):
#: each binning pass and each deposit call (its field groups inside)
deposit_wide.launches = 0
