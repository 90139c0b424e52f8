"""The 3D deposit's oversize route: footprints wider than kernel #6's widest
level, through a hand-written CUDA kernel.

A particle whose support reaches past 7 voxels (``grid3d_tiled``'s K = 16
level) is *oversize*; the 3D layout keeps such particles at the end of its
arrays in GLOBAL f32 voxel coordinates. A whole periodic box gridded at a
voxel near the mean interparticle spacing sends its void particles here.

On a CUDA tensor :func:`deposit_3d_wide` runs ``csrc/deposit3d_wide.cu``
(replacing no TPU kernel; see its head): per batch of particles, torch
lists each particle's 16^3 output tiles (:func:`tile_lists`: the tiles its
support's bounding box meets, a stable sort by tile, the one number read
back being the lists' total), and the kernel sums each tile's list in
shared memory, a warp an 8 x 4 patch of the tile's columns walking the
chords of its columns flattened over its 32 lanes, and adds the tile into
the cube once. While a profiler runs, the kernel counts the walks' lane
steps and the voxels they added (``walk_lanes``, ``walk_pairs`` on the
innermost open span). :func:`walk_plain` repeats that walk in plain torch,
step for step, for the tests. On a CPU tensor :func:`deposit_3d_wide` runs
:func:`deposit_3d_wide_plain`, the plain torch stencil engine
(``ops/grid3d.py::deposit_3d``) on the same particles, which is also what
the kernel is held to on the card.
"""

from __future__ import annotations

import itertools

import torch

from .. import _build
from ..kernels.splines import get_kernel
from ..utils.profiling import count, recording
from .grid3d import GridSpec, _per_axis, deposit_3d

Tensor = torch.Tensor

#: side of an output tile (voxels), every axis; csrc/deposit3d_wide.cu's kT
TILE = 16
#: voxels the binning widens each support's bounding box by (the kernel's
#: chords and patch tests take the same slack, csrc/deposit3d_wide.cu's kSlack)
SLACK = 0.01
#: a warp's patch of a tile's (x, y) columns in the kernel, along x and y
#: (csrc/deposit3d_wide.cu's kPatchX, kPatchY): lane l takes column (l % 8, l // 8)
PATCH = (8, 4)
#: scratch a call may hold at once for the binning: the expanded entries,
#: their tile keys, the sort and the lists; past it the particles go in
#: batches over the same cube (each batch one launch, which reads and
#: writes every tile its lists reach once). Read at each call.
SCRATCH_BYTES = 512 << 20
#: scratch an entry takes while a batch is binned (int32 particle index,
#: rank and key; the sort's int64 permutation, its buffers; the list)
_ENTRY_BYTES = 64


def tile_grid(spec: GridSpec) -> tuple[int, int, int]:
    """(tiles along x, along y, along z) of the cube."""
    nz, ny, nx = spec.shape
    return -(-nx // TILE), -(-ny // TILE), -(-nz // TILE)


def _axis_tiles(c: Tensor, r: Tensor, n: int, periodic: bool, offset: float) -> tuple[Tensor, Tensor]:
    """(first tile, tile count) int64 per particle along one axis of ``n``
    voxels: the tiles holding a sample index k with |k + offset - c| <= r +
    SLACK, ``c`` the global voxel coordinate and ``r`` the support radius
    (voxels). On a periodic axis the range wraps (a count reaching the end
    of the axis goes on from tile 0), and a range that wraps back into its
    first tile meets every tile; on an open axis it is cut to the grid, and
    a particle whose range misses the grid counts 0."""
    nt = -(-n // TILE)
    lo = torch.ceil(c - offset - r - SLACK)
    hi = torch.floor(c - offset + r + SLACK)
    if periodic:
        length = hi - lo + 1
        far = ~torch.isfinite(length) | (length >= n)
        lo = torch.where(far, 0.0, lo).long()
        length = torch.where(far, float(n), length).long()
        first = torch.remainder(lo, n)
        t_lo = first // TILE
        every = far | (length + first - t_lo * TILE > n)
        t_hi = torch.remainder(lo + length - 1, n) // TILE
        cnt = torch.where(every, nt, torch.remainder(t_hi - t_lo, nt) + 1)
        return torch.where(every, 0, t_lo), cnt
    # clamped in float first: a far-off centre or a huge h must not overflow
    lo = torch.clamp(lo, -1.0, float(n)).long().clamp(min=0)
    hi = torch.clamp(hi, -1.0, float(n)).long().clamp(max=n - 1)
    cnt = torch.where(hi >= lo, hi // TILE - lo // TILE + 1, 0)
    return lo // TILE, cnt


def _particle_tiles(u: Tensor, v: Tensor, w: Tensor, h: Tensor, spec: GridSpec, *,
                   kernel: str) -> tuple[Tensor, Tensor]:
    """Each particle's bounding box of tiles: ``t_lo`` (n, 3) int64, the
    first tile along x, y and z, and ``cnt`` (n, 3) int64, the tiles along
    each (all 0 for h <= 0, which reaches no voxel)."""
    per = _per_axis(spec.periodic_wrap)
    lim = get_kernel(kernel).support_factor
    dz, dy, dx = spec.voxel_size
    hd = h.double()
    live = hd > 0
    out = [_axis_tiles(c.double(), lim * hd / d, n, p, spec.sample_offset)
           for c, d, n, p in ((u, dx, spec.shape[2], per[0]), (v, dy, spec.shape[1], per[1]),
                              (w, dz, spec.shape[0], per[2]))]
    t_lo = torch.stack([o[0] for o in out], dim=1)
    cnt = torch.where(live[:, None], torch.stack([o[1] for o in out], dim=1), 0)
    return t_lo, cnt


def _batch_lists(t_lo: Tensor, cnt: Tensor, first: Tensor, total: int, spec: GridSpec) -> tuple[Tensor, Tensor]:
    """The tile lists of a batch: ``starts`` (n_tiles + 1,) int64 and
    ``lists`` int32 particle indices (within the batch), each tile's in
    particle order. ``t_lo``, ``cnt`` (n, 3) int32: each particle's tile
    box; ``first`` (n,) int32: its first entry; ``total``: the batch's
    entries. Each entry's key is its tile, x fastest."""
    ntx, nty, ntz = tile_grid(spec)
    per = _per_axis(spec.periodic_wrap)
    dev = cnt.device
    pid = torch.repeat_interleave(torch.arange(cnt.shape[0], dtype=torch.int32, device=dev), cnt.prod(dim=1),
                                  output_size=total)
    rank = torch.arange(total, dtype=torch.int32, device=dev) - first[pid]  # the entry within its particle's box
    key = torch.zeros(total, dtype=torch.int32, device=dev)
    stride = 1
    for a, (nt, p) in enumerate(((ntx, per[0]), (nty, per[1]), (ntz, per[2]))):
        c = cnt[:, a][pid]
        tile = t_lo[:, a][pid] + torch.remainder(rank, c)
        rank.div_(c, rounding_mode="floor")
        del c
        key += (torch.remainder(tile, nt) if p else tile) * stride
        del tile
        stride *= nt
    del rank
    sorted_key, perm = torch.sort(key, stable=True)
    del key
    lists = pid[perm]
    del pid, perm
    bounds = torch.arange(ntx * nty * ntz + 1, dtype=torch.int32, device=dev)
    return torch.searchsorted(sorted_key, bounds), lists


def tile_lists(u: Tensor, v: Tensor, w: Tensor, h: Tensor, spec: GridSpec, *, kernel: str):
    """Yield the particles' tile lists in batches whose binning scratch
    stays near :data:`SCRATCH_BYTES`: per batch (first particle, end particle,
    ``starts`` (n_tiles + 1,) int64, ``lists`` int32 indices within the
    batch). Reads one number back (the lists' total), and the batches'
    bounds where there is more than one."""
    t_lo, cnt = (a.to(torch.int32) for a in _particle_tiles(u, v, w, h, spec, kernel=kernel))
    per_particle = cnt.prod(dim=1, dtype=torch.int64)
    ends = torch.cumsum(per_particle, 0)
    n = int(per_particle.shape[0])
    total = int(ends[-1]) if n else 0  # the one host read
    cap = max(1, SCRATCH_BYTES // _ENTRY_BYTES)
    n_batches = -(-total // cap)
    if n_batches <= 1:
        bounds = [(0, n, total)]
    else:
        # batch b ends at the last particle whose entries end by (b + 1) cap;
        # a batch then holds at most cap entries and one particle's more
        cut = torch.searchsorted(ends, torch.arange(1, n_batches, device=ends.device) * cap, right=True)
        cut = torch.cat([cut, torch.tensor([n], device=ends.device)])
        at = torch.cat([torch.zeros(1, dtype=ends.dtype, device=ends.device), ends])[cut]
        cuts, upto = cut.tolist(), at.tolist()
        bounds, p0, e0 = [], 0, 0
        for p1, e1 in zip(cuts, upto):
            if p1 > p0:
                bounds.append((p0, p1, e1 - e0))
            p0, e0 = p1, e1
    first = ends - per_particle
    for p0, p1, entries in bounds:
        if entries == 0:
            continue
        starts, lists = _batch_lists(t_lo[p0:p1], cnt[p0:p1], (first[p0:p1] - first[p0]).to(torch.int32), entries,
                                     spec)
        yield p0, p1, starts, lists


def deposit_3d_wide_plain(u: Tensor, v: Tensor, w: Tensor, h: Tensor, values: Tensor, spec: GridSpec, *,
                          kernel: str, out: Tensor) -> Tensor:
    """The plain route: world coordinates from the global voxel coordinates,
    then the plain torch stencil engine (``deposit_3d``: its K = 32 stencil
    and dense pass) on the same device, added into ``out`` (F, nz, ny,
    nx)."""
    x0, _, y0, _, z0, _ = spec.extent
    dz, dy, dx = spec.voxel_size
    pos = torch.stack([u * dx + x0, v * dy + y0, w * dz + z0], dim=1)
    cube = deposit_3d(pos, h, values.T, spec, kernel=kernel, device=u.device)
    out += cube.permute(3, 0, 1, 2)
    return out


def _flat_walk(lens: list, k_los: list, z0: int) -> tuple[list, int]:
    """One warp's flattened walk over its columns' chords, as the kernel
    finds each index's column: ``lens`` and ``k_los`` (32 each) the lanes'
    chord lengths and first planes. Returns the (lane, tile plane) of every
    index 0..T-1 in order, and the steps (T / 32, rounded up)."""
    incl = list(itertools.accumulate(lens))
    total = incl[-1]
    firsts = [i - n for i, n in zip(incl, lens)]
    # the walking columns in lane order: first plane less first index, lane
    table = [(k - z0 - f, lane) for lane, (n, k, f) in enumerate(zip(lens, k_los, firsts)) if n > 0]
    heads = [(f >> 5, 1 << (f & 31)) if n > 0 else (-1, 0) for n, f in zip(lens, firsts)]
    n_steps = (total + 31) >> 5
    visits, before = [], 0
    for s in range(n_steps):
        word = 0
        for step, bit in heads:
            word |= bit if step == s else 0
        for lane in range(32):
            idx = 32 * s + lane
            if idx < total:
                kz, col = table[before + bin(word & ((2 << lane) - 1)).count("1") - 1]
                visits.append((col, idx + kz))
        before += bin(word).count("1")
    return visits, n_steps


def walk_plain(u: Tensor, v: Tensor, w: Tensor, h: Tensor, spec: GridSpec, tile: int, *, kernel: str) -> dict:
    """The kernel's walk over output tile ``tile`` (x fastest, then y, z) of
    the particles' lists, in plain float32 torch, step for step: each
    warp's patch test, each lane's column chord inside the tile (the one
    image that can meet the tile, the float clamps, the slack), the
    flattened index's column and plane, or, where another image could meet
    the tile too, each lane's own column walk. Returns ``voxels`` (n, 3)
    int64 (x, y, z) of every voxel visited, ``entry`` (n,) its particle,
    ``inside`` (n,) bool the exact test q^2 < lim^2 there as the kernel
    takes it, and ``lanes`` and ``pairs``, what the kernel's counters take
    for the tile (32 x the steps; the voxels inside)."""
    f32 = torch.float32
    nz, ny, nx = spec.shape
    per_x, per_y, per_z = _per_axis(spec.periodic_wrap)
    dz, dy, dx = spec.voxel_size
    lim = torch.tensor(get_kernel(kernel).support_factor, dtype=f32)
    lim2, off, slack = lim * lim, torch.tensor(spec.sample_offset, dtype=f32), torch.tensor(SLACK, dtype=f32)
    ntx, nty, _ = tile_grid(spec)
    tz, rem = divmod(tile, ntx * nty)
    ty, tx = divmod(rem, ntx)
    entry = torch.cat([torch.zeros(0, dtype=torch.long)] + [
        lists[starts[tile]:starts[tile + 1]].long() + p0 for p0, _, starts, lists in tile_lists(u, v, w, h, spec,
                                                                                                   kernel=kernel)])
    # (entry, warp, lane): the lane's column of its warp's patch
    wid, lane = torch.arange(8)[:, None], torch.arange(32)[None, :]
    px0, py0 = tx * TILE + (wid % (TILE // PATCH[0])) * PATCH[0], ty * TILE + (wid // (TILE // PATCH[0])) * PATCH[1]
    x, y, z0 = px0 + lane % PATCH[0], py0 + lane // PATCH[0], tz * TILE
    mine = (x < nx) & (y < ny)
    nzt = min(TILE, nz - z0)
    L = [torch.tensor(float(n), dtype=f32) for n in (nx, ny, nz)]

    def image(d, a):  # the minimum image on a periodic axis, as the kernel takes it
        return d - L[a] * torch.round(d * (1.0 / L[a]))

    au, av, aw = (c[entry][:, None, None] for c in (u, v, w))
    inv_h = 1.0 / h[entry][:, None, None]
    sx, sy, sz = (torch.tensor(d, dtype=f32) * inv_h for d in (dx, dy, dz))
    # a. the patch test
    ex, ey = (c.to(f32) + (PATCH[a] - 1) * 0.5 + off - p
              for a, (c, p) in enumerate(((px0, au), (py0, av))))
    ex, ey = (image(d, a) if p else d for a, (d, p) in enumerate(((ex, per_x), (ey, per_y))))
    ex = torch.clamp(ex.abs() - ((PATCH[0] - 1) * 0.5 + slack), min=0.0) * sx
    ey = torch.clamp(ey.abs() - ((PATCH[1] - 1) * 0.5 + slack), min=0.0) * sy
    meets = (ex * ex + ey * ey < lim2)[..., 0]
    # b. each lane's chord
    cx, cy = x.to(f32) + off - au, y.to(f32) + off - av
    cx, cy = image(cx, 0) if per_x else cx, image(cy, 1) if per_y else cy
    dxn, dyn = cx * sx, cy * sy
    dxy2 = dxn * dxn + dyn * dyn
    inn = mine & (dxy2 < lim2)
    half = torch.where(inn, torch.sqrt(torch.clamp(lim2 - dxy2, min=0.0)) / sz + slack, 0.0)
    zc = aw - off
    several = (2.0 * (lim / sz + slack) + TILE >= L[2])[:, 0, 0] & per_z
    zmid = torch.tensor(float(z0), dtype=f32) + 0.5 * (nzt - 1)
    shift = (torch.round((zmid - zc) * (1.0 / L[2])).long() * nz if per_z else torch.zeros_like(zc, dtype=torch.long))

    def chord(c, half):  # (first plane, length) of the chord, cut to the tile
        k_lo = torch.ceil(torch.clamp(c - half, float(z0), float(z0 + TILE))).long()
        return k_lo, torch.floor(torch.clamp(c + half, float(z0 - 1), float(z0 + nzt - 1))).long() - k_lo + 1

    k_lo, lens = chord(zc + shift.to(f32), half)
    lens = torch.where(inn, lens.clamp(min=0), 0)
    # c. the walks: (entry, warp, lane, plane, how dz is taken: ALONG the
    # flattened chord from its first voxel, from the image at SHIFT, or at
    # the NEAREST image voxel by voxel; the shift)
    ALONG, SHIFT, NEAREST = range(3)
    visits, lanes = [], 0
    for e, wi in meets.nonzero().tolist():
        if not several[e]:
            done, n_steps = _flat_walk(lens[e, wi].tolist(), k_lo[e, wi].tolist(), z0)
            visits += [(e, wi, col, z0 + k, ALONG, 0) for col, k in done]
            lanes += 32 * n_steps
            continue
        steps = [0] * 32
        for col in inn[e, wi].nonzero()[:, 0].tolist():
            if 2.0 * half[e, wi, col] >= L[2]:  # the chord covers the axis
                visits += [(e, wi, col, z0 + k, NEAREST, 0) for k in range(nzt)]
                steps[col] = nzt
                continue
            for im in (-1, 0, 1):
                lo, n = (int(a) for a in chord(zc[e, 0, 0] + im * L[2], half[e, wi, col]))
                visits += [(e, wi, col, k, SHIFT, im * nz) for k in range(lo, lo + max(n, 0))]
                steps[col] += max(n, 0)
        lanes += 32 * max(steps)
    if not visits:
        empty = torch.zeros(0, dtype=torch.long)
        return {"voxels": empty.reshape(0, 3), "entry": empty, "inside": empty.bool(), "lanes": lanes, "pairs": 0}
    e, wi, col, k, how, sh = (torch.tensor(c) for c in zip(*visits))
    d = (k - sh).to(f32) - zc[e, 0, 0]
    dzn = torch.where(how == NEAREST, image(d, 2), d) * sz[e, 0, 0]
    first = k_lo[e, wi, col]
    dz_lo = ((first - shift[e, 0, 0]).to(f32) - zc[e, 0, 0]) * sz[e, 0, 0]
    dzn = torch.where(how == ALONG, (k - first).to(f32) * sz[e, 0, 0] + dz_lo, dzn)
    q2 = dxy2[e, wi, col] + dzn * dzn
    inside = q2 < lim2
    voxels = torch.stack([x.expand(8, 32)[wi, col], y.expand(8, 32)[wi, col], k], dim=1)
    return {"voxels": voxels, "entry": entry[e], "inside": inside, "lanes": lanes, "pairs": int(inside.sum())}


def _check_inputs(u, v, w, h, values, out, spec: GridSpec) -> None:
    n = u.shape[0]
    for name, a in (("u", u), ("v", v), ("w", w), ("h", h)):
        if a.dtype != torch.float32 or a.ndim != 1 or a.shape[0] != n or a.device != u.device:
            raise ValueError(f"{name} must be a 1-D float32 tensor of {n} entries on {u.device}")
    if values.dtype != torch.float32 or values.ndim != 2 or values.shape[1] != n or values.device != u.device:
        raise ValueError(f"values must be a (F, {n}) float32 tensor on {u.device}")
    if (out.dtype != torch.float32 or out.shape != (values.shape[0], *spec.shape) or not out.is_contiguous()
            or out.device != u.device):
        raise ValueError(f"out must be a contiguous ({values.shape[0]}, {spec.shape}) float32 tensor on {u.device}")
    if n >= 2**31:
        raise ValueError("the oversize route indexes particles with int32")
    if u.device.type == "cuda":
        if not all(a.is_contiguous() for a in (u, v, w, h)) or values.stride(1) != 1:
            raise ValueError("the oversize-route kernel takes contiguous coordinates and values of unit column stride")
        if not 1 <= values.shape[0] <= 4:
            raise ValueError(f"the oversize-route kernel takes 1..4 fields, got {values.shape[0]}")


def _deposit(u, v, w, h, values, starts, lists, spec: GridSpec, *, kernel: str, out: Tensor,
             stats: Tensor | None = None) -> None:
    """One launch of the deposit kernel over a batch's lists; ``stats`` (2,)
    int64 on the device, where given, takes the walks' lane steps and
    voxels added."""
    nz, ny, nx = spec.shape
    per = _per_axis(spec.periodic_wrap)
    dz, dy, dx = spec.voxel_size
    kspec = get_kernel(kernel)
    # the tiles, longest list first: the longest start early instead of trailing the launch
    order = torch.argsort(starts[1:] - starts[:-1], descending=True, stable=True).to(torch.int32)
    lib, _ = _build.load("deposit3d_wide")
    code = lib.wide3d_deposit_launch(
        u.data_ptr(), v.data_ptr(), w.data_ptr(), h.data_ptr(), values.data_ptr(), values.stride(0),
        values.shape[0], starts.data_ptr(), lists.data_ptr(), order.data_ptr(), nx, ny, nz,
        int(per[0]), int(per[1]), int(per[2]), float(spec.sample_offset), float(dx), float(dy), float(dz),
        kspec.kernel_id, float(kspec.norm_3d), float(kspec.support_factor), out.data_ptr(),
        None if stats is None else stats.data_ptr(), torch.cuda.current_stream(u.device).cuda_stream,
    )
    _build.check(lib, code, "deposit3d_wide")
    deposit_3d_wide.launches += 1


def deposit_3d_wide(u: Tensor, v: Tensor, w: Tensor, h: Tensor, values: Tensor, spec: GridSpec, *, kernel: str,
                    out: Tensor) -> Tensor:
    """Add the oversize particles (``u, v, w`` (n,) global f32 voxel
    coordinates, ``h`` (n,), ``values`` (F, n) with unit column stride)
    into ``out`` (F, nz, ny, nx) and return it. On a CUDA tensor: per
    batch of :func:`tile_lists`, one launch of ``csrc/deposit3d_wide.cu``
    (built at first use; a failed build or launch raises), counting
    ``launches`` and ``tile_pairs`` (the lists' entries) on the innermost
    open span, and, while a profiler runs, ``walk_lanes`` and
    ``walk_pairs`` (the kernel's lane steps and voxels added, device
    tensors read when the span is). On a CPU tensor:
    :func:`deposit_3d_wide_plain`."""
    if u.device.type == "cpu":
        return deposit_3d_wide_plain(u, v, w, h, values, spec, kernel=kernel, out=out)
    if u.device.type != "cuda":
        raise ValueError(f"no oversize-route kernel for device {u.device}")
    _check_inputs(u, v, w, h, values, out, spec)
    launches, entries = deposit_3d_wide.launches, 0
    stats = torch.zeros(2, dtype=torch.int64, device=u.device) if recording() else None
    with torch.cuda.device(u.device):
        for p0, p1, starts, lists in tile_lists(u, v, w, h, spec, kernel=kernel):
            _deposit(u[p0:p1], v[p0:p1], w[p0:p1], h[p0:p1], values[:, p0:p1], starts, lists, spec, kernel=kernel,
                     out=out, stats=stats)
            entries += int(lists.shape[0])
    walk = {} if stats is None else {"walk_lanes": stats[0], "walk_pairs": stats[1]}
    count(launches=deposit_3d_wide.launches - launches, tile_pairs=entries, **walk)
    return out


#: kernel launches made by the oversize route in this process (CUDA only)
deposit_3d_wide.launches = 0
