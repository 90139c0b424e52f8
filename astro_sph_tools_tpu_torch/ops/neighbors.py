"""Nearest-neighbour queries on a torch device, with a host KDTree dispatch.

Counterpart: ``astro_sph_tools_tpu/ops/neighbors.py``. The reference's
neighbour workloads are (a) nearest-halo searches with scipy
``KDTree(boxsize=...)`` thread fan-out (`_scripts/find_nearest_haloes.py:212-215`)
and (b) k-NN smoothing lengths for SWIFT dark matter
(`io/SWIFT/_SnapshotSWIFT.py:58-85`). The engines:

- :func:`nearest_points_device` / :func:`knn_distances`: dense distance
  blocks with periodic minimum-image handling, a running ``argmin`` or
  top-k merge over blocks of the points;
- :func:`nearest_points_grid`: the shell-walking grid query for large
  point sets (Chebyshev shells 0-3 over a cell grid, a residual spill pass
  for bucket overflow, a dense sweep for queries still unsettled);
- :func:`knn_distances_grid`: the fine-to-coarse k-NN cascade over
  27-cell stencils, used for SWIFT dark-matter smoothing lengths at scale;
- :func:`nearest_points`: the dispatcher (dense, grid or scipy's KDTree).

Every pair distance is the direct minimum-image difference
``d - round(d / box) * box`` (round half to even, as ``jnp.round``), summed
as ((dx^2 + dy^2) + dz^2) in f32, never the ``|q|^2 + |p|^2 - 2 q.p``
matmul form, whose cancellation would break the exact match with the
KDTree. Queries are processed in batches sized by memory
(``_BLOCK_ELEMENTS`` pair distances a block) and the points in blocks
merged into running results, so a query set of any size meets a point set
of any size. Divisors are f32 tensors on the device: torch multiplies by
the reciprocal when it divides a CUDA tensor by a Python number, which
rounds differently from the CPU. Results come back as NumPy arrays, as the
JAX functions return them; ``device=`` says where the work runs.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

Tensor = torch.Tensor

# pair distances computed at once (one f32 temporary of 256 MiB); the
# batches of queries and blocks of points are sized from it
_BLOCK_ELEMENTS = 1 << 26

# up to this many points nearest_points takes the dense blocks, past it the
# grid: chip_smoke.py phase 22's crossover on an NVIDIA H100 80GB HBM3
# (700 W), 2^22 clustered queries against 1e3-1e5 clustered points, fell at
# 5.59e3 and 5.56e3 points in two runs (the JAX package's 2e4 was the TPU's)
_DENSE_MAX_POINTS = 5_500

_R_CAP = 3  # shells walked by the nearest-point grid; beyond -> dense sweep
_W_SENTINEL = 1e30  # validity channel of empty k-NN bucket slots
_KNN_DENSE_MAX_POINTS = 8192  # the k-NN cascade takes the dense engine up to here


def _points(a, device) -> Tensor:
    """(N, 3) f32 tensor on ``device``."""
    if isinstance(a, Tensor):
        t = a.to(device=device, dtype=torch.float32)
    else:
        t = torch.as_tensor(np.asarray(a, np.float32), device=device)
    return t.reshape(-1, 3)


def _f32(value: float, device) -> Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _rows(width: int) -> int:
    """Queries a batch when each query meets ``width`` candidates."""
    return max(1, _BLOCK_ELEMENTS // max(1, width))


def _min_image_(d: Tensor, box: Optional[Tensor]) -> Tensor:
    """``d - round(d / box) * box`` in place (nothing for an open box)."""
    if box is not None:
        d.sub_(torch.round(d / box).mul_(box))
    return d


def _sq_dist(q: Tensor, coord, box: Optional[Tensor]) -> Tensor:
    """Squared minimum-image distances, ((dx^2 + dy^2) + dz^2): ``q`` (B, 3)
    against ``coord(a)``, the a-th coordinate of the candidates, shaped (B,
    ...) or broadcastable to it."""
    d2 = None
    for a in range(3):
        c = coord(a)
        qa = q[:, a].reshape((-1,) + (1,) * (c.dim() - 1))
        d = _min_image_(qa - c, box)
        d.mul_(d)
        d2 = d if d2 is None else d2.add_(d)
    return d2


def _merge_nearest(q: Tensor, pT: Tensor, box, best_d2: Tensor, best_i: Tensor,
                   ids: Optional[Tensor] = None) -> None:
    """Merge the nearest of the points ``pT`` (3, M) into each query's
    running (``best_d2``, ``best_i``), in place: blocks of the points in
    index order, the first minimum within a block, a strictly smaller
    distance to replace the carried one (so ties keep the earliest index, as
    one ``argmin`` over all points would). ``ids`` maps column j to the
    index reported (default j)."""
    n, m = q.shape[0], pT.shape[1]
    pb = min(m, _BLOCK_ELEMENTS)
    qb = _rows(pb)
    for s in range(0, n, qb):
        e = min(n, s + qb)
        bd, bi = best_d2[s:e], best_i[s:e]
        for ps in range(0, m, pb):
            blk = pT[:, ps:ps + pb]
            d2 = _sq_dist(q[s:e], lambda a: blk[a][None, :], box)
            v, j = torch.min(d2, dim=1)
            j = j + ps
            if ids is not None:
                j = ids[j]
            better = v < bd
            bd.copy_(torch.where(better, v, bd))
            bi.copy_(torch.where(better, j, bi))


def _merge_knn(q: Tensor, pT: Tensor, k: int, box, best: Tensor) -> Tensor:
    """The k smallest squared distances (ascending) of each query's running
    list ``best`` (n, k) and the points ``pT`` (3, M), over blocks of the
    points; returns the new (n, k) lists."""
    n, m = q.shape[0], pT.shape[1]
    pb = min(m, _BLOCK_ELEMENTS)
    qb = _rows(pb + k)
    out = torch.empty_like(best)
    for s in range(0, n, qb):
        e = min(n, s + qb)
        cur = best[s:e]
        for ps in range(0, m, pb):
            blk = pT[:, ps:ps + pb]
            d2 = _sq_dist(q[s:e], lambda a: blk[a][None, :], box)
            if d2.shape[1] > k:
                d2 = torch.topk(d2, k, dim=1, largest=False, sorted=False).values
            cur = torch.topk(torch.cat([cur, d2], dim=1), k, dim=1, largest=False, sorted=True).values
        out[s:e] = cur
    return out


def _box_tensor(periodic_box, device) -> Optional[Tensor]:
    return None if periodic_box is None else _f32(float(periodic_box), device)


def nearest_points_device(
    queries, points, *, periodic_box: Optional[float] = None, chunk: int = 1024, device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """(index, distance) of the nearest point for every query, by dense
    blocks on ``device``: int32 indexes and f32 distances, as the JAX
    function returns. ``chunk`` is accepted for the JAX signature; batches
    are sized by memory."""
    q, p = _points(queries, device), _points(points, device)
    if p.shape[0] == 0:
        raise ValueError("no points to query against")
    best_d2 = torch.full((q.shape[0],), float("inf"), dtype=torch.float32, device=q.device)
    best_i = torch.full((q.shape[0],), -1, dtype=torch.int64, device=q.device)
    _merge_nearest(q, p.T.contiguous(), _box_tensor(periodic_box, q.device), best_d2, best_i)
    return best_i.to(torch.int32).cpu().numpy(), torch.sqrt(best_d2).cpu().numpy()


def knn_distances(
    queries, points, k: int, *, periodic_box: Optional[float] = None, chunk: int = 512, device="cuda",
) -> np.ndarray:
    """Distances to the k nearest points (ascending), by dense blocks on
    ``device``; (n, k) f32.

    The device analogue of the SWIFT DM smoothing-length derivation
    (32-nearest-neighbour distance, `_SnapshotSWIFT.py:58-85`). ``chunk`` is
    accepted for the JAX signature; batches are sized by memory.
    """
    q, p = _points(queries, device), _points(points, device)
    if k > p.shape[0]:
        raise ValueError(f"k={k} exceeds the number of points ({p.shape[0]})")
    return torch.sqrt(_knn_dense_d2(q, p, k, _box_tensor(periodic_box, q.device))).cpu().numpy()


def _knn_dense_d2(q: Tensor, p: Tensor, k: int, box) -> Tensor:
    best = torch.full((q.shape[0], k), float("inf"), dtype=torch.float32, device=q.device)
    return _merge_knn(q, p.T.contiguous(), k, box, best)


def _pick_method(n_points: int, prefer_device: Optional[bool], method: Optional[str]) -> str:
    if method is None:
        if prefer_device is False:
            return "kdtree"
        return "dense" if n_points <= _DENSE_MAX_POINTS else "grid"
    if method not in ("dense", "grid", "kdtree"):
        raise ValueError(f"Unknown method {method!r} (dense | grid | kdtree)")
    return method


def nearest_points(
    queries, points, *, periodic_box: Optional[float] = None,
    prefer_device: Optional[bool] = None, method: Optional[str] = None, device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Nearest-point query dispatching between the device engines and scipy.

    Matches the reference pipeline's outputs (index into ``points`` and the
    periodic distance). Device paths: dense blocks for small point sets
    (up to ``_DENSE_MAX_POINTS``), the shell-walking grid query
    (:func:`nearest_points_grid`) for large ones; scipy's KDTree stays
    available through ``method="kdtree"`` (or ``prefer_device=False``) as
    the host oracle.
    """
    method = _pick_method(len(points), prefer_device, method)
    if method == "dense":
        return nearest_points_device(queries, points, periodic_box=periodic_box, device=device)
    if method == "grid":
        return nearest_points_grid(queries, points, periodic_box=periodic_box, device=device)
    from scipy.spatial import KDTree

    points = _host(points)
    queries = _host(queries)
    if periodic_box is not None:
        tree = KDTree(np.mod(points, periodic_box), boxsize=periodic_box)
        dist, idx = tree.query(np.mod(queries, periodic_box), workers=-1)
    else:
        tree = KDTree(points)
        dist, idx = tree.query(queries, workers=-1)
    return idx.astype(np.int64), dist


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, Tensor) else np.asarray(a)


# ---------------------------------------------------------------------------
# Cell grids shared by the shell walk and the k-NN cascade
# ---------------------------------------------------------------------------


def _grid_frame(q: Tensor, p: Tensor, periodic_box):
    """(queries, points, origin (3,) f32, span): wrapped into [0, box) for a
    periodic box; else the joint bounding box padded by 1e-4 (a fixed pad,
    as in the JAX package: below an ulp of large coordinates, where the
    clip of the cell index keeps the extreme points in the edge cells)."""
    if periodic_box is not None:
        span = float(periodic_box)
        box = _f32(span, p.device)
        return torch.remainder(q, box), torch.remainder(p, box), torch.zeros(3, device=p.device), span
    lo = torch.minimum(p.min(0).values, q.min(0).values) - 1e-4
    hi = torch.maximum(p.max(0).values, q.max(0).values) + 1e-4
    return q, p, lo, float((hi - lo).max())


def _cell_index(x: Tensor, origin: Tensor, cell: Tensor, g: int, periodic: bool) -> Tensor:
    """(N, 3) int64 cell of each position: ``floor((x - origin) / cell)``
    in f32, wrapped (periodic) or clipped onto the grid."""
    ci = torch.floor((x - origin) / cell).to(torch.int64)
    return torch.remainder(ci, g) if periodic else torch.clamp(ci, 0, g - 1)


def _cell_flat(x: Tensor, origin: Tensor, cell: Tensor, g: int) -> Tensor:
    """Row-major cell id ((z g + y) g + x) of each position, clipped."""
    ci = torch.clamp(torch.floor((x - origin) / cell).to(torch.int64), 0, g - 1)
    return (ci[:, 2] * g + ci[:, 1]) * g + ci[:, 0]


def _sort_into_cells(pts: Tensor, origin: Tensor, cell: Tensor, g: int):
    """(cell-sorted flat ids, permutation, counts per cell, rank of each
    sorted point within its cell): one stable sort on the device."""
    flat = _cell_flat(pts, origin, cell, g)
    flat_sorted, order = torch.sort(flat, stable=True)
    counts = torch.bincount(flat, minlength=g**3)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(pts.shape[0], device=pts.device) - start[flat_sorted]
    return flat_sorted, order, counts, rank


def _percentile(counts: Tensor, q: float) -> float:
    """NumPy's percentile of the occupied cells' counts (on the host, so
    the grid sizing equals the JAX package's)."""
    return float(np.percentile(counts[counts > 0].cpu().numpy(), q))


# ---------------------------------------------------------------------------
# Shell-walking nearest-point grid
# ---------------------------------------------------------------------------


def _shell_offsets(r: int) -> np.ndarray:
    """Cell offsets at Chebyshev radius exactly r, shape (n, 3)."""
    rng = np.arange(-r, r + 1)
    g = np.stack(np.meshgrid(rng, rng, rng, indexing="ij"), axis=-1).reshape(-1, 3)
    cheb = np.abs(g).max(axis=1)
    return g[cheb == r].astype(np.int32)


def _build_cell_grid(q: Tensor, p: Tensor, periodic_box, cap: Optional[int],
                     points_per_cell: float = 8.0) -> dict:
    """The nearest-point grid, built on the device: g^3 cells of ~8 points,
    buckets of ``cap`` point indexes a cell (``cap=None`` sizes it from the
    occupancy tail: p99, a power of two in [8, 128]) filled by one stable
    sort and each point's rank within its cell, the overflow in
    ``residual``. Empty slots hold the index m, a zero point masked to
    inf wherever it is read."""
    qs, pts, origin, span = _grid_frame(q, p, periodic_box)
    m = pts.shape[0]
    g = int(np.clip(round((m / points_per_cell) ** (1 / 3)), 1, 128))
    cell = span / g
    flat_sorted, order, counts, rank = _sort_into_cells(pts, origin, _f32(cell, p.device), g)
    if cap is None:
        tail = int(_percentile(counts, 99.0))
        cap = int(min(128, max(8, 2 ** int(np.ceil(np.log2(max(1, tail)))))))
    keep = rank < cap
    buckets = torch.full((g**3, cap), m, dtype=torch.int32, device=p.device)
    buckets[flat_sorted[keep], rank[keep]] = order[keep].to(torch.int32)
    # column m (an empty slot's index) is a zero point, masked to inf
    pT = torch.cat([pts, pts.new_zeros(1, 3)]).T.contiguous()
    return dict(qs=qs, pT=pT, buckets=buckets, residual=order[~keep], g=g, cap=cap,
                cell=cell, origin=origin, periodic=periodic_box is not None, m=m)


def nearest_points_grid(
    queries,
    points,
    *,
    periodic_box: Optional[float] = None,
    chunk: int = 256,
    cap: Optional[int] = None,
    device="cuda",
    stats: Optional[dict] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Shell-walking nearest-point query over an on-device cell grid.

    The device replacement for the reference's threaded KDTree
    (`_scripts/find_nearest_haloes.py:212-215`, SURVEY.md §2.8): points are
    bucketed into a cubic cell grid; shell r (Chebyshev radius 0-3) is
    probed only for the queries not settled by shell r - 1 (a query whose
    best distance is within (r - 1) cells can gain nothing further out);
    queries whose probes met a full bucket merge its overflow in a residual
    pass; queries still unsettled after shell 3 take a dense sweep over all
    points. The same results as the JAX walk: the same distances, and the
    same index except on exact ties (the first minimum wins in both).
    ``chunk`` is accepted for the JAX signature. Returns int64 indexes and
    f32 distances. ``stats``, when given, receives the grid's size and the
    queries each branch took.
    """
    q, p = _points(queries, device), _points(points, device)
    if p.shape[0] == 0:
        raise ValueError("no points to query against")
    grid = _build_cell_grid(q, p, periodic_box, cap)
    g, cap, m, periodic = grid["g"], grid["cap"], grid["m"], grid["periodic"]
    qs, pT, buckets, dev = grid["qs"], grid["pT"], grid["buckets"], q.device
    cell_t = _f32(grid["cell"], dev)
    box = _f32(g * grid["cell"], dev) if periodic else None
    n = qs.shape[0]
    ci = _cell_index(qs, grid["origin"], cell_t, g, periodic)
    best_d2 = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((n,), -1, dtype=torch.int64, device=dev)
    hit_full = torch.zeros(n, dtype=torch.bool, device=dev)
    active = torch.arange(n, device=dev)
    shell_queries = []
    for r in range(_R_CAP + 1):
        if r:
            # after shell r - 1 every unexplored point is >= (r - 1) cells away
            settled = best_d2[active] <= _f32(((r - 1) * grid["cell"]) ** 2, dev)
            active = active[~settled]
            if active.numel() == 0:
                break
        shell_queries.append(int(active.numel()))
        offs = torch.as_tensor(_shell_offsets(r), dtype=torch.int64, device=dev)
        step = _rows(offs.shape[0] * cap)
        for s in range(0, active.numel(), step):
            a = active[s:s + step]
            cc = ci[a][:, None, :] + offs[None]
            if periodic:
                cc = torch.remainder(cc, g)
            else:
                in_grid = ((cc >= 0) & (cc < g)).all(dim=-1)
                cc = torch.clamp(cc, 0, g - 1)
            cand = buckets[(cc[..., 2] * g + cc[..., 1]) * g + cc[..., 0]].to(torch.int64)  # (B, O, cap)
            if not periodic:
                cand = torch.where(in_grid[..., None], cand, m)
            # a probed bucket whose last slot is real hit its cap: its
            # overflow lives in the residual list
            hit_full[a] |= (cand[..., -1] != m).any(dim=1)
            d2 = _sq_dist(qs[a], lambda ax: pT[ax][cand], box)
            d2 = torch.where(cand == m, float("inf"), d2).reshape(a.shape[0], -1)
            v, j = torch.min(d2, dim=1)
            better = v < best_d2[a]
            best_d2[a] = torch.where(better, v, best_d2[a])
            best_i[a] = torch.where(better, cand.reshape(a.shape[0], -1).gather(1, j[:, None])[:, 0], best_i[a])
    # residual spill: only queries that probed a full bucket (the overflow of
    # unprobed cells lies beyond the shell-distance bound)
    residual = grid["residual"]
    spill = torch.nonzero(hit_full).squeeze(1) if residual.numel() else hit_full.new_zeros(0, dtype=torch.int64)
    if spill.numel():
        bd, bi = best_d2[spill], best_i[spill]
        _merge_nearest(qs[spill], pT[:, residual], box, bd, bi, ids=residual)
        best_d2[spill], best_i[spill] = bd, bi
    # dense sweep for queries still unsettled after the last shell (voids)
    sweep = torch.nonzero(~(best_d2 <= _f32((_R_CAP * grid["cell"]) ** 2, dev))).squeeze(1)
    if sweep.numel():
        bd, bi = best_d2[sweep], best_i[sweep]
        _merge_nearest(qs[sweep], pT[:, :m], box, bd, bi)
        best_d2[sweep], best_i[sweep] = bd, bi
    if stats is not None:
        stats.update(g=g, cap=cap, residual=int(residual.numel()), shell_queries=shell_queries,
                     spilled=int(spill.numel()), dense_sweep=int(sweep.numel()))
    return best_i.cpu().numpy(), torch.sqrt(best_d2).cpu().numpy()


# ---------------------------------------------------------------------------
# Fine-to-coarse k-NN cascade
# ---------------------------------------------------------------------------


def _bucketize_coords(pts: Tensor, g: int, cap: int, cell: Tensor, origin: Tensor, periodic: bool, k: int):
    """One stage's coordinate buckets, built on the device: (bucket (G_pad,
    4, width) f32 of [x, y, z, w] rows, w = 0 for a point and 1e30 for an
    empty slot; full_cells (G_pad,) bool, a cell holding >= cap points;
    residual point indexes). The x axis is padded by a column each side
    (the far column's copy on a periodic grid, empty otherwise), so a
    3-cell x run of the stencil is 3 consecutive rows, and 3 empty sentinel
    rows at the end take the stencil's off-grid rows. ``width`` is the
    fullest bucket (at most ``cap``, and enough slots for k): the slots past
    it are empty in every cell, and an empty slot never ranks before a
    point."""
    flat_sorted, order, counts, rank = _sort_into_cells(pts, origin, cell, g)
    width = max(min(cap, int(counts.max())), -(-k // 27))
    keep = rank < cap
    nx = g + 2
    n_rows = g * g * nx
    bucket = torch.zeros((n_rows + 3, 4, width), dtype=torch.float32, device=pts.device)
    bucket[:, 3, :] = _W_SENTINEL
    fs = flat_sorted[keep]
    row = (fs // g) * nx + fs % g + 1
    slot = rank[keep]
    src = pts[order[keep]]
    for a in range(3):
        bucket[row, a, slot] = src[:, a]
    bucket[row, 3, slot] = 0.0
    full_cells = torch.zeros(n_rows + 3, dtype=torch.bool, device=pts.device)
    full_cells[:n_rows].view(g * g, nx)[:, 1:g + 1] = (counts >= cap).view(g * g, g)
    if periodic:
        b = bucket[:n_rows].view(g * g, nx, 4, width)
        b[:, 0] = b[:, g]
        b[:, g + 1] = b[:, 1]
        f = full_cells[:n_rows].view(g * g, nx)
        f[:, 0] = f[:, g]
        f[:, g + 1] = f[:, 1]
    return bucket, full_cells, order[~keep], width


def _knn_stage(qa: Tensor, bucket: Tensor, full_cells: Tensor, g: int, cell: Tensor, origin: Tensor,
               periodic: bool, box, k: int):
    """One cascade stage: the k smallest squared distances (ascending) of
    each query over the 27 cells (r <= 1) around its own cell, and whether
    any of those cells is full (its overflow is in the residual list)."""
    dev = qa.device
    width = bucket.shape[2]
    nx = g + 2
    dy, dz = torch.meshgrid(torch.arange(-1, 2, device=dev), torch.arange(-1, 2, device=dev), indexing="ij")
    dy, dz = dy.reshape(-1), dz.reshape(-1)
    run = torch.arange(3, device=dev)
    n = qa.shape[0]
    out_d2 = torch.empty((n, k), dtype=torch.float32, device=dev)
    out_full = torch.empty(n, dtype=torch.bool, device=dev)
    step = _rows(27 * 4 * width)
    for s in range(0, n, step):
        q = qa[s:s + step]
        b = q.shape[0]
        ci = _cell_index(q, origin, cell, g, periodic)
        cy = ci[:, 1, None] + dy
        cz = ci[:, 2, None] + dz
        if periodic:
            cy, cz = torch.remainder(cy, g), torch.remainder(cz, g)
        else:
            in_grid = (cy >= 0) & (cy < g) & (cz >= 0) & (cz < g)
            cy, cz = torch.clamp(cy, 0, g - 1), torch.clamp(cz, 0, g - 1)
        # padded-x rows: row (z, y) starts at (z g + y) nx; column cx + 1
        # holds real cell cx, so the dx = -1..1 run starts at column cx
        base = (cz * g + cy) * nx + ci[:, 0, None]
        if not periodic:
            base = torch.where(in_grid, base, g * g * nx)
        rows = (base[..., None] + run).reshape(-1)
        cand = bucket.index_select(0, rows).view(b, 27, 4, width)
        out_full[s:s + b] = full_cells[rows].view(b, 27).any(dim=1)
        d2 = _sq_dist(q, lambda a: cand[:, :, a, :], box).add_(cand[:, :, 3, :])
        out_d2[s:s + b] = torch.topk(d2.view(b, -1), k, dim=1, largest=False, sorted=True).values
    return out_d2, out_full


def _knn_grid(queries, points, k: int, *, periodic_box: Optional[float] = None, cap: int = 64,
              max_stages: int = 4, device="cuda", stats: Optional[dict] = None) -> Tensor:
    """:func:`knn_distances_grid`'s (n, k) f32 distances, left on the device."""
    q, p = _points(queries, device), _points(points, device)
    dev = q.device
    m = p.shape[0]
    if m == 0:
        raise ValueError("no points to query against")
    if k > m:
        raise ValueError(f"k={k} exceeds the number of points ({m})")
    n = q.shape[0]
    if stats is not None:
        stats.update(stages=[], stragglers=0, dense_only=m <= _KNN_DENSE_MAX_POINTS)
    if m <= _KNN_DENSE_MAX_POINTS:
        return torch.sqrt(_knn_dense_d2(q, p, k, _box_tensor(periodic_box, dev)))

    periodic = periodic_box is not None
    qs, pts, origin, span = _grid_frame(q, p, periodic_box)
    spill_box = _f32(span, dev) if periodic else None

    # stage-1 grid: start at ~cap/4 mean occupancy, then refine until the
    # p99 occupancy tail fits the bucket (clusters resolved into many cells)
    g = int(np.clip(round((m / (cap / 4)) ** (1 / 3)), 3, 192))
    for _ in range(3):
        counts = torch.bincount(_cell_flat(pts, origin, _f32(span / g, dev), g), minlength=g**3)
        p99 = _percentile(counts, 99.0)
        if p99 <= cap or g >= 192:
            break
        g = int(np.clip(round(g * (p99 / cap) ** (1 / 3)), g + 1, 192))
    del counts

    out = torch.empty((n, k), dtype=torch.float32, device=dev)
    active = torch.arange(n, device=dev)
    for _ in range(max_stages):
        if g < 3 or active.numel() == 0:  # g < 3: the periodic 27-stencil would
            break  # wrap onto duplicate cells (duplicates corrupt a k-list)
        t0 = time.perf_counter()
        cell = span / g
        cell_t = _f32(cell, dev)
        box = _f32(g * cell, dev) if periodic else None
        bucket, full_cells, residual, width = _bucketize_coords(pts, g, cap, cell_t, origin, periodic, k)
        # cell-sort the active queries: batches become spatially coherent
        _, qord = torch.sort(_cell_flat(qs[active], origin, cell_t, g), stable=True)
        idx = active[qord]
        q_act = qs[idx]
        d2, q_full = _knn_stage(q_act, bucket, full_cells, g, cell_t, origin, periodic, box, k)
        del bucket, full_cells
        n_spill = 0
        if residual.numel():
            # compact spill: only flagged queries meet the bucket overflow
            flag = torch.nonzero(q_full).squeeze(1)
            n_spill = int(flag.numel())
            if n_spill:
                d2[flag] = _merge_knn(q_act[flag], pts[residual].T.contiguous(), k, spill_box, d2[flag])
        kth2 = d2[:, -1]
        settled = kth2 <= _f32(float(np.float32(cell) * np.float32(cell)), dev)
        out[idx[settled]] = torch.sqrt(d2[settled])
        active = idx[~settled]
        # next stage: coarsen to the cell width that would settle ~80% of
        # the remaining queries (their current k-th distances are upper
        # bounds, so settling on the bound implies settling on the truth)
        kth = np.sqrt(kth2[~settled].cpu().numpy())
        if stats is not None:
            _sync(dev)
            n_act = int(idx.numel())
            stats["stages"].append({
                "g": g, "cap": cap, "width": width, "active": n_act, "spilled": n_spill,
                "residual": int(residual.numel()), "settled": n_act - int(active.numel()),
                "settled_share": (n_act - int(active.numel())) / n_act, "seconds": time.perf_counter() - t0,
            })
        del d2, q_full, kth2, settled
        finite = kth[kth < 1e14]
        if finite.size:
            cell_next = float(np.percentile(finite, 80.0))
            g = max(3, min(g - 1, int(span / max(cell_next, 1e-30))))
        else:
            g //= 2

    if active.numel():
        out[active] = torch.sqrt(_knn_dense_d2(qs[active], pts, k, _box_tensor(periodic_box, dev)))
    if stats is not None:
        stats["stragglers"] = int(active.numel())
    return out


def knn_distances_grid(
    queries,
    points,
    k: int,
    *,
    periodic_box: Optional[float] = None,
    chunk: int = 256,
    cap: int = 64,
    max_stages: int = 4,
    device="cuda",
    stats: Optional[dict] = None,
) -> np.ndarray:
    """Distances to the k nearest points (ascending), (n, k) f32, via a
    fine-to-coarse cell-grid cascade on ``device``: the at-scale path for
    SWIFT dark-matter smoothing lengths (`_SnapshotSWIFT.py:58-85`: 32-NN
    distance), where the dense :func:`knn_distances` is O(N M).

    Each stage probes the 27-cell neighbourhood of each active query on its
    grid (buckets of ``cap`` point coordinates a cell with a validity
    channel, padded along x so the 3 x 3 x 3 stencil is 9 runs of 3
    consecutive rows) and keeps its k best. Queries whose own stencil met a
    full bucket merge the overflow in a compact spill pass. A query whose
    k-th best squared distance is within one cell width squared (compared
    in f32) is exact and leaves; the rest continue on a coarser grid sized
    from the 80th percentile of their k-th distances, until ``max_stages``
    or g < 3, and stragglers take a dense sweep. The stage-1 grid is sized
    so the p99 occupancy fits the bucket (g <= 192). Up to 8192 points the
    dense engine answers alone. Exact: matches
    ``scipy.spatial.KDTree.query(k=k)`` distances (to f32). ``chunk`` is
    accepted for the JAX signature; batches are sized by memory. ``stats``,
    when given, receives each stage's grid, bucket cap (and the slots read,
    ``width``), active, spilled and settled queries and seconds, and the
    stragglers.
    """
    return _knn_grid(queries, points, k, periodic_box=periodic_box, cap=cap, max_stages=max_stages,
                     device=device, stats=stats).cpu().numpy()
