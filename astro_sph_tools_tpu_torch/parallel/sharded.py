"""Particle-sharded 2D maps and slab-sharded 3D cubes over a process mesh.

Counterpart: ``astro_sph_tools_tpu/parallel/sharded.py`` (the replacement
for the reference's MPI data parallelism, SURVEY.md §2.8). Every function
takes this rank's shard:

- **2D maps** (:func:`deposit_2d_sharded`): the rank deposits its particles
  into a whole map, then one ``all_reduce`` sums the maps; every rank ends
  with the same map.
- **3D cubes** (:func:`deposit_3d_sharded`): the rank owns a z-slab of the
  cube and deposits its particles into the slab extended by ``K // 2``
  halo planes on each side (x and y wrap locally when periodic, z does not);
  the halo planes then travel to the neighbouring slabs over a ring
  (``ring_shift``) and are added there. On an open grid the edge ranks drop
  the halos that wrapped round the ring.

The JAX package's ``shard_map`` programs, per-shard chunk padding and
capacities maxed over shards exist for static shapes and are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.splines import get_kernel
from ..ops._device import PRECISIONS_3D, as_f32, check_precision, tile_ranges
from ..ops.deposit import MapSpec, _as_tensor, _stencil_level_pass
from ..ops.deposit_tiled import PALLAS_LEVELS, deposit_2d_pallas
from ..ops.grid3d import GridSpec, _stencil_level_pass_3d
from ..ops.grid3d_tiled import (
    PALLAS_3D_LEVELS,
    _geometry_3d,
    _multi_level_assign_3d,
    _voxel_coords,
    deposit_3d_tiles,
)
from ._comm import all_reduce_, ring_shift
from .mesh import Mesh, make_mesh

Tensor = torch.Tensor

__all__ = [
    "deposit_2d_sharded",
    "deposit_3d_sharded",
    "make_mesh",
    "pad_for_mesh",
    "partition_particles_by_slab",
]


def _pallas_level_for_K(K: int):
    """Smallest footprint level whose column window hosts a K footprint."""
    for cfg in PALLAS_LEVELS:
        if cfg.K >= K:
            return cfg
    raise ValueError(f"no pallas level hosts K={K} (max {PALLAS_LEVELS[-1].K})")


def deposit_2d_sharded(
    x,
    y,
    h,
    values,  # (N,) or (N, F)
    spec: MapSpec,
    mesh: Mesh,
    *,
    K: int = 8,
    kernel: str = "cubic_spline",
    chunk: int = 8192,
    axis_name: str = "data",
    engine: str = "pallas",
    precision: str = "bf16x2",
) -> Tensor:
    """Deposit this rank's particles and sum the maps over the mesh: the
    (ny, nx) or (ny, nx, F) map, the same on every rank, on ``mesh.device``.

    ``engine="pallas"`` (name kept from the JAX package) runs one footprint
    level of the sorted engine, the smallest whose window hosts a K-pixel
    footprint (``_pallas_level_for_K``), through ``deposit_2d_pallas`` and
    its CUDA kernel ``csrc/deposit2d.cu``; every footprint must fit that
    level. ``engine="xla"`` runs the plain torch K x K stencil pass. Either
    way one ``all_reduce`` follows. Shards need no padding; the JAX
    package's padding (``pad_for_mesh``: h = 1, values 0) deposits nothing.
    ``precision`` is validated; the sums are f32.
    """
    check_precision(precision)
    get_kernel(kernel)
    if engine not in ("pallas", "xla"):
        raise ValueError(f"Unknown engine {engine!r} (pallas | xla)")
    device = mesh.device
    vals = as_f32(values, device)
    single = vals.ndim == 1
    if single:
        vals = vals[:, None]
    n_fields = vals.shape[1]
    ny, nx = spec.shape
    hs = as_f32(h, device)
    if engine == "pallas":
        cfg = _pallas_level_for_K(K)
        if hs.shape[0]:
            # the single-device engine places f64 coordinates in f64
            image = deposit_2d_pallas(
                x, y, hs, vals.T, spec, kernel=kernel, precision=precision, level=cfg, device=device,
            ).permute(1, 2, 0).contiguous()
        else:
            image = torch.zeros((ny, nx, n_fields), dtype=torch.float32, device=device)
    else:
        xs, ys = _as_tensor(x, device), _as_tensor(y, device)
        xs, ys = (a if a.dtype == torch.float64 else a.float() for a in (xs, ys))
        image = torch.zeros((ny * nx, n_fields), dtype=torch.float32, device=device)
        _stencil_level_pass(
            image, xs, ys, hs, vals, None,
            K=K, spec=spec, kernel_name=kernel, projection="kernel3d", chunk=chunk,
        )
        image = image.reshape(ny, nx, n_fields)
    all_reduce_(image, mesh)
    return image[..., 0] if single else image


def deposit_3d_sharded(
    pos,  # (N, 3): this rank's particles, already wrapped into the box
    h,
    values,  # (N,)
    spec: GridSpec,
    mesh: Mesh,
    *,
    K: int = 4,
    kernel: str = "cubic_spline",
    chunk: int = 2048,
    axis_name: str = "data",
    engine: str = "pallas",
    precision: str = "bf16x2",
) -> Tensor:
    """Slab-sharded 3D voxel deposit with a ring halo exchange: this rank's
    (nz / size, ny, nx) slab of the cube, on ``mesh.device``.

    Rank r owns planes ``[r * slab, (r + 1) * slab)`` and takes the
    particles whose z lies in them (:func:`partition_particles_by_slab`
    orders them so). It deposits into its slab extended by ``halo = K // 2``
    planes a side: ``engine="pallas"`` (name kept from the JAX package)
    through the CUDA kernel ``csrc/deposit3d.cu`` (``deposit_3d_tiles``) at
    the smallest level whose window hosts K, periodic in x and y when the
    grid is, open in z; ``engine="xla"`` through the plain torch K^3 stencil
    pass. Then the top halo goes to the next rank and the bottom one to the
    previous (``ring_shift``), which add them to their slabs; on an open
    grid the first rank drops what came from below and the last what came
    from above (it wrapped round the ring). Raises when ``nz`` does not
    divide over the mesh or a slab is thinner than its halo.
    """
    check_precision(precision, PRECISIONS_3D)
    if engine not in ("pallas", "xla"):
        raise ValueError(f"Unknown engine {engine!r} (pallas | xla)")
    nz, ny, nx = spec.shape
    n_dev, rank = mesh.size, mesh.rank
    if nz % n_dev:
        raise ValueError(f"nz={nz} must divide over {n_dev} devices")
    slab = nz // n_dev
    halo = K // 2
    if slab < halo:
        raise ValueError(f"a slab of {slab} planes is thinner than its halo of {halo} (K={K})")
    x0, x1, y0, y1, z0, z1 = (float(e) for e in spec.extent)
    psz = (z1 - z0) / nz
    ext_nz = slab + 2 * halo
    ext_shape = (ext_nz, ny, nx)
    ext_extent = (x0, x1, y0, y1, 0.0, ext_nz * psz)
    periodic = (spec.periodic_wrap, spec.periodic_wrap, False)
    device = mesh.device

    p = as_f32(pos, device).reshape(-1, 3)
    hs = as_f32(h, device)
    vs = as_f32(values, device).reshape(-1)
    if engine == "pallas":
        cfg = next((c for c in PALLAS_3D_LEVELS if c.K >= K), None)
        if cfg is None:
            raise ValueError(f"no 3D pallas level hosts K={K}")
        ext = torch.zeros((1, *ext_shape), dtype=torch.float32, device=device)
        if hs.shape[0]:
            args, kw = _slab_launch(p, hs, vs, spec, cfg, rank * slab - halo, ext_shape, kernel)
            deposit_3d_tiles(*args, ext, **kw)
        ext = ext[0]
    else:
        # z in the extended slab's frame, whose first plane is rank * slab - halo
        cz = p[:, 2] - (z0 + (rank * slab - halo) * psz)
        flat = torch.zeros((ext_nz * ny * nx, 1), dtype=torch.float32, device=device)
        _stencil_level_pass_3d(
            flat, p[:, 0], p[:, 1], cz, hs, vs[:, None],
            K=K, shape=ext_shape, extent=ext_extent, offset=spec.sample_offset,
            periodic=periodic, kernel_name=kernel, chunk=chunk,
        )
        ext = flat.reshape(ext_shape)

    # my top halo belongs to the next slab, my bottom one to the previous
    from_below = ring_shift(ext[slab + halo:].contiguous(), mesh, 1)
    from_above = ring_shift(ext[:halo].contiguous(), mesh, -1)
    body = ext[halo:halo + slab].clone()
    if spec.periodic_wrap or rank != 0:
        body[:halo] += from_below
    if spec.periodic_wrap or rank != n_dev - 1:
        body[slab - halo:] += from_above
    return body


def _slab_launch(p: Tensor, h: Tensor, values: Tensor, spec: GridSpec, cfg, first_plane: int, ext_shape,
                 kernel: str):
    """The 3D kernel's inputs for an extended slab of ``ext_shape`` whose
    first plane is plane ``first_plane`` of the grid: ``(args, kw)`` of
    ``deposit_3d_tiles(*args, grid, **kw)``, periodic in x and y when the
    grid is, open in z.

    The voxel coordinates are the single-device engine's (``_voxel_coords``,
    bit for bit), z unwrapped: a particle that rounds onto the top face
    lands in the top halo and travels round the ring. z moves into the
    slab's frame in f64, where the shift by whole planes is exact (in f32 it
    rounds once w crosses a power of two: ~1.5e-5 voxel at 512 planes)."""
    nz, ny, nx = spec.shape
    x0, x1, y0, y1, z0, z1 = (float(e) for e in spec.extent)
    geom = _geometry_3d(cfg, ext_shape)
    u, v, _ = _voxel_coords(p, spec)
    w = ((p[:, 2] - z0) / ((z1 - z0) / nz)).double() - first_plane
    _, tile, ul, vl, wl = _multi_level_assign_3d(u, v, w, torch.zeros_like(u), (np.inf,), (geom,))
    tile_sorted, perm = torch.sort(tile, stable=True)
    pstart, pcount = tile_ranges(tile_sorted, geom.n_tiles)
    args = (ul[perm], vl[perm], wl.float()[perm], h[perm], values[perm][None, :].contiguous(), pstart, pcount)
    kw = dict(geom=geom, kernel=kernel, periodic=(spec.periodic_wrap, spec.periodic_wrap, False),
              psx=(x1 - x0) / nx, psy=(y1 - y0) / ny, psz=(z1 - z0) / nz, offset=spec.sample_offset)
    return args, kw


def partition_particles_by_slab(
    pos: np.ndarray, h: np.ndarray, values: np.ndarray, spec: GridSpec, n_dev: int,
    chunk: int = 2048,
):
    """Host-side: order particles by z-slab and pad each slab to the common
    per-device length (multiple of ``chunk``) so slab i occupies block i.

    Returns (pos, h, values); rank i passes block i
    (``[i * per_dev, (i + 1) * per_dev)``) to :func:`deposit_3d_sharded`.
    The same arithmetic as the JAX package's.
    """
    z0, z1 = spec.extent[4], spec.extent[5]
    slab_height = (z1 - z0) / n_dev
    slab_idx = np.clip(((pos[:, 2] - z0) / slab_height).astype(np.int64), 0, n_dev - 1)
    order = np.argsort(slab_idx, kind="stable")
    pos, h, values, slab_idx = pos[order], h[order], values[order], slab_idx[order]
    counts = np.bincount(slab_idx, minlength=n_dev)
    per_dev = int(np.ceil(counts.max() / chunk) * chunk)
    out_pos = np.zeros((n_dev * per_dev, 3), np.float32)
    out_h = np.ones(n_dev * per_dev, np.float32)
    out_v = np.zeros(n_dev * per_dev, np.float32)
    start = 0
    for d in range(n_dev):
        n = counts[d]
        out_pos[d * per_dev : d * per_dev + n] = pos[start : start + n]
        out_h[d * per_dev : d * per_dev + n] = h[start : start + n]
        out_v[d * per_dev : d * per_dev + n] = values[start : start + n]
        start += n
    return out_pos, out_h, out_v


def pad_for_mesh(arrays, n_dev: int, chunk: int, pad_values=None):
    """Pad 1-D/2-D arrays to a multiple of ``n_dev * chunk`` along axis 0."""
    n = arrays[0].shape[0]
    unit = n_dev * chunk
    n_pad = max(unit, ((n + unit - 1) // unit) * unit)
    out = []
    for i, a in enumerate(arrays):
        fill = 0.0 if pad_values is None else pad_values[i]
        pad_width = [(0, n_pad - n)] + [(0, 0)] * (np.ndim(a) - 1)
        out.append(np.pad(np.asarray(a), pad_width, constant_values=fill))
    return out
