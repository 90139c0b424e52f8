"""3D voxel gridding: the SPH deposit on (nz, ny, nx) cubes, in plain torch.

Counterpart: ``astro_sph_tools_tpu/ops/grid3d.py`` (BASELINE config 3:
"512^3 density/velocity cubes with per-particle smoothing lengths and
periodic wrapping"). The same scatter-stencil architecture as
``ops/deposit.py`` with a K^3 voxel stencil and the full 3D kernel at the
true 3D radius: voxel value = sum_i value_i * W(|r_i|, h_i), the SPH density
estimator when value = mass. It holds no hand-written kernel: it is the
oracle of the tiled engine (``ops/grid3d_tiled.py``) and its route for
particles whose footprint exceeds the largest tile level.

Periodic wrapping uses minimum-image distances over a half-open [0, L) box.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..kernels.splines import get_kernel
from .deposit import _DENSE_BLOCK, _as_tensor

Tensor = torch.Tensor

STENCIL_LEVELS_3D: tuple[int, ...] = (2, 4, 8, 16, 32)
_DEF_CHUNK_3D = 4096


@dataclass(frozen=True)
class GridSpec:
    """Static description of the output voxel grid.

    extent = (x0, x1, y0, y1, z0, z1); shape = (nz, ny, nx).
    """

    shape: tuple[int, int, int]
    extent: tuple[float, float, float, float, float, float]
    voxel_origin: str = "center"
    periodic_wrap: bool = False

    @property
    def voxel_size(self) -> tuple[float, float, float]:
        """Voxel edges in (z, y, x) order."""
        nz, ny, nx = self.shape
        x0, x1, y0, y1, z0, z1 = self.extent
        return ((z1 - z0) / nz, (y1 - y0) / ny, (x1 - x0) / nx)

    @property
    def sample_offset(self) -> float:
        if self.voxel_origin == "center":
            return 0.5
        if self.voxel_origin == "corner":
            return 0.0
        raise ValueError(f"voxel_origin must be 'center' or 'corner', got {self.voxel_origin!r}")


def _per_axis(periodic) -> tuple[bool, bool, bool]:
    """``periodic`` as an (x, y, z) tuple (a bool applies to every axis)."""
    if isinstance(periodic, bool):
        return (periodic,) * 3
    per = tuple(bool(p) for p in periodic)
    if len(per) != 3:
        raise ValueError(f"periodic must be a bool or an (x, y, z) tuple, got {periodic!r}")
    return per


def _stencil_level_pass_3d(
    grid_flat: Tensor,  # (nz*ny*nx, F) accumulator, updated in place
    x: Tensor,
    y: Tensor,
    z: Tensor,
    h: Tensor,
    values: Tensor,  # (M, F)
    *,
    K: int,
    shape: tuple[int, int, int],
    extent: tuple[float, ...],
    offset: float,
    periodic,
    kernel_name: str,
    chunk: int,
) -> Tensor:
    """Deposit M particles with a K^3 stencil into the flat grid.

    ``periodic`` is a bool or a per-axis (x, y, z) tuple: the slab-sharded
    deposit wraps x and y locally while z crosses the halo exchange."""
    per_x, per_y, per_z = _per_axis(periodic)
    kernel = get_kernel(kernel_name)
    S = kernel.support_factor
    nz, ny, nx = shape
    x0, x1, y0, y1, z0, z1 = extent
    psx = (x1 - x0) / nx
    psy = (y1 - y0) / ny
    psz = (z1 - z0) / nz
    dtype = grid_flat.dtype
    ks = torch.arange(K, dtype=torch.int64, device=grid_flat.device)

    def axis_index(j: Tensor, n_ax: int, per: bool) -> tuple[Tensor, Optional[Tensor]]:
        if per:
            return torch.remainder(j, n_ax), None
        return torch.clamp(j, 0, n_ax - 1), (j >= 0) & (j < n_ax)

    for c0 in range(0, x.shape[0], chunk):
        cx, cy, cz, ch = x[c0:c0 + chunk], y[c0:c0 + chunk], z[c0:c0 + chunk], h[c0:c0 + chunk]
        cvals = values[c0:c0 + chunk]
        u = (cx - x0) / psx
        v = (cy - y0) / psy
        w_ = (cz - z0) / psz
        jx = (torch.floor(u - offset + 0.5).to(torch.int64) - (K // 2))[:, None] + ks[None, :]
        jy = (torch.floor(v - offset + 0.5).to(torch.int64) - (K // 2))[:, None] + ks[None, :]
        jz = (torch.floor(w_ - offset + 0.5).to(torch.int64) - (K // 2))[:, None] + ks[None, :]
        dxp = ((jx.to(dtype) + offset) - u[:, None]) * psx
        dyp = ((jy.to(dtype) + offset) - v[:, None]) * psy
        dzp = ((jz.to(dtype) + offset) - w_[:, None]) * psz
        # (C, Kz, Ky, Kx)
        r2 = (
            dzp[:, :, None, None] ** 2
            + dyp[:, None, :, None] ** 2
            + dxp[:, None, None, :] ** 2
        )
        support = S * ch
        inside = r2 < (support * support)[:, None, None, None]
        weights = kernel.w(torch.sqrt(r2), ch[:, None, None, None])
        weights = torch.where(inside, weights, 0.0).to(dtype)

        fx, in_x = axis_index(jx, nx, per_x)
        fy, in_y = axis_index(jy, ny, per_y)
        fz, in_z = axis_index(jz, nz, per_z)
        # off-grid voxels (open axes) get weight 0 at a clipped index: the
        # add is then a no-op, as the JAX scatter's mode='drop'
        for m, axis in ((in_z, 1), (in_y, 2), (in_x, 3)):
            if m is not None:
                view = [m.shape[0], 1, 1, 1]
                view[axis] = m.shape[1]
                weights = torch.where(m.view(view), weights, 0.0)
        flat = (
            fz[:, :, None, None] * (ny * nx)
            + fy[:, None, :, None] * nx
            + fx[:, None, None, :]
        )
        updates = weights[..., None] * cvals[:, None, None, None, :]
        grid_flat.index_add_(0, flat.reshape(-1), updates.reshape(-1, updates.shape[-1]))
    return grid_flat


def _dense_pass_3d(
    grid_flat: Tensor,  # (nz*ny*nx, F), updated in place
    x: Tensor,
    y: Tensor,
    z: Tensor,
    h: Tensor,
    values: Tensor,  # (M, F)
    *,
    shape: tuple[int, int, int],
    extent: tuple[float, ...],
    offset: float,
    periodic,
    kernel_name: str,
) -> Tensor:
    """Whole-grid deposit for oversize-footprint particles (rare): blocks of
    particles against every voxel, minimum-image distances on periodic axes."""
    per_x, per_y, per_z = _per_axis(periodic)
    kernel = get_kernel(kernel_name)
    S = kernel.support_factor
    nz, ny, nx = shape
    x0, x1, y0, y1, z0, z1 = extent
    dtype = grid_flat.dtype
    dev = grid_flat.device
    Lx, Ly, Lz = x1 - x0, y1 - y0, z1 - z0

    xs = (x0 + (torch.arange(nx, dtype=dtype, device=dev) + offset) * (Lx / nx)).reshape(1, 1, 1, nx)
    ys = (y0 + (torch.arange(ny, dtype=dtype, device=dev) + offset) * (Ly / ny)).reshape(1, 1, ny, 1)
    zs = (z0 + (torch.arange(nz, dtype=dtype, device=dev) + offset) * (Lz / nz)).reshape(1, nz, 1, 1)
    tile = max(1, _DENSE_BLOCK // (nz * ny * nx))

    for c0 in range(0, x.shape[0], tile):
        cx, cy, cz, ch = x[c0:c0 + tile], y[c0:c0 + tile], z[c0:c0 + tile], h[c0:c0 + tile]
        cvals = values[c0:c0 + tile]
        dxp = xs - cx.reshape(-1, 1, 1, 1)
        dyp = ys - cy.reshape(-1, 1, 1, 1)
        dzp = zs - cz.reshape(-1, 1, 1, 1)
        if per_x:
            dxp = dxp - torch.round(dxp / Lx) * Lx
        if per_y:
            dyp = dyp - torch.round(dyp / Ly) * Ly
        if per_z:
            dzp = dzp - torch.round(dzp / Lz) * Lz
        r2 = dxp * dxp + dyp * dyp + dzp * dzp
        support = S * ch
        inside = r2 < (support * support).reshape(-1, 1, 1, 1)
        w = kernel.w(torch.sqrt(r2), ch.reshape(-1, 1, 1, 1))
        w = torch.where(inside, w, 0.0).to(dtype)
        contrib = torch.einsum("pzyx,pf->zyxf", w, cvals.to(dtype))
        grid_flat += contrib.reshape(nz * ny * nx, -1)
    return grid_flat


def deposit_3d(
    pos,
    h,
    values,
    spec: GridSpec,
    *,
    kernel: str = "cubic_spline",
    dtype=torch.float32,
    chunk: int = _DEF_CHUNK_3D,
    grid: Optional[Tensor] = None,
    device="cuda",
) -> Tensor:
    """Deposit particles onto a 3D voxel grid.

    pos : (N, 3) world coordinates (x, y, z columns), NumPy or torch.
    values : (N,) or (N, F) payloads; voxel value is sum_i value_i * W(r_i, h_i).
    grid : optional (nz, ny, nx) or (nz, ny, nx, F) accumulator to add into.
    device : where the deposit runs; inputs are moved there.
    Returns (nz, ny, nx), or (nz, ny, nx, F) for multi-field input, on ``device``.
    """
    device = torch.device(device)
    pos = _as_tensor(pos, device)
    h = _as_tensor(h, device)
    values = _as_tensor(values, device)
    single_field = values.ndim == 1
    if single_field:
        values = values[:, None]

    kspec = get_kernel(kernel)
    nz, ny, nx = spec.shape
    if grid is None:
        grid_flat = torch.zeros((nz * ny * nx, values.shape[1]), dtype=dtype, device=device)
    else:
        grid_flat = torch.as_tensor(grid, dtype=dtype, device=device).reshape(nz * ny * nx, -1).clone()

    # level binning on the smallest voxel edge, in the smoothing lengths' own
    # precision (before the cast)
    s_vox = kspec.support_factor * h / min(spec.voxel_size)
    needed = 2.0 * s_vox + 2.0
    bounds = torch.tensor(STENCIL_LEVELS_3D, dtype=needed.dtype, device=device)
    levels = torch.searchsorted(bounds, needed, side="left")
    pos, h, values = (a.to(dtype) for a in (pos, h, values))

    static = dict(
        shape=spec.shape,
        extent=tuple(float(v) for v in spec.extent),
        offset=spec.sample_offset,
        periodic=spec.periodic_wrap,
        kernel_name=kernel,
    )
    for li, K in enumerate(STENCIL_LEVELS_3D):
        idx = torch.nonzero(levels == li).flatten()
        if idx.numel() == 0:
            continue
        level_chunk = max(64, min(chunk, chunk * 512 // (K * K * K)))
        _stencil_level_pass_3d(
            grid_flat, pos[idx, 0], pos[idx, 1], pos[idx, 2], h[idx], values[idx],
            K=int(K), chunk=level_chunk, **static,
        )

    oversize = torch.nonzero(levels >= len(STENCIL_LEVELS_3D)).flatten()
    if oversize.numel():
        _dense_pass_3d(
            grid_flat, pos[oversize, 0], pos[oversize, 1], pos[oversize, 2], h[oversize],
            values[oversize], **static,
        )

    out = grid_flat.reshape(nz, ny, nx, -1)
    return out[..., 0] if single_field else out
