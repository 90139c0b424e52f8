"""SPH particle -> pixel deposition, stencil engine in plain torch.

Counterpart: ``astro_sph_tools_tpu/ops/deposit.py``. This is the port's
``engine="xla"`` and the oversize fallback of the sorted tile engine
(``ops/deposit_tiled.py``). It holds no hand-written kernel: each particle
chunk's K x K stencil weights are evaluated with tensor operations and added
into the flat image with one ``index_add_`` per chunk (the JAX version's
``mode='drop'`` scatter).

Numerics preserved from the reference:
- map value = sum_i value_i * W(r_i, h_i) where r_i is the distance from the
  pixel sample point to the particle **projected** onto the image plane and W
  is the 3D-normalised kernel (`_pixel_calculations.pyx:32-34`) — selectable
  as ``projection="kernel3d"`` (default, reference parity). The physically
  line-integrated column kernel is available as ``projection="integrated"``.
- candidate mask ``r^2 < (support_factor * h)^2`` (`_pixel_calculations.pyx:31`).
- pixel sample points at ``min + index * pixel_size`` in reference-parity
  mode (``pixel_origin="corner"``, `_pixel_calculations.pyx:11-14`); the
  default ``"center"`` samples at ``min + (index + 1/2) * pixel_size``.

Adaptive smoothing lengths are handled by *support-level binning*: particles
are partitioned by footprint into stencil levels K in {2,4,8,...}, one pass
per level, so a huge-h particle never inflates the stencil of small-h ones.
Past K = 64 the port adds wider windows (``WIDE_LEVELS``) that the JAX
engine lacks (it sends those particles over the whole image): the same sum,
a K x K window a particle instead of the full map.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..kernels.splines import (
    KernelSpec,
    get_kernel,
    integrated_kernel_lookup,
    integrated_kernel_table,
)
from ..utils.profiling import count

Tensor = torch.Tensor

# Stencil side lengths available to the level binner. A particle whose kernel
# support spans s pixels (radius, in pixel units) fits level K if 2*s + 2 <= K.
STENCIL_LEVELS: tuple[int, ...] = (2, 4, 8, 16, 32, 64)
# Particles whose footprint exceeds the largest stencil are oversize. The JAX
# package sends every one through the dense (whole-image) path, which costs a
# full map a particle; that is cheap only while they are rare, and a halo
# cutout much finer than its particles' h is nearly all oversize. Here an
# oversize particle takes the narrowest of these wider windows that holds it
# and fits the map (so a window never wraps onto itself), and only what fits
# none takes the dense path.
MAX_STENCIL = STENCIL_LEVELS[-1]
WIDE_LEVELS: tuple[int, ...] = (128, 256, 512, 1024)

_DEF_CHUNK = 32 * 1024
# elements of one dense-pass block (particles x pixels)
_DENSE_BLOCK = 1 << 22
# elements of one wide-window chunk (particles x window pixels)
_WIDE_BLOCK = 1 << 24


@dataclass(frozen=True)
class MapSpec:
    """Static description of the output image grid.

    extent = (x_min, x_max, y_min, y_max) in world units; shape = (ny, nx).
    ``pixel_origin="center"`` samples pixel centres; ``"corner"`` reproduces
    the reference's ``min + index * pixel_size`` convention.
    """

    shape: tuple[int, int]
    extent: tuple[float, float, float, float]
    pixel_origin: str = "center"
    periodic_wrap: bool = False

    @property
    def pixel_size(self) -> tuple[float, float]:
        ny, nx = self.shape
        x0, x1, y0, y1 = self.extent
        return ((y1 - y0) / ny, (x1 - x0) / nx)

    @property
    def sample_offset(self) -> float:
        if self.pixel_origin == "center":
            return 0.5
        if self.pixel_origin == "corner":
            return 0.0
        raise ValueError(f"pixel_origin must be 'center' or 'corner', got {self.pixel_origin!r}")


def _eval_weights(kernel: KernelSpec, projection: str, lut: Optional[Tensor], r: Tensor, h: Tensor) -> Tensor:
    if projection == "kernel3d":
        return kernel.w(r, h)
    if projection == "integrated":
        return integrated_kernel_lookup(lut, r, h, kernel.support_factor)
    raise ValueError(f"projection must be 'kernel3d' or 'integrated', got {projection!r}")


def _stencil_level_pass(
    image_flat: Tensor,  # (ny*nx, F) accumulator, updated in place
    x: Tensor,  # (M,) world x
    y: Tensor,  # (M,) world y
    h: Tensor,  # (M,) smoothing length
    values: Tensor,  # (M, F) deposit payloads
    lut: Optional[Tensor],
    *,
    K: int,
    spec: MapSpec,
    kernel_name: str,
    projection: str,
    chunk: int,
) -> Tensor:
    """Deposit M particles with a K x K stencil into the flat image. The
    pixel-space positions and offsets are taken in the dtype of ``x`` (f64
    coordinates keep f64's precision at any map size), the weights in the
    image's."""
    kernel = get_kernel(kernel_name)
    S = kernel.support_factor
    ny, nx = spec.shape
    x0, x1, y0, y1 = spec.extent
    psx = (x1 - x0) / nx
    psy = (y1 - y0) / ny
    offset = spec.sample_offset
    dtype = image_flat.dtype
    ks = torch.arange(K, dtype=torch.int64, device=image_flat.device)

    for c0 in range(0, x.shape[0], chunk):
        cx, cy, ch = x[c0:c0 + chunk], y[c0:c0 + chunk], h[c0:c0 + chunk]
        cvals = values[c0:c0 + chunk]
        u = (cx - x0) / psx  # pixel-space position
        v = (cy - y0) / psy
        # centered K-window around the nearest sample point
        jx0 = torch.floor(u - offset + 0.5).to(torch.int64) - (K // 2)
        jy0 = torch.floor(v - offset + 0.5).to(torch.int64) - (K // 2)
        jx = jx0[:, None] + ks[None, :]  # (C, K)
        jy = jy0[:, None] + ks[None, :]
        dxp = (((jx.to(u.dtype) + offset) - u[:, None]) * psx).to(dtype)  # world units
        dyp = (((jy.to(v.dtype) + offset) - v[:, None]) * psy).to(dtype)
        r2 = dyp[:, :, None] ** 2 + dxp[:, None, :] ** 2  # (C, Ky, Kx)
        support = S * ch
        inside = r2 < (support * support)[:, None, None]
        w = _eval_weights(kernel, projection, lut, torch.sqrt(r2), ch[:, None, None])
        w = torch.where(inside, w, 0.0).to(dtype)

        if spec.periodic_wrap:
            flat = torch.remainder(jy, ny)[:, :, None] * nx + torch.remainder(jx, nx)[:, None, :]
        else:
            in_x = (jx >= 0) & (jx < nx)
            in_y = (jy >= 0) & (jy < ny)
            valid = in_y[:, :, None] & in_x[:, None, :]
            # off-image pixels get weight 0 at a clipped (in-range) index:
            # the add is then a no-op, as the JAX scatter's mode='drop'
            w = torch.where(valid, w, 0.0)
            flat = (
                torch.clamp(jy, 0, ny - 1)[:, :, None] * nx
                + torch.clamp(jx, 0, nx - 1)[:, None, :]
            )
        updates = w[..., None] * cvals[:, None, None, :]  # (C, Ky, Kx, F)
        image_flat.index_add_(0, flat.reshape(-1), updates.reshape(-1, updates.shape[-1]))
    return image_flat


def _dense_pass(
    image_flat: Tensor,  # (ny*nx, F), updated in place
    x: Tensor,
    y: Tensor,
    h: Tensor,
    values: Tensor,  # (M, F)
    lut: Optional[Tensor],
    *,
    spec: MapSpec,
    kernel_name: str,
    projection: str,
) -> Tensor:
    """Whole-image deposit for oversize-footprint particles (rare).

    Processes blocks of particles against the full pixel grid —
    O(M * ny * nx) but M is tiny. With a periodic map the minimum-image
    convention is applied per axis.
    """
    kernel = get_kernel(kernel_name)
    S = kernel.support_factor
    ny, nx = spec.shape
    x0, x1, y0, y1 = spec.extent
    psx = (x1 - x0) / nx
    psy = (y1 - y0) / ny
    offset = spec.sample_offset
    dtype = image_flat.dtype
    dev = image_flat.device
    Lx = x1 - x0
    Ly = y1 - y0

    # sample points and offsets in the coordinates' dtype, weights in the image's
    xs = (x0 + (torch.arange(nx, dtype=x.dtype, device=dev) + offset) * psx).reshape(1, 1, nx)
    ys = (y0 + (torch.arange(ny, dtype=y.dtype, device=dev) + offset) * psy).reshape(1, ny, 1)
    tile = max(1, _DENSE_BLOCK // (ny * nx))

    for c0 in range(0, x.shape[0], tile):
        cx, cy, ch = x[c0:c0 + tile], y[c0:c0 + tile], h[c0:c0 + tile]
        cvals = values[c0:c0 + tile]
        dxp = xs - cx.reshape(-1, 1, 1)
        dyp = ys - cy.reshape(-1, 1, 1)
        if spec.periodic_wrap:
            dxp = dxp - torch.round(dxp / Lx) * Lx
            dyp = dyp - torch.round(dyp / Ly) * Ly
        dxp, dyp = dxp.to(dtype), dyp.to(dtype)
        r2 = dxp * dxp + dyp * dyp
        support = S * ch
        inside = r2 < (support * support).reshape(-1, 1, 1)
        w = _eval_weights(kernel, projection, lut, torch.sqrt(r2), ch.reshape(-1, 1, 1))
        w = torch.where(inside, w, 0.0).to(dtype)
        contrib = torch.einsum("pyx,pf->yxf", w, cvals.to(dtype))
        image_flat += contrib.reshape(ny * nx, -1)
    return image_flat


def bin_particles_by_footprint(
    h, pixel_size: tuple[float, float], support_factor: float
) -> tuple[list[Tensor], Tensor]:
    """Partition particle indices by stencil level.

    Returns (per-level index tensors aligned with STENCIL_LEVELS, oversize
    index tensor), on the device of ``h`` (NumPy input is taken as a CPU
    tensor).
    """
    h = torch.as_tensor(h)
    s_pix = support_factor * h / min(pixel_size)
    needed = 2.0 * s_pix + 2.0
    bounds = torch.tensor(STENCIL_LEVELS, dtype=needed.dtype, device=needed.device)
    levels = torch.searchsorted(bounds, needed, side="left")
    per_level = [torch.nonzero(levels == i).flatten() for i in range(len(STENCIL_LEVELS))]
    oversize = torch.nonzero(levels >= len(STENCIL_LEVELS)).flatten()
    return per_level, oversize


def _as_tensor(a, device) -> Tensor:
    return torch.as_tensor(np.asarray(a) if not isinstance(a, Tensor) else a, device=device)


def deposit_2d(
    x,
    y,
    h,
    values,
    spec: MapSpec,
    *,
    kernel: str = "cubic_spline",
    projection: str = "kernel3d",
    dtype=torch.float32,
    chunk: int = _DEF_CHUNK,
    image: Optional[Tensor] = None,
    device="cuda",
) -> Tensor:
    """Deposit particles onto a 2D map.

    Parameters
    ----------
    x, y : (N,) world-space in-plane coordinates (pre-projected: pick the two
        axes with ``CoordinateAxes.projection_plane``). NumPy arrays or torch
        tensors; f64 ones keep f64 for the pixel offsets, which then carry
        f64's precision at any map size (the weights and sums are ``dtype``).
    h : (N,) smoothing lengths (same units).
    values : (N,) or (N, F) deposit payloads. The resulting map is
        ``sum_i values_i * W(r_i, h_i)`` per pixel.
    spec : the output grid description.
    kernel, projection : kernel family and 2D evaluation mode (see module doc).
    image : optional (ny, nx) or (ny, nx, F) accumulator to add into.
    device : where the deposit runs; inputs are moved there.

    Returns the (ny, nx) map, or (ny, nx, F) for multi-field input, as a
    tensor on ``device``. Under ``torch.profiler`` the particles each
    stencil level, wide window (``K<side>``) and the dense pass take are
    counted on the innermost open span (``utils.profiling.count``).
    """
    device = torch.device(device)
    x = _as_tensor(x, device)
    y = _as_tensor(y, device)
    h = _as_tensor(h, device)
    values = _as_tensor(values, device)
    single_field = values.ndim == 1
    if single_field:
        values = values[:, None]
    n_fields = values.shape[1]

    kspec = get_kernel(kernel)
    lut = (
        torch.as_tensor(integrated_kernel_table(kernel), dtype=dtype, device=device)
        if projection == "integrated"
        else None
    )

    ny, nx = spec.shape
    if image is None:
        image_flat = torch.zeros((ny * nx, n_fields), dtype=dtype, device=device)
    else:
        image_flat = torch.as_tensor(image, dtype=dtype, device=device).reshape(ny * nx, -1).clone()

    # binning runs in the smoothing lengths' own precision, before the cast;
    # f64 coordinates stay f64 for the pixel offsets (see _stencil_level_pass)
    per_level, oversize = bin_particles_by_footprint(h, spec.pixel_size, kspec.support_factor)
    x, y = (a if a.dtype == torch.float64 else a.to(dtype) for a in (x, y))
    h, values = h.to(dtype), values.to(dtype)
    static = dict(spec=spec, kernel_name=kernel, projection=projection)

    routed = {}  # particles a level, for the innermost open span
    for K, idx in zip(STENCIL_LEVELS, per_level):
        if idx.numel() == 0:
            continue
        routed[f"K{K}"] = idx.numel()
        level_chunk = max(256, min(chunk, chunk * 64 // (K * K)))
        _stencil_level_pass(
            image_flat, x[idx], y[idx], h[idx], values[idx], lut,
            K=int(K), chunk=level_chunk, **static,
        )

    if oversize.numel():
        needed = 2.0 * kspec.support_factor * h[oversize] / min(spec.pixel_size) + 2.0
        for K in WIDE_LEVELS:
            if K > min(ny, nx) or oversize.numel() == 0:
                break
            fits = needed <= K
            idx = oversize[fits]
            oversize, needed = oversize[~fits], needed[~fits]
            if idx.numel():
                routed[f"K{K}"] = idx.numel()
                _stencil_level_pass(
                    image_flat, x[idx], y[idx], h[idx], values[idx], lut,
                    K=K, chunk=max(1, _WIDE_BLOCK // (K * K)), **static,
                )

    if oversize.numel():
        routed["dense"] = oversize.numel()
        _dense_pass(
            image_flat, x[oversize], y[oversize], h[oversize], values[oversize], lut,
            **static,
        )
    count(**routed)

    image = image_flat.reshape(ny, nx, n_fields)
    return image[..., 0] if single_field else image


def deposit_2d_fixed_h(
    x: Tensor,
    y: Tensor,
    h: Tensor,
    values: Tensor,
    spec: MapSpec,
    *,
    K: int,
    kernel: str = "cubic_spline",
    projection: str = "kernel3d",
    dtype=torch.float32,
    chunk: int = _DEF_CHUNK,
) -> Tensor:
    """Single-level deposit (no binning), on the device of ``x``.

    Requires every particle's footprint to fit the static K x K stencil
    (``2 * support_factor * h / pixel_size + 2 <= K``); contributions outside
    the stencil are silently truncated.
    """
    values = values if values.ndim == 2 else values[:, None]
    single_field = values.shape[1] == 1
    ny, nx = spec.shape
    lut = (
        torch.as_tensor(integrated_kernel_table(kernel), dtype=dtype, device=x.device)
        if projection == "integrated"
        else None
    )
    image_flat = torch.zeros((ny * nx, values.shape[1]), dtype=dtype, device=x.device)
    _stencil_level_pass(
        image_flat, x.to(dtype), y.to(dtype), h.to(dtype), values.to(dtype), lut,
        K=K, spec=spec, kernel_name=kernel, projection=projection, chunk=chunk,
    )
    image = image_flat.reshape(ny, nx, -1)
    return image[..., 0] if single_field else image


def deposit_weighted_mean(
    x, y, h, quantity, weight, spec: MapSpec, floor: float = 0.0, **kwargs
) -> tuple[Tensor, Tensor]:
    """Weight-averaged map: returns (sum(w*q)/sum(w), sum(w)) per pixel.

    The two accumulators ride one deposit pass (multi-field payload).
    """
    quantity = torch.as_tensor(np.asarray(quantity) if not isinstance(quantity, Tensor) else quantity)
    weight = torch.as_tensor(np.asarray(weight) if not isinstance(weight, Tensor) else weight)
    fields = torch.stack([weight * quantity, weight], dim=1)
    maps = deposit_2d(x, y, h, fields, spec, **kwargs)
    wq, w = maps[..., 0], maps[..., 1]
    mean = torch.where(w > floor, wq / torch.clamp_min(w, 1e-37), 0.0)
    return mean, w
