"""Fused absorption-spectra engine: velocity-space tau through a hand-written CUDA kernel.

Counterpart: ``astro_sph_tools_tpu/ops/spectra_pallas.py`` (public name
``absorption_spectra_pallas`` kept). Same physics as
:func:`ops.spectra.absorption_spectra`, on the layout and ray schedule of
``ops/sightlines_fused.py`` with blocks of ``B = 32`` rays; the channels
after [x, y, h] are [column payload N, v_eff, b_Doppler].
:func:`spectra_tiles` (``csrc/sightlines.cu``, TPU kernel #5) gives every
ray block's (32, n_bins) optical depth, ``tau += w_col @ phi`` in f32: the
TPU's bf16 hi/lo limb splits existed for its matrix unit and are not
carried over.

**Velocity images.** With a periodic velocity axis the profile is summed
over ``-n .. n`` images of the box's velocity extent. For the Gaussian the
JAX engine sizes ``n`` from the widest line (images beyond reach add under
exp(-36)); for ``profile="voigt"`` it used the same Gaussian rule, which
drops the damping wings' far images and leaves tau near the antipode up to
~50 % low. This engine sums the 7 images of ``ops/spectra.py::_profile_sum``
for Voigt, as the dense and binned engines do.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .. import _build
from ..kernels.splines import clenshaw, get_kernel, integrated_kernel_chebyshev
from .deposit_tiled import device_const
from .sightlines_fused import (
    _RAY_BATCH,
    _check_layout,
    _pair_geometry,
    _span_entries,
    stage_rays,
    unsort_sum,
)
from .sightlines import _host
from .spectra import _profile_sum, _resolve_profile, _spectra_inputs

Tensor = torch.Tensor

# Rays per block: the ray count of the kernel's tau tile (and of its
# per-chunk live mask, one bit per ray).
_B = 32


def n_velocity_images(profile: str, b_max: float, v_box: float) -> int:
    """Periodic velocity images summed on each side of the principal one.

    After wrapping to the principal zone (|dv| <= v_box/2) image k peaks at
    best (k - 0.5) * v_box away, so a Gaussian needs only the images with
    (k - 0.5) * v_box < 6 b_max (exp(-36) beyond): typically none. Voigt
    wings fall off as 1/x^2, and take the dense engine's 3."""
    if profile == "voigt":
        return 3
    return min(3, max(0, int(math.ceil(6.0 * b_max / v_box + 0.5)) - 1))


def spectra_tiles_plain(
    packed: Tensor, rx: Tensor, ry: Tensor, lo: Tensor, hi: Tensor, v_centres: Tensor,
    *,
    kernel: str,
    periodic: bool,
    Lx: float,
    Ly: float,
    v_box: Optional[float],
    n_images: int,
    profile: str,
    voigt_k: float,
) -> Tensor:
    """Plain torch version of :func:`spectra_tiles`: the same inputs and the
    same (n_blocks, B, n_bins) f32 output. Every (span entry, ray) pair gets
    the kernel's column weight; the profile is evaluated for the pairs whose
    weight is non-zero, in blocks of 2^22 (CPU) or 2^25 (GPU) elements."""
    S = get_kernel(kernel).support_factor
    cheb = integrated_kernel_chebyshev(kernel)
    n_blocks, B = rx.shape
    n_bins = v_centres.shape[0]
    dev = packed.device
    out = torch.zeros((n_blocks * B, n_bins), dtype=torch.float32, device=dev)
    blk_all, idx_all = _span_entries(lo, hi)
    big = 1 << (22 if dev.type == "cpu" else 25)
    for c0 in range(0, blk_all.shape[0], big // B):
        blk, idx = blk_all[c0:c0 + big // B], idx_all[c0:c0 + big // B]
        b2, hs, inv_h = _pair_geometry(packed, rx, ry, blk, idx, periodic, Lx, Ly)
        inv_h = inv_h[:, None]
        inv_sh = inv_h * (1.0 / S)
        tq = b2 * (inv_sh * inv_sh)
        live = (tq < 1.0) & (hs > 0.0)[:, None]
        e, r = torch.nonzero(live, as_tuple=True)
        if e.numel() == 0:
            continue
        tq_l, ih_l = tq[e, r], inv_h[e, 0]
        w = clenshaw(2.0 * torch.clamp(tq_l, 0.0, 1.0) - 1.0, cheb) * (ih_l * ih_l) * packed[3, idx[e]]
        row = blk[e] * B + r
        v_eff, inv_b = packed[4, idx[e]], 1.0 / packed[5, idx[e]]
        step = max(1, big // n_bins)
        for p0 in range(0, e.shape[0], step):
            sl = slice(p0, p0 + step)
            dv = v_centres[None, :] - v_eff[sl, None]  # (P, bins)
            phi = _profile_sum(dv, inv_b[sl, None], profile, voigt_k, v_box, n_images)
            out.index_add_(0, row[sl], w[sl, None] * phi)
    return out.view(n_blocks, B, n_bins)


def spectra_tiles(
    packed: Tensor, rx: Tensor, ry: Tensor, lo: Tensor, hi: Tensor, v_centres: Tensor,
    *,
    kernel: str,
    periodic: bool,
    Lx: float,
    Ly: float,
    v_box: Optional[float],
    n_images: int,
    profile: str,
    voigt_k: float,
) -> Tensor:
    """Optical depth of every ray block, (n_blocks, B, n_bins) f32.

    ``packed`` holds the (level, cell)-sorted channels [x, y, h, N, v_eff,
    b_Doppler] as rows; block ``k`` sums the spans ``[lo[k, u], hi[k, u])``
    against its rays ``(rx[k], ry[k])`` at the f32 velocity bin centres
    ``v_centres``. ``v_box`` None: no velocity wrap; else the profile is
    wrapped to the principal zone and summed over ``-n_images .. n_images``.
    On a CUDA tensor this launches the hand-written kernel
    ``csrc/sightlines.cu`` (built at first use) and raises if the build or
    the launch fails; on a CPU tensor it runs :func:`spectra_tiles_plain`.
    """
    if profile not in ("gaussian", "voigt"):
        raise ValueError(f"unknown line profile {profile!r}")
    args = dict(kernel=kernel, periodic=periodic, Lx=Lx, Ly=Ly, v_box=v_box, n_images=n_images,
                profile=profile, voigt_k=voigt_k)
    if packed.device.type == "cpu":
        return spectra_tiles_plain(packed, rx, ry, lo, hi, v_centres, **args)
    if packed.device.type != "cuda":
        raise ValueError(f"no spectra kernel for device {packed.device}")
    _check_layout(packed, rx, ry, lo, hi, _B, 6)
    if v_centres.dtype != torch.float32 or v_centres.device != packed.device or v_centres.ndim != 1:
        raise ValueError(f"v_centres must be a 1-D float32 tensor on {packed.device}")
    n_blocks, n_bins = rx.shape[0], v_centres.shape[0]
    out = torch.empty((n_blocks, _B, n_bins), dtype=torch.float32, device=packed.device)
    if n_blocks == 0 or n_bins == 0:
        return out.zero_()
    lib, _ = _build.load("sightlines")
    cheb = device_const(integrated_kernel_chebyshev(kernel), torch.float32, packed.device)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        code = lib.sightline_spectra_launch(
            packed.data_ptr(), packed.stride(0),
            rx.data_ptr(), ry.data_ptr(), lo.data_ptr(), hi.data_ptr(), n_blocks,
            v_centres.data_ptr(), n_bins, out.data_ptr(),
            int(periodic), float(Lx), float(Ly), float(get_kernel(kernel).support_factor),
            cheb.data_ptr(), cheb.numel(),
            int(v_box is not None), float(v_box or 1.0), int(n_images),
            int(profile == "voigt"), float(voigt_k),
            stream,
        )
    if code != 0:
        raise RuntimeError(
            f"sightline spectra kernel launch failed: {lib.cuda_error_string(code).decode()} ({code})"
        )
    spectra_tiles.launches += 1
    return out


#: kernel launches made by :func:`spectra_tiles` in this process (CUDA only)
spectra_tiles.launches = 0


def absorption_spectra_pallas(
    pos,
    h,
    values,
    velocities_los,
    temperatures,
    ray_x,
    ray_y,
    *,
    cosmology=None,
    box_size: Optional[float] = None,
    atomic_weight: float = 1.008,
    n_bins: int = 512,
    kernel: str = "cubic_spline",
    periodic: bool = True,
    profile: str = "gaussian",
    gamma: Optional[float] = None,
    rest_wavelength_angstrom: float = 1215.67,
    device="cuda",
) -> tuple[Tensor, np.ndarray]:
    """Per-ray velocity-space spectra — :func:`ops.spectra.absorption_spectra`
    semantics (incl. ``profile="voigt"`` damping wings) on the fused kernel
    pass; name kept from the JAX package. ``n_bins`` must be a multiple of
    128, as in the JAX engine. Returns (spectra (R, n_bins) on ``device``,
    velocity bin centres in km/s).
    """
    voigt_k = _resolve_profile(profile, gamma, rest_wavelength_angstrom)
    device = torch.device(device)
    n_rays_in = len(ray_x)
    if n_rays_in > _RAY_BATCH:
        # spectra rows are independent per ray: large ray sets run in batches
        rx_all, ry_all = _host(ray_x, np.float64), _host(ray_y, np.float64)
        taus, vc = [], None
        for i in range(0, n_rays_in, _RAY_BATCH):
            tau_i, vc = absorption_spectra_pallas(
                pos, h, values, velocities_los, temperatures,
                rx_all[i:i + _RAY_BATCH], ry_all[i:i + _RAY_BATCH],
                cosmology=cosmology, box_size=box_size, atomic_weight=atomic_weight,
                n_bins=n_bins, kernel=kernel, periodic=periodic, profile=profile, gamma=gamma,
                rest_wavelength_angstrom=rest_wavelength_angstrom, device=device,
            )
            taus.append(tau_i)
        return torch.cat(taus, dim=0), vc
    if n_bins % 128:
        raise ValueError("the fused spectra engine needs n_bins to be a multiple of 128")
    layout, v_centres, v_box, n_images = _spectra_layout(
        pos, h, values, velocities_los, temperatures, ray_x, ray_y, cosmology=cosmology,
        box_size=box_size, atomic_weight=atomic_weight, n_bins=n_bins, kernel=kernel,
        periodic=periodic, profile=profile, device=device,
    )
    if layout is None:
        return torch.zeros((n_rays_in, n_bins), dtype=torch.float32, device=device), v_centres
    out = spectra_tiles(
        layout.packed, layout.rx, layout.ry, layout.lo, layout.hi,
        torch.as_tensor(v_centres, device=device), kernel=kernel, periodic=layout.periodic,
        Lx=layout.Lx, Ly=layout.Ly, v_box=v_box, n_images=n_images, profile=profile, voigt_k=voigt_k,
    )
    return unsort_sum(out, layout), v_centres


def _spectra_layout(pos, h, values, velocities_los, temperatures, ray_x, ray_y, *, cosmology, box_size,
                    atomic_weight, n_bins, kernel, periodic, profile, device):
    """(RayLayout or None, v_centres, wrapped v_box or None, n_images) of a
    spectra pass on ``device``."""
    (x, y, h_t, col, v_eff, b_dopp), v_box, v_centres = _spectra_inputs(
        pos, h, values, velocities_los, temperatures, cosmology=cosmology, box_size=box_size,
        atomic_weight=atomic_weight, n_bins=n_bins, periodic=periodic, device=device,
    )
    wrap = v_box if (periodic and v_box is not None) else None
    n_images = 0
    if wrap is not None:
        b_max = float(b_dopp.max()) if b_dopp.numel() else 1.0
        n_images = n_velocity_images(profile, b_max, wrap)
    if len(ray_x) == 0:
        return None, v_centres, wrap, n_images
    layout = stage_rays(
        x, y, h_t, [col, v_eff, b_dopp], ray_x, ray_y,
        support_factor=get_kernel(kernel).support_factor,
        periodic_box=float(box_size) if periodic else None, B=_B,
    )
    return layout, v_centres, wrap, n_images
