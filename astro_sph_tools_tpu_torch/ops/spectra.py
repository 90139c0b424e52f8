"""Velocity-space absorption spectra (SpecWizard-style, config 4).

Counterpart: ``astro_sph_tools_tpu/ops/spectra.py``. Each particle
contributes its kernel column weight at the ray's impact parameter, smeared
in velocity space by a thermal/Doppler line profile centred on its effective
velocity (Hubble flow along the LOS + peculiar velocity):

    tau(v) = sum_i  N_i(b_impact) * phi(v - v_i; b_i)

with ``N_i = value_i * Y(b_impact_i, h_i)`` (the line-integrated kernel
table), ``v_i = H(z) a z_pos_i + v_pec,i`` and ``b_i = sqrt(2 k_B T_i /
m_ion)``. ``phi`` is a Gaussian or a Voigt profile (:func:`voigt_hjerting`),
summed over periodic velocity images of the box.

Two plain torch engines, the oracles of the fused engine
(``ops/spectra_fused.py``, TPU kernel #5's port):

- :func:`absorption_spectra` (dense): every particle against every ray, in
  (rays x particles) blocks;
- :func:`absorption_spectra_binned`: the host cell-binned candidate scheme
  of ``ops/sightlines.py::column_integrate_binned``.

Both evaluate the line profile only for the particles of a block whose
column weight is non-zero for some ray of the block; the others add exact
zeros, so the sums are the JAX engines'.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .. import constants as C
from ..kernels.splines import get_kernel, integrated_kernel_table
from ._device import as_f32
from .sightlines import _binned_domain, _binned_levels, _block_elems, _column_weights, _host, _min_image

Tensor = torch.Tensor

_DEF_CHUNK = 1024
_RAY_MACRO = 256


def doppler_parameter_kms(temperature_K, atomic_weight: float):
    """b = sqrt(2 k_B T / m) in km/s for an ion of the given atomic weight.

    Namespace-aware: a torch tensor stays a tensor on its device; anything
    else is computed with NumPy."""
    m = atomic_weight * C.ATOMIC_MASS_UNIT_CGS
    if isinstance(temperature_K, Tensor):
        return torch.sqrt(2.0 * C.BOLTZMANN_CONSTANT_CGS * temperature_K / m) / 1.0e5
    t = np.asarray(temperature_K)
    return np.sqrt(2.0 * C.BOLTZMANN_CONSTANT_CGS * t / m) / 1.0e5


def voigt_damping_kms(gamma: float, rest_wavelength_angstrom: float) -> float:
    """``voigt_k`` scalar for the engines: a_i = voigt_k / b_i(km/s).

    The Voigt damping parameter is ``a = Gamma * lambda0 / (4 pi b)`` with
    ``b`` in cm/s; dividing by 1e5 re-expresses it per km/s so the engines
    can form ``a`` from the per-particle Doppler parameter they already
    carry. For H I Lya: Gamma = 6.265e8 1/s, lambda0 = 1215.67 A."""
    lam_cm = rest_wavelength_angstrom * 1.0e-8
    return float(gamma) * lam_cm / (4.0 * math.pi) / 1.0e5


# Chebyshev fit of corr(x) = 2 - 4 x F(x) (F = Dawson's function) on
# x in [0, 7], mapped u = x/3.5 - 1; max abs error 4.1e-8 vs scipy.dawsn.
# csrc/sightlines.cu holds the same coefficients.
_VOIGT_CHEB = (
    2.4881856318770293e-01, -6.0099312693192697e-01, 6.4361396302280671e-01,
    -5.1737510766123362e-01, 2.7006888736076384e-01, -2.6368566685981337e-02,
    -1.1440794112897615e-01, 1.3403557615997266e-01, -8.1168647269143177e-02,
    1.9254729968325685e-02, 1.5083805306240839e-02, -1.9727259945187089e-02,
    1.0291579640219038e-02, -1.1424355634791525e-03, -2.4686477108562285e-03,
    2.0475510075201524e-03, -6.2666180702336701e-04, -1.7901753143482690e-04,
    2.7790611865101666e-04, -1.1578103569858545e-04, -4.5046318466839111e-06,
    3.0438481530514348e-05, -1.4871741069277782e-05, 6.4132269964071750e-07,
    2.9411844272740243e-06, -1.5233384164772555e-06, 9.4266957856181097e-08,
    2.6613322244869490e-07, -1.3128921523181491e-07, 9.9593625077359186e-09,
    2.2027981792878860e-08,
)


def voigt_hjerting(a, x):
    """Voigt-Hjerting function ``H(a, x)`` for small damping parameters.

    Second-order expansion in ``a`` with *exact* coefficient functions:

        H(a, x) = exp(-x^2) (1 + a^2 (1 - 2x^2)) - (a / sqrt(pi)) corr(x)
                  + O(a^3),
        corr(x) = 2 - 4 x F(x)          (F = Dawson's function)

    ``corr`` is evaluated from a degree-30 Chebyshev fit on [0, 7]
    (4e-8 max abs error) and the asymptotic series in 1/x^2 beyond
    (1.8e-7 max rel). Normalisation matches the Gaussian: the integral of H
    over x is sqrt(pi). Torch tensors are evaluated with torch in their
    dtype; anything else with NumPy.
    """
    if isinstance(x, Tensor) or isinstance(a, Tensor):
        xp, x = torch, torch.abs(torch.as_tensor(x))
        a = torch.as_tensor(a, dtype=x.dtype, device=x.device)
    else:
        xp, x = np, np.abs(np.asarray(x))
        a = np.asarray(a)
    x2 = x * x
    # Clenshaw on u in [-1, 1] (numerically stable at this degree in f32)
    u = xp.clip(x, 0.0, 7.0) * (1.0 / 3.5) - 1.0
    u2 = 2.0 * u
    b1 = xp.zeros_like(u)
    b2 = xp.zeros_like(u)
    for c in _VOIGT_CHEB[:0:-1]:
        b1, b2 = u2 * b1 - b2 + c, b1
    corr_cheb = u * b1 - b2 + _VOIGT_CHEB[0]
    t = 1.0 / (torch.clamp_min(x2, 49.0) if xp is torch else np.maximum(x2, 49.0))
    corr_asym = -t * (
        1.0 + t * (1.5 + t * (3.75 + t * (13.125 + t * (59.0625 + t * 324.84375))))
    )
    corr = xp.where(x <= 7.0, corr_cheb, corr_asym)
    h0 = xp.exp(-x2)
    return h0 * (1.0 + a * a * (1.0 - 2.0 * x2)) - a * (1.0 / math.sqrt(math.pi)) * corr


def _resolve_profile(profile: str, gamma, rest_wavelength_angstrom) -> float:
    """Validate the profile choice and return the engine's ``voigt_k``."""
    if profile not in ("gaussian", "voigt"):
        raise ValueError(f"unknown line profile {profile!r}")
    if profile == "voigt":
        if gamma is None or gamma <= 0:
            raise ValueError(
                "profile='voigt' needs the line's damping rate: pass "
                "gamma (1/s; H I Lya: 6.265e8)"
            )
        return voigt_damping_kms(gamma, rest_wavelength_angstrom)
    return 0.0


def _profile_sum(dv: Tensor, inv_b: Tensor, profile: str, voigt_k: float, vbox: Optional[float],
                 n_images: int = 3) -> Tensor:
    """Line profile phi(dv) with unit velocity integral, summed over the
    periodic velocity images ``-n_images .. n_images`` when ``vbox`` is
    given (after wrapping ``dv`` to the principal zone).

    ``profile="gaussian"``: pure thermal/Doppler core.
    ``profile="voigt"``: adds the Lorentzian damping wings via
    :func:`voigt_hjerting` with per-particle a = voigt_k * inv_b. The 7
    images (``n_images = 3``, the dense and binned engines' choice) cover
    the wings: beyond +-3 boxes the 1/x^2 wing contributes < (b/3 v_box)^2 *
    a of the line centre."""
    def one(d):
        z = d * inv_b
        if profile == "voigt":
            return voigt_hjerting(voigt_k * inv_b, z)
        return torch.exp(-(z * z))

    if vbox is None:
        phi = one(dv)
    else:
        dv = dv - torch.round(dv / vbox) * vbox
        phi = torch.zeros_like(dv)
        for k in range(-n_images, n_images + 1):
            phi = phi + one(dv + k * vbox)
    return phi * ((1.0 / math.sqrt(math.pi)) * inv_b)


def _spectra_inputs(pos, h, values, velocities_los, temperatures, *, cosmology, box_size,
                    atomic_weight, n_bins, periodic, device):
    """Per-particle device inputs and the velocity grid, as the JAX engines
    form them: ``(x, y, h, N, v_eff, b_dopp)`` f32 on ``device``, ``v_box``
    (None without a Hubble flow) and the f32 bin centres (NumPy).

    Host NumPy input is combined in f64 on the host (the JAX engines'
    arithmetic) before the f32 upload; tensor input stays on its device."""
    if box_size is None and periodic:
        raise ValueError("periodic spectra need box_size")
    # effective velocity: proper Hubble flow across the box + peculiar
    dv_dx = cosmology.hubble_rate() * cosmology.expansion_factor if cosmology is not None else 0.0
    v_box = float(box_size * dv_dx) if (box_size is not None and dv_dx > 0) else None
    if isinstance(pos, Tensor):
        pos = pos.to(device)
        v_pec = as_f32(velocities_los, device)
        temp = torch.as_tensor(temperatures, device=device)
        v_eff = (pos[:, 2] * dv_dx + v_pec).float()
        b_dopp = torch.clamp_min(doppler_parameter_kms(temp, atomic_weight), 1e-3).float()
    else:
        pos = np.asarray(pos)
        v_pec = np.asarray(_host(velocities_los, np.float32))
        temp = _host(temperatures, None)
        v_eff = as_f32((pos[:, 2] * dv_dx + v_pec).astype(np.float32), device)
        b_dopp = as_f32(np.maximum(doppler_parameter_kms(temp, atomic_weight), 1e-3).astype(np.float32), device)
    x, y = as_f32(pos[:, 0], device), as_f32(pos[:, 1], device)
    h = as_f32(h, device)
    col = as_f32(values, device)
    if v_box is not None:
        v_edges = np.linspace(0.0, v_box, n_bins + 1)
    else:
        lo = float(v_eff.min() - 3 * b_dopp.max())
        hi = float(v_eff.max() + 3 * b_dopp.max())
        v_edges = np.linspace(lo, hi, n_bins + 1)
    v_centres = 0.5 * (v_edges[:-1] + v_edges[1:]).astype(np.float32)
    return (x, y, h, col, v_eff, b_dopp), v_box, v_centres


def _accumulate(tau: Tensor, w_col: Tensor, v_eff: Tensor, b_dopp: Tensor, v_centres: Tensor,
                profile: str, voigt_k: float, vbox: Optional[float]) -> None:
    """tau (R, bins) += w_col (R, C) @ phi(C, bins)^T over the particles
    with a non-zero weight for some ray (the rest add exact zeros)."""
    live = torch.nonzero((w_col != 0).any(0))[:, 0]
    if live.numel() == 0:
        return
    dv = v_centres[:, None] - v_eff[live][None, :]  # (bins, L)
    phi = _profile_sum(dv, 1.0 / b_dopp[live][None, :], profile, voigt_k, vbox)
    tau += w_col[:, live] @ phi.T


def absorption_spectra(
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
    chunk: int = _DEF_CHUNK,
    periodic: bool = True,
    profile: str = "gaussian",
    gamma: Optional[float] = None,
    rest_wavelength_angstrom: float = 1215.67,
    device="cuda",
) -> tuple[Tensor, np.ndarray]:
    """Per-ray velocity-space spectra (dense engine).

    Parameters
    ----------
    pos : (N, 3) co-moving positions (projection axis = z; pre-rotate
        otherwise). h : (N,) smoothing lengths. values : (N,) column payloads
        (e.g. ion masses or column-density weights).
    velocities_los : (N,) peculiar LOS velocities, km/s.
    temperatures : (N,) gas temperatures, K (sets the Doppler width).
    cosmology : Cosmology supplying the Hubble flow (H(z)); if None, no
        Hubble flow is added (pure peculiar-velocity space).
    box_size : co-moving box length for periodic wrapping (both spatial and
        the velocity extent of the box).
    atomic_weight : ion mass in amu for the Doppler parameter.
    profile : "gaussian" (thermal core only) or "voigt" (adds natural/
        damping Lorentzian wings — required for saturated absorbers).
    gamma : damping rate Gamma in 1/s (required for profile="voigt";
        H I Lya: 6.265e8).
    rest_wavelength_angstrom : line rest wavelength (default Lya).
    device : where the spectra are computed.

    Returns (spectra (R, n_bins) on ``device``, velocity bin centres (km/s)).
    """
    voigt_k = _resolve_profile(profile, gamma, rest_wavelength_angstrom)
    device = torch.device(device)
    (x, y, h, col, v_eff, b_dopp), v_box, v_centres = _spectra_inputs(
        pos, h, values, velocities_los, temperatures, cosmology=cosmology, box_size=box_size,
        atomic_weight=atomic_weight, n_bins=n_bins, periodic=periodic, device=device,
    )
    kspec = get_kernel(kernel)
    lut = torch.as_tensor(integrated_kernel_table(kernel), dtype=torch.float32, device=device)
    vc = torch.as_tensor(v_centres, device=device)
    rx, ry = as_f32(ray_x, device), as_f32(ray_y, device)
    n_rays, n = rx.shape[0], x.shape[0]
    box = float(box_size) if periodic else None
    vbox = v_box if periodic else None
    tau = torch.zeros((n_rays, n_bins), dtype=torch.float32, device=device)
    step = max(chunk, _block_elems(device) // max(_RAY_MACRO, n_bins))
    for r0 in range(0, n_rays, _RAY_MACRO):
        r1 = min(r0 + _RAY_MACRO, n_rays)
        for c0 in range(0, n, step):
            c1 = min(c0 + step, n)
            dx = rx[r0:r1, None] - x[None, c0:c1]
            dy = ry[r0:r1, None] - y[None, c0:c1]
            if box is not None:
                dx = _min_image(dx, box)
                dy = _min_image(dy, box)
            w_col = _column_weights(kspec, lut, dx * dx + dy * dy, h[None, c0:c1]) * col[None, c0:c1]
            _accumulate(tau[r0:r1], w_col, v_eff[c0:c1], b_dopp[c0:c1], vc, profile, voigt_k, vbox)
    return tau, v_centres


def absorption_spectra_binned(
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
    chunk: int = 1024,
    ray_block: int = 128,
    periodic: bool = True,
    profile: str = "gaussian",
    gamma: Optional[float] = None,
    rest_wavelength_angstrom: float = 1215.67,
    device="cuda",
) -> tuple[Tensor, np.ndarray]:
    """Cell-binned per-ray velocity spectra — :func:`absorption_spectra`
    semantics at O(R * N_local), on the candidate scheme of
    :func:`ops.sightlines.column_integrate_binned`. As in the JAX engine,
    velocities wrap over the box's velocity extent whenever it has one
    (a Hubble flow and a ``box_size``), periodic or not.
    """
    voigt_k = _resolve_profile(profile, gamma, rest_wavelength_angstrom)
    device = torch.device(device)
    (_, _, _, col, v_eff, b_dopp), v_box, v_centres = _spectra_inputs(
        pos, h, values, velocities_los, temperatures, cosmology=cosmology, box_size=box_size,
        atomic_weight=atomic_weight, n_bins=n_bins, periodic=periodic, device=device,
    )
    kspec = get_kernel(kernel)
    lut = torch.as_tensor(integrated_kernel_table(kernel), dtype=torch.float32, device=device)
    vc = torch.as_tensor(v_centres, device=device)
    pos_h = _host(pos, np.float64)
    xh, yh = pos_h[:, 0], pos_h[:, 1]
    h64 = _host(h, np.float64)
    s = kspec.support_factor * h64
    rays = np.stack([_host(ray_x, np.float64), _host(ray_y, np.float64)])
    n_rays = rays.shape[1]
    xh, yh, rays, x0, y0, Lx, Ly = _binned_domain(xh, yh, s, rays, box_size if periodic else None)

    tau = torch.zeros((n_rays, n_bins), dtype=torch.float32, device=device)
    step = max(chunk, _block_elems(device) // max(ray_block, n_bins))
    for sel, rorder, blocks in _binned_levels(xh, yh, s, rays, x0, y0, Lx, Ly, ray_block, periodic):
        sel_t = torch.as_tensor(sel, device=device)
        px = torch.as_tensor(xh[sel].astype(np.float32), device=device)
        py = torch.as_tensor(yh[sel].astype(np.float32), device=device)
        ph = torch.as_tensor(h64[sel].astype(np.float32), device=device)
        pN, pv, pb = col[sel_t], v_eff[sel_t], b_dopp[sel_t]
        rxs = torch.as_tensor(rays[0][rorder].astype(np.float32), device=device)
        rys = torch.as_tensor(rays[1][rorder].astype(np.float32), device=device)
        ro = torch.as_tensor(rorder, device=device)
        for b0, b1, spans in blocks:
            rxb, ryb = rxs[b0:b1, None], rys[b0:b1, None]
            blk = torch.zeros((b1 - b0, n_bins), dtype=torch.float32, device=device)
            for lo, hi in spans:
                for c0 in range(lo, hi, step):
                    c1 = min(c0 + step, hi)
                    dx = rxb - px[None, c0:c1]
                    dy = ryb - py[None, c0:c1]
                    if periodic:
                        dx = _min_image(dx, Lx)
                        dy = _min_image(dy, Ly)
                    w_col = _column_weights(kspec, lut, dx * dx + dy * dy, ph[None, c0:c1]) * pN[None, c0:c1]
                    _accumulate(blk, w_col, pv[c0:c1], pb[c0:c1], vc, profile, voigt_k, v_box)
            tau.index_add_(0, ro[b0:b1], blk)
    return tau, v_centres
