"""SPH smoothing kernels on torch tensors.

Counterpart: ``astro_sph_tools_tpu/kernels/splines.py``. The same five
kernels, their divide-free ``*_shape`` functions and normalisations, the
line-integrated column kernel (quadrature table, Chebyshev fit, Clenshaw
evaluation) — written with torch operations in place of ``jax.numpy``. The
NumPy functions that build the tables are copied.

Parity target: the reference's native kernel
(`astro_sph_tools/tools/projections/_kernels.pyx:9-20`, named
``quartic_spline_kernel`` but actually the standard M4 *cubic* spline):

    q = r / h
    W = (1 - 1.5 q^2 + 0.75 q^3) / (pi h^3)   for q < 1
    W = 0.25 (2 - q)^3 / (pi h^3)             for 1 <= q < 2
    W = 0                                     otherwise

i.e. compact support of **2 h**. ``h`` is the Gadget-style smoothing length
and the support radius is ``support_factor * h`` (2 for cubic/Wendland, 3 for
the quintic). Each kernel integrates to 1 over 3D space.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

Tensor = torch.Tensor

_INV_PI = 1.0 / math.pi


def cubic_spline_kernel(r: Tensor, h: Tensor) -> Tensor:
    """M4 cubic spline, 3D normalisation, support 2h (reference kernel)."""
    q = r / h
    inv_h3 = _INV_PI / (h * h * h)
    inner = 1.0 - 1.5 * q * q + 0.75 * q * q * q
    outer_base = 2.0 - q
    outer = 0.25 * outer_base * outer_base * outer_base
    w = torch.where(q < 1.0, inner, torch.where(q < 2.0, outer, 0.0))
    return w * inv_h3


def wendland_c2_kernel(r: Tensor, h: Tensor) -> Tensor:
    """Wendland C2, 3D, support H = 2h: W = 21/(2 pi H^3) (1-u)^4 (1+4u)."""
    u = r / (2.0 * h)
    norm = 21.0 / (16.0 * math.pi) / (h * h * h)
    one_m_u = torch.clamp_min(1.0 - u, 0.0)
    p2 = one_m_u * one_m_u
    return norm * (p2 * p2) * (1.0 + 4.0 * u)


def wendland_c4_kernel(r: Tensor, h: Tensor) -> Tensor:
    """Wendland C4, 3D, support H = 2h: W = 495/(32 pi H^3)(1-u)^6(1+6u+35u^2/3)."""
    u = r / (2.0 * h)
    norm = 495.0 / (256.0 * math.pi) / (h * h * h)
    one_m_u = torch.clamp_min(1.0 - u, 0.0)
    p2 = one_m_u * one_m_u
    p6 = p2 * p2 * p2
    return norm * p6 * (1.0 + 6.0 * u + (35.0 / 3.0) * u * u)


def wendland_c6_kernel(r: Tensor, h: Tensor) -> Tensor:
    """Wendland C6, 3D, support H = 2h: W = 1365/(64 pi H^3)(1-u)^8(1+8u+25u^2+32u^3)."""
    u = r / (2.0 * h)
    norm = 1365.0 / (512.0 * math.pi) / (h * h * h)
    one_m_u = torch.clamp_min(1.0 - u, 0.0)
    p2 = one_m_u * one_m_u
    p4 = p2 * p2
    p8 = p4 * p4
    return norm * p8 * (1.0 + 8.0 * u + 25.0 * u * u + 32.0 * u * u * u)


def _p5(x: Tensor) -> Tensor:
    xc = torch.clamp_min(x, 0.0)
    x2 = xc * xc
    return x2 * x2 * xc


def quintic_spline_kernel(r: Tensor, h: Tensor) -> Tensor:
    """M6 quintic spline, 3D, support 3h: W = [ (3-q)^5 - 6(2-q)^5 + 15(1-q)^5 ] / (120 pi h^3)."""
    q = r / h
    norm = 1.0 / (120.0 * math.pi) / (h * h * h)
    w = _p5(3.0 - q) - 6.0 * _p5(2.0 - q) + 15.0 * _p5(1.0 - q)
    return norm * torch.where(q < 3.0, w, 0.0)


# Reference-compat alias: the reference misnames its cubic spline "quartic"
# (_kernels.pyx:9).
quartic_spline_kernel = cubic_spline_kernel


# --- dimensionless shape functions ------------------------------------------
#
# W(r, h) = norm_3d / h^3 * shape_q(r / h): the deposit hoists 1/h and the
# normalisation to per-particle factors and evaluates only the divide-free
# polynomial shape per pixel. Each shape is exactly zero beyond its support.


def cubic_spline_shape(q: Tensor) -> Tensor:
    inner = 1.0 - 1.5 * q * q + 0.75 * q * q * q
    outer_base = 2.0 - q
    outer = 0.25 * outer_base * outer_base * outer_base
    return torch.where(q < 1.0, inner, torch.where(q < 2.0, outer, 0.0))


def wendland_c2_shape(q: Tensor) -> Tensor:
    u = 0.5 * q
    one_m_u = torch.clamp_min(1.0 - u, 0.0)
    p2 = one_m_u * one_m_u
    return (p2 * p2) * (1.0 + 4.0 * u)


def wendland_c4_shape(q: Tensor) -> Tensor:
    u = 0.5 * q
    one_m_u = torch.clamp_min(1.0 - u, 0.0)
    p2 = one_m_u * one_m_u
    p6 = p2 * p2 * p2
    return p6 * (1.0 + 6.0 * u + (35.0 / 3.0) * u * u)


def wendland_c6_shape(q: Tensor) -> Tensor:
    u = 0.5 * q
    one_m_u = torch.clamp_min(1.0 - u, 0.0)
    p2 = one_m_u * one_m_u
    p8 = p2 * p2 * p2 * p2
    return p8 * (1.0 + 8.0 * u + 25.0 * u * u + 32.0 * u * u * u)


def quintic_spline_shape(q: Tensor) -> Tensor:
    w = _p5(3.0 - q) - 6.0 * _p5(2.0 - q) + 15.0 * _p5(1.0 - q)
    return torch.where(q < 3.0, w, 0.0)


@dataclass(frozen=True)
class KernelSpec:
    """Static description of an SPH kernel family.

    ``kernel_id`` is the index the CUDA deposit kernel switches on
    (``csrc/deposit2d.cu``)."""

    name: str
    support_factor: float  # support radius = support_factor * h
    w: Callable[[Tensor, Tensor], Tensor]  # W(r, h), 3D-normalised
    # divide-free split: W(r, h) = norm_3d / h^3 * shape_q(r / h)
    shape_q: Optional[Callable[[Tensor], Tensor]] = None
    norm_3d: float = 0.0
    kernel_id: int = 0


KERNELS: dict[str, KernelSpec] = {
    "cubic_spline": KernelSpec(
        "cubic_spline", 2.0, cubic_spline_kernel,
        cubic_spline_shape, 1.0 / math.pi, 0,
    ),
    "wendland_c2": KernelSpec(
        "wendland_c2", 2.0, wendland_c2_kernel,
        wendland_c2_shape, 21.0 / (16.0 * math.pi), 1,
    ),
    "wendland_c4": KernelSpec(
        "wendland_c4", 2.0, wendland_c4_kernel,
        wendland_c4_shape, 495.0 / (256.0 * math.pi), 2,
    ),
    "wendland_c6": KernelSpec(
        "wendland_c6", 2.0, wendland_c6_kernel,
        wendland_c6_shape, 1365.0 / (512.0 * math.pi), 3,
    ),
    "quintic_spline": KernelSpec(
        "quintic_spline", 3.0, quintic_spline_kernel,
        quintic_spline_shape, 1.0 / (120.0 * math.pi), 4,
    ),
}


def get_kernel(name: str) -> KernelSpec:
    try:
        return KERNELS[name]
    except KeyError:
        raise ValueError(
            f"Unknown SPH kernel {name!r}; available: {sorted(KERNELS)}"
        ) from None


# --- line-integrated (column) kernels ---------------------------------------
#
# The reference projector evaluates the *3D* kernel at the projected 2D radius
# (_pixel_calculations.pyx:32-33). For physically correct column densities
# the line-integrated kernel
#     Y(b, h) = 2 * Integral_0^{sqrt(S^2 - b^2)} W(sqrt(b^2 + z^2), h) dz
# is tabulated once per kernel over u = b / S in [0, 1] (dimensionless:
# Y(b, h) = y(u) / h^2).


def _integrated_shape_table(spec: KernelSpec, n_table: int, n_quad: int = 256) -> np.ndarray:
    """Tabulate y(u) = h^2 * Y(u * S, h) by Gauss-Legendre quadrature (f64)."""
    S = spec.support_factor
    nodes, weights = np.polynomial.legendre.leggauss(n_quad)
    u = np.linspace(0.0, 1.0, n_table)
    b = u * S  # in units of h
    z_max = np.sqrt(np.maximum(S * S - b * b, 0.0))
    # map nodes from [-1,1] to [0, z_max]
    z = 0.5 * z_max[:, None] * (nodes[None, :] + 1.0)
    r = torch.from_numpy(np.sqrt(b[:, None] ** 2 + z**2))
    w_vals = spec.w(r, torch.ones_like(r)).numpy()
    y = 2.0 * 0.5 * z_max * (w_vals * weights[None, :]).sum(axis=1)
    return y.astype(np.float64)


_INTEGRATED_LUT_CACHE: dict[tuple[str, int], np.ndarray] = {}


def integrated_kernel_table(name: str, n_table: int = 4096) -> np.ndarray:
    """The dimensionless line-integral LUT y(u), u = b / (support_factor*h)."""
    key = (name, n_table)
    if key not in _INTEGRATED_LUT_CACHE:
        _INTEGRATED_LUT_CACHE[key] = _integrated_shape_table(get_kernel(name), n_table)
    return _INTEGRATED_LUT_CACHE[key]


def integrated_kernel_lookup(table: Tensor, b: Tensor, h: Tensor, support_factor: float) -> Tensor:
    """Evaluate Y(b, h) = y(b / (S h)) / h^2 by linear interpolation into *table*."""
    n = table.shape[0]
    u = b / (support_factor * h)
    x = torch.clamp(u, 0.0, 1.0) * (n - 1)
    i0 = torch.clamp(x.to(torch.int64), 0, n - 2)
    frac = x - i0.to(x.dtype)
    y = table[i0] * (1.0 - frac) + table[i0 + 1] * frac
    return torch.where(u < 1.0, y / (h * h), 0.0)


# --- gather-free column-kernel evaluation ------------------------------------
#
# y(u) fit once per kernel with one degree-44 Chebyshev series in t = u^2
# (even in u, so no sqrt), evaluated by the Clenshaw recurrence: FMAs only,
# stable in f32 (max relative error vs the quadrature table at degree 44:
# cubic 1.0e-6, Wendland C2 2.3e-6, all others <= 5e-7).

_INTEGRATED_CHEB_CACHE: dict[tuple[str, int], tuple[float, ...]] = {}


def integrated_kernel_chebyshev(name: str, degree: int = 44) -> tuple[float, ...]:
    """Chebyshev coefficients c_k of y(u) in x = 2 u^2 - 1 on [-1, 1]."""
    key = (name, degree)
    if key not in _INTEGRATED_CHEB_CACHE:
        tab = integrated_kernel_table(name, 8192)
        u = np.linspace(0.0, 1.0, 8192)
        x = 2.0 * u * u - 1.0
        c = np.polynomial.chebyshev.chebfit(x, tab, degree)
        _INTEGRATED_CHEB_CACHE[key] = tuple(float(v) for v in c)
    return _INTEGRATED_CHEB_CACHE[key]


def clenshaw(x: Tensor, coeffs: tuple[float, ...]) -> Tensor:
    """Evaluate a Chebyshev series at x in [-1, 1] (static coefficients)."""
    b1 = torch.zeros_like(x)
    b2 = torch.zeros_like(x)
    for k in range(len(coeffs) - 1, 0, -1):
        b1, b2 = 2.0 * x * b1 - b2 + coeffs[k], b1
    return x * b1 - b2 + coeffs[0]


def kernel_weight_q2(q2: Tensor, kernel: str, projection: str) -> Tensor:
    """Normalised kernel weight at squared normalised distance ``q2``: the
    kernel's shape at sqrt(q2) for ``"kernel3d"``, its line-integrated
    Chebyshev fit (0 from q2 = 1) for ``"integrated"``. The plain versions
    of the tiled 2D deposit kernels evaluate it."""
    if projection == "integrated":
        yv = clenshaw(2.0 * torch.clamp(q2, 0.0, 1.0) - 1.0, integrated_kernel_chebyshev(kernel))
        return torch.where(q2 < 1.0, yv, 0.0)
    return get_kernel(kernel).shape_q(torch.sqrt(q2))
