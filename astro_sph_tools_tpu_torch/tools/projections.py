"""Reference-compatible ``tools.projections`` surface, on the sorted engine.

Counterpart: ``astro_sph_tools_tpu/tools/projections.py``. The reference
ships ``create_image`` / ``quartic_spline_kernel``
(`tools/projections/_projector.py:75-120`, `_kernels.pyx:9-20`) but the
module is unimportable in-tree (`_projector.py:11` imports a misspelled
module and `tools/__init__.py:6` comments the package out — SURVEY §2.9.1).
This module provides the same call signature, executed by
``deposit_2d_auto`` (the CUDA deposit kernel on the card, its plain torch
version on the CPU).

Conventions preserved from the reference:

- pixel (xi, yi) samples the field at ``x_min + xi * pixel_size`` — corner
  sampling, no half-pixel offset (`_pixel_calculations.pyx:13-14`);
- the returned image is indexed ``img[xi, yi]`` (first axis along the
  in-plane x coordinate; `_projector.py:118`);
- the kernel is evaluated at the *projected* radius with the ``r^2 < (2h)^2``
  mask (`_pixel_calculations.pyx:31-33`);
- ``quartic_spline_kernel`` keeps the reference's (mis)name for the M4 cubic
  spline.

Fixed relative to the reference, as in the JAX package: non-square images
used ``image_size[0]`` for both pixel sizes inside the Cython helper while
the chunk prefilter used ``image_size[1]`` (`_pixel_calculations.pyx:12-13`
vs `_projector.py:35`); here both axes use their own extent/size.
``chunk_size`` is accepted for signature parity and ignored — tiling is the
engine's concern.
"""

from __future__ import annotations

from typing import Callable, Union

import numpy as np

from ..data_structures.particle_types import CoordinateAxes
from ..kernels.splines import KERNELS, cubic_spline_kernel
from ..ops.deposit import MapSpec
from ..ops.deposit_tiled import deposit_2d_auto

quartic_spline_kernel = cubic_spline_kernel  # reference naming, M4 cubic

_KERNEL_BY_CALLABLE = {spec.w: name for name, spec in KERNELS.items()}


def create_image(
    positions: np.ndarray,
    smoothing_lengths: np.ndarray,
    particle_properties: np.ndarray,
    image_size: tuple[int, int],
    chunk_size: int = 64,
    projection_axis: CoordinateAxes = CoordinateAxes.Z,
    x_min: float = 0.0,
    x_max: float = 1.0,
    y_min: float = 0.0,
    y_max: float = 1.0,
    kernel_func: Union[str, Callable, None] = None,
    device="cuda",
) -> np.ndarray:
    """SPH projection with the reference ``create_image`` signature.

    ``kernel_func`` may be a kernel name (e.g. ``"cubic_spline"``), one of
    this package's kernel callables, or None (the reference default, the M4
    cubic). Positions are deposited from f64 (the engine's quality path);
    ``device`` is where the engine runs. Returns a float64 (image_size[0],
    image_size[1]) array indexed ``[xi, yi]``.
    """
    if kernel_func is None or kernel_func is quartic_spline_kernel:
        kernel = "cubic_spline"
    elif isinstance(kernel_func, str):
        kernel = kernel_func
    elif kernel_func in _KERNEL_BY_CALLABLE:
        kernel = _KERNEL_BY_CALLABLE[kernel_func]
    else:
        raise ValueError(
            "kernel_func must be a kernel name, a kernels.splines callable, "
            f"or None; got {kernel_func!r}"
        )

    positions = np.asarray(positions, np.float64)
    i, j = CoordinateAxes(projection_axis).projection_plane
    spec = MapSpec(
        shape=(int(image_size[1]), int(image_size[0])),  # (ny, nx)
        extent=(float(x_min), float(x_max), float(y_min), float(y_max)),
        periodic_wrap=False,
        pixel_origin="corner",  # reference samples at x_min + xi * px
    )
    img = deposit_2d_auto(
        positions[:, i], positions[:, j],
        np.asarray(smoothing_lengths, np.float32),
        np.asarray(particle_properties, np.float32),
        spec, kernel=kernel, device=device,
    )
    # the engine returns (ny, nx); the reference indexes img[xi, yi]
    return img.double().cpu().numpy().T
