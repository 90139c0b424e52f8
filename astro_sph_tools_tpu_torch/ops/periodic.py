"""Periodic-box geometry, elementwise torch.

Counterpart: ``astro_sph_tools_tpu/ops/periodic.py``. Parity target:
`astro_sph_tools/tools/_periodic_box_manipulations.py:10-72`. Semantics
preserved exactly (minimum-image displacement with the |d| > L/2 wrap rule;
wrap-into-box with the half-open [0, L) / [-L/2, L/2) intervals; origin/
centre shifts, each wrapping once); the reference's in-place NumPy mutation
becomes functional returns.

Every function works elementwise on the caller's tensors, on their device
and in their dtype: an f64 input stays f64 (the JAX package, with x64 off,
computes in f32). NumPy arrays and Python numbers become tensors on the
device of the first tensor argument, or on ``device`` when none is a tensor
(float NumPy arrays keep their dtype; Python lists become f64, as
``np.asarray`` makes them). Shapes broadcast over leading axes.
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


def _tensors(*arrays, device):
    """The arrays as tensors on one device: that of the first tensor among
    them, else ``device``."""
    dev = next((a.device for a in arrays if isinstance(a, Tensor)), None)
    dev = torch.device(device) if dev is None else dev
    return [a if isinstance(a, Tensor) else torch.as_tensor(np.asarray(a), device=dev) for a in arrays]


def _box(box_width):
    """A box width as the reference takes it: a number or a 0-d array."""
    if isinstance(box_width, Tensor):
        return box_width
    return float(np.asarray(box_width))


def wrapped_displacement(from_positions, to_positions, box_width, *, device="cuda") -> Tensor:
    """Minimum-image displacement ``to - from`` in a periodic box.

    Components with |delta| > box_width/2 are wrapped by one box length toward
    zero (reference `_periodic_box_manipulations.py:10-20`). Assumes points
    are inside the box (or that the true displacement is under half a box).
    """
    from_positions, to_positions = _tensors(from_positions, to_positions, device=device)
    box_width = _box(box_width)
    delta = to_positions - from_positions
    needs_wrap = torch.abs(delta) > box_width / 2
    return torch.where(needs_wrap, delta - torch.sign(delta) * box_width, delta)


def wrapped_distance(
    from_position, to_positions, box_width, squared: bool = False, *, device="cuda"
) -> Tensor:
    """Length of the minimum-image displacement (reference `:22-34`).

    The reduction axis follows the reference: the last axis when either input
    is 2D (vectors), else the whole (1D single-vector) input.
    """
    from_position, to_positions = _tensors(from_position, to_positions, device=device)
    displacement = wrapped_displacement(from_position, to_positions, box_width)
    axis = 1 if (from_position.ndim > 1 or to_positions.ndim > 1) else 0
    squared_distance = (displacement**2).sum(dim=axis)
    return squared_distance if squared else torch.sqrt(squared_distance)


def make_periodic(positions, box_width, origin_is_centre: bool = False, *, device="cuda") -> Tensor:
    """Wrap positions into [0, L) (or [-L/2, L/2) if *origin_is_centre*).

    Functional version of the reference's in-place ``make_periodic``
    (`:36-43`); single-wrap semantics preserved (positions more than one box
    length outside are wrapped once, as in the reference).
    """
    (positions,) = _tensors(positions, device=device)
    box_width = _box(box_width)
    if origin_is_centre:
        half = box_width / 2
        out_of_box = (positions < -half) | (positions >= half)
        wrapped = positions - torch.sign(positions + half) * box_width
    else:
        out_of_box = (positions < 0.0) | (positions >= box_width)
        wrapped = positions - torch.sign(positions) * box_width
    return torch.where(out_of_box, wrapped, positions)


# Functional alias used by the reference's public API (`:44-51`).
calculate_periodic = make_periodic


def shift_origin(
    positions, new_origin, box_width, origin_is_centre: bool = False, *, device="cuda"
) -> Tensor:
    """Translate so *new_origin* maps to zero, then wrap (reference `:53-60`)."""
    positions, new_origin = _tensors(positions, new_origin, device=device)
    return make_periodic(positions - new_origin, box_width, origin_is_centre)


def shift_centre(
    positions, new_centre, box_width, origin_is_centre: bool = False, *, device="cuda"
) -> Tensor:
    """Translate so *new_centre* maps to the box centre, then wrap (reference `:62-72`)."""
    if origin_is_centre:
        return shift_origin(positions, new_centre, box_width, origin_is_centre, device=device)
    positions, new_centre = _tensors(positions, new_centre, device=device)
    return make_periodic(positions + (_box(box_width) / 2 - new_centre), box_width, origin_is_centre)
