"""Device plumbing the engines share: inputs as f32 tensors, constants made
once per device, the accepted precision strings and the tile-sorted
layouts' keys and ranges. It imports nothing from ``ops/``, so every engine
(and ``io/``) can import it without reaching into another engine.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

Tensor = torch.Tensor

#: precision strings the 2D engines accept (the sums are f32 for each)
PRECISIONS_2D = ("f32", "bf16", "bf16x2", "bf16x3")
#: those the 3D engines accept
PRECISIONS_3D = ("f32", "bf16", "bf16x2")

#: composite sort key of the tiled layouts (2D and 3D): level * STRIDE + tile
LEVEL_STRIDE = 1 << 22


def check_precision(precision: str, accepted: Sequence[str] = PRECISIONS_2D) -> str:
    """Unknown strings must fail loudly (a typo such as 'fp32' must not
    silently select another mode)."""
    if precision not in accepted:
        raise ValueError(f"unknown precision {precision!r}; expected one of {tuple(accepted)}")
    return precision


def as_f32(a, device) -> Tensor:
    """``a`` (a tensor, a NumPy array or anything NumPy takes) as an f32
    tensor on ``device``."""
    return torch.as_tensor(a if isinstance(a, Tensor) else np.asarray(a), dtype=torch.float32, device=device)


def as_field_matrix(values, device, max_fields: Optional[int] = None) -> tuple[Tensor, bool]:
    """``values`` (N,) or (F, N) as a contiguous (F, N) f32 tensor on
    ``device``, and whether the input was 1-D; more than ``max_fields``
    fields (the kernel's limit) raise."""
    values = as_f32(values, device)
    single = values.ndim == 1
    if single:
        values = values[None, :]
    if max_fields is not None and values.shape[0] > max_fields:
        raise ValueError(f"this engine carries at most {max_fields} fields per pass, got {values.shape[0]}")
    return values.contiguous(), single


_CONSTS: dict = {}


def device_const(values: Sequence, dtype: torch.dtype, device) -> Tensor:
    """A small constant tensor on ``device``, made once per process and
    reused. A copy from pageable host memory to the device synchronises the
    host with the device, so a render meant to run without host syncs must
    not make one per call."""
    key = (tuple(values), dtype, str(torch.device(device)))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(key[0], dtype=dtype, device=device)
    return t


def tile_ranges(tile_sorted: Tensor, n_tiles: int) -> tuple[Tensor, Tensor]:
    """(pstart, pcount) int32 per tile over a tile-sorted id array."""
    tile_range = torch.arange(n_tiles, dtype=tile_sorted.dtype, device=tile_sorted.device)
    pstart = torch.searchsorted(tile_sorted, tile_range)
    pend = torch.searchsorted(tile_sorted, tile_range, right=True)
    return pstart.to(torch.int32), (pend - pstart).to(torch.int32)
