"""Morton encoding and on-device cell lists (neighbour structure).

Counterpart: ``astro_sph_tools_tpu/ops/cells.py``. The 3D cell list behind
neighbour queries and spatial analysis: one stable sort of the particles by
cell key and two ``searchsorted`` passes for the cell ranges, all on the
device. Keys stay int32, as the JAX package's are (30-bit Morton keys, or
row-major ids below 1024^3); the permutation is int64. The JAX package
registers ``CellList`` as a pytree so that it passes through ``jit``; eager
torch needs no counterpart.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

Tensor = torch.Tensor


def _as_tensor(a, device) -> Tensor:
    if isinstance(a, Tensor):
        return a.to(device)
    return torch.as_tensor(np.asarray(a), device=device)


def _part1by2(x: Tensor) -> Tensor:
    """Spread the low 10 bits of x so there are 2 zero bits between each."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def morton_encode_3d(ix, iy, iz) -> Tensor:
    """Interleave three 10-bit cell indices into a 30-bit Morton key (int32).

    Supports grids up to 1024^3 cells; keys preserve spatial locality, so
    cell-sorted particle arrays are read coherently. Works on the device of
    ``ix`` (NumPy inputs become CPU tensors).
    """
    ix = _as_tensor(ix, ix.device if isinstance(ix, Tensor) else "cpu")
    iy, iz = (_as_tensor(a, ix.device) for a in (iy, iz))
    return (
        _part1by2(ix.to(torch.int32))
        | (_part1by2(iy.to(torch.int32)) << 1)
        | (_part1by2(iz.to(torch.int32)) << 2)
    )


@dataclass
class CellList:
    """Cell-sorted particle structure.

    Attributes
    ----------
    order : (N,) int64 permutation sorting particles by cell key.
    cell_of_particle : (N,) int32 cell key per *sorted* particle.
    cell_start / cell_end : (n_cells,) int32 particle ranges per cell
        (``searchsorted`` over the sorted keys; one zero each for Morton keys).
    n_cells_per_axis : cells per axis; cell_size : world units.
    """

    order: Tensor
    cell_of_particle: Tensor
    cell_start: Tensor
    cell_end: Tensor
    n_cells_per_axis: int
    cell_size: float
    box_size: float
    morton: bool

    @property
    def n_cells(self) -> int:
        return self.n_cells_per_axis**3

    def counts(self) -> Tensor:
        return self.cell_end - self.cell_start


def linear_cell_id(pos, box_size: float, n_cells_per_axis: int, morton: bool = False,
                   device="cuda") -> Tensor:
    """Cell id per particle (int32): row-major linear or Morton-interleaved.

    Cells are ``trunc(pos / (box_size / n))`` clipped to [0, n - 1], the
    division in f32 as in the JAX package.
    """
    n = n_cells_per_axis
    pos = _as_tensor(pos, device).to(torch.float32)
    width = torch.tensor(box_size / n, dtype=torch.float32, device=pos.device)
    cell = torch.clamp((pos / width).to(torch.int32), 0, n - 1)
    if morton:
        return morton_encode_3d(cell[:, 0], cell[:, 1], cell[:, 2])
    return (cell[:, 2] * n + cell[:, 1]) * n + cell[:, 0]


def build_cell_list(
    pos, *, box_size: float, n_cells_per_axis: int, morton: bool = False, device="cuda"
) -> CellList:
    """Build the cell list: one stable sort + two searchsorteds, on ``device``.

    With ``morton=True`` the cell ranges are indexed by Morton key (use
    :func:`morton_encode_3d` to look cells up, and ``searchsorted`` on
    ``cell_of_particle`` for ranges); the default row-major layout supports
    direct (ix, iy, iz) arithmetic for neighbour walks.
    """
    ids = linear_cell_id(pos, box_size, n_cells_per_axis, morton, device=device)
    sorted_ids, order = torch.sort(ids, stable=True)
    if morton:
        cell_start = cell_end = torch.zeros(1, dtype=torch.int32, device=ids.device)
    else:
        rng = torch.arange(n_cells_per_axis**3, dtype=sorted_ids.dtype, device=ids.device)
        cell_start = torch.searchsorted(sorted_ids, rng).to(torch.int32)
        cell_end = torch.searchsorted(sorted_ids, rng, right=True).to(torch.int32)
    return CellList(
        order=order,
        cell_of_particle=sorted_ids,
        cell_start=cell_start,
        cell_end=cell_end,
        n_cells_per_axis=n_cells_per_axis,
        cell_size=box_size / n_cells_per_axis,
        box_size=box_size,
        morton=morton,
    )
