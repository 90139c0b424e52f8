"""Ionisation-table interpolation base.

Counterpart: ``astro_sph_tools_tpu/data_structures/ionisation.py``: N-D
regular-grid interpolation of log-space ion-fraction tables with
``bounds_error=False`` and ``fill_value=-inf``; ``evaluate_at_redshift``
fixes the redshift column of the gas-state matrix. The table and its axes
are held as tensors on an explicit device (``cuda`` unless the caller asks
for the CPU), and the lookups run there (``ops.interp``).

Not copied: the JAX package's ``table_at_redshift`` clamps a redshift
outside the table's redshift axis to the edge plane, while its full-D
lookup returns -inf there. Here a redshift outside the axis gives -inf for
every row on both paths.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np
import torch
from torch import Tensor

from ..ops.interp import regular_grid_interpolate


class IIonisationTable(ABC):
    """Types that provide ionisation state."""

    @abstractmethod
    def __call__(self, gas_state) -> Tensor: ...


class IonisationTableBase(IIonisationTable):
    """A log ion-fraction table over D axes, one of which is the redshift
    (``redshift_input_index``, counted from the end when negative)."""

    def __init__(self, table, *table_positions, redshift_input_index: int = -1, device="cuda") -> None:
        self._n_input_dimensions = len(table_positions)
        # a negative index counts from the end (the JAX package's
        # ``n - index`` points past the axes for the default -1)
        self._redshift_index = (
            redshift_input_index
            if redshift_input_index >= 0
            else self._n_input_dimensions + redshift_input_index
        )
        if self._n_input_dimensions == 0:
            raise IndexError("No input dimensions were specified for table interpolation construction.")
        if np.ndim(table) != self._n_input_dimensions:
            raise IndexError(
                f"Interpolation table has {np.ndim(table)} dimensions but "
                f"{self._n_input_dimensions} arrays were used to specify the table positions."
            )
        self.device = torch.device(device)
        self._table = _on(table, self.device)
        self._positions = tuple(_on(p, self.device) for p in table_positions)

    def __call__(self, gas_state) -> Tensor:
        """Interpolate at (N, D) gas-state rows; -inf outside the grid."""
        return regular_grid_interpolate(
            self._positions, self._table, gas_state, fill_value=-float("inf"), device=self.device
        )

    def evaluate_at_redshift(self, gas_state, redshift: float) -> Tensor:
        """Insert a constant-redshift column at the configured axis
        position. A 3-D table is first collapsed to its plane at that
        redshift (:meth:`table_at_redshift`), the same values as the full-D
        lookup; a redshift outside the table's axis gives -inf for every
        row, as the full-D lookup does."""
        gas_state = _on(gas_state, self.device)
        if self._n_input_dimensions == 3 and gas_state.shape[1] == 2:
            axes2, table2 = self.table_at_redshift(redshift)
            return regular_grid_interpolate(axes2, table2, gas_state, fill_value=-float("inf"), device=self.device)
        n = gas_state.shape[0]
        formatted = torch.empty((n, self._n_input_dimensions), dtype=torch.float64, device=self.device)
        mask = torch.arange(self._n_input_dimensions) != self._redshift_index
        formatted[:, mask.to(self.device)] = gas_state.to(torch.float64)
        formatted[:, self._redshift_index] = float(redshift)
        return self(formatted)

    def table_at_redshift(self, redshift: float):
        """Collapse the redshift axis at a constant z: the remaining axes and
        the linearly blended table of one lower dimension, tensors on the
        table's device. A redshift outside the axis gives a table of -inf
        (every lookup then returns -inf, as the full-D lookup does)."""
        zi = self._redshift_index
        ax = self._positions[zi].cpu().numpy()
        axes2 = tuple(p for d, p in enumerate(self._positions) if d != zi)
        if not ax[0] <= redshift <= ax[-1]:
            shape = tuple(s for d, s in enumerate(self._table.shape) if d != zi)
            return axes2, torch.full(shape, -float("inf"), dtype=self._table.dtype, device=self.device)
        i = int(np.clip(np.searchsorted(ax, redshift, side="right") - 1, 0, ax.shape[0] - 2))
        w = float((redshift - ax[i]) / (ax[i + 1] - ax[i]))
        lo = self._table.select(zi, i)
        hi = self._table.select(zi, i + 1)
        return axes2, (1.0 - w) * lo + w * hi

    @property
    def number_of_input_dimensions(self) -> int:
        return self._n_input_dimensions

    @property
    def ionisation_fraction_table(self) -> np.ndarray:
        return self._table.cpu().numpy().copy()

    def get_table_dimension(self, dimension: int) -> np.ndarray:
        return self._positions[dimension].cpu().numpy().copy()


def _on(a, device) -> Tensor:
    if isinstance(a, Tensor):
        return a.to(device)
    return torch.as_tensor(np.asarray(a), device=device)
