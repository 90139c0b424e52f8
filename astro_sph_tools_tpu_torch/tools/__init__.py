"""Analysis-tools namespace (reference-API-compatible re-exports).

Counterpart: ``astro_sph_tools_tpu/tools/__init__.py``: the 2D and 3D
deposit engines, sightlines and spectra, periodic-box geometry with the
reference's ``calculate_wrapped_*`` names, ``ArrayReorder`` /
``ArrayMapping`` (and the reference's ``ArrayReorder_2`` name), and the
*working* projection surface the reference only
intended (``tools.projections``, broken in-tree — SURVEY.md §2.9.1)."""

from ..ops.deposit import MapSpec, deposit_2d, deposit_weighted_mean
from ..ops.deposit_tiled import deposit_2d_auto, deposit_2d_pallas
from ..ops.grid3d import GridSpec, deposit_3d
from ..ops.grid3d_tiled import deposit_3d_auto, deposit_3d_pallas
from ..ops.periodic import (
    calculate_periodic,
    make_periodic,
    shift_centre,
    shift_origin,
    wrapped_displacement,
    wrapped_distance,
)
from ..ops.reorder import ArrayMapping, ArrayReorder
from ..ops.sightlines import column_integrate, los_profiles
from ..ops.spectra import absorption_spectra, doppler_parameter_kms
from . import projections
from .projections import create_image, quartic_spline_kernel

# reference naming aliases
calculate_wrapped_displacement = wrapped_displacement
calculate_wrapped_distance = wrapped_distance

# The reference also exports ArrayReorder_2 (its same-semantics v2 rewrite,
# `tools/_ArrayReorder.py:660`) and the MPI variants (`:88,262`). Here the
# modern ArrayReorder IS the v2 semantics, and the distributed engine lives
# in ``parallel.distributed_reorder`` (owner-sharded all_to_all exchange).
ArrayReorder_2 = ArrayReorder


def ArrayReorder_MPI(*args, **kwargs):  # pragma: no cover - guidance shim
    raise NotImplementedError(
        "ArrayReorder_MPI is replaced by "
        "astro_sph_tools_tpu_torch.parallel.distributed_reorder (owner-sharded "
        "all_to_all exchange over torch.distributed)."
    )


ArrayReorder_MPI_2 = ArrayReorder_MPI

__all__ = [
    "ArrayMapping",
    "ArrayReorder",
    "ArrayReorder_2",
    "ArrayReorder_MPI",
    "ArrayReorder_MPI_2",
    "create_image",
    "projections",
    "quartic_spline_kernel",
    "calculate_periodic",
    "calculate_wrapped_displacement",
    "calculate_wrapped_distance",
    "make_periodic",
    "shift_centre",
    "shift_origin",
    "wrapped_displacement",
    "wrapped_distance",
    "GridSpec",
    "MapSpec",
    "absorption_spectra",
    "column_integrate",
    "deposit_2d",
    "deposit_2d_auto",
    "deposit_2d_pallas",
    "deposit_3d",
    "deposit_3d_auto",
    "deposit_3d_pallas",
    "deposit_weighted_mean",
    "doppler_parameter_kms",
    "los_profiles",
]
