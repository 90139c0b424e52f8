"""Analysis-tools namespace (reference-API-compatible re-exports).

Counterpart: ``astro_sph_tools_tpu/tools/__init__.py``; re-exports only what
the ported slices have (the 2D and 3D deposit engines, sightlines and
spectra, periodic-box geometry with the reference's ``calculate_wrapped_*``
names, and ``ArrayReorder`` / ``ArrayMapping``)."""

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

# reference naming aliases
calculate_wrapped_displacement = wrapped_displacement
calculate_wrapped_distance = wrapped_distance

__all__ = [
    "ArrayMapping",
    "ArrayReorder",
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
