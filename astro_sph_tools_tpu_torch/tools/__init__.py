"""Analysis-tools namespace (reference-API-compatible re-exports).

Counterpart: ``astro_sph_tools_tpu/tools/__init__.py``; re-exports only what
the ported slices have (the 2D deposit engines, sightlines and spectra)."""

from ..ops.deposit import MapSpec, deposit_2d, deposit_weighted_mean
from ..ops.deposit_tiled import deposit_2d_auto, deposit_2d_pallas
from ..ops.sightlines import column_integrate, los_profiles
from ..ops.spectra import absorption_spectra, doppler_parameter_kms

__all__ = [
    "MapSpec",
    "absorption_spectra",
    "column_integrate",
    "deposit_2d",
    "deposit_2d_auto",
    "deposit_2d_pallas",
    "deposit_weighted_mean",
    "doppler_parameter_kms",
    "los_profiles",
]
