"""Device-side operations: the 2D deposit engines, sightlines and spectra.

Counterpart: ``astro_sph_tools_tpu/ops/__init__.py`` (the ported slices: the
plain torch stencil engine, the sorted tile engine, the coherent-order
engine, and the sightline column and absorption-spectra engines). As in
the JAX package, the exported function ``deposit_coherent`` shadows the
module of the same name: import the module with
``importlib.import_module("astro_sph_tools_tpu_torch.ops.deposit_coherent")``."""

from .deposit import MapSpec, deposit_2d, deposit_2d_fixed_h, deposit_weighted_mean
from .deposit_coherent import (
    CoherentCaps,
    CoherentLayout,
    caps_from_layout,
    caps_union,
    deposit_2d_coherent,
    deposit_2d_coherent_fused,
    deposit_coherent,
    tile_particles_coherent,
)
from .deposit_tiled import (
    PALLAS_LEVELS,
    PallasDepositConfig,
    TiledParticles,
    deposit_2d_auto,
    deposit_2d_pallas,
    deposit_tiled,
    deposit_tiles,
    deposit_tiles_plain,
    tile_particles,
    tiled_particles_from_arrays,
)
from .sightlines import column_integrate, column_integrate_binned, los_profiles
from .sightlines_fused import column_integrate_pallas
from .spectra import (
    absorption_spectra,
    absorption_spectra_binned,
    doppler_parameter_kms,
    voigt_damping_kms,
    voigt_hjerting,
)
from .spectra_fused import absorption_spectra_pallas

__all__ = [
    "CoherentCaps",
    "CoherentLayout",
    "MapSpec",
    "PALLAS_LEVELS",
    "PallasDepositConfig",
    "TiledParticles",
    "absorption_spectra",
    "absorption_spectra_binned",
    "absorption_spectra_pallas",
    "caps_from_layout",
    "caps_union",
    "column_integrate",
    "column_integrate_binned",
    "column_integrate_pallas",
    "deposit_2d",
    "deposit_2d_auto",
    "deposit_2d_coherent",
    "deposit_2d_coherent_fused",
    "deposit_2d_fixed_h",
    "deposit_2d_pallas",
    "deposit_coherent",
    "deposit_tiled",
    "deposit_tiles",
    "deposit_tiles_plain",
    "deposit_weighted_mean",
    "doppler_parameter_kms",
    "los_profiles",
    "tile_particles",
    "tile_particles_coherent",
    "tiled_particles_from_arrays",
    "voigt_damping_kms",
    "voigt_hjerting",
]
