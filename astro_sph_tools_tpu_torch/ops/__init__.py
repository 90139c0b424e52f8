"""Device-side operations: the 2D and 3D deposit engines, sightlines and spectra.

Counterpart: ``astro_sph_tools_tpu/ops/__init__.py`` (the ported slices: the
plain torch stencil engine, the sorted tile engine, the coherent-order
engine, the sightline column and absorption-spectra engines, the 3D voxel
engines, periodic-box geometry, ID-matched reordering and regular-grid
interpolation; the neighbour searches are still to port). As in
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
from .grid3d import GridSpec, deposit_3d
from .grid3d_tiled import (
    PALLAS_3D_LEVELS,
    Pallas3DConfig,
    Tiled3DParticles,
    deposit_3d_auto,
    deposit_3d_pallas,
    deposit_3d_tiled,
    tile_particles_3d,
)
from .interp import cubic_spline_1d, regular_grid_interpolate
from .periodic import (
    calculate_periodic,
    make_periodic,
    shift_centre,
    shift_origin,
    wrapped_displacement,
    wrapped_distance,
)
from .reorder import ArrayMapping, ArrayReorder, MatchPlan, match_ids
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
    "ArrayMapping",
    "ArrayReorder",
    "MatchPlan",
    "calculate_periodic",
    "make_periodic",
    "match_ids",
    "shift_centre",
    "shift_origin",
    "wrapped_displacement",
    "wrapped_distance",
    "CoherentCaps",
    "CoherentLayout",
    "GridSpec",
    "MapSpec",
    "PALLAS_3D_LEVELS",
    "PALLAS_LEVELS",
    "Pallas3DConfig",
    "PallasDepositConfig",
    "Tiled3DParticles",
    "TiledParticles",
    "absorption_spectra",
    "absorption_spectra_binned",
    "absorption_spectra_pallas",
    "caps_from_layout",
    "caps_union",
    "column_integrate",
    "column_integrate_binned",
    "column_integrate_pallas",
    "cubic_spline_1d",
    "deposit_2d",
    "deposit_2d_auto",
    "deposit_2d_coherent",
    "deposit_2d_coherent_fused",
    "deposit_2d_fixed_h",
    "deposit_2d_pallas",
    "deposit_3d",
    "deposit_3d_auto",
    "deposit_3d_pallas",
    "deposit_3d_tiled",
    "deposit_coherent",
    "deposit_tiled",
    "deposit_tiles",
    "deposit_tiles_plain",
    "deposit_weighted_mean",
    "doppler_parameter_kms",
    "los_profiles",
    "regular_grid_interpolate",
    "tile_particles",
    "tile_particles_3d",
    "tile_particles_coherent",
    "tiled_particles_from_arrays",
    "voigt_damping_kms",
    "voigt_hjerting",
]
