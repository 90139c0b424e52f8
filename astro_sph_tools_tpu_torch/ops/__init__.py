"""Device-side operations: the deposit engines, sightlines and spectra, neighbours.

Counterpart: ``astro_sph_tools_tpu/ops/__init__.py`` (the plain torch
stencil engine, the sorted tile engine, the coherent-order engine, the
sightline column and absorption-spectra engines, the 3D voxel engines,
periodic-box geometry, cell lists and neighbour queries, ID-matched
reordering and regular-grid interpolation). As in
the JAX package, the exported function ``deposit_coherent`` shadows the
module of the same name: import the module with
``importlib.import_module("astro_sph_tools_tpu_torch.ops.deposit_coherent")``.
:func:`kernel_counters` is the registry of the CUDA kernel wrappers."""

from . import deposit_wide as _wide
from .cells import CellList, build_cell_list, linear_cell_id, morton_encode_3d
from .coherent_prep import prep_rows
from .deposit import MapSpec, deposit_2d, deposit_2d_fixed_h, deposit_weighted_mean
from .deposit_coherent import (
    CoherentCaps,
    CoherentLayout,
    caps_from_layout,
    caps_union,
    deposit_2d_coherent,
    deposit_2d_coherent_fused,
    deposit_coherent,
    deposit_coherent_tiles,
    deposit_coherent_windows,
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
    deposit_3d_tiles,
    tile_particles_3d,
)
from .grid3d_wide import deposit_3d_wide
from .interp import cubic_spline_1d, regular_grid_interpolate
from .layout_shear import append_gangs
from .neighbors import (
    knn_distances,
    knn_distances_grid,
    nearest_points,
    nearest_points_device,
    nearest_points_grid,
)
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
from .sightlines_fused import column_integrate_pallas, columns_tiles
from .spectra import (
    absorption_spectra,
    absorption_spectra_binned,
    doppler_parameter_kms,
    voigt_damping_kms,
    voigt_hjerting,
)
from .spectra_fused import absorption_spectra_pallas, spectra_tiles


def kernel_counters() -> dict:
    """Every CUDA kernel wrapper of the package by kernel name; each
    carries ``launches``, the launches it made in this process (the CPU
    plain versions count none)."""
    return {"deposit2d": deposit_tiles, "deposit_wide": _wide.deposit_wide, "coherent_prep": prep_rows,
            "coherent_deposit": deposit_coherent_tiles, "coherent_window": deposit_coherent_windows,
            "sightline_columns": columns_tiles, "sightline_spectra": spectra_tiles, "deposit3d": deposit_3d_tiles,
            "deposit3d_wide": deposit_3d_wide, "append_gangs": append_gangs}


__all__ = [
    "ArrayMapping",
    "ArrayReorder",
    "CellList",
    "MatchPlan",
    "build_cell_list",
    "knn_distances",
    "knn_distances_grid",
    "linear_cell_id",
    "morton_encode_3d",
    "nearest_points",
    "nearest_points_device",
    "nearest_points_grid",
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
    "kernel_counters",
    "los_profiles",
    "regular_grid_interpolate",
    "tile_particles",
    "tile_particles_3d",
    "tile_particles_coherent",
    "tiled_particles_from_arrays",
    "voigt_damping_kms",
    "voigt_hjerting",
]
