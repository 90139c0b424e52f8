"""Device-side operations: the 2D deposit engines.

Counterpart: ``astro_sph_tools_tpu/ops/__init__.py`` (the ported slice: the
plain torch stencil engine, the sorted tile engine and the coherent-order
engine). As in the JAX package, the exported function ``deposit_coherent``
shadows the module of the same name: import the module with
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

__all__ = [
    "CoherentCaps",
    "CoherentLayout",
    "MapSpec",
    "PALLAS_LEVELS",
    "PallasDepositConfig",
    "TiledParticles",
    "caps_from_layout",
    "caps_union",
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
    "tile_particles",
    "tile_particles_coherent",
    "tiled_particles_from_arrays",
]
