"""Multi-GPU execution on ``torch.distributed``: sharded deposits, the
distributed reorder, rebalancing and rank-parallel reads.

Counterpart: ``astro_sph_tools_tpu/parallel/__init__.py``, the same names
plus :class:`Mesh`. One process per card (``torchrun --nproc-per-node=N``);
every function takes this rank's shard and a :class:`Mesh` from
:func:`make_mesh`, which needs an initialised process group. The entry
points accept the JAX package's ``axis_name=`` so that its calls port
unchanged, and ignore it: a mesh here has one axis, its process group.
"""

from .coherent import (
    caps_union_mesh,
    deposit_2d_coherent_sharded,
    deposit_2d_coherent_sharded_fused,
    pad_particles_mesh,
)
from .mesh import Mesh, make_mesh
from .rebalance import rebalance_evenly
from .reorder import distributed_reorder
from .sharded import (
    deposit_2d_sharded,
    deposit_3d_sharded,
    pad_for_mesh,
    partition_particles_by_slab,
)
from .sharded_io import (
    load_particle_fields_sharded,
    open_process_local_snapshot,
    sharded_from_local,
)
from .sightlines import absorption_spectra_sharded, column_integrate_sharded

__all__ = [
    "Mesh",
    "absorption_spectra_sharded",
    "caps_union_mesh",
    "deposit_2d_coherent_sharded",
    "deposit_2d_coherent_sharded_fused",
    "pad_particles_mesh",
    "column_integrate_sharded",
    "deposit_2d_sharded",
    "deposit_3d_sharded",
    "rebalance_evenly",
    "distributed_reorder",
    "load_particle_fields_sharded",
    "open_process_local_snapshot",
    "sharded_from_local",
    "make_mesh",
    "pad_for_mesh",
    "partition_particles_by_slab",
]
