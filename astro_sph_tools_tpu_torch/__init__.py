"""astro_sph_tools_tpu_torch — the PyTorch + CUDA port of astro_sph_tools_tpu.

Counterpart: ``astro_sph_tools_tpu/__init__.py``. The same public names and
conventions (co-moving, h-full, Mpc / Msun / km/s / K), so that a user's
script ports by changing only the import; the hot deposit runs in a
hand-written CUDA kernel for Hopper (``csrc/deposit2d.cu``).

Importing the package imports torch and NumPy only: the HDF5 readers
import ``h5py`` on their first read (``io/_lazy.py``). Importing it also
calls the CPU math functions once on small tensors (``_cpu_math.py``).
"""

from .__about__ import __version__
from ._cpu_math import warm_cpu_math

# the CPU math library's first calls, made here on one thread: a first call
# split over the intra-op threads can come back wrong (_cpu_math.py)
warm_cpu_math()

from .data_structures import Cosmology, CoordinateAxes, ParticleType
from .render import MapStack, render_halo_maps, render_map_stack
from .units import UnitArray, unit_array, unit_quantity

__all__ = [
    "__version__",
    "Cosmology",
    "ParticleType",
    "CoordinateAxes",
    "UnitArray",
    "unit_array",
    "unit_quantity",
    "MapStack",
    "render_halo_maps",
    "render_map_stack",
]
