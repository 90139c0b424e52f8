"""grid3d_layout_ms: the 3D layout's self device time, span
``layout.grid3d`` (``ops/grid3d_tiled.py::tile_particles_3d``: the level
and tile keys, the sort, the gathers, the per-level counts), summed over
the traced window, a product's mean (ms); none where the program records
no such span or no device time."""

from sphbench.spanread import self_ms


def read(run):
    return self_ms(run, "layout.grid3d")
