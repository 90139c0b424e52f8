"""coherent_layout_ms: the coherent layout's self device time, span
``layout.coherent`` (``ops/deposit_coherent.py::tile_particles_coherent``:
stage A, kernel #3 or the row sort, the one host sync, the tail's gather
and sort), summed over the traced window, a product's mean (ms); none where
the program records no such span or no device time."""

from sphbench.spanread import self_ms


def read(run):
    return self_ms(run, "layout.coherent")
