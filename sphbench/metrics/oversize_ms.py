"""oversize_ms: the oversize route, the self device time of the span
``deposit.oversize`` (``ops/deposit.py::deposit_2d`` on the particles too
wide for kernel #1's levels: stencils, wide windows, ``index_add_``, the
dense pass), summed over the traced window, a product's mean (ms); none
where the program records no such span or no device time."""

from sphbench.spanread import self_ms


def read(run):
    return self_ms(run, "deposit.oversize")
