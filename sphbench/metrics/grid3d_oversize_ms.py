"""grid3d_oversize_ms: the 3D oversize route, the self device time of the
span ``deposit3d.oversize`` (the particles too wide for kernel #6's levels:
the binning into tile lists and the route's kernel), summed over the traced
window, a product's mean (ms); none where the program records no such span
or no device time."""

from sphbench.spanread import self_ms


def read(run):
    return self_ms(run, "deposit3d.oversize")
