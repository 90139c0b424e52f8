"""grid3d_level_ms: kernel #6 over the 3D layout's levels, the self device
time of the span ``deposit3d.levels``, summed over the traced window, a
product's mean (ms); none where the program records no such span or no
device time."""

from sphbench.spanread import self_ms


def read(run):
    return self_ms(run, "deposit3d.levels")
