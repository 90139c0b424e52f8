"""grid3d_deposit_roofline: a product's least time on the card
(``reference/box_cube.py::work``: its bytes over the peak bandwidth or its
FP32 operations over the peak rate, whichever is longer, counted from the
problem) over the self device time of the 3D deposit's two kernels, the
spans ``deposit3d.levels`` (kernel #6) and ``deposit3d.oversize`` (the
oversize route), summed over the traced window a product (%). One share
over both: where the levels end and the route begins is the program's
choice. None where the program records neither span or no device time."""

from sphbench.spanread import self_ms


def read(run):
    ms = self_ms(run, "deposit3d.levels", "deposit3d.oversize")
    return 100.0 * run.work()["seconds"] / (ms / 1e3) if ms else None
