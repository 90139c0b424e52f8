"""grid3d_oversize_pct: the share of particles the 3D layout sends to the
oversize route, 100 * the sum of the counter ``n_oversize`` over the sum of
``particles`` of the spans ``layout.grid3d`` in the traced window (%); none
where the program records no such span."""

from sphbench.spanread import share_pct


def read(run):
    return share_pct("layout.grid3d", "n_oversize")
