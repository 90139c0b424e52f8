"""routed_pct: the share of particles the coherent layout routes to kernel
#1's levels and the oversize route, 100 * the sum of the counter
``routed_particles`` over the sum of ``particles`` of the spans
``layout.coherent`` in the traced window (%); none where the program
records no such span."""

from sphbench.spanread import share_pct


def read(run):
    return share_pct("layout.coherent", "routed_particles")
