"""Entry: ``render_map_stack`` over a snapshot served from memory.

A product is one call, ending with its NumPy maps on the host: one answer,
the call's ``MapStack.maps``. The engine is the traffic's ``engine`` where
it names one, else the program's default.
"""

from astro_sph_tools_tpu_torch import render_map_stack
from astro_sph_tools_tpu_torch.data_structures.particle_types import CoordinateAxes
from astro_sph_tools_tpu_torch.io.memory import MemorySnapshot

SNAPSHOT_FIELDS = ("positions", "smoothing_lengths", "masses", "temperatures", "metallicities")


def setup(ctx):
    snap = MemorySnapshot({k: ctx.inputs[k] for k in SNAPSHOT_FIELDS}, ctx.inputs["box"])
    product = ctx.config["product"]
    kw = dict(fields=tuple(product["fields"]), resolution=int(product["resolution"]), kernel=ctx.config["kernel"],
              axis=CoordinateAxes.from_string(product["axis"]), device=ctx.device)
    if "engine" in ctx.traffic:
        kw["engine"] = ctx.traffic["engine"]

    def call():
        stack = render_map_stack(snap, **kw)
        return [dict(stack.maps)], dict(stack.timings)

    return call
