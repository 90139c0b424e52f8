"""Entry: ``render_halo_maps`` over every halo of an in-memory catalogue.

A product is one call over all the haloes, ending with their NumPy maps on
the host: one answer a halo, its ``MapStack.maps``. The timings are each
phase's seconds summed over the haloes.
"""

from astro_sph_tools_tpu_torch import render_halo_maps
from astro_sph_tools_tpu_torch.data_structures.particle_types import CoordinateAxes
from astro_sph_tools_tpu_torch.io.catalogue import BasicHaloDefinitions
from astro_sph_tools_tpu_torch.io.memory import MemoryCatalogue, MemorySnapshot

SNAPSHOT_FIELDS = ("positions", "smoothing_lengths", "masses", "temperatures", "metallicities")


def setup(ctx):
    inputs = ctx.inputs
    snap = MemorySnapshot({k: inputs[k] for k in SNAPSHOT_FIELDS}, inputs["box"])
    catalogue = MemoryCatalogue(snap, inputs["halo_centres"],
                                {BasicHaloDefinitions.SO_200_CRIT.value: inputs["halo_r200"]})
    haloes = list(range(len(inputs["halo_r200"])))
    product = ctx.config["product"]
    kw = dict(fields=tuple(product["fields"]), resolution=int(product["resolution"]), kernel=ctx.config["kernel"],
              axis=CoordinateAxes.from_string(product["axis"]), radius_multiple=float(product["radius_multiple"]),
              device=ctx.device)
    if "engine" in ctx.traffic:
        kw["engine"] = ctx.traffic["engine"]

    def call():
        stacks = render_halo_maps(snap, catalogue, haloes, **kw)
        timings: dict = {}
        for s in stacks:
            for k, v in s.timings.items():
                timings[k] = timings.get(k, 0.0) + v
        return [dict(s.maps) for s in stacks], timings

    return call
