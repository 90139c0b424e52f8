"""Entry: ``render_grid_stack`` over a snapshot served from memory.

A product is one call, ending with its NumPy cubes on the host: one answer,
the call's ``MapStack.maps``, each cube as its (nz * ny, nx) view and the
density cube named ``surface_density``, the names ``compare.py`` reads (see
``reference/box_cube.py``). ``render_grid_stack`` is imported here, so a
program without it fails at set-up.
"""

from astro_sph_tools_tpu_torch import render_grid_stack
from astro_sph_tools_tpu_torch.io.memory import MemorySnapshot

SNAPSHOT_FIELDS = ("positions", "smoothing_lengths", "masses", "temperatures", "metallicities")
#: the program's cube names that ``compare.py`` reads under another name
NAMES = {"density": "surface_density"}


def setup(ctx):
    snap = MemorySnapshot({k: ctx.inputs[k] for k in SNAPSHOT_FIELDS}, ctx.inputs["box"])
    product = ctx.config["product"]
    kw = dict(fields=tuple(product["fields"]), resolution=int(product["resolution"]), kernel=ctx.config["kernel"],
              device=ctx.device)

    def call():
        stack = render_grid_stack(snap, **kw)
        return [{NAMES.get(k, k): c.reshape(-1, c.shape[-1]) for k, c in stack.maps.items()}], dict(stack.timings)

    return call
