"""Entry: ``render_sightlines`` over a snapshot served from memory.

A product is one call, ending with its NumPy columns and spectra on the
host: one answer, the columns' 2D view (``reference/los_spectra.py::
columns_view``) under ``surface_density``, the name ``compare.py`` needs,
and the spectra under ``tau``. The rays are the inputs' (drawn from the
seed), the same every product. ``render_sightlines`` is imported here, so a
program without it fails at set-up.
"""

from astro_sph_tools_tpu_torch import render_sightlines
from astro_sph_tools_tpu_torch.data_structures.particle_types import CoordinateAxes
from astro_sph_tools_tpu_torch.io.memory import MemorySnapshot
from sphbench.reference.los_spectra import columns_view

SNAPSHOT_FIELDS = ("positions", "smoothing_lengths", "masses", "velocities", "temperatures")


def setup(ctx):
    snapshot = ctx.config["snapshot"]
    snap = MemorySnapshot({k: ctx.inputs[k] for k in SNAPSHOT_FIELDS}, ctx.inputs["box"],
                          redshift=float(snapshot["redshift"]), hubble_param=float(snapshot["hubble_h"]),
                          omega_baryon=float(snapshot["omega_b"]))
    product = ctx.config["product"]
    kw = dict(axis=CoordinateAxes.from_string(product["axis"]), kernel=ctx.config["kernel"], spectra=True,
              n_bins=int(product["n_bins"]), profile=product["profile"], gamma=float(product["gamma_per_s"]),
              rest_wavelength_angstrom=float(product["rest_wavelength_angstrom"]),
              atomic_weight=float(product["atomic_weight"]), periodic=bool(product["periodic"]), device=ctx.device)
    if "engine" in ctx.traffic:
        kw["engine"] = ctx.traffic["engine"]
    rx, ry = ctx.inputs["ray_x"], ctx.inputs["ray_y"]

    def call():
        los = render_sightlines(snap, rx, ry, **kw)
        return [{"surface_density": columns_view(los.columns), "tau": los.tau}], dict(los.timings)

    return call
