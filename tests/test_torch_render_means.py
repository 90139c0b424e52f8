"""Every render entry ends the same way (``render.py::_finish``): the
``mean_*`` maps and cubes are derived on the render's device, before the
copy back, by the JAX package's formula ``where(d > 0, n / max(d, 1e-30),
0)`` in f32 over the ``mass`` map where one is rendered, else over the
surface density (the density cube). Here each returned mean is held, bit
for bit, to that NumPy expression applied to the returned weighted and
denominator maps: ``render_map_stack`` on its three engines,
``render_halo_maps`` on its two, and ``render_grid_stack``.
"""

import numpy as np
import pytest
import torch

from astro_sph_tools_tpu_torch import render_grid_stack, render_halo_maps, render_map_stack
from astro_sph_tools_tpu_torch.io.catalogue import BasicHaloDefinitions
from astro_sph_tools_tpu_torch.io.memory import MemoryCatalogue, MemorySnapshot

BOX = 10.0
N = 2000
FIELDS = ("density", "temperature", "metallicity")


@pytest.fixture(scope="module")
def snap():
    rng = np.random.default_rng(11)
    mass = rng.uniform(1.0, 2.0, N)
    return MemorySnapshot({
        "positions": torch.tensor(rng.uniform(0.0, BOX, (N, 3)), dtype=torch.float32),
        "smoothing_lengths": torch.tensor(rng.uniform(0.02, 0.2, N), dtype=torch.float32),
        "masses": torch.tensor(mass, dtype=torch.float32),
        "temperatures": torch.tensor(rng.uniform(1e4, 1e6, N), dtype=torch.float32),
        "metallicities": torch.tensor(rng.uniform(0.0, 0.04, N), dtype=torch.float32),
    }, BOX)


def render(snap, case: str) -> list:
    entry, _, engine = case.partition("-")
    if entry == "map":
        return [render_map_stack(snap, FIELDS, resolution=64, engine=engine, device="cpu")]
    if entry == "map_mass":  # no density: the means are over the added mass map
        return [render_map_stack(snap, ("temperature", "metallicity"), resolution=64, engine=engine, device="cpu")]
    if entry == "halo":
        cat = MemoryCatalogue(snap, np.array([[5.0, 5.0, 5.0], [0.5, 9.5, 5.0]]),
                              {BasicHaloDefinitions.SO_200_CRIT.value: np.array([1.0, 0.8])})
        return render_halo_maps(snap, cat, [0, 1], fields=FIELDS, resolution=48, engine=engine, device="cpu")
    return [render_grid_stack(snap, ("density", "temperature"), resolution=20, kernel="wendland_c2", device="cpu")]


@pytest.mark.parametrize("case", ["map-pallas", "map-coherent", "map-xla", "map_mass-pallas", "halo-pallas",
                                  "halo-xla", "grid"])
def test_means_are_the_jax_formula_of_the_returned_maps(snap, case):
    for stack in render(snap, case):
        means = [k for k in stack.keys() if k.startswith("mean_")]
        assert len(means) == (1 if case == "grid" else 2)
        denom = stack["mass" if "mass" in stack.keys() else ("density" if case == "grid" else "surface_density")]
        assert (denom == 0).any() and (denom > 0).any()  # both branches of the guard
        for name in means:
            weighted = stack[name.replace("mean", "mass_weighted")]
            want = np.where(denom > 0, weighted / np.maximum(denom, 1e-30), 0.0)
            got = stack[name]
            assert isinstance(got, np.ndarray) and got.dtype == want.dtype == np.float32
            assert np.array_equal(got, want), name
