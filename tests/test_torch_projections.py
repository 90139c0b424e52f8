"""Port vs JAX: the reference's ``tools.projections`` surface.

``create_image`` against JAX's (its Pallas deposit kernel in interpret mode)
on a square and a non-square image of at most 64^2 pixels, for each way of
naming the kernel, and against the f64 oracle of ``tests/oracles.py`` with
the reference's conventions (corner sampling, ``img[xi, yi]``, each axis's
own pixel size); ``quartic_spline_kernel`` against JAX's on the same radii.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from astro_sph_tools_tpu.data_structures import CoordinateAxes as JAxes
from astro_sph_tools_tpu.tools import projections as J
from astro_sph_tools_tpu_torch.data_structures import CoordinateAxes
from astro_sph_tools_tpu_torch.kernels.splines import wendland_c2_kernel
from astro_sph_tools_tpu_torch.tools import projections as T
from oracles import project_oracle_fast


def particles(n=1500, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 1.0, (n, 3))
    h = rng.uniform(0.02, 0.08, n)
    mass = rng.uniform(0.5, 1.5, n)
    return pos, h, mass


@pytest.mark.parametrize("size,axis,kernel", [
    ((64, 64), "Z", None), ((48, 32), "X", "wendland_c2"), ((40, 56), "Y", "callable"),
], ids=["square", "non_square_x", "non_square_y_callable"])
def test_create_image_matches_jax_and_the_oracle(size, axis, kernel):
    pos, h, mass = particles()
    kw = dict(x_min=0.1, x_max=0.9, y_min=0.05, y_max=0.95)
    t_kernel = wendland_c2_kernel if kernel == "callable" else kernel
    j_kernel = "wendland_c2" if kernel == "callable" else kernel
    got = T.create_image(pos, h, mass, size, projection_axis=CoordinateAxes[axis], kernel_func=t_kernel,
                         device="cpu", **kw)
    ref = J.create_image(pos, h, mass, size, projection_axis=JAxes[axis], kernel_func=j_kernel, **kw)
    assert got.shape == ref.shape == size and got.dtype == np.float64
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    i, j = CoordinateAxes[axis].projection_plane
    oracle = project_oracle_fast(pos[:, i], pos[:, j], h, mass, (size[1], size[0]),
                                 (kw["x_min"], kw["x_max"], kw["y_min"], kw["y_max"]),
                                 kernel=j_kernel or "cubic_spline", pixel_origin="corner").T
    assert np.abs(got - oracle).max() <= 1e-5 * np.abs(oracle).max()


def test_quartic_spline_kernel_matches_jax():
    r = np.linspace(0.0, 2.5, 501, dtype=np.float32)
    h = np.full_like(r, 0.9)
    got = T.quartic_spline_kernel(torch.as_tensor(r), torch.as_tensor(h)).numpy()
    np.testing.assert_allclose(got, np.asarray(J.quartic_spline_kernel(jnp.asarray(r), jnp.asarray(h))),
                               rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="kernel_func"):
        T.create_image(*particles(10), (8, 8), kernel_func=len, device="cpu")
