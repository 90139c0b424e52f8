"""Port vs JAX: the plain stencil engine ``ops/deposit.py::deposit_2d``.

The same NumPy particles (made from a seed) go through the JAX package's
``ops.deposit.deposit_2d`` (XLA on the CPU) and the port's (torch on the
CPU). Bound: max |port - jax| <= 1e-5 * max |jax|, the fidelity budget
both engines are held to against the f64 oracle. It is not tighter because
XLA on the CPU does not round f32 division and square root as IEEE does
(about 20 % of ``x / psx`` and 11 % of ``sqrt`` results differ by an ulp
from torch's), and a sub-pixel footprint amplifies an ulp of pixel position
to a few 1e-6 of the map's maximum.
"""

import numpy as np
import pytest
import torch

from astro_sph_tools_tpu.ops import deposit as J
from astro_sph_tools_tpu_torch.ops import deposit as T

BOX = 10.0


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


CASES = {
    "kernel3d": dict(),
    "integrated": dict(projection="integrated"),
    "periodic": dict(periodic_wrap=True),
    "corner": dict(pixel_origin="corner"),
    "multifield": dict(n_fields=3),
    "oversize": dict(oversize=True),
    "wendland_c4": dict(kernel="wendland_c4"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_deposit_2d_matches_jax(case):
    opts = dict(CASES[case])
    rng = np.random.default_rng(sorted(CASES).index(case))
    n, npix = 600, 48
    px = BOX / npix
    x = rng.uniform(0, BOX, n)
    y = rng.uniform(0, BOX, n)
    x[:40] = rng.uniform(0, 0.2, 40)  # edge-hugging: off-image / wrapped footprints
    h = 10.0 ** rng.uniform(-0.2, 0.9, n) * px
    if opts.pop("oversize", False):
        h[:3] = 40.0 * px  # beyond the largest stencil: the dense path
    n_fields = opts.pop("n_fields", 1)
    vals = rng.uniform(0.5, 2.0, (n, n_fields)) if n_fields > 1 else rng.uniform(0.5, 2.0, n)
    kernel = opts.pop("kernel", "cubic_spline")
    projection = opts.pop("projection", "kernel3d")
    spec_kw = dict(shape=(npix, npix), extent=(0.0, BOX, 0.0, BOX), **opts)

    ref = np.asarray(J.deposit_2d(x, y, h, vals, J.MapSpec(**spec_kw), kernel=kernel, projection=projection))
    got = T.deposit_2d(
        x, y, h, vals, T.MapSpec(**spec_kw), kernel=kernel, projection=projection, device="cpu"
    )
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert tuple(got.shape) == ref.shape
    assert rel_err(got, ref) <= 1e-5


def test_binning_and_weighted_mean():
    rng = np.random.default_rng(7)
    n, npix = 400, 32
    spec_kw = dict(shape=(npix, npix), extent=(0.0, BOX, 0.0, BOX))
    x, y = rng.uniform(0, BOX, n), rng.uniform(0, BOX, n)
    h = 10.0 ** rng.uniform(-0.2, 1.3, n) * BOX / npix
    t = rng.uniform(1e4, 1e6, n)
    m = rng.uniform(0.5, 2.0, n)

    jl, jo = J.bin_particles_by_footprint(h, J.MapSpec(**spec_kw).pixel_size, 2.0)
    tl, to = T.bin_particles_by_footprint(h, T.MapSpec(**spec_kw).pixel_size, 2.0)
    assert all(np.array_equal(a, b.numpy()) for a, b in zip(jl, tl))
    assert np.array_equal(jo, to.numpy())

    jmean, jw = J.deposit_weighted_mean(x, y, h, t, m, J.MapSpec(**spec_kw))
    tmean, tw = T.deposit_weighted_mean(x, y, h, t, m, T.MapSpec(**spec_kw), device="cpu")
    assert rel_err(tw, jw) <= 1e-5
    # the mean divides two maps: compare where the weight map is not tiny
    covered = np.asarray(jw) > 1e-3 * np.asarray(jw).max()
    assert rel_err(tmean.numpy()[covered], np.asarray(jmean)[covered]) <= 1e-5


def test_fixed_h_matches_jax():
    rng = np.random.default_rng(8)
    n, npix = 512, 32
    spec_kw = dict(shape=(npix, npix), extent=(0.0, BOX, 0.0, BOX))
    x, y = rng.uniform(0, BOX, n), rng.uniform(0, BOX, n)
    h = rng.uniform(0.5, 1.2, n) * BOX / npix
    m = rng.uniform(0.5, 2.0, n)
    import jax.numpy as jnp

    ref = J.deposit_2d_fixed_h(
        *(jnp.asarray(a, jnp.float32) for a in (x, y, h, m)), J.MapSpec(**spec_kw), K=8, chunk=256
    )
    got = T.deposit_2d_fixed_h(
        *(torch.as_tensor(a, dtype=torch.float32) for a in (x, y, h, m)), T.MapSpec(**spec_kw), K=8, chunk=256
    )
    assert rel_err(got, ref) <= 1e-5


@pytest.mark.parametrize("periodic", [True, False])
def test_wide_windows_match_the_oracle_and_the_dense_pass(periodic, monkeypatch):
    """Footprints past K = 64 take the wide windows (128, then 256 on a
    256^2 map; 512 and 1024 do not fit it, so the largest go dense); the
    map equals the f64 oracle within 1e-5 * max and the all-dense route
    (``WIDE_LEVELS = ()``, the JAX engine's) within 1e-6 * max."""
    from oracles import project_oracle_fast

    rng = np.random.default_rng(61)
    n, npix = 300, 256
    spec = T.MapSpec(shape=(npix, npix), extent=(0.0, BOX, 0.0, BOX), periodic_wrap=periodic)
    x = rng.uniform(0.0, BOX, n)
    y = rng.uniform(0.0, BOX, n)
    px = BOX / npix
    h = px * np.concatenate([rng.uniform(16.0, 30.0, 100), rng.uniform(33.0, 62.0, 100),
                             rng.uniform(70.0, 120.0, 100)])  # K = 128, 256 and dense
    m = rng.uniform(0.5, 2.0, n)
    got = T.deposit_2d(x, y, h, m, spec, device="cpu").numpy()
    oracle = project_oracle_fast(x, y, h, m, spec.shape, spec.extent, periodic=periodic)
    assert rel_err(got, oracle) <= 1e-5
    monkeypatch.setattr(T, "WIDE_LEVELS", ())
    dense = T.deposit_2d(x, y, h, m, spec, device="cpu").numpy()
    assert rel_err(got, dense) <= 1e-6
