"""Port vs JAX: the plain 3D voxel stencil engine (BASELINE config 3, scaled down).

The same seeded NumPy inputs go to ``astro_sph_tools_tpu.ops.grid3d`` and to
``astro_sph_tools_tpu_torch.ops.grid3d`` (on the CPU), and both are held
against the f64 oracle ``oracles.grid3d_oracle``. Bounds: 1e-5 * max against
the oracle (the fidelity budget); 2e-5 * max between the two f32 engines,
which convert positions to f32 voxel coordinates with different rounding (XLA
on the CPU does not round f32 division and sqrt as IEEE does).
"""

import numpy as np
import pytest
import torch

from astro_sph_tools_tpu.ops import grid3d as J
from astro_sph_tools_tpu_torch.ops import grid3d as T
from oracles import grid3d_oracle

TOL = 1e-5
PATH_TOL = 2e-5
EXT = (0.0, 10.0, 0.0, 10.0, 0.0, 10.0)


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def both(pos, h, values, shape, *, periodic=False, origin="center", **kw):
    """(port, jax) grids of the same inputs."""
    got = T.deposit_3d(
        pos, h, values, T.GridSpec(shape, EXT, voxel_origin=origin, periodic_wrap=periodic), device="cpu", **kw
    )
    ref = J.deposit_3d(pos, h, values, J.GridSpec(shape, EXT, voxel_origin=origin, periodic_wrap=periodic), **kw)
    return got.numpy(), np.asarray(ref)


def test_matches_oracle(rng):
    n = 400
    pos = rng.uniform(0, 10.0, (n, 3))
    h = rng.uniform(0.4, 1.2, n)
    m = rng.uniform(0.5, 2.0, n)
    got, ref = both(pos, h, m, (16, 16, 16), chunk=512)
    assert got.shape == (16, 16, 16)
    assert rel_err(got, grid3d_oracle(pos, h, m, (16, 16, 16), EXT)) < TOL
    assert rel_err(got, ref) < PATH_TOL


def test_periodic(rng):
    n = 200
    pos = rng.uniform(0, 10.0, (n, 3))
    pos[:30, 0] = rng.uniform(0, 0.3, 30)  # edge-hugging
    h = np.full(n, 0.8)
    m = np.ones(n)
    got, ref = both(pos, h, m, (12, 12, 12), periodic=True, chunk=512)
    assert rel_err(got, grid3d_oracle(pos, h, m, (12, 12, 12), EXT, periodic=True)) < TOL
    assert rel_err(got, ref) < PATH_TOL


def test_mass_conservation(rng):
    """The density grid's volume integral approximates the total mass for
    well-resolved kernels away from the edges."""
    n = 300
    pos = rng.uniform(3.0, 7.0, (n, 3))
    h = rng.uniform(0.5, 0.8, n)
    m = rng.uniform(0.5, 2.0, n)
    spec = T.GridSpec(shape=(48, 48, 48), extent=EXT)
    got = T.deposit_3d(pos, h, m, spec, chunk=512, device="cpu").numpy()
    assert abs(got.sum() * np.prod(spec.voxel_size) / m.sum() - 1.0) < 2e-2


def test_oversize_and_rect(rng):
    n = 40
    pos = rng.uniform(0, 10.0, (n, 3))
    h = np.full(n, 0.5)
    h[:3] = 6.0  # oversize footprint: the dense pass
    m = np.ones(n)
    got, ref = both(pos, h, m, (8, 12, 16), chunk=512)
    assert got.shape == (8, 12, 16)
    assert rel_err(got, grid3d_oracle(pos, h, m, (8, 12, 16), EXT)) < TOL
    assert rel_err(got, ref) < PATH_TOL


def test_multifield_velocity_cube(rng):
    """Density and momentum cubes in one pass (config 3's density/velocity)."""
    n = 200
    pos = rng.uniform(0, 10.0, (n, 3))
    h = rng.uniform(0.5, 1.0, n)
    m = rng.uniform(0.5, 2.0, n)
    vx = rng.normal(0, 100.0, n)
    got, ref = both(pos, h, np.stack([m, m * vx], axis=1), (12, 12, 12), chunk=512)
    assert got.shape == (12, 12, 12, 2)
    assert rel_err(got[..., 0], grid3d_oracle(pos, h, m, (12, 12, 12), EXT)) < TOL
    assert rel_err(got[..., 1], grid3d_oracle(pos, h, m * vx, (12, 12, 12), EXT)) < TOL
    assert rel_err(got, ref) < PATH_TOL


def test_voxel_origin_corner(rng):
    n = 300
    pos = rng.uniform(0, 10.0, (n, 3))
    h = rng.uniform(0.4, 1.0, n)
    m = rng.uniform(0.5, 2.0, n)
    got, ref = both(pos, h, m, (16, 16, 16), origin="corner", chunk=512)
    assert rel_err(got, grid3d_oracle(pos, h, m, (16, 16, 16), EXT, voxel_origin="corner")) < TOL
    assert rel_err(got, ref) < PATH_TOL


@pytest.mark.parametrize("periodic", [(True, True, False), (False, True, True), (True, False, True)])
def test_per_axis_periodic_stencil_pass(periodic):
    """The stencil pass takes an (x, y, z) periodicity tuple, as the JAX
    pass does for the slab-sharded deposit."""
    rng = np.random.default_rng(7 + sum(i * p for i, p in enumerate(periodic)))
    n, K, shape = 256, 8, (12, 12, 12)
    pos = rng.uniform(-0.5, 10.5, (n, 3)).astype(np.float32)
    h = rng.uniform(0.5, 1.2, n).astype(np.float32)
    vals = rng.uniform(0.5, 2.0, (n, 2)).astype(np.float32)
    static = dict(K=K, shape=shape, extent=EXT, offset=0.5, periodic=periodic, kernel_name="cubic_spline", chunk=64)
    ref = np.asarray(J._stencil_level_pass_3d(
        J.jnp.zeros((12 * 12 * 12, 2), J.jnp.float32), pos[:, 0], pos[:, 1], pos[:, 2], h, vals, **static
    ))
    t = [torch.from_numpy(a) for a in (pos[:, 0], pos[:, 1], pos[:, 2], h, vals)]
    got = T._stencil_level_pass_3d(torch.zeros((12 * 12 * 12, 2)), *t, **static).numpy()
    assert rel_err(got, ref) < PATH_TOL
    # the tuple differs from the all-periodic and the all-open pass
    for p in (True, False):
        other = T._stencil_level_pass_3d(torch.zeros((12 * 12 * 12, 2)), *t, **{**static, "periodic": p}).numpy()
        assert rel_err(got, other) > 1e-3


def test_grid_spec():
    spec = T.GridSpec(shape=(8, 12, 16), extent=(0.0, 16.0, 0.0, 6.0, 0.0, 2.0))
    assert spec.voxel_size == J.GridSpec((8, 12, 16), (0.0, 16.0, 0.0, 6.0, 0.0, 2.0)).voxel_size == (0.25, 0.5, 1.0)
    assert spec.sample_offset == 0.5
    assert T.GridSpec((8, 8, 8), EXT, voxel_origin="corner").sample_offset == 0.0
    with pytest.raises(ValueError, match="voxel_origin"):
        T.GridSpec((8, 8, 8), EXT, voxel_origin="edge").sample_offset
    with pytest.raises(ValueError, match="periodic"):
        T._per_axis((True, False))
    assert T.STENCIL_LEVELS_3D == J.STENCIL_LEVELS_3D == (2, 4, 8, 16, 32)


def test_accumulates_into_grid(rng):
    n = 100
    pos = rng.uniform(0, 10.0, (n, 3))
    h = rng.uniform(0.5, 1.0, n)
    m = rng.uniform(0.5, 2.0, n)
    spec = T.GridSpec((8, 8, 8), EXT)
    base = torch.ones((8, 8, 8))
    got = T.deposit_3d(pos, h, m, spec, grid=base, device="cpu")
    assert torch.allclose(got, T.deposit_3d(pos, h, m, spec, device="cpu") + 1.0)
    assert bool((base == 1.0).all())  # the caller's accumulator is not modified
