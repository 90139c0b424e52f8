"""The port's sharded coherent engines held to the JAX package's
``deposit_2d_coherent_sharded`` on ``make_mesh(4)`` of the 8 virtual CPU
devices, and to the f64 oracle of ``tests/oracles.py`` at the input
coordinates.

Four gloo ranks are spawned once for the file (``torch_dist.RankPool``);
each engine runs on the four and on one rank alone. The particles are
``test_torch_parallel.coherent_set``'s with every support at least 0.3 px:
below that, the f32 rounding of a position (~1e-5 px at 64 px) moves a
footprint's peak by ~4e-5 of the max, so two f32 engines that place
particles in different frames (the JAX package's and the port's) part by
more than 2e-5 (``test_torch_coherent.py::test_random_order_degrades_to_tail``
floors h so for the same reason; ``test_torch_parallel.py`` holds the
engines to the oracle of the particles as placed, with no floor).
Tolerances: against JAX 2e-5 * max, against the oracle 1e-5 * max.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_tasks as T
from astro_sph_tools_tpu.ops.deposit import MapSpec as JMapSpec
from astro_sph_tools_tpu.parallel import make_mesh as j_make_mesh
from astro_sph_tools_tpu.parallel.coherent import deposit_2d_coherent_sharded as j_deposit_2d_coherent_sharded
from astro_sph_tools_tpu_torch.ops import MapSpec
from astro_sph_tools_tpu_torch.parallel import pad_particles_mesh
from oracles import project_oracle
from test_torch_parallel import coherent_set
from torch_dist import RankPool

JAX_TOL = 2e-5
ORACLE_TOL = 1e-5


def rel_err(got, ref):
    return float(np.abs(np.asarray(got, np.float64) - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(4, str(tmp_path_factory.mktemp("gloo")))
    yield p
    p.close()


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(32)
    box = 10.0
    shape, extent = (64, 64), (0.0, box, 0.0, box)
    x, y, h, m = coherent_set(rng, 4 * 3 * 2048 - 700, box, box / 64)
    h = np.maximum(h, 0.3 * box / 64).astype(np.float32)
    fields = np.stack([m, m * rng.uniform(1, 2, m.size).astype(np.float32)])
    spec = MapSpec(shape=shape, extent=extent, periodic_wrap=True)
    xp, yp, hp, vp = pad_particles_mesh(x, y, h, fields, spec, 4)
    jspec = JMapSpec(shape=shape, extent=extent, periodic_wrap=True)
    jax_map = np.asarray(j_deposit_2d_coherent_sharded(
        jnp.asarray(xp), jnp.asarray(yp), jnp.asarray(hp), jnp.asarray(vp), jspec, j_make_mesh(4),
        precision="f32", prep="pallas",
    ))
    oracle = np.stack([project_oracle(x, y, h, f, shape, extent, periodic=True) for f in fields])
    return spec, (xp, yp, hp, vp), jax_map, oracle


@pytest.mark.parametrize("world", [4, 1])
@pytest.mark.parametrize("engine", ["synced_pallas", "synced_xla", "fused"])
def test_coherent_sharded_matches_jax_and_oracle(pool, case, world, engine):
    spec, (xp, yp, hp, vp), jax_map, oracle = case
    ranks = range(4 if world == 4 else 1)
    if engine == "fused":
        got = pool.run(T.coherent_fused, (world, xp, yp, hp, vp, spec, -1), ranks=ranks)
        assert all(ok for _, ok, _ in got)
        maps = [img for img, _, _ in got]
    else:
        prep = engine.split("_")[1]
        maps = pool.run(T.coherent, (world, xp, yp, hp, vp, spec, dict(prep=prep)), ranks=ranks)
    for img in maps:
        np.testing.assert_array_equal(img, maps[0])
    assert maps[0].shape == jax_map.shape == oracle.shape
    for f in range(oracle.shape[0]):
        assert rel_err(maps[0][f], jax_map[f]) <= JAX_TOL, f
        assert rel_err(maps[0][f], oracle[f]) <= ORACLE_TOL, f
