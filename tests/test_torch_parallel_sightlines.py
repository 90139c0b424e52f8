"""The port's sharded sightline columns and spectra: in one process over
shards (``devices``), and over gloo on the CPU with four ranks and with
one (``mesh``). Held to the JAX package's XLA engines
(``ops/sightlines.py``, ``ops/spectra.py``) summed over the shards
(whole-engine f32: 2e-5 * max) and to the port's single-device fused
engines on all the particles (1e-5 * max)."""

import numpy as np
import pytest

import torch_parallel_tasks as T
from astro_sph_tools_tpu.data_structures.cosmology import Cosmology as JCosmology
from astro_sph_tools_tpu.ops.sightlines import column_integrate as j_column_integrate
from astro_sph_tools_tpu.ops.spectra import absorption_spectra as j_absorption_spectra
from astro_sph_tools_tpu_torch.data_structures import Cosmology
from astro_sph_tools_tpu_torch.ops.sightlines_fused import column_integrate_pallas
from astro_sph_tools_tpu_torch.ops.spectra_fused import absorption_spectra_pallas
from astro_sph_tools_tpu_torch.parallel import absorption_spectra_sharded, column_integrate_sharded
from torch_dist import RankPool

JAX_TOL = 2e-5
TOL = 1e-5
_COSMO = dict(hubble_param=0.6777, omega_baryon=0.04825, expansion_factor=0.5, redshift=1.0)


def rel_err(got, ref):
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64)).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(4, str(tmp_path_factory.mktemp("gloo")))
    yield p
    p.close()


def _split(arrays, n_shards):
    n = arrays[0].shape[0]
    edges = np.linspace(0, n, n_shards + 1).astype(int)
    return [tuple(a[lo:hi] for a in arrays) for lo, hi in zip(edges[:-1], edges[1:])]


@pytest.fixture(scope="module")
def column_case():
    rng = np.random.default_rng(0)
    n, rays, box = 12000, 80, 10.0
    x = rng.uniform(0, box, n)
    y = rng.uniform(0, box, n)
    h = np.exp(rng.normal(np.log(0.1), 0.5, n)).clip(0.02, 0.8)
    v = rng.uniform(0.5, 2.0, (n, 2)).astype(np.float32)
    rx = rng.uniform(0, box, rays)
    ry = rng.uniform(0, box, rays)
    shards = _split((x, y, h, v), 4)
    ref = {}
    for pb in (None, box):
        jax_sum = sum(np.asarray(j_column_integrate(*s, rx, ry, periodic_box=pb)) for s in shards)
        single = column_integrate_pallas(x, y, h, v, rx, ry, periodic_box=pb, device="cpu").numpy()
        ref[pb] = (jax_sum, single)
    return shards, rx, ry, box, ref


@pytest.mark.parametrize("periodic", [True, False])
def test_columns_over_shards_in_one_process(column_case, periodic):
    shards, rx, ry, box, ref = column_case
    pb = box if periodic else None
    got = column_integrate_sharded(shards, rx, ry, periodic_box=pb, devices=["cpu", "cpu"]).numpy()
    assert got.shape == (2, rx.size)
    assert rel_err(got, ref[pb][0]) <= JAX_TOL
    assert rel_err(got, ref[pb][1]) <= TOL


@pytest.mark.parametrize("world", [4, 1])
@pytest.mark.parametrize("periodic", [True, False])
def test_columns_over_a_mesh(pool, column_case, world, periodic):
    shards, rx, ry, box, ref = column_case
    pb = box if periodic else None
    got = pool.run(T.columns, (world, shards, rx, ry, dict(periodic_box=pb)), ranks=range(4 if world == 4 else 1))
    for g in got:
        np.testing.assert_array_equal(g, got[0])
    assert rel_err(got[0], ref[pb][0]) <= JAX_TOL
    assert rel_err(got[0], ref[pb][1]) <= TOL


@pytest.fixture(scope="module")
def spectra_case():
    rng = np.random.default_rng(1)
    n, rays, box = 6000, 30, 10.0
    pos = rng.uniform(0, box, (n, 3))
    h = np.exp(rng.normal(np.log(0.1), 0.5, n)).clip(0.02, 0.8)
    vals = rng.uniform(0.5, 2.0, n).astype(np.float32)
    vpec = rng.normal(0, 60, n).astype(np.float32)
    T_ = 10 ** rng.uniform(4, 6, n)
    rx = rng.uniform(0, box, rays)
    ry = rng.uniform(0, box, rays)
    shards = _split((pos, h, vals, vpec, T_), 4)
    kw = dict(box_size=box, n_bins=256, periodic=True)
    jax_sum = sum(np.asarray(j_absorption_spectra(*s, rx, ry, cosmology=JCosmology(**_COSMO), **kw)[0])
                  for s in shards)
    single, vc = absorption_spectra_pallas(pos, h, vals, vpec, T_, rx, ry, cosmology=Cosmology(**_COSMO),
                                           device="cpu", **kw)
    return shards, rx, ry, kw, (jax_sum, single.numpy(), vc)


def test_spectra_over_shards_in_one_process(spectra_case):
    shards, rx, ry, kw, (jax_sum, single, vc) = spectra_case
    got, vc2 = absorption_spectra_sharded(shards, rx, ry, cosmology=Cosmology(**_COSMO), devices=["cpu"], **kw)
    np.testing.assert_array_equal(vc2, vc)
    assert rel_err(got.numpy(), jax_sum) <= JAX_TOL
    assert rel_err(got.numpy(), single) <= TOL


@pytest.mark.parametrize("world", [4, 1])
def test_spectra_over_a_mesh(pool, spectra_case, world):
    shards, rx, ry, kw, (jax_sum, single, vc) = spectra_case
    got = pool.run(T.spectra, (world, shards, rx, ry, dict(kw, cosmology=_COSMO)), ranks=range(4 if world == 4 else 1))
    for tau, vc2 in got:
        np.testing.assert_array_equal(tau, got[0][0])
        np.testing.assert_array_equal(vc2, vc)
    assert rel_err(got[0][0], jax_sum) <= JAX_TOL
    assert rel_err(got[0][0], single) <= TOL


def test_spectra_need_a_cosmology_and_a_box(spectra_case):
    shards, rx, ry, kw, _ = spectra_case
    with pytest.raises(ValueError, match="cosmology and box_size"):
        absorption_spectra_sharded(shards, rx, ry, box_size=kw["box_size"], devices=["cpu"])
    with pytest.raises(ValueError, match="cosmology and box_size"):
        absorption_spectra_sharded(shards, rx, ry, cosmology=Cosmology(**_COSMO), devices=["cpu"])
