"""CPU tests of the benchmark's yardstick: the reference against
``tests/oracles.py`` on tiny inputs, the counts, and the comparison failing
the control and each fault a map cell can have.

    python -m pytest sphbench/ -q
"""

from __future__ import annotations

import importlib.util
import math

import numpy as np
import pytest
import torch

from sphbench import compare, counting, faults, harness
from sphbench.reference import scatter

SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
TINY = {"snapshot": {"n_particles": 1 << 14}, "product": {"resolution": 128}}
CELLS = [w["name"] for w in SPEC["workloads"]]


def _oracles():
    spec = importlib.util.spec_from_file_location("sphbench_oracles", harness.ROOT / "tests" / "oracles.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("kernel", ["wendland_c2", "cubic_spline"])
@pytest.mark.parametrize("periodic", [True, False])
def test_the_reference_agrees_with_the_oracle(kernel, periodic):
    oracles = _oracles()
    rng = np.random.default_rng(5)
    n, shape, extent = 300, (24, 20), (0.0, 2.0, 0.0, 2.4)
    x, y = rng.uniform(-0.2, 2.2, n), rng.uniform(-0.2, 2.6, n)
    h = rng.uniform(0.01, 0.3, n)
    values = rng.uniform(0.5, 2.0, (2, n))
    got = scatter.project(*(torch.from_numpy(a) for a in (x, y, h, values)), shape, extent, kernel=kernel,
                          periodic=periodic).numpy()
    for f in range(2):
        want = oracles.project_oracle(x, y, h, values[f], shape, extent, kernel=kernel, periodic=periodic)
        assert np.abs(got[f] - want).max() <= 1e-12 * np.abs(want).max()


def test_the_wendland_kernel_is_the_oracles():
    oracles = _oracles()
    r, h = np.linspace(0.0, 0.5, 101), np.full(101, 0.2)
    got = scatter.wendland_c2_w(torch.from_numpy(r), torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, oracles.wendland_c2_w(r, h), rtol=1e-14, atol=0.0)


def test_the_control_is_one_precision_below():
    rng = np.random.default_rng(6)
    x, y, h = (torch.from_numpy(a).float() for a in (rng.uniform(0, 1, 2000), rng.uniform(0, 1, 2000),
                                                      rng.uniform(0.01, 0.05, 2000)))
    v = torch.ones(1, 2000)
    ref = scatter.project(x, y, h, v, (64, 64), (0.0, 1.0, 0.0, 1.0), kernel="wendland_c2", periodic=True)
    low = scatter.project(x, y, h, v, (64, 64), (0.0, 1.0, 0.0, 1.0), kernel="wendland_c2", periodic=True,
                          control=True)
    assert ref.dtype == torch.float64 and low.dtype == torch.float32
    gap = float((low.double() - ref).abs().max() / ref.abs().max())
    assert 2.0 ** -14 < gap < 0.1  # bfloat16 rounding, not a different sum


def test_clipped_support_points_are_the_discs_area_in_the_map():
    cx = torch.tensor([50.0, 0.0, 10.0, 50.0], dtype=torch.float64)
    cy = torch.tensor([50.0, 0.0, 50.0, 50.0], dtype=torch.float64)
    s = torch.tensor([10.0, 20.0, 30.0, 500.0], dtype=torch.float64)
    got = counting.clipped_support_points(cx, cy, s, 100, 100)
    # inside; a quarter; a disc cut by the edge x = 0 at 10 from its centre; the whole map
    cut = 30.0**2 * (math.pi - math.acos(10 / 30) + (10 / 30) * math.sqrt(1 - (10 / 30) ** 2))
    want = math.pi * 100 + math.pi * 400 / 4 + cut + 100 * 100
    assert abs(got - want) <= 1e-3 * want


def test_pair_ops_count_wendland_and_the_fields():
    assert counting.pair_ops(2, "wendland_c2") == 18 and counting.pair_ops(3, "cubic_spline") == 18


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct_and_the_control_and_each_fault_are_not(cell):
    sound = harness.run(SPEC, cell, 11, 0.2, False, t0=0.0, device="cpu", overrides=TINY)
    assert sound["correct"], sound["checks"]
    for name, product in [("control", faults.control)] + list(faults.FAULTS.items()):
        r = harness.run(SPEC, cell, 11, 0.05, False, t0=0.0, device="cpu", overrides=TINY, product=product)
        assert not r["correct"], (name, r["checks"])


def test_a_missing_or_broken_answer_reads_infinity():
    ref = [{"surface_density": np.ones((4, 4)), "mean_temperature": np.ones((4, 4))}]
    assert compare.numbers([{}], ref)["map_max_rel"] == math.inf
    nan = [{"surface_density": np.full((4, 4), np.nan), "mean_temperature": np.ones((4, 4))}]
    assert not compare.judge(compare.numbers(nan, ref), {"map_max_rel": 1.0})[0]
    assert compare.numbers(ref, ref) == dict.fromkeys(compare.NUMBERS, 0.0)


def test_the_block_gap_sees_a_dropped_tile_and_a_raised_pixel_that_the_summed_gap_dilutes():
    rng = np.random.default_rng(8)
    ref = np.exp(rng.normal(0.0, 1.5, (1024, 1024)))
    noisy = ref * (1 + 1e-4 * rng.normal(size=ref.shape))
    assert compare.block_gap(noisy, ref) < 1e-3
    for change in (faults._drop_emptiest_block, faults._raise_centre):
        bad = change(ref.copy())
        got = compare.numbers([{"surface_density": bad}], [{"surface_density": ref}])
        assert got["map_l1_rel"] < 1e-3 < got["block_l1_rel"], (change.__name__, got)


def test_the_smoothing_length_is_eagles_and_r200_holds_200_rho_crit():
    from sphbench.generators import clustered

    config = harness.find_cell(SPEC, "l0025_haloes").config
    snap = config["snapshot"]
    h = clustered.mean_smoothing_length(snap)
    rho_crit = clustered.RHO_CRIT_H2 * snap["hubble_h"] ** 2
    n = snap["omega_b"] * rho_crit / snap["particle_mass_msun"]  # gas particles a cMpc^3
    assert abs(4.0 / 3.0 * math.pi * (2.0 * h) ** 3 * n - snap["n_ngb"]) < 1e-9
    # 376^3 particles of 1.81e6 Msun fill the 25 cMpc box at Omega_b rho_crit
    assert abs(n * snap["box_cmpc"] ** 3 / snap["n_particles"] - 1.0) < 2e-3
    m = np.array([1e13, 5e11])
    r = clustered.r200(m, snap)
    np.testing.assert_allclose(m / (4.0 / 3.0 * math.pi * r**3), 200 * rho_crit, rtol=1e-12)


def test_the_halo_request_holds_the_heaviest_and_the_two_haloes_across_the_edge():
    cell = harness.find_cell(SPEC, "l0025_haloes", overrides=TINY)
    inputs = harness.make_inputs(cell, 3, "cpu")
    centres, r200 = inputs["halo_centres"], inputs["halo_r200"]
    assert len(r200) == 3 and r200[0] == r200.max()
    half = cell.config["product"]["radius_multiple"] * r200
    box = inputs["box"]
    near_edge = np.minimum(centres[:, :2], box - centres[:, :2]).min(axis=1)
    assert (near_edge[1:] < half[1:]).all() and near_edge[0] > half[0]
