"""CPU tests of the cube cell's yardstick, ``reference/box_cube.py``: its
scatter against ``tests/oracles.py``'s per-voxel gather, the cubes it hands
``compare.py``, and ``work()``'s count of the pairs inside the supports.

    python -m pytest sphbench/ -q
"""

from __future__ import annotations

import importlib.util
import math

import numpy as np
import pytest
import torch

from sphbench import counting, harness
from sphbench.reference import box_cube


def _oracles():
    spec = importlib.util.spec_from_file_location("sphbench_oracles", harness.ROOT / "tests" / "oracles.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _particles(seed: int, n: int, box: float, h_range):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, box, (n, 3))
    h = rng.uniform(*h_range, n)
    values = rng.uniform(0.5, 2.0, (2, n))
    return pos, h, values


@pytest.mark.parametrize("kernel", ["wendland_c2", "cubic_spline"])
def test_the_cube_reference_agrees_with_the_oracle(kernel):
    """A periodic cube of unequal axes, support radii of 0.3-5.3 voxels
    (windows of 2-12 voxels, several of each width, those near an edge
    wrapped): every voxel within 1e-12 of the largest, both in float64."""
    oracles = _oracles()
    box, shape = 1.0, (10, 12, 14)
    pos, h, values = _particles(3, 200, box, (0.015, 0.19))
    got = box_cube.scatter(*(torch.from_numpy(a) for a in (pos, h, values)), shape, box, kernel=kernel).numpy()
    for f in range(2):
        want = oracles.grid3d_oracle(pos, h, values[f], shape, (0.0, box) * 3, kernel=kernel, periodic=True)
        assert np.abs(got[f] - want).max() <= 1e-12 * np.abs(want).max()


def test_a_window_wider_than_the_cube_raises():
    pos, h, values = _particles(4, 8, 1.0, (0.3, 0.4))
    with pytest.raises(ValueError, match="wider than the periodic cube"):
        box_cube.scatter(*(torch.from_numpy(a) for a in (pos, h, values)), (4, 4, 4), 1.0, kernel="wendland_c2")


def test_the_maps_are_the_cubes_as_planes_with_the_mean_derived():
    """``maps()`` hands each cube as its (nz * ny, nx) view, the density as
    ``surface_density``, and the mean temperature over it where positive."""
    box, res = 2.0, 8
    pos, h, values = _particles(5, 120, box, (0.02, 0.2))
    inputs = {"positions": torch.from_numpy(pos).float(), "smoothing_lengths": torch.from_numpy(h).float(),
              "masses": torch.from_numpy(values[0]).float(), "temperatures": torch.from_numpy(values[1]).float(),
              "box": box}
    config = {"kernel": "wendland_c2", "product": {"kind": "box_cube", "resolution": res,
                                                   "fields": ["density", "temperature"]}}
    (got,) = box_cube.maps(inputs, config, "cpu")
    assert sorted(got) == ["mass_weighted_temperature", "mean_temperature", "surface_density"]
    assert all(m.shape == (res * res, res) for m in got.values())
    payload = torch.stack([inputs["masses"].double(), inputs["masses"].double() * inputs["temperatures"].double()])
    cubes = box_cube.scatter(inputs["positions"], inputs["smoothing_lengths"], payload, (res,) * 3, box,
                             kernel="wendland_c2").numpy()
    np.testing.assert_array_equal(got["surface_density"], cubes[0].reshape(res * res, res))
    rho, mw = got["surface_density"], got["mass_weighted_temperature"]
    assert (got["mean_temperature"][rho == 0] == 0).all()
    np.testing.assert_allclose(got["mean_temperature"][rho > 0], (mw / np.where(rho > 0, rho, 1.0))[rho > 0],
                               rtol=1e-14)


def test_the_work_counts_the_voxel_centres_inside_each_sphere():
    """``work()`` counts (4/3) pi s^3 voxel centres a particle of support
    radius s voxels, (14 + 2F) operations each for Wendland C2, the inputs
    read and the cubes (each field's and each mean) written once; and
    (4/3) pi s^3 is the mean count of voxel centres inside a sphere over
    its sub-voxel offset (within 1 % over 400 offsets at s = 2.5-6)."""
    box, res = 4.0, 32
    voxel = box / res
    s = np.array([2.5, 4.0, 6.0])
    h = torch.tensor(s * voxel / 2.0)
    inputs = {"smoothing_lengths": h, "box": box}
    config = {"kernel": "wendland_c2", "product": {"kind": "box_cube", "resolution": res,
                                                   "fields": ["density", "temperature"]}}
    got = box_cube.work(inputs, config, "cpu")
    points = 4.0 / 3.0 * math.pi * float((s ** 3).sum())
    assert got["ops"] == pytest.approx(points * counting.pair_ops(2, "wendland_c2"), rel=1e-12)
    assert counting.pair_ops(2, "wendland_c2") == 14 + 2 * 2
    assert got["bytes"] == 4.0 * 3 * (4 + 2) + 4.0 * 3 * res ** 3
    rng = np.random.default_rng(6)
    for radius in s:
        k = np.arange(-math.ceil(radius) - 1, math.ceil(radius) + 2)
        counts = []
        for off in rng.uniform(0.0, 1.0, (400, 3)):
            d2 = [(k + 0.5 - o) ** 2 for o in off]
            counts.append(int(((d2[2][:, None, None] + d2[1][None, :, None] + d2[0][None, None, :])
                               < radius * radius).sum()))
        assert np.mean(counts) == pytest.approx(4.0 / 3.0 * math.pi * radius ** 3, rel=0.01)
