"""Port vs JAX: the neighbour queries (``ops/neighbors.py``).

Each engine of the port runs on the CPU (``device="cpu"``) on the same
seeded NumPy inputs as the JAX function (on the CPU) and scipy's KDTree:

- the dense engines, ``nearest_points_device`` and ``knn_distances``,
  periodic and open: indexes equal to JAX's and the KDTree's, distances to
  f32 (XLA on the CPU rounds a few distances an ulp apart);
- the shell-walking ``nearest_points_grid``: JAX's clustered periodic case
  (9,000 points, 2,500 queries) and an open box, a ``cap=8`` case whose
  probes meet full buckets (the spill pass), a void-heavy case whose
  queries reach the dense sweep, a periodic grid of g <= 2 (its shells
  wrap onto the same cells, which an argmin does not mind) and an open box
  far from the origin (the fixed 1e-4 pad of the bounding box is below an
  ulp there);
- the k-NN cascade ``knn_distances_grid``: k = 32 on 12,000 clustered
  points, k = 8 on an open box with m > 8192 (the JAX open-box test, at
  m = 5,000, only reaches the dense shortcut), a small-cap case with a
  sparse half that takes two stages, the spill and stragglers, and the
  k > m rejection.

Each branch is shown to run through the engines' ``stats``.
"""

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, as conftest sets it)
import numpy as np
import pytest
from scipy.spatial import KDTree

from astro_sph_tools_tpu.ops import neighbors as J
from astro_sph_tools_tpu_torch.ops import neighbors as T

DIST_RTOL = 1e-5  # f32 distances, the port against JAX (an ulp or two)


def clustered(rng, m, box, n_blobs, sigma):
    """Half the points in Gaussian blobs, half uniform, wrapped (f32)."""
    centres = rng.uniform(0, box, (n_blobs, 3))
    blob = centres[rng.integers(0, n_blobs, m // 2)] + rng.normal(0, sigma, (m // 2, 3))
    return np.vstack([np.mod(blob, box), rng.uniform(0, box, (m - m // 2, 3))]).astype(np.float32)


def kdtree(pts, qs, box, k=1):
    if box is None:
        return KDTree(pts).query(qs, k=k)
    return KDTree(np.mod(pts, box), boxsize=box).query(np.mod(qs, box), k=k)


def assert_nearest(got, ref, kd, index_share=1.0):
    (ti, td), (ji, jd), (kdd, kdi) = got, ref, kd
    np.testing.assert_allclose(td, jd, rtol=DIST_RTOL, atol=1e-6)
    assert np.abs(td - kdd).max() < 1e-4
    assert (ti == ji).mean() >= index_share
    assert (ti == kdi).mean() >= index_share


@pytest.mark.parametrize("box", [10.0, None], ids=["periodic", "open"])
def test_dense_nearest_matches_jax_and_kdtree(box):
    rng = np.random.default_rng(1)
    q = rng.uniform(0, 10, (500, 3))
    p = rng.uniform(0, 10, (200, 3))
    ti, td = T.nearest_points_device(q, p, periodic_box=box, device="cpu")
    ji, jd = J.nearest_points_device(q, p, periodic_box=box)
    assert ti.dtype == ji.dtype == np.int32 and td.dtype == np.float32
    assert_nearest((ti, td), (ji, jd), kdtree(p, q, box))
    np.testing.assert_array_equal(ti, ji)


@pytest.mark.parametrize("box", [10.0, None], ids=["periodic", "open"])
def test_dense_knn_matches_jax_and_kdtree(box):
    rng = np.random.default_rng(2)
    p = rng.uniform(0, 10, (800, 3))
    got = T.knn_distances(p, p, 32, periodic_box=box, device="cpu")
    np.testing.assert_allclose(got, J.knn_distances(p, p, 32, periodic_box=box), rtol=DIST_RTOL, atol=1e-6)
    np.testing.assert_allclose(got, kdtree(p, p, box, k=32)[0], rtol=1e-4, atol=1e-5)
    assert (np.diff(got, axis=1) >= 0).all()


def test_dense_engines_block_over_the_points(monkeypatch):
    """Blocks of the points merge into running results: tiny blocks give
    what one block gives, ties keeping the earliest index."""
    rng = np.random.default_rng(3)
    p = np.round(rng.uniform(0, 4, (300, 3)))  # integer lattice: many exact ties
    q = np.round(rng.uniform(0, 4, (90, 3))) + 0.5
    one = T.nearest_points_device(q, p, periodic_box=4.0, device="cpu"), T.knn_distances(q, p, 7, device="cpu")
    monkeypatch.setattr(T, "_BLOCK_ELEMENTS", 64)
    many = T.nearest_points_device(q, p, periodic_box=4.0, device="cpu"), T.knn_distances(q, p, 7, device="cpu")
    np.testing.assert_array_equal(one[0][0], many[0][0])
    np.testing.assert_array_equal(one[0][1], many[0][1])
    np.testing.assert_array_equal(one[1], many[1])
    np.testing.assert_array_equal(one[0][0], J.nearest_points_device(q, p, periodic_box=4.0)[0])


GRID_CASES = {
    # JAX's own case: clustered points, uniform queries
    "clustered_periodic": dict(box=12.0, m=9000, q=2500, blobs=12, sigma=0.3, cap=None),
    "cap8_spill": dict(box=12.0, m=9000, q=2500, blobs=12, sigma=0.3, cap=8),
    # two tight blobs in a box of voids: far queries reach the dense sweep
    "voids_periodic": dict(box=12.0, m=3000, q=1500, blobs=2, sigma=0.2, cap=None, all_blobs=True),
    # m = 60: g = 2, shells 1-3 wrap onto the same 8 cells
    "g2_periodic": dict(box=5.0, m=60, q=700, blobs=3, sigma=0.5, cap=None),
}


@pytest.mark.parametrize("name", list(GRID_CASES))
def test_grid_nearest_matches_jax_and_kdtree(name):
    c = GRID_CASES[name]
    rng = np.random.default_rng(4)
    if c.get("all_blobs"):
        centres = rng.uniform(0, c["box"], (c["blobs"], 3))
        pts = np.mod(centres[rng.integers(0, c["blobs"], c["m"])]
                     + rng.normal(0, c["sigma"], (c["m"], 3)), c["box"]).astype(np.float32)
    else:
        pts = clustered(rng, c["m"], c["box"], c["blobs"], c["sigma"])
    qs = rng.uniform(0, c["box"], (c["q"], 3)).astype(np.float32)
    stats = {}
    got = T.nearest_points_grid(qs, pts, periodic_box=c["box"], cap=c["cap"], device="cpu", stats=stats)
    ref = J.nearest_points_grid(qs, pts, periodic_box=c["box"], cap=c["cap"])
    assert got[0].dtype == np.int64 and got[1].dtype == np.float32
    assert_nearest(got, ref, kdtree(pts, qs, c["box"]), index_share=0.999)
    if name == "cap8_spill":
        assert stats["cap"] == 8 and stats["spilled"] > 0
    if name == "voids_periodic":
        assert stats["dense_sweep"] > 0 and len(stats["shell_queries"]) == 4
    if name == "g2_periodic":
        assert stats["g"] == 2


def test_grid_nearest_open_box_and_dispatcher():
    rng = np.random.default_rng(5)
    pts = rng.normal(0, 3.0, (3000, 3)).astype(np.float32)
    qs = rng.normal(0, 4.0, (800, 3)).astype(np.float32)
    got = T.nearest_points(qs, pts, method="grid", device="cpu")
    assert_nearest(got, J.nearest_points(qs, pts, method="grid"), kdtree(pts, qs, None), index_share=0.999)
    dense = T.nearest_points(qs, pts, device="cpu")  # 3000 <= _DENSE_MAX_POINTS
    np.testing.assert_array_equal(dense[0], got[0])
    host = T.nearest_points(qs, pts, prefer_device=False)
    np.testing.assert_array_equal(host[0], got[0])
    with pytest.raises(ValueError, match="Unknown method"):
        T.nearest_points(qs, pts, method="octree", device="cpu")


def test_grid_nearest_far_from_the_origin():
    """An open box at 1e5: the bounding box's 1e-4 pad is below an ulp of
    the coordinates, and the cell clip keeps the extreme points on the
    grid; both packages still match the KDTree."""
    rng = np.random.default_rng(6)
    pts = (1e5 + rng.uniform(0, 50, (2000, 3))).astype(np.float32)
    qs = (1e5 + rng.uniform(0, 50, (500, 3))).astype(np.float32)
    assert np.float32(pts.min() - np.float32(1e-4)) == pts.min()
    got = T.nearest_points_grid(qs, pts, device="cpu")
    assert_nearest(got, J.nearest_points_grid(qs, pts), kdtree(pts.astype(np.float64), qs, None),
                   index_share=0.999)


def test_grid_knn_clustered_periodic_k32():
    rng = np.random.default_rng(7)
    box = 12.0
    pts = clustered(rng, 12000, box, 10, 0.25)
    stats = {}
    got = T.knn_distances_grid(pts, pts, 32, periodic_box=box, device="cpu", stats=stats)
    np.testing.assert_allclose(got, J.knn_distances_grid(pts, pts, 32, periodic_box=box), rtol=DIST_RTOL, atol=1e-6)
    np.testing.assert_allclose(got, kdtree(pts, pts, box, k=32)[0], rtol=1e-4, atol=1e-5)
    assert (np.diff(got, axis=1) >= 0).all()
    assert len(stats["stages"]) >= 2 and stats["stages"][0]["spilled"] > 0


def test_grid_knn_open_box_past_the_dense_shortcut():
    rng = np.random.default_rng(8)
    pts = rng.normal(0, 3.0, (10000, 3)).astype(np.float32)
    qs = rng.normal(0, 4.0, (900, 3)).astype(np.float32)
    stats = {}
    got = T.knn_distances_grid(qs, pts, 8, device="cpu", stats=stats)
    assert not stats["dense_only"] and stats["stages"]
    np.testing.assert_allclose(got, J.knn_distances_grid(qs, pts, 8), rtol=DIST_RTOL, atol=1e-6)
    np.testing.assert_allclose(got, kdtree(pts, qs, None, k=8)[0], rtol=1e-4, atol=1e-5)


def test_grid_knn_stages_spill_and_stragglers():
    """A small cap and a sparse half: the first stage spills and leaves the
    sparse queries, a second (coarser) stage runs, and what it leaves takes
    the dense sweep."""
    rng = np.random.default_rng(9)
    box = 12.0
    dense = np.mod(rng.uniform(0, box, (2, 3))[rng.integers(0, 2, 9000)]
                   + rng.normal(0, 0.15, (9000, 3)), box)
    sparse = rng.uniform(0, box, (300, 3))
    pts = np.vstack([dense, sparse]).astype(np.float32)
    stats = {}
    got = T.knn_distances_grid(pts, pts, 16, periodic_box=box, cap=8, max_stages=2, device="cpu", stats=stats)
    ref = J.knn_distances_grid(pts, pts, 16, periodic_box=box, cap=8, max_stages=2)
    np.testing.assert_allclose(got, ref, rtol=DIST_RTOL, atol=1e-6)
    np.testing.assert_allclose(got, kdtree(pts, pts, box, k=16)[0], rtol=1e-4, atol=1e-5)
    stages = stats["stages"]
    assert len(stages) == 2 and stages[1]["g"] < stages[0]["g"]
    assert stages[0]["spilled"] > 0 and stats["stragglers"] > 0


def test_grid_knn_rejects_k_past_the_points():
    pts = np.random.default_rng(10).uniform(0, 1, (16, 3)).astype(np.float32)
    with pytest.raises(ValueError, match="exceeds"):
        T.knn_distances_grid(pts, pts, 32, device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        J.knn_distances_grid(pts, pts, 32)
    with pytest.raises(ValueError, match="no points"):
        T.knn_distances_grid(pts, pts[:0], 1, device="cpu")
