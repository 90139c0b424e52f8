"""Port vs JAX: SWIFT dark-matter smoothing lengths and the DM map.

On a SWIFT snapshot written by the JAX package's fixture writer, with
10,000 clustered DM particles (past the k-NN cascade's dense shortcut at
8192, so the grid engine walks its stages):

- the port's ``"grid"`` engine (``knn_distances_grid``, here on the CPU)
  equals its ``"kdtree"`` to rtol 2e-4 (the JAX package's own tolerance
  between the two, ``tests/test_cells_neighbors.py``) and JAX's grid to
  f32; the port's ``"kdtree"`` equals the JAX reader's exactly;
- ``"auto"`` takes the grid from ``DM_HSML_DEVICE_THRESHOLD`` particles and
  the KDTree below it, and a forced engine wins over it;
- ``render_map_stack(particle_type=dark_matter)`` at 64^2 (the port's
  "auto" takes its grid here, JAX's its KDTree) equals the JAX one within
  the f32 comparison bound (2e-5 * max) and the f64 oracle of
  ``tests/oracles.py`` (with the KDTree's h) within 1e-5 * max.
"""

import numpy as np
import pytest

from astro_sph_tools_tpu.data_structures import ParticleType as JParticleType
from astro_sph_tools_tpu.io.swift import SnapshotSWIFT as JSnapshotSWIFT
from astro_sph_tools_tpu.io.synthetic import SyntheticSnapshotSpec, write_swift_snapshot
from astro_sph_tools_tpu.render import render_map_stack as j_render
from astro_sph_tools_tpu_torch import render_map_stack as t_render
from astro_sph_tools_tpu_torch.data_structures import ParticleType
from astro_sph_tools_tpu_torch.io import swift as port_swift
from astro_sph_tools_tpu_torch.io.swift import SnapshotSWIFT
from oracles import project_oracle_fast

N_DM = 10_000


@pytest.fixture(scope="module")
def swift(tmp_path_factory):
    spec = SyntheticSnapshotSpec(n_gas=64, n_dm=N_DM, n_star=8, n_bh=2, clustered=True)
    path, truth = write_swift_snapshot(str(tmp_path_factory.mktemp("torch_swift_dm")), spec)
    return path, spec


def dm_h(path, engine, package="port"):
    if package == "port":
        snap = SnapshotSWIFT(path)
        snap.dm_hsml_device = "cpu"
        pt = ParticleType.dark_matter
    else:
        snap, pt = JSnapshotSWIFT(path), JParticleType.dark_matter
    snap.dm_hsml_engine = engine
    return snap.get_smoothing_lengths(pt).value


def test_grid_engine_equals_the_kdtree_and_jax(swift):
    path, _ = swift
    grid, kd = dm_h(path, "grid"), dm_h(path, "kdtree")
    np.testing.assert_allclose(grid, kd, rtol=2e-4, atol=1e-6)
    np.testing.assert_array_equal(kd, dm_h(path, "kdtree", "jax"))
    np.testing.assert_allclose(grid, dm_h(path, "grid", "jax"), rtol=1e-5, atol=1e-6)
    assert grid.dtype == np.float64


def test_grid_engine_walks_its_stages(swift):
    path, _ = swift
    pos = SnapshotSWIFT(path).get_positions(ParticleType.dark_matter).to_value("Mpc")
    stats = {}
    h = port_swift.dm_smoothing_lengths(pos, 10.0, "grid", "cpu", stats=stats)
    assert stats["engine"] == "grid" and not stats["dense_only"] and stats["stages"]
    np.testing.assert_array_equal(h, dm_h(path, "grid"))


def test_auto_dispatch_pinned_at_the_port_constant(swift, monkeypatch):
    path, _ = swift
    snap = SnapshotSWIFT(path)
    threshold = port_swift.DM_HSML_DEVICE_THRESHOLD
    assert snap.DM_HSML_DEVICE_THRESHOLD == threshold
    assert snap._dm_hsml_pick_engine(threshold - 1) == "kdtree"
    assert snap._dm_hsml_pick_engine(threshold) == "grid"
    snap.dm_hsml_engine = "kdtree"
    assert snap._dm_hsml_pick_engine(10 * threshold) == "kdtree"
    # the module function resolves "auto" at the same constant
    pos = snap.get_positions(ParticleType.dark_matter).to_value("Mpc")
    stats = {}
    port_swift.dm_smoothing_lengths(pos[:2000], 10.0, "auto", "cpu", stats=stats)
    assert stats["engine"] == ("grid" if 2000 >= threshold else "kdtree")
    monkeypatch.setattr(port_swift, "DM_HSML_DEVICE_THRESHOLD", 2000)
    port_swift.dm_smoothing_lengths(pos[:2000], 10.0, "auto", "cpu", stats=stats)
    assert stats["engine"] == "grid"
    with pytest.raises(ValueError, match="Unknown DM"):
        port_swift.dm_smoothing_lengths(pos, 10.0, "octree", "cpu")


def test_dm_map_matches_jax_and_the_oracle(swift):
    path, spec = swift
    ref = j_render(JSnapshotSWIFT(path), particle_type=JParticleType.dark_matter, resolution=64)
    snap = SnapshotSWIFT(path)
    snap.dm_hsml_device = "cpu"  # "auto" takes the grid at 10,000 DM particles
    assert snap._dm_hsml_pick_engine(N_DM) == "grid"
    got = t_render(snap, particle_type=ParticleType.dark_matter, resolution=64, device="cpu")
    g, r = got["surface_density"], ref["surface_density"]
    assert g.shape == (64, 64)
    assert np.abs(g - r).max() <= 2e-5 * np.abs(r).max()
    snap.dm_hsml_engine = "kdtree"
    snap._dm_hsml_cache = None
    pos = snap.get_positions(ParticleType.dark_matter).to_value("Mpc")
    oracle = project_oracle_fast(
        pos[:, 0], pos[:, 1], snap.get_smoothing_lengths(ParticleType.dark_matter).value,
        snap.get_masses(ParticleType.dark_matter).to_value("Msun"), (64, 64),
        (0.0, spec.box_size_mpc, 0.0, spec.box_size_mpc), periodic=True,
    )
    err = np.abs(g - oracle).max() / np.abs(oracle).max()  # h: the port's grid, the oracle's KDTree
    print(f"DM map vs f64 oracle: {err:.3e} * max (JAX {np.abs(r - oracle).max() / np.abs(oracle).max():.3e})")
    assert err <= 1e-5
