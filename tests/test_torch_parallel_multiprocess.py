"""Two ranks over gloo read a four-file synthetic EAGLE snapshot in
stripes and render it: the port of tests/multiprocess/worker.py (which
stays as it is).

Each rank opens its stripe (``open_process_local_snapshot``), pads its
blocks over the mesh (``load_particle_fields_sharded``), rebalances them
evenly, renders them (``deposit_2d_sharded``) and checks that both ranks
hold the same map (``assert_consistent_across_processes``); the map is held
to the f64 oracle of the whole file set (1e-5 * max). Then
``render_halo_maps(mesh=...)`` is held to ``render_halo_maps`` on the
unstriped snapshot (2e-5 * max, the whole-engine f32 bound), and SUBFIND's
gather to the single-process array.
"""

import numpy as np
import pytest

import torch_parallel_tasks as T
from astro_sph_tools_tpu_torch import render_halo_maps
from astro_sph_tools_tpu_torch.data_structures import ParticleType
from astro_sph_tools_tpu_torch.io.eagle import SnapshotEAGLE
from astro_sph_tools_tpu_torch.io.subfind import CatalogueSUBFIND, _allgather_concat
from astro_sph_tools_tpu_torch.io.synthetic import SyntheticSnapshotSpec, write_catalogue, write_snapshot
from oracles import project_oracle_fast
from torch_dist import RankPool

ORACLE_TOL = 1e-5
PATH_TOL = 2e-5


def rel_err(got, ref):
    return float(np.abs(np.asarray(got, np.float64) - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("striped_snapshot")
    spec = SyntheticSnapshotSpec(n_gas=6000, n_dm=500, n_star=64, n_bh=2, n_files=4, seed=11,
                                 clustered=True, n_groups=4)
    path, truth = write_snapshot(str(root), spec)
    memb, prop = write_catalogue(str(root), spec, truth)
    pool = RankPool(2, str(tmp_path_factory.mktemp("gloo")))
    try:
        out = pool.run(T.striped_read_and_render, (path, memb, prop, 32))
    finally:
        pool.close()
    return path, memb, prop, out


def test_striped_reads_cover_the_snapshot_once(run):
    path, _, _, out = run
    full = SnapshotEAGLE(path)
    n_total = full.number_of_particles_this_rank(ParticleType.gas)
    assert [o["files"] for o in out] == [2, 2]  # each rank a strict subset of the 4 files
    assert sum(o["n_local"] for o in out) == n_total
    for o in out:
        np.testing.assert_array_equal(o["counts"], [p["n_local"] for p in out])
        assert o["pos_shape"][0] % 512 == 0 and o["pos_shape"][0] >= max(o["counts"])
        assert o["new_counts"].sum() == n_total and o["new_counts"].max() - o["new_counts"].min() <= 1


def test_sharded_render_is_consistent_and_matches_the_oracle(run):
    path, _, _, out = run
    assert out[0]["digest"] == out[1]["digest"]
    assert all(o["digest_mismatch"] and "inconsistency" in o["digest_mismatch"] for o in out)
    full = SnapshotEAGLE(path)
    x = full.get_positions(ParticleType.gas).to_value("Mpc")
    h = full.get_smoothing_lengths(ParticleType.gas).to_value("Mpc")
    m = full.get_masses(ParticleType.gas).to_value("Msun")
    box = float(full.box_size.value[0])
    exp = project_oracle_fast(x[:, 0].astype(np.float32), x[:, 1].astype(np.float32), h.astype(np.float32),
                              m.astype(np.float32), (64, 64), (0.0, box, 0.0, box))
    assert rel_err(out[0]["map"], exp) <= ORACLE_TOL


def test_halo_maps_over_the_mesh_match_one_process(run):
    path, memb, prop, out = run
    snap = SnapshotEAGLE(path)
    ref = render_halo_maps(snap, CatalogueSUBFIND(memb, prop, snap), [0, 2], fields=("density", "temperature"),
                           resolution=32, device="cpu")
    for o in out:
        for got, r in zip(o["halo_maps"], ref):
            assert set(got) == set(r.keys())
            covered = r["surface_density"] > 1e-3 * r["surface_density"].max()
            for name in got:
                where = covered if name.startswith("mean_") else slice(None)
                assert rel_err(got[name][where], r[name][where]) <= PATH_TOL, name


def test_subfind_gather_over_the_group(run):
    """Every rank gets the stripes' arrays in rank order (rank 0's files
    0 and 2, then rank 1's files 1 and 3): the rows of the whole snapshot."""
    path, memb, prop, out = run
    stripes = []
    for rank in range(2):
        snap = SnapshotEAGLE(path, process_index=rank, n_processes=2)
        stripes.append(CatalogueSUBFIND(memb, prop, snap).get_halo_IDs_by_snapshot_particle(ParticleType.gas))
        np.testing.assert_array_equal(out[rank]["local_ids"], stripes[-1])
    expected = np.concatenate(stripes)
    for o in out:
        np.testing.assert_array_equal(o["all_ids"], expected)
        np.testing.assert_array_equal(o["all_ids_by_method"], expected)
    snap = SnapshotEAGLE(path)
    ref = CatalogueSUBFIND(memb, prop, snap).get_halo_IDs_by_snapshot_particle(ParticleType.gas)
    np.testing.assert_array_equal(np.sort(expected), np.sort(ref))
    # one process: the local array is the whole array
    np.testing.assert_array_equal(_allgather_concat(ref), ref)
