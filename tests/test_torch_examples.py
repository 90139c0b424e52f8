"""The port's examples (``astro_sph_tools_tpu_torch/examples/``) on the CPU
at small sizes.

- ``full_workflow``: all ten steps from the port's own synthetic EAGLE tree;
  its map stack and columns are held to the JAX functions on the same files
  (``render_map_stack(engine="xla")``, the dense ``column_integrate``) at
  1e-5 * max, and the in-memory source (the card's, which has no h5py) to
  the files' at 1e-5 * max.
- ``render_service``: every fused chunk's ``ok`` flag True, the summed map
  against one sorted-engine render of every chunk's particles at 1e-5 * max
  (the engines place every particle alike; only summation orders differ).
- ``multichip_render``: its four steps on four gloo ranks, each against the
  single-device engine on the whole input (1e-5 * max), the reorder exact.
"""


import numpy as np
import pytest
import torch

import torch_parallel_tasks as T
from torch_dist import RankError, RankPool

from astro_sph_tools_tpu_torch.examples import full_workflow, render_service

TOL = 1e-5


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def workflow(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tree"))
    return d, full_workflow.main([d, "--device", "cpu", "--n-gas", "3000"])


def test_full_workflow_runs_every_step(workflow):
    _, out = workflow
    assert out["skipped"] == {} and out["n_haloes"] == 8
    assert abs(out["cube_mass_recon"] - 1.0) < 1e-3
    assert out["spectra_shape"] == [4, 256] and out["spectra_finite"]
    assert out["reorder_lossless"] and out["reorder_exact"]
    assert len(out["cutout_sums"]) == 2 and all(s > 0 for s in out["cutout_sums"])
    assert out["filter_selected"] == 1500


def test_full_workflow_matches_jax_on_the_same_files(workflow):
    from astro_sph_tools_tpu.data_structures import ParticleType
    from astro_sph_tools_tpu.io import FileTreeScraper_EAGLE
    from astro_sph_tools_tpu.ops.sightlines import column_integrate
    from astro_sph_tools_tpu.render import render_map_stack

    d, out = workflow
    tree = FileTreeScraper_EAGLE(d)
    cat = tree.catalogues.get_by_number(tree.catalogues.find_file_number_from_redshift(0.5)).load()
    snap = cat.snapshot
    ref = render_map_stack(snap, fields=("density", "temperature"), resolution=256, engine="xla")
    assert set(out["stack"].keys()) == set(ref.keys())
    for name in ref.keys():
        assert rel_err(out["stack"][name], ref[name]) <= TOL, name
    pos = snap.get_positions(ParticleType.gas).to_value("Mpc")
    h = snap.get_smoothing_lengths(ParticleType.gas).to_value("Mpc")
    m = snap.get_masses(ParticleType.gas).to_value("Msun")
    rx, ry = out["rays"]
    cols = column_integrate(pos[:, 0], pos[:, 1], h, m, rx, ry, periodic_box=float(snap.box_size.value[0]))
    assert rel_err(out["columns"], cols) <= TOL


def test_full_workflow_from_memory_matches_the_files(workflow):
    _, files = workflow
    mem = full_workflow.main(["--device", "cpu", "--n-gas", "3000", "--source", "memory"])
    assert set(mem["skipped"]) == {"1-2 tree, discovery", "9 table file", "10 sidecar file"}
    for name in ("surface_density", "mean_temperature"):
        assert rel_err(mem["stack"][name], files["stack"][name]) <= TOL, name
    assert rel_err(mem["columns"], files["columns"]) <= TOL
    for key in ("n_haloes", "reorder_lossless", "filter_selected", "spectra_shape"):
        assert mem[key] == files[key], key
    for key in ("ion_log_fraction", "nearest_median", "cube_mass_recon"):
        assert abs(mem[key] - files[key]) <= 1e-5 * max(1.0, abs(files[key])), key


def test_render_service_fused_chunks_match_one_sorted_render():
    from astro_sph_tools_tpu_torch.ops import MapSpec, deposit_2d_auto

    n_log2, res, n_chunks = 15, 128, 3
    n = 1 << n_log2
    out = render_service.main(["--device", "cpu", "--n-log2", str(n_log2), "--res", str(res), "--chunks", str(n_chunks)])
    assert out["engines"] == ["synced calibration"] + ["fused zero-sync"] * (n_chunks - 1)
    assert out["ok"] == [True] * (n_chunks - 1)
    assert len(out["chunk_wall_s"]) == n_chunks and out["sigma_sum"] > 0
    parts = list(render_service.chunks(n, res, n_chunks))
    x, y, h, f = (np.concatenate([p[i] for p in parts], axis=-1) for i in range(4))
    spec = MapSpec(shape=(res, res), extent=(0, render_service.BOX, 0, render_service.BOX), periodic_wrap=True)
    ref = deposit_2d_auto(x, y, h, f, spec, device="cpu")
    assert tuple(out["map"].shape) == (2, res, res)
    assert rel_err(out["map"], ref) <= TOL


def test_examples_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_service.main(["--n-log2", "7"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        full_workflow.main(["--source", "memory"])


def multichip_cube_inputs():
    """The example's 3D draws (its second step) and its slab partition."""
    from astro_sph_tools_tpu_torch.ops import GridSpec
    from astro_sph_tools_tpu_torch.parallel import partition_particles_by_slab

    rng = np.random.default_rng(11)
    box, n = 20.0, 24_000
    for _ in range(2):
        rng.uniform(0, box, n)
    rng.normal(size=n)
    rng.uniform(0.5, 2.0, n)
    rng.uniform(1e4, 1e6, n)
    pos = rng.uniform(0, box, (6_000, 3)).astype(np.float32)
    h3 = rng.uniform(0.2, 0.8, 6_000).astype(np.float32)
    m3 = rng.uniform(0.5, 2.0, 6_000).astype(np.float32)
    gspec = GridSpec(shape=(32, 64, 64), extent=(0, box, 0, box, 0, box), periodic_wrap=True)
    return (*partition_particles_by_slab(pos, h3, m3, gspec, 1, chunk=512), gspec)


@pytest.fixture(scope="module")
def multichip(tmp_path_factory):
    pool = RankPool(4, str(tmp_path_factory.mktemp("gloo")))
    try:
        ranks = pool.run(T.multichip_render, ({"n": 24_000, "n_3d": 6_000, "ids_per_rank": 512, "n_rays": 16},))
        pp, hp, mp, gspec = multichip_cube_inputs()
        # the cube of one rank holding every particle (the world-1 mesh)
        whole = pool.run(T.deposit_3d, (1, pp, hp, mp, gspec, dict(K=4, chunk=512)), ranks=[0])[0]
        return ranks, whole
    finally:
        pool.close()


def test_multichip_render_on_four_ranks(multichip):
    from astro_sph_tools_tpu_torch.ops import MapSpec, column_integrate_pallas, deposit_2d_coherent

    ranks, whole = multichip
    for r in ranks + [whole]:
        assert not isinstance(r, RankError), r.trace if isinstance(r, RankError) else ""
    r0 = ranks[0]
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    assert all(r["reorder"] == {"exact": True, "matched": True} for r in ranks)
    for r in ranks[1:]:
        assert np.array_equal(r["coherent_map"], r0["coherent_map"])
        assert np.array_equal(r["columns_values"], r0["columns_values"])
        assert r["cube"]["mass"] == r0["cube"]["mass"]
    # the four slabs make the one-rank cube (K = 4 windows, as the JAX example)
    assert rel_err(np.concatenate([r["cube_slab"] for r in ranks]), whole) <= TOL
    # the single-device engines on the whole input (the example's own draws)
    rng = np.random.default_rng(11)
    box, n = 20.0, 24_000
    px = box / 256
    x = rng.uniform(0, box, n).astype(np.float32)
    y = rng.uniform(0, box, n).astype(np.float32)
    order = np.argsort((x // (16 * px)).astype(np.int64) * 1024 + (y // (16 * px)))
    x, y = x[order], y[order]
    h = np.exp(rng.normal(np.log(0.6 * px), 0.7, n)).clip(0.05 * px, 10 * px)
    m = rng.uniform(0.5, 2.0, n).astype(np.float32)
    t = rng.uniform(1e4, 1e6, n).astype(np.float32)
    spec = MapSpec(shape=(256, 256), extent=(0, box, 0, box), periodic_wrap=True)
    ref = deposit_2d_coherent(x, y, h.astype(np.float32), np.stack([m, m * t]), spec, device="cpu")
    assert rel_err(r0["coherent_map"], ref) <= TOL
    # the 3D and reorder draws come next in the example's sequence
    rng.uniform(0, box, (6_000, 3))
    rng.uniform(0.2, 0.8, 6_000)
    rng.uniform(0.5, 2.0, 6_000)
    rng.permutation(4 * 512)
    rng.permutation(4 * 512)
    rng.normal(size=4 * 512)
    rx, ry = rng.uniform(0, box, 16), rng.uniform(0, box, 16)
    cols = column_integrate_pallas(x, y, h.astype(np.float32), m, rx, ry, periodic_box=box, device="cpu")
    assert rel_err(r0["columns_values"], cols) <= TOL
