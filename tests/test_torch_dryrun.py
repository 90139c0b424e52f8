"""``parallel.dryrun.dryrun_multichip``, the port of the JAX package's
``__graft_entry__.dryrun_multichip``: every step and check of the JAX
function on four gloo ranks on the CPU (``tests/torch_dist.py``), each rank
on its shard. On the CPU no kernel launches, so every launch count is 0;
``chip_smoke.py`` phase 24 runs it on the card."""

import pytest
import torch

import torch_parallel_tasks as T
from torch_dist import RankError, RankPool

from astro_sph_tools_tpu_torch.parallel.dryrun import dryrun_multichip
from astro_sph_tools_tpu_torch.ops import kernel_counters

STEPS = {"deposit_2d_sharded", "deposit_3d_sharded", "distributed_reorder", "deposit_2d_coherent_sharded",
         "deposit_2d_coherent_sharded_fused", "render_halo_maps_sharded", "sightlines_sharded", "rebalance_evenly"}


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(4, str(tmp_path_factory.mktemp("gloo")))
    yield p
    p.close()


def test_dryrun_multichip_on_four_ranks(pool):
    results = pool.run(T.dryrun, (4,))
    for rank, r in enumerate(results):
        assert not isinstance(r, RankError), r.trace if isinstance(r, RankError) else ""
        assert r["rank"] == rank and r["world"] == 4 and r["backend"] == "gloo" and r["device"] == "cpu"
        assert set(r["step_seconds"]) == STEPS and all(v > 0 for v in r["step_seconds"].values())
        assert set(r["launches"]) == set(kernel_counters()) and not any(r["launches"].values())


def test_dryrun_multichip_needs_the_world_it_names(pool):
    for r in pool.run(T.dryrun, (3,)):
        assert isinstance(r, RankError) and r.kind == "ValueError" and "n_devices=3" in r.message


def test_dryrun_multichip_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        dryrun_multichip(4, device="cpu")


def test_dryrun_main_refuses_a_missing_card(monkeypatch):
    from astro_sph_tools_tpu_torch.parallel import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["4"])
    assert not torch.distributed.is_initialized()


def test_dryrun_main_on_the_cpu_when_asked(tmp_path):
    """``python -m ...parallel.dryrun 1 --device cpu`` in a one-rank gloo
    world, as torchrun would set it up."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, WORLD_SIZE="1", RANK="0", LOCAL_RANK="0", MASTER_ADDR="localhost",
               MASTER_PORT=str(port), CUDA_VISIBLE_DEVICES="")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join([repo, env.get("PYTHONPATH", "")])
    r = subprocess.run([sys.executable, "-m", "astro_sph_tools_tpu_torch.parallel.dryrun", "1", "--device", "cpu"],
                       cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "dryrun_multichip(1)" in r.stdout and "ran OK" in r.stdout and "'backend': 'gloo'" in r.stdout
