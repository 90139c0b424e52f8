"""chip_smoke.py's phase 23 (b) on the CPU at small sizes: four gloo ranks
run ``par_rank_work`` (every entry point of ``parallel/`` on a rank's
shard) and ``par_check`` holds their outputs to the single-device engines
on the whole inputs, with the phase's own verdict (``check_par_rows``).
On the CPU no kernel launches, so the launch counts stay 0 here; the card
runs the phase in full."""

import pytest
import torch

import chip_smoke
import torch_parallel_tasks as T
from torch_dist import RankPool

SIZES = {"log2n": 16, "res": 256, "vox": 32, "vox_log2n": 14, "sight_log2n": 14, "rays": 64,
         "ids_log2n": 12, "rebalance_cap": 4096, "halo_res": 64}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    pool = RankPool(chip_smoke.PAR_RANKS, str(tmp_path_factory.mktemp("gloo")))
    try:
        return pool.run(T.smoke_rank, (SIZES,))
    finally:
        pool.close()


@pytest.fixture(scope="module")
def rows(results):
    return chip_smoke.par_check(torch, torch.device("cpu"), results, SIZES)


def test_phase_23_ranks_pass_the_phase_checks(results, rows):
    chip_smoke.check_par_rows(rows, results)
    assert rows["rebalance"]["counts_after"] == [1365, 1364, 1364, 1364]
    assert rows["reorder_partial"]["matched"] == rows["reorder_partial"]["n"] // 2
    for r in results:
        assert set(r["launches"]) == {"deposit2d", "coherent_prep", "coherent_deposit", "sightline_columns",
                                      "sightline_spectra", "deposit3d"}
        assert all(v == 0 for v in r["launches"].values())  # no kernel on the CPU
        assert all(e["wall_s"] > 0 for e in r["entries"].values())
    # bytes each rank hands to the collectives: rank 2 holds nothing to rebalance
    assert [r["entries"]["rebalance"]["bytes_exchanged"] for r in results] == [4089 * 12, 3 * 12, 0, 1365 * 12]


def test_phase_23_checks_fail_a_wrong_rank(results, rows):
    import copy

    rows = copy.deepcopy(rows)
    rows["coherent_fused_tiny_caps_on_rank_3"]["ok"][1] = True
    with pytest.raises(AssertionError, match="every rank"):
        chip_smoke.check_par_rows(rows, results)


def test_rank_deadline_fails_the_phase(tmp_path):
    """A rank that outlives the deadline fails the phase, and every rank
    process is stopped."""
    import sys

    cmds = [[sys.executable, "-c", "import time; time.sleep(60)"], [sys.executable, "-c", "pass"]]
    with pytest.raises(AssertionError, match="outlived"):
        chip_smoke.run_ranks(cmds, str(tmp_path), timeout_s=2)
    cmds = [[sys.executable, "-c", "raise SystemExit(3)"], [sys.executable, "-c", "import time; time.sleep(60)"]]
    with pytest.raises(AssertionError, match="exit codes"):
        chip_smoke.run_ranks(cmds, str(tmp_path), timeout_s=30)
