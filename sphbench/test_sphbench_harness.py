"""CPU tests of the benchmark's harness at a tiny size.

    python -m pytest sphbench/ -q

The harness's look for a card is skipped by calling ``harness.run`` and
``harness.launch`` with a CPU device; the test marked ``cuda`` runs the
command itself on a card and skips without one.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from sphbench import harness, run as run_cli

SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
TINY = {"snapshot": {"n_particles": 1 << 14}, "product": {"resolution": 128}}
DIRS = ("configs", "workloads", "entries", "metrics", "reference", "generators", "limits")
SEED = 2**31 + 7  # past 32 signed bits: the command takes any such seed
CELLS = [w["name"] for w in SPEC["workloads"]]


def tiny_run(cell, trace=False, spec=SPEC, **kw):
    return harness.run(spec, cell, SEED, 0.2, trace, t0=0.0, device="cpu", overrides=TINY, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_is_found_by_name(cell):
    c = harness.find_cell(SPEC, cell)
    assert c.chips == 1 and c.limits
    snap = c.config["snapshot"]
    assert hasattr(c.module("generators", snap["generator"]), "generate")
    assert hasattr(c.module("entries", c.traffic["entry"]), "setup")
    kind = c.module("reference", c.config["product"]["kind"])
    assert hasattr(kind, "maps") and hasattr(kind, "work")
    for m in c.end_to_end + c.per_layer:
        assert hasattr(c.module("metrics", m["name"]), "read")
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer


def test_every_configuration_file_holds_its_entry():
    for entry in SPEC["configs"]:
        config = harness.load_json(harness.ROOT / entry["file"])
        assert config["name"] == entry["name"] and config["source"] == entry["source"]
        assert config["reduced"] == entry["reduced"]


def test_a_cell_and_a_metric_added_as_files_only_are_run(tmp_path):
    root = tmp_path / "bench"
    for d in DIRS:
        shutil.copytree(harness.HERE / d, root / d)
    traffic = harness.load_json(root / "workloads" / "map_sfc.json")
    traffic["engine"] = "xla"
    (root / "workloads" / "map_sfc_plain.json").write_text(json.dumps(traffic))
    shutil.copy(root / "limits" / "l0025_map_sfc.json", root / "limits" / "l0025_map_sfc_plain.json")
    (root / "metrics" / "products_done.py").write_text("def read(run):\n    return len(run.walls)\n")
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "l0025_map_sfc_plain", "config": "eagle_l0025_boxmap",
                              "traffic": "map_sfc_plain", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "products_done", "unit": "1", "better": "higher", "source": "host_clock",
                              "layer": "render", "moves": "stack_ms", "workloads": ["l0025_map_sfc_plain"]})
    r = harness.run(spec, "l0025_map_sfc_plain", SEED, 0.2, True, t0=0.0, device="cpu", overrides=TINY,
                    root=root)
    assert r["correct"], r["checks"]
    assert r["metrics"]["products_done"]["value"] == r["products"] >= 1


@pytest.mark.parametrize("cell", ["l0025_map_sfc", "l0025_haloes"])
@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run_of_each_entry_prints_the_contract_keys(cell, trace):
    result = tiny_run(cell, trace)
    out, err = io.StringIO(), io.StringIO()
    run_cli.emit(result, out, err)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == keys
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    wanted = {m["name"] for m in (SPEC["per_layer"] if trace else SPEC["end_to_end"])
              if "workloads" not in m or cell in m["workloads"]}
    # off the card the device metrics find nothing to read and are left out
    assert set(line["metrics"]) <= wanted
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    tail = err.getvalue().strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())


def test_the_no_jax_check_compares_whole_top_level_names():
    assert harness.forbidden_modules(["astro_sph_tools_tpu_torch", "astro_sph_tools_tpu_torch.ops",
                                      "jaxtyping", "flaxen", "numpy"]) == []
    assert harness.forbidden_modules(["jax.numpy", "astro_sph_tools_tpu.render", "flax"]) == \
        ["astro_sph_tools_tpu", "flax", "jax"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(harness.ROOT)!r})\n"
        "from sphbench import harness\n"
        "spec = harness.load_json(harness.ROOT / 'BENCHMARK.json')\n"
        f"r = harness.run(spec, 'l0025_haloes', 3, 0.1, True, t0=0.0, device='cpu', overrides={TINY!r})\n"
        "import sphbench.reference.scatter\n"
        "print(json.dumps([r['found_forbidden'], harness.forbidden_modules()]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [[], []]


def test_the_reference_imports_nothing_of_the_program():
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(harness.ROOT)!r})\n"
        "import sphbench.reference.scatter, sphbench.reference.box_map, sphbench.reference.halo_maps\n"
        "import sphbench.compare, sphbench.counting\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'astro_sph_tools_tpu', 'astro_sph_tools_tpu_torch'})))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_command_refuses_a_machine_without_a_card_and_a_checkout_without_the_program(tmp_path):
    bare = tmp_path / "bare"
    shutil.copytree(harness.HERE, bare / "sphbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", bare / "BENCHMARK.json")
    for where in (bare, harness.ROOT):
        out = subprocess.run([sys.executable, "sphbench/run.py", "--workload", "l0025_map_sfc", "--seed", "1",
                              "--seconds", "1", "--trace", "0"], cwd=where, capture_output=True, text=True,
                             timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": ""})
        assert out.returncode != 0 and out.stdout.strip() == "", (where, out.stdout, out.stderr)


def test_two_ranks_of_a_cell_on_two_chips_run_under_gloo(tmp_path):
    root = tmp_path / "bench"
    for d in DIRS:
        shutil.copytree(harness.HERE / d, root / d)
    shutil.copy(root / "limits" / "l0025_map_sfc.json", root / "limits" / "l0025_map_sfc_2.json")
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "l0025_map_sfc_2", "config": "eagle_l0025_boxmap", "traffic": "map_sfc",
                              "chips": 2, "why": "test"})
    r = harness.launch(spec, "l0025_map_sfc_2", SEED, 0.3, False, t0=0.0, device_type="cpu", root=root,
                       overrides=TINY, timeout_s=240)
    assert r["correct"] and r["device"]["count"] == 2 and r["failed"] == 0


@pytest.fixture()
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_the_command_runs_a_cell_on_the_card(cuda_device):
    out = subprocess.run([sys.executable, "sphbench/run.py", "--workload", "l0025_map_sfc", "--seed", str(SEED),
                          "--seconds", "2", "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert {"stack_ms", "setup_s", "peak_mem_gib"} <= set(line["metrics"])


def test_no_test_file_name_is_one_that_tests_uses():
    ours = {p.name for p in Path(harness.HERE).glob("test_*.py")}
    assert ours and not ours & {p.name for p in (harness.ROOT / "tests").glob("*.py")}
