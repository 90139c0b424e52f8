"""Run one cell once: inputs from the seed, warm-up, the measured window,
the comparison with the reference, and the metrics, all found by name.

A cell of ``BENCHMARK.json`` names a configuration (its ``file``), a traffic
mix (``workloads/<traffic>.json``) and a chip count. The configuration's
``snapshot.generator`` names ``generators/<name>.py``, its ``product.kind``
names ``reference/<kind>.py``, the traffic's ``entry`` names
``entries/<entry>.py``, each metric names ``metrics/<metric>.py``, and the
cell's limits are ``limits/<cell>.json``. Adding any of them is adding a
file.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import random
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from sphbench import compare, devtrace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PROGRAM = "astro_sph_tools_tpu_torch"
#: top-level modules that may not be loaded in a run (compared whole: the
#: program's name begins with the JAX package's)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "astro_sph_tools_tpu"})


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default
    ``sys.modules``), each module name cut at its first dot."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".", 1)[0] for name in names} & FORBIDDEN)


def load_module(path: Path):
    """Import the Python file at ``path`` under a name of its own."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    name = "sphbench_" + "_".join(path.with_suffix("").relative_to(path.parents[1]).parts)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """Everything a run of one cell reads, found by name under ``root``."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    root: Path

    def module(self, kind: str, name: str):
        return load_module(self.root / kind / f"{name}.py")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(spec: dict, name: str, root: Path = HERE, checkout: Path = ROOT, overrides: dict = None) -> Cell:
    """The cell ``name`` of the benchmark ``spec`` (BENCHMARK.json's
    contents). ``overrides`` replaces keys of the configuration's groups
    (tests shrink a cell with it)."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in the benchmark (have {sorted(cells)})")
    entry = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(checkout / configs[entry["config"]]["file"])
    for group, values in (overrides or {}).items():
        config[group] = {**config[group], **values}
    return Cell(
        name=name, chips=int(entry["chips"]), config=config,
        traffic=load_json(root / "workloads" / f"{entry['traffic']}.json"),
        limits=load_json(root / "limits" / f"{name}.json")["limits"],
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
        root=root,
    )


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def make_inputs(cell: Cell, seed: int, device) -> dict:
    """The particles (and the haloes the traffic's ``haloes`` asks for, by
    their index in the catalogue) from the seed, as float32
    tensors on the card, in the order the traffic's ``order`` says: "sfc"
    keeps the generator's curve order, "shuffled" permutes every particle
    by a permutation drawn from the seed."""
    snap = cell.config["snapshot"]
    gen = cell.module("generators", snap["generator"])
    inputs = gen.generate(snap, seed, device)
    if "haloes" in cell.config:
        centres, r200 = gen.haloes(snap, cell.config["haloes"])
        asked = list(cell.traffic["haloes"])  # the catalogue's haloes a request asks for
        inputs["halo_centres"], inputs["halo_r200"] = centres[asked], r200[asked]
    order = cell.traffic["order"]
    if order == "shuffled":
        g = torch.Generator(device=device)
        g.manual_seed((int(seed) + 0x5EED) % (1 << 63))
        perm = torch.randperm(inputs["masses"].shape[0], generator=g, device=device)
        for k, v in inputs.items():
            if isinstance(v, torch.Tensor):
                inputs[k] = v[perm]
        del perm
    elif order != "sfc":
        raise ValueError(f"unknown order {order!r} (sfc | shuffled)")
    return inputs


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------


@dataclass
class Run:
    """What a run measured, for the metric readers: per product its host
    wall (s) and the program's phase timings (s); the set-up and window
    seconds; the peak of allocated device memory over the window; the trace
    (``devtrace.Trace``) of a traced run; and ``work()``, the least time of
    one product (``counting.least_seconds``)."""

    cell: Cell
    device: object
    inputs: dict
    walls: list = field(default_factory=list)
    timings: list = field(default_factory=list)
    setup_s: float = 0.0
    window_s: float = 0.0
    peak_bytes: int = 0
    trace: object = None
    _work: dict = None

    def work(self) -> dict:
        if self._work is None:
            kind = self.cell.config["product"]["kind"]
            self._work = self.cell.module("reference", kind).work(self.inputs, self.cell.config, self.device)
        return self._work


@dataclass
class Context:
    """What an entry's ``setup`` is given."""

    inputs: dict
    config: dict
    traffic: dict
    device: object
    rank: int = 0
    world: int = 1


def _by_second(walls: list) -> list:
    """The mean wall (ms) of the products that ended in each second of the
    window, in order: where a run is slow, and when."""
    out, t, acc = [], 0.0, []
    for w in walls:
        t += w
        acc.append(w)
        if t >= len(out) + 1:
            out.append(round(1e3 * sum(acc) / len(acc), 3))
            acc = []
    if acc:
        out.append(round(1e3 * sum(acc) / len(acc), 3))
    return out


def _phases(record: Run) -> dict:
    """Each of the program's phases (``timings``), and the rest of a
    product's wall outside them, as [first quartile, median, third
    quartile] over the window's products (ms): which phase carries the
    spread of the walls."""
    rows = [dict(t, other=w - sum(t.values())) for w, t in zip(record.walls, record.timings)]
    out = {}
    for name in sorted({k for r in rows for k in r}):
        v = sorted(1e3 * r.get(name, 0.0) for r in rows)
        out[name] = [v[len(v) // 4], v[len(v) // 2], v[(3 * len(v)) // 4]]
    return out


def _finite(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def run(spec: dict, name: str, seed: int, seconds: float, trace: bool, *, t0: float, device="cuda",
        rank: int = 0, world: int = 1, root: Path = HERE, checkout: Path = ROOT, overrides: dict = None,
        product=None, warm: bool = True) -> dict:
    """One run of the cell ``name``: returns the result line's object (on
    rank 0; other ranks return what rank 0 gathers from them). ``t0``: the
    host clock when the process started. ``product`` replaces the entry's
    ``setup`` (the control and the fault tests put their own in the
    program's place). ``warm`` False leaves out the warm-up product (a
    calibration's later seeds, whose shapes an earlier seed warmed)."""
    cell = find_cell(spec, name, root, checkout, overrides)
    device = torch.device(device)
    inputs = make_inputs(cell, seed, device)
    ctx = Context(inputs, cell.config, cell.traffic, device, rank, world)
    setup = product if product is not None else cell.module("entries", cell.traffic["entry"]).setup
    call = setup(ctx)
    if warm:
        call()  # one warm-up product: every shape the window uses, every library built and loaded
    _sync(device)
    record = Run(cell, device, inputs)
    record.setup_s = time.perf_counter() - t0

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    rng = random.Random(int(seed))
    kept: dict = {}  # the first, a uniformly drawn and the last product's answers
    attempted = failed = 0
    errors: list = []
    with devtrace.traced(trace, device) as tr:
        start = time.perf_counter()
        while True:
            go = time.perf_counter() - start < seconds
            if world > 1:
                flag = [go]
                torch.distributed.broadcast_object_list(flag, src=0)
                go = flag[0]
            if not go:
                break
            attempted += 1
            t = time.perf_counter()
            try:
                answers, timings = call()
            except Exception as exc:  # a failed product is counted and reported, the window goes on
                failed += 1
                errors.append(f"{type(exc).__name__}: {exc}")
                continue
            record.walls.append(time.perf_counter() - t)
            record.timings.append(timings)
            n_done = len(record.walls)
            if n_done == 1:
                kept["first"] = answers
            elif rng.random() < 1.0 / (n_done - 1):
                kept["drawn"] = answers
            kept["last"] = answers
        record.window_s = time.perf_counter() - start
    record.trace = tr
    _sync(device)
    if device.type == "cuda":
        record.peak_bytes = int(torch.cuda.max_memory_allocated(device))
    found = forbidden_modules()

    # the program's state goes before the reference runs on the card
    del call, setup
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    kind = cell.module("reference", cell.config["product"]["kind"])
    reference = kind.maps(inputs, cell.config, device)
    readings = [compare.numbers(answers, reference) for answers in kept.values()]
    values = compare.worst(readings)
    correct, checks = compare.judge(values, cell.limits)
    correct = correct and failed == 0 and bool(record.walls)
    del reference, kept
    reference_s = time.perf_counter() - t_ref

    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = cell.module("metrics", m["name"]).read(record) if record.walls else None
        if _finite(value) is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": world,
        "memory_peak_bytes": record.peak_bytes,
    }
    if trace and tr is not None:
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
    if world > 1:
        mine = {"correct": correct, "failed": failed, "found": found, "errors": errors[:3],
                "peak_bytes": record.peak_bytes, "busy_s": device_info.get("busy_s")}
        everyone = [None] * world
        torch.distributed.all_gather_object(everyone, mine)
        found = sorted({m for r in everyone for m in r["found"]})
        failed = sum(r["failed"] for r in everyone)
        correct = all(r["correct"] for r in everyone)
        errors = [e for r in everyone for e in r["errors"]][:3]
        device_info["memory_peak_bytes"] = max(r["peak_bytes"] for r in everyone)
        if trace and tr is not None:
            device_info["busy_s"] = sum(r["busy_s"] or 0.0 for r in everyone) / world
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": device_info}
    if trace and tr is not None:
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    result["products"] = len(record.walls)
    result["walls_by_second_ms"] = _by_second(record.walls)
    result["walls_ms"] = [1e3 * float(np.min(record.walls)), 1e3 * float(np.median(record.walls)),
                          1e3 * float(np.max(record.walls))] if record.walls else []
    result["phases_ms"] = _phases(record)
    result["reference_s"] = reference_s
    result["found_forbidden"] = found
    result["errors"] = errors[:3]
    result["readings"] = {k: _finite(v) for k, v in values.items()}
    result["checks"] = {k: {"value": _finite(c["value"]), "limit": c["limit"]} for k, c in checks.items()}
    return result


# ---------------------------------------------------------------------------
# one process a chip
# ---------------------------------------------------------------------------


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(spec, name, seed, seconds, trace, device_type, rank, world, port, root, checkout, overrides):
    """A rank above 0 of a cell on several chips (a spawned process)."""
    t0 = time.perf_counter()
    device = torch.device(f"cuda:{rank}") if device_type == "cuda" else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    torch.distributed.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                         init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world)
    try:
        run(spec, name, seed, seconds, trace, t0=t0, device=device, rank=rank, world=world, root=root,
            checkout=checkout, overrides=overrides)
    finally:
        torch.distributed.destroy_process_group()


def launch(spec: dict, name: str, seed: int, seconds: float, trace: bool, *, t0: float, device_type="cuda",
           root: Path = HERE, checkout: Path = ROOT, overrides: dict = None, timeout_s: float = 600.0) -> dict:
    """Run the cell on as many chips as it asks for: this process is rank 0,
    each other rank a spawned process on its own card; every one is waited
    for, and one left running after ``timeout_s`` is ended."""
    chips = find_cell(spec, name, root, checkout, overrides).chips
    if chips == 1:
        device = "cuda" if device_type == "cuda" else "cpu"
        return run(spec, name, seed, seconds, trace, t0=t0, device=device, root=root, checkout=checkout,
                   overrides=overrides)
    import multiprocessing

    port = free_port()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(spec, name, seed, seconds, trace, device_type, r, chips, port,
                                                 root, checkout, overrides)) for r in range(1, chips)]
    for p in procs:
        p.start()
    try:
        device = torch.device("cuda:0") if device_type == "cuda" else torch.device("cpu")
        if device.type == "cuda":
            torch.cuda.set_device(device)
        torch.distributed.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                             init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=chips)
        try:
            result = run(spec, name, seed, seconds, trace, t0=t0, device=device, rank=0, world=chips, root=root,
                         checkout=checkout, overrides=overrides)
        finally:
            torch.distributed.destroy_process_group()
    finally:
        deadline = time.monotonic() + timeout_s
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"a rank exited with {bad}")
    return result
