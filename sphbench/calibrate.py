"""Read the numbers the limits are set from, on the card at a cell's size:
the program's readings over many seeds, the control's and the faults'
over a few, each in a short window of the cell's own entry, in one process.

    python3 sphbench/calibrate.py --workload <cell> --seeds 1 2 ... [--control-seeds ...]
        [--fault-seeds ...] [--seconds 2] [--out PATH]

Prints one JSON line a run: the mode (program, control or a fault), the
seed, ``correct`` under the limits now in ``limits/<cell>.json`` and every
number of ``compare.NUMBERS``. Not run by the benchmark's own runs.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None, help="also append the lines to this file")
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from sphbench import faults, harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    plan = [("program", None, s) for s in args.seeds]
    plan += [("control", faults.control, s) for s in args.control_seeds]
    plan += [(name, fn, s) for s in args.fault_seeds for name, fn in faults.FAULTS.items()]
    warmed = set()  # one warm-up product for each mode; later seeds use the same shapes
    for mode, product, seed in plan:
        t = time.perf_counter()
        r = harness.run(spec, args.workload, seed, args.seconds, False, t0=t, product=product,
                        warm=mode not in warmed)
        warmed.add(mode)
        line = json.dumps({"workload": args.workload, "mode": mode, "seed": seed, "correct": r["correct"],
                           "products": r["products"], "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                           "reference_s": r["reference_s"], "run_s": time.perf_counter() - t,
                           "readings": r["readings"]})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
