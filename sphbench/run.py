"""Run one cell of the benchmark once and print its result line.

    python3 sphbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds BENCHMARK.json and the program
(``astro_sph_tools_tpu_torch``). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` a ``breakdown``, and last ``checks``: each compared
number beside its limit, which also close standard error. The run exits
with another code than 0, and prints no result, when there is no CUDA card
(or fewer than the cell asks for), when the program is not in the checkout,
and when JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="a cell's name in BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True, help="draws the inputs; the same seed, the same inputs")
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0, help="1: trace the window, report per-layer metrics")
    return p.parse_args(argv)


def fail(message: str, code: int = 2) -> int:
    print(f"sphbench: {message}", file=sys.stderr, flush=True)
    return code


#: the keys of the printed line, in order; ``checks`` comes last
LINE_KEYS = ("correct", "attempted", "failed", "metrics", "device", "breakdown", "checks")


def emit(result: dict, out=None, err=None) -> None:
    """Print a run's result: what is not on the line (failed products'
    errors, the products and the reference's seconds) and then each
    compared number beside its limit to standard error; the line, the
    contract's keys with ``checks`` last, to standard output."""
    out, err = out or sys.stdout, err or sys.stderr
    for line in result["errors"]:
        print(f"sphbench: a product failed: {line}", file=err)
    print(f"sphbench: {result['products']} products, walls min/median/max {result['walls_ms']} ms, "
          f"reference {result['reference_s']:.3f} s", file=err)
    print(f"sphbench: mean wall by second of the window {result['walls_by_second_ms']} ms", file=err)
    print(f"sphbench: phases, quartiles and median over the products {result['phases_ms']} ms", file=err)
    print(f"sphbench: every compared number {result['readings']}", file=err)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=err)
    err.flush()
    print(json.dumps({k: result[k] for k in LINE_KEYS if k in result}), file=out, flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from sphbench import harness

    if not (harness.ROOT / harness.PROGRAM / "__init__.py").is_file():
        return fail(f"the program {harness.PROGRAM} is not in the checkout {harness.ROOT}")
    import torch

    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    chips = harness.find_cell(spec, args.workload).chips
    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        return fail(f"the cell asks for {chips} cards, this machine has {torch.cuda.device_count()}")
    import importlib

    program = importlib.import_module(harness.PROGRAM)
    if not os.path.abspath(program.__file__).startswith(str(harness.ROOT) + os.sep):
        return fail(f"{harness.PROGRAM} was imported from {program.__file__}, not from the checkout")
    result = harness.launch(spec, args.workload, args.seed, args.seconds, bool(args.trace), t0=T0)
    found = sorted(set(result["found_forbidden"]) | set(harness.forbidden_modules()))
    if found:
        return fail(f"modules of JAX or of the JAX package were loaded: {found}", 3)
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
