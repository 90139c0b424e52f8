"""The port's plain CPU path is inside the budget on a fresh process's
first multi-threaded call.

On this CPU host, PyTorch's first call of ``sqrt`` / ``exp`` / ``log``
split over the intra-op threads (tensors past the 32,768-element grain)
came back 1e-4 to 3e-4 wrong in some fresh processes: 19 of 64 runs of the
probe below before the package warmed the math library at import
(``astro_sph_tools_tpu_torch/_cpu_math.py``), 0 of 64 after. Each run here
is a fresh process: ``chip_smoke.py --cpu-probe port`` (the package's
``deposit_2d_auto(..., device="cpu")`` of 3,454 particles with f64 offsets
into a 48^2 cutout, temporaries of ~73,000 elements) held to the f64
oracle of ``tests/oracles.py`` at 1e-5 * max. Four runs take ~15 s alone,
~35 s beside the other workers of the fast lane.
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


@pytest.mark.parametrize("run", range(4))
def test_fresh_process_plain_deposit_matches_the_oracle(run):
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--cpu-probe", "port"],
        capture_output=True, text=True, timeout=120, check=True, cwd=ROOT,
    )
    probe = json.loads(out.stdout.strip().splitlines()[-1])
    assert probe["kind"] == "port" and probe["rel_err"] <= TOL, probe
