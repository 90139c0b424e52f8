"""Port vs JAX: determinism helpers (``utils/determinism.py``).

- ``hash_array`` equals the JAX package's digest for the same NumPy array,
  and a tensor hashes as the NumPy array of its values and dtype, whatever
  its device; dtype and shape change the digest.
- ``hash_pytree`` equals JAX's over nested dicts and lists of arrays.
- ``assert_deterministic`` passes the port's plain deposit (bitwise
  reproducible on the CPU) and catches a function that differs between
  calls.
- ``assert_consistent_across_processes`` is a no-op without a process
  group, passes two gloo processes that hold the same data and fails two
  that do not.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from astro_sph_tools_tpu.utils import determinism as JD
from astro_sph_tools_tpu_torch.ops import MapSpec, deposit_2d_auto
from astro_sph_tools_tpu_torch.utils import determinism as D

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32, np.int64, np.uint8, np.float16])
def test_hash_array_matches_jax_and_ignores_the_container(dtype):
    a = (np.random.default_rng(1).normal(size=(8, 5)) * 100).astype(dtype)
    assert D.hash_array(a) == JD.hash_array(a)
    assert D.hash_array(torch.from_numpy(a)) == D.hash_array(a)
    assert D.hash_array(torch.from_numpy(a.copy()).t().contiguous().t()) == D.hash_array(a)  # strides
    assert D.hash_array(a.reshape(5, 8)) != D.hash_array(a)


def test_hash_depends_on_dtype_and_value():
    a = np.zeros(16, np.float32)
    assert D.hash_array(a) != D.hash_array(a.astype(np.float64))
    b = a.copy()
    b[3] = 1e-7
    assert D.hash_array(a) != D.hash_array(b)
    bf = torch.zeros(16, dtype=torch.bfloat16)
    assert D.hash_array(bf) != D.hash_array(torch.zeros(16, dtype=torch.int16))


def test_hash_pytree_matches_jax():
    rng = np.random.default_rng(2)
    tree = {"b": [rng.normal(size=3), rng.normal(size=(2, 2))], "a": rng.normal(size=4)}
    assert D.hash_pytree(tree) == JD.hash_pytree(tree)
    as_tensors = {"a": torch.from_numpy(tree["a"]), "b": [torch.from_numpy(t) for t in tree["b"]]}
    assert D.hash_pytree(as_tensors) == D.hash_pytree(tree)


def test_assert_deterministic_passes_the_plain_deposit_and_catches_a_flaky_function():
    rng = np.random.default_rng(3)
    n = 3000
    x, y = rng.uniform(0, 10, n), rng.uniform(0, 10, n)
    h = rng.uniform(0.1, 0.6, n).astype(np.float32)
    m = rng.uniform(0.5, 2, n).astype(np.float32)
    spec = MapSpec(shape=(48, 48), extent=(0.0, 10.0, 0.0, 10.0))
    digest = D.assert_deterministic(lambda: deposit_2d_auto(x, y, h, m, spec, device="cpu"), n_runs=3)
    assert len(digest) == 64
    calls = {"i": 0}

    def flaky():
        calls["i"] += 1
        return torch.full((4,), float(calls["i"]))

    with pytest.raises(AssertionError, match="Nondeterministic"):
        D.assert_deterministic(flaky, n_runs=2)


WORKER = """
import sys
import torch, torch.distributed as dist
from astro_sph_tools_tpu_torch.utils.determinism import assert_consistent_across_processes
rank, port, mode = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=2)
value = {"x": torch.arange(5.0) + (rank if mode == "differ" else 0)}
try:
    assert_consistent_across_processes(value)
    print("consistent")
except AssertionError:
    print("inconsistent")
dist.destroy_process_group()
"""


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("mode", ["same", "differ"])
def test_consistency_across_two_processes(mode):
    D.assert_consistent_across_processes(torch.arange(3))  # no group: a no-op
    port = str(free_port())
    procs = [
        subprocess.Popen([sys.executable, "-c", WORKER, str(r), port, mode], cwd=ROOT,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)
    ]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
    want = "consistent" if mode == "same" else "inconsistent"
    assert [o[0].strip().splitlines()[-1] for o in outs] == [want, want]
