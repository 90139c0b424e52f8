"""Port vs JAX: ID-matched reordering (``ops/reorder.py``).

Mirrors ``tests/test_reorder.py``. The port's NumPy path is the JAX
package's, copied, so plans and reordered data must be equal to JAX's
NumPy results exactly (``np.array_equal``); so must the torch path (torch
tensors in, matched with ``torch.sort`` / ``torch.searchsorted`` on int64 IDs
on their device), whose results are tensors.
"""

import numpy as np
import pytest
import torch

from astro_sph_tools_tpu.ops.reorder import ArrayMapping as JMapping
from astro_sph_tools_tpu.ops.reorder import ArrayReorder as JReorder
from astro_sph_tools_tpu.ops.reorder import match_ids as j_match
from astro_sph_tools_tpu_torch import ops, tools
from astro_sph_tools_tpu_torch.ops.reorder import ArrayMapping, ArrayReorder, MatchPlan, match_ids
from astro_sph_tools_tpu_torch.units import UnitArray

BACKENDS = ("numpy", "tensor", "xp_torch")


def port_inputs(backend, *arrays):
    """The arrays as the backend takes them, and the ``xp`` to pass."""
    if backend == "tensor":
        return [None if a is None else torch.as_tensor(a) for a in arrays], np
    return list(arrays), (torch if backend == "xp_torch" else np)


def host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_same(got, ref, backend):
    if backend != "numpy":
        assert isinstance(got, torch.Tensor)
    assert np.array_equal(host(got), np.asarray(ref), equal_nan=True)


SCENARIOS = {
    "permutation": (np.array([10, 20, 30, 40]), np.array([30, 10, 40, 20]), None, None,
                    np.array([1.0, 2.0, 3.0, 4.0]), {}),
    "partial_overlap_default": (np.array([1, 2, 3, 4]), np.array([3, 4, 5, 6]), None, None,
                                np.array([10.0, 20.0, 30.0, 40.0]), {"default_value": -1.0}),
    "output_array": (np.array([1, 2]), np.array([2, 9]), None, None, np.array([1.0, 2.0]),
                     {"output_array": np.array([100.0, 200.0])}),
    "output_array_and_default": (np.array([1, 2]), np.array([2, 9]), None, None, np.array([1.0, 2.0]),
                                 {"output_array": np.array([100.0, 200.0]), "default_value": 7.0}),
    "source_filter": (np.array([1, 2, 3]), np.array([1, 2, 3]), np.array([True, False, True]), None,
                      np.array([10.0, 20.0, 30.0]), {"default_value": 0.0}),
    "target_filter": (np.array([1, 2, 3]), np.array([1, 2, 3]), None, np.array([True, True, False]),
                      np.array([10.0, 20.0, 30.0]), {"default_value": -5.0}),
    "payload_2d": (np.array([5, 6, 7]), np.array([7, 5, 6]), None, None, np.arange(9.0).reshape(3, 3), {}),
    "subset": (np.array([1, 2, 3, 4]), np.array([2, 4]), None, None, np.array([1.0, 2.0, 3.0, 4.0]), {}),
    "int64_above_2_32": (2**40 + np.array([3, 1, 2], dtype=np.int64), 2**40 + np.array([2, 3], dtype=np.int64),
                         None, None, np.array([1.0, 2.0, 3.0]), {}),
}

FLAGS = ("lossless", "matched_items", "uses_all_inputs", "all_outputs_matched", "matches_are_reduction",
         "results_are_expansion", "results_are_subset", "results_are_superset", "input_length",
         "output_length")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_reorder_matches_jax(name, backend):
    src, tgt, sf, tf, data, call = SCENARIOS[name]
    ref = JReorder.create(src, tgt, sf, tf)
    (psrc, ptgt, psf, ptf), xp = port_inputs(backend, src, tgt, sf, tf)
    op = ArrayReorder.create(psrc, ptgt, psf, ptf, xp=xp)
    for flag in FLAGS:
        assert getattr(op, flag) == getattr(ref, flag), flag
    for attr in ("input_filter", "output_filter"):
        assert_same(getattr(op, attr), getattr(ref, attr), backend)
    assert_same(op(data, **call), ref(data, **call), backend)
    # the reverse operator reorders back
    back_ref = ref.reverse(ref(data, **call), default_value=0.0)
    assert_same(op.reverse(op(data, **call), default_value=0.0), back_ref, backend)


@pytest.mark.parametrize("backend", BACKENDS)
def test_match_plan_matches_jax(backend, rng):
    n = 3000
    src = rng.permutation(n * 3)[:n].astype(np.int64) + 2**33
    keep = rng.random(n) > 0.3
    tgt = rng.permutation(np.concatenate([src[keep], 2**33 + n * 3 + np.arange(50)]))
    sf = rng.random(n) > 0.1
    tf = rng.random(tgt.size) > 0.1
    ref = j_match(src, tgt, sf, tf)
    (psrc, ptgt, psf, ptf), xp = port_inputs(backend, src, tgt, sf, tf)
    plan = match_ids(psrc, ptgt, psf, ptf, xp=xp)
    assert isinstance(plan, MatchPlan) and plan.n_matched == ref.n_matched
    assert_same(plan.source_matched, ref.source_matched, backend)
    assert_same(plan.target_matched, ref.target_matched, backend)
    # the gather index is arbitrary where unmatched
    hit = np.asarray(ref.target_matched)
    assert np.array_equal(host(plan.gather_index)[hit], np.asarray(ref.gather_index)[hit])


@pytest.mark.parametrize("backend", BACKENDS)
def test_mapping_matches_jax(backend):
    src = np.array([1, 2, 3])
    tgt = np.array([2, 2, 1, 3, 1, 7])
    data = np.array([10.0, 20.0, 30.0])
    ref = JMapping(src, tgt)
    (psrc, ptgt), xp = port_inputs(backend, src, tgt)
    op = ArrayMapping(psrc, ptgt, xp=xp)
    assert_same(op(data, default_value=np.nan), ref(data, default_value=np.nan), backend)
    assert op.results_are_expansion == ref.results_are_expansion
    with pytest.raises(ValueError):
        op(data)
    (dsrc, dtgt), xp = port_inputs(backend, np.array([1, 1, 2]), np.array([1, 2]))
    with pytest.raises(IndexError):
        ArrayMapping(dsrc, dtgt, xp=xp)
    (fsrc, ftgt, ff), xp = port_inputs(backend, np.array([1, 1, 2]), np.array([1, 2]), np.array([True, False, True]))
    op = ArrayMapping(fsrc, ftgt, source_id_filter=ff, xp=xp)
    assert_same(op(np.array([10.0, 99.0, 20.0])), [10.0, 20.0], backend)


def test_unit_array_payload():
    op = ArrayReorder.create(torch.tensor([5, 6, 7]), torch.tensor([7, 5, 6]))
    out = op(UnitArray(torch.tensor([1.0, 2.0, 3.0]), "Mpc"))
    assert isinstance(out, UnitArray) and out.units.symbol == "Mpc"
    assert torch.equal(out.value, torch.tensor([3.0, 1.0, 2.0]))


def test_large_random_tensor_ids(rng):
    n = 20000
    src = rng.permutation(n * 3)[:n]
    keep = rng.random(n) > 0.3
    tgt = rng.permutation(src[keep])
    data = rng.normal(size=n)
    op = ArrayReorder.create(torch.as_tensor(src), torch.as_tensor(tgt))
    out = op(torch.as_tensor(data))
    assert np.array_equal(out.numpy(), JReorder.create(src, tgt)(data))


def test_bad_xp_refused():
    with pytest.raises(ValueError, match="numpy or torch"):
        match_ids(np.array([1]), np.array([1]), xp=object())


@pytest.mark.cuda
def test_tensor_ids_match_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    src = torch.tensor([2**40 + 3, 2**40 + 1, 2**40 + 2], device="cuda")
    tgt = torch.tensor([2**40 + 2, 2**40 + 3], device="cuda")
    op = ArrayReorder.create(src, tgt)
    out = op(torch.tensor([1.0, 2.0, 3.0], device="cuda"))
    assert out.device.type == "cuda" and out.tolist() == [3.0, 1.0]


def test_exported_names():
    assert ops.ArrayReorder is ArrayReorder and ops.match_ids is match_ids
    assert tools.ArrayReorder is ArrayReorder and tools.ArrayMapping is ArrayMapping
