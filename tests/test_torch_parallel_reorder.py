"""The port's ``distributed_reorder`` and ``rebalance_evenly`` over gloo on
the CPU, held exactly to the JAX package's on ``make_mesh(4)`` and
``make_mesh(1)`` (the cases of tests/test_distributed_reorder.py and
tests/test_rebalance.py), and the int64 rebalance plan past 2^31 on the
host alone."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_parallel_tasks as T
from astro_sph_tools_tpu.parallel.rebalance import rebalance_evenly as j_rebalance_evenly
from astro_sph_tools_tpu.parallel.reorder import distributed_reorder as j_distributed_reorder
from astro_sph_tools_tpu.parallel.sharded import make_mesh as j_make_mesh
from astro_sph_tools_tpu_torch.parallel.rebalance import rebalance_plan
from torch_dist import RankError, RankPool


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(4, str(tmp_path_factory.mktemp("gloo")))
    yield p
    p.close()


def _ranks(world):
    return range(4 if world == 4 else 1)


def j_reorder(world, src_ids, data, tgt_ids, **kw):
    """JAX's ``distributed_reorder`` under one ``jax.jit``. Its default
    exact-capacity path runs its ``shard_map`` eagerly (~20 s a call on
    this CPU); ``capacity_factor = world`` sizes every bucket to a whole
    shard, which never overflows and gives the exact path's values."""
    kw = {"capacity_factor": float(world), **kw}
    mesh = j_make_mesh(world)
    if src_ids.dtype == np.int64:  # int64 IDs split into (hi, lo) on the host, at trace time
        return jax.jit(lambda d: j_distributed_reorder(src_ids, d, tgt_ids, mesh, **kw))(jnp.asarray(data))
    return jax.jit(lambda s, d, t: j_distributed_reorder(s, d, t, mesh, **kw))(
        jnp.asarray(src_ids), jnp.asarray(data), jnp.asarray(tgt_ids)
    )


def run_both(pool, world, src_ids, data, tgt_ids, **kw):
    """(port's (values, matched, overflow), JAX's) on ``world`` ranks."""
    j_out, j_matched, j_overflow = j_reorder(world, src_ids, data, tgt_ids, **kw)
    got = pool.run(T.reorder, (world, src_ids, data, tgt_ids, kw), ranks=_ranks(world))
    out = np.concatenate([g[0] for g in got])
    matched = np.concatenate([g[1] for g in got])
    overflows = {g[2] for g in got}
    assert len(overflows) == 1  # every rank reports the same flag
    return (out, matched, overflows.pop()), (np.asarray(j_out), np.asarray(j_matched), bool(j_overflow))


def assert_same(got, ref):
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[2] == ref[2]


@pytest.mark.parametrize("world", [4, 1])
def test_full_permutation(pool, rng, world):
    n = 8 * 64
    src_ids = rng.permutation(n).astype(np.int32)
    tgt_ids = rng.permutation(n).astype(np.int32)
    data = rng.normal(size=n).astype(np.float32)
    got, ref = run_both(pool, world, src_ids, data, tgt_ids)
    assert_same(got, ref)
    assert got[1].all() and not got[2]


@pytest.mark.parametrize("world", [4, 1])
def test_partial_overlap_default(pool, rng, world):
    n = 8 * 32
    src_ids = rng.permutation(n * 2)[:n].astype(np.int32)
    tgt_ids = rng.permutation(n * 2)[:n].astype(np.int32)
    data = rng.normal(size=n).astype(np.float32)
    got, ref = run_both(pool, world, src_ids, data, tgt_ids, default_value=-99.0)
    assert_same(got, ref)
    assert (got[0][~got[1]] == -99.0).all() and 0 < got[1].sum() < n


def test_vector_payload(pool, rng):
    n = 8 * 16
    src_ids = rng.permutation(n).astype(np.int32)
    tgt_ids = rng.permutation(n).astype(np.int32)
    data = rng.normal(size=(n, 3)).astype(np.float32)
    got, ref = run_both(pool, 4, src_ids, data, tgt_ids)
    assert got[0].shape == (n, 3)
    assert_same(got, ref)


@pytest.mark.parametrize("world", [4, 1])
def test_overflow_flag(pool, world):
    # every ID hashes to owner 0: the buckets of capacity_factor 1 overflow
    # on the four ranks (not on one, where the one bucket holds all)
    n = 8 * 32
    src_ids = np.arange(n, dtype=np.int32) * 8
    tgt_ids = src_ids[::-1].copy()
    data = np.arange(n, dtype=np.float32)
    got, ref = run_both(pool, world, src_ids, data, tgt_ids, capacity_factor=1.0)
    assert got[2] == ref[2] == (world == 4)
    # the port's values stay complete where the JAX engine dropped some
    np.testing.assert_array_equal(got[0], data[::-1])
    assert got[1].all()


def test_matches_single_device_reference(pool, rng):
    n = 8 * 48
    src_ids = rng.permutation(n * 3)[:n].astype(np.int32)
    keep = rng.random(n) > 0.25
    tgt_pool = np.concatenate([src_ids[keep], (np.arange(50) + n * 10).astype(np.int32)])
    tgt_ids = rng.permutation(tgt_pool)[: 8 * 40].astype(np.int32)
    data = rng.normal(size=n).astype(np.float32)
    got, ref = run_both(pool, 4, src_ids, data, tgt_ids, default_value=np.nan)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ~np.isnan(got[0]))


@pytest.mark.parametrize("world", [4, 1])
def test_int64_ids_beyond_2_32(pool, rng, world):
    n = 8 * 64
    # unique int64 IDs straddling 2^32 multiples (lo collisions across hi)
    src_ids = np.int64(2) ** 40 + rng.permutation(n).astype(np.int64) * (np.int64(2) ** 33 + 13)
    tgt_ids = rng.permutation(src_ids).astype(np.int64)
    data = rng.normal(size=n).astype(np.float32)
    got, ref = run_both(pool, world, src_ids, data, tgt_ids)
    assert_same(got, ref)
    assert got[1].all()


def test_int64_lo_collisions_and_unmatched(pool, rng):
    # IDs sharing their low 32 bits but not their high ones must not match
    n = 8 * 32
    lo = rng.permutation(n // 2).astype(np.int64)
    src_ids = np.concatenate([lo, lo + (np.int64(1) << 35)])
    tgt_ids = src_ids[rng.permutation(n)].copy()
    tgt_ids[:16] = (np.int64(1) << 45) + np.arange(16)  # absent IDs
    data = np.arange(n, dtype=np.float32)
    got, ref = run_both(pool, 4, src_ids, data, tgt_ids, default_value=-1.0)
    assert_same(got, ref)
    assert not got[1][:16].any() and got[1][16:].all()


def test_duplicate_source_ids_take_the_first_in_global_order(pool):
    """Not compared with JAX, whose choice among duplicates is unspecified."""
    src_ids = np.array([5, 1, 2, 3, 5, 6, 7, 8, 5, 9, 10, 11, 12, 13, 14, 5], np.int64)
    data = np.arange(16, dtype=np.float32)
    tgt_ids = np.array([5] * 16, np.int64)
    got = pool.run(T.reorder, (4, src_ids, data, tgt_ids, {}))
    for out, matched, _ in got:
        np.testing.assert_array_equal(out, np.zeros(4, np.float32))
        assert matched.all()


def test_mismatched_id_families_raise(pool):
    got = pool.run(T.reorder, (1, np.arange(8, dtype=np.int32), np.zeros(8, np.float32),
                               np.arange(8, dtype=np.int64), {}), ranks=[0])[0]
    assert isinstance(got, RankError) and "dtype family" in got.message


# ---------------------------------------------------------------------------
# rebalance_evenly
# ---------------------------------------------------------------------------


def _unbalanced(rng, counts, shard_len, pads):
    n_dev = len(counts)
    total = sum(counts)
    truth = [rng.uniform(0, 10.0, total), rng.uniform(0, 10.0, total), np.full(total, 0.22),
             rng.uniform(0.5, 2.0, total)]
    blocks = []
    for arr, pad in zip(truth, pads):
        g = np.full(n_dev * shard_len, pad, np.float32)
        off = 0
        for i, c in enumerate(counts):
            g[i * shard_len:i * shard_len + c] = arr[off:off + c]
            off += c
        blocks.append(g)
    return blocks, truth


@pytest.mark.parametrize("world,counts", [(4, [4000, 10, 0, 700]), (4, [0, 0, 0, 4090]), (1, [3000])])
def test_rebalance_matches_jax(pool, rng, world, counts):
    shard_len = 4096
    pads = (0.0, 0.0, 1.0, 0.0)
    blocks, truth = _unbalanced(rng, counts, shard_len, pads)
    mesh = j_make_mesh(world)
    sharding = NamedSharding(mesh, P("data"))
    j_out, j_counts = j_rebalance_evenly([jax.device_put(jnp.asarray(b), sharding) for b in blocks],
                                         np.asarray(counts), mesh, pad_values=pads)
    got = pool.run(T.rebalance, (world, blocks, np.asarray(counts), pads), ranks=_ranks(world))
    for _, new_counts in got:
        np.testing.assert_array_equal(new_counts, j_counts)
        assert new_counts.dtype == np.int64 and int(new_counts.max() - new_counts.min()) <= 1
    for k in range(4):
        mine = np.concatenate([g[0][k] for g in got])
        np.testing.assert_array_equal(mine, np.asarray(j_out[k]))
        rebuilt = np.concatenate([mine[i * shard_len:i * shard_len + int(c)] for i, c in enumerate(got[0][1])])
        np.testing.assert_array_equal(rebuilt, truth[k].astype(np.float32))


def test_rebalance_capacity_guard(pool, rng):
    blocks, _ = _unbalanced(rng, [100] * 4, 128, (0, 0, 1, 0))
    got = pool.run(T.rebalance, (4, blocks, np.asarray([100] * 2), None))
    assert all(isinstance(g, RankError) and "counts must be" in g.message for g in got)
    got = pool.run(T.rebalance, (4, blocks, np.asarray([128 * 4 + 1, 0, 0, 0]), None))
    assert all(isinstance(g, RankError) and "exceeds the shard capacity" in g.message for g in got)
    assert pool.run(T.ring, (4,))[0] == (3.0, 1.0, False)  # no rank was left waiting


def test_rebalance_plan_is_int64_past_2_31():
    """The plan at totals past 2^31 (the JAX package's int32 metadata wraps
    there): host arithmetic only, nothing allocated per element."""
    counts = np.array([2**31 + 5, 0, 2**31 - 1, 3 * 2**30], np.int64)
    plan = rebalance_plan(counts, 4)
    total = int(counts.sum())
    assert total > 2**32
    assert plan.new_counts.sum() == total and plan.new_counts.dtype == np.int64
    assert int(plan.new_counts.max() - plan.new_counts.min()) <= 1
    assert plan.bounds[-1] == total and plan.offsets[2] == 2**31 + 5
    sends = np.stack([plan.send_counts(r) for r in range(4)])
    recvs = np.stack([plan.recv_counts(r) for r in range(4)])
    np.testing.assert_array_equal(sends, recvs.T)  # what r sends to d, d receives from r
    np.testing.assert_array_equal(sends.sum(1), counts)
    np.testing.assert_array_equal(recvs.sum(1), plan.new_counts)
    assert (sends >= 0).all() and sends.dtype == np.int64
    # the JAX package's int32 metadata of the same plan has wrapped
    assert np.asarray(plan.offsets, np.int32)[2] < 0
