"""Port vs JAX: the coherent engine's stage A (row prep) and the build.

The JAX package's row prep runs its Pallas kernel in interpret mode on the
CPU (``coherent_prep_pallas._stage_a_pallas(..., interpret=True)``); the port
runs the kernel's plain torch version, which is what its wrapper takes for a
CPU tensor. The plain torch row sort (``prep="xla"``) is held against the
JAX package's ``_assign_and_rowsort``. Inputs are NumPy arrays made from a
seed and handed to both, at 4 and 12 rows of 2048 particles: sizes at which
neither package pads. Positions and smoothing lengths are snapped 2e-3 px
away from tile and level boundaries, so that the two frameworks' f32
rounding (XLA on the CPU does not divide as IEEE does) cannot flip a tile.
Bounds: counts, tail_eff, the heavy/n_l0 aux columns and the per-row lane
keys are equal; candidates (key, row, k4) and the rows of each tail bucket
are equal as sorted multisets; float channels agree within
1e-6 * max |channel|.

``prep_emulated`` repeats the CUDA kernel's per-row steps in torch (each
thread's float4 lanes, the packed tail scan, the row image, the
early-stopped candidate rounds) and is held bit for bit to
``prep_rows_plain``, on the cases above and on edge rows (d_max and
d_max + 1 distinct head keys, only tails, all heavy). The CUDA tests need a
card and skip here.
"""

import importlib
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from astro_sph_tools_tpu.ops import coherent_prep_pallas as JP
from astro_sph_tools_tpu_torch import _build
from astro_sph_tools_tpu_torch.ops import MapSpec
from astro_sph_tools_tpu_torch.ops import coherent_prep as CP
from astro_sph_tools_tpu_torch.ops.coherent_prep import _stage_a_prep, prep_lanes, prep_rounds, prep_rows, prep_rows_plain

# both packages export a function named like the module: import the modules
JC = importlib.import_module("astro_sph_tools_tpu.ops.deposit_coherent")
TC = importlib.import_module("astro_sph_tools_tpu_torch.ops.deposit_coherent")

BOX = 10.0
NPIX = 128
C = 2048
FTOL = 1e-6


def snap(a):
    """Keep values at least 2e-3 away from the next integer."""
    fl = np.floor(a)
    return fl + np.clip(a - fl, 2e-3, 1.0 - 2e-3)


def prep_inputs(seed, n_rows, *, periodic, heavy_rows=(), off_extent=False, n_fields=2):
    """Cell-ordered clustered particles (snapshot-like), snapped away from
    tile and level boundaries. ``heavy_rows``: rows whose particles are
    scattered over the map; ``off_extent``: every 131st particle is moved
    outside the extent."""
    rng = np.random.default_rng(seed)
    n = n_rows * C
    px = BOX / NPIX
    u = rng.uniform(0, NPIX, n)
    v = rng.uniform(0, NPIX, n)
    cell = np.floor(v / 16).astype(int) * 8 + np.floor(u / 16).astype(int)
    order = np.argsort(cell, kind="stable")
    u, v = u[order], v[order]
    for r in heavy_rows:
        sl = slice(r * C, (r + 1) * C)
        u[sl] = rng.uniform(0, NPIX, C)
        v[sl] = rng.uniform(0, NPIX, C)
    if off_extent:
        u[::131] = rng.uniform(-6.0, -0.5, u[::131].shape)
        v[3::131] = NPIX + rng.uniform(0.5, 6.0, v[3::131].shape)
    s_pix = snap(np.exp(rng.normal(-0.3, 1.0, n)).clip(0.05, 40.0))
    x = (snap(u) * px).astype(np.float32)
    y = (snap(v) * px).astype(np.float32)
    h = (s_pix * px / 2.0).astype(np.float32)  # cubic spline: support 2h
    vals = rng.uniform(0.5, 2.0, (n_fields, n)).astype(np.float32)
    spec = MapSpec(shape=(NPIX, NPIX), extent=(0.0, BOX, 0.0, BOX), periodic_wrap=periodic)
    return spec, x, y, h, vals


def edge_row_inputs(seed, *, periodic=True, n_fields=2):
    """Five rows at the candidate rounds' edges: exactly d_max distinct
    level-0 keys (with tails among them), d_max + 1 (heavy), only tails,
    one level-0 key, and a row of ``prep_inputs``' clustered particles.
    Level-0 lanes sit near their tiles' centres, some with s_pix > 1 (the
    K4 flag), all snapped away from tile and level boundaries."""
    spec, x, y, h, vals = prep_inputs(seed, 5, periodic=periodic, n_fields=n_fields)
    st = TC._setup(spec, "cubic_spline", TC.PALLAS_LEVELS, TC._D_MAX)
    g0 = st.geom0
    rng = np.random.default_rng(seed + 1)
    px = BOX / NPIX
    tiles = rng.permutation(g0.n_tiles_x * g0.n_tiles_y)

    def heads(sl, n_keys):
        t = tiles[rng.integers(0, n_keys, C)]
        t[:n_keys] = tiles[:n_keys]  # every key at least once
        u = (t % g0.n_tiles_x + rng.uniform(0.2, 0.8, C)) * g0.tx
        v = (t // g0.n_tiles_x + rng.uniform(0.2, 0.8, C)) * g0.cfg.TY
        x[sl], y[sl] = (snap(u) * px).astype(np.float32), (snap(v) * px).astype(np.float32)
        h[sl] = (rng.uniform(0.3, 0.95 * st.bounds[0], C) * px / 2.0).astype(np.float32)

    def tails(sl):
        lanes = np.arange(C)[sl] if isinstance(sl, np.ndarray) else np.arange(sl.start, sl.stop)
        h[lanes] = (rng.uniform(1.05 * st.bounds[0], 0.95 * st.bounds[1], len(lanes)) * px / 2.0).astype(np.float32)

    heads(slice(0, C), TC._D_MAX)
    tails(slice(3 * C // 4, C))  # level-1 lanes after the heads
    heads(slice(C, 2 * C), TC._D_MAX + 1)
    tails(slice(2 * C, 3 * C))
    heads(slice(3 * C, 4 * C), 1)
    return spec, x, y, h, vals


def all_heavy_inputs(seed, *, periodic=True, n_fields=2):
    """Eight rows of ``prep_inputs``' particles shuffled over the whole
    map: every row heavy."""
    spec, x, y, h, vals = prep_inputs(seed, 8, periodic=periodic, n_fields=n_fields)
    perm = np.random.default_rng(seed).permutation(x.shape[0])
    return spec, x[perm], y[perm], h[perm], vals[:, perm]


def jax_statics(spec, st, n_rows):
    jgeoms = []
    for cfg in JC.PALLAS_LEVELS:
        try:
            jgeoms.append(JC._level_geometry(cfg, JC.MapSpec(spec.shape, spec.extent, periodic_wrap=spec.periodic_wrap)))
        except ValueError:
            jgeoms.append(None)
    bases = JC._ckey_bases(jgeoms)
    assert bases == st.bases
    return dict(
        shape=spec.shape, extent=tuple(float(e) for e in spec.extent), periodic=spec.periodic_wrap,
        bounds=tuple(g.cfg.max_s_pix if g else -1.0 for g in jgeoms),
        geom_tuples=(
            tuple(g.n_tiles_x if g else 1 for g in jgeoms), tuple(g.cfg.TY if g else 1 for g in jgeoms),
            tuple(g.tx if g else 1 for g in jgeoms), tuple(g.n_tiles_y if g else 1 for g in jgeoms),
            tuple(g.cfg.M if g else 0 for g in jgeoms),
        ),
        support_factor=2.0, n_levels=4, bases=bases, d_max=JC._D_MAX, n_rows=n_rows, C=C,
    )


def as_torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def cand_multiset(keys, rows, k4):
    t = np.stack([np.asarray(keys, np.int64), np.asarray(rows, np.int64), np.asarray(k4, np.int64)], 1)
    return t[np.lexsort(t.T[::-1])]


def bucket_row_sets(rows_by_bucket, nb):
    rows_by_bucket = np.asarray(rows_by_bucket)
    out, lo = [], 0
    for c in list(nb) + [len(rows_by_bucket) - int(np.sum(nb))]:
        out.append(sorted(rows_by_bucket[lo:lo + c].tolist()))
        lo += c
    return out


def assert_close_channels(got, ref, n_ch):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    for c in range(n_ch):
        scale = max(np.abs(ref[:, c]).max(), 1e-30)
        assert np.abs(got[:, c] - ref[:, c]).max() <= FTOL * scale, f"channel {c}"


PREP_CASES = [
    dict(n_rows=4, periodic=True),
    dict(n_rows=4, periodic=False, off_extent=True),
    dict(n_rows=12, periodic=True, heavy_rows=(3, 4), n_fields=1),
    dict(n_rows=12, periodic=False, heavy_rows=(7,), off_extent=True, n_fields=4),
]


@pytest.mark.parametrize("case", range(len(PREP_CASES)))
def test_prep_rows_plain_matches_pallas_prep(case):
    """(a) prep_rows_plain + _stage_a_prep vs the JAX Pallas row prep."""
    kw = PREP_CASES[case]
    n_rows = kw["n_rows"]
    spec, x, y, h, vals = prep_inputs(100 + case, **kw)
    n_fields = vals.shape[0]
    st = TC._setup(spec, "cubic_spline", TC.PALLAS_LEVELS, TC._D_MAX)
    js = jax_statics(spec, st, n_rows)
    jx, jy, jh, jv = (jnp.asarray(a) for a in (x, y, h, vals))
    j_packed, j_aux = JP._prep_call(
        jx.reshape(n_rows, C), jy.reshape(n_rows, C), jh.reshape(n_rows, C), jv.reshape(n_fields, n_rows, C),
        RB=2, n_fields=n_fields, interpret=True,
        **{k: js[k] for k in ("n_rows", "C", "shape", "extent", "periodic", "bounds", "geom_tuples",
                              "support_factor", "bases", "n_levels", "d_max")},
    )
    j_out = JP._stage_a_pallas(jx, jy, jh, jv, n_fields=n_fields, RB=2, interpret=True,
                               tail_buckets=JC._TAIL_BUCKETS, **js)
    tx, ty, th, tv = as_torch(x, y, h, vals)
    packed, aux = prep_rows_plain(tx, ty, th, tv, st)
    out = _stage_a_prep(tx, ty, th, tv, st)
    j_packed, j_aux = np.asarray(j_packed), np.asarray(j_aux)
    aux = aux.numpy()
    d = TC._D_MAX

    assert torch.equal(out[0], packed)
    key_ch = 3 + n_fields
    assert np.array_equal(packed[:, key_ch].numpy(), j_packed[:, key_ch])  # lane keys, lane by lane
    assert_close_channels(packed[:, :key_ch].numpy(), j_packed[:, :key_ch], key_ch)
    assert not packed[:, key_ch + 1:].any()
    # tail_eff, n_l0, heavy and the per-level counts: exactly equal
    assert np.array_equal(aux[:, d:d + 3 + 4], j_aux[:, d:d + 3 + 4])
    assert np.array_equal(aux[:, 2 * d + 7:], j_aux[:, 2 * d + 7:])
    assert np.array_equal(out[6].numpy(), np.asarray(j_out[6]))  # counts vector
    assert np.array_equal(out[4].numpy(), np.asarray(j_out[4]))  # tail_eff
    assert np.array_equal(
        cand_multiset(*(a.numpy() for a in out[1:4])), cand_multiset(*(np.asarray(a) for a in j_out[1:4]))
    )
    nb = out[6].numpy()[3:3 + len(TC._TAIL_BUCKETS)]
    assert bucket_row_sets(out[5].numpy(), nb) == bucket_row_sets(j_out[5], nb)
    heavy = aux[:, d + 2] > 0.5
    assert heavy.sum() >= len(kw.get("heavy_rows", ()))
    if not kw.get("off_extent"):  # off-extent lanes add keys: those rows may all be heavy
        assert (~heavy).any()


EDGE_CASES = [
    (edge_row_inputs, dict(periodic=True)),
    (edge_row_inputs, dict(periodic=False, n_fields=4)),
    (all_heavy_inputs, dict(periodic=True, n_fields=1)),
]
# every case of the prep tests: (generator, keyword arguments)
ALL_CASES = [(prep_inputs, dict(n_rows=kw.pop("n_rows"), **kw)) for kw in map(dict, PREP_CASES)] + EDGE_CASES


def case_inputs(case, seed):
    gen, kw = ALL_CASES[case]
    kw = dict(kw)
    return gen(seed, kw.pop("n_rows"), **kw) if gen is prep_inputs else gen(seed, **kw)


def prep_emulated(x, y, h, values, st):
    """Torch emulation of ``csrc/coherent.cu::coherent_prep_kernel``, row by
    row as its thread block takes it: each thread's lanes (``prep_lanes``),
    the warp scan of the threads' tail counts packed two runs to an int,
    every lane's and channel's destination in the row's image, the zero
    channels, the early-stopped candidate rounds (round d's barrier brings
    the next min and the K4 flag of the key d took) and each aux slot as
    its thread writes it. Returns (packed, aux, rounds)."""
    nl, d_max, pad = st.n_levels, st.d_max, st.pad_key
    n_rows = x.shape[0] // C
    n_fields = values.shape[0]
    level, _, u_loc, v_loc, s_pix, ckey = TC._assign(x, y, h, st)
    lanes = prep_lanes()  # (256 threads, 8)

    def per_thread(a):
        return a.reshape(n_rows, C)[:, lanes]  # (rows, thread, j)

    key = per_thread(ckey).to(torch.int64)
    is_tail = key >= st.bases[1]
    run_tails = is_tail.reshape(n_rows, 256, 2, 4).sum(-1)
    tails = run_tails[..., 0] + (run_tails[..., 1] << 16)  # per thread
    tw = tails.reshape(n_rows, 8, 32)  # per warp, per lane
    incl = torch.cumsum(tw, -1)
    excl = incl - tw
    own = incl[..., -1]  # the warp's packed total (lane 31's)
    cw = (own & 0xFFFF) + (own >> 16)
    before = (torch.cumsum(cw, -1) - cw)[..., None]
    n_tail = cw.sum(-1)
    tb = torch.stack([before + (excl & 0xFFFF), before + (own[..., None] & 0xFFFF) + (excl >> 16)], -1)
    tb = tb.reshape(n_rows, 256, 2, 1)
    within = torch.cumsum(is_tail.reshape(n_rows, 256, 2, 4).to(torch.int64), -1) - is_tail.reshape(
        n_rows, 256, 2, 4).to(torch.int64)
    tb = (tb + within).reshape(n_rows, 256, 8)
    dest = torch.where(is_tail, C - n_tail[:, None, None] + tb, lanes - tb)
    img = torch.full((n_rows, 8, C), float("nan"))
    chans = [per_thread(a) for a in (u_loc, v_loc, h, *values)] + [key.to(torch.float32)]
    for c, a in enumerate(chans):
        img[:, c].scatter_(1, dest.reshape(n_rows, -1), a.reshape(n_rows, -1))
    img[:, 4 + n_fields:] = 0.0

    mk = torch.where(is_tail, pad, key).reshape(n_rows, -1)
    big = (~is_tail & (per_thread(s_pix) > 1.0)).reshape(n_rows, -1)
    key = key.reshape(n_rows, -1)
    m = mk.min(1).values  # the scan's min
    slots = torch.full((n_rows, d_max), pad, dtype=torch.int64)
    flags = torch.ones((n_rows, d_max))
    rounds = torch.zeros(n_rows, dtype=torch.int64)
    running = torch.ones(n_rows, dtype=torch.bool)
    for d in range(d_max):
        took = (key == m[:, None]) & big
        slots[:, d] = torch.where(running, m, slots[:, d])
        flags[:, d] = torch.where(running & took.any(1), 0.0, flags[:, d])
        mk = torch.where(running[:, None] & (mk == m[:, None]), pad, mk)
        m = torch.where(running, mk.min(1).values, m)
        rounds += running
        running &= m != pad
    heavy = (rounds == d_max) & (m < st.bases[1])
    lev = level.reshape(n_rows, C)
    cols = (
        [torch.where(heavy[:, None], pad, slots), torch.where(heavy, C, n_tail)[:, None],
         (C - n_tail)[:, None], heavy[:, None]]
        + [(lev == li).sum(1, keepdim=True) for li in range(1, nl + 1)] + [flags]
    )
    aux = torch.zeros((n_rows, TC._AUX_W))
    row = torch.cat([c.to(torch.float32) for c in cols], 1)
    aux[:, :row.shape[1]] = row
    return img, aux, rounds


@pytest.mark.parametrize("case", range(len(ALL_CASES)))
def test_prep_emulation_matches_plain_and_jax(case):
    """The kernel's per-row steps (``prep_emulated``) give ``prep_rows_plain``'s
    packed and aux rows bit for bit, take the rounds ``prep_rounds`` reads
    from aux, and the stage A they feed matches the JAX package's
    ``_assign_and_rowsort``: counts, tail_eff and candidates equal, each
    row's lanes equal as sorted multisets (float channels within FTOL, as
    in ``test_assign_and_rowsort_matches_jax``)."""
    spec, x, y, h, vals = case_inputs(case, 400 + case)
    n_fields, n_rows = vals.shape[0], x.shape[0] // C
    st = TC._setup(spec, "cubic_spline", TC.PALLAS_LEVELS, TC._D_MAX)
    tx, ty, th, tv = as_torch(x, y, h, vals)
    img, aux, rounds = prep_emulated(tx, ty, th, tv, st)
    packed, ref_aux = prep_rows_plain(tx, ty, th, tv, st)
    assert torch.equal(img, packed)
    assert torch.equal(aux, ref_aux)
    assert torch.equal(rounds, prep_rounds(aux, st))
    d = st.d_max
    heavy = aux[:, d + 2] > 0.5
    if ALL_CASES[case][0] is edge_row_inputs:
        assert heavy.tolist() == [False, True, False, False, False]
        assert rounds[:4].tolist() == [d, d, 1, 1]
        assert int(aux[0, 2 * d + 7:3 * d + 7].eq(0).sum()) > 0  # some candidate has s_pix > 1
    if ALL_CASES[case][0] is all_heavy_inputs:
        assert bool(heavy.all())

    js = jax_statics(spec, st, n_rows)
    j_out = JC._assign_and_rowsort(*(jnp.asarray(a) for a in (x, y, h, vals)), n_fields=n_fields, **js)
    out = TC._stage_a_glue(
        aux[:, :d].to(torch.int32), aux[:, d + 7:2 * d + 7].to(torch.int32), aux[:, d].to(torch.int32),
        heavy, aux[:, d + 1].to(torch.int32), aux[:, d + 3:d + 7].to(torch.int64).sum(0), st,
    )
    assert np.array_equal(out[5].numpy(), np.asarray(j_out[6])[:-1])  # JAX appends the window-step count
    assert np.array_equal(out[3].numpy(), np.asarray(j_out[4]))
    # the candidates, and the K4 flags of the real ones (a heavy row's pad
    # slots keep its keys' flags in the row prep, not in the XLA stage A)
    got_c = cand_multiset(*(a.numpy() for a in out[:3]))
    ref_c = cand_multiset(*(np.asarray(a) for a in j_out[1:4]))
    assert np.array_equal(got_c[:, :2], ref_c[:, :2])
    real = got_c[:, 0] < st.bases[1]
    assert np.array_equal(got_c[real], ref_c[real])
    key_ch = 3 + n_fields
    got, ref = img.numpy(), np.asarray(j_out[0])
    for r in range(n_rows):
        og = np.lexsort(got[r, :key_ch + 1][::-1])
        orf = np.lexsort(ref[r, :key_ch + 1][::-1])
        assert np.array_equal(got[r, key_ch, og], ref[r, key_ch, orf])
        for c in range(key_ch):
            scale = max(np.abs(ref[r, c]).max(), 1e-30)
            assert np.abs(got[r, c, og] - ref[r, c, orf]).max() <= FTOL * scale


@pytest.mark.parametrize("case", range(len(EDGE_CASES)))
def test_prep_rows_plain_matches_pallas_prep_on_edge_rows(case):
    """The edge rows against the JAX Pallas row prep (interpret mode): lane
    keys lane by lane, the aux counts and flags exactly, float channels
    within FTOL."""
    spec, x, y, h, vals = case_inputs(len(PREP_CASES) + case, 500 + case)
    n_fields, n_rows = vals.shape[0], x.shape[0] // C
    st = TC._setup(spec, "cubic_spline", TC.PALLAS_LEVELS, TC._D_MAX)
    js = jax_statics(spec, st, n_rows)
    jx, jy, jh, jv = (jnp.asarray(a) for a in (x, y, h, vals))
    j_packed, j_aux = JP._prep_call(
        jx.reshape(n_rows, C), jy.reshape(n_rows, C), jh.reshape(n_rows, C), jv.reshape(n_fields, n_rows, C),
        RB=2 if n_rows % 2 == 0 else 1, n_fields=n_fields, interpret=True,
        **{k: js[k] for k in ("n_rows", "C", "shape", "extent", "periodic", "bounds", "geom_tuples",
                              "support_factor", "bases", "n_levels", "d_max")},
    )
    packed, aux = prep_rows_plain(*as_torch(x, y, h, vals), st)
    j_packed, j_aux, aux = np.asarray(j_packed), np.asarray(j_aux), aux.numpy()
    key_ch = 3 + n_fields
    assert np.array_equal(packed[:, key_ch].numpy(), j_packed[:, key_ch])
    assert_close_channels(packed[:, :key_ch].numpy(), j_packed[:, :key_ch], key_ch)
    assert np.array_equal(aux, j_aux)


def test_vector_loads_get_aligned_inputs():
    """The kernel reads every input as float4s: an input off a 16-byte
    boundary, or ``values`` rows not a multiple of 4 floats apart, is
    copied first (and the copy is the kernel's cost); an aligned input is
    passed as it is. On the CPU, a strided ``values`` gives the plain
    result of its contiguous copy."""
    spec, x, y, h, vals = prep_inputs(9, 2, periodic=True)
    tx, ty, th, tv = as_torch(x, y, h, vals)
    assert CP._vector_ready(tx) is tx and CP._vector_ready(tv) is tv
    off = torch.zeros(tx.shape[0] + 1)[1:]
    off.copy_(tx)
    assert off.data_ptr() % 16 and CP._vector_ready(off).data_ptr() % 16 == 0
    assert torch.equal(CP._vector_ready(off), tx)
    wide = torch.zeros((tv.shape[0], tv.shape[1] + 3))
    wide[:, :tv.shape[1]] = tv
    strided = wide[:, :tv.shape[1]]
    ready = CP._vector_ready(strided)
    assert ready.stride() == (tv.shape[1], 1) and ready.data_ptr() % 16 == 0 and torch.equal(ready, tv)
    got = prep_rows(tx, ty, th, strided, spec)
    ref = prep_rows(tx, ty, th, tv, spec)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_prep_lanes_cover_each_row_once():
    """Each row lane is one thread's, and a warp's float4 loads read 512
    contiguous bytes: lane 4 t + e of run g for thread t of a warp."""
    lanes = prep_lanes()
    assert sorted(lanes.reshape(-1).tolist()) == list(range(C))
    for g in range(2):
        run = lanes[:, 4 * g:4 * g + 4].reshape(8, 32 * 4)  # a warp's run g, in lane order
        assert torch.equal(run - run[:, :1], torch.arange(128).expand(8, -1))


@pytest.mark.parametrize("case", [0, 3])
def test_assign_and_rowsort_matches_jax(case):
    """(b) the plain torch row sort vs the JAX package's XLA stage A: rows
    compared after a lexicographic sort of their lanes (equal keys may sit
    in any order within a row)."""
    kw = PREP_CASES[case]
    n_rows = kw["n_rows"]
    spec, x, y, h, vals = prep_inputs(200 + case, **kw)
    n_fields = vals.shape[0]
    st = TC._setup(spec, "cubic_spline", TC.PALLAS_LEVELS, TC._D_MAX)
    js = jax_statics(spec, st, n_rows)
    j_out = JC._assign_and_rowsort(*(jnp.asarray(a) for a in (x, y, h, vals)), n_fields=n_fields, **js)
    out = TC._assign_and_rowsort(*as_torch(x, y, h, vals), st)

    key_ch = 3 + n_fields
    got, ref = out[0].numpy(), np.asarray(j_out[0])
    for r in range(n_rows):
        og = np.lexsort(got[r, :key_ch + 1][::-1])
        orf = np.lexsort(ref[r, :key_ch + 1][::-1])
        assert np.array_equal(got[r, key_ch, og], ref[r, key_ch, orf])
        for c in range(key_ch):
            scale = max(np.abs(ref[r, c]).max(), 1e-30)
            assert np.abs(got[r, c, og] - ref[r, c, orf]).max() <= FTOL * scale
    assert np.array_equal(out[6].numpy(), np.asarray(j_out[6])[:-1])  # JAX appends the window-step count
    assert np.array_equal(out[4].numpy(), np.asarray(j_out[4]))
    assert np.array_equal(
        cand_multiset(*(a.numpy() for a in out[1:4])), cand_multiset(*(np.asarray(a) for a in j_out[1:4]))
    )
    nb = out[6].numpy()[3:3 + len(TC._TAIL_BUCKETS)]
    assert bucket_row_sets(out[5].numpy(), nb) == bucket_row_sets(j_out[5], nb)


def test_prep_constants_match_jax():
    assert (TC._D_MAX, TC._TAIL_BUCKETS, TC._K4_MAX_S, TC._K4) == (JC._D_MAX, JC._TAIL_BUCKETS, JC._K4_MAX_S, JC._K4)
    assert TC._AUX_W == JP._AUX_W and TC._CHUNK == JC._CHUNK
    for n in (0, 1, 8, 9, 17, 100, 2047, 2049, 12345, 1 << 20, (1 << 20) + 1):
        assert TC._next_size_class(n) == JC._next_size_class(n)


def test_prep_wrapper_takes_plain_version_only_on_cpu():
    spec, x, y, h, vals = prep_inputs(7, 1, periodic=True)
    tx, ty, th, tv = as_torch(x, y, h, vals)
    before = prep_rows.launches
    got = prep_rows(tx, ty, th, tv, spec)
    st = TC._setup(spec, "cubic_spline", TC.PALLAS_LEVELS, TC._D_MAX)
    ref = prep_rows_plain(tx, ty, th, tv, st)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert prep_rows.launches == before  # no kernel launched on the CPU
    with pytest.raises(ValueError, match="no row-prep kernel"):
        prep_rows(*(a.to("meta") for a in (tx, ty, th, tv)), spec)


def test_library_name_hashes_included_headers(tmp_path):
    """Editing a header a source includes renames that source's library (no
    stale library is loaded); nvcc is not run."""
    src = tmp_path / "csrc"
    shutil.copytree(_build._SRC_DIR, src)
    names = {n: _build.library_path(n, src, tmp_path) for n in _build.LIBRARIES}
    # the same bytes give the same names as the package's own sources
    assert {n: p.name for n, p in names.items()} == {n: _build.library_path(n).name for n in _build.LIBRARIES}
    hdr = src / "deposit_common.cuh"
    includes = {n for n in _build.LIBRARIES if hdr in _build._headers(src / f"{n}.cu", src)}
    assert includes == set(_build.LIBRARIES) - {"layout_shear"}  # the gang append needs no footprint math
    hdr.write_bytes(hdr.read_bytes() + b"\n// edited\n")
    for n in _build.LIBRARIES:
        assert (_build.library_path(n, src, tmp_path) != names[n]) == (n in includes), n
    # a header no source includes changes no library
    edited = {n: _build.library_path(n, src, tmp_path) for n in _build.LIBRARIES}
    (src / "unused.cuh").write_text("// not included\n")
    assert {n: _build.library_path(n, src, tmp_path) for n in _build.LIBRARIES} == edited


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA row-prep kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(ALL_CASES)))
def test_cuda_prep_kernel_matches_plain_bitwise(cuda_device, case):
    """(h) kernel #3 against its plain version on the card: bit for bit,
    the edge rows included."""
    spec, x, y, h, vals = case_inputs(case, 300 + case)
    args = [a.to(cuda_device) for a in as_torch(x, y, h, vals)]
    st = TC._setup(spec, "cubic_spline", TC.PALLAS_LEVELS, TC._D_MAX)
    before = prep_rows.launches
    got = prep_rows(*args, spec)
    ref = prep_rows_plain(*args, st)
    torch.cuda.synchronize()
    assert prep_rows.launches == before + 1
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.cuda
def test_cuda_prep_kernel_takes_strided_values(cuda_device):
    """A ``values`` view whose rows are 2051 floats apart, and an x off a
    16-byte boundary, are copied aligned before the launch: the result is
    the plain version's, bit for bit."""
    spec, x, y, h, vals = prep_inputs(310, 4, periodic=True)
    tx, ty, th, tv = (a.to(cuda_device) for a in as_torch(x, y, h, vals))
    wide = torch.zeros((tv.shape[0], tv.shape[1] + 3), device=cuda_device)
    wide[:, :tv.shape[1]] = tv
    off = torch.zeros(tx.shape[0] + 1, device=cuda_device)[1:]
    off.copy_(tx)
    st = TC._setup(spec, "cubic_spline", TC.PALLAS_LEVELS, TC._D_MAX)
    got = prep_rows(off, ty, th, wide[:, :tv.shape[1]], spec)
    ref = prep_rows_plain(tx, ty, th, tv, st)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
