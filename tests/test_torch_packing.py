"""Port vs JAX: the packed particle wire (``io/packing.py``).

The same NumPy inputs, made from a seed, go through both packages.

- ``pack_particles_host``: every leaf equal bit for bit, for every encoding
  (``u16``, ``delta``, ``auto``, ``f16``, ``u8``), with raw-unit folding,
  at the 65535 clip edge (f32 positions at the far box edge) and on a
  shuffled input that fills the exception list.
- ``unpack_particles_device`` on the CPU: positions and smoothing lengths
  bit for bit (the port keeps JAX's f32 operation order), f16 fields bit
  for bit. The u8-log fields are not: the port evaluates 2 ** (lo + q *
  step) in f64 and rounds once (within 1 ulp of the f64 value here), while
  XLA on the CPU fuses ``lo + q * step`` into an f32 FMA and rounds its f32
  ``exp2`` up to ~30 ulps off; the two are held within 4e-6 relative, and
  JAX's own distance from the f64 value is recorded beside.
- ``morton_delta_decode_device`` returns the encoder's inputs exactly for
  any order, including int32 wrap-around of the code sums (codes near
  2^32 and exceptions in every segment), and equals JAX's decode.
- The tensor form of a block (``packed_to_tensors``: uint16 as int16 bits,
  uint32 as int64) decodes to the same values as the NumPy block.
"""

import numpy as np
import pytest
import torch

from astro_sph_tools_tpu.io import packing as JP
from astro_sph_tools_tpu_torch.io import packing as P

BOX = 25.0
U8_REL = 4e-6  # port vs JAX, u8-log fields (XLA's f32 exp2, see above)


def morton(x, y, box):
    xq = np.clip(x / box * 65536, 0, 65535).astype(np.uint16)
    yq = np.clip(y / box * 65536, 0, 65535).astype(np.uint16)
    return np.argsort(P._interleave16(xq, yq), kind="stable")


@pytest.fixture()
def clustered():
    """Curve-ordered particles at production code density (the sample is
    squeezed into 0.4 Mpc, as the JAX package's tests do)."""
    rng = np.random.default_rng(11)
    n = 12_000
    x = 4.0 + rng.uniform(0.0, 0.4, n)
    y = 9.0 + rng.uniform(0.0, 0.4, n)
    h = 10.0 ** rng.uniform(-2.0, -0.5, n)
    mass = 10.0 ** rng.uniform(5.8, 6.4, n)
    temp = 10.0 ** rng.uniform(3.5, 6.5, n)
    o = morton(x, y, BOX)
    return x[o], y[o], h[o], mass[o], temp[o]


CASES = {
    "u16_f16": dict(field_scales=(2.0**20, 2.0**16)),
    "delta_f16": dict(field_scales=(2.0**20, 2.0**16), pos_encoding="delta"),
    "auto_f16": dict(field_scales=(2.0**20, 2.0**16), pos_encoding="auto"),
    "u16_u8": dict(field_dtype="u8"),
    "delta_u8": dict(pos_encoding="delta", field_dtype="u8"),
    "raw_units": dict(
        pos_scale=0.6777, h_scale=0.6777, field_scales=(2.0**-14, 2.0**16),
        field_unpack_scales=(2.0**-14 / 5e-11, 2.0**16),
    ),
}


def leaves(p):
    out = [p.x_q, p.y_q, p.h_q, p.fields_q]
    out += list(p.pos_delta[:4]) if p.pos_delta is not None else [None] * 4
    out += list(p.field_log_meta) if p.field_log_meta is not None else [None] * 2
    return out


def assert_same_pack(a, b):
    for u, v in zip(leaves(a), leaves(b)):
        if u is None or v is None:
            assert u is None and v is None
        else:
            assert u.dtype == v.dtype and u.shape == v.shape and np.array_equal(u, v)
    for f in ("x0", "y0", "box", "field_scales", "h_scale", "pos_scale", "n_particles", "nbytes"):
        assert getattr(a, f) == getattr(b, f), f


def pack_both(x, y, h, fields, **kw):
    return JP.pack_particles_host(x, y, h, fields, box=BOX, **kw), P.pack_particles_host(x, y, h, fields, box=BOX, **kw)


def bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("case", sorted(CASES))
def test_pack_and_unpack_match_jax(case, clustered):
    x, y, h, mass, temp = clustered
    kw = CASES[case]
    if case == "raw_units":
        x, y, h, mass = x / 0.6777, y / 0.6777, h / 0.6777, mass * 5e-11
    jp, pp = pack_both(x, y, h, [mass, temp], **kw)
    assert_same_pack(jp, pp)
    if kw.get("pos_encoding") == "auto":
        assert pp.pos_delta is not None  # curve order: the delta stream
    jx, jy, jh, jf = (np.asarray(a) for a in JP.unpack_particles_device(jp))
    px, py, ph, pf = (a.numpy() for a in P.unpack_particles_device(pp, device="cpu"))
    assert bits_equal(px, jx) and bits_equal(py, jy) and bits_equal(ph, jh)
    if kw.get("field_dtype") != "u8":
        assert bits_equal(pf, jf)
        return
    # u8-log: the port within 1 ulp of the f64 value, JAX within U8_REL of it
    lo, st = pp.field_log_meta
    q = pp.fields_q.astype(np.float64).reshape(2, lo.shape[1], -1)
    exact = np.exp2(lo.astype(np.float64)[:, :, None] + q * st.astype(np.float64)[:, :, None])
    exact = exact.reshape(2, -1)[:, : x.shape[0]]
    ulp = np.spacing(exact.astype(np.float32)).astype(np.float64)
    assert (np.abs(pf.astype(np.float64) - exact) / ulp).max() <= 1.0
    jax_ulps = (np.abs(jf.astype(np.float64) - exact) / ulp).max()
    assert np.abs(pf.astype(np.float64) / jf - 1.0).max() <= U8_REL, jax_ulps
    # and within the wire's own step of the truth
    for fi, truth in enumerate((mass, temp)):
        assert np.abs(pf[fi] / truth - 1.0).max() <= (2.0 ** (st[fi].max() / 2) - 1.0) * 1.01


def test_far_edge_f32_positions_clip_to_the_last_cell():
    x = np.array([np.nextafter(np.float32(BOX), np.float32(0.0)), np.float32(BOX), np.float32(BOX + 1)], np.float32)
    y = np.array([0.0, -1.0, np.float32(BOX)], np.float32)
    h = np.ones(3, np.float32)
    jp, pp = pack_both(x, y, h, [np.ones(3, np.float32)])
    assert_same_pack(jp, pp)
    assert pp.x_q.min() >= 65534 and pp.x_q.max() == 65535 and pp.y_q.tolist() == [0, 0, 65535]
    px = P.unpack_particles_device(pp, device="cpu")[0].numpy()
    assert (px < BOX).all() and (px > BOX - 2 * BOX / 65536).all()


def test_shuffled_input_fills_the_exception_list(clustered):
    x, y, h, mass, temp = clustered
    sh = np.random.default_rng(0).permutation(x.shape[0])
    x, y, h, mass, temp = x[sh], y[sh], h[sh], mass[sh], temp[sh]
    for enc in ("delta", "auto"):
        jp, pp = pack_both(x, y, h, [mass, temp], field_scales=(2.0**20, 2.0**16), pos_encoding=enc)
        assert_same_pack(jp, pp)
        if enc == "auto":
            assert pp.pos_delta is None  # the shuffle falls back to u16 pairs
        else:
            assert pp.pos_delta[2].size > 0.5 * x.shape[0]
            jx = np.asarray(JP.unpack_particles_device(jp)[0])
            assert bits_equal(P.unpack_particles_device(pp, device="cpu")[0].numpy(), jx)


@pytest.mark.parametrize("order", ["morton", "random", "reversed"])
def test_morton_decode_is_exact_for_any_order(order):
    rng = np.random.default_rng(5)
    n = 3 * P._DELTA_CHUNK + 123
    # codes over the whole u32 range: sums of deltas and corrections wrap
    xq = rng.integers(0, 65536, n).astype(np.uint16)
    yq = rng.integers(0, 65536, n).astype(np.uint16)
    if order != "random":
        o = np.argsort(P._interleave16(xq, yq), kind="stable")
        xq, yq = xq[o], yq[o]
        if order == "reversed":
            xq, yq = xq[::-1].copy(), yq[::-1].copy()
    xq[-2:] = 65535  # the largest codes, 2^32 - 1
    yq[-2:] = 65535
    enc = P.morton_delta_encode(xq, yq)
    X, Y = P.morton_delta_decode_device(*enc, device="cpu")
    assert X.dtype == torch.int32 and np.array_equal(X.numpy(), xq.astype(np.int32))
    assert np.array_equal(Y.numpy(), yq.astype(np.int32))
    jX, jY = JP.morton_delta_decode_device(*JP.morton_delta_encode(xq, yq))
    assert np.array_equal(np.asarray(jX), X.numpy()) and np.array_equal(np.asarray(jY), Y.numpy())


def test_tensor_leaves_decode_like_numpy_leaves(clustered):
    x, y, h, mass, temp = clustered
    pp = P.pack_particles_host(x, y, h, [mass, temp], box=BOX, pos_encoding="delta", field_dtype="u8")
    tp = P.packed_to_tensors(pp, "cpu")
    assert tp.pos_delta[0].dtype == torch.int16 and tp.pos_delta[1].dtype == torch.int64
    assert tp.pos_delta[3].dtype == torch.int64 and tp.fields_q.dtype == torch.uint8
    a = P.unpack_particles_device(pp, device="cpu")
    b = P.unpack_particles_device(tp, device="cpu")
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    up = P.packed_to_tensors(P.pack_particles_host(x, y, h, [mass], box=BOX, field_scales=(2.0**20,)), "cpu")
    assert up.x_q.dtype == torch.int16  # uint16 bits, widened at unpack
    assert (P._u16(up.x_q) >= 0).all()


def test_validation():
    x = np.ones(4)
    with pytest.raises(ValueError, match="field_scales"):
        P.pack_particles_host(x, x, x, [x, x], box=BOX, field_scales=(1.0,))
    with pytest.raises(ValueError, match="positive"):
        P.pack_particles_host(x, x, x, [np.zeros(4)], box=BOX, field_dtype="u8")
    with pytest.raises(ValueError, match="pos_encoding"):
        P.pack_particles_host(x, x, x, [x], box=BOX, pos_encoding="zip")
    with pytest.raises(ValueError, match="field_dtype"):
        P.pack_particles_host(x, x, x, [x], box=BOX, field_dtype="f8")


def test_exp2_exact_is_within_an_ulp():
    lg = torch.linspace(-40.0, 40.0, 100_001, dtype=torch.float64)
    got = P.exp2_exact(lg).double().numpy()
    exact = np.exp2(lg.numpy())
    ulp = np.spacing(exact.astype(np.float32)).astype(np.float64)
    assert (np.abs(got - exact) / ulp).max() <= 0.5 + 1e-6


def test_u8_fields_honour_field_scales_unlike_jax(clustered):
    """The JAX package's u8 tier ignores ``field_scales`` when it packs but
    multiplies by them when it unpacks (``field_unpack_scales`` default to
    them), so ``benchmarks/e2e_1e8.py``'s packdelta call (its f16 prescales
    2^-14 and 2^16 with u8 fields) decodes masses 2^-14 times and
    temperatures 2^16 times too large. Not copied: the port quantises
    log2(field / scale), and decodes the fields."""
    x, y, h, mass, temp = clustered
    kw = dict(field_scales=(2.0**-14, 2.0**16), field_dtype="u8", pos_encoding="delta")
    jp, pp = pack_both(x, y, h, [mass, temp], **kw)
    jf = np.asarray(JP.unpack_particles_device(jp)[3], np.float64)
    pf = P.unpack_particles_device(pp, device="cpu")[3].numpy().astype(np.float64)
    for fi, (truth, s) in enumerate(zip((mass, temp), kw["field_scales"])):
        st = pp.field_log_meta[1][fi].max()
        assert np.abs(pf[fi] / truth - 1.0).max() <= (2.0 ** (st / 2) - 1.0) * 1.01
        assert np.allclose(jf[fi] / truth, s, rtol=0.02)  # JAX's: off by the scale
    # with unit scales both pack the same bits (test_pack_and_unpack_match_jax)
