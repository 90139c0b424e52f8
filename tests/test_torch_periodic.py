"""Port vs JAX: periodic-box geometry (``ops/periodic.py``).

Mirrors ``tests/test_periodic.py``. At f32 inputs each port function is held
to the JAX one (which computes in f32: x64 is off) within 1e-6 of the box,
a few f32 ulps; at f64 inputs to a NumPy f64 oracle of the reference
semantics, exactly, and the result stays f64. The wrap boundaries
(|delta| = L/2, positions at 0 and L) must agree exactly with the oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import astro_sph_tools_tpu.ops as jops
import astro_sph_tools_tpu.tools as jtools
from astro_sph_tools_tpu_torch import ops, tools
from astro_sph_tools_tpu_torch.ops.periodic import (
    calculate_periodic,
    make_periodic,
    shift_centre,
    shift_origin,
    wrapped_displacement,
    wrapped_distance,
)

F32_TOL = 1e-6  # of the box width: a few f32 ulps


def oracle_displacement(a, b, L):
    d = b - a
    m = np.abs(d) > L / 2
    d[m] = d[m] - np.sign(d[m]) * L
    return d


def oracle_make_periodic(p, L, centre=False):
    p = p.copy()
    if centre:
        half = L / 2
        m = (p < -half) | (p >= half)
        p[m] = -np.sign(p[m] + half) * L + p[m]
    else:
        m = (p < 0.0) | (p >= L)
        p[m] = -np.sign(p[m]) * L + p[m]
    return p


def t64(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def as_np(t):
    return t.cpu().numpy()


CASES = {
    "displacement": (
        lambda rng: (rng.uniform(0, 25.0, (512, 3)), rng.uniform(0, 25.0, (512, 3))),
        lambda a, b: (a, b, 25.0), wrapped_displacement, jops.wrapped_displacement,
        lambda a, b: oracle_displacement(a.copy(), b, 25.0),
    ),
    "distance": (
        lambda rng: (rng.uniform(0, 25.0, (128, 3)), rng.uniform(0, 25.0, (128, 3))),
        lambda a, b: (a, b, 25.0), wrapped_distance, jops.wrapped_distance,
        lambda a, b: np.sqrt((oracle_displacement(a.copy(), b, 25.0) ** 2).sum(axis=1)),
    ),
    "make_periodic": (
        lambda rng: (rng.uniform(-10.0, 20.0, (256, 3)), None),
        lambda a, b: (a, 10.0), make_periodic, jops.make_periodic,
        lambda a, b: oracle_make_periodic(a, 10.0),
    ),
    "make_periodic_centred": (
        lambda rng: (rng.uniform(-10.0, 10.0, (256, 3)), None),
        lambda a, b: (a, 10.0, True), make_periodic, jops.make_periodic,
        lambda a, b: oracle_make_periodic(a, 10.0, centre=True),
    ),
    "shift_origin": (
        lambda rng: (rng.uniform(0, 20.0, (64, 3)), np.array([18.0, 1.0, 10.0])),
        lambda a, b: (a, b, 20.0), shift_origin, jops.shift_origin,
        lambda a, b: oracle_make_periodic(a - b, 20.0),
    ),
    "shift_centre": (
        lambda rng: (rng.uniform(0, 20.0, (64, 3)), np.array([3.0, 17.0, 9.0])),
        lambda a, b: (a, b, 20.0), shift_centre, jops.shift_centre,
        lambda a, b: oracle_make_periodic(a + (10.0 - b), 20.0),
    ),
    "shift_centre_centred": (
        lambda rng: (rng.uniform(-10.0, 10.0, (64, 3)), np.array([-7.0, 2.0, 9.5])),
        lambda a, b: (a, b, 20.0, True), shift_centre, jops.shift_centre,
        lambda a, b: oracle_make_periodic(a - b, 20.0, centre=True),
    ),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_f32_matches_jax(name, rng):
    draw, args, port, ref, _ = CASES[name]
    a, b = draw(rng)
    a32 = a.astype(np.float32)
    b32 = None if b is None else b.astype(np.float32)
    targs = args(torch.as_tensor(a32), None if b32 is None else torch.as_tensor(b32))
    jargs = args(jnp.asarray(a32), None if b32 is None else jnp.asarray(b32))
    got = port(*targs)
    assert got.dtype == torch.float32
    expected = np.asarray(ref(*jargs))
    np.testing.assert_allclose(as_np(got), expected, rtol=0, atol=F32_TOL * 25.0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_f64_matches_oracle(name, rng):
    draw, args, port, _, oracle = CASES[name]
    a, b = draw(rng)
    got = port(*args(t64(a), None if b is None else t64(b)))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(as_np(got), oracle(a, b), rtol=1e-15, atol=1e-13)


def test_numpy_input_becomes_tensor_on_device():
    a = np.array([[0.5, 1.0, 2.0]])
    b = np.array([[24.5, 1.0, 2.0]])
    got = wrapped_displacement(a, b, 25.0, device="cpu")
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    np.testing.assert_array_equal(as_np(got), [[-1.0, 0.0, 0.0]])
    # a tensor argument decides the device; the NumPy one follows it
    got = shift_centre(t64(a), np.array([0.5, 1.0, 2.0]), 25.0, device="no-such-device")
    np.testing.assert_array_equal(as_np(got), [[12.5, 12.5, 12.5]])
    with pytest.raises(RuntimeError):
        make_periodic(a, 25.0, device="no-such-device")


def test_wrap_boundaries_exact():
    """|delta| = L/2 is not wrapped (strict >); 0 stays, L maps to 0, -L/2
    stays and +L/2 wraps in the centred convention."""
    L = 10.0
    d = wrapped_displacement(t64([0.0, 0.0, 2.5]), t64([5.0, -5.0, 7.5]), L)
    np.testing.assert_array_equal(as_np(d), [5.0, -5.0, 5.0])
    d = wrapped_displacement(t64([0.0]), t64([5.0 + 1e-12]), L)
    np.testing.assert_allclose(as_np(d), [-5.0 + 1e-12], rtol=0, atol=1e-15)
    p = t64([0.0, L, -1e-300, L - 1e-12])
    np.testing.assert_array_equal(as_np(make_periodic(p, L)), oracle_make_periodic(as_np(p), L))
    np.testing.assert_array_equal(as_np(make_periodic(p, L)), [0.0, 0.0, L, L - 1e-12])
    q = t64([-L / 2, L / 2, 0.0])
    np.testing.assert_array_equal(as_np(make_periodic(q, L, origin_is_centre=True)), [-L / 2, -L / 2, 0.0])
    # the same points at f32 agree with the JAX package bit for bit
    for fn, jfn, x in ((make_periodic, jops.make_periodic, [0.0, L, L - 1e-6]),):
        x32 = np.asarray(x, np.float32)
        np.testing.assert_array_equal(as_np(fn(torch.as_tensor(x32), L)), np.asarray(jfn(jnp.asarray(x32), L)))


def test_single_wrap_semantics():
    """Positions more than one box outside are wrapped once (reference)."""
    got = make_periodic(t64([25.0, -15.0]), 10.0)
    np.testing.assert_array_equal(as_np(got), [15.0, -5.0])
    assert calculate_periodic is make_periodic


def test_distance_reduction_axis():
    """1D inputs reduce over the single vector; 2D over the last axis."""
    one = wrapped_distance(t64([0.0, 0.0, 0.0]), t64([3.0, 4.0, 0.0]), 100.0, squared=True)
    assert one.ndim == 0 and float(one) == 25.0
    many = wrapped_distance(t64([0.5, 0.0, 0.0]), t64([[9.9, 0.0, 0.0], [3.0, 4.0, 0.0]]), 10.0)
    np.testing.assert_allclose(as_np(many), [0.6, np.hypot(2.5, 4.0)], rtol=1e-14)


def test_shift_centre_recentres_in_f64():
    """f64 positions recentre in f64: the JAX package (x64 off) rounds to
    f32, off by an ulp of box/2."""
    pos = np.array([[67.123456789, 1.0, 2.0]])
    centre = np.array([67.1, 1.0, 2.0])
    got = as_np(shift_centre(t64(pos), t64(centre), 100.0))
    np.testing.assert_allclose(got[0, 0], 50.0 + (67.123456789 - 67.1), rtol=0, atol=1e-12)
    jax_x = float(np.asarray(jops.shift_centre(jnp.asarray(pos), jnp.asarray(centre), 100.0))[0, 0])
    assert abs(jax_x - got[0, 0]) > 1e-7


def test_exported_names():
    for name in ("wrapped_displacement", "wrapped_distance", "make_periodic", "calculate_periodic",
                 "shift_origin", "shift_centre"):
        assert getattr(ops, name) is getattr(ops.periodic, name)
        assert getattr(tools, name) is getattr(ops.periodic, name)
        assert hasattr(jtools, name)
    assert tools.calculate_wrapped_displacement is wrapped_displacement
    assert tools.calculate_wrapped_distance is wrapped_distance
