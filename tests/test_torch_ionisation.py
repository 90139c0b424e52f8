"""Port vs JAX: regular-grid interpolation and the HM01 ionisation tables.

The same NumPy inputs, made from a seed, go to both packages (JAX on the
CPU, f32 as its x64-off default; the port on ``device="cpu"``).

- ``regular_grid_interpolate`` in 1-3 D: f32 inputs against JAX's
  ``method="gather"`` (and, in 2-D, ``"mxu"``) within 1e-5 relative to the
  table's range (f32 weights, summed in another order); f64 inputs against
  ``scipy.interpolate.RegularGridInterpolator`` within 1e-12; -inf outside
  the hull, on both sides of every axis, as scipy's ``fill_value``.
- ``cubic_spline_1d`` (natural ends, a host f64 Thomas sweep) and
  ``interpolate_gammahi`` against JAX within 1e-5 relative (JAX's f32
  scan); the spline passes through its knots to 1e-12.
- ``IonisationTable_HM01`` read from the file JAX's
  ``write_synthetic_hm01_table`` writes: the same arrays and metadata as
  JAX's reader, and the port's writer writes the same file contents.
- The state carried across: ``IonisationTableBase`` built from the JAX
  table's ``ionisation_fraction_table`` and ``get_table_dimension(d)``
  arrays gives JAX's lookups (1e-5 relative).
- A redshift outside the table's axis gives -inf on the plane path, as on
  the full-D path (the JAX package's plane path clamps to the edge plane:
  its value is recorded beside, ROADMAP's "not copied" fault).
"""

import numpy as np
import pytest
from scipy.interpolate import RegularGridInterpolator

from astro_sph_tools_tpu.io import ionisation as JI
from astro_sph_tools_tpu.ops import interp as JX
from astro_sph_tools_tpu_torch.data_structures.ionisation import IonisationTableBase
from astro_sph_tools_tpu_torch.io import ionisation as PI
from astro_sph_tools_tpu_torch.ops import interp as PX

REL = 1e-5


def grid(rng, ndim):
    sizes = (12, 9, 7)[:ndim]
    axes = [np.sort(rng.uniform(-3.0, 5.0, s)) for s in sizes]
    for a in axes:  # strictly increasing
        a += np.arange(a.shape[0]) * 1e-3
    table = rng.normal(size=sizes)
    inside = np.column_stack([rng.uniform(a[0], a[-1], 400) for a in axes])
    outside = inside[:ndim * 2].copy()
    for d in range(ndim):  # below and above each axis
        outside[2 * d, d] = axes[d][0] - 0.5
        outside[2 * d + 1, d] = axes[d][-1] + 0.5
    knots = np.column_stack([a[np.arange(5) % a.shape[0]] for a in axes])
    return axes, table, np.concatenate([inside, outside, knots]), ndim * 2


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_interpolation_matches_scipy_in_f64(ndim):
    rng = np.random.default_rng(ndim)
    axes, table, pts, n_out = grid(rng, ndim)
    got = PX.regular_grid_interpolate(axes, table, pts, device="cpu").numpy()
    ref = RegularGridInterpolator(axes, table, bounds_error=False, fill_value=-np.inf)(pts)
    finite = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), finite) and (~finite).sum() == n_out
    assert np.abs(got[finite] - ref[finite]).max() <= 1e-12
    assert (got[~finite] == -np.inf).all()


@pytest.mark.parametrize("method", ["auto", "gather", "mxu"])
@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_interpolation_matches_jax_in_f32(ndim, method):
    rng = np.random.default_rng(10 + ndim)
    axes, table, pts, _ = grid(rng, ndim)
    axes32 = [a.astype(np.float32) for a in axes]
    table32, pts32 = table.astype(np.float32), pts.astype(np.float32)
    jmethod = method if (method != "mxu" or ndim == 2) else "gather"  # JAX's mxu form is 2-D only
    ref = np.asarray(JX.regular_grid_interpolate(axes32, table32, pts32, method=jmethod))
    got = PX.regular_grid_interpolate(axes32, table32, pts32, method=method, device="cpu").numpy()
    assert got.dtype == np.float32
    assert np.array_equal(np.isinf(got), np.isinf(ref))
    f = np.isfinite(ref)
    assert np.abs(got[f] - ref[f]).max() <= REL * np.ptp(table)
    with pytest.raises(ValueError, match="method"):
        PX.regular_grid_interpolate(axes32, table32, pts32, method="onehot", device="cpu")


def test_cubic_spline_and_gammahi_match_jax(tmp_path):
    x = np.linspace(0.0, 8.0, 30)
    y = np.sin(x) + 0.1 * x
    xq = np.linspace(-0.5, 8.5, 211)
    got = PX.cubic_spline_1d(x, y, xq, device="cpu").numpy()
    ref = np.asarray(JX.cubic_spline_1d(x, y, xq))
    assert np.abs(got - ref).max() <= REL * np.abs(y).max()
    assert np.abs(PX.cubic_spline_1d(x, y, x, device="cpu").numpy() - y).max() <= 1e-12
    JI.write_synthetic_hm01_table(str(tmp_path), JI.SupportedIons.H_I)
    ours = PI.IonisationTable_HM01(PI.SupportedIons.H_I, str(tmp_path), device="cpu")
    theirs = JI.IonisationTable_HM01(JI.SupportedIons.H_I, str(tmp_path))
    zq = np.array([0.0, 0.37, 1.0, 2.5, 7.9])
    a = ours.interpolate_gammahi(zq).to_value("s**-1")
    b = theirs.interpolate_gammahi(zq).to_value("s**-1")
    assert np.abs(a / b - 1.0).max() <= REL
    assert ours.interpolate_gammahi(1.0).to_value("s**-1") == pytest.approx(1e-12 * 2.0**1.5, rel=1e-2)


def test_hm01_reads_jax_file_as_jax_does(tmp_path):
    JI.write_synthetic_hm01_table(str(tmp_path), JI.SupportedIons.O_VI)
    ours = PI.IonisationTable_HM01(PI.SupportedIons.O_VI, str(tmp_path), device="cpu")
    theirs = JI.IonisationTable_HM01(JI.SupportedIons.O_VI, str(tmp_path))
    assert np.array_equal(ours.ionisation_fraction_table, theirs.ionisation_fraction_table)
    for d in range(3):
        assert np.array_equal(ours.get_table_dimension(d), theirs.get_table_dimension(d))
    for name in ("cloudy_version", "model_name", "model_description"):
        assert getattr(ours, name) == getattr(theirs, name)
    assert np.array_equal(ours.evaluation_redshifts, theirs.evaluation_redshifts)
    assert np.array_equal(ours.energies.value, theirs.energies.value)
    assert np.array_equal(ours.fluxes.value, theirs.fluxes.value)
    assert ours.number_of_input_dimensions == 3 and ours.ion is PI.SupportedIons.O_VI
    rng = np.random.default_rng(3)
    gas = np.column_stack([rng.uniform(-9, 1, 500), rng.uniform(1.5, 8.5, 500)])
    for z in (0.0, 0.5, 2.0, 7.99):
        a = ours.evaluate_at_redshift(gas, z).numpy()
        b = np.asarray(theirs.evaluate_at_redshift(gas, z))
        assert np.array_equal(np.isinf(a), np.isinf(b)) and np.isinf(a).any()
        f = np.isfinite(b)
        assert np.abs(a[f] - b[f]).max() <= REL * np.abs(b[f]).max()
        # the plane path and the full-D path agree
        full = ours(np.column_stack([gas, np.full(500, z)])).numpy()
        assert np.array_equal(np.isinf(full), np.isinf(a))
        assert np.abs(full[f] - a[f]).max() <= 1e-12


def test_ported_writer_writes_the_same_file(tmp_path):
    import h5py

    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jpath = JI.write_synthetic_hm01_table(str(tmp_path / "jax"), JI.SupportedIons.C_IV, seed=5)
    ppath = PI.write_synthetic_hm01_table(str(tmp_path / "port"), PI.SupportedIons.C_IV, seed=5)
    with h5py.File(jpath, "r") as a, h5py.File(ppath, "r") as b:
        names = []
        a.visit(names.append)
        other = []
        b.visit(other.append)
        assert sorted(names) == sorted(other)
        for name in names:
            if isinstance(a[name], h5py.Dataset):
                assert np.array_equal(a[name][()], b[name][()]), name
            assert dict(a[name].attrs) == dict(b[name].attrs), name
    arrays = PI.synthetic_hm01_arrays(seed=5)
    assert arrays["ionbal"].shape == (16, 20, 8)


def test_table_from_jax_state_gives_jax_lookups():
    rng = np.random.default_rng(4)
    axes = (np.linspace(-8, 0, 5), np.linspace(2, 8, 6), np.linspace(0, 3, 4))
    from astro_sph_tools_tpu.data_structures.ionisation import IonisationTableBase as JBase

    jt = JBase(rng.normal(size=(5, 6, 4)), *axes, redshift_input_index=2)
    pt = IonisationTableBase(
        jt.ionisation_fraction_table, *(jt.get_table_dimension(d) for d in range(3)),
        redshift_input_index=2, device="cpu",
    )
    gas = np.column_stack([rng.uniform(-7, -1, 50), rng.uniform(3, 7, 50)])
    a = pt.evaluate_at_redshift(gas, 1.5).numpy()
    b = np.asarray(jt.evaluate_at_redshift(gas, 1.5))
    assert np.abs(a - b).max() <= REL * np.abs(b).max()
    rows = np.column_stack([gas, rng.uniform(0, 3, 50)])
    assert np.abs(pt(rows).numpy() - np.asarray(jt(rows))).max() <= REL * np.abs(b).max()
    # a negative redshift index counts from the end
    assert IonisationTableBase(jt.ionisation_fraction_table, *axes, device="cpu")._redshift_index == 2
    with pytest.raises(IndexError):
        IonisationTableBase(np.zeros((3, 3)), np.arange(3), device="cpu")


@pytest.mark.parametrize("z", [-0.5, 8.5])
def test_redshift_outside_the_table_gives_minus_inf(tmp_path, z):
    JI.write_synthetic_hm01_table(str(tmp_path), JI.SupportedIons.O_VI)
    ours = PI.IonisationTable_HM01(PI.SupportedIons.O_VI, str(tmp_path), device="cpu")
    theirs = JI.IonisationTable_HM01(JI.SupportedIons.O_VI, str(tmp_path))
    gas = np.array([[-4.0, 4.5], [-2.0, 5.0]])
    plane = ours.evaluate_at_redshift(gas, z).numpy()
    full = ours(np.column_stack([gas, np.full(2, z)])).numpy()
    assert (plane == -np.inf).all() and (full == -np.inf).all()
    # the JAX plane path clamps to the edge plane (finite), its full-D path gives -inf
    jax_plane = np.asarray(theirs.evaluate_at_redshift(gas, z))
    jax_full = np.asarray(theirs(np.column_stack([gas, np.full(2, z)])))
    assert np.isfinite(jax_plane).all() and (jax_full == -np.inf).all()
    print(f"z={z}: JAX's clamped plane value {jax_plane.tolist()}, the port's -inf")


def test_supported_ions_are_the_jax_ions(tmp_path):
    assert [(i.name, i.value) for i in PI.SupportedIons] == [(i.name, i.value) for i in JI.SupportedIons]
    assert len(PI.SupportedIons) == 38
    assert PI.SupportedIons.O_VI.display_name == "O VI"
    assert len(PI.SupportedIons.ions_of_element("C")) == 6
    with pytest.raises(FileNotFoundError):
        PI.IonisationTable_HM01(PI.SupportedIons.C_IV, str(tmp_path), device="cpu")
