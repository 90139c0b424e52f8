"""Port vs JAX: the ion-weighted workflow as a whole.

``tests/test_science_workflow.py``'s composition (the JAX package runs it
in its slow lane), in the fast lane on the port's plain kernel versions:
the synthetic EAGLE fixture of 3,000 clustered gas particles, n_H from the
element abundances, the synthetic O VI HM01 table at the snapshot's
redshift, then

- per-particle ion fractions against scipy's ``RegularGridInterpolator``
  over the table file's arrays (f64: 1e-10 relative) and against the JAX
  package's (its f32 lookup: 1e-5 relative, its own test's bound);
- an ion-weighted 64^2 map from the sorted engine (``deposit_2d_auto``,
  host f64 positions: the native assignment) and from the zero-sync fused
  coherent engine (``deposit_2d_coherent_fused``, capacities from one
  synced layout, its ``ok`` flag checked), each within 1e-5 * max of the
  JAX package's XLA twin (the stencil engine ``ops.deposit.deposit_2d``)
  on the same ion masses and of the f64 oracle;
- ion columns on 32 rays (``column_integrate``, periodic) within 1e-5 *
  max of JAX's and of a dense f64 sum of the line-integrated kernel.
"""

import numpy as np
import pytest
import torch
from scipy.interpolate import RegularGridInterpolator

from astro_sph_tools_tpu.data_structures import ParticleType as JParticleType
from astro_sph_tools_tpu.io.eagle import SnapshotEAGLE as JSnapshotEAGLE
from astro_sph_tools_tpu.io.ionisation import IonisationTable_HM01 as JTable
from astro_sph_tools_tpu.io.ionisation import SupportedIons as JIons
from astro_sph_tools_tpu.io.ionisation import write_synthetic_hm01_table
from astro_sph_tools_tpu.io.synthetic import SyntheticSnapshotSpec, write_snapshot
from astro_sph_tools_tpu.ops.deposit import MapSpec as JMapSpec
from astro_sph_tools_tpu.ops.deposit import deposit_2d as j_deposit_2d
from astro_sph_tools_tpu.ops.sightlines import column_integrate as j_column_integrate
from astro_sph_tools_tpu_torch.data_structures import ParticleType
from astro_sph_tools_tpu_torch.io import IonisationTable_HM01, SnapshotEAGLE, SupportedIons
from astro_sph_tools_tpu_torch.kernels.splines import get_kernel
from astro_sph_tools_tpu_torch.ops import (
    MapSpec,
    caps_from_layout,
    column_integrate,
    deposit_2d_auto,
    deposit_2d_coherent_fused,
    deposit_coherent,
    tile_particles_coherent,
)
from oracles import _integrated_w_oracle, project_oracle

TOL = 1e-5
RES = 64


@pytest.fixture(scope="module")
def workflow(tmp_path_factory):
    root = tmp_path_factory.mktemp("ion_workflow")
    spec = SyntheticSnapshotSpec(n_gas=3000, n_dm=64, n_star=16, n_bh=2, clustered=True, n_groups=4)
    snap_path, _ = write_snapshot(str(root), spec)
    write_synthetic_hm01_table(str(root), JIons.O_VI)
    ours = SnapshotEAGLE(snap_path), IonisationTable_HM01(SupportedIons.O_VI, str(root), device="cpu")
    theirs = JSnapshotEAGLE(snap_path), JTable(JIons.O_VI, str(root))
    snap = ours[0]
    gas = ParticleType.gas
    pos = snap.get_positions(gas).to_value("Mpc")
    return {
        "ours": ours, "theirs": theirs, "box": float(snap.box_size.value[0]),
        "x": np.ascontiguousarray(pos[:, 0]), "y": np.ascontiguousarray(pos[:, 1]),
        "h": snap.get_smoothing_lengths(gas).to_value("Mpc"),
    }


def gas_state(snap, gas):
    n_h = snap.get_number_densities(gas, "H").to_value("cm**-3")
    temp = snap.get_temperatures(gas).to_value("K")
    mass = snap.get_masses(gas).to_value("Msun")
    return np.stack([np.log10(n_h), np.log10(temp)], axis=1), mass


def ion_masses(workflow):
    snap, table = workflow["ours"]
    state, mass = gas_state(snap, ParticleType.gas)
    frac = 10.0 ** table.evaluate_at_redshift(state, snap.redshift).numpy()
    return mass * frac, frac, state


def test_fractions_match_scipy_and_jax(workflow):
    ion_mass, frac, state = ion_masses(workflow)
    assert np.isfinite(frac).all() and (frac >= 0).all() and (frac > 0).any()
    snap, table = workflow["ours"]
    interp = RegularGridInterpolator(
        tuple(table.get_table_dimension(d) for d in range(3)), table.ionisation_fraction_table,
        bounds_error=False, fill_value=-np.inf,
    )
    exp = 10.0 ** interp(np.column_stack([state, np.full(state.shape[0], snap.redshift)]))
    np.testing.assert_allclose(frac, exp, rtol=1e-10, atol=1e-300)
    jsnap, jtable = workflow["theirs"]
    jstate, jmass = gas_state(jsnap, JParticleType.gas)
    assert np.array_equal(jstate, state)
    jfrac = 10.0 ** np.asarray(jtable.evaluate_at_redshift(jstate, jsnap.redshift), np.float64)
    np.testing.assert_allclose(frac, jfrac, rtol=TOL, atol=1e-30)


def test_ion_weighted_maps_match_jax_and_the_oracle(workflow):
    ion_mass, _, _ = ion_masses(workflow)
    box, x, y, h = workflow["box"], workflow["x"], workflow["y"], workflow["h"]
    m32 = ion_mass.astype(np.float32)
    spec = MapSpec(shape=(RES, RES), extent=(0.0, box, 0.0, box), periodic_wrap=True)
    sorted_map = deposit_2d_auto(x, y, h, m32, spec, device="cpu").numpy()
    # the fused engine's capacities from one synced layout, as the
    # ion-weighted render calibrates them
    xf, yf, hf = (torch.as_tensor(a, dtype=torch.float32) for a in (x, y, h))
    mf = torch.as_tensor(m32)[None, :]
    lay = tile_particles_coherent(xf, yf, hf, mf, spec, device="cpu")
    synced = deposit_coherent(lay)[0].numpy()
    fused, ok = deposit_2d_coherent_fused(xf, yf, hf, mf, spec, caps_from_layout(lay), device="cpu")
    assert bool(ok)
    fused = fused[0].numpy()
    jax_map = np.asarray(j_deposit_2d(x.astype(np.float32), y.astype(np.float32), h.astype(np.float32), m32,
                                      JMapSpec(shape=(RES, RES), extent=(0.0, box, 0.0, box), periodic_wrap=True)))
    ref = project_oracle(x, y, h, m32.astype(np.float64), (RES, RES), spec.extent, periodic=True)
    scale = np.abs(ref).max()
    assert scale > 0 and (sorted_map >= 0).all()
    for got in (sorted_map, synced, fused):
        assert np.abs(got - ref).max() <= TOL * scale
        assert np.abs(got - jax_map).max() <= TOL * scale
    assert np.abs(jax_map - ref).max() <= TOL * scale


def test_ion_columns_match_jax_and_the_oracle(workflow):
    ion_mass, _, _ = ion_masses(workflow)
    box, x, y, h = workflow["box"], workflow["x"], workflow["y"], workflow["h"]
    m32 = ion_mass.astype(np.float32)
    rng = np.random.default_rng(5)
    rx, ry = rng.uniform(0, box, 32), rng.uniform(0, box, 32)
    cols = column_integrate(x, y, h, m32, rx, ry, periodic_box=box, device="cpu").numpy()
    jcols = np.asarray(j_column_integrate(x, y, h, m32, rx, ry, periodic_box=box))
    w = _integrated_w_oracle("cubic_spline", get_kernel("cubic_spline").support_factor)
    exp = np.empty(32)
    for i in range(32):
        dx = np.abs(x - rx[i])
        dy = np.abs(y - ry[i])
        dx, dy = np.minimum(dx, box - dx), np.minimum(dy, box - dy)
        exp[i] = float((m32.astype(np.float64) * w(np.sqrt(dx * dx + dy * dy), h)).sum())
    assert cols.shape == (32,) and np.isfinite(cols).all() and (cols >= 0).all() and exp.max() > 0
    assert np.abs(cols - exp).max() <= TOL * exp.max()
    assert np.abs(cols - jcols).max() <= TOL * exp.max()
