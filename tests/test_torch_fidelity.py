"""``scripts/fidelity_check.py``, the port's fidelity artifact, on the CPU:
``--small --device cpu`` writes a file of the documented schema with every
in-budget case within its budget, and the module's f64 oracle equals
``tests/oracles.py::project_oracle_fast`` (the JAX package's f64 scatter
oracle) to 1e-12 in both projections, periodic and open; the 3D one equals
``grid3d_oracle``. The card runs the full sizes (``chip_smoke.py`` phase
24)."""

import json

import numpy as np
import pytest
import torch

from astro_sph_tools_tpu_torch.scripts import fidelity_check as F
from oracles import grid3d_oracle, project_oracle_fast

CASE_KEYS = {"case", "precision", "n_particles", "max_rel_err", "budget", "in_budget_flag", "wall_s", "kernels"}


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    path = tmp_path_factory.mktemp("fid") / "FIDELITY_TORCH.json"
    F.main(["--small", "--device", "cpu", "--out", str(path)])
    with open(path) as f:
        return json.load(f)


def test_small_artifact_schema_and_budget(artifact):
    assert artifact["small"] is True and artifact["budget"] == F.BUDGET == 1e-5
    assert artifact["device"] == "cpu" and "not measured" in artifact["nvidia_smi"]
    cases = artifact["cases"]
    assert all(CASE_KEYS <= set(c) for c in cases)
    assert all(c["kernels"] == {} for c in cases)  # no kernel launches on the CPU
    names = " | ".join(c["case"] for c in cases)
    for part in ("K=8", "K=64", "lognormal", "columns", "gaussian", "voigt", "coherent-order", "fused",
                 "shear", "ion table", "bucketed", "window mode", "render_halo_maps", "f32 wire", "pack wire",
                 "packdelta wire", "deposit_3d_auto"):
        assert part in names, part
    assert {c["precision"] for c in cases if c["case"].startswith("K=")} == {"f32", "bf16x2", "bf16x3", "bf16"}
    scored = [c for c in cases if c["in_budget_flag"]]
    over = [c for c in scored if not c["max_rel_err"] <= c["budget"]]
    assert not over and artifact["all_within_budget"] is True
    worst = max(scored, key=lambda c: c["max_rel_err"])
    assert artifact["worst_case"]["max_rel_err"] == worst["max_rel_err"]
    for part in ("bucketed", "window mode"):
        row = next(c for c in cases if part in c["case"])
        assert row["in_budget_flag"] and "placed particles" in row["case"]
        assert 0 < row["placement_max_px"] <= F.PLACE_TOL_PX
        assert row["vs_sorted_engine"] <= row["budget"] and row["vs_f64_oracle_of_inputs"] > 0
    informational = {c["case"] for c in cases if not c["in_budget_flag"]}
    assert any("pack wire" in c for c in informational) and any("packdelta" in c for c in informational)


def _port_table_oracle(kernel, support_factor):
    """``oracles._integrated_w_oracle`` on the port's f64 table: the JAX
    package tabulates the line integral in f32 arithmetic (its table is
    ~6e-8 of its peak off the f64 one), which a 1e-12 comparison of the
    scatter would see."""
    from astro_sph_tools_tpu_torch.kernels.splines import integrated_kernel_table

    tab = integrated_kernel_table(kernel, 65536)
    grid = np.linspace(0.0, 1.0, 65536)

    def w(r, h):
        u = r / (support_factor * h)
        return np.where(u < 1.0, np.interp(np.minimum(u, 1.0), grid, tab) / (h * h), 0.0)

    return w


def test_integrated_tables_agree():
    from astro_sph_tools_tpu.kernels.splines import integrated_kernel_table as jax_table
    from astro_sph_tools_tpu_torch.kernels.splines import integrated_kernel_table

    port, jax_t = integrated_kernel_table("cubic_spline", 65536), np.asarray(jax_table("cubic_spline", 65536))
    assert np.abs(port - jax_t).max() <= 1e-7 * np.abs(port).max()


@pytest.mark.parametrize("projection", ["kernel3d", "integrated"])
@pytest.mark.parametrize("periodic", [False, True])
def test_f64_oracle_equals_project_oracle_fast(monkeypatch, projection, periodic):
    import oracles

    monkeypatch.setattr(oracles, "_integrated_w_oracle", _port_table_oracle)
    rng = np.random.default_rng(7)
    n, res, box = 3000, 48, 6.0
    px = box / res
    x = rng.uniform(-0.3, box + 0.3, n)
    y = rng.uniform(-0.3, box + 0.3, n)
    # footprints from sub-pixel to past the largest window (the whole-image pass)
    h = np.exp(rng.uniform(np.log(0.2 * px), np.log(40 * px), n))
    m = rng.uniform(0.5, 2.0, n)
    extent = (0.0, box, 0.0, box)
    got = F.project_f64(x, y, h, m, (res, res), extent, periodic=periodic, projection=projection, pairs=1 << 14)
    ref = project_oracle_fast(x, y, h, m, (res, res), extent, periodic=periodic, projection=projection)
    assert got.shape == (1, res, res)
    assert np.abs(got[0].numpy() - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("periodic", [False, True])
def test_f64_grid_equals_grid3d_oracle(periodic):
    rng = np.random.default_rng(8)
    n, side, box = 300, 10, 4.0
    vox = box / side
    pos = rng.uniform(0, box, (n, 3))
    h = rng.uniform(0.3 * vox, 2.5 * vox, n)  # supports under half the box
    m = rng.uniform(0.5, 2.0, n)
    extent = (0.0, box) * 3
    got = F.grid_f64(pos, h, m, (side,) * 3, extent, periodic=periodic)
    ref = grid3d_oracle(pos, h, m, (side,) * 3, extent, periodic=periodic)
    assert np.abs(got.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()


def test_columns_reference_matches_the_dense_engine():
    from astro_sph_tools_tpu_torch.ops.sightlines import column_integrate

    rng = np.random.default_rng(9)
    n, box = 4000, 5.0
    x, y = rng.uniform(0, box, n), rng.uniform(0, box, n)
    h = rng.uniform(0.05, 0.4, n)
    m = rng.uniform(0.5, 2.0, n)
    rx, ry = rng.uniform(0, box, 32), rng.uniform(0, box, 32)
    got = F.columns_f64(x, y, h, m, rx, ry, box=box)
    ref = column_integrate(x, y, h, m, rx, ry, periodic_box=box, device="cpu")
    assert got.dtype == torch.float64
    assert np.abs(got.numpy() - ref.double().numpy()).max() <= 1e-5 * np.abs(ref.numpy()).max()


def test_no_card_refuses():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        F.run("cuda", small=True)


def test_3d_placement_keeps_f64_input_in_f64():
    """f64 positions place in f64 (tile-local f32 voxel coordinates from f64
    arithmetic); the same positions as f32 round ~1.5e-5 voxel past 256, so
    sub-voxel footprints at 256^3 leave the 1e-5 budget (the fidelity
    artifact's 3D case, 2^20 particles on an H100: 4.5e-5 with f32
    placement)."""
    from astro_sph_tools_tpu_torch.ops import GridSpec, deposit_3d_auto

    rng = np.random.default_rng(10)
    n, side, box = 1 << 13, 256, 25.0
    vox = box / side
    spec = GridSpec(shape=(side,) * 3, extent=(0.0, box) * 3, periodic_wrap=True)
    pos = rng.uniform(0, box, (n, 3))
    h = np.clip(np.exp(rng.normal(np.log(0.8 * vox), 0.5, n)), 0.4 * vox, 3.5 * vox)
    m = rng.uniform(0.5, 2.0, n)
    ref = F.grid_f64(pos, h, m, spec.shape, spec.extent, periodic=True)
    assert F.rel_err(deposit_3d_auto(pos, h, m, spec, device="cpu"), ref) <= F.BUDGET
    f32_pos = pos.astype(np.float32)
    ref32 = F.grid_f64(f32_pos, h, m, spec.shape, spec.extent, periodic=True)
    assert F.rel_err(deposit_3d_auto(f32_pos.astype(np.float64), h, m, spec, device="cpu"), ref32) <= F.BUDGET


@pytest.mark.parametrize("periodic", [False, True])
def test_placed_oracle_is_the_input_oracle_where_placement_is_exact(periodic):
    """With a power-of-two pixel and coordinates on a 2^-12 px lattice the
    f32 placement is exact: ``placed_f64`` finds no offset and equals
    ``project_f64`` of the inputs; on ordinary f32 coordinates its offset
    stays within PLACE_TOL_PX."""
    from astro_sph_tools_tpu_torch.ops import MapSpec

    rng = np.random.default_rng(12)
    n, res, box = 6000, 64, 8.0
    px = box / res
    spec = MapSpec(shape=(res, res), extent=(0.0, box, 0.0, box), periodic_wrap=periodic)
    x = (np.floor(rng.uniform(0, box, n) / px * 4096) * px / 4096).astype(np.float32)
    y = (np.floor(rng.uniform(0, box, n) / px * 4096) * px / 4096).astype(np.float32)
    h = np.exp(rng.uniform(np.log(0.05 * px), np.log(6 * px), n)).astype(np.float32)
    m = rng.uniform(0.5, 2.0, n).astype(np.float32)
    placed, offset = F.placed_f64(x, y, h, m, spec, "cpu")
    ref = F.project_f64(x, y, h, m, spec.shape, spec.extent, periodic=periodic)
    assert offset == 0.0
    assert np.abs(placed.numpy() - ref.numpy()).max() <= 1e-12 * np.abs(ref.numpy()).max()
    xr = (x + rng.uniform(0, px / 4096, n)).astype(np.float32) % np.float32(box)
    _, offset = F.placed_f64(xr, y, h, m, spec, "cpu")
    assert 0.0 < offset <= F.PLACE_TOL_PX
