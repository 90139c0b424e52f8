"""``render_sightlines`` (BASELINE config 4's product through the render
layer) on the CPU, where kernels #4 and #5 run their plain torch versions.

- Against the benchmark's plain reference, ``sphbench/reference/
  los_spectra.py`` (float64, its own candidates, quadrature and Dawson
  function), on seeded random particles: Voigt and Gaussian lines, a
  periodic and an open box, float64 and float32 input. The reference's
  bfloat16 control fails every tolerance.
- The render adds no arithmetic: its columns and spectra are the op calls'
  bit for bit, on either engine.
- Its spans and their counters, and nothing without the profiler.
- The sightlines CLI, which now goes through the render, writes what the
  ops give, in its HDF5 layout.
- On the card (marker ``cuda``; the file imports no JAX and, at its top, no
  h5py, so ``--noconftest -m cuda`` runs it there): kernels #4 and #5 run,
  once each, and hold the same tolerances against the reference.
"""

from functools import lru_cache

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from astro_sph_tools_tpu_torch import Sightlines, render_sightlines
from astro_sph_tools_tpu_torch.data_structures import CoordinateAxes, ParticleType
from astro_sph_tools_tpu_torch.io.memory import MemorySnapshot
from astro_sph_tools_tpu_torch.io.synthetic import SyntheticSnapshotSpec, write_snapshot
from astro_sph_tools_tpu_torch.ops.sightlines import column_integrate
from astro_sph_tools_tpu_torch.ops.sightlines_fused import _columns_layout, column_integrate_pallas
from astro_sph_tools_tpu_torch.ops.spectra import absorption_spectra
from astro_sph_tools_tpu_torch.ops.spectra_fused import _spectra_layout, absorption_spectra_pallas
from astro_sph_tools_tpu_torch.scripts.render_map import load_snapshot
from astro_sph_tools_tpu_torch.scripts.sightlines_cli import _engine as _cli_engine
from astro_sph_tools_tpu_torch.scripts.sightlines_cli import main as cli_main
from astro_sph_tools_tpu_torch.utils.profiling import device_trace, spans
from sphbench.reference import los_spectra

N, RAYS, BINS, BOX, Z = 3000, 64, 128, 10.0, 0.5
GAMMA = 6.265e8  # H I Lya damping rate, 1/s
FIELDS = ("positions", "smoothing_lengths", "masses", "velocities", "temperatures")

#: Tolerances, as max |a - b| / max |b| and sum |a - b| / sum |b| of the
#: columns and of the spectra against the float64 reference.
#: - float64 input: the fidelity budget, 1e-5 of the largest value. The
#:   kernels place the particles, the rays and the line velocities in
#:   float32 (an impact parameter ~5e-7 cMpc off in a 10 cMpc box, a line
#:   centre ~3e-5 km/s off against Doppler widths of 7-400 km/s), and sum
#:   their float32 column table and profiles: 0.9-1.0e-6 of the largest
#:   column, 4.2-5.7e-6 of the largest spectrum bin here.
#: - float32 input: the reference reads the same float32 values, so what is
#:   left is the kernels' float32 placement of the float64 rays and bin
#:   centres and their float32 arithmetic: 0.6-0.7e-6 and 2.9-3.4e-6 here,
#:   held to the same budget.
#: - the summed gap, 5e-6: the float32 rounding of ~10 hits a bin averages
#:   out to 0.3-1.4e-6 here.
#: The control (float32 placement, bfloat16 per-pair steps, float32 sums)
#: reads 2.2e-3 on the columns and 1e-2 to 0.24 on the spectra.
MAX_REL = {torch.float64: 1e-5, torch.float32: 1e-5}
L1_REL = 5e-6


def _inputs(seed: int, dtype) -> dict:
    """Particles of h 0.15-0.6 cMpc in a 10 cMpc box (each ray meets ~20
    supports), temperatures as the configuration draws them (Doppler
    widths of 7-400 km/s) and random rays."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, dtype=dtype)
    return {
        "positions": t(rng.uniform(0.0, BOX, (N, 3))),
        "smoothing_lengths": t(rng.uniform(0.15, 0.6, N)),
        "masses": t(rng.uniform(0.5, 2.0, N)),
        "velocities": t(rng.normal(0.0, 100.0, (N, 3))),
        "temperatures": t(10.0 ** np.clip(rng.normal(4.3, 0.6, N), 3.5, 7.0)),
        "box": BOX,
        "ray_x": rng.uniform(0.0, BOX, RAYS),
        "ray_y": rng.uniform(0.0, BOX, RAYS),
    }


def _config(profile: str, periodic: bool) -> dict:
    return {
        "kernel": "wendland_c2",
        "snapshot": {"redshift": Z, "hubble_h": 0.6777, "omega_b": 0.04825, "omega_m": 0.307,
                     "omega_lambda": 0.693},
        "product": {"axis": "z", "n_bins": BINS, "profile": profile, "gamma_per_s": GAMMA,
                    "rest_wavelength_angstrom": 1215.67, "atomic_weight": 1.008, "periodic": periodic},
    }


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The CPU versions of kernels #4 and #5 are ~2,000 small tensor ops a
    render, each an OpenMP region over every core. With the test run's
    workers sharing the cores, each region waits for threads the scheduler
    has set aside: a render took ~40 s so, against ~0.2 s alone. One
    intra-op thread a worker takes that wait away."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@lru_cache(maxsize=None)
def _reference(profile: str, periodic: bool, dtype) -> tuple:
    """(inputs, (columns, tau) of the float64 reference) of one case, shared
    by the tests that hold the render and the control to it."""
    inputs = _inputs(11, dtype)
    return inputs, los_spectra.sightlines(inputs, _config(profile, periodic), "cpu")


def _snap(inputs) -> MemorySnapshot:
    return MemorySnapshot({k: inputs[k] for k in FIELDS}, BOX, redshift=Z)


def _render(inputs, profile, periodic, engine="pallas") -> Sightlines:
    return render_sightlines(_snap(inputs), inputs["ray_x"], inputs["ray_y"], kernel="wendland_c2", spectra=True,
                             n_bins=BINS, profile=profile, gamma=GAMMA, periodic=periodic, engine=engine,
                             device="cpu")


def _gaps(a, b) -> tuple:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max(), np.abs(a - b).sum() / np.abs(b).sum()


def _within(got, ref, dtype) -> bool:
    widest, summed = _gaps(got, ref)
    return widest <= MAX_REL[dtype] and summed <= L1_REL


CASES = [(p, per, dt) for p in ("voigt", "gaussian") for per in (True, False) for dt in (torch.float64, torch.float32)]


@pytest.mark.parametrize("profile,periodic,dtype", CASES)
def test_render_sightlines_matches_the_reference(profile, periodic, dtype):
    inputs, (columns, tau) = _reference(profile, periodic, dtype)
    los = _render(inputs, profile, periodic)
    assert los.columns.shape == (RAYS,) and los.tau.shape == (RAYS, BINS)
    assert float(columns.min()) > 0.0  # every ray meets supports
    assert _within(los.columns, columns, dtype), _gaps(los.columns, columns)
    assert _within(los.tau, tau, dtype), _gaps(los.tau, tau)


@pytest.mark.parametrize("profile,periodic,dtype", CASES)
def test_the_control_fails_each_tolerance(profile, periodic, dtype):
    """One precision below (float32 placement, bfloat16 per-pair steps,
    float32 sums), the reference misses both tolerances, on the columns
    and on the spectra."""
    inputs, ref = _reference(profile, periodic, dtype)
    control = los_spectra.sightlines(inputs, _config(profile, periodic), "cpu", control=True)
    for got, want in zip(control, ref):
        widest, summed = _gaps(got, want)
        assert widest > 10 * MAX_REL[dtype] and summed > 10 * L1_REL


def _without_wings(monkeypatch, how: str):
    """The reference's spectra that lose the damping wings: a Gaussian line
    in the Voigt's place, or the Voigt with its wing series (|x| > 7, where
    the program's Chebyshev fit ends) set to 0."""
    if how == "gaussian":
        return lambda inputs, config: los_spectra.sightlines(
            inputs, dict(config, product=dict(config["product"], profile="gaussian")), "cpu")
    parts = los_spectra._voigt_parts

    def cut(a, x):
        g, near, e = parts(a, x)
        return torch.where(torch.abs(x) > 7.0, torch.zeros_like(g), g), near, e

    monkeypatch.setattr(los_spectra, "_voigt_parts", cut)
    return lambda inputs, config: los_spectra.sightlines(inputs, config, "cpu")


@pytest.mark.parametrize("how", ["gaussian", "wing_cut"])
@pytest.mark.parametrize("periodic", [True, False])
def test_spectra_without_damping_wings_fail_the_tolerance(monkeypatch, how, periodic):
    """The damping a = Gamma lambda_0 / (4 pi b) is ~3e-4 at b = 18 km/s: a
    spectrum that drops the wings, or only their series beyond |x| = 7,
    misses the summed-gap tolerance, while its columns stay the same."""
    inputs, (columns, tau) = _reference("voigt", periodic, torch.float64)
    got_columns, got_tau = _without_wings(monkeypatch, how)(inputs, _config("voigt", periodic))
    assert _within(got_columns, columns, torch.float64)
    widest, summed = _gaps(got_tau, tau)
    assert summed > 2 * L1_REL, (widest, summed)


@pytest.mark.parametrize("engine", ["pallas", "dense"])
def test_the_render_is_the_op_calls_bit_for_bit(engine):
    inputs = _inputs(12, torch.float32)
    los = _render(inputs, "voigt", True, engine)
    pos, h, m = inputs["positions"], inputs["smoothing_lengths"], inputs["masses"]
    rx, ry = inputs["ray_x"], inputs["ray_y"]
    column_fn, spectra_fn = ((column_integrate_pallas, absorption_spectra_pallas) if engine == "pallas"
                             else (column_integrate, absorption_spectra))
    columns = column_fn(pos[:, 0], pos[:, 1], h, m, rx, ry, kernel="wendland_c2", projection="integrated",
                        periodic_box=BOX, device="cpu")
    tau, v_centres = spectra_fn(pos[:, [0, 1, 2]], h, m, inputs["velocities"][:, 2], inputs["temperatures"], rx, ry,
                                cosmology=_snap(inputs).cosmology, box_size=BOX, n_bins=BINS, kernel="wendland_c2",
                                profile="voigt", gamma=GAMMA, device="cpu")
    assert np.array_equal(los.columns, columns.numpy())
    assert np.array_equal(los.tau, tau.numpy())
    assert np.array_equal(los.velocity_kms, v_centres)
    assert set(los.timings) == {"io", "columns", "spectra", "to_host"}


def test_an_axis_other_than_z_rotates_the_line_of_sight():
    """Along x the rays stand on (y, z) and the lines take the velocities'
    x component: the render along x of a snapshot is the render along z of
    the same snapshot with its axes turned (y, z, x) -> (x, y, z)."""
    inputs = _inputs(13, torch.float64)
    turned = dict(inputs, positions=inputs["positions"][:, [1, 2, 0]], velocities=inputs["velocities"][:, [1, 2, 0]])
    kw = dict(kernel="wendland_c2", spectra=True, n_bins=BINS, profile="voigt", gamma=GAMMA, engine="pallas",
              device="cpu")
    along_x = render_sightlines(_snap(inputs), inputs["ray_x"], inputs["ray_y"], axis=CoordinateAxes.X, **kw)
    along_z = render_sightlines(_snap(turned), inputs["ray_x"], inputs["ray_y"], **kw)
    assert np.array_equal(along_x.columns, along_z.columns) and np.array_equal(along_x.tau, along_z.tau)


def test_columns_alone_read_no_velocities():
    inputs = _inputs(14, torch.float32)
    snap = MemorySnapshot({k: inputs[k] for k in ("positions", "smoothing_lengths", "masses")}, BOX, redshift=Z)
    los = render_sightlines(snap, inputs["ray_x"], inputs["ray_y"], kernel="wendland_c2", engine="pallas",
                            device="cpu")
    assert los.tau is None and los.velocity_kms is None and "spectra" not in los.timings
    assert np.array_equal(los.columns, _render(inputs, "gaussian", True).columns)


@pytest.mark.parametrize("engine", ["bogus", "auto"])
def test_an_unknown_engine_raises(engine):
    """The render takes no size rule of its own: the engine is the
    caller's choice."""
    inputs = _inputs(15, torch.float32)
    with pytest.raises(ValueError, match="Unknown engine"):
        _render(inputs, "voigt", True, engine=engine)


def test_the_fused_engine_refuses_bins_its_kernel_cannot_take():
    """Asked for the fused passes, spectra of bins no multiple of 128 raise
    instead of running the dense sweep."""
    inputs = _inputs(15, torch.float32)
    with pytest.raises(ValueError, match="multiple of 128"):
        render_sightlines(_snap(inputs), inputs["ray_x"], inputs["ray_y"], kernel="wendland_c2", spectra=True,
                          n_bins=100, profile="gaussian", engine="pallas", device="cpu")


def test_the_benchmark_entry_hands_compare_the_columns_view_and_tau():
    from sphbench.harness import Context, ROOT, load_module

    inputs = _inputs(16, torch.float32)
    config = _config("voigt", True)
    entry = load_module(ROOT / "sphbench" / "entries" / "render_sightlines.py")
    answers, timings = entry.setup(Context(inputs, config, {"engine": "pallas"}, torch.device("cpu")))()
    los = _render(inputs, "voigt", True)
    assert list(answers[0]) == ["surface_density", "tau"]
    assert np.array_equal(answers[0]["surface_density"], los.columns.reshape(1, RAYS))
    assert np.array_equal(answers[0]["tau"], los.tau) and set(timings) == set(los.timings)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


def test_spans_and_their_counters_under_the_profiler():
    inputs = _inputs(17, torch.float32)
    with profile(activities=[ProfilerActivity.CPU]):
        _render(inputs, "voigt", True)
    records = spans()
    by_name = {}
    for s in records:
        by_name.setdefault(s["name"], []).append(s["counts"])
    assert by_name["render.sightlines"] == [{"particles": N, "rays": RAYS, "bins": BINS}]
    pos, h, m = inputs["positions"], inputs["smoothing_lengths"], inputs["masses"]
    columns, _, _ = _columns_layout(pos[:, 0], pos[:, 1], h, m, inputs["ray_x"], inputs["ray_y"],
                                    kernel="wendland_c2", periodic_box=BOX, device="cpu")
    staged, _, _, n_images = _spectra_layout(
        pos, h, m, inputs["velocities"][:, 2], inputs["temperatures"], inputs["ray_x"], inputs["ray_y"],
        cosmology=_snap(inputs).cosmology, box_size=BOX, atomic_weight=1.008, n_bins=BINS, kernel="wendland_c2",
        periodic=True, profile="voigt", device="cpu")
    assert by_name["layout.rays"] == [
        {"particles": N, "rays": RAYS, "levels": len(columns.grids), "items": columns.n_items},
        {"particles": N, "rays": RAYS, "levels": len(staged.rorders), "blocks": staged.n_blocks},
    ]
    # the CPU runs the plain versions: the launches are counted, and 0
    assert by_name["sightlines.columns"] == [{"rays": RAYS, "items": columns.n_items, "launches": 0}]
    assert by_name["sightlines.spectra"] == [{"rays": RAYS, "blocks": staged.n_blocks, "bins": BINS,
                                              "images": 2 * n_images + 1, "launches": 0}]
    assert n_images == 3  # a Voigt line's 7 images


def test_nothing_is_recorded_without_the_profiler():
    with device_trace():  # opens a new, empty window
        pass
    _render(_inputs(18, torch.float32), "voigt", True)
    assert spans() == []


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernels #4 and #5 run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("line", ["voigt", "gaussian"])
def test_on_the_card_kernels_4_and_5_run_once_and_match_the_reference(cuda_device, line):
    from astro_sph_tools_tpu_torch.ops import kernel_counters

    inputs = _inputs(19, torch.float32)
    on_card = dict(inputs, **{k: inputs[k].to(cuda_device) for k in FIELDS})
    counters = kernel_counters()
    before = {k: counters[k].launches for k in ("sightline_columns", "sightline_spectra")}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        los = render_sightlines(_snap(on_card), inputs["ray_x"], inputs["ray_y"], kernel="wendland_c2", spectra=True,
                                n_bins=BINS, profile=line, gamma=GAMMA, engine="pallas", device=cuda_device)
    kernels = {s["name"]: s for s in spans() if s["name"].startswith("sightlines.")}
    assert {k: counters[k].launches - before[k] for k in before} == {"sightline_columns": 1, "sightline_spectra": 1}
    assert kernels["sightlines.columns"]["counts"]["launches"] == 1
    assert kernels["sightlines.spectra"]["counts"]["launches"] == 1
    assert all(s["self_device_ms"] > 0 for s in kernels.values())
    columns, tau = los_spectra.sightlines(inputs, _config(line, True), "cpu")
    assert _within(los.columns, columns, torch.float32), _gaps(los.columns, columns)
    assert _within(los.tau, tau, torch.float32), _gaps(los.tau, tau)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def snap_path(tmp_path_factory):
    spec = SyntheticSnapshotSpec(n_gas=1024, n_dm=64, n_star=16, n_bh=2, n_files=2, clustered=True)
    path, _ = write_snapshot(str(tmp_path_factory.mktemp("los_cli")), spec)
    return path


@pytest.mark.parametrize("n_pairs,spectra,bins,engine", [
    (1e6, True, 512, "dense"), (1e7, False, 100, "pallas"), (1e7, True, 512, "pallas"), (1e8, True, 100, "dense")])
def test_the_cli_resolves_auto_to_one_engine(n_pairs, spectra, bins, engine):
    """``--engine auto``: the fused passes from 10^7 particle x ray pairs on,
    where the spectra's bins allow them; the render gets the one engine."""
    assert _cli_engine("auto", n_pairs, spectra, bins) == engine
    assert _cli_engine("dense", 1e9, True, 512) == "dense"


def test_the_cli_says_which_engine_it_took(snap_path, tmp_path, capsys):
    args = ["--snapshot", snap_path, "--output", str(tmp_path / "e.hdf5"), "--device", "cpu", "--n-rays", "4"]
    assert cli_main(args) == 0
    assert "Engine: dense" in capsys.readouterr().out


@pytest.mark.parametrize("engine", ["pallas", "dense"])
def test_the_cli_writes_what_the_ops_give(snap_path, tmp_path, engine):
    out = str(tmp_path / "rays.hdf5")
    args = ["--snapshot", snap_path, "--output", out, "--device", "cpu", "--n-rays", "12", "--spectra",
            "--spectra-bins", "128", "--profile", "voigt", "--gamma", str(GAMMA), "--engine", engine,
            "--kernel", "wendland_c2"]
    assert cli_main(args) == 0
    import h5py

    snap = load_snapshot(snap_path, "eagle")
    box = float(snap.box_size.value[0])
    rng = np.random.default_rng(8)  # the CLI's default ray seed
    rx, ry = rng.uniform(0.0, box, 12), rng.uniform(0.0, box, 12)
    pos = snap.get_positions(ParticleType.gas).to_value("Mpc")
    h = snap.get_smoothing_lengths(ParticleType.gas).to_value("Mpc")
    m = snap.get_masses(ParticleType.gas).to_value("Msun")
    v = snap.get_velocities(ParticleType.gas).to_value("km/s")[:, 2]
    temp = snap.get_temperatures(ParticleType.gas).to_value("K")
    column_fn, spectra_fn = ((column_integrate_pallas, absorption_spectra_pallas) if engine == "pallas"
                             else (column_integrate, absorption_spectra))
    columns = column_fn(pos[:, 0], pos[:, 1], h, m, rx, ry, kernel="wendland_c2", projection="integrated",
                        periodic_box=box, device="cpu").numpy()
    tau, v_centres = spectra_fn(pos[:, [0, 1, 2]], h, m, v, temp, rx, ry, cosmology=snap.cosmology, box_size=box,
                                n_bins=128, kernel="wendland_c2", profile="voigt", gamma=GAMMA, device="cpu")
    with h5py.File(out, "r") as f:
        assert sorted(f) == ["Header", "Spectra", "column_density", "ray_x", "ray_y"]
        assert sorted(f["Spectra"]) == ["tau", "velocity_kms"]
        assert sorted(f["Header"].attrs) == ["Axis", "BoxSize_cMpc", "Kernel", "Redshift"]
        assert np.array_equal(f["ray_x"][()], rx) and np.array_equal(f["ray_y"][()], ry)
        assert np.array_equal(f["column_density"][()], columns)
        assert np.array_equal(f["Spectra/tau"][()], tau.numpy())
        assert np.array_equal(f["Spectra/velocity_kms"][()], v_centres)
