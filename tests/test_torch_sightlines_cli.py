"""Port vs JAX: the sightlines CLI end to end on a synthetic EAGLE snapshot.

The JAX package's fixture generator writes the snapshot; both packages'
``sightlines_cli.main`` read it and write their HDF5 outputs, whose
``column_density`` and ``Spectra/tau`` must agree: within 1e-5 of the
maximum for the same engine on both sides (dense), twice that for the
port's fused engine (its plain kernel versions on the CPU) against the JAX
dense engine.
"""

import h5py
import numpy as np
import pytest

from astro_sph_tools_tpu.io.synthetic import SyntheticSnapshotSpec, write_snapshot
from astro_sph_tools_tpu.scripts.sightlines_cli import main as j_main
from astro_sph_tools_tpu_torch.io.errors import SnapshotFormatError
from astro_sph_tools_tpu_torch.scripts.sightlines_cli import main as t_main

TOL = 1e-5
FUSED_TOL = 2e-5


@pytest.fixture(scope="module")
def snap_path(tmp_path_factory):
    spec = SyntheticSnapshotSpec(n_gas=1024, n_dm=256, n_star=64, n_bh=2, n_files=2, clustered=True)
    path, _ = write_snapshot(str(tmp_path_factory.mktemp("torch_cli_sim")), spec)
    return path


def _read(path):
    with h5py.File(path, "r") as f:
        out = {k: np.asarray(f[k]) for k in ("ray_x", "ray_y", "column_density")}
        if "Spectra" in f:
            out["tau"] = np.asarray(f["Spectra/tau"])
            out["velocity_kms"] = np.asarray(f["Spectra/velocity_kms"])
        out["attrs"] = dict(f["Header"].attrs)
    return out


def _rel(a, b):
    return np.abs(a.astype(np.float64) - b).max() / np.abs(b).max()


def _run_both(snap_path, tmp_path, args, port_extra=(), jax_extra=()):
    common = ["--snapshot", snap_path] + list(args)
    j_out, t_out = str(tmp_path / "jax.hdf5"), str(tmp_path / "port.hdf5")
    assert j_main(common + ["--output", j_out] + list(jax_extra)) == 0
    assert t_main(common + ["--output", t_out, "--device", "cpu"] + list(port_extra)) == 0
    return _read(j_out), _read(t_out)


PROFILES = {"gaussian": [], "voigt": ["--profile", "voigt", "--gamma", "6.265e8"]}


@pytest.mark.parametrize("profile", ["gaussian", "voigt"])
def test_cli_matches_jax(snap_path, tmp_path, profile):
    args = ["--n-rays", "32", "--spectra", "--spectra-bins", "512"] + PROFILES[profile]
    ref, got = _run_both(snap_path, tmp_path, args)
    np.testing.assert_array_equal(got["ray_x"], ref["ray_x"])
    assert got["attrs"] == ref["attrs"]
    assert got["column_density"].shape == (32,) and got["tau"].shape == (32, 512)
    np.testing.assert_array_equal(got["velocity_kms"], ref["velocity_kms"])
    assert _rel(got["column_density"], ref["column_density"]) <= TOL
    assert _rel(got["tau"], ref["tau"]) <= TOL


@pytest.mark.parametrize("profile", ["gaussian", "voigt"])
def test_cli_fused_engine_matches_jax_dense(snap_path, tmp_path, profile):
    args = ["--n-rays", "32", "--spectra", "--spectra-bins", "512"] + PROFILES[profile]
    ref, got = _run_both(snap_path, tmp_path, args, port_extra=["--engine", "pallas"],
                         jax_extra=["--engine", "dense"])
    assert _rel(got["column_density"], ref["column_density"]) <= FUSED_TOL
    assert _rel(got["tau"], ref["tau"]) <= FUSED_TOL


def test_cli_ray_file(snap_path, tmp_path):
    ray_file = tmp_path / "rays.txt"
    ray_file.write_text("2.0 3.0\n7.5 8.0\n0.01 9.99\n")
    args = ["--ray-file", str(ray_file), "--spectra", "--spectra-bins", "256"]
    ref, got = _run_both(snap_path, tmp_path, args)
    assert got["column_density"].shape == (3,)
    np.testing.assert_array_equal(got["ray_y"], ref["ray_y"])
    assert _rel(got["column_density"], ref["column_density"]) <= TOL
    assert _rel(got["tau"], ref["tau"]) <= TOL


def test_cli_prints_phase_times_only_when_verbose(snap_path, tmp_path, capsys, monkeypatch):
    from astro_sph_tools_tpu_torch.utils import settings

    base = ["--snapshot", snap_path, "--output", str(tmp_path / "v.hdf5"), "--device", "cpu", "--n-rays", "4"]
    assert t_main(base) == 0
    quiet = capsys.readouterr().out
    assert "Wrote 4 sightlines" in quiet and "TIMING" not in quiet
    monkeypatch.setattr(settings, "verbose", True)
    assert t_main(base) == 0
    loud = capsys.readouterr().out
    assert "TIMING: read snapshot fields:" in loud and "TIMING: column integration:" in loud


def test_cli_errors(snap_path, tmp_path):
    out = str(tmp_path / "x.hdf5")
    base = ["--snapshot", snap_path, "--output", out, "--device", "cpu", "--n-rays", "4"]
    with pytest.raises(ValueError, match="damping rate"):
        t_main(base + ["--spectra", "--profile", "voigt"])
    with pytest.raises(SystemExit):
        t_main(base + ["--engine", "bogus"])
    # the SWIFT and TNG readers refuse an EAGLE file
    with pytest.raises(KeyError, match="Cosmology"):
        t_main(base + ["--format", "swift"])
    with pytest.raises(SnapshotFormatError, match="TNG naming scheme"):
        t_main(base + ["--format", "tng"])
    bad = tmp_path / "bad.txt"
    bad.write_text("1 2 3\n")
    with pytest.raises(SystemExit):
        t_main(base + ["--ray-file", str(bad)])
