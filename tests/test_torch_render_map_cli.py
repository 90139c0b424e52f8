"""Port vs JAX: the render CLI (``scripts/render_map.py``) and ``ast_cli``.

Mirrors ``tests/test_cli.py:109-155,232-326``. Both packages'
``render_map.main`` read one synthetic EAGLE snapshot (the JAX package's
fixture writer) and write HDF5 maps; the port runs with ``--device cpu``
(its CUDA engines use their plain kernel versions there). Datasets must
agree within 2e-5 * max (the whole-engine f32 bound; ``mean_*`` where the
surface density exceeds 1e-3 of its maximum) and the header attributes
exactly. Every port engine is held to the JAX ``xla`` engine at the same
``--projection``: the JAX CLI passes ``--projection`` to that engine only
(its ``pallas`` and ``coherent`` engines render ``kernel3d`` whatever the
flag says, a fault the port does not copy).
"""

import os

import h5py
import numpy as np
import pytest

from astro_sph_tools_tpu.io.synthetic import (
    SyntheticSnapshotSpec,
    write_snapshot,
    write_swift_snapshot,
    write_tng_snapshot,
)
from astro_sph_tools_tpu.scripts.render_map import main as j_main
from astro_sph_tools_tpu_torch.io.eagle import SnapshotEAGLE
from astro_sph_tools_tpu_torch.scripts import render_map
from astro_sph_tools_tpu_torch.scripts.ast_cli import main as t_ast
from astro_sph_tools_tpu_torch.scripts.render_map import main as t_main

TOL = 2e-5
HEADER = ("Redshift", "BoxSize_cMpc", "Extent_cMpc", "Axis", "Kernel", "ParticleType")


@pytest.fixture(scope="module")
def snap_path(tmp_path_factory):
    spec = SyntheticSnapshotSpec(n_gas=1024, n_dm=256, n_star=64, n_bh=2, n_files=2, n_groups=6, clustered=True)
    path, _ = write_snapshot(str(tmp_path_factory.mktemp("torch_render_cli_sim")), spec)
    return path


def read(path):
    with h5py.File(path, "r") as f:
        maps = {k: np.asarray(f[k]) for k in f.keys() if k != "Header"}
        header = {k: f["Header"].attrs[k] for k in f["Header"].attrs}
    return maps, header


def assert_outputs_match(got_path, ref_path, tol=TOL):
    got, got_hdr = read(got_path)
    ref, ref_hdr = read(ref_path)
    assert set(got) == set(ref)
    for key in HEADER:
        assert np.array_equal(np.asarray(got_hdr[key]), np.asarray(ref_hdr[key])), key
    denom = ref["mass"] if "mass" in ref else ref["surface_density"]
    covered = denom > 1e-3 * denom.max()
    for name, r in ref.items():
        g = got[name]
        assert g.shape == r.shape and np.isfinite(g).all()
        if name.startswith("mean_"):
            g, r = g[covered], r[covered]
        assert np.abs(g - r).max() <= tol * np.abs(r).max(), name


def run_both(tmp_path, args, engine, projection="integrated", tag=""):
    ref = str(tmp_path / f"jax{tag}.hdf5")
    got = str(tmp_path / f"port{tag}.hdf5")
    assert j_main(args + ["--output", ref, "--engine", "xla", "--projection", projection]) == 0
    assert t_main(args + ["--output", got, "--engine", engine, "--projection", projection,
                          "--device", "cpu"]) == 0
    return got, ref


@pytest.mark.parametrize("engine", ["xla", "pallas", "coherent"])
@pytest.mark.parametrize("region", [None, "2,8,2.5,7.5"])
def test_render_matches_jax(snap_path, tmp_path, engine, region):
    args = ["--snapshot", snap_path, "--format", "eagle", "--resolution", "48",
            "--fields", "density,temperature,metallicity"]
    if region:
        args += ["--region", region]
    got, ref = run_both(tmp_path, args, engine)
    assert_outputs_match(got, ref)
    maps, hdr = read(got)
    assert maps["surface_density"].sum() > 0 and "mean_temperature" in maps
    assert tuple(hdr["Extent_cMpc"]) == ((2.0, 8.0, 2.5, 7.5) if region else (0.0, 10.0, 0.0, 10.0))


def test_kernel3d_projection_and_axis(snap_path, tmp_path):
    args = ["--snapshot", snap_path, "--resolution", "32", "--fields", "mass,temperature", "--axis", "x"]
    got, ref = run_both(tmp_path, args, "pallas", projection="kernel3d")
    assert_outputs_match(got, ref)
    assert "mass" in read(got)[0] and "mean_temperature" in read(got)[0]


def test_jax_cli_ignores_projection_on_its_pallas_engine(snap_path, tmp_path):
    """The fault not copied: the JAX CLI's pallas engine renders kernel3d
    under --projection integrated; the port's renders what was asked."""
    base = ["--snapshot", snap_path, "--resolution", "16"]
    paths = {k: str(tmp_path / f"{k}.hdf5") for k in ("jp", "jx3", "tp", "tx")}
    assert j_main(base + ["-o", paths["jp"], "--engine", "pallas", "--projection", "integrated"]) == 0
    assert j_main(base + ["-o", paths["jx3"], "--engine", "xla", "--projection", "kernel3d"]) == 0
    assert t_main(base + ["-o", paths["tp"], "--engine", "pallas", "--projection", "integrated", "--device", "cpu"]) == 0
    assert j_main(base + ["-o", paths["tx"], "--engine", "xla", "--projection", "integrated"]) == 0
    assert_outputs_match(paths["jp"], paths["jx3"])
    assert_outputs_match(paths["tp"], paths["tx"])
    sd = lambda k: read(paths[k])[0]["surface_density"]  # noqa: E731
    assert np.abs(sd("tp") - sd("jp")).max() > 1e-2 * sd("jp").max()


def test_region_pad_grows_to_the_largest_h(snap_path, tmp_path, monkeypatch):
    """Without --region-pad the loading region starts at 5% of the region
    side and grows to 1.05 x the largest loaded h (re-reading), on the map
    plane's axes only; the port restricts exactly as the JAX CLI does."""
    import astro_sph_tools_tpu.io.eagle as jeagle

    calls = {"port": [], "jax": []}

    def spy(cls, key):
        real = cls.restrict_data_comoving_loading_region

        def restrict(self, *bounds):
            calls[key].append(bounds)
            return real(self, *bounds)

        monkeypatch.setattr(cls, "restrict_data_comoving_loading_region", restrict)

    spy(SnapshotEAGLE, "port")
    spy(jeagle.SnapshotEAGLE, "jax")
    args = ["--snapshot", snap_path, "--resolution", "32", "--axis", "y", "--region", "4,6,3,5"]
    got, ref = run_both(tmp_path, args, "pallas")
    assert calls["port"] == calls["jax"] and len(calls["port"]) >= 2
    first, last = calls["port"][0], calls["port"][-1]
    # axis y: the plane is (x, z) = (0, 2): the region's x-range on axis 0,
    # its y-range on axis 2, axis 1 the whole box
    assert first == pytest.approx((3.9, 6.1, 0.0, 10.0, 2.9, 5.1))
    pad = last[1] - 6
    assert pad > 0.1 and last == pytest.approx((4 - pad, 6 + pad, 0.0, 10.0, 3 - pad, 5 + pad))
    # the grown pad covers every smoothing length loaded in its region
    snap = SnapshotEAGLE(snap_path)
    snap.restrict_data_comoving_loading_region(*last)
    assert snap.get_smoothing_lengths(render_map.ParticleType.gas).to_value("Mpc").max() <= pad
    assert_outputs_match(got, ref)


def test_explicit_region_pad_does_not_grow(snap_path, tmp_path, monkeypatch):
    calls = []
    real = SnapshotEAGLE.restrict_data_comoving_loading_region
    monkeypatch.setattr(SnapshotEAGLE, "restrict_data_comoving_loading_region",
                        lambda self, *b: (calls.append(b), real(self, *b))[1])
    out = str(tmp_path / "m.hdf5")
    assert t_main(["--snapshot", snap_path, "-o", out, "--resolution", "16", "--axis", "y",
                   "--region", "2,6,3,7", "--region-pad", "0.5", "--engine", "xla", "--device", "cpu"]) == 0
    assert calls == [(1.5, 6.5, 0.0, 10.0, 2.5, 7.5)]


def test_png_preview(snap_path, tmp_path):
    out, png = str(tmp_path / "r.hdf5"), str(tmp_path / "r.png")
    assert t_main(["--snapshot", snap_path, "-o", out, "--png", png, "--resolution", "32",
                   "--region", "2,8,2,8", "--engine", "xla", "--device", "cpu"]) == 0
    assert os.path.getsize(png) > 0
    no_png = str(tmp_path / "n.hdf5")
    assert t_main(["--snapshot", snap_path, "-o", no_png, "--resolution", "16", "--engine", "xla",
                   "--device", "cpu"]) == 0
    assert sorted(os.listdir(tmp_path)) == ["n.hdf5", "r.hdf5", "r.png"]


@pytest.mark.parametrize("fmt", ["swift", "tng"])
def test_swift_and_tng_snapshots(tmp_path, fmt):
    spec = SyntheticSnapshotSpec(n_gas=1024, n_dm=64, n_star=16, n_bh=2, clustered=True, n_groups=3)
    if fmt == "swift":
        path, _ = write_swift_snapshot(str(tmp_path), spec)
    else:
        path, *_ = write_tng_snapshot(str(tmp_path), spec)
    args = ["--snapshot", path, "--format", fmt, "--resolution", "32", "--fields", "density,temperature"]
    got, ref = run_both(tmp_path, args, "pallas")
    assert_outputs_match(got, ref)


def test_errors(snap_path, tmp_path):
    base = ["--snapshot", snap_path, "-o", str(tmp_path / "x.hdf5"), "--resolution", "16", "--device", "cpu"]
    with pytest.raises(SystemExit):
        t_main(base + ["--fields", "entropy", "--engine", "xla"])
    with pytest.raises(SystemExit):
        t_main(base + ["--engine", "bogus"])
    with pytest.raises(SystemExit):
        t_main(base + ["--region", "1,2,3"])
    with pytest.raises(SystemExit):
        t_main(base + ["--format", "gadget"])


def test_ast_cli(capsys):
    assert t_ast([]) == 0
    out = capsys.readouterr().out
    assert "astro-sph-tools-tpu" in out and "render_map" in out and "CUDA device(s)" in out


# ---------------------------------------------------------------------------
# utils/console.py, which the readers and the CLI print through
# ---------------------------------------------------------------------------

CONSOLE_CALLS = ("print_info", "print_verbose_info", "print_debug", "print_warning", "print_verbose_warning",
                 "print_error")


@pytest.mark.parametrize("verbose,debug", [(False, False), (True, False), (False, True)])
def test_console_matches_jax(capsys, verbose, debug):
    import astro_sph_tools_tpu.utils.console as jcon
    from astro_sph_tools_tpu_torch.utils import console as tcon

    outs = []
    for con in (jcon, tcon):
        saved = (con.settings.verbose, con.settings.debug)
        con.settings.verbose, con.settings.debug = verbose, debug
        try:
            for name in CONSOLE_CALLS:
                getattr(con, name)(f"message from {name}")
            watch = con.Stopwatch("io")
            watch.lap("read")
            assert len(watch.laps) == 1 and watch.total() >= watch.laps[0][1]
            assert watch.process_skew() == (watch.laps[0][1], watch.laps[0][1])
        finally:
            con.settings.verbose, con.settings.debug = saved
        captured = capsys.readouterr()
        outs.append((captured.out.replace("ms\n", "\n").split("took")[0], captured.err))
    assert outs[0] == outs[1]
    assert ("INFO: message from print_verbose_info" in outs[1][0]) == (verbose or debug)


def test_console_show_times_and_process_index(capsys):
    import socket

    import torch.distributed as dist

    from astro_sph_tools_tpu_torch.utils import console

    console.show_times(True)
    try:
        console.print_info("stamped")
    finally:
        console.show_times(False)
    assert capsys.readouterr().out.startswith("[")
    assert console._process_index() == 0
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        assert console._process_index() == 0
        watch = console.Stopwatch()
        watch.lap()
        assert watch.process_skew() == (watch.laps[0][1],) * 2
    finally:
        dist.destroy_process_group()
