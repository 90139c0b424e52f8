"""CPU tests of the sightline cell's yardstick, ``reference/los_spectra.py``,
and of its generator, ``generators/clustered3d.py``.

    python -m pytest sphbench/ -q
"""

from __future__ import annotations

import json
import math
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy import integrate, special

from sphbench import compare, faults, harness
from sphbench.generators import clustered3d
from sphbench.reference import los_spectra as L

SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELL = "l0025_sightlines"
#: the cell at a tiny size: 3000 particles of the box's whole gas mass
#: (h ~ 2 cMpc), 200 rays, 128 bins
TINY = {"snapshot": {"n_particles": 3000, "n_rays": 200, "particle_mass_msun": 1.81e6 * 53157376 / 3000},
        "product": {"n_bins": 128}}


def test_dawson_agrees_with_scipy():
    x = np.concatenate([np.linspace(-40.0, 40.0, 40001), np.geomspace(1e-8, 1e5, 400), [0.0, 15.99, 16.0, 16.01]])
    got = L.dawson(torch.tensor(x)).numpy()
    want = special.dawsn(x)
    assert np.all(np.abs(got - want) <= 1e-13 * np.abs(want) + 1e-300)


def test_the_voigt_function_is_its_two_parts_and_matches_the_direct_sum():
    """Where 2 - 4 x F does not cancel (|x| < 8), H from the reference's
    parts equals the definition with scipy's Dawson function; beyond, the
    wing series is -corr's asymptotic form, 1 / x^2 (1 + 3 / (2 x^2) + ...)."""
    a = 3e-4
    x = np.linspace(-8.0, 8.0, 16001)
    want = np.exp(-x * x) * (1 + a * a * (1 - 2 * x * x)) - a / math.sqrt(math.pi) * (2 - 4 * x * special.dawsn(x))
    assert np.abs(L.voigt_hjerting(a, torch.tensor(x)).numpy() - want).max() <= 1e-15
    far = np.geomspace(20.0, 1e4, 200)
    g = L.voigt_hjerting(a, torch.tensor(far)).numpy() / (a / math.sqrt(math.pi))
    assert np.allclose(g, (1 + 1.5 / far**2 + 3.75 / far**4) / far**2, rtol=1e-7)


@pytest.mark.parametrize("beta", [0.0, 1e-7, 1e-3, 0.05, 0.3, 1.0, 1.41, 1.5, 1.99])
def test_the_integrated_kernel_agrees_with_adaptive_quadrature(beta):
    """Y(b, h) at b = beta h against scipy's adaptive quadrature of the
    Wendland C2 kernel along the line, told where its curvature sits (z ~
    b)."""
    h = 0.37
    b = beta * h

    def w(z):
        u = min(math.sqrt(b * b + z * z) / (2 * h), 1.0)
        return 21.0 / (16.0 * math.pi) / h**3 * (1 - u) ** 4 * (1 + 4 * u)

    zmax = math.sqrt(4 * h * h - b * b)
    points = [p for p in (b, 10 * b, 100 * b) if 0 < p < zmax] or None
    want, _ = integrate.quad(w, 0.0, zmax, epsabs=1e-16, epsrel=1e-15, limit=1000, points=points)
    got = float(L.integrated_kernel(torch.tensor([b], dtype=torch.float64), torch.tensor([h], dtype=torch.float64)))
    assert abs(got - 2 * want) <= 1e-12 * 2 * want


def test_the_integrated_kernel_holds_unit_mass():
    b = torch.linspace(0.0, 2.0, 100001, dtype=torch.float64)
    y = L.integrated_kernel(b, torch.ones_like(b))
    assert abs(float(torch.trapezoid(2 * math.pi * b * y, b)) - 1.0) < 1e-9


def _brute_pairs(px, py, s, rx, ry, box, periodic):
    dx = rx[:, None] - px[None, :]
    dy = ry[:, None] - py[None, :]
    if periodic:
        dx -= torch.round(dx / box) * box
        dy -= torch.round(dy / box) * box
    ray, p = torch.nonzero(dx * dx + dy * dy < (s * s)[None, :], as_tuple=True)
    return set(zip(ray.tolist(), p.tolist()))


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("s_range", [(0.05, 0.4), (1.0, 4.5)])  # many cells; fewer than 3 a side
def test_the_candidates_find_every_hit_once(periodic, s_range):
    rng = np.random.default_rng(3)
    box, n, r = 10.0, 2000, 150
    px, py = (torch.tensor(rng.uniform(0, box, n)) for _ in range(2))
    s = torch.tensor(rng.uniform(*s_range, n))
    rx, ry = (torch.tensor(rng.uniform(0, box, r)) for _ in range(2))
    found = []
    for ray, p, b2 in L.hits(px, py, s, rx, ry, box=box, periodic=periodic, block=5000):
        found += list(zip(ray.tolist(), p.tolist()))
    assert len(found) == len(set(found)) and set(found) == _brute_pairs(px, py, s, rx, ry, box, periodic)


def _li(seed: int, n: int, n_rays: int, n_bins: int, profile: str, periodic: bool):
    rng = np.random.default_rng(seed)
    box = 25.0
    inputs = {"positions": torch.tensor(rng.uniform(0, box, (n, 3)), dtype=torch.float32),
              "smoothing_lengths": torch.tensor(rng.uniform(0.05, 0.6, n), dtype=torch.float32),
              "masses": torch.ones(n), "velocities": torch.tensor(rng.normal(0, 100, (n, 3)), dtype=torch.float32),
              "temperatures": torch.tensor(10 ** np.clip(rng.normal(4.3, 0.6, n), 3.5, 7.0), dtype=torch.float32),
              "box": box, "ray_x": rng.uniform(0, box, n_rays), "ray_y": rng.uniform(0, box, n_rays)}
    config = {"kernel": "wendland_c2", "snapshot": {"redshift": 0.5, "hubble_h": 0.6777, "omega_m": 0.307,
                                                    "omega_lambda": 0.693},
              "product": {"axis": "z", "n_bins": n_bins, "profile": profile, "gamma_per_s": 6.265e8,
                          "rest_wavelength_angstrom": 1215.67, "atomic_weight": 1.008, "periodic": periodic}}
    return inputs, config


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("profile", ["gaussian", "voigt"])
def test_work_counts_the_needed_operations(periodic, profile):
    """``work()``'s expected operations against a count over the actual
    hits (rays inside each support), term by term, as
    ``test_spectra_bound_counts_the_needed_work`` counts ``chip_smoke.py``'s:
    within 5 %."""
    n, n_rays, n_bins = 4000, 400, 128
    inputs, config = _li(21, n, n_rays, n_bins, profile, periodic)
    work = L.work(inputs, config, "cpu")
    li = L.los_inputs(inputs, config, "cpu", torch.float32)
    v_box = li["v_box"]
    n_img = 3 if profile == "voigt" else min(3, max(0, math.ceil(6 * float(li["b"].max()) / v_box + 0.5) - 1))
    if not periodic:
        n_img = 0
    pairs = _brute_pairs(li["x"].double(), li["y"].double(), L.SUPPORT * li["h"], li["rx"].double(),
                         li["ry"].double(), li["box"], periodic)
    n_hits = torch.zeros(n, dtype=torch.float64)
    for _, p in pairs:
        n_hits[p] += 1
    hit = n_hits > 0
    d = li["v_centres"][None, :] - li["v"].double()[hit][:, None]
    if periodic:
        d = d - torch.round(d / v_box) * v_box
    b = li["b"][hit][:, None]
    terms = torch.zeros_like(d)
    term_ops = torch.zeros_like(d)
    for k in range(-n_img, n_img + 1):
        x = ((d + k * v_box) / b).abs()
        if profile == "voigt":
            terms += 1.0
            term_ops += torch.where(x <= L.VOIGT_CORE_X, L.VOIGT_CORE_OPS,
                                    torch.where(x <= L.GAUSS_Z_MAX, L.VOIGT_WING_EXP_OPS, L.VOIGT_SERIES_OPS))
        else:
            live = (torch.exp(-(x * x).float()) > 0).double()
            terms += live
            term_ops += live * L.GAUSS_TERM_OPS
    live_bin = terms > 0
    bin_ops = L.VOIGT_BIN_OPS if profile == "voigt" else L.BIN_OPS
    term_ops += (terms - 1.0).clamp_min(0.0) * L.IMAGE_OPS + live_bin * bin_ops
    spectra = term_ops.sum() + (n_hits[hit] * (2.0 * live_bin.sum(1) + L.COLUMN_PAIR_OPS)).sum()
    columns = n_hits.sum() * (L.COLUMN_PAIR_OPS + 2)
    assert abs(work["hits"] / float(n_hits.sum()) - 1.0) < 0.05
    assert abs(work["particles_hit"] / float(hit.sum()) - 1.0) < 0.05
    assert abs(work["spectra"]["ops"] / float(spectra) - 1.0) < 0.05
    assert abs(work["ops"] / float(spectra + columns) - 1.0) < 0.05
    assert work["seconds"] >= work["spectra"]["seconds"] > 0


def test_the_generator_draws_the_same_particles_and_rays_for_a_seed():
    snap = dict(harness.load_json(harness.ROOT / "sphbench" / "configs" / "eagle_l0025_sightlines.json")["snapshot"],
                n_particles=5000, n_rays=64)
    a, b = clustered3d.generate(snap, 2**31 + 7, "cpu"), clustered3d.generate(snap, 2**31 + 7, "cpu")
    other = clustered3d.generate(snap, 8, "cpu")
    for k in ("positions", "smoothing_lengths", "masses", "velocities", "temperatures", "ray_x", "ray_y"):
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
        assert not np.array_equal(np.asarray(a[k]), np.asarray(other[k])), k
    box = snap["box_cmpc"]
    assert float(a["positions"].min()) >= 0.0 and float(a["positions"].max()) < box
    assert a["ray_x"].shape == (64,) and 0.0 <= a["ray_x"].min() and a["ray_y"].max() < box
    lo, hi = snap["h_clip_cmpc"]
    assert lo <= float(a["smoothing_lengths"].min()) and float(a["smoothing_lengths"].max()) <= hi
    t = a["temperatures"].double()
    assert 10**3.5 * (1 - 1e-6) <= float(t.min()) and float(t.max()) <= 10**7 * (1 + 1e-6)
    # the snapshot order is the field's 3D Morton curve
    grid = 1 << clustered3d._BITS
    ijk = torch.clamp((a["positions"] / (box / grid)).long(), 0, grid - 1)
    rank = torch.as_tensor(clustered3d._morton_order_3d(clustered3d._BITS))[(ijk[:, 0] * grid + ijk[:, 1]) * grid
                                                                           + ijk[:, 2]]
    assert bool((rank[1:] >= rank[:-1]).all())


def test_the_reference_and_the_generator_import_nothing_of_the_program():
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(harness.ROOT)!r})\n"
        "import sphbench.reference.los_spectra, sphbench.generators.clustered3d\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'astro_sph_tools_tpu', 'astro_sph_tools_tpu_torch'})))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_a_tiny_run_is_correct_and_the_control_and_every_fault_fail(tmp_path):
    """The cell at a tiny size under limits that the program passes: the
    control and each fault read above them."""
    root = tmp_path / "bench"
    import shutil

    for d in ("configs", "workloads", "entries", "metrics", "reference", "generators", "limits"):
        shutil.copytree(harness.HERE / d, root / d)
    (root / "limits" / f"{CELL}.json").write_text(json.dumps(
        {"limits": {"map_max_rel": 1e-4, "map_l1_rel": 3e-5, "block_l1_rel": 1e-4}}))
    run = lambda product=None: harness.run(SPEC, CELL, 2**31 + 7, 0.2, product is None, t0=0.0, device="cpu",
                                           overrides=TINY, root=root, product=product)
    r = run()
    assert r["correct"], r["checks"]
    assert {"render_io_ms", "los_layout_ms"} - set(r["metrics"]) == {"los_layout_ms"}  # no device time here
    for name, product in [("control", faults.control)] + list(faults.FAULTS.items()):
        assert not run(product)["correct"], name


@pytest.mark.parametrize("how", ["gaussian", "wing_cut"])
def test_the_cells_limits_refuse_spectra_without_damping_wings(monkeypatch, how):
    """At a tiny size, the f64 reference's spectra that lose the damping
    wings (a Gaussian line, or the Voigt's wing series beyond |x| = 7 set to
    0) read above the cell's own limits, by ``map_l1_rel`` at least, as the
    program with either change read on the card (``limits/<cell>.json``)."""
    config = harness.load_json(harness.ROOT / "sphbench" / "configs" / "eagle_l0025_sightlines.json")
    for group, values in TINY.items():
        config[group] = {**config[group], **values}
    inputs = clustered3d.generate(config["snapshot"], 2**31 + 7, "cpu")
    sound = L.maps(inputs, config, "cpu")
    if how == "gaussian":
        config = dict(config, product=dict(config["product"], profile="gaussian"))
    else:
        parts = L._voigt_parts

        def cut(a, x):
            g, near, e = parts(a, x)
            return torch.where(torch.abs(x) > 7.0, torch.zeros_like(g), g), near, e

        monkeypatch.setattr(L, "_voigt_parts", cut)
    limits = harness.load_json(harness.HERE / "limits" / f"{CELL}.json")["limits"]
    values = compare.numbers(L.maps(inputs, config, "cpu"), sound)
    assert values["map_l1_rel"] > limits["map_l1_rel"], values
    assert not compare.judge(values, limits)[0]
