"""Port vs JAX: Doppler widths, the Voigt-Hjerting function and the spectra engines.

The same seeded NumPy inputs go through the JAX package's spectra engines
(``ops/spectra.py``, XLA on the CPU) and the port's; the fused engine runs
its plain kernel version on the CPU. Tolerances: 1e-5 of the maximum for
the f32 comparisons of one formulation (dense, binned), twice that for the
fused engine (Clenshaw column weights, the level/cell schedule) against
the JAX dense engine. ``voigt_hjerting`` is held to ``scipy.special.wofz``
in f64.

The fused engine sums 7 velocity images for ``profile="voigt"``, as the
dense engine does; the JAX fused engine sized them by the Gaussian rule and
runs low in the damping wings near the antipode (ROADMAP.md §3). The wing
test below holds the port to the JAX dense engine there, bin by bin.
"""

import os
import sys

import numpy as np
import pytest
import torch

from astro_sph_tools_tpu.data_structures.cosmology import Cosmology as JCosmology
from astro_sph_tools_tpu.ops.spectra import (
    absorption_spectra as j_absorption_spectra,
    absorption_spectra_binned as j_absorption_spectra_binned,
    doppler_parameter_kms as j_doppler,
    voigt_hjerting as j_voigt_hjerting,
)
from astro_sph_tools_tpu_torch.data_structures import Cosmology
from astro_sph_tools_tpu_torch.ops import (
    absorption_spectra,
    absorption_spectra_binned,
    absorption_spectra_pallas,
    doppler_parameter_kms,
    voigt_damping_kms,
    voigt_hjerting,
)
import astro_sph_tools_tpu_torch.ops.spectra_fused as SPF

# chip_smoke.py (the repository root) holds the awkward-line generator
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TOL = 1e-5
FUSED_TOL = 2e-5
GAMMA_LYA = 6.265e8
_COSMO = dict(hubble_param=0.6777, omega_baryon=0.04825, expansion_factor=0.5, redshift=1.0)


def _data(n=8000, rays=100, box=10.0, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, box, (n, 3))
    h = np.exp(rng.normal(np.log(0.1), 0.6, n)).clip(0.02, 1.0)
    vals = rng.uniform(0.5, 2.0, n).astype(np.float32)
    vpec = rng.normal(0, 80, n).astype(np.float32)
    T = 10 ** rng.uniform(3.8, 6.5, n)
    rx = rng.uniform(0, box, rays)
    ry = rng.uniform(0, box, rays)
    return pos, h, vals, vpec, T, rx, ry, box


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _kw(cosmo: bool, periodic: bool, box: float, profile: str, n_bins: int = 256):
    """Matching keyword sets for the JAX and the port engines."""
    extra = dict(n_bins=n_bins, box_size=box, periodic=periodic, profile=profile,
                 gamma=GAMMA_LYA if profile == "voigt" else None)
    return (dict(extra, cosmology=JCosmology(**_COSMO) if cosmo else None),
            dict(extra, cosmology=Cosmology(**_COSMO) if cosmo else None, device="cpu"))


@pytest.fixture(scope="module")
def data():
    return _data()


class TestDopplerAndVoigt:
    def test_doppler_matches_jax(self):
        T = 10.0 ** np.linspace(3, 7, 41)
        for aw in (1.008, 4.0026, 15.999):
            np.testing.assert_array_equal(doppler_parameter_kms(T, aw), j_doppler(T, aw))
            got = doppler_parameter_kms(torch.as_tensor(T), aw)
            assert isinstance(got, torch.Tensor)
            np.testing.assert_allclose(got.numpy(), j_doppler(T, aw), rtol=1e-15)
        assert doppler_parameter_kms(1.0e4, 1.008) == pytest.approx(12.85, rel=0.01)

    def test_damping_constant(self):
        # H I Lya: a = Gamma lambda0 / (4 pi b) with b in cm/s
        assert voigt_damping_kms(GAMMA_LYA, 1215.67) == pytest.approx(
            GAMMA_LYA * 1215.67e-8 / (4 * np.pi) / 1e5, rel=1e-15)

    def test_hjerting_matches_faddeeva(self):
        """voigt_hjerting vs Re[wofz] in f64: <= 1e-5 relative over the
        astrophysical damping-parameter range, on NumPy and torch f64 input."""
        from scipy.special import wofz

        x = np.concatenate([np.linspace(0, 7, 2001), np.geomspace(7, 300, 800)])
        for a in (1e-6, 1e-5, 1e-4, 1e-3, 3e-3):
            exact = wofz(x + 1j * a).real
            for got in (voigt_hjerting(a, x), voigt_hjerting(a, torch.as_tensor(x)).numpy()):
                assert (np.abs(got - exact) / np.abs(exact)).max() < 1e-5, a
            np.testing.assert_allclose(voigt_hjerting(a, x), j_voigt_hjerting(a, x), rtol=1e-12)

    def test_hjerting_f32(self):
        """The f32 torch path (what the engines run) stays within 1e-5 of the
        f64 evaluation."""
        x = np.linspace(0.0, 40.0, 20001)
        r64 = voigt_hjerting(1e-3, x)
        r32 = voigt_hjerting(torch.tensor(1e-3), torch.as_tensor(x, dtype=torch.float32))
        assert r32.dtype == torch.float32
        rel = np.abs(r32.numpy().astype(np.float64) - r64) / np.maximum(np.abs(r64), 1e-12)
        assert rel.max() < 1e-5


# (cosmology, periodic, profile): with and without a Hubble flow
CASES = [(True, True, "gaussian"), (True, False, "gaussian"), (True, True, "voigt"), (False, False, "gaussian")]


@pytest.mark.parametrize("cosmo,periodic,profile", CASES)
def test_dense_matches_jax(data, cosmo, periodic, profile):
    pos, h, vals, vpec, T, rx, ry, box = data
    jkw, tkw = _kw(cosmo, periodic, box, profile)
    ref, vc = j_absorption_spectra(pos, h, vals, vpec, T, rx, ry, **jkw)
    got, vc2 = absorption_spectra(pos, h, vals, vpec, T, rx, ry, **tkw)
    np.testing.assert_array_equal(vc, vc2)
    assert tuple(got.shape) == (100, 256)
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("cosmo,periodic,profile", CASES)
def test_binned_matches_jax(data, cosmo, periodic, profile):
    pos, h, vals, vpec, T, rx, ry, box = data
    jkw, tkw = _kw(cosmo, periodic, box, profile)
    ref, vc = j_absorption_spectra_binned(pos, h, vals, vpec, T, rx, ry, **jkw)
    got, vc2 = absorption_spectra_binned(pos, h, vals, vpec, T, rx, ry, **tkw)
    np.testing.assert_array_equal(vc, vc2)
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("cosmo,periodic,profile", CASES)
def test_fused_matches_jax_dense(data, cosmo, periodic, profile):
    pos, h, vals, vpec, T, rx, ry, box = data
    jkw, tkw = _kw(cosmo, periodic, box, profile, n_bins=512 if periodic else 256)
    ref, vc = j_absorption_spectra(pos, h, vals, vpec, T, rx, ry, **jkw)
    got, vc2 = absorption_spectra_pallas(pos, h, vals, vpec, T, rx, ry, **tkw)
    np.testing.assert_array_equal(vc, vc2)
    assert _rel(got, ref) <= FUSED_TOL


def test_voigt_wings_near_antipode_match_dense():
    """A lone saturated absorber: near v_line + v_box/2 the Voigt wing tau is
    a sum over the periodic images on both sides, and the fused engine must
    match the JAX dense engine there bin by bin (relative error of each
    wing bin, not error normalised by the line centre)."""
    box = 25.0
    pos = np.array([[12.5, 12.5, 5.0]])
    h = np.array([0.4])
    vals = np.array([1.0e6], np.float32)
    v_pec = np.array([0.0], np.float32)
    T = np.array([1.0e4])  # b ~ 12.8 km/s: the Gaussian rule would sum no image
    rx = ry = np.array([12.45])
    jkw, tkw = _kw(True, True, box, "voigt", n_bins=512)
    ref, vc = j_absorption_spectra(pos, h, vals, v_pec, T, rx, ry, **jkw)
    got, _ = absorption_spectra_pallas(pos, h, vals, v_pec, T, rx, ry, **tkw)
    ref, got = np.asarray(ref, np.float64)[0], got.numpy().astype(np.float64)[0]
    c = JCosmology(**_COSMO)
    v_box = box * c.hubble_rate() * c.a
    v_line = 5.0 * c.hubble_rate() * c.a
    d = np.abs((vc - v_line + 0.5 * v_box) % v_box - 0.5 * v_box)  # distance to the line, wrapped
    wing = d > 0.45 * v_box
    assert wing.sum() >= 20 and (ref[wing] > 0).all()
    assert (np.abs(got[wing] - ref[wing]) / ref[wing]).max() <= 1e-4
    # summing only the principal image would leave the antipode ~half low
    assert SPF.n_velocity_images("gaussian", 12.9, v_box) == 0
    assert SPF.n_velocity_images("voigt", 12.9, v_box) == 3


def test_velocity_integral_conserves_column():
    """The velocity integral of each fused spectrum equals the ray's column."""
    from astro_sph_tools_tpu_torch.ops import column_integrate

    pos, h, vals, vpec, T, rx, ry, box = _data(n=4000, rays=20)
    _, tkw = _kw(True, True, box, "gaussian", n_bins=1024)
    tau, vc = absorption_spectra_pallas(pos, h, vals, vpec, T, rx, ry, **tkw)
    cols = column_integrate(pos[:, 0], pos[:, 1], h, vals, rx, ry, periodic_box=box, device="cpu")
    np.testing.assert_allclose(tau.sum(dim=1).numpy() * (vc[1] - vc[0]), cols.numpy(), rtol=2e-3)


def test_zero_rays_and_bad_arguments():
    pos, h, vals, vpec, T, _, _, box = _data(n=1000, rays=5)
    empty = np.array([], np.float64)
    tau, vc = absorption_spectra_pallas(pos, h, vals, vpec, T, empty, empty, box_size=box, n_bins=128,
                                        device="cpu")
    assert tuple(tau.shape) == (0, 128) and vc.shape == (128,)
    with pytest.raises(ValueError, match="multiple of 128"):
        absorption_spectra_pallas(pos, h, vals, vpec, T, empty, empty, box_size=box, n_bins=300, device="cpu")
    with pytest.raises(ValueError, match="damping rate"):
        absorption_spectra_pallas(pos, h, vals, vpec, T, empty, empty, box_size=box, profile="voigt",
                                  device="cpu")
    with pytest.raises(ValueError, match="need box_size"):
        absorption_spectra(pos, h, vals, vpec, T, empty, empty, device="cpu")


def test_ray_batching_matches_single_pass(monkeypatch):
    pos, h, vals, vpec, T, rx, ry, box = _data(n=4000, rays=70)
    _, tkw = _kw(True, True, box, "gaussian", n_bins=128)
    whole, _ = absorption_spectra_pallas(pos, h, vals, vpec, T, rx, ry, **tkw)
    monkeypatch.setattr(SPF, "_RAY_BATCH", 32)
    batched, _ = absorption_spectra_pallas(pos, h, vals, vpec, T, rx, ry, **tkw)
    np.testing.assert_allclose(batched.numpy(), whole.numpy(), rtol=0, atol=1e-6 * float(whole.abs().max()))


def test_wrapper_runs_plain_on_cpu():
    pos, h, vals, vpec, T, rx, ry, box = _data(n=3000, rays=40)
    lay, vc, v_box, n_img = SPF._spectra_layout(
        pos, h, vals, vpec, T, rx, ry, cosmology=Cosmology(**_COSMO), box_size=box, atomic_weight=1.008,
        n_bins=128, kernel="cubic_spline", periodic=True, profile="gaussian", device="cpu",
    )
    kw = dict(kernel="cubic_spline", periodic=True, Lx=lay.Lx, Ly=lay.Ly, v_box=v_box, n_images=n_img,
              profile="gaussian", voigt_k=0.0)
    args = (lay.packed, lay.rx, lay.ry, lay.lo, lay.hi, torch.as_tensor(vc))
    before = SPF.spectra_tiles.launches
    got = SPF.spectra_tiles(*args, **kw)
    assert SPF.spectra_tiles.launches == before
    assert torch.equal(got, SPF.spectra_tiles_plain(*args, **kw))
    assert tuple(got.shape) == (lay.n_blocks, 32, 128)
    with pytest.raises(ValueError, match="line profile"):
        SPF.spectra_tiles(*args, **{**kw, "profile": "lorentz"})


# ---------------------------------------------------------------------------
# The kernel's line windows (ops/spectra_fused.py::line_windows, mirrored by
# csrc/sightlines.cu::line_window) and a torch emulation of its sum
# ---------------------------------------------------------------------------


def _window_lines(v_lo, v_hi, dvb, v_box):
    """Line centres at and beside the velocity edges and inside, times
    Doppler widths from a tenth of a bin to beyond the box."""
    eps = 1e-3 * dvb
    vs = [v_lo, 0.5 * (v_lo + v_hi), v_hi - eps, v_lo - dvb / 3, v_hi + dvb / 3, v_lo + 0.37 * dvb,
          v_lo + 0.5 * dvb, v_hi - 2.5 * dvb, v_lo - 0.6 * v_box, v_hi + 1.3 * v_box]
    bs = [0.1 * dvb, 0.35 * dvb, dvb, 2.5 * dvb, 11.0 * dvb, 0.45 * v_box / 10.2, 0.52 * v_box / 10.2,
          0.3 * v_box, 0.6 * v_box, 1.3 * v_box]
    v, b = np.meshgrid(np.array(vs), np.array(bs), indexing="ij")
    return torch.as_tensor(v.ravel(), dtype=torch.float32), torch.as_tensor(b.ravel(), dtype=torch.float32)


@pytest.mark.parametrize("n_bins", [128, 384])
@pytest.mark.parametrize("n_images", [0, 1, 2, 3])
@pytest.mark.parametrize("periodic", [True, False])
def test_line_windows_hold_every_nonzero_gaussian_term(periodic, n_images, n_bins):
    """Brute force: every (line, bin, image) Gaussian term that is not 0 in
    f32, with the plain version's arithmetic, lies in the line's window and
    image range; narrow windows stay within 2 * 10.2 b plus 4 bins; and the
    kernel's once-a-line wrap gives the plain version's wrapped offsets."""
    v_box = 1000.0
    lo, hi = (0.0, v_box) if periodic else (-300.0, 1300.0)
    edges = np.linspace(lo, hi, n_bins + 1)
    vc = torch.as_tensor((0.5 * (edges[:-1] + edges[1:])).astype(np.float32))
    dvb = (hi - lo) / n_bins
    v, b = _window_lines(lo, hi, dvb, v_box)
    wrap = v_box if periodic else None
    win = SPF.line_windows(v, b, vc, v_box=wrap, n_images=n_images, profile="gaussian")
    j = torch.arange(n_bins)
    in_win = torch.remainder(j[None, :] - win.first[:, None], n_bins) < win.length[:, None]
    assert bool(((win.length >= 0) & (win.length <= n_bins)).all())
    assert bool(((win.first >= 0) & ((win.first < n_bins) | (win.length == 0))).all())

    dv = vc[None, :] - v[:, None]
    if periodic:
        dv = dv - torch.round(dv / v_box) * v_box
    ib = 1.0 / b
    n_live = 0
    for k in range(-n_images, n_images + 1) if periodic else [0]:
        z = (dv + k * v_box) * ib[:, None]
        live = torch.exp(-(z * z)) > 0
        n_live += int(live.sum())
        assert not bool((live & ~in_win).any()), f"image {k}: a non-zero term outside its window"
        assert not bool((live & (abs(k) > win.images)[:, None]).any()), f"image {k} outside the image range"
    assert n_live > 0
    narrow = win.length < n_bins
    assert bool((win.length[narrow] <= 2.0 * 10.2 * b[narrow] / dvb + 4.0).all())
    assert bool((win.images <= (n_images if periodic else 0)).all())
    if periodic:
        # the wrap, taken once a line, against the plain version's per bin
        dvk = (vc[None, :] - v[:, None]) - torch.where(
            j[None, :] >= win.wrap_bin[:, None], win.shift_hi[:, None], win.shift_lo[:, None])
        assert bool((dvk.abs() <= 0.5 * v_box + 1e-3 * dvb).all())
        away = dv.abs() < 0.5 * v_box - 1e-3 * dvb
        assert torch.equal(dvk[away], dv[away])


def test_bin_grid_refuses_what_the_kernel_cannot_window():
    vc = torch.linspace(0.5, 127.5, 128)
    assert SPF.bin_grid(vc, 128.0) == (0.5, pytest.approx(1.0))
    with pytest.raises(ValueError, match="uniformly spaced"):
        SPF.bin_grid(vc ** 1.01, None)
    with pytest.raises(ValueError, match="tile one v_box"):
        SPF.bin_grid(vc, 200.0)
    with pytest.raises(ValueError, match="at least 2"):
        SPF.bin_grid(vc[:1], None)


def test_kernel_runs_the_ray_blocks_heaviest_first():
    """``heaviest_first``: the ray-block order the CUDA kernel's thread blocks
    take, a permutation of the blocks by particles scanned, most first, ties
    (and the empty spans, lo >= hi) in block order."""
    rng = np.random.default_rng(5)
    n_blocks = 300
    lo = torch.as_tensor(rng.integers(0, 1000, (n_blocks, 10)), dtype=torch.int32)
    hi = lo + torch.as_tensor(rng.integers(-5, 40, (n_blocks, 10)), dtype=torch.int32)
    hi[::7] = lo[::7]  # blocks that scan nothing
    order = SPF.heaviest_first(lo, hi)
    assert order.dtype == torch.int32
    assert torch.equal(torch.sort(order.long()).values, torch.arange(n_blocks))
    scanned = (hi - lo).clamp_min(0).sum(dim=1)[order.long()]
    assert bool((scanned[:-1] >= scanned[1:]).all())
    ties = scanned[:-1] == scanned[1:]
    assert bool((order[:-1][ties] < order[1:][ties]).all())
    assert int(scanned[-1]) == 0 and int(order[-1]) == n_blocks - 1 - (n_blocks - 1) % 7


def _spectra_emulated(packed, rx, ry, lo, hi, v_centres, *, kernel, periodic, Lx, Ly, v_box, n_images,
                      profile, voigt_k):
    """Torch emulation of ``csrc/sightlines.cu::spectra_kernel``'s sum: for
    each (ray block, live particle) pair, the line profile only at the bins
    of the particle's window and its images (``line_windows``), with the
    kernel's once-a-line velocity wrap, added only into the rays that hit
    the particle. Returns (tau (n_blocks, 32, n_bins), the live pairs, the
    profile terms evaluated)."""
    from astro_sph_tools_tpu_torch.kernels.splines import clenshaw, get_kernel, integrated_kernel_chebyshev
    from astro_sph_tools_tpu_torch.ops.sightlines_fused import _pair_geometry, _span_entries

    S = get_kernel(kernel).support_factor
    n_blocks, B = rx.shape
    n = v_centres.shape[0]
    blk, idx = _span_entries(lo, hi)
    b2, hs, inv_h = _pair_geometry(packed, rx, ry, blk, idx, periodic, Lx, Ly)
    inv_sh = inv_h[:, None] * (1.0 / S)
    tq = b2 * (inv_sh * inv_sh)
    hit = (tq < 1.0) & (hs > 0.0)[:, None]
    live = hit.any(dim=1)
    blk, idx, hit, tq, inv_h = blk[live], idx[live], hit[live], tq[live], inv_h[live]
    cheb = integrated_kernel_chebyshev(kernel)
    w = clenshaw(2.0 * torch.clamp(tq, 0.0, 1.0) - 1.0, cheb) * (inv_h * inv_h * packed[3, idx])[:, None]
    v, bd = packed[4, idx], packed[5, idx]
    win = SPF.line_windows(v, bd, v_centres, v_box=v_box, n_images=n_images, profile=profile)
    j = torch.arange(n)
    in_win = torch.remainder(j[None, :] - win.first[:, None], n) < win.length[:, None]
    dv = (v_centres[None, :] - v[:, None]) - torch.where(
        j[None, :] >= win.wrap_bin[:, None], win.shift_hi[:, None], win.shift_lo[:, None])
    ib = 1.0 / bd
    phi = torch.zeros_like(dv)
    terms = 0
    for k in range(-n_images, n_images + 1) if v_box is not None else [0]:
        use = in_win & (abs(k) <= win.images)[:, None]
        z = (dv + k * (v_box or 0.0)) * ib[:, None]
        term = voigt_hjerting(voigt_k * ib[:, None], z) if profile == "voigt" else torch.exp(-(z * z))
        phi += torch.where(use, term, 0.0)
        terms += int(use.sum())
    phi *= (1.0 / np.sqrt(np.pi)) * ib[:, None]
    e, r = torch.nonzero(hit, as_tuple=True)  # the rays that hit, only
    tau = torch.zeros((n_blocks * B, n), dtype=torch.float32)
    tau.index_add_(0, blk[e] * B + r, w[e, r, None] * phi[e])
    return tau.view(n_blocks, B, n), int(live.sum()), terms


def _awkward():
    """chip_smoke.py's awkward_lines: lines at the velocity edges, Doppler
    widths from a tenth of a bin to 0.6 v_box."""
    import chip_smoke

    return chip_smoke.awkward_lines(Cosmology(**_COSMO), n=1500, n_rays=48)


@pytest.mark.parametrize("profile", ["gaussian", "voigt"])
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("inputs", ["data", "awkward"])
def test_windowed_emulation_matches_plain_and_jax_dense(inputs, periodic, profile):
    """The kernel's windowed, hit-rays-only sum, emulated in torch, against
    ``spectra_tiles_plain`` (1e-5 of max) and, through the unsort, against
    the JAX dense engine (the fused tolerance)."""
    pos, h, vals, vpec, T, rx, ry, box = _data() if inputs == "data" else _awkward()
    n_bins = 512 if periodic else 256
    lay, vc, v_box, n_img = SPF._spectra_layout(
        pos, h, vals, vpec, T, rx, ry, cosmology=Cosmology(**_COSMO), box_size=box, atomic_weight=1.008,
        n_bins=n_bins, kernel="cubic_spline", periodic=periodic, profile=profile, device="cpu",
    )
    kw = dict(kernel="cubic_spline", periodic=lay.periodic, Lx=lay.Lx, Ly=lay.Ly, v_box=v_box, n_images=n_img,
              profile=profile, voigt_k=voigt_damping_kms(GAMMA_LYA, 1215.67) if profile == "voigt" else 0.0)
    args = (lay.packed, lay.rx, lay.ry, lay.lo, lay.hi, torch.as_tensor(vc))
    got, pairs, terms = _spectra_emulated(*args, **kw)
    assert _rel(got, SPF.spectra_tiles_plain(*args, **kw)) <= TOL
    jkw, _ = _kw(True, periodic, box, profile, n_bins=n_bins)
    ref, _ = j_absorption_spectra(pos, h, vals, vpec, T, rx, ry, **jkw)
    assert _rel(SPF.unsort_sum(got, lay), ref) <= FUSED_TOL
    images = 2 * n_img + 1
    if profile == "voigt":
        assert terms == pairs * n_bins * images
    else:  # the windows drop terms (the data's lines are up to ~1/2 box wide)
        assert 0 < terms < 0.9 * pairs * n_bins * images


@pytest.mark.slow
def test_fused_matches_jax_pallas_interpret():
    """The port's fused engine against the JAX fused engine itself
    (interpret-mode Pallas on the CPU; Gaussian, where the two size the
    velocity images alike)."""
    from astro_sph_tools_tpu.ops.spectra_pallas import absorption_spectra_pallas as j_pallas

    pos, h, vals, vpec, T, rx, ry, box = _data(n=4000, rays=40)
    jkw, tkw = _kw(True, True, box, "gaussian", n_bins=256)
    ref, _ = j_pallas(pos, h, vals, vpec, T, rx, ry, **jkw)
    got, _ = absorption_spectra_pallas(pos, h, vals, vpec, T, rx, ry, **tkw)
    assert _rel(got, ref) <= FUSED_TOL


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the spectra kernel runs only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("profile", ["gaussian", "voigt"])
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("inputs", ["data", "awkward"])
def test_cuda_spectra_kernel_matches_plain(cuda_device, inputs, profile, periodic):
    pos, h, vals, vpec, T, rx, ry, box = _data() if inputs == "data" else _awkward()
    lay, vc, v_box, n_img = SPF._spectra_layout(
        pos, h, vals, vpec, T, rx, ry, cosmology=Cosmology(**_COSMO), box_size=box, atomic_weight=1.008,
        n_bins=512, kernel="cubic_spline", periodic=periodic, profile=profile, device=cuda_device,
    )
    kw = dict(kernel="cubic_spline", periodic=lay.periodic, Lx=lay.Lx, Ly=lay.Ly, v_box=v_box, n_images=n_img,
              profile=profile, voigt_k=voigt_damping_kms(GAMMA_LYA, 1215.67) if profile == "voigt" else 0.0)
    args = (lay.packed, lay.rx, lay.ry, lay.lo, lay.hi, torch.as_tensor(vc, device=cuda_device))
    before = SPF.spectra_tiles.launches
    got = SPF.spectra_tiles(*args, **kw)
    ref = SPF.spectra_tiles_plain(*args, **kw)
    torch.cuda.synchronize()
    assert SPF.spectra_tiles.launches == before + 1
    assert _rel(got.cpu(), ref.cpu()) <= TOL
    jkw, tkw = _kw(True, periodic, box, profile, n_bins=512)
    full, _ = absorption_spectra_pallas(pos, h, vals, vpec, T, rx, ry, **{**tkw, "device": cuda_device})
    ref, _ = j_absorption_spectra(pos, h, vals, vpec, T, rx, ry, **jkw)
    assert _rel(full.cpu(), ref) <= FUSED_TOL
