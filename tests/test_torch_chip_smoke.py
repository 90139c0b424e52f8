"""chip_smoke.py's bound for the spectra kernel (#5) counts the work its
function needs: ``spectra_work``'s expected counts over uniform random rays,
held against a brute-force count of this seed's (particle, ray) hits and of
the profile terms, on a small CPU case: the Gaussian terms that are not 0 in
f32, each Voigt term by the branch ``voigt_hjerting`` takes (the Chebyshev
core for |z| <= 7, the series and exp to |z| = 10.16, the series alone
beyond), the terms past the first of each bin, and each bin's own work
once."""

import os
import sys

import numpy as np
import pytest
import torch

from astro_sph_tools_tpu_torch.data_structures import Cosmology
from astro_sph_tools_tpu_torch.ops.spectra import _spectra_inputs
from astro_sph_tools_tpu_torch.ops.spectra_fused import n_velocity_images

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

N, N_RAYS, N_BINS = 20000, 256, 512


def small_sightlines(rng):
    box = cs.SIGHT_BOX
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    return {
        "pos": f32(rng.uniform(0.0, box, (N, 3))),
        "h": f32(np.exp(np.log(0.3) + 0.3 * rng.standard_normal(N))),
        "m": f32(np.ones(N)),
        "v_pec": f32(100.0 * rng.standard_normal(N)),
        "T": f32(10.0 ** np.clip(4.3 + 0.6 * rng.standard_normal(N), 3.5, 7.0)),
        "rx": rng.uniform(0.0, box, N_RAYS),
        "ry": rng.uniform(0.0, box, N_RAYS),
        "cosmology": Cosmology.from_redshift(0.5, 0.6777, 0.04825),
    }


@pytest.mark.parametrize("profile", ["gaussian", "voigt"])
@pytest.mark.parametrize("periodic", [True, False])
def test_spectra_bound_counts_the_needed_work(periodic, profile):
    sl = small_sightlines(np.random.default_rng(31))
    (x, y, h, _, v, b), v_box, vc = _spectra_inputs(
        sl["pos"], sl["h"], sl["m"], sl["v_pec"], sl["T"], cosmology=sl["cosmology"], box_size=cs.SIGHT_BOX,
        atomic_weight=1.008, n_bins=N_BINS, periodic=periodic, device="cpu",
    )
    n_img = n_velocity_images(profile, float(b.max()), v_box) if periodic else 0
    work = cs.spectra_work(torch, sl, N_RAYS, N_BINS, periodic, profile, n_img)

    # hits: rays inside each particle's support (radius 2 h), min-image if periodic
    dx = torch.as_tensor(sl["rx"])[None, :] - x.double()[:, None]
    dy = torch.as_tensor(sl["ry"])[None, :] - y.double()[:, None]
    if periodic:
        dx -= cs.SIGHT_BOX * torch.round(dx / cs.SIGHT_BOX)
        dy -= cs.SIGHT_BOX * torch.round(dy / cs.SIGHT_BOX)
    n_hits = ((dx * dx + dy * dy) < (2.0 * h.double()[:, None]) ** 2).sum(1)
    hit = n_hits > 0
    # profile terms (bin, velocity image): the Gaussian's where it is not 0
    # in f32, the Voigt's each by its branch; then, per bin where the
    # profile is not 0, its terms past the first and the bin's own work
    d = torch.as_tensor(vc)[None, :] - v[hit][:, None]
    if periodic:
        d = d - torch.round(d / v_box) * v_box
    terms = torch.zeros_like(d)
    term_ops = torch.zeros_like(d, dtype=torch.float64)
    for k in range(-n_img, n_img + 1):
        z = (d + k * v_box) / b[hit][:, None]
        if profile == "voigt":
            x = z.abs().double()
            terms += 1.0
            term_ops += torch.where(x <= 7.0, cs.VOIGT_CORE_OPS, torch.where(
                x <= cs.GAUSS_Z_MAX, cs.VOIGT_WING_EXP_OPS, cs.VOIGT_SERIES_OPS))
        else:
            live = (torch.exp(-(z * z)) > 0).float()
            terms += live
            term_ops += live.double() * cs.GAUSS_TERM_OPS
    live_bin = terms > 0
    bin_ops = cs.VOIGT_BIN_OPS if profile == "voigt" else cs.BIN_OPS
    term_ops += (terms - 1.0).clamp_min(0.0).double() * cs.IMAGE_OPS + live_bin.double() * bin_ops
    live_bins = live_bin.sum(1).double()
    brute = term_ops.sum() + (n_hits[hit].double() * (2.0 * live_bins + cs.pair_ops(0, "integrated"))).sum()

    assert work["velocity_images"] == 2 * n_img + 1
    assert abs(work["hits"] / float(n_hits.sum()) - 1.0) < 0.05
    assert abs(work["particles_hit"] / float(hit.sum()) - 1.0) < 0.05
    assert abs(work["ops"] / float(brute) - 1.0) < 0.05
