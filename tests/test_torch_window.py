"""Port vs JAX: the coherent engine's window mode (kernel #2's window
branch).

The JAX package's four window regimes (``tests/test_deposit_coherent.py``,
``TestWindowSchedule``: multilevel, all sub-pixel, random order with heavy
rows, non-periodic with particles off the extent) at W in {128, 256, 512,
1024}. Inputs are NumPy arrays made from a seed, in an 8-unit box whose
pixel sizes are powers of two: dividing by them and multiplying by their
reciprocals agree bit for bit, so both packages give every particle the same
key and the window geometry can be compared exactly. The port runs the
window kernel's plain version, which its wrapper takes for a CPU tensor; the
JAX package runs its Pallas kernel in interpret mode. Bounds:

- window map vs whole-row map: 1e-6 * max (the JAX package's own bound:
  the same particles, another summation order);
- window map vs JAX's window map and vs ``tests/oracles.py::project_oracle``
  (f64): 1e-5 * max;
- the window step count and each candidate's (wb0, nw, k4n), keyed by
  (tile, row) (JAX sorts candidates unstably): equal.

The CUDA case needs a card and skips here.
"""

import importlib

import numpy as np
import pytest
import torch

from astro_sph_tools_tpu_torch.ops import MapSpec, deposit_2d_coherent, tile_particles_coherent
from oracles import project_oracle

JC = importlib.import_module("astro_sph_tools_tpu.ops.deposit_coherent")
TC = importlib.import_module("astro_sph_tools_tpu_torch.ops.deposit_coherent")

BOX = 8.0
WINDOWS = (128, 256, 512, 1024)
N = 8 * 2048  # particles: a row count at which the JAX package does not pad
WHOLE_ROW_TOL = 1e-6
TOL = 1e-5


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def coherent_set(rng, n, px, h_sigma=0.6, h_clip=12.0):
    """Cell-ordered (snapshot-like) clustered particles with density-
    correlated smoothing lengths, as the JAX package's window tests draw
    them."""
    cx = rng.uniform(0, BOX, n)
    cy = rng.uniform(0, BOX, n)
    cell = np.floor(cy / (BOX / 32)).astype(int) * 32 + np.floor(cx / (BOX / 32)).astype(int)
    order = np.argsort(cell, kind="stable")
    x, y = cx[order].astype(np.float32), cy[order].astype(np.float32)
    dens = rng.uniform(0.3, 3.0, 1024)[cell[order]]
    h = np.clip(
        0.6 * px * dens ** (-1 / 3) * np.exp(h_sigma * rng.normal(size=n)), 0.05 * px, h_clip * px
    ).astype(np.float32)
    m = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return x, y, h, m


def multilevel(rng):
    spec = MapSpec(shape=(128, 128), extent=(0, BOX, 0, BOX), periodic_wrap=True)
    x, y, h, m = coherent_set(rng, N, BOX / 128)
    return spec, x, y, h, np.stack([m, (m * rng.uniform(1, 2, x.size)).astype(np.float32)])


def all_subpixel(rng):
    spec = MapSpec(shape=(128, 128), extent=(0, BOX, 0, BOX), periodic_wrap=True)
    px = BOX / 128
    x, y, h, m = coherent_set(rng, N, px)
    return spec, x, y, np.minimum(h, 0.45 * px).astype(np.float32), m  # s_pix <= 0.9: K4 only


def random_heavy(rng):
    spec = MapSpec(shape=(128, 128), extent=(0, BOX, 0, BOX), periodic_wrap=True)
    px = BOX / 128
    n = N
    x = rng.uniform(0, BOX, n).astype(np.float32)
    y = rng.uniform(0, BOX, n).astype(np.float32)
    # f32 tile-local coordinates round ~4e-6 px, which the whole-row engine
    # and the window mode alike turn into ~1e-5 * max against the f64
    # oracle where a 0.3 px footprint lands on this map's peak: a 0.5 px
    # floor keeps both inside the oracle budget
    h = np.clip(0.6 * px * np.exp(0.6 * rng.normal(size=n)), 0.5 * px, 10 * px).astype(np.float32)
    return spec, x, y, h, rng.uniform(0.5, 2.0, n).astype(np.float32)


def off_extent(rng):
    spec = MapSpec(shape=(64, 64), extent=(0, BOX, 0, BOX), periodic_wrap=False)
    px = BOX / 64
    x, y, h, m = coherent_set(rng, N, px, h_sigma=0.5, h_clip=6.0)
    # a snapshot cut wider than the map: every 7th particle moved off it
    x[::7] = rng.uniform(-0.5, BOX + 0.5, x[::7].size).astype(np.float32)
    y[::7] = rng.uniform(-0.5, BOX + 0.5, y[::7].size).astype(np.float32)
    return spec, x, y, np.maximum(h, 0.3 * px).astype(np.float32), m


REGIMES = {"multilevel": multilevel, "all_subpixel": all_subpixel,
           "random_heavy": random_heavy, "off_extent": off_extent}


@pytest.fixture(scope="module")
def regime_data():
    """Per regime: inputs, the port's whole-row map, the f64 oracle."""
    out = {}
    for i, (name, make) in enumerate(REGIMES.items()):
        spec, x, y, h, vals = make(np.random.default_rng(300 + i))
        whole = deposit_2d_coherent(x, y, h, vals, spec, prep="xla", device="cpu").numpy()
        v2 = np.atleast_2d(vals)
        oracle = np.stack([
            project_oracle(x, y, h, v2[f], spec.shape, spec.extent, periodic=spec.periodic_wrap)
            for f in range(v2.shape[0])
        ])
        out[name] = (spec, x, y, h, vals, whole, oracle.reshape(whole.shape))
    return out


@pytest.mark.parametrize("W", WINDOWS)
@pytest.mark.parametrize("regime", list(REGIMES))
def test_window_map_matches_whole_row_and_oracle(regime_data, regime, W):
    spec, x, y, h, vals, whole, oracle = regime_data[regime]
    lay = tile_particles_coherent(x, y, h, vals, spec, window=W, device="cpu")
    assert lay.window == W and lay.b0w == lay.stats["n_window_steps"]
    img = TC.deposit_coherent(lay).numpy()
    img = img[0] if whole.ndim == 2 else img
    assert rel_err(img, whole) <= WHOLE_ROW_TOL
    assert rel_err(img, oracle) <= TOL
    if regime == "random_heavy":
        assert lay.stats["heavy_rows"] > 0
    if regime == "all_subpixel":
        # every window of every candidate is sub-pixel only: all K4
        assert torch.equal(lay.cand_win[2], lay.cand_win[1])
    if lay.n_cand:
        assert lay.stats["n_window_steps"] > 0


# JAX's interpret-mode window render costs seconds a call: every window on
# the multilevel regime, W = 512 (its own tests' window) on the rest
JAX_CASES = [("multilevel", W) for W in WINDOWS] + [(r, 512) for r in REGIMES if r != "multilevel"]


@pytest.mark.parametrize("regime,W", JAX_CASES)
def test_window_map_matches_jax(regime_data, regime, W):
    spec, x, y, h, vals, whole, _ = regime_data[regime]
    jspec = JC.MapSpec(spec.shape, spec.extent, periodic_wrap=spec.periodic_wrap)
    ref = np.asarray(JC.deposit_2d_coherent(x, y, h, vals, jspec, precision="f32", window=W))
    img = deposit_2d_coherent(x, y, h, vals, spec, window=W, device="cpu").numpy()
    assert img.shape == ref.shape == whole.shape
    assert rel_err(img, ref) <= TOL


def _windows_by_candidate(tile, row, win, n_cand):
    if not n_cand:  # JAX keeps no candidate arrays then
        return {}
    tile, row = np.asarray(tile)[:n_cand], np.asarray(row)[:n_cand]
    wb0, nw, k4n = (np.asarray(a)[:n_cand] for a in win)
    return {(int(t), int(r)): (int(a), int(b), int(c)) for t, r, a, b, c in zip(tile, row, wb0, nw, k4n)}


@pytest.mark.parametrize("W", WINDOWS)
@pytest.mark.parametrize("regime", list(REGIMES))
def test_window_geometry_matches_jax(regime_data, regime, W):
    spec, x, y, h, vals, _, _ = regime_data[regime]
    jspec = JC.MapSpec(spec.shape, spec.extent, periodic_wrap=spec.periodic_wrap)
    jlay = JC.tile_particles_coherent(x, y, h, vals, jspec, window=W)
    lay = tile_particles_coherent(x, y, h, vals, spec, window=W, device="cpu")
    # the keys agree first: each row's key channel, key-sorted in both
    key_ch = 3 + lay.n_fields
    assert np.array_equal(lay.packed[:, key_ch].numpy(), np.asarray(jlay.packed)[:, key_ch])
    assert lay.n_cand == jlay.n_cand
    assert lay.stats["n_window_steps"] == jlay.stats["n_window_steps"]
    got = _windows_by_candidate(lay.cand_tile, lay.cand_row, lay.cand_win, lay.n_cand)
    ref = _windows_by_candidate(jlay.cand_tile, jlay.cand_row, jlay.cand_win, jlay.n_cand)
    assert got == ref
    # the step list the kernel takes covers every window once, in tile order
    step_row, step_lane0, wstart, wend = lay.win_steps
    assert int(wend[-1]) == lay.b0w and bool((wstart[1:] == wend[:-1]).all())
    steps = {(int(r), int(l0)) for r, l0 in zip(step_row, step_lane0)}
    want = {(r, (a + j) * W) for (_, r), (a, b, _) in got.items() for j in range(b)}
    assert steps == want


def test_window_kernel_plain_matches_whole_row_plain_on_every_lane():
    """Windows that cover whole rows (wb0 = 0, nw = C / W) take every lane:
    the window plain version is then the whole-row plain version."""
    spec, x, y, h, vals = multilevel(np.random.default_rng(310))
    lay = tile_particles_coherent(x, y, h, vals, spec, device="cpu")
    g0 = lay.geom0
    psy, psx = spec.pixel_size
    kw = dict(n_fields=2, n_tiles=g0.n_tiles, cfg=g0.cfg, kernel="cubic_spline",
              projection="integrated", psx=psx, psy=psy, offset=0.5)
    W = 256
    wb0 = torch.zeros_like(lay.cand_tile)
    nw = torch.full_like(lay.cand_tile, 2048 // W)
    steps = TC.window_steps(lay.cand_tile, lay.cand_row, wb0, nw, window=W, n_steps=int(nw.sum()),
                            n_tiles=g0.n_tiles)
    got = TC.deposit_coherent_windows(lay.packed, lay.cand_tile, lay.cand_row, wb0, nw, steps, window=W, **kw)
    ref = TC.deposit_coherent_tiles_plain(lay.packed, lay.cand_tile, lay.cand_row, **kw)
    assert torch.equal(got, ref)


def test_window_arguments():
    spec = MapSpec(shape=(64, 64), extent=(0.0, BOX, 0.0, BOX))
    x = np.array([0.5], np.float32)
    h = np.array([0.05], np.float32)
    for bad in (64, 100, 2048, 3000):
        with pytest.raises(ValueError, match="power of two"):
            tile_particles_coherent(x, x, h, x, spec, window=bad, device="cpu")
    with pytest.raises(ValueError, match="prep"):
        tile_particles_coherent(x, x, h, x, spec, window=256, prep="pallas", device="cpu")
    with pytest.raises(ValueError, match="prep"):
        deposit_2d_coherent(x, x, h, x, spec, window=256, prep="pallas", device="cpu")
    # prep=None takes the row sort in window mode, on a card as elsewhere
    assert TC._resolve_prep(None, torch.device("cuda"), 256) == "xla"
    assert TC._resolve_prep(None, torch.device("cuda"), 0) == "pallas"
    lay = tile_particles_coherent(x, x, h, x, spec, window=128, device="cpu")
    assert lay.window == 128 and len(lay.cand_win) == 3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA window kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("W", WINDOWS)
def test_cuda_window_kernel_matches_plain(cuda_device, W):
    spec, x, y, h, vals = multilevel(np.random.default_rng(320))
    lay = tile_particles_coherent(x, y, h, vals, spec, window=W, device=cuda_device)
    g0 = lay.geom0
    psy, psx = spec.pixel_size
    for projection in ("kernel3d", "integrated"):
        kw = dict(n_fields=2, n_tiles=g0.n_tiles, cfg=g0.cfg, kernel="cubic_spline",
                  projection=projection, psx=psx, psy=psy, offset=0.5)
        wb0, nw, _ = lay.cand_win
        before = TC.deposit_coherent_windows.launches
        got = TC.deposit_coherent_windows(lay.packed, lay.cand_tile, lay.cand_row, wb0, nw, lay.win_steps,
                                          window=W, **kw)
        ref = TC.deposit_coherent_windows_plain(lay.packed, lay.cand_tile, lay.cand_row, wb0, nw, window=W, **kw)
        torch.cuda.synchronize()
        assert TC.deposit_coherent_windows.launches == before + 1
        assert rel_err(got.cpu(), ref.cpu()) <= TOL
