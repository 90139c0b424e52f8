"""Fidelity artifact of the port: every engine's error against an f64
reference, on the card.

Counterpart: ``benchmarks/fidelity_check.py`` of the JAX package, which
writes ``FIDELITY.json`` from a TPU run. This module runs its cases at its
sizes through the port's engines, plus the cases that file never had: the
bucketed random-order engine, the coherent engine's window mode, the halo
cutouts, the three streamed wires and the 3D voxel deposit. Each case
records ``max_rel_err`` (max |got - ref| / max |ref|), the ``budget``
(1e-5), ``in_budget_flag`` (False for the informational cases),
``n_particles``, ``wall_s`` (the engine call, synchronised) and the kernel
launches it made.

References, all f64 on the same device as the engines:

- :func:`project_f64` and :func:`grid_f64`, particle-scatter oracles
  written as ``tests/oracles.py::project_oracle_fast`` is (footprint
  windows K = 2..128 by 2 s + 2, a whole-image pass beyond), with the
  kernels of ``kernels/splines.py`` and, for the integrated projection, a
  65536-point table of the line-integrated kernel; scattered with
  ``index_add_`` in chunks of at most ``PAIRS`` (pixel, particle) pairs.
  They share no code with the engines' deposits (``ops/deposit*.py``).
  :func:`placed_f64` is :func:`project_f64` of the particles where the
  sorted layout's f32 placement puts them, for the two f32-input cases.
- the dense column and spectra engines' arithmetic
  (``ops/sightlines.py::_column_weights``, ``ops/spectra.py::_accumulate``)
  run in f64 with the 65536-point table;
- SciPy's f64 ``RegularGridInterpolator`` for the ion table.

Run on the card (the file is stamped with ``nvidia-smi``'s name and power
limit)::

    python -m astro_sph_tools_tpu_torch.scripts.fidelity_check --out FIDELITY_TORCH.json

``--small`` takes the CPU tests' sizes, ``--device cpu`` the CPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Optional

import numpy as np
import torch

from ..ops import kernel_counters

BUDGET = 1e-5
PAIRS = 1 << 24  # (pixel, particle) pairs a scatter chunk holds
#: px: two f32 ulps of a global pixel coordinate below 1024 (the card
#: multiplies by the pixel size's f32 reciprocal, the CPU divides)
PLACE_TOL_PX = 2.0**-13
_WINDOWS = (2, 4, 8, 16, 32, 64, 128)
_LUT_N = 65536

#: per case family, (full size, --small size); particle counts as log2
SIZES = {
    "res": (1024, 256),
    "levels_log2n": ((23, 21, 18, 15), (14, 12, 10, 8)),
    # an error relative to the map's maximum grows as the maps thin out (a
    # sub-pixel particle's peak, alone, sets the maximum): the small sizes
    # of the lognormal and halo cases keep particles a pixel near the full
    # sizes' (4 for the lognormal case)
    "auto": ((22, 1024), (16, 128)),
    "f32_log2n": (21, 13),
    "columns": ((20, 2048), (13, 64)),
    "spectra": ((18, 256, 256), (11, 16, 128)),
    "coherent_log2n": (21, 15),
    "ion_log2n": (20, 12),
    "bucketed_log2n": (22, 15),
    "window_log2n": (22, 15),
    "halo": ((22, 256), (17, 64)),
    "wires_log2n": (22, 15),
    "grid3d": ((20, 256), (12, 32)),
}


# ---------------------------------------------------------------------------
# f64 references
# ---------------------------------------------------------------------------


def _f64(a, device) -> torch.Tensor:
    return torch.as_tensor(a if isinstance(a, torch.Tensor) else np.asarray(a), device=device).to(torch.float64)


def _weight_fn(kernel: str, projection: str, support_factor: float, device):
    """f64 pair weight w(r, h): the 3D kernel at the projected radius, or
    the line-integrated kernel y(r / (S h)) / h^2 by linear interpolation in
    a 65536-point table."""
    from ..kernels.splines import get_kernel, integrated_kernel_table

    if projection == "kernel3d":
        return get_kernel(kernel).w
    tab = torch.as_tensor(integrated_kernel_table(kernel, _LUT_N), dtype=torch.float64, device=device)

    def w(r, h):
        u = torch.clamp(r / (support_factor * h), max=1.0)
        t = u * (_LUT_N - 1)
        i0 = torch.clamp(torch.floor(t).long(), max=_LUT_N - 2)
        f = t - i0
        y = tab[i0] * (1.0 - f) + tab[i0 + 1] * f
        return torch.where(u < 1.0, y / (h * h), 0.0)

    return w


def project_f64(x, y, h, values, shape, extent, *, kernel: str = "cubic_spline", periodic: bool = False,
                projection: str = "kernel3d", support_factor: float = 2.0, device="cpu",
                pairs: int = PAIRS) -> torch.Tensor:
    """f64 particle-scatter map (F, ny, nx) (values (N,) or (F, N)) at
    pixel centres, as ``tests/oracles.py::project_oracle_fast`` computes it."""
    device = torch.device(device)
    ny, nx = shape
    x0, x1, y0, y1 = extent
    psx, psy = (x1 - x0) / nx, (y1 - y0) / ny
    x, y, h = _f64(x, device), _f64(y, device), _f64(h, device)
    vals = _f64(values, device)
    vals = vals[None] if vals.ndim == 1 else vals
    n_f = vals.shape[0]
    image = torch.zeros((n_f, ny * nx), dtype=torch.float64, device=device)
    w_fn = _weight_fn(kernel, projection, support_factor, device)
    s_pix = support_factor * h / min(psx, psy)
    lvl = torch.searchsorted(torch.tensor(_WINDOWS, dtype=torch.float64, device=device), 2 * s_pix + 2)
    xs = x0 + (torch.arange(nx, dtype=torch.float64, device=device) + 0.5) * psx
    ys = y0 + (torch.arange(ny, dtype=torch.float64, device=device) + 0.5) * psy
    for li in torch.unique(lvl).tolist():
        idx = torch.nonzero(lvl == li)[:, 0]
        if li >= len(_WINDOWS) or (periodic and _WINDOWS[li] > min(nx, ny)):
            # wider than the largest window: a whole-image pass
            step = max(1, pairs // (ny * nx))
            for c in range(0, idx.numel(), step):
                sel = idx[c:c + step]
                dx = xs[None, None, :] - x[sel, None, None]
                dy = ys[None, :, None] - y[sel, None, None]
                if periodic:
                    dx = dx - torch.round(dx / (x1 - x0)) * (x1 - x0)
                    dy = dy - torch.round(dy / (y1 - y0)) * (y1 - y0)
                r2 = dx * dx + dy * dy
                hs = h[sel, None, None]
                w = torch.where(r2 < (support_factor * hs) ** 2, w_fn(torch.sqrt(r2), hs), 0.0)
                image += torch.einsum("fn,nyx->fyx", vals[:, sel], w).reshape(n_f, -1)
            continue
        K = _WINDOWS[li]
        ks = torch.arange(K, device=device)
        step = max(1, pairs // (K * K))
        for c in range(0, idx.numel(), step):
            sel = idx[c:c + step]
            u = (x[sel] - x0) / psx
            v = (y[sel] - y0) / psy
            jx = torch.floor(u - 0.5 + 0.5).long()[:, None] - K // 2 + ks
            jy = torch.floor(v - 0.5 + 0.5).long()[:, None] - K // 2 + ks
            dxp = (jx + 0.5 - u[:, None]) * psx
            dyp = (jy + 0.5 - v[:, None]) * psy
            r2 = dyp[:, :, None] ** 2 + dxp[:, None, :] ** 2
            hs = h[sel][:, None, None]
            w = torch.where(r2 < (support_factor * hs) ** 2, w_fn(torch.sqrt(r2), hs), 0.0)
            if periodic:
                flat = (torch.remainder(jy, ny)[:, :, None] * nx + torch.remainder(jx, nx)[:, None, :]).reshape(-1)
                keep = None
            else:
                ok = ((jy >= 0) & (jy < ny))[:, :, None] & ((jx >= 0) & (jx < nx))[:, None, :]
                flat = (jy.clamp(0, ny - 1)[:, :, None] * nx + jx.clamp(0, nx - 1)[:, None, :]).reshape(-1)
                keep = ok.reshape(-1)
            for f in range(n_f):
                wf = (w * vals[f, sel][:, None, None]).reshape(-1)
                if keep is not None:
                    wf = torch.where(keep, wf, 0.0)
                image[f].index_add_(0, flat, wf)
    return image.reshape(n_f, ny, nx)


def grid_f64(pos, h, values, shape, extent, *, kernel: str = "cubic_spline", periodic: bool = False,
             support_factor: float = 2.0, device="cpu", pairs: int = PAIRS) -> torch.Tensor:
    """f64 particle-scatter voxel grid (nz, ny, nx) of Σ value W(r, h) at
    voxel centres, as ``tests/oracles.py::grid3d_oracle`` defines it;
    footprints up to 64 voxels across."""
    from ..kernels.splines import get_kernel

    device = torch.device(device)
    shp = tuple(shape)  # (nz, ny, nx)
    lo = (extent[4], extent[2], extent[0])
    ps = tuple((extent[2 * a + 1] - extent[2 * a]) / shape[2 - a] for a in range(3))[::-1]  # (z, y, x)
    pos = _f64(pos, device)
    p = torch.stack([pos[:, 2], pos[:, 1], pos[:, 0]], dim=1)  # (z, y, x)
    h = _f64(h, device)
    vals = _f64(values, device)
    w_fn = get_kernel(kernel).w
    grid = torch.zeros(shp[0] * shp[1] * shp[2], dtype=torch.float64, device=device)
    s_vox = support_factor * h / min(ps)
    lvl = torch.searchsorted(torch.tensor(_WINDOWS, dtype=torch.float64, device=device), 2 * s_vox + 2)
    if int(lvl.max()) >= 6:
        raise ValueError("grid_f64 takes footprints up to 64 voxels across")
    for li in torch.unique(lvl).tolist():
        idx = torch.nonzero(lvl == li)[:, 0]
        K = _WINDOWS[li]
        ks = torch.arange(K, device=device)
        step = max(1, pairs // K ** 3)
        for c in range(0, idx.numel(), step):
            sel = idx[c:c + step]
            js, ds, oks = [], [], []
            for a in range(3):
                u = (p[sel, a] - lo[a]) / ps[a]
                j = torch.floor(u).long()[:, None] - K // 2 + ks
                ds.append((j + 0.5 - u[:, None]) * ps[a])
                if periodic:
                    js.append(torch.remainder(j, shp[a]))
                    oks.append(None)
                else:
                    js.append(j.clamp(0, shp[a] - 1))
                    oks.append((j >= 0) & (j < shp[a]))
            r2 = ds[0][:, :, None, None] ** 2 + ds[1][:, None, :, None] ** 2 + ds[2][:, None, None, :] ** 2
            hs = h[sel][:, None, None, None]
            w = torch.where(r2 < (support_factor * hs) ** 2, w_fn(torch.sqrt(r2), hs), 0.0)
            w = w * vals[sel][:, None, None, None]
            if not periodic:
                w = w * (oks[0][:, :, None, None] & oks[1][:, None, :, None] & oks[2][:, None, None, :])
            flat = (js[0][:, :, None, None] * shp[1] + js[1][:, None, :, None]) * shp[2] + js[2][:, None, None, :]
            grid.index_add_(0, flat.reshape(-1), w.reshape(-1))
    return grid.reshape(shp)


def columns_f64(x, y, h, values, rx, ry, *, box: Optional[float], kernel: str = "cubic_spline",
                device="cpu", pairs: int = PAIRS) -> torch.Tensor:
    """f64 integrated columns (R,) of the dense engine's arithmetic
    (``ops/sightlines.py::_column_weights``) with the 65536-point table."""
    from ..kernels.splines import get_kernel, integrated_kernel_table
    from ..ops.sightlines import _column_weights, _min_image

    device = torch.device(device)
    kspec = get_kernel(kernel)
    lut = torch.as_tensor(integrated_kernel_table(kernel, _LUT_N), dtype=torch.float64, device=device)
    x, y, h, v = (_f64(a, device) for a in (x, y, h, values))
    rx, ry = _f64(rx, device), _f64(ry, device)
    out = torch.zeros(rx.shape[0], dtype=torch.float64, device=device)
    step = max(1, pairs // rx.shape[0])
    for c in range(0, x.shape[0], step):
        dx = rx[:, None] - x[None, c:c + step]
        dy = ry[:, None] - y[None, c:c + step]
        if box is not None:
            dx, dy = _min_image(dx, box), _min_image(dy, box)
        out += (_column_weights(kspec, lut, dx * dx + dy * dy, h[None, c:c + step]) * v[None, c:c + step]).sum(1)
    return out


def spectra_f64(pos, h, values, v_los, temps, rx, ry, *, cosmology, box_size: float, n_bins: int,
                profile: str = "gaussian", gamma: Optional[float] = None, kernel: str = "cubic_spline",
                device="cpu", pairs: int = 1 << 22) -> torch.Tensor:
    """f64 spectra (R, n_bins): the dense engine's arithmetic
    (``ops/spectra.py::absorption_spectra``, periodic) on its per-particle
    inputs, in f64, with the 65536-point table."""
    from ..kernels.splines import get_kernel, integrated_kernel_table
    from ..ops.sightlines import _column_weights, _min_image
    from ..ops.spectra import _accumulate, _resolve_profile, _spectra_inputs

    device = torch.device(device)
    voigt_k = _resolve_profile(profile, gamma, 1215.67)
    (x, y, hh, col, v_eff, b_dopp), v_box, v_centres = _spectra_inputs(
        pos, h, values, v_los, temps, cosmology=cosmology, box_size=box_size, atomic_weight=1.008,
        n_bins=n_bins, periodic=True, device=device,
    )
    x, y, hh, col, v_eff, b_dopp = (a.double() for a in (x, y, hh, col, v_eff, b_dopp))
    kspec = get_kernel(kernel)
    lut = torch.as_tensor(integrated_kernel_table(kernel, _LUT_N), dtype=torch.float64, device=device)
    vc = torch.as_tensor(v_centres, dtype=torch.float64, device=device)
    rx, ry = _f64(rx, device), _f64(ry, device)
    tau = torch.zeros((rx.shape[0], n_bins), dtype=torch.float64, device=device)
    step = max(1, pairs // max(rx.shape[0], n_bins))
    for c in range(0, x.shape[0], step):
        dx = _min_image(rx[:, None] - x[None, c:c + step], box_size)
        dy = _min_image(ry[:, None] - y[None, c:c + step], box_size)
        w_col = _column_weights(kspec, lut, dx * dx + dy * dy, hh[None, c:c + step]) * col[None, c:c + step]
        _accumulate(tau, w_col, v_eff[c:c + step], b_dopp[c:c + step], vc, profile, voigt_k, v_box)
    return tau


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------


def rel_err(got, ref) -> float:
    got = torch.as_tensor(got).to(torch.float64)
    ref = torch.as_tensor(ref).to(torch.float64).to(got.device)
    return float((got - ref).abs().max() / ref.abs().max())


def snapshot_order(x, y, box: float, cells: int = 64) -> np.ndarray:
    """Row-major storage-cell order (a stand-in for a snapshot's curve
    order), stable within a cell."""
    c = np.floor(y / (box / cells)).astype(np.int64) * cells + np.floor(x / (box / cells)).astype(np.int64)
    return np.argsort(c, kind="stable")


class _Run:
    """Case bookkeeping: the device, the launch counters, the rows."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.kernels = kernel_counters()
        self.cases: list = []

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def call(self, fn):
        """(result, wall seconds, launches by kernel) of ``fn()``."""
        before = {k: f.launches for k, f in self.kernels.items()}
        self.sync()
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        wall = time.perf_counter() - t0
        launched = {k: f.launches - before[k] for k, f in self.kernels.items() if f.launches != before[k]}
        return out, wall, launched

    def add(self, case: str, precision: str, n: int, err: float, wall: float, launched: dict,
            in_budget: bool = True, **extra) -> dict:
        row = {"case": case, "precision": precision, "n_particles": int(n), "max_rel_err": float(err),
               "budget": BUDGET, "in_budget_flag": bool(in_budget), "wall_s": round(wall, 4),
               "kernels": launched, **extra}
        self.cases.append(row)
        print(json.dumps(row), flush=True)
        return row


def _uniform(rng, n, box, lo_px, hi_px, px):
    x = rng.uniform(0, box, n)
    y = rng.uniform(0, box, n)
    h = rng.uniform(lo_px * px, hi_px * px, n)
    return x, y, h, rng.uniform(0.5, 2.0, n)


def _lognormal(rng, n, box, px):
    x = rng.uniform(0, box, n)
    y = rng.uniform(0, box, n)
    h = np.clip(np.exp(rng.normal(np.log(0.9 * px), 0.55, n)), 0.25 * px, 24 * px)
    return x, y, h, rng.uniform(0.5, 2.0, n)


def case_levels(run: _Run, sz, rng, box):
    from ..ops import PALLAS_LEVELS, MapSpec, deposit_2d_pallas

    res = sz["res"]
    spec = MapSpec(shape=(res, res), extent=(0.0, box, 0.0, box))
    px = box / res
    for cfg, log2n in zip(PALLAS_LEVELS, sz["levels_log2n"]):
        n = 1 << log2n
        smax = cfg.max_s_pix
        smin = smax / 2 + 0.6 if cfg.K > 8 else 1.0
        x, y, _, m = _uniform(rng, n, box, 0, 1, px)
        h = rng.uniform(smin * px / 2, (smax - 0.05) * px / 2, n)
        ref = project_f64(x, y, h, m, spec.shape, spec.extent, device=run.device)[0]
        for precision in ("f32", "bf16x2", "bf16x3", "bf16"):
            got, wall, k = run.call(lambda: deposit_2d_pallas(x, y, h, m, spec, precision=precision, level=cfg,
                                                              device=run.device))
            run.add(f"K={cfg.K}", precision, n, rel_err(got, ref), wall, k)
        del ref


def case_auto(run: _Run, sz, rng, box):
    from ..ops import MapSpec, deposit_2d_auto

    log2n, res = sz["auto"]
    spec = MapSpec(shape=(res, res), extent=(0.0, box, 0.0, box))
    px = box / res
    n = 1 << log2n
    x, y, h, m = _lognormal(rng, n, box, px)
    for projection in ("kernel3d", "integrated"):
        ref = project_f64(x, y, h, m, spec.shape, spec.extent, projection=projection, device=run.device)[0]
        got, wall, k = run.call(lambda: deposit_2d_auto(x, y, h, m, spec, projection=projection, device=run.device))
        run.add(f"auto adaptive-h (lognormal levels), {projection}", "default", n, rel_err(got, ref), wall, k)
    # f32 device inputs skip the host-f64 assignment: their rounding
    # (~6e-5 px at 1024^2) rides along against the f64 positions
    res = sz["res"]
    spec = MapSpec(shape=(res, res), extent=(0.0, box, 0.0, box))
    px = box / res
    n = 1 << sz["f32_log2n"]
    x, y, h, m = _uniform(rng, n, box, 0.5, 1.45, px)
    ref = project_f64(x, y, h, m, spec.shape, spec.extent, device=run.device)[0]
    t = [torch.as_tensor(a, dtype=torch.float32, device=run.device) for a in (x, y, h, m)]
    got, wall, k = run.call(lambda: deposit_2d_auto(*t, spec, device=run.device))
    run.add("K=8 device-f32 inputs (informational)", "bf16x2", n, rel_err(got, ref), wall, k, in_budget=False)


def case_sightlines(run: _Run, sz, rng, box):
    from ..data_structures import Cosmology
    from ..ops import absorption_spectra_pallas, column_integrate_pallas

    px = box / SIZES["res"][0]
    log2n, n_rays = sz["columns"]
    n = 1 << log2n
    x = rng.uniform(0, box, n)
    y = rng.uniform(0, box, n)
    h = np.exp(rng.normal(np.log(10 * px), 0.5, n)).clip(2 * px, 60 * px)
    m = rng.uniform(0.5, 2.0, n).astype(np.float32)
    rx, ry = rng.uniform(0, box, n_rays), rng.uniform(0, box, n_rays)
    ref = columns_f64(x.astype(np.float32), y.astype(np.float32), h.astype(np.float32), m, rx, ry, box=box,
                      device=run.device)
    got, wall, k = run.call(lambda: column_integrate_pallas(x, y, h, m, rx, ry, periodic_box=box, device=run.device))
    run.add("sightline columns vs f64 dense columns", "f32 + Clenshaw", n, rel_err(got, ref), wall, k)

    log2n, n_rays, n_bins = sz["spectra"]
    n = 1 << log2n
    pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
    hs = np.exp(rng.normal(np.log(10 * px), 0.5, n)).clip(2 * px, 60 * px).astype(np.float32)
    val = rng.uniform(0.5, 2.0, n).astype(np.float32)
    vel = rng.normal(0.0, 80.0, n).astype(np.float32)
    temp = rng.uniform(1e4, 1e6, n).astype(np.float32)
    rxs, rys = rng.uniform(0, box, n_rays), rng.uniform(0, box, n_rays)
    cosmo = Cosmology.from_redshift(0.5, 0.6777, 0.0482)
    for profile, gamma in (("gaussian", None), ("voigt", 6.265e8)):
        kw = dict(cosmology=cosmo, box_size=box, n_bins=n_bins, profile=profile, gamma=gamma)
        ref = spectra_f64(pos, hs, val, vel, temp, rxs, rys, device=run.device, **kw)
        (got, _), wall, k = run.call(lambda: absorption_spectra_pallas(pos, hs, val, vel, temp, rxs, rys,
                                                                        device=run.device, **kw))
        run.add(f"{profile} absorption spectra vs f64 dense spectra", "f32", n, rel_err(got, ref), wall, k)


def _coherent_set(rng, n, box, px):
    x = rng.uniform(0, box, n)
    y = rng.uniform(0, box, n)
    o = snapshot_order(x, y, box)
    h = np.clip(np.exp(rng.normal(np.log(0.6 * px), 0.6, n)), 0.05 * px, 12 * px)
    return x[o].astype(np.float32), y[o].astype(np.float32), h.astype(np.float32), rng.uniform(0.5, 2.0, n).astype(
        np.float32)


def case_engines(run: _Run, sz, rng, box):
    """Engine against engine on identical f32 inputs (the JAX file's
    coherent, fused and shear rows), each also against the f64 oracle."""
    from ..ops import (
        MapSpec, caps_from_layout, deposit_2d_auto, deposit_2d_coherent, deposit_2d_coherent_fused, deposit_tiled,
        tile_particles, tile_particles_coherent,
    )

    res = sz["res"]
    spec = MapSpec(shape=(res, res), extent=(0.0, box, 0.0, box), periodic_wrap=True)
    n = 1 << sz["coherent_log2n"]
    xc, yc, hc, mc = _coherent_set(rng, n, box, box / res)
    oracle = project_f64(xc, yc, hc, mc, spec.shape, spec.extent, periodic=True, device=run.device)[0]
    srt, wall, k = run.call(lambda: deposit_2d_auto(xc, yc, hc, mc, spec, device=run.device))
    run.add("sorted engine, f32 inputs, vs f64 oracle (informational)", "default", n, rel_err(srt, oracle), wall, k,
            in_budget=False)
    coh, wall, k = run.call(lambda: deposit_2d_coherent(xc, yc, hc, mc, spec, device=run.device))
    run.add("coherent-order engine vs sorted engine (identical inputs)", "bf16x2", n, rel_err(coh, srt), wall, k)
    caps = caps_from_layout(tile_particles_coherent(xc, yc, hc, mc, spec, device=run.device))
    (fused, ok), wall, k = run.call(lambda: deposit_2d_coherent_fused(xc, yc, hc, mc, spec, caps, device=run.device))
    run.add("zero-sync fused engine vs synced coherent (identical inputs, occupancy caps)", "bf16x2", n,
            rel_err(fused, coh), wall, k, caps_ok_flag=bool(ok))
    sh = np.random.default_rng(29).permutation(n)
    xs, ys, hs, ms = xc[sh], yc[sh], hc[sh], mc[sh]
    srt2 = deposit_tiled(tile_particles(xs, ys, hs, ms, spec, layout="sort", need_perm=False, device=run.device))
    shear, wall, k = run.call(lambda: deposit_tiled(tile_particles(xs, ys, hs, ms, spec, layout="shear",
                                                                   need_perm=False, device=run.device)))
    run.add("shear grouping layout vs sort layout (shuffled input)", "bf16x2", n, rel_err(shear, srt2), wall, k)


def case_ion(run: _Run, sz, rng):
    from scipy.interpolate import RegularGridInterpolator

    from ..data_structures import IonisationTableBase
    from ..io.ionisation import synthetic_hm01_arrays

    a = synthetic_hm01_arrays()
    table = IonisationTableBase(a["ionbal"], a["logd"], a["logt"], a["redshift"], redshift_input_index=2,
                                device=run.device)
    n = 1 << sz["ion_log2n"]
    z = 0.5
    pts = np.column_stack([rng.uniform(-7.9, -0.1, n), rng.uniform(2.1, 7.9, n)])
    ref = RegularGridInterpolator((a["logd"], a["logt"], a["redshift"]), a["ionbal"])(
        np.column_stack([pts, np.full(n, z)]))
    got, wall, k = run.call(lambda: table.evaluate_at_redshift(pts, z))
    run.add("ion table lookup vs SciPy f64 interpolation", "f32", n, rel_err(got, torch.as_tensor(ref)), wall, k)


def placed_f64(x, y, h, values, spec, device) -> tuple:
    """(oracle, offset): the f64 oracle (:func:`project_f64`) of the
    particles where the sorted layout places them, and the largest distance
    in pixels between a placed particle and its input. The f32 engines place
    a coordinate at ``fl(fl(x / pixel) - tile origin)``, an ulp of the
    global pixel coordinate (6.1e-5 px below 1024), as the JAX package's
    engines do; against footprints of a few hundredths of a pixel that
    rounding alone leaves the 1e-5 budget (the informational sorted-engine
    row above). This oracle holds the deposit to f64 apart from it, and
    ``offset`` bounds the rounding (:data:`PLACE_TOL_PX`)."""
    from ..ops.deposit_tiled import tile_particles

    tp = tile_particles(x, y, h, values, spec, need_perm=True, device=device)
    x0, x1, y0, y1 = spec.extent
    ny, nx = spec.shape
    psx, psy = (x1 - x0) / nx, (y1 - y0) / ny
    u, v = tp.sorted_u.double().clone(), tp.sorted_v.double().clone()
    for geom, lo, count in tp.geoms:
        tile = tp.sorted_tile[lo:lo + count].long()
        u[lo:lo + count] += (tile % geom.n_tiles_x).double() * geom.tx - geom.cfg.M
        v[lo:lo + count] += torch.div(tile, geom.n_tiles_x, rounding_mode="floor").double() * geom.cfg.TY - geom.cfg.M
    perm = tp.perm[:tp.n_valid].long()
    u, v = u[:tp.n_valid], v[:tp.n_valid]
    px_, py_ = x0 + u * psx, y0 + v * psy
    offset = 0.0
    for placed, given, ps, span in ((px_, x, psx, x1 - x0), (py_, y, psy, y1 - y0)):
        d = placed - _f64(given, placed.device)[perm]
        if spec.periodic_wrap:
            d = d - torch.round(d / span) * span
        offset = max(offset, float(d.abs().max()) / ps)
    vals = tp.sorted_values[:, :tp.n_valid]
    oracle = project_f64(px_, py_, tp.sorted_h[:tp.n_valid], vals, spec.shape, spec.extent,
                         periodic=spec.periodic_wrap, device=device)
    return oracle, offset


def case_random_and_window(run: _Run, sz, rng, box):
    """The cases the JAX file never had: the bucketed random-order engine
    and the coherent engine's window mode, on f32 coordinates with
    footprints down to 0.05 px. Each is scored against the f64 oracle of the
    particles as placed (:func:`placed_f64`; the placement within
    :data:`PLACE_TOL_PX`); its error against the f64 oracle of the inputs,
    which carries the f32 placement, and against the sorted engine on the
    same inputs ride along."""
    from ..ops import MapSpec, deposit_2d_auto, deposit_2d_coherent
    from ..ops.layout_shear import deposit_2d_bucketed

    res = sz["res"]
    spec = MapSpec(shape=(res, res), extent=(0.0, box, 0.0, box), periodic_wrap=True)
    px = box / res
    n = 1 << sz["bucketed_log2n"]
    x, y, h, m = _coherent_set(rng, n, box, px)
    p = rng.permutation(n)
    x, y, h, m = x[p], y[p], h[p], m[p]
    placed, offset = placed_f64(x, y, h, m, spec, run.device)
    _check_placement(offset)
    srt = deposit_2d_auto(x, y, h, m, spec, device=run.device)
    oracle = project_f64(x, y, h, m, spec.shape, spec.extent, periodic=True, device=run.device)[0]
    got, wall, k = run.call(lambda: deposit_2d_bucketed(x, y, h, m, spec, device=run.device))
    run.add("bucketed random-order engine vs f64 oracle of the placed particles (shuffled f32 inputs)", "bf16x2", n,
            rel_err(got, placed[0]), wall, k, placement_max_px=offset, vs_f64_oracle_of_inputs=rel_err(got, oracle),
            vs_sorted_engine=rel_err(got, srt))
    del placed, oracle, srt

    n = 1 << sz["window_log2n"]
    x, y, h, m = _coherent_set(rng, n, box, px)
    placed, offset = placed_f64(x, y, h, m, spec, run.device)
    _check_placement(offset)
    srt = deposit_2d_auto(x, y, h, m, spec, device=run.device)
    whole = deposit_2d_coherent(x, y, h, m, spec, device=run.device)
    oracle = project_f64(x, y, h, m, spec.shape, spec.extent, periodic=True, device=run.device)[0]
    got, wall, k = run.call(lambda: deposit_2d_coherent(x, y, h, m, spec, window=512, device=run.device))
    run.add("coherent window mode W=512 vs f64 oracle of the placed particles (f32 inputs)", "bf16x2", n,
            rel_err(got, placed[0]), wall, k, placement_max_px=offset, vs_f64_oracle_of_inputs=rel_err(got, oracle),
            vs_sorted_engine=rel_err(got, srt), vs_whole_row=rel_err(got, whole))


def _check_placement(offset: float) -> None:
    if not offset <= PLACE_TOL_PX:
        raise AssertionError(f"fidelity_check: the sorted layout placed a particle {offset} px off its input")


def case_haloes(run: _Run, sz, rng, box):
    """``render_halo_maps`` on 4 haloes of a clustered box (one by the
    corner, so its cutout wraps), each cutout against the f64 oracle of the
    particles recentred in f64."""
    from ..io.catalogue import BasicHaloDefinitions
    from ..io.memory import MemoryCatalogue, MemorySnapshot
    from ..render import render_halo_maps

    log2n, res = sz["halo"]
    n = 1 << log2n
    centres = np.array([[6.0, 7.0, 12.5], [18.0, 5.0, 12.5], [12.0, 19.0, 12.5], [0.05, 0.05, 12.5]])
    radii = np.array([0.15, 0.3, 0.6, 1.0])
    n_blob = (3 * n) // 5
    which = rng.integers(0, 4, n_blob)
    pos = np.concatenate([np.mod(centres[which] + rng.normal(0, 0.4, (n_blob, 3)), box),
                          rng.uniform(0, box, (n - n_blob, 3))])
    h = np.clip(np.exp(rng.normal(np.log(0.04), 0.5, n)), 0.008, 0.3)
    m = rng.uniform(0.5, 2.0, n)
    snap = MemorySnapshot({"positions": pos, "smoothing_lengths": h, "masses": m}, box)
    cat = MemoryCatalogue(snap, centres, {BasicHaloDefinitions.SO_200_CRIT.value: radii})
    stacks, wall, k = run.call(lambda: render_halo_maps(snap, cat, [0, 1, 2, 3], resolution=res, device=run.device))
    errs = []
    for i, st in enumerate(stacks):
        hw = 2.0 * radii[i]
        d = np.mod(pos[:, :2] - centres[i, :2] + box / 2, box)  # recentred on box / 2, f64
        ext = (box / 2 - hw, box / 2 + hw, box / 2 - hw, box / 2 + hw)
        near = np.all(np.abs(d - box / 2) <= hw + 2.0 * h[:, None], axis=1)
        ref = project_f64(d[near, 0], d[near, 1], h[near], m[near], (res, res), ext, device=run.device)[0]
        errs.append(rel_err(torch.as_tensor(np.asarray(st["surface_density"])), ref))
    run.add("render_halo_maps, 4 cutouts vs f64 oracle (worst)", "default", n, max(errs), wall, k,
            per_halo=errs, resolution=res)


def case_wires(run: _Run, sz, rng, box):
    """The streamed ingest's three wires: 4 macro-chunks through
    ``stream_macro_chunks`` into the sorted engine. ``f32`` carries f32
    particles, promoted to f64 on the device for the assignment (the engine's
    f64 path), and counts against the budget with the f64 oracle of the
    values it carries; ``pack`` (u16 positions, f16 h and fields) and
    ``packdelta`` (Morton-delta positions, u8-log fields) are informational
    beside their quantisation error (their map against the f32 wire's)."""
    from ..io.packing import pack_particles_host, unpack_particles_device
    from ..io.prefetch import stream_macro_chunks
    from ..ops import MapSpec, deposit_2d_auto

    res = sz["res"]
    spec = MapSpec(shape=(res, res), extent=(0.0, box, 0.0, box), periodic_wrap=True)
    px = box / res
    n = 1 << sz["wires_log2n"]
    x, y, h, m = _coherent_set(rng, n, box, px)
    h = np.maximum(h, 0.3 * px).astype(np.float32)
    t = rng.uniform(1e4, 1e6, n).astype(np.float32)
    fields = [m, (m * t).astype(np.float32)]
    n_chunks = 4
    bounds = np.linspace(0, n, n_chunks + 1).astype(int)
    ref = project_f64(x, y, h, np.stack(fields), spec.shape, spec.extent, periodic=True, device=run.device)

    def read(wire):
        def chunk(ci):
            s = slice(bounds[ci], bounds[ci + 1])
            if wire == "f32":
                return (x[s], y[s], h[s], np.stack([f[s] for f in fields]))
            kw = dict(pos_encoding="delta", field_dtype="u8") if wire == "packdelta" else {}
            return pack_particles_host(x[s], y[s], h[s], [f[s] for f in fields], box=box,
                                       field_scales=(1.0, 2.0 ** 20), **kw)
        return chunk

    def render(wire):
        total = None
        for item in stream_macro_chunks(read(wire), n_chunks, device=run.device):
            if wire == "f32":
                cx, cy, ch, cf = item
                cx, cy = cx.double(), cy.double()
            else:
                cx, cy, ch, cf = unpack_particles_device(item, device=run.device)
            img = deposit_2d_auto(cx, cy, ch, cf, spec, device=run.device)
            total = img if total is None else total + img
        return total

    maps = {}
    for wire in ("f32", "pack", "packdelta"):
        maps[wire], wall, k = run.call(lambda: render(wire))
        extra = {} if wire == "f32" else {"quantisation_err_vs_f32_wire": rel_err(maps[wire], maps["f32"])}
        run.add(f"streamed {wire} wire, 4 chunks, vs f64 oracle", "default", n, rel_err(maps[wire], ref), wall, k,
                in_budget=wire == "f32", **extra)


def case_grid3d(run: _Run, sz, rng):
    from ..ops import GridSpec, deposit_3d_auto

    log2n, side = sz["grid3d"]
    n = 1 << log2n
    box = 25.0
    vox = box / side
    spec = GridSpec(shape=(side,) * 3, extent=(0.0, box) * 3, periodic_wrap=True)
    pos = rng.uniform(0, box, (n, 3))
    h = np.clip(np.exp(rng.normal(np.log(0.8 * vox), 0.5, n)), 0.4 * vox, 3.5 * vox)
    m = rng.uniform(0.5, 2.0, n)
    ref = grid_f64(pos, h, m, spec.shape, spec.extent, periodic=True, device=run.device)
    got, wall, k = run.call(lambda: deposit_3d_auto(pos, h, m, spec, device=run.device))
    run.add(f"deposit_3d_auto into {side}^3 vs f64 oracle", "default", n, rel_err(got, ref), wall, k)


def card_stamp(device) -> dict:
    """The card's name and power limit as nvidia-smi reports them."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"device": str(device), "nvidia_smi": "not measured (not a CUDA device)"}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        smi = f"nvidia-smi failed: {exc}"
    return {"device": torch.cuda.get_device_name(device), "nvidia_smi": smi}


def run(device="cuda", small: bool = False) -> dict:
    """Every case at full size (or the CPU tests' sizes with ``small``) on
    ``device``; returns the artifact."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fidelity_check: no CUDA device (pass --device cpu to run on the CPU)")
    sz = {k: v[1 if small else 0] for k, v in SIZES.items()}
    r = _Run(device)
    box = 25.0
    rng = np.random.default_rng(99)
    t0 = time.perf_counter()
    case_levels(r, sz, rng, box)
    case_auto(r, sz, rng, box)
    case_sightlines(r, sz, rng, box)
    case_engines(r, sz, rng, box)
    case_ion(r, sz, rng)
    case_random_and_window(r, sz, rng, box)
    case_haloes(r, sz, rng, box)
    case_wires(r, sz, rng, box)
    case_grid3d(r, sz, rng)
    scored = [c for c in r.cases if c["in_budget_flag"]]
    worst = max(scored, key=lambda c: c["max_rel_err"])
    return {
        "backend": "torch", "small": bool(small), **card_stamp(device),
        "oracle": "astro_sph_tools_tpu_torch/scripts/fidelity_check.py project_f64 / grid_f64 (f64 particle "
                  "scatter as tests/oracles.py project_oracle_fast; for the bucketed and window cases of the "
                  "particles as the sorted layout places them, placed_f64) and the dense engines' arithmetic in f64",
        "budget": BUDGET,
        "all_within_budget": all(c["max_rel_err"] <= BUDGET for c in scored),
        "worst_case": {"case": worst["case"], "precision": worst["precision"], "max_rel_err": worst["max_rel_err"]},
        "seconds": round(time.perf_counter() - t0, 3),
        "cases": r.cases,
    }


def main(argv: Optional[list] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="FIDELITY_TORCH.json", help="where to write the artifact")
    p.add_argument("--small", action="store_true", help="the CPU tests' sizes")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = p.parse_args(argv)
    result = run(args.device, args.small)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"fidelity_artifact": args.out, "all_within_budget": result["all_within_budget"],
                      "worst_case": result["worst_case"]}), flush=True)
    return result


if __name__ == "__main__":
    main()
