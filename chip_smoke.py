#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (astro_sph_tools_tpu_torch).

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py                # every phase
    python3 chip_smoke.py --phases 0,1,2 # a subset, for debugging

It drives the port's two main paths — the adaptive-h sorted tile engine
behind ``render_map_stack`` and the coherent-order engine (synced and
zero-sync fused) — on particles generated in memory from a seed, and fails
(non-zero exit) if any phase fails:

0. device: torch version, card name and power limit (nvidia-smi);
1. build: compile every CUDA kernel library (``csrc/deposit2d.cu``,
   ``csrc/coherent.cu``), one nvcc per source, all started together;
2. sorted-engine deposit kernel vs its plain torch version on the card, for
   every level K in {8, 16, 32, 64} x F in {2, 5} x projection, on a 1024^2
   map with 2^18 particles whose h lies inside the level;
3. sorted main path: ``deposit_2d_auto`` on 2^26 Morton-ordered clustered
   particles with adaptive h, 1024^2 periodic map, 2 fields; checks the
   kernel launch count, finiteness, mass conservation in the integrated
   projection, and agreement with the plain version on a 2^22 subset;
4. ``render_map_stack`` at 1024^2 on an in-memory snapshot;
5. host-f64 quality path against the f64 oracle of ``tests/oracles.py``;
6. row-prep kernel vs its plain version, bit for bit, on phase 3's
   particles, on 2^22 of them shuffled (most rows heavy) and on a
   non-periodic map with every 131st particle off the extent;
7. coherent deposit kernel vs its plain version on the layout of phase 3's
   particles, F in {1, 2, 4} x projection;
8. coherent main path at 2^26 (phase 3's particles): ``deposit_2d_coherent``
   and, with capacities from its layout, ``deposit_2d_coherent_fused``
   (the latter once more under ``torch.cuda.set_sync_debug_mode("error")``),
   both against the sorted engine; the three engines' warm walls; an
   overflowing fused render must report ``ok`` False;
9. ``render_map_stack(engine="coherent")`` against ``engine="pallas"``.

Every phase prints one JSON line; the kernels' summary line and the card's
``nvidia-smi`` line come before the last line, which is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
REL_TOL = 1e-5  # kernel vs plain and vs oracle: max|a - b| <= 1e-5 * max|b|
MASS_TOL = 5e-3  # integrated projection mass conservation
MAIN_LOG2N = 26  # main path: 2^26 particles (EAGLE Ref-L0025N0376's 376^3 gas fits)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int) -> float:
    """Median over ``reps`` synchronised runs, timed with CUDA events (ms)."""
    import torch

    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def wall_s(fn, reps: int) -> float:
    """Median over ``reps`` runs of the host wall clock around a synchronised call."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def device_busy_ms(fn) -> tuple:
    """(device busy ms, wall ms) of one synchronised call under
    ``torch.profiler``; busy is None when the trace shows no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events (kernels, copies) of the one stream, summed
    busy_us = sum(
        e.device_time_total for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    return (busy_us / 1e3 if busy_us > 0 else None), wall_ms


def rel_err(got, ref) -> tuple[float, float]:
    import torch

    got = torch.as_tensor(got, dtype=torch.float64)
    ref = torch.as_tensor(ref, dtype=torch.float64, device=got.device)
    err = float((got - ref).abs().max())
    return err, err / float(ref.abs().max())


# ---------------------------------------------------------------------------
# particle generators
# ---------------------------------------------------------------------------


def _morton_order_2d(bits: int) -> np.ndarray:
    """Morton (z-order) rank of each cell of a (2^bits, 2^bits) grid,
    flattened row-major."""
    n = 1 << bits
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    rank = np.zeros((n, n), dtype=np.int64)
    for b in range(bits):
        rank |= ((ii >> b) & 1) << (2 * b + 1)
        rank |= ((jj >> b) & 1) << (2 * b)
    return rank.reshape(-1)


def clustered_particles(n: int, box: float, npix: int, seed: int, device):
    """Morton-ordered clustered particles with density-correlated lognormal
    h (median ~0.5 px, clipped into the K=64 level), as the JAX package's
    ``benchmarks/northstar_proxy.py::build_particles`` draws them, with a
    ``torch.Generator`` for the per-particle draws. Returns x, y, h, m, T."""
    import torch

    bits = 8
    grid = 1 << bits
    n_cells = grid * grid
    rng = np.random.default_rng(seed)
    # blob-mixture density on a 256^2 cell grid: point masses smoothed with
    # periodic FFT Gaussians at three scales
    dens = np.zeros((grid, grid))
    fi = np.fft.fftfreq(grid)
    k2 = fi[:, None] ** 2 + fi[None, :] ** 2
    for n_blobs, sig_cells in ((400, 1.5), (1200, 3.0), (600, 6.0)):
        ci = rng.integers(0, grid, n_blobs)
        cj = rng.integers(0, grid, n_blobs)
        w = np.exp(rng.normal(0.0, 1.0, n_blobs))
        point = np.zeros((grid, grid))
        np.add.at(point, (ci, cj), w)
        kernel_ft = np.exp(-2.0 * (np.pi * sig_cells) ** 2 * k2)
        dens += np.real(np.fft.ifft2(np.fft.fft2(point) * kernel_ft))
    dens = np.maximum(dens, 0.0) ** 1.5
    dens = dens + 0.02 * dens.mean()
    dens = dens.reshape(-1)
    cell_seq = np.argsort(_morton_order_2d(bits))  # cell visited at each curve step
    cum = np.cumsum(dens[cell_seq] / dens.sum())

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    u01 = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) / n
    step = torch.searchsorted(torch.as_tensor(cum, dtype=torch.float32, device=device), u01)
    step = torch.clamp(step, 0, n_cells - 1)
    cell = torch.as_tensor(cell_seq, device=device)[step]
    del step, u01
    cw = box / grid
    x = ((cell % grid).float() + torch.rand(n, generator=g, device=device)) * cw
    y = ((cell // grid).float() + torch.rand(n, generator=g, device=device)) * cw
    px = box / npix
    rho = torch.as_tensor(dens / dens.mean(), dtype=torch.float32, device=device)[cell]
    del cell
    h = 0.5 * px * rho ** (-1.0 / 3.0)
    h = h * torch.exp(0.6 * torch.randn(n, generator=g, device=device))
    h = torch.clamp(h, 0.02 * px, 15.4 * px)
    m = 0.5 + 1.5 * torch.rand(n, generator=g, device=device)
    t = 1e4 + (1e6 - 1e4) * torch.rand(n, generator=g, device=device)
    return x, y, h, m, t


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: chip_smoke.py needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({
        "phase": "device", "torch": torch.__version__, "cuda": torch.version.cuda,
        "name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
    })
    return smi


def phase_build():
    from astro_sph_tools_tpu_torch import _build

    t0 = time.perf_counter()
    libs = _build.load_all()
    for name, (_, info) in libs.items():
        ptxas = [ln.strip() for ln in info.log.splitlines() if "registers" in ln or "Compiling entry" in ln]
        emit({
            "phase": "build", "library": os.path.relpath(str(info.path), ROOT),
            "nvcc_seconds": round(info.seconds, 3), "built": info.built,
            "flags": " ".join(_build.NVCC_FLAGS), "ptxas": ptxas,
        })
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3), "libraries": sorted(libs)})


def _level_inputs(torch, cfg, lo_s, hi_s, n_fields, n, spec, seed, device):
    """Tile-sorted tile-local inputs of one level, h inside (lo_s, hi_s] px."""
    from astro_sph_tools_tpu_torch.ops.deposit_tiled import _level_geometry, _tile_local_coords, _tile_ranges

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    box = spec.extent[1]
    px = box / spec.shape[1]
    x = torch.rand(n, generator=g, device=device) * box
    y = torch.rand(n, generator=g, device=device) * box
    s_pix = lo_s + (hi_s - lo_s) * (1.0 - torch.rand(n, generator=g, device=device))
    h = s_pix * px / 2.0
    vals = 0.5 + 1.5 * torch.rand((n_fields, n), generator=g, device=device)
    geom = _level_geometry(cfg, spec)
    tile, u_loc, v_loc = _tile_local_coords(x, y, geom, spec)
    tile, perm = torch.sort(tile, stable=True)
    pstart, pcount = _tile_ranges(tile, geom.n_tiles)
    return geom, (u_loc[perm], v_loc[perm], h[perm], vals[:, perm].contiguous(), pstart, pcount)


def phase_kernels(torch, device, n: int = 1 << 18):
    from astro_sph_tools_tpu_torch.ops import MapSpec
    from astro_sph_tools_tpu_torch.ops.deposit_tiled import PALLAS_LEVELS, deposit_tiles, deposit_tiles_plain

    spec = MapSpec(shape=(1024, 1024), extent=(0.0, 25.0, 0.0, 25.0), periodic_wrap=True)
    bounds = [0.02] + [cfg.max_s_pix for cfg in PALLAS_LEVELS]
    cases = []
    for li, cfg in enumerate(PALLAS_LEVELS):
        for n_fields in (2, 5):
            for projection in ("kernel3d", "integrated"):
                geom, args = _level_inputs(
                    torch, cfg, bounds[li], bounds[li + 1], n_fields, n, spec,
                    seed=100 + 10 * li + n_fields, device=device,
                )
                kw = dict(
                    cfg=cfg, kernel="cubic_spline", projection=projection,
                    psx=25.0 / 1024, psy=25.0 / 1024, offset=spec.sample_offset,
                )
                got = deposit_tiles(*args, **kw)
                ref = deposit_tiles_plain(*args, **kw)
                torch.cuda.synchronize()
                err, rel = rel_err(got, ref)
                ms = cuda_ms(lambda: deposit_tiles(*args, **kw), 5)
                plain_ms = cuda_ms(lambda: deposit_tiles_plain(*args, **kw), 5)
                case = {
                    "K": cfg.K, "F": n_fields, "projection": projection,
                    "n": n, "n_tiles": geom.n_tiles,
                    "max_pcount": int(args[5].max()), "max_abs_err": err,
                    "rel_err": rel, "ms": ms, "plain_ms": plain_ms,
                }
                emit({"phase": "kernel_vs_plain", **case})
                check(bool(torch.isfinite(got).all()), f"non-finite kernel output {case}")
                check(rel <= REL_TOL, f"kernel disagrees with the plain version: {case}")
                cases.append(case)
    return cases


def main_particles(torch, device, n_log2: int):
    """Phase 3's particle set (shared by phases 3, 4 and 6-9)."""
    box = 25.0
    t0 = time.perf_counter()
    x, y, h, m, t = clustered_particles(1 << n_log2, box, 1024, seed=7, device=device)
    torch.cuda.synchronize()
    return (x, y, h, m, t, box), time.perf_counter() - t0


def phase_main(torch, device, particles, gen_s):
    from astro_sph_tools_tpu_torch.ops import MapSpec, deposit_2d_auto, deposit_tiled, tile_particles
    from astro_sph_tools_tpu_torch.ops.deposit_tiled import _tile_ranges, deposit_tiles

    x, y, h, m, t, box = particles
    n = x.shape[0]
    n_log2 = n.bit_length() - 1
    spec = MapSpec(shape=(1024, 1024), extent=(0.0, box, 0.0, box), periodic_wrap=True)
    fields = torch.stack([m, m * t])

    # the main path, once, with the launch count reset just before it
    deposit_tiles.launches = 0
    img = deposit_2d_auto(x, y, h, fields, spec, device=device)
    torch.cuda.synchronize()
    launches = deposit_tiles.launches

    tp = tile_particles(x, y, h, fields, spec, device=device)
    levels = []
    for geom, lo, count in tp.geoms:
        _, pcount = _tile_ranges(tp.sorted_tile[lo:lo + count], geom.n_tiles)
        levels.append({"K": geom.cfg.K, "count": count, "n_tiles": geom.n_tiles,
                       "max_pcount": int(pcount.max())})
    check(launches >= len(tp.geoms), f"{launches} kernel launches for {len(tp.geoms)} levels")
    check(tuple(img.shape) == (2, 1024, 1024), f"output shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), "non-finite map")
    check(float(img[0].sum()) > 0, "empty map")

    wall = wall_s(lambda: deposit_2d_auto(x, y, h, fields, spec, device=device), 3)
    layout_s = wall_s(lambda: tile_particles(x, y, h, fields, spec, device=device), 3)
    deposit_s = wall_s(lambda: deposit_tiled(tp), 3)
    for lev, (geom, lo, count) in zip(levels, tp.geoms):
        sl = slice(lo, lo + count)
        pstart, pcount = _tile_ranges(tp.sorted_tile[sl], geom.n_tiles)
        args = (tp.sorted_u[sl], tp.sorted_v[sl], tp.sorted_h[sl], tp.sorted_values[:, sl], pstart, pcount)
        kw = dict(cfg=geom.cfg, kernel="cubic_spline", projection="kernel3d",
                  psx=box / 1024, psy=box / 1024, offset=spec.sample_offset)
        lev["kernel_ms"] = cuda_ms(lambda: deposit_tiles(*args, **kw), 3)
    busy_ms, prof_wall_ms = device_busy_ms(lambda: deposit_2d_auto(x, y, h, fields, spec, device=device))

    integ = deposit_2d_auto(x, y, h, fields, spec, projection="integrated", device=device)
    px = box / 1024
    mass = float(m.double().sum())
    mass_err = abs(float(integ[0].double().sum()) * px * px - mass) / mass
    check(bool(torch.isfinite(integ).all()), "non-finite integrated map")
    check(mass_err < MASS_TOL, f"integrated map mass error {mass_err}")

    sub = 1 << min(22, n_log2)
    a = deposit_2d_auto(x[:sub], y[:sub], h[:sub], fields[:, :sub], spec, device=device)
    b = deposit_2d_auto(x[:sub], y[:sub], h[:sub], fields[:, :sub], spec, device=device, plain=True)
    err, rel = rel_err(a, b)
    out = {
        "phase": "main_path", "n": n, "map": [1024, 1024], "fields": 2,
        "generate_s": gen_s, "launches": launches, "levels": levels,
        "n_oversize": tp.n_oversize, "wall_s": wall, "layout_s": layout_s,
        "deposit_s": deposit_s, "deposits_per_s": n / wall,
        "profiled_wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": None if busy_ms is None else 1.0 - busy_ms / prof_wall_ms,
        "integrated_mass_rel_err": mass_err,
        "plain_subset_n": sub, "plain_subset_max_abs_err": err, "plain_subset_rel_err": rel,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
    }
    emit(out)
    check(rel <= REL_TOL, f"main path disagrees with the plain version on {sub} particles: {rel}")
    return out


def memory_snapshot(x, y, h, m, t, box):
    """An in-memory gas-only snapshot serving device tensors (positions in
    the z = 0 plane, smoothing lengths, masses, temperatures)."""
    import torch

    from astro_sph_tools_tpu_torch.data_structures import ParticleType
    from astro_sph_tools_tpu_torch.io.snapshot import SnapshotBase
    from astro_sph_tools_tpu_torch.units import unit_array

    class MemorySnapshot(SnapshotBase):
        def __init__(self):
            super().__init__(
                filepath="<memory>", number="000", redshift=0.0,
                hubble_param=0.6777, omega_baryon=0.04825,
                expansion_factor=1.0, box_size=unit_array(np.full(3, box), "Mpc"),
            )

        def _get_number_of_particles(self):
            return {pt: (x.shape[0] if pt == ParticleType.gas else 0) for pt in ParticleType.get_all()}

        _get_number_of_particles_this_rank = _get_number_of_particles

        def _get_positions(self, particle_type, use_proper_units):
            return unit_array(torch.stack([x, y, torch.zeros_like(x)], dim=1), "Mpc")

        def _get_smoothing_lengths(self, particle_type, use_proper_units):
            return unit_array(h, "Mpc")

        def _get_masses(self, particle_type):
            return unit_array(m, "Msun")

        def _get_temperatures(self, particle_type):
            return unit_array(t, "K")

        def _missing(self, *args, **kwargs):
            raise NotImplementedError("not served by the in-memory snapshot")

        _get_IDs = _get_black_hole_subgrid_masses = _get_black_hole_dynamical_masses = _missing
        _get_velocities = _get_sfr = _get_metallicities = _missing
        _get_mean_enrichment_redshift = _get_densities = _missing
        _get_number_densities = _get_elemental_abundance = _missing

    return MemorySnapshot()


def phase_render(torch, device, particles):
    from astro_sph_tools_tpu_torch import render_map_stack

    snap = memory_snapshot(*particles)
    stack = render_map_stack(snap, fields=("density", "temperature"), resolution=1024, device=device)
    sd = stack["surface_density"]
    check(sd.shape == (1024, 1024) and np.isfinite(sd).all() and sd.sum() > 0, "bad surface density")
    mt = stack["mean_temperature"]
    covered = sd > 1e-3 * sd.max()
    check(bool(((mt[covered] >= 1e4 * 0.999) & (mt[covered] <= 1e6 * 1.001)).all()),
          "mean temperature outside the particles' range")
    emit({"phase": "render_map_stack", "maps": sorted(stack.keys()), "timings": stack.timings})


def phase_quality(torch, device):
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from oracles import project_oracle

    from astro_sph_tools_tpu_torch.ops import MapSpec, deposit_2d_auto, tile_particles
    from astro_sph_tools_tpu_torch.ops.deposit_tiled import deposit_tiles

    rng = np.random.default_rng(11)
    box, npix, n = 10.0, 64, 2000
    spec = MapSpec(shape=(npix, npix), extent=(0.0, box, 0.0, box))
    px = box / npix
    x = rng.uniform(0, box, n)
    y = rng.uniform(0, box, n)
    h = 10.0 ** rng.uniform(-0.3, 1.35, n) * px  # K = 8..64 levels + oversize
    m = rng.uniform(0.5, 2.0, n)
    tp = tile_particles(x, y, h, m, spec, device=device)
    before = deposit_tiles.launches
    got = deposit_2d_auto(x, y, h, m, spec, device=device).cpu().numpy()
    expected = project_oracle(x, y, h, m, spec.shape, spec.extent)
    err, rel = rel_err(got, expected)
    out = {
        "phase": "quality_f64", "n": n, "map": [npix, npix],
        "levels": [geom.cfg.K for geom, _, _ in tp.geoms], "n_oversize": tp.n_oversize,
        "launches": deposit_tiles.launches - before, "max_abs_err": err, "rel_err": rel,
    }
    emit(out)
    check(len(tp.geoms) == 4 and tp.n_oversize > 0, "quality case must span K=8..64 and oversize")
    check(rel <= REL_TOL, f"quality path off the f64 oracle: {rel}")


def _coherent_module():
    import importlib

    # ops/__init__ exports a function named like the module
    return importlib.import_module("astro_sph_tools_tpu_torch.ops.deposit_coherent")


def phase_prep(torch, device, particles):
    """Kernel #3 (row prep) vs its plain version: bit for bit."""
    from astro_sph_tools_tpu_torch.ops import MapSpec
    from astro_sph_tools_tpu_torch.ops.coherent_prep import _prep_rows, prep_rows, prep_rows_plain

    TC = _coherent_module()
    x, y, h, m, t, box = particles
    n = x.shape[0]
    g = torch.Generator(device=device)
    g.manual_seed(13)
    sub = min(n, 1 << 22)
    perm = torch.randperm(sub, generator=g, device=device)
    off = min(n, 1 << 24)
    xo, yo = x[:off].clone(), y[:off].clone()
    xo[::131] -= 2.0 * box  # off the extent, to the left
    yo[65::131] += 2.0 * box  # and above it
    periodic = MapSpec(shape=(1024, 1024), extent=(0.0, box, 0.0, box), periodic_wrap=True)
    flat = MapSpec(shape=(1024, 1024), extent=(0.0, box, 0.0, box), periodic_wrap=False)
    cases = [
        ("coherent_order", periodic, x, y, h, torch.stack([m, m * t])),
        ("shuffled", periodic, x[:sub][perm], y[:sub][perm], h[:sub][perm], torch.stack([m[:sub][perm], t[:sub][perm]])),
        ("off_extent", flat, xo, yo, h[:off], torch.stack([m[:off], m[:off] * t[:off]])),
    ]
    out = []
    for name, spec, cx, cy, ch, cv in cases:
        cx, cy, ch, cv = (a.contiguous() for a in (cx, cy, ch, cv))
        st = TC._setup(spec, "cubic_spline", TC.PALLAS_LEVELS, TC._D_MAX)
        packed, aux = prep_rows(cx, cy, ch, cv, spec)
        ref_packed, ref_aux = prep_rows_plain(cx, cy, ch, cv, st)
        torch.cuda.synchronize()
        bad_packed = int((packed != ref_packed).sum())
        bad_aux = int((aux != ref_aux).sum())
        err = max(float((packed - ref_packed).abs().max()), float((aux - ref_aux).abs().max()))
        d = TC._D_MAX
        heavy = int((aux[:, d + 2] > 0.5).sum())
        n_rows = aux.shape[0]
        case = {
            "phase": "prep_vs_plain", "case": name, "n": cx.shape[0], "periodic": spec.periodic_wrap,
            "mismatched_packed": bad_packed, "mismatched_aux": bad_aux, "max_abs_err": err,
            "ms": cuda_ms(lambda: _prep_rows(cx, cy, ch, cv, st), 5),
            "plain_ms": cuda_ms(lambda: prep_rows_plain(cx, cy, ch, cv, st), 5),
            "heavy_rows": heavy, "coherent_fraction": 1.0 - heavy / n_rows,
        }
        if bad_packed or bad_aux:  # where they differ, for the record
            idx = torch.nonzero(packed != ref_packed)[:5].tolist()
            case["first_packed_mismatches"] = [
                [i, float(packed[tuple(i)]), float(ref_packed[tuple(i)])] for i in idx
            ]
            idx = torch.nonzero(aux != ref_aux)[:5].tolist()
            case["first_aux_mismatches"] = [[i, float(aux[tuple(i)]), float(ref_aux[tuple(i)])] for i in idx]
        emit(case)
        check(bad_packed == 0 and bad_aux == 0, f"row-prep kernel differs from its plain version: {name}")
        out.append(case)
    return out


def phase_coherent_kernel(torch, device, particles):
    """Kernel #2 (coherent deposit) vs its plain version on the main path's layout."""
    from astro_sph_tools_tpu_torch.ops import MapSpec, tile_particles_coherent

    TC = _coherent_module()
    x, y, h, m, t, box = particles
    spec = MapSpec(shape=(1024, 1024), extent=(0.0, box, 0.0, box), periodic_wrap=True)
    all_fields = [m, m * t, t, 2.0 * m]
    out = []
    for n_fields in (1, 2, 4):
        lay = tile_particles_coherent(x, y, h, torch.stack(all_fields[:n_fields]), spec, device=device)
        g0 = lay.geom0
        tr = torch.arange(g0.n_tiles, dtype=torch.int32, device=device)
        per_tile = torch.searchsorted(lay.cand_tile, tr, right=True) - torch.searchsorted(lay.cand_tile, tr)
        for projection in ("kernel3d", "integrated"):
            kw = dict(n_fields=n_fields, n_tiles=g0.n_tiles, cfg=g0.cfg, kernel="cubic_spline",
                      projection=projection, psx=box / 1024, psy=box / 1024, offset=spec.sample_offset)
            args = (lay.packed, lay.cand_tile, lay.cand_row)
            got = TC.deposit_coherent_tiles(*args, **kw)
            ref = TC.deposit_coherent_tiles_plain(*args, **kw)
            torch.cuda.synchronize()
            err, rel = rel_err(got, ref)
            case = {
                "phase": "coherent_kernel_vs_plain", "F": n_fields, "projection": projection,
                "n_candidates": lay.n_cand, "n_tiles": g0.n_tiles,
                "max_candidates_per_tile": int(per_tile.max()),
                "mean_candidates_per_tile": lay.n_cand / g0.n_tiles,
                "max_abs_err": err, "rel_err": rel,
                "ms": cuda_ms(lambda: TC.deposit_coherent_tiles(*args, **kw), 5),
                "plain_ms": cuda_ms(lambda: TC.deposit_coherent_tiles_plain(*args, **kw), 3),
            }
            emit(case)
            check(bool(torch.isfinite(got).all()), f"non-finite coherent kernel output {case}")
            check(rel <= REL_TOL, f"coherent kernel disagrees with its plain version: {case}")
            out.append(case)
        del lay
    return out


def phase_coherent(torch, device, particles):
    """The coherent main path at full size, synced and fused."""
    from astro_sph_tools_tpu_torch.ops import (
        CoherentCaps, MapSpec, caps_from_layout, deposit_2d_auto, deposit_2d_coherent,
        deposit_2d_coherent_fused, deposit_coherent, tile_particles_coherent,
    )
    from astro_sph_tools_tpu_torch.ops.coherent_prep import prep_rows
    from astro_sph_tools_tpu_torch.ops.deposit_tiled import deposit_tiles

    TC = _coherent_module()
    x, y, h, m, t, box = particles
    n = x.shape[0]
    spec = MapSpec(shape=(1024, 1024), extent=(0.0, box, 0.0, box), periodic_wrap=True)
    fields = torch.stack([m, m * t])
    torch.cuda.reset_peak_memory_stats()

    # the coherent main path, once, with every launch count reset just before it
    deposit_tiles.launches = prep_rows.launches = TC.deposit_coherent_tiles.launches = 0
    img = deposit_2d_coherent(x, y, h, fields, spec, device=device)
    torch.cuda.synchronize()
    launches = {
        "coherent_prep": prep_rows.launches,
        "coherent_deposit": TC.deposit_coherent_tiles.launches,
        "deposit2d": deposit_tiles.launches,
    }
    lay = tile_particles_coherent(x, y, h, fields, spec, device=device)
    caps = caps_from_layout(lay)
    deposit_tiles.launches = prep_rows.launches = TC.deposit_coherent_tiles.launches = 0
    img_f, ok = deposit_2d_coherent_fused(x, y, h, fields, spec, caps, device=device)
    torch.cuda.synchronize()
    fused_launches = {
        "coherent_prep": prep_rows.launches,
        "coherent_deposit": TC.deposit_coherent_tiles.launches,
        "deposit2d": deposit_tiles.launches,
    }
    ok_first = bool(ok)
    # zero host syncs: a synchronising call inside raises in this mode
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        img_f2, ok2 = deposit_2d_coherent_fused(x, y, h, fields, spec, caps, device=device)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    ref = deposit_2d_auto(x, y, h, fields, spec, device=device)
    err_s, rel_s = rel_err(img, ref)
    err_f, rel_f = rel_err(img_f, ref)
    err_f2, rel_f2 = rel_err(img_f2, ref)

    integ = deposit_2d_coherent(x, y, h, fields, spec, projection="integrated", device=device)
    px = box / 1024
    mass = float(m.double().sum())
    mass_err = abs(float(integ[0].double().sum()) * px * px - mass) / mass

    wall_sync = wall_s(lambda: deposit_2d_coherent(x, y, h, fields, spec, device=device), 3)
    wall_fused = wall_s(lambda: deposit_2d_coherent_fused(x, y, h, fields, spec, caps, device=device), 3)
    wall_sorted = wall_s(lambda: deposit_2d_auto(x, y, h, fields, spec, device=device), 3)
    layout_s = wall_s(lambda: tile_particles_coherent(x, y, h, fields, spec, device=device), 3)
    deposit_s = wall_s(lambda: deposit_coherent(lay), 3)
    busy_ms, prof_wall_ms = device_busy_ms(
        lambda: deposit_2d_coherent_fused(x, y, h, fields, spec, caps, device=device)
    )

    sub = 1 << min(22, n.bit_length() - 1)
    tiny = CoherentCaps(b0=4096, bucket_caps=tuple(0 for _ in range(12)), level_caps=(0, 0, 0, 0))
    _, ok_tiny = deposit_2d_coherent_fused(x[:sub], y[:sub], h[:sub], fields[:, :sub], spec, tiny, device=device)
    ok_tiny = bool(ok_tiny)

    out = {
        "phase": "coherent_path", "n": n, "map": [1024, 1024], "fields": 2,
        "launches_synced": launches, "launches_fused": fused_launches,
        "ok": ok_first, "ok_sync_debug_run": bool(ok2), "overflow_ok": ok_tiny,
        "synced_vs_sorted_rel_err": rel_s, "fused_vs_sorted_rel_err": rel_f,
        "fused_sync_debug_vs_sorted_rel_err": rel_f2, "max_abs_err": max(err_s, err_f, err_f2),
        "integrated_mass_rel_err": mass_err,
        "wall_s_coherent_synced": wall_sync, "wall_s_coherent_fused": wall_fused,
        "wall_s_sorted": wall_sorted, "deposits_per_s_fused": n / wall_fused,
        "layout_s": layout_s, "deposit_s": deposit_s,
        "fused_profiled_wall_ms": prof_wall_ms, "fused_device_busy_ms": busy_ms,
        "fused_device_idle_share": None if busy_ms is None else 1.0 - busy_ms / prof_wall_ms,
        "stats": lay.stats, "caps": {"b0": caps.b0, "bucket_caps": caps.bucket_caps, "level_caps": caps.level_caps},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
    }
    emit(out)
    check(all(v > 0 for v in launches.values()), f"a kernel of the coherent path was not launched: {launches}")
    check(all(v > 0 for v in fused_launches.values()), f"a kernel of the fused path was not launched: {fused_launches}")
    check(ok_first and bool(ok2), "fused render reported overflow with capacities from its own layout")
    check(not ok_tiny, "fused render with tiny capacities reported ok")
    for name, a in (("synced", img), ("fused", img_f), ("integrated", integ)):
        check(tuple(a.shape) == (2, 1024, 1024) and bool(torch.isfinite(a).all()), f"bad {name} map")
    check(max(rel_s, rel_f, rel_f2) <= REL_TOL, f"coherent maps off the sorted engine: {rel_s}, {rel_f}, {rel_f2}")
    check(mass_err < MASS_TOL, f"integrated coherent map mass error {mass_err}")
    return out


def phase_render_coherent(torch, device, particles):
    from astro_sph_tools_tpu_torch import render_map_stack

    snap = memory_snapshot(*particles)
    kw = dict(fields=("density", "temperature"), resolution=1024, device=device)
    got = render_map_stack(snap, engine="coherent", **kw)
    ref = render_map_stack(snap, engine="pallas", **kw)
    errs = {name: rel_err(got[name], ref[name])[1] for name in ("surface_density", "mass_weighted_temperature")}
    emit({"phase": "render_map_stack_coherent", "maps": sorted(got.keys()), "rel_err_vs_pallas": errs,
          "timings": got.timings, "timings_pallas": ref.timings})
    check(max(errs.values()) <= REL_TOL, f"render_map_stack(engine='coherent') off engine='pallas': {errs}")



def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", default="0,1,2,3,4,5,6,7,8,9", help="comma-separated phases to run")
    parser.add_argument("--log2n", type=int, default=MAIN_LOG2N, help="log2 of the main path's particle count")
    args = parser.parse_args()
    phases = {int(p) for p in args.phases.split(",")}

    if not os.path.isdir(os.path.join(ROOT, "astro_sph_tools_tpu_torch")):
        raise SystemExit("chip_smoke.py must run from a checkout of the repository")
    sys.path.insert(0, ROOT)
    import torch

    phase_device(torch)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from astro_sph_tools_tpu_torch.ops.deposit_tiled import deposit_tiles

    if phases - {0}:
        phase_build()
    cases = phase_kernels(torch, device) if 2 in phases else []
    particles, gen_s = main_particles(torch, device, args.log2n) if phases & {3, 4, 6, 7, 8, 9} else (None, 0.0)
    main_out = phase_main(torch, device, particles, gen_s) if 3 in phases else None
    if 4 in phases:
        phase_render(torch, device, particles)
    if 5 in phases:
        phase_quality(torch, device)
    prep_cases = phase_prep(torch, device, particles) if 6 in phases else []
    coh_cases = phase_coherent_kernel(torch, device, particles) if 7 in phases else []
    coh_out = phase_coherent(torch, device, particles) if 8 in phases else None
    if 9 in phases:
        phase_render_coherent(torch, device, particles)
    del particles

    def pick(rows, **match):
        return next((c for c in rows if all(c[k] == v for k, v in match.items())), None)

    ref_case = pick(cases, K=8, F=2, projection="kernel3d")
    prep_case = pick(prep_cases, case="coherent_order")
    coh_case = pick(coh_cases, F=2, projection="kernel3d")
    launches = coh_out["launches_synced"] if coh_out else {}
    emit({"kernels": [
        {
            "name": "deposit2d",
            "route": "cuda",
            "source": "astro_sph_tools_tpu_torch/csrc/deposit2d.cu",
            "replaces": "astro_sph_tools_tpu/ops/deposit_pallas.py:129",
            "launches": main_out["launches"] if main_out else deposit_tiles.launches,
            "max_abs_err": max((c["max_abs_err"] for c in cases), default=None),
            "ms": ref_case["ms"] if ref_case else None,
            "plain_ms": ref_case["plain_ms"] if ref_case else None,
        },
        {
            "name": "coherent_prep",
            "route": "cuda",
            "source": "astro_sph_tools_tpu_torch/csrc/coherent.cu",
            "replaces": "astro_sph_tools_tpu/ops/coherent_prep_pallas.py:104",
            "launches": launches.get("coherent_prep"),
            "max_abs_err": max((c["max_abs_err"] for c in prep_cases), default=None),
            "ms": prep_case["ms"] if prep_case else None,
            "plain_ms": prep_case["plain_ms"] if prep_case else None,
        },
        {
            "name": "coherent_deposit",
            "route": "cuda",
            "source": "astro_sph_tools_tpu_torch/csrc/coherent.cu",
            "replaces": "astro_sph_tools_tpu/ops/deposit_coherent.py:660",
            "launches": launches.get("coherent_deposit"),
            "max_abs_err": max((c["max_abs_err"] for c in coh_cases), default=None),
            "ms": coh_case["ms"] if coh_case else None,
            "plain_ms": coh_case["plain_ms"] if coh_case else None,
        },
    ]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }})


if __name__ == "__main__":
    main()
