#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (astro_sph_tools_tpu_torch).

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py                # phases 0-14, 16-17
    python3 chip_smoke.py --phases 0,1,2 # a subset, for debugging

It drives the port's main paths — the adaptive-h sorted tile engine behind
``render_map_stack``, the coherent-order engine (synced and zero-sync fused),
the sightline columns and absorption spectra of BASELINE config 4, the 3D
voxel deposit of BASELINE config 3 and the random-order path (shear grouping,
``deposit_2d_bucketed``) — on particles generated in memory from a seed, and
fails (non-zero exit) if any phase fails:

0. device: torch version, card name and power limit (nvidia-smi);
1. build: compile every CUDA kernel library (``csrc/deposit2d.cu``,
   ``csrc/coherent.cu``, ``csrc/sightlines.cu``, ``csrc/deposit3d.cu``,
   ``csrc/layout_shear.cu``), one nvcc per source, all started together;
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
9. ``render_map_stack(engine="coherent")`` against ``engine="pallas"``;
10. sightline column kernel (``csrc/sightlines.cu``) vs its plain version on
    the fused layout of the config-4 particles (below) and 2048 rays,
    {kernel3d, integrated} x {periodic, open} x F in {1, 5};
11. spectra kernel vs its plain version, 256 rays, 512 bins, {gaussian,
    voigt (H I Lya)} x {periodic, open};
12. the config-4 path at full size: 10^4 random rays through 10^7 clustered
    gas particles in a periodic 25 cMpc box at z = 0.5 —
    ``column_integrate_pallas`` and ``absorption_spectra_pallas`` (512 bins,
    Gaussian and Voigt); launch counts, finiteness, warm walls, the device's
    busy share, and agreement with the binned engines on 256 rays and with
    the dense spectra engine on a 2^20-particle subset;
13. 3D voxel deposit kernel (``csrc/deposit3d.cu``) vs its plain version,
    every level K in {4, 8, 16} x F in {1, 4} x {periodic, open}, on a 256^3
    grid with 2^18 particles whose h lies inside the level;
14. the config-3 path at full size: ``deposit_3d_auto`` on 2^24 clustered
    particles (the JAX package's ``benchmarks/voxel3d_bench.py`` generator,
    h capped at 3.5 voxels so that every particle fits the K = 16 level),
    512^3 periodic cube over 25 cMpc, F = 4 (m and m * v); launch count, no
    oversize particle, finiteness, agreement with the plain stencil engine
    on a 2^20 subset, the oversize route at 64^3, warm walls split into
    layout and kernel, the device's busy share, peak memory; and each
    level's kernel launch against its plain version on the full-size layout;
15. (only when named in ``--phases``) tile-geometry A/B of kernel #6 on
    phase 14's particles: the K = 8 and K = 16 levels' kernel times at 8^3
    (the default), (16, 16, 8) and 16^3 tiles, F = 1 and 4, each held
    against the default's cube;
16. gang-append kernel (``csrc/layout_shear.cu``, kernel #7) vs its plain
    version, bit for bit on every destination gang, on stage A's output for
    (a) the coarse 128 x 2-cell grouping of phase 17's particles, (b) their
    fine 1024^2 level/tile key space, (c) one key, (d) runs of mostly one
    record; kernel, plain and ``torch.index_select`` times and bounds;
17. the random-order path at 2^27 (``--rand-log2n``): phase 3's density
    field, h and fields with every particle in an iid random cell (the JAX
    package's ``benchmarks/northstar_proxy.py --order random``), 1024^2
    periodic, 2 fields, through ``deposit_2d_bucketed`` (the slice's main
    path: launch counts), ``tile_particles(layout="shear")`` +
    ``deposit_tiled``, ``deposit_2d_auto`` and ``deposit_2d_coherent``;
    every map against the sorted engine's, integrated-map mass, warm walls,
    the bucketed wall split into stage A, append, cleanup and coherent
    render, run counts and pad shares, coherent row statistics before and
    after bucketing, the device's busy share and peak memory; and, on the
    stream the bucketing feeds the coherent engine, the row-prep kernel (bit
    for bit), the coherent deposit kernel and the sorted-engine kernel on
    each routed tail level, each against its plain version.

Every phase prints one JSON line; the kernels' summary line and the card's
``nvidia-smi`` line come before the last line, which is
``{"ok": true, "device": {...}}``. Each kernel's ``bound_ms`` is the least
time the card could take for the same work on that case's inputs: the larger
of the bytes it must move (each input read once, each output written once)
over the memory rate and its FP32 operations over the FP32 rate, at the
H100 SXM data-sheet peaks below.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
REL_TOL = 1e-5  # kernel vs plain and vs oracle: max|a - b| <= 1e-5 * max|b|
MASS_TOL = 5e-3  # integrated projection mass conservation
MAIN_LOG2N = 26  # main path: 2^26 particles (EAGLE Ref-L0025N0376's 376^3 gas fits)
PATH_TOL = 2e-5  # whole-engine f32 runs (fused vs binned/dense oracles): twice REL_TOL
SIGHT_N = 10_000_000  # config 4: 10^7 gas particles ...
SIGHT_RAYS = 10_000  # ... and 10^4 rays (BASELINE.json config 4)
SIGHT_BOX = 25.0  # cMpc, periodic
GAMMA_LYA = 6.265e8  # H I Lya damping rate, 1/s
VOX_LOG2N = 24  # config 3: 2^24 = 16.8M particles ...
VOX_GRID = 512  # ... on a 512^3 periodic cube (BASELINE.json config 3)
VOX_BOX = 25.0  # cMpc
RAND_LOG2N = 27  # phases 16-17: 2^27 shuffled particles (northstar_proxy.py --order random)
# H100 SXM data-sheet peaks (dense, at 700 W), for bound_ms
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def pair_ops(n_fields: int, projection: str = "kernel3d") -> int:
    """FP32 operations per (particle, sample point) pair inside a support,
    counted from the kernels' arithmetic: the offsets and q^2 (6), sqrt and
    the spline polynomial (6) or, for the line-integrated kernel, the
    44-step Clenshaw recurrence (3 each) and its argument (8); one
    multiply-add per field."""
    return (12 if projection == "kernel3d" else 140) + 2 * n_fields


def support_points(h, support_factor: float, cell: float, dim: int) -> float:
    """Expected number of sample points (pixels, voxels) inside the particles'
    supports: a disc or ball of radius s = support_factor * h / cell holds
    pi s^2 or 4/3 pi s^3 lattice points on average over its sub-cell
    offset."""
    s = support_factor * h.double() / cell
    return float((math.pi * s * s if dim == 2 else (4.0 / 3.0) * math.pi * s ** 3).sum())


def bound(moved_bytes: float, ops: float) -> dict:
    """Least time on the card for ``moved_bytes`` and ``ops`` FP32
    operations, and which of the two sets it."""
    t_bytes = moved_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": moved_bytes, "bound_ops": ops}


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


def clustered_particles(n: int, box: float, npix: int, seed: int, device, order: str = "morton"):
    """Clustered particles with density-correlated lognormal h (median ~0.5
    px, clipped into the K=64 level), as the JAX package's
    ``benchmarks/northstar_proxy.py::build_particles`` draws them, with a
    ``torch.Generator`` for the per-particle draws. ``order="morton"``
    sweeps the cells along the Morton curve (snapshot-like order);
    ``order="random"`` draws each particle's cell iid from the same density
    (inverse CDF), the incoherent worst case. Returns x, y, h, m, T."""
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
    if order == "random":
        u01 = torch.rand(n, generator=g, device=device)
    else:
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
                    **bound(nbytes(*args, got), support_points(args[2], 2.0, 25.0 / 1024, 2)
                            * pair_ops(n_fields, projection)),
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


def _prep_vs_plain(torch, name, spec, cx, cy, ch, cv):
    """One case of kernel #3 (row prep) vs its plain version, bit for bit,
    on whole 2048-lane rows."""
    from astro_sph_tools_tpu_torch.ops.coherent_prep import _prep_rows, prep_rows, prep_rows_plain

    TC = _coherent_module()
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
        # assignment arithmetic: about 40 operations a particle
        **bound(nbytes(cx, cy, ch, cv, packed, aux), 40.0 * cx.shape[0]),
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
    return case


def phase_prep(torch, device, particles):
    """Kernel #3 (row prep) vs its plain version: bit for bit."""
    from astro_sph_tools_tpu_torch.ops import MapSpec

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
    return [_prep_vs_plain(torch, name, spec, cx, cy, ch, cv) for name, spec, cx, cy, ch, cv in cases]


def _coherent_vs_plain(torch, lay, spec, h, projection, plain_reps: int, **tags):
    """Kernel #2 (coherent deposit) vs its plain version on a coherent
    layout's candidates; ``h`` is the layout's particles' smoothing lengths
    (for the bound)."""
    TC = _coherent_module()
    g0 = lay.geom0
    n_fields = lay.n_fields
    psy, psx = spec.pixel_size
    tr = torch.arange(g0.n_tiles, dtype=torch.int32, device=lay.cand_tile.device)
    per_tile = torch.searchsorted(lay.cand_tile, tr, right=True) - torch.searchsorted(lay.cand_tile, tr)
    kw = dict(n_fields=n_fields, n_tiles=g0.n_tiles, cfg=g0.cfg, kernel="cubic_spline",
              projection=projection, psx=psx, psy=psy, offset=spec.sample_offset)
    args = (lay.packed, lay.cand_tile, lay.cand_row)
    got = TC.deposit_coherent_tiles(*args, **kw)
    ref = TC.deposit_coherent_tiles_plain(*args, **kw)
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    del ref
    case = {
        "phase": "coherent_kernel_vs_plain", **tags, "F": n_fields, "projection": projection,
        "n_candidates": lay.n_cand, "n_tiles": g0.n_tiles,
        "max_candidates_per_tile": int(per_tile.max()),
        "mean_candidates_per_tile": lay.n_cand / g0.n_tiles,
        "max_abs_err": err, "rel_err": rel,
        "ms": cuda_ms(lambda: TC.deposit_coherent_tiles(*args, **kw), 5),
        "plain_ms": cuda_ms(lambda: TC.deposit_coherent_tiles_plain(*args, **kw), plain_reps),
        **bound(nbytes(*args, got), support_points(h, 2.0, psx, 2) * pair_ops(n_fields, projection)),
    }
    emit(case)
    check(bool(torch.isfinite(got).all()), f"non-finite coherent kernel output {case}")
    check(rel <= REL_TOL, f"coherent kernel disagrees with its plain version: {case}")
    return case


def phase_coherent_kernel(torch, device, particles):
    """Kernel #2 (coherent deposit) vs its plain version on the main path's layout."""
    from astro_sph_tools_tpu_torch.ops import MapSpec, tile_particles_coherent

    x, y, h, m, t, box = particles
    spec = MapSpec(shape=(1024, 1024), extent=(0.0, box, 0.0, box), periodic_wrap=True)
    all_fields = [m, m * t, t, 2.0 * m]
    out = []
    for n_fields in (1, 2, 4):
        lay = tile_particles_coherent(x, y, h, torch.stack(all_fields[:n_fields]), spec, device=device)
        for projection in ("kernel3d", "integrated"):
            out.append(_coherent_vs_plain(torch, lay, spec, h, projection, 3))
        del lay
    return out


def _tail_levels_vs_plain(torch, lay, spec, **tags):
    """Kernel #1 (sorted-engine deposit) vs its plain version on each level
    of a coherent layout's routed tail, as the coherent render launches it."""
    from astro_sph_tools_tpu_torch.ops.deposit_tiled import deposit_tiles, deposit_tiles_plain

    TC = _coherent_module()
    psy, psx = spec.pixel_size
    kw = dict(kernel="cubic_spline", projection="kernel3d", psx=psx, psy=psy, offset=spec.sample_offset)
    tu, tv, th, t_values, skey = lay.tail
    out = []
    for li, geom, lo, count in lay.tail_metas:
        pstart, pcount = TC._tail_level_ranges(skey, lay.bases[li], geom, None)
        args = (tu, tv, th, t_values, pstart, pcount)
        got = deposit_tiles(*args, cfg=geom.cfg, **kw)
        ref = deposit_tiles_plain(*args, cfg=geom.cfg, **kw)
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        del ref
        sl = slice(lo, lo + count)
        case = {
            "phase": "kernel_vs_plain", **tags, "K": geom.cfg.K, "F": lay.n_fields, "projection": "kernel3d",
            "n": count, "n_tiles": geom.n_tiles, "max_pcount": int(pcount.max()),
            "max_abs_err": err, "rel_err": rel,
            "ms": cuda_ms(lambda: deposit_tiles(*args, cfg=geom.cfg, **kw), 5),
            "plain_ms": cuda_ms(lambda: deposit_tiles_plain(*args, cfg=geom.cfg, **kw), 1),
            **bound(nbytes(tu[sl], tv[sl], th[sl], t_values[:, sl], pstart, pcount, got),
                    support_points(th[sl], 2.0, psx, 2) * pair_ops(lay.n_fields)),
        }
        emit(case)
        check(bool(torch.isfinite(got).all()), f"non-finite tail-level kernel output {case}")
        check(rel <= REL_TOL, f"tail-level kernel disagrees with its plain version: {case}")
        out.append(case)
        del got
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


# ---------------------------------------------------------------------------
# config 4: sightline columns and absorption spectra
# ---------------------------------------------------------------------------


def sightline_particles(torch, device, n: int, box: float, seed: int):
    """Clustered gas particles in a periodic 3D box, drawn as
    ``clustered_particles`` draws its 2D ones: a blob-mixture density on a
    64^3 cell grid (point masses smoothed with periodic FFT Gaussians at
    three scales), cells sampled by density, uniform within a cell. h
    follows the local density (1.2 mean spacings at the mean density,
    ``(rho / mean)^(-1/3)``) with a lognormal scatter; v_pec, T and the
    masses are drawn per particle with a ``torch.Generator``. Returns
    (pos (n, 3), h, m, v_pec, T) on ``device``, f32."""
    grid = 64
    rng = np.random.default_rng(seed)
    dens = np.zeros((grid, grid, grid))
    f = np.fft.fftfreq(grid)
    k2 = f[:, None, None] ** 2 + f[None, :, None] ** 2 + f[None, None, :] ** 2
    for n_blobs, sig_cells in ((3000, 1.0), (6000, 2.0), (2000, 4.0)):
        idx = rng.integers(0, grid, (3, n_blobs))
        point = np.zeros((grid, grid, grid))
        np.add.at(point, tuple(idx), np.exp(rng.normal(0.0, 1.0, n_blobs)))
        dens += np.real(np.fft.ifftn(np.fft.fftn(point) * np.exp(-2.0 * (np.pi * sig_cells) ** 2 * k2)))
    dens = np.maximum(dens, 0.0) ** 1.5
    dens = (dens + 0.02 * dens.mean()).reshape(-1)
    cum = np.cumsum(dens / dens.sum())

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    cell = torch.searchsorted(
        torch.as_tensor(cum, dtype=torch.float32, device=device),
        torch.rand(n, generator=g, device=device),
    ).clamp_(0, grid ** 3 - 1)
    cw = box / grid
    ijk = torch.stack([cell // (grid * grid), (cell // grid) % grid, cell % grid], dim=1).float()
    pos = (ijk + torch.rand((n, 3), generator=g, device=device)) * cw
    rho = torch.as_tensor(dens / dens.mean(), dtype=torch.float32, device=device)[cell]
    del cell, ijk
    h = 1.2 * (box / n ** (1.0 / 3.0)) * rho ** (-1.0 / 3.0)
    h = torch.clamp(h * torch.exp(0.25 * torch.randn(n, generator=g, device=device)), 0.005, 1.5)
    m = 1.81e6 * (0.9 + 0.2 * torch.rand(n, generator=g, device=device))
    v_pec = 100.0 * torch.randn(n, generator=g, device=device)
    T = 10.0 ** torch.clamp(4.3 + 0.6 * torch.randn(n, generator=g, device=device), 3.5, 7.0)
    return pos, h, m, v_pec, T


def sightline_setup(torch, device, n: int):
    """Phase 10-12's particles, rays and cosmology (z = 0.5)."""
    from astro_sph_tools_tpu_torch.data_structures import Cosmology

    t0 = time.perf_counter()
    pos, h, m, v_pec, T = sightline_particles(torch, device, n, SIGHT_BOX, seed=17)
    torch.cuda.synchronize()
    rng = np.random.default_rng(8)
    rx = rng.uniform(0.0, SIGHT_BOX, SIGHT_RAYS)
    ry = rng.uniform(0.0, SIGHT_BOX, SIGHT_RAYS)
    cosmo = Cosmology.from_redshift(0.5, 0.6777, 0.04825)
    return {"pos": pos, "h": h, "m": m, "v_pec": v_pec, "T": T, "rx": rx, "ry": ry,
            "cosmology": cosmo, "generate_s": time.perf_counter() - t0}


def phase_columns_kernel(torch, device, sl, n_rays: int = 2048):
    """Kernel #4 vs its plain version on the fused layout of the config-4
    particles."""
    from astro_sph_tools_tpu_torch.ops.sightlines_fused import (
        _columns_layout, columns_tiles, columns_tiles_plain,
    )

    pos, h, m, T, v = sl["pos"], sl["h"], sl["m"], sl["T"], sl["v_pec"]
    fields5 = torch.stack([m, m * T, m * v, h, T], dim=1)
    rx, ry = sl["rx"][:n_rays], sl["ry"][:n_rays]
    # expected (ray, particle) pairs inside a support, rays uniform over the box
    hits = support_points(h, 2.0, 1.0, 2) * n_rays / SIGHT_BOX**2
    out = []
    for periodic in (True, False):
        for n_fields in (1, 5):
            lay, _, _ = _columns_layout(
                pos[:, 0], pos[:, 1], h, fields5[:, :n_fields], rx, ry, kernel="cubic_spline",
                periodic_box=SIGHT_BOX if periodic else None, device=device,
            )
            args = (lay.packed, lay.rx, lay.ry, lay.lo, lay.hi)
            spans = (lay.hi - lay.lo).clamp_min(0).sum(dim=1)
            for projection in ("kernel3d", "integrated"):
                kw = dict(n_fields=n_fields, kernel="cubic_spline", projection=projection,
                          periodic=lay.periodic, Lx=lay.Lx, Ly=lay.Ly)
                got = columns_tiles(*args, **kw)
                ref = columns_tiles_plain(*args, **kw)
                torch.cuda.synchronize()
                err, rel = rel_err(got, ref)
                case = {
                    "phase": "columns_kernel_vs_plain", "projection": projection, "periodic": periodic,
                    "F": n_fields, "n": pos.shape[0], "n_rays": n_rays, "n_blocks": lay.n_blocks,
                    "n_levels": len(lay.rorders), "pairs_scanned": int(spans.sum()) * 8,
                    "max_span_particles": int(spans.max()), "max_abs_err": err, "rel_err": rel,
                    "ms": cuda_ms(lambda: columns_tiles(*args, **kw), 5),
                    "plain_ms": cuda_ms(lambda: columns_tiles_plain(*args, **kw), 3),
                    **bound(nbytes(*args, got), hits * pair_ops(n_fields, projection)),
                }
                emit(case)
                check(bool(torch.isfinite(got).all()), f"non-finite column kernel output {case}")
                check(rel <= REL_TOL, f"column kernel disagrees with its plain version: {case}")
                out.append(case)
            del lay, args
    return out


def phase_spectra_kernel(torch, device, sl, n_rays: int = 256, n_bins: int = 512):
    """Kernel #5 vs its plain version on the fused layout of the config-4
    particles."""
    from astro_sph_tools_tpu_torch.ops.spectra import _resolve_profile
    from astro_sph_tools_tpu_torch.ops.spectra_fused import _spectra_layout, spectra_tiles, spectra_tiles_plain

    hits = support_points(sl["h"], 2.0, 1.0, 2) * n_rays / SIGHT_BOX**2
    out = []
    for periodic in (True, False):
        for profile in ("gaussian", "voigt"):
            lay, vc, v_box, n_images = _spectra_layout(
                sl["pos"], sl["h"], sl["m"], sl["v_pec"], sl["T"], sl["rx"][:n_rays], sl["ry"][:n_rays],
                cosmology=sl["cosmology"], box_size=SIGHT_BOX, atomic_weight=1.008, n_bins=n_bins,
                kernel="cubic_spline", periodic=periodic, profile=profile, device=device,
            )
            vc_t = torch.as_tensor(vc, device=device)
            args = (lay.packed, lay.rx, lay.ry, lay.lo, lay.hi, vc_t)
            kw = dict(kernel="cubic_spline", periodic=lay.periodic, Lx=lay.Lx, Ly=lay.Ly, v_box=v_box,
                      n_images=n_images, profile=profile,
                      voigt_k=_resolve_profile(profile, GAMMA_LYA, 1215.67))
            got = spectra_tiles(*args, **kw)
            ref = spectra_tiles_plain(*args, **kw)
            torch.cuda.synchronize()
            err, rel = rel_err(got, ref)
            spans = (lay.hi - lay.lo).clamp_min(0).sum(dim=1)
            case = {
                "phase": "spectra_kernel_vs_plain", "profile": profile, "periodic": periodic,
                "n": sl["pos"].shape[0], "n_rays": n_rays, "n_bins": n_bins, "n_blocks": lay.n_blocks,
                "n_levels": len(lay.rorders), "velocity_images": n_images,
                "particles_scanned": int(spans.sum()), "max_abs_err": err, "rel_err": rel,
                "ms": cuda_ms(lambda: spectra_tiles(*args, **kw), 3),
                "plain_ms": cuda_ms(lambda: spectra_tiles_plain(*args, **kw), 1),
                # each hit's profile at every bin and image: ~10 operations
                # for a Gaussian, ~60 for the Voigt fit, plus the tau FMA
                **bound(nbytes(*args, got), hits * n_bins * n_images * (12 if profile == "gaussian" else 62)),
            }
            emit(case)
            check(bool(torch.isfinite(got).all()), f"non-finite spectra kernel output {case}")
            check(rel <= REL_TOL, f"spectra kernel disagrees with its plain version: {case}")
            out.append(case)
            del lay, args
    return out


def phase_sightlines(torch, device, sl, n_check: int = 256, n_bins: int = 512):
    """The config-4 path at full size: columns and spectra (Gaussian and
    Voigt) through the fused engines."""
    from astro_sph_tools_tpu_torch.ops import (
        absorption_spectra, absorption_spectra_binned, absorption_spectra_pallas, column_integrate_binned,
        column_integrate_pallas,
    )
    from astro_sph_tools_tpu_torch.ops.sightlines_fused import _columns_layout, columns_tiles
    from astro_sph_tools_tpu_torch.ops.spectra import _resolve_profile
    from astro_sph_tools_tpu_torch.ops.spectra_fused import _spectra_layout, spectra_tiles

    pos, h, m, v, T, rx, ry = (sl[k] for k in ("pos", "h", "m", "v_pec", "T", "rx", "ry"))
    x, y = pos[:, 0].contiguous(), pos[:, 1].contiguous()
    cosmo = sl["cosmology"]
    n, n_rays = pos.shape[0], rx.shape[0]
    cols_fn = lambda: column_integrate_pallas(x, y, h, m, rx, ry, periodic_box=SIGHT_BOX, device=device)
    spec_kw = dict(cosmology=cosmo, box_size=SIGHT_BOX, n_bins=n_bins, device=device)
    voigt_kw = dict(profile="voigt", gamma=GAMMA_LYA)
    gauss_fn = lambda: absorption_spectra_pallas(pos, h, m, v, T, rx, ry, **spec_kw)
    voigt_fn = lambda: absorption_spectra_pallas(pos, h, m, v, T, rx, ry, **spec_kw, **voigt_kw)
    torch.cuda.reset_peak_memory_stats()

    # the main path, once, with both launch counts reset just before it
    columns_tiles.launches = spectra_tiles.launches = 0
    cols = cols_fn()
    tau_g, vc = gauss_fn()
    tau_v, _ = voigt_fn()
    torch.cuda.synchronize()
    launches = {"sightline_columns": columns_tiles.launches, "sightline_spectra": spectra_tiles.launches}

    for name, a, shape in (("columns", cols, (n_rays,)), ("gaussian", tau_g, (n_rays, n_bins)),
                           ("voigt", tau_v, (n_rays, n_bins))):
        check(tuple(a.shape) == shape and bool(torch.isfinite(a).all()), f"bad {name} output {tuple(a.shape)}")
    check(float(cols.min()) >= 0.0 and float(cols.max()) > 0.0, "column densities empty or negative")

    walls = {
        "columns": wall_s(cols_fn, 3),
        "spectra_gaussian": wall_s(gauss_fn, 3),
        "spectra_voigt": wall_s(voigt_fn, 3),
    }
    busy_cols, prof_cols = device_busy_ms(cols_fn)
    busy_g, prof_g = device_busy_ms(gauss_fn)
    busy_v, prof_v = device_busy_ms(voigt_fn)

    # the walls split: layout (device sort + host ray schedule) and kernel
    col_layout = lambda: _columns_layout(x, y, h, m, rx, ry, kernel="cubic_spline", periodic_box=SIGHT_BOX,
                                         device=device)
    spec_layout = lambda prof: _spectra_layout(
        pos, h, m, v, T, rx, ry, cosmology=cosmo, box_size=SIGHT_BOX, atomic_weight=1.008, n_bins=n_bins,
        kernel="cubic_spline", periodic=True, profile=prof, device=device)
    layout_s = {"columns": wall_s(col_layout, 3), "spectra": wall_s(lambda: spec_layout("gaussian"), 3)}
    lay = col_layout()[0]
    kernel_ms = {"columns": cuda_ms(lambda: columns_tiles(
        lay.packed, lay.rx, lay.ry, lay.lo, lay.hi, n_fields=1, kernel="cubic_spline",
        projection="integrated", periodic=True, Lx=lay.Lx, Ly=lay.Ly), 3)}
    for prof in ("gaussian", "voigt"):
        lay, vc_np, v_box, n_img = spec_layout(prof)
        vc_t = torch.as_tensor(vc_np, device=device)
        kernel_ms[f"spectra_{prof}"] = cuda_ms(lambda: spectra_tiles(
            lay.packed, lay.rx, lay.ry, lay.lo, lay.hi, vc_t, kernel="cubic_spline", periodic=True,
            Lx=lay.Lx, Ly=lay.Ly, v_box=v_box, n_images=n_img, profile=prof,
            voigt_k=_resolve_profile(prof, GAMMA_LYA, 1215.67)), 3)
    del lay

    # the velocity integral of each spectrum is its column (unit-integral
    # profiles; bins cover the box's velocity extent)
    dv = float(vc[1] - vc[0])
    live = cols > 1e-3 * cols.max()
    flux_err = float(((tau_g.sum(dim=1) * dv - cols).abs() / cols)[live].max())

    # oracles: the binned engines on the first n_check rays, the dense
    # spectra engine on a 2^20-particle subset
    rs = slice(0, n_check)
    errs = {}
    ref = column_integrate_binned(x, y, h, m, rx[rs], ry[rs], periodic_box=SIGHT_BOX, device=device)
    errs["columns_vs_binned"] = rel_err(cols[rs], ref)
    for name, tau, kw in (("gaussian", tau_g, {}), ("voigt", tau_v, voigt_kw)):
        ref, _ = absorption_spectra_binned(pos, h, m, v, T, rx[rs], ry[rs], **spec_kw, **kw)
        errs[f"{name}_vs_binned"] = rel_err(tau[rs], ref)
        sub = 1 << 20
        got, _ = absorption_spectra_pallas(pos[:sub], h[:sub], m[:sub], v[:sub], T[:sub], rx[rs], ry[rs],
                                           **spec_kw, **kw)
        ref, _ = absorption_spectra(pos[:sub], h[:sub], m[:sub], v[:sub], T[:sub], rx[rs], ry[rs],
                                    **spec_kw, **kw)
        errs[f"{name}_vs_dense_2^20"] = rel_err(got, ref)
    out = {
        "phase": "sightlines_path", "n": n, "n_rays": n_rays, "n_bins": n_bins, "box_cMpc": SIGHT_BOX,
        "redshift": cosmo.redshift, "generate_s": sl["generate_s"], "launches": launches,
        "wall_s": walls, "rays_per_s_columns": n_rays / walls["columns"], "layout_s": layout_s,
        "kernel_ms": kernel_ms,
        "profiled_wall_ms": {"columns": prof_cols, "spectra_gaussian": prof_g, "spectra_voigt": prof_v},
        "device_busy_ms": {"columns": busy_cols, "spectra_gaussian": busy_g, "spectra_voigt": busy_v},
        "device_idle_share": {
            k: (None if b is None else 1.0 - b / w)
            for k, b, w in (("columns", busy_cols, prof_cols), ("spectra_gaussian", busy_g, prof_g),
                            ("spectra_voigt", busy_v, prof_v))
        },
        "h_range": [float(h.min()), float(h.max())],
        "column_flux_rel_err": flux_err,
        "max_abs_err": max(e for e, _ in errs.values()),
        "rel_err": {k: r for k, (_, r) in errs.items()},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
    }
    emit(out)
    check(all(c > 0 for c in launches.values()), f"a sightline kernel was not launched: {launches}")
    check(flux_err < 2e-2, f"spectra lose their columns: {flux_err}")
    bad = {k: r for k, (_, r) in errs.items() if not r <= PATH_TOL}
    check(not bad, f"config-4 path off its oracles: {bad}")
    return out


# ---------------------------------------------------------------------------
# config 3: the 3D voxel deposit
# ---------------------------------------------------------------------------


def _voxel_level_inputs(torch, cfg, lo_s, hi_s, n_fields, n, spec, seed, device):
    """Tile-sorted tile-local inputs of one 3D level, h inside (lo_s, hi_s]
    voxels; positions reach 2 % past each face of the box (wrapped on a
    periodic grid, clipped into the edge tiles on an open one)."""
    from astro_sph_tools_tpu_torch.ops.deposit_tiled import _tile_ranges
    from astro_sph_tools_tpu_torch.ops.grid3d_tiled import _geometry_3d, _multi_level_assign_3d, _voxel_coords

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    box = spec.extent[1]
    vox = box / spec.shape[2]
    pos = (1.04 * torch.rand((n, 3), generator=g, device=device) - 0.02) * box
    s_vox = lo_s + (hi_s - lo_s) * (1.0 - torch.rand(n, generator=g, device=device))
    h = s_vox * vox / 2.0
    vals = 0.5 + 1.5 * torch.rand((n_fields, n), generator=g, device=device)
    geom = _geometry_3d(cfg, spec.shape)
    u, v, w = _voxel_coords(pos, spec)
    _, tile, ul, vl, wl = _multi_level_assign_3d(u, v, w, torch.zeros_like(u), (math.inf,), (geom,))
    tile, perm = torch.sort(tile, stable=True)
    pstart, pcount = _tile_ranges(tile, geom.n_tiles)
    return geom, (ul[perm], vl[perm], wl[perm], h[perm], vals[:, perm].contiguous(), pstart, pcount)


def phase_voxel_kernel(torch, device, n: int = 1 << 18, npix: int = 256):
    """Kernel #6 (3D voxel deposit) vs its plain version, every level."""
    from astro_sph_tools_tpu_torch.ops import PALLAS_3D_LEVELS, GridSpec
    from astro_sph_tools_tpu_torch.ops.grid3d_tiled import _level_args, deposit_3d_tiles, deposit_3d_tiles_plain

    bounds = [0.05] + [cfg.max_s_vox for cfg in PALLAS_3D_LEVELS]
    vox = VOX_BOX / npix
    out = []
    for li, cfg in enumerate(PALLAS_3D_LEVELS):
        for n_fields in (1, 4):
            for periodic in (True, False):
                spec = GridSpec(shape=(npix,) * 3, extent=(0.0, VOX_BOX) * 3, periodic_wrap=periodic)
                geom, args = _voxel_level_inputs(
                    torch, cfg, bounds[li], bounds[li + 1], n_fields, n, spec,
                    seed=200 + 10 * li + n_fields + 5 * periodic, device=device,
                )
                kw = _level_args(geom, spec, "cubic_spline")
                got = torch.zeros((n_fields, *spec.shape), device=device)
                ref = torch.zeros_like(got)
                deposit_3d_tiles(*args, got, **kw)
                deposit_3d_tiles_plain(*args, ref, **kw)
                torch.cuda.synchronize()
                err, rel = rel_err(got, ref)
                case = {
                    "phase": "voxel_kernel_vs_plain", "K": cfg.K, "F": n_fields, "periodic": periodic,
                    "grid": [npix] * 3, "n": n, "n_tiles": geom.n_tiles,
                    "max_pcount": int(args[6].max()), "max_abs_err": err, "rel_err": rel,
                    "ms": cuda_ms(lambda: deposit_3d_tiles(*args, got, **kw), 5),
                    "plain_ms": cuda_ms(lambda: deposit_3d_tiles_plain(*args, ref, **kw), 3),
                    **bound(nbytes(*args, got), support_points(args[3], 2.0, vox, 3) * pair_ops(n_fields)),
                }
                emit(case)
                check(bool(torch.isfinite(got).all()), f"non-finite 3D kernel output {case}")
                check(rel <= REL_TOL, f"3D kernel disagrees with its plain version: {case}")
                out.append(case)
                del got, ref, args
    return out


def voxel_particles(torch, device, n: int, box: float, seed: int):
    """The JAX package's ``benchmarks/voxel3d_bench.py::build_particles``
    with a ``torch.Generator``: 60 % of the particles in 256 Gaussian blobs
    (sigma 1-5 % of the box), 40 % uniform; lognormal h (median 0.15 % of
    the box in blobs, 0.6 % outside, sigma_ln 0.35). Adds m ~ U(0.5, 2) and
    v ~ N(0, 100 km/s) per axis. Returns (pos (n, 3), h, m, v (n, 3))."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    n_blob = int(0.6 * n)
    n_bg = n - n_blob
    n_groups = 256
    centres = torch.rand((n_groups, 3), generator=g, device=device) * box
    sigma = (0.01 + 0.04 * torch.rand(n_groups, generator=g, device=device)) * box
    gidx = torch.randint(0, n_groups, (n_blob,), generator=g, device=device)
    pos_blob = centres[gidx] + torch.randn((n_blob, 3), generator=g, device=device) * sigma[gidx][:, None]
    pos_bg = torch.rand((n_bg, 3), generator=g, device=device) * box
    pos = torch.remainder(torch.cat([pos_blob, pos_bg]), box)
    del pos_blob, pos_bg, gidx
    h = torch.exp(torch.cat([
        math.log(0.0015 * box) + 0.35 * torch.randn(n_blob, generator=g, device=device),
        math.log(0.006 * box) + 0.35 * torch.randn(n_bg, generator=g, device=device),
    ]))
    m = 0.5 + 1.5 * torch.rand(n, generator=g, device=device)
    v = 100.0 * torch.randn((n, 3), generator=g, device=device)
    return pos, h, m, v


def phase_voxel(torch, device, n_log2: int):
    """The config-3 path at full size: ``deposit_3d_auto`` into 512^3 x 4."""
    from astro_sph_tools_tpu_torch.ops import GridSpec, deposit_3d, deposit_3d_auto, deposit_3d_tiled, tile_particles_3d
    from astro_sph_tools_tpu_torch.ops.deposit_tiled import _tile_ranges
    from astro_sph_tools_tpu_torch.ops.grid3d_tiled import _level_args, deposit_3d_tiles, deposit_3d_tiles_plain

    n = 1 << n_log2
    ng = VOX_GRID
    vox = VOX_BOX / ng
    spec = GridSpec(shape=(ng,) * 3, extent=(0.0, VOX_BOX) * 3, periodic_wrap=True)
    t0 = time.perf_counter()
    pos, h, m, v = voxel_particles(torch, device, n, VOX_BOX, seed=11)
    # max_s_vox(K = 16) / support_factor: every particle fits the K = 16 level
    h = torch.clamp(h, max=3.5 * vox)
    fields = torch.stack([m, m * v[:, 0], m * v[:, 1], m * v[:, 2]])
    del v
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()

    # the main path, once, with the launch count reset just before it
    deposit_3d_tiles.launches = 0
    cube = deposit_3d_auto(pos, h, fields, spec, device=device)
    torch.cuda.synchronize()
    launches = deposit_3d_tiles.launches
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    check(tuple(cube.shape) == (4, ng, ng, ng), f"output shape {tuple(cube.shape)}")
    check(bool(torch.isfinite(cube).all()), "non-finite cube")
    mass_ratio = float(cube[0].double().sum()) * vox**3 / float(m.double().sum())
    del cube

    # each level's kernel against its plain version at full size (dense
    # tiles split over many blocks), then its time
    tp = tile_particles_3d(pos, h, fields, spec, device=device)
    levels = []
    for geom, lo, count in tp.geoms:
        sl = slice(lo, lo + count)
        pstart, pcount = _tile_ranges(tp.sorted_tile[sl], geom.n_tiles)
        args = (tp.sorted_u[sl], tp.sorted_v[sl], tp.sorted_w[sl], tp.sorted_h[sl], tp.sorted_values[:, sl],
                pstart, pcount)
        got = torch.zeros((4, ng, ng, ng), device=device)
        ref = torch.zeros_like(got)
        kw = _level_args(geom, spec, "cubic_spline")
        deposit_3d_tiles(*args, got, **kw)
        plain_ms = cuda_ms(lambda: deposit_3d_tiles_plain(*args, ref, **kw), 1)
        err_l, rel_l = rel_err(got, ref)
        del ref
        levels.append({
            "K": geom.cfg.K, "count": count, "share": count / n, "n_tiles": geom.n_tiles,
            "occupied_tiles": int((pcount > 0).sum()), "max_pcount": int(pcount.max()),
            "max_abs_err": err_l, "rel_err": rel_l, "plain_ms": plain_ms,
            "kernel_ms": cuda_ms(lambda: deposit_3d_tiles(*args, got, **kw), 3),
            **bound(nbytes(*args, got), support_points(args[3], 2.0, vox, 3) * pair_ops(4)),
        })
        del got, args
    check(tp.n_oversize == 0, f"{tp.n_oversize} oversize particles on the config-3 path")
    check(launches >= len(tp.geoms) > 0, f"{launches} kernel launches for {len(tp.geoms)} levels")

    auto = lambda: deposit_3d_auto(pos, h, fields, spec, device=device)
    wall = wall_s(auto, 3)
    layout_s = wall_s(lambda: tile_particles_3d(pos, h, fields, spec, device=device), 3)
    deposit_s = wall_s(lambda: deposit_3d_tiled(tp), 3)
    busy_ms, prof_wall_ms = device_busy_ms(auto)
    n_oversize = tp.n_oversize
    del tp

    # the plain stencil engine on a strided 2^20 subset (blobs and background)
    stride = max(1, n >> 20)
    ps, hs, fs = pos[::stride].contiguous(), h[::stride].contiguous(), fields[:, ::stride].contiguous()
    got = deposit_3d_auto(ps, hs, fs, spec, device=device)
    ref = deposit_3d(ps, hs, fs.T, spec, device=device).permute(3, 0, 1, 2)
    err, rel = rel_err(got, ref)
    del got, ref

    # the oversize route: 64^3, some footprints past the K = 16 level
    g = torch.Generator(device=device)
    g.manual_seed(12)
    small = GridSpec(shape=(64,) * 3, extent=(0.0, VOX_BOX) * 3, periodic_wrap=True)
    pv = VOX_BOX / 64
    po = torch.rand((20000, 3), generator=g, device=device) * VOX_BOX
    ho = pv * 10.0 ** (-0.7 + 1.4 * torch.rand(20000, generator=g, device=device))  # s up to 10 voxels
    fo = torch.stack([fields[0, :20000], fields[1, :20000]])
    n_over = tile_particles_3d(po, ho, fo, small, device=device).n_oversize
    got = deposit_3d_auto(po, ho, fo, small, device=device)
    ref = deposit_3d(po, ho, fo.T, small, device=device).permute(3, 0, 1, 2)
    err_o, rel_o = rel_err(got, ref)

    out = {
        "phase": "voxel_path", "n": n, "grid": [ng] * 3, "box_cMpc": VOX_BOX, "fields": 4,
        "h_cap_voxels": 3.5, "generate_s": gen_s, "launches": launches, "levels": levels,
        "n_oversize": n_oversize, "wall_s": wall, "layout_s": layout_s, "deposit_s": deposit_s,
        "deposits_per_s": n / wall, "profiled_wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": None if busy_ms is None else 1.0 - busy_ms / prof_wall_ms,
        "density_mass_ratio": mass_ratio, "peak_mem_gb": peak_gb,
        "plain_subset_n": ps.shape[0], "plain_subset_max_abs_err": err, "plain_subset_rel_err": rel,
        "oversize_case": {"grid": [64] * 3, "n": 20000, "n_oversize": n_over, "max_abs_err": err_o,
                          "rel_err": rel_o},
    }
    emit(out)
    for lv in levels:
        check(lv["rel_err"] <= REL_TOL, f"3D kernel disagrees with its plain version at full size: {lv}")
    check(rel <= PATH_TOL, f"config-3 path off the plain stencil engine on {ps.shape[0]} particles: {rel}")
    check(n_over > 0, "the oversize case has no oversize particle")
    check(rel_o <= PATH_TOL, f"oversize route off the plain stencil engine: {rel_o}")
    return out


def phase_voxel_tiles(torch, device, n_log2: int):
    """Kernel #6's time per level under other tile geometries, on phase 14's
    particles (the same layout code, only the level's (TZ, TY, TX) differs)."""
    from astro_sph_tools_tpu_torch.ops import PALLAS_3D_LEVELS, GridSpec, Pallas3DConfig, tile_particles_3d
    from astro_sph_tools_tpu_torch.ops.deposit_tiled import _tile_ranges
    from astro_sph_tools_tpu_torch.ops.grid3d_tiled import _level_args, deposit_3d_tiles

    ng = VOX_GRID
    vox = VOX_BOX / ng
    spec = GridSpec(shape=(ng,) * 3, extent=(0.0, VOX_BOX) * 3, periodic_wrap=True)
    pos, h, m, v = voxel_particles(torch, device, 1 << n_log2, VOX_BOX, seed=11)
    h = torch.clamp(h, max=3.5 * vox)
    fields = torch.stack([m, m * v[:, 0], m * v[:, 1], m * v[:, 2]])
    del v
    out = []
    for li in (1, 2):
        ref = None
        for tiles in ((8, 8, 8), (16, 16, 8), (16, 16, 16)):
            levels = list(PALLAS_3D_LEVELS)
            levels[li] = Pallas3DConfig(K=levels[li].K, TZ=tiles[0], TY=tiles[1], TX=tiles[2])
            tp = tile_particles_3d(pos, h, fields, spec, levels=tuple(levels), device=device)
            geom, lo, count = next(g for g in tp.geoms if g[0].cfg.K == levels[li].K)
            sl = slice(lo, lo + count)
            pstart, pcount = _tile_ranges(tp.sorted_tile[sl], geom.n_tiles)
            kw = _level_args(geom, spec, "cubic_spline")
            case = {"phase": "voxel_tile_ab", "K": geom.cfg.K, "tiles_zyx": list(tiles), "count": count,
                    "n_tiles": geom.n_tiles, "max_pcount": int(pcount.max())}
            for n_fields in (1, 4):
                args = (tp.sorted_u[sl], tp.sorted_v[sl], tp.sorted_w[sl], tp.sorted_h[sl],
                        tp.sorted_values[:n_fields, sl], pstart, pcount)
                grid = torch.zeros((n_fields, ng, ng, ng), device=device)
                deposit_3d_tiles(*args, grid, **kw)
                torch.cuda.synchronize()
                if n_fields == 4:
                    if ref is None:
                        ref = grid.clone()
                    case["rel_err_vs_8^3"] = rel_err(grid, ref)[1]
                case[f"ms_F{n_fields}"] = cuda_ms(lambda: deposit_3d_tiles(*args, grid, **kw), 3)
                del grid, args
            emit(case)
            check(case["rel_err_vs_8^3"] <= REL_TOL, f"tile geometries disagree: {case}")
            out.append(case)
            del tp
        del ref
    return out


# ---------------------------------------------------------------------------
# the random-order path: shear grouping, kernel #7, deposit_2d_bucketed
# ---------------------------------------------------------------------------


def random_particles(torch, device, n_log2: int):
    """Phase 16-17's particle set: 2^n_log2 particles with the main path's
    density field, h and fields, each drawn in a random cell (the JAX
    package's ``benchmarks/northstar_proxy.py --order random``)."""
    box = 25.0
    t0 = time.perf_counter()
    x, y, h, m, t = clustered_particles(1 << n_log2, box, 1024, seed=7, device=device, order="random")
    torch.cuda.synchronize()
    return (x, y, h, m, t, box), time.perf_counter() - t0


def _map_spec(box):
    from astro_sph_tools_tpu_torch.ops import MapSpec

    return MapSpec(shape=(1024, 1024), extent=(0.0, box, 0.0, box), periodic_wrap=True)


def _shear_stage_a_inputs(torch, grouping: str, particles):
    """(ops, n_keys, assign) of stage A for the coarse bucketing (as
    ``shear_coarse_group`` feeds it) or the fine level/tile key space at
    1024^2 (as ``tile_particles(layout="shear")`` feeds it, perm included)."""
    from astro_sph_tools_tpu_torch.kernels.splines import get_kernel
    from astro_sph_tools_tpu_torch.ops import PALLAS_LEVELS
    from astro_sph_tools_tpu_torch.ops import layout_shear as LS
    from astro_sph_tools_tpu_torch.ops.deposit_tiled import _assign_setup, _shear_assign

    x, y, h, m, t, box = particles
    spec = _map_spec(box)
    fields = [m, m * t]
    if grouping == "coarse":
        assign = LS._cached_coarse_assign((0.0, box, 0.0, box), True, 2, 128)
        return [x, y, h, *fields], 256, assign
    assign, level_n_tiles = _shear_assign(
        spec, get_kernel("cubic_spline").support_factor, *_assign_setup(spec, PALLAS_LEVELS)
    )
    perm = torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
    return [x, y, h, *fields, perm], sum(level_n_tiles) + 1, assign


def phase_append_kernel(torch, device, particles):
    """Kernel #7 (gang append) vs its plain version, bit for bit, on every
    gang of the destination: (a) the coarse grouping of phase 17's input,
    (b) its fine 1024^2 level/tile key space, (c) one key (one giant run per
    band), (d) runs of mostly one record."""
    from astro_sph_tools_tpu_torch.ops import layout_shear as LS

    g = torch.Generator(device=device)
    g.manual_seed(16)
    out = []
    for name in ("coarse", "fine", "single_key", "one_record_runs"):
        if name in ("coarse", "fine"):
            ops, n_keys, assign = _shear_stage_a_inputs(torch, name, particles)
        else:
            n, n_keys = (1 << 24, 1) if name == "single_key" else (1 << 21, 1 << 14)
            key = torch.randint(0, n_keys, (n,), generator=g, device=device, dtype=torch.int32)
            ops = [key] + [torch.rand(n, generator=g, device=device) for _ in range(3)]
            assign = None
        n = ops[0].shape[0]
        gangs, src_gang, _, ngang, cum_ngang, cnt, cum_nsub, _, ng_t, ns_t = LS._shear_stage_a(
            ops, n_keys=n_keys, assign=assign
        )
        del ops
        n_gang, n_sub = LS._host_totals(ng_t, ns_t)
        sched = LS._shear_schedule(src_gang, ngang, cum_ngang, cum_nsub, n_sub)
        got = LS.append_gangs(gangs, sched, n_gang)
        ref = LS.append_gangs_plain(gangs, sched, n_gang)
        src_of_dst, _ = LS._gang_indices(sched, n_gang)  # the schedule is in destination order
        lib = torch.index_select(gangs, 0, src_of_dst)
        torch.cuda.synchronize()
        bad = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
        bad_lib = int((lib.view(torch.int32) != ref.view(torch.int32)).sum())
        channels = gangs.shape[1]
        case = {
            "phase": "append_kernel_vs_plain", "case": name, "n": n, "n_keys": n_keys, "channels": channels,
            "runs": int((cnt > 0).sum()), "n_gang": n_gang, "n_sub": n_sub,
            "pad_share": n_gang * 128 / n - 1.0, "mismatched_words": bad, "mismatched_words_index_select": bad_lib,
            "max_abs_err": float((got - ref).abs().max()) if n_gang else 0.0,
            "ms": cuda_ms(lambda: LS.append_gangs(gangs, sched, n_gang), 5),
            "plain_ms": cuda_ms(lambda: LS.append_gangs_plain(gangs, sched, n_gang), 5),
            "library_ms": cuda_ms(lambda: torch.index_select(gangs, 0, src_of_dst), 5),
            # the source gangs and the schedule read once, the destination
            # written once (runs of one band share their boundary gangs, so
            # with many short runs the destination outgrows the source)
            **bound(nbytes(gangs, sched) + n_gang * channels * 128 * 4, 0.0),
        }
        emit(case)
        check(bad == 0 and bad_lib == 0, f"gang append kernel differs from its plain version: {name}")
        out.append(case)
        del gangs, got, ref, lib, sched, src_of_dst
    return out


def phase_random(torch, device, particles, gen_s):
    """The random-order path at size: ``deposit_2d_bucketed`` (the slice's
    main path), ``tile_particles(layout="shear")`` + ``deposit_tiled``, the
    sorted engine and the synced coherent engine, all on one shuffled input."""
    from astro_sph_tools_tpu_torch.ops import (
        deposit_2d_auto, deposit_2d_coherent, deposit_tiled, tile_particles, tile_particles_coherent,
    )
    from astro_sph_tools_tpu_torch.ops import layout_shear as LS
    from astro_sph_tools_tpu_torch.ops.coherent_prep import prep_rows
    from astro_sph_tools_tpu_torch.ops.deposit_tiled import deposit_tiles

    TC = _coherent_module()
    x, y, h, m, t, box = particles
    n = x.shape[0]
    spec = _map_spec(box)
    fields = torch.stack([m, m * t])
    kernels = (LS.append_gangs, deposit_tiles, prep_rows, TC.deposit_coherent_tiles)
    names = ("append_gangs", "deposit2d", "coherent_prep", "coherent_deposit")

    def reset():
        for k in kernels:
            k.launches = 0

    def read():
        return dict(zip(names, (k.launches for k in kernels)))

    bucketed = lambda: LS.deposit_2d_bucketed(x, y, h, fields, spec, device=device)
    shear = lambda: deposit_tiled(tile_particles(x, y, h, fields, spec, layout="shear", device=device))
    torch.cuda.reset_peak_memory_stats()

    # the main path, once, with every launch count reset just before it
    reset()
    img_b = bucketed()
    torch.cuda.synchronize()
    launches_b = read()
    peak_b = torch.cuda.max_memory_allocated() / 2**30
    reset()
    tp = tile_particles(x, y, h, fields, spec, layout="shear", device=device)
    img_s = deposit_tiled(tp)
    torch.cuda.synchronize()
    launches_s = read()
    shear_layout = {"n_sorted": tp.n_sorted, "pad_share": tp.n_sorted / n - 1.0, "n_oversize": tp.n_oversize,
                    "levels": [{"K": geom.cfg.K, "count": c} for geom, _, c in tp.geoms]}
    del tp
    img_sorted = deposit_2d_auto(x, y, h, fields, spec, device=device)
    img_c = deposit_2d_coherent(x, y, h, fields, spec, device=device)
    errs = {name: rel_err(a, img_sorted) for name, a in
            (("bucketed", img_b), ("shear", img_s), ("coherent", img_c))}
    for name, a in (("bucketed", img_b), ("shear", img_s), ("sorted", img_sorted), ("coherent", img_c)):
        check(tuple(a.shape) == (2, 1024, 1024) and bool(torch.isfinite(a).all()), f"bad {name} map")
    del img_b, img_s, img_c
    coh_stats = tile_particles_coherent(x, y, h, fields, spec, device=device).stats
    integ = LS.deposit_2d_bucketed(x, y, h, fields, spec, projection="integrated", device=device)
    px = box / 1024
    mass = float(m.double().sum())
    mass_err = abs(float(integ[0].double().sum()) * px * px - mass) / mass
    del integ

    walls = {
        "sorted": wall_s(lambda: deposit_2d_auto(x, y, h, fields, spec, device=device), 3),
        "coherent_synced": wall_s(lambda: deposit_2d_coherent(x, y, h, fields, spec, device=device), 3),
        "bucketed": wall_s(bucketed, 3),
        "shear_layout": wall_s(shear, 3),
    }
    # the sorted engine's and the shear path's walls split into layout and deposit
    layout_split = {}
    for layout in ("sort", "shear"):
        build = lambda: tile_particles(x, y, h, fields, spec, layout=layout, device=device)
        tp = build()
        layout_split[layout] = {"layout": wall_s(build, 3), "deposit": wall_s(lambda: deposit_tiled(tp), 3)}
        del tp
    # the bucketed wall split: stage A (with the host read of the totals),
    # the append (schedule + kernel #7), the cleanup, the coherent render
    ops, n_keys, assign = _shear_stage_a_inputs(torch, "coarse", particles)
    stage_a = lambda: LS._shear_stage_a(ops, n_keys=n_keys, assign=assign)
    a_out = stage_a()
    gangs, src_gang, head, ngang, cum_ngang, cnt, cum_nsub, _, ng_t, ns_t = a_out
    n_gang, n_sub = LS._host_totals(ng_t, ns_t)
    append = lambda: LS._shear_append(gangs, src_gang, ngang, cum_ngang, cum_nsub, n_gang=n_gang, n_sub=n_sub)
    dest = append()
    cleanup = lambda: LS._coarse_cleanup(dest, head, ngang, cum_ngang, cnt, n_fields=2)
    gx, gy, gh, gv = cleanup()
    render = lambda: deposit_2d_coherent(gx, gy, gh, gv, spec, device=device)
    split = {
        "stage_a": wall_s(lambda: LS._host_totals(*stage_a()[8:]), 3),
        "append": wall_s(append, 3),
        "cleanup": wall_s(cleanup, 3),
        "coherent_render": wall_s(render, 3),
    }
    coarse = {"runs": int((cnt > 0).sum()), "n_gang": n_gang, "n_sub": n_sub, "pad_share": n_gang * 128 / n - 1.0}
    del a_out, gangs, dest, ops
    # the path's other kernels against their plain versions on the stream
    # the bucketing feeds them: the row prep (bit for bit), the coherent
    # deposit on its candidates, the sorted-engine deposit on each level of
    # its routed tail
    cx, cy, ch, cv, _ = TC._device_inputs(gx, gy, gh, gv, spec, device)
    stream = {"prep": _prep_vs_plain(torch, "bucketed_stream", spec, cx, cy, ch, cv)}
    del cx, cy, ch, cv
    lay = tile_particles_coherent(gx, gy, gh, gv, spec, device=device)
    bucket_stats = lay.stats
    stream["coherent_deposit"] = _coherent_vs_plain(torch, lay, spec, gh, "kernel3d", 1, case="bucketed_stream")
    stream["tail_levels"] = _tail_levels_vs_plain(torch, lay, spec, case="bucketed_stream")
    del lay, gx, gy, gh, gv
    busy_ms, prof_wall_ms = device_busy_ms(bucketed)

    out = {
        "phase": "random_path", "n": n, "order": "random", "map": [1024, 1024], "fields": 2,
        "generate_s": gen_s, "launches_bucketed": launches_b, "launches_shear": launches_s,
        "rel_err_vs_sorted": {k: r for k, (_, r) in errs.items()},
        "max_abs_err_vs_sorted": {k: e for k, (e, _) in errs.items()}, "integrated_mass_rel_err": mass_err,
        "wall_s": walls, "deposits_per_s": {k: n / w for k, w in walls.items()},
        "bucketed_split_s": split, "layout_deposit_split_s": layout_split,
        "coarse_grouping": coarse, "shear_layout": shear_layout,
        "coherent_stats_on_shuffled": coh_stats, "coherent_stats_after_bucketing": bucket_stats,
        "bucketed_stream_checks": stream,
        "bucketed_profiled_wall_ms": prof_wall_ms, "bucketed_device_busy_ms": busy_ms,
        "bucketed_device_idle_share": None if busy_ms is None else 1.0 - busy_ms / prof_wall_ms,
        "peak_mem_gb_bucketed": peak_b, "peak_mem_gb_phase": torch.cuda.max_memory_allocated() / 2**30,
        "max_abs_err": max(e for e, _ in errs.values()),
    }
    emit(out)
    check(launches_b["append_gangs"] > 0, f"kernel #7 not launched on the bucketed path: {launches_b}")
    check(launches_s["append_gangs"] > 0, f"kernel #7 not launched on the shear path: {launches_s}")
    check(all(v > 0 for v in launches_b.values()), f"a kernel of the bucketed path was not launched: {launches_b}")
    bad = {k: r for k, (_, r) in errs.items() if not r <= REL_TOL}
    check(not bad, f"random-order maps off the sorted engine: {bad}")
    check(mass_err < MASS_TOL, f"integrated bucketed map mass error {mass_err}")
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", default="0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,16,17",
                        help="comma-separated phases to run (15 only when named)")
    parser.add_argument("--log2n", type=int, default=MAIN_LOG2N, help="log2 of the main path's particle count")
    parser.add_argument("--sight-n", type=int, default=SIGHT_N, help="gas particles of phases 10-12")
    parser.add_argument("--vox-log2n", type=int, default=VOX_LOG2N, help="log2 of phase 14's particle count")
    parser.add_argument("--rand-log2n", type=int, default=RAND_LOG2N,
                        help="log2 of phases 16-17's shuffled particle count")
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
    torch.cuda.empty_cache()
    sl = sightline_setup(torch, device, args.sight_n) if phases & {10, 11, 12} else None
    col_cases = phase_columns_kernel(torch, device, sl) if 10 in phases else []
    spec_cases = phase_spectra_kernel(torch, device, sl) if 11 in phases else []
    sight_out = phase_sightlines(torch, device, sl) if 12 in phases else None
    del sl
    torch.cuda.empty_cache()
    vox_cases = phase_voxel_kernel(torch, device) if 13 in phases else []
    vox_out = phase_voxel(torch, device, args.vox_log2n) if 14 in phases else None
    if 15 in phases:
        phase_voxel_tiles(torch, device, args.vox_log2n)
    torch.cuda.empty_cache()
    rp, rand_gen_s = random_particles(torch, device, args.rand_log2n) if phases & {16, 17} else (None, 0.0)
    app_cases = phase_append_kernel(torch, device, rp) if 16 in phases else []
    rand_out = phase_random(torch, device, rp, rand_gen_s) if 17 in phases else None
    del rp

    def pick(rows, **match):
        return next((c for c in rows if all(c[k] == v for k, v in match.items())), None)

    def bound_keys(case):
        """The case's bound; no single PyTorch call computes the functions
        of kernels #1-#6, so no library time."""
        return {
            "bound_ms": case["bound_ms"] if case else None,
            "bound_by": case["bound_by"] if case else None,
            "library_ms": None,
        }

    ref_case = pick(cases, K=8, F=2, projection="kernel3d")
    prep_case = pick(prep_cases, case="coherent_order")
    coh_case = pick(coh_cases, F=2, projection="kernel3d")
    launches = coh_out["launches_synced"] if coh_out else {}
    col_case = pick(col_cases, projection="integrated", periodic=True, F=1)
    spec_case = pick(spec_cases, profile="gaussian", periodic=True)
    vox_case = pick(vox_cases, K=8, F=4, periodic=True)
    app_case = pick(app_cases, case="coarse")
    sight_launches = sight_out["launches"] if sight_out else {}
    # phase 17's checks of kernels #1-#3 on the bucketed stream
    stream = rand_out["bucketed_stream_checks"] if rand_out else {}
    dep_all = cases + stream.get("tail_levels", [])
    prep_all = prep_cases + ([stream["prep"]] if stream else [])
    coh_all = coh_cases + ([stream["coherent_deposit"]] if stream else [])
    emit({"kernels": [
        {
            "name": "deposit2d",
            "route": "cuda",
            "source": "astro_sph_tools_tpu_torch/csrc/deposit2d.cu",
            "replaces": "astro_sph_tools_tpu/ops/deposit_pallas.py:129",
            "launches": main_out["launches"] if main_out else None,
            "max_abs_err": max((c["max_abs_err"] for c in dep_all), default=None),
            "ms": ref_case["ms"] if ref_case else None,
            "plain_ms": ref_case["plain_ms"] if ref_case else None,
            **bound_keys(ref_case),
        },
        {
            "name": "coherent_prep",
            "route": "cuda",
            "source": "astro_sph_tools_tpu_torch/csrc/coherent.cu",
            "replaces": "astro_sph_tools_tpu/ops/coherent_prep_pallas.py:104",
            "launches": launches.get("coherent_prep"),
            "max_abs_err": max((c["max_abs_err"] for c in prep_all), default=None),
            "ms": prep_case["ms"] if prep_case else None,
            "plain_ms": prep_case["plain_ms"] if prep_case else None,
            **bound_keys(prep_case),
        },
        {
            "name": "coherent_deposit",
            "route": "cuda",
            "source": "astro_sph_tools_tpu_torch/csrc/coherent.cu",
            "replaces": "astro_sph_tools_tpu/ops/deposit_coherent.py:660",
            "launches": launches.get("coherent_deposit"),
            "max_abs_err": max((c["max_abs_err"] for c in coh_all), default=None),
            "ms": coh_case["ms"] if coh_case else None,
            "plain_ms": coh_case["plain_ms"] if coh_case else None,
            **bound_keys(coh_case),
        },
        {
            "name": "sightline_columns",
            "route": "cuda",
            "source": "astro_sph_tools_tpu_torch/csrc/sightlines.cu",
            "replaces": "astro_sph_tools_tpu/ops/sightlines_pallas.py:368",
            "launches": sight_launches.get("sightline_columns"),
            "max_abs_err": max((c["max_abs_err"] for c in col_cases), default=None),
            "ms": col_case["ms"] if col_case else None,
            "plain_ms": col_case["plain_ms"] if col_case else None,
            **bound_keys(col_case),
        },
        {
            "name": "sightline_spectra",
            "route": "cuda",
            "source": "astro_sph_tools_tpu_torch/csrc/sightlines.cu",
            "replaces": "astro_sph_tools_tpu/ops/spectra_pallas.py:70",
            "launches": sight_launches.get("sightline_spectra"),
            "max_abs_err": max((c["max_abs_err"] for c in spec_cases), default=None),
            "ms": spec_case["ms"] if spec_case else None,
            "plain_ms": spec_case["plain_ms"] if spec_case else None,
            **bound_keys(spec_case),
        },
        {
            "name": "deposit3d",
            "route": "cuda",
            "source": "astro_sph_tools_tpu_torch/csrc/deposit3d.cu",
            "replaces": "astro_sph_tools_tpu/ops/grid3d_pallas.py:129",
            "launches": vox_out["launches"] if vox_out else None,
            "max_abs_err": max((c["max_abs_err"] for c in vox_cases + (vox_out["levels"] if vox_out else [])),
                               default=None),
            "ms": vox_case["ms"] if vox_case else None,
            "plain_ms": vox_case["plain_ms"] if vox_case else None,
            **bound_keys(vox_case),
        },
        {
            "name": "append_gangs",
            "route": "cuda",
            "source": "astro_sph_tools_tpu_torch/csrc/layout_shear.cu",
            "replaces": "astro_sph_tools_tpu/ops/layout_shear.py:198",
            "launches": rand_out["launches_bucketed"]["append_gangs"] if rand_out else None,
            "max_abs_err": max((c["max_abs_err"] for c in app_cases), default=None),
            "ms": app_case["ms"] if app_case else None,
            "plain_ms": app_case["plain_ms"] if app_case else None,
            # torch.index_select over a per-destination-gang source index
            # computes the same function in one PyTorch call
            **bound_keys(app_case),
            "library_ms": app_case["library_ms"] if app_case else None,
        },
    ]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }})


if __name__ == "__main__":
    main()
