#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (astro_sph_tools_tpu_torch).

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py                # phases 0-14, 16, 17 and 19-27
    python3 chip_smoke.py --phases 0,1,2 # a subset, for debugging

It drives the port's main paths — the adaptive-h sorted tile engine behind
``render_map_stack``, the coherent-order engine (synced and zero-sync fused),
the sightline columns and absorption spectra of BASELINE config 4, the 3D
voxel deposit of BASELINE config 3, the random-order path (shear grouping,
``deposit_2d_bucketed``), the halo-centred map stacks of BASELINE config
5 (``render_halo_maps``), the streamed snapshot-to-map ingest, the
ion-weighted render and the neighbour queries (SWIFT DM smoothing lengths,
the DM map, the nearest-halo search) and the multi-GPU layer
(``parallel/`` on ``torch.distributed``) and the rest (the coherent
engine's window mode, the fidelity artifact, the examples, the multi-GPU
dry run) — on particles generated in memory from a seed, and
fails (non-zero exit) if any phase fails (phases 19 and 23 run after phase
9, on phase 3's particles):

0. device: torch version, card name and power limit (nvidia-smi); the CPU
   first-call probe (``cpu_probe``) in 8 fresh processes of plain torch
   and 8 of the package's plain deposit: how many went wrong on this host
   (the package's must not);
1. build: compile every CUDA kernel library (``csrc/deposit2d.cu``,
   ``csrc/coherent.cu``, ``csrc/deposit_wide.cu``, ``csrc/sightlines.cu``,
   ``csrc/deposit3d.cu``, ``csrc/deposit3d_wide.cu``,
   ``csrc/layout_shear.cu``), one nvcc per source,
   all started together, and the host C library ``native/hostops.c``; the
   row-prep, column and oversize-route kernels' registers and spill bytes
   (``ptxas_summary``);
2. sorted-engine deposit kernel (#1) vs its plain torch version on the
   card, for every level K in {8, 16, 32, 64} x F in {2, 5} x projection,
   on a 1024^2 map: 2^18 uniform particles whose h lies inside the level,
   and dense tiles (``DENSE_N[K]`` Morton-ordered clustered particles on
   4 x 4 of the level's tiles, a few hundred footprints a pixel; at K = 8
   also 2^20 on 2 x 2 tiles, radii uniform in the level, thousands a
   pixel), with the plain version's own run-to-run spread on the dense
   inputs and kernel and plain against the f64 sum of the plain version's
   terms (``plain_f64_sum``, the yardstick of the 2 x 2 case); each case's
   cluster size, largest share a block, densest tile's time alone, and a
   check that no kernel time is under its bound; at K = 8 and 32 with F =
   5 the dense tiles also over clusters of 1 and 8 blocks;
3. sorted main path: ``deposit_2d_auto`` on 2^26 Morton-ordered clustered
   particles with adaptive h, 1024^2 periodic map, 2 fields; checks the
   kernel launch count, finiteness, mass conservation in the integrated
   projection, and agreement with the plain version on a 2^22 subset; each
   level's kernel time beside its bound at this size, counted as phase 2's,
   its cluster size, largest share a block and densest tile's time alone
   (no kernel time may fall under its bound), and the densest tile against
   the plain version at full size, with plain's own spread and both
   against ``plain_f64_sum``;
4. ``render_map_stack`` at 1024^2 on an in-memory snapshot;
5. host-f64 quality path against the f64 oracle of ``tests/oracles.py``;
6. row-prep kernel vs its plain version, bit for bit, on phase 3's
   particles, on 2^22 of them shuffled (most rows heavy) and on a
   non-periodic map with every 131st particle off the extent; each time
   beside its bound (no time may fall under it) and the candidate rounds
   the early stop saved;
7. coherent deposit kernel (#2) vs its plain version on the layout of phase
   3's particles, F in {1, 2, 4} x projection, and on dense tiles (2^20
   Morton-ordered clustered particles on 4 x 4 level-0 tiles, F in {2, 4},
   split over more than one block; F = 4 also over clusters of 1 and 8
   blocks); each case's cluster size, largest
   share of candidate rows a block, densest tile's time alone, and its
   bound (``coherent_bytes``: the key channel of each distinct candidate
   row, the other channels of the lanes that match, the candidate arrays
   and the output), which no kernel time may fall under;
8. coherent main path at 2^26 (phase 3's particles): ``deposit_2d_coherent``
   and, with capacities from its layout, ``deposit_2d_coherent_fused``
   (the latter once more under ``torch.cuda.set_sync_debug_mode("error")``),
   both against the sorted engine; the three engines' warm walls; an
   overflowing fused render must report ``ok`` False;
9. ``render_map_stack(engine="coherent")`` against ``engine="pallas"``;
10. sightline column kernel (``csrc/sightlines.cu``) vs its plain version on
    the fused layout of the config-4 particles (below) and 2048 rays,
    {kernel3d, integrated} x {periodic, open} x F in {1, 5}; two launches
    compared bit for bit; pair tests per expected hit, items and the
    largest item's particles, beside the same counts of the block schedule
    the column kernel took before (``block_work``); no time under its
    bound;
11. spectra kernel vs its plain version, 256 rays, 512 bins, {gaussian,
    voigt (H I Lya)} x {periodic, open}, on the config-4 particles and on
    ``awkward_lines`` (lines at the velocity edges, Doppler widths from a
    tenth of a bin to 0.6 v_box, 3 Gaussian images a side), with the work
    its bound counts (``spectra_work``), what the kernel did
    (``spectra_live_work``: live (ray block, particle) pairs, per distinct
    particle, and profile terms) and a check that no kernel time is under
    its bound;
12. the config-4 path at full size: 10^4 random rays through 10^7 clustered
    gas particles in a periodic 25 cMpc box at z = 0.5 —
    ``column_integrate_pallas`` and ``absorption_spectra_pallas`` (512 bins,
    Gaussian and Voigt); launch counts, finiteness, warm walls, the
    columns wall split into the domain read, device sort, ray cells
    and kernel, the column launch's work and bound, each
    spectra launch's kernel time beside its bound (checked to be no less)
    and phase 11's counts of what it did, the device's busy share,
    and agreement with the binned engines on 256 rays and with the dense
    spectra engine on a 2^20-particle subset;
13. 3D voxel deposit kernel (``csrc/deposit3d.cu``) vs its plain version,
    every level K in {4, 8, 16} x F in {1, 4} x {periodic, open}, on a 256^3
    grid with 2^18 particles whose h lies inside the level, and every level
    on four small grids (20^3 periodic and open, which the 8^3 tiles do not
    divide; 4 x 6 x 20 periodic, over which the K = 16 boxes fold; 24 x 16
    x 40 periodic in x and z only) at the default region split and at 512
    candidates a block, regions whole and split over blocks;
14. the config-3 path at full size: ``deposit_3d_auto`` on 2^24 clustered
    particles (the JAX package's ``benchmarks/voxel3d_bench.py`` generator,
    h capped at 3.5 voxels so that every particle fits the K = 16 level),
    512^3 periodic cube over 25 cMpc, F = 4 (m and m * v); launch count, no
    oversize particle, finiteness, agreement with the plain stencil engine
    on a 2^20 subset, the oversize route at 64^3, warm walls split into
    layout and kernel, the device's busy share, peak memory; and each
    level's kernel launch against its plain version on the full-size layout,
    with its work list (output regions, thread blocks, blocks of split
    regions, the largest and the mean candidate count);
15. (only when named in ``--phases``) tile-geometry A/B of kernel #6 on
    phase 14's particles: the K = 8 and K = 16 levels' kernel times at 8^3
    (the default), (16, 16, 8) and 16^3 tiles, F = 1 and 4, each held
    against the default's cube;
16. gang-append kernel (``csrc/layout_shear.cu``, kernel #7) vs its plain
    version, bit for bit on every destination gang, on stage A's output for
    (a) the coarse 128 x 2-cell grouping of phase 17's particles, (b) their
    fine 1024^2 level/tile key space, (c) one key at 2^24 and 2^26 records,
    (d) runs of mostly one record; kernel, plain and ``torch.index_select``
    times and bounds, and ten alternating pairs of kernel and
    ``index_select`` times, of one call and of ten back-to-back calls;
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
    each routed tail level, each against its plain version;
18. (only when named in ``--phases``) kernel #6's time per level on phase
    14's layout at region splits of 512, 2048, 8192 (the default) and 32768
    candidates per block, each held against the default's cube;
19. the halo path: ``render_halo_maps`` (the sorted engine, kernel #1) on
    phase 3's particles served by ``memory_snapshot`` (with metallicities)
    and an in-memory catalogue (``memory_catalogue``) of 16 haloes
    (``halo_catalogue``: 14 on the most massive 64^2 cells, one within 0.1
    Mpc of the corner (0, 0), one on the edge x ~ box; R_200 0.15-1.0 Mpc),
    1024^2 x (density, temperature, metallicity); kernel #1's launches
    (also per halo), finite maps with surface density at every cutout's
    centre; the four smallest cutouts against ``engine="xla"`` (the plain
    stencil engine on the card), the smallest against the host-f64 quality
    path on the same particles, each edge halo against the render of the
    particles translated by half a box (f64, on the card); per halo the
    particles in the cutout and the timing split; for the 16 haloes the
    warm wall, the device's busy share and peak memory; the oversize
    route's launches (``deposit_wide``); then the oversize-route kernels
    (``csrc/deposit_wide.cu``) at the benchmark cell ``l0025_haloes``'s
    shapes (``wide_route_cases``: ``sphbench``'s EAGLE Ref-L0025N0376
    generator, haloes 0, 14 and 15, each cutout's oversize segment of the
    sorted layout, 1024^2 x 3 fields): the route's, the binning's and the
    deposit kernel's time beside the bound (the pairs inside the supports
    clipped to the map, ``sphbench/counting.py``), the plain route's time,
    the launches, the list entries (``tile_pairs``) and the pixels they
    evaluate over the pairs inside; the route and the plain route against
    the plain route in f64 on the same placed particles (the route within
    1e-5 * max; the plain f32 route, one running sum a pixel over up to
    ~1e5 footprints, reads up to ~1e-4 there), two runs bit for bit, the
    lists against their plain version bit for bit;
20. the streamed snapshot-to-map path (the JAX package's
    ``benchmarks/e2e_1e8.py``): 2^27 gas particles of its
    ``write_big_snapshot`` distribution in 8 Morton-sorted "files" held on
    the host in raw internal units (``e2e_files``), streamed as 4
    macro-chunks of 2^25 through ``stream_macro_chunks`` (pinned buffers, a
    side stream) on three wires (``f32``: host unit conversion; ``pack``:
    u16 positions and f16 h and fields; ``packdelta``: raw units, Morton-
    delta positions, u8-log fields, units folded into the unpack), each
    into 1024^2 x [m, m T] periodic maps through the sorted engine, and
    ``f32`` and ``packdelta`` also through ``deposit_2d_coherent``; each
    chunk's decode on the card against the CPU decode (bit for bit) and the
    Morton decode against the encoder's inputs; each streamed map against
    one render of all its decoded particles and coherent against sorted
    (1e-5 * max); finite maps, integrated mass; kernel #1-#3 launches in
    the steady passes; per wire and engine the cold and steady walls, the
    exposed wait, layout and deposit, bytes a particle, the device's busy
    share (``device_trace``) and peak memory; the packed maps' quantisation
    error against the ``f32`` wire's; H2D GB/s from pinned and pageable
    memory;
21. the ion-weighted render (the JAX package's ``benchmarks/ion_e2e.py`` at
    2^26): the synthetic O VI HM01 table in memory, collapsed at z = 0.5;
    the per-particle lookup on the card against scipy's f64 interpolation
    of the full table on 2^20 particles (1e-5 in log f; -inf and f = 0
    outside the table); the payload [m f, m f T 2^-16]; capacities from one
    synced coherent render, then ``deposit_2d_coherent_fused`` with its
    ``ok`` flag read on every pass; fused, synced and sorted maps within
    1e-5 * max; kernel #2-#3 launches; the warm wall, the payload alone,
    the calibration, the device's busy share and peak memory;
22. the neighbour path at EAGLE Ref-L0025N0376's size (``--neigh-side``,
    default 376): 376^3 DM and 376^3 gas positions in a periodic 25 cMpc box
    from ``benchmarks/knn_crossover.py``'s generator (``neighbour_positions``;
    the particle masses of the run); (a) ``dm_smoothing_lengths(engine=
    "grid")`` (k = 32, host positions in) cold and warm, each stage's grid,
    bucket cap, active, spilled and settled queries and time, stragglers,
    peak memory, the engine taken (must be the grid), every row ascending,
    1024 random rows against the dense ``knn_distances`` over all points
    (rtol 1e-4, atol 1e-5); (b) the DM map of those lengths, 1024^2
    periodic through ``deposit_2d_auto`` (kernel #1's launches, each level
    against its plain version and the f64 sum of the plain version's terms
    (``plain_f64_sum``: ~2e4 footprints a pixel, where the f32 order of the
    plain sum alone nears 1e-5; the kernel is held to the f64 sum) and
    beside its bound, oversize count, against
    the stencil engine on 2^22 particles, integrated mass); (c)
    ``nearest_halo_search`` of every gas particle against 30,000 haloes
    (``neighbour_haloes``: dN/dlogM ~ M^-0.9 on [9, 14.5], R200 at 200
    rho_crit) at [all, 11, 12, 13], each pass's engine and wall, 2^16
    queries a pass against scipy's KDTree; (d) the crossovers behind the
    two ``auto`` constants: the 32-NN grid against the host KDTree at
    KNN_CROSSOVER.json's sizes and two below (at 3e6 also traced: the
    device's busy share and its top kernels), and ``nearest_points`` dense
    against grid at 1e3-1e5 haloes and 2^22 queries;
23. the multi-GPU layer on the one card: (a) a world of one rank over NCCL
    (a ``FileStore`` in a temporary directory) at full size: the coherent
    sharded engines, synced and fused (the fused also under sync debug
    mode "error"), on phase 3's 2^26 particles against the single-device
    engines beside their own run-to-run difference, the one-rank
    all_reduce bit for bit; ``deposit_2d_sharded`` at the smallest level
    that holds the largest footprint against ``deposit_2d_auto``;
    ``deposit_3d_sharded`` (K = 16, F = 1) on config 3's 2^24 particles at
    512^3 against ``deposit_3d_auto``; walls beside the single-device
    engines' and the collective's share; (b) PAR_RANKS = 4 gloo ranks on
    the card, each a process of its own (``--par-rank``) with a
    process-group timeout, under one deadline (a rank that fails or hangs
    fails the phase): every entry point of ``parallel/`` on its shard
    (``PAR_SIZES``: 2^24 of phase 3's generator in Morton-contiguous
    quarters, 1024^2 x 2; 256^3 periodic and open slabs of 2^22 of phase
    14's; columns and Gaussian spectra of 2^22 config-4 particles on 2048
    rays; the reorder of 2^22 int64 IDs above 2^40, a permutation and a
    half overlap; a rebalance with one rank nearly full; four haloes of
    phase 19's catalogue) against the single-device engine on the whole
    input (1e-5 * max; the reorders and the rebalance exactly), the fused
    engine's ``ok`` on every rank with merged capacities and on none when
    one rank's capacities are too small; each entry's wall, the bytes a
    rank hands to the collectives, its error; the launches of kernels
    #1-#6 over both parts, each above zero;
24. the rest: (a) the coherent engine's window mode on phase 3's 2^26
    particles (1024^2 x 2, ``prep="xla"``) at W = 256, 512 and 1024
    through ``deposit_2d_coherent`` (the window kernel's launches, each
    map within 1e-5 * max of the whole-row map) and kernel #2's window
    branch against its plain version on each layout (at W = 512 also F =
    1 and 4 and the integrated projection) and on phase 7's dense tiles,
    its time beside the whole-row kernel's on the same candidates and
    beside its bound (``coherent_window_bytes``); (b) the fidelity
    artifact (``scripts/fidelity_check.py`` at full size, written to
    ``--fidelity-out``, default FIDELITY_TORCH.json in the temporary
    directory), every in-budget case
    within 1e-5; (c) ``examples.render_service`` at 4 chunks of 2^25,
    1024^2 x 2: every ``ok`` True, the summed map against one sorted
    render of all the chunks (1e-5 * max), kernels #1-#3 against their
    plain versions on the first fused chunk; (d) ``examples.full_workflow``
    on the card (served from memory: no h5py on the card's machine), then
    REST_RANKS gloo ranks on the card (``--rest-rank``) running
    ``parallel.dryrun.dryrun_multichip(4)`` and
    ``examples.multichip_render`` under one deadline;
25. the 3D oversize route (``ops/grid3d_wide.py``, ``csrc/deposit3d_wide.cu``)
    at the benchmark cell ``l0025_cube512``'s shapes (``grid_route_cases``:
    ``sphbench``'s EAGLE Ref-L0025N0376 generator, all 53M gas particles
    through ``tile_particles_3d`` into a periodic 512^3 x 2-field cube, the
    layout's oversize segment, support radii 7-15.4 voxels): the launches
    with the counter zeroed just before (one a batch of the binning), the
    route's, the binning's and the deposit kernel's time beside the bound
    (the voxels inside the supports, 14 + 2F operations each), the list
    entries; the route against ``sphbench/reference/box_cube.py``'s float64
    scatter of the same placed particles (1e-5 * max), two runs bit for
    bit, the stencil engine never called; the plain route
    (``deposit_3d_wide_plain``) and the route on a strided subset of the
    segment (``CUBE_PLAIN_N`` particles), each against the f64 scatter of
    the subset (the route within 1e-5 * max; the plain route, which places
    the particles again from f32 world coordinates, reads ~1e-5 there), and
    the plain route's time scaled to the whole segment; the kernel's walk
    counters from one traced pass (``walk_lanes``, ``walk_pairs`` and their
    ratio, the lane efficiency) and its registers, local (spill) bytes and
    shared bytes a block. Only the wrapper's surface, ``tile_lists`` and
    ``_deposit`` are used, so that a copy of this file placed in a checkout
    of an earlier tree times that tree's kernel (what it lacks reads None);
26. kernel #1's register path (K >= 32, ``deposit2d_register``) at the box
    cells' own level populations (``box_level_cases``: ``sphbench``'s
    EAGLE Ref-L0025N0376 generator, all 53M gas particles at EAGLE's h,
    through ``tile_particles`` onto a periodic 1024^2 map, Wendland C2,
    kernel3d, F = 2: mass and mass times temperature): per K = 32 and 64
    level the particles, tiles and fullest tile, the kernel's time beside
    its bound (the pixels inside the supports, ``sphbench.counting``'s
    14 + 2F operations each), the lane efficiency (lane evaluations, from
    each particle's loop box, the 2-row x 16-column steps its rows and
    columns meet, over the pixels inside its support; the warp-a-particle
    design it replaced beside it), two launches bit for bit, and the
    densest tile and ``BOX_CHECK_TILES`` tiles drawn from the seed against
    ``plain_f64_sum`` (1e-5 * max); and the spans ``deposit.levels`` (the
    sorted engine) and ``deposit.tail`` (the coherent engine on the same
    particles) count, in a traced render, the launches and register-path
    launches the wrapper made;
27. kernel #6 at the cube cell's level populations (``cube_level_cases``:
    ``sphbench``'s EAGLE Ref-L0025N0376 generator at ``CUBE_CELL_SEED``,
    all 53M gas particles through ``tile_particles_3d`` into a periodic
    512^3 x 2-field cube, Wendland C2): per K = 4 / 8 / 16 level the
    particles, the voxels inside the supports (4/3 pi s^3 each), the bound
    (those pairs at ``sphbench.counting``'s 14 + 2F operations, or the
    particles and the cube's read and write), the kernel's time (CUDA
    events, median of 5), the candidates the work list stages per particle,
    split regions; two launches bit for bit on every voxel of the regions
    no split shares; kernel and plain version on a strided subset of the
    level (``CUBE_LEVEL_PLAIN_N`` particles) within 1e-6 * max; and the
    span ``deposit3d.levels`` counting, in a traced pass, the candidates
    and blocks the work lists hold. Only the wrapper's surface and
    ``_region_candidates`` are used, so that a copy of this file placed in
    a checkout of an earlier tree times that tree's kernel (counters it
    lacks read None).

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
import re
import subprocess
import sys
import tempfile
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
HALO_N = 16  # phase 19: haloes on phase 3's particles ...
HALO_RES = 1024  # ... each a 1024^2 x 3-field cutout


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


def alternating_ms(fn_a, fn_b, pairs: int, reps: int) -> dict:
    """``pairs`` alternating timings of two functions (a then b, b then a,
    ...), each the median of ``reps`` runs (``cuda_ms``): both lists, their
    medians and ranges, and b/a per pair, so that drift of the card hits
    both alike."""
    a, b = [], []
    for i in range(pairs):
        for fn, out in ((fn_a, a), (fn_b, b)) if i % 2 == 0 else ((fn_b, b), (fn_a, a)):
            out.append(cuda_ms(fn, reps))
    ratio = [y / x for x, y in zip(a, b)]
    return {"a_ms": a, "b_ms": b, "a_median": float(np.median(a)), "b_median": float(np.median(b)),
            "a_range": [min(a), max(a)], "b_range": [min(b), max(b)], "b_over_a": ratio,
            "b_over_a_median": float(np.median(ratio)), "b_over_a_range": [min(ratio), max(ratio)]}


def wall_s(fn, reps: int, device=None) -> float:
    """Median over ``reps`` runs of the host wall clock around a call
    synchronised on ``device`` (default: the card)."""
    import torch

    device = torch.device("cuda") if device is None else torch.device(device)
    times = []
    for _ in range(reps):
        sync(torch, device)
        t0 = time.perf_counter()
        fn()
        sync(torch, device)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def device_busy_ms(fn, top: int = 0) -> tuple:
    """(device busy ms, wall ms) of one synchronised call under
    ``torch.profiler``; busy is None when the trace shows no device time.
    With ``top`` > 0 a third item: the ``top`` device events by summed ms,
    as {name: ms}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events (kernels, copies) of the one stream, summed
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in device)
    out = ((busy_us / 1e3 if busy_us > 0 else None), wall_ms)
    if not top:
        return out
    by_name: dict = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
    return out + (dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:top]),)


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
# the CPU first-call probe (phase 0; tests/test_torch_cpu_first_call.py)
# ---------------------------------------------------------------------------

PROBE_GRAIN = 73_216  # elements of the probe's temporaries: past torch's 32,768-element grain


def cpu_probe(kind: str) -> dict:
    """One fresh process's first multi-threaded CPU math, held to f64.

    ``"torch"``: plain torch, without the package (whose import warms the
    math library, ``_cpu_math.py``): a floor and an int32 cast, then the
    first ``sqrt``, ``exp`` and ``log`` of PROBE_GRAIN f32 values, each
    against NumPy f64. ``"port"``: the package's plain CPU deposit
    (``deposit_2d_auto(..., device="cpu")``: 3,454 particles with f64
    offsets into a 48^2 cutout, temporaries past the grain) against the f64
    oracle of ``tests/oracles.py``. Returns the largest relative error."""
    import torch

    if kind == "torch":
        rng = np.random.default_rng(3)
        t = torch.from_numpy(rng.uniform(0.0, 48.0, PROBE_GRAIN).astype(np.float32))
        q = (t - torch.floor(t - 0.5).to(torch.int32).to(torch.float32)) * 0.37 + 0.01
        errs = {}
        for name, f, g in (("sqrt", torch.sqrt, np.sqrt), ("exp", torch.exp, np.exp), ("log", torch.log, np.log)):
            ref = g(q.double().numpy())
            errs[name] = float(np.max(np.abs(f(q).double().numpy() - ref) / np.abs(ref)))
        return {"kind": kind, "rel_err": max(errs.values()), "by_op": errs}
    if kind != "port":
        raise ValueError(f"unknown probe {kind!r}")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from oracles import project_oracle_fast

    from astro_sph_tools_tpu_torch.ops import MapSpec, deposit_2d_auto

    rng = np.random.default_rng(5)
    n, w = 3454, 1.2  # a 1.2 Mpc, 48-pixel cutout
    px = w / 48
    x = rng.uniform(-w / 2, w / 2, n)
    y = rng.uniform(-w / 2, w / 2, n)
    h = np.exp(rng.normal(np.log(1.2 * px), 0.5, n)).clip(0.3 * px, 6 * px).astype(np.float32)
    m = rng.uniform(0.5, 1.5, n).astype(np.float32)
    spec = MapSpec(shape=(48, 48), extent=(-w / 2, w / 2, -w / 2, w / 2))
    img = deposit_2d_auto(x, y, h, m, spec, device="cpu").numpy().astype(np.float64)
    ref = project_oracle_fast(x, y, h.astype(np.float64), m.astype(np.float64), (48, 48), spec.extent)
    return {"kind": kind, "rel_err": float(np.abs(img - ref).max() / np.abs(ref).max())}


def run_cpu_probes(kind: str, n: int, timeout: float = 120.0) -> list:
    """``cpu_probe(kind)`` in ``n`` fresh processes, started together (one
    after another they took ~8 s each on the card's host, where each
    imports a CUDA build of torch); their errors."""
    cmd = [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--cpu-probe", kind]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
             for _ in range(n)]
    errs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise RuntimeError(f"cpu probe {kind} failed ({p.returncode}): {err[-2000:]}")
            errs.append(json.loads(out.strip().splitlines()[-1])["rel_err"])
    finally:
        for p in procs:  # stop every process this started
            if p.poll() is None:
                p.kill()
                p.wait()
    return errs


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(torch, n_probes: int = 8):
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
        "nvidia_smi": smi, "cpu_threads": torch.get_num_threads(),
    })
    # does this host's CPU math go wrong on a fresh process's first
    # multi-threaded call (plain torch), and does the package's warm-up
    # keep its plain CPU path inside the budget (the port)?
    t0 = time.perf_counter()
    raw = run_cpu_probes("torch", n_probes)
    port = run_cpu_probes("port", n_probes)
    out = {
        "phase": "device", "cpu_first_call": {
            "processes": n_probes, "tolerance": REL_TOL,
            "torch_bad": sum(e > REL_TOL for e in raw), "torch_max_rel_err": max(raw),
            "port_bad": sum(e > REL_TOL for e in port), "port_max_rel_err": max(port),
            "seconds": time.perf_counter() - t0,
        },
    }
    emit(out)
    check(out["cpu_first_call"]["port_bad"] == 0, f"the port's CPU path off the oracle: {port}")
    return smi


def phase_build():
    from astro_sph_tools_tpu_torch import _build

    t0 = time.perf_counter()
    libs = _build.load_all()
    for name, (_, info) in libs.items():
        ptxas = [ln.strip() for ln in info.log.splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        emit({
            "phase": "build", "library": os.path.relpath(str(info.path), ROOT),
            "nvcc_seconds": round(info.seconds, 3), "built": info.built,
            "flags": " ".join(_build.NVCC_FLAGS), "ptxas": ptxas,
        })
    _, host = _build.load_host()
    emit({"phase": "build", "library": os.path.relpath(str(host.path), ROOT),
          "cc_seconds": round(host.seconds, 3), "built": host.built, "flags": " ".join(_build.CC_FLAGS)})
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3), "libraries": sorted(libs) + ["hostops"]})
    logs = "\n".join(info.log for _, info in libs.values())
    emit({"phase": "build", "ptxas_by_kernel": {
        name: ptxas_summary(logs, name)
        for name in ("deposit2d_register", "coherent_prep_kernel", "columns_kernel", "column_sums_kernel",
                     "wide_bin_kernel", "wide_deposit_kernel", "deposit3d_pull_kernel", "wide3d_deposit_kernel")
    }})


def ptxas_summary(log: str, kernel: str) -> dict:
    """Registers and spill bytes of every instantiation of ``kernel`` in
    ``nvcc -Xptxas -v`` output: their count, the most registers and the
    most spill bytes any of them takes."""
    regs, spills, entry = [], [], None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", ln)
        if m:
            entry = m.group(1)
            continue
        if entry is None or kernel not in entry:
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            regs.append(int(m.group(1)))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spills.append(int(m.group(1)) + int(m.group(2)))
    return {"instances": len(regs), "registers_max": max(regs, default=None),
            "spill_bytes_max": max(spills, default=None)}


def _level_inputs(torch, cfg, lo_s, hi_s, n_fields, n, spec, seed, device):
    """Tile-sorted tile-local inputs of one level, h inside (lo_s, hi_s] px."""
    from astro_sph_tools_tpu_torch.ops._device import tile_ranges
    from astro_sph_tools_tpu_torch.ops.deposit_tiled import _level_geometry, _tile_local_coords

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
    pstart, pcount = tile_ranges(tile, geom.n_tiles)
    return geom, (u_loc[perm], v_loc[perm], h[perm], vals[:, perm].contiguous(), pstart, pcount)


def morton_key(torch, ix, iy):
    """Morton (z-order) key of non-negative int64 cell coordinates < 2^16."""
    key = torch.zeros_like(ix)
    for b in range(16):
        key |= ((ix >> b) & 1) << (2 * b)
        key |= ((iy >> b) & 1) << (2 * b + 1)
    return key


def dense_positions(torch, n: int, w: float, hgt: float, seed: int, device):
    """``n`` clustered positions in a ``w`` x ``hgt`` box from the origin
    (half in a Gaussian blob of a sixth of the box, half uniform; the blob's
    centre holds ~3.4x the mean density), in Morton order over the box, as a
    snapshot's space-filling curve keeps them."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    half = n // 2
    x = torch.cat([w * (0.5 + torch.randn(half, generator=g, device=device) / 6.0),
                   w * torch.rand(n - half, generator=g, device=device)]).clamp(0.0, w * (1 - 1e-6))
    y = torch.cat([hgt * (0.5 + torch.randn(half, generator=g, device=device) / 6.0),
                   hgt * torch.rand(n - half, generator=g, device=device)]).clamp(0.0, hgt * (1 - 1e-6))
    ix = (x / w * 65536).long().clamp(0, 65535)
    iy = (y / hgt * 65536).long().clamp(0, 65535)
    order = torch.argsort(morton_key(torch, ix, iy))
    return x[order], y[order], g


# dense-tile cases of phase 2: particles on 4 x 4 of the level's tiles, so
# many that a pixel lies in a few hundred footprints on average, as in the
# main path's densest tiles (342,485 particles on one K = 8 tile's 8 x 64
# pixels, with h falling where they crowd)
DENSE_N = {8: 1 << 20, 16: 1 << 17, 32: 1 << 15, 64: 1 << 14}


def _dense_level_inputs(torch, cfg, lo_s, hi_s, n_fields, n, spec, seed, device, side: int = 4,
                        radii: str = "log"):
    """Tile-sorted tile-local inputs of one level, with ``n`` Morton-ordered
    clustered particles on ``side`` x ``side`` of the level's tiles, their
    support radii log-uniform (``radii="log"``) or uniform in (lo_s, hi_s]
    px: the dense tiles a clustered snapshot makes."""
    from astro_sph_tools_tpu_torch.ops._device import tile_ranges
    from astro_sph_tools_tpu_torch.ops.deposit_tiled import _level_geometry, _tile_local_coords

    geom = _level_geometry(cfg, spec)
    px = spec.extent[1] / spec.shape[1]
    x, y, g = dense_positions(torch, n, side * geom.tx * px, side * cfg.TY * px, seed, device)
    r = 1.0 - torch.rand(n, generator=g, device=device)
    s_pix = lo_s * (hi_s / lo_s) ** r if radii == "log" else lo_s + (hi_s - lo_s) * r
    h = s_pix * px / 2.0
    vals = 0.5 + 1.5 * torch.rand((n_fields, n), generator=g, device=device)
    tile, u_loc, v_loc = _tile_local_coords(x, y, geom, spec)
    tile, perm = torch.sort(tile, stable=True)
    pstart, pcount = tile_ranges(tile, geom.n_tiles)
    return geom, (u_loc[perm], v_loc[perm], h[perm], vals[:, perm].contiguous(), pstart, pcount)


def _deposit_module():
    import importlib

    return importlib.import_module("astro_sph_tools_tpu_torch.ops.deposit_tiled")


def with_cluster(module, C: int, fn):
    """``fn()`` with the module's blocks a tile (``_CLUSTER``) set to C."""
    old = module._CLUSTER
    module._CLUSTER = C
    try:
        return fn()
    finally:
        module._CLUSTER = old


def plain_f64_sum(torch, deposit_tiles_plain, args, kw, run: int = 8):
    """Kernel #1's function with the plain version's f32 terms summed in
    f64: each tile's particles cut into runs of ``run``, each run through
    the plain version as a tile of its own (a pixel sums at most ``run``
    terms in f32), the runs added into their tile in f64. The yardstick for
    f32 summation order."""
    u, v, h, vals, pstart, pcount = args
    n_tiles = pstart.shape[0]
    counts = pcount.to(torch.int64)
    n_runs = (counts + run - 1) // run
    tile_of = torch.repeat_interleave(torch.arange(n_tiles, device=u.device), n_runs)
    k = torch.arange(tile_of.shape[0], device=u.device) - torch.repeat_interleave(torch.cumsum(n_runs, 0) - n_runs,
                                                                                  n_runs)
    rstart = (pstart.to(torch.int64)[tile_of] + k * run).to(torch.int32)
    rcount = torch.clamp(counts[tile_of] - k * run, max=run).to(torch.int32)
    cfg = kw["cfg"]
    out = torch.zeros((n_tiles, vals.shape[0] * cfg.R, cfg.S), dtype=torch.float64, device=u.device)
    step = max(1, (1 << 28) // (vals.shape[0] * cfg.R * cfg.S))
    for i in range(0, tile_of.shape[0], step):
        part = deposit_tiles_plain(u, v, h, vals, rstart[i:i + step], rcount[i:i + step], **kw)
        out.index_add_(0, tile_of[i:i + step], part.double())
    return out


def split_stats(torch, C: int, pcount, group: int, K: int = 0) -> dict:
    """The cluster split of one launch: its blocks a tile (C), and the
    largest share a block takes (particles for #1, split in groups of 8;
    candidate rows for #2, one by one). #1's register path (from
    ``REGISTER_MIN_K``) splits rows, not particles: each block walks its
    whole tile."""
    from astro_sph_tools_tpu_torch.ops.deposit_tiled import REGISTER_MIN_K, cluster_share_sizes

    if K >= REGISTER_MIN_K:
        return {"cluster": C, "max_share": int(pcount.max()) if pcount.numel() else 0}
    share = cluster_share_sizes(pcount, C, group)
    return {"cluster": C, "max_share": int(share.max()) if share.numel() else 0}


def check_bound(case: dict, what: str) -> None:
    """No kernel time may fall under the least time the card could take."""
    check(case["ms"] >= case["bound_ms"], f"{what}: kernel {case['ms']} ms under its bound {case['bound_ms']} ms")


def _deposit_case(torch, deposit_tiles, deposit_tiles_plain, geom, args, kw, n_fields, projection,
                  plain_reps: int, **tags):
    """Kernel #1 vs its plain version on one level's inputs, timed beside its
    bound, with the launch's split and its densest tile's time alone. On
    dense inputs also the plain version's own run-to-run spread and both
    against ``plain_f64_sum``; the ``dense_2x2`` case (thousands of
    footprints a pixel) is held to that f64 sum, the others to plain."""
    got = deposit_tiles(*args, **kw)
    ref = deposit_tiles_plain(*args, **kw)
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    dense_case = tags.get("case", "").startswith("dense")
    extra = {}
    if dense_case:
        # the plain version's own run-to-run spread (index_add_ sums with
        # atomics on the card), and both against the f64 sum of its terms
        ref64 = plain_f64_sum(torch, deposit_tiles_plain, args, kw)
        extra = {"plain_repeat_rel_err": rel_err(deposit_tiles_plain(*args, **kw), ref)[1],
                 "f64_max_abs_err": rel_err(got, ref64)[0], "f64_rel_err": rel_err(got, ref64)[1],
                 "plain_f64_rel_err": rel_err(ref, ref64)[1]}
        del ref64
    del ref
    pstart, pcount = args[4], args[5]
    t = int(torch.argmax(pcount))
    dense = args[:4] + (pstart[t:t + 1], pcount[t:t + 1])
    px = kw["psx"]
    case = {
        **tags, "K": geom.cfg.K, "F": n_fields, "projection": projection,
        "n": int(args[0].shape[0]), "n_tiles": geom.n_tiles,
        "max_pcount": int(pcount.max()), **split_stats(torch, _deposit_module()._CLUSTER, pcount, 8, geom.cfg.K),
        "max_abs_err": err, "rel_err": rel, **extra,
        "ms": cuda_ms(lambda: deposit_tiles(*args, **kw), 5),
        "densest_tile_ms": cuda_ms(lambda: deposit_tiles(*dense, **kw), 5),
        "plain_ms": cuda_ms(lambda: deposit_tiles_plain(*args, **kw), plain_reps),
        **bound(nbytes(*args, got), support_points(args[2], 2.0, px, 2) * pair_ops(n_fields, projection)),
    }
    emit({"phase": "kernel_vs_plain", **case})
    check(bool(torch.isfinite(got).all()), f"non-finite kernel output {case}")
    if tags.get("case") == "dense_2x2":
        check(case["f64_rel_err"] <= REL_TOL, f"kernel off the f64 sum of the plain version's terms: {case}")
    else:
        check(rel <= REL_TOL, f"kernel disagrees with the plain version: {case}")
    check_bound(case, f"kernel #1 {tags} K={geom.cfg.K} F={n_fields} {projection}")
    return case


def _cluster_extremes(torch, deposit_tiles, deposit_tiles_plain, geom, args, kw, n_fields, projection):
    """Kernel #1 on one level's inputs with its tiles split over 1 and over 8
    blocks (the largest portable cluster) against the plain version."""
    T = _deposit_module()
    ref = deposit_tiles_plain(*args, **kw)
    out = []
    for C in (1, 8):
        got = with_cluster(T, C, lambda: deposit_tiles(*args, **kw))
        err, rel = rel_err(got, ref)
        row = {"phase": "kernel_vs_plain_cluster", "kernel": "deposit2d", "K": geom.cfg.K, "F": n_fields,
               "projection": projection, "cluster": C, "max_abs_err": err, "rel_err": rel,
               "ms": cuda_ms(lambda: with_cluster(T, C, lambda: deposit_tiles(*args, **kw)), 3)}
        emit(row)
        check(rel <= REL_TOL, f"kernel #1 at C={C} disagrees with the plain version: {row}")
        out.append(row)
    return out


def phase_kernels(torch, device, n: int = 1 << 18):
    """Kernel #1 vs its plain version, every level x F in {2, 5} x
    projection: on ``n`` uniform particles (no tile split matters, no pixel
    stacks), and on ``DENSE_N[K]`` Morton-ordered clustered particles on
    4 x 4 tiles of the level; at K = 8 also on 2^20 of them on 2 x 2 tiles
    with radii uniform in the level (thousands of footprints a pixel); at
    K = 8 and 32 with F = 5 the dense tiles also at clusters of 1 and 8
    blocks."""
    from astro_sph_tools_tpu_torch.ops import MapSpec
    from astro_sph_tools_tpu_torch.ops.deposit_tiled import PALLAS_LEVELS, deposit_tiles, deposit_tiles_plain

    spec = MapSpec(shape=(1024, 1024), extent=(0.0, 25.0, 0.0, 25.0), periodic_wrap=True)
    bounds = [0.02] + [cfg.max_s_pix for cfg in PALLAS_LEVELS]
    cases = []
    for li, cfg in enumerate(PALLAS_LEVELS):
        for n_fields in (2, 5):
            for projection in ("kernel3d", "integrated"):
                kw = dict(
                    cfg=cfg, kernel="cubic_spline", projection=projection,
                    psx=25.0 / 1024, psy=25.0 / 1024, offset=spec.sample_offset,
                )
                seed = 100 + 10 * li + n_fields
                geom, args = _level_inputs(torch, cfg, bounds[li], bounds[li + 1], n_fields, n, spec, seed, device)
                cases.append(_deposit_case(torch, deposit_tiles, deposit_tiles_plain, geom, args, kw, n_fields,
                                           projection, 5, case="uniform"))
                geom, args = _dense_level_inputs(torch, cfg, bounds[li], bounds[li + 1], n_fields,
                                                 DENSE_N[cfg.K], spec, seed + 1000, device)
                cases.append(_deposit_case(torch, deposit_tiles, deposit_tiles_plain, geom, args, kw, n_fields,
                                           projection, 1, case="dense"))
                if cfg.K in (8, 32) and n_fields == 5:
                    _cluster_extremes(torch, deposit_tiles, deposit_tiles_plain, geom, args, kw, n_fields,
                                      projection)
                if cfg.K == 8:
                    geom, args = _dense_level_inputs(torch, cfg, bounds[li], bounds[li + 1], n_fields, 1 << 20,
                                                     spec, seed + 2000, device, side=2, radii="uniform")
                    cases.append(_deposit_case(torch, deposit_tiles, deposit_tiles_plain, geom, args, kw,
                                               n_fields, projection, 1, case="dense_2x2"))
                del args
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
    from astro_sph_tools_tpu_torch.ops._device import tile_ranges
    from astro_sph_tools_tpu_torch.ops.deposit_tiled import deposit_tiles, deposit_tiles_plain

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
        _, pcount = tile_ranges(tp.sorted_tile[lo:lo + count], geom.n_tiles)
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
        pstart, pcount = tile_ranges(tp.sorted_tile[sl], geom.n_tiles)
        args = (tp.sorted_u[sl], tp.sorted_v[sl], tp.sorted_h[sl], tp.sorted_values[:, sl], pstart, pcount)
        kw = dict(cfg=geom.cfg, kernel="cubic_spline", projection="kernel3d",
                  psx=box / 1024, psy=box / 1024, offset=spec.sample_offset)
        lev["kernel_ms"] = cuda_ms(lambda: deposit_tiles(*args, **kw), 3)
        # the level's bound at main-path size, counted as phase 2 counts it
        lev.update(bound(nbytes(*args, deposit_tiles(*args, **kw)),
                         support_points(args[2], 2.0, box / 1024, 2) * pair_ops(2, "kernel3d")))
        lev["excess_ms"] = lev["kernel_ms"] - lev["bound_ms"]
        # the launch's split, and its densest tile alone
        lev.update(split_stats(torch, _deposit_module()._CLUSTER, pcount, 8, geom.cfg.K))
        t = int(torch.argmax(pcount))
        dense = args[:4] + (pstart[t:t + 1], pcount[t:t + 1])
        lev["densest_tile_ms"] = cuda_ms(lambda: deposit_tiles(*dense, **kw), 3)
        # the densest tile against the plain version at full size, beside
        # the plain version's own spread and both against the f64 sum
        got = deposit_tiles(*dense, **kw)
        ref = deposit_tiles_plain(*dense, **kw)
        ref64 = plain_f64_sum(torch, deposit_tiles_plain, dense, kw)
        lev["densest_tile_max_abs_err"], lev["densest_tile_rel_err"] = rel_err(got, ref)
        lev["densest_tile_plain_repeat_rel_err"] = rel_err(deposit_tiles_plain(*dense, **kw), ref)[1]
        lev["densest_tile_f64_rel_err"] = rel_err(got, ref64)[1]
        lev["densest_tile_plain_f64_rel_err"] = rel_err(ref, ref64)[1]
        del got, ref, ref64
        check(lev["densest_tile_rel_err"] <= REL_TOL, f"phase 3 K={geom.cfg.K}: densest tile off plain: {lev}")
        check_bound({"ms": lev["kernel_ms"], "bound_ms": lev["bound_ms"]}, f"phase 3 K={geom.cfg.K}")
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


def memory_snapshot(x, y, h, m, t, box, metal_seed: int = 19):
    """An in-memory gas-only snapshot (``io.memory.MemorySnapshot``) serving
    device tensors (positions in the z = 0 plane, smoothing lengths,
    masses, temperatures, and metallicities drawn uniformly in [0, 0.04)
    from a ``torch.Generator`` seeded with ``metal_seed``)."""
    import torch

    from astro_sph_tools_tpu_torch.io.memory import MemorySnapshot

    gen = torch.Generator(device=x.device)
    gen.manual_seed(metal_seed)
    z_metal = 0.04 * torch.rand(x.shape[0], generator=gen, device=x.device)
    return MemorySnapshot({"positions": torch.stack([x, y, torch.zeros_like(x)], dim=1), "smoothing_lengths": h,
                           "masses": m, "temperatures": t, "metallicities": z_metal}, box)


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


QUALITY_ASSIGN_LOG2N = 26


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
    out["host_f64_assign"] = quality_assign_timing(torch, device)
    emit({"phase": "quality_f64_assign", **out["host_f64_assign"]})
    check(out["host_f64_assign"]["bitwise_equal"], "native host assignment differs from the torch formulation")


def quality_assign_timing(torch, device, n_log2: int = QUALITY_ASSIGN_LOG2N) -> dict:
    """The host-f64 quality path's assignment at 2^26 particles on a
    periodic 1024^2 map: the torch formulation (``_assign_keys``) against
    the native library's (``_native_assign``, split over the host's cores),
    each alone on the host and inside ``tile_particles`` to ``device``
    (host wall clock, medians of 3), and their outputs compared bit for
    bit."""
    import importlib

    from astro_sph_tools_tpu_torch.ops import MapSpec, tile_particles

    T = importlib.import_module("astro_sph_tools_tpu_torch.ops.deposit_tiled")
    n = 1 << n_log2
    rng = np.random.default_rng(5)
    box = 25.0
    x, y = rng.uniform(0, box, n), rng.uniform(0, box, n)
    h = torch.from_numpy((10.0 ** rng.uniform(-0.7, 1.1, n) * box / 1024).astype(np.float32))
    vals = torch.ones((1, n), dtype=torch.float32)
    spec = MapSpec(shape=(1024, 1024), extent=(0.0, box, 0.0, box), periodic_wrap=True)
    _, bounds, gt = T._assign_setup(spec, T.PALLAS_LEVELS)
    xs, ys = torch.from_numpy(x), torch.from_numpy(y)
    ref = T._assign_keys(xs, ys, h, spec, 2.0, bounds, gt)
    got = T._native_assign(xs, ys, h, spec, 2.0, bounds, gt)
    equal = all(bool(torch.equal(a.to(b.dtype), b)) for a, b in zip(ref, got))
    del ref, got
    out = {"n": n, "host_threads": torch.get_num_threads(), "bitwise_equal": equal}
    for name, fn in (("torch", T._assign_keys), ("native", T._native_assign)):
        out[f"assign_s_{name}"] = wall_s(lambda: fn(xs, ys, h, spec, 2.0, bounds, gt), 3)
    native = T._native_assign
    try:
        for name, fn in (("torch", T._assign_keys), ("native", native)):
            T._native_assign = fn  # the branch tile_particles takes for host f64
            out[f"tile_particles_s_{name}"] = wall_s(
                lambda: tile_particles(x, y, h, vals, spec, need_perm=False, device=device), 3)
    finally:
        T._native_assign = native
    return out


def _coherent_module():
    import importlib

    # ops/__init__ exports a function named like the module
    return importlib.import_module("astro_sph_tools_tpu_torch.ops.deposit_coherent")


def _prep_vs_plain(torch, name, spec, cx, cy, ch, cv):
    """One case of kernel #3 (row prep) vs its plain version, bit for bit,
    on whole 2048-lane rows: its time beside the bound, and the candidate
    rounds the early stop saved."""
    from astro_sph_tools_tpu_torch.ops.coherent_prep import _prep_rows, prep_rounds, prep_rows, prep_rows_plain

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
    rounds = prep_rounds(ref_aux, st)
    heavy = int((aux[:, d + 2] > 0.5).sum())
    n_rows = aux.shape[0]
    case = {
        "phase": "prep_vs_plain", "case": name, "n": cx.shape[0], "periodic": spec.periodic_wrap,
        "mismatched_packed": bad_packed, "mismatched_aux": bad_aux, "max_abs_err": err,
        "ms": cuda_ms(lambda: _prep_rows(cx, cy, ch, cv, st), 5),
        "plain_ms": cuda_ms(lambda: prep_rows_plain(cx, cy, ch, cv, st), 5),
        "heavy_rows": heavy, "coherent_fraction": 1.0 - heavy / n_rows,
        # the early stop: rounds run per row (a barrier each, plus the scan's)
        "rounds_mean": float(rounds.double().mean()),
        "rounds_saved": int((d - rounds).sum()), "rounds_saved_share": float((d - rounds).sum()) / (d * n_rows),
        # assignment arithmetic: about 40 operations a particle
        **bound(nbytes(cx, cy, ch, cv, packed, aux), 40.0 * cx.shape[0]),
    }
    case["bound_share"] = case["bound_ms"] / case["ms"]
    if bad_packed or bad_aux:  # where they differ, for the record
        idx = torch.nonzero(packed != ref_packed)[:5].tolist()
        case["first_packed_mismatches"] = [
            [i, float(packed[tuple(i)]), float(ref_packed[tuple(i)])] for i in idx
        ]
        idx = torch.nonzero(aux != ref_aux)[:5].tolist()
        case["first_aux_mismatches"] = [[i, float(aux[tuple(i)]), float(ref_aux[tuple(i)])] for i in idx]
    emit(case)
    check(bad_packed == 0 and bad_aux == 0, f"row-prep kernel differs from its plain version: {name}")
    check_bound(case, f"row prep, {name}")
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


def coherent_bytes(torch, packed, cand_tile, cand_row, n_fields: int, n_tiles: int, out) -> int:
    """Bytes kernel #2's function must move: the key channel of each
    distinct candidate row (a heavy row, which no candidate names, is not
    read), the u, v, h and value channels of the lanes that match a
    candidate's tile, the candidate arrays, and the accumulators written
    once."""
    C = packed.shape[2]
    key_ch = 3 + n_fields
    live = cand_tile < n_tiles
    rows = cand_row[live].long()
    tiles = cand_tile[live].float()
    matched = 0
    step = 1 << 14  # candidates a chunk of (chunk, C) key compares
    for i in range(0, rows.shape[0], step):
        matched += int((packed[rows[i:i + step], key_ch, :] == tiles[i:i + step, None]).sum())
    n_rows = int(torch.unique(rows).numel())
    f32 = 4
    return (n_rows * C + matched * (3 + n_fields)) * f32 + nbytes(cand_tile, cand_row, out)


def _coherent_vs_plain(torch, lay, spec, h, projection, plain_reps: int, **tags):
    """Kernel #2 (coherent deposit) vs its plain version on a coherent
    layout's candidates, timed beside its bound, with the launch's split and
    its densest tile alone (the other tiles' candidates left out); ``h`` is
    the layout's particles' smoothing lengths (for the bound). With
    ``plain_reps`` 0 the plain version runs once, untimed."""
    TC = _coherent_module()
    g0 = lay.geom0
    n_fields = lay.n_fields
    psy, psx = spec.pixel_size
    tr = torch.arange(g0.n_tiles, dtype=torch.int32, device=lay.cand_tile.device)
    cstart = torch.searchsorted(lay.cand_tile, tr)
    per_tile = torch.searchsorted(lay.cand_tile, tr, right=True) - cstart
    kw = dict(n_fields=n_fields, n_tiles=g0.n_tiles, cfg=g0.cfg, kernel="cubic_spline",
              projection=projection, psx=psx, psy=psy, offset=spec.sample_offset)
    args = (lay.packed, lay.cand_tile, lay.cand_row)
    got = TC.deposit_coherent_tiles(*args, **kw)
    ref = TC.deposit_coherent_tiles_plain(*args, **kw)
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    del ref
    t = int(torch.argmax(per_tile))
    sel = slice(int(cstart[t]), int(cstart[t] + per_tile[t]))
    dense = (lay.packed, lay.cand_tile[sel], lay.cand_row[sel])
    case = {
        "phase": "coherent_kernel_vs_plain", **tags, "F": n_fields, "projection": projection,
        "n_candidates": lay.n_cand, "n_tiles": g0.n_tiles,
        "max_candidates_per_tile": int(per_tile.max()),
        "mean_candidates_per_tile": lay.n_cand / g0.n_tiles,
        **split_stats(torch, TC._CLUSTER, per_tile, 1),
        "max_abs_err": err, "rel_err": rel,
        "ms": cuda_ms(lambda: TC.deposit_coherent_tiles(*args, **kw), 5),
        "densest_tile_ms": cuda_ms(lambda: TC.deposit_coherent_tiles(*dense, **kw), 5),
        "plain_ms": cuda_ms(lambda: TC.deposit_coherent_tiles_plain(*args, **kw), plain_reps) if plain_reps else None,
        **bound(coherent_bytes(torch, *args, n_fields, g0.n_tiles, got),
                support_points(h, 2.0, psx, 2) * pair_ops(n_fields, projection)),
    }
    emit(case)
    check(bool(torch.isfinite(got).all()), f"non-finite coherent kernel output {case}")
    check(rel <= REL_TOL, f"coherent kernel disagrees with its plain version: {case}")
    check_bound(case, f"kernel #2 {tags} F={n_fields} {projection}")
    return case


def dense_coherent_particles(torch, device, n: int, box: float, seed: int):
    """``n`` Morton-ordered clustered particles on 4 x 4 level-0 tiles of
    the 1024^2 map (a pixel in a few hundred footprints on average), support
    radii log-uniform in (0.05, 3] px (the K = 8 level), 4 fields: each tile
    is named by tens of candidate rows."""
    px = box / 1024
    x, y, g = dense_positions(torch, n, 256 * px, 32 * px, seed, device)
    s_pix = 0.05 * 60.0 ** (1.0 - torch.rand(n, generator=g, device=device))
    h = s_pix * px / 2.0
    vals = 0.5 + 1.5 * torch.rand((4, n), generator=g, device=device)
    return x, y, h, vals


def phase_coherent_kernel(torch, device, particles, n_dense: int = 1 << 20):
    """Kernel #2 (coherent deposit) vs its plain version on the main path's
    layout, F in {1, 2, 4} x projection, and on dense tiles (F in {2, 4})."""
    from astro_sph_tools_tpu_torch.ops import MapSpec, tile_particles_coherent

    x, y, h, m, t, box = particles
    spec = MapSpec(shape=(1024, 1024), extent=(0.0, box, 0.0, box), periodic_wrap=True)
    all_fields = [m, m * t, t, 2.0 * m]
    out = []
    for n_fields in (1, 2, 4):
        lay = tile_particles_coherent(x, y, h, torch.stack(all_fields[:n_fields]), spec, device=device)
        for projection in ("kernel3d", "integrated"):
            out.append(_coherent_vs_plain(torch, lay, spec, h, projection, 3, case="main"))
        del lay
    dx, dy, dh, dv = dense_coherent_particles(torch, device, n_dense, box, seed=17)
    TC = _coherent_module()
    for n_fields in (2, 4):
        lay = tile_particles_coherent(dx, dy, dh, dv[:n_fields], spec, device=device)
        for projection in ("kernel3d", "integrated"):
            case = _coherent_vs_plain(torch, lay, spec, dh, projection, 1, case="dense")
            check(case["cluster"] > 1, f"dense coherent case without a cluster split: {case}")
            out.append(case)
            if n_fields == 4:
                # the same tiles over 1 and over 8 blocks (the largest portable cluster)
                g0 = lay.geom0
                psy, psx = spec.pixel_size
                kw = dict(n_fields=n_fields, n_tiles=g0.n_tiles, cfg=g0.cfg, kernel="cubic_spline",
                          projection=projection, psx=psx, psy=psy, offset=spec.sample_offset)
                args = (lay.packed, lay.cand_tile, lay.cand_row)
                ref = TC.deposit_coherent_tiles_plain(*args, **kw)
                for C in (1, 8):
                    err, rel = rel_err(with_cluster(TC, C, lambda: TC.deposit_coherent_tiles(*args, **kw)), ref)
                    row = {"phase": "kernel_vs_plain_cluster", "kernel": "coherent_deposit", "F": n_fields,
                           "projection": projection, "cluster": C, "max_abs_err": err, "rel_err": rel,
                           "ms": cuda_ms(lambda: with_cluster(TC, C, lambda: TC.deposit_coherent_tiles(*args, **kw)),
                                         3)}
                    emit(row)
                    check(rel <= REL_TOL, f"kernel #2 at C={C} disagrees with the plain version: {row}")
                del ref
        del lay
    return out


def _level_vs_plain(torch, geom, args, sl, spec, what: str, f64_run: int = 0, plain_reps: int = 1, **tags):
    """Kernel #1 (sorted-engine deposit) vs its plain version on one
    level's launch ``args`` (u, v, h, values, pstart, pcount), whose
    particles are ``sl`` of the arrays, as the engine launches it; the plain
    version timed over ``plain_reps`` runs (0: untimed). With
    ``f64_run`` > 0 (inputs of thousands of footprints a pixel, where the
    order of two f32 sums alone comes near 1e-5) kernel and plain are also
    held to ``plain_f64_sum`` of the plain version's terms in runs of that
    many, and the kernel is checked against that sum."""
    from astro_sph_tools_tpu_torch.ops.deposit_tiled import deposit_tiles, deposit_tiles_plain

    psy, psx = spec.pixel_size
    kw = dict(cfg=geom.cfg, kernel="cubic_spline", projection="kernel3d", psx=psx, psy=psy,
              offset=spec.sample_offset)
    u, v, h, values, pstart, pcount = args
    n_fields = values.shape[0]
    got = deposit_tiles(*args, **kw)
    ref = deposit_tiles_plain(*args, **kw)
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    case = {
        "phase": "kernel_vs_plain", **tags, "K": geom.cfg.K, "F": n_fields, "projection": "kernel3d",
        "n": int(h[sl].shape[0]), "n_tiles": geom.n_tiles, "max_pcount": int(pcount.max()),
        **split_stats(torch, _deposit_module()._CLUSTER, pcount, 8, geom.cfg.K),
        "max_abs_err": err, "rel_err": rel,
        "ms": cuda_ms(lambda: deposit_tiles(*args, **kw), 5),
        "plain_ms": cuda_ms(lambda: deposit_tiles_plain(*args, **kw), plain_reps) if plain_reps else None,
        **bound(nbytes(u[sl], v[sl], h[sl], values[:, sl], pstart, pcount, got),
                support_points(h[sl], 2.0, psx, 2) * pair_ops(n_fields)),
    }
    if f64_run:
        ref64 = plain_f64_sum(torch, deposit_tiles_plain, args, kw, run=f64_run)
        case.update(f64_run=f64_run, f64_rel_err=rel_err(got, ref64)[1], plain_f64_rel_err=rel_err(ref, ref64)[1])
        del ref64
    del ref
    emit(case)
    check(bool(torch.isfinite(got).all()), f"non-finite {what} kernel output {case}")
    check(case["f64_rel_err" if f64_run else "rel_err"] <= REL_TOL,
          f"{what} kernel disagrees with its plain version: {case}")
    check_bound(case, f"kernel #1 {tags} {what} K={geom.cfg.K}")
    return case


def _tail_levels_vs_plain(torch, lay, spec, plain_reps: int = 1, **tags):
    """Kernel #1 vs its plain version on each level of a coherent layout's
    routed tail, as the coherent render launches it."""
    TC = _coherent_module()
    tu, tv, th, t_values, skey = lay.tail
    out = []
    for li, geom, lo, count in lay.tail_metas:
        pstart, pcount = TC._tail_level_ranges(skey, lay.bases[li], geom, None)
        out.append(_level_vs_plain(torch, geom, (tu, tv, th, t_values, pstart, pcount), slice(lo, lo + count),
                                   spec, "tail-level", plain_reps=plain_reps, **tags))
    return out


def _sorted_levels_vs_plain(torch, tp, f64_run: int = 0, plain_reps: int = 1, **tags):
    """Kernel #1 vs its plain version on each level of a sorted layout, as
    ``deposit_tiled`` launches it (``f64_run``: ``_level_vs_plain``'s)."""
    from astro_sph_tools_tpu_torch.ops._device import tile_ranges

    out = []
    for geom, lo, count in tp.geoms:
        sl = slice(lo, lo + count)
        pstart, pcount = tile_ranges(tp.sorted_tile[sl], geom.n_tiles)
        args = (tp.sorted_u[sl], tp.sorted_v[sl], tp.sorted_h[sl], tp.sorted_values[:, sl], pstart, pcount)
        out.append(_level_vs_plain(torch, geom, args, slice(None), tp.spec, "sorted-level", f64_run, plain_reps,
                                   **tags))
    return out


def path_kernels_vs_plain(torch, device, x, y, h, values, spec, engines, case: str, plain_reps: int = 1) -> dict:
    """Kernels #1-#3 against their plain versions on one input of a path,
    at the shapes the path gives them: with the sorted engine, #1 on each
    level of its layout; with the coherent engine, #3 on its rows (bit for
    bit), #2 on its candidates and #1 on each level of its routed tail.
    ``plain_reps``: runs of #1's and #2's plain versions timed (0: none)."""
    from astro_sph_tools_tpu_torch.ops import tile_particles, tile_particles_coherent

    TC = _coherent_module()
    out = {}
    if "sorted" in engines:
        tp = tile_particles(x, y, h, values, spec, need_perm=False, device=device)
        out["sorted_levels"] = _sorted_levels_vs_plain(torch, tp, plain_reps=plain_reps, case=case)
        del tp
    if "coherent" in engines:
        cx, cy, ch, cv, _ = TC._device_inputs(x, y, h, values, spec, device)
        out["prep"] = _prep_vs_plain(torch, case, spec, cx, cy, ch, cv)
        del cx, cy, ch, cv
        lay = tile_particles_coherent(x, y, h, values, spec, device=device)
        out["coherent_deposit"] = _coherent_vs_plain(torch, lay, spec, h, "kernel3d", plain_reps, case=case)
        out["tail_levels"] = _tail_levels_vs_plain(torch, lay, spec, plain_reps, case=case)
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


# ---------------------------------------------------------------------------
# phase 19: halo-centred map stacks (BASELINE config 5's analysis shape)
# ---------------------------------------------------------------------------


def memory_catalogue(centres, radii, snapshot):
    """An in-memory halo catalogue (``io.memory.MemoryCatalogue``) serving
    what ``render_halo_maps`` reads: centres of potential (Mpc) and SO 200
    crit radii (Mpc); everything else raises."""
    from astro_sph_tools_tpu_torch.io.catalogue import BasicHaloDefinitions
    from astro_sph_tools_tpu_torch.io.memory import MemoryCatalogue

    return MemoryCatalogue(snapshot, centres, {BasicHaloDefinitions.SO_200_CRIT.value: radii})


def halo_catalogue(torch, particles, n_dense: int = HALO_N - 2, grid: int = 64):
    """Phase 19's haloes on phase 3's particles: ``n_dense`` centred on the
    most massive cells of a ``grid``^2 partition of the box (heaviest
    first), one within 0.1 Mpc of the corner (0, 0) and one on the edge
    x ~ box (at the heaviest cell's y), all in the z = 0 plane; R_200 from
    0.15 to 1.0 Mpc in that order, so cutouts are 0.6-4 Mpc across and the
    two edge haloes (the largest) cross the periodic boundary."""
    x, y, h, m, t, box = particles
    cw = box / grid
    ix = torch.clamp((x / cw).long(), 0, grid - 1)
    iy = torch.clamp((y / cw).long(), 0, grid - 1)
    cell_mass = torch.bincount(iy * grid + ix, weights=m.double(), minlength=grid * grid)
    top = torch.topk(cell_mass, n_dense).indices.cpu().numpy()
    centres = [((c % grid + 0.5) * cw, (c // grid + 0.5) * cw, 0.0) for c in top]
    centres.append((0.05, 0.07, 0.0))
    centres.append((box - 0.02, (top[0] // grid + 0.5) * cw, 0.0))
    return np.array(centres), np.geomspace(0.15, 1.0, len(centres))


def cutout_selection(torch, xy, h, centre, half_width: float, box: float, support_factor: float = 2.0):
    """(in-plane offsets from the cutout's centre, indexes) of the particles
    ``render_halo_maps`` selects for a cutout: those whose support reaches it
    after the f64 periodic recentring (its own rule)."""
    from astro_sph_tools_tpu_torch.ops.periodic import shift_centre

    local = shift_centre(xy, centre[:2], box) - box / 2
    reach = half_width + support_factor * h
    sel = torch.nonzero((local[:, 0].abs() < reach) & (local[:, 1].abs() < reach)).squeeze(1)
    return local[sel], sel


def stack_errors(got, ref) -> dict:
    """max|a - b| / max|b| per map; ``mean_*`` maps where the reference
    surface density exceeds 1e-3 of its maximum (elsewhere they divide two
    near-zero maps)."""
    sd = np.asarray(ref["surface_density"])
    covered = sd > 1e-3 * sd.max()
    out = {}
    for name in ref.keys():
        a, b = np.asarray(got[name], np.float64), np.asarray(ref[name], np.float64)
        if name.startswith("mean_"):
            a, b = a[covered], b[covered]
        out[name] = float(np.abs(a - b).max() / np.abs(b).max())
    return out


def phase_halo(torch, device, particles):
    """``render_halo_maps`` (sorted engine, kernel #1) at 1024^2 x 3 fields
    on 16 haloes of phase 3's 2^26 particles; see the module docstring."""
    from astro_sph_tools_tpu_torch import render_halo_maps
    from astro_sph_tools_tpu_torch.data_structures import ParticleType
    from astro_sph_tools_tpu_torch.ops import MapSpec, deposit_2d_auto, tile_particles
    from astro_sph_tools_tpu_torch.ops.deposit_tiled import deposit_tiles
    from astro_sph_tools_tpu_torch.ops.deposit_wide import deposit_wide

    x, y, h, m, t, box = particles
    snap = memory_snapshot(*particles)
    centres, radii = halo_catalogue(torch, particles)
    cat = memory_catalogue(centres, radii, snap)
    kw = dict(fields=("density", "temperature", "metallicity"), resolution=HALO_RES, device=device)
    haloes = list(range(len(radii)))

    steps = {}  # host seconds of each step of this phase
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        torch.cuda.synchronize()
        steps[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    # the main path, once, with the launch counts reset just before it
    deposit_tiles.launches = 0
    deposit_wide.launches = 0
    stacks = render_halo_maps(snap, cat, haloes, engine="pallas", **kw)
    torch.cuda.synchronize()
    launches = deposit_tiles.launches
    wide_launches = deposit_wide.launches
    check(launches > 0, "render_halo_maps launched no deposit kernel")
    lap("main_path")

    xy = torch.stack([x, y], dim=1).double()
    h64 = h.double()
    c = HALO_RES // 2
    rows = []
    for k, stack in enumerate(stacks):
        before = deposit_tiles.launches
        render_halo_maps(snap, cat, [k], engine="pallas", **kw)
        hw = 2 * float(radii[k])
        local, sel = cutout_selection(torch, xy, h64, centres[k], hw, box)
        spec = MapSpec(shape=(HALO_RES, HALO_RES), extent=(-hw, hw, -hw, hw))
        tp = tile_particles(local[:, 0], local[:, 1], h64[sel], m[sel], spec, device=device)
        row = {
            "halo": k, "centre_cMpc": centres[k].tolist(), "r200_cMpc": float(radii[k]),
            "cutout_cMpc": 2 * hw, "particles": int(sel.shape[0]),
            # the sorted engine's level occupancy and its oversize route (the
            # plain stencil engine's wide windows and dense pass)
            "level_counts": {geom.cfg.K: count for geom, _, count in tp.geoms}, "oversize": tp.n_oversize,
            "launches": deposit_tiles.launches - before,
            "finite": bool(all(np.isfinite(v).all() for v in stack.maps.values())),
            "centre_surface_density": float(stack["surface_density"][c - 1:c + 1, c - 1:c + 1].mean()),
            "max_surface_density": float(stack["surface_density"].max()),
        }
        del local, sel, tp
        rows.append(row)
        emit({"phase": "halo_maps_halo", **row, "timings_s": stack.timings})
        check(row["finite"], f"halo {k}: non-finite map")
        check(row["centre_surface_density"] > 0, f"halo {k}: no surface density at the cutout's centre")
        check(set(stack.keys()) == {"surface_density", "mass_weighted_temperature", "mean_temperature",
                                    "mass_weighted_metallicity", "mean_metallicity"}, f"halo {k}: maps {stack.keys()}")

    lap("per_halo")

    # the four smallest cutouts against the plain stencil engine on the card
    smallest = [int(k) for k in np.argsort(radii)[:4]]
    ref = render_halo_maps(snap, cat, smallest, engine="xla", **kw)
    xla_errs = {k: stack_errors(stacks[k], r) for k, r in zip(smallest, ref)}
    del ref
    lap("xla")
    emit({"phase": "halo_maps_check", "xla_rel_err": xla_errs})
    for k, errs in xla_errs.items():
        check(max(errs.values()) <= PATH_TOL, f"halo {k} off engine='xla': {errs}")

    # the smallest cutout against the host-f64 quality path: the same
    # selected particles, recentred in f64, assigned in f64 on the host
    k0 = smallest[0]
    hw = 2 * float(radii[k0])
    local, sel = cutout_selection(torch, xy, h64, centres[k0], hw, box)
    z_metal = snap.get_metallicities(ParticleType.gas).value
    values = torch.stack([m, m * t, m * z_metal])[:, sel].double().cpu().numpy()
    spec = MapSpec(shape=(HALO_RES, HALO_RES), extent=(-hw, hw, -hw, hw))
    f64_maps = deposit_2d_auto(local[:, 0].cpu().numpy(), local[:, 1].cpu().numpy(),
                               h64[sel].cpu().numpy(), values, spec, device=device).cpu().numpy()
    del local, sel, values
    f64_errs = {name: rel_err(stacks[k0][name], f64_maps[i])[1] for i, name in
                enumerate(("surface_density", "mass_weighted_temperature", "mass_weighted_metallicity"))}
    lap("f64")
    emit({"phase": "halo_maps_check", "f64_halo": k0, "f64_rel_err": f64_errs})
    check(max(f64_errs.values()) <= PATH_TOL, f"halo {k0} off the host-f64 path: {f64_errs}")

    # each edge halo against the same particles translated by half a box
    # (f64 on the card) before the render
    edge = [len(radii) - 2, len(radii) - 1]
    xt = torch.remainder(x.double() + box / 2, box)
    yt = torch.remainder(y.double() + box / 2, box)
    moved = memory_snapshot(xt, yt, h, m, t, box)
    moved_centres = centres.copy()
    moved_centres[:, :2] = np.mod(centres[:, :2] + box / 2, box)
    moved_stacks = render_halo_maps(moved, memory_catalogue(moved_centres, radii, moved), edge,
                                    engine="pallas", **kw)
    edge_errs = {k: stack_errors(stacks[k], s) for k, s in zip(edge, moved_stacks)}
    del xt, yt, moved, moved_stacks
    lap("edge")
    emit({"phase": "halo_maps_check", "edge_rel_err": edge_errs})
    for k, errs in edge_errs.items():
        check(max(errs.values()) <= PATH_TOL, f"edge halo {k} off its translated render: {errs}")

    # warm wall of the 16-halo call, device busy share, peak memory
    del stacks
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    last = {}

    def render_all():
        last["stacks"] = render_halo_maps(snap, cat, haloes, engine="pallas", **kw)

    wall = wall_s(render_all, 3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for row, stack in zip(rows, last.pop("stacks")):
        row["timings_s"] = stack.timings
    lap("warm_walls")
    busy_ms, prof_wall_ms, top_ms = device_busy_ms(render_all, top=8)
    del last
    lap("profiled")
    out = {
        "phase": "halo_maps", "n": x.shape[0], "haloes": len(radii), "map": [HALO_RES, HALO_RES], "fields": 3,
        "launches": launches, "wide_launches": wide_launches, "per_halo": rows,
        "xla_rel_err": xla_errs, "f64_halo": k0, "f64_rel_err": f64_errs, "edge_rel_err": edge_errs,
        "wall_s": wall, "haloes_per_s": len(radii) / wall,
        "profiled_wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": None if busy_ms is None else 1.0 - busy_ms / prof_wall_ms,
        "device_ms_by_kernel": top_ms, "peak_mem_gb": peak, "steps_s": steps,
    }
    emit(out)
    out["wide_cases"] = wide_route_cases(torch, device)
    return out


WIDE_CELL_CONFIG = "sphbench/configs/eagle_l0025_halomaps.json"  # the benchmark's halo cell ...
WIDE_CELL_HALOES = (0, 14, 15)  # ... and the haloes it asks for
WIDE_CELL_SEED = 3_000_000_019
CUBE_CELL_CONFIG = "sphbench/configs/eagle_l0025_cube512.json"  # phase 25: the benchmark's cube cell
CUBE_CELL_SEED = 3_000_000_025
CUBE_PLAIN_N = 4096  # oversize particles the plain route takes in phase 25 (~0.5 ms each)


def wide_route_cases(torch, device) -> list:
    """The oversize route's kernels at the halo cell's shapes (phase 19; see
    the module docstring): per halo, the cutout's oversize segment of the
    sorted layout, timed through ``deposit_wide`` (binning and deposit), its
    parts, and ``deposit_wide_plain`` once; checked against the plain route
    and for repeatability."""
    from astro_sph_tools_tpu_torch.ops import MapSpec, deposit_2d, tile_particles
    from astro_sph_tools_tpu_torch.ops import deposit_wide as W
    from sphbench.counting import clipped_support_points, pair_ops
    from sphbench.generators import clustered

    with open(os.path.join(ROOT, WIDE_CELL_CONFIG)) as f:
        cfg = json.load(f)
    snap = cfg["snapshot"]
    inputs = clustered.generate(snap, WIDE_CELL_SEED, device)
    centres, r200 = clustered.haloes(snap, cfg["haloes"])
    box = inputs["box"]
    res = int(cfg["product"]["resolution"])
    xy = inputs["positions"][:, :2].double()
    h64 = inputs["smoothing_lengths"].double()
    m = inputs["masses"]
    values = torch.stack([m, m * inputs["temperatures"], m * inputs["metallicities"]])
    del inputs
    kernel = cfg["kernel"]
    rows = []
    for k in WIDE_CELL_HALOES:
        hw = float(cfg["product"]["radius_multiple"]) * float(r200[k])
        local, sel = cutout_selection(torch, xy, h64, centres[k], hw, box)
        spec = MapSpec(shape=(res, res), extent=(-hw, hw, -hw, hw))
        tp = tile_particles(local[:, 0], local[:, 1], h64[sel].float(), values[:, sel], spec, kernel=kernel,
                            device=device)
        del local
        sl = slice(tp.n_sorted - tp.n_oversize, tp.n_sorted)
        u, v, hh, vals = tp.sorted_u[sl], tp.sorted_v[sl], tp.sorted_h[sl], tp.sorted_values[:, sl]
        kw = dict(kernel=kernel, projection="kernel3d")
        F = vals.shape[0]

        def route(out=None):
            out = torch.zeros((F, res, res), device=device) if out is None else out
            return W.deposit_wide(u, v, hh, vals, spec, out=out, **kw)

        before = W.deposit_wide.launches
        got = route()
        again = route()
        torch.cuda.synchronize()
        launches = W.deposit_wide.launches - before
        ref = W.deposit_wide_plain(u, v, hh, vals, spec, out=torch.zeros_like(got), **kw)
        # the yardstick: the plain route in f64 on the same placed particles
        # (up to ~1e5 footprints a pixel: the plain f32 route's one running
        # sum a pixel drifts by ~1e-4 of the max there)
        psy, psx = spec.pixel_size
        x0, _, y0, _ = spec.extent
        f64 = deposit_2d(u.double() * psx + x0, v.double() * psy + y0, hh.double(), vals.T.double(), spec,
                         dtype=torch.float64, device=device, **kw).permute(2, 0, 1)
        err = max(rel_err(got[f], f64[f])[1] for f in range(F))
        plain_err = max(rel_err(ref[f], f64[f])[1] for f in range(F))
        vs_plain = max(rel_err(got[f], ref[f])[1] for f in range(F))
        del f64
        repeat = bool(torch.equal(got, again))
        # the parts: the binning's two passes and the deposit on its lists
        geo, scale, lim2 = W.particle_geometry(u, v, hh, psx=psx, psy=psy, **kw)
        counts = W._bin_counts(geo, lim2, spec, plain=False)
        starts = torch.nn.functional.pad(torch.cumsum(counts, 0, dtype=torch.int64), (1, 0))
        pairs = int(starts[-1])
        lists = W._bin_lists(geo, lim2, spec, starts, pairs, plain=False)
        lists_equal = bool(torch.equal(counts, W.tile_counts_plain(geo, lim2, spec))
                           and torch.equal(lists, W.tile_lists_plain(geo, lim2, spec)))
        out = torch.zeros_like(got)
        route_ms = cuda_ms(lambda: route(out), 5)
        bin_ms = cuda_ms(lambda: (W._bin_counts(geo, lim2, spec, plain=False),
                                  W._bin_lists(geo, lim2, spec, starts, pairs, plain=False)), 5)
        deposit_ms = cuda_ms(lambda: W._deposit(geo, scale, vals, starts, lists, spec, lim2=lim2, out=out,
                                                plain=False, **kw), 5)
        plain_ms = cuda_ms(lambda: W.deposit_wide_plain(u, v, hh, vals, spec, out=out, **kw), 1)
        # the least time: the pairs inside the supports, clipped to the map
        s_pix = 2.0 * hh.double() / psx
        inside = clipped_support_points(u, v, s_pix, res, res)
        moved = 4.0 * (3 + F) * u.shape[0] + 2 * 4.0 * F * res * res
        b = bound(moved, inside * pair_ops(F, kernel))
        row = {
            "halo": k, "cutout_cMpc": 2 * hw, "particles": int(sel.shape[0]), "oversize": tp.n_oversize,
            "launches": launches, "tile_pairs": pairs, "pairs_inside": inside,
            "evaluated_over_inside": pairs * W.TILE * W.TILE / inside if inside else None,
            "route_ms": route_ms, "bin_ms": bin_ms, "deposit_ms": deposit_ms, "plain_ms": plain_ms, **b,
            "rel_err_vs_f64": err, "plain_rel_err_vs_f64": plain_err, "rel_err_vs_plain": vs_plain,
            "repeatable": repeat, "lists_equal_plain": lists_equal,
        }
        del tp, sel, u, v, hh, vals, got, again, ref, geo, scale, counts, starts, lists, out
        emit({"phase": "halo_maps_wide", **row})
        rows.append(row)
        check(err <= REL_TOL, f"halo {k}: oversize route off the f64 plain route: {err}")
        check(repeat, f"halo {k}: two runs of the oversize route differ")
        check(lists_equal, f"halo {k}: the tile lists differ from their plain version")
        check(deposit_ms >= b["bound_ms"], f"halo {k}: the oversize deposit under its bound")
    del xy, h64, values
    torch.cuda.empty_cache()
    return rows


BOX_CELL_CONFIG = "sphbench/configs/eagle_l0025_boxmap.json"  # phase 26: the benchmark's box cells
BOX_CELL_SEED = 3_000_000_026
BOX_CHECK_TILES = 8  # tiles of each level held to the f64 sum besides the densest


def register_lane_work(torch, u, v, h, cfg, psx: float, psy: float, offset: float,
                       support_factor: float = 2.0) -> dict:
    """Lane evaluations of one K >= 32 level's launch, from each particle's
    loop box as ``particle_setup`` draws it (kernel3d: support radius
    ``support_factor`` h, slack 0.01 px + 1e-4 radius, clamped to the
    accumulator and to the K-column window): the register path evaluates
    32 lanes for every (row pair, 16-column group) the box meets; the
    warp-a-particle design it replaced, the box's pixels in steps of 32."""
    from astro_sph_tools_tpu_torch.ops.deposit_tiled import _LANES

    K, R = cfg.K, cfg.R
    ry = support_factor * h / psy
    rx = support_factor * h / psx
    cy, cx = v - offset, u - offset
    col0 = torch.floor(u - offset + 0.5) - K // 2
    r_lo = torch.ceil(torch.clamp(cy - ry - (0.01 + 1e-4 * ry), min=-1.0)).clamp(min=0)
    r_hi = torch.floor(torch.clamp(cy + ry + (0.01 + 1e-4 * ry), max=float(R))).clamp(max=R - 1)
    c_lo = torch.maximum(torch.ceil(torch.clamp(cx - rx - (0.01 + 1e-4 * rx), min=-1.0)), col0).clamp(min=0)
    c_hi = torch.minimum(torch.floor(torch.clamp(cx + rx + (0.01 + 1e-4 * rx), max=float(_LANES))),
                         col0 + K - 1).clamp(max=_LANES - 1)
    live = (h > 0) & (r_lo <= r_hi) & (c_lo <= c_hi)
    r_lo, r_hi, c_lo, c_hi = (a[live].long() for a in (r_lo, r_hi, c_lo, c_hi))
    steps = (r_hi // 2 - r_lo // 2 + 1) * (c_hi // 16 - c_lo // 16 + 1)
    box = (r_hi - r_lo + 1) * (c_hi - c_lo + 1)
    return {"register_lane_evals": 32.0 * float(steps.double().sum()),
            "warp_lane_evals": 32.0 * float(((box + 31) // 32).double().sum()),
            "box_pixels": float(box.double().sum())}


def box_level_cases(torch, device) -> list:
    """Kernel #1's K >= 32 levels at the box cells' shapes (phase 26; see
    the module docstring)."""
    from astro_sph_tools_tpu_torch.ops import MapSpec, deposit_coherent, deposit_tiled, tile_particles
    from astro_sph_tools_tpu_torch.ops.deposit_coherent import tile_particles_coherent
    from astro_sph_tools_tpu_torch.ops._device import tile_ranges
    from astro_sph_tools_tpu_torch.ops.deposit_tiled import REGISTER_MIN_K, deposit_tiles, deposit_tiles_plain
    from astro_sph_tools_tpu_torch.utils.profiling import device_trace, spans
    from sphbench.counting import pair_ops
    from sphbench.generators import clustered

    with open(os.path.join(ROOT, BOX_CELL_CONFIG)) as f:
        cfg = json.load(f)
    snap = cfg["snapshot"]
    inputs = clustered.generate(snap, BOX_CELL_SEED, device)
    box = inputs["box"]
    res = int(cfg["product"]["resolution"])
    kernel = cfg["kernel"]
    m = inputs["masses"]
    values = torch.stack([m, m * inputs["temperatures"]])
    spec = MapSpec(shape=(res, res), extent=(0.0, box, 0.0, box), periodic_wrap=True)
    xyh = (inputs["positions"][:, 0], inputs["positions"][:, 1], inputs["smoothing_lengths"])
    tp = tile_particles(*xyh, values, spec, kernel=kernel, device=device)
    n_all = int(inputs["positions"].shape[0])

    def traced_counts(render, name):
        """The counters of the span ``name`` in a traced ``render()``, and
        the launches and register-path launches of #1 it made."""
        before = (deposit_tiles.launches, deposit_tiles.register_launches)
        with device_trace(device=device):
            render()
        made = {"launches": deposit_tiles.launches - before[0],
                "register_launches": deposit_tiles.register_launches - before[1]}
        return next(sp["counts"] for sp in spans() if sp["name"] == name), made

    # the spans' counters: the sorted engine's levels, the coherent engine's
    # tail (the cells' particles are in curve order)
    levels_counts, levels_made = traced_counts(lambda: deposit_tiled(tp), "deposit.levels")
    layout = tile_particles_coherent(*xyh, values, spec, kernel=kernel, device=device)
    tail_counts, tail_made = traced_counts(lambda: deposit_coherent(layout), "deposit.tail")
    del layout, inputs, values, m, xyh
    wide_levels = sum(g.cfg.K >= REGISTER_MIN_K for g, _, _ in tp.geoms)
    emit({"phase": "box_levels", "deposit.levels": levels_counts, "deposit.tail": tail_counts,
          "wide_levels": wide_levels, "tail_launches_made": tail_made})
    check(levels_counts["register_launches"] == levels_made["register_launches"] == wide_levels > 0,
          f"deposit.levels counts {levels_counts}, {wide_levels} levels from K = {REGISTER_MIN_K}")
    check(tail_counts["register_launches"] == tail_made["register_launches"] > 0
          and tail_counts["launches"] == tail_made["launches"], f"deposit.tail counts {tail_counts}: {tail_made}")
    psy, psx = spec.pixel_size
    kw = dict(kernel=kernel, projection="kernel3d", psx=psx, psy=psy, offset=spec.sample_offset)
    g = torch.Generator(device="cpu")
    g.manual_seed(BOX_CELL_SEED)
    rows = []
    for geom, lo, count in tp.geoms:
        if geom.cfg.K < REGISTER_MIN_K:
            continue
        sl = slice(lo, lo + count)
        pstart, pcount = tile_ranges(tp.sorted_tile[sl], geom.n_tiles)
        args = (tp.sorted_u[sl], tp.sorted_v[sl], tp.sorted_h[sl], tp.sorted_values[:, sl], pstart, pcount)
        lkw = dict(cfg=geom.cfg, **kw)
        got = deposit_tiles(*args, **lkw)
        repeat = bool(torch.equal(got, deposit_tiles(*args, **lkw)))
        ms = cuda_ms(lambda: deposit_tiles(*args, **lkw), 5)
        inside = support_points(args[2], 2.0, psx, 2)
        b = bound(nbytes(*args, got), inside * pair_ops(2, kernel))
        work = register_lane_work(torch, args[0], args[1], args[2], geom.cfg, psx, psy, spec.sample_offset)
        # the densest tile and tiles drawn from the seed against the f64 sum
        filled = torch.nonzero(pcount > 0).squeeze(1).cpu()
        pick = filled[torch.randperm(filled.shape[0], generator=g)[:BOX_CHECK_TILES]].tolist()
        errs = []
        for t in [int(torch.argmax(pcount))] + pick:
            one = args[:4] + (pstart[t:t + 1], pcount[t:t + 1])
            ref64 = plain_f64_sum(torch, deposit_tiles_plain, one, lkw)
            errs.append(rel_err(got[t:t + 1], ref64)[1])
            del ref64
        row = {
            "K": geom.cfg.K, "F": 2, "particles": count, "share_of_particles": count / n_all,
            "n_tiles": geom.n_tiles, "tx": geom.tx, "max_pcount": int(pcount.max()),
            "ms": ms, **b, "pairs_inside": inside,
            "lane_efficiency": work["register_lane_evals"] / inside,
            "warp_lane_efficiency": work["warp_lane_evals"] / inside,
            "box_over_inside": work["box_pixels"] / inside,
            "repeatable": repeat, "f64_checked_tiles": len(errs),
            "densest_tile_f64_rel_err": errs[0], "f64_rel_err": max(errs),
        }
        emit({"phase": "box_levels", **row})
        rows.append(row)
        del got, args
        check(repeat, f"K={geom.cfg.K}: two launches of the register path differ")
        check(row["f64_rel_err"] <= REL_TOL, f"K={geom.cfg.K}: register path off the f64 sum: {row}")
        check(ms >= b["bound_ms"], f"K={geom.cfg.K}: kernel #1 under its bound: {row}")
    del tp
    torch.cuda.empty_cache()
    return rows


def grid_route_cases(torch, device) -> dict:
    """The 3D oversize route at the cube cell's shapes (phase 25; see the
    module docstring): the layout's oversize segment of the cell's
    particles, timed through ``deposit_3d_wide`` (binning and deposit) and
    its parts, held to the float64 reference scatter and, on a subset, to
    the plain route."""
    import ctypes

    from astro_sph_tools_tpu_torch import _build
    from astro_sph_tools_tpu_torch.kernels.splines import get_kernel
    from astro_sph_tools_tpu_torch.ops import GridSpec, tile_particles_3d
    from astro_sph_tools_tpu_torch.ops import grid3d_wide as W
    from astro_sph_tools_tpu_torch.utils.profiling import span, spans
    from sphbench.counting import pair_ops
    from sphbench.generators import clustered
    from sphbench.reference import box_cube

    with open(os.path.join(ROOT, CUBE_CELL_CONFIG)) as f:
        cfg = json.load(f)
    res, kernel = int(cfg["product"]["resolution"]), cfg["kernel"]
    inputs = clustered.generate(cfg["snapshot"], CUBE_CELL_SEED, device)
    box = inputs["box"]
    m = inputs["masses"]
    spec = GridSpec(shape=(res,) * 3, extent=(0.0, box) * 3, periodic_wrap=True)
    tp = tile_particles_3d(inputs["positions"], inputs["smoothing_lengths"],
                           torch.stack([m, m * inputs["temperatures"]]), spec, kernel=kernel, device=device)
    del inputs, m
    n, n_over = tp.n_valid, tp.n_oversize
    sl = slice(tp.n_sorted - n_over, tp.n_sorted)
    u, v, w, hh = (a[sl].contiguous() for a in (tp.sorted_u, tp.sorted_v, tp.sorted_w, tp.sorted_h))
    vals = tp.sorted_values[:, sl].contiguous()
    del tp
    torch.cuda.empty_cache()
    F = vals.shape[0]
    vox = box / res

    def refuse(*a, **k):
        raise AssertionError("the stencil engine ran on the card")

    plain_engine, W.deposit_3d = W.deposit_3d, refuse  # no plain fallback on the card
    try:
        W.deposit_3d_wide.launches = 0
        got = W.deposit_3d_wide(u, v, w, hh, vals, spec, kernel=kernel, out=torch.zeros((F, res, res, res),
                                                                                         device=device))
        torch.cuda.synchronize()
        launches = W.deposit_3d_wide.launches
        again = W.deposit_3d_wide(u, v, w, hh, vals, spec, kernel=kernel, out=torch.zeros_like(got))
        repeat = bool(torch.equal(got, again))
        del again
        # the parts: the binning (every batch's lists), the deposit on them
        batches = list(W.tile_lists(u, v, w, hh, spec, kernel=kernel))
        entries = sum(int(b[3].shape[0]) for b in batches)
        out = torch.zeros_like(got)
        route_ms = cuda_ms(lambda: W.deposit_3d_wide(u, v, w, hh, vals, spec, kernel=kernel, out=out), 3)
        bin_ms = cuda_ms(lambda: list(W.tile_lists(u, v, w, hh, spec, kernel=kernel)), 3)

        def deposit():
            for p0, p1, starts, lists in batches:
                W._deposit(u[p0:p1], v[p0:p1], w[p0:p1], hh[p0:p1], vals[:, p0:p1], starts, lists, spec,
                           kernel=kernel, out=out)

        deposit_ms = cuda_ms(deposit, 3)
        # the walk's counters, from one traced pass (None on a tree without them)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with span("deposit3d.oversize"):
                W.deposit_3d_wide(u, v, w, hh, vals, spec, kernel=kernel, out=out)
            torch.cuda.synchronize()
        walk = [s["counts"] for s in spans() if s["name"] == "deposit3d.oversize"][-1]
        del batches, out
    finally:
        W.deposit_3d = plain_engine
    walk_lanes, walk_pairs = walk.get("walk_lanes"), walk.get("walk_pairs")
    # the kernel's registers, spill (local) bytes and shared bytes a block at F (None on a tree without them)
    lib, _ = _build.load("deposit3d_wide")
    resources = None
    if hasattr(lib, "wide3d_deposit_attributes"):
        attrs = (ctypes.c_int * 3)()
        _build.check(lib, lib.wide3d_deposit_attributes(get_kernel(kernel).kernel_id, F, attrs), "deposit3d_wide")
        resources = dict(zip(("registers", "local_bytes", "shared_bytes"), attrs))
    # the yardstick: the f64 scatter of the same placed particles (world
    # coordinates from the global voxel coordinates, as the plain route takes them)
    ref = box_cube.scatter(torch.stack([u, v, w], dim=1).double() * vox, hh.double(), vals.double(), (res,) * 3,
                           box, kernel=kernel)
    errs = [rel_err(got[f], ref[f]) for f in range(F)]
    del ref
    # the plain route on a strided subset, beside the route on it, both
    # held to the f64 scatter there (the plain route places its particles
    # again from f32 world coordinates, ~1e-5 of a lone support's peak off)
    idx = torch.arange(0, n_over, max(1, n_over // CUBE_PLAIN_N), device=device)[:CUBE_PLAIN_N]
    sub = [a[idx].contiguous() for a in (u, v, w, hh)] + [vals[:, idx].contiguous()]
    plain = torch.zeros_like(got)
    plain_ms = cuda_ms(lambda: W.deposit_3d_wide_plain(*sub, spec, kernel=kernel, out=plain), 1)
    small = W.deposit_3d_wide(*sub, spec, kernel=kernel, out=torch.zeros_like(got))
    ref = box_cube.scatter(torch.stack(sub[:3], dim=1).double() * vox, sub[3].double(), sub[4].double(),
                           (res,) * 3, box, kernel=kernel)
    sub_err = max(rel_err(small[f], ref[f])[1] for f in range(F))
    plain_err = max(rel_err(plain[f], ref[f])[1] for f in range(F))
    del plain, small, got, ref
    inside = support_points(hh, 2.0, vox, 3)
    b = bound(4.0 * (4 + F) * n_over + 2 * 4.0 * F * res ** 3, inside * pair_ops(F, kernel))
    row = {
        "phase": "grid_route", "n": n, "grid": [res] * 3, "fields": F, "oversize": n_over,
        "oversize_share": n_over / n, "s_vox": [2.0 * float(hh.min()) / vox, 2.0 * float(hh.max()) / vox],
        "launches": launches, "tile_pairs": entries, "pairs_inside": inside,
        "route_ms": route_ms, "bin_ms": bin_ms, "deposit_ms": deposit_ms, **b,
        "walk_lanes": walk_lanes, "walk_pairs": walk_pairs,
        "walk_efficiency": walk_pairs / walk_lanes if walk_lanes else None, "kernel_resources": resources,
        "max_abs_err": max(e[0] for e in errs), "rel_err_vs_f64": max(e[1] for e in errs),
        "repeatable": repeat, "plain_subset_n": int(idx.shape[0]), "plain_ms": plain_ms,
        "plain_ms_whole_segment": plain_ms * n_over / int(idx.shape[0]), "subset_rel_err_vs_f64": sub_err,
        "subset_plain_rel_err_vs_f64": plain_err,
    }
    emit(row)
    del u, v, w, hh, vals, sub
    torch.cuda.empty_cache()
    check(launches >= 1 and entries > 0, f"the route made {launches} launches over {entries} list entries")
    check(row["rel_err_vs_f64"] <= REL_TOL, f"the 3D oversize route off the f64 reference: {row['rel_err_vs_f64']}")
    check(sub_err <= REL_TOL, f"the 3D oversize route off the f64 reference on the subset: {sub_err}")
    check(repeat, "two runs of the 3D oversize route differ")
    check(deposit_ms >= b["bound_ms"], "the 3D oversize deposit under its bound")
    return row


CUBE_LEVEL_PLAIN_N = 1 << 18  # particles of each level phase 27 holds to the plain version
CUBE_LEVEL_TOL = 1e-6  # phase 27: the kernel against the plain version on that subset, of the max


def cube_level_cases(torch, device) -> list:
    """Kernel #6 at the cube cell's level populations (phase 27; see the
    module docstring). Written against the wrapper's public surface and
    ``_region_candidates``, so that the same phase times a parent tree's
    kernel; counters the tree lacks read None."""
    from astro_sph_tools_tpu_torch.ops import GridSpec, deposit_3d_tiled, tile_particles_3d
    from astro_sph_tools_tpu_torch.ops import grid3d_tiled as G
    from astro_sph_tools_tpu_torch.ops._device import tile_ranges
    from astro_sph_tools_tpu_torch.utils.profiling import device_trace, spans
    from sphbench.counting import pair_ops
    from sphbench.generators import clustered

    with open(os.path.join(ROOT, CUBE_CELL_CONFIG)) as f:
        cfg = json.load(f)
    res, kernel = int(cfg["product"]["resolution"]), cfg["kernel"]
    inputs = clustered.generate(cfg["snapshot"], CUBE_CELL_SEED, device)
    box = inputs["box"]
    m = inputs["masses"]
    spec = GridSpec(shape=(res,) * 3, extent=(0.0, box) * 3, periodic_wrap=True)
    tp = tile_particles_3d(inputs["positions"], inputs["smoothing_lengths"],
                           torch.stack([m, m * inputs["temperatures"]]), spec, kernel=kernel, device=device)
    del inputs, m
    torch.cuda.empty_cache()
    F, vox = tp.n_fields, box / res
    counted = hasattr(G.deposit_3d_tiles, "candidates")

    # the span's counters over one traced pass of the levels
    before = (G.deposit_3d_tiles.candidates, G.deposit_3d_tiles.blocks) if counted else None
    with device_trace(device=device):
        deposit_3d_tiled(tp)
    span_counts = next((sp["counts"] for sp in spans() if sp["name"] == "deposit3d.levels"), {})
    made = ((G.deposit_3d_tiles.candidates - before[0], G.deposit_3d_tiles.blocks - before[1]) if counted
            else None)
    rows = []
    for geom, lo, count in tp.geoms:
        sl = slice(lo, lo + count)
        pstart, pcount = tile_ranges(tp.sorted_tile[sl], geom.n_tiles)
        args = (tp.sorted_u[sl], tp.sorted_v[sl], tp.sorted_w[sl], tp.sorted_h[sl], tp.sorted_values[:, sl],
                pstart, pcount)
        kw = G._level_args(geom, spec, kernel)
        tables = G._candidate_tables(geom, spec.shape, True, device)
        counts = G._region_candidates(pcount, geom, tables)
        split_region = counts > G._REGION_CANDIDATES
        candidates = int(counts.sum())
        got = G.deposit_3d_tiles(*args, torch.zeros((F, res, res, res), device=device), **kw)
        again = G.deposit_3d_tiles(*args, torch.zeros_like(got), **kw)
        # bit for bit on every voxel of the regions no split shares
        split_vox = split_region.view(geom.ntz, geom.nty, geom.ntx)
        for axis, T_ in ((0, geom.cfg.TZ), (1, geom.cfg.TY), (2, geom.cfg.TX)):
            split_vox = torch.repeat_interleave(split_vox, T_, dim=axis)
        split_vox = split_vox[:res, :res, :res]
        repeat = not bool(((got != again) & ~split_vox).any())
        del again, split_vox
        out = torch.zeros_like(got)
        ms = cuda_ms(lambda: G.deposit_3d_tiles(*args, out, **kw), 5)
        del out
        # a strided subset of the level (still tile-sorted), kernel and plain
        step = max(1, count // CUBE_LEVEL_PLAIN_N)
        sub_sl = slice(lo, lo + count, step)
        sub = tuple(a[sub_sl].contiguous() for a in (tp.sorted_u, tp.sorted_v, tp.sorted_w, tp.sorted_h))
        sub += (tp.sorted_values[:, sub_sl].contiguous(), *tile_ranges(tp.sorted_tile[sub_sl], geom.n_tiles))
        n_sub = int(sub[0].shape[0])
        k_sub = G.deposit_3d_tiles(*sub, torch.zeros_like(got), **kw)
        p_sub = G.deposit_3d_tiles_plain(*sub, torch.zeros_like(got), **kw)
        err, rel = rel_err(k_sub, p_sub)
        del k_sub, p_sub, sub
        pairs = support_points(args[3], 2.0, vox, 3)
        b = bound(4.0 * (4 + F) * count + 2 * 4.0 * F * res ** 3, pairs * pair_ops(F, kernel))
        row = {
            "phase": "cube_levels", "K": geom.cfg.K, "F": F, "particles": count, "n_tiles": geom.n_tiles,
            "max_pcount": int(pcount.max()), "pairs_inside": pairs, "ms": ms, **b,
            "s_per_pair": ms * 1e-3 / pairs, "candidates": candidates, "candidates_per_particle": candidates / count,
            "active_regions": int((counts > 0).sum()), "split_regions": int(split_region.sum()),
            "max_candidates": int(counts.max()), "plain_subset_n": n_sub,
            "plain_max_abs_err": err, "plain_rel_err": rel, "repeatable_unsplit": repeat,
        }
        emit(row)
        rows.append(row)
        del got, args
        check(rel <= CUBE_LEVEL_TOL, f"K={geom.cfg.K}: kernel #6 off its plain version: {row}")
        check(repeat, f"K={geom.cfg.K}: two launches of kernel #6 differ on unsplit regions")
        check(ms >= b["bound_ms"], f"K={geom.cfg.K}: kernel #6 under its bound: {row}")
    total = sum(r["candidates"] for r in rows)
    emit({"phase": "cube_levels", "counted": counted, "span": span_counts,
          "made": list(made) if made else None, "candidates": total,
          "kernel_ms": sum(r["ms"] for r in rows), "bound_ms": sum(r["bound_ms"] for r in rows)})
    if counted:
        check(span_counts.get("candidates") == made[0] == total and span_counts.get("blocks") == made[1] > 0,
              f"deposit3d.levels counts {span_counts}, the work lists {total} candidates, made {made}")
    del tp
    torch.cuda.empty_cache()
    return rows


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


def column_work(torch, lay, hits: float) -> dict:
    """What kernel #4 scans on a column layout: its pair tests (every
    candidate of every (level, ray, cell row) item against the item's ray),
    per expected hit, its items and the largest item's particles; and the
    candidates of the distinct ray cells alone, which a kernel that tested
    each candidate against all rays of its cell would read."""
    from astro_sph_tools_tpu_torch.ops.sightlines_fused import ray_spans

    lo, hi = ray_spans(lay.bounds, lay.rays, lay.grids, lay.periodic)
    per_item = (hi - lo).clamp_min(0).sum(-1)
    pairs = int(per_item.sum())
    cells = lay.rays[1]  # each level's ray cells, in order
    first = torch.ones_like(cells, dtype=torch.bool)
    first[:, 1:] = cells[:, 1:] != cells[:, :-1]
    distinct = int(per_item.sum(-1)[first].sum())
    return {"pair_tests": pairs, "pair_tests_per_hit": pairs / hits, "items": lay.n_items,
            "max_item_particles": int(per_item.max()), "mean_item_particles": pairs / lay.n_items,
            "distinct_cell_candidates": distinct, "pair_tests_per_distinct_candidate": pairs / max(distinct, 1)}


def block_work(torch, x, y, h, m, rx, ry, periodic_box, hits: float) -> dict:
    """The same counts for the block schedule the column kernel took
    before its per-ray items, and the spectra keep: blocks of 8 cell-sorted
    rays, each candidate of a block's 10 spans tested against all 8."""
    from astro_sph_tools_tpu_torch.ops.sightlines_fused import _B, stage_rays

    lay = stage_rays(x, y, h, [m], rx, ry, support_factor=2.0, periodic_box=periodic_box, B=_B)
    spans = (lay.hi - lay.lo).clamp_min(0).sum(dim=1)
    pairs = int(spans.sum()) * _B
    return {"pair_tests": pairs, "pair_tests_per_hit": pairs / hits, "items": lay.n_blocks,
            "max_item_particles": int(spans.max())}


def phase_columns_kernel(torch, device, sl, n_rays: int = 2048):
    """Kernel #4 vs its plain version on the fused layout of the config-4
    particles; two launches compared bit for bit; the pair tests and items
    of this kernel and of the block schedule it replaced."""
    from astro_sph_tools_tpu_torch.ops.sightlines_fused import (
        _columns_layout, columns_tiles, columns_tiles_plain,
    )

    pos, h, m, T, v = sl["pos"], sl["h"], sl["m"], sl["T"], sl["v_pec"]
    x, y = pos[:, 0].contiguous(), pos[:, 1].contiguous()
    fields5 = torch.stack([m, m * T, m * v, h, T], dim=1)
    rx, ry = sl["rx"][:n_rays], sl["ry"][:n_rays]
    # expected (ray, particle) pairs inside a support, rays uniform over the box
    hits = support_points(h, 2.0, 1.0, 2) * n_rays / SIGHT_BOX**2
    out = []
    for periodic in (True, False):
        box = SIGHT_BOX if periodic else None
        blocks = block_work(torch, x, y, h, m, rx, ry, box, hits)
        for n_fields in (1, 5):
            lay, _, _ = _columns_layout(x, y, h, fields5[:, :n_fields], rx, ry, kernel="cubic_spline",
                                        periodic_box=box, device=device)
            args = (lay.packed, lay.bounds, lay.rx, lay.ry, lay.rays, lay.grids)
            work = column_work(torch, lay, hits)
            for projection in ("kernel3d", "integrated"):
                kw = dict(n_fields=n_fields, kernel="cubic_spline", projection=projection,
                          periodic=lay.periodic, Lx=lay.Lx, Ly=lay.Ly)
                got = columns_tiles(*args, **kw)
                again = columns_tiles(*args, **kw)
                ref = columns_tiles_plain(*args, **kw)
                torch.cuda.synchronize()
                err, rel = rel_err(got, ref)
                case = {
                    "phase": "columns_kernel_vs_plain", "projection": projection, "periodic": periodic,
                    "F": n_fields, "n": pos.shape[0], "n_rays": n_rays, "n_levels": len(lay.grids),
                    "expected_hits": hits, **work, "block_schedule": blocks,
                    "same_bits_twice": bool(torch.equal(got, again)),
                    "max_abs_err": err, "rel_err": rel,
                    "ms": cuda_ms(lambda: columns_tiles(*args, **kw), 5),
                    "plain_ms": cuda_ms(lambda: columns_tiles_plain(*args, **kw), 3),
                    **bound(nbytes(*args[:5], got), hits * pair_ops(n_fields, projection)),
                }
                case["bound_share"] = case["bound_ms"] / case["ms"]
                emit(case)
                check(bool(torch.isfinite(got).all()), f"non-finite column kernel output {case}")
                check(rel <= REL_TOL, f"column kernel disagrees with its plain version: {case}")
                check(case["same_bits_twice"], f"column kernel gave other bits on a second launch: {case}")
                check_bound(case, f"column kernel, {projection}, periodic {periodic}, F {n_fields}")
                out.append(case)
            del lay, args
    return out


# exp(-z^2) rounds to 0 in f32 once z^2 > 103.3 (below the least subnormal)
GAUSS_Z_MAX = math.sqrt(103.3)
VOIGT_CORE_X = 7.0  # ops/spectra.py::voigt_hjerting: the Chebyshev fit of corr(x) for |x| <= 7
# FP32 operations of a line profile, from ops/spectra.py's arithmetic (an
# FMA counts 2). A term is one bin at one velocity image, z = (dv + k v_box) / b.
TERM_OPS = 2  # each term: the scale by 1/b, x^2
IMAGE_OPS = 2  # each term past the first of its bin: the image offset k v_box, the sum over images
EXP_OPS = 4  # exp(-x^2): range reduction and scaling around the hardware exp2
CHEB_OPS = 96  # corr(x), |x| <= 7: u = x / 3.5 - 1 and 2u (3), 30 Clenshaw steps (90), the last (3)
SERIES_OPS = 12  # corr(x), |x| > 7: t = 1/x^2 (1), five Horner steps (10), times -t (1)
GAUSS_TERM_OPS = TERM_OPS + EXP_OPS  # 6
# exp(-x^2) (1 + a^2 (1 - 2 x^2)): exp (4), the factor (4), the product (1)
VOIGT_EXP_OPS = EXP_OPS + 4 + 1
VOIGT_CORE_OPS = TERM_OPS + CHEB_OPS + VOIGT_EXP_OPS  # 107
VOIGT_WING_EXP_OPS = TERM_OPS + SERIES_OPS + VOIGT_EXP_OPS  # 23
VOIGT_SERIES_OPS = TERM_OPS + SERIES_OPS  # 14
# once a (particle, bin): the offset from the line, its wrap, the scale by
# 1 / (sqrt(pi) b); a Voigt also H = g - a / sqrt(pi) corr over the images' sums (2)
BIN_OPS = 3
VOIGT_BIN_OPS = BIN_OPS + 2


def spectra_work(torch, sl, n_rays: int, n_bins: int, periodic: bool, profile: str, n_images: int,
                 box: float = SIGHT_BOX) -> dict:
    """The FP32 operations that kernel #5's function needs on this run's
    particles, as expected values over uniform random rays. A particle of
    smoothing length h is hit by lam = pi (2 h)^2 n_rays / box^2 rays, and by
    at least one with probability 1 - exp(-lam). The work is:

    * per hit, its column weight (``pair_ops(0, "integrated")``);
    * per particle hit at all, its profile once (the rays share it), term by
      term (a term: one bin at one velocity image, at z = (dv + k v_box) / b):

      - Gaussian, ``GAUSS_TERM_OPS`` = 6, only where |z| < ``GAUSS_Z_MAX``
        (exp(-z^2) is 0 in f32 beyond): a window of 2 * 10.16 b around the
        line, folded over the 2n + 1 images when the velocities wrap, cut at
        the bin range when they do not; for config 4, ~160 of 2,560 terms;
      - Voigt, by the branch ``voigt_hjerting`` takes: ``VOIGT_CORE_OPS`` =
        107 where |z| <= 7 (the Chebyshev core and exp), ``VOIGT_WING_EXP_OPS``
        = 23 where 7 < |z| <= 10.16 (the series and exp) and
        ``VOIGT_SERIES_OPS`` = 14 beyond (the series alone, exp being 0).
        Each line's bins at the 2n + 1 images cover |z| up to (n + 1/2)
        v_box / b, so the counts are 14 b / dv, 6.3 b / dv and the rest of
        the n_bins (2n + 1) terms, each cut as the Gaussian's window is; at
        config 4's temperatures (median b 18 km/s, dv = 2.9 km/s, 7 images)
        3.1 % core, 1.4 % series and exp, 95.5 % series alone;
      - ``IMAGE_OPS`` = 2 for each term past the first of its bin (its image
        offset and the sum over images; a Voigt term's second sum, into the
        exp part, is not counted: the bound errs low), and once per bin where
        the profile is not 0, ``BIN_OPS`` = 3 (the offset from the line, its
        wrap, the normalisation), ``VOIGT_BIN_OPS`` = 5 with the Voigt's
        combination of its two sums; so a Voigt term that is series alone
        costs 16 and 5/7 at 7 images;
    * per hit, one multiply-add into tau at every bin where the profile is
      not 0.

    The kernel does more: it evaluates a particle's profile once for each
    ray block whose rays hit it (``spectra_live_work``)."""
    from astro_sph_tools_tpu_torch.ops.spectra import _spectra_inputs

    (_, _, h, _, v, b), v_box, vc = _spectra_inputs(
        sl["pos"], sl["h"], sl["m"], sl["v_pec"], sl["T"], cosmology=sl["cosmology"], box_size=box,
        atomic_weight=1.008, n_bins=n_bins, periodic=periodic, device=sl["pos"].device,
    )
    h, v, b = h.double(), v.double(), b.double()
    lam = math.pi * (2.0 * h) ** 2 * (n_rays / box**2)
    hit_any = -torch.expm1(-lam)
    images = 2 * n_images + 1
    dv = float(vc[1]) - float(vc[0])
    total = float(n_bins * images)
    lo, hi = float(vc[0]) - 0.5 * dv, float(vc[-1]) + 0.5 * dv

    def within(radius):
        """Expected terms with |dv + k v_box| < radius: the images of a
        periodic axis tile it, an open one is cut at the bin range."""
        if periodic and v_box is not None:
            return torch.clamp(2.0 * radius / dv, max=total)
        return (torch.clamp(v + radius, max=hi) - torch.clamp(v - radius, min=lo)).clamp_min(0.0) / dv

    near = within(GAUSS_Z_MAX * b)
    if profile == "voigt":
        core = within(VOIGT_CORE_X * b)
        series = (total - near).clamp_min(0.0)
        terms = torch.full_like(h, total)
        term_ops = core * VOIGT_CORE_OPS + (near - core) * VOIGT_WING_EXP_OPS + series * VOIGT_SERIES_OPS
        bins = torch.full_like(h, float(n_bins))
        bin_ops = VOIGT_BIN_OPS
        shares = {"voigt_core_share": float((hit_any * core).sum() / (hit_any * terms).sum()),
                  "voigt_wing_exp_share": float((hit_any * (near - core)).sum() / (hit_any * terms).sum())}
    else:
        terms = near
        term_ops = terms * GAUSS_TERM_OPS
        bins = torch.clamp(terms, max=float(n_bins))
        bin_ops = BIN_OPS
        shares = {}
    profile_ops = term_ops + (terms - bins) * IMAGE_OPS + bins * bin_ops
    ops = hit_any * profile_ops + lam * (2.0 * bins + pair_ops(0, "integrated"))
    return {"ops": float(ops.sum()), "hits": float(lam.sum()), "particles_hit": float(hit_any.sum()),
            "profile_terms_per_particle_hit": float((hit_any * terms).sum() / hit_any.sum()),
            "velocity_images": images, **shares}


def spectra_live_work(torch, lay, vc_t, v_box, n_images: int, profile: str, S: float = 2.0) -> dict:
    """What kernel #5 does on this layout, counted in torch from the same
    arithmetic: its (ray block, live particle) pairs (a particle some ray
    of the block hits: the kernel evaluates its profile once per pair), the
    distinct live particles, the hits (the FMA rows), and the profile terms
    it evaluates (each pair's window of bins times its images,
    ``line_windows``)."""
    from astro_sph_tools_tpu_torch.ops.sightlines_fused import _pair_geometry, _span_entries
    from astro_sph_tools_tpu_torch.ops.spectra_fused import line_windows

    blk_all, idx_all = _span_entries(lay.lo, lay.hi)
    seen = torch.zeros(lay.packed.shape[1], dtype=torch.bool, device=lay.packed.device)
    block_pairs = torch.zeros(lay.n_blocks, dtype=torch.int64, device=lay.packed.device)
    pairs = hits = terms = 0
    step = 1 << 17
    for c0 in range(0, blk_all.shape[0], step):
        blk, idx = blk_all[c0:c0 + step], idx_all[c0:c0 + step]
        b2, hs, inv_h = _pair_geometry(lay.packed, lay.rx, lay.ry, blk, idx, lay.periodic, lay.Lx, lay.Ly)
        inv_sh = inv_h[:, None] * (1.0 / S)
        hit = (b2 * (inv_sh * inv_sh) < 1.0) & (hs > 0.0)[:, None]
        live = hit.any(dim=1)
        ix = idx[live]
        seen[ix] = True
        block_pairs.index_add_(0, blk[live], torch.ones_like(ix))
        pairs += int(live.sum())
        hits += int(hit.sum())
        win = line_windows(lay.packed[4, ix], lay.packed[5, ix], vc_t, v_box=v_box, n_images=n_images,
                           profile=profile)
        terms += int((win.length.long() * (2 * win.images.long() + 1)).sum())
    particles = int(seen.sum())
    scanned = (lay.hi - lay.lo).clamp_min(0).sum(dim=1)
    return {"n_blocks": lay.n_blocks, "particles_scanned": int(scanned.sum()),
            "max_block_scanned": int(scanned.max()), "max_block_live_pairs": int(block_pairs.max()),
            "live_pairs": pairs, "particles_live": particles,
            "live_pairs_per_particle": pairs / max(particles, 1), "kernel_hits": hits,
            "kernel_terms": terms, "kernel_terms_per_pair": terms / max(pairs, 1)}


def awkward_lines(cosmology, n: int = 3000, n_rays: int = 64, n_bins: int = 512, seed: int = 23):
    """A small sightline set whose lines sit where kernel #5's windows are
    awkward, as NumPy arrays (pos, h, m, v_pec, T, rx, ry, box) for a 10 cMpc
    periodic box under ``cosmology``: line centres at the velocity edges (0, v_box / 2, just
    below v_box, a third of a bin beyond either end) and uniform, Doppler
    widths from a tenth of a bin to 0.6 v_box (the widest take every bin and,
    for the Gaussian, 3 images a side), supports wide enough that most
    particles are hit."""
    from astro_sph_tools_tpu_torch.ops.spectra import doppler_parameter_kms

    box = 10.0
    rng = np.random.default_rng(seed)
    dv_dx = cosmology.hubble_rate() * cosmology.expansion_factor
    v_box = box * dv_dx
    dv = v_box / n_bins
    pos = rng.uniform(0.0, box, (n, 3))
    h = np.exp(rng.normal(np.log(0.4), 0.3, n))
    m = rng.uniform(0.5, 2.0, n).astype(np.float32)
    b = np.geomspace(0.1 * dv, 0.6 * v_box, n)
    rng.shuffle(b)
    T = b**2 / doppler_parameter_kms(1.0, 1.008) ** 2
    edges = np.array([0.0, 0.5 * v_box, v_box - 1e-3 * dv, -dv / 3.0, v_box + dv / 3.0])
    v_eff = np.where(np.arange(n) % 2 == 0, edges[rng.integers(0, len(edges), n)], rng.uniform(0.0, v_box, n))
    v_pec = (v_eff - pos[:, 2] * dv_dx).astype(np.float32)
    rx, ry = rng.uniform(0.0, box, n_rays), rng.uniform(0.0, box, n_rays)
    return pos, h, m, v_pec, T, rx, ry, box


def _spectra_case(torch, device, sl, n_rays: int, n_bins: int, periodic: bool, profile: str,
                  box: float, reps: int) -> dict:
    """Kernel #5 against its plain version on one layout: errors, times, the
    work the function needs (``spectra_work``) and what the kernel does
    (``spectra_live_work``)."""
    from astro_sph_tools_tpu_torch.ops.spectra import _resolve_profile
    from astro_sph_tools_tpu_torch.ops.spectra_fused import _spectra_layout, spectra_tiles, spectra_tiles_plain

    lay, vc, v_box, n_images = _spectra_layout(
        sl["pos"], sl["h"], sl["m"], sl["v_pec"], sl["T"], sl["rx"][:n_rays], sl["ry"][:n_rays],
        cosmology=sl["cosmology"], box_size=box, atomic_weight=1.008, n_bins=n_bins,
        kernel="cubic_spline", periodic=periodic, profile=profile, device=device,
    )
    vc_t = torch.as_tensor(vc, device=device)
    args = (lay.packed, lay.rx, lay.ry, lay.lo, lay.hi, vc_t)
    kw = dict(kernel="cubic_spline", periodic=lay.periodic, Lx=lay.Lx, Ly=lay.Ly, v_box=v_box,
              n_images=n_images, profile=profile, voigt_k=_resolve_profile(profile, GAMMA_LYA, 1215.67))
    got = spectra_tiles(*args, **kw)
    ref = spectra_tiles_plain(*args, **kw)
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    spans = (lay.hi - lay.lo).clamp_min(0).sum(dim=1)
    work = spectra_work(torch, sl, n_rays, n_bins, periodic, profile, n_images, box=box)
    case = {
        "profile": profile, "periodic": periodic, "n": sl["pos"].shape[0], "n_rays": n_rays,
        "n_bins": n_bins, "n_blocks": lay.n_blocks, "n_levels": len(lay.rorders), "n_images": n_images,
        "particles_scanned": int(spans.sum()), **{k: x for k, x in work.items() if k != "ops"},
        **spectra_live_work(torch, lay, vc_t, v_box, n_images, profile),
        "max_abs_err": err, "rel_err": rel,
        "ms": cuda_ms(lambda: spectra_tiles(*args, **kw), reps),
        "plain_ms": cuda_ms(lambda: spectra_tiles_plain(*args, **kw), 1),
        **bound(nbytes(*args, got), work["ops"]),
    }
    case["bound_share"] = case["bound_ms"] / case["ms"]
    check(bool(torch.isfinite(got).all()), f"non-finite spectra kernel output {case}")
    check(rel <= REL_TOL, f"spectra kernel disagrees with its plain version: {case}")
    return case


def check_spectra_bound(case: dict, what: str) -> None:
    """A kernel faster than the least time for its work means the work was
    miscounted: fail, rather than print a share over 100 %."""
    check(case["ms"] >= case["bound_ms"],
          f"{what}: kernel #5 took {case['ms']} ms, under its bound {case['bound_ms']} ms: the count is wrong")


def phase_spectra_kernel(torch, device, sl, n_rays: int = 256, n_bins: int = 512):
    """Kernel #5 vs its plain version on the fused layout of the config-4
    particles, and on ``awkward_lines``."""
    pos, h, m, v_pec, T, rx, ry, box = awkward_lines(sl["cosmology"], n_bins=n_bins)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)
    awk = {"pos": f32(pos), "h": f32(h), "m": f32(m), "v_pec": f32(v_pec), "T": f32(T), "rx": rx, "ry": ry,
           "cosmology": sl["cosmology"]}
    out = []
    for name, data, rays, data_box in (("config4", sl, n_rays, SIGHT_BOX), ("awkward", awk, len(rx), box)):
        for periodic in (True, False):
            for profile in ("gaussian", "voigt"):
                case = {"phase": "spectra_kernel_vs_plain", "input": name,
                        **_spectra_case(torch, device, data, rays, n_bins, periodic, profile, data_box, 3)}
                emit(case)
                check_spectra_bound(case, f"phase 11 {name} {profile} periodic={periodic}")
                out.append(case)
    return out


def phase_sightlines(torch, device, sl, n_check: int = 256, n_bins: int = 512):
    """The config-4 path at full size: columns and spectra (Gaussian and
    Voigt) through the fused engines."""
    from astro_sph_tools_tpu_torch.ops import (
        absorption_spectra, absorption_spectra_binned, absorption_spectra_pallas, column_integrate_binned,
        column_integrate_pallas,
    )
    from astro_sph_tools_tpu_torch.ops import sightlines_fused as SF
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

    # the walls split: layout (device sort + host ray schedule) and kernel;
    # the columns' layout also as its domain read (the particles' extremes),
    # the device sort (level/cell sort, gather, bounds table) and the ray
    # cells (sent to the device and sorted there)
    col_layout = lambda: _columns_layout(x, y, h, m, rx, ry, kernel="cubic_spline", periodic_box=SIGHT_BOX,
                                         device=device)
    rays_w, x0, y0, Lx, Ly, s_max = SF._domain(x, y, h, np.stack([rx, ry]), 2.0, SIGHT_BOX)
    grids = SF._choose_grids(Lx, Ly, s_max)
    columns_split_s = {
        "domain": wall_s(lambda: SF._domain(x, y, h, np.stack([rx, ry]), 2.0, SIGHT_BOX), 3),
        "device_sort": wall_s(lambda: SF._sort_particles(x, y, h, [m], grids, 2.0, (x0, y0, Lx, Ly), True), 3),
        "ray_cells": wall_s(lambda: SF._ray_table(rays_w, grids, x0, y0, Lx, Ly, device), 3),
    }
    spec_layout = lambda prof: _spectra_layout(
        pos, h, m, v, T, rx, ry, cosmology=cosmo, box_size=SIGHT_BOX, atomic_weight=1.008, n_bins=n_bins,
        kernel="cubic_spline", periodic=True, profile=prof, device=device)
    layout_s = {"columns": wall_s(col_layout, 3), "spectra": wall_s(lambda: spec_layout("gaussian"), 3)}
    lay = col_layout()[0]
    kernel_ms = {"columns": cuda_ms(lambda: columns_tiles(
        lay.packed, lay.bounds, lay.rx, lay.ry, lay.rays, lay.grids, n_fields=1, kernel="cubic_spline",
        projection="integrated", periodic=True, Lx=lay.Lx, Ly=lay.Ly), 3)}
    columns_split_s["kernel"] = kernel_ms["columns"] / 1e3
    col_hits = support_points(h, 2.0, 1.0, 2) * n_rays / SIGHT_BOX**2
    columns_work = {
        **column_work(torch, lay, col_hits), "ms": kernel_ms["columns"],
        **bound(nbytes(lay.packed, lay.bounds, lay.rx, lay.ry, lay.rays) + 4 * n_rays,
                col_hits * pair_ops(1, "integrated")),
    }
    columns_work["bound_share"] = columns_work["bound_ms"] / columns_work["ms"]
    check_bound(columns_work, "phase 12 columns")
    kernel_bound = {}
    for prof in ("gaussian", "voigt"):
        lay, vc_np, v_box, n_img = spec_layout(prof)
        vc_t = torch.as_tensor(vc_np, device=device)
        kernel_ms[f"spectra_{prof}"] = cuda_ms(lambda: spectra_tiles(
            lay.packed, lay.rx, lay.ry, lay.lo, lay.hi, vc_t, kernel="cubic_spline", periodic=True,
            Lx=lay.Lx, Ly=lay.Ly, v_box=v_box, n_images=n_img, profile=prof,
            voigt_k=_resolve_profile(prof, GAMMA_LYA, 1215.67)), 3)
        # each full-size launch's bound beside its time, and what the kernel did
        work = spectra_work(torch, sl, n_rays, n_bins, True, prof, n_img)
        kernel_bound[f"spectra_{prof}"] = {
            **{k: x for k, x in work.items() if k != "ops"},
            **spectra_live_work(torch, lay, vc_t, v_box, n_img, prof),
            **bound(nbytes(lay.packed, lay.rx, lay.ry, lay.lo, lay.hi, vc_t) + n_rays * n_bins * 4, work["ops"]),
            "ms": kernel_ms[f"spectra_{prof}"],
        }
        kernel_bound[f"spectra_{prof}"]["bound_share"] = kernel_bound[f"spectra_{prof}"]["bound_ms"] / kernel_ms[
            f"spectra_{prof}"]
        check_spectra_bound(kernel_bound[f"spectra_{prof}"], f"phase 12 {prof}")
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
        "columns_split_s": columns_split_s, "columns_work": columns_work,
        "kernel_ms": kernel_ms, "kernel_bound": kernel_bound,
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
    from astro_sph_tools_tpu_torch.ops._device import tile_ranges
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
    pstart, pcount = tile_ranges(tile, geom.n_tiles)
    return geom, (ul[perm], vl[perm], wl[perm], h[perm], vals[:, perm].contiguous(), pstart, pcount)


def region_work(torch, geom, spec, pcount, periodic=None) -> dict:
    """Kernel #6's work list for one level: output regions with candidates,
    thread blocks (a region past the split is shared by several, which add
    with atomics), and the largest and the mean candidate count."""
    from astro_sph_tools_tpu_torch.ops.grid3d_tiled import _candidate_tables, _region_candidates, _region_items

    periodic = spec.periodic_wrap if periodic is None else periodic
    tables = _candidate_tables(geom, spec.shape, periodic, pcount.device)
    items, max_cand, _ = _region_items(pcount, geom, tables)
    counts = _region_candidates(pcount, geom, tables)
    return {"regions": int((counts > 0).sum()), "blocks": items.shape[0],
            "split_blocks": int(items[:, 3].sum()), "max_candidates": max_cand,
            "mean_candidates": float(counts.double().mean())}


def phase_voxel_kernel(torch, device, n: int = 1 << 18, npix: int = 256):
    """Kernel #6 (3D voxel deposit) vs its plain version, every level."""
    from astro_sph_tools_tpu_torch.ops import PALLAS_3D_LEVELS, GridSpec
    from astro_sph_tools_tpu_torch.ops import grid3d_tiled as G
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
                work = region_work(torch, geom, spec, args[6])
                deposit_3d_tiles(*args, got, **kw)
                deposit_3d_tiles_plain(*args, ref, **kw)
                torch.cuda.synchronize()
                err, rel = rel_err(got, ref)
                case = {
                    "phase": "voxel_kernel_vs_plain", "K": cfg.K, "F": n_fields, "periodic": periodic,
                    "grid": [npix] * 3, "n": n, "n_tiles": geom.n_tiles,
                    "max_pcount": int(args[6].max()), **work, "max_abs_err": err, "rel_err": rel,
                    "ms": cuda_ms(lambda: deposit_3d_tiles(*args, got, **kw), 5),
                    "plain_ms": cuda_ms(lambda: deposit_3d_tiles_plain(*args, ref, **kw), 3),
                    **bound(nbytes(*args, got), support_points(args[3], 2.0, vox, 3) * pair_ops(n_fields)),
                }
                emit(case)
                check(bool(torch.isfinite(got).all()), f"non-finite 3D kernel output {case}")
                check(rel <= REL_TOL, f"3D kernel disagrees with its plain version: {case}")
                out.append(case)
                del got, ref, args
    # grids the tiles do not divide, boxes that fold over a small periodic
    # axis, per-axis periodicity; 1,500 particles on a few tiles, at the
    # default region split and at 512 candidates a block, leave some regions
    # whole and split others over blocks
    default = G._REGION_CANDIDATES
    try:
        for gi, (shape, periodic) in enumerate((((20, 20, 20), True), ((20, 20, 20), False), ((4, 6, 20), True),
                                                ((24, 16, 40), (True, False, True)))):
            spec = GridSpec(shape=shape, extent=(0.0, VOX_BOX) * 3, periodic_wrap=periodic is True)
            for li, cfg in enumerate(PALLAS_3D_LEVELS):
                geom, args = _voxel_level_inputs(
                    torch, cfg, bounds[li], bounds[li + 1], 3, 1500, spec, seed=300 + 10 * gi + li, device=device,
                )
                kw = _level_args(geom, spec, "cubic_spline")
                kw["periodic"] = periodic
                for split in dict.fromkeys((default, 512)):
                    G._REGION_CANDIDATES = split
                    got = torch.zeros((3, *shape), device=device)
                    ref = torch.zeros_like(got)
                    deposit_3d_tiles(*args, got, **kw)
                    deposit_3d_tiles_plain(*args, ref, **kw)
                    torch.cuda.synchronize()
                    err, rel = rel_err(got, ref)
                    case = {
                        "phase": "voxel_kernel_vs_plain", "K": cfg.K, "F": 3, "periodic": periodic,
                        "grid": list(shape), "n": 1500, "split": split,
                        **region_work(torch, geom, spec, args[6], periodic), "max_abs_err": err, "rel_err": rel,
                    }
                    emit(case)
                    check(bool(torch.isfinite(got).all()), f"non-finite 3D kernel output {case}")
                    check(rel <= REL_TOL, f"3D kernel disagrees with its plain version: {case}")
                    out.append(case)
                    del got, ref
                del args
    finally:
        G._REGION_CANDIDATES = default
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
    from astro_sph_tools_tpu_torch.ops._device import tile_ranges
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
        pstart, pcount = tile_ranges(tp.sorted_tile[sl], geom.n_tiles)
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
            **region_work(torch, geom, spec, pcount),
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
    from astro_sph_tools_tpu_torch.ops._device import tile_ranges
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
            pstart, pcount = tile_ranges(tp.sorted_tile[sl], geom.n_tiles)
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


def phase_voxel_split(torch, device, n_log2: int):
    """Kernel #6's time per level on phase 14's layout at three region
    splits (the candidates one block takes before a region is shared by
    blocks that add with atomics), each held against the default's cube."""
    from astro_sph_tools_tpu_torch.ops import GridSpec, tile_particles_3d
    from astro_sph_tools_tpu_torch.ops import grid3d_tiled as G
    from astro_sph_tools_tpu_torch.ops._device import tile_ranges

    ng = VOX_GRID
    spec = GridSpec(shape=(ng,) * 3, extent=(0.0, VOX_BOX) * 3, periodic_wrap=True)
    pos, h, m, v = voxel_particles(torch, device, 1 << n_log2, VOX_BOX, seed=11)
    h = torch.clamp(h, max=3.5 * VOX_BOX / ng)
    fields = torch.stack([m, m * v[:, 0], m * v[:, 1], m * v[:, 2]])
    del v
    tp = tile_particles_3d(pos, h, fields, spec, device=device)
    default = G._REGION_CANDIDATES
    out = []
    try:
        for geom, lo, count in tp.geoms:
            sl = slice(lo, lo + count)
            pstart, pcount = tile_ranges(tp.sorted_tile[sl], geom.n_tiles)
            args = (tp.sorted_u[sl], tp.sorted_v[sl], tp.sorted_w[sl], tp.sorted_h[sl], tp.sorted_values[:, sl],
                    pstart, pcount)
            kw = G._level_args(geom, spec, "cubic_spline")
            ref = None
            for split in dict.fromkeys((default, 512, 2048, 8192, 32768)):
                G._REGION_CANDIDATES = split
                grid = torch.zeros((4, ng, ng, ng), device=device)
                G.deposit_3d_tiles(*args, grid, **kw)
                torch.cuda.synchronize()
                if ref is None:
                    ref = grid.clone()
                case = {"phase": "voxel_split", "K": geom.cfg.K, "count": count, "split": split,
                        **region_work(torch, geom, spec, pcount), "rel_err_vs_default": rel_err(grid, ref)[1],
                        "kernel_ms": cuda_ms(lambda: G.deposit_3d_tiles(*args, grid, **kw), 5)}
                emit(case)
                check(case["rel_err_vs_default"] <= REL_TOL, f"region splits disagree: {case}")
                out.append(case)
                del grid
            del ref, args
    finally:
        G._REGION_CANDIDATES = default
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
    band), at 2^24 records and at four times as many (a fixed cost per
    launch stays, a cost per byte grows), (d) runs of mostly one record."""
    from astro_sph_tools_tpu_torch.ops import layout_shear as LS

    g = torch.Generator(device=device)
    g.manual_seed(16)
    out = []
    sizes = {"single_key": (1 << 24, 1), "single_key_x4": (1 << 26, 1), "one_record_runs": (1 << 21, 1 << 14)}
    for name in ("coarse", "fine", "single_key", "single_key_x4", "one_record_runs"):
        if name in ("coarse", "fine"):
            ops, n_keys, assign = _shear_stage_a_inputs(torch, name, particles)
        else:
            n, n_keys = sizes[name]
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
            # ten alternating pairs, kernel (a) and index_select (b), each a
            # median of 5: the spread of both in one run
            "pairs_vs_index_select": alternating_ms(
                lambda: LS.append_gangs(gangs, sched, n_gang),
                lambda: torch.index_select(gangs, 0, src_of_dst), 10, 5),
            # the same with ten back-to-back calls a timing (ms for all ten):
            # the host's time to launch each call then overlaps the card's
            # work instead of adding to it
            "pairs_vs_index_select_x10": alternating_ms(
                lambda: [LS.append_gangs(gangs, sched, n_gang).shape for _ in range(10)],
                lambda: [torch.index_select(gangs, 0, src_of_dst).shape for _ in range(10)], 10, 3),
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


# ---------------------------------------------------------------------------
# phase 20: streamed snapshot to map (the JAX package's benchmarks/e2e_1e8.py)
# ---------------------------------------------------------------------------

E2E_LOG2N = 27  # 2^27 gas particles ...
E2E_FILES = 8  # ... in 8 Morton-sorted "files" ...
E2E_CHUNKS = 4  # ... streamed as 4 macro-chunks of 2^25
E2E_BOX = 25.0  # Mpc, periodic, 1024^2
E2E_HUBBLE = 0.6777  # the EAGLE fixture's h: positions and h are stored x h ...
E2E_MASS_CGS = 1.989e43  # ... and masses in units of 1e10 Msun (this many g), x h
MASS_SCALE = 2.0**20  # the benchmark's power-of-two f16 scales (Msun, K)
TEMP_SCALE = 2.0**16
E2E_COMBOS = (("f32", "sorted"), ("f32", "coherent"), ("pack", "sorted"),
              ("packdelta", "sorted"), ("packdelta", "coherent"))


def sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _interleave16_t(xq, yq):
    """u16 values (int64 tensors) -> u32 Morton codes, as
    ``io.packing._interleave16``."""
    def spread(v):
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v

    return spread(xq) | (spread(yq) << 1)


def e2e_files(torch, device, n_log2: int, n_files: int = E2E_FILES, res: int = 1024, seed: int = 11) -> list:
    """The JAX package's ``write_big_snapshot`` distribution, drawn on
    ``device`` and kept on the host in raw internal units, one dict of f32
    NumPy columns per "file": half uniform background, half in 64 Gaussian
    blobs (sigma 0.02 box), each file sorted along the 2D Morton key at the
    wire's 65536 cells; lognormal h (median 0.9 px, sigma_ln 0.55, clipped
    to 0.25-24 px), m in U(0.8, 1.2) 1e6 Msun, lognormal T (median 1e5 K,
    sigma_ln 1). Positions (x, y, z) and h are stored x h, masses x h in
    units of 1e10 Msun (``e2e_1e8.py:124-129``)."""
    from astro_sph_tools_tpu_torch import constants as C

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    edges = np.linspace(0, 1 << n_log2, n_files + 1).astype(int)
    px = E2E_BOX / res
    centres = torch.rand((64, 3), generator=g, device=device, dtype=torch.float64) * E2E_BOX
    msun_in_1e10 = C.SOLAR_MASS_CGS / E2E_MASS_CGS
    files = []
    for fi in range(n_files):
        nf = int(edges[fi + 1] - edges[fi])
        nb = nf // 2
        pos = torch.empty((nf, 3), dtype=torch.float32, device=device)
        pos[: nf - nb] = torch.rand((nf - nb, 3), generator=g, device=device) * E2E_BOX
        which = torch.randint(0, 64, (nb,), generator=g, device=device)
        blob = centres[which] + torch.randn((nb, 3), generator=g, device=device, dtype=torch.float64) * (0.02 * E2E_BOX)
        pos[nf - nb:] = torch.remainder(blob, E2E_BOX).float()
        q = torch.clamp(pos[:, :2] / E2E_BOX * 65536, 0, 65535).to(torch.int64)
        pos = pos[torch.sort(_interleave16_t(q[:, 0], q[:, 1]), stable=True).indices]
        h = torch.exp(math.log(0.9 * px) + 0.55 * torch.randn(nf, generator=g, device=device))
        h = torch.clamp(h, 0.25 * px, 24.0 * px)
        m = 0.8e6 + 0.4e6 * torch.rand(nf, generator=g, device=device)
        t = torch.exp(math.log(1e5) + torch.randn(nf, generator=g, device=device))
        files.append({
            "Coordinates": (pos * E2E_HUBBLE).cpu().numpy(),
            "SmoothingLength": (h * E2E_HUBBLE).cpu().numpy(),
            "Mass": (m * (E2E_HUBBLE * msun_in_1e10)).cpu().numpy(),
            "Temperature": t.cpu().numpy(),
        })
    return files


def e2e_raw_chunk(files, ci: int, n_chunks: int = E2E_CHUNKS) -> dict:
    """The raw columns of chunk ``ci``: the files ``ci, ci + n_chunks, ...``,
    as ``SnapshotEAGLE(process_index=ci, n_processes=n_chunks)`` reads them."""
    mine = files[ci::n_chunks]
    return {k: np.concatenate([f[k] for f in mine]) for k in mine[0]}


def e2e_read_chunk(files, wire: str, ci: int, n_chunks: int = E2E_CHUNKS):
    """``e2e_1e8.py::read_chunk`` on in-memory files. ``f32``: the reader's
    fused unit conversion, one f32-output multiply a column (``output_dtype
    = float32``); ``pack``: those arrays quantised; ``packdelta``: the raw
    arrays packed with Morton-delta positions and u8-log fields, the unit
    factors folded into the unpack."""
    from astro_sph_tools_tpu_torch import constants as C
    from astro_sph_tools_tpu_torch.io.packing import pack_particles_host

    raw = e2e_raw_chunk(files, ci, n_chunks)
    s_len = 1.0 / E2E_HUBBLE
    s_mass = E2E_MASS_CGS / (E2E_HUBBLE * C.SOLAR_MASS_CGS)
    if wire == "packdelta":
        # raw internal masses (~7e-5) sit in f16's subnormals: prescale by 2^14
        return pack_particles_host(
            np.ascontiguousarray(raw["Coordinates"][:, 0]), np.ascontiguousarray(raw["Coordinates"][:, 1]),
            raw["SmoothingLength"], [raw["Mass"], raw["Temperature"]],
            box=E2E_BOX * E2E_HUBBLE, pos_scale=s_len, h_scale=s_len,
            field_scales=(2.0**-14, TEMP_SCALE), field_unpack_scales=(s_mass * 2.0**-14, TEMP_SCALE),
            pos_encoding="auto", field_dtype="u8",
        )
    pos = np.multiply(raw["Coordinates"], s_len, dtype=np.float32)
    hs = np.multiply(raw["SmoothingLength"], s_len, dtype=np.float32)
    mass = np.multiply(raw["Mass"], s_mass, dtype=np.float32)
    temp = np.multiply(raw["Temperature"], 1.0, dtype=np.float32)
    x, y = np.ascontiguousarray(pos[:, 0]), np.ascontiguousarray(pos[:, 1])
    if wire == "pack":
        return pack_particles_host(x, y, hs, [mass, temp], box=E2E_BOX, field_scales=(MASS_SCALE, TEMP_SCALE))
    return (x, y, hs, mass, temp)


def e2e_decode(item, device) -> tuple:
    """(x, y, h, m, T) on ``device`` from a delivered chunk (the packed
    wires unpack there)."""
    from astro_sph_tools_tpu_torch.io.packing import unpack_particles_device

    if isinstance(item, tuple):
        return item
    x, y, h, f = unpack_particles_device(item, device=device)
    return x, y, h, f[0], f[1]


def peak_mem_gb(torch, device):
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**30


def reset_peak_mem(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def e2e_pass(torch, device, files, wire: str, engine: str, spec, keep: bool = False):
    """One streamed pass (``e2e_1e8.py::run_pass``): ``stream_macro_chunks``
    reads chunk k+1 and copies it to the card while chunk k deposits; the
    maps sum over the chunks. Returns the summed maps, the timings (the
    pass's wall; the exposed wait, from asking for a chunk until it is
    decoded on the card, which unlike the benchmark's also counts the time
    blocked on the stream; the layout; the deposit; the wire's bytes a
    particle, as the host packed them) and, with ``keep``, each chunk's
    host arrays, delivered item and decoded particles."""
    from astro_sph_tools_tpu_torch.io.prefetch import stream_macro_chunks
    from astro_sph_tools_tpu_torch.ops import deposit_2d_coherent, deposit_tiled, tile_particles

    wire_bytes, hosts = [], []

    def read_chunk(ci):
        host = e2e_read_chunk(files, wire, ci)
        wire_bytes.append(20 * host[0].shape[0] if isinstance(host, tuple) else host.nbytes)
        if keep:
            hosts.append(host)
        return host

    sync(torch, device)
    t_pass = time.perf_counter()
    wait_s = layout_s = deposit_s = 0.0
    total, kept, n = None, [], 0
    stream = stream_macro_chunks(read_chunk, E2E_CHUNKS, prefetch_depth=1, device=device)
    t0 = time.perf_counter()
    for item in stream:
        x, y, h, m, t = e2e_decode(item, device)
        values = torch.stack([m, m * t])  # the payload algebra on the card
        sync(torch, device)
        wait_s += time.perf_counter() - t0
        n += x.shape[0]
        t0 = time.perf_counter()
        if engine == "coherent":
            maps = deposit_2d_coherent(x, y, h, values, spec, device=device)
        else:
            tp = tile_particles(x, y, h, values, spec, need_perm=False, device=device)
            sync(torch, device)
            layout_s += time.perf_counter() - t0
            t0 = time.perf_counter()
            maps = deposit_tiled(tp)
        total = maps if total is None else total + maps
        sync(torch, device)
        deposit_s += time.perf_counter() - t0
        if keep:
            kept.append((hosts[len(kept)], item, (x, y, h, m, t)))
        t0 = time.perf_counter()
    times = {"wall_s": time.perf_counter() - t_pass, "wait_s": wait_s, "layout_s": layout_s,
             "deposit_s": deposit_s, "bytes_per_particle": sum(wire_bytes) / n}
    return total, times, kept


def h2d_rates(torch, device, host_arrays) -> dict:
    """GB/s of copying ``host_arrays`` to the card from pinned buffers
    (``non_blocking``, CUDA events) and from pageable NumPy memory (host
    clock around a synchronised copy); medians of 3."""
    srcs = [torch.from_numpy(np.ascontiguousarray(a)) for a in host_arrays]
    total = sum(s.numel() * s.element_size() for s in srcs)
    pinned = [s.pin_memory() for s in srcs]
    outs = [torch.empty(s.shape, dtype=s.dtype, device=device) for s in srcs]

    def copy_pinned():
        for o, p in zip(outs, pinned):
            o.copy_(p, non_blocking=True)

    def copy_pageable():
        for o, s in zip(outs, srcs):
            o.copy_(s)

    copy_pinned()
    copy_pageable()
    return {"bytes": total, "pinned_gb_s": total / cuda_ms(copy_pinned, 3) / 1e6,
            "pageable_gb_s": total / wall_s(copy_pageable, 3) / 1e9}


def e2e_decode_checks(torch, files, kept) -> dict:
    """Each chunk's decode on the card against the port's CPU decode of the
    same packed arrays, bit for bit; the card's Morton decode against the
    encoder's inputs."""
    from astro_sph_tools_tpu_torch.io.packing import morton_delta_decode_device

    out = {"chunks": len(kept), "bitwise_equal": True, "morton_chunks": 0, "morton_exact": True}
    for ci, (host, item, got) in enumerate(kept):
        ref = e2e_decode(host, "cpu")
        for a, b in zip(got, ref):
            out["bitwise_equal"] &= bool(torch.equal(a.cpu().view(torch.int32), b.view(torch.int32)))
        if item.pos_delta is not None:
            raw = e2e_raw_chunk(files, ci)
            inv = np.float64(65536.0) / host.box
            for axis, q in zip((0, 1), morton_delta_decode_device(*item.pos_delta)):
                enc = np.clip(raw["Coordinates"][:, axis] * inv, 0, 65535.0).astype(np.uint16)
                out["morton_exact"] &= bool(np.array_equal(q.cpu().numpy(), enc.astype(np.int32)))
            out["morton_chunks"] += 1
    return out


def phase_e2e(torch, device, n_log2: int = E2E_LOG2N, res: int = 1024):
    from astro_sph_tools_tpu_torch.ops import MapSpec, deposit_2d_auto, deposit_2d_coherent, deposit_tiled, tile_particles
    from astro_sph_tools_tpu_torch.ops.coherent_prep import prep_rows
    from astro_sph_tools_tpu_torch.ops.deposit_tiled import deposit_tiles
    from astro_sph_tools_tpu_torch.utils import device_trace

    TC = _coherent_module()
    t0 = t_phase = time.perf_counter()
    files = e2e_files(torch, device, n_log2, res=res)
    gen_s = time.perf_counter() - t0
    n = sum(f["Mass"].shape[0] for f in files)
    spec = MapSpec(shape=(res, res), extent=(0.0, E2E_BOX, 0.0, E2E_BOX), periodic_wrap=True)
    wires = sorted({w for w, _ in E2E_COMBOS})

    # pass 1 (cold) of every wire and engine; the first engine of a wire
    # keeps its decoded chunks for the checks
    rows, maps, decoded, checks = {}, {}, {}, {}
    for wire, engine in E2E_COMBOS:
        keep = wire not in decoded
        total, times, kept = e2e_pass(torch, device, files, wire, engine, spec, keep=keep)
        rows[(wire, engine)] = {"wire": wire, "engine": engine, "cold": times}
        maps[(wire, engine)] = total
        if keep:
            decoded[wire] = [k[2] for k in kept]
            if wire != "f32":
                checks[wire] = e2e_decode_checks(torch, files, kept)
            del kept

    # the streamed maps against one render of all of a wire's decoded
    # particles (the deposit is linear), coherent against sorted, the
    # integrated map's mass, and the path's kernels against their plain
    # versions on the wire's first decoded chunk
    kernel_checks = {}
    for wire in wires:
        engines = [e for w, e in E2E_COMBOS if w == wire]
        x, y, h, m, t = decoded[wire][0]
        kernel_checks[wire] = path_kernels_vs_plain(torch, device, x, y, h, torch.stack([m, m * t]), spec, engines,
                                                    case=f"e2e_{wire}")
        x, y, h, m, t = (torch.cat([c[i] for c in decoded[wire]]) for i in range(5))
        values = torch.stack([m, m * t])
        one = {"sorted": deposit_tiled(tile_particles(x, y, h, values, spec, need_perm=False, device=device)),
               "coherent": deposit_2d_coherent(x, y, h, values, spec, device=device)}
        for engine in ("sorted", "coherent"):
            if (wire, engine) in maps:
                row = rows[(wire, engine)]
                row["streamed_vs_one_shot_rel_err"] = rel_err(maps[(wire, engine)], one[engine])[1]
                row["finite"] = bool(torch.isfinite(maps[(wire, engine)]).all())
        if (wire, "coherent") in maps:
            rows[(wire, "coherent")]["coherent_vs_sorted_rel_err"] = rel_err(
                maps[(wire, "coherent")], maps[(wire, "sorted")])[1]
        integ = deposit_2d_auto(x, y, h, m, spec, projection="integrated", device=device)
        mass = float(m.double().sum())
        px = E2E_BOX / res
        checks.setdefault(wire, {})["integrated_mass_rel_err"] = abs(float(integ.double().sum()) * px * px - mass) / mass
        del x, y, h, m, t, values, one, integ
    del decoded
    # the quantisation error of the packed wires, against the f32 wire's map
    ref = maps[("f32", "sorted")]
    quant = {}
    for wire in ("pack", "packdelta"):
        d = (maps[(wire, "sorted")] - ref).double()
        scale = ref.double().abs().amax(dim=(1, 2))
        quant[wire] = {"max_rel": (d.abs().amax(dim=(1, 2)) / scale).tolist(),
                       "rms_rel": (d.pow(2).mean(dim=(1, 2)).sqrt() / scale).tolist()}

    # pass 2 (steady, untraced) of every wire and engine: the main path,
    # with every launch count reset just before it
    deposit_tiles.launches = prep_rows.launches = TC.deposit_coherent_tiles.launches = 0
    for wire, engine in E2E_COMBOS:
        reset_peak_mem(torch, device)
        _, times, _ = e2e_pass(torch, device, files, wire, engine, spec)
        rows[(wire, engine)].update({"steady": times, "peak_mem_gb": peak_mem_gb(torch, device)})
    launches = {"deposit2d": deposit_tiles.launches, "coherent_prep": prep_rows.launches,
                "coherent_deposit": TC.deposit_coherent_tiles.launches}
    # pass 3, traced: the device's busy and idle share and its top operations
    for wire, engine in E2E_COMBOS:
        with device_trace(top=6, device=device) as tr:
            e2e_pass(torch, device, files, wire, engine, spec)
        rows[(wire, engine)].update({"device_busy_ms": tr.busy_ms, "traced_wall_ms": tr.wall_ms,
                                     "device_idle_share": tr.idle_share, "device_top_ms": tr.top_ms})
    h2d = h2d_rates(torch, device, e2e_read_chunk(files, "f32", 0)) if torch.device(device).type == "cuda" else None
    out = {"phase": "e2e_stream", "n": n, "chunks": E2E_CHUNKS, "files": len(files), "map": [res, res],
           "fields": 2, "generate_s": gen_s, "launches": launches, "h2d_f32_chunk": h2d,
           "checks": checks, "quantisation_vs_f32": quant, "rows": list(rows.values()),
           "kernels_vs_plain": kernel_checks, "phase_s": time.perf_counter() - t_phase}
    emit(out)
    for w in ("pack", "packdelta"):
        check(checks[w]["bitwise_equal"], f"phase 20 {w}: the card's decode differs from the CPU's")
    check(checks["packdelta"]["morton_chunks"] == E2E_CHUNKS and checks["packdelta"]["morton_exact"],
          f"phase 20: the Morton-delta wire was not taken or did not decode exactly: {checks['packdelta']}")
    for row in rows.values():
        check(row["finite"], f"phase 20: non-finite streamed map {row['wire']}/{row['engine']}")
        check(row["streamed_vs_one_shot_rel_err"] <= REL_TOL, f"phase 20: streamed map off its one-shot render: {row}")
        check(row.get("coherent_vs_sorted_rel_err", 0.0) <= REL_TOL, f"phase 20: coherent map off sorted: {row}")
    for wire in wires:
        check(checks[wire]["integrated_mass_rel_err"] < MASS_TOL, f"phase 20 {wire}: integrated mass {checks[wire]}")
    check(all(v > 0 for v in launches.values()), f"phase 20: a kernel of the path was not launched: {launches}")
    return out


# ---------------------------------------------------------------------------
# phase 21: ion-weighted fused render (the JAX package's benchmarks/ion_e2e.py)
# ---------------------------------------------------------------------------

ION_LOG2N = 26  # the size of ION_E2E_64M.json
ION_BOX = 25.0
ION_REDSHIFT = 0.5
ION_CHECK_N = 1 << 20


def ion_particles(torch, device, n: int, res: int = 1024, seed: int = 7) -> tuple:
    """``ion_e2e.py:74-98`` on ``device``: particles in 2^14 Morton-ordered
    cells (128^2), sorted cell ids, uniform within their cell; lognormal h
    around 1.2 px clipped to 0.1-14 px, lognormal masses around 1e6 Msun,
    log n_H ~ N(-4, 1.2), log T ~ N(4.8, 0.6)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    cell = torch.sort(torch.randint(0, 1 << 14, (n,), generator=g, device=device)).values

    def unspread(v):
        v = v & 0x55555555
        v = (v | (v >> 1)) & 0x33333333
        v = (v | (v >> 2)) & 0x0F0F0F0F
        v = (v | (v >> 4)) & 0x00FF00FF
        v = (v | (v >> 8)) & 0x0000FFFF
        return v

    cw = ION_BOX / 128
    x = (unspread(cell).float() + torch.rand(n, generator=g, device=device)) * cw
    y = (unspread(cell >> 1).float() + torch.rand(n, generator=g, device=device)) * cw
    px = ION_BOX / res
    h = torch.exp(0.5 * torch.randn(n, generator=g, device=device) + math.log(1.2 * px)).clamp(0.1 * px, 14.0 * px)
    mass = torch.exp(0.3 * torch.randn(n, generator=g, device=device)) * 1.0e6
    log_nh = 1.2 * torch.randn(n, generator=g, device=device) - 4.0
    log_t = 0.6 * torch.randn(n, generator=g, device=device) + 4.8
    return x, y, h, mass, log_nh, log_t


def ion_table(torch, device):
    """The synthetic O VI table (16 x 20 x 8), built in memory, and its plane
    at ``ION_REDSHIFT`` in f32 (``table_at_redshift``)."""
    from astro_sph_tools_tpu_torch.data_structures import IonisationTableBase
    from astro_sph_tools_tpu_torch.io.ionisation import synthetic_hm01_arrays

    arrays = synthetic_hm01_arrays()
    table = IonisationTableBase(arrays["ionbal"], arrays["logd"], arrays["logt"], arrays["redshift"],
                                redshift_input_index=2, device=device)
    axes2, grid2 = table.table_at_redshift(ION_REDSHIFT)
    return arrays, tuple(a.float() for a in axes2), grid2.float()


def ion_payload(torch, axes2, grid2, log_nh, log_t, mass, temp_lin):
    """``ion_e2e.py::ion_payload``: the table's log f per particle, f =
    10^log f (0 outside the table), and the fields [m f, m f T 2^-16]."""
    from astro_sph_tools_tpu_torch.ops import regular_grid_interpolate

    logf = regular_grid_interpolate(axes2, grid2, torch.stack([log_nh, log_t], dim=1), fill_value=-math.inf)
    ion_mass = mass * torch.exp2(logf * math.log2(10.0))
    return torch.stack([ion_mass, ion_mass * temp_lin])


def phase_ion(torch, device, n_log2: int = ION_LOG2N, res: int = 1024, repeats: int = 3):
    from scipy.interpolate import RegularGridInterpolator

    from astro_sph_tools_tpu_torch.ops import (
        MapSpec, caps_from_layout, deposit_2d_auto, deposit_2d_coherent_fused, deposit_coherent,
        regular_grid_interpolate, tile_particles_coherent,
    )
    from astro_sph_tools_tpu_torch.ops.coherent_prep import prep_rows
    from astro_sph_tools_tpu_torch.ops.deposit_tiled import deposit_tiles
    from astro_sph_tools_tpu_torch.utils import device_trace

    TC = _coherent_module()
    t_phase = time.perf_counter()
    n = 1 << n_log2
    x, y, h, mass, log_nh, log_t = ion_particles(torch, device, n, res=res)
    arrays, axes2, grid2 = ion_table(torch, device)
    temp_lin = torch.exp2(log_t * math.log2(10.0)) * 2.0**-16  # K, scaled into f32's comfort
    spec = MapSpec(shape=(res, res), extent=(0.0, ION_BOX, 0.0, ION_BOX), periodic_wrap=True)

    # the card's lookup against scipy over the full 3-D table, f64
    sub = min(ION_CHECK_N, n)
    pts = torch.stack([log_nh[:sub], log_t[:sub]], dim=1)
    logf = regular_grid_interpolate(axes2, grid2, pts, fill_value=-math.inf).double().cpu().numpy()
    p64 = pts.double().cpu().numpy()
    ref = RegularGridInterpolator((arrays["logd"], arrays["logt"], arrays["redshift"]), arrays["ionbal"],
                                  bounds_error=False, fill_value=-np.inf)(
        np.column_stack([p64, np.full(sub, ION_REDSHIFT)]))
    outside = ~np.isfinite(ref)
    frac0 = ion_payload(torch, axes2, grid2, log_nh[:sub], log_t[:sub], mass[:sub], temp_lin[:sub])[0]
    interp = {
        "n": sub, "outside": int(outside.sum()),
        "max_abs_err_log_f": float(np.abs(logf[~outside] - ref[~outside]).max()),
        "outside_minus_inf": bool((logf[outside] == -np.inf).all() and np.isfinite(logf[~outside]).all()),
        "outside_zero_f": bool((frac0.cpu().numpy()[outside] == 0).all()),
    }

    sync(torch, device)
    reset_peak_mem(torch, device)
    t0 = time.perf_counter()
    fields = ion_payload(torch, axes2, grid2, log_nh, log_t, mass, temp_lin)
    lay = tile_particles_coherent(x, y, h, fields, spec, device=device)
    synced = deposit_coherent(lay, precision="bf16x2")
    caps = caps_from_layout(lay)
    sync(torch, device)
    calibrate_s = time.perf_counter() - t0

    def fused_pass():
        f = ion_payload(torch, axes2, grid2, log_nh, log_t, mass, temp_lin)
        return deposit_2d_coherent_fused(x, y, h, f, spec, caps, precision="bf16x2", device=device)

    # the main path, once, with every launch count reset just before it
    deposit_tiles.launches = prep_rows.launches = TC.deposit_coherent_tiles.launches = 0
    fused, ok = fused_pass()
    sync(torch, device)
    launches = {"deposit2d": deposit_tiles.launches, "coherent_prep": prep_rows.launches,
                "coherent_deposit": TC.deposit_coherent_tiles.launches}
    oks = [bool(ok)]
    walls, payload_s = [], []
    for _ in range(repeats):
        sync(torch, device)
        t0 = time.perf_counter()
        maps, ok = fused_pass()
        float(maps[0].sum())
        oks.append(bool(ok))  # the mandatory ok check, every pass
        walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        f = ion_payload(torch, axes2, grid2, log_nh, log_t, mass, temp_lin)
        float(f[0, 0])
        payload_s.append(time.perf_counter() - t0)
    with device_trace(top=8, device=device) as tr:
        maps, ok = fused_pass()
        oks.append(bool(ok))
    sorted_map = deposit_2d_auto(x, y, h, fields, spec, device=device)
    rel_fs = rel_err(fused, synced)[1]
    rel_fo = rel_err(fused, sorted_map)[1]
    rel_so = rel_err(synced, sorted_map)[1]
    del sorted_map
    # the path's kernels against their plain versions on its payload
    kernel_checks = path_kernels_vs_plain(torch, device, x, y, h, fields, spec, ("sorted", "coherent"), case="ion")
    out = {
        "phase": "ion_render", "n": n, "map": [res, res], "fields": 2, "redshift": ION_REDSHIFT,
        "table_shape": list(arrays["ionbal"].shape), "interp": interp, "launches": launches,
        "ok_every_pass": oks, "fused_vs_synced_rel_err": rel_fs, "fused_vs_sorted_rel_err": rel_fo,
        "synced_vs_sorted_rel_err": rel_so, "calibrate_s": calibrate_s,
        "wall_s": float(np.median(walls)), "wall_s_runs": walls, "payload_s": float(np.median(payload_s)),
        "deposits_per_s": n / float(np.median(walls)),
        "device_busy_ms": tr.busy_ms, "traced_wall_ms": tr.wall_ms, "device_idle_share": tr.idle_share,
        "device_top_ms": tr.top_ms, "peak_mem_gb": peak_mem_gb(torch, device),
        "kernels_vs_plain": kernel_checks, "phase_s": time.perf_counter() - t_phase,
    }
    emit(out)
    check(interp["max_abs_err_log_f"] <= REL_TOL, f"phase 21: the card's lookup off scipy: {interp}")
    check(interp["outside"] > 0 and interp["outside_minus_inf"] and interp["outside_zero_f"],
          f"phase 21: the table's outside is not -inf / f = 0: {interp}")
    check(all(oks), f"phase 21: the fused render reported overflow: {oks}")
    check(max(rel_fs, rel_fo, rel_so) <= REL_TOL, f"phase 21: maps disagree: {rel_fs}, {rel_fo}, {rel_so}")
    check(bool(torch.isfinite(fused).all()) and float(fused[0].sum()) > 0, "phase 21: bad fused map")
    check(launches["coherent_prep"] > 0 and launches["coherent_deposit"] > 0,
          f"phase 21: a kernel of the path was not launched: {launches}")
    return out


# ---------------------------------------------------------------------------
# phase 22: the neighbour path (EAGLE Ref-L0025N0376 at full size)
# ---------------------------------------------------------------------------

NEIGH_SIDE = 376  # Ref-L0025N0376: 376^3 DM particles and as many gas (Schaye et al. 2015, Table 2)
NEIGH_BOX = 25.0  # cMpc
NEIGH_DM_MASS = 9.70e6  # Msun, the run's DM particle mass
NEIGH_GAS_MASS = 1.81e6  # Msun, its initial gas particle mass
NEIGH_HUBBLE = 0.6777  # EAGLE's (Planck 2013) h and Omega_b
NEIGH_OMEGA_B = 0.04825
NEIGH_K = 32  # the SWIFT DM smoothing length: the 32nd neighbour
NEIGH_HALOES = 30_000
NEIGH_CUTS = (11.0, 12.0, 13.0)  # log10 M200 / Msun, after "all"
NEIGH_LOGM = (9.0, 14.5)  # the halo mass function's range, dN/dlogM ~ M^-0.9
NEIGH_SLOPE = -0.9
NEIGH_DENSE_CHECK = 1024  # hsml rows held to the dense k-NN over all points
NEIGH_KDTREE_CHECK = 1 << 16  # gas queries a halo pass is held to scipy's KDTree on
# KNN_CROSSOVER.json's sizes, and two below them (the H100's crossover lies lower)
KNN_SWEEP = (3_000, 10_000, 30_000, 100_000, 300_000, 1_000_000, 3_000_000)
KNN_SWEEP_KDTREE_QUERIES = 100_000
NEAREST_SWEEP = (1_000, 3_000, 10_000, 30_000, 100_000)  # haloes ...
NEAREST_SWEEP_QUERIES = 1 << 22  # ... against these queries
NEAREST_DENSE_STOP_S = 5.0  # no larger dense sweep once one wall passes this


def neighbour_positions(rng, m: int, box: float):
    """``benchmarks/knn_crossover.py::clustered`` (the same draws from
    ``rng``): half the points in Gaussian blobs of sigma = box / 40 around
    max(8, m // 1500) uniform centres, half uniform, wrapped, f32; and the
    blob centres."""
    nb = max(8, m // 1500)
    centres = rng.uniform(0, box, (nb, 3))
    half = m // 2
    blob = centres[rng.integers(0, nb, half)] + rng.normal(0, box / 40, (half, 3))
    pts = np.vstack([np.mod(blob, box), rng.uniform(0, box, (m - half, 3))]).astype(np.float32)
    return pts, centres


def neighbour_haloes(rng, centres, n: int, box: float):
    """Phase 22's halo catalogue: ``n`` centres (the blob centres first,
    the rest uniform), log10 M200 drawn from dN/dlogM ~ M^-0.9 on [9, 14.5]
    (inverse CDF) and R200 from M200 = 200 rho_crit 4/3 pi R200^3 (comoving
    rho_crit at z = 0 for EAGLE's h). Returns (centres, log10 M200, M200,
    R200)."""
    from astro_sph_tools_tpu_torch.data_structures import Cosmology

    c = np.vstack([centres[:n], rng.uniform(0, box, (max(0, n - len(centres)), 3))])
    lo, hi = (10.0 ** (NEIGH_SLOPE * v) for v in NEIGH_LOGM)
    logm = np.log10(lo + rng.uniform(size=n) * (hi - lo)) / NEIGH_SLOPE
    m200 = 10.0**logm
    rho_crit = Cosmology.from_redshift(0.0, NEIGH_HUBBLE, NEIGH_OMEGA_B).critical_density_comoving()
    r200 = np.cbrt(3.0 * m200 / (4.0 * math.pi * 200.0 * rho_crit))
    return c, logm, m200, r200


def crossover(sizes, device_s, host_s):
    """The size at which the device's wall falls to the host's: the ratio
    interpolated in log-log between the two sizes that bracket 1; None when
    the device is faster at every size (below the first), inf when never."""
    ratio = [d / h for d, h in zip(device_s, host_s)]
    if ratio[0] <= 1.0:
        return None
    for (m0, r0), (m1, r1) in zip(zip(sizes, ratio), zip(sizes[1:], ratio[1:])):
        if r1 <= 1.0:
            t = math.log(r0) / (math.log(r0) - math.log(r1))
            return float(math.exp(math.log(m0) + t * (math.log(m1) - math.log(m0))))
    return math.inf


def _knn_sweep(torch, device, rng, box: float) -> dict:
    """32-NN wall of the device grid (``dm_smoothing_lengths(engine="grid")``,
    host positions in, the 32nd distance out; best of 2 after a warm-up)
    against scipy's KDTree with every host core: built on all points,
    queried on a 1e5 subset; extrapolated to all points as
    KNN_CROSSOVER.json did (build and query times m / 1e5) and with the
    build counted once."""
    from scipy.spatial import KDTree

    from astro_sph_tools_tpu_torch.io.swift import dm_smoothing_lengths

    rows = []
    for m in KNN_SWEEP:
        pts, _ = neighbour_positions(rng, m, box)
        got = dm_smoothing_lengths(pts, box, "grid", device)
        grid_s = min(wall_s(lambda: dm_smoothing_lengths(pts, box, "grid", device), 1) for _ in range(2))
        t0 = time.perf_counter()
        tree = KDTree(np.mod(pts.astype(np.float64), box), boxsize=box)
        build_s = time.perf_counter() - t0
        sub = np.mod(pts[:KNN_SWEEP_KDTREE_QUERIES].astype(np.float64), box)
        t0 = time.perf_counter()
        kd, _ = tree.query(sub, k=NEIGH_K, workers=-1)
        query_s = time.perf_counter() - t0
        scale = m / len(sub)
        rows.append({
            "m": m, "grid_s": grid_s, "kdtree_build_s": build_s, "kdtree_query_s": query_s,
            "kdtree_queries": len(sub), "kdtree_s_extrapolated": (build_s + query_s) * scale,
            "kdtree_s_build_once": build_s + query_s * scale,
            "rel_err_vs_kdtree": float(np.abs(got[:len(sub)] - kd[:, -1]).max() / kd[:, -1].max()),
        })
        check(rows[-1]["rel_err_vs_kdtree"] <= 1e-4, f"phase 22: the grid k-NN is off the KDTree: {rows[-1]}")
        emit({"phase": "neighbours", "knn_sweep": rows[-1]})
    # the grid's device time by kernel, traced at the largest size (at 376^3
    # the trace's ~2e5 launches take minutes to read back)
    busy_ms, prof_wall_ms, top = device_busy_ms(lambda: dm_smoothing_lengths(pts, box, "grid", device), top=8)
    trace = {"m": KNN_SWEEP[-1], "profiled_wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
             "device_idle_share": None if busy_ms is None else 1.0 - busy_ms / prof_wall_ms,
             "device_ms_by_kernel": top}
    emit({"phase": "neighbours", "knn_trace": trace})
    sizes = [r["m"] for r in rows]
    grid = [r["grid_s"] for r in rows]
    return {"rows": rows, "trace": trace,
            "crossover_m": crossover(sizes, grid, [r["kdtree_s_extrapolated"] for r in rows]),
            "crossover_m_build_once": crossover(sizes, grid, [r["kdtree_s_build_once"] for r in rows])}


def _nearest_sweep(torch, device, rng, box: float) -> dict:
    """``nearest_points`` dense against grid, M haloes against 2^22
    queries on the card (best of 2 each); no larger dense sweep once one of
    its walls passes 5 s."""
    from astro_sph_tools_tpu_torch.ops import nearest_points

    q = torch.as_tensor(neighbour_positions(rng, NEAREST_SWEEP_QUERIES, box)[0], device=device)
    rows, dense_on = [], True
    for m in NEAREST_SWEEP:
        pts, _ = neighbour_positions(rng, m, box)
        row = {"m": m, "queries": NEAREST_SWEEP_QUERIES}
        for method in ("grid", "dense"):
            if method == "dense" and not dense_on:
                row["dense_s"] = None
                continue
            runs = [wall_s(lambda: nearest_points(q, pts, periodic_box=box, method=method, device=device), 1)
                    for _ in range(2)]
            row[f"{method}_s"] = min(runs)
            dense_on = dense_on and (method == "grid" or max(runs) <= NEAREST_DENSE_STOP_S)
        gi, gd = nearest_points(q, pts, periodic_box=box, method="grid", device=device)
        if row["dense_s"] is not None:
            di, dd = nearest_points(q, pts, periodic_box=box, method="dense", device=device)
            row["dense_vs_grid_max_dist_diff"] = float(np.abs(gd - dd).max())
            row["dense_vs_grid_index_share"] = float((gi == di).mean())
            check(row["dense_vs_grid_max_dist_diff"] < 1e-4 and row["dense_vs_grid_index_share"] >= 0.999,
                  f"phase 22: nearest_points dense and grid disagree: {row}")
        rows.append(row)
        emit({"phase": "neighbours", "nearest_sweep": row})
    done = [r for r in rows if r["dense_s"] is not None]
    # the dense engine's crossover: the size from which the grid is faster
    return {"rows": rows, "crossover_m": crossover([r["m"] for r in done], [r["grid_s"] for r in done],
                                                   [r["dense_s"] for r in done])}


def phase_neighbours(torch, device, side: int = NEIGH_SIDE):
    """Phase 22: SWIFT DM smoothing lengths at 376^3 on the grid k-NN, the
    DM map they feed (kernel #1), the nearest-halo search of 376^3 gas
    particles, and the two device/host crossovers."""
    from scipy.spatial import KDTree

    from astro_sph_tools_tpu_torch.io.swift import dm_smoothing_lengths
    from astro_sph_tools_tpu_torch.ops import MapSpec, deposit_2d, deposit_2d_auto, knn_distances, tile_particles
    from astro_sph_tools_tpu_torch.ops.deposit_tiled import deposit_tiles
    from astro_sph_tools_tpu_torch.ops.neighbors import _knn_grid
    from astro_sph_tools_tpu_torch.scripts.find_nearest_haloes import nearest_halo_search

    t_phase = time.perf_counter()
    n, box = side**3, NEIGH_BOX
    rng = np.random.default_rng(22)
    t0 = time.perf_counter()
    dm, centres = neighbour_positions(rng, n, box)
    gas, _ = neighbour_positions(rng, n, box)
    out = {"phase": "neighbours", "config": "EAGLE Ref-L0025N0376", "n_dm": n, "n_gas": n, "box": box,
           "k": NEIGH_K, "generate_s": time.perf_counter() - t0}

    # (a) DM smoothing lengths on the grid k-NN, host positions in
    reset_peak_mem(torch, device)
    walls, stats = [], []
    for _ in range(2):  # cold, warm
        st = {}
        sync(torch, device)
        t0 = time.perf_counter()
        hsml = dm_smoothing_lengths(dm, box, "grid", device, stats=st)
        walls.append(time.perf_counter() - t0)
        stats.append(st)
    check(all(st["engine"] == "grid" for st in stats), f"phase 22: the hsml engine was not the grid: {stats}")
    dm_t = torch.as_tensor(dm, device=device)
    rows = _knn_grid(dm_t, dm_t, NEIGH_K, periodic_box=box, device=device)
    ascending = bool((rows[:, 1:] >= rows[:, :-1]).all())
    same_kth = bool(torch.equal(rows[:, -1].double().cpu(), torch.from_numpy(hsml)))
    pick = torch.as_tensor(rng.choice(n, NEIGH_DENSE_CHECK, replace=False), device=device)
    dense = knn_distances(dm_t[pick], dm_t, NEIGH_K, periodic_box=box, device=device)
    grid_rows = rows[pick].cpu().numpy()
    del rows
    hsml_check = {
        "queries": NEIGH_DENSE_CHECK, "rtol": 1e-4, "atol": 1e-5,
        "max_abs_err": float(np.abs(grid_rows - dense).max()),
        # the largest difference as a share of its allowance atol + rtol |dense|
        "max_share_of_tolerance": float((np.abs(grid_rows - dense) / (1e-5 + 1e-4 * np.abs(dense))).max()),
        "within": bool(np.allclose(grid_rows, dense, rtol=1e-4, atol=1e-5)),
        "rows_ascending": ascending, "kth_equals_hsml": same_kth,
    }
    out["hsml"] = {
        "engine": stats[-1]["engine"], "cold_s": walls[0], "warm_s": walls[1],
        "stages": stats[-1]["stages"], "stages_cold": stats[0]["stages"], "stragglers": stats[-1]["stragglers"],
        "peak_mem_gb": peak_mem_gb(torch, device), "check": hsml_check,

        "h_median": float(np.median(hsml)), "h_min": float(hsml.min()), "h_max": float(hsml.max()),
    }
    emit({"phase": "neighbours", "hsml": out["hsml"]})
    check(hsml_check["within"] and ascending and same_kth, f"phase 22: the hsml check failed: {hsml_check}")

    # (b) the DM map they feed: render_map_stack's sorted engine, kernel #1
    spec = MapSpec(shape=(1024, 1024), extent=(0.0, box, 0.0, box), periodic_wrap=True)
    x, y = dm_t[:, 0].contiguous(), dm_t[:, 1].contiguous()
    h = torch.as_tensor(hsml, dtype=torch.float32, device=device)
    mass = torch.full((n,), NEIGH_DM_MASS, dtype=torch.float32, device=device)
    deposit_tiles.launches = 0
    img = deposit_2d_auto(x, y, h, mass, spec, device=device)
    sync(torch, device)
    launches = deposit_tiles.launches
    tp = tile_particles(x, y, h, mass[None], spec, need_perm=False, device=device)
    n_oversize = tp.n_oversize
    level_counts = {geom.cfg.K: count for geom, lo, count in tp.geoms}
    # ~2e4 footprints a pixel: each level also against the f64 sum of the
    # plain version's terms, f32 over runs of 256
    levels = _sorted_levels_vs_plain(torch, tp, f64_run=256, case="dm_map")
    del tp
    map_wall = wall_s(lambda: deposit_2d_auto(x, y, h, mass, spec, device=device), 3)
    integ = deposit_2d_auto(x, y, h, mass, spec, projection="integrated", device=device)
    px = box / 1024
    mass_err = abs(float(integ.double().sum()) * px * px - NEIGH_DM_MASS * n) / (NEIGH_DM_MASS * n)
    del integ
    sub = min(n, 1 << 22)
    a = deposit_2d_auto(x[:sub], y[:sub], h[:sub], mass[:sub], spec, device=device)
    b = deposit_2d(x[:sub], y[:sub], h[:sub], mass[:sub], spec, device=device)
    stencil_abs, stencil_rel = rel_err(a, b)
    del a, b
    out["dm_map"] = {
        "map": [1024, 1024], "launches": launches, "levels": level_counts, "n_oversize": n_oversize,
        "wall_s": map_wall, "integrated_mass_rel_err": mass_err,
        "stencil_subset_n": sub, "stencil_subset_max_abs_err": stencil_abs, "stencil_subset_rel_err": stencil_rel,
        "kernel_levels": [{k: c[k] for k in ("K", "n", "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
                                               "rel_err", "f64_rel_err", "plain_f64_rel_err")}
                          for c in levels],
    }
    emit({"phase": "neighbours", "dm_map": out["dm_map"]})
    check(tuple(img.shape) == (1024, 1024) and bool(torch.isfinite(img).all()) and float(img.sum()) > 0,
          "phase 22: bad DM map")
    check(launches >= len(level_counts), f"phase 22: {launches} kernel #1 launches for levels {level_counts}")
    check(mass_err < MASS_TOL, f"phase 22: DM map mass error {mass_err}")
    check(stencil_rel <= PATH_TOL, f"phase 22: DM map off the stencil engine on {sub}: {stencil_rel}")
    del img, x, y, h, mass, dm_t
    torch.cuda.empty_cache()

    # (c) the nearest-halo search of every gas particle
    hc, logm, m200, r200 = neighbour_haloes(rng, centres, NEIGH_HALOES, box)
    gas_t = torch.as_tensor(gas, device=device)
    passes = []
    keys, ids, dist, rad = nearest_halo_search(gas_t, np.arange(NEIGH_HALOES), hc, r200, m200, NEIGH_CUTS, box,
                                               device=device, passes=passes)
    del gas_t
    q_idx = rng.choice(n, min(n, NEIGH_KDTREE_CHECK), replace=False)
    q = np.mod(gas[q_idx].astype(np.float64), box)
    for i, (key, p) in enumerate(zip(keys, passes)):
        mask = m200 > (0.0 if key == -np.inf else 10.0**key)
        if not mask.any():
            p["check"] = {"null": bool((ids[q_idx, i] == -1).all() and np.isinf(dist[q_idx, i]).all())}
            continue
        kd, ki = KDTree(np.mod(hc[mask], box), boxsize=box).query(q, workers=-1)
        p["check"] = {
            "queries": len(q_idx), "max_dist_err": float(np.abs(dist[q_idx, i] - kd).max()),
            "index_share": float((ids[q_idx, i] == np.arange(NEIGH_HALOES)[mask][ki]).mean()),
            "radius_equal": bool(np.array_equal(rad[q_idx, i], r200[ids[q_idx, i]])),
        }
    out["haloes"] = {"n_haloes": NEIGH_HALOES, "cuts": list(NEIGH_CUTS), "passes": passes,
                     "log10_m200_range": [float(logm.min()), float(logm.max())]}
    emit({"phase": "neighbours", "haloes": out["haloes"]})
    for p in passes:
        c = p["check"]
        check(c.get("null", True) and c.get("max_dist_err", 0.0) < 1e-4 and c.get("index_share", 1.0) >= 0.999
              and c.get("radius_equal", True), f"phase 22: a halo pass is off the KDTree: {p}")
    check(bool(np.isfinite(dist[:, 0]).all()) and (ids[:, 0] >= 0).all(), "phase 22: a gas particle has no halo")
    del ids, dist, rad, gas

    # (d) the crossovers that set the two "auto" constants
    crng = np.random.default_rng(3)
    out["knn_crossover"] = _knn_sweep(torch, device, crng, box)
    out["nearest_crossover"] = _nearest_sweep(torch, device, crng, box)
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "neighbours", "knn_crossover_m": out["knn_crossover"]["crossover_m"],
          "knn_crossover_m_build_once": out["knn_crossover"]["crossover_m_build_once"],
          "nearest_crossover_m": out["nearest_crossover"]["crossover_m"], "seconds": out["seconds"]})
    return out


# ---------------------------------------------------------------------------
# phase 23: the multi-GPU layer (parallel/) on the one card
# ---------------------------------------------------------------------------

PAR_RANKS = 4  # (b): gloo ranks on the one card (NCCL takes one rank a card)
PAR_SIZES = {
    "log2n": 24,  # the 2D inputs: 2^24 of phase 3's generator, 1024^2 x 2 fields
    "res": 1024,
    "vox": 256,  # the 3D grid, 256^3 over VOX_BOX, periodic and open ...
    "vox_log2n": 22,  # ... 2^22 of phase 14's generator
    "sight_log2n": 22,  # 2^22 config-4 particles ...
    "rays": 2048,  # ... and 2048 rays
    "ids_log2n": 22,  # int64 IDs above 2^40
    "rebalance_cap": 1 << 20,  # each rank's block in the rebalance
    "halo_res": 1024,  # four haloes of phase 19's catalogue, 1024^2 x 2 fields
}
PAR_HALOES = (0, 1, 14, 15)  # two dense cutouts and the two that cross the periodic edges
PAR_TIMEOUT_S = 300  # the gloo group's timeout; the parent waits this long past the ranks' start


def _par_counters():
    """The launch counters of kernels #1-#6, by the ``kernels`` line's names."""
    from astro_sph_tools_tpu_torch.ops import kernel_counters

    names = ("deposit2d", "coherent_prep", "coherent_deposit", "sightline_columns", "sightline_spectra", "deposit3d")
    return {k: v for k, v in kernel_counters().items() if k in names}


def reset_launches() -> None:
    for fn in _par_counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _par_counters().items()}


def par_level_vs_plain(torch, x, y, h, values, spec, K: int, **tags) -> dict:
    """Kernel #1 vs its plain version on the one level that
    ``deposit_2d_sharded`` launches on these particles (``values`` (F, N)),
    as ``deposit_2d_pallas(level=...)`` lays them out."""
    from astro_sph_tools_tpu_torch.ops import PALLAS_LEVELS
    from astro_sph_tools_tpu_torch.ops._device import tile_ranges
    from astro_sph_tools_tpu_torch.ops.deposit_tiled import _level_layout

    cfg = next(c for c in PALLAS_LEVELS if c.K == K)
    geom, u, v, hs, vals, tile = _level_layout(x, y, h, values.contiguous(), spec, cfg, values.device)
    pstart, pcount = tile_ranges(tile, geom.n_tiles)
    return _level_vs_plain(torch, geom, (u, v, hs, vals, pstart, pcount), slice(None), spec, "sharded-level",
                           plain_reps=0, **tags)


def par_slab_vs_plain(torch, pos, h, values, spec, rank: int, n_dev: int, K: int, **tags) -> dict:
    """Kernel #6 vs its plain version on the extended slab (its planes plus
    K // 2 halo planes a side, periodic in x and y when the grid is, open in
    z) that ``deposit_3d_sharded`` fills on rank ``rank`` of ``n_dev``."""
    from astro_sph_tools_tpu_torch.ops._device import as_f32
    from astro_sph_tools_tpu_torch.ops.grid3d_tiled import PALLAS_3D_LEVELS, deposit_3d_tiles, deposit_3d_tiles_plain
    from astro_sph_tools_tpu_torch.parallel.sharded import _slab_launch

    device = pos.device
    nz, ny, nx = spec.shape
    slab, halo = nz // n_dev, K // 2
    ext_shape = (slab + 2 * halo, ny, nx)
    cfg = next(c for c in PALLAS_3D_LEVELS if c.K >= K)
    args, kw = _slab_launch(as_f32(pos, device).reshape(-1, 3), as_f32(h, device),
                            as_f32(values, device).reshape(-1), spec, cfg, rank * slab - halo, ext_shape, "cubic_spline")
    got = torch.zeros((1, *ext_shape), dtype=torch.float32, device=device)
    ref = torch.zeros_like(got)
    deposit_3d_tiles(*args, got, **kw)
    deposit_3d_tiles_plain(*args, ref, **kw)
    sync(torch, device)
    err, rel = rel_err(got, ref)
    case = {"phase": "kernel_vs_plain_3d", **tags, "K": cfg.K, "ext_shape": list(ext_shape),
            "periodic": list(kw["periodic"]), "n": int(args[3].shape[0]), "max_abs_err": err, "rel_err": rel}
    emit(case)
    check(bool(torch.isfinite(got).all()), f"non-finite 3D kernel output {case}")
    check(rel <= REL_TOL, f"the 3D kernel disagrees with its plain version on the extended slab: {case}")
    return case


def par_columns_vs_plain(torch, x, y, h, m, rx, ry, box, **tags) -> dict:
    """Kernel #4 vs its plain version on the layout ``column_integrate_sharded``
    launches it on for one shard (one field, integrated, periodic)."""
    from astro_sph_tools_tpu_torch.ops.sightlines_fused import _columns_layout, columns_tiles, columns_tiles_plain

    lay, n_fields, _ = _columns_layout(x, y, h, m, rx, ry, kernel="cubic_spline", periodic_box=box, device=x.device)
    args = (lay.packed, lay.bounds, lay.rx, lay.ry, lay.rays, lay.grids)
    kw = dict(n_fields=n_fields, kernel="cubic_spline", projection="integrated", periodic=lay.periodic,
              Lx=lay.Lx, Ly=lay.Ly)
    got = columns_tiles(*args, **kw)
    ref = columns_tiles_plain(*args, **kw)
    sync(torch, x.device)
    err, rel = rel_err(got, ref)
    case = {"phase": "columns_kernel_vs_plain", **tags, "n": int(x.shape[0]), "n_rays": len(rx),
            "max_abs_err": err, "rel_err": rel}
    emit(case)
    check(bool(torch.isfinite(got).all()), f"non-finite column kernel output {case}")
    check(rel <= REL_TOL, f"column kernel disagrees with its plain version: {case}")
    return case


def par_spectra_vs_plain(torch, pos, h, m, v, T, rx, ry, cosmology, box, n_bins: int, **tags) -> dict:
    """Kernel #5 vs its plain version on the layout ``absorption_spectra_sharded``
    launches it on for one shard (Gaussian, periodic)."""
    from astro_sph_tools_tpu_torch.ops.spectra import _resolve_profile
    from astro_sph_tools_tpu_torch.ops.spectra_fused import _spectra_layout, spectra_tiles, spectra_tiles_plain

    device = pos.device
    lay, vc, v_box, n_images = _spectra_layout(
        pos, h, m, v, T, rx, ry, cosmology=cosmology, box_size=box, atomic_weight=1.008, n_bins=n_bins,
        kernel="cubic_spline", periodic=True, profile="gaussian", device=device,
    )
    args = (lay.packed, lay.rx, lay.ry, lay.lo, lay.hi, torch.as_tensor(vc, device=device))
    kw = dict(kernel="cubic_spline", periodic=lay.periodic, Lx=lay.Lx, Ly=lay.Ly, v_box=v_box, n_images=n_images,
              profile="gaussian", voigt_k=_resolve_profile("gaussian", None, 1215.67))
    got = spectra_tiles(*args, **kw)
    ref = spectra_tiles_plain(*args, **kw)
    sync(torch, device)
    err, rel = rel_err(got, ref)
    case = {"phase": "spectra_kernel_vs_plain", **tags, "n": int(pos.shape[0]), "n_rays": len(rx),
            "n_bins": n_bins, "max_abs_err": err, "rel_err": rel}
    emit(case)
    check(bool(torch.isfinite(got).all()), f"non-finite spectra kernel output {case}")
    check(rel <= REL_TOL, f"spectra kernel disagrees with its plain version: {case}")
    return case


def par_kernels_vs_plain(torch, device, case: str, coherent=None, level=None, slabs=(), columns=None,
                         spectra=None) -> dict:
    """Phase 23's kernels against their plain versions on one rank's own
    inputs, at the shapes its entry points launch them at (REL_TOL; #3 bit
    for bit): ``coherent`` (x, y, h, values, spec): #3, #2 and #1 on the
    routed tail; ``level`` (x, y, h, values, spec, K): #1 at
    ``deposit_2d_sharded``'s level; ``slabs``, each (pos, h, values, spec,
    rank, n_dev, K): #6 on the extended slab; ``columns`` and ``spectra``:
    #4 and #5 on the shard. Returns each kernel's largest errors by the
    ``kernels`` line's names."""
    cases = {}
    if coherent is not None:
        got = path_kernels_vs_plain(torch, device, *coherent, ("coherent",), case, plain_reps=0)
        cases["coherent_prep"] = [got["prep"]]
        cases["coherent_deposit"] = [got["coherent_deposit"]]
        cases["deposit2d"] = list(got["tail_levels"])
    if level is not None:
        cases.setdefault("deposit2d", []).append(par_level_vs_plain(torch, *level, case=case))
    for pos, h, values, spec, rank, n_dev, K in slabs:
        cases.setdefault("deposit3d", []).append(par_slab_vs_plain(
            torch, pos, h, values, spec, rank, n_dev, K, case=case, grid_periodic=spec.periodic_wrap))
    if columns is not None:
        cases["sightline_columns"] = [par_columns_vs_plain(torch, *columns, case=case)]
    if spectra is not None:
        cases["sightline_spectra"] = [par_spectra_vs_plain(torch, *spectra, case=case)]
    return {name: _worst(rows) for name, rows in cases.items()}


def _worst(rows) -> dict:
    """The largest errors over ``rows`` (cases, or summaries with their
    ``cases`` count); a case without ``rel_err`` was held bit for bit."""
    return {"max_abs_err": max(r["max_abs_err"] for r in rows), "rel_err": max(r.get("rel_err", 0.0) for r in rows),
            "cases": sum(r.get("cases", 1) for r in rows)}


def merge_vs_plain(parts) -> dict:
    """Each kernel's largest errors over several ``par_kernels_vs_plain``
    results (the ranks')."""
    names = sorted({name for rows in parts for name in rows})
    return {name: _worst([rows[name] for rows in parts if name in rows]) for name in names}


def par_level_K(h, px: float, support_factor: float = 2.0) -> int:
    """K of the smallest footprint level that holds the largest footprint."""
    from astro_sph_tools_tpu_torch.ops import PALLAS_LEVELS

    s_max = support_factor * float(h.max()) / px
    return next(c.K for c in PALLAS_LEVELS if c.max_s_pix >= s_max)


def phase_parallel_world1(torch, device, particles, backend: str = "nccl", vox_log2n: int = VOX_LOG2N,
                          vox_grid: int = VOX_GRID) -> dict:
    """Phase 23 (a): the sharded engines at a world of one rank (NCCL on
    the card) at full size, against their single-device engines, 1e-5 *
    max: the coherent maps (synced, fused, and fused again under sync debug
    mode "error"), beside the single-device engine's own run-to-run
    difference (kernels #1-#2 add with float atomics); the all_reduce over
    one rank bit for bit; ``deposit_2d_sharded`` at the smallest level that
    holds the largest footprint against ``deposit_2d_auto``;
    ``deposit_3d_sharded`` (K = 16, F = 1) against ``deposit_3d_auto``;
    each wall beside its single-device engine's and the collective's share
    of the coherent walls; each launched kernel against its plain version
    on these inputs (``par_kernels_vs_plain``)."""
    from datetime import timedelta

    import torch.distributed as dist
    from astro_sph_tools_tpu_torch.ops import (
        GridSpec, MapSpec, caps_from_layout, deposit_2d_auto, deposit_2d_coherent, deposit_2d_coherent_fused,
        deposit_3d_auto, tile_particles_coherent,
    )
    from astro_sph_tools_tpu_torch.parallel import (
        deposit_2d_coherent_sharded, deposit_2d_coherent_sharded_fused, deposit_2d_sharded, deposit_3d_sharded,
        make_mesh,
    )
    from astro_sph_tools_tpu_torch.parallel._comm import all_reduce_

    x, y, h, m, t, box = particles
    n = x.shape[0]
    res = 1024
    spec = MapSpec(shape=(res, res), extent=(0.0, box, 0.0, box), periodic_wrap=True)
    fields = torch.stack([m, m * t])
    K = par_level_K(h, box / res)
    vox = VOX_BOX / vox_grid
    spec3 = GridSpec(shape=(vox_grid,) * 3, extent=(0.0, VOX_BOX) * 3, periodic_wrap=True)
    pos3, h3, m3, _ = voxel_particles(torch, device, 1 << vox_log2n, VOX_BOX, seed=11)
    h3 = torch.clamp(h3, max=3.5 * vox)  # every footprint fits the K = 16 level, as in phase 14
    caps = caps_from_layout(tile_particles_coherent(x, y, h, fields, spec, device=device))

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
                                world_size=1, timeout=timedelta(seconds=PAR_TIMEOUT_S))
        try:
            mesh = make_mesh(1) if device.type == "cuda" else make_mesh(1, device=device)
            sync(torch, device)
            # the main path, once, with every launch count reset just before it
            reset_launches()
            img_cs = deposit_2d_coherent_sharded(x, y, h, fields, spec, mesh)
            img_fs, ok_fs = deposit_2d_coherent_sharded_fused(x, y, h, fields, spec, mesh, caps)
            img_ps = deposit_2d_sharded(x, y, h, fields.T, spec, mesh, K=K)
            slab = deposit_3d_sharded(pos3, h3, m3, spec3, mesh, K=16)
            sync(torch, device)
            launches = read_launches()
            ok_fs = bool(ok_fs)

            # zero host syncs in the fused sharded render: a synchronising
            # call inside raises in this mode
            debug = device.type == "cuda"
            if debug:
                torch.cuda.set_sync_debug_mode("error")
            try:
                img_fs2, ok_fs2 = deposit_2d_coherent_sharded_fused(x, y, h, fields, spec, mesh, caps)
            finally:
                if debug:
                    torch.cuda.set_sync_debug_mode("default")
            ok_fs2 = bool(ok_fs2)

            # kernels #1-#2 add with shared-memory float atomics, so two runs
            # of one engine may differ in the last bits (csrc/deposit2d.cu):
            # the engine's own run-to-run difference stands beside the
            # sharded one's, and the one-rank all_reduce is held bit for bit
            img_c1 = deposit_2d_coherent(x, y, h, fields, spec, device=device)
            img_c2 = deposit_2d_coherent(x, y, h, fields, spec, device=device)
            img_f1, ok_f1 = deposit_2d_coherent_fused(x, y, h, fields, spec, caps, device=device)
            reduced = all_reduce_(img_c1.clone(), mesh)
            ref2 = deposit_2d_auto(x, y, h, fields, spec, device=device)
            cube = deposit_3d_auto(pos3, h3, m3, spec3, device=device)
            errs = {
                "coherent_sharded_vs_coherent": rel_err(img_cs, img_c1),
                "coherent_run_to_run": rel_err(img_c2, img_c1),
                "fused_sharded_vs_fused": rel_err(img_fs, img_f1),
                "fused_sharded_sync_debug_vs_fused": rel_err(img_fs2, img_f1),
                "deposit_2d_sharded_vs_auto": rel_err(img_ps.permute(2, 0, 1), ref2),
                "deposit_3d_sharded_vs_auto": rel_err(slab, cube),
            }
            del cube
            buf = torch.zeros((2, res, res), dtype=torch.float32, device=device)
            walls = {
                "coherent_sharded": wall_s(lambda: deposit_2d_coherent_sharded(x, y, h, fields, spec, mesh), 3),
                "coherent": wall_s(lambda: deposit_2d_coherent(x, y, h, fields, spec, device=device), 3),
                "fused_sharded": wall_s(lambda: deposit_2d_coherent_sharded_fused(
                    x, y, h, fields, spec, mesh, caps), 3),
                "fused": wall_s(lambda: deposit_2d_coherent_fused(x, y, h, fields, spec, caps, device=device), 3),
                "deposit_2d_sharded": wall_s(lambda: deposit_2d_sharded(x, y, h, fields.T, spec, mesh, K=K), 3),
                "deposit_2d_auto": wall_s(lambda: deposit_2d_auto(x, y, h, fields, spec, device=device), 3),
                "deposit_3d_sharded": wall_s(lambda: deposit_3d_sharded(pos3, h3, m3, spec3, mesh, K=16), 3),
                "deposit_3d_auto": wall_s(lambda: deposit_3d_auto(pos3, h3, m3, spec3, device=device), 3),
                # the one all_reduce of a (2, 1024, 1024) f32 map stack
                "all_reduce_map": wall_s(lambda: all_reduce_(buf, mesh), 5),
            }
        finally:
            dist.destroy_process_group()

    # each kernel of this path against its plain version on the path's own
    # inputs: #1-#3 on the coherent layout of the 2^26 particles, #1 at the
    # one level that deposit_2d_sharded runs them all at, #6 on the one
    # rank's slab extended by its halo planes
    vs_plain = par_kernels_vs_plain(
        torch, device, "par_world1", coherent=(x, y, h, fields, spec), level=(x, y, h, fields, spec, K),
        slabs=[(pos3, h3, m3, spec3, 0, 1, 16)],
    )
    out = {
        "phase": "parallel_world1", "backend": backend, "n": n, "map": [res, res], "fields": 2,
        "vox_n": int(pos3.shape[0]), "vox_grid": vox_grid, "K_2d": K, "launches": launches,
        "all_reduce_identity_bitwise": bool(torch.equal(reduced, img_c1)),
        "ok_fused_sharded": ok_fs, "ok_fused_sharded_sync_debug": ok_fs2, "ok_fused": bool(ok_f1),
        "max_abs_err": {k: e for k, (e, _) in errs.items()}, "rel_err": {k: r for k, (_, r) in errs.items()},
        "walls_s": walls,
        "collective_share_coherent_sharded": walls["all_reduce_map"] / walls["coherent_sharded"],
        "collective_share_fused_sharded": 2 * walls["all_reduce_map"] / walls["fused_sharded"],
        "kernels_vs_plain": vs_plain,
    }
    emit(out)
    for name in ("deposit2d", "coherent_prep", "coherent_deposit", "deposit3d"):
        check(launches[name] > 0, f"phase 23 (a) launched no {name} kernel: {launches}")
        check(vs_plain[name]["rel_err"] <= REL_TOL, f"phase 23 (a) {name} off its plain version: {vs_plain[name]}")
    check(out["all_reduce_identity_bitwise"], "the all_reduce over one rank changed the map")
    check(ok_fs and ok_fs2 and out["ok_fused"],
          "the fused render reported overflow with capacities from its own layout")
    check(tuple(img_cs.shape) == (2, res, res) and bool(torch.isfinite(img_cs).all()), "bad coherent sharded map")
    for name, rel in out["rel_err"].items():
        check(rel <= REL_TOL, f"phase 23 (a) {name}: {rel}")
    return out


def par_inputs(torch, device, sizes: dict) -> dict:
    """Phase 23 (b)'s whole inputs, made from seeds on ``device`` (the
    ranks and the parent make the same ones)."""
    from astro_sph_tools_tpu_torch.data_structures import Cosmology

    x, y, h, m, t = clustered_particles(1 << sizes["log2n"], 25.0, sizes["res"], seed=7, device=device)
    vox_box = VOX_BOX
    pos3, h3, m3, _ = voxel_particles(torch, device, 1 << sizes["vox_log2n"], vox_box, seed=11)
    h3 = torch.clamp(h3, max=3.5 * vox_box / 512)  # at most 1.75 voxels of 256^3: the K = 16 level
    pos_s, h_s, m_s, v_s, T_s = sightline_particles(torch, device, 1 << sizes["sight_log2n"], SIGHT_BOX, seed=17)
    rng = np.random.default_rng(8)
    rx = rng.uniform(0.0, SIGHT_BOX, sizes["rays"])
    ry = rng.uniform(0.0, SIGHT_BOX, sizes["rays"])
    n_ids = 1 << sizes["ids_log2n"]
    g = torch.Generator(device=device)
    g.manual_seed(5)
    p1 = torch.randperm(n_ids, generator=g, device=device)
    p2 = torch.randperm(n_ids, generator=g, device=device)
    base = 1 << 40
    src_ids = base + 3 * p1
    return {
        "2d": (x, y, h, m, t, 25.0), "3d": (pos3, h3, m3),
        "sight": (pos_s, h_s, m_s, v_s, T_s, rx, ry, Cosmology.from_redshift(0.5, 0.6777, 0.04825)),
        "ids": (src_ids, (src_ids % 1000003).float(), base + 3 * p2, base + 3 * p2 + (p2 % 2)),
    }


def par_rebalance_blocks(torch, device, rank: int, cap: int):
    """Rank ``rank``'s rebalance blocks: one rank nearly full. Each holds
    its valid elements' global indices (int64) and their f32 halves,
    padding after; returns (blocks, counts of every rank)."""
    counts = np.array([cap - 7, 3, 0, cap // 3], np.int64)
    off = int(counts[:rank].sum())
    idx = torch.full((cap,), -1, dtype=torch.int64, device=device)
    idx[:counts[rank]] = off + torch.arange(int(counts[rank]), device=device)
    return [idx, torch.where(idx >= 0, idx.float() * 0.5, 0.0)], counts


def par_rank_work(torch, mesh, sizes: dict) -> dict:
    """One rank of phase 23 (b): every entry point of ``parallel/`` on this
    rank's shard of ``par_inputs``; each entry's output, wall and the bytes
    this rank hands to the collectives."""
    from astro_sph_tools_tpu_torch import render_halo_maps
    from astro_sph_tools_tpu_torch.ops import CoherentCaps, GridSpec, MapSpec, caps_from_layout, tile_particles_coherent
    from astro_sph_tools_tpu_torch.parallel import (
        absorption_spectra_sharded, caps_union_mesh, column_integrate_sharded, deposit_2d_coherent_sharded,
        deposit_2d_coherent_sharded_fused, deposit_2d_sharded, deposit_3d_sharded, distributed_reorder,
        rebalance_evenly,
    )
    from astro_sph_tools_tpu_torch.parallel._comm import all_reduce_

    device, r, s = mesh.device, mesh.rank, mesh.size
    inp = par_inputs(torch, device, sizes)
    x, y, h, m, t, box = inp["2d"]
    q = x.shape[0] // s
    sl = slice(r * q, (r + 1) * q)  # Morton-contiguous quarters
    res = sizes["res"]
    spec = MapSpec(shape=(res, res), extent=(0.0, box, 0.0, box), periodic_wrap=True)
    fields = torch.stack([m, m * t])
    xs, ys, hs, fs = x[sl], y[sl], h[sl], fields[:, sl].contiguous()
    K = par_level_K(h, box / res)
    caps = caps_union_mesh(caps_from_layout(tile_particles_coherent(xs, ys, hs, fs, spec, device=device)), mesh)
    tiny = CoherentCaps(b0=4096, bucket_caps=(0,) * len(caps.bucket_caps), level_caps=(0,) * len(caps.level_caps))

    pos3, h3, m3 = inp["3d"]
    ng = sizes["vox"]
    slab_of = torch.clamp((pos3[:, 2] / (VOX_BOX / s)).long(), 0, s - 1)
    mine = torch.nonzero(slab_of == r).squeeze(1)
    p3, hh3, mm3 = pos3[mine], h3[mine], m3[mine]
    grids = [GridSpec(shape=(ng,) * 3, extent=(0.0, VOX_BOX) * 3, periodic_wrap=p) for p in (True, False)]
    pos_s, h_s, m_s, v_s, T_s, rx, ry, cosmo = inp["sight"]
    qs = pos_s.shape[0] // s
    ss = slice(r * qs, (r + 1) * qs)
    src_ids, data, tgt_full, tgt_part = inp["ids"]
    qi = src_ids.shape[0] // s
    si = slice(r * qi, (r + 1) * qi)
    blocks, counts = par_rebalance_blocks(torch, device, r, sizes["rebalance_cap"])
    snap = memory_snapshot(xs, ys, hs, m[sl], t[sl], box)
    centres, radii = halo_catalogue(torch, inp["2d"])
    cat = memory_catalogue(centres, radii, snap)
    map_bytes = 2 * res * res * 4
    halo = 8  # K = 16
    entries = [
        ("deposit_2d_sharded", lambda: deposit_2d_sharded(xs, ys, hs, fs.T, spec, mesh, K=K), map_bytes),
        ("coherent_synced", lambda: deposit_2d_coherent_sharded(xs, ys, hs, fs, spec, mesh), map_bytes + 16),
        ("coherent_fused", lambda: deposit_2d_coherent_sharded_fused(xs, ys, hs, fs, spec, mesh, caps),
         map_bytes + 4),
        ("coherent_fused_tiny_caps_on_rank_3", lambda: deposit_2d_coherent_sharded_fused(
            xs, ys, hs, fs, spec, mesh, tiny if r == s - 1 else caps), map_bytes + 4),
        ("deposit_3d_sharded_periodic", lambda: deposit_3d_sharded(p3, hh3, mm3, grids[0], mesh, K=16),
         2 * halo * ng * ng * 4),
        ("deposit_3d_sharded_open", lambda: deposit_3d_sharded(p3, hh3, mm3, grids[1], mesh, K=16),
         2 * halo * ng * ng * 4),
        ("columns_sharded", lambda: column_integrate_sharded(
            [(pos_s[ss, 0], pos_s[ss, 1], h_s[ss], m_s[ss])], rx, ry, periodic_box=SIGHT_BOX, mesh=mesh),
         sizes["rays"] * 4),
        ("spectra_sharded", lambda: absorption_spectra_sharded(
            [(pos_s[ss], h_s[ss], m_s[ss], v_s[ss], T_s[ss])], rx, ry, cosmology=cosmo, box_size=SIGHT_BOX,
            n_bins=512, mesh=mesh)[0], sizes["rays"] * 512 * 4),
        ("reorder_permutation", lambda: distributed_reorder(src_ids[si], data[si], tgt_full[si], mesh)[:2],
         qi * (8 + 4) + qi * 8 + qi * (4 + 1)),
        ("reorder_partial", lambda: distributed_reorder(src_ids[si], data[si], tgt_part[si], mesh,
                                                        default_value=-1.0)[:2],
         qi * (8 + 4) + qi * 8 + qi * (4 + 1)),
        ("rebalance", lambda: rebalance_evenly(blocks, counts, mesh, pad_values=(-1, 0.0)),
         int(counts[r]) * (8 + 4)),
        ("render_halo_maps", lambda: [{k: st[k] for k in st.keys()} for st in render_halo_maps(
            snap, cat, list(PAR_HALOES), fields=("density", "temperature"), resolution=sizes["halo_res"],
            mesh=mesh)], len(PAR_HALOES) * map_bytes),
    ]
    out = {"rank": r, "device": str(device), "caps": [caps.b0, list(caps.bucket_caps), list(caps.level_caps)],
           "entries": {}}
    # the main path, once, with every launch count reset just before it
    reset_launches()
    for name, fn, nbytes_ in entries:
        sync(torch, device)
        t0 = time.perf_counter()
        value = fn()
        sync(torch, device)
        out["entries"][name] = {"wall_s_cold": time.perf_counter() - t0, "bytes_exchanged": nbytes_,
                                "result": _to_host(torch, value)}
    out["launches"] = read_launches()
    for name, fn, _ in entries:
        out["entries"][name]["wall_s"] = wall_s(fn, 2, device)
    # the map stack's all_reduce alone: gloo stages it through the host
    buf = torch.zeros((2, res, res), dtype=torch.float32, device=device)
    out["all_reduce_map_s"] = wall_s(lambda: all_reduce_(buf, mesh), 3, device)
    if device.type == "cuda":  # on the CPU every wrapper runs its plain version
        # each launched kernel against its plain version on this rank's own
        # inputs, after the last collective
        out["kernels_vs_plain"] = par_kernels_vs_plain(
            torch, device, f"par_rank{r}", coherent=(xs, ys, hs, fs, spec), level=(xs, ys, hs, fs, spec, K),
            slabs=[(p3, hh3, mm3, spec3, r, s, 16) for spec3 in grids],
            columns=(pos_s[ss, 0].contiguous(), pos_s[ss, 1].contiguous(), h_s[ss], m_s[ss], rx, ry, SIGHT_BOX),
            spectra=(pos_s[ss], h_s[ss], m_s[ss], v_s[ss], T_s[ss], rx, ry, cosmo, SIGHT_BOX, 512),
        )
    return out


def _to_host(torch, value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    if isinstance(value, (list, tuple)):
        return type(value)(_to_host(torch, v) for v in value)
    if isinstance(value, dict):
        return {k: _to_host(torch, v) for k, v in value.items()}
    return value


def par_rank_main(rank: int, par_dir: str) -> None:
    """A phase 23 (b) rank process: a gloo group of PAR_RANKS ranks on the
    card through a FileStore in ``par_dir``; writes ``rank<r>.pt``."""
    from datetime import timedelta

    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    from astro_sph_tools_tpu_torch.parallel import make_mesh

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: phase 23's ranks need the GPU")
    with open(os.path.join(par_dir, "sizes.json")) as f:
        sizes = json.load(f)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(par_dir, "store"), PAR_RANKS), rank=rank,
                            world_size=PAR_RANKS, timeout=timedelta(seconds=PAR_TIMEOUT_S))
    try:
        mesh = make_mesh(PAR_RANKS)
        torch.cuda.set_device(mesh.device)
        out = par_rank_work(torch, mesh, sizes)
        torch.save(out, os.path.join(par_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(cmds, par_dir: str, timeout_s: float) -> list:
    """Start one process per command, wait for all of them with one
    deadline; a rank that fails or outlives the deadline fails the phase.
    Every process is stopped before this returns. Returns their exit codes."""
    procs, logs = [], []
    try:
        for r, cmd in enumerate(cmds):
            log = open(os.path.join(par_dir, f"rank{r}.log"), "w")
            logs.append(log)
            env = {k: v for k, v in os.environ.items() if k != "LOCAL_RANK"}
            procs.append(subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env))
        deadline = time.monotonic() + timeout_s
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                raise AssertionError(f"phase 23's ranks outlived {timeout_s} s")
            if any(p.poll() not in (None, 0) for p in procs):
                time.sleep(2)  # let the others report, then stop them
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    rcs = [p.returncode for p in procs]
    if any(rc != 0 for rc in rcs):
        for r in range(len(cmds)):
            with open(os.path.join(par_dir, f"rank{r}.log")) as f:
                print(f"--- rank {r} (exit {rcs[r]}) ---\n" + f.read()[-3000:], file=sys.stderr, flush=True)
        raise AssertionError(f"phase 23's ranks failed: exit codes {rcs}")
    return rcs


def par_check(torch, device, results: list, sizes: dict) -> dict:
    """Phase 23 (b)'s checks in the parent: every rank's outputs against
    the single-device engines on the same whole inputs, and the rebalance
    against the even split of the counts the ranks were given."""
    from astro_sph_tools_tpu_torch import render_halo_maps
    from astro_sph_tools_tpu_torch.ops import (
        PALLAS_LEVELS, ArrayReorder, GridSpec, MapSpec, absorption_spectra_pallas, column_integrate_pallas,
        deposit_2d_auto, deposit_2d_coherent, deposit_2d_pallas, deposit_3d_auto,
    )

    inp = par_inputs(torch, device, sizes)
    x, y, h, m, t, box = inp["2d"]
    res = sizes["res"]
    spec = MapSpec(shape=(res, res), extent=(0.0, box, 0.0, box), periodic_wrap=True)
    fields = torch.stack([m, m * t])
    ref_auto = deposit_2d_auto(x, y, h, fields, spec, device=device)
    ref_coh = deposit_2d_coherent(x, y, h, fields, spec, device=device)
    pos3, h3, m3 = inp["3d"]
    ng = sizes["vox"]
    pos_s, h_s, m_s, v_s, T_s, rx, ry, cosmo = inp["sight"]
    src_ids, data, tgt_full, tgt_part = inp["ids"]
    centres, radii = halo_catalogue(torch, inp["2d"])
    snap = memory_snapshot(x, y, h, m, t, box)
    level = next(c for c in PALLAS_LEVELS if c.K == par_level_K(h, box / res))
    # deposit_2d_sharded is deposit_2d_pallas at one level on each shard:
    # held to it on the whole input (REL_TOL), and to the adaptive engine
    # (PATH_TOL: the levels' tile-local f32 frames differ)
    refs = {
        "deposit_2d_sharded": lambda: deposit_2d_pallas(x, y, h, fields, spec, level=level, device=device).permute(
            1, 2, 0),
        "deposit_2d_sharded_vs_auto": lambda: ref_auto.permute(1, 2, 0),
        "coherent_synced": lambda: ref_coh,
        "coherent_fused": lambda: ref_coh,
        "deposit_3d_sharded_periodic": lambda: deposit_3d_auto(
            pos3, h3, m3, GridSpec(shape=(ng,) * 3, extent=(0.0, VOX_BOX) * 3, periodic_wrap=True), device=device),
        "deposit_3d_sharded_open": lambda: deposit_3d_auto(
            pos3, h3, m3, GridSpec(shape=(ng,) * 3, extent=(0.0, VOX_BOX) * 3), device=device),
        "columns_sharded": lambda: column_integrate_pallas(
            pos_s[:, 0].contiguous(), pos_s[:, 1].contiguous(), h_s, m_s, rx, ry, periodic_box=SIGHT_BOX,
            device=device),
        "spectra_sharded": lambda: absorption_spectra_pallas(
            pos_s, h_s, m_s, v_s, T_s, rx, ry, cosmology=cosmo, box_size=SIGHT_BOX, n_bins=512, device=device)[0],
    }
    rows = {}
    for name, ref_fn in refs.items():
        ref = ref_fn()
        entry = "deposit_2d_sharded" if name == "deposit_2d_sharded_vs_auto" else name
        if name.startswith("deposit_3d"):
            got = torch.cat([r["entries"][name]["result"] for r in results])
            same = True
        else:
            got_all = [r["entries"][entry]["result"] for r in results]
            if name.startswith("coherent_fused"):
                got_all = [g[0] for g in got_all]
            got = got_all[0]
            same = all(torch.equal(g, got) for g in got_all)
        err, rel = rel_err(got.to(device), ref)
        rows[name] = {"max_abs_err": err, "rel_err": rel, "same_on_every_rank": same,
                      "tolerance": PATH_TOL if name == "deposit_2d_sharded_vs_auto" else REL_TOL}
    rows["coherent_fused"]["ok"] = [bool(r["entries"]["coherent_fused"]["result"][1]) for r in results]
    rows["coherent_fused_tiny_caps_on_rank_3"] = {
        "ok": [bool(r["entries"]["coherent_fused_tiny_caps_on_rank_3"]["result"][1]) for r in results]}

    ref_perm = ArrayReorder.create(src_ids, tgt_full)(data, default_value=-1.0)
    ref_part = ArrayReorder.create(src_ids, tgt_part)(data, default_value=-1.0)
    for name, ref, tgt in (("reorder_permutation", ref_perm, tgt_full), ("reorder_partial", ref_part, tgt_part)):
        vals = torch.cat([r["entries"][name]["result"][0] for r in results]).to(device)
        matched = torch.cat([r["entries"][name]["result"][1] for r in results]).to(device)
        present = torch.isin(tgt, src_ids)
        rows[name] = {"exact": bool(torch.equal(vals, ref)), "matched_exact": bool(torch.equal(matched, present)),
                      "matched": int(matched.sum()), "n": int(tgt.shape[0])}

    # the even split of the input counts, from the counts the ranks were
    # given: total // size each, the first total % size ranks one more
    counts_before = par_rebalance_blocks(torch, "cpu", 0, sizes["rebalance_cap"])[1]
    total, n_ranks = int(counts_before.sum()), len(results)
    even = [total // n_ranks + (1 if r < total % n_ranks else 0) for r in range(n_ranks)]
    counts_ok = all([int(c) for c in r["entries"]["rebalance"]["result"][1]] == even for r in results)
    idx = torch.cat([r["entries"]["rebalance"]["result"][0][0][:c] for r, c in zip(results, even)])
    half = torch.cat([r["entries"]["rebalance"]["result"][0][1][:c] for r, c in zip(results, even)])
    pads = all(bool((r["entries"]["rebalance"]["result"][0][0][c:] == -1).all()) for r, c in zip(results, even))
    rows["rebalance"] = {
        "counts_before": counts_before.tolist(),
        "counts_after": results[0]["entries"]["rebalance"]["result"][1].tolist(), "counts_even": even,
        "counts_exact": counts_ok,
        "exact": counts_ok and bool(torch.equal(idx, torch.arange(total)))
        and bool(torch.equal(half, idx.float() * 0.5)) and pads,
    }

    ref_halo = render_halo_maps(snap, memory_catalogue(centres, radii, snap), list(PAR_HALOES),
                                fields=("density", "temperature"), resolution=sizes["halo_res"], device=device)
    halo_errs = []
    for r in results:
        for got, ref in zip(r["entries"]["render_halo_maps"]["result"], ref_halo):
            covered = ref["surface_density"] > 1e-3 * ref["surface_density"].max()
            for k in got:
                g, want = got[k], ref[k]
                if k.startswith("mean_"):
                    g, want = g[covered], want[covered]
                halo_errs.append(rel_err(g, want))
    rows["render_halo_maps"] = {"max_abs_err": max(e for e, _ in halo_errs),
                                "rel_err": max(e for _, e in halo_errs), "tolerance": REL_TOL}
    for name, row in rows.items():
        entry = results[0]["entries"].get(name)
        if entry is None:
            continue
        row["wall_s_cold"] = [r["entries"][name]["wall_s_cold"] for r in results]
        row["wall_s"] = [r["entries"][name]["wall_s"] for r in results]
        row["bytes_exchanged_per_rank"] = entry["bytes_exchanged"]
    return rows


def phase_parallel_gloo(torch, device, sizes: dict = PAR_SIZES) -> dict:
    """Phase 23 (b): PAR_RANKS gloo ranks on the one card, each a process of
    its own (``par_rank_main``), with a deadline; every entry point against
    the single-device result of the same particles, and on every rank each
    launched kernel against its plain version on the rank's own inputs."""

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "sizes.json"), "w") as f:
            json.dump(sizes, f)
        cmds = [[sys.executable, os.path.abspath(__file__), "--par-rank", str(r), "--par-dir", tmp]
                for r in range(PAR_RANKS)]
        run_ranks(cmds, tmp, PAR_TIMEOUT_S + 120)
        spawn_s = time.perf_counter() - t0
        results = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(PAR_RANKS)]
    rows = par_check(torch, device, results, sizes)
    vs_plain = merge_vs_plain([r["kernels_vs_plain"] for r in results])
    launches = {k: sum(r["launches"][k] for r in results) for k in results[0]["launches"]}
    all_reduce_s = [r["all_reduce_map_s"] for r in results]
    staged = {name: max(all_reduce_s) / float(np.median(rows[name]["wall_s"]))
              for name in ("deposit_2d_sharded", "coherent_synced", "coherent_fused")}
    out = {"phase": "parallel_gloo", "ranks": PAR_RANKS, "backend": "gloo", "sizes": sizes,
           "devices": [r["device"] for r in results], "ranks_s": spawn_s, "launches": launches, "entries": rows,
           "all_reduce_map_s": all_reduce_s, "staged_all_reduce_share": staged, "caps_union": results[0]["caps"],
           "kernels_vs_plain": vs_plain}
    emit(out)
    check_par_rows(rows, results)
    for name in ("deposit2d", "coherent_prep", "coherent_deposit", "sightline_columns", "sightline_spectra",
                 "deposit3d"):
        check(launches[name] > 0, f"phase 23 (b) launched no {name} kernel: {launches}")
        check(vs_plain[name]["cases"] >= PAR_RANKS and vs_plain[name]["rel_err"] <= REL_TOL,
              f"phase 23 (b) {name} off its plain version on a rank's inputs: {vs_plain}")
    return out


def check_par_rows(rows: dict, results: list) -> None:
    """Phase 23 (b)'s verdict on ``par_check``'s rows: each map within
    REL_TOL of its single-device engine and the same on every rank, every
    rank ``ok`` with merged capacities and none when one rank's overflow,
    the reorders and the rebalance exact, one set of merged capacities."""
    check(len({json.dumps(r["caps"]) for r in results}) == 1, "the ranks' merged capacities differ")
    for name in ("deposit_2d_sharded", "deposit_2d_sharded_vs_auto", "coherent_synced", "coherent_fused",
                 "deposit_3d_sharded_periodic", "deposit_3d_sharded_open", "columns_sharded", "spectra_sharded",
                 "render_halo_maps"):
        check(rows[name]["rel_err"] <= rows[name]["tolerance"],
              f"phase 23 (b) {name} off its single-device engine: {rows[name]}")
        check(rows[name].get("same_on_every_rank", True), f"phase 23 (b) {name} differs between ranks")
    check(all(rows["coherent_fused"]["ok"]), "the fused sharded render reported overflow with merged capacities")
    check(not any(rows["coherent_fused_tiny_caps_on_rank_3"]["ok"]),
          "one rank's overflow did not make ok False on every rank")
    for name in ("reorder_permutation", "reorder_partial"):
        check(rows[name]["exact"] and rows[name]["matched_exact"], f"phase 23 (b) {name} not exact: {rows[name]}")
    check(rows["rebalance"]["exact"], f"phase 23 (b) rebalance not exact: {rows['rebalance']}")


def phase_parallel(torch, device, particles) -> dict:
    """Phase 23: (a) a world of one rank over NCCL at full size, (b)
    PAR_RANKS gloo ranks on the one card; the launches of kernels #1-#6
    over both, each above zero, and each kernel's largest error against its
    plain version on the phase's inputs."""
    t0 = time.perf_counter()
    a = phase_parallel_world1(torch, device, particles)
    torch.cuda.empty_cache()
    b = phase_parallel_gloo(torch, device)
    launches = {k: a["launches"][k] + b["launches"][k] for k in a["launches"]}
    out = {"phase": "parallel", "launches": launches,
           "kernels_vs_plain": merge_vs_plain([a["kernels_vs_plain"], b["kernels_vs_plain"]]),
           "seconds": time.perf_counter() - t0}
    emit(out)
    check(all(v > 0 for v in launches.values()), f"phase 23 launched a kernel of #1-#6 no time: {launches}")
    return out


# ---------------------------------------------------------------------------
# phase 24: the rest (window mode, the fidelity artifact, the examples, the
# multi-GPU dry run)
# ---------------------------------------------------------------------------

REST_WINDOWS = (256, 512, 1024)  # phase 24 (a)'s windows at full width
REST_SERVICE_LOG2N = 25  # phase 24 (c): render_service's chunks of 2^25 ...
REST_SERVICE_CHUNKS = 4  # ... four of them, 1024^2 x 2
REST_RANKS = 4  # phase 24 (d): gloo ranks of the dry run and multichip_render
REST_TIMEOUT_S = 300.0


def coherent_window_bytes(torch, lay, out) -> int:
    """Bytes kernel #2's window branch must move on a window-mode layout:
    ``coherent_bytes`` with the key channel of each distinct window step's
    W lanes in place of each candidate row's 2048, and the step arrays it
    reads (the layout's ``win_steps``) in place of the candidate arrays."""
    g0 = lay.geom0
    step_row, step_lane0, _, _ = lay.win_steps
    n_windows = int(torch.unique(step_row.long() * lay.packed.shape[2] + step_lane0.long()).numel())
    live = lay.cand_tile < g0.n_tiles
    n_rows = int(torch.unique(lay.cand_row[live]).numel())
    whole = coherent_bytes(torch, lay.packed, lay.cand_tile, lay.cand_row, lay.n_fields, g0.n_tiles, out)
    return (whole + (n_windows * lay.window - n_rows * lay.packed.shape[2]) * 4 + nbytes(*lay.win_steps)
            - nbytes(lay.cand_tile, lay.cand_row))


def _window_vs_plain(torch, lay, spec, h, projection, plain_reps: int, **tags):
    """Kernel #2's window branch vs its plain version on a window-mode
    layout, its time beside the whole-row kernel's on the same candidates
    (which read every lane of their rows) and beside its bound."""
    TC = _coherent_module()
    g0 = lay.geom0
    psy, psx = spec.pixel_size
    kw = dict(n_fields=lay.n_fields, n_tiles=g0.n_tiles, cfg=g0.cfg, kernel="cubic_spline",
              projection=projection, psx=psx, psy=psy, offset=spec.sample_offset)
    wb0, nw, _ = lay.cand_win
    wargs = (lay.packed, lay.cand_tile, lay.cand_row, wb0, nw)
    got = TC.deposit_coherent_windows(*wargs, lay.win_steps, window=lay.window, **kw)
    ref = TC.deposit_coherent_windows_plain(*wargs, window=lay.window, **kw)
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    del ref
    case = {
        "phase": "window_kernel_vs_plain", **tags, "window": lay.window, "F": lay.n_fields, "projection": projection,
        "n_candidates": lay.n_cand, "n_window_steps": lay.b0w, "n_tiles": g0.n_tiles,
        "max_abs_err": err, "rel_err": rel,
        "ms": cuda_ms(lambda: TC.deposit_coherent_windows(*wargs, lay.win_steps, window=lay.window, **kw), 5),
        "whole_row_ms": cuda_ms(lambda: TC.deposit_coherent_tiles(lay.packed, lay.cand_tile, lay.cand_row, **kw), 5),
        "plain_ms": cuda_ms(lambda: TC.deposit_coherent_windows_plain(*wargs, window=lay.window, **kw), plain_reps)
        if plain_reps else None,
        **bound(coherent_window_bytes(torch, lay, got), support_points(h, 2.0, psx, 2) * pair_ops(lay.n_fields,
                                                                                                   projection)),
    }
    emit(case)
    check(bool(torch.isfinite(got).all()), f"non-finite window kernel output {case}")
    check(rel <= REL_TOL, f"the window kernel disagrees with its plain version: {case}")
    check_bound(case, f"kernel #2's window branch {tags} W={lay.window} F={lay.n_fields} {projection}")
    return case


def rest_window(torch, device, particles) -> dict:
    """Phase 24 (a): window mode at full width on phase 3's particles."""
    from astro_sph_tools_tpu_torch.ops import MapSpec, deposit_2d_coherent, tile_particles_coherent
    from astro_sph_tools_tpu_torch.ops.deposit_tiled import deposit_tiles

    TC = _coherent_module()
    x, y, h, m, t, box = particles
    spec = MapSpec(shape=(1024, 1024), extent=(0.0, box, 0.0, box), periodic_wrap=True)
    all_fields = [m, m * t, t, 2.0 * m]
    vals = torch.stack(all_fields[:2])
    whole = deposit_2d_coherent(x, y, h, vals, spec, prep="xla", device=device)
    maps, cases, launches = [], [], {"coherent_window": 0, "deposit2d": 0}
    for W in REST_WINDOWS:
        # the main path: the entry point, with the counts set to 0 just before
        TC.deposit_coherent_windows.launches = deposit_tiles.launches = 0
        sync(torch, device)
        t0 = time.perf_counter()
        img = deposit_2d_coherent(x, y, h, vals, spec, window=W, device=device)
        sync(torch, device)
        wall = time.perf_counter() - t0
        launches["coherent_window"] += TC.deposit_coherent_windows.launches
        launches["deposit2d"] += deposit_tiles.launches
        check(TC.deposit_coherent_windows.launches > 0, f"window mode W={W} launched no window kernel")
        err, rel = rel_err(img, whole)
        maps.append({"window": W, "vs_whole_row_max_abs_err": err, "vs_whole_row_rel_err": rel, "wall_s": wall,
                     "finite": bool(torch.isfinite(img).all())})
        emit({"phase": "rest_window_map", **maps[-1]})
        check(maps[-1]["finite"] and rel <= REL_TOL, f"window map off the whole-row map: {maps[-1]}")
        del img
        lay = tile_particles_coherent(x, y, h, vals, spec, window=W, device=device)
        cases.append(_window_vs_plain(torch, lay, spec, h, "kernel3d", 1, case="main"))
        if W == 512:
            cases.append(_window_vs_plain(torch, lay, spec, h, "integrated", 0, case="main"))
            del lay
            for n_fields in (1, 4):
                lay = tile_particles_coherent(x, y, h, torch.stack(all_fields[:n_fields]), spec, window=W,
                                              device=device)
                for projection in ("kernel3d", "integrated"):
                    cases.append(_window_vs_plain(torch, lay, spec, h, projection, 0, case="main"))
                del lay
        else:
            del lay
    dx, dy, dh, dv = dense_coherent_particles(torch, device, 1 << 20, box, seed=17)
    lay = tile_particles_coherent(dx, dy, dh, dv[:2], spec, window=512, device=device)
    for projection in ("kernel3d", "integrated"):
        cases.append(_window_vs_plain(torch, lay, spec, dh, projection, 1, case="dense"))
    del lay
    return {"maps": maps, "cases": cases, "launches": launches}


def rest_fidelity(torch, device, out_path: str) -> dict:
    """Phase 24 (b): the fidelity artifact at full size, written to
    ``out_path``; every in-budget case within its budget."""
    from astro_sph_tools_tpu_torch.scripts import fidelity_check

    art = fidelity_check.run(device)
    with open(out_path, "w") as f:
        json.dump(art, f, indent=1)
    scored = [c for c in art["cases"] if c["in_budget_flag"]]
    out = {"path": os.path.abspath(out_path), "all_within_budget": art["all_within_budget"],
           "worst_case": art["worst_case"], "n_cases": len(art["cases"]), "n_in_budget": len(scored),
           "seconds": art["seconds"], "nvidia_smi": art["nvidia_smi"],
           "window_launches": sum(c["kernels"].get("coherent_window", 0) for c in art["cases"])}
    emit({"phase": "rest_fidelity", **out})
    over = [c for c in scored if not c["max_rel_err"] <= fidelity_check.BUDGET]
    check(not over, f"fidelity cases over their budget: {over}")
    return out


def rest_service(torch, device) -> dict:
    """Phase 24 (c): ``examples.render_service`` at 4 chunks of 2^25 on
    1024^2 x 2: every ok True, the summed map against one sorted render of
    every chunk, kernels #1-#3 against their plain versions on the first
    fused chunk."""
    from astro_sph_tools_tpu_torch.examples import render_service
    from astro_sph_tools_tpu_torch.ops import MapSpec, deposit_2d_auto

    reset_launches()
    out = render_service.run(1 << REST_SERVICE_LOG2N, 1024, REST_SERVICE_CHUNKS, device, keep=True)
    launches = {k: v for k, v in read_launches().items() if k in ("deposit2d", "coherent_prep", "coherent_deposit")}
    parts = out.pop("chunks")
    spec = MapSpec(shape=(1024, 1024), extent=(0.0, render_service.BOX, 0.0, render_service.BOX), periodic_wrap=True)
    x, y, h, f = (torch.as_tensor(np.concatenate([p[i] for p in parts], axis=-1), device=device) for i in range(4))
    ref = deposit_2d_auto(x, y, h, f, spec, device=device)
    err, rel = rel_err(out.pop("map"), ref)
    del x, y, h, f, ref
    torch.cuda.empty_cache()
    first_fused = [torch.as_tensor(a, device=device) for a in parts[1]]
    del parts
    vs_plain = path_kernels_vs_plain(torch, device, *first_fused, spec, ("coherent",), "render_service")
    res = {"phase": "rest_render_service", "chunk_wall_s": out["chunk_wall_s"], "engines": out["engines"],
           "ok": out["ok"], "calibration": out["calibration"], "caps": out["caps"], "launches": launches,
           "vs_sorted_max_abs_err": err, "vs_sorted_rel_err": rel,
           "kernels_vs_plain": {"prep": vs_plain["prep"]["max_abs_err"],
                                "coherent_deposit": vs_plain["coherent_deposit"]["rel_err"],
                                "tail_levels": max((c["rel_err"] for c in vs_plain["tail_levels"]), default=0.0)}}
    emit(res)
    check(all(out["ok"]) and len(out["ok"]) == REST_SERVICE_CHUNKS - 1, f"render_service overflowed: {out['ok']}")
    check(rel <= REL_TOL, f"render_service's map off the sorted render: {rel}")
    check(all(v > 0 for v in launches.values()), f"render_service launched a kernel of #1-#3 no time: {launches}")
    return {**res, "vs_plain": vs_plain}


def rest_rank_main(rank: int, rest_dir: str) -> None:
    """A phase 24 (d) rank process: a gloo group of REST_RANKS ranks on the
    card through a FileStore in ``rest_dir``; ``dryrun_multichip`` then
    ``examples.multichip_render``; writes ``rank<r>.pt``."""
    from datetime import timedelta

    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    from astro_sph_tools_tpu_torch.examples import multichip_render
    from astro_sph_tools_tpu_torch.parallel import make_mesh
    from astro_sph_tools_tpu_torch.parallel.dryrun import dryrun_multichip

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: phase 24's ranks need the GPU")
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(rest_dir, "store"), REST_RANKS), rank=rank,
                            world_size=REST_RANKS, timeout=timedelta(seconds=REST_TIMEOUT_S))
    try:
        t0 = time.perf_counter()
        dry = dryrun_multichip(REST_RANKS)
        dry_s = time.perf_counter() - t0
        mesh = make_mesh(REST_RANKS)
        t0 = time.perf_counter()
        mc = multichip_render.run(mesh)
        mc_s = time.perf_counter() - t0
        torch.save({"dryrun": dry, "dryrun_s": dry_s, "multichip": _to_host(torch, mc), "multichip_s": mc_s},
                   os.path.join(rest_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def rest_examples(torch, device) -> dict:
    """Phase 24 (d): ``examples.full_workflow`` on the card (in-memory
    source: this machine has no h5py), then REST_RANKS gloo ranks running
    ``dryrun_multichip`` and ``examples.multichip_render`` under one
    deadline."""

    from astro_sph_tools_tpu_torch.examples import full_workflow

    counters = {k: v for k, v in _par_counters().items()
                if k in ("deposit2d", "sightline_columns", "sightline_spectra", "deposit3d")}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    wf = full_workflow.run(None, device=device, source="memory")
    wf_s = time.perf_counter() - t0
    wf_launches = {k: fn.launches for k, fn in counters.items()}
    keys = ("n_haloes", "surface_density_sum", "cutout_sums", "cube_mass_recon", "columns_median", "spectra_shape",
            "spectra_finite", "nearest_median", "reorder_lossless", "reorder_exact", "ion_log_fraction",
            "filter_selected", "skipped")
    res = {"phase": "rest_examples", "full_workflow": {k: wf[k] for k in keys}, "full_workflow_s": wf_s,
           "full_workflow_launches": wf_launches}
    check(all(v > 0 for v in wf_launches.values()), f"full_workflow launched a kernel no time: {wf_launches}")
    check(wf["spectra_finite"] and wf["reorder_exact"] and abs(wf["cube_mass_recon"] - 1.0) < 1e-3,
          f"full_workflow's checks failed: {res['full_workflow']}")
    with tempfile.TemporaryDirectory() as tmp:
        cmds = [[sys.executable, os.path.abspath(__file__), "--rest-rank", str(r), "--rest-dir", tmp]
                for r in range(REST_RANKS)]
        t0 = time.perf_counter()
        run_ranks(cmds, tmp, REST_TIMEOUT_S)
        res["ranks_s"] = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(REST_RANKS)]
    res["dryrun_launches"] = {k: sum(r["dryrun"]["launches"][k] for r in ranks) for k in ranks[0]["dryrun"]["launches"]}
    res["dryrun_step_seconds"] = ranks[0]["dryrun"]["step_seconds"]
    res["dryrun_s"] = [r["dryrun_s"] for r in ranks]
    mc = [r["multichip"] for r in ranks]
    res["multichip"] = {k: mc[0][k] for k in ("coherent", "cube", "reorder", "columns")}
    res["multichip_s"] = [r["multichip_s"] for r in ranks]
    res["multichip_same_on_every_rank"] = all(
        torch.equal(m["coherent_map"], mc[0]["coherent_map"]) and torch.equal(m["columns_values"], mc[0]["columns_values"])
        for m in mc)
    emit(res)
    check(all(r["dryrun"]["device"] == "cuda:0" for r in ranks), "a dry-run rank ran off the card")
    check(all(res["dryrun_launches"][k] > 0 for k in _par_counters()),
          f"the dry run launched a kernel of #1-#6 no time: {res}")
    check(all(m["reorder"] == {"exact": True, "matched": True} for m in mc), "multichip_render's reorder not exact")
    check(res["multichip_same_on_every_rank"], "multichip_render's reduced maps differ between ranks")
    return res


def phase_rest(torch, device, particles, fidelity_out: str) -> dict:
    """Phase 24: (a) window mode, (b) the fidelity artifact, (c)
    render_service, (d) full_workflow, dryrun_multichip and
    multichip_render."""
    t0 = time.perf_counter()
    a = rest_window(torch, device, particles)
    ta = time.perf_counter() - t0
    del particles
    torch.cuda.empty_cache()
    b = rest_fidelity(torch, device, fidelity_out)
    tb = time.perf_counter() - t0 - ta
    torch.cuda.empty_cache()
    c = rest_service(torch, device)
    tc = time.perf_counter() - t0 - ta - tb
    torch.cuda.empty_cache()
    d = rest_examples(torch, device)
    out = {"phase": "rest", "seconds": time.perf_counter() - t0,
           "part_seconds": {"window": ta, "fidelity": tb, "render_service": tc,
                            "examples": time.perf_counter() - t0 - ta - tb - tc}}
    emit(out)
    return {**out, "window": a, "fidelity": b, "service": c, "examples": d}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", default="0,1,2,3,4,5,6,7,8,9,19,23,10,11,12,13,14,25,26,27,16,17,20,21,22,24",
                        help="comma-separated phases to run (15 and 18 only when named)")
    parser.add_argument("--log2n", type=int, default=MAIN_LOG2N, help="log2 of the main path's particle count")
    parser.add_argument("--sight-n", type=int, default=SIGHT_N, help="gas particles of phases 10-12")
    parser.add_argument("--vox-log2n", type=int, default=VOX_LOG2N, help="log2 of phase 14's particle count")
    parser.add_argument("--rand-log2n", type=int, default=RAND_LOG2N,
                        help="log2 of phases 16-17's shuffled particle count")
    parser.add_argument("--e2e-log2n", type=int, default=E2E_LOG2N, help="log2 of phase 20's particle count")
    parser.add_argument("--ion-log2n", type=int, default=ION_LOG2N, help="log2 of phase 21's particle count")
    parser.add_argument("--neigh-side", type=int, default=NEIGH_SIDE,
                        help="phase 22's particles per axis (DM and gas each side^3)")
    parser.add_argument("--par-rank", type=int, help="run one rank of phase 23 (b) (started by phase 23 itself)")
    parser.add_argument("--par-dir", help="phase 23 (b)'s shared directory (with --par-rank)")
    parser.add_argument("--rest-rank", type=int, help="run one rank of phase 24 (d) (started by phase 24 itself)")
    parser.add_argument("--rest-dir", help="phase 24 (d)'s shared directory (with --rest-rank)")
    parser.add_argument("--fidelity-out", default=os.path.join(tempfile.gettempdir(), "FIDELITY_TORCH.json"),
                        help="where phase 24 writes the fidelity artifact (default: the temporary directory)")
    parser.add_argument("--cpu-probe", choices=("torch", "port"),
                        help="run one CPU first-call probe in this process and print its error (phase 0)")
    args = parser.parse_args()
    if args.cpu_probe:
        print(json.dumps(cpu_probe(args.cpu_probe)), flush=True)
        return
    if args.par_rank is not None:
        par_rank_main(args.par_rank, args.par_dir)
        return
    if args.rest_rank is not None:
        rest_rank_main(args.rest_rank, args.rest_dir)
        return
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
    particles, gen_s = main_particles(torch, device, args.log2n) if phases & {3, 4, 6, 7, 8, 9, 19, 23} else (None, 0.0)
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
    halo_out = phase_halo(torch, device, particles) if 19 in phases else None
    par_out = phase_parallel(torch, device, particles) if 23 in phases else None
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
    if 18 in phases:
        phase_voxel_split(torch, device, args.vox_log2n)
    torch.cuda.empty_cache()
    grid_out = grid_route_cases(torch, device) if 25 in phases else None
    box_rows = box_level_cases(torch, device) if 26 in phases else []
    cube_rows = cube_level_cases(torch, device) if 27 in phases else []
    rp, rand_gen_s = random_particles(torch, device, args.rand_log2n) if phases & {16, 17} else (None, 0.0)
    app_cases = phase_append_kernel(torch, device, rp) if 16 in phases else []
    rand_out = phase_random(torch, device, rp, rand_gen_s) if 17 in phases else None
    del rp
    torch.cuda.empty_cache()
    e2e_out = phase_e2e(torch, device, args.e2e_log2n) if 20 in phases else None
    torch.cuda.empty_cache()
    ion_out = phase_ion(torch, device, args.ion_log2n) if 21 in phases else None
    torch.cuda.empty_cache()
    neigh_out = phase_neighbours(torch, device, args.neigh_side) if 22 in phases else None
    torch.cuda.empty_cache()
    rest_out = None
    if 24 in phases:
        rest_out = phase_rest(torch, device, main_particles(torch, device, args.log2n)[0], args.fidelity_out)

    def pick(rows, **match):
        return next((c for c in rows if all(c.get(k) == v for k, v in match.items())), None)

    def bound_keys(case):
        """The case's bound; no single PyTorch call computes the functions
        of kernels #1-#6, so no library time."""
        return {
            "bound_ms": case["bound_ms"] if case else None,
            "bound_by": case["bound_by"] if case else None,
            "library_ms": None,
        }

    def par_launches(name):
        """The multi-GPU path's launches of a kernel (phase 23, both parts)
        and its largest error against its plain version on that path's
        inputs."""
        row = par_out["kernels_vs_plain"][name] if par_out else None
        return {"parallel_path_launches": par_out["launches"][name] if par_out else None,
                "parallel_path_max_abs_err": row["max_abs_err"] if row else None,
                "parallel_path_rel_err": row["rel_err"] if row else None}

    ref_case = pick(cases, case="uniform", K=8, F=2, projection="kernel3d")
    main_k8 = pick(main_out["levels"], K=8) if main_out else None
    prep_case = pick(prep_cases, case="coherent_order")
    coh_case = pick(coh_cases, case="main", F=2, projection="kernel3d")
    launches = coh_out["launches_synced"] if coh_out else {}
    col_case = pick(col_cases, projection="integrated", periodic=True, F=1)
    spec_case = pick(spec_cases, input="config4", profile="gaussian", periodic=True)
    vox_case = pick(vox_cases, K=8, F=4, periodic=True)
    app_case = pick(app_cases, case="coarse")
    wide_all = halo_out["wide_cases"] if halo_out else []
    wide0 = pick(wide_all, halo=0)
    win = rest_out["window"] if rest_out else None
    win_case = pick(win["cases"], case="main", window=512, F=2, projection="kernel3d") if win else None
    sight_launches = sight_out["launches"] if sight_out else {}
    # phase 17's checks of kernels #1-#3 on the bucketed stream
    stream = rand_out["bucketed_stream_checks"] if rand_out else {}
    dep_all = cases + stream.get("tail_levels", []) + (neigh_out["dm_map"]["kernel_levels"] if neigh_out else [])
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
            # the main path's K = 8 level at 2^26 (phase 3)
            "main_path_k8_ms": main_k8["kernel_ms"] if main_k8 else None,
            "main_path_k8_bound_ms": main_k8["bound_ms"] if main_k8 else None,
            # the box cells' K = 32 and 64 levels, the register path (phase 26)
            "box_levels": {r["K"]: {"ms": r["ms"], "bound_ms": r["bound_ms"], "f64_rel_err": r["f64_rel_err"],
                                    "lane_efficiency": r["lane_efficiency"]} for r in box_rows},
            # the halo path's launches: 16 cutouts of phase 3's particles (phase 19)
            "halo_path_launches": halo_out["launches"] if halo_out else None,
            # the streamed and the ion-weighted paths' launches (phases 20, 21)
            "e2e_path_launches": e2e_out["launches"]["deposit2d"] if e2e_out else None,
            "ion_path_launches": ion_out["launches"]["deposit2d"] if ion_out else None,
            # the DM map of phase 22's smoothing lengths
            "dm_path_launches": neigh_out["dm_map"]["launches"] if neigh_out else None,
            **par_launches("deposit2d"),
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
            "e2e_path_launches": e2e_out["launches"]["coherent_prep"] if e2e_out else None,
            "ion_path_launches": ion_out["launches"]["coherent_prep"] if ion_out else None,
            **par_launches("coherent_prep"),
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
            # the main path's layout (phase 7's case, its K = 8 level-0 tiles)
            "main_path_k8_ms": coh_case["ms"] if coh_case else None,
            "main_path_k8_bound_ms": coh_case["bound_ms"] if coh_case else None,
            "e2e_path_launches": e2e_out["launches"]["coherent_deposit"] if e2e_out else None,
            "ion_path_launches": ion_out["launches"]["coherent_deposit"] if ion_out else None,
            **par_launches("coherent_deposit"),
        },
        {
            "name": "coherent_window",
            "route": "cuda",
            "source": "astro_sph_tools_tpu_torch/csrc/coherent.cu",
            # the window-step branch of _deposit_kernel_coherent: its window words
            "replaces": "astro_sph_tools_tpu/ops/deposit_coherent.py:683",
            "launches": win["launches"]["coherent_window"] if win else None,
            "max_abs_err": max((c["max_abs_err"] for c in win["cases"]), default=None) if win else None,
            "ms": win_case["ms"] if win_case else None,
            "plain_ms": win_case["plain_ms"] if win_case else None,
            **bound_keys(win_case),
            # each window at full width: kernel, the whole-row kernel on the same candidates, bound
            "by_window": {c["window"]: {"ms": c["ms"], "whole_row_ms": c["whole_row_ms"], "bound_ms": c["bound_ms"],
                                        "n_window_steps": c["n_window_steps"]}
                          for c in (win["cases"] if win else []) if c["case"] == "main" and c["F"] == 2
                          and c["projection"] == "kernel3d"},
        },
        {
            "name": "deposit_wide",
            "route": "cuda",
            "source": "astro_sph_tools_tpu_torch/csrc/deposit_wide.cu",
            "replaces": None,  # the JAX package sends these footprints to XLA
            # phase 19: the 16-halo render's launches; the halo cell's halo 0
            "launches": halo_out["wide_launches"] if halo_out else None,
            "max_abs_err": None,
            "ms": wide0["deposit_ms"] if wide0 else None,
            "bin_ms": wide0["bin_ms"] if wide0 else None,
            "route_ms": wide0["route_ms"] if wide0 else None,
            "plain_ms": wide0["plain_ms"] if wide0 else None,
            **bound_keys(wide0),
            "rel_err_vs_f64": max((c["rel_err_vs_f64"] for c in wide_all), default=None),
            "plain_rel_err_vs_f64": max((c["plain_rel_err_vs_f64"] for c in wide_all), default=None),
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
            # the config-4 columns' launch: 10^4 rays (phase 12)
            "main_path_ms": sight_out["columns_work"]["ms"] if sight_out else None,
            "main_path_bound_ms": sight_out["columns_work"]["bound_ms"] if sight_out else None,
            **par_launches("sightline_columns"),
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
            **par_launches("sightline_spectra"),
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
            # the cube cell's K = 4 / 8 / 16 levels (phase 27)
            "cube_levels": {r["K"]: {"ms": r["ms"], "bound_ms": r["bound_ms"], "plain_rel_err": r["plain_rel_err"],
                                     "candidates_per_particle": r["candidates_per_particle"]} for r in cube_rows},
            **par_launches("deposit3d"),
        },
        {
            "name": "deposit3d_wide",
            "route": "cuda",
            "source": "astro_sph_tools_tpu_torch/csrc/deposit3d_wide.cu",
            "replaces": None,  # the JAX package sends these footprints to XLA
            # phase 25: the cube cell's oversize segment, one product's launches
            "launches": grid_out["launches"] if grid_out else None,
            "max_abs_err": grid_out["max_abs_err"] if grid_out else None,
            "ms": grid_out["deposit_ms"] if grid_out else None,
            "bin_ms": grid_out["bin_ms"] if grid_out else None,
            "route_ms": grid_out["route_ms"] if grid_out else None,
            "plain_ms": grid_out["plain_ms"] if grid_out else None,
            "plain_subset_n": grid_out["plain_subset_n"] if grid_out else None,
            "plain_ms_whole_segment": grid_out["plain_ms_whole_segment"] if grid_out else None,
            **bound_keys(grid_out),
            "rel_err_vs_f64": grid_out["rel_err_vs_f64"] if grid_out else None,
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
