"""chip_smoke.py's bounds count the work the kernels' functions need.

- Kernel #5 (spectra): ``spectra_work``'s expected counts over uniform
  random rays, held against a brute-force count of this seed's (particle,
  ray) hits and of the profile terms, on a small CPU case: the Gaussian
  terms that are not 0 in f32, each Voigt term by the branch
  ``voigt_hjerting`` takes (the Chebyshev core for |z| <= 7, the series and
  exp to |z| = 10.16, the series alone beyond), the terms past the first of
  each bin, and each bin's own work once.
- Kernel #2 (coherent deposit): ``coherent_bytes``, held against a count
  made candidate by candidate and lane by lane on a small CPU layout with
  heavy rows (which no candidate names and the kernel does not read).

And kernel #1's f64 yardstick: ``plain_f64_sum`` (the plain version's f32
terms, runs of a few particles at a time, summed in f64) equals the same
terms taken one particle at a time, with no f32 sum at all.

And phase 19's in-memory inputs: ``memory_catalogue`` serves what
``render_halo_maps`` reads (centres of potential and SO 200 crit radii, in
Mpc), ``memory_snapshot`` its fields (metallicities from a seeded
generator), ``halo_catalogue`` places its haloes as the phase says, and
``cutout_selection`` selects the particles the render hands the engine.
"""

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
from test_torch_coherent_prep import prep_inputs  # noqa: E402

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


@pytest.mark.parametrize("n_fields", [1, 4])
def test_coherent_bound_counts_what_the_kernel_reads(n_fields):
    import importlib

    from astro_sph_tools_tpu_torch.ops import tile_particles_coherent

    TC = importlib.import_module("astro_sph_tools_tpu_torch.ops.deposit_coherent")
    spec, x, y, h, vals = prep_inputs(37 + n_fields, 8, periodic=True, heavy_rows=(1, 6), n_fields=n_fields)
    lay = tile_particles_coherent(x, y, h, vals, spec, device="cpu")
    assert lay.stats["heavy_rows"] >= 2 and lay.n_cand > 0
    g0 = lay.geom0
    psy, psx = spec.pixel_size
    out = TC.deposit_coherent_tiles_plain(
        lay.packed, lay.cand_tile, lay.cand_row, n_fields=n_fields, n_tiles=g0.n_tiles, cfg=g0.cfg,
        kernel="cubic_spline", projection="kernel3d", psx=psx, psy=psy, offset=0.5,
    )
    # a pad candidate (tile n_tiles) names a row but is not read
    cand_tile = torch.cat([lay.cand_tile, torch.tensor([g0.n_tiles], dtype=torch.int32)])
    cand_row = torch.cat([lay.cand_row, torch.tensor([1], dtype=torch.int32)])
    got = cs.coherent_bytes(torch, lay.packed, cand_tile, cand_row, n_fields, g0.n_tiles, out)

    keys = lay.packed[:, 3 + n_fields, :].numpy()
    rows, lanes = set(), 0
    for tile, row in zip(cand_tile.tolist(), cand_row.tolist()):
        if tile >= g0.n_tiles:
            continue
        rows.add(row)
        lanes += sum(1 for k in keys[row] if k == tile)
    heavy = {r for r in range(lay.packed.shape[0]) if r not in rows}
    assert heavy  # rows no candidate names, their channels not counted
    brute = 4 * (len(rows) * 2048 + lanes * (3 + n_fields)) + 4 * (2 * cand_tile.numel() + out.numel())
    assert got == brute
    assert got < cs.nbytes(lay.packed, cand_tile, cand_row, out)  # below the old count: all 8 channels of all rows


@pytest.mark.parametrize("side,radii", [(4, "log"), (2, "uniform")])
def test_plain_f64_sum_is_the_f64_sum_of_the_plain_terms(side, radii):
    from astro_sph_tools_tpu_torch.ops import MapSpec
    from astro_sph_tools_tpu_torch.ops.deposit_tiled import PALLAS_LEVELS, deposit_tiles_plain

    spec = MapSpec(shape=(1024, 1024), extent=(0.0, 25.0, 0.0, 25.0), periodic_wrap=True)
    cfg = PALLAS_LEVELS[0]
    geom, args = cs._dense_level_inputs(torch, cfg, 0.02, cfg.max_s_pix, 2, 1 << 12, spec, 31 + side, "cpu",
                                        side=side, radii=radii)
    assert int((args[5] > 0).sum()) > 1 and int(args[5].max()) > 8 * 64  # several dense tiles
    kw = dict(cfg=cfg, kernel="cubic_spline", projection="kernel3d", psx=25 / 1024, psy=25 / 1024,
              offset=spec.sample_offset)
    got = cs.plain_f64_sum(torch, deposit_tiles_plain, args, kw)
    exact = cs.plain_f64_sum(torch, deposit_tiles_plain, args, kw, run=1)  # one term a pixel a particle
    plain = deposit_tiles_plain(*args, **kw)
    assert got.dtype == torch.float64 and got.shape == plain.shape
    assert cs.rel_err(got, exact)[1] <= 1e-7
    assert cs.rel_err(plain, exact)[1] <= 1e-5


@pytest.mark.parametrize("li", [2, 3])
def test_register_lane_work_counts_the_kernels_steps(li):
    """Phase 26's lane count of #1's register path, brute-forced: every
    pixel the exact test passes lies in the loop box it is counted from;
    the register path's 32-lane steps are the (row pair, 16-column group)
    cells of the tile's owners (``register_pixels``) that the box meets;
    the warp-a-particle design's, the box's pixels 32 a step."""
    from astro_sph_tools_tpu_torch.ops import MapSpec
    from astro_sph_tools_tpu_torch.ops.deposit_tiled import PALLAS_LEVELS, register_pixels

    spec = MapSpec(shape=(1024, 1024), extent=(0.0, 25.0, 0.0, 25.0), periodic_wrap=True)
    cfg = PALLAS_LEVELS[li]
    px = 25.0 / 1024
    geom, args = cs._level_inputs(torch, cfg, PALLAS_LEVELS[li - 1].max_s_pix, cfg.max_s_pix, 1, 300, spec, 47 + li,
                                  "cpu")
    u, v, h = args[:3]
    work = cs.register_lane_work(torch, u, v, h, cfg, px, px, spec.sample_offset)
    # each (row pair, column group) cell: the pixels of one 32-lane step, by the owners' map
    cells = {}
    for rank in range(2):
        for warp in range(12):
            for lane in range(32):
                for _, r, c in register_pixels(cfg.R, 2, rank, warp, lane):
                    cells.setdefault((r // 2, c // 16), set()).add((r, c))
    assert all(len(px_set) == 32 for px_set in cells.values())
    steps = warp_steps = box_pixels = 0
    rows = torch.arange(cfg.R, dtype=torch.float32)
    cols = torch.arange(128, dtype=torch.float32)
    for i in range(u.shape[0]):
        s_n = 2.0 * float(h[i]) / px  # support radius in pixels
        col0 = int(np.floor(float(u[i]) - 0.5 + 0.5)) - cfg.K // 2
        dy = (rows + 0.5 - v[i]) * (px / h[i])
        dx = (cols + 0.5 - u[i]) * (px / h[i])
        inside = (dy[:, None] ** 2 + dx[None, :] ** 2 < 4.0) & (cols >= col0) & (cols < col0 + cfg.K)
        r_in, c_in = torch.nonzero(inside, as_tuple=True)
        cy, cx = float(v[i]) - 0.5, float(u[i]) - 0.5
        slack = 0.01 + 1e-4 * s_n
        r_lo, r_hi = max(int(np.ceil(cy - s_n - slack)), 0), min(int(np.floor(cy + s_n + slack)), cfg.R - 1)
        c_lo = max(int(np.ceil(cx - s_n - slack)), col0, 0)
        c_hi = min(int(np.floor(cx + s_n + slack)), col0 + cfg.K - 1, 127)
        assert r_in.numel() and int(r_in.min()) >= r_lo and int(r_in.max()) <= r_hi
        assert int(c_in.min()) >= c_lo and int(c_in.max()) <= c_hi
        box = {(r, c) for r in range(r_lo, r_hi + 1) for c in range(c_lo, c_hi + 1)}
        steps += sum(1 for px_set in cells.values() if px_set & box)
        warp_steps += -(-len(box) // 32)
        box_pixels += len(box)
    assert work["register_lane_evals"] == 32.0 * steps
    assert work["warp_lane_evals"] == 32.0 * warp_steps
    assert work["box_pixels"] == box_pixels


def test_ptxas_summary_reads_registers_and_spills():
    """Phase 1's per-kernel summary of ``nvcc -Xptxas -v``: every
    instantiation of the named kernel, the most registers and spill bytes
    among them, and nothing of other kernels."""
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114columns_kernelILi0ELb1ELi1EEEvPKf' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_114columns_kernelILi0ELb1ELi1EEEvPKf",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, used 1 barriers, 1024 bytes smem, 532 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114columns_kernelILi0ELb1ELi5EEEvPKf' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_114columns_kernelILi0ELb1ELi5EEEvPKf",
        "    24 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 56 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118column_sums_kernelEPKfiiiPf' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_118column_sums_kernelEPKfiiiPf",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 90 registers",
    ])
    assert cs.ptxas_summary(log, "columns_kernel") == {"instances": 2, "registers_max": 56, "spill_bytes_max": 24}
    assert cs.ptxas_summary(log, "column_sums_kernel") == {"instances": 1, "registers_max": 90, "spill_bytes_max": 0}
    assert cs.ptxas_summary(log, "coherent_prep_kernel") == {
        "instances": 0, "registers_max": None, "spill_bytes_max": None}


def small_halo_inputs():
    x, y, h, m, t = cs.clustered_particles(1 << 14, 25.0, 32, seed=7, device=torch.device("cpu"))
    return (x, y, h, m, t, 25.0)


def test_memory_catalogue_serves_what_render_halo_maps_reads(monkeypatch):
    import astro_sph_tools_tpu_torch.render as render_mod
    from astro_sph_tools_tpu_torch import render_halo_maps
    from astro_sph_tools_tpu_torch.data_structures import ParticleType
    from astro_sph_tools_tpu_torch.io.catalogue import BasicHaloDefinitions, CatalogueBase
    from astro_sph_tools_tpu_torch.io.errors import HaloDefinitionNotSupportedError

    particles = small_halo_inputs()
    x, y, h, m, t, box = particles
    snap = cs.memory_snapshot(*particles)
    z = snap.get_metallicities(ParticleType.gas).value
    assert torch.equal(z, cs.memory_snapshot(*particles).get_metallicities(ParticleType.gas).value)
    assert float(z.min()) >= 0.0 and float(z.max()) < 0.04

    centres, radii = cs.halo_catalogue(torch, particles)
    assert centres.shape == (cs.HALO_N, 3) and radii.shape == (cs.HALO_N,)
    np.testing.assert_allclose([radii[0], radii[-1]], [0.15, 1.0])
    assert np.hypot(*centres[-2, :2]) < 0.1 and abs(centres[-1, 0] - box) < 0.1
    assert (centres[:, 2] == 0).all()
    cat = cs.memory_catalogue(centres, radii, snap)
    assert isinstance(cat, CatalogueBase) and len(cat) == cs.HALO_N and cat.redshift == snap.redshift
    np.testing.assert_array_equal(cat.get_halo_centres_of_potential().to_value("Mpc"), centres)
    np.testing.assert_array_equal(cat.get_halo_radii(BasicHaloDefinitions.SO_200_CRIT.value).to_value("Mpc"), radii)
    with pytest.raises(HaloDefinitionNotSupportedError):
        cat.get_halo_radii(BasicHaloDefinitions.SO_500_CRIT.value)
    with pytest.raises(NotImplementedError):
        cat.get_halo_masses(BasicHaloDefinitions.SO_200_CRIT.value)

    seen = []
    real = render_mod.deposit_2d_auto

    def spy(lx, *args, **kw):
        seen.append(int(lx.shape[0]))
        return real(lx, *args, **kw)

    monkeypatch.setattr(render_mod, "deposit_2d_auto", spy)
    haloes = [0, cs.HALO_N - 2, cs.HALO_N - 1]
    stacks = render_halo_maps(snap, cat, haloes, fields=("density", "temperature", "metallicity"),
                              resolution=32, device="cpu")
    xy = torch.stack([x, y], dim=1).double()
    counts = [int(cs.cutout_selection(torch, xy, h.double(), centres[k], 2 * radii[k], box)[1].shape[0])
              for k in haloes]
    assert seen == counts and min(counts) > 0
    for stack in stacks:
        assert stack["surface_density"][15:17, 15:17].mean() > 0
        assert cs.stack_errors(stack, stack) == {name: 0.0 for name in stack.keys()}


def test_e2e_files_and_chunks_follow_the_benchmark():
    """Phase 20's in-memory snapshot (``e2e_files``): ``write_big_snapshot``'s
    distribution in raw internal units, each file Morton-sorted at the
    wire's 65536 cells; ``e2e_read_chunk`` takes files ci, ci + 4 as the
    reader's process split does, and its three wires decode to the same
    particles in user units (positions to a cell, fields to the wire's
    quantisation)."""
    from astro_sph_tools_tpu.io.packing import _interleave16
    from astro_sph_tools_tpu_torch import constants as C
    from astro_sph_tools_tpu_torch.io.packing import unpack_particles_device

    files = cs.e2e_files(torch, "cpu", 14, res=64)
    assert len(files) == cs.E2E_FILES and sum(f["Mass"].shape[0] for f in files) == 1 << 14
    px = cs.E2E_BOX / 64
    for f in files:
        pos = f["Coordinates"] / cs.E2E_HUBBLE
        q = np.clip(pos[:, :2] / cs.E2E_BOX * 65536, 0, 65535).astype(np.uint16)
        assert (np.diff(_interleave16(q[:, 0], q[:, 1]).astype(np.int64)) >= 0).all()
        assert (pos >= 0).all() and (pos <= cs.E2E_BOX).all()
        h = f["SmoothingLength"] / cs.E2E_HUBBLE
        assert h.min() >= 0.25 * px * (1 - 1e-6) and h.max() <= 24 * px * (1 + 1e-6)
        assert abs(np.median(h) / (0.9 * px) - 1) < 0.1
        m = f["Mass"].astype(np.float64) * (cs.E2E_MASS_CGS / (cs.E2E_HUBBLE * C.SOLAR_MASS_CGS))
        assert 0.8e6 * (1 - 1e-6) <= m.min() and m.max() <= 1.2e6 * (1 + 1e-6)
    raw = cs.e2e_raw_chunk(files, 1)
    assert raw["Mass"].shape[0] == files[1]["Mass"].shape[0] + files[5]["Mass"].shape[0]
    x, y, h, m, t = cs.e2e_read_chunk(files, "f32", 1)
    assert x.dtype == np.float32 and np.array_equal(x, (raw["Coordinates"][:, 0] * (1 / cs.E2E_HUBBLE)).astype(np.float32))
    for wire in ("pack", "packdelta"):
        px_, py_, ph, f = (a.numpy() for a in unpack_particles_device(cs.e2e_read_chunk(files, wire, 1), device="cpu"))
        assert np.abs(px_ - x).max() <= cs.E2E_BOX / 65536 and np.abs(py_ - y).max() <= cs.E2E_BOX / 65536
        assert np.abs(ph / h - 1).max() < 1e-3
        assert np.abs(f[0] / m - 1).max() < 0.01 and np.abs(f[1] / t - 1).max() < 0.03


def test_ion_inputs_follow_the_benchmark():
    """Phase 21's generator (``ion_particles``: Morton-ordered cells, the
    clipped lognormal h, log n_H and log T), its table plane at z = 0.5 and
    its payload, against the JAX package's lookup of the same plane."""
    from astro_sph_tools_tpu.data_structures.ionisation import IonisationTableBase as JBase
    from astro_sph_tools_tpu.ops.interp import regular_grid_interpolate as j_interp

    n = 1 << 15
    x, y, h, mass, log_nh, log_t = cs.ion_particles(torch, "cpu", n, res=64)
    px = cs.ION_BOX / 64
    assert float(h.min()) >= 0.1 * px * (1 - 1e-6) and float(h.max()) <= 14 * px * (1 + 1e-6)
    assert abs(float(log_nh.mean()) + 4.0) < 0.05 and abs(float(log_t.std()) - 0.6) < 0.02
    assert float(x.min()) >= 0 and float(x.max()) <= cs.ION_BOX
    arrays, axes2, grid2 = cs.ion_table(torch, "cpu")
    jt = JBase(arrays["ionbal"], arrays["logd"], arrays["logt"], arrays["redshift"], redshift_input_index=2)
    jaxes, jgrid = jt.table_at_redshift(cs.ION_REDSHIFT)
    np.testing.assert_allclose(grid2.numpy(), np.asarray(jgrid), rtol=1e-6, atol=1e-6)
    temp_lin = torch.exp2(log_t * np.log2(10.0)) * 2.0**-16
    fields = cs.ion_payload(torch, axes2, grid2, log_nh, log_t, mass, temp_lin).numpy()
    pts = np.stack([log_nh.numpy(), log_t.numpy()], axis=1)
    jlogf = np.asarray(j_interp([np.asarray(a, np.float32) for a in jaxes], np.asarray(jgrid, np.float32), pts,
                                method="gather"), np.float64)
    jion = mass.numpy() * 10.0 ** jlogf
    assert (fields[0][~np.isfinite(jlogf)] == 0).all() and (~np.isfinite(jlogf)).any()
    ok = np.isfinite(jlogf)
    assert np.abs(fields[0][ok] / jion[ok] - 1).max() < 1e-4
    np.testing.assert_allclose(fields[1], fields[0] * temp_lin.numpy(), rtol=1e-6)


def test_neighbour_positions_follow_the_crossover_benchmark():
    """Phase 22's generator is ``benchmarks/knn_crossover.py::clustered``:
    the same points from the same draws (half in blobs of sigma = box / 40
    around max(8, m // 1500) centres, half uniform), and its blob centres."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("knn_crossover", os.path.join(ROOT, "benchmarks", "knn_crossover.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    for m in (5000, 30000):
        pts, centres = cs.neighbour_positions(np.random.default_rng(3), m, cs.NEIGH_BOX)
        np.testing.assert_array_equal(pts, bench.clustered(np.random.default_rng(3), m, cs.NEIGH_BOX))
        assert pts.dtype == np.float32 and pts.shape == (m, 3) and len(centres) == max(8, m // 1500)
        # the blob half sits within a few sigma of its centres
        d = np.abs(pts[: m // 2, None, :] - centres[None, :, :].astype(np.float32))
        d = np.minimum(d, cs.NEIGH_BOX - d)
        nearest = np.sqrt((d**2).sum(-1)).min(1)
        sigma = cs.NEIGH_BOX / 40
        assert np.median(nearest) < 2 * sigma and np.quantile(nearest, 0.99) < 4.5 * sigma


def test_neighbour_haloes_follow_the_mass_function():
    """Phase 22's haloes: the blob centres first, the rest uniform; log10
    M200 in [9, 14.5] with dN/dlogM ~ M^-0.9 (the share above each cut as
    the CDF gives it) and M200 = 200 rho_crit 4/3 pi R200^3."""
    from astro_sph_tools_tpu_torch.data_structures import Cosmology

    rng = np.random.default_rng(5)
    centres = rng.uniform(0, cs.NEIGH_BOX, (700, 3))
    c, logm, m200, r200 = cs.neighbour_haloes(rng, centres, 200_000, cs.NEIGH_BOX)
    np.testing.assert_array_equal(c[:700], centres)
    assert c.shape == (200_000, 3) and (c >= 0).all() and (c < cs.NEIGH_BOX).all()
    assert logm.min() >= 9.0 and logm.max() <= 14.5
    a, b = 10 ** (-0.9 * 9.0), 10 ** (-0.9 * 14.5)
    for cut in (10.0, 11.0, 12.0, 13.0):
        expect = (10 ** (-0.9 * cut) - b) / (a - b)
        assert abs((logm > cut).mean() - expect) <= 5 * np.sqrt(expect / 200_000) + 1e-5
    rho = Cosmology.from_redshift(0.0, 0.6777, 0.04825).critical_density_comoving()
    np.testing.assert_allclose(200 * rho * 4 / 3 * np.pi * r200**3, m200, rtol=1e-12)
    assert 0.05 < r200[np.abs(logm - 12).argmin()] < 0.5  # ~0.2 Mpc at 1e12 Msun


def test_nearest_halo_search_returns_what_the_cli_writes(tmp_path):
    """The search phase 22 runs is the CLI's: on a synthetic EAGLE tree,
    ``nearest_halo_search`` of the arrays the CLI reads gives the datasets
    it writes."""
    import h5py

    from astro_sph_tools_tpu_torch.io.synthetic import SyntheticSnapshotSpec, write_catalogue, write_snapshot
    from astro_sph_tools_tpu_torch.data_structures import ParticleType
    from astro_sph_tools_tpu_torch.io.catalogue import BasicHaloDefinitions
    from astro_sph_tools_tpu_torch.io.filetree import FileTreeScraper_EAGLE
    from astro_sph_tools_tpu_torch.scripts.find_nearest_haloes import main, nearest_halo_search

    spec = SyntheticSnapshotSpec(n_gas=1024, n_dm=256, n_star=64, n_bh=2, n_groups=6, clustered=True)
    _, truth = write_snapshot(str(tmp_path), spec)
    write_catalogue(str(tmp_path), spec, truth)
    assert main(["-z", "0.5", "--eagle", "-i", str(tmp_path), "-o", str(tmp_path / "out"), "-m", "11.0,30.0",
                 "--device", "cpu"]) == 0
    cats = FileTreeScraper_EAGLE(str(tmp_path)).catalogues
    cat = cats.get_by_number(cats.find_file_number_from_redshift(0.5)).load()
    so = BasicHaloDefinitions.SO_200_CRIT.value
    passes = []
    keys, ids, dist, rad = nearest_halo_search(
        cat.snapshot.get_positions(ParticleType.gas).to_value("Mpc"), cat.get_halo_indexes(),
        cat.get_halo_centres_of_potential().to_value("Mpc"), cat.get_halo_radii(so).to_value("Mpc"),
        cat.get_halo_masses(so).value, [11.0, 30.0], float(cat.snapshot.box_size.value[0]), device="cpu",
        passes=passes,
    )
    assert [p["n_haloes"] > 0 for p in passes] == [True, True, False] and passes[2]["engine"] is None
    with h5py.File(tmp_path / "out.hdf5", "r") as f:
        g = f[f"redshift_{cat.snapshot.redshift}"]
        groups = [g, g["minimum_halo_mass_limited/11.00"], g["minimum_halo_mass_limited/30.00"]]
        for i, grp in enumerate(groups):
            np.testing.assert_array_equal(grp["halo_indexes"][:], ids[:, i])
            np.testing.assert_array_equal(grp["halo_comoving_distance"][:], dist[:, i])
            np.testing.assert_array_equal(grp["halo_comoving_radius"][:], rad[:, i])
    assert keys[0] == -np.inf and (ids[:, 2] == -1).all() and np.isinf(dist[:, 2]).all()


def test_crossover_interpolates_where_the_ratio_crosses_one():
    assert cs.crossover([1e3, 1e4], [2.0, 0.5], [1.0, 1.0]) == pytest.approx(10 ** 3.5)
    assert cs.crossover([1e3, 1e4], [0.5, 0.1], [1.0, 1.0]) is None
    assert cs.crossover([1e3, 1e4], [2.0, 3.0], [1.0, 1.0]) == np.inf
