"""The oversize route ``ops/deposit_wide.py``: the tiled algorithm of
``csrc/deposit_wide.cu`` in plain torch, and on the card the kernels.

- The plain tiled route (the torch side of the binning and the deposit
  kernel's plain version) against the stencil route it replaces,
  ``deposit_2d``'s wide windows and dense pass on the same particles
  (``deposit_wide_plain``): 1e-6 * max with the 3D kernel; with the
  line-integrated kernel 3e-6 * max, because ``deposit_2d`` reads a
  4096-entry lookup table and the kernels the Chebyshev fit, which differ
  by up to 2.1e-6 of the peak (Wendland C2).
- The per-tile lists against a brute-force (particle, tile) overlap in f64.
- On the card: the kernels against the plain versions, the lists bit for
  bit, and the counters on the ``deposit.oversize`` span.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from astro_sph_tools_tpu_torch.ops import deposit_wide as W
from astro_sph_tools_tpu_torch.ops.deposit import MapSpec
from astro_sph_tools_tpu_torch.ops.deposit_tiled import deposit_2d_auto, tile_particles
from astro_sph_tools_tpu_torch.utils.profiling import spans

NY, NX = 80, 96  # 3 x 3 tiles, the last row and column partial
EXTENT = (-1.0, 1.2, 0.5, 2.3)  # pixels of 0.0229 x 0.0225: not square
TOL = {"kernel3d": 1e-6, "integrated": 3e-6}


def rel_err(got, ref) -> float:
    got, ref = torch.as_tensor(got, dtype=torch.float64), torch.as_tensor(ref, dtype=torch.float64)
    return float((got - ref).abs().max() / ref.abs().max())


def oversize_particles(seed: int, n: int, *, periodic: bool, kernel: str = "wendland_c2", n_fields: int = 3,
                       s_max: float = 45.0, margin: float = 0.0, device="cpu"):
    """(u, v, h, values (F, n), spec): supports of 32-``s_max`` px (past
    kernel #1's widest level), centres ``margin`` px beyond the map's edges
    at most (periodic maps keep them on the map, as the layouts do)."""
    rng = np.random.default_rng(seed)
    spec = MapSpec(shape=(NY, NX), extent=EXTENT, periodic_wrap=periodic)
    psy, psx = spec.pixel_size
    m = 0.0 if periodic else margin
    u = rng.uniform(-m, NX + m, n)
    v = rng.uniform(-m, NY + m, n)
    S = 3.0 if kernel == "quintic_spline" else 2.0
    h = rng.uniform(32.0, s_max, n) * min(psx, psy) / S
    values = rng.uniform(0.5, 2.0, (n_fields, n))
    t = [torch.as_tensor(a, dtype=torch.float32, device=device) for a in (u, v, h, values)]
    return (*t, spec)


CASES = {
    f"{'periodic' if per else 'open'}-{proj}-{kern}-F{F}": dict(periodic=per, projection=proj, kernel=kern, n_fields=F)
    for per in (False, True)
    for proj in ("kernel3d", "integrated")
    for kern in ("wendland_c2", "cubic_spline")
    for F in (1, 3, 7)
}
# discs wider than the map (up to 2.5 x its width): on a periodic map every
# pixel takes the nearest image, as the dense pass has it
CASES["periodic-wider-than-map"] = dict(periodic=True, s_max=240.0)
CASES["open-wider-than-map"] = dict(periodic=False, s_max=240.0)
# centres up to 60 px off the map, whose supports reach in
CASES["open-off-map"] = dict(periodic=False, margin=60.0)
# a cap that holds about 30 entries beside the geometry: several batches
CASES["open-two-batches"] = dict(periodic=False, scratch_bytes=12 * 10 + 20 * 8 + 4 * 30)
CASES["periodic-two-batches"] = dict(periodic=True, scratch_bytes=12 * 10 + 20 * 8 + 4 * 30)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tiled_route_matches_the_stencil_route(case):
    opts = dict(CASES[case])
    projection = opts.pop("projection", "kernel3d")
    scratch = opts.pop("scratch_bytes", W.SCRATCH_BYTES)
    kernel = opts.get("kernel", "wendland_c2")
    u, v, h, values, spec = oversize_particles(sorted(CASES).index(case), 60, **opts)
    F = values.shape[0]
    ref = W.deposit_wide_plain(u, v, h, values, spec, kernel=kernel, projection=projection,
                               out=torch.zeros(F, NY, NX))
    got = torch.zeros(F, NY, NX)
    batches = W.deposit_wide_tiled(u, v, h, values, spec, kernel=kernel, projection=projection, out=got,
                                   scratch_bytes=scratch, plain=True)
    assert float(ref.abs().max()) > 0
    assert rel_err(got, ref) <= TOL[projection], case
    # the batches cover the particles in order, each within the cap
    assert [b[0] for b in batches] == [0] + [b[1] for b in batches[:-1]] and batches[-1][1] == u.shape[0]
    if scratch < W.SCRATCH_BYTES:
        assert len(batches) >= 2
        n_tiles = 9
        assert all(12 * (n_tiles + 1) + 20 * (p1 - p0) + 4 * pairs <= scratch for p0, p1, pairs in batches)
    else:
        assert len(batches) == 1


def brute_force_tiles(u, v, h, spec: MapSpec, shrink: float, kernel="wendland_c2"):
    """{tile: set of particles} whose support holds a pixel of the tile, in
    f64: a pixel within the support radius once each offset is shortened by
    ``shrink`` px (0: the exact test), minimum image on a periodic map."""
    S = 3.0 if kernel == "quintic_spline" else 2.0
    psy, psx = spec.pixel_size
    ny, nx = spec.shape
    off = spec.sample_offset
    cols = np.arange(nx) + off
    rows = np.arange(ny) + off
    out = {}
    for i, (pu, pv, ph) in enumerate(zip(u.double().numpy(), v.double().numpy(), h.double().numpy())):
        dx, dy = cols - pu, rows - pv
        if spec.periodic_wrap:
            dx, dy = dx - nx * np.round(dx / nx), dy - ny * np.round(dy / ny)
        dx = np.maximum(np.abs(dx) - shrink, 0.0) * psx / (S * ph)
        dy = np.maximum(np.abs(dy) - shrink, 0.0) * psy / (S * ph)
        inside = dy[:, None] ** 2 + dx[None, :] ** 2 < 1.0
        for ty, tx in {(r // W.TILE, c // W.TILE) for r, c in zip(*np.nonzero(inside))}:
            out.setdefault(ty * W.tile_grid(spec)[0] + tx, set()).add(i)
    return out


@pytest.mark.parametrize("case", ["open", "periodic", "periodic-wider-than-map", "open-off-map"])
def test_tile_lists_match_a_brute_force_overlap(case):
    opts = dict(periodic=case.startswith("periodic"), s_max=240.0 if "wider" in case else 45.0,
                margin=60.0 if "off-map" in case else 0.0)
    u, v, h, _, spec = oversize_particles(11 + len(case), 40, **opts)
    psy, psx = spec.pixel_size
    geo, _, lim2 = W.particle_geometry(u, v, h, kernel="wendland_c2", projection="kernel3d", psx=psx, psy=psy)
    counts = W.tile_counts_plain(geo, lim2, spec)
    lists = W.tile_lists_plain(geo, lim2, spec)
    assert counts.dtype == lists.dtype == torch.int32 and int(counts.sum()) == lists.shape[0]
    starts = np.concatenate([[0], np.cumsum(counts.numpy())])
    exact = brute_force_tiles(u, v, h, spec, 0.0)
    loose = brute_force_tiles(u, v, h, spec, 0.02)  # the binning's 0.01 px slack, with room for rounding
    n_tiles = int(np.prod(W.tile_grid(spec)))
    assert sum(len(s) for s in exact.values()) > n_tiles  # most tiles hold several particles
    for t in range(n_tiles):
        got = lists[starts[t]:starts[t + 1]].tolist()
        assert got == sorted(set(got)), "a tile's list is in particle order, each particle once"
        assert exact.get(t, set()) <= set(got) <= loose.get(t, set()), t


def test_the_cpu_wrapper_takes_the_stencil_route():
    u, v, h, values, spec = oversize_particles(3, 50, periodic=False, margin=20.0)
    launches = W.deposit_wide.launches
    got = W.deposit_wide(u, v, h, values, spec, kernel="wendland_c2", projection="kernel3d",
                         out=torch.ones(3, NY, NX))
    ref = W.deposit_wide_plain(u, v, h, values, spec, kernel="wendland_c2", projection="kernel3d",
                               out=torch.ones(3, NY, NX))
    assert torch.equal(got, ref) and W.deposit_wide.launches == launches
    with pytest.raises(ValueError, match="no oversize-route kernel"):
        W.deposit_wide(*(a.to("meta") for a in (u, v, h, values)), spec, kernel="wendland_c2",
                       projection="kernel3d", out=torch.zeros(3, NY, NX, device="meta"))
    with pytest.raises(ValueError, match="cannot hold the lists of one particle"):
        W.deposit_wide_tiled(u, v, h, values, spec, kernel="wendland_c2", projection="kernel3d",
                             out=torch.zeros(3, NY, NX), scratch_bytes=100, plain=True)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the oversize-route kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["open-kernel3d-wendland_c2-F3", "periodic-integrated-cubic_spline-F7",
                                  "periodic-wider-than-map", "open-off-map", "open-two-batches"])
def test_cuda_kernels_match_plain(cuda_device, case):
    opts = dict(CASES[case])
    projection = opts.pop("projection", "kernel3d")
    scratch = opts.pop("scratch_bytes", W.SCRATCH_BYTES)
    kernel = opts.get("kernel", "wendland_c2")
    u, v, h, values, spec = oversize_particles(5, 400, device=cuda_device, **opts)
    F = values.shape[0]
    kw = dict(kernel=kernel, projection=projection)
    ref = W.deposit_wide_plain(u, v, h, values, spec, out=torch.zeros(F, NY, NX, device=cuda_device), **kw)
    runs = []
    for _ in range(2):
        out = torch.zeros(F, NY, NX, device=cuda_device)
        W.deposit_wide_tiled(u, v, h, values, spec, out=out, scratch_bytes=scratch, **kw)
        torch.cuda.synchronize()
        runs.append(out)
    assert torch.equal(runs[0], runs[1]), "no atomics: the same sums every run"
    assert rel_err(runs[0], ref) <= 1e-5
    psy, psx = spec.pixel_size
    geo, _, lim2 = W.particle_geometry(u, v, h, psx=psx, psy=psy, **kw)
    counts = W._bin_counts(geo, lim2, spec, plain=False)
    starts = torch.nn.functional.pad(torch.cumsum(counts, 0, dtype=torch.int64), (1, 0))
    lists = W._bin_lists(geo, lim2, spec, starts, int(starts[-1]), plain=False)
    assert torch.equal(counts, W.tile_counts_plain(geo, lim2, spec))
    assert torch.equal(lists, W.tile_lists_plain(geo, lim2, spec))


@pytest.mark.cuda
def test_cuda_oversize_span_counts_launches_and_tile_pairs(cuda_device):
    u, v, h, values, spec = oversize_particles(9, 300, periodic=False, device=cuda_device)
    psy, psx = spec.pixel_size
    x0, _, y0, _ = spec.extent
    x, y = u.double() * psx + x0, v.double() * psy + y0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        got = deposit_2d_auto(x, y, h, values, spec, kernel="wendland_c2", device=cuda_device)
        torch.cuda.synchronize()
    over = [s["counts"] for s in spans() if s["name"] == "deposit.oversize"]
    assert len(over) == 1 and over[0]["particles"] > 0
    assert over[0]["launches"] == 3  # one batch: count, fill, deposit
    tp = tile_particles(x, y, h, values, spec, kernel="wendland_c2", device=cuda_device)
    sl = slice(tp.n_sorted - tp.n_oversize, tp.n_sorted)
    geo, _, lim2 = W.particle_geometry(tp.sorted_u[sl], tp.sorted_v[sl], tp.sorted_h[sl], kernel="wendland_c2",
                                       projection="kernel3d", psx=psx, psy=psy)
    assert over[0]["particles"] == tp.n_oversize
    assert over[0]["tile_pairs"] == int(W.tile_counts_plain(geo, lim2, spec).sum())
    ref = deposit_2d_auto(x, y, h, values, spec, kernel="wendland_c2", device=cuda_device, plain=True)
    assert rel_err(got, ref) <= 1e-5


@pytest.mark.cuda
def test_cuda_halo_render_counts_its_oversize_launches_in_the_registry(cuda_device):
    """A halo cutout much finer than its particles' h sends them over the
    oversize route, whose launches ``ops.kernel_counters()`` counts."""
    from astro_sph_tools_tpu_torch import render_halo_maps
    from astro_sph_tools_tpu_torch.io.catalogue import BasicHaloDefinitions
    from astro_sph_tools_tpu_torch.io.memory import MemoryCatalogue, MemorySnapshot
    from astro_sph_tools_tpu_torch.ops import kernel_counters

    rng = np.random.default_rng(4)
    n, box = 3000, 10.0
    snap = MemorySnapshot({
        "positions": torch.tensor(rng.uniform(4.0, 6.0, (n, 3)), dtype=torch.float32, device=cuda_device),
        "smoothing_lengths": torch.tensor(rng.uniform(0.3, 0.6, n), dtype=torch.float32, device=cuda_device),
        "masses": torch.ones(n, device=cuda_device),
    }, box)
    cat = MemoryCatalogue(snap, np.array([[5.0, 5.0, 5.0]]), {BasicHaloDefinitions.SO_200_CRIT.value: np.array([0.5])})
    wide = kernel_counters()["deposit_wide"]
    launches = wide.launches
    (stack,) = render_halo_maps(snap, cat, [0], resolution=128, device=cuda_device)
    assert wide.launches >= launches + 3  # count, fill, deposit
    assert stack["surface_density"].max() > 0
