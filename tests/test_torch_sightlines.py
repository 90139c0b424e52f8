"""Port vs JAX: sightline columns (dense, binned, fused) and LOS profiles.

The same seeded NumPy particles and rays go through the JAX package's
engines (``ops/sightlines.py``, XLA on the CPU) and the port's
(``astro_sph_tools_tpu_torch.ops``), the fused engine through its plain
kernel version on the CPU. Tolerances: 1e-5 of the maximum for the f32
engine-to-engine comparisons of one formulation (dense, binned, profiles),
twice that for the fused engine (Clenshaw weights and the level/cell
schedule vs the XLA engines' table lookup). The case list mirrors
``tests/test_sightlines_pallas.py``; the comparison with the interpret-mode
Pallas engine itself is in the slow lane, and the CUDA kernel against its
plain version needs a card. The column kernel's per-ray candidate spans
(``ray_spans``, which ``csrc/sightlines.cu::row_spans`` mirrors) are
brute-force tested: every particle whose support reaches a ray lies in
that ray's spans exactly once.
"""

import numpy as np
import pytest
import torch

from astro_sph_tools_tpu.ops.sightlines import (
    column_integrate as j_column_integrate,
    column_integrate_binned as j_column_integrate_binned,
    los_profiles as j_los_profiles,
)
from astro_sph_tools_tpu_torch.ops import (
    column_integrate,
    column_integrate_binned,
    column_integrate_pallas,
    los_profiles,
)
import astro_sph_tools_tpu_torch.ops.sightlines_fused as SF

TOL = 1e-5  # one formulation, f32 on both sides
FUSED_TOL = 2e-5  # whole-engine f32 runs of two formulations


def _data(n=20000, rays=300, box=10.0, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, box, n)
    y = rng.uniform(0, box, n)
    h = np.exp(rng.normal(np.log(0.08), 0.7, n)).clip(0.01, 1.5)
    v = rng.uniform(0.5, 2.0, (n, 3)).astype(np.float32)
    rx = rng.uniform(0, box, rays)
    ry = rng.uniform(0, box, rays)
    return x, y, h, v, rx, ry, box


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _fused(*args, **kw):
    return column_integrate_pallas(*args, device="cpu", **kw).numpy()


def level_counts(lay):
    """Particles of each level of a column layout (a host read, for tests)."""
    b = lay.bounds.numpy()
    return np.array([int(b[off + ncx * ncy]) - int(b[off]) for ncx, ncy, off in lay.grids])


@pytest.fixture(scope="module")
def data():
    return _data()


@pytest.mark.parametrize("projection", ["integrated", "kernel3d"])
@pytest.mark.parametrize("periodic", [True, False])
def test_dense_matches_jax(data, projection, periodic):
    x, y, h, v, rx, ry, box = data
    pb = box if periodic else None
    ref = j_column_integrate(x, y, h, v, rx, ry, projection=projection, periodic_box=pb)
    got = column_integrate(x, y, h, v, rx, ry, projection=projection, periodic_box=pb, device="cpu")
    assert tuple(got.shape) == (3, 300)
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("projection", ["integrated", "kernel3d"])
@pytest.mark.parametrize("periodic", [True, False])
def test_fused_matches_jax_dense(data, projection, periodic):
    x, y, h, v, rx, ry, box = data
    pb = box if periodic else None
    ref = j_column_integrate(x, y, h, v, rx, ry, projection=projection, periodic_box=pb)
    got = _fused(x, y, h, v, rx, ry, projection=projection, periodic_box=pb)
    assert got.shape == (3, 300)
    assert _rel(got, ref) <= FUSED_TOL


@pytest.mark.parametrize("projection", ["integrated", "kernel3d"])
@pytest.mark.parametrize("periodic", [True, False])
def test_binned_matches_jax_binned(data, projection, periodic):
    x, y, h, v, rx, ry, box = data
    pb = box if periodic else None
    ref = j_column_integrate_binned(x, y, h, v, rx, ry, projection=projection, periodic_box=pb)
    got = column_integrate_binned(x, y, h, v, rx, ry, projection=projection, periodic_box=pb, device="cpu")
    assert _rel(got, ref) <= TOL


def test_single_field_and_clustered(data):
    x, y, h, v, rx, ry, box = data
    rng = np.random.default_rng(3)
    n = x.shape[0]
    xc = np.concatenate([rng.normal(5, 0.3, n // 2) % box, x[n // 2:]])
    yc = np.concatenate([rng.normal(2, 0.3, n // 2) % box, y[n // 2:]])
    ref = j_column_integrate(xc, yc, h, v[:, 0], rx[:7], ry[:7], periodic_box=box)
    got = _fused(xc, yc, h, v[:, 0], rx[:7], ry[:7], periodic_box=box)
    assert got.shape == np.asarray(ref).shape == (7,)
    assert _rel(got, ref) <= FUSED_TOL


def test_uniform_h_single_level():
    x, y, h, v, rx, ry, box = _data(n=8000, rays=100)
    h2 = np.full_like(h, 0.02)
    lay, _, _ = SF._columns_layout(x, y, h2, v, rx, ry, kernel="cubic_spline", periodic_box=box, device="cpu")
    assert sum(level_counts(lay) > 0) == 1
    ref = j_column_integrate(x, y, h2, v, rx, ry, periodic_box=box)
    assert _rel(_fused(x, y, h2, v, rx, ry, periodic_box=box), ref) <= FUSED_TOL


@pytest.mark.parametrize("kernel", ["wendland_c2", "quintic_spline"])
def test_other_kernels(kernel):
    x, y, h, v, rx, ry, box = _data(n=8000, rays=100)
    for projection in ("integrated", "kernel3d"):
        ref = j_column_integrate(x, y, h, v, rx, ry, kernel=kernel, projection=projection, periodic_box=box)
        got = _fused(x, y, h, v, rx, ry, kernel=kernel, projection=projection, periodic_box=box)
        assert _rel(got, ref) <= FUSED_TOL


def test_coarse_grid_periodic_wrap_no_double_count():
    """Large supports force a tiny cell grid (ncy ~ 2-4): the periodic wrap
    spans must not re-add rows already inside the clamped main span."""
    rng = np.random.default_rng(5)
    n, box = 3000, 10.0
    x = rng.uniform(0, box, n)
    y = rng.uniform(0, box, n)
    h = rng.uniform(1.0, 1.6, n)  # supports ~ box/4
    v = rng.uniform(0.5, 2.0, n).astype(np.float32)
    rx = rng.uniform(0, box, 64)
    ry = rng.uniform(0, box, 64)
    ref = j_column_integrate(x, y, h, v, rx, ry, periodic_box=box)
    assert _rel(_fused(x, y, h, v, rx, ry, periodic_box=box), ref) <= FUSED_TOL
    got_b = column_integrate_binned(x, y, h, v, rx, ry, periodic_box=box, device="cpu")
    assert _rel(got_b, ref) <= TOL


def test_edge_rays_xwrap_spans():
    """Rays hugging the box edges exercise the x-window wrap spans of the
    cell-level schedule (narrow-block x-wrap units)."""
    rng = np.random.default_rng(3)
    box, n = 10.0, 20000
    x = rng.uniform(0, box, n)
    y = rng.uniform(0, box, n)
    h = np.exp(rng.normal(np.log(0.1), 0.6, n)).clip(0.02, 1.0)
    v = rng.uniform(0.5, 2.0, n).astype(np.float32)
    t = rng.uniform(0, box, 60)
    eps = 1e-3
    rx = np.concatenate([t, t, np.full(60, eps), np.full(60, box - eps), [eps, box - eps]])
    ry = np.concatenate([np.full(60, eps), np.full(60, box - eps), t, t, [eps, box - eps]])
    lay, _, _ = SF._columns_layout(x, y, h, v, rx, ry, kernel="cubic_spline", periodic_box=box, device="cpu")
    lo, hi = SF.ray_spans(lay.bounds, lay.rays, lay.grids, True)
    assert bool((hi[..., 1] > lo[..., 1]).any())  # x-wrap spans in use
    ref = j_column_integrate(x, y, h, v, rx, ry, periodic_box=box)
    assert _rel(_fused(x, y, h, v, rx, ry, periodic_box=box), ref) <= FUSED_TOL


def test_row_spanning_blocks_and_ragged_rays():
    """Ray count not a multiple of the block size, with rays so sparse that
    blocks span several cell rows (the wide-block spans)."""
    rng = np.random.default_rng(4)
    box, n = 25.0, 20000
    x = rng.uniform(0, box, n)
    y = rng.uniform(0, box, n)
    h = rng.uniform(1.0, 3.0, n)  # coarse grids -> few rays per row
    v = rng.uniform(0.5, 2.0, n).astype(np.float32)
    rx = rng.uniform(0, box, 41)
    ry = rng.uniform(0, box, 41)
    for pb in (box, None):
        ref = j_column_integrate(x, y, h, v, rx, ry, periodic_box=pb)
        assert _rel(_fused(x, y, h, v, rx, ry, periodic_box=pb), ref) <= FUSED_TOL


def test_rays_in_empty_regions_zero():
    """Ray blocks whose cells hold no particles come back exactly zero."""
    rng = np.random.default_rng(7)
    box, n = 20.0, 20000
    x = rng.uniform(0, box / 4, n)  # all particles in the left quarter
    y = rng.uniform(0, box, n)
    h = rng.uniform(0.05, 0.2, n)
    v = rng.uniform(0.5, 2.0, n).astype(np.float32)
    rx = rng.uniform(3 * box / 4, box - 1.0, 300)
    ry = rng.uniform(1.0, box - 1.0, 300)
    assert np.all(_fused(x, y, h, v, rx, ry, periodic_box=box) == 0.0)
    assert np.all(_fused(x, y, h, v, rx, ry) == 0.0)


def _span_counts(lay):
    """(n_rays, N) int64: how often each sorted particle lies in each ray's
    candidate spans, over every level and cell row."""
    lo, hi = SF.ray_spans(lay.bounds, lay.rays, lay.grids, lay.periodic)
    span_ray = lay.rays[0].to(torch.int64)[:, :, None, None].expand_as(lo).reshape(-1)
    span, idx = SF._span_entries(lo.reshape(-1, 1), hi.reshape(-1, 1))
    n = lay.packed.shape[1]
    return torch.bincount(span_ray[span] * n + idx, minlength=lay.n_rays * n).reshape(lay.n_rays, n)


def _within_support(lay, S, slack=1.0):
    """(n_rays, N) bool: sorted particle i's support (S h, times ``slack``)
    reaches ray r, in f64 with the periodic minimum image."""
    px, py, ph = (lay.packed[c].double() for c in range(3))
    dx = lay.rx.double()[:, None] - px[None, :]
    dy = lay.ry.double()[:, None] - py[None, :]
    if lay.periodic:
        dx = dx - torch.round(dx / lay.Lx) * lay.Lx
        dy = dy - torch.round(dy / lay.Ly) * lay.Ly
    return (dx * dx + dy * dy) < (slack * S * ph[None, :]) ** 2


def _grid_layout(grid, periodic, seed, n=1500):
    """A one-level column layout on an ncx x ncy grid of a 6 x 5 box: supports
    up to 0.999 of a cell (the slack the level assignment keeps), particles
    and rays on cell boundaries and box edges among random ones."""
    ncx, ncy = grid
    Lx, Ly = 6.0, 5.0
    cx, cy = Lx / ncx, Ly / ncy
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, Lx, n)
    y = rng.uniform(0, Ly, n)
    x[:ncx * 8] = np.repeat(np.arange(ncx) * cx, 8)  # on cell boundaries
    y[n - ncy * 8:] = np.repeat(np.arange(ncy) * cy, 8)
    h = rng.uniform(0.1, 0.999, n) * min(cx, cy) / 2.0  # cubic spline: support 2 h
    v = np.ones((n, 1))
    xs = [k * cx for k in range(ncx + 1)] + [1e-9, Lx - 1e-9]  # cell boundaries and box edges
    ys = [k * cy for k in range(ncy + 1)] + [1e-9, Ly - 1e-9]
    rx = np.concatenate([rng.uniform(0, Lx, 40), xs, rng.uniform(0, Lx, len(ys)), xs[:3], [Lx, 0.0]])
    ry = np.concatenate([rng.uniform(0, Ly, 40), rng.uniform(0, Ly, len(xs)), ys, ys[-3:], [Ly, Ly]])
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    rays = np.stack([rx, ry])
    if periodic:
        rays = np.mod(rays, [[Lx], [Ly]])
    packed, bounds = SF._sort_particles(f32(x), f32(y), f32(h), [f32(v[:, 0])], (grid,), 2.0,
                                        (0.0, 0.0, Lx, Ly), periodic)
    rxt, ryt, table, grids = SF._ray_table(rays, (grid,), 0.0, 0.0, Lx, Ly, "cpu")
    return SF.ColumnLayout(packed=packed, bounds=bounds, rx=rxt, ry=ryt, rays=table, grids=grids,
                           periodic=periodic, Lx=Lx, Ly=Ly)


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("grid", [(1, 1), (1, 2), (2, 1), (2, 2), (3, 3), (2, 3), (3, 5), (4, 4), (7, 2), (8, 8)])
def test_ray_spans_hold_each_support_once(grid, periodic):
    """Brute force of the per-ray span builder on grids of 1, 2, 3 and more
    cells an axis: every particle whose support reaches a ray lies in that
    ray's spans, and no particle lies in them twice (a coarse periodic grid
    takes each row and column once)."""
    lay = _grid_layout(grid, periodic, seed=sum(grid) + 10 * periodic)
    counts = _span_counts(lay)
    assert int(counts.max()) == 1
    reach = _within_support(lay, 2.0)
    assert bool(reach.any())
    assert bool((counts[reach] == 1).all())
    if grid[0] * grid[1] <= (9 if periodic else 1):  # the ring is the whole grid
        assert bool((counts == 1).all())


@pytest.mark.parametrize("periodic", [True, False])
def test_ray_spans_cover_supports_on_every_level(periodic):
    """The same brute force on a layout of every level: lognormal h, rays on
    the finest level's cell boundaries and at the box edges. Each particle
    belongs to one level, so it lies in a ray's spans at most once."""
    rng = np.random.default_rng(21 + periodic)
    box, n = 10.0, 6000
    x = rng.uniform(0, box, n)
    y = rng.uniform(0, box, n)
    h = np.exp(rng.normal(np.log(0.08), 1.0, n)).clip(0.005, 1.2)
    v = np.ones(n)
    t = rng.uniform(0, box, 30)
    grid = np.arange(0.0, box, box / 64)[1::7]
    rx = np.concatenate([t, grid, [0.0, 1e-9, box - 1e-9] * 2])
    ry = np.concatenate([grid[::-1] if len(grid) == 30 else rng.uniform(0, box, 30), t[:len(grid)],
                         [0.0, box - 1e-9, 1e-9, box - 1e-9, 0.0, 5.0]])
    lay, _, _ = SF._columns_layout(x, y, h, v, rx, ry, kernel="cubic_spline",
                                   periodic_box=box if periodic else None, device="cpu")
    assert sum(level_counts(lay) > 0) >= 4
    counts = _span_counts(lay)
    assert int(counts.max()) == 1
    reach = _within_support(lay, 2.0)
    assert bool((counts[reach] == 1).all())


def test_ray_table_cells_match_the_block_schedule():
    """The column layout's ray cells, taken in f64 by torch, are the cells
    the spectra's host schedule (``_stage_ray_levels``, NumPy) gives the same
    rays, rays on cell boundaries and box edges included, and each level's
    rays are in stable cell order."""
    rng = np.random.default_rng(12)
    box = 25.0
    grids = SF._choose_grids(box, box, 3.0)
    edges = np.arange(257) * (box / 256)
    rays = np.stack([np.concatenate([rng.uniform(0, box, 500), edges, [box - 1e-12]]),
                     np.concatenate([rng.uniform(0, box, 500), edges[::-1], [1e-12]])])
    rays = np.mod(rays, box)
    _, _, table, rows = SF._ray_table(rays, grids, 0.0, 0.0, box, box, "cpu")
    assert [r[:2] for r in rows] == list(grids)
    for l, (ncx, ncy) in enumerate(grids):
        rcx = np.clip(((rays[0] - 0.0) * (ncx / box)).astype(np.int64), 0, ncx - 1)
        rcy = np.clip(((rays[1] - 0.0) * (ncy / box)).astype(np.int64), 0, ncy - 1)
        order = np.argsort(rcy * ncx + rcx, kind="stable")
        assert np.array_equal(table[0, l].numpy(), order)
        assert np.array_equal(table[1, l].numpy(), (rcy * ncx + rcx)[order])


@pytest.mark.parametrize("projection", ["integrated", "kernel3d"])
@pytest.mark.parametrize("periodic", [True, False])
def test_fused_matches_jax_binned(data, projection, periodic):
    """The per-ray cell layout and the plain kernel version against the JAX
    binned engine (a different candidate grid)."""
    x, y, h, v, rx, ry, box = data
    pb = box if periodic else None
    ref = j_column_integrate_binned(x, y, h, v, rx, ry, projection=projection, periodic_box=pb)
    assert _rel(_fused(x, y, h, v, rx, ry, projection=projection, periodic_box=pb), ref) <= FUSED_TOL


def test_columns_path_reads_no_bounds_back(monkeypatch):
    """The columns path keeps the bounds table on its device: no host copy
    (``_prep``) and no block schedule (``_level_schedule``)."""
    def refuse(*args, **kw):
        raise AssertionError("the columns path took the spectra's block schedule")

    monkeypatch.setattr(SF, "_prep", refuse)
    monkeypatch.setattr(SF, "_level_schedule", refuse)
    x, y, h, v, rx, ry, box = _data(n=3000, rays=40)
    for pb in (box, None):
        ref = j_column_integrate(x, y, h, v, rx, ry, periodic_box=pb)
        assert _rel(_fused(x, y, h, v, rx, ry, periodic_box=pb), ref) <= FUSED_TOL


def test_zero_rays():
    x, y, h, v, _, _, box = _data(n=2000, rays=5)
    empty = np.array([], np.float64)
    assert _fused(x, y, h, v, empty, empty, periodic_box=box).shape == (3, 0)
    assert _fused(x, y, h, v[:, 0], empty, empty).shape == (0,)


def test_ray_batching_matches_single_pass(monkeypatch):
    """Ray sets above _RAY_BATCH run in batches; per-ray independence makes
    the batched result the single pass's."""
    x, y, h, v, rx, ry, box = _data(n=15000, rays=301)
    whole = _fused(x, y, h, v, rx, ry, periodic_box=box)
    monkeypatch.setattr(SF, "_RAY_BATCH", 100)
    batched = _fused(x, y, h, v, rx, ry, periodic_box=box)
    assert batched.shape == whole.shape
    np.testing.assert_allclose(batched, whole, rtol=0, atol=1e-6 * np.abs(whole).max())


def test_zero_h_particles_contribute_nothing():
    """h <= 0 particles add exactly nothing (no 1/h^3 overflow into NaN)."""
    x, y, h, v, rx, ry, box = _data(n=4000, rays=40)
    h0 = h.copy()
    h0[::7] = 0.0
    for projection in ("integrated", "kernel3d"):
        got = _fused(x, y, h0, v, rx, ry, projection=projection, periodic_box=box)
        keep = h0 > 0
        ref = _fused(x[keep], y[keep], h0[keep], v[keep], rx, ry, projection=projection, periodic_box=box)
        assert np.isfinite(got).all()
        assert _rel(got, ref) <= FUSED_TOL


@pytest.mark.parametrize("periodic", [True, False])
def test_los_profiles_matches_jax(periodic):
    rng = np.random.default_rng(11)
    n, box = 3000, 10.0
    pos = rng.uniform(0, box, (n, 3))
    h = rng.uniform(0.2, 0.6, n)
    vals = rng.uniform(0.5, 2.0, (n, 2)).astype(np.float32)
    rx = rng.uniform(0, box, 12)
    ry = rng.uniform(0, box, 12)
    kw = dict(z_range=(0.0, box), n_bins=64, periodic_box=box if periodic else None)
    ref = j_los_profiles(pos, h, vals, rx, ry, **kw)
    got = los_profiles(pos, h, vals, rx, ry, device="cpu", **kw)
    assert tuple(got.shape) == (2, 12, 64)
    assert _rel(got, ref) <= TOL
    got1 = los_profiles(pos, h, vals[:, 0], rx, ry, device="cpu", **kw)
    assert tuple(got1.shape) == (12, 64)


def test_wrapper_runs_plain_on_cpu_and_validates():
    """On a CPU tensor the kernel wrapper is its plain version and counts no
    launch; bad arguments raise."""
    x, y, h, v, rx, ry, box = _data(n=3000, rays=50)
    lay, F, _ = SF._columns_layout(x, y, h, v, rx, ry, kernel="cubic_spline", periodic_box=box, device="cpu")
    kw = dict(n_fields=F, kernel="cubic_spline", projection="integrated", periodic=True, Lx=lay.Lx, Ly=lay.Ly)
    args = (lay.packed, lay.bounds, lay.rx, lay.ry, lay.rays, lay.grids)
    before = SF.columns_tiles.launches
    got = SF.columns_tiles(*args, **kw)
    assert SF.columns_tiles.launches == before
    assert torch.equal(got, SF.columns_tiles_plain(*args, **kw))
    assert tuple(got.shape) == (F, 50)
    with pytest.raises(ValueError, match="projection"):
        SF.columns_tiles(*args, **{**kw, "projection": "bogus"})
    with pytest.raises(ValueError, match="fields"):
        SF.columns_tiles(*args, **{**kw, "n_fields": 6})
    with pytest.raises(ValueError, match="at most 5"):
        column_integrate_pallas(x, y, h, np.ones((3000, 6)), rx, ry, device="cpu")


def test_column_kernel_inputs_are_checked():
    """The checks the CUDA wrapper makes before a launch, with no host sync:
    a layout passes; grids whose offsets do not step through the bounds
    table, a bounds table of the wrong length and a ray table of the wrong
    shape raise."""
    x, y, h, v, rx, ry, box = _data(n=3000, rays=30)
    lay, F, _ = SF._columns_layout(x, y, h, v, rx, ry, kernel="cubic_spline", periodic_box=box, device="cpu")
    args = (lay.packed, lay.bounds, lay.rx, lay.ry, lay.rays, lay.grids, 3 + F)
    SF._check_columns(*args)
    shifted = tuple((ncx, ncy, off + 1) for ncx, ncy, off in lay.grids)
    with pytest.raises(ValueError, match="offset"):
        SF._check_columns(*args[:5], shifted, 3 + F)
    with pytest.raises(ValueError, match="bounds"):
        SF._check_columns(args[0], lay.bounds[:-1], *args[2:])
    with pytest.raises(ValueError, match="rays"):
        SF._check_columns(*args[:4], lay.rays[:, :, :-1].contiguous(), *args[5:])


@pytest.mark.slow
def test_fused_matches_jax_pallas_interpret():
    """The port's fused engine against the JAX fused engine itself
    (interpret-mode Pallas on the CPU)."""
    from astro_sph_tools_tpu.ops.sightlines_pallas import column_integrate_pallas as j_pallas

    x, y, h, v, rx, ry, box = _data(n=8000, rays=100)
    ref = j_pallas(x, y, h, v, rx, ry, periodic_box=box)
    assert _rel(_fused(x, y, h, v, rx, ry, periodic_box=box), ref) <= FUSED_TOL


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the sightline kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("projection", ["integrated", "kernel3d"])
@pytest.mark.parametrize("periodic", [True, False])
def test_cuda_columns_kernel_matches_plain(cuda_device, projection, periodic):
    x, y, h, v, rx, ry, box = _data()
    lay, F, _ = SF._columns_layout(
        x, y, h, v, rx, ry, kernel="cubic_spline", periodic_box=box if periodic else None, device=cuda_device,
    )
    kw = dict(n_fields=F, kernel="cubic_spline", projection=projection, periodic=lay.periodic, Lx=lay.Lx, Ly=lay.Ly)
    args = (lay.packed, lay.bounds, lay.rx, lay.ry, lay.rays, lay.grids)
    before = SF.columns_tiles.launches
    got = SF.columns_tiles(*args, **kw)
    again = SF.columns_tiles(*args, **kw)
    ref = SF.columns_tiles_plain(*args, **kw)
    torch.cuda.synchronize()
    assert SF.columns_tiles.launches == before + 2
    assert tuple(got.shape) == (F, rx.shape[0])
    assert torch.equal(got, again)  # a fixed order of sums: the same bits every run
    assert _rel(got.cpu(), ref.cpu()) <= TOL
    full = column_integrate_pallas(x, y, h, v, rx, ry, projection=projection,
                                   periodic_box=box if periodic else None, device=cuda_device)
    ref = j_column_integrate(x, y, h, v, rx, ry, projection=projection, periodic_box=box if periodic else None)
    assert _rel(full.cpu(), ref) <= FUSED_TOL
