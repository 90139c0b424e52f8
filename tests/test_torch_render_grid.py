"""``render_grid_stack`` (``render.py``) against the plain float64 reference
``reference_grid.py``, on the CPU; the 3D oversize route's tile lists and
its kernel's walk (``grid3d_wide.walk_plain``) against brute force; on the
card, the route's kernel (``csrc/deposit3d_wide.cu``) against the plain
stencil engine and a float64 nearest-image sum, and its walk counters.

The inputs are seeded random particles whose supports fill every footprint
level of the 3D layout (K = 4, 8, 16), the oversize route past K = 16
(support radius s > 7 voxels) and, past s = 15, the plain engine's dense
pass. Tolerance: 5e-5 of each cube's largest value (the mean cube: its
summed gap weighted by the density). The render works in float32
(positions, h and payloads as given, voxel coordinates, the kernel, the
sums), and float32 voxel coordinates at 32-56 voxels carry up to ~4e-6
voxel of rounding: in the narrowest supports (radius 0.3 voxel, h = 0.15
voxel), whose peaks are the cubes' largest values, that moves q = r / h by
up to ~5e-5 and the kernel by up to ~5e-5 of the peak (3.2e-5 seen).
"""

import numpy as np
import pytest
import torch

import reference_grid
from astro_sph_tools_tpu_torch import render_grid_stack
from astro_sph_tools_tpu_torch.io.memory import MemorySnapshot
from astro_sph_tools_tpu_torch.kernels.splines import get_kernel
from astro_sph_tools_tpu_torch.ops import grid3d_wide as W
from astro_sph_tools_tpu_torch.ops.grid3d import GridSpec
from astro_sph_tools_tpu_torch.ops.grid3d_tiled import tile_particles_3d

BOX = 8.0
N = 1 << 13
TOL = 5e-5
Tensor = torch.Tensor
CASES = {"periodic-48": (True, 48, None), "open-56": (False, 56, (0.5, 7.0, 1.0, 7.5, 0.0, 6.0))}


def particles(seed: int, res: int, n: int = N, s_range=(0.3, 3.0), wide: float = 0.06) -> dict:
    """Particles in the box with support radii (voxels of a ``res`` grid of
    the box) log-uniform over ``s_range`` and, for a share ``wide`` of them,
    over 3-22 voxels (K = 8 and 16, the oversize route, the dense pass)."""
    rng = np.random.default_rng(seed)
    s = np.exp(rng.uniform(*np.log(s_range), n))
    k = int(wide * n)
    s[:k] = np.exp(rng.uniform(np.log(3.0), np.log(22.0), k))
    voxel = BOX / res
    return {
        "positions": torch.tensor(rng.uniform(0.0, BOX, (n, 3)), dtype=torch.float32),
        "smoothing_lengths": torch.tensor(s * voxel / 2.0, dtype=torch.float32),
        "masses": torch.tensor(rng.uniform(0.5, 2.0, n), dtype=torch.float32),
        "temperatures": torch.tensor(rng.uniform(1e4, 1e6, n), dtype=torch.float32),
    }


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_cubes_match_the_reference(case):
    periodic, res, extent = CASES[case]
    fields = particles(7, res)
    stack = render_grid_stack(MemorySnapshot(fields, BOX), ("density", "temperature"), resolution=res, extent=extent,
                              periodic=periodic, kernel="wendland_c2", device="cpu")
    ext = extent or (0.0, BOX) * 3
    tp = tile_particles_3d(fields["positions"], fields["smoothing_lengths"], fields["masses"],
                           GridSpec((res,) * 3, ext, periodic_wrap=periodic), kernel="wendland_c2", device="cpu")
    assert [g.cfg.K for g, _, _ in tp.geoms] == [4, 8, 16] and tp.n_oversize > 0
    s = 2.0 * fields["smoothing_lengths"] * res / BOX
    assert int((s > 15).sum()) > 0  # the plain engine's dense pass on the CPU
    ref = reference_grid.grid_stack(fields, (res,) * 3, ext, kernel="wendland_c2", periodic=periodic)
    assert set(stack.maps) == set(ref)
    for name, cube in stack.maps.items():
        assert cube.shape == (res,) * 3 and cube.dtype == np.float32
        if name.startswith("mean_"):  # a ratio, weighted by the density as the benchmark weighs it
            rho, want = ref["density"].numpy(), ref[name].numpy()
            assert (rho * np.abs(cube - want)).sum() / (rho * np.abs(want)).sum() <= TOL, name
        else:
            assert rel_err(cube, ref[name]) <= TOL, name


def test_mass_is_conserved_on_a_periodic_grid():
    """With every support at least 2 voxels in radius, the density cube's
    voxel sum times the voxel volume is the particles' mass: the midpoint
    rule of a C2 kernel on a lattice at 2 or more voxels a support radius
    is within 1e-3 of its integral, and the periodic grid loses nothing at
    the edges."""
    res = 32
    fields = particles(11, res, n=4096, s_range=(2.0, 6.0), wide=0.05)
    stack = render_grid_stack(MemorySnapshot(fields, BOX), ("density",), resolution=res, kernel="wendland_c2",
                              device="cpu")
    total = float(stack["density"].astype(np.float64).sum()) * (BOX / res) ** 3
    assert abs(total / float(fields["masses"].double().sum()) - 1.0) < 1e-3


def test_mean_temperature_is_zero_where_the_density_is():
    fields = particles(13, 32, n=2048, s_range=(0.3, 2.0), wide=0.0)
    fields["positions"][:, 0] = 0.3 * fields["positions"][:, 0]  # the particles fill a third of the box in x
    stack = render_grid_stack(MemorySnapshot(fields, BOX), ("density", "temperature"), resolution=32,
                              periodic=False, extent=(0.0, BOX) * 3, kernel="wendland_c2", device="cpu")
    empty = stack["density"] == 0
    assert empty.mean() > 0.5
    assert (stack["mean_temperature"][empty] == 0).all()
    assert (stack["mean_temperature"][~empty] > 0).all()


def test_velocity_los_has_no_line_of_sight_in_a_cube():
    fields = particles(17, 16, n=64)
    with pytest.raises(ValueError, match="velocity_los"):
        render_grid_stack(MemorySnapshot(fields, BOX), ("velocity_los",), resolution=16, device="cpu")


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the 3D oversize-route kernel has no CPU mode")
    return torch.device("cuda")


def oversize(seed: int, n: int, shape, *, periodic: bool, n_fields: int, s_max: float, margin: float, device):
    """(u, v, w, h, values, spec): global voxel coordinates, supports of
    7-``s_max`` voxels, centres ``margin`` voxels beyond an open grid at
    most."""
    rng = np.random.default_rng(seed)
    spec = GridSpec(shape=shape, extent=(-1.0, 1.4, 0.5, 2.3, 0.0, 2.0), periodic_wrap=periodic)
    dz, dy, dx = spec.voxel_size
    m = 0.0 if periodic else margin
    nz, ny, nx = shape
    uvw = [rng.uniform(-m, k + m, n) for k in (nx, ny, nz)]
    h = rng.uniform(7.0, s_max, n) * min(dx, dy, dz) / 2.0
    values = rng.uniform(0.5, 2.0, (n_fields, n))
    t = [torch.as_tensor(a, dtype=torch.float32, device=device).contiguous() for a in (*uvw, h, values)]
    return (*t, spec)


CARD = {
    "periodic-F2": dict(periodic=True, n_fields=2, s_max=20.0, margin=0.0),
    "open-F4-off-grid": dict(periodic=False, n_fields=4, s_max=20.0, margin=12.0),
    "periodic-wider-than-grid-F1": dict(periodic=True, n_fields=1, s_max=40.0, margin=0.0),
    "open-F3": dict(periodic=False, n_fields=3, s_max=16.0, margin=0.0),
}


@pytest.mark.parametrize("case", sorted(CARD))
def test_the_lists_in_batches_are_the_lists_in_one(case, monkeypatch):
    """Past ``SCRATCH_BYTES`` the binning goes in batches of consecutive
    particles, each within the cap but for its last particle's entries;
    their lists, indices taken back to the whole segment and joined in
    batch order, are the one batch's lists tile by tile. A particle lost or
    listed twice at a batch's edge would drop or double its support."""
    u, v, w, h, values, spec = oversize(5, 150, (40, 36, 48), device="cpu", **CARD[case])
    ((_, _, starts, lists),) = W.tile_lists(u, v, w, h, spec, kernel="wendland_c2")
    n_tiles = starts.shape[0] - 1
    want = [lists[starts[t]:starts[t + 1]].tolist() for t in range(n_tiles)]
    cap = 600
    monkeypatch.setattr(W, "SCRATCH_BYTES", W._ENTRY_BYTES * cap)
    batches = list(W.tile_lists(u, v, w, h, spec, kernel="wendland_c2"))
    assert len(batches) > 1
    assert all(a[1] <= b[0] for a, b in zip(batches, batches[1:]))
    got = [[] for _ in range(n_tiles)]
    for p0, p1, b_starts, b_lists in batches:
        assert b_lists.shape[0] <= cap + max(len(x) for x in want)
        for t in range(n_tiles):
            got[t] += (b_lists[b_starts[t]:b_starts[t + 1]] + p0).tolist()
    assert got == want


def test_the_tile_lists_hold_every_tile_a_support_meets():
    """Each particle is listed in exactly the tiles of its support's
    bounding box (wrapped on a periodic grid: radii up to 20 voxels wrap
    back into their first tile on the 36- and 40-voxel axes), each tile's
    list in particle order: against a brute-force overlap in float64."""
    u, v, w, h, values, spec = oversize(9, 80, (40, 36, 48), device="cpu", periodic=True, n_fields=1, s_max=20.0,
                                        margin=0.0)
    ((p0, p1, starts, lists),) = W.tile_lists(u, v, w, h, spec, kernel="wendland_c2")
    ntx, nty, ntz = W.tile_grid(spec)
    want = [[] for _ in range(ntx * nty * ntz)]
    for i in range(u.shape[0]):
        axes = []
        for c, d, n in ((u[i], spec.voxel_size[2], 48), (v[i], spec.voxel_size[1], 36), (w[i], spec.voxel_size[0], 40)):
            r = 2.0 * float(h[i]) / d
            ks = np.arange(np.ceil(float(c) - 0.5 - r - W.SLACK), np.floor(float(c) - 0.5 + r + W.SLACK) + 1)
            axes.append(sorted({int(k) % n // W.TILE for k in ks}))
        for tz in axes[2]:
            for ty in axes[1]:
                for tx in axes[0]:
                    want[(tz * nty + ty) * ntx + tx].append(i)
    got = [lists[starts[t]:starts[t + 1]].tolist() for t in range(len(want))]
    assert got == want


def one_column(device) -> tuple:
    """(u, v, w, h, values, spec): one particle of support radius 8
    voxels on a periodic 48^3 grid whose disk meets, of tile (1, 1, 1)'s
    patch (16..23, 16..19), the column (19, 16) alone (the particle lies
    7.97 voxels below it along y; its neighbours in x lie sqrt(1 + 7.97^2)
    > 8 voxels off); ``ONE_COLUMN`` names that tile and column."""
    spec = GridSpec(shape=(48, 48, 48), extent=(0.0, 4.8) * 3, periodic_wrap=True)
    t = [torch.tensor([c], dtype=torch.float32, device=device) for c in (19.5, 16.5 - 7.97, 24.3, 0.4)]
    return (*t, torch.ones(1, 1, device=device), spec)


ONE_COLUMN = {"tile": (1 * 3 + 1) * 3 + 1, "column": (19, 16)}


def walk_case(case: str):
    """(u, v, w, h, spec) of a walk case: random supports of 7-16 voxels
    (``oversize``), on grids that are not multiples of 16."""
    if case == "one-column":
        u, v, w, h, _, spec = one_column("cpu")
        return u, v, w, h, spec
    shape, periodic, margin = WALKS[case]
    u, v, w, h, _, spec = oversize(3, 12, shape, device="cpu", periodic=periodic, n_fields=1, s_max=16.0,
                                   margin=margin)
    if case == "periodic-across-the-edge":  # centres within 2 voxels of each axis's periodic edge
        u, v, w = (torch.remainder(torch.where(c < n / 2, c, c - n) * (2.0 / (n / 2)), n)
                   for c, n in ((u, shape[2]), (v, shape[1]), (w, shape[0])))
    return u, v, w, h, spec


WALKS = {  # shape (nz, ny, nx), periodic, centres' margin beyond an open grid (voxels)
    "periodic-ragged": ((116, 36, 44), True, 0.0),
    "open-ragged": ((36, 44, 40), False, 6.0),
    "periodic-across-the-edge": ((72, 40, 52), True, 0.0),
    "periodic-two-images-a-tile": ((12, 20, 24), True, 0.0),
    "one-column": None,
}


def supports_in_tile(u, v, w, h, spec, tile: int, *, scale: float) -> set:
    """(particle, x, y, z) of every voxel of ``tile`` with q^2 < scale *
    lim^2, in float64, each axis at the particle's nearest image."""
    nz, ny, nx = spec.shape
    ntx, nty, _ = W.tile_grid(spec)
    tz, rem = divmod(tile, ntx * nty)
    ty, tx = divmod(rem, ntx)
    axes = [np.arange(t * W.TILE, min(n, (t + 1) * W.TILE)) for t, n in ((tx, nx), (ty, ny), (tz, nz))]
    dz, dy, dx = spec.voxel_size
    out = set()
    for i in range(u.shape[0]):
        d = []
        for k, c, n, size, per in zip(axes, (u, v, w), (nx, ny, nz), (dx, dy, dz),
                                      W._per_axis(spec.periodic_wrap)):
            off = k + spec.sample_offset - float(c[i])
            d.append((off - n * np.round(off / n) if per else off) * size / float(h[i]))
        q2 = d[2][:, None, None] ** 2 + d[1][None, :, None] ** 2 + d[0][None, None, :] ** 2
        for a, b, c in np.argwhere(q2 < scale * 4.0):  # Wendland C2: support 2 h
            out.add((i, int(axes[0][c]), int(axes[1][b]), int(axes[2][a])))
    return out


@pytest.mark.parametrize("case", sorted(WALKS))
def test_the_flattened_walk_visits_each_voxel_inside_a_support_once(case):
    """``walk_plain``, the kernel's walk step for step (patch tests, each
    column's chord in the tile at the one image that can meet it, the
    flattened index's column and plane; the columns' own walks where two
    images can meet a tile), over every tile: no voxel twice for one
    entry, none off the tile or the grid, and the voxels that pass the
    exact test those of brute force, every voxel of the tile (float64
    q^2 < lim^2 within 1e-5 of lim^2: the walk's f32 test decides the
    borderline ones). The counters: the voxels inside, 32 lanes a step."""
    u, v, w, h, spec = walk_case(case)
    ntx, nty, ntz = W.tile_grid(spec)
    nz, ny, nx = spec.shape
    lanes = pairs = 0
    for tile in range(ntx * nty * ntz):
        r = W.walk_plain(u, v, w, h, spec, tile, kernel="wendland_c2")
        keys = [tuple(k) for k in torch.cat([r["entry"][:, None], r["voxels"]], dim=1).tolist()]
        assert len(set(keys)) == len(keys), f"tile {tile}: a voxel visited twice for one entry"
        tz, rem = divmod(tile, ntx * nty)
        ty, tx = divmod(rem, ntx)
        for _, x, y, z in keys:
            assert tx * 16 <= x < min(nx, tx * 16 + 16) and ty * 16 <= y < min(ny, ty * 16 + 16)
            assert tz * 16 <= z < min(nz, tz * 16 + 16)
        got = {k for k, inside in zip(keys, r["inside"].tolist()) if inside}
        assert supports_in_tile(u, v, w, h, spec, tile, scale=1 - 1e-5) <= got, f"tile {tile}: a voxel missed"
        assert got <= supports_in_tile(u, v, w, h, spec, tile, scale=1 + 1e-5), f"tile {tile}: a voxel outside"
        assert r["pairs"] == len(got) and r["lanes"] % 32 == 0 and r["lanes"] >= r["pairs"]
        lanes, pairs = lanes + r["lanes"], pairs + r["pairs"]
        if case == "one-column" and tile == ONE_COLUMN["tile"]:
            patch = {(x, y) for _, x, y, _ in got if 16 <= x < 24 and 16 <= y < 20}
            assert patch == {ONE_COLUMN["column"]}
    assert pairs > 0


def test_the_flattened_walk_keeps_its_lanes_busy():
    """At supports of 7-15.4 voxels on a grid deep enough for one image a
    tile (2 half + 16 < nz), the walk's voxels inside over its lane steps
    (the kernel's ``walk_pairs / walk_lanes``) is ~0.89; a thread a column
    walking its own chord, the warp at its longest, kept ~0.45."""
    u, v, w, h, _, spec = oversize(11, 24, (64, 64, 64), device="cpu", periodic=True, n_fields=1, s_max=15.4,
                                   margin=0.0)
    runs = [W.walk_plain(u, v, w, h, spec, tile, kernel="wendland_c2") for tile in range(64)]
    assert sum(r["pairs"] for r in runs) / sum(r["lanes"] for r in runs) >= 0.8


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD))
def test_cuda_route_matches_the_plain_engine(cuda_device, case, monkeypatch):
    """The kernel against the plain stencil engine on the same particles,
    1e-5 of the max (both float32; the kernel's root by the reciprocal
    root, a few ulp); two runs bit for bit (no atomics); the binning in
    several batches gives the same cube."""
    u, v, w, h, values, spec = oversize(5, 600, (40, 36, 48), device=cuda_device, **CARD[case])
    F = values.shape[0]
    ref = W.deposit_3d_wide_plain(u, v, w, h, values, spec, kernel="wendland_c2",
                                  out=torch.zeros(F, *spec.shape, device=cuda_device))

    def no_plain(*a, **k):
        raise AssertionError("the plain engine ran on the card")

    monkeypatch.setattr(W, "deposit_3d", no_plain)
    runs = []
    launches = W.deposit_3d_wide.launches
    for _ in range(2):
        out = torch.zeros(F, *spec.shape, device=cuda_device)
        W.deposit_3d_wide(u, v, w, h, values, spec, kernel="wendland_c2", out=out)
        torch.cuda.synchronize()
        runs.append(out)
    assert W.deposit_3d_wide.launches == launches + 2
    assert torch.equal(runs[0], runs[1]), "no atomics: the same sums every run"
    assert rel_err(runs[0].cpu(), ref.cpu()) <= 1e-5
    monkeypatch.setattr(W, "SCRATCH_BYTES", W._ENTRY_BYTES * 1000)
    batched = torch.zeros(F, *spec.shape, device=cuda_device)
    launches = W.deposit_3d_wide.launches
    W.deposit_3d_wide(u, v, w, h, values, spec, kernel="wendland_c2", out=batched)
    assert W.deposit_3d_wide.launches > launches + 1, "one launch a batch"
    assert rel_err(batched.cpu(), ref.cpu()) <= 1e-5


def no_plain(*a, **k):
    raise AssertionError("the plain engine ran on the card")


def nearest_image_cube(u, v, w, h, values, spec) -> Tensor:
    """The route's contract in float64, every voxel against every particle:
    sum_i val_f(i) W(r, h_i), r taken per axis at the particle's nearest
    image on a periodic axis (as the dense pass takes it), Wendland C2."""
    kspec = get_kernel("wendland_c2")
    nz, ny, nx = spec.shape
    dz, dy, dx = spec.voxel_size
    d2 = 0.0
    for a, (n, c, size, per) in enumerate(zip((nx, ny, nz), (u, v, w), (dx, dy, dz),
                                              W._per_axis(spec.periodic_wrap))):
        off = torch.arange(n, dtype=torch.float64, device=u.device)[None, :] + spec.sample_offset - c.double()[:, None]
        off = off - n * torch.round(off / n) if per else off
        view = [-1, 1, 1, 1]
        view[3 - a] = n
        d2 = d2 + ((off * size) ** 2).view(view)
    hd = h.double().view(-1, 1, 1, 1)
    wgt = torch.where(d2 < (kspec.support_factor * hd) ** 2, kspec.w(torch.sqrt(d2), hd), 0.0)
    return torch.einsum("fn,nzyx->fzyx", values.double(), wgt)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["two-images-a-tile", "one-column"])
def test_cuda_route_on_its_edge_cases(cuda_device, case, monkeypatch):
    """The kernel against the route's contract in float64, 1e-5 of the max,
    two runs bit for bit: on a periodic 12 x 20 x 24 grid, where two images
    of a support can meet one tile and chords cover the whole axis (2 half
    >= nz), so each lane walks its own column (the plain stencil engine's
    windows, wrapped on axes shorter than them, add further images there);
    and on a list that meets one column of one patch."""
    if case == "one-column":
        u, v, w, h, values, spec = one_column(cuda_device)
    else:
        u, v, w, h, values, spec = oversize(13, 300, (12, 20, 24), device=cuda_device, periodic=True,
                                            n_fields=2, s_max=16.0, margin=0.0)
    F = values.shape[0]
    ref = nearest_image_cube(u, v, w, h, values, spec)
    monkeypatch.setattr(W, "deposit_3d", no_plain)
    runs = [W.deposit_3d_wide(u, v, w, h, values, spec, kernel="wendland_c2",
                              out=torch.zeros(F, *spec.shape, device=cuda_device)) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    assert rel_err(runs[0].cpu(), ref.cpu()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["periodic-ragged", "periodic-two-images-a-tile"])
def test_cuda_walk_counters_while_profiling(cuda_device, case, monkeypatch):
    """While a profiler runs, the span ``deposit3d.oversize`` takes the
    kernel's ``walk_lanes`` and ``walk_pairs``: those of ``walk_plain`` over
    every tile (within 1e-3: the card's fused multiply-adds and fast divide
    move a borderline chord end or test); without one, the wrapper passes
    the kernel no counters."""
    from astro_sph_tools_tpu_torch.utils.profiling import span, spans

    u, v, w, h, spec = walk_case(case)
    ntx, nty, ntz = W.tile_grid(spec)
    plain = [W.walk_plain(u, v, w, h, spec, t, kernel="wendland_c2") for t in range(ntx * nty * ntz)]
    args = [a.to(cuda_device) for a in (u, v, w, h)] + [torch.ones(1, u.shape[0], device=cuda_device)]
    passed = []
    deposit = W._deposit
    monkeypatch.setattr(W, "_deposit", lambda *a, stats=None, **k: passed.append(stats) or deposit(*a, stats=stats,
                                                                                                  **k))
    out = torch.zeros(1, *spec.shape, device=cuda_device)
    W.deposit_3d_wide(*args, spec, kernel="wendland_c2", out=out)
    assert passed and all(s is None for s in passed)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("deposit3d.oversize"):
            W.deposit_3d_wide(*args, spec, kernel="wendland_c2", out=out)
        torch.cuda.synchronize()
    assert passed[-1] is not None
    (counts,) = [s["counts"] for s in spans() if s["name"] == "deposit3d.oversize"]
    lanes, pairs = sum(r["lanes"] for r in plain), sum(r["pairs"] for r in plain)
    assert counts["walk_lanes"] == pytest.approx(lanes, rel=1e-3)
    assert counts["walk_pairs"] == pytest.approx(pairs, rel=1e-3)
    assert 0 < counts["walk_pairs"] <= counts["walk_lanes"]


@pytest.mark.cuda
def test_cuda_render_takes_no_plain_route(cuda_device, monkeypatch):
    """``render_grid_stack`` on the card sends every particle past K = 16 to
    the route's kernel, none to the stencil engine, and matches the
    reference as the CPU render does."""
    fields = particles(7, 48)

    def no_plain(*a, **k):
        raise AssertionError("the plain engine ran on the card")

    monkeypatch.setattr(W, "deposit_3d", no_plain)
    launches = W.deposit_3d_wide.launches
    snap = MemorySnapshot({k: t.to(cuda_device) for k, t in fields.items()}, BOX)
    got = render_grid_stack(snap, ("density", "temperature"), resolution=48, kernel="wendland_c2", device=cuda_device)
    assert W.deposit_3d_wide.launches > launches
    ref = reference_grid.grid_stack(fields, (48,) * 3, (0.0, BOX) * 3, kernel="wendland_c2", periodic=True)
    for name in ("density", "mass_weighted_temperature"):
        assert rel_err(got[name], ref[name]) <= TOL, name


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1000, (1 << 24) + 12345])
def test_cuda_copy_back_gives_arrays_of_their_own(cuda_device, n):
    """``render._to_host``: the array ``.cpu()`` gives, bit for bit, in
    memory of its own while the last one is held, and again from memory
    that a dropped array freed."""
    from astro_sph_tools_tpu_torch.render import _to_host

    t = torch.randn(n, device=cuda_device).reshape(-1, 1) * 3.0
    a, b = _to_host(t, pinned=True), _to_host(t, pinned=True)
    assert a.shape == (n, 1) and a.dtype == np.float32
    assert np.array_equal(a, t.cpu().numpy()) and np.array_equal(b, a)
    assert n == 0 or not np.shares_memory(a, b)
    del b
    t.mul_(-1.0)
    c = _to_host(t, pinned=True)
    assert np.array_equal(c, t.cpu().numpy()) and np.array_equal(a, -c)
