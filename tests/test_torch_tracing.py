"""The port's spans and counters (``utils/profiling.py``) on the CPU, and
the benchmark's readers of them (``sphbench/metrics/``).

- Off: with no profiler running, ``span`` hands back one shared object and
  a render records nothing.
- Under ``torch.profiler``: each render (maps, haloes, cubes, sightlines) records its
  tree of spans, one ``product`` a call; the counters equal what the
  layouts report when built directly; every span's host interval holds its
  ``record_function`` event in the raw kineto events, the clock
  ``sphbench/devtrace.py`` reads, and a span stamped on another clock does
  not; the maps are bit for bit those rendered without the profiler.
- Each span metric's ``read`` on a fabricated span list.
"""

import importlib.util
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from astro_sph_tools_tpu_torch import render_grid_stack, render_halo_maps, render_map_stack, render_sightlines
from astro_sph_tools_tpu_torch.data_structures import ParticleType
from astro_sph_tools_tpu_torch.io.catalogue import BasicHaloDefinitions
from astro_sph_tools_tpu_torch.io.memory import MemoryCatalogue, MemorySnapshot
from astro_sph_tools_tpu_torch.ops.deposit import MapSpec
from astro_sph_tools_tpu_torch.ops.deposit_coherent import tile_particles_coherent
from astro_sph_tools_tpu_torch.ops.deposit_tiled import tile_particles
from astro_sph_tools_tpu_torch.ops.grid3d import GridSpec
from astro_sph_tools_tpu_torch.ops._device import tile_ranges
from astro_sph_tools_tpu_torch.ops.grid3d_tiled import (
    _candidate_tables,
    _region_candidates,
    _region_items,
    tile_particles_3d,
)
from astro_sph_tools_tpu_torch.utils import profiling
from astro_sph_tools_tpu_torch.utils.profiling import count, device_trace, span, spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOX = 10.0
N = 4096
FIELDS = ("density", "temperature")
RES = 64
HALO_RES = 128  # a 2 Mpc cutout in 128^2: h past 0.24 Mpc is oversize, past 0.49 takes the dense pass
GRID_RES = 24  # voxels of 0.42 Mpc: h past 1.46 Mpc is oversize


def _fields(seed: int, h_range: tuple) -> dict:
    rng = np.random.default_rng(seed)
    mass = rng.uniform(1.0, 2.0, N)
    return {
        "positions": torch.tensor(rng.uniform(0.0, BOX, (N, 3)), dtype=torch.float32),
        "smoothing_lengths": torch.tensor(rng.uniform(*h_range, N), dtype=torch.float32),
        "masses": torch.tensor(mass, dtype=torch.float32),
        "temperatures": torch.tensor(rng.uniform(1e4, 1e6, N), dtype=torch.float32),
        "metallicities": torch.tensor(rng.uniform(0.0, 0.04, N), dtype=torch.float32),
    }


@pytest.fixture(scope="module")
def box_snap():
    return MemorySnapshot(_fields(3, (0.02, 0.3)), BOX)


@pytest.fixture(scope="module")
def halo_inputs():
    snap = MemorySnapshot(_fields(5, (0.02, 0.8)), BOX)
    centres = np.array([[5.0, 5.0, 5.0], [2.0, 7.0, 5.0]])
    catalogue = MemoryCatalogue(snap, centres, {BasicHaloDefinitions.SO_200_CRIT.value: np.array([0.5, 0.4])})
    return snap, catalogue


@pytest.fixture(scope="module")
def cube_snap():
    fields = _fields(7, (0.05, 0.9))
    fields["smoothing_lengths"][:200] = torch.linspace(1.5, 2.4, 200)  # past K = 16: the oversize route
    return MemorySnapshot(fields, BOX)


LOS_RAYS, LOS_BINS = 48, 128


@pytest.fixture(scope="module")
def los_snap():
    """Particles with velocities, and 48 rays: a few supports a ray."""
    fields = _fields(9, (0.1, 0.5))
    fields["velocities"] = torch.tensor(np.random.default_rng(10).normal(0.0, 100.0, (N, 3)), dtype=torch.float32)
    rays = np.random.default_rng(11).uniform(0.0, BOX, (2, LOS_RAYS))
    return MemorySnapshot(fields, BOX, redshift=0.5), rays


def los_render(inputs):
    """On one intra-op thread, as ``test_torch_render_sightlines.py::
    one_torch_thread`` says why: the render's CPU kernels are many small
    ops, each slowed by the test run's workers sharing the cores."""
    snap, rays = inputs
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return render_sightlines(snap, rays[0], rays[1], kernel="wendland_c2", spectra=True, n_bins=LOS_BINS,
                                 profile="voigt", gamma=6.265e8, engine="pallas", device="cpu")
    finally:
        torch.set_num_threads(threads)


def box_render(snap, engine):
    return render_map_stack(snap, FIELDS, resolution=RES, engine=engine, device="cpu")


def cube_render(snap):
    return render_grid_stack(snap, FIELDS, resolution=GRID_RES, kernel="wendland_c2", device="cpu")


def halo_render(inputs):
    snap, catalogue = inputs
    return render_halo_maps(snap, catalogue, [0, 1], fields=FIELDS, resolution=HALO_RES, device="cpu")


def profiled(fn):
    """(fn's result, the spans it recorded, the profiler)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, spans(), prof


def tree(records) -> list:
    """(name, parent's name) of each span, in the order they opened."""
    by_id = {s["id"]: s["name"] for s in records}
    return [(s["name"], by_id.get(s["parent"])) for s in records]


# ---------------------------------------------------------------------------
# (a) off
# ---------------------------------------------------------------------------


def test_off_span_is_one_shared_object_that_records_nothing(box_snap):
    with device_trace():  # opens a new, empty window
        pass
    assert spans() == []
    a, b = span("render.io"), span("layout.sorted", particles=3)
    assert a is b is profiling._OFF
    with a as sp:
        sp.count(launches=1)
        count(particles=2)
    box_render(box_snap, "pallas")
    box_render(box_snap, "coherent")
    assert spans() == []


# ---------------------------------------------------------------------------
# (b) the span tree
# ---------------------------------------------------------------------------

MAP_TOP = [("render.map_stack", None), ("render.io", "render.map_stack"), ("render.deposit", "render.map_stack")]
MAP_END = [("render.derive", "render.map_stack"), ("render.to_host", "render.map_stack")]
TREES = {
    "coherent": MAP_TOP + [("layout.coherent", "render.deposit"), ("deposit.coherent", "render.deposit"),
                           ("deposit.tail", "render.deposit")] + MAP_END,
    "pallas": MAP_TOP + [("layout.sorted", "render.deposit"), ("deposit.levels", "render.deposit")] + MAP_END,
}
HALO = [("render.halo", "render.halo_maps"), ("render.recentre", "render.halo"), ("render.select", "render.halo"),
        ("render.deposit", "render.halo"), ("layout.sorted", "render.deposit"),
        ("deposit.levels", "render.deposit"), ("deposit.oversize", "render.deposit"),
        ("render.derive", "render.halo"), ("render.to_host", "render.halo")]
HALO_TREE = [("render.halo_maps", None), ("render.io", "render.halo_maps")] + HALO + HALO
GRID_TREE = [("render.grid_stack", None), ("render.io", "render.grid_stack"), ("render.deposit", "render.grid_stack"),
             ("layout.grid3d", "render.deposit"), ("deposit3d.levels", "render.deposit"),
             ("deposit3d.oversize", "render.deposit"), ("render.derive", "render.grid_stack"),
             ("render.to_host", "render.grid_stack")]


LOS_TREE = [("render.sightlines", None), ("render.io", "render.sightlines"),
            ("render.columns", "render.sightlines"), ("layout.rays", "render.columns"),
            ("sightlines.columns", "render.columns"), ("render.spectra", "render.sightlines"),
            ("layout.rays", "render.spectra"), ("sightlines.spectra", "render.spectra"),
            ("render.to_host", "render.sightlines")]


@pytest.mark.parametrize("engine", ["coherent", "pallas"])
def test_map_stack_records_its_span_tree(box_snap, engine):
    _, records, _ = profiled(lambda: box_render(box_snap, engine))
    assert tree(records) == TREES[engine]
    assert {s["product"] for s in records} == {records[0]["id"]}
    assert records[0]["counts"] == {"particles": N, "fields": 2}
    assert all(s["device_ms"] is None and s["self_device_ms"] is None for s in records)  # no CUDA here


def test_halo_maps_records_its_span_tree(halo_inputs):
    _, records, _ = profiled(lambda: halo_render(halo_inputs))
    assert tree(records) == HALO_TREE
    assert {s["product"] for s in records} == {records[0]["id"]}
    assert records[0]["counts"] == {"haloes": 2, "particles": N}
    assert [s["counts"]["halo"] for s in records if s["name"] == "render.halo"] == [0, 1]


def test_grid_stack_records_its_span_tree(cube_snap):
    _, records, _ = profiled(lambda: cube_render(cube_snap))
    assert tree(records) == GRID_TREE
    assert {s["product"] for s in records} == {records[0]["id"]}
    assert records[0]["counts"] == {"particles": N, "fields": 2, "voxels": GRID_RES**3}
    assert one(records, "render.to_host") == {"bytes": 3 * GRID_RES**3 * 4}


@pytest.fixture(scope="module")
def los_records(los_snap):
    """The spans of one profiled sightline render, which two tests read."""
    return profiled(lambda: los_render(los_snap))[1]


def test_sightlines_record_their_span_tree(los_records):
    records = los_records
    assert tree(records) == LOS_TREE
    assert {s["product"] for s in records} == {records[0]["id"]}
    assert records[0]["counts"] == {"particles": N, "rays": LOS_RAYS, "bins": LOS_BINS}
    # the columns and the spectra, float32, back in one phase
    assert one(records, "render.to_host") == {"bytes": 4 * LOS_RAYS * (1 + LOS_BINS)}
    assert all(s["device_ms"] is None for s in records)  # no CUDA here


def test_sightline_counters_count_the_stagings_and_the_kernels(los_records):
    """Each ``layout.rays`` counts its particles, rays and levels, and the
    columns' (level, ray, cell row) items or the spectra's ray blocks; the
    kernels' spans count the same items or blocks and the launches (0: the
    plain versions run here)."""
    records = los_records
    layouts = [s["counts"] for s in records if s["name"] == "layout.rays"]
    assert [set(c) for c in layouts] == [{"particles", "rays", "levels", "items"},
                                         {"particles", "rays", "levels", "blocks"}]
    assert all(c["particles"] == N and c["rays"] == LOS_RAYS and c["levels"] >= 1 for c in layouts)
    assert layouts[0]["items"] == 3 * layouts[0]["levels"] * LOS_RAYS  # three cell rows a (level, ray)
    columns = one(records, "sightlines.columns")
    assert columns == {"rays": LOS_RAYS, "items": layouts[0]["items"], "launches": 0}
    spectra = one(records, "sightlines.spectra")
    assert spectra == {"rays": LOS_RAYS, "blocks": layouts[1]["blocks"], "bins": LOS_BINS, "images": 7,
                       "launches": 0}
    assert layouts[1]["blocks"] == layouts[1]["levels"] * -(-LOS_RAYS // 32)  # 32 rays a block, each level


def test_the_registry_still_lists_the_sightline_kernels():
    from astro_sph_tools_tpu_torch.ops import kernel_counters
    from astro_sph_tools_tpu_torch.ops.sightlines_fused import columns_tiles
    from astro_sph_tools_tpu_torch.ops.spectra_fused import spectra_tiles

    counters = kernel_counters()
    assert counters["sightline_columns"] is columns_tiles and counters["sightline_spectra"] is spectra_tiles


def test_each_call_is_one_product(box_snap):
    def two():
        box_render(box_snap, "pallas")
        box_render(box_snap, "coherent")

    _, records, _ = profiled(two)
    roots = [s for s in records if s["parent"] is None]
    assert [s["name"] for s in roots] == ["render.map_stack"] * 2
    for root in roots:
        mine = [s for s in records if s["product"] == root["id"]]
        assert len(mine) == len(TREES["pallas" if root is roots[0] else "coherent"])


def test_a_new_profiled_window_replaces_the_last_read_one(box_snap):
    profiled(lambda: box_render(box_snap, "pallas"))
    _, records, _ = profiled(lambda: box_render(box_snap, "coherent"))
    assert tree(records) == TREES["coherent"]


# ---------------------------------------------------------------------------
# (c) counters
# ---------------------------------------------------------------------------


def _box_layout_inputs(snap):
    """The engines' inputs as ``render_map_stack`` builds them from ``snap``."""
    pos = snap.get_positions(ParticleType.gas).to_value("Mpc")
    mass = snap.get_masses(ParticleType.gas).to_value("Msun")
    values = torch.stack([mass, mass * snap.get_temperatures(ParticleType.gas).to_value("K")])
    h = snap.get_smoothing_lengths(ParticleType.gas).to_value("Mpc")
    spec = MapSpec(shape=(RES, RES), extent=(0.0, BOX, 0.0, BOX), periodic_wrap=True)
    return pos[:, 0], pos[:, 1], h, values, spec


def one(records, name) -> dict:
    found = [s for s in records if s["name"] == name]
    assert len(found) == 1, name
    return found[0]["counts"]


def test_coherent_layout_counters_equal_its_stats(box_snap):
    _, records, _ = profiled(lambda: box_render(box_snap, "coherent"))
    layout = tile_particles_coherent(*_box_layout_inputs(box_snap), device="cpu")
    got = one(records, "layout.coherent")
    want = {k: layout.stats[k] for k in ("n_rows", "coherent_rows", "n_candidates", "routed_particles")}
    assert got == {"particles": N, "n_tail_oversize": layout.n_tail_oversize, **want}
    assert want["routed_particles"] > 0 and one(records, "deposit.coherent")["candidates"] == layout.n_cand
    # no kernel runs on the CPU: the counts of launches are there, and 0
    assert one(records, "deposit.tail") == {"particles": layout.tail[0].shape[0], "launches": 0,
                                            "register_launches": 0}
    # the surface density, the weighted temperature and its mean
    assert one(records, "render.to_host") == {"bytes": 3 * RES * RES * 4}


def test_sorted_layout_counters_equal_its_levels(box_snap):
    _, records, _ = profiled(lambda: box_render(box_snap, "pallas"))
    tp = tile_particles(*_box_layout_inputs(box_snap), device="cpu")
    levels = {f"K{g.cfg.K}": c for g, _, c in tp.geoms}
    assert len(levels) >= 2
    assert one(records, "layout.sorted") == {"particles": N, "n_oversize": tp.n_oversize, **levels}
    assert one(records, "deposit.levels") == {"particles": sum(levels.values()), "launches": 0,
                                              "register_launches": 0}


def test_grid3d_layout_counters_add_up_to_the_particles(cube_snap):
    _, records, _ = profiled(lambda: cube_render(cube_snap))
    pos = cube_snap.get_positions(ParticleType.gas).to_value("Mpc")
    h = cube_snap.get_smoothing_lengths(ParticleType.gas).to_value("Mpc")
    spec = GridSpec((GRID_RES,) * 3, (0.0, BOX) * 3, periodic_wrap=True)
    tp = tile_particles_3d(pos, h, torch.ones(N), spec, kernel="wendland_c2", device="cpu")
    levels = {f"K{g.cfg.K}": c for g, _, c in tp.geoms}
    assert set(levels) == {"K4", "K8", "K16"} and tp.n_oversize > 0
    layout = one(records, "layout.grid3d")
    assert layout == {"particles": N, "n_oversize": tp.n_oversize, **levels}
    assert sum(v for k, v in layout.items() if k.startswith("K")) + layout["n_oversize"] == layout["particles"]
    lv = one(records, "deposit3d.levels")
    assert {k: lv[k] for k in ("particles", "launches")} == {"particles": sum(levels.values()), "launches": 0}
    assert one(records, "deposit3d.oversize") == {"particles": tp.n_oversize}


def test_grid3d_level_counters_equal_the_work_lists(cube_snap):
    """The span ``deposit3d.levels`` counts the candidates and the thread
    blocks of every level's work list: the sum of ``_region_candidates``
    over the active regions, and ``_region_items``' blocks (on the CPU too,
    where the plain version runs and no kernel launches)."""
    _, records, _ = profiled(lambda: cube_render(cube_snap))
    pos = cube_snap.get_positions(ParticleType.gas).to_value("Mpc")
    h = cube_snap.get_smoothing_lengths(ParticleType.gas).to_value("Mpc")
    spec = GridSpec((GRID_RES,) * 3, (0.0, BOX) * 3, periodic_wrap=True)
    tp = tile_particles_3d(pos, h, torch.ones(N), spec, kernel="wendland_c2", device="cpu")
    candidates = blocks = 0
    for geom, lo, c in tp.geoms:
        _, pcount = tile_ranges(tp.sorted_tile[lo:lo + c], geom.n_tiles)
        tables = _candidate_tables(geom, spec.shape, True, "cpu")
        counts = _region_candidates(pcount, geom, tables)
        candidates += int(counts[counts > 0].sum())
        blocks += _region_items(pcount, geom, tables)[0].shape[0]
    assert candidates > 0 and blocks > 0
    assert one(records, "deposit3d.levels") == {"particles": sum(c for _, _, c in tp.geoms), "launches": 0,
                                                "candidates": candidates, "blocks": blocks}


def test_halo_counters_add_up_over_the_oversize_route(halo_inputs):
    _, records, _ = profiled(lambda: halo_render(halo_inputs))
    halos = [s for s in records if s["name"] == "render.halo"]
    deposits = [s for s in records if s["name"] == "render.deposit"]
    layouts = [s["counts"] for s in records if s["name"] == "layout.sorted"]
    oversize = [s["counts"] for s in records if s["name"] == "deposit.oversize"]
    assert len(halos) == len(deposits) == len(layouts) == len(oversize) == 2
    for h, lay, over in zip(halos, layouts, oversize):
        selected = h["counts"]["selected"]
        assert lay["particles"] == selected
        assert sum(v for k, v in lay.items() if k.startswith("K")) + lay["n_oversize"] == selected
        assert over["particles"] == lay["n_oversize"] > 0
        routed = {k: v for k, v in over.items() if k != "particles"}
        assert sum(routed.values()) == over["particles"]
        assert routed.get("K128", 0) > 0 and routed.get("dense", 0) > 0


# ---------------------------------------------------------------------------
# (d) the profiler's clock
# ---------------------------------------------------------------------------


#: what the kineto clock's conversion to unix time may differ by (ns): the
#: converter fits the approximate clock to the system clock
CLOCK_SLACK = 20_000


def render_of(which, box_snap, halo_inputs, cube_snap, los_snap=None):
    def sightlines():
        los = los_render(los_snap)
        return {"columns": los.columns, "tau": los.tau}

    return {"halo": lambda: halo_render(halo_inputs), "grid": lambda: cube_render(cube_snap),
            "sightlines": sightlines}.get(which, lambda: box_render(box_snap, which))


def misplaced(records, prof) -> list:
    """The spans whose host interval does not hold their
    ``record_function`` event (matched by name, in order), within
    CLOCK_SLACK: a span stamped on another clock, or not around its event."""
    names = {s["name"] for s in records}
    events: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in names and e.device_type() != torch.autograd.DeviceType.CUDA:
            events.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    out = []
    for name in names:
        mine = [(s["start_ns"], s["end_ns"]) for s in records if s["name"] == name]
        theirs = sorted(events[name])
        assert len(mine) == len(theirs), name
        out += [(name, ea - a, b - eb) for (a, b), (ea, eb) in zip(mine, theirs)
                if not (a - CLOCK_SLACK <= ea and eb <= b + CLOCK_SLACK)]
    return out


@pytest.mark.parametrize("which", ["coherent", "pallas", "halo", "grid", "sightlines"])
def test_spans_lie_on_their_record_function_events(box_snap, halo_inputs, cube_snap, los_snap, which):
    """Each span's stamps are read just outside its record_function, so its
    interval holds the event's on one clock, however long the thread waits
    between the two stamps (a loaded host can hold it up for milliseconds:
    the distance between the stamps is no test of the clock)."""
    _, records, prof = profiled(render_of(which, box_snap, halo_inputs, cube_snap, los_snap))
    assert misplaced(records, prof) == []


def test_a_span_stamped_on_another_clock_does_not_lie_on_its_event(box_snap):
    _, records, prof = profiled(lambda: box_render(box_snap, "pallas"))
    shift = time.monotonic_ns() - time.time_ns()  # the same instants on the monotonic clock
    moved = [dict(s, start_ns=s["start_ns"] + shift, end_ns=s["end_ns"] + shift) for s in records]
    assert len(misplaced(moved, prof)) == len(records)
    late = [dict(s, start_ns=s["start_ns"] + 50_000_000, end_ns=s["end_ns"] + 50_000_000) for s in records]
    assert len(misplaced(late, prof)) == len(records)  # the system clock 50 ms off


# ---------------------------------------------------------------------------
# (e) results unchanged
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["coherent", "pallas", "halo", "grid", "sightlines"])
def test_maps_are_bit_for_bit_those_rendered_without_the_profiler(box_snap, halo_inputs, cube_snap, los_snap, which):
    render = render_of(which, box_snap, halo_inputs, cube_snap, los_snap)
    fn = render if which == "halo" else (lambda: [render()])
    plain = fn()
    traced, records, _ = profiled(fn)
    assert records
    for a, b in zip(plain, traced):
        assert set(a.keys()) == set(b.keys())
        for k in a.keys():
            assert np.array_equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# (f) the benchmark's readers
# ---------------------------------------------------------------------------


def _metric(name):
    path = os.path.join(ROOT, "sphbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"tracing_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Run:
    walls = [0.1, 0.1]  # two products in the window


def _rec(name, ms, **counts):
    return {"name": name, "self_device_ms": ms, "counts": counts}


FABRICATED = [
    _rec("render.map_stack", 1.0), _rec("render.deposit", 0.5),
    _rec("layout.coherent", 7.0, particles=1000, routed_particles=250),
    _rec("deposit.coherent", 8.0), _rec("deposit.tail", 100.0), _rec("render.to_host", 1.5),
    _rec("layout.coherent", 9.0, particles=1000, routed_particles=350),
    _rec("deposit.coherent", 6.0), _rec("deposit.tail", 104.0), _rec("render.to_host", 1.3),
    _rec("layout.sorted", 15.0, particles=400, n_oversize=100), _rec("deposit.levels", 20.0),
    _rec("deposit.oversize", 3000.0, particles=100), _rec("layout.sorted", 17.0, particles=600, n_oversize=20),
    _rec("render.grid_stack", 2.0), _rec("layout.grid3d", 30.0, particles=5000, K4=500, K8=2500, K16=1500, n_oversize=500),
    _rec("deposit3d.levels", 100.0, particles=4500, launches=3), _rec("deposit3d.oversize", 60.0, particles=500),
    _rec("layout.grid3d", 34.0, particles=5000, K8=3000, K16=1600, n_oversize=400),
    _rec("deposit3d.levels", 104.0, particles=4600, launches=2), _rec("deposit3d.oversize", 50.0, particles=400),
    _rec("render.sightlines", 3.0), _rec("layout.rays", 40.0, particles=5000, rays=100, levels=6, items=1800),
    _rec("sightlines.columns", 2.5, launches=1),
    _rec("layout.rays", 30.0, particles=5000, rays=100, levels=4, blocks=16),
    _rec("sightlines.spectra", 180.0, launches=1, bins=512), _rec("layout.rays", 44.0),
    _rec("sightlines.columns", 2.7), _rec("layout.rays", 32.0), _rec("sightlines.spectra", 184.0),
]
EXPECTED = {
    "coherent_layout_ms": (7.0 + 9.0) / 2,
    "sorted_layout_ms": (15.0 + 17.0) / 2,
    "level_deposit_ms": (100.0 + 104.0 + 20.0) / 2,
    "coherent_deposit_ms": (8.0 + 6.0) / 2,
    "oversize_ms": 3000.0 / 2,
    "to_host_ms": (1.5 + 1.3) / 2,
    "routed_pct": 100.0 * 600 / 2000,
    "oversize_pct": 100.0 * 120 / 1000,
    "grid3d_layout_ms": (30.0 + 34.0) / 2,
    "grid3d_level_ms": (100.0 + 104.0) / 2,
    "grid3d_oversize_ms": (60.0 + 50.0) / 2,
    "grid3d_oversize_pct": 100.0 * 900 / 10000,
    "los_layout_ms": (40.0 + 30.0 + 44.0 + 32.0) / 2,
    "los_columns_ms": (2.5 + 2.7) / 2,
    "los_spectra_ms": (180.0 + 184.0) / 2,
}
SPAN_OF = {"coherent_layout_ms": "layout.coherent", "sorted_layout_ms": "layout.sorted",
           "level_deposit_ms": "deposit.", "coherent_deposit_ms": "deposit.coherent",
           "oversize_ms": "deposit.oversize", "to_host_ms": "render.to_host", "routed_pct": "layout.coherent",
           "oversize_pct": "layout.sorted", "grid3d_layout_ms": "layout.grid3d", "grid3d_level_ms": "deposit3d.levels",
           "grid3d_oversize_ms": "deposit3d.oversize", "grid3d_oversize_pct": "layout.grid3d",
           "los_layout_ms": "layout.rays", "los_columns_ms": "sightlines.columns",
           "los_spectra_ms": "sightlines.spectra"}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_span_metric_reads_the_hand_computed_value(monkeypatch, name):
    monkeypatch.setattr(profiling, "spans", lambda: FABRICATED)
    assert _metric(name).read(_Run()) == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_span_metric_is_none_without_its_span(monkeypatch, name):
    rest = [s for s in FABRICATED if not s["name"].startswith(SPAN_OF[name])]
    monkeypatch.setattr(profiling, "spans", lambda: rest)
    assert _metric(name).read(_Run()) is None
    monkeypatch.delattr(profiling, "spans")  # a program without spans
    assert _metric(name).read(_Run()) is None


@pytest.mark.parametrize("name", [n for n in sorted(EXPECTED) if n.endswith("_ms")])
def test_time_metric_is_none_off_the_card(monkeypatch, name):
    cpu = [dict(s, self_device_ms=None) for s in FABRICATED]
    monkeypatch.setattr(profiling, "spans", lambda: cpu)
    assert _metric(name).read(_Run()) is None


class _CubeRun(_Run):
    def work(self):
        return {"seconds": 0.0083}  # a product's least time


def test_the_grid3d_roofline_reads_the_least_time_over_both_3d_kernels(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: FABRICATED)
    # (100 + 60 + 104 + 50) ms over two products
    assert _metric("grid3d_deposit_roofline").read(_CubeRun()) == pytest.approx(100.0 * 8.3 / 157.0, rel=1e-12)
    monkeypatch.setattr(profiling, "spans", lambda: [s for s in FABRICATED if not s["name"].startswith("deposit3d")])
    assert _metric("grid3d_deposit_roofline").read(_CubeRun()) is None
    monkeypatch.setattr(profiling, "spans", lambda: [dict(s, self_device_ms=None) for s in FABRICATED])
    assert _metric("grid3d_deposit_roofline").read(_CubeRun()) is None
    monkeypatch.delattr(profiling, "spans")  # a program without spans
    assert _metric("grid3d_deposit_roofline").read(_CubeRun()) is None


class _LosRun(_Run):
    def work(self):
        return {"seconds": 0.03, "spectra": {"seconds": 0.018}}  # a product's and the spectra's least times


def test_the_spectra_roofline_reads_their_least_time_over_kernel_5(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: FABRICATED)
    # (180 + 184) ms of #5 over two products
    assert _metric("spectra_roofline").read(_LosRun()) == pytest.approx(100.0 * 18.0 / 182.0, rel=1e-12)
    monkeypatch.setattr(profiling, "spans", lambda: [s for s in FABRICATED if s["name"] != "sightlines.spectra"])
    assert _metric("spectra_roofline").read(_LosRun()) is None
    monkeypatch.setattr(profiling, "spans", lambda: [dict(s, self_device_ms=None) for s in FABRICATED])
    assert _metric("spectra_roofline").read(_LosRun()) is None
    monkeypatch.delattr(profiling, "spans")  # a program without spans
    assert _metric("spectra_roofline").read(_LosRun()) is None
