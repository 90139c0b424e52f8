"""Port vs JAX: snapshot IO, Cosmology and ``render_map_stack``.

A synthetic EAGLE snapshot (written by the JAX package's fixture generator)
is opened by both packages' ``SnapshotEAGLE``: the arrays read must be
identical and the cosmologies equal field by field. The two
``render_map_stack``s then render it on the sorted engine (``pallas``: the
JAX Pallas kernel in interpret mode vs the port's plain kernel version on
the CPU) and on the stencil engine (``xla``). Maps agree within
1e-5 * max; ``mean_*`` maps are compared where the surface density exceeds
1e-3 of its maximum (elsewhere they divide two near-zero maps).
"""

import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from astro_sph_tools_tpu.data_structures import ParticleType as JParticleType
from astro_sph_tools_tpu.io.eagle import SnapshotEAGLE as JSnapshotEAGLE
from astro_sph_tools_tpu.io.synthetic import SyntheticSnapshotSpec, write_snapshot
from astro_sph_tools_tpu.render import render_map_stack as j_render
from astro_sph_tools_tpu_torch import render_map_stack as t_render
from astro_sph_tools_tpu_torch.data_structures import Cosmology, ParticleType
from astro_sph_tools_tpu_torch.io import SnapshotEAGLE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def snap_path(tmp_path_factory):
    spec = SyntheticSnapshotSpec(n_gas=2048, n_dm=256, n_star=64, n_bh=2, clustered=True)
    path, _ = write_snapshot(str(tmp_path_factory.mktemp("torch_render_sim")), spec)
    return path


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("getter", ["positions", "smoothing_lengths", "masses", "temperatures", "velocities"])
def test_snapshot_arrays_identical(snap_path, getter):
    j = getattr(JSnapshotEAGLE(snap_path), f"get_{getter}")(JParticleType.gas)
    t = getattr(SnapshotEAGLE(snap_path), f"get_{getter}")(ParticleType.gas)
    assert t.units.symbol == j.units.symbol
    assert np.array_equal(t.value, j.value)


def test_cosmology_and_metadata_match(snap_path):
    j = JSnapshotEAGLE(snap_path)
    t = SnapshotEAGLE(snap_path)
    assert [f.name for f in dataclasses.fields(Cosmology)] == [
        f.name for f in dataclasses.fields(type(j.cosmology))
    ]
    for f in dataclasses.fields(Cosmology):
        assert getattr(t.cosmology, f.name) == getattr(j.cosmology, f.name)
    assert t.cosmology.critical_density_comoving() == j.cosmology.critical_density_comoving()
    assert np.array_equal(t.box_size.value, j.box_size.value)
    assert t.number_of_particles(ParticleType.gas) == j.number_of_particles(JParticleType.gas)


def test_fields_to_device(snap_path):
    t = SnapshotEAGLE(snap_path)
    out = t.fields_to_device(ParticleType.gas, ["masses", "smoothing_lengths"], device="cpu")
    assert out["masses"].dtype == torch.float32 and out["masses"].device.type == "cpu"
    assert np.allclose(out["smoothing_lengths"].numpy(), t.get_smoothing_lengths(ParticleType.gas).value, rtol=1e-7)


@pytest.mark.parametrize("engine", ["pallas", "xla"])
def test_render_map_stack_matches_jax(snap_path, engine):
    kw = dict(fields=("density", "temperature"), resolution=32, engine=engine)
    ref = j_render(JSnapshotEAGLE(snap_path), **kw)
    got = t_render(SnapshotEAGLE(snap_path), device="cpu", **kw)
    assert set(got.keys()) == set(ref.keys()) == {
        "surface_density", "mass_weighted_temperature", "mean_temperature",
    }
    assert got.spec == type(got.spec)(**dataclasses.asdict(ref.spec))
    for name in ("surface_density", "mass_weighted_temperature"):
        assert got[name].shape == (32, 32)
        assert rel_err(got[name], ref[name]) <= 1e-5
    sd = ref["surface_density"]
    covered = sd > 1e-3 * sd.max()
    assert rel_err(got["mean_temperature"][covered], ref["mean_temperature"][covered]) <= 1e-5
    assert set(got.timings) == {"io", "deposit", "derive", "to_host"}


def test_render_rejects_unported_engine(snap_path):
    with pytest.raises(ValueError, match="Unknown engine"):
        t_render(SnapshotEAGLE(snap_path), engine="scatter", device="cpu")
    # the coherent engine carries at most 4 fields per pass, as in JAX
    with pytest.raises(ValueError, match="at most 4 fields"):
        t_render(SnapshotEAGLE(snap_path), fields=("density", "mass", "temperature", "metallicity",
                                                  "velocity_los"), engine="coherent", device="cpu")


@pytest.mark.parametrize("fields", [("density",), ("density", "temperature", "velocity_los")])
def test_render_map_stack_coherent_matches_pallas(snap_path, fields):
    """engine="coherent" renders the maps of engine="pallas" (the port's
    sorted engine, held against JAX above)."""
    snap = SnapshotEAGLE(snap_path)
    got = t_render(snap, fields=fields, resolution=64, engine="coherent", device="cpu")
    ref = t_render(snap, fields=fields, resolution=64, engine="pallas", device="cpu")
    assert set(got.keys()) == set(ref.keys())
    for name in got.keys():
        if not name.startswith("mean_"):
            assert rel_err(got[name], ref[name]) <= 1e-5, name


def test_port_imports_neither_jax_nor_h5py():
    code = (
        "import sys\n"
        "import astro_sph_tools_tpu_torch, astro_sph_tools_tpu_torch.render\n"
        "import astro_sph_tools_tpu_torch.tools, astro_sph_tools_tpu_torch.ops\n"
        "import astro_sph_tools_tpu_torch.ops.coherent_prep, astro_sph_tools_tpu_torch._build\n"
        "from astro_sph_tools_tpu_torch.ops import deposit_2d_coherent_fused, tile_particles_coherent\n"
        "import astro_sph_tools_tpu_torch.io.snapshot\n"
        "import astro_sph_tools_tpu_torch.ops.sightlines, astro_sph_tools_tpu_torch.ops.sightlines_fused\n"
        "import astro_sph_tools_tpu_torch.ops.spectra, astro_sph_tools_tpu_torch.ops.spectra_fused\n"
        "import astro_sph_tools_tpu_torch.scripts.sightlines_cli, astro_sph_tools_tpu_torch.utils.console\n"
        "import astro_sph_tools_tpu_torch.ops.grid3d, astro_sph_tools_tpu_torch.ops.grid3d_tiled\n"
        "import astro_sph_tools_tpu_torch.ops.layout_shear\n"
        "from astro_sph_tools_tpu_torch.tools import GridSpec, deposit_3d, deposit_3d_auto, deposit_3d_pallas\n"
        "import astro_sph_tools_tpu_torch.ops.periodic, astro_sph_tools_tpu_torch.ops.reorder\n"
        "import astro_sph_tools_tpu_torch.io, astro_sph_tools_tpu_torch.io.eagle, astro_sph_tools_tpu_torch.io.catalogue\n"
        "import astro_sph_tools_tpu_torch.io.subfind, astro_sph_tools_tpu_torch.io.swift, astro_sph_tools_tpu_torch.io.tng\n"
        "import astro_sph_tools_tpu_torch.io.filetree, astro_sph_tools_tpu_torch.io.los\n"
        "import astro_sph_tools_tpu_torch.io.particle_filter, astro_sph_tools_tpu_torch.data_structures.interface\n"
        "import astro_sph_tools_tpu_torch.scripts.render_map, astro_sph_tools_tpu_torch.scripts.ast_cli\n"
        "from astro_sph_tools_tpu_torch import render_halo_maps\n"
        "from astro_sph_tools_tpu_torch.io import SnapshotEAGLE, SnapshotSWIFT, SnapshotTNG, CatalogueSUBFIND\n"
        "from astro_sph_tools_tpu_torch.tools import shift_centre, ArrayReorder, calculate_wrapped_distance\n"
        "import astro_sph_tools_tpu_torch.io.packing, astro_sph_tools_tpu_torch.io.prefetch\n"
        "import astro_sph_tools_tpu_torch.io.ionisation, astro_sph_tools_tpu_torch.native\n"
        "import astro_sph_tools_tpu_torch.ops.interp, astro_sph_tools_tpu_torch.data_structures.ionisation\n"
        "import astro_sph_tools_tpu_torch.utils.determinism, astro_sph_tools_tpu_torch.utils.profiling\n"
        "from astro_sph_tools_tpu_torch.io import IonisationTable_HM01, stream_macro_chunks, unpack_particles_device\n"
        "from astro_sph_tools_tpu_torch.utils import device_trace, assert_deterministic\n"
        "import astro_sph_tools_tpu_torch.ops.cells, astro_sph_tools_tpu_torch.ops.neighbors\n"
        "import astro_sph_tools_tpu_torch.scripts.find_nearest_haloes, astro_sph_tools_tpu_torch.tools.projections\n"
        "from astro_sph_tools_tpu_torch.tools import create_image, ArrayReorder_2\n"
        "import astro_sph_tools_tpu_torch.parallel, astro_sph_tools_tpu_torch.parallel.mesh\n"
        "import astro_sph_tools_tpu_torch.parallel._comm, astro_sph_tools_tpu_torch.parallel.sharded\n"
        "import astro_sph_tools_tpu_torch.parallel.coherent, astro_sph_tools_tpu_torch.parallel.sightlines\n"
        "import astro_sph_tools_tpu_torch.parallel.reorder, astro_sph_tools_tpu_torch.parallel.rebalance\n"
        "import astro_sph_tools_tpu_torch.parallel.sharded_io\n"
        "from astro_sph_tools_tpu_torch.parallel import distributed_reorder, make_mesh, Mesh\n"
        "import astro_sph_tools_tpu_torch.io.synthetic, astro_sph_tools_tpu_torch.parallel.dryrun\n"
        "import astro_sph_tools_tpu_torch.io.memory\n"
        "import astro_sph_tools_tpu_torch.examples.full_workflow, astro_sph_tools_tpu_torch.examples.render_service\n"
        "import astro_sph_tools_tpu_torch.examples.multichip_render, astro_sph_tools_tpu_torch.scripts.fidelity_check\n"
        "print(sorted(m for m in ('jax', 'h5py', 'astro_sph_tools_tpu') if m in sys.modules))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120, check=True
    )
    assert out.stdout.strip() == "[]"


def test_chip_smoke_imports_no_jax(tmp_path):
    """chip_smoke.py's module level imports neither jax nor h5py, and the
    script fails without a GPU or in a directory that holds only itself."""
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "import chip_smoke\n"
        "print(sorted(m for m in ('jax', 'h5py', 'astro_sph_tools_tpu') if m in sys.modules))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120, check=True
    )
    assert out.stdout.strip() == "[]"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    runs = [tmp_path] + ([] if torch.cuda.is_available() else [ROOT])
    for cwd in runs:
        run = subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True, timeout=120
        )
        assert run.returncode != 0 and '"ok": true' not in run.stdout
