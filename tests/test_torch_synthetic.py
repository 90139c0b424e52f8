"""Port vs JAX: the synthetic fixture writers (``io/synthetic.py``).

Each writer runs in both packages from the same spec and seed, into two
directories; every file the JAX writer made must exist under the port's
directory with equal groups, datasets (values by ``np.array_equal``, dtypes,
shapes) and attributes. ``generate_particles`` must give equal arrays. The
port's module must import neither JAX nor the JAX package.
"""

import os
import subprocess
import sys

import h5py
import numpy as np
import pytest

import astro_sph_tools_tpu.io.synthetic as JS
import astro_sph_tools_tpu_torch.io.synthetic as TS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spec(mod, **kw):
    base = dict(n_gas=600, n_dm=400, n_star=120, n_bh=4, n_files=3, clustered=True, n_groups=5, seed=4242)
    base.update(kw)
    return mod.SyntheticSnapshotSpec(**base)


def _files(root):
    out = []
    for d, _, names in os.walk(root):
        out += [os.path.relpath(os.path.join(d, n), root) for n in names]
    return sorted(out)


def _attrs_equal(a, b, where):
    assert sorted(a.keys()) == sorted(b.keys()), where
    for k in a.keys():
        va, vb = a[k], b[k]
        assert type(va) is type(vb), (where, k)
        assert np.array_equal(np.asarray(va), np.asarray(vb)), (where, k)
        assert np.asarray(va).dtype == np.asarray(vb).dtype, (where, k)


def assert_same_hdf5(path_a, path_b):
    with h5py.File(path_a, "r") as fa, h5py.File(path_b, "r") as fb:
        _attrs_equal(fa.attrs, fb.attrs, "/")
        names_a, names_b = [], []
        fa.visit(names_a.append)
        fb.visit(names_b.append)
        assert sorted(names_a) == sorted(names_b), path_a
        for name in names_a:
            oa, ob = fa[name], fb[name]
            assert type(oa) is type(ob), name
            _attrs_equal(oa.attrs, ob.attrs, name)
            if isinstance(oa, h5py.Dataset):
                assert oa.dtype == ob.dtype and oa.shape == ob.shape, name
                assert np.array_equal(oa[()], ob[()]), name


def assert_same_trees(dir_a, dir_b):
    fa, fb = _files(dir_a), _files(dir_b)
    assert fa == fb and fa
    for rel in fa:
        assert_same_hdf5(os.path.join(dir_a, rel), os.path.join(dir_b, rel))


def _same_nested(a, b):
    if isinstance(a, dict):
        assert sorted(map(str, a)) == sorted(map(str, b))
        for (ka, va), (kb, vb) in zip(sorted(a.items(), key=lambda kv: str(kv[0])),
                                      sorted(b.items(), key=lambda kv: str(kv[0]))):
            assert str(ka) == str(kb)
            _same_nested(va, vb)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for va, vb in zip(a, b):
            _same_nested(va, vb)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.asarray(a).dtype == np.asarray(b).dtype and np.array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("kw", [{}, {"spatial_order": True, "clustered": False}])
def test_generate_particles_equal(kw):
    pa = JS.generate_particles(_spec(JS, **kw))
    pb = TS.generate_particles(_spec(TS, **kw))
    for field in ("positions", "velocities", "masses", "smoothing", "ids", "group_numbers", "metallicity",
                  "enrichment_z", "abundances"):
        _same_nested({k.name: v for k, v in getattr(pa, field).items()},
                     {k.name: v for k, v in getattr(pb, field).items()})
    for field in ("density", "temperature", "sfr", "bh_subgrid_mass", "group_centres"):
        assert np.array_equal(getattr(pa, field), getattr(pb, field)), field
    assert pa.dm_particle_mass == pb.dm_particle_mass


@pytest.mark.parametrize("kw", [
    {},
    {"spatial_order": True, "numpart_highword": True},
    {"snipshot": True, "n_files": 2},
    {"numpart_total_override": (5, 2**33, 0, 0, 7, 3)},
])
def test_write_snapshot_and_catalogue_equal(tmp_path, kw):
    dirs = []
    for mod, name in ((JS, "jax"), (TS, "port")):
        d = str(tmp_path / name)
        os.makedirs(d)
        spec = _spec(mod, **kw)
        path, truth = mod.write_snapshot(d, spec)
        if not spec.snipshot:
            mod.write_catalogue(d, spec, truth)
        dirs.append(d)
    assert_same_trees(*dirs)


@pytest.mark.parametrize("cells", [0, 3])
def test_write_swift_and_soap_equal(tmp_path, cells):
    dirs = []
    for mod, name in ((JS, "jax"), (TS, "port")):
        d = str(tmp_path / name)
        os.makedirs(d)
        spec = _spec(mod, swift_cells_dim=cells)
        _, truth = mod.write_swift_snapshot(d, spec)
        *_, meta = mod.write_soap_catalogue(d, spec, truth)
        dirs.append((d, meta))
    assert_same_trees(dirs[0][0], dirs[1][0])
    _same_nested(dirs[0][1], dirs[1][1])


def test_write_tng_equal(tmp_path):
    outs = []
    for mod, name in ((JS, "jax"), (TS, "port")):
        d = str(tmp_path / name)
        os.makedirs(d)
        *_, meta = mod.write_tng_snapshot(d, _spec(mod, n_files=4))
        outs.append((d, meta))
    assert_same_trees(outs[0][0], outs[1][0])
    _same_nested(outs[0][1], outs[1][1])


@pytest.mark.parametrize("seed", [None, 17])
def test_write_los_equal(tmp_path, seed):
    outs = []
    for mod, name in ((JS, "jax"), (TS, "port")):
        d = str(tmp_path / name)
        os.makedirs(d)
        _, meta = mod.write_los_file(d, _spec(mod), n_sightlines=3, particles_per_los=50, seed=seed)
        outs.append((d, meta))
    assert_same_trees(outs[0][0], outs[1][0])
    _same_nested(outs[0][1], outs[1][1])


def test_public_names_match():
    names = [n for n in dir(JS) if not n.startswith("_") and n not in ("h5py", "np", "os", "annotations")]
    missing = [n for n in names if not hasattr(TS, n)]
    assert not missing
    assert TS.SyntheticSnapshotSpec().tag == JS.SyntheticSnapshotSpec().tag


def test_port_module_imports_no_jax():
    code = (
        "import sys\n"
        "import astro_sph_tools_tpu_torch.io.synthetic as s\n"
        "s.generate_particles(s.SyntheticSnapshotSpec(n_gas=64, n_dm=64, n_star=8, n_bh=2))\n"
        "print(sorted(m for m in ('jax', 'astro_sph_tools_tpu', 'h5py') if m in sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=120,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
