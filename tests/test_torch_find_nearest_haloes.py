"""Port vs JAX: the nearest-halo CLI (``scripts/find_nearest_haloes.py``).

Both packages' ``main`` run on the synthetic EAGLE tree of
``tests/test_cli.py`` and the SWIFT tree of ``tests/test_swift_filetree.py``
(the JAX fixture writers), the port with ``--device cpu``. The output HDF5
files are compared dataset by dataset and attribute by attribute: halo
indexes equal, distances and radii within f32. A threshold above every
halo gives ids -1, distance inf and radius 0 in both; the existing-dataset
guard refuses a second run without ``--overwrite``; a missing format flag
is an error.
"""

import h5py
import numpy as np
import pytest

from astro_sph_tools_tpu.io.synthetic import (
    SyntheticSnapshotSpec,
    write_catalogue,
    write_snapshot,
    write_soap_catalogue,
    write_swift_snapshot,
)
from astro_sph_tools_tpu.scripts.find_nearest_haloes import main as j_main
from astro_sph_tools_tpu_torch.scripts.find_nearest_haloes import main as t_main


@pytest.fixture(scope="module")
def eagle_sim(tmp_path_factory):
    spec = SyntheticSnapshotSpec(n_gas=1024, n_dm=256, n_star=64, n_bh=2, n_files=2, n_groups=6, clustered=True)
    root = tmp_path_factory.mktemp("torch_nearest_eagle")
    _, truth = write_snapshot(str(root), spec)
    write_catalogue(str(root), spec, truth)
    return str(root)


@pytest.fixture(scope="module")
def swift_sim(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_nearest_swift")
    for number, z, seed in ((10, 1.0, 3), (12, 0.25, 4)):
        spec = SyntheticSnapshotSpec(n_gas=512, n_dm=256, n_star=32, n_bh=2, n_groups=5,
                                     snapshot_number=number, redshift=z, seed=seed)
        _, particles = write_swift_snapshot(str(root), spec)
        write_soap_catalogue(str(root), spec, particles)
    return str(root)


def h5_items(path):
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            attrs = {k: np.asarray(v) for k, v in obj.attrs.items()}
            out[name] = (np.asarray(obj) if isinstance(obj, h5py.Dataset) else None, attrs)
        f.visititems(visit)
    return out


def assert_same_output(got_path, ref_path):
    got, ref = h5_items(got_path), h5_items(ref_path)
    assert set(got) == set(ref)
    for name, (data, attrs) in ref.items():
        g_data, g_attrs = got[name]
        assert set(g_attrs) == set(attrs), name
        for k in attrs:
            np.testing.assert_array_equal(g_attrs[k], attrs[k], err_msg=f"{name} {k}")
        if data is None:
            continue
        assert g_data.dtype == data.dtype and g_data.shape == data.shape, name
        if name.endswith("halo_indexes"):
            np.testing.assert_array_equal(g_data, data, err_msg=name)
        else:
            np.testing.assert_allclose(g_data, data, rtol=1e-6, atol=0, err_msg=name)
    return got


@pytest.mark.parametrize("fmt", ["eagle", "swift"])
def test_output_matches_jax(fmt, eagle_sim, swift_sim, tmp_path):
    root, z = (eagle_sim, "0.5") if fmt == "eagle" else (swift_sim, "0.25")
    argv = ["--target-redshift", z, f"--{fmt}", "--input-directory", root,
            "--minimum-log10-halo-masses", "11.0,12.0,20.0"]
    assert j_main(argv + ["--output-filepath", str(tmp_path / "jax")]) == 0
    assert t_main(argv + ["--output-filepath", str(tmp_path / "port"), "--device", "cpu"]) == 0
    got = assert_same_output(tmp_path / "port.hdf5", tmp_path / "jax.hdf5")
    top = next(name for name in got if "/" not in name)
    ids, dist = got[f"{top}/halo_indexes"][0], got[f"{top}/halo_comoving_distance"][0]
    assert (ids >= 0).all() and np.isfinite(dist).all() and (dist >= 0).all()
    # no halo passes 10^20 Msun: the null values
    empty = f"{top}/minimum_halo_mass_limited/20.00"
    assert (got[f"{empty}/halo_indexes"][0] == -1).all()
    assert np.isinf(got[f"{empty}/halo_comoving_distance"][0]).all()
    assert (got[f"{empty}/halo_comoving_radius"][0] == 0).all()


def test_existing_dataset_guard_and_overwrite(eagle_sim, tmp_path):
    argv = ["--target-redshift", "0.5", "--eagle", "--input-directory", eagle_sim,
            "--output-filepath", str(tmp_path / "nearest"), "--device", "cpu"]
    assert t_main(argv) == 0
    first = h5_items(tmp_path / "nearest.hdf5")
    assert t_main(argv) == 1  # the guard refuses without --overwrite
    assert t_main(argv + ["--overwrite"]) == 0
    again = h5_items(tmp_path / "nearest.hdf5")
    assert set(again) == set(first)
    for name, (data, _) in first.items():
        if data is not None:
            np.testing.assert_array_equal(again[name][0], data)


def test_requires_a_format_flag(eagle_sim, swift_sim, tmp_path):
    base = ["--target-redshift", "0.5", "--output-filepath", str(tmp_path / "x"), "--device", "cpu"]
    assert t_main(base + ["--input-directory", eagle_sim]) == 1
    assert t_main(base + ["--input-directory", swift_sim, "--swift", "--snipshots"]) == 1
    with pytest.raises(SystemExit):
        t_main(base + ["--input-directory", eagle_sim, "--eagle", "--swift"])
