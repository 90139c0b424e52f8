"""The port's host C library (``native/hostops.c``) against its plain versions.

- ``assign_tiles_f64`` against the port's own torch formulation of the
  sorted engine's assignment (``deposit_tiled._assign_keys``: the
  ``_pixel_coords`` and ``_multi_level_assign`` it keeps as the plain
  version), bit for bit (keys, tile-local u and v), on periodic and open
  maps with every level's geometry, off-extent particles and particles on
  tile and level boundaries, in one pass and split over threads; the same for the single-level
  ``_tile_local_coords``; and the layouts ``tile_particles`` builds from
  host f64 and from f64 CPU tensors (the torch formulation) are equal.
- ``scale_cast`` against NumPy's f64 multiply and f32 cast, bit for bit.
- ``morton_delta_encode_u16`` against the NumPy formulation (the port's
  ``morton_delta_encode_plain`` and the JAX package's), bit for bit, for
  curve-ordered and shuffled inputs.
- A build that fails raises with the compiler's message.

The library is built with the system C compiler into the package's
``_build/`` at first use.
"""

import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

from astro_sph_tools_tpu.io import packing as JP
from astro_sph_tools_tpu_torch import _build, native
from astro_sph_tools_tpu_torch.io import packing as P
from astro_sph_tools_tpu_torch.kernels.splines import get_kernel
from astro_sph_tools_tpu_torch.ops import MapSpec

T = importlib.import_module("astro_sph_tools_tpu_torch.ops.deposit_tiled")

SPECS = {
    "periodic_64": MapSpec(shape=(64, 64), extent=(0.0, 10.0, 0.0, 10.0), periodic_wrap=True),
    "periodic_1024": MapSpec(shape=(1024, 1024), extent=(0.0, 25.0, 0.0, 25.0), periodic_wrap=True),
    "open_48x40": MapSpec(shape=(40, 48), extent=(-0.6, 0.6, -0.5, 0.5)),
    "open_corner_300x200": MapSpec(shape=(200, 300), extent=(1.0, 31.0, 2.0, 22.0), pixel_origin="corner"),
}


def particles(spec, n, seed):
    """f64 positions over the extent and 20 % beyond it, with some exactly
    on tile boundaries and on the extent's edges; f32 h spanning every
    level and the oversize route, with some exactly on level bounds."""
    rng = np.random.default_rng(seed)
    x0, x1, y0, y1 = spec.extent
    ny, nx = spec.shape
    wx, wy = x1 - x0, y1 - y0
    x = rng.uniform(x0 - 0.2 * wx, x1 + 0.2 * wx, n)
    y = rng.uniform(y0 - 0.2 * wy, y1 + 0.2 * wy, n)
    k = n // 10
    x[:k] = x0 + rng.integers(0, nx + 1, k) * (wx / nx)  # pixel (and tile) edges
    y[:k] = y0 + rng.integers(0, ny + 1, k) * (wy / ny)
    px = min(spec.pixel_size)
    h = np.exp(rng.normal(np.log(2.0 * px), 1.3, n)).astype(np.float32)
    support = get_kernel("cubic_spline").support_factor
    bounds = [c.max_s_pix for c in T.PALLAS_LEVELS]
    h[:8] = np.float32(np.array(bounds * 2) * px / support)  # on the level bounds
    return x, y, h


@pytest.mark.parametrize("name", sorted(SPECS))
def test_assign_tiles_equals_the_torch_formulation_bit_for_bit(name):
    spec = SPECS[name]
    x, y, h = particles(spec, 20000, seed=len(name))
    support = get_kernel("cubic_spline").support_factor
    geoms, bounds, geom_tuples = T._assign_setup(spec, T.PALLAS_LEVELS)
    xs, ys, ht = torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(h)
    key_c, u_c, v_c = T._native_assign(xs, ys, ht, spec, support, bounds, geom_tuples)
    key_t, u_t, v_t = T._assign_keys(xs, ys, ht, spec, support, bounds, geom_tuples)
    assert key_c.dtype == key_t.dtype == torch.int32
    assert torch.equal(key_c, key_t)
    assert torch.equal(u_c.view(torch.int32), u_t.view(torch.int32))
    assert torch.equal(v_c.view(torch.int32), v_t.view(torch.int32))
    # the inputs reach every populated level and the oversize route
    levels = set((key_t // T._LEVEL_STRIDE).tolist())
    assert len(geoms) in levels and len(levels) >= 3


@pytest.mark.parametrize("threads", [2, 5])
def test_assign_tiles_split_over_threads_equals_one_pass(threads, monkeypatch):
    spec = SPECS["periodic_1024"]
    x, y, h = particles(spec, 20011, seed=9)
    support = get_kernel("cubic_spline").support_factor
    _, bounds, geom_tuples = T._assign_setup(spec, T.PALLAS_LEVELS)
    xs, ys, ht = torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(h)
    one = T._native_assign(xs, ys, ht, spec, support, bounds, geom_tuples)
    monkeypatch.setattr(native, "_MIN_SPAN", 1000)
    monkeypatch.setattr(native.os, "sched_getaffinity", lambda pid: set(range(threads)))
    assert len(native._spans(x.shape[0])) == threads
    split = T._native_assign(xs, ys, ht, spec, support, bounds, geom_tuples)
    for a, b in zip(one, split):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_single_level_coords_equal_the_torch_formulation(name):
    spec = SPECS[name]
    x, y, _ = particles(spec, 5000, seed=7)
    geom = T._level_geometry(T.PALLAS_LEVELS[0], spec)
    xs, ys = torch.from_numpy(x), torch.from_numpy(y)
    got = T._tile_local_coords(xs, ys, geom, spec)  # host f64: the native pass
    # the torch branch of _tile_local_coords, written out
    u, v = T._pixel_coords(xs, ys, spec)
    tx_i = torch.clamp((u / geom.tx).to(torch.int32), 0, geom.n_tiles_x - 1)
    ty_i = torch.clamp((v / geom.cfg.TY).to(torch.int32), 0, geom.n_tiles_y - 1)
    ref = (
        ty_i * geom.n_tiles_x + tx_i,
        (u - (tx_i * geom.tx - geom.cfg.M)).to(torch.float32),
        (v - (ty_i * geom.cfg.TY - geom.cfg.M)).to(torch.float32),
    )
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("name", ["periodic_64", "open_48x40"])
def test_tile_particles_layout_from_the_native_pass(name, monkeypatch):
    spec = SPECS[name]
    x, y, h = particles(spec, 3000, seed=3)
    values = np.random.default_rng(4).uniform(0.5, 1.5, (2, 3000)).astype(np.float32)
    native_tp = T.tile_particles(x, y, h, values, spec, device="cpu")
    monkeypatch.setattr(T, "_native_assign", T._assign_keys)
    plain_tp = T.tile_particles(x, y, h, values, spec, device="cpu")
    for f in ("sorted_u", "sorted_v", "sorted_h", "sorted_values", "sorted_tile", "perm"):
        assert torch.equal(getattr(native_tp, f), getattr(plain_tp, f)), f
    assert native_tp.geoms == plain_tp.geoms and native_tp.n_oversize == plain_tp.n_oversize


def test_scale_cast_matches_numpy():
    rng = np.random.default_rng(1)
    for dt in (np.float64, np.float32):
        a = rng.uniform(-1e8, 1e8, 10000).astype(dt)
        got = native.scale_cast(a, 1.989e-13)
        ref = (a.astype(np.float64) * 1.989e-13).astype(np.float32)
        assert got.dtype == np.float32 and np.array_equal(got.view(np.int32), ref.view(np.int32))
    with pytest.raises(TypeError):
        native.scale_cast(np.arange(4), 2.0)


@pytest.mark.parametrize("order", ["morton", "random"])
@pytest.mark.parametrize("n", [1, 4096, 50_001])
def test_morton_delta_encode_matches_numpy(order, n):
    rng = np.random.default_rng(n)
    xq = rng.integers(0, 65536, n).astype(np.uint16)
    yq = rng.integers(0, 65536, n).astype(np.uint16)
    if order == "morton":
        o = np.argsort(P._interleave16(xq, yq), kind="stable")
        xq, yq = xq[o], yq[o]
    got = native.morton_delta_encode_u16(xq, yq, P._DELTA_CHUNK)
    for ref in (P.morton_delta_encode_plain(xq, yq), JP.morton_delta_encode(xq, yq)):
        assert got[4] == ref[4] == n
        for a, b in zip(got[:4], ref[:4]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    if order == "random" and n > 1:
        assert got[2].size > 0  # the shuffled input fills the exception list


def test_failed_build_raises_with_the_compiler_message(tmp_path, monkeypatch):
    bad = tmp_path / "broken.c"
    bad.write_text("int f(void) { return undeclared_name; }\n")
    with pytest.raises(RuntimeError, match="undeclared_name"):
        _build.build_host(bad, tmp_path / "build")
    assert not list((tmp_path / "build").glob("*.so"))
    # no compiler at all: a RuntimeError that says so, no NumPy fallback
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C compiler"):
        _build.build_host(Path(bad), tmp_path / "build2")


def test_library_is_built_into_the_package_build_dir():
    lib = native.get_lib()
    path = _build.host_library_path()
    assert path.exists() and path.parent.name == "_build"
    assert lib.assign_tiles_f64.argtypes is not None
