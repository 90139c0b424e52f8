"""Port vs JAX: the streamed snapshot-to-map path as a whole.

The JAX package's ``benchmarks/e2e_1e8.py`` at 2^14 particles: its
``write_big_snapshot`` writes an 8-file EAGLE snapshot (half uniform, half
in 64 blobs, each file Morton-sorted at the wire's 65536 cells; h drawn for
this test's 64^2 map), and each package reads it back in 4 macro-chunks as
the benchmark's ``read_chunk`` does, for three wires:

- ``f32``: unit conversion on the host (``output_dtype = float32``);
- ``pack``: the converted arrays quantised (u16 positions, f16 h, f16
  fields with power-of-two scales);
- ``packdelta``: raw internal units packed with Morton-delta positions and
  u8-log fields, the unit factors folded into the device unpack (the
  benchmark's ``pos_encoding="auto"`` would fall back to u16 pairs here:
  2^14 particles in a 25 Mpc box are too sparse on the Morton curve for
  int16 deltas, so the test asks for ``"delta"``, exact through its
  exception list).

Each package reads with its own ``SnapshotEAGLE``: the arrays read are
equal bit for bit. They are packed once, by the port's packer (JAX's packs
the same bits for ``pack``; its u8 tier mishandles the benchmark's
prescales, see ``io/packing.py``), and both packages stream the same
chunks: ``stream_macro_chunks`` (the port on ``device="cpu"``) and the
unpack. The port deposits each chunk with its sorted engine
(``tile_particles`` + ``deposit_tiled``) and its coherent engine
(``deposit_2d_coherent``) on their plain kernel versions, and both packages
deposit each chunk's decoded particles, as f64 NumPy, on their sorted
engine's host-f64 quality path (the JAX package's kernel in interpret
mode). Maps are summed over the chunks.

Every bound is 1e-5 * max. On f32 coordinates both engines place each
particle at ``fl(fl(x / pixel) - tile origin)``: up to an ulp of a
tile-local coordinate, 2^-16 px, which is 6e-5 of the smallest footprint's
h (0.25 px) and moves its weight by ~1e-5 of the map's max. So the f32
maps are held to the f64 oracle (``oracles.project_oracle``) of the
particles as the sorted layout placed them, the placement to the decoded
coordinates within 2^-16 px, and the quality paths, which place in f64, to
the oracle of the decoded particles and to each other.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from astro_sph_tools_tpu import constants as JC
from astro_sph_tools_tpu.data_structures import ParticleType as JParticleType
from astro_sph_tools_tpu.io import packing as JP
from astro_sph_tools_tpu.io.eagle import SnapshotEAGLE as JSnapshotEAGLE
from astro_sph_tools_tpu.io.prefetch import stream_macro_chunks as j_stream_macro_chunks
from astro_sph_tools_tpu.ops.deposit import MapSpec as JMapSpec
from astro_sph_tools_tpu.ops.deposit_pallas import deposit_2d_auto as j_deposit_2d_auto
from astro_sph_tools_tpu_torch import constants as C
from astro_sph_tools_tpu_torch.data_structures import ParticleType
from astro_sph_tools_tpu_torch.io import packing as P
from astro_sph_tools_tpu_torch.io.eagle import SnapshotEAGLE
from astro_sph_tools_tpu_torch.io.prefetch import stream_macro_chunks
from astro_sph_tools_tpu_torch.ops import MapSpec, deposit_2d_auto, deposit_2d_coherent, deposit_tiled, tile_particles
from oracles import project_oracle

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5  # every map bound, as a fraction of the reference's max
PLACE_TOL = 2.0**-16  # px: an f32 ulp of a tile-local coordinate below 128 px
N_CHUNKS = 4
RES = 64
MASS_SCALE = 2.0**20  # the benchmark's power-of-two f16 scales
TEMP_SCALE = 2.0**16


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    spec = importlib.util.spec_from_file_location("e2e_1e8", os.path.join(ROOT, "benchmarks", "e2e_1e8.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    bench.RESOLUTION = RES  # h drawn for a 64^2 map of the 25 Mpc box
    first = bench.write_big_snapshot(str(tmp_path_factory.mktemp("e2e")), 1 << 14, n_files=2 * N_CHUNKS)
    return first, bench.BOX_MPC


def read_chunk(reader, gas, constants, first, wire, ci):
    """The reads of the benchmark's ``read_chunk`` with one package's
    reader, gas particle type and constants: the arrays it packs (or, for
    ``f32``, sends), and the unit factors it folds into the unpack."""
    snap = reader(first, process_index=ci, n_processes=N_CHUNKS)
    if wire == "packdelta":
        raw_pos = snap._read_dataset(gas, "Coordinates", trailing=(3,))
        return {
            "x": np.ascontiguousarray(raw_pos[:, 0]), "y": np.ascontiguousarray(raw_pos[:, 1]),
            "h": snap._read_dataset(gas, "SmoothingLength"), "m": snap._read_dataset(gas, "Mass"),
            "t": snap._read_dataset(gas, "Temperature"), "box": snap._box_internal,
            "s_len": snap.h**snap._length_h_exp * snap._length_cgs / constants.MEGAPARSEC_CGS,
            "s_mass": snap.h**snap._mass_h_exp * snap._mass_cgs / constants.SOLAR_MASS_CGS,
        }
    snap.output_dtype = np.float32
    pos = snap.get_positions(gas).to_value("Mpc")
    return {
        "x": np.ascontiguousarray(pos[:, 0]), "y": np.ascontiguousarray(pos[:, 1]),
        "h": snap.get_smoothing_lengths(gas).to_value("Mpc"), "m": snap.get_masses(gas).to_value("Msun"),
        "t": snap.get_temperatures(gas).to_value("K"),
    }


def pack_chunk(raw, wire, box):
    """The benchmark's packing of one chunk, by the port's packer (the JAX
    package's packs the same bits for ``pack``; for ``packdelta``'s u8
    fields with its f16 prescales it does not, see ``io/packing.py``)."""
    if wire == "f32":
        return (raw["x"], raw["y"], raw["h"], raw["m"], raw["t"])
    if wire == "pack":
        return P.pack_particles_host(raw["x"], raw["y"], raw["h"], [raw["m"], raw["t"]], box=box,
                                     field_scales=(MASS_SCALE, TEMP_SCALE))
    return P.pack_particles_host(
        raw["x"], raw["y"], raw["h"], [raw["m"], raw["t"]], box=raw["box"],
        pos_scale=raw["s_len"], h_scale=raw["s_len"],
        field_scales=(2.0**-14, TEMP_SCALE), field_unpack_scales=(raw["s_mass"] * 2.0**-14, TEMP_SCALE),
        pos_encoding="delta", field_dtype="u8",
    )


def j_to_device(host):
    """The benchmark's ``to_device``: ``jax.device_put`` of every leaf."""
    import dataclasses

    import jax

    put = jax.device_put
    if isinstance(host, tuple):
        return tuple(put(a) for a in host)
    return dataclasses.replace(
        host, x_q=None if host.x_q is None else put(host.x_q), y_q=None if host.y_q is None else put(host.y_q),
        h_q=put(host.h_q), fields_q=put(host.fields_q),
        pos_delta=None if host.pos_delta is None else (*(put(a) for a in host.pos_delta[:4]), host.pos_delta[4]),
        field_log_meta=None if host.field_log_meta is None else tuple(put(a) for a in host.field_log_meta),
    )


def decoded(item, unpack):
    if isinstance(item, tuple):
        x, y, h, m, t = item
        return x, y, h, m, t
    x, y, h, f = unpack(item)
    return x, y, h, f[0], f[1]


def placed(tp):
    """(x, y, h, values) in f64 of every particle as the sorted layout
    ``tp`` placed it: world coordinates of its f32 tile-local coordinates
    and its tile's origin (global pixel coordinates for oversize ones)."""
    x0, x1, y0, y1 = tp.spec.extent
    ny, nx = tp.spec.shape
    psx, psy = (x1 - x0) / nx, (y1 - y0) / ny
    u, v = tp.sorted_u.double().clone(), tp.sorted_v.double().clone()
    for geom, lo, count in tp.geoms:
        tile = tp.sorted_tile[lo:lo + count].long()
        u[lo:lo + count] += (tile % geom.n_tiles_x) * geom.tx - geom.cfg.M
        v[lo:lo + count] += (tile // geom.n_tiles_x) * geom.cfg.TY - geom.cfg.M
    return (x0 + u.numpy() * psx, y0 + v.numpy() * psy, tp.sorted_h.double().numpy(),
            tp.sorted_values.double().numpy())


@pytest.mark.parametrize("wire", ["f32", "pack", "packdelta"])
def test_streamed_wire_matches_jax_and_the_oracle(snapshot, wire):
    first, box = snapshot
    ours_raw = [read_chunk(SnapshotEAGLE, ParticleType.gas, C, first, wire, ci) for ci in range(N_CHUNKS)]
    theirs_raw = [read_chunk(JSnapshotEAGLE, JParticleType.gas, JC, first, wire, ci) for ci in range(N_CHUNKS)]
    for a, b in zip(ours_raw, theirs_raw):
        assert a.keys() == b.keys()
        for k in a:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype and np.array_equal(a[k], b[k]), k
    host = [pack_chunk(raw, wire, box) for raw in ours_raw]
    if wire == "pack":
        raw = theirs_raw[0]
        jp = JP.pack_particles_host(raw["x"], raw["y"], raw["h"], [raw["m"], raw["t"]], box=box,
                                    field_scales=(MASS_SCALE, TEMP_SCALE))
        for u, v in ((host[0].x_q, jp.x_q), (host[0].y_q, jp.y_q), (host[0].h_q, jp.h_q), (host[0].fields_q, jp.fields_q)):
            assert np.array_equal(u, v)
    if wire == "packdelta":
        assert all(c.pos_delta is not None and c.field_log_meta is not None for c in host)

    spec = MapSpec(shape=(RES, RES), extent=(0.0, box, 0.0, box), periodic_wrap=True)
    jspec = JMapSpec(shape=(RES, RES), extent=(0.0, box, 0.0, box), periodic_wrap=True)
    px = box / RES
    sorted_map = coherent_map = quality_map = jax_map = 0.0
    ours_parts, theirs_parts, placed_parts = [], [], []
    stream = stream_macro_chunks(lambda ci: host[ci], N_CHUNKS, prefetch_depth=1, device="cpu")
    for ci, item in enumerate(stream):
        x, y, h, m, t = decoded(item, lambda p: P.unpack_particles_device(p, device="cpu"))
        if wire == "packdelta":  # the unit factors fold into the unpack: masses in Msun
            truth = ours_raw[ci]["m"] * ours_raw[ci]["s_mass"]
            assert np.abs(m.numpy() / truth - 1.0).max() < 0.01
        values = torch.stack([m, m * t])
        tp = tile_particles(x, y, h, values, spec, need_perm=True, device="cpu")
        sorted_map = sorted_map + deposit_tiled(tp)
        coherent_map = coherent_map + deposit_2d_coherent(x, y, h, values, spec, device="cpu")
        quality_map = quality_map + deposit_2d_auto(x.double().numpy(), y.double().numpy(), h, values, spec,
                                                    device="cpu")
        xp, yp, hp, vp = placed(tp)
        for got, want in ((xp, x[tp.perm]), (yp, y[tp.perm])):  # the placement, in pixels
            assert np.abs(got - want.double().numpy()).max() <= PLACE_TOL * px
        placed_parts.append((xp, yp, hp, vp))
        ours_parts.append([a.numpy() for a in (x, y, h, m, t)])
    for item in j_stream_macro_chunks(lambda ci: host[ci], N_CHUNKS, prefetch_depth=1, to_device=j_to_device):
        x, y, h, m, t = (np.asarray(a) for a in decoded(item, JP.unpack_particles_device))
        jax_map = jax_map + np.asarray(j_deposit_2d_auto(
            x.astype(np.float64), y.astype(np.float64), h, np.stack([m, m * t]), jspec))
        theirs_parts.append([x, y, h, m, t])

    def oracle(x, y, h, values):
        return np.stack([project_oracle(x, y, h, v, (RES, RES), spec.extent, periodic=True) for v in values])

    def decoded_oracle(parts):
        x, y, h, m, t = (np.concatenate([p[i] for p in parts]).astype(np.float64) for i in range(5))
        mt = (np.float32(m) * np.float32(t)).astype(np.float64)  # the payload as both engines form it, f32
        return oracle(x, y, h, (m, mt))

    def within(got, ref):
        for f in range(2):
            assert np.abs(np.asarray(got[f]) - ref[f]).max() <= TOL * np.abs(ref[f]).max()

    placed_ref = oracle(*(np.concatenate([p[i] for p in placed_parts], axis=-1) for i in range(4)))
    within(sorted_map.numpy(), placed_ref)
    within(coherent_map.numpy(), placed_ref)
    within(coherent_map.numpy(), sorted_map.numpy())
    within(quality_map.numpy(), decoded_oracle(ours_parts))
    within(jax_map, decoded_oracle(theirs_parts))
    within(quality_map.numpy(), jax_map)
