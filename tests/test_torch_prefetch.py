"""Port vs JAX: the streaming prefetch pipeline (``io/prefetch.py``).

On the CPU (the pinned, side-stream copy runs only on the card, where
``chip_smoke.py`` phase 20 drives it):

- ``stream_particle_blocks`` yields every particle once, in order, with
  ``start``/``stop``, as NumPy (``device_put=False``) or as CPU tensors,
  equal to JAX's blocks; exceptions in the producer reach the consumer;
- ``stream_macro_chunks`` delivers in order with ``n_readers > 1`` and
  jittered reads, propagates a reader's error, and its default copy turns
  uint16 / uint32 leaves into int16 bits / int64 (``packed_to_tensors``'s
  dtypes) inside dataclasses and tuples;
- a consumer that stops early (``close``, an exception in its loop) leaves
  no live ``ast-*`` thread, also with a producer blocked on a full queue;
- ``streamed_deposit_2d`` against JAX's within 1e-5 * max (both in f32) and
  against the f64 oracle within 1e-5 * max (h clamped into the K = 8
  window, as the JAX package's test does).
"""

import threading
import time
from dataclasses import dataclass

import numpy as np
import pytest
import torch

from astro_sph_tools_tpu.data_structures import ParticleType as JParticleType
from astro_sph_tools_tpu.io.eagle import SnapshotEAGLE as JSnapshotEAGLE
from astro_sph_tools_tpu.io.prefetch import stream_particle_blocks as j_stream_blocks
from astro_sph_tools_tpu.io.prefetch import streamed_deposit_2d as j_streamed_deposit_2d
from astro_sph_tools_tpu.io.synthetic import SyntheticSnapshotSpec, write_snapshot
from astro_sph_tools_tpu.ops.deposit import MapSpec as JMapSpec
from astro_sph_tools_tpu.units import unit_array as j_unit_array
from astro_sph_tools_tpu_torch.data_structures import ParticleType
from astro_sph_tools_tpu_torch.io.eagle import SnapshotEAGLE
from astro_sph_tools_tpu_torch.io.packing import pack_particles_host
from astro_sph_tools_tpu_torch.io.prefetch import stream_macro_chunks, stream_particle_blocks, streamed_deposit_2d
from astro_sph_tools_tpu_torch.ops import MapSpec
from astro_sph_tools_tpu_torch.units import unit_array
from oracles import project_oracle

TOL = 1e-5
H_CAP = 0.22  # Mpc: every footprint inside the K = 8 window at 64^2 over 10 Mpc


@pytest.fixture(scope="module")
def snap(tmp_path_factory):
    spec = SyntheticSnapshotSpec(n_gas=3000, n_dm=64, n_star=16, n_bh=2, n_files=2)
    path, truth = write_snapshot(str(tmp_path_factory.mktemp("stream_sim")), spec)
    return path, truth, spec


def live_threads(prefix="ast-"):
    return [t for t in threading.enumerate() if t.name.startswith(prefix) and t.is_alive()]


def wait_gone(prefix="ast-", timeout=6.0):
    t0 = time.monotonic()
    while live_threads(prefix) and time.monotonic() - t0 < timeout:
        time.sleep(0.05)
    return live_threads(prefix)


@pytest.mark.parametrize("device_put", [False, True])
def test_blocks_cover_everything_in_order_as_jax(snap, device_put):
    path, truth, spec = snap
    kw = dict(chunk_size=700)
    ours = list(stream_particle_blocks(SnapshotEAGLE(path), ParticleType.gas, ["masses", "positions"],
                                       device_put=device_put, device="cpu", **kw))
    theirs = list(j_stream_blocks(JSnapshotEAGLE(path), JParticleType.gas, ["masses", "positions"],
                                  device_put=False, **kw))
    assert [(b["start"], b["stop"]) for b in ours] == [(b["start"], b["stop"]) for b in theirs]
    assert ours[-1]["stop"] == spec.n_gas
    for a, b in zip(ours, theirs):
        for name in ("masses", "positions"):
            got = a[name]
            if device_put:
                assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
                np.testing.assert_array_equal(got.numpy(), np.asarray(b[name], np.float32))
            else:
                np.testing.assert_array_equal(got, b[name])


def test_producer_exception_propagates(snap):
    path, *_ = snap
    with pytest.raises(AttributeError):
        list(stream_particle_blocks(SnapshotEAGLE(path), ParticleType.gas, ["nonexistent_field"],
                                    chunk_size=100, device="cpu"))
    assert not wait_gone()


@pytest.mark.parametrize("n_readers", [1, 4])
def test_macro_chunks_deliver_in_order(n_readers):
    def read_chunk(ci):
        time.sleep(0.01 * ((ci * 7) % 3))  # jittered completion order
        return {"ci": np.asarray([ci])}

    got = [int(item["ci"][0]) for item in stream_macro_chunks(
        read_chunk, 12, prefetch_depth=2, n_readers=n_readers, device="cpu")]
    assert got == list(range(12))
    assert not wait_gone()


def test_reader_error_propagates():
    def read_chunk(ci):
        if ci == 3:
            raise RuntimeError("boom")
        return {"ci": np.asarray([ci])}

    with pytest.raises(RuntimeError, match="boom"):
        list(stream_macro_chunks(read_chunk, 6, n_readers=3, device="cpu"))
    assert not wait_gone()


@dataclass
class Box:
    a: np.ndarray
    pair: tuple
    label: str


def test_default_copy_maps_every_leaf():
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 10, 5000)
    packed = pack_particles_host(x, x[::-1].copy(), np.full(5000, 0.1), [x + 1.0], box=10.0,
                                 pos_encoding="delta", field_dtype="u8")

    def read_chunk(ci):
        return (packed, Box(np.arange(3, dtype=np.uint16), (np.arange(2, dtype=np.uint32), 7), "k"))

    (got_packed, box), = list(stream_macro_chunks(read_chunk, 1, device="cpu"))
    assert got_packed.pos_delta[0].dtype == torch.int16 and got_packed.pos_delta[1].dtype == torch.int64
    assert got_packed.pos_delta[4] == 5000 and got_packed.field_scales == packed.field_scales
    assert box.a.dtype == torch.int16 and box.pair[0].dtype == torch.int64 and box.pair[1] == 7
    assert box.label == "k"


@pytest.mark.parametrize("how", ["close", "consumer_error"])
def test_abandoned_streams_leave_no_thread(snap, how):
    path, *_ = snap
    makers = [
        lambda: stream_particle_blocks(SnapshotEAGLE(path), ParticleType.gas, ["masses"], chunk_size=64,
                                       prefetch_depth=1, device="cpu"),
        lambda: stream_macro_chunks(lambda ci: {"x": np.arange(ci, ci + 4, dtype=np.float32)}, 50,
                                    prefetch_depth=1, device="cpu"),
        lambda: stream_macro_chunks(lambda ci: {"x": np.arange(ci, ci + 4, dtype=np.float32)}, 50,
                                    prefetch_depth=1, n_readers=3, device="cpu"),
    ]
    for make in makers:
        if how == "close":
            stream = make()
            next(stream)
            time.sleep(0.3)  # let the producer fill the queue and block on put
            stream.close()
        else:
            # the loop drops its only reference to the stream as the error
            # leaves it, which closes the generator
            with pytest.raises(ValueError, match="consumer"):
                for _ in make():
                    time.sleep(0.3)
                    raise ValueError("consumer failed")
    assert not wait_gone()


def test_streamed_deposit_matches_jax_and_the_oracle(snap):
    path, truth, spec = snap
    ours_snap, theirs_snap = SnapshotEAGLE(path), JSnapshotEAGLE(path)

    def clamp(snapshot, units):
        class Clamped:
            def __getattr__(self, name):
                return getattr(snapshot, name)

            def get_smoothing_lengths(self, pt, **kw):
                h = snapshot.get_smoothing_lengths(pt, **kw).to_value("Mpc")
                return units(np.minimum(h, H_CAP), "Mpc")

        return Clamped()

    extent = (0.0, 10.0, 0.0, 10.0)
    ours = streamed_deposit_2d(clamp(ours_snap, unit_array), ParticleType.gas,
                               MapSpec(shape=(64, 64), extent=extent),
                               K=8, chunk_size=900, device_chunk=512, device="cpu").numpy()
    theirs = np.asarray(j_streamed_deposit_2d(clamp(theirs_snap, j_unit_array), JParticleType.gas,
                                              JMapSpec(shape=(64, 64), extent=extent),
                                              K=8, chunk_size=900, device_chunk=512))
    pos = truth.positions[JParticleType.gas]
    h = np.minimum(truth.smoothing[JParticleType.gas], H_CAP)
    ref = project_oracle(pos[:, 0], pos[:, 1], h, truth.masses[JParticleType.gas], (64, 64), extent)
    scale = np.abs(ref).max()
    assert np.abs(ours - theirs).max() <= TOL * np.abs(theirs).max()
    assert np.abs(ours - ref).max() <= TOL * scale
