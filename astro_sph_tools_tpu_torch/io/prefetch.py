"""Host->device streaming with background prefetch.

Counterpart: ``astro_sph_tools_tpu/io/prefetch.py``. Particle data is read
(and packed) on a background thread and copied to the card ahead of
consumption, so that the deposit of one chunk overlaps the read and the
host-to-device copy of the next.

The default copy to a CUDA device (``_H2DCopier``) stages each host array
in a pinned buffer (a copy from pageable memory with ``non_blocking=True``
is synchronous) and copies it to the card with ``non_blocking=True`` on a
side CUDA stream, which the producer thread makes its current stream
itself, with the device set. The consumer's stream waits on an event
recorded after a chunk's copies, and the chunk's tensors are recorded on
the consumer's stream (``record_stream``): they were allocated on the side
stream, and the caching allocator would otherwise hand their memory out
again as soon as they are freed, while the consumer's work on them may
still be queued. A pinned buffer is reused only after the event of the
copy that read it has completed.

Usage::

    for block in stream_particle_blocks(snap, ParticleType.gas,
                                        ["positions", "masses"],
                                        chunk_size=1 << 22):
        image = deposit_into(image, block["positions"], block["masses"], ...)
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch
from torch import Tensor

from ..data_structures.particle_types import ParticleType
from ..units import UnitArray
from .packing import host_leaf_to_tensor
from .snapshot import SnapshotBase

_SENTINEL = object()


def _tree_map(fn: Callable, tree):
    """``fn`` over every array leaf (NumPy array or tensor) of nested
    dicts, lists, tuples and dataclasses; other leaves are kept."""
    if isinstance(tree, (np.ndarray, Tensor)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(
            tree, **{f.name: _tree_map(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree)}
        )
    return tree


@dataclasses.dataclass
class _Delivery:
    """A chunk on the card, the event its copies end with, and the tensors
    the copies wrote (allocated on the side stream)."""

    value: object
    event: "torch.cuda.Event"
    tensors: list


class _H2DCopier:
    """Copies host arrays to one CUDA device through pinned buffers on a
    side stream. :meth:`copy` runs on the producer thread, with
    ``self.stream`` current."""

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self._staging: list = []  # (pinned uint8 buffer, event of the copy that last read it)
        self._written: list = []  # device tensors written since the last finish()

    def _pinned(self, nbytes: int) -> Tensor:
        """The smallest staged buffer that holds ``nbytes``, once the copy
        that last read it has completed; a new pinned buffer if none does."""
        fits = [i for i, (buf, _) in enumerate(self._staging) if buf.numel() >= nbytes]
        if not fits:
            return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        buf, event = self._staging.pop(min(fits, key=lambda i: self._staging[i][0].numel()))
        event.synchronize()
        return buf

    def copy(self, a) -> Tensor:
        if isinstance(a, Tensor) and a.device == self.device:
            return a
        src = a.contiguous() if isinstance(a, Tensor) else host_leaf_to_tensor(a)
        out = torch.empty(src.shape, dtype=src.dtype, device=self.device)
        if src.numel():
            buf = self._pinned(src.numel() * src.element_size())
            staged = buf[: src.numel() * src.element_size()].view(src.dtype).view(src.shape)
            staged.copy_(src)
            out.copy_(staged, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
            self._staging.append((buf, event))
        self._written.append(out)
        return out

    def finish(self, value) -> _Delivery:
        event = torch.cuda.Event()
        event.record(self.stream)
        written, self._written = self._written, []
        return _Delivery(value, event, written)


def _default_to_device(device) -> tuple[Callable, Optional[_H2DCopier]]:
    """The default ``to_device`` of the streams: pinned, side-stream copies
    for a CUDA device; CPU tensors (no copy where NumPy allows) otherwise."""
    device = torch.device(device)
    if device.type == "cuda":
        copier = _H2DCopier(device)
        return (lambda host: copier.finish(_tree_map(copier.copy, host))), copier
    if device.type == "cpu":
        return (lambda host: _tree_map(
            lambda a: a if isinstance(a, Tensor) else host_leaf_to_tensor(a), host
        )), None
    raise ValueError(f"no host-to-device copy for device {device}")


def _run_stream(produce: Callable, prefetch_depth: int, copier: Optional[_H2DCopier], name: str) -> Iterator:
    """Run ``produce(put)`` on a background thread and yield what it puts,
    in order. Exceptions in the producer propagate to the consumer. A
    consumer that stops early (``break``, an exception, garbage collection
    of the generator) releases a producer blocked on a full queue, which
    then ends: a leaked producer must not outlive its consumer and race
    later device work."""
    work: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch_depth))
    abandoned = threading.Event()
    consumer = torch.cuda.current_stream(copier.device) if copier is not None else None

    def put(item) -> bool:
        while not abandoned.is_set():
            try:
                work.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            if copier is not None:
                torch.cuda.set_device(copier.device)
                with torch.cuda.stream(copier.stream):
                    produce(put)
            else:
                produce(put)
            put(_SENTINEL)
        except Exception as err:  # propagate to the consumer
            put(err)

    thread = threading.Thread(target=producer, name=name, daemon=True)
    thread.start()
    try:
        while True:
            item = work.get()
            if item is _SENTINEL:
                break
            if isinstance(item, Exception):
                raise item
            if isinstance(item, _Delivery):
                consumer.wait_event(item.event)
                for t in item.tensors:
                    t.record_stream(consumer)
                item = item.value
            yield item
    finally:
        abandoned.set()
        while True:  # unblock a producer waiting on a full queue
            try:
                work.get_nowait()
            except queue.Empty:
                break
        thread.join(timeout=5.0)


def stream_particle_blocks(
    snapshot: SnapshotBase,
    particle_type: ParticleType,
    fields: Sequence[str],
    *,
    chunk_size: int = 1 << 22,
    prefetch_depth: int = 2,
    dtype=torch.float32,
    device_put: bool = True,
    device="cuda",
) -> Iterator[dict]:
    """Yield dicts of field chunks, read and copied ahead of consumption.

    ``fields`` name ``get_*`` getters without the prefix. Each yielded dict
    maps field -> tensor on ``device`` in ``dtype`` (NumPy arrays when
    ``device_put=False``) of at most ``chunk_size`` particles, plus
    ``"start"``/``"stop"`` global indices. A background thread keeps
    ``prefetch_depth`` chunks in flight; exceptions propagate to the
    consumer.
    """
    # full columns once (the readers concatenate per process), then slices
    host: dict[str, np.ndarray] = {}
    for name in fields:
        value = getattr(snapshot, f"get_{name}")(particle_type)
        if isinstance(value, UnitArray):
            value = value.value
        host[name] = np.asarray(value)
    n = host[fields[0]].shape[0]
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    to_device, copier = _default_to_device(device) if device_put else (None, None)

    def produce(put):
        for start in range(0, n, chunk_size):
            stop = min(start + chunk_size, n)
            block = {name: host[name][start:stop] for name in fields}
            if device_put:
                block = to_device({k: np.asarray(v, np_dtype) for k, v in block.items()})
                if isinstance(block, _Delivery):
                    block.value.update(start=start, stop=stop)
                else:
                    block.update(start=start, stop=stop)
            else:
                block.update(start=start, stop=stop)
            if not put(block):
                return

    yield from _run_stream(produce, prefetch_depth, copier, "ast-prefetch")


def streamed_deposit_2d(
    snapshot: SnapshotBase,
    particle_type: ParticleType,
    spec,
    *,
    axis=None,
    K: int = 8,
    chunk_size: int = 1 << 22,
    device_chunk: int = 8192,
    kernel: str = "cubic_spline",
    device="cuda",
) -> Tensor:
    """Streaming surface-density deposit: IO chunks overlap device compute.

    Each block goes through the fixed-window stencil engine
    (``ops/deposit.py::_stencil_level_pass``, a K x K window, which suits
    bounded-h streaming ingest); returns the accumulated (ny, nx) map on
    ``device``.
    """
    from ..data_structures.particle_types import CoordinateAxes
    from ..ops.deposit import _stencil_level_pass

    axis = axis or CoordinateAxes.Z
    i, j = axis.projection_plane
    ny, nx = spec.shape
    image_flat = torch.zeros((ny * nx, 1), dtype=torch.float32, device=device)
    for block in stream_particle_blocks(
        snapshot, particle_type, ["positions", "smoothing_lengths", "masses"],
        chunk_size=chunk_size, device=device,
    ):
        pos = block["positions"]
        image_flat = _stencil_level_pass(
            image_flat, pos[:, i], pos[:, j], block["smoothing_lengths"], block["masses"][:, None], None,
            K=K, spec=spec, kernel_name=kernel, projection="kernel3d", chunk=device_chunk,
        )
    return image_flat.reshape(ny, nx)


def stream_macro_chunks(
    read_chunk: Callable,
    n_chunks: int,
    *,
    prefetch_depth: int = 1,
    to_device: Optional[Callable] = None,
    n_readers: int = 1,
    device="cuda",
) -> Iterator:
    """Macro-chunk pipeline: the read (and pack) and the host-to-device copy
    of chunk k+1 overlap the device work on chunk k.

    ``read_chunk(ci)`` returns a nest of NumPy arrays (tuples, lists,
    dicts, dataclasses such as ``PackedParticles``). The background thread
    copies it to ``device`` at once (``to_device``; by default pinned
    staging and a side CUDA stream, see the module's docstring, with
    ``uint16``/``uint32`` leaves as ``io.packing.host_leaf_to_tensor``
    gives them), so the copy of chunk k+1 is done or in flight when the
    consumer asks for it. ``prefetch_depth`` bounds the chunks waiting on
    the card.

    ``n_readers > 1`` fans the reads over a thread pool (NumPy, h5py and
    the native pack release the GIL); chunks are still delivered in order,
    and the one producer thread serialises the copies.
    """
    copier = None
    if to_device is None:
        to_device, copier = _default_to_device(device)

    def produce(put):
        if n_readers > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=n_readers, thread_name_prefix="ast-reader") as pool:
                # at most n_readers + prefetch_depth chunks in flight,
                # delivered strictly in order
                pending = {}
                next_submit = 0
                for ci in range(n_chunks):
                    while next_submit < n_chunks and len(pending) < n_readers + prefetch_depth:
                        pending[next_submit] = pool.submit(read_chunk, next_submit)
                        next_submit += 1
                    host = pending.pop(ci).result()
                    if not put(to_device(host)):
                        for fut in pending.values():
                            fut.cancel()
                        return
        else:
            for ci in range(n_chunks):
                if not put(to_device(read_chunk(ci))):
                    return

    yield from _run_stream(produce, prefetch_depth, copier, "ast-macro-prefetch")
