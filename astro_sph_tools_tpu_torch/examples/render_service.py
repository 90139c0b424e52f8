"""Resident render-service pattern: one synced calibration, then zero-sync
fused renders of a stream of snapshot chunks.

Counterpart: ``examples/render_service.py`` of the JAX package. A map
service renders a stream of snapshot chunks against a fixed map geometry:

1. **Calibration**: chunk 0 runs the synced coherent engine
   (``tile_particles_coherent`` + ``deposit_coherent``), whose one host
   sync reads the layout's counts; ``caps_from_layout`` turns them into
   capacities for every later chunk.
2. **Fused renders**: chunks 1+ run ``deposit_2d_coherent_fused``, which
   sizes everything from the capacities and makes no host sync; its
   on-device ``ok`` flags are read once, at the end (a real service would
   re-render a chunk whose flag is False through the synced engine).

On a card both run the row-prep kernel (#3), the coherent deposit kernel
(#2) and the sorted engine's kernel (#1) on the routed tails. The JAX
example's ``donate=True`` lets XLA reuse the input buffers for the layout;
PyTorch has no buffer donation, and the chunks here are freed when the next
one replaces them. Its compile-reuse argument has no counterpart either:
nothing is compiled per shape.

    python -m astro_sph_tools_tpu_torch.examples.render_service [--device cuda]
        [--n-log2 25 --res 1024 --chunks 4]

The defaults are near the JAX example's sizes (2^17 particles a chunk where
it has 120,000; 256^2);
``--n-log2 25 --res 1024 --chunks 4`` is one card's share of the north-star
render (2^27 particles, 1024^2, two fields).
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

BOX = 25.0


def synthetic_chunk(rng, n: int, box: float, px: float):
    """A snapshot-ordered clustered chunk (a stand-in for one macro-chunk of
    a snapshot read; ``io.prefetch.stream_macro_chunks`` is the IO side):
    (x, y, h, [m, m T]) as f32 NumPy arrays, the JAX example's draws."""
    cx = rng.uniform(0, box, n)
    cy = rng.uniform(0, box, n)
    # 32 x 32 storage cells: a 2048-particle row spans one or two cells
    cell = np.floor(cy / (box / 32)).astype(int) * 32 + np.floor(cx / (box / 32)).astype(int)
    order = np.argsort(cell.astype(np.int16), kind="stable")  # cells < 1024: a radix sort
    x, y = cx[order].astype(np.float32), cy[order].astype(np.float32)
    dens = rng.uniform(0.3, 3.0, 1024)[cell[order]]
    h = np.clip(0.6 * px * dens ** (-1 / 3) * np.exp(0.5 * rng.normal(size=n)), 0.05 * px, 12.0 * px).astype(
        np.float32
    )
    m = rng.uniform(0.5, 2.0, n).astype(np.float32)
    t = rng.uniform(1e4, 1e6, n).astype(np.float32)
    return x, y, h, np.stack([m, m * t])


def chunks(n: int, res: int, n_chunks: int, seed: int = 0):
    """The service's chunk stream, chunk by chunk (the same arrays on every
    call with the same arguments)."""
    rng = np.random.default_rng(seed)
    for _ in range(n_chunks):
        yield synthetic_chunk(rng, n, BOX, BOX / res)


def run(n: int = 1 << 17, res: int = 256, n_chunks: int = 4, device="cuda", seed: int = 0,
        keep: bool = False) -> dict:
    """Render ``n_chunks`` chunks of ``n`` particles into one (2, res, res)
    map on ``device``. Returns the summed map (``"map"``, a tensor), each
    chunk's wall in seconds (synchronised), its engine, the ``ok`` flags of
    the fused chunks, the calibration layout's statistics and capacities;
    with ``keep`` also the chunks' host arrays (``"chunks"``)."""
    from ..ops import MapSpec, caps_from_layout, deposit_2d_coherent_fused, deposit_coherent, tile_particles_coherent

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("render_service: no CUDA device (pass --device cpu to run on the CPU)")
    spec = MapSpec(shape=(res, res), extent=(0, BOX, 0, BOX), periodic_wrap=True)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    total, caps, stats = None, None, None
    walls, engines, pending, kept = [], [], [], []
    for ci, (x, y, h, fields) in enumerate(chunks(n, res, n_chunks, seed)):
        if keep:
            kept.append((x, y, h, fields))
        sync()
        t0 = time.perf_counter()
        if caps is None:
            layout = tile_particles_coherent(x, y, h, fields, spec, device=device)
            caps = caps_from_layout(layout)
            maps = deposit_coherent(layout)
            stats = {k: layout.stats[k] for k in ("coherent_fraction", "n_candidates", "routed_particles")}
            engines.append("synced calibration")
            del layout
        else:
            maps, ok = deposit_2d_coherent_fused(x, y, h, fields, spec, caps, device=device)
            pending.append(ok)
            engines.append("fused zero-sync")
        total = maps if total is None else total + maps
        sync()
        walls.append(time.perf_counter() - t0)
    # the deferred capacity checks: one host read at the end
    ok_flags = [bool(v) for v in torch.stack(pending).cpu()] if pending else []
    return {"map": total, "chunk_wall_s": walls, "engines": engines, "ok": ok_flags, "calibration": stats,
            "caps": {"b0": caps.b0, "bucket_caps": list(caps.bucket_caps), "level_caps": list(caps.level_caps)},
            "n_per_chunk": n, "res": res, "device": str(device), **({"chunks": kept} if keep else {})}


def main(argv: Optional[list] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    p.add_argument("--n-log2", type=int, default=17, help="particles a chunk, as a power of two")
    p.add_argument("--res", type=int, default=256, help="map side in pixels")
    p.add_argument("--chunks", type=int, default=4, help="chunks in the stream")
    args = p.parse_args(argv)
    out = run(1 << args.n_log2, args.res, args.chunks, args.device)
    for ci, (wall, engine) in enumerate(zip(out["chunk_wall_s"], out["engines"])):
        print(f"chunk {ci + 1}/{args.chunks}: {wall * 1e3:9.1f} ms  {engine}", flush=True)
    if not all(out["ok"]):
        bad = [ci + 1 for ci, ok in enumerate(out["ok"]) if not ok]
        raise RuntimeError(f"capacity overflow on chunks {bad}: re-render them synced")
    sigma, sig_t = (a.double().cpu().numpy() for a in out["map"])
    mean_t = np.where(sigma > 0, sig_t / np.maximum(sigma, 1e-30), 0.0)
    out["sigma_sum"] = float(sigma.sum())
    out["mean_t_range"] = [float(mean_t[mean_t > 0].min()), float(mean_t.max())]
    print(f"final map: sigma sum={out['sigma_sum']:.3e}, T range=[{out['mean_t_range'][0]:.2e}, "
          f"{out['mean_t_range'][1]:.2e}] K", flush=True)
    return out


if __name__ == "__main__":
    main()
