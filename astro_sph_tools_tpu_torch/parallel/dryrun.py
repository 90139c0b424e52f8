"""One step of every multi-GPU entry point on an n-rank mesh, on tiny shapes.

Counterpart: ``__graft_entry__.py::dryrun_multichip`` of the JAX package,
its steps and assertions in its order: the particle-sharded 2D deposit, the
slab-sharded 3D deposit with its ring halo exchange, the distributed reorder
(int32 and int64 IDs), the sharded coherent engine (synced, then fused with
capacities merged over the mesh), the sharded halo cutouts, the sharded
sightline columns and spectra, and the even rebalance. The JAX function
drives a whole mesh from one process; here each rank runs it on its own
shard of the same seeded data, so every rank makes the data and takes its
part. (``__graft_entry__.entry``, a ``jax.jit`` compile check, has no
counterpart in eager torch.)

Run it with one process a card::

    torchrun --nproc-per-node=4 -m astro_sph_tools_tpu_torch.parallel.dryrun 4

(``--device cpu`` runs it over gloo on the CPU), or call
:func:`dryrun_multichip` on a process group the caller initialised (the tests
run it over gloo ranks on the CPU with ``device="cpu"``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data_structures import Cosmology
from ..ops import kernel_counters
from ..ops.deposit import MapSpec
from ..ops.deposit_coherent import caps_from_layout, tile_particles_coherent
from ..ops.grid3d import GridSpec
from ..render import render_halo_maps_sharded
from .coherent import caps_union_mesh, deposit_2d_coherent_sharded, deposit_2d_coherent_sharded_fused, pad_particles_mesh
from .mesh import make_mesh
from .rebalance import rebalance_evenly
from .reorder import distributed_reorder
from .sharded import deposit_2d_sharded, deposit_3d_sharded, pad_for_mesh, partition_particles_by_slab
from .sightlines import absorption_spectra_sharded, column_integrate_sharded


def _check(cond, what: str) -> None:
    if not bool(cond):
        raise AssertionError(f"dryrun_multichip: {what}")


def _finite(t) -> bool:
    return bool(torch.isfinite(torch.as_tensor(t)).all())


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the step on this rank's shard of the mesh of ``n_devices`` ranks
    of the initialised default process group, and check it as the JAX
    package does. Raises when there is no process group or when it does not
    have ``n_devices`` ranks (as :func:`make_mesh` does), and when a check
    fails. ``device`` defaults to this rank's card. Returns what the step
    did: its seconds a step, the kernels' launches, the shapes."""
    mesh = make_mesh(n_devices, device=device)
    n_dev, rank = mesh.size, mesh.rank
    dev = mesh.device
    kernels = kernel_counters()
    before = {name: fn.launches for name, fn in kernels.items()}
    steps = {}
    rng = np.random.default_rng(0)
    box = 8.0
    n = 2048
    chunk = 128

    def block(a, i, per):
        return a[i * per:(i + 1) * per]

    # --- 2D: particle-sharded deposit + one all_reduce ---
    t0 = time.perf_counter()
    spec2d = MapSpec(shape=(64, 64), extent=(0.0, box, 0.0, box))
    x = rng.uniform(0, box, n)
    y = rng.uniform(0, box, n)
    h = np.full(n, 0.15)
    m = rng.uniform(0.5, 2.0, n)
    t = rng.uniform(1e4, 1e6, n)
    fields = np.stack([m, m * t], axis=1)
    xp, yp, hp, fp = pad_for_mesh([x, y, h, fields], n_dev, chunk, pad_values=[0, 0, 1.0, 0])
    per = xp.shape[0] // n_dev
    img = deposit_2d_sharded(
        *(block(a, rank, per).astype(np.float32) for a in (xp, yp, hp, fp)), spec2d, mesh, K=8, engine="pallas"
    )
    _check(tuple(img.shape) == (64, 64, 2), f"2D map shape {tuple(img.shape)}")
    _check(_finite(img), "non-finite 2D map")
    steps["deposit_2d_sharded"] = time.perf_counter() - t0

    # --- 3D: slab-sharded grid with the ring halo exchange ---
    t0 = time.perf_counter()
    nz = 8 * n_dev
    spec3d = GridSpec(shape=(nz, 16, 16), extent=(0.0, box, 0.0, box, 0.0, box), periodic_wrap=True)
    pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
    h3 = np.full(n, 0.05, np.float32)
    m3 = rng.uniform(0.5, 2.0, n).astype(np.float32)
    pp, hp3, mp3 = partition_particles_by_slab(pos, h3, m3, spec3d, n_dev, chunk=chunk)
    per3 = pp.shape[0] // n_dev
    slab = deposit_3d_sharded(
        block(pp, rank, per3), block(hp3, rank, per3), block(mp3, rank, per3), spec3d, mesh, K=4, chunk=chunk
    )
    _check(tuple(slab.shape) == (nz // n_dev, 16, 16), f"3D slab shape {tuple(slab.shape)}")
    _check(_finite(slab), "non-finite 3D slab")
    steps["deposit_3d_sharded"] = time.perf_counter() - t0

    # --- distributed ID-matched reorder: all_to_all bucket exchange ---
    t0 = time.perf_counter()
    n_ids = n_dev * 64
    src_ids = rng.permutation(n_ids).astype(np.int32)
    tgt_ids = rng.permutation(n_ids).astype(np.int32)
    data = rng.normal(size=n_ids).astype(np.float32)
    _, matched, overflow = distributed_reorder(
        block(src_ids, rank, 64), block(data, rank, 64), block(tgt_ids, rank, 64), mesh
    )
    _check(bool(matched.all()) and not overflow, "int32 reorder left targets unmatched")
    # int64 IDs beyond 2^32 keep their full range
    src64 = np.int64(2) ** 40 + rng.permutation(n_ids).astype(np.int64) * 3
    tgt64 = rng.permutation(src64)
    _, matched64, overflow64 = distributed_reorder(
        block(src64, rank, 64), block(data, rank, 64), block(tgt64, rank, 64), mesh
    )
    _check(bool(matched64.all()) and not overflow64, "int64 reorder left targets unmatched")
    steps["distributed_reorder"] = time.perf_counter() - t0

    # --- the coherent-order engine per particle shard + one all_reduce ---
    t0 = time.perf_counter()
    n_coh = n_dev * 2048
    spec_coh = MapSpec(shape=(64, 64), extent=(0.0, box, 0.0, box), periodic_wrap=True)
    px = box / 64
    xc = rng.uniform(0, box, n_coh).astype(np.float32)
    yc = rng.uniform(0, box, n_coh).astype(np.float32)
    hc = np.exp(rng.normal(np.log(0.6 * px), 0.7, n_coh)).clip(0.05 * px, 6.0 * px).astype(np.float32)
    mc = rng.uniform(0.5, 2.0, n_coh).astype(np.float32)
    fc = np.stack([mc, mc * rng.uniform(1, 2, n_coh).astype(np.float32)])
    xcp, ycp, hcp, fcp = pad_particles_mesh(xc, yc, hc, fc, spec_coh, n_dev)
    per_c = xcp.size // n_dev
    mine = slice(rank * per_c, (rank + 1) * per_c)
    shard = (xcp[mine], ycp[mine], hcp[mine], fcp[:, mine])
    img_coh = deposit_2d_coherent_sharded(*shard, spec_coh, mesh, precision="f32")
    _check(tuple(img_coh.shape) == (2, 64, 64) and _finite(img_coh), "coherent sharded map")
    steps["deposit_2d_coherent_sharded"] = time.perf_counter() - t0

    # --- the zero-sync fused engine: each rank calibrates its shard, the
    # capacities are merged over the mesh ---
    t0 = time.perf_counter()
    caps = caps_union_mesh(caps_from_layout(tile_particles_coherent(*shard, spec_coh, device=dev)), mesh)
    img_fused, ok = deposit_2d_coherent_sharded_fused(*shard, spec_coh, mesh, caps, precision="f32")
    _check(bool(ok), "fused coherent capacities overflowed")
    _check(torch.allclose(img_fused, img_coh, rtol=2e-5, atol=1e-6), "fused and synced coherent maps differ")
    steps["deposit_2d_coherent_sharded_fused"] = time.perf_counter() - t0

    # --- halo-centric cutouts summed over the mesh ---
    t0 = time.perf_counter()
    centres = rng.uniform(0, box, (4, 3)).astype(np.float32)
    radii = rng.uniform(0.4, 0.9, 4).astype(np.float32)
    edges = np.linspace(0, n, n_dev + 1).astype(int)
    lo, hi = edges[rank], edges[rank + 1]
    stacks = render_halo_maps_sharded(
        pos[lo:hi], h3[lo:hi], m3[lo:hi], centres, radii, [0, 3], mesh, box=box, resolution=32
    )
    _check(len(stacks) == 2, f"{len(stacks)} halo stacks")
    for st in stacks:
        _check(np.isfinite(np.asarray(st["surface_density"])).all(), "non-finite halo cutout")
    steps["render_halo_maps_sharded"] = time.perf_counter() - t0

    # --- sightline columns and spectra: additive per-ray partials ---
    t0 = time.perf_counter()
    n_rays = 16
    rx = rng.uniform(0, box, n_rays)
    ry = rng.uniform(0, box, n_rays)
    hs = np.exp(rng.normal(np.log(0.12), 0.4, n)).clip(0.03, 0.6)
    vals = rng.uniform(0.5, 2.0, n).astype(np.float32)
    cols = column_integrate_sharded(
        [(pos[lo:hi, 0], pos[lo:hi, 1], hs[lo:hi], vals[lo:hi])], rx, ry, periodic_box=box, mesh=mesh
    )
    _check(tuple(cols.shape) == (n_rays,) and _finite(cols), "sharded columns")
    vpec = rng.normal(0, 60, n).astype(np.float32)
    temp = (10 ** rng.uniform(4, 6, n)).astype(np.float32)
    cosmo = Cosmology.from_redshift(0.5, 0.6777, 0.0482)
    tau, v_centres = absorption_spectra_sharded(
        [(pos[lo:hi], hs[lo:hi], vals[lo:hi], vpec[lo:hi], temp[lo:hi])], rx, ry,
        cosmology=cosmo, box_size=box, n_bins=128, mesh=mesh,
    )
    _check(tuple(tau.shape) == (n_rays, 128) and _finite(tau), "sharded spectra")
    _check(np.isfinite(np.asarray(v_centres)).all(), "non-finite velocity bins")
    steps["sightlines_sharded"] = time.perf_counter() - t0

    # --- even shard rebalance of a skewed distribution ---
    t0 = time.perf_counter()
    shard_len = 256
    counts = [shard_len] + [4] * (n_dev - 1)  # one shard nearly full
    offsets = np.concatenate([[0], np.cumsum(counts)])
    gx = np.zeros(shard_len, np.float32)
    gx[:counts[rank]] = np.arange(offsets[rank], offsets[rank + 1])
    (bal,), new_counts = rebalance_evenly([gx], np.asarray(counts), mesh)
    bounds = np.concatenate([[0], np.cumsum(new_counts)])
    got = bal[:int(new_counts[rank])].cpu().numpy()
    _check(np.array_equal(got, np.arange(bounds[rank], bounds[rank + 1], dtype=np.float32)),
           "rebalanced block out of global order")
    _check(int(new_counts.max() - new_counts.min()) <= 1, f"uneven rebalance {new_counts.tolist()}")
    steps["rebalance_evenly"] = time.perf_counter() - t0

    return {
        "rank": rank, "world": n_dev, "device": str(dev), "backend": mesh.backend,
        "step_seconds": steps,
        "launches": {name: fn.launches - before[name] for name, fn in kernels.items()},
    }


def main(argv: Optional[list] = None) -> int:
    """``python -m astro_sph_tools_tpu_torch.parallel.dryrun N`` under
    ``torchrun`` (which sets the rendezvous variables): NCCL on the cards,
    or gloo with ``--device cpu``. Raises when the card is asked for and
    there is none."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n_devices", type=int, nargs="?", default=int(os.environ.get("WORLD_SIZE", "1")),
                   help="ranks of the mesh (default: the world size torchrun set)")
    p.add_argument("--device", default="cuda", help="torch device type of every rank (default: the card)")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    n_devices = args.n_devices
    cpu = torch.device(args.device).type == "cpu"
    if not cpu:
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip: no CUDA device (pass --device cpu to run on the CPU)")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("gloo" if cpu else "nccl")
    try:
        out = dryrun_multichip(n_devices, device="cpu" if cpu else None)
        if out["rank"] == 0:
            print(
                f"dryrun_multichip({n_devices}): 2D particle-sharded deposit, 3D slab-sharded "
                "ring-exchange deposit, sharded coherent-order deposit (synced + zero-sync fused), "
                "distributed reorder (int32 + int64 IDs), even shard rebalancing, halo-centric "
                "sharded cutouts, sharded sightline columns and absorption spectra ran OK: "
                f"{out}", flush=True,
            )
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
