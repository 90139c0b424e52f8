"""Multi-GPU rendering tour: the mesh-sharded engines, one process a card.

Counterpart: ``examples/multichip_render.py`` of the JAX package, which
drives a whole device mesh from one process. Here every rank of a
``torch.distributed`` process group makes the same seeded data, takes its
shard and calls ``parallel/`` on it:

1. the coherent-order adaptive deposit over the mesh (one ``all_reduce``
   of the map stack);
2. a slab-sharded 3D voxel cube with the ring halo exchange;
3. the distributed ID-matched reorder;
4. sightline columns over particle shards.

Run it with one process a card (NCCL)::

    torchrun --nproc-per-node=4 -m astro_sph_tools_tpu_torch.examples.multichip_render

or, on the CPU, ``--device cpu`` (gloo); :func:`run` takes a mesh the
caller built over its own process group.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..parallel._comm import all_reduce_


def run(mesh, n: int = 200_000, n_3d: int = 50_000, ids_per_rank: int = 4096, n_rays: int = 64) -> dict:
    """The four steps on this rank's shard of ``mesh``; returns their
    numbers (the same on every rank where they are reduced over the mesh)."""
    from ..ops import GridSpec, MapSpec
    from ..parallel import (
        column_integrate_sharded,
        deposit_2d_coherent_sharded,
        deposit_3d_sharded,
        distributed_reorder,
        pad_particles_mesh,
        partition_particles_by_slab,
    )

    n_dev, rank, dev = mesh.size, mesh.rank, mesh.device
    rng = np.random.default_rng(11)
    box = 20.0
    out = {"rank": rank, "world": n_dev, "device": str(dev)}

    # --- 1. the coherent engine over the mesh: snapshot-ordered particles ---
    spec = MapSpec(shape=(256, 256), extent=(0, box, 0, box), periodic_wrap=True)
    px = box / 256
    x = rng.uniform(0, box, n).astype(np.float32)
    y = rng.uniform(0, box, n).astype(np.float32)
    order = np.argsort((x // (16 * px)).astype(np.int64) * 1024 + (y // (16 * px)))
    x, y = x[order], y[order]
    h = np.exp(rng.normal(np.log(0.6 * px), 0.7, n)).clip(0.05 * px, 10 * px)
    m = rng.uniform(0.5, 2.0, n).astype(np.float32)
    t = rng.uniform(1e4, 1e6, n).astype(np.float32)
    xp, yp, hp, fp = pad_particles_mesh(x, y, h.astype(np.float32), np.stack([m, m * t]), spec, n_dev)
    per = xp.size // n_dev
    mine = slice(rank * per, (rank + 1) * per)
    stack = deposit_2d_coherent_sharded(xp[mine], yp[mine], hp[mine], fp[:, mine], spec, mesh)
    sigma, sig_t = (a.double().cpu().numpy() for a in stack)
    mean_t = np.where(sigma > 0, sig_t / np.maximum(sigma, 1e-30), 0.0)
    out["coherent"] = {"shape": list(stack.shape), "mass_weight": float(sigma.sum() * px * px),
                       "mean_t_range": [float(mean_t[mean_t > 0].min()), float(mean_t.max())]}
    out["coherent_map"] = stack

    # --- 2. 3D cube: slab-sharded along z, ring halo exchange ---
    nz = 8 * n_dev
    gspec = GridSpec(shape=(nz, 64, 64), extent=(0, box, 0, box, 0, box), periodic_wrap=True)
    pos = rng.uniform(0, box, (n_3d, 3)).astype(np.float32)
    h3 = rng.uniform(0.2, 0.8, n_3d).astype(np.float32)
    m3 = rng.uniform(0.5, 2.0, n_3d).astype(np.float32)
    pp, hp3, mp3 = partition_particles_by_slab(pos, h3, m3, gspec, n_dev, chunk=512)
    per3 = pp.shape[0] // n_dev
    b3 = slice(rank * per3, (rank + 1) * per3)
    slab = deposit_3d_sharded(pp[b3], hp3[b3], mp3[b3], gspec, mesh, K=4, chunk=512)
    vox = (box / nz) * (box / 64) ** 2
    cube_mass = all_reduce_(slab.double().sum().reshape(1), mesh)
    out["cube"] = {"slab_shape": list(slab.shape), "mass": float(cube_mass) * vox, "true_mass": float(m3.sum())}
    out["cube_slab"] = slab

    # --- 3. distributed ID-matched reorder ---
    n_ids = n_dev * ids_per_rank
    src_ids = rng.permutation(n_ids).astype(np.int32)
    tgt_ids = rng.permutation(n_ids).astype(np.int32)
    data = rng.normal(size=n_ids).astype(np.float32)
    bi = slice(rank * ids_per_rank, (rank + 1) * ids_per_rank)
    got, matched, _ = distributed_reorder(src_ids[bi], data[bi], tgt_ids[bi], mesh)
    want = data[np.argsort(src_ids)][np.argsort(np.argsort(tgt_ids))][bi]
    exact = torch.tensor([int(np.array_equal(got.cpu().numpy(), want)), int(bool(matched.all()))], device=dev)
    all_reduce_(exact, mesh, "min")
    out["reorder"] = {"exact": bool(exact[0]), "matched": bool(exact[1])}

    # --- 4. sightline columns, data-parallel over particle shards ---
    rx = rng.uniform(0, box, n_rays)
    ry = rng.uniform(0, box, n_rays)
    edges = np.linspace(0, n, n_dev + 1).astype(int)
    lo, hi = edges[rank], edges[rank + 1]
    cols = column_integrate_sharded(
        [(x[lo:hi], y[lo:hi], h[lo:hi].astype(np.float32), m[lo:hi])], rx, ry, periodic_box=box, mesh=mesh
    )
    out["columns"] = {"n_rays": n_rays, "median": float(cols.double().median())}
    out["columns_values"] = cols
    return out


def main(argv: Optional[list] = None) -> dict:
    """Under ``torchrun``: NCCL on the cards, or gloo with ``--device cpu``."""
    from ..parallel import make_mesh

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="torch device type of every rank (default: the card)")
    p.add_argument("--n", type=int, default=200_000, help="particles of the coherent render")
    args = p.parse_args(argv)
    cpu = torch.device(args.device).type == "cpu"
    if not cpu:
        if not torch.cuda.is_available():
            raise RuntimeError("multichip_render: no CUDA device (pass --device cpu to run on the CPU)")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("gloo" if cpu else "nccl")
    try:
        mesh = make_mesh(device="cpu" if cpu else None)
        out = run(mesh, n=args.n)
        if mesh.rank == 0:
            print(f"devices: {mesh.size} ({mesh.backend}, {mesh.device})")
            c = out["coherent"]
            print(f"1. sharded coherent deposit: stack {tuple(c['shape'])}, total mass-weight "
                  f"{c['mass_weight']:.3e}, mean-T map range [{c['mean_t_range'][0]:.3g}, {c['mean_t_range'][1]:.3g}] K")
            print(f"2. slab-sharded 3D cube, slabs {tuple(out['cube']['slab_shape'])}: mass "
                  f"{out['cube']['mass']:.4g} vs true {out['cube']['true_mass']:.4g}")
            print(f"3. distributed reorder: matched={out['reorder']['matched']}, exact={out['reorder']['exact']}")
            print(f"4. sharded sightlines: {out['columns']['n_rays']} columns, median {out['columns']['median']:.3g}",
                  flush=True)
    finally:
        dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
