"""Rank-side tasks of the ``tests/test_torch_parallel*.py`` files, run by
``torch_dist.RankPool`` in spawned processes: they import the port, torch
and NumPy only (no JAX), take a ``RankContext`` first and return NumPy
arrays or plain values."""

from __future__ import annotations

import numpy as np
import torch


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t


def block(a, rank: int, size: int):
    """Rank ``rank``'s block of an array split evenly along axis 0."""
    n = a.shape[0] // size
    return a[rank * n:(rank + 1) * n]


def deposit_2d(ctx, world, x, y, h, v, spec, kw):
    from astro_sph_tools_tpu_torch.parallel import deposit_2d_sharded

    mesh = ctx.mesh(world)
    r, s = mesh.rank, mesh.size
    return _np(deposit_2d_sharded(block(x, r, s), block(y, r, s), block(h, r, s), block(v, r, s), spec, mesh, **kw))


def deposit_3d(ctx, world, pos, h, v, spec, kw):
    from astro_sph_tools_tpu_torch.parallel import deposit_3d_sharded

    mesh = ctx.mesh(world)
    r, s = mesh.rank, mesh.size
    return _np(deposit_3d_sharded(block(pos, r, s), block(h, r, s), block(v, r, s), spec, mesh, **kw))


def ring(ctx, world):
    """What each rank receives from the ring shifts of its rank id."""
    from astro_sph_tools_tpu_torch.parallel._comm import ring_shift

    mesh = ctx.mesh(world)
    t = torch.full((2, 3), float(mesh.rank))
    up, down = ring_shift(t, mesh, 1), ring_shift(t, mesh, -1)
    return float(up[0, 0]), float(down[0, 0]), up is t


def coherent(ctx, world, x, y, h, v, spec, kw):
    from astro_sph_tools_tpu_torch.parallel import deposit_2d_coherent_sharded

    mesh = ctx.mesh(world)
    r, s = mesh.rank, mesh.size
    return _np(deposit_2d_coherent_sharded(block(x, r, s), block(y, r, s), block(h, r, s), block(v.T, r, s).T,
                                           spec, mesh, **kw))


def coherent_fused(ctx, world, x, y, h, v, spec, tiny_rank):
    """The fused engine with capacities merged over the mesh; rank
    ``tiny_rank`` instead renders with capacities that cannot hold its
    shard. Returns (map, ok, caps)."""
    from astro_sph_tools_tpu_torch.ops import CoherentCaps, caps_from_layout, tile_particles_coherent
    from astro_sph_tools_tpu_torch.parallel import caps_union_mesh, deposit_2d_coherent_sharded_fused

    mesh = ctx.mesh(world)
    r, s = mesh.rank, mesh.size
    xs, ys, hs, vs = block(x, r, s), block(y, r, s), block(h, r, s), block(v.T, r, s).T
    caps = caps_union_mesh(caps_from_layout(tile_particles_coherent(xs, ys, hs, vs, spec, device="cpu")), mesh)
    if r == tiny_rank:
        caps = CoherentCaps(b0=4096, bucket_caps=(0,) * len(caps.bucket_caps), level_caps=(0,) * len(caps.level_caps))
    img, ok = deposit_2d_coherent_sharded_fused(xs, ys, hs, vs, spec, mesh, caps)
    return _np(img), bool(ok), (caps.b0, caps.bucket_caps, caps.level_caps)


def coherent_bad_rank(ctx, x, y, h, v, spec, bad_rank, what, engine="synced"):
    """Rank ``bad_rank`` gets an oversize smoothing length (``what`` =
    "oversize") or a shard whose N is not a multiple of 2048 ("rows"); the
    synced engine must raise on every rank. With ``engine`` "fused" the
    capacities are merged over the mesh from the unchanged shards, and each
    rank returns (map, ok)."""
    from astro_sph_tools_tpu_torch.ops import caps_from_layout, tile_particles_coherent
    from astro_sph_tools_tpu_torch.parallel import (
        caps_union_mesh,
        deposit_2d_coherent_sharded,
        deposit_2d_coherent_sharded_fused,
    )

    mesh = ctx.mesh()
    r, s = mesh.rank, mesh.size
    xs, ys, hs, vs = block(x, r, s), block(y, r, s), block(h, r, s).copy(), block(v.T, r, s).T
    if engine == "fused":
        caps = caps_union_mesh(caps_from_layout(tile_particles_coherent(xs, ys, hs, vs, spec, device="cpu")), mesh)
    if r == bad_rank:
        if what == "oversize":
            hs[::1000] = 50 * spec.pixel_size[0]
        else:
            xs, ys, hs, vs = xs[:-1], ys[:-1], hs[:-1], vs[:, :-1]
    if engine == "fused":
        img, ok = deposit_2d_coherent_sharded_fused(xs, ys, hs, vs, spec, mesh, caps)
        return _np(img), bool(ok)
    return _np(deposit_2d_coherent_sharded(xs, ys, hs, vs, spec, mesh))


def reorder(ctx, world, src_ids, data, tgt_ids, kw):
    """This rank's (values, matched, overflow) of ``distributed_reorder``
    on its blocks of the three arrays."""
    from astro_sph_tools_tpu_torch.parallel import distributed_reorder

    mesh = ctx.mesh(world)
    r, s = mesh.rank, mesh.size
    out, matched, overflow = distributed_reorder(
        block(src_ids, r, s), block(data, r, s), block(tgt_ids, r, s), mesh, **kw
    )
    return _np(out), _np(matched), overflow


def rebalance(ctx, world, blocks, counts, pads):
    """This rank's rebalanced blocks and the new counts."""
    from astro_sph_tools_tpu_torch.parallel import rebalance_evenly

    mesh = ctx.mesh(world)
    out, new_counts = rebalance_evenly([block(b, mesh.rank, mesh.size) for b in blocks], counts, mesh,
                                       pad_values=pads)
    return [_np(o) for o in out], new_counts


def columns(ctx, world, shards, rx, ry, kw):
    """``column_integrate_sharded`` over ``world`` ranks, rank r taking
    ``shards[r]`` (at one rank, every shard)."""
    from astro_sph_tools_tpu_torch.parallel import column_integrate_sharded

    mesh = ctx.mesh(world)
    mine = shards if mesh.size == 1 else [shards[mesh.rank]]
    return _np(column_integrate_sharded(mine, rx, ry, mesh=mesh, **kw))


def spectra(ctx, world, shards, rx, ry, kw):
    """``absorption_spectra_sharded`` as :func:`columns`."""
    from astro_sph_tools_tpu_torch.data_structures import Cosmology
    from astro_sph_tools_tpu_torch.parallel import absorption_spectra_sharded

    mesh = ctx.mesh(world)
    mine = shards if mesh.size == 1 else [shards[mesh.rank]]
    kw = dict(kw, cosmology=Cosmology(**kw["cosmology"]))
    tau, vc = absorption_spectra_sharded(mine, rx, ry, mesh=mesh, **kw)
    return _np(tau), vc


def striped_read_and_render(ctx, path, memb, prop, resolution):
    """The port of tests/multiprocess/worker.py on one rank: a striped
    read, the blocks padded over the mesh, an even rebalance, the sharded
    render, the cross-process digest check; then the halo maps over the
    mesh and SUBFIND's gather. Returns what the test compares."""
    from astro_sph_tools_tpu_torch import render_halo_maps
    from astro_sph_tools_tpu_torch.data_structures import ParticleType
    from astro_sph_tools_tpu_torch.io.eagle import SnapshotEAGLE
    from astro_sph_tools_tpu_torch.io.subfind import CatalogueSUBFIND, _allgather_concat
    from astro_sph_tools_tpu_torch.ops.deposit import MapSpec
    from astro_sph_tools_tpu_torch.parallel import (
        deposit_2d_sharded,
        load_particle_fields_sharded,
        open_process_local_snapshot,
        rebalance_evenly,
    )
    from astro_sph_tools_tpu_torch.parallel._comm import all_gather_v
    from astro_sph_tools_tpu_torch.utils.determinism import assert_consistent_across_processes, hash_array

    mesh = ctx.mesh()
    gas = ParticleType.gas
    snap = open_process_local_snapshot(SnapshotEAGLE, path, mesh=mesh)
    n_local = snap.number_of_particles_this_rank(gas)
    fields = load_particle_fields_sharded(snap, gas, ["positions", "smoothing_lengths", "masses"], mesh,
                                          pad_to_multiple=512)
    pos = fields["positions"]
    counts = torch.cat(all_gather_v(torch.tensor([n_local]), mesh)).numpy()
    (bx, by, bh, bm), new_counts = rebalance_evenly(
        [pos[:, 0], pos[:, 1], fields["smoothing_lengths"], fields["masses"]], counts, mesh,
        pad_values=(0.0, 0.0, 1.0, 0.0),
    )
    box = float(snap.box_size.value[0])
    spec = MapSpec(shape=(64, 64), extent=(0.0, box, 0.0, box))
    img = deposit_2d_sharded(bx, by, bh, bm, spec, mesh, K=64).numpy()
    assert_consistent_across_processes(img, mesh=mesh)
    digest_mismatch = None
    try:  # a rank-dependent value must fail the check on every rank
        assert_consistent_across_processes(np.array([mesh.rank]), mesh=mesh)
    except AssertionError as exc:
        digest_mismatch = str(exc)

    cat = CatalogueSUBFIND(memb, prop, snap)
    stacks = render_halo_maps(snap, cat, [0, 2], fields=("density", "temperature"), resolution=resolution,
                              mesh=mesh)
    local_ids = cat.get_halo_IDs_by_snapshot_particle(gas)
    return {
        "files": len(snap._my_files), "n_local": n_local, "pos_shape": tuple(pos.shape),
        "counts": counts, "new_counts": new_counts, "map": img, "digest": hash_array(img),
        "digest_mismatch": digest_mismatch,
        "halo_maps": [{k: s[k] for k in s.keys()} for s in stacks],
        "local_ids": local_ids, "all_ids": _allgather_concat(local_ids),
        "all_ids_by_method": cat.get_halo_IDs_by_all_snapshot_particles(gas),
    }


def halo_maps_sharded(ctx, world, pos, h, m, centres, radii, haloes, box, resolution):
    """``render_halo_maps_sharded`` over ``world`` ranks, rank r taking
    block r of the particles; the surface-density maps."""
    from astro_sph_tools_tpu_torch.render import render_halo_maps_sharded

    mesh = ctx.mesh(world)
    r, s = mesh.rank, mesh.size
    stacks = render_halo_maps_sharded(block(pos, r, s), block(h, r, s), block(m, r, s), centres, radii, haloes,
                                      mesh, box=box, resolution=resolution)
    return [st["surface_density"] for st in stacks]


def smoke_rank(ctx, sizes):
    """One rank of chip_smoke.py's phase 23 (b), on the CPU."""
    import chip_smoke

    return chip_smoke.par_rank_work(torch, ctx.mesh(), sizes)


def empty_last_rank(ctx, x, y, h, v, spec, pos3, h3, m3, spec3, caps):
    """Every sharded deposit with the last rank holding no particle: the
    maps (and the fused ``ok``) of each rank."""
    from astro_sph_tools_tpu_torch.ops import CoherentCaps
    from astro_sph_tools_tpu_torch.parallel import (
        deposit_2d_coherent_sharded,
        deposit_2d_coherent_sharded_fused,
        deposit_2d_sharded,
        deposit_3d_sharded,
    )

    mesh = ctx.mesh()
    r, s = mesh.rank, mesh.size
    # ranks 0 .. s-2 split the particles, the last rank gets none
    parts = np.array_split(np.arange(x.shape[0]), s - 1) + [np.arange(0)]
    i = parts[r]
    out = {"2d": _np(deposit_2d_sharded(x[i], y[i], h[i], v[i], spec, mesh, K=16)),
           "coherent": _np(deposit_2d_coherent_sharded(x[i], y[i], h[i], v[i], spec, mesh))}
    img, ok = deposit_2d_coherent_sharded_fused(x[i], y[i], h[i], v[i], spec, mesh, CoherentCaps(*caps))
    out["fused"], out["ok"] = _np(img), bool(ok)
    slab_of = np.clip((pos3[:, 2] / (spec3.extent[5] / s)).astype(int), 0, s - 1)
    j = np.nonzero(slab_of == r)[0] if r < s - 1 else np.arange(0)
    out["3d"] = _np(deposit_3d_sharded(pos3[j], h3[j], m3[j], spec3, mesh, K=4))
    return out


def comm(ctx):
    """all_gather_v and all_to_all_v with uneven and empty pieces."""
    from astro_sph_tools_tpu_torch.parallel._comm import all_gather_v, all_to_all_v

    mesh = ctx.mesh()
    r, s = mesh.rank, mesh.size
    mine = torch.arange(r * 10, r * 10 + r, dtype=torch.int64)  # rank r holds r items
    gathered = [_np(g) for g in all_gather_v(mine, mesh)]
    # rank r sends d items to each rank d, valued 100 r + d
    send = torch.cat([torch.full((d,), 100 * r + d, dtype=torch.int64) for d in range(s)])
    got, counts = all_to_all_v(send, [d for d in range(s)], mesh)
    return gathered, _np(got), counts


def dryrun(ctx, n_devices):
    """``parallel.dryrun.dryrun_multichip`` on the CPU mesh of the pool."""
    from astro_sph_tools_tpu_torch.parallel.dryrun import dryrun_multichip

    return dryrun_multichip(n_devices, device="cpu")


def multichip_render(ctx, kw):
    """``examples.multichip_render.run`` on the CPU mesh of the pool; its
    tensors come back as NumPy arrays."""
    from astro_sph_tools_tpu_torch.examples.multichip_render import run

    return {k: _np(v) for k, v in run(ctx.mesh(), **kw).items()}
