"""End-to-end workflow tour of the port.

Counterpart: ``examples/full_workflow.py`` of the JAX package, its ten
steps in its order: a synthetic EAGLE-format simulation tree, discovery and
reads, a map stack, halo cutouts, a 3D cube, sightline columns and spectra,
the nearest haloes, an ID reorder, an ionisation table and a particle-filter
sidecar. The maps, cutouts, cube, columns and spectra run through the
kernel engines (on a card: kernels #1, #4, #5 and #6), where the JAX
example took ``engine="xla"`` and the dense engines.

    python -m astro_sph_tools_tpu_torch.examples.full_workflow [workdir]
        [--device cuda] [--n-gas 30000] [--source files|memory]

``--source files`` (the default) writes and reads the HDF5 tree, which
needs ``h5py``. ``--source memory`` draws the same particles
(``io.synthetic.generate_particles``) and the same catalogue and serves
them from memory, for a machine without ``h5py``: the steps that exist to
write or read files (the tree, its discovery, the table file and the
sidecar) are then reported as skipped and every other step runs as it
does from the files.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from ..data_structures import ParticleType
from ..io.synthetic import SyntheticSnapshotSpec


def workflow_spec(n_gas: int = 30_000) -> SyntheticSnapshotSpec:
    """The JAX example's tree: 4 files, clustered, 8 FOF groups; the other
    particle types scale with the gas as they do there."""
    return SyntheticSnapshotSpec(
        n_gas=n_gas, n_dm=n_gas // 3, n_star=n_gas // 15, n_bh=8, n_files=4, clustered=True, n_groups=8,
    )


def _catalogue_masses(spec: SyntheticSnapshotSpec) -> np.ndarray:
    """FOF masses (Msun) as ``io.synthetic.write_catalogue`` draws them."""
    return 10.0 ** np.random.default_rng(spec.seed + 1).uniform(11.0, 13.0, spec.n_groups)


def memory_tree(spec: SyntheticSnapshotSpec):
    """(snapshot, catalogue) serving ``generate_particles(spec)``'s gas and
    ``write_catalogue``'s groups from memory (``io/memory.py``), in the
    units the files' readers return (co-moving Mpc, Msun, km/s, K)."""
    from ..io.catalogue import BasicHaloDefinitions
    from ..io.memory import MemoryCatalogue, MemorySnapshot
    from ..io.synthetic import generate_particles

    p = generate_particles(spec)
    gas = ParticleType.gas
    snapshot = MemorySnapshot(
        {"positions": p.positions[gas], "velocities": p.velocities[gas], "smoothing_lengths": p.smoothing[gas],
         "masses": p.masses[gas], "temperatures": p.temperature, "ids": p.ids[gas]},
        spec.box_size_mpc, redshift=spec.redshift, hubble_param=spec.hubble_param,
        omega_baryon=spec.omega_baryon, number=f"{spec.snapshot_number:03d}",
    )
    masses = _catalogue_masses(spec)
    # write_catalogue's factors per definition, radii (m / 1e12)^(1/3) 0.2 Mpc x factor
    factors = {BasicHaloDefinitions.SO_200_CRIT.value: 1.0, BasicHaloDefinitions.SO_200_MEAN.value: 1.2}
    return snapshot, MemoryCatalogue(
        snapshot, p.group_centres,
        radii={d: (masses / 1.0e12) ** (1 / 3) * 0.2 * f for d, f in factors.items()},
        masses={d: masses * f for d, f in factors.items()},
    )


def run(workdir: Optional[str] = None, *, n_gas: int = 30_000, device="cuda", source: str = "files") -> dict:
    """The ten steps; returns their numbers, the map stack (``"stack"``),
    the columns (``"columns"``) and the ray positions (``"rays"``), and the
    steps skipped in ``source="memory"`` mode with the reason."""
    from ..io.catalogue import BasicHaloDefinitions
    from ..io.ionisation import IonisationTable_HM01, SupportedIons, synthetic_hm01_arrays
    from ..data_structures import IonisationTableBase
    from ..ops import (
        ArrayReorder, absorption_spectra_pallas, column_integrate_pallas, nearest_points,
    )
    from ..render import render_grid_stack, render_halo_maps, render_map_stack

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("full_workflow: no CUDA device (pass --device cpu to run on the CPU)")
    if source not in ("files", "memory"):
        raise ValueError(f"source must be 'files' or 'memory', got {source!r}")
    out: dict = {"device": str(device), "source": source, "skipped": {}}
    spec = workflow_spec(n_gas)
    no_files = "--source memory: this step writes or reads files (h5py)"

    # --- 1-2. a synthetic EAGLE-format tree; discovery and load ---
    if source == "files":
        from ..io import FileTreeScraper_EAGLE
        from ..io.synthetic import write_catalogue, write_los_file, write_snapshot

        _, truth = write_snapshot(workdir, spec)
        write_catalogue(workdir, spec, truth)
        write_los_file(workdir, spec)
        tree = FileTreeScraper_EAGLE(workdir)
        number = tree.catalogues.find_file_number_from_redshift(0.5)
        cat = tree.catalogues.get_by_number(number).load()
        snap = cat.snapshot
        print(f"[1] synthetic EAGLE tree under {workdir}")
    else:
        snap, cat = memory_tree(spec)
        out["skipped"]["1-2 tree, discovery"] = no_files
        print("[1] synthetic EAGLE particles and catalogue in memory")
    out["n_haloes"] = len(cat)
    print(f"[2] snapshot z={snap.z:.2f} with {len(cat)} FOF groups")

    # --- 3. multi-field map stack (kernel #1) ---
    stack = render_map_stack(snap, fields=("density", "temperature"), resolution=256, engine="pallas", device=device)
    out["stack"] = stack
    out["surface_density_sum"] = float(np.asarray(stack["surface_density"], np.float64).sum())
    print(f"[3] 256^2 map stack: total surface density {out['surface_density_sum']:.3e}")

    # --- 4. halo-centric cutouts (kernel #1) ---
    cutouts = render_halo_maps(snap, cat, [0, 1], resolution=64, engine="pallas", device=device)
    out["cutout_sums"] = [float(np.asarray(c["surface_density"], np.float64).sum()) for c in cutouts]
    print(f"[4] {len(cutouts)} halo cutouts, extents {cutouts[0].spec.extent}")

    # --- 5. 3D voxel cube (kernel #6 and the oversize route) ---
    m = snap.get_masses(ParticleType.gas).to_value("Msun")
    box = float(snap.box_size.value[0])
    cube = render_grid_stack(snap, fields=("density",), resolution=64, device=device)["density"]
    out["cube_mass_recon"] = float(cube.astype(np.float64).sum()) * (box / 64) ** 3 / float(np.sum(m, dtype=np.float64))
    print(f"[5] 64^3 density cube: mass recon {out['cube_mass_recon']:.3f}")

    # --- 6. sightline columns (kernel #4) and spectra (kernel #5) ---
    pos = snap.get_positions(ParticleType.gas).to_value("Mpc")
    h = snap.get_smoothing_lengths(ParticleType.gas).to_value("Mpc")
    rng = np.random.default_rng(1)
    rx, ry = rng.uniform(0, box, 64), rng.uniform(0, box, 64)
    cols = column_integrate_pallas(pos[:, 0], pos[:, 1], h, m, rx, ry, periodic_box=box, device=device)
    v = snap.get_velocities(ParticleType.gas).to_value("km/s")
    T = snap.get_temperatures(ParticleType.gas).to_value("K")
    tau, vc = absorption_spectra_pallas(
        pos, h, m, v[:, 2], T, rx[:4], ry[:4], cosmology=snap.cosmology, box_size=box, n_bins=256, device=device,
    )
    # saturated-absorber studies need the natural damping wings
    tau_v, _ = absorption_spectra_pallas(
        pos, h, m, v[:, 2], T, rx[:4], ry[:4], cosmology=snap.cosmology, box_size=box, n_bins=256,
        profile="voigt", gamma=6.265e8, device=device,  # H I Lya
    )
    out["columns"], out["rays"] = cols, (rx, ry)
    out["columns_median"] = float(cols.double().median())
    out["spectra_shape"] = list(tau.shape)
    out["spectra_finite"] = bool(torch.isfinite(tau).all() and torch.isfinite(tau_v).all())
    print(f"[6] 64 sightline columns (median {out['columns_median']:.3e}); 4 spectra x {len(vc)} bins "
          "(+ Voigt wings)")

    # --- 7. catalogue analytics + nearest haloes ---
    centres = cat.get_halo_centres_of_potential().to_value("Mpc")
    m200 = cat.get_halo_masses(BasicHaloDefinitions.SO_200_MEAN.value)
    _, dist = nearest_points(pos[:500], centres, periodic_box=box, device=device)
    out["nearest_median"] = float(np.median(dist))
    out["m200_mean_range"] = [float(m200.value.min()), float(m200.value.max())]
    print(f"[7] nearest halo of 500 particles: median distance {out['nearest_median']:.2f} cMpc; "
          f"M200_mean range {out['m200_mean_range'][0]:.2e}..{out['m200_mean_range'][1]:.2e} Msun")

    # --- 8. ID-matched reorder between two orderings ---
    ids = snap.get_IDs(ParticleType.gas)
    shuffled = np.random.default_rng(2).permutation(ids)
    op = ArrayReorder.create(ids, shuffled)
    reordered = np.asarray(op(m))
    out["reorder_lossless"] = bool(op.lossless)
    out["reorder_exact"] = bool(np.array_equal(reordered, m[np.argsort(ids)][np.searchsorted(np.sort(ids), shuffled)]))
    print(f"[8] reorder {len(ids)} IDs: lossless={op.lossless}")

    # --- 9. ionisation table ---
    if source == "files":
        from ..io.ionisation import write_synthetic_hm01_table

        write_synthetic_hm01_table(workdir, SupportedIons.O_VI)
        table = IonisationTable_HM01(SupportedIons.O_VI, workdir, device=device)
    else:
        a = synthetic_hm01_arrays()
        table = IonisationTableBase(a["ionbal"], a["logd"], a["logt"], a["redshift"], redshift_input_index=2,
                                    device=device)
        out["skipped"]["9 table file"] = no_files + " (the same table is built in memory)"
    frac = table.evaluate_at_redshift(np.array([[-4.0, 5.5]]), snap.z)
    out["ion_log_fraction"] = float(frac[0])
    print(f"[9] O VI ion fraction at (n_H=1e-4, T=10^5.5, z={snap.z:.1f}): 10^{out['ion_log_fraction']:.2f}")

    # --- 10. particle-filter sidecar ---
    mask = m > np.median(m)
    out["filter_selected"] = int(mask.sum())
    if source == "files":
        from ..io.particle_filter import ParticleFilterFile, SnapshotParticleFilter

        pf = ParticleFilterFile(
            filepath=os.path.join(workdir, "filters.hdf5"), description="gas above median mass",
            simulation_type="EAGLE",
        )
        pf.add_snapshot_filter(SnapshotParticleFilter(
            particle_type=ParticleType.gas, redshift=snap.z, snapshot_number=snap.number,
            filepath=snap.filepath, allowed_ids=ids[mask], mask=mask,
        ))
        pf.save()
        print(f"[10] particle filter saved ({out['filter_selected']} selected)")
    else:
        out["skipped"]["10 sidecar file"] = no_files
        print(f"[10] particle filter of {out['filter_selected']} particles (not saved: no files)")
    print("workflow complete.", flush=True)
    return out


def main(argv: Optional[list] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("workdir", nargs="?", help="directory of the synthetic tree (default: a new temporary one)")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    p.add_argument("--n-gas", type=int, default=30_000, help="gas particles of the synthetic snapshot")
    p.add_argument("--source", choices=("files", "memory"), default="files",
                   help="read the particles from HDF5 files (needs h5py) or serve them from memory")
    args = p.parse_args(argv)
    if args.source == "memory" or args.workdir:
        if args.workdir:
            os.makedirs(args.workdir, exist_ok=True)
        return run(args.workdir, n_gas=args.n_gas, device=args.device, source=args.source)
    with tempfile.TemporaryDirectory() as tmp:
        return run(tmp, n_gas=args.n_gas, device=args.device, source=args.source)


if __name__ == "__main__":
    main()
