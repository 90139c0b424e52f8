"""Sightline columns and absorption spectra from a snapshot, on a torch device.

Counterpart: ``astro_sph_tools_tpu/scripts/sightlines_cli.py``
(``ast-tpu-sightlines``), the CLI face of BASELINE config 4: cast rays
through a snapshot (random or from a file of positions), integrate per-ray
kernel columns, and optionally synthesise velocity-space absorption spectra;
results go to HDF5 in the same layout. Run it with

    python -m astro_sph_tools_tpu_torch.scripts.sightlines_cli --snapshot snap.0.hdf5 -o rays.hdf5

``--device`` (default ``cuda``) picks where the engines run; the fused
engines launch their CUDA kernels there and use their plain torch versions
on ``cpu``. ``h5py`` is imported when the output is written.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np

from ..data_structures.particle_types import CoordinateAxes, ParticleType
from ..ops.sightlines import column_integrate
from ..ops.sightlines_fused import column_integrate_pallas
from ..ops.spectra import absorption_spectra
from ..ops.spectra_fused import absorption_spectra_pallas
from ..utils.console import print_info, timed_phase
from .params import Param, ScriptWrapper
from .render_map import load_snapshot

PARAMS = (
    Param("snapshot", "i", "Path to the first snapshot file.", str, required=True),
    Param("format", "f", "Snapshot format: eagle | swift | tng.", str, default="eagle"),
    Param("output", "o", "Output HDF5 path.", str, required=True),
    Param("n_rays", "n", "Number of random rays (ignored with --ray-file).", int, default=1000),
    Param("ray_file", None, "Text file of 'x y' ray positions in cMpc.", str, default=None),
    Param("seed", None, "Random-ray seed.", int, default=8),
    Param("axis", "a", "Projection axis: x | y | z.", str, default="z"),
    Param("kernel", "k", "SPH kernel name.", str, default="cubic_spline"),
    Param("spectra", None, "Also synthesise velocity-space spectra.", is_flag=True),
    Param("spectra_bins", None, "Velocity bins for spectra.", int, default=512),
    Param("atomic_weight", None, "Ion mass (amu) for Doppler widths.", float, default=1.008),
    Param(
        "profile", None,
        "Line profile for spectra: gaussian (thermal core) | voigt "
        "(adds natural damping wings; needs --gamma).",
        str, default="gaussian",
    ),
    Param(
        "gamma", None,
        "Damping rate Gamma (1/s) for --profile voigt; H I Lya: 6.265e8.",
        float, default=None,
    ),
    Param(
        "rest_wavelength", None,
        "Line rest wavelength in Angstrom (default Lya 1215.67).",
        float, default=1215.67,
    ),
    Param(
        "engine", None,
        "Integration engine: auto | pallas | dense (auto = the fused kernel "
        "pass for large ray x particle workloads, dense sweep otherwise).",
        str, default="auto",
    ),
    Param("device", None, "Torch device the engines run on (cuda | cpu).", str, default="cuda"),
)


def _use_pallas(engine: str, n_pairs: float) -> bool:
    if engine == "pallas":
        return True
    if engine == "dense":
        return False
    if engine != "auto":
        raise SystemExit(f"error: unknown engine {engine!r}")
    # small sweeps stay on the dense path (no layout or schedule to build)
    return n_pairs >= 1e7


def main(argv: Optional[list] = None) -> int:
    wrapper = ScriptWrapper(
        command="python -m astro_sph_tools_tpu_torch.scripts.sightlines_cli",
        description="Integrate sightline columns (and optional spectra) through a snapshot.",
        parameters=PARAMS,
    )
    return run(**wrapper.parse(argv))


def run(
    snapshot: str,
    format: str,
    output: str,
    n_rays: int,
    ray_file: Optional[str],
    seed: int,
    axis: str,
    kernel: str,
    spectra: bool,
    spectra_bins: int,
    atomic_weight: float,
    engine: str = "auto",
    profile: str = "gaussian",
    gamma: Optional[float] = None,
    rest_wavelength: float = 1215.67,
    device: str = "cuda",
) -> int:
    snap = load_snapshot(snapshot, format)
    ax = CoordinateAxes.from_string(axis)
    i, j = ax.projection_plane
    box = float(snap.box_size.value[0])

    if ray_file:
        rays = np.loadtxt(ray_file, ndmin=2)
        if rays.shape[1] != 2:
            raise SystemExit("error: --ray-file needs two columns (x y in cMpc)")
        rx, ry = rays[:, 0], rays[:, 1]
    else:
        rng = np.random.default_rng(seed)
        rx = rng.uniform(0.0, box, n_rays)
        ry = rng.uniform(0.0, box, n_rays)

    with timed_phase("read snapshot fields"):
        pos = snap.get_positions(ParticleType.gas).to_value("Mpc")
        h = snap.get_smoothing_lengths(ParticleType.gas).to_value("Mpc")
        m = snap.get_masses(ParticleType.gas).to_value("Msun")

    fused = _use_pallas(engine, float(len(h)) * len(rx))
    with timed_phase("column integration"):
        column_fn = column_integrate_pallas if fused else column_integrate
        cols = column_fn(
            pos[:, i], pos[:, j], h, m, rx, ry,
            kernel=kernel, projection="integrated", periodic_box=box, device=device,
        ).cpu().numpy()

    spec_data = None
    if spectra:
        with timed_phase("spectra synthesis"):
            v = snap.get_velocities(ParticleType.gas).to_value("km/s")
            T = snap.get_temperatures(ParticleType.gas).to_value("K")
            # rotate so the LOS axis is z for the spectra engine
            pos_rot = pos[:, [i, j, ax.value]]
            spectra_fn = (
                absorption_spectra_pallas if (fused and spectra_bins % 128 == 0) else absorption_spectra
            )
            tau, v_centres = spectra_fn(
                pos_rot, h, m, v[:, ax.value], T, rx, ry,
                cosmology=snap.cosmology, box_size=box, n_bins=spectra_bins,
                atomic_weight=atomic_weight, kernel=kernel,
                profile=profile, gamma=gamma,
                rest_wavelength_angstrom=rest_wavelength, device=device,
            )
            spec_data = (tau.cpu().numpy(), v_centres)

    import h5py

    with h5py.File(output, "w") as f:
        hdr = f.create_group("Header")
        hdr.attrs["Redshift"] = snap.redshift
        hdr.attrs["BoxSize_cMpc"] = box
        hdr.attrs["Axis"] = str(ax)
        hdr.attrs["Kernel"] = kernel
        f.create_dataset("ray_x", data=rx).attrs["Description"] = "cMpc"
        f.create_dataset("ray_y", data=ry).attrs["Description"] = "cMpc"
        f.create_dataset("column_density", data=cols).attrs["Description"] = (
            "Mass column density, Msun / cMpc^2 (integrated kernel)."
        )
        if spec_data is not None:
            tau, v_centres = spec_data
            g = f.create_group("Spectra")
            g.create_dataset("velocity_kms", data=v_centres)
            g.create_dataset("tau", data=tau).attrs["Description"] = (
                "Doppler-broadened kernel column per velocity bin "
                "(multiply by the line cross-section for optical depth)."
            )
    print_info(f"Wrote {len(rx)} sightlines to {output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
