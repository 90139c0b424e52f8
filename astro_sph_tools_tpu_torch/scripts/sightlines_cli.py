"""Sightline columns and absorption spectra from a snapshot, on a torch device.

Counterpart: ``astro_sph_tools_tpu/scripts/sightlines_cli.py``
(``ast-tpu-sightlines``), the CLI face of BASELINE config 4: cast rays
through a snapshot (random or from a file of positions), integrate per-ray
kernel columns, and optionally synthesise velocity-space absorption spectra;
results go to HDF5 in the same layout. Run it with

    python -m astro_sph_tools_tpu_torch.scripts.sightlines_cli --snapshot snap.0.hdf5 -o rays.hdf5

``--device`` (default ``cuda``) picks where the engines run; the fused
engines launch their CUDA kernels there and use their plain torch versions
on ``cpu``. The work is one call of ``render.py::render_sightlines``, the
path the benchmark measures; the CLI draws or reads the rays and writes the
result. ``h5py`` is imported when the output is written.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np

from ..data_structures.particle_types import CoordinateAxes, ParticleType
from ..render import SIGHTLINE_ENGINES, render_sightlines
from ..utils.console import print_info, print_timing
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

#: ``--engine auto`` takes the fused passes from this many particle x ray
#: pairs on (a small sweep has no layout or schedule to build), where the
#: spectra's bins are a multiple of 128, and the dense sweeps otherwise
_FUSED_PAIRS = 1e7


def _engine(engine: str, n_pairs: float, spectra: bool, spectra_bins: int) -> str:
    if engine != "auto":
        return engine
    fused = n_pairs >= _FUSED_PAIRS and not (spectra and spectra_bins % 128)
    return "pallas" if fused else "dense"


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
    if engine != "auto" and engine not in SIGHTLINE_ENGINES:
        raise SystemExit(f"error: unknown engine {engine!r}")
    snap = load_snapshot(snapshot, format)
    ax = CoordinateAxes.from_string(axis)
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

    n_pairs = float(snap.number_of_particles_this_rank(ParticleType.gas)) * len(rx)
    engine = _engine(engine, n_pairs, spectra, spectra_bins)
    print_info(f"Engine: {engine}")
    los = render_sightlines(
        snap, rx, ry, axis=ax, kernel=kernel, spectra=spectra, n_bins=spectra_bins, profile=profile, gamma=gamma,
        rest_wavelength_angstrom=rest_wavelength, atomic_weight=atomic_weight, engine=engine, device=device,
    )
    for phase, label in (("io", "read snapshot fields"), ("columns", "column integration"),
                         ("spectra", "spectra synthesis"), ("to_host", "copy back")):
        if phase in los.timings:
            print_timing(label, los.timings[phase])

    import h5py

    with h5py.File(output, "w") as f:
        hdr = f.create_group("Header")
        hdr.attrs["Redshift"] = snap.redshift
        hdr.attrs["BoxSize_cMpc"] = box
        hdr.attrs["Axis"] = str(ax)
        hdr.attrs["Kernel"] = kernel
        f.create_dataset("ray_x", data=rx).attrs["Description"] = "cMpc"
        f.create_dataset("ray_y", data=ry).attrs["Description"] = "cMpc"
        f.create_dataset("column_density", data=los.columns).attrs["Description"] = (
            "Mass column density, Msun / cMpc^2 (integrated kernel)."
        )
        if spectra:
            g = f.create_group("Spectra")
            g.create_dataset("velocity_kms", data=los.velocity_kms)
            g.create_dataset("tau", data=los.tau).attrs["Description"] = (
                "Doppler-broadened kernel column per velocity bin "
                "(multiply by the line cross-section for optical depth)."
            )
    print_info(f"Wrote {len(rx)} sightlines to {output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
