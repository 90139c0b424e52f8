"""High-level rendering API: snapshot -> multi-field map stacks.

Counterpart: ``astro_sph_tools_tpu/render.py`` (``render_map_stack`` and
``MapStack``). One call reads the needed fields, stacks the deposit payloads
(weighted quantities ride the same pass as the weights), renders on the
chosen engine on ``device``, and derives weighted means. Maps come back as
NumPy arrays, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from .data_structures.particle_types import CoordinateAxes, ParticleType
from .io.snapshot import SnapshotBase
from .ops.deposit import MapSpec, deposit_2d
from .ops.deposit_coherent import deposit_2d_coherent
from .ops.deposit_tiled import deposit_2d_auto
from .utils.profiling import PhaseTimer

_KNOWN_FIELDS = ("density", "mass", "temperature", "metallicity", "velocity_los", "sfr")


@dataclass
class MapStack:
    """Result of a render: named maps + derived weighted means."""

    maps: dict
    spec: MapSpec
    axis: CoordinateAxes
    particle_type: ParticleType
    timings: dict = field(default_factory=dict)

    def __getitem__(self, name: str) -> np.ndarray:
        return self.maps[name]

    def keys(self):
        return self.maps.keys()


def render_map_stack(
    snapshot: SnapshotBase,
    fields: Sequence[str] = ("density",),
    *,
    particle_type: ParticleType = ParticleType.gas,
    axis: CoordinateAxes = CoordinateAxes.Z,
    resolution: int = 1024,
    extent: Optional[tuple] = None,
    kernel: str = "cubic_spline",
    engine: str = "pallas",
    projection: str = "kernel3d",
    periodic: Optional[bool] = None,
    device="cuda",
) -> MapStack:
    """Render a stack of SPH-projected maps from a snapshot.

    fields: any of "density" (surface density), "mass", "sfr", and the
    mass-weighted quantities "temperature", "metallicity", "velocity_los"
    (weighted means are derived automatically from a mass map that rides the
    same deposit pass).

    engine: ``"pallas"`` (default) is the sorted tile engine with the
    hand-written CUDA deposit kernel (``ops/deposit_tiled.py``; the name is
    kept from the JAX package); ``"coherent"`` is the coherent-order engine
    for snapshot-ordered particles (``ops/deposit_coherent.py``, at most 4
    fields per pass); ``"xla"`` is the plain torch stencil engine
    (``ops/deposit.py``).
    """
    if engine not in ("pallas", "coherent", "xla"):
        raise ValueError(f"Unknown engine {engine!r} (pallas | coherent | xla)")
    device = torch.device(device)
    timer = PhaseTimer(device)
    i, j = axis.projection_plane
    box = float(snapshot.box_size.value[0])
    if extent is None:
        extent = (0.0, box, 0.0, box)
        if periodic is None:
            periodic = True
    periodic = bool(periodic)

    with timer.phase("io"):
        pos = snapshot.get_positions(particle_type).to_value("Mpc")
        h = snapshot.get_smoothing_lengths(particle_type).to_value("Mpc")
        if particle_type == ParticleType.black_hole:
            mass = snapshot.get_black_hole_dynamical_masses().to_value("Msun")
        else:
            mass = snapshot.get_masses(particle_type).to_value("Msun")

        payloads: list = []
        names: list = []
        weighted: list = []
        for name in fields:
            if name == "density":
                payloads.append(mass)
                names.append("surface_density")
            elif name == "mass":
                payloads.append(mass)
                names.append("mass")
            elif name == "sfr":
                payloads.append(snapshot.get_sfr().to_value("Msun/yr"))
                names.append("sfr")
            elif name == "temperature":
                payloads.append(mass * snapshot.get_temperatures(particle_type).to_value("K"))
                names.append("mass_weighted_temperature")
                weighted.append("mass_weighted_temperature")
            elif name == "metallicity":
                payloads.append(mass * snapshot.get_metallicities(particle_type).value)
                names.append("mass_weighted_metallicity")
                weighted.append("mass_weighted_metallicity")
            elif name == "velocity_los":
                v = snapshot.get_velocities(particle_type).to_value("km/s")
                payloads.append(mass * v[:, axis.value])
                names.append("mass_weighted_velocity_los")
                weighted.append("mass_weighted_velocity_los")
            else:
                raise ValueError(f"Unknown map field {name!r}; known: {_KNOWN_FIELDS}")
        if weighted and "surface_density" not in names and "mass" not in names:
            payloads.append(mass)
            names.append("mass")

    spec = MapSpec(
        shape=(resolution, resolution),
        extent=tuple(float(v) for v in extent),
        periodic_wrap=periodic,
    )
    # a snapshot may serve tensors already on the device (fields_to_device)
    values = (
        torch.stack(payloads, dim=0) if isinstance(payloads[0], torch.Tensor)
        else np.stack(payloads, axis=0)
    )

    with timer.phase("deposit"):
        if engine in ("pallas", "coherent"):
            render = deposit_2d_auto if engine == "pallas" else deposit_2d_coherent
            maps = render(
                pos[:, i], pos[:, j], h, values, spec, kernel=kernel,
                projection=projection, device=device,
            )
        else:
            maps = deposit_2d(
                pos[:, i], pos[:, j], h, values.T, spec, kernel=kernel,
                projection=projection, device=device,
            ).permute(2, 0, 1)
        maps = maps.cpu().numpy()
        if maps.ndim == 2:
            maps = maps[None]

    result = {name: m for name, m in zip(names, maps)}
    with timer.phase("derive"):
        denom_name = "mass" if "mass" in result else (
            "surface_density" if "surface_density" in result else None
        )
        if denom_name:
            denom = result[denom_name]
            for name in weighted:
                mean = np.where(denom > 0, result[name] / np.maximum(denom, 1e-30), 0.0)
                result[name.replace("mass_weighted", "mean")] = mean

    return MapStack(
        maps=result,
        spec=spec,
        axis=axis,
        particle_type=particle_type,
        timings=timer.report(),
    )
