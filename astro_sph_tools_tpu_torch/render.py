"""High-level rendering API: snapshot -> multi-field map stacks.

Counterpart: ``astro_sph_tools_tpu/render.py`` (``render_map_stack``,
``render_halo_maps``, ``render_halo_maps_sharded`` and ``MapStack``), and
``render_grid_stack``, the same path for 3D voxel cubes. One
call reads the needed
fields, stacks the deposit payloads (weighted quantities ride the same pass
as the weights), renders on the chosen engine on ``device``, and ends as
every product ends (:func:`_finish`): the weighted means derived on
``device``, then every map copied back. Maps come back as NumPy arrays, as
in the JAX package. :func:`render_sightlines` is the same path for rays:
per-ray columns and absorption spectra (BASELINE config 4), which the JAX
package reaches only through its sightlines CLI.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from .data_structures.particle_types import CoordinateAxes, ParticleType
from .io.catalogue import BasicHaloDefinitions
from .io.snapshot import SnapshotBase
from .kernels.splines import get_kernel
from .ops.deposit import MapSpec, deposit_2d
from .ops._device import check_precision
from .ops.deposit_coherent import deposit_2d_coherent
from .ops.deposit_tiled import deposit_2d_auto
from .ops.grid3d import GridSpec
from .ops.grid3d_tiled import deposit_3d_auto
from .ops.periodic import shift_centre
from .ops.sightlines import column_integrate
from .ops.sightlines_fused import column_integrate_pallas
from .ops.spectra import absorption_spectra
from .ops.spectra_fused import absorption_spectra_pallas
from .parallel._comm import all_reduce_
from .parallel.mesh import Mesh
from .utils.profiling import PhaseTimer, count, span

_KNOWN_FIELDS = ("density", "mass", "temperature", "metallicity", "velocity_los", "sfr")


@dataclass
class MapStack:
    """Result of a render: named maps (or cubes) + derived weighted means."""

    maps: dict
    spec: MapSpec  # a GridSpec for cubes
    axis: Optional[CoordinateAxes]  # None for cubes
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
    (``ops/deposit.py``). ``timings`` holds the io, deposit, derive and
    to_host seconds.
    """
    with span("render.map_stack") as sp:
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
            pos, h, payloads, names, weighted = _read_payloads(snapshot, fields, particle_type, "surface_density",
                                                               axis)
        sp.count(particles=int(h.shape[0]), fields=len(payloads))

        spec = MapSpec(
            shape=(resolution, resolution),
            extent=tuple(float(v) for v in extent),
            periodic_wrap=periodic,
        )
        with timer.phase("deposit"):
            maps = _deposit_2d(engine, pos[:, i], pos[:, j], h, _stack(payloads), spec, kernel=kernel,
                               projection=projection, device=device)
        result = _finish(dict(zip(names, maps)), weighted, "surface_density", timer, pinned=False)

        return MapStack(
            maps=result,
            spec=spec,
            axis=axis,
            particle_type=particle_type,
            timings=timer.report(),
        )


def _read_payloads(snapshot: SnapshotBase, fields: Sequence[str], particle_type: ParticleType, density_name: str,
                   axis: Optional[CoordinateAxes]) -> tuple:
    """Read what ``fields`` need and build their deposit payloads: (positions
    (Mpc), smoothing lengths (Mpc), payloads, their names, the names of the
    mass-weighted ones). "density" deposits the mass under ``density_name``;
    a weighted field without "density" or "mass" adds a "mass" payload, the
    denominator of its mean; "velocity_los" needs the line of sight
    ``axis``."""
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
            names.append(density_name)
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
        elif name == "velocity_los" and axis is not None:
            v = snapshot.get_velocities(particle_type).to_value("km/s")
            payloads.append(mass * v[:, axis.value])
            names.append("mass_weighted_velocity_los")
            weighted.append("mass_weighted_velocity_los")
        else:
            known = _KNOWN_FIELDS if axis is not None else tuple(f for f in _KNOWN_FIELDS if f != "velocity_los")
            raise ValueError(f"Unknown map field {name!r}; known: {known}")
    if weighted and density_name not in names and "mass" not in names:
        payloads.append(mass)
        names.append("mass")
    return pos, h, payloads, names, weighted


def _stack(payloads: list):
    """The payloads as one (F, N) array: a tensor where the snapshot serves
    tensors (``fields_to_device``), else NumPy."""
    return torch.stack(payloads, dim=0) if isinstance(payloads[0], torch.Tensor) else np.stack(payloads, axis=0)


def _deposit_2d(engine: str, x, y, h, values, spec: MapSpec, *, kernel: str, projection: str,
                device) -> torch.Tensor:
    """The (F, ny, nx) maps of ``values`` (F, N) on ``device`` from
    ``engine``: ``"pallas"`` (the sorted tile engine), ``"coherent"`` or
    ``"xla"`` (the stencil engine, which takes and returns fields last)."""
    kw = dict(kernel=kernel, projection=projection, device=device)
    if engine == "pallas":
        return deposit_2d_auto(x, y, h, values, spec, **kw)
    if engine == "coherent":
        return deposit_2d_coherent(x, y, h, values, spec, **kw)
    if engine == "xla":
        return deposit_2d(x, y, h, values.T, spec, **kw).permute(2, 0, 1)
    raise ValueError(f"Unknown engine {engine!r} (pallas | coherent | xla)")


def _derive_means(result: dict, weighted: Sequence[str], denom_name: str) -> None:
    """Add to ``result`` each weighted map's (or cube's) ``mean_*``, on
    their device: the JAX package's ``where(d > 0, n / max(d, 1e-30), 0)``
    over the denominator ``d``, in f32, which gives NumPy's bits."""
    if not weighted:
        return
    denom = result[denom_name]
    positive = denom > 0
    safe = torch.clamp_min(denom, 1e-30)
    for name in weighted:
        result[name.replace("mass_weighted", "mean")] = torch.where(positive, result[name] / safe, 0.0)


def _finish(result: dict, weighted: Sequence[str], density_name: str, timer: PhaseTimer, *,
            pinned: bool) -> dict:
    """The end of every product, from its maps (or cubes) on the device:
    the ``derive`` phase (the means over ``"mass"`` where it was rendered,
    else over ``density_name``), then the ``to_host`` phase, which counts
    the ``bytes`` it copies back and returns NumPy arrays (:func:`_to_host`
    with ``pinned``)."""
    with timer.phase("derive"):
        _derive_means(result, weighted, "mass" if "mass" in result else density_name)
    with timer.phase("to_host"):
        count(bytes=sum(t.numel() * t.element_size() for t in result.values()))
        return {name: _to_host(t, pinned=pinned) for name, t in result.items()}


def render_grid_stack(
    snapshot: SnapshotBase,
    fields: Sequence[str] = ("density",),
    *,
    particle_type: ParticleType = ParticleType.gas,
    resolution: int = 512,
    extent: Optional[tuple] = None,
    kernel: str = "cubic_spline",
    periodic: Optional[bool] = None,
    device="cuda",
) -> MapStack:
    """Grid a snapshot into a stack of 3D voxel cubes (BASELINE config 3).

    fields: any of "density" (the cube ``density``, sum_i m_i W at voxel
    centres, in Msun cMpc^-3 for h-full comoving input), "mass", "sfr" and
    the mass-weighted "temperature" and "metallicity", whose
    ``mass_weighted_*`` cubes ride the same deposit pass and whose
    ``mean_*`` cubes (the weighted cube over the density where that is
    positive, else 0) are derived on ``device`` before the copy back.

    The cubes are ``resolution``^3 over ``extent`` = (x0, x1, y0, y1, z0,
    z1), by default the whole box, periodic unless ``periodic`` says
    otherwise. They render through ``deposit_3d_auto``'s layout: kernel #6
    (``csrc/deposit3d.cu``) on its footprint levels and the oversize route
    (``ops/grid3d_wide.py``) past them, on a CUDA ``device``; their plain
    versions on the CPU. Returns (nz, ny, nx) float32 NumPy cubes in a
    :class:`MapStack` whose ``spec`` is the :class:`GridSpec` and whose
    ``axis`` is None; ``timings`` holds the io, deposit, derive and to_host
    seconds.

    From a CUDA ``device`` the cubes are page-locked: NumPy views of host
    memory from torch's caching pinned allocator (see :func:`_to_host`).
    Each cube pins its bytes while the caller holds it (three 512^3 cubes,
    1.5 GB); a dropped cube's memory goes back to torch's pool for the next
    copy, not to the system, until the process ends or the pool is emptied
    (``torch.accelerator.empty_host_cache()`` where torch has it, else
    ``torch._C._host_emptyCache()``). Copy a cube (``np.array(cube)``) to
    keep it in pageable memory. Maps stay pageable (``render_map_stack``,
    ``render_halo_maps``): a stack of 1024^2 maps is tens of MB, where
    fresh pageable pages cost little.
    """
    with span("render.grid_stack") as sp:
        device = torch.device(device)
        timer = PhaseTimer(device)
        box = float(snapshot.box_size.value[0])
        if extent is None:
            extent = (0.0, box) * 3
            if periodic is None:
                periodic = True
        spec = GridSpec(shape=(resolution,) * 3, extent=tuple(float(v) for v in extent),
                        periodic_wrap=bool(periodic))

        with timer.phase("io"):
            pos, h, payloads, names, weighted = _read_payloads(snapshot, fields, particle_type, "density", None)
        sp.count(particles=int(h.shape[0]), fields=len(payloads), voxels=resolution ** 3)

        with timer.phase("deposit"):
            cubes = deposit_3d_auto(pos, h, _stack(payloads), spec, kernel=kernel, device=device)
        result = _finish(dict(zip(names, cubes)), weighted, "density", timer, pinned=True)

        return MapStack(maps=result, spec=spec, axis=None, particle_type=particle_type, timings=timer.report())


#: ``render_sightlines``' engines: the fused kernel passes or the dense plain
#: sweeps, the caller's choice
SIGHTLINE_ENGINES = ("pallas", "dense")


@dataclass
class Sightlines:
    """Result of :func:`render_sightlines`, NumPy arrays: per ray its
    column (R,) and, where spectra were asked for, its spectrum (R, n_bins)
    at the velocity bin centres (km/s; None otherwise); and each phase's
    seconds."""

    columns: np.ndarray
    tau: Optional[np.ndarray]
    velocity_kms: Optional[np.ndarray]
    timings: dict = field(default_factory=dict)


def render_sightlines(
    snapshot: SnapshotBase,
    ray_x,
    ray_y,
    *,
    axis: CoordinateAxes = CoordinateAxes.Z,
    kernel: str = "cubic_spline",
    spectra: bool = False,
    n_bins: int = 512,
    profile: str = "gaussian",
    gamma: Optional[float] = None,
    rest_wavelength_angstrom: float = 1215.67,
    atomic_weight: float = 1.008,
    periodic: bool = True,
    engine: str = "pallas",
    device="cuda",
) -> Sightlines:
    """Cast rays along ``axis`` through a snapshot's gas (BASELINE config
    4): each ray's kernel column of the particle masses and, with
    ``spectra``, its velocity-space spectrum.

    The rays stand at (``ray_x``, ``ray_y``) cMpc on the plane of ``axis``.
    The columns are ``sum_i m_i Y(b_i, h_i)`` with ``Y`` the line-integrated
    kernel (Msun cMpc^-2 for h-full comoving input); the spectra spread each
    column over ``n_bins`` velocity bins by a Gaussian or, with ``profile=
    "voigt"`` and the damping rate ``gamma`` (1/s), a Voigt line of an ion of
    ``atomic_weight`` at ``rest_wavelength_angstrom``, about the particle's
    Hubble-flow plus peculiar velocity along ``axis`` in the snapshot's
    cosmology (multiply by the line cross-section for optical depth; an ion
    fraction is one more factor per particle). ``periodic`` wraps the box on
    the plane and the velocities over its Hubble-flow extent.

    ``engine``: ``"pallas"`` runs the fused passes, kernel #4
    (``ops/sightlines_fused.py::column_integrate_pallas``) and kernel #5
    (``ops/spectra_fused.py::absorption_spectra_pallas``, which raises
    unless ``n_bins`` is a multiple of 128), their CUDA kernels on a CUDA
    ``device`` and plain torch versions on the CPU; ``"dense"`` the plain
    sweeps over every particle (``column_integrate``,
    ``absorption_spectra``). The results are those calls' bit for bit.
    ``timings`` holds the io, columns, spectra and to_host seconds; the
    copy back is pageable, as for maps.
    """
    if engine not in SIGHTLINE_ENGINES:
        raise ValueError(f"Unknown engine {engine!r} ({' | '.join(SIGHTLINE_ENGINES)})")
    with span("render.sightlines") as sp:
        device = torch.device(device)
        timer = PhaseTimer(device)
        i, j = axis.projection_plane
        box = float(snapshot.box_size.value[0])
        rx, ry = _host_f64(ray_x), _host_f64(ray_y)

        with timer.phase("io"):
            gas = ParticleType.gas
            pos = snapshot.get_positions(gas).to_value("Mpc")
            h = snapshot.get_smoothing_lengths(gas).to_value("Mpc")
            mass = snapshot.get_masses(gas).to_value("Msun")
            if spectra:
                v_los = snapshot.get_velocities(gas).to_value("km/s")[:, axis.value]
                temperature = snapshot.get_temperatures(gas).to_value("K")
        n = int(h.shape[0])
        sp.count(particles=n, rays=len(rx), bins=n_bins if spectra else 0)
        fused = engine == "pallas"

        with timer.phase("columns"):
            column_fn = column_integrate_pallas if fused else column_integrate
            result = {"columns": column_fn(pos[:, i], pos[:, j], h, mass, rx, ry, kernel=kernel,
                                           projection="integrated", periodic_box=box if periodic else None,
                                           device=device)}
        v_centres = None
        if spectra:
            with timer.phase("spectra"):
                spectra_fn = absorption_spectra_pallas if fused else absorption_spectra
                # the line of sight rotated to z, as the spectra engines take it
                result["tau"], v_centres = spectra_fn(
                    pos[:, [i, j, axis.value]], h, mass, v_los, temperature, rx, ry,
                    cosmology=snapshot.cosmology, box_size=box, atomic_weight=atomic_weight, n_bins=n_bins,
                    kernel=kernel, periodic=periodic, profile=profile, gamma=gamma,
                    rest_wavelength_angstrom=rest_wavelength_angstrom, device=device,
                )
        with timer.phase("to_host"):
            count(bytes=sum(t.numel() * t.element_size() for t in result.values()))
            host = {name: _to_host(t, pinned=False) for name, t in result.items()}
        return Sightlines(columns=host["columns"], tau=host.get("tau"), velocity_kms=v_centres, timings=timer.report())


def _to_host(t: torch.Tensor, *, pinned: bool) -> np.ndarray:
    """``t`` as a NumPy array: ``.cpu()``'s unless ``pinned`` and ``t`` is
    on a CUDA device. Then the array is one of its own in page-locked host
    memory from torch's pinned allocator, which keeps a dropped array's
    memory for the next copy: three 512 MB cubes then copy in ~30 ms at the
    link's rate, where a pageable ``.cpu()`` faults in 1.5 GB of fresh pages
    (670-870 ms, varying with the host's load). Growing the pool, while the
    caller holds more arrays than it has, costs about what the pageable
    copy does."""
    if not pinned or t.device.type != "cuda":
        return t.cpu().numpy()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out.numpy()


def _host_f64(a) -> np.ndarray:
    return a.detach().cpu().numpy().astype(np.float64) if isinstance(a, torch.Tensor) else np.asarray(a, np.float64)


def _on_device(a, dtype, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def render_halo_maps(
    snapshot: SnapshotBase,
    catalogue,
    halo_indexes,
    *,
    radius_multiple: float = 2.0,
    radius_definition=None,
    fields: Sequence[str] = ("density",),
    particle_type: ParticleType = ParticleType.gas,
    axis: CoordinateAxes = CoordinateAxes.Z,
    resolution: int = 256,
    kernel: str = "cubic_spline",
    engine: str = "pallas",
    mesh=None,
    device="cuda",
) -> list[MapStack]:
    """Halo-centric multi-field map stacks (BASELINE config 5's analysis shape).

    For each requested halo, recentres the box on the halo's centre of
    potential (periodic ``shift_centre``) and renders a cutout of
    ``radius_multiple x R_def`` half-width: extent ``box/2 +- half width``,
    not periodic. ``radius_definition`` defaults to SO 200 crit (the
    reference pipeline's choice, `_scripts/find_nearest_haloes.py:161-187`).
    ``fields``: "density" (the surface density, always rendered),
    "temperature" and "metallicity" (mass-weighted, with their ``mean_*``
    maps derived).

    ``engine``: ``"pallas"`` (default) is the sorted tile engine
    ``deposit_2d_auto``, whose levels launch the CUDA deposit kernel
    (``csrc/deposit2d.cu``) on a CUDA ``device``; ``"xla"`` is the plain
    torch stencil engine ``deposit_2d``.

    The particles move to ``device`` once for all haloes: the in-plane
    positions in f64 (the JAX package recentres in f32), the smoothing
    lengths in f64 for the support cut, the payloads in f32. Per halo: the
    f64 recentring, the cut to particles whose support ``support_factor * h``
    reaches the cutout (a mask; its compaction is the halo's one host sync)
    and one engine call on the selected particles' f64 offsets from the
    cutout's centre: both engines take f64 positions in f64 for the pixel
    assignment (f32 ones cost ~5e-5 px at 1024², over the 1e-5 budget), and
    the sorted engine's f32 pixel coordinates, which its oversize route
    (``ops/deposit_wide.py``) deposits from, stay at the cutout's own scale. ``timings``
    holds each halo's recentre, select, deposit, derive and to_host seconds;
    the first stack's also holds ``io``, the call's one read and upload.

    ``mesh`` (a :class:`~astro_sph_tools_tpu_torch.parallel.Mesh`): the
    snapshot holds this rank's particles (``open_process_local_snapshot``);
    each halo's maps are rendered from them on ``mesh.device`` and summed
    over the mesh with one ``all_reduce`` before the means are derived, so
    every rank returns the whole maps. Every rank must pass the same
    catalogue and haloes.
    """
    if engine not in ("pallas", "xla"):
        raise ValueError(f"Unknown engine {engine!r} (pallas | xla)")
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a Mesh from astro_sph_tools_tpu_torch.parallel.make_mesh, got {type(mesh)}")
    if radius_definition is None:
        radius_definition = BasicHaloDefinitions.SO_200_CRIT.value
    device = mesh.device if mesh is not None else torch.device(device)
    with span("render.halo_maps", haloes=int(np.size(halo_indexes))) as sp:
        io_timer = PhaseTimer(device)

        with io_timer.phase("io"):
            box = float(snapshot.box_size.value[0])
            centres = catalogue.get_halo_centres_of_potential().to_value("Mpc")
            radii = catalogue.get_halo_radii(radius_definition).to_value("Mpc")
            pos = snapshot.get_positions(particle_type).to_value("Mpc")
            h = snapshot.get_smoothing_lengths(particle_type).to_value("Mpc")
            mass = snapshot.get_masses(particle_type).to_value("Msun")

            # the payload stack, once, as the JAX package builds it: its own
            # loop, not _read_payloads, because the JAX halo path reads
            # get_masses for every particle type and maps only temperature
            # and metallicity beside the always-rendered surface density
            payloads = [mass]
            names = ["surface_density"]
            weighted = []
            for name in fields:
                if name == "density":
                    continue
                if name == "temperature":
                    payloads.append(mass * snapshot.get_temperatures(particle_type).to_value("K"))
                    names.append("mass_weighted_temperature")
                    weighted.append("mass_weighted_temperature")
                elif name == "metallicity":
                    payloads.append(mass * snapshot.get_metallicities(particle_type).value)
                    names.append("mass_weighted_metallicity")
                    weighted.append("mass_weighted_metallicity")
                else:
                    raise ValueError(f"Unknown halo-map field {name!r}")
            particles = _halo_particles(pos, h, payloads, axis, device)
            del pos, payloads
        sp.count(particles=int(particles[1].shape[0]))

        return _halo_stacks(
            particles, names, weighted, centres, radii, halo_indexes, box=box, radius_multiple=radius_multiple,
            axis=axis, resolution=resolution, kernel=kernel, engine=engine, particle_type=particle_type,
            device=device, mesh=mesh, io_timings=io_timer.report(),
        )


def _halo_particles(pos, h, payloads, axis: CoordinateAxes, device) -> tuple:
    """(in-plane positions (N, 2) f64, h f64, payloads (F, N) f32) on ``device``."""
    i, j = axis.projection_plane
    values = (
        torch.stack([_on_device(p, torch.float32, device) for p in payloads])
        if isinstance(payloads[0], torch.Tensor)
        else _on_device(np.stack([np.asarray(p) for p in payloads], axis=0), torch.float32, device)
    )
    plane = pos[:, [i, j]] if isinstance(pos, torch.Tensor) else np.ascontiguousarray(np.asarray(pos)[:, [i, j]])
    return _on_device(plane, torch.float64, device), _on_device(h, torch.float64, device), values


def _halo_stacks(
    particles, names, weighted, centres, radii, halo_indexes, *, box: float, radius_multiple: float,
    axis: CoordinateAxes, resolution: int, kernel: str, engine: str, particle_type: ParticleType,
    device, mesh, io_timings: dict,
) -> list[MapStack]:
    """The per-halo loop of :func:`render_halo_maps`: recentre, select,
    deposit (then sum over ``mesh`` when given), derive, copy back."""
    xy, h64, values = particles
    centres, radii = _host_f64(centres), _host_f64(radii)
    i, j = axis.projection_plane
    support_factor = get_kernel(kernel).support_factor
    stacks = []
    for halo_index in np.atleast_1d(halo_indexes):
        with span("render.halo", halo=int(halo_index)) as sp:
            timer = PhaseTimer(device)
            half_width = radius_multiple * float(radii[halo_index])
            lo, hi = box / 2 - half_width, box / 2 + half_width
            spec = MapSpec(shape=(resolution, resolution), extent=(lo, hi, lo, hi), periodic_wrap=False)
            # the same grid about the cutout's centre, in which the engines deposit
            local_spec = MapSpec(shape=spec.shape, extent=(-half_width, half_width) * 2, periodic_wrap=False)
            with timer.phase("recentre"):
                # f64 offsets from the cutout's centre (box/2 after the shift)
                local = shift_centre(xy, centres[halo_index][[i, j]], box) - box / 2
            with timer.phase("select"):
                # the cutout plus each particle's kernel support S_f * h (not a
                # literal 2h: quintic/Wendland kernels reach 3h)
                reach = half_width + support_factor * h64
                sel = torch.nonzero((local[:, 0].abs() < reach) & (local[:, 1].abs() < reach)).squeeze(1)
                lx, ly = local[sel, 0], local[sel, 1]
                hs = h64[sel].to(torch.float32)
                vs = values[:, sel]
                sp.count(selected=int(sel.shape[0]))
                del local, reach, sel
            with timer.phase("deposit"):
                maps = _deposit_2d(engine, lx, ly, hs, vs, local_spec, kernel=kernel, projection="kernel3d",
                                   device=device)
                if mesh is not None:
                    maps = all_reduce_(maps.contiguous(), mesh)
                del lx, ly, hs, vs
            result = _finish(dict(zip(names, maps)), weighted, "surface_density", timer, pinned=False)
            del maps  # free the device maps before the next halo's deposit
            timings = timer.report()
            if not stacks:
                timings = {**io_timings, **timings}
            stacks.append(MapStack(maps=result, spec=spec, axis=axis, particle_type=particle_type, timings=timings))
    return stacks


def render_halo_maps_sharded(
    positions,  # (N, 3) Mpc: this rank's particles
    h,  # (N,)
    mass,  # (N,)
    centres,  # (n_haloes, 3) catalogue centres
    radii,  # (n_haloes,) catalogue radii (R_def)
    halo_indexes,
    mesh,
    *,
    box: float,
    radius_multiple: float = 2.0,
    axis: CoordinateAxes = CoordinateAxes.Z,
    resolution: int = 256,
    kernel: str = "cubic_spline",
    particle_type: ParticleType = ParticleType.gas,
    axis_name: str = "data",
    precision: str = "bf16x2",
) -> list[MapStack]:
    """Halo cutout surface-density maps from this rank's particles, summed
    over ``mesh`` (BASELINE config 5's multi-GPU analysis shape): the
    per-halo path of :func:`render_halo_maps` with ``mesh`` — f64
    recentring and support cut on ``mesh.device``, the sorted engine
    ``deposit_2d_auto`` (kernel #1; footprints past the largest level take
    its oversize route), one ``all_reduce`` per halo. The JAX package
    recentres in f32 and raises past K = 64; neither is copied.
    ``precision`` is validated; the sums are f32.
    """
    check_precision(precision)
    particles = _halo_particles(positions, h, [mass], axis, mesh.device)
    return _halo_stacks(
        particles, ["surface_density"], [], centres, radii, halo_indexes, box=box,
        radius_multiple=radius_multiple, axis=axis, resolution=resolution, kernel=kernel, engine="pallas",
        particle_type=particle_type, device=mesh.device, mesh=mesh, io_timings={},
    )
