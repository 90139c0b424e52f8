"""Clustered gas particles in a periodic 3D box, with velocities,
temperatures and rays, drawn on the card.

A frozen copy of the draws that ``chip_smoke.py`` measured for its
sightline phases (``sightline_particles``): a blob-mixture density on a 64^3
cell grid (point masses smoothed with periodic FFT Gaussians at three
scales, raised to 1.5, with a floor of 2 % of the mean), at a snapshot's
count. Three departures: the field comes from the configuration's fixed
``field_seed`` and the run's ``--seed`` draws every per-particle quantity
and the rays; the particles fill the cells along the field's 3D Morton
curve (the order a snapshot file keeps them in), each curve step taking its
share of the mass, as ``clustered.py`` fills its 2D curve; and h follows
EAGLE's rule (``clustered.py::mean_smoothing_length``) at the cell's
density.
"""

from __future__ import annotations

import numpy as np
import torch

from sphbench.generators.clustered import mean_smoothing_length

_BITS = 6  # the density field's cell grid is 2^6 = 64 cells a side


def _morton_order_3d(bits: int) -> np.ndarray:
    """Morton (z-order) rank of each cell of a (2^bits)^3 grid, flattened
    row-major."""
    n = 1 << bits
    ii, jj, kk = np.meshgrid(np.arange(n), np.arange(n), np.arange(n), indexing="ij")
    rank = np.zeros((n, n, n), dtype=np.int64)
    for b in range(bits):
        rank |= ((ii >> b) & 1) << (3 * b + 2)
        rank |= ((jj >> b) & 1) << (3 * b + 1)
        rank |= ((kk >> b) & 1) << (3 * b)
    return rank.reshape(-1)


def density_field(field_seed: int) -> np.ndarray:
    """The blob-mixture density on a 64^3 cell grid, axes (x, y, z)."""
    grid = 1 << _BITS
    rng = np.random.default_rng(field_seed)
    dens = np.zeros((grid, grid, grid))
    f = np.fft.fftfreq(grid)
    k2 = f[:, None, None] ** 2 + f[None, :, None] ** 2 + f[None, None, :] ** 2
    for n_blobs, sig_cells in ((3000, 1.0), (6000, 2.0), (2000, 4.0)):
        idx = rng.integers(0, grid, (3, n_blobs))
        point = np.zeros((grid, grid, grid))
        np.add.at(point, tuple(idx), np.exp(rng.normal(0.0, 1.0, n_blobs)))
        dens += np.real(np.fft.ifftn(np.fft.fftn(point) * np.exp(-2.0 * (np.pi * sig_cells) ** 2 * k2)))
    dens = np.maximum(dens, 0.0) ** 1.5
    return dens + 0.02 * dens.mean()


def generate(snapshot: dict, seed: int, device) -> dict:
    """Gas particles along the field's 3D Morton curve: positions (N, 3)
    cMpc; smoothing lengths h = ``mean_smoothing_length`` * (rho / mean
    rho)^(-1/3) * lognormal(``h_lognormal_sigma``), clipped into
    ``h_clip_cmpc``; masses ``particle_mass_msun`` * U(``mass_scatter``);
    velocities (N, 3), each component N(0, ``velocity_sigma_kms``) km/s;
    temperatures 10^N(mean, sigma) K clipped into ``log10_temperature_k``'s
    range; every array f32 on ``device``. The rays: ``n_rays`` positions
    uniform over the box's (x, y) plane, float64 NumPy ``ray_x``, ``ray_y``
    (cMpc), drawn last."""
    n = int(snapshot["n_particles"])
    box = float(snapshot["box_cmpc"])
    grid = 1 << _BITS
    dens = density_field(int(snapshot["field_seed"])).reshape(-1)
    cell_seq = np.argsort(_morton_order_3d(_BITS))  # cell visited at each curve step
    cum = np.cumsum(dens[cell_seq] / dens.sum())

    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    u01 = (torch.arange(n, dtype=torch.float64, device=device) + 0.5) / n
    step = torch.searchsorted(torch.as_tensor(cum, dtype=torch.float64, device=device), u01)
    del u01
    step = torch.clamp(step, 0, grid ** 3 - 1)
    cell = torch.as_tensor(cell_seq, device=device)[step]
    del step
    ijk = torch.stack([cell // (grid * grid), (cell // grid) % grid, cell % grid], dim=1).float()
    pos = (ijk + torch.rand((n, 3), generator=g, device=device)) * (box / grid)
    del ijk
    rho = torch.as_tensor(dens / dens.mean(), dtype=torch.float32, device=device)[cell]
    del cell
    h = mean_smoothing_length(snapshot) * rho ** (-1.0 / 3.0)
    del rho
    h = h * torch.exp(float(snapshot["h_lognormal_sigma"]) * torch.randn(n, generator=g, device=device))
    lo, hi = snapshot["h_clip_cmpc"]
    h = torch.clamp(h, float(lo), float(hi))
    m_lo, m_hi = snapshot["mass_scatter"]
    m = float(snapshot["particle_mass_msun"]) * (
        float(m_lo) + (float(m_hi) - float(m_lo)) * torch.rand(n, generator=g, device=device))
    v = float(snapshot["velocity_sigma_kms"]) * torch.randn((n, 3), generator=g, device=device)
    lt = snapshot["log10_temperature_k"]
    t = 10.0 ** torch.clamp(float(lt["mean"]) + float(lt["sigma"]) * torch.randn(n, generator=g, device=device),
                            float(lt["clip"][0]), float(lt["clip"][1]))
    n_rays = int(snapshot["n_rays"])
    rays = box * torch.rand((2, n_rays), dtype=torch.float64, generator=g, device=device)
    rays = rays.cpu().numpy()
    return {"positions": pos, "smoothing_lengths": h, "masses": m, "velocities": v, "temperatures": t,
            "box": box, "ray_x": rays[0], "ray_y": rays[1]}
