"""Clustered gas particles at a snapshot's count, drawn on the card.

A frozen copy of the draws that ``chip_smoke.py`` measured
(``clustered_particles``, ``memory_snapshot`` and ``halo_catalogue``), so that
a change of the program cannot move the benchmark's inputs. Two departures,
both to keep the work the same from seed to seed: the blob-mixture density
field is drawn from the configuration's fixed ``field_seed`` (the run's
``--seed`` draws every per-particle quantity), and the haloes sit on the
field's heaviest cells rather than on the drawn particles' ones.
"""

from __future__ import annotations

import numpy as np
import torch

_BITS = 8  # the density field's cell grid is 2^8 = 256 cells a side
#: the critical density today over h^2, Msun cMpc^-3
RHO_CRIT_H2 = 2.77536627e11


def _morton_order_2d(bits: int) -> np.ndarray:
    """Morton (z-order) rank of each cell of a (2^bits, 2^bits) grid,
    flattened row-major."""
    n = 1 << bits
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    rank = np.zeros((n, n), dtype=np.int64)
    for b in range(bits):
        rank |= ((ii >> b) & 1) << (2 * b + 1)
        rank |= ((jj >> b) & 1) << (2 * b)
    return rank.reshape(-1)


def density_field(field_seed: int) -> np.ndarray:
    """The blob-mixture density on a 256^2 cell grid, rows along y: point
    masses smoothed with periodic FFT Gaussians at three scales, raised to
    1.5, with a floor of 2% of the mean."""
    grid = 1 << _BITS
    rng = np.random.default_rng(field_seed)
    dens = np.zeros((grid, grid))
    fi = np.fft.fftfreq(grid)
    k2 = fi[:, None] ** 2 + fi[None, :] ** 2
    for n_blobs, sig_cells in ((400, 1.5), (1200, 3.0), (600, 6.0)):
        ci = rng.integers(0, grid, n_blobs)
        cj = rng.integers(0, grid, n_blobs)
        w = np.exp(rng.normal(0.0, 1.0, n_blobs))
        point = np.zeros((grid, grid))
        np.add.at(point, (ci, cj), w)
        kernel_ft = np.exp(-2.0 * (np.pi * sig_cells) ** 2 * k2)
        dens += np.real(np.fft.ifft2(np.fft.fft2(point) * kernel_ft))
    dens = np.maximum(dens, 0.0) ** 1.5
    return dens + 0.02 * dens.mean()


def mean_smoothing_length(snapshot: dict) -> float:
    """EAGLE's smoothing length at the mean gas density (cMpc), in the
    convention of a kernel whose support is 2h: the support radius H holds
    ``n_ngb`` neighbours, (4 pi / 3) H^3 n = n_ngb, at the number density
    n = Omega_b rho_crit / m of gas particles of mass
    ``particle_mass_msun``, rho_crit = 2.775e11 h^2 Msun cMpc^-3 at z = 0,
    and h = H / 2."""
    rho_crit = RHO_CRIT_H2 * float(snapshot["hubble_h"]) ** 2
    volume = float(snapshot["particle_mass_msun"]) / (float(snapshot["omega_b"]) * rho_crit)
    return 0.5 * (3.0 * float(snapshot["n_ngb"]) * volume / (4.0 * np.pi)) ** (1.0 / 3.0)


def generate(snapshot: dict, seed: int, device) -> dict:
    """Gas particles along the Morton curve of the field's cells (the order a
    snapshot file keeps them in): positions (N, 3) in cMpc, smoothing
    lengths h = ``mean_smoothing_length`` * (rho / mean rho)^(-1/3) *
    lognormal(``h_lognormal_sigma``), clipped into ``h_clip_cmpc``, masses
    ``particle_mass_msun`` * U(0.5, 2), temperatures U(``temperature_k``),
    metallicities U(``metallicity``). Every array is f32 on ``device``."""
    n = int(snapshot["n_particles"])
    box = float(snapshot["box_cmpc"])
    grid = 1 << _BITS
    n_cells = grid * grid
    dens = density_field(int(snapshot["field_seed"])).reshape(-1)
    cell_seq = np.argsort(_morton_order_2d(_BITS))  # cell visited at each curve step
    cum = np.cumsum(dens[cell_seq] / dens.sum())

    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    u01 = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) / n
    step = torch.searchsorted(torch.as_tensor(cum, dtype=torch.float32, device=device), u01)
    del u01
    step = torch.clamp(step, 0, n_cells - 1)
    cell = torch.as_tensor(cell_seq, device=device)[step]
    del step
    cw = box / grid
    x = ((cell % grid).float() + torch.rand(n, generator=g, device=device)) * cw
    y = ((cell // grid).float() + torch.rand(n, generator=g, device=device)) * cw
    rho = torch.as_tensor(dens / dens.mean(), dtype=torch.float32, device=device)[cell]
    del cell
    h = mean_smoothing_length(snapshot) * rho ** (-1.0 / 3.0)
    del rho
    h = h * torch.exp(float(snapshot["h_lognormal_sigma"]) * torch.randn(n, generator=g, device=device))
    lo, hi = snapshot["h_clip_cmpc"]
    h = torch.clamp(h, float(lo), float(hi))
    m = float(snapshot["particle_mass_msun"]) * (0.5 + 1.5 * torch.rand(n, generator=g, device=device))
    t0, t1 = snapshot["temperature_k"]
    t = float(t0) + (float(t1) - float(t0)) * torch.rand(n, generator=g, device=device)
    z0, z1 = snapshot["metallicity"]
    metal = float(z0) + (float(z1) - float(z0)) * torch.rand(n, generator=g, device=device)
    z = box * torch.rand(n, generator=g, device=device)
    pos = torch.stack([x, y, z], dim=1)
    del x, y, z
    return {"positions": pos, "smoothing_lengths": h, "masses": m, "temperatures": t, "metallicities": metal,
            "box": box}


def r200(m200, snapshot: dict):
    """R200 (cMpc at z = 0) of haloes of mass ``m200`` (Msun): the radius
    within which the mean density is 200 rho_crit."""
    rho_crit = RHO_CRIT_H2 * float(snapshot["hubble_h"]) ** 2
    return (3.0 * np.asarray(m200, np.float64) / (4.0 * np.pi * 200.0 * rho_crit)) ** (1.0 / 3.0)


def haloes(snapshot: dict, catalogue: dict) -> tuple:
    """(centres (n, 3) cMpc, R200 (n,) cMpc): ``n_dense`` haloes at the
    centres of the heaviest cells of a ``grid``^2 partition of the density
    field, heaviest first, then one within 0.1 Mpc of the corner (0, 0) and
    one on the edge x ~ box at the heaviest cell's y, both crossing the
    periodic boundary. M200 is spaced geometrically over ``m200_msun``
    (heaviest first) in that order, and R200 follows from it."""
    box = float(snapshot["box_cmpc"])
    grid = int(catalogue["grid"])
    field = density_field(int(snapshot["field_seed"]))
    block = field.shape[0] // grid
    cell_mass = field.reshape(grid, block, grid, block).sum(axis=(1, 3)).reshape(-1)
    top = np.argsort(-cell_mass, kind="stable")[: int(catalogue["n_dense"])]
    cw = box / grid
    centres = [((c % grid + 0.5) * cw, (c // grid + 0.5) * cw, box / 2) for c in top]
    centres.append((0.05, 0.07, box / 2))
    centres.append((box - 0.02, (top[0] // grid + 0.5) * cw, box / 2))
    m_hi, m_lo = catalogue["m200_msun"]
    return np.array(centres, np.float64), r200(np.geomspace(float(m_hi), float(m_lo), len(centres)), snapshot)
