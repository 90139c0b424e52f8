"""Reference of a ``los_spectra`` product: per-ray columns and absorption
spectra through a box of particles (SpecWizard-style, BASELINE config 4).

The same semantics as the entry's product, worked out again from the
inputs the harness hands both sides (``ops/spectra.py`` and
``ops/sightlines.py`` state them; nothing of the program is imported):

- **Rays** stand at (``ray_x``, ``ray_y``) on the plane of the product's
  ``axis`` and run through the whole box along it.
- **Candidates**: the particles of a plain grid of cells at least the
  largest support wide, sorted by cell; a ray's candidates are those of its
  own and its 8 neighbouring cells (each cell once where a periodic axis has
  fewer than 3). A candidate is a hit where the impact parameter b, the
  periodic minimum image in float64 (or the plain distance in an open box),
  lies inside the support, b < 2h.
- **Column weight** of a hit: the payload (the mass) times the integrated
  kernel Y(b, h) = int W(sqrt(b^2 + z^2), h) dz over the whole support, by
  float64 Gauss-Legendre quadrature (:func:`integrated_kernel`). Each ray's
  column is the sum of its hits' weights.
- **Velocity** of a particle: v = z H(z) a + v_pec, z its coordinate along
  the ray (cMpc), H(z) = 100 h sqrt(Omega_m (1 + z)^3 + Omega_Lambda) and
  a = 1 / (1 + z) from the configuration's cosmology; its Doppler width
  b_D = sqrt(2 k_B T / m_ion) (CODATA 2018 constants), at least 1e-3 km/s.
- **Spectrum**: tau(v_j) = sum over hits of the column weight times
  phi(v_j - v), at the bin centres v_j = (j + 1/2) v_box / n_bins of the
  box's Hubble-flow extent v_box = box H(z) a. With ``periodic`` the offset
  is wrapped to the principal zone, |dv| <= v_box / 2, and the profile summed
  over the 7 velocity images dv + k v_box, k = -3 .. 3; an open box takes
  the offset as it is. phi(dv) = sum_k H(a, x_k) / (sqrt(pi) b_D) with
  x_k = (dv + k v_box) / b_D: a Gaussian, H = exp(-x^2), or a Voigt line,
  H(a, x) = exp(-x^2) (1 + a^2 (1 - 2 x^2)) - a / sqrt(pi) (2 - 4 x F(x)),
  the expansion to second order in the damping a = Gamma lambda_0 /
  (4 pi b_D) (Dawson's F by :func:`dawson`).

``compare.py`` reads 2D maps and needs ``surface_density``: the columns are
handed over under that name as their (R / 100, 100) view
(:func:`columns_view`), the spectra as ``tau`` (R, n_bins).

Two precisions, as ``scatter.py`` has them. The reference places, evaluates
and sums in float64. The control is the same code one precision below the
configurations' float32: the impact parameters and the velocity offsets in
float32, every per-pair step (the support test, the quadrature, the line
profile and its products) in bfloat16, and the sums in float32.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from sphbench.counting import least_seconds
from sphbench.reference.scatter import KERNELS

#: the support radius in units of h of the configurations' kernels
SUPPORT = 2.0
#: erg / K and g (CODATA 2018)
BOLTZMANN_CGS = 1.380649e-16
AMU_CGS = 1.66053906660e-24
#: velocity images summed on each side of the principal one (periodic)
N_IMAGES = 3
#: rays a row of the columns' 2D view
ROW = 100
#: (LOS axis index, plane axes) by the product's ``axis``: the program's
#: projection planes (along x the plane is (y, z); along y, (x, z))
AXES = {"x": (0, (1, 2)), "y": (1, (0, 2)), "z": (2, (0, 1))}


def columns_view(columns):
    """The (R / ROW, ROW) view of the columns (one row where R is no
    multiple of ROW), the 2D map ``compare.py`` reads."""
    n = columns.shape[0]
    return columns.reshape(-1, ROW) if n % ROW == 0 else columns.reshape(1, n)


# ---------------------------------------------------------------------------
# the integrated kernel
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _gauss_legendre(n: int) -> tuple:
    """Gauss-Legendre nodes and weights on [0, 1], float64 NumPy."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


#: nodes of the panel [0, b] and of each of the B_PANELS panels of [b, Z]
A_NODES, B_PANELS, B_NODES = 16, 10, 12


def _rule(n: int, dtype, device):
    x, w = _gauss_legendre(n)
    return torch.as_tensor(x, dtype=dtype, device=device), torch.as_tensor(w, dtype=dtype, device=device)


def integrated_kernel(b, h, *, kernel: str = "wendland_c2"):
    """Y(b, h) = int W(sqrt(b^2 + z^2), h) dz over the support |r| < 2h,
    each pair in the dtype of ``b`` (float64: within 1e-12 of the value).

    The kernel is a polynomial of r inside its support, and r = sqrt(b^2 +
    z^2) has branch points at z = +-i b: Gauss-Legendre on z would converge
    slowly for b << h. So Y = 2 (A + B): A on z in [0, min(b, Z)] (16 nodes;
    the branch points lie a panel's width away), B on z in [b, Z], Z =
    sqrt(4 h^2 - b^2), mapped to s = ln(z / b) (branch points at s = i pi /
    2) and cut into 10 equal panels of 12 nodes. b is floored at 1e-9 h,
    where Y differs from Y(0) by ~1e-17 of its value."""
    if kernel != "wendland_c2":
        raise ValueError(f"the quadrature is exact only for a kernel smooth inside its support, not {kernel!r}")
    w_fn = KERNELS[kernel]
    dt, dev = b.dtype, b.device
    b = torch.maximum(b, 1e-9 * h)
    zmax = torch.sqrt(torch.clamp((SUPPORT * h) ** 2 - b * b, min=0.0))
    hh = h[:, None]
    # A: z = t min(b, Z), t in [0, 1]
    za_end = torch.minimum(b, zmax)
    t, wt = _rule(A_NODES, dt, dev)
    z = za_end[:, None] * t
    a_part = (w_fn(torch.sqrt(b[:, None] ** 2 + z * z), hh) * wt).sum(1) * za_end
    # B: z = b e^s, s in [0, ln(Z / b)] where Z > b
    s_end = torch.log(torch.clamp(zmax / b, min=1.0))
    t, wt = _rule(B_NODES, dt, dev)
    panel = s_end / B_PANELS
    s = (torch.arange(B_PANELS, dtype=dt, device=dev)[:, None] + t).reshape(-1)  # panel + node
    s = panel[:, None] * s
    z = b[:, None] * torch.exp(s)
    b_part = (w_fn(torch.sqrt(b[:, None] ** 2 + z * z), hh) * z * wt.repeat(B_PANELS)).sum(1) * panel
    return 2.0 * (a_part + b_part)


# ---------------------------------------------------------------------------
# the line profile
# ---------------------------------------------------------------------------

#: Dawson's F is tabulated at x_k = k / 16 for |x| < CORE_X; the
#: asymptotic series in 1 / x^2 takes over from there
_STEP = 1.0 / 16.0
CORE_X = 16.0
_TAYLOR_TERMS = 20


def _taylor(f0, x0, t, terms: int = _TAYLOR_TERMS):
    """F(x0 + t) from F(x0) by the Taylor series of Dawson's equation
    F' = 1 - 2 x F: (n + 1) c_{n+1} = [n = 0] - 2 (x0 c_n + c_{n-1})."""
    c_prev, c = f0, 1.0 - 2.0 * x0 * f0
    total, power = f0 + c * t, t
    for n in range(1, terms):
        c_prev, c = c, -2.0 * (x0 * c + c_prev) / (n + 1)
        power = power * t
        total = total + c * power
    return total


@lru_cache(maxsize=None)
def _dawson_nodes() -> np.ndarray:
    """F at x_k = k / 16, k = 0 .. 16 * CORE_X + 1, by stepping Dawson's
    equation from F(0) = 0 with its Taylor series (40 terms a step of 1/16:
    the terms fall as 1 / n!); the equation damps an error as it steps."""
    n = int(CORE_X / _STEP) + 2
    f = np.zeros(n)
    for k in range(1, n):
        f[k] = _taylor(f[k - 1], (k - 1) * _STEP, _STEP, terms=40)
    return f


#: the wing series' coefficients (2m + 1)!! / 2^m, m = 0 .. 12: the next term
#: is below 2^-53 of the sum from |x| = CORE_X on
_WING = tuple(math.prod(range(1, 2 * m + 2, 2)) / 2.0 ** m for m in range(13))


def _wing(ax):
    """(y, P(y)) with y = 1 / x^2 and P = sum_m (2m + 1)!! / 2^m y^m, the
    asymptotic series of Dawson's F = (1 + y P / 2) / (2 |x|), and of
    -corr(x) = 4 x F - 2 = y P, for |x| >= CORE_X (smaller |x| are taken
    as CORE_X)."""
    y = 1.0 / torch.clamp(ax * ax, min=CORE_X * CORE_X)
    series = torch.full_like(y, _WING[-1])
    for c in _WING[-2::-1]:  # Horner
        series = torch.addcmul(torch.full((), c, dtype=y.dtype, device=y.device), y, series)
    return y, series


def _core_dawson(ax):
    """F(|x|) for |x| <= CORE_X: the Taylor series of Dawson's equation
    about the nearest tabulated node (:func:`_dawson_nodes`)."""
    nodes = torch.as_tensor(_dawson_nodes(), dtype=ax.dtype, device=ax.device)
    k = torch.clamp(torch.round(ax / _STEP), max=nodes.shape[0] - 1).long()
    x0 = k.to(ax.dtype) * _STEP
    return _taylor(nodes[k], x0, ax - x0)


def dawson(x):
    """Dawson's integral F(x) = exp(-x^2) int_0^x exp(t^2) dt, in the dtype
    of ``x``: |x| < CORE_X by the Taylor series of Dawson's equation about
    the nearest tabulated node, beyond by its asymptotic series
    (:func:`_wing`). Odd in x."""
    ax = torch.abs(x)
    y, series = _wing(ax)
    far = (1.0 + 0.5 * y * series) / (2.0 * torch.clamp(ax, min=CORE_X))
    return torch.sign(x) * torch.where(ax < CORE_X, _core_dawson(torch.clamp(ax, max=CORE_X)), far)


def _voigt_parts(a, x):
    """The two parts of H(a, x) = e + a / sqrt(pi) g: g = -corr(x) = 4 x F(x)
    - 2 at every x (the wing series from |x| = CORE_X on, without the
    cancellation of 4 x F - 2), and e = exp(-x^2) (1 + a^2 (1 - 2 x^2)) at
    the indices ``near`` where |x| < CORE_X, a few percent of a spectrum's
    terms; beyond, e < 1e-111 adds nothing to the damping term in float64
    (a / x^2 > 1e-8 for any line of the configurations). Returns (g, near,
    e)."""
    ax = torch.abs(x)
    y, series = _wing(ax)
    g = y * series
    near = torch.nonzero(ax < CORE_X, as_tuple=True)
    xn = ax[near]
    x2 = xn * xn
    g[near] = 4.0 * xn * _core_dawson(xn) - 2.0
    an = a.expand_as(x)[near]
    return g, near, torch.exp(-x2) * (1.0 + an * an * (1.0 - 2.0 * x2))


def voigt_hjerting(a, x):
    """H(a, x) = exp(-x^2) (1 + a^2 (1 - 2 x^2)) - a / sqrt(pi) (2 - 4 x
    F(x)) in the dtype of ``x``, ``a`` broadcast to it (:func:`_voigt_parts`)."""
    a = torch.as_tensor(a, dtype=x.dtype, device=x.device)
    g, near, e = _voigt_parts(a, x)
    out = a * (1.0 / math.sqrt(math.pi)) * g
    out[near] += e
    return out


def voigt_damping_per_kms(gamma: float, rest_wavelength_angstrom: float) -> float:
    """a b_D (km/s) = Gamma lambda_0 / (4 pi) in km/s: the damping a of a
    line of Doppler width b_D is this over b_D."""
    return gamma * rest_wavelength_angstrom * 1e-8 / (4.0 * math.pi) / 1e5


def _profile(dv, inv_b, damping, *, voigt: bool, v_box, pair):
    """phi of offsets ``dv`` (P, bins) for lines of inverse Doppler width
    ``inv_b`` and damping ``damping`` (P, 1), in ``pair``: summed over the
    velocity images when ``v_box`` is given, after the wrap. A Voigt line
    sums its damping parts g over the images before the one product with
    a / sqrt(pi)."""
    dv, inv_b, damping = dv.to(pair), inv_b.to(pair), damping.to(pair)
    if v_box is None:
        shifts = [0.0]
    else:
        dv = dv - torch.round(dv / v_box) * v_box
        shifts = [k * v_box for k in range(-N_IMAGES, N_IMAGES + 1)]
    phi = torch.zeros_like(dv)  # a Gaussian's sum; a Voigt line's exp parts
    wing = torch.zeros_like(dv) if voigt else None
    for shift in shifts:
        x = (dv + shift) * inv_b
        if not voigt:
            phi += torch.exp(-(x * x))
            continue
        g, near, e = _voigt_parts(damping, x)
        wing += g
        phi.index_put_(near, e, accumulate=True)
    if voigt:
        phi += damping * (1.0 / math.sqrt(math.pi)) * wing
    return phi * ((1.0 / math.sqrt(math.pi)) * inv_b)


# ---------------------------------------------------------------------------
# the candidates
# ---------------------------------------------------------------------------


def _cells(px, py, rx, ry, s_max: float, box: float, periodic: bool):
    """(particle cells, ray cells, ncx, ncy) of a plain grid of cells at
    least ``s_max`` wide over the periodic box, or over the bounding box of
    particles and rays."""
    if periodic:
        x0 = y0 = 0.0
        lx = ly = box
    else:
        x0, y0 = min(float(px.min()), float(rx.min())), min(float(py.min()), float(ry.min()))
        lx = max(float(px.max()), float(rx.max())) - x0
        ly = max(float(py.max()), float(ry.max())) - y0
    ncx = max(1, min(int(lx / s_max), 4096))
    ncy = max(1, min(int(ly / s_max), 4096))

    def cell(x, y):
        cx = torch.clamp(torch.floor((x - x0) / lx * ncx).long(), 0, ncx - 1)
        cy = torch.clamp(torch.floor((y - y0) / ly * ncy).long(), 0, ncy - 1)
        return cy * ncx + cx

    return cell(px, py), cell(rx, ry), ncx, ncy


def _ring(n: int, periodic: bool) -> list:
    """Offsets of a cell's ring along an axis of ``n`` cells: -1, 0, 1, or
    every cell once where a periodic axis has fewer than 3."""
    return list(range(n)) if periodic and n < 3 else [-1, 0, 1]


def hits(px, py, s, rx, ry, *, box: float, periodic: bool, block: int):
    """Yield (ray, particle, b^2) of the (ray, particle) pairs with b < s,
    b^2 in the dtype of ``px``, the candidates taken in blocks of about
    ``block`` pairs."""
    dev = px.device
    if periodic:
        px, py = torch.remainder(px, box), torch.remainder(py, box)
        rx, ry = torch.remainder(rx, box), torch.remainder(ry, box)
    pcell, rcell, ncx, ncy = _cells(px, py, rx, ry, float(s.max()), box, periodic)
    order = torch.argsort(pcell)
    counts = torch.bincount(pcell, minlength=ncx * ncy)
    starts = torch.cumsum(counts, 0) - counts
    del pcell
    # each ray's ring of cells: (R, 9) cell ids, -1 where an open box ends
    rcx, rcy = rcell % ncx, rcell // ncx
    ring = []
    for oy in _ring(ncy, periodic):
        for ox in _ring(ncx, periodic):
            if periodic and ncx < 3:
                cx = torch.full_like(rcx, ox)
            else:
                cx = torch.remainder(rcx + ox, ncx) if periodic else rcx + ox
            if periodic and ncy < 3:
                cy = torch.full_like(rcy, oy)
            else:
                cy = torch.remainder(rcy + oy, ncy) if periodic else rcy + oy
            inside = (cx >= 0) & (cx < ncx) & (cy >= 0) & (cy < ncy)
            ring.append(torch.where(inside, cy * ncx + cx, -1))
    ring = torch.stack(ring, dim=1)
    ring_counts = torch.where(ring >= 0, counts[ring.clamp(min=0)], 0)
    cum = np.cumsum(ring_counts.sum(1).cpu().numpy())
    n_rays = ring.shape[0]
    r0 = 0
    while r0 < n_rays:
        # the next rays whose candidates fill about one block (at least one ray)
        done = int(cum[r0 - 1]) if r0 else 0
        r1 = max(int(np.searchsorted(cum, done + block, side="right")), r0 + 1)
        cnt = ring_counts[r0:r1].reshape(-1)
        cells = ring[r0:r1].reshape(-1)
        ray = (torch.arange(r0, r1, device=dev)[:, None].expand(-1, ring.shape[1])).reshape(-1)
        keep = cnt > 0
        cnt, cells, ray = cnt[keep], cells[keep], ray[keep]
        r0 = r1
        if cnt.numel() == 0:
            continue
        seg = torch.repeat_interleave(torch.arange(cnt.shape[0], device=dev), cnt)
        first = torch.cumsum(cnt, 0) - cnt
        p = order[starts[cells][seg] + (torch.arange(seg.shape[0], device=dev) - first[seg])]
        ray = ray[seg]
        del seg, first
        dx, dy = rx[ray] - px[p], ry[ray] - py[p]
        if periodic:
            dx = dx - torch.round(dx / box) * box
            dy = dy - torch.round(dy / box) * box
        b2 = dx * dx + dy * dy
        hit = b2 < s[p] * s[p]
        yield ray[hit], p[hit], b2[hit]


# ---------------------------------------------------------------------------
# the product
# ---------------------------------------------------------------------------


def los_inputs(inputs: dict, config: dict, device, place=torch.float64) -> dict:
    """The particles' plane coordinates, h, payload, line velocity and
    Doppler width, and the rays, in ``place`` on ``device``; the box, v_box
    and the bin centres (float64)."""
    product, snap = config["product"], config["snapshot"]
    los, (i, j) = AXES[product["axis"]]
    pos = inputs["positions"].to(device)
    z = float(snap["redshift"])
    hubble = 100.0 * float(snap["hubble_h"]) * math.sqrt(
        float(snap["omega_m"]) * (1.0 + z) ** 3 + float(snap["omega_lambda"]))
    dv_dx = hubble / (1.0 + z)  # km/s per cMpc: H(z) a
    box = float(inputs["box"])
    v_box = box * dv_dx
    mass_ion = float(product["atomic_weight"]) * AMU_CGS
    temp = inputs["temperatures"].to(device).double()
    n_bins = int(product["n_bins"])
    return {
        "x": pos[:, i].to(place), "y": pos[:, j].to(place), "h": inputs["smoothing_lengths"].to(device).double(),
        "m": inputs["masses"].to(device).double(),
        "v": (pos[:, los].double() * dv_dx + inputs["velocities"].to(device)[:, los].double()).to(place),
        "b": torch.clamp(torch.sqrt(2.0 * BOLTZMANN_CGS * temp / mass_ion) / 1e5, min=1e-3),
        "rx": torch.as_tensor(np.asarray(inputs["ray_x"]), dtype=torch.float64, device=device).to(place),
        "ry": torch.as_tensor(np.asarray(inputs["ray_y"]), dtype=torch.float64, device=device).to(place),
        "box": box, "v_box": v_box,
        "v_centres": (torch.arange(n_bins, dtype=torch.float64, device=device) + 0.5) * (v_box / n_bins),
    }


def sightlines(inputs: dict, config: dict, device, *, control: bool = False) -> tuple:
    """(columns (R,), tau (R, n_bins)) on ``device``, float64 (float32 for
    the control), from the module's semantics."""
    place = torch.float32 if control else torch.float64
    pair = torch.bfloat16 if control else torch.float64
    acc = torch.float32 if control else torch.float64
    product = config["product"]
    periodic = bool(product["periodic"])
    voigt = product["profile"] == "voigt"
    k_damp = voigt_damping_per_kms(float(product["gamma_per_s"]), float(product["rest_wavelength_angstrom"])) \
        if voigt else 0.0
    li = los_inputs(inputs, config, device, place)
    n_rays, n_bins = li["rx"].shape[0], li["v_centres"].shape[0]
    columns = torch.zeros(n_rays, dtype=acc, device=device)
    tau = torch.zeros(n_rays, n_bins, dtype=acc, device=device)
    v_box = li["v_box"] if periodic else None
    block = 1 << (26 if torch.device(device).type == "cuda" else 20)
    s = (SUPPORT * li["h"]).to(place)
    vc = li["v_centres"].to(place)
    rays, parts, weights = [], [], []
    for ray, p, b2 in hits(li["x"], li["y"], s, li["rx"], li["ry"], box=li["box"], periodic=periodic, block=block):
        h = li["h"][p].to(pair)
        w = li["m"][p].to(pair) * integrated_kernel(torch.sqrt(b2.to(pair)), h, kernel=config["kernel"])
        w = torch.where(b2.to(pair) < (SUPPORT * h) ** 2, w, torch.zeros((), dtype=pair, device=device))
        columns.index_add_(0, ray, w.to(acc))
        rays.append(ray)
        parts.append(p)
        weights.append(w)
    if not rays:
        return columns, tau
    # the hits by particle: a particle's profile is evaluated once a block
    p = torch.cat(parts)
    order = torch.argsort(p, stable=True)
    ray, p, w = torch.cat(rays)[order], p[order], torch.cat(weights)[order]
    del rays, parts, weights, order
    step = max(1, block // n_bins)
    for lo in range(0, p.shape[0], step):
        sl = slice(lo, lo + step)
        uniq, inv = torch.unique_consecutive(p[sl], return_inverse=True)
        inv_b = (1.0 / li["b"][uniq])[:, None]
        dv = vc[None, :] - li["v"][uniq][:, None]  # placement precision
        phi = _profile(dv, inv_b, k_damp * inv_b, voigt=voigt, v_box=v_box, pair=pair)
        tau.index_add_(0, ray[sl], (w[sl, None] * phi[inv]).to(acc))
        del phi, dv
    return columns, tau


def maps(inputs: dict, config: dict, device, *, control: bool = False) -> list:
    """The one answer: the columns' view as ``surface_density`` and the
    spectra as ``tau``, float64 NumPy (see the module's doc)."""
    columns, tau = sightlines(inputs, config, device, control=control)
    return [{"surface_density": columns_view(columns.double().cpu().numpy()), "tau": tau.double().cpu().numpy()}]


# ---------------------------------------------------------------------------
# the least time
# ---------------------------------------------------------------------------

#: FP32 operations of the line-integrated kernel a (ray, particle) pair inside
#: a support: the offsets and b^2 (6), its argument (8) and a 44-step
#: Clenshaw recurrence (3 each); then a multiply-add a field
COLUMN_PAIR_OPS = 140
#: exp(-z^2) rounds to 0 in f32 once z^2 > 103.3 (below the least subnormal)
GAUSS_Z_MAX = math.sqrt(103.3)
VOIGT_CORE_X = 7.0  # the program's Chebyshev fit of corr(x) for |x| <= 7
# FP32 operations of a line profile (an FMA counts 2). A term is one bin at
# one velocity image, z = (dv + k v_box) / b.
TERM_OPS = 2  # each term: the scale by 1/b, x^2
IMAGE_OPS = 2  # each term past the first of its bin: the image offset k v_box, the sum over images
EXP_OPS = 4  # exp(-x^2): range reduction and scaling around the hardware exp2
CHEB_OPS = 96  # corr(x), |x| <= 7: u = x / 3.5 - 1 and 2u (3), 30 Clenshaw steps (90), the last (3)
SERIES_OPS = 12  # corr(x), |x| > 7: t = 1/x^2 (1), five Horner steps (10), times -t (1)
GAUSS_TERM_OPS = TERM_OPS + EXP_OPS  # 6
VOIGT_EXP_OPS = EXP_OPS + 4 + 1  # exp(-x^2) (1 + a^2 (1 - 2 x^2)): exp, the factor, the product
VOIGT_CORE_OPS = TERM_OPS + CHEB_OPS + VOIGT_EXP_OPS  # 107
VOIGT_WING_EXP_OPS = TERM_OPS + SERIES_OPS + VOIGT_EXP_OPS  # 23
VOIGT_SERIES_OPS = TERM_OPS + SERIES_OPS  # 14
# once a (particle, bin): the offset from the line, its wrap, the scale by
# 1 / (sqrt(pi) b); a Voigt also H = g - a / sqrt(pi) corr over the images' sums (2)
BIN_OPS = 3
VOIGT_BIN_OPS = BIN_OPS + 2


def _inside_area(x, y, r, box: float, rows: int = 256):
    """The area of each disc of radius ``r`` at (``x``, ``y``) inside the
    square [0, box]^2: pi r^2 where it lies wholly inside, else by the
    midpoint rule over ``rows`` strips (within 0.1 %)."""
    inside = (x - r >= 0) & (x + r <= box) & (y - r >= 0) & (y + r <= box)
    area = math.pi * r * r
    part = torch.nonzero(~inside).squeeze(1)
    if part.numel():
        px, py, pr = x[part, None], y[part, None], r[part, None]
        y0, y1 = torch.clamp(py - pr, 0.0, box), torch.clamp(py + pr, 0.0, box)
        frac = (torch.arange(rows, dtype=x.dtype, device=x.device) + 0.5) / rows
        w = torch.sqrt(torch.clamp(pr * pr - (y0 + (y1 - y0) * frac - py) ** 2, min=0.0))
        chord = torch.clamp(torch.clamp(px + w, max=box) - torch.clamp(px - w, min=0.0), min=0.0)
        area[part] = chord.mean(dim=1) * (y1 - y0)[:, 0]
    return area


def _expected_hits(li: dict, n_rays: int, periodic: bool):
    """Expected rays inside each particle's support, the rays uniform over
    the box: its area pi (2h)^2 (periodic; the area inside the box in an
    open one, :func:`_inside_area`) times R / box^2."""
    s, box = SUPPORT * li["h"], li["box"]
    area = math.pi * s * s if periodic else _inside_area(li["x"].double(), li["y"].double(), s, box)
    return area * (n_rays / box ** 2)


def spectra_ops(li: dict, n_rays: int, n_bins: int, periodic: bool, voigt: bool, n_images: int) -> dict:
    """The FP32 operations of the spectra (``chip_smoke.py::spectra_work``,
    frozen), as expected values over uniform random rays. A particle is hit
    by lam rays (:func:`_expected_hits`), and by at least one with
    probability 1 - exp(-lam). The work is: per hit, its column weight
    (COLUMN_PAIR_OPS); per particle hit at all, its profile once (the rays
    share it), term by term (a Gaussian's where exp(-z^2) is not 0 in f32;
    a Voigt's everywhere, by the branch it takes), with IMAGE_OPS for each
    term past the first of its bin and the bin's own work once; per hit, one
    multiply-add into tau at every bin where the profile is not 0."""
    h, v, b = li["h"], li["v"].double(), li["b"]
    lam = _expected_hits(li, n_rays, periodic)
    hit_any = -torch.expm1(-lam)
    images = 2 * n_images + 1
    vc = li["v_centres"]
    dv = float(vc[1] - vc[0])
    total = float(n_bins * images)
    lo, hi = float(vc[0]) - 0.5 * dv, float(vc[-1]) + 0.5 * dv

    def within(radius):
        """Expected terms with |dv + k v_box| < radius: the images of a
        periodic axis tile it, an open one is cut at the bin range."""
        if periodic:
            return torch.clamp(2.0 * radius / dv, max=total)
        return (torch.clamp(v + radius, max=hi) - torch.clamp(v - radius, min=lo)).clamp_min(0.0) / dv

    near = within(GAUSS_Z_MAX * b)
    if voigt:
        core = within(VOIGT_CORE_X * b)
        series = (total - near).clamp_min(0.0)
        terms = torch.full_like(h, total)
        term_ops = core * VOIGT_CORE_OPS + (near - core) * VOIGT_WING_EXP_OPS + series * VOIGT_SERIES_OPS
        bins = torch.full_like(h, float(n_bins))
        bin_ops = VOIGT_BIN_OPS
    else:
        terms = near
        term_ops = terms * GAUSS_TERM_OPS
        bins = torch.clamp(terms, max=float(n_bins))
        bin_ops = BIN_OPS
    profile_ops = term_ops + (terms - bins) * IMAGE_OPS + bins * bin_ops
    ops = hit_any * profile_ops + lam * (2.0 * bins + COLUMN_PAIR_OPS)
    return {"ops": float(ops.sum()), "hits": float(lam.sum()), "particles_hit": float(hit_any.sum()),
            "velocity_images": images}


def work(inputs: dict, config: dict, device) -> dict:
    """The least time of one product (``counting.least_seconds``), and of
    its parts under ``columns`` and ``spectra``. The columns: each particle's
    plane coordinates, h and mass read once as float32 and each ray's
    column written once, and COLUMN_PAIR_OPS + 2 FP32 operations a hit. The
    spectra: the same inputs with the line velocity and Doppler width, the
    (R, n_bins) float32 spectra written once, and :func:`spectra_ops`'s
    count, the program's velocity images (7 for a Voigt line; for a
    Gaussian the images within reach of exp(-36) of the widest line, up to
    3 a side). The whole product: the sum of both counts."""
    product = config["product"]
    periodic = bool(product["periodic"])
    voigt = product["profile"] == "voigt"
    li = los_inputs(inputs, config, device, torch.float32)
    n, n_rays, n_bins = li["h"].shape[0], li["rx"].shape[0], int(product["n_bins"])
    n_images = 0
    if periodic:
        b_max = float(li["b"].max())
        n_images = 3 if voigt else min(3, max(0, int(math.ceil(6.0 * b_max / li["v_box"] + 0.5)) - 1))
    spec = spectra_ops(li, n_rays, n_bins, periodic, voigt, n_images)
    col_ops = spec["hits"] * (COLUMN_PAIR_OPS + 2)
    col_bytes = 4.0 * n * 4 + 4.0 * n_rays * 3
    spec_bytes = 4.0 * n * 6 + 4.0 * n_rays * (2 + n_bins)
    return {**least_seconds(col_bytes + spec_bytes, col_ops + spec["ops"]),
            "columns": least_seconds(col_bytes, col_ops), "spectra": least_seconds(spec_bytes, spec["ops"]),
            "hits": spec["hits"], "particles_hit": spec["particles_hit"]}
