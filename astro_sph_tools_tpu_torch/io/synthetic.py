"""Synthetic EAGLE-schema dataset generator (test fixture + benchmark data).

Counterpart: ``astro_sph_tools_tpu/io/synthetic.py``, copied with the same
random draws in the same order, datasets, attributes, dtypes and file
splits, so both packages write equal files from one spec. ``h5py`` is
named through ``io/_lazy.py``: importing this module does not import it,
the first write does. :func:`generate_particles` needs only NumPy.

Writes multi-file HDF5 snapshots (and SUBFIND-style catalogues) with the
exact header/attribute schema the reference consumes and SURVEY.md §4 calls
for ("tiny synthetic EAGLE-format HDF5 snapshots ... written by a fixture
generator"). Schema replicated from ``astro_sph_tools/io/EAGLE/
_SnapshotEAGLE.py:78-113`` (snapshot) and `_CatalogueSUBFIND.py:66-104`
(catalogue):

- ``Header`` attrs: Redshift, HubbleParam, ExpansionFactor, OmegaBaryon,
  NumPart_Total, NumPart_ThisFile, MassTable, BoxSize (internal h^-1 Mpc).
- ``Constants`` attrs: Z_Solar. ``Units`` attrs: UnitLength_in_cm etc.
- ``PartType{n}`` datasets each carrying ``h-scale-exponent``,
  ``aexp-scale-exponent``, ``CGSConversionFactor`` attrs (EAGLE's recipe:
  physical = raw * h^h_exp * a^a_exp * cgs).
- Gas fields: ParticleIDs, Coordinates, Velocity, Mass, SmoothingLength,
  Density, Temperature, StarFormationRate, Metallicity,
  MetalMassWeightedRedshift, ElementAbundance/<FullName>, GroupNumber.

Values are generated in *physical comoving h-full* units (Mpc, Msun, km/s)
and converted to EAGLE internal units here, so reader tests genuinely
exercise the unit algebra rather than round-tripping raw numbers.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .. import constants as C
from ..data_structures.particle_types import ParticleType
from ._lazy import h5py

# EAGLE internal-unit conventions (h^-1 Mpc, 1e10 h^-1 Msun, km/s)
LENGTH_CGS = C.MEGAPARSEC_CGS
MASS_CGS = 1.989e43  # 1e10 Msun in g, the value EAGLE files carry
VELOCITY_CGS = 1.0e5
DENSITY_CGS = MASS_CGS / LENGTH_CGS**3
TIME_CGS = LENGTH_CGS / VELOCITY_CGS
ENERGY_CGS = MASS_CGS * VELOCITY_CGS**2
PRESSURE_CGS = MASS_CGS / LENGTH_CGS / TIME_CGS**2
MSUN_IN_1E10 = C.SOLAR_MASS_CGS / MASS_CGS  # Msun in internal mass units

ELEMENT_FULL_NAMES = {
    "H": "Hydrogen", "He": "Helium", "C": "Carbon", "N": "Nitrogen",
    "O": "Oxygen", "Ne": "Neon", "Mg": "Magnesium", "Si": "Silicon", "Fe": "Iron",
}


@dataclass
class SyntheticSnapshotSpec:
    """Parameters for a synthetic EAGLE-format snapshot."""

    box_size_mpc: float = 10.0  # comoving h-full Mpc
    redshift: float = 0.5
    hubble_param: float = 0.6777
    omega_baryon: float = 0.04825
    n_gas: int = 4096
    n_dm: int = 4096
    n_star: int = 512
    n_bh: int = 8
    n_files: int = 2
    snapshot_number: int = 12
    seed: int = 20240509
    clustered: bool = False  # add Gaussian blobs over the uniform background
    solar_metallicity: float = 0.012663729
    n_groups: int = 8  # FOF groups for GroupNumber / catalogue files
    #: sort each type by Morton key of position before splitting into files,
    #: mimicking the Peano-Hilbert-ordered storage of real EAGLE outputs
    #: (pyread_eagle hash cells, `_SnapshotEAGLE.py:115-130`) — what makes
    #: the reader's spatial block index prune effectively
    spatial_order: bool = False
    #: write NumPart_Total as the uint32 low word plus the
    #: NumPart_Total_HighWord attr, as real EAGLE headers do
    numpart_highword: bool = False
    #: override the header totals (e.g. to fake a >2^32 count without
    #: writing that many particles); int64 per-slot values
    numpart_total_override: Optional[tuple] = None
    #: write a snipshot (``snipshot_*/snip_*`` naming, reduced field set:
    #: no ElementAbundance, MetalMassWeightedRedshift, StarFormationRate or
    #: Temperature — the reference's snipshot semantics,
    #: `_SnapshotEAGLE.py:69-74` naming, §2.1 snipshot field guards)
    snipshot: bool = False
    #: SWIFT writer only: emit the native ``Cells`` spatial metadata with
    #: this many top-level cells per axis (0 = none). Particles are sorted
    #: into cell order, as SWIFT outputs are on disk
    swift_cells_dim: int = 0

    @property
    def expansion_factor(self) -> float:
        return 1.0 / (1.0 + self.redshift)

    @property
    def tag(self) -> str:
        zint = int(self.redshift)
        zdec = int(round((self.redshift - zint) * 1000))
        return f"{self.snapshot_number:03d}_z{zint:03d}p{zdec:03d}"


@dataclass
class SyntheticParticles:
    """Ground-truth physical fields (comoving h-full: Mpc, Msun, km/s, K)."""

    positions: dict = field(default_factory=dict)  # (N, 3) Mpc
    velocities: dict = field(default_factory=dict)  # (N, 3) km/s
    masses: dict = field(default_factory=dict)  # (N,) Msun
    smoothing: dict = field(default_factory=dict)  # (N,) Mpc
    ids: dict = field(default_factory=dict)  # (N,) int64
    group_numbers: dict = field(default_factory=dict)  # (N,) int32
    density: Optional[np.ndarray] = None  # gas, Msun/Mpc^3 (comoving h-full)
    temperature: Optional[np.ndarray] = None  # gas, K
    sfr: Optional[np.ndarray] = None  # gas, Msun/yr
    metallicity: dict = field(default_factory=dict)  # gas/star
    enrichment_z: dict = field(default_factory=dict)
    abundances: dict = field(default_factory=dict)  # gas/star -> {symbol: (N,)}
    bh_subgrid_mass: Optional[np.ndarray] = None
    dm_particle_mass: float = 0.0  # Msun
    group_centres: Optional[np.ndarray] = None  # (n_groups, 3) Mpc


def _positions(rng, n, box, clustered, n_groups, centres):
    if not clustered:
        return rng.uniform(0.0, box, (n, 3))
    n_blob = n // 2
    base = rng.uniform(0.0, box, (n - n_blob, 3))
    which = rng.integers(0, n_groups, n_blob)
    blob = centres[which] + rng.normal(0.0, box * 0.02, (n_blob, 3))
    return np.concatenate([base, np.mod(blob, box)], axis=0)


def generate_particles(spec: SyntheticSnapshotSpec) -> SyntheticParticles:
    rng = np.random.default_rng(spec.seed)
    box = spec.box_size_mpc
    out = SyntheticParticles()
    out.group_centres = rng.uniform(0.0, box, (spec.n_groups, 3))

    counts = {
        ParticleType.gas: spec.n_gas,
        ParticleType.dark_matter: spec.n_dm,
        ParticleType.star: spec.n_star,
        ParticleType.black_hole: spec.n_bh,
    }
    next_id = 1
    for pt, n in counts.items():
        out.positions[pt] = _positions(rng, n, box, spec.clustered, spec.n_groups, out.group_centres)
        out.velocities[pt] = rng.normal(0.0, 150.0, (n, 3))
        out.ids[pt] = np.arange(next_id, next_id + n, dtype=np.int64)
        next_id += n
        # nearest group assignment with some unbound negatives
        d = np.linalg.norm(
            (out.positions[pt][:, None, :] - out.group_centres[None, :, :] + box / 2) % box
            - box / 2,
            axis=2,
        )
        nearest = np.argmin(d, axis=1).astype(np.int32) + 1
        near = d[np.arange(n), nearest - 1] < box * 0.08
        gn = np.where(near, nearest, 2**30)
        unbound = near & (rng.random(n) < 0.1)
        gn = np.where(unbound, -nearest, gn)
        out.group_numbers[pt] = gn.astype(np.int32)

    mean_ips = box / max(spec.n_gas, 1) ** (1.0 / 3.0)
    for pt in (ParticleType.gas, ParticleType.star, ParticleType.black_hole):
        n = counts[pt]
        out.smoothing[pt] = mean_ips * 10.0 ** rng.uniform(-0.3, 0.5, n)
        out.masses[pt] = 10.0 ** rng.uniform(5.8, 6.4, n)  # Msun

    out.dm_particle_mass = 6.57e6  # Msun
    out.masses[ParticleType.dark_matter] = np.full(spec.n_dm, out.dm_particle_mass)

    ng = spec.n_gas
    out.density = 10.0 ** rng.uniform(8.0, 13.0, ng)  # Msun/Mpc^3
    out.temperature = 10.0 ** rng.uniform(3.5, 7.5, ng)
    out.sfr = np.where(rng.random(ng) < 0.1, 10.0 ** rng.uniform(-3, 0, ng), 0.0)
    out.bh_subgrid_mass = 10.0 ** rng.uniform(5.0, 7.0, spec.n_bh)

    for pt in (ParticleType.gas, ParticleType.star):
        n = counts[pt]
        out.metallicity[pt] = 10.0 ** rng.uniform(-4.0, -1.5, n)
        out.enrichment_z[pt] = rng.uniform(spec.redshift, 10.0, n)
        ab = {}
        ab["H"] = rng.uniform(0.70, 0.76, n)
        ab["He"] = 1.0 - ab["H"] - out.metallicity[pt]
        for sym in ("C", "N", "O", "Ne", "Mg", "Si", "Fe"):
            ab[sym] = out.metallicity[pt] * rng.uniform(0.01, 0.3, n)
        out.abundances[pt] = ab
    if spec.spatial_order:
        _sort_spatially(out, box)
    return out


def _morton_key_3d(pos: np.ndarray, box: float, bits: int = 7) -> np.ndarray:
    """Morton (z-order) key of each position on a 2^bits cell grid."""
    cell = np.clip(
        (pos / box * (1 << bits)).astype(np.int64), 0, (1 << bits) - 1
    )
    key = np.zeros(pos.shape[0], dtype=np.int64)
    for b in range(bits):
        for ax in range(3):
            key |= ((cell[:, ax] >> b) & 1) << (3 * b + (2 - ax))
    return key


def _reorder_type(p: SyntheticParticles, pt, order: np.ndarray) -> None:
    """Apply one permutation to every per-type array of ``pt`` (in place) —
    the single place new SyntheticParticles fields must be threaded into."""
    for d in (p.positions, p.velocities, p.masses, p.smoothing, p.ids,
              p.group_numbers, p.metallicity, p.enrichment_z):
        if pt in d:
            d[pt] = d[pt][order]
    if pt in p.abundances:
        p.abundances[pt] = {
            sym: arr[order] for sym, arr in p.abundances[pt].items()
        }
    if pt == ParticleType.gas:
        p.density = p.density[order]
        p.temperature = p.temperature[order]
        p.sfr = p.sfr[order]
    if pt == ParticleType.black_hole and p.bh_subgrid_mass is not None:
        p.bh_subgrid_mass = p.bh_subgrid_mass[order]


def _sort_spatially(p: SyntheticParticles, box: float) -> None:
    """Reorder every per-type array by Morton key of position (in place)."""
    for pt in list(p.positions):
        order = np.argsort(
            _morton_key_3d(p.positions[pt], box), kind="stable"
        )
        _reorder_type(p, pt, order)


def write_snapshot(
    directory: str, spec: SyntheticSnapshotSpec, particles: Optional[SyntheticParticles] = None
) -> tuple[str, SyntheticParticles]:
    """Write a multi-file EAGLE-format snapshot; returns (first file path, truth)."""
    p = particles or generate_particles(spec)
    h = spec.hubble_param
    a = spec.expansion_factor
    tag = spec.tag
    kind, prefix = (
        ("snipshot", "snip") if spec.snipshot else ("snapshot", "snap")
    )
    snap_dir = os.path.join(directory, f"{kind}_{tag}")
    os.makedirs(snap_dir, exist_ok=True)

    counts = {pt: len(p.ids[pt]) for pt in ParticleType.get_all()}
    num_part_total = np.zeros(6, dtype=np.int64)
    for pt in ParticleType.get_all():
        num_part_total[pt.value] = counts[pt]

    # physical (comoving h-full) -> internal raw: raw = phys / (h^h_exp * cgs)
    def to_internal_length(mpc):  # h_exp = -1
        return mpc * h  # internal h^-1 Mpc

    def to_internal_mass(msun):  # h_exp = -1
        return msun * h * MSUN_IN_1E10

    def to_internal_velocity(kms):  # h_exp = 0, a_exp = 0.5: raw = phys / a^0.5...
        # comoving user value uses a_exp=0, so raw = phys directly in km/s
        return kms

    def to_internal_density(msun_mpc3):  # h_exp = +2
        return msun_mpc3 / h**2 * (C.SOLAR_MASS_CGS / C.MEGAPARSEC_CGS**3) / DENSITY_CGS

    # split particles across files
    splits = {}
    for pt in ParticleType.get_all():
        n = counts[pt]
        edges = np.linspace(0, n, spec.n_files + 1).astype(int)
        splits[pt] = [(edges[i], edges[i + 1]) for i in range(spec.n_files)]

    def attrs(ds, h_exp, a_exp, cgs):
        ds.attrs["h-scale-exponent"] = float(h_exp)
        ds.attrs["aexp-scale-exponent"] = float(a_exp)
        ds.attrs["CGSConversionFactor"] = float(cgs)

    first_path = None
    for fi in range(spec.n_files):
        path = os.path.join(snap_dir, f"{prefix}_{tag}.{fi}.hdf5")
        if fi == 0:
            first_path = path
        with h5py.File(path, "w") as f:
            hdr = f.create_group("Header")
            hdr.attrs["Redshift"] = spec.redshift
            hdr.attrs["HubbleParam"] = h
            hdr.attrs["ExpansionFactor"] = a
            hdr.attrs["OmegaBaryon"] = spec.omega_baryon
            hdr.attrs["Omega0"] = 0.307
            totals = (
                num_part_total
                if spec.numpart_total_override is None
                else np.asarray(spec.numpart_total_override, dtype=np.int64)
            )
            if spec.numpart_highword:
                hdr.attrs["NumPart_Total"] = (
                    totals & np.int64(0xFFFFFFFF)
                ).astype(np.uint32)
                hdr.attrs["NumPart_Total_HighWord"] = (totals >> 32).astype(
                    np.uint32
                )
            else:
                hdr.attrs["NumPart_Total"] = totals
            hdr.attrs["NumPart_ThisFile"] = _num_this_file(splits, fi)
            hdr.attrs["NumFilesPerSnapshot"] = spec.n_files
            mass_table = np.zeros(6, dtype=np.float64)
            mass_table[1] = to_internal_mass(p.dm_particle_mass)
            hdr.attrs["MassTable"] = mass_table
            hdr.attrs["BoxSize"] = to_internal_length(spec.box_size_mpc)

            const = f.create_group("Constants")
            const.attrs["Z_Solar"] = spec.solar_metallicity

            units = f.create_group("Units")
            units.attrs["UnitLength_in_cm"] = LENGTH_CGS
            units.attrs["UnitMass_in_g"] = MASS_CGS
            units.attrs["UnitVelocity_in_cm_per_s"] = VELOCITY_CGS
            units.attrs["UnitDensity_in_cgs"] = DENSITY_CGS
            units.attrs["UnitEnergy_in_cgs"] = ENERGY_CGS
            units.attrs["UnitPressure_in_cgs"] = PRESSURE_CGS
            units.attrs["UnitTime_in_s"] = TIME_CGS

            for pt in ParticleType.get_all():
                i0, i1 = splits[pt][fi]
                g = f.create_group(pt.common_hdf5_name)
                g.create_dataset("ParticleIDs", data=p.ids[pt][i0:i1])
                ds = g.create_dataset(
                    "Coordinates", data=to_internal_length(p.positions[pt][i0:i1])
                )
                attrs(ds, -1.0, 1.0, LENGTH_CGS)
                ds = g.create_dataset(
                    "Velocity", data=to_internal_velocity(p.velocities[pt][i0:i1])
                )
                attrs(ds, 0.0, 0.5, VELOCITY_CGS)
                ds = g.create_dataset("GroupNumber", data=p.group_numbers[pt][i0:i1])

                if pt != ParticleType.dark_matter:
                    ds = g.create_dataset("Mass", data=to_internal_mass(p.masses[pt][i0:i1]))
                    attrs(ds, -1.0, 0.0, MASS_CGS)
                    ds = g.create_dataset(
                        "SmoothingLength", data=to_internal_length(p.smoothing[pt][i0:i1])
                    )
                    attrs(ds, -1.0, 1.0, LENGTH_CGS)

                if pt == ParticleType.black_hole:
                    ds = g.create_dataset(
                        "BH_Mass", data=to_internal_mass(p.bh_subgrid_mass[i0:i1])
                    )
                    attrs(ds, -1.0, 0.0, MASS_CGS)

                if pt == ParticleType.gas:
                    ds = g.create_dataset(
                        "Density", data=to_internal_density(p.density[i0:i1])
                    )
                    attrs(ds, 2.0, -3.0, DENSITY_CGS)
                    if not spec.snipshot:
                        ds = g.create_dataset("Temperature", data=p.temperature[i0:i1])
                        attrs(ds, 0.0, 0.0, 1.0)
                        ds = g.create_dataset("StarFormationRate", data=p.sfr[i0:i1])
                        attrs(ds, 0.0, 0.0, C.SOLAR_MASS_CGS / C.YEAR_CGS)

                if pt in (ParticleType.gas, ParticleType.star):
                    ds = g.create_dataset("Metallicity", data=p.metallicity[pt][i0:i1])
                    attrs(ds, 0.0, 0.0, 1.0)
                    if not spec.snipshot:
                        ds = g.create_dataset(
                            "MetalMassWeightedRedshift", data=p.enrichment_z[pt][i0:i1]
                        )
                        attrs(ds, 0.0, 0.0, 1.0)
                        ab = g.create_group("ElementAbundance")
                        for sym, full in ELEMENT_FULL_NAMES.items():
                            ab.create_dataset(full, data=p.abundances[pt][sym][i0:i1])
    return first_path, p


def _num_this_file(splits, fi) -> np.ndarray:
    """NumPart_ThisFile vector over the 6 HDF5 particle slots."""
    out = np.zeros(6, dtype=np.int64)
    for pt, sl in splits.items():
        out[pt.value] = sl[fi][1] - sl[fi][0]
    return out


def write_swift_snapshot(
    directory: str,
    spec: SyntheticSnapshotSpec,
    particles: Optional[SyntheticParticles] = None,
) -> tuple[str, SyntheticParticles]:
    """Write a SWIFT-format snapshot (h-free on disk, per-field CGS attrs).

    Schema per the framework's SWIFT reader docstring: values are the same
    physical truth used for EAGLE fixtures, so cross-backend tests can assert
    identical user-facing data.
    """
    p = particles or generate_particles(spec)
    path = os.path.join(directory, f"swift_{spec.snapshot_number:04d}.hdf5")
    cgs_key = "Conversion factor to CGS (not including cosmological corrections)"

    cell_layout = None
    if spec.swift_cells_dim:
        # sort each type into top-level-cell order (mutates p, which is
        # also the returned truth) and build per-cell counts/offsets —
        # SWIFT's native on-disk spatial index
        cell_layout = _sort_into_swift_cells(
            p, spec.box_size_mpc, spec.swift_cells_dim
        )

    counts = {pt: len(p.ids[pt]) for pt in ParticleType.get_all()}
    num_total = np.zeros(6, dtype=np.int64)
    for pt in ParticleType.get_all():
        num_total[pt.value] = counts[pt]

    with h5py.File(path, "w") as f:
        hdr = f.create_group("Header")
        hdr.attrs["Redshift"] = np.array([spec.redshift])
        hdr.attrs["Scale-factor"] = np.array([spec.expansion_factor])
        hdr.attrs["NumPart_Total"] = num_total
        hdr.attrs["NumPart_ThisFile"] = num_total
        hdr.attrs["BoxSize"] = np.full(3, spec.box_size_mpc)  # internal U_L = Mpc
        cos = f.create_group("Cosmology")
        cos.attrs["h"] = np.array([spec.hubble_param])
        cos.attrs["Omega_b"] = np.array([spec.omega_baryon])
        units = f.create_group("Units")
        units.attrs["Unit length in cgs (U_L)"] = np.array([C.MEGAPARSEC_CGS])
        units.attrs["Unit mass in cgs (U_M)"] = np.array([C.SOLAR_MASS_CGS])

        def mk(group, name, data, cgs, a_exp):
            ds = group.create_dataset(name, data=data)
            ds.attrs[cgs_key] = cgs
            ds.attrs["a-scale exponent"] = np.array([a_exp])
            return ds

        for pt in ParticleType.get_all():
            g = f.create_group(pt.common_hdf5_name)
            mk(g, "Coordinates", p.positions[pt], C.MEGAPARSEC_CGS, 1.0)
            mk(g, "Velocities", p.velocities[pt], 1.0e5, 0.5)
            mk(g, "ParticleIDs", p.ids[pt], 1.0, 0.0)
            if pt == ParticleType.black_hole:
                mk(g, "DynamicalMasses", p.masses[pt], C.SOLAR_MASS_CGS, 0.0)
                mk(g, "SubgridMasses", p.bh_subgrid_mass, C.SOLAR_MASS_CGS, 0.0)
            else:
                mk(g, "Masses", p.masses[pt], C.SOLAR_MASS_CGS, 0.0)
            if pt != ParticleType.dark_matter:
                mk(g, "SmoothingLengths", p.smoothing[pt], C.MEGAPARSEC_CGS, 1.0)
            if pt == ParticleType.gas:
                mk(g, "Densities", p.density, C.SOLAR_MASS_CGS / C.MEGAPARSEC_CGS**3, -3.0)
                mk(g, "Temperatures", p.temperature, 1.0, 0.0)
                mk(g, "StarFormationRates", p.sfr, C.SOLAR_MASS_CGS / C.YEAR_CGS, 0.0)
            if pt in (ParticleType.gas, ParticleType.star):
                mk(g, "MetalMassFractions", p.metallicity[pt], 1.0, 0.0)
                mk(g, "MeanMetalWeightedRedshifts", p.enrichment_z[pt], 1.0, 0.0)
                order = ("H", "He", "C", "N", "O", "Ne", "Mg", "Si", "Fe")
                emf = np.stack([p.abundances[pt][s] for s in order], axis=1)
                mk(g, "ElementMassFractions", emf, 1.0, 0.0)

        if cell_layout is not None:
            dim = spec.swift_cells_dim
            csize = spec.box_size_mpc / dim
            nc = dim**3
            cells = f.create_group("Cells")
            meta = cells.create_group("Meta-data")
            meta.attrs["dimension"] = np.array([dim, dim, dim], np.int32)
            meta.attrs["size"] = np.full(3, csize)
            meta.attrs["nr_cells"] = np.array([nc], np.int32)
            ii = np.arange(nc)
            ci, cj, ck = ii // (dim * dim), (ii // dim) % dim, ii % dim
            cells.create_dataset(
                "Centres",
                data=np.stack(
                    [(ci + 0.5) * csize, (cj + 0.5) * csize, (ck + 0.5) * csize],
                    axis=1,
                ),
            )
            counts_g = cells.create_group("Counts")
            off_g = cells.create_group("OffsetsInFile")
            files_g = cells.create_group("Files")
            for pt, (c_counts, c_offsets) in cell_layout.items():
                name = pt.common_hdf5_name
                counts_g.create_dataset(name, data=c_counts)
                off_g.create_dataset(name, data=c_offsets)
                files_g.create_dataset(name, data=np.zeros(nc, np.int32))
    return path, p


def _sort_into_swift_cells(
    p: SyntheticParticles, box: float, dim: int
) -> dict:
    """Sort every per-type array into top-level-cell order (in place) and
    return {pt: (counts, offsets)} over the dim^3 row-major cell grid."""
    nc = dim**3
    layout = {}
    for pt in list(p.positions):
        cell3 = np.clip(
            (p.positions[pt] / box * dim).astype(np.int64), 0, dim - 1
        )
        cell = (cell3[:, 0] * dim + cell3[:, 1]) * dim + cell3[:, 2]
        order = np.argsort(cell, kind="stable")
        _reorder_type(p, pt, order)
        counts = np.bincount(cell, minlength=nc).astype(np.int64)
        offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
        layout[pt] = (counts, offsets)
    return layout


def write_soap_catalogue(
    directory: str,
    spec: SyntheticSnapshotSpec,
    particles: SyntheticParticles,
) -> tuple[str, str, dict]:
    """Write SOAP-style catalogue + membership files.

    Schema per `io/SWIFT/_CatalogueSOAP.py`: VR group (ID, Parent_halo_ID,
    Host_halo_ID, CentreOfPotential, CentreOfMass), SO/<mult>_crit subgroups,
    and a membership file with per-type GroupNr_all/GroupNr_bound.
    """
    rng = np.random.default_rng(spec.seed + 11)
    n = spec.n_groups
    cgs_key = "Conversion factor to CGS (not including cosmological corrections)"

    halo_ids = np.arange(1, n + 1, dtype=np.int64) * 10
    parent = halo_ids.copy()
    host = halo_ids.copy()
    # make a couple of subhaloes
    if n >= 4:
        parent[2] = halo_ids[0]
        host[2] = halo_ids[0]
        parent[3] = halo_ids[2]
        host[3] = halo_ids[0]
    masses = 10.0 ** rng.uniform(11.0, 13.0, n)
    radii = (masses / 1e12) ** (1 / 3) * 0.2

    cat_path = os.path.join(directory, f"soap_{spec.snapshot_number:04d}.hdf5")
    with h5py.File(cat_path, "w") as f:
        vr = f.create_group("VR")
        vr.create_dataset("ID", data=halo_ids)
        vr.create_dataset("Parent_halo_ID", data=np.where(parent == halo_ids, -1, parent))
        vr.create_dataset("Host_halo_ID", data=np.where(host == halo_ids, -1, host))
        ds = vr.create_dataset("CentreOfPotential", data=particles.group_centres)
        ds.attrs[cgs_key] = np.array([C.MEGAPARSEC_CGS])
        ds = vr.create_dataset("CentreOfMass", data=particles.group_centres)
        ds.attrs[cgs_key] = np.array([C.MEGAPARSEC_CGS])
        for mult, factor in ((200, 1.0), (500, 0.7)):
            so = f.create_group(f"SO/{mult}_crit")
            ds = so.create_dataset("TotalMass", data=masses * factor)
            ds.attrs[cgs_key] = np.array([C.SOLAR_MASS_CGS])
            ds = so.create_dataset("SORadius", data=radii * factor)
            ds.attrs[cgs_key] = np.array([C.MEGAPARSEC_CGS])
        bs = f.create_group("BoundSubhalo")
        ds = bs.create_dataset("TotalMass", data=masses)
        ds.attrs[cgs_key] = np.array([C.SOLAR_MASS_CGS])

    memb_path = os.path.join(directory, f"soap_membership_{spec.snapshot_number:04d}.hdf5")
    with h5py.File(memb_path, "w") as f:
        for pt in ParticleType.get_all():
            gn = particles.group_numbers[pt]
            # map synthetic group numbers (1-based, 2^30 = none) to halo index
            idx_all = np.where((np.abs(gn) >= 1) & (np.abs(gn) <= n), np.abs(gn) - 1, -1)
            idx_bound = np.where((gn >= 1) & (gn <= n), gn - 1, -1)
            g = f.create_group(pt.common_hdf5_name)
            g.create_dataset("GroupNr_all", data=idx_all.astype(np.int64))
            g.create_dataset("GroupNr_bound", data=idx_bound.astype(np.int64))

    truth = dict(halo_ids=halo_ids, parent=parent, host=host, masses=masses, radii=radii)
    return cat_path, memb_path, truth


def write_tng_snapshot(
    directory: str,
    spec: SyntheticSnapshotSpec,
    particles: Optional[SyntheticParticles] = None,
) -> tuple[str, str, SyntheticParticles, dict]:
    """Write a TNG-format snapshot + group catalogue.

    Schema per the TNG reader docstring: snapdir_NNN/snap_NNN.K.hdf5 with
    ckpc/h lengths, 1e10 Msun/h masses, km sqrt(a)/s velocities, derived-
    temperature inputs (InternalEnergy, ElectronAbundance, GFM_Metals); the
    groups_NNN/fof_subhalo_tab_NNN catalogue with Group fields. Particles are
    written sorted by FOF group (members first) so membership offsets work.
    """
    p = particles or generate_particles(spec)
    h = spec.hubble_param
    a = spec.expansion_factor
    num = spec.snapshot_number
    n_groups = spec.n_groups
    rng = np.random.default_rng(spec.seed + 23)

    snap_dir = os.path.join(directory, f"snapdir_{num:03d}")
    group_dir = os.path.join(directory, f"groups_{num:03d}")
    os.makedirs(snap_dir, exist_ok=True)
    os.makedirs(group_dir, exist_ok=True)

    def to_ckpc_h(mpc):
        return mpc * h * 1.0e3

    def to_1e10_h(msun):
        return msun * h / 1.0e10

    # sort every species by group (members of group 0, 1, ..., then fuzz)
    order = {}
    group_len_type = np.zeros((n_groups, 6), dtype=np.int64)
    for pt in ParticleType.get_all():
        gn = p.group_numbers[pt]
        member = (gn > 0) & (gn < 2**30)
        sort_key = np.where(member, gn - 1, n_groups + 1)
        order[pt] = np.argsort(sort_key, kind="stable")
        counts = np.bincount(gn[member] - 1, minlength=n_groups)
        group_len_type[:, pt.value] = counts

    counts_per_type = {pt: len(p.ids[pt]) for pt in ParticleType.get_all()}
    num_total = np.zeros(6, dtype=np.int64)
    for pt in ParticleType.get_all():
        num_total[pt.value] = counts_per_type[pt]
    mass_table = np.zeros(6, dtype=np.float64)
    mass_table[1] = to_1e10_h(p.dm_particle_mass)

    # temperature inputs consistent with the stored truth temperature:
    # u = T k_B / ((gamma-1) mu) / 1e10
    gas_order = order[ParticleType.gas]
    x_h = p.abundances[ParticleType.gas]["H"]
    x_e = rng.uniform(0.0, 1.2, counts_per_type[ParticleType.gas])
    mu = 4.0 * C.PROTON_MASS_CGS / (1.0 + 3.0 * x_h + 4.0 * x_h * x_e)
    u_cgs = p.temperature * C.BOLTZMANN_CONSTANT_CGS / ((5.0 / 3.0 - 1.0) * mu)
    internal_energy = u_cgs / 1.0e10

    n_files = spec.n_files
    splits = {}
    for pt in ParticleType.get_all():
        n = counts_per_type[pt]
        edges = np.linspace(0, n, n_files + 1).astype(int)
        splits[pt] = [(edges[i], edges[i + 1]) for i in range(n_files)]

    first = None
    for fi in range(n_files):
        path = os.path.join(snap_dir, f"snap_{num:03d}.{fi}.hdf5")
        if fi == 0:
            first = path
        with h5py.File(path, "w") as f:
            hdr = f.create_group("Header")
            hdr.attrs["Redshift"] = spec.redshift
            hdr.attrs["HubbleParam"] = h
            hdr.attrs["Time"] = a
            hdr.attrs["OmegaBaryon"] = spec.omega_baryon
            hdr.attrs["BoxSize"] = to_ckpc_h(spec.box_size_mpc)
            hdr.attrs["NumPart_Total"] = num_total
            hdr.attrs["NumPart_ThisFile"] = _num_this_file(splits, fi)
            hdr.attrs["MassTable"] = mass_table
            hdr.attrs["NumFilesPerSnapshot"] = n_files

            for pt in ParticleType.get_all():
                i0, i1 = splits[pt][fi]
                sel = order[pt][i0:i1]
                g = f.create_group(pt.common_hdf5_name)
                g.create_dataset("ParticleIDs", data=p.ids[pt][sel])
                g.create_dataset("Coordinates", data=to_ckpc_h(p.positions[pt][sel]))
                g.create_dataset(
                    "Velocities", data=p.velocities[pt][sel] / np.sqrt(a)
                )
                if pt != ParticleType.dark_matter:
                    g.create_dataset("Masses", data=to_1e10_h(p.masses[pt][sel]))
                    g.create_dataset("SubfindHsml", data=to_ckpc_h(p.smoothing[pt][sel]))
                if pt == ParticleType.black_hole:
                    g.create_dataset("BH_Mass", data=to_1e10_h(p.bh_subgrid_mass[sel]))
                if pt == ParticleType.gas:
                    # density in 1e10 Msun/h per (ckpc/h)^3
                    rho_internal = (p.density[sel] / 1.0e10 / h**2) * 1.0e-9
                    g.create_dataset("Density", data=rho_internal)
                    g.create_dataset("InternalEnergy", data=internal_energy[sel])
                    g.create_dataset("ElectronAbundance", data=x_e[sel])
                    g.create_dataset("StarFormationRate", data=p.sfr[sel])
                if pt in (ParticleType.gas, ParticleType.star):
                    g.create_dataset("GFM_Metallicity", data=p.metallicity[pt][sel])
                    gfm_order = ("H", "He", "C", "N", "O", "Ne", "Mg", "Si", "Fe")
                    metals = np.stack([p.abundances[pt][s][sel] for s in gfm_order], axis=1)
                    g.create_dataset("GFM_Metals", data=metals)

    # group catalogue
    masses = 10.0 ** rng.uniform(11.0, 13.0, n_groups)
    radii = (masses / 1e12) ** (1 / 3) * 0.2
    cat_path = os.path.join(group_dir, f"fof_subhalo_tab_{num:03d}.0.hdf5")
    with h5py.File(cat_path, "w") as f:
        hdr = f.create_group("Header")
        hdr.attrs["Ngroups_Total"] = n_groups
        hdr.attrs["Ngroups_ThisFile"] = n_groups
        g = f.create_group("Group")
        g.create_dataset("GroupPos", data=to_ckpc_h(p.group_centres))
        g.create_dataset("GroupCM", data=to_ckpc_h(p.group_centres))
        g.create_dataset("GroupMass", data=to_1e10_h(masses))
        g.create_dataset("GroupLenType", data=group_len_type)
        for spec_name, factor in (("Crit200", 1.0), ("Crit500", 0.7), ("Mean200", 1.2), ("TopHat200", 1.1)):
            g.create_dataset(f"Group_M_{spec_name}", data=to_1e10_h(masses * factor))
            g.create_dataset(f"Group_R_{spec_name}", data=to_ckpc_h(radii * factor))

    truth = dict(order=order, masses=masses, radii=radii, x_e=x_e, group_len_type=group_len_type)
    return first, cat_path, p, truth


def write_los_file(
    directory: str,
    spec: SyntheticSnapshotSpec,
    n_sightlines: int = 4,
    particles_per_los: int = 200,
    seed: Optional[int] = None,
) -> tuple[str, dict]:
    """Write an EAGLE-format ``part_los_zXpY.hdf5`` file + physical truth.

    Schema per `_LineOfSightEAGLE.py:29-39,72-90`: Header attrs incl.
    Number_of_sight_lines; per-``LOS{i}`` group attrs (particle count, axis
    indices, x/y position in h^-1 Mpc) and datasets (Positions, Velocity,
    Mass, Metallicity, Temperature, Density, SmoothingLength) with
    h/a/CGS attrs.
    """
    rng = np.random.default_rng(seed if seed is not None else spec.seed + 7)
    h = spec.hubble_param
    box = spec.box_size_mpc
    zint = int(spec.redshift)
    zdec = int(round((spec.redshift - zint) * 1000))
    path = os.path.join(directory, f"part_los_z{zint}p{zdec:03d}.hdf5")

    truth: dict = {"sightlines": []}
    with h5py.File(path, "w") as f:
        hdr = f.create_group("Header")
        hdr.attrs["Redshift"] = spec.redshift
        hdr.attrs["ExpansionFactor"] = spec.expansion_factor
        hdr.attrs["HubbleParam"] = h
        hdr.attrs["Number_of_sight_lines"] = n_sightlines
        hdr.attrs["BoxSize"] = box * h

        def attrs(ds, h_exp, a_exp, cgs):
            ds.attrs["h-scale-exponent"] = float(h_exp)
            ds.attrs["aexp-scale-exponent"] = float(a_exp)
            ds.attrs["CGSConversionFactor"] = float(cgs)

        for i in range(n_sightlines):
            n = particles_per_los
            g = f.create_group(f"LOS{i}")
            # project along z with x/y in-plane (axis indices 0,1,2)
            xpos_mpc = rng.uniform(0, box)
            ypos_mpc = rng.uniform(0, box)
            g.attrs["Number_of_part_this_los"] = n
            g.attrs["x-axis"] = 0
            g.attrs["y-axis"] = 1
            g.attrs["z-axis"] = 2
            g.attrs["x-position"] = xpos_mpc * h  # h^-1 Mpc on disk
            g.attrs["y-position"] = ypos_mpc * h

            pos = rng.uniform(0, box, (n, 3))  # comoving Mpc truth
            pos[:, 0] = xpos_mpc + rng.normal(0, 0.05, n)
            pos[:, 1] = ypos_mpc + rng.normal(0, 0.05, n)
            vel = rng.normal(0, 120.0, (n, 3))
            mass = 10.0 ** rng.uniform(5.8, 6.4, n)
            dens = 10.0 ** rng.uniform(8, 13, n)
            temp = 10.0 ** rng.uniform(3.5, 7.0, n)
            metal = 10.0 ** rng.uniform(-4, -2, n)
            hsml = 10.0 ** rng.uniform(-2, -1, n)

            ds = g.create_dataset("Positions", data=pos * h)
            attrs(ds, -1.0, 1.0, LENGTH_CGS)
            ds = g.create_dataset("Velocity", data=vel)
            attrs(ds, 0.0, 0.5, VELOCITY_CGS)
            ds = g.create_dataset("Mass", data=mass * h * MSUN_IN_1E10)
            attrs(ds, -1.0, 0.0, MASS_CGS)
            ds = g.create_dataset("Metallicity", data=metal)
            attrs(ds, 0.0, 0.0, 1.0)
            ds = g.create_dataset("Temperature", data=temp)
            attrs(ds, 0.0, 0.0, 1.0)
            ds = g.create_dataset(
                "Density",
                data=dens / spec.hubble_param**2
                * (C.SOLAR_MASS_CGS / C.MEGAPARSEC_CGS**3) / DENSITY_CGS,
            )
            attrs(ds, 2.0, -3.0, DENSITY_CGS)
            ds = g.create_dataset("SmoothingLength", data=hsml * h)
            attrs(ds, -1.0, 1.0, LENGTH_CGS)

            truth["sightlines"].append(
                dict(
                    x=xpos_mpc, y=ypos_mpc, positions=pos, velocities=vel, masses=mass,
                    density=dens, temperature=temp, metallicity=metal, smoothing=hsml,
                )
            )
    return path, truth


def write_catalogue(
    directory: str,
    spec: SyntheticSnapshotSpec,
    particles: SyntheticParticles,
) -> tuple[str, str]:
    """Write SUBFIND-style membership + properties file sets.

    Schema per `_CatalogueSUBFIND.py:66-104`: membership files
    (``eagle_subfind_particles_<tag>/eagle_subfind_particles_<tag>.K.hdf5``)
    carry Header/NumPart_ThisFile + per-type IDs/GroupNumber; properties files
    (``groups_<tag>/eagle_subfind_tab_<tag>.K.hdf5``) carry FOF group fields
    with h/a/CGS attrs.
    """
    h = spec.hubble_param
    tag = spec.tag
    n_groups = spec.n_groups
    rng = np.random.default_rng(spec.seed + 1)

    memb_dir = os.path.join(directory, f"particledata_{tag}")
    prop_dir = os.path.join(directory, f"groups_{tag}")
    os.makedirs(memb_dir, exist_ok=True)
    os.makedirs(prop_dir, exist_ok=True)

    # membership: bound particles (positive group number), sorted by group
    memb_path = os.path.join(memb_dir, f"eagle_subfind_particles_{tag}.0.hdf5")
    with h5py.File(memb_path, "w") as f:
        hdr = f.create_group("Header")
        num_this = np.zeros(6, dtype=np.int64)
        for pt in ParticleType.get_all():
            bound = particles.group_numbers[pt] > 0
            bound &= particles.group_numbers[pt] < 2**30
            num_this[pt.value] = int(bound.sum())
        hdr.attrs["NumPart_ThisFile"] = num_this
        hdr.attrs["NumFilesPerSnapshot"] = 1
        hdr.attrs["HubbleParam"] = h
        hdr.attrs["Redshift"] = spec.redshift
        hdr.attrs["ExpansionFactor"] = spec.expansion_factor
        for pt in ParticleType.get_all():
            gn = particles.group_numbers[pt]
            bound = (gn > 0) & (gn < 2**30)
            order = np.argsort(gn[bound], kind="stable")
            g = f.create_group(pt.common_hdf5_name)
            ds = g.create_dataset("ParticleIDs", data=particles.ids[pt][bound][order])
            ds.attrs["h-scale-exponent"] = 0.0
            ds.attrs["aexp-scale-exponent"] = 0.0
            ds.attrs["CGSConversionFactor"] = 1.0
            ds = g.create_dataset("GroupNumber", data=gn[bound][order])
            ds.attrs["h-scale-exponent"] = 0.0
            ds.attrs["aexp-scale-exponent"] = 0.0
            ds.attrs["CGSConversionFactor"] = 1.0

    # properties: FOF group table
    prop_path = os.path.join(prop_dir, f"eagle_subfind_tab_{tag}.0.hdf5")
    centres = particles.group_centres
    masses = 10.0 ** rng.uniform(11.0, 13.0, n_groups)  # Msun
    with h5py.File(prop_path, "w") as f:
        hdr = f.create_group("Header")
        hdr.attrs["TotNgroups"] = n_groups
        hdr.attrs["HubbleParam"] = h
        hdr.attrs["Redshift"] = spec.redshift
        hdr.attrs["ExpansionFactor"] = spec.expansion_factor
        hdr.attrs["NumFilesPerSnapshot"] = 1
        fof = f.create_group("FOF")
        fof.attrs["Ngroups"] = n_groups

        def mk(name, phys, h_exp, a_exp, cgs, internal):
            ds = fof.create_dataset(name, data=internal)
            ds.attrs["h-scale-exponent"] = float(h_exp)
            ds.attrs["aexp-scale-exponent"] = float(a_exp)
            ds.attrs["CGSConversionFactor"] = float(cgs)

        mk("GroupCentreOfPotential", centres, -1.0, 1.0, LENGTH_CGS, centres * h)
        mk("GroupMass", masses, -1.0, 0.0, MASS_CGS, masses * h * MSUN_IN_1E10)
        for suffix, factor in [("Crit200", 1.0), ("Crit500", 0.7), ("Crit2500", 0.4),
                               ("Mean200", 1.2), ("Mean500", 0.8), ("TopHat200", 1.1)]:
            gm = masses * factor
            mk(f"Group_M_{suffix}", gm, -1.0, 0.0, MASS_CGS, gm * h * MSUN_IN_1E10)
            gr = (masses / 1.0e12) ** (1 / 3) * 0.2 * factor  # Mpc
            mk(f"Group_R_{suffix}", gr, -1.0, 1.0, LENGTH_CGS, gr * h)
    return memb_path, prop_path
