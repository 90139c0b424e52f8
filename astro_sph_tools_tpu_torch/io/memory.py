"""A gas snapshot and a halo catalogue served from arrays in memory.

The file readers need ``h5py``; a machine that renders without files (the
card's has no ``h5py``), the examples' in-memory source and the fidelity
artifact serve their particles and haloes through these instead. They
implement the readers' interfaces (:class:`SnapshotBase`,
:class:`CatalogueBase`) for what the renders and the workflow read: gas
positions, smoothing lengths, masses and, where given, velocities,
temperatures, metallicities and IDs; halo centres of potential and the
radii and masses of the given definitions. Everything else raises
``NotImplementedError``. The JAX package has no counterpart (its tests and
examples always write files).
"""

from __future__ import annotations

import numpy as np

from ..data_structures.particle_types import ParticleType
from ..units import unit_array
from .catalogue import CatalogueBase
from .snapshot import SnapshotBase

#: the gas fields a memory snapshot serves, by getter, with their units
_FIELDS = {
    "positions": "Mpc",
    "velocities": "km/s",
    "smoothing_lengths": "Mpc",
    "masses": "Msun",
    "temperatures": "K",
    "metallicities": "",
}


def _missing(*args, **kwargs):
    raise NotImplementedError("not served by the in-memory snapshot or catalogue")


class MemorySnapshot(SnapshotBase):
    """Gas particles from arrays (NumPy or torch): ``fields`` maps the
    names of ``_FIELDS`` (and ``"ids"``) to arrays in its units (co-moving
    Mpc, km/s, Msun, K, mass fraction)."""

    def __init__(self, fields: dict, box: float, *, redshift: float = 0.0, hubble_param: float = 0.6777,
                 omega_baryon: float = 0.04825, number: str = "000") -> None:
        unknown = set(fields) - set(_FIELDS) - {"ids"}
        if unknown:
            raise ValueError(f"unknown snapshot fields {sorted(unknown)}")
        self._fields = dict(fields)
        super().__init__(
            filepath="<memory>", number=number, redshift=redshift, hubble_param=hubble_param,
            omega_baryon=omega_baryon, expansion_factor=1.0 / (1.0 + redshift),
            box_size=unit_array(np.full(3, float(box)), "Mpc"),
        )

    def _field(self, name: str, particle_type: ParticleType):
        if particle_type != ParticleType.gas or name not in self._fields:
            _missing()
        return unit_array(self._fields[name], _FIELDS[name])

    def _get_number_of_particles(self):
        n = len(self._fields["masses"])
        return {pt: (n if pt == ParticleType.gas else 0) for pt in ParticleType.get_all()}

    _get_number_of_particles_this_rank = _get_number_of_particles

    def _get_IDs(self, particle_type):
        if particle_type != ParticleType.gas or "ids" not in self._fields:
            _missing()
        return self._fields["ids"]

    def _get_positions(self, particle_type, use_proper_units):
        return self._field("positions", particle_type)

    def _get_velocities(self, particle_type, use_proper_units):
        return self._field("velocities", particle_type)

    def _get_smoothing_lengths(self, particle_type, use_proper_units):
        return self._field("smoothing_lengths", particle_type)

    def _get_masses(self, particle_type):
        return self._field("masses", particle_type)

    def _get_temperatures(self, particle_type):
        return self._field("temperatures", particle_type)

    def _get_metallicities(self, particle_type, solar_units, solar_metallicity):
        return self._field("metallicities", particle_type)

    _get_black_hole_subgrid_masses = _get_black_hole_dynamical_masses = _missing
    _get_sfr = _get_mean_enrichment_redshift = _get_densities = _missing
    _get_number_densities = _get_elemental_abundance = _missing


class MemoryCatalogue(CatalogueBase):
    """Haloes from arrays: centres of potential (n, 3) Mpc, and per halo
    definition (``BasicHaloDefinitions.X.value``) the radii (Mpc) and,
    where given, the masses (Msun)."""

    def __init__(self, snapshot: SnapshotBase, centres, radii: dict, masses: dict = None) -> None:
        super().__init__("<memory>", "<memory>", snapshot)
        self._centres = np.array(centres, np.float64)
        self._radii = {k: np.array(v, np.float64) for k, v in radii.items()}
        self._masses = {k: np.array(v, np.float64) for k, v in (masses or {}).items()}

    def _by_definition(self, table: dict, halo_type, unit: str):
        for definition, values in table.items():
            if definition == halo_type:
                return unit_array(values.copy(), unit)
        raise halo_type.make_error(type(self))

    def get_number_of_haloes(self, particle_type=None):
        return len(self._centres)

    def get_halo_IDs(self, particle_type=None):
        return np.arange(1, len(self._centres) + 1)

    def get_halo_indexes(self, particle_type=None):
        return np.arange(len(self._centres))

    def get_halo_centres_of_potential(self, particle_type=None, use_proper_units=False):
        return unit_array(self._centres.copy(), "Mpc")

    def get_halo_radii(self, halo_type, particle_type=None, use_proper_units=False):
        return self._by_definition(self._radii, halo_type, "Mpc")

    def get_halo_masses(self, halo_type, particle_type=None):
        return self._by_definition(self._masses, halo_type, "Msun")

    _get_hierarchy_IDs = get_halo_parent_IDs = get_halo_parent_indexes = _missing
    get_halo_top_level_parent_IDs = get_halo_top_level_parent_indexes = _missing
    get_halo_centres_of_mass = get_particle_IDs = _missing
    get_halo_IDs_by_snapshot_particle = get_halo_indexes_by_snapshot_particle = _missing
