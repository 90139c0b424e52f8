"""Line-of-sight file readers (EAGLE ``part_los_z*.hdf5`` + SWIFT variant).

Parity targets: the LOS base classes
(`astro_sph_tools/io/data_structures/_LineOfSightBase.py:16-189`)
and the EAGLE implementation
(`astro_sph_tools/io/EAGLE/_LineOfSightEAGLE.py`):

- file header gives the sightline count; each ``LOS{i}`` group carries its
  particle count, projection-axis indices, and the sightline's in-plane
  x/y position in h^-1 Mpc (converted with ``h**-1`` to Mpc);
- per-field reads apply the h-exp / a-exp / CGS recipe with a_exp = 0 for
  co-moving data (`_LineOfSightEAGLE.py:72-75` — the behaviour the broken
  SWIFT copy got wrong, SURVEY.md §2.9.4);
- fields: Positions, Velocity, Mass, Metallicity, Temperature, Density,
  SmoothingLength; reads cached per sightline (`_LineOfSightBase.py:122-128`);
- file discovery sorts by the redshift embedded in the filename
  (`_LineOfSightEAGLE.py:55-61`).

The device-side sightline *integration* (SPH kernel line integrals) lives in
``ops.sightlines``; these classes are the host IO feeding it.

Counterpart: ``astro_sph_tools_tpu/io/los.py``
(copied; ``h5py`` is imported on first use).
"""

from __future__ import annotations

import os
from typing import Optional

from ._lazy import h5py
import numpy as np

from ..units import UnitArray, unit_array


class LineOfSightFileBase:
    """One LOS output file: metadata for every sightline it holds."""

    def __init__(
        self,
        filepath: str,
        number_of_sightlines: int,
        number_of_sightline_particles: np.ndarray,
        sightline_start_positions: UnitArray,
        sightline_direction_vectors: np.ndarray,
        redshift: float,
        expansion_factor: float,
        hubble_param: float,
    ) -> None:
        self._filepath = filepath
        self._n_sightlines = int(number_of_sightlines)
        self._n_particles = number_of_sightline_particles
        self._starts = sightline_start_positions
        self._directions = sightline_direction_vectors
        self._redshift = float(redshift)
        self._expansion_factor = float(expansion_factor)
        self._hubble_param = float(hubble_param)

    @property
    def filepath(self) -> str:
        return self._filepath

    @property
    def file_name(self) -> str:
        return os.path.basename(self._filepath)

    def get_readonly_file_handle(self) -> h5py.File:
        return h5py.File(self._filepath, "r")

    @property
    def redshift(self) -> float:
        return self._redshift

    z = redshift

    @property
    def expansion_factor(self) -> float:
        return self._expansion_factor

    a = expansion_factor

    @property
    def hubble_param(self) -> float:
        return self._hubble_param

    h = hubble_param

    @property
    def number_of_sightlines(self) -> int:
        return self._n_sightlines

    def __len__(self) -> int:
        return self._n_sightlines

    def get_sightline_length(self, sightline_index: int) -> int:
        return int(self._n_particles[sightline_index])

    def get_sightline_start_position(self, sightline_index: int) -> UnitArray:
        return self._starts[sightline_index]

    def get_sightline_direction_vector(self, sightline_index: int) -> np.ndarray:
        return self._directions[sightline_index]

    def get_sightline(self, index: int, cache_data: bool = True) -> "LineOfSightBase":
        raise NotImplementedError("Attempted to call an abstract method.")

    @staticmethod
    def get_files(directory: str, prefix: str = "part_los") -> tuple[str, ...]:
        raise NotImplementedError("Attempted to call an abstract method.")


class LineOfSightBase:
    """One sightline: cached field reads (`_LineOfSightBase.py:84-189`)."""

    def __init__(
        self,
        file_object: LineOfSightFileBase,
        number_of_particles: int,
        start_position: UnitArray,
        direction_vector: np.ndarray,
        cache_data: bool = True,
    ) -> None:
        self._file = file_object
        self._n_particles = int(number_of_particles)
        self._start = start_position
        self._direction = direction_vector
        self._cache_enabled = bool(cache_data)
        self._cache: dict[str, object] = {}

    @property
    def file(self) -> LineOfSightFileBase:
        return self._file

    @property
    def number_of_particles(self) -> int:
        return self._n_particles

    def __len__(self) -> int:
        return self._n_particles

    @property
    def start_position(self) -> UnitArray:
        return self._start

    @property
    def direction(self) -> np.ndarray:
        return self._direction

    def delete_cache(self) -> None:
        self._cache = {}

    @property
    def cache_data(self) -> bool:
        return self._cache_enabled

    @cache_data.setter
    def cache_data(self, value: bool) -> None:
        self._cache_enabled = bool(value)
        if not value:
            self.delete_cache()

    def _cached(self, key: str, reader, *args):
        if not self._cache_enabled:
            return reader(*args)
        if key not in self._cache:
            self._cache[key] = reader(*args)
        return self._cache[key]

    # -- field surface ----------------------------------------------------------
    @property
    def positions_comoving(self) -> UnitArray:
        return self._cached("pos_co", self._read_positions, True)

    @property
    def positions_proper(self) -> UnitArray:
        return self._cached("pos_pr", self._read_positions, False)

    def _read_positions(self, comoving=True) -> UnitArray:
        raise NotImplementedError("Attempted to call an abstract method.")

    @property
    def velocities_comoving(self) -> UnitArray:
        return self._cached("vel_co", self._read_velocities, True)

    @property
    def velocities_proper(self) -> UnitArray:
        return self._cached("vel_pr", self._read_velocities, False)

    def _read_velocities(self, comoving=True) -> UnitArray:
        raise NotImplementedError("Attempted to call an abstract method.")

    @property
    def masses(self) -> UnitArray:
        return self._cached("mass", self._read_masses)

    def _read_masses(self) -> UnitArray:
        raise NotImplementedError("Attempted to call an abstract method.")

    @property
    def metallicities(self) -> UnitArray:
        return self._cached("Z", self._read_metallicities)

    def _read_metallicities(self) -> UnitArray:
        raise NotImplementedError("Attempted to call an abstract method.")

    @property
    def temperatures(self) -> UnitArray:
        return self._cached("T", self._read_temperatures)

    def _read_temperatures(self) -> UnitArray:
        raise NotImplementedError("Attempted to call an abstract method.")

    @property
    def densities_comoving(self) -> UnitArray:
        return self._cached("rho_co", self._read_densities, True)

    @property
    def densities_proper(self) -> UnitArray:
        return self._cached("rho_pr", self._read_densities, False)

    def _read_densities(self, comoving=True) -> UnitArray:
        raise NotImplementedError("Attempted to call an abstract method.")

    @property
    def smoothing_lengths_comoving(self) -> UnitArray:
        return self._cached("h_co", self._read_smoothing_lengths, True)

    @property
    def smoothing_lengths_proper(self) -> UnitArray:
        return self._cached("h_pr", self._read_smoothing_lengths, False)

    def _read_smoothing_lengths(self, comoving=True) -> UnitArray:
        raise NotImplementedError("Attempted to call an abstract method.")


class LineOfSightFileEAGLE(LineOfSightFileBase):
    """EAGLE ``part_los_z*.hdf5`` reader (`_LineOfSightEAGLE.py:13-61`)."""

    def __init__(self, filepath: str) -> None:
        with h5py.File(filepath, "r") as f:
            hdr = f["Header"].attrs
            redshift = float(hdr["Redshift"])
            expansion_factor = float(hdr["ExpansionFactor"])
            hubble_param = float(hdr["HubbleParam"])
            n_sl = int(hdr["Number_of_sight_lines"])
            n_parts = np.array(
                [int(f[f"LOS{i}"].attrs["Number_of_part_this_los"]) for i in range(n_sl)]
            )
            starts = np.zeros((n_sl, 3), dtype=np.float64)
            directions = np.zeros((n_sl, 3), dtype=np.float64)
            for i in range(n_sl):
                a = f[f"LOS{i}"].attrs
                axes = np.array([int(a["x-axis"]), int(a["y-axis"]), int(a["z-axis"])])
                # LOS positions are h^-1 Mpc on disk (`_LineOfSightEAGLE.py:38`)
                starts[i, axes] = (
                    np.array([float(a["x-position"]), float(a["y-position"]), 0.0])
                    / hubble_param
                )
                directions[i, axes[2]] = 1.0
        super().__init__(
            filepath=filepath,
            number_of_sightlines=n_sl,
            number_of_sightline_particles=n_parts,
            sightline_start_positions=unit_array(starts, "Mpc"),
            sightline_direction_vectors=directions,
            redshift=redshift,
            expansion_factor=expansion_factor,
            hubble_param=hubble_param,
        )

    def get_sightline(self, index: int, cache_data: bool = True) -> "LineOfSightEAGLE":
        return LineOfSightEAGLE(
            self,
            self.get_sightline_length(index),
            index,
            self.get_sightline_start_position(index),
            self.get_sightline_direction_vector(index),
            cache_data=cache_data,
        )

    @staticmethod
    def get_files(directory: str, prefix: str = "part_los") -> tuple[str, ...]:
        """All LOS files sorted by the redshift in their name
        (`_LineOfSightEAGLE.py:55-61`)."""
        if not os.path.exists(directory):
            raise FileNotFoundError(
                f'Line-of-sight file directory "{directory}" does not exist.'
            )
        names = [n for n in os.listdir(directory) if n.startswith(prefix)]
        paths = [os.path.join(directory, n) for n in names]
        paths.sort(key=lambda v: float(v.rsplit("z", maxsplit=1)[1].rsplit(".", maxsplit=1)[0]))
        return tuple(paths)


class LineOfSightEAGLE(LineOfSightBase):
    """One EAGLE sightline (`_LineOfSightEAGLE.py:64-90`)."""

    def __init__(
        self, file_object, number_of_particles, sightline_index, start_position,
        direction_vector, cache_data=True,
    ) -> None:
        super().__init__(
            file_object=file_object,
            number_of_particles=number_of_particles,
            start_position=start_position,
            direction_vector=direction_vector,
            cache_data=cache_data,
        )
        self._index = int(sightline_index)

    @property
    def sightline_index(self) -> int:
        return self._index

    def _read_cgs_field(self, field: str, cgs_units: Optional[str], comoving=True) -> UnitArray:
        """raw * h^h_exp * a^(a_exp if proper else 0) * cgs
        (`_LineOfSightEAGLE.py:72-75`)."""
        with self.file.get_readonly_file_handle() as f:
            ds = f[f"LOS{self._index}/{field}"]
            # f64 conversion: f32 on-disk data overflows in CGS grams
            data = (
                np.asarray(ds[:], dtype=np.float64)
                * (self.file.h ** float(ds.attrs["h-scale-exponent"]))
                * (self.file.a ** (0.0 if comoving else float(ds.attrs["aexp-scale-exponent"])))
                * float(ds.attrs["CGSConversionFactor"])
            )
            return unit_array(data, cgs_units or "")

    def _read_positions(self, comoving=True) -> UnitArray:
        return self._read_cgs_field("Positions", "cm", comoving).to("Mpc")

    def _read_velocities(self, comoving=True) -> UnitArray:
        return self._read_cgs_field("Velocity", "cm/s", comoving).to("km/s")

    def _read_masses(self) -> UnitArray:
        return self._read_cgs_field("Mass", "g").to("Msun")

    def _read_metallicities(self) -> UnitArray:
        return self._read_cgs_field("Metallicity", None)

    def _read_temperatures(self) -> UnitArray:
        return self._read_cgs_field("Temperature", "K")

    def _read_densities(self, comoving=True) -> UnitArray:
        return self._read_cgs_field("Density", "g/cm**3", comoving).to("Msun/Mpc**3")

    def _read_smoothing_lengths(self, comoving=True) -> UnitArray:
        return self._read_cgs_field("SmoothingLength", "cm", comoving).to("Mpc")


class LineOfSightFileSWIFT(LineOfSightFileEAGLE):
    """SWIFT LOS files share the EAGLE on-disk layout.

    The reference's SWIFT variant is an acknowledged copy of the EAGLE logic
    with two defects (`io/SWIFT/_LineOfSightSWIFT.py:4,31-38,61`, SURVEY.md
    §2.9.4): missing base-ctor arguments and ``a_exp=1.0`` applied to
    *co-moving* reads. This subclass inherits the corrected EAGLE semantics.
    """

    def get_sightline(self, index: int, cache_data: bool = True) -> "LineOfSightEAGLE":
        return LineOfSightEAGLE(
            self,
            self.get_sightline_length(index),
            index,
            self.get_sightline_start_position(index),
            self.get_sightline_direction_vector(index),
            cache_data=cache_data,
        )
