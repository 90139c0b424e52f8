"""HM01 (CLOUDY / Haardt & Madau 2001) ionisation tables + supported ions.

Counterpart: ``astro_sph_tools_tpu/io/ionisation.py``:

- ``SupportedIons`` enum with element/stage metadata (copied);
- ``IonisationTable_HM01``: per-ion HDF5 files (``<ion>.hdf5``) with axes
  log n_H ("logd"), log T ("logt"), redshift; ion-fraction grid "ionbal";
  UV-background spectrum metadata and a cubic spline for the H I
  photoionisation rate Gamma_HI(z). The table lives on an explicit device
  (``cuda`` unless the caller asks for the CPU);
- ``synthetic_hm01_arrays`` (the synthetic fixture's arrays, in memory) and
  ``write_synthetic_hm01_table`` (the same arrays written as an HM01 file).

Gas-state rows are ``[log10 n_H / cm^-3, log10 T / K, z]`` with the redshift
axis at index 2. ``h5py`` is named through ``io/_lazy.py``: importing this
module does not import it, so a machine without ``h5py`` builds its tables
from arrays (``IonisationTableBase(table, log_nh, log_t, z,
redshift_input_index=2)``).
"""

from __future__ import annotations

import os
from enum import Enum

import numpy as np

from ..data_structures.ionisation import IonisationTableBase
from ..ops.interp import cubic_spline_1d
from ..units import UnitArray, unit_array, unit_quantity
from ._lazy import h5py


class SupportedIons(Enum):
    """Ion species with HM01 tables; values are the on-disk file stems."""

    H_I = "h1"
    He_I = "he1"
    He_II = "he2"
    C_I = "c1"
    C_II = "c2"
    C_III = "c3"
    C_IV = "c4"
    C_V = "c5"
    C_VI = "c6"
    N_II = "n2"
    N_III = "n3"
    N_IV = "n4"
    N_V = "n5"
    N_VI = "n6"
    N_VII = "n7"
    O_I = "o1"
    O_III = "o3"
    O_IV = "o4"
    O_V = "o5"
    O_VI = "o6"
    O_VII = "o7"
    O_VIII = "o8"
    Ne_VIII = "ne8"
    Ne_IX = "ne9"
    Ne_X = "ne10"
    Mg_I = "mg1"
    Mg_II = "mg2"
    Al_I = "al1"
    Al_II = "al2"
    Al_III = "al3"
    Si_II = "si2"
    Si_III = "si3"
    Si_IV = "si4"
    Si_XIII = "si13"
    S_V = "s5"
    Fe_II = "fe2"
    Fe_III = "fe3"
    Fe_XVII = "fe17"

    @property
    def element_symbol(self) -> str:
        """Chemical symbol of the parent element."""
        stem = self.value
        return "".join(c for c in stem if c.isalpha()).capitalize()

    @property
    def ionisation_stage(self) -> int:
        """1-based ionisation stage (I = 1 = neutral)."""
        return int("".join(c for c in self.value if c.isdigit()))

    @property
    def roman_numeral(self) -> str:
        romans = [
            "I", "II", "III", "IV", "V", "VI", "VII", "VIII", "IX", "X",
            "XI", "XII", "XIII", "XIV", "XV", "XVI", "XVII",
        ]
        return romans[self.ionisation_stage - 1]

    @property
    def display_name(self) -> str:
        return f"{self.element_symbol} {self.roman_numeral}"

    @classmethod
    def ions_of_element(cls, symbol: str) -> tuple["SupportedIons", ...]:
        symbol = symbol.capitalize()
        return tuple(i for i in cls if i.element_symbol == symbol)


class IonisationTable_HM01(IonisationTableBase):
    """One ion's HM01 table.

    ``gas_state`` rows: [log10(n_H / cm^-3), log10(T / K), redshift].
    """

    supported_ions: tuple[SupportedIons, ...] = tuple(SupportedIons)

    def __init__(self, ion: SupportedIons, directory: str, device="cuda") -> None:
        if ion not in IonisationTable_HM01.supported_ions:
            raise NotImplementedError(f"The HM01 table set contains no ionisation table for {ion}.")
        self._ion = ion
        with h5py.File(os.path.join(directory, ion.value) + ".hdf5", "r") as f:
            log_t = np.asarray(f["logt"])
            log_nh = np.asarray(f["logd"])
            redshift = np.asarray(f["redshift"])
            ion_frac = np.asarray(f["ionbal"])

            self._cloudy_version = _attr_str(f["header"].attrs["cloudy_version"])
            self._model_name = _attr_str(f["header/spectrum"].attrs["model_name"])
            self._model_description = _attr_str(f["header/spectrum"].attrs["model_description"])
            self._evaluation_redshifts = np.asarray(f["header/spectrum/redshift"])
            self._gammahi = np.asarray(f["header/spectrum/gammahi"])  # s^-1
            self._log_energy_ryd = np.asarray(f["header/spectrum/logenergy_ryd"])
            self._log_flux = np.asarray(f["header/spectrum/logflux"])

        super().__init__(ion_frac, log_nh, log_t, redshift, redshift_input_index=2, device=device)

    @property
    def ion(self) -> SupportedIons:
        return self._ion

    @property
    def cloudy_version(self) -> str:
        return self._cloudy_version

    @property
    def model_name(self) -> str:
        return self._model_name

    @property
    def model_description(self) -> str:
        return self._model_description

    @property
    def evaluation_redshifts(self) -> np.ndarray:
        return self._evaluation_redshifts.copy()

    @property
    def gammahi(self) -> UnitArray:
        """H I photoionisation rate vs redshift, s^-1."""
        return unit_array(self._gammahi.copy(), "s**-1")

    @property
    def energies(self) -> UnitArray:
        """Spectrum energies (Rydberg, dimensionless carrier here)."""
        return unit_array(10.0**self._log_energy_ryd, "")

    @property
    def fluxes(self) -> UnitArray:
        return unit_array(10.0**self._log_flux, "erg/s/cm**2")

    def interpolate_gammahi(self, redshift):
        """Cubic-spline Gamma_HI at the given redshift(s), on the host in f64."""
        scalar = np.isscalar(redshift)
        zq = np.atleast_1d(np.asarray(redshift, dtype=float))
        vals = cubic_spline_1d(self._evaluation_redshifts, self._gammahi, zq, device="cpu").numpy()
        if scalar:
            return unit_quantity(float(vals[0]), "s**-1")
        return unit_array(vals, "s**-1")


def _attr_str(value) -> str:
    if isinstance(value, bytes):
        return value.decode()
    return str(value)


def synthetic_hm01_arrays(
    n_density: int = 16,
    n_temperature: int = 20,
    n_redshift: int = 8,
    seed: int = 3,
) -> dict:
    """The synthetic HM01 table's arrays, by dataset name ("logd", "logt",
    "redshift", "ionbal", and under "spectrum/" the UV-background
    metadata): a smooth analytic ion balance, peaked in T and sloped in
    density and z."""
    rng = np.random.default_rng(seed)
    log_nh = np.linspace(-8.0, 0.0, n_density)
    log_t = np.linspace(2.0, 8.0, n_temperature)
    redshift = np.linspace(0.0, 8.0, n_redshift)
    D, T, Z = np.meshgrid(log_nh, log_t, redshift, indexing="ij")
    return {
        "logd": log_nh,
        "logt": log_t,
        "redshift": redshift,
        "ionbal": -((T - 4.5) ** 2) / 2.0 + 0.2 * D - 0.1 * Z,
        "spectrum/redshift": redshift,
        "spectrum/gammahi": 1e-12 * (1 + redshift) ** 1.5,
        "spectrum/logenergy_ryd": np.linspace(-1, 3, 32),
        "spectrum/logflux": rng.uniform(-25, -18, (32, n_redshift)),
    }


def write_synthetic_hm01_table(
    directory: str,
    ion: SupportedIons,
    n_density: int = 16,
    n_temperature: int = 20,
    n_redshift: int = 8,
    seed: int = 3,
) -> str:
    """Write :func:`synthetic_hm01_arrays` as an HM01-schema HDF5 table
    (test fixture)."""
    arrays = synthetic_hm01_arrays(n_density, n_temperature, n_redshift, seed)
    path = os.path.join(directory, ion.value + ".hdf5")
    with h5py.File(path, "w") as f:
        for name in ("logt", "logd", "redshift", "ionbal"):
            f.create_dataset(name, data=arrays[name])
        hdr = f.create_group("header")
        hdr.attrs["cloudy_version"] = "synthetic-cloudy-1.0"
        spec = hdr.create_group("spectrum")
        spec.attrs["model_name"] = "HM01-synthetic"
        spec.attrs["model_description"] = "synthetic fixture spectrum"
        for name in ("redshift", "gammahi", "logenergy_ryd", "logflux"):
            spec.create_dataset(name, data=arrays["spectrum/" + name])
    return path
