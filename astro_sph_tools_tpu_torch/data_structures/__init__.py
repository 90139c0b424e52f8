"""Core data vocabulary: particle types, axes, cosmology, interfaces.

Counterpart: ``astro_sph_tools_tpu/data_structures/__init__.py``."""

from .cosmology import RHO_CRIT_H1_MSUN_PER_MPC3, Cosmology
from .interface import (
    Interface,
    ISimulation,
    ISimulationData,
    SimType_EAGLE,
    SimType_SWIFT,
    SimType_TNG,
    SimulationDataBase,
    ensure_not_interface,
)
from .ionisation import IIonisationTable, IonisationTableBase
from .particle_types import CoordinateAxes, ParticleType

__all__ = [
    "ISimulation",
    "ISimulationData",
    "Interface",
    "SimulationDataBase",
    "SimType_EAGLE",
    "SimType_SWIFT",
    "SimType_TNG",
    "ensure_not_interface",
    "ParticleType",
    "CoordinateAxes",
    "Cosmology",
    "RHO_CRIT_H1_MSUN_PER_MPC3",
    "IIonisationTable",
    "IonisationTableBase",
]
