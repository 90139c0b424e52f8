"""Interface machinery and simulation-data markers.

Parity targets:
- ``Interface`` ABC + ``ensure_not_interface`` guard preventing direct
  instantiation of interface types
  (`astro_sph_tools/_Interface.py:8-23`);
- ``ISimulation`` / ``ISimulationData`` marker interfaces and the generic
  ``SimulationDataBase`` (`data_structures/_SimulationData.py:11-34`).

These exist for API-shape parity and extension points; the framework's own
types favour composition over marker inheritance.

Counterpart: ``astro_sph_tools_tpu/data_structures/interface.py``
(copied unchanged).
"""

from __future__ import annotations

from abc import ABC
from typing import Generic, TypeVar


class Interface(ABC):
    """Marker base for interface types that must not be instantiated."""


def ensure_not_interface(cls: type, interface_type: type) -> None:
    """Raise if *cls* is the interface type itself rather than an implementation."""
    if cls is interface_type:
        raise TypeError(
            f"{interface_type.__name__} is an interface and cannot be instantiated "
            "directly; subclass it instead."
        )


class ISimulation(Interface):
    """Marker: a type describing a simulation."""

    def __new__(cls, *args, **kwargs):
        ensure_not_interface(cls, ISimulation)
        return super().__new__(cls)


class ISimulationData(Interface):
    """Marker: a type providing access to simulation data."""

    def __new__(cls, *args, **kwargs):
        ensure_not_interface(cls, ISimulationData)
        return super().__new__(cls)


T_ISimulation = TypeVar("T_ISimulation", bound=ISimulation)
T_ISimulationData = TypeVar("T_ISimulationData", bound=ISimulationData)


class SimulationDataBase(ISimulationData, Generic[T_ISimulation]):
    """Generic base for simulation-data readers (parity shim)."""


class SimType_EAGLE(ISimulation):
    """EAGLE simulation marker (`io/EAGLE/_sim_type.py:9`)."""


class SimType_SWIFT(ISimulation):
    """SWIFT simulation marker (`io/SWIFT/_sim_type.py:9`)."""


class SimType_TNG(ISimulation):
    """IllustrisTNG simulation marker (`io/TNG/_sim_type.py:9`)."""
