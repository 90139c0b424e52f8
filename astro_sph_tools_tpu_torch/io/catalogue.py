"""Halo catalogue data model: definitions taxonomy + abstract catalogue API.

Parity target: ``CatalogueBase`` and the halo-definition hierarchy
(`astro_sph_tools/io/data_structures/_CatalogueBase.py:24-780`):

- ``IHaloDefinition`` value-equality (``is_match``) + error factory
  (``make_error`` -> HaloDefinitionNotSupportedError);
- ``FOFGroup``, ``FixedRadiusAperture(radius)``, spherical-overdensity
  apertures with Critical/Mean/TopHat flavours;
- ``BasicHaloDefinitions`` enum: FOF, SO {200,500,2500} x {crit,mean},
  SO_200_TOP_HAT, fixed apertures {5,10,30,50,100} kpc;
- abstract catalogue getter surface (halo IDs/indexes/parents/centres/
  masses/radii/per-particle maps/member IDs), snapshot cosmology
  passthrough, ``__len__`` = halo count;
- hierarchy analytics (number_of_children / number_of_descendants) — the
  reference's O(N^2) index-building loop (`_CatalogueBase.py:688-715`, the
  author's own "too slow?" TODO) is replaced by a vectorized
  sort/searchsorted match + level-wise ancestor propagation, O(N log N * depth).

Counterpart: ``astro_sph_tools_tpu/io/catalogue.py`` (copied).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from concurrent.futures import Future, ThreadPoolExecutor
from enum import Enum
from typing import Optional

import numpy as np

from ..data_structures.particle_types import ParticleType
from ..units import UnitArray, unit_quantity
from .errors import HaloDefinitionNotSupportedError
from .snapshot import SnapshotBase


class IHaloDefinition(ABC):
    """A way of delimiting a halo. Value-equality via :meth:`is_match`."""

    @abstractmethod
    def is_match(self, value: "IHaloDefinition") -> bool: ...

    @abstractmethod
    def get_details_for_error(self) -> Optional[str]: ...

    def make_error(
        self, catalogue_type: type, message: Optional[str] = None
    ) -> HaloDefinitionNotSupportedError:
        return HaloDefinitionNotSupportedError(
            definition_type=type(self),
            catalogue_type=catalogue_type,
            definition_detail=self.get_details_for_error(),
            message=message,
        )

    def __eq__(self, value):
        return isinstance(value, IHaloDefinition) and self.is_match(value)

    def __ne__(self, value):
        return not (self == value)

    def __hash__(self):
        return hash(type(self).__name__)


class FOFGroup(IHaloDefinition):
    """All particles linked by the Friends-Of-Friends clustering."""

    def get_details_for_error(self) -> Optional[str]:
        return None

    def is_match(self, value: IHaloDefinition) -> bool:
        return isinstance(value, FOFGroup)


class IApertureHalo(IHaloDefinition):
    """Haloes defined by a sphere."""


class FixedRadiusAperture(IApertureHalo):
    """All particles within a fixed radius of the centre."""

    def __init__(self, radius: UnitArray) -> None:
        self._radius = radius

    @property
    def radius(self) -> UnitArray:
        return self._radius

    def get_details_for_error(self) -> Optional[str]:
        return f"R = {self._radius.value} ({self._radius.units.symbol})"

    def is_match(self, value: IHaloDefinition) -> bool:
        return (
            isinstance(value, FixedRadiusAperture)
            and self._radius.to_value("kpc") == value.radius.to_value("kpc")
        )


class SphericalOverdensityAperture(IApertureHalo):
    """Sphere whose co-moving radius encloses a fixed overdensity multiple."""

    def __init__(self, overdensity_multiple: int) -> None:
        self._multiple = int(overdensity_multiple)

    @property
    def overdensity_limit(self) -> int:
        return self._multiple


class CriticalSphericalOverdensityAperture(SphericalOverdensityAperture):
    """Density = multiple x critical density."""

    def get_details_for_error(self) -> Optional[str]:
        return f"R = {self.overdensity_limit} * rho_c"

    def is_match(self, value: IHaloDefinition) -> bool:
        return (
            isinstance(value, CriticalSphericalOverdensityAperture)
            and self.overdensity_limit == value.overdensity_limit
        )


class MeanSphericalOverdensityAperture(SphericalOverdensityAperture):
    """Density = multiple x mean density."""

    def get_details_for_error(self) -> Optional[str]:
        return f"R = {self.overdensity_limit} * <rho>"

    def is_match(self, value: IHaloDefinition) -> bool:
        return (
            isinstance(value, MeanSphericalOverdensityAperture)
            and self.overdensity_limit == value.overdensity_limit
        )


class TopHatSphericalOverdensityAperture(SphericalOverdensityAperture):
    """EAGLE Group_R_TopHat200-style definition (Bryan & Norman 1998)."""

    def get_details_for_error(self) -> Optional[str]:
        return (
            f"R = {self.overdensity_limit} * (18 * pi**2 + 82 * (Omega_m(z) - 1) "
            "- 39 * (Omega_m(z) - 1)**2)"
        )

    def is_match(self, value: IHaloDefinition) -> bool:
        return (
            isinstance(value, TopHatSphericalOverdensityAperture)
            and self.overdensity_limit == value.overdensity_limit
        )


class BasicHaloDefinitions(Enum):
    """Built-in halo definitions (`_CatalogueBase.py:121-137`)."""

    FOF_GROUP = FOFGroup()
    SO_200_CRIT = CriticalSphericalOverdensityAperture(200)
    SO_500_CRIT = CriticalSphericalOverdensityAperture(500)
    SO_2500_CRIT = CriticalSphericalOverdensityAperture(2500)
    SO_200_MEAN = MeanSphericalOverdensityAperture(200)
    SO_500_MEAN = MeanSphericalOverdensityAperture(500)
    SO_2500_MEAN = MeanSphericalOverdensityAperture(2500)
    SO_200_TOP_HAT = TopHatSphericalOverdensityAperture(200)
    FIXED_5_KPC = FixedRadiusAperture(unit_quantity(5.0, "kpc"))
    FIXED_10_KPC = FixedRadiusAperture(unit_quantity(10.0, "kpc"))
    FIXED_30_KPC = FixedRadiusAperture(unit_quantity(30.0, "kpc"))
    FIXED_50_KPC = FixedRadiusAperture(unit_quantity(50.0, "kpc"))
    FIXED_100_KPC = FixedRadiusAperture(unit_quantity(100.0, "kpc"))


def calculate_n_children(
    halo_ids: np.ndarray, parent_ids: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Direct-children and total-descendant counts per halo.

    Semantics of `_CatalogueBase.py:694-715` (-1 = no parent; self-parenting
    treated as root), vectorized: parent-index resolution by sorted-ID
    searchsorted, ancestor chains accumulated one tree level at a time with
    bincount — O(N log N * tree_depth) instead of the reference's O(N^2) loop.
    """
    n = len(halo_ids)
    n_direct = np.zeros(n, dtype=np.int64)
    n_total = np.zeros(n, dtype=np.int64)
    if n == 0 or (parent_ids != -1).sum() == 0 or (halo_ids != parent_ids).sum() == 0:
        return n_direct, n_total

    order = np.argsort(halo_ids)
    sorted_ids = halo_ids[order]
    pos = np.searchsorted(sorted_ids, parent_ids)
    pos_c = np.clip(pos, 0, n - 1)
    valid = (parent_ids != -1) & (sorted_ids[pos_c] == parent_ids)
    parent_index = np.where(valid, order[pos_c], -1)
    # a halo listed as its own parent is a root
    self_parent = parent_index == np.arange(n)
    parent_index[self_parent] = -1
    valid &= ~self_parent

    n_direct = np.bincount(parent_index[valid], minlength=n).astype(np.int64)

    # propagate: at each level, every halo with a live ancestor pointer
    # contributes one descendant to that ancestor, then hops one level up
    current = parent_index.copy()
    for _ in range(n):  # bounded by tree depth; break below
        live = current != -1
        if not live.any():
            break
        n_total += np.bincount(current[live], minlength=n).astype(np.int64)
        current[live] = parent_index[current[live]]
    return n_direct, n_total


class CatalogueBase(ABC):
    """Abstract halo-catalogue reader (`_CatalogueBase.py:145-780`)."""

    BasicHaloDefinitions = BasicHaloDefinitions

    def __init__(
        self, membership_filepath: str, properties_filepath: str, snapshot: SnapshotBase
    ) -> None:
        self._membership_filepath = membership_filepath
        self._properties_filepath = properties_filepath
        self._snapshot = snapshot
        self._n_direct_children: Optional[np.ndarray] = None
        self._n_total_descendants: Optional[np.ndarray] = None
        self._executor: Optional[ThreadPoolExecutor] = None

    # -- hierarchy hooks -------------------------------------------------------
    @abstractmethod
    def _get_hierarchy_IDs(self) -> tuple[np.ndarray, np.ndarray]:
        """(halo IDs, parent IDs); parent -1 where none."""

    # -- metadata passthrough (`_CatalogueBase.py:213-296`) ---------------------
    @property
    def membership_filepath(self) -> str:
        return self._membership_filepath

    @property
    def properties_filepath(self) -> str:
        return self._properties_filepath

    @property
    def snapshot(self) -> SnapshotBase:
        return self._snapshot

    @property
    def redshift(self) -> float:
        return self._snapshot.redshift

    z = redshift

    @property
    def expansion_factor(self) -> float:
        return self._snapshot.expansion_factor

    a = expansion_factor

    @property
    def hubble_param(self) -> float:
        return self._snapshot.hubble_param

    h = hubble_param

    @property
    def box_size(self):
        return self._snapshot.box_size

    @property
    def number_of_haloes(self) -> int:
        return self.get_number_of_haloes()

    def __len__(self) -> int:
        return self.number_of_haloes

    # -- hierarchy analytics (`_CatalogueBase.py:316-343,688-715`) --------------
    def _ensure_descendant_info(self) -> None:
        if self._n_direct_children is None:
            self._n_direct_children, self._n_total_descendants = calculate_n_children(
                *self._get_hierarchy_IDs()
            )

    @property
    def number_of_children(self) -> np.ndarray:
        self._ensure_descendant_info()
        return self._n_direct_children

    @property
    def number_of_descendants(self) -> np.ndarray:
        self._ensure_descendant_info()
        return self._n_total_descendants

    # -- abstract halo API (`_CatalogueBase.py:345-645`) -------------------------
    @abstractmethod
    def get_number_of_haloes(self, particle_type: Optional[ParticleType] = None) -> int: ...

    @abstractmethod
    def get_halo_IDs(self, particle_type: Optional[ParticleType] = None) -> np.ndarray: ...

    @abstractmethod
    def get_halo_indexes(self, particle_type: Optional[ParticleType] = None) -> np.ndarray: ...

    @abstractmethod
    def get_halo_parent_IDs(self, particle_type: Optional[ParticleType] = None) -> np.ndarray: ...

    @abstractmethod
    def get_halo_parent_indexes(
        self, particle_type: Optional[ParticleType] = None
    ) -> np.ndarray: ...

    @abstractmethod
    def get_halo_top_level_parent_IDs(
        self, particle_type: Optional[ParticleType] = None
    ) -> np.ndarray: ...

    @abstractmethod
    def get_halo_top_level_parent_indexes(
        self, particle_type: Optional[ParticleType] = None
    ) -> np.ndarray: ...

    @abstractmethod
    def get_halo_centres_of_mass(
        self, particle_type: Optional[ParticleType] = None, use_proper_units: bool = False
    ) -> UnitArray: ...

    @abstractmethod
    def get_halo_centres_of_potential(
        self, particle_type: Optional[ParticleType] = None, use_proper_units: bool = False
    ) -> UnitArray: ...

    @abstractmethod
    def get_halo_masses(
        self, halo_type: IHaloDefinition, particle_type: Optional[ParticleType] = None
    ) -> UnitArray: ...

    @abstractmethod
    def get_halo_radii(
        self,
        halo_type: IHaloDefinition,
        particle_type: Optional[ParticleType] = None,
        use_proper_units: bool = False,
    ) -> UnitArray: ...

    @abstractmethod
    def get_halo_IDs_by_snapshot_particle(
        self, particle_type: ParticleType, snapshot_particle_ids: Optional[np.ndarray] = None
    ) -> np.ndarray: ...

    @abstractmethod
    def get_halo_indexes_by_snapshot_particle(
        self, particle_type: ParticleType, snapshot_particle_ids: Optional[np.ndarray] = None
    ) -> np.ndarray: ...

    @abstractmethod
    def get_particle_IDs(
        self, particle_type: ParticleType, include_unbound: bool = True
    ) -> np.ndarray: ...

    # -- async (`_CatalogueBase.py:717-780`) --------------------------------------
    def read_async(self, getter_name: str, /, *args, **kwargs) -> Future:
        if self._executor is None:
            self._executor = ThreadPoolExecutor(max_workers=4, thread_name_prefix="cat-io")
        return self._executor.submit(getattr(self, getter_name), *args, **kwargs)
