"""IO layer: snapshot/catalogue/LOS data models and format backends.

Counterpart: ``astro_sph_tools_tpu/io/__init__.py``, the same surface
except the packing, prefetch and ionisation modules, which are not ported
yet (ROADMAP queue 1). The readers name ``h5py`` through ``io/_lazy.py``,
so importing this package does not import ``h5py``: the first read does.
"""

from . import errors
from .catalogue import (
    BasicHaloDefinitions,
    CatalogueBase,
    CriticalSphericalOverdensityAperture,
    FixedRadiusAperture,
    FOFGroup,
    IApertureHalo,
    IHaloDefinition,
    MeanSphericalOverdensityAperture,
    SphericalOverdensityAperture,
    TopHatSphericalOverdensityAperture,
)
from .eagle import EAGLE_MAX_GROUP_NUMBER, SnapshotEAGLE
from .filetree import (
    FileSetLeaf,
    FileTreeScraper_EAGLE,
    FileTreeScraper_SWIFT,
    FileTreeScraperBase,
    TaggedFileSet,
    discover_soap_catalogues,
    discover_swift_snapshots,
)
from .los import (
    LineOfSightBase,
    LineOfSightEAGLE,
    LineOfSightFileBase,
    LineOfSightFileEAGLE,
    LineOfSightFileSWIFT,
)
from .particle_filter import (
    LineOfSightParticleFilter,
    ParticleFilterFile,
    SnapshotParticleFilter,
)
from .snapshot import SnapshotBase
from .subfind import CatalogueSUBFIND
from .swift import CatalogueSOAP, SnapshotSWIFT
from .tng import CatalogueTNG, SnapshotTNG

__all__ = [
    "errors",
    "BasicHaloDefinitions",
    "CatalogueBase",
    "CatalogueSOAP",
    "CatalogueSUBFIND",
    "CatalogueTNG",
    "CriticalSphericalOverdensityAperture",
    "EAGLE_MAX_GROUP_NUMBER",
    "FileSetLeaf",
    "FileTreeScraperBase",
    "FileTreeScraper_EAGLE",
    "FileTreeScraper_SWIFT",
    "discover_soap_catalogues",
    "discover_swift_snapshots",
    "FixedRadiusAperture",
    "FOFGroup",
    "IApertureHalo",
    "IHaloDefinition",
    "LineOfSightBase",
    "LineOfSightEAGLE",
    "LineOfSightFileBase",
    "LineOfSightFileEAGLE",
    "LineOfSightFileSWIFT",
    "LineOfSightParticleFilter",
    "ParticleFilterFile",
    "SnapshotParticleFilter",
    "MeanSphericalOverdensityAperture",
    "SnapshotBase",
    "SnapshotEAGLE",
    "SnapshotSWIFT",
    "SnapshotTNG",
    "SphericalOverdensityAperture",
    "TaggedFileSet",
    "TopHatSphericalOverdensityAperture",
]
