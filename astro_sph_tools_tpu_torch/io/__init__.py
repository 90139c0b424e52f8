"""IO layer: snapshot/catalogue/LOS data models and format backends.

Counterpart: ``astro_sph_tools_tpu/io/__init__.py``, the same surface. The
readers and the HM01 tables name ``h5py`` through ``io/_lazy.py``, so
importing this package does not import ``h5py``: the first read does.
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
from .ionisation import IonisationTable_HM01, SupportedIons
from .los import (
    LineOfSightBase,
    LineOfSightEAGLE,
    LineOfSightFileBase,
    LineOfSightFileEAGLE,
    LineOfSightFileSWIFT,
)
from .packing import PackedParticles, pack_particles_host, unpack_particles_device
from .particle_filter import (
    LineOfSightParticleFilter,
    ParticleFilterFile,
    SnapshotParticleFilter,
)
from .prefetch import stream_macro_chunks, stream_particle_blocks, streamed_deposit_2d
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
    "IonisationTable_HM01",
    "SupportedIons",
    "PackedParticles",
    "pack_particles_host",
    "unpack_particles_device",
    "stream_macro_chunks",
    "stream_particle_blocks",
    "streamed_deposit_2d",
]
