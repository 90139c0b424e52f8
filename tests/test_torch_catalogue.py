"""Port vs JAX: halo definitions, hierarchy analytics and the SUBFIND
catalogue (``io/catalogue.py``, ``io/subfind.py``).

Mirrors ``tests/test_catalogue.py``. The modules are copied, so on the same
synthetic EAGLE snapshot and SUBFIND files (the JAX package's fixture
writers) every ID, index, centre, radius, mass and membership map must equal
JAX's exactly (``np.array_equal``), units included.
"""

import numpy as np
import pytest

import astro_sph_tools_tpu.io.catalogue as jcat
from astro_sph_tools_tpu.data_structures import ParticleType as JParticleType
from astro_sph_tools_tpu.io.eagle import SnapshotEAGLE as JSnapshotEAGLE
from astro_sph_tools_tpu.io.errors import HaloDefinitionNotSupportedError as JHaloDefinitionNotSupportedError
from astro_sph_tools_tpu.io.subfind import CatalogueSUBFIND as JCatalogueSUBFIND
from astro_sph_tools_tpu.io.synthetic import SyntheticSnapshotSpec, write_catalogue, write_snapshot
from astro_sph_tools_tpu_torch import io
from astro_sph_tools_tpu_torch.data_structures import ParticleType
from astro_sph_tools_tpu_torch.io.catalogue import (
    BasicHaloDefinitions,
    CriticalSphericalOverdensityAperture,
    FixedRadiusAperture,
    FOFGroup,
    MeanSphericalOverdensityAperture,
    TopHatSphericalOverdensityAperture,
    calculate_n_children,
)
from astro_sph_tools_tpu_torch.io.eagle import SnapshotEAGLE
from astro_sph_tools_tpu_torch.io.errors import HaloDefinitionNotSupportedError
from astro_sph_tools_tpu_torch.io.subfind import CatalogueSUBFIND
from astro_sph_tools_tpu_torch.units import unit_quantity


def same(t, j):
    """Port and JAX results equal: arrays exactly, UnitArrays with their units."""
    if hasattr(j, "units"):
        assert t.units.symbol == j.units.symbol
        t, j = t.value, j.value
    assert np.array_equal(np.asarray(t), np.asarray(j))


class TestHaloDefinitions:
    def test_value_equality(self):
        assert FOFGroup() == FOFGroup()
        assert CriticalSphericalOverdensityAperture(200) == CriticalSphericalOverdensityAperture(200)
        assert CriticalSphericalOverdensityAperture(200) != CriticalSphericalOverdensityAperture(500)
        assert CriticalSphericalOverdensityAperture(200) != MeanSphericalOverdensityAperture(200)
        assert MeanSphericalOverdensityAperture(200) != TopHatSphericalOverdensityAperture(200)
        a = FixedRadiusAperture(unit_quantity(30.0, "kpc"))
        assert a == FixedRadiusAperture(unit_quantity(30.0, "kpc"))
        assert a != FixedRadiusAperture(unit_quantity(50.0, "kpc"))

    def test_enum_matches_jax(self):
        assert [d.name for d in BasicHaloDefinitions] == [d.name for d in jcat.BasicHaloDefinitions]
        for d, jd in zip(BasicHaloDefinitions, jcat.BasicHaloDefinitions):
            assert type(d.value).__name__ == type(jd.value).__name__
            assert d.value.get_details_for_error() == jd.value.get_details_for_error()

    def test_make_error(self):
        err = FOFGroup().make_error(CatalogueSUBFIND)
        assert isinstance(err, HaloDefinitionNotSupportedError)
        assert "FOFGroup" in str(err)


class TestHierarchyAnalytics:
    @pytest.mark.parametrize("case", ["flat", "two_level", "random_forest"])
    def test_matches_jax(self, case, rng):
        if case == "flat":
            ids, parents = np.array([1, 2, 3]), np.array([-1, -1, -1])
        elif case == "two_level":
            ids, parents = np.array([1, 2, 3, 4]), np.array([-1, 1, 1, 2])
        else:
            n = 200
            ids = rng.permutation(n) + 1
            parents = np.full(n, -1)
            for i in range(1, n):
                if rng.random() < 0.8:
                    parents[i] = ids[rng.integers(0, i)]
        got = calculate_n_children(ids, parents)
        ref = jcat.calculate_n_children(ids, parents)
        for g, r in zip(got, ref):
            assert np.array_equal(g, r)
        if case == "two_level":
            assert got[0].tolist() == [2, 1, 0, 0] and got[1].tolist() == [3, 1, 0, 0]


@pytest.fixture(scope="module")
def catalogues(tmp_path_factory):
    spec = SyntheticSnapshotSpec(n_gas=2048, n_dm=1024, n_star=256, n_bh=8, n_files=2, n_groups=6)
    root = tmp_path_factory.mktemp("torch_eagle_cat")
    snap_path, truth = write_snapshot(str(root), spec)
    memb, prop = write_catalogue(str(root), spec, truth)
    port = CatalogueSUBFIND(memb, prop, SnapshotEAGLE(snap_path))
    ref = JCatalogueSUBFIND(memb, prop, JSnapshotEAGLE(snap_path))
    return port, ref, truth, spec


DEFINITIONS = [d.name for d in BasicHaloDefinitions]


class TestCatalogueSUBFIND:
    def test_counts_ids_indexes(self, catalogues):
        cat, ref, _, spec = catalogues
        assert cat.get_number_of_haloes() == ref.get_number_of_haloes() == spec.n_groups
        assert len(cat) == len(ref)
        same(cat.get_halo_IDs(), ref.get_halo_IDs())
        same(cat.get_halo_indexes(), ref.get_halo_indexes())
        same(cat.get_halo_top_level_parent_IDs(), ref.get_halo_top_level_parent_IDs())
        same(cat.number_of_children, ref.number_of_children)
        same(cat.number_of_descendants, ref.number_of_descendants)
        with pytest.raises(NotImplementedError):
            cat.get_halo_parent_IDs()
        with pytest.raises(NotImplementedError):
            cat.get_halo_centres_of_mass()

    def test_centres(self, catalogues):
        cat, ref, truth, _ = catalogues
        same(cat.get_halo_centres_of_potential(), ref.get_halo_centres_of_potential())
        np.testing.assert_allclose(cat.get_halo_centres_of_potential().value, truth.group_centres, rtol=1e-10)

    @pytest.mark.parametrize("definition", DEFINITIONS)
    def test_masses_and_radii(self, catalogues, definition):
        cat, ref, *_ = catalogues
        d = BasicHaloDefinitions[definition].value
        jd = jcat.BasicHaloDefinitions[definition].value
        for getter in ("get_halo_masses", "get_halo_radii"):
            try:
                expected = getattr(ref, getter)(jd)
            except (JHaloDefinitionNotSupportedError, KeyError) as err:
                # the JAX reader refuses (or the file lacks the field): so must the port
                with pytest.raises(KeyError if isinstance(err, KeyError) else HaloDefinitionNotSupportedError):
                    getattr(cat, getter)(d)
                continue
            same(getattr(cat, getter)(d), expected)

    @pytest.mark.parametrize("pt", ["gas", "dark_matter", "star", "black_hole"])
    def test_membership(self, catalogues, pt):
        cat, ref, truth, _ = catalogues
        t_pt, j_pt = ParticleType[pt], JParticleType[pt]
        assert cat.get_number_of_haloes(t_pt) == ref.get_number_of_haloes(j_pt)
        same(cat.get_halo_indexes(t_pt), ref.get_halo_indexes(j_pt))
        same(cat.get_particle_IDs(t_pt), ref.get_particle_IDs(j_pt))
        same(cat.get_halo_indexes_by_snapshot_particle(t_pt), ref.get_halo_indexes_by_snapshot_particle(j_pt))
        same(cat.get_halo_IDs_by_snapshot_particle(t_pt), ref.get_halo_IDs_by_snapshot_particle(j_pt))
        same(cat.get_halo_indexes_by_all_snapshot_particles(t_pt),
             ref.get_halo_indexes_by_all_snapshot_particles(j_pt))
        sub = truth.ids[j_pt][::3]
        same(cat.get_halo_indexes_by_snapshot_particle(t_pt, sub), ref.get_halo_indexes_by_snapshot_particle(j_pt, sub))

    def test_halo_map_is_group_number(self, catalogues):
        cat, _, truth, _ = catalogues
        idx_map = cat.get_halo_indexes_by_snapshot_particle(ParticleType.gas)
        gn = truth.group_numbers[JParticleType.gas]
        member = (gn > 0) & (gn < 2**30)
        np.testing.assert_array_equal(idx_map[member], gn[member] - 1)
        assert (idx_map[~member] == -1).all()

    def test_unsupported_definition_raises(self, catalogues):
        cat, *_ = catalogues
        with pytest.raises(HaloDefinitionNotSupportedError):
            cat.get_halo_masses(BasicHaloDefinitions.FIXED_30_KPC.value)
        with pytest.raises(HaloDefinitionNotSupportedError):
            cat.get_halo_radii(BasicHaloDefinitions.FOF_GROUP.value)

    def test_cosmology_passthrough(self, catalogues):
        cat, ref, *_ = catalogues
        assert cat.redshift == ref.redshift and cat.hubble_param == ref.hubble_param

    def test_exported(self):
        assert io.CatalogueSUBFIND is CatalogueSUBFIND and io.BasicHaloDefinitions is BasicHaloDefinitions
