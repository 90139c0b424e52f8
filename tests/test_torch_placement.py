"""Port vs JAX: the sorted engine's f32 placement, on the streamed 64^2 chunks.

``test_torch_e2e_ingest.py``'s snapshot (the JAX ``benchmarks/e2e_1e8.py``
writer at 2^14 particles, h drawn for a 64^2 map, footprints down to 0.25
px) read on the ``f32`` wire in 4 chunks, and each chunk's f32 coordinates
deposited by both packages' ``deposit_2d_auto``: the port's plain kernel
version and the JAX Pallas kernel in interpret mode. Both place a particle
at ``fl(fl(x / pixel) - tile origin)`` in f32 (``deposit_pallas.py::
_tile_local_coords`` and the port's ``deposit_tiled.py::_tile_local_coords``),
so the two maps agree within the f32 comparison bound (2e-5 * max, ROADMAP
§3 finding 3). Each map's error against the f64 oracle of the particles as
read is printed beside the other's, and each stays within the same bound:
the error is an ulp of the global f32 pixel coordinate ``x / pixel``, which
the two packages round apart (XLA on the CPU divides by the pixel size's
reciprocal), so either package's map is the nearer one on a given input.
"""

import numpy as np
import torch

from astro_sph_tools_tpu.data_structures import ParticleType as JParticleType
from astro_sph_tools_tpu.ops.deposit import MapSpec as JMapSpec
from astro_sph_tools_tpu.ops.deposit_pallas import deposit_2d_auto as j_deposit_2d_auto
from astro_sph_tools_tpu_torch import constants as C
from astro_sph_tools_tpu_torch.data_structures import ParticleType
from astro_sph_tools_tpu_torch.io.eagle import SnapshotEAGLE
from astro_sph_tools_tpu_torch.ops import MapSpec, deposit_2d_auto
from oracles import project_oracle
from test_torch_e2e_ingest import N_CHUNKS, RES, read_chunk, snapshot  # noqa: F401  (snapshot: the fixture)

PAIR_TOL = 2e-5  # f32 maps of the two packages (ROADMAP §3 finding 3)


def test_f32_placement_is_the_references(snapshot):  # noqa: F811
    first, box = snapshot
    spec = MapSpec(shape=(RES, RES), extent=(0.0, box, 0.0, box), periodic_wrap=True)
    jspec = JMapSpec(shape=(RES, RES), extent=(0.0, box, 0.0, box), periodic_wrap=True)
    port_map = jax_map = 0.0
    parts = []
    for ci in range(N_CHUNKS):
        raw = read_chunk(SnapshotEAGLE, ParticleType.gas, C, first, "f32", ci)
        x, y, h, m, t = (raw[k] for k in "xyhmt")
        assert x.dtype == np.float32
        values = np.stack([m, m * t])  # the payload in f32, as both engines form it
        port_map = port_map + deposit_2d_auto(*(torch.as_tensor(a) for a in (x, y, h, values)), spec,
                                              device="cpu").numpy()
        jax_map = jax_map + np.asarray(j_deposit_2d_auto(x, y, h, values, jspec))
        parts.append((x, y, h, values))
    assert JParticleType.gas.value == ParticleType.gas.value
    x, y, h = (np.concatenate([p[i] for p in parts]).astype(np.float64) for i in range(3))
    values = np.concatenate([p[3] for p in parts], axis=1).astype(np.float64)
    oracle = np.stack([project_oracle(x, y, h, v, (RES, RES), spec.extent, periodic=True) for v in values])

    def rel(got, ref):
        return max(np.abs(got[f] - ref[f]).max() / np.abs(ref[f]).max() for f in range(2))

    port_err, jax_err = rel(port_map, oracle), rel(jax_map, oracle)
    print(f"f32 placement vs the f64 oracle: port {port_err:.3e} * max, JAX {jax_err:.3e} * max; "
          f"port vs JAX {rel(port_map, jax_map):.3e} * max")
    assert rel(port_map, jax_map) <= PAIR_TOL
    assert max(port_err, jax_err) <= PAIR_TOL
