"""Port vs JAX: Morton keys and cell lists (``ops/cells.py``).

``morton_encode_3d`` bit for bit against the JAX function over random
10-bit triples and the whole 10-bit range of each axis; ``linear_cell_id``
and ``build_cell_list`` (``order``, ``cell_of_particle``, ``cell_start`` /
``cell_end``) equal to JAX's on 3,000 points, row-major and Morton, on the
CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from astro_sph_tools_tpu.ops import cells as J
from astro_sph_tools_tpu_torch.ops import cells as T


def test_morton_bit_for_bit():
    rng = np.random.default_rng(0)
    coords = rng.integers(0, 1024, (20000, 3))
    ramp = np.arange(1024)
    coords = np.vstack([coords, np.stack([ramp, ramp[::-1], (ramp * 7) % 1024], axis=1)])
    got = T.morton_encode_3d(*(torch.as_tensor(coords[:, a]) for a in range(3)))
    ref = np.asarray(J.morton_encode_3d(*(jnp.asarray(coords[:, a]) for a in range(3))))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(T.morton_encode_3d([1, 0, 0, 1], [0, 1, 0, 1], [0, 0, 1, 1]).numpy(), [1, 2, 4, 7])


@pytest.mark.parametrize("morton", [False, True], ids=["row_major", "morton"])
def test_cell_list_matches_jax(morton):
    rng = np.random.default_rng(1)
    pos = rng.uniform(0, 10, (3000, 3)).astype(np.float32)
    pos[:5, 0] = [0.0, 10.0, 9.999999, 5.0, 2.5]  # edges: clipped into the grid
    got = T.build_cell_list(pos, box_size=10.0, n_cells_per_axis=8, morton=morton, device="cpu")
    ref = J.build_cell_list(jnp.asarray(pos), box_size=10.0, n_cells_per_axis=8, morton=morton)
    for name in ("order", "cell_of_particle", "cell_start", "cell_end"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name)
    assert got.cell_of_particle.dtype == got.cell_start.dtype == torch.int32
    np.testing.assert_array_equal(
        T.linear_cell_id(pos, 10.0, 8, morton, device="cpu").numpy(),
        np.asarray(J.linear_cell_id(jnp.asarray(pos), 10.0, 8, morton)),
    )
    if not morton:
        assert int(got.counts().sum()) == 3000 and got.n_cells == 512 and got.cell_size == 1.25
