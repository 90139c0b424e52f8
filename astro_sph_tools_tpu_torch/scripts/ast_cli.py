"""ast-tpu: framework info entry point (parity: `_scripts/ast.py:9-10`).

Counterpart: ``astro_sph_tools_tpu/scripts/ast_cli.py``; prints the torch
build and its CUDA devices where the JAX one prints the JAX backend. Run it
with ``python -m astro_sph_tools_tpu_torch.scripts.ast_cli``.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    from ..__about__ import __version__

    print(f"astro-sph-tools-tpu v{__version__} (PyTorch + CUDA port)")
    print("SPH snapshot analysis and rendering framework.")
    print("Tools: python -m astro_sph_tools_tpu_torch.scripts.render_map, "
          "python -m astro_sph_tools_tpu_torch.scripts.sightlines_cli, "
          "python -m astro_sph_tools_tpu_torch.scripts.find_nearest_haloes")
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    names = ", ".join(torch.cuda.get_device_name(k) for k in range(n)) or "none"
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}); {n} CUDA device(s): {names}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
