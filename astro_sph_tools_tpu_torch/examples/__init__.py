"""Runnable tours of the port, one module each::

    python -m astro_sph_tools_tpu_torch.examples.full_workflow [--device cuda]
    python -m astro_sph_tools_tpu_torch.examples.render_service [--device cuda]
    torchrun --nproc-per-node=N -m astro_sph_tools_tpu_torch.examples.multichip_render

Counterparts: the JAX package's ``examples/`` scripts. Each ``main(argv)``
prints its numbers and returns them as a dict; ``--device`` defaults to the
card, and the CPU is used only when asked for (``--device cpu``).
"""
