"""astro_sph_tools_tpu_torch.scripts (counterpart: ``astro_sph_tools_tpu/scripts``)."""
