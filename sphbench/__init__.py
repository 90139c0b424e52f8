"""The benchmark of ``astro_sph_tools_tpu_torch`` on one or more NVIDIA cards.

``python3 sphbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON result line.
Everything a cell is made of is found by name, one file each: configurations
(``configs/``), traffic (``workloads/``), generators (``generators/``),
entries into the program (``entries/``), per-metric readers (``metrics/``),
the plain references of each product (``reference/``) and the limits of the
comparison that decides ``correct`` (``limits/``). Nothing here imports JAX
or the JAX package; only ``entries/`` imports the program.
"""
