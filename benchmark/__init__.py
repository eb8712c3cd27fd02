"""The benchmark of ``dupl_tpu_torch`` on one NVIDIA card.

``benchmark/run.py`` runs one cell of ``BENCHMARK.json`` once; the layout
that lets later changes add configurations, traffic mixes and metrics as
new files is in ``benchmark/README.md``.  Nothing here imports JAX or the
JAX package.
"""
