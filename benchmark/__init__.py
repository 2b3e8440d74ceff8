"""The benchmark of tpusparse_torch on one NVIDIA H100: ``run.py`` runs
one cell of ``BENCHMARK.json`` and prints its result line."""
