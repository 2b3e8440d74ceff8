"""Per-layer metric readers, one file per metric of ``BENCHMARK.json``,
found by its name; modules whose name starts with ``_`` are helpers."""
