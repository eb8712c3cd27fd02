"""Per-layer metric readers, one file a metric, found by its name in
``BENCHMARK.json``: ``read(ctx)`` returns the metric's value, or None where
the run gives it nothing to read."""
