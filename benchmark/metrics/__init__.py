"""The per-layer metric readers, one file per metric named as in
``BENCHMARK.json``, each with ``read(ctx)`` (``harness.metrics``)."""
