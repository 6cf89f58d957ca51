"""The benchmark's own tests: ``python -m pytest benchmark/tests`` (CPU;
tests that need the card are marked ``cuda`` and skip without one)."""
