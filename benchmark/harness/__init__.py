"""The benchmark's harness: one run of one cell (``benchmark/run.py``)."""
