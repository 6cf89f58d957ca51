"""The per-layer metrics of a cell: each is a small reader of its own,
``benchmark/metrics/<metric name>.py`` with ``read(ctx)``, found by the
name ``BENCHMARK.json`` gives it.  A reader returns the metric's value or
None where it finds nothing to read, and the metric is then left out of
the line.  ``ctx`` holds the parsed trace (``"trace"``, a
``harness.trace.Trace``) and what the drive counted (``"steps"``,
``"frames"``, bounds of kernels)."""

from __future__ import annotations

import importlib.util
import json

from benchmark.harness.common import ROOT

METRICS = ROOT / "benchmark" / "metrics"


def load_reader(name):
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applicable(bench, cell):
    """The per-layer metrics of ``cell``: those that list it, and those
    without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"]: m for m in bench["end_to_end"]}

    def reports(name):
        ws = e2e[name].get("workloads")
        return ws is None or cell in ws

    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else reports(m["moves"]))]


def read(cell, ctx):
    with open(ROOT / "BENCHMARK.json") as fh:
        bench = json.load(fh)
    out = {}
    for m in applicable(bench, cell):
        value = load_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
