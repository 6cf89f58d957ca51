#!/usr/bin/env python3
"""One run of one benchmark cell of the PyTorch/CUDA port.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``benchmark/configs/<config>.json``) and a traffic mix
(``benchmark/traffic/<traffic>.json``), whose ``drive`` names the loop
that drives the port (``benchmark/harness/drive_<drive>.py``).  The run makes its inputs from ``--seed``, sets the
port up and warms it up, measures for ``--seconds``, checks what the
timed path produced against the plain reference (``benchmark/reference``)
and prints one JSON line last on stdout: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics from a
profiler trace of part of the window.  Without as many CUDA devices as
the cell needs it exits with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# every cache of the program at a fixed path inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

from benchmark.harness import common  # noqa: E402



def drive(mix):
    """The module of the traffic mix's drive, found by its name."""
    import importlib

    return importlib.import_module(f"benchmark.harness.drive_{mix['drive']}")


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def cell_files(name):
    """``(cell, configuration, traffic mix)`` of the workload ``name``."""
    with open(ROOT / "BENCHMARK.json") as fh:
        bench = json.load(fh)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}: {sorted(cells)}")
    cell = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(ROOT / cfg["file"]) as fh:
        cfg_file = json.load(fh)
    from benchmark.harness import traffic

    return cell, cfg_file, traffic.load(cell["traffic"])


def main(argv=None):
    clock = common.SetupClock()
    args = parser().parse_args(argv)
    cell, cfg_file, mix = cell_files(args.workload)
    common.require_cards(cell["chips"])
    common.log(f"card: {common.power_limit()}")
    result, checks = drive(mix).run(args, cell["name"], cfg_file, mix, clock)
    common.emit(result, checks)


if __name__ == "__main__":
    main()
