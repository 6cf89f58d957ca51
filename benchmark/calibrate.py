#!/usr/bin/env python3
"""Readings that set the limits of a cell's comparison.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11 12 ... \
        --seconds <s> [--control bfloat16] [--fault <name>]

Sets the cell up once and, for each seed, makes the seed's inputs, runs a
window of ``--seconds`` through the timed path and prints one JSON line:
the numbers the run's check compares, from the port (the lower reading of
a limit) and, with ``--control``, from the reference computed in that
lower precision in the port's place (the upper reading).  With
``--fault`` the port runs with that fault planted (``harness/faults.py``)
and the line gives what the check reads of it.  The benchmark's own runs
never run the control or a fault.  Needs the card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from benchmark import run as bench_run  # noqa: E402
from benchmark.harness import common, faults  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control", default=None,
                    help="torch dtype of the control, e.g. bfloat16")
    ap.add_argument("--fault", default=None, choices=faults.FAULTS)
    args = ap.parse_args(argv)
    with (faults.planted(args.fault) if args.fault
          else contextlib.nullcontext()):
        readings(args)


def readings(args):
    clock = common.SetupClock()
    cell, cfg_file, mix = bench_run.cell_files(args.workload)
    common.require_cards(cell["chips"])
    cellrun = bench_run.drive(mix).Cell(cfg_file, mix,
                                        torch.device("cuda", 0))
    cellrun.setup(clock, args.seconds)
    control = None if args.control is None else getattr(torch, args.control)
    for i, seed in enumerate(args.seeds):
        cellrun.inputs(seed)
        if i == 0:
            cellrun.warm_up()
        w = cellrun.window(args.seconds)
        line = {"seed": seed, "fault": args.fault,
                "units": w.get("steps", w.get("frames")),
                "port": {k: v["value"] for k, v in cellrun.check(w).items()}}
        if control is not None:
            line["control"] = {k: v["value"] for k, v in
                               cellrun.check(w, control=control).items()}
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
