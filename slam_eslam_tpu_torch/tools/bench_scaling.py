"""Scaling of the sharded filter step over 1..K ranks.

Counterpart of ``tools/bench_scaling.py`` of the JAX package: the full
filter step (odometry, propagation, contact weighting through the fold
K1, the ESS-gated resample with its all-gathered weights and payload)
over a mesh of ``k`` ranks for each ``k`` of ``--devices``, each world
its own set of processes (``parallel.distributed.run_world``).

Weak scaling (the default): ``--per-device`` particles per rank, and
``weak_scaling_eff = t(1) / t(k)``.  ``--fixed-total N`` holds the total
fixed instead (``partitioning_overhead = t(k) / t(1)``: what the
collectives add).  A step's time is the host clock around the step on
every rank between two barriers, the card synchronised, the best of
``--repeats``.

Where the ranks cannot show scaling the line says so in ``note``:
``"cpu-gloo-ranks"`` on the CPU (the ranks share the host's cores, as the
JAX tool's ``virtual-cpu-mesh`` shares them), ``"shared-card"`` where
ranks outnumber the cards and share one over gloo (``transport
host``): those lines check the sharded path and claim no scaling.
``graphed`` says how each world ran its step: CUDA graphs over NCCL (a
card per rank), eager launches over gloo and the host transport (the
default ``graph=None`` of ``filter.step.make_filter_step``).

Usage: python -m slam_eslam_tpu_torch.tools.bench_scaling
           [--per-device 8192] [--devices 1 2 4 8] [--repeats 5]
           [--fixed-total N] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import torch


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--per-device", type=int, default=8192)
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--fixed-total", type=int, default=0, dest="fixed_total",
                    help="hold the total particle count fixed and vary the "
                         "rank count: t(k)/t(1) is what partitioning adds")
    ap.add_argument("--cpu", action="store_true",
                    help="run the ranks on the CPU (gloo)")
    return ap


def _rank(mesh, n, repeats):
    """One rank: build the step at ``n`` particles (``graph=None``: CUDA
    graphs over NCCL, eager over gloo and the host transport), run it
    twice (a graphed step captures at its second call), then time
    ``repeats`` steps between barriers; returns ``(the best seconds,
    graphed)``."""
    from slam_eslam_tpu_torch.dryrun import GATE, _build
    from slam_eslam_tpu_torch.filter import step as steplib
    from slam_eslam_tpu_torch.parallel import sharding as shd

    cfg, lookup, state, cs, q = _build(n, nx=64, ny=64, device=mesh.device,
                                       mesh=mesh)
    state = shd.shard_state(state, mesh)
    fn = steplib.make_filter_step(cfg, lookup, mesh=mesh)

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        mesh.all_reduce(torch.zeros((), device=mesh.device))

    for _ in range(2):
        out, _ = fn(state, cs, q, GATE)
    float(out.particles.weight.sum())
    best = float("inf")
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        out, _ = fn(state, cs, q, GATE)
        sync()
        best = min(best, time.perf_counter() - t0)
    # every rank waits for the slowest: the step's time is the largest
    return (float(mesh.all_reduce(torch.tensor(best, device=mesh.device),
                                  "max")),
            fn.graphs is not None)


def main(argv=None):
    from slam_eslam_tpu_torch.parallel import distributed as pdist
    from slam_eslam_tpu_torch.utils.device import card_line, entry_device

    args = parser().parse_args(argv)
    device = entry_device("cpu" if args.cpu else None)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    results, t1 = {}, None
    for k in args.devices:
        n = args.fixed_total or args.per_device * k
        sec, graphed = pdist.run_world(_rank, k, args=(n, args.repeats),
                                       device=device.type)[0]
        t1 = sec if t1 is None else t1
        row = {"n": n, "sec": sec, "graphed": graphed}
        if args.fixed_total:
            row["partitioning_overhead"] = sec / t1
            label = f"overhead={sec / t1:.2f}x"
        else:
            row["weak_scaling_eff"] = t1 / sec
            label = f"eff={t1 / sec:.2f}"
        if device.type == "cpu":
            row["note"] = "cpu-gloo-ranks"
        elif k > cards:
            row["note"] = "shared-card"
        row["transport"] = ("gloo" if device.type == "cpu"
                            else "host" if k > cards else "nccl")
        results[k] = row
        print(f"devices={k:2d}  particles={n:8d}  {sec * 1e3:8.2f} ms "
              f"{label}  [{row['transport']}, "
              f"{'graphed' if graphed else 'eager'}"
              + (f", {row['note']}" if "note" in row else "") + "]",
              flush=True)
    key = "fixed_total_scaling" if args.fixed_total else "weak_scaling"
    line = {key: results, "device": str(device),
            "card": card_line(device)}
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
