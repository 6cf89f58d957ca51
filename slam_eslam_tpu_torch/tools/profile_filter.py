"""Profile the full filter step op by op (the bench's localisation shape).

Counterpart of ``tools/profile_filter.py`` of the JAX package: 100,000
particles on the 400x400 grid at 0.05 m, contacts compacted to 8, a
measurement update on every step, through ``filter.step.make_scan_runner``
of the port with the lookup of ``mapping.lookup.make_lookup``: the contact
fold, kernel K1 (``contact_fold_kernel``) on the card.  The runner is the
compiled one, as the JAX script's is jitted: CUDA graphs on the card (a
step eager at its first meeting, captured at its second, replayed
after), the eager loop on the CPU.  The warm-up run is traced on the
card for its capture (``profile_slam.warm_up``); the trace of one run of
replays is summed by name as ``tools.profile_slam.aggregate_trace`` does,
with the device records it kept beside the launches the host made.

``--lookup`` and ``--window`` are accepted and change nothing: the port
has one lookup over the whole grid, which sits in the card's L2, and no
window that a query could miss (``Config.lookup_window`` is ignored as
well).

Usage: python -m slam_eslam_tpu_torch.tools.profile_filter
           [--particles 100000] [--steps 10] [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

FOLD = "contact fold (kernel K1 contact_fold on the card)"
SELECT = "unfolded select (kernel K5 select_cells on the card)"


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--particles", type=int, default=100_000)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--lookup", default="window",
                    help="accepted and ignored: the port has one lookup")
    ap.add_argument("--window", default="64",
                    help="int (square) or WXxWY, e.g. 128x96; accepted and "
                         "ignored: the port's lookup has no window")
    ap.add_argument("--contact-cap", type=int, default=8,
                    dest="contact_cap")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--trace-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "filter_trace"),
                    help="where the trace goes (default: filter_trace in "
                         "the temporary directory)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions; the "
                         "table then sums host operators)")
    return ap


def lookup_name(cfg, lookup):
    """Which lookup a measurement update of ``cfg`` through ``lookup``
    runs (``models.contact_model.evaluate_pose_batch``'s choice)."""
    m = cfg.contact_model
    folds = (getattr(lookup, "fold", None) is not None and m.fold_lookup
             and m.weighting != "chitta" and not cfg.log_debug
             and not m.use_slip_update)
    return FOLD if folds else SELECT


def main(argv=None):
    """Run the profile; returns a dict with the first and steady seconds,
    ns per query, the aggregated rows (all of them), the total, the
    trace's path and kind, the device records kept and the launches made
    in the trace (``records``, on the card), whether the runner replayed
    CUDA graphs (``graphed``), the lookup that ran and the kernel launches
    of the steady run."""
    from slam_eslam_tpu_torch import bench, ops
    from slam_eslam_tpu_torch.config import Config, ContactModelConfig
    from slam_eslam_tpu_torch.filter import step as steplib
    from slam_eslam_tpu_torch.mapping.lookup import make_lookup
    from slam_eslam_tpu_torch.models import sim as simlib
    from slam_eslam_tpu_torch.tools.profile_slam import (aggregate_trace,
                                                         device_records,
                                                         print_table,
                                                         warm_up)
    from slam_eslam_tpu_torch.utils import profiling, tree
    from slam_eslam_tpu_torch.utils.device import card_line, entry_device

    args = parser().parse_args(argv)
    device = entry_device("cpu" if args.cpu else None)
    n = args.particles
    window = (tuple(int(v) for v in args.window.split("x"))
              if "x" in args.window else int(args.window))
    cfg = dataclasses.replace(
        Config(), particle_count=n, min_effective=n // 5,
        contact_model=ContactModelConfig(contact_point_radius=0.0),
        lookup_mode=args.lookup, lookup_window=window)
    grid = simlib.terrain_grid(bench.filter_terrain, **bench.FILTER_GRID,
                               device=device)
    lookup = make_lookup(cfg, grid)
    particles = tree.to(bench.filter_particles(n), device)
    css, qs, _, _ = bench.filter_trajectory(args.steps, args.contact_cap)
    css, qs = tree.to(css, device), qs.to(device)
    # the compiled runner: CUDA graphs on the card, the eager loop on the
    # CPU (utils.graphs.resolve)
    run = steplib.make_scan_runner(cfg, lookup)

    def timed():
        state = bench.filter_state(cfg, particles, args.contact_cap, device)
        profiling.sync()
        t0 = time.perf_counter()
        run(state, css, qs)
        profiling.sync()
        return time.perf_counter() - t0

    print(f"device: {device}" + (f" ({card_line(device)})"
                                 if device.type == "cuda" else ""))
    print(f"lookup: {lookup_name(cfg, lookup)}; --lookup {args.lookup} "
          f"--window {args.window} change nothing (one lookup over the "
          f"whole grid)")
    warm_dir = os.path.join(args.trace_dir, "warm-up")
    seconds, graphed = warm_up(timed, run, device, warm_dir)
    first_s = seconds[0]
    print(f"compile+first: {first_s:.1f}s (the kernels' build at first use "
          f"and the run" + (", traced; graphed: the first step eager, the "
                            "second captured)" if graphed else ")"),
          flush=True)
    before = ops.launch_counts()
    dt = timed()
    launches = {k: v - before[k] for k, v in ops.launch_counts().items()}
    ns_query = dt / args.steps / (n * args.contact_cap) * 1e9
    print(f"steady: {dt * 1e3:.2f} ms for {args.steps} steps "
          f"({ns_query:.2f} ns/query); launches {launches['contact_fold']} "
          f"contact_fold, {launches['select_cells']} select_cells; "
          + ("graphed (CUDA graphs replayed)" if graphed else "eager"),
          flush=True)

    state = bench.filter_state(cfg, particles, args.contact_cap, device)
    with profiling.trace(args.trace_dir):
        run(state, css, qs)
    on_card = device.type == "cuda"
    rows_all, total, path, kind = aggregate_trace(args.trace_dir, top=None,
                                                  on_card=on_card)
    records = (device_records(args.trace_dir,
                              (warm_dir,) if graphed else ())
               if on_card else None)
    print_table(rows_all[:args.top], total, path, kind, records)
    return dict(first_s=first_s, steady_s=dt, ns_per_query=ns_query,
                rows_all=rows_all, total_ms=total, path=path, kind=kind,
                lookup=lookup_name(cfg, lookup), launches=launches,
                updates=args.steps, graphed=graphed, records=records)


if __name__ == "__main__":
    main()
