"""Benchmarks of the surface hash.

Counterpart of ``tools/bench_surface_hash.py`` of the JAX package:

1. ``SurfaceHash.create`` at the reference's scale: a 400x400-cell grid x
   16 headings (the precompute the reference runs on startup,
   ``SurfaceHash.hpp:155-231``), first call and steady seconds;
2. the cost of hash reinjection in the streaming SLAM loop at the bench's
   SLAM shape (4,096 particles, contacts compacted to 8, the odometry from
   the full contact stream): frames/s through
   ``filter.streaming.make_slam_scan_runner(..., external_odometry=True)``
   with the hash (``period=10``) and without it.

The runners are the compiled ones, as the JAX script's are jitted: CUDA
graphs on the card (warmed up until every gate combination replays), the
eager loop on the CPU.  They update the carry's pool in place, so every
run starts from a fresh filter (outside the timed region) whose pool, one
for both runners, is refilled in place (``MapPool.refill_``).  Prints one
JSON line with the JAX script's keys; ``backend`` is ``"cuda"`` or
``"cpu"``, ``graphed`` whether the runners replayed CUDA graphs, and the
``*_compile_first_s`` keys time the first call (the kernels' build at
first use and the run).

Usage: python -m slam_eslam_tpu_torch.tools.bench_surface_hash [--cpu]
           [--particles 4096]
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import numpy as np
import torch

N_RAYS = 64


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--particles", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--grid-cells", type=int, default=400,
                    dest="grid_cells")
    ap.add_argument("--angles", type=int, default=16)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    return ap


def hash_grid(g, device):
    """The ``g x g`` grid at 0.05 m centred on the origin, over the
    localisation bench's terrain."""
    from slam_eslam_tpu_torch.bench import filter_terrain
    from slam_eslam_tpu_torch.models import sim as simlib

    return simlib.terrain_grid(filter_terrain, nx=g, ny=g, resolution=0.05,
                               origin=(-g * 0.05 / 2, -g * 0.05 / 2),
                               device=device)


def create_hash(grid_cells, angles, device):
    """``SurfaceHash.create`` on ``hash_grid``; returns ``(hash, seconds)``,
    the seconds ending in a device sync."""
    from slam_eslam_tpu_torch.config import SurfaceHashConfig
    from slam_eslam_tpu_torch.filter.surface_hash import SurfaceHash
    from slam_eslam_tpu_torch.utils import profiling

    grid = hash_grid(grid_cells, device)
    t0 = time.perf_counter()
    h = SurfaceHash.create(SurfaceHashConfig(angular_steps=angles), grid)
    profiling.sync()
    return h, time.perf_counter() - t0


def stream(steps, cfg, device):
    """The frames (contacts compacted to 8) and the odometry states from
    the full contact stream, on ``device``; and the start height."""
    from slam_eslam_tpu_torch.bench import slam_terrain
    from slam_eslam_tpu_torch.filter import streaming
    from slam_eslam_tpu_torch.models.asguard import AsguardSim
    from slam_eslam_tpu_torch.utils import tree

    sim = AsguardSim(terrain=slam_terrain)
    z0 = float(sim.position[2])
    q = np.array([1.0, 0, 0, 0], np.float32)
    meta = (np.float32(-np.pi / 2), np.float32(np.pi / N_RAYS))
    frames, full = [], []

    def cb(s):
        cs = s.contact_state()
        full.append(cs)
        frames.append([cs.compact(8), q, np.asarray(s.position, np.float32),
                       np.full((N_RAYS,), 2.0, np.float32), meta, False])

    for _ in range(steps):
        sim.step(wheel_delta=0.3, on_substep=cb)
        frames[-1][5] = True
    frames = tree.to(streaming.stack_frames([tuple(f) for f in frames]),
                     device)
    qs = torch.tensor(np.stack([q] * len(frames)), device=device)
    odos = streaming.precompute_odometry(
        20, tree.to(tree.stack(full), device), qs, cfg=cfg)
    return z0, frames, odos


def main(argv=None):
    """Run the benchmarks; prints and returns the result dict (and the
    SLAM runs' kernel launches on stderr)."""
    from slam_eslam_tpu_torch import ops
    from slam_eslam_tpu_torch.bench import slam_terrain
    from slam_eslam_tpu_torch.config import SurfaceHashConfig
    from slam_eslam_tpu_torch.filter import streaming
    from slam_eslam_tpu_torch.filter.eslam_filter import EmbodiedSlamFilter
    from slam_eslam_tpu_torch.filter.surface_hash import SurfaceHash
    from slam_eslam_tpu_torch.models import sim as simlib
    from slam_eslam_tpu_torch.tools.profile_slam import slam_config
    from slam_eslam_tpu_torch.utils import profiling
    from slam_eslam_tpu_torch.utils.device import entry_device

    args = parser().parse_args(argv)
    device = entry_device("cpu" if args.cpu else None)
    out = {"metric": "surface_hash", "backend": device.type}

    # ---- 1. create at reference scale ----
    g = args.grid_cells
    _, first = create_hash(g, args.angles, device)
    out["create_compile_first_s"] = round(first, 2)
    h, steady = create_hash(g, args.angles, device)
    out["create_steady_s"] = round(steady, 3)
    out["create_cells_x_angles"] = g * g * args.angles
    out["n_valid_candidates"] = int(h.n_valid)
    del h

    # ---- 2. in-loop reinjection cost (streaming SLAM) ----
    n = args.particles
    cfg = slam_config(n)
    # the hash the filter uses in the loop: built from a grid at the SLAM
    # scale (the shared environment grid of the drive)
    env = simlib.terrain_grid(slam_terrain, nx=96, ny=96, resolution=0.25,
                              origin=(-12.0, -12.0), device=device)
    hash_ = SurfaceHash.create(
        SurfaceHashConfig(angular_steps=args.angles, period=10), env)
    z0, frames, odos = stream(args.steps, cfg, device)
    n_frames = len(frames)
    lb = (np.eye(3), np.zeros(3))

    # both runners update one pool in place: every run refills it
    pool = []

    def fresh():
        f = EmbodiedSlamFilter(config=cfg, device=device).init(
            pose=(np.array([0.0, 0.0, z0]), 0.0), use_shared_map=False,
            num_contact_points=20, pool=pool.pop() if pool else None)
        return streaming.StreamingState.create(f.state, f.pool)

    def once(run):
        gc.collect()
        carry = fresh()
        profiling.sync()
        t0 = time.perf_counter()
        done, _ = run(carry, frames, odos)
        pool.append(done.pool)
        del carry, done
        profiling.sync()
        return time.perf_counter() - t0

    # the compiled runners: CUDA graphs on the card, the eager loop on the
    # CPU (utils.graphs.resolve); the warm-up runs until every gate
    # combination replays
    runs = {tag: streaming.make_slam_scan_runner(
        cfg, laser2body=lb, hash_=hh, external_odometry=True)
        for tag, hh in (("hash_off", None), ("hash_on", hash_))}
    before = ops.launch_counts()
    for tag, run in runs.items():
        out[f"{tag}_compile_first_s"] = round(once(run), 1)
        while run.graphs is not None and not run.graphs.settled():
            once(run)
    out["graphed"] = all(run.graphs is not None for run in runs.values())
    # the repeats in turns (off, on, on, off, ...): host-bound rates drift
    # within a call
    best = {tag: float("inf") for tag in runs}
    for i in range(args.repeats):
        for tag in (runs if i % 2 == 0 else reversed(list(runs))):
            best[tag] = min(best[tag], once(runs[tag]))
    for tag, dt in best.items():
        out[f"{tag}_fps"] = round(n_frames / dt, 1)
    out["reinjection_cost_ms_per_frame"] = round(
        (1.0 / out["hash_on_fps"] - 1.0 / out["hash_off_fps"]) * 1e3, 3)
    launched = {k: v - before[k] for k, v in ops.launch_counts().items()}
    print(f"# kernel launches: { {k: v for k, v in launched.items() if v} }",
          file=sys.stderr)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
