"""Accuracy A/B of the map pool's storage type: bfloat16 against float32.

Counterpart of ``tools/ab_pool_dtype.py`` of the JAX package.  The whole
streaming SLAM loop (per-particle copy-on-write maps, laser merges,
contact updates: the ``bench --mode slam`` shape at 256 particles) runs
over ``--runs`` seeded drives on a rolling terrain with a rock field, once
per pool type, and reports

* the xy ATE of the weighted-centroid track against the kinematic ground
  truth (mean over the last third of each drive, then over the runs), and
* the z error per frame (mean and standard deviation over runs x frames),

the reference's exp1 z-error harness (``test/testMap.cpp:358-435``) with
the map replaced by the pool under test.  By default every particle's map
starts as a copy of the environment grid (clone-from-env,
``PoseEstimator.cpp:47-62``), so the contact updates localise through the
pool from the first step.

The drives are the JAX script's: the rocks from ``default_rng(7)``, the
contact-point noise of run ``r`` from ``default_rng(1000 + r)``.  The
filter's own draws come from a torch generator seeded ``3000 + r``, where
the JAX script uses ``PRNGKey(3000 + r)``.  The ground truth is the
position of every frame; the JAX script's is the drive's last position on
every frame (it keeps the simulator's one position array, which moves in
place), so its ATE measures the distance to the end of the drive.  The
JAX script runs on the CPU unless given ``--tpu``; this one runs on the
card unless given ``--cpu``.

The runner is the compiled one, as the JAX script's is jitted: CUDA graphs
on the card (a gate combination eager at its first meeting, captured at
its second), the eager loop on the CPU; each drive refills the runner's
one pool in place (``MapPool.refill_``).

Usage: python -m slam_eslam_tpu_torch.tools.ab_pool_dtype [--runs 10
           --steps 120 --particles 256] [--cpu]
Prints one JSON line with both pool types' stats, the deltas and
``graphed`` (whether the runners replayed CUDA graphs).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

N_RAYS = 64
DTYPES = ("float32", "bfloat16")


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--particles", type=int, default=256)
    ap.add_argument("--contact-cap", type=int, default=8,
                    dest="contact_cap")
    ap.add_argument("--contact-noise", type=float, default=0.005,
                    dest="contact_noise")
    ap.add_argument("--no-seed-env", action="store_false",
                    dest="seed_env", default=True,
                    help="pure-SLAM regime (blank maps): ATE then "
                    "includes open-loop drift — only the f32-vs-bf16 "
                    "DELTA is meaningful")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    return ap


def make_terrain():
    """A rolling base and a field of 80 Gaussian rocks from
    ``default_rng(7)``: distinct local relief gives the contact model xy
    observability."""
    rng_rocks = np.random.default_rng(7)
    rocks = np.stack([
        rng_rocks.uniform(-6, 6, 80), rng_rocks.uniform(-6, 6, 80),
        rng_rocks.uniform(0.10, 0.30, 80),
        rng_rocks.uniform(0.25, 0.45, 80),
    ], axis=1)

    def terrain(x, y):
        x, y = np.asarray(x, float), np.asarray(y, float)
        base = (0.15 * np.sin(0.7 * x) + 0.12 * np.cos(0.5 * y))
        d2 = ((x[..., None] - rocks[:, 0]) ** 2
              + (y[..., None] - rocks[:, 1]) ** 2)
        r = (rocks[:, 2] * np.exp(-d2 / (2 * rocks[:, 3] ** 2))).sum(-1)
        return base + r

    return terrain


def pool_config(dtype, n):
    from slam_eslam_tpu_torch.config import Config, ContactModelConfig

    return dataclasses.replace(
        Config(), particle_count=n, min_effective=n // 2, grid_size=10.0,
        grid_resolution=0.25, map_pool_blocks=n + 64, map_chain_length=3,
        map_pool_color=False, map_pool_dtype=dtype,
        contact_model=ContactModelConfig(contact_point_radius=0.0,
                                         min_contacts=2))


def drive(terrain, steps, run, contact_noise, contact_cap):
    """Run ``run``'s drive: the frames (contacts with noise from
    ``default_rng(1000 + run)``, compacted to ``contact_cap``), the full
    contact states, the orientations ``[T, 4]`` and the true positions
    ``[T, 3]``, all on the host; and the start height."""
    from slam_eslam_tpu_torch.filter import streaming
    from slam_eslam_tpu_torch.models.asguard import AsguardSim
    from slam_eslam_tpu_torch.utils import tree

    rng = np.random.default_rng(1000 + run)
    sim = AsguardSim(terrain=terrain)
    z0 = float(sim.position[2])
    q = np.array([1.0, 0, 0, 0], np.float32)
    meta = (np.float32(-np.pi / 2), np.float32(np.pi / N_RAYS))
    frames, full, truth = [], [], []

    def cb(s):
        cs = s.contact_state()
        noise = rng.normal(0.0, contact_noise, tuple(cs.position.shape))
        cs = dataclasses.replace(cs, position=cs.position + torch.from_numpy(
            noise.astype(np.float32)))
        full.append(cs)
        frames.append([cs.compact(contact_cap), q,
                       np.asarray(s.position, np.float32),
                       np.full((N_RAYS,), 2.0, np.float32), meta, False])
        # a copy: the simulator moves its position array in place (the
        # JAX script appends that one array every frame, so its ground
        # truth is the drive's last position throughout)
        truth.append(np.array(s.position, np.float64))

    for _ in range(steps):
        sim.step(wheel_delta=0.3, on_substep=cb)
        frames[-1][5] = True
    return dict(z0=z0, frames=streaming.stack_frames([tuple(f)
                                                      for f in frames]),
                full=tree.stack(full),
                qs=torch.from_numpy(np.stack([q] * len(frames))),
                truth=np.stack(truth))


def run_dtype(dtype, args, device, draws=None, detail=None):
    """``--runs`` drives on a pool of ``dtype``; returns the stats.
    ``draws``: None (a generator seeded ``3000 + r`` per run) or per run
    ``((normal_xy [N, 2], normal_yaw [N]), [filter.step.StepDraws per
    frame])``.  ``detail`` (a list) receives per run the drive, the
    odometry states and the centroids."""
    from slam_eslam_tpu_torch.filter import streaming
    from slam_eslam_tpu_torch.filter.eslam_filter import EmbodiedSlamFilter
    from slam_eslam_tpu_torch.models import sim as simlib
    from slam_eslam_tpu_torch.utils import tree

    n = args.particles
    cfg = pool_config(dtype, n)
    terrain = make_terrain()
    # the compiled runner: CUDA graphs on the card, the eager loop on the
    # CPU (utils.graphs.resolve); it updates its carry's pool in place,
    # and every drive refills that one pool
    run = streaming.make_slam_scan_runner(cfg, laser2body=(np.eye(3),
                                                           np.zeros(3)),
                                          external_odometry=True)
    pool = None
    env = None
    if args.seed_env:
        env = simlib.terrain_grid(terrain, nx=96, ny=96, resolution=0.25,
                                  origin=(-12.0, -12.0), device=device)

    ates, zerrs = [], []
    for r in range(args.runs):
        d = drive(terrain, args.steps, r, args.contact_noise,
                  args.contact_cap)
        frames = tree.to(d["frames"], device)
        qs = d["qs"].to(device)
        # odometry from the full contact stream: compaction breaks its
        # slot correspondence across frames
        odos = streaming.precompute_odometry(
            d["full"].contact.shape[-1], tree.to(d["full"], device), qs,
            cfg=cfg)
        gen = torch.Generator(device).manual_seed(3000 + r)
        if draws is None:
            normals = (torch.randn((n, 2), generator=gen, device=device),
                       torch.randn((n,), generator=gen, device=device))
            frame_draws = None
        else:
            normals, frame_draws = tree.to(draws[r][0], device), [
                tree.to(fd, device) for fd in draws[r][1]]
        f = EmbodiedSlamFilter(config=cfg, device=device).init(
            pose=(np.array([0.0, 0.0, d["z0"]]), 0.0), use_shared_map=False,
            shared_grid=env, num_contact_points=20, normal_xy=normals[0],
            normal_yaw=normals[1], pool=pool)
        state = dataclasses.replace(f.state, generator=gen)
        carry0 = streaming.StreamingState.create(state, f.pool)
        del f
        done, aux = run(carry0, frames, odos, frame_draws)
        pool = done.pool
        del carry0, done
        cents = aux["centroid"].cpu().numpy().astype(np.float64)
        gt = d["truth"]
        tail = slice(len(gt) * 2 // 3, None)
        ates.append(float(np.mean(np.linalg.norm(
            cents[tail, :2] - gt[tail, :2], axis=1))))
        zerrs.append(cents[tail, 2] - gt[tail, 2])
        if detail is not None:
            detail.append(dict(d, odos=odos, centroids=cents,
                               updated=aux["updated"]))
    zerr = np.concatenate(zerrs)
    return {
        "ate_mean": float(np.mean(ates)),
        "ate_std": float(np.std(ates)),
        "z_err_mean": float(np.mean(zerr)),
        "z_err_std": float(np.std(zerr)),
    }


def main(argv=None):
    """Run the A/B; prints and returns the result dict (each pool type's
    stats and kernel launches also on stderr)."""
    from slam_eslam_tpu_torch import ops
    from slam_eslam_tpu_torch.utils import graphs
    from slam_eslam_tpu_torch.utils.device import card_line, entry_device

    args = parser().parse_args(argv)
    device = entry_device("cpu" if args.cpu else None)
    print(f"# device: {device}" + (f" ({card_line(device)})"
                                   if device.type == "cuda" else ""),
          file=sys.stderr, flush=True)
    out = {}
    for dtype in DTYPES:
        before = ops.launch_counts()
        t0 = time.time()
        out[dtype] = run_dtype(dtype, args, device)
        out[dtype]["wall_s"] = round(time.time() - t0, 1)
        launched = {k: v - before[k] for k, v in ops.launch_counts().items()
                    if v > before[k]}
        print(f"# {dtype}: {out[dtype]}, kernel launches {launched}",
              file=sys.stderr, flush=True)
    out["delta"] = {
        k: out["bfloat16"][k] - out["float32"][k]
        for k in ("ate_mean", "z_err_mean", "z_err_std")
    }
    out["config"] = {
        "runs": args.runs, "steps": args.steps,
        "particles": args.particles,
    }
    # the runners replayed CUDA graphs (on the card) or ran eagerly
    out["graphed"] = graphs.supported(device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
