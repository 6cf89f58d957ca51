"""Benchmark of the PyTorch/CUDA port: filter step throughput and the
full SLAM loop on one GPU.

    python -m slam_eslam_tpu_torch.bench [--mode filter|slam] [...]

Counterpart of the JAX package's root ``bench.py``, with its flags and its
output keys.  ``--mode filter`` measures the per-frame main path of the
reference pipeline (``EmbodiedSlamFilter.cpp:353-369``: odometry +
propagate + contact weighting + resample) at benchmark scale (default
100k particles against the reference's 250, ``Configuration.hpp:87``)
over a trajectory, and the two kernel rooflines of
``utils.kernel_eff``.  ``--mode slam`` measures the streaming SLAM loop
with per-particle maps (``filter.streaming``).

Prints ONE JSON line on stdout and a ``#`` summary on stderr.
``vs_baseline`` normalises against the target operating point: 100k
particles at real-time rate (10 Hz) = 1e6 particle-updates/s, and 100
SLAM frames/s.  Timing is the host clock around a run that ends in
``torch.cuda.synchronize()``, best of ``--repeats`` after one warm-up
run; on a GPU any host synchronisation inside a timed run raises.

The run is on the CUDA device unless ``--device cpu`` is given (the
plain versions of the kernels, for tests; the roofline keys are then
null, a CPU time would mean nothing).  Without a CUDA device the default
raises.  ``--lookup``, ``--window``, ``--chain-kernel`` and
``--merge-kernel`` select among code paths that only the JAX package
has; the port has one lookup and one kernel each, accepts them and
echoes the kernel choices.  ``--donate`` chains the carry through the
repeats; without it every repeat starts from a fresh filter, and either
way the runner updates the carry's pool in place.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from slam_eslam_tpu_torch.config import Config, ContactModelConfig
from slam_eslam_tpu_torch.utils.device import entry_device

# reference-default grid scale of the filter mode: 20 m at 0.05 m
# resolution (Configuration.hpp:101-103)
FILTER_GRID = dict(nx=400, ny=400, resolution=0.05, origin=(-10.0, -10.0))
SLAM_RAYS = 64
FULL_CONTACTS = 20


def filter_terrain(x, y):
    return 0.25 * np.sin(1.3 * np.asarray(x)) + 0.2 * np.cos(
        0.9 * np.asarray(y))


def slam_terrain(x, y):
    return 0.15 * np.sin(0.7 * np.asarray(x)) + 0.12 * np.cos(
        0.5 * np.asarray(y))


def parser():
    ap = argparse.ArgumentParser(
        prog="python -m slam_eslam_tpu_torch.bench",
        description="Benchmark the PyTorch/CUDA port on one GPU.")
    ap.add_argument(
        "--particles", type=int, default=None,
        help="particle count (default: 100000 for --mode filter, "
        "1024 for --mode slam: per-particle maps scale memory with "
        "particles x map area)")
    ap.add_argument(
        "--steps", type=int, default=150,
        help="filter mode: trajectory steps per run; slam mode: scans, "
        "each 10 contact frames")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument(
        "--lookup", choices=["gather", "window", "auto"], default="auto",
        help="map-lookup path of the JAX package; accepted and ignored "
        "(the port has one full-grid lookup)")
    ap.add_argument(
        "--window", type=int, default=0,
        help="window size of the JAX package's windowed lookup; accepted "
        "and ignored")
    ap.add_argument(
        "--contact-cap", type=int, default=8, dest="contact_cap",
        help="compact contact states to this many candidates "
        "(semantics-preserving when >= active count; 0 disables)")
    ap.add_argument(
        "--fold", choices=["on", "off"], default="on",
        help="(filter mode) contact fold: likelihood ratio + group "
        "reductions inside the lookup kernel "
        "(ContactModelConfig.fold_lookup); off = the unfolded lookup")
    ap.add_argument(
        "--mode", choices=["filter", "slam"], default="filter",
        help="filter: localisation step throughput (headline); "
        "slam: the streaming SLAM loop with per-particle maps and laser "
        "merges")
    ap.add_argument(
        "--grid-size", type=float, default=10.0, dest="grid_size",
        help="(slam mode) per-particle grid extent in metres")
    ap.add_argument(
        "--grid-res", type=float, default=0.25, dest="grid_res",
        help="(slam mode) per-particle grid resolution in metres")
    ap.add_argument(
        "--donate", action="store_true",
        help="(slam mode) chain the carry through the repeats instead of "
        "rebuilding the filter for each (the runner always updates the "
        "pool in place)")
    ap.add_argument(
        "--pool-dtype", choices=["float32", "bfloat16"],
        default="float32", dest="pool_dtype",
        help="(slam mode) storage dtype of the map pool's float patch "
        "fields; bfloat16 = 10 B/patch-slot instead of 16")
    ap.add_argument(
        "--chain-kernel", choices=["auto", "pallas", "xla"],
        default="auto", dest="chain_kernel",
        help="(slam mode) chain-lookup path of the JAX package; accepted "
        "and echoed (the port has one chain-lookup kernel)")
    ap.add_argument(
        "--merge-kernel", choices=["auto", "pallas", "xla"],
        default="auto", dest="merge_kernel",
        help="(slam mode) scan-merge path of the JAX package; accepted "
        "and echoed (the port has one merge kernel)")
    ap.add_argument(
        "--visual", action="store_true",
        help="(slam mode) enable the scan-match visual update "
        "(use_visual_update; w *= match^0.1 per particle)")
    ap.add_argument(
        "--chain-len", type=int, default=3, dest="chain_len",
        help="(slam mode) per-particle map chain length; steady state "
        "pins ~particles*chain_len pool blocks")
    ap.add_argument(
        "--pool-blocks", type=int, default=0, dest="pool_blocks",
        help="(slam mode) map-pool block capacity (0 = 4x particles: a "
        "moving robot rolls blocks over and pins ~chain_len live blocks "
        "per particle plus copy-on-write copies)")
    ap.add_argument(
        "--min-effective", type=int, default=-1, dest="min_effective",
        help="ESS resampling threshold (default: particles/5; 0 "
        "disables resampling, for stage attribution)")
    ap.add_argument(
        "--ablate", choices=["none", "noupdate", "nolookup"],
        default="none",
        help="stage ablation for marginal-cost attribution: "
        "'noupdate' = project+centroid only; 'nolookup' = full update "
        "math with a constant fake lookup (no map gather)")
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA device; 'cpu' runs the "
        "kernels' plain versions)")
    return ap


def card_line(device):
    """The card's name and power limit as ``nvidia-smi`` gives them; None
    for a run on the CPU."""
    if device.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[device.index or 0]


@contextlib.contextmanager
def no_host_sync(device):
    """On a GPU, any host synchronisation inside the body raises."""
    if device.type != "cuda":
        yield
        return
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def timed_run(fn, device, forbid_sync=True):
    """Host seconds of ``fn()`` ending in a device sync, host syncs inside
    forbidden (not in a warm-up run, which may build a kernel); returns
    ``(seconds, fn's result)``."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    with (no_host_sync(device) if forbid_sync else contextlib.nullcontext()):
        out = fn()
    sync()
    return time.perf_counter() - t0, out


# ------------------------------------------------------------ filter mode

def filter_config(args):
    n = args.particles
    return dataclasses.replace(
        Config(),
        particle_count=n,
        min_effective=(n // 5 if args.min_effective < 0
                       else args.min_effective),
        contact_model=ContactModelConfig(
            contact_point_radius=0.0, fold_lookup=(args.fold == "on")),
        lookup_mode=args.lookup,
        **({"lookup_window": args.window} if args.window else {}),
    )


def filter_trajectory(steps, contact_cap):
    """The input trajectory, on the host: stacked contact states (compacted
    to ``contact_cap``), orientations ``[T, 4]``, the true xy ``[T, 2]``
    and the contact rig's xy reach."""
    from slam_eslam_tpu_torch.models import sim
    from slam_eslam_tpu_torch.utils import geometry, tree

    trajectory = sim.TrajectorySim(filter_terrain, speed=0.05)
    css, qs, truth = [], [], []
    for _ in range(steps):
        (pos, yaw), _ = trajectory.step()
        cs = trajectory.contact_state(noise=0.005)
        if contact_cap:
            cs = cs.compact(contact_cap)
        css.append(cs)
        qs.append(geometry.quat_from_yaw(
            torch.tensor(yaw, dtype=torch.float32)))
        truth.append(pos[:2])
    extent = float(np.linalg.norm(css[-1].position.numpy()[:, :2],
                                  axis=1).max())
    return tree.stack(css), torch.stack(qs), np.array(truth), extent


def filter_particles(n):
    """The start cloud, on the host (seeded)."""
    from slam_eslam_tpu_torch.filter import pose_estimator as pe

    return pe.init_gaussian(
        n, (0.0, 0.0), 0.0, (0.3, 0.3), 0.05, 0.2, 0.3,
        generator=torch.Generator().manual_seed(0))


def filter_state(cfg, particles, contact_cap, device):
    from slam_eslam_tpu_torch.filter import pose_estimator as pe
    from slam_eslam_tpu_torch.utils import tree

    state = pe.PoseEstimatorState.create(cfg, contact_cap or FULL_CONTACTS,
                                         device=device)
    return dataclasses.replace(state, particles=tree.to(particles, device))


def constant_lookup(map_id, points):
    """The ``nolookup`` ablation's map: every query finds a patch at
    height 0 with stdev 0.1, so the update math runs and no gather does."""
    del map_id
    if isinstance(points, tuple):
        ref = points[0]
        shape = ref.shape
    else:
        ref = points
        shape = points.shape[:-1]
    found = torch.ones(shape, dtype=torch.bool, device=ref.device)
    mean = torch.zeros(shape, dtype=torch.float32, device=ref.device)
    stdev = torch.full(shape, 0.1, dtype=torch.float32, device=ref.device)
    if isinstance(points, tuple):
        return found, mean, stdev
    return found, mean, stdev, mean.new_zeros(shape + (3,))


constant_lookup.batched = True
constant_lookup.soa = True


def make_filter_runner(cfg, lookup, ablate="none"):
    """``run(state, contact_states, orientations, draws=None) ->
    (state, centroids [T, 3])``: ``step.make_scan_runner`` (a measurement
    update on every step), with the map lookup replaced by a constant
    (``nolookup``) or the update left out (``noupdate``: odometry,
    propagation and centroid only)."""
    from slam_eslam_tpu_torch.filter import pose_estimator as pe
    from slam_eslam_tpu_torch.filter import step as steplib
    from slam_eslam_tpu_torch.models import odometry as odom
    from slam_eslam_tpu_torch.utils import tree

    if ablate == "nolookup":
        return steplib.make_scan_runner(cfg, constant_lookup)
    if ablate != "noupdate":
        return steplib.make_scan_runner(cfg, lookup)
    odo_cfg = steplib.cfg_odo(cfg)

    def run(state, contact_states, orientations, draws=None):
        cents = []
        for t in range(orientations.shape[0]):
            q = orientations[t]
            state = dataclasses.replace(state, odometry=odom.update(
                state.odometry, tree.index(contact_states, t), q, odo_cfg))
            state = pe.project(state, q, cfg,
                               None if draws is None else draws[t].project)
            c_pos, _ = pe.centroid(state.particles, q,
                                   wrap_safe=cfg.wrap_safe_centroid)
            cents.append(c_pos)
        return state, torch.stack(cents)

    return run


def bench_filter(args, detail=None):
    """Filter mode; returns the result dict.  ``detail`` (a dict) also
    receives the last run's final state, centroids, the true xy, the
    seconds of every repeat, the kernel launches of the warm-up and the
    repeats together (without the rooflines' own) and the two roofline
    dicts."""
    from slam_eslam_tpu_torch import ops
    from slam_eslam_tpu_torch.mapping import mls_grid
    from slam_eslam_tpu_torch.mapping.lookup import make_lookup
    from slam_eslam_tpu_torch.models import sim
    from slam_eslam_tpu_torch.utils import kernel_eff, profiling, tree

    device = entry_device(args.device)
    n = args.particles
    cfg = filter_config(args)
    grid = tree.to(sim.terrain_grid(filter_terrain, **FILTER_GRID), device)
    lookup = make_lookup(cfg, grid)
    css, qs, truth, contact_extent = filter_trajectory(args.steps,
                                                       args.contact_cap)
    css_d, qs_d = tree.to(css, device), qs.to(device)
    particles = filter_particles(n)
    run = make_filter_runner(cfg, lookup, args.ablate)
    fresh = lambda: filter_state(cfg, particles, args.contact_cap, device)

    launched = ops.launch_counts()
    warm_s, _ = timed_run(lambda: run(fresh(), css_d, qs_d), device,
                          forbid_sync=False)
    seconds = []
    for _ in range(args.repeats):
        state0 = fresh()
        dt, (out_state, cents) = timed_run(
            lambda: run(state0, css_d, qs_d), device)
        seconds.append(dt)
    best = min(seconds)
    launched = {k: v - launched[k] for k, v in ops.launch_counts().items()}

    pu_per_s = n * args.steps / best
    # speed-of-light accounting: the share of the min-time roofline (the
    # larger of bytes over bandwidth and flops over peak for the abstract
    # weighting step) that the measured step achieves
    stats = profiling.weighting_step_stats(
        n, args.contact_cap or FULL_CONTACTS, cfg.mls_patches_per_cell)
    sol = profiling.speed_of_light_fraction(best / args.steps, stats)

    # each kernel against its own bound; the port's lookups read the whole
    # grid, so the "tier" is the grid
    tier = kernel_eff.steady_state_tier(
        tree.to(out_state.particles, "cpu"), contact_extent,
        grid.resolution, (), (grid.nx, grid.ny))
    fold = kernel_eff.fold_roofline(mls_grid.PackedLookup.from_grid(grid), n)
    merge = kernel_eff.merge_floor_fraction(device=device)
    rounded = lambda d, key, digits: (round(d[key], digits) if d else None)
    result = {
        "metric": "particle_updates_per_sec_per_chip",
        "value": round(pu_per_s, 1),
        "unit": "particle-updates/s",
        "vs_baseline": round(pu_per_s / 1.0e6, 3),
        "sol_fraction": round(sol, 4),
        "ns_per_query": round(
            best / args.steps / stats["queries"] * 1e9, 3),
        "fold_tier": list(tier),
        "fold_mfu": None,   # the fold kernel uses no matrix unit
        "fold_kernel_us": rounded(fold, "us", 1),
        "fold_roofline_fraction": rounded(fold, "fraction", 4),
        "merge_dma_floor_fraction": rounded(merge, "floor_fraction", 3),
        "merge_us_per_block": rounded(merge, "merge_us_per_block", 4),
        "merge_unsorted_twin_us_per_block": rounded(
            merge, "unsorted_us_per_block", 4),
        "merge_whole_us_per_block": rounded(merge, "whole_us_per_block", 4),
        "copy_gbps": rounded(merge, "copy_gbps", 1),
        "card": card_line(device),
    }
    print(json.dumps(result))
    print(f"# {n} particles x {args.steps} steps: best {best:.3f}s "
          f"(first run {warm_s:.1f}s), device={device_name(device)}",
          file=sys.stderr)
    if detail is not None:
        detail.update(state=out_state, centroids=cents, truth=truth,
                      seconds=seconds, run_launches=launched, fold=fold,
                      merge=merge, cfg=cfg)
    return result


def device_name(device):
    if device.type == "cuda":
        return f"{device} ({torch.cuda.get_device_name(device)})"
    return str(device)


# -------------------------------------------------------------- slam mode

def slam_config(args):
    n = args.particles
    return dataclasses.replace(
        Config(),
        particle_count=n,
        min_effective=n // 2,
        grid_size=args.grid_size,
        grid_resolution=args.grid_res,
        map_pool_blocks=args.pool_blocks or 4 * n,
        map_chain_length=args.chain_len,
        map_pool_color=False,  # perf config: no slip/texture fusion
        map_pool_dtype=args.pool_dtype,
        chain_kernel=args.chain_kernel,
        merge_kernel=args.merge_kernel,
        use_visual_update=args.visual,
        contact_model=ContactModelConfig(
            contact_point_radius=0.0, min_contacts=2),
    )


def slam_trajectory(steps, contact_cap):
    """The frame stream, on the host: the Asguard rolling 0.3 rad per step
    over a sine terrain, 10 contact frames per step, one 64-ray scan at
    2 m on each step's last frame; the measurement update reads contacts
    compacted to ``contact_cap``, the odometry the full 20 (compaction
    breaks its across-frame slot correspondence).  Returns ``(z0,
    SlamFrames, stacked full contact states, orientations [T, 4])``."""
    from slam_eslam_tpu_torch.filter import streaming
    from slam_eslam_tpu_torch.models.asguard import AsguardSim
    from slam_eslam_tpu_torch.utils import tree

    asg = AsguardSim(terrain=slam_terrain)
    z0 = float(asg.position[2])
    q = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    meta = (np.float32(-np.pi / 2), np.float32(np.pi / SLAM_RAYS))
    frames, full = [], []

    def on_substep(s):
        cs = s.contact_state()
        full.append(cs)
        if contact_cap:
            cs = cs.compact(contact_cap)
        frames.append([cs, q, s.position.astype(np.float32),
                       np.full(SLAM_RAYS, 2.0, np.float32), meta, False])

    for _ in range(steps):
        asg.step(wheel_delta=0.3, on_substep=on_substep)
        frames[-1][5] = True
    qs = torch.tensor(np.stack([f[1] for f in frames]))
    return z0, streaming.stack_frames(frames), tree.stack(full), qs


def slam_carry(cfg, z0, device, normals=None):
    """A fresh filter with per-particle maps, as the SLAM loop's carry;
    ``normals = (xy [N, 2], yaw [N])`` fixes the start cloud."""
    from slam_eslam_tpu_torch.filter import streaming
    from slam_eslam_tpu_torch.filter.eslam_filter import EmbodiedSlamFilter

    f = EmbodiedSlamFilter(config=cfg, device=device).init(
        pose=(np.array([0.0, 0.0, z0]), 0.0), use_shared_map=False,
        num_contact_points=FULL_CONTACTS,
        normal_xy=None if normals is None else normals[0].to(device),
        normal_yaw=None if normals is None else normals[1].to(device))
    return streaming.StreamingState.create(f.state, f.pool)


def make_slam_runner(cfg):
    from slam_eslam_tpu_torch.filter import streaming

    return streaming.make_slam_scan_runner(
        cfg, laser2body=(np.eye(3), np.zeros(3)), external_odometry=True)


def bench_slam(args, detail=None):
    """SLAM mode: contact updates + motion-gated per-particle scan merges,
    the whole loop on the device; returns the result dict.  ``detail`` (a
    dict) also receives the last run's carry and aux, the frame count,
    the seconds of every repeat and the patch and failure counts."""
    from slam_eslam_tpu_torch.filter import streaming
    from slam_eslam_tpu_torch.utils import tree

    device = entry_device(args.device)
    n = args.particles
    cfg = slam_config(args)
    steps = args.steps if args.steps != 10 else 20
    z0, frames, full, qs = slam_trajectory(steps, args.contact_cap)
    n_frames = len(frames)
    frames_d = tree.to(frames, device)
    odos = streaming.precompute_odometry(
        FULL_CONTACTS, tree.to(full, device), qs.to(device), cfg=cfg)
    run = make_slam_runner(cfg)

    carry = slam_carry(cfg, z0, device)
    box = [carry]
    del carry

    def once():
        # the runner consumes the carry's pool: hold no second reference
        out = run(box.pop(), frames_d, odos)
        box.append(out[0])
        return out[1]

    warm_s, aux = timed_run(once, device, forbid_sync=False)
    seconds = []
    for _ in range(args.repeats):
        if not args.donate:
            box.clear()
            box.append(slam_carry(cfg, z0, device))
        dt, aux = timed_run(once, device)
        seconds.append(dt)
    dt = min(seconds)
    carry = box.pop()

    result = {
        "metric": "slam_frames_per_sec",
        "value": round(n_frames / dt, 2),
        "unit": f"frames/s @ {n} particles, per-particle maps",
        "vs_baseline": round(n_frames / dt / 100.0, 3),
        "chain_kernel": args.chain_kernel,
        "merge_kernel": args.merge_kernel,
        "pool_dtype": args.pool_dtype,
        "card": card_line(device),
    }
    print(json.dumps(result))
    patches = int(carry.pool.count_valid())
    failed = int(carry.alloc_failed)
    print(f"# {n_frames} contact frames ({steps} scan frames, "
          f"{int(aux['mapped'].sum())} merges gated in, "
          f"{int(aux['updated'].sum())} measurement updates) "
          f"in {dt:.3f}s (first run {warm_s:.1f}s), "
          f"map patches={patches}, alloc_failed={failed}, "
          f"device={device_name(device)}", file=sys.stderr)
    if detail is not None:
        detail.update(carry=carry, aux=aux, frames=n_frames,
                      seconds=seconds, patches=patches, failed=failed,
                      cfg=cfg)
    return result


def main(argv=None, detail=None):
    args = parser().parse_args(argv)
    if args.particles is None:
        args.particles = 1024 if args.mode == "slam" else 100_000
    if args.mode == "slam":
        return bench_slam(args, detail)
    return bench_filter(args, detail)


if __name__ == "__main__":
    main()
