#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py [--profile DIR]

Phases (any failure raises and exits non-zero):

1. report the card (torch and ``nvidia-smi`` name and power limit);
2. build every kernel from ``slam_eslam_tpu_torch/csrc``, one ``nvcc``
   per source, all started together;
3. check the contact fold (K1) against its plain PyTorch version on the
   card, at the localisation benchmark shape (N = 100,000 particles,
   C = 8 contacts, a 400x400x4 grid), at a ragged N and on a spread
   cloud with out-of-grid queries, and time both with CUDA events;
4. drive the localisation path: the benchmark trajectory (100k
   particles, 20 m x 20 m map at 0.05 m, contacts compacted to 8, 150
   steps) through ``filter.step.make_scan_runner`` on the card; count K1
   launches, check the centroids, and hold the first 20 steps against
   the CPU port fed the same random draws;
5. check the chain lookup (K2) and the block merge (K3) against their
   plain versions at the SLAM benchmark shapes (N = 4,096 particles,
   C = 8 contacts, chains of 3, P = 64 scan points, a 16,384-block pool
   of 40x40x4 cells half full of patches, with empty chain entries) and
   at a ragged N, and time both;
6. drive the SLAM path: 4,096 particles with per-particle maps over 200
   frames (20 laser scans) through ``filter.streaming.
   make_slam_scan_runner`` on the card with host syncs forbidden; count
   K2 and K3 launches against the measurement and mapping gates, check
   that centroids, weights and the pool are finite, and hold the first
   60 frames against the CPU port fed the same random draws.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  ``--profile DIR`` also writes
``torch.profiler`` tables and traces of 10 localisation steps and of 50
SLAM frames to DIR.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

N_BENCH = 100_000
N_RAGGED = 100_003
STEPS = 150
CHECK_STEPS = 20
CONTACT_CAP = 8
GRID = dict(nx=400, ny=400, resolution=0.05, origin=(-10.0, -10.0))
KERNEL_RTOL = 1e-4
KERNEL_ATOL_REL = 1e-5   # times max |row| of the plain version
CENTROID_ATOL = 1e-3     # m, GPU vs CPU port on identical draws

# the SLAM benchmark (bench.py --mode slam): 4,096 particles, 10 m grids
# at 0.25 m, chains of 3, a pool of 4N blocks, 20 scans x 10 substeps
SLAM_N = 4096
SLAM_N_RAGGED = 4093
SLAM_POOL = dict(nx=40, ny=40, k=4, resolution=0.25, chain_len=3)
SLAM_C = 8
SLAM_RAYS = 64
SLAM_STEPS, SLAM_SUBSTEPS = 20, 10
SLAM_CHECK_FRAMES = 60
SLAM_PROFILE_FRAMES = 50
# K3 against its plain version: bitwise on cells one point hits; the
# plain version sums multi-point cells with atomics on the card, so
# those agree to float32 rounding: rtol 1e-6 (mean, stdev), atol 1e-6 m
# (height, a difference of two heights)
MERGE_RTOL = 1e-6
MERGE_HEIGHT_ATOL = 1e-6
# GPU vs CPU port: patch counts after 60 frames.  Float32 rounding of
# transcendental functions differs between the two devices, which can
# move a point across a cell edge or a resampling ancestor by one; each
# changes a count by a few patches
PATCH_COUNT_RTOL = 1e-3
KERNELS = ("contact_fold", "chain_lookup", "block_merge")


def slam_terrain(x, y):
    return 0.15 * np.sin(0.7 * np.asarray(x)) + 0.12 * np.cos(
        0.5 * np.asarray(y))


def bench_terrain(x, y):
    return 0.25 * np.sin(1.3 * np.asarray(x)) + 0.2 * np.cos(
        0.9 * np.asarray(y))


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters):
    """Mean milliseconds per call of ``fn`` over ``iters`` calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- phase 3

def fold_inputs(n, spread, dev, seed):
    """Seeded contact-fold operands: a 400x400 grid with 4 slots per
    cell (some empty), [8, N] queries around a particle cloud, two
    grouped pairs, one inactive member and ungrouped points."""
    from slam_eslam_tpu_torch.core.state import BodyContactState
    from slam_eslam_tpu_torch.mapping.mls_grid import PackedLookup

    rng = np.random.default_rng(seed)
    nx, ny, res = GRID["nx"], GRID["ny"], GRID["resolution"]
    ox, oy = GRID["origin"]
    cx = (np.arange(nx) + 0.5) * res + ox
    cy = (np.arange(ny) + 0.5) * res + oy
    base = bench_terrain(cx[:, None], cy[None, :])
    means = base[..., None] + np.concatenate(
        [np.zeros((nx, ny, 1)), rng.uniform(-2.5, 2.5, (nx, ny, 3))], -1)
    stdev = rng.uniform(0.01, 0.1, (nx, ny, 4))
    empty = rng.random((nx, ny, 4)) < 0.3
    data = np.concatenate([np.where(empty, 0.0, means),
                           np.where(empty, -1.0, stdev)], -1)
    packed = PackedLookup(
        data=torch.tensor(data, dtype=torch.float32, device=dev),
        origin=torch.tensor(GRID["origin"], dtype=torch.float32, device=dev),
        resolution=res,
    )

    c = 8
    if spread:
        pxy = rng.uniform(-15.0, 15.0, (n, 2))      # beyond the 20 m grid
    else:
        pxy = rng.normal(0.0, 0.5, (n, 2))
    offs = rng.uniform(-0.4, 0.4, (c, 2))
    qx = offs[:, 0:1] + pxy[None, :, 0]
    qy = offs[:, 1:2] + pxy[None, :, 1]
    qz = bench_terrain(qx, qy) + rng.normal(0.0, 0.05, (c, n))
    far = rng.random((c, n)) < 0.05
    qz = np.where(far, qz + rng.uniform(-4.0, 4.0, (c, n)), qz)
    mv = rng.uniform(0.01, 0.2, (1, n))
    cs = BodyContactState.create(
        np.zeros((c, 3)), group_id=[0, 0, 1, 1, -1, 2, 2, -1])
    seg, s = cs.segments()
    onehot = (seg[:, None] == torch.arange(s)[None, :]).float()
    act = np.array([1, 1, 1, 0, 1, 1, 1, 1], np.float32)[:, None]
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    return (packed, (t(qx), t(qy), t(qz)), t(act), t(mv), onehot.to(dev))


def check_contact_fold(dev, cfg):
    from slam_eslam_tpu_torch.ops import contact_fold as cf

    correction = cfg.contact_model.contact_likelihood_correction
    z_window = cfg.mls_z_window
    max_err, timing = 0.0, None
    for name, n, spread in (("bench", N_BENCH, False),
                            ("ragged", N_RAGGED, False),
                            ("spread", N_BENCH, True)):
        packed, q, act, mv, onehot = fold_inputs(n, spread, dev, seed=n)
        kw = dict(onehot=onehot, correction=correction, z_window=z_window)
        out_k = cf.contact_fold(packed, q, act, mv, **kw)
        out_p = cf.contact_fold_reference(packed, q, act, mv, **kw)
        torch.cuda.synchronize()
        if out_k.shape != (8, n) or not torch.isfinite(out_k).all():
            raise RuntimeError(f"contact_fold[{name}]: bad output")
        for r in range(4):
            a, b = out_k[r], out_p[r]
            tol = KERNEL_RTOL * b.abs() + KERNEL_ATOL_REL * b.abs().max()
            bad = int(((a - b).abs() > tol).sum())
            if bad:
                raise RuntimeError(f"contact_fold[{name}] row {r}: {bad} "
                                   f"values outside tolerance")
        if not torch.equal(out_k[4], out_p[4]) or out_k[5:].any():
            raise RuntimeError(f"contact_fold[{name}]: n_contacts rows "
                               f"differ")
        err = float((out_k[:5] - out_p[:5]).abs().max())
        max_err = max(max_err, err)
        print(f"contact_fold[{name}] N={n}: max_abs_err={err:.3e} "
              f"mean n_contacts={float(out_k[4].mean()):.3f}")
        if name == "bench":
            kern = lambda: cf.contact_fold(packed, q, act, mv, **kw)
            plain = lambda: cf.contact_fold_reference(packed, q, act, mv,
                                                      **kw)
            for f in (kern, plain):
                cuda_ms(f, 3)
            # alternate plain, kernel, kernel, plain
            p1, k1, k2, p2 = (cuda_ms(plain, 20), cuda_ms(kern, 50),
                              cuda_ms(kern, 50), cuda_ms(plain, 20))
            timing = ((k1 + k2) / 2, (p1 + p2) / 2)
            print(f"contact_fold[bench] kernel {timing[0]:.4f} ms "
                  f"({k1:.4f}, {k2:.4f}), plain {timing[1]:.4f} ms "
                  f"({p1:.4f}, {p2:.4f})")
    return max_err, timing


# ---------------------------------------------------------------- phase 4

def bench_setup(n, steps):
    """The benchmark configuration, map, trajectory and initial state
    (``bench.py`` filter mode, rebuilt with the port's NumPy sim)."""
    from slam_eslam_tpu_torch import Config, ContactModelConfig
    from slam_eslam_tpu_torch.filter import pose_estimator as pe
    from slam_eslam_tpu_torch.models import sim
    from slam_eslam_tpu_torch.utils import geometry, tree

    cfg = dataclasses.replace(
        Config(), particle_count=n, min_effective=n // 5,
        contact_model=ContactModelConfig(contact_point_radius=0.0),
        lookup_mode="auto",
    )
    grid = sim.terrain_grid(bench_terrain, **GRID)
    trajectory = sim.TrajectorySim(bench_terrain, speed=0.05)
    css, qs, truth = [], [], []
    for _ in range(steps):
        (pos, yaw), _ = trajectory.step()
        css.append(trajectory.contact_state(noise=0.005).compact(
            CONTACT_CAP))
        qs.append(geometry.quat_from_yaw(torch.tensor(yaw,
                                                      dtype=torch.float32)))
        truth.append(pos[:2])
    particles = pe.init_gaussian(
        n, (0.0, 0.0), 0.0, (0.3, 0.3), 0.05, 0.2, 0.3,
        generator=torch.Generator().manual_seed(0),
    )
    return (cfg, grid, tree.stack(css), torch.stack(qs), np.array(truth),
            particles)


def fresh_state(cfg, particles, dev):
    from slam_eslam_tpu_torch.filter import pose_estimator as pe
    from slam_eslam_tpu_torch.utils import tree

    state = pe.PoseEstimatorState.create(cfg, CONTACT_CAP, device=dev)
    return dataclasses.replace(state, particles=tree.to(particles, dev))


def main_path(dev, profile):
    from slam_eslam_tpu_torch.filter import pose_estimator as pe
    from slam_eslam_tpu_torch.filter import step as steplib
    from slam_eslam_tpu_torch.mapping.lookup import make_lookup
    from slam_eslam_tpu_torch.ops import contact_fold as cf
    from slam_eslam_tpu_torch.utils import tree

    cfg, grid, css, qs, truth, particles = bench_setup(N_BENCH, STEPS)
    run = steplib.make_scan_runner(cfg, make_lookup(cfg, tree.to(grid, dev)))
    css_d, qs_d = tree.to(css, dev), qs.to(dev)

    run(fresh_state(cfg, particles, dev), css_d, qs_d)     # warm-up
    torch.cuda.synchronize()
    state0 = fresh_state(cfg, particles, dev)
    torch.cuda.synchronize()

    cf.contact_fold.launches = 0
    # any host sync inside the step raises here
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    final, cents = run(state0, css_d, qs_d)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = cf.contact_fold.launches

    if launches != STEPS:
        raise RuntimeError(f"contact_fold launched {launches} times in "
                           f"{STEPS} steps")
    if cents.shape != (STEPS, 3) or not torch.isfinite(cents).all():
        raise RuntimeError("main path: non-finite or misshaped centroids")
    if not torch.isfinite(final.particles.weight).all():
        raise RuntimeError("main path: non-finite particle weights")
    err = np.linalg.norm(cents[:, :2].cpu().numpy() - truth, axis=1)
    final10 = float(err[-10:].mean())
    print(f"main path: {STEPS} steps x {N_BENCH} particles in "
          f"{elapsed:.4f} s, contact_fold launches {launches}")

    # the first CHECK_STEPS steps against the CPU port on the same draws
    gen = torch.Generator().manual_seed(1)
    draws = [steplib.StepDraws(
        pe.ProjectDraws.sample(N_BENCH, gen, "cpu"),
        torch.rand(N_BENCH, generator=gen)) for _ in range(CHECK_STEPS)]
    sub = tree.index(css, slice(0, CHECK_STEPS))
    run_cpu = steplib.make_scan_runner(cfg, make_lookup(cfg, grid))
    _, cents_cpu = run_cpu(fresh_state(cfg, particles, "cpu"), sub,
                           qs[:CHECK_STEPS], draws)
    _, cents_gpu = run(fresh_state(cfg, particles, dev), tree.to(sub, dev),
                       qs[:CHECK_STEPS].to(dev),
                       [tree.to(d, dev) for d in draws])
    dev_err = float((cents_gpu.cpu() - cents_cpu).abs().max())
    print(f"main path: GPU vs CPU port over {CHECK_STEPS} steps, max "
          f"centroid difference {dev_err:.3e} m")
    if not dev_err <= CENTROID_ATOL:
        raise RuntimeError(f"GPU and CPU centroids differ by {dev_err} m")

    if profile:
        profile_steps(run, cfg, particles, css_d, qs_d, dev, Path(profile))
    return dict(elapsed=elapsed, launches=launches, final10=final10,
                dev_err=dev_err)


# ---------------------------------------------------------------- phase 5

def alternate(kern, plain, n_kern=50, n_plain=5):
    """Mean ms per call of ``kern`` and ``plain``, timed in turns (plain,
    kernel, kernel, plain) after a warm-up; returns ``(kernel_ms,
    plain_ms, the four runs)``."""
    for f in (kern, plain):
        cuda_ms(f, 2)
    runs = (cuda_ms(plain, n_plain), cuda_ms(kern, n_kern),
            cuda_ms(kern, n_kern), cuda_ms(plain, n_plain))
    return (runs[1] + runs[2]) / 2, (runs[0] + runs[3]) / 2, runs


def check_chain_lookup(dev, pool, z_window):
    from slam_eslam_tpu_torch.models import sim
    from slam_eslam_tpu_torch.ops import chain_lookup as cl

    queries = sim.chain_queries(pool, SLAM_C, seed=5)
    max_err, timing = 0.0, None
    for name, n in (("bench", SLAM_N), ("ragged", SLAM_N_RAGGED)):
        args = (pool.mean, pool.stdev, pool.meta, pool.origin,
                pool.resolution, pool.chain[:n].contiguous(),
                tuple(q[:n].contiguous() for q in queries))
        kw = dict(k=pool.k, z_window=z_window)
        got = cl.chain_lookup(*args, **kw)
        ref = cl.chain_lookup_reference(*args, **kw)
        torch.cuda.synchronize()
        if got[0].shape != (n, SLAM_C):
            raise RuntimeError(f"chain_lookup[{name}]: bad output shape")
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            bad = int((got[0] != ref[0]).sum())
            raise RuntimeError(f"chain_lookup[{name}]: differs from its "
                               f"plain version ({bad} found flags)")
        max_err = max(max_err, *(float((a - b).abs().max())
                                 for a, b in zip(got[1:], ref[1:])))
        empty = float((pool.chain[:n] < 0).float().mean())
        print(f"chain_lookup[{name}] N={n} C={SLAM_C} L="
              f"{pool.chain.shape[1]}: bitwise equal, found "
              f"{float(got[0].float().mean()):.4f}, empty chain entries "
              f"{empty:.4f}")
        if name == "bench":
            k_ms, p_ms, runs = alternate(lambda: cl.chain_lookup(*args, **kw),
                                         lambda: cl.chain_lookup_reference(
                                             *args, **kw))
            timing = (k_ms, p_ms)
            print(f"chain_lookup[bench] kernel {k_ms:.4f} ms ({runs[1]:.4f}, "
                  f"{runs[2]:.4f}), plain {p_ms:.4f} ms ({runs[0]:.4f}, "
                  f"{runs[3]:.4f})")
    return max_err, timing


def one_point_slots(pool, blk, lx, ly):
    """Pool slots of cells that exactly one masked-in point hits."""
    inb = (lx < pool.nx) & (ly < pool.ny)
    cell = (blk.long()[:, None] * pool.nx + lx.long()) * pool.ny + ly.long()
    counts = torch.zeros(pool.b * pool.nx * pool.ny, dtype=torch.int32,
                         device=blk.device)
    counts.index_add_(0, cell[inb], torch.ones_like(cell[inb],
                                                    dtype=torch.int32))
    return (counts == 1).reshape(pool.b, pool.nx, pool.ny, 1).expand(
        -1, -1, -1, pool.k).reshape(pool.mean.shape)


def bench_cloud(dev):
    """The SLAM benchmark's scan: 64 rays at 2 m over a half turn,
    projected with an identity mount and orientation."""
    from slam_eslam_tpu_torch.mapping import projection

    scan = projection.LaserScan(
        torch.full((SLAM_RAYS,), 2.0, device=dev),
        torch.tensor(-np.pi / 2, dtype=torch.float32, device=dev),
        torch.tensor(np.pi / SLAM_RAYS, dtype=torch.float32, device=dev))
    pts, valid = projection.scan_to_points(scan, 3.0)
    eye = torch.eye(3, device=dev)
    q = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
    return projection.project_points(pts, valid, eye,
                                     torch.zeros(3, device=dev), q)


def check_block_merge(dev, pool, cfg):
    from slam_eslam_tpu_torch.mapping import map_pool as mp
    from slam_eslam_tpu_torch.models import sim
    from slam_eslam_tpu_torch.ops import block_merge as bm

    ops = mp.merge_operands(pool, *sim.poses_on_heads(pool, 3.0, seed=7),
                            bench_cloud(dev))
    kw = dict(k=pool.k, patch_thickness=cfg.grid_patch_thickness,
              gap_size=cfg.grid_gap_size)
    fields = [pool.mean, pool.stdev, pool.height, pool.meta]
    max_err, timing = 0.0, None
    for name, n in (("bench", SLAM_N), ("ragged", SLAM_N_RAGGED)):
        blk, lx, ly, w, wz = (a[:n].contiguous() for a in ops)
        kern = [f.clone() for f in fields]
        plain = [f.clone() for f in fields]
        bm.block_merge(*kern, None, blk, lx, ly, w, wz, 7, **kw)
        bm.block_merge_reference(*plain, None, blk, lx, ly, w, wz, 7, **kw)
        torch.cuda.synchronize()
        if not torch.equal(kern[3], plain[3]):
            bad = int((kern[3] != plain[3]).sum())
            raise RuntimeError(f"block_merge[{name}]: meta differs in {bad} "
                               f"slots")
        one = one_point_slots(pool, blk, lx, ly)
        for fname, a, b in zip(("mean", "stdev", "height"), kern, plain):
            if not torch.equal(a[one], b[one]):
                raise RuntimeError(f"block_merge[{name}] {fname}: one-point "
                                   f"cells not bitwise equal")
            tol = (MERGE_HEIGHT_ATOL if fname == "height"
                   else MERGE_RTOL * b.abs())
            if bool(((a - b).abs() > tol).any()):
                raise RuntimeError(f"block_merge[{name}] {fname}: outside "
                                   f"tolerance")
            max_err = max(max_err, float((a - b).abs().max()))
        written = int((kern[3] != pool.meta).sum())
        multi = int(((kern[3] != pool.meta) & ~one).sum())
        print(f"block_merge[{name}] N={n} P={lx.shape[1]}: {written} slots "
              f"written ({multi} from multi-point cells), meta equal, "
              f"max_abs_err={max_err:.3e}")
        if name == "bench":
            k_ms, p_ms, runs = alternate(
                lambda: bm.block_merge(*kern, None, blk, lx, ly, w, wz, 7,
                                       **kw),
                lambda: bm.block_merge_reference(*plain, None, blk, lx, ly,
                                                 w, wz, 7, **kw))
            timing = (k_ms, p_ms)
            print(f"block_merge[bench] kernel {k_ms:.4f} ms ({runs[1]:.4f}, "
                  f"{runs[2]:.4f}), plain {p_ms:.4f} ms ({runs[0]:.4f}, "
                  f"{runs[3]:.4f})")
        del kern, plain
    return max_err, timing


def check_slam_kernels(dev, cfg):
    from slam_eslam_tpu_torch.models import sim

    pool = sim.random_pool(SLAM_N, cfg.map_pool_blocks, **SLAM_POOL,
                           seed=3, device=dev)
    gb = sum(getattr(pool, f).numel() * 4 for f in pool.data_fields()) / 1e9
    print(f"SLAM pool: {pool.b} blocks of {pool.nx}x{pool.ny}x{pool.k}, "
          f"{gb:.3f} GB, {float(pool.valid.float().mean()):.4f} of slots "
          f"valid")
    k2 = check_chain_lookup(dev, pool, cfg.mls_z_window)
    k3 = check_block_merge(dev, pool, cfg)
    return k2, k3


# ---------------------------------------------------------------- phase 6

def slam_config():
    from slam_eslam_tpu_torch import Config, ContactModelConfig

    return dataclasses.replace(
        Config(), particle_count=SLAM_N, min_effective=SLAM_N // 2,
        grid_size=10.0, grid_resolution=0.25, map_pool_blocks=4 * SLAM_N,
        map_chain_length=3, map_pool_color=False, map_pool_dtype="float32",
        contact_model=ContactModelConfig(contact_point_radius=0.0,
                                         min_contacts=2))


def slam_setup():
    """The SLAM benchmark trajectory (``bench.py::bench_slam``): the
    Asguard rolling 0.3 rad per step over a sine terrain, 10 substeps per
    step, one 64-ray scan at 2 m on each step's last substep, contacts
    compacted to 8 for the measurement and the odometry from the full 20.
    Returns ``(z0, frames, full contact states, orientations)``."""
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
        frames.append([cs.compact(CONTACT_CAP), q,
                       s.position.astype(np.float32),
                       np.full(SLAM_RAYS, 2.0, np.float32), meta, False])

    for _ in range(SLAM_STEPS):
        asg.step(wheel_delta=0.3, substeps=SLAM_SUBSTEPS,
                 on_substep=on_substep)
        frames[-1][5] = True
    qs = torch.tensor(np.stack([f[1] for f in frames]))
    return z0, streaming.stack_frames(frames), tree.stack(full), qs


def slam_carry(cfg, z0, dev, normals=None):
    from slam_eslam_tpu_torch.filter import streaming
    from slam_eslam_tpu_torch.filter.eslam_filter import EmbodiedSlamFilter

    f = EmbodiedSlamFilter(config=cfg, device=dev).init(
        pose=(np.array([0.0, 0.0, z0]), 0.0), use_shared_map=False,
        num_contact_points=20,
        normal_xy=None if normals is None else normals[0].to(dev),
        normal_yaw=None if normals is None else normals[1].to(dev))
    return streaming.StreamingState.create(f.state, f.pool)


def slam_path(dev, profile):
    from slam_eslam_tpu_torch.filter import pose_estimator as pe
    from slam_eslam_tpu_torch.filter import streaming
    from slam_eslam_tpu_torch.filter.step import StepDraws
    from slam_eslam_tpu_torch.ops import block_merge as bm
    from slam_eslam_tpu_torch.ops import chain_lookup as cl
    from slam_eslam_tpu_torch.ops import contact_fold as cf
    from slam_eslam_tpu_torch.utils import tree

    cfg = slam_config()
    z0, frames, full, qs = slam_setup()
    n_frames = len(frames)
    frames_d = tree.to(frames, dev)
    odos = streaming.precompute_odometry(20, tree.to(full, dev), qs.to(dev),
                                         cfg=cfg)
    run = streaming.make_slam_scan_runner(
        cfg, laser2body=(np.eye(3), np.zeros(3)), external_odometry=True)
    warm = slice(0, 30)
    run(slam_carry(cfg, z0, dev), frames_d.at(warm), tree.index(odos, warm))
    carry0 = slam_carry(cfg, z0, dev)
    torch.cuda.synchronize()

    cf.contact_fold.launches = 0
    cl.chain_lookup.launches = 0
    bm.block_merge.launches = 0
    # any host sync inside a frame raises here
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    try:
        carry, aux = run(carry0, frames_d, odos)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"contact_fold": cf.contact_fold.launches,
                "chain_lookup": cl.chain_lookup.launches,
                "block_merge": bm.block_merge.launches}
    del carry0

    n_meas, n_map = int(aux["updated"].sum()), int(aux["mapped"].sum())
    want = {"chain_lookup": n_meas + (n_map if cfg.use_visual_update else 0),
            "block_merge": n_map, "contact_fold": 0}
    if launches != want or not n_meas or not n_map:
        raise RuntimeError(f"SLAM path: launches {launches}, gates want "
                           f"{want}")
    if aux["centroid"].shape != (n_frames, 3) or not bool(
            torch.isfinite(aux["centroid"]).all()):
        raise RuntimeError("SLAM path: non-finite or misshaped centroids")
    if not bool(torch.isfinite(carry.filter.particles.weight).all()):
        raise RuntimeError("SLAM path: non-finite particle weights")
    pool = carry.pool
    for name in ("mean", "stdev", "height"):
        if not bool(torch.isfinite(getattr(pool, name)).all()):
            raise RuntimeError(f"SLAM path: non-finite pool {name}")
    patches = int(pool.valid.sum())
    failed = int(carry.alloc_failed)
    if patches <= 0:
        raise RuntimeError("SLAM path: no patches were merged")
    print(f"SLAM path: {n_frames} frames x {SLAM_N} particles in "
          f"{elapsed:.4f} s = {n_frames / elapsed:.2f} frames/s; "
          f"{n_meas} measurement and {n_map} mapping frames; launches "
          f"{launches}; patches {patches}, alloc_failed {failed}")
    del carry, pool

    # the first frames against the CPU port on the same draws
    sub = slice(0, SLAM_CHECK_FRAMES)
    gen = torch.Generator().manual_seed(1)
    normals = (torch.randn((SLAM_N, 2), generator=gen),
               torch.randn((SLAM_N,), generator=gen))
    draws = [StepDraws(pe.ProjectDraws.sample(SLAM_N, gen, "cpu"),
                       torch.rand(SLAM_N, generator=gen))
             for _ in range(SLAM_CHECK_FRAMES)]
    odos_cpu = streaming.precompute_odometry(20, full, qs, cfg=cfg)
    c_cpu, a_cpu = run(slam_carry(cfg, z0, "cpu", normals), frames.at(sub),
                       tree.index(odos_cpu, sub), draws)
    c_gpu, a_gpu = run(slam_carry(cfg, z0, dev, normals), frames_d.at(sub),
                       tree.index(odos, sub), [tree.to(d, dev) for d in draws])
    if not ((a_gpu["updated"] == a_cpu["updated"]).all()
            and (a_gpu["mapped"] == a_cpu["mapped"]).all()):
        raise RuntimeError("SLAM path: GPU and CPU gates differ")
    dev_err = float((a_gpu["centroid"].cpu() - a_cpu["centroid"]).abs().max())
    p_gpu, p_cpu = int(c_gpu.pool.valid.sum()), int(c_cpu.pool.valid.sum())
    print(f"SLAM path: GPU vs CPU port over {SLAM_CHECK_FRAMES} frames, max "
          f"centroid difference {dev_err:.3e} m, patches {p_gpu} vs {p_cpu}")
    if not dev_err <= CENTROID_ATOL:
        raise RuntimeError(f"SLAM path: GPU and CPU centroids differ by "
                           f"{dev_err} m")
    if abs(p_gpu - p_cpu) > PATCH_COUNT_RTOL * p_cpu:
        raise RuntimeError(f"SLAM path: patch counts {p_gpu} (GPU) and "
                           f"{p_cpu} (CPU) differ")
    del c_gpu, c_cpu

    if profile:
        profile_slam(run, cfg, z0, frames_d, odos, dev, Path(profile))
    return dict(elapsed=elapsed, frames=n_frames, launches=launches,
                patches=patches, failed=failed, dev_err=dev_err,
                n_meas=n_meas, n_map=n_map)


def profile_slam(run, cfg, z0, frames_d, odos, dev, out):
    from torch.profiler import ProfilerActivity, profile

    from slam_eslam_tpu_torch.utils import tree

    carry = slam_carry(cfg, z0, dev)
    sub = slice(0, SLAM_PROFILE_FRAMES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(carry, frames_d.at(sub), tree.index(odos, sub))
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    avg = prof.key_averages()
    device_us = sum(getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0))
                    for e in avg)
    launch_calls = sum(e.count for e in avg
                       if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                    "cudaLaunchKernelExC"))
    table = avg.table(sort_by="cuda_time_total", row_limit=50)
    out.mkdir(parents=True, exist_ok=True)
    (out / "chip_smoke_slam_profile.txt").write_text(table)
    prof.export_chrome_trace(str(out / "chip_smoke_slam_trace.json"))
    print(f"SLAM profile: {SLAM_PROFILE_FRAMES} frames in {wall:.4f} s "
          f"traced, device busy {device_us / 1e3:.3f} ms "
          f"({device_us / 1e4 / wall:.2f} %), "
          f"{launch_calls / SLAM_PROFILE_FRAMES:.1f} launch calls per frame")
    print(table[:6000])


def profile_steps(run, cfg, particles, css_d, qs_d, dev, out, steps=10):
    from torch.profiler import ProfilerActivity, profile

    from slam_eslam_tpu_torch.utils import tree

    state = fresh_state(cfg, particles, dev)
    sub = tree.index(css_d, slice(0, steps))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(state, sub, qs_d[:steps])
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    out.mkdir(parents=True, exist_ok=True)
    (out / "chip_smoke_profile.txt").write_text(table)
    prof.export_chrome_trace(str(out / "chip_smoke_trace.json"))
    print(table[:6000])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile 10 main-path steps into DIR")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA GPU: "
                         "torch.cuda.is_available() is False")
    from slam_eslam_tpu_torch import Config
    from slam_eslam_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = nvidia_smi()
    print(f"device: {kind}, count {torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(f"card: {card}")

    t0 = time.perf_counter()
    seconds = _build.load_all(KERNELS)
    print(f"build: {', '.join(f'{k} {v:.2f} s' for k, v in seconds.items())}"
          f" ({time.perf_counter() - t0:.2f} s in parallel)")
    for name in KERNELS:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    max_err, (k_ms, p_ms) = check_contact_fold(dev, Config())
    res = main_path(dev, args.profile)
    ms_step = res["elapsed"] / STEPS * 1e3
    print(f"main path: {ms_step:.4f} ms/step, "
          f"{N_BENCH * STEPS / res['elapsed']:.1f} particle-updates/s, "
          f"contact_fold {k_ms * 1e3:.2f} us/step (plain "
          f"{p_ms * 1e3:.2f} us), final-10 xy error "
          f"{res['final10']:.4f} m [{card}]")

    (k2_err, (k2_ms, k2_plain)), (k3_err, (k3_ms, k3_plain)) = (
        check_slam_kernels(dev, slam_config()))
    slam = slam_path(dev, args.profile)
    print(f"SLAM path: {slam['frames'] / slam['elapsed']:.2f} frames/s at "
          f"{SLAM_N} particles, {slam['elapsed'] / slam['frames'] * 1e3:.4f}"
          f" ms/frame; chain_lookup {k2_ms * 1e3:.2f} us (plain "
          f"{k2_plain * 1e3:.2f} us), block_merge {k3_ms * 1e3:.2f} us "
          f"(plain {k3_plain * 1e3:.2f} us) [{card}]")

    rows = (
        ("contact_fold", "slam_eslam_tpu/ops/pallas_gather.py:578",
         res["launches"], max_err, k_ms, p_ms),
        ("chain_lookup", "slam_eslam_tpu/ops/pallas_chain.py:36",
         slam["launches"]["chain_lookup"], k2_err, k2_ms, k2_plain),
        ("block_merge", "slam_eslam_tpu/ops/pallas_merge.py:211",
         slam["launches"]["block_merge"], k3_err, k3_ms, k3_plain),
    )
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"slam_eslam_tpu_torch/csrc/{name}.cu",
        "replaces": replaces, "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms,
    } for name, replaces, launches, err, ms, plain_ms in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
