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
   60 frames against the CPU port fed the same random draws;
7. check the unfolded lookup's select (K5) against its plain version,
   bit for bit, at 800,000 queries (100k particles x 8 contacts) on the
   400x400x4 grid, at a ragged count and on a spread cloud with
   out-of-grid queries, and time both; then drive the application API,
   ``EmbodiedSlamFilter.update_contact`` in shared-map mode with
   ``log_debug`` and the surface hash (global init, reinjection), at
   100k particles over the 150 frames of the localisation trajectory
   with host syncs forbidden in every measurement update and the
   distribution exported every 50 frames; count K5 launches (one per
   measurement update, K1 none), run 20 frames with Chitta weighting
   and 20 with the slip update on terrain labels, and hold the first 20
   frames against the CPU port fed the same random draws.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  ``--profile DIR`` also writes
``torch.profiler`` tables and traces of 10 localisation steps, of 50
SLAM frames and of 20 application frames to DIR.
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
# the application path (phase 7): EmbodiedSlamFilter.update_contact on
# the localisation bench's grid, the distribution exported every 50
# frames, 20-frame runs of the Chitta weighting and the slip update
APP_FRAMES = 150
APP_SHORT_FRAMES = 20
APP_LOG_PERIOD = 50
APP_PROFILE_FRAMES = 20
APP_HASH_PERIOD = 5      # steps between hash reinjections
CP_OK_RTOL = 1e-3        # cp_ok counts per update, GPU vs CPU port
KERNELS = ("contact_fold", "chain_lookup", "block_merge", "select_cells")


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


# ---------------------------------------------------------------- phase 7

def check_select_cells(dev, cfg):
    """K5 against its plain version on the phase-3 grid and queries, flat:
    every output bit for bit, misses included; the int32-cell entry
    against the world entry; both timed in turns."""
    from slam_eslam_tpu_torch.mapping import mls_grid
    from slam_eslam_tpu_torch.ops import select_cells as sc

    z_window = cfg.mls_z_window
    max_err, timing = 0.0, None
    for name, n, spread in (("bench", N_BENCH, False),
                            ("ragged", N_RAGGED, False),
                            ("spread", N_BENCH, True)):
        packed, q, *_ = fold_inputs(n, spread, dev, seed=n + 7)
        q = tuple(a.reshape(-1).contiguous() for a in q)
        got = sc.select_cells(packed, q, z_window)
        ref = sc.select_cells_reference(packed, q, z_window)
        ix, iy = mls_grid.cells(packed, q[0], q[1])
        by_cell = sc.select_cells(packed, (ix, iy, q[2]), z_window)
        torch.cuda.synchronize()
        if got[0].shape != (8 * n,):
            raise RuntimeError(f"select_cells[{name}]: bad output shape")
        for what, out in (("plain version", ref), ("cell entry", by_cell)):
            if not all(torch.equal(a, b) for a, b in zip(got, out)):
                bad = int((got[0] != out[0]).sum())
                raise RuntimeError(f"select_cells[{name}]: differs from the "
                                   f"{what} ({bad} found flags)")
        max_err = max(max_err, *(float((a - b).abs().max())
                                 for a, b in zip(got[1:], ref[1:])))
        inside = (ix >= 0) & (ix < packed.data.shape[0]) & (iy >= 0) & (
            iy < packed.data.shape[1])
        print(f"select_cells[{name}] Q={8 * n}: bitwise equal, found "
              f"{float(got[0].float().mean()):.4f}, outside the grid "
              f"{float((~inside).float().mean()):.4f}")
        if name == "bench":
            k_ms, p_ms, runs = alternate(
                lambda: sc.select_cells(packed, q, z_window),
                lambda: sc.select_cells_reference(packed, q, z_window),
                n_kern=50, n_plain=20)
            timing = (k_ms, p_ms)
            print(f"select_cells[bench] kernel {k_ms:.4f} ms ({runs[1]:.4f}, "
                  f"{runs[2]:.4f}), plain {p_ms:.4f} ms ({runs[0]:.4f}, "
                  f"{runs[3]:.4f})")
    return max_err, timing


def app_config(**contact):
    from slam_eslam_tpu_torch import Config, ContactModelConfig

    return dataclasses.replace(
        Config(), particle_count=N_BENCH, min_effective=N_BENCH // 5,
        contact_model=ContactModelConfig(contact_point_radius=0.0, **contact),
        log_debug=not contact, log_particle_period=APP_LOG_PERIOD)


def app_classes(x, y):
    """Terrain-class colours of the slip run: class 0 west of x = 0,
    class 1 east of it."""
    east = np.asarray(x) > 0.0
    return np.stack([~east, east, np.zeros_like(east)], -1)


def app_labels(frame):
    """Per-wheel terrain labels of the slip run: wheels 0 and 1 on class
    0, wheel 3 on class 1 from frame 10."""
    out = [(0, [0.8, 0.1, 0.1]), (1, [0.7, 0.2, 0.1])]
    if frame >= 10:
        out.append((3, [0.1, 0.8, 0.1]))
    return out


def app_setup():
    """The localisation bench's trajectory for ``update_contact``: the
    host poses ``(quaternion, position)`` the motion gate reads, and the
    contact states (compacted to 8) and orientations, stacked."""
    from slam_eslam_tpu_torch.models import sim
    from slam_eslam_tpu_torch.utils import geometry, tree

    trajectory = sim.TrajectorySim(bench_terrain, speed=0.05)
    z0 = float(trajectory.position[2])
    poses, css, qs = [], [], []
    for _ in range(APP_FRAMES):
        (pos, yaw), _ = trajectory.step()
        q = geometry.quat_from_yaw(torch.tensor(yaw, dtype=torch.float32))
        css.append(trajectory.contact_state(noise=0.005).compact(CONTACT_CAP))
        qs.append(q)
        poses.append((q.numpy(), pos))
    return z0, poses, tree.stack(css), torch.stack(qs)


def app_filter(cfg, grid, z0, dev, hash_config=None, particles=None):
    from slam_eslam_tpu_torch.filter.eslam_filter import EmbodiedSlamFilter
    from slam_eslam_tpu_torch.utils import tree

    f = EmbodiedSlamFilter(config=cfg, device=dev).init(
        pose=(np.array([0.0, 0.0, z0]), 0.0), shared_grid=grid,
        hash_config=hash_config, num_contact_points=CONTACT_CAP)
    if particles is not None:
        f.state = dataclasses.replace(f.state,
                                      particles=tree.to(particles, dev))
    return f


def app_drive(f, poses, css, qs, frames, labels=None, spans=None,
              exports=None):
    """``update_contact`` over the first ``frames`` frames (contact
    states and orientations already on the filter's device), host syncs
    forbidden in each call.  ``spans`` collects, per call, CUDA events
    around it and its host milliseconds (the time to launch its work),
    ``exports`` the period-gated distributions.  Returns the gate
    decisions."""
    gates = []
    for i in range(frames):
        if spans is not None:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            gates.append(f.update_contact(
                poses[i], css[i], None if labels is None else labels(i),
                orientation=qs[i]))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if spans is not None:
            host_ms = (time.perf_counter() - t0) * 1e3
            ev[1].record()
            spans.append((*ev, host_ms))
        if exports is not None:
            dist = f.maybe_log_distribution()
            if dist is not None:
                exports.append((i, dist))
    return gates


def check_app_state(f, name):
    p = f.state.particles
    cent, quat = f.get_centroid()
    if not (bool(torch.isfinite(p.weight).all())
            and bool(torch.isfinite(cent).all())
            and bool(torch.isfinite(quat).all())):
        raise RuntimeError(f"application path[{name}]: non-finite state")
    return cent


def app_compare(dev, cfg, hcfg, grid, z0, poses, css, qs):
    """The card against the CPU port on identical draws.  The global
    initialisation: equal hash tables (no bucket flips) and equal
    particles from equal integer draws.  Then the first CHECK_STEPS
    frames from one Gaussian start cloud, with the same odometry noise,
    resampling uniforms and in-bucket reinjection draws.  (From the
    hash's map-wide cloud a one-ulp difference of a weight moves a
    resampling ancestor by metres, not by the centimetres the tolerance
    is made for.)"""
    from slam_eslam_tpu_torch.filter import pose_estimator as pe
    from slam_eslam_tpu_torch.filter.eslam_filter import ContactDraws
    from slam_eslam_tpu_torch.utils import tree

    f_cpu = app_filter(cfg, grid, z0, "cpu", hcfg)
    f_gpu = app_filter(cfg, tree.to(grid, dev), z0, dev, hcfg)
    h = f_cpu.hash
    flips = int((f_gpu.hash.bucket_id.cpu() != h.bucket_id).sum())
    gen = torch.Generator().manual_seed(2)
    n = cfg.particle_count
    u = torch.randint(0, int(h.n_valid), (n,), generator=gen)
    p_cpu = h.sample_particles(n, u)
    p_gpu = f_gpu.hash.sample_particles(n, u.to(dev))
    if flips or not all(torch.equal(getattr(p_cpu, f.name),
                                    getattr(p_gpu, f.name).cpu())
                        for f in dataclasses.fields(p_cpu)):
        raise RuntimeError(f"application path: the hash differs on the card "
                           f"({flips} bucket flips)")

    start = pe.init_gaussian(
        n, (0.0, 0.0), 0.0, cfg.initial_translation_error[:2],
        cfg.initial_rotation_error[2], z0,
        cfg.initial_translation_error[2] + 1e-3, generator=gen)
    for f in (f_cpu, f_gpu):
        f.state = dataclasses.replace(
            f.state, particles=tree.to(start, f.device))
    dev_err, cp_err, gates = 0.0, 0.0, []
    for i in range(CHECK_STEPS):
        cs, q = tree.index(css, i), qs[i]
        count = int(h._at_bucket(h.bucket_count,
                                 h.bucket(*h.signature(cs, q))))
        draws = ContactDraws(
            pe.ProjectDraws.sample(n, gen, "cpu"),
            torch.rand(n, generator=gen),
            (torch.rand(n, generator=gen, dtype=torch.float64)
             * max(count, 1)).long())
        g_cpu = f_cpu.update_contact(poses[i], cs, draws=draws, orientation=q)
        g_gpu = f_gpu.update_contact(poses[i], tree.to(cs, dev),
                                     draws=tree.to(draws, dev),
                                     orientation=q.to(dev))
        if g_cpu != g_gpu:
            raise RuntimeError(f"application path: gates differ at frame {i}")
        gates.append(g_gpu)
        c_cpu, c_gpu = f_cpu.get_centroid()[0], f_gpu.get_centroid()[0]
        dev_err = max(dev_err, float((c_gpu.cpu() - c_cpu).abs().max()))
        if g_gpu:
            n_cpu = int(f_cpu.last_eval.cp_ok.sum())
            n_gpu = int(f_gpu.last_eval.cp_ok.sum())
            cp_err = max(cp_err, abs(n_gpu - n_cpu) / max(n_cpu, 1))
    rein = app_reinjections(gates, hcfg)
    print(f"application path: GPU vs CPU port, hash of "
          f"{h.bucket_id.numel()} candidates with {flips} bucket flips and "
          f"equal global-init particles; over {CHECK_STEPS} frames "
          f"({sum(gates)} measurement updates, {rein} reinjections): max "
          f"centroid difference {dev_err:.3e} m, cp_ok counts within "
          f"{cp_err:.3e}")
    if not dev_err <= CENTROID_ATOL:
        raise RuntimeError(f"application path: GPU and CPU centroids differ "
                           f"by {dev_err} m")
    if not cp_err <= CP_OK_RTOL:
        raise RuntimeError(f"application path: cp_ok counts differ by "
                           f"{cp_err}")
    return dev_err, cp_err, flips


def app_reinjections(gates, hcfg):
    """Hash reinjections in a run: measurement updates on a step count
    that is a multiple of the period."""
    return sum(1 for i, g in enumerate(gates)
               if g and (i + 1) % max(1, hcfg.period) == 0)


def app_path(dev, profile):
    from slam_eslam_tpu_torch import SurfaceHashConfig
    from slam_eslam_tpu_torch.models import sim
    from slam_eslam_tpu_torch.ops import contact_fold as cf
    from slam_eslam_tpu_torch.ops import select_cells as sc
    from slam_eslam_tpu_torch.utils import tree

    cfg = app_config()
    # the gate fires on every second frame, at odd step counts, so the
    # default period of 10 steps would never reinject
    hcfg = SurfaceHashConfig(use_hash=True, period=APP_HASH_PERIOD)
    grid = sim.terrain_grid(bench_terrain, **GRID)
    grid_d = tree.to(grid, dev)
    z0, poses, css, qs = app_setup()
    css_d, qs_d = tree.to(css, dev), qs.to(dev)
    frames = [tree.index(css_d, i) for i in range(APP_FRAMES)]
    qs_l = [qs_d[i] for i in range(APP_FRAMES)]

    app_drive(app_filter(cfg, grid_d, z0, dev, hcfg), poses, frames, qs_l,
              10)                                               # warm-up
    t0 = time.perf_counter()
    f = app_filter(cfg, grid_d, z0, dev, hcfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    spans, exports = [], []
    cf.contact_fold.launches = 0
    sc.select_cells.launches = 0
    t0 = time.perf_counter()
    gates = app_drive(f, poses, frames, qs_l, APP_FRAMES, spans=spans,
                      exports=exports)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"select_cells": sc.select_cells.launches,
                "contact_fold": cf.contact_fold.launches}
    n_meas = sum(gates)
    if launches != {"select_cells": n_meas, "contact_fold": 0} or not n_meas:
        raise RuntimeError(f"application path: launches {launches} for "
                           f"{n_meas} measurement updates")
    check_app_state(f, "log_debug+hash")
    ev = f.last_eval
    if not bool(ev.cp_ok.any()) or not bool(
            (ev.cp_point[ev.cp_ok].abs().sum(-1) > 0).all()):
        raise RuntimeError("application path: no debug contact points")
    if [i for i, _ in exports] != [i for i in range(APP_FRAMES)
                                   if (i + 1) % APP_LOG_PERIOD == 0]:
        raise RuntimeError(f"application path: exports at frames "
                           f"{[i for i, _ in exports]}")
    for _, dist in exports:
        if not (bool(torch.isfinite(dist.gmm_means).all())
                and bool(torch.isfinite(dist.gmm_covs).all())
                and dist.cpoints.shape == ev.cp_point.shape):
            raise RuntimeError("application path: bad distribution export")
    def mean_ms(which, gated):
        ms = [which(span) for span, g in zip(spans, gates) if g == gated]
        return sum(ms) / max(len(ms), 1)

    device_ms = lambda span: span[0].elapsed_time(span[1])
    host_ms = lambda span: span[2]
    ms_meas, ms_plain = mean_ms(device_ms, True), mean_ms(device_ms, False)
    host_meas, host_plain = mean_ms(host_ms, True), mean_ms(host_ms, False)
    print(f"application path: {APP_FRAMES} frames x {N_BENCH} particles in "
          f"{elapsed:.4f} s = {APP_FRAMES / elapsed:.2f} frames/s; "
          f"{n_meas} measurement updates at {ms_meas:.4f} ms each (CUDA "
          f"events; {host_meas:.4f} ms on the host), other frames "
          f"{ms_plain:.4f} ms ({host_plain:.4f} ms); launches {launches}; "
          f"{len(exports)} distribution exports, "
          f"{app_reinjections(gates, hcfg)} hash reinjections; hash "
          f"{f.hash.cand_xy.shape[0]} candidates, {int(f.hash.n_valid)} "
          f"valid, init {init_s:.4f} s")
    del f, spans, exports

    short = {}
    for name, contact, grid_s, labels in (
            ("chitta", dict(weighting="chitta"), grid_d, None),
            ("slip", dict(use_slip_update=True),
             tree.to(sim.terrain_grid(bench_terrain, **GRID,
                                      color=app_classes), dev),
             app_labels)):
        cfg_s = app_config(**contact)
        f_s = app_filter(cfg_s, grid_s, z0, dev)
        sc.select_cells.launches = 0
        cf.contact_fold.launches = 0
        g = app_drive(f_s, poses, frames, qs_l, APP_SHORT_FRAMES,
                      labels=labels)
        k5 = sc.select_cells.launches
        want = sum(g) if name == "chitta" else 0
        if k5 != want or cf.contact_fold.launches or not sum(g):
            raise RuntimeError(f"application path[{name}]: select_cells "
                               f"launched {k5} times, contact_fold "
                               f"{cf.contact_fold.launches}, for {sum(g)} "
                               f"updates")
        cent = check_app_state(f_s, name)
        short[name] = (sum(g), k5)
        print(f"application path[{name}]: {APP_SHORT_FRAMES} frames, "
              f"{sum(g)} measurement updates, select_cells launches {k5}, "
              f"centroid {cent.cpu().numpy()}")
        del f_s

    dev_err, cp_err, flips = app_compare(dev, cfg, hcfg, grid, z0, poses,
                                         css, qs)
    if profile:
        profile_app(cfg, hcfg, grid_d, z0, poses, frames, qs_l, dev,
                    Path(profile))
    return dict(elapsed=elapsed, launches=launches, n_meas=n_meas,
                ms_meas=ms_meas, ms_plain=ms_plain, host_meas=host_meas,
                host_plain=host_plain, dev_err=dev_err,
                cp_err=cp_err, flips=flips, short=short)


def profile_app(cfg, hcfg, grid_d, z0, poses, frames, qs_l, dev, out):
    from torch.profiler import ProfilerActivity, profile

    f = app_filter(cfg, grid_d, z0, dev, hcfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        gates = app_drive(f, poses, frames, qs_l, APP_PROFILE_FRAMES)
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
    (out / "chip_smoke_app_profile.txt").write_text(table)
    prof.export_chrome_trace(str(out / "chip_smoke_app_trace.json"))
    print(f"application profile: {APP_PROFILE_FRAMES} frames "
          f"({sum(gates)} measurement updates) in {wall:.4f} s traced, "
          f"device busy {device_us / 1e3:.3f} ms "
          f"({device_us / 1e4 / wall:.2f} %), "
          f"{launch_calls / APP_PROFILE_FRAMES:.1f} launch calls per frame")
    print(table[:6000])


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
                    help="also profile the localisation, SLAM and "
                         "application paths into DIR")
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

    k5_err, (k5_ms, k5_plain) = check_select_cells(dev, Config())
    app = app_path(dev, args.profile)
    print(f"application path: {APP_FRAMES / app['elapsed']:.2f} frames/s at "
          f"{N_BENCH} particles, {app['ms_meas']:.4f} ms per measurement "
          f"update ({app['n_meas']} updates); select_cells "
          f"{k5_ms * 1e3:.2f} us (plain {k5_plain * 1e3:.2f} us) [{card}]")

    rows = (
        ("contact_fold", "slam_eslam_tpu/ops/pallas_gather.py:578",
         res["launches"], max_err, k_ms, p_ms),
        ("chain_lookup", "slam_eslam_tpu/ops/pallas_chain.py:36",
         slam["launches"]["chain_lookup"], k2_err, k2_ms, k2_plain),
        ("block_merge", "slam_eslam_tpu/ops/pallas_merge.py:211",
         slam["launches"]["block_merge"], k3_err, k3_ms, k3_plain),
        ("select_cells", "slam_eslam_tpu/ops/pallas_gather.py:277",
         app["launches"]["select_cells"], k5_err, k5_ms, k5_plain),
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
