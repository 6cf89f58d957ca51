#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py [--profile DIR]

Phases (any failure raises and exits non-zero):

1. report the card (torch and ``nvidia-smi`` name and power limit);
2. build every kernel of the main path from ``slam_eslam_tpu_torch/csrc``;
3. check each kernel against its plain PyTorch version on the card, at
   the benchmark shape (N = 100,000 particles, C = 8 contacts, a
   400x400x4 grid), at a ragged N and on a spread cloud with out-of-grid
   queries, and time both with CUDA events;
4. drive the main path: the benchmark trajectory (100k particles, 20 m x
   20 m map at 0.05 m, contacts compacted to 8, 150 steps) through
   ``filter.step.make_scan_runner`` on the card; count kernel launches,
   check the centroids, and hold the first 20 steps against the CPU port
   fed the same random draws.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  ``--profile DIR`` also writes a
``torch.profiler`` table and trace of 10 main-path steps to DIR.
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
    _build.load("contact_fold")
    print(f"build: contact_fold in {time.perf_counter() - t0:.2f} s")
    for line in _build.build_log("contact_fold").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    max_err, (k_ms, p_ms) = check_contact_fold(dev, Config())
    res = main_path(dev, args.profile)

    ms_step = res["elapsed"] / STEPS * 1e3
    print(f"main path: {ms_step:.4f} ms/step, "
          f"{N_BENCH * STEPS / res['elapsed']:.1f} particle-updates/s, "
          f"contact_fold {k_ms * 1e3:.2f} us/step (plain "
          f"{p_ms * 1e3:.2f} us), final-10 xy error "
          f"{res['final10']:.4f} m [{card}]")
    print(json.dumps({"kernels": [{
        "name": "contact_fold",
        "route": "cuda",
        "source": "slam_eslam_tpu_torch/csrc/contact_fold.cu",
        "replaces": "slam_eslam_tpu/ops/pallas_gather.py:578",
        "launches": res["launches"],
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
