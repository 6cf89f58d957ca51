"""Integrated demo: a drifting front end plus the pose-graph loop-closure
back end.

Counterpart of ``examples/loop_closure_demo.py`` of the JAX package.  The
robot drives an out-and-back path whose believed poses drift in y; the
keyframe manager stores terrain-sampled scan clouds, detects the
revisit, aligns against the old keyframes' grids, and the pose-graph
optimisation pulls the drifted trajectory back onto itself.

Run:  python -m slam_eslam_tpu_torch.examples.loop_closure_demo [--cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from slam_eslam_tpu_torch.backend.keyframes import KeyframeManager
from slam_eslam_tpu_torch.mapping.mls_grid import PatchCloud
from slam_eslam_tpu_torch.utils.device import entry_device


def terrain(x, y):
    return 0.3 * np.sin(0.9 * np.asarray(x)) + 0.25 * np.cos(
        0.7 * np.asarray(y))


def closure_run(device=None, log=print):
    """The demo on ``device`` (the CUDA device unless given).  Returns a
    dict: ``closures``, ``believed [K, 3]``, ``trajectory [K, 3]`` after
    optimisation, the max |y| drift before and after, and the chi2
    history."""
    rng = np.random.default_rng(0)
    device = entry_device(device)

    def scan_cloud(true_pose, n=400):
        local = rng.uniform(-1.5, 1.5, (n, 2)).astype(np.float32)
        c, s = np.cos(true_pose[2]), np.sin(true_pose[2])
        world = np.stack(
            [c * local[:, 0] - s * local[:, 1] + true_pose[0],
             s * local[:, 0] + c * local[:, 1] + true_pose[1]], axis=1)
        z = terrain(world[:, 0], world[:, 1]).astype(np.float32)
        return PatchCloud.create(
            xy=torch.from_numpy(local).to(device),
            z=torch.from_numpy(z - np.float32(0.2)).to(device),
            stdev=torch.full((n,), 0.05, device=device),
            valid=torch.ones((n,), dtype=torch.bool, device=device))

    km = KeyframeManager(keyframe_distance=0.45, closure_radius=1.0,
                         min_separation=4, min_score=0.3,
                         closure_info=2000.0, device=device)

    # out-and-back ground truth with odometry drift in the belief
    xs = list(np.arange(0, 3.1, 0.5)) + list(np.arange(2.5, -0.1, -0.5))
    drift_per_kf = 0.06
    drift = 0.0
    believed = []
    for x in xs:
        true_pose = np.array([x, 0.0, 0.0])
        belief = true_pose + np.array([0.0, drift, 0.0])
        added, closure = km.maybe_add_keyframe(belief, scan_cloud(true_pose),
                                               z=0.2)
        if added:
            drift += drift_per_kf
            believed.append(belief)
            mark = f"  closure {closure}" if closure else ""
            log(f"kf {len(believed) - 1:2d}  belief=({belief[0]:5.2f},"
                f"{belief[1]:5.2f})  truth=({x:4.1f},0.00){mark}")

    log(f"\nclosures: {km.closures}")
    traj, hist = km.optimize(iters=15)
    believed = np.array(believed)
    err_before = np.abs(believed[:, 1]).max()
    err_after = np.abs(traj[: len(believed), 1]).max()
    hist = hist.cpu().numpy()
    log(f"max |y| drift before optimisation: {err_before:.3f} m")
    log(f"max |y| drift after  optimisation: {err_after:.3f} m")
    log(f"chi2: {float(hist[0]):.4f} -> {float(hist[-1]):.4f}")
    return dict(closures=km.closures, believed=believed,
                trajectory=traj[: len(believed)], err_before=err_before,
                err_after=err_after, hist=hist)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA device")
    args = ap.parse_args(argv)
    return closure_run("cpu" if args.cpu else None)


if __name__ == "__main__":
    main()
