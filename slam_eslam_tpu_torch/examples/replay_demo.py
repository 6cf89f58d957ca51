"""Record a traverse into the native log, then replay it through the filter.

Counterpart of ``examples/replay_demo.py`` of the JAX package.  Phase 1
records a simulated Asguard traverse (contact states, orientations,
ground-truth poses) through the C++ log writer (``io.logio``); phase 2
replays it with the asynchronous prefetching feeder into
``EmbodiedSlamFilter.update_contact`` on a shared map: disk -> native
prefetch thread -> host decode -> filter on the device.  Every
measurement update runs the contact fold K1 (``ops.contact_fold``) on the
card: the filter's shared-map lookup folds (``Config.fold_lookup``).  On
the card the filter replays its calls as CUDA graphs
(``EmbodiedSlamFilter(graph=True)``), as the JAX demo runs them jitted;
with ``--cpu`` it runs them eagerly.  The
timestamps come from the wall clock, so two recordings differ in them and
nowhere else.

Run:  python -m slam_eslam_tpu_torch.examples.replay_demo
          [--steps 15] [--particles 48] [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np

from slam_eslam_tpu_torch.config import Config, ContactModelConfig
from slam_eslam_tpu_torch.filter.eslam_filter import (ContactDraws,
                                                      EmbodiedSlamFilter)
from slam_eslam_tpu_torch.io import logio
from slam_eslam_tpu_torch.models import sim as simlib
from slam_eslam_tpu_torch.models.asguard import AsguardSim
from slam_eslam_tpu_torch.utils import tree
from slam_eslam_tpu_torch.utils.device import entry_device


def terrain(x, y):
    return 0.15 * np.sin(0.7 * np.asarray(x)) + 0.12 * np.cos(
        0.5 * np.asarray(y))


def demo_config(particles):
    return dataclasses.replace(
        Config(), particle_count=particles, min_effective=particles // 2,
        contact_model=ContactModelConfig(contact_point_radius=0.0,
                                         min_contacts=2))


def record(path, steps):
    """Drive the simulator ``steps`` steps (10 frames each, after the
    start frame) and write contact state, orientation and pose per frame.
    Returns the number of frames."""
    sim = AsguardSim(terrain=terrain)
    t0 = time.time()
    q = [1.0, 0, 0, 0]
    with logio.LogWriter(path) as w:

        def frame(s):
            ts = int((time.time() - t0) * 1e9)
            w.write_contact_state(s.contact_state(), ts)
            w.write_orientation(q, ts)
            w.write_pose(s.position, q, ts)

        frame(sim)
        for _ in range(steps):
            sim.step(wheel_delta=0.3, on_substep=frame)
    return steps * 10 + 1


def replay(path, particles, device=None, draws=None, frames=None,
           log=print, graph=None):
    """Replay the log at ``path`` through the feeder into a shared-map
    filter on ``device`` (the CUDA device unless given).  The first pose
    initialises the filter; every later frame is one ``update_contact``.
    ``draws``: None (the filter's generator), else ``(normals, per_frame)``
    with ``normals = (xy [N, 2], yaw [N])`` and one ``ContactDraws`` per
    update; ``frames``: stop after that many updates.  Returns a dict:
    ``errors`` (xy error of the centroid per update), ``centroids``,
    ``updates`` (how many ran the measurement update), the seconds of
    the replay and those spent waiting for the feeder.  ``graph``: the
    filter's CUDA graphs; None: on the card, and eager on the CPU."""
    cfg = demo_config(particles)
    grid = simlib.terrain_grid(terrain, nx=64, ny=64, resolution=0.25,
                               origin=(-8.0, -8.0))
    device = entry_device(device)
    f = EmbodiedSlamFilter(config=cfg, device=device,
                           graph=(device.type == "cuda" if graph is None
                                  else graph))
    normals, per_frame = ((None, None), None) if draws is None else (
        [n.to(f.device) for n in draws[0]], draws[1])
    errs, cents, updates, wait = [], [], 0, 0.0
    t_start = time.perf_counter()
    with logio.LogReader(path) as reader, \
            logio.AsyncFeeder(reader, slots=8) as feeder:
        cs = q = None
        initialized = False
        while frames is None or len(errs) < frames:
            t0 = time.perf_counter()
            rec = next(feeder, None)
            wait += time.perf_counter() - t0
            if rec is None:
                break
            rec_type, _, payload = rec
            if rec_type == logio.CONTACT_STATE:
                cs = logio.decode_contact_state(payload)
            elif rec_type == logio.ORIENTATION:
                q = logio.decode_orientation(payload)
            elif rec_type == logio.POSE:
                truth, _ = logio.decode_pose(payload)
                if not initialized:
                    f.init(pose=(truth.astype(np.float64), 0.0),
                           shared_grid=grid, use_shared_map=True,
                           normal_xy=normals[0], normal_yaw=normals[1])
                    initialized = True
                    continue
                d = (ContactDraws() if per_frame is None
                     else tree.to(per_frame[len(errs)], f.device))
                updates += f.update_contact((q, truth.astype(np.float64)),
                                            cs, draws=d)
                c_pos, _ = f.get_centroid()
                c = c_pos.cpu().numpy()
                cents.append(c)
                errs.append(float(np.linalg.norm(c[:2] - truth[:2])))
    seconds = time.perf_counter() - t_start
    errs = np.asarray(errs)
    log(f"replayed {len(errs)} frames ({updates} measurement updates) in "
        f"{seconds:.3f} s, {wait / seconds:.1%} of it waiting for the "
        f"feeder; final-20 mean xy err {errs[-20:].mean():.3f} m")
    return dict(errors=errs, centroids=np.stack(cents), updates=updates,
                seconds=seconds, wait=wait)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=15)
    ap.add_argument("--particles", type=int, default=48)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA device")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "traverse.eslg")
        n_rec = record(path, args.steps)
        print(f"recorded {n_rec} frames -> {path} "
              f"({os.path.getsize(path) / 1024:.0f} KiB)")
        return replay(path, args.particles, "cpu" if args.cpu else None)


if __name__ == "__main__":
    main()
