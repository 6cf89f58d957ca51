"""Full SLAM demo: per-particle mapping + laser scans + localisation.

Counterpart of ``examples/slam_demo.py`` of the JAX package: the
``EmbodiedSlamFilter`` in per-particle-map mode over a synthetic world.
The robot rolls forward (kinematic Asguard simulator); a contact update
per sub-step localises against each particle's own map while simulated
laser scans of the surrounding terrain merge into the per-particle maps
(``update_contact`` per sub-step, ``update_scan`` per scan).  Prints the
per-step table, then renders the best particle's map and the particle
cloud to ``--out/slam_demo.png`` and, with ``--snapshot-every N``, the
running filter every N steps to ``--out/frames``; where matplotlib is
not installed the images are skipped with a note.

Run:  python -m slam_eslam_tpu_torch.examples.slam_demo
          [--steps 20] [--particles 24] [--cpu] [--out DIR]
          [--snapshot-every N]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import numpy as np
import torch

from slam_eslam_tpu_torch.config import Config, ContactModelConfig
from slam_eslam_tpu_torch.filter.eslam_filter import EmbodiedSlamFilter
from slam_eslam_tpu_torch.mapping import projection as proj
from slam_eslam_tpu_torch.models.asguard import AsguardSim

N_RAYS = 64


def terrain(x, y):
    return 0.15 * np.sin(0.6 * np.asarray(x)) + 0.1 * np.cos(
        0.5 * np.asarray(y))


def demo_config(particles):
    return dataclasses.replace(
        Config(), particle_count=particles, min_effective=particles // 2,
        grid_size=10.0, grid_resolution=0.25,
        map_pool_blocks=particles + 16, map_chain_length=3,
        contact_model=ContactModelConfig(contact_point_radius=0.0,
                                         min_contacts=2))


def laser_mount():
    """The scanner mounted level, pitched slightly down toward the ground,
    its x axis along the body's y (forward)."""
    pitch = 0.15
    laser_rot = np.array([[np.cos(pitch), 0, np.sin(pitch)],
                          [0, 1, 0],
                          [-np.sin(pitch), 0, np.cos(pitch)]])
    swap = np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]])
    return swap @ laser_rot, np.array([0.0, 0.1, 0.3])


def make_scan(sim, device):
    """Simulate a forward-looking laser: rays in the body xy-plane
    intersected with the terrain (coarse ray-march)."""
    angles = np.linspace(-np.pi / 2, np.pi / 2, N_RAYS) + np.pi / 2
    ranges = np.full(N_RAYS, np.inf, np.float32)
    origin = sim.position + [0, 0, 0.3]   # scanner height above the body
    for i, a in enumerate(angles):
        d_world = np.array([np.cos(a + sim.yaw), np.sin(a + sim.yaw), -0.15])
        d_world /= np.linalg.norm(d_world)
        for t in np.arange(0.3, 4.0, 0.05):
            p = origin + t * d_world
            if p[2] <= terrain(p[0], p[1]):
                ranges[i] = t
                break
    f32 = dict(dtype=torch.float32, device=device)
    return proj.LaserScan(
        ranges=torch.as_tensor(ranges, device=device),
        start_angle=torch.tensor(0.0, **f32),
        angular_resolution=torch.tensor(np.pi / (N_RAYS - 1), **f32))


def main(argv=None):
    """Run the demo; returns the per-step rows ``(step, truth y, xy error,
    mapped, map patches)``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--particles", type=int, default=24)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")
    ap.add_argument("--out",
                    default=os.path.join(tempfile.gettempdir(), "slam_demo"))
    ap.add_argument("--snapshot-every", "--render-every", type=int,
                    default=0, dest="snapshot_every",
                    help="render the running filter every N steps (the "
                    "offline analog of the reference's 10 Hz live viz; "
                    "frames land in --out/frames)")
    args = ap.parse_args(argv)

    f = EmbodiedSlamFilter(config=demo_config(args.particles),
                           device="cpu" if args.cpu else None)
    sim = AsguardSim(terrain=terrain)
    f.init(pose=(np.array([0.0, 0.0, sim.position[2]]), 0.0),
           use_shared_map=False)
    q = np.array([1.0, 0, 0, 0], np.float32)
    laser2body = laser_mount()
    recorder = None
    if args.snapshot_every:
        from slam_eslam_tpu_torch.viz.snapshots import SnapshotRecorder

        recorder = SnapshotRecorder(os.path.join(args.out, "frames"),
                                    every=args.snapshot_every)

    rows = []
    for i in range(args.steps):
        sim.step(wheel_delta=0.3, on_substep=lambda s: f.update_contact(
            (q, s.position.astype(np.float64)), s.contact_state()))
        mapped = f.update_scan((q, sim.position.astype(np.float64)),
                               make_scan(sim, f.device), laser2body)
        if recorder is not None:
            recorder.maybe(f, truth=sim.position)
        c_pos, _ = f.get_centroid()
        err = float(np.linalg.norm(c_pos.cpu().numpy()[:2]
                                   - sim.position[:2]))
        patches = int(f.pool.count_valid())
        rows.append((i, float(sim.position[1]), err, mapped, patches))
        print(f"step {i:3d}  truth y={sim.position[1]:6.2f}  "
              f"xy_err={err:6.3f}  mapped={'*' if mapped else ' '}  "
              f"map_patches={patches}")
    best = f.get_best_particle_index()
    print(f"best particle: {best}")
    render_png(f, best, args.out)
    return rows


def render_png(f, best, out_dir):
    """The best particle's map beside the particle cloud, to
    ``out_dir/slam_demo.png``; skipped where matplotlib is missing."""
    try:
        import matplotlib
    except ImportError as e:
        print(f"(no images: {e})")
        return None
    from slam_eslam_tpu_torch.viz import render

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    fig, axes = plt.subplots(1, 2, figsize=(14, 7))
    render.draw_particle_map(f.pool, best, ax=axes[0])
    axes[0].set_title(f"best particle ({best}) map")
    render.draw_particles(f.state.particles, ax=axes[1], best_index=best)
    axes[1].set_title("particle cloud")
    out = os.path.join(out_dir, "slam_demo.png")
    fig.savefig(out, dpi=110, bbox_inches="tight")
    plt.close(fig)
    print(f"saved {out}")
    return out


if __name__ == "__main__":
    main()
