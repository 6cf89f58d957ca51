"""Per-step spread of the contact-query cloud over the bench trajectory.

Counterpart of ``tools/probe_spread.py`` of the JAX package: the bench's
filter configuration (100,000 particles, the 400x400 grid at 0.05 m,
contacts compacted to 8) over 150 steps, printing per step the x and y
extents, in cells, of the contact-query cloud (the rotated contact points
at every particle), the ESS and whether the step resampled, then the share
of steps whose cloud fits a 128-cell x ``lim`` window.  The measurement
update's lookup is the port's ``make_lookup``: the contact fold, kernel K1
on the card (the tool prints which lookup ran and its launches).  The
port's lookup reads the whole grid, so the fits lines describe the cloud,
not a window the port would need.  The JAX script runs every step in one
jitted ``lax.scan``; here the steps run as a ``utils.graphs.ScanRunner``
on the card (one CUDA graph of the step, replayed), eagerly on the CPU
(``graph=`` of ``spread_run`` and ``main``, ``utils.graphs.resolve``).

Usage: python -m slam_eslam_tpu_torch.tools.probe_spread
           [--particles 100000] [--steps 150] [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

RES = 0.05
LIMS = (24, 32, 48, 64, 96)


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--particles", type=int, default=100_000)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--contact-cap", type=int, default=8,
                    dest="contact_cap")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    return ap


def spread_config(n):
    from slam_eslam_tpu_torch.config import Config, ContactModelConfig

    return dataclasses.replace(
        Config(), particle_count=n, min_effective=n // 5,
        contact_model=ContactModelConfig(contact_point_radius=0.0))


def query_extents(cs, q, particles):
    """The x and y extents, in cells, of the active contact points placed
    at every particle (the JAX script's construction, float for float)."""
    from slam_eslam_tpu_torch.models import contact_model as cm

    cstate = cm.set_contact_points(cs, q)
    rot, trans = particles.pose_matrix()
    px, py, pz = (cstate.position[:, j][:, None] for j in range(3))
    wx = (rot[:, 0, 0][None] * px + rot[:, 0, 1][None] * py
          + rot[:, 0, 2][None] * pz + trans[:, 0][None])
    wy = (rot[:, 1, 0][None] * px + rot[:, 1, 1][None] * py
          + rot[:, 1, 2][None] * pz + trans[:, 1][None])
    act = (cstate.valid & ~(cstate.contact < cm.CONTACT_THRESHOLD))[:, None]
    big = torch.full((), 1e9, device=wx.device)
    sx = (torch.where(act, wx, -big).max() - torch.where(act, wx, big).min()
          ) / RES
    sy = (torch.where(act, wy, -big).max() - torch.where(act, wy, big).min()
          ) / RES
    return sx, sy


def spread_step(cfg, lookup):
    """One step of the probe, ``step(state, (contacts, orientation, draws
    or None)) -> (state, [sx, sy, ess, resampled])``: odometry,
    ``project``, the query cloud's extents and the measurement update."""
    from slam_eslam_tpu_torch.filter import pose_estimator as pe
    from slam_eslam_tpu_torch.filter.step import cfg_odo
    from slam_eslam_tpu_torch.models import odometry as odom

    def step(state, x):
        cs, q, d = x
        state = dataclasses.replace(state, odometry=odom.update(
            state.odometry, cs, q, cfg_odo(cfg)))
        state = pe.project(state, q, cfg, None if d is None else d.project)
        sx, sy = query_extents(cs, q, state.particles)
        state, aux = pe.update(state, cs, q, lookup, cfg,
                               None if d is None else d.resample_u)
        return state, torch.stack([sx, sy, aux["ess"],
                                   aux["resampled"].to(sx.dtype)])

    return step


def spread_run(cfg, lookup, state, css, qs, draws=None, graph=None):
    """Every step (``spread_step``) over the trajectory.  ``draws``: None
    (the state's generator, carried through the graph) or one
    ``filter.step.StepDraws`` per step.  ``graph``: as the port's runners
    take it (None: a CUDA graph of the step on the card, the eager loop
    on the CPU).  Nothing is read back until the end.  Returns ``{"sx",
    "sy", "ess", "resampled"}`` NumPy arrays and ``graphed``."""
    from slam_eslam_tpu_torch.utils import graphs, tree

    step = spread_step(cfg, lookup)
    xs = [(tree.index(css, t), qs[t], None if draws is None else draws[t])
          for t in range(qs.shape[0])]
    capture = graphs.resolve(graph, qs.device, what="spread_run")
    if capture is None:
        rows = []
        for x in xs:
            state, row = step(state, x)
            rows.append(row)
        out = torch.stack(rows)
    else:
        _, (out,) = graphs.ScanRunner(step, capture, "spread_run").run(
            state, xs)
    out = out.cpu().numpy()
    return dict(sx=out[:, 0], sy=out[:, 1], ess=out[:, 2],
                resampled=out[:, 3].astype(bool), graphed=capture is not None)


def main(argv=None, graph=None):
    """Run the probe (``graph``: as ``spread_run`` takes it); returns the
    per-step arrays, the fits shares, the lookup that ran, the kernel
    launches and whether the steps ran graphed."""
    from slam_eslam_tpu_torch import bench, ops
    from slam_eslam_tpu_torch.filter import pose_estimator as pe
    from slam_eslam_tpu_torch.mapping.lookup import make_lookup
    from slam_eslam_tpu_torch.models import sim as simlib
    from slam_eslam_tpu_torch.tools.profile_filter import lookup_name
    from slam_eslam_tpu_torch.utils import profiling, tree
    from slam_eslam_tpu_torch.utils.device import card_line, entry_device

    args = parser().parse_args(argv)
    device = entry_device("cpu" if args.cpu else None)
    n = args.particles
    cfg = spread_config(n)
    grid = simlib.terrain_grid(bench.filter_terrain, **bench.FILTER_GRID,
                               device=device)
    lookup = make_lookup(cfg, grid)
    state = pe.PoseEstimatorState.create(cfg, args.contact_cap,
                                         device=device)
    state = dataclasses.replace(
        state, particles=tree.to(bench.filter_particles(n), device))
    css, qs, _, _ = bench.filter_trajectory(args.steps, args.contact_cap)
    css, qs = tree.to(css, device), qs.to(device)

    print(f"device: {device}" + (f" ({card_line(device)})"
                                 if device.type == "cuda" else ""))
    print(f"lookup: {lookup_name(cfg, lookup)}")
    before = ops.launch_counts()
    t0 = time.perf_counter()
    res = spread_run(cfg, lookup, state, css, qs, graph=graph)
    profiling.sync()
    print(f"compile+run: {time.perf_counter() - t0:.1f}s ("
          + ("graphed: the first step eager, the second captured, the rest "
             "replayed)" if res["graphed"] else "eager)"))
    launches = {k: v - before[k] for k, v in ops.launch_counts().items()}
    print(f"launches: {launches['contact_fold']} contact_fold, "
          f"{launches['select_cells']} select_cells in {args.steps} "
          f"measurement updates")
    sx, sy = res["sx"], res["sy"]
    print("step sx_cells sy_cells ess resampled")
    for i in range(args.steps):
        print(f"{i:4d} {sx[i]:8.1f} {sy[i]:8.1f} "
              f"{res['ess'][i]:10.0f} {int(res['resampled'][i])}")
    fits = {}
    for lim in LIMS:
        fits[lim] = float(np.mean((sx < 128) & (sy < lim)))
        print(f"# fits (128, {lim}): {fits[lim] * 100:.0f}% of steps")
    return dict(res, fits=fits, lookup=lookup_name(cfg, lookup),
                launches=launches, updates=args.steps)


if __name__ == "__main__":
    main()
