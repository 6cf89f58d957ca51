"""End-to-end localisation demo through the public API.

Counterpart of ``examples/localize_demo.py`` of the JAX package: a
synthetic terrain MLS map (160x160 cells at 0.1 m), a ground-truth
trajectory, and the particle filter (project -> contact-likelihood
update -> resample) against the map through ``shared_grid_lookup``,
reporting the per-step pose error.  The lookup is the packed shared-grid
select without a fold, so every update takes the unfolded branch: kernel
K5 (``ops.select_cells``) once per step on the card (the JAX demo's
lookup is a plain XLA gather, ``get_patch_packed``).  The JAX demo jits
its step (the odometry fields, ``project``, ``update``, ``centroid``);
here the step is one CUDA graph on the card (``utils.graphs.CallGraphs``,
keyed by the inputs' shapes: eager at its first meeting, captured at its
second, replayed after), eager on the CPU (``graph=`` of ``localize``,
``utils.graphs.resolve``).  The host reads the centroid, the ESS and
whether the step resampled after each step, as the JAX loop does.

Run:  python -m slam_eslam_tpu_torch.examples.localize_demo
          [--steps 40] [--particles 96] [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from slam_eslam_tpu_torch.config import Config, ContactModelConfig
from slam_eslam_tpu_torch.filter import pose_estimator as pe
from slam_eslam_tpu_torch.mapping.lookup import shared_grid_lookup
from slam_eslam_tpu_torch.models import sim as simlib
from slam_eslam_tpu_torch.ops.select_cells import select_cells
from slam_eslam_tpu_torch.utils import geometry, graphs, tree
from slam_eslam_tpu_torch.utils.device import entry_device

INIT_SEED = 7   # the start cloud's seed (the JAX demo's PRNGKey(7))


def terrain(x, y):
    return 0.25 * np.sin(1.3 * np.asarray(x)) + 0.2 * np.cos(
        0.9 * np.asarray(y))


def demo_config(particles):
    return dataclasses.replace(
        Config(), particle_count=particles, min_effective=particles // 2,
        contact_model=ContactModelConfig(contact_point_radius=0.0))


def step_fn(cfg):
    """The demo's step as a function of one tree of tensors (what a CUDA
    graph reads: ``utils.graphs``' static inputs): ``(state, contacts,
    orientation, (delta_xy, delta_yaw, delta_z), (sigma_xy, sigma_1,
    initialized), project draws or None, resampling uniforms or None,
    the lookup's packed tables)`` -> ``(state, centroid [3], ess,
    resampled)``."""

    def step(x):
        (state, cs, q, (d_xy, dyaw, dz), (sigma_xy, sigma_1, initialized),
         proj, resample_u, packed) = x
        o = dataclasses.replace(
            state.odometry, delta_xy=d_xy, delta_yaw=dyaw, delta_z=dz,
            sigma_xy=sigma_xy, sigma_yaw=sigma_1, sigma_z=sigma_1,
            initialized=initialized)
        state = dataclasses.replace(state, odometry=o)
        state = pe.project(state, q, cfg, proj)
        state, aux = pe.update(state, cs, q, shared_grid_lookup(packed), cfg,
                               resample_u)
        c_pos, _ = pe.centroid(state.particles, q)
        return state, c_pos, aux["ess"], aux["resampled"]

    return step


def localize(steps=40, particles=96, device=None, draws=None, log=print,
             graph=None):
    """Run the demo's loop on ``device`` (the CUDA device unless given).
    ``draws``: None (from generators), else ``(init_normals, per_step)``
    with ``init_normals = (xy [N, 2], yaw [N])`` and ``per_step`` one
    ``(pe.ProjectDraws, resample_u [N])`` per step.  ``graph``: the step
    as a CUDA graph (None: on the card, eager on the CPU; False: eager;
    True; or a stand-in).  Returns a dict: ``errors [steps, 2]`` (xy, z),
    ``centroids [steps, 3]``, ``ess`` and ``resampled`` per step, the
    final ``state``, the seconds, the K5 launches (on the card; 0 on the
    CPU, where the plain version runs) and ``graphed``."""
    device = entry_device(device)
    capture = graphs.resolve(graph, device, what="localize")
    cfg = demo_config(particles)
    grid = simlib.terrain_grid(terrain, nx=160, ny=160, resolution=0.1,
                               origin=(-8.0, -8.0), device=device)
    lookup = shared_grid_lookup(grid)
    sim = simlib.TrajectorySim(terrain, speed=0.06)

    state = pe.PoseEstimatorState.create(cfg, 20, device=device)
    if draws is None:
        gen = torch.Generator(device).manual_seed(INIT_SEED)
        normals = (torch.randn((particles, 2), generator=gen, device=device),
                   torch.randn((particles,), generator=gen, device=device))
        per_step = [(None, None)] * steps
    else:
        normals, per_step = tree.to(draws[0], device), draws[1]
    particles_ = pe.init_gaussian(
        cfg.particle_count, sim.position[:2], 0.0, (0.4, 0.4), 0.05,
        sim.position[2], 0.3, normal_xy=normals[0].to(device),
        normal_yaw=normals[1].to(device))
    state = dataclasses.replace(state, particles=particles_)
    f32 = dict(dtype=torch.float32, device=device)
    sigmas = (torch.tensor([0.01, 0.02], **f32), torch.tensor(0.01, **f32),
              torch.ones((), dtype=torch.bool, device=device))
    step = step_fn(cfg)
    # the state's generator draws where no draws are given
    cg = (None if capture is None else graphs.CallGraphs(
        capture, "localize_demo", generator=state.generator))

    log(f"{'step':>4} {'xy_err':>8} {'z_err':>8} {'ess':>7} rs")
    errs, cents, esss, rss = [], [], [], []
    launches0 = select_cells.launches
    t0 = time.perf_counter()
    for i in range(steps):
        (pos, yaw), (d_body, dyaw, dz) = sim.step()
        cs = tree.to(sim.contact_state(noise=0.005), device)
        q = geometry.quat_from_yaw(torch.tensor(yaw, **f32))
        deltas = (torch.tensor(d_body, **f32), torch.tensor(dyaw, **f32),
                  torch.tensor(dz, **f32))
        proj, resample_u = per_step[i]
        x = (state, cs, q, deltas, sigmas,
             None if proj is None else tree.to(proj, device),
             None if resample_u is None else resample_u.to(device),
             lookup.packed)
        state, c_pos, ess, resampled = (step(x) if cg is None
                                        else cg("step", step, x))
        c = np.array(c_pos.tolist())
        xy_err = float(np.linalg.norm(c[:2] - pos[:2]))
        z_err = abs(float(c[2]) - pos[2])
        errs.append((xy_err, z_err))
        cents.append(c)
        esss.append(float(ess))
        rss.append(bool(resampled))
        if i % 5 == 0 or i == steps - 1:
            log(f"{i:>4} {xy_err:8.3f} {z_err:8.3f} {esss[-1]:7.1f} "
                f"{'*' if rss[-1] else ' '}")
    seconds = time.perf_counter() - t0
    errs = np.array(errs)
    log(f"\nfinal-10 mean xy ATE: {errs[-10:, 0].mean():.3f} m "
        f"(initial spread 0.40 m)")
    log(f"final-10 mean z  ATE: {errs[-10:, 1].mean():.3f} m")
    launches = select_cells.launches - launches0
    log(f"{steps} steps in {seconds:.1f}s "
        f"({steps * cfg.particle_count / seconds:.0f} particle-updates/s, "
        f"includes host-side sim); lookup kernel K5 select_cells, "
        f"{launches} launches; "
        + ("graphed (one CUDA graph a step)" if cg is not None else "eager"))
    return dict(errors=errs, centroids=np.stack(cents), ess=esss,
                resampled=rss, state=state, seconds=seconds,
                launches=launches, graphed=cg is not None)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--particles", type=int, default=96)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA device")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    print(f"device: {entry_device(device)}")
    return localize(args.steps, args.particles, device)


if __name__ == "__main__":
    main()
