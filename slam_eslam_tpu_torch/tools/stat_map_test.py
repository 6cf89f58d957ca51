"""Statistical z-estimation / map-building harness.

Counterpart of ``tools/stat_map_test.py`` of the JAX package, the replica
of the reference's benchmark rig (``test/testMap.cpp``: ``StatMapTest``
batch mode, configs ``test/map/exp1.conf`` / ``contact.conf``):
Monte-Carlo runs of the 1-robot z-drift + contact-correction +
map-building loop on flat ground, aggregating per-step statistics into a
whitespace result file with the column layout the reference's gnuplot
script documents (``test/map/res.plot``):

  col 1 step, 2 forward distance, 3 height-error mean, 4 height-error
  stdev, 5 sqrt(z variance), 6 map height mean, 7 map height stdev,
  8 map patch stdev, 9 height-error min, 10 height-error max

It is the one caller that drives the single-grid write side
(``mls_grid.merge_points``) with the contact model in a loop.  The loop
is driven from the host, step by step, as the reference's is; the noise
comes from one explicit ``numpy`` generator per run, seeded as in the JAX
tool, so both draw the same numbers.  The JAX tool jits the z evaluation
(``eval_step``); here it is one CUDA graph on the card
(``utils.graphs.CallGraphs``: eager at its first meeting, captured at its
second, replayed after), eager on the CPU (``graph=`` of ``run_batch`` and
``main``, ``utils.graphs.resolve``).  ``merge_points`` replaces the grid
on every step, so the grid goes into the graph's static inputs at each
call; the map building stays eager, and the host reads whether the
evaluation was used after the call, as in the JAX tool.

Modes (like the reference): ``batch`` (default) and ``contact``
(empirical pdf/cdf histograms -> contact.dat/nocontact.dat/pdfcdf.dat).

Usage: python -m slam_eslam_tpu_torch.tools.stat_map_test batch
           [--steps 200 --runs 50] [--cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from slam_eslam_tpu_torch.config import ContactModelConfig
from slam_eslam_tpu_torch.mapping import mls_grid
from slam_eslam_tpu_torch.models import asguard
from slam_eslam_tpu_torch.models import contact_model as cm
from slam_eslam_tpu_torch.utils import geometry, graphs, tree
from slam_eslam_tpu_torch.utils.device import entry_device


def make_eval_step(sigma_body, cfg, device, graph=None):
    """The z evaluation ``eval_step(cstate, grid, z_pos, z_var) -> (z_pos,
    z_var, used)`` (device tensors in and out, no host read), one CUDA
    graph on the card (``graph``: as the port's runners take it; None:
    graphed on the card, eager on the CPU).  Every tensor it reads goes in
    as a static input, so a grid replaced between calls is read anew."""
    f32 = dict(dtype=torch.float32, device=device)
    consts = (torch.eye(3, **f32), torch.tensor([0.0, 0.0, 1.0], **f32))

    def evaluate(x):
        cstate, grid, z_pos, z_var, (rot, up) = x
        lookup = lambda pts: mls_grid.get_patch(grid, pts, 1e9)
        res = cm.evaluate_pose(cstate, rot, up * z_pos,
                               sigma_body ** 2 + z_var, lookup, cfg)
        _, new_z, new_var = cm.update_z_position_estimate(res, z_pos, z_var)
        use = res.measurement_valid
        return (torch.where(use, new_z, z_pos),
                torch.where(use, new_var, z_var), use)

    capture = graphs.resolve(graph, device, what="stat_map_test")
    cg = (None if capture is None
          else graphs.CallGraphs(capture, "stat_map_test"))

    def eval_step(cstate, grid, z_pos, z_var):
        x = (cstate, grid, z_pos, z_var, consts)
        if cg is None:
            return evaluate(x)
        # the grid's resolution is baked into the graph
        return cg(("eval_step", grid.resolution), evaluate, x)

    eval_step.graphs = cg
    return eval_step


def run_batch(args, graph=None):
    """The batch experiment; writes the result file (or the raw arrays,
    ``--save-raw``) and returns the raw arrays and, under ``"graphs"``,
    the evaluation's graph counts (``CallGraphs.counts``; None when
    eager).  ``graph``: the evaluation's, as ``make_eval_step`` takes
    it."""
    device = entry_device("cpu" if args.cpu else None)
    cfg = ContactModelConfig(
        min_contacts=args.min_contacts,
        contact_likelihood_correction=args.sigma_factor,
        contact_point_radius=0.0,
    )
    f32 = dict(dtype=torch.float32, device=device)
    eval_step = make_eval_step(args.sigma_body, cfg, device, graph)

    steps = args.steps
    height_err = np.zeros((args.runs, steps))
    z_vars = np.zeros((args.runs, steps))
    forward = np.zeros(steps)
    map_z = np.full((args.runs, steps), np.nan)
    map_sd = np.full((args.runs, steps), np.nan)

    q = geometry.quat_identity(device=device)

    for run in range(args.runs):
        print(f"run {run}     ", end="\r", file=sys.stderr)
        # per-run generator: runs are independent of batching, so a
        # 500-run experiment can be split across processes
        # (--run-offset) and merged (--save-raw + merge_raw)
        rng = np.random.default_rng(
            100003 * args.seed + args.run_offset + run)
        sim = asguard.AsguardSim()
        grid = mls_grid.MLSGrid.create(200, 200, 0.05, (-5.0, 0.0), k=1,
                                       device=device)
        z_pos = sim.position[2]
        z_var = 0.0
        last_y = 0.0
        ones = torch.ones(50, dtype=torch.bool, device=device)
        for i in range(steps):
            z_prev = sim.position[2]
            sim.step(wheel_delta=0.1)
            z_delta = sim.position[2] - z_prev
            # drift the z belief (testMap.cpp:262-268)
            z_pos += z_delta + rng.normal() * args.sigma_step
            z_var += args.sigma_step ** 2

            cstate = cm.set_contact_points(
                tree.to(sim.contact_state(), device), q)
            y_pos = sim.position[1]
            if (last_y + 0.05) < y_pos:
                z_post, z_vart, used = eval_step(
                    cstate, grid, torch.tensor(z_pos, **f32),
                    torch.tensor(z_var, **f32))
                if bool(used):
                    z_pos, z_var = float(z_post), float(z_vart)
                    last_y = y_pos

            # map building: a lateral row of synthetic height
            # measurements 1 m ahead (testMap.cpp:291-318)
            xs = (np.arange(50) - 25.0) * 0.02
            meas = np.stack(
                [xs + sim.position[0],
                 np.full(50, 1.0 + sim.position[1]),
                 np.full(50, z_pos - sim.position[2]
                         + rng.normal(0, args.sigma_sensor, 1)[0])], axis=1)
            sigma = np.sqrt(args.sigma_sensor ** 2 + z_var)
            meas_t = torch.as_tensor(meas, **f32)
            grid = mls_grid.merge_points(
                grid, meas_t[:, :2], meas_t[:, 2],
                torch.full((50,), sigma, **f32), ones, i)

            height_err[run, i] = z_pos - sim.position[2]
            z_vars[run, i] = z_var
            forward[i] = sim.position[1]
            f, m, s, _ = mls_grid.get_patch(
                grid, torch.as_tensor(sim.position, **f32)[None, :], 1e9)
            if bool(f[0]):
                map_z[run, i] = float(m[0])
                map_sd[run, i] = float(s[0])

    raw = dict(height_err=height_err, z_vars=z_vars, forward=forward,
               map_z=map_z, map_sd=map_sd)
    if args.save_raw:
        np.savez(args.save_raw, **raw)
        print(f"\nwrote {args.save_raw}", file=sys.stderr)
    else:
        _write_result(args.result_file, height_err, z_vars, forward,
                      map_z, map_sd)
    cg = eval_step.graphs
    return dict(raw, graphs=None if cg is None else cg.counts())


def _write_result(path, height_err, z_vars, forward, map_z, map_sd):
    steps = height_err.shape[1]
    with open(path, "w") as out:
        for i in range(steps):
            he = height_err[:, i]
            out.write(
                f"{i} {forward[i]} {he.mean()} {he.std()} "
                f"{np.sqrt(z_vars[:, i].mean())} "
                f"{np.nanmean(map_z[:, i])} {np.nanstd(map_z[:, i])} "
                f"{np.nanmean(map_sd[:, i])} {he.min()} {he.max()}\n"
            )
    print(f"\nwrote {path}", file=sys.stderr)
    print(
        f"final height error: {height_err[:, -1].mean():.4f} "
        f"+- {height_err[:, -1].std():.4f} m "
        f"({height_err.shape[0]} runs x {steps} steps)"
    )


def merge_raw(args):
    """Merge per-shard --save-raw npz files into the result file."""
    import glob

    files = sorted(glob.glob(args.merge_raw))
    if not files:
        raise SystemExit(f"no raw shards match {args.merge_raw}")
    parts = [np.load(f) for f in files]
    cat = lambda k: np.concatenate([p[k] for p in parts], axis=0)
    _write_result(
        args.result_file, cat("height_err"), cat("z_vars"),
        parts[0]["forward"], cat("map_z"), cat("map_sd"),
    )


def run_contact(args):
    """Empirical contact/no-contact z histograms vs the pdf/cdf model
    (``ContactMeasurementTest``, ``testMap.cpp:106-178``)."""
    rng = np.random.default_rng(args.seed)
    sim = asguard.AsguardSim()
    edges = np.linspace(-0.1, 0.5, 101)
    contact = np.zeros(100)
    nocontact = np.zeros(100)
    for i in range(args.steps):
        sim.step(wheel_delta=0.1)
        feet = sim._to_world(
            sim.config.foot_positions(sim.wheel_pos)
        )
        for z in feet[:5, 2]:  # one wheel's feet
            has = abs(z) < 1e-3
            zn = z + rng.normal() * args.sigma_step
            b = np.searchsorted(edges, zn) - 1
            if 0 <= b < 100:
                (contact if has else nocontact)[b] += 1
    scale = (contact.sum() + nocontact.sum()) * (edges[1] - edges[0])
    centers = 0.5 * (edges[:-1] + edges[1:])
    np.savetxt("contact.dat", np.stack([centers, contact / scale], 1))
    np.savetxt("nocontact.dat", np.stack([centers, nocontact / scale], 1))
    from scipy.stats import norm as _norm

    model = _norm.pdf(centers, 0, args.sigma_step) / _norm.cdf(
        centers, 0, args.sigma_step
    )
    ratio = np.where(nocontact > 0, contact / np.maximum(nocontact, 1),
                     np.nan)
    np.savetxt("pdfcdf.dat", np.stack([centers, ratio, model], 1))
    print("wrote contact.dat nocontact.dat pdfcdf.dat")


def main(argv=None, graph=None):
    """The command line; ``graph``: the evaluation's (``run_batch``).
    Returns ``run_batch``'s raw arrays in batch mode, else None."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", nargs="?", default="batch",
                    choices=["batch", "contact"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--sigma-step", type=float, default=0.002,
                    dest="sigma_step")
    ap.add_argument("--sigma-body", type=float, default=0.05,
                    dest="sigma_body")
    ap.add_argument("--sigma-sensor", type=float, default=0.02,
                    dest="sigma_sensor")
    ap.add_argument("--sigma-factor", type=float, default=0.33,
                    dest="sigma_factor")
    ap.add_argument("--min-contacts", type=int, default=3,
                    dest="min_contacts")
    ap.add_argument("--result-file", default="stat_map_result.dat",
                    dest="result_file")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--run-offset", type=int, default=0,
                    dest="run_offset",
                    help="per-run seed offset (process-parallel shards)")
    ap.add_argument("--save-raw", default=None, dest="save_raw",
                    help="write raw per-run arrays (npz) instead of the "
                    "aggregated result file")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")
    ap.add_argument("--merge-raw", default=None, dest="merge_raw",
                    help="glob of raw npz shards to merge into "
                    "--result-file (no simulation)")
    args = ap.parse_args(argv)
    if args.merge_raw:
        merge_raw(args)
    elif args.mode == "batch":
        return run_batch(args, graph)
    else:
        run_contact(args)


if __name__ == "__main__":
    main()
