"""Offline closure/backend lab on a ``full_demo --save-graph`` dump.

Counterpart of the JAX package's ``tools/closure_lab.py``.  Loop closures
on a long out-and-back route can lock across the track but slip along it
(a self-similar strip), and a non-robust Gauss-Newton solve then makes
the keyframe ATE worse.  This lab re-optimises the dumped graph under
edge-selection and robust-kernel policies without re-running the drive:

  none        all closure edges, robust=None (what the demo does)
  huber       Huber kernel, delta sweep
  dcs         Dynamic Covariance Scaling, delta sweep
  median      consistency gate: keep closures whose implied world
              correction agrees with the local median within --consist m,
              then robust=None on the survivors
  median+dcs  both
  s>=,r>=     the score/ratio gates of KeyframeManager, swept
  oracle      ground-truth gate (edge relative error < 0.75 m): the upper
              bound any gate could reach
  np ...      the same without the absolute yaw priors, and a sweep of
              the odometry chain's relative-yaw stiffness

Edges are classified by their xy information (``classify_edges``):
odometry is consecutive with xy information, a yaw prior has none, a
closure is non-consecutive with it.  The JAX lab counted every
consecutive edge as odometry, which took the keyframe-0 -> node-1 yaw
prior for odometry: ``yaw_scale`` softened that prior and ``priors=False``
kept it.

Runs on the CUDA device unless given ``--cpu``.

Usage: python -m slam_eslam_tpu_torch.tools.closure_lab graph.npz [--cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from slam_eslam_tpu_torch.backend import pose_graph as pgr
from slam_eslam_tpu_torch.examples.full_demo import FALSE_CLOSURE_M, rel2d
from slam_eslam_tpu_torch.utils.device import entry_device

GRAPH_FIELDS = ("nodes", "node_valid", "edge_i", "edge_j", "edge_z",
                "edge_info", "edge_valid")


def classify_edges(edge_i, edge_j, edge_info):
    """Indices of the odometry, yaw-prior and closure edges among the
    given (valid) edges: odometry joins consecutive nodes and carries xy
    information, a prior carries none (``diag(0, 0, w)``), a closure joins
    non-consecutive nodes with xy information."""
    xy = np.asarray(edge_info)[:, 0, 0] > 0
    consecutive = (np.asarray(edge_j) - np.asarray(edge_i)) == 1
    return dict(odometry=np.nonzero(consecutive & xy)[0],
                prior=np.nonzero(~xy)[0],
                closure=np.nonzero(~consecutive & xy)[0])


def closure_errors(d):
    """Each closure edge's relative pose against the true relative pose
    of its two keyframes (m)."""
    tp = d["kf_truth"][:, [0, 1, 3]]
    return np.array([
        np.linalg.norm(rel2d(d["kf_poses"][int(o)], corr)[:2]
                       - rel2d(tp[int(o)], tp[int(nw)])[:2])
        for (o, nw, _s, _r), corr in zip(d["closures"], d["corrected"])])


def median_gate(d, consist):
    """Keep a closure whose implied world correction (its drift estimate
    at the new keyframe: smooth in time for true closures, jumpy for
    along-track slips) is within ``consist`` m of its neighbours'
    median."""
    closures = d["closures"]
    keep = np.ones(len(closures), bool)
    if len(closures) >= 3:
        deltas = (d["corrected"][:, :2]
                  - d["kf_poses"][closures[:, 1].astype(int), :2])
        med = np.stack([np.median(deltas[max(0, i - 2):i + 3], axis=0)
                        for i in range(len(closures))])
        keep = np.linalg.norm(deltas - med, axis=1) <= consist
    return keep


def policies(d, consist):
    """The lab's policies in the JAX lab's order: ``(name, keep [C] bool,
    robust, delta, priors, yaw_scale)``."""
    closures = d["closures"]
    good = closure_errors(d) < FALSE_CLOSURE_M
    everything = np.ones(len(closures), bool)
    nothing = np.zeros(len(closures), bool)
    count = lambda k: f"({(k & good).sum()}g/{(k & ~good).sum()}f)"
    out = [("none", everything, None, 1.0, True, 1.0)]
    for delta in (0.5, 1.0, 2.0, 4.0):
        out += [(f"huber d={delta}", everything, "huber", delta, True, 1.0),
                (f"dcs d={delta}", everything, "dcs", delta, True, 1.0)]
    mk = median_gate(d, consist)
    out += [(f"median c={consist}", mk, None, 1.0, True, 1.0),
            ("median+dcs d=1", mk, "dcs", 1.0, True, 1.0),
            ("median+huber d=1", mk, "huber", 1.0, True, 1.0)]
    # the score/ratio gates KeyframeManager applies at closure time,
    # swept offline for the operating point to bake into the defaults
    for ms, mr in ((0.3, 1.25), (0.35, 1.25), (0.3, 1.3), (0.4, 1.2),
                   (0.3, 1.2)):
        gk = (closures[:, 2] >= ms) & (closures[:, 3] >= mr)
        gm = gk & mk
        out += [(f"s>={ms},r>={mr} {count(gk)}", gk, None, 1.0, True, 1.0),
                (f"s/r+median {count(gm)}", gm, None, 1.0, True, 1.0)]
    out += [("oracle", good, None, 1.0, True, 1.0),
            ("no-closures", nothing, None, 1.0, True, 1.0),
            # without the absolute yaw priors: do they help once the
            # closure set is clean?
            ("np none", everything, None, 1.0, False, 1.0)]
    out += [(f"np dcs d={delta}", everything, "dcs", delta, False, 1.0)
            for delta in (0.5, 1.0)]
    gk = (closures[:, 2] >= 0.3) & (closures[:, 3] >= 1.25)
    out += [(f"np s/r {count(gk)}", gk, None, 1.0, False, 1.0),
            ("np s/r+dcs d=1", gk, "dcs", 1.0, False, 1.0),
            ("np oracle", good, None, 1.0, False, 1.0),
            ("np no-closures", nothing, None, 1.0, False, 1.0)]
    # the odometry chain's relative-yaw stiffness: can the chain absorb a
    # closure correction as rotation instead of xy distortion?
    for ys in (0.3, 0.1, 0.03, 0.01):
        out += [(f"np s/r yawx{ys}", gk, None, 1.0, False, ys),
                (f"np orc yawx{ys}", good, None, 1.0, False, ys)]
    return out


def masked_graph(d, classes, keep, priors=True, yaw_scale=1.0):
    """The dump's graph (NumPy fields) with the closures ``keep`` drops
    switched off, the priors too without ``priors``, and the odometry
    edges' relative-yaw information scaled by ``yaw_scale``."""
    g = {name: d[name].copy() for name in GRAPH_FIELDS}
    g["edge_valid"][classes["closure"][~keep]] = False
    if not priors:
        g["edge_valid"][classes["prior"]] = False
    if yaw_scale != 1.0:
        g["edge_info"][classes["odometry"], 2, 2] *= yaw_scale
    return g


def optimize(g, solver, iters, robust, delta, device):
    """One solve of a NumPy graph on ``device``: ``(nodes [M, D], chi2
    history)`` as NumPy."""
    graph = pgr.PoseGraph(**{name: torch.from_numpy(np.asarray(g[name]))
                             .to(device) for name in GRAPH_FIELDS})
    opt = pgr.optimize_schur if solver == "schur" else pgr.optimize
    out, hist = opt(graph, iters=iters, robust=robust, robust_delta=delta)
    return out.nodes.cpu().numpy(), hist.cpu().numpy()


def load(path):
    with np.load(path) as z:
        return {name: z[name] for name in z.files}


def lab(d, iters=20, consist=1.0, solver="dense", device=None, log=print):
    """Every policy on the dump ``d`` (a dict of its arrays), in
    ``policies`` order.  Returns ``[(name, kf ATE after, chi2 history)]``
    (two policies that keep the same closures may share a name: both
    rows stay)."""
    device = entry_device(device)
    n_nodes = int(d["node_valid"].sum())
    n_edges = int(d["edge_valid"].sum())
    classes = classify_edges(d["edge_i"][:n_edges], d["edge_j"][:n_edges],
                             d["edge_info"][:n_edges])
    errs = closure_errors(d)
    # closures and closure edges share their insertion order
    if len(classes["closure"]) != len(errs):
        raise ValueError(f"{len(classes['closure'])} closure edges for "
                         f"{len(errs)} closures in the dump")
    kf_truth = d["kf_truth"]
    ate = lambda nodes: float(np.linalg.norm(
        nodes[:n_nodes, :2] - kf_truth[:, :2], axis=1).mean())
    good = errs < FALSE_CLOSURE_M
    log(f"{n_nodes} nodes, {n_edges} edges ({len(classes['odometry'])} "
        f"odometry, {len(classes['prior'])} yaw priors), {len(errs)} "
        f"closures ({good.sum()} good by truth), kf ATE before "
        f"{ate(d['nodes']):.3f} m")
    mk = median_gate(d, consist)
    log(f"median gate keeps {mk.sum()}/{len(errs)} ({(mk & good).sum()} "
        f"good, {(mk & ~good).sum()} false kept)")
    results = []
    for name, keep, robust, delta, priors, yaw_scale in policies(d, consist):
        nodes, hist = optimize(
            masked_graph(d, classes, keep, priors, yaw_scale), solver,
            iters, robust, delta, device)
        results.append((name, ate(nodes), hist))
    for name, after, hist in results:
        log(f"{name:20s} kf ATE after {after:7.3f} m   chi2 "
            f"{float(hist[-1]):10.1f}")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dump")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--consist", type=float, default=1.0)
    ap.add_argument("--solver", default="dense", choices=["dense", "schur"])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA device")
    args = ap.parse_args(argv)
    return lab(load(args.dump), args.iters, args.consist, args.solver,
               "cpu" if args.cpu else None)


if __name__ == "__main__":
    main()
