"""The rank side of the port's multi-rank tests.

Each function here runs on every rank of a world started by
``slam_eslam_tpu_torch.parallel.distributed.run_world`` (gloo, CPU) and
returns NumPy results; the test modules build the inputs with the JAX
package in the parent process, start one world per module and hold each
case's results against the JAX single-device functions.  This module
imports neither JAX nor the JAX package, so a rank starts in seconds.
"""

import dataclasses

import numpy as np
import torch

from slam_eslam_tpu_torch.parallel import resample as dres
from slam_eslam_tpu_torch.parallel import sharding as shd
from slam_eslam_tpu_torch.utils import tree


def _np(t):
    return t.detach().cpu().numpy()


def _gather(mesh, t):
    return _np(mesh.all_gather(t))


# ---------------------------------------------------------------------------
# tests/test_torch_parallel.py
# ---------------------------------------------------------------------------

def _resample_cases(mesh, inp):
    out = {}
    w = torch.from_numpy(inp["shard_map_w"])
    idx, ess = dres.resample_shard_map(torch.tensor(inp["shard_map_u"]),
                                       mesh.local(w), mesh)
    out["shard_map"] = (_gather(mesh, idx), float(ess))
    w = torch.from_numpy(inp["sharded_w"])
    idx, ess = dres.resample_sharded(torch.tensor(inp["sharded_u"]),
                                     mesh.local(w), mesh)
    out["sharded"] = (_gather(mesh, idx), float(ess))
    idx, ess = dres.resample_shard_map(torch.tensor(inp["shard_map_u"]),
                                       mesh.local(torch.zeros(64)), mesh)
    out["degenerate"] = (_gather(mesh, idx), float(ess))
    payload = {"xy": torch.arange(64.0)[:, None] * torch.ones(1, 2),
               "map_id": torch.arange(64, dtype=torch.int32)}
    local = {k: mesh.local(v) for k, v in payload.items()}
    for name, wc in inp["ppermute_w"].items():
        moved, idxg, ess = dres.resample_ppermute(
            torch.tensor(inp["ppermute_u"]), mesh.local(torch.from_numpy(wc)),
            local, mesh)
        out[f"ppermute_{name}"] = (
            _gather(mesh, idxg), _gather(mesh, moved["map_id"]),
            _gather(mesh, moved["xy"]), float(ess))
    moved, idxg, _ = dres.resample_ppermute(
        torch.from_numpy(inp["stratified_u"]),
        mesh.local(torch.from_numpy(inp["stratified_w"])),
        {"i": mesh.local(torch.arange(64, dtype=torch.int32))}, mesh,
        scheme="stratified")
    out["stratified"] = (_gather(mesh, idxg), _gather(mesh, moved["i"]))
    out["hops"] = mesh.reads["ppermute h_max"]
    return out


def _step_cases(mesh, inp):
    from slam_eslam_tpu_torch.filter import step as steplib
    from slam_eslam_tpu_torch.mapping.lookup import make_lookup

    cfg, state, cs, q, draws = (inp["cfg"], inp["state"], inp["contact"],
                                inp["q"], inp["draws"])
    lookup = make_lookup(cfg, inp["grid"], mesh)
    gate = (np.float32(1.0), np.float32(0.0))
    sh = shd.shard_state(state, mesh)
    out = {}
    got, aux = steplib.make_filter_step(cfg, lookup, mesh=mesh)(
        sh, cs, q, gate, draws)
    full = shd.gather_state(got, mesh).particles
    out["meshed"] = {"weight": _np(full.weight), "xy": _np(full.xy),
                     "ess": float(aux["ess"])}
    # the ring-hop resampler against the gather in the same forced step
    forced = dataclasses.replace(cfg, min_effective=float(cfg.particle_count))
    plain, _ = steplib.make_filter_step(forced, lookup, mesh=mesh)(
        sh, cs, q, gate, draws)
    ring, _ = steplib.make_filter_step(
        forced, lookup, mesh=mesh,
        resampler=dres.make_ppermute_resampler(mesh))(sh, cs, q, gate, draws)
    a = shd.gather_state(plain, mesh).particles
    b = shd.gather_state(ring, mesh).particles
    out["ppermute_step"] = {"weight": (_np(a.weight), _np(b.weight)),
                            "xy": (_np(a.xy), _np(b.xy))}
    # the lookup on this rank's share of a query cloud
    pts = torch.from_numpy(inp["points"])
    found, mean, _, _ = make_lookup(cfg, inp["window_grid"], mesh)(
        None, mesh.local(pts))
    out["lookup"] = (_gather(mesh, found), _gather(mesh, mean))
    return out


def _discount_case(mesh, inp):
    """``discount_terms`` on the mesh (the factors gathered) and in one
    process on every particle."""
    from slam_eslam_tpu_torch.filter.pose_estimator import discount_terms

    valid, meas, n_contacts = (torch.from_numpy(a) for a in inp["discount"])
    meshed = discount_terms(mesh.local(valid), mesh.local(meas),
                            mesh.local(n_contacts), 0.9, mesh)
    single = discount_terms(valid, meas, n_contacts, 0.9)
    return ((_gather(mesh, meshed[0]), _np(meshed[1]), _np(meshed[2])),
            tuple(_np(t) for t in single))


def parallel_cases(mesh, inp):
    """Every case of ``tests/test_torch_parallel.py`` on one world."""
    from slam_eslam_tpu_torch.dryrun import _filter_check

    return {"resample": _resample_cases(mesh, inp),
            "step": _step_cases(mesh, inp),
            "discount": _discount_case(mesh, inp),
            "dryrun_filter": _filter_check(mesh, max(8 * mesh.size, 64)),
            "describe": mesh.describe()}


# ---------------------------------------------------------------------------
# tests/test_torch_parallel_slam.py
# ---------------------------------------------------------------------------

def _slam_run(cfg, carry, frames, draws, mesh, colocated):
    from slam_eslam_tpu_torch.filter import streaming

    st = carry.filter
    pool = carry.pool
    if mesh is not None:
        st = shd.shard_state(st, mesh)
        pool = (shd.shard_pool(pool, mesh) if colocated
                else dataclasses.replace(pool,
                                         chain=mesh.local(pool.chain).clone()))
    c = streaming.StreamingState.create(st, pool, steps=carry.steps)
    run = streaming.make_slam_scan_runner(cfg, mesh=mesh)
    c, aux = run(c, frames, draws=draws)
    rows = c.pool.mean.shape[0]
    state = shd.gather_state(c.filter, mesh)
    pool = shd.gather_pool(c.pool, mesh) if mesh is not None else c.pool
    return {"weight": _np(state.particles.weight), "chain": _np(pool.chain),
            "mean": _np(pool.mean), "valid": _np(pool.valid),
            "meta": _np(pool.meta), "centroid": _np(aux["centroid"]),
            "rows": rows, "alloc_failed": int(c.alloc_failed),
            "mapped": int(aux["mapped"].sum()),
            "updated": int(aux["updated"].sum())}


def slam_cases(mesh, inp):
    """Every case of ``tests/test_torch_parallel_slam.py``: each config
    run on the mesh and, on rank 0 only, in one process (the bit-for-bit
    comparison)."""
    out = {}
    for name, case in inp.items():
        fresh = lambda: tree.tree_map(torch.clone, case["carry"])
        before, moved = dict(mesh.reads), dict(mesh.remote)
        meshed = _slam_run(case["cfg"], fresh(), case["frames"],
                           case["draws"], mesh, case["colocated"])
        single = (_slam_run(case["cfg"], fresh(), case["frames"],
                            case["draws"], None, False)
                  if mesh.rank == 0 else None)
        out[name] = {"meshed": meshed, "single": single,
                     "reads": {k: v - before.get(k, 0)
                               for k, v in mesh.reads.items()},
                     "remote": {k: v - moved.get(k, 0)
                                for k, v in mesh.remote.items()}}
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_parallel_pose_graph.py
# ---------------------------------------------------------------------------

def pose_graph_cases(mesh, inp):
    from slam_eslam_tpu_torch.backend import pose_graph as pgr

    out = {}
    for dim in (3, 4):
        g = inp[f"cg_{dim}"]
        gs, _ = pgr.optimize_cg(g, 15, cg_iters=64, mesh=mesh)
        gl, _ = pgr.optimize_cg(g, 15, cg_iters=64)
        out[f"cg_{dim}"] = (_np(gs.nodes), _np(gl.nodes))
    g = inp["schur"]
    gs, _ = pgr.optimize_schur(g, 12, segments=8, boundary_cap=32, mesh=mesh)
    gl, _ = pgr.optimize_schur(g, 12, segments=8, boundary_cap=32)
    out["schur"] = (_np(gs.nodes), _np(gl.nodes))
    return out
