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
        mesh.asked.clear()    # the exchanges this case issues
        moved = dict(mesh.remote)
        meshed = _slam_run(case["cfg"], fresh(), case["frames"],
                           case["draws"], mesh, case["colocated"])
        single = (_slam_run(case["cfg"], fresh(), case["frames"],
                            case["draws"], None, False)
                  if mesh.rank == 0 else None)
        out[name] = {"meshed": meshed, "single": single,
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


# ---------------------------------------------------------------------------
# tests/test_torch_mesh_graphs.py
# ---------------------------------------------------------------------------

def _since(mesh, before):
    """The rows asked of other ranks since ``before`` (a copy of
    ``mesh.remote``), by name."""
    return {k: v - before.get(k, 0) for k, v in mesh.remote.items()
            if v != before.get(k, 0)}


def _leaves(tree_):
    from slam_eslam_tpu_torch.utils import graphs

    return [_np(t) for t in graphs.leaves(tree_)]


def _equal(a, b):
    """Every leaf of ``a`` equal to ``b``'s bit for bit."""
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and x.tobytes() == y.tobytes() for x, y in zip(la, lb))


def _graphed_filter_steps(mesh, n, resampler, steps=4):
    """``make_filter_step`` on the mesh through the stand-in and eagerly,
    every measurement resampling: whether they are equal, and the
    stand-in's replays."""
    from slam_eslam_tpu_torch.dryrun import GATE, _build, step_draws
    from slam_eslam_tpu_torch.filter import step as steplib
    from torch_stand_in import StandIn

    cfg, lookup, state, cs, q = _build(n, nx=32, ny=32, device=mesh.device,
                                       mesh=mesh)
    cfg = dataclasses.replace(cfg, min_effective=float(n))
    hook = (lambda: None) if not resampler else (
        lambda: dres.make_ppermute_resampler(mesh))
    out = {}
    for mode in ("eager", "graphed"):
        stand_in = StandIn() if mode == "graphed" else False
        fn = steplib.make_filter_step(cfg, lookup, mesh=mesh,
                                      resampler=hook(), graph=stand_in)
        st = shd.shard_state(state, mesh)
        seq = []
        for t in range(steps):
            st, aux = fn(st, cs, q, GATE, step_draws(n, mesh.device, 11 + t))
            seq.append((shd.gather_state(st, mesh).particles, aux["ess"]))
        out[mode] = seq
    return {"equal": _equal(out["eager"], out["graphed"]),
            "replayed": stand_in.replays}


def _graphed_scan_runner(mesh, n, steps=3):
    from slam_eslam_tpu_torch.dryrun import _build, step_draws
    from slam_eslam_tpu_torch.filter import step as steplib
    from torch_stand_in import StandIn

    cfg, lookup, state, cs, q = _build(n, nx=32, ny=32, device=mesh.device,
                                       mesh=mesh)
    css, qs = tree.stack([cs] * steps), torch.stack([q] * steps)
    draws = [step_draws(n, mesh.device, 3 + t) for t in range(steps)]
    res = {}
    for mode, g in (("eager", False), ("graphed", StandIn())):
        run = steplib.make_scan_runner(cfg, lookup, mesh=mesh, graph=g)
        st, cents = run(shd.shard_state(state, mesh), css, qs, draws)
        res[mode] = (shd.gather_state(st, mesh).particles, cents)
    return {"equal": _equal(res["eager"], res["graphed"]),
            "counts": run.graphs.counts()}


def _dryrun_slam(cfg, frames, z0, mesh, graph, colocated):
    """``dryrun.slam_run`` on the mesh with the runner's ``graph``, the
    pool split (``colocated``) or held whole with this rank's chain
    rows."""
    from slam_eslam_tpu_torch.dryrun import slam_filter, step_draws
    from slam_eslam_tpu_torch.filter import streaming

    f = slam_filter(cfg, z0, mesh.device)
    pool = (shd.shard_pool(f.pool, mesh) if colocated
            else dataclasses.replace(
                f.pool, chain=mesh.local(f.pool.chain).clone()))
    run = streaming.make_slam_scan_runner(
        cfg, laser2body=(np.eye(3), np.zeros(3)), mesh=mesh, graph=graph)
    return run(streaming.StreamingState.create(
        shd.shard_state(f.state, mesh), pool), frames, draws=[
        step_draws(cfg.particle_count, mesh.device, 21 + t)
        for t in range(len(frames))])


def _graphed_slam(mesh, n, drive, colocated):
    """The SLAM runner on ``drive`` through the stand-in and eagerly, the
    pool split (``colocated``) or whole on every rank, and the rows each
    run asked of other ranks (the stand-in restores the mesh's counters
    at its capture, as a capture on the card adds nothing to them)."""
    from slam_eslam_tpu_torch.dryrun import (SLAM_DRIVES, slam_config,
                                             slam_frames)
    from torch_stand_in import StandIn

    fields, frame_args = SLAM_DRIVES[drive]
    cfg = slam_config(n, mesh.size if colocated else 1, **fields)
    frames, z0 = slam_frames(mesh.device, **frame_args)
    res, remote = {}, {}
    for mode, g in (("eager", False), ("graphed", StandIn(mesh=mesh))):
        before = dict(mesh.remote)
        carry, aux = _dryrun_slam(cfg, frames, z0, mesh, g, colocated)
        remote[mode] = _since(mesh, before)
        pool = shd.gather_pool(carry.pool, mesh)
        res[mode] = (shd.gather_state(carry.filter, mesh).particles,
                     pool.chain, pool.mean, pool.stdev, pool.meta,
                     pool.origin, aux["centroid"], aux["best_pose"],
                     carry.alloc_failed)
        if mode == "eager":
            eager_pool = carry.pool
    return {"equal": _equal(res["eager"], res["graphed"]),
            "remote": remote, "mapped": int(aux["mapped"].sum()),
            "replayed": g.replays,
            "pool": eager_pool if colocated else None}


def _fixed_pool_ops(mesh, pool, seed=4):
    """The split pool's fixed-shape exchanges on ``pool`` (a migrated
    drive's) against the same operations in one process on the gathered
    pool with the same ``shards``: the chain lookup (with remote levels),
    ``fetch_rows``, ``ensure_unique_active`` and ``rollover``, bit for
    bit, the rows asked of other ranks and the exchanges issued."""
    from slam_eslam_tpu_torch.mapping import map_pool as mp
    from slam_eslam_tpu_torch.utils import graphs

    gen = torch.Generator().manual_seed(seed)
    nl = pool.chain.shape[0]
    n = nl * mesh.size
    whole = graphs.clone(shd.gather_pool(pool, mesh))
    o = whole.origin.mean(0)
    queries = tuple((torch.rand((n, 8), generator=gen) - 0.5) * 2.0 + c
                    for c in (o[0] + 1.0, o[1] + 1.0, torch.tensor(0.0)))
    ids = torch.randint(0, pool.b, (n,), generator=gen)
    xy = torch.stack([o[0] + torch.rand(n, generator=gen) * 4.0,
                      o[1] + torch.rand(n, generator=gen) * 4.0], -1)
    map_id = torch.arange(n, dtype=torch.int32)
    names = ("mean", "meta", "origin")

    p = dataclasses.replace(graphs.clone(pool), mesh=mesh)
    before = dict(mesh.remote)
    looked = mp.make_chain_lookup(p, 3.0)(
        mesh.local(map_id), tuple(mesh.local(q) for q in queries))
    rows = mp.fetch_rows(p, mesh.local(ids), names, "t")
    _, f1 = mp.ensure_unique_active(p, mesh.size)
    _, f2 = mp.rollover(p, mesh.local(xy), 0.5, mesh.size)
    remote = _since(mesh, before)
    g = shd.gather_pool(p, mesh)
    meshed = ([mesh.all_gather(t) for t in looked],
              [mesh.all_gather(rows[k]) for k in names],
              g.chain, g.mean, g.meta, g.origin, g.allocated, f1, f2)

    looked = mp.make_chain_lookup(whole, 3.0)(map_id, queries)
    rows = [getattr(whole, k).index_select(0, ids) for k in names]
    _, f1 = mp.ensure_unique_active(whole, mesh.size)
    _, f2 = mp.rollover(whole, xy, 0.5, mesh.size)
    single = (list(looked), rows, whole.chain, whole.mean, whole.meta,
              whole.origin, whole.allocated, f1, f2)
    return {"equal": _equal(meshed, single), "remote": remote,
            "issued": sorted(mesh.asked)}


def _fixed_ppermute(mesh, n):
    """The ring-hop resample with the weight collapsed onto the first and
    onto the last rank, against the single-device systematic resample on
    the global weights: the ancestors, and the payload moved equal to the
    global payload gathered by them."""
    from slam_eslam_tpu_torch.core import filter as pf

    out = {}
    for name, hot in (("first", 0), ("last", mesh.size - 1)):
        w = torch.full((n,), 1e-6)
        nl = n // mesh.size
        w[hot * nl:(hot + 1) * nl] = 1.0
        u = torch.tensor(0.37)
        payload = {"i": torch.arange(n, dtype=torch.int32),
                   "xy": torch.arange(2.0 * n).reshape(n, 2)}
        moved, idxg, _ = dres.resample_ppermute(
            u, mesh.local(w), {k: mesh.local(v) for k, v in payload.items()},
            mesh)
        idx = mesh.all_gather(idxg)
        ref = pf.resample_systematic(pf.normalize_weights(w)[0], u, n)
        out[name] = {
            "equal": _equal((idx, mesh.all_gather(moved["i"]),
                             mesh.all_gather(moved["xy"])),
                            (ref, payload["i"].index_select(0, ref),
                             payload["xy"].index_select(0, ref))),
            "idx": _np(idx)}
    return out


def _graphed_solves(mesh):
    """The meshed PCG and Schur solves through the stand-in (three calls:
    eager, captured, replayed) against the eager meshed solve."""
    from slam_eslam_tpu_torch.backend import pose_graph as pgr
    from slam_eslam_tpu_torch.dryrun import ring_graph
    from slam_eslam_tpu_torch.utils import graphs
    from torch_stand_in import StandIn

    m = 8 * mesh.size
    out = {}
    solvers = {
        "cg": lambda g, cg: pgr.optimize_cg(g, 4, cg_iters=8, mesh=mesh,
                                            robust="dcs", cuda_graphs=cg),
        "schur": lambda g, cg: pgr.optimize_schur(
            g, 4, segments=mesh.size, boundary_cap=4 * mesh.size,
            mesh=mesh, cuda_graphs=cg)}
    for name, solve in solvers.items():
        cg = graphs.CallGraphs(StandIn(), name)
        equal = True
        for seed in (3, 3, 5):
            g, _ = ring_graph(m, seed=seed, device=mesh.device)
            equal &= _equal(solve(g, None), solve(g, cg))
        out[name] = {"equal": equal, "counts": cg.counts()}
    return out


def _graphed_online(mesh, n):
    """Two ``OnlineSlam`` chunks on the mesh through the stand-in and
    eagerly: the same centroids, state, pool and keyframes."""
    from slam_eslam_tpu_torch.dryrun import slam_config, slam_frames
    from slam_eslam_tpu_torch.online import OnlineSlam
    from torch_stand_in import StandIn

    cfg = slam_config(n, mesh.size)
    frames, z0 = slam_frames(mesh.device, steps=2)
    res = {}
    for mode, g in (("eager", False), ("graphed", StandIn())):
        s = OnlineSlam(config=cfg, laser2body=(np.eye(3), np.zeros(3)),
                       mesh=mesh, device=mesh.device, graph=g,
                       keyframe_kw=dict(keyframe_distance=0.01))
        s.init((np.array([0.0, 0.0, z0]), 0.0))
        s.filter.state = shd.shard_state(s.filter.state, mesh)
        s.filter.pool = shd.shard_pool(s.filter.pool, mesh)
        auxes = [s.process_chunk(frames.at(sl))
                 for sl in (slice(0, 10), slice(10, 20))]
        res[mode] = ([(a["centroid"], a["best_pose"]) for a in auxes],
                     shd.gather_state(s.filter.state, mesh).particles,
                     shd.gather_pool(s.filter.pool, mesh).mean,
                     torch.from_numpy(s.trajectory()))
    runner, = s.filter._runners.values()
    return {"equal": _equal(res["eager"], res["graphed"]),
            "keyframes": len(s.keyframes.keyframes),
            "counts": runner.counts()}


def mesh_graph_cases(mesh, inp):
    """Every case of ``tests/test_torch_mesh_graphs.py`` on one world:
    each meshed runner through the stand-in of ``tests/torch_stand_in.py``
    against its eager meshed run, and the fixed-shape exchanges against
    one process."""
    n = inp["particles"]
    out = {"filter": _graphed_filter_steps(mesh, n, False),
           "filter_ppermute": _graphed_filter_steps(mesh, n, True),
           "scan": _graphed_scan_runner(mesh, n),
           "ppermute": _fixed_ppermute(mesh, n),
           "solves": _graphed_solves(mesh)}
    if inp["slam"]:
        whole = _graphed_slam(mesh, n, "slam", False)
        split = _graphed_slam(mesh, n, "migrate", True)
        out["fixed_pool"] = _fixed_pool_ops(mesh, split.pop("pool"))
        whole.pop("pool")
        out.update(slam_whole=whole, slam_split=split,
                   online=_graphed_online(mesh, n))
    return out
