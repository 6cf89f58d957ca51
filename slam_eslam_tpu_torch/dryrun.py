"""The dry run's entry points: a one-device step and the multi-rank checks.

Port of the repository's root ``__graft_entry__.py``.  ``entry()`` builds
one filter step of the flagship configuration and its arguments;
``dryrun_multichip(n)`` starts ``n`` ranks (``parallel.distributed.
run_world``: NCCL with a card per rank, gloo where ranks share a card or
run on the CPU) and makes the four checks of the JAX dry run, each rank
on its slice:

1. one gated filter step on the mesh (the contact fold K1 on each rank's
   particles), held against the single-process step on the same draws;
2. streaming SLAM on a co-located pool (``map_pool_shards = n``): each
   rank must hold ``B/n`` blocks, and the gathered chains, patches and
   centroids must equal a single-process run with ``map_pool_shards =
   n`` on the same draws, bit for bit; once on the JAX dry run's short
   drive, and once on a drive where particles migrate between ranks
   (every measurement resamples, 2 m grids roll over), which must copy
   blocks from and look chain levels up on other ranks;
3. the ring-hop resampler (``parallel.resample.resample_ppermute``)
   equal to the single-device systematic resample;
4. a Schur pose-graph solve with its segments over the ranks, pose
   error < 5e-2.

The runners take their default ``graph=None``: CUDA graphs over NCCL,
eager launches over gloo and the host transport; each line says which
(``graphed``).  The rows a rank asks of other ranks are counted on the
device (``parallel.sharding.Mesh.remote``), graphed or not.

Usage:  python -m slam_eslam_tpu_torch.dryrun [N] [--cpu]
(no N: the one-device ``entry()`` step).
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

GATE = (np.float32(1.0), np.float32(0.0))   # forces the update branch


def terrain(x, y):
    return 0.25 * np.sin(1.3 * np.asarray(x)) + 0.2 * np.cos(
        0.9 * np.asarray(y))


def slam_terrain(x, y):
    return 0.15 * np.sin(0.7 * np.asarray(x)) + 0.12 * np.cos(
        0.5 * np.asarray(y))


def _build(n_particles, nx=64, ny=64, n_contacts=20, device=None,
           normals=None, mesh=None):
    """``(cfg, lookup, state, contact_state, q)`` of the flagship step:
    ``n_particles`` on a ``nx x ny`` sine terrain at 0.2 m (the lookup of
    ``mapping.lookup.make_lookup``, the contact fold K1 on the card), a
    Gaussian start (``normals = (xy [n, 2], yaw [n])``, else drawn from a
    generator seeded 0) and one step of ``TrajectorySim``'s contacts.  On
    the card unless ``device`` is given; ``mesh``: the lookup's."""
    from slam_eslam_tpu_torch.config import Config, ContactModelConfig
    from slam_eslam_tpu_torch.filter import pose_estimator as pe
    from slam_eslam_tpu_torch.mapping.lookup import make_lookup
    from slam_eslam_tpu_torch.models import sim as simlib
    from slam_eslam_tpu_torch.utils import tree
    from slam_eslam_tpu_torch.utils.device import entry_device

    device = entry_device(device)
    cfg = dataclasses.replace(
        Config(), particle_count=n_particles,
        min_effective=max(2, n_particles // 2),
        contact_model=ContactModelConfig(contact_point_radius=0.0))
    grid = simlib.terrain_grid(terrain, nx=nx, ny=ny, resolution=0.2,
                               origin=(-nx * 0.1, -ny * 0.1), device=device)
    lookup = make_lookup(cfg, grid, mesh)
    state = pe.PoseEstimatorState.create(cfg, n_contacts, device)
    if normals is None:
        gen = torch.Generator(device).manual_seed(0)
        particles = pe.init_gaussian(n_particles, (0.0, 0.0), 0.0,
                                     (0.3, 0.3), 0.05, 0.2, 0.3,
                                     generator=gen, device=device)
    else:
        particles = pe.init_gaussian(
            n_particles, (0.0, 0.0), 0.0, (0.3, 0.3), 0.05, 0.2, 0.3,
            normal_xy=normals[0].to(device), normal_yaw=normals[1].to(device))
    state = dataclasses.replace(state, particles=particles)
    sim = simlib.TrajectorySim(terrain, speed=0.05)
    sim.step()
    cs = tree.to(sim.contact_state(), device)
    q = torch.tensor([1.0, 0.0, 0.0, 0.0], device=device)
    return cfg, lookup, state, cs, q


def entry(device=None):
    """One-device check of one full filter step (propagate, contact
    weighting, ESS-gated resample) at 1,024 particles: returns ``(fn,
    args)``; ``fn(*args)`` runs it."""
    from slam_eslam_tpu_torch.filter import step as steplib

    cfg, lookup, state, cs, q = _build(1024, device=device)
    fn = steplib.make_filter_step(cfg, lookup)
    return fn, (state, cs, q, GATE)


def step_draws(n, device, seed):
    """One step's global draws, from a generator seeded ``seed``."""
    from slam_eslam_tpu_torch.filter import pose_estimator as pe
    from slam_eslam_tpu_torch.filter.step import StepDraws

    gen = torch.Generator(device).manual_seed(seed)
    return StepDraws(pe.ProjectDraws.sample(n, gen, device),
                     torch.rand((n,), generator=gen, device=device))


def _filter_check(mesh, n):
    """Check 1: one gated step on the mesh against the single-process
    step on the same draws."""
    from slam_eslam_tpu_torch.filter import step as steplib
    from slam_eslam_tpu_torch.parallel import sharding as shd

    cfg, lookup, state, cs, q = _build(n, nx=32, ny=32, device=mesh.device,
                                       mesh=mesh)
    draws = step_draws(n, mesh.device, 11)
    out, aux = steplib.make_filter_step(cfg, lookup, mesh=mesh)(
        shd.shard_state(state, mesh), cs, q, GATE, draws)
    got = shd.gather_state(out, mesh).particles
    ref, _ = steplib.make_filter_step(cfg, lookup)(state, cs, q, GATE, draws)
    ref = ref.particles
    return {"ess": float(aux["ess"]),
            "weight_err": float((got.weight - ref.weight).abs().max()),
            "xy_err": float((got.xy - ref.xy).abs().max())}


# the drives of check 2, by the key of their results: the config's fields
# beside ``slam_config``'s and ``slam_frames``' arguments.  "slam": the JAX
# dry run's short drive; "migrate": every measurement resamples and 2 m
# grids roll over on a longer drive, so particles take heads and chain
# tails held by other ranks
SLAM_DRIVES = {
    "slam": ({}, {}),
    "migrate": (dict(min_effective_share=1.0, grid_size=2.0,
                     grid_resolution=0.25, map_chain_length=3,
                     blocks_per_particle=4),
                dict(rays=32, range_m=0.8, steps=8, wheel_delta=1.0)),
}


def slam_config(n, ranks, min_effective_share=0.5, blocks_per_particle=None,
                **fields):
    """The dry run's SLAM config: ``n`` particles, a pool split over
    ``ranks`` of ``n + 2 ranks`` blocks (or ``blocks_per_particle * n``),
    ``fields`` over the defaults below."""
    from slam_eslam_tpu_torch.config import Config, ContactModelConfig

    blocks = (n + 2 * ranks if blocks_per_particle is None
              else blocks_per_particle * n)
    base = dict(grid_size=4.0, grid_resolution=0.5, map_chain_length=2)
    return dataclasses.replace(
        Config(), particle_count=n,
        min_effective=int(n * min_effective_share),
        map_pool_blocks=blocks, map_pool_color=False, map_pool_shards=ranks,
        contact_model=ContactModelConfig(contact_point_radius=0.0,
                                         min_contacts=2),
        **{**base, **fields})


def slam_frames(device, rays=16, range_m=1.5, steps=1, wheel_delta=0.3):
    """Frames of ``steps`` Asguard steps (10 substeps of ``wheel_delta /
    10`` of wheel each), a flat scan of ``rays`` at ``range_m`` on every
    frame, on ``device``."""
    from slam_eslam_tpu_torch.filter import streaming
    from slam_eslam_tpu_torch.models.asguard import AsguardSim
    from slam_eslam_tpu_torch.utils import tree

    sim = AsguardSim(terrain=slam_terrain)
    q = np.array([1.0, 0, 0, 0], np.float32)
    meta = (np.float32(-np.pi / 2), np.float32(np.pi / rays))
    frames = []

    def cb(s):
        frames.append((s.contact_state(), q,
                       np.asarray(s.position, np.float32),
                       np.full((rays,), range_m, np.float32), meta, True))

    z0 = float(sim.position[2])
    for _ in range(steps):
        sim.step(wheel_delta=wheel_delta, on_substep=cb)
    return tree.to(streaming.stack_frames(frames), device), z0


def slam_filter(cfg, z0, device):
    from slam_eslam_tpu_torch.filter.eslam_filter import EmbodiedSlamFilter

    f = EmbodiedSlamFilter(config=cfg, device=device)
    f.init(pose=(np.array([0.0, 0.0, z0]), 0.0), use_shared_map=False)
    return f


def slam_run(cfg, frames, z0, device, mesh=None, draw_seed=21):
    """A streaming SLAM run over ``frames`` from a fresh filter, on the
    mesh (the state and pool split, ``shard_pool``) or not, with global
    draws from a generator seeded ``draw_seed``.  Returns ``(carry,
    aux)``."""
    from slam_eslam_tpu_torch.filter import streaming
    from slam_eslam_tpu_torch.parallel import sharding as shd

    f = slam_filter(cfg, z0, device)
    n = cfg.particle_count
    draws = [step_draws(n, device, draw_seed + t) for t in range(len(frames))]
    state, pool = f.state, f.pool
    if mesh is not None:
        state, pool = shd.shard_state(state, mesh), shd.shard_pool(pool, mesh)
    run = streaming.make_slam_scan_runner(
        cfg, laser2body=(np.eye(3), np.zeros(3)), mesh=mesh)
    return run(streaming.StreamingState.create(state, pool), frames,
               draws=draws)


def _slam_check(mesh, n, drive="slam"):
    """Check 2: the co-located pool on the mesh against the single-process
    run with the same ``map_pool_shards``, on one of ``SLAM_DRIVES``.
    ``remote`` counts the rows this rank asked of other ranks, by name."""
    from slam_eslam_tpu_torch.parallel import sharding as shd

    fields, frame_args = SLAM_DRIVES[drive]
    cfg = slam_config(n, mesh.size, **fields)
    frames, z0 = slam_frames(mesh.device, **frame_args)
    remote = dict(mesh.remote)
    carry, aux = slam_run(cfg, frames, z0, mesh.device, mesh)
    rows = carry.pool.mean.shape[0]
    got = shd.gather_pool(carry.pool, mesh)
    since = lambda now, then: {k: v - then.get(k, 0) for k, v in now.items()}
    remote = since(mesh.remote, remote)
    ref, ref_aux = slam_run(cfg, frames, z0, mesh.device)
    names = ("chain", "meta", "mean", "stdev", "height", "origin")
    return {"frames": len(frames), "blocks": got.b, "rows": rows,
            "patches": int(got.count_valid()),
            "equal": {f: bool(torch.equal(getattr(got, f),
                                          getattr(ref.pool, f)))
                      for f in names},
            "centroid_err": float((aux["centroid"]
                                   - ref_aux["centroid"]).abs().max()),
            "mapped": int(aux["mapped"].sum()),
            "remote": remote}


def _ppermute_check(mesh, n):
    """Check 3: the ring-hop resample against the single-device one."""
    from slam_eslam_tpu_torch.core import filter as pf
    from slam_eslam_tpu_torch.parallel import resample as dres

    rng = np.random.default_rng(1)
    w = torch.tensor(rng.uniform(size=n).astype(np.float32) + 0.01,
                     device=mesh.device)
    u = torch.tensor(np.float32(np.random.default_rng(5).uniform()),
                     device=mesh.device)
    payload = {"map_id": mesh.local(torch.arange(n, dtype=torch.int32,
                                                 device=mesh.device))}
    out, idxg, ess = dres.resample_ppermute(u, mesh.local(w), payload, mesh)
    wn, _ = pf.normalize_weights(w)
    ref = pf.resample_systematic(wn, u, n)
    got = mesh.all_gather(idxg)
    moved = mesh.all_gather(out["map_id"])
    return {"ess": float(ess), "equal": bool(torch.equal(got, ref)),
            "payload_moved": bool(torch.equal(moved.long(), got))}


def ring_graph(m, dim=3, seed=3, device=None):
    """The dry run's pose graph: ``m`` poses on a unit circle, odometry
    edges and one closing edge (information 100), noisy initial nodes
    (sigma 0.05, the first exact).  Returns ``(graph, truth [m, 3])``."""
    from slam_eslam_tpu_torch.backend import pose_graph as pgr

    g = pgr.PoseGraph.empty(max_nodes=m, max_edges=m + 8, dim=dim,
                            device=device)
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 2 * np.pi, m, endpoint=False)
    gt = np.stack([np.cos(t), np.sin(t), t + np.pi / 2],
                  axis=1).astype(np.float32)
    n0 = gt + rng.normal(0, 0.05, gt.shape).astype(np.float32)
    n0[0] = gt[0]

    def rel(a, b):
        c, s = np.cos(a[2]), np.sin(a[2])
        d = b[:2] - a[:2]
        dy = np.arctan2(np.sin(b[2] - a[2]), np.cos(b[2] - a[2]))
        return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1], dy])

    pairs = [(k, k + 1) for k in range(m - 1)] + [(0, m - 1)]
    e = len(pairs)
    dev = g.nodes.device
    put = lambda a, dt=torch.float32: torch.tensor(np.asarray(a), dtype=dt,
                                                   device=dev)
    ei, ej = g.edge_i.clone(), g.edge_j.clone()
    ei[:e] = put([p[0] for p in pairs], torch.int32)
    ej[:e] = put([p[1] for p in pairs], torch.int32)
    ez, info, valid = g.edge_z.clone(), g.edge_info.clone(), \
        g.edge_valid.clone()
    ez[:e] = put(np.stack([rel(gt[a], gt[b]) for a, b in pairs]))
    info[:e] = torch.eye(3, device=dev) * 100.0
    valid[:e] = True
    g = dataclasses.replace(g, nodes=put(n0),
                            node_valid=torch.ones(m, dtype=torch.bool,
                                                  device=dev),
                            edge_i=ei, edge_j=ej, edge_z=ez, edge_info=info,
                            edge_valid=valid)
    return g, put(gt)


def _schur_check(mesh):
    """Check 4: the Schur solve with its segments over the ranks."""
    from slam_eslam_tpu_torch.backend import pose_graph as pgr

    m = 16 * mesh.size
    g, gt = ring_graph(m, device=mesh.device)
    gs, _ = pgr.optimize_schur(g, 8, segments=mesh.size,
                               boundary_cap=4 * mesh.size, mesh=mesh)
    d = gs.nodes - gt
    d[:, 2] = pgr.wrap_angle(d[:, 2])
    return {"nodes": m, "err": float(d.abs().max())}


def _dryrun_rank(mesh):
    """Every check on one rank; returns its results and its kernels'
    launch counts."""
    from slam_eslam_tpu_torch import ops
    from slam_eslam_tpu_torch.utils import graphs

    ops.reset_launch_counts()
    n = max(8 * mesh.size, 64)
    out = {"backend": mesh.backend, "transport": mesh.transport,
           "graphed": graphs.resolve(None, mesh.device, mesh) is not None,
           "device": str(mesh.device), "particles": n,
           "filter": _filter_check(mesh, n),
           "slam": _slam_check(mesh, n),
           "migrate": _slam_check(mesh, n, "migrate"),
           "ppermute": _ppermute_check(mesh, n),
           "schur": _schur_check(mesh)}
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    out["launches"] = ops.launch_counts()
    return out


def remote_rows(ranks, drive):
    """Rows the ranks asked of other ranks on ``drive``, summed over the
    ranks, by name."""
    out = {}
    for r in ranks:
        for k, v in r[drive]["remote"].items():
            out[k] = out.get(k, 0) + v
    return out


def dryrun_multichip(n_devices, device=None, timeout=600):
    """Run the four checks over ``n_devices`` ranks on ``device`` (the
    card unless ``"cpu"``); raises if one fails.  Prints a line per check
    with the backend and transport; returns every rank's results."""
    from slam_eslam_tpu_torch.parallel.distributed import run_world

    ranks = run_world(_dryrun_rank, n_devices, device=device,
                      timeout=timeout)
    r0 = ranks[0]
    where = (f"{n_devices} ranks, backend {r0['backend']}, transport "
             f"{r0['transport']}, graphed {r0['graphed']}, {r0['device']}")
    f = r0["filter"]
    if not (f["weight_err"] <= 1e-6 and f["xy_err"] <= 1e-6):
        raise AssertionError(f"meshed filter step differs from the "
                             f"single-process step: {f}")
    print(f"dryrun_multichip ok: {where}, {r0['particles']} particles, "
          f"ess={f['ess']:.1f}, vs one process: weights "
          f"{f['weight_err']:.1e}, xy {f['xy_err']:.1e}")
    for drive in SLAM_DRIVES:
        for r in ranks:
            s = r[drive]
            if s["rows"] * n_devices != s["blocks"]:
                raise AssertionError(f"each rank must hold B/n blocks: {s}")
            if not all(s["equal"].values()) or s["centroid_err"] > 0.0:
                raise AssertionError(f"sharded SLAM ({drive} drive) differs "
                                     f"from the single-process run: {s}")
        s = r0[drive]
        print(f"dryrun_multichip slam ok: {drive} drive, {s['frames']} "
              f"frames, {s['patches']} patches, pool split {s['rows']} of "
              f"{s['blocks']} blocks a rank, equal bit for bit to one "
              f"process with map_pool_shards={n_devices}; rows from other "
              f"ranks {remote_rows(ranks, drive)}")
    moved = remote_rows(ranks, "migrate")
    if not (moved.get("block copy", 0) > 0
            and moved.get("chain lookup", 0) > 0):
        raise AssertionError(f"the migrating drive must copy blocks from "
                             f"and look chain levels up on other ranks: "
                             f"rows from other ranks {moved}")
    p = r0["ppermute"]
    if not all(r["ppermute"]["equal"] and r["ppermute"]["payload_moved"]
               for r in ranks):
        raise AssertionError("ppermute resample must match the "
                             "single-device oracle")
    print(f"dryrun_multichip ppermute-resample ok: {r0['particles']} "
          f"particles, ess={p['ess']:.1f}, payload moved by ring hops")
    sc = r0["schur"]
    if not all(r["schur"]["err"] < 5e-2 for r in ranks):
        raise AssertionError(f"meshed Schur solve diverged: {sc}")
    print(f"dryrun_multichip schur ok: {sc['nodes']} nodes over "
          f"{n_devices} segments on the mesh, max pose err "
          f"{sc['err']:.4f}")
    return ranks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ranks", nargs="?", type=int)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (gloo) instead of the card")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    if args.ranks:
        dryrun_multichip(args.ranks, device=device)
        return
    fn, fargs = entry(device)
    out, _ = fn(*fargs)
    float(out.particles.weight.sum())
    print("entry ok")


if __name__ == "__main__":
    main()
