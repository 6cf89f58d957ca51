"""Flagship end-to-end demo: record a traverse, replay it, report.

Counterpart of ``examples/full_demo.py`` of the JAX package.  A simulated
Asguard drives an out-and-back route over synthetic terrain:

1. **Record** (``io.logio``): contact states, orientations, ground-truth
   poses, ray-cast laser scans (a tilted 270-degree scanner) and ray-cast
   distance images with RGB textures (a camera), written through the
   native log writer: the input a deployment replays.
2. **Replay** (``OnlineSlam``): the log read onto the device at once
   (``streaming.frames_from_log``), then per-particle-map SLAM in chunks
   with laser merges, camera merges carrying texture colour, optional
   surface-hash reinjection, keyframes and scan-align loop closures.  On
   the card every measurement frame runs the chain lookup K2 and every
   laser or camera mapping frame the block merge K3.
3. **Report**: tracking ATE against ground truth, the keyframe
   trajectory's error before and after the pose-graph backend, closure
   quality against the true relative poses, one JSON line with the JAX
   demo's keys, and a snapshot image where matplotlib is installed.

Two places where the port does not copy the JAX demo: ``--min-ratio``
defaults to the library's 1.25 (``backend.keyframes.KeyframeManager``),
not the demo's 1.0, which switched the closure distinctiveness gate off;
and only a missing matplotlib skips the snapshot (the JAX demo skipped it
on any error).

Run:  python -m slam_eslam_tpu_torch.examples.full_demo [--cpu]
          [--steps 48] [--particles 192]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import numpy as np

from slam_eslam_tpu_torch.config import (Config, ContactModelConfig,
                                         OdometryConfig, SurfaceHashConfig)
from slam_eslam_tpu_torch.filter import streaming
from slam_eslam_tpu_torch.filter.surface_hash import SurfaceHash
from slam_eslam_tpu_torch.io import logio
from slam_eslam_tpu_torch.models import sim as simlib
from slam_eslam_tpu_torch.models.asguard import AsguardSim
from slam_eslam_tpu_torch.online import OnlineSlam
from slam_eslam_tpu_torch.utils import tree
from slam_eslam_tpu_torch.utils.device import entry_device

ROCK_SEED = 7
DEFAULT_EXTENT = 6.0
FALSE_CLOSURE_M = 0.75   # a closure edge this far from the truth is false


def _draw_rocks(rng, extent):
    # density thins about linearly with extent: a constant density at
    # stretch extents (10x the rocks) degraded the stance-foot odometry
    # and aliased under closure correlation in the JAX package's runs
    count = int(60 * max(1.0, extent / 6.0))
    return np.stack([
        rng.uniform(-extent, extent, count),   # x
        rng.uniform(-extent, extent, count),   # y
        rng.uniform(0.10, 0.30, count),        # height
        rng.uniform(0.25, 0.45, count),        # radius
    ], axis=1)


def make_rocks(extent=DEFAULT_EXTENT):
    """The JAX demo's rock field: the first draw of a generator seeded
    with 7 at the default extent; at another extent the same generator's
    second draw (the JAX demo draws the default field when it is imported
    and redraws from that generator)."""
    rng = np.random.default_rng(ROCK_SEED)
    rocks = _draw_rocks(rng, DEFAULT_EXTENT)
    if extent != DEFAULT_EXTENT:
        rocks = _draw_rocks(rng, extent)
    return rocks


class World:
    """The demo's ground: a rolling base plus a rock field, its colours,
    and a ray caster against it (host NumPy, vectorised)."""

    def __init__(self, extent=DEFAULT_EXTENT):
        self.rocks = make_rocks(extent)

    def height(self, x, y, rocks=None):
        x, y = np.asarray(x, float), np.asarray(y, float)
        # distinctive local relief gives the contact model and the
        # closure z-correlation something to lock onto (sinusoids alone
        # are self-similar at the robot's scale)
        base = (0.20 * np.sin(0.9 * x) + 0.16 * np.cos(0.7 * y)
                + 0.10 * np.sin(2.3 * x + 0.8 * y))
        if rocks is None:
            rocks = self.rocks
        bump = lambda fx, fy: (rocks[:, 2] * np.exp(
            -((fx[..., None] - rocks[:, 0]) ** 2
              + (fy[..., None] - rocks[:, 1]) ** 2)
            / (2 * rocks[:, 3] ** 2))).sum(-1)
        if x.size * len(rocks) <= 5e7:
            return base + bump(x, y)
        # a large survey grid is evaluated in chunks, not as one
        # multi-GB broadcast
        flat_x, flat_y = x.reshape(-1), y.reshape(-1)
        out = np.empty(flat_x.shape, float)
        step = max(1, int(5e7 / max(len(rocks), 1)))
        for i in range(0, flat_x.size, step):
            out[i:i + step] = bump(flat_x[i:i + step], flat_y[i:i + step])
        return base + out.reshape(x.shape)

    def color(self, x, y):
        """Synthetic ground RGB: a height-keyed colour map."""
        t = np.clip((self.height(x, y) + 0.6) / 1.2, 0.0, 1.0)
        return np.stack([0.2 + 0.6 * t, 0.5 - 0.2 * t, 0.8 - 0.6 * t], -1)

    def raycast(self, origins, dirs, t_min=0.25, t_max=3.2, dt=0.02):
        """First terrain intersection along each ray: ``origins [R, 3]``,
        ``dirs [R, 3]`` (not necessarily unit) -> parametric t [R] (inf =
        no hit within range)."""
        ts = np.arange(t_min, t_max, dt)
        p = origins[:, None, :] + ts[None, :, None] * dirs[:, None, :]
        # only rocks whose 6-sigma support overlaps the ray bundle's box
        # contribute (their tails beyond are < 1e-8 m)
        xy = p[..., :2].reshape(-1, 2)
        pad = 6.0 * self.rocks[:, 3].max()
        lo, hi = xy.min(0) - pad, xy.max(0) + pad
        r = self.rocks
        sel = ((r[:, 0] >= lo[0]) & (r[:, 0] <= hi[0])
               & (r[:, 1] >= lo[1]) & (r[:, 1] <= hi[1]))
        below = p[..., 2] <= self.height(p[..., 0], p[..., 1], rocks=r[sel])
        first = np.argmax(below, axis=1)
        return np.where(below.any(axis=1), ts[first], np.inf)


def _rot_x(a):
    return np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                     [0, np.sin(a), np.cos(a)]])


def _world_rot(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def rigs():
    """The sensor mounts.  A 270-degree lidar (out-leg and return-leg scans
    overlap even at opposite headings: a forward fan cannot close a loop on
    an out-and-back route), its x along the body's y, tilted 28 degrees
    down; a 12x16 camera, z forward, tilted 38 degrees down."""
    n_rays = 180
    swap = np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]])  # x->y, y->-x
    cam_h, cam_w = 12, 16
    sx = sy = 0.09
    return dict(
        n_rays=n_rays, start_angle=-3 * np.pi / 4,
        ang_res=(3 * np.pi / 2) / n_rays,
        laser=(_rot_x(-np.deg2rad(28.0)) @ swap, np.array([0.0, 0.25, 0.15])),
        cam_hw=(cam_h, cam_w),
        camera=(_rot_x(-np.deg2rad(38.0)) @ np.array(
            [[1.0, 0, 0], [0, 0, 1], [0, -1, 0]]),
            np.array([0.0, 0.20, 0.25])),
        intrinsics=(sx, sy, -sx * (cam_w - 1) / 2, -sy * (cam_h - 1) / 2))


def record(path, args, world):
    """Drive the out-and-back route (out, a skid U-turn, back over the
    same ground: a guaranteed revisit) and write every frame's contact
    state, orientation and pose, a scan on every tenth frame and, unless
    ``--no-camera``, a distance image with its texture on the fifth frame
    of every second step.  Returns the truth ``[T, 4]`` (x, y, z, yaw)."""
    rig = rigs()
    n_rays, start_angle, ang_res = (rig["n_rays"], rig["start_angle"],
                                    rig["ang_res"])
    laser_rot, laser_trans = rig["laser"]
    cam_rot, cam_trans = rig["camera"]
    cam_h, cam_w = rig["cam_hw"]
    sx, sy, cx0, cy0 = rig["intrinsics"]
    sim = AsguardSim(terrain=world.height)
    truth = []
    turn_steps = args.turn_steps or max(4, args.steps // 8)
    n_turns = max(1, args.legs - 1)
    leg = (args.steps - n_turns * turn_steps) // args.legs
    period = leg + turn_steps

    with logio.LogWriter(path) as w:

        def frame(s, scan=False, camera=False):
            ts = len(truth) * 10_000_000
            q = np.asarray(s.orientation)
            w.write_contact_state(s.contact_state(), ts)
            w.write_orientation(q, ts)
            w.write_pose(s.position, q, ts)
            truth.append(np.array([*s.position, s.yaw]))
            rw = _world_rot(s.yaw)
            if scan:
                angles = start_angle + np.arange(n_rays) * ang_res
                d_scan = np.stack([np.cos(angles), np.sin(angles),
                                   np.zeros(n_rays)], -1)
                d_world = (rw @ laser_rot @ d_scan.T).T
                o = s.position + rw @ laser_trans
                t = world.raycast(np.broadcast_to(o, (n_rays, 3)), d_world)
                w.write_scan(np.where(np.isfinite(t), t, 0.0).astype(
                    np.float32), start_angle, ang_res, ts)
            if camera:
                uu, vv = np.meshgrid(np.arange(cam_w) * sx + cx0,
                                     np.arange(cam_h) * sy + cy0)
                d_cam = np.stack([uu, vv, np.ones_like(uu)],
                                 -1).reshape(-1, 3)
                d_world = (rw @ cam_rot @ d_cam.T).T
                o = s.position + rw @ cam_trans
                t = world.raycast(np.broadcast_to(o, (d_world.shape[0], 3)),
                                  d_world, t_min=0.3, t_max=2.8, dt=0.02)
                depth = np.where(np.isfinite(t), t, 0.0).astype(np.float32)
                w.write_distance_image(depth.reshape(cam_h, cam_w), sx, sy,
                                       cx0, cy0, ts)
                hits = o[None] + np.nan_to_num(t[:, None], posinf=0.0) \
                    * d_world
                tex = world.color(hits[:, 0], hits[:, 1]).astype(np.float32)
                w.write_texture_image(tex.reshape(cam_h, cam_w, 3), ts)

        frame(sim)
        for k in range(args.steps):
            turning = k < n_turns * period and k % period >= leg
            subs = []

            def sub(s, k=k, subs=subs):
                subs.append(None)
                frame(s, scan=len(subs) == 10,
                      camera=(not args.no_camera and len(subs) == 5
                              and k % 2 == 0))

            sim.step(wheel_delta=args.wheel_delta,
                     yaw_rate=np.pi / turn_steps if turning else 0.0,
                     on_substep=sub)
    return np.stack(truth)


def demo_config(args):
    return dataclasses.replace(
        Config(), particle_count=args.particles,
        min_effective=args.particles // 2,
        grid_size=args.grid_size, grid_resolution=args.grid_res,
        map_pool_blocks=args.pool_blocks or args.particles + 32,
        map_chain_length=3, map_pool_dtype=args.pool_dtype,
        # textures ride the patches (camera path); camera-free runs drop
        # colour for 1.5x less pool memory and merge traffic
        map_pool_color=not args.no_camera,
        mapping_camera_threshold=dataclasses.replace(
            Config().mapping_camera_threshold, distance=0.6),
        contact_model=ContactModelConfig(contact_point_radius=0.0,
                                         min_contacts=2))


def keyframe_kw(args):
    return dict(
        keyframe_distance=args.keyframe_distance,
        closure_radius=args.closure_radius,
        # 64 cells at 0.2 m = 12.8 m keyframe grids: a candidate pairing
        # under drift can be metres off-centre and the probe cloud must
        # still land on the grid
        grid_cells=64, align_coarse=args.align_coarse,
        min_separation=(args.min_separation or max(
            3, int(args.closure_radius / args.keyframe_distance) + 2)),
        min_score=args.min_score, min_ratio=args.min_ratio,
        closure_info=args.closure_info, yaw_prior_info=args.yaw_prior,
        # the sweep spans the drift around the turn; yaw rides the IMU, so
        # its sweep stays tight and xy ambiguity cannot pose as rotation
        align_search_xy=1.5, align_search_yaw=0.15,
        align_steps_xy=31, align_steps_yaw=5, align_sigma=0.05,
        align_search_z=args.align_z, align_steps_z=7)


def make_slam(args, start, device=None, normals=None, graph=None):
    """``OnlineSlam`` with the demo's configuration on ``device`` (the CUDA
    device unless given), started at ``start = (x, y, z, yaw)``;
    ``normals = (xy [N, 2], yaw [N])`` are the start cloud's draws (else
    the filter's generator).  With ``--hash`` the surface hash of a prior
    survey of the whole rock field reinjects candidates.  ``graph``: the
    chunks as CUDA graphs (``OnlineSlam(graph=...)``); None: on the card,
    as the JAX demo runs its chunks jitted, and eager on the CPU."""
    device = entry_device(device)
    if graph is None:
        graph = device.type == "cuda"
    rig = rigs()
    cam_kw = {} if args.no_camera else dict(
        camera2body=rig["camera"], camera_intrinsics=rig["intrinsics"],
        camera_texture=True)
    slam = OnlineSlam(
        config=demo_config(args), submap_scans=3, donate=args.donate,
        # skid-steer: commanded yaw drags the stance feet sideways, a
        # systematic slip the odometry error model must cover
        odometry_config=OdometryConfig(dist_error_xy=0.35,
                                       const_error_xy=0.004),
        laser2body=rig["laser"], keyframe_kw=keyframe_kw(args),
        device=device, graph=graph, **cam_kw)
    init_kw = {} if normals is None else dict(
        normal_xy=normals[0].to(slam.device),
        normal_yaw=normals[1].to(slam.device))
    slam.init(pose=(start[:3], start[3]), **init_kw)
    if args.hash:
        hx = args.extent + 5.0
        hn = int(2 * hx / 0.25)
        world = World(args.extent)
        slam.filter.hash = SurfaceHash.create(
            SurfaceHashConfig(use_hash=True, period=20,
                              lost_threshold=args.hash_lost),
            simlib.terrain_grid(world.height, nx=hn, ny=hn, resolution=0.25,
                                origin=(-hx, -hx), device=slam.device))
    return slam


def replay(slam, frames, chunk, draws=None, log=print):
    """``frames`` (``SlamFrames``) through ``slam.process_chunk`` in chunks
    of ``chunk`` frames (a trailing partial chunk is left out);
    ``draws``: one ``step.StepDraws`` per frame, else the filter's
    generator.  Returns the centroids ``[used, 3]``, the per-chunk
    ``aux`` and seconds (each ending in the read of its centroids) and the
    wall seconds of the loop."""
    cents, auxes, chunk_s = [], [], []
    t0 = time.perf_counter()
    nchunks = len(frames) // chunk
    for ci in range(nchunks):
        t1 = time.perf_counter()
        sl = slice(ci * chunk, (ci + 1) * chunk)
        dr = None if draws is None else [tree.to(d, slam.device)
                                         for d in draws[sl]]
        aux = slam.process_chunk(frames.at(sl), draws=dr)
        cents.append(aux["centroid"].cpu().numpy())
        chunk_s.append(time.perf_counter() - t1)
        auxes.append(aux)
        cam = int(aux["cam_mapped"].sum()) if "cam_mapped" in aux else 0
        log(f"chunk {ci + 1}/{nchunks}: {int(aux['mapped'].sum())} laser "
            f"merges, {cam} camera merges, "
            f"{len(slam.keyframes.keyframes)} keyframes, "
            f"{len(slam.keyframes.closures)} closures")
    wall = time.perf_counter() - t0
    return dict(centroids=np.concatenate(cents), auxes=auxes,
                chunk_s=chunk_s, wall=wall)


def _np(t):
    return t.detach().cpu().numpy()


def save_graph(path, slam, kf_frames, kf_truth):
    """The keyframe graph, clouds, closures and truth before optimisation
    (the input of ``tools.closure_lab``); the JAX demo's keys."""
    km = slam.keyframes
    g = km.builder.graph
    cloud = lambda name: np.stack([_np(getattr(k.cloud, name))
                                   for k in km.keyframes])
    np.savez_compressed(
        path, nodes=_np(g.nodes), node_valid=_np(g.node_valid),
        edge_i=_np(g.edge_i), edge_j=_np(g.edge_j), edge_z=_np(g.edge_z),
        edge_info=_np(g.edge_info), edge_valid=_np(g.edge_valid),
        kf_poses=np.stack([k.pose for k in km.keyframes]),
        kf_zs=np.asarray([k.z for k in km.keyframes]),
        kf_frames=kf_frames, kf_truth=kf_truth,
        clouds_xy=cloud("xy"), clouds_z=cloud("z"),
        clouds_stdev=cloud("stdev"), clouds_valid=cloud("valid"),
        closures=np.asarray([(d["old"], d["new"], d["score"], d["ratio"])
                             for d in km.closure_details]).reshape(-1, 4),
        corrected=np.asarray([d["corrected"] for d in km.closure_details]
                             ).reshape(-1, 3))


def rel2d(a, b):
    """Pose of b in a's frame; a, b = (x, y, yaw)."""
    c, s = np.cos(a[2]), np.sin(a[2])
    dt = np.asarray(b[:2]) - np.asarray(a[:2])
    return np.array([
        c * dt[0] + s * dt[1], -s * dt[0] + c * dt[1],
        np.arctan2(np.sin(b[2] - a[2]), np.cos(b[2] - a[2])),
    ])


def report(slam, truth, run, args, log=print):
    """Tracking ATE, the backend (consistency prune, ``optimize``) and
    closure quality; prints the JAX demo's lines and JSON line.  Returns
    ``(result, extra)``: the JSON object, and the keyframe truth, the
    keyframe trajectory before and after the backend and the seconds of
    ``optimize``."""
    cents, wall = run["centroids"], run["wall"]
    used = cents.shape[0]
    tr = truth[:used]
    xy_err = np.linalg.norm(cents[:, :2] - tr[:, :2], axis=1)
    z_err = np.abs(cents[:, 2] - tr[:, 2])
    n10 = max(1, used // 10)
    cpath = np.linalg.norm(np.diff(cents[:, :2], axis=0), axis=1).sum()
    tpath = np.linalg.norm(np.diff(tr[:, :2], axis=0), axis=1).sum()
    log(f"\nonline tracking ({used} frames in {wall:.1f}s = "
        f"{used / wall:.1f} fps incl. host chunking; centroid path "
        f"{cpath:.2f} m vs truth {tpath:.2f} m):")
    log(f"  mean xy ATE {xy_err.mean():.3f} m | final-10% "
        f"{xy_err[-n10:].mean():.3f} m | z {z_err.mean():.3f} m")

    km = slam.keyframes
    kf_frames = np.asarray(slam.keyframe_frames, dtype=int)
    kf_truth = truth[kf_frames]
    if args.save_graph:
        save_graph(args.save_graph, slam, kf_frames, kf_truth)
        log(f"graph dump -> {args.save_graph}")
    before = slam.trajectory()
    n_pruned = km.prune_closures(args.consist) if args.consist > 0 else 0
    robust = None if args.robust == "none" else args.robust
    t0 = time.perf_counter()
    traj, hist = slam.optimize(iters=40, incremental=False, robust=robust,
                               robust_delta=args.robust_delta,
                               solver=args.solver)
    hist = _np(hist)
    optimize_s = time.perf_counter() - t0
    after = np.asarray(traj)
    kf_err = lambda t: np.linalg.norm(
        np.asarray(t)[:, :2] - kf_truth[:, :2], axis=1).mean()

    # closure quality: the alignment lands in the old keyframe's (drifted)
    # frame, so the honest metric is the closure edge's relative pose
    # against the true relative pose of the two frames
    align_errs = []
    for det in km.closure_details:
        t_old = truth[kf_frames[det["old"]]][[0, 1, 3]]
        t_new = truth[kf_frames[det["new"]]][[0, 1, 3]]
        rel_edge = rel2d(km.keyframes[det["old"]].pose, det["corrected"])
        rel_true = rel2d(t_old, t_new)
        err = float(np.linalg.norm(rel_edge[:2] - rel_true[:2]))
        align_errs.append(err)
        log(f"  closure kf{det['old']} <- kf{det['new']} "
            f"(score {det['score']:.3f} ratio {det['ratio']:.2f}): "
            f"edge rel ({rel_edge[0]:.2f},{rel_edge[1]:.2f}) "
            f"true rel ({rel_true[0]:.2f},{rel_true[1]:.2f}) "
            f"-> err {err:.2f} m"
            + ("  FALSE" if err > FALSE_CLOSURE_M else "")
            + ("  PRUNED" if det.get("pruned") else ""))
    n_false = sum(e > FALSE_CLOSURE_M for e in align_errs)
    kept = [e for e, d in zip(align_errs, km.closure_details)
            if not d.get("pruned")]
    n_false_used = sum(e > FALSE_CLOSURE_M for e in kept)
    # revisit opportunities: keyframes whose true pose passes within
    # closure range of an older, separation-eligible keyframe
    n_revisit = sum(
        1 for i in range(len(kf_frames))
        if any(np.linalg.norm(kf_truth[i, :2] - kf_truth[j, :2]) < 2.0
               for j in range(0, i - km.min_separation)))
    log(f"  closure quality: {len(align_errs)}/{n_revisit} revisit "
        f"opportunities closed, {n_false} false (aligned err > "
        f"{FALSE_CLOSURE_M} m), mean aligned err "
        f"{np.mean(align_errs) if align_errs else float('nan'):.2f} m"
        f"; prune kept {len(kept)} ({n_false_used} false)")
    log(f"keyframe trajectory ({len(kf_frames)} keyframes, "
        f"{len(km.closures)} loop closures):")
    log(f"  mean xy error before backend {kf_err(before):.3f} m "
        f"-> after {kf_err(after):.3f} m "
        f"(chi2 {float(hist[0]):.2f} -> {float(hist[-1]):.2f})")
    result = {
        "metric": "full_demo_composition",
        "particles": args.particles,
        "frames": used,
        "route_m": round(float(tpath), 1),
        "fps_incl_host": round(used / wall, 1),
        "ate_xy_mean_m": round(float(xy_err.mean()), 3),
        "ate_xy_final10_m": round(float(xy_err[-n10:].mean()), 3),
        "ate_z_mean_m": round(float(z_err.mean()), 3),
        "keyframes": int(len(kf_frames)),
        "closures": int(len(km.closures)),
        "kf_xy_before_m": round(float(kf_err(before)), 3),
        "kf_xy_after_m": round(float(kf_err(after)), 3),
        "revisit_opportunities": int(n_revisit),
        "false_closures": int(n_false),
        "closures_used": int(len(kept)),
        "false_closures_used": int(n_false_used),
        "pruned_closures": int(n_pruned),
        "closure_align_err_mean_m": (
            round(float(np.mean(align_errs)), 3) if align_errs else None),
        "solver": args.solver,
        "robust": args.robust,
        "pool_dtype": args.pool_dtype,
    }
    log(json.dumps(result))
    return result, dict(kf_truth=kf_truth, before=before, after=after,
                        optimize_s=optimize_s)


def snapshot(slam, truth, run, extra, out_dir, log=print):
    """Particles over the trajectories, the best particle's map and the
    keyframe graph before and after the backend, to
    ``out_dir/full_demo.png``.  Skipped, with a note, where matplotlib is
    not installed; any other failure raises."""
    try:
        import matplotlib
    except ImportError as e:
        log(f"(snapshot rendering skipped: {e})")
        return None
    from slam_eslam_tpu_torch.viz import render

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cents = run["centroids"]
    tr, kf_truth = truth[:cents.shape[0]], extra["kf_truth"]
    before, after = np.asarray(extra["before"]), extra["after"]
    best = slam.filter.get_best_particle_index()
    fig, axes = plt.subplots(1, 3, figsize=(16, 5))
    render.draw_particles(slam.filter.get_particles(), ax=axes[0],
                          best_index=best)
    axes[0].plot(tr[:, 0], tr[:, 1], "k--", lw=0.8, label="truth")
    axes[0].plot(cents[:, 0], cents[:, 1], "g-", lw=0.8, label="centroid")
    axes[0].legend()
    axes[0].set_title("particles + trajectories")
    render.draw_particle_map(slam.filter.pool, best, ax=axes[1])
    axes[1].set_title("best particle's map (chain composite)")
    axes[2].plot(kf_truth[:, 0], kf_truth[:, 1], "k--", label="truth")
    axes[2].plot(before[:, 0], before[:, 1], "r-", lw=0.8,
                 label="before opt")
    axes[2].plot(after[:, 0], after[:, 1], "b-", lw=0.8, label="after opt")
    axes[2].legend()
    axes[2].set_title("keyframe graph: backend correction")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "full_demo.png")
    fig.savefig(out, dpi=110, bbox_inches="tight")
    plt.close(fig)
    log(f"saved {out}")
    return out


def _coarse_spec(text):
    """'--align-coarse search_xy,steps,sigma', with a clear error."""
    parts = text.split(",")
    if len(parts) != 3:
        raise argparse.ArgumentTypeError(
            f"expected 'search_xy,steps,sigma' (3 fields), got {text!r}")
    try:
        return (float(parts[0]), int(float(parts[1])), float(parts[2]))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"non-numeric field in {text!r} "
            "(expected 'search_xy,steps,sigma')") from None


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    arg = ap.add_argument
    arg("--steps", type=int, default=48,
        help="sim steps (10 frames each) along the route")
    arg("--particles", type=int, default=192)
    arg("--chunk", type=int, default=60, help="frames per process_chunk")
    arg("--cpu", action="store_true",
        help="run on the CPU instead of the CUDA device")
    arg("--out", default=os.path.join(tempfile.gettempdir(), "full_demo"),
        help="directory of the snapshot image")
    arg("--hash", action="store_true",
        help="enable surface-hash reinjection (global relocalisation "
        "candidates; on signature-ambiguous synthetic terrain they spread "
        "wide and cost tracking accuracy on this route)")
    arg("--no-camera", action="store_true")
    arg("--hash-lost", type=float, default=0.2, dest="hash_lost",
        help="health gate of hash reinjection (SurfaceHashConfig."
        "lost_threshold): inject only while the decayed max weight is "
        "below this; 0 = the reference's unconditional injection")
    arg("--wheel-delta", type=float, default=0.32, dest="wheel_delta",
        help="wheel advance per step (rad); larger = longer route")
    arg("--extent", type=float, default=DEFAULT_EXTENT,
        help="rock-field half-extent in metres; raise to cover a longer "
        "route with relief (about half the route length)")
    arg("--pool-dtype", choices=["float32", "bfloat16"], default="float32",
        dest="pool_dtype")
    arg("--pool-blocks", type=int, default=0, dest="pool_blocks",
        help="map-pool capacity (0 = particles+32; moving routes with "
        "rollover want ~2-3x particles)")
    arg("--donate", action="store_true",
        help="accepted for the JAX demo's command line; the port's pool "
        "is always updated in place, so it changes nothing")
    arg("--grid-size", type=float, default=10.0, dest="grid_size",
        help="per-particle grid extent (m)")
    arg("--grid-res", type=float, default=0.25, dest="grid_res")
    arg("--keyframe-distance", type=float, default=0.3,
        dest="keyframe_distance",
        help="keyframe spacing (m); long routes want ~1.5 to keep the "
        "closure search small")
    arg("--closure-radius", type=float, default=2.0, dest="closure_radius",
        help="revisit-candidate radius on believed poses; must exceed the "
        "drift accumulated at revisit time")
    arg("--align-coarse", default=None, type=_coarse_spec,
        dest="align_coarse",
        help="'search_xy,steps,sigma' of a coarse stage seeding the fine "
        "sweep (e.g. '8.0,21,0.5' for metres of drift)")
    arg("--align-z", type=float, default=0.3, dest="align_z",
        help="vertical sweep half-range of the closure alignment")
    arg("--min-score", type=float, default=0.2, dest="min_score",
        help="closure acceptance score; raise on self-similar terrain")
    arg("--save-graph", default="", dest="save_graph",
        help="dump the keyframe graph + clouds + truth to this .npz before "
        "optimisation (the input of tools.closure_lab)")
    arg("--log-cache", default="", dest="log_cache",
        help="path prefix: reuse <prefix>.eslg + <prefix>.truth.npy if "
        "both exist, else record there (the route flags are the cache "
        "key, the caller's to keep)")
    arg("--turn-steps", type=int, default=0, dest="turn_steps",
        help="U-turn duration in steps (0 = steps/8); keep tight on long "
        "routes so the return leg re-crosses the out-leg ground")
    arg("--legs", type=int, default=2,
        help="straight legs (legs-1 U-turns); 4 = two out-and-back laps")
    arg("--yaw-prior", type=float, default=1e4, dest="yaw_prior",
        help="absolute IMU-heading prior information per keyframe (0 = "
        "off)")
    arg("--consist", type=float, default=1.0,
        help="median-consistency closure prune threshold in metres (0 = "
        "off)")
    arg("--robust", choices=["none", "dcs", "huber"], default="none",
        help="robust kernel of the backend solve")
    arg("--robust-delta", type=float, default=1.0, dest="robust_delta")
    arg("--solver", choices=["dense", "schur"], default="dense",
        help="pose-graph solver passed to OnlineSlam.optimize (whose "
        "builder, in both packages, runs the dense solve for 'schur')")
    arg("--min-ratio", type=float, default=1.25, dest="min_ratio",
        help="closure peak-distinctiveness gate: the best score must "
        "exceed min_ratio x the best score >0.75 m from the peak (1.0 = "
        "off).  Default 1.25, the library's (KeyframeManager); the JAX "
        "demo's 1.0 switched the gate off")
    arg("--closure-info", type=float, default=1000.0, dest="closure_info",
        help="information weight of closure edges (x score)")
    arg("--min-separation", type=int, default=0, dest="min_separation",
        help="keyframe-index gap of closure candidates (0 = "
        "closure_radius/keyframe_distance + 2)")
    return ap


def main(argv=None):
    """Run the demo; returns the JSON object it prints."""
    args = parser().parse_args(argv)
    device = entry_device("cpu" if args.cpu else None)
    world = World(args.extent)
    with tempfile.TemporaryDirectory() as tmp:
        path = args.log_cache + ".eslg" if args.log_cache else os.path.join(
            tmp, "loop.eslg")
        truth_path = args.log_cache + ".truth.npy"
        if args.log_cache and os.path.exists(path) \
                and os.path.exists(truth_path):
            truth = np.load(truth_path)
            print(f"log cache hit: {path} ({len(truth)} frames); the route "
                  "flags must match the recording")
        else:
            truth = record(path, args, world)
            if args.log_cache:
                np.save(truth_path, truth)
            print(f"recorded {len(truth)} frames ({args.steps} scans) -> "
                  f"{path} ({os.path.getsize(path) / 1024:.0f} KiB)")
        slam = make_slam(args, truth[0], device)
        if args.no_camera:
            frames, _ = streaming.frames_from_log(path, device=device)
        else:
            frames, _, intr = streaming.frames_from_log(
                path, camera=True, texture=True, device=device)
            if not np.allclose(intr, rigs()["intrinsics"], atol=1e-6):
                raise ValueError(f"the log's camera intrinsics {intr} are "
                                 "not the demo's")
    run = replay(slam, frames, args.chunk)
    result, extra = report(slam, truth, run, args)
    snapshot(slam, truth, run, extra, args.out)
    return result


if __name__ == "__main__":
    main()
