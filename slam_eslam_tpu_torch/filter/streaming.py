"""Streaming SLAM with per-particle maps: the per-frame loop.

Port of ``slam_eslam_tpu.filter.streaming`` on the laser path.  Per
frame, as the reference's ``EmbodiedSlamFilter`` (``.cpp:311-369``):

* odometry (or a precomputed odometry state) and particle propagation;
* measurement gate -> contact weighting through each particle's map
  chain (kernel K2) and ESS-gated resampling, which duplicates map
  chains by index (the reference's ``cloneMaps``);
* mapping gate -> copy-on-write heads, grid rollover, optional
  negative information and scan match, and the scan merge into every
  particle's active grid (kernel K3).

The JAX package gates with ``lax.cond`` on the device.  Here both gates
stay on the host: they depend only on the frames' ``body_pos``, ``q``
and ``has_scan`` and on anchors those inputs set, so ``SlamFrames``
keeps host copies of them and the step branches in Python.  Nothing in
a step reads a device value back to the host, and the map pool is
updated in place (a runner consumes the pool of the carry it is
given).  The camera path, the surface hash and a device mesh are not
ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from slam_eslam_tpu_torch.config import Config
from slam_eslam_tpu_torch.core.state import BodyContactState
from slam_eslam_tpu_torch.filter import pose_estimator as pe
from slam_eslam_tpu_torch.filter.step import StepDraws, cfg_odo
from slam_eslam_tpu_torch.mapping import map_pool as mp
from slam_eslam_tpu_torch.mapping import projection
from slam_eslam_tpu_torch.models import odometry as odom
from slam_eslam_tpu_torch.utils import tree

f32 = np.float32


@dataclasses.dataclass
class StreamingState:
    """The SLAM loop's carry: filter, map pool and the motion-gate
    anchors (the reference's ``udPose``/``mapPose``/``stereoPose``,
    ``EmbodiedSlamFilter.cpp:128,243,313``).  Anchors are host float32
    arrays and ``update_idx`` a Python int, because the gates run on
    the host; ``alloc_failed`` counts pool exhaustion on the device."""

    filter: pe.PoseEstimatorState
    pool: mp.MapPool
    ud_pos: np.ndarray     # [3]
    ud_q: np.ndarray       # [4]
    map_pos: np.ndarray    # [3]
    map_q: np.ndarray      # [4]
    cam_pos: np.ndarray    # [3]
    cam_q: np.ndarray      # [4]
    update_idx: int
    alloc_failed: torch.Tensor  # [] int32

    @staticmethod
    def create(filter_state, pool):
        far = lambda: np.array([1000.0, 0.0, 0.0], f32)
        qid = lambda: np.array([1.0, 0.0, 0.0, 0.0], f32)
        return StreamingState(
            filter=filter_state, pool=pool,
            ud_pos=far(), ud_q=qid(), map_pos=far(), map_q=qid(),
            cam_pos=far(), cam_q=qid(), update_idx=0,
            alloc_failed=torch.zeros((), dtype=torch.int32,
                                     device=pool.mean.device),
        )


@dataclasses.dataclass
class SlamFrames:
    """A frame stream with a leading time axis (``[T, ...]``; one frame
    without it), the port's form of the JAX frame tuple ``(contact_state,
    q, body_pos, scan_ranges, (start_angle, angular_resolution),
    has_scan)``.  The tensors live on the compute device; ``host_q``,
    ``host_body_pos`` and ``host_has_scan`` are float32/bool NumPy copies
    that the motion gates read."""

    contact: BodyContactState
    q: torch.Tensor                   # [T, 4]
    body_pos: torch.Tensor            # [T, 3]
    ranges: torch.Tensor              # [T, R]
    start_angle: torch.Tensor         # [T]
    angular_resolution: torch.Tensor  # [T]
    has_scan: torch.Tensor            # [T] bool
    host_q: np.ndarray
    host_body_pos: np.ndarray
    host_has_scan: np.ndarray

    def __len__(self):
        return self.q.shape[0]

    def at(self, t):
        """Frame ``t`` (the tensors indexed, the host copies too)."""
        return dataclasses.replace(
            tree.index(self, t), host_q=self.host_q[t],
            host_body_pos=self.host_body_pos[t],
            host_has_scan=self.host_has_scan[t])


def stack_frames(frames):
    """Per-frame tuples ``(contact_state, q, body_pos, ranges,
    (start_angle, angular_resolution), has_scan)`` of tensors, arrays or
    numbers -> ``SlamFrames`` on the CPU."""
    cs = tree.stack([fr[0] for fr in frames])
    col = lambda i, dt: torch.stack(
        [torch.as_tensor(np.asarray(fr[i]), dtype=dt) for fr in frames])
    meta = lambda j: torch.tensor([float(fr[4][j]) for fr in frames],
                                  dtype=torch.float32)
    q, pos = col(1, torch.float32), col(2, torch.float32)
    has_scan = col(5, torch.bool)
    return SlamFrames(
        contact=cs, q=q, body_pos=pos, ranges=col(3, torch.float32),
        start_angle=meta(0), angular_resolution=meta(1), has_scan=has_scan,
        host_q=q.numpy().copy(), host_body_pos=pos.numpy().copy(),
        host_has_scan=has_scan.numpy().copy())


def _quat_angle(qa, qb):
    """Rotation angle between two unit quaternions (float32, host)."""
    d = np.abs(np.sum(qa * qb, dtype=f32))
    return f32(2.0) * np.arccos(np.clip(d, f32(-1.0), f32(1.0)))


def _quat_rotate(q, v):
    """``geometry.quat_rotate`` for one quaternion, float32 on the host."""
    w, u = q[0], q[1:4]
    uv = np.cross(u, v)
    return v + f32(2.0) * (w * uv + np.cross(u, uv))


def _passes(threshold, dist, angle):
    """``UpdateThreshold.test`` in float32."""
    return bool((dist > f32(threshold.distance))
                | (angle > f32(threshold.angle)))


def make_slam_step(cfg: Config, laser2body=None, hash_=None, mesh=None,
                   camera2body=None, external_odometry=False):
    """Build ``step(carry, frame, odo_state=None, draws=None) -> (carry,
    aux)`` for one ``SlamFrames`` frame.

    ``laser2body = (rot [3, 3], trans [3])``.  ``cfg.use_visual_update``
    adds the scan-match weight ``w *= match^0.1``
    (``EmbodiedSlamFilter.cpp:214-221``) and
    ``cfg.grid_use_negative_information`` clears contradicted patches
    before each merge.  With ``external_odometry`` the frame's odometry
    state ``odo_state`` is given (``precompute_odometry``), which
    compacted contact states require.  ``draws`` (a
    ``step.StepDraws``) are the frame's random draws; its
    ``resample_u`` is used only when the measurement gate fires.  ``aux``
    holds the device ``centroid [3]`` and ``best_pose [4]`` and the host
    flags ``updated`` and ``mapped``."""
    for name, value in (("hash_", hash_), ("camera2body", camera2body),
                        ("mesh", mesh)):
        if value is not None:
            raise NotImplementedError(
                f"make_slam_step({name}=...) is not ported yet (ROADMAP.md "
                "queue 1: in-loop hash reinjection, the camera path, "
                "multi-GPU)")
    match = cfg.use_visual_update
    odo_cfg = cfg_odo(cfg)
    threshold = cfg.grid_size / 2.0 * cfg.grid_threshold
    rot = np.eye(3) if laser2body is None else np.asarray(laser2body[0])
    trans = np.zeros(3) if laser2body is None else np.asarray(laser2body[1])
    host_trans = trans.astype(f32)
    lasers = {}

    def laser(device):
        """The extrinsics on ``device``, copied once, asynchronously from
        pinned memory for a GPU (a blocking copy would sync the host)."""
        if device not in lasers:
            host = [torch.as_tensor(a, dtype=torch.float32)
                    for a in (rot, trans)]
            if device.type == "cuda":
                host = [h.pin_memory() for h in host]
            lasers[device] = tuple(h.to(device, non_blocking=True)
                                   for h in host)
        return lasers[device]

    def step(carry: StreamingState, frame: SlamFrames, odo_state=None,
             draws: StepDraws | None = None):
        q = frame.q
        st = carry.filter
        st = dataclasses.replace(st, odometry=(
            odo_state if external_odometry
            else odom.update(st.odometry, frame.contact, q, odo_cfg)))
        st = pe.project(st, q, cfg, None if draws is None else draws.project)
        pool = carry.pool

        # ---- measurement gate (EmbodiedSlamFilter.cpp:353-369) ----
        q_h, pos_h = frame.host_q, frame.host_body_pos
        do_update = _passes(cfg.measurement_threshold,
                            np.linalg.norm(pos_h - carry.ud_pos),
                            _quat_angle(q_h, carry.ud_q))
        ud_pos, ud_q = carry.ud_pos, carry.ud_q
        if do_update:
            lookup = mp.make_chain_lookup(pool, cfg.mls_z_window)
            st, aux = pe.update(st, frame.contact, q, lookup, cfg,
                                None if draws is None else draws.resample_u)
            # chains follow the resampled particles (PoseEstimator.cpp:
            # 249-253's cloneMaps as an O(N) index gather)
            pool = pool.resample(aux["resample_idx"])
            p = st.particles
            st = dataclasses.replace(st, particles=dataclasses.replace(
                p, map_id=torch.arange(p.n, dtype=torch.int32,
                                       device=p.x.device)))
            ud_pos, ud_q = pos_h, q_h

        # ---- laser mapping gate (EmbodiedSlamFilter.cpp:311-351) ----
        laser_pos = pos_h + _quat_rotate(q_h, host_trans)
        do_map = bool(frame.host_has_scan) and _passes(
            cfg.mapping_threshold, np.linalg.norm(laser_pos - carry.map_pos),
            _quat_angle(q_h, carry.map_q))
        update_idx, failed = carry.update_idx, carry.alloc_failed
        map_pos, map_q = carry.map_pos, carry.map_q
        if do_map:
            l_rot, l_trans = laser(q.device)
            scan = projection.LaserScan(frame.ranges, frame.start_angle,
                                        frame.angular_resolution)
            pts, valid = projection.scan_to_points(scan,
                                                   cfg.max_sensor_range)
            cloud = projection.project_points(pts, valid, l_rot, l_trans, q)
            p = st.particles
            xy = p.xy
            pool, f1 = mp.ensure_unique_active(pool,
                                               shards=cfg.map_pool_shards)
            pool, f2 = mp.rollover(pool, xy, threshold,
                                   shards=cfg.map_pool_shards)
            failed = failed + f1 + f2
            if cfg.grid_use_negative_information:
                # the laser path only (EmbodiedSlamFilter.cpp:160)
                free_pts, free_mask = projection.free_space_points(
                    pts, valid, l_rot, l_trans, q)
                mp.apply_negative_cloud_all(pool, xy, p.yaw, p.z, free_pts,
                                            free_mask)
            if match:
                w = mp.match_cloud_all(pool, xy, p.yaw, p.z, p.z_sigma,
                                       cloud, sampling=10, sigma=0.2,
                                       z_window=cfg.mls_z_window)
                # visualWeighting = 0.1 (EmbodiedSlamFilter.cpp:219-220)
                st = dataclasses.replace(st, particles=dataclasses.replace(
                    p, weight=p.weight * torch.pow(w.clamp(min=1e-30), 0.1)))
            mp.merge_cloud_all(pool, xy, p.yaw, p.z, p.z_sigma, cloud,
                               update_idx,
                               patch_thickness=cfg.grid_patch_thickness,
                               gap_size=cfg.grid_gap_size)
            update_idx += 1
            map_pos, map_q = laser_pos, q_h

        c_pos, _ = pe.centroid(st.particles, q,
                               wrap_safe=cfg.wrap_safe_centroid)
        p = st.particles
        bi = torch.argmax(p.weight).reshape(1)
        best_pose = torch.cat([p.x.index_select(0, bi),
                               p.y.index_select(0, bi),
                               p.z.index_select(0, bi),
                               p.yaw.index_select(0, bi)])
        out = dataclasses.replace(
            carry, filter=st, pool=pool, ud_pos=ud_pos, ud_q=ud_q,
            map_pos=map_pos, map_q=map_q, update_idx=update_idx,
            alloc_failed=failed)
        return out, {"centroid": c_pos, "updated": do_update,
                     "mapped": do_map, "best_pose": best_pose}

    return step


def make_slam_scan_runner(cfg: Config, laser2body=None, hash_=None,
                          mesh=None, camera2body=None,
                          external_odometry=False):
    """Roll a ``SlamFrames`` stream through ``make_slam_step``:
    ``run(carry, frames, odos=None, draws=None) -> (carry, aux)``, with
    ``odos`` the stacked per-frame odometry states of
    ``precompute_odometry`` (``external_odometry=True``) and ``draws`` a
    sequence of one ``step.StepDraws`` per frame.  ``aux``: ``centroid
    [T, 3]`` and ``best_pose [T, 4]`` on the device, ``updated`` and
    ``mapped`` ``[T]`` bool NumPy arrays.  The carry's pool is updated in
    place: the JAX runner's ``donate=True``, always."""
    step = make_slam_step(cfg, laser2body=laser2body, hash_=hash_,
                          mesh=mesh, camera2body=camera2body,
                          external_odometry=external_odometry)

    def run(carry: StreamingState, frames: SlamFrames, odos=None,
            draws=None):
        if external_odometry and odos is None:
            raise ValueError("external_odometry=True needs the stacked "
                             "odometry states (precompute_odometry)")
        cents, bests, updated, mapped = [], [], [], []
        for t in range(len(frames)):
            carry, aux = step(
                carry, frames.at(t),
                tree.index(odos, t) if external_odometry else None,
                None if draws is None else draws[t])
            cents.append(aux["centroid"])
            bests.append(aux["best_pose"])
            updated.append(aux["updated"])
            mapped.append(aux["mapped"])
        return carry, {"centroid": torch.stack(cents),
                       "best_pose": torch.stack(bests),
                       "updated": np.array(updated, bool),
                       "mapped": np.array(mapped, bool)}

    return run


def precompute_odometry(num_points, contact_states, orientations,
                        cfg: Config = None):
    """Per-frame odometry states from the full (uncompacted) contact
    stream: ``odometry.update`` rolled over the trajectory.
    ``contact_states`` is a stacked ``BodyContactState`` (``[T, C, ...]``),
    ``orientations [T, 4]``.  Returns the stacked ``FootContactOdometry``
    (``[T, ...]``) on the inputs' device."""
    odo_cfg = cfg_odo(cfg if cfg is not None else Config())
    odo = odom.FootContactOdometry.create(num_points,
                                          orientations.device)
    states = []
    for t in range(orientations.shape[0]):
        odo = odom.update(odo, tree.index(contact_states, t),
                          orientations[t], odo_cfg)
        states.append(odo)
    return tree.stack(states)
