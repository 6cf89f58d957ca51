"""Streaming SLAM with per-particle maps: the per-frame loop.

Port of ``slam_eslam_tpu.filter.streaming``.  Per frame, as the
reference's ``EmbodiedSlamFilter`` (``.cpp:239-369``):

* odometry (or a precomputed odometry state) and particle propagation;
* measurement gate -> contact weighting through each particle's map
  chain (kernel K2) and ESS-gated resampling, which duplicates map
  chains by index (the reference's ``cloneMaps``);
* mapping gate -> copy-on-write heads, grid rollover, optional
  negative information and scan match, and the scan merge into every
  particle's active grid (kernel K3);
* hash reinjection every ``period`` projections, when a surface hash is
  given (``PoseEstimator.cpp:239-241``);
* camera gate (its own ``stereoPose`` anchor) -> the distance image,
  textured or not, merged into every particle's active grid, never
  matched (``processMap(scanMap, false, true)``, ``.cpp:301``).

The JAX package gates with ``lax.cond`` on the device.  Here every gate
stays on the host: they depend only on the frames' ``body_pos``, ``q``,
``has_scan`` and ``has_dimg``, on anchors those inputs set and on the
count of projections, so ``SlamFrames`` keeps host copies of them, the
carry counts its steps on the host, and the step branches in Python.
Nothing in a step reads a device value back to the host, and the map
pool is updated in place (a runner consumes the pool of the carry it is
given).  ``frames_from_log`` reads a recorded traverse (``io.logio``)
into ``SlamFrames`` on the device.

On a device mesh (``mesh=``) the carry holds this rank's particles
(``parallel.sharding.shard_state``) and the draws are the global ones.
The gates stay on the host, outside every collective: every rank reads
the same host odometry, so every rank takes the same branches and joins
the same collectives.  The pool is either held whole on every rank with
this rank's chain rows (``map_pool_shards == 1``: every rank applies
every particle's copy-on-write and merge from gathered poses and chain
rows) or split by block range (``parallel.sharding.shard_pool`` with
``map_pool_shards`` equal to the mesh size: ``mapping.map_pool``'s
meshed operations, K3 on the rank's own blocks).  Either way a meshed
run equals the single-process run with the same ``map_pool_shards``, and
the meshed pool's exchanges have fixed shapes and read nothing back, so a
meshed step captures as an unmeshed one does (NCCL meshes only).

The runners' ``graph=None`` (the default, as the JAX package's runners
are jitted) runs CUDA graphs on a CUDA device with no mesh or an NCCL
mesh, and the eager loop on the CPU and on a gloo or host mesh
(``utils.graphs.resolve``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from slam_eslam_tpu_torch.config import Config
from slam_eslam_tpu_torch.core import filter as pf
from slam_eslam_tpu_torch.core.state import BodyContactState
from slam_eslam_tpu_torch.filter import pose_estimator as pe
from slam_eslam_tpu_torch.filter.step import StepDraws, cfg_odo
from slam_eslam_tpu_torch.mapping import map_pool as mp
from slam_eslam_tpu_torch.mapping import projection
from slam_eslam_tpu_torch.models import odometry as odom
from slam_eslam_tpu_torch.parallel import sharding as shd
from slam_eslam_tpu_torch.utils import graphs, tracing, tree
from slam_eslam_tpu_torch.utils.device import entry_device, to_device_async

f32 = np.float32


@dataclasses.dataclass
class StreamingState:
    """The SLAM loop's carry: filter, map pool and the motion-gate
    anchors (the reference's ``udPose``/``mapPose``/``stereoPose``,
    ``EmbodiedSlamFilter.cpp:128,243,313``).  Anchors are host float32
    arrays, ``update_idx`` a Python int and ``steps`` the host's copy of
    ``filter.step`` (the hash period counts projections), because the
    gates run on the host; ``alloc_failed`` counts pool exhaustion on the
    device."""

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
    steps: int = 0

    @staticmethod
    def create(filter_state, pool, steps=None):
        """``steps``: the projections ``filter_state`` has seen; read from
        its device counter when not given."""
        far = lambda: np.array([1000.0, 0.0, 0.0], f32)
        qid = lambda: np.array([1.0, 0.0, 0.0, 0.0], f32)
        return StreamingState(
            filter=filter_state, pool=pool,
            ud_pos=far(), ud_q=qid(), map_pos=far(), map_q=qid(),
            cam_pos=far(), cam_q=qid(), update_idx=0,
            alloc_failed=torch.zeros((), dtype=torch.int32,
                                     device=pool.mean.device),
            steps=int(filter_state.step) if steps is None else steps,
        )


@dataclasses.dataclass
class SlamFrames:
    """A frame stream with a leading time axis (``[T, ...]``; one frame
    without it), the port's form of the JAX frame tuple ``(contact_state,
    q, body_pos, scan_ranges, (start_angle, angular_resolution),
    has_scan)`` and, on the camera path, ``(..., dimg, has_dimg)`` or
    ``(..., dimg, has_dimg, timg)``.  The tensors live on the compute
    device; ``host_q``, ``host_body_pos``, ``host_has_scan`` and
    ``host_has_dimg`` are float32/bool NumPy copies that the gates
    read."""

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
    dimg: torch.Tensor | None = None      # [T, H, W] distance images
    has_dimg: torch.Tensor | None = None  # [T] bool
    timg: torch.Tensor | None = None      # [T, H, W, 3] RGB textures
    host_has_dimg: np.ndarray | None = None

    def __len__(self):
        return self.q.shape[0]

    def at(self, t):
        """Frame ``t``, or the frames of a slice ``t`` (the tensors
        indexed, the host copies too)."""
        return dataclasses.replace(
            tree.index(self, t), host_q=self.host_q[t],
            host_body_pos=self.host_body_pos[t],
            host_has_scan=self.host_has_scan[t],
            host_has_dimg=(None if self.host_has_dimg is None
                           else self.host_has_dimg[t]))


def stack_frames(frames):
    """Per-frame tuples ``(contact_state, q, body_pos, ranges,
    (start_angle, angular_resolution), has_scan[, dimg, has_dimg[,
    timg]])`` of tensors, arrays or numbers -> ``SlamFrames`` on the
    CPU."""
    cs = tree.stack([fr[0] for fr in frames])
    col = lambda i, dt: torch.stack(
        [torch.as_tensor(np.asarray(fr[i]), dtype=dt) for fr in frames])
    meta = lambda j: torch.tensor([float(fr[4][j]) for fr in frames],
                                  dtype=torch.float32)
    q, pos = col(1, torch.float32), col(2, torch.float32)
    has_scan = col(5, torch.bool)
    camera = {}
    if len(frames[0]) > 6:
        has_dimg = col(7, torch.bool)
        camera = dict(dimg=col(6, torch.float32), has_dimg=has_dimg,
                      host_has_dimg=has_dimg.numpy().copy())
        if len(frames[0]) > 8:
            camera["timg"] = col(8, torch.float32)
    return SlamFrames(
        contact=cs, q=q, body_pos=pos, ranges=col(3, torch.float32),
        start_angle=meta(0), angular_resolution=meta(1), has_scan=has_scan,
        host_q=q.numpy().copy(), host_body_pos=pos.numpy().copy(),
        host_has_scan=has_scan.numpy().copy(), **camera)


def frames_from_log(path, camera=False, texture=False, device=None):
    """A recorded traverse (``io.logio`` native log) -> ``SlamFrames`` on
    ``device`` (the CUDA device unless given), through the batched C
    gather (``logio.load_stream``): the whole log becomes a handful of
    contiguous host arrays, each copied to the device once.  Pose records
    are required (the motion gates read them).

    Returns ``(frames, ts [T])``.  With ``camera=True`` the frames carry
    the distance images (DISTANCE_IMAGE records required) and the return
    is ``(frames, ts, intrinsics)``: pass ``intrinsics`` as
    ``camera_intrinsics`` to the runner.  With ``texture=True`` they also
    carry the RGB textures (TEXTURE_IMAGE records; the runner's
    ``camera_texture=True`` needs a colour-carrying pool)."""
    from slam_eslam_tpu_torch.io import logio

    device = entry_device(device)
    s = logio.load_stream(path)
    if s["pose"] is None:
        raise ValueError(
            "streaming replay needs pose records (the motion-gate input)")
    if s["orientation"] is None:
        raise ValueError("streaming replay needs orientation records")
    if camera and s["dimg"] is None:
        raise ValueError(
            f"camera=True but {path} has no DISTANCE_IMAGE records")
    if camera and texture and s["timg"] is None:
        raise ValueError(
            f"texture=True but {path} has no TEXTURE_IMAGE records")
    put = lambda a: torch.from_numpy(np.array(a)).to(device)
    contact = s["contact"]
    t = contact.shape[0]
    cs = BodyContactState(
        position=put(contact["position"]), contact=put(contact["contact"]),
        slip=put(contact["slip"]), group_id=put(contact["group_id"]),
        valid=torch.ones(contact.shape, dtype=torch.bool, device=device))
    if s["scan_ranges"] is not None:
        ranges, (start, res) = s["scan_ranges"], s["scan_meta"]
    else:  # no scans: empty rays, the mapping gate never fires
        ranges, start, res = np.zeros((t, 1), f32), 0.0, 1.0
    q, body_pos = s["orientation"], s["pose"][:, :3]
    full = lambda v: torch.full((t,), v, dtype=torch.float32, device=device)
    frames = dict(
        contact=cs, q=put(q), body_pos=put(body_pos), ranges=put(ranges),
        start_angle=full(start), angular_resolution=full(res),
        has_scan=put(s["has_scan"]), host_q=q.copy(),
        host_body_pos=body_pos.copy(), host_has_scan=s["has_scan"].copy())
    if camera:
        frames.update(dimg=put(s["dimg"]), has_dimg=put(s["has_dimg"]),
                      host_has_dimg=s["has_dimg"].copy())
        if texture:
            frames["timg"] = put(s["timg"])
    frames = SlamFrames(**frames)
    if not camera:
        return frames, s["ts"]
    return frames, s["ts"], s["dimg_meta"]


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


# ---- the parts of a frame's device work, shared with the application API
# (``eslam_filter.EmbodiedSlamFilter``) ----

def own_heads(cfg: Config, pool, p, failed=None):
    """Copy-on-write heads and grid rollover before a merge
    (``EmbodiedSlamFilter.cpp:195-207``), in place: ``(pool, failed``
    plus the particles the pool had no block for``)``; ``failed`` None
    counts from nothing."""
    with tracing.stage("own heads", p.x.device):
        pool, f1 = mp.ensure_unique_active(pool, shards=cfg.map_pool_shards)
        pool, f2 = mp.rollover(pool, p.xy,
                               cfg.grid_size / 2.0 * cfg.grid_threshold,
                               shards=cfg.map_pool_shards)
        return pool, (f1 if failed is None else failed + f1) + f2


def follow_chains(st, pool, idx, in_place, mesh=None):
    """The map chains follow the resampled particles along ``idx``
    (``PoseEstimator.cpp:249-253``'s cloneMaps as an O(N) index gather;
    ``in_place``: into ``pool.chain``, whose storage a graph keeps; on a
    mesh the gathered rows make a new chain, which a graphed step writes
    back into the carry's), and
    every particle's ``map_id`` is its row again."""
    pool = (pool.resample_(idx) if in_place and mesh is None
            else pool.resample(idx, mesh))
    p = st.particles
    lo = 0 if mesh is None else mesh.rank * p.n
    return dataclasses.replace(st, particles=dataclasses.replace(
        p, map_id=torch.arange(lo, lo + p.n, dtype=torch.int32,
                               device=p.x.device))), pool


def measure(cfg: Config, st, pool, contact, q, resample_u, in_place,
            mesh=None, terrain_prob=None):
    """The measurement update through every particle's map chain (kernel
    K2; ``EmbodiedSlamFilter.cpp:353-369``) and the chains following the
    resampled particles.  Returns ``(state, pool, aux)`` (``aux`` of
    ``pose_estimator.update``)."""
    with tracing.stage("measure", st.particles.x.device):
        lookup = mp.make_chain_lookup(pool, cfg.mls_z_window, mesh=mesh)
        st, aux = pe.update(st, contact, q, lookup, cfg, resample_u,
                            terrain_prob, mesh=mesh)
        st, pool = follow_chains(st, pool, aux["resample_idx"], in_place,
                                 mesh)
        return st, pool, aux


def weigh_by_match(st, score, mesh=None):
    """``w *= match^0.1`` (visualWeighting = 0.1,
    ``EmbodiedSlamFilter.cpp:219-220``), the power taken over every
    particle's score and then this rank's part: the CPU's pow over a
    slice may round otherwise."""
    w = torch.pow(score.clamp(min=1e-30), 0.1)
    p = st.particles
    return dataclasses.replace(st, particles=dataclasses.replace(
        p, weight=p.weight * (w if mesh is None else mesh.local(w))))


def laser_cloud(cfg: Config, scan, q, l_rot, l_trans, negative):
    """A laser scan as a ``PatchCloud`` in the scan frame, and its
    free-space samples ``(points, mask)`` when ``negative``, else None."""
    pts, valid = projection.scan_to_points(scan, cfg.max_sensor_range)
    cloud = projection.project_points(pts, valid, l_rot, l_trans, q)
    free = (projection.free_space_points(pts, valid, l_rot, l_trans, q)
            if negative else None)
    return cloud, free


def camera_cloud(cfg: Config, img, q, c_rot, c_trans, texture=None):
    """A distance image as a ``PatchCloud``, with ``texture [H, W, 3]``
    as patch colour when given."""
    pts, valid = projection.distance_image_to_points(img,
                                                     cfg.max_sensor_range)
    color = (projection.texture_colors(img, texture)
             if texture is not None else None)
    return projection.project_points(pts, valid, c_rot, c_trans, q,
                                     color=color)


def map_cloud(cfg: Config, st, pool, p, cloud, update_idx, failed=None,
              free=None, match=False, update=True, mesh=None):
    """One cloud into every particle's map (``processMap``,
    ``EmbodiedSlamFilter.cpp:179-232``): with ``update`` own heads, the
    free-space samples ``free`` cleared (the laser path only, ``:160``)
    and, after the ``match`` weighting, the merge (kernel K3) stamped
    with ``update_idx``.  ``p``: the particles whose maps ``pool`` holds
    (on a mesh with a pool held whole, every particle); ``st``: this
    rank's state.  Returns ``(st, pool, failed, update_idx)``."""
    if update:
        pool, failed = own_heads(cfg, pool, p, failed)
        if free is not None:
            with tracing.stage("merge", p.x.device):
                mp.apply_negative_cloud_all(pool, p.xy, p.yaw, p.z, *free)
    if match:
        w = mp.match_cloud_all(pool, p.xy, p.yaw, p.z, p.z_sigma, cloud,
                               sampling=10, sigma=0.2,
                               z_window=cfg.mls_z_window)
        if pool.mesh is not None:
            w = mesh.all_gather(w)
        st = weigh_by_match(st, w, mesh)
    if update:
        with tracing.stage("merge", p.x.device):
            mp.merge_cloud_all(pool, p.xy, p.yaw, p.z, p.z_sigma, cloud,
                               update_idx,
                               patch_thickness=cfg.grid_patch_thickness,
                               gap_size=cfg.grid_gap_size)
        update_idx = update_idx + 1
    return st, pool, failed, update_idx


@dataclasses.dataclass
class _DeviceCarry:
    """The device part of a ``StreamingState``, as a graphed runner keeps
    it in static buffers: the filter, the pool (the caller's, updated in
    place), ``alloc_failed`` and the device mirror of ``update_idx`` ([]
    int32) that the merge kernel reads."""

    filter: pe.PoseEstimatorState
    pool: mp.MapPool
    alloc_failed: torch.Tensor
    update_idx: torch.Tensor


def make_slam_step(cfg: Config, laser2body=None, hash_=None, match=None,
                   update=True, mesh=None, camera2body=None,
                   camera_intrinsics=None, camera_texture=False,
                   odometry_config=None, external_odometry=False,
                   graph=False):
    """Build ``step(carry, frame, odo_state=None, draws=None) -> (carry,
    aux)`` for one ``SlamFrames`` frame.

    ``laser2body = (rot [3, 3], trans [3])``.  ``match`` (default
    ``cfg.use_visual_update``) adds the scan-match weight ``w *=
    match^0.1`` (``EmbodiedSlamFilter.cpp:214-221``), ``update`` merges
    the scans into the per-particle maps (``:344``), and
    ``cfg.grid_use_negative_information`` clears contradicted patches
    before each laser merge.  ``hash_`` (a ``SurfaceHash``) reinjects
    candidates every ``hash_.config.period`` projections and turns the
    recovery spreading of ``project`` off.

    With ``camera2body`` the frames carry ``dimg`` and ``has_dimg``: the
    distance-image path of the reference (``:239-309``), gated by
    ``cfg.mapping_camera_threshold`` on its own anchor and always merged,
    never matched.  ``camera_intrinsics = (scale_x, scale_y, center_x,
    center_y)`` of the distance image are static (the reference builds its
    ``DistanceGrid`` once, ``:247-252``).  With ``camera_texture`` the
    frames' ``timg [H, W, 3]`` rides on the merged patches as colour,
    which needs a colour-carrying pool.

    With ``external_odometry`` the frame's odometry state ``odo_state``
    is given (``precompute_odometry``), which compacted contact states
    require; otherwise odometry runs with ``odometry_config`` (default:
    from ``cfg``).  ``draws`` (a ``step.StepDraws``) are the frame's
    random draws; its ``resample_u`` is used only when the measurement
    gate fires and its ``hash_u`` only on a reinjection frame.  ``aux``
    holds the device ``centroid [3]`` and ``best_pose [4]`` and the host
    flags ``updated``, ``mapped`` and, on the camera path,
    ``cam_mapped``.

    ``mesh``: see the module docstring; ``centroid`` and ``best_pose`` are
    global, the same on every rank.

    ``graph=True`` (CUDA only; a mesh only over NCCL): the host gates
    pick one CUDA graph per combination of (measurement update, laser mapping,
    camera mapping, hash reinjection), at most sixteen, each run eagerly
    at its first meeting, captured at its second and replayed after
    (``utils.graphs``).  The frame's inputs (the distance image and its
    texture, the hash's draws included) are copied into static buffers,
    ``update_idx`` has a device mirror that the merge kernel reads, the
    camera anchor is mirrored on the host as the laser anchor is, and the
    resampled chains are written back into ``pool.chain`` in place.  A
    step equals the eager step bit for bit; the pool is the caller's,
    updated in place, the filter state, the outputs and ``alloc_failed``
    are new tensors.  ``graph=None`` (the default): graphs where the
    carry's device and the mesh allow them, else eager (module
    docstring).  The step's ``graphs`` is its ``utils.graphs.ShapeGraphs``,
    None for the eager step."""
    if camera2body is not None and camera_intrinsics is None:
        raise ValueError("camera2body needs camera_intrinsics=(scale_x, "
                         "scale_y, center_x, center_y)")
    if match is None:
        match = cfg.use_visual_update
    odo_cfg = odometry_config if odometry_config is not None else cfg_odo(cfg)
    period = None if hash_ is None else max(1, hash_.config.period)
    mounts = {"laser": ((np.eye(3), np.zeros(3)) if laser2body is None
                        else laser2body)}
    if camera2body is not None:
        mounts["camera"] = camera2body
    host_trans = {name: np.asarray(m[1], f32) for name, m in mounts.items()}
    on_device = {}

    def constants(device):
        """The extrinsics and camera intrinsics on ``device``, copied
        once (``to_device_async``: no blocking copy inside a frame)."""
        if device not in on_device:
            out = {name: tuple(to_device_async(a, device) for a in m)
                   for name, m in mounts.items()}
            if camera2body is not None:
                out["intrinsics"] = tuple(to_device_async(v, device)
                                          for v in camera_intrinsics)
            on_device[device] = out
        return on_device[device]

    def pool_view(pool, p):
        """``(pool, particles, back)``: the pool and the particles a
        mapping update works on, and the function that turns the worked
        pool back into the carry's.  On a mesh with a pool held whole on
        every rank: every particle (gathered) and every chain row."""
        if mesh is None or pool.mesh is not None:
            return pool, p, (lambda v: v)
        n = pe.global_count(p, mesh)
        gp = pf.take(p, torch.arange(n, device=p.x.device), mesh)
        view = dataclasses.replace(pool, chain=mesh.all_gather(pool.chain))
        back = lambda v: dataclasses.replace(
            v, chain=mesh.local(v.chain).clone())
        return view, gp, back

    def best(p):
        """``[x, y, z, yaw]`` of the heaviest particle (the first on ties),
        over every rank."""
        bi = torch.argmax(p.weight).reshape(1)
        row = torch.cat([p.weight.index_select(0, bi),
                         p.x.index_select(0, bi), p.y.index_select(0, bi),
                         p.z.index_select(0, bi),
                         p.yaw.index_select(0, bi)])
        if mesh is None:
            return row[1:]
        rows = mesh.all_gather(row[None])
        # a one-element index: a 0-d device index is read back to the host
        top = torch.argmax(rows[:, 0]).reshape(1)
        return rows.index_select(0, top)[0, 1:]

    def gates(carry, q_h, pos_h, has_scan, has_dimg):
        """The host gates of a frame (``EmbodiedSlamFilter.cpp:
        239-369``): ``(key, laser_pos, cam_pos)`` with ``key =
        (do_update, do_map, do_cam, do_hash)``."""
        do_update = _passes(cfg.measurement_threshold,
                            np.linalg.norm(pos_h - carry.ud_pos),
                            _quat_angle(q_h, carry.ud_q))
        laser_pos = pos_h + _quat_rotate(q_h, host_trans["laser"])
        do_map = bool(has_scan) and _passes(
            cfg.mapping_threshold, np.linalg.norm(laser_pos - carry.map_pos),
            _quat_angle(q_h, carry.map_q))
        cam_pos, do_cam = None, False
        if camera2body is not None:
            cam_pos = pos_h + _quat_rotate(q_h, host_trans["camera"])
            do_cam = bool(has_dimg) and _passes(
                cfg.mapping_camera_threshold,
                np.linalg.norm(cam_pos - carry.cam_pos),
                _quat_angle(q_h, carry.cam_q))
        # hash reinjection every `period` projections
        # (PoseEstimator.cpp:239-241)
        do_hash = hash_ is not None and (carry.steps + 1) % period == 0
        return (do_update, do_map, do_cam, do_hash), laser_pos, cam_pos

    def host_fields(carry, key, q_h, pos_h, laser_pos, cam_pos):
        """The carry's host fields after a frame of gates ``key``."""
        do_update, do_map, do_cam, _ = key
        host = dict(steps=carry.steps + 1)
        if do_update:
            host.update(ud_pos=pos_h, ud_q=q_h)
        if do_map:
            host.update(map_pos=laser_pos, map_q=q_h)
        if do_cam:
            host.update(cam_pos=cam_pos, cam_q=q_h)
        return host

    def propagate(st, contact, q, odo_state, draws):
        with tracing.stage("propagate", q.device):
            st = dataclasses.replace(st, odometry=(
                odo_state if external_odometry
                else odom.update(st.odometry, contact, q, odo_cfg)))
            return pe.project(st, q, cfg,
                              None if draws is None else draws.project,
                              use_hash=hash_ is not None, mesh=mesh)

    def laser_map(st, pool, failed, update_idx, q, scan):
        """The laser mapping update (``EmbodiedSlamFilter.cpp:311-351``):
        heads, negative information, the match, the merge."""
        l_rot, l_trans = constants(q.device)["laser"]
        cloud, free = laser_cloud(
            cfg, scan, q, l_rot, l_trans,
            update and cfg.grid_use_negative_information)
        view, gp, back = pool_view(pool, st.particles)
        st, view, failed, update_idx = map_cloud(
            cfg, st, view, gp, cloud, update_idx, failed, free, match,
            update, mesh)
        return st, back(view), failed, update_idx

    def camera_map(st, pool, failed, update_idx, q, dimg, timg):
        """The camera mapping update (``EmbodiedSlamFilter.cpp:239-309``):
        heads and the merge, never matched (``processMap(scanMap, false,
        true)``, ``:301``)."""
        consts = constants(q.device)
        c_rot, c_trans = consts["camera"]
        with tracing.stage("camera cloud", q.device):
            cloud = camera_cloud(
                cfg, projection.DistanceImage(dimg, *consts["intrinsics"]),
                q, c_rot, c_trans, timg if camera_texture else None)
        view, gp, back = pool_view(pool, st.particles)
        st, view, failed, update_idx = map_cloud(cfg, st, view, gp, cloud,
                                                 update_idx, failed)
        return st, back(view), failed, update_idx

    def device_step(st, pool, failed, update_idx, x, key, in_place):
        """One frame's device work for the gates ``key``: ``(state, pool,
        failed, update_idx, (centroid, best_pose))``."""
        do_update, do_map, do_cam, do_hash = key
        contact, q, ranges, start, res, dimg, timg, odo_state, draws = x
        st = propagate(st, contact, q, odo_state, draws)
        if do_update:
            st, pool, _ = measure(cfg, st, pool, contact, q,
                                  None if draws is None else draws.resample_u,
                                  in_place, mesh)
        if do_hash:
            # on a mesh over every particle, from the global draws
            with tracing.stage("reinject", q.device):
                st = shd.shard_state(hash_.reinject(
                    shd.gather_state(st, mesh), contact, q, cfg,
                    None if draws is None else draws.hash_u), mesh)
        if do_map:
            st, pool, failed, update_idx = laser_map(
                st, pool, failed, update_idx, q,
                projection.LaserScan(ranges, start, res))
        if do_cam:
            st, pool, failed, update_idx = camera_map(
                st, pool, failed, update_idx, q, dimg, timg)
        c_pos, _ = pe.centroid(st.particles, q,
                               wrap_safe=cfg.wrap_safe_centroid, mesh=mesh)
        with tracing.stage("centroid", q.device):
            best_pose = best(st.particles)
        return st, pool, failed, update_idx, (c_pos, best_pose)

    def frame_inputs(frame: SlamFrames, odo_state, draws):
        """The device inputs of a frame: what ``device_step`` reads."""
        return (frame.contact, frame.q, frame.ranges, frame.start_angle,
                frame.angular_resolution,
                frame.dimg if camera2body is not None else None,
                frame.timg if camera_texture else None, odo_state, draws)

    def frame_aux(key, c_pos, best_pose):
        aux = {"centroid": c_pos, "updated": key[0], "mapped": key[1],
               "best_pose": best_pose}
        if camera2body is not None:
            aux["cam_mapped"] = key[2]
        return aux

    def step(carry: StreamingState, frame: SlamFrames, odo_state=None,
             draws: StepDraws | None = None):
        key, laser_pos, cam_pos = gates(carry, frame.host_q,
                                        frame.host_body_pos,
                                        frame.host_has_scan,
                                        frame.host_has_dimg)
        st, pool, failed, update_idx, (c_pos, best_pose) = device_step(
            carry.filter, carry.pool, carry.alloc_failed, carry.update_idx,
            frame_inputs(frame, odo_state, draws), key, False)
        out = dataclasses.replace(
            carry, filter=st, pool=pool, update_idx=update_idx,
            alloc_failed=failed,
            **host_fields(carry, key, frame.host_q, frame.host_body_pos,
                          laser_pos, cam_pos))
        return out, frame_aux(key, c_pos, best_pose)

    def build(capture):
        """The step of a resolved ``graph=``."""
        if capture is False:
            step.graphs = None
            return step

        def body(dc: _DeviceCarry, x, key):
            """One frame's device work for the gates ``key``, on the
            static buffers."""
            st, pool, failed, update_idx, y = device_step(
                dc.filter, dc.pool, dc.alloc_failed, dc.update_idx, x, key,
                True)
            return _DeviceCarry(st, pool, failed, update_idx), y

        per_shape = graphs.ShapeGraphs()   # by the device carry's shape

        def bind(carry: StreamingState):
            """The ``StepGraphs`` of the carry's shape, its static carry
            holding ``carry``'s values (the pool adopted at the first call
            and copied in place after, unless it is the same pool)."""
            gen = carry.filter.generator
            dev = carry.alloc_failed.device
            capture.check(dev, "make_slam_step")
            key = graphs.signature((carry.filter, carry.pool))
            sg = per_shape.get(key)
            if sg is None:
                static_gen = (None if gen is None
                              else torch.Generator(gen.device))
                dc = _DeviceCarry(
                    dataclasses.replace(graphs.clone(carry.filter),
                                        generator=static_gen),
                    carry.pool, graphs.clone(carry.alloc_failed),
                    torch.full((), carry.update_idx, dtype=torch.int32,
                               device=dev))
                # a graph reads the hash's tables and the mounts outside
                # the carry and the inputs (the mounts copied to the card
                # first)
                constants(dev)
                sg = per_shape[key] = graphs.StepGraphs(
                    body, dc, capture, static_gen,
                    reads=lambda gate: (hash_,
                                        tuple(on_device[dev].values())),
                    what="make_slam_step")
            else:
                graphs.copy_into(sg.carry, _DeviceCarry(
                    carry.filter, carry.pool, carry.alloc_failed,
                    sg.carry.update_idx))
                sg.carry.update_idx.fill_(carry.update_idx)
            graphs.load_generator(sg.generator, gen)
            return sg

        def frame_step(sg, carry, x, q_h, pos_h, has_scan, has_dimg):
            """One graphed frame: the host gates, then the graph of their
            combination.  Returns the carry's new host fields, the static
            ``(centroid, best_pose)`` and the gates."""
            with tracing.span("frame gates"):
                key, laser_pos, cam_pos = gates(carry, q_h, pos_h, has_scan,
                                                has_dimg)
                host = host_fields(carry, key, q_h, pos_h, laser_pos,
                                   cam_pos)
                host["update_idx"] = (carry.update_idx
                                      + int(key[1] and update) + int(key[2]))
            return host, sg.step(key, x), key

        def result(sg, carry):
            """The carry after a graphed run (``carry``: the caller's, its
            host fields updated): the static filter state and
            ``alloc_failed`` copied out, the caller's generator advanced,
            the pool the static (the caller's) pool."""
            gen = carry.filter.generator
            graphs.load_generator(gen, sg.generator)
            return dataclasses.replace(
                carry, filter=dataclasses.replace(
                    graphs.clone(sg.carry.filter), generator=gen),
                pool=sg.carry.pool,
                alloc_failed=graphs.clone(sg.carry.alloc_failed))

        def graphed(carry: StreamingState, frame: SlamFrames,
                    odo_state=None, draws: StepDraws | None = None):
            with tracing.call("make_slam_step", per_shape.traced()):
                with tracing.span("frame bind"):
                    sg = bind(carry)
                host, (c_pos, best_pose), key = frame_step(
                    sg, carry, frame_inputs(frame, odo_state, draws),
                    frame.host_q, frame.host_body_pos, frame.host_has_scan,
                    frame.host_has_dimg)
                with tracing.span("frame result"):
                    return result(sg, dataclasses.replace(carry, **host)), \
                        frame_aux(key, c_pos.clone(), best_pose.clone())

        graphed.bind, graphed.frame_step = bind, frame_step
        graphed.result = result
        graphed.per_shape = graphed.graphs = per_shape
        graphed.camera = camera2body is not None
        graphed.texture = camera_texture
        return graphed

    return graphs.runner_for(graph, mesh, "make_slam_step", build,
                             lambda carry, *_: carry.alloc_failed.device)


def make_slam_scan_runner(cfg: Config, laser2body=None, hash_=None,
                          match=None, update=True, mesh=None,
                          camera2body=None, camera_intrinsics=None,
                          camera_texture=False, donate=False,
                          odometry_config=None, external_odometry=False,
                          graph=None):
    """Roll a ``SlamFrames`` stream through ``make_slam_step`` (same
    arguments): ``run(carry, frames, odos=None, draws=None) -> (carry,
    aux)``, with ``odos`` the stacked per-frame odometry states of
    ``precompute_odometry`` (``external_odometry=True``) and ``draws`` a
    sequence of one ``step.StepDraws`` per frame.  ``aux``: ``centroid
    [T, 3]`` and ``best_pose [T, 4]`` on the device, ``updated``,
    ``mapped`` and (camera path) ``cam_mapped`` ``[T]`` bool NumPy arrays.
    The carry's pool is updated in place: the JAX runner's
    ``donate=True``, always, so ``donate`` is accepted and changes
    nothing.

    ``graph=True``: the JAX package's jitted ``lax.scan``, as CUDA graphs
    (``make_slam_step``'s): every frame replays the graph of its gate
    combination, with its inputs copied from ``frames``, ``odos`` and
    ``draws`` at ``t``; each replay's ``centroid`` and ``best_pose`` are
    copied into the run's ``[T, ...]`` outputs.  The run equals the eager
    loop's bit for bit.  ``run.settled()`` says whether every gate
    combination met so far replays (a warm-up run has captured it), and
    ``run.counts()`` how many frames ran eagerly, were captured and were
    replayed; ``run.graphs`` is the ``utils.graphs.ShapeGraphs``, None for
    the eager loop.  ``graph=None`` (the default): as ``make_slam_step``'s.
    """
    del donate
    flags = ("updated", "mapped") + (
        ("cam_mapped",) if camera2body is not None else ())

    def check(odos):
        if external_odometry and odos is None:
            raise ValueError("external_odometry=True needs the stacked "
                             "odometry states (precompute_odometry)")

    return graphs.runner_for(
        graph, mesh, "make_slam_scan_runner",
        lambda capture: _slam_scan_runner(make_slam_step(
            cfg, laser2body=laser2body, hash_=hash_, match=match,
            update=update, mesh=mesh, camera2body=camera2body,
            camera_intrinsics=camera_intrinsics,
            camera_texture=camera_texture, odometry_config=odometry_config,
            external_odometry=external_odometry, graph=capture), capture,
            flags, check, external_odometry),
        lambda carry, *_: carry.alloc_failed.device)


def _slam_scan_runner(step, capture, flags, check, external_odometry):
    """``make_slam_scan_runner``'s runner for a resolved ``graph=``."""

    def run(carry: StreamingState, frames: SlamFrames, odos=None,
            draws=None):
        check(odos)
        cents, bests = [], []
        gates = {name: [] for name in flags}
        for t in range(len(frames)):
            carry, aux = step(
                carry, frames.at(t),
                tree.index(odos, t) if external_odometry else None,
                None if draws is None else draws[t])
            cents.append(aux["centroid"])
            bests.append(aux["best_pose"])
            for name in flags:
                gates[name].append(aux[name])
        return carry, {"centroid": torch.stack(cents),
                       "best_pose": torch.stack(bests),
                       **{name: np.array(v, bool)
                          for name, v in gates.items()}}

    if capture is False:
        run.graphs = None
        return run

    def graphed(carry: StreamingState, frames: SlamFrames, odos=None,
                draws=None):
        check(odos)
        with tracing.call("make_slam_scan_runner", step.per_shape.traced()):
            return run_graphed(carry, frames, odos, draws)

    def run_graphed(carry, frames, odos, draws):
        n = len(frames)
        sg = step.bind(carry)
        host_carry = carry
        cents = bests = None
        gates = {name: np.zeros(n, bool) for name in flags}
        for t in range(n):
            x = (tree.index(frames.contact, t), frames.q[t],
                 frames.ranges[t], frames.start_angle[t],
                 frames.angular_resolution[t],
                 frames.dimg[t] if step.camera else None,
                 frames.timg[t] if step.texture else None,
                 tree.index(odos, t) if external_odometry else None,
                 None if draws is None else draws[t])
            host, (c_pos, best_pose), key = step.frame_step(
                sg, host_carry, x, frames.host_q[t],
                frames.host_body_pos[t], frames.host_has_scan[t],
                frames.host_has_dimg[t] if step.camera else None)
            host_carry = dataclasses.replace(host_carry, **host)
            if cents is None:
                cents = c_pos.new_empty((n,) + tuple(c_pos.shape))
                bests = best_pose.new_empty((n,) + tuple(best_pose.shape))
            graphs.copy_into((cents[t], bests[t]), (c_pos, best_pose))
            for name, gate in zip(flags, key):
                gates[name][t] = gate
        return step.result(sg, host_carry), {
            "centroid": cents, "best_pose": bests, **gates}

    graphed.settled = step.per_shape.settled
    graphed.counts = step.per_shape.counts
    graphed.graphs = step.per_shape
    return graphed


def precompute_odometry(num_points, contact_states, orientations,
                        odo_cfg=None, cfg: Config = None):
    """Per-frame odometry states from the full (uncompacted) contact
    stream: ``odometry.update`` rolled over the trajectory.
    ``contact_states`` is a stacked ``BodyContactState`` (``[T, C, ...]``),
    ``orientations [T, 4]``.  ``odo_cfg``: the ``OdometryConfig`` (default
    the one of ``cfg``, else of ``Config()``).  Returns the stacked
    ``FootContactOdometry`` (``[T, ...]``) on the inputs' device."""
    if odo_cfg is None:
        odo_cfg = cfg_odo(cfg if cfg is not None else Config())
    odo = odom.FootContactOdometry.create(num_points,
                                          orientations.device)
    states = []
    for t in range(orientations.shape[0]):
        odo = odom.update(odo, tree.index(contact_states, t),
                          orientations[t], odo_cfg)
        states.append(odo)
    return tree.stack(states)
