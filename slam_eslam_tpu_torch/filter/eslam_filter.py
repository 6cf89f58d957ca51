"""Embodied-SLAM orchestrator: the application-level API.

Port of ``slam_eslam_tpu.filter.eslam_filter.EmbodiedSlamFilter``
(``EmbodiedSlamFilter.{hpp,cpp}``): the grid template, ``init`` in both
map modes (a shared environment grid, or per-particle maps in a
``MapPool`` seeded from a blank template or cloned from an environment
grid) with the optional global initialisation from the surface hash,
the proprioceptive update ``update_contact`` (the reference's
``update(body2odo, BodyContactState, ltc)``: odometry and propagation
on every call, and a motion-gated measurement update with terrain
labels, debug capture and hash reinjection), the exteroceptive updates
``update_scan`` and ``update_distance_image`` with ``process_map`` (scan
match and map merge over all particles), ``run_stream`` (a whole frame
stream through ``filter.streaming``, anchors carried in and out), the
read-outs and the distribution export.

The motion gate runs on the host from the host pose, as in the JAX
package; the hash period counts ``project`` calls on the host, and in
per-particle mode the map chains follow the device resampling index
(the identity when resampling did not fire), so a measurement update
never reads the device back to the host.  The mapping gates run on the
host too.  A merge's count of particles the pool had no block for (the
JAX package reads it back at once) is copied into pinned host memory
without blocking and reported on stderr, with the same message and
count, once the copy has landed: at the end of the call on the CPU, on
the card at a later call of the filter, at the latest at the next
mapping call or at ``run_stream``'s end, so one mapping call later at
most.  ``run_stream`` reads the stream's count once at its end.

``EmbodiedSlamFilter(graph=True)`` is the JAX package's jitted
application (``eslam_filter.py:196, 230, 248, 598``) as CUDA graphs
(``utils.graphs``): each call runs its host gates and then the graph of
its key, captured at the key's second meeting and replayed after, bit
for bit the eager call.  The keys: ``update_contact`` by (measurement
update, hash reinjection on this call); ``update_scan`` by (match,
update, negative information); ``update_distance_image`` by the map
mode; ``process_map`` by (match, update); each also by which inputs are
given (the draws, the terrain tables, the texture, the free-space
samples).  The inputs are copied into static buffers, the state lives in
static buffers (what a call hands out is a copy), ``update_idx`` has a
device mirror, the chains follow the particles in place, and the shared
map's camera merge writes the grid and the lookup's tables into their
storage, which every graph reads.  One ``utils.graphs.Capture`` (one
memory pool) serves every graph of the filter and of its ``run_stream``.
``graph=None``, the default (the JAX package's filter is jitted), is
graphs on a CUDA device and the eager calls on the CPU; ``graphed`` says
which.  A ``run_stream`` over a gloo or host mesh runs eagerly.
"""

from __future__ import annotations

import collections
import dataclasses
import sys

import numpy as np
import torch

from slam_eslam_tpu_torch.config import Config, OdometryConfig, SurfaceHashConfig
from slam_eslam_tpu_torch.core import filter as pf
from slam_eslam_tpu_torch.core.distribution import export_distribution
from slam_eslam_tpu_torch.core.state import BodyContactState
from slam_eslam_tpu_torch.filter import pose_estimator as pe
from slam_eslam_tpu_torch.filter import streaming
from slam_eslam_tpu_torch.filter.surface_hash import SurfaceHash
from slam_eslam_tpu_torch.mapping import map_pool as mp
from slam_eslam_tpu_torch.mapping import mls_grid, projection
from slam_eslam_tpu_torch.mapping.lookup import make_lookup
from slam_eslam_tpu_torch.models import odometry as odom
from slam_eslam_tpu_torch.models import terrain as terr
from slam_eslam_tpu_torch.models.asguard import NUM_WHEELS
from slam_eslam_tpu_torch.utils import geometry, graphs, tree
from slam_eslam_tpu_torch.utils.device import entry_device, to_device_async


def _affine(q, t):
    """4x4 pose of quaternion ``q`` and translation ``t``; the rotation
    is computed in float32, as the JAX package's
    ``geometry.quat_to_matrix``."""
    w, x, y, z = np.asarray(q, np.float32)
    m = np.eye(4)
    m[:3, :3] = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)
    m[:3, 3] = np.asarray(t)
    return m


def _mounted(q, t, sensor2body):
    """4x4 pose of a sensor mounted by ``sensor2body = (rot [3, 3], trans
    [3])`` on the body pose ``(q, t)``."""
    mount = np.eye(4)
    mount[:3, :3] = np.asarray(sensor2body[0])
    mount[:3, 3] = np.asarray(sensor2body[1])
    return _affine(q, t) @ mount


def _quat_from_matrix(r):
    """``[3, 3]`` rotation matrix -> unit quaternion ``[w, x, y, z]`` with
    ``w >= 0``, float32 on the host (``geometry.quat_from_matrix``)."""
    return geometry.quat_from_matrix(
        torch.from_numpy(np.asarray(r, np.float32))).numpy()


def _motion(delta):
    dist = float(np.linalg.norm(delta[:3, 3]))
    angle = float(
        np.arccos(np.clip((np.trace(delta[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)))
    return dist, angle


def _check_refill(cfg: Config, pool, device):
    """Raise unless ``pool`` has the shape, storage dtype and device of
    the pool ``cfg`` makes (what ``init(pool=)`` may refill)."""
    dtype = cfg.map_pool_dtype or torch.float32
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    want = (cfg.particle_count, cfg.map_pool_blocks, cfg.map_chain_length,
            cfg.map_pool_color, dtype, torch.device(device))
    have = (pool.n, pool.bl, pool.chain_len, pool.color is not None,
            pool.mean.dtype, pool.mean.device)
    if pool.mesh is not None or have != want:
        raise ValueError(
            f"init(pool=) refills a pool of (particles, blocks, chain "
            f"length, colour, dtype, device) {want}, not {have}"
            + (" on a mesh" if pool.mesh is not None else ""))


def _far_pose():
    """The motion gates' "far away" initial anchor (``:128``)."""
    far = np.eye(4)
    far[0, 3] = 1000.0
    return far


@dataclasses.dataclass
class ContactDraws:
    """The random draws of one ``update_contact`` call; each one not
    given is drawn from the state's generator."""

    project: pe.ProjectDraws | None = None
    resample_u: torch.Tensor | None = None  # [N] stratum uniforms
    hash_u: torch.Tensor | None = None      # [N] in-bucket reinjection draws


@dataclasses.dataclass
class _AppCarry:
    """The filter's device state as one call's work takes and returns
    it: the estimator's state, the map pool (per-particle mode) and
    ``update_idx``, the host int in an eager call and a [] int32 device
    mirror (what the merge kernel reads) in a graph."""

    state: pe.PoseEstimatorState
    pool: mp.MapPool | None
    update_idx: int | torch.Tensor


class _FailureReports:
    """The counts of particles the pool had no block for, one per merge
    call, read without blocking the host: each is copied into pinned
    memory behind an event (on the CPU it is there at once) and reported
    once the event has completed."""

    def __init__(self):
        self.pending = collections.deque()

    def push(self, count):
        if count.device.type == "cuda":
            host = torch.empty((), dtype=count.dtype, pin_memory=True)
            host.copy_(count, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            host, done = count.clone(), None
        self.pending.append((host, done))

    def report(self, wait=False):
        """Report every count whose copy has landed, in order; ``wait``:
        every count, waiting for the copies."""
        while self.pending:
            host, done = self.pending[0]
            if done is not None and not done.query():
                if not wait:
                    return
                done.synchronize()
            self.pending.popleft()
            nf = int(host)
            if nf:
                print(f"slam_eslam_tpu_torch: map pool exhausted for {nf} "
                      "particles", file=sys.stderr)


class EmbodiedSlamFilter:
    """``device`` holds every tensor: the CUDA device unless given
    (``device="cpu"`` for the CPU; no CUDA device and no ``device``
    raises).  Construction mirrors the reference constructor
    (``EmbodiedSlamFilter.cpp:13-23``).  ``graph=True`` captures every
    call into CUDA graphs (module docstring; CUDA only); ``graph=None``
    (the default) does so on a CUDA device and runs the eager calls on
    the CPU; ``graph=False`` runs them eagerly; ``graph`` may also be a
    stand-in for ``utils.graphs.Capture``."""

    def __init__(self, odometry_config: OdometryConfig = None,
                 config: Config = None, device=None, graph=None):
        self.config = config or Config()
        self.odometry_config = odometry_config or OdometryConfig()
        self.device = entry_device(device)
        self.state: pe.PoseEstimatorState | None = None
        self.shared_grid: mls_grid.MLSGrid | None = None
        self.pool: mp.MapPool | None = None
        self.use_shared_map = True
        self.hash: SurfaceHash | None = None
        self._reset_gates()
        self.last_eval = None   # ContactEvalResult of the last measurement
        self._lookup = None
        self._runners = {}
        self._capture = graphs.resolve(graph, self.device,
                                       what="EmbodiedSlamFilter")
        self.graphed = self._capture is not None
        self._stream_capture = None
        self._reports = _FailureReports()
        self._reset_graphs()

    def _reset_graphs(self):
        # the static buffers and graphs by the shape of (state, pool), and
        # the state the last graphed call handed out
        self.graphs = graphs.ShapeGraphs()
        self._handed = None

    def _reset_gates(self):
        # the motion gates' anchors (udPose / mapPose / stereoPose)
        self.ud_pose = _far_pose()
        self.map_pose = _far_pose()
        self.stereo_pose = _far_pose()
        self.update_idx = 0
        self.steps = 0          # project calls since init (the hash period)

    def make_grid_template(self, origin_xy=(0.0, 0.0), center=None):
        """An empty grid of ``grid_size`` at ``grid_resolution``
        (``createGridTemplate``, ``EmbodiedSlamFilter.cpp:25-39``),
        placed at ``origin_xy`` or centred on ``center``."""
        cfg = self.config
        n = int(round(cfg.grid_size / cfg.grid_resolution))
        if center is not None:
            origin_xy = (center[0] - cfg.grid_size / 2.0,
                         center[1] - cfg.grid_size / 2.0)
        return mls_grid.MLSGrid.create(n, n, cfg.grid_resolution, origin_xy,
                                       cfg.mls_patches_per_cell,
                                       device=self.device)

    def init(self, pose, shared_grid: mls_grid.MLSGrid = None,
             use_shared_map=True, hash_config: SurfaceHashConfig = None,
             num_contact_points=20, normal_xy=None, normal_yaw=None,
             hash_u=None, pool=None):
        """``pose = (position [3], yaw)`` (``EmbodiedSlamFilter.cpp:
        70-177``).  Shared-map mode needs ``shared_grid``.  Per-particle
        mode seeds every particle's map with a copy of ``shared_grid``
        when given (clone-from-env, ``PoseEstimator.cpp:47-62``), else
        with a blank template centred on the start pose.

        Particles start Gaussian around ``pose``; ``normal_xy [N, 2]`` and
        ``normal_yaw [N]`` are their standard normals.  With
        ``hash_config.use_hash`` the surface hash is built from
        ``shared_grid`` in either map mode (``:93-98``) and the particles
        are drawn from its candidates over the whole map instead;
        ``hash_u [N]`` are those integer draws (``SurfaceHash.
        sample_particles``).  Draws not given come from the state's
        generator (seeded with ``config.seed``).

        ``pool``: in per-particle mode, a ``MapPool`` of this
        configuration's shape to refill in place (``MapPool.refill_``)
        instead of allocating a new one: the pool a graphed runner's
        graphs were captured on, which a fresh start is written into."""
        cfg = self.config
        position, yaw = np.asarray(pose[0], np.float64), float(pose[1])
        if shared_grid is not None:
            shared_grid = tree.to(shared_grid, self.device)
        self.use_shared_map = use_shared_map
        self._reset_graphs()
        if use_shared_map:
            if pool is not None:
                raise ValueError("init(pool=) refills a per-particle pool: "
                                 "shared-map mode has none")
            if shared_grid is None:
                raise ValueError("shared-map mode requires an MLS grid "
                                 "(EmbodiedSlamFilter.cpp:104)")
            # graphs merge camera images into the grid in place: into the
            # filter's own copy, never into the caller's
            self.shared_grid = (shared_grid if self._capture is None
                                else graphs.clone(shared_grid))
            self.pool = None
            self._lookup = make_lookup(cfg, self.shared_grid)
        else:
            template = (shared_grid if shared_grid is not None
                        else self.make_grid_template(center=position[:2]))
            if pool is None:
                self.pool = mp.MapPool.from_template(
                    template, cfg.particle_count, cfg.map_pool_blocks,
                    cfg.map_chain_length, with_color=cfg.map_pool_color,
                    shards=cfg.map_pool_shards, dtype=cfg.map_pool_dtype,
                    device=self.device)
            else:
                _check_refill(cfg, pool, self.device)
                self.pool = pool.refill_(template, cfg.map_pool_shards)
            self.shared_grid, self._lookup = None, None

        state = pe.PoseEstimatorState.create(
            cfg, num_contact_points, device=self.device)
        if hash_config is not None and hash_config.use_hash:
            if shared_grid is None:
                raise ValueError(
                    "the surface hash precomputes over a prebuilt "
                    "environment grid: pass shared_grid "
                    "(EmbodiedSlamFilter.cpp:93-98)")
            self.hash = SurfaceHash.create(hash_config, shared_grid)
            particles = self.hash.sample_particles(
                cfg.particle_count, hash_u, state.generator)
        else:
            self.hash = None
            particles = pe.init_gaussian(
                cfg.particle_count, position[:2], yaw,
                (cfg.initial_translation_error[0],
                 cfg.initial_translation_error[1]),
                cfg.initial_rotation_error[2], position[2],
                cfg.initial_translation_error[2] + 1e-3,
                normal_xy=normal_xy, normal_yaw=normal_yaw,
                generator=state.generator, device=self.device)
        if not use_shared_map:
            particles = dataclasses.replace(particles, map_id=torch.arange(
                cfg.particle_count, dtype=torch.int32, device=self.device))
        self.state = dataclasses.replace(state, particles=particles)
        self._reset_gates()
        self.last_eval = None
        return self

    # ------------------------------------------------------------------
    # proprioceptive update (EmbodiedSlamFilter.cpp:353-369)
    # ------------------------------------------------------------------

    def _to_device(self, a, dtype=torch.float32):
        """Host values on the filter's device, without a blocking copy."""
        return to_device_async(a, self.device, dtype)

    def _terrain_tables(self, ltc):
        """Terrain labels -> the slip update's wheel tables ``(probs [W,
        K], valid [W])`` on the device (``ContactModel.cpp:226-260``):
        ``[(wheel_idx, class_probs), ...]`` or a prebuilt ``(wheel_probs,
        wheel_valid)`` pair; wheels without a label carry no
        information."""
        wheel_probs = np.full((NUM_WHEELS, terr.NUM_CLASSES),
                              1.0 / terr.NUM_CLASSES, np.float32)
        wheel_valid = np.zeros((NUM_WHEELS,), bool)
        if ltc is not None:
            if isinstance(ltc, tuple) and len(ltc) == 2:
                wheel_probs = np.asarray(ltc[0], np.float32)
                wheel_valid = np.asarray(ltc[1], bool)
            else:
                for wheel_idx, probs in ltc:
                    wheel_probs[int(wheel_idx)] = np.asarray(probs,
                                                             np.float32)
                    wheel_valid[int(wheel_idx)] = True
        return (self._to_device(wheel_probs),
                self._to_device(wheel_valid, torch.bool))

    def _sensor(self, reading):
        """A scan or distance image on the filter's device; under graphs
        its scalars as device tensors too, since a graph keeps a number
        it was captured with."""
        reading = tree.to(reading, self.device)
        if self._capture is None:
            return reading
        return dataclasses.replace(reading, **{
            f.name: self._to_device(getattr(reading, f.name))
            for f in dataclasses.fields(reading)
            if not torch.is_tensor(getattr(reading, f.name))})

    # ---- one call's device work: eager, or the graph of its key ----

    def _run(self, key, x, merges):
        """The device work of ``key`` on the inputs ``x``: eagerly, or by
        the graph of ``key`` (``merges``: the merges it stamps, by which
        the host's ``update_idx`` advances).  Returns its output."""
        if self._capture is None:
            carry, y = self._work(_AppCarry(self.state, self.pool,
                                            self.update_idx), x, key, False)
            self.state, self.pool = carry.state, carry.pool
            self.update_idx = carry.update_idx
            return y
        sg = self._bind()
        y = sg.step(key, x)
        gen = self.state.generator
        graphs.load_generator(gen, sg.generator)
        self.state = self._handed = dataclasses.replace(
            graphs.clone(sg.carry.state), generator=gen)
        self.pool = sg.carry.pool
        self.update_idx += merges
        sg.host_update_idx = self.update_idx
        return graphs.clone(y)

    def _bind(self):
        """The ``StepGraphs`` of the state's and pool's shape, its static
        carry holding the filter's values: the state copied in unless it
        is the one the last call handed out, the pool adopted at the
        first call (copied in after, field by field, where it is another
        tensor), the device mirror of ``update_idx`` refilled where the
        host's moved (``run_stream``)."""
        sig = graphs.signature((self.state, self.pool))
        sg = self.graphs.get(sig)
        if sg is None:
            gen = self.state.generator
            static_gen = None if gen is None else torch.Generator(gen.device)
            carry = _AppCarry(
                dataclasses.replace(graphs.clone(self.state),
                                    generator=static_gen),
                self.pool, torch.full((), self.update_idx, dtype=torch.int32,
                                      device=self.device))
            sg = self.graphs[sig] = graphs.StepGraphs(
                lambda c, x, key: self._work(c, x, key, True), carry,
                self._capture, static_gen, reads=self._reads,
                writes=self._writes, what="EmbodiedSlamFilter")
            sg.host_update_idx = self.update_idx
        else:
            if self.state is not self._handed:
                graphs.copy_into(sg.carry.state, self.state)
            if self.pool is not None:
                graphs.copy_into(sg.carry.pool, self.pool)
            if sg.host_update_idx != self.update_idx:
                sg.carry.update_idx.fill_(self.update_idx)
                sg.host_update_idx = self.update_idx
        graphs.load_generator(sg.generator, self.state.generator)
        return sg

    def _reads(self, key):
        """What every graph reads outside its carry and inputs: the
        shared grid and its lookup's packed tables, the hash's tables."""
        del key
        return (self.shared_grid, getattr(self._lookup, "packed", None),
                self.hash)

    def _writes(self, key):
        """What the graph of ``key`` writes in place outside its carry:
        the shared grid and the packed tables, by a camera merge."""
        if key[0] != "image" or self.pool is not None:
            return None
        return self.shared_grid, getattr(self._lookup, "packed", None)

    def _work(self, carry, x, key, in_place):
        """One call's device work for ``key``: ``(carry, output)``;
        ``in_place`` (a graph) writes the chains and the shared grid into
        their storage."""
        kind = key[0]
        if kind == "contact":
            return self._contact_work(carry, x, key, in_place)
        if kind == "scan":
            _, match, update, negative = key
            q, l_rot, l_trans, scan = x
            cloud, free = streaming.laser_cloud(self.config, scan, q, l_rot,
                                                l_trans, negative)
            return self._map_work(carry, cloud, free, match, update)
        if kind == "image":
            q, dimage, texture, c_rot, c_trans = x
            cloud = streaming.camera_cloud(self.config, dimage, q, c_rot,
                                           c_trans, texture)
            if carry.pool is None:
                return self._shared_merge(carry, cloud, in_place), None
            return self._map_work(carry, cloud, None, False, True)
        _, match, update = key
        return self._map_work(carry, *x, match, update)

    def _contact_work(self, carry, x, key, in_place):
        """``update_contact``'s device work: odometry and propagation,
        and with ``key = ("contact", do_update, do_hash)`` the
        measurement update (the chains following the particles) and the
        hash reinjection.  The output is the ``ContactEvalResult``."""
        _, do_update, do_hash = key
        contact, q, tables, draws = x
        cfg = self.config
        st = carry.state
        st = dataclasses.replace(st, odometry=odom.update(
            st.odometry, contact, q, self.odometry_config))
        st = pe.project(st, q, cfg, draws.project,
                        use_hash=self.hash is not None)
        if not do_update:
            return dataclasses.replace(carry, state=st), None
        terrain_prob = None if tables is None else (
            lambda gid, color: terr.per_point_probability(
                gid, color, *tables, with_mask=True))
        pool = carry.pool
        if pool is None:
            st, aux = pe.update(st, contact, q, self._lookup, cfg,
                                draws.resample_u, terrain_prob)
        else:
            # chains follow the particles along the resampling index,
            # the identity when resampling did not fire (replaces
            # cloneMaps-on-resample, PoseEstimator.cpp:249-253)
            st, pool, aux = streaming.measure(
                cfg, st, pool, contact, q, draws.resample_u, in_place,
                terrain_prob=terrain_prob)
        if do_hash:
            st = self.hash.reinject(st, contact, q, cfg, draws.hash_u)
        return _AppCarry(st, pool, carry.update_idx), aux["eval"]

    def _map_work(self, carry, cloud, free, match, update):
        """``process_map``'s device work (``EmbodiedSlamFilter.cpp:
        179-232``; the pool is updated in place either way); the output is
        the count of particles the pool had no block for, None without a
        merge."""
        cfg = self.config
        st, pool = carry.state, carry.pool
        p = st.particles
        if pool is None:
            if match:
                st = streaming.weigh_by_match(st, mls_grid.match_cloud(
                    self.shared_grid, cloud, geometry.rot2d(p.yaw), p.xy,
                    p.z, p.z_sigma, sampling=10, sigma=0.2,
                    z_window=cfg.mls_z_window))
            return dataclasses.replace(carry, state=st), None
        st, pool, failed, update_idx = streaming.map_cloud(
            cfg, st, pool, p, cloud, carry.update_idx, free=free,
            match=match, update=update)
        return _AppCarry(st, pool, update_idx), failed

    def _shared_merge(self, carry, cloud, in_place):
        """The camera merge into the shared grid under the centroid pose;
        ``in_place``: the merged grid and the lookup's packed tables are
        written into their storage, which the graphs of ``update_contact``
        read (``_reads``)."""
        cfg = self.config
        st = carry.state
        pos, quat = pe.centroid(st.particles, st.odometry.prev_orientation,
                                wrap_safe=cfg.wrap_safe_centroid)
        merged = mls_grid.merge_cloud(
            self.shared_grid, cloud,
            geometry.rot2d(geometry.yaw_from_quat(quat)), pos[:2], pos[2],
            0.0, carry.update_idx, patch_thickness=cfg.grid_patch_thickness,
            gap_size=cfg.grid_gap_size)
        if in_place:
            graphs.copy_into(self.shared_grid, merged)
            packed = getattr(self._lookup, "packed", None)
            if packed is not None:
                packed.data.copy_(
                    mls_grid.PackedLookup.from_grid(self.shared_grid).data)
        else:
            self.shared_grid = merged
            self._lookup = make_lookup(cfg, merged)
        return dataclasses.replace(carry, update_idx=carry.update_idx + 1)

    def _merged(self, failed):
        """After a merge call: queue its failure count, report what has
        landed."""
        if failed is not None:
            self._reports.push(failed)
        self._reports.report()

    def update_contact(self, body2odometry, contact_state: BodyContactState,
                       terrain_classifications=None, draws=None,
                       orientation=None):
        """``body2odometry = (orientation quaternion [4], position [3])``
        in the odometry frame, host values (the motion gate reads them).
        Always advances odometry and propagation; runs the measurement
        update when the motion gate fires or terrain labels are present.
        Returns True when the measurement update ran.

        ``orientation``: the same quaternion already on the filter's
        device, which spares a copy; ``draws``: a ``ContactDraws``;
        ``contact_state`` should lie on the filter's device."""
        self._reports.report()
        cfg = self.config
        shared = self.use_shared_map
        if (not shared and cfg.contact_model.use_slip_update
                and self.pool.color is None):
            raise ValueError(
                "the slip update in per-particle mode reads the terrain "
                "class off the patch colours: it needs a colour-carrying "
                "pool (map_pool_color=True)")
        draws = draws or ContactDraws()
        q_np, t_np = body2odometry
        q = orientation if orientation is not None else self._to_device(q_np)
        contact_state = tree.to(contact_state, self.device)
        self.steps += 1

        pose = _affine(q_np, t_np)
        dist, angle = _motion(np.linalg.inv(self.ud_pose) @ pose)
        ltc = terrain_classifications
        # non-empty terrain labels force the update
        # (ltc.size() > 0, EmbodiedSlamFilter.cpp:360)
        if ltc is None:
            has_ltc = False
        elif hasattr(ltc, "__len__"):
            has_ltc = len(ltc) > 0
        else:
            has_ltc = True
        do_update = bool(dist > cfg.measurement_threshold.distance
                         or angle > cfg.measurement_threshold.angle
                         or has_ltc)
        do_hash = do_update and self.hash is not None and (
            self.steps % max(1, self.hash.config.period) == 0)
        # labels given or not change the tables' values only
        tables = (self._terrain_tables(ltc if has_ltc else None)
                  if do_update and cfg.contact_model.use_slip_update
                  else None)
        ev = self._run(("contact", do_update, do_hash),
                       (contact_state, q, tables, draws), 0)
        if not do_update:
            return False
        self.last_eval = ev
        self.ud_pose = pose
        return True

    # ------------------------------------------------------------------
    # exteroceptive updates (EmbodiedSlamFilter.cpp:179-351)
    # ------------------------------------------------------------------

    def update_scan(self, body2odometry, scan: projection.LaserScan,
                    laser2body, orientation=None):
        """Laser mapping update (``EmbodiedSlamFilter.cpp:311-351``).
        ``laser2body = (rot [3, 3], trans [3])``, host values.  In
        per-particle mode the scan merges into every particle's map (after
        the laser's negative information, ``:160``); with
        ``use_visual_update`` the particles are also weighted by the scan
        match, in either map mode.  ``orientation``: the quaternion
        already on the filter's device.  Returns True when the mapping
        gate fired."""
        self._reports.report(wait=True)
        cfg = self.config
        q_np, t_np = body2odometry
        pose = _mounted(q_np, t_np, laser2body)
        dist, angle = _motion(np.linalg.inv(self.map_pose) @ pose)
        if not (dist > cfg.mapping_threshold.distance
                or angle > cfg.mapping_threshold.angle):
            return False

        q = orientation if orientation is not None else self._to_device(q_np)
        update = not self.use_shared_map
        self._merged(self._run(
            ("scan", cfg.use_visual_update, update,
             update and cfg.grid_use_negative_information),
            (q, self._to_device(laser2body[0]),
             self._to_device(laser2body[1]), self._sensor(scan)),
            int(update)))
        self.map_pose = pose
        return True

    def update_distance_image(self, body2odometry,
                              dimage: projection.DistanceImage, camera2body,
                              texture=None, orientation=None):
        """Camera mapping update (``EmbodiedSlamFilter.cpp:239-309``): the
        distance image, with ``texture [H, W, 3]`` as patch colour when
        given, is always merged and never matched (``:301``), and carries
        no negative information (``:172-176``).  In shared-map mode it
        merges into the shared grid under the centroid pose, and the next
        ``update_contact`` looks the new patches up.  Returns True when
        the camera gate fired."""
        self._reports.report(wait=True)
        cfg = self.config
        q_np, t_np = body2odometry
        pose = _mounted(q_np, t_np, camera2body)
        dist, angle = _motion(np.linalg.inv(self.stereo_pose) @ pose)
        if not (dist > cfg.mapping_camera_threshold.distance
                or angle > cfg.mapping_camera_threshold.angle):
            return False

        q = orientation if orientation is not None else self._to_device(q_np)
        if texture is not None:
            texture = (texture.to(self.device, torch.float32)
                       if torch.is_tensor(texture)
                       else self._to_device(texture))
        self._merged(self._run(
            ("image",),
            (q, self._sensor(dimage), texture,
             self._to_device(camera2body[0]),
             self._to_device(camera2body[1])), 1))
        self.stereo_pose = pose
        return True

    def process_map(self, cloud: mls_grid.PatchCloud, match, update,
                    free=None):
        """Per-particle scan match and map merge (``EmbodiedSlamFilter::
        processMap``, ``EmbodiedSlamFilter.cpp:179-232``).  ``match``
        weights every particle by ``match^0.1`` of the cloud against its
        own map (kernel K2), or against the shared grid in shared-map
        mode; ``update`` (per-particle mode only) gives every particle its
        own head block, rolls grids over, applies the free-space samples
        ``free = (points [F, 3], mask [F])`` and merges the cloud (kernel
        K3).  The count of particles the pool had no block for is
        reported on stderr when it is not 0, once its copy to the host has
        landed (module docstring): at most one mapping call later."""
        self._reports.report(wait=True)
        if free is not None:
            free = tuple(v.to(self.device) for v in free)
        self._merged(self._run(
            ("map", match, update), (tree.to(cloud, self.device), free),
            int(update and self.pool is not None)))

    def run_stream(self, frames: streaming.SlamFrames, laser2body=None,
                   mesh=None, camera2body=None, camera_intrinsics=None,
                   camera_texture=False, draws=None, donate=False,
                   graph=None):
        """A whole frame stream (``streaming.stack_frames``, on the
        filter's device) through ``filter.streaming``: every update this
        class would run frame by frame, gates included.  Per-particle
        mode only.  Consumes and updates this filter's state, the gate
        anchors, ``update_idx`` and the step count.  ``draws``: one
        ``step.StepDraws`` per frame.  Returns the per-frame ``aux``
        (centroids, gate flags) plus ``alloc_failed_total``, the count of
        pool exhaustion over the stream (also reported on stderr when it
        is not 0).  ``mesh``: this filter holds the rank's particles and
        pool (``parallel.sharding.shard_state`` / ``shard_pool``; see
        ``filter.streaming``); every rank calls with the same frames.
        ``donate``: the pool is always updated in place, so the JAX
        flag is accepted and changes nothing.  ``graph``: the runner's
        CUDA graphs (``streaming.make_slam_scan_runner(graph=...)``, one
        per gate combination; the filter's own ``Capture`` where it has
        one); None: as the filter was built, and eagerly over a gloo or
        host mesh (``utils.graphs.supported``)."""
        del donate
        self._reports.report(wait=True)
        if self.use_shared_map:
            raise ValueError(
                "run_stream requires per-particle-map mode "
                "(use_shared_map=False); shared-map tracking streams via "
                "filter.step.make_scan_runner")
        capture = self._stream_graphs(graph, mesh)
        extr = lambda e: (None if e is None else
                          np.asarray(e[0], np.float32).tobytes()
                          + np.asarray(e[1], np.float32).tobytes())
        key = (extr(laser2body), extr(camera2body), camera_intrinsics,
               camera_texture, self.odometry_config, id(mesh), capture)
        if key not in self._runners:
            self._runners[key] = streaming.make_slam_scan_runner(
                self.config, laser2body=laser2body, hash_=self.hash,
                mesh=mesh, camera2body=camera2body,
                camera_intrinsics=camera_intrinsics,
                camera_texture=camera_texture,
                odometry_config=self.odometry_config,
                graph=False if capture is None else capture)
        anchor = lambda pose: (pose[:3, 3].astype(np.float32),
                               _quat_from_matrix(pose[:3, :3]))
        (ud_pos, ud_q), (map_pos, map_q), (cam_pos, cam_q) = (
            anchor(self.ud_pose), anchor(self.map_pose),
            anchor(self.stereo_pose))
        carry = dataclasses.replace(
            streaming.StreamingState.create(self.state, self.pool,
                                            steps=self.steps),
            ud_pos=ud_pos, ud_q=ud_q, map_pos=map_pos, map_q=map_q,
            cam_pos=cam_pos, cam_q=cam_q, update_idx=self.update_idx)
        carry, aux = self._runners[key](carry, frames, draws=draws)
        self.state, self.pool = carry.filter, carry.pool
        self.update_idx, self.steps = carry.update_idx, carry.steps
        self.ud_pose = _affine(carry.ud_q, carry.ud_pos)
        self.map_pose = _affine(carry.map_q, carry.map_pos)
        self.stereo_pose = _affine(carry.cam_q, carry.cam_pos)
        aux["alloc_failed_total"] = carry.alloc_failed
        nf = int(carry.alloc_failed)
        if nf:
            print(f"slam_eslam_tpu_torch: map pool exhausted {nf} times "
                  "during the stream (merges degraded; raise "
                  "map_pool_blocks)", file=sys.stderr)
        return aux

    def _stream_graphs(self, graph, mesh):
        """The capture of ``run_stream(graph=..., mesh=...)``
        (``utils.graphs.resolve``; None: eager), ``graph=None`` as the
        filter was built; a ``Capture`` is the filter's own where it has
        one (one memory pool for every graph), else one kept for the
        streams."""
        if graph is None and self._capture is None:
            return None
        capture = graphs.resolve(graph, self.device, mesh, "run_stream")
        if not isinstance(capture, graphs.Capture):
            return capture
        if self._capture is not None:
            return self._capture
        if self._stream_capture is None:
            self._stream_capture = graphs.Capture()
        return self._stream_capture

    def update_featurecloud(self, *_args, **_kw):
        """Stereo feature clouds are unsupported, as in the reference
        (stub returning false, ``EmbodiedSlamFilter.cpp:234-237``)."""
        return False

    # ------------------------------------------------------------------
    # outputs (EmbodiedSlamFilter.cpp:371-384)
    # ------------------------------------------------------------------

    def get_particles(self):
        return self.state.particles

    def get_best_particle_index(self):
        return int(pf.best_particle_index(self.state.particles.weight))

    def get_centroid(self):
        """``(position [3], orientation quaternion [4])``."""
        return pe.centroid(self.state.particles,
                           self.state.odometry.prev_orientation,
                           wrap_safe=self.config.wrap_safe_centroid)

    def get_distribution(self, body_state=None, n_components=3, first=None):
        """The observable ``PoseDistribution`` (particles, 2-D GMM,
        orientation, contact state; ``PoseParticle.hpp:88-114``), with
        the last measurement's debug contact points when ``log_debug``
        captured them.  ``first``: the GMM's first initial mean
        (``core.gmm.fit_gmm``), else drawn from the state's generator."""
        if body_state is None:
            body_state = BodyContactState.create(np.zeros((1, 3)),
                                                 device=self.device)
        debug = self.last_eval if self.config.log_debug else None
        return export_distribution(
            self.state.particles, self.state.odometry.prev_orientation,
            body_state, n_components=n_components, eval_result=debug,
            first=first, generator=self.state.generator)

    def maybe_log_distribution(self, body_state=None):
        """Period-gated export (``logParticlePeriod``, ``Configuration.hpp:
        207-212``): a ``PoseDistribution`` every ``log_particle_period``-th
        step, else None; period 0 disables."""
        period = self.config.log_particle_period
        if not period or self.steps % period:
            return None
        return self.get_distribution(body_state)
