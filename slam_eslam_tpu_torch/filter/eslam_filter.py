"""Embodied-SLAM orchestrator: the application-level API.

Port of ``slam_eslam_tpu.filter.eslam_filter.EmbodiedSlamFilter``
(``EmbodiedSlamFilter.{hpp,cpp}``): the grid template, ``init`` in both
map modes (a shared environment grid, or per-particle maps in a
``MapPool`` seeded from a blank template or cloned from an environment
grid) with the optional global initialisation from the surface hash,
the proprioceptive update ``update_contact`` (the reference's
``update(body2odo, BodyContactState, ltc)``: odometry and propagation
on every call, and a motion-gated measurement update with terrain
labels, debug capture and hash reinjection), the read-outs and the
distribution export.  The streaming SLAM loop is ``filter.streaming``.

The motion gate runs on the host from the host pose, as in the JAX
package; the hash period counts ``project`` calls on the host, and in
per-particle mode the map chains follow the device resampling index
(the identity when resampling did not fire), so a measurement update
never reads the device back to the host.

The exteroceptive updates (``update_scan``, ``update_distance_image``,
``process_map``) and ``run_stream`` are not ported yet and raise
``NotImplementedError`` (``ROADMAP.md`` queue 1).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from slam_eslam_tpu.config import Config, OdometryConfig, SurfaceHashConfig
from slam_eslam_tpu_torch.core import filter as pf
from slam_eslam_tpu_torch.core.distribution import export_distribution
from slam_eslam_tpu_torch.core.state import BodyContactState
from slam_eslam_tpu_torch.filter import pose_estimator as pe
from slam_eslam_tpu_torch.filter.surface_hash import SurfaceHash
from slam_eslam_tpu_torch.mapping import map_pool as mp
from slam_eslam_tpu_torch.mapping import mls_grid
from slam_eslam_tpu_torch.mapping.lookup import make_lookup
from slam_eslam_tpu_torch.models import odometry as odom
from slam_eslam_tpu_torch.models import terrain as terr
from slam_eslam_tpu_torch.models.asguard import NUM_WHEELS
from slam_eslam_tpu_torch.utils import tree


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


def _motion(delta):
    dist = float(np.linalg.norm(delta[:3, 3]))
    angle = float(
        np.arccos(np.clip((np.trace(delta[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)))
    return dist, angle


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


class EmbodiedSlamFilter:
    """``device`` holds every tensor.  Construction mirrors the reference
    constructor (``EmbodiedSlamFilter.cpp:13-23``)."""

    def __init__(self, odometry_config: OdometryConfig = None,
                 config: Config = None, device=None):
        self.config = config or Config()
        self.odometry_config = odometry_config or OdometryConfig()
        self.device = torch.device(device or "cpu")
        self.state: pe.PoseEstimatorState | None = None
        self.shared_grid: mls_grid.MLSGrid | None = None
        self.pool: mp.MapPool | None = None
        self.use_shared_map = True
        self.hash: SurfaceHash | None = None
        self.ud_pose = _far_pose()
        self.steps = 0          # project calls since init (the hash period)
        self.last_eval = None   # ContactEvalResult of the last measurement
        self._lookup = None

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
             hash_u=None):
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
        generator (seeded with ``config.seed``)."""
        cfg = self.config
        position, yaw = np.asarray(pose[0], np.float64), float(pose[1])
        if shared_grid is not None:
            shared_grid = tree.to(shared_grid, self.device)
        self.use_shared_map = use_shared_map
        if use_shared_map:
            if shared_grid is None:
                raise ValueError("shared-map mode requires an MLS grid "
                                 "(EmbodiedSlamFilter.cpp:104)")
            self.shared_grid, self.pool = shared_grid, None
            self._lookup = make_lookup(cfg, shared_grid)
        else:
            template = (shared_grid if shared_grid is not None
                        else self.make_grid_template(center=position[:2]))
            self.pool = mp.MapPool.from_template(
                template, cfg.particle_count, cfg.map_pool_blocks,
                cfg.map_chain_length, with_color=cfg.map_pool_color,
                shards=cfg.map_pool_shards, dtype=cfg.map_pool_dtype,
                device=self.device)
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
        self.ud_pose = _far_pose()
        self.steps = 0
        self.last_eval = None
        return self

    # ------------------------------------------------------------------
    # proprioceptive update (EmbodiedSlamFilter.cpp:353-369)
    # ------------------------------------------------------------------

    def _to_device(self, a, dtype=torch.float32):
        """Host values on the filter's device; to a GPU asynchronously
        from pinned memory, so the host does not wait."""
        t = torch.tensor(np.asarray(a), dtype=dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _terrain_prob(self, ltc):
        """Terrain labels -> the slip update's per-point probability
        (``ContactModel.cpp:226-260``): ``[(wheel_idx, class_probs),
        ...]`` or a prebuilt ``(wheel_probs [W, K], wheel_valid [W])``
        pair; wheels without a label carry no information."""
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
        probs = self._to_device(wheel_probs)
        valid = self._to_device(wheel_valid, torch.bool)
        return lambda gid, color: terr.per_point_probability(
            gid, color, probs, valid, with_mask=True)

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
        cfg = self.config
        shared = self.use_shared_map
        if not shared and cfg.contact_model.use_slip_update:
            raise NotImplementedError(
                "the slip update in per-particle mode needs the colour chain "
                "lookup, which is not ported yet (ROADMAP.md queue 1)")
        draws = draws or ContactDraws()
        q_np, t_np = body2odometry
        q = orientation if orientation is not None else self._to_device(q_np)
        contact_state = tree.to(contact_state, self.device)

        st = self.state
        st = dataclasses.replace(st, odometry=odom.update(
            st.odometry, contact_state, q, self.odometry_config))
        self.state = pe.project(st, q, cfg, draws.project,
                                use_hash=self.hash is not None)
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
        if not (dist > cfg.measurement_threshold.distance
                or angle > cfg.measurement_threshold.angle or has_ltc):
            return False

        terrain_prob = (self._terrain_prob(ltc if has_ltc else None)
                        if cfg.contact_model.use_slip_update else None)
        lookup = (self._lookup if shared
                  else mp.make_chain_lookup(self.pool, cfg.mls_z_window))
        state, aux = pe.update(self.state, contact_state, q, lookup, cfg,
                               draws.resample_u, terrain_prob)
        self.last_eval = aux["eval"]
        if not shared:
            # chains follow the particles along the resampling index,
            # the identity when resampling did not fire (replaces
            # cloneMaps-on-resample, PoseEstimator.cpp:249-253)
            self.pool = self.pool.resample(aux["resample_idx"])
            p = state.particles
            state = dataclasses.replace(state, particles=dataclasses.replace(
                p, map_id=torch.arange(p.n, dtype=torch.int32,
                                       device=p.x.device)))
        self.state = state
        if self.hash is not None and self.steps % max(
                1, self.hash.config.period) == 0:
            self.state = self.hash.reinject(self.state, contact_state, q,
                                            cfg, draws.hash_u)
        self.ud_pose = pose
        return True

    # ------------------------------------------------------------------
    # exteroceptive updates (EmbodiedSlamFilter.cpp:179-351)
    # ------------------------------------------------------------------

    def _queued(self, name):
        raise NotImplementedError(
            f"EmbodiedSlamFilter.{name} is not ported yet (ROADMAP.md "
            "queue 1); filter.streaming runs the laser path")

    def update_scan(self, *args, **kw):
        self._queued("update_scan")

    def update_distance_image(self, *args, **kw):
        self._queued("update_distance_image")

    def process_map(self, *args, **kw):
        self._queued("process_map")

    def run_stream(self, *args, **kw):
        self._queued("run_stream")

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
