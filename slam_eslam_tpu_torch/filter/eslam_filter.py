"""Embodied-SLAM orchestrator: construction and read-out.

Port of the construction half of
``slam_eslam_tpu.filter.eslam_filter.EmbodiedSlamFilter``
(``EmbodiedSlamFilter.{hpp,cpp}``): the grid template, ``init`` in both
map modes (a shared environment grid, or per-particle maps in a
``MapPool`` seeded from a blank template or cloned from an environment
grid) and the read-outs ``get_particles``, ``get_best_particle_index``
and ``get_centroid``.  The streaming SLAM loop that drives it is
``filter.streaming``.  The host-driven updates (``update_contact``,
``update_scan``, ``update_distance_image``, ``process_map``,
``run_stream``) and the surface hash are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from slam_eslam_tpu.config import Config, SurfaceHashConfig
from slam_eslam_tpu_torch.core import filter as pf
from slam_eslam_tpu_torch.filter import pose_estimator as pe
from slam_eslam_tpu_torch.mapping import map_pool as mp
from slam_eslam_tpu_torch.mapping import mls_grid


class EmbodiedSlamFilter:
    """``device`` holds every tensor.  The reference constructor's
    odometry configuration (``EmbodiedSlamFilter.cpp:13-23``) serves the
    host-driven updates, which are not ported yet."""

    def __init__(self, config: Config = None, device=None):
        self.config = config or Config()
        self.device = torch.device(device or "cpu")
        self.state: pe.PoseEstimatorState | None = None
        self.shared_grid: mls_grid.MLSGrid | None = None
        self.pool: mp.MapPool | None = None
        self.use_shared_map = True

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
             num_contact_points=20, normal_xy=None, normal_yaw=None):
        """``pose = (position [3], yaw)`` (``EmbodiedSlamFilter.cpp:
        70-177``).  Shared-map mode needs ``shared_grid``.  Per-particle
        mode seeds every particle's map with a copy of ``shared_grid``
        when given (clone-from-env, ``PoseEstimator.cpp:47-62``), else
        with a blank template centred on the start pose.

        Particles start Gaussian around ``pose``; ``normal_xy [N, 2]`` and
        ``normal_yaw [N]`` are their standard normals, drawn from the
        state's generator (seeded with ``config.seed``) when not given."""
        cfg = self.config
        if hash_config is not None and hash_config.use_hash:
            raise NotImplementedError(
                "the surface hash is not ported yet (ROADMAP.md, queue 1: "
                "filter/surface_hash.py)")
        position, yaw = np.asarray(pose[0], np.float64), float(pose[1])
        self.use_shared_map = use_shared_map
        if use_shared_map:
            if shared_grid is None:
                raise ValueError("shared-map mode requires an MLS grid "
                                 "(EmbodiedSlamFilter.cpp:104)")
            self.shared_grid, self.pool = shared_grid, None
        else:
            template = (shared_grid if shared_grid is not None
                        else self.make_grid_template(center=position[:2]))
            self.pool = mp.MapPool.from_template(
                template, cfg.particle_count, cfg.map_pool_blocks,
                cfg.map_chain_length, with_color=cfg.map_pool_color,
                shards=cfg.map_pool_shards, dtype=cfg.map_pool_dtype,
                device=self.device)
            self.shared_grid = None

        state = pe.PoseEstimatorState.create(
            cfg, num_contact_points, device=self.device)
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
        return self

    def get_particles(self):
        return self.state.particles

    def get_best_particle_index(self):
        return int(pf.best_particle_index(self.state.particles.weight))

    def get_centroid(self):
        """``(position [3], orientation quaternion [4])``."""
        return pe.centroid(self.state.particles,
                           self.state.odometry.prev_orientation,
                           wrap_safe=self.config.wrap_safe_centroid)
