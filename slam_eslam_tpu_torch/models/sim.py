"""Synthetic simulation fixtures, in NumPy.

A jax-free copy of ``slam_eslam_tpu.models.sim`` (``terrain_grid``,
``conformal_contact_state``, ``TrajectorySim``) with the Asguard wheel
geometry of ``slam_eslam_tpu.models.asguard``, so the benchmark
trajectory can be rebuilt where JAX is not installed.  The grid is
filled with the same float32 arithmetic as the JAX ``merge_points`` of
one measurement into each empty cell.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from slam_eslam_tpu_torch.core.state import BodyContactState
from slam_eslam_tpu_torch.mapping.mls_grid import MLSGrid
from slam_eslam_tpu_torch.utils import tree

NUM_WHEELS = 4
FEET_PER_WHEEL = 5
NUM_FEET = NUM_WHEELS * FEET_PER_WHEEL


@dataclasses.dataclass
class AsguardConfig:
    wheel_radius: float = 0.16
    # wheel centre offsets (x lateral, y longitudinal)
    track_width: float = 0.5
    wheel_base: float = 0.6

    def wheel_centers(self):
        hx, hy = self.track_width / 2.0, self.wheel_base / 2.0
        return np.array(
            [[-hx, -hy, 0.0], [hx, -hy, 0.0], [-hx, hy, 0.0], [hx, hy, 0.0]]
        )


def terrain_grid(terrain, nx, ny, resolution, origin, stdev=0.02, k=4,
                 device=None):
    """An ``MLSGrid`` holding one patch per cell (slot 0) at
    ``terrain(x, y)`` of the cell centre, with standard deviation
    ``stdev``."""
    f32 = np.float32
    ix, iy = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    cells = np.stack([ix.ravel(), iy.ravel()], -1).astype(f32)
    xy = (cells + f32(0.5)) * f32(resolution) + np.asarray(origin, f32)
    z = np.asarray(terrain(xy[:, 0], xy[:, 1]), f32)
    # one Gaussian-fused measurement per empty cell: inverse-variance
    # sums of a single point, inserted into the first free slot
    var = np.full_like(z, stdev, dtype=f32) ** 2
    w = f32(1.0) / np.maximum(var, f32(1e-12))
    fused_z = (w * z) / np.maximum(w, f32(1e-30))
    fused_sd = np.sqrt(f32(1.0) / np.maximum(w, f32(1e-30)))

    g = MLSGrid.create(nx, ny, resolution, origin, k)
    g.mean[..., 0] = torch.from_numpy(fused_z.reshape(nx, ny))
    g.stdev[..., 0] = torch.from_numpy(fused_sd.reshape(nx, ny))
    g.valid[..., 0] = True
    return g if device is None else tree.to(g, device)


def conformal_contact_state(position, yaw, terrain, config=None, noise=0.0,
                            rng=None):
    """Terrain-conformal contact candidates for a true pose: per wheel,
    the stance foot sits on the terrain under the wheel centre (contact
    1) and the other feet hang above it (contact 0).  Points are in the
    yaw-compensated body frame."""
    config = config or AsguardConfig()
    rng = rng or np.random.default_rng(0)
    centers = config.wheel_centers()
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, -s], [s, c]])

    positions = np.zeros((NUM_FEET, 3), np.float32)
    contact = np.zeros(NUM_FEET, np.float32)
    group = np.repeat(np.arange(NUM_WHEELS), FEET_PER_WHEEL).astype(np.int32)
    for wheel in range(NUM_WHEELS):
        cw = centers[wheel]
        world_xy = rot @ cw[:2] + position[:2]
        ground = terrain(world_xy[0], world_xy[1])
        for j in range(FEET_PER_WHEEL):
            i = wheel * FEET_PER_WHEEL + j
            if j == 0:
                fz = ground - position[2] + rng.normal() * noise
                contact[i] = 1.0
            else:
                fz = ground - position[2] + 0.05 + 0.03 * j
            positions[i] = [cw[0], cw[1], fz]
    return BodyContactState.create(positions, contact=contact, group_id=group)


class TrajectorySim:
    """Ground-truth poses moving along body +y over a terrain."""

    def __init__(self, terrain, speed=0.05, yaw_rate=0.0, seed=0):
        self.terrain = terrain
        self.speed = speed
        self.yaw_rate = yaw_rate
        self.rng = np.random.default_rng(seed)
        self.position = np.zeros(3)
        self.yaw = 0.0
        self.position[2] = terrain(0.0, 0.0) + 0.2

    def step(self):
        """Advance one step; returns the ground truth ``(position, yaw)``
        and the body-frame odometry delta ``(dxy, dyaw, dz)``."""
        c, s = np.cos(self.yaw), np.sin(self.yaw)
        d_body = np.array([0.0, self.speed])
        self.position[:2] += np.array([[c, -s], [s, c]]) @ d_body
        self.yaw += self.yaw_rate
        new_z = self.terrain(self.position[0], self.position[1]) + 0.2
        dz = new_z - self.position[2]
        self.position[2] = new_z
        return (self.position.copy(), self.yaw), (d_body, self.yaw_rate, dz)

    def contact_state(self, noise=0.0):
        return conformal_contact_state(
            self.position, self.yaw, self.terrain, noise=noise, rng=self.rng
        )
