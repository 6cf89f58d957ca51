"""Legged-wheel (Asguard-like) kinematics and simulation fixture, in NumPy.

Port of ``slam_eslam_tpu.models.asguard`` (the reference's test fixture,
``testMap.cpp:65-104``): four wheels, each a five-spoke star of feet;
rolling the wheels moves the robot along body +y from foot to foot and
produces the contact stream that drives the filter.  It runs in NumPy
and builds the port's ``BodyContactState`` (CPU tensors), so the SLAM
benchmark trajectory can be made where JAX is not installed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from slam_eslam_tpu_torch.core.state import BodyContactState

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

    def foot_positions(self, wheel_pos):
        """Body-frame positions ``[NUM_FEET, 3]`` of all feet for wheel
        angles ``wheel_pos [4]``, wheel-major (group id = wheel)."""
        centers = self.wheel_centers()
        j = np.arange(FEET_PER_WHEEL)
        angles = wheel_pos[:, None] + j[None, :] * (2 * np.pi / FEET_PER_WHEEL)
        offs = np.stack(
            [np.zeros_like(angles), -np.sin(angles), -np.cos(angles)],
            axis=-1,
        ) * self.wheel_radius
        return (centers[:, None, :] + offs).reshape(NUM_FEET, 3)

    def lowest_foot_position(self, wheel_pos):
        feet = self.foot_positions(wheel_pos)
        return feet[np.argmin(feet[:, 2])]

    def contact_state(self, wheel_pos):
        """One contact candidate per foot, grouped by wheel; the lowest
        foot of each wheel is in contact (``ContactModel.cpp:48-92``)."""
        feet = self.foot_positions(wheel_pos)
        group = np.repeat(np.arange(NUM_WHEELS), FEET_PER_WHEEL)
        z = feet[:, 2].reshape(NUM_WHEELS, FEET_PER_WHEEL)
        lowest = np.zeros_like(z)
        lowest[np.arange(NUM_WHEELS), np.argmin(z, axis=1)] = 1.0
        c = feet.shape[0]
        return BodyContactState(
            position=torch.from_numpy(feet.astype(np.float32)),
            contact=torch.from_numpy(lowest.reshape(-1).astype(np.float32)),
            slip=torch.zeros(c, dtype=torch.float32),
            group_id=torch.from_numpy(group.astype(np.int32)),
            valid=torch.ones(c, dtype=torch.bool),
        )


class AsguardSim:
    """Kinematic ground-truth simulator (``testMap.cpp:65-104``): the
    body z rides so that the lowest foot touches the terrain under it
    (``:81-83,101-102``)."""

    def __init__(self, config: AsguardConfig = None, terrain=None):
        self.config = config or AsguardConfig()
        self.terrain = terrain or (lambda x, y: 0.0)
        self.wheel_pos = np.zeros(NUM_WHEELS)
        self.position = np.zeros(3)
        self.yaw = 0.0
        self._settle()

    def _settle(self):
        world_feet = self._to_world(
            self.config.foot_positions(self.wheel_pos))
        clearance = world_feet[:, 2] - np.array(
            [self.terrain(p[0], p[1]) for p in world_feet])
        self.position[2] -= clearance.min()

    def _to_world(self, pts):
        c, s = np.cos(self.yaw), np.sin(self.yaw)
        r = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        return pts @ r.T + self.position

    @property
    def orientation(self):
        half = 0.5 * float(self.yaw)
        return np.array([np.cos(half), 0.0, 0.0, np.sin(half)], np.float32)

    def contact_state(self):
        return self.config.contact_state(self.wheel_pos)

    def step(self, wheel_delta=0.1, yaw_rate=0.0, substeps=10,
             on_substep=None):
        """One filter step of ``substeps`` kinematic substeps (the
        reference's 10 x 0.01 rad inner loop, ``testMap.cpp:86-97``);
        ``on_substep(sim)`` runs after each.  Returns the new ground-truth
        ``(position, yaw)``."""
        d = wheel_delta / substeps
        for _ in range(substeps):
            prev_feet = self._to_world(
                self.config.foot_positions(self.wheel_pos))
            # the stance foot is the lowest one before the substep
            stance = int(np.argmin(prev_feet[:, 2]))
            self.wheel_pos += d
            self.yaw += yaw_rate / substeps
            cur_feet = self._to_world(
                self.config.foot_positions(self.wheel_pos))
            self.position[:2] += (prev_feet[stance] - cur_feet[stance])[:2]
            self._settle()
            if on_substep is not None:
                on_substep(self)
        return self.position.copy(), self.yaw
