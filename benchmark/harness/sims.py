"""The benchmark's traffic generators, in NumPy.

Copies of the port's simulation fixtures (``slam_eslam_tpu_torch.models.
sim``: ``terrain_grid``, ``conformal_contact_state``, ``TrajectorySim``;
``models.asguard``: ``AsguardConfig``, ``AsguardSim``), kept here so that
the yardstick does not move when the program does.  They emit plain
arrays: a contact state is a dict of NumPy arrays ``position [C, 3]``,
``contact [C]``, ``slip [C]``, ``group_id [C]`` and ``valid [C]``, and a
grid is a dict of ``mean``, ``stdev``, ``valid [nx, ny, K]`` and its
``origin`` and ``resolution``.  ``harness.port`` turns them into the
port's types at the boundary.
"""

from __future__ import annotations

import dataclasses

import numpy as np

NUM_WHEELS = 4
FEET_PER_WHEEL = 5
NUM_FEET = NUM_WHEELS * FEET_PER_WHEEL
# contact probability below which a candidate is never queried
# (ContactModel.cpp:136)
CONTACT_THRESHOLD = 0.2
# the contact probability of a foot touching down: active for the contact
# model, below the odometry's threshold of 0.5
TOUCHDOWN = 0.3

f32 = np.float32


TERRAINS = {
    # name: (a, kx, b, ky) of the height a sin(kx x) + b cos(ky y)
    "sine": (0.25, 1.3, 0.2, 0.9),         # the localisation map
    "sine_slam": (0.15, 0.7, 0.12, 0.5),   # the SLAM traverse
}


def terrain(kind):
    """The terrain height function ``h(x, y)`` of a configuration, of
    NumPy arrays or of torch tensors (the laser's ray casting)."""
    if kind not in TERRAINS:
        raise ValueError(f"unknown terrain {kind!r}")
    a, kx, b, ky = TERRAINS[kind]

    def height(x, y):
        if hasattr(x, "sin"):
            return a * (kx * x).sin() + b * (ky * y).cos()
        return a * np.sin(kx * np.asarray(x)) + b * np.cos(ky * np.asarray(y))

    return height


def terrain_grid(height, nx, ny, resolution, origin, stdev=0.02, k=4):
    """One patch per cell (slot 0) at ``height`` of the cell centre with
    standard deviation ``stdev``, fused as one Gaussian measurement into an
    empty cell, in float32."""
    ix, iy = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    cells = np.stack([ix.ravel(), iy.ravel()], -1).astype(f32)
    xy = (cells + f32(0.5)) * f32(resolution) + np.asarray(origin, f32)
    z = np.asarray(height(xy[:, 0], xy[:, 1]), f32)
    var = np.full_like(z, stdev, dtype=f32) ** 2
    w = f32(1.0) / np.maximum(var, f32(1e-12))
    fused_z = (w * z) / np.maximum(w, f32(1e-30))
    fused_sd = np.sqrt(f32(1.0) / np.maximum(w, f32(1e-30)))
    mean = np.zeros((nx, ny, k), f32)
    sd = np.zeros((nx, ny, k), f32)
    valid = np.zeros((nx, ny, k), bool)
    mean[..., 0] = fused_z.reshape(nx, ny)
    sd[..., 0] = fused_sd.reshape(nx, ny)
    valid[..., 0] = True
    return {"mean": mean, "stdev": sd, "valid": valid,
            "origin": np.asarray(origin, f32), "resolution": float(resolution)}


def contact_state(position, contact, group_id):
    c = len(contact)
    return {"position": np.asarray(position, f32),
            "contact": np.asarray(contact, f32),
            "slip": np.zeros(c, f32),
            "group_id": np.asarray(group_id, np.int32),
            "valid": np.ones(c, bool)}


def compact(cs, cap):
    """The active candidates first (stable, group runs kept), ``cap`` of
    them, in their original order (of each state along any leading axes):
    what the measurement update reads of a contact state (points below the contact threshold are never queried,
    ``ContactModel.cpp:136,154``)."""
    active = cs["valid"] & ~(cs["contact"] < CONTACT_THRESHOLD)
    order = np.argsort(~active, axis=-1, kind="stable")
    keep = np.sort(order[..., :cap], axis=-1)
    take = lambda v: np.take_along_axis(
        v, keep.reshape(keep.shape + (1,) * (v.ndim - keep.ndim)), axis=keep.ndim - 1)
    return {k: take(v) for k, v in cs.items()}


@dataclasses.dataclass
class AsguardConfig:
    wheel_radius: float = 0.16
    track_width: float = 0.5
    wheel_base: float = 0.6

    def wheel_centers(self):
        hx, hy = self.track_width / 2.0, self.wheel_base / 2.0
        return np.array(
            [[-hx, -hy, 0.0], [hx, -hy, 0.0], [-hx, hy, 0.0], [hx, hy, 0.0]])

    def foot_positions(self, wheel_pos):
        """Body-frame feet ``[..., NUM_FEET, 3]`` for wheel angles ``[...,
        4]``, wheel-major."""
        centers = self.wheel_centers()
        j = np.arange(FEET_PER_WHEEL)
        angles = (wheel_pos[..., :, None]
                  + j * (2 * np.pi / FEET_PER_WHEEL))
        offs = np.stack([np.zeros_like(angles), -np.sin(angles),
                         -np.cos(angles)], axis=-1) * self.wheel_radius
        return (centers[:, None, :] + offs).reshape(
            wheel_pos.shape[:-1] + (NUM_FEET, 3))

    def contact_state(self, wheel_pos):
        """One candidate per foot, grouped by wheel; the lowest foot of
        each wheel is in contact."""
        feet = self.foot_positions(wheel_pos)
        group = np.repeat(np.arange(NUM_WHEELS), FEET_PER_WHEEL)
        z = feet[:, 2].reshape(NUM_WHEELS, FEET_PER_WHEEL)
        lowest = np.zeros_like(z)
        lowest[np.arange(NUM_WHEELS), np.argmin(z, axis=1)] = 1.0
        return contact_state(feet, lowest.reshape(-1), group)


def conformal_contact_state(position, yaw, height, config=None, noise=0.0,
                            rng=None, footholds=None, lifted=()):
    """Terrain-conformal candidates for a true pose: per wheel the stance
    foot sits on the terrain under the wheel centre (contact 1, height
    noise ``noise``) and the other feet hang above it (contact 0); points
    in the yaw-compensated body frame.  ``footholds [4, 2]``: the world xy
    where each wheel's stance foot stands, in place of the wheel centres;
    the wheels in ``lifted`` touch down and report a contact probability
    of ``TOUCHDOWN`` on their stance foot: active for the measurement
    update, below the odometry's contact threshold."""
    config = config or AsguardConfig()
    rng = rng or np.random.default_rng(0)
    centers = config.wheel_centers()
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, -s], [s, c]])
    positions = np.zeros((NUM_FEET, 3), f32)
    contact = np.zeros(NUM_FEET, f32)
    group = np.repeat(np.arange(NUM_WHEELS), FEET_PER_WHEEL).astype(np.int32)
    for wheel in range(NUM_WHEELS):
        cw = centers[wheel]
        world_xy = rot @ cw[:2] + position[:2]
        ground = height(world_xy[0], world_xy[1])
        for j in range(FEET_PER_WHEEL):
            i = wheel * FEET_PER_WHEEL + j
            if j == 0:
                fx, fy = cw[0], cw[1]
                if footholds is not None:
                    d = footholds[wheel] - position[:2]
                    fx, fy = rot.T @ d
                    ground = height(*footholds[wheel])
                fz = ground - position[2] + rng.normal() * noise
                contact[i] = TOUCHDOWN if wheel in lifted else 1.0
                positions[i] = [fx, fy, fz]
            else:
                fz = ground - position[2] + 0.05 + 0.03 * j
                positions[i] = [cw[0], cw[1], fz]
    return contact_state(positions, contact, group)


class TrajectorySim:
    """Ground-truth poses moving along body +y at ``speed`` a step,
    turning by ``yaw_rate`` a step, over a terrain.

    ``stance_steps`` 0: each step's stance feet stand under the wheel
    centres, so consecutive contact states show no foot moving and contact
    odometry sees no translation.  ``stance_steps`` k > 0: a wheel's stance
    foot stays where it touched down for k steps, so the body moves over
    it; wheel w touches down (under its centre, its contact probability
    ``TOUCHDOWN`` on that sample) at the steps ``t`` with
    ``(t + w) % k == 0``."""

    def __init__(self, height, speed=0.05, yaw_rate=0.0, seed=0,
                 stance_steps=0):
        self.height = height
        self.speed = speed
        self.yaw_rate = yaw_rate
        self.rng = np.random.default_rng(seed)
        self.position = np.zeros(3)
        self.yaw = 0.0
        self.position[2] = height(0.0, 0.0) + 0.2
        self.stance_steps = stance_steps
        self.t = 0
        self.footholds = self._centres() if stance_steps else None

    def _centres(self):
        c, s = np.cos(self.yaw), np.sin(self.yaw)
        rot = np.array([[c, -s], [s, c]])
        return (AsguardConfig().wheel_centers()[:, :2] @ rot.T
                + self.position[:2])

    def step(self):
        self.t += 1
        c, s = np.cos(self.yaw), np.sin(self.yaw)
        d_body = np.array([0.0, self.speed])
        self.position[:2] += np.array([[c, -s], [s, c]]) @ d_body
        self.yaw += self.yaw_rate
        new_z = self.height(self.position[0], self.position[1]) + 0.2
        dz = new_z - self.position[2]
        self.position[2] = new_z
        return (self.position.copy(), self.yaw), (d_body, self.yaw_rate, dz)

    def contact_state(self, noise=0.0):
        lifted = ()
        if self.stance_steps:
            lifted = [w for w in range(NUM_WHEELS)
                      if (self.t + w) % self.stance_steps == 0]
            centres = self._centres()
            for w in lifted:
                self.footholds[w] = centres[w]
        return conformal_contact_state(self.position, self.yaw, self.height,
                                       noise=noise, rng=self.rng,
                                       footholds=self.footholds,
                                       lifted=lifted)


class AsguardSim:
    """Kinematic ground truth of the legged wheels (``testMap.cpp:
    65-104``): rolling moves the body along +y from foot to foot, and the
    body z rides so that the lowest foot touches the terrain."""

    def __init__(self, config: AsguardConfig = None, height=None):
        self.config = config or AsguardConfig()
        self.height = height or (lambda x, y: 0.0)
        self.wheel_pos = np.zeros(NUM_WHEELS)
        self.position = np.zeros(3)
        self.yaw = 0.0
        self._settle()

    def _settle(self):
        feet = self._to_world(self.config.foot_positions(self.wheel_pos))
        clearance = feet[:, 2] - np.broadcast_to(
            self.height(feet[:, 0], feet[:, 1]), feet[:, 2].shape)
        self.position[2] -= clearance.min()

    def _to_world(self, pts):
        c, s = np.cos(self.yaw), np.sin(self.yaw)
        r = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        return pts @ r.T + self.position

    @property
    def orientation(self):
        half = 0.5 * float(self.yaw)
        return np.array([np.cos(half), 0.0, 0.0, np.sin(half)], f32)

    def contact_state(self):
        return self.config.contact_state(self.wheel_pos)

    def roll(self, steps, wheel_delta=0.1, substeps=10):
        """``steps`` calls of ``step`` with no turning, at once: every
        substep's body position ``[T, 3]`` and contact state (stacked,
        ``[T, NUM_FEET, ...]``), as ``step``'s ``on_substep`` sees them.
        The heading stays 0, so a foot's body-frame place and which foot
        stands do not depend on where the body is."""
        if self.yaw != 0.0:
            raise ValueError("roll keeps a heading of 0")
        t = steps * substeps
        d = wheel_delta / substeps
        wheel = self.wheel_pos + d * np.arange(t + 1)[:, None]   # [T+1, 4]
        feet = self.config.foot_positions(wheel)                 # [T+1, F, 3]
        stance = np.argmin(feet[:-1, :, 2], axis=1)
        rows = np.arange(t)
        moves = (feet[:-1][rows, stance] - feet[1:][rows, stance])[:, :2]
        xy = np.cumsum(np.concatenate([self.position[None, :2], moves]),
                       axis=0)[1:]
        world = xy[:, None, :] + feet[1:, :, :2]
        z = (self.height(world[..., 0], world[..., 1])
             - feet[1:, :, 2]).max(axis=1)
        self.wheel_pos = wheel[-1].copy()
        self.position = np.array([xy[-1, 0], xy[-1, 1], z[-1]])
        group = np.repeat(np.arange(NUM_WHEELS), FEET_PER_WHEEL)
        fz = feet[1:, :, 2].reshape(t, NUM_WHEELS, FEET_PER_WHEEL)
        lowest = (fz == fz.min(axis=2, keepdims=True)) & (
            np.cumsum(fz == fz.min(axis=2, keepdims=True), axis=2) == 1)
        states = {
            "position": feet[1:].astype(f32),
            "contact": lowest.reshape(t, NUM_FEET).astype(f32),
            "slip": np.zeros((t, NUM_FEET), f32),
            "group_id": np.broadcast_to(group.astype(np.int32),
                                        (t, NUM_FEET)).copy(),
            "valid": np.ones((t, NUM_FEET), bool)}
        return np.concatenate([xy, z[:, None]], 1), states

    def step(self, wheel_delta=0.1, yaw_rate=0.0, substeps=10,
             on_substep=None):
        d = wheel_delta / substeps
        for _ in range(substeps):
            prev = self._to_world(self.config.foot_positions(self.wheel_pos))
            stance = int(np.argmin(prev[:, 2]))
            self.wheel_pos += d
            self.yaw += yaw_rate / substeps
            cur = self._to_world(self.config.foot_positions(self.wheel_pos))
            self.position[:2] += (prev[stance] - cur[stance])[:2]
            self._settle()
            if on_substep is not None:
                on_substep(self)
        return self.position.copy(), self.yaw
