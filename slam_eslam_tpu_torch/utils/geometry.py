"""Quaternion and yaw helpers of the localisation step.

Port of the subset of ``slam_eslam_tpu.utils.geometry`` the main path
uses (``base::getYaw`` / ``base::removeYaw`` / the 2.5-D particle pose).
Quaternions are ``[..., 4]`` tensors ordered ``[w, x, y, z]``; every
function broadcasts over leading batch dimensions.
"""

from __future__ import annotations

import torch


def quat_identity(dtype=torch.float32, device=None):
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_mul(q1, q2):
    """Hamilton product ``q1 * q2`` ([..., 4] x [..., 4] -> [..., 4])."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_rotate(q, v):
    """Rotate vector(s) ``v`` [..., 3] by quaternion(s) ``q`` [..., 4]."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    u, v = torch.broadcast_tensors(u, v)
    # v' = v + 2 w (u x v) + 2 u x (u x v)
    uv = torch.linalg.cross(u, v, dim=-1)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=-1))


def quat_from_yaw(yaw):
    """Quaternion for a rotation of ``yaw`` about +Z ([...] -> [..., 4])."""
    half = 0.5 * yaw
    zeros = torch.zeros_like(half)
    return torch.stack([torch.cos(half), zeros, zeros, torch.sin(half)],
                       dim=-1)


def yaw_from_quat(q):
    """Heading of the quaternion: the angle of the rotated x-axis
    projected into the xy-plane (``base::getYaw``)."""
    w, x, y, z = q.unbind(-1)
    r00 = 1 - 2 * (y * y + z * z)
    r10 = 2 * (x * y + w * z)
    return torch.atan2(r10, r00)


def remove_yaw(q):
    """Strip the heading: ``R_z(-yaw(q)) * q`` (``base::removeYaw``)."""
    return quat_mul(quat_from_yaw(-yaw_from_quat(q)), q)


def rot2d(theta):
    """``[...]`` -> ``[..., 2, 2]`` planar rotation matrix."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], dim=-1),
                        torch.stack([s, c], dim=-1)], dim=-2)


def pose_matrix_2p5d(xy, yaw, z):
    """Per-particle ``(R [..., 3, 3], t [..., 3])`` of
    ``Translation3d(x, y, z) * AngleAxisd(yaw, UnitZ())``
    (``PoseEstimator.cpp:279-282``)."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    r = torch.stack(
        [c, -s, zero, s, c, zero, zero, zero, one], dim=-1
    ).reshape(yaw.shape + (3, 3))
    t = torch.cat([xy, z[..., None]], dim=-1)
    return r, t
