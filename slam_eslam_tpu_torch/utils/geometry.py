"""Geometry primitives: quaternions, yaw decomposition, 2-D rotations.

Port of ``slam_eslam_tpu.utils.geometry`` (the Rock ``base-types``
helpers the reference leans on: ``base::getYaw``, ``base::removeYaw``,
the 2.5-D particle pose).  Quaternions are ``[..., 4]`` tensors ordered
``[w, x, y, z]``; every function but ``quat_from_matrix`` broadcasts over
leading batch dimensions.
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


def quat_conj(q):
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def quat_normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


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


def quat_from_axis_angle(axis, angle):
    """Quaternion of a rotation by ``angle`` about ``axis [3]`` (normalised
    here), float32."""
    axis = torch.as_tensor(axis, dtype=torch.float32)
    axis = axis / torch.linalg.norm(axis)
    half = 0.5 * torch.as_tensor(angle, dtype=torch.float32,
                                 device=axis.device)
    return torch.cat([torch.cos(half)[..., None],
                      torch.sin(half)[..., None] * axis], dim=-1)


def quat_to_matrix(q):
    """``[..., 4]`` -> ``[..., 3, 3]`` rotation matrix."""
    w, x, y, z = q.unbind(-1)
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def quat_from_matrix(r):
    """``[3, 3]`` rotation matrix -> ``[4]`` unit quaternion with ``w >= 0``
    (Shepperd's method, branch-free: all four constructions, the
    best-conditioned one selected on the device)."""
    r = torch.as_tensor(r)
    m00, m11, m22 = r[0, 0], r[1, 1], r[2, 2]
    tr = m00 + m11 + m22
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22
    cands = torch.stack([
        torch.stack([qw2, r[2, 1] - r[1, 2], r[0, 2] - r[2, 0],
                     r[1, 0] - r[0, 1]]),
        torch.stack([r[2, 1] - r[1, 2], qx2, r[1, 0] + r[0, 1],
                     r[0, 2] + r[2, 0]]),
        torch.stack([r[0, 2] - r[2, 0], r[1, 0] + r[0, 1], qy2,
                     r[2, 1] + r[1, 2]]),
        torch.stack([r[1, 0] - r[0, 1], r[0, 2] + r[2, 0],
                     r[2, 1] + r[1, 2], qz2]),
    ])                                                   # [4, 4]
    mags = torch.stack([qw2, qx2, qy2, qz2])
    best = torch.argmax(mags)
    q = cands[best] / (2.0 * torch.sqrt(mags[best].clamp(min=1e-12)))
    return torch.where(q[0] < 0, -q, q)


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


def rotate2d(theta, v):
    """Rotate 2-vector(s) ``v [..., 2]`` by angle(s) ``theta [...]``."""
    c, s = torch.cos(theta), torch.sin(theta)
    x, y = v[..., 0], v[..., 1]
    return torch.stack([c * x - s * y, s * x + c * y], dim=-1)


def angle_of_rotation(q):
    """Total rotation angle of a quaternion
    (``Eigen::AngleAxisd(R).angle()``)."""
    return 2.0 * torch.arccos(q[..., 0].abs().clamp(0.0, 1.0))


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


def transform_points(rot, trans, points):
    """Apply ``(R [..., 3, 3], t [..., 3])`` to ``points [..., P, 3]``."""
    return torch.einsum("...ij,...pj->...pi", rot, points) + trans[..., None, :]
