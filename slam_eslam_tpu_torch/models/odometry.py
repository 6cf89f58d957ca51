"""Contact (foot) odometry.

Port of ``slam_eslam_tpu.models.odometry`` (the capability of Rock's
``odometry::FootContact``, consumed at ``PoseEstimator.cpp:184-198``):
a stance foot is stationary in the world, so the body translation
between two samples is the weighted mean displacement of the feet in
contact in both, in the yaw-compensated frame.  The per-particle
delta sampler takes its standard normals as arguments.
"""

from __future__ import annotations

import dataclasses

import torch

from slam_eslam_tpu_torch.config import OdometryConfig
from slam_eslam_tpu_torch.core.state import BodyContactState
from slam_eslam_tpu_torch.utils import geometry, tracing


@dataclasses.dataclass
class FootContactOdometry:
    """Odometry state plus the last computed delta."""

    prev_points: torch.Tensor       # [C, 3] yaw-compensated positions
    prev_contact: torch.Tensor      # [C]
    prev_valid: torch.Tensor        # [C] bool
    prev_orientation: torch.Tensor  # [4]
    initialized: torch.Tensor       # [] bool
    delta_xy: torch.Tensor          # [2] (yaw-compensated frame)
    delta_yaw: torch.Tensor         # []
    delta_z: torch.Tensor           # []
    sigma_xy: torch.Tensor          # [2] std devs of the error model
    sigma_yaw: torch.Tensor         # []
    sigma_z: torch.Tensor           # []

    @staticmethod
    def create(num_points, device=None, dtype=torch.float32):
        z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
        return FootContactOdometry(
            prev_points=z(num_points, 3),
            prev_contact=z(num_points),
            prev_valid=torch.zeros(num_points, dtype=torch.bool,
                                   device=device),
            prev_orientation=geometry.quat_identity(dtype, device),
            initialized=torch.zeros((), dtype=torch.bool, device=device),
            delta_xy=z(2),
            delta_yaw=z(),
            delta_z=z(),
            sigma_xy=z(2),
            sigma_yaw=z(),
            sigma_z=z(),
        )


def update(odo: FootContactOdometry, state: BodyContactState, orientation,
           cfg: OdometryConfig):
    """Advance the odometry with a new contact state and IMU orientation
    (``FootContact::update``, call site ``EmbodiedSlamFilter.cpp:357``)."""
    with tracing.stage("odometry", state.position.device):
        q = geometry.remove_yaw(orientation)
        pts = geometry.quat_rotate(q[None, :], state.position)
        contact = torch.nan_to_num(state.contact, nan=1.0)

        both = (
            odo.initialized
            & odo.prev_valid
            & state.valid
            & (odo.prev_contact > cfg.contact_threshold)
            & (contact > cfg.contact_threshold)
        )
        w = torch.where(both, torch.minimum(odo.prev_contact, contact),
                        torch.zeros_like(contact))
        wsum = w.sum()

        yaw_prev = geometry.yaw_from_quat(odo.prev_orientation)
        yaw_cur = geometry.yaw_from_quat(orientation)
        d = yaw_cur - yaw_prev
        dyaw = torch.where(odo.initialized,
                           torch.atan2(torch.sin(d), torch.cos(d)),
                           torch.zeros_like(d))

        # remove the yaw-delta rotation from the current points before
        # differencing: t_delta = p_prev - R(dyaw) p_cur
        c_d, s_d = torch.cos(dyaw), torch.sin(dyaw)
        pts_rot = torch.stack(
            [c_d * pts[:, 0] - s_d * pts[:, 1],
             s_d * pts[:, 0] + c_d * pts[:, 1],
             pts[:, 2]], dim=-1,
        )
        disp = odo.prev_points - pts_rot                           # [C, 3]
        mean_disp = (disp * w[:, None]).sum(0) / wsum.clamp(min=1e-9)
        mean_disp = torch.where(wsum > 0, mean_disp,
                                torch.zeros_like(mean_disp))

        dist = torch.linalg.vector_norm(mean_disp[:2])
        sigma_xy = torch.full((2,), cfg.const_error_xy, dtype=pts.dtype,
                              device=pts.device) + cfg.dist_error_xy * dist
        return dataclasses.replace(
            odo,
            prev_points=pts,
            prev_contact=contact,
            prev_valid=state.valid,
            prev_orientation=orientation,
            initialized=torch.ones_like(odo.initialized),
            delta_xy=mean_disp[:2],
            delta_yaw=dyaw,
            delta_z=mean_disp[2],
            sigma_xy=sigma_xy,
            sigma_yaw=cfg.const_error_yaw + cfg.dist_error_yaw * dist,
            sigma_z=cfg.const_error_z + cfg.dist_error_z * dist,
        )


def pose_delta_samples_2d(odo: FootContactOdometry, normal_xy, normal_yaw):
    """Noise-sampled 2-D pose deltas (``getPoseDeltaSample2D``,
    ``PoseEstimator.cpp:198``) from standard normals ``normal_xy
    [n, 2]`` and ``normal_yaw [n]``.  Returns ``(dxy [n, 2], dyaw [n])``.
    """
    dxy = odo.delta_xy + normal_xy * odo.sigma_xy
    dyaw = odo.delta_yaw + normal_yaw * odo.sigma_yaw
    return dxy, dyaw


def position_error(odo: FootContactOdometry):
    """3x3 position error covariance (``FootContact::getPositionError``)."""
    return torch.diag(
        torch.stack([odo.sigma_xy[0] ** 2, odo.sigma_xy[1] ** 2,
                     odo.sigma_z ** 2])
    )


def z_delta_and_var(odo: FootContactOdometry, orientation):
    """World z displacement and variance for z propagation
    (``PoseEstimator.cpp:188-192``): the delta is already in the
    yaw-compensated world frame, so its z component is the world z
    displacement; the variance is the odometry's z error doubled."""
    del orientation
    return odo.delta_z, (odo.sigma_z ** 2) * 2.0
