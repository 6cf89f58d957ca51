"""Sensor projection: laser scans and distance images -> patch clouds.

Port of ``slam_eslam_tpu.mapping.projection`` (the envire operator chains
of ``EmbodiedSlamFilter.cpp:137-176``): ``scan_to_points``
(``ScanMeshing``), ``distance_image_to_points``
(``DistanceGridToPointcloud``) with ``texture_colors`` (the ImageRGB24
input, ``:259-275``), ``project_points`` (``MLSProjection`` with
``useUncertainty``: a 5 deg sensor-yaw and a 3 deg body pitch/roll error
propagated to a per-point z standard deviation, ``:322-336``) and
``free_space_points`` (negative information).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from slam_eslam_tpu_torch.mapping.mls_grid import PatchCloud
from slam_eslam_tpu_torch.utils import geometry

SCAN_ANGLE_SIGMA = 5.0 * math.pi / 180.0   # EmbodiedSlamFilter.cpp:323
PITCH_ROLL_SIGMA = 3.0 * math.pi / 180.0   # EmbodiedSlamFilter.cpp:332


@dataclasses.dataclass
class LaserScan:
    """Planar scan (``base::samples::LaserScan``)."""

    ranges: torch.Tensor              # [R] float32, metres; <= 0 invalid
    start_angle: torch.Tensor         # [] float32
    angular_resolution: torch.Tensor  # [] float32


@dataclasses.dataclass
class DistanceImage:
    """Dense distance image (``base::samples::DistanceImage``), pinhole
    model: ``z = d``, ``x = (u * scale_x + center_x) * d``."""

    data: torch.Tensor      # [H, W] float32 distances; nan or <= 0 invalid
    scale_x: torch.Tensor   # [] float32
    scale_y: torch.Tensor
    center_x: torch.Tensor
    center_y: torch.Tensor


def scan_to_points(scan: LaserScan, max_range, min_range=0.1):
    """Scan line -> points in the scanner frame (x forward, scan in xy).
    Returns ``(points [R, 3], valid [R])``."""
    r = scan.ranges
    a = scan.start_angle + torch.arange(
        r.shape[0], dtype=r.dtype, device=r.device) * scan.angular_resolution
    valid = (r > min_range) & (r < max_range) & torch.isfinite(r)
    pts = torch.stack([r * torch.cos(a), r * torch.sin(a),
                       torch.zeros_like(r)], dim=-1)
    return pts, valid


def distance_image_to_points(img: DistanceImage, max_distance):
    """Distance image -> points in the camera frame, row-major.  Returns
    ``(points [H*W, 3], valid [H*W])``."""
    h, w = img.data.shape
    d = img.data.reshape(-1)
    u = torch.arange(w, dtype=d.dtype, device=d.device).repeat(h)
    v = torch.arange(h, dtype=d.dtype, device=d.device).repeat_interleave(w)
    x = (u * img.scale_x + img.center_x) * d
    y = (v * img.scale_y + img.center_y) * d
    valid = torch.isfinite(d) & (d > 0) & (d < max_distance)
    return torch.stack([x, y, torch.nan_to_num(d)], dim=-1), valid


def texture_colors(img: DistanceImage, texture):
    """Per-point RGB from a texture image aligned with the distance image:
    ``texture [H, W, 3]`` in [0, 1] -> ``[H*W, 3]`` float32 in the order of
    ``distance_image_to_points``."""
    h, w = img.data.shape
    return torch.as_tensor(texture, dtype=torch.float32,
                           device=img.data.device).reshape(h * w, 3)


def _to_yaw_free_world(points, sensor2body_rot, sensor2body_trans,
                       orientation):
    """Sensor-frame points -> body frame and yaw-compensated world frame.
    Returns ``(p_body, p_world, q0)`` with ``q0`` the yaw-free
    orientation."""
    p_body = points @ sensor2body_rot.T + sensor2body_trans
    q0 = geometry.remove_yaw(orientation)
    return p_body, geometry.quat_rotate(q0[None, :], p_body), q0


def project_points(points, valid, sensor2body_rot, sensor2body_trans,
                   orientation, sensor_sigma=0.02,
                   sensor_angle_sigma=SCAN_ANGLE_SIGMA,
                   body_angle_sigma=PITCH_ROLL_SIGMA, color=None):
    """Sensor-frame points -> ``PatchCloud`` in the yaw-compensated body
    frame (the reference's ``scanFrame``), with z variance

        sensor_sigma^2 + (sensor-yaw error lever)^2 + (pitch/roll lever)^2

    by first-order propagation (``projection.project_points``)."""
    p_body, p_w, q0 = _to_yaw_free_world(points, sensor2body_rot,
                                         sensor2body_trans, orientation)
    dz_sensor = sensor_angle_sigma * torch.sqrt(
        p_body[:, 0] ** 2 + p_body[:, 1] ** 2
    ) * torch.abs(torch.sin(_tilt_angle(q0)))
    dz_body = body_angle_sigma * torch.sqrt(p_w[:, 0] ** 2 + p_w[:, 1] ** 2)
    stdev = torch.sqrt(sensor_sigma ** 2 + dz_sensor ** 2 + dz_body ** 2)
    return PatchCloud.create(xy=p_w[:, :2], z=p_w[:, 2], stdev=stdev,
                             valid=valid, color=color)


def free_space_points(points, valid, sensor2body_rot, sensor2body_trans,
                      orientation, samples=6, min_frac=0.15, max_frac=0.85):
    """Free-space samples along the sensor rays: ``samples`` positions
    between ``min_frac`` and ``max_frac`` of the way from the sensor to
    each hit.  Returns ``(points [R*samples, 3], mask [R*samples])`` in
    the frame of ``project_points``."""
    _, p_w, q0 = _to_yaw_free_world(points, sensor2body_rot,
                                    sensor2body_trans, orientation)
    origin = geometry.quat_rotate(q0, sensor2body_trans)
    fr = torch.linspace(min_frac, max_frac, samples, dtype=p_w.dtype,
                        device=p_w.device)
    free = origin[None, None, :] + fr[None, :, None] * (
        p_w[:, None, :] - origin[None, None, :])            # [R, S, 3]
    mask = valid[:, None].expand(free.shape[:2])
    return free.reshape(-1, 3), mask.reshape(-1)


def _tilt_angle(q):
    """Angle between the rotated z-axis and world z (pitch/roll tilt)."""
    # made on the device: a tensor from host values, or a setitem of a
    # Python number, would be a blocking host-to-device copy
    up = torch.zeros_like(q[1:4])
    up[2:].fill_(1.0)
    z_axis = geometry.quat_rotate(q, up)
    return torch.arccos(torch.clamp(z_axis[2], -1.0, 1.0))
