"""Particle sets and body contact states as dataclasses of tensors.

Port of ``slam_eslam_tpu.core.state``: structure-of-arrays rebuilds of
``eslam::PoseParticle`` (``PoseParticle.hpp:52-86``) and
``odometry::BodyContactState`` (``ContactModel.cpp:21-41``).  World x
and y stay split into two ``[N]`` fields, which keeps every per-particle
load coalesced on a GPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from slam_eslam_tpu_torch.utils import geometry


@dataclasses.dataclass
class ParticleSet:
    """SoA particle state; every field has leading dim N."""

    x: torch.Tensor           # [N] float32 — world x
    y: torch.Tensor           # [N] float32 — world y
    yaw: torch.Tensor         # [N] float32 — heading
    z: torch.Tensor           # [N] float32 — zPos
    z_sigma: torch.Tensor     # [N] float32 — zSigma
    weight: torch.Tensor      # [N] float32
    mprob: torch.Tensor       # [N] float32 — last measurement probability
    floating: torch.Tensor    # [N] bool    — no valid contact measurement
    n_contacts: torch.Tensor  # [N] int32   — |cpoints| (discount exponent)
    map_id: torch.Tensor      # [N] int32   — map-pool index

    @property
    def n(self):
        return self.x.shape[0]

    @property
    def xy(self):
        """[N, 2] read view."""
        return torch.stack([self.x, self.y], dim=-1)

    def with_xy(self, xy):
        """Functional update from an ``[N, 2]`` (or ``[..., 2]``) tensor."""
        return dataclasses.replace(self, x=xy[..., 0], y=xy[..., 1])

    @staticmethod
    def zeros(n, device=None, dtype=torch.float32):
        return ParticleSet(
            x=torch.zeros(n, dtype=dtype, device=device),
            y=torch.zeros(n, dtype=dtype, device=device),
            yaw=torch.zeros(n, dtype=dtype, device=device),
            z=torch.zeros(n, dtype=dtype, device=device),
            z_sigma=torch.zeros(n, dtype=dtype, device=device),
            weight=torch.full((n,), 1.0 / n, dtype=dtype, device=device),
            mprob=torch.ones(n, dtype=dtype, device=device),
            floating=torch.ones(n, dtype=torch.bool, device=device),
            n_contacts=torch.zeros(n, dtype=torch.int32, device=device),
            map_id=torch.zeros(n, dtype=torch.int32, device=device),
        )

    def pose_matrix(self):
        """(R, t) per particle for the weighting loop
        (``PoseEstimator.cpp:279-282``)."""
        return geometry.pose_matrix_2p5d(self.xy, self.yaw, self.z)

    def full_pose(self, orientation_quat):
        """6-DoF pose per particle, ``(q [N, 4], t [N, 3])``: translation *
        yaw * removeYaw(imu) (``PoseParticle.hpp:58-67``)."""
        q = geometry.quat_mul(
            geometry.quat_from_yaw(self.yaw),
            geometry.remove_yaw(orientation_quat).expand(
                self.yaw.shape + (4,)))
        return q, torch.stack([self.x, self.y, self.z], dim=-1)


@dataclasses.dataclass
class BodyContactState:
    """Fixed-size contact-point set (leading dim C = candidates)."""

    position: torch.Tensor  # [C, 3] float32 — body-frame positions
    contact: torch.Tensor   # [C] float32 — contact probability (NaN = unknown)
    slip: torch.Tensor      # [C] float32
    group_id: torch.Tensor  # [C] int32   — -1 = ungrouped
    valid: torch.Tensor     # [C] bool    — padding mask

    @property
    def c(self):
        return self.position.shape[0]

    @staticmethod
    def create(position, contact=None, slip=None, group_id=None, valid=None,
               device=None):
        position = torch.as_tensor(position, dtype=torch.float32,
                                   device=device)
        c = position.shape[0]
        device = position.device

        def field(val, fill, dtype):
            if val is None:
                return torch.full((c,), fill, dtype=dtype, device=device)
            return torch.as_tensor(val, dtype=dtype, device=device)

        return BodyContactState(
            position=position,
            contact=field(contact, float("nan"), torch.float32),
            slip=field(slip, 0.0, torch.float32),
            group_id=field(group_id, -1, torch.int32),
            valid=field(valid, True, torch.bool),
        )

    def compact(self, cap):
        """Host-side compaction to the active candidate set
        (``slam_eslam_tpu.core.state.BodyContactState.compact``).

        Points below the contact threshold are never queried
        (``ContactModel.cpp:136,154``), so keeping the actives first
        (stable order, group runs preserved) gives identical results in
        ``cap`` slots.  Measurement-only: the odometry differences
        contact points by slot across frames and needs the full stream.
        """
        from slam_eslam_tpu_torch.models.contact_model import (
            CONTACT_THRESHOLD,
        )

        contact = self.contact.cpu().numpy()
        valid = self.valid.cpu().numpy()
        active = valid & ~(contact < CONTACT_THRESHOLD)
        order = np.argsort(~active, kind="stable")  # actives first
        keep = torch.as_tensor(np.sort(order[:cap]),
                               device=self.position.device)
        return BodyContactState(
            position=self.position[keep],
            contact=self.contact[keep],
            slip=self.slip[keep],
            group_id=self.group_id[keep],
            valid=self.valid[keep],
        )

    def segments(self):
        """Group segmentation (``ContactModel.cpp:193-214``): groups are
        consecutive runs of equal non-negative ``group_id``, and every
        ``-1`` point is its own group.  Returns ``(seg_id [C] int32,
        num_segments C)``."""
        gid = self.group_id
        prev = torch.cat([gid.new_full((1,), -2), gid[:-1]])
        boundary = (gid != prev) | (gid < 0)
        seg = torch.cumsum(boundary.to(torch.int32), 0) - 1
        return seg.to(torch.int32), self.c
