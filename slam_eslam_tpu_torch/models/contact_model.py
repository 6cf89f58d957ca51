"""Terrain-contact measurement model.

Port of the ``"ratio"`` weighting of ``slam_eslam_tpu.models.contact_model``
(``ContactModel.cpp:117-224,262-340``): the likelihood of each particle
pose given the robot's contact candidates and a shared MLS map.  Groups
are consecutive runs of contact points (``BodyContactState.segments``);
their reductions are one-hot ``[C, S]`` sums over a contact state shared
by every particle.

``evaluate_pose_batch`` has the two branches of the JAX function: the
fold branch, where the lookup's ``fold`` (kernel K1 on a GPU) returns
per-particle statistics, and the unfolded branch, which evaluates the
likelihood ratio in log space per query — the in-package oracle of the
fold.  Chitta weighting, terrain probabilities and debug points are not
part of this port yet.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from slam_eslam_tpu.config import ContactModelConfig
from slam_eslam_tpu_torch.core.state import BodyContactState
from slam_eslam_tpu_torch.utils import geometry

# contact probability below which a candidate is skipped
# (fixed in the reference, ContactModel.cpp:136)
CONTACT_THRESHOLD = 0.2


def set_contact_points(state: BodyContactState, orientation):
    """Rotate contact candidates into the yaw-compensated frame
    (``ContactModel::setContactPoints``, ``ContactModel.cpp:21-41``)."""
    q = geometry.remove_yaw(orientation)
    return dataclasses.replace(
        state, position=geometry.quat_rotate(q[None, :], state.position)
    )


@dataclasses.dataclass
class ContactEvalResult:
    """Per-particle output of ``evaluate_pose_batch`` (``getWeight``,
    ``getZDelta``, ``getZVar``, ``m_poseVar``; ``ContactModel.hpp:
    124-141``) plus the per-group ``cp_*`` payload (zeros on the fold
    branch, which keeps group data inside the kernel)."""

    measurement_valid: torch.Tensor  # [N] bool — >= min_contacts groups
    weight: torch.Tensor             # [N] joint contact probability
    z_delta: torch.Tensor            # [N] proposed z correction
    z_var: torch.Tensor              # [N] variance of the correction
    pose_var: torch.Tensor           # [N] summed map variance
    n_contacts: torch.Tensor         # [N] int32 — valid contact groups
    cp_zdiff: torch.Tensor           # [N, S]
    cp_zvar: torch.Tensor            # [N, S]
    cp_ok: torch.Tensor              # [N, S] bool


def contact_likelihood_ratio(z, sigma, correction):
    """pdf/cdf contact-vs-no-contact ratio (``ContactModel.cpp:104-115``)
    in log space, as ``jax.scipy.stats.norm``'s ``logpdf - logcdf``."""
    s = sigma * correction
    s2 = s * s
    logpdf = (torch.log(2.0 * math.pi * s2) + (z * z) / s2) / -2.0
    return torch.exp(logpdf - torch.special.log_ndtr(z / s))


def update_z_position_estimate(result: ContactEvalResult, z_pos, z_var):
    """1-D Kalman z update with outlier rejection
    (``ContactModel::updateZPositionEstimate``, ``ContactModel.cpp:
    319-340``), batched over particles.  Returns ``(accepted, new_z_pos,
    new_z_var)``; rejected particles keep their inputs."""
    n = result.n_contacts.clamp(min=1).to(z_pos.dtype)
    pose_var = result.pose_var / n
    delta_var = (z_var - pose_var).clamp(min=1e-9)
    accepted = (result.z_delta / torch.sqrt(delta_var)).abs() <= 1.0
    gain = z_var / (z_var + result.z_var)
    new_z = z_pos + gain * result.z_delta
    var_gain = delta_var / (delta_var + result.z_var)
    new_var = pose_var + (1.0 - var_gain) * delta_var
    return (accepted, torch.where(accepted, new_z, z_pos),
            torch.where(accepted, new_var, z_var))


def world_queries(state: BodyContactState, rot, trans, radius):
    """Contact-grid ``[C, N]`` world coordinates ``R_i p_c + t_i - (0, 0,
    radius)`` as three tensors (contact rows, particle columns)."""
    px = state.position[:, 0:1]                                # [C, 1]
    py = state.position[:, 1:2]
    pz = state.position[:, 2:3]

    def row(j):
        return (rot[:, j, 0][None, :] * px + rot[:, j, 1][None, :] * py
                + rot[:, j, 2][None, :] * pz + trans[:, j][None, :])

    return row(0), row(1), row(2) - radius


def evaluate_pose_batch(state: BodyContactState, rot, trans, meas_var,
                        map_lookup_batch, cfg: ContactModelConfig,
                        terrain_prob=None, with_debug_points=False):
    """Contact likelihood of N particle poses (``ContactModel::
    evaluatePose`` + ``evaluateWeight``), batched.

    ``rot [N, 3, 3]``, ``trans [N, 3]``, ``meas_var [N]``;
    ``map_lookup_batch`` takes SoA queries ``(x, y, z)`` and returns
    ``(found, mean, stdev)`` of the same shape, and may carry ``fold``
    (see ``ops.contact_fold.contact_fold``).
    """
    if cfg.weighting != "ratio" or terrain_prob is not None \
            or with_debug_points:
        raise NotImplementedError(
            "the port evaluates the 'ratio' weighting without terrain "
            "probabilities or debug points"
        )
    n = rot.shape[0]
    seg, num_seg = state.segments()
    dtype = state.position.dtype
    onehot = (seg[:, None] == torch.arange(num_seg, dtype=seg.dtype,
                                           device=seg.device)[None, :]
              ).to(dtype)                                      # [C, S]
    active = state.valid & ~(state.contact < CONTACT_THRESHOLD)  # [C]
    wx, wy, wz = world_queries(state, rot, trans, cfg.contact_point_radius)

    fold_fn = getattr(map_lookup_batch, "fold", None)
    if fold_fn is not None and cfg.fold_lookup:
        out8 = fold_fn(
            (wx, wy, wz), active.to(dtype)[:, None],
            meas_var.to(dtype)[None, :], onehot=onehot,
            correction=cfg.contact_likelihood_correction,
        )
        d1, d2, sq, pv, ncf = out8[0], out8[1], out8[2], out8[3], out8[4]
        n_contacts = torch.round(ncf).to(torch.int32)
        pos = d2 > 0
        safe_d2 = torch.where(pos, d2, torch.ones_like(d2))
        delta = d1 / safe_d2
        # sum_i (zdiff_i - delta)^2 / zvar_i == sq - d1 * delta
        log_pz = (-0.5 * (sq - d1 * delta) if cfg.use_shape_update
                  else torch.zeros_like(sq))
        return ContactEvalResult(
            measurement_valid=n_contacts >= cfg.min_contacts,
            weight=torch.exp(log_pz),
            z_delta=-delta,
            z_var=torch.where(pos, 1.0 / safe_d2,
                              torch.full_like(d2, float("inf"))),
            pose_var=pv,
            n_contacts=n_contacts,
            cp_zdiff=torch.zeros((n, num_seg), dtype=dtype, device=d1.device),
            cp_zvar=torch.full((n, num_seg), float("inf"), dtype=dtype,
                               device=d1.device),
            cp_ok=torch.zeros((n, num_seg), dtype=torch.bool,
                              device=d1.device),
        )

    # unfolded branch: per-query lookup, log-space ratio, [N, C] layout
    found, mean, stdev = map_lookup_batch((wx.T, wy.T, wz.T))    # [N, C]
    zdiff = wz.T - mean
    pose_var = stdev * stdev
    zvar = pose_var + meas_var[:, None]
    ratio = contact_likelihood_ratio(
        zdiff, torch.sqrt(zvar), cfg.contact_likelihood_correction
    )
    contrib = active[None, :] & found
    ratio_m = torch.where(contrib, ratio, torch.zeros_like(ratio))
    miss = active[None, :] & ~found

    seg_sum = lambda x: x @ onehot                             # [N, S]
    rsum = seg_sum(ratio_m)
    zdiff_sum = seg_sum(ratio_m * zdiff)
    zvar_sum = seg_sum(ratio_m * zvar)
    pvar_sum = seg_sum(ratio_m * pose_var)
    group_valid = seg_sum(miss.to(dtype)) == 0
    seg_any = seg_sum(contrib.to(dtype)) > 0

    cp_ok = group_valid & seg_any & (rsum > 1e-9)
    safe_rsum = torch.where(cp_ok, rsum, torch.ones_like(rsum))
    cp_zdiff = torch.where(cp_ok, zdiff_sum / safe_rsum,
                           torch.zeros_like(rsum))
    cp_zvar = torch.where(cp_ok, zvar_sum / safe_rsum,
                          torch.full_like(rsum, float("inf")))
    m_pose_var = torch.where(cp_ok, pvar_sum / safe_rsum,
                             torch.zeros_like(rsum)).sum(-1)

    n_contacts = cp_ok.sum(-1).to(torch.int32)
    inv_var = torch.where(cp_ok, 1.0 / cp_zvar, torch.zeros_like(cp_zvar))
    d1 = (torch.where(cp_ok, cp_zdiff, torch.zeros_like(cp_zdiff))
          * inv_var).sum(-1)
    d2 = inv_var.sum(-1)
    pos = d2 > 0
    safe_d2 = torch.where(pos, d2, torch.ones_like(d2))
    delta = d1 / safe_d2
    odiff2 = torch.where(cp_ok, (cp_zdiff - delta[:, None]) ** 2 / cp_zvar,
                         torch.zeros_like(cp_zvar))
    log_pz = torch.zeros((n,), dtype=dtype, device=d1.device)
    if cfg.use_shape_update:
        log_pz = log_pz - 0.5 * odiff2.sum(-1)
    # without terrain probabilities every group's probability is 1, so
    # the slip term of use_slip_update adds log(1) = 0
    return ContactEvalResult(
        measurement_valid=n_contacts >= cfg.min_contacts,
        weight=torch.exp(log_pz),
        z_delta=-delta,
        z_var=torch.where(pos, 1.0 / safe_d2,
                          torch.full_like(d2, float("inf"))),
        pose_var=m_pose_var,
        n_contacts=n_contacts,
        cp_zdiff=cp_zdiff,
        cp_zvar=cp_zvar,
        cp_ok=cp_ok,
    )
