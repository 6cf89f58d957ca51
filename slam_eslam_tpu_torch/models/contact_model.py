"""Terrain-contact measurement model.

Port of ``slam_eslam_tpu.models.contact_model`` (``ContactModel.cpp:
117-361``): the likelihood of each particle pose given the robot's
contact candidates and an MLS map, in the ``"ratio"`` weighting of
``ContactModel`` or the ``"chitta"`` weighting of ``ChittaContactModel``,
optionally with per-point terrain/slip probabilities and the debug
contact points of ``log_debug``.  Groups are consecutive runs of contact
points (``BodyContactState.segments``); in the batch their reductions
are one-hot ``[C, S]`` sums over a contact state shared by every
particle.

``evaluate_pose_batch`` has the two branches of the JAX function: the
fold branch, where the lookup's ``fold`` (kernel K1 on a GPU) returns
per-particle statistics, and the unfolded branch, which evaluates the
likelihood ratio in log space per query through the lookup itself
(kernel K5 on a GPU for the shared grid).  ``evaluate_pose`` is one
particle with segment reductions: the in-package oracle of the batch.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from slam_eslam_tpu_torch.config import ContactModelConfig
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


def _segment_reduce(values, seg, num_seg, reduce, init):
    """``values [C]`` reduced into ``num_seg`` segments (``amin``/``amax``);
    empty segments hold ``init``."""
    out = torch.full((num_seg,), init, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce(0, seg.long(), values, reduce=reduce,
                              include_self=True)


def _segment_sum(values, seg, num_seg):
    out = torch.zeros((num_seg,), dtype=values.dtype, device=values.device)
    return out.index_add(0, seg.long(), values)


def lowest_point_per_group(state: BodyContactState):
    """Per-group lowest contact candidate (``ContactModel.cpp:48-92``).
    Returns ``(points [C, 3], mask [C], new_contact [C])``: ``mask``
    marks the z-lowest valid point of each group (the first on ties) and
    every valid ungrouped point; ``new_contact`` is 1 for the selected
    point of a group and 0 for its other points, and keeps the contact
    value of ungrouped points
    (``updateContactStateUsingLowestPointHeuristic``)."""
    seg, num_seg = state.segments()
    z = torch.where(state.valid, state.position[..., 2],
                    torch.full_like(state.position[..., 2], float("inf")))
    seg_min = _segment_reduce(z, seg, num_seg, "amin", float("inf"))
    is_min = (z == seg_min[seg.long()]) & state.valid
    idx = torch.arange(state.c, dtype=torch.int64, device=z.device)
    first_min = _segment_reduce(
        torch.where(is_min, idx, torch.full_like(idx, state.c)), seg,
        num_seg, "amin", state.c)
    is_lowest = idx == first_min[seg.long()]
    new_contact = torch.where(state.group_id >= 0,
                              is_lowest.to(state.contact.dtype),
                              state.contact)
    return state.position, is_lowest & state.valid, new_contact


@dataclasses.dataclass
class ContactEvalResult:
    """Per-particle output of ``evaluate_pose_batch`` (``getWeight``,
    ``getZDelta``, ``getZVar``, ``m_poseVar``; ``ContactModel.hpp:
    124-141``), the per-group environment contact points ``cp_*``
    (``eslam::ContactPoint``, ``PoseParticle.hpp:20-43``) and the
    per-point slip-debug payload ``sp_*`` (``eslam::SlipPoint``,
    ``:45-50``).  The fold branch keeps group data inside its kernel and
    returns the empty payload: ``cp_ok`` and ``sp_ok`` all False; the
    ``sp_*`` payload is filled only with terrain probabilities and debug
    points.  ``evaluate_pose`` gives one particle (no leading N)."""

    measurement_valid: torch.Tensor  # [N] bool — >= min_contacts groups
    weight: torch.Tensor             # [N] joint contact probability
    z_delta: torch.Tensor            # [N] proposed z correction
    z_var: torch.Tensor              # [N] variance of the correction
    pose_var: torch.Tensor           # [N] summed map variance
    n_contacts: torch.Tensor         # [N] int32 — valid contact groups
    cp_point: torch.Tensor           # [N, S, 3] group surface point
    cp_zdiff: torch.Tensor           # [N, S]
    cp_zvar: torch.Tensor            # [N, S]
    cp_prob: torch.Tensor            # [N, S] terrain/slip probability
    cp_ok: torch.Tensor              # [N, S] bool
    sp_point: torch.Tensor           # [N, C, 3] slip-point world position
    sp_prob: torch.Tensor            # [N, C] joint terrain probability
    sp_ok: torch.Tensor              # [N, C] bool


def contact_likelihood_ratio(z, sigma, correction):
    """pdf/cdf contact-vs-no-contact ratio (``ContactModel.cpp:104-115``)
    in log space, as ``jax.scipy.stats.norm``'s ``logpdf - logcdf``."""
    s = sigma * correction
    s2 = s * s
    logpdf = (torch.log(2.0 * math.pi * s2) + (z * z) / s2) / -2.0
    return torch.exp(logpdf - torch.special.log_ndtr(z / s))


def _resolve_terrain_prob(terrain_prob, group_id, color):
    """Normalise ``terrain_prob``: a callable of ``(group_id, patch
    color)`` may return the probabilities or ``(prob,
    has_classification)``; an array's mask defaults to the grouped
    points.  Returns ``(prob, has)`` or ``(None, None)``."""
    if callable(terrain_prob):
        out = terrain_prob(group_id, color)
        if isinstance(out, tuple):
            return out
        terrain_prob = out
    if terrain_prob is None:
        return None, None
    return terrain_prob, (group_id >= 0).expand(terrain_prob.shape)


def _evaluate_weight(cp_zdiff, cp_zvar, cp_prob, cp_ok, cfg):
    """Precision-weighted z-delta and joint probability
    (``ContactModel::evaluateWeight``, ``ContactModel.cpp:262-317``) over
    the last axis (groups).  Returns ``(weight, z_delta, z_var)``."""
    zero = torch.zeros_like(cp_zvar)
    inv_var = torch.where(cp_ok, 1.0 / cp_zvar, zero)
    d1 = (torch.where(cp_ok, cp_zdiff, zero) * inv_var).sum(-1)
    d2 = inv_var.sum(-1)
    pos = d2 > 0
    safe_d2 = torch.where(pos, d2, torch.ones_like(d2))
    delta = d1 / safe_d2
    log_pz = torch.zeros_like(d1)
    if cfg.use_shape_update:
        odiff2 = torch.where(
            cp_ok, (cp_zdiff - delta[..., None]) ** 2 / cp_zvar, zero)
        log_pz = log_pz - 0.5 * odiff2.sum(-1)
    if cfg.use_slip_update:
        log_pz = log_pz + torch.where(
            cp_ok, torch.log(cp_prob.clamp(min=1e-30)), zero).sum(-1)
    return (torch.exp(log_pz), -delta,
            torch.where(pos, 1.0 / safe_d2, torch.full_like(d2, math.inf)))


def evaluate_weight_chitta(cp_zdiff, cp_zvar, cp_ok, meas_var):
    """Literature-variant weighting (``ChittaContactModel::
    evaluateWeight``, ``ContactModel.cpp:342-361``) over the last axis:
    anchor at the minimum zdiff, sum squared residuals of the rest.
    Returns ``(weight, z_delta, z_var)``; ``z_delta`` is -inf where no
    group is valid, as in the reference."""
    inf = torch.full_like(cp_zdiff, math.inf)
    z_delta = -torch.where(cp_ok, cp_zdiff, inf).amin(-1)
    # the anchor contributes (zmin - zmin)^2 = 0, so summing over all
    # selected points matches the reference's skip-first loop
    z_t = torch.where(cp_ok, (cp_zdiff + z_delta[..., None]) ** 2,
                      torch.zeros_like(cp_zdiff)).sum(-1)
    meas_var = torch.as_tensor(meas_var, dtype=cp_zvar.dtype,
                               device=cp_zvar.device)
    return torch.exp(-z_t / (2.0 * meas_var)), z_delta, meas_var


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


def evaluate_pose(state: BodyContactState, rot, trans, meas_var, map_lookup,
                  cfg: ContactModelConfig, terrain_prob=None):
    """Contact likelihood of one particle pose (``ContactModel::
    evaluatePose`` + ``evaluateWeight``, ``ContactModel.cpp:117-317``):
    candidates to world ``R p + t - (0, 0, radius)``, ``map_lookup(points
    [C, 3]) -> (found, mean, stdev, color)``, per group the ratio-weighted
    averages (a group is invalid when an active member misses the map,
    ``:189-190``), then the weighting.  The group's debug point is its
    max-ratio member, as in the JAX package.  ``terrain_prob``: ``[C]``
    probabilities or a callable of ``(group_id, patch color)``."""
    if float(meas_var) == 0.0:
        raise ValueError("using a zero measurement variance leads to "
                         "singularities")
    c = state.c
    seg, num_seg = state.segments()
    seg_l = seg.long()
    dtype = state.position.dtype
    active = state.valid & ~(state.contact < CONTACT_THRESHOLD)

    offset = torch.tensor([0.0, 0.0, cfg.contact_point_radius], dtype=dtype,
                          device=state.position.device)
    world = state.position @ rot.T + trans - offset
    found, mean, stdev, color = map_lookup(world)

    zdiff = world[..., 2] - mean
    pose_var = stdev * stdev
    zvar = pose_var + meas_var
    ratio = contact_likelihood_ratio(zdiff, torch.sqrt(zvar),
                                     cfg.contact_likelihood_correction)
    contrib = active & found
    zero = torch.zeros_like(ratio)
    ratio = torch.where(contrib, ratio, zero)
    miss = active & ~found

    seg_sum = lambda v: _segment_sum(v, seg, num_seg)
    group_valid = seg_sum(miss.to(dtype)) == 0
    rsum = seg_sum(ratio)
    zdiff_sum = seg_sum(ratio * zdiff)
    zvar_sum = seg_sum(ratio * zvar)
    pvar_sum = seg_sum(ratio * pose_var)
    seg_any = seg_sum(contrib.to(dtype)) > 0

    cp_ok = group_valid & seg_any & (rsum > 1e-9)
    zero_s = torch.zeros_like(rsum)
    safe_rsum = torch.where(cp_ok, rsum, torch.ones_like(rsum))
    cp_zdiff = torch.where(cp_ok, zdiff_sum / safe_rsum, zero_s)
    cp_zvar = torch.where(cp_ok, zvar_sum / safe_rsum,
                          torch.full_like(rsum, math.inf))
    m_pose_var = torch.where(cp_ok, pvar_sum / safe_rsum, zero_s).sum()

    # representative (max-ratio, first on ties) surface point per group
    neg_ratio = torch.where(contrib, ratio, torch.full_like(ratio, -math.inf))
    seg_maxr = _segment_reduce(neg_ratio, seg, num_seg, "amax", -math.inf)
    idx = torch.arange(c, device=seg.device)
    is_rep = contrib & (neg_ratio == seg_maxr[seg_l])
    rep_idx = _segment_reduce(
        torch.where(is_rep, idx, torch.full_like(idx, c - 1)), seg, num_seg,
        "amin", c - 1)
    surface = torch.cat([world[:, :2], mean[:, None]], dim=-1)
    cp_point = surface[rep_idx]

    terrain_prob, sp_has = _resolve_terrain_prob(terrain_prob,
                                                 state.group_id, color)
    if terrain_prob is not None:
        logp = torch.where(contrib, torch.log(terrain_prob.clamp(min=1e-30)),
                           zero)
        cp_prob = torch.exp(seg_sum(logp))
        sp_point, sp_prob, sp_ok = world, terrain_prob, contrib & sp_has
    else:
        cp_prob = torch.ones_like(rsum)
        sp_point = torch.zeros_like(world)
        sp_prob = torch.ones_like(ratio)
        sp_ok = torch.zeros_like(contrib)

    if cfg.weighting == "chitta":
        weight, z_delta, z_var = evaluate_weight_chitta(cp_zdiff, cp_zvar,
                                                        cp_ok, meas_var)
    else:
        weight, z_delta, z_var = _evaluate_weight(cp_zdiff, cp_zvar, cp_prob,
                                                  cp_ok, cfg)
    n_contacts = cp_ok.sum().to(torch.int32)
    return ContactEvalResult(
        measurement_valid=n_contacts >= cfg.min_contacts, weight=weight,
        z_delta=z_delta, z_var=z_var, pose_var=m_pose_var,
        n_contacts=n_contacts, cp_point=cp_point, cp_zdiff=cp_zdiff,
        cp_zvar=cp_zvar, cp_prob=cp_prob, cp_ok=cp_ok, sp_point=sp_point,
        sp_prob=sp_prob, sp_ok=sp_ok)


def world_queries(state: BodyContactState, rot, trans, radius,
                  contact_major=True):
    """World coordinates ``R_i p_c + t_i - (0, 0, radius)`` as three
    tensors: ``[C, N]`` (contact rows, particle columns) or, with
    ``contact_major=False``, ``[N, C]``; the same float operations
    either way."""
    if contact_major:
        p = lambda j: state.position[:, j:j + 1]                  # [C, 1]
        r = lambda i, j: rot[:, i, j][None, :]                    # [1, N]
        t = lambda i: trans[:, i][None, :]
    else:
        p = lambda j: state.position[None, :, j]                  # [1, C]
        r = lambda i, j: rot[:, i, j:j + 1]                       # [N, 1]
        t = lambda i: trans[:, i:i + 1]

    def row(i):
        return r(i, 0) * p(0) + r(i, 1) * p(1) + r(i, 2) * p(2) + t(i)

    return row(0), row(1), row(2) - radius


def _const(value, shape, dtype, device):
    """A read-only tensor of ``shape`` filled with ``value`` (one element
    expanded)."""
    return torch.full((), value, dtype=dtype, device=device).expand(shape)


def _fold_result(out8, n, c, num_seg, cfg):
    """``ContactEvalResult`` from the fold's ``[8, N]`` rows, with the
    empty group and slip payloads."""
    d1, d2, sq, pv, ncf = out8[0], out8[1], out8[2], out8[3], out8[4]
    n_contacts = torch.round(ncf).to(torch.int32)
    pos = d2 > 0
    safe_d2 = torch.where(pos, d2, torch.ones_like(d2))
    delta = d1 / safe_d2
    # sum_i (zdiff_i - delta)^2 / zvar_i == sq - d1 * delta
    log_pz = (-0.5 * (sq - d1 * delta) if cfg.use_shape_update
              else torch.zeros_like(sq))
    const = lambda value, *shape, dtype=d1.dtype: _const(
        value, shape, dtype, d1.device)
    return ContactEvalResult(
        measurement_valid=n_contacts >= cfg.min_contacts,
        weight=torch.exp(log_pz), z_delta=-delta,
        z_var=torch.where(pos, 1.0 / safe_d2,
                          torch.full_like(d2, math.inf)),
        pose_var=pv, n_contacts=n_contacts,
        cp_point=const(0.0, n, num_seg, 3), cp_zdiff=const(0.0, n, num_seg),
        cp_zvar=const(math.inf, n, num_seg), cp_prob=const(1.0, n, num_seg),
        cp_ok=const(False, n, num_seg, dtype=torch.bool),
        sp_point=const(0.0, n, c, 3), sp_prob=const(1.0, n, c),
        sp_ok=const(False, n, c, dtype=torch.bool))


def evaluate_pose_batch(state: BodyContactState, rot, trans, meas_var,
                        map_lookup_batch, cfg: ContactModelConfig,
                        terrain_prob=None, with_debug_points=False):
    """Contact likelihood of N particle poses (``ContactModel::
    evaluatePose`` + ``evaluateWeight``), batched.

    ``rot [N, 3, 3]``, ``trans [N, 3]``, ``meas_var [N]``.
    ``map_lookup_batch`` with ``soa`` takes SoA queries ``(x, y, z)``,
    each ``[N, C]``, and returns ``(found, mean, stdev)``; without it,
    points ``[N, C, 3]`` and returns ``(found, mean, stdev, color)``.
    Its ``fold`` (``ops.contact_fold.contact_fold``, given the groups as
    int32 ids, which is what the kernel reads) is used unless Chitta
    weighting, terrain probabilities (``[C]``, ``[N, C]`` or a callable
    of ``(group_id, patch color)``) or the ``log_debug`` points
    (``with_debug_points``) need per-query data.
    """
    n, c = rot.shape[0], state.c
    seg, num_seg = state.segments()
    dtype = state.position.dtype
    active = state.valid & ~(state.contact < CONTACT_THRESHOLD)  # [C]
    radius = cfg.contact_point_radius

    fold_fn = getattr(map_lookup_batch, "fold", None)
    if (fold_fn is not None and cfg.fold_lookup and cfg.weighting != "chitta"
            and terrain_prob is None and not with_debug_points):
        out8 = fold_fn(
            world_queries(state, rot, trans, radius),
            active.to(dtype)[:, None], meas_var.to(dtype)[None, :],
            seg=seg, correction=cfg.contact_likelihood_correction,
        )
        return _fold_result(out8, n, c, num_seg, cfg)
    onehot = (seg[:, None] == torch.arange(num_seg, dtype=seg.dtype,
                                           device=seg.device)[None, :]
              ).to(dtype)                                      # [C, S]

    # unfolded branch: per-query lookup, log-space ratio, [N, C] layout
    wx, wy, wz = world_queries(state, rot, trans, radius,
                               contact_major=False)
    world = None                                               # [N, C, 3]
    if getattr(map_lookup_batch, "soa", False):
        found, mean, stdev = map_lookup_batch((wx, wy, wz))
        color = None  # SoA lookups carry no colour
    else:
        world = torch.stack([wx, wy, wz], dim=-1)
        found, mean, stdev, color = map_lookup_batch(world)
    zdiff = wz - mean
    pose_var = stdev * stdev
    zvar = pose_var + meas_var[:, None]
    ratio = contact_likelihood_ratio(zdiff, torch.sqrt(zvar),
                                     cfg.contact_likelihood_correction)
    contrib = active[None, :] & found
    zero = torch.zeros_like(ratio)
    ratio_m = torch.where(contrib, ratio, zero)
    miss = active[None, :] & ~found

    seg_sum = lambda x: x @ onehot                             # [N, S]
    rsum = seg_sum(ratio_m)
    zdiff_sum = seg_sum(ratio_m * zdiff)
    zvar_sum = seg_sum(ratio_m * zvar)
    pvar_sum = seg_sum(ratio_m * pose_var)
    group_valid = seg_sum(miss.to(dtype)) == 0
    seg_any = seg_sum(contrib.to(dtype)) > 0

    cp_ok = group_valid & seg_any & (rsum > 1e-9)
    zero_s = torch.zeros_like(rsum)
    safe_rsum = torch.where(cp_ok, rsum, torch.ones_like(rsum))
    cp_zdiff = torch.where(cp_ok, zdiff_sum / safe_rsum, zero_s)
    cp_zvar = torch.where(cp_ok, zvar_sum / safe_rsum,
                          torch.full_like(rsum, math.inf))
    m_pose_var = torch.where(cp_ok, pvar_sum / safe_rsum, zero_s).sum(-1)

    if with_debug_points:
        # the max-ratio member of each group (first on ties): an
        # [N, C, S] argmax, paid only for the log_debug payload
        big = torch.where(contrib, ratio, torch.full_like(ratio, -math.inf))
        per_seg = torch.where(onehot.bool()[None], big[..., None],
                              torch.full_like(big[..., None], -math.inf))
        rep_idx = torch.argmax(per_seg, dim=1)                 # [N, S]
        surface = torch.stack([wx, wy, mean], dim=-1)          # [N, C, 3]
        cp_point = torch.gather(
            surface, 1, rep_idx[..., None].expand(n, num_seg, 3))
    else:
        cp_point = _const(0.0, (n, num_seg, 3), dtype, wx.device)

    terrain_prob, sp_has = _resolve_terrain_prob(terrain_prob,
                                                 state.group_id, color)
    if terrain_prob is not None:
        logp = torch.where(contrib, torch.log(terrain_prob.clamp(min=1e-30)),
                           zero)
        cp_prob = torch.exp(seg_sum(logp))
    else:
        cp_prob = torch.ones_like(rsum)
    if terrain_prob is not None and with_debug_points:
        # slip-point debug payload (SlipPoint, ContactModel.cpp:248-254)
        sp_point = (world if world is not None
                    else torch.stack([wx, wy, wz], dim=-1))
        sp_prob = terrain_prob.expand(n, c)
        sp_ok = contrib & sp_has
    else:
        sp_point = _const(0.0, (n, c, 3), dtype, wx.device)
        sp_prob = _const(1.0, (n, c), dtype, wx.device)
        sp_ok = _const(False, (n, c), torch.bool, wx.device)

    n_contacts = cp_ok.sum(-1).to(torch.int32)
    if cfg.weighting == "chitta":
        # batched ChittaContactModel::evaluateWeight: a particle without
        # a valid group gets z_delta 0, not -inf
        weight, z_delta, z_var = evaluate_weight_chitta(cp_zdiff, cp_zvar,
                                                        cp_ok, meas_var)
        z_delta = torch.where(cp_ok.any(-1), z_delta,
                              torch.zeros_like(z_delta))
    else:
        weight, z_delta, z_var = _evaluate_weight(cp_zdiff, cp_zvar, cp_prob,
                                                  cp_ok, cfg)
    return ContactEvalResult(
        measurement_valid=n_contacts >= cfg.min_contacts, weight=weight,
        z_delta=z_delta, z_var=z_var, pose_var=m_pose_var,
        n_contacts=n_contacts, cp_point=cp_point, cp_zdiff=cp_zdiff,
        cp_zvar=cp_zvar, cp_prob=cp_prob, cp_ok=cp_ok, sp_point=sp_point,
        sp_prob=sp_prob, sp_ok=sp_ok)
