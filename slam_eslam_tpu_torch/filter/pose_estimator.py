"""Pose estimator: the eslam SIR localisation filter.

Port of ``slam_eslam_tpu.filter.pose_estimator`` (``eslam::PoseEstimator``,
``PoseEstimator.{hpp,cpp}``): particles over (x, y, yaw, z, zSigma)
driven by sampled contact-odometry deltas, weighted by the contact model
against an MLS map, resampled on low ESS.

Randomness: JAX's threefry draws cannot be reproduced with torch's
generators, so every stochastic function takes its draws as tensors
(``ProjectDraws``, the resampling uniforms, the init normals).  When
they are not given, they are drawn from ``state.generator``, which
lives on the state's device.  Nothing in ``project``/``update`` reads
a device value back to the host, and the resampling gate is a
device-side select.
"""

from __future__ import annotations

import dataclasses

import torch

from slam_eslam_tpu_torch.config import Config
from slam_eslam_tpu_torch.core import filter as pf
from slam_eslam_tpu_torch.core.state import BodyContactState, ParticleSet
from slam_eslam_tpu_torch.models import contact_model as cm
from slam_eslam_tpu_torch.models import odometry as odom
from slam_eslam_tpu_torch.utils import geometry
from slam_eslam_tpu_torch.utils.device import entry_device


@dataclasses.dataclass
class PoseEstimatorState:
    particles: ParticleSet
    odometry: odom.FootContactOdometry
    max_weight: torch.Tensor  # [] float32 (PoseEstimator.hpp:154)
    step: torch.Tensor        # [] int32 — project-call counter
    generator: torch.Generator | None = None  # draws not given explicitly

    @staticmethod
    def create(cfg: Config, num_contact_points, device=None,
               generator=None):
        """Zeroed state on ``device``: the CUDA device unless given
        (``device="cpu"`` for the CPU; no CUDA device and no ``device``
        raises)."""
        device = entry_device(device)
        if generator is None:
            generator = torch.Generator(device).manual_seed(cfg.seed)
        return PoseEstimatorState(
            particles=ParticleSet.zeros(cfg.particle_count, device),
            odometry=odom.FootContactOdometry.create(num_contact_points,
                                                     device),
            max_weight=torch.zeros((), device=device),
            step=torch.zeros((), dtype=torch.int32, device=device),
            generator=generator,
        )


@dataclasses.dataclass
class ProjectDraws:
    """The random draws of one ``project`` call, all standard normal or
    U[0, 1)."""

    delta_xy: torch.Tensor   # [n, 2] normal — odometry delta noise
    delta_yaw: torch.Tensor  # [n] normal
    slip: torch.Tensor       # [n] uniform — slip event test
    shrink: torch.Tensor     # [n] uniform — slip shrink factor
    spread_xy: torch.Tensor  # [n, 2] normal — recovery spreading
    spread_yaw: torch.Tensor  # [n] normal

    @staticmethod
    def sample(n, generator, device=None):
        device = device or generator.device
        normal = lambda *s: torch.randn(s, generator=generator,
                                        device=device)
        uniform = lambda *s: torch.rand(s, generator=generator,
                                        device=device)
        return ProjectDraws(
            delta_xy=normal(n, 2), delta_yaw=normal(n),
            slip=uniform(n), shrink=uniform(n),
            spread_xy=normal(n, 2), spread_yaw=normal(n),
        )


def init_gaussian(n, mu_xy, mu_yaw, sigma_xy, sigma_yaw, zpos, zsigma, *,
                  normal_xy=None, normal_yaw=None, generator=None,
                  device=None):
    """Gaussian particle initialisation (``PoseEstimator.cpp:88-102``)
    with uniform weights.  ``normal_xy [n, 2]`` / ``normal_yaw [n]`` are
    the standard normals; drawn from ``generator`` when not given."""
    if normal_xy is None:
        device = device or generator.device
        normal_xy = torch.randn((n, 2), generator=generator, device=device)
        normal_yaw = torch.randn((n,), generator=generator, device=device)
    device = normal_xy.device
    f32 = dict(dtype=torch.float32, device=device)
    xy = torch.as_tensor(mu_xy, **f32) + normal_xy * torch.as_tensor(
        sigma_xy, **f32)
    yaw = torch.as_tensor(mu_yaw, **f32) + normal_yaw * torch.as_tensor(
        sigma_yaw, **f32)
    return dataclasses.replace(
        ParticleSet.zeros(n, device),
        x=xy[:, 0].contiguous(), y=xy[:, 1].contiguous(), yaw=yaw,
        z=torch.full((n,), zpos, **f32),
        z_sigma=torch.full((n,), zsigma, **f32),
    )


def weighting_function(x, alpha=0.1, beta=0.9, gamma=0.05):
    """Piecewise-linear recovery schedule (``PoseEstimator.cpp:104-128``)."""
    a = (1.0 - gamma) / (alpha - beta)
    b = 1.0 - alpha * a
    return torch.where(
        x < alpha, torch.ones_like(x),
        torch.where(x < beta, a * x + b, torch.full_like(x, gamma)),
    )


def project(state: PoseEstimatorState, orientation, cfg: Config,
            draws: ProjectDraws | None = None, use_hash=False):
    """Propagate particles with a sampled odometry delta
    (``PoseEstimator::project``, ``PoseEstimator.cpp:184-242``): noisy
    2-D delta, y-slip with probability ``slip_factor``, x0.7 weight
    outside ``max_yaw_deviation`` of the IMU heading, z propagation and,
    when no surface hash is in use (``use_hash``), recovery spreading
    when the max weight collapsed.  The draws of the spreading are taken
    either way."""
    p = state.particles
    if draws is None:
        draws = ProjectDraws.sample(p.n, state.generator, p.x.device)

    yaw_meas = geometry.yaw_from_quat(orientation)
    z_delta, z_var = odom.z_delta_and_var(state.odometry, orientation)
    dxy, dyaw = odom.pose_delta_samples_2d(state.odometry, draws.delta_xy,
                                           draws.delta_yaw)
    # slip model (PoseEstimator.cpp:199-202): with probability
    # slip_factor the longitudinal (y) component shrinks by U(0, 1)
    slip = draws.slip < cfg.slip_factor
    dx0 = dxy[:, 0]
    dy0 = dxy[:, 1] * torch.where(slip, draws.shrink,
                                  torch.ones_like(draws.shrink))

    c, s = torch.cos(p.yaw), torch.sin(p.yaw)
    x = p.x + c * dx0 - s * dy0
    y = p.y + s * dx0 + c * dy0
    yaw = p.yaw + dyaw

    weight = p.weight
    if cfg.max_yaw_deviation > 0.0:
        d = yaw - yaw_meas
        dev = torch.atan2(torch.sin(d), torch.cos(d))
        weight = torch.where(dev.abs() > cfg.max_yaw_deviation,
                             weight * 0.7, weight)

    z = p.z + z_delta
    z_sigma = torch.sqrt(p.z_sigma ** 2 + z_var)

    if not use_hash and cfg.spread_threshold > 0.0:
        # recovery spreading (PoseEstimator.cpp:224-236), scaled by how
        # far the max weight has collapsed
        spread = weighting_function(state.max_weight, 0.0,
                                    cfg.spread_threshold, 0.0)
        trans_fac = cfg.spread_translation_factor * spread
        rot_fac = cfg.spread_rotation_factor * spread
        noise = draws.spread_xy * trans_fac
        x = x + noise[:, 0]
        y = y + noise[:, 1]
        yaw = yaw + draws.spread_yaw * rot_fac

    particles = dataclasses.replace(
        p, x=x, y=y, yaw=yaw, z=z, z_sigma=z_sigma, weight=weight
    )
    return dataclasses.replace(state, particles=particles,
                               step=state.step + 1)


def bind_lookup(map_lookup, map_id):
    """Bind the per-particle ``map_id`` onto a lookup, forwarding its
    ``soa`` and ``fold`` capabilities."""
    bound = lambda pts: map_lookup(map_id, pts)
    bound.soa = getattr(map_lookup, "soa", False)
    fold = getattr(map_lookup, "fold", None)
    if fold is not None:
        bound.fold = fold
    return bound


def update_weights(state: PoseEstimatorState, contact_state: BodyContactState,
                   orientation, map_lookup, cfg: Config, terrain_prob=None):
    """Contact-likelihood weighting of all particles
    (``PoseEstimator::updateWeights``, ``PoseEstimator.cpp:257-352``).

    As in the reference, the measurement weight enters twice (directly,
    ``:300``, and through ``mprob`` in the discount pass, ``:329-345``);
    the group-count discount ``(discount * floating_weight)^(4 - #cp)``
    applies to every particle; ``max_weight`` decays by
    ``discount_factor`` when no particle saw a contact point.
    ``terrain_prob`` feeds the slip update (``evaluate_pose_batch``) and
    ``cfg.log_debug`` asks for the debug contact points, which take the
    unfolded lookup.  Returns ``(new_state, ContactEvalResult)``.
    """
    cstate = cm.set_contact_points(contact_state, orientation)
    p = state.particles
    rot, trans = p.pose_matrix()
    meas_var = p.z_sigma ** 2 + cfg.measurement_error ** 2
    res = cm.evaluate_pose_batch(
        cstate, rot, trans, meas_var, bind_lookup(map_lookup, p.map_id),
        cfg.contact_model, terrain_prob=terrain_prob,
        with_debug_points=cfg.log_debug,
    )
    valid = res.measurement_valid

    # Kalman z update for particles with a valid measurement
    # (PoseEstimator.cpp:293-296)
    _, new_z, new_zvar = cm.update_z_position_estimate(res, p.z,
                                                       p.z_sigma ** 2)
    z = torch.where(valid, new_z, p.z)
    z_sigma = torch.where(valid, torch.sqrt(new_zvar), p.z_sigma)

    weight = torch.where(valid, p.weight * res.weight, p.weight)
    mprob = torch.where(valid, res.weight, torch.ones_like(res.weight))
    n_cp = res.n_contacts.to(weight.dtype)

    data_particles = valid.sum()
    inv_cp = 1.0 / n_cp.clamp(min=1.0)
    sum_data_weights = torch.where(valid, res.weight ** inv_cp,
                                   torch.zeros_like(inv_cp)).sum()
    floating_weight = torch.where(
        data_particles > 0, sum_data_weights / data_particles.clamp(min=1),
        torch.ones_like(sum_data_weights),
    )

    # group-count discount pass (PoseEstimator.cpp:329-345)
    factor = mprob * torch.pow(cfg.discount_factor * floating_weight,
                               4.0 - n_cp)
    weight = weight * factor

    total_points = torch.where(valid, res.n_contacts,
                               torch.zeros_like(res.n_contacts)).sum()
    max_meas = torch.where(valid, res.weight,
                           torch.zeros_like(res.weight)).max()
    max_weight = torch.where(total_points == 0,
                             state.max_weight * cfg.discount_factor, max_meas)

    particles = dataclasses.replace(
        p, z=z, z_sigma=z_sigma, weight=weight, mprob=mprob,
        floating=~valid, n_contacts=res.n_contacts,
    )
    return dataclasses.replace(state, particles=particles,
                               max_weight=max_weight), res


def update(state: PoseEstimatorState, contact_state: BodyContactState,
           orientation, map_lookup, cfg: Config, resample_u=None,
           terrain_prob=None):
    """Measurement update and ESS-gated stratified resampling
    (``PoseEstimator::update``, ``PoseEstimator.cpp:244-255``).

    ``resample_u [N]``: the stratum uniforms, drawn from
    ``state.generator`` when not given.  Resampling copies the
    normalised weights with the particles (``ParticleFilter.hpp:104``)
    and is a device-side select: ``idx = where(ess < min_effective,
    ancestors, arange)`` and one gather.  ``terrain_prob`` feeds the
    slip update.  Returns ``(state, aux)``; ``aux["eval"]`` is the
    ``ContactEvalResult`` (the ``log_debug`` payload).
    """
    state, res = update_weights(state, contact_state, orientation,
                                map_lookup, cfg, terrain_prob)
    p = state.particles
    weight, ess = pf.normalize_weights(p.weight)
    if resample_u is None:
        resample_u = torch.rand((p.n,), generator=state.generator,
                                device=weight.device)
    do_resample = ess < cfg.min_effective
    idx = torch.where(
        do_resample, pf.resample_stratified(weight, resample_u),
        torch.arange(p.n, device=weight.device),
    )
    particles = pf.take(dataclasses.replace(p, weight=weight), idx)
    state = dataclasses.replace(state, particles=particles)
    return state, {"eval": res, "ess": ess, "resampled": do_resample,
                   "resample_idx": idx}


def centroid(particles: ParticleSet, orientation, wrap_safe=False):
    """Weighted-mean pose (``PoseEstimator::getCentroid``,
    ``PoseEstimator.cpp:354-383``): ``(position [3], quaternion [4])``
    with the quaternion ``R_z(mean_yaw) * removeYaw(orientation)``.
    ``wrap_safe`` takes the circular mean of yaw instead of the
    reference's plain weighted mean (``Config.wrap_safe_centroid``)."""
    w, _ = pf.normalize_weights(particles.weight)
    cx = (particles.x * w).sum()
    cy = (particles.y * w).sum()
    if wrap_safe:
        yaw = torch.atan2((torch.sin(particles.yaw) * w).sum(),
                          (torch.cos(particles.yaw) * w).sum())
    else:
        yaw = (particles.yaw * w).sum()
    z = (particles.z * w).sum()
    q = geometry.quat_mul(geometry.quat_from_yaw(yaw),
                          geometry.remove_yaw(orientation))
    return torch.stack([cx, cy, z]), q
