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

On a device mesh (``mesh=``, ``parallel.sharding``) the state holds this
rank's particles and every draw is the global ``[N]`` one, sliced: every
rank draws the same numbers, so a meshed run fed the same draws equals
the single-process run.  Every reduction over the particle axis crosses
the mesh: the weights are all-gathered and normalised in the single
process's order (so is the ESS), the discount is computed over the
all-gathered measurement terms, the resample gathers the payload by global
ancestor index (``core.filter.take``) and the centroid sums its
all-gathered weighted terms in the single process's order.
"""

from __future__ import annotations

import dataclasses

import torch

from slam_eslam_tpu_torch.config import Config
from slam_eslam_tpu_torch.core import filter as pf
from slam_eslam_tpu_torch.core.state import BodyContactState, ParticleSet
from slam_eslam_tpu_torch.models import contact_model as cm
from slam_eslam_tpu_torch.models import odometry as odom
from slam_eslam_tpu_torch.utils import geometry, tracing, tree
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

    def local(self, mesh):
        """This rank's slice of global draws (the draws themselves without
        a mesh)."""
        if mesh is None:
            return self
        return dataclasses.replace(self, **{
            f.name: mesh.local(getattr(self, f.name))
            for f in dataclasses.fields(self)})


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


def global_count(particles, mesh=None):
    """The particle count over every rank of ``mesh``."""
    return particles.n * (1 if mesh is None else mesh.size)


def project(state: PoseEstimatorState, orientation, cfg: Config,
            draws: ProjectDraws | None = None, use_hash=False, mesh=None):
    """Propagate particles with a sampled odometry delta
    (``PoseEstimator::project``, ``PoseEstimator.cpp:184-242``): noisy
    2-D delta, y-slip with probability ``slip_factor``, x0.7 weight
    outside ``max_yaw_deviation`` of the IMU heading, z propagation and,
    when no surface hash is in use (``use_hash``), recovery spreading
    when the max weight collapsed.  The draws of the spreading are taken
    either way.  On a mesh ``draws`` are the global ones (drawn globally
    when not given) and this rank takes its slice."""
    with tracing.stage("project", state.particles.x.device):
        p = state.particles
        if draws is None:
            draws = ProjectDraws.sample(global_count(p, mesh), state.generator,
                                        p.x.device)
        draws = draws.local(mesh)

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


def discount_terms(valid, meas, n_contacts, discount_factor, mesh=None):
    """The group-count discount (``PoseEstimator.cpp:329-345``) of this
    rank's particles from their measurement ``valid`` bits, weights
    ``meas`` and contact counts: ``(factor [n], total_points, max_meas)``,
    the last two over every rank.  On a mesh the inputs are all-gathered
    and each rank does the single process's arithmetic on the same [N]
    vectors, then keeps its slice: the CPU's vectorised ``pow`` rounds
    otherwise than its scalar one, so a pow over a slice may differ."""
    glob = (lambda t: t) if mesh is None else mesh.all_gather
    valid, meas, n_contacts = glob(valid), glob(meas), glob(n_contacts)
    n_cp = n_contacts.to(meas.dtype)
    data_particles = valid.sum()
    inv_cp = 1.0 / n_cp.clamp(min=1.0)
    sum_data_weights = torch.where(valid, meas ** inv_cp,
                                   torch.zeros_like(inv_cp)).sum()
    floating_weight = torch.where(
        data_particles > 0, sum_data_weights / data_particles.clamp(min=1),
        torch.ones_like(sum_data_weights),
    )
    mprob = torch.where(valid, meas, torch.ones_like(meas))
    factor = mprob * torch.pow(discount_factor * floating_weight, 4.0 - n_cp)
    total_points = torch.where(valid, n_contacts,
                               torch.zeros_like(n_contacts)).sum()
    max_meas = torch.where(valid, meas, torch.zeros_like(meas)).max()
    return (factor if mesh is None else mesh.local(factor)), total_points, \
        max_meas


def update_weights(state: PoseEstimatorState, contact_state: BodyContactState,
                   orientation, map_lookup, cfg: Config, terrain_prob=None,
                   mesh=None):
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
    with tracing.stage("weights", state.particles.x.device):
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

        factor, total_points, max_meas = discount_terms(
            valid, res.weight, res.n_contacts, cfg.discount_factor, mesh)
        weight = weight * factor

        max_weight = torch.where(total_points == 0,
                                 state.max_weight * cfg.discount_factor,
                                 max_meas)

        particles = dataclasses.replace(
            p, z=z, z_sigma=z_sigma, weight=weight, mprob=mprob,
            floating=~valid, n_contacts=res.n_contacts,
        )
        return dataclasses.replace(state, particles=particles,
                                   max_weight=max_weight), res


def update(state: PoseEstimatorState, contact_state: BodyContactState,
           orientation, map_lookup, cfg: Config, resample_u=None,
           terrain_prob=None, resampler=None, mesh=None):
    """Measurement update and ESS-gated stratified resampling
    (``PoseEstimator::update``, ``PoseEstimator.cpp:244-255``).

    ``resample_u [N]``: the stratum uniforms, drawn from
    ``state.generator`` when not given.  Resampling copies the
    normalised weights with the particles (``ParticleFilter.hpp:104``)
    and is a device-side select: ``idx = where(ess < min_effective,
    ancestors, arange)`` and one gather.  ``terrain_prob`` feeds the
    slip update.  ``resampler``: an override ``(u, weights, particles) ->
    (particles, idx)`` taking the uniforms, this rank's normalised weights
    and particles (``parallel.resample.make_ppermute_resampler``: ring hops
    in place of the gather); its result is selected by the same ESS gate.
    ``mesh``: the state holds this rank's particles, ``resample_u`` is the
    global ``[N]`` and ``aux["resample_idx"]`` the global ancestor of each
    of this rank's slots.  Returns ``(state, aux)``; ``aux["eval"]`` is
    the ``ContactEvalResult`` (the ``log_debug`` payload).
    """
    state, res = update_weights(state, contact_state, orientation,
                                map_lookup, cfg, terrain_prob, mesh=mesh)
    with tracing.stage("resample", state.particles.x.device):
        p = state.particles
        n = global_count(p, mesh)
        weight_all, ess = pf.normalize_weights(
            p.weight if mesh is None else mesh.all_gather(p.weight))
        weight = weight_all if mesh is None else mesh.local(weight_all)
        if resample_u is None:
            resample_u = torch.rand((n,), generator=state.generator,
                                    device=weight.device)
        do_resample = ess < cfg.min_effective
        lo, hi = (0, n) if mesh is None else mesh.bounds(n)
        ident = torch.arange(lo, hi, device=weight.device)
        p_norm = dataclasses.replace(p, weight=weight)
        if resampler is not None:
            moved, idx_r = resampler(resample_u, weight, p_norm)
            idx = torch.where(do_resample, idx_r.long(), ident)
            particles = tree.where(do_resample, moved, p_norm)
        else:
            slots = None if mesh is None else (lo, hi)
            idx = torch.where(
                do_resample,
                pf.resample_stratified(weight_all, resample_u, slots), ident)
            particles = pf.take(p_norm, idx, mesh)
        state = dataclasses.replace(state, particles=particles)
        return state, {"eval": res, "ess": ess, "resampled": do_resample,
                       "resample_idx": idx}


def centroid(particles: ParticleSet, orientation, wrap_safe=False,
             mesh=None):
    """Weighted-mean pose (``PoseEstimator::getCentroid``,
    ``PoseEstimator.cpp:354-383``): ``(position [3], quaternion [4])``
    with the quaternion ``R_z(mean_yaw) * removeYaw(orientation)``.
    ``wrap_safe`` takes the circular mean of yaw instead of the
    reference's plain weighted mean (``Config.wrap_safe_centroid``).  On a
    mesh the weights are normalised over every rank and the weighted terms
    all-gathered and summed in the single process's order: every rank
    gets the single process's centroid, bit for bit."""
    with tracing.stage("centroid", particles.x.device):
        if mesh is None:
            w, _ = pf.normalize_weights(particles.weight)
        else:
            w = mesh.local(pf.normalize_weights(
                mesh.all_gather(particles.weight))[0])
        terms = [particles.x * w, particles.y * w, particles.z * w]
        if wrap_safe:
            terms += [torch.sin(particles.yaw) * w,
                      torch.cos(particles.yaw) * w]
        else:
            terms.append(particles.yaw * w)
        if mesh is not None:
            terms = mesh.all_gather(torch.stack(terms, dim=1)).T.contiguous()
        sums = torch.stack([t.sum() for t in terms])
        cx, cy, z = sums[0], sums[1], sums[2]
        yaw = torch.atan2(sums[3], sums[4]) if wrap_safe else sums[3]
        q = geometry.quat_mul(geometry.quat_from_yaw(yaw),
                              geometry.remove_yaw(orientation))
        return torch.stack([cx, cy, z]), q
