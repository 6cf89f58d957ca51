"""Filter steps: the per-frame localisation path and a trajectory runner.

Port of ``slam_eslam_tpu.filter.step``: odometry update -> particle
propagation -> (gated) measurement update, the main path of
``EmbodiedSlamFilter::update`` (``EmbodiedSlamFilter.cpp:353-369``).
The JAX ``lax.cond`` gate becomes a device-side ``torch.where`` over
the two states and ``lax.scan`` a Python loop; no step reads a device
value back to the host, so a step can be captured in a CUDA graph.

``mesh=`` (``parallel.sharding.make_mesh``) runs a step on this rank's
slice of the particles (``parallel.sharding.shard_state``) with the
global draws; the lookup's kernels (K1, or K5 under ``--fold off``) run
on the rank's own particles against the replicated grid, and the
reductions over particles cross the mesh (``filter.pose_estimator``).
The ring-hop ``resampler`` hook takes ``(u, weights, particles)``.
"""

from __future__ import annotations

import dataclasses

import torch

from slam_eslam_tpu_torch.config import Config, OdometryConfig
from slam_eslam_tpu_torch.filter import pose_estimator as pe
from slam_eslam_tpu_torch.models import odometry as odom
from slam_eslam_tpu_torch.utils import tree


@dataclasses.dataclass
class StepDraws:
    """The random draws of one step: ``project``'s, the resampling
    uniforms ``[N]`` and, where a surface hash reinjects, its in-bucket
    integer draws ``[N]`` (``SurfaceHash.sample_bucket``)."""

    project: pe.ProjectDraws
    resample_u: torch.Tensor
    hash_u: torch.Tensor | None = None


def cfg_odo(cfg: Config):
    return OdometryConfig(seed=cfg.seed)


def _propagate(state, contact_state, orientation, cfg, draws, mesh=None):
    new_odo = odom.update(state.odometry, contact_state, orientation,
                          cfg_odo(cfg))
    state = dataclasses.replace(state, odometry=new_odo)
    return pe.project(state, orientation, cfg,
                      None if draws is None else draws.project, mesh=mesh)


def make_filter_step(cfg: Config, map_lookup, mesh=None, resampler=None):
    """Build ``step(state, contact_state, orientation, gate_ref,
    draws=None) -> (state, aux)``.

    The measurement update runs when the accumulated motion
    ``gate_ref = (distance, angle)`` passes
    ``cfg.measurement_threshold`` (``EmbodiedSlamFilter.cpp:360``, with
    the intended distance/angle argument order).  Both outcomes are
    computed and selected on the device.  ``mesh``: the state is this
    rank's (``parallel.sharding.shard_state``) and ``draws`` the global
    ones.  ``resampler``: forwarded to ``pose_estimator.update`` (e.g.
    ``parallel.resample.make_ppermute_resampler(mesh)``).
    """

    def step(state, contact_state, orientation, gate_ref, draws=None):
        state = _propagate(state, contact_state, orientation, cfg, draws,
                           mesh)
        dist, angle = (torch.as_tensor(v, device=state.step.device)
                       for v in gate_ref)
        do_update = cfg.measurement_threshold.test(dist, angle)
        updated, aux = pe.update(
            state, contact_state, orientation, map_lookup, cfg,
            None if draws is None else draws.resample_u,
            resampler=resampler, mesh=mesh,
        )
        state = tree.where(do_update, updated, state)
        ess = torch.where(do_update, aux["ess"],
                          torch.full_like(aux["ess"], float("inf")))
        return state, {"ess": ess, "updated": do_update}

    return step


def make_scan_runner(cfg: Config, map_lookup, mesh=None):
    """Roll a trajectory with a measurement update on every step (the
    benchmark regime).

    ``run(state, contact_states, orientations, draws=None)`` takes the
    per-step ``BodyContactState`` stacked along a leading time axis
    (``utils.tree.stack``), ``orientations [T, 4]`` and optionally a
    sequence of T ``StepDraws``.  Returns ``(final_state, centroids
    [T, 3])``.  ``mesh``: as for ``make_filter_step``; the centroids are
    global, the same on every rank.
    """

    def run(state, contact_states, orientations, draws=None):
        cents = []
        for t in range(orientations.shape[0]):
            cs = tree.index(contact_states, t)
            q = orientations[t]
            d = None if draws is None else draws[t]
            state = _propagate(state, cs, q, cfg, d, mesh)
            state, _ = pe.update(state, cs, q, map_lookup, cfg,
                                 None if d is None else d.resample_u,
                                 mesh=mesh)
            c_pos, _ = pe.centroid(state.particles, q,
                                   wrap_safe=cfg.wrap_safe_centroid,
                                   mesh=mesh)
            cents.append(c_pos)
        return state, torch.stack(cents)

    return run
