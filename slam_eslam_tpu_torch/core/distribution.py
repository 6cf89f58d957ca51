"""Exported pose distribution (the filter's observable state).

Port of ``slam_eslam_tpu.core.distribution`` (``eslam::PoseDistribution``,
``PoseParticle.hpp:88-114``): the particle cloud, a 2-D GMM summary,
the current orientation and the body contact state, plus the debug
contact points of the last measurement (``cpoints``, ``PoseParticle.hpp:
78-82``) when ``log_debug`` captured them.
"""

from __future__ import annotations

import dataclasses

import torch

from slam_eslam_tpu_torch.core import gmm as gmmlib
from slam_eslam_tpu_torch.core.state import BodyContactState, ParticleSet


@dataclasses.dataclass
class PoseDistribution:
    time: torch.Tensor          # [] float32 seconds
    particles: ParticleSet
    gmm_means: torch.Tensor     # [K, 2]
    gmm_covs: torch.Tensor      # [K, 2, 2]
    gmm_weights: torch.Tensor   # [K]
    orientation: torch.Tensor   # [4]
    body_state: BodyContactState
    # debug contact points per particle ([N, S, 3] + mask); zero-size
    # without an evaluation result
    cpoints: torch.Tensor
    cpoint_mask: torch.Tensor


def export_distribution(particles: ParticleSet, orientation,
                        body_state: BodyContactState, time=0.0,
                        n_components=3, eval_result=None, first=None,
                        generator=None):
    """Build the distribution; ``eval_result`` (a ``ContactEvalResult``)
    adds its ``cp_point``/``cp_ok`` as the debug contact points.
    ``first`` and ``generator``: the GMM's first initial mean
    (``gmm.fit_gmm``)."""
    means, covs, mix, _ = gmmlib.fit_gmm(
        particles.xy, particles.weight, n_components, first=first,
        generator=generator)
    dev = particles.x.device
    if eval_result is not None:
        cpoints, cmask = eval_result.cp_point, eval_result.cp_ok
    else:
        cpoints = torch.zeros((particles.n, 0, 3), device=dev)
        cmask = torch.zeros((particles.n, 0), dtype=torch.bool, device=dev)
    return PoseDistribution(
        time=torch.tensor(time, dtype=torch.float32),
        particles=particles, gmm_means=means, gmm_covs=covs,
        gmm_weights=mix,
        orientation=torch.as_tensor(orientation, dtype=torch.float32,
                                    device=dev),
        body_state=body_state, cpoints=cpoints, cpoint_mask=cmask)
