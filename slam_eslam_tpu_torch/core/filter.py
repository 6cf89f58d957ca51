"""Particle-filter core: weight normalisation, ESS, resampling.

Port of ``slam_eslam_tpu.core.filter`` (the SIR template of
``ParticleFilter.hpp``).  Every resampler takes its uniforms as an
argument, so the same draws can be fed to the JAX package and to the
port; the ancestor search is ``torch.searchsorted`` on the cumulative
weights.
"""

from __future__ import annotations

import dataclasses

import torch


def weights_sum(weights):
    """Total weight (``ParticleFilter.hpp:34-39``)."""
    return weights.sum()


def weights_avg(weights):
    """Mean weight (``ParticleFilter.hpp:41-44``)."""
    return weights.mean()


def normalize_weights(weights):
    """Normalise; return ``(normalized, ess)`` (``ParticleFilter.hpp:
    46-70``).  A total weight that is <= 0 or non-finite resets every
    particle to uniform 1/N.  ``ess = 1 / sum(w^2)``."""
    n = weights.shape[0]
    total = weights.sum()
    uniform = torch.full_like(weights, 1.0 / n)
    ok = (total > 0.0) & torch.isfinite(total)
    normalized = torch.where(
        ok, weights / torch.where(ok, total, torch.ones_like(total)), uniform
    )
    ess = 1.0 / (normalized * normalized).sum()
    return normalized, ess


def effective_sample_size(weights):
    return normalize_weights(weights)[1]


def resample_from_positions(weights, positions):
    """Map positions in [0, 1) to particle indices: ``idx[k]`` is the
    first particle whose cumulative weight reaches ``positions[k]``
    (the reference's walk ``while (sum_w < sum_r) ++idx``,
    ``ParticleFilter.hpp:96-105``).  Returns int64 ``[Q]``."""
    n = weights.shape[0]
    cumsum = torch.cumsum(weights, 0)
    # guard against round-off: the last entry covers 1.0
    cumsum = torch.cat([cumsum[:-1], cumsum[-1:].clamp(min=1.0 + 1e-6)])
    idx = torch.searchsorted(cumsum, positions, right=False)
    return idx.clamp(0, n - 1)


def resample_stratified(weights, u):
    """Stratified resampling (``ParticleFilter.hpp:85-108``): positions
    ``(k + u_k) / N`` for uniforms ``u [N]`` in [0, 1)."""
    num = u.shape[0]
    k = torch.arange(num, dtype=weights.dtype, device=weights.device)
    return resample_from_positions(weights, (k + u) / num)


def resample_systematic(weights, u, num_samples):
    """Systematic resampling: one uniform offset ``u`` (0-d) shared by
    all strata."""
    k = torch.arange(num_samples, dtype=weights.dtype, device=weights.device)
    return resample_from_positions(weights, (k + u) / num_samples)


def resample_multinomial(weights, u):
    """Multinomial resampling (``ParticleFilter.hpp:120-148``) from
    uniforms ``u [Q]``."""
    return resample_from_positions(weights, u)


def best_particle_index(weights):
    """Index of the largest weight, the first on ties
    (``ParticleFilter.hpp:160-173``); a 0-d int64 tensor on the weights'
    device."""
    return torch.argmax(weights)


def take(particles, idx):
    """Gather every per-particle field by index (the SoA analogue of
    copying ``Particle`` structs, ``ParticleFilter.hpp:104``)."""
    return dataclasses.replace(
        particles,
        **{f.name: getattr(particles, f.name).index_select(0, idx)
           for f in dataclasses.fields(particles)},
    )
