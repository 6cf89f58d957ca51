"""Particle-filter core: weight normalisation, ESS, resampling.

Port of ``slam_eslam_tpu.core.filter`` (the SIR template of
``ParticleFilter.hpp``).  Every resampler takes its uniforms as an
argument, so the same draws can be fed to the JAX package and to the
port; the ancestor search is ``torch.searchsorted`` on the cumulative
weights, which kernel S1 (``ops.ordered_scan``) sums in one fixed order,
so that the same weights give the same ancestors on every call and on
every rank of a mesh (``torch.cumsum`` of float32 on the card does not
repeat itself).
"""

from __future__ import annotations

import dataclasses

import torch

from slam_eslam_tpu_torch.ops.ordered_scan import ordered_scan


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
    cumsum = ordered_scan(weights)
    # guard against round-off: the last entry covers 1.0
    cumsum = torch.cat([cumsum[:-1], cumsum[-1:].clamp(min=1.0 + 1e-6)])
    idx = torch.searchsorted(cumsum, positions, right=False)
    return idx.clamp(0, n - 1)


def resample_stratified(weights, u, slots=None):
    """Stratified resampling (``ParticleFilter.hpp:85-108``): positions
    ``(k + u_k) / N`` for uniforms ``u [N]`` in [0, 1).  ``slots = (lo,
    hi)`` resolves the strata ``lo <= k < hi`` only (a rank's output slots
    on a mesh: the same positions, so the same ancestors)."""
    num = u.shape[0]
    k = torch.arange(num, dtype=weights.dtype, device=weights.device)
    pos = (k + u) / num
    return resample_from_positions(
        weights, pos if slots is None else pos[slots[0]:slots[1]])


def resample_systematic(weights, u, num_samples, slots=None):
    """Systematic resampling: one uniform offset ``u`` (0-d) shared by
    all strata; ``slots`` as for ``resample_stratified``."""
    k = torch.arange(num_samples, dtype=weights.dtype, device=weights.device)
    pos = (k + u) / num_samples
    return resample_from_positions(
        weights, pos if slots is None else pos[slots[0]:slots[1]])


def resample_multinomial(weights, u):
    """Multinomial resampling (``ParticleFilter.hpp:120-148``) from
    uniforms ``u [Q]``."""
    return resample_from_positions(weights, u)


def best_particle_index(weights):
    """Index of the largest weight, the first on ties
    (``ParticleFilter.hpp:160-173``); a 0-d int64 tensor on the weights'
    device."""
    return torch.argmax(weights)


def take(particles, idx, mesh=None):
    """Gather every per-particle field by index (the SoA analogue of
    copying ``Particle`` structs, ``ParticleFilter.hpp:104``).  On a mesh
    ``idx`` holds global particle ids for this rank's slots: every rank's
    particles, packed into one ``[n, F]`` int32 matrix (floats by their
    bits), are all-gathered once and the rows taken (the JAX package's
    default formulation of a sharded resample)."""
    fields = [f.name for f in dataclasses.fields(particles)]
    if mesh is None:
        return dataclasses.replace(particles, **{
            f: getattr(particles, f).index_select(0, idx) for f in fields})
    cols = []
    for f in fields:
        a = getattr(particles, f)
        cols.append(a.view(torch.int32) if a.dtype == torch.float32
                    else a.to(torch.int32))
    rows = mesh.all_gather(torch.stack(cols, dim=1)).index_select(0, idx)
    out = {}
    for i, f in enumerate(fields):
        like, col = getattr(particles, f), rows[:, i].contiguous()
        out[f] = (col.view(torch.float32) if like.dtype == torch.float32
                  else col.to(like.dtype))
    return dataclasses.replace(particles, **out)
