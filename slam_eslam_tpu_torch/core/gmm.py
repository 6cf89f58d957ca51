"""Weighted 2-D Gaussian-mixture fitting (EM).

Port of ``slam_eslam_tpu.core.gmm`` (envire's ``GaussianMixture`` for
the exported pose distribution, ``PoseParticle.hpp:88-114``): a fixed
component count and a fixed number of EM iterations.  The 2x2 inverse
and determinant are closed forms, the same float operations on the CPU
and a GPU.
"""

from __future__ import annotations

import math

import torch

from slam_eslam_tpu_torch.ops.ordered_scan import ordered_scan


def _inv_det(cov):
    """Closed-form inverse and determinant of ``[K, 2, 2]`` matrices."""
    a, b = cov[:, 0, 0], cov[:, 0, 1]
    c, d = cov[:, 1, 0], cov[:, 1, 1]
    det = a * d - b * c
    inv = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)],
                      -2) / det[:, None, None]
    return inv, det


def _log_resp(xy, means, covs, mix):
    """Normalised log responsibilities ``[K, N]``."""
    inv, det = _inv_det(covs)
    diff = xy[None, :, :] - means[:, None, :]                  # [K, N, 2]
    maha = torch.einsum("kni,kij,knj->kn", diff, inv, diff)
    logdet = torch.log(det.clamp(min=1e-30))
    logp = (-0.5 * (maha + logdet[:, None] + 2.0 * math.log(2.0 * math.pi))
            + torch.log(mix.clamp(min=1e-30))[:, None])
    return logp - torch.logsumexp(logp, dim=0, keepdim=True)


def fit_gmm(xy, weights, n_components=3, n_iters=25, min_var=1e-6,
            first=None, generator=None):
    """Weighted EM fit of ``n_components`` Gaussians to points ``xy [N,
    2]``.  ``first`` is the index of the first initial mean, drawn with
    probability ``weights`` (``jax.random.choice(key, n, p=w)`` in the
    JAX package); drawn from ``generator`` on the device when not given.
    Returns ``(means [K, 2], covs [K, 2, 2], mix [K], resp [N, K])``."""
    n = xy.shape[0]
    dev, dtype = xy.device, xy.dtype
    w = weights / weights.sum().clamp(min=1e-30)
    if first is None:
        u = torch.rand((1,), generator=generator, device=dev, dtype=dtype)
        first = torch.searchsorted(ordered_scan(w), u).clamp(max=n - 1)
    first = torch.as_tensor(first, device=dev).reshape(1).long()

    # init: farthest-point (k-means++-style) means, so every seed does
    # not fall into one mode; covariances a fraction of the global spread
    means = xy.index_select(0, first).expand(n_components, 2).clone()
    chosen = torch.arange(n_components, device=dev)
    for k in range(1, n_components):
        d2 = ((xy[:, None, :] - means[None, :, :]) ** 2).sum(-1)  # [N, K]
        d2 = torch.where(chosen[None, :] < k, d2,
                         torch.full_like(d2, math.inf))
        nxt = torch.argmax(w * d2.amin(dim=1)).reshape(1)
        means[k] = xy.index_select(0, nxt)[0]
    mu = (xy * w[:, None]).sum(0)
    d = xy - mu
    eye = torch.eye(2, dtype=dtype, device=dev)
    glob_cov = torch.einsum("n,ni,nj->ij", w, d, d) + eye * min_var
    covs = (glob_cov / n_components ** 2).expand(n_components, 2, 2)
    mix = torch.full((n_components,), 1.0 / n_components, dtype=dtype,
                     device=dev)

    for _ in range(n_iters):
        resp = torch.exp(_log_resp(xy, means, covs, mix)) * w[None, :]
        nk = resp.sum(1)
        safe_nk = nk.clamp(min=1e-30)
        means = (resp @ xy) / safe_nk[:, None]
        diff = xy[None, :, :] - means[:, None, :]
        covs = (torch.einsum("kn,kni,knj->kij", resp, diff, diff)
                / safe_nk[:, None, None] + eye * min_var)
        mix = nk / nk.sum().clamp(min=1e-30)
    return means, covs, mix, torch.exp(_log_resp(xy, means, covs, mix)).T
