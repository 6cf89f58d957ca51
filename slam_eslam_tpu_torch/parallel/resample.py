"""Distributed systematic and stratified resampling over a mesh.

Port of ``slam_eslam_tpu.parallel.resample``.  The reference resamples
with a sequential walk on one core (``ParticleFilter.hpp:85-108``).
Over a ``('dp',)`` mesh (``parallel.sharding.Mesh``) the same statistics
come from:

1. the global normaliser and ESS (an ``all_reduce`` of the ranks' sums,
   or the all-gathered weights summed in the single process's order);
2. the same uniforms on every rank: a scalar offset (systematic) or the
   global ``[N]`` uniforms, of which a rank uses its own slots
   (stratified) -- the port's counterpart of every shard drawing from
   one key;
3. the all-gathered ``[N]`` weights, scanned in one fixed order (kernel
   S1, ``ops.ordered_scan``), so that every rank finds the same global
   ancestor for each of its output slots;
4. the payload moved by an index gather of all-gathered rows
   (``core.filter.take``) or by ring hops (``resample_ppermute``).

Every function takes this rank's weights and returns this rank's slots:
``(idx, ess)`` with ``idx`` the global ancestor of each slot.  ``key``
of the JAX functions becomes ``u``: the uniforms themselves.
"""

from __future__ import annotations

import dataclasses

import torch

from slam_eslam_tpu_torch.core import filter as pf
from slam_eslam_tpu_torch.ops.ordered_scan import ordered_scan


def resample_sharded(u, weights, mesh):
    """The gather formulation: this rank's weights all-gathered, then the
    math of ``core.filter.resample_systematic`` on the global vector, for
    this rank's slots.  ``u``: the scalar offset."""
    n = weights.shape[0] * mesh.size
    w, ess = pf.normalize_weights(mesh.all_gather(weights))
    return pf.resample_systematic(w, u, n, mesh.bounds(n)), ess


def _normalise(weights, mesh):
    """Global normalisation by ``all_reduce`` (a degenerate total resets
    to uniform 1/N, ``ParticleFilter.hpp:51-59``) and the ESS."""
    n = weights.shape[0] * mesh.size
    total = mesh.all_reduce(weights.sum())
    ok = (total > 0) & torch.isfinite(total)
    w_n = torch.where(ok, weights / torch.where(ok, total, 1.0),
                      torch.full_like(weights, 1.0 / n))
    ess = 1.0 / mesh.all_reduce((w_n * w_n).sum())
    return w_n, ess


def resample_shard_map(u, weights, mesh):
    """The explicit formulation (JAX ``resample_shard_map``): normaliser
    and ESS by ``all_reduce``, the normalised weights all-gathered and
    scanned (S1), this rank's systematic positions searched."""
    n = weights.shape[0] * mesh.size
    w_n, ess = _normalise(weights, mesh)
    cumsum = ordered_scan(mesh.all_gather(w_n))
    cumsum = torch.cat([cumsum[:-1], cumsum[-1:].clamp(min=1.0 + 1e-6)])
    lo, hi = mesh.bounds(n)
    k = torch.arange(lo, hi, dtype=w_n.dtype, device=w_n.device)
    idx = torch.searchsorted(cumsum, (k + u) / n, right=False)
    return idx.clamp(0, n - 1), ess


def make_ppermute_resampler(mesh, scheme="stratified"):
    """Adapter for ``filter.pose_estimator.update(resampler=...)``:
    ``(u, weights, particles) -> (particles, idx_global)`` through the
    ring-hop exchange of ``resample_ppermute``; ``scheme='stratified'``
    is the reference's (``u`` the global ``[N]`` uniforms)."""

    def resampler(u, weights, particles):
        out, idxg, _ = resample_ppermute(u, weights, particles, mesh,
                                         scheme=scheme)
        return out, idxg

    return resampler


def _flatten(payload):
    """``(tensors, rebuild)`` of a dict or dataclass of tensors."""
    if isinstance(payload, dict):
        keys = list(payload)
        return [payload[k] for k in keys], lambda ts: dict(zip(keys, ts))
    names = [f.name for f in dataclasses.fields(payload)]
    return ([getattr(payload, f) for f in names],
            lambda ts: dataclasses.replace(payload, **dict(zip(names, ts))))


def resample_ppermute(u, weights, payload, mesh, scheme="systematic"):
    """Distributed resample that moves the payload by ring hops instead
    of gathering it (JAX ``resample_ppermute``).

    Systematic and stratified positions are sorted, so each rank's output
    slots draw from a contiguous run of source ranks: 0 or 1 hops away
    while tracking, ``P - 1`` only when the weight collapses onto one
    rank.  So:

    1. normaliser and ESS by ``all_reduce``; the ``P`` rank sums
       all-gathered give every rank the global rank boundaries;
    2. each slot's source rank (a search of the ``P`` boundaries) and
       position;
    3. ``ceil((P - 1) / 2)`` rounds in which every rank passes its
       carried (payload, local cumsum) one rank on in both directions
       (``Mesh.ring``) and resolves the slots whose source it now holds:
       the rounds reach every rank in one direction or the other, and a
       round that finds no slot of its source changes nothing
       (``resolve`` is masked by the source).  The JAX package runs a
       ``while_loop`` to the largest distance (a ``pmax``); a fixed count
       reads nothing back, so the step can be captured into a CUDA graph.

    Traffic per rank: ``2 ceil((P - 1) / 2)`` payload slices, against
    ``P - 1`` for the gather.  ``u``: a scalar (``"systematic"``) or the
    global ``[N]`` uniforms (``"stratified"``).  ``payload``: a dict or
    dataclass of this rank's ``[N/P, ...]`` tensors.  Returns
    ``(payload_out, idx_global, ess)``; the move equals an index gather by
    ``idx_global``."""
    if scheme not in ("systematic", "stratified"):
        raise ValueError(f"unknown scheme {scheme!r}")
    p, d = mesh.size, mesh.rank
    nl = weights.shape[0]
    n = nl * p
    w_n, ess = _normalise(weights, mesh)

    # rank boundaries over the unit interval; the lower bounds from the
    # raw sums (JAX resample.py:145-152)
    sums = mesh.all_gather(w_n.sum()[None])
    cums = ordered_scan(sums)
    offsets = cums - sums
    bounds = torch.cat([cums[:-1], cums[-1:].clamp(min=1.0 + 1e-6)])

    lo, hi = mesh.bounds(n)
    kk = torch.arange(lo, hi, dtype=w_n.dtype, device=w_n.device)
    u = torch.as_tensor(u, dtype=w_n.dtype, device=w_n.device)
    uk = u if u.dim() == 0 else u[lo:hi]
    pos = (kk + uk) / n
    src = torch.searchsorted(bounds, pos, right=True).clamp(0, p - 1)

    cum = ordered_scan(w_n)
    leaves, rebuild = _flatten(payload)

    def resolve(source, cum_s, leaves_s, out, idxg):
        """Fill the slots whose source is rank ``source`` from its
        (cumsum, payload)."""
        il = torch.searchsorted(offsets[source] + cum_s, pos,
                                right=False).clamp(0, nl - 1)
        mask = src == source
        out = [torch.where(mask.reshape((nl,) + (1,) * (o.dim() - 1)),
                           a.index_select(0, il), o)
               for a, o in zip(leaves_s, out)]
        return out, torch.where(mask, source * nl + il, idxg)

    idxg = torch.full((nl,), -1, dtype=torch.int64, device=w_n.device)
    out, idxg = resolve(d, cum, leaves, list(leaves), idxg)
    fwd = bwd = [cum] + leaves
    # p // 2 == ceil((p - 1) / 2); at an even p the last round meets the
    # opposite rank both ways and writes the same rows twice
    for h in range(1, p // 2 + 1):
        fwd = mesh.ring(fwd, 1)     # now holds rank d + h's
        bwd = mesh.ring(bwd, -1)    # now holds rank d - h's
        out, idxg = resolve((d + h) % p, fwd[0], fwd[1:], out, idxg)
        out, idxg = resolve((d - h) % p, bwd[0], bwd[1:], out, idxg)
    return rebuild(out), idxg, ess
