"""Terrain-signature hashing for global (re)localisation.

Port of ``slam_eslam_tpu.filter.surface_hash`` (``eslam::SurfaceHash`` +
``SurfaceParam`` + ``Buckets``, ``SurfaceHash.hpp``): for every map cell
and each of ``angular_steps`` headings, the least-squares plane slope of
a 4-point robot footprint; candidate poses bucketed by ``(slope_x,
slope_y)``; relocalisation candidates drawn from the bucket of the
robot's sensed footprint signature.  Buckets are a sort-by-bucket index
(``sorted_idx`` and per-bucket ``start``/``count``).

The plane fit is a closed-form 3x3 solve with sums taken point by point
in a fixed order, and the footprint offsets are rotated on the host, so
the CPU and a GPU compute the same bits.  Integer draws (the candidate
indices of ``sample_particles``, the in-bucket offsets of
``sample_bucket``) are optional tensors; otherwise they come from a
``torch.Generator`` as ``floor(U * count)`` on the device, so nothing
reads the device back to the host.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from slam_eslam_tpu_torch.config import Config, SurfaceHashConfig
from slam_eslam_tpu_torch.core import filter as pf
from slam_eslam_tpu_torch.core.state import ParticleSet
from slam_eslam_tpu_torch.mapping.mls_grid import MLSGrid
from slam_eslam_tpu_torch.models import contact_model as cm

# footprint base length in metres (SurfaceHash.hpp:162)
FOOT_BASE = 0.5
# body height added to candidate z (SurfaceHash.hpp:218)
BODY_HEIGHT = 0.18


def _point_sum(v):
    """Sum over the last axis, one point after the other."""
    out = v[..., 0]
    for i in range(1, v.shape[-1]):
        out = out + v[..., i]
    return out


def fit_plane(points, mask):
    """Masked least-squares plane ``z = a x + b y + c`` over the last
    point axis (``SurfaceParam::fromPoints``, ``SurfaceHash.hpp:60-110``):
    the normal equations regularised by 1e-6 I, solved in closed form
    (adjugate over determinant).  Degenerate fits (fewer than 3 points)
    give values the caller masks.  Returns ``(slope_x, slope_y)``."""
    w = mask.to(points.dtype)
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    sx, sy, sz = _point_sum(w * x), _point_sum(w * y), _point_sum(w * z)
    sxx, syy = _point_sum(w * x * x), _point_sum(w * y * y)
    sxy = _point_sum(w * x * y)
    sxz, syz = _point_sum(w * x * z), _point_sum(w * y * z)
    n = _point_sum(w)
    a, e, i = sxx + 1e-6, syy + 1e-6, n + 1e-6        # the diagonal
    b, c, f = sxy, sx, sy                             # symmetric: d=b, g=c, h=f
    # cofactors of the symmetric matrix [[a, b, c], [b, e, f], [c, f, i]]
    c00 = e * i - f * f
    c01 = c * f - b * i
    c02 = b * f - c * e
    c11 = a * i - c * c
    c12 = b * c - a * f
    det = a * c00 + b * c01 + c * c02
    slope_x = (c00 * sxz + c01 * syz + c02 * sz) / det
    slope_y = (c01 * sxz + c11 * syz + c12 * sz) / det
    return slope_x, slope_y


def _bucket_index(slope, bins):
    """Bucket of a slope in [-1, 1] (``Buckets::bucketIndex``,
    ``SurfaceHash.hpp:25-29``): truncation, then clipped."""
    idx = ((slope + 1.0) / 2.0 * bins).to(torch.int32)
    return idx.clamp(0, bins - 1)


def _footprint_offsets(steps):
    """``[A, 4, 2]`` float32 footprint offsets rotated by each heading
    (the reference rotates before the first use, ``SurfaceHash.hpp:
    182-184``), and the headings ``[A]``; computed on the host."""
    base = np.float32(FOOT_BASE)
    opoints = np.array([[base / 2, 0.0], [-base / 2, 0.0],
                        [base / 2, -base], [-base / 2, -base]], np.float32)
    angles = (np.arange(1, steps + 1, dtype=np.float32) * np.float32(2.0)
              * np.float32(math.pi) / np.float32(steps))
    c, s = np.cos(angles), np.sin(angles)
    offs = np.stack([opoints[None, :, 0] * c[:, None]
                     - opoints[None, :, 1] * s[:, None],
                     opoints[None, :, 0] * s[:, None]
                     + opoints[None, :, 1] * c[:, None]], -1)
    return (torch.from_numpy(opoints), torch.from_numpy(offs),
            torch.from_numpy(angles))


@dataclasses.dataclass
class SurfaceHash:
    cand_xy: torch.Tensor       # [M, 2]
    cand_yaw: torch.Tensor      # [M]
    cand_z: torch.Tensor        # [M]
    cand_valid: torch.Tensor    # [M] bool
    bucket_id: torch.Tensor     # [M] int32 (bx * bins + by; bins^2 invalid)
    sorted_idx: torch.Tensor    # [M] candidate ids sorted by bucket
    bucket_start: torch.Tensor  # [bins^2] int32
    bucket_count: torch.Tensor  # [bins^2] int32
    n_valid: torch.Tensor       # [] int32
    config: SurfaceHashConfig

    @staticmethod
    def create(config: SurfaceHashConfig, grid: MLSGrid):
        """Precompute the hash over an MLS grid (``SurfaceHash::create``,
        ``SurfaceHash.hpp:155-231``): the ``[angular_steps x nx*ny]``
        sweep of 4-point footprints on the grid's device."""
        bins, steps = config.slope_bins, config.angular_steps
        nx, ny = grid.nx, grid.ny
        dev = grid.mean.device
        opoints, offs, angles = (t.to(dev) for t in
                                 _footprint_offsets(steps))
        xs, ys = torch.meshgrid(torch.arange(nx, device=dev),
                                torch.arange(ny, device=dev), indexing="ij")
        centers = grid.from_grid(xs.reshape(-1), ys.reshape(-1))  # [P, 2]
        pts = centers[None, :, None, :] + offs[:, None, :, :]   # [A, P, 4, 2]
        ix, iy, inb = grid.to_grid(pts)
        zero = torch.zeros_like(ix)
        cix = torch.where(inb, ix, zero).long()
        ciy = torch.where(inb, iy, zero).long()
        # first stored patch per cell (MLSGrid::beginCell,
        # SurfaceHash.hpp:201-206)
        cell_valid = grid.valid[cix, ciy]                       # [A, P, 4, K]
        first = torch.argmax(cell_valid.to(torch.int8), dim=-1, keepdim=True)
        zval = torch.gather(grid.mean[cix, ciy], -1, first)[..., 0]
        found = inb & cell_valid.any(-1)                        # [A, P, 4]
        n_found = found.sum(-1)
        mean_z = (_point_sum(torch.where(found, zval, torch.zeros_like(zval)))
                  / n_found.clamp(min=1).to(zval.dtype))
        fit_pts = torch.cat([opoints.expand(pts.shape), zval[..., None]], -1)
        slope_x, slope_y = fit_plane(fit_pts, found)
        valid = (n_found >= 3).reshape(-1)
        bid = (_bucket_index(slope_x, bins) * bins
               + _bucket_index(slope_y, bins)).reshape(-1)
        bid = torch.where(valid, bid, torch.full_like(bid, bins * bins))
        order = torch.argsort(bid, stable=True).to(torch.int32)
        bid_sorted = bid.index_select(0, order.long())
        edges = torch.arange(bins * bins + 1, dtype=torch.int32, device=dev)
        bounds = torch.searchsorted(bid_sorted, edges).to(torch.int32)
        return SurfaceHash(
            cand_xy=centers.repeat(steps, 1),
            cand_yaw=angles.repeat_interleave(nx * ny),
            cand_z=(mean_z + BODY_HEIGHT).reshape(-1), cand_valid=valid,
            bucket_id=bid, sorted_idx=order, bucket_start=bounds[:-1],
            bucket_count=bounds[1:] - bounds[:-1],
            n_valid=valid.sum().to(torch.int32), config=config)

    def bucket(self, slope_x, slope_y):
        """The bucket of a signature as a ``[1]`` index: indexing with a
        0-d device tensor would read it back to the host."""
        bins = self.config.slope_bins
        return (_bucket_index(slope_x, bins) * bins
                + _bucket_index(slope_y, bins)).long().reshape(1)

    def _at_bucket(self, table, b):
        return table.index_select(0, b)[0]

    def signature(self, contact_state, orientation):
        """Footprint slope signature of the current contact state: the
        lowest point per wheel, plane-fitted (``PoseEstimator.cpp:
        136-143``)."""
        cstate = cm.set_contact_points(contact_state, orientation)
        pts, mask, _ = cm.lowest_point_per_group(cstate)
        return fit_plane(pts, mask)

    def relevance(self, slope_x, slope_y):
        """``1 - |bucket| / |all|`` (``SurfaceHash::getRelevance``,
        ``SurfaceHash.hpp:134-139``)."""
        count = self._at_bucket(self.bucket_count,
                                self.bucket(slope_x, slope_y))
        return 1.0 - count / self.n_valid.clamp(min=1)

    def _offsets(self, n, count, u, generator):
        """``u`` (integers in ``[0, max(count, 1))``) or ``floor(U *
        max(count, 1))`` for ``U`` from ``generator``."""
        if u is not None:
            return u.long()
        r = torch.rand((n,), generator=generator,
                       device=self.sorted_idx.device, dtype=torch.float64)
        top = count.clamp(min=1).long()
        return (r * top).long().clamp(max=top - 1)

    def sample_particles(self, n, u=None, generator=None):
        """Uniform global sampling over the valid candidates (the first
        ``n_valid`` entries of ``sorted_idx``; ``SurfaceHash::sample()``,
        ``SurfaceHash.hpp:128-132``).  ``u [n]``: the integer draws in
        ``[0, max(n_valid, 1))``."""
        ids = self.sorted_idx.index_select(
            0, self._offsets(n, self.n_valid, u, generator)).long()
        p = ParticleSet.zeros(n, self.cand_xy.device)
        return dataclasses.replace(
            p, x=self.cand_xy[ids, 0], y=self.cand_xy[ids, 1],
            yaw=self.cand_yaw[ids], z=self.cand_z[ids],
            z_sigma=torch.zeros_like(p.z_sigma))

    def sample_bucket(self, slope_x, slope_y, n, u=None, generator=None):
        """Signature-conditioned sampling (``SurfaceHash::sample(param)``,
        ``SurfaceHash.hpp:141-153``).  ``u [n]``: the in-bucket integer
        draws in ``[0, max(count, 1))``.  Returns ``(ids [n], ok)``; ``ok``
        is False for an empty bucket (the reference returns NULL)."""
        b = self.bucket(slope_x, slope_y)
        count = self._at_bucket(self.bucket_count, b)
        pos = (self._at_bucket(self.bucket_start, b)
               + self._offsets(n, count, u, generator))
        ids = self.sorted_idx.index_select(
            0, pos.clamp(max=self.sorted_idx.shape[0] - 1)).long()
        return ids, count > 0

    def reinject(self, state, contact_state, orientation, cfg: Config,
                 u=None):
        """Replace the lowest-weight particles with hash candidates
        (``PoseEstimator::sampleFromHash``, ``PoseEstimator.cpp:130-182``):
        ``percentage * relevance^3`` of them when the signature is
        distinctive (``relevance^3 >= 0.8``), scaled by the
        ``lost_threshold`` health gate, at weight ``avg * avg_factor *
        relevance^3``.  ``u``: the in-bucket draws of ``sample_bucket``;
        drawn from ``state.generator`` when not given."""
        from slam_eslam_tpu_torch.filter.pose_estimator import (
            weighting_function)

        hcfg = self.config
        p = state.particles
        n = p.n
        sx, sy = self.signature(contact_state, orientation)
        rel = self.relevance(sx, sy) ** 3
        lost = 1.0
        if hcfg.lost_threshold > 0.0:
            lost = weighting_function(state.max_weight, 0.0,
                                      hcfg.lost_threshold, 0.0)
        # float32 count, truncated, as the JAX package computes it
        count = (n * hcfg.percentage * rel * lost).to(torch.int32)
        ids, ok = self.sample_bucket(sx, sy, n, u, state.generator)
        count = torch.where(ok & (rel >= 0.8), count, torch.zeros_like(count))

        # lowest weights first (the reference sorts ascending)
        order = torch.argsort(p.weight, stable=True)
        rank = torch.empty_like(order).scatter_(
            0, order, torch.arange(n, device=order.device))
        replace = rank < count
        new_weight = pf.weights_avg(p.weight) * hcfg.avg_factor * rel
        pick = lambda cand, old: torch.where(replace, cand[ids], old)
        particles = dataclasses.replace(
            p, x=pick(self.cand_xy[:, 0], p.x),
            y=pick(self.cand_xy[:, 1], p.y),
            yaw=pick(self.cand_yaw, p.yaw), z=pick(self.cand_z, p.z),
            z_sigma=torch.where(replace, torch.full_like(p.z_sigma, 0.5),
                                p.z_sigma),
            floating=replace | p.floating,
            weight=torch.where(replace, new_weight, p.weight))
        return dataclasses.replace(state, particles=particles)
