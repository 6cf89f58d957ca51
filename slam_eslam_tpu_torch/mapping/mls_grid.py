"""Multi-Level Surface grids.

Port of ``slam_eslam_tpu.mapping.mls_grid``.  Read side: the
``[nx, ny, K]`` SoA grid with ``to_grid``/``from_grid``, the colour-carrying
``get_patch``, the packed single-gather view and the z-window patch select
(``MLSMap::getPatch`` with the reference's 3.0 m window,
``PoseEstimator.hpp:97-105``).  Write side: the ``PatchCloud`` a scan
projects to, the row-wise same-cell fusion ``_dedup_fuse_rows`` and the
envire slot rules ``fuse_slot_rows`` -- the plain version the block-merge
kernel (``ops.block_merge``) is held against -- and the single-grid
writers ``merge_points``, ``merge_cloud``, ``match_cloud`` and
``apply_negative_points`` (``MLSGrid::updateCell`` / ``merge`` / ``match``
on one grid: the shared map's camera merge and the map-building rig).
The single-grid writers return a new grid, as in the JAX package, and
read nothing back to the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from slam_eslam_tpu_torch.utils.scatter import add_at


@dataclasses.dataclass
class MLSGrid:
    """One MLS grid: ``[nx, ny, K]`` patch slots.  ``origin`` is the
    world xy of the cell (0, 0) corner; ``resolution`` (static) is
    metres per cell."""

    mean: torch.Tensor        # [nx, ny, K] float32
    stdev: torch.Tensor       # [nx, ny, K] float32
    height: torch.Tensor      # [nx, ny, K] float32
    valid: torch.Tensor       # [nx, ny, K] bool
    horizontal: torch.Tensor  # [nx, ny, K] bool
    update_idx: torch.Tensor  # [nx, ny, K] int32
    color: torch.Tensor       # [nx, ny, K, 3] float32
    origin: torch.Tensor      # [2] float32
    resolution: float

    @property
    def nx(self):
        return self.mean.shape[0]

    @property
    def ny(self):
        return self.mean.shape[1]

    @property
    def k(self):
        return self.mean.shape[2]

    @staticmethod
    def create(nx, ny, resolution, origin=(0.0, 0.0), k=4, device=None,
               dtype=torch.float32):
        shape = (nx, ny, k)
        return MLSGrid(
            mean=torch.zeros(shape, dtype=dtype, device=device),
            stdev=torch.zeros(shape, dtype=dtype, device=device),
            height=torch.zeros(shape, dtype=dtype, device=device),
            valid=torch.zeros(shape, dtype=torch.bool, device=device),
            horizontal=torch.ones(shape, dtype=torch.bool, device=device),
            update_idx=torch.zeros(shape, dtype=torch.int32, device=device),
            color=torch.zeros(shape + (3,), dtype=dtype, device=device),
            origin=torch.as_tensor(origin, dtype=dtype, device=device),
            resolution=float(resolution),
        )

    def to_grid(self, xy):
        """World ``xy [..., 2]`` -> ``(ix, iy, in_bounds)``, cells
        floor-indexed as ``cells`` computes them."""
        inv = inverse_resolution(self.resolution)
        ix = torch.floor((xy[..., 0] - self.origin[0]) * inv).to(torch.int32)
        iy = torch.floor((xy[..., 1] - self.origin[1]) * inv).to(torch.int32)
        inb = (ix >= 0) & (ix < self.nx) & (iy >= 0) & (iy < self.ny)
        return ix, iy, inb

    def from_grid(self, ix, iy):
        """Cell index -> world xy ``[..., 2]`` of the cell centre."""
        cell = torch.stack([ix, iy], dim=-1).to(self.mean.dtype)
        return (cell + 0.5) * self.resolution + self.origin

    def clear(self):
        """The grid with every patch dropped (``valid`` and
        ``update_idx`` zeroed; the other fields are shared)."""
        return dataclasses.replace(
            self, valid=torch.zeros_like(self.valid),
            update_idx=torch.zeros_like(self.update_idx))


@dataclasses.dataclass
class PackedLookup:
    """Read-only ``[nx, ny, 2K]`` view of a grid: means in the first K
    lanes, stdevs (negative = invalid slot) in the last K, so one query
    reads one contiguous 8K-byte cell row."""

    data: torch.Tensor    # [nx, ny, 2K] float32
    origin: torch.Tensor  # [2] float32
    resolution: float

    @property
    def k(self):
        return self.data.shape[2] // 2

    @staticmethod
    def from_grid(grid: MLSGrid):
        mean = torch.where(grid.valid, grid.mean, torch.zeros_like(grid.mean))
        stdev = torch.where(grid.valid, grid.stdev,
                            torch.full_like(grid.stdev, -1.0))
        return PackedLookup(
            data=torch.cat([mean, stdev], dim=-1).contiguous(),
            origin=grid.origin,
            resolution=grid.resolution,
        )


def inverse_resolution(resolution):
    """Cells per metre as float32 arithmetic gives it.  Cell indices are
    ``floor(offset * inverse_resolution)``: the product the JAX package's
    compiled ``offset / resolution`` reduces to, and one that the CUDA
    kernel and the plain version compute bit for bit alike."""
    return float(np.float32(1.0) / np.float32(resolution))


def cells(packed: PackedLookup, x, y):
    """World x, y -> unclamped int32 cell indices (floor)."""
    inv = inverse_resolution(packed.resolution)
    ix = torch.floor((x - packed.origin[0]) * inv)
    iy = torch.floor((y - packed.origin[1]) * inv)
    return ix.to(torch.int32), iy.to(torch.int32)


def get_patch(grid: MLSGrid, points, z_window=3.0):
    """Colour-carrying lookup of ``[..., 3]`` points in the unpacked grid
    (``mls_grid.get_patch``), a plain gather as in the JAX package, which
    computes it in XLA.  Returns ``(found, mean, stdev, color [..., 3])``.
    Unlike the packed lookup, ``stdev`` is the slot's raw value and the
    means of invalid slots are not masked; a miss carries slot 0 of its
    cell (of cell (0, 0) outside the grid)."""
    ix, iy, inb = grid.to_grid(points[..., :2])
    zero = torch.zeros_like(ix)
    cix = torch.where(inb, ix, zero).long()
    ciy = torch.where(inb, iy, zero).long()
    means = grid.mean[cix, ciy]                                # [..., K]
    dist = (means - points[..., 2:3]).abs()
    cand = grid.valid[cix, ciy] & (dist <= z_window)
    best = torch.argmin(torch.where(cand, dist,
                                    torch.full_like(dist, float("inf"))),
                        dim=-1, keepdim=True)
    found = inb & cand.any(dim=-1)
    take = lambda a: torch.gather(a, -1, best)[..., 0]
    color = torch.gather(grid.color[cix, ciy], -2,
                         best[..., None].expand(best.shape + (3,)))[..., 0, :]
    return found, take(means), take(grid.stdev[cix, ciy]), color


def get_patch_packed_cells(packed: PackedLookup, ix, iy, z, z_window=3.0):
    """Z-window patch select at cell queries ``ix, iy`` (unclamped, any
    shape) with heights ``z``: per query, the valid slot whose mean is
    nearest to ``z`` within ``z_window`` (lowest slot on ties).  Queries
    outside the grid are not found.  Returns ``(found, mean, stdev)``."""
    k = packed.k
    nx, ny = packed.data.shape[0], packed.data.shape[1]
    inb = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
    zero = torch.zeros_like(ix)
    cell = packed.data[torch.where(inb, ix, zero).long(),
                       torch.where(inb, iy, zero).long()]
    means = cell[..., :k]
    stdevs = cell[..., k:]
    dist = (means - z[..., None]).abs()
    cand = (stdevs >= 0.0) & (dist <= z_window)
    dist = torch.where(cand, dist, torch.full_like(dist, float("inf")))
    best = torch.argmin(dist, dim=-1, keepdim=True)
    found = inb & cand.any(dim=-1)
    mean = torch.gather(means, -1, best)[..., 0]
    stdev = torch.gather(stdevs, -1, best)[..., 0].abs()
    return found, mean, stdev


def get_patch_packed(packed: PackedLookup, points, z_window=3.0):
    """Lookup of ``[..., 3]`` world points.  Returns ``(found, mean,
    stdev, color)``; the packed view carries no colour (zeros)."""
    ix, iy = cells(packed, points[..., 0], points[..., 1])
    found, mean, stdev = get_patch_packed_cells(
        packed, ix, iy, points[..., 2], z_window
    )
    color = torch.zeros(points.shape[:-1] + (3,), dtype=mean.dtype,
                        device=mean.device)
    return found, mean, stdev, color


# --------------------------------------------------------------------------
# Write side: patch clouds and slot fusion
# --------------------------------------------------------------------------

@dataclasses.dataclass
class PatchCloud:
    """Fixed-size list of surface patches in the yaw-compensated body
    frame (the reference's intermediate ``scanMap``,
    ``EmbodiedSlamFilter.cpp:137-160``); ``color`` is zeros when
    untextured."""

    xy: torch.Tensor     # [P, 2] float32
    z: torch.Tensor      # [P] float32
    stdev: torch.Tensor  # [P] float32
    valid: torch.Tensor  # [P] bool
    color: torch.Tensor  # [P, 3] float32

    @property
    def p(self):
        return self.xy.shape[0]

    @staticmethod
    def create(xy, z, stdev, valid, color=None):
        if color is None:
            color = torch.zeros(xy.shape[:-1] + (3,), dtype=xy.dtype,
                                device=xy.device)
        return PatchCloud(xy=xy, z=z, stdev=stdev, valid=valid, color=color)


# the pool's slot flags, packed into one int32 word per slot
META_VALID = 1          # bit 0
META_HORIZONTAL = 2     # bit 1
META_UIDX_SHIFT = 2     # bits 2.. = update_idx


def pack_meta(valid, horizontal, update_idx):
    """Encode (valid, horizontal, update_idx) into one int32 word."""
    return ((valid.to(torch.int32) & 1)
            | ((horizontal.to(torch.int32) & 1) << 1)
            | (update_idx.to(torch.int32) << META_UIDX_SHIFT))


def run_sums_rows(lin, w, wz, color=None):
    """Per row: sort the entries by cell id ``lin [N, P]`` (stable, so
    equal cells keep point order) and sum ``w``, ``wz`` (and ``w *
    color``) over each run of equal cells, adding in point order on the
    CPU and in ``utils.scatter.add_at``'s fixed order on the card.

    Returns ``(lin_s, order, first, wsum, wzsum, csum)``: the sorted ids,
    the permutation, a mark on the first entry of each run, and the run
    sums broadcast back to every entry of the run (``csum`` is None
    without ``color [N, P, 3]``)."""
    n, p = lin.shape
    lin_s, order = torch.sort(lin, dim=1, stable=True)
    first = torch.ones_like(lin_s, dtype=torch.bool)
    first[:, 1:] = lin_s[:, 1:] != lin_s[:, :-1]
    seg = torch.cumsum(first.to(torch.int64), dim=1) - 1          # [N, P]
    # each run's element of the flat [N * P] sums; add_at adds a run's
    # entries in one fixed order, point order on the CPU (utils.scatter)
    run = (torch.arange(n, device=lin.device)[:, None] * p + seg).reshape(-1)

    def run_sum(v, trail=()):
        flat = run if not trail else (
            run[:, None] * trail[0] + torch.arange(
                trail[0], device=run.device)).reshape(-1)
        out = add_at(torch.zeros_like(v).reshape(-1), flat,
                     v.reshape(-1)).view(v.shape)
        return torch.gather(out, 1, seg.view(n, p, *(1,) * len(trail))
                            .expand(v.shape))

    w_s = torch.gather(w, 1, order)
    wsum = run_sum(w_s)
    wzsum = run_sum(torch.gather(wz, 1, order))
    csum = None
    if color is not None:
        idx3 = order[..., None].expand(n, p, 3)
        wc = w_s[..., None] * torch.gather(color, 1, idx3)
        csum = run_sum(wc, (3,))
    return lin_s, order, first, wsum, wzsum, csum


def _dedup_fuse_rows(lin, z, var, mask, sentinel, color=None):
    """Row-independent Gaussian fusion of same-cell points
    (``mls_grid._dedup_fuse_rows``): rows are particles, so cells of
    different rows never collide.  Returns ``(lin_sorted, fused_z,
    fused_var, keep, fused_color)`` with the entries reordered within
    rows and ``keep`` marking one survivor per occupied cell."""
    lin_m = torch.where(mask, lin, torch.full_like(lin, sentinel))
    w = torch.where(mask, 1.0 / var.clamp(min=1e-12), torch.zeros_like(var))
    lin_s, order, first, wsum, wzsum, csum = run_sums_rows(
        lin_m, w, w * z, color)
    fused_z = wzsum / wsum.clamp(min=1e-30)
    fused_var = 1.0 / wsum.clamp(min=1e-30)
    fused_color = (None if csum is None
                   else csum / wsum.clamp(min=1e-30)[..., None])
    keep = first & torch.gather(mask, 1, order)
    return lin_s, fused_z, fused_var, keep, fused_color


def fuse_slot_rows(means, stdevs, heights, valids, horiz, uidx,
                   z, var, keep, update_idx,
                   patch_thickness=0.1, gap_size=1.5):
    """The envire ``MLSGrid::updateCell`` rules for one measurement
    ``(z [M], var [M])`` against its cell's ``[M, K]`` slot rows
    (``mls_grid.fuse_slot_rows``): (a) Kalman-fuse with the nearest
    horizontal patch within ``patch_thickness``; (b) else extend the
    nearest patch within ``gap_size`` vertically; (c) else insert into
    the lowest free slot, or evict the highest-stdev patch.  The lowest
    slot wins every tie.  Only rows with ``keep`` write, stamped with
    ``update_idx`` (a Python int or a 0-d integer tensor on the rows'
    device).  Returns the updated rows and the written-slot mask ``upd
    [M, K]``."""
    k = means.shape[-1]
    dist = (means - z[:, None]).abs()
    inf = torch.full_like(dist, float("inf"))

    fuse_cand = valids & horiz & (dist <= patch_thickness)
    fuse_slot = torch.argmin(torch.where(fuse_cand, dist, inf), dim=-1)
    can_fuse = fuse_cand.any(dim=-1)

    gap_cand = valids & (dist <= gap_size)
    gap_slot = torch.argmin(torch.where(gap_cand, dist, inf), dim=-1)
    can_gap = gap_cand.any(dim=-1) & ~can_fuse

    free_slot = torch.argmax((~valids).to(torch.int32), dim=-1)
    has_free = (~valids).any(dim=-1)
    evict_slot = torch.argmax(torch.where(valids, stdevs, -inf), dim=-1)
    ins_slot = torch.where(has_free, free_slot, evict_slot)

    slot = torch.where(can_fuse, fuse_slot,
                       torch.where(can_gap, gap_slot, ins_slot))
    onehot = slot[:, None] == torch.arange(k, device=slot.device)[None, :]
    sel = lambda a: torch.gather(a, 1, slot[:, None])[:, 0]
    m0, s0, h0 = sel(means), sel(stdevs), sel(heights)

    w1 = 1.0 / (s0 * s0).clamp(min=1e-12)
    w2 = 1.0 / var.clamp(min=1e-12)
    fuse_mean = (m0 * w1 + z * w2) / (w1 + w2)
    fuse_stdev = torch.sqrt(1.0 / (w1 + w2))
    top = torch.maximum(m0, z)
    bottom = torch.minimum(m0 - h0, z)
    sq_var = torch.sqrt(var)

    new_mean = torch.where(can_fuse, fuse_mean, torch.where(can_gap, top, z))
    new_stdev = torch.where(can_fuse, fuse_stdev,
                            torch.where(can_gap, torch.minimum(s0, sq_var),
                                        sq_var))
    new_height = torch.where(can_fuse, h0,
                             torch.where(can_gap, top - bottom,
                                         torch.zeros_like(top)))
    new_horiz = can_fuse | ~can_gap

    upd = onehot & keep[:, None]
    means = torch.where(upd, new_mean[:, None], means)
    stdevs = torch.where(upd, new_stdev[:, None], stdevs)
    heights = torch.where(upd, new_height[:, None], heights)
    valids = valids | upd
    horiz = torch.where(upd, new_horiz[:, None], horiz)
    stamp = (update_idx.to(uidx.dtype) if torch.is_tensor(update_idx)
             else torch.full_like(uidx, int(update_idx)))
    uidx = torch.where(upd, stamp, uidx)
    return means, stdevs, heights, valids, horiz, uidx, upd


# --------------------------------------------------------------------------
# Single-grid writers (MLSGrid::updateCell / merge / match on one grid)
# --------------------------------------------------------------------------

def _dedup_fuse(ix, iy, z, var, mask, nx, ny, color=None):
    """Gaussian-fuse points that land in the same cell
    (``mls_grid._dedup_fuse``): a stable sort by linear cell id and
    inverse-variance sums over each run, in point order.  Returns ``(ix,
    iy, fused_z, fused_var, keep, order, fused_color)``, all ``[P]`` in
    sorted order, ``keep`` marking one survivor per occupied cell;
    ``color [P, 3]``, when given, fuses by the same weights."""
    lin = torch.where(mask, ix.long() * ny + iy.long(),
                      torch.full_like(ix, nx * ny, dtype=torch.long))
    w = torch.where(mask, 1.0 / var.clamp(min=1e-12), torch.zeros_like(var))
    _, order, first, wsum, wzsum, csum = run_sums_rows(
        lin[None], w[None], (w * z)[None],
        None if color is None else color[None])
    order, first, wsum = order[0], first[0], wsum[0].clamp(min=1e-30)
    fused_color = None if csum is None else csum[0] / wsum[:, None]
    keep = first & mask[order]
    return (ix[order], iy[order], wzsum[0] / wsum, 1.0 / wsum, keep, order,
            fused_color)


def scatter_fuse_cells(arrays, ix, iy, z, var, keep, update_idx,
                       patch_thickness=0.1, gap_size=1.5, color=None):
    """Fuse one measurement per (unique) cell into the K patch slots
    (``mls_grid.scatter_fuse_cells``).  ``arrays`` is the dict of grid
    fields shaped ``[X, ny, K]`` (``color [X, ny, K, 3]``); ``(ix, iy)``
    must be unique among the ``keep`` entries (``_dedup_fuse``).  Returns
    the dict of updated fields (new tensors).  Dropped entries are written
    to a spare row past the grid, so nothing depends on their number and
    no device value is read back."""
    x, ny = arrays["mean"].shape[:2]
    zero = torch.zeros_like(ix)
    gix = torch.where(keep, ix, zero).long()
    giy = torch.where(keep, iy, zero).long()
    means, stdevs, heights, valids, horiz, uidx, upd = fuse_slot_rows(
        arrays["mean"][gix, giy], arrays["stdev"][gix, giy],
        arrays["height"][gix, giy], arrays["valid"][gix, giy],
        arrays["horizontal"][gix, giy], arrays["update_idx"][gix, giy],
        z, var, keep, update_idx,
        patch_thickness=patch_thickness, gap_size=gap_size)
    cell = torch.where(keep, gix * ny + giy, torch.full_like(gix, x * ny))

    def scat(dst, val):
        trail = dst.shape[2:]
        flat = torch.cat([dst.reshape((x * ny,) + trail),
                          dst.new_zeros((1,) + trail)])
        flat[cell] = val.to(dst.dtype)
        return flat[:-1].reshape(dst.shape)

    out = {"mean": scat(arrays["mean"], means),
           "stdev": scat(arrays["stdev"], stdevs),
           "height": scat(arrays["height"], heights),
           "valid": scat(arrays["valid"], valids),
           "horizontal": scat(arrays["horizontal"], horiz),
           "update_idx": scat(arrays["update_idx"], uidx)}
    if color is not None and "color" in arrays:
        # written slots take the (fused) measurement colour (terrain-class
        # RGB riding on patches, ContactModel.cpp:238-240)
        cell_colors = torch.where(upd[..., None], color[:, None, :],
                                  arrays["color"][gix, giy])
        out["color"] = scat(arrays["color"], cell_colors)
    return out


def merge_points(grid: MLSGrid, xy, z, stdev, mask, update_idx,
                 patch_thickness=0.1, gap_size=1.5, color=None):
    """Scatter-fuse a batch of surface measurements into the grid
    (looping ``MLSGrid::updateCell`` over projected points,
    ``testMap.cpp:304-317``): points are bucketed by cell and
    Gaussian-fused per cell, then each occupied cell resolves against its
    K slots by the envire rules (``fuse_slot_rows``).  ``update_idx`` (a
    Python int) is stamped on touched patches.  Returns the updated
    grid."""
    ix, iy, inb = grid.to_grid(xy)
    ix, iy, z, var, keep, _, fcolor = _dedup_fuse(
        ix, iy, z, stdev * stdev, mask & inb, grid.nx, grid.ny, color=color)
    arrays = {name: getattr(grid, name) for name in (
        "mean", "stdev", "height", "valid", "horizontal", "update_idx")}
    if color is not None:
        arrays["color"] = grid.color
    return dataclasses.replace(grid, **scatter_fuse_cells(
        arrays, ix, iy, z, var, keep, update_idx,
        patch_thickness=patch_thickness, gap_size=gap_size, color=fcolor))


def apply_negative_points(grid: MLSGrid, points, mask, z_margin=0.15):
    """Negative information (``useNegativeInformation``,
    ``EmbodiedSlamFilter.cpp:160``): patches whose mean lies within
    ``z_margin`` of a free-space sample ``points [P, 3]``
    (``projection.free_space_points``) are invalidated.  Returns the
    updated grid."""
    ix, iy, inb = grid.to_grid(points[..., :2])
    m = mask & inb
    zero = torch.zeros_like(ix)
    gix = torch.where(m, ix, zero).long()
    giy = torch.where(m, iy, zero).long()
    hit = (grid.valid[gix, giy]
           & ((grid.mean[gix, giy] - points[..., 2:3]).abs() <= z_margin)
           & m[..., None])
    cells = grid.nx * grid.ny
    hits = torch.zeros((cells + 1, grid.k), dtype=torch.int32,
                       device=ix.device)
    hits.index_put_((torch.where(m, gix * grid.ny + giy,
                                 torch.full_like(gix, cells)),),
                    hit.to(torch.int32), accumulate=True)
    return dataclasses.replace(
        grid, valid=grid.valid & (hits[:-1] == 0).reshape(grid.valid.shape))


def _on_device(v, like):
    """``v`` as a tensor of ``like``'s dtype and device; a host number by
    a fill kernel, not a copy from the host (which a CUDA graph cannot
    capture)."""
    if isinstance(v, (int, float)):
        return torch.full((), v, dtype=like.dtype, device=like.device)
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _place_cloud(cloud: PatchCloud, rot2d, trans, z_offset):
    """The cloud under a planar pose: ``rot2d [..., 2, 2]``, ``trans
    [..., 2]``, ``z_offset [...]`` -> world ``[..., P, 3]``."""
    px, py = cloud.xy[:, 0], cloud.xy[:, 1]
    gx = (rot2d[..., 0, 0, None] * px + rot2d[..., 0, 1, None] * py
          + trans[..., 0, None])
    gy = (rot2d[..., 1, 0, None] * px + rot2d[..., 1, 1, None] * py
          + trans[..., 1, None])
    return torch.stack([gx, gy, cloud.z + z_offset[..., None]], dim=-1)


def match_cloud(grid: MLSGrid, cloud: PatchCloud, rot2d, trans, z_offset,
                offset_stdev, sampling=10, sigma=0.2, z_window=3.0):
    """Scan-to-map consistency score in [0, 1] (``MLSGrid::match``,
    consumed at ``EmbodiedSlamFilter.cpp:214-221``): every
    ``sampling``-th cloud patch, placed by ``rot2d``, ``trans`` and
    ``z_offset`` (the particle's zPos), is looked up and scored with a
    Gaussian on the height residual, ``offset_stdev`` (the particle's
    zSigma) widening its variance; missing patches score 0 and the sum is
    normalised by the number of valid sampled patches.  The pose may carry
    leading batch dimensions (``rot2d [N, 2, 2]``, ``trans [N, 2]``,
    ``z_offset, offset_stdev [N]``): one score per pose."""
    z_offset = _on_device(z_offset, cloud.z)
    offset_stdev = _on_device(offset_stdev, cloud.z)
    m = cloud.valid & (torch.arange(cloud.p, device=cloud.z.device)
                       % sampling == 0)
    pts = _place_cloud(cloud, rot2d, trans, z_offset)
    found, mean, stdev, _ = get_patch(grid, pts, z_window)
    var = (sigma * sigma + stdev * stdev + cloud.stdev ** 2
           + offset_stdev[..., None] ** 2)
    resid = pts[..., 2] - mean
    score = torch.where(m & found, torch.exp(-0.5 * resid * resid / var),
                        torch.zeros_like(resid))
    return score.sum(-1) / m.sum().clamp(min=1)


def merge_cloud(grid: MLSGrid, cloud: PatchCloud, rot2d, trans, z_offset,
                offset_stdev, update_idx, patch_thickness=0.1, gap_size=1.5):
    """Merge a scan cloud into the grid under one pose (``MLSGrid::
    merge(scanMap, C_s2p, offsetPatch)``, ``EmbodiedSlamFilter.cpp:
    222-227``): patches are shifted by ``z_offset`` and their uncertainty
    widened by ``offset_stdev`` before fusion.  Returns the updated
    grid."""
    z_offset = _on_device(z_offset, cloud.z)
    pts = _place_cloud(cloud, rot2d, trans, z_offset)
    stdev = torch.sqrt(cloud.stdev ** 2 + offset_stdev ** 2)
    return merge_points(grid, pts[:, :2], pts[:, 2], stdev, cloud.valid,
                        update_idx, patch_thickness=patch_thickness,
                        gap_size=gap_size, color=cloud.color)
