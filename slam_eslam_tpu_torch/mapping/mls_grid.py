"""Multi-Level Surface grids, read side.

Port of the lookup half of ``slam_eslam_tpu.mapping.mls_grid``: the
``[nx, ny, K]`` SoA grid, its packed single-gather view and the z-window
patch select (``MLSMap::getPatch`` with the reference's 3.0 m window,
``PoseEstimator.hpp:97-105``).  The write side (patch fusion, merges)
belongs to the per-particle-map slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


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
