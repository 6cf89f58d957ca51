"""Needed bytes, operations and bound of the cloud merge
(``cloud_merge_kernel``): one shared cloud of ``P`` points placed by each
of ``N`` poses and fused per cell into each particle's head block.

**Bytes.**  The merge needs the cloud's rows once (x, y, z, stdev and the
valid byte, 17 bytes a point, and 12 of colour on a colour pool), each
pose once (block id, x, y, the yaw's cosine and sine, z and its stdev,
and the head block's origin: 36 bytes), and the ``K`` slots of every cell
it writes read once and written once, each slot three fields at the
pool's dtype and a 32-bit meta word, and three colour channels at the
pool's dtype on a colour pool.  Per-particle operand rows are not counted:
a kernel that places the points in registers never moves them.

**Operations.**  Each valid placement of a point that falls in its
particle's block needs, as ``map_pool.merge_operands`` and K3 state it:
the rotation and translation of x and y (2 multiplies and 2 adds each,
8), the cell (a subtract, a multiply and a floor each for x and y, 6), the
inverse-variance weight (the point's variance, an add of the particle's,
a clamp and a reciprocal, 4), the weighted height (an add and a multiply,
2), the weighted colour (3 multiplies on a colour pool) and its share of
the cell's sums (w and w z, and 3 colour sums on a colour pool: 2 or 5
adds): 22 operations a placement, 28 on a colour pool.  A division counts
as one operation, which keeps the bound low.  The fuse of a cell's slots
is left out: a few tens of operations a cell against hundreds of points.

The bound is the larger of the bytes over the card's memory rate and the
operations over its float32 rate (``peaks.json``).
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())

POINT_BYTES = 17
COLOR_BYTES = 12
POSE_BYTES = 36
OPS = {"place": 8, "cell": 6, "weight": 4, "height": 2, "sums": 2}
COLOR_OPS = {"weigh_color": 3, "color_sums": 3}


def placements(x, y, yaw, origin, points_xy, valid, res, nx, ny, group=32):
    """``(placements, cells)``: the valid points of the cloud ``points_xy
    [P, 2]`` that fall in each particle's block, placed by each pose ``x,
    y, yaw [N]`` into its head block at ``origin [N, 2]``, and the distinct
    cells they hit, each summed over the particles (``group`` particles at
    a time)."""
    placed = cells = 0
    px, py = points_xy[:, 0][None], points_xy[:, 1][None]
    for lo in range(0, len(x), group):
        sl = slice(lo, lo + group)
        c, s = torch.cos(yaw[sl]), torch.sin(yaw[sl])
        wx = c[:, None] * px - s[:, None] * py + x[sl, None]
        wy = s[:, None] * px + c[:, None] * py + y[sl, None]
        ix = torch.floor((wx - origin[sl, :1]) / res).long()
        iy = torch.floor((wy - origin[sl, 1:]) / res).long()
        ok = valid[None] & (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
        lin, _ = torch.where(ok, ix * ny + iy, -1).sort(-1)
        first = torch.ones_like(lin, dtype=torch.bool)
        first[:, 1:] = lin[:, 1:] != lin[:, :-1]
        placed += int(ok.sum())
        cells += int((first & (lin >= 0)).sum())
    return placed, cells


def needed_bytes(n, p, cells, k, slot_bytes, color):
    """The cloud and the poses once; the written cells' ``k`` slots read
    and written once."""
    slot = 3 * slot_bytes + 4 + (3 * slot_bytes if color else 0)
    return (p * (POINT_BYTES + (COLOR_BYTES if color else 0))
            + n * POSE_BYTES + 2 * cells * k * slot)


def needed_ops(placed, color):
    """Operations of ``placed`` valid placements (module docstring)."""
    per = sum(OPS.values()) + (sum(COLOR_OPS.values()) if color else 0)
    return placed * per


def bound_seconds(n, p, placed, cells, k, slot_bytes, color):
    return max(needed_bytes(n, p, cells, k, slot_bytes, color)
               / PEAKS["hbm_bytes_per_s"],
               needed_ops(placed, color) / PEAKS["fp32_flops_per_s"])
