"""Needed bytes and bound of the block merge (kernel K3,
``block_merge_kernel``).

A merge needs each particle's block id and its points' four operand rows
(cell x, cell y, weight, weighted height) read once, and the ``K`` slots
of every cell its points touch read once and written once, each slot four
fields (mean, stdev, height at the pool's dtype, and a 32-bit meta word).
What moves beyond that (the sort of the points by cell, rereads) is the
implementation's, so the bound reads the same work whatever implements
it.  The bound is the bytes over the card's memory rate (``peaks.json``):
the merge's arithmetic is a few operations a byte.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def touched_cells(x, y, yaw, origin, points_xy, valid, res, nx, ny):
    """Distinct in-grid cells of each particle's points: the cloud
    ``points_xy [P, 2]`` (``valid [P]``) placed by each pose ``x, y, yaw
    [N]`` into its head grid at ``origin [N, 2]``.  Returns the total over
    the particles."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    px, py = points_xy[:, 0][None], points_xy[:, 1][None]
    wx = c[:, None] * px - s[:, None] * py + x[:, None]
    wy = s[:, None] * px + c[:, None] * py + y[:, None]
    ix = torch.floor((wx - origin[:, :1]) / res).long()
    iy = torch.floor((wy - origin[:, 1:]) / res).long()
    ok = valid[None] & (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
    lin = torch.where(ok, ix * ny + iy, torch.full_like(ix, -1))
    lin, _ = lin.sort(-1)
    first = torch.ones_like(lin, dtype=torch.bool)
    first[:, 1:] = lin[:, 1:] != lin[:, :-1]
    return int((first & (lin >= 0)).sum())


def needed_bytes(n, p, cells, k, slot_bytes):
    """Block ids and four point rows once; ``k`` slots of ``cells`` cells
    read and written, each ``3 * slot_bytes + 4`` bytes."""
    return n * 4 + 4 * n * p * 4 + 2 * cells * k * (3 * slot_bytes + 4)


def bound_seconds(n, p, cells, k, slot_bytes):
    return needed_bytes(n, p, cells, k, slot_bytes) / PEAKS["hbm_bytes_per_s"]
