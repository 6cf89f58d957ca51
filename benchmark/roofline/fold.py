"""Work and bound of the contact fold (kernel K1, ``contact_fold_kernel``).

Copied from the port's ``utils/kernel_eff.py`` (``fold_costs``,
``fold_work``, ``fold_bound``), with the lookup done here in plain
PyTorch: the counts come from the call's inputs (the queries, the grid,
the groups), never from the kernel's code, so the bound reads the same
work whatever implements it.

A call needs its queries, the measurement variances and its eight output
rows once each, and one slot row of ``2K`` floats for every distinct grid
cell its queries touch; and the instructions of ``fold_costs`` for what
its data makes it do.  The bound is the larger of the bytes over the
card's memory rate and the instructions over its float32 instruction rate
(``peaks.json``).
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())

# Instructions of an IEEE float32 division, square root and expf as nvcc
# emits them for sm_90 without fast math, on the common path.
DIV, SQRT, EXP = 8, 8, 8


def fold_costs(k):
    """Instructions per thing a fold's data makes it do, at ``k`` slots a
    cell (see the port's ``kernel_eff.fold_costs``)."""
    return {
        "particles": 20,
        "rows": 8,
        "active": 18,
        "inside": 6 + 6 * k,
        "found": 2 * (k - 1) + 3 + SQRT + 1 + 2 * DIV + 5,
        "head": 2 + DIV + 6 + 2 + EXP + 3 + 3 + EXP + 1 + DIV,
        "tail": 1 + 8 * (DIV + 1),
        "groups": 12,
        "valid_groups": 3 * DIV,
    }


def cells(grid, x, y):
    """Unclamped cell indices of world ``x, y`` in ``grid`` (a dict of
    ``mean [nx, ny, K]``, ``origin``, ``resolution``)."""
    res = grid["resolution"]
    ix = torch.floor((x - grid["origin"][0]) / res).long()
    iy = torch.floor((y - grid["origin"][1]) / res).long()
    return ix, iy


def fold_work(grid, queries, active, mv, group, correction, z_window):
    """What one fold's inputs make it do: ``{"particles", "rows",
    "active", "inside", "found", "head", "tail", "groups",
    "valid_groups", "touched"}``.  ``queries``: ``(x, y, z)``, each
    ``[C, N]``; ``active [C]`` bool; ``mv [N]``; ``group [C]`` the group
    index of each row.  A group is valid when every active member found a
    patch and one did; ``touched`` counts the distinct cells of the
    queries inside the grid."""
    x, y, z = queries
    c, n = x.shape
    nx, ny, _ = grid["mean"].shape
    ix, iy = cells(grid, x, y)
    act = active[:, None].expand(c, n)
    inside = act & (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
    cx = torch.where(inside, ix, torch.zeros_like(ix))
    cy = torch.where(inside, iy, torch.zeros_like(iy))
    mean = grid["mean"][cx, cy].to(z.dtype)
    sd = grid["stdev"][cx, cy].to(z.dtype)
    dist = (mean - z[..., None]).abs()
    ok = grid["valid"][cx, cy] & (dist <= z_window)
    best = torch.where(ok, dist, torch.full_like(dist, float("inf"))).argmin(
        -1, keepdim=True)
    found = inside & ok.any(-1)
    m = mean.gather(-1, best)[..., 0]
    s = sd.gather(-1, best)[..., 0]
    u = (z - m) / (torch.sqrt(s * s + mv[None]) * correction)
    tail = found & ~(u >= -3.0)
    groups = int(group.max()) + 1 if c else 0
    onehot = (group[:, None] == torch.arange(groups, device=group.device)[
        None]).to(torch.float32)                               # [C, G]
    hits = onehot.T @ found.to(torch.float32)                  # [G, N]
    acts = (onehot * active[:, None].to(torch.float32)).sum(0)[:, None]
    valid = (hits >= acts - 0.5) & (hits > 0.5)
    count = lambda t: int(t.sum())
    touched = torch.unique((ix * ny + iy)[inside]).numel()
    return {"particles": n, "rows": c * n, "active": count(act),
            "inside": count(inside), "found": count(found),
            "head": count(found) - count(tail), "tail": count(tail),
            "groups": groups * n, "valid_groups": count(valid),
            "touched": int(touched)}


def needed_bytes(work, c, n, k):
    """Bytes a fold must move: queries, variances and output rows once,
    one slot row (means and stdevs, ``2k`` floats) per touched cell."""
    return (3 * c * n + n + 8 * n) * 4 + work["touched"] * 2 * k * 4


def needed_instructions(work, k):
    costs = fold_costs(k)
    return sum(costs[name] * work[name] for name in costs)


def bound_seconds(work, c, n, k):
    """``(seconds, "bytes" or "operations")``: the least time the card
    could take for a fold with this work."""
    t_bytes = needed_bytes(work, c, n, k) / PEAKS["hbm_bytes_per_s"]
    t_ops = needed_instructions(work, k) / PEAKS["fp32_instructions_per_s"]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
