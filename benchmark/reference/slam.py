"""Plain reference of per-particle-map SLAM, in PyTorch.

The semantics of the reference filter's SLAM frame
(``EmbodiedSlamFilter.cpp:179-369``) on the maps of a few particles,
written from the published description and nothing of the program under
test.  A particle's map is a chain of MLS grids, most recent first; each
grid has an origin (the world xy of its cell (0, 0) corner), and per cell
``K`` patch slots of ``mean``, ``stdev``, ``height``, ``valid``,
``horizontal`` and the update stamp ``uidx``.  A set of maps is a dict of
tensors with a leading ``[S, L]`` (particles, levels) and ``exists [S,
L]``.

* ``chain_lookup``: a query finds, level by level from the head, the
  valid patch of its cell nearest in height within the z window; the
  first level that has one answers (read from blocks of cells, whole
  grids or windows of them).
* ``own_heads``: the copy-on-write copy changes no particle's map; a
  particle farther than ``threshold`` along x or y from its head grid's
  centre starts an empty head grid centred on itself, and its chain drops
  the oldest grid (``MLSMap::selectActiveGrid``).
* ``merge``: a scan, placed by the particle's pose, fuses per cell (the
  inverse-variance mean of the cell's points) into the head grid by the
  envire ``MLSGrid::updateCell`` rules: Kalman-fuse with the nearest
  horizontal patch within the patch thickness, else extend the nearest
  patch within the gap size vertically, else take the lowest free slot or
  evict the patch of largest stdev; the lowest slot wins ties, and the
  written slot is stamped with the update index.
* ``scan_cloud``: a laser scan as points in the yaw-compensated body frame
  with their height variances (``EmbodiedSlamFilter.cpp:311-335``).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.localization import rotate, strip_yaw

SCAN_ANGLE_SIGMA = 5.0 * math.pi / 180.0   # EmbodiedSlamFilter.cpp:323
PITCH_ROLL_SIGMA = 3.0 * math.pi / 180.0   # EmbodiedSlamFilter.cpp:332
SENSOR_SIGMA = 0.02
MIN_RANGE = 0.1


def cells(origin, x, y, res):
    """Cell indices of world ``x, y [S, P]`` in grids at ``origin [S,
    2]``."""
    ix = torch.floor((x - origin[:, :1]) / res).long()
    iy = torch.floor((y - origin[:, 1:]) / res).long()
    return ix, iy


def chain_lookup(grids, x, y, z, res, z_window):
    """``(found, mean, stdev, outside)`` of queries ``[N, C]`` through
    each particle's chain.  ``grids`` holds blocks of cells: ``mean``,
    ``stdev``, ``valid [B, W, W, K]``, each block's grid ``origin [B, 2]``,
    the block's first cell ``lo [B, 2]`` in its grid (a window of a grid
    of ``extent`` cells, or the whole grid at ``lo`` 0) and ``chain [N,
    L]``, each particle's blocks head first (-1: none).  ``outside``
    marks queries inside a grid of the chain but beyond its window, which
    the window cannot answer."""
    nx, ny = grids["extent"]
    w = grids["mean"].shape[1]
    found = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    outside = torch.zeros_like(found)
    mean = torch.zeros_like(x)
    sd = torch.zeros_like(x)
    for lv in range(grids["chain"].shape[1]):
        blk = grids["chain"][:, lv]
        b = blk.clamp(min=0)
        org = grids["origin"][b].to(x.dtype)
        lo = grids["lo"][b]
        ix = torch.floor((x - org[:, :1]) / res).long()
        iy = torch.floor((y - org[:, 1:]) / res).long()
        inside = ((ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
                  & (blk >= 0)[:, None])
        wx, wy = ix - lo[:, :1], iy - lo[:, 1:]
        kept = (wx >= 0) & (wx < w) & (wy >= 0) & (wy < w)
        outside = outside | (inside & ~kept & ~found)
        inside = inside & kept
        cx = torch.where(inside, wx, torch.zeros_like(wx))
        cy = torch.where(inside, wy, torch.zeros_like(wy))
        bb = b[:, None].expand(x.shape)
        m = grids["mean"][bb, cx, cy].to(x.dtype)             # [N, C, K]
        d = grids["stdev"][bb, cx, cy].to(x.dtype)
        dist = (m - z[..., None]).abs()
        ok = grids["valid"][bb, cx, cy] & (dist <= z_window)
        best = torch.where(ok, dist, torch.full_like(dist, math.inf)).argmin(
            -1, keepdim=True)
        hit = inside & ok.any(-1) & ~found
        mean = torch.where(hit, m.gather(-1, best)[..., 0], mean)
        sd = torch.where(hit, d.gather(-1, best)[..., 0], sd)
        found = found | hit
    return found, mean, sd, outside


def own_heads(maps, x, y, res, threshold):
    """Rollover of each particle at ``x, y [S]``; returns ``(maps,
    rolled [S])``."""
    nx, ny = maps["mean"].shape[2:4]
    hx, hy = nx * res / 2.0, ny * res / 2.0
    org = maps["origin"][:, 0]
    rolled = (((x - (org[:, 0] + hx)).abs() > threshold)
              | ((y - (org[:, 1] + hy)).abs() > threshold))
    out = {}
    for name, v in maps.items():
        shifted = torch.cat([torch.zeros_like(v[:, :1]), v[:, :-1]], 1)
        sel = rolled.view((-1,) + (1,) * (v.dim() - 1))
        out[name] = torch.where(sel, shifted, v)
    new_org = torch.stack([x - hx, y - hy], -1)
    out["origin"][:, 0] = torch.where(rolled[:, None], new_org,
                                      maps["origin"][:, 0])
    out["exists"][:, 0] = torch.where(rolled, True, maps["exists"][:, 0])
    return out, rolled


def scan_cloud(ranges, start, step, max_range, q, rot, trans, dtype):
    """Points ``(xy [R, 2], z [R], stdev [R], valid [R])`` of a scan in
    the yaw-compensated body frame."""
    r = ranges.to(dtype)
    a = start + torch.arange(len(r), dtype=dtype, device=r.device) * step
    valid = (r > MIN_RANGE) & (r < max_range) & torch.isfinite(r)
    pts = torch.stack([r * torch.cos(a), r * torch.sin(a),
                       torch.zeros_like(r)], -1)
    body = pts @ rot.to(dtype).T + trans.to(dtype)
    q0 = strip_yaw(q.to(dtype))
    world = rotate(q0[None], body)
    up = rotate(q0, torch.tensor([0.0, 0.0, 1.0], dtype=dtype,
                                 device=r.device))
    tilt = torch.arccos(up[2].clamp(-1.0, 1.0))
    dz_sensor = (SCAN_ANGLE_SIGMA * torch.linalg.vector_norm(body[:, :2], dim=-1)
                 * torch.sin(tilt).abs())
    dz_body = PITCH_ROLL_SIGMA * torch.linalg.vector_norm(world[:, :2], dim=-1)
    sd = torch.sqrt(SENSOR_SIGMA ** 2 + dz_sensor ** 2 + dz_body ** 2)
    return world[:, :2], world[:, 2], sd, valid


def merge(maps, x, y, yaw, z, z_sigma, cloud, update_idx, res, thickness,
          gap):
    """The scan ``cloud`` into each particle's head grid; returns the new
    maps and the number of cells written."""
    xy_c, z_c, sd_c, valid = cloud
    s_, _, nx, ny, _ = maps["mean"].shape
    c, s = torch.cos(yaw), torch.sin(yaw)
    wx = c[:, None] * xy_c[None, :, 0] - s[:, None] * xy_c[None, :, 1] + x[:, None]
    wy = s[:, None] * xy_c[None, :, 0] + c[:, None] * xy_c[None, :, 1] + y[:, None]
    wz = z_c[None] + z[:, None]
    var = sd_c[None] ** 2 + z_sigma[:, None] ** 2
    ix, iy = cells(maps["origin"][:, 0], wx, wy, res)
    hit = valid[None] & (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
    w = torch.where(hit, 1.0 / var, torch.zeros_like(var))
    lin = torch.where(hit, ix * ny + iy, torch.full_like(ix, nx * ny))
    wsum = torch.zeros(s_, nx * ny + 1, dtype=w.dtype, device=w.device)
    wzsum = torch.zeros_like(wsum)
    wsum.scatter_add_(1, lin, w)
    wzsum.scatter_add_(1, lin, w * wz)
    wsum, wzsum = wsum[:, :-1], wzsum[:, :-1]
    touched = wsum > 0                                      # [S, cells]
    mz = wzsum / wsum.clamp(min=1e-300)
    mvar = 1.0 / wsum.clamp(min=1e-300)
    out = {kk: v.clone() for kk, v in maps.items()}
    head = {kk: out[kk][:, 0].reshape(s_, nx * ny, *out[kk].shape[4:])
            for kk in ("mean", "stdev", "height", "valid", "horiz", "uidx")}
    sel = touched.nonzero(as_tuple=True)
    rows = {kk: v[sel] for kk, v in head.items()}           # [M, K]
    new = update_cells(rows, mz[sel], mvar[sel], update_idx, thickness, gap)
    for kk, v in new.items():
        head[kk][sel] = v
    for kk in head:
        out[kk][:, 0] = head[kk].reshape(out[kk][:, 0].shape)
    return out, int(touched.sum())


def update_cells(rows, z, var, update_idx, thickness, gap):
    """``MLSGrid::updateCell`` for one fused measurement ``(z, var)`` per
    cell against the cell's slots ``rows`` (each ``[M, K]``)."""
    means, stdevs, heights = rows["mean"], rows["stdev"], rows["height"]
    valids, horiz = rows["valid"], rows["horiz"]
    k = means.shape[-1]
    inf = torch.full_like(means, math.inf)
    dist = (means - z[:, None]).abs()
    fuse_cand = valids & horiz & (dist <= thickness)
    can_fuse = fuse_cand.any(-1)
    fuse_slot = torch.where(fuse_cand, dist, inf).argmin(-1)
    gap_cand = valids & (dist <= gap)
    can_gap = gap_cand.any(-1) & ~can_fuse
    gap_slot = torch.where(gap_cand, dist, inf).argmin(-1)
    has_free = (~valids).any(-1)
    free_slot = (~valids).to(torch.int8).argmax(-1)
    evict_slot = torch.where(valids, stdevs, -inf).argmax(-1)
    slot = torch.where(can_fuse, fuse_slot, torch.where(
        can_gap, gap_slot, torch.where(has_free, free_slot, evict_slot)))
    pick = lambda a: a.gather(1, slot[:, None])[:, 0]
    m0, s0, h0 = pick(means), pick(stdevs), pick(heights)
    w1 = 1.0 / (s0 * s0).clamp(min=1e-12)
    w2 = 1.0 / var.clamp(min=1e-12)
    top = torch.maximum(m0, z)
    bottom = torch.minimum(m0 - h0, z)
    new_mean = torch.where(can_fuse, (m0 * w1 + z * w2) / (w1 + w2),
                           torch.where(can_gap, top, z))
    new_sd = torch.where(can_fuse, torch.sqrt(1.0 / (w1 + w2)),
                         torch.where(can_gap, torch.minimum(s0, torch.sqrt(var)),
                                     torch.sqrt(var)))
    new_h = torch.where(can_fuse, h0, torch.where(can_gap, top - bottom,
                                                  torch.zeros_like(top)))
    written = slot[:, None] == torch.arange(k, device=slot.device)[None]
    put = lambda old, v: torch.where(written, v[:, None], old)
    return {"mean": put(means, new_mean), "stdev": put(stdevs, new_sd),
            "height": put(heights, new_h), "valid": valids | written,
            "horiz": put(horiz, can_fuse | ~can_gap),
            "uidx": torch.where(written, torch.full_like(rows["uidx"],
                                                         update_idx),
                                rows["uidx"])}
