"""Plain reference of the camera's distance-image update, in PyTorch.

The semantics of the reference filter's distance-image update
(``EmbodiedSlamFilter::update(DistanceImage)``,
``EmbodiedSlamFilter.cpp:239-309``) and of the map update it calls
(``processMap``, ``:179-232``), written from the published description
and nothing of the program under test:

* ``image_points``: the distance image through its pinhole intrinsics
  (``DistanceGridToPointcloud``): pixel ``(u, v)`` at distance ``d`` is
  the camera-frame point ``((u * scale_x + center_x) d, (v * scale_y +
  center_y) d, d)``, row-major; a pixel is valid when ``d`` is finite,
  positive and below the sensor's range.
* ``image_cloud``: the points through the camera's mount into the body
  frame, then into the yaw-free frame of the body's orientation, with a
  height deviation per point (``MLSProjection`` with ``useUncertainty``:
  the sensor's 0.02 m, a 5 degree sensor-yaw error over the point's
  horizontal lever in the body frame scaled by the body's tilt, a 3
  degree pitch and roll error over its horizontal lever), and the texture
  as the points' colour (``SurfacePatch.color``).
* ``heads``: the head grid each particle merges into: its own, unless
  the particle is farther than ``threshold`` along x or y from the head
  grid's centre, when a new empty grid centred on the particle starts
  (``MLSMap::selectActiveGrid``); the copy-on-write copy changes no
  particle's map.
* ``merge``: the cloud, placed by each particle's pose, fused per cell:
  the inverse-variance mean of the cell's points and their weighted mean
  colour, into the head grid by the envire ``MLSGrid::updateCell`` rules
  (``benchmark.reference.slam.update_cells``), the written slot stamped
  with the update index and given the cell's colour.

A head grid is held as a window of ``W x W`` cells of each particle's
grid (``lo``: its first cell; ``extent``: the grid's cells), so that a few
particles' maps at a camera's reach stay small; every point of the cloud
has to fall in the window or outside the grid (``merge`` counts those
that do not).

Departures from the published code, each the repository's own
configuration: the camera is the robot's only mapping sensor and is
merged on every camera frame past its own motion gate; no negative
information and no visual match (``processMap(scanMap, false, true)``);
the colour of a written slot is the weighted mean colour of the cell's
points, where envire keeps the colour of the last point.

Arithmetic is float32 by default, with TF32 off; ``sum_dtype`` is the
type the per-cell sums are taken in (a lower one for the control).
"""

from __future__ import annotations

import torch

from benchmark.reference.localization import rotate, strip_yaw
from benchmark.reference.slam import (PITCH_ROLL_SIGMA, SCAN_ANGLE_SIGMA,
                                      SENSOR_SIGMA, update_cells)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FIELDS = ("mean", "stdev", "height", "valid", "horiz", "uidx", "color")


def image_points(depth, intrinsics, max_range, dtype=torch.float32):
    """``(points [H * W, 3], valid [H * W])`` in the camera frame of the
    distance image ``depth [H, W]`` with ``intrinsics = (scale_x, scale_y,
    center_x, center_y)``."""
    h, w = depth.shape
    d = depth.reshape(-1).to(dtype)
    sx, sy, cx, cy = (float(v) for v in intrinsics)
    u = torch.arange(w, dtype=dtype, device=d.device).repeat(h)
    v = torch.arange(h, dtype=dtype, device=d.device).repeat_interleave(w)
    valid = torch.isfinite(d) & (d > 0) & (d < max_range)
    d = torch.where(valid, d, torch.zeros_like(d))
    return torch.stack([(u * sx + cx) * d, (v * sy + cy) * d, d], -1), valid


def image_cloud(depth, intrinsics, max_range, q, rot, trans, texture=None,
                dtype=torch.float32):
    """The image as a cloud in the yaw-free body frame: ``(xy [P, 2], z
    [P], stdev [P], valid [P], color [P, 3])``; ``rot [3, 3]``, ``trans
    [3]``: camera to body; ``q``: the body's orientation (w, x, y, z);
    ``texture [H, W, 3]`` in [0, 1] (zeros without one)."""
    pts, valid = image_points(depth, intrinsics, max_range, dtype)
    body = pts @ rot.to(dtype).T + trans.to(dtype)
    q0 = strip_yaw(q.to(dtype))
    world = rotate(q0[None], body)
    up = rotate(q0, torch.tensor([0.0, 0.0, 1.0], dtype=dtype,
                                 device=pts.device))
    tilt = torch.arccos(up[2].clamp(-1.0, 1.0))
    dz_sensor = (SCAN_ANGLE_SIGMA * torch.linalg.vector_norm(body[:, :2], dim=-1)
                 * torch.sin(tilt).abs())
    dz_body = PITCH_ROLL_SIGMA * torch.linalg.vector_norm(world[:, :2], dim=-1)
    sd = torch.sqrt(SENSOR_SIGMA ** 2 + dz_sensor ** 2 + dz_body ** 2)
    color = (torch.zeros_like(pts) if texture is None
             else texture.reshape(-1, 3).to(dtype))
    return world[:, :2], world[:, 2], sd, valid, color


def heads(origin, x, y, res, extent, threshold):
    """``(origin [S, 2], rolled [S])``: the head grid's origin each
    particle at ``x, y [S]`` merges into, from its head's ``origin``; a
    rolled particle's head is a new empty grid centred on it."""
    hx, hy = extent[0] * res / 2.0, extent[1] * res / 2.0
    rolled = (((x - (origin[:, 0] + hx)).abs() > threshold)
              | ((y - (origin[:, 1] + hy)).abs() > threshold))
    new = torch.stack([x - hx, y - hy], -1).to(origin.dtype)
    return torch.where(rolled[:, None], new, origin), rolled


def empty_window(like):
    """A window of the shape of ``like`` with no valid slot."""
    return {k: torch.zeros_like(v) for k, v in like.items()}


def merge(win, origin, lo, extent, x, y, yaw, z, z_sigma, cloud, update_idx,
          res, thickness, gap, sum_dtype=None):
    """The cloud ``(xy, z, stdev, valid, color)`` merged into each
    particle's head window ``win`` (``FIELDS`` of ``[S, W, W, K]``, colour
    ``[S, W, W, K, 3]``) of the grid at ``origin [S, 2]`` whose cell ``lo
    [S, 2]`` is the window's first.  Returns ``(window, cells written,
    points in the grid but outside the window)``."""
    xy_c, z_c, sd_c, valid, col = cloud
    s_, w_, _, _ = win["mean"].shape
    dt = win["mean"].dtype
    sdt = dt if sum_dtype is None else sum_dtype
    c, s = torch.cos(yaw), torch.sin(yaw)
    wx = c[:, None] * xy_c[None, :, 0] - s[:, None] * xy_c[None, :, 1] + x[:, None]
    wy = s[:, None] * xy_c[None, :, 0] + c[:, None] * xy_c[None, :, 1] + y[:, None]
    ix = torch.floor((wx - origin[:, :1]) / res).long()
    iy = torch.floor((wy - origin[:, 1:]) / res).long()
    in_grid = (valid[None] & (ix >= 0) & (ix < extent[0]) & (iy >= 0)
               & (iy < extent[1]))
    jx, jy = ix - lo[:, :1], iy - lo[:, 1:]
    in_win = (jx >= 0) & (jx < w_) & (jy >= 0) & (jy < w_)
    beyond = int((in_grid & ~in_win).sum())
    hit = in_grid & in_win
    var = sd_c[None] ** 2 + z_sigma[:, None] ** 2
    w = torch.where(hit, 1.0 / var, torch.zeros_like(var)).to(sdt)
    wz = (z_c[None] + z[:, None]).to(sdt)
    lin = torch.where(hit, jx * w_ + jy, torch.full_like(jx, w_ * w_))
    sums = torch.zeros(5, s_, w_ * w_ + 1, dtype=sdt, device=w.device)
    for i, v in enumerate((w, w * wz, *(w * col[None, :, j].to(sdt)
                                        for j in range(3)))):
        sums[i].scatter_add_(1, lin, v)
    sums = sums[:, :, :-1].to(dt)
    wsum = sums[0]
    touched = wsum > 0
    sel = touched.nonzero(as_tuple=True)
    mz = sums[1][sel] / wsum[sel]
    mvar = 1.0 / wsum[sel]
    out = {k: v.clone() for k, v in win.items()}
    flat = {k: out[k].reshape(s_, w_ * w_, *out[k].shape[3:]) for k in FIELDS}
    rows = {k: flat[k][sel] for k in FIELDS if k != "color"}
    # the written slot is the one stamped: stamped first with a mark no
    # slot holds (stamps are not negative), then with the update index
    new = update_cells(rows, mz, mvar, -1, thickness, gap)
    at = new["uidx"] == -1                                      # [M, K]
    new["uidx"] = torch.where(at, torch.full_like(new["uidx"], update_idx),
                              new["uidx"])
    cell_col = torch.stack([sums[2 + j][sel] / wsum[sel] for j in range(3)],
                           -1)                                  # [M, 3]
    new["color"] = torch.where(at[..., None], cell_col[:, None, :],
                               flat["color"][sel])
    for kk in FIELDS:
        flat[kk][sel] = new[kk]
        out[kk] = flat[kk].reshape(out[kk].shape)
    return out, int(touched.sum()), beyond


def rolled_levels(chain_origin, head_origin, rolled):
    """The chain's level origins ``[S, L, 2]`` after the heads: a rolled
    particle's chain moves down one level under its new head (the oldest
    level dropped); ``chain_origin`` NaN where a level is empty."""
    shifted = torch.cat([head_origin[:, None], chain_origin[:, :-1]], 1)
    out = torch.where(rolled[:, None, None], shifted, chain_origin)
    out[:, 0] = head_origin
    return out


def cell_changes(want, got, value_tol, color_tol):
    """Cells of windows ``want`` that ``got`` holds otherwise: a slot's
    valid bit, or a valid slot's horizontal bit, stamp, mean, stdev,
    height (by more than ``value_tol``) or colour (by more than
    ``color_tol``).  ``[S, W, W]`` bool."""
    v = want["valid"]
    bad = (v != got["valid"]) | (v & (
        (want["horiz"] != got["horiz"]) | (want["uidx"] != got["uidx"])
        | ((want["mean"] - got["mean"]).abs() > value_tol)
        | ((want["stdev"] - got["stdev"]).abs() > value_tol)
        | ((want["height"] - got["height"]).abs() > value_tol)
        | ((want["color"] - got["color"]).abs().amax(-1) > color_tol)))
    return bad.any(-1)
