"""Block merge: kernel K3 (which also serves K4) and its plain version.

Replaces ``slam_eslam_tpu/ops/pallas_merge.py::_merge_kernel`` (through
``merge_blocks``) and ``_merge_kernel_grouped`` (``merge_blocks_grouped``,
the same function with G blocks per grid step).  Operands follow
``merge_blocks``: each particle ``n`` fuses its points ``j`` at block-local
cells ``(lx[n, j], ly[n, j])`` (out of range = masked out) with
inverse-variance weights ``w`` and ``wz = w * z`` into its active block
``blk[n]``: per hit cell, ``z = sum wz / sum w`` and ``var = 1 / sum w``
go through the envire slot rules (``mls_grid.fuse_slot_rows``) and the
written slot is stamped ``meta = 1 | horizontal << 1 | update_idx << 2``.
A colour-carrying pool also takes the w-weighted mean ``point_color`` of
the cell's points in the written slot (the JAX XLA branch's rule).

``block_merge`` updates the pool fields **in place**: it launches the
CUDA kernel (``csrc/block_merge.cu``) for CUDA tensors and runs
``block_merge_reference`` for CPU tensors; there is no other route.
``block_merge.launches`` counts kernel launches.  Active blocks must be
unique (``map_pool.ensure_unique_active``); a shared block takes the
writes of its particles in unspecified order.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from slam_eslam_tpu_torch.mapping import mls_grid
from slam_eslam_tpu_torch.ops import _build

MAX_POINTS = 16384  # kMaxPoints of csrc/block_merge.cu


def block_merge_reference(mean, stdev, height, meta, color, blk, lx, ly, w,
                          wz, update_idx, point_color=None, *, k,
                          patch_thickness=0.1, gap_size=1.5):
    """The plain version of the kernel (the XLA branch of
    ``map_pool.merge_cloud_all``): a stable per-row sort by cell, run sums
    in point order (``mls_grid.run_sums_rows``), ``fuse_slot_rows`` on the
    gathered slot rows of one survivor per cell, and a scatter back.
    Updates the fields in place; reads hit cells back to the host."""
    _, nx, nyk = mean.shape
    ny = nyk // k
    ncells = nx * ny
    n, p = lx.shape
    inb = (lx >= 0) & (lx < nx) & (ly >= 0) & (ly < ny)
    lin = torch.where(inb, lx.long() * ny + ly.long(),
                      torch.full_like(lx, ncells, dtype=torch.long))
    cf = (None if color is None
          else point_color[None].expand(n, p, 3).to(torch.float32))
    lin_s, _, first, wsum, wzsum, csum = mls_grid.run_sums_rows(
        lin, w.float(), wz.float(), cf)
    rows, cols = torch.nonzero(first & (lin_s < ncells), as_tuple=True)
    cell = lin_s[rows, cols]
    ws = wsum[rows, cols].clamp(min=1e-30)
    z = wzsum[rows, cols] / ws
    var = 1.0 / ws

    slots = torch.arange(k, device=lx.device)
    flat = ((blk.long()[rows, None] * nx + (cell // ny)[:, None]) * nyk
            + (cell % ny)[:, None] * k + slots)                 # [M, K]
    gmeta = meta.view(-1)[flat]
    means, stdevs, heights, valids, horiz, uidx, upd = (
        mls_grid.fuse_slot_rows(
            mean.view(-1)[flat].float(), stdev.view(-1)[flat].float(),
            height.view(-1)[flat].float(), (gmeta & 1) != 0,
            (gmeta & 2) != 0, gmeta >> mls_grid.META_UIDX_SHIFT, z, var,
            torch.ones_like(z, dtype=torch.bool), update_idx,
            patch_thickness=patch_thickness, gap_size=gap_size))
    mean.view(-1)[flat] = means.to(mean.dtype)
    stdev.view(-1)[flat] = stdevs.to(stdev.dtype)
    height.view(-1)[flat] = heights.to(height.dtype)
    meta.view(-1)[flat] = mls_grid.pack_meta(valids, horiz, uidx)
    if color is not None:
        fcolor = csum[rows, cols] / ws[:, None]                 # [M, 3]
        flat3 = flat[..., None] * 3 + torch.arange(3, device=lx.device)
        cell_colors = torch.where(upd[..., None], fcolor[:, None, :],
                                  color.view(-1)[flat3].float())
        color.view(-1)[flat3] = cell_colors.to(color.dtype)


@functools.cache
def _launcher():
    fn = _build.load("block_merge").block_merge_launch
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [ptr] * 11 + [i32] * 7 + [f32] * 2 + [ptr]
    fn.restype = ctypes.c_int
    return fn


def block_merge(mean, stdev, height, meta, color, blk, lx, ly, w, wz,
                update_idx, point_color=None, *, k, patch_thickness=0.1,
                gap_size=1.5):
    """Merge ``[N, P]`` point operands into the active blocks ``blk [N]``
    of the pool fields ``mean, stdev, height`` (float32), ``meta``
    (int32), each ``[B, nx, ny*k]``, and ``color`` (``[B, nx, ny*k*3]``
    or None, then ``point_color [P, 3]``), in place.  ``update_idx`` is a
    Python int.  See the module docstring for the semantics."""
    device = mean.device
    kw = dict(k=k, patch_thickness=patch_thickness, gap_size=gap_size)
    if device.type == "cpu":
        block_merge_reference(mean, stdev, height, meta, color, blk, lx, ly,
                              w, wz, update_idx, point_color, **kw)
        return
    if device.type != "cuda":
        raise ValueError(f"block_merge runs on CPU or CUDA, not {device}")
    b, nx, nyk = mean.shape
    n, p = lx.shape
    if p > MAX_POINTS:
        raise ValueError(f"block_merge takes at most {MAX_POINTS} points "
                         f"per particle, got {p}: merge the cloud in chunks")
    if nyk % k:
        raise ValueError(f"pool lane extent {nyk} is not a multiple of "
                         f"k={k}")
    f32 = torch.float32
    align = 16 if k == 4 else None
    for name, t, dtype in (("mean", mean, f32), ("stdev", stdev, f32),
                           ("height", height, f32),
                           ("meta", meta, torch.int32)):
        _build.check_operand(name, t, (b, nx, nyk), dtype, device, align)
    for name, t, shape, dtype in (
            ("blk", blk, (n,), torch.int32),
            ("lx", lx, (n, p), torch.int32), ("ly", ly, (n, p), torch.int32),
            ("w", w, (n, p), f32), ("wz", wz, (n, p), f32)):
        _build.check_operand(name, t, shape, dtype, device)
    color_ptr = pcolor_ptr = None
    if color is not None:
        _build.check_operand("color", color, (b, nx, nyk * 3), f32, device)
        _build.check_operand("point_color", point_color, (p, 3), f32, device)
        color_ptr, pcolor_ptr = color.data_ptr(), point_color.data_ptr()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _launcher()(
            mean.data_ptr(), stdev.data_ptr(), height.data_ptr(),
            meta.data_ptr(), color_ptr, blk.data_ptr(), lx.data_ptr(),
            ly.data_ptr(), w.data_ptr(), wz.data_ptr(), pcolor_ptr,
            n, p, b, nx, nyk // k, k, int(update_idx),
            float(patch_thickness), float(gap_size), stream,
        )
    if err != 0:
        raise RuntimeError(f"block_merge kernel launch failed: CUDA error "
                           f"{err}")
    block_merge.launches += 1


block_merge.launches = 0
