"""Block merge: kernel K3 (which also serves K4 and P4) and its plain
versions.

Replaces ``slam_eslam_tpu/ops/pallas_merge.py::_merge_kernel`` (through
``merge_blocks``) and ``_merge_kernel_grouped`` (``merge_blocks_grouped``,
the same function with G blocks per grid step).  Operands follow
``merge_blocks``: each particle ``n`` fuses its points ``j`` at block-local
cells ``(lx[n, j], ly[n, j])`` (out of range = masked out) with
inverse-variance weights ``w`` and ``wz = w * z`` into its active block
``blk[n]``: per hit cell, ``z = sum wz / sum w`` and ``var = 1 / sum w``
go through the envire slot rules (``mls_grid.fuse_slot_rows``) and the
written slot is stamped ``meta = 1 | horizontal << 1 | update_idx << 2``.
The kernel reads ``update_idx`` from a 0-d int32 tensor on the device, so a
merge captured into a CUDA graph stamps whatever that tensor holds at each
replay; the wrappers also take a Python int, which they write into a new
device scalar (one fill kernel, no host-to-device copy).
A colour-carrying pool also takes the w-weighted mean ``point_color`` of
the cell's points in the written slot (the JAX XLA branch's rule).

``block_merge`` updates the pool fields **in place**: it launches the
CUDA kernel (``csrc/block_merge.cu``) for CUDA tensors and runs
``block_merge_reference`` for CPU tensors; there is no other route.
``block_merge.launches`` counts kernel launches.  Active blocks must be
unique (``map_pool.ensure_unique_active``); a shared block takes the
writes of its particles in unspecified order.

``block_merge_packed`` is the same merge on the packed block image of
``tools/probe_merge_overhead.py::merge_packed`` (its
``_merge_packed_kernel``, probe kernel P4): one float32 tensor ``[B, 4*nx,
ny*k]`` whose rows ``[0, nx)`` are a block's mean, ``[nx, 2nx)`` its stdev,
``[2nx, 3nx)`` its height and ``[3nx, 4nx)`` its meta words as int32 bits
(``pack_fields``, ``packed_fields``).  It launches the same CUDA kernel
through its own entry point, with the four field bases ``nx*ny*k``
elements apart and a block stride of four fields, counts its launches in
``block_merge_packed.launches`` and runs ``block_merge_packed_reference``
for CPU tensors.  On the TPU the packed image probes the cost of issuing
four DMAs per block instead of one; on a GPU it probes whether a cell's
four loads and stores are cheaper 26 KB apart than a field tensor apart.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from slam_eslam_tpu_torch.mapping import mls_grid
from slam_eslam_tpu_torch.ops import _build

MAX_POINTS = 16384  # kMaxPoints of csrc/cell_sort.cuh


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


def device_update_idx(update_idx, device):
    """``update_idx`` as the kernel reads it: a 0-d int32 tensor on
    ``device`` (checked), or a Python int written into a new one with a
    fill kernel (a tensor built from a host value would be a blocking
    copy)."""
    if not torch.is_tensor(update_idx):
        return torch.full((), int(update_idx), dtype=torch.int32,
                          device=device)
    _build.check_operand("update_idx", update_idx, (), torch.int32, device)
    return update_idx


@functools.cache
def _launcher():
    fn = _build.load("block_merge").block_merge_launch
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [ptr] * 11 + [i32] * 7 + [ptr] + [f32] * 2 + [ptr]
    fn.restype = ctypes.c_int
    return fn


def launch(mean, stdev, height, meta, color, blk, lx, ly, w, wz, update_idx,
           point_color=None, *, k, patch_thickness=0.1, gap_size=1.5):
    """Launch the merge kernel on PyTorch's current stream: operands as
    ``block_merge`` takes them, already checked, ``update_idx`` a 0-d
    int32 tensor on the device.  In place; allocates nothing and reads
    nothing back."""
    b, nx, nyk = mean.shape
    n, p = lx.shape
    device = mean.device
    color_ptr = pcolor_ptr = None
    if color is not None:
        color_ptr, pcolor_ptr = color.data_ptr(), point_color.data_ptr()
    with torch.cuda.device(device):
        err = _launcher()(
            mean.data_ptr(), stdev.data_ptr(), height.data_ptr(),
            meta.data_ptr(), color_ptr, blk.data_ptr(), lx.data_ptr(),
            ly.data_ptr(), w.data_ptr(), wz.data_ptr(), pcolor_ptr,
            n, p, b, nx, nyk // k, k, int(mean.dtype == torch.bfloat16),
            update_idx.data_ptr(), float(patch_thickness), float(gap_size),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"block_merge kernel launch failed: CUDA error "
                           f"{err}")
    block_merge.launches += 1


def block_merge(mean, stdev, height, meta, color, blk, lx, ly, w, wz,
                update_idx, point_color=None, *, k, patch_thickness=0.1,
                gap_size=1.5):
    """Merge ``[N, P]`` point operands into the active blocks ``blk [N]``
    of the pool fields ``mean, stdev, height`` (all float32 or all
    bfloat16), ``meta`` (int32), each ``[B, nx, ny*k]``, and ``color``
    (``[B, nx, ny*k*3]`` of the same dtype, or None; then ``point_color
    [P, 3]`` float32), in place.  A bfloat16 pool is read up to float32,
    fused in float32 and rounded once (to nearest even) where a slot is
    written.  ``update_idx`` is a Python int or a 0-d int32 tensor on the
    pool's device.  See the module docstring for the semantics."""
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
                         f"per particle, got {p}: a larger cloud shared by "
                         f"every particle takes ops.cloud_merge "
                         f"(map_pool.merge_cloud_all picks it)")
    if nyk % k:
        raise ValueError(f"pool lane extent {nyk} is not a multiple of "
                         f"k={k}")
    f32 = torch.float32
    _build.check_operand("mean", mean, (b, nx, nyk), _build.POOL_DTYPES,
                         device, _build.pool_align(mean.dtype, k))
    for name, t, dtype in (("stdev", stdev, mean.dtype),
                           ("height", height, mean.dtype),
                           ("meta", meta, torch.int32)):
        _build.check_operand(name, t, (b, nx, nyk), dtype, device,
                             _build.pool_align(dtype, k))
    for name, t, shape, dtype in (
            ("blk", blk, (n,), torch.int32),
            ("lx", lx, (n, p), torch.int32), ("ly", ly, (n, p), torch.int32),
            ("w", w, (n, p), f32), ("wz", wz, (n, p), f32)):
        _build.check_operand(name, t, shape, dtype, device)
    update_idx = device_update_idx(update_idx, device)
    if color is not None:
        _build.check_operand("color", color, (b, nx, nyk * 3), mean.dtype,
                             device)
        _build.check_operand("point_color", point_color, (p, 3), f32, device)
    launch(mean, stdev, height, meta, color, blk, lx, ly, w, wz, update_idx,
           point_color, k=k, patch_thickness=patch_thickness,
           gap_size=gap_size)


block_merge.launches = 0


def pack_fields(mean, stdev, height, meta):
    """Four float32/int32 fields ``[B, nx, ny*k]`` -> the packed block
    image ``[B, 4*nx, ny*k]`` float32, meta carried as bits.  The copy goes
    through int32 words, so no meta word meets float arithmetic."""
    for name, t in (("mean", mean), ("stdev", stdev), ("height", height)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}: a packed block "
                            f"image is float32 (its meta rows are 32-bit "
                            f"words)")
    if meta.dtype != torch.int32:
        raise TypeError(f"meta has dtype {meta.dtype}, expected torch.int32")
    bits = lambda t: t.contiguous().view(torch.int32)
    return torch.cat([bits(mean), bits(stdev), bits(height), meta],
                     dim=1).view(torch.float32)


def packed_fields(packed, nx):
    """Contiguous copies ``(mean, stdev, height, meta)`` of the four row
    ranges of a packed block image (meta as int32)."""
    words = packed.view(torch.int32)
    part = lambda i: words[:, i * nx:(i + 1) * nx].contiguous()
    return (part(0).view(torch.float32), part(1).view(torch.float32),
            part(2).view(torch.float32), part(3))


def _check_packed(packed, nx, k):
    if packed.dtype != torch.float32:
        raise TypeError(f"packed has dtype {packed.dtype}: a packed block "
                        f"image is float32 (a 16-bit image cannot carry the "
                        f"32-bit meta words)")
    if packed.dim() != 3 or packed.shape[1] != 4 * nx:
        raise ValueError(f"packed has shape {tuple(packed.shape)}, expected "
                         f"[B, {4 * nx}, ny*k]")
    if packed.shape[2] % k:
        raise ValueError(f"packed lane extent {packed.shape[2]} is not a "
                         f"multiple of k={k}")


def block_merge_packed_reference(packed, blk, lx, ly, w, wz, update_idx, *,
                                 nx, k, patch_thickness=0.1, gap_size=1.5):
    """The plain version of ``block_merge_packed``: the four row ranges
    taken out (``packed_fields``), ``block_merge_reference`` on them, and
    the results written back through int32 words.  In place."""
    _check_packed(packed, nx, k)
    fields = packed_fields(packed, nx)
    block_merge_reference(*fields, None, blk, lx, ly, w, wz, update_idx,
                          k=k, patch_thickness=patch_thickness,
                          gap_size=gap_size)
    words = packed.view(torch.int32)
    for i, f in enumerate(fields):
        words[:, i * nx:(i + 1) * nx] = f.view(torch.int32)


@functools.cache
def _packed_launcher():
    fn = _build.load("block_merge").block_merge_packed_launch
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [ptr] * 6 + [i32] * 6 + [ptr] + [f32] * 2 + [ptr]
    fn.restype = ctypes.c_int
    return fn


def launch_packed(packed, blk, lx, ly, w, wz, update_idx, *, nx, k,
                  patch_thickness=0.1, gap_size=1.5):
    """Launch the merge kernel's packed entry point on PyTorch's current
    stream: operands as ``block_merge_packed`` takes them, already
    checked, ``update_idx`` a 0-d int32 tensor on the device.  In place;
    allocates nothing and reads nothing back."""
    b, _, nyk = packed.shape
    n, p = lx.shape
    device = packed.device
    with torch.cuda.device(device):
        err = _packed_launcher()(
            packed.data_ptr(), blk.data_ptr(), lx.data_ptr(), ly.data_ptr(),
            w.data_ptr(), wz.data_ptr(), n, p, b, nx, nyk // k, k,
            update_idx.data_ptr(), float(patch_thickness), float(gap_size),
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"block_merge_packed kernel launch failed: CUDA "
                           f"error {err}")
    block_merge_packed.launches += 1


def block_merge_packed(packed, blk, lx, ly, w, wz, update_idx, *, nx, k,
                       patch_thickness=0.1, gap_size=1.5):
    """``block_merge`` on a packed block image ``packed [B, 4*nx, ny*k]``
    float32 (module docstring), in place: point operands ``blk [N]``,
    ``lx, ly [N, P]`` int32 and ``w, wz [N, P]`` float32 as ``block_merge``
    takes them, unique active blocks, no colour.  ``update_idx`` is a
    Python int or a 0-d int32 tensor on the image's device."""
    device = packed.device
    kw = dict(nx=nx, k=k, patch_thickness=patch_thickness, gap_size=gap_size)
    if device.type == "cpu":
        block_merge_packed_reference(packed, blk, lx, ly, w, wz, update_idx,
                                     **kw)
        return
    if device.type != "cuda":
        raise ValueError(f"block_merge_packed runs on CPU or CUDA, not "
                         f"{device}")
    _check_packed(packed, nx, k)
    b, _, nyk = packed.shape
    n, p = lx.shape
    if p > MAX_POINTS:
        raise ValueError(f"block_merge_packed takes at most {MAX_POINTS} "
                         f"points per particle, got {p}")
    f32 = torch.float32
    align = _build.pool_align(f32, k)
    _build.check_operand("packed", packed, (b, 4 * nx, nyk), f32, device,
                         align)
    if align and (nx * nyk * 4) % align:
        raise ValueError(f"a field of {nx}x{nyk} slots does not keep the "
                         f"field sub-images {align}-byte aligned")
    for name, t, shape, dtype in (
            ("blk", blk, (n,), torch.int32),
            ("lx", lx, (n, p), torch.int32), ("ly", ly, (n, p), torch.int32),
            ("w", w, (n, p), f32), ("wz", wz, (n, p), f32)):
        _build.check_operand(name, t, shape, dtype, device)
    update_idx = device_update_idx(update_idx, device)
    launch_packed(packed, blk, lx, ly, w, wz, update_idx, **kw)


block_merge_packed.launches = 0
