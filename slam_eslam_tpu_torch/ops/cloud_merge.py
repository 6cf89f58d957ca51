"""Cloud merge: the block merge of one shared cloud under every pose, for
clouds of any size, and its plain version.

Replaces no TPU kernel of its own: the JAX package merges a cloud with
``merge_blocks`` (K3) on operands ``[N, P]`` that it builds first.  K3's
CUDA kernel sorts one particle's points in one CTA's shared memory, so it
takes at most ``block_merge.MAX_POINTS`` (16,384) points, and its operand
rows grow with ``N * P``: a 640 x 480 distance image under 1,000 poses
would be ~11 GB of them.  ``cloud_merge`` takes the cloud ``[P]`` once
and the poses ``[N]`` and places the points inside the kernel
(``csrc/cloud_merge.cu``), as ``map_pool.merge_operands`` does, op for op;
the merge is then K3's: per touched cell of each particle's active block
``blk[n]``, the sums of ``w``, ``w * z`` (and ``w * colour``) over every
point of the cloud in the cell, added in point order, then the envire slot
rules once (``mls_grid.fuse_slot_rows``), stamped with ``update_idx``.
Merging a cloud in pieces would apply the slot rules once a piece and give
other maps.

``cloud_merge`` updates the pool fields **in place**: the CUDA kernel for
CUDA tensors, ``cloud_merge_reference`` for CPU tensors; there is no other
route.  ``cloud_merge.launches`` counts kernel launches.  Active blocks
must be unique; a ``blk`` outside ``[0, B)`` is skipped.  With
``counters`` (int64 ``[2]`` on the pool's device) the merge adds the valid
placements that fall in a block to ``counters[0]`` and the cells it wrote
to ``counters[1]`` (the tracer's ``merge.points`` and ``merge.cells``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from slam_eslam_tpu_torch.mapping.mls_grid import inverse_resolution
from slam_eslam_tpu_torch.ops import _build
from slam_eslam_tpu_torch.ops import block_merge as bm

# the particles a group of the plain version places at once: bounds its
# operand rows to about 2^24 elements each, whatever the cloud's size
PLAIN_ELEMENTS = 1 << 24


def cloud_bounds(xy, valid):
    """``[4]`` float32 on ``xy``'s device: the smallest and largest x, then
    y, of the valid points of ``xy [P, 2]`` (``+inf, -inf`` each where none
    is valid), reduced on the device."""
    inf = float("inf")
    x, y = xy[:, 0], xy[:, 1]
    return torch.stack([x.masked_fill(~valid, inf).amin(),
                        x.masked_fill(~valid, -inf).amax(),
                        y.masked_fill(~valid, inf).amin(),
                        y.masked_fill(~valid, -inf).amax()]).float()


def operands(origin, blk, x, y, cos, sin, z, z_sigma, cxy, cz, csd, cvalid,
             nx, ny, inv_res):
    """K3's operands ``(lx, ly, w, wz)`` ``[G, P]`` of the particles
    ``blk [G]`` (``map_pool.merge_operands``'s formulas; masked points at
    ``nx, ny`` with ``w = 0``)."""
    wx = cos[:, None] * cxy[None, :, 0] - sin[:, None] * cxy[None, :, 1] \
        + x[:, None]
    wy = sin[:, None] * cxy[None, :, 0] + cos[:, None] * cxy[None, :, 1] \
        + y[:, None]
    org = origin.index_select(0, blk.clamp(min=0).long())
    ix = torch.floor((wx - org[:, 0:1]) * inv_res).to(torch.int32)
    iy = torch.floor((wy - org[:, 1:2]) * inv_res).to(torch.int32)
    wzv = cz[None, :] + z[:, None]
    var = (csd ** 2)[None, :] + (z_sigma ** 2)[:, None]
    mask = ((ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
            & cvalid[None, :] & (blk >= 0)[:, None])
    w = torch.where(mask, 1.0 / var.clamp(min=1e-12), torch.zeros_like(var))
    return (torch.where(mask, ix, nx), torch.where(mask, iy, ny), w, w * wzv)


def cloud_merge_reference(mean, stdev, height, meta, color, origin, blk, x, y,
                          cos, sin, z, z_sigma, cxy, cz, csd, cvalid, ccolor,
                          update_idx, counters=None, *, k, resolution,
                          patch_thickness=0.1, gap_size=1.5):
    """The plain version: K3's operands (``operands``) of a group of
    particles at a time, merged by ``block_merge.block_merge_reference``
    (sums in point order, as the kernel's).  In place; any ``P``."""
    _, nx, nyk = mean.shape
    ny = nyk // k
    inv = inverse_resolution(resolution)
    blk = torch.where((blk >= 0) & (blk < mean.shape[0]), blk, -1)
    group = max(1, PLAIN_ELEMENTS // max(1, cxy.shape[0]))
    for lo in range(0, blk.shape[0], group):
        sl = slice(lo, lo + group)
        b = blk[sl]
        lx, ly, w, wz = operands(origin, b, x[sl], y[sl], cos[sl], sin[sl],
                                 z[sl], z_sigma[sl], cxy, cz, csd, cvalid,
                                 nx, ny, inv)
        if counters is not None:
            counters += touched(lx, ly, nx, ny)
        bm.block_merge_reference(
            mean, stdev, height, meta, color, b.clamp(min=0), lx, ly, w, wz,
            update_idx, ccolor if color is not None else None, k=k,
            patch_thickness=patch_thickness, gap_size=gap_size)


def touched(lx, ly, nx, ny):
    """``[2]`` int64: the in-block placements of operands ``lx, ly [G,
    P]`` and the distinct cells they hit (each row's own)."""
    hit = lx < nx
    lin = torch.where(hit, lx.long() * ny + ly, -1).sort(1).values
    first = torch.ones_like(lin, dtype=torch.bool)
    first[:, 1:] = lin[:, 1:] != lin[:, :-1]
    return torch.stack([hit.sum(), (first & (lin >= 0)).sum()])


@functools.cache
def _launcher():
    fn = _build.load("cloud_merge").cloud_merge_launch
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = ([ptr] * 20 + [i32] * 7 + [ptr] + [f32] * 3 + [ptr])
    fn.restype = ctypes.c_int
    return fn


def launch(mean, stdev, height, meta, color, origin, blk, x, y, cos, sin, z,
           z_sigma, cxy, cz, csd, cvalid, ccolor, bounds, update_idx,
           counters=None, *, k, resolution, patch_thickness=0.1,
           gap_size=1.5):
    """Launch the kernel on PyTorch's current stream: operands as
    ``cloud_merge`` takes them, already checked, ``bounds`` the cloud's
    (``cloud_bounds``), ``update_idx`` a 0-d int32 tensor on the device.
    In place; allocates nothing and reads nothing back."""
    b, nx, nyk = mean.shape
    device = mean.device
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(device):
        err = _launcher()(
            mean.data_ptr(), stdev.data_ptr(), height.data_ptr(),
            meta.data_ptr(), ptr(color), origin.data_ptr(), blk.data_ptr(),
            x.data_ptr(), y.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            z.data_ptr(), z_sigma.data_ptr(), cxy.data_ptr(), cz.data_ptr(),
            csd.data_ptr(), cvalid.data_ptr(),
            ptr(ccolor if color is not None else None), bounds.data_ptr(),
            ptr(counters), blk.shape[0], cxy.shape[0], b, nx, nyk // k, k,
            int(mean.dtype == torch.bfloat16), update_idx.data_ptr(),
            float(inverse_resolution(resolution)), float(patch_thickness),
            float(gap_size), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cloud_merge kernel launch failed: CUDA error "
                           f"{err}")
    cloud_merge.launches += 1


def cloud_merge(mean, stdev, height, meta, color, origin, blk, x, y, cos,
                sin, z, z_sigma, cxy, cz, csd, cvalid, ccolor, update_idx,
                counters=None, *, k, resolution, patch_thickness=0.1,
                gap_size=1.5):
    """Merge the cloud ``cxy [P, 2]``, ``cz``, ``csd [P]`` float32,
    ``cvalid [P]`` bool (``ccolor [P, 3]`` float32 for a colour pool),
    placed by each pose (``x, y``, the yaw's ``cos, sin``, lifted by ``z``
    and widened by ``z_sigma``, all ``[N]`` float32), into the active
    blocks ``blk [N]`` int32 of the pool fields (``block_merge.block_merge``'s
    ``mean, stdev, height, meta, color``) whose cell (0, 0) lies at
    ``origin [B, 2]`` float32, cells ``resolution`` m wide, in place.
    ``update_idx`` is a Python int or a 0-d int32 tensor on the pool's
    device.  See the module docstring."""
    device = mean.device
    kw = dict(k=k, resolution=resolution, patch_thickness=patch_thickness,
              gap_size=gap_size)
    if device.type == "cpu":
        cloud_merge_reference(mean, stdev, height, meta, color, origin, blk,
                              x, y, cos, sin, z, z_sigma, cxy, cz, csd,
                              cvalid, ccolor, update_idx, counters, **kw)
        return
    if device.type != "cuda":
        raise ValueError(f"cloud_merge runs on CPU or CUDA, not {device}")
    b, nx, nyk = mean.shape
    if nyk % k:
        raise ValueError(f"pool lane extent {nyk} is not a multiple of "
                         f"k={k}")
    n, p = blk.shape[0], cxy.shape[0]
    f32 = torch.float32
    _build.check_operand("mean", mean, (b, nx, nyk), _build.POOL_DTYPES,
                         device, _build.pool_align(mean.dtype, k))
    for name, t, dtype in (("stdev", stdev, mean.dtype),
                           ("height", height, mean.dtype),
                           ("meta", meta, torch.int32)):
        _build.check_operand(name, t, (b, nx, nyk), dtype, device,
                             _build.pool_align(dtype, k))
    checks = [("origin", origin, (b, 2), f32), ("blk", blk, (n,), torch.int32),
              ("cz", cz, (p,), f32),
              ("csd", csd, (p,), f32), ("cvalid", cvalid, (p,), torch.bool)]
    checks += [(name, t, (n,), f32) for name, t in (
        ("x", x), ("y", y), ("cos", cos), ("sin", sin), ("z", z),
        ("z_sigma", z_sigma))]
    if color is not None:
        checks += [("color", color, (b, nx, nyk * 3), mean.dtype),
                   ("ccolor", ccolor, (p, 3), f32)]
    if counters is not None:
        checks.append(("counters", counters, (2,), torch.int64))
    for name, t, shape, dtype in checks:
        _build.check_operand(name, t, shape, dtype, device)
    # a point's x and y are one 8-byte load
    _build.check_operand("cxy", cxy, (p, 2), f32, device, 8)
    update_idx = bm.device_update_idx(update_idx, device)
    launch(mean, stdev, height, meta, color, origin, blk, x, y, cos, sin, z,
           z_sigma, cxy, cz, csd, cvalid, ccolor, cloud_bounds(cxy, cvalid),
           update_idx, counters, **kw)


cloud_merge.launches = 0
