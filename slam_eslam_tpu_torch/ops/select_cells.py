"""Select cells: kernel K5 and its plain PyTorch version.

Replaces the unfolded shared-grid lookup's TPU kernels in
``slam_eslam_tpu/ops/pallas_gather.py``: ``_fused_select_kernel_t``
(``window_select_t``, the default ``q_lanes`` layout), the ``q_flat``
and ``q_sublanes`` variants (``window_select_flat``, ``window_select``)
and the raw row gather ``_gather_kernel`` (``window_gather``, whose
select ran in XLA).  Per flat query: the cell, the z-window slot select
over its K slots and ``(found, mean, |stdev|)`` -- exactly
``mls_grid.get_patch_packed_cells``, which is the plain version.

``select_cells`` launches the CUDA kernel (``csrc/select_cells.cu``) for
CUDA tensors and runs the plain version for CPU tensors; there is no
other route.  ``select_cells.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from slam_eslam_tpu_torch.mapping import mls_grid
from slam_eslam_tpu_torch.ops import _build


def select_cells_reference(packed: mls_grid.PackedLookup, queries,
                           z_window=3.0):
    """The plain version: world queries ``(x, y, z)`` go through
    ``mls_grid.cells``, int32 cell queries ``(ix, iy, z)`` straight to
    ``get_patch_packed_cells``."""
    a, b, zq = queries
    if a.dtype != torch.int32:
        a, b = mls_grid.cells(packed, a, b)
    return mls_grid.get_patch_packed_cells(packed, a, b, zq, z_window)


@functools.cache
def _launchers():
    lib = _build.load("select_cells")
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    world = lib.select_world_launch
    world.argtypes = [ptr] * 8 + [i64, i32, i32, i32, f32, f32, ptr]
    world.restype = ctypes.c_int
    cells = lib.select_cells_launch
    cells.argtypes = [ptr] * 7 + [i64, i32, i32, i32, f32, ptr]
    cells.restype = ctypes.c_int
    return world, cells


def select_cells(packed: mls_grid.PackedLookup, queries, z_window=3.0):
    """Z-window patch select of ``queries`` against the packed grid:
    world coordinates ``(x, y, z)`` (float32) or cells ``(ix, iy, z)``
    (int32 cells, unclamped), all three of one shape.  Returns ``(found
    bool, mean, stdev)`` of that shape; ``stdev`` is non-negative, and a
    miss carries slot 0 of its cell (of cell (0, 0) outside the grid).

    CPU tensors take ``select_cells_reference``; CUDA tensors launch the
    kernel, which reads the grid in place."""
    a, b, zq = queries
    device = packed.data.device
    if device.type == "cpu":
        return select_cells_reference(packed, queries, z_window)
    if device.type != "cuda":
        raise ValueError(f"select_cells runs on CPU or CUDA, not {device}")
    nx, ny, k2 = packed.data.shape
    k = k2 // 2
    shape = zq.shape
    cell_queries = a.dtype == torch.int32
    qdtype = torch.int32 if cell_queries else torch.float32
    a, b, zq = (t.reshape(-1).contiguous() for t in (a, b, zq))
    q = zq.numel()
    f32 = torch.float32
    _build.check_operand("packed.data", packed.data, (nx, ny, k2), f32,
                         device, 16 if k == 4 else None)
    _build.check_operand("packed.origin", packed.origin, (2,), f32, device)
    for name, t, dtype in (("x/ix", a, qdtype), ("y/iy", b, qdtype),
                           ("z", zq, f32)):
        _build.check_operand(name, t, (q,), dtype, device)
    found = torch.empty(q, dtype=torch.bool, device=device)
    mean = torch.empty(q, dtype=f32, device=device)
    stdev = torch.empty(q, dtype=f32, device=device)
    world, cells = _launchers()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        outs = (found.data_ptr(), mean.data_ptr(), stdev.data_ptr())
        if cell_queries:
            err = cells(packed.data.data_ptr(), a.data_ptr(), b.data_ptr(),
                        zq.data_ptr(), *outs, q, nx, ny, k, float(z_window),
                        stream)
        else:
            err = world(packed.data.data_ptr(), packed.origin.data_ptr(),
                        a.data_ptr(), b.data_ptr(), zq.data_ptr(), *outs, q,
                        nx, ny, k,
                        mls_grid.inverse_resolution(packed.resolution),
                        float(z_window), stream)
    if err != 0:
        raise RuntimeError(f"select_cells kernel launch failed: CUDA error "
                           f"{err}")
    select_cells.launches += 1
    return found.reshape(shape), mean.reshape(shape), stdev.reshape(shape)


select_cells.launches = 0
