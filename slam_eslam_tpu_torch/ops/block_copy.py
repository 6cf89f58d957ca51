"""Block copy: kernel K7 and its plain version.

Replaces ``slam_eslam_tpu/utils/kernel_eff.py::_copy_all_kernel`` (in
``merge_floor_fraction``): the block merge "with the same grid spec,
block indexing, aliasing and operands and a passthrough body", the
traffic floor that the merge kernel's time is held against.  The probe
variants of ``tools/probe_merge_overhead.py`` that share that body are
the same function: ``copy_all`` (fields and points), ``copy_fields``
(``points=None``) and ``copy_packed`` (one packed field image of
``4 * nx`` rows).

``fields`` are block images ``[B, rows, cols]`` (float32, int32 or
bfloat16); for every particle ``n`` the kernel works on block ``blk[n]``
of each (a ``blk[n]`` outside ``[0, B)`` is skipped), in one of three
modes:

* ``"whole"``: every element of the block is copied from the input field
  to the same place in the output field, and the particle's point rows
  ``points = (lx, ly, w, wz)``, each ``[N, P]``, are read.  What the TPU
  kernel computes.
* ``"cells"``: the K slots of each cell ``(lx[n, j], ly[n, j])`` that an
  in-range point hits are copied (``cols = ny * k``), and the point's
  ``w`` and ``wz`` are read: the rows that the block merge of this port
  reads and writes, visited in its order (sorted by cell, once per
  distinct cell), with its sums and slot rules taken out.
* ``"points"``: the same rows copied with no sort either, in point order,
  a cell once per point that hits it; the result is that of ``"cells"``.
  Timed beside ``"cells"`` it tells what the merge's sort costs and saves.

``out=None`` copies in place (input and output alias, as in the merge);
otherwise ``out`` holds one tensor per field, and only the copied
elements of it change.  ``blk`` must be unique when ``out`` is given.

``block_copy`` launches the CUDA kernel (``csrc/block_copy.cu``) for CUDA
tensors and runs ``block_copy_reference`` for CPU tensors; there is no
other route.  ``block_copy.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from slam_eslam_tpu_torch.ops import _build

MODES = ("whole", "cells", "points")
MAX_FIELDS = 4  # kMaxFields of csrc/block_copy.cu
MAX_POINTS = 16384  # kMaxPoints of csrc/cell_sort.cuh (cells mode)
FIELD_DTYPES = (torch.float32, torch.int32, torch.bfloat16)


def hit_rows(blk, lx, ly, b, nx, ny):
    """Flat cell indices ``(b * nx + x) * ny + y`` ``[M]`` of the in-range
    points of particles whose block is valid (duplicates kept)."""
    ok = ((blk >= 0) & (blk < b))[:, None] & (
        (lx >= 0) & (lx < nx) & (ly >= 0) & (ly < ny))
    cell = (blk.long()[:, None] * nx + lx.long()) * ny + ly.long()
    return cell[ok]


def block_copy_reference(fields, blk, points=None, *, out=None,
                         mode="whole", k=4):
    """The plain version of the kernel, and the library call it is timed
    against: per field ``out.index_copy_(0, blk, in.index_select(0, blk))``
    for ``"whole"``, a gather and scatter of the hit cells' slot rows for
    ``"cells"`` and ``"points"``.  Returns the output fields."""
    out = fields if out is None else out
    b, rows, cols = fields[0].shape
    if mode == "whole":
        good = blk[(blk >= 0) & (blk < b)].long()
        for src, dst in zip(fields, out):
            dst.index_copy_(0, good, src.index_select(0, good))
    else:
        lx, ly, _, _ = points
        flat = (hit_rows(blk, lx, ly, b, rows, cols // k)[:, None] * k
                + torch.arange(k, device=blk.device))             # [M, K]
        for src, dst in zip(fields, out):
            dst.view(-1)[flat] = src.view(-1)[flat]
    return out


@functools.cache
def _launcher():
    fn = _build.load("block_copy").block_copy_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 3 + [i32] + [ptr] * 5 + [i32] * 7 + [ptr]
    fn.restype = ctypes.c_int
    return fn


def launch(fields, blk, points, out, *, mode="whole", k=4):
    """Launch the kernel on PyTorch's current stream: tuples ``fields`` and
    ``out`` (the same tuple for a copy in place), ``blk`` and ``points``
    (or None) as ``block_copy`` takes them, already checked.  Allocates
    nothing on the card and reads nothing back."""
    b, rows, cols = fields[0].shape
    n = blk.shape[0]
    device = fields[0].device
    p, point_ptrs = 0, [None] * 4
    if points is not None:
        p = points[0].shape[1]
        point_ptrs = [t.data_ptr() for t in points]
    count = len(fields)
    ptrs = ctypes.c_void_p * count
    with torch.cuda.device(device):
        err = _launcher()(
            ptrs(*(t.data_ptr() for t in fields)),
            ptrs(*(t.data_ptr() for t in out)),
            (ctypes.c_int * count)(*(t.element_size() for t in fields)),
            count, blk.data_ptr(), *point_ptrs, n, p, b, rows, cols, k,
            MODES.index(mode),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"block_copy kernel launch failed: CUDA error "
                           f"{err}")
    block_copy.launches += 1


def block_copy(fields, blk, points=None, *, out=None, mode="whole", k=4):
    """Copy block ``blk[n]`` of every tensor of ``fields`` (1 to 4 block
    images ``[B, rows, cols]``) into ``out`` (default: in place), whole or
    only the cells that ``points = (lx, ly, w, wz)`` hit (``"cells"``,
    ``"points"``).  Returns the output fields.  See the module docstring
    for the semantics."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode != "whole" and points is None:
        raise ValueError(f"mode={mode!r} copies the cells the points hit: "
                         f"give points=(lx, ly, w, wz)")
    fields = tuple(fields)
    if not 1 <= len(fields) <= MAX_FIELDS:
        raise ValueError(f"block_copy takes 1 to {MAX_FIELDS} fields, got "
                         f"{len(fields)}")
    out = fields if out is None else tuple(out)
    if len(out) != len(fields):
        raise ValueError("out must hold one tensor per field")
    device = fields[0].device
    if device.type == "cpu":
        return block_copy_reference(fields, blk, points, out=out, mode=mode,
                                    k=k)
    if device.type != "cuda":
        raise ValueError(f"block_copy runs on CPU or CUDA, not {device}")
    b, rows, cols = fields[0].shape
    if mode != "whole" and cols % k:
        raise ValueError(f"field lane extent {cols} is not a multiple of "
                         f"k={k}")
    if mode == "cells" and points[0].shape[1] > MAX_POINTS:
        raise ValueError(f"mode='cells' takes at most {MAX_POINTS} points "
                         f"per particle, got {points[0].shape[1]}")
    n = blk.shape[0]
    _build.check_operand("blk", blk, (n,), torch.int32, device)
    for i, (src, dst) in enumerate(zip(fields, out)):
        _build.check_operand(f"fields[{i}]", src, (b, rows, cols),
                             FIELD_DTYPES, device)
        _build.check_operand(f"out[{i}]", dst, (b, rows, cols), src.dtype,
                             device)
    if points is not None:
        p = points[0].shape[1]
        for name, t, dtype in zip(("lx", "ly", "w", "wz"), points,
                                  (torch.int32, torch.int32, torch.float32,
                                   torch.float32)):
            _build.check_operand(name, t, (n, p), dtype, device)
    launch(fields, blk, points, out, mode=mode, k=k)
    return out


block_copy.launches = 0
