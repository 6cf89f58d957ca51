"""Row copy: the map pool's masked block copy, and its plain version.

Replaces no TPU kernel: the JAX package skips its pool-wide copy with
``lax.cond(any(mask))``, a read of the mask on the host, which a frame of
the port never makes.  For every ``i`` with ``mask[i]``, in every field of
``fields`` (block images ``[B, ...]`` of any dtype, each contiguous):

* ``field[dst[i]] = field[src[i]]`` (the copy form: ``src`` given);
* ``field[dst[i]] = fill[f][i]`` (the fill form: ``src`` None), or zeros
  where ``fill`` gives the field none.

Rows whose mask is off are neither read nor written.  The masked ``dst``
must be unique and none of them a masked row's ``src``, and every masked
``dst`` and ``src`` must lie in ``[0, B)``: outside it the plain version
raises ``IndexError`` and the kernel traps (the CUDA context is lost), as
an out-of-range ``index_copy_`` does.

``row_copy`` launches the CUDA kernel (``csrc/row_copy.cu``) for CUDA
tensors: one launch for all the fields, at a shape fixed by ``N`` and the
device, that reads the mask on the card and moves only the masked rows, so
a CUDA graph replays it whatever the mask holds.  For CPU tensors it runs
``row_copy_reference``; there is no other route.  ``row_copy.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from slam_eslam_tpu_torch.ops import _build

MAX_FIELDS = 8  # kMaxFields of csrc/row_copy.cu


def row_copy_reference(fields, dst, src, mask, fill=None):
    """The plain version: the masked rows picked on the host
    (``nonzero``, a host sync on a card), then per field one
    ``index_copy_`` of those rows alone.  In place; returns ``fields``."""
    fields = tuple(fields)
    fill = (None,) * len(fields) if fill is None else tuple(fill)
    rows = torch.nonzero(mask).reshape(-1)
    d = dst.index_select(0, rows).long()
    for field, values in zip(fields, fill):
        if src is not None:
            new = field.index_select(0, src.index_select(0, rows).long())
        elif values is None:
            new = field.new_zeros((rows.shape[0],) + field.shape[1:])
        else:
            new = values.index_select(0, rows)
        field.index_copy_(0, d, new)
    return fields


@functools.cache
def _launcher():
    fn = _build.load("row_copy").row_copy_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 3 + [i32] + [ptr] * 3 + [i32] * 2 + [ptr]
    fn.restype = ctypes.c_int
    return fn


def launch(fields, dst, src, mask, fill):
    """Launch the kernel on PyTorch's current stream: ``fields`` and
    ``fill`` tuples (``fill`` entries None for zeros), ``src`` or None,
    all as ``row_copy`` takes them, already checked.  Allocates nothing on
    the card and reads nothing back."""
    count = len(fields)
    device = fields[0].device
    ptrs = ctypes.c_void_p * count
    row_bytes = (ctypes.c_ulonglong * count)(
        *(f[0].numel() * f.element_size() for f in fields))
    with torch.cuda.device(device):
        err = _launcher()(
            ptrs(*(f.data_ptr() for f in fields)),
            ptrs(*(None if v is None else v.data_ptr() for v in fill)),
            row_bytes, count, dst.data_ptr(),
            None if src is None else src.data_ptr(), mask.data_ptr(),
            dst.shape[0], fields[0].shape[0],
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"row_copy kernel launch failed: CUDA error {err}")
    row_copy.launches += 1


def row_copy(fields, dst, src, mask, fill=None):
    """Copy (or fill) the rows ``dst[i]`` of every tensor of ``fields``
    where ``mask[i]``, in place; see the module docstring.  ``dst``,
    ``src`` ``[N]`` int32 (``src`` None: the fill form), ``mask`` ``[N]``
    bool, ``fill`` (the fill form only) None or one entry per field: None
    or ``[N, ...]`` rows of the field's shape and dtype.  Returns
    ``fields``."""
    fields = tuple(fields)
    if not 1 <= len(fields) <= MAX_FIELDS:
        raise ValueError(f"row_copy takes 1 to {MAX_FIELDS} fields, got "
                         f"{len(fields)}")
    fill = (None,) * len(fields) if fill is None else tuple(fill)
    if len(fill) != len(fields):
        raise ValueError("fill must hold one entry per field")
    if src is not None and any(v is not None for v in fill):
        raise ValueError("fill belongs to the fill form (src None)")
    device = fields[0].device
    if device.type == "cpu":
        return row_copy_reference(fields, dst, src, mask, fill)
    if device.type != "cuda":
        raise ValueError(f"row_copy runs on CPU or CUDA, not {device}")
    b, n = fields[0].shape[0], dst.shape[0]
    _build.check_operand("dst", dst, (n,), torch.int32, device)
    if src is not None:
        _build.check_operand("src", src, (n,), torch.int32, device)
    _build.check_operand("mask", mask, (n,), torch.bool, device)
    for i, (field, values) in enumerate(zip(fields, fill)):
        if field.shape[0] != b:
            raise ValueError(f"fields[{i}] has {field.shape[0]} rows, "
                             f"fields[0] {b}")
        _build.check_operand(f"fields[{i}]", field, field.shape,
                             field.dtype, device)
        if (field[0].numel() * field.element_size()) % 2:
            raise ValueError(f"fields[{i}] has rows of an odd byte count")
        if values is not None:
            _build.check_operand(f"fill[{i}]", values,
                                 (n,) + tuple(field.shape[1:]), field.dtype,
                                 device)
    launch(fields, dst, src, mask, fill)
    return fields


row_copy.launches = 0
