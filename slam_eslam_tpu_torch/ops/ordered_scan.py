"""Ordered scan: kernel S1 and its plain version.

An inclusive float32 prefix sum whose additions happen in one fixed
order, so that it gives the same bits on every call, on the card and on
the CPU.  It replaces ``torch.cumsum`` where the port searches cumulative
weights (``core.filter.resample_from_positions``, ``core.gmm.fit_gmm``,
``tools.profile_resample``): on the card ``torch.cumsum`` of float32 is
not repeatable, and on a device mesh every rank must find the same
ancestors in the same all-gathered weights.  No TPU kernel stands behind
it (the JAX package's XLA cumsum repeats itself).

The order is the JAX package's own on the CPU (XLA's rewrite of a
prefix-sum reduce-window), so the port searches the very cumulative
weights that the JAX package searches: up to ``ROW`` elements a
sequential sum; above, the input padded with zeros to rows of ``ROW`` is
summed in sequence inside each row, the row totals are scanned by the same
rule, recursively, and each row then adds the scanned total of the row
before it (``csrc/ordered_scan.cu``).  ``ordered_scan_reference`` repeats
that order with elementwise adds, and IEEE addition makes the kernel and
it equal bit for bit.

``ordered_scan`` launches the CUDA kernel for CUDA tensors and runs
``ordered_scan_reference`` for CPU tensors; there is no other route.
``ordered_scan.launches`` counts calls that launched the kernel (a call
is one kernel launch up to ``SMALL`` elements and three or more above).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from slam_eslam_tpu_torch.ops import _build

ROW = 16      # kRow of csrc/ordered_scan.cu
SMALL = 8192  # kSmall: the largest size one CTA scans


def scratch_size(n):
    """Floats of scratch the kernel needs for ``n`` elements: the row
    totals of every level above ``SMALL`` elements."""
    total = 0
    while n > SMALL:
        n = -(-n // ROW)
        total += n
    return total


def ordered_scan_reference(x):
    """The plain version: the kernel's order of additions, on any device.
    ``x [N]`` float32; returns ``[N]``."""
    n = x.shape[0]
    if n <= ROW:
        cols = list(x.unbind(0))
        for j in range(1, n):
            cols[j] = cols[j - 1] + cols[j]
        return torch.stack(cols) if n else x.clone()
    rows = -(-n // ROW)
    p = torch.nn.functional.pad(x, (0, rows * ROW - n)).reshape(rows, ROW)
    cols = [p[:, 0]]
    for j in range(1, ROW):
        cols.append(cols[-1] + p[:, j])
    loc = torch.stack(cols, dim=1)
    tot = ordered_scan_reference(loc[:, -1].contiguous())
    carry = torch.cat([tot.new_zeros(1), tot[:-1]])
    return (loc + carry[:, None]).reshape(-1)[:n]


@functools.cache
def _launcher():
    fn = _build.load("ordered_scan").ordered_scan_launch
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr, ptr, ptr, ctypes.c_longlong, ptr]
    fn.restype = ctypes.c_int
    return fn


def launch(x, out, scratch):
    """Launch the kernel on PyTorch's current stream: ``x`` and ``out``
    ``[N]`` float32 and ``scratch`` of ``scratch_size(N)`` floats, on one
    card, already checked.  Allocates nothing and reads nothing back."""
    device = x.device
    with torch.cuda.device(device):
        err = _launcher()(
            x.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch.numel() else None, x.shape[0],
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ordered_scan kernel launch failed: CUDA error "
                           f"{err}")
    ordered_scan.launches += 1


def ordered_scan(x):
    """Inclusive prefix sum of ``x [N]`` (float32) in the fixed order of
    the module docstring: the same bits on every call and every device."""
    if x.dim() != 1:
        raise ValueError(f"ordered_scan takes a 1-D tensor, got shape "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return ordered_scan_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"ordered_scan runs on CPU or CUDA, not "
                         f"{x.device}")
    n = x.shape[0]
    x = x.contiguous()
    _build.check_operand("x", x, (n,), torch.float32, x.device)
    out = torch.empty_like(x)
    scratch = torch.empty(scratch_size(n), dtype=torch.float32,
                          device=x.device)
    launch(x, out, scratch)
    return out


ordered_scan.launches = 0
