"""Scatter-adds of floats in one fixed order.

The JAX package's ``.at[].add`` and ``segment_sum`` add each index's
values in index order on the CPU, the same on every call.  PyTorch's
float scatter-adds do not, on every device: ``index_add_`` and
``scatter_add_`` add with atomics on the card, and on the CPU a large
``index_put_(accumulate=True)`` is split over threads that race.  Every
float scatter-add of the port goes through ``add_at``, which picks the
operation that adds in one fixed order on each device, so a call repeats
bit for bit (graphed or eager).  On the CPU that order is the index order,
and the sums equal the JAX package's CPU sums; on the card, for
one-dimensional values, it is another, so there the sums agree with the
CPU's to rounding only.  Integer scatter-adds and ``amin``/``amax``
reductions are exact in any order and stay as they are.
"""

from __future__ import annotations

import torch


def add_at(target, idx, values):
    """``target[idx] += values`` along dim 0, in place; returns
    ``target``.  Each index's values are added in one fixed order:
    ``index_add_`` on the CPU, a serial loop in the order of ``idx``;
    ``index_put_(accumulate=True)`` on the card, a stable sort of ``idx``
    and then each run of equal indices summed in an order of the kernel's
    own where ``values`` is one-dimensional (an H100 with PyTorch 2.11
    gives other roundings than the serial loop on most runs of more than
    a few values), in sequence where it has trailing dimensions."""
    if target.device.type == "cpu":
        return target.index_add_(0, idx, values)
    return target.index_put_((idx,), values, accumulate=True)
