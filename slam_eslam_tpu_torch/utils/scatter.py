"""Scatter-adds of floats in one fixed order.

The JAX package's ``.at[].add`` and ``segment_sum`` add each index's
values in index order on the CPU, the same on every call.  PyTorch's
float scatter-adds do not, on every device: ``index_add_`` and
``scatter_add_`` add with atomics on the card, and on the CPU a large
``index_put_(accumulate=True)`` is split over threads that race.  Every
float scatter-add of the port goes through ``add_at``, which picks the
operation that adds serially in index order on each device, so a call
repeats bit for bit (graphed or eager) and equals the JAX package's CPU
sums.  Integer scatter-adds and ``amin``/``amax`` reductions are exact in
any order and stay as they are.
"""

from __future__ import annotations

import torch


def add_at(target, idx, values):
    """``target[idx] += values`` along dim 0, in place; returns
    ``target``.  Each index's values are added in turn, in the order of
    ``idx``: ``index_add_`` on the CPU (a serial loop over ``idx``),
    ``index_put_(accumulate=True)`` on the card (a stable sort of ``idx``,
    then each run of equal indices added in sequence)."""
    if target.device.type == "cpu":
        return target.index_add_(0, idx, values)
    return target.index_put_((idx,), values, accumulate=True)
