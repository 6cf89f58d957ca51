"""Kernel K3 (``block_merge_kernel``) against its roofline: the needed
bytes of the traced merges (``roofline/merge.py``: points once, the
touched cells' slots read and written once) over the memory rate, over
K3's device time in the traced stretch, in percent."""

from benchmark.harness.trace import re_kernel


def read(ctx):
    bound = ctx.get("k3_bound_s")
    seconds, count = ctx["trace"].kernel_seconds(re_kernel("block_merge_kernel"))
    if not bound or not count or seconds <= 0:
        return None
    return bound / seconds * 100.0
