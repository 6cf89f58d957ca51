"""The cloud merge (``cloud_merge_kernel``) against its roofline: the
bound of the traced camera merges (``roofline/merge_cloud.py``: the
cloud, the poses and the written cells' slots once over the memory rate,
or the operations of every valid placement over the float32 rate, the
larger), over the kernel's device time in the traced stretch, in
percent.  Nothing where the port has no such kernel."""

from benchmark.harness.trace import re_kernel


def read(ctx):
    bound = ctx.get("cloud_merge_bound_s")
    seconds, count = ctx["trace"].kernel_seconds(
        re_kernel("cloud_merge_kernel"))
    if not bound or not count or seconds <= 0:
        return None
    return bound / seconds * 100.0
