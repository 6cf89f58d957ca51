"""Kernel K1 (``contact_fold_kernel``) against its roofline: the bound of
the fold's inputs (``roofline/fold.py``: needed bytes over the memory
rate or needed instructions over the float32 instruction rate, the
larger) times its launches, over its device time in the traced stretch,
in percent."""

from benchmark.harness.readers import roofline_share


def read(ctx):
    return roofline_share(ctx, "contact_fold_kernel", "k1_bound_s")
