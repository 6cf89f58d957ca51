"""The port's CUDA kernels, one wrapper module each (``contact_fold``,
``chain_lookup``, ``block_merge``, ``select_cells``, ``block_copy``,
``ordered_scan``, ``row_copy``, ``cloud_merge``),
built and bound by ``_build``.  Every wrapper counts its kernel launches
in ``<wrapper>.launches``; ``launch_counts`` reads them all
(``block_merge_packed``, the second wrapper of ``block_merge``'s source,
included)."""

import importlib

from slam_eslam_tpu_torch.ops._build import KERNELS


def _wrappers():
    out = {name: getattr(importlib.import_module(f"{__name__}.{name}"), name)
           for name in KERNELS}
    out["block_merge_packed"] = importlib.import_module(
        f"{__name__}.block_merge").block_merge_packed
    return out


def launch_counts():
    """``{kernel name: launches so far}`` over every kernel wrapper."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts():
    """Set every wrapper's launch count to 0."""
    for fn in _wrappers().values():
        fn.launches = 0


def set_launch_counts(counts):
    """Set each wrapper's launch count to ``counts[name]`` (a
    ``launch_counts`` dict): a CUDA graph's replay credits the launches its
    capture recorded (``utils.graphs``)."""
    for name, fn in _wrappers().items():
        fn.launches = counts[name]
