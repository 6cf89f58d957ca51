"""The port's CUDA kernels, one wrapper module each (``contact_fold``,
``chain_lookup``, ``block_merge``, ``select_cells``, ``block_copy``),
built and bound by ``_build``.  Every wrapper counts its kernel launches
in ``<wrapper>.launches``; ``launch_counts`` reads them all."""

import importlib

from slam_eslam_tpu_torch.ops._build import KERNELS


def _wrappers():
    return {name: getattr(importlib.import_module(f"{__name__}.{name}"), name)
            for name in KERNELS}


def launch_counts():
    """``{kernel name: launches so far}`` over every kernel wrapper."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts():
    """Set every wrapper's launch count to 0."""
    for fn in _wrappers().values():
        fn.launches = 0
