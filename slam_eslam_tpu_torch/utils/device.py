"""Where an entry point of the port runs.

The port is written for the GPU: ``EmbodiedSlamFilter``,
``PoseEstimatorState.create`` and ``bench`` run on the CUDA device unless
the caller asks for another one (``device="cpu"``, as the CPU parity
tests do).  There is no silent CPU: without a CUDA device the default
raises.
"""

from __future__ import annotations

import torch


def entry_device(device=None):
    """``device`` as a ``torch.device``; None means the current CUDA
    device (with its index, so it compares equal to a tensor's device)
    and raises ``RuntimeError`` where there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port's entry points run on the GPU "
                "unless asked for another device (pass device=\"cpu\")")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device
