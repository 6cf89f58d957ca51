"""Where an entry point of the port runs.

The port is written for the GPU: ``EmbodiedSlamFilter``,
``PoseEstimatorState.create`` and ``bench`` run on the CUDA device unless
the caller asks for another one (``device="cpu"``, as the CPU parity
tests do).  There is no silent CPU: without a CUDA device the default
raises.
"""

from __future__ import annotations

import subprocess

import numpy as np
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


def to_device_async(a, device, dtype=torch.float32):
    """Host values ``a`` as a tensor of ``dtype`` on ``device``; to a GPU
    asynchronously from pinned memory, so that the host does not wait (a
    blocking copy inside a frame would be a host sync)."""
    t = torch.tensor(np.asarray(a), dtype=dtype)
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def card_line(device):
    """The card's name and power limit as ``nvidia-smi`` gives them; None
    for a run on the CPU."""
    if device.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[device.index or 0]

