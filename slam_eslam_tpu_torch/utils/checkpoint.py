"""Checkpoint / resume of the full filter state.

Port of ``slam_eslam_tpu.utils.checkpoint`` with ``torch.save`` /
``torch.load`` in place of Orbax.  One file holds the filter state (the
particles, the odometry, the counters and the state of its
``torch.Generator``, so that a restored filter draws the same numbers),
the map (the shared grid or the block pool, in its storage dtype) and
the host-side gate state: the three motion-gate anchors (the camera's
included), ``update_idx`` and the step count that the hash period reads.
The file holds tensors and plain values only (``torch.load(...,
weights_only=True)`` reads it); the static fields (resolutions, pool
shapes, the configuration) come from the filter it is restored into,
which must be ``init``-ed with the same configuration first.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from slam_eslam_tpu_torch.mapping.lookup import make_lookup


def _tensors(obj):
    """The state fields of a dataclass as a nested dict: tensors, a
    generator as its state, host arrays as tensors and Python numbers as
    they are; static fields (floats of the geometry, configurations) are
    left to the template."""
    out = {}
    for f in dataclasses.fields(obj):
        val = getattr(obj, f.name)
        if isinstance(val, torch.Tensor):
            out[f.name] = val.detach()
        elif isinstance(val, torch.Generator):
            out[f.name] = val.get_state()
        elif dataclasses.is_dataclass(val):
            out[f.name] = _tensors(val)
        elif isinstance(val, np.ndarray):
            out[f.name] = torch.from_numpy(val.copy())
        elif isinstance(val, (bool, int)):
            out[f.name] = val
    return out


def _fill(template, saved, device):
    """``template`` with its saved fields replaced by ``saved`` (tensors
    moved to ``device``, host arrays back to NumPy); a generator field
    gets the saved state set."""
    fields = {}
    for f in dataclasses.fields(template):
        val = getattr(template, f.name)
        if f.name not in saved:
            continue
        if isinstance(val, torch.Generator):
            val.set_state(saved[f.name])
        elif dataclasses.is_dataclass(val):
            fields[f.name] = _fill(val, saved[f.name], device)
        elif isinstance(val, torch.Tensor):
            fields[f.name] = saved[f.name].to(device)
        elif isinstance(val, np.ndarray):
            fields[f.name] = saved[f.name].numpy().copy()
        else:
            fields[f.name] = saved[f.name]
    return dataclasses.replace(template, **fields)


def _map_of(f):
    return f.shared_grid if f.use_shared_map else f.pool


def save_filter(path, eslam_filter):
    """Persist an ``EmbodiedSlamFilter``'s complete state to ``path``."""
    f = eslam_filter
    tree = {
        "state": _tensors(f.state),
        "map": _tensors(_map_of(f)),
        "host": {
            "ud_pose": torch.from_numpy(np.asarray(f.ud_pose, np.float64)),
            "map_pose": torch.from_numpy(np.asarray(f.map_pose, np.float64)),
            "stereo_pose": torch.from_numpy(
                np.asarray(f.stereo_pose, np.float64)),
            "update_idx": int(f.update_idx),
            "steps": int(f.steps),
        },
    }
    torch.save(tree, os.path.abspath(path))


def restore_filter(path, eslam_filter):
    """Restore in place onto the filter's own device (the filter must be
    ``init``-ed with the same configuration and map mode first).
    Returns the filter."""
    f = eslam_filter
    tree = torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True)
    f.state = _fill(f.state, tree["state"], f.device)
    restored = _fill(_map_of(f), tree["map"], f.device)
    if f.use_shared_map:
        f.shared_grid = restored
        # the derived lookup follows the restored grid
        f._lookup = make_lookup(f.config, restored)
    else:
        f.pool = restored
    host = tree["host"]
    f.ud_pose = host["ud_pose"].numpy().copy()
    f.map_pose = host["map_pose"].numpy().copy()
    f.stereo_pose = host["stereo_pose"].numpy().copy()
    f.update_idx = int(host["update_idx"])
    f.steps = int(host["steps"])
    return f


def save_state(path, obj):
    """Save any state dataclass of tensors (filter-core states, map
    pools, hashes)."""
    torch.save(_tensors(obj), os.path.abspath(path))


def restore_state(path, template, device=None):
    """``template`` (a dataclass of the saved kind) with the saved
    tensors, on ``device`` (default: the template's)."""
    if device is None:
        device = next(v.device for v in _flat(template))
    return _fill(template, torch.load(os.path.abspath(path),
                                      map_location="cpu", weights_only=True),
                 device)


def _flat(obj):
    for f in dataclasses.fields(obj):
        val = getattr(obj, f.name)
        if isinstance(val, torch.Tensor):
            yield val
        elif dataclasses.is_dataclass(val):
            yield from _flat(val)
