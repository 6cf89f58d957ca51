"""Carry state across between the JAX package and the port.

The JAX package's state is given as (nested) dicts of numpy arrays keyed
by the JAX dataclass field names, e.g. ``dataclasses.asdict`` of a JAX
pytree with every leaf passed through ``np.asarray``.  The ``*_from``
functions build the port's dataclasses of tensors on ``device``;
``to_numpy`` goes the other way.  The JAX PRNG key of
``PoseEstimatorState`` has no counterpart (the port's state carries a
``torch.Generator``), and ``PackedLookup.data_t`` (the TPU kernel's
pre-transposed table) is not carried.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from slam_eslam_tpu_torch.core.state import BodyContactState, ParticleSet
from slam_eslam_tpu_torch.filter.pose_estimator import PoseEstimatorState
from slam_eslam_tpu_torch.mapping.mls_grid import MLSGrid, PackedLookup
from slam_eslam_tpu_torch.models.odometry import FootContactOdometry


def _tensor(value, device):
    return torch.from_numpy(np.array(value, copy=True)).to(device)


def _from(cls, d, device, **static):
    fields = {}
    for f in dataclasses.fields(cls):
        if f.name in static:
            fields[f.name] = static[f.name]
        else:
            fields[f.name] = _tensor(d[f.name], device)
    return cls(**fields)


def particle_set_from(d, device=None) -> ParticleSet:
    return _from(ParticleSet, d, device)


def odometry_from(d, device=None) -> FootContactOdometry:
    return _from(FootContactOdometry, d, device)


def body_contact_state_from(d, device=None) -> BodyContactState:
    return _from(BodyContactState, d, device)


def mls_grid_from(d, device=None) -> MLSGrid:
    return _from(MLSGrid, d, device, resolution=float(d["resolution"]))


def packed_lookup_from(d, device=None) -> PackedLookup:
    return _from(PackedLookup, d, device,
                 resolution=float(d["resolution"]))


def pose_estimator_state_from(d, device=None,
                              generator=None) -> PoseEstimatorState:
    """``generator`` draws what is not given explicitly; defaults to a
    fresh ``torch.Generator`` on ``device``."""
    device = torch.device(device or "cpu")
    return PoseEstimatorState(
        particles=particle_set_from(d["particles"], device),
        odometry=odometry_from(d["odometry"], device),
        max_weight=_tensor(d["max_weight"], device),
        step=_tensor(d["step"], device),
        generator=generator or torch.Generator(device),
    )


def to_numpy(obj):
    """A port dataclass -> nested dict of numpy arrays (static fields
    kept as they are, the generator dropped)."""
    out = {}
    for f in dataclasses.fields(obj):
        val = getattr(obj, f.name)
        if isinstance(val, torch.Tensor):
            out[f.name] = val.detach().cpu().numpy()
        elif dataclasses.is_dataclass(val):
            out[f.name] = to_numpy(val)
        elif not isinstance(val, torch.Generator):
            out[f.name] = val
    return out
