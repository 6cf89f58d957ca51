"""Carry state across between the JAX package and the port.

The JAX package's state is given as (nested) dicts of numpy arrays keyed
by the JAX dataclass field names, e.g. ``dataclasses.asdict`` of a JAX
pytree with every leaf passed through ``np.asarray``.  The ``*_from``
functions build the port's dataclasses of tensors on ``device``;
``to_numpy`` goes the other way.  The JAX PRNG key of
``PoseEstimatorState`` has no counterpart (the port's state carries a
``torch.Generator``), and ``PackedLookup.data_t`` (the TPU kernel's
pre-transposed table) is not carried.

NumPy has no bfloat16 of its own.  A bfloat16 JAX array arrives as a
NumPy array of the extension dtype named ``bfloat16`` (or as ``uint16``
bit patterns with the owner saying so, ``bf16_from_bits``); its 16-bit
patterns are reinterpreted as ``torch.bfloat16``, bit for bit.
``to_numpy`` gives a bfloat16 tensor back as float32 (exact).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from slam_eslam_tpu_torch.core.state import BodyContactState, ParticleSet
from slam_eslam_tpu_torch.filter.pose_estimator import PoseEstimatorState
from slam_eslam_tpu_torch.filter.streaming import StreamingState
from slam_eslam_tpu_torch.filter.surface_hash import SurfaceHash
from slam_eslam_tpu_torch.mapping.map_pool import MapPool
from slam_eslam_tpu_torch.mapping.mls_grid import MLSGrid, PackedLookup
from slam_eslam_tpu_torch.models.odometry import FootContactOdometry


def bf16_from_bits(bits, device=None):
    """``uint16`` bit patterns -> a ``torch.bfloat16`` tensor (bit exact)."""
    bits = np.ascontiguousarray(bits, dtype=np.uint16)
    return torch.from_numpy(bits.view(np.int16).copy()).view(
        torch.bfloat16).to(device)


def _tensor(value, device):
    value = np.array(value, copy=True)
    if value.dtype.name == "bfloat16":
        return bf16_from_bits(value.view(np.uint16), device)
    return torch.from_numpy(value).to(device)


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


def map_pool_from(d, device=None) -> MapPool:
    """A JAX ``MapPool`` dict (``color`` None for a colourless pool).  A
    pool stored in bfloat16 comes across bit for bit (module docstring)."""
    return _from(MapPool, d, device, resolution=float(d["resolution"]),
                 nx=int(d["nx"]), ny=int(d["ny"]), k=int(d["k"]),
                 color=(None if d["color"] is None
                        else _tensor(d["color"], device)))


def streaming_state_from(d, device=None, generator=None) -> StreamingState:
    """A JAX ``StreamingState`` dict.  The motion-gate anchors become
    host float32 arrays and ``update_idx`` a Python int, as the port's
    host-side gates keep them."""
    anchor = lambda name: np.array(d[name], np.float32)
    return StreamingState(
        filter=pose_estimator_state_from(d["filter"], device, generator),
        pool=map_pool_from(d["pool"], device),
        ud_pos=anchor("ud_pos"), ud_q=anchor("ud_q"),
        map_pos=anchor("map_pos"), map_q=anchor("map_q"),
        cam_pos=anchor("cam_pos"), cam_q=anchor("cam_q"),
        update_idx=int(d["update_idx"]),
        alloc_failed=_tensor(d["alloc_failed"], device),
    )


def surface_hash_from(d, config, device=None) -> SurfaceHash:
    """A JAX ``SurfaceHash`` dict; ``config`` is its (static)
    ``SurfaceHashConfig``."""
    return _from(SurfaceHash, d, device, config=config)


def to_numpy(obj):
    """A port dataclass -> nested dict of numpy arrays (static fields
    kept as they are, the generator dropped)."""
    out = {}
    for f in dataclasses.fields(obj):
        val = getattr(obj, f.name)
        if isinstance(val, torch.Tensor):
            val = val.detach().cpu()
            if val.dtype == torch.bfloat16:
                val = val.float()
            out[f.name] = val.numpy()
        elif dataclasses.is_dataclass(val):
            out[f.name] = to_numpy(val)
        elif not isinstance(val, torch.Generator):
            out[f.name] = val
    return out
