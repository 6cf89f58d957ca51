"""The boundary between the benchmark's plain inputs and the port.

The generators (``harness.sims``) emit NumPy arrays and the draws are
plain tensors; this module turns them into the port's types
(``slam_eslam_tpu_torch``: ``Config``, ``MLSGrid``, ``BodyContactState``,
``PoseEstimatorState``, ``StepDraws``) and reads the port's state back
into dicts of tensors for the reference.  Nothing else of the harness
touches the port's types, and the reference never imports this module.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

DRAW_FIELDS = ("delta_xy", "delta_yaw", "slip", "shrink", "spread_xy",
               "spread_yaw")


def config(cfg_file):
    """The port's ``Config`` from a configuration file's ``filter`` group
    (gates as ``[distance, angle]``; every other field at the port's
    default, which is the reference's)."""
    from slam_eslam_tpu_torch.config import (Config, ContactModelConfig,
                                             UpdateThreshold)

    fil = dict(cfg_file["filter"])
    cm = ContactModelConfig(**fil.pop("contact_model"))
    for gate in ("measurement_threshold", "mapping_threshold"):
        if gate in fil:
            fil[gate] = UpdateThreshold(*fil[gate])
    return dataclasses.replace(Config(), contact_model=cm, **fil)


def grid(arrays, device):
    """An ``MLSGrid`` holding the generator's patches."""
    from slam_eslam_tpu_torch.mapping.mls_grid import MLSGrid

    nx, ny, k = arrays["mean"].shape
    g = MLSGrid.create(nx, ny, arrays["resolution"],
                       tuple(float(v) for v in arrays["origin"]), k,
                       device=device)
    g.mean.copy_(torch.from_numpy(arrays["mean"]))
    g.stdev.copy_(torch.from_numpy(arrays["stdev"]))
    g.valid.copy_(torch.from_numpy(arrays["valid"]))
    return g


def contact_states(stacked, device):
    """A stacked ``BodyContactState`` (leading time axis) from a dict of
    stacked arrays."""
    from slam_eslam_tpu_torch.core.state import BodyContactState

    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return BodyContactState(
        position=put(stacked["position"]), contact=put(stacked["contact"]),
        slip=put(stacked["slip"]), group_id=put(stacked["group_id"]),
        valid=put(stacked["valid"]))


def step_draws(draws, t):
    """The port's ``StepDraws`` of step ``t`` of the draw tensors (views)."""
    from slam_eslam_tpu_torch.filter.pose_estimator import ProjectDraws
    from slam_eslam_tpu_torch.filter.step import StepDraws

    return StepDraws(
        project=ProjectDraws(**{f: draws[f][t] for f in DRAW_FIELDS}),
        resample_u=draws["resample_u"][t])


def filter_state(cfg, particles, num_contacts, device):
    """A ``PoseEstimatorState`` with the harness's start cloud
    (``particles``: a dict of ``x, y, yaw, z, z_sigma`` tensors) and the
    odometry, gate and counters zeroed."""
    from slam_eslam_tpu_torch.filter import pose_estimator as pe

    state = pe.PoseEstimatorState.create(cfg, num_contacts, device=device)
    p = dataclasses.replace(state.particles, **particles)
    return dataclasses.replace(state, particles=p)


def odometry_states(odo):
    """The port's stacked ``FootContactOdometry`` (floats in float32) from
    the reference's odometry dict of stacked frames."""
    from slam_eslam_tpu_torch.models.odometry import FootContactOdometry

    f = lambda t: t.float() if t.is_floating_point() else t
    return FootContactOdometry(**{k: f(v).contiguous() for k, v in odo.items()})


def plain_state(state, dtype=torch.float64):
    """The port's ``PoseEstimatorState`` as the reference's dicts, floats
    in ``dtype``: ``{"particles", "odometry", "max_weight"}``."""
    f = lambda t: t.to(dtype) if t.is_floating_point() else t.clone()
    p = state.particles
    odo = state.odometry
    return {
        "particles": {k: f(getattr(p, k))
                      for k in ("x", "y", "yaw", "z", "z_sigma", "weight")},
        "odometry": {k.name: f(getattr(odo, k.name))
                     for k in dataclasses.fields(odo)},
        "max_weight": f(state.max_weight),
    }


def plain_contacts(stacked, t, device, dtype=torch.float64):
    """Contact state ``t`` (or the states of a slice ``t``) of the
    generator's stacked arrays as the reference's dict of tensors."""
    out = {}
    for k, v in stacked.items():
        a = torch.from_numpy(np.ascontiguousarray(v[t])).to(device)
        out[k] = a.to(dtype) if a.is_floating_point() else a
    return out
