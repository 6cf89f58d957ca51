"""Faults planted in the port underneath a run, for the harness's tests
and ``calibrate.py --fault``: each breaks the timed path where a real
fault would sit, and the run's check has to come out not correct.  None
is ever planted by ``run.py``.

* ``half_batch``: the centroid taken over the first half of the
  particles only;
* ``altered_pose``: every centroid 1 mm off in x where it is produced;
* ``resample_shift``: the resampling gives each stratum the particle
  after the one its cumulative weight picks (the wrong particles for the
  weights and the draws).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

FAULTS = ("half_batch", "altered_pose", "resample_shift")


@contextlib.contextmanager
def planted(name):
    """The fault ``name`` planted for the duration (before the runners
    are built and captured, so the captures hold it)."""
    from slam_eslam_tpu_torch.core import filter as pf
    from slam_eslam_tpu_torch.filter import pose_estimator as pe

    if name == "half_batch":
        mod, attr, real = pe, "centroid", pe.centroid

        def fault(particles, *a, **kw):
            n = particles.n // 2
            part = dataclasses.replace(particles, **{
                f.name: getattr(particles, f.name)[:n]
                for f in dataclasses.fields(particles)})
            return real(part, *a, **kw)
    elif name == "altered_pose":
        mod, attr, real = pe, "centroid", pe.centroid

        def fault(*a, **kw):
            c, q = real(*a, **kw)
            return c + torch.tensor([1e-3, 0.0, 0.0], dtype=c.dtype,
                                    device=c.device), q
    elif name == "resample_shift":
        mod, attr, real = pf, "resample_stratified", pf.resample_stratified

        def fault(weights, u, slots=None):
            idx = real(weights, u, slots)
            return (idx + 1).clamp(max=weights.shape[0] - 1)
    else:
        raise ValueError(f"unknown fault {name!r}: {FAULTS}")
    setattr(mod, attr, fault)
    try:
        yield
    finally:
        setattr(mod, attr, real)
