"""PyTorch/CUDA port of the embodied-SLAM engine.

The shared-map localisation step (odometry -> particle propagation ->
contact-likelihood weighting -> ESS-gated resampling -> centroid), the
application API's contact update (``filter.eslam_filter``, with debug
capture, Chitta weighting, terrain fusion and the surface hash) and
per-particle-map SLAM on the laser path (``filter.streaming``), on plain
``torch`` tensors with hand-written CUDA kernels under ``ops``.  Module
names mirror ``slam_eslam_tpu``.

The configuration dataclasses (``config``) are the port's own copy of
the JAX package's, field for field; this package imports neither ``jax``
nor anything of ``slam_eslam_tpu``.  The window/Pallas knobs of
``Config`` (``lookup_window``, ``lookup_tiers``, ``merge_group``, ...)
are accepted and ignored: the port gathers straight from the full grid.
Entry points (``EmbodiedSlamFilter``, ``PoseEstimatorState.create``,
``bench``) run on the CUDA device unless the caller asks for
``device="cpu"``.
"""

from slam_eslam_tpu_torch.config import (Config, ContactModelConfig,
                                         OdometryConfig, SurfaceHashConfig,
                                         UpdateThreshold)

__all__ = ["Config", "ContactModelConfig", "OdometryConfig",
           "SurfaceHashConfig", "UpdateThreshold"]
