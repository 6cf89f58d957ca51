"""PyTorch/CUDA port of the embodied-SLAM engine.

The shared-map localisation step (odometry -> particle propagation ->
contact-likelihood weighting -> ESS-gated resampling -> centroid) on
plain ``torch`` tensors, with the contact fold as a hand-written CUDA
kernel (``ops.contact_fold``).  Module names mirror ``slam_eslam_tpu``.

The configuration dataclasses are shared with the JAX package
(``slam_eslam_tpu.config`` is jax-free); this package never imports
``jax``.  The window/Pallas knobs of ``Config`` (``lookup_window``,
``lookup_tiers``, ``merge_group``, ...) are accepted and ignored: the
port gathers straight from the full grid.
"""

from slam_eslam_tpu.config import Config, ContactModelConfig, OdometryConfig

__all__ = ["Config", "ContactModelConfig", "OdometryConfig"]
