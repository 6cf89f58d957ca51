"""Demonstrations of the port, run as modules (``python -m
slam_eslam_tpu_torch.examples.<name>``): the counterparts of the JAX
package's ``examples/`` scripts."""
