"""Measurement scripts of the port, run as modules (``python -m
slam_eslam_tpu_torch.tools.<name>``): the counterparts of the JAX
package's ``tools/`` scripts."""
