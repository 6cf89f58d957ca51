"""Shared helpers of the port's parity tests: JAX pytrees as numpy dicts,
numpy to torch, the JAX package's scripts under ``tools/`` loaded as
modules, and the JAX package's random draws rebuilt by repeating its key
splits, so the port can be fed the same numbers."""

import dataclasses
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from slam_eslam_tpu_torch.filter import pose_estimator as tpe


def as_dict(pytree):
    return jax.tree_util.tree_map(np.asarray, dataclasses.asdict(pytree))


def t(a):
    return torch.from_numpy(np.array(a))


def port_config(c):
    """A JAX package configuration dataclass rebuilt as the port's class
    of the same name, field for field (nested ones too), so it can go to
    a process that has no JAX."""
    import slam_eslam_tpu_torch.config as tc

    if dataclasses.is_dataclass(c):
        return getattr(tc, type(c).__name__)(**{
            f.name: port_config(getattr(c, f.name))
            for f in dataclasses.fields(c)})
    return c


def jax_tool(name):
    """The JAX package's ``tools/<name>.py`` as a module (the scripts that
    put the repository on ``sys.path`` leave it as it was)."""
    repo = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", repo / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    path = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
    return mod


def project_draws(key, n):
    """``pose_estimator.project``'s draws (``pose_estimator.py:113-115,
    123-124,154-157``, ``odometry.py:160-166``); returns the next key."""
    key, k_delta, k_slip1, k_slip2, k_sxy, k_syaw = jax.random.split(key, 6)
    kxy, kyaw = jax.random.split(k_delta)
    normal = lambda k, s: t(jax.random.normal(k, s, jnp.float32))
    uniform = lambda k, s: t(jax.random.uniform(k, s, jnp.float32))
    return key, tpe.ProjectDraws(
        delta_xy=normal(kxy, (n, 2)), delta_yaw=normal(kyaw, (n,)),
        slip=uniform(k_slip1, (n,)), shrink=uniform(k_slip2, (n,)),
        spread_xy=normal(k_sxy, (n, 2)), spread_yaw=normal(k_syaw, (n,)),
    )


def resample_draws(key, n):
    """``update``'s stratum uniforms (``pose_estimator.py:305``,
    ``core/filter.py:132``); returns the next key."""
    key, k_rs = jax.random.split(key)
    return key, t(jax.random.uniform(k_rs, (n,), jnp.float32))


def gaussian_normals(key, n):
    """``init_gaussian``'s standard normals ``(xy [n, 2], yaw [n])``."""
    kxy, kyaw = jax.random.split(key)
    return (t(jax.random.normal(kxy, (n, 2))),
            t(jax.random.normal(kyaw, (n,))))


def randint_draws(key, n, count):
    """``jax.random.randint(key, (n,), 0, max(count, 1))``: the hash's
    integer draws (``surface_hash.py:218-219,237``)."""
    return t(jax.random.randint(key, (n,), 0, jnp.maximum(count, 1)))


def slam_draws(key, n, updated):
    """Per frame of a streaming SLAM run without a hash: ``project``'s
    draws, then the resampling uniforms (``pose_estimator.py:305``) where
    the measurement gate ``updated[frame]`` fired."""
    from slam_eslam_tpu_torch.filter.step import StepDraws

    out = []
    for up in updated:
        key, proj = project_draws(key, n)
        u = None
        if up:
            key, u = resample_draws(key, n)
        out.append(StepDraws(proj, u))
    return out
