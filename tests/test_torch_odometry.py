"""Parity of the port's contact odometry with the JAX package: the same
contact-state stream and orientations through both, step by step."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_eslam_tpu.config import OdometryConfig
from slam_eslam_tpu.core.state import BodyContactState as JContactState
from slam_eslam_tpu.models import odometry as jodom
from slam_eslam_tpu.models.asguard import AsguardSim
from slam_eslam_tpu_torch import convert
from slam_eslam_tpu_torch.core.state import BodyContactState
from slam_eslam_tpu_torch.models import odometry as todom

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


def as_dict(pytree):
    return jax.tree_util.tree_map(np.asarray, dataclasses.asdict(pytree))


def stream(steps, yaw_rate, seed):
    """Asguard frames (rolling stance feet) with IMU orientations that
    also pitch and roll, and a few NaN / low contact probabilities."""
    rng = np.random.default_rng(seed)
    sim = AsguardSim()
    frames = []
    for _ in range(steps):
        sim.step(wheel_delta=0.3, yaw_rate=yaw_rate)
        cs = sim.contact_state()
        contact = np.array(cs.contact)
        contact[rng.integers(0, contact.size)] = np.nan
        axis = rng.normal(size=3)
        tilt = 0.05 * axis / np.linalg.norm(axis)
        half = 0.5 * sim.yaw
        qyaw = np.array([np.cos(half), 0, 0, np.sin(half)])
        qtilt = np.concatenate([[1.0], 0.5 * tilt])
        qtilt /= np.linalg.norm(qtilt)
        w1, x1, y1, z1 = qyaw
        w2, x2, y2, z2 = qtilt
        q = np.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                      w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                      w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                      w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], np.float32)
        frames.append((np.asarray(cs.position), contact,
                       np.asarray(cs.group_id), q))
    return frames


def assert_state_close(port, ref):
    ref = as_dict(ref)
    got = convert.to_numpy(port)
    for name, val in ref.items():
        if val.dtype == bool:
            np.testing.assert_array_equal(got[name], val, err_msg=name)
        else:
            np.testing.assert_allclose(got[name], val, rtol=RTOL, atol=ATOL,
                                       err_msg=name)


@pytest.mark.parametrize("yaw_rate", [0.0, 0.08])
def test_update_stream(yaw_rate):
    cfg = OdometryConfig()
    frames = stream(8, yaw_rate, seed=int(yaw_rate * 100))
    j = jodom.FootContactOdometry.create(frames[0][0].shape[0])
    p = todom.FootContactOdometry.create(frames[0][0].shape[0])
    moved = 0.0
    for pos, contact, groups, q in frames:
        j = jodom.update(j, JContactState.create(pos, contact, None, groups),
                         jnp.asarray(q), cfg)
        p = todom.update(p, BodyContactState.create(pos, contact, None,
                                                    groups),
                         torch.from_numpy(q), cfg)
        assert_state_close(p, j)
        moved += float(np.linalg.norm(np.asarray(j.delta_xy)))
    assert moved > 0.1  # the stream exercises real stance-foot motion


def test_samples_and_error_model():
    cfg = OdometryConfig()
    frames = stream(3, 0.05, seed=3)
    j = jodom.FootContactOdometry.create(frames[0][0].shape[0])
    for pos, contact, groups, q in frames:
        j = jodom.update(j, JContactState.create(pos, contact, None, groups),
                         jnp.asarray(q), cfg)
    p = convert.odometry_from(as_dict(j))

    n = 96
    key = jax.random.PRNGKey(11)
    dxy_j, dyaw_j = jodom.pose_delta_samples_2d(j, key, n)
    kxy, kyaw = jax.random.split(key)
    nxy = np.array(jax.random.normal(kxy, (n, 2), jnp.float32))
    nyaw = np.array(jax.random.normal(kyaw, (n,), jnp.float32))
    dxy_p, dyaw_p = todom.pose_delta_samples_2d(
        p, torch.from_numpy(nxy), torch.from_numpy(nyaw))
    np.testing.assert_allclose(dxy_p.numpy(), np.asarray(dxy_j), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(dyaw_p.numpy(), np.asarray(dyaw_j), rtol=RTOL,
                               atol=ATOL)

    q = frames[-1][3]
    zd_j, zv_j = jodom.z_delta_and_var(j, jnp.asarray(q))
    zd_p, zv_p = todom.z_delta_and_var(p, torch.from_numpy(q))
    np.testing.assert_allclose(float(zd_p), float(zd_j), rtol=RTOL)
    np.testing.assert_allclose(float(zv_p), float(zv_j), rtol=RTOL)
    np.testing.assert_allclose(todom.position_error(p).numpy(),
                               np.asarray(jodom.position_error(j)),
                               rtol=RTOL)
