"""The port's geometry helpers against ``slam_eslam_tpu.utils.geometry``.

Every case of ``tests/test_geometry.py`` runs on both packages with the
same inputs: the port's outputs must equal the JAX package's within rtol
1e-6 (atol 1e-7 for values at zero, where float32 rounding of sines and
cosines differs between XLA and PyTorch), and must pass the JAX test's own
assertion.  Further cases cover the helpers that test leaves out
(``quat_conj``, ``quat_normalize``, ``quat_from_matrix``) and the state
helpers ``ParticleSet.with_xy``, ``ParticleSet.full_pose`` and
``core.filter.weights_sum`` (values equal on seeded inputs).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_eslam_tpu.core import filter as jfilter
from slam_eslam_tpu.core import state as jstate
from slam_eslam_tpu.utils import geometry as jgeo
from slam_eslam_tpu_torch import convert
from slam_eslam_tpu_torch.core import filter as tfilter
from slam_eslam_tpu_torch.utils import geometry as tgeo

RTOL, ATOL = 1e-6, 1e-7
JAX = (jgeo, jnp.asarray)
TORCH = (tgeo, lambda a: torch.as_tensor(np.asarray(a, np.float32)))


def quat_from_euler(geo, arr, roll, pitch, yaw):
    """zyx (yaw-pitch-roll) composition, for test construction."""
    qz = geo.quat_from_axis_angle(arr([0.0, 0, 1]), arr(yaw))
    qy = geo.quat_from_axis_angle(arr([0.0, 1, 0]), arr(pitch))
    qx = geo.quat_from_axis_angle(arr([1.0, 0, 0]), arr(roll))
    return geo.quat_mul(qz, geo.quat_mul(qy, qx))


def case_mul_identity(geo, arr):
    q = quat_from_euler(geo, arr, 0.1, -0.2, 0.7)
    return dict(q=q, out=geo.quat_mul(q, geo.quat_identity()))


def case_rotate_matches_matrix(geo, arr):
    q = quat_from_euler(geo, arr, 0.3, 0.2, -1.1)
    v = arr([0.5, -1.0, 2.0])
    return dict(rot=geo.quat_rotate(q, v), mat=geo.quat_to_matrix(q) @ v)


def case_yaw_roundtrip(geo, arr):
    yaws = [-2.5, -0.3, 0.0, 1.0, 3.0]
    return dict(got=[geo.yaw_from_quat(geo.quat_from_yaw(arr(y)))
                     for y in yaws], want=yaws)


def case_yaw_with_tilt(geo, arr):
    return dict(got=geo.yaw_from_quat(
        quat_from_euler(geo, arr, 0.1, 0.05, 0.8)), want=0.8)


def case_remove_yaw(geo, arr):
    q = quat_from_euler(geo, arr, 0.15, -0.1, 1.3)
    q0 = geo.remove_yaw(q)
    q_back = geo.quat_mul(geo.quat_from_yaw(arr(1.3)), q0)
    return dict(yaw0=geo.yaw_from_quat(q0), q=q, q_back=q_back)


def case_remove_yaw_batch(geo, arr):
    q = [quat_from_euler(geo, arr, 0.1, 0.0, y) for y in (0.2, -0.9)]
    stack = jnp.stack if arr is jnp.asarray else torch.stack
    return dict(yaw0=geo.yaw_from_quat(geo.remove_yaw(stack(q))))


def case_rotate2d(geo, arr):
    return dict(got=geo.rotate2d(arr(np.pi / 2), arr([1.0, 0.0])),
                want=[0.0, 1.0])


def case_rot2d_matches(geo, arr):
    th, v = arr(0.7), arr([0.3, -0.4])
    return dict(mat=geo.rot2d(th) @ v, got=geo.rotate2d(th, v))


def case_transform_points(geo, arr):
    r, t = geo.pose_matrix_2p5d(arr([[1.0, 2.0]]), arr([np.pi / 2]),
                                arr([0.5]))
    out = geo.transform_points(r, t, arr([[[1.0, 0.0, 0.0]]]))
    return dict(got=out[0, 0], want=[1.0, 3.0, 0.5])


def case_angle_of_rotation(geo, arr):
    q = geo.quat_from_axis_angle(arr([0.0, 0, 1]), arr(0.4))
    return dict(got=geo.angle_of_rotation(q), want=0.4)


def case_conj_normalize(geo, arr):
    q = quat_from_euler(geo, arr, 0.2, 0.3, -0.4) * 2.5
    n = geo.quat_normalize(q)
    return dict(n=n, prod=geo.quat_mul(n, geo.quat_conj(n)),
                want=[1.0, 0.0, 0.0, 0.0])


def case_quat_from_matrix(geo, arr):
    """Each of Shepperd's four branches, and the w >= 0 sign."""
    qs = [quat_from_euler(geo, arr, *e) for e in (
        (0.1, 0.2, 0.3), (3.0, 0.1, 0.1), (0.1, 3.0, -0.2),
        (0.2, 0.1, 3.1), (-0.4, 0.5, -2.9))]
    back = [geo.quat_from_matrix(geo.quat_to_matrix(q)) for q in qs]
    return dict(q=qs, back=back)


def check_mul_identity(o):
    np.testing.assert_allclose(o["out"], o["q"], atol=1e-6)


def check_rotate_matches_matrix(o):
    np.testing.assert_allclose(o["rot"], o["mat"], atol=1e-5)


def check_remove_yaw(o):
    np.testing.assert_allclose(o["yaw0"], 0.0, atol=1e-6)
    np.testing.assert_allclose(np.abs(np.dot(o["q_back"], o["q"])), 1.0,
                               atol=1e-6)


def check_remove_yaw_batch(o):
    np.testing.assert_allclose(o["yaw0"], [0, 0], atol=1e-6)


def check_rot2d_matches(o):
    np.testing.assert_allclose(o["mat"], o["got"], atol=1e-6)


def check_conj_normalize(o):
    np.testing.assert_allclose(np.linalg.norm(o["n"]), 1.0, rtol=1e-6)
    np.testing.assert_allclose(o["prod"], o["want"], atol=1e-6)


def check_quat_from_matrix(o):
    for q, back in zip(o["q"], o["back"]):
        assert back[0] >= 0
        np.testing.assert_allclose(np.abs(np.dot(q, back)), 1.0, atol=1e-6)


def check_want(o, atol):
    np.testing.assert_allclose(o["got"], o["want"], atol=atol)


CASES = {
    "mul_identity": check_mul_identity,
    "rotate_matches_matrix": check_rotate_matches_matrix,
    "yaw_roundtrip": lambda o: check_want(o, 1e-6),
    "yaw_with_tilt": lambda o: check_want(o, 1e-6),
    "remove_yaw": check_remove_yaw,
    "remove_yaw_batch": check_remove_yaw_batch,
    "rotate2d": lambda o: check_want(o, 1e-6),
    "rot2d_matches": check_rot2d_matches,
    "transform_points": lambda o: check_want(o, 1e-6),
    "angle_of_rotation": lambda o: check_want(o, 1e-5),
    "conj_normalize": check_conj_normalize,
    "quat_from_matrix": check_quat_from_matrix,
}


def as_np(tree):
    if isinstance(tree, dict):
        return {k: as_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [as_np(v) for v in tree]
    return np.asarray(tree, np.float64)


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_on_both_packages(name):
    fn = globals()[f"case_{name}"]
    ref = as_np(fn(*JAX))
    got = as_np(fn(*TORCH))
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], rtol=RTOL, atol=ATOL,
                                   err_msg=key)
    CASES[name](got)


def test_state_helpers():
    rng = np.random.default_rng(3)
    n = 17
    jp = jstate.ParticleSet.zeros(n)
    jp = dataclasses.replace(
        jp, yaw=jnp.asarray(rng.uniform(-3, 3, n), jnp.float32),
        z=jnp.asarray(rng.normal(0, 1, n), jnp.float32),
        weight=jnp.asarray(rng.uniform(0, 1, n), jnp.float32))
    tp = convert.particle_set_from(
        jax.tree_util.tree_map(np.asarray, dataclasses.asdict(jp)))
    xy = rng.normal(0, 2, (n, 2)).astype(np.float32)
    jp, tp = jp.with_xy(jnp.asarray(xy)), tp.with_xy(torch.from_numpy(xy))
    np.testing.assert_array_equal(tp.x.numpy(), np.asarray(jp.x))
    np.testing.assert_array_equal(tp.y.numpy(), np.asarray(jp.y))
    imu = quat_from_euler(*JAX, 0.2, -0.1, 0.9)
    jq, jt = jp.full_pose(imu)
    tq, tt = tp.full_pose(torch.from_numpy(np.array(imu)))
    assert tq.shape == (n, 4) and tt.shape == (n, 3)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(
        float(tfilter.weights_sum(tp.weight)),
        float(jfilter.weights_sum(jp.weight)), rtol=RTOL)
