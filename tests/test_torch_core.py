"""Parity of the port's geometry, state and particle-filter core with
the JAX package, on the same seeded inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_eslam_tpu.core import filter as jpf
from slam_eslam_tpu.core import state as jstate
from slam_eslam_tpu.utils import geometry as jgeo
from slam_eslam_tpu_torch import convert
from slam_eslam_tpu_torch.core import filter as tpf
from slam_eslam_tpu_torch.core import state as tstate
from slam_eslam_tpu_torch.utils import geometry as tgeo
from slam_eslam_tpu_torch.utils import tree

torch.set_num_threads(2)


def as_dict(pytree):
    """A JAX state dataclass -> nested dict of numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, dataclasses.asdict(pytree))


def t(a):
    return torch.from_numpy(np.array(a))


def random_quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


class TestGeometry:
    def test_quaternion_helpers(self):
        rng = np.random.default_rng(0)
        q1, q2 = random_quats(rng, 32), random_quats(rng, 32)
        v = rng.normal(size=(32, 3)).astype(np.float32)
        yaw = rng.uniform(-4, 4, 32).astype(np.float32)
        pairs = [
            (jgeo.quat_mul(q1, q2), tgeo.quat_mul(t(q1), t(q2))),
            (jgeo.quat_rotate(q1, v), tgeo.quat_rotate(t(q1), t(v))),
            (jgeo.quat_from_yaw(yaw), tgeo.quat_from_yaw(t(yaw))),
            (jgeo.yaw_from_quat(q1), tgeo.yaw_from_quat(t(q1))),
            (jgeo.remove_yaw(q1), tgeo.remove_yaw(t(q1))),
            (jgeo.quat_rotate(q1[0][None], v),
             tgeo.quat_rotate(t(q1[0])[None], t(v))),
        ]
        for ref, got in pairs:
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=1e-5, atol=2e-6)

    def test_pose_matrix(self):
        rng = np.random.default_rng(1)
        xy = rng.normal(size=(16, 2)).astype(np.float32)
        yaw = rng.uniform(-4, 4, 16).astype(np.float32)
        z = rng.normal(size=16).astype(np.float32)
        rj, tj = jgeo.pose_matrix_2p5d(xy, yaw, z)
        rt, tt = tgeo.pose_matrix_2p5d(t(xy), t(yaw), t(z))
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-6)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))


GROUP_CASES = [
    [0, 0, 1, 1, 2, 2, 3, 3],
    [-1, -1, 0, 0, 0, -1, 2, 2],
    [3, 3, 3, 1, 1, 3, -1, 0],
    [-1] * 8,
    [5] * 8,
]


class TestContactState:
    @pytest.mark.parametrize("groups", GROUP_CASES)
    def test_segments(self, groups):
        pos = np.zeros((len(groups), 3), np.float32)
        seg_j, s_j = jstate.BodyContactState.create(
            pos, group_id=groups).segments()
        seg_t, s_t = tstate.BodyContactState.create(
            pos, group_id=groups).segments()
        assert s_t == s_j
        assert seg_t.dtype == torch.int32
        np.testing.assert_array_equal(seg_t.numpy(), np.asarray(seg_j))

    @pytest.mark.parametrize("cap", [4, 6, 8])
    def test_compact(self, cap):
        rng = np.random.default_rng(cap)
        pos = rng.normal(size=(12, 3)).astype(np.float32)
        contact = np.array([1, 0, 0.5, np.nan, 0.1, 0.9, 0, 0, 0.3, 1, 0, 1],
                           np.float32)
        groups = np.array([0, 0, 0, 1, 1, 1, -1, -1, 2, 2, 3, 3], np.int32)
        valid = np.ones(12, bool)
        valid[5] = False
        j = jstate.BodyContactState.create(pos, contact, None, groups,
                                           valid).compact(cap)
        p = tstate.BodyContactState.create(pos, contact, None, groups,
                                           valid).compact(cap)
        for name in ("position", "contact", "slip", "group_id", "valid"):
            np.testing.assert_array_equal(getattr(p, name).numpy(),
                                          np.asarray(getattr(j, name)))

    def test_stack_and_index(self):
        states = [tstate.BodyContactState.create(np.full((3, 3), i))
                  for i in range(4)]
        stacked = tree.stack(states)
        assert stacked.position.shape == (4, 3, 3)
        np.testing.assert_array_equal(
            tree.index(stacked, 2).position.numpy(), np.full((3, 3), 2))


def weight_cases():
    rng = np.random.default_rng(2)
    w = rng.gamma(0.5, size=200).astype(np.float32)
    return {
        "random": w,
        "peaked": np.where(np.arange(200) == 17, 1.0, 1e-9).astype(np.float32),
        "zero": np.zeros(200, np.float32),
        "nan": np.where(np.arange(200) == 3, np.nan, 1.0).astype(np.float32),
        "inf": np.where(np.arange(200) == 3, np.inf, 1.0).astype(np.float32),
    }


class TestWeights:
    @pytest.mark.parametrize("case", sorted(weight_cases()))
    def test_normalize_and_ess(self, case):
        w = weight_cases()[case]
        nj, ej = jpf.normalize_weights(jnp.asarray(w))
        nt, et = tpf.normalize_weights(t(w))
        np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=1e-6)
        np.testing.assert_allclose(float(et), float(ej), rtol=1e-5)
        np.testing.assert_allclose(float(tpf.effective_sample_size(t(w))),
                                   float(jpf.effective_sample_size(w)),
                                   rtol=1e-5)


def assert_ancestors_match(got, ref, weights, positions):
    """Equal indices, except +-1 where a position lies within 1e-6 of
    the cumulative weight at the boundary (``core/filter.py:73-78``)."""
    got, ref = np.asarray(got), np.asarray(ref)
    diff = got != ref
    assert np.all(np.abs(got[diff] - ref[diff]) == 1)
    cums = np.cumsum(weights.astype(np.float64))
    lo = np.minimum(got, ref)[diff]
    assert np.all(np.abs(positions[diff] - cums[lo]) < 1e-6)


class TestResampling:
    # 256 takes the JAX single compare-all count, 300 its wide search
    @pytest.mark.parametrize("n", [256, 300])
    def test_stratified(self, n):
        w = np.random.default_rng(n).gamma(0.3, size=n).astype(np.float32)
        w /= w.sum()
        key = jax.random.PRNGKey(n)
        ref = jpf.resample_stratified(key, jnp.asarray(w), n)
        u = np.asarray(jax.random.uniform(key, (n,), dtype=jnp.float32))
        got = tpf.resample_stratified(t(w), t(u))
        pos = (np.arange(n, dtype=np.float32) + u) / n
        assert_ancestors_match(got, ref, w, pos)

    @pytest.mark.parametrize("n", [256, 300])
    def test_systematic(self, n):
        w = np.random.default_rng(n + 1).gamma(0.3, size=n).astype(np.float32)
        w /= w.sum()
        key = jax.random.PRNGKey(n + 1)
        ref = jpf.resample_systematic(key, jnp.asarray(w), n)
        u = np.asarray(jax.random.uniform(key, (), dtype=jnp.float32))
        got = tpf.resample_systematic(t(w), t(u), n)
        pos = (np.arange(n, dtype=np.float32) + u) / n
        assert_ancestors_match(got, ref, w, pos)

    @pytest.mark.parametrize("n", [256, 300])
    def test_multinomial(self, n):
        w = np.random.default_rng(n + 2).gamma(0.3, size=n).astype(np.float32)
        w /= w.sum()
        key = jax.random.PRNGKey(n + 2)
        ref = jpf.resample_multinomial(key, jnp.asarray(w), n)
        u = np.asarray(jax.random.uniform(key, (n,), dtype=jnp.float32))
        got = tpf.resample_multinomial(t(w), t(u))
        assert_ancestors_match(got, ref, w, u)

    def test_take(self):
        n = 64
        rng = np.random.default_rng(3)
        p = jstate.ParticleSet.zeros(n).with_xy(
            jnp.asarray(rng.normal(size=(n, 2)), jnp.float32))
        p = dataclasses.replace(
            p, yaw=jnp.asarray(rng.normal(size=n), jnp.float32),
            n_contacts=jnp.arange(n, dtype=jnp.int32),
            floating=jnp.arange(n) % 3 == 0)
        idx = np.sort(rng.integers(0, n, n)).astype(np.int32)
        ref = as_dict(jpf.take_packed(p, jnp.asarray(idx)))
        got = convert.to_numpy(tpf.take(convert.particle_set_from(as_dict(p)),
                                         torch.from_numpy(idx).long()))
        for name, val in ref.items():
            np.testing.assert_array_equal(got[name], val, err_msg=name)


class TestConvert:
    def test_particle_set_round_trip(self):
        p = jstate.ParticleSet.zeros(10)
        d = as_dict(p)
        back = convert.to_numpy(convert.particle_set_from(d))
        for name, val in d.items():
            np.testing.assert_array_equal(back[name], val)
            assert back[name].dtype == val.dtype, name

    def test_pose_estimator_state(self):
        from slam_eslam_tpu.config import Config
        from slam_eslam_tpu.filter import pose_estimator as jpe

        d = as_dict(jpe.PoseEstimatorState.create(Config(particle_count=8),
                                                  5))
        s = convert.pose_estimator_state_from(d)
        back = convert.to_numpy(s)
        assert set(back) == {"particles", "odometry", "max_weight", "step"}
        for group in ("particles", "odometry"):
            for name, val in d[group].items():
                np.testing.assert_array_equal(back[group][name], val)
        assert isinstance(s.generator, torch.Generator)
