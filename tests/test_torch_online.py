"""The port's ``OnlineSlam`` against ``slam_eslam_tpu.online.OnlineSlam``
on the CPU.

``tests/test_online.py``'s run (32 particles with per-particle maps, an
Asguard rolling over a sine terrain, a 48-ray scan on every frame, two
chunks of 30 frames, keyframes every 0.1 m) drives both packages.  The
JAX ``OnlineSlam`` draws from its filter's key; the port is fed the same
draws, rebuilt by repeating the key splits (``project`` on every frame,
the resampling uniforms on measurement frames), and the same start
normals.  Compared: the gate flags and the keyframe frames and count
exactly, keyframe poses within 1e-4 m, closures with the same index
pairs and scores within 1e-5, the optimised trajectory within 1e-4, and
the incremental no-op of a second ``optimize``.  Also the JAX test's own
assertions on the port's run, and the local-map cloud of the first
keyframe against the JAX package's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_eslam_tpu.config import Config as JConfig
from slam_eslam_tpu.config import ContactModelConfig as JContact
from slam_eslam_tpu.filter import streaming as jst
from slam_eslam_tpu.models.asguard import AsguardSim
from slam_eslam_tpu.online import OnlineSlam as JOnline
from slam_eslam_tpu_torch import convert
from slam_eslam_tpu_torch.config import Config as TConfig
from slam_eslam_tpu_torch.config import ContactModelConfig as TContact
from slam_eslam_tpu_torch.filter import pose_estimator as tpe
from slam_eslam_tpu_torch.filter import streaming as tst
from slam_eslam_tpu_torch.filter.step import StepDraws
from slam_eslam_tpu_torch.online import OnlineSlam as TOnline

torch.set_num_threads(2)

N = 32
N_RAYS = 48
CHUNKS, STEPS_PER_CHUNK = 2, 3
SCAN_META = (np.float32(-np.pi / 2), np.float32(np.pi / N_RAYS))
KEYFRAMES = dict(keyframe_distance=0.1, closure_radius=0.6,
                 min_separation=3, min_score=0.05)
POSE_ATOL = 1e-4
SCORE_ATOL = 1e-5


def terrain(x, y):
    return 0.3 * np.sin(0.9 * np.asarray(x)) + 0.25 * np.cos(
        0.7 * np.asarray(y))


def config(cls, contact):
    return dataclasses.replace(
        cls(), particle_count=N, min_effective=N // 2, grid_size=10.0,
        grid_resolution=0.25, map_pool_blocks=N + 16, map_chain_length=3,
        contact_model=contact(contact_point_radius=0.0, min_contacts=2))


def t(a):
    return torch.from_numpy(np.array(a))


def chunk_draws(key, updated):
    """``project``'s draws per frame, then the resampling uniforms where
    the measurement gate fired (the JAX filter's key splits)."""
    out = []
    for up in updated:
        key, k_delta, k_slip1, k_slip2, k_sxy, k_syaw = jax.random.split(
            key, 6)
        kxy, kyaw = jax.random.split(k_delta)
        normal = lambda k, s: t(jax.random.normal(k, s, jnp.float32))
        uniform = lambda k, s: t(jax.random.uniform(k, s, jnp.float32))
        proj = tpe.ProjectDraws(
            delta_xy=normal(kxy, (N, 2)), delta_yaw=normal(kyaw, (N,)),
            slip=uniform(k_slip1, (N,)), shrink=uniform(k_slip2, (N,)),
            spread_xy=normal(k_sxy, (N, 2)), spread_yaw=normal(k_syaw, (N,)))
        u = None
        if up:
            key, k_rs = jax.random.split(key)
            u = uniform(k_rs, (N,))
        out.append(StepDraws(proj, u))
    return out


def chunks():
    """The frames of each chunk, as the JAX test makes them."""
    sim = AsguardSim(terrain=terrain)
    z0 = float(sim.position[2])
    q = np.array([1.0, 0, 0, 0], np.float32)
    out = []
    for _ in range(CHUNKS):
        frames = []

        def cb(s):
            frames.append((s.contact_state(), q,
                           np.asarray(s.position, np.float32),
                           np.full((N_RAYS,), 2.0, np.float32), SCAN_META,
                           True))

        for _ in range(STEPS_PER_CHUNK):
            sim.step(wheel_delta=0.3, on_substep=cb)
        out.append(frames)
    return z0, out


@pytest.fixture(scope="module")
def runs():
    z0, frame_chunks = chunks()
    pose = (np.array([0.0, 0.0, z0]), 0.0)
    js = JOnline(config=config(JConfig, JContact), keyframe_kw=KEYFRAMES)
    js.init(pose=pose)
    _, k_init = jax.random.split(jax.random.PRNGKey(js.filter.config.seed))
    kxy, kyaw = jax.random.split(k_init)
    ts = TOnline(config=config(TConfig, TContact), keyframe_kw=KEYFRAMES,
                 device="cpu")
    ts.init(pose=pose, normal_xy=t(jax.random.normal(kxy, (N, 2))),
            normal_yaw=t(jax.random.normal(kyaw, (N,))))
    auxes = []
    for frames in frame_chunks:
        key = js.filter.state.key
        jaux = js.process_chunk(jst.stack_frames([
            (cs, jnp.asarray(q), jnp.asarray(p), jnp.asarray(r), meta,
             jnp.asarray(hs)) for cs, q, p, r, meta, hs in frames]))
        tframes = tst.stack_frames([
            (convert.body_contact_state_from(jax.tree_util.tree_map(
                np.asarray, dataclasses.asdict(cs))), q, p, r, meta, hs)
            for cs, q, p, r, meta, hs in frames])
        draws = chunk_draws(key, np.asarray(jaux["updated"]))
        taux = ts.process_chunk(tframes, draws=draws)
        auxes.append((jaux, taux))
    return js, ts, auxes


def test_gates_and_centroids(runs):
    _, _, auxes = runs
    total_mapped = 0
    for jaux, taux in auxes:
        for name in ("updated", "mapped"):
            np.testing.assert_array_equal(taux[name], np.asarray(jaux[name]))
        np.testing.assert_allclose(taux["centroid"].numpy(),
                                   np.asarray(jaux["centroid"]),
                                   atol=POSE_ATOL)
        total_mapped += int(taux["mapped"].sum())
    assert total_mapped > 0


def test_keyframes_and_closures(runs):
    js, ts, _ = runs
    jk, tk = js.keyframes, ts.keyframes
    assert len(tk.keyframes) >= 2
    assert ts.keyframe_frames == js.keyframe_frames
    assert len(tk.keyframes) == len(jk.keyframes)
    for a, b in zip(tk.keyframes, jk.keyframes):
        np.testing.assert_allclose(a.pose, b.pose, atol=POSE_ATOL)
        assert abs(a.z - b.z) < POSE_ATOL
    assert [c[:2] for c in tk.closures] == [c[:2] for c in jk.closures]
    np.testing.assert_allclose([c[2] for c in tk.closures],
                               [c[2] for c in jk.closures], atol=SCORE_ATOL)


def test_keyframe_cloud(runs):
    """The first keyframe's local-map cloud (best particle's chain,
    recency gate, cell de-duplication, padding) as the JAX package
    extracts it."""
    js, ts, _ = runs
    a, b = ts.keyframes.keyframes[0].cloud, js.keyframes.keyframes[0].cloud
    valid = np.asarray(b.valid)
    np.testing.assert_array_equal(a.valid.numpy(), valid)
    assert 0 < valid.sum() <= valid.size == 1024
    for name in ("xy", "z", "stdev"):
        np.testing.assert_allclose(getattr(a, name).numpy(),
                                   np.asarray(getattr(b, name)),
                                   atol=POSE_ATOL, err_msg=name)


def test_optimize_and_incremental_noop(runs):
    js, ts, _ = runs
    n = len(ts.keyframes.keyframes)
    (jt, jh), (tt, th) = js.optimize(iters=5), ts.optimize(iters=5)
    assert tt.shape[1] == 3 and np.isfinite(tt[:n]).all()
    np.testing.assert_allclose(tt[:n], np.asarray(jt)[:n], atol=POSE_ATOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4,
                               atol=1e-4)
    tt2, th2 = ts.optimize(iters=5)
    assert th2.shape == (0,)
    np.testing.assert_allclose(tt, tt2)
