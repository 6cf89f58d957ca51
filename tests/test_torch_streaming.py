"""Per-particle-map SLAM as a whole: the port's streaming runner against
the JAX ``make_slam_scan_runner(external_odometry=True)``.

Both run from one converted ``EmbodiedSlamFilter.init(use_shared_map=
False)`` state over an Asguard trajectory (contacts compacted to 8, the
odometry precomputed from the full 20-point stream, a 16-ray scan on
every fifth frame), the port with the JAX random draws rebuilt by
repeating the JAX key splits (``project`` on every frame, the resampling
uniforms on measurement frames).  The trajectory rolls particles over
onto fresh grids and copies shared heads on write; the test asserts
both.  The JAX runner is compiled (``jax.jit``) as in production.

Tolerances: the gate sequences, ``alloc_failed``, the chains and the
pool's ``meta`` exact; centroids atol 1e-4 m; particle fields rtol 1e-4
/ atol 1e-5 and the pool's float fields and block origins rtol 1e-5 /
atol 1e-6 (float32
rounding: XLA contracts multiply-adds, the port rounds each operation).
Also the fixtures: ``AsguardSim`` contact states, ``precompute_odometry``
and ``EmbodiedSlamFilter.init``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_eslam_tpu.config import Config, ContactModelConfig
from slam_eslam_tpu.filter import streaming as jst
from slam_eslam_tpu.filter.eslam_filter import EmbodiedSlamFilter as JFilter
from slam_eslam_tpu.models.asguard import AsguardSim as JSim
from slam_eslam_tpu_torch import convert
from slam_eslam_tpu_torch.filter import pose_estimator as tpe
from slam_eslam_tpu_torch.filter import streaming as tst
from slam_eslam_tpu_torch.filter.eslam_filter import (
    EmbodiedSlamFilter as TFilter)
from slam_eslam_tpu_torch.filter.step import StepDraws
from slam_eslam_tpu_torch.mapping import map_pool as tmp
from slam_eslam_tpu_torch.models.asguard import AsguardSim as TSim
from slam_eslam_tpu_torch.utils import tree

torch.set_num_threads(2)

N = 64
STEPS, SUBSTEPS = 6, 5          # 30 frames
RAYS = 16
CAP = 8
LASER = (np.array([[0.995, 0.0, 0.0998], [0.0, 1.0, 0.0],
                   [-0.0998, 0.0, 0.995]], np.float32),
         np.array([0.05, 0.2, 0.3], np.float32))


def terrain(x, y):
    return 0.15 * np.sin(0.7 * np.asarray(x)) + 0.12 * np.cos(
        0.5 * np.asarray(y))


def as_dict(pytree):
    return jax.tree_util.tree_map(np.asarray, dataclasses.asdict(pytree))


def t(a):
    return torch.from_numpy(np.array(a))


def config(match):
    return dataclasses.replace(
        Config(), particle_count=N, min_effective=0.9 * N, grid_size=2.0,
        grid_resolution=0.25, map_pool_blocks=4 * N, map_chain_length=3,
        map_pool_color=False, use_visual_update=match,
        grid_use_negative_information=match,
        contact_model=ContactModelConfig(contact_point_radius=0.0,
                                         min_contacts=2))


def trajectory():
    """Per-frame (full contact state, compacted contact state, q,
    position, ranges, has_scan) from the JAX fixture."""
    sim = JSim(terrain=terrain)
    rng = np.random.default_rng(0)
    out = []

    def cb(s):
        cs = s.contact_state()
        ranges = rng.uniform(0.8, 2.6, RAYS).astype(np.float32)
        ranges[rng.random(RAYS) < 0.1] = 4.0          # beyond max range
        out.append([cs, cs.compact(CAP), s.orientation,
                    np.asarray(s.position, np.float32), ranges, False])

    for _ in range(STEPS):
        sim.step(wheel_delta=1.0, yaw_rate=0.1, substeps=SUBSTEPS,
                 on_substep=cb)
        out[-1][5] = True
    return out


SCAN_META = (np.float32(-np.pi / 2), np.float32(np.pi / RAYS))


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


def slam_draws(key, n, updated):
    """Per frame: ``project``'s draws, then the resampling uniforms
    (``pose_estimator.py:305``) when the measurement gate fired."""
    out = []
    for up in updated:
        key, proj = project_draws(key, n)
        u = None
        if up:
            key, k_rs = jax.random.split(key)
            u = t(jax.random.uniform(k_rs, (n,), jnp.float32))
        out.append(StepDraws(proj, u))
    return out


def init_normals(seed, n):
    """``EmbodiedSlamFilter.init``'s particle normals."""
    _, k_init = jax.random.split(jax.random.PRNGKey(seed))
    kxy, kyaw = jax.random.split(k_init)
    return (t(jax.random.normal(kxy, (n, 2))),
            t(jax.random.normal(kyaw, (n,))))


def jax_filter(cfg, z0):
    f = JFilter(config=cfg)
    f.init(pose=(np.array([0.0, 0.0, z0]), 0.0), use_shared_map=False,
           num_contact_points=20)
    return f


@pytest.fixture(scope="module", params=[False, True],
                ids=["bench", "match+negative"])
def runs(request):
    """One JAX run and the port's run on the same inputs."""
    match = request.param
    cfg = config(match)
    traj = trajectory()
    z0 = float(JSim(terrain=terrain).position[2])
    jframes = jst.stack_frames([
        (cmp, jnp.asarray(q), jnp.asarray(pos), jnp.asarray(r), SCAN_META,
         jnp.asarray(hs)) for _, cmp, q, pos, r, hs in traj])
    full = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                  *[fr[0] for fr in traj])
    qs = jnp.stack([jnp.asarray(fr[2]) for fr in traj])
    jodos = jst.precompute_odometry(20, full, qs, cfg=cfg)
    carry0 = jst.StreamingState.create(*(lambda f: (f.state, f.pool))(
        jax_filter(cfg, z0)))
    run = jst.make_slam_scan_runner(cfg, laser2body=LASER,
                                    external_odometry=True)
    jcarry, jaux = run(carry0, jframes, jodos)

    tframes = tst.stack_frames([
        (convert.body_contact_state_from(as_dict(cmp)), q, pos, r,
         SCAN_META, hs) for _, cmp, q, pos, r, hs in traj])
    todos = tst.precompute_odometry(
        20, tree.stack([convert.body_contact_state_from(as_dict(fr[0]))
                        for fr in traj]), t(np.asarray(qs)), cfg=cfg)
    carry = convert.streaming_state_from(as_dict(carry0))
    draws = slam_draws(carry0.filter.key, N, np.asarray(jaux["updated"]))

    # watch the copy-on-write and rollover steps of the port's run
    seen = {"dup_heads": 0, "rolled": 0}
    ensure, roll = tmp.ensure_unique_active, tmp.rollover

    def spy_ensure(pool, shards=1):
        heads = pool.active().numpy()
        seen["dup_heads"] += heads.size - np.unique(heads).size
        return ensure(pool, shards)

    def spy_rollover(pool, xy, threshold, shards=1):
        before = pool.active().clone()
        out = roll(pool, xy, threshold, shards)
        seen["rolled"] += int((out[0].active() != before).sum())
        return out

    tmp.ensure_unique_active, tmp.rollover = spy_ensure, spy_rollover
    try:
        tcarry, taux = tst.make_slam_scan_runner(
            cfg, laser2body=LASER, external_odometry=True)(
            carry, tframes, todos, draws)
    finally:
        tmp.ensure_unique_active, tmp.rollover = ensure, roll
    return dict(cfg=cfg, traj=traj, jodos=jodos, todos=todos, jcarry=jcarry,
                jaux=jaux, tcarry=tcarry, taux=taux, seen=seen, z0=z0)


def test_gates_and_centroids(runs):
    jaux, taux = runs["jaux"], runs["taux"]
    np.testing.assert_array_equal(taux["updated"], np.asarray(jaux["updated"]))
    np.testing.assert_array_equal(taux["mapped"], np.asarray(jaux["mapped"]))
    assert 3 <= taux["updated"].sum() < len(taux["updated"])
    assert taux["mapped"].sum() == STEPS
    np.testing.assert_allclose(taux["centroid"].numpy(),
                               np.asarray(jaux["centroid"]), atol=1e-4)
    # the best particle is an argmax over weights that can tie within
    # float32 rounding (duplicates after resampling, the match^0.1
    # factor): most frames must pick the same pose
    same = np.isclose(taux["best_pose"].numpy(),
                      np.asarray(jaux["best_pose"]), atol=1e-4).all(axis=1)
    assert same.mean() >= 0.8, same


def test_final_particles_and_pool(runs):
    got = convert.to_numpy(runs["tcarry"])
    ref = as_dict(runs["jcarry"])
    for name, val in ref["filter"]["particles"].items():
        if val.dtype.kind in "biu":
            np.testing.assert_array_equal(got["filter"]["particles"][name],
                                          val, err_msg=name)
        else:
            np.testing.assert_allclose(got["filter"]["particles"][name], val,
                                       rtol=1e-4, atol=1e-5, err_msg=name)
    assert int(got["alloc_failed"]) == int(ref["alloc_failed"])
    assert got["update_idx"] == int(ref["update_idx"]) == STEPS
    for name in ("ud_pos", "ud_q", "map_pos", "map_q"):
        np.testing.assert_allclose(got[name], ref[name], rtol=1e-6,
                                   err_msg=name)
    for name in ("chain", "meta", "allocated"):
        np.testing.assert_array_equal(got["pool"][name], ref["pool"][name],
                                      err_msg=name)
    # rolled-over grids are centred on particle positions
    for name in ("mean", "stdev", "height", "origin"):
        np.testing.assert_allclose(got["pool"][name], ref["pool"][name],
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    assert (ref["pool"]["meta"] & 1).sum() > 5 * N


def test_rollover_and_copy_on_write_fired(runs):
    seen = runs["seen"]
    assert seen["dup_heads"] > 0, seen
    assert seen["rolled"] > 0, seen
    assert (np.asarray(runs["jcarry"].pool.chain)[:, 1] >= 0).any()


def test_precompute_odometry(runs):
    ref = as_dict(runs["jodos"])
    got = convert.to_numpy(runs["todos"])
    for name, val in ref.items():
        np.testing.assert_allclose(got[name], val, rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    assert np.abs(ref["delta_xy"]).max() > 0.01      # the robot moves


def test_asguard_contact_states():
    js, ts = JSim(terrain=terrain), TSim(terrain=terrain)
    for _ in range(3):
        jpos, jyaw = js.step(wheel_delta=0.4, yaw_rate=0.05, substeps=4)
        tpos, tyaw = ts.step(wheel_delta=0.4, yaw_rate=0.05, substeps=4)
        np.testing.assert_array_equal(tpos, jpos)
        assert tyaw == jyaw
        np.testing.assert_array_equal(ts.orientation, js.orientation)
        for full in (True, False):
            jc, tc = js.contact_state(), ts.contact_state()
            if not full:
                jc, tc = jc.compact(CAP), tc.compact(CAP)
            for name, val in as_dict(jc).items():
                np.testing.assert_array_equal(
                    convert.to_numpy(tc)[name], val, err_msg=name)


@pytest.mark.parametrize("env_seed", [False, True])
def test_filter_init(env_seed):
    """Per-particle init from a blank template and from an environment
    grid (clone-from-env), and the read-outs."""
    from slam_eslam_tpu.mapping import mls_grid as jmls

    cfg = config(False)
    grid = None
    if env_seed:
        grid = jmls.MLSGrid.create(8, 8, 0.25, (-1.0, -1.0), k=4)
        grid = dataclasses.replace(grid, valid=grid.valid.at[2:5, 3].set(True),
                                   mean=grid.mean.at[2:5, 3].set(0.4))
    jf = JFilter(config=cfg)
    jf.init(pose=(np.array([0.3, -0.2, 0.1]), 0.2), shared_grid=grid,
            use_shared_map=False, num_contact_points=20)
    nxy, nyaw = init_normals(cfg.seed, N)
    tf = TFilter(config=cfg)
    tf.init(pose=(np.array([0.3, -0.2, 0.1]), 0.2),
            shared_grid=(None if grid is None
                         else convert.mls_grid_from(as_dict(grid))),
            use_shared_map=False, num_contact_points=20, normal_xy=nxy,
            normal_yaw=nyaw)
    ref, got = as_dict(jf.state.particles), convert.to_numpy(
        tf.get_particles())
    for name, val in ref.items():
        np.testing.assert_allclose(got[name], val, rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    for name, val in as_dict(jf.pool).items():
        if val is not None:
            np.testing.assert_array_equal(convert.to_numpy(tf.pool)[name],
                                          val, err_msg=name)
    assert tf.get_best_particle_index() == jf.get_best_particle_index()
    for a, b in zip(tf.get_centroid(), jf.get_centroid()):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
