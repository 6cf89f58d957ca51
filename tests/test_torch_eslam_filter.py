"""The port's application API, ``EmbodiedSlamFilter.update_contact``,
against the JAX package's over 40 steps of ``models.sim.TrajectorySim``
at 96 particles, with the JAX random draws injected: the shared map with
``log_debug`` (the unfolded lookup), the surface hash (global init and
reinjection), terrain labels with the slip update (the colour lookup),
and per-particle maps (the chain lookup).  The motion-gate decisions
must be equal and the centroids within 1e-4 m at every step.  Also:
``project`` without recovery spreading under a hash, the distribution
export, the gate's terrain-label rule and the entry points still queued.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_eslam_tpu.config import Config, ContactModelConfig, SurfaceHashConfig
from slam_eslam_tpu.filter import eslam_filter as jef
from slam_eslam_tpu.filter import pose_estimator as jpe
from slam_eslam_tpu.filter import surface_hash as jsh
from slam_eslam_tpu.models import sim as jsim
from slam_eslam_tpu.utils import geometry as jgeom
from slam_eslam_tpu_torch import convert
from slam_eslam_tpu_torch.filter import eslam_filter as tef
from slam_eslam_tpu_torch.filter import pose_estimator as tpe
from torch_jax_draws import (as_dict, gaussian_normals, project_draws,
                             randint_draws, resample_draws, t)

torch.set_num_threads(2)

N = 96
STEPS = 40
CENTROID_ATOL = 1e-4
HASH = SurfaceHashConfig(use_hash=True, slope_bins=10, angular_steps=4,
                         period=5)


def terrain(x, y):
    x, y = np.asarray(x), np.asarray(y)
    return 0.2 * np.sin(x) + 0.15 * np.cos(0.8 * y) + 0.05 * x


def classes(x, y):
    """Terrain-class colours: class 0 west of x = 0.3, class 1 east."""
    east = np.asarray(x) > 0.3
    return np.stack([~east, east, np.zeros_like(east)], -1).astype(np.float32)


def config(**kw):
    kw.setdefault("contact_model", ContactModelConfig(contact_point_radius=0.0))
    return dataclasses.replace(
        Config(), particle_count=N, min_effective=N // 2, grid_size=8.0,
        grid_resolution=0.25, map_pool_blocks=N + 16, map_chain_length=3,
        map_pool_color=False, **kw)


def jax_grid(colour=False):
    g = jsim.terrain_grid(terrain, nx=64, ny=64, resolution=0.25,
                          origin=(-8.0, -8.0))
    if colour:
        xy = g.from_grid(*jnp.meshgrid(jnp.arange(64), jnp.arange(64),
                                       indexing="ij"))
        rgb = classes(np.asarray(xy[..., 0]), np.asarray(xy[..., 1]))
        g = dataclasses.replace(g, color=jnp.broadcast_to(
            jnp.asarray(rgb)[:, :, None, :], g.color.shape))
    return g


MODES = {
    "shared_log_debug": dict(cfg=dict(log_debug=True)),
    "hash": dict(hash=HASH),
    "slip_labels": dict(cfg=dict(contact_model=ContactModelConfig(
        contact_point_radius=0.0, use_slip_update=True, min_contacts=2)),
        labels=True),
    "per_particle": dict(shared=False),
}


def labels(step):
    """Per-wheel classifications: wheels 0 and 1 on class 0, wheel 3 on
    class 1 after the first ten steps."""
    out = [(0, [0.8, 0.1, 0.1]), (1, [0.7, 0.2, 0.1])]
    if step >= 10:
        out.append((3, [0.1, 0.8, 0.1]))
    return out


def hash_draws(jf, key, cs, q):
    """``reinject``'s in-bucket draws from its key."""
    _, k_s = jax.random.split(key)
    sx, sy = jf.hash.signature(cs, jnp.asarray(q))
    bins = jf.hash.config.slope_bins
    b = jsh._bucket_index(sx, bins) * bins + jsh._bucket_index(sy, bins)
    return randint_draws(k_s, N, jf.hash.bucket_count[b])


@pytest.mark.parametrize("mode", MODES)
def test_update_contact_matches_jax(mode):
    opt = MODES[mode]
    cfg = config(**opt.get("cfg", {}))
    shared = opt.get("shared", True)
    jgrid = jax_grid(colour=opt.get("labels", False))
    z0 = float(terrain(0.0, 0.0)) + 0.2
    pose = (np.array([0.0, 0.0, z0]), 0.0)
    jf = jef.EmbodiedSlamFilter(config=cfg).init(
        pose, shared_grid=jgrid, use_shared_map=shared,
        hash_config=opt.get("hash"))
    _, k_init = jax.random.split(jax.random.PRNGKey(cfg.seed))
    kw = {}
    if "hash" in opt:
        kw["hash_u"] = randint_draws(k_init, N, jf.hash.n_valid)
    else:
        kw["normal_xy"], kw["normal_yaw"] = gaussian_normals(k_init, N)
    tf = tef.EmbodiedSlamFilter(config=cfg).init(
        pose, shared_grid=convert.mls_grid_from(as_dict(jgrid)),
        use_shared_map=shared, hash_config=opt.get("hash"), **kw)
    for name, val in as_dict(jf.state.particles).items():
        np.testing.assert_allclose(getattr(tf.state.particles, name).numpy(),
                                   val, rtol=1e-6, err_msg=name)

    sim = jsim.TrajectorySim(terrain, speed=0.05, yaw_rate=0.02)
    gates = []
    for step in range(STEPS):
        (pos, yaw), _ = sim.step()
        cs = sim.contact_state(noise=0.005)
        q = np.asarray(jgeom.quat_from_yaw(jnp.asarray(yaw, jnp.float32)))
        ltc = labels(step) if opt.get("labels") else None
        key, proj = project_draws(jf.state.key, N)
        key, u = resample_draws(key, N)
        draws = tef.ContactDraws(
            proj, u, hash_draws(jf, key, cs, q) if "hash" in opt else None)
        ref = jf.update_contact((q, pos.copy()), cs, ltc)
        got = tf.update_contact((q, pos.copy()),
                                convert.body_contact_state_from(as_dict(cs)),
                                ltc, draws=draws)
        assert got == ref, f"step {step}: gates differ"
        gates.append(got)
        c_ref, q_ref = jf.get_centroid()
        c_got, q_got = tf.get_centroid()
        np.testing.assert_allclose(c_got.numpy(), np.asarray(c_ref), rtol=0,
                                   atol=CENTROID_ATOL, err_msg=f"step {step}")
        np.testing.assert_allclose(q_got.numpy(), np.asarray(q_ref),
                                   atol=1e-5)
    assert 0 < sum(gates) <= STEPS
    assert tf.steps == STEPS
    p = tf.state.particles
    assert not p.floating.all() and torch.isfinite(p.weight).all()
    if mode == "shared_log_debug":
        assert tf.last_eval.cp_ok.any()
    if not shared:
        assert torch.equal(tf.pool.chain[:, 0], jnp_to_t(jf.pool.chain[:, 0]))


def jnp_to_t(a):
    return torch.from_numpy(np.asarray(a))


def test_project_skips_spreading_under_a_hash():
    cfg = config()
    state = jpe.PoseEstimatorState.create(cfg, 20)
    state = dataclasses.replace(state, particles=jpe.init_gaussian(
        jax.random.PRNGKey(1), N, (0.0, 0.0), 0.0, (0.2, 0.2), 0.05, 0.2,
        0.1))        # max_weight 0: recovery spreading at full strength
    q = np.asarray(jgeom.quat_from_yaw(jnp.asarray(0.3, jnp.float32)))
    _, draws = project_draws(state.key, N)
    tstate = convert.pose_estimator_state_from(as_dict(state))
    moved = {}
    for use_hash in (False, True):
        ref = jpe.project(state, jnp.asarray(q), cfg, use_hash=use_hash)
        got = tpe.project(tstate, t(q), cfg, draws, use_hash=use_hash)
        for name, val in as_dict(ref.particles).items():
            np.testing.assert_allclose(getattr(got.particles, name).numpy(),
                                       val, rtol=1e-5, atol=1e-6,
                                       err_msg=name)
        moved[use_hash] = got.particles.x
    assert not torch.allclose(moved[False], moved[True])


def test_distribution_export():
    cfg = config(log_debug=True, log_particle_period=3)
    jgrid = jax_grid()
    pose = (np.array([0.0, 0.0, 0.4]), 0.0)
    jf = jef.EmbodiedSlamFilter(config=cfg).init(pose, shared_grid=jgrid)
    tf = tef.EmbodiedSlamFilter(config=cfg).init(
        pose, shared_grid=convert.mls_grid_from(as_dict(jgrid)))
    tf.state = convert.pose_estimator_state_from(
        as_dict(jf.state), generator=torch.Generator().manual_seed(0))
    sim = jsim.TrajectorySim(terrain, speed=0.15)
    logged = []
    for _ in range(6):
        (pos, yaw), _ = sim.step()
        cs = sim.contact_state()
        q = np.asarray(jgeom.quat_from_yaw(jnp.asarray(yaw, jnp.float32)))
        tf.update_contact((q, pos), convert.body_contact_state_from(
            as_dict(cs)))
        logged.append(tf.maybe_log_distribution() is not None)
    assert logged == [False, False, True, False, False, True]
    # the JAX export of the same particles, first GMM mean injected
    jstate = dataclasses.replace(jf.state, particles=jpe.ParticleSet(
        **{k: jnp.asarray(v) for k, v in
           convert.to_numpy(tf.state.particles).items()}),
        odometry=dataclasses.replace(
            jf.state.odometry,
            prev_orientation=jnp.asarray(
                tf.state.odometry.prev_orientation.numpy())))
    jf.state = jstate
    ref = jf.get_distribution()
    key = jax.random.fold_in(jstate.key, 17)
    w = jstate.particles.weight / jnp.sum(jstate.particles.weight)
    first = int(jax.random.choice(key, N, (), p=w))
    got = tf.get_distribution(first=first)
    for name in ("gmm_means", "gmm_covs", "gmm_weights", "orientation"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    # log_debug: the last measurement's contact points ride along
    assert got.cpoints.shape == tf.last_eval.cp_point.shape
    assert torch.equal(got.cpoint_mask, tf.last_eval.cp_ok)
    assert got.cpoint_mask.any()


def test_terrain_labels_force_the_update():
    cfg = config()
    tf = tef.EmbodiedSlamFilter(config=cfg).init(
        (np.array([0.0, 0.0, 0.4]), 0.0),
        shared_grid=convert.mls_grid_from(as_dict(jax_grid())))
    sim = jsim.TrajectorySim(terrain, speed=0.05)
    (pos, yaw), _ = sim.step()
    cs = convert.body_contact_state_from(as_dict(sim.contact_state()))
    q = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    assert tf.update_contact((q, pos), cs) is True     # anchor 1000 m away
    assert tf.update_contact((q, pos + [0.001, 0, 0]), cs) is False
    # an empty label set does not force it (ltc.size() > 0, :360)
    assert tf.update_contact((q, pos), cs, terrain_classifications=[]) is False
    assert tf.update_contact((q, pos), cs,
                             terrain_classifications=[(0, [1, 0, 0])]) is True
    assert tf.steps == 4


def test_queued_entry_points_raise():
    tf = tef.EmbodiedSlamFilter(config=config())
    for name in ("update_scan", "update_distance_image", "process_map",
                 "run_stream"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            getattr(tf, name)(None, None, None)
    assert tf.update_featurecloud(None) is False
    slip = config(contact_model=ContactModelConfig(use_slip_update=True))
    tf = tef.EmbodiedSlamFilter(config=slip).init(
        (np.zeros(3), 0.0), use_shared_map=False)
    with pytest.raises(NotImplementedError, match="colour chain lookup"):
        tf.update_contact((np.array([1.0, 0, 0, 0]), np.zeros(3)),
                          convert.body_contact_state_from(as_dict(
                              jsim.conformal_contact_state(
                                  np.zeros(3), 0.0, terrain))))
