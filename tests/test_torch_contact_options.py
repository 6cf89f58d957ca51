"""The contact model's options in the port against the JAX package: debug
points, Chitta weighting, terrain probabilities (array and callable,
with the slip-point payload), ``lowest_point_per_group`` and the
per-particle ``evaluate_pose``; the ``log_debug`` route through
``update_weights`` and the filter step; the terrain fusion helpers, the
GMM fit and the distribution export.

The JAX side looks up through ``make_lookup`` in its production ``auto``
mode (the unfolded Pallas lookup in interpret mode) or the unpacked
colour gather.  Tolerances: masks and counts exact, floats rtol 1e-5,
``cp_point`` atol 1e-6 m, ``terrain.*`` rtol 1e-6, the GMM rtol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_eslam_tpu.config import Config, ContactModelConfig
from slam_eslam_tpu.core import distribution as jdist
from slam_eslam_tpu.core import gmm as jgmm
from slam_eslam_tpu.core.state import BodyContactState as JContactState
from slam_eslam_tpu.core.state import ParticleSet as JParticleSet
from slam_eslam_tpu.filter import pose_estimator as jpe
from slam_eslam_tpu.filter import step as jstep
from slam_eslam_tpu.mapping import lookup as jlookup
from slam_eslam_tpu.models import contact_model as jcm
from slam_eslam_tpu.models import sim as jsim
from slam_eslam_tpu.models import terrain as jterr
from slam_eslam_tpu_torch import convert
from slam_eslam_tpu_torch.core import distribution as tdist
from slam_eslam_tpu_torch.core import gmm as tgmm
from slam_eslam_tpu_torch.filter import pose_estimator as tpe
from slam_eslam_tpu_torch.filter import step as tstep
from slam_eslam_tpu_torch.mapping import lookup as tlookup
from slam_eslam_tpu_torch.models import contact_model as tcm
from slam_eslam_tpu_torch.models import terrain as tterr
from torch_jax_draws import as_dict, project_draws, resample_draws, t

torch.set_num_threads(2)

N = 64
RTOL = 1e-5
GROUPS = np.array([0, 0, 0, 1, 1, -1, 2, 2, 2, 2, -1, 3, 3], np.int32)


def terrain(x, y):
    return 0.25 * np.sin(1.3 * np.asarray(x)) + 0.2 * np.cos(
        0.9 * np.asarray(y))


def contact_state(seed):
    """Grouped candidates under four wheels and two ungrouped ones, some
    inactive (contact below 0.2), one of unknown contact (NaN), one
    padding slot, and an exact tie in height inside group 2."""
    rng = np.random.default_rng(seed)
    c = GROUPS.shape[0]
    wheel = np.array([[-0.25, -0.3], [0.25, -0.3], [-0.25, 0.3], [0.25, 0.3]])
    xy = np.where(GROUPS[:, None] >= 0,
                  wheel[np.clip(GROUPS, 0, 3)], rng.uniform(-0.4, 0.4, (c, 2)))
    xy = xy + rng.uniform(-0.05, 0.05, (c, 2))
    z = -0.2 + rng.normal(0.0, 0.03, c)
    z[6] = z[7] = z[6:10].min() - 0.01     # group 2's lowest, twice
    contact = rng.uniform(0.0, 1.0, c)
    contact[[0, 6, 7, 11]] = 0.9
    contact[9] = np.nan
    valid = np.ones(c, bool)
    valid[12] = False
    return JContactState.create(
        np.concatenate([xy, z[:, None]], -1).astype(np.float32),
        contact=contact, group_id=GROUPS, valid=valid)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(0)
    jgrid = jsim.terrain_grid(terrain, nx=64, ny=64, resolution=0.1,
                              origin=(-3.2, -3.2))
    color = rng.random(jgrid.color.shape).astype(np.float32)
    jgrid = dataclasses.replace(jgrid, color=jnp.asarray(color))
    x, y = rng.normal(0.0, 0.3, (2, N))
    particles = dataclasses.replace(
        JParticleSet.zeros(N), x=jnp.asarray(x, jnp.float32),
        y=jnp.asarray(y, jnp.float32),
        yaw=jnp.asarray(rng.normal(0.0, 0.1, N), jnp.float32),
        z=jnp.asarray(terrain(x, y) + 0.2 + rng.normal(0, 0.02, N),
                      jnp.float32),
        z_sigma=jnp.full((N,), 0.05, jnp.float32))
    rot, trans = particles.pose_matrix()
    cfg = dataclasses.replace(
        Config(), particle_count=N, min_effective=N // 2, lookup_mode="auto",
        contact_model=ContactModelConfig(contact_point_radius=0.01,
                                         min_contacts=2))
    q = np.array([np.cos(0.1), 0.05, -0.03, np.sin(0.1)], np.float32)
    q /= np.linalg.norm(q)
    wheel_probs = rng.dirichlet(np.ones(3), 4).astype(np.float32)
    wheel_valid = np.array([True, False, True, True])
    return dict(
        cfg=cfg, jgrid=jgrid, tgrid=convert.mls_grid_from(as_dict(jgrid)),
        cs=contact_state(1), q=q, rot=rot, trans=trans,
        mv=particles.z_sigma ** 2 + cfg.measurement_error ** 2,
        particles=particles, wheel_probs=wheel_probs,
        wheel_valid=wheel_valid,
        point_probs=rng.uniform(0.2, 1.0, GROUPS.shape).astype(np.float32))


def lookups(world, colour):
    """(JAX, port) lookups: the auto lookup, or the colour gather."""
    if colour:
        return (jlookup.shared_grid_lookup(world["jgrid"], 3.0, packed=False),
                tlookup.shared_grid_lookup(world["tgrid"], 3.0, packed=False))
    return (jlookup.make_lookup(world["cfg"], world["jgrid"]),
            tlookup.make_lookup(world["cfg"], world["tgrid"]))


def terrain_probs(world, kind):
    """(JAX, port) ``terrain_prob`` arguments."""
    if kind is None:
        return None, None
    if kind == "array":
        p = world["point_probs"]
        return jnp.asarray(p), torch.from_numpy(p)
    wp, wv = world["wheel_probs"], world["wheel_valid"]
    jwp, jwv, twp, twv = (jnp.asarray(wp), jnp.asarray(wv),
                          torch.from_numpy(wp), torch.from_numpy(wv))
    return (lambda gid, col: jterr.per_point_probability(
                gid, col, jwp, jwv, with_mask=True),
            lambda gid, col: tterr.per_point_probability(
                gid, col, twp, twv, with_mask=True))


def assert_eval_close(got, ref):
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name).numpy(), np.asarray(getattr(ref, f.name))
        assert a.shape == b.shape, f.name
        if b.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        elif f.name in ("cp_point", "sp_point"):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6,
                                       err_msg=f.name)
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-7,
                                       err_msg=f.name)


CASES = {
    "debug": dict(debug=True),
    "chitta": dict(weighting="chitta"),
    "chitta_debug": dict(weighting="chitta", debug=True),
    "terrain_array": dict(terrain="array", slip=True),
    "terrain_callable_debug": dict(terrain="callable", slip=True, debug=True,
                                   colour=True),
    "unfolded_ratio": dict(fold=False),
}


@pytest.mark.parametrize("case", CASES)
def test_evaluate_pose_batch(world, case):
    opt = CASES[case]
    cmc = dataclasses.replace(
        world["cfg"].contact_model, weighting=opt.get("weighting", "ratio"),
        use_slip_update=opt.get("slip", False),
        fold_lookup=opt.get("fold", True))
    debug = opt.get("debug", False)
    jl, tl = lookups(world, opt.get("colour", False))
    jtp, ttp = terrain_probs(world, opt.get("terrain"))
    q, cs = world["q"], world["cs"]
    ref = jax.jit(lambda c, r, tr, mv: jcm.evaluate_pose_batch(
        jcm.set_contact_points(c, q), r, tr, mv,
        jpe.bind_lookup(jl, jnp.zeros(N, jnp.int32)), cmc, terrain_prob=jtp,
        with_debug_points=debug))(cs, world["rot"], world["trans"],
                                  world["mv"])
    got = tcm.evaluate_pose_batch(
        tcm.set_contact_points(convert.body_contact_state_from(as_dict(cs)),
                               t(q)),
        t(world["rot"]), t(world["trans"]), t(world["mv"]),
        tpe.bind_lookup(tl, None), cmc, terrain_prob=ttp,
        with_debug_points=debug)
    assert_eval_close(got, ref)
    ok = np.asarray(ref.cp_ok)
    assert ok.any() and np.asarray(ref.measurement_valid).any()
    if debug:
        assert (np.abs(got.cp_point.numpy()[ok]).sum(-1) > 0).all()
    if opt.get("terrain") == "callable":
        assert np.asarray(ref.sp_ok).any()


@pytest.mark.parametrize("case", ["ratio", "chitta", "terrain_callable"])
def test_evaluate_pose_per_particle(world, case):
    """One particle at a time against JAX ``evaluate_pose``, and the
    port's batch against its own per-particle oracle."""
    cmc = dataclasses.replace(
        world["cfg"].contact_model,
        weighting="chitta" if case == "chitta" else "ratio",
        use_slip_update=case == "terrain_callable")
    jl, tl = lookups(world, colour=True)
    jtp, ttp = terrain_probs(world, "callable" if case == "terrain_callable"
                             else None)
    q = world["q"]
    jcs = jcm.set_contact_points(world["cs"], q)
    tcs = tcm.set_contact_points(
        convert.body_contact_state_from(as_dict(world["cs"])), t(q))
    one = jax.jit(lambda r, tr, mv: jcm.evaluate_pose(
        jcs, r, tr, mv, lambda p: jl(None, p), cmc, terrain_prob=jtp))
    batch = tcm.evaluate_pose_batch(
        tcs, t(world["rot"]), t(world["trans"]), t(world["mv"]),
        tpe.bind_lookup(tl, None), cmc, terrain_prob=ttp,
        with_debug_points=True)
    for i in (0, 5, 17, 40):
        ref = one(world["rot"][i], world["trans"][i], world["mv"][i])
        got = tcm.evaluate_pose(tcs, t(world["rot"][i]), t(world["trans"][i]),
                                t(world["mv"][i]), lambda p: tl(None, p),
                                cmc, terrain_prob=ttp)
        assert_eval_close(got, ref)
        ok = got.cp_ok
        for f in dataclasses.fields(got):
            a, b = getattr(got, f.name), getattr(batch, f.name)[i]
            if f.name == "z_delta" and case == "chitta" and not ok.any():
                continue        # the batch answers 0 where the oracle has -inf
            if f.name == "cp_point":
                # the point of a group without a valid member is arbitrary
                a, b = a[ok], b[ok]
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                       atol=1e-6, err_msg=f.name)


def test_lowest_point_per_group(world):
    cs = world["cs"]
    ref = jcm.lowest_point_per_group(cs)
    got = tcm.lowest_point_per_group(
        convert.body_contact_state_from(as_dict(cs)))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    mask = got[1].numpy()
    # one point per wheel (the tie in group 2 goes to the first), both
    # valid ungrouped points, nothing from the padding slot
    assert mask.sum() == 6 and mask[6] and not mask[7] and not mask[12]


class TestLogDebug:
    """``Config.log_debug`` asks for debug points, so the weighting takes
    the unfolded lookup in both packages and returns the payload."""

    def _cfg(self, world):
        return dataclasses.replace(world["cfg"], log_debug=True)

    def _state(self, world):
        return dataclasses.replace(
            jpe.PoseEstimatorState.create(world["cfg"], 13),
            particles=world["particles"])

    def test_update_weights_takes_unfolded_branch(self, world):
        cfg, jstate, q, cs = (self._cfg(world), self._state(world),
                              world["q"], world["cs"])
        jl, tl = lookups(world, colour=False)
        ref_state, ref = jax.jit(lambda s, c: jpe.update_weights(
            s, c, q, jl, cfg))(jstate, cs)
        got_state, got = tpe.update_weights(
            convert.pose_estimator_state_from(as_dict(jstate)),
            convert.body_contact_state_from(as_dict(cs)), t(q), tl, cfg)
        ok = np.asarray(ref.cp_ok)
        assert ok.any()
        np.testing.assert_array_equal(got.cp_ok.numpy(), ok)
        assert (np.abs(got.cp_point.numpy()[ok]).sum(-1) > 0).all()
        assert_eval_close(got, ref)
        np.testing.assert_allclose(got_state.particles.weight.numpy(),
                                   np.asarray(ref_state.particles.weight),
                                   rtol=1e-4, atol=1e-6)

    def test_filter_step(self, world):
        cfg, jstate, q, cs = (self._cfg(world), self._state(world),
                              world["q"], world["cs"])
        jl, tl = lookups(world, colour=False)
        gate = (np.float32(1.0), np.float32(0.0))
        ref, aux = jstep.make_filter_step(cfg, jl)(jstate, cs, q, gate)
        key, proj = project_draws(jstate.key, N)
        _, u = resample_draws(key, N)
        got, taux = tstep.make_filter_step(cfg, tl)(
            convert.pose_estimator_state_from(as_dict(jstate)),
            convert.body_contact_state_from(as_dict(cs)), t(q), gate,
            tstep.StepDraws(proj, u))
        assert bool(taux["updated"]) and bool(aux["updated"])
        np.testing.assert_allclose(float(taux["ess"]), float(aux["ess"]),
                                   rtol=1e-4)
        for name, val in as_dict(ref.particles).items():
            np.testing.assert_allclose(
                getattr(got.particles, name).numpy(), val, rtol=1e-4,
                atol=1e-5, err_msg=name)


class TestTerrain:
    def test_joint_and_rgb(self):
        rng = np.random.default_rng(3)
        vis = rng.dirichlet(np.ones(3), 16).astype(np.float32)
        prop = rng.dirichlet(np.ones(3), 16).astype(np.float32)
        vis[0] = 0.0                                 # no information
        np.testing.assert_allclose(
            tterr.joint_probability(t(vis), t(prop)).numpy(),
            np.asarray(jterr.joint_probability(vis, prop)), rtol=1e-6)
        rgb = tterr.to_rgb(t(vis))
        np.testing.assert_allclose(rgb.numpy(),
                                   np.asarray(jterr.to_rgb(jnp.asarray(vis))),
                                   rtol=1e-6)
        np.testing.assert_allclose(tterr.from_rgb(rgb).numpy(),
                                   np.asarray(jterr.from_rgb(rgb.numpy())),
                                   rtol=1e-6)

    def test_per_point_probability(self, world):
        rng = np.random.default_rng(4)
        color = rng.random((5, GROUPS.shape[0], 3)).astype(np.float32)
        color[:, 2] = 0.0                            # black: uniform
        args = (GROUPS, color, world["wheel_probs"], world["wheel_valid"])
        ref = jterr.per_point_probability(*map(jnp.asarray, args),
                                          with_mask=True)
        got = tterr.per_point_probability(*map(t, args), with_mask=True)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def cluster_cloud(n=300, seed=5):
    rng = np.random.default_rng(seed)
    centres = np.array([[0.0, 0.0], [2.0, 1.0], [-1.5, 2.5]])
    xy = centres[rng.integers(0, 3, n)] + rng.normal(0, 0.3, (n, 2))
    return xy.astype(np.float32), rng.gamma(2.0, size=n).astype(np.float32)


def test_fit_gmm():
    xy, w = cluster_cloud()
    key = jax.random.PRNGKey(7)
    first = jax.random.choice(key, xy.shape[0], (),
                              p=jnp.asarray(w) / w.sum())
    ref = jgmm.fit_gmm(key, jnp.asarray(xy), jnp.asarray(w))
    got = tgmm.fit_gmm(t(xy), t(w), first=int(first))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)
    # drawn from a generator when not given: a valid mixture
    means, covs, mix, resp = tgmm.fit_gmm(
        t(xy), t(w), generator=torch.Generator().manual_seed(0))
    assert abs(float(mix.sum()) - 1.0) < 1e-5
    assert torch.isfinite(covs).all() and resp.shape == (xy.shape[0], 3)


@pytest.mark.parametrize("with_eval", [False, True])
def test_export_distribution(world, with_eval):
    p = world["particles"]
    key = jax.random.PRNGKey(11)
    w = p.weight / jnp.sum(p.weight)
    first = int(jax.random.choice(key, N, (), p=w))
    jl, tl = lookups(world, colour=False)
    jres = tres = None
    cs, q = world["cs"], world["q"]
    tcs = convert.body_contact_state_from(as_dict(cs))
    if with_eval:
        cmc = world["cfg"].contact_model
        jres = jcm.evaluate_pose_batch(
            jcm.set_contact_points(cs, q), world["rot"], world["trans"],
            world["mv"], jpe.bind_lookup(jl, p.map_id), cmc,
            with_debug_points=True)
        tres = tcm.evaluate_pose_batch(
            tcm.set_contact_points(tcs, t(q)), t(world["rot"]),
            t(world["trans"]), t(world["mv"]), tpe.bind_lookup(tl, None),
            cmc, with_debug_points=True)
    ref = jdist.export_distribution(key, p, q, cs, time=1.5,
                                    eval_result=jres)
    got = tdist.export_distribution(
        convert.particle_set_from(as_dict(p)), t(q), tcs, time=1.5,
        eval_result=tres, first=first)
    for name in ("time", "gmm_means", "gmm_covs", "gmm_weights",
                 "orientation", "cpoints", "cpoint_mask"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=name)
    assert got.cpoints.shape == ((N, GROUPS.shape[0], 3) if with_eval
                                 else (N, 0, 3))
