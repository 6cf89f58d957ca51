"""The port's localisation step against the JAX package: the simulation
fixtures, ``init_gaussian``, ``project``, ``evaluate_pose_batch``,
``update_weights``, ``update``, the gated filter step and a 5-step
``make_scan_runner``.  The JAX side uses ``make_lookup(cfg, grid)`` in
its production ``auto`` mode (the contact fold through the Pallas
kernel in interpret mode); the port gets the JAX random draws, rebuilt
by repeating the JAX key splits.

Tolerances: particle fields rtol 1e-4 / atol 1e-5, centroids atol
1e-4 m; resampling indices must agree exactly (a +-1 difference would
show as a particle-field mismatch).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_eslam_tpu.config import Config, ContactModelConfig
from slam_eslam_tpu.filter import pose_estimator as jpe
from slam_eslam_tpu.filter import step as jstep
from slam_eslam_tpu.mapping.lookup import make_lookup as jmake_lookup
from slam_eslam_tpu.models import contact_model as jcm
from slam_eslam_tpu.models import sim as jsim
from slam_eslam_tpu.models.asguard import AsguardSim
from slam_eslam_tpu_torch import bench as tbench
from slam_eslam_tpu_torch import convert
from slam_eslam_tpu_torch.filter import pose_estimator as tpe
from slam_eslam_tpu_torch.filter import step as tstep
from slam_eslam_tpu_torch.mapping.lookup import make_lookup as tmake_lookup
from slam_eslam_tpu_torch.models import contact_model as tcm
from slam_eslam_tpu_torch.models import sim as tsim
from slam_eslam_tpu_torch.utils import tree

torch.set_num_threads(2)

N = 128
T = 5
CAP = 8
RTOL, ATOL = 1e-4, 1e-5
GRID = dict(nx=64, ny=64, resolution=0.1, origin=(-3.2, -3.2))


def terrain(x, y):
    return 0.25 * np.sin(1.3 * np.asarray(x)) + 0.2 * np.cos(
        0.9 * np.asarray(y))


def as_dict(pytree):
    return jax.tree_util.tree_map(np.asarray, dataclasses.asdict(pytree))


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def world():
    """Config, the two lookups, an Asguard trajectory compacted to 8
    contact candidates as the benchmark feeds it, the JAX initial state
    and the JAX states after 1..3 odometry + project calls (so the
    measurement tests start from a propagated cloud)."""
    cfg = dataclasses.replace(
        Config(), particle_count=N, min_effective=N // 2,
        contact_model=ContactModelConfig(contact_point_radius=0.0),
        lookup_mode="auto",
    )
    jgrid = jsim.terrain_grid(terrain, **GRID)
    sim = AsguardSim(terrain=terrain)
    z0 = float(sim.position[2])
    frames = []
    for _ in range(T):
        sim.step(wheel_delta=0.3, yaw_rate=0.05)
        frames.append((sim.contact_state().compact(CAP), sim.orientation))
    state = jpe.PoseEstimatorState.create(cfg, CAP)
    particles = jpe.init_gaussian(jax.random.PRNGKey(0), N, (0.0, 0.0), 0.0,
                                  (0.1, 0.1), 0.05, z0, 0.1)
    state = dataclasses.replace(state, particles=particles)

    @jax.jit
    def advance(s, cs, q):
        odo = jstep.odom.update(s.odometry, cs, q, jstep.cfg_odo(cfg))
        return jpe.project(dataclasses.replace(s, odometry=odo), q, cfg)

    advanced = [state]
    for cs, q in frames[:3]:
        advanced.append(advance(advanced[-1], cs, q))
    jlookup = jmake_lookup(cfg, jgrid)
    return dict(
        cfg=cfg, jlookup=jlookup,
        tlookup=tmake_lookup(cfg, convert.mls_grid_from(as_dict(jgrid))),
        jgrid=jgrid, frames=frames, state=state, advanced=advanced,
        update=jax.jit(lambda s, c, q: jpe.update(s, c, q, jlookup, cfg)),
        step=jstep.make_filter_step(cfg, jlookup),
    )


def port_state(jstate):
    return convert.pose_estimator_state_from(as_dict(jstate))


def port_contact(cs):
    return convert.body_contact_state_from(as_dict(cs))


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


def step_draws(key, n, steps):
    out = []
    for _ in range(steps):
        key, proj = project_draws(key, n)
        key, u = resample_draws(key, n)
        out.append(tstep.StepDraws(proj, u))
    return out


def assert_particles_close(port, ref, rtol=RTOL, atol=ATOL):
    got = convert.to_numpy(port)
    for name, val in as_dict(ref).items():
        if val.dtype.kind in "biu":
            np.testing.assert_array_equal(got[name], val, err_msg=name)
        else:
            np.testing.assert_allclose(got[name], val, rtol=rtol, atol=atol,
                                       err_msg=name)


def assert_state_close(port, ref):
    assert_particles_close(port.particles, ref.particles)
    np.testing.assert_allclose(float(port.max_weight), float(ref.max_weight),
                               rtol=RTOL, atol=ATOL)
    assert int(port.step) == int(ref.step)


class TestSimFixtures:
    def test_terrain_grid(self):
        j = as_dict(jsim.terrain_grid(terrain, **GRID))
        p = convert.to_numpy(tsim.terrain_grid(terrain, **GRID))
        for name in ("valid", "horizontal", "update_idx", "height",
                     "color", "origin"):
            np.testing.assert_array_equal(p[name], j[name], err_msg=name)
        for name in ("mean", "stdev"):
            np.testing.assert_allclose(p[name], j[name], rtol=1e-6,
                                       atol=1e-7, err_msg=name)
        assert p["resolution"] == j["resolution"]

    def test_trajectory_contact_states(self):
        js = jsim.TrajectorySim(terrain, speed=0.05, yaw_rate=0.02)
        ts = tsim.TrajectorySim(terrain, speed=0.05, yaw_rate=0.02)
        for _ in range(4):
            (jp, jy), _ = js.step()
            (tp, ty), _ = ts.step()
            np.testing.assert_array_equal(tp, jp)
            assert ty == jy
            jc = as_dict(js.contact_state(noise=0.005).compact(8))
            tc = convert.to_numpy(ts.contact_state(noise=0.005).compact(8))
            for name, val in jc.items():
                np.testing.assert_array_equal(tc[name], val, err_msg=name)


class TestPoseEstimator:
    def test_init_gaussian(self):
        key = jax.random.PRNGKey(3)
        ref = jpe.init_gaussian(key, N, (0.5, -0.2), 0.3, (0.3, 0.2), 0.05,
                                0.2, 0.3)
        kxy, kyaw = jax.random.split(key)
        got = tpe.init_gaussian(
            N, (0.5, -0.2), 0.3, (0.3, 0.2), 0.05, 0.2, 0.3,
            normal_xy=t(jax.random.normal(kxy, (N, 2))),
            normal_yaw=t(jax.random.normal(kyaw, (N,))),
        )
        assert_particles_close(got, ref, rtol=1e-6, atol=1e-7)

    @pytest.mark.parametrize("max_weight", [0.0, 0.5, 0.95])
    def test_project(self, world, max_weight):
        cfg = world["cfg"]
        cs, q = world["frames"][1]
        jstate = world["advanced"][1]
        jstate = dataclasses.replace(
            jstate, max_weight=jnp.float32(max_weight),
            particles=dataclasses.replace(
                jstate.particles,
                yaw=jstate.particles.yaw.at[::5].add(0.5)),  # off heading
        )
        odo = jax.jit(lambda o, c, q: jstep.odom.update(
            o, c, q, jstep.cfg_odo(cfg)))(jstate.odometry, cs, q)
        jstate = dataclasses.replace(jstate, odometry=odo)
        ref = jax.jit(lambda s, q: jpe.project(s, q, cfg))(jstate, q)
        _, draws = project_draws(jstate.key, N)
        got = tpe.project(port_state(jstate), t(q), cfg, draws)
        assert_state_close(got, ref)

    @pytest.mark.parametrize("fold", [True, False])
    def test_evaluate_pose_batch(self, world, fold):
        cfg = world["cfg"]
        cmc = dataclasses.replace(cfg.contact_model, fold_lookup=fold)
        cs, q = world["frames"][1]
        p = world["advanced"][2].particles
        rot, trans = p.pose_matrix()
        meas_var = p.z_sigma ** 2 + cfg.measurement_error ** 2
        jlookup = (world["jlookup"] if fold
                   else jmake_lookup(dataclasses.replace(
                       cfg, lookup_mode="gather"), world["jgrid"]))
        ref = jax.jit(lambda c, r, tr, mv: jcm.evaluate_pose_batch(
            jcm.set_contact_points(c, q), r, tr, mv,
            jpe.bind_lookup(jlookup, p.map_id), cmc))(cs, rot, trans,
                                                      meas_var)
        got = tcm.evaluate_pose_batch(
            tcm.set_contact_points(port_contact(cs), t(q)), t(rot), t(trans),
            t(meas_var), tpe.bind_lookup(world["tlookup"], None), cmc)
        assert np.asarray(ref.measurement_valid).any()
        for name in ("measurement_valid", "n_contacts"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(ref, name)))
        for name in ("weight", "z_delta", "z_var", "pose_var"):
            np.testing.assert_allclose(
                getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                rtol=RTOL, atol=ATOL, err_msg=name)
        if not fold:
            for name in ("cp_zdiff", "cp_zvar", "cp_ok"):
                np.testing.assert_allclose(
                    getattr(got, name).numpy(),
                    np.asarray(getattr(ref, name)), rtol=RTOL, atol=ATOL,
                    err_msg=name)

    def test_update_weights(self, world):
        cfg = world["cfg"]
        cs, q = world["frames"][2]
        jstate = world["advanced"][3]
        ref, _ = jax.jit(lambda s, c: jpe.update_weights(
            s, c, q, world["jlookup"], cfg))(jstate, cs)
        got, _ = tpe.update_weights(port_state(jstate), port_contact(cs),
                                    t(q), world["tlookup"], cfg)
        assert_state_close(got, ref)
        assert not np.asarray(ref.particles.floating).all()

    @pytest.mark.parametrize("k,peaked", [(1, False), (3, True)])
    def test_update(self, world, k, peaked):
        """Peaked prior weights push the ESS below ``min_effective``, so
        the resampling branch is taken; flat ones skip it."""
        cs, q = world["frames"][k - 1]
        jstate = world["advanced"][k]
        if peaked:
            w = np.random.default_rng(k).gamma(0.2, size=N)
            jstate = dataclasses.replace(jstate, particles=dataclasses.replace(
                jstate.particles, weight=jnp.asarray(w / w.sum(), jnp.float32)))
        ref, aux = world["update"](jstate, cs, q)
        _, u = resample_draws(jstate.key, N)
        got, taux = tpe.update(port_state(jstate), port_contact(cs), t(q),
                               world["tlookup"], world["cfg"], resample_u=u)
        assert bool(aux["resampled"]) == peaked
        assert bool(taux["resampled"]) == peaked
        np.testing.assert_array_equal(taux["resample_idx"].numpy(),
                                      np.asarray(aux["resample_idx"]))
        assert_state_close(got, ref)

    @pytest.mark.parametrize("wrap_safe", [False, True])
    def test_centroid(self, world, wrap_safe):
        p = world["advanced"][2].particles
        p = dataclasses.replace(p, yaw=p.yaw + 3.1)   # across the wrap
        q = world["frames"][1][1]
        pos_j, q_j = jpe.centroid(p, q, wrap_safe=wrap_safe)
        pos_t, q_t = tpe.centroid(convert.particle_set_from(as_dict(p)),
                                  t(q), wrap_safe=wrap_safe)
        np.testing.assert_allclose(pos_t.numpy(), np.asarray(pos_j),
                                   atol=1e-5)
        np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), atol=1e-5)


class TestSteps:
    @pytest.mark.parametrize("gate", [(0.0, 0.0), (1.0, 0.0), (0.0, 1.0)])
    def test_filter_step_gate(self, world, gate):
        cfg = world["cfg"]
        cs, q = world["frames"][1]
        jstate = world["advanced"][1]
        gate = tuple(np.float32(g) for g in gate)
        ref, aux = world["step"](jstate, cs, q, gate)
        draws = step_draws(jstate.key, N, 1)[0]
        got, taux = tstep.make_filter_step(cfg, world["tlookup"])(
            port_state(jstate), port_contact(cs), t(q), gate, draws)
        assert bool(taux["updated"]) == bool(aux["updated"])
        np.testing.assert_allclose(float(taux["ess"]), float(aux["ess"]),
                                   rtol=RTOL)
        assert_state_close(got, ref)

    def test_scan_runner(self, world):
        cfg, jstate = world["cfg"], world["state"]
        css = [cs for cs, _ in world["frames"]]
        qs = np.stack([q for _, q in world["frames"]])
        ref_state, ref_cents = jstep.make_scan_runner(cfg, world["jlookup"])(
            jstate, jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *css),
            jnp.asarray(qs))
        got_state, got_cents = tstep.make_scan_runner(cfg, world["tlookup"])(
            port_state(jstate), tree.stack([port_contact(c) for c in css]),
            t(qs), step_draws(jstate.key, N, T))
        assert got_cents.shape == (T, 3)
        np.testing.assert_allclose(got_cents.numpy(), np.asarray(ref_cents),
                                   rtol=0, atol=1e-4)
        assert_state_close(got_state, ref_state)
        # the trajectory exercised the measurement and resampling paths
        assert not np.asarray(ref_state.particles.floating).all()
        assert np.asarray(ref_state.particles.n_contacts).max() >= 3

    @pytest.mark.parametrize("ablate", ["none", "noupdate"])
    def test_bench_filter_runner(self, world, ablate):
        """The runner that ``slam_eslam_tpu_torch.bench`` times in filter
        mode is this path: on the JAX draws its centroids equal the JAX
        ``make_scan_runner``'s (atol 1e-4 m), and its ``noupdate``
        ablation equals ``bench.py``'s (odometry, ``project`` and centroid
        only)."""
        cfg, jstate = world["cfg"], world["state"]
        css = [cs for cs, _ in world["frames"]]
        qs = np.stack([q for _, q in world["frames"]])
        jcss = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *css)
        if ablate == "none":
            ref_cents = jstep.make_scan_runner(cfg, world["jlookup"])(
                jstate, jcss, jnp.asarray(qs))[1]
        else:
            def one_step(state, inp):
                cs, q = inp
                state = dataclasses.replace(state, odometry=jstep.odom.update(
                    state.odometry, cs, q, jstep.cfg_odo(cfg)))
                state = jpe.project(state, q, cfg)
                return state, jpe.centroid(state.particles, q)[0]

            ref_cents = jax.jit(lambda s, c, q: jax.lax.scan(
                one_step, s, (c, q)))(jstate, jcss, jnp.asarray(qs))[1]
        key, draws = jstate.key, []
        for _ in range(T):
            key, proj = project_draws(key, N)
            u = None
            if ablate == "none":
                key, u = resample_draws(key, N)
            draws.append(tstep.StepDraws(proj, u))
        run = tbench.make_filter_runner(cfg, world["tlookup"], ablate)
        _, got_cents = run(port_state(jstate),
                           tree.stack([port_contact(c) for c in css]), t(qs),
                           draws)
        np.testing.assert_allclose(got_cents.numpy(), np.asarray(ref_cents),
                                   rtol=0, atol=1e-4)
