"""The compiled runners' capture helper, ``slam_eslam_tpu_torch/utils/
graphs.py``, on the CPU.

A CUDA graph needs the card, so these tests drive the helper's buffer
discipline through a stand-in for ``torch.cuda.CUDAGraph``
(``tests/torch_stand_in.py``, injected as the runners' ``graph=``).

* The graphed localisation runner (``make_scan_runner(graph=...)``, N =
  256, T = 12) and the per-step ``make_filter_step(graph=...)`` equal the
  eager port bit for bit, from the state's generator and from injected
  draws; the graphed SLAM runner (``make_slam_scan_runner``, 16 particles
  on 16 x 16 x 4 grids, chains of 3, 64 blocks, 30 frames) likewise, its
  whole pool, chains and ``alloc_failed`` included.
* Both equal the JAX ``make_scan_runner`` / ``make_slam_scan_runner`` on
  the JAX draws (rebuilt by repeating its key splits) within the
  tolerances of ``tests/test_torch_step.py`` (particle fields rtol 1e-4 /
  atol 1e-5, centroids atol 1e-4 m) and ``tests/test_torch_streaming.py``
  (chains, ``meta``, ``allocated`` and ``alloc_failed`` exact, pool float
  fields and origins rtol 1e-5 / atol 1e-6).
* Outputs of an earlier run survive a later one; a replay credits the
  launches its capture recorded, and the capture counts none; a failed
  capture raises; ``graph=True`` on the CPU, or with ``mesh=``, raises.
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
from slam_eslam_tpu.filter import streaming as jst
from slam_eslam_tpu.filter.eslam_filter import EmbodiedSlamFilter as JFilter
from slam_eslam_tpu.mapping.lookup import make_lookup as jmake_lookup
from slam_eslam_tpu.models import sim as jsim
from slam_eslam_tpu.models.asguard import AsguardSim
from slam_eslam_tpu_torch import convert, ops
from slam_eslam_tpu_torch.filter import step as tstep
from slam_eslam_tpu_torch.filter.eslam_filter import EmbodiedSlamFilter
from slam_eslam_tpu_torch.filter import streaming as tst
from slam_eslam_tpu_torch.mapping.lookup import make_lookup as tmake_lookup
from slam_eslam_tpu_torch.online import OnlineSlam
from slam_eslam_tpu_torch.parallel.sharding import Mesh
from slam_eslam_tpu_torch.utils import graphs, tree
from torch_jax_draws import as_dict, project_draws, resample_draws, t
from torch_stand_in import StandIn, assert_bitwise

torch.set_num_threads(2)

N, T, CAP = 256, 12, 8
GRID = dict(nx=64, ny=64, resolution=0.1, origin=(-3.2, -3.2))
SLAM_N, STEPS, SUBSTEPS, RAYS = 16, 6, 5, 16
SCAN_META = (np.float32(-np.pi / 2), np.float32(np.pi / RAYS))
LASER = (np.array([[0.995, 0.0, 0.0998], [0.0, 1.0, 0.0],
                   [-0.0998, 0.0, 0.995]], np.float32),
         np.array([0.05, 0.2, 0.3], np.float32))


def terrain(x, y):
    return 0.25 * np.sin(1.3 * np.asarray(x)) + 0.2 * np.cos(
        0.9 * np.asarray(y))


def slam_terrain(x, y):
    return 0.15 * np.sin(0.7 * np.asarray(x)) + 0.12 * np.cos(
        0.5 * np.asarray(y))


def step_draws(key, n, steps):
    out = []
    for _ in range(steps):
        key, proj = project_draws(key, n)
        key, u = resample_draws(key, n)
        out.append(tstep.StepDraws(proj, u))
    return out


@pytest.fixture(scope="module")
def loc():
    """The localisation world of ``tests/test_torch_step.py`` at N = 256
    over 12 steps, and the JAX runner's result on it."""
    cfg = dataclasses.replace(
        Config(), particle_count=N, min_effective=N // 2,
        contact_model=ContactModelConfig(contact_point_radius=0.0),
        lookup_mode="auto")
    jgrid = jsim.terrain_grid(terrain, **GRID)
    sim = AsguardSim(terrain=terrain)
    z0 = float(sim.position[2])
    frames = []
    for _ in range(T):
        sim.step(wheel_delta=0.3, yaw_rate=0.05)
        frames.append((sim.contact_state().compact(CAP), sim.orientation))
    jstate = dataclasses.replace(
        jpe.PoseEstimatorState.create(cfg, CAP),
        particles=jpe.init_gaussian(jax.random.PRNGKey(0), N, (0.0, 0.0),
                                    0.0, (0.1, 0.1), 0.05, z0, 0.1))
    css = [cs for cs, _ in frames]
    qs = np.stack([q for _, q in frames])
    ref_state, ref_cents = jstep.make_scan_runner(
        cfg, jmake_lookup(cfg, jgrid))(
        jstate, jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *css),
        jnp.asarray(qs))
    tcss = tree.stack([convert.body_contact_state_from(as_dict(c))
                       for c in css])
    return dict(
        cfg=cfg, jstate=jstate, ref_state=ref_state, ref_cents=ref_cents,
        tlookup=tmake_lookup(cfg, convert.mls_grid_from(as_dict(jgrid))),
        css=tcss, qs=t(qs), draws=step_draws(jstate.key, N, T))


def port_state(loc, seed=0):
    state = convert.pose_estimator_state_from(as_dict(loc["jstate"]))
    return dataclasses.replace(
        state, generator=torch.Generator().manual_seed(seed))


def test_scan_runner_equals_eager_and_jax(loc):
    """On the JAX draws: the graphed runner equals the eager one bit for
    bit and the JAX runner within the parity tolerances."""
    cfg, lookup = loc["cfg"], loc["tlookup"]
    stand_in = StandIn()
    graphed = tstep.make_scan_runner(cfg, lookup, graph=stand_in)
    eager = tstep.make_scan_runner(cfg, lookup)
    got_state, got_cents = graphed(port_state(loc), loc["css"], loc["qs"],
                                   loc["draws"])
    ref_state, ref_cents = eager(port_state(loc), loc["css"], loc["qs"],
                                 loc["draws"])
    assert torch.equal(got_cents, ref_cents)
    assert_bitwise(got_state, ref_state)
    # one capture, then a replay for every step but the eager first
    assert (stand_in.captures, stand_in.replays) == (1, T - 1)
    assert graphed.graphs.counts() == dict(eager=1, captured=1,
                                           replayed=T - 1)
    np.testing.assert_allclose(got_cents.numpy(),
                               np.asarray(loc["ref_cents"]), rtol=0,
                               atol=1e-4)
    got = convert.to_numpy(got_state.particles)
    for name, val in as_dict(loc["ref_state"].particles).items():
        if val.dtype.kind in "biu":
            np.testing.assert_array_equal(got[name], val, err_msg=name)
        else:
            np.testing.assert_allclose(got[name], val, rtol=1e-4, atol=1e-5,
                                       err_msg=name)
    assert int(got_state.step) == int(loc["ref_state"].step)


def test_scan_runner_draws_from_the_generator(loc):
    """Without draws both runners draw from the state's generator: the
    same numbers, and the generator left at the same offset."""
    cfg, lookup = loc["cfg"], loc["tlookup"]
    graphed = tstep.make_scan_runner(cfg, lookup, graph=StandIn())
    eager = tstep.make_scan_runner(cfg, lookup)
    s_graph, s_eager = port_state(loc, 5), port_state(loc, 5)
    got_state, got_cents = graphed(s_graph, loc["css"], loc["qs"])
    ref_state, ref_cents = eager(s_eager, loc["css"], loc["qs"])
    assert torch.equal(got_cents, ref_cents)
    assert_bitwise(got_state, ref_state)
    assert got_state.generator is s_graph.generator
    assert torch.equal(s_graph.generator.get_state(),
                       s_eager.generator.get_state())
    # the generator moved: the run drew
    assert not torch.equal(s_graph.generator.get_state(),
                           torch.Generator().manual_seed(5).get_state())


def test_outputs_outlive_later_runs(loc):
    """A run's centroids and final state are its own tensors: a second run
    of the same runner from another start replays the same graph and
    leaves the first run's outputs as they were."""
    cfg, lookup = loc["cfg"], loc["tlookup"]
    graphed = tstep.make_scan_runner(cfg, lookup, graph=StandIn())
    first_state, first_cents = graphed(port_state(loc, 1), loc["css"],
                                       loc["qs"])
    kept = (first_cents.clone(), graphs.clone(first_state))
    second_state, second_cents = graphed(port_state(loc, 2), loc["css"],
                                         loc["qs"])
    assert graphed.graphs.counts() == dict(eager=1, captured=1,
                                           replayed=2 * T - 1)
    assert not torch.equal(second_cents, first_cents)
    assert torch.equal(first_cents, kept[0])
    assert_bitwise(first_state, kept[1])
    ref_state, ref_cents = tstep.make_scan_runner(cfg, lookup)(
        port_state(loc, 2), loc["css"], loc["qs"])
    assert torch.equal(second_cents, ref_cents)
    assert_bitwise(second_state, ref_state)


@pytest.mark.parametrize("with_draws", [False, True],
                         ids=["generator", "draws"])
def test_filter_step_equals_eager(loc, with_draws):
    """``make_filter_step(graph=...)`` call by call, the measurement gate
    open on every other call (``gate_ref`` as host numbers and as a
    tensor): the eager step's states and ``aux`` bit for bit."""
    cfg, lookup = loc["cfg"], loc["tlookup"]
    graphed = tstep.make_filter_step(cfg, lookup, graph=StandIn())
    eager = tstep.make_filter_step(cfg, lookup)
    a, b = port_state(loc, 3), port_state(loc, 3)
    updated = []
    for i in range(6):
        cs, q = tree.index(loc["css"], i), loc["qs"][i]
        gate = (0.5 * (i % 2), 0.0) if i < 3 else (
            torch.tensor(0.5 * (i % 2)), torch.tensor(0.0))
        d = loc["draws"][i] if with_draws else None
        a, aux_a = eager(a, cs, q, gate, d)
        b, aux_b = graphed(b, cs, q, gate, d)
        assert_bitwise(b, a)
        assert torch.equal(aux_b["ess"], aux_a["ess"])
        assert torch.equal(aux_b["updated"], aux_a["updated"])
        updated.append(bool(aux_b["updated"]))
    assert updated == [False, True] * 3
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_replays_credit_their_launches():
    """A wrapper's launch count moves by the launches of every step: the
    eager first step counts its own, the capture none, and every replay
    what the capture recorded."""
    from slam_eslam_tpu_torch.ops import block_merge as bm

    def step(carry, x):
        bm.block_merge.launches += 1     # a kernel launch of the step
        return carry * x, carry.sum()[None]

    stand_in = StandIn()
    runner = graphs.ScanRunner(step, stand_in, "toy")
    before = ops.launch_counts()
    xs = [torch.full((4,), 1.0 + i) for i in range(5)]
    carry, (ys,) = runner.run(torch.ones(4), xs)
    after = ops.launch_counts()
    assert after["block_merge"] - before["block_merge"] == 5
    assert {k: after[k] - before[k] for k in after
            if k != "block_merge"} == dict.fromkeys(
        [k for k in after if k != "block_merge"], 0)
    assert (stand_in.captures, stand_in.replays) == (1, 4)
    assert torch.equal(carry, torch.full((4,), 120.0))
    assert torch.equal(ys[:, 0], torch.tensor([4.0, 4.0, 8.0, 24.0, 96.0]))


def test_a_failed_capture_raises():
    """Nothing falls back to eager: the capture's error reaches the
    caller."""
    runner = graphs.ScanRunner(lambda c, x: (c + x, c), StandIn(fail=True),
                               "toy")
    with pytest.raises(RuntimeError, match="capture failed"):
        runner.run(torch.zeros(3), [torch.ones(3)] * 3)


def test_graph_refuses_the_cpu_and_unported_variants(loc, slam):
    cfg, lookup = loc["cfg"], loc["tlookup"]
    with pytest.raises(ValueError, match="needs a CUDA device"):
        tstep.make_scan_runner(cfg, lookup, graph=True)(
            port_state(loc), loc["css"], loc["qs"])
    with pytest.raises(ValueError, match="needs a CUDA device"):
        tstep.make_filter_step(cfg, lookup, graph=True)(
            port_state(loc), tree.index(loc["css"], 0), loc["qs"][0],
            (1.0, 0.0))
    # every variant captures now; a mesh only where its collectives are
    # NCCL's: gloo and the host transport raise by name
    mesh = Mesh(group=None, size=1, rank=0, device=torch.device("cpu"),
                backend="gloo", transport="gloo")
    for make in (tstep.make_scan_runner, tstep.make_filter_step):
        with pytest.raises(ValueError, match="transport is 'gloo'"):
            make(cfg, lookup, mesh=mesh, graph=True)
    scfg = slam_config()
    for make in (tst.make_slam_step, tst.make_slam_scan_runner):
        with pytest.raises(ValueError, match="transport is 'gloo'"):
            make(scfg, graph=True, mesh=mesh)
        make(scfg, graph=True, hash_=None, camera2body=LASER,
             camera_intrinsics=(1, 1, 0, 0))
    with pytest.raises(ValueError, match="transport is 'gloo'"):
        OnlineSlam(config=scfg, mesh=mesh, graph=True, device="cpu")
    host = dataclasses.replace(mesh, transport="host")
    with pytest.raises(ValueError, match="transport is 'host'"):
        tstep.make_filter_step(cfg, lookup, mesh=host, graph=True)
    run = tst.make_slam_scan_runner(scfg, laser2body=LASER,
                                    external_odometry=True, graph=True)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        run(slam["carry"](), slam["frames"], slam["odos"])
    with pytest.raises(ValueError, match="needs a CUDA device"):
        EmbodiedSlamFilter(config=scfg, device="cpu", graph=True)


# --------------------------------------------------------------- SLAM

def slam_config():
    return dataclasses.replace(
        Config(), particle_count=SLAM_N, min_effective=0.9 * SLAM_N,
        grid_size=4.0, grid_resolution=0.25, map_pool_blocks=64,
        map_chain_length=3, map_pool_color=False,
        contact_model=ContactModelConfig(contact_point_radius=0.0,
                                         min_contacts=2))


@pytest.fixture(scope="module")
def slam():
    """30 frames of the Asguard over a sine terrain (contacts compacted
    to 8, a 16-ray scan every fifth frame), the JAX package's start carry
    and runner result, and the port's inputs."""
    cfg = slam_config()
    sim = AsguardSim(terrain=slam_terrain)
    z0 = float(sim.position[2])
    rng = np.random.default_rng(0)
    traj = []

    def cb(s):
        cs = s.contact_state()
        ranges = rng.uniform(0.8, 2.6, RAYS).astype(np.float32)
        ranges[rng.random(RAYS) < 0.1] = 4.0
        traj.append([cs, cs.compact(CAP), s.orientation,
                     np.asarray(s.position, np.float32), ranges, False])

    for _ in range(STEPS):
        sim.step(wheel_delta=1.0, yaw_rate=0.1, substeps=SUBSTEPS,
                 on_substep=cb)
        traj[-1][5] = True
    jframes = jst.stack_frames([
        (cmp, jnp.asarray(q), jnp.asarray(pos), jnp.asarray(r), SCAN_META,
         jnp.asarray(hs)) for _, cmp, q, pos, r, hs in traj])
    full = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                  *[fr[0] for fr in traj])
    qs = jnp.stack([jnp.asarray(fr[2]) for fr in traj])
    f = JFilter(config=cfg)
    f.init(pose=(np.array([0.0, 0.0, z0]), 0.0), use_shared_map=False,
           num_contact_points=20)
    carry0 = jst.StreamingState.create(f.state, f.pool)
    jcarry, jaux = jst.make_slam_scan_runner(
        cfg, laser2body=LASER, external_odometry=True)(
        carry0, jframes, jst.precompute_odometry(20, full, qs, cfg=cfg))
    tframes = tst.stack_frames([
        (convert.body_contact_state_from(as_dict(cmp)), q, pos, r,
         SCAN_META, hs) for _, cmp, q, pos, r, hs in traj])
    odos = tst.precompute_odometry(
        20, tree.stack([convert.body_contact_state_from(as_dict(fr[0]))
                        for fr in traj]), t(np.asarray(qs)), cfg=cfg)
    # the JAX draws: project's on every frame, the resampling uniforms on
    # the frames whose measurement gate fired
    key, draws = carry0.filter.key, []
    for up in np.asarray(jaux["updated"]):
        key, proj = project_draws(key, SLAM_N)
        u = None
        if up:
            key, u = resample_draws(key, SLAM_N)
        draws.append(tstep.StepDraws(proj, u))
    host0 = as_dict(carry0)

    def carry(seed=0):
        c = convert.streaming_state_from(host0)
        return dataclasses.replace(c, filter=dataclasses.replace(
            c.filter, generator=torch.Generator().manual_seed(seed)))

    return dict(cfg=cfg, jcarry=jcarry, jaux=jaux, frames=tframes,
                odos=odos, draws=draws, carry=carry)


def slam_runner(cfg, graph=False):
    return tst.make_slam_scan_runner(cfg, laser2body=LASER,
                                     external_odometry=True, graph=graph)


def assert_slam_bitwise(got, ref):
    (gc, ga), (rc, ra) = got, ref
    for name in ("updated", "mapped"):
        np.testing.assert_array_equal(ga[name], ra[name], err_msg=name)
    assert torch.equal(ga["centroid"], ra["centroid"])
    assert torch.equal(ga["best_pose"], ra["best_pose"])
    assert_bitwise((gc.filter, gc.pool, gc.alloc_failed),
                   (rc.filter, rc.pool, rc.alloc_failed))
    for name in ("update_idx", "steps"):
        assert getattr(gc, name) == getattr(rc, name), name
    for name in ("ud_pos", "ud_q", "map_pos", "map_q"):
        np.testing.assert_array_equal(getattr(gc, name), getattr(rc, name))


@pytest.mark.parametrize("with_draws", [True, False],
                         ids=["jax draws", "generator"])
def test_slam_runner_equals_eager(slam, with_draws):
    """The graphed SLAM runner equals the eager loop bit for bit: gates,
    centroids, best poses, the filter, every pool field (``meta`` with
    its update indices), the chains and ``alloc_failed``; a second run
    from a fresh carry replays every gate combination and equals it
    again."""
    w = slam
    draws = w["draws"] if with_draws else None
    ref = slam_runner(w["cfg"])(w["carry"](7), w["frames"], w["odos"], draws)
    stand_in = StandIn()
    run = slam_runner(w["cfg"], stand_in)
    got = run(w["carry"](7), w["frames"], w["odos"], draws)
    assert_slam_bitwise(got, ref)
    aux = ref[1]
    assert aux["updated"].sum() >= 3 and aux["mapped"].sum() == STEPS
    combos = {(bool(u), bool(m))
              for u, m in zip(aux["updated"], aux["mapped"])}
    assert len(combos) >= 3
    counts = run.counts()
    assert counts["eager"] + counts["captured"] + counts["replayed"] == (
        len(w["frames"]) + counts["captured"])
    assert run.settled()
    # the chain writes of the last merge carry its index in meta
    assert int((got[0].pool.meta >> 2).max()) == got[0].update_idx - 1
    kept = (got[1]["centroid"].clone(), got[1]["best_pose"].clone())
    again = run(w["carry"](7), w["frames"], w["odos"], draws)
    assert run.counts()["eager"] == counts["eager"]
    assert run.counts()["captured"] == counts["captured"]
    assert_slam_bitwise(again, ref)
    assert torch.equal(got[1]["centroid"], kept[0])
    assert torch.equal(got[1]["best_pose"], kept[1])
    if not with_draws:
        assert torch.equal(got[0].filter.generator.get_state(),
                           ref[0].filter.generator.get_state())


def test_slam_runner_equals_jax(slam):
    """On the JAX draws the graphed SLAM runner meets the JAX
    ``make_slam_scan_runner`` within the tolerances of
    ``tests/test_torch_streaming.py``."""
    w = slam
    carry, aux = slam_runner(w["cfg"], StandIn())(
        w["carry"](), w["frames"], w["odos"], w["draws"])
    jaux = w["jaux"]
    for name in ("updated", "mapped"):
        np.testing.assert_array_equal(aux[name], np.asarray(jaux[name]),
                                      err_msg=name)
    np.testing.assert_allclose(aux["centroid"].numpy(),
                               np.asarray(jaux["centroid"]), atol=1e-4)
    got, ref = convert.to_numpy(carry), as_dict(w["jcarry"])
    for name, val in ref["filter"]["particles"].items():
        if val.dtype.kind in "biu":
            np.testing.assert_array_equal(got["filter"]["particles"][name],
                                          val, err_msg=name)
        else:
            np.testing.assert_allclose(got["filter"]["particles"][name], val,
                                       rtol=1e-4, atol=1e-5, err_msg=name)
    assert int(got["alloc_failed"]) == int(ref["alloc_failed"])
    assert got["update_idx"] == int(ref["update_idx"]) == STEPS
    for name in ("chain", "meta", "allocated"):
        np.testing.assert_array_equal(got["pool"][name], ref["pool"][name],
                                      err_msg=name)
    for name in ("mean", "stdev", "height", "origin"):
        np.testing.assert_allclose(got["pool"][name], ref["pool"][name],
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    assert (ref["pool"]["meta"] & 1).sum() > 5 * SLAM_N


def test_refilled_pool_reruns_as_a_fresh_carry(slam):
    """A fresh start written into the pool the runner's graphs were
    captured on (``EmbodiedSlamFilter.init(pool=)``, ``MapPool.refill_``)
    keeps that pool's tensors at their addresses, holds the bits of a
    newly built pool, and replays the run a freshly built carry gives."""
    w = slam
    cfg = w["cfg"]

    def carry(pool=None):
        f = EmbodiedSlamFilter(config=cfg, device="cpu").init(
            pose=(np.array([0.0, 0.0, 0.3]), 0.0), use_shared_map=False,
            num_contact_points=20, pool=pool)
        return tst.StreamingState.create(f.state, f.pool)

    ref = slam_runner(cfg)(carry(), w["frames"], w["odos"])
    run = slam_runner(cfg, StandIn())
    first = run(carry(), w["frames"], w["odos"])
    assert_slam_bitwise(first, ref)
    pool = first[0].pool                  # the runner's static pool
    where = graphs.addresses(pool)
    counts = run.counts()
    fresh = carry(pool)
    assert fresh.pool is pool and graphs.addresses(fresh.pool) == where
    assert_bitwise(fresh.pool, carry().pool)
    again = run(fresh, w["frames"], w["odos"])
    assert graphs.addresses(again[0].pool) == where
    assert_slam_bitwise(again, ref)
    # the rerun replayed every frame: no second eager meeting or capture
    assert run.counts()["eager"] == counts["eager"]
    assert run.counts()["captured"] == counts["captured"]
    with pytest.raises(ValueError, match="refills a pool of"):
        EmbodiedSlamFilter(
            config=dataclasses.replace(cfg, map_pool_blocks=65),
            device="cpu").init(pose=(np.zeros(3), 0.0),
                               use_shared_map=False, pool=pool)


def test_slam_step_call_by_call(slam):
    """``make_slam_step(graph=...)`` frame by frame equals the eager step,
    the caller's generator advanced alike."""
    w = slam
    cfg = w["cfg"]
    eager = tst.make_slam_step(cfg, laser2body=LASER, external_odometry=True)
    graphed = tst.make_slam_step(cfg, laser2body=LASER,
                                 external_odometry=True, graph=StandIn())
    a, b = w["carry"](4), w["carry"](4)
    for i in range(12):
        frame, odo = w["frames"].at(i), tree.index(w["odos"], i)
        a, aux_a = eager(a, frame, odo)
        b, aux_b = graphed(b, frame, odo)
        assert (aux_a["updated"], aux_a["mapped"]) == (aux_b["updated"],
                                                       aux_b["mapped"])
        assert torch.equal(aux_a["centroid"], aux_b["centroid"])
        assert torch.equal(aux_a["best_pose"], aux_b["best_pose"])
        assert_bitwise((b.filter, b.pool, b.alloc_failed),
                       (a.filter, a.pool, a.alloc_failed))
        assert (a.update_idx, a.steps) == (b.update_idx, b.steps)
    assert torch.equal(a.filter.generator.get_state(),
                       b.filter.generator.get_state())
