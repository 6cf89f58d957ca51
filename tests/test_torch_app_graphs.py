"""The application API captured as CUDA graphs, on the CPU.

``EmbodiedSlamFilter(graph=...)``, the camera and hash gates of
``streaming.make_slam_step(graph=...)``, ``run_stream`` and
``OnlineSlam`` with ``graph=``, driven through the stand-in of
``tests/torch_stand_in.py`` (48 particles on the 64 x 64 x 4 maps of
``tests/test_torch_eslam_filter.py``, whose trajectory, sensors and
mounts these tests share):

* every graphed call equals the eager call bit for bit on the same draws
  and generator state, checked after every call: the estimator's state,
  the pool, the shared grid, ``last_eval``, ``update_idx``, the anchors
  and the generator.  ``update_contact`` in both map modes with
  ``log_debug``, terrain labels and the hash reinjecting, and the slip
  update on a colour-carrying pool; ``update_scan`` with and without the
  match and negative information, ``update_distance_image`` with a
  texture and ``process_map``, in both map modes; a camera merge into a
  hole of the shared map, whose patches the next contacts find;
* ``make_slam_scan_runner`` with ``camera2body=`` and ``hash_=`` meets
  each of its 16 gate combinations twice, replays each and equals the
  eager runner; two ``OnlineSlam`` chunks likewise;
* the graphed application meets the JAX package's ``EmbodiedSlamFilter``
  on the JAX draws within the tolerances of
  ``tests/test_torch_eslam_filter.py`` (centroids 1e-4 m and weights
  rtol 1e-4 at every step; at the end the pool's chains and meta words
  equal and its fields within rtol 1e-5, the shared grid's ``valid``
  equal and fields within rtol 1e-5);
* ``StepGraphs(reads=...)`` raises when a tensor a graph reads is
  replaced, and the deferred count of particles the pool had no block
  for reports what the eager call reports.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_eslam_tpu.models import sim as jsim
from slam_eslam_tpu.utils import geometry as jgeom
from slam_eslam_tpu_torch import convert
from slam_eslam_tpu_torch.config import SurfaceHashConfig, UpdateThreshold
from slam_eslam_tpu_torch.filter import eslam_filter as tef
from slam_eslam_tpu_torch.filter import pose_estimator as tpe
from slam_eslam_tpu_torch.filter import streaming as tst
from slam_eslam_tpu_torch.filter.surface_hash import SurfaceHash
from slam_eslam_tpu_torch.mapping import projection
from slam_eslam_tpu_torch.mapping.lookup import make_lookup
from slam_eslam_tpu_torch.models import sim as tsim
from slam_eslam_tpu_torch.online import OnlineSlam
from slam_eslam_tpu_torch.utils import graphs
from test_torch_eslam_filter import (CAMERA, HASH, INTRINSICS, LASER,
                                     MAPPING_MODES, SLIP, config, jax_grid,
                                     labels, mapping_api_against_jax,
                                     port_sensors, sensor_frames,
                                     stream_frames, terrain)
from torch_jax_draws import as_dict, t
from torch_stand_in import StandIn, assert_bitwise

torch.set_num_threads(2)

N = 48
STEPS = 32


@pytest.fixture(scope="module")
def drive():
    """STEPS frames of the trajectory of ``tests/test_torch_eslam_filter.
    py``: host poses, the port's contact states, a laser scan and a
    distance image each, and the texture."""
    sim = jsim.TrajectorySim(terrain, speed=0.05, yaw_rate=0.02)
    ranges, dimg, tex = sensor_frames(STEPS)
    frames = []
    for step in range(STEPS):
        (pos, yaw), _ = sim.step()
        q = np.asarray(jgeom.quat_from_yaw(jnp.asarray(yaw, jnp.float32)))
        frames.append(dict(
            pose=(q, pos.copy()), cs=convert.body_contact_state_from(
                as_dict(sim.contact_state(noise=0.005))),
            sensors=port_sensors(ranges[step], dimg[step])))
    return frames, t(tex)


def contact_draws(n, steps, seed=2):
    """Per step: every draw given on two steps of three (the hash's
    in-bucket draws on every other of those), the filter's generator on
    the third."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for step in range(steps):
        d = tef.ContactDraws(
            tpe.ProjectDraws.sample(n, gen, "cpu"), torch.rand(n, generator=gen),
            torch.zeros(n, dtype=torch.long) if step % 2 else None)
        out.append(None if step % 3 == 2 else d)
    return out


def pair(cfg, shared=True, grid=None, hash_config=None, n=N):
    """An eager filter and one whose calls run as graphs (the stand-in),
    from one start: the same normals, the same generator seed."""
    gen = torch.Generator().manual_seed(11)
    normals = (torch.randn((n, 2), generator=gen),
               torch.randn((n,), generator=gen))
    z0 = float(terrain(0.0, 0.0)) + 0.2
    return [tef.EmbodiedSlamFilter(config=cfg, device="cpu", graph=g).init(
        (np.array([0.0, 0.0, z0]), 0.0), shared_grid=grid,
        use_shared_map=shared, hash_config=hash_config,
        normal_xy=normals[0], normal_yaw=normals[1])
        for g in (False, StandIn())]


def assert_same(a, b):
    """The eager filter ``a`` and the graphed ``b``, bit for bit."""
    assert_bitwise((a.state, a.pool, a.shared_grid, a.last_eval),
                   (b.state, b.pool, b.shared_grid, b.last_eval))
    assert (a.update_idx, a.steps) == (b.update_idx, b.steps)
    for name in ("ud_pose", "map_pose", "stereo_pose"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert torch.equal(a.state.generator.get_state(),
                       b.state.generator.get_state())


def both(filters, call):
    """``call`` on each filter; the results equal.  Returns one."""
    out = [call(f) for f in filters]
    assert out[0] == out[1]
    return out[0]


def kinds(f):
    """The kinds of call ("contact", "scan", ...) a graph was captured
    for."""
    return {key[0][0] for sg in f.graphs.values() for key in sg.graphs}


CONTACT_MODES = {
    # the shared map: log_debug (the unfolded lookup), the hash
    # reinjecting, terrain labels forcing updates
    "shared": dict(cfg=dict(log_debug=True), hash=HASH, labels=True),
    # per-particle maps cloned from the environment, the hash
    "per_particle": dict(shared=False, hash=HASH, labels=True),
    # the slip update on a colour-carrying pool, on terrain labels
    "slip_colour_pool": dict(shared=False, labels=True, cfg=dict(
        map_pool_color=True, contact_model=SLIP)),
}


@pytest.mark.parametrize("mode", CONTACT_MODES)
def test_update_contact_graphed_equals_eager(drive, mode):
    opt = CONTACT_MODES[mode]
    cfg = config(particle_count=N, **opt.get("cfg", {}))
    frames, _ = drive
    filters = pair(cfg, opt.get("shared", True),
                   convert.mls_grid_from(as_dict(jax_grid(colour=True))),
                   opt.get("hash"))
    eager, graphed = filters
    draws = contact_draws(N, STEPS)
    gates, kept = [], None
    for step, fr in enumerate(frames):
        ltc = labels(step) if opt.get("labels") and step % 5 == 4 else None
        gates.append(both(filters, lambda f: f.update_contact(
            fr["pose"], fr["cs"], ltc, draws=draws[step])))
        assert_same(eager, graphed)
        if step == STEPS // 2:
            kept = [(v, graphs.clone(v)) for v in (graphed.last_eval,
                                                   graphed.state)]
    # what a call handed out is no view of a static buffer
    for v, copy in kept:
        assert_bitwise(v, copy)
    assert 0 < sum(gates) < STEPS
    counts = graphed.graphs.counts()
    assert counts["captured"] >= 3 and counts["replayed"] > STEPS // 2
    if "hash" in opt:
        period = opt["hash"].period
        assert any(g and (i + 1) % period == 0 for i, g in enumerate(gates))
    if mode == "shared":
        assert graphed.last_eval.cp_ok.any()


MAP_MODES = {
    "per_particle_match_negative": dict(shared=False, labels=True, cfg=dict(
        map_pool_color=True, use_visual_update=True,
        grid_use_negative_information=True, contact_model=SLIP)),
    "per_particle_plain": dict(shared=False, cfg=dict(map_pool_color=True)),
    "shared_match": dict(shared=True, cfg=dict(use_visual_update=True)),
}


@pytest.mark.parametrize("mode", MAP_MODES)
def test_mapping_calls_graphed_equal_eager(drive, mode):
    """``update_scan``, ``update_distance_image`` (textured) and
    ``process_map`` beside ``update_contact`` on every step."""
    opt = MAP_MODES[mode]
    shared = opt["shared"]
    cfg = config(particle_count=N, map_pool_blocks=4 * N, **opt["cfg"])
    frames, tex = drive
    filters = pair(cfg, shared,
                   convert.mls_grid_from(as_dict(jax_grid(colour=True)))
                   if shared else None)
    eager, graphed = filters
    draws = contact_draws(N, STEPS, seed=3)
    negative = cfg.grid_use_negative_information
    rot, trans = (torch.tensor(np.asarray(v), dtype=torch.float32)
                  for v in LASER)
    fired = {"scan": 0, "camera": 0}
    for step, fr in enumerate(frames):
        ltc = labels(step) if opt.get("labels") and step >= 12 else None
        both(filters, lambda f: f.update_contact(fr["pose"], fr["cs"], ltc,
                                                 draws=draws[step]))
        scan, img = fr["sensors"]
        if step % 4 == 1:
            fired["scan"] += both(filters, lambda f: f.update_scan(
                fr["pose"], scan, LASER))
            fired["camera"] += both(filters, lambda f: f.update_distance_image(
                fr["pose"], img, CAMERA, texture=tex))
        if step % 4 == 3:
            cloud, free = tst.laser_cloud(cfg, scan, t(fr["pose"][0]), rot,
                                          trans, negative)
            both(filters, lambda f: f.process_map(
                cloud, match=cfg.use_visual_update, update=True, free=free))
        assert_same(eager, graphed)
    assert fired["scan"] == STEPS // 4 and fired["camera"] >= 2
    assert kinds(graphed) == {"contact", "scan", "image", "map"}
    assert graphed.update_idx == fired["camera"] + (
        0 if shared else fired["scan"] + STEPS // 4)
    if shared:
        assert (graphed.shared_grid.update_idx > 0).any()
    else:
        assert int(graphed.pool.count_valid()) > 0


def hole_grid(frames, half=2.5):
    """The colourless environment grid with no patch within ``half`` m
    of the first pose."""
    grid = convert.mls_grid_from(as_dict(jax_grid()))
    x0, y0 = frames[0]["pose"][1][:2]
    xy = grid.from_grid(*torch.meshgrid(torch.arange(grid.nx),
                                        torch.arange(grid.ny), indexing="ij"))
    hole = ((xy[..., 0] - x0).abs() < half) & ((xy[..., 1] - y0).abs() < half)
    return dataclasses.replace(grid, valid=grid.valid & ~hole[..., None])


def test_shared_camera_merge_then_contacts(drive):
    """A camera merge into a hole of the shared map, then more
    ``update_contact`` calls.  The graphed filter writes the merged grid
    and the lookup's packed tables (the contact fold's) into their
    storage, which the graphs of ``update_contact`` captured before the
    merge read: the contacts find the new patches, and every call equals
    the eager filter's bit for bit.  The caller's grid stays as it was.
    Replacing the lookup's tables instead makes the next replay raise."""
    frames, _ = drive
    cfg = config(particle_count=N)
    grid = hole_grid(frames)
    given = graphs.clone(grid)
    filters = pair(cfg, True, grid)
    eager, graphed = filters
    storage = graphs.addresses((graphed.shared_grid, graphed._lookup.packed))
    h, w = 12, 16
    intrinsics = [torch.tensor(v) for v in (0.12, 0.12, -0.12 * (w - 1) / 2,
                                            -0.12 * (h - 1) / 2)]
    down = (np.diag([1.0, -1.0, -1.0]), np.array([0.0, 0.0, 0.25]))
    found, merged_at = [], 8
    for step, fr in enumerate(frames[:16]):
        gate = both(filters, lambda f: f.update_contact(fr["pose"], fr["cs"]))
        if gate:
            found.append((step, int(graphed.last_eval.n_contacts.sum())))
        if step == merged_at:
            pos = fr["pose"][1]
            # a level surface at the ground's height under the robot
            img = projection.DistanceImage(torch.full(
                (h, w), 0.25 + 0.2, dtype=torch.float32), *intrinsics)
            assert both(filters, lambda f: f.update_distance_image(
                fr["pose"], img, down))
            assert float(terrain(pos[0], pos[1])) + 0.2 - pos[2] < 1e-6
        assert_same(eager, graphed)
    before = [n for s, n in found if s <= merged_at]
    after = [n for s, n in found if s > merged_at]
    assert before and after and max(before) == 0 and min(after) > 0
    # the merge went into the grid's storage, not into the caller's grid
    assert graphs.addresses((graphed.shared_grid,
                             graphed._lookup.packed)) == storage
    assert_bitwise(grid, given)
    assert "contact" in kinds(graphed)
    graphed._lookup = make_lookup(cfg, graphed.shared_grid)
    with pytest.raises(graphs.StaleRead, match="EmbodiedSlamFilter"):
        fr = frames[16]
        graphed.update_contact(fr["pose"], fr["cs"])


def test_stale_read_raises():
    """A graph that reads a tensor outside its carry and inputs: writing
    into it is seen by every replay; replacing it raises at the next."""
    table = {"t": torch.ones(3)}
    sg = graphs.StepGraphs(
        lambda c, x, key: (c + x * table["t"], c.sum()[None]),
        torch.zeros(3), StandIn(), reads=lambda key: table["t"],
        what="toy")
    for _ in range(3):    # eager, captured and replayed, replayed
        sg.step(None, torch.ones(3))
    table["t"].mul_(2.0)
    sg.step(None, torch.ones(3))
    assert torch.equal(sg.carry, torch.full((3,), 5.0))
    assert sg.counts == {"eager": 1, "captured": 1, "replayed": 3}
    table["t"] = torch.ones(3)
    with pytest.raises(graphs.StaleRead, match="toy: 1 of the 1 tensors"):
        sg.step(None, torch.ones(3))


# ---------------------------------------------------------- the streams

KEY_STEP = 0.12        # m a moving frame advances; every gate needs 0.1


def key_frames():
    """Frames that meet each of the 16 gate combinations (measurement,
    laser, camera, hash) twice: blocks of two plain moving frames and one
    frame of the combination, the hash reinjecting on every second
    frame.  A moving frame passes the measurement gate, and leaves the
    laser's and the camera's anchors behind, so the block's third frame
    passes the laser gate with a scan and the camera gate with an image,
    moving or not."""
    combos = [(u, m, c) for u in (0, 1) for m in (0, 1) for c in (0, 1)]
    ranges, dimg, tex = sensor_frames(3 * 32)
    q = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    x, frames, want = 0.0, [], []
    for k in range(32):
        u, m, c = combos[(k // 2) % 8]
        for move, scan, image in ((1, 0, 0), (1, 0, 0), (u, m, c)):
            x += KEY_STEP * move
            i = len(frames)
            pos = np.array([x, 0.0, terrain(x, 0.0) + 0.2])
            cs = tsim.conformal_contact_state(pos, 0.0, terrain)
            frames.append((cs, q, pos.astype(np.float32), ranges[i],
                           (np.float32(0.0), np.float32(np.pi / 23)),
                           bool(scan), dimg[i], bool(image), tex))
        want.append((bool(u), bool(m), bool(c), k % 2 == 1))
    return tst.stack_frames(frames), want


def test_slam_runner_camera_and_hash_keys():
    """``make_slam_scan_runner`` with ``camera2body=``, textured, and
    ``hash_=`` (period 2): the graphed runner meets every one of the 16
    gate combinations at least twice, replays each, and equals the eager
    runner bit for bit; a second run from the same start only replays and
    equals it again."""
    gate = UpdateThreshold(0.1, np.pi)
    cfg = dataclasses.replace(
        config(particle_count=16, map_pool_blocks=160, map_pool_color=True,
               use_visual_update=True, grid_use_negative_information=True),
        grid_size=4.0, measurement_threshold=gate, mapping_threshold=gate,
        mapping_camera_threshold=gate)
    frames, want = key_frames()
    hash_ = SurfaceHash.create(
        SurfaceHashConfig(use_hash=True, slope_bins=10, angular_steps=4,
                          period=2),
        convert.mls_grid_from(as_dict(jax_grid())))
    kw = dict(laser2body=LASER, hash_=hash_, camera2body=CAMERA,
              camera_intrinsics=INTRINSICS, camera_texture=True)
    f = tef.EmbodiedSlamFilter(config=cfg, device="cpu").init(
        (frames.host_body_pos[0].astype(np.float64), 0.0),
        use_shared_map=False)

    def start():
        c = tst.StreamingState.create(graphs.clone(f.state),
                                      graphs.clone(f.pool))
        return dataclasses.replace(c, filter=dataclasses.replace(
            c.filter, generator=torch.Generator().manual_seed(9)))

    ref = tst.make_slam_scan_runner(cfg, **kw)(start(), frames)
    run = tst.make_slam_scan_runner(cfg, graph=StandIn(), **kw)
    got = run(start(), frames)
    flags = ("updated", "mapped", "cam_mapped")
    met = list(zip(*(ref[1][name] for name in flags),
                   (np.arange(len(frames)) + 1) % 2 == 0))
    assert all(met[3 * k + 2] == w for k, w in enumerate(want))
    assert len(set(met)) == 16 and run.settled()
    for (gc, ga), (rc, ra) in ((got, ref), (run(start(), frames), ref)):
        for name in flags:
            np.testing.assert_array_equal(ga[name], ra[name], err_msg=name)
        assert_bitwise((ga["centroid"], ga["best_pose"], gc.filter, gc.pool,
                        gc.alloc_failed),
                       (ra["centroid"], ra["best_pose"], rc.filter, rc.pool,
                        rc.alloc_failed))
        assert (gc.update_idx, gc.steps) == (rc.update_idx, rc.steps)
        for name in ("ud_pos", "map_pos", "cam_pos", "cam_q"):
            np.testing.assert_array_equal(getattr(gc, name),
                                          getattr(rc, name))
        assert torch.equal(gc.filter.generator.get_state(),
                           rc.filter.generator.get_state())
    counts = run.counts()
    assert counts["captured"] >= 16
    assert counts["replayed"] == 2 * len(frames) - counts["eager"]
    assert ref[0].update_idx == sum(ref[1]["mapped"]) + sum(
        ref[1]["cam_mapped"])


def test_online_slam_chunks_graphed_equal_eager():
    """Two ``OnlineSlam`` chunks (laser, textured camera) through the
    filter's graphs, against the eager chunks: the same gates, centroids,
    state, pool, keyframes and anchors, bit for bit."""
    cfg = config(particle_count=N, map_pool_blocks=4 * N,
                 map_pool_color=True, use_visual_update=True,
                 grid_use_negative_information=True)
    frames = tst.stack_frames(stream_frames(24)[0])
    gen = torch.Generator().manual_seed(8)
    normals = (torch.randn((N, 2), generator=gen),
               torch.randn((N,), generator=gen))
    slams = [OnlineSlam(config=cfg, laser2body=LASER, camera2body=CAMERA,
                        camera_intrinsics=INTRINSICS, camera_texture=True,
                        keyframe_kw=dict(keyframe_distance=0.1),
                        device="cpu", graph=g).init(
        (np.array([0.0, 0.0, 0.3]), 0.0), normal_xy=normals[0],
        normal_yaw=normals[1]) for g in (False, StandIn())]
    for sl in (slice(0, 12), slice(12, 24)):
        auxes = [s.process_chunk(frames.at(sl)) for s in slams]
        for name in ("updated", "mapped", "cam_mapped"):
            np.testing.assert_array_equal(auxes[0][name], auxes[1][name])
        assert_bitwise((auxes[0]["centroid"], auxes[0]["best_pose"]),
                       (auxes[1]["centroid"], auxes[1]["best_pose"]))
        assert_same(slams[0].filter, slams[1].filter)
        assert (len(slams[0].keyframes.keyframes)
                == len(slams[1].keyframes.keyframes))
    assert slams[0].keyframe_frames == slams[1].keyframe_frames
    runner, = slams[1].filter._runners.values()
    assert runner.counts()["replayed"] > 12


@pytest.mark.parametrize("mode", MAPPING_MODES)
def test_graphed_application_matches_jax(mode):
    """The mapping API's drive of ``tests/test_torch_eslam_filter.py``
    (``update_contact`` with terrain labels and the slip update,
    ``update_scan`` with the match and negative information, the textured
    ``update_distance_image``; per-particle and shared maps) through the
    graphed filter, held against the JAX package at every step."""
    tf = mapping_api_against_jax(mode, graph=StandIn())
    assert tf.graphs.counts()["replayed"] > 20
    assert {"contact", "scan", "image"} <= kinds(tf)


def test_pool_exhaustion_report_deferred(capsys):
    """The count of particles the pool had no block for: the graphed
    ``update_scan`` reports what the eager one reports, and leaves the
    same chains (where particles share a head, the merge's plain version
    adds in no fixed order, so the pool's fields are not compared).  A
    count whose copy has not landed (an event not completed, as on the
    card) waits for a later call, and a mapping call waits for it."""
    cfg = config(particle_count=N, map_pool_blocks=N + 2)
    filters = pair(cfg, False)
    ids = np.arange(N, dtype=np.int32)
    chain = t(np.stack([np.zeros_like(ids), np.where(ids > 0, ids, -1),
                        np.full_like(ids, -1)], 1))
    for f in filters:
        f.pool = dataclasses.replace(f.pool, chain=chain.clone())
    ranges, dimg, _ = sensor_frames(1)
    scan, _ = port_sensors(ranges[0], dimg[0])
    pose = (np.array([1.0, 0, 0, 0], np.float32), np.array([0.0, 0.0, 0.3]))
    count = lambda text: int(text.split("exhausted for ")[1].split()[0])
    capsys.readouterr()
    reports = []
    for f in filters:
        assert f.update_scan(pose, scan, LASER) is True
        reports.append(count(capsys.readouterr().err))
    assert reports == [N - 1 - 2] * 2
    assert torch.equal(filters[0].pool.chain, filters[1].pool.chain)

    class Pending:
        """An event whose copy lands when it is waited for."""

        done = False

        def query(self):
            return self.done

        def synchronize(self):
            self.done = True

    f = filters[1]
    f._reports.pending.append((torch.tensor(7, dtype=torch.int32),
                               Pending()))
    f._reports.report()
    assert capsys.readouterr().err == ""
    f.update_scan(pose, scan, LASER)          # the gate: nothing merged
    assert count(capsys.readouterr().err) == 7
