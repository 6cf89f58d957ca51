"""The port's application API, ``EmbodiedSlamFilter.update_contact``,
against the JAX package's over 40 steps of ``models.sim.TrajectorySim``
at 96 particles, with the JAX random draws injected: the shared map with
``log_debug`` (the unfolded lookup), the surface hash (global init and
reinjection), terrain labels with the slip update (the colour lookup),
and per-particle maps (the chain lookup).  The motion-gate decisions
must be equal and the centroids within 1e-4 m at every step.  Also:
``project`` without recovery spreading under a hash, the distribution
export and the gate's terrain-label rule.

The mapping API runs the same way, 40 steps at 48 particles with a laser
scan and a textured 6x8 distance image every fourth step: per-particle
maps on a colour-carrying pool with the scan match, negative information
and the slip update on terrain labels (``update_scan``,
``update_distance_image``, ``process_map``, the colour chain lookup), and
the shared map (the scan match over particles against the shared grid, the
camera merge into it under the centroid pose).  Gates equal, centroids
within 1e-4 m at every step, weights within rtol 1e-4; at the end the
pool's chains and meta words equal and its fields within rtol 1e-5 (the
shared grid: ``valid`` equal, fields within rtol 1e-5).  ``run_stream``
must leave the filter where the same frames, driven call by call, leave
it: gates and pool words equal, particles and pool fields within 1e-6.
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
from slam_eslam_tpu.mapping import projection as jproj
from slam_eslam_tpu.models import sim as jsim
from slam_eslam_tpu.utils import geometry as jgeom
from slam_eslam_tpu_torch import convert
from slam_eslam_tpu_torch.filter import eslam_filter as tef
from slam_eslam_tpu_torch.filter import pose_estimator as tpe
from slam_eslam_tpu_torch.filter import streaming as tst
from slam_eslam_tpu_torch.filter.step import StepDraws
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
    kw.setdefault("map_pool_color", False)
    kw.setdefault("particle_count", N)
    n = kw["particle_count"]
    kw.setdefault("map_pool_blocks", n + 16)
    return dataclasses.replace(
        Config(), min_effective=n // 2, grid_size=8.0, grid_resolution=0.25,
        map_chain_length=3, **kw)


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
    tf = tef.EmbodiedSlamFilter(config=cfg, device="cpu").init(
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
    tf = tef.EmbodiedSlamFilter(config=cfg, device="cpu").init(
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
    tf = tef.EmbodiedSlamFilter(config=cfg, device="cpu").init(
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


# ------------------------------------------------------------ mapping API

N_MAP = 48
LASER = (np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]]) @ np.array(
    [[np.cos(0.15), 0, np.sin(0.15)], [0, 1, 0],
     [-np.sin(0.15), 0, np.cos(0.15)]]), np.array([0.0, 0.1, 0.3]))
CAMERA = (np.array([[0.0, -0.1736, 0.9848], [-1.0, 0.0, 0.0],
                    [0.0, -0.9848, -0.1736]]), np.array([0.1, 0.0, 0.35]))
IMG_H, IMG_W = 6, 8
INTRINSICS = (2 * 0.5 / IMG_W, 2 * 0.4 / IMG_H, -0.5, -0.4)
RAYS = 24
SCAN_META = (np.float32(0.0), np.float32(np.pi / (RAYS - 1)))
SLIP = ContactModelConfig(contact_point_radius=0.0, use_slip_update=True,
                          min_contacts=2)


def sensor_frames(steps):
    """Seeded laser ranges and distance images with finite invalid
    pixels, and a texture of terrain-class colours (class 0 on the left
    half of the image, class 1 on the right)."""
    rng = np.random.default_rng(7)
    ranges = rng.uniform(1.2, 2.6, (steps, RAYS)).astype(np.float32)
    ranges[:, 3] = 9.0                      # beyond max_sensor_range
    dimg = rng.uniform(0.6, 2.6, (steps, IMG_H, IMG_W)).astype(np.float32)
    dimg[:, 0, 0], dimg[:, 3, 4] = 0.0, 8.0
    tex = np.zeros((IMG_H, IMG_W, 3), np.float32)
    tex[:, :IMG_W // 2, 0] = 1.0
    tex[:, IMG_W // 2:, 1] = 1.0
    return ranges, dimg, tex


def jax_sensors(ranges, dimg):
    scan = jproj.LaserScan(jnp.asarray(ranges), jnp.asarray(SCAN_META[0]),
                           jnp.asarray(SCAN_META[1]))
    img = jproj.DistanceImage(jnp.asarray(dimg), *(
        jnp.asarray(v, jnp.float32) for v in INTRINSICS))
    return scan, img


def port_sensors(ranges, dimg):
    return (convert.laser_scan_from(dict(
        ranges=ranges, start_angle=SCAN_META[0],
        angular_resolution=SCAN_META[1])),
        convert.distance_image_from(dict(
            data=dimg, scale_x=np.float32(INTRINSICS[0]),
            scale_y=np.float32(INTRINSICS[1]),
            center_x=np.float32(INTRINSICS[2]),
            center_y=np.float32(INTRINSICS[3]))))


def assert_particles_match(tf, jf, label, rtol=1e-4):
    for name, val in as_dict(jf.state.particles).items():
        got = getattr(tf.state.particles, name).numpy()
        if val.dtype.kind in "biu":
            np.testing.assert_array_equal(got, val, err_msg=f"{label} {name}")
        else:
            np.testing.assert_allclose(got, val, rtol=rtol, atol=1e-5,
                                       err_msg=f"{label} {name}")


def assert_pools_match(tpool, jpool, rtol=1e-5):
    got, ref = convert.to_numpy(tpool), as_dict(jpool)
    for name in ("chain", "meta", "allocated"):
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    for name in ("mean", "stdev", "height", "origin", "color"):
        if ref[name] is not None:
            np.testing.assert_allclose(got[name], ref[name], rtol=rtol,
                                       atol=1e-6, err_msg=name)
    return got, ref


MAPPING_MODES = {
    "per_particle": dict(shared=False, cfg=dict(
        map_pool_color=True, use_visual_update=True,
        grid_use_negative_information=True, contact_model=SLIP)),
    "shared": dict(shared=True, cfg=dict(use_visual_update=True)),
}


@pytest.mark.parametrize("mode", MAPPING_MODES)
def test_mapping_api_matches_jax(mode):
    mapping_api_against_jax(mode)


def mapping_api_against_jax(mode, graph=False):
    """The mapping API's drive of ``MAPPING_MODES[mode]`` on the port
    (``graph``: its ``EmbodiedSlamFilter(graph=...)``) and the JAX
    package, held together at every step and at the end."""
    opt = MAPPING_MODES[mode]
    shared = opt["shared"]
    cfg = config(particle_count=N_MAP, map_pool_blocks=4 * N_MAP,
                 **opt["cfg"])
    jgrid = jax_grid(colour=True)
    z0 = float(terrain(0.0, 0.0)) + 0.2
    pose = (np.array([0.0, 0.0, z0]), 0.0)
    jf = jef.EmbodiedSlamFilter(config=cfg).init(
        pose, shared_grid=jgrid if shared else None, use_shared_map=shared)
    _, k_init = jax.random.split(jax.random.PRNGKey(cfg.seed))
    normal_xy, normal_yaw = gaussian_normals(k_init, N_MAP)
    tf = tef.EmbodiedSlamFilter(config=cfg, device="cpu", graph=graph).init(
        pose, shared_grid=(convert.mls_grid_from(as_dict(jgrid)) if shared
                           else None),
        use_shared_map=shared, normal_xy=normal_xy, normal_yaw=normal_yaw)

    ranges, dimg, tex = sensor_frames(STEPS)
    sim = jsim.TrajectorySim(terrain, speed=0.05, yaw_rate=0.02)
    fired = {"scan": 0, "camera": 0}
    for step in range(STEPS):
        (pos, yaw), _ = sim.step()
        cs = sim.contact_state(noise=0.005)
        q = np.asarray(jgeom.quat_from_yaw(jnp.asarray(yaw, jnp.float32)))
        ltc = labels(step) if not shared and step >= 12 else None
        key, proj = project_draws(jf.state.key, N_MAP)
        key, u = resample_draws(key, N_MAP)
        ref = jf.update_contact((q, pos.copy()), cs, ltc)
        got = tf.update_contact(
            (q, pos.copy()), convert.body_contact_state_from(as_dict(cs)),
            ltc, draws=tef.ContactDraws(proj, u))
        assert got == ref, f"step {step}: measurement gates differ"
        if step % 4 == 1:
            jscan, jimg = jax_sensors(ranges[step], dimg[step])
            tscan, timg = port_sensors(ranges[step], dimg[step])
            ref = jf.update_scan((q, pos.copy()), jscan, LASER)
            got = tf.update_scan((q, pos.copy()), tscan, LASER)
            assert got == ref, f"step {step}: mapping gates differ"
            fired["scan"] += got
            ref = jf.update_distance_image((q, pos.copy()), jimg, CAMERA,
                                           texture=jnp.asarray(tex))
            got = tf.update_distance_image((q, pos.copy()), timg, CAMERA,
                                           texture=t(tex))
            assert got == ref, f"step {step}: camera gates differ"
            fired["camera"] += got
        c_ref, _ = jf.get_centroid()
        c_got, _ = tf.get_centroid()
        np.testing.assert_allclose(c_got.numpy(), np.asarray(c_ref), rtol=0,
                                   atol=CENTROID_ATOL, err_msg=f"step {step}")
        np.testing.assert_allclose(
            tf.state.particles.weight.numpy(),
            np.asarray(jf.state.particles.weight), rtol=1e-4, atol=1e-12,
            err_msg=f"step {step}")
    assert fired["scan"] == STEPS // 4 and 2 <= fired["camera"] < STEPS // 4
    assert tf.update_idx == jf.update_idx == (
        fired["camera"] + (0 if shared else fired["scan"]))
    assert_particles_match(tf, jf, mode)
    if shared:
        got, ref = convert.to_numpy(tf.shared_grid), as_dict(jf.shared_grid)
        for name in ("valid", "horizontal", "update_idx"):
            np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
        for name in ("mean", "stdev", "height", "color"):
            np.testing.assert_allclose(got[name][ref["valid"]],
                                       ref[name][ref["valid"]], rtol=1e-5,
                                       atol=1e-6, err_msg=name)
        # the camera merges changed the terrain's patches
        assert (ref["mean"] != np.asarray(jgrid.mean)).sum() > 10
        assert (ref["update_idx"][ref["valid"]] > 0).any()
    else:
        got, ref = assert_pools_match(tf.pool, jf.pool)
        assert (ref["meta"] & 1).sum() > 5 * N_MAP
        # texture colours ride on camera patches; the slip update read them
        assert (ref["color"] == 1.0).sum() > N_MAP
    return tf


def stream_frames(n_frames):
    """Per-frame tuples for ``stack_frames`` and the host poses: a drive
    along +y with a scan on every fifth frame and a textured image two
    frames later."""
    ranges, dimg, tex = sensor_frames(n_frames)
    sim = jsim.TrajectorySim(terrain, speed=0.06, yaw_rate=0.01)
    frames, poses = [], []
    for i in range(n_frames):
        (pos, yaw), _ = sim.step()
        cs = convert.body_contact_state_from(as_dict(
            sim.contact_state(noise=0.005)))
        q = np.asarray(jgeom.quat_from_yaw(jnp.asarray(yaw, jnp.float32)))
        poses.append((q, pos.copy()))
        frames.append((cs, q, pos.astype(np.float32), ranges[i], SCAN_META,
                       i % 5 == 2, dimg[i], i % 5 == 4, tex))
    return frames, poses


def test_run_stream_equals_host_driven():
    """``run_stream`` in two chunks against the same frames through
    ``update_contact``, ``update_scan`` and ``update_distance_image``, on
    the same draws: the anchors, ``update_idx`` and the step count carried
    in and out."""
    n_frames = 24
    cfg = config(particle_count=N_MAP, map_pool_blocks=4 * N_MAP,
                 map_pool_color=True, use_visual_update=True,
                 grid_use_negative_information=True)
    frames, poses = stream_frames(n_frames)
    gen = torch.Generator().manual_seed(5)
    draws = [StepDraws(tpe.ProjectDraws.sample(N_MAP, gen, "cpu"),
                       torch.rand(N_MAP, generator=gen))
             for _ in range(n_frames)]
    start = tpe.init_gaussian(N_MAP, (0.0, 0.0), 0.0, (0.1, 0.1), 0.05, 0.3,
                              0.05, generator=gen)

    def make():
        f = tef.EmbodiedSlamFilter(config=cfg, device="cpu").init(
            (np.array([0.0, 0.0, 0.3]), 0.0), use_shared_map=False)
        f.state = dataclasses.replace(f.state, particles=dataclasses.replace(
            start, map_id=f.state.particles.map_id))
        return f

    host, gates = make(), {"updated": [], "mapped": [], "cam_mapped": []}
    for i, (cs, q, pos, rng_, _, has_scan, dimg, has_dimg, tex) in enumerate(
            frames):
        gates["updated"].append(host.update_contact(
            poses[i], cs, draws=tef.ContactDraws(draws[i].project,
                                                 draws[i].resample_u)))
        tscan, timg = port_sensors(rng_, dimg)
        gates["mapped"].append(
            has_scan and host.update_scan(poses[i], tscan, LASER))
        gates["cam_mapped"].append(
            has_dimg and host.update_distance_image(poses[i], timg, CAMERA,
                                                    texture=t(tex)))

    streamed = make()
    stacked = tst.stack_frames(frames)
    kw = dict(laser2body=LASER, camera2body=CAMERA,
              camera_intrinsics=INTRINSICS, camera_texture=True)
    cut = 13
    aux = [streamed.run_stream(stacked.at(slice(0, cut)),
                               draws=draws[:cut], **kw),
           streamed.run_stream(stacked.at(slice(cut, n_frames)),
                               draws=draws[cut:], **kw)]
    assert len(streamed._runners) == 1          # the runner is built once
    for name, want in gates.items():
        got = np.concatenate([a[name] for a in aux])
        np.testing.assert_array_equal(got, np.array(want, bool), err_msg=name)
        assert 0 < got.sum() < n_frames
    assert int(aux[1]["alloc_failed_total"]) == 0
    assert streamed.update_idx == host.update_idx == (
        sum(gates["mapped"]) + sum(gates["cam_mapped"]))
    assert streamed.steps == host.steps == n_frames
    # the sensors' anchors agree in position; in rotation the stream keeps
    # the body's where the host calls keep the mounted sensor's (each gate
    # only ever compares its own anchors), as in the JAX package
    np.testing.assert_allclose(streamed.ud_pose, host.ud_pose, atol=1e-6)
    for name in ("map_pose", "stereo_pose"):
        np.testing.assert_allclose(getattr(streamed, name)[:3, 3],
                                   getattr(host, name)[:3, 3], atol=1e-6,
                                   err_msg=name)
    for f in dataclasses.fields(host.state.particles):
        np.testing.assert_allclose(
            getattr(streamed.state.particles, f.name).numpy(),
            getattr(host.state.particles, f.name).numpy(), rtol=1e-6,
            atol=1e-6, err_msg=f.name)
    got, ref = convert.to_numpy(streamed.pool), convert.to_numpy(host.pool)
    for name in ("chain", "meta", "allocated"):
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    for name in ("mean", "stdev", "height", "color"):
        np.testing.assert_allclose(got[name], ref[name], rtol=1e-6, atol=1e-6,
                                   err_msg=name)
    assert (ref["meta"] & 1).sum() > 3 * N_MAP and (ref["color"] > 0).any()
    with pytest.raises(ValueError, match="per-particle-map mode"):
        tef.EmbodiedSlamFilter(config=config(), device="cpu").init(
            (np.zeros(3), 0.0),
            shared_grid=convert.mls_grid_from(as_dict(jax_grid()))
        ).run_stream(stacked)


def test_process_map_reports_pool_exhaustion(capsys):
    """A pool with too few blocks: ``process_map`` reads the count of
    particles left without a block and reports it on stderr, as the JAX
    package does; ``run_stream`` reports the stream's total."""
    cfg = config(particle_count=N_MAP, map_pool_blocks=N_MAP + 2)
    jf = jef.EmbodiedSlamFilter(config=cfg).init(
        (np.array([0.0, 0.0, 0.3]), 0.0), use_shared_map=False)
    tf = tef.EmbodiedSlamFilter(config=cfg, device="cpu").init(
        (np.array([0.0, 0.0, 0.3]), 0.0), use_shared_map=False)
    # every particle on the map of particle 0 with its own first block kept
    # as the chain's second entry: all but one need a new head, and only
    # the two spare blocks are unreferenced
    ids = np.arange(N_MAP, dtype=np.int32)
    chain = np.stack([np.zeros_like(ids), np.where(ids > 0, ids, -1),
                      np.full_like(ids, -1)], 1)
    jf.pool = dataclasses.replace(jf.pool, chain=jnp.asarray(chain))
    tf.pool = dataclasses.replace(tf.pool, chain=t(chain))
    ranges, dimg, _ = sensor_frames(1)
    jscan, _ = jax_sensors(ranges[0], dimg[0])
    tscan, _ = port_sensors(ranges[0], dimg[0])
    pose = (np.array([1.0, 0, 0, 0], np.float32), np.array([0.0, 0.0, 0.3]))
    capsys.readouterr()
    assert jf.update_scan(pose, jscan, LASER) is True
    ref = capsys.readouterr().err
    assert tf.update_scan(pose, tscan, LASER) is True
    got = capsys.readouterr().err
    count = lambda text: int(text.split("exhausted for ")[1].split()[0])
    assert count(got) == count(ref) == N_MAP - 1 - 2
    np.testing.assert_array_equal(tf.pool.chain.numpy(),
                                  np.asarray(jf.pool.chain))


def test_queued_entry_points_raise():
    """Nothing of the mapping API is queued any more: every entry point
    runs (``run_stream`` on a one-rank mesh too), ``update_featurecloud``
    stays the reference's stub, and what still raises is a slip update on
    a pool without colours."""
    cfg = config(particle_count=N_MAP, map_pool_blocks=2 * N_MAP)
    tf = tef.EmbodiedSlamFilter(config=cfg, device="cpu").init(
        (np.array([0.0, 0.0, 0.3]), 0.0), use_shared_map=False)
    ranges, dimg, _ = sensor_frames(1)
    tscan, timg = port_sensors(ranges[0], dimg[0])
    pose = (np.array([1.0, 0, 0, 0], np.float32), np.array([0.0, 0.0, 0.3]))
    assert tf.update_scan(pose, tscan, LASER) is True
    assert tf.update_scan(pose, tscan, LASER) is False      # the gate
    assert tf.update_distance_image(pose, timg, CAMERA) is True
    assert tf.update_distance_image(pose, timg, CAMERA) is False
    assert tf.update_idx == 2 and int(tf.pool.count_valid()) > 0
    assert tf.update_featurecloud(None) is False
    frames, _ = stream_frames(2)
    aux = tf.run_stream(tst.stack_frames(frames), laser2body=LASER,
                        camera2body=CAMERA, camera_intrinsics=INTRINSICS,
                        camera_texture=False)
    assert aux["centroid"].shape == (2, 3) and tf.steps == 2
    from slam_eslam_tpu_torch.parallel.sharding import Mesh

    mesh = Mesh(group=None, size=1, rank=0, device=torch.device("cpu"),
                backend="gloo", transport="gloo")
    aux = tf.run_stream(tst.stack_frames(frames), mesh=mesh, donate=True)
    assert aux["centroid"].shape == (2, 3) and tf.steps == 4
    slip = config(contact_model=ContactModelConfig(use_slip_update=True))
    tf = tef.EmbodiedSlamFilter(config=slip, device="cpu").init(
        (np.zeros(3), 0.0), use_shared_map=False)
    with pytest.raises(ValueError, match="colour-carrying pool"):
        tf.update_contact((np.array([1.0, 0, 0, 0]), np.zeros(3)),
                          convert.body_contact_state_from(as_dict(
                              jsim.conformal_contact_state(
                                  np.zeros(3), 0.0, terrain))))


def test_default_device_is_the_card():
    """No ``device``: the CUDA device, and an error where there is none;
    ``device="cpu"`` runs on the CPU."""
    cfg = config()
    for make in (lambda **kw: tef.EmbodiedSlamFilter(config=cfg, **kw).device,
                 lambda **kw: tpe.PoseEstimatorState.create(
                     cfg, 8, **kw).step.device):
        assert make(device="cpu") == torch.device("cpu")
        if torch.cuda.is_available():
            assert make().type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
