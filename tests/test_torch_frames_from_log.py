"""``streaming.frames_from_log`` of the port against the JAX package's, on
the CPU.

``tests/test_streaming.py``'s two log cases run on the port: a traverse
recorded through the native log with scans on every fifth frame (the
round trip) and one with distance images on every fourth (the camera
path) each give, through ``make_slam_scan_runner``, what the same frames
stacked in memory give: the same gate flags, centroids within 1e-6 m,
weights and pool means within rtol 1e-6 (the JAX test's tolerances).
Beside them: the JAX and the port's ``frames_from_log`` on one log agree
bit for bit, field by field, ``ts`` and the intrinsics included; each of
its four ``ValueError``s is raised as the JAX function raises it; and
``SlamFrames.at`` with a slice takes the same slice of every field,
host copies included.
"""

import dataclasses

import numpy as np
import pytest
import torch

from slam_eslam_tpu.filter import streaming as jst
from slam_eslam_tpu_torch.config import Config, ContactModelConfig
from slam_eslam_tpu_torch.filter import streaming
from slam_eslam_tpu_torch.filter.eslam_filter import EmbodiedSlamFilter
from slam_eslam_tpu_torch.io import logio
from slam_eslam_tpu_torch.models.asguard import AsguardSim

torch.set_num_threads(2)

N_RAYS = 32
SCAN_META = (np.float32(-np.pi / 2), np.float32(np.pi / N_RAYS))
Q = np.array([1.0, 0, 0, 0], np.float32)
INTR = (0.1, 0.1, -0.3, -0.2)
H, W = 4, 6


def terrain(x, y):
    return 0.15 * np.sin(0.7 * np.asarray(x)) + 0.12 * np.cos(
        0.5 * np.asarray(y))


def config(n):
    return dataclasses.replace(
        Config(), particle_count=n, min_effective=n // 2, grid_size=10.0,
        grid_resolution=0.25, map_pool_blocks=n + 16, map_chain_length=3,
        contact_model=ContactModelConfig(contact_point_radius=0.0,
                                         min_contacts=2))


def carry(cfg):
    """A fresh per-particle filter's streaming carry (the runner updates
    the pool in place, so every run gets its own; the seeded generator
    gives each the same draws)."""
    f = EmbodiedSlamFilter(config=cfg, device="cpu")
    f.init(pose=(np.array([0.0, 0.0, AsguardSim(terrain=terrain)
                           .position[2]]), 0.0), use_shared_map=False)
    return streaming.StreamingState.create(f.state, f.pool)


def record(path, steps, scan_every=None, image_every=None, texture=False):
    """Drive the simulator and write every frame to the log; returns the
    same frames as per-frame tuples for ``streaming.stack_frames``."""
    sim = AsguardSim(terrain=terrain)
    frames = []
    with logio.LogWriter(path) as w:

        def sub(s):
            i = len(frames)
            ts = 1000 + i * 10
            cs = s.contact_state()
            w.write_contact_state(cs, timestamp_ns=ts)
            w.write_orientation(Q, timestamp_ns=ts)
            w.write_pose(s.position, Q, timestamp_ns=ts)
            has_scan = bool(scan_every) and (i + 1) % scan_every == 0
            if has_scan:
                w.write_scan(np.full(N_RAYS, 2.0), float(SCAN_META[0]),
                             float(SCAN_META[1]), timestamp_ns=ts)
            frame = [cs, Q, np.asarray(s.position, np.float32),
                     np.full((N_RAYS,), 2.0, np.float32) if scan_every
                     else np.zeros((1,), np.float32),
                     SCAN_META if scan_every else (0.0, 1.0), has_scan]
            if image_every:
                has_img = (i + 1) % image_every == 0
                d = (2.0 + 0.05 * (i + 1)) * np.ones((H, W), np.float32)
                tex = np.full((H, W, 3), 0.02 * i, np.float32)
                if has_img:
                    w.write_distance_image(d, *INTR, timestamp_ns=ts)
                    if texture:
                        w.write_texture_image(tex, timestamp_ns=ts)
                frame += [d, has_img] + ([tex] if texture else [])
            frames.append(tuple(frame))

        for _ in range(steps):
            sim.step(wheel_delta=0.3, on_substep=sub)
    return frames


def test_frames_from_log_roundtrip(tmp_path):
    """``tests/test_streaming.py::test_frames_from_log_roundtrip`` on the
    port: the log through the runner equals the in-memory stream."""
    cfg = config(16)
    path = str(tmp_path / "traverse.eslg")
    frames = record(path, 3, scan_every=5)
    log_frames, ts = streaming.frames_from_log(path, device="cpu")
    assert ts.shape == (len(frames),)
    run = streaming.make_slam_scan_runner(cfg)
    c_mem, a_mem = run(carry(cfg), streaming.stack_frames(frames))
    c_log, a_log = run(carry(cfg), log_frames)
    np.testing.assert_array_equal(a_mem["mapped"], a_log["mapped"])
    assert a_log["mapped"].sum() > 0
    np.testing.assert_allclose(c_mem.filter.particles.weight.numpy(),
                               c_log.filter.particles.weight.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(a_mem["centroid"].numpy(),
                               a_log["centroid"].numpy(), atol=1e-6)


def test_camera_frames_from_log(tmp_path):
    """``tests/test_streaming.py::test_camera_frames_from_log`` on the
    port: DISTANCE_IMAGE records flow through ``load_stream`` into the
    runner's camera path."""
    cfg = config(16)
    path = str(tmp_path / "cam.eslg")
    frames = record(path, 2, image_every=4)
    log_frames, ts, meta = streaming.frames_from_log(path, camera=True,
                                                     device="cpu")
    np.testing.assert_allclose(meta, INTR, rtol=1e-6)
    run = streaming.make_slam_scan_runner(
        cfg, camera2body=(np.eye(3), np.zeros(3)), camera_intrinsics=INTR)
    c_mem, a_mem = run(carry(cfg), streaming.stack_frames(frames))
    c_log, a_log = run(carry(cfg), log_frames)
    np.testing.assert_array_equal(a_mem["cam_mapped"], a_log["cam_mapped"])
    assert a_log["cam_mapped"].sum() > 0
    np.testing.assert_allclose(c_mem.pool.mean.numpy(),
                               c_log.pool.mean.numpy(), rtol=1e-6)


def frame_fields(frames, jframes):
    """Pairs ``(name, port array, JAX array)`` of every frame field (the
    JAX frame tuple's order)."""
    cs, q, pos, ranges, (start, res), has_scan = jframes[:6]
    out = [(f"contact.{f}", getattr(frames.contact, f), getattr(cs, f))
           for f in ("position", "contact", "slip", "group_id", "valid")]
    out += [("q", frames.q, q), ("body_pos", frames.body_pos, pos),
            ("ranges", frames.ranges, ranges),
            ("start_angle", frames.start_angle, start),
            ("angular_resolution", frames.angular_resolution, res),
            ("has_scan", frames.has_scan, has_scan)]
    names = ("dimg", "has_dimg", "timg")
    out += [(n, getattr(frames, n), a) for n, a in zip(names, jframes[6:])]
    return [(n, a.numpy(), np.asarray(b)) for n, a, b in out]


@pytest.mark.parametrize("kind", ["laser", "camera", "texture"])
def test_jax_and_port_agree_bit_for_bit(kind, tmp_path):
    path = str(tmp_path / "log.eslg")
    record(path, 3, scan_every=None if kind != "laser" else 5,
           image_every=None if kind == "laser" else 3,
           texture=kind == "texture")
    kw = {} if kind == "laser" else dict(camera=True,
                                         texture=kind == "texture")
    mine = streaming.frames_from_log(path, device="cpu", **kw)
    ref = jst.frames_from_log(path, **kw)
    assert len(mine) == len(ref) == (2 if kind == "laser" else 3)
    fields = frame_fields(mine[0], ref[0])
    assert len(fields) == {"laser": 11, "camera": 13, "texture": 14}[kind]
    for name, a, b in fields:
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(mine[1], np.asarray(ref[1]))
    assert mine[1].dtype == np.asarray(ref[1]).dtype
    if kind != "laser":
        assert mine[2] == ref[2]
    # the gates' host copies are the tensors' values
    f = mine[0]
    np.testing.assert_array_equal(f.host_q, f.q.numpy())
    np.testing.assert_array_equal(f.host_body_pos, f.body_pos.numpy())
    np.testing.assert_array_equal(f.host_has_scan, f.has_scan.numpy())
    if kind != "laser":
        np.testing.assert_array_equal(f.host_has_dimg, f.has_dimg.numpy())


def write_partial(path, pose=True, orientation=True, image=False):
    with logio.LogWriter(path) as w:
        for i in range(3):
            cs = AsguardSim(terrain=terrain).contact_state()
            w.write_contact_state(cs, timestamp_ns=i)
            if orientation:
                w.write_orientation(Q, timestamp_ns=i)
            if pose:
                w.write_pose([0.1 * i, 0, 0], Q, timestamp_ns=i)
            if image:
                w.write_distance_image(np.ones((H, W)), *INTR,
                                       timestamp_ns=i)


ERRORS = {
    "no pose": (dict(pose=False), {}, "pose records"),
    "no orientation": (dict(orientation=False), {}, "orientation records"),
    "camera without images": ({}, dict(camera=True), "DISTANCE_IMAGE"),
    "texture without textures": (dict(image=True),
                                 dict(camera=True, texture=True),
                                 "TEXTURE_IMAGE"),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_the_value_errors_of_the_jax_function(case, tmp_path):
    write_kw, call_kw, words = ERRORS[case]
    path = str(tmp_path / "partial.eslg")
    write_partial(path, **write_kw)
    with pytest.raises(ValueError) as ref:
        jst.frames_from_log(path, **call_kw)
    with pytest.raises(ValueError, match=words) as mine:
        streaming.frames_from_log(path, device="cpu", **call_kw)
    assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("sl", [slice(0, 7), slice(5, 19), slice(20, None),
                                slice(2, 17, 3)])
def test_at_slices_every_field_and_host_copy(sl, tmp_path):
    path = str(tmp_path / "log.eslg")
    record(path, 3, scan_every=4, image_every=5, texture=True)
    frames, _, _ = streaming.frames_from_log(path, camera=True, texture=True,
                                             device="cpu")
    part = frames.at(sl)
    n = len(range(*sl.indices(len(frames))))
    assert len(part) == n
    for f in dataclasses.fields(frames):
        a, b = getattr(part, f.name), getattr(frames, f.name)
        if f.name == "contact":
            for g in ("position", "contact", "slip", "group_id", "valid"):
                assert torch.equal(getattr(a, g), getattr(b, g)[sl])
        elif isinstance(b, torch.Tensor):
            assert torch.equal(a, b[sl]), f.name
        else:
            np.testing.assert_array_equal(a, b[sl], err_msg=f.name)
            assert len(a) == n
