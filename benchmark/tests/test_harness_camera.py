"""The camera cell's drive at a size a test run holds: the generator's
images (rays that end on the terrain, the camera's mount and
intrinsics), a sound run correct, and the comparison failing where it
must: the control (the reference with its merge sums in bfloat16 in the
port's place) and the merge cut to each cloud's first 16,384 points."""

import copy
import json

import numpy as np
import pytest
import torch

from benchmark.harness import common, drive_camera, faults_camera, traffic
from benchmark.tests.conftest import ROOT


def correct(checks):
    return all(c["value"] <= c["limit"] for c in checks.values())


def tiny_camera(n=16):
    """The cell cut to 16 particles, 5 m grids and a 160 x 120 image
    (19,200 points, over the 16,384 a K3 merge takes) with the cell's
    field of view and mount, and a range of 1 m, so that the CPU holds it
    and a short window reaches measurement frames."""
    cfg = json.loads((ROOT / "benchmark/configs/slam_cam_1k_f32.json")
                     .read_text())
    cfg["particles"] = cfg["filter"]["particle_count"] = n
    cfg["min_effective"] = cfg["filter"]["min_effective"] = 3 * n // 4
    cfg["map_pool_blocks"] = cfg["filter"]["map_pool_blocks"] = 4 * n
    cfg["filter"]["grid_size"] = 5.0
    cfg["filter"]["max_sensor_range"] = 1.0
    cfg["camera"]["width"], cfg["camera"]["height"] = 160, 120
    mix = copy.deepcopy(traffic.load("online_camera"))
    mix["route"]["min_steps"] = 600
    mix["route"]["max_frames_per_s"] = 0
    mix["camera_window_m"] = 2.0
    return cfg, mix


def test_the_cells_camera_mount_and_pool():
    cfg = json.loads((ROOT / "benchmark/configs/slam_cam_1k_f32.json")
                     .read_text())
    cam = cfg["camera"]
    assert (cam["width"], cam["height"]) == (640, 480)
    sx, sy, cx, cy = drive_camera.intrinsics(cam)
    assert sx == sy == pytest.approx(np.tan(np.pi / 6) / 320)
    assert cx == pytest.approx(-sx * 319.5) and cy == pytest.approx(-sy * 239.5)
    rot, trans = drive_camera.mount(cam)
    assert np.allclose(rot.T @ rot, np.eye(3))
    # the optical axis ahead (+y) and 38 degrees down; image x along +x
    axis = rot @ np.array([0.0, 0.0, 1.0])
    assert np.allclose(axis, [0.0, np.cos(np.deg2rad(38)),
                              -np.sin(np.deg2rad(38))])
    assert np.allclose(rot @ np.array([1.0, 0.0, 0.0]), [1.0, 0.0, 0.0])
    assert np.allclose(trans, [0.0, 0.3, 0.25])
    assert cfg["filter"]["map_pool_color"] is True
    assert cfg["map_pool_blocks"] == 4000 and cfg["particles"] == 1000


def test_images_end_on_the_terrain():
    """Every ray of a generated image ends on the terrain: the hit's
    height is the terrain's there, at the depth along the optical axis
    the image holds; the texture is the terrain's colour in 8 bits."""
    cam = {"width": 64, "height": 48, "fov_x": np.pi / 3,
           "mount_xyz": [0.0, 0.3, 0.25], "mount_pitch": np.deg2rad(38.0)}
    rot, trans = drive_camera.mount(cam)
    origins = np.array([[0.0, 0.0, 0.16], [0.3, 2.0, 0.3]]) + trans
    depth, tex = drive_camera.images("sine_slam", origins, rot, cam,
                                     torch.device("cpu"), False)
    assert depth.shape == (2, 48, 64) and tex.dtype == torch.uint8
    sx, sy, cx, cy = drive_camera.intrinsics(cam)
    u, v = np.meshgrid(np.arange(64) * sx + cx, np.arange(48) * sy + cy)
    d = np.stack([u, v, np.ones_like(u)], -1) @ rot.T
    h = traffic.sims.terrain("sine_slam")
    for k in range(2):
        p = origins[k] + depth[k].double().numpy()[..., None] * d
        assert np.abs(p[..., 2] - h(p[..., 0], p[..., 1])).max() < 1e-5
        col = drive_camera.texture(torch.from_numpy(p[..., 0]),
                                   torch.from_numpy(p[..., 1]))
        assert (col * 255 - tex[k].double()).abs().max() <= 0.5 + 1e-3
    assert 0.2 < float(depth.min()) < float(depth.max()) < 3.0


@pytest.fixture(scope="module")
def camera():
    cfg_file, mix = tiny_camera()
    cell = drive_camera.Camera(cfg_file, mix, torch.device("cpu"))
    cell.setup(common.SetupClock(), 3.0)
    cell.inputs(2**31 + 300)
    cell.warm_up()
    return cell


def window(cell, seed):
    cell.inputs(seed)
    return cell.window(6.0, expected_rate=60.0)


@pytest.mark.parametrize("seed", [2**31 + 301, 2**31 + 302])
def test_camera_control_is_not_correct(camera, seed):
    w = window(camera, seed)
    checks = camera.check(w)
    assert correct(checks), checks
    assert checks["map_cells_differ"]["value"] < 0.01
    control = camera.check(w, control=torch.bfloat16)
    assert not correct(control)
    assert control["map_cells_differ"]["value"] > 0.5


def test_first_16384_points_are_not_correct():
    """The merge cut to each cloud's first 16,384 points (the rest of
    the image dropped) comes out not correct: its maps miss the image's
    nearest rows."""
    cfg_file, mix = tiny_camera()
    with faults_camera.first_points():
        cell = drive_camera.Camera(cfg_file, mix, torch.device("cpu"))
        cell.setup(common.SetupClock(), 3.0)
        cell.inputs(2**31 + 303)
        cell.warm_up()
        checks = cell.check(window(cell, 2**31 + 304))
    assert not correct(checks)
    assert checks["map_cells_differ"]["value"] > 0.05
