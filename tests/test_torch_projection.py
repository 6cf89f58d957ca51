"""The port's sensor projection against the JAX package: ``scan_to_points``,
``project_points`` (with and without colour) and ``free_space_points``
on seeded scans, tilted orientations and sensor mounts, and the camera
path: ``distance_image_to_points`` with ``texture_colors`` on seeded
distance images with invalid pixels, and the textured cloud they project
to.  The JAX functions run under ``jax.jit``.  Tolerance: rtol 1e-6, atol
1e-6 (m); validity masks and colours exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_eslam_tpu.mapping import projection as jproj
from slam_eslam_tpu_torch import convert
from slam_eslam_tpu_torch.mapping import projection as tproj

RTOL = ATOL = 1e-6
R = 16


def t(a):
    return torch.from_numpy(np.array(a))


def quat(roll, pitch, yaw):
    """[w, x, y, z] of R_z(yaw) R_y(pitch) R_x(roll), float32."""
    cr, sr = np.cos(roll / 2), np.sin(roll / 2)
    cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
    cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
    return np.array([cr * cp * cy + sr * sp * sy, sr * cp * cy - cr * sp * sy,
                     cr * sp * cy + sr * cp * sy, cr * cp * sy - sr * sp * cy],
                    np.float32)


def scan_case(seed):
    rng = np.random.default_rng(seed)
    ranges = rng.uniform(0.05, 4.0, R).astype(np.float32)
    ranges[3] = np.nan
    ranges[7] = 0.0
    start, res = np.float32(-np.pi / 2), np.float32(np.pi / R)
    q = quat(*rng.uniform(-0.2, 0.2, 2), rng.uniform(-3, 3))
    a = rng.uniform(-0.3, 0.3)
    rot = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                    [-np.sin(a), 0, np.cos(a)]], np.float32)
    trans = rng.uniform(-0.3, 0.3, 3).astype(np.float32)
    color = rng.uniform(0, 1, (R, 3)).astype(np.float32)
    return ranges, start, res, q, rot, trans, color


def close(got, ref, err_msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL, err_msg=err_msg)


@pytest.mark.parametrize("seed", [0, 1])
def test_scan_to_points(seed):
    ranges, start, res, *_ = scan_case(seed)
    ref = jax.jit(lambda r: jproj.scan_to_points(
        jproj.LaserScan(r, start, res), 3.0))(jnp.asarray(ranges))
    got = tproj.scan_to_points(
        tproj.LaserScan(t(ranges), t(start), t(res)), 3.0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    valid = np.asarray(ref[1])
    close(got[0][t(valid)], np.asarray(ref[0])[valid])


@pytest.mark.parametrize("seed,colored", [(0, False), (1, True), (2, False)])
def test_project_points(seed, colored):
    ranges, start, res, q, rot, trans, color = scan_case(seed)
    pts, valid = jproj.scan_to_points(
        jproj.LaserScan(jnp.asarray(ranges), start, res), 3.0)
    pts = np.nan_to_num(np.asarray(pts))
    kw = dict(color=color) if colored else {}
    ref = jax.jit(lambda p, v: jproj.project_points(p, v, rot, trans, q,
                                                    **kw))(pts, valid)
    got = tproj.project_points(
        t(pts), t(np.asarray(valid)), t(rot), t(trans), t(q),
        **({"color": t(color)} if colored else {}))
    for name in ("xy", "z", "stdev", "color"):
        close(getattr(got, name), getattr(ref, name), name)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))


@pytest.mark.parametrize("seed", [0, 3])
def test_free_space_points(seed):
    ranges, start, res, q, rot, trans, _ = scan_case(seed)
    pts, valid = jproj.scan_to_points(
        jproj.LaserScan(jnp.asarray(ranges), start, res), 3.0)
    pts = np.nan_to_num(np.asarray(pts))
    ref = jax.jit(lambda p, v: jproj.free_space_points(p, v, rot, trans, q)
                  )(pts, valid)
    got = tproj.free_space_points(t(pts), t(np.asarray(valid)), t(rot),
                                  t(trans), t(q))
    assert got[0].shape == (R * 6, 3)
    close(got[0], ref[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


def image_case(seed, h=6, w=8):
    """A seeded distance image with nan, zero, negative and too-far
    pixels, its intrinsics (the pinhole model of ``examples/full_demo.py``)
    and an aligned texture."""
    rng = np.random.default_rng(seed)
    data = rng.uniform(0.4, 3.5, (h, w)).astype(np.float32)
    data[0, 1], data[2, 3], data[3, 0], data[5, 7] = np.nan, 0.0, -1.0, 9.0
    fields = dict(data=data, scale_x=np.float32(2 * 0.5 / w),
                  scale_y=np.float32(2 * 0.4 / h),
                  center_x=np.float32(-0.5), center_y=np.float32(-0.4))
    texture = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    return fields, texture


@pytest.mark.parametrize("seed", [0, 4])
def test_distance_image_to_points(seed):
    fields, texture = image_case(seed)
    ref = jax.jit(lambda d: jproj.distance_image_to_points(
        jproj.DistanceImage(**d), 3.0))(fields)
    img = convert.distance_image_from(fields)
    got = tproj.distance_image_to_points(img, 3.0)
    valid = np.asarray(ref[1])
    assert got[0].shape == (48, 3) and 0 < valid.sum() <= 48 - 4
    np.testing.assert_array_equal(got[1].numpy(), valid)
    close(got[0][t(valid)], np.asarray(ref[0])[valid])
    # invalid pixels carry finite coordinates where the distance is finite
    assert bool(torch.isfinite(got[0][:, 2]).all())
    np.testing.assert_array_equal(
        tproj.texture_colors(img, texture).numpy(),
        np.asarray(jproj.texture_colors(jproj.DistanceImage(**fields),
                                        texture)))


@pytest.mark.parametrize("seed", [1, 5])
def test_textured_camera_cloud(seed):
    """Distance image -> points -> textured ``PatchCloud`` under a tilted
    orientation and a camera mount, as ``update_distance_image`` chains
    them."""
    fields, texture = image_case(seed)
    _, _, _, q, rot, trans, _ = scan_case(seed)

    def jax_cloud(d, tex):
        img = jproj.DistanceImage(**d)
        pts, valid = jproj.distance_image_to_points(img, 3.0)
        return jproj.project_points(pts, valid, rot, trans, q,
                                    color=jproj.texture_colors(img, tex))

    ref = jax.jit(jax_cloud)(fields, texture)
    img = convert.distance_image_from(fields)
    pts, valid = tproj.distance_image_to_points(img, 3.0)
    got = tproj.project_points(pts, valid, t(rot), t(trans), t(q),
                               color=tproj.texture_colors(img, t(texture)))
    ok = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), ok)
    for name in ("xy", "z", "stdev"):
        close(getattr(got, name)[t(ok)], np.asarray(getattr(ref, name))[ok],
              name)
    np.testing.assert_array_equal(got.color.numpy(), np.asarray(ref.color))
    assert float(got.color.max()) > 0.5
