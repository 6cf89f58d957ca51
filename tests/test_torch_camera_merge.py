"""The camera's distance-image update of the PyTorch port against the
plain reference ``reference/slam_camera.py`` (plain float32 PyTorch,
nothing of the port), and the cloud merge beyond K3's 16,384 points
(``ops.cloud_merge``), on the CPU.

* A camera frame of ``make_slam_step`` (8 particles, a 64 x 48 textured
  distance image with invalid pixels, a colour pool) leaves the particles
  as the same frame without the image does, bit for bit (the reference's
  camera update moves no particle), gives every particle a head of its
  own whose chain levels are the reference's (rolled over where a
  particle left its grid), and holds the reference's head grids: fields
  and colour.
* ``map_pool.merge_cloud_all`` on a cloud of more than 16,384 points (the
  cloud merge's plain version) holds the reference's head grids, counts
  ``merge.points`` and ``merge.cells`` as the reference places them, and
  equals K3's plain version on the same operands bit for bit.
* Merging one cloud in two pieces gives other maps than merging it once:
  the slot rules run once a cell on the whole cloud.

Tolerances: cell fields and colour within 1e-5 (float32 sums over up to a
few hundred points, in point order in the port and in scatter order in
the reference); and at most 1 % of the written cells may differ, because
the port computes a cell as ``floor(offset * (1 / resolution))`` and the
reference as ``floor(offset / resolution)``, which put a point that lies
within a rounding of a cell edge on different sides.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from reference import slam_camera as cref  # noqa: E402
from slam_eslam_tpu_torch import Config, ContactModelConfig  # noqa: E402
from slam_eslam_tpu_torch.config import UpdateThreshold  # noqa: E402
from slam_eslam_tpu_torch.filter import streaming  # noqa: E402
from slam_eslam_tpu_torch.filter.eslam_filter import (  # noqa: E402
    EmbodiedSlamFilter)
from slam_eslam_tpu_torch.filter.pose_estimator import ProjectDraws  # noqa: E402
from slam_eslam_tpu_torch.filter.step import StepDraws  # noqa: E402
from slam_eslam_tpu_torch.mapping import map_pool as mp  # noqa: E402
from slam_eslam_tpu_torch.mapping.mls_grid import PatchCloud  # noqa: E402
from slam_eslam_tpu_torch.ops import block_merge as bm  # noqa: E402
from slam_eslam_tpu_torch.ops import cloud_merge as cm  # noqa: E402
from slam_eslam_tpu_torch.utils import tracing  # noqa: E402

N = 8
TOL = 1e-5           # metres, and a colour channel in [0, 1]
EDGE_SHARE = 0.01    # written cells a cell-edge rounding may move
# camera z forward along body +y, x along +x, y down, pitched 30 deg down
PITCH = np.deg2rad(30.0)
CAMERA = (np.array([[1.0, 0.0, 0.0],
                    [0.0, -np.sin(PITCH), np.cos(PITCH)],
                    [0.0, -np.cos(PITCH), -np.sin(PITCH)]], np.float32),
          np.array([0.0, 0.2, 0.3], np.float32))


def config(grid_size=4.0):
    return dataclasses.replace(
        Config(), particle_count=N, min_effective=1, grid_size=grid_size,
        grid_resolution=0.05, map_pool_blocks=4 * N, map_chain_length=3,
        map_pool_color=True, max_sensor_range=1.5,
        measurement_threshold=UpdateThreshold(100.0, 10.0),
        mapping_camera_threshold=UpdateThreshold(0.02, 0.0873),
        contact_model=ContactModelConfig(contact_point_radius=0.0,
                                         min_contacts=2))


def image(h, w, seed):
    """A seeded distance image ``[H, W]`` (0.6-1.3 m, a few pixels
    invalid: NaN, 0 and beyond the range) and texture ``[H, W, 3]``."""
    gen = torch.Generator().manual_seed(seed)
    d = 0.6 + 0.7 * torch.rand((h, w), generator=gen)
    bad = torch.rand((h, w), generator=gen)
    d = torch.where(bad < 0.02, torch.nan, d)
    d = torch.where((bad >= 0.02) & (bad < 0.04), 0.0, d)
    d = torch.where((bad >= 0.04) & (bad < 0.06), 4.0, d)
    return d, torch.rand((h, w, 3), generator=gen)


def intrinsics(h, w):
    s = np.tan(np.pi / 6) / (w / 2)
    return (s, s, -s * (w - 1) / 2, -s * (h - 1) / 2)


def heads(pool):
    """Every particle's whole head grid as the reference's window, its
    origin and its chain levels' origins (NaN: no level)."""
    head = pool.chain[:, 0].long()
    grid = lambda f, *t: f.view(pool.b, pool.nx, pool.ny, pool.k, *t)[head]
    meta = grid(pool.meta)
    win = {"mean": grid(pool.mean).float(), "stdev": grid(pool.stdev).float(),
           "height": grid(pool.height).float(), "valid": (meta & 1) != 0,
           "horiz": (meta & 2) != 0, "uidx": meta >> 2,
           "color": grid(pool.color, 3).float()}
    lvl = pool.origin[pool.chain.clamp(min=0).long()]
    lvl = torch.where((pool.chain >= 0)[..., None], lvl, torch.nan)
    return win, pool.origin[head].clone(), lvl


def frame(pos, dimg, timg, has):
    """One ``SlamFrames`` frame at ``pos`` with the camera image."""
    from slam_eslam_tpu_torch.core.state import BodyContactState

    cs = BodyContactState.create(np.zeros((4, 3)))
    q = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    p = np.asarray(pos, np.float32)
    return streaming.SlamFrames(
        contact=cs, q=torch.from_numpy(q), body_pos=torch.from_numpy(p),
        ranges=torch.zeros(1), start_angle=torch.zeros(()),
        angular_resolution=torch.ones(()), has_scan=torch.tensor(False),
        host_q=q, host_body_pos=p, host_has_scan=np.bool_(False),
        dimg=dimg, has_dimg=torch.tensor(has), timg=timg,
        host_has_dimg=np.bool_(has))


def draws(seed):
    gen = torch.Generator().manual_seed(seed)
    n = lambda *s: 0.3 * torch.randn((N,) + s, generator=gen)
    u = lambda: torch.rand(N, generator=gen)
    return StepDraws(project=ProjectDraws(
        delta_xy=n(2), delta_yaw=n(), slip=u(), shrink=u(), spread_xy=n(2),
        spread_yaw=n()), resample_u=u())


def start(cfg, seed):
    gen = torch.Generator().manual_seed(seed)
    f = EmbodiedSlamFilter(config=cfg, device="cpu").init(
        pose=(np.zeros(3), 0.0), use_shared_map=False, num_contact_points=4,
        normal_xy=torch.randn((N, 2), generator=gen),
        normal_yaw=torch.randn((N,), generator=gen))
    return streaming.StreamingState.create(f.state, f.pool)


def clone_carry(carry):
    pool = dataclasses.replace(carry.pool, **{
        k: getattr(carry.pool, k).clone() for k in (
            "mean", "stdev", "height", "meta", "color", "origin",
            "allocated", "chain")})
    return dataclasses.replace(carry, pool=pool,
                               alloc_failed=carry.alloc_failed.clone())


def reference_frame(cfg, carry, after, dimg, timg, update_idx, pre):
    """The reference's head grids after the camera frame from the pool
    before it (``pre``: ``heads`` of it) and the particles after it:
    ``(window, origin, levels, cells written, points beyond)``."""
    p = after.filter.particles
    nx = carry.pool.nx
    win, origin0, levels0 = pre
    origin, rolled = cref.heads(origin0, p.x, p.y, cfg.grid_resolution,
                                (nx, nx), cfg.grid_size / 2.0
                                * cfg.grid_threshold)
    levels = cref.rolled_levels(levels0, origin, rolled)
    start_ = {k: torch.where(rolled.view((-1,) + (1,) * (v.dim() - 1)),
                             torch.zeros_like(v), v) for k, v in win.items()}
    cloud = cref.image_cloud(dimg, intrinsics(*dimg.shape),
                             cfg.max_sensor_range, torch.tensor(
                                 [1.0, 0.0, 0.0, 0.0]),
                             torch.from_numpy(CAMERA[0]),
                             torch.from_numpy(CAMERA[1]), timg)
    want, written, beyond = cref.merge(
        start_, origin, torch.zeros((N, 2), dtype=torch.long), (nx, nx),
        p.x, p.y, p.yaw, p.z, p.z_sigma, cloud, update_idx,
        cfg.grid_resolution, cfg.grid_patch_thickness, cfg.grid_gap_size)
    return want, origin, levels, written, beyond


def assert_heads_match(want, got, written):
    bad = cref.cell_changes(want, got, TOL, TOL)
    assert written > 0
    assert int(bad.sum()) <= EDGE_SHARE * written, (int(bad.sum()), written)


@pytest.mark.parametrize("seed,jump", [(1, 0.0), (2, 0.0), (3, 1.2)],
                         ids=["fuse", "fuse-2", "rollover"])
def test_camera_frame_matches_reference(seed, jump):
    """Frame 0 weighs (the measurement gate's first anchor), frames 1-3
    each merge an image into every particle's map; frame 3 is checked,
    with every particle moved ``jump`` m along y before it: 1.2 m rolls
    every particle over onto a new grid."""
    cfg = config()
    h, w = 48, 64
    step = streaming.make_slam_step(
        cfg, camera2body=CAMERA, camera_intrinsics=intrinsics(h, w),
        camera_texture=True)
    carry = start(cfg, seed)
    imgs = [image(h, w, 10 * seed + i) for i in range(4)]
    ys = [0.0, 0.03, 0.06, 0.09]
    for t in range(3):
        carry, aux = step(carry, frame((0.0, ys[t], 0.0), *imgs[t],
                                       t > 0), None, draws(100 * seed + t))
        assert aux["cam_mapped"] == (t > 0)
    p = carry.filter.particles
    carry = dataclasses.replace(carry, filter=dataclasses.replace(
        carry.filter, particles=dataclasses.replace(p, y=p.y + jump)))
    before = clone_carry(carry)
    pre = heads(before.pool)
    t = 3
    after, aux = step(carry, frame((0.0, ys[t], 0.0), *imgs[t], True),
                      None, draws(100 * seed + t))
    assert aux["cam_mapped"] and not aux["updated"]
    assert int(after.alloc_failed) == 0
    # the image moves no particle: the same frame without it
    plain, _ = step(clone_carry(before), frame((0.0, ys[t], 0.0),
                                               *imgs[t], False),
                    None, draws(100 * seed + t))
    for k in ("x", "y", "yaw", "z", "z_sigma", "weight"):
        assert torch.equal(getattr(after.filter.particles, k),
                           getattr(plain.filter.particles, k)), k
    # every particle a head of its own, its levels the reference's
    head = after.pool.chain[:, 0]
    assert int(torch.unique(head).numel()) == N
    want, origin, levels, written, beyond = reference_frame(
        cfg, before, after, *imgs[t], before.update_idx, pre)
    assert beyond == 0
    win, got_origin, got_levels = heads(after.pool)
    torch.testing.assert_close(got_origin, origin, rtol=0, atol=1e-6)
    assert torch.equal(got_levels.isnan(), levels.isnan())
    torch.testing.assert_close(got_levels.nan_to_num(), levels.nan_to_num(),
                               rtol=0, atol=1e-6)
    rolled = (origin - pre[1]).abs().amax(-1) > 1e-6
    assert bool(rolled.all()) == (jump > 0)
    assert_heads_match(want, win, written)


def big_cloud(p, seed, color=True):
    """A cloud of ``p`` points ahead of the body: a 1.6 m x 1.2 m field of
    heights near 0.3 m (the pool's fusable band), a tenth invalid."""
    gen = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.rand(s, generator=gen)
    xy = torch.stack([1.6 * r(p) - 0.8, 0.3 + 1.2 * r(p)], -1)
    return PatchCloud.create(
        xy=xy, z=0.3 + 0.05 * torch.randn(p, generator=gen),
        stdev=0.01 + 0.04 * r(p), valid=r(p) < 0.9,
        color=r(p, 3) if color else None)


def colour_pool(seed):
    from slam_eslam_tpu_torch.models import sim

    pool = sim.random_pool(N, 4 * N, 80, 80, resolution=0.05, seed=seed)
    pool.color = torch.rand((pool.b, 80, 80 * 4 * 3),
                            generator=torch.Generator().manual_seed(seed))
    return pool


def pool_copy(pool):
    return dataclasses.replace(pool, **{
        k: getattr(pool, k).clone() for k in (
            "mean", "stdev", "height", "meta", "color", "origin",
            "allocated", "chain")})


def poses(pool, seed):
    """Poses near each head grid's centre, headings all round."""
    gen = torch.Generator().manual_seed(seed)
    centre = pool.origin[pool.active().long()] + 2.0
    xy = centre + 0.4 * (2 * torch.rand((N, 2), generator=gen) - 1)
    return (xy, (2 * torch.rand(N, generator=gen) - 1) * np.pi,
            0.02 * torch.randn(N, generator=gen),
            0.05 * torch.rand(N, generator=gen))


def test_cloud_merge_beyond_k3_matches_reference(monkeypatch):
    """20,000 points (over K3's 16,384) into a colour pool: the cloud
    merge's plain version, against the reference and K3's plain version
    on the same operands, with the tracer's counters."""
    p = 20_000
    assert p > bm.MAX_POINTS
    pool = colour_pool(5)
    cloud = big_cloud(p, 6)
    xy, yaw, z, zs = poses(pool, 7)
    called = []
    real = cm.cloud_merge_reference
    monkeypatch.setattr(cm, "cloud_merge_reference",
                        lambda *a, **kw: called.append(1) or real(*a, **kw))
    # a few particles at a time, as a large cloud is placed
    monkeypatch.setattr(cm, "PLAIN_ELEMENTS", 3 * p)
    pre = heads(pool)
    got = pool_copy(pool)
    tracing.reset()
    with tracing.enable():
        mp.merge_cloud_all(got, xy, yaw, z, zs, cloud, 9)
    counts = tracing.counts(tracing.records().loose)
    assert called == [1]
    # K3's plain version on merge_operands' [N, P] rows
    k3 = pool_copy(pool)
    bm.block_merge_reference(
        k3.mean, k3.stdev, k3.height, k3.meta, k3.color,
        *mp.merge_operands(k3, xy, yaw, z, zs, cloud), 9, cloud.color, k=4)
    for f in ("mean", "stdev", "height", "meta", "color"):
        assert torch.equal(getattr(got, f), getattr(k3, f)), f
    # the reference, from each particle's whole head grid
    nx = pool.nx
    want, written, beyond = cref.merge(
        pre[0], pre[1], torch.zeros((N, 2), dtype=torch.long), (nx, nx),
        xy[:, 0], xy[:, 1], yaw, z, zs,
        (cloud.xy, cloud.z, cloud.stdev, cloud.valid, cloud.color), 9,
        0.05, 0.1, 1.5)
    assert beyond == 0
    assert_heads_match(want, heads(got)[0], written)
    placed, cells = (int(v) for v in cm.touched(*mp.merge_operands(
        pool, xy, yaw, z, zs, cloud)[1:3], nx, nx))
    assert counts == {"merge.points": placed, "merge.cells": cells}
    assert abs(cells - written) <= EDGE_SHARE * written


def test_merging_in_two_pieces_gives_other_maps():
    """The same cloud merged in two halves (two calls, one update index)
    runs the slot rules twice on a cell both halves hit: other maps than
    one merge of the whole cloud."""
    p = 2 * 17_000
    pool = colour_pool(8)
    cloud = big_cloud(p, 9)
    xy, yaw, z, zs = poses(pool, 10)
    once, twice = pool_copy(pool), pool_copy(pool)
    mp.merge_cloud_all(once, xy, yaw, z, zs, cloud, 3)
    for half in (slice(0, p // 2), slice(p // 2, p)):
        part = PatchCloud(xy=cloud.xy[half], z=cloud.z[half],
                          stdev=cloud.stdev[half], valid=cloud.valid[half],
                          color=cloud.color[half])
        mp.merge_cloud_all(twice, xy, yaw, z, zs, part, 3)
    differ = (once.mean != twice.mean) | (once.meta != twice.meta)
    assert int(differ.sum()) > 100
