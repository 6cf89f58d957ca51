"""The port's single-grid write side against the JAX package.

Every scripted case of ``tests/test_mls_grid.py::TestMergeAndLookup``,
``TestColorAndNegative`` and ``TestMatchMergeCloud`` is replayed as a list
of operations (``merge_points``, ``apply_negative_points``, ``clear``,
``merge_cloud``, ``match_cloud``) through the JAX functions and through
``slam_eslam_tpu_torch.mapping.mls_grid`` on the same inputs; after every
operation the two grids are compared whole.  Seeded dense cases (many
points per cell, all four envire rules, colour) follow.

Tolerances: ``valid``, ``horizontal`` and ``update_idx`` equal; ``mean``,
``stdev`` and ``color`` within rtol 2e-6 (XLA's CPU compiler contracts
multiply-adds, the port rounds every operation; several points per cell
sum in another order), ``height`` within 1e-6 m; match scores within rtol
1e-5.  Grids are at 0.5 m and 0.25 m, whose reciprocals are exact, so
both packages put every point into the same cell.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_eslam_tpu.mapping import mls_grid as jmls
from slam_eslam_tpu_torch import convert
from slam_eslam_tpu_torch.mapping import mls_grid as tmls

torch.set_num_threads(2)


def as_dict(pytree):
    return jax.tree_util.tree_map(np.asarray, dataclasses.asdict(pytree))


def t(a):
    return torch.from_numpy(np.array(a))


def f32(a):
    return np.asarray(a, np.float32)


def grid_args(nx=20, ny=20, res=0.5, origin=(-5.0, -5.0), k=4):
    return nx, ny, res, origin, k


def assert_grids_match(got, ref, label):
    g, r = convert.to_numpy(got), as_dict(ref)
    for name in ("valid", "horizontal", "update_idx"):
        np.testing.assert_array_equal(g[name], r[name],
                                      err_msg=f"{label} {name}")
    valid = r["valid"]
    for name in ("mean", "stdev"):
        np.testing.assert_allclose(g[name][valid], r[name][valid], rtol=2e-6,
                                   atol=0, err_msg=f"{label} {name}")
    np.testing.assert_allclose(g["height"][valid], r["height"][valid],
                               rtol=0, atol=1e-6, err_msg=f"{label} height")
    np.testing.assert_allclose(g["color"][valid], r["color"][valid],
                               rtol=2e-6, atol=1e-7,
                               err_msg=f"{label} color")


# one operation = (name, positional arguments as numpy, keyword arguments)
def merge(xy, z, sd, mask, uidx, color=None, **kw):
    if color is not None:
        kw["color"] = f32(color)
    return ("merge", (f32(xy), f32(z), f32(sd), np.asarray(mask, bool)),
            dict(update_idx=uidx, **kw))


def negative(points, mask, z_margin=0.15):
    return ("negative", (f32(points), np.asarray(mask, bool)),
            dict(z_margin=z_margin))


def lookup(points, z_window=3.0):
    return ("lookup", (f32(points),), dict(z_window=z_window))


CLEAR = ("clear", (), {})
AT = [[0.0, 0.0]]

CASES = {
    "insert_then_lookup": (grid_args(), [
        merge([[0.0, 0.0], [1.0, 1.0]], [0.5, -0.25], [0.1, 0.2],
              [True, True], 7),
        lookup([[0.0, 0.0, 0.4], [1.0, 1.0, 0.0], [3.0, 3.0, 0.0]])]),
    "same_cell_points_fused": (grid_args(), [
        merge([[0.1, 0.1], [0.2, 0.2]], [1.0, 2.0], [0.5, 0.5],
              [True, True], 0),
        lookup([[0.1, 0.1, 1.5]])]),
    "kalman_fusion_within_thickness": (grid_args(), [
        merge(AT, [1.0], [0.3], [True], 0),
        merge(AT, [1.05], [0.3], [True], 1, patch_thickness=0.1),
        lookup([[0.0, 0.0, 1.0]])]),
    "multi_level_patches": (grid_args(), [
        merge(AT, [0.0], [0.1], [True], 0, gap_size=1.0),
        merge(AT, [3.0], [0.1], [True], 0, gap_size=1.0),
        lookup([[0.0, 0.0, 0.2], [0.0, 0.0, 2.8]], 1.0)]),
    "vertical_extension_within_gap": (grid_args(), [
        merge(AT, [0.0], [0.1], [True], 0, patch_thickness=0.1,
              gap_size=1.0),
        merge(AT, [0.5], [0.1], [True], 0, patch_thickness=0.1,
              gap_size=1.0)]),
    "eviction_when_full": (grid_args(k=2), [
        merge(AT, [0.0], [0.1], [True], 0, gap_size=0.5),
        merge(AT, [5.0], [0.9], [True], 0, gap_size=0.5),
        merge(AT, [10.0], [0.2], [True], 0, gap_size=0.5)]),
    "invalid_points_ignored": (grid_args(), [
        merge(AT, [1.0], [0.1], [False], 0)]),
    "clear": (grid_args(), [merge(AT, [1.0], [0.1], [True], 3), CLEAR]),
    "merge_carries_color": (grid_args(), [
        merge(AT, [0.5], [0.1], [True], 0, color=[[1.0, 0.2, 0.0]]),
        lookup([[0.0, 0.0, 0.5]])]),
    "same_cell_colors_fused": (grid_args(), [
        merge([[0.1, 0.1], [0.2, 0.2]], [1.0, 1.0], [0.5, 0.5],
              [True, True], 0, color=[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]),
        lookup([[0.1, 0.1, 1.0]])]),
    "negative_information_removes_contradicted": (grid_args(), [
        merge([[0.0, 0.0], [1.0, 1.0]], [0.5, 2.0], [0.1, 0.1],
              [True, True], 0, gap_size=0.3),
        negative([[0.0, 0.0, 0.55], [5.0, 5.0, 0.0]], [True, True]),
        lookup([[0.0, 0.0, 0.5], [1.0, 1.0, 2.0]])]),
    "negative_far_z_untouched": (grid_args(), [
        merge(AT, [2.0], [0.1], [True], 0),
        negative([[0.0, 0.0, 0.2]], [True]),
        lookup([[0.0, 0.0, 2.0]])]),
}

JAX_OPS = {
    "merge": lambda g, a, kw: jmls.merge_points(
        g, *a, kw["update_idx"],
        **{k: v for k, v in kw.items() if k != "update_idx"}),
    "negative": lambda g, a, kw: jmls.apply_negative_points(g, *a, **kw),
    "clear": lambda g, a, kw: g.clear(),
}
TORCH_OPS = {
    "merge": lambda g, a, kw: tmls.merge_points(
        g, *a, kw["update_idx"],
        **{k: v for k, v in kw.items() if k != "update_idx"}),
    "negative": lambda g, a, kw: tmls.apply_negative_points(g, *a, **kw),
    "clear": lambda g, a, kw: g.clear(),
}


@pytest.mark.parametrize("name", list(CASES))
def test_scripted_case(name):
    (nx, ny, res, origin, k), ops = CASES[name]
    jg = jmls.MLSGrid.create(nx, ny, res, origin, k)
    tg = tmls.MLSGrid.create(nx, ny, res, origin, k, device="cpu")
    for i, (op, args, kw) in enumerate(ops):
        tkw = {key: t(v) if isinstance(v, np.ndarray) else v
               for key, v in kw.items()}
        if op == "lookup":
            ref = jmls.get_patch(jg, jnp.asarray(args[0]), **kw)
            got = tmls.get_patch(tg, t(args[0]), **tkw)
            found = np.asarray(ref[0])
            np.testing.assert_array_equal(got[0].numpy(), found)
            for a, b in zip(got[1:], ref[1:]):
                np.testing.assert_allclose(a.numpy()[found],
                                           np.asarray(b)[found], rtol=2e-6,
                                           atol=1e-7)
            continue
        before = convert.to_numpy(tg)
        jg = JAX_OPS[op](jg, tuple(jnp.asarray(a) for a in args), kw)
        new = TORCH_OPS[op](tg, tuple(t(a) for a in args), tkw)
        # the writers return a new grid and leave their input alone
        for key, val in convert.to_numpy(tg).items():
            np.testing.assert_array_equal(val, before[key])
        tg = new
        assert_grids_match(tg, jg, f"{name} step {i} ({op})")
    if name not in ("invalid_points_ignored", "clear"):
        assert int(tg.valid.sum()) > 0


def dense_case(seed, p, with_color):
    """A 12x12x4 grid at 0.25 m filled by six seeded merges of ``p``
    points into a 2 m square: many points per cell, heights near 0.3 m
    (fuse), 0.5-1.3 m above (gap) and 2-3 m above (insert, evict)."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(6):
        kind = rng.choice(3, p, p=[0.4, 0.3, 0.3])
        z = np.where(kind == 0, 0.3 + rng.normal(0, 0.03, p),
                     np.where(kind == 1, 0.3 + rng.uniform(0.5, 1.3, p),
                              0.3 + rng.uniform(2.0, 9.0, p)))
        ops.append(merge(rng.uniform(-1.2, 1.2, (p, 2)), z,
                         rng.uniform(0.01, 0.2, p), rng.random(p) < 0.9, i,
                         color=(rng.uniform(0, 1, (p, 3)) if with_color
                                else None)))
    return ops


@pytest.mark.parametrize("p,with_color", [(60, False), (200, True)])
def test_dense_merges_match_jax(p, with_color):
    jg = jmls.MLSGrid.create(12, 12, 0.25, (-1.0, -1.0), 4)
    tg = tmls.MLSGrid.create(12, 12, 0.25, (-1.0, -1.0), 4, device="cpu")
    fn = jax.jit(jmls.merge_points, static_argnums=5)
    for i, (_, args, kw) in enumerate(dense_case(p, p, with_color)):
        color = kw.pop("color", None)
        jg = fn(jg, *(jnp.asarray(a) for a in args), kw["update_idx"],
                color=None if color is None else jnp.asarray(color))
        tg = tmls.merge_points(tg, *(t(a) for a in args), kw["update_idx"],
                               color=None if color is None else t(color))
        assert_grids_match(tg, jg, f"dense merge {i}")
    full = np.asarray(jg.valid).all(-1)
    assert full.any() and (~np.asarray(jg.horizontal)
                           & np.asarray(jg.valid)).any()
    assert (np.asarray(jg.update_idx)[np.asarray(jg.valid)] == 5).any()


def test_dedup_fuse_matches_jax():
    rng = np.random.default_rng(41)
    p, nx, ny = 50, 4, 5
    ix = rng.integers(0, nx, p).astype(np.int32)
    iy = rng.integers(0, ny, p).astype(np.int32)
    z = rng.uniform(0, 1, p).astype(np.float32)
    var = rng.uniform(1e-4, 1e-2, p).astype(np.float32)
    mask = rng.random(p) < 0.8
    color = rng.uniform(0, 1, (p, 3)).astype(np.float32)
    ref = jax.jit(jmls._dedup_fuse, static_argnums=(5, 6))(
        ix, iy, z, var, mask, nx, ny, color=color)
    got = tmls._dedup_fuse(t(ix), t(iy), t(z), t(var), t(mask), nx, ny,
                           color=t(color))
    keep = np.asarray(ref[4])
    np.testing.assert_array_equal(got[4].numpy(), keep)
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(ref[5]))
    for i in (0, 1):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref[i]))
    for i in (2, 3, 6):
        np.testing.assert_allclose(got[i].numpy()[keep],
                                   np.asarray(ref[i])[keep], rtol=2e-6)


def test_apply_negative_points_matches_jax():
    rng = np.random.default_rng(43)
    jg = jmls.MLSGrid.create(12, 12, 0.25, (-1.0, -1.0), 4)
    (_, args, kw), *_ = dense_case(43, 300, False)
    jg = jmls.merge_points(jg, *(jnp.asarray(a) for a in args), 0)
    tg = convert.mls_grid_from(as_dict(jg))
    pts = np.concatenate([rng.uniform(-1.4, 2.4, (80, 2)),
                          rng.uniform(0.2, 0.5, (80, 1))], -1).astype(
        np.float32)
    mask = rng.random(80) < 0.8
    ref = jax.jit(jmls.apply_negative_points)(jg, pts, mask)
    got = tmls.apply_negative_points(tg, t(pts), t(mask))
    assert_grids_match(got, ref, "negative")
    cleared = np.asarray(jg.valid) & ~np.asarray(ref.valid)
    assert 0 < cleared.sum() < np.asarray(jg.valid).sum()


# ------------------------------------------------------- match / merge cloud

def flat_grids(z=0.0):
    jg = jmls.MLSGrid.create(40, 40, 0.25, (-5.0, -5.0), 4)
    xs, ys = jnp.meshgrid(jnp.arange(40), jnp.arange(40), indexing="ij")
    xy = jg.from_grid(xs.ravel(), ys.ravel())
    n = xy.shape[0]
    jg = jmls.merge_points(jg, xy, jnp.full((n,), z), jnp.full((n,), 0.05),
                           jnp.ones((n,), bool), 0)
    return jg, convert.mls_grid_from(as_dict(jg))


def clouds(z=0.0, n=64, seed=0):
    rng = np.random.default_rng(seed)
    jc = jmls.PatchCloud.create(
        xy=jnp.asarray(rng.uniform(-2.0, 2.0, (n, 2)), jnp.float32),
        z=jnp.full((n,), z, jnp.float32),
        stdev=jnp.asarray(rng.uniform(0.02, 0.08, n), jnp.float32),
        valid=jnp.asarray(rng.random(n) < 0.9),
        color=jnp.asarray(rng.uniform(0, 1, (n, 3)), jnp.float32))
    return jc, convert.patch_cloud_from(as_dict(jc))


@pytest.mark.parametrize("name,cloud_z,z_offset,kw,low,high", [
    ("consistent_cloud_scores_high", 0.0, 0.0, dict(sampling=1), 0.95, 1.0),
    ("offset_cloud_scores_low", 2.0, 0.0, dict(sampling=1, z_window=10.0),
     0.0, 0.05),
    ("z_offset_compensates", 2.0, -2.0, dict(sampling=1, z_window=10.0),
     0.95, 1.0),
    ("default_sampling", 0.0, 0.0, {}, 0.9, 1.0),
])
def test_match_cloud(name, cloud_z, z_offset, kw, low, high):
    jg, tg = flat_grids(0.0)
    jc, tc = clouds(cloud_z)
    ref = float(jmls.match_cloud(jg, jc, jnp.eye(2), jnp.zeros(2), z_offset,
                                 0.0, **kw))
    got = float(tmls.match_cloud(tg, tc, torch.eye(2), torch.zeros(2),
                                 z_offset, 0.0, **kw))
    assert low <= ref <= high, name
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)


def test_match_cloud_over_particles_matches_vmap():
    """The batched pose form that ``process_map`` uses in shared-map mode
    against the JAX package's ``vmap`` of ``match_cloud``."""
    from slam_eslam_tpu.utils import geometry as jgeo
    from slam_eslam_tpu_torch.utils import geometry as tgeo

    rng = np.random.default_rng(47)
    jg, tg = flat_grids(0.1)
    jc, tc = clouds(0.1, n=50, seed=47)
    n = 16
    xy = rng.uniform(-3.5, 3.5, (n, 2)).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    z = rng.normal(0, 0.1, n).astype(np.float32)
    zs = rng.uniform(0, 0.1, n).astype(np.float32)
    ref = jax.jit(lambda g, c: jax.vmap(
        lambda x, th, zo, os_: jmls.match_cloud(
            g, c, jgeo.rot2d(th), x, zo, os_, sampling=3, sigma=0.2,
            z_window=3.0))(xy, yaw, z, zs))(jg, jc)
    got = tmls.match_cloud(tg, tc, tgeo.rot2d(t(yaw)), t(xy), t(z), t(zs),
                           sampling=3, sigma=0.2, z_window=3.0)
    ref = np.asarray(ref)
    assert got.shape == (n,) and 0.05 < ref.min() < ref.max() <= 1.0
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("theta,trans,z_offset,offset_stdev", [
    (np.pi / 2, (0.0, 0.0), 0.5, 0.0), (0.7, (0.4, -0.9), -0.2, 0.05)])
def test_merge_cloud(theta, trans, z_offset, offset_stdev):
    jg = jmls.MLSGrid.create(40, 40, 0.25, (-5.0, -5.0), 4)
    tg = convert.mls_grid_from(as_dict(jg))
    if offset_stdev:
        jc, tc = clouds(0.3, n=120, seed=53)
    else:  # the scripted case of TestMatchMergeCloud.test_merge_cloud_rotation
        jc = jmls.PatchCloud.create(
            xy=jnp.array([[2.0, 0.0]]), z=jnp.array([1.0]),
            stdev=jnp.array([0.1]), valid=jnp.array([True]))
        tc = convert.patch_cloud_from(as_dict(jc))
    r = np.array([[np.cos(theta), -np.sin(theta)],
                  [np.sin(theta), np.cos(theta)]], np.float32)
    for uidx in (0, 1):  # the second merge fuses into the first's patches
        jg = jmls.merge_cloud(jg, jc, jnp.asarray(r), jnp.asarray(f32(trans)),
                              z_offset, offset_stdev, uidx)
        tg = tmls.merge_cloud(tg, tc, t(r), t(f32(trans)), z_offset,
                              offset_stdev, uidx)
        assert_grids_match(tg, jg, f"merge_cloud {uidx}")
    assert int(tg.valid.sum()) > 0
    if not offset_stdev:
        found, mean, _, _ = tmls.get_patch(tg, t(f32([[0.0, 2.0, 1.5]])))
        assert bool(found[0])
        np.testing.assert_allclose(float(mean[0]), 1.5, atol=1e-6)
