"""The port's unfolded shared-grid lookup (kernel K5's plain version on
the CPU, ``ops.select_cells``) against the JAX package's lookups:
``make_lookup`` in its production ``auto`` mode, which reaches the
Pallas kernel ``window_select_t`` (K5a, interpret mode with float32
dots) for a compact cloud and the exact gather for a spread one, and
``windowed_grid_lookup`` in its ``q_flat`` (K5b) and ``q_sublanes`` (K5c)
layouts and unfused (K6, ``window_gather`` + an XLA select).

A pure select: ``found`` must be equal, and ``mean`` and ``stdev`` equal
bit for bit where found.  The JAX window kernels miss outside their
window by design, so they are held only on clouds the window covers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_eslam_tpu.config import Config
from slam_eslam_tpu.mapping import mls_grid as jmls
from slam_eslam_tpu.mapping.lookup import make_lookup as jmake_lookup
from slam_eslam_tpu.ops import pallas_gather as pg
from slam_eslam_tpu_torch import convert
from slam_eslam_tpu_torch.mapping import mls_grid
from slam_eslam_tpu_torch.mapping.lookup import (
    make_lookup, shared_grid_lookup)
from slam_eslam_tpu_torch.ops import select_cells as sc

torch.set_num_threads(2)

NX, NY, K = 64, 56, 4
RES = 0.1
ORIGIN = (-3.2, -2.8)
WINDOW = (32, 32)
CFG = dataclasses.replace(Config(), lookup_mode="auto", lookup_window=WINDOW,
                          lookup_tiers=())


def terrain(x, y):
    return 0.3 * np.sin(np.asarray(x)) + 0.2 * np.cos(0.7 * np.asarray(y))


def as_dict(pytree):
    return jax.tree_util.tree_map(np.asarray, dataclasses.asdict(pytree))


@pytest.fixture(scope="module")
def grids():
    """A grid with 4 slots per cell, some empty, the first near the
    terrain, the others up to 4 m away, and in one cell in ten a second
    slot at the first one's height (a tie the lowest slot wins)."""
    rng = np.random.default_rng(0)
    cx = (np.arange(NX) + 0.5) * RES + ORIGIN[0]
    cy = (np.arange(NY) + 0.5) * RES + ORIGIN[1]
    base = terrain(cx[:, None], cy[None, :])[..., None]
    mean = base + np.concatenate(
        [np.zeros((NX, NY, 1)), rng.uniform(-4.0, 4.0, (NX, NY, K - 1))], -1)
    tie = rng.random((NX, NY)) < 0.1
    mean[..., 1] = np.where(tie, mean[..., 0], mean[..., 1])
    valid = rng.random((NX, NY, K)) < 0.7
    valid[..., :2] |= tie[..., None]
    g = jmls.MLSGrid.create(NX, NY, RES, ORIGIN, K)
    g = dataclasses.replace(
        g, mean=jnp.asarray(mean, jnp.float32),
        stdev=jnp.asarray(rng.uniform(0.01, 0.1, (NX, NY, K)), jnp.float32),
        valid=jnp.asarray(valid))
    return g, convert.mls_grid_from(as_dict(g))


def cloud(spread, n=96, c=8, seed=1):
    """``[N, C, 3]`` queries: particles within ``spread`` metres of the
    grid centre, contact offsets of up to 0.3 m, heights near the terrain
    or up to 5 m off it, and exact cell edges."""
    rng = np.random.default_rng(seed)
    centre = np.array([ORIGIN[0] + NX * RES / 2, ORIGIN[1] + NY * RES / 2])
    xy = (centre + rng.uniform(-spread, spread, (n, 1, 2))
          + rng.uniform(-0.3, 0.3, (1, c, 2)))
    edge = rng.random((n, c)) < 0.05
    xy[..., 0] = np.where(edge, np.round(xy[..., 0] / RES) * RES, xy[..., 0])
    z = terrain(xy[..., 0], xy[..., 1]) + rng.normal(0.0, 0.05, (n, c))
    z = np.where(rng.random((n, c)) < 0.2, z + rng.uniform(-5, 5, (n, c)), z)
    return np.concatenate([xy, z[..., None]], -1).astype(np.float32)


def assert_select_equal(got, ref):
    found = np.asarray(ref[0])
    np.testing.assert_array_equal(np.asarray(got[0]), found)
    assert found.any() and not found.all()
    for a, b in zip(got[1:3], ref[1:3]):
        np.testing.assert_array_equal(np.asarray(a)[found],
                                      np.asarray(b)[found])


@pytest.mark.parametrize("spread", [1.0, 6.0], ids=["compact", "spread"])
@pytest.mark.parametrize("soa", [True, False], ids=["soa", "aos"])
def test_make_lookup_matches_jax_auto(grids, spread, soa):
    """Compact: K5a in interpret mode; spread (queries beyond the window
    and outside the grid): the JAX package's exact-gather fallback."""
    jgrid, tgrid = grids
    pts = cloud(spread)
    jl = jmake_lookup(CFG, jgrid)
    tl = make_lookup(CFG, tgrid)
    assert tl.soa and tl.fold is not None
    if soa:
        flat = pts.reshape(-1, 3)
        ref = jax.jit(lambda x, y, z: jl(None, (x, y, z)))(
            *(jnp.asarray(flat[:, i]) for i in range(3)))
        got = tl(None, tuple(torch.from_numpy(flat[:, i].copy())
                             for i in range(3)))
        assert len(got) == 3
    else:
        ref = jax.jit(lambda p: jl(None, p))(jnp.asarray(pts))
        got = tl(None, torch.from_numpy(pts))
        assert got[3].shape == pts.shape and not got[3].any()
    assert_select_equal(got, ref)


@pytest.mark.parametrize("variant", [
    dict(layout="q_flat"),                  # K5b
    dict(layout="q_sublanes"),              # K5c
    dict(fused=False),                      # K6, select in XLA
], ids=["K5b_q_flat", "K5c_q_sublanes", "K6_unfused"])
def test_matches_jax_window_kernels(grids, variant):
    jgrid, tgrid = grids
    pts = cloud(1.0, seed=2)      # a 2.6 m cloud inside the 3.2 m window
    packed = jmls.PackedLookup.from_grid(jgrid)
    fused = variant.get("fused", True)
    jl = pg.windowed_grid_lookup(packed, z_window=CFG.mls_z_window,
                                 window=WINDOW if fused else WINDOW[0],
                                 **variant)
    ref = jax.jit(lambda p: jl(None, p))(jnp.asarray(pts))
    got = make_lookup(CFG, tgrid)(None, torch.from_numpy(pts))
    assert_select_equal(got, ref)


def test_cell_queries_equal_world_queries(grids):
    """The kernel's two entry points: int32 cells give what world
    coordinates give (``mls_grid.cells`` computes the cells)."""
    _, tgrid = grids
    packed = mls_grid.PackedLookup.from_grid(tgrid)
    pts = torch.from_numpy(cloud(6.0, seed=3).reshape(-1, 3))
    x, y, z = pts.unbind(-1)
    ix, iy = mls_grid.cells(packed, x, y)
    before = sc.select_cells.launches
    world = sc.select_cells(packed, (x, y, z))
    cells = sc.select_cells(packed, (ix, iy, z))
    assert sc.select_cells.launches == before      # CPU: the plain version
    for a, b in zip(world, cells):
        assert torch.equal(a, b)


def test_miss_fill_values(grids):
    """What the kernel must reproduce on a miss: slot 0 of the query's
    cell, of cell (0, 0) outside the grid; ``stdev`` non-negative."""
    _, tgrid = grids
    packed = mls_grid.PackedLookup.from_grid(tgrid)
    ix = torch.tensor([-1, NX, 3, 5], dtype=torch.int32)
    iy = torch.tensor([2, 0, NY + 4, 7], dtype=torch.int32)
    z = torch.tensor([0.0, 0.0, 0.0, 1e4])
    found, mean, stdev = sc.select_cells(packed, (ix, iy, z))
    assert not found.any()
    data = packed.data
    np.testing.assert_array_equal(mean[:3].numpy(), data[0, 0, 0].expand(3))
    assert float(mean[3]) == float(data[5, 7, 0])
    assert float(stdev[3]) == abs(float(data[5, 7, K]))


def test_unpacked_lookup_matches_jax_get_patch(grids):
    """The slip update's colour lookup (a plain gather in both packages):
    raw stdev, unmasked means and colour, misses included."""
    jgrid, tgrid = grids
    rng = np.random.default_rng(4)
    color = rng.random((NX, NY, K, 3)).astype(np.float32)
    jgrid = dataclasses.replace(jgrid, color=jnp.asarray(color))
    tgrid = dataclasses.replace(tgrid, color=torch.from_numpy(color))
    pts = cloud(6.0, seed=5)
    ref = jax.jit(lambda g, p: jmls.get_patch(g, p, CFG.mls_z_window))(
        jgrid, jnp.asarray(pts))
    got = shared_grid_lookup(tgrid, CFG.mls_z_window, packed=False)(
        None, torch.from_numpy(pts))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_views_into_a_tensor_select_like_fresh_tensors(grids):
    """Queries given as views that start 4 bytes into a tensor (a sliced
    batch) select exactly as fresh copies do, world and cell entries, and
    as the JAX package's exact select: the kernel moves 4-byte words, so
    it needs no alignment of its queries."""
    jgrid, tgrid = grids
    packed = mls_grid.PackedLookup.from_grid(tgrid)
    jpacked = jmls.PackedLookup.from_grid(jgrid)
    flat = cloud(6.0, n=41, seed=5).reshape(-1, 3)
    qx, qy, qz = (torch.from_numpy(flat[:, i].copy()) for i in range(3))
    for count in (1, 3, 5, 40 * 8):
        view = tuple(a[1:count + 1] for a in (qx, qy, qz))
        assert all(v.data_ptr() - a.data_ptr() == 4
                   for v, a in zip(view, (qx, qy, qz)))
        fresh = tuple(v.clone() for v in view)
        ref = sc.select_cells_reference(packed, fresh)
        for q in (view, fresh):
            got = sc.select_cells(packed, q)
            ix, iy = mls_grid.cells(packed, q[0], q[1])
            by_cell = sc.select_cells(packed, (ix, iy, q[2]))
            for a, b, c in zip(got, ref, by_cell):
                assert a.shape == (count,)
                assert torch.equal(a, b) and torch.equal(a, c)
        jref = jmls.get_patch_packed_cells(
            jpacked, jnp.asarray(ix.numpy()), jnp.asarray(iy.numpy()),
            jnp.asarray(view[2].numpy()))
        for a, b in zip(got, jref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
