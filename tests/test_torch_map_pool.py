"""The port's copy-on-write map pool against the JAX package.

Bookkeeping (``from_template``, ``refcounts``, ``resample``,
``_allocate`` with exhaustion, ``ensure_unique_active``, ``rollover``)
must agree exactly.  The chain lookup's plain version (kernel K2's
oracle) must agree bit for bit with JAX ``chain_lookup`` and with the
Pallas ``chain_lookup_blocks`` in interpret mode.  ``merge_cloud_all``'s
plain version (kernel K3's oracle) is held against JAX ``kernel="xla"``,
``kernel="pallas"`` (interpret mode) and ``merge_blocks_grouped`` with
``group=4``: ``meta`` identical, float fields within 2 ulps on cells
that one point hits and within rtol 2e-6 on cells that several points
hit (f32 sums in another order).  The ulps are XLA's: its CPU compiler
contracts ``a*b + c*d`` (the point variance, then the Kalman fuse) into
fused multiply-adds, one rounding each, while the port rounds every
operation, as the CUDA kernel does, so that kernel and plain version
agree bit for bit (``tests/test_torch_cuda.py``).
``apply_negative_cloud_all`` must agree exactly, ``match_cloud_all``
within rtol 1e-5.  Every JAX function runs
under ``jax.jit``; the grids are at 0.25 m, whose reciprocal is exact.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_eslam_tpu.mapping import map_pool as jmp
from slam_eslam_tpu.mapping import mls_grid as jmls
from slam_eslam_tpu.ops import pallas_chain, pallas_merge
from slam_eslam_tpu_torch import convert
from slam_eslam_tpu_torch.mapping import map_pool as tmp
from slam_eslam_tpu_torch.mapping import mls_grid as tmls
from slam_eslam_tpu_torch.utils import graphs

torch.set_num_threads(2)

N, L, K = 32, 3, 4
NX = NY = 12           # 3 m at 0.25 m
RES = 0.25
SIZE = NX * RES


def as_dict(pytree):
    return jax.tree_util.tree_map(np.asarray, dataclasses.asdict(pytree))


def t(a):
    return torch.from_numpy(np.array(a))


def port_pool(jpool):
    return convert.map_pool_from(as_dict(jpool))


def random_pool(seed, n=N, b=4 * N, with_color=False, unique_heads=True):
    """A JAX ``MapPool`` with seeded content: each cell holds 0..K valid
    slots (half full on average), slot means near 0.3 m (fusable),
    0.5-1.3 m above (gap extension) or 2-3 m above (neither), random
    horizontal bits and update stamps, block origins on a 3 m lattice,
    and chains whose tails hold -1 entries."""
    rng = np.random.default_rng(seed)
    shape = (b, NX, NY * K)
    kind = rng.choice(3, shape, p=[0.3, 0.2, 0.5])
    mean = np.where(kind == 0, 0.3 + rng.normal(0, 0.03, shape),
                    np.where(kind == 1, 0.3 + rng.uniform(0.5, 1.3, shape),
                             0.3 + rng.uniform(2.0, 3.0, shape)))
    count = rng.integers(0, K + 1, (b, NX, NY, 1))
    rank = np.argsort(rng.random((b, NX, NY, K)), axis=-1)
    valid = (rank < count).reshape(shape)
    meta = (valid.astype(np.int32) | (rng.random(shape) < 0.8) << 1
            | rng.integers(0, 5, shape) << 2).astype(np.int32)
    origin = (rng.integers(-2, 2, (b, 2)) * SIZE - SIZE / 2).astype(
        np.float32)
    if unique_heads:
        heads = rng.permutation(b)[:n]
    else:
        heads = rng.integers(0, b, n)
    chain = np.concatenate([heads[:, None], rng.integers(0, b, (n, L - 1))],
                           axis=1)
    chain[rng.random((n, L)) < 0.25] = -1
    chain[:, 0] = heads
    f = lambda a: jnp.asarray(a, jnp.float32)
    return jmp.MapPool(
        mean=f(mean), stdev=f(rng.uniform(0.01, 0.2, shape)),
        height=f(rng.uniform(0, 0.3, shape) * (rng.random(shape) < 0.3)),
        meta=jnp.asarray(meta),
        color=(f(rng.uniform(0, 1, (b, NX, NY * K * 3))) if with_color
               else None),
        origin=jnp.asarray(origin),
        allocated=jnp.asarray(np.isin(np.arange(b), chain)),
        chain=jnp.asarray(chain.astype(np.int32)),
        resolution=RES, nx=NX, ny=NY, k=K)


def assert_pool_equal(got, ref):
    g, r = convert.to_numpy(got), as_dict(ref)
    for name in ("mean", "stdev", "height", "meta", "color", "origin",
                 "allocated", "chain"):
        if r[name] is None:
            assert g[name] is None, name
        else:
            np.testing.assert_array_equal(g[name], r[name], err_msg=name)


def particles_near_heads(jpool, seed, spread=0.6):
    """Particle xy around the centre of each head block, yaw, z, z_sigma."""
    rng = np.random.default_rng(seed)
    heads = np.asarray(jpool.chain)[:, 0]
    centre = np.asarray(jpool.origin)[heads] + SIZE / 2
    n = heads.shape[0]
    xy = (centre + rng.uniform(-spread, spread, (n, 2))).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    z = rng.normal(0.0, 0.02, n).astype(np.float32)
    zs = rng.uniform(0.0, 0.05, n).astype(np.float32)
    return xy, yaw, z, zs


# ------------------------------------------------------------ bookkeeping

class TestBookkeeping:
    @pytest.mark.parametrize("with_color", [False, True])
    def test_from_template(self, with_color):
        rng = np.random.default_rng(0)
        grid = jmls.MLSGrid.create(NX, NY, RES, (-1.5, 2.0), k=K)
        grid = dataclasses.replace(
            grid, mean=jnp.asarray(rng.normal(0, 1, (NX, NY, K)), jnp.float32),
            valid=jnp.asarray(rng.random((NX, NY, K)) < 0.4),
            update_idx=jnp.asarray(rng.integers(0, 9, (NX, NY, K)),
                                   jnp.int32))
        ref = jmp.MapPool.from_template(grid, N, 3 * N, L,
                                        with_color=with_color)
        got = tmp.MapPool.from_template(convert.mls_grid_from(as_dict(grid)),
                                        N, 3 * N, L, with_color=with_color)
        assert_pool_equal(got, ref)
        assert (got.nx, got.ny, got.k, got.resolution) == (NX, NY, K, RES)

    @pytest.mark.parametrize("with_color,shards,dtype", [
        (False, 1, "float32"), (True, 1, "float32"), (False, 2, "bfloat16")])
    def test_refill_writes_the_template_pool_in_place(self, with_color,
                                                      shards, dtype):
        """``refill_`` of a pool that ran (every field overwritten) gives
        the JAX ``from_template``'s pool again, in the same tensors."""
        rng = np.random.default_rng(1)
        grid = jmls.MLSGrid.create(NX, NY, RES, (0.5, -1.0), k=K)
        grid = dataclasses.replace(
            grid, mean=jnp.asarray(rng.normal(0, 1, (NX, NY, K)), jnp.float32),
            valid=jnp.asarray(rng.random((NX, NY, K)) < 0.4))
        ref = jmp.MapPool.from_template(grid, N, 4 * N, L,
                                        with_color=with_color,
                                        shards=shards, dtype=dtype)
        tgrid = convert.mls_grid_from(as_dict(grid))
        pool = tmp.MapPool.from_template(tgrid, N, 4 * N, L,
                                         with_color=with_color,
                                         shards=shards, dtype=dtype)
        for f in graphs.leaves(pool):
            f.copy_(torch.ones_like(f) if f.dtype == torch.bool
                    else torch.full_like(f, 3))
        where = graphs.addresses(pool)
        assert pool.refill_(tgrid, shards) is pool
        assert graphs.addresses(pool) == where
        assert_pool_equal(pool, ref)
        with pytest.raises(ValueError, match="cannot refill"):
            pool.refill_(tmls.MLSGrid.create(NX + 1, NY, RES, (0.0, 0.0),
                                             K), shards)

    def test_refcounts_and_resample(self):
        jpool = random_pool(1, unique_heads=False)
        pool = port_pool(jpool)
        np.testing.assert_array_equal(pool.refcounts().numpy(),
                                      np.asarray(jpool.refcounts()))
        idx = np.random.default_rng(1).integers(0, N, N)
        np.testing.assert_array_equal(
            pool.resample(t(idx)).chain.numpy(),
            np.asarray(jpool.resample(jnp.asarray(idx)).chain))

    @pytest.mark.parametrize("b,p_want", [(4 * N, 0.5), (N + 6, 0.9)])
    def test_allocate(self, b, p_want):
        """The second case wants more blocks than are free."""
        jpool = random_pool(2, b=b, unique_heads=False)
        want = np.random.default_rng(2).random(N) < p_want
        ref_blk, ref_failed = jax.jit(jmp._allocate)(jpool, jnp.asarray(want))
        blk, failed = tmp._allocate(port_pool(jpool), t(want))
        np.testing.assert_array_equal(blk.numpy(), np.asarray(ref_blk))
        assert int(failed) == int(ref_failed)
        if b < 2 * N:
            assert int(ref_failed) > 0

    @pytest.mark.parametrize("b", [4 * N, N + 4])
    def test_ensure_unique_active(self, b):
        """Resampled chains share heads; a small pool runs out."""
        jpool = random_pool(3, b=b, with_color=b > N + 4)
        idx = np.sort(np.random.default_rng(3).integers(0, N, N))
        jpool = jpool.resample(jnp.asarray(idx))
        ref, ref_failed = jax.jit(jmp.ensure_unique_active)(jpool)
        got, failed = tmp.ensure_unique_active(port_pool(jpool))
        assert_pool_equal(got, ref)
        assert int(failed) == int(ref_failed)
        heads = np.asarray(ref.chain)[:, 0]
        if b > N + 4:
            assert len(set(heads.tolist())) == N
        else:
            assert int(ref_failed) > 0

    def test_rollover(self):
        jpool = random_pool(4)
        xy, *_ = particles_near_heads(jpool, 4, spread=1.2)
        ref, ref_failed = jax.jit(jmp.rollover, static_argnums=2)(
            jpool, jnp.asarray(xy), 0.75)
        got, failed = tmp.rollover(port_pool(jpool), t(xy), 0.75)
        assert_pool_equal(got, ref)
        assert int(failed) == int(ref_failed) == 0
        moved = np.asarray(ref.chain)[:, 0] != np.asarray(jpool.chain)[:, 0]
        assert 0 < moved.sum() < N


# ------------------------------------------------------------ chain lookup

def lookup_queries(jpool, seed, c=8):
    """[N, C, 3] world points around each particle's chain blocks, some
    outside every block, heights around the slot means."""
    rng = np.random.default_rng(seed)
    chain = np.asarray(jpool.chain)
    org = np.asarray(jpool.origin)[np.maximum(chain, 0)]         # [N, L, 2]
    pick = rng.integers(0, L, (N, c))
    base = np.take_along_axis(org, pick[..., None], axis=1)      # [N, C, 2]
    xy = base + rng.uniform(-0.3, SIZE + 0.3, (N, c, 2))
    z = 0.3 + rng.choice([0.0, 0.9, 2.5, -1.0], (N, c)) + rng.normal(
        0, 0.05, (N, c))
    return np.concatenate([xy, z[..., None]], -1).astype(np.float32)


@pytest.mark.parametrize("seed", [5, 6, 31, 65])
def test_chain_lookup_bitwise(seed):
    """Seeds past 8 also set the queries per particle (31 and 65: across a
    warp and two of the kernel's threads)."""
    jpool = random_pool(seed, unique_heads=False)
    pts = lookup_queries(jpool, seed, c=max(seed, 8))
    zw = 1.0
    lookup = jmp.chain_lookup(jpool, z_window=zw)
    ref = jax.jit(lambda p: jax.vmap(lookup)(jnp.arange(N), p))(pts)
    ref_k = pallas_chain.chain_lookup_blocks(
        jpool.mean, jpool.stdev, jpool.meta, jpool.chain, jpool.origin, RES,
        jnp.asarray(pts), k=K, z_window=zw, interpret=True)
    # on CPU tensors the lookup runs kernel K2's plain version
    got = tmp.make_chain_lookup(port_pool(jpool), zw)(
        torch.arange(N), tuple(t(pts[..., i]) for i in range(3)))
    found = np.asarray(ref[0])
    assert 0.1 < found.mean() < 0.9
    assert (np.asarray(jpool.chain) < 0).any()
    for r in (ref[:3], ref_k):
        for a, b_ in zip(got, r):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b_))


@pytest.mark.parametrize("seed", [8, 9])
def test_colour_chain_lookup_matches_jax(seed):
    """On a colour-carrying pool the lookup takes ``[N, C, 3]`` points and
    also returns the hit patch's colour, as JAX ``chain_lookup`` does
    (a colour pool never reaches the Pallas kernel there): found, mean and
    stdev bit for bit, colour equal (a gather), zeros where nothing is
    found."""
    jpool = random_pool(seed, with_color=True, unique_heads=False)
    pts = lookup_queries(jpool, seed)
    zw = 1.0
    lookup = jmp.make_chain_lookup(jpool, zw)
    assert not getattr(lookup, "batched", False)   # the XLA gather
    ref = jax.jit(lambda p: jax.vmap(lookup)(jnp.arange(N), p))(pts)
    port_lookup = tmp.make_chain_lookup(port_pool(jpool), zw)
    assert port_lookup.batched and not port_lookup.soa
    got = port_lookup(torch.arange(N), t(pts))
    found = np.asarray(ref[0])
    assert 0.1 < found.mean() < 0.9
    assert len(got) == 4 and got[3].shape == (N, 8, 3)
    for a, b_ in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b_))
    assert np.asarray(ref[3])[found].max() > 0.5
    assert not np.asarray(ref[3])[~found].any()
    # resampled particles look their own chains up
    idx = np.random.default_rng(seed).integers(0, N, N)
    ref_r = jax.jit(lambda p: jax.vmap(lookup)(jnp.asarray(idx), p))(pts)
    got_r = port_lookup(t(idx), t(pts))
    for a, b_ in zip(got_r, ref_r):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b_))


@pytest.mark.parametrize("seed", [8, 9])
def test_chain_lookup_slot_points_at_the_hit_patch(seed):
    """``with_slot`` (what the colour gather goes by): the index of the
    selected slot in the flattened fields, -1 where nothing is found."""
    from slam_eslam_tpu_torch.ops import chain_lookup as cl

    jpool = random_pool(seed, with_color=True, unique_heads=False)
    pool, pts = port_pool(jpool), t(lookup_queries(jpool, seed))
    args = (pool.mean, pool.stdev, pool.meta, pool.origin, pool.resolution,
            pool.chain, pts.unbind(-1))
    found, mean, stdev, slot = cl.chain_lookup(*args, k=K, z_window=1.0,
                                               with_slot=True)
    for a, b_ in zip((found, mean, stdev),
                     cl.chain_lookup(*args, k=K, z_window=1.0)):
        assert torch.equal(a, b_)
    assert slot.dtype == torch.int64 and 0.1 < float(found.float().mean()) < 0.9
    assert torch.equal(slot >= 0, found)
    assert torch.equal(pool.mean.reshape(-1)[slot[found]], mean[found])
    assert torch.equal(pool.stdev.reshape(-1)[slot[found]], stdev[found])
    assert (pool.meta.reshape(-1)[slot[found]] & 1).all()
    color = cl.chain_color(pool.color, slot)
    assert torch.equal(color[found],
                       pool.color.reshape(-1, 3)[slot[found]])
    assert not color[~found].any()


# ------------------------------------------------------------ merge

def merge_case(seed, p, spread, with_color=False):
    rng = np.random.default_rng(seed)
    jpool = random_pool(seed, with_color=with_color)
    xy, yaw, z, zs = particles_near_heads(jpool, seed)
    cxy = rng.uniform(-spread, spread, (p, 2)).astype(np.float32)
    cloud = jmls.PatchCloud.create(
        xy=jnp.asarray(cxy),
        z=jnp.asarray(rng.uniform(0.25, 0.35, p), jnp.float32),
        stdev=jnp.asarray(rng.uniform(0.01, 0.05, p), jnp.float32),
        valid=jnp.asarray(rng.random(p) < 0.9),
        color=jnp.asarray(rng.uniform(0, 1, (p, 3)), jnp.float32))
    return jpool, (xy, yaw, z, zs), cloud


def port_cloud(cloud):
    return tmls.PatchCloud(**{k: t(v) for k, v in as_dict(cloud).items()})


def port_merge(jpool, parts, cloud, update_idx):
    pool = port_pool(jpool)
    tmp.merge_cloud_all(pool, *(t(a) for a in parts), port_cloud(cloud),
                        update_idx)
    return pool


def jax_merge(jpool, parts, cloud, update_idx, **kw):
    fn = jax.jit(functools.partial(jmp.merge_cloud_all, **kw),
                 static_argnums=6)
    return fn(jpool, *(jnp.asarray(a) for a in parts), cloud, update_idx)


def cell_hits(jpool, parts, cloud):
    """Per slot of the pool: how many masked-in points hit its cell."""
    xy, yaw, _, _ = parts
    c, s = np.cos(yaw), np.sin(yaw)
    px, py = np.asarray(cloud.xy[:, 0]), np.asarray(cloud.xy[:, 1])
    wx = c[:, None] * px - s[:, None] * py + xy[:, 0:1]
    wy = s[:, None] * px + c[:, None] * py + xy[:, 1:2]
    heads = np.asarray(jpool.chain)[:, 0]
    org = np.asarray(jpool.origin)[heads]
    ix = np.floor((wx - org[:, 0:1]) * 4).astype(int)
    iy = np.floor((wy - org[:, 1:2]) * 4).astype(int)
    ok = ((ix >= 0) & (ix < NX) & (iy >= 0) & (iy < NY)
          & np.asarray(cloud.valid)[None])
    hits = np.zeros((jpool.b, NX, NY), int)
    np.add.at(hits, (np.broadcast_to(heads[:, None], ix.shape)[ok], ix[ok],
                     iy[ok]), 1)
    return np.repeat(hits, K, axis=2)


def assert_ulps(got, ref, ulps, err_msg):
    """Finite float32 arrays of one sign pattern within ``ulps`` units in
    the last place."""
    assert np.array_equal(np.signbit(got), np.signbit(ref)), err_msg
    gap = np.abs(got.view(np.int32).astype(np.int64)
                 - ref.view(np.int32).astype(np.int64))
    assert gap.max(initial=0) <= ulps, (err_msg, gap.max())


def assert_merge_matches(got, ref, hits, label):
    g, r = convert.to_numpy(got), as_dict(ref)
    np.testing.assert_array_equal(g["meta"], r["meta"], err_msg=label)
    one = hits == 1
    for name in ("mean", "stdev"):
        assert_ulps(g[name][one], r[name][one], 2,
                    f"{label} {name} (1 point)")
        np.testing.assert_allclose(g[name], r[name], rtol=2e-6, atol=0,
                                   err_msg=f"{label} {name}")
    # a gap-extended height is a difference of two heights: its error is
    # absolute, 2 ulps of the ~1 m means (single point), or of their
    # multi-point sums
    np.testing.assert_allclose(g["height"][one], r["height"][one], rtol=0,
                               atol=2.4e-7, err_msg=f"{label} height")
    np.testing.assert_allclose(g["height"], r["height"], rtol=0, atol=1e-6,
                               err_msg=f"{label} height")
    if r["color"] is not None:
        np.testing.assert_allclose(g["color"], r["color"], rtol=2e-6,
                                   atol=1e-7, err_msg=label)


def rule_counts(jpool, ref, hits):
    """Which envire rule wrote each hit cell, read off the merge: a new
    meta stamp (update_idx 7) at a slot that was valid and horizontal with
    the new horizontal bit set = fuse, valid and now vertical = gap
    extension, invalid = insert, valid with neither = eviction."""
    before, after = np.asarray(jpool.meta), np.asarray(ref.meta)
    written = (after >> 2 == 7) & (hits > 0)
    valid, horiz = before & 1, after >> 1 & 1
    mean_b, mean_a = np.asarray(jpool.mean), np.asarray(ref.mean)
    fused = written & (valid == 1) & (horiz == 1) & (
        np.abs(mean_b - mean_a) <= 0.1)
    gapped = written & (valid == 1) & (horiz == 0)
    inserted = written & (valid == 0)
    evicted = written & (valid == 1) & ~fused & ~gapped
    return fused.sum(), gapped.sum(), inserted.sum(), evicted.sum()


# point counts around a warp (32) and two (64), and a spread of 0: every
# point of a particle in one cell, a run longer than a warp
MERGE_CLOUDS = [(24, 1.4), (48, 0.6), (31, 1.4), (33, 1.4), (65, 0.6),
                (40, 0.0)]


@pytest.mark.parametrize("p,spread", MERGE_CLOUDS)
def test_merge_matches_jax_xla(p, spread):
    """Sparse (mostly one point per cell) and dense (multi-point) clouds
    over a half-full pool."""
    jpool, parts, cloud = merge_case(7 + p, p, spread)
    ref = jax_merge(jpool, parts, cloud, 7, kernel="xla")
    got = port_merge(jpool, parts, cloud, 7)
    hits = cell_hits(jpool, parts, cloud)
    assert (hits > 1).any()
    if spread == 0:
        assert hits.max() > 32
    else:
        assert (hits == 1).any()
    assert_merge_matches(got, ref, hits, "xla")
    if spread:
        fused, gapped, inserted, evicted = rule_counts(jpool, ref, hits)
        assert min(fused, gapped, inserted, evicted) > 0, (
            fused, gapped, inserted, evicted)


@pytest.mark.parametrize("group", [1, 4])
def test_merge_matches_pallas(group):
    """``merge_blocks`` (group 1) and ``merge_blocks_grouped`` (group 4),
    interpret mode."""
    jpool, parts, cloud = merge_case(11, 40, 0.9)
    ref = jax_merge(jpool, parts, cloud, 7, kernel="pallas", group=group)
    got = port_merge(jpool, parts, cloud, 7)
    assert_merge_matches(got, ref, cell_hits(jpool, parts, cloud),
                         f"pallas group={group}")


def test_merge_colour_pool():
    jpool, parts, cloud = merge_case(13, 40, 0.9, with_color=True)
    ref = jax_merge(jpool, parts, cloud, 7, kernel="xla")
    got = port_merge(jpool, parts, cloud, 7)
    assert_merge_matches(got, ref, cell_hits(jpool, parts, cloud), "colour")


def test_merge_operands_plain_vs_pallas_body():
    """``block_merge_reference`` on the kernel operands against
    ``pallas_merge.merge_blocks`` called directly (interpret mode)."""
    from slam_eslam_tpu_torch.ops import block_merge as bm

    jpool, parts, cloud = merge_case(17, 40, 0.9)
    rng = np.random.default_rng(17)
    heads = np.asarray(jpool.chain)[:, 0].astype(np.int32)
    lx = rng.integers(-1, NX + 1, (N, 40)).astype(np.int32)
    ly = rng.integers(0, NY, (N, 40)).astype(np.int32)
    w = rng.uniform(10, 1000, (N, 40)).astype(np.float32)
    wz = (w * rng.uniform(0.2, 0.4, (N, 40))).astype(np.float32)
    ref = jax.jit(functools.partial(
        pallas_merge.merge_blocks, k=K, interpret=True))(
        jpool.mean, jpool.stdev, jpool.height, jpool.meta, heads, lx, ly, w,
        wz, 3)
    pool = port_pool(jpool)
    bm.block_merge_reference(pool.mean, pool.stdev, pool.height, pool.meta,
                             None, t(heads), t(lx), t(ly), t(w), t(wz), 3,
                             k=K)
    np.testing.assert_array_equal(pool.meta.numpy(), np.asarray(ref[3]))
    for got, r in zip((pool.mean, pool.stdev, pool.height), ref[:3]):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), rtol=1e-6)


# ------------------------------------------------------------ negative, match

def test_apply_negative_cloud_all():
    jpool, parts, _ = merge_case(19, 8, 1.0)
    xy, yaw, z, _ = parts
    rng = np.random.default_rng(19)
    pts = np.concatenate([rng.uniform(-1.2, 1.2, (30, 2)),
                          rng.uniform(0.2, 0.4, (30, 1))], -1).astype(
        np.float32)
    mask = rng.random(30) < 0.8
    ref = jax.jit(jmp.apply_negative_cloud_all)(
        jpool, *(jnp.asarray(a) for a in (xy, yaw, z, pts, mask)))
    got = tmp.apply_negative_cloud_all(port_pool(jpool), t(xy), t(yaw), t(z),
                                       t(pts), t(mask))
    assert_pool_equal(got, ref)
    cleared = (np.asarray(jpool.meta) & 1) & ~(np.asarray(ref.meta) & 1)
    assert cleared.sum() > 0


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_match_cloud_all(kernel):
    jpool, parts, cloud = merge_case(23, 60, 1.2)
    ref = jax.jit(functools.partial(jmp.match_cloud_all, kernel=kernel))(
        jpool, *(jnp.asarray(a) for a in parts), cloud)
    got = tmp.match_cloud_all(port_pool(jpool), *(t(a) for a in parts),
                              port_cloud(cloud))
    assert np.asarray(ref).max() > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-7)


# ------------------------------------------------------------ write side

def test_dedup_fuse_rows_and_fuse_slot_rows():
    rng = np.random.default_rng(29)
    n, p = 6, 20
    lin = rng.integers(0, 8, (n, p)).astype(np.int32)
    z = rng.uniform(0, 1, (n, p)).astype(np.float32)
    var = rng.uniform(1e-4, 1e-2, (n, p)).astype(np.float32)
    mask = rng.random((n, p)) < 0.8
    color = rng.uniform(0, 1, (n, p, 3)).astype(np.float32)
    ref = jax.jit(functools.partial(jmls._dedup_fuse_rows, sentinel=100))(
        lin, z, var, mask, color=color)
    got = tmls._dedup_fuse_rows(t(lin), t(z), t(var), t(mask), 100,
                                color=t(color))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    keep = np.asarray(ref[3])
    for a, b_ in zip((got[1], got[2], got[4]), (ref[1], ref[2], ref[4])):
        np.testing.assert_allclose(a.numpy()[keep], np.asarray(b_)[keep],
                                   rtol=1e-6)

    m = 40
    means = rng.uniform(0, 2, (m, K)).astype(np.float32)
    stdevs = rng.uniform(0.01, 0.2, (m, K)).astype(np.float32)
    heights = rng.uniform(0, 0.3, (m, K)).astype(np.float32)
    valids = rng.random((m, K)) < 0.6
    horiz = rng.random((m, K)) < 0.7
    uidx = rng.integers(0, 5, (m, K)).astype(np.int32)
    zq = rng.uniform(0, 2, m).astype(np.float32)
    vq = rng.uniform(1e-4, 1e-2, m).astype(np.float32)
    keepq = rng.random(m) < 0.9
    args = (means, stdevs, heights, valids, horiz, uidx, zq, vq, keepq)
    ref = jax.jit(jmls.fuse_slot_rows, static_argnums=9)(*args, 9)
    got = tmls.fuse_slot_rows(*(t(a) for a in args), 9)
    for a, b_ in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b_))


# ---- the JAX package's per-particle lookup and pool views --------------

def _lookup_scenarios():
    """The nine uses of JAX ``map_pool.chain_lookup`` in
    ``tests/test_map_pool.py``: the pool each builds and the queries
    ``(particle, points [C, 3], z_window)`` it makes."""
    from test_map_pool import make_pool, write_cell

    def unique_copies():
        pool = write_cell(make_pool(), 0, 0.0, 0.0, 7.0)
        pool, _ = jmp.ensure_unique_active(pool.resample(
            jnp.array([0, 0, 0, 3])))
        return pool, [(i, [[0.0, 0.0, 7.0]], 3.0) for i in range(3)]

    def rolled(z_window, probe):
        pool = write_cell(make_pool(), 1, 0.0, 0.0, 2.5)
        xy = jnp.array([[0.0, 0.0], [8.0, 0.0], [0.0, 0.0], [0.0, 0.0]])
        pool, _ = jmp.rollover(pool, xy, threshold=3.0)
        if probe:
            head = int(pool.chain[1, 0])
            pool = write_cell(pool, head, 4.0, 0.0, 9.0)
            pool = write_cell(pool, 1, 4.0, 0.0, 1.0)
            return pool, [(1, [[4.0, 0.0, 5.0]], z_window)]
        return pool, [(1, [[0.0, 0.0, 2.5]], z_window)]

    def merged(dtype=None, with_color=True):
        xy = jax.random.uniform(jax.random.PRNGKey(3), (32, 2), minval=-2.0,
                                maxval=2.0)
        cloud = jmls.PatchCloud.create(
            xy=xy, z=jnp.full((32,), 1.0), stdev=jnp.full((32,), 0.1),
            valid=jnp.ones((32,), bool))
        if dtype is None:
            pool = make_pool(with_color=with_color)
        else:
            pool = jmp.MapPool.from_template(
                jmls.MLSGrid.create(20, 20, 0.5, (-5.0, -5.0), k=2), 4, 10,
                3, with_color=False, dtype=dtype)
        pool = jmp.merge_cloud_all(
            pool, jnp.zeros((4, 2)), jnp.zeros((4,)),
            jnp.array([0.0, 10.0, 0.0, 0.0]), jnp.zeros((4,)), cloud, 5,
            kernel="xla")
        pt = np.asarray(cloud.xy[0])
        return pool, [(0, [[pt[0], pt[1], 1.0]], 3.0),
                      (1, [[pt[0], pt[1], 11.0]], 3.0),
                      (0, [[pt[0], pt[1], 11.0]], 3.0)]

    def negative(pts, mask, z=0.0):
        pool = write_cell(make_pool(n=1, with_color=False), 0, 1.0, 1.0, 2.0)
        out = jmp.apply_negative_cloud_all(
            pool, jnp.zeros((1, 2)), jnp.zeros(1), jnp.full((1,), z),
            jnp.array(pts), jnp.array(mask))
        return out, [(0, [[1.0, 1.0, 2.0]], 3.0)]

    def two_particles():
        pool = make_pool(n=2, with_color=False)
        pool = write_cell(write_cell(pool, 0, 1.0, 1.0, 2.0), 1, -2.0, 0.0,
                          0.5)
        out = jmp.apply_negative_cloud_all(
            pool, jnp.array([[0.0, 0.0], [-3.0, 0.0]]), jnp.zeros(2),
            jnp.array([0.0, 0.5]), jnp.array([[1.0, 1.0, 2.0],
                                              [1.0, 0.0, 0.0]]),
            jnp.ones(2, bool))
        return out, [(0, [[1.0, 1.0, 2.0]], 3.0),
                     (1, [[-2.0, 0.0, 0.5]], 3.0)]

    def tail_block():
        pool = write_cell(make_pool(n=1, b=10, with_color=False), 5, 1.0,
                          1.0, 2.0)
        pool = dataclasses.replace(pool, chain=jnp.array([[0, 5, -1]],
                                                         jnp.int32))
        out = jmp.apply_negative_cloud_all(
            pool, jnp.zeros((1, 2)), jnp.zeros(1), jnp.zeros(1),
            jnp.array([[1.0, 1.0, 2.0]]), jnp.ones(1, bool))
        return out, [(0, [[1.0, 1.0, 2.0]], 3.0)]

    return {
        "ensure_unique_copies": unique_copies,
        "rollover_tail": lambda: rolled(3.0, False),
        "chain_head_priority": lambda: rolled(20.0, True),
        "merge_isolated": merged,
        "negative_two_particles": two_particles,
        "negative_outside_margin": lambda: negative([[1.0, 1.0, 1.5]], [1]),
        "negative_masked": lambda: negative([[1.0, 1.0, 2.0]], [0]),
        "negative_tail_survives": tail_block,
        "bf16_pool": lambda: merged(jnp.bfloat16),
    }


@pytest.mark.parametrize("scenario", sorted(_lookup_scenarios()))
def test_per_particle_chain_lookup_matches_jax(scenario):
    """``map_pool.chain_lookup(pool, z_window)(particle, points)``: the JAX
    package's per-particle callback, on each pool its tests build, equal
    to JAX's ``(found, mean, stdev, color)`` (colour zeros without a
    colour field), one particle at a time and batched."""
    jpool, queries = _lookup_scenarios()[scenario]()
    tpool = port_pool(jpool)
    for particle, pts, zw in queries:
        ref = jmp.chain_lookup(jpool, z_window=zw)(jnp.asarray(particle),
                                                   jnp.asarray(pts))
        got = tmp.chain_lookup(tpool, z_window=zw)(particle, pts)
        batched = tmp.chain_lookup(tpool, z_window=zw)(
            torch.tensor([particle]), torch.tensor([pts]))
        for g, b, r in zip(got, batched, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
            np.testing.assert_array_equal(b[0].numpy(), np.asarray(r))


def test_slot_count_and_field_grid_match_jax():
    """``MapPool.s`` and ``MapPool.field_grid`` (JAX ``map_pool.py:127,
    142``), colour included."""
    jpool = random_pool(11, with_color=True)
    tpool = port_pool(jpool)
    assert tpool.s == jpool.s == NX * NY * K
    for name in ("mean", "stdev", "meta", "color"):
        got = tpool.field_grid(name)
        ref = np.asarray(jpool.field_grid(name))
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("with_color", [False, True], ids=["plain", "colour"])
def test_merge_update_idx_as_a_device_scalar(with_color):
    """``merge_cloud_all`` with ``update_idx`` as a 0-d int32 tensor (what
    a CUDA graph replays: K3 reads it from the device) gives the pool the
    same Python int gives, bit for bit, and stamps that index into the
    written slots' ``meta``."""
    jpool, parts, cloud = merge_case(17, 40, 0.9, with_color=with_color)
    by_int = port_merge(jpool, parts, cloud, 9)
    by_tensor = port_merge(jpool, parts, cloud,
                           torch.tensor(9, dtype=torch.int32))
    for name in by_int.data_fields() + ("origin", "chain", "allocated"):
        a, b = getattr(by_int, name), getattr(by_tensor, name)
        assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a, b.view(torch.int32)
                           if b.is_floating_point() else b), name
    written = by_tensor.meta != port_pool(jpool).meta
    assert written.any()
    assert ((by_tensor.meta[written] >> 2) == 9).all()
