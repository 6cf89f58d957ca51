"""A map pool stored in bfloat16: the port against the JAX package.

``slam_eslam_tpu.mapping.map_pool`` with ``dtype=jnp.bfloat16`` (the
storage of its 100k-particle SLAM configuration) upcasts on every read,
computes in float32 and rounds once on store; lookups return float32.
The port must do the same on a pool carried across by
``convert.map_pool_from`` (bit for bit):

* ``from_template(dtype=...)`` and the bookkeeping (``resample``,
  ``ensure_unique_active``, ``rollover``) equal, bit for bit;
* the chain lookup bitwise equal to JAX ``chain_lookup`` and to the Pallas
  kernel in interpret mode, float32 out;
* ``merge_cloud_all`` against JAX ``kernel="xla"`` and ``kernel="pallas"``
  (interpret mode): ``meta`` equal, the float fields within one bfloat16
  ulp.  The float32 arithmetic of the two packages differs by up to 2
  float32 ulps (XLA contracts multiply-adds, ``tests/
  test_torch_map_pool.py``), which can move the one rounding to bfloat16
  across a tie, never further;
* ``apply_negative_cloud_all`` and ``match_cloud_all`` as on a float32
  pool (exact, rtol 1e-5).

Every JAX function runs under ``jax.jit``, as in
``tests/test_torch_map_pool.py``, whose seeded pools are reused.
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
from slam_eslam_tpu.ops import pallas_chain
from slam_eslam_tpu_torch import convert
from slam_eslam_tpu_torch.mapping import map_pool as tmp
from test_torch_map_pool import (K, L, N, NX, NY, RES, as_dict, cell_hits,
                                 lookup_queries, merge_case,
                                 particles_near_heads, port_cloud,
                                 random_pool, t)

torch.set_num_threads(2)

FLOAT_FIELDS = ("mean", "stdev", "height")


def bf16_pool(jpool):
    """The pool with its float fields rounded to bfloat16."""
    return dataclasses.replace(jpool, **{
        f: getattr(jpool, f).astype(jnp.bfloat16) for f in FLOAT_FIELDS})


def bits(a):
    """bfloat16 bit patterns (int64) of a float32 array that holds
    bfloat16 values."""
    a = np.ascontiguousarray(a, np.float32)
    assert not (a.view(np.uint32) & 0xFFFF).any(), "not bfloat16 values"
    return (a.view(np.uint32) >> 16).astype(np.int64)


def f32(a):
    return np.asarray(a, np.float32)


def assert_pool_bitwise(got, ref):
    g = convert.to_numpy(got)
    for name in FLOAT_FIELDS:
        assert getattr(got, name).dtype == torch.bfloat16, name
        assert getattr(ref, name).dtype == jnp.bfloat16, name
        np.testing.assert_array_equal(bits(g[name]),
                                      bits(f32(getattr(ref, name))),
                                      err_msg=name)
    for name in ("meta", "origin", "allocated", "chain"):
        np.testing.assert_array_equal(g[name], np.asarray(getattr(ref, name)),
                                      err_msg=name)


def assert_within_one_bf16_ulp(got, ref, label):
    """Equal, or neighbouring bfloat16 values of one sign."""
    gb, rb = bits(got), bits(ref)
    differ = gb != rb
    assert np.array_equal(np.signbit(got)[differ], np.signbit(ref)[differ]), (
        label)
    gap = np.abs(gb - rb)
    assert gap.max(initial=0) <= 1, (label, int(gap.max()))
    return int(differ.sum())


def port_pool(jpool):
    return convert.map_pool_from(as_dict(jpool))


def test_convert_carries_bf16_bit_for_bit():
    jpool = bf16_pool(random_pool(1))
    pool = port_pool(jpool)
    assert_pool_bitwise(pool, jpool)
    # and as explicit uint16 bit patterns
    raw = np.asarray(jpool.mean).view(np.uint16)
    again = convert.bf16_from_bits(raw)
    assert again.dtype == torch.bfloat16
    assert torch.equal(again, pool.mean)
    # the values are really rounded: not all float32 means survive
    assert (f32(jpool.mean) != np.asarray(random_pool(1).mean)).mean() > 0.5


@pytest.mark.parametrize("dtype", ["bfloat16", torch.bfloat16])
def test_from_template_bf16(dtype):
    rng = np.random.default_rng(0)
    grid = jmls.MLSGrid.create(NX, NY, RES, (-1.5, 2.0), k=K)
    grid = dataclasses.replace(
        grid, mean=jnp.asarray(rng.normal(0, 1, (NX, NY, K)), jnp.float32),
        stdev=jnp.asarray(rng.uniform(0.01, 0.2, (NX, NY, K)), jnp.float32),
        valid=jnp.asarray(rng.random((NX, NY, K)) < 0.4))
    ref = jmp.MapPool.from_template(grid, N, 3 * N, L, with_color=False,
                                    dtype=jnp.bfloat16)
    got = tmp.MapPool.from_template(convert.mls_grid_from(as_dict(grid)),
                                    N, 3 * N, L, with_color=False,
                                    dtype=dtype)
    assert_pool_bitwise(got, ref)


def test_bookkeeping_on_bf16_pool():
    """``resample`` -> ``ensure_unique_active`` -> ``rollover``: block
    copies and fills keep the storage type and every bit."""
    jpool = bf16_pool(random_pool(3))
    idx = np.sort(np.random.default_rng(3).integers(0, N, N))
    jres = jpool.resample(jnp.asarray(idx))
    pres = port_pool(jpool).resample(t(idx))
    assert_pool_bitwise(pres, jres)

    ref, ref_failed = jax.jit(jmp.ensure_unique_active)(jres)
    got, failed = tmp.ensure_unique_active(pres)
    assert_pool_bitwise(got, ref)
    assert int(failed) == int(ref_failed) == 0
    assert len(set(np.asarray(ref.chain)[:, 0].tolist())) == N

    xy, *_ = particles_near_heads(ref, 4, spread=1.2)
    ref2, ref_failed = jax.jit(jmp.rollover, static_argnums=2)(
        ref, jnp.asarray(xy), 0.75)
    got2, failed = tmp.rollover(got, t(xy), 0.75)
    assert_pool_bitwise(got2, ref2)
    assert int(failed) == int(ref_failed) == 0
    moved = np.asarray(ref2.chain)[:, 0] != np.asarray(ref.chain)[:, 0]
    assert 0 < moved.sum() < N


@pytest.mark.parametrize("seed", [5, 6])
def test_chain_lookup_bf16_bitwise(seed):
    jpool = bf16_pool(random_pool(seed, unique_heads=False))
    pts = lookup_queries(jpool, seed)
    zw = 1.0
    lookup = jmp.chain_lookup(jpool, z_window=zw)
    ref = jax.jit(lambda p: jax.vmap(lookup)(jnp.arange(N), p))(pts)
    ref_k = pallas_chain.chain_lookup_blocks(
        jpool.mean, jpool.stdev, jpool.meta, jpool.chain, jpool.origin, RES,
        jnp.asarray(pts), k=K, z_window=zw, interpret=True)
    got = tmp.make_chain_lookup(port_pool(jpool), zw)(
        torch.arange(N), tuple(t(pts[..., i]) for i in range(3)))
    assert 0.1 < np.asarray(ref[0]).mean() < 0.9
    assert got[1].dtype == got[2].dtype == torch.float32
    assert ref[1].dtype == jnp.float32
    for r in (ref[:3], ref_k):
        for a, b_ in zip(got, r):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b_))
    # the means that come back are bfloat16 values
    bits(got[1].numpy())


def merge_both(seed, p, spread, **kw):
    jpool, parts, cloud = merge_case(seed, p, spread)
    jpool = bf16_pool(jpool)
    fn = jax.jit(functools.partial(jmp.merge_cloud_all, **kw),
                 static_argnums=6)
    ref = fn(jpool, *(jnp.asarray(a) for a in parts), cloud, 7)
    got = port_pool(jpool)
    tmp.merge_cloud_all(got, *(t(a) for a in parts), port_cloud(cloud), 7)
    return jpool, ref, got, cell_hits(jpool, parts, cloud)


def assert_bf16_merge_matches(jpool, ref, got, hits, label):
    g = convert.to_numpy(got)
    np.testing.assert_array_equal(g["meta"], np.asarray(ref.meta),
                                  err_msg=label)
    written = np.asarray(ref.meta) != np.asarray(jpool.meta)
    assert written.sum() > N and (hits[written] > 0).all()
    moved = 0
    for name in FLOAT_FIELDS:
        assert getattr(got, name).dtype == torch.bfloat16
        assert getattr(ref, name).dtype == jnp.bfloat16
        rf = f32(getattr(ref, name))
        moved += assert_within_one_bf16_ulp(g[name], rf, f"{label} {name}")
        # slots that the merge did not write keep every bit
        before = f32(getattr(jpool, name))
        np.testing.assert_array_equal(g[name][~written], before[~written],
                                      err_msg=f"{label} {name} untouched")
    # a rounding may move, but rarely: the arithmetic is the same
    assert moved <= 0.02 * 3 * written.sum(), (label, moved)


@pytest.mark.parametrize("p,spread", [(24, 1.4), (48, 0.6)])
def test_merge_bf16_matches_jax_xla(p, spread):
    jpool, ref, got, hits = merge_both(7 + p, p, spread, kernel="xla")
    assert (hits == 1).any() and (hits > 1).any()
    assert_bf16_merge_matches(jpool, ref, got, hits, "xla")


def test_merge_bf16_matches_pallas():
    """The Pallas merge kernel in interpret mode, on one case."""
    jpool, ref, got, hits = merge_both(11, 40, 0.9, kernel="pallas")
    assert_bf16_merge_matches(jpool, ref, got, hits, "pallas")


def test_negative_and_match_on_bf16_pool():
    jpool, parts, cloud = merge_case(19, 60, 1.2)
    jpool = bf16_pool(jpool)
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
    assert_pool_bitwise(got, ref)
    assert ((np.asarray(jpool.meta) & 1) & ~(np.asarray(ref.meta) & 1)).any()

    score = jax.jit(functools.partial(jmp.match_cloud_all, kernel="xla"))(
        jpool, *(jnp.asarray(a) for a in parts), cloud)
    got_s = tmp.match_cloud_all(port_pool(jpool), *(t(a) for a in parts),
                                port_cloud(cloud))
    assert np.asarray(score).max() > 0
    np.testing.assert_allclose(got_s.numpy(), np.asarray(score), rtol=1e-5,
                               atol=1e-7)
