"""The merge on a packed block image (probe kernel P4) against the JAX
package.

``tools/probe_merge_overhead.py`` builds its ``merge_packed`` variant
inside ``main``; the same ``pallas_call`` (``_merge_packed_kernel`` over
``pallas_merge._merge_body``, one ``[B, 4*nx, ny*k]`` float32 operand
aliased in and out) is rebuilt here and run in interpret mode.  On CPU
tensors ``block_merge_packed`` runs its plain version, which is what the
CUDA kernel is held against on the card (``tests/test_torch_cuda.py``).

Tolerances: the meta rows must be equal as int32 words; mean and stdev
within 2 ulps on cells one point hits (XLA's CPU compiler contracts
``a*b + c*d`` into fused multiply-adds, the port rounds every operation)
and rtol 2e-6 where several points hit (float32 sums in another order);
heights within 2.4e-7 m and 1e-6 m (a difference of two heights).  The
same limits hold against JAX ``merge_blocks`` on the unpacked fields.
Against the port's own merge on the unpacked fields the packed merge must
be equal bit for bit.  Pools and operands are those of
``tests/test_torch_map_pool.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from slam_eslam_tpu.ops import pallas_merge
from slam_eslam_tpu_torch import convert
from slam_eslam_tpu_torch.mapping import map_pool as tmp
from slam_eslam_tpu_torch.ops import block_merge as bm
from test_torch_map_pool import (K, N, NX, NY, as_dict, assert_ulps,
                                 cell_hits, merge_case, port_cloud, port_pool,
                                 t)

torch.set_num_threads(2)

NYK = NY * K
UPDATE_IDX = 3


def jax_merge_packed(packed, blk, lx, ly, w, wz):
    """``merge_packed`` of ``tools/probe_merge_overhead.py:212-254``."""
    n, p = lx.shape
    b = packed.shape[0]

    def kernel(blk_ref, par_ref, lx_ref, lyt_ref, w_ref, wz_ref, pi, po):
        del blk_ref
        img = pi[0]
        mean = jax.lax.slice(img, (0, 0), (NX, NYK))
        stdev = jax.lax.slice(img, (NX, 0), (2 * NX, NYK))
        height = jax.lax.slice(img, (2 * NX, 0), (3 * NX, NYK))
        meta = jax.lax.bitcast_convert_type(
            jax.lax.slice(img, (3 * NX, 0), (4 * NX, NYK)), jnp.int32)
        nm, ns, nh, ng = pallas_merge._merge_body(
            par_ref[0], lx_ref[0], lyt_ref[0], w_ref[0], wz_ref[0],
            mean, stdev, height, meta, nx=NX, ny=NY, k=K,
            patch_thickness=0.1, gap_size=1.5)
        po[0] = jnp.concatenate(
            [nm, ns, nh, jax.lax.bitcast_convert_type(ng, jnp.float32)],
            axis=0)

    row = lambda shape: pl.BlockSpec(shape, lambda i, blk, par: (i, 0, 0),
                                     memory_space=pltpu.VMEM)
    pk_spec = pl.BlockSpec((1, 4 * NX, NYK),
                           lambda i, blk, par: (blk[i], 0, 0),
                           memory_space=pltpu.VMEM)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2, grid=(n,),
        in_specs=[row((1, 1, p)), row((1, p, 1)), row((1, 1, p)),
                  row((1, 1, p)), pk_spec],
        out_specs=[pk_spec])
    return pl.pallas_call(
        kernel, grid_spec=grid_spec,
        out_shape=[jax.ShapeDtypeStruct((b, 4 * NX, NYK), jnp.float32)],
        input_output_aliases={6: 0}, interpret=True,
    )(blk, jnp.asarray([UPDATE_IDX], jnp.int32), lx[:, None, :],
      ly[:, :, None], w[:, None, :], wz[:, None, :], packed)[0]


def jax_packed(jpool):
    return jnp.concatenate(
        [jpool.mean, jpool.stdev, jpool.height,
         jax.lax.bitcast_convert_type(jpool.meta, jnp.float32)], axis=1)


def case(seed, p, spread):
    """A seeded pool, the merge operands of a cloud under seeded particle
    poses (as the production merge builds them) and the per-slot count of
    points that hit each cell."""
    jpool, parts, cloud = merge_case(seed, p, spread)
    pool = port_pool(jpool)
    ops = tmp.merge_operands(pool, *(t(a) for a in parts), port_cloud(cloud))
    return jpool, pool, ops, cell_hits(jpool, parts, cloud)


def fields_of(packed_np):
    """``(mean, stdev, height, meta int32)`` of a packed numpy image."""
    words = np.ascontiguousarray(packed_np).view(np.int32)
    part = lambda i: np.ascontiguousarray(words[:, i * NX:(i + 1) * NX])
    return (part(0).view(np.float32), part(1).view(np.float32),
            part(2).view(np.float32), part(3))


def assert_fields_match(got, ref, hits, label):
    np.testing.assert_array_equal(got[3], ref[3], err_msg=f"{label} meta")
    one = hits == 1
    for name, g, r in zip(("mean", "stdev"), got, ref):
        assert_ulps(g[one], r[one], 2, f"{label} {name} (1 point)")
        np.testing.assert_allclose(g, r, rtol=2e-6, atol=0,
                                   err_msg=f"{label} {name}")
    np.testing.assert_allclose(got[2][one], ref[2][one], rtol=0, atol=2.4e-7,
                               err_msg=f"{label} height (1 point)")
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=1e-6,
                               err_msg=f"{label} height")


def test_pack_fields_round_trip_keeps_meta_bits():
    """Meta words that are NaN or denormal bit patterns as float32 survive
    packing, the converter and unpacking."""
    jpool, pool, _, _ = case(3, 8, 1.0)
    meta = pool.meta.clone()
    meta.view(-1)[:4] = torch.tensor([0x7FC00001, 0x7F800001, 0x00000003,
                                      -4], dtype=torch.int64).to(torch.int32)
    packed = bm.pack_fields(pool.mean, pool.stdev, pool.height, meta)
    assert packed.shape == (pool.b, 4 * NX, NYK)
    assert packed.dtype == torch.float32
    for got, ref in zip(bm.packed_fields(packed, NX),
                        (pool.mean, pool.stdev, pool.height, meta)):
        assert torch.equal(got, ref)
    # the JAX package's packing and the converter give the same image
    ref = np.asarray(jax_packed(jpool))
    np.testing.assert_array_equal(
        convert.packed_image_from(ref).view(torch.int32).numpy(),
        ref.view(np.int32))
    np.testing.assert_array_equal(
        convert.packed_image_from_fields(as_dict(jpool)).view(
            torch.int32).numpy(), ref.view(np.int32))
    with pytest.raises(ValueError, match="float32"):
        convert.packed_image_from(ref.astype(np.float64))


@pytest.mark.parametrize("p,spread", [(16, 1.4), (40, 0.6), (31, 1.4),
                                      (33, 1.4), (65, 0.6), (40, 0.0)])
def test_merge_packed_matches_pallas_and_merge_blocks(p, spread):
    """Point counts around a warp and two, and (spread 0) every point of a
    particle in one cell: a run longer than a warp."""
    jpool, pool, (blk, lx, ly, w, wz), hits = case(31 + p, p, spread)
    assert (hits > 1).any()
    assert hits.max() > 32 if spread == 0 else (hits == 1).any()
    j = lambda a: jnp.asarray(a.numpy())
    ref_packed = fields_of(np.asarray(jax_merge_packed(
        jax_packed(jpool), j(blk), j(lx), j(ly), j(w), j(wz))))
    ref_blocks = [np.asarray(a) for a in jax.jit(functools.partial(
        pallas_merge.merge_blocks, k=K, interpret=True))(
        jpool.mean, jpool.stdev, jpool.height, jpool.meta, j(blk), j(lx),
        j(ly), j(w), j(wz), UPDATE_IDX)]

    packed = bm.pack_fields(pool.mean, pool.stdev, pool.height, pool.meta)
    before = bm.block_merge_packed.launches
    bm.block_merge_packed(packed, blk, lx, ly, w, wz, UPDATE_IDX, nx=NX, k=K)
    assert bm.block_merge_packed.launches == before  # no kernel on the CPU
    got = fields_of(packed.numpy())
    # one cell a particle where every point lies in one
    assert (got[3] != np.asarray(jpool.meta)).sum() > (N if spread else N // 2)
    assert_fields_match(got, ref_packed, hits, "pallas merge_packed")
    assert_fields_match(got, ref_blocks, hits, "merge_blocks")

    # the port's merge on the unpacked fields: equal bit for bit
    bm.block_merge(pool.mean, pool.stdev, pool.height, pool.meta, None, blk,
                   lx, ly, w, wz, UPDATE_IDX, k=K)
    for g, r in zip(got, (pool.mean, pool.stdev, pool.height, pool.meta)):
        np.testing.assert_array_equal(g.view(np.int32),
                                      r.numpy().view(np.int32))


def test_merge_packed_leaves_other_blocks_and_rejects_bad_images():
    _, pool, (blk, lx, ly, w, wz), _ = case(5, 12, 1.0)
    packed = bm.pack_fields(pool.mean, pool.stdev, pool.height, pool.meta)
    before = packed.clone()
    bm.block_merge_packed(packed, blk, lx, ly, w, wz, 1, nx=NX, k=K)
    idle = torch.ones(pool.b, dtype=torch.bool)
    idle[blk.long()] = False
    assert idle.any()
    assert torch.equal(packed.view(torch.int32)[idle],
                       before.view(torch.int32)[idle])
    assert not torch.equal(packed.view(torch.int32), before.view(torch.int32))
    args = (blk, lx, ly, w, wz, 1)
    with pytest.raises(TypeError, match="float32"):
        bm.block_merge_packed(packed.to(torch.bfloat16), *args, nx=NX, k=K)
    with pytest.raises(ValueError, match="shape"):
        bm.block_merge_packed(packed, *args, nx=NX + 1, k=K)
    with pytest.raises(ValueError, match="multiple"):
        bm.block_merge_packed(packed[:, :, :NYK - 1], *args, nx=NX, k=K)
    with pytest.raises(TypeError, match="float32"):
        bm.pack_fields(pool.mean.to(torch.bfloat16), pool.stdev, pool.height,
                       pool.meta)


def test_merge_packed_update_idx_as_a_device_scalar():
    """``block_merge_packed`` and ``block_merge`` with ``update_idx`` a 0-d
    int32 tensor equal the same Python int bit for bit."""
    _, pool, (blk, lx, ly, w, wz), _ = case(9, 24, 1.0)
    images = [bm.pack_fields(pool.mean, pool.stdev, pool.height, pool.meta)
              for _ in range(2)]
    bm.block_merge_packed(images[0], blk, lx, ly, w, wz, UPDATE_IDX, nx=NX,
                          k=K)
    bm.block_merge_packed(images[1], blk, lx, ly, w, wz,
                          torch.tensor(UPDATE_IDX, dtype=torch.int32),
                          nx=NX, k=K)
    assert torch.equal(images[0].view(torch.int32),
                       images[1].view(torch.int32))
    fields = [[f.clone() for f in (pool.mean, pool.stdev, pool.height,
                                   pool.meta)] for _ in range(2)]
    bm.block_merge(*fields[0], None, blk, lx, ly, w, wz, UPDATE_IDX, k=K)
    bm.block_merge(*fields[1], None, blk, lx, ly, w, wz,
                   torch.tensor(UPDATE_IDX, dtype=torch.int32), k=K)
    for a, b in zip(*fields):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(fields[0][3].view(torch.int32),
                       bm.packed_fields(images[0], NX)[3])
