"""The map pool's masked row copy, ``ops.row_copy``, on the CPU.

``row_copy`` on CPU tensors runs ``row_copy_reference``, the plain
version that the CUDA kernel (``csrc/row_copy.cu``) is held against bit
for bit on the card (``tests/test_torch_cuda.py``).  Here:

* the plain version against a loop over the rows, in the copy and the
  fill form, float32, bfloat16 and int32 fields, with masks that select
  none, one, some and every row, and a source shared by several rows; a
  masked row outside the pool raises;
* copy-on-write and rollover (``ensure_unique_active``, ``rollover``) on
  pools with and without colour, float32 and bfloat16, equal bit for bit
  to the formulation that wrote every particle's row (a row whose mask
  was off copying its block onto itself), kept here as the oracle.
"""

import dataclasses

import pytest
import torch

from slam_eslam_tpu_torch.mapping import map_pool as mp
from slam_eslam_tpu_torch.models import sim
from slam_eslam_tpu_torch.ops import row_copy as rc
from torch_stand_in import assert_bitwise

B, N = 24, 10
MASKS = {"none": [], "one": [3], "some": [0, 2, 3, 7], "all": list(range(N))}


def fields_of(dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    if dtype == torch.int32:
        a = torch.randint(-2 ** 30, 2 ** 30, (B, 3, 10), generator=gen,
                          dtype=torch.int32)
    else:
        a = torch.randn((B, 3, 10), generator=gen).to(dtype)
    origin = torch.randn((B, 2), generator=gen)
    return [a, origin]


def case(pattern, shared_src):
    """``dst`` unique and outside every ``src``; ``src`` the first blocks,
    shared by pairs of rows with ``shared_src``."""
    dst = torch.arange(B - N, B, dtype=torch.int32)
    src = torch.arange(N, dtype=torch.int32)
    if shared_src:
        src = src // 2
    mask = torch.zeros(N, dtype=torch.bool)
    mask[MASKS[pattern]] = True
    return dst, src, mask


def loop_copy(fields, dst, src, mask, fill):
    out = [f.clone() for f in fields]
    for i in range(N):
        if not mask[i]:
            continue
        for f, (a, values) in enumerate(zip(out, fill)):
            if src is not None:
                a[dst[i]] = fields[f][src[i]]
            else:
                a[dst[i]] = 0 if values is None else values[i]
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
@pytest.mark.parametrize("pattern", list(MASKS))
@pytest.mark.parametrize("form", ["copy", "shared_src", "fill",
                                  "fill_values"])
def test_plain_version_matches_a_loop(dtype, pattern, form):
    fields = fields_of(dtype, seed=len(pattern))
    dst, src, mask = case(pattern, form == "shared_src")
    fill = [None, None]
    if form.startswith("fill"):
        src = None
    if form == "fill_values":
        fill = [fields[0][:N].clone() + 1, torch.full((N, 2), 7.5)]
    want = loop_copy(fields, dst, src, mask, fill)
    got = rc.row_copy(fields, dst, src, mask, fill=fill)
    assert got[0] is fields[0] and got[1] is fields[1]   # in place
    assert_bitwise(list(got), want)


@pytest.mark.parametrize("where", ["dst_below", "dst_above", "src_above"])
def test_masked_rows_outside_the_pool_raise(where):
    """A masked ``dst`` or ``src`` outside ``[0, B)`` raises, as
    ``index_copy_`` does (the kernel traps); unmasked ones are not read."""
    fields = fields_of(torch.float32, seed=3)
    dst, src, mask = case("some", False)
    dst, src = dst.clone(), src.clone()
    dst[1] = B                     # row 1 is not masked
    if where == "src_above":
        src[2] = B
    else:
        dst[2] = -1 if where == "dst_below" else B + 5
    with pytest.raises(IndexError):
        rc.row_copy(fields, dst, src, mask)


def test_rejects_bad_arguments_and_counts_no_launch_on_the_cpu():
    fields = fields_of(torch.float32, seed=4)
    dst, src, mask = case("some", False)
    with pytest.raises(ValueError):
        rc.row_copy([], dst, src, mask)
    with pytest.raises(ValueError):
        rc.row_copy(fields * 5, dst, src, mask)
    with pytest.raises(ValueError):
        rc.row_copy(fields, dst, src, mask, fill=[None])
    with pytest.raises(ValueError):      # fill belongs to the fill form
        rc.row_copy(fields, dst, src, mask, fill=[None, fields[1][:N]])
    before = rc.row_copy.launches
    rc.row_copy(fields, dst, src, mask)
    assert rc.row_copy.launches == before        # the CPU never launches


# ------------------------------------------- the pool, against the O(N) rows

def every_row_copy(pool, dst, src, mask):
    """The copy-on-write's former formulation: every particle's row
    written, a row with ``mask`` off copying its source onto itself."""
    d = torch.where(mask, dst, src).long()
    s = src.long()
    for f in pool.data_fields() + ("origin",):
        a = getattr(pool, f)
        a.index_copy_(0, d, a.index_select(0, s))


def every_row_own_heads(pool, xy, threshold):
    """``ensure_unique_active`` then ``rollover`` as they wrote every
    particle's head row (no mesh, one block range)."""
    chain = pool.chain
    active = chain[:, 0]
    n, b = pool.n, pool.b
    idx = torch.arange(n, dtype=torch.int32)
    owner = torch.full((b,), n, dtype=torch.int32)
    owner.scatter_reduce_(0, active.long(), idx, reduce="amin",
                          include_self=True)
    is_dup = idx != owner.index_select(0, active.long())
    new_block, f1 = mp._allocate_chains(chain, b, is_dup)
    do = new_block >= 0
    every_row_copy(pool, new_block, active, do)
    head = torch.where(do, new_block, active)
    pool.allocated.index_fill_(0, head.long(), True)
    pool.chain[:, 0] = head

    hx = pool.nx * pool.resolution / 2.0
    hy = pool.ny * pool.resolution / 2.0
    active = pool.active()
    org = pool.origin.index_select(0, active.long())
    need = (((xy[:, 0] - (org[:, 0] + hx)).abs() > threshold)
            | ((xy[:, 1] - (org[:, 1] + hy)).abs() > threshold))
    new_block, f2 = mp._allocate_chains(pool.chain, b, need)
    do = new_block >= 0
    new_origin = torch.stack([xy[:, 0] - hx, xy[:, 1] - hy], dim=-1)
    d = torch.where(do, new_block, active).long()
    pool.meta.index_copy_(0, d, torch.where(
        ~do[:, None, None], pool.meta.index_select(0, d), 0))
    pool.origin.index_copy_(0, d, torch.where(
        do[:, None], new_origin, pool.origin.index_select(0, d)))
    pool.allocated.index_copy_(0, d, do | pool.allocated.index_select(0, d))
    shifted = torch.cat([new_block[:, None], pool.chain[:, :-1]], dim=1)
    pool.chain.copy_(torch.where(do[:, None], shifted, pool.chain))
    return pool, f1 + f2


def heads_case(dtype, with_color, blocks, seed):
    n = 16
    pool = sim.random_pool(n, blocks, nx=6, ny=5, k=4, seed=seed,
                           dtype=dtype)
    if with_color:
        gen = torch.Generator().manual_seed(seed)
        pool = dataclasses.replace(pool, color=torch.rand(
            (blocks, 6, 5 * 4 * 3), generator=gen).to(dtype))
    idx = torch.sort(torch.randint(0, n, (n,), generator=torch.Generator()
                                   .manual_seed(seed + 1))).values
    pool.resample_(idx)
    xy = sim.poses_on_heads(pool, 1.2, seed=seed)[0]
    return pool, xy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_color", [False, True])
@pytest.mark.parametrize("blocks", [64, 20])
def test_own_heads_equal_every_row_formulation(dtype, with_color, blocks):
    """A resampling shares heads and some particles leave their grid; a
    pool of 20 blocks for 16 particles runs out."""
    pool, xy = heads_case(dtype, with_color, blocks, seed=blocks)
    want_pool, want_failed = every_row_own_heads(
        dataclasses.replace(pool, **{f: getattr(pool, f).clone() for f in
                                     pool.data_fields()
                                     + ("origin", "allocated", "chain")}),
        xy, 0.6)
    heads_before = pool.active().clone()
    pool, f1 = mp.ensure_unique_active(pool)
    copied = int((pool.active() != heads_before).sum())
    heads_before = pool.active().clone()
    pool, f2 = mp.rollover(pool, xy, 0.6)
    started = int((pool.active() != heads_before).sum())
    assert_bitwise(([getattr(pool, f) for f in pool.data_fields()]
                    + [pool.origin, pool.allocated, pool.chain, f1 + f2]),
                   ([getattr(want_pool, f) for f in pool.data_fields()]
                    + [want_pool.origin, want_pool.allocated,
                       want_pool.chain, want_failed]))
    # the small pool runs out before the new heads find a block
    assert copied and (started > 0) == (blocks == 64)
    assert (int(f1 + f2) > 0) == (blocks < 64)
