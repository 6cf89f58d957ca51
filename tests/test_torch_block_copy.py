"""Block copy (kernel K7's plain version) against NumPy.

``ops.block_copy.block_copy`` on CPU tensors runs
``block_copy_reference``, the plain version that the CUDA kernel is held
against on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
Here it is held against the function's definition in NumPy, bit for bit
(a copy has no tolerance):

* ``whole``: ``out[blk] = in[blk]`` for every field, every other block
  untouched; with and without the point operands (the JAX probes
  ``copy_all`` and ``copy_fields``) and for one packed image of ``4*nx``
  rows (``copy_packed``);
* ``cells`` and ``points`` (the same result, visited in another order on
  the card): the K slots of every cell an in-range point hits are copied,
  nothing else changes; in place, every field is unchanged;

each for float32 and bfloat16 float fields, in place and into a second
pool, with out-of-range block ids and points.

The JAX function this kernel serves, ``kernel_eff.merge_floor_fraction``,
runs only on its accelerator and returns ``None`` elsewhere; so does the
port's for ``device="cpu"``.
"""

import numpy as np
import pytest
import torch

from slam_eslam_tpu.utils import kernel_eff as jeff
from slam_eslam_tpu_torch.ops import block_copy as bc
from slam_eslam_tpu_torch.utils import kernel_eff as teff

torch.set_num_threads(2)

N, P, B = 24, 20, 40
NX, NY, K = 10, 6, 4


def make_fields(seed, dtype, packed=False):
    """Seeded ``(mean, stdev, height, meta)`` block images, or one packed
    float32 image of ``4 * NX`` rows."""
    rng = np.random.default_rng(seed)
    shape = (B, NX, NY * K)
    if packed:
        return (torch.from_numpy(
            rng.normal(size=(B, 4 * NX, NY * K)).astype(np.float32)),)
    f = lambda: torch.from_numpy(
        rng.normal(size=shape).astype(np.float32)).to(dtype)
    meta = torch.from_numpy(rng.integers(0, 64, shape).astype(np.int32))
    return f(), f(), f(), meta


def make_points(seed):
    """``blk`` (unique, two entries outside ``[0, B)``) and point rows with
    some cells out of range and some hit more than once."""
    rng = np.random.default_rng(seed + 100)
    blk = rng.permutation(B)[:N].astype(np.int32)
    blk[3], blk[7] = -1, B
    lx = rng.integers(-1, NX + 1, (N, P)).astype(np.int32)
    ly = rng.integers(-1, NY + 1, (N, P)).astype(np.int32)
    lx[:, 1], ly[:, 1] = lx[:, 0], ly[:, 0]          # a repeated cell
    w = rng.uniform(1, 50, (N, P)).astype(np.float32)
    wz = rng.normal(size=(N, P)).astype(np.float32)
    return (torch.from_numpy(blk),
            tuple(torch.from_numpy(a) for a in (lx, ly, w, wz)))


def raw(x):
    """A tensor's bits as a NumPy integer array."""
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy()
    return x.view(torch.int32).numpy()


def expected(fields_in, fields_out, blk, points, mode):
    """The definition, in NumPy, on bit patterns."""
    blk = blk.numpy()
    good = blk[(blk >= 0) & (blk < B)]
    outs = []
    for src, dst in zip(fields_in, fields_out):
        src, dst = raw(src), raw(dst).copy()
        if mode == "whole":
            dst[good] = src[good]
        else:
            lx, ly = points[0].numpy(), points[1].numpy()
            for n in range(N):
                if not 0 <= blk[n] < B:
                    continue
                for x, y in zip(lx[n], ly[n]):
                    if 0 <= x < NX and 0 <= y < NY:
                        dst[blk[n], x, y * K:(y + 1) * K] = src[
                            blk[n], x, y * K:(y + 1) * K]
        outs.append(dst)
    return outs


@pytest.mark.parametrize("in_place", [True, False],
                         ids=["in_place", "out_of_place"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mode,with_points", [
    ("whole", True), ("whole", False), ("cells", True), ("points", True)],
    ids=["whole", "whole_no_points", "cells", "points"])
def test_block_copy_matches_numpy(mode, with_points, dtype, in_place):
    fields = make_fields(0, dtype)
    blk, points = make_points(0)
    before = [f.clone() for f in fields]
    out = None if in_place else make_fields(1, dtype)
    out_before = before if in_place else [f.clone() for f in out]
    want = expected(before, out_before, blk, points, mode)
    got = bc.block_copy(fields, blk, points if with_points else None,
                        out=out, mode=mode, k=K)
    assert len(got) == 4
    for g, w, src in zip(got, want, before):
        assert g.dtype == src.dtype
        np.testing.assert_array_equal(raw(g), w)
    for f, b_ in zip(fields, before):      # the input is never changed
        assert torch.equal(f.view(torch.uint8), b_.view(torch.uint8))
    if not in_place:
        # something was copied, and blocks outside blk kept their content
        assert any((raw(g) != raw(o)).any() for g, o in zip(got, out_before))
        unused = np.setdiff1d(np.arange(B), blk.numpy())
        for g, o in zip(got, out_before):
            np.testing.assert_array_equal(raw(g)[unused], raw(o)[unused])


@pytest.mark.parametrize("in_place", [True, False],
                         ids=["in_place", "out_of_place"])
def test_block_copy_packed_image(in_place):
    """One packed ``[B, 4*nx, ny*k]`` image, whole blocks, no points."""
    fields = make_fields(2, torch.float32, packed=True)
    blk, _ = make_points(2)
    before = [fields[0].clone()]
    out = None if in_place else make_fields(3, torch.float32, packed=True)
    out_before = before if in_place else [out[0].clone()]
    want = expected(before, out_before, blk, None, "whole")
    got = bc.block_copy(fields, blk, out=out, mode="whole")
    assert got[0].shape == (B, 4 * NX, NY * K)
    np.testing.assert_array_equal(raw(got[0]), want[0])


def test_block_copy_rejects_bad_arguments():
    fields = make_fields(4, torch.float32)
    blk, points = make_points(4)
    with pytest.raises(ValueError):
        bc.block_copy(fields, blk, points, mode="rows")
    for mode in ("cells", "points"):           # both need the points
        with pytest.raises(ValueError):
            bc.block_copy(fields, blk, mode=mode)
    with pytest.raises(ValueError):            # at most four fields
        bc.block_copy(fields + fields[:1], blk)
    with pytest.raises(ValueError):            # one output per field
        bc.block_copy(fields, blk, out=fields[:2])
    assert bc.block_copy.launches == 0         # the CPU never launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_merge_benchmark_operands(dtype):
    """The merge benchmark's operands: the JAX function's draws, in its
    order, from ``numpy.random.default_rng(seed)``; unique block ids,
    every point in range; another seed, other content."""
    n, p, nx, ny, k = 12, 5, 6, 3, 4
    fields, blk, points = teff.merge_benchmark_operands(
        n, p, nx, ny, k, dtype=dtype)
    rng = np.random.default_rng(0)
    shape = (n + 64, nx, ny * k)
    mean = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    stdev = torch.from_numpy(
        rng.uniform(0.05, 0.3, size=shape).astype(np.float32))
    meta = (rng.random(size=shape) < 0.5).astype(np.int32)
    assert [f.dtype for f in fields] == [dtype] * 3 + [torch.int32]
    assert torch.equal(fields[0], mean.to(dtype))
    assert torch.equal(fields[1], stdev.to(dtype))
    assert not fields[2].any() and fields[2].shape == shape
    np.testing.assert_array_equal(fields[3].numpy(), meta)
    np.testing.assert_array_equal(blk.numpy(), rng.permutation(n + 64)[:n])
    assert len(set(blk.tolist())) == n
    lx, ly, w, wz = points
    assert all(t.shape == (n, p) for t in points)
    assert 0 <= int(lx.min()) and int(lx.max()) < nx
    assert 0 <= int(ly.min()) and int(ly.max()) < ny
    assert float(w.min()) >= 1.0 and wz.dtype == torch.float32
    other, _, _ = teff.merge_benchmark_operands(n, p, nx, ny, k, dtype=dtype,
                                                seed=1)
    assert not torch.equal(other[0], fields[0])


def test_merge_floor_fraction_is_none_off_the_accelerator():
    assert jeff.merge_floor_fraction() is None
    assert teff.merge_floor_fraction(device="cpu") is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            teff.merge_floor_fraction()
