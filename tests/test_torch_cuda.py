"""CUDA kernels K1 (``csrc/contact_fold.cu``), K2 (``csrc/chain_lookup.cu``),
K3 (``csrc/block_merge.cu``, and through its second entry point the merge
on a packed block image, P4), K5 (``csrc/select_cells.cu``) and K7
(``csrc/block_copy.cu``) against their plain PyTorch versions on the
card, and short GPU-vs-CPU runs of the localisation and SLAM paths and
of the application API's contact update.  K2, K5 and K7 must match bit
for bit; K3 bit for bit on cells one point hits and within rtol 1e-6
elsewhere (the plain version sums with atomics on the card), on a
bfloat16 pool within one bfloat16 ulp there.  Marked ``cuda``; without a CUDA device every test
skips.  This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from slam_eslam_tpu_torch import Config, ContactModelConfig, SurfaceHashConfig
from slam_eslam_tpu_torch.core.state import BodyContactState
from slam_eslam_tpu_torch.filter import pose_estimator as pe
from slam_eslam_tpu_torch.filter import step as steplib
from slam_eslam_tpu_torch.filter import streaming
from slam_eslam_tpu_torch.filter.eslam_filter import (ContactDraws,
                                                      EmbodiedSlamFilter)
from slam_eslam_tpu_torch.mapping import map_pool as mp
from slam_eslam_tpu_torch.mapping import mls_grid
from slam_eslam_tpu_torch.mapping.lookup import make_lookup
from slam_eslam_tpu_torch.mapping.mls_grid import PackedLookup, PatchCloud
from slam_eslam_tpu_torch.models import sim
from slam_eslam_tpu_torch.models.asguard import AsguardSim
from slam_eslam_tpu_torch.ops import block_copy as bc
from slam_eslam_tpu_torch.ops import block_merge as bm
from slam_eslam_tpu_torch.ops import chain_lookup as cl
from slam_eslam_tpu_torch.ops import contact_fold as cf
from slam_eslam_tpu_torch.ops import select_cells as sc
from slam_eslam_tpu_torch.utils import tree

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def terrain(x, y):
    return 0.25 * np.sin(1.3 * np.asarray(x)) + 0.2 * np.cos(
        0.9 * np.asarray(y))


def fold_case(n, spread, seed, dev, nx=200, ny=160, k=4, c=8):
    rng = np.random.default_rng(seed)
    res, origin = 0.05, (-5.0, -4.0)
    cx = (np.arange(nx) + 0.5) * res + origin[0]
    cy = (np.arange(ny) + 0.5) * res + origin[1]
    base = terrain(cx[:, None], cy[None, :])[..., None]
    mean = base + rng.uniform(-2.5, 2.5, (nx, ny, k)) * (np.arange(k) > 0)
    empty = rng.random((nx, ny, k)) < 0.3
    data = np.concatenate([np.where(empty, 0.0, mean),
                           np.where(empty, -1.0,
                                    rng.uniform(0.01, 0.1, (nx, ny, k)))], -1)
    packed = PackedLookup(torch.tensor(data, dtype=torch.float32, device=dev),
                          torch.tensor(origin, device=dev), res)
    pxy = rng.uniform(-spread, spread, (n, 2))
    offs = rng.uniform(-0.4, 0.4, (c, 2))
    qx = offs[:, :1] + pxy[None, :, 0]
    qy = offs[:, 1:] + pxy[None, :, 1]
    qz = terrain(qx, qy) + rng.normal(0, 0.05, (c, n))
    qz = np.where(rng.random((c, n)) < 0.05, qz + rng.uniform(-4, 4, (c, n)),
                  qz)
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    # the 8-row pattern repeated, every repeat with group ids of its own
    rows = np.arange(c)
    pattern = np.array([0, 0, 1, 1, -1, 2, 2, -1])[rows % 8]
    seg, s = BodyContactState.create(
        np.zeros((c, 3)),
        group_id=np.where(pattern < 0, -1,
                          pattern + 3 * (rows // 8))).segments()
    onehot = (seg[:, None] == torch.arange(s)[None, :]).float().to(dev)
    act = f(np.array([1, 1, 1, 0, 1, 1, 1, 1])[rows % 8][:, None])
    mv = f(rng.uniform(0.01, 0.2, (1, n)))
    return packed, (f(qx), f(qy), f(qz)), act, mv, onehot


@pytest.mark.parametrize("n,spread,k", [(4096, 1.0, 4), (1001, 6.0, 4),
                                        (777, 2.0, 2), (300, 1.0, 1)])
def test_kernel_matches_plain(dev, n, spread, k):
    packed, q, act, mv, onehot = fold_case(n, spread, n, dev, k=k)
    kw = dict(onehot=onehot, correction=0.33, z_window=3.0)
    before = cf.contact_fold.launches
    got = cf.contact_fold(packed, q, act, mv, **kw)
    assert cf.contact_fold.launches == before + 1
    ref = cf.contact_fold_reference(packed, q, act, mv, **kw)
    torch.cuda.synchronize()
    for r in range(4):
        atol = 1e-5 * float(ref[r].abs().max())
        torch.testing.assert_close(got[r], ref[r], rtol=1e-4, atol=atol)
    assert torch.equal(got[4:], ref[4:])
    assert float(got[4].max()) >= 3


def test_kernel_rejects_bad_operands(dev):
    packed, (qx, qy, qz), act, mv, onehot = fold_case(64, 1.0, 0, dev)
    kw = dict(onehot=onehot, correction=0.33)
    with pytest.raises(ValueError):   # non-contiguous
        cf.contact_fold(packed, (qx.T.contiguous().T, qy, qz), act, mv, **kw)
    with pytest.raises(TypeError):    # float64
        cf.contact_fold(packed, (qx.double(), qy, qz), act, mv, **kw)
    with pytest.raises(ValueError):   # queries on the host
        cf.contact_fold(packed, (qx.cpu(), qy, qz), act, mv, **kw)


def test_steps_match_cpu_port(dev):
    n, steps = 4096, 5
    cfg = dataclasses.replace(
        Config(), particle_count=n, min_effective=n // 2,
        contact_model=ContactModelConfig(contact_point_radius=0.0))
    grid = sim.terrain_grid(terrain, nx=160, ny=160, resolution=0.05,
                            origin=(-4.0, -4.0))
    traj = sim.TrajectorySim(terrain, speed=0.05, yaw_rate=0.02)
    css, qs = [], []
    for _ in range(steps):
        (_, yaw), _ = traj.step()
        css.append(traj.contact_state(noise=0.005).compact(8))
        qs.append(torch.tensor([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)],
                               dtype=torch.float32))
    css, qs = tree.stack(css), torch.stack(qs)
    gen = torch.Generator().manual_seed(0)
    particles = pe.init_gaussian(n, (0.0, 0.0), 0.0, (0.2, 0.2), 0.05, 0.2,
                                 0.3, generator=gen)
    draws = [steplib.StepDraws(pe.ProjectDraws.sample(n, gen, "cpu"),
                               torch.rand(n, generator=gen))
             for _ in range(steps)]
    cents = {}
    for d in ("cpu", dev):
        state = dataclasses.replace(
            pe.PoseEstimatorState.create(cfg, 8, device=d),
            particles=tree.to(particles, d))
        run = steplib.make_scan_runner(cfg, make_lookup(cfg,
                                                        tree.to(grid, d)))
        before = cf.contact_fold.launches
        _, c = run(state, tree.to(css, d), qs.to(d),
                   [tree.to(x, d) for x in draws])
        launched = cf.contact_fold.launches - before
        assert launched == (steps if d == dev else 0)
        cents[str(d)] = c.cpu()
    torch.testing.assert_close(cents[str(dev)], cents["cpu"], rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("n,c,nx", [(4096, 8, 40), (1001, 5, 12)])
def test_chain_lookup_matches_plain(dev, n, c, nx):
    pool = sim.random_pool(n, 4 * n, nx, nx, seed=n, device=dev)
    q = sim.chain_queries(pool, c, seed=n)
    args = (pool.mean, pool.stdev, pool.meta, pool.origin, pool.resolution,
            pool.chain, q)
    before = cl.chain_lookup.launches
    got = cl.chain_lookup(*args, k=4, z_window=1.0)
    assert cl.chain_lookup.launches == before + 1
    ref = cl.chain_lookup_reference(*args, k=4, z_window=1.0)
    torch.cuda.synchronize()
    assert 0.1 < float(ref[0].float().mean()) < 0.9
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    # the slot output a colour pool's lookup gathers its colour by
    got = cl.chain_lookup(*args, k=4, z_window=1.0, with_slot=True)
    ref = cl.chain_lookup_reference(*args, k=4, z_window=1.0, with_slot=True)
    assert got[3].dtype == torch.int64 and bool((got[3] >= 0).equal(got[0]))
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def merge_setup(n, p, nx, dev, seed, dtype=torch.float32):
    pool = sim.random_pool(n, 4 * n, nx, nx, seed=seed, device=dev,
                           dtype=dtype)
    gen = torch.Generator(dev).manual_seed(seed)
    ang = torch.linspace(-np.pi / 2, np.pi / 2, p, device=dev)
    r = 0.5 + 2.0 * torch.rand(p, generator=gen, device=dev)
    cloud = PatchCloud.create(
        xy=torch.stack([r * torch.cos(ang), r * torch.sin(ang)], -1),
        z=0.3 + 0.02 * torch.randn(p, generator=gen, device=dev),
        stdev=0.01 + 0.04 * torch.rand(p, generator=gen, device=dev),
        valid=torch.rand(p, generator=gen, device=dev) < 0.9)
    ops = mp.merge_operands(pool, *sim.poses_on_heads(pool, 1.0, seed),
                            cloud)
    return pool, ops


def one_point_slots(pool, blk, lx, ly):
    """Slots of cells that exactly one masked-in point hits."""
    inb = (lx < pool.nx) & (ly < pool.ny)
    cell = (blk.long()[:, None] * pool.nx + lx.long()) * pool.ny + ly.long()
    counts = torch.zeros(pool.b * pool.nx * pool.ny, dtype=torch.int32,
                         device=blk.device)
    counts.index_add_(0, cell[inb], torch.ones_like(cell[inb],
                                                    dtype=torch.int32))
    return (counts == 1).reshape(pool.b, pool.nx, pool.ny, 1).expand(
        -1, -1, -1, pool.k).reshape(pool.mean.shape)


@pytest.mark.parametrize("n,p,nx", [(4096, 64, 40), (777, 300, 12)])
def test_block_merge_matches_plain(dev, n, p, nx):
    pool, (blk, lx, ly, w, wz) = merge_setup(n, p, nx, dev, seed=n)
    fields = [pool.mean, pool.stdev, pool.height, pool.meta]
    kern = [f.clone() for f in fields]
    plain = [f.clone() for f in fields]
    before = bm.block_merge.launches
    bm.block_merge(*kern, None, blk, lx, ly, w, wz, 5, k=4)
    assert bm.block_merge.launches == before + 1
    bm.block_merge_reference(*plain, None, blk, lx, ly, w, wz, 5, k=4)
    torch.cuda.synchronize()
    assert torch.equal(kern[3], plain[3])
    changed = kern[3] != fields[3]
    assert int(changed.sum()) > n
    one = one_point_slots(pool, blk, lx, ly)
    for a, b in zip(kern[:3], plain[:3]):
        assert torch.equal(a[one], b[one])
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_block_merge_many_points_match_cpu(dev):
    """A camera-sized cloud (P = 8,192: 64 KB of sort keys, above the
    default 48 KB of shared memory) against the plain version on the
    CPU, whose sums run in point order as the kernel's do: mean, height
    and meta bit for bit, many-point cells included; stdev within 1 ulp,
    because PyTorch's vectorised CPU ``sqrt`` is not correctly rounded
    (about 0.7 % of float32 inputs come out 1 ulp off) and the card's
    is."""
    pool, (blk, lx, ly, w, wz) = merge_setup(64, 8192, 40, dev, seed=9)
    fields = [pool.mean, pool.stdev, pool.height, pool.meta]
    kern = [f.clone() for f in fields]
    cpu = [f.cpu() for f in fields]
    bm.block_merge(*kern, None, blk, lx, ly, w, wz, 3, k=4)
    bm.block_merge_reference(*cpu, None, blk.cpu(), lx.cpu(), ly.cpu(),
                             w.cpu(), wz.cpu(), 3, k=4)
    torch.cuda.synchronize()
    assert int((kern[3] != fields[3]).sum()) > 64
    for i in (0, 2, 3):
        assert torch.equal(kern[i].cpu(), cpu[i])
    ulps = (kern[1].cpu().view(torch.int32).long()
            - cpu[1].view(torch.int32).long()).abs()
    assert int(ulps.max()) <= 1


@pytest.mark.parametrize("n,p,nx", [(4096, 64, 40), (777, 300, 12),
                                    (64, 8192, 40)])
def test_block_merge_packed_matches_plain_and_unpacked(dev, n, p, nx):
    """The merge on the packed block image: meta rows equal as int32 and
    the fields bitwise on one-point cells, rtol 1e-6 elsewhere, against
    its plain version; bit for bit against K3 on the unpacked fields (one
    kernel, two layouts); blocks no particle owns untouched."""
    pool, (blk, lx, ly, w, wz) = merge_setup(n, p, nx, dev, seed=n + 1)
    fields = [pool.mean, pool.stdev, pool.height, pool.meta]
    packed = bm.pack_fields(*fields)
    for a, b in zip(bm.packed_fields(packed, nx), fields):
        assert torch.equal(a, b)
    kern, plain = packed.clone(), packed.clone()
    unpacked = [f.clone() for f in fields]
    before = (bm.block_merge_packed.launches, bm.block_merge.launches)
    bm.block_merge_packed(kern, blk, lx, ly, w, wz, 5, nx=nx, k=4)
    assert (bm.block_merge_packed.launches, bm.block_merge.launches) == (
        before[0] + 1, before[1])
    bm.block_merge_packed_reference(plain, blk, lx, ly, w, wz, 5, nx=nx, k=4)
    bm.block_merge(*unpacked, None, blk, lx, ly, w, wz, 5, k=4)
    torch.cuda.synchronize()
    got, ref = bm.packed_fields(kern, nx), bm.packed_fields(plain, nx)
    assert torch.equal(got[3], ref[3])
    assert int((got[3] != fields[3]).sum()) > n
    one = one_point_slots(pool, blk, lx, ly)
    for a, b in zip(got[:3], ref[:3]):
        assert torch.equal(a[one], b[one])
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    for a, b in zip(got, unpacked):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    idle = torch.ones(pool.b, dtype=torch.bool, device=dev)
    idle[blk.long()] = False
    assert torch.equal(kern.view(torch.int32)[idle],
                       packed.view(torch.int32)[idle])


def test_block_merge_packed_rejects_bad_operands(dev):
    pool, (blk, lx, ly, w, wz) = merge_setup(32, 16, 12, dev, seed=2)
    packed = bm.pack_fields(pool.mean, pool.stdev, pool.height, pool.meta)
    args = (blk, lx, ly, w, wz, 1)
    with pytest.raises(TypeError, match="float32"):
        bm.block_merge_packed(packed.bfloat16(), *args, nx=12, k=4)
    with pytest.raises(ValueError, match="shape"):
        bm.block_merge_packed(packed, *args, nx=10, k=4)
    with pytest.raises(ValueError, match="contiguous"):
        bm.block_merge_packed(packed.transpose(1, 2).contiguous()
                              .transpose(1, 2), *args, nx=12, k=4)
    with pytest.raises(TypeError, match="lx"):
        bm.block_merge_packed(packed, blk, lx.long(), ly, w, wz, 1, nx=12,
                              k=4)
    with pytest.raises(TypeError, match="bfloat16|float32"):
        bm.pack_fields(pool.mean.bfloat16(), pool.stdev, pool.height,
                       pool.meta)


def test_block_merge_colour_pool(dev):
    pool, (blk, lx, ly, w, wz) = merge_setup(500, 64, 12, dev, seed=3)
    gen = torch.Generator(dev).manual_seed(3)
    color = torch.rand(pool.mean.shape[:2] + (pool.mean.shape[2] * 3,),
                       generator=gen, device=dev)
    pcolor = torch.rand((64, 3), generator=gen, device=dev)
    fields = [pool.mean, pool.stdev, pool.height, pool.meta, color]
    kern = [f.clone() for f in fields]
    plain = [f.clone() for f in fields]
    bm.block_merge(*kern, blk, lx, ly, w, wz, 2, pcolor, k=4)
    bm.block_merge_reference(*plain, blk, lx, ly, w, wz, 2, pcolor, k=4)
    torch.cuda.synchronize()
    assert torch.equal(kern[3], plain[3])
    for a, b in zip(kern, plain):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,c,nx,k", [(4096, 8, 40, 4), (1001, 5, 12, 4),
                                      (513, 3, 12, 2)])
def test_chain_lookup_bf16_matches_plain(dev, n, c, nx, k):
    """K2 on a pool stored in bfloat16: still a pure select, bitwise,
    float32 out."""
    pool = sim.random_pool(n, 4 * n, nx, nx, k=k, seed=n, device=dev,
                           dtype=torch.bfloat16)
    q = sim.chain_queries(pool, c, seed=n)
    args = (pool.mean, pool.stdev, pool.meta, pool.origin, pool.resolution,
            pool.chain, q)
    before = cl.chain_lookup.launches
    got = cl.chain_lookup(*args, k=k, z_window=1.0)
    assert cl.chain_lookup.launches == before + 1
    ref = cl.chain_lookup_reference(*args, k=k, z_window=1.0)
    torch.cuda.synchronize()
    assert 0.1 < float(ref[0].float().mean()) < 0.9
    assert got[1].dtype == got[2].dtype == torch.float32
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def bf16_ulps(a, b):
    """Largest distance in bfloat16 steps between two bfloat16 tensors."""
    return int((a.view(torch.int16).long()
                - b.view(torch.int16).long()).abs().max())


@pytest.mark.parametrize("n,p,nx", [(4096, 64, 40), (777, 300, 12)])
def test_block_merge_bf16_matches_plain(dev, n, p, nx):
    """K3 on a pool stored in bfloat16: meta equal, one-point cells bit
    for bit, many-point cells (float32 sums in another order, then one
    rounding) within one bfloat16 ulp; the storage type is kept."""
    pool, (blk, lx, ly, w, wz) = merge_setup(n, p, nx, dev, seed=n,
                                             dtype=torch.bfloat16)
    fields = [pool.mean, pool.stdev, pool.height, pool.meta]
    kern = [f.clone() for f in fields]
    plain = [f.clone() for f in fields]
    before = bm.block_merge.launches
    bm.block_merge(*kern, None, blk, lx, ly, w, wz, 5, k=4)
    assert bm.block_merge.launches == before + 1
    bm.block_merge_reference(*plain, None, blk, lx, ly, w, wz, 5, k=4)
    torch.cuda.synchronize()
    assert torch.equal(kern[3], plain[3])
    assert int((kern[3] != fields[3]).sum()) > n
    one = one_point_slots(pool, blk, lx, ly)
    for a, b in zip(kern[:3], plain[:3]):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a[one], b[one])
        assert bf16_ulps(a, b) <= 1


@pytest.mark.parametrize("in_place", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,n,p,nx,nyk", [
    ("whole", 4096, 64, 40, 128), ("cells", 4096, 64, 40, 128),
    ("points", 4096, 64, 40, 128), ("whole", 777, 20, 11, 44),
    ("cells", 777, 20, 11, 44), ("points", 777, 20, 11, 44)])
def test_block_copy_matches_plain(dev, mode, n, p, nx, nyk, dtype,
                                  in_place):
    """K7 against its plain version, bit for bit, at the merge benchmark's
    shape and at a ragged one whose blocks are no multiple of 16 bytes in
    bfloat16; out of place, blocks outside ``blk`` keep their content."""
    b = n + 64
    gen = torch.Generator(dev).manual_seed(n)
    rand = lambda *s: torch.rand(s, generator=gen, device=dev)
    make = lambda: (rand(b, nx, nyk).to(dtype), rand(b, nx, nyk).to(dtype),
                    rand(b, nx, nyk).to(dtype),
                    torch.randint(0, 99, (b, nx, nyk), generator=gen,
                                  device=dev, dtype=torch.int32))
    fields = make()
    blk = torch.randperm(b, generator=gen, device=dev)[:n].to(torch.int32)
    blk[5] = -1
    ny = nyk // 4
    points = (torch.randint(-1, nx + 1, (n, p), generator=gen, device=dev,
                            dtype=torch.int32),
              torch.randint(-1, ny + 1, (n, p), generator=gen, device=dev,
                            dtype=torch.int32), rand(n, p), rand(n, p))
    out = None if in_place else make()
    start = None if in_place else [f.clone() for f in out]
    want_out = None if in_place else [f.clone() for f in out]
    want_in = [f.clone() for f in fields]
    before = bc.block_copy.launches
    got = bc.block_copy(fields, blk, points, out=out, mode=mode, k=4)
    assert bc.block_copy.launches == before + 1
    want = bc.block_copy_reference(want_in, blk, points, out=want_out,
                                   mode=mode, k=4)
    torch.cuda.synchronize()
    for g, w_ in zip(got, want):
        assert torch.equal(g.view(torch.uint8), w_.view(torch.uint8))
    if not in_place:                      # and something was copied
        assert all(not torch.equal(g, o) for g, o in zip(got, start))


def test_block_copy_packed_and_no_points(dev):
    """One packed image of ``4 * nx`` rows and a copy without the point
    operands (the JAX probes ``copy_packed`` and ``copy_fields``)."""
    n, b, nx, nyk = 300, 364, 12, 48
    gen = torch.Generator(dev).manual_seed(0)
    packed = torch.rand((b, 4 * nx, nyk), generator=gen, device=dev)
    out = torch.zeros_like(packed)
    blk = torch.randperm(b, generator=gen, device=dev)[:n].to(torch.int32)
    got = bc.block_copy((packed,), blk, out=(out,))
    want = torch.zeros_like(packed)
    want[blk.long()] = packed[blk.long()]
    torch.cuda.synchronize()
    assert torch.equal(got[0], want)


def test_kernels_reject_bad_operands(dev):
    pool, (blk, lx, ly, w, wz) = merge_setup(64, 16, 12, dev, seed=4)
    q = sim.chain_queries(pool, 4)
    with pytest.raises(TypeError):               # mixed pool storage types
        cl.chain_lookup(pool.mean.bfloat16(), pool.stdev, pool.meta,
                        pool.origin, 0.25, pool.chain, q, k=4)
    with pytest.raises(TypeError):               # float16 is no pool type
        bm.block_merge(pool.mean.half(), pool.stdev.half(),
                       pool.height.half(), pool.meta, None, blk, lx, ly, w,
                       wz, 1, k=4)
    with pytest.raises(TypeError):               # int64 block ids
        bc.block_copy((pool.mean,), blk.long())
    with pytest.raises(ValueError):              # chain on the host
        cl.chain_lookup(pool.mean, pool.stdev, pool.meta, pool.origin,
                        0.25, pool.chain.cpu(), q, k=4)
    with pytest.raises(TypeError):               # int64 cells
        bm.block_merge(pool.mean, pool.stdev, pool.height, pool.meta, None,
                       blk, lx.long(), ly, w, wz, 1, k=4)


def test_slam_steps_match_cpu_port(dev):
    """A short per-particle SLAM run on the card against the CPU port on
    the same draws; K2 and K3 launch once per gated frame."""
    n, steps = 512, 4
    cfg = dataclasses.replace(
        Config(), particle_count=n, min_effective=n // 2, grid_size=4.0,
        grid_resolution=0.25, map_pool_blocks=4 * n, map_chain_length=3,
        map_pool_color=False,
        contact_model=ContactModelConfig(contact_point_radius=0.0,
                                         min_contacts=2))
    asg = AsguardSim(terrain=terrain)
    z0 = float(asg.position[2])
    frames, full = [], []

    def cb(s):
        cs = s.contact_state()
        full.append(cs)
        frames.append([cs.compact(8), s.orientation,
                       s.position.astype(np.float32),
                       np.full(32, 2.0, np.float32),
                       (-np.pi / 2, np.pi / 32), False])

    for _ in range(steps):
        asg.step(wheel_delta=0.6, on_substep=cb)
        frames[-1][5] = True
    stacked = streaming.stack_frames(frames)
    qs = torch.stack([torch.as_tensor(f[1]) for f in frames])
    gen = torch.Generator().manual_seed(0)
    normals = (torch.randn((n, 2), generator=gen),
               torch.randn((n,), generator=gen))
    draws = [steplib.StepDraws(pe.ProjectDraws.sample(n, gen, "cpu"),
                               torch.rand(n, generator=gen))
             for _ in frames]
    out = {}
    for d in ("cpu", dev):
        f = EmbodiedSlamFilter(config=cfg, device=d).init(
            pose=(np.array([0.0, 0.0, z0]), 0.0), use_shared_map=False,
            num_contact_points=20, normal_xy=normals[0].to(d),
            normal_yaw=normals[1].to(d))
        odos = streaming.precompute_odometry(20, tree.to(tree.stack(full), d),
                                             qs.to(d), cfg=cfg)
        run = streaming.make_slam_scan_runner(
            cfg, laser2body=(np.eye(3), np.zeros(3)), external_odometry=True)
        k2, k3 = cl.chain_lookup.launches, bm.block_merge.launches
        carry, aux = run(streaming.StreamingState.create(f.state, f.pool),
                         tree.to(stacked, d), odos,
                         [tree.to(x, d) for x in draws])
        k2, k3 = cl.chain_lookup.launches - k2, bm.block_merge.launches - k3
        if d == dev:
            assert (k2, k3) == (aux["updated"].sum(), aux["mapped"].sum())
        else:
            assert (k2, k3) == (0, 0)
        out[str(d)] = (aux, int(carry.pool.valid.sum()))
    (a_cpu, n_cpu), (a_gpu, n_gpu) = out["cpu"], out[str(dev)]
    assert (a_gpu["updated"] == a_cpu["updated"]).all()
    assert (a_gpu["mapped"] == a_cpu["mapped"]).all()
    assert a_gpu["mapped"].sum() == steps
    torch.testing.assert_close(a_gpu["centroid"].cpu(), a_cpu["centroid"],
                               rtol=0, atol=1e-3)
    assert abs(n_gpu - n_cpu) <= 1e-3 * n_cpu


@pytest.mark.parametrize("n,spread,k,nx", [
    (100_000, 1.0, 4, 400),      # Q = 800,000 on the 400 x 400 x 4 grid
    (100_003, 1.0, 4, 400),      # a ragged Q
    (100_000, 15.0, 4, 400),     # spread, most queries outside the grid
    (3001, 2.0, 2, 200),
    (2999, 2.0, 1, 200)], ids=["bench", "ragged", "spread", "k2", "k1"])
def test_select_cells_matches_plain(dev, n, spread, k, nx):
    packed, q, *_ = fold_case(n, spread, n, dev, nx=nx, ny=nx, k=k)
    q = tuple(a.reshape(-1).contiguous() for a in q)
    before = sc.select_cells.launches
    got = sc.select_cells(packed, q, 3.0)
    ix, iy = mls_grid.cells(packed, q[0], q[1])
    by_cell = sc.select_cells(packed, (ix, iy, q[2]), 3.0)
    assert sc.select_cells.launches == before + 2
    ref = sc.select_cells_reference(packed, q, 3.0)
    torch.cuda.synchronize()
    assert got[0].shape == (8 * n,)
    assert 0.0 < float(ref[0].float().mean()) < 1.0
    for a, b, c in zip(got, ref, by_cell):      # misses included
        assert torch.equal(a, b) and torch.equal(a, c)


def test_select_cells_rejects_bad_operands(dev):
    packed, (qx, qy, qz), *_ = fold_case(64, 1.0, 0, dev)
    with pytest.raises(ValueError):   # shapes differ
        sc.select_cells(packed, (qx, qy[:4], qz))
    with pytest.raises(TypeError):    # float64
        sc.select_cells(packed, (qx.double(), qy, qz))
    with pytest.raises(ValueError):   # queries on the host
        sc.select_cells(packed, (qx.cpu(), qy, qz))
    with pytest.raises(TypeError):    # int64 cells
        sc.select_cells(packed, (qx.long(), qy.long(), qz))


def test_update_contact_matches_cpu_port(dev):
    """``EmbodiedSlamFilter.update_contact`` with ``log_debug`` and the
    surface hash on the card, host syncs forbidden, against the CPU port
    on the same draws; K5 launches once per measurement update.  The hash
    and its global sampling must be equal; the run starts both from one
    Gaussian cloud, where a one-ulp weight difference can move a
    resampling ancestor by centimetres (from the map-wide hash cloud, by
    metres)."""
    n, frames = 4096, 12
    cfg = dataclasses.replace(
        Config(), particle_count=n, min_effective=n // 5, log_debug=True,
        contact_model=ContactModelConfig(contact_point_radius=0.0))
    hcfg = SurfaceHashConfig(use_hash=True, period=4)
    grid = sim.terrain_grid(terrain, nx=160, ny=160, resolution=0.05,
                            origin=(-4.0, -4.0))
    traj = sim.TrajectorySim(terrain, speed=0.05, yaw_rate=0.02)
    z0 = float(traj.position[2])
    gen = torch.Generator().manual_seed(0)
    filters = {d: EmbodiedSlamFilter(config=cfg, device=d).init(
        (np.array([0.0, 0.0, z0]), 0.0), shared_grid=grid, hash_config=hcfg,
        num_contact_points=8) for d in ("cpu", dev)}
    fc, fg = filters["cpu"], filters[dev]
    assert torch.equal(fg.hash.bucket_id.cpu(), fc.hash.bucket_id)
    u = torch.randint(0, int(fc.hash.n_valid), (n,), generator=gen)
    sampled = (fc.hash.sample_particles(n, u),
               fg.hash.sample_particles(n, u.to(dev)))
    for f in dataclasses.fields(sampled[0]):
        assert torch.equal(getattr(sampled[1], f.name).cpu(),
                           getattr(sampled[0], f.name))
    start = pe.init_gaussian(n, (0.0, 0.0), 0.0, (0.1, 0.1), 0.1, z0, 0.3,
                             generator=gen)
    for f in (fc, fg):
        f.state = dataclasses.replace(f.state,
                                      particles=tree.to(start, f.device))
    n_meas, before = 0, sc.select_cells.launches
    for _ in range(frames):
        (pos, yaw), _ = traj.step()
        cs = traj.contact_state(noise=0.005).compact(8)
        q = torch.tensor([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)],
                         dtype=torch.float32)
        count = int(fc.hash.bucket_count[fc.hash.bucket(
            *fc.hash.signature(cs, q))])
        draws = ContactDraws(
            pe.ProjectDraws.sample(n, gen, "cpu"), torch.rand(n, generator=gen),
            torch.randint(0, max(count, 1), (n,), generator=gen))
        pose = (q.numpy(), pos)
        got_c = fc.update_contact(pose, cs, draws=draws, orientation=q)
        cs_d, draws_d, q_d = tree.to(cs, dev), tree.to(draws, dev), q.to(dev)
        torch.cuda.set_sync_debug_mode("error")
        try:
            got_g = fg.update_contact(pose, cs_d, draws=draws_d,
                                      orientation=q_d)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert got_g == got_c
        n_meas += got_g
        torch.testing.assert_close(fg.get_centroid()[0].cpu(),
                                   fc.get_centroid()[0], rtol=0, atol=1e-3)
    assert sc.select_cells.launches - before == n_meas > 0
    assert torch.equal(fg.last_eval.cp_ok.cpu(), fc.last_eval.cp_ok)


def assert_fold_close(got, ref):
    for r in range(4):
        atol = 1e-5 * float(ref[r].abs().max())
        torch.testing.assert_close(got[r], ref[r], rtol=1e-4, atol=atol)
    assert torch.equal(got[4:], ref[4:])


@pytest.mark.parametrize("c", [1, 5, 8, 9, 20, 32])
@pytest.mark.parametrize("n", [1, 127, 129, 4096])
def test_fold_tile_and_row_edges(dev, c, n):
    """K1 around a warp's and a block's edge, at one row and at more rows
    than the bench has: ``seg=`` and ``onehot=`` give the same bits, and
    both agree with the plain version."""
    packed, q, act, mv, onehot = fold_case(n, 1.0, 100 * c + n, dev, c=c)
    seg = cf.segment_ids(onehot)
    got = cf.contact_fold(packed, q, act, mv, seg=seg, correction=0.33)
    by_onehot = cf.contact_fold(packed, q, act, mv, onehot=onehot,
                                correction=0.33)
    ref = cf.contact_fold_reference(packed, q, act, mv, onehot, 0.33)
    torch.cuda.synchronize()
    assert torch.equal(got, by_onehot)
    assert_fold_close(got, ref)


def test_fold_many_rows(dev):
    """C = 100 contact rows: the row loop has no limit of its own."""
    c, n = 100, 300
    packed, q, act, mv, onehot = fold_case(n, 1.0, 3, dev, c=c)
    got = cf.contact_fold(packed, q, act, mv, seg=cf.segment_ids(onehot),
                          correction=0.33)
    ref = cf.contact_fold_reference(packed, q, act, mv, onehot, 0.33)
    torch.cuda.synchronize()
    assert_fold_close(got, ref)


def test_fold_all_rows_inactive(dev):
    packed, q, act, mv, onehot = fold_case(257, 1.0, 5, dev)
    got = cf.contact_fold(packed, q, torch.zeros_like(act), mv,
                          onehot=onehot, correction=0.33)
    torch.cuda.synchronize()
    assert not bool(got.any())


@pytest.mark.parametrize("count", [1, 3, 5, 4096, 800_001])
@pytest.mark.parametrize("offset", [0, 1], ids=["fresh", "offset_view"])
def test_select_cells_small_counts_and_views(dev, count, offset):
    """K5 at small counts and one past a full block, on fresh tensors and
    on views that start 4 bytes into one: both entries, bit for bit."""
    n = -(-(count + 1) // 8)
    packed, q, *_ = fold_case(n, 6.0, count, dev)
    q = tuple(a.reshape(-1)[offset:offset + count] for a in q)
    if not offset:
        q = tuple(a.contiguous() for a in q)
    got = sc.select_cells(packed, q, 3.0)
    ix, iy = mls_grid.cells(packed, q[0], q[1])
    by_cell = sc.select_cells(packed, (ix, iy, q[2]), 3.0)
    ref = sc.select_cells_reference(packed, q, 3.0)
    torch.cuda.synchronize()
    assert got[0].shape == (count,)
    for a, b, c in zip(got, ref, by_cell):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_launches_capture_into_a_cuda_graph(dev):
    """The raw launches of K1 and K5 allocate nothing and read nothing
    back, so a CUDA graph captures them; a replay gives the eager result."""
    packed, q, act, mv, onehot = fold_case(4096, 1.0, 11, dev)
    seg = cf.segment_ids(onehot)
    ref = cf.contact_fold(packed, q, act, mv, seg=seg, correction=0.33)
    flat = tuple(a.reshape(-1).contiguous() for a in q)
    sel_ref = sc.select_cells(packed, flat, 3.0)
    out = torch.zeros_like(ref)
    outs = tuple(torch.zeros_like(t) for t in sel_ref)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = cf.contact_fold.launches, sc.select_cells.launches
    with torch.cuda.graph(graph):
        cf.launch(packed, q, act, mv, seg, out, 0.33)
        sc.launch(packed, flat, outs, 3.0)
    assert (cf.contact_fold.launches, sc.select_cells.launches) == (
        before[0] + 1, before[1] + 1)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    for a, b in zip(outs, sel_ref):
        assert torch.equal(a, b)


def test_device_time_reads_below_the_call_time(dev):
    """``profiling.device_time`` of K1's raw launch, the profiler's
    reading of the kernel by name and of every kernel of a call, and the
    cold-L2 reading are all positive."""
    from slam_eslam_tpu_torch.utils import profiling

    packed, q, act, mv, onehot = fold_case(4096, 1.0, 13, dev)
    seg = cf.segment_ids(onehot)
    out = cf.contact_fold(packed, q, act, mv, seg=seg, correction=0.33)
    launch = lambda: cf.launch(packed, q, act, mv, seg, out, 0.33)
    t = profiling.device_time(launch, reps=50, replays=3)
    p = profiling.profiler_kernel_time(launch, "contact_fold_kernel",
                                       calls=10)
    # the wrapper given the one-hot: the argmax and the cast count too
    whole = profiling.profiler_kernel_time(
        lambda: cf.contact_fold(packed, q, act, mv, onehot=onehot,
                                correction=0.33), calls=10)
    cold, fill = profiling.device_time_cold(launch, reps=20, replays=2)
    assert 0 < p < whole and t > 0
    assert fill > 0 and cold > 0
