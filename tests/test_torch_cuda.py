"""CUDA kernels K1 (``csrc/contact_fold.cu``), K2 (``csrc/chain_lookup.cu``),
K3 (``csrc/block_merge.cu``, and through its second entry point the merge
on a packed block image, P4), K5 (``csrc/select_cells.cu``), K7
(``csrc/block_copy.cu``), the map pool's row copy K8
(``csrc/row_copy.cu``: bit for bit, a mask off touches no byte, replayed
in a CUDA graph with a changing mask, past 2^31 elements, and
copy-on-write with rollover against the CPU) and the cloud merge
(``csrc/cloud_merge.cu``: K3's result bit for bit on clouds K3 takes, a
307,200-point cloud against the CPU and bit for bit from run to run and
in a CUDA graph, and at the 4,000-block colour pool's shape, whose
offsets pass 2^32) against their plain PyTorch
versions on the card, and short GPU-vs-CPU runs of the localisation and SLAM paths and
of the application API's contact update.  The backend: every pose-graph
solver and ``scan_align`` on the card against the CPU port, the solvers
under a global TF32 flag, no host sync in the dense and PCG solves, and
a checkpoint resumed on the card; every solver, ``scan_align`` and the
keyframe manager as CUDA graphs bit for bit their eager runs, two
graphs of one solve alike, and the caller's linear algebra library
restored after a solve.  The log runtime: a log read onto the
card by ``frames_from_log`` equals the CPU read bit for bit, and
``chain_layers`` on a bfloat16 pool on the card equals the CPU's.  The
application as CUDA graphs (``EmbodiedSlamFilter(graph=True)``) equals
the eager filter bit for bit in both map modes, and so do the functions
the JAX tools and demos jit themselves (``profile_step``'s stages,
``localize_demo``'s step, ``probe_spread``'s scan, ``stat_map_test``'s
evaluation) graphed by default.  The
ordered scan S1 (``csrc/ordered_scan.cu``, one launch) equals its plain
version bit for bit on the card and on the CPU, signed zeros included,
call after call, 1,000 calls in a row and replay after replay of a CUDA
graph.  K2, K5
and K7 must match bit
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
from slam_eslam_tpu_torch.core.state import BodyContactState, ParticleSet
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
from slam_eslam_tpu_torch.ops import cloud_merge as cm
from slam_eslam_tpu_torch.ops import contact_fold as cf
from slam_eslam_tpu_torch.ops import ordered_scan as osc
from slam_eslam_tpu_torch.ops import row_copy as rc
from slam_eslam_tpu_torch.ops import select_cells as sc
from slam_eslam_tpu_torch.utils import graphs, tree

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


# ------------------------------------------------- row copy (copy-on-write)

ROW_MASKS = ("none", "one", "some", "all")


def row_fields(dev, dtype, with_color, b, nx=20, nyk=44, seed=0):
    """A pool's fields as ``ops.row_copy`` takes them: mean, stdev, height
    (``dtype``), meta (int32), colour (``dtype``) where asked, origin
    ``[B, 2]`` float32; seeded."""
    gen = torch.Generator(dev).manual_seed(seed)
    f = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)
    fields = [f(b, nx, nyk), f(b, nx, nyk), f(b, nx, nyk),
              torch.randint(-2 ** 30, 2 ** 30, (b, nx, nyk), generator=gen,
                            device=dev, dtype=torch.int32)]
    if with_color:
        fields.append(f(b, nx, nyk * 3))
    fields.append(torch.randn((b, 2), generator=gen, device=dev))
    return fields


def row_case(dev, n, b, pattern, form, seed=0):
    """``(dst, src, mask)``: unique ``dst`` in the pool's upper half,
    ``src`` in its lower half (pairs of rows sharing one with ``shared``,
    None for the fill form), ``mask`` as ``pattern`` says."""
    gen = torch.Generator(dev).manual_seed(seed)
    dst = (b // 2 + torch.randperm(b - b // 2, generator=gen, device=dev)[:n]
           ).to(torch.int32)
    src = torch.randint(0, b // 2, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    if form == "shared":
        src = src.div(2, rounding_mode="floor") * 2
        src[1::2] = src[0::2][:n // 2]
    if form == "fill":
        src = None
    mask = {"none": torch.zeros(n, dtype=torch.bool, device=dev),
            "one": torch.arange(n, device=dev) == n // 3,
            "some": torch.rand(n, generator=gen, device=dev) < 0.3,
            "all": torch.ones(n, dtype=torch.bool, device=dev)}[pattern]
    return dst, src, mask


def as_bytes(fields):
    return [f.view(torch.uint8) for f in fields]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_color", [False, True])
@pytest.mark.parametrize("pattern", ROW_MASKS)
@pytest.mark.parametrize("form", ["copy", "shared", "fill", "fill_values"])
def test_row_copy_matches_plain(dev, dtype, with_color, pattern, form):
    """The kernel against its plain version, bit for bit: copies (sources
    shared by several rows too) and fills (zeros, or given rows), with
    masks that select none, one, some and every row."""
    n, b = 300, 700
    fields = row_fields(dev, dtype, with_color, b, seed=n)
    dst, src, mask = row_case(dev, n, b, pattern,
                              "fill" if form == "fill_values" else form)
    fill = None
    if form == "fill_values":
        fill = [None] * (len(fields) - 1) + [
            torch.randn((n, 2), device=dev)]
        fill[0] = torch.randn((n,) + fields[0].shape[1:],
                              device=dev).to(dtype)
    want = rc.row_copy_reference([f.clone() for f in fields], dst, src,
                                 mask, fill)
    before = rc.row_copy.launches
    got = rc.row_copy(fields, dst, src, mask, fill=fill)
    assert rc.row_copy.launches == before + 1
    torch.cuda.synchronize()
    for g, w_ in zip(as_bytes(got), as_bytes(want)):
        assert torch.equal(g, w_)


@pytest.mark.parametrize("nyk", [7, 44])
def test_row_copy_touches_no_unmasked_block(dev, nyk):
    """Canary bytes in every block: with no row masked the pool is
    unchanged byte for byte; with some, every block outside the masked
    ``dst`` is, in the copy and the fill form.  ``nyk = 7`` gives bfloat16
    rows of 280 bytes, moved in 8-byte units, and more rows than one
    window of the kernel."""
    n, b = 5000, 10_001
    fields = row_fields(dev, torch.bfloat16, True, b, nx=20, nyk=nyk)
    for f in fields:
        f.view(torch.uint8).fill_(0x5A)
    for pattern, form in (("none", "copy"), ("none", "fill"),
                          ("some", "copy"), ("some", "fill")):
        dst, src, mask = row_case(dev, n, b, pattern, form, seed=1)
        start = [f.clone() for f in fields]
        for f in fields:          # sources differ from the canaries
            f[:b // 2].view(torch.uint8).fill_(0x33)
        rc.row_copy(fields, dst, src, mask)
        torch.cuda.synchronize()
        written = torch.zeros(b, dtype=torch.bool, device=dev)
        written[dst[mask].long()] = True
        for f, s in zip(fields, start):
            keep = ~written
            keep[:b // 2] = False
            assert torch.equal(f[keep].view(torch.uint8),
                               s[keep].view(torch.uint8))
        if pattern == "none":
            assert not written.any()
        else:
            assert written.sum() > 1000
            for f in fields:
                assert (f[written].view(torch.uint8)
                        == (0 if form == "fill" else 0x33)).all()
            for f in fields:      # the next round's canaries
                f[b // 2:].view(torch.uint8).fill_(0x5A)


def test_row_copy_replays_in_a_cuda_graph(dev):
    """Captured once, replayed with a mask that changes between replays:
    each replay moves the rows its mask selects, as the plain version
    does."""
    n, b = 1000, 2100
    fields = row_fields(dev, torch.float32, False, b, nx=40, nyk=64, seed=3)
    dst, src, mask = row_case(dev, n, b, "none", "copy", seed=3)
    static = mask.clone()
    rc.row_copy(fields, dst, src, static)               # built, warmed
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        rc.row_copy(fields, dst, src, static)
    gen = torch.Generator(dev).manual_seed(4)
    for share in (0.0, 0.001, 0.03, 1.0, 0.3):
        want = rc.row_copy_reference(
            [f.clone() for f in fields], dst, src,
            torch.rand(n, generator=gen.manual_seed(int(share * 1e4)),
                       device=dev) < share)
        static.copy_(torch.rand(n, generator=gen.manual_seed(
            int(share * 1e4)), device=dev) < share)
        g.replay()
        torch.cuda.synchronize()
        for f, w_ in zip(fields, want):
            assert torch.equal(f.view(torch.uint8), w_.view(torch.uint8))


def test_row_copy_past_2_31_elements(dev):
    """The 100,000-particle pool's shape (``chip_smoke.check_big_kernels``):
    400,000 blocks of 40 x 40 x 4 slots, an int32 meta image of 2.56e9
    elements and a bfloat16 field, so element offsets pass 2^31 from block
    335,545 on and byte offsets 2^32 sooner.  Masked rows copy from and
    into blocks on both sides of that line, then others are filled; every
    block is then checked against what it must hold, 25,000 at a time."""
    b, n, per = 400_000, 100_000, 40 * 160
    far = 2 ** 31 // per + 1
    meta = torch.empty((b, 40, 160), dtype=torch.int32, device=dev)
    mean = torch.empty((b, 40, 160), dtype=torch.bfloat16, device=dev)
    origin = torch.empty((b, 2), dtype=torch.float32, device=dev)
    e = torch.arange(per, device=dev).reshape(40, 160)

    def content(ids):
        """Each block's pattern from its id (-1: zeros)."""
        i = ids.long()[:, None, None]
        m = torch.where(i >= 0, i * 4096 + e % 4096, 0).to(torch.int32)
        f = torch.where(i >= 0, (i % 200 + e % 50).float(), 0.0)
        o = torch.where(ids[:, None] >= 0, ids.float()[:, None]
                        * torch.tensor([1.0, -1.0], device=dev), 0.0)
        return m, f.to(torch.bfloat16), o

    step = 25_000
    for lo in range(0, b, step):
        ids = torch.arange(lo, lo + step, device=dev)
        meta[lo:lo + step], mean[lo:lo + step], origin[lo:lo + step] = (
            content(ids))
    gen = torch.Generator(dev).manual_seed(5)
    # the pool's last blocks written, from both sides of the line
    last = torch.arange(b - 4, b, device=dev)
    firsts = torch.tensor([far + 11, 3, b - 100], device=dev)
    perm = torch.randperm(b, generator=gen, device=dev)
    perm = perm[~torch.isin(perm, torch.cat([last, firsts]))]
    dst = torch.cat([last, perm[:n - 4]]).to(torch.int32)
    src = perm[n - 4:2 * n - 4].to(torch.int32)
    src[1:4] = firsts.to(torch.int32)
    mask = torch.rand(n, generator=gen, device=dev) < 0.05
    mask[:8] = True
    fills = mask & (torch.arange(n, device=dev) % 7 == 0)
    copies = mask & ~fills
    moved = dst[mask]
    assert int((moved >= far).sum()) > 100
    assert int((src[copies] >= far).sum()) > 100
    rc.row_copy((meta, mean, origin), dst, src, copies)
    rc.row_copy((meta, mean, origin), dst, None, fills)
    want_id = torch.arange(b, device=dev)
    want_id[dst[copies].long()] = src[copies].long()
    want_id[dst[fills].long()] = -1
    torch.cuda.synchronize()
    for lo in range(0, b, step):
        m, f, o = content(want_id[lo:lo + step])
        assert torch.equal(meta[lo:lo + step], m)
        assert torch.equal(mean[lo:lo + step].view(torch.int16),
                           f.view(torch.int16))
        assert torch.equal(origin[lo:lo + step], o)


@pytest.mark.parametrize("with_color", [False, True])
def test_own_heads_equals_cpu(dev, with_color):
    """``streaming.own_heads`` (copy-on-write, then rollover) on a pool
    on the card against the same call on a CPU clone of it, bit for bit:
    a resampling shares heads and some particles leave their grid."""
    n, b = 64, 256
    pool = sim.random_pool(n, b, nx=8, ny=8, k=4, resolution=0.25, seed=9)
    if with_color:
        pool = dataclasses.replace(pool, color=torch.rand(
            (b, 8, 8 * 4 * 3), generator=torch.Generator().manual_seed(9)))
    gen = torch.Generator().manual_seed(10)
    pool.resample_(torch.sort(torch.randint(0, n, (n,), generator=gen))
                   .values)
    xy = sim.poses_on_heads(pool, 1.0, seed=11)[0]
    p = ParticleSet.zeros(n).with_xy(xy)
    cfg = dataclasses.replace(Config(), grid_size=2.0, grid_resolution=0.25)
    on_card = tree.to(pool, dev)
    heads = pool.active().clone()
    want, want_failed = streaming.own_heads(cfg, pool, p)
    before = rc.row_copy.launches
    got, failed = streaming.own_heads(cfg, on_card, tree.to(p, dev))
    assert rc.row_copy.launches == before + 2
    torch.cuda.synchronize()
    assert int((want.active() != heads).sum()) > 10
    for f in pool.data_fields() + ("origin", "allocated", "chain"):
        assert torch.equal(getattr(got, f).cpu().view(torch.uint8),
                           getattr(want, f).view(torch.uint8)), f
    assert int(failed) == int(want_failed) == 0


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
    """The raw launches of K1, K5, K2, K3 and S1 allocate nothing and read
    nothing back, so a CUDA graph captures them; a replay gives the eager
    result, and S1's every replay."""
    packed, q, act, mv, onehot = fold_case(4096, 1.0, 11, dev)
    seg = cf.segment_ids(onehot)
    ref = cf.contact_fold(packed, q, act, mv, seg=seg, correction=0.33)
    flat = tuple(a.reshape(-1).contiguous() for a in q)
    sel_ref = sc.select_cells(packed, flat, 3.0)
    out = torch.zeros_like(ref)
    outs = tuple(torch.zeros_like(t) for t in sel_ref)
    # K2 and K3 on a SLAM pool: the merge in place on a copy
    pool, (blk, lx, ly, w, wz) = merge_setup(1024, 64, 12, dev, seed=11)
    cq = sim.chain_queries(pool, 8, seed=11)
    cargs = (pool.mean, pool.stdev, pool.meta, pool.origin, pool.resolution,
             pool.chain, cq)
    chain_ref = cl.chain_lookup(*cargs, k=4, z_window=1.0, with_slot=True)
    chain_outs = tuple(torch.zeros_like(t) for t in chain_ref)
    fields = [pool.mean, pool.stdev, pool.height, pool.meta]
    merged = [f.clone() for f in fields]
    bm.block_merge(*merged, None, blk, lx, ly, w, wz, 5, k=4)
    work = [f.clone() for f in fields]
    uidx = torch.full((), 5, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    counts = lambda: (cf.contact_fold.launches, sc.select_cells.launches,
                      cl.chain_lookup.launches, bm.block_merge.launches)
    before = counts()
    with torch.cuda.graph(graph):
        cf.launch(packed, q, act, mv, seg, out, 0.33)
        sc.launch(packed, flat, outs, 3.0)
        cl.launch(*cargs, chain_outs, k=4, z_window=1.0)
        bm.launch(*work, None, blk, lx, ly, w, wz, uidx, k=4)
    assert counts() == tuple(b + 1 for b in before)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    for a, b in zip(outs + chain_outs + tuple(work),
                    sel_ref + chain_ref + tuple(merged)):
        assert torch.equal(a, b)
    # S1 at one tile and at many: each replay gives the eager bits again
    for n in (4096, 100_000, 2_100_000):
        w = scan_weights(n, signed=True).to(dev)
        scan_ref = osc.ordered_scan(w)
        scan_out = torch.zeros_like(w)
        state = osc.device_state(dev, n)
        scan_graph = torch.cuda.CUDAGraph()
        before = osc.ordered_scan.launches
        with torch.cuda.graph(scan_graph):
            osc.launch(w, scan_out, state)
        assert osc.ordered_scan.launches == before + 1
        for _ in range(3):
            scan_out.zero_()
            scan_graph.replay()
            torch.cuda.synchronize()
            assert bitwise(scan_out, scan_ref)


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


# ---- K3 at every point count the paths give it and around the warp's
# edges, against the plain version on the CPU, whose run sums go in point
# order as the kernel's do (the card's plain version sums with atomics):
# meta, mean and height bit for bit, stdev within one step (PyTorch's
# vectorised CPU sqrt is not correctly rounded)

def steps(a, b):
    """Largest distance in steps of the storage type (float32 or
    bfloat16 bit patterns)."""
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return int((a.cpu().view(view).long() - b.view(view).long()).abs().max())


def assert_merge_equals_cpu(kern, cpu, label):
    for name, a, b in zip(("mean", "stdev", "height", "meta"), kern, cpu):
        assert steps(a, b) <= (1 if name == "stdev" else 0), (label, name)


def merge_vs_cpu(pool, ops, update_idx=5, color=None, pcolor=None):
    """K3 on the card and its plain version on the CPU, from the same
    pool: ``(card fields, CPU fields)`` (colour last where given)."""
    fields = [pool.mean, pool.stdev, pool.height, pool.meta]
    kern = [f.clone() for f in fields]
    cpu = [f.cpu() for f in fields]
    kc = None if color is None else color.clone()
    cc = None if color is None else color.cpu()
    before = bm.block_merge.launches
    bm.block_merge(*kern, kc, *ops, update_idx, pcolor, k=pool.k)
    assert bm.block_merge.launches == before + 1
    bm.block_merge_reference(*cpu, cc, *(a.cpu() for a in ops), update_idx,
                             None if pcolor is None else pcolor.cpu(),
                             k=pool.k)
    torch.cuda.synchronize()
    if color is not None:
        kern.append(kc)
        cpu.append(cc)
    return kern, cpu


@pytest.mark.parametrize("p", [1, 31, 32, 33, 64, 65, 192, 2048, 16384])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_merge_point_counts_match_cpu(dev, p, dtype):
    n = 64 if p > 2048 else 512
    pool, ops = merge_setup(n, p, 12, dev, seed=p, dtype=dtype)
    kern, cpu = merge_vs_cpu(pool, ops)
    assert int((kern[3] != pool.meta).sum()) > 0
    assert_merge_equals_cpu(kern, cpu, f"P={p}")


@pytest.mark.parametrize("p", [40, 64, 100])
def test_block_merge_one_cell_hit_by_every_point(dev, p):
    """Runs as long as the cloud, longer than a warp past P = 32."""
    pool, (blk, lx, ly, w, wz) = merge_setup(256, p, 12, dev, seed=p)
    lx = torch.full_like(lx, 5)
    ly = (torch.arange(256, device=dev, dtype=torch.int32) % 12)[:, None]
    ly = ly.expand(-1, p).contiguous()
    kern, cpu = merge_vs_cpu(pool, (blk, lx, ly, w, wz))
    # one slot of one cell per particle
    assert int((kern[3] != pool.meta).sum()) == 256
    assert_merge_equals_cpu(kern, cpu, f"one cell, P={p}")


def test_block_merge_masked_points_and_void_blocks(dev):
    """Points out of range and particles whose block is -1 (or past the
    pool) change nothing."""
    pool, (blk, lx, ly, w, wz) = merge_setup(512, 64, 12, dev, seed=4)
    fields = [pool.mean, pool.stdev, pool.height, pool.meta]
    out = torch.full_like(lx, 12)
    kern, _ = merge_vs_cpu(pool, (blk, out, ly, w, wz))
    for a, b in zip(kern, fields):
        assert torch.equal(a, b)
    void = blk.clone()
    void[::2] = -1
    void[1::4] = pool.b
    kern = [f.clone() for f in fields]
    bm.block_merge(*kern, None, void, lx, ly, w, wz, 5, k=4)
    # the plain version takes only valid blocks: the particles that have one
    live = slice(3, None, 4)
    cpu = [f.cpu() for f in fields]
    bm.block_merge_reference(*cpu, None, *(a[live].cpu() for a in (
        blk, lx, ly, w, wz)), 5, k=4)
    torch.cuda.synchronize()
    assert_merge_equals_cpu(kern, cpu, "void blocks")
    idle = torch.ones(pool.b, dtype=torch.bool, device=dev)
    idle[blk[live].long()] = False
    assert torch.equal(kern[3][idle], pool.meta[idle])
    assert not torch.equal(kern[3], pool.meta)


@pytest.mark.parametrize("p", [64, 192])
def test_block_merge_colour_pool_matches_cpu(dev, p):
    pool, ops = merge_setup(256, p, 12, dev, seed=p + 1)
    gen = torch.Generator(dev).manual_seed(p)
    color = torch.rand(pool.mean.shape[:2] + (pool.mean.shape[2] * 3,),
                       generator=gen, device=dev)
    pcolor = torch.rand((p, 3), generator=gen, device=dev)
    kern, cpu = merge_vs_cpu(pool, ops, color=color, pcolor=pcolor)
    assert_merge_equals_cpu(kern[:4], cpu[:4], f"colour P={p}")
    torch.testing.assert_close(kern[4].cpu(), cpu[4], rtol=1e-6, atol=1e-7)
    assert not torch.equal(kern[4], color)


@pytest.mark.parametrize("p", [1, 33, 65, 2048])
def test_block_merge_packed_point_counts(dev, p):
    """The packed entry at point counts on either side of the warp: K3 on
    the unpacked fields, bit for bit."""
    pool, (blk, lx, ly, w, wz) = merge_setup(256, p, 12, dev, seed=p + 2)
    fields = [pool.mean, pool.stdev, pool.height, pool.meta]
    packed = bm.pack_fields(*fields)
    unpacked = [f.clone() for f in fields]
    bm.block_merge_packed(packed, blk, lx, ly, w, wz, 5, nx=12, k=4)
    bm.block_merge(*unpacked, None, blk, lx, ly, w, wz, 5, k=4)
    torch.cuda.synchronize()
    for a, b in zip(bm.packed_fields(packed, 12), unpacked):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert not torch.equal(unpacked[3], pool.meta)


# ---- K2: void chains, hits only at the tail, queries off every block,
# K = 1 and 2, bfloat16; bit for bit against the plain version, slot
# index included

def chain_vs_plain(pool, q, k, label):
    args = (pool.mean, pool.stdev, pool.meta, pool.origin, pool.resolution,
            pool.chain, q)
    got = cl.chain_lookup(*args, k=k, z_window=1.0, with_slot=True)
    ref = cl.chain_lookup_reference(*args, k=k, z_window=1.0, with_slot=True)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b), label
    return got


def test_chain_lookup_every_level_void(dev):
    pool = sim.random_pool(1000, 4000, 12, 12, seed=1, device=dev)
    q = sim.chain_queries(pool, 8, seed=1)
    pool.chain.fill_(-1)
    found, mean, stdev, slot = chain_vs_plain(pool, q, 4, "void")
    assert not found.any() and not mean.any() and not stdev.any()
    assert bool((slot == -1).all())


def test_chain_lookup_entries_past_the_pool_are_void(dev):
    """The kernel skips a chain entry at or past ``num_blocks`` as it
    skips -1 (the plain version takes only -1)."""
    pool = sim.random_pool(1000, 4000, 12, 12, seed=5, device=dev)
    q = sim.chain_queries(pool, 8, seed=5)
    pool.chain[::3, 1] = -1
    ref = chain_vs_plain(pool, q, 4, "void entries")
    pool.chain[::3, 1] = pool.b
    pool.chain[1::3, 1] = torch.where(pool.chain[1::3, 1] < 0, pool.b + 7,
                                      pool.chain[1::3, 1])
    got = cl.chain_lookup(pool.mean, pool.stdev, pool.meta, pool.origin,
                          pool.resolution, pool.chain, q, k=4, z_window=1.0,
                          with_slot=True)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chain_lookup_hits_only_at_the_tail(dev, dtype):
    """Head and middle blocks lie far from the queries, the tail under
    them: every hit is at the last level."""
    n, nx = 1000, 12
    pool = sim.random_pool(n, 4 * n, nx, nx, seed=2, device=dev, dtype=dtype)
    ids = torch.arange(n, device=dev, dtype=torch.int32)
    pool.chain = torch.stack([ids, n + ids, 2 * n + ids], 1).contiguous()
    pool.origin[:2 * n] = 1000.0
    pool.origin[2 * n:3 * n] = 0.0
    size = nx * pool.resolution
    gen = torch.Generator(dev).manual_seed(2)
    q = (size * torch.rand((n, 8), generator=gen, device=dev),
         size * torch.rand((n, 8), generator=gen, device=dev),
         0.3 + 0.05 * torch.randn((n, 8), generator=gen, device=dev))
    found, _, _, slot = chain_vs_plain(pool, q, 4, "tail")
    assert 0.1 < float(found.float().mean()) < 1.0
    per_block = nx * nx * 4
    assert torch.equal(slot[found] // per_block,
                       (2 * n + ids.long())[:, None].expand_as(slot)[found])


def test_chain_lookup_queries_off_every_block(dev):
    pool = sim.random_pool(1000, 4000, 12, 12, seed=3, device=dev)
    x, y, z = sim.chain_queries(pool, 8, seed=3)
    found, _, _, _ = chain_vs_plain(pool, (x + 1e4, y - 1e4, z), 4, "off")
    assert not found.any()


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chain_lookup_slot_counts(dev, k, dtype):
    pool = sim.random_pool(2000, 8000, 12, 12, k=k, seed=k, device=dev,
                           dtype=dtype)
    found, _, _, _ = chain_vs_plain(pool, sim.chain_queries(pool, 8, seed=k),
                                    k, f"k={k}")
    assert 0.05 < float(found.float().mean()) < 0.95


# ---------------------------------------------------------------- backend

def _pose_err(a, b):
    d = a.double().cpu() - b.double().cpu()
    d[:, -1] = torch.atan2(torch.sin(d[:, -1]), torch.cos(d[:, -1]))
    return float(d.abs().max())


@pytest.mark.parametrize("dim", [3, 4])
@pytest.mark.parametrize("solver", ["dense", "dense dcs", "pcg", "schur"])
def test_pose_graph_solvers_match_cpu(dev, dim, solver):
    """Every solver on a 256-node circle with closures and an outlier
    closure: the card within 1e-3 (m, rad) of the CPU port, chi2 history
    within rtol 1e-4 (the card's scatter-adds sum in another order)."""
    from slam_eslam_tpu_torch.backend import pose_graph as pg

    solve = {"dense": lambda g: pg.optimize(g, 10),
             "dense dcs": lambda g: pg.optimize(g, 10, robust="dcs"),
             "pcg": lambda g: pg.optimize_cg(g, 10, cg_iters=64),
             "schur": lambda g: pg.optimize_schur(g, 10, segments=8,
                                                  boundary_cap=32)}[solver]
    g, _ = sim.circle_pose_graph(dim, 256, seed=3, outlier=True, device=dev)
    got, hist = solve(g)
    ref, ref_hist = solve(tree.to(g, "cpu"))
    assert got.nodes.device == dev
    assert _pose_err(got.nodes, ref.nodes) < 1e-3
    np.testing.assert_allclose(hist.cpu().numpy(), ref_hist.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_pose_graph_ignores_the_global_tf32_flag(dev):
    """The solvers compute in float32 without TF32 whatever the caller's
    ``allow_tf32``, and give the flag back as they found it."""
    from slam_eslam_tpu_torch.backend import pose_graph as pg

    g, _ = sim.circle_pose_graph(3, 256, seed=3, outlier=True, device=dev)
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        off, off_hist = pg.optimize(g, 10)
        torch.backends.cuda.matmul.allow_tf32 = True
        on, on_hist = pg.optimize(g, 10)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert _pose_err(on.nodes, off.nodes) < 1e-5
    np.testing.assert_allclose(on_hist.cpu().numpy(),
                               off_hist.cpu().numpy(), rtol=1e-6)


def test_dense_and_pcg_optimize_put_no_host_sync(dev):
    from slam_eslam_tpu_torch.backend import pose_graph as pg

    g, _ = sim.circle_pose_graph(3, 256, seed=3, outlier=True, device=dev)
    pg.optimize(g, 2)
    pg.optimize_cg(g, 2, cg_iters=8)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pg.optimize(g, 3, robust="dcs")
        pg.optimize_cg(g, 3, cg_iters=8)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("steps_xy", [9, 31])
def test_scan_align_matches_cpu(dev, steps_xy):
    from slam_eslam_tpu_torch.backend import pose_graph as pg

    grid = sim.terrain_grid(terrain, nx=48, ny=48, resolution=0.2,
                            origin=(-4.8, -4.8), k=2)
    rng = np.random.default_rng(4)
    n = 1024
    xy = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    z = terrain(xy[:, 0] + 0.2, xy[:, 1] - 0.1).astype(np.float32)
    cloud = PatchCloud.create(
        xy=torch.from_numpy(xy), z=torch.from_numpy(z),
        stdev=torch.full((n,), 0.05),
        valid=torch.from_numpy(np.arange(n) < 900))
    kw = dict(search_xy=0.5 * steps_xy / 9, steps_xy=steps_xy, steps_yaw=7,
              return_ratio=True)
    ref = pg.scan_align(grid, cloud, torch.zeros(2), 0.0, 0.0, **kw)
    got = pg.scan_align(tree.to(grid, dev), tree.to(cloud, dev),
                        torch.zeros(2, device=dev), 0.0, 0.0, **kw)
    np.testing.assert_allclose(got[0].cpu().numpy(), ref[0].numpy(),
                               atol=1e-6)
    assert abs(float(got[1]) - float(ref[1])) <= 1e-6
    for a, b in zip(got[2:], ref[2:]):
        assert abs(float(a) - float(b)) <= 1e-5


def same_bits(a, b):
    """Every tensor of ``a`` equal to ``b``'s bit for bit."""
    return graphs.equal_bits(a, b)[0]


POSE_SOLVES = {
    "dense": lambda g, cg: _pg().optimize(g, 10, cuda_graphs=cg),
    "dense dcs": lambda g, cg: _pg().optimize(g, 10, robust="dcs",
                                              cuda_graphs=cg),
    "pcg": lambda g, cg: _pg().optimize_cg(g, 10, cg_iters=64,
                                           cuda_graphs=cg),
    "schur": lambda g, cg: _pg().optimize_schur(g, 10, segments=8,
                                                boundary_cap=32,
                                                cuda_graphs=cg)}


def _pg():
    from slam_eslam_tpu_torch.backend import pose_graph as pg

    return pg


@pytest.mark.parametrize("dim", [3, 4])
@pytest.mark.parametrize("solver", sorted(POSE_SOLVES))
def test_graphed_pose_graph_solve_equals_eager(dev, dim, solver):
    """Each solver at 256 nodes as one CUDA graph (eager, captured,
    replayed, then on another graph): bit for bit the eager solve; two
    eager solves and two graphs of the same solve alike bit for bit (the
    scatter-adds add in index order)."""
    solve = POSE_SOLVES[solver]
    cgs = [graphs.CallGraphs(graphs.Capture(), "test") for _ in range(2)]
    for seed in (3, 3, 3, 4):
        g, _ = sim.circle_pose_graph(dim, 256, seed=seed, outlier=True,
                                     device=dev)
        ref = solve(g, None)
        assert same_bits(solve(g, None), ref)
        for cg in cgs:
            assert same_bits(solve(g, cg), ref)
    assert cgs[0].counts() == dict(eager=1, captured=1, replayed=3)


def test_graphed_scan_align_equals_eager(dev):
    pg = _pg()
    grid = tree.to(sim.terrain_grid(terrain, nx=48, ny=48, resolution=0.2,
                                    origin=(-4.8, -4.8), k=2), dev)
    rng = np.random.default_rng(4)
    n = 1024
    xy = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    z = terrain(xy[:, 0] + 0.2, xy[:, 1] - 0.1).astype(np.float32)
    cloud = tree.to(PatchCloud.create(
        xy=torch.from_numpy(xy), z=torch.from_numpy(z),
        stdev=torch.full((n,), 0.05),
        valid=torch.from_numpy(np.arange(n) < 900)), dev)
    cg = graphs.CallGraphs(graphs.Capture(), "test")
    for ratio in (False, True):
        for guess in ((0.0, 0.0), (0.0, 0.0), (0.1, -0.05), (0.0, 0.02)):
            xy0 = torch.tensor([guess[0], 0.0], device=dev)
            kw = dict(steps_xy=9, steps_yaw=7, return_ratio=ratio)
            got = pg.scan_align(grid, cloud, xy0, guess[1], 0.0,
                                cuda_graphs=cg, **kw)
            assert same_bits(got, pg.scan_align(grid, cloud, xy0, guess[1],
                                              0.0, **kw))
    assert cg.counts() == dict(eager=2, captured=2, replayed=6)


def test_graphed_keyframes_equal_eager(dev):
    """A keyframe manager on the card graphed (the default) and eager over
    an out-and-back route that closes loops: the same closures, graph and
    solved trajectory, bit for bit."""
    from slam_eslam_tpu_torch.backend.keyframes import KeyframeManager

    kw = dict(keyframe_distance=0.45, closure_radius=1.0, min_separation=4,
              min_score=0.3, closure_info=2000.0, device=dev)
    kms = [KeyframeManager(**kw, graph=False), KeyframeManager(**kw)]
    assert kms[1].graphed and not kms[0].graphed
    rng = np.random.default_rng(9)
    xs = list(np.arange(0, 3.1, 0.5)) + list(np.arange(2.5, -0.1, -0.5))
    for i, x in enumerate(xs):
        local = rng.uniform(-1.5, 1.5, (400, 2)).astype(np.float32)
        z = terrain(local[:, 0] + x, local[:, 1]).astype(np.float32) - 0.2
        cloud = tree.to(PatchCloud.create(
            xy=torch.from_numpy(local), z=torch.from_numpy(z),
            stdev=torch.full((400,), 0.05),
            valid=torch.ones((400,), dtype=torch.bool)), dev)
        pose = np.array([x, 0.06 * i, 0.0])
        out = [km.maybe_add_keyframe(pose, cloud, z=0.2) for km in kms]
        assert out[0] == out[1]
    assert kms[1].closures == kms[0].closures and kms[1].closures
    assert same_bits(kms[1].builder.graph, kms[0].builder.graph)
    for _ in range(3):
        (t0, h0), (t1, h1) = (km.optimize(iters=15) for km in kms)
        np.testing.assert_array_equal(t0, t1)
        assert same_bits(h0, h1)
    assert kms[1].cuda_graphs.counts()["replayed"] > 0


def test_solves_restore_the_linalg_library(dev):
    """A solve runs with cuSOLVER and gives the caller's preferred linear
    algebra library back."""
    pg = _pg()
    g, _ = sim.circle_pose_graph(3, 64, seed=3, device=dev)
    old = torch.backends.cuda.preferred_linalg_library()
    try:
        for lib in ("default", "cusolver"):
            torch.backends.cuda.preferred_linalg_library(lib)
            want = torch.backends.cuda.preferred_linalg_library()
            pg.optimize(g, 2)
            pg.optimize_schur(g, 2, segments=4, boundary_cap=16)
            assert torch.backends.cuda.preferred_linalg_library() == want
    finally:
        torch.backends.cuda.preferred_linalg_library(old)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_resume_on_the_card(dev, tmp_path, dtype):
    """Save mid-stream, run 20 frames, restore into a fresh filter on the
    card and run them again: the same centroids and pool."""
    from slam_eslam_tpu_torch.utils import checkpoint as ckpt

    cfg = dataclasses.replace(
        Config(), particle_count=256, min_effective=128, grid_size=4.0,
        grid_resolution=0.25, map_pool_blocks=1024, map_chain_length=3,
        map_pool_dtype=dtype,
        contact_model=ContactModelConfig(contact_point_radius=0.0,
                                         min_contacts=2))
    asg = AsguardSim(terrain=terrain)
    z0 = float(asg.position[2])
    q = np.array([1.0, 0, 0, 0], np.float32)
    meta = (np.float32(-np.pi / 2), np.float32(np.pi / 32))
    fr = []

    def cb(s):
        fr.append([s.contact_state(), q, s.position.astype(np.float32),
                   np.full(32, 1.5, np.float32), meta, False])

    for _ in range(8):
        asg.step(wheel_delta=0.5, substeps=5, on_substep=cb)
        fr[-1][5] = True
    frames = tree.to(streaming.stack_frames([tuple(f) for f in fr]), dev)

    def make():
        return EmbodiedSlamFilter(config=cfg, device=dev).init(
            pose=(np.array([0.0, 0.0, z0]), 0.0),
            use_shared_map=False)

    f = make()
    f.run_stream(frames.at(slice(0, 20)))
    ckpt.save_filter(tmp_path / "f.pt", f)
    a1 = f.run_stream(frames.at(slice(20, 40)))
    g = make()
    ckpt.restore_filter(tmp_path / "f.pt", g)
    assert g.pool.mean.device == dev
    a2 = g.run_stream(frames.at(slice(20, 40)))
    assert torch.equal(a1["centroid"], a2["centroid"])
    for name in ("mean", "stdev", "height", "meta", "chain", "origin"):
        assert torch.equal(getattr(f.pool, name), getattr(g.pool, name)), name


def record_log(path, steps=2, image_every=4):
    """A traverse through the native log: contact, orientation and pose on
    every frame, a scan, a distance image and a texture on every fourth."""
    from slam_eslam_tpu_torch.io import logio

    s = AsguardSim(terrain=terrain)
    q = np.array([1.0, 0, 0, 0], np.float32)
    count = [0]
    with logio.LogWriter(path) as w:

        def frame(sim_):
            ts = 1000 + 10 * count[0]
            count[0] += 1
            w.write_contact_state(sim_.contact_state(), ts)
            w.write_orientation(q, ts)
            w.write_pose(sim_.position, q, ts)
            if count[0] % image_every == 0:
                w.write_scan(np.full(16, 2.0 + 0.01 * count[0]), -1.5, 0.2,
                             ts)
                w.write_distance_image(np.full((4, 6), 1.5), 0.1, 0.1,
                                       -0.25, -0.15, ts)
                w.write_texture_image(np.full((4, 6, 3), 0.3), ts)

        for _ in range(steps):
            s.step(wheel_delta=0.3, on_substep=frame)
    return count[0]


def test_frames_from_log_onto_the_card(dev, tmp_path):
    """The log read onto the card equals, bit for bit, the same log read
    onto the CPU, host copies included."""
    path = str(tmp_path / "log.eslg")
    n = record_log(path)
    got, ts, intr = streaming.frames_from_log(path, camera=True,
                                              texture=True, device=dev)
    ref, ts_h, intr_h = streaming.frames_from_log(path, camera=True,
                                                  texture=True, device="cpu")
    assert len(got) == n and got.q.device == dev
    assert np.array_equal(ts, ts_h) and intr == intr_h
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if f.name == "contact":
            for g in ("position", "contact", "slip", "group_id", "valid"):
                assert getattr(a, g).device == dev
                assert torch.equal(getattr(a, g).cpu(), getattr(b, g)), g
        elif isinstance(b, torch.Tensor):
            assert a.device == dev and torch.equal(a.cpu(), b), f.name
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)


def test_chain_layers_on_a_bfloat16_pool(dev):
    """``viz.render.chain_layers`` on a bfloat16 pool on the card equals
    the CPU's, and adds only its blocks' rows to the card's memory."""
    from slam_eslam_tpu_torch.viz import render

    pool = sim.random_pool(64, 256, 10, 8, k=4, resolution=0.25,
                           chain_len=3, seed=5, device="cpu",
                           dtype=torch.bfloat16)
    on_card = tree.to(pool, dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for i in range(pool.n):
        got, ref = render.chain_layers(on_card, i), render.chain_layers(
            pool, i)
        assert len(got) == len(ref)
        for (z, ext), (z_r, ext_r) in zip(got, ref):
            np.testing.assert_array_equal(z, z_r)
            assert ext == ext_r
    rise = torch.cuda.max_memory_allocated() - base
    # three blocks' meta and mean rows a call, with the allocator's
    # rounding: far below the pool's 0.35 MB mask
    assert rise < (2 << 20)


def scan_weights(n, signed=False):
    """Softmax weights seeded by ``n``; ``signed``: zeros of both signs in
    the first 15 elements of every tile of 4,096 and, above two tiles, a
    first tile of ``-0.0``."""
    g = torch.Generator().manual_seed(n)
    w = torch.softmax(2.5 * torch.randn((n,), generator=g), 0)
    if signed:
        i = torch.arange(n)
        w = torch.where(i % osc.TILE < 15,
                        torch.where(i % 3 == 1, 0.0, -0.0), w)
        if n > 2 * osc.TILE:
            w[:osc.TILE] = -0.0
    return w


def bitwise(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("n", [1, 2, 16, 17, 127, 129, 256, 257, 4095, 4096,
                               4097, 8192, 8193, 65_536, 65_537, 100_000,
                               100_003, 140_000, 16 * 4096 * 17 + 3,
                               2_100_000])
def test_ordered_scan_matches_plain_bitwise(dev, n, signed):
    """S1 against its plain version (run on the card and on the CPU) bit
    for bit, signed zeros included, across the tile size, the levels of
    the order and more than 16 tiles per level above the tile; two calls
    on the same weights give the same bits; one kernel launch a call."""
    w = scan_weights(n, signed)
    wd = w.to(dev)
    before = osc.ordered_scan.launches
    got = osc.ordered_scan(wd)
    assert osc.ordered_scan.launches == before + 1
    again = osc.ordered_scan(wd)
    assert bitwise(got, again)
    assert bitwise(got.cpu(), osc.ordered_scan_reference(w))
    assert bitwise(got, osc.ordered_scan_reference(wd))


def test_ordered_scan_of_an_unaligned_view(dev):
    """A view that starts one float into its storage (no 16-byte row
    loads) scans like a fresh tensor."""
    w = scan_weights(100_001)
    got = osc.ordered_scan(w.to(dev)[1:])
    assert bitwise(got.cpu(), osc.ordered_scan_reference(w[1:].clone()))


@pytest.mark.parametrize("n", [4097, 100_000])
def test_ordered_scan_repeats_back_to_back(dev, n):
    """1,000 calls in a row give the same bits: every launch leaves the
    ticket reset and tags its records with its own generation."""
    wd = scan_weights(n).to(dev)
    want = osc.ordered_scan(wd).view(torch.int32)
    differ = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(1000):
        differ += (osc.ordered_scan(wd).view(torch.int32) != want).sum()
    assert int(differ) == 0


def test_ordered_scan_sizes_in_turn(dev):
    """Larger and smaller launches in turn share the state: a launch that
    leaves records of a larger one unused clears them, so no later launch
    takes one for its own."""
    sizes = (2_100_000, 100_000, 8193, 4096, 100_000, 2_100_000, 5000)
    weights = {n: scan_weights(n, signed=True) for n in set(sizes)}
    want = {n: osc.ordered_scan_reference(w) for n, w in weights.items()}
    on_card = {n: w.to(dev) for n, w in weights.items()}
    for _ in range(3):
        for n in sizes:
            assert bitwise(osc.ordered_scan(on_card[n]).cpu(), want[n])


def test_ordered_scan_state_serves_one_stream(dev):
    """The device's state serves one stream: an eager call from another
    raises, and a call too large for the state inside a capture raises."""
    wd = scan_weights(5000).to(dev)
    osc.ordered_scan(wd)
    with torch.cuda.stream(torch.cuda.Stream(dev)):
        with pytest.raises(RuntimeError, match="one stream"):
            osc.ordered_scan(wd)
    big = scan_weights(osc.TILE * 4096 + 1).to(dev)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="before the capture"):
        with torch.cuda.graph(graph):
            osc.ordered_scan(big)
    torch.cuda.synchronize()


def test_ordered_scan_resample_repeats(dev):
    """The resampling search on the card finds the same ancestors twice,
    and the CPU's."""
    from slam_eslam_tpu_torch.core import filter as pf
    from slam_eslam_tpu_torch.tools import profile_resample

    w, pos = profile_resample.weights_and_positions(100_000, "cpu")
    a = pf.resample_from_positions(w.to(dev), pos.to(dev))
    b = pf.resample_from_positions(w.to(dev), pos.to(dev))
    assert torch.equal(a, b)
    assert torch.equal(a.cpu(), pf.resample_from_positions(w, pos))
    with pytest.raises(TypeError, match="float32"):
        osc.ordered_scan(w.to(dev, torch.float64))


# ------------------------------------------------ the compiled runners

def test_block_merge_replays_read_update_idx_from_the_device(dev):
    """K3 captured once stamps the update index the device scalar holds
    at each replay (it is read, not baked into the capture), and each
    replay equals an eager merge at that index."""
    pool, (blk, lx, ly, w, wz) = merge_setup(512, 64, 12, dev, seed=21)
    fields = [pool.mean, pool.stdev, pool.height, pool.meta]
    uidx = torch.zeros((), dtype=torch.int32, device=dev)
    work = [f.clone() for f in fields]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        bm.launch(*work, None, blk, lx, ly, w, wz, uidx, k=4)
    for value in (3, 11):
        for a, f in zip(work, fields):
            a.copy_(f)
        uidx.fill_(value)
        graph.replay()
        ref = [f.clone() for f in fields]
        bm.block_merge(*ref, None, blk, lx, ly, w, wz, value, k=4)
        torch.cuda.synchronize()
        for a, b in zip(work, ref):
            assert bitwise(a, b)
        written = work[3] != pool.meta
        assert written.any() and ((work[3][written] >> 2) == value).all()


def graph_bench_filter(dev, n, steps):
    from slam_eslam_tpu_torch import bench

    args = bench.parser().parse_args(["--particles", str(n), "--steps",
                                      str(steps)])
    cfg = bench.filter_config(args)
    grid = tree.to(sim.terrain_grid(bench.filter_terrain,
                                    **bench.FILTER_GRID), dev)
    css, qs, _, _ = bench.filter_trajectory(steps, 8)
    particles = bench.filter_particles(n)
    fresh = lambda: bench.filter_state(cfg, particles, 8, dev)
    return cfg, make_lookup(cfg, grid), tree.to(css, dev), qs.to(dev), fresh


@pytest.mark.parametrize("with_draws", [False, True],
                         ids=["generator", "draws"])
def test_graphed_scan_runner_equals_eager(dev, with_draws):
    """The localisation runner as CUDA graphs at 4,096 particles over 20
    steps equals the eager loop bit for bit: centroids, every field of the
    final state and the generator's state; its replays run under
    ``set_sync_debug_mode("error")`` and credit K1 and S1 once a step."""
    from slam_eslam_tpu_torch import ops

    n, steps = 4096, 20
    cfg, lookup, css, qs, fresh = graph_bench_filter(dev, n, steps)
    draws = None
    if with_draws:
        gen = torch.Generator().manual_seed(2)
        draws = [tree.to(steplib.StepDraws(
            pe.ProjectDraws.sample(n, gen, "cpu"),
            torch.rand(n, generator=gen)), dev) for _ in range(steps)]
    eager = steplib.make_scan_runner(cfg, lookup, graph=False)
    graphed = steplib.make_scan_runner(cfg, lookup, graph=True)
    graphed(fresh(), css, qs, draws)                 # eager first step, capture
    s_ref, s_got = fresh(), fresh()
    ref_state, ref_cents = eager(s_ref, css, qs, draws)
    torch.cuda.synchronize()
    before = ops.launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got_state, got_cents = graphed(s_got, css, qs, draws)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["contact_fold"] - before["contact_fold"] == steps
    assert after["ordered_scan"] - before["ordered_scan"] == steps
    assert graphed.graphs.counts() == dict(eager=1, captured=1,
                                           replayed=2 * steps - 1)
    assert bitwise(got_cents, ref_cents)
    for a, b in zip(graphs.leaves(got_state), graphs.leaves(ref_state)):
        assert torch.equal(a, b)
    assert torch.equal(s_got.generator.get_state(),
                       s_ref.generator.get_state())


def graph_slam_setup(dev, n, scans):
    from slam_eslam_tpu_torch import bench

    args = bench.parser().parse_args(["--mode", "slam", "--particles",
                                      str(n), "--steps", str(scans)])
    cfg = bench.slam_config(args)
    z0, frames, full, qs = bench.slam_trajectory(scans, 8)
    odos = streaming.precompute_odometry(20, tree.to(full, dev), qs.to(dev),
                                         cfg=cfg)
    return bench, cfg, z0, tree.to(frames, dev), odos


@pytest.mark.parametrize("with_draws", [False, True],
                         ids=["generator", "draws"])
def test_graphed_slam_runner_equals_eager(dev, with_draws):
    """The SLAM runner as CUDA graphs at 4,096 particles over 40 frames
    equals the eager loop bit for bit: gates, centroids, best poses, the
    filter, every pool field (``meta`` with its update indices), the
    chains and ``alloc_failed``; K2, K3, S1 and row-copy launches (two a
    mapping frame) equal the gates in the replayed run, which runs under
    ``set_sync_debug_mode("error")``."""
    from slam_eslam_tpu_torch import ops

    n = 4096
    bench, cfg, z0, frames, odos = graph_slam_setup(dev, n, 4)
    draws = None
    if with_draws:
        gen = torch.Generator().manual_seed(3)
        draws = [tree.to(steplib.StepDraws(
            pe.ProjectDraws.sample(n, gen, "cpu"),
            torch.rand(n, generator=gen)), dev) for _ in range(len(frames))]
    graphed = bench.make_slam_runner(cfg, graph=True)
    for _ in range(2):       # warm-up: every gate combination captured
        graphed(bench.slam_carry(cfg, z0, dev), frames, odos, draws)
    assert graphed.settled()
    ref = bench.make_slam_runner(cfg)(bench.slam_carry(cfg, z0, dev),
                                      frames, odos, draws)
    carry = bench.slam_carry(cfg, z0, dev)
    torch.cuda.synchronize()
    before, counts = ops.launch_counts(), graphed.counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = graphed(carry, frames, odos, draws)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert graphed.counts()["eager"] == counts["eager"]
    assert graphed.counts()["captured"] == counts["captured"]
    (gc, ga), (rc, ra) = got, ref
    n_meas, n_map = int(ra["updated"].sum()), int(ra["mapped"].sum())
    assert n_meas and n_map
    assert {k: after[k] - before[k] for k in after} == dict(
        dict.fromkeys(after, 0), chain_lookup=n_meas, block_merge=n_map,
        ordered_scan=n_meas, row_copy=2 * n_map)
    for name in ("updated", "mapped"):
        assert (ga[name] == ra[name]).all()
    assert bitwise(ga["centroid"], ra["centroid"])
    assert bitwise(ga["best_pose"], ra["best_pose"])
    for a, b in zip(graphs.leaves((gc.filter, gc.pool, gc.alloc_failed)),
                    graphs.leaves((rc.filter, rc.pool, rc.alloc_failed))):
        assert torch.equal(a, b)
    assert (gc.update_idx, gc.steps) == (rc.update_idx, rc.steps)
    assert int((gc.pool.meta >> 2).max()) == gc.update_idx - 1


def classes(x, y):
    """Terrain-class colours: class 0 west of x = 0, class 1 east."""
    east = np.asarray(x) > 0.0
    return np.stack([~east, east, np.zeros_like(east)], -1)


@pytest.mark.parametrize("shared", [False, True],
                         ids=["per_particle", "shared"])
def test_graphed_application_equals_eager(dev, shared):
    """``EmbodiedSlamFilter(graph=True)`` on the card against the eager
    filter over 40 frames at 1,024 particles, bit for bit after every
    call: ``update_contact`` with terrain labels (the slip update on a
    colour-carrying pool per particle) and the hash reinjecting,
    ``update_scan`` with the match and negative information and the
    textured ``update_distance_image`` on every fourth frame (in
    shared-map mode a camera merge into the grid, which the next
    contacts read); launch counts equal, the pool's failure count read
    without a host sync."""
    from slam_eslam_tpu_torch import ops
    from slam_eslam_tpu_torch.mapping import projection

    n, frames = 1024, 40
    slip = ContactModelConfig(contact_point_radius=0.0, min_contacts=2,
                              use_slip_update=not shared)
    cfg = dataclasses.replace(
        Config(), particle_count=n, min_effective=n // 2, grid_size=8.0,
        grid_resolution=0.25, map_pool_blocks=4 * n, map_chain_length=3,
        map_pool_color=True, use_visual_update=True,
        grid_use_negative_information=True, contact_model=slip)
    grid = sim.terrain_grid(terrain, nx=64, ny=64, resolution=0.25,
                            origin=(-8.0, -8.0), color=classes)
    traj = sim.TrajectorySim(terrain, speed=0.06, yaw_rate=0.02)
    z0 = float(traj.position[2])
    filters = [EmbodiedSlamFilter(config=cfg, device=dev, graph=g).init(
        (np.array([0.0, 0.0, z0]), 0.0), shared_grid=grid,
        use_shared_map=shared, hash_config=SurfaceHashConfig(
            use_hash=True, slope_bins=10, angular_steps=4, period=3))
        for g in (False, True)]
    laser = (np.eye(3), np.array([0.1, 0.0, 0.3]))
    camera = (np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0],
                        [0.0, -1.0, 0.0]]), np.array([0.1, 0.0, 0.35]))
    rng = np.random.default_rng(2)
    image = projection.DistanceImage(
        torch.tensor(rng.uniform(0.6, 2.4, (6, 8)), dtype=torch.float32,
                     device=dev),
        *(torch.tensor(v, device=dev) for v in (0.1, 0.1, -0.35, -0.25)))
    texture = torch.tensor(rng.uniform(0, 1, (6, 8, 3)),
                           dtype=torch.float32, device=dev)
    counts = []
    for i in range(frames):
        (pos, yaw), _ = traj.step()
        q = np.array([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)], np.float32)
        cs = tree.to(traj.contact_state(noise=0.005), dev)
        ltc = [(0, [0.8, 0.1, 0.1])] if i % 5 == 4 else None
        scan = projection.LaserScan(
            torch.tensor(rng.uniform(1.0, 2.5, 24), dtype=torch.float32,
                         device=dev), torch.tensor(-1.2, device=dev),
            torch.tensor(0.1, device=dev))
        for f in filters:
            before = ops.launch_counts()
            out = [f.update_contact((q, pos), cs, ltc)]
            if i % 4 == 1:
                out.append(f.update_scan((q, pos), scan, laser))
                out.append(f.update_distance_image((q, pos), image, camera,
                                                   texture=texture))
            after = ops.launch_counts()
            counts.append((out, {k: after[k] - before[k] for k in after}))
        assert counts[-1] == counts[-2], i
        a, b = filters
        bits = lambda t: t if t.dtype == torch.bool else (
            t.contiguous().view(-1).view(torch.uint8))
        for x, y in zip(graphs.leaves((a.state, a.pool, a.shared_grid,
                                       a.last_eval)),
                        graphs.leaves((b.state, b.pool, b.shared_grid,
                                       b.last_eval))):
            assert torch.equal(bits(x), bits(y)), i
        assert (a.update_idx, a.steps) == (b.update_idx, b.steps)
        assert torch.equal(a.state.generator.get_state(),
                           b.state.generator.get_state())
    graphed = filters[1].graphs.counts()
    assert graphed["replayed"] > frames and graphed["captured"] >= 4
    assert sum(c["ordered_scan"] for _, c in counts) > 0


def test_segment_sums_repeat_on_the_card(dev):
    """``contact_model._segment_sum`` and the per-pose ``evaluate_pose``
    that sums through it (``utils.scatter.add_at``) give the same bits on
    every call on the card, where ``index_add`` adds with atomics in no
    fixed order: 200,000 values into 300 segments, and a pose of 100,000
    contact candidates in groups of 400."""
    from slam_eslam_tpu_torch.models import contact_model as cm

    rng = np.random.default_rng(5)
    values = torch.tensor(rng.standard_normal(200_000) * 1e3,
                          dtype=torch.float32, device=dev)
    seg = torch.tensor(rng.integers(0, 300, 200_000), dtype=torch.int32,
                       device=dev)
    first = cm._segment_sum(values, seg, 300)
    for _ in range(4):
        assert torch.equal(cm._segment_sum(values, seg, 300), first)

    c = 100_000
    state = BodyContactState.create(
        rng.uniform(-2.0, 2.0, (c, 3)).astype(np.float32),
        contact=np.ones(c, np.float32),
        group_id=(np.arange(c) // 400).astype(np.int32), device=dev)

    def lookup(world):
        mean = 0.3 * torch.sin(world[:, 0]) + 0.2 * torch.cos(world[:, 1])
        found = world[:, 0] > -1.9
        return (found, mean, torch.full_like(mean, 0.05),
                torch.zeros(world.shape[0], 3, device=world.device))

    rot = torch.eye(3, device=dev)
    trans = torch.tensor([0.1, -0.2, 0.05], device=dev)
    cfg = ContactModelConfig(contact_point_radius=0.0, min_contacts=2)
    ref = cm.evaluate_pose(state, rot, trans, 0.01, lookup, cfg)
    for _ in range(2):
        got = cm.evaluate_pose(state, rot, trans, 0.01, lookup, cfg)
        for a, b in zip(graphs.leaves(got), graphs.leaves(ref), strict=True):
            assert torch.equal(a, b)


@pytest.mark.parametrize("lookup", ["gather", "window"])
def test_graphed_profile_step_stages_equal_eager(dev, lookup):
    """``tools.profile_step`` on the card runs each stage as a CUDA graph
    (its default): every stage's graphed outputs equal an eager call on
    the same inputs and generator state bit for bit, with a device time,
    its kernels' sum, a host time and the eager call's launch calls; K1
    (window) or K5 (gather) launched by the lookup stages."""
    from slam_eslam_tpu_torch import ops
    from slam_eslam_tpu_torch.tools import profile_step

    before = ops.launch_counts()
    res = profile_step.main(["--particles", "4096", "--repeats", "2",
                             "--lookup", lookup, "--contact-cap", "8"])
    after = ops.launch_counts()
    for name, r in res.items():
        assert r["graphed"] and r["equal"] is True and r["finite"], name
        assert r["ms"] > 0 and r["kernel_ms"] > 0, name
        assert r["host_ms"] > 0 and r["launches"] > 0, name
    kernel = "contact_fold" if lookup == "window" else "select_cells"
    assert after[kernel] > before[kernel]


def test_graphed_localize_demo_equals_eager(dev):
    """``examples.localize_demo``'s step as a CUDA graph (the default on
    the card) equals the eager loop bit for bit, K5 once a step in both."""
    from slam_eslam_tpu_torch.examples import localize_demo

    quiet = lambda *a, **k: None
    got = localize_demo.localize(12, 96, dev, log=quiet)
    ref = localize_demo.localize(12, 96, dev, log=quiet, graph=False)
    assert got["graphed"] and not ref["graphed"]
    assert got["launches"] == ref["launches"] == 12
    assert np.array_equal(got["centroids"], ref["centroids"])
    assert got["ess"] == ref["ess"]
    assert got["resampled"] == ref["resampled"]
    assert same_bits(got["state"], ref["state"])
    assert torch.equal(got["state"].generator.get_state(),
                       ref["state"].generator.get_state())


def test_graphed_spread_run_equals_eager(dev):
    """``tools.probe_spread``'s scan as CUDA graphs (the default on the
    card) equals the eager loop bit for bit, the state's generator drawn
    in the graph; K1 once a measurement update under replay."""
    from slam_eslam_tpu_torch import ops
    from slam_eslam_tpu_torch.tools import probe_spread

    before = ops.launch_counts()
    got = probe_spread.main(["--particles", "4096", "--steps", "10"])
    assert got["launches"]["contact_fold"] == 10
    ref = probe_spread.main(["--particles", "4096", "--steps", "10"],
                            graph=False)
    assert ops.launch_counts()["contact_fold"] - before["contact_fold"] == 20
    for key in ("sx", "sy", "ess", "resampled"):
        assert np.array_equal(got[key], ref[key]), key


def test_graphed_stat_map_test_equals_eager(dev, tmp_path):
    """``tools.stat_map_test``'s evaluation as a CUDA graph (the default on
    the card): the raw arrays equal the eager run's bit for bit and the
    result files are identical."""
    from slam_eslam_tpu_torch.tools import stat_map_test

    runs = []
    for name, graph in (("graphed", None), ("eager", False)):
        path = tmp_path / f"{name}.dat"
        raw = stat_map_test.main(["batch", "--steps", "30", "--runs", "2",
                                  "--result-file", str(path)], graph=graph)
        runs.append((raw, path.read_text()))
    (got, got_file), (ref, ref_file) = runs
    assert ref.pop("graphs") is None
    assert got.pop("graphs")["replayed"] > 0
    for key in ref:
        assert np.array_equal(got[key], ref[key], equal_nan=True), key
    assert got_file == ref_file


# ---- the cloud merge (csrc/cloud_merge.cu): K3's merge with the operands
# placed inside the kernel, for clouds of any size

def camera_cloud(p, seed, dev, spread=1.0):
    """A cloud of ``p`` points as a camera gives it: rows of a dense image
    over ~1.6 x 1.4 m ahead (hundreds of points a 5 cm cell near the
    camera), heights near 0.3 m, colour, a few points invalid."""
    gen = torch.Generator(dev).manual_seed(seed)
    w = 640
    h = p // w
    v = torch.arange(h, device=dev).repeat_interleave(w).float() / h
    u = torch.arange(w, device=dev).repeat(h).float() / w - 0.5
    depth = 0.3 + spread * 1.4 * v ** 2
    xy = torch.stack([u * (0.4 + spread * depth), depth], -1)
    return PatchCloud.create(
        xy=xy, z=0.3 + 0.02 * torch.randn(h * w, generator=gen, device=dev),
        stdev=0.01 + 0.04 * torch.rand(h * w, generator=gen, device=dev),
        valid=torch.rand(h * w, generator=gen, device=dev) < 0.97,
        color=torch.rand(h * w, 3, generator=gen, device=dev))


def cloud_args(pool, xy, yaw, z, zs, cloud, blk=None):
    """``cm.cloud_merge``'s operands as ``map_pool.merge_cloud_all`` hands
    them over."""
    blk = pool.active() if blk is None else blk
    return (pool.origin, blk.contiguous(), xy[:, 0].contiguous(),
            xy[:, 1].contiguous(), torch.cos(yaw), torch.sin(yaw),
            z.contiguous(), zs.contiguous(), cloud.xy.contiguous(),
            cloud.z.contiguous(), cloud.stdev.contiguous(),
            cloud.valid.contiguous(),
            None if pool.color is None else cloud.color.contiguous())


def with_colour(pool, seed):
    gen = torch.Generator(pool.mean.device).manual_seed(seed)
    pool.color = torch.rand(pool.mean.shape[:2] + (pool.mean.shape[2] * 3,),
                            generator=gen,
                            device=pool.mean.device).to(pool.mean.dtype)
    return pool


def fields_of(pool, color=True):
    out = [pool.mean, pool.stdev, pool.height, pool.meta]
    return out + ([pool.color] if color and pool.color is not None else [])


@pytest.mark.parametrize("p", [1, 33, 5000, 16384])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("color", [False, True])
def test_cloud_merge_equals_k3(dev, p, dtype, color):
    """On a cloud K3 takes, the cloud merge writes what K3 writes on
    ``merge_operands``' rows, bit for bit, colour included."""
    pool = sim.random_pool(256, 1024, 40, 40, seed=p, device=dev,
                           dtype=dtype)
    if color:
        with_colour(pool, p)
    cloud = camera_cloud(-(-p // 640) * 640, p, dev)
    cloud = PatchCloud(xy=cloud.xy[:p], z=cloud.z[:p],
                       stdev=cloud.stdev[:p], valid=cloud.valid[:p],
                       color=cloud.color[:p])
    xy, yaw, z, zs = sim.poses_on_heads(pool, 1.0, p)
    k3 = [f.clone() for f in fields_of(pool)]
    cl_ = [f.clone() for f in fields_of(pool)]
    ops = mp.merge_operands(pool, xy, yaw, z, zs, cloud)
    bm.block_merge(*k3[:4], k3[4] if color else None, *ops, 7,
                   cloud.color if color else None, k=pool.k)
    before = cm.cloud_merge.launches
    cm.cloud_merge(*cl_[:4], cl_[4] if color else None,
                   *cloud_args(pool, xy, yaw, z, zs, cloud), 7,
                   k=pool.k, resolution=pool.resolution)
    assert cm.cloud_merge.launches == before + 1
    torch.cuda.synchronize()
    assert int((k3[3] != pool.meta).sum()) > 0
    for a, b in zip(k3, cl_):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cloud_merge_camera_cloud_matches_cpu_and_repeats(dev, dtype):
    """A 640 x 480 cloud (307,200 points) into 32 particles' heads of the
    cell's 400 x 400 grids at 0.05 m, colour pool: against the plain
    version on the CPU (given the card's cos and sin): mean, height, meta
    and colour bit for bit, stdev within one step; the tracer's counters
    as the plain version counts them; and bit for bit from run to run
    and replayed in a CUDA graph."""
    n = 32
    pool = sim.random_pool(n, 4 * n, 400, 400, resolution=0.05, seed=21,
                           device=dev, dtype=dtype)
    with_colour(pool, 21)
    cloud = camera_cloud(640 * 480, 22, dev)
    xy, yaw, z, zs = sim.poses_on_heads(pool, 2.0, 23)
    args = cloud_args(pool, xy, yaw, z, zs, cloud)
    kw = dict(k=pool.k, resolution=pool.resolution)
    runs = []
    for _ in range(2):
        f = [t.clone() for t in fields_of(pool)]
        counts = torch.zeros(2, dtype=torch.int64, device=dev)
        cm.cloud_merge(*f[:4], f[4], *args, 11, counts, **kw)
        runs.append((f, counts))
    torch.cuda.synchronize()
    for a, b in zip(runs[0][0], runs[1][0]):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    # a CUDA graph's replay, from a fresh copy each time
    f = [t.clone() for t in fields_of(pool)]
    upd = torch.full((), 11, dtype=torch.int32, device=dev)
    bounds = cm.cloud_bounds(args[8], args[11])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cm.launch(*f[:4], f[4], *args, bounds, upd, **kw)
    for _ in range(2):
        for t, t0 in zip(f, fields_of(pool)):
            t.copy_(t0)
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(f, runs[0][0]):
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    cpu = [t.cpu() for t in fields_of(pool)]
    cpu_counts = torch.zeros(2, dtype=torch.int64)
    cm.cloud_merge_reference(*cpu[:4], cpu[4], *(a.cpu() for a in args), 11,
                             cpu_counts, **kw)
    kern, counts = runs[0]
    assert int((kern[3] != pool.meta).sum()) > 500 * n
    assert torch.equal(counts.cpu(), cpu_counts)
    for name, a, b in zip(("mean", "stdev", "height", "meta", "color"),
                          kern, cpu):
        assert steps(a, b) <= (1 if name == "stdev" else 0), name


def test_cloud_merge_at_the_colour_pool_shape(dev):
    """The camera cell's pool: 4,000 blocks of 400 x 400 cells x 4 slots,
    float32 fields and colour (71.68 GB; the colour field holds 7.68e9
    elements, so its offsets pass 2^32 from block 2,237 on).  Heads in the
    last block, near the middle and at the start take a 307,200-point
    cloud; each written block equals the plain version's on the CPU, and
    a block no head names is untouched."""
    b, nx, k = 4000, 400, 4
    shape = (b, nx, nx * k)
    new = lambda dt, *s: torch.empty(s or shape, dtype=dt, device=dev)
    pool = mp.MapPool(
        mean=new(torch.float32), stdev=new(torch.float32),
        height=new(torch.float32), meta=new(torch.int32),
        color=new(torch.float32, b, nx, nx * k * 3),
        origin=torch.zeros((b, 2), device=dev),
        allocated=torch.zeros(b, dtype=torch.bool, device=dev),
        chain=torch.full((3, 3), -1, dtype=torch.int32, device=dev),
        resolution=0.05, nx=nx, ny=nx, k=k)
    heads = torch.tensor([b - 1, 2001, 0], dtype=torch.int32, device=dev)
    spare = 1000
    small = sim.random_pool(3, 4, nx, nx, resolution=0.05, seed=31,
                            device=dev)
    with_colour(small, 31)
    for i, blk in enumerate(heads.tolist() + [spare]):
        for name in ("mean", "stdev", "height", "meta", "color"):
            getattr(pool, name)[blk] = getattr(small, name)[i]
        pool.origin[blk] = torch.tensor([-10.0 + i, -10.0 - i], device=dev)
    pool.chain[:, 0] = heads
    xy = pool.origin[heads.long()] + 10.0
    yaw = torch.tensor([0.3, -2.0, 1.2], device=dev)
    z = torch.zeros(3, device=dev)
    zs = torch.full((3,), 0.02, device=dev)
    cloud = camera_cloud(640 * 480, 32, dev)
    args = cloud_args(pool, xy, yaw, z, zs, cloud)
    kw = dict(k=k, resolution=0.05)
    spare_meta = pool.meta[spare].clone()
    cm.cloud_merge(*fields_of(pool)[:4], pool.color, *args, 4, **kw)
    torch.cuda.synchronize()
    assert torch.equal(pool.meta[spare], spare_meta)
    # the plain version on a pool of the three heads alone
    cpu = mp.MapPool(
        mean=small.mean[:3].cpu(), stdev=small.stdev[:3].cpu(),
        height=small.height[:3].cpu(), meta=small.meta[:3].cpu(),
        color=small.color[:3].cpu(),
        origin=pool.origin[heads.long()].cpu(),
        allocated=torch.ones(3, dtype=torch.bool),
        chain=torch.arange(3, dtype=torch.int32)[:, None].expand(3, 3)
        .contiguous(), resolution=0.05, nx=nx, ny=nx, k=k)
    cargs = (cpu.origin, torch.arange(3, dtype=torch.int32)) + tuple(
        a.cpu() for a in args[2:])
    cm.cloud_merge_reference(*fields_of(cpu)[:4], cpu.color, *cargs, 4, **kw)
    for i, blk in enumerate(heads.tolist()):
        for name in ("mean", "stdev", "height", "meta", "color"):
            got, want = getattr(pool, name)[blk], getattr(cpu, name)[i]
            assert steps(got, want) <= (1 if name == "stdev" else 0), (
                blk, name)
        assert int((pool.meta[blk].cpu() != small.meta[i].cpu()).sum()) > 100
