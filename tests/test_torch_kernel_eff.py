"""The port's ``utils.profiling`` and ``utils.kernel_eff`` against the JAX
package's: the roofline accounting (``weighting_step_stats``,
``speed_of_light_fraction`` with the same peaks given) and
``steady_state_tier`` equal on seeded inputs (integers exact, ratios to
rtol 1e-12: both are the same float64 Python arithmetic); ``_slope_time``
on a stub whose cost is known; ``sync`` on the CPU.  The measurements themselves (``fold_roofline``,
``merge_floor_fraction``) need the card (``chip_smoke.py``); on the CPU
they return ``None``, as the JAX functions do off their accelerator.
"""

import types

import numpy as np
import pytest
import torch

from slam_eslam_tpu.utils import kernel_eff as jeff
from slam_eslam_tpu.utils import profiling as jprof
from slam_eslam_tpu_torch.mapping import mls_grid
from slam_eslam_tpu_torch.models import sim
from slam_eslam_tpu_torch.ops import block_copy as bc
from slam_eslam_tpu_torch.utils import kernel_eff as teff
from slam_eslam_tpu_torch.utils import profiling as tprof


@pytest.mark.parametrize("n,c,k,bytes_per", [(100_000, 8, 4, 4),
                                             (4096, 20, 2, 2), (1, 1, 1, 4)])
def test_weighting_step_stats(n, c, k, bytes_per):
    assert (tprof.weighting_step_stats(n, c, k, bytes_per)
            == jprof.weighting_step_stats(n, c, k, bytes_per))


@pytest.mark.parametrize("seconds", [1e-6, 4.3e-3, 0.0])
def test_speed_of_light_fraction(seconds):
    stats = tprof.weighting_step_stats(100_000, 8, 4)
    for peaks in (dict(hbm_gbps=3350.0, tflops=67.0),
                  dict(hbm_gbps=1.0, tflops=1e-6)):    # compute-bound too
        got = tprof.speed_of_light_fraction(seconds, stats, **peaks)
        ref = jprof.speed_of_light_fraction(seconds, stats, **peaks)
        assert got == pytest.approx(ref, rel=1e-12)
    # the defaults are the H100's, named so
    assert tprof.speed_of_light_fraction(1e-3, stats) == pytest.approx(
        tprof.speed_of_light_fraction(
            1e-3, stats, hbm_gbps=tprof.H100_HBM_GBPS,
            tflops=tprof.H100_FP32_TFLOPS))
    assert (tprof.H100_HBM_GBPS, tprof.H100_FP32_TFLOPS) == (3350.0, 67.0)


@pytest.mark.parametrize("seed,spread", [(0, 0.1), (1, 1.0), (2, 4.0)])
def test_steady_state_tier(seed, spread):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, spread, 500).astype(np.float32)
    y = rng.normal(0, spread, 500).astype(np.float32)
    tiers = ((128, 32), (128, 64))
    for window in ((128, 96), 96):
        ref = jeff.steady_state_tier(types.SimpleNamespace(x=x, y=y), 0.4,
                                     0.05, tiers, window)
        got = teff.steady_state_tier(
            types.SimpleNamespace(x=torch.from_numpy(x),
                                  y=torch.from_numpy(y)),
            0.4, 0.05, tiers, window)
        assert got == ref
    # no tiers: the window itself, which the port's bench sets to the grid
    assert teff.steady_state_tier(types.SimpleNamespace(x=x, y=y), 0.4, 0.05,
                                  (), (400, 400)) == (400, 400)


def test_slope_time_cancels_the_constant_cost(monkeypatch):
    """A stub that costs 2 ms per application, plus 30 ms once per chain
    (at its first application): the slope is the 2 ms.  The stub advances
    a fake clock instead of sleeping, so the machine's load cannot move
    the result."""
    calls = []
    now = [0.0]

    def fn(x):
        now[0] += 0.002 + (0.03 if x == 0 else 0.0)
        calls.append(x)
        return x + 1

    monkeypatch.setattr(teff.time, "perf_counter", lambda: now[0])
    got = teff._slope_time(fn, 0, iters=3, repeats=2, device="cpu")
    assert got == pytest.approx(0.002, rel=1e-9)
    # (1 warm-up + 2 repeats) chains of 12 and of 3 applications, each
    # chained from x0 through fn's result
    assert len(calls) == 3 * (12 + 3)
    assert calls[:12] == list(range(12))


def test_rooflines_need_the_card():
    grid = sim.terrain_grid(lambda x, y: 0.0 * x, nx=8, ny=8, resolution=0.1,
                            origin=(0.0, 0.0))
    assert teff.fold_roofline(mls_grid.PackedLookup.from_grid(grid),
                              16) is None
    assert teff.merge_floor_fraction(device="cpu") is None
    assert jeff.fold_mfu(None, (128, 32), 16) is None


def test_sync_returns():
    """``sync`` waits for the card where there is one and returns at once
    without (here)."""
    assert tprof.sync() is None


def test_trace_writes_a_profile(tmp_path):
    with tprof.trace(tmp_path / "prof") as prof:
        torch.ones(64).sum()
    assert prof is not None
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert "aten::sum" in (tmp_path / "prof" / "key_averages.txt").read_text()


def test_device_timers_need_the_card():
    """A kernel's device time cannot be read on the CPU: the graph timer,
    its cold-L2 form and the profiler reading raise without a CUDA device
    (``_slope_time(device="cpu")``, above, stays the host-clock path)."""
    if torch.cuda.is_available():
        pytest.skip("has a CUDA device")
    calls = []
    for timer, args in ((tprof.device_time, ()),
                        (tprof.device_time_cold, ()),
                        (tprof.profiler_kernel_time, ("some_kernel",))):
        with pytest.raises(RuntimeError, match="CUDA device"):
            timer(lambda: calls.append(1), *args)
    assert not calls
    with pytest.raises(ValueError, match="L2"):
        tprof.device_time_cold(lambda: None, fill_bytes=1 << 20)


class _HostOnlyTrace:
    """A ``torch.profiler.profile`` stand-in whose trace holds the host's
    launch calls and, as ``kept`` says, the kernel's device records."""

    sessions = 0
    kept = False

    def __init__(self, activities):
        type(self).sessions += 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def key_averages(self):
        from torch.autograd import DeviceType

        event = lambda key, device: types.SimpleNamespace(
            key=key, count=4, device_type=device, self_device_time_total=8.0)
        rows = [event("cudaLaunchKernel", DeviceType.CPU)]
        if type(self).kept:
            rows.append(event("some_kernel", DeviceType.CUDA))
        return rows


@pytest.mark.parametrize("kept", [False, True])
def test_profiler_lost_records(monkeypatch, kept):
    """Sessions whose traces keep the host's launch calls and no device
    record are traced again, ``PROFILER_SESSIONS`` in all, and then raise
    ``ProfilerLostRecords`` (a cross-check the caller may go without);
    a session that kept its records reads on the first try (8 us over 4
    launches)."""
    import torch.profiler

    trace = type("Trace", (_HostOnlyTrace,), dict(sessions=0, kept=kept))
    monkeypatch.setattr(torch.profiler, "profile", trace)
    monkeypatch.setattr(tprof, "PROFILER_PAD_S", 0.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    if kept:
        got = tprof.profiler_kernel_time(lambda: None, "some_kernel", 4)
        assert got == pytest.approx(2e-6, rel=1e-12)
        assert trace.sessions == 1
    else:
        with pytest.raises(tprof.ProfilerLostRecords, match="0 device"):
            tprof.profiler_kernel_time(lambda: None, "some_kernel", 4)
        assert trace.sessions == tprof.PROFILER_SESSIONS


def test_instruction_bound():
    # 800,000 queries of 300 instructions at 67 TFLOP/s, a fused
    # multiply-add counted as two: 33.5e12 instructions a second
    got = tprof.instruction_bound_seconds(800_000 * 300)
    assert got == pytest.approx(2.4e8 / 33.5e12, rel=1e-12)
    assert 7.1e-6 < got < 7.2e-6
    # the same rate from the card's layout: 132 SMs x 4 schedulers x 32
    # lanes at 1.98 GHz
    assert 33.5e12 == pytest.approx(132 * 4 * 32 * 1.98e9, rel=2e-3)


def flat_lookup(k=4):
    """An 8 x 8 grid at 0.1 m from the origin: slot 0 of every cell a
    patch at height 0 with stdev 0.05, the other slots empty."""
    data = torch.zeros((8, 8, 2 * k))
    data[..., k] = 0.05
    data[..., k + 1:] = -1.0
    return mls_grid.PackedLookup(data=data, origin=torch.zeros(2),
                                 resolution=0.1)


# with mv = 0.01 the scale is sqrt(0.0025 + 0.01) = 0.112: a query 0.05 m
# above its patch has u = 0.45 (the head), one 1 m below u = -8.9 (the
# tail), one 5 m above finds no slot within the 3 m window
HEAD_Z, TAIL_Z, FAR_Z = 0.05, -1.0, 5.0
ALL = dict(particles=3, rows=12, active=12, inside=12, found=12, head=12,
           tail=0, groups=9, valid_groups=9)


@pytest.mark.parametrize("case,want", [
    ("head", ALL),
    ("tail", dict(ALL, head=0, tail=12)),
    ("far", dict(ALL, found=0, head=0, valid_groups=0)),
    ("outside", dict(ALL, inside=0, found=0, head=0, valid_groups=0)),
    ("inactive", dict(ALL, active=0, inside=0, found=0, head=0,
                      valid_groups=0)),
    # row 1 finds no patch: its group (rows 0 and 1) is invalid
    ("member lost", dict(ALL, found=9, head=9, valid_groups=6)),
    # row 1 inactive: its group is judged on row 0 alone
    ("member inactive", dict(ALL, active=9, inside=9, found=9, head=9)),
    # particle 0 in the head, 1 in the tail, 2 outside the grid
    ("mixed", dict(ALL, inside=8, found=8, head=4, tail=4, valid_groups=6)),
])
def test_fold_work_counts_what_the_inputs_need(case, want):
    c, n = 4, 3
    x = torch.full((c, n), 0.35)
    z = torch.full((c, n), HEAD_Z)
    act = torch.ones((c, 1))
    if case == "tail":
        z[:] = TAIL_Z
    elif case == "far":
        z[:] = FAR_Z
    elif case == "outside":
        x[:] = -1.0
    elif case == "inactive":
        act[:] = 0.0
    elif case == "member lost":
        z[1] = FAR_Z
    elif case == "member inactive":
        act[1] = 0.0
        z[1] = FAR_Z
    elif case == "mixed":
        z[:, 1] = TAIL_Z
        x[:, 2] = 0.85
    seg = torch.tensor([0, 0, 1, 2], dtype=torch.int32)
    got = teff.fold_work(flat_lookup(), (x, x.clone(), z), act,
                         torch.full((1, n), 0.01), seg, correction=1.0)
    assert got == want


@pytest.mark.parametrize("k", [1, 2, 4])
def test_fold_needed_instructions(k):
    costs = teff.fold_costs(k)
    assert set(costs) == set(ALL)
    assert all(v > 0 for v in costs.values())
    # a tail query pays eight divisions where a head query pays two and
    # two expf; a valid group three divisions
    assert costs["tail"] == 1 + 8 * (teff.DIV + 1)
    assert costs["head"] > 2 * teff.DIV + 2 * teff.EXP
    assert costs["valid_groups"] == 3 * teff.DIV
    one = dict.fromkeys(ALL, 0)
    for name in ALL:
        assert teff.fold_needed_instructions(dict(one, **{name: 7}),
                                             k) == 7 * costs[name]
    total = teff.fold_needed_instructions(ALL, k)
    assert total == sum(costs[name] * ALL[name] for name in ALL)
    # moving every query to the tail costs the difference of the branches
    tail = dict(ALL, head=0, tail=12)
    assert teff.fold_needed_instructions(tail, k) - total == 12 * (
        costs["tail"] - costs["head"])


@pytest.mark.parametrize("nbytes,by", [(10 ** 9, "bytes"), (1, "operations")])
def test_fold_bound_is_the_larger_of_the_two(nbytes, by):
    seconds, bound_by, needed = teff.fold_bound(nbytes, ALL, 4)
    assert bound_by == by
    assert needed == teff.fold_needed_instructions(ALL, 4)
    assert seconds == max(nbytes / 3.35e12,
                          tprof.instruction_bound_seconds(needed))


SASS = """
	code for sm_90a
		Function : _ZN3foo19select_world_kernelILi4EEEvPKf
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   EXIT ;
        /*0020*/                   BRA 0x20;
		Function : _ZN3foo19contact_fold_kernelILi4EEEvPKf
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                  /* 0x00000a00ff017b82 */
                                                                             /* 0x000fe20000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0030*/                   MUFU.RCP R4, R3 ;
        /*0040*/                   FCHK P0, R2, R3 ;
        /*0050*/              @!P0 FFMA R5, R4, R2, RZ ;
        /*0060*/               @P0 CALL.REL.NOINC 0x100 ;
        /*0070*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0080*/                   FADD R6, R5, R5 ;
        /*0090*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*00a0*/              @!PT LDS RZ, [RZ] ;
        /*00b0*/                   STG.E [R8.64], R6 ;
        /*00c0*/                   EXIT ;
        /*00d0*/                   BRA 0xd0;
        /*00e0*/                   NOP;
        /*00f0*/                   NOP;
        /*0100*/                   FMUL R5, R2, R4 ;
        /*0110*/                   RET.REL.NODEC R10 0x0 ;
        /*0120*/                   BRA 0x120;
		Function : _ZN3foo19contact_fold_kernelILi2EEEvPKf
        /*0000*/                   EXIT ;
"""


def test_count_sass():
    from slam_eslam_tpu_torch.ops import _build

    got = _build.count_sass(SASS, ("contact_fold_kernel", "ILi4E"))
    assert got["function"].endswith("contact_fold_kernelILi4EEEvPKf")
    # padding and the closing branches to themselves do not count; what
    # the CALL enters (from 0x100) is a subroutine, not the kernel's own
    assert got["main"] == 13 and got["subroutines"] == 2
    assert _build.count_sass(SASS, "select_world_kernel")["main"] == 2
    with pytest.raises(RuntimeError, match="no kernel"):
        _build.count_sass(SASS, "block_merge_kernel")


# ---- the traffic counts of the block merge (K3) and the chain lookup (K2):
# useful bytes and distinct 32-byte sectors, against hand counts on tiny
# pools (blocks of 4x4 cells, K = 4: a float32 or int32 slot row is 16
# bytes, two cells to a sector; a bfloat16 row 8 bytes, four to a sector)

def tiny_pool(dtype=torch.float32, b=8):
    pool = sim.random_pool(1, b, 4, 4, k=4, resolution=1.0, seed=0,
                           dtype=dtype)
    pool.mean.zero_()
    pool.meta.fill_(1)                         # every slot valid, mean 0
    pool.origin = torch.tensor([[10.0 * i, 0.0] for i in range(b)])
    return pool


def merge_ops(blk, lx, ly):
    i32 = lambda a: torch.tensor(a, dtype=torch.int32)
    return i32(blk), i32(lx), i32(ly)


# one particle on block 1, point rows of P = 2 (one sector each), the
# block id (one sector): 5 sectors read besides the field rows
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ly,field_sectors", [
    ([0, 1], 4),      # neighbours in iy share each field's sector
    ([1, 2], 8),      # cells 17 and 18: a sector boundary between them
    ([3, 3], 4),      # one cell hit by both points counts once
])
def test_merge_traffic_counts_distinct_sectors(dtype, ly, field_sectors):
    if dtype == torch.bfloat16 and ly == [1, 2]:
        field_sectors = 5   # bfloat16 rows 17, 18 share a sector, meta not
    pool = tiny_pool(dtype)
    t = teff.merge_traffic(pool, *merge_ops([1], [[0, 0]], [ly]))
    assert t["sectors_written"] == field_sectors
    assert t["sectors_read"] == 5 + field_sectors
    assert t["sectors"] == 5 + 2 * field_sectors
    size = pool.mean.element_size()
    cells = len(set(ly))
    assert t["bytes"] == 4 + 4 * 2 * 4 + cells * (4 * (3 * size + 4)
                                                   + 3 * size + 4)


def test_merge_traffic_void_block_and_masked_points_count_no_rows():
    pool = tiny_pool()
    for ops in (merge_ops([-1], [[0, 1]], [[0, 1]]),
                merge_ops([99], [[0, 1]], [[0, 1]]),
                merge_ops([2], [[4, 0]], [[0, 4]])):
        t = teff.merge_traffic(pool, *ops)
        assert t["sectors_written"] == 0 and t["sectors_read"] == 5


@pytest.mark.parametrize("seed,dtype", [(0, torch.float32),
                                        (1, torch.bfloat16)])
def test_merge_traffic_sectors_cover_the_useful_bytes(seed, dtype):
    rng = np.random.default_rng(seed)
    pool = tiny_pool(dtype, b=64)
    blk, lx, ly = merge_ops(rng.permutation(64)[:16],
                            rng.integers(-1, 5, (16, 24)),
                            rng.integers(-1, 5, (16, 24)))
    t = teff.merge_traffic(pool, blk, lx, ly)
    cells = int(torch.unique(bc.hit_rows(blk, lx, ly, 64, 4, 4)).numel())
    assert t["sectors"] * teff.SECTOR_BYTES >= t["bytes"]
    # a slot row lies in one sector of each field
    assert 0 < t["sectors_written"] <= 4 * cells


def chain_case(chain, xy, c=1):
    pool = tiny_pool()
    pool.chain = torch.tensor([chain], dtype=torch.int32)
    q = lambda v: torch.full((1, c), v)
    return pool, (q(xy[0]), q(xy[1]), q(0.0))


# queries x, y, z, the chain row: 4 sectors read; found, mean, stdev: 3
# written.  Block 3's origin lies in sector 0, block 5's in sector 1.
@pytest.mark.parametrize("chain,xy,origins,rows,every", [
    ([3, -1, -1], (30.5, 0.5), 1, 3, 1),      # a hit at the head
    ([-1, -1, 3], (30.5, 0.5), 1, 3, 1),      # void levels count nothing
    ([5, 3, -1], (30.5, 0.5), 2, 3, 2),       # block 5 off: its origin only
    ([3, 5, -1], (30.5, 0.5), 1, 3, 2),       # the walk ends at the hit
    ([5, 5, 5], (30.5, 0.5), 1, 0, 1),        # off every block: no rows
])
@pytest.mark.parametrize("c", [1, 3])
def test_chain_traffic_counts_distinct_sectors(chain, xy, origins, rows,
                                               every, c):
    """``origins``, ``rows``: the sectors of origins and of mean, meta and
    stdev rows that the walk needs; ``every``: the origin sectors of every
    level (``sectors_all_levels``)."""
    pool, queries = chain_case(chain, xy, c)
    if chain == [3, 5, -1]:                    # put block 5 under the query
        pool.origin[5] = torch.tensor([30.0, 0.0])
        rows_all = 3 + 2                       # its mean and meta rows too
    else:
        rows_all = rows
    t = teff.chain_traffic(pool, pool.chain, queries, 3.0)
    assert t["sectors_written"] == 3
    assert t["sectors_read"] == 4 + origins + rows
    assert t["sectors"] == 7 + origins + rows
    assert t["sectors_all_levels"] == 7 + every + rows_all
