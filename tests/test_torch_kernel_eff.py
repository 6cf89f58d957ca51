"""The port's ``utils.profiling`` and ``utils.kernel_eff`` against the JAX
package's: the roofline accounting (``weighting_step_stats``,
``speed_of_light_fraction`` with the same peaks given) and
``steady_state_tier`` equal on seeded inputs (integers exact, ratios to
rtol 1e-12: both are the same float64 Python arithmetic); ``_slope_time``
on a stub whose cost is known; ``timed``, ``sync`` and ``StepLogger`` on
the CPU.  The measurements themselves (``fold_roofline``,
``merge_floor_fraction``) need the card (``chip_smoke.py``); on the CPU
they return ``None``, as the JAX functions do off their accelerator.
"""

import io
import time
import types

import numpy as np
import pytest
import torch

from slam_eslam_tpu.utils import kernel_eff as jeff
from slam_eslam_tpu.utils import profiling as jprof
from slam_eslam_tpu_torch.mapping import mls_grid
from slam_eslam_tpu_torch.models import sim
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


def test_slope_time_cancels_the_constant_cost():
    """A stub that costs 2 ms per application, plus 30 ms once per chain
    (at its first application): the slope is the 2 ms."""
    calls = []

    def fn(x):
        time.sleep(0.002 + (0.03 if x == 0 else 0.0))
        calls.append(x)
        return x + 1

    got = teff._slope_time(fn, 0, iters=3, repeats=2, device="cpu")
    assert got == pytest.approx(0.002, rel=0.25)
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


def test_timed_sync_and_step_logger(capsys):
    out = {}
    with tprof.timed("work", out):
        time.sleep(0.01)
    assert out["work"] >= 0.01
    assert "[timing] work:" in capsys.readouterr().err
    tprof.sync()                                  # no device: returns
    stream = io.StringIO()
    log = tprof.StepLogger(every=2, stream=stream)
    for i in range(4):
        log.log(ess=i, found=2 * i)
    ref_stream = io.StringIO()
    ref = jprof.StepLogger(every=2, stream=ref_stream)
    for i in range(4):
        ref.log(ess=i, found=2 * i)
    assert stream.getvalue() == ref_stream.getvalue()
    assert stream.getvalue().count("iteration:") == 2


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
