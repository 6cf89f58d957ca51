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
