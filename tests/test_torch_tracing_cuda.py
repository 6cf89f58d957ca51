"""The port's tracer (``slam_eslam_tpu_torch/utils/tracing.py``) on the card,
with its stamp kernel (``csrc/trace_stamp.cu``) inside the runners' CUDA
graphs.

* The stamps of a traced localisation runner come out in order, one set
  of stage marks a replay, and each replay's stamps fall within the
  profiler's device records of that replay (within ``REPLAY_TOL_US``: the
  two clocks are tied by the tracer's calibration stamps, taken between
  synchronises).
* Graphed results with tracing on equal those with it off bit for bit,
  for the localisation and the SLAM runner.
* A graph captured with tracing off holds the kernels of the step with
  the tracer's entry points stubbed out (the step before the tracer); one
  captured with it on holds those and its stamps (the device records of a
  replay of each graph, by name).

Marked ``cuda``; without a CUDA device every test skips.  This file
imports no JAX, so it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_tracing_cuda.py
"""

import collections
import contextlib
import json

import pytest
import torch

from slam_eslam_tpu_torch import bench
from slam_eslam_tpu_torch.filter import step as steplib
from slam_eslam_tpu_torch.filter import streaming
from slam_eslam_tpu_torch.mapping.lookup import make_lookup
from slam_eslam_tpu_torch.models import sim
from slam_eslam_tpu_torch.utils import graphs, tracing, tree

pytestmark = pytest.mark.cuda

N, STEPS = 4096, 20
LOC_STAGES = ("odometry", "project", "weights", "resample", "centroid")
# how far a replay's stamps may lie outside its device records, on the
# profiler's clock: the tracer's calibration and the profiler's own
# conversion of the card's clock put a stamp from 4.5 us before to 74 us
# after the profiler's record of it (NVIDIA H100 80GB HBM3, 700 W)
REPLAY_TOL_US = 150.0
STAMP_KERNEL = "trace_stamp_kernel"


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def tracer(monkeypatch):
    fresh = tracing.Tracer(capacity=1 << 16)
    monkeypatch.setattr(tracing, "TRACER", fresh)
    return fresh


def loc_case(dev):
    args = bench.parser().parse_args(["--particles", str(N), "--steps",
                                      str(STEPS)])
    cfg = bench.filter_config(args)
    grid = tree.to(sim.terrain_grid(bench.filter_terrain,
                                    **bench.FILTER_GRID), dev)
    css, qs, _, _ = bench.filter_trajectory(STEPS, 8)
    particles = bench.filter_particles(N)
    css, qs = tree.to(css, dev), qs.to(dev)
    lookup = make_lookup(cfg, grid)

    def run(runner):
        return runner(bench.filter_state(cfg, particles, 8, dev), css, qs)

    return (lambda capture=True: steplib.make_scan_runner(
        cfg, lookup, graph=capture)), run


def slam_case(dev):
    args = bench.parser().parse_args(["--mode", "slam", "--particles",
                                      str(N), "--steps", "4"])
    cfg = bench.slam_config(args)
    z0, frames, full, qs = bench.slam_trajectory(4, 8)
    odos = streaming.precompute_odometry(20, tree.to(full, dev), qs.to(dev),
                                         cfg=cfg)
    frames = tree.to(frames, dev)

    def run(runner):
        return runner(bench.slam_carry(cfg, z0, dev), frames, odos)

    return (lambda capture=True: bench.make_slam_runner(
        cfg, graph=capture)), run


def test_stamps_are_in_order_one_set_a_replay(dev):
    make, run = loc_case(dev)
    runner = make()
    with tracing.enable():
        run(runner)                    # eager, captured, replayed
        run(runner)                    # every step replayed
    calls = tracing.records().calls
    call = calls[-1]
    assert (call.untraced, call.lost) == (0, 0)
    one = [(s, k) for s in LOC_STAGES for k in ("enter", "exit")]
    assert [(m.name, m.kind) for m in call.marks] == one * STEPS
    times = [m.value for m in call.marks]
    assert times == sorted(times)
    for t in range(STEPS):
        step = call.marks[10 * t:10 * (t + 1)]
        stages = tracing.stage_ns(step)
        assert all(stages[s] > 0 for s in LOC_STAGES)
        assert sum(stages.values()) <= tracing.extent_ns(step)


def device_records_of_replays(path):
    """``[(first start, last end) in us]`` of each ``graph replay N`` span's
    device records, in order, and every stamp record's start."""
    doc = json.loads(path.read_text())
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith(graphs.REPLAY_SPAN))
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and "GraphLaunch" in e["name"]]
    device = collections.defaultdict(list)
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            device[e["args"].get("correlation")].append(e)
    out = []
    for a, b in spans:
        (launch,) = [e for e in launches if a <= e["ts"] <= b]
        recs = device[launch["args"]["correlation"]]
        out.append((min(e["ts"] for e in recs),
                    max(e["ts"] + e["dur"] for e in recs),
                    sorted(e["ts"] for e in recs
                           if STAMP_KERNEL in e["name"])))
    return out, int(doc["baseTimeNanoseconds"])


def test_stamps_fall_within_their_replays_device_records(dev, tmp_path):
    make, run = loc_case(dev)
    runner = make()
    with tracing.enable():
        run(runner)
    tracing.reset()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    with prof:
        run(runner)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    replays, base = device_records_of_replays(path)
    (call,) = tracing.records().calls
    assert len(replays) == STEPS
    offsets = []
    for t, (lo, hi, stamps) in enumerate(replays):
        us = [(m.value - base) / 1e3 for m in call.marks[10 * t:10 * (t + 1)]]
        assert len(stamps) == len(us)
        assert lo - REPLAY_TOL_US <= us[0] and us[-1] <= hi + REPLAY_TOL_US
        offsets += [a - b for a, b in zip(us, stamps)]
    offsets.sort()
    print(f"tracing: a stamp's time less its own device record's over "
          f"{STEPS} replays: {offsets[0]:.2f} to {offsets[-1]:.2f} us, "
          f"median {offsets[len(offsets) // 2]:.2f}")


@pytest.mark.parametrize("case", [loc_case, slam_case],
                         ids=["localisation", "slam"])
def test_traced_results_equal_untraced_bit_for_bit(dev, case):
    make, run = case(dev)
    off = make()
    run(off)
    run(off)
    ref = run(off)
    on = make()
    with tracing.enable():
        run(on)
        run(on)
        got = run(on)
    torch.cuda.synchronize()
    assert on.graphs.traced() and not off.graphs.traced()
    same, n = graphs.equal_bits(got, ref)
    assert same and n
    assert tracing.records().calls


def graph_kernels(runner, path):
    """The device records of the runner's captured graph, by name: one
    replay of it, run directly (the runner would capture it again with
    marks under a profiler), traced by the profiler into ``path``."""
    (graph,) = [g[0] for sg in runner.graphs.per_shape.values()
                for g in sg.graphs.values()]
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    with prof:
        graph.replay()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return collections.Counter(
        e["name"] for e in events
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))


class NoTracer(tracing.Tracer):
    def span(self, name):
        return contextlib.nullcontext()

    def call(self, name, traced=False):
        return contextlib.nullcontext()

    def stage(self, name, device):
        return contextlib.nullcontext()

    def count(self, name, value, device=None):
        pass


def test_an_untraced_graph_holds_the_launches_of_the_step_before_the_tracer(
        dev, monkeypatch, tmp_path):
    make, run = loc_case(dev)
    kernels = {}
    for name, tracer, traced in (("off", None, False),
                                 ("before", NoTracer(), False),
                                 ("on", None, True)):
        with monkeypatch.context() as m:
            if tracer is not None:
                m.setattr(tracing, "TRACER", tracer)
            runner = make()
            with tracing.enable() if traced else contextlib.nullcontext():
                run(runner)
            kernels[name] = graph_kernels(runner, tmp_path / f"{name}.json")
    off, before, on = kernels["off"], kernels["before"], kernels["on"]
    assert off and off == before
    stamps = {k: v for k, v in on.items() if STAMP_KERNEL in k}
    assert sum(stamps.values()) == 2 * len(LOC_STAGES)
    assert on - collections.Counter(stamps) == off
