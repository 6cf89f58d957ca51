"""The port's tracer, ``slam_eslam_tpu_torch/utils/tracing.py``, on the CPU.

The runners' CUDA graphs are driven through the stand-in of
``tests/torch_stand_in.py``: its capture runs the step's Python and puts
back what it wrote, its replay runs the step again, so a replay's marks
are written into the CPU's ring by the step's own code and the host's
account of them (credited from the capture's record, as on the card) has
to agree with what was written.

* Spans nest with their parents and carry their runner call's id.
* With tracing off nothing is recorded, and the step runs the operators
  it runs with the tracer's entry points stubbed out (the code before the
  tracer); with tracing on the results equal those with it off, bit for
  bit, in both runners.
* Captured with tracing on, each replay writes its stage records in
  order; a graph captured with tracing off is captured again once tracing
  is on; a traced runner records every call; under a profiler alone eager
  work outside a runner call takes no mark.
* The map pool's counters equal a direct count on a tiny pool, in a
  frame that needs copies, one that needs none and one where the pool
  runs out.
* The tracer's spans and a ``record_function`` around the same region
  agree in nesting order on the profiler's clock.
"""

import contextlib
import dataclasses
import json
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from slam_eslam_tpu_torch import bench
from slam_eslam_tpu_torch.config import Config, ContactModelConfig
from slam_eslam_tpu_torch.core.state import ParticleSet
from slam_eslam_tpu_torch.filter import pose_estimator as pe
from slam_eslam_tpu_torch.filter import step as steplib
from slam_eslam_tpu_torch.filter import streaming
from slam_eslam_tpu_torch.mapping import map_pool as mp
from slam_eslam_tpu_torch.mapping.lookup import make_lookup
from slam_eslam_tpu_torch.mapping.mls_grid import MLSGrid
from slam_eslam_tpu_torch.models import sim
from slam_eslam_tpu_torch.utils import graphs, tracing, tree
from torch_stand_in import StandIn, assert_bitwise

CPU = torch.device("cpu")
N, STEPS = 128, 5
LOC_STAGES = ("odometry", "project", "weights", "resample", "centroid")
SLAM_N = 16
LASER = (np.eye(3), np.zeros(3))
COUNTERS = ("pool.head_rows_moved", "pool.heads_copied",
            "pool.heads_started", "pool.alloc_failed")


@pytest.fixture(autouse=True)
def tracer(monkeypatch):
    """A tracer of the test's own (the process's serves every test of a
    worker)."""
    fresh = tracing.Tracer(capacity=1 << 14)
    monkeypatch.setattr(tracing, "TRACER", fresh)
    return fresh


@pytest.fixture(scope="module")
def loc():
    args = bench.parser().parse_args(["--particles", str(N), "--steps",
                                      str(STEPS)])
    cfg = bench.filter_config(args)
    grid = sim.terrain_grid(bench.filter_terrain, nx=80, ny=80,
                            resolution=0.05, origin=(-2.0, -2.0))
    css, qs, _, _ = bench.filter_trajectory(STEPS, 8)
    particles = bench.filter_particles(N)
    return dict(cfg=cfg, lookup=make_lookup(cfg, grid), css=css, qs=qs,
                fresh=lambda: bench.filter_state(cfg, particles, 8, CPU))


def loc_runner(loc):
    return steplib.make_scan_runner(loc["cfg"], loc["lookup"],
                                    graph=StandIn())


def run_loc(loc, runner):
    return runner(loc["fresh"](), loc["css"], loc["qs"])


def slam_config():
    return dataclasses.replace(
        Config(), particle_count=SLAM_N, min_effective=0.9 * SLAM_N,
        grid_size=1.0, grid_resolution=0.125, map_pool_blocks=4 * SLAM_N,
        map_chain_length=3, map_pool_color=False,
        contact_model=ContactModelConfig(contact_point_radius=0.0,
                                         min_contacts=2))


@pytest.fixture(scope="module")
def slam():
    """40 frames of the Asguard (a scan on every tenth), 16 particles on
    grids of 1 m at 0.125 m: resamplings, copies and rollovers."""
    cfg = slam_config()
    z0, frames, full, qs = bench.slam_trajectory(4, 8)
    odos = streaming.precompute_odometry(20, full, qs, cfg=cfg)
    return dict(cfg=cfg, frames=frames, odos=odos,
                carry=lambda: bench.slam_carry(cfg, z0, CPU))


def run_slam(slam):
    """Every frame through a graphed ``make_slam_step`` (the stand-in):
    ``(carry, [(centroid, best pose)], mapping gates, step)``."""
    step = streaming.make_slam_step(slam["cfg"], laser2body=LASER,
                                    external_odometry=True, graph=StandIn())
    carry, out, mapped = slam["carry"](), [], []
    frames, odos = slam["frames"], slam["odos"]
    for t in range(len(frames)):
        carry, aux = step(carry, frames.at(t), tree.index(odos, t))
        out.append((aux["centroid"], aux["best_pose"]))
        mapped.append(aux["mapped"])
    return carry, out, mapped, step


def in_call(recs, call):
    return [s for s in recs.spans if s.call == call.id]


def test_spans_nest_with_their_parents_and_calls(loc):
    runner = loc_runner(loc)
    with tracing.enable():
        run_loc(loc, runner)
        run_loc(loc, runner)
    recs = tracing.records()
    assert [c.id for c in recs.calls] == [0, 1]
    for call in recs.calls:
        top = recs.spans[call.span]
        assert (top.name, top.parent, top.call) == (
            "make_scan_runner", None, call.id)
        spans = in_call(recs, call)
        names = [s.name for s in spans]
        for name in ("scan inputs", "scan steps", "scan bind",
                     "scan result"):
            assert names.count(name) == 1, name
        assert names.count("step inputs") == STEPS
        assert names.count("step outputs") == STEPS
        for s in spans:
            # every span lies inside its parent, in the same call, and
            # its parents lead up to the call's span
            chain, p = [], s.parent
            while p is not None:
                parent = recs.spans[p]
                assert parent.call == call.id
                assert parent.start <= s.start and s.end <= parent.end
                chain.append(parent.name)
                p = parent.parent
            assert s is top or chain[-1] == "make_scan_runner"
            if s.name.startswith(graphs.REPLAY_SPAN):
                assert chain[0] == "scan steps"
    # the first call: one step eager, the second captured, then replays
    replays = [s.name for s in in_call(recs, recs.calls[0])
               if s.name.startswith(graphs.REPLAY_SPAN)]
    assert len(replays) == STEPS - 1


class Operators(TorchDispatchMode):
    """The ATen operators run inside, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


class NoTracer(tracing.Tracer):
    """The tracer's entry points doing nothing at all: the step as it ran
    before the tracer."""

    def span(self, name):
        return contextlib.nullcontext()

    def call(self, name, traced=False):
        return contextlib.nullcontext()

    def stage(self, name, device):
        return contextlib.nullcontext()

    def count(self, name, value, device=None):
        pass


@pytest.mark.parametrize("runner", ["localisation", "slam"])
def test_off_records_nothing_and_adds_no_operators(loc, slam, runner,
                                                   monkeypatch):
    """With tracing off a graphed run records nothing and runs, capture
    included, the operators it runs with the tracer stubbed out; with
    tracing on its results equal those with it off, bit for bit."""
    run = ((lambda: run_loc(loc, loc_runner(loc))) if runner
           == "localisation" else (lambda: run_slam(slam)[:2]))
    with Operators() as off:
        got = run()
    recs = tracing.records()
    assert (recs.spans, recs.calls, recs.loose) == ([], [], [])
    assert tracing.TRACER.rings == {}
    with monkeypatch.context() as m:
        m.setattr(tracing, "TRACER", NoTracer())
        with Operators() as before:
            ref = run()
    assert off.ops == before.ops and len(off.ops) > 100
    assert_bitwise(got, ref)
    with tracing.enable():
        traced = run()
    assert_bitwise(traced, ref)
    assert tracing.records().calls


def test_each_replay_writes_its_stage_records_in_order(loc):
    runner = loc_runner(loc)
    with tracing.enable():
        run_loc(loc, runner)
    run_loc(loc, runner)       # tracing off: the runner's graph is traced
    recs = tracing.records()
    assert len(recs.calls) == 2 and not recs.loose
    one = [(name, kind) for name in LOC_STAGES
           for kind in ("enter", "exit")]
    for call in recs.calls:
        assert (call.untraced, call.lost) == (0, 0)
        assert [(m.name, m.kind) for m in call.marks] == one * STEPS
        times = [m.value for m in call.marks]
        assert times == sorted(times)
        top = recs.spans[call.span]
        assert top.start <= times[0] and times[-1] <= top.end
        assert set(tracing.stage_ns(call.marks)) == set(LOC_STAGES)
    assert runner.graphs.counts() == dict(eager=1, captured=1,
                                          replayed=2 * STEPS - 1)


def test_an_untraced_graph_is_captured_again_when_tracing_turns_on(loc):
    runner = loc_runner(loc)
    run_loc(loc, runner)
    assert not runner.graphs.traced() and not tracing.records().calls
    with tracing.enable():
        run_loc(loc, runner)
    assert runner.graphs.traced()
    # the traced run's first step captures again and replays
    assert runner.graphs.counts() == dict(eager=1, captured=2,
                                          replayed=2 * STEPS - 1)
    (call,) = tracing.records().calls
    assert call.untraced == 0 and len(call.marks) == 10 * STEPS


def test_a_profiler_alone_marks_captures_not_eager_work(loc):
    """Under a profiler eager work outside a runner call takes no mark (the
    profiler records eager kernels itself), while a runner's capture does
    and every replay writes them."""
    state = loc["fresh"]()
    runner = loc_runner(loc)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        pe.centroid(state.particles, loc["qs"][0])
        run_loc(loc, runner)
    recs = tracing.records()
    assert recs.loose == [] and runner.graphs.traced()
    (call,) = recs.calls
    assert len(call.marks) == 2 * len(LOC_STAGES) * STEPS


def test_replays_of_untraced_graphs_are_counted():
    with tracing.enable(), tracing.call("frame"):
        with tracing.replaying(None):
            pass
        with tracing.replaying(None):
            pass
    (call,) = tracing.records().calls
    assert (call.name, call.untraced, call.marks) == ("frame", 2, [])


def test_marks_a_replay_did_not_write_are_refused():
    """The host credits a replay with the marks its capture recorded: a
    replay that writes others leaves the ring and the account apart."""
    with tracing.enable():
        with tracing.capturing(True) as cap:
            with tracing.stage("weights", CPU):
                pass
        with tracing.call("step"), tracing.replaying(cap.marks()):
            pass      # the stand-in's replay wrote nothing
    with pytest.raises(RuntimeError, match="accounted for"):
        tracing.records()


def tiny_pool(n, blocks):
    template = MLSGrid.create(8, 8, 0.125, origin=(-0.5, -0.5), k=2)
    return mp.MapPool.from_template(template, n, blocks, chain_len=3,
                                    with_color=False)


@pytest.mark.parametrize("case", ["copies", "none", "exhausted"])
def test_pool_counters_equal_a_direct_count(case):
    """One copy-on-write and rollover (``streaming.own_heads``) on a pool
    of 6 particles after a resampling (``copies``: three heads shared,
    two particles off their grid), with none needed (``none``:
    ``needless_head_copy_share`` reads 100 %), and with a pool of one
    block a particle (``exhausted``: the new heads find none)."""
    n = 6
    cfg = slam_config()
    pool = tiny_pool(n, n if case == "exhausted" else 4 * n)
    p = ParticleSet.zeros(n, CPU)
    if case != "none":
        pool.resample_(torch.tensor([0, 0, 1, 1, 1, 5]))
        p = dataclasses.replace(p, x=torch.tensor(
            [0.0, 0.0, 2.0, 0.0, 0.0, -2.0]))
    heads = pool.chain[:, 0]
    dups = n - int(torch.unique(heads).numel())
    origin = pool.origin.index_select(0, heads.long())
    half = pool.nx * pool.resolution / 2.0
    off_grid = int(((p.x - origin[:, 0] - half).abs()
                    > cfg.grid_size / 2.0 * cfg.grid_threshold).sum())
    ref_pool = graphs.clone(pool)
    ref_pool, ref_failed = streaming.own_heads(cfg, ref_pool, p)
    with tracing.enable():
        pool, failed = streaming.own_heads(cfg, pool, p)
    assert_bitwise((pool, failed), (ref_pool, ref_failed))
    assert (case == "none") == (dups == off_grid == 0)
    if case == "copies":
        assert (dups, off_grid) == (3, 2)
    marks = tracing.records().loose
    got = tracing.counts(marks)
    assert set(got) == set(COUNTERS)
    moved = got["pool.head_rows_moved"]
    assert moved == 2 * n
    # exhausted: the resampling freed as many blocks as heads it shared,
    # so the copies find blocks and the new heads none
    started = 0 if case == "exhausted" else off_grid
    assert got["pool.heads_copied"] == dups
    assert got["pool.heads_started"] == started
    assert got["pool.alloc_failed"] == int(failed) == off_grid - started
    needless = 100.0 * (1 - (got["pool.heads_copied"]
                             + got["pool.heads_started"]) / moved)
    assert (needless == 100.0) == (case == "none")
    stages = [(m.name, m.kind) for m in marks if m.kind != "count"]
    assert stages == [("own heads", "enter"), ("own heads", "exit")]


def test_slam_frames_carry_their_stages_and_counters(slam):
    """Traced, every frame of the graphed SLAM step (eager, captured or
    replayed) is a call with its stages; a mapping frame's counters
    count every particle's head row twice and its copies as the pool
    changed."""
    with tracing.enable():
        carry, _, gates, step = run_slam(slam)
    assert step.graphs.counts()["replayed"] > step.graphs.counts()["eager"]
    recs = tracing.records()
    assert len(recs.calls) == len(slam["frames"])
    mapped = [c for c in recs.calls
              if "merge" in tracing.stage_ns(c.marks)]
    assert [c.id for c in mapped] == list(np.flatnonzero(gates))
    for call in recs.calls:
        stages = tracing.stage_ns(call.marks)
        assert {"propagate", "project", "centroid"} <= set(stages)
        names = {s.name for s in in_call(recs, call)}
        assert {"frame bind", "frame gates", "frame result",
                "step inputs"} <= names
        got = tracing.counts(call.marks)
        if call in mapped:
            assert "own heads" in stages
            assert got["pool.head_rows_moved"] == 2 * SLAM_N
            assert got["pool.alloc_failed"] == 0
        else:
            assert got == {}
    copied = sum(tracing.counts(c.marks)["pool.heads_copied"]
                 + tracing.counts(c.marks)["pool.heads_started"]
                 for c in mapped)
    assert 0 < copied < 2 * SLAM_N * len(mapped)
    assert int(carry.alloc_failed) == 0


def test_spans_agree_with_record_function_on_the_profiler_clock(tmp_path):
    """A tracer span inside a ``record_function`` and around another: the
    profiler's events, at their ``ts`` plus the trace's
    ``baseTimeNanoseconds``, nest with the span's host times within
    ``TOL_NS`` (the trace keeps microseconds)."""
    tol = 50_000
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof:
        with torch.profiler.record_function("outer rf"):
            time.sleep(0.002)
            with tracing.span("traced"):
                time.sleep(0.002)
                with torch.profiler.record_function("inner rf"):
                    time.sleep(0.002)
                time.sleep(0.002)
            time.sleep(0.002)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base = int(doc["baseTimeNanoseconds"])
    ev = {e["name"]: (base + e["ts"] * 1e3, base + (e["ts"] + e["dur"])
                      * 1e3)
          for e in doc["traceEvents"] if e.get("cat") == "user_annotation"}
    (s,) = tracing.records().spans
    assert s.name == "traced" and s.end - s.start >= 4_000_000
    outer, inner, own = ev["outer rf"], ev["inner rf"], ev["traced"]
    assert outer[0] - tol <= s.start <= inner[0] + tol
    assert inner[1] - tol <= s.end <= outer[1] + tol
    assert own[0] - tol <= s.start and s.end <= own[1] + tol


def test_write_exports_a_chrome_trace(loc, tmp_path):
    with tracing.enable():
        run_loc(loc, loc_runner(loc))
    path = tmp_path / "port.json"
    tracing.write(path)
    doc = json.loads(path.read_text())
    events = doc["traceEvents"]
    stages = [e for e in events if e.get("cat") == "port_stage"]
    assert len(stages) == len(LOC_STAGES) * STEPS
    assert {e["name"] for e in stages} == set(LOC_STAGES)
    spans = [e for e in events if e.get("cat") == "port_span"]
    assert len(spans) == len(tracing.records().spans)
    assert all(e["ts"] >= 0 and e["dur"] >= 0 for e in stages + spans)


def test_stage_times_and_counts_of_marks():
    m = tracing.Mark
    marks = [m("measure", "enter", 0), m("weights", "enter", 10),
             m("measure", "enter", 12), m("measure", "exit", 14),
             m("weights", "exit", 30), m("pool.heads_copied", "count", 3),
             m("measure", "exit", 40), m("pool.heads_copied", "count", 4)]
    # the inner "measure" lies inside the outer and counts once
    assert tracing.stage_ns(marks) == {"measure": 40, "weights": 20}
    assert tracing.counts(marks) == {"pool.heads_copied": 7}
    assert tracing.extent_ns(marks) == 40
    assert tracing.extent_ns(marks[5:6]) is None
