"""The trace reduction and the per-layer readers on a small recorded
trace (a Chrome trace written by hand in torch.profiler's layout)."""

import json

import pytest

from benchmark.harness import attribute, metrics, trace


def event(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": 1, "args": args}


@pytest.fixture
def recorded(tmp_path):
    # a window of 100 us: two graph replays of 10 us host each, kernels on
    # the card at 10-30, 25-40 (overlapping) and 60-70, K1 among them
    ev = [
        event(trace.WINDOW_SPAN, "user_annotation", 0, 100),
        event("chunk dispatch", "user_annotation", 0, 50),
        event(trace.REPLAY_SPAN + "3", "user_annotation", 5, 10),
        event(trace.REPLAY_SPAN + "3", "user_annotation", 45, 10),
        event("pose read", "user_annotation", 50, 50),
        event("contact_fold_kernel(float const*)", "kernel", 10, 20),
        event("add_kernel", "kernel", 25, 15),
        event("contact_fold_kernel(float const*)", "kernel", 60, 10),
        event("outside", "kernel", 150, 10),
    ]
    path = tmp_path / "window.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return trace.Trace(path)


def test_busy_idle_and_breakdown(recorded):
    tr = recorded
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy() == pytest.approx(40e-6)       # 10-40 and 60-70
    ops = dict((n, s) for n, s in tr.top_ops())
    assert ops["contact_fold_kernel(float const*)"] == pytest.approx(30e-6)
    gaps = tr.idle_gaps()
    assert gaps[0] == ["pose read", pytest.approx(30e-6)]     # 70-100
    # 0-10: the graph launch open at its middle
    assert ["graph replay", pytest.approx(10e-6)] in gaps
    assert ["pose read", pytest.approx(20e-6)] in gaps        # 40-60
    fields, breakdown = trace.summary(tr)
    assert fields["busy_s"] == pytest.approx(40e-6)
    assert len(breakdown["device_ops"]) <= 10


def test_readers(recorded):
    ctx = {"trace": recorded, "steps": 2, "k1_bound_s": 6e-6}
    read = lambda name: metrics.load_reader(name)(ctx)
    assert read("graph_launch_host_ms.loc") == pytest.approx(0.01)
    assert read("step_device_ms.loc") == pytest.approx(45e-6 / 2 * 1e3)
    assert read("device_idle_share.loc") == pytest.approx(60.0)
    # two K1 launches, 6 us bound each, 30 us on the card
    assert read("k1_roofline_share") == pytest.approx(40.0)
    assert metrics.load_reader("k3_roofline_share")(ctx) is None


def test_a_reader_finds_nothing_without_records(tmp_path):
    path = tmp_path / "empty.json"
    path.write_text(json.dumps({"traceEvents": []}))
    ctx = {"trace": trace.Trace(path), "steps": 10}
    for name in ("step_device_ms.loc", "device_idle_share.slam",
                 "graph_launch_host_ms.slam", "k1_roofline_share"):
        assert metrics.load_reader(name)(ctx) is None


def test_replayed_copies_are_tied_to_their_capture(tmp_path):
    """A replay's records take the operators its capture recorded: the
    first launch of graph 7 was an ``index_copy_`` inside the pool's
    rollover span, the second an add outside it."""
    cap = [
        event(trace.CAPTURE_SPAN + "7", "user_annotation", 0, 100),
        event("pool rollover", "user_annotation", 5, 40),
        event("aten::index_copy_", "cpu_op", 10, 20, **{"External id": 1}),
        event("aten::add", "cpu_op", 60, 10, **{"External id": 2}),
        event("cudaStreamBeginCapture", "cuda_runtime", 1, 1),
        event("cudaLaunchKernel", "cuda_runtime", 12, 1,
              **{"External id": 1}),
        event("cudaLaunchKernel", "cuda_runtime", 62, 1,
              **{"External id": 2}),
        event("cudaStreamEndCapture", "cuda_runtime", 90, 1),
    ]
    win = [
        event(trace.WINDOW_SPAN, "user_annotation", 1000, 1000),
        event(trace.REPLAY_SPAN + "7", "user_annotation", 1010, 20),
        event("cudaGraphLaunch", "cuda_runtime", 1012, 5, correlation=99),
        event("index_copy_kernel", "kernel", 1100, 300, correlation=99),
        event("add_kernel", "kernel", 1400, 100, correlation=99),
    ]
    (tmp_path / "warm.json").write_text(json.dumps({"traceEvents": cap}))
    (tmp_path / "window.json").write_text(json.dumps({"traceEvents": win}))
    recs = attribute.attribute(tmp_path / "window.json",
                               tmp_path / "warm.json",
                               ("aten::index_copy_",), ("pool rollover",))
    part, share = attribute.share(recs)
    assert part == pytest.approx(300e-6) and share == pytest.approx(0.75)
