"""The readers of the port's own tracer (``harness.program_trace`` and the
four metrics that read it) on synthetic records: the calls of the traced
stretch chosen by the trace's ``baseTimeNanoseconds``, nothing where a
call there replayed an untraced graph or lost marks, or where the port has
no tracer, and each metric's arithmetic."""

import json
import sys

import pytest

from benchmark.harness import metrics, program_trace, trace
from slam_eslam_tpu_torch.utils.tracing import Call, Mark, Records, Span

BASE = 1_790_000_000_000_000_000
MS = 1_000_000
NEW = ("update_device_ms.loc", "mapping_frame_device_ms.slam",
       "needless_head_copy_share.slam", "frame_host_ms.slam")


def window_trace(tmp_path, start_us=1000, dur_us=100_000):
    """A trace whose window span covers ``start_us`` for ``dur_us`` after
    its base time."""
    path = tmp_path / "window.json"
    path.write_text(json.dumps({
        "schemaVersion": 1, "baseTimeNanoseconds": BASE,
        "traceEvents": [{"ph": "X", "cat": "user_annotation",
                         "name": trace.WINDOW_SPAN, "ts": start_us,
                         "dur": dur_us, "pid": 1, "tid": 1}]}))
    return trace.Trace(path)


def stage(name, t0, t1):
    return [Mark(name, "enter", t0), Mark(name, "exit", t1)]


def loc_step(t):
    """One localisation step's marks from ``t`` ns: weights 0.3 ms and
    resample 0.2 ms of its 0.9 ms."""
    return (stage("odometry", t, t + 50_000)
            + stage("project", t + 50_000, t + 150_000)
            + stage("weights", t + 150_000, t + 450_000)
            + stage("resample", t + 450_000, t + 650_000)
            + stage("centroid", t + 650_000, t + 900_000))


def mapping_frame(t, copied, started, n=1000):
    """A SLAM mapping frame's marks from ``t`` ns, 22 ms long."""
    return (stage("propagate", t, t + MS)
            + [Mark("own heads", "enter", t + MS)]
            + [Mark("pool.head_rows_moved", "count", n),
               Mark("pool.heads_copied", "count", copied),
               Mark("pool.alloc_failed", "count", 0),
               Mark("pool.head_rows_moved", "count", n),
               Mark("pool.heads_started", "count", started),
               Mark("pool.alloc_failed", "count", 0)]
            + [Mark("own heads", "exit", t + 20 * MS)]
            + stage("merge", t + 20 * MS, t + 21 * MS)
            + stage("centroid", t + 21 * MS, t + 22 * MS))


def records(calls):
    """``Records`` of ``calls``: ``(start ns after the base, length ns,
    replay ns, marks[, untraced])`` each, a call span with one replay span
    inside."""
    spans, out = [], []
    for i, (start, length, replay, marks, *untraced) in enumerate(calls):
        t = BASE + start
        spans.append(Span("make_slam_step", t, t + length, None, i))
        out.append(Call(i, "make_slam_step", len(spans) - 1,
                        untraced[0] if untraced else 0, 0,
                        [m._replace(value=BASE + m.value)
                         if m.kind != "count" else m for m in marks]))
        spans.append(Span("graph replay 4", t + 1000, t + 1000 + replay,
                          len(spans) - 1, i))
    return Records(spans, out, [])


def read(name, tr, recs):
    return metrics.load_reader(name)({"trace": tr, "program_records": recs})


def test_the_stretch_is_chosen_by_the_trace_base_time(tmp_path):
    """The window covers 1-101 ms after the base: the calls at 0.5 ms and
    150 ms lie outside it, so only the middle frame counts."""
    tr = window_trace(tmp_path)
    assert program_trace.base_ns(tr.path) == BASE
    recs = records([
        (500_000, 3 * MS, MS, mapping_frame(500_000, 1000, 1000)),
        (50 * MS, 3 * MS, MS, mapping_frame(50 * MS, 100, 0)),
        (150 * MS, 3 * MS, MS, mapping_frame(150 * MS, 0, 0)),
    ])
    inside, _ = program_trace.calls({"trace": tr, "program_records": recs},
                                    "test")
    assert [c.id for c in inside] == [1]
    assert read("needless_head_copy_share.slam", tr, recs) == \
        pytest.approx(95.0)
    assert read("mapping_frame_device_ms.slam", tr, recs) == \
        pytest.approx(22.0)
    assert read("frame_host_ms.slam", tr, recs) == pytest.approx(2.0)


def test_the_metrics_arithmetic(tmp_path):
    tr = window_trace(tmp_path)
    slam = records([
        (2 * MS, 4 * MS, MS, mapping_frame(2 * MS, 200, 0)),
        (10 * MS, 3 * MS, 2 * MS, mapping_frame(10 * MS, 0, 100)),
        # a frame that does not map: no counters, not a mapping frame
        (20 * MS, 1 * MS, MS // 2, stage("propagate", 20 * MS, 21 * MS)),
    ])
    # 2,000 rows written a mapping frame, 300 of 4,000 needed
    assert read("needless_head_copy_share.slam", tr, slam) == \
        pytest.approx(100.0 * (1 - 300 / 4000))
    assert read("mapping_frame_device_ms.slam", tr, slam) == \
        pytest.approx(22.0)
    # outside the replays: 3, 1 and 0.5 ms
    assert read("frame_host_ms.slam", tr, slam) == pytest.approx(1.5)
    loc = records([(5 * MS, 4 * MS, 3 * MS,
                    loc_step(5 * MS) + loc_step(6 * MS) + loc_step(7 * MS))])
    assert read("update_device_ms.loc", tr, loc) == pytest.approx(0.5)


@pytest.mark.parametrize("broken", ["untraced", "lost", "none inside"])
def test_nothing_where_the_stretch_is_not_whole(tmp_path, broken):
    tr = window_trace(tmp_path)
    recs = records([(2 * MS, 3 * MS, MS, mapping_frame(2 * MS, 10, 10),
                     int(broken == "untraced"))])
    if broken == "lost":
        recs.calls[0].lost = 2
    if broken == "none inside":
        recs = records([(200 * MS, 3 * MS, MS,
                         mapping_frame(200 * MS, 10, 10))])
    for name in NEW:
        assert read(name, tr, recs) is None, name


def test_nothing_without_the_tracer(tmp_path, monkeypatch):
    """A port without ``utils.tracing`` (the parent of the tracer): every
    reader gives nothing and none raises."""
    import slam_eslam_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "tracing")
    monkeypatch.setitem(sys.modules, "slam_eslam_tpu_torch.utils.tracing",
                        None)
    tr = window_trace(tmp_path)
    ctx = {"trace": tr}
    for name in NEW:
        assert metrics.load_reader(name)(ctx) is None, name


def test_nothing_where_the_tracer_refuses_its_records(tmp_path,
                                                      monkeypatch):
    """A device that wrote other marks than the tracer accounted for: the
    readers give nothing and none raises."""
    from slam_eslam_tpu_torch.utils import tracing

    def refuse():
        raise RuntimeError("the trace ring of cuda:0 counts 3 records where "
                           "the host accounted for 2")

    monkeypatch.setattr(tracing, "records", refuse)
    ctx = {"trace": window_trace(tmp_path)}
    for name in NEW:
        assert metrics.load_reader(name)(ctx) is None, name


def test_the_new_metrics_are_read_in_their_cells():
    bench = json.loads((metrics.ROOT / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    assert [m["name"] for m in bench["per_layer"][-4:]] == list(NEW)
    assert per_layer["update_device_ms.loc"]["workloads"] == [
        "loc_100k.replay"]
    for name in NEW[1:]:
        assert per_layer[name]["workloads"] == ["slam_1k.online"]
    loc = {m["name"] for m in metrics.applicable(bench, "loc_100k.replay")}
    slam = {m["name"] for m in metrics.applicable(bench, "slam_1k.online")}
    assert "update_device_ms.loc" in loc and set(NEW[1:]) <= slam
