"""The camera cell's two readers on recorded traces:
``camera_frame_device_ms.cam`` on synthetic tracer records (the camera
frames of the stretch, from their first stamp to their last) and
``camera_merge_roofline_share`` on a small Chrome trace, with the
bound's arithmetic of ``roofline/merge_cloud.py``; each finds nothing
where its records are missing."""

import json
import math

import pytest
import torch

from benchmark.harness import metrics, trace
from benchmark.roofline import merge_cloud
from benchmark.tests.test_harness_program_trace import (MS, records, stage,
                                                        window_trace)
from slam_eslam_tpu_torch.utils.tracing import Mark


def camera_frame(t, length_ms):
    return (stage("propagate", t, t + MS)
            + stage("own heads", t + MS, t + 2 * MS)
            + stage("camera cloud", t + 2 * MS, t + 3 * MS)
            + [Mark("merge", "enter", t + 3 * MS),
               Mark("merge.points", "count", 307_200_000),
               Mark("merge.cells", "count", 600_000),
               Mark("merge", "exit", t + (length_ms - 1) * MS)]
            + stage("centroid", t + (length_ms - 1) * MS, t + length_ms * MS))


def plain_frame(t):
    return stage("propagate", t, t + MS) + stage("centroid", t + MS, t + 2 * MS)


def test_camera_frame_device_ms(tmp_path):
    tr = window_trace(tmp_path, start_us=1000, dur_us=100_000)
    recs = records([(2 * MS, 3 * MS, 10_000, plain_frame(2 * MS)),
                    (10 * MS, 9 * MS, 10_000, camera_frame(10 * MS, 8)),
                    (30 * MS, 13 * MS, 10_000, camera_frame(30 * MS, 12)),
                    (50 * MS, 3 * MS, 10_000, plain_frame(50 * MS))])
    read = metrics.load_reader("camera_frame_device_ms.cam")
    assert read({"trace": tr, "program_records": recs}) == pytest.approx(10.0)
    # no camera frame in the stretch: nothing
    plain = records([(2 * MS, 3 * MS, 10_000, plain_frame(2 * MS))])
    assert read({"trace": tr, "program_records": plain}) is None
    # a replay of a graph captured without marks: nothing
    untraced = records([(10 * MS, 9 * MS, 10_000, camera_frame(10 * MS, 8),
                         1)])
    assert read({"trace": tr, "program_records": untraced}) is None


def test_camera_merge_roofline_share(tmp_path):
    ev = [{"ph": "X", "name": n, "cat": c, "ts": ts, "dur": d, "pid": 1,
           "tid": 1, "args": {}} for n, c, ts, d in (
        (trace.WINDOW_SPAN, "user_annotation", 0, 10_000),
        ("void (anonymous namespace)::cloud_merge_kernel<4, float, true>("
         "Operands, int)", "kernel", 100, 2_000),
        ("void (anonymous namespace)::cloud_merge_kernel<4, float, true>("
         "Operands, int)", "kernel", 5_000, 2_000),
        ("block_merge_kernel", "kernel", 8_000, 100))]
    path = tmp_path / "window.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    tr = trace.Trace(path)
    read = metrics.load_reader("camera_merge_roofline_share")
    # two merges of 2 ms each against a bound of 0.5 ms each
    assert read({"trace": tr, "cloud_merge_bound_s": 1e-3}) == pytest.approx(
        25.0)
    assert read({"trace": tr}) is None
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"traceEvents": []}))
    assert read({"trace": trace.Trace(empty),
                 "cloud_merge_bound_s": 1e-3}) is None


def test_the_bound_reads_the_placements_and_cells():
    """Two poses over a cloud of 6 points, 5 valid: the placements that
    fall in each block and the distinct cells they hit; bytes and
    operations as the module states them."""
    xy = torch.tensor([[0.01, 0.01], [0.02, 0.03], [0.11, 0.01],
                       [0.30, 0.30], [-5.0, 0.0], [0.04, 0.04]])
    valid = torch.tensor([True, True, True, True, True, False])
    x, y = torch.tensor([0.0, 0.0]), torch.tensor([0.0, 1.0])
    yaw = torch.zeros(2)
    origin = torch.tensor([[0.0, 0.0], [0.0, 0.95]])
    placed, cells = merge_cloud.placements(x, y, yaw, origin, xy, valid,
                                           0.1, 4, 4)
    # particle 0: 4 points in its 0.4 m block (the far one out), cells
    # (0,0) twice, (1,0), (3,3); particle 1 the same, shifted by 0.05 m
    assert placed == 8
    assert cells == 6
    n, p, k = 2, 6, 4
    b = merge_cloud.needed_bytes(n, p, cells, k, 4, True)
    assert b == p * 29 + n * 36 + 2 * cells * k * (3 * 4 + 4 + 3 * 4)
    assert merge_cloud.needed_ops(placed, True) == 8 * 28
    assert merge_cloud.needed_ops(placed, False) == 8 * 22
    s = merge_cloud.bound_seconds(n, p, placed, cells, k, 4, True)
    assert s == pytest.approx(max(b / merge_cloud.PEAKS["hbm_bytes_per_s"],
                                  8 * 28 / merge_cloud.PEAKS[
                                      "fp32_flops_per_s"]))
    assert math.isfinite(s)
