"""Profile the streaming SLAM step op by op.

Counterpart of ``tools/profile_slam.py`` of the JAX package: the SLAM
bench shape (per-particle maps, scan merges; 4,096 particles, 10 m grids
at 0.25 m, chains of 3, ``map_pool_blocks = 4n``, 64 rays) over the
``AsguardSim`` frames, run three times through
``filter.streaming.make_slam_scan_runner``: the first call (the kernels'
``nvcc`` build at first use, then the run), the steady run, and the run
under ``utils.profiling.trace`` (``torch.profiler``).  The Chrome trace's
complete events are summed by name: the card's kernels, copies and memsets
on the GPU, PyTorch's host operators with ``--cpu``.  The chain lookup and
the merge show as ``chain_lookup_kernel`` (K2) and ``block_merge_kernel``
(K3).  The last line gives the share of the device time spent in the
block copies (the kernels that ``index_select`` and ``index_copy_``
launch: the copy-on-write and rollover of ``mapping.map_pool``).

The runner updates the carry's map pool in place, so each of the three
runs starts from a new filter (the same seeded start).

Usage:  python -m slam_eslam_tpu_torch.tools.profile_slam
            [--particles 4096] [--steps 10] [--cpu]
Prints the top ``--top`` ops by total time, with their counts.
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import functools
import gc
import json
import os
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op",)
# the operators whose kernels are the map pool's block copies
COPY_OPS = ("aten::index_select", "aten::index_copy_")
N_RAYS = 64


def trace_file(trace_dir):
    """The newest ``trace.json`` under ``trace_dir``."""
    paths = sorted(Path(trace_dir).rglob("trace.json"),
                   key=lambda p: p.stat().st_mtime)
    if not paths:
        raise FileNotFoundError(f"no trace.json under {trace_dir}")
    return paths[-1]


@functools.lru_cache(maxsize=2)
def _complete_events(path, mtime_ns):
    with open(path) as fh:
        return [ev for ev in json.load(fh)["traceEvents"]
                if ev.get("ph") == "X"]


def complete_events(path):
    """The complete (``"ph": "X"``) events of the Chrome trace at
    ``path``, read once per version of the file."""
    return _complete_events(str(path), Path(path).stat().st_mtime_ns)


def aggregate_trace(trace_dir, top=30):
    """Sum the complete (``"ph": "X"``) events of the newest Chrome trace
    under ``trace_dir`` (``utils.profiling.trace`` writes ``trace.json``)
    by name: the device categories (``kernel``, ``gpu_memcpy``,
    ``gpu_memset``) where the trace has any, else the host operators
    (``cpu_op``; nested operators count at every level).  Returns ``(rows,
    total_ms, path, kind)``: ``rows`` the ``top`` ``(name, (ms, count))``
    pairs by total time (all of them for ``top=None``), ``kind``
    ``"device"`` or ``"host"``."""
    path = trace_file(trace_dir)
    events = complete_events(path)
    device = any(ev.get("cat") in DEVICE_CATEGORIES for ev in events)
    cats = DEVICE_CATEGORIES if device else HOST_CATEGORIES
    agg = defaultdict(lambda: [0.0, 0])
    total = 0.0
    for ev in events:
        if ev.get("cat") not in cats:
            continue
        dur = ev.get("dur", 0) / 1e3  # us -> ms
        agg[ev.get("name", "?")][0] += dur
        agg[ev.get("name", "?")][1] += 1
        total += dur
    rows = sorted(((name, tuple(v)) for name, v in agg.items()),
                  key=lambda kv: -kv[1][0])
    return (rows if top is None else rows[:top]), total, path, (
        "device" if device else "host")


def op_share(trace_dir, ops=COPY_OPS):
    """``(ms, share)``: the device time of the kernels, copies and memsets
    launched inside the host operators ``ops``, and its share of all
    device time in the newest trace under ``trace_dir``.  A device event
    carries the ``External id`` of the innermost operator that launched
    it; it counts when one of ``ops`` encloses that operator on its
    thread.  ``(0.0, 0.0)`` for a trace without device events."""
    events = complete_events(trace_file(trace_dir))
    cpu = [ev for ev in events if ev.get("cat") == "cpu_op"]
    by_id = {ev["args"]["External id"]: ev for ev in cpu
             if "External id" in ev.get("args", {})}
    spans = defaultdict(list)
    for ev in cpu:
        if ev.get("name") in ops:
            spans[ev.get("tid")].append((ev["ts"], ev["ts"] + ev["dur"]))
    for tid in spans:
        spans[tid].sort()
    starts = {tid: [a for a, _ in s] for tid, s in spans.items()}

    def inside(op):
        s = spans.get(op.get("tid"))
        if not s:
            return False
        i = bisect.bisect_right(starts[op["tid"]], op["ts"]) - 1
        # the copy operators never nest in one another: the last span that
        # starts at or before the operator is the only one that can hold it
        return i >= 0 and op["ts"] + op.get("dur", 0) <= s[i][1]

    total = part = 0.0
    for ev in events:
        if ev.get("cat") not in DEVICE_CATEGORIES:
            continue
        dur = ev.get("dur", 0) / 1e3
        total += dur
        op = by_id.get(ev.get("args", {}).get("External id"))
        if op is not None and inside(op):
            part += dur
    return part, (part / total if total else 0.0)


def print_table(rows, total, path, kind):
    print(f"trace: {path}\ntotal {kind} time: {total:.2f} ms"
          + ("" if kind == "device" else
             " (host operators: nested ones count at every level)"))
    for name, (ms, cnt) in rows:
        print(f"{ms:9.3f} ms  x{cnt:<5d} {name[:110]}")


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--particles", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions; the "
                         "table then sums host operators)")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--trace-dir",
                    default=os.path.join(tempfile.gettempdir(), "slam_trace"),
                    help="where the trace goes (default: slam_trace in the "
                         "temporary directory)")
    ap.add_argument("--wheel-delta", type=float, default=0.3,
                    dest="wheel_delta",
                    help="wheel advance per step (10 frames); ~4.7 "
                    "makes the 0.1 m reference measurement gate fire "
                    "EVERY frame (measurement-heavy platforms)")
    ap.add_argument("--gate", default="",
                    help="'dist,angle_deg' override of the "
                    "measurement gate (reference default 0.1,10); "
                    "'0,0' = fire every frame regardless of speed")
    return ap


def slam_config(n, gate=""):
    from slam_eslam_tpu_torch.config import (Config, ContactModelConfig,
                                             UpdateThreshold)

    gate_kw = {}
    if gate:
        d, a = (float(v) for v in gate.split(","))
        gate_kw["measurement_threshold"] = UpdateThreshold(d, np.deg2rad(a))
    return dataclasses.replace(
        Config(), particle_count=n, min_effective=n // 2,
        grid_size=10.0, grid_resolution=0.25,
        map_pool_blocks=4 * n, map_chain_length=3,
        map_pool_color=False,
        contact_model=ContactModelConfig(contact_point_radius=0.0,
                                         min_contacts=2),
        **gate_kw)


def slam_frames(steps, wheel_delta):
    """The script's frames, on the host: the Asguard's full contact state
    on each of the 10 substeps of a step, a 64-ray scan at 2 m on the
    step's last.  Returns ``(z0, SlamFrames)``."""
    from slam_eslam_tpu_torch.bench import slam_terrain
    from slam_eslam_tpu_torch.filter import streaming
    from slam_eslam_tpu_torch.models.asguard import AsguardSim

    sim = AsguardSim(terrain=slam_terrain)
    z0 = float(sim.position[2])
    q = np.array([1.0, 0, 0, 0], np.float32)
    meta = (np.float32(-np.pi / 2), np.float32(np.pi / N_RAYS))
    frames = []

    def cb(s):
        frames.append([s.contact_state(), q,
                       np.asarray(s.position, np.float32),
                       np.full((N_RAYS,), 2.0, np.float32), meta, False])

    for _ in range(steps):
        sim.step(wheel_delta=wheel_delta, on_substep=cb)
        frames[-1][5] = True
    return z0, streaming.stack_frames([tuple(fr) for fr in frames])


def main(argv=None):
    """Run the profile; returns a dict with the first and steady seconds,
    the frame, measurement and mapping counts, the aggregated rows (all of
    them, ``rows_all``), the total, the trace's path and kind, the block
    copies' device ms and share, and the kernel launches of the steady
    run."""
    from slam_eslam_tpu_torch import ops
    from slam_eslam_tpu_torch.filter import streaming
    from slam_eslam_tpu_torch.filter.eslam_filter import EmbodiedSlamFilter
    from slam_eslam_tpu_torch.utils import profiling, tree
    from slam_eslam_tpu_torch.utils.device import card_line, entry_device

    args = parser().parse_args(argv)
    device = entry_device("cpu" if args.cpu else None)
    n = args.particles
    cfg = slam_config(n, args.gate)
    z0, frames = slam_frames(args.steps, args.wheel_delta)
    frames = tree.to(frames, device)
    n_frames = len(frames)
    # eager launches: each run's fresh pool (41 GB at 100,000 particles)
    # would otherwise be copied into the graphs' static one
    run = streaming.make_slam_scan_runner(cfg, laser2body=(np.eye(3),
                                                           np.zeros(3)),
                                          graph=False)

    def fresh():
        f = EmbodiedSlamFilter(config=cfg, device=device).init(
            pose=(np.array([0.0, 0.0, z0]), 0.0), use_shared_map=False)
        return streaming.StreamingState.create(f.state, f.pool)

    def timed():
        # one carry at a time: at 100,000 particles a pool is 41 GB
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        carry = fresh()
        profiling.sync()
        t0 = time.perf_counter()
        out = run(carry, frames)
        del carry
        profiling.sync()
        return time.perf_counter() - t0, out[1]

    print(f"device: {device}" + (f" ({card_line(device)})"
                                 if device.type == "cuda" else ""))
    first_s, _ = timed()
    print(f"compile+first: {first_s:.1f}s (the kernels' build at first use "
          f"and the run)", flush=True)
    before = ops.launch_counts()
    dt, aux = timed()
    launches = {k: v - before[k] for k, v in ops.launch_counts().items()}
    fired, mapped = int(aux["updated"].sum()), int(aux["mapped"].sum())
    print(f"steady: {dt * 1e3:.1f} ms for {n_frames} frames "
          f"({n_frames / dt:.1f} fps); measurement fired {fired}/{n_frames}, "
          f"mapped {mapped}", flush=True)

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    carry = fresh()
    with profiling.trace(args.trace_dir):
        out = run(carry, frames)
        del carry
    del out
    rows_all, total, path, kind = aggregate_trace(args.trace_dir, top=None)
    print_table(rows_all[:args.top], total, path, kind)
    copy_ms, copy_share = op_share(args.trace_dir)
    if kind == "device":
        print(f"block copies (index_select / index_copy_ kernels): "
              f"{copy_ms:.3f} ms = {copy_share:.2%} of the device time")
    return dict(first_s=first_s, steady_s=dt, frames=n_frames, fired=fired,
                mapped=mapped, rows_all=rows_all, total_ms=total, path=path,
                kind=kind, copy_ms=copy_ms, copy_share=copy_share,
                launches=launches, config=cfg)


if __name__ == "__main__":
    main()
