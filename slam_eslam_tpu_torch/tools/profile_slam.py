"""Profile the streaming SLAM step op by op.

Counterpart of ``tools/profile_slam.py`` of the JAX package: the SLAM
bench shape (per-particle maps, scan merges; 4,096 particles, 10 m grids
at 0.25 m, chains of 3, ``map_pool_blocks = 4n``, 64 rays) over the
``AsguardSim`` frames, run through the compiled runner, as the JAX script
runs the jitted one: ``filter.streaming.make_slam_scan_runner``, CUDA
graphs on the card (a gate combination eager at its first meeting,
captured at its second, replayed after), the eager loop on the CPU.  The
first call (the kernels' ``nvcc`` build at first use, then the run; on
the card a second run when a gate combination met once has not been
captured, both traced for their captures), the steady run, and the run
under ``utils.profiling.trace`` (``torch.profiler``; on the card every
frame a replay).  The Chrome trace's complete events are summed by name:
the card's kernels, copies and memsets on the GPU, PyTorch's host
operators with ``--cpu``; on the card the total comes with the device
records the tracer kept against the launches the host made (a graph
launch counts the launches its capture recorded), and a trace with no
device record raises.  The chain lookup and the merge show as
``chain_lookup_kernel`` (K2) and ``block_merge_kernel`` (K3).  The last
line gives the share of the device time spent in the block copies (the
copy-on-write and rollover of ``mapping.map_pool``: the row-copy kernel
of ``ops.row_copy``, and the kernels that ``index_select`` and
``index_copy_`` launch); a replayed kernel takes the operator of the
launch its capture recorded in its place (``attribute``).

The runner updates the carry's map pool in place, so every run starts
from a new filter (the same seeded start) whose pool is that one pool,
refilled in place (``MapPool.refill_``): one pool on the card.

Usage:  python -m slam_eslam_tpu_torch.tools.profile_slam
            [--particles 4096] [--steps 10] [--cpu]
Prints the top ``--top`` ops by total time, with their counts.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
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

from slam_eslam_tpu_torch.utils.graphs import CAPTURE_SPAN, REPLAY_SPAN

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op",)
RUNTIME_CATEGORIES = ("cuda_runtime", "cuda_driver")
# the operators whose kernels are the map pool's block copies
COPY_OPS = ("aten::index_select", "aten::index_copy_")
# and the kernels that are block copies by themselves (``ops.row_copy``)
COPY_KERNELS = ("row_copy_kernel",)
N_RAYS = 64


class UnattributedKernel(RuntimeError):
    """A replayed kernel that the traces given cannot tie to the operator
    that captured it."""


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


def launch_kind(name):
    """The device record a host runtime call puts on the card:
    ``"kernel"`` for a kernel launch, ``"gpu_memcpy"`` / ``"gpu_memset"``
    for a copy or a memset, None for any other call (a graph launch, a
    sync, a capture's own bookkeeping)."""
    if "LaunchKernel" in name:
        return "kernel"
    if "Memcpy" in name:
        return "gpu_memcpy"
    if "Memset" in name:
        return "gpu_memset"
    return None


class Trace:
    """The complete events of one Chrome trace of ``torch.profiler``,
    sorted for the analysis: the device records, the host operators, the
    runtime calls and the spans of ``utils.graphs`` (a CUDA graph's
    capture and replays).  ``ops``: the operators whose kernels
    ``in_ops`` tells apart (the block copies by default)."""

    def __init__(self, path, ops=COPY_OPS):
        events = complete_events(path)
        self.device = [ev for ev in events
                       if ev.get("cat") in DEVICE_CATEGORIES]
        self.runtime = sorted((ev for ev in events
                               if ev.get("cat") in RUNTIME_CATEGORIES),
                              key=lambda ev: ev["ts"])
        cpu = [ev for ev in events if ev.get("cat") == "cpu_op"]
        self.by_id = {ev["args"]["External id"]: ev for ev in cpu
                      if "External id" in ev.get("args", {})}
        self.spans = defaultdict(list)
        for ev in cpu:
            if ev.get("name") in ops:
                self.spans[ev.get("tid")].append(
                    (ev["ts"], ev["ts"] + ev["dur"]))
        for tid in self.spans:
            self.spans[tid].sort()
        self.starts = {tid: [a for a, _ in s]
                       for tid, s in self.spans.items()}
        self.graph_spans = {
            prefix: sorted((ev["ts"], ev["ts"] + ev.get("dur", 0),
                            int(ev["name"][len(prefix):]))
                           for ev in events
                           if ev.get("cat") == "user_annotation"
                           and ev.get("name", "").startswith(prefix))
            for prefix in (CAPTURE_SPAN, REPLAY_SPAN)}
        # the runtime calls made while a stream was captured: they put
        # nothing on the card then
        self.captured = set()
        inside = False
        for ev in self.runtime:
            if "BeginCapture" in ev["name"]:
                inside = True
            elif "EndCapture" in ev["name"]:
                inside = False
            elif inside:
                self.captured.add(id(ev))

    def in_ops(self, external_id):
        """Whether the operator of ``external_id`` lies inside one of the
        ``ops`` on its thread, however deep."""
        op = self.by_id.get(external_id)
        if op is None:
            return False
        s = self.spans.get(op.get("tid"))
        if not s:
            return False
        i = bisect.bisect_right(self.starts[op["tid"]], op["ts"]) - 1
        # the copy operators never nest in one another: the last span that
        # starts at or before the operator is the only one that can hold it
        return i >= 0 and op["ts"] + op.get("dur", 0) <= s[i][1]

    def eager_launches(self):
        """The runtime calls that put a record on the card outside every
        capture."""
        return [ev for ev in self.runtime if launch_kind(ev["name"])
                and id(ev) not in self.captured]

    def _span_of(self, prefix, ts):
        spans = self.graph_spans[prefix]
        i = bisect.bisect_right(spans, (ts, float("inf"), 0)) - 1
        return spans[i][2] if i >= 0 and ts <= spans[i][1] else None

    def captures(self):
        """``{graph number: [(record kind, inside ops)]}``: the launches a
        capture recorded, in order, each with whether the operator that
        made it lies inside ``ops`` (what a replay of that graph puts on
        the card, record by record)."""
        out = defaultdict(list)
        for ev in self.runtime:
            kind = launch_kind(ev["name"])
            if kind is None or id(ev) not in self.captured:
                continue
            number = self._span_of(CAPTURE_SPAN, ev["ts"])
            if number is not None:
                out[number].append((kind, self.in_ops(
                    ev.get("args", {}).get("External id"))))
        return dict(out)

    def replays(self):
        """``[(graph number or None, [device records in order])]``, one
        entry per graph launch."""
        launches = {ev.get("args", {}).get("correlation"): ev
                    for ev in self.runtime if "GraphLaunch" in ev["name"]}
        records = defaultdict(list)
        for ev in self.device:
            corr = ev.get("args", {}).get("correlation")
            if corr in launches:
                records[corr].append(ev)
        return [(self._span_of(REPLAY_SPAN, ev["ts"]),
                 sorted(records.get(corr, ()), key=lambda r: r["ts"]))
                for corr, ev in launches.items()]


def attribute(trace_dir, captures=(), ops=COPY_OPS):
    """Every device record of the newest trace under ``trace_dir``, each
    with whether an operator of ``ops`` launched it, and the launches the
    host made.  Returns ``(records [(event, inside ops)], launched)``.

    An eager record carries the ``External id`` of the operator that
    launched it.  A replayed one carries only its ``cudaGraphLaunch``'s
    correlation: its graph (the ``utils.graphs`` replay span around the
    launch) is found among the captures of this trace and of the traces
    under ``captures`` (a warm-up that captured), and the replay's records
    take, one to one and in order, the launches the capture recorded with
    their operators; their kinds must agree, and every whole replay of a
    graph must show the same kernels.  A replay that lost records is
    attributed by kernel name, where that graph's whole replays tie the
    name to one answer.  ``launched``: the host's launch calls outside
    captures plus, per graph launch, the launches its capture recorded.
    A replayed record that cannot be attributed so raises
    ``UnattributedKernel``."""
    main = Trace(trace_file(trace_dir), ops)
    traces = [main] + [Trace(trace_file(d), ops) for d in captures]
    nodes = {}
    for tr in traces:
        nodes.update(tr.captures())
    replays = [(tr is main, number, recs)
               for tr in traces for number, recs in tr.replays()]
    names = {}    # graph number -> the kernels of its whole replays
    for in_main, number, recs in replays:
        if number not in nodes:
            if in_main:
                raise UnattributedKernel(
                    f"{len(recs)} records of a graph launch whose capture "
                    f"is in none of the traces given (graph {number})")
            continue
        want = nodes[number]
        if len(recs) > len(want):
            raise UnattributedKernel(
                f"a replay of graph {number} has {len(recs)} device "
                f"records, its capture {len(want)} launches")
        if len(recs) < len(want):
            continue
        kinds = [r["cat"] for r in recs]
        if kinds != [k for k, _ in want]:
            raise UnattributedKernel(
                f"a replay of graph {number} ran {kinds}, its capture "
                f"recorded {[k for k, _ in want]}")
        seen = tuple(r["name"] for r in recs)
        if names.setdefault(number, seen) != seen:
            raise UnattributedKernel(
                f"two replays of graph {number} ran other kernels")
    records, launched = [], len(main.eager_launches())
    replayed = set()
    for in_main, number, recs in replays:
        if in_main:
            launched += len(nodes[number])
            replayed.update(id(r) for r in recs)
            records += _replay_records(number, recs, nodes[number],
                                       names.get(number))
    records += [(ev, main.in_ops(ev.get("args", {}).get("External id")))
                for ev in main.device if id(ev) not in replayed]
    return records, launched


def _replay_records(number, recs, want, names):
    """The records of one replay of graph ``number``, each with whether
    its capture's launch lay inside the operators: by position for a
    whole replay, by kernel name (``names``: the kernels of its whole
    replays, None if it had none) for one that lost records."""
    if len(recs) == len(want):
        return [(r, inside) for r, (_, inside) in zip(recs, want)]
    if names is None:
        raise UnattributedKernel(
            f"a replay of graph {number} lost {len(want) - len(recs)} of "
            f"its {len(want)} records and no whole replay of it names its "
            f"kernels")
    by_name = defaultdict(set)
    for name, (_, inside) in zip(names, want):
        by_name[name].add(inside)
    out = []
    for r in recs:
        answer = by_name.get(r["name"], ())
        if len(answer) != 1:
            raise UnattributedKernel(
                f"kernel {r['name'][:80]!r} of a replay of graph {number} "
                f"that lost records: its graph ties the name to "
                f"{sorted(answer) or 'no launch'}")
        out.append((r, next(iter(answer))))
    return out


def aggregate_trace(trace_dir, top=30, on_card=False):
    """Sum the complete (``"ph": "X"``) events of the newest Chrome trace
    under ``trace_dir`` (``utils.profiling.trace`` writes ``trace.json``)
    by name: the device categories (``kernel``, ``gpu_memcpy``,
    ``gpu_memset``) where the trace has any, else the host operators
    (``cpu_op``; nested operators count at every level).  Returns ``(rows,
    total_ms, path, kind)``: ``rows`` the ``top`` ``(name, (ms, count))``
    pairs by total time (all of them for ``top=None``), ``kind``
    ``"device"`` or ``"host"``.  ``on_card``: the run was on the card, so
    a trace without a device record lost them: raises
    ``utils.profiling.ProfilerLostRecords``."""
    path = trace_file(trace_dir)
    events = complete_events(path)
    device = any(ev.get("cat") in DEVICE_CATEGORIES for ev in events)
    if on_card and not device:
        from slam_eslam_tpu_torch.utils.profiling import ProfilerLostRecords

        raise ProfilerLostRecords(
            f"{path}: torch.profiler kept no device record of "
            f"{len(Trace(path).eager_launches())} launch calls and "
            f"{sum('GraphLaunch' in ev.get('name', '') for ev in events)} "
            f"graph launches")
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


def device_records(trace_dir, captures=()):
    """``(kept, launched)``: the device records the newest trace under
    ``trace_dir`` holds and the launches the host made in it (``attribute``;
    a graph launch counts the launches its capture recorded).  Fewer kept
    than launched: the tracer lost records."""
    records, launched = attribute(trace_dir, captures)
    return len(records), launched


def op_share(trace_dir, ops=COPY_OPS, captures=(), kernels=COPY_KERNELS):
    """``(ms, share)``: the device time of the kernels, copies and memsets
    launched inside the host operators ``ops`` or named by one of
    ``kernels``, and its share of all device time in the newest trace
    under ``trace_dir``.  An eager device
    event carries the ``External id`` of the innermost operator that
    launched it; it counts when one of ``ops`` encloses that operator on
    its thread.  A replayed one counts when the launch its capture
    recorded in its place does (``attribute``; ``captures``: the traces
    of the captures).  ``(0.0, 0.0)`` for a trace without device
    events."""
    records, _ = attribute(trace_dir, captures, ops)
    total = part = 0.0
    for ev, inside in records:
        dur = ev.get("dur", 0) / 1e3
        total += dur
        if inside or any(k in ev.get("name", "") for k in kernels):
            part += dur
    return part, (part / total if total else 0.0)


def print_table(rows, total, path, kind, records=None):
    """The table of ``aggregate_trace``'s rows; ``records``: ``(kept,
    launched)`` of ``device_records``, printed beside the total."""
    print(f"trace: {path}\ntotal {kind} time: {total:.2f} ms"
          + ("" if kind == "device" else
             " (host operators: nested ones count at every level)")
          + ("" if records is None else
             f" (device records {records[0]:,} of {records[1]:,} "
             f"launches)"))
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


def warm_up(run_once, run, device, trace_dir):
    """The warm-up: one run, and a second when the runner's graphs have
    not settled (a gate combination met once ran eagerly: its next
    meeting would capture).  On the card, where the runner captures CUDA
    graphs (``utils.graphs.supported``), the warm-up is traced into
    ``trace_dir``: its captures tie each replayed kernel of a later trace
    to its operator.  Returns the seconds of each run and whether the
    runner is graphed."""
    from slam_eslam_tpu_torch.utils import graphs, profiling

    graphed = graphs.supported(device)
    with (profiling.trace(trace_dir) if graphed
          else contextlib.nullcontext()):
        seconds = [run_once()]
        while graphed and not run.graphs.settled():
            seconds.append(run_once())
    return seconds, graphed


def main(argv=None):
    """Run the profile; returns a dict with the first and steady seconds,
    the frame, measurement and mapping counts, the aggregated rows (all of
    them, ``rows_all``), the total, the trace's path and kind, the block
    copies' device ms and share, the device records kept and the launches
    made in the trace (``records``), whether the runner replayed CUDA
    graphs (``graphed``), the runs made (``runs``: the warm-up's, the
    steady and the traced one), the frames the traced run ran eagerly,
    captured and replayed (``traced``) and the kernel launches of the
    steady run."""
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
    # the compiled runner: CUDA graphs on the card, the eager loop on the
    # CPU (utils.graphs.resolve)
    run = streaming.make_slam_scan_runner(cfg, laser2body=(np.eye(3),
                                                           np.zeros(3)))
    box = []

    def fresh():
        # the runner updates its carry's pool in place: every run refills
        # that one pool (41 GB at 100,000 particles)
        pool = box.pop().pool if box else None
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        f = EmbodiedSlamFilter(config=cfg, device=device).init(
            pose=(np.array([0.0, 0.0, z0]), 0.0), use_shared_map=False,
            pool=pool)
        return streaming.StreamingState.create(f.state, f.pool)

    def once():
        carry = fresh()
        profiling.sync()
        t0 = time.perf_counter()
        out = run(carry, frames)
        del carry
        box.append(out[0])
        profiling.sync()
        return time.perf_counter() - t0, out[1]

    print(f"device: {device}" + (f" ({card_line(device)})"
                                 if device.type == "cuda" else ""))
    warm_dir = os.path.join(args.trace_dir, "warm-up")
    seconds, graphed = warm_up(lambda: once()[0], run, device, warm_dir)
    print(f"compile+first: {seconds[0]:.1f}s (the kernels' build at first "
          f"use and the run" + (f", traced; {len(seconds)} warm-up run(s) "
                                f"until every gate combination replays a "
                                f"CUDA graph)" if graphed else ")"),
          flush=True)
    before = ops.launch_counts()
    dt, aux = once()
    launches = {k: v - before[k] for k, v in ops.launch_counts().items()}
    fired, mapped = int(aux["updated"].sum()), int(aux["mapped"].sum())
    print(f"steady: {dt * 1e3:.1f} ms for {n_frames} frames "
          f"({n_frames / dt:.1f} fps); measurement fired {fired}/{n_frames}, "
          f"mapped {mapped}; " + ("graphed (CUDA graphs replayed)"
                                  if graphed else "eager"), flush=True)

    carry = fresh()
    counted = run.graphs.counts() if graphed else {}
    with profiling.trace(args.trace_dir):
        out = run(carry, frames)
        del carry
    box.append(out[0])
    del out
    # what the traced run did: eager, captured and replayed frames
    traced = ({k: v - counted.get(k, 0)
               for k, v in run.graphs.counts().items()} if graphed
              else {"eager": n_frames})
    on_card = device.type == "cuda"
    captures = (warm_dir,) if graphed else ()
    rows_all, total, path, kind = aggregate_trace(args.trace_dir, top=None,
                                                  on_card=on_card)
    records = device_records(args.trace_dir, captures) if on_card else None
    print_table(rows_all[:args.top], total, path, kind, records)
    copy_ms, copy_share = op_share(args.trace_dir, captures=captures)
    if kind == "device":
        print(f"block copies (row_copy, index_select and index_copy_ "
              f"kernels): "
              f"{copy_ms:.3f} ms = {copy_share:.2%} of the device time"
              + (" (replayed kernels attributed through their captures)"
                 if graphed else ""))
    return dict(first_s=seconds[0], steady_s=dt, frames=n_frames,
                fired=fired, mapped=mapped, rows_all=rows_all,
                total_ms=total, path=path, kind=kind, copy_ms=copy_ms,
                copy_share=copy_share, launches=launches, config=cfg,
                graphed=graphed, records=records, runs=len(seconds) + 2,
                traced=traced)


if __name__ == "__main__":
    main()
