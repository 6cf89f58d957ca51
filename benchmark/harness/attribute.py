"""Which host code launched each device record of a trace, CUDA graph
replays included.

Copied from the port's ``tools/profile_slam.py`` (``Trace.captures``,
``Trace.replays``, ``attribute``) and narrowed to what the benchmark
reads: whether a record was launched by one of the operators ``ops``
inside one of the harness's spans ``spans``.  An eager record carries the
``External id`` of the operator that launched it.  A replayed record
carries only its ``cudaGraphLaunch``'s correlation: the replay's graph
(the port's ``graph replay N`` span around the launch) is found among the
captures of the capture trace (the warm-up, traced), and the replay's
records take, one to one and in order, the launches its capture recorded
with their operators.  A replay that lost records is matched by kernel
name where the graph's whole replays tie the name to one answer.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

from benchmark.harness.trace import (CAPTURE_SPAN, DEVICE_CATEGORIES,
                                     REPLAY_SPAN, RUNTIME_CATEGORIES)


class Unattributed(RuntimeError):
    """A replayed record that the traces cannot tie to its capture."""


def launch_kind(name):
    if "LaunchKernel" in name:
        return "kernel"
    if "Memcpy" in name:
        return "gpu_memcpy"
    if "Memset" in name:
        return "gpu_memset"
    return None


class Events:
    """The complete events of one Chrome trace, sorted for attribution."""

    def __init__(self, path, ops, spans):
        with open(path) as fh:
            events = [ev for ev in json.load(fh)["traceEvents"]
                      if ev.get("ph") == "X"]
        self.device = [ev for ev in events
                       if ev.get("cat") in DEVICE_CATEGORIES]
        self.runtime = sorted((ev for ev in events
                               if ev.get("cat") in RUNTIME_CATEGORIES),
                              key=lambda ev: ev["ts"])
        cpu = [ev for ev in events if ev.get("cat") == "cpu_op"]
        self.by_id = {ev["args"]["External id"]: ev for ev in cpu
                      if "External id" in ev.get("args", {})}
        self.ops = defaultdict(list)
        for ev in cpu:
            if ev.get("name") in ops:
                self.ops[ev.get("tid")].append((ev["ts"],
                                                ev["ts"] + ev["dur"]))
        self.spans = defaultdict(list)
        for ev in events:
            if ev.get("cat") == "user_annotation" and ev.get("name") in spans:
                self.spans[ev.get("tid")].append((ev["ts"],
                                                  ev["ts"] + ev["dur"]))
        for table in (self.ops, self.spans):
            for tid in table:
                table[tid].sort()
        self.graph_spans = {
            prefix: sorted((ev["ts"], ev["ts"] + ev.get("dur", 0),
                            int(ev["name"][len(prefix):]))
                           for ev in events
                           if ev.get("cat") == "user_annotation"
                           and ev.get("name", "").startswith(prefix))
            for prefix in (CAPTURE_SPAN, REPLAY_SPAN)}
        self.captured = set()
        inside = False
        for ev in self.runtime:
            if "BeginCapture" in ev["name"]:
                inside = True
            elif "EndCapture" in ev["name"]:
                inside = False
            elif inside:
                self.captured.add(id(ev))

    @staticmethod
    def _within(table, tid, a, b):
        s = table.get(tid)
        if not s:
            return False
        # the listed operators and spans do not nest in one another: the
        # last one that starts at or before the operator is the only one
        # that can hold it
        i = bisect.bisect_right(s, (a, float("inf"))) - 1
        return i >= 0 and s[i][1] >= b

    def inside(self, external_id):
        """Whether the operator of ``external_id`` lies inside one of the
        ``ops`` and inside one of the ``spans`` on its thread."""
        op = self.by_id.get(external_id)
        if op is None:
            return False
        a, b = op["ts"], op["ts"] + op.get("dur", 0)
        tid = op.get("tid")
        return (self._within(self.ops, tid, a, b)
                and self._within(self.spans, tid, a, b))

    def _span_of(self, prefix, ts):
        spans = self.graph_spans[prefix]
        i = bisect.bisect_right(spans, (ts, float("inf"), 0)) - 1
        return spans[i][2] if i >= 0 and ts <= spans[i][1] else None

    def captures(self):
        out = defaultdict(list)
        for ev in self.runtime:
            kind = launch_kind(ev["name"])
            if kind is None or id(ev) not in self.captured:
                continue
            number = self._span_of(CAPTURE_SPAN, ev["ts"])
            if number is not None:
                out[number].append((kind, self.inside(
                    ev.get("args", {}).get("External id"))))
        return dict(out)

    def replays(self):
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


def attribute(window_path, capture_path, ops, spans, window=None):
    """``[(device event, launched inside ops and spans)]`` for every device
    record of the window trace (within ``window = (start_us, end_us)``
    when given)."""
    main = Events(window_path, ops, spans)
    nodes = Events(capture_path, ops, spans).captures()
    nodes.update(main.captures())
    names = {}
    replays = main.replays()
    for number, recs in replays:
        want = nodes.get(number)
        if want is None:
            raise Unattributed(f"graph {number}: no capture in the traces")
        if len(recs) > len(want):
            raise Unattributed(f"a replay of graph {number} has {len(recs)} "
                               f"records, its capture {len(want)} launches")
        if len(recs) == len(want):
            kinds = [r["cat"] for r in recs]
            if kinds != [k for k, _ in want]:
                raise Unattributed(f"a replay of graph {number} ran {kinds}")
            names.setdefault(number, tuple(r["name"] for r in recs))
    out, replayed = [], set()
    for number, recs in replays:
        want = nodes[number]
        replayed.update(id(r) for r in recs)
        if len(recs) == len(want):
            out += [(r, inside) for r, (_, inside) in zip(recs, want)]
            continue
        seen = names.get(number)
        if seen is None:
            raise Unattributed(f"a replay of graph {number} lost records and "
                               f"no whole replay names its kernels")
        by_name = defaultdict(set)
        for name, (_, inside) in zip(seen, want):
            by_name[name].add(inside)
        for r in recs:
            answer = by_name.get(r["name"], ())
            if len(answer) != 1:
                raise Unattributed(f"kernel {r['name'][:60]!r} of graph "
                                   f"{number} ties to {sorted(answer)}")
            out.append((r, next(iter(answer))))
    out += [(ev, main.inside(ev.get("args", {}).get("External id")))
            for ev in main.device if id(ev) not in replayed]
    if window is not None:
        a, b = window
        out = [(ev, i) for ev, i in out
               if ev["ts"] >= a and ev["ts"] + ev.get("dur", 0) <= b]
    return out


def share(records):
    """``(seconds inside, share of all)`` of attributed records."""
    total = part = 0.0
    for ev, inside in records:
        dur = ev.get("dur", 0) * 1e-6
        total += dur
        if inside:
            part += dur
    return part, (part / total if total else None)
