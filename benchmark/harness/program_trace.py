"""What the port's own tracer recorded in the traced stretch, for the
per-layer metrics that read it (``slam_eslam_tpu_torch.utils.tracing``:
host spans of each runner call, the stage marks that its CUDA graphs
write on the card, the map pool's counters).

A runner call belongs to the stretch when its host start lies inside the
harness's window span: the trace's ``ts`` are microseconds after its
``baseTimeNanoseconds``, and the tracer's times are nanoseconds on the
same clock.  A port without the tracer, a stretch without a call, or a
call there that replayed a graph captured without marks (or lost marks to
the ring) gives nothing, with the reason logged."""

from __future__ import annotations

import json
import re

from benchmark.harness import common

BASE = re.compile(rb'"baseTimeNanoseconds"\s*:\s*(\d+)')
# the trace's header, where torch.profiler writes its base time
HEAD_BYTES = 1 << 20


def base_ns(path):
    """The trace's ``baseTimeNanoseconds`` (0 where it has none)."""
    with open(path, "rb") as fh:
        m = BASE.search(fh.read(HEAD_BYTES))
    if m is not None:
        return int(m.group(1))
    with open(path) as fh:
        return int(json.load(fh).get("baseTimeNanoseconds", 0))


def records(ctx):
    """The tracer's records, read once a run (kept in ``ctx``), or None
    (logged) where the port has no tracer or its devices wrote other marks
    than it accounted for."""
    if "program_records" not in ctx:
        ctx["program_records"] = None
        try:
            from slam_eslam_tpu_torch.utils import tracing
        except ImportError:
            common.log("the port has no tracer")
        else:
            try:
                ctx["program_records"] = tracing.records()
            except RuntimeError as err:
                common.log(f"the port's tracer: {err}")
    return ctx["program_records"]


def calls(ctx, metric):
    """``(calls, records)``: the runner calls whose host start lies in the
    traced stretch, each whole (no untraced replay, no lost mark); None,
    logged, where there is none or one is not whole."""
    recs = records(ctx)
    if recs is None:
        common.log(f"{metric}: no records of the port's tracer")
        return None
    tr = ctx["trace"]
    base = base_ns(tr.path)
    lo, hi = (base + t * 1e9 for t in tr.window)
    inside = [c for c in recs.calls
              if lo <= recs.spans[c.span].start <= hi]
    if not inside:
        common.log(f"{metric}: no runner call of the port in the stretch")
        return None
    untraced = sum(c.untraced for c in inside)
    lost = sum(c.lost for c in inside)
    if untraced or lost:
        common.log(f"{metric}: {untraced} replays of graphs captured without "
                   f"marks and {lost} marks lost in the stretch's "
                   f"{len(inside)} calls")
        return None
    return inside, recs


def mapping(inside):
    """The calls of SLAM frames that mapped: those with a ``merge``
    stage."""
    from slam_eslam_tpu_torch.utils import tracing

    return [c for c in inside if "merge" in tracing.stage_ns(c.marks)]
