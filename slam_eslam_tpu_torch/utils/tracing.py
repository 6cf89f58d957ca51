"""The port's tracer: host spans, stage marks that survive CUDA-graph
capture and the map pool's counters, kept in memory and read once.

**When it records.**  Tracing is on while ``enable()`` holds or while a
``torch.profiler`` session records.  A runner's call (``call``) records
while tracing is on, and also while the runner holds a graph captured with
tracing on: such a graph carries its marks for as long as it lives, so
every replay of it writes them, profiled or not.  A graph captured with
tracing off and met again while tracing is on is captured again, with its
marks (``utils.graphs.StepGraphs``).  With tracing off and no such graph,
``span``, ``stage`` and ``count`` cost a flag check each: nothing is
recorded, nothing is added to a graph, nothing is launched, and the stamp
kernel is neither built nor loaded.

**Spans** (``span``, ``call``) have a name, a host start and end, the
enclosing span and the runner call they belong to, on the profiler's
clock (``time.time_ns``: a Chrome trace's ``ts`` plus its
``baseTimeNanoseconds``).  Under a profiler each is also a
``record_function``, so a profiler's trace names host time by them.
``call`` opens a runner call (one call of a graphed runner or step) with
an id of its own; a call inside a call is a span of the outer one.

**Marks** (``stage``, ``count``) are records ``(code, value)`` that the
device writes into a fixed ring (``RING_RECORDS`` records a device), in
the order its stream runs them.  A stage's boundaries are stamps
(``csrc/trace_stamp.cu``: one thread writes the card's nanosecond clock;
on the CPU the record holds the host clock); a counter's record holds a
count the device computed (a tensor's sum) or one the host knows.  Inside
a CUDA graph's capture a mark records a stamp node and runs nothing; each
replay then writes exactly the records its capture recorded, and the host
credits them to the call from its own count of the ring's records
(``Ring.issued``), reading nothing back.  Under a profiler at capture
time a stage is also a ``record_function``, so the capture's trace ties
each launch to its stage.  Eager work outside a runner call takes marks
under ``enable()`` only: a profiler records eager kernels itself.  ``records()`` synchronises, reads each ring
once, checks that every device wrote what the host accounted for, and
puts the device's clock on the host's from calibration stamps between two
synchronises (one when the ring is made and one at every read, each good
to half its round trip, ~30 us on an H100), linear between the first and
the last: the card's clock drifts from the host's by a few parts in a
million.

The marks are taken where the work happens, in the shared step
functions: the localisation stages ``odometry``, ``project``,
``weights``, ``resample`` and ``centroid``; the SLAM frame's
``propagate``, ``measure``, ``reinject``, ``own heads``, ``camera cloud``,
``merge`` and ``centroid``; the map pool's counters
``pool.head_rows_moved``, ``pool.heads_copied``, ``pool.heads_started``
and ``pool.alloc_failed``; and the cloud merge's ``merge.points`` and
``merge.cells`` (``map_pool.merge_cloud_all`` beyond K3's points).
``write(path)`` exports the records as a Chrome trace, to open beside a
profiler's.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
import json
import threading
import time

import torch

# records (code, value), two int64 words each, that one device's ring holds
RING_RECORDS = 1 << 20
# calibration stamps a reading of the card's clock takes; the one with the
# shortest round trip is kept
CALIBRATION_TRIES = 10
KINDS = ("enter", "exit", "count")
_ENTER, _EXIT, _COUNT = range(len(KINDS))
_profiler_enabled = torch._C._autograd._profiler_enabled
# what a span, stage or replay is while nothing records (reusable)
_NOTHING = contextlib.nullcontext()

Span = collections.namedtuple("Span", "name start end parent call")
Span.__doc__ = """A host span: ``start`` and ``end`` in ns on the
profiler's clock (``end`` None while open), ``parent`` the index of the
enclosing span in ``Records.spans`` (None at the top), ``call`` the id of
the runner call it belongs to (None outside one)."""

Mark = collections.namedtuple("Mark", "name kind value")
Mark.__doc__ = """A record of the ring: ``kind`` ``"enter"`` or ``"exit"``
of the stage ``name`` (``value``: ns on the host's clock, read on the
device), or ``"count"`` (``value``: the count)."""


@dataclasses.dataclass
class Call:
    """One runner call: its ``id``, its span's index in ``Records.spans``,
    its marks in the order the device wrote them, the replays of graphs
    captured without marks (``untraced``) and the marks that the ring
    overwrote before they were read (``lost``)."""

    id: int
    name: str
    span: int
    untraced: int = 0
    lost: int = 0
    marks: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Records:
    """What the tracer recorded: ``spans`` (``Span``), ``calls``
    (``Call``) and ``loose``, the marks taken outside any call."""

    spans: list
    calls: list
    loose: list


def stage_ns(marks):
    """``{stage: ns}`` of a call's marks: the time between each stage's
    enter and exit, summed over its occurrences that no occurrence of the
    same stage encloses."""
    out, stack = collections.defaultdict(int), []
    for m in marks:
        if m.kind == "enter":
            stack.append(m)
        elif m.kind == "exit":
            e = stack.pop()
            if e.name != m.name:
                raise ValueError(f"stage {m.name!r} closed inside "
                                 f"{e.name!r}")
            if all(s.name != m.name for s in stack):
                out[m.name] += m.value - e.value
    return dict(out)


def counts(marks):
    """``{counter: total}`` of a call's marks."""
    out = collections.defaultdict(int)
    for m in marks:
        if m.kind == "count":
            out[m.name] += m.value
    return dict(out)


def extent_ns(marks):
    """ns from a call's first stamp to its last, or None without two."""
    t = [m.value for m in marks if m.kind != "count"]
    return t[-1] - t[0] if len(t) > 1 else None


@functools.cache
def _launcher():
    from slam_eslam_tpu_torch.ops import _build

    fn = _build.load("trace_stamp").trace_stamp_launch
    ptr, ll = ctypes.c_void_p, ctypes.c_longlong
    fn.argtypes = [ptr, ptr, ll, ll, ptr, ctypes.c_int, ll, ptr]
    fn.restype = ctypes.c_int
    return fn


def _stamp(buf, cursor, capacity, code, value, device):
    """Launch one stamp on ``device``'s current stream: the clock for
    ``value`` None, else an int, or a tensor whose sum the device counts."""
    ptr, mode, imm = None, 0, 0
    if torch.is_tensor(value):
        value = value.sum(dtype=torch.int64)
        ptr, mode = value.data_ptr(), 2
    elif value is not None:
        mode, imm = 1, int(value)
    with torch.cuda.device(device):
        err = _launcher()(buf.data_ptr(), cursor.data_ptr(), capacity, code,
                          ptr, mode, imm,
                          torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"trace stamp launch failed: CUDA error {err}")


class Ring:
    """One device's ring of marks, and the host's account of it:
    ``issued`` records so far, which the device's cursor reaches once the
    work launched so far has run."""

    def __init__(self, device, capacity):
        self.device, self.capacity = device, capacity
        self.issued = 0
        # calibration points: (host ns, device ns, the round trip in ns
        # that bounds the point's error)
        self.clock = []
        if device.type == "cuda":
            zeros = lambda *s: torch.zeros(s, dtype=torch.int64,
                                           device=device)
            self.buf, self.cursor = zeros(capacity, 2), zeros(1)
            self._probe, self._probe_cursor = zeros(1, 2), zeros(1)
            self.calibrate()
        else:
            self.buf, self.cursor = [None] * capacity, 0

    def write(self, code, value=None):
        """One record, written as the device writes it: on the card a
        stamp launched on the current stream (recorded into a graph under
        capture), on the CPU at once."""
        if self.device.type == "cuda":
            _stamp(self.buf, self.cursor, self.capacity, code, value,
                   self.device)
            return
        if value is None:
            value = time.time_ns()
        elif torch.is_tensor(value):
            value = int(value.sum())
        self.buf[self.cursor % self.capacity] = (code, int(value))
        self.cursor += 1

    def calibrate(self):
        """A calibration point: a stamp between two synchronises, the
        host's clock taken on each side."""
        best = None
        for _ in range(CALIBRATION_TRIES):
            torch.cuda.synchronize(self.device)
            h0 = time.time_ns()
            _stamp(self._probe, self._probe_cursor, 1, 0, None, self.device)
            torch.cuda.synchronize(self.device)
            h1 = time.time_ns()
            t = int(self._probe[0, 1])
            if best is None or h1 - h0 < best[0]:
                best = (h1 - h0, (h0 + h1) // 2, t)
        self.clock.append((best[1], best[2], best[0]))

    def to_host(self, t):
        """A time of this device in ns on the host's clock (linear between
        the first and the last calibration point)."""
        if not self.clock:
            return t
        (h0, d0, _), (h1, d1, _) = self.clock[0], self.clock[-1]
        if d1 == d0:
            return t + h0 - d0
        return h0 + round((t - d0) * (h1 - h0) / (d1 - d0))

    def read(self):
        """``(cursor, records)``: the device's count of records written and
        the ring's records (as ``[code, value]``, by slot), after a
        synchronise."""
        if self.device.type != "cuda":
            return self.cursor, self.buf
        torch.cuda.synchronize(self.device)
        self.calibrate()
        n = min(self.issued, self.capacity)
        return int(self.cursor), self.buf[:n].cpu().tolist()


class _Capturing:
    """A capture in progress: the codes of the marks it records."""

    def __init__(self, traced):
        self.traced, self.ring, self.codes = traced, None, []

    def marks(self):
        """What a graph of this capture writes at each replay: ``(ring,
        codes)``, or None when it was captured with tracing off."""
        return (self.ring, tuple(self.codes)) if self.traced else None


class _Replaying:
    """A replay in progress (a stand-in for the card runs the region's
    Python again: its marks are written, credited already)."""

    def __init__(self, traced):
        self.traced = traced


class _Mode:
    """``mode`` (a ``_Capturing`` or ``_Replaying``) set on the thread's
    state while this holds."""

    __slots__ = ("loc", "mode", "saved")

    def __init__(self, loc, mode):
        self.loc, self.mode = loc, mode

    def __enter__(self):
        self.saved, self.loc.mode = self.loc.mode, self.mode
        return self.mode

    def __exit__(self, *exc):
        self.loc.mode = self.saved
        return False


class _CallRecord:
    def __init__(self, id_, name, span):
        self.id, self.name, self.span = id_, name, span
        self.untraced = 0
        self.segments = []


class _Span:
    """A recorded host span (and a ``record_function`` under a
    profiler); opens a call too where ``call`` is given."""

    __slots__ = ("tracer", "name", "call", "index", "saved", "rf")

    def __init__(self, tracer, name, call=False):
        self.tracer, self.name, self.call = tracer, name, call
        self.rf = None

    def __enter__(self):
        if _profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        tr = self.tracer
        loc = tr._loc()
        self.index = len(tr.spans)
        self.saved = loc.call
        if self.call:
            loc.call = _CallRecord(len(tr.calls), self.name, self.index)
            tr.calls.append(loc.call)
        tr.spans.append([self.name, time.time_ns(), None,
                         loc.stack[-1] if loc.stack else None,
                         None if loc.call is None else loc.call.id])
        loc.stack.append(self.index)
        return self

    def __exit__(self, *exc):
        tr = self.tracer
        tr.spans[self.index][2] = time.time_ns()
        loc = tr._loc()
        loc.stack.pop()
        loc.call = self.saved
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class _Stage:
    __slots__ = ("tracer", "name", "device", "rf")

    def __init__(self, tracer, name, device):
        self.tracer, self.name, self.device = tracer, name, device
        self.rf = None

    def __enter__(self):
        if _profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.tracer.mark(self.name, _ENTER, self.device)
        return self

    def __exit__(self, *exc):
        self.tracer.mark(self.name, _EXIT, self.device)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class Tracer:
    """The tracer's state: spans, calls and rings.  The module's functions
    act on one of these, the process's (``TRACER``)."""

    def __init__(self, capacity=RING_RECORDS):
        self.capacity = capacity
        self.depth = 0            # enable() blocks open
        self.rings = {}           # device -> Ring
        self.spans = []           # [name, start, end, parent, call]
        self.calls = []           # _CallRecord
        self.loose = []           # segments of marks outside any call
        self.names, self.codes = [], {}
        self.local = threading.local()

    def _loc(self):
        loc = self.local
        if not hasattr(loc, "stack"):
            loc.stack, loc.call, loc.mode = [], None, None
        return loc

    def on(self):
        return self.depth > 0 or _profiler_enabled()

    def recording(self):
        """Whether spans and marks are recorded here: tracing on, or
        inside a call of a runner that holds a traced graph."""
        return (self.depth > 0 or _profiler_enabled()
                or getattr(self.local, "call", None) is not None)

    def _live(self):
        """Whether a mark is taken: inside a capture or a replay, whether
        its graph carries marks; in eager work, under ``enable()`` or in
        the call of a runner that records, but not under a profiler alone,
        which records eager kernels itself (a stamp there would be a
        launch of the measurement's own)."""
        loc = self._loc()
        if loc.mode is not None:
            return loc.mode.traced
        return self.depth > 0 or loc.call is not None

    def span(self, name):
        if not self.recording():
            return _NOTHING
        return _Span(self, name)

    def call(self, name, traced=False):
        if getattr(self.local, "call", None) is not None:
            return _Span(self, name)
        if not (traced or self.on()):
            return _NOTHING
        return _Span(self, name, call=True)

    def stage(self, name, device):
        if not self._live():
            return _NOTHING
        return _Stage(self, name, torch.device(device))

    def count(self, name, value, device=None):
        if self._live():
            self.mark(name, _COUNT,
                      torch.device(value.device if device is None
                                   else device), value)

    def _code(self, name, kind):
        code = self.codes.get((name, kind))
        if code is None:
            if name not in self.names:
                self.names.append(name)
            code = self.names.index(name) * len(KINDS) + kind
            self.codes[(name, kind)] = code
        return code

    def ring(self, device):
        """The ring of ``device``, made (and its clock calibrated) at the
        first need, outside any capture."""
        ring = self.rings.get(device)
        if ring is None:
            if device.type == "cuda" and \
                    torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"the trace ring of {device} is made outside a "
                    f"capture: call tracing.prepare({device}) before "
                    f"capturing with tracing on")
            ring = self.rings[device] = Ring(device, self.capacity)
        return ring

    def mark(self, name, kind, device, value=None):
        code = self._code(name, kind)
        mode = self._loc().mode
        if isinstance(mode, _Capturing):
            ring = self.ring(device)
            if mode.ring not in (None, ring):
                raise RuntimeError("a traced capture marks one device")
            mode.ring = ring
            if device.type == "cuda":
                ring.write(code, value)   # a node of the graph
            mode.codes.append(code)
        elif isinstance(mode, _Replaying):
            self.ring(device).write(code, value)
        else:
            ring = self.ring(device)
            ring.write(code, value)
            ring.issued += 1
            self._credit(ring, ring.issued - 1, (code,))

    def _credit(self, ring, slot, codes):
        call = self._loc().call
        segments = self.loose if call is None else call.segments
        last = segments[-1] if segments else None
        if last is not None and last[0] is ring and \
                last[1] + len(last[2]) == slot:
            last[2].extend(codes)
        else:
            segments.append([ring, slot, list(codes)])

    def capturing(self, traced):
        return _Mode(self._loc(), _Capturing(traced))

    def replaying(self, marks):
        if marks is None and not self.recording():
            return _NOTHING
        loc = self._loc()
        if marks is None:
            if loc.call is not None:
                loc.call.untraced += 1
        elif marks[1]:
            ring, codes = marks
            ring.issued += len(codes)
            self._credit(ring, ring.issued - len(codes), codes)
        return _Mode(loc, _Replaying(marks is not None))

    def _marks(self, segments, data):
        out, lost = [], 0
        for ring, slot0, codes in segments:
            recs = data[ring]
            for slot, code in enumerate(codes, slot0):
                if ring.issued - slot > ring.capacity:
                    lost += 1
                    continue
                rec = recs[slot % ring.capacity]
                if rec is None or rec[0] != code:
                    raise RuntimeError(
                        f"the trace ring of {ring.device} holds "
                        f"{None if rec is None else self._describe(rec[0])}"
                        f" at record {slot}, where the host expected "
                        f"{self._describe(code)}")
                name, kind = self._name(code)
                value = rec[1] if kind == _COUNT else ring.to_host(rec[1])
                out.append(Mark(name, KINDS[kind], value))
        return out, lost

    def _name(self, code):
        return self.names[code // len(KINDS)], code % len(KINDS)

    def _describe(self, code):
        name, kind = self._name(code)
        return f"{KINDS[kind]} {name!r}"

    def records(self):
        data = {}
        for ring in self.rings.values():
            cursor, recs = ring.read()
            if cursor != ring.issued:
                raise RuntimeError(
                    f"the trace ring of {ring.device} counts {cursor} "
                    f"records where the host accounted for {ring.issued}: "
                    f"a graph wrote other marks than its capture recorded")
            data[ring] = recs
        calls = []
        for c in self.calls:
            marks, lost = self._marks(c.segments, data)
            calls.append(Call(c.id, c.name, c.span, c.untraced, lost, marks))
        loose, _ = self._marks(self.loose, data)
        return Records([Span(*s) for s in self.spans], calls, loose)

    def reset(self):
        self.spans.clear()
        self.calls.clear()
        self.loose.clear()


TRACER = Tracer()


@contextlib.contextmanager
def enable():
    """Tracing on while this holds (nested blocks count)."""
    TRACER.depth += 1
    try:
        yield
    finally:
        TRACER.depth -= 1


def on():
    """Whether tracing is on: inside ``enable()`` or a profiler session."""
    return TRACER.on()


def recording():
    """Whether spans and marks are recorded here (tracing on, or inside a
    call of a runner that holds a traced graph)."""
    return TRACER.recording()


def marking():
    """Whether a mark taken here would be recorded (``count`` and
    ``stage`` do something): inside a traced capture or replay, under
    ``enable()``, or in the call of a runner that records.  Work that
    feeds a counter is made only then."""
    return TRACER._live()


def span(name):
    """A host span named ``name`` while recording (a ``record_function``
    too under a profiler), else nothing."""
    return TRACER.span(name)


def call(name, traced=False):
    """A runner call named ``name``: recorded while tracing is on or where
    the runner holds a traced graph (``traced``); a span of the enclosing
    call inside one."""
    return TRACER.call(name, traced)


def stage(name, device):
    """The stage ``name`` of the work on ``device``: its boundaries are
    stamps while marks are taken, else nothing."""
    return TRACER.stage(name, device)


def count(name, value, device=None):
    """Record the counter ``name``: ``value`` an int (``device`` given) or
    a tensor whose sum the device counts.  Nothing while no mark is
    taken."""
    TRACER.count(name, value, device)


def prepare(device):
    """Make ``device``'s ring (and calibrate its clock) before a traced
    capture: neither can happen under one."""
    TRACER.ring(torch.device(device))


def capturing(traced):
    """Around a graph's capture: its marks are recorded (``traced``) and
    not run; the object yielded gives them (``marks()``) afterwards."""
    return TRACER.capturing(traced)


def replaying(marks):
    """Around a graph's replay: credit to the current call the marks its
    capture recorded (``marks``, as ``_Capturing.marks`` gives them; None
    for a graph captured with tracing off, counted as ``untraced``)."""
    return TRACER.replaying(marks)


def records():
    """Everything recorded so far, read once from every ring
    (``Records``); raises where a device wrote other marks than the host
    accounted for."""
    return TRACER.records()


def reset():
    """Forget the spans, calls and marks recorded so far; the rings stay
    (graphs captured with marks go on writing into them)."""
    TRACER.reset()


def write(path, base_ns=None):
    """Write the records as a Chrome trace to ``path``: spans on the
    ``port host`` track, stages and counters on ``port device``, ``ts``
    in us after ``baseTimeNanoseconds`` (``base_ns``, a profiler trace's,
    to lay it beside that trace; else the first second recorded)."""
    recs = records()
    starts = [s.start for s in recs.spans]
    if base_ns is None:
        base_ns = min(starts) // 10 ** 9 * 10 ** 9 if starts else 0
    us = lambda ns: (ns - base_ns) / 1e3
    events = [{"ph": "X", "cat": "port_span", "name": s.name,
               "pid": "port host", "tid": 0, "ts": us(s.start),
               "dur": (s.end - s.start) / 1e3, "args": {"call": s.call}}
              for s in recs.spans if s.end is not None]
    groups = [(c.id, recs.spans[c.span].start, c.marks) for c in recs.calls]
    groups.append((None, base_ns, recs.loose))
    for cid, t, marks in groups:
        stack = []
        for m in marks:
            if m.kind == "enter":
                stack.append(m)
                t = m.value
            elif m.kind == "exit":
                e = stack.pop()
                t = m.value
                events.append({"ph": "X", "cat": "port_stage",
                               "name": m.name, "pid": "port device",
                               "tid": len(stack), "ts": us(e.value),
                               "dur": (m.value - e.value) / 1e3,
                               "args": {"call": cid}})
            else:
                events.append({"ph": "C", "name": m.name,
                               "pid": "port device", "ts": us(t),
                               "args": {m.name: m.value}})
    with open(path, "w") as fh:
        json.dump({"traceEvents": events, "baseTimeNanoseconds": base_ns,
                   "displayTimeUnit": "ms"}, fh)
