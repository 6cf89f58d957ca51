"""The traced stretch of a ``--trace 1`` run: a ``torch.profiler`` session
over part of the window, exported as a Chrome trace and reduced to what
the per-layer metrics read.

The harness marks the stretch and its own calls with spans
(``torch.profiler.record_function``): ``WINDOW_SPAN`` around the whole
stretch, and spans around each dispatch and each read of the poses.  The
port marks each CUDA graph capture and replay (``graph capture N`` /
``graph replay N``, ``slam_eslam_tpu_torch.utils.graphs``).  Device
records are the card's kernels, copies and memsets.
"""

from __future__ import annotations

import contextlib
import json
import re
import shutil
import tempfile
from collections import defaultdict
from pathlib import Path

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATEGORIES = ("cuda_runtime", "cuda_driver")
WINDOW_SPAN = "bench window"
REPLAY_SPAN = "graph replay "
CAPTURE_SPAN = "graph capture "


def re_kernel(name):
    """A pattern of the device records of kernel ``name``."""
    return rf"\b{name}\b"


def span(name):
    """A harness span (a no-op without a profiler running)."""
    import torch

    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


@contextlib.contextmanager
def profiled(path):
    """A ``torch.profiler`` session of the CPU and the card whose Chrome
    trace is written to ``path`` when it closes."""
    import torch

    card = torch.cuda.is_available()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU]
        + ([torch.profiler.ProfilerActivity.CUDA] if card else []))
    prof.start()
    try:
        yield prof
    finally:
        if card:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(str(path))


def trace_dir():
    """A directory for this run's traces under the temporary directory."""
    return Path(tempfile.mkdtemp(prefix="bench-trace-"))


def union(intervals):
    """Merged ``[(start, end)]`` of ``intervals``, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(v) for v in out]


class Trace:
    """The complete events of one Chrome trace, split for the readers;
    times in seconds.  ``window``: the ``(start, end)`` of the harness's
    window span (the whole trace without one)."""

    def __init__(self, path):
        with open(path) as fh:
            events = [ev for ev in json.load(fh)["traceEvents"]
                      if ev.get("ph") == "X"]
        self.path = path
        self.device = sorted(
            ((ev["ts"] * 1e-6, (ev["ts"] + ev.get("dur", 0)) * 1e-6,
              ev.get("name", "?"), ev.get("cat"))
             for ev in events if ev.get("cat") in DEVICE_CATEGORIES))
        self.spans = sorted(
            ((ev["ts"] * 1e-6, (ev["ts"] + ev.get("dur", 0)) * 1e-6,
              ev.get("name", "?"))
             for ev in events if ev.get("cat") == "user_annotation"))
        self.runtime = [ev for ev in events
                        if ev.get("cat") in RUNTIME_CATEGORIES]
        windows = [(a, b) for a, b, name in self.spans if name == WINDOW_SPAN]
        if windows:
            self.window = (windows[0][0], windows[-1][1])
        elif self.device:
            self.window = (self.device[0][0], max(e[1] for e in self.device))
        else:
            self.window = (0.0, 0.0)
        a, b = self.window
        self.in_window = [e for e in self.device if e[0] >= a and e[1] <= b]

    @property
    def window_s(self):
        return self.window[1] - self.window[0]

    def busy(self):
        """Seconds in which a device record ran, within the window."""
        return sum(b - a for a, b in union((e[0], e[1])
                                           for e in self.in_window))

    def kernel_seconds(self, pattern=None):
        """``(seconds, count)`` of the window's device records whose name
        matches ``pattern`` (a regular expression; every record for
        None)."""
        rx = None if pattern is None else re.compile(pattern)
        recs = [e for e in self.in_window if rx is None or rx.search(e[2])]
        return sum(e[1] - e[0] for e in recs), len(recs)

    def span_seconds(self, prefix):
        """Durations of the window's spans whose name starts with
        ``prefix``."""
        a, b = self.window
        return [e - s for s, e, name in self.spans
                if name.startswith(prefix) and s >= a and e <= b]

    def top_ops(self, k=10):
        """The ``k`` device operations that took the most time in the
        window: ``[[name, seconds]]``."""
        agg = defaultdict(float)
        for s, e, name, _ in self.in_window:
            agg[name] += e - s
        return [[n, v] for n, v in sorted(agg.items(), key=lambda kv: -kv[1])
                [:k]]

    def host_span_at(self, t):
        """The innermost harness or graph span open at host time ``t``
        (a graph's number dropped), or ``"no span"``."""
        best = None
        for s, e, name in self.spans:
            if s > t:
                break
            if e >= t and name != WINDOW_SPAN and (
                    best is None or s >= best[0]):
                best = (s, e, name)
        if best is None:
            return "no span"
        return re.sub(r" \d+$", "", best[2])

    def idle_gaps(self, k=10):
        """The ``k`` longest stretches of the window with nothing on the
        device, each named by the host span open across its middle:
        ``[[name, seconds]]``."""
        a, b = self.window
        busy = union((e[0], e[1]) for e in self.in_window)
        gaps, t = [], a
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if b > t:
            gaps.append((t, b))
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self.host_span_at(0.5 * (s + e)), e - s]
                for s, e in gaps[:k]]


def summary(tr):
    """``(device fields, breakdown)`` of a ``Trace`` for the result line."""
    return ({"busy_s": tr.busy(), "window_s": tr.window_s},
            {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()})


def remove(path):
    """Delete a trace file (they are large)."""
    with contextlib.suppress(OSError):
        Path(path).unlink()


def remove_dir(path):
    shutil.rmtree(path, ignore_errors=True)
