"""Reading helpers that several per-layer metric readers share."""

from __future__ import annotations

from benchmark.harness.trace import REPLAY_SPAN, re_kernel


def graph_launch_host_ms(ctx):
    """Mean host milliseconds of a ``graph replay N`` span."""
    spans = ctx["trace"].span_seconds(REPLAY_SPAN)
    return sum(spans) / len(spans) * 1e3 if spans else None


def idle_share(ctx):
    """Percent of the traced window with no device record running."""
    tr = ctx["trace"]
    if tr.window_s <= 0 or not tr.in_window:
        return None
    return (1.0 - tr.busy() / tr.window_s) * 100.0


def roofline_share(ctx, kernel, bound_key):
    """Percent: ``ctx[bound_key]`` (seconds a launch) times the launches
    of device records named ``kernel``, over their device time."""
    bound = ctx.get(bound_key)
    seconds, count = ctx["trace"].kernel_seconds(re_kernel(kernel))
    if bound is None or not count or seconds <= 0:
        return None
    return bound * count / seconds * 100.0
