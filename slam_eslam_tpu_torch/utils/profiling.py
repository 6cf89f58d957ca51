"""Profiling and observability hooks.

Port of ``slam_eslam_tpu.utils.profiling``.  The reference has no tracing
at all (only stderr progress lines, ``PoseEstimator.cpp:350-351``).  Here:

* ``trace(path)``  -- context manager around ``torch.profiler`` (CPU and,
  where there is one, CUDA activity); writes a Chrome trace and a table
  of kernel times into ``path``,
* ``device_time`` / ``device_time_cold`` / ``profiler_kernel_time`` -- a
  kernel's time on the card itself: a CUDA graph of many raw launches
  replayed between two events (back to back, or with the L2 cache flushed
  before every launch), and ``torch.profiler``'s time of the kernel by
  its name.  Events around a Python loop of wrapper calls read the host
  wherever a call costs the host more than the kernel costs the card,
* ``launch_calls`` -- the host's kernel-launch calls of one call of a
  function,
* ``timed``        -- wall-clock timing that ends in a device sync,
* ``sync``         -- ``torch.cuda.synchronize`` where there is a GPU,
* ``StepLogger``   -- the stderr progress line, rate-limited (the
  ``iteration: N found: M`` analogue),
* ``weighting_step_stats`` / ``speed_of_light_fraction`` -- bytes/flops
  accounting of the contact-weighting step, so that a measured step time
  converts to a fraction of the card's roofline.
"""

from __future__ import annotations

import contextlib
import sys
import time
from pathlib import Path

import torch

# Published peaks of one NVIDIA H100 SXM at its full 700 W power limit
# (NVIDIA's data sheet): HBM3 bandwidth and the float32 rate outside the
# tensor cores, which is what the weighting step's arithmetic uses.
H100_HBM_GBPS = 3350.0
H100_FP32_TFLOPS = 67.0


@contextlib.contextmanager
def trace(path="slam_eslam_trace"):
    """Profile the body with ``torch.profiler``; on exit write
    ``path/trace.json`` (Chrome trace) and ``path/key_averages.txt``.
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        sync()
    out = Path(path)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))
    sort_by = ("cuda_time_total" if torch.cuda.is_available()
               else "cpu_time_total")
    (out / "key_averages.txt").write_text(
        prof.key_averages().table(sort_by=sort_by, row_limit=50))


# idle seconds between a profiler session's start and its launches (see
# ``profiler_kernel_time``)
PROFILER_PAD_S = 0.05
# profiler sessions ``profiler_kernel_time`` takes before it gives up
PROFILER_SESSIONS = 3


class ProfilerLostRecords(RuntimeError):
    """``torch.profiler`` kept no device record in any session while the
    host traced the launches: the tracer lost them, the kernel ran."""
# launches before a capture: the build, the library load and the first
# launch cannot be captured
DEVICE_TIME_WARMUP = 3
DEVICE_TIME_REPS = 200
# the fill node of ``device_time_cold`` copies this many bytes (read and
# written once each): more than twice the H100's 50 MB L2
L2_FILL_BYTES = 64 * 2 ** 20


def _replay_seconds(body, reps, replays, generator=None):
    """Seconds per repetition of ``body()`` on the card: ``reps``
    repetitions captured into one CUDA graph, the graph replayed once to
    warm up and then ``replays`` times between two events.  ``generator``
    (a ``torch.Generator`` that ``body`` draws from) is registered with
    the graph."""
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    with torch.cuda.graph(graph):
        for _ in range(reps):
            body()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e-3 / (reps * replays)


def device_time(launch, reps=DEVICE_TIME_REPS, replays=5, generator=None):
    """Seconds one launch of a kernel takes on the card, back to back
    (what it last touched may still lie in L2).  ``launch()`` must put
    the kernel on PyTorch's current stream and nothing else: no
    read-back, no synchronise (a kernel module's ``launch``, or a
    function of PyTorch operations, whose tensors come from the graph's
    own pool).  It is called ``DEVICE_TIME_WARMUP`` times eagerly and
    ``reps`` times under capture; the time between graph nodes (about a
    microsecond) is part of the reading, the graph's own launch is spread
    over ``reps``.  ``generator``: the ``torch.Generator`` that
    ``launch`` draws from, registered with the graph.  Needs a CUDA
    device."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_time needs a CUDA device: a kernel's "
                           "device time cannot be read on the CPU")
    for _ in range(DEVICE_TIME_WARMUP):
        launch()
    torch.cuda.synchronize()
    return _replay_seconds(launch, reps, replays, generator)


def device_time_cold(launch, reps=DEVICE_TIME_REPS, replays=3,
                     fill_bytes=L2_FILL_BYTES):
    """Seconds one launch takes on the card when nothing it reads lies in
    L2: as ``device_time``, with a copy of ``fill_bytes`` (at least 64 MB)
    before every launch and the copy's own time, from a graph of copies
    alone, taken off.  Returns ``(seconds, seconds of one fill)``."""
    if fill_bytes < L2_FILL_BYTES:
        raise ValueError(f"a fill of {fill_bytes} bytes leaves part of the "
                         f"L2 cache as it was; use {L2_FILL_BYTES} or more")
    if not torch.cuda.is_available():
        raise RuntimeError("device_time_cold needs a CUDA device")
    src = torch.empty(fill_bytes, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    fill = lambda: dst.copy_(src)

    def both():
        fill()
        launch()

    for _ in range(DEVICE_TIME_WARMUP):
        both()
    torch.cuda.synchronize()
    t_fill = _replay_seconds(fill, reps, replays)
    t_both = _replay_seconds(both, reps, replays)
    return t_both - t_fill, t_fill


def profiler_kernel_time(launch, kernel_name=None, calls=20):
    """Seconds of device time per call of ``launch()``, as
    ``torch.profiler`` reports it over ``calls`` eager calls: the time of
    the kernel whose name contains ``kernel_name`` per launch of it (the
    kernel's own time, without the gap between launches), or, with no
    name, of every kernel the call puts on the card (the device time of a
    function made of many PyTorch operations, whatever its host time).

    On an H100 host the tracer loses device records: most often those of
    launches made just after a session starts, so the launches wait
    ``PROFILER_PAD_S`` after the start, and now and then every record of
    a session while the host traced its launches.  Such an empty session
    is said on stderr and traced again, at most ``PROFILER_SESSIONS`` in
    all; raises ``ProfilerLostRecords`` if every one was empty.  Raises
    ``RuntimeError`` if the trace holds no kernel of the name, naming what
    it did hold; says so on stderr if it holds fewer device records than
    the host traced launches (then a reading with no name is of the kept
    records alone)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("profiler_kernel_time needs a CUDA device")
    launch()
    torch.cuda.synchronize()
    for session in range(PROFILER_SESSIONS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILER_PAD_S)
            for _ in range(calls):
                launch()
            torch.cuda.synchronize()
        events = prof.key_averages()
        seen = {e.key: e.count for e in events
                if e.device_type == DeviceType.CUDA}
        launched = _launch_counts(events)
        said = (f"{sum(seen.values())} device records for "
                f"{sum(launched.values())} kernel launches in {calls} calls "
                f"(kernel *{kernel_name or ''}*)")
        if seen or not launched:
            break
        print(f"profiler_kernel_time: torch.profiler kept {said} in session "
              f"{session + 1}", file=sys.stderr)
    total_us, count = 0.0, 0
    for e in events:
        if e.device_type == DeviceType.CUDA and (kernel_name is None
                                                 or kernel_name in e.key):
            total_us += getattr(e, "self_device_time_total",
                                getattr(e, "self_cuda_time_total", 0))
            count += e.count
    if not seen and launched:
        raise ProfilerLostRecords(f"torch.profiler kept {said} in "
                                  f"{PROFILER_SESSIONS} sessions")
    if not count:
        raise RuntimeError(f"torch.profiler kept {said}: device events "
                           f"{seen}, host launch calls {launched}")
    if sum(seen.values()) < sum(launched.values()):
        print(f"profiler_kernel_time: torch.profiler kept {said}",
              file=sys.stderr)
    return total_us * 1e-6 / (calls if kernel_name is None else count)


def _launch_counts(events):
    """``{name: calls}`` of the host's kernel-launch records among
    ``torch.profiler``'s ``key_averages()``."""
    from torch.autograd import DeviceType

    return {e.key: e.count for e in events
            if e.device_type != DeviceType.CUDA and "LaunchKernel" in e.key}


def launch_calls(fn):
    """The host's kernel-launch calls in one call of ``fn()`` ending in a
    device sync: ``torch.profiler``'s host records of the CUDA runtime
    (the tracer keeps them where it may lose device records).  None
    without a CUDA device."""
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        return None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(_launch_counts(prof.key_averages()).values())


@contextlib.contextmanager
def timed(label, out=None):
    t0 = time.perf_counter()
    yield
    sync()
    dt = time.perf_counter() - t0
    msg = f"[timing] {label}: {dt * 1e3:.2f} ms"
    if out is not None:
        out[label] = dt
    print(msg, file=sys.stderr)


def sync():
    """Block until all device work is done (accurate timing boundaries);
    nothing to wait for without a GPU."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class StepLogger:
    """Rate-limited progress line: ``iteration: i  ess: .. found: ..``."""

    def __init__(self, every=10, stream=sys.stderr):
        self.every = every
        self.stream = stream
        self.i = 0

    def log(self, **kv):
        if self.every and self.i % self.every == 0:
            parts = "\t".join(f"{k}: {v}" for k, v in kv.items())
            print(f"iteration: {self.i}\t{parts}", file=self.stream)
        self.i += 1


def instruction_bound_seconds(thread_instructions):
    """The least time the card needs for ``thread_instructions`` float32
    instructions (a per-thread count: queries times instructions per
    query).  The published 67 TFLOP/s counts a fused multiply-add as two
    operations, so the card starts 33.5e12 instructions a second: a full
    warp on each of the 4 schedulers of its 132 SMs at every clock of
    1.98 GHz."""
    return thread_instructions / (H100_FP32_TFLOPS * 1e12 / 2)


def weighting_step_stats(n_particles, n_contacts, k_patches, bytes_per=4):
    """Memory/compute accounting for the contact-weighting step.

    Per particle x contact point: one cell gather (K patch slots x
    mean/stdev/valid) + ~60 flops of likelihood math.  Returns a dict
    with ``queries``, ``bytes_accessed`` and ``flops`` for a roofline
    comparison (``speed_of_light_fraction``).
    """
    q = n_particles * n_contacts
    gather_bytes = q * k_patches * 3 * bytes_per
    state_bytes = n_particles * 10 * bytes_per * 2
    flops = q * 60 + n_particles * 40
    return {
        "queries": q,
        "bytes_accessed": gather_bytes + state_bytes,
        "flops": flops,
    }


def speed_of_light_fraction(measured_seconds, stats,
                            hbm_gbps=H100_HBM_GBPS,
                            tflops=H100_FP32_TFLOPS):
    """Fraction of the bandwidth/compute roofline a measured step
    achieves (min-time model: t_ideal = max(bytes/BW, flops/FLOPS)); the
    default peaks are the H100's."""
    t_bw = stats["bytes_accessed"] / (hbm_gbps * 1e9)
    t_fl = stats["flops"] / (tflops * 1e12)
    t_ideal = max(t_bw, t_fl)
    return t_ideal / max(measured_seconds, 1e-12)
