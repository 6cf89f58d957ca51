"""Profiling and observability hooks.

Port of ``slam_eslam_tpu.utils.profiling``.  The reference has no tracing
at all (only stderr progress lines, ``PoseEstimator.cpp:350-351``).  Here:

* ``trace(path)``  -- context manager around ``torch.profiler`` (CPU and,
  where there is one, CUDA activity); writes a Chrome trace and a table
  of kernel times into ``path``,
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
