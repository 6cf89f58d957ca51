"""What every run of every cell shares: the set-up clock, the device
checks, the check that nothing of JAX was loaded, and the result line."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# top-level module names the port's process may never hold
FORBIDDEN = ("jax", "jaxlib", "flax", "slam_eslam_tpu")


def process_start():
    """``time.time()`` at this process's start, read from ``/proc`` (the
    clock ticks since boot at which it started), or None."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
    except (OSError, IndexError, ValueError):
        return None
    return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")


class SetupClock:
    """Seconds since the process started, by part: each ``part(name)``
    closes the part that ran since the last one and prints it on stderr."""

    def __init__(self):
        start = process_start()
        self.t0_wall = start if start is not None else time.time()
        self.last = time.time()
        self.parts = {"interpreter": self.last - self.t0_wall}

    def part(self, name):
        now = time.time()
        took = now - self.last
        self.parts[name] = self.parts.get(name, 0.0) + took
        self.last = now
        print(f"setup: {name} {took:.3f} s", file=sys.stderr, flush=True)

    def total(self):
        return time.time() - self.t0_wall


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def require_cards(chips):
    """Exit with code 2, printing no result, unless the CUDA device count
    reaches ``chips``: the benchmark measures the card and has no CPU
    fallback."""
    import torch

    if not torch.cuda.is_available():
        log("benchmark: torch.cuda.is_available() is False: no CUDA device, "
            "no result")
        sys.exit(2)
    if torch.cuda.device_count() < chips:
        log(f"benchmark: {torch.cuda.device_count()} CUDA device(s), the cell "
            f"needs {chips}: no result")
        sys.exit(2)


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name (before the first dot) is
    one of ``FORBIDDEN``, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted(name for name in modules
                  if name.split(".", 1)[0] in FORBIDDEN)


def power_limit():
    """``nvidia-smi``'s name and power limit of the first card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def device_info(chips, peak_bytes, trace=None):
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak_bytes)}
    if trace is not None:
        info["busy_s"] = trace["busy_s"]
        info["window_s"] = trace["window_s"]
    return info


def emit(result, checks):
    """Print the numbers compared beside their limits as the last lines on
    stderr, then the result line, ``checks`` its last key, as the last
    line on stdout.  Exits with code 3, printing no result, when a
    forbidden module was loaded."""
    found = forbidden_modules()
    if found:
        log(f"benchmark: the process loaded {', '.join(found)}: no result")
        sys.exit(3)
    result = dict(result)
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
