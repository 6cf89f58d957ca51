"""Kernel-level benchmarks of the lookup and the resample, with their
bounds.

Counterpart of ``tools/bench_kernels.py`` of the JAX package, at its
shapes: 2,000,000 queries on the 400x400 grid at 0.05 m (x and y uniform
in [-1.5, 1.5) m, z in [-0.5, 0.5); drawn from a seeded torch generator,
where the JAX script draws from JAX keys) and a resample of 100,000
particles.

* ``lookup/gather``: ``mapping.mls_grid.get_patch_packed``, the plain
  PyTorch lookup;
* ``select_cells (K5)``: the select kernel (``ops.select_cells``) on the
  same queries, its device time (``utils.profiling.device_time`` on its
  ``launch``) beside its byte bound (the queries read and the results
  written once, and each grid row a query touches once), its speed-up over
  the gather, and ``found``, ``mean`` and ``stdev`` equal to the plain
  version bit for bit;
* ``resample``: ``normalize_weights`` + ``resample_systematic`` + the
  ``[N, 12]`` row gather.

The JAX script sweeps windows, tiles, stages and layouts of its Pallas
kernels; on the card they are one select with no window (K5), so the
sweep has no counterpart.  Times on the card are device times (a CUDA
graph of calls, replayed); with ``--cpu`` they are the host clock and the
kernel row runs the plain version.

Usage: python -m slam_eslam_tpu_torch.tools.bench_kernels
           [--queries 2000000] [--particles 100000] [--cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from slam_eslam_tpu_torch.utils.profiling import (H100_FP32_TFLOPS,
                                                  H100_HBM_GBPS)

GRID = dict(nx=400, ny=400, resolution=0.05, origin=(-10.0, -10.0))
Z_WINDOW = 3.0


def terrain(x, y):
    return 0.25 * np.sin(1.3 * np.asarray(x))


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--queries", type=int, default=2_000_000)
    ap.add_argument("--particles", type=int, default=100_000)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (host clock; the kernel row runs "
                         "the plain version)")
    ap.add_argument("--hbm-gbps", type=float, default=H100_HBM_GBPS,
                    help="memory rate of the bounds (default: the H100's)")
    ap.add_argument("--tflops", type=float, default=H100_FP32_TFLOPS,
                    help="float32 rate (default: the H100's; no row here "
                         "is bound by it)")
    return ap


def queries(q, device, seed=0):
    """``[q, 3]`` points: x, y uniform in [-1.5, 1.5), z in [-0.5, 0.5)."""
    gen = torch.Generator(device).manual_seed(seed)
    xy = torch.rand((q, 2), generator=gen, device=device) * 3.0 - 1.5
    z = torch.rand((q, 1), generator=gen, device=device) - 0.5
    return torch.cat([xy, z], 1)


def select_bytes(packed, x, y):
    """Bytes K5 must move: x, y, z read and found, mean, stdev written per
    query (21 bytes), and one slot row per distinct grid cell touched."""
    from slam_eslam_tpu_torch.mapping import mls_grid

    nx, ny, k2 = packed.data.shape
    ix, iy = mls_grid.cells(packed, x, y)
    inside = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
    rows = torch.unique((ix.long() * ny + iy.long())[inside]).numel()
    return x.numel() * (12 + 9) + rows * k2 * 4


def main(argv=None):
    """Run the benchmarks; returns a dict of rows: ``gather``, ``select``
    and ``resample``, each with ``ms`` (and the select's ``bound_ms``,
    ``speedup`` and ``equal``)."""
    from slam_eslam_tpu_torch.core import filter as pf
    from slam_eslam_tpu_torch.mapping import mls_grid
    from slam_eslam_tpu_torch.models import sim as simlib
    from slam_eslam_tpu_torch.ops import select_cells as sc
    from slam_eslam_tpu_torch.utils import profiling
    from slam_eslam_tpu_torch.utils.device import card_line, entry_device

    args = parser().parse_args(argv)
    device = entry_device("cpu" if args.cpu else None)
    on_card = device.type == "cuda"
    rate = args.hbm_gbps * 1e9
    print(f"devices: {device}" + (f" ({card_line(device)})" if on_card
                                  else " (host clock)"))
    q = args.queries
    grid = simlib.terrain_grid(terrain, **GRID, device=device)
    packed = mls_grid.PackedLookup.from_grid(grid)
    pts = queries(q, device)
    soa = tuple(pts[:, j].contiguous() for j in range(3))

    def seconds(fn, reps=20):
        if on_card:
            return profiling.device_time(fn, reps=reps, replays=3)
        fn()
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    nbytes = select_bytes(packed, soa[0], soa[1])
    t_ideal = nbytes / rate
    t_gather = seconds(lambda: mls_grid.get_patch_packed(packed, pts,
                                                         Z_WINDOW))
    print(f"lookup/gather        : {t_gather * 1e3:8.3f} ms  "
          f"({q / t_gather / 1e6:7.1f} Mq/s)  "
          f"SoL(bw)={t_ideal / t_gather:.3f}")

    got = sc.select_cells(packed, soa, Z_WINDOW)
    ref = sc.select_cells_reference(packed, soa, Z_WINDOW)
    equal = all(torch.equal(a, b) for a, b in zip(got, ref))
    if on_card:
        outs = tuple(torch.empty_like(t) for t in got)
        t_sel = profiling.device_time(
            lambda: sc.launch(packed, soa, outs, Z_WINDOW))
    else:
        t_sel = seconds(lambda: sc.select_cells(packed, soa, Z_WINDOW))
    print(f"select_cells (K5)    : {t_sel * 1e3:8.4f} ms  "
          f"({q / t_sel / 1e6:7.1f} Mq/s)  bound {t_ideal * 1e3:.4f} ms "
          f"({nbytes / 1e6:.1f} MB at {args.hbm_gbps:.0f} GB/s), "
          f"SoL(bw)={t_ideal / t_sel:.3f}  speedup x{t_gather / t_sel:.2f}  "
          f"found/mean/stdev {'equal' if equal else 'DIFFER from'} the "
          f"plain version bit for bit"
          + ("" if on_card else " (the plain version itself on the CPU)"))
    if not equal:
        raise RuntimeError("select_cells differs from its plain version")
    print("# the JAX script's window / tile / stage / layout sweep "
          "(lookup/winNN, fused/*, q_lanes/*, q_flat/*) has no counterpart "
          "on this card: its Pallas variants are one select kernel, K5, "
          "with no window")

    n = args.particles
    gen = torch.Generator(device).manual_seed(2)
    wts = torch.rand((n,), generator=gen, device=device) + 0.01
    state = torch.randn((n, 12), generator=gen, device=device)
    u = torch.rand((), generator=gen, device=device)

    def resample():
        wn, _ = pf.normalize_weights(wts)
        return state.index_select(0, pf.resample_systematic(wn, u, n))

    t_rs = seconds(resample)
    rs_bytes = n * (12 + 1 + 1) * 4 * 2
    print(f"resample      : {t_rs * 1e3:8.3f} ms  "
          f"({n / t_rs / 1e6:7.1f} Mp/s)  "
          f"SoL(bw)={rs_bytes / rate / t_rs:.3f}")
    return dict(gather=dict(ms=t_gather * 1e3),
                select=dict(ms=t_sel * 1e3, bound_ms=t_ideal * 1e3,
                            bytes=nbytes, speedup=t_gather / t_sel,
                            equal=equal),
                resample=dict(ms=t_rs * 1e3, bound_ms=rs_bytes / rate * 1e3))


if __name__ == "__main__":
    main()
