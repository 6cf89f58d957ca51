#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py [--profile DIR]

Phases (any failure raises and exits non-zero):

1. report the card (torch and ``nvidia-smi`` name and power limit);
2. build every kernel from ``slam_eslam_tpu_torch/csrc``, one ``nvcc``
   per source, all started together;
3. check the contact fold (K1) against its plain PyTorch version on the
   card, at the localisation benchmark shape (N = 100,000 particles,
   C = 8 contacts, a 400x400x4 grid), at a ragged N, on a spread cloud
   with out-of-grid queries and at C = 1, 5, 20 x N = 1, 127, 129 (around
   a warp and a block's edge), with the groups given as one-hot and as
   int32 ids; count the instructions its inputs need for its bound, and
   those of the built kernel from ``cuobjdump -sass`` beside them; time it
   on the card (see below), back to back and with a cold L2;
4. drive the localisation path: the benchmark trajectory (100k
   particles, 20 m x 20 m map at 0.05 m, contacts compacted to 8, 150
   steps) through ``filter.step.make_scan_runner`` on the card; count K1
   launches, check the centroids, and hold the first 20 steps against
   the CPU port fed the same random draws;
5. check the chain lookup (K2) and the block merge (K3) against their
   plain versions at the SLAM benchmark shapes (N = 4,096 particles,
   C = 8 contacts, chains of 3, P = 64 scan points, a 16,384-block pool
   of 40x40x4 cells half full of patches, with empty chain entries) and
   at a ragged N, and time both;
6. drive the SLAM path: 4,096 particles with per-particle maps over 200
   frames (20 laser scans) through ``filter.streaming.
   make_slam_scan_runner`` on the card with host syncs forbidden; count
   K2 and K3 launches against the measurement and mapping gates, check
   that centroids, weights and the pool are finite, and hold the first
   60 frames against the CPU port fed the same random draws;
7. check the unfolded lookup's select (K5) against its plain version,
   bit for bit, at 800,000 queries (100k particles x 8 contacts) on the
   400x400x4 grid, at a ragged count, on a spread cloud with out-of-grid
   queries, at Q = 1, 3, 5 and 800,001 and on views that start 4 bytes
   into a tensor, and time it on the card, back to back and with a cold
   L2; then drive the application API,
   ``EmbodiedSlamFilter.update_contact`` in shared-map mode with
   ``log_debug`` and the surface hash (global init, reinjection), at
   100k particles over the 150 frames of the localisation trajectory
   with host syncs forbidden in every measurement update and the
   distribution exported every 50 frames; count K5 launches (one per
   measurement update, K1 none), run 20 frames with Chitta weighting
   and 20 with the slip update on terrain labels, and hold the first 20
   frames against the CPU port fed the same random draws;
8. check the block copy (K7) against its plain version, bit for bit, at
   the merge benchmark's shape (N = 4,096 particles, P = 64 points,
   blocks of 40x128 slots, a pool of N + 64 blocks) and at a ragged N,
   on float32 and bfloat16 fields, whole blocks and hit cells (sorted
   as the merge visits them, and unsorted), in place and into a second
   pool, and time it beside its plain version, the library call and the
   block merge; check K2 and K3 on a pool stored in bfloat16 at phase
   5's shapes, and at the 100,000-particle run's shape (a bfloat16 pool
   of 400,000 blocks, element offsets past 2^31); then run the benchmark
   ``slam_eslam_tpu_torch.bench`` in process: filter mode at its defaults
   (100k particles, 150 steps; K1 launches, the fold and merge rooflines
   with K7), filter mode with ``--fold off`` (K5, no K1), SLAM mode at
   4,096 particles on a bfloat16 pool (200 frames) and SLAM mode at
   100,000 particles on a bfloat16 pool of 400,000 blocks (50 frames);
   and hold the first 60 SLAM frames on a bfloat16 pool against the CPU
   port and against the float32 pool, fed the same random draws;
9. check the merge on a packed block image (P4, the second entry point of
   K3's source) at the merge probe's shape (N = 4,096 particles, P = 64
   points, N + 64 blocks of 40x40x4 slots in one float32 image of 160 rows
   per block) against its plain version (meta rows equal as int32, fields
   bitwise on one-point cells, K3's tolerance elsewhere) and against K3 on
   the unpacked fields (bit for bit), and time the three in turns; run the
   merge probe ``slam_eslam_tpu_torch.tools.probe_merge_overhead`` in
   process at its defaults (every variant prints, ``copy_packed`` not
   below its byte bound, the grouped rows are K3's); then drive the
   application's mapping API, ``EmbodiedSlamFilter`` with per-particle
   maps at 4,096 particles on a colour-carrying float32 pool with the
   scan match, negative information, the slip update on terrain labels
   and the surface hash, the way ``examples.slam_demo`` drives it (three
   timed passes): ``update_contact`` on each of 200 frames,
   ``update_scan`` and ``update_distance_image`` (a
   textured 12x16 distance image) on every tenth; count K2 and K3 launches
   against the gates and the host syncs of every mapping update (one, the
   read of the pool's failure count); hold ``run_stream`` against the same
   60 frames driven call by call, and the card against the CPU port over
   60 frames on identical draws; and merge a distance image into a hole
   of the shared 400x400 map at 100,000 particles
   (``update_distance_image`` in shared-map mode) and check that the
   contacts of the next ``update_contact`` find the new patches, against
   a twin filter that merged the same image 4 m to the side.

Every kernel's time is the card's own (``ms`` = ``device_ms``): 200 raw
launches (a kernel module's ``launch``: no check, no allocation) captured
into a CUDA graph and replayed between two CUDA events, so that no Python
runs between two launches.  ``device_ms_profiler`` is the cross-check:
``torch.profiler``'s time of the kernel by its name over 20 eager
launches, which leaves out the gap between two graph nodes.  ``call_ms``
is CUDA events around a Python loop of calls of the public wrapper, which
is the wrapper's host time wherever that exceeds the kernel's (what an
eager loop pays per call).  ``plain_ms`` and ``library_ms`` are device times too: every
kernel the plain version, or the one PyTorch call, puts on the card, as
``torch.profiler`` sums them (``plain_call_ms``, ``library_call_ms``: the
events around the calls).  Each time stands beside its bound: the bytes
the call must move (each input read once, each output written once,
counted from this run's inputs) over the card's published memory rate,
or its operations over the published float32 rate (for K1: the
instructions this run's queries need, ``utils.kernel_eff.fold_work``),
whichever takes longer.

The third line from the end is ``{"kernels": [...]}``, then the card's
name and power limit; the last line is
``{"ok": true, "device": {...}}``.  ``--profile DIR`` also writes
``torch.profiler`` tables and traces of 10 localisation steps, of 50
SLAM frames, of 20 application frames and of 50 frames of the mapping path
to DIR.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

N_BENCH = 100_000
N_RAGGED = 100_003
STEPS = 150
CHECK_STEPS = 20
CONTACT_CAP = 8
GRID = dict(nx=400, ny=400, resolution=0.05, origin=(-10.0, -10.0))
KERNEL_RTOL = 1e-4
KERNEL_ATOL_REL = 1e-5   # times max |row| of the plain version
CENTROID_ATOL = 1e-3     # m, GPU vs CPU port on identical draws

# the SLAM benchmark (bench.py --mode slam): 4,096 particles, 10 m grids
# at 0.25 m, chains of 3, a pool of 4N blocks, 20 scans x 10 substeps
SLAM_N = 4096
SLAM_N_RAGGED = 4093
SLAM_POOL = dict(nx=40, ny=40, k=4, resolution=0.25, chain_len=3)
SLAM_C = 8
SLAM_RAYS = 64
SLAM_STEPS = 20            # scans, 10 contact frames each
SLAM_CHECK_FRAMES = 60
SLAM_PROFILE_FRAMES = 50
# K3 against its plain version: bitwise on cells one point hits; the
# plain version sums multi-point cells with atomics on the card, so
# those agree to float32 rounding: rtol 1e-6 (mean, stdev), atol 1e-6 m
# (height, a difference of two heights)
MERGE_RTOL = 1e-6
MERGE_HEIGHT_ATOL = 1e-6
# GPU vs CPU port: patch counts after 60 frames.  Float32 rounding of
# transcendental functions differs between the two devices, which can
# move a point across a cell edge or a resampling ancestor by one; each
# changes a count by a few patches
PATCH_COUNT_RTOL = 1e-3
# the application path (phase 7): EmbodiedSlamFilter.update_contact on
# the localisation bench's grid, the distribution exported every 50
# frames, 20-frame runs of the Chitta weighting and the slip update
APP_FRAMES = 150
APP_SHORT_FRAMES = 20
APP_LOG_PERIOD = 50
APP_PROFILE_FRAMES = 20
APP_HASH_PERIOD = 5      # steps between hash reinjections
CP_OK_RTOL = 1e-3        # cp_ok counts per update, GPU vs CPU port
KERNELS = ("contact_fold", "chain_lookup", "block_merge", "select_cells",
           "block_copy")
# every wrapper that counts launches: block_merge's source has two
WRAPPERS = KERNELS + ("block_merge_packed",)
# published peaks of one H100 SXM at its 700 W limit (NVIDIA's data
# sheet): memory rate, and float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS_F32 = 67e12
# a kernel's device time: raw launches per CUDA graph; the graph's and the
# profiler's readings are said to differ beyond this
GRAPH_REPS = 200
BIG_GRAPH_REPS = 50      # at the 100,000-particle shapes
COPY_GRAPH_REPS = 100    # the whole-block copy moves 671 MB a launch
CROSS_CHECK_RTOL = 0.25
# the small shapes of the K1 check (C contact rows x N particles, around
# a warp and a block's edge) and of the K5 check (Q queries)
FOLD_SMALL_C = (1, 5, 20)
FOLD_SMALL_N = (1, 127, 129)
SELECT_SMALL_Q = (1, 3, 5, 800_001)
# the merge benchmark's shape (utils.kernel_eff.merge_floor_fraction)
COPY_N, COPY_N_RAGGED, COPY_P = 4096, 4093, 64
COPY_BLOCK = dict(nx=40, ny=32, k=4)
# the merge's twin does a subset of the merge's work: a floor fraction
# above this means the twin is at fault
FLOOR_FRACTION_MAX = 1.05
BIG_N, BIG_STEPS = 100_000, 5     # 100k-particle SLAM: 50 frames
BIG_PARTS = 16    # the 400,000-block check pool is drawn 25,000 at a time
INT32_ELEMENTS = 2 ** 31  # element offsets from here on need 64 bits
# phase 9: the merge probe's default shape; the application mapping path
PROBE = dict(n=4096, p=64, nx=40, ny=40, k=4)
MAP_CHECK_FRAMES = 60
MAP_WARM_FRAMES = 30
MAP_PASSES = 3               # timed passes of the 200 frames, rates as a range
MAP_IMAGE = (12, 16)         # the distance image of examples/full_demo.py
MAP_HASH_PERIOD = 5
MAP_LABEL_PERIOD = 4         # terrain labels on every fourth frame
MAP_CAMERA_DISTANCE = 0.08   # m between camera merges: every second scan
STREAM_ATOL = 1e-5           # m, run_stream vs the same frames call by call
# the shared-map camera merge: half side of the hole in the start map, the
# twin's sideways mount, and the least weight difference (in mean weights)
# that counts as the new patches seen; float32 rounding is 1e-7 of a weight
SHARED_HOLE = 1.5
SHARED_FAR = 4.0
SHARED_WEIGHT_FLOOR = 1e-2


def bench_terrain(x, y):
    return 0.25 * np.sin(1.3 * np.asarray(x)) + 0.2 * np.cos(
        0.9 * np.asarray(y))


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters):
    """Mean milliseconds per call of ``fn`` over ``iters`` calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, flops=0.0):
    """``(bound_ms, bound_by)``: the least time the card could take for
    ``nbytes`` of traffic and ``flops`` float32 operations."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms_of(fn, calls=5):
    """Device milliseconds per call of ``fn``, a function of many PyTorch
    operations: every kernel it puts on the card, summed by
    ``torch.profiler``."""
    from slam_eslam_tpu_torch.utils import profiling

    return profiling.profiler_kernel_time(fn, None, calls) * 1e3


def kernel_times(label, call, launch, kernel_name, plain, bnd, n_call=50,
                 n_plain=5, reps=GRAPH_REPS):
    """Every time of one kernel row.  ``ms`` = ``device_ms``: ``reps`` raw
    launches (``launch()``: a kernel module's ``launch`` on fixed operands
    and outputs) captured into a CUDA graph and replayed, so no Python
    runs between the launches; ``device_ms_profiler``: the kernel's own
    time by its name (``kernel_name``) from ``torch.profiler`` over 20
    eager launches, without the gap between graph nodes; ``call_ms``: CUDA
    events around a Python loop of ``call()``, the public wrapper (what an
    eager loop pays per call: the wrapper's host time where that exceeds
    the kernel's), in turns with ``plain()``, the plain version
    (``plain_call_ms``); ``plain_ms``: the plain version's kernels on the
    card, summed by the profiler; ``bound_ms``, ``bound_by`` from
    ``bnd``."""
    from slam_eslam_tpu_torch.utils import profiling

    call_ms, plain_call, runs = alternate(call, plain, n_call, n_plain)
    plain_ms = device_ms_of(plain)
    dev = profiling.device_time(launch, reps) * 1e3
    prof = profiling.profiler_kernel_time(launch, kernel_name) * 1e3
    print(f"{label} device {dev:.5f} ms (graph of {reps} launches), "
          f"{prof:.5f} ms (profiler, {kernel_name}); call {call_ms:.4f} ms "
          f"({runs[1]:.4f}, {runs[2]:.4f}: events around the wrapper), plain "
          f"{plain_ms:.4f} ms on the card (profiler, all its kernels), "
          f"{plain_call:.4f} ms a call ({runs[0]:.4f}, {runs[3]:.4f}), bound "
          f"{bnd[0]:.5f} ms ({bnd[1]}): {bnd[0] / dev:.3f} of the bound")
    if abs(dev - prof) > CROSS_CHECK_RTOL * prof:
        print(f"{label}: graph and profiler readings differ by "
              f"{abs(dev - prof) / prof:.0%}; ms takes the graph's, which "
              f"holds the gap between two graph nodes that a captured step "
              f"pays too; the profiler's is the kernel alone")
    return dict(ms=dev, device_ms=dev, device_ms_profiler=prof,
                call_ms=call_ms, plain_ms=plain_ms, plain_call_ms=plain_call,
                bound_ms=bnd[0], bound_by=bnd[1])


def cold_times(label, launch, times):
    """Add ``device_ms_cold_l2`` to ``times``: ``launch()`` with the L2
    cache flushed before every launch (``profiling.device_time_cold``)."""
    from slam_eslam_tpu_torch.utils import profiling

    cold, fill = profiling.device_time_cold(launch)
    times.update(device_ms_cold_l2=cold * 1e3, l2_fill_ms=fill * 1e3)
    print(f"{label} device {cold * 1e3:.5f} ms with a cold L2 (a "
          f"{profiling.L2_FILL_BYTES >> 20} MB copy before every launch, its "
          f"own {fill * 1e3:.5f} ms taken off), {times['device_ms']:.5f} ms "
          f"back to back")


def in_turns_device(old, new, reps=GRAPH_REPS):
    """Device ms of two launchers, old, new, new, old: ``((old mean, new
    mean), the four readings)``."""
    from slam_eslam_tpu_torch.utils import profiling

    runs = [profiling.device_time(f, reps) * 1e3
            for f in (old, new, new, old)]
    return ((runs[0] + runs[3]) / 2, (runs[1] + runs[2]) / 2), runs


def distinct(cells):
    """Number of distinct values in an integer tensor."""
    return int(torch.unique(cells).numel())


def grid_query_bytes(packed, xq, yq, per_query):
    """Bytes a lookup of world queries into a packed grid must move:
    ``per_query`` bytes of queries and results each, plus one slot row
    (2K float32) per distinct cell the queries touch."""
    from slam_eslam_tpu_torch.mapping import mls_grid

    nx, ny, c2 = packed.data.shape
    ix, iy = mls_grid.cells(packed, xq, yq)
    inside = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
    touched = distinct((ix.long() * ny + iy.long())[inside])
    return xq.numel() * per_query + touched * c2 * 4


# ---------------------------------------------------------------- phase 3

def fold_inputs(n, spread, dev, seed, c=8):
    """Seeded contact-fold operands: a 400x400 grid with 4 slots per
    cell (some empty), [C, N] queries around a particle cloud and, per 8
    contact rows, two grouped pairs, one inactive member and ungrouped
    points.  Returns ``(packed, queries, act, mv, onehot, seg)``."""
    from slam_eslam_tpu_torch.core.state import BodyContactState
    from slam_eslam_tpu_torch.mapping.mls_grid import PackedLookup

    rng = np.random.default_rng(seed)
    nx, ny, res = GRID["nx"], GRID["ny"], GRID["resolution"]
    ox, oy = GRID["origin"]
    cx = (np.arange(nx) + 0.5) * res + ox
    cy = (np.arange(ny) + 0.5) * res + oy
    base = bench_terrain(cx[:, None], cy[None, :])
    means = base[..., None] + np.concatenate(
        [np.zeros((nx, ny, 1)), rng.uniform(-2.5, 2.5, (nx, ny, 3))], -1)
    stdev = rng.uniform(0.01, 0.1, (nx, ny, 4))
    empty = rng.random((nx, ny, 4)) < 0.3
    data = np.concatenate([np.where(empty, 0.0, means),
                           np.where(empty, -1.0, stdev)], -1)
    packed = PackedLookup(
        data=torch.tensor(data, dtype=torch.float32, device=dev),
        origin=torch.tensor(GRID["origin"], dtype=torch.float32, device=dev),
        resolution=res,
    )

    if spread:
        pxy = rng.uniform(-15.0, 15.0, (n, 2))      # beyond the 20 m grid
    else:
        pxy = rng.normal(0.0, 0.5, (n, 2))
    offs = rng.uniform(-0.4, 0.4, (c, 2))
    qx = offs[:, 0:1] + pxy[None, :, 0]
    qy = offs[:, 1:2] + pxy[None, :, 1]
    qz = bench_terrain(qx, qy) + rng.normal(0.0, 0.05, (c, n))
    far = rng.random((c, n)) < 0.05
    qz = np.where(far, qz + rng.uniform(-4.0, 4.0, (c, n)), qz)
    mv = rng.uniform(0.01, 0.2, (1, n))
    # the 8-row pattern repeated, every repeat with group ids of its own
    rows = np.arange(c)
    pattern = np.array([0, 0, 1, 1, -1, 2, 2, -1])[rows % 8]
    cs = BodyContactState.create(
        np.zeros((c, 3)),
        group_id=np.where(pattern < 0, -1, pattern + 3 * (rows // 8)))
    seg, s = cs.segments()
    onehot = (seg[:, None] == torch.arange(s)[None, :]).float()
    act = np.array([1, 1, 1, 0, 1, 1, 1, 1], np.float32)[rows % 8][:, None]
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    return (packed, (t(qx), t(qy), t(qz)), t(act), t(mv), onehot.to(dev),
            seg.to(dev))


def fold_agrees(label, out_k, out_p, c, n):
    """Raise unless the kernel's ``[8, N]`` agrees with the plain
    version's: rows 0-3 within KERNEL_RTOL (plus KERNEL_ATOL_REL of the
    row's largest magnitude), row 4 exactly, rows 5-7 zero.  Returns the
    largest absolute difference."""
    if out_k.shape != (8, n) or not torch.isfinite(out_k).all():
        raise RuntimeError(f"contact_fold[{label}]: bad output")
    for r in range(4):
        a, b = out_k[r], out_p[r]
        tol = KERNEL_RTOL * b.abs() + KERNEL_ATOL_REL * b.abs().max()
        bad = int(((a - b).abs() > tol).sum())
        if bad:
            raise RuntimeError(f"contact_fold[{label}] row {r}: {bad} "
                               f"values outside tolerance")
    if not torch.equal(out_k[4], out_p[4]) or out_k[5:].any():
        raise RuntimeError(f"contact_fold[{label}]: n_contacts rows "
                           f"differ")
    return float((out_k[:5] - out_p[:5]).abs().max())


def check_contact_fold(dev, cfg):
    from slam_eslam_tpu_torch.ops import _build
    from slam_eslam_tpu_torch.ops import contact_fold as cf
    from slam_eslam_tpu_torch.utils import kernel_eff, profiling

    correction = cfg.contact_model.contact_likelihood_correction
    z_window = cfg.mls_z_window
    max_err, timing = 0.0, None
    for name, n, spread in (("bench", N_BENCH, False),
                            ("ragged", N_RAGGED, False),
                            ("spread", N_BENCH, True)):
        packed, q, act, mv, onehot, seg = fold_inputs(n, spread, dev, seed=n)
        kw = dict(onehot=onehot, correction=correction, z_window=z_window)
        out_k = cf.contact_fold(packed, q, act, mv, **kw)
        out_p = cf.contact_fold_reference(packed, q, act, mv, **kw)
        by_seg = cf.contact_fold(packed, q, act, mv, seg=seg,
                                 correction=correction, z_window=z_window)
        torch.cuda.synchronize()
        if not torch.equal(out_k, by_seg):
            raise RuntimeError(f"contact_fold[{name}]: seg= and onehot= "
                               f"give different results")
        err = fold_agrees(name, out_k, out_p, 8, n)
        max_err = max(max_err, err)
        print(f"contact_fold[{name}] N={n}: max_abs_err={err:.3e} "
              f"mean n_contacts={float(out_k[4].mean()):.3f}")
        if name == "bench":
            # x, y, z per query, mv and 8 output rows per particle, the
            # touched slot rows; the instructions these queries need
            nbytes = grid_query_bytes(packed, q[0], q[1], 12) + 9 * n * 4
            work = kernel_eff.fold_work(packed, q, act, mv, seg, correction,
                                        z_window)
            b_s, b_by, needed = kernel_eff.fold_bound(
                nbytes, work, packed.data.shape[2] // 2)
            byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
            ops_ms = profiling.instruction_bound_seconds(needed) * 1e3
            sass = _build.sass_instructions("contact_fold",
                                            ("contact_fold_kernel", "ILi4E"))
            if sass is None:
                raise RuntimeError("contact_fold: no cuobjdump to count the "
                                   "kernel's instructions with")
            print(f"contact_fold[bench] bound: {nbytes} bytes = "
                  f"{byte_ms:.5f} ms; {needed} instructions needed "
                  f"({needed / q[0].numel():.1f} per query: {work}) = "
                  f"{ops_ms:.5f} ms; bound by {b_by}.  The built kernel: "
                  f"{sass['main']} SASS instructions (static: its loop over "
                  f"the rows once, both Mills branches) and "
                  f"{sass['subroutines']} in slow-path subroutines")
            launch = lambda: cf.launch(packed, q, act, mv, seg, out_k,
                                       correction, z_window)
            timing = kernel_times(
                "contact_fold[bench]",
                lambda: cf.contact_fold(packed, q, act, mv, **kw), launch,
                "contact_fold_kernel",
                lambda: cf.contact_fold_reference(packed, q, act, mv, **kw),
                (b_s * 1e3, b_by), n_plain=20)
            # the wrapper given the group ids (what the model hands it: no
            # argmax) and given the one-hot, in turns
            ways, first, second = in_turns({
                "onehot": lambda: cf.contact_fold(packed, q, act, mv, **kw),
                "seg": lambda: cf.contact_fold(
                    packed, q, act, mv, seg=seg, correction=correction,
                    z_window=z_window)}, dict(onehot=50, seg=50))
            timing.update(bound_ms_bytes=byte_ms, bound_ms_operations=ops_ms,
                          needed_instructions_per_query=(
                              needed / q[0].numel()),
                          tail_share=work["tail"] / max(work["found"], 1),
                          sass_instructions=sass["main"],
                          sass_subroutine_instructions=sass["subroutines"],
                          call_ms_seg=ways["seg"],
                          call_ms_onehot_in_turns=ways["onehot"])
            print(f"contact_fold[bench] call {ways['seg']:.4f} ms with seg= "
                  f"({first['seg']:.4f}, {second['seg']:.4f}), "
                  f"{ways['onehot']:.4f} ms with onehot= "
                  f"({first['onehot']:.4f}, {second['onehot']:.4f}: an "
                  f"argmax and a cast more), in turns")
            cold_times("contact_fold[bench]", launch, timing)
    # a warp's and a block's edges, one row and more rows than the bench
    for c in FOLD_SMALL_C:
        for n in FOLD_SMALL_N:
            packed, q, act, mv, onehot, seg = fold_inputs(
                n, False, dev, seed=1000 * c + n, c=c)
            out_k = cf.contact_fold(packed, q, act, mv, seg=seg,
                                    correction=correction, z_window=z_window)
            out_p = cf.contact_fold_reference(packed, q, act, mv, onehot,
                                              correction, z_window)
            torch.cuda.synchronize()
            max_err = max(max_err, fold_agrees(f"C={c} N={n}", out_k, out_p,
                                               c, n))
    print(f"contact_fold[small] C in {FOLD_SMALL_C} x N in {FOLD_SMALL_N}: "
          f"within tolerance, max_abs_err of all {max_err:.3e}")
    return max_err, timing


# ---------------------------------------------------------------- phase 4

def bench_setup(n, steps):
    """The benchmark configuration, map, trajectory and initial state of
    ``slam_eslam_tpu_torch.bench`` in filter mode, on the host."""
    from slam_eslam_tpu_torch import bench
    from slam_eslam_tpu_torch.models import sim

    args = bench.parser().parse_args(
        ["--particles", str(n), "--steps", str(steps), "--contact-cap",
         str(CONTACT_CAP)])
    css, qs, truth, _ = bench.filter_trajectory(steps, CONTACT_CAP)
    return (bench.filter_config(args),
            sim.terrain_grid(bench.filter_terrain, **bench.FILTER_GRID),
            css, qs, truth, bench.filter_particles(n))


def fresh_state(cfg, particles, dev):
    from slam_eslam_tpu_torch import bench

    return bench.filter_state(cfg, particles, CONTACT_CAP, dev)


def main_path(dev, profile):
    from slam_eslam_tpu_torch.filter import pose_estimator as pe
    from slam_eslam_tpu_torch.filter import step as steplib
    from slam_eslam_tpu_torch.mapping.lookup import make_lookup
    from slam_eslam_tpu_torch.ops import contact_fold as cf
    from slam_eslam_tpu_torch.utils import tree

    cfg, grid, css, qs, truth, particles = bench_setup(N_BENCH, STEPS)
    run = steplib.make_scan_runner(cfg, make_lookup(cfg, tree.to(grid, dev)))
    css_d, qs_d = tree.to(css, dev), qs.to(dev)

    run(fresh_state(cfg, particles, dev), css_d, qs_d)     # warm-up
    torch.cuda.synchronize()
    state0 = fresh_state(cfg, particles, dev)
    torch.cuda.synchronize()

    cf.contact_fold.launches = 0
    # any host sync inside the step raises here
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    final, cents = run(state0, css_d, qs_d)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = cf.contact_fold.launches

    if launches != STEPS:
        raise RuntimeError(f"contact_fold launched {launches} times in "
                           f"{STEPS} steps")
    if cents.shape != (STEPS, 3) or not torch.isfinite(cents).all():
        raise RuntimeError("main path: non-finite or misshaped centroids")
    if not torch.isfinite(final.particles.weight).all():
        raise RuntimeError("main path: non-finite particle weights")
    err = np.linalg.norm(cents[:, :2].cpu().numpy() - truth, axis=1)
    final10 = float(err[-10:].mean())
    print(f"main path: {STEPS} steps x {N_BENCH} particles in "
          f"{elapsed:.4f} s, contact_fold launches {launches}")

    # the first CHECK_STEPS steps against the CPU port on the same draws
    gen = torch.Generator().manual_seed(1)
    draws = [steplib.StepDraws(
        pe.ProjectDraws.sample(N_BENCH, gen, "cpu"),
        torch.rand(N_BENCH, generator=gen)) for _ in range(CHECK_STEPS)]
    sub = tree.index(css, slice(0, CHECK_STEPS))
    run_cpu = steplib.make_scan_runner(cfg, make_lookup(cfg, grid))
    _, cents_cpu = run_cpu(fresh_state(cfg, particles, "cpu"), sub,
                           qs[:CHECK_STEPS], draws)
    _, cents_gpu = run(fresh_state(cfg, particles, dev), tree.to(sub, dev),
                       qs[:CHECK_STEPS].to(dev),
                       [tree.to(d, dev) for d in draws])
    dev_err = float((cents_gpu.cpu() - cents_cpu).abs().max())
    print(f"main path: GPU vs CPU port over {CHECK_STEPS} steps, max "
          f"centroid difference {dev_err:.3e} m")
    if not dev_err <= CENTROID_ATOL:
        raise RuntimeError(f"GPU and CPU centroids differ by {dev_err} m")

    if profile:
        profile_steps(run, cfg, particles, css_d, qs_d, dev, Path(profile))
    return dict(elapsed=elapsed, launches=launches, final10=final10,
                dev_err=dev_err)


# ---------------------------------------------------------------- phase 5

def in_turns(fns, iters):
    """Mean ms per call of each function of ``fns`` (a dict), timed after
    a warm-up in the dict's order and then in its reverse, so that every
    function is measured early and late."""
    for f in fns.values():
        cuda_ms(f, 2)
    names = list(fns)
    first = {k: cuda_ms(fns[k], iters[k]) for k in names}
    second = {k: cuda_ms(fns[k], iters[k]) for k in reversed(names)}
    return {k: (first[k] + second[k]) / 2 for k in names}, first, second


def alternate(kern, plain, n_kern=50, n_plain=5):
    """Mean ms per call of ``kern`` and ``plain``, timed in turns (plain,
    kernel, kernel, plain) after a warm-up; returns ``(kernel_ms,
    plain_ms, the four runs)``."""
    ms, first, second = in_turns({"plain": plain, "kern": kern},
                                 {"plain": n_plain, "kern": n_kern})
    return ms["kern"], ms["plain"], (first["plain"], first["kern"],
                                     second["kern"], second["plain"])


def chain_lookup_bytes(pool, chain, queries, z_window):
    """Bytes one chain lookup must move for these inputs: per query its
    x, y, z and the three outputs; the chain; and per level a query
    reaches (the walk ends at the first hit) the block's origin and the
    cell's mean and meta rows, plus the stdev row where it hits."""
    from slam_eslam_tpu_torch.ops import chain_lookup as cl

    xq, yq, zq = queries
    size = pool.mean.element_size()
    nbytes = xq.numel() * (12 + 9) + chain.numel() * 4
    found = torch.zeros_like(xq, dtype=torch.bool)
    size_x, size_y = pool.nx * pool.resolution, pool.ny * pool.resolution
    for level in range(chain.shape[1]):
        b = chain[:, level]
        ok = (b >= 0)[:, None] & ~found
        org = pool.origin.index_select(0, b.clamp(min=0).long())
        inside = ((xq >= org[:, 0:1]) & (xq < org[:, 0:1] + size_x)
                  & (yq >= org[:, 1:2]) & (yq < org[:, 1:2] + size_y))
        hit, _, _ = cl.block_get_patch(
            pool.mean, pool.stdev, pool.meta, pool.origin, pool.resolution,
            b.clamp(min=0), xq, yq, zq, k=pool.k, z_window=z_window)
        hit = hit & ok
        nbytes += int(ok.sum()) * 8
        nbytes += int((ok & inside).sum()) * pool.k * (size + 4)
        nbytes += int(hit.sum()) * pool.k * size
        found |= hit
    return nbytes


def check_chain_lookup(dev, pool, z_window):
    from slam_eslam_tpu_torch.models import sim
    from slam_eslam_tpu_torch.ops import chain_lookup as cl

    queries = sim.chain_queries(pool, SLAM_C, seed=5)
    max_err, timing = 0.0, None
    for name, n in (("bench", SLAM_N), ("ragged", SLAM_N_RAGGED)):
        args = (pool.mean, pool.stdev, pool.meta, pool.origin,
                pool.resolution, pool.chain[:n].contiguous(),
                tuple(q[:n].contiguous() for q in queries))
        # with the slot index a colour pool's lookup gathers its colour by
        kw = dict(k=pool.k, z_window=z_window)
        got = cl.chain_lookup(*args, **kw, with_slot=True)
        ref = cl.chain_lookup_reference(*args, **kw, with_slot=True)
        torch.cuda.synchronize()
        if not (torch.equal(got[3] >= 0, got[0]) and all(
                torch.equal(a, b) for a, b in zip(
                    got[:3], cl.chain_lookup(*args, **kw)))):
            raise RuntimeError(f"chain_lookup[{name}]: the slot output "
                               f"changes the result")
        if got[0].shape != (n, SLAM_C):
            raise RuntimeError(f"chain_lookup[{name}]: bad output shape")
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            bad = int((got[0] != ref[0]).sum())
            raise RuntimeError(f"chain_lookup[{name}]: differs from its "
                               f"plain version ({bad} found flags)")
        max_err = max(max_err, *(float((a - b).abs().max())
                                 for a, b in zip(got[1:3], ref[1:3])))
        empty = float((pool.chain[:n] < 0).float().mean())
        print(f"chain_lookup[{name}] N={n} C={SLAM_C} L="
              f"{pool.chain.shape[1]} {pool.mean.dtype}: bitwise equal, slot "
              f"indices too, found "
              f"{float(got[0].float().mean()):.4f}, empty chain entries "
              f"{empty:.4f}")
        if name == "bench":
            outs = cl.chain_lookup(*args, **kw)
            timing = kernel_times(
                "chain_lookup[bench]", lambda: cl.chain_lookup(*args, **kw),
                lambda: cl.launch(*args, outs, **kw), "chain_lookup_kernel",
                lambda: cl.chain_lookup_reference(*args, **kw),
                bound(chain_lookup_bytes(pool, args[5], args[6], z_window)))
    return max_err, timing


def one_point_slots(pool, blk, lx, ly):
    """Pool slots of cells that exactly one masked-in point hits."""
    inb = (lx < pool.nx) & (ly < pool.ny)
    cell = (blk.long()[:, None] * pool.nx + lx.long()) * pool.ny + ly.long()
    counts = torch.zeros(pool.b * pool.nx * pool.ny, dtype=torch.int32,
                         device=blk.device)
    counts.index_add_(0, cell[inb], torch.ones_like(cell[inb],
                                                    dtype=torch.int32))
    return (counts == 1).reshape(pool.b, pool.nx, pool.ny, 1).expand(
        -1, -1, -1, pool.k).reshape(pool.mean.shape)


def bench_cloud(dev):
    """The SLAM benchmark's scan: 64 rays at 2 m over a half turn,
    projected with an identity mount and orientation."""
    from slam_eslam_tpu_torch.mapping import projection

    scan = projection.LaserScan(
        torch.full((SLAM_RAYS,), 2.0, device=dev),
        torch.tensor(-np.pi / 2, dtype=torch.float32, device=dev),
        torch.tensor(np.pi / SLAM_RAYS, dtype=torch.float32, device=dev))
    pts, valid = projection.scan_to_points(scan, 3.0)
    eye = torch.eye(3, device=dev)
    q = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
    return projection.project_points(pts, valid, eye,
                                     torch.zeros(3, device=dev), q)


def hit_cells(blk, lx, ly, b, nx, ny):
    """``(in-range points, distinct hit cells)`` of merge operands."""
    from slam_eslam_tpu_torch.ops.block_copy import hit_rows

    rows = hit_rows(blk, lx, ly, b, nx, ny)
    return int(rows.numel()), distinct(rows)


def block_merge_bytes(pool, blk, lx, ly):
    """Bytes one block merge must move for these operands: the block ids
    and the four point rows; per distinct hit cell the K slots of the
    four fields read and one slot of each written.  The operations (two
    sums per point, about 50 per cell for the slot rules, the sort's
    P log^2 P compares per particle) are counted for the other bound."""
    n, p = lx.shape
    size = pool.mean.element_size()
    _, cells = hit_cells(blk, lx, ly, pool.b, pool.nx, pool.ny)
    nbytes = (n * 4 + 4 * n * p * 4
              + cells * (pool.k * (3 * size + 4) + 3 * size + 4))
    p_pad = 1 << (p - 1).bit_length()
    flops = n * p_pad * (p_pad.bit_length() ** 2) / 2 + 2 * n * p + 50 * cells
    return nbytes, flops


def bf16_steps(a, b):
    """Per-element distance, in bfloat16 steps, of two bfloat16 tensors."""
    return (a.view(torch.int16).long() - b.view(torch.int16).long()).abs()


def check_block_merge(dev, pool, cfg):
    from slam_eslam_tpu_torch.mapping import map_pool as mp
    from slam_eslam_tpu_torch.models import sim
    from slam_eslam_tpu_torch.ops import block_merge as bm

    ops = mp.merge_operands(pool, *sim.poses_on_heads(pool, 3.0, seed=7),
                            bench_cloud(dev))
    kw = dict(k=pool.k, patch_thickness=cfg.grid_patch_thickness,
              gap_size=cfg.grid_gap_size)
    fields = [pool.mean, pool.stdev, pool.height, pool.meta]
    max_err, timing = 0.0, None
    for name, n in (("bench", SLAM_N), ("ragged", SLAM_N_RAGGED)):
        blk, lx, ly, w, wz = (a[:n].contiguous() for a in ops)
        kern = [f.clone() for f in fields]
        plain = [f.clone() for f in fields]
        bm.block_merge(*kern, None, blk, lx, ly, w, wz, 7, **kw)
        bm.block_merge_reference(*plain, None, blk, lx, ly, w, wz, 7, **kw)
        torch.cuda.synchronize()
        if not torch.equal(kern[3], plain[3]):
            bad = int((kern[3] != plain[3]).sum())
            raise RuntimeError(f"block_merge[{name}]: meta differs in {bad} "
                               f"slots")
        one = one_point_slots(pool, blk, lx, ly)
        bf16 = pool.mean.dtype == torch.bfloat16
        for fname, a, b in zip(("mean", "stdev", "height"), kern, plain):
            if not torch.equal(a[one], b[one]):
                raise RuntimeError(f"block_merge[{name}] {fname}: one-point "
                                   f"cells not bitwise equal")
            if bf16:
                # float32 sums in another order, then one rounding
                outside = bf16_steps(a, b) > 1
            else:
                outside = (a - b).abs() > (
                    MERGE_HEIGHT_ATOL if fname == "height"
                    else MERGE_RTOL * b.abs())
            if bool(outside.any()):
                raise RuntimeError(f"block_merge[{name}] {fname}: outside "
                                   f"tolerance")
            max_err = max(max_err, float((a.float() - b.float()).abs().max()))
        written = int((kern[3] != pool.meta).sum())
        multi = int(((kern[3] != pool.meta) & ~one).sum())
        print(f"block_merge[{name}] N={n} P={lx.shape[1]} "
              f"{pool.mean.dtype}: {written} slots "
              f"written ({multi} from multi-point cells), meta equal, "
              f"max_abs_err={max_err:.3e}")
        if name == "bench":
            timing = kernel_times(
                "block_merge[bench]",
                lambda: bm.block_merge(*kern, None, blk, lx, ly, w, wz, 7,
                                       **kw),
                lambda: bm.launch(*kern, None, blk, lx, ly, w, wz, 7, **kw),
                "block_merge_kernel",
                lambda: bm.block_merge_reference(*plain, None, blk, lx, ly,
                                                 w, wz, 7, **kw),
                bound(*block_merge_bytes(pool, blk, lx, ly)))
        del kern, plain
    return max_err, timing


def check_slam_kernels(dev, cfg, dtype=torch.float32):
    from slam_eslam_tpu_torch.models import sim

    pool = sim.random_pool(SLAM_N, cfg.map_pool_blocks, **SLAM_POOL,
                           seed=3, device=dev, dtype=dtype)
    print(f"SLAM pool: {pool.b} blocks of {pool.nx}x{pool.ny}x{pool.k} "
          f"{dtype}, {pool.storage_bytes() / 1e9:.3f} GB, "
          f"{int(pool.count_valid()) / pool.meta.numel():.4f} of slots "
          f"valid")
    k2 = check_chain_lookup(dev, pool, cfg.mls_z_window)
    k3 = check_block_merge(dev, pool, cfg)
    return k2, k3


# ---------------------------------------------------------------- phase 6

def slam_args(n=None, steps=None, dtype="float32", extra=()):
    """The command line of ``slam_eslam_tpu_torch.bench`` in SLAM mode
    (default: phase 6's particle count and scans)."""
    n, steps = n or SLAM_N, steps or SLAM_STEPS
    return ["--mode", "slam", "--particles", str(n), "--steps", str(steps),
            "--contact-cap", str(CONTACT_CAP), "--pool-dtype", dtype, *extra]


def slam_config(dtype="float32"):
    from slam_eslam_tpu_torch import bench

    return bench.slam_config(bench.parser().parse_args(slam_args(dtype=dtype)))


def slam_setup():
    """The SLAM benchmark trajectory of ``slam_eslam_tpu_torch.bench``:
    ``(z0, frames, full contact states, orientations)``, on the host."""
    from slam_eslam_tpu_torch import bench

    return bench.slam_trajectory(SLAM_STEPS, CONTACT_CAP)


def slam_carry(cfg, z0, dev, normals=None):
    from slam_eslam_tpu_torch import bench

    return bench.slam_carry(cfg, z0, dev, normals)


def slam_draws(n_frames):
    """Seeded start normals and per-frame draws, on the host."""
    from slam_eslam_tpu_torch.filter import pose_estimator as pe
    from slam_eslam_tpu_torch.filter.step import StepDraws

    gen = torch.Generator().manual_seed(1)
    normals = (torch.randn((SLAM_N, 2), generator=gen),
               torch.randn((SLAM_N,), generator=gen))
    draws = [StepDraws(pe.ProjectDraws.sample(SLAM_N, gen, "cpu"),
                       torch.rand(SLAM_N, generator=gen))
             for _ in range(n_frames)]
    return normals, draws


def slam_compare(run, cfg, z0, frames, full, qs, dev, label):
    """The first SLAM_CHECK_FRAMES frames on the card against the CPU
    port on identical draws: equal gates, centroids within CENTROID_ATOL,
    patch counts within PATCH_COUNT_RTOL.  Returns ``(largest centroid
    difference, the card's centroids [T, 3])``."""
    from slam_eslam_tpu_torch.filter import streaming
    from slam_eslam_tpu_torch.utils import tree

    sub = slice(0, SLAM_CHECK_FRAMES)
    normals, draws = slam_draws(SLAM_CHECK_FRAMES)
    out = {}
    for d in ("cpu", dev):
        odos = streaming.precompute_odometry(
            20, tree.to(full, d), qs.to(d), cfg=cfg)
        carry, aux = run(slam_carry(cfg, z0, d, normals),
                         tree.to(frames, d).at(sub), tree.index(odos, sub),
                         [tree.to(x, d) for x in draws])
        out[str(d)] = (aux, int(carry.pool.count_valid()))
        del carry
    (a_cpu, p_cpu), (a_gpu, p_gpu) = out["cpu"], out[str(dev)]
    if not ((a_gpu["updated"] == a_cpu["updated"]).all()
            and (a_gpu["mapped"] == a_cpu["mapped"]).all()):
        raise RuntimeError(f"{label}: GPU and CPU gates differ")
    dev_err = float((a_gpu["centroid"].cpu() - a_cpu["centroid"]).abs().max())
    print(f"{label}: GPU vs CPU port over {SLAM_CHECK_FRAMES} frames, max "
          f"centroid difference {dev_err:.3e} m, patches {p_gpu} vs {p_cpu}")
    if not dev_err <= CENTROID_ATOL:
        raise RuntimeError(f"{label}: GPU and CPU centroids differ by "
                           f"{dev_err} m")
    if abs(p_gpu - p_cpu) > PATCH_COUNT_RTOL * p_cpu:
        raise RuntimeError(f"{label}: patch counts {p_gpu} (GPU) and "
                           f"{p_cpu} (CPU) differ")
    return dev_err, a_gpu["centroid"]


def check_slam_state(carry, aux, n_frames, label):
    """Finite centroids, weights and pool, some patches merged; returns
    ``(patches, alloc_failed)``.  The pool is scanned in chunks of blocks
    (a pool-sized temporary would not fit beside a 25 GB pool)."""
    if aux["centroid"].shape != (n_frames, 3) or not bool(
            torch.isfinite(aux["centroid"]).all()):
        raise RuntimeError(f"{label}: non-finite or misshaped centroids")
    if not bool(torch.isfinite(carry.filter.particles.weight).all()):
        raise RuntimeError(f"{label}: non-finite particle weights")
    pool = carry.pool
    for name in ("mean", "stdev", "height"):
        finite = torch.ones((), dtype=torch.bool, device=pool.meta.device)
        for part in getattr(pool, name).split(16384):
            finite &= torch.isfinite(part).all()
        if not bool(finite):
            raise RuntimeError(f"{label}: non-finite pool {name}")
    patches = int(pool.count_valid())
    if patches <= 0:
        raise RuntimeError(f"{label}: no patches were merged")
    return patches, int(carry.alloc_failed)


def slam_path(dev, profile):
    from slam_eslam_tpu_torch import bench
    from slam_eslam_tpu_torch.filter import streaming
    from slam_eslam_tpu_torch.ops import block_merge as bm
    from slam_eslam_tpu_torch.ops import chain_lookup as cl
    from slam_eslam_tpu_torch.ops import contact_fold as cf
    from slam_eslam_tpu_torch.utils import tree

    cfg = slam_config()
    z0, frames, full, qs = slam_setup()
    n_frames = len(frames)
    frames_d = tree.to(frames, dev)
    odos = streaming.precompute_odometry(20, tree.to(full, dev), qs.to(dev),
                                         cfg=cfg)
    run = bench.make_slam_runner(cfg)
    warm = slice(0, 30)
    run(slam_carry(cfg, z0, dev), frames_d.at(warm), tree.index(odos, warm))
    carry0 = slam_carry(cfg, z0, dev)
    torch.cuda.synchronize()

    cf.contact_fold.launches = 0
    cl.chain_lookup.launches = 0
    bm.block_merge.launches = 0
    # any host sync inside a frame raises here
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    try:
        carry, aux = run(carry0, frames_d, odos)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"contact_fold": cf.contact_fold.launches,
                "chain_lookup": cl.chain_lookup.launches,
                "block_merge": bm.block_merge.launches}
    del carry0

    n_meas, n_map = int(aux["updated"].sum()), int(aux["mapped"].sum())
    want = {"chain_lookup": n_meas + (n_map if cfg.use_visual_update else 0),
            "block_merge": n_map, "contact_fold": 0}
    if launches != want or not n_meas or not n_map:
        raise RuntimeError(f"SLAM path: launches {launches}, gates want "
                           f"{want}")
    patches, failed = check_slam_state(carry, aux, n_frames, "SLAM path")
    print(f"SLAM path: {n_frames} frames x {SLAM_N} particles in "
          f"{elapsed:.4f} s = {n_frames / elapsed:.2f} frames/s; "
          f"{n_meas} measurement and {n_map} mapping frames; launches "
          f"{launches}; patches {patches}, alloc_failed {failed}")
    del carry

    # the first frames against the CPU port on the same draws
    dev_err, _ = slam_compare(run, cfg, z0, frames, full, qs, dev,
                              "SLAM path")

    if profile:
        profile_slam(run, cfg, z0, frames_d, odos, dev, Path(profile))
    return dict(elapsed=elapsed, frames=n_frames, launches=launches,
                patches=patches, failed=failed, dev_err=dev_err,
                n_meas=n_meas, n_map=n_map)


# ---------------------------------------------------------------- phase 7

def select_outs(q, dev):
    return (torch.empty(q, dtype=torch.bool, device=dev),
            torch.empty(q, dtype=torch.float32, device=dev),
            torch.empty(q, dtype=torch.float32, device=dev))


def check_select_cells(dev, cfg):
    """K5 against its plain version on the phase-3 grid and queries, flat:
    every output bit for bit, misses included; the int32-cell entry
    against the world entry; small counts, and views that start 4 bytes
    into a tensor; timed on the card, and the wrapper in turns with the
    plain version."""
    from slam_eslam_tpu_torch.mapping import mls_grid
    from slam_eslam_tpu_torch.ops import select_cells as sc

    z_window = cfg.mls_z_window
    max_err, timing = 0.0, None

    def compare(label, packed, q):
        """World and cell entries against the plain version; returns the
        kernel's outputs and the cells."""
        got = sc.select_cells(packed, q, z_window)
        ref = sc.select_cells_reference(packed, q, z_window)
        ix, iy = mls_grid.cells(packed, q[0], q[1])
        by_cell = sc.select_cells(packed, (ix, iy, q[2]), z_window)
        torch.cuda.synchronize()
        if got[0].shape != q[2].shape:
            raise RuntimeError(f"select_cells[{label}]: bad output shape")
        for what, out in (("plain version", ref), ("cell entry", by_cell)):
            if not all(torch.equal(a, b) for a, b in zip(got, out)):
                bad = int((got[0] != out[0]).sum())
                raise RuntimeError(f"select_cells[{label}]: differs from the "
                                   f"{what} ({bad} found flags)")
        return got, ref, (ix, iy)

    for name, n, spread in (("bench", N_BENCH, False),
                            ("ragged", N_RAGGED, False),
                            ("spread", N_BENCH, True)):
        packed, q, *_ = fold_inputs(n, spread, dev, seed=n + 7)
        q = tuple(a.reshape(-1).contiguous() for a in q)
        got, ref, (ix, iy) = compare(name, packed, q)
        max_err = max(max_err, *(float((a - b).abs().max())
                                 for a, b in zip(got[1:3], ref[1:3])))
        inside = (ix >= 0) & (ix < packed.data.shape[0]) & (iy >= 0) & (
            iy < packed.data.shape[1])
        print(f"select_cells[{name}] Q={8 * n}: bitwise equal, found "
              f"{float(got[0].float().mean()):.4f}, outside the grid "
              f"{float((~inside).float().mean()):.4f}")
        if name == "spread":
            # small counts, one past a full block, and views that start 4
            # bytes into a tensor
            for count in SELECT_SMALL_Q:
                big = fold_inputs(-(-count // 8) + 1, True, dev,
                                  seed=count)[1]
                flat = tuple(a.reshape(-1) for a in big)
                compare(f"Q={count}", packed,
                        tuple(a[:count].contiguous() for a in flat))
                compare(f"Q={count} offset view", packed,
                        tuple(a[1:count + 1] for a in flat))
            print(f"select_cells[small] Q in {SELECT_SMALL_Q}, on fresh "
                  f"tensors and on views that start 4 bytes into one, both "
                  f"entries: bitwise equal")
        if name == "bench":
            outs = select_outs(q[2].numel(), dev)
            # x, y, z read and found, mean, stdev written per query, and
            # the touched slot rows
            launch = lambda: sc.launch(packed, q, outs, z_window)
            timing = kernel_times(
                "select_cells[bench]",
                lambda: sc.select_cells(packed, q, z_window), launch,
                "select_world_kernel",
                lambda: sc.select_cells_reference(packed, q, z_window),
                bound(grid_query_bytes(packed, q[0], q[1], 12 + 9)),
                n_plain=20)
            cold_times("select_cells[bench]", launch, timing)
    return max_err, timing


def app_config(**contact):
    from slam_eslam_tpu_torch import Config, ContactModelConfig

    return dataclasses.replace(
        Config(), particle_count=N_BENCH, min_effective=N_BENCH // 5,
        contact_model=ContactModelConfig(contact_point_radius=0.0, **contact),
        log_debug=not contact, log_particle_period=APP_LOG_PERIOD)


def app_classes(x, y):
    """Terrain-class colours of the slip run: class 0 west of x = 0,
    class 1 east of it."""
    east = np.asarray(x) > 0.0
    return np.stack([~east, east, np.zeros_like(east)], -1)


def app_labels(frame):
    """Per-wheel terrain labels of the slip run: wheels 0 and 1 on class
    0, wheel 3 on class 1 from frame 10."""
    out = [(0, [0.8, 0.1, 0.1]), (1, [0.7, 0.2, 0.1])]
    if frame >= 10:
        out.append((3, [0.1, 0.8, 0.1]))
    return out


def app_setup():
    """The localisation bench's trajectory for ``update_contact``: the
    host poses ``(quaternion, position)`` the motion gate reads, and the
    contact states (compacted to 8) and orientations, stacked."""
    from slam_eslam_tpu_torch.models import sim
    from slam_eslam_tpu_torch.utils import geometry, tree

    trajectory = sim.TrajectorySim(bench_terrain, speed=0.05)
    z0 = float(trajectory.position[2])
    poses, css, qs = [], [], []
    for _ in range(APP_FRAMES):
        (pos, yaw), _ = trajectory.step()
        q = geometry.quat_from_yaw(torch.tensor(yaw, dtype=torch.float32))
        css.append(trajectory.contact_state(noise=0.005).compact(CONTACT_CAP))
        qs.append(q)
        poses.append((q.numpy(), pos))
    return z0, poses, tree.stack(css), torch.stack(qs)


def app_filter(cfg, grid, z0, dev, hash_config=None, particles=None):
    from slam_eslam_tpu_torch.filter.eslam_filter import EmbodiedSlamFilter
    from slam_eslam_tpu_torch.utils import tree

    f = EmbodiedSlamFilter(config=cfg, device=dev).init(
        pose=(np.array([0.0, 0.0, z0]), 0.0), shared_grid=grid,
        hash_config=hash_config, num_contact_points=CONTACT_CAP)
    if particles is not None:
        f.state = dataclasses.replace(f.state,
                                      particles=tree.to(particles, dev))
    return f


def app_drive(f, poses, css, qs, frames, labels=None, spans=None,
              exports=None):
    """``update_contact`` over the first ``frames`` frames (contact
    states and orientations already on the filter's device), host syncs
    forbidden in each call.  ``spans`` collects, per call, CUDA events
    around it and its host milliseconds (the time to launch its work),
    ``exports`` the period-gated distributions.  Returns the gate
    decisions."""
    gates = []
    for i in range(frames):
        if spans is not None:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            gates.append(f.update_contact(
                poses[i], css[i], None if labels is None else labels(i),
                orientation=qs[i]))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if spans is not None:
            host_ms = (time.perf_counter() - t0) * 1e3
            ev[1].record()
            spans.append((*ev, host_ms))
        if exports is not None:
            dist = f.maybe_log_distribution()
            if dist is not None:
                exports.append((i, dist))
    return gates


def check_app_state(f, name):
    p = f.state.particles
    cent, quat = f.get_centroid()
    if not (bool(torch.isfinite(p.weight).all())
            and bool(torch.isfinite(cent).all())
            and bool(torch.isfinite(quat).all())):
        raise RuntimeError(f"application path[{name}]: non-finite state")
    return cent


def app_compare(dev, cfg, hcfg, grid, z0, poses, css, qs):
    """The card against the CPU port on identical draws.  The global
    initialisation: equal hash tables (no bucket flips) and equal
    particles from equal integer draws.  Then the first CHECK_STEPS
    frames from one Gaussian start cloud, with the same odometry noise,
    resampling uniforms and in-bucket reinjection draws.  (From the
    hash's map-wide cloud a one-ulp difference of a weight moves a
    resampling ancestor by metres, not by the centimetres the tolerance
    is made for.)"""
    from slam_eslam_tpu_torch.filter import pose_estimator as pe
    from slam_eslam_tpu_torch.filter.eslam_filter import ContactDraws
    from slam_eslam_tpu_torch.utils import tree

    f_cpu = app_filter(cfg, grid, z0, "cpu", hcfg)
    f_gpu = app_filter(cfg, tree.to(grid, dev), z0, dev, hcfg)
    h = f_cpu.hash
    flips = int((f_gpu.hash.bucket_id.cpu() != h.bucket_id).sum())
    gen = torch.Generator().manual_seed(2)
    n = cfg.particle_count
    u = torch.randint(0, int(h.n_valid), (n,), generator=gen)
    p_cpu = h.sample_particles(n, u)
    p_gpu = f_gpu.hash.sample_particles(n, u.to(dev))
    if flips or not all(torch.equal(getattr(p_cpu, f.name),
                                    getattr(p_gpu, f.name).cpu())
                        for f in dataclasses.fields(p_cpu)):
        raise RuntimeError(f"application path: the hash differs on the card "
                           f"({flips} bucket flips)")

    start = pe.init_gaussian(
        n, (0.0, 0.0), 0.0, cfg.initial_translation_error[:2],
        cfg.initial_rotation_error[2], z0,
        cfg.initial_translation_error[2] + 1e-3, generator=gen)
    for f in (f_cpu, f_gpu):
        f.state = dataclasses.replace(
            f.state, particles=tree.to(start, f.device))
    dev_err, cp_err, gates = 0.0, 0.0, []
    for i in range(CHECK_STEPS):
        cs, q = tree.index(css, i), qs[i]
        count = int(h._at_bucket(h.bucket_count,
                                 h.bucket(*h.signature(cs, q))))
        draws = ContactDraws(
            pe.ProjectDraws.sample(n, gen, "cpu"),
            torch.rand(n, generator=gen),
            (torch.rand(n, generator=gen, dtype=torch.float64)
             * max(count, 1)).long())
        g_cpu = f_cpu.update_contact(poses[i], cs, draws=draws, orientation=q)
        g_gpu = f_gpu.update_contact(poses[i], tree.to(cs, dev),
                                     draws=tree.to(draws, dev),
                                     orientation=q.to(dev))
        if g_cpu != g_gpu:
            raise RuntimeError(f"application path: gates differ at frame {i}")
        gates.append(g_gpu)
        c_cpu, c_gpu = f_cpu.get_centroid()[0], f_gpu.get_centroid()[0]
        dev_err = max(dev_err, float((c_gpu.cpu() - c_cpu).abs().max()))
        if g_gpu:
            n_cpu = int(f_cpu.last_eval.cp_ok.sum())
            n_gpu = int(f_gpu.last_eval.cp_ok.sum())
            cp_err = max(cp_err, abs(n_gpu - n_cpu) / max(n_cpu, 1))
    rein = app_reinjections(gates, hcfg)
    print(f"application path: GPU vs CPU port, hash of "
          f"{h.bucket_id.numel()} candidates with {flips} bucket flips and "
          f"equal global-init particles; over {CHECK_STEPS} frames "
          f"({sum(gates)} measurement updates, {rein} reinjections): max "
          f"centroid difference {dev_err:.3e} m, cp_ok counts within "
          f"{cp_err:.3e}")
    if not dev_err <= CENTROID_ATOL:
        raise RuntimeError(f"application path: GPU and CPU centroids differ "
                           f"by {dev_err} m")
    if not cp_err <= CP_OK_RTOL:
        raise RuntimeError(f"application path: cp_ok counts differ by "
                           f"{cp_err}")
    return dev_err, cp_err, flips


def app_reinjections(gates, hcfg):
    """Hash reinjections in a run: measurement updates on a step count
    that is a multiple of the period."""
    return sum(1 for i, g in enumerate(gates)
               if g and (i + 1) % max(1, hcfg.period) == 0)


def app_path(dev, profile):
    from slam_eslam_tpu_torch import SurfaceHashConfig
    from slam_eslam_tpu_torch.models import sim
    from slam_eslam_tpu_torch.ops import contact_fold as cf
    from slam_eslam_tpu_torch.ops import select_cells as sc
    from slam_eslam_tpu_torch.utils import tree

    cfg = app_config()
    # the gate fires on every second frame, at odd step counts, so the
    # default period of 10 steps would never reinject
    hcfg = SurfaceHashConfig(use_hash=True, period=APP_HASH_PERIOD)
    grid = sim.terrain_grid(bench_terrain, **GRID)
    grid_d = tree.to(grid, dev)
    z0, poses, css, qs = app_setup()
    css_d, qs_d = tree.to(css, dev), qs.to(dev)
    frames = [tree.index(css_d, i) for i in range(APP_FRAMES)]
    qs_l = [qs_d[i] for i in range(APP_FRAMES)]

    app_drive(app_filter(cfg, grid_d, z0, dev, hcfg), poses, frames, qs_l,
              10)                                               # warm-up
    t0 = time.perf_counter()
    f = app_filter(cfg, grid_d, z0, dev, hcfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    spans, exports = [], []
    cf.contact_fold.launches = 0
    sc.select_cells.launches = 0
    t0 = time.perf_counter()
    gates = app_drive(f, poses, frames, qs_l, APP_FRAMES, spans=spans,
                      exports=exports)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"select_cells": sc.select_cells.launches,
                "contact_fold": cf.contact_fold.launches}
    n_meas = sum(gates)
    if launches != {"select_cells": n_meas, "contact_fold": 0} or not n_meas:
        raise RuntimeError(f"application path: launches {launches} for "
                           f"{n_meas} measurement updates")
    check_app_state(f, "log_debug+hash")
    ev = f.last_eval
    if not bool(ev.cp_ok.any()) or not bool(
            (ev.cp_point[ev.cp_ok].abs().sum(-1) > 0).all()):
        raise RuntimeError("application path: no debug contact points")
    if [i for i, _ in exports] != [i for i in range(APP_FRAMES)
                                   if (i + 1) % APP_LOG_PERIOD == 0]:
        raise RuntimeError(f"application path: exports at frames "
                           f"{[i for i, _ in exports]}")
    for _, dist in exports:
        if not (bool(torch.isfinite(dist.gmm_means).all())
                and bool(torch.isfinite(dist.gmm_covs).all())
                and dist.cpoints.shape == ev.cp_point.shape):
            raise RuntimeError("application path: bad distribution export")
    def mean_ms(which, gated):
        ms = [which(span) for span, g in zip(spans, gates) if g == gated]
        return sum(ms) / max(len(ms), 1)

    device_ms = lambda span: span[0].elapsed_time(span[1])
    host_ms = lambda span: span[2]
    ms_meas, ms_plain = mean_ms(device_ms, True), mean_ms(device_ms, False)
    host_meas, host_plain = mean_ms(host_ms, True), mean_ms(host_ms, False)
    print(f"application path: {APP_FRAMES} frames x {N_BENCH} particles in "
          f"{elapsed:.4f} s = {APP_FRAMES / elapsed:.2f} frames/s; "
          f"{n_meas} measurement updates at {ms_meas:.4f} ms each (CUDA "
          f"events; {host_meas:.4f} ms on the host), other frames "
          f"{ms_plain:.4f} ms ({host_plain:.4f} ms); launches {launches}; "
          f"{len(exports)} distribution exports, "
          f"{app_reinjections(gates, hcfg)} hash reinjections; hash "
          f"{f.hash.cand_xy.shape[0]} candidates, {int(f.hash.n_valid)} "
          f"valid, init {init_s:.4f} s")
    del f, spans, exports

    short = {}
    for name, contact, grid_s, labels in (
            ("chitta", dict(weighting="chitta"), grid_d, None),
            ("slip", dict(use_slip_update=True),
             tree.to(sim.terrain_grid(bench_terrain, **GRID,
                                      color=app_classes), dev),
             app_labels)):
        cfg_s = app_config(**contact)
        f_s = app_filter(cfg_s, grid_s, z0, dev)
        sc.select_cells.launches = 0
        cf.contact_fold.launches = 0
        g = app_drive(f_s, poses, frames, qs_l, APP_SHORT_FRAMES,
                      labels=labels)
        k5 = sc.select_cells.launches
        want = sum(g) if name == "chitta" else 0
        if k5 != want or cf.contact_fold.launches or not sum(g):
            raise RuntimeError(f"application path[{name}]: select_cells "
                               f"launched {k5} times, contact_fold "
                               f"{cf.contact_fold.launches}, for {sum(g)} "
                               f"updates")
        cent = check_app_state(f_s, name)
        short[name] = (sum(g), k5)
        print(f"application path[{name}]: {APP_SHORT_FRAMES} frames, "
              f"{sum(g)} measurement updates, select_cells launches {k5}, "
              f"centroid {cent.cpu().numpy()}")
        del f_s

    dev_err, cp_err, flips = app_compare(dev, cfg, hcfg, grid, z0, poses,
                                         css, qs)
    if profile:
        profile_app(cfg, hcfg, grid_d, z0, poses, frames, qs_l, dev,
                    Path(profile))
    return dict(elapsed=elapsed, launches=launches, n_meas=n_meas,
                ms_meas=ms_meas, ms_plain=ms_plain, host_meas=host_meas,
                host_plain=host_plain, dev_err=dev_err,
                cp_err=cp_err, flips=flips, short=short)


# ---------------------------------------------------------------- phase 8

def max_abs_diff(got, ref):
    """Largest |got - ref| over pairs of tensors, in float32."""
    return max(float((a.float() - b.float()).abs().max())
               for a, b in zip(got, ref))


def block_copy_bytes(fields, blk, points, mode):
    """Bytes one block copy must move: in whole mode every field's block
    read and written and the four point rows read; in cells mode lx and
    ly of every point, w and wz of the in-range ones, and per distinct
    hit cell the K slots of every field read and written."""
    b, nx, nyk = fields[0].shape
    n, p = points[0].shape
    sizes = sum(f.element_size() for f in fields)
    if mode == "whole":
        return n * (4 + 2 * nx * nyk * sizes + 4 * p * 4)
    k = COPY_BLOCK["k"]
    inb, cells = hit_cells(blk, points[0], points[1], b, nx, nyk // k)
    return n * 4 + n * p * 8 + inb * 8 + cells * 2 * k * sizes


def check_block_copy(dev, cfg):
    """K7 against its plain version, bit for bit: every mode, float32 and
    bfloat16 fields, in place and into a second pool, at the merge
    benchmark's N and a ragged one; then K7, its plain version, the
    library call and the merge (K3) on the same operands in turns.
    Returns ``(largest |kernel - plain| of all comparisons, timings)``."""
    from slam_eslam_tpu_torch.ops import block_copy as bc
    from slam_eslam_tpu_torch.ops import block_merge as bm
    from slam_eslam_tpu_torch.utils import kernel_eff, profiling

    # the operands that the benchmark's merge_floor_fraction times
    copy_inputs = lambda n, dtype, seed: kernel_eff.merge_benchmark_operands(
        n, COPY_P, **COPY_BLOCK, device=dev, dtype=dtype, seed=seed)
    k = COPY_BLOCK["k"]
    same = lambda a, b: torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    max_err = 0.0
    for name, n in (("bench", COPY_N), ("ragged", COPY_N_RAGGED)):
        for dtype in (torch.float32, torch.bfloat16):
            fields, blk, points = copy_inputs(n, dtype, n)
            # a second pool with other content in every block
            other = [f.roll(1, 0) for f in fields]
            unused = torch.ones(fields[0].shape[0], dtype=torch.bool,
                                device=dev)
            unused[blk.long()] = False
            for mode in bc.MODES:
                for in_place in (True, False):
                    src = [f.clone() for f in fields]
                    out = None if in_place else [f.clone() for f in other]
                    ref_out = None if in_place else [f.clone() for f in other]
                    got = bc.block_copy(src, blk, points, out=out, mode=mode,
                                        k=k)
                    ref = bc.block_copy_reference(
                        [f.clone() for f in fields], blk, points,
                        out=ref_out, mode=mode, k=k)
                    torch.cuda.synchronize()
                    where = (f"block_copy[{name}] {mode} {dtype} "
                             f"{'in place' if in_place else 'out of place'}")
                    max_err = max(max_err, max_abs_diff(got, ref))
                    if not all(same(a, b) for a, b in zip(got, ref)):
                        raise RuntimeError(f"{where}: differs from its plain "
                                           f"version")
                    if not all(same(a, b) for a, b in zip(src, fields)):
                        raise RuntimeError(f"{where}: the input changed")
                    if not in_place and not all(
                            same(a[unused], b[unused])
                            for a, b in zip(got, other)):
                        raise RuntimeError(f"{where}: a block outside blk "
                                           f"changed")
                    if not in_place and all(same(a, b)
                                            for a, b in zip(got, other)):
                        raise RuntimeError(f"{where}: nothing was copied")
            print(f"block_copy[{name}] N={n} P={COPY_P} {dtype}: "
                  f"{', '.join(bc.MODES)}, in place and out of place, "
                  f"bitwise equal")
    # no point operands, and one packed image of 4 * nx rows
    fields, blk, points = copy_inputs(COPY_N_RAGGED, torch.float32, 11)
    packed = torch.cat(fields[:3] + (fields[3].view(torch.float32),), dim=1)
    for label, src in (("no points", fields), ("packed image", (packed,))):
        got = bc.block_copy(src, blk, out=[torch.zeros_like(f) for f in src])
        ref = bc.block_copy_reference(src, blk,
                                      out=[torch.zeros_like(f) for f in src])
        torch.cuda.synchronize()
        max_err = max(max_err, max_abs_diff(got, ref))
        if not all(same(a, b) for a, b in zip(got, ref)):
            raise RuntimeError(f"block_copy[{label}]: differs from its "
                               f"plain version")
    print("block_copy: without point operands and on one packed image of "
          f"{packed.shape[1]} rows, bitwise equal; max_abs_err of all "
          f"comparisons {max_err:.3e}")

    timing = {}
    for tag, dtype in (("", torch.float32), ("_bf16", torch.bfloat16)):
        fields, blk, points = copy_inputs(COPY_N, dtype, 1)
        lblk = blk.long()
        kw = dict(k=k, patch_thickness=cfg.grid_patch_thickness,
                  gap_size=cfg.grid_gap_size)

        def library():
            for f in fields:
                f.index_copy_(0, lblk, f.index_select(0, lblk))

        ms, first, second = in_turns({
            "plain": lambda: bc.block_copy_reference(fields, blk, points,
                                                     mode="whole", k=k),
            "library": library,
            "whole": lambda: bc.block_copy(fields, blk, points, mode="whole",
                                           k=k),
            "plain_cells": lambda: bc.block_copy_reference(
                fields, blk, points, mode="cells", k=k),
            "cells": lambda: bc.block_copy(fields, blk, points, mode="cells",
                                           k=k),
            "points": lambda: bc.block_copy(fields, blk, points,
                                            mode="points", k=k),
            "merge": lambda: bm.block_merge(*fields, None, blk, *points, 3,
                                            **kw),
        }, dict(plain=10, library=10, whole=20, plain_cells=10, cells=50,
                points=50, merge=50))
        b_whole = bound(block_copy_bytes(fields, blk, points, "whole"))
        b_cells = bound(block_copy_bytes(fields, blk, points, "cells"))
        # the same rows unsorted: the same bytes must move
        b_points = bound(block_copy_bytes(fields, blk, points, "points"))
        spread = ", ".join(f"{name} {first[name]:.4f}/{second[name]:.4f}"
                           for name in ms)
        print(f"block_copy[bench] {dtype} calls (events around the "
              f"wrappers): whole {ms['whole']:.4f} ms (plain "
              f"{ms['plain']:.4f}, library {ms['library']:.4f}), cells "
              f"{ms['cells']:.4f} ms (plain {ms['plain_cells']:.4f}), the "
              f"same rows unsorted (points) {ms['points']:.4f} ms, merge "
              f"{ms['merge']:.4f} ms [{spread}]")
        # the card's own times: raw launches in a CUDA graph, then the
        # profiler's reading of each kernel by its name
        launches = {mode: (lambda mode=mode: bc.launch(
            fields, blk, points, fields, mode=mode, k=k)) for mode in bc.MODES}
        launches["merge"] = lambda: bm.launch(*fields, None, blk, *points, 3,
                                              **kw)
        dev_ms = {name: profiling.device_time(f, COPY_GRAPH_REPS) * 1e3
                  for name, f in launches.items()}
        prof_ms = {name: profiling.profiler_kernel_time(
            f, "block_merge_kernel" if name == "merge"
            else f"block_copy_{name}_kernel") * 1e3
            for name, f in launches.items()}
        # the plain versions and the library call on the card: all their
        # kernels, summed by the profiler
        dev_ms.update(
            plain=device_ms_of(lambda: bc.block_copy_reference(
                fields, blk, points, mode="whole", k=k)),
            plain_cells=device_ms_of(lambda: bc.block_copy_reference(
                fields, blk, points, mode="cells", k=k)),
            library=device_ms_of(library))
        timing[tag] = dict(call=ms, device=dev_ms, profiler=prof_ms,
                           bound_whole=b_whole, bound_cells=b_cells,
                           bound_points=b_points)
        print(f"block_copy[bench] {dtype} device (graph of "
              f"{COPY_GRAPH_REPS} launches / profiler): whole "
              f"{dev_ms['whole']:.4f} / {prof_ms['whole']:.4f} ms (bound "
              f"{b_whole[0]:.4f} ms by {b_whole[1]}; plain "
              f"{dev_ms['plain']:.4f}, library {dev_ms['library']:.4f} ms on "
              f"the card), cells "
              f"{dev_ms['cells']:.4f} / {prof_ms['cells']:.4f} ms (bound "
              f"{b_cells[0]:.5f} ms; plain {dev_ms['plain_cells']:.4f}), "
              f"points {dev_ms['points']:.4f} / "
              f"{prof_ms['points']:.4f} ms (bound {b_points[0]:.5f} ms), "
              f"merge {dev_ms['merge']:.4f} / {prof_ms['merge']:.4f} ms; "
              f"cells / merge {dev_ms['cells'] / dev_ms['merge']:.3f}, "
              f"points / merge {dev_ms['points'] / dev_ms['merge']:.3f}")
        if dev_ms["whole"] < b_whole[0]:
            raise RuntimeError(
                f"block_copy whole mode took {dev_ms['whole']} ms, less than "
                f"the card needs for its bytes ({b_whole[0]} ms): the loads "
                f"or stores are gone")
    return max_err, timing


def compare_pool_dtypes(dev, cfg):
    """K2 and K3 on the float32 pool of phase 5 and on the same pool
    rounded to bfloat16, same queries and merge operands, timed in turns
    within one phase (two phases of a run may find the card in different
    states).  Returns ``{name: ms}``."""
    from slam_eslam_tpu_torch.mapping import map_pool as mp
    from slam_eslam_tpu_torch.models import sim
    from slam_eslam_tpu_torch.ops import block_merge as bm
    from slam_eslam_tpu_torch.ops import chain_lookup as cl

    fns, keep = {}, []
    kw = dict(patch_thickness=cfg.grid_patch_thickness,
              gap_size=cfg.grid_gap_size)
    for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        pool = sim.random_pool(SLAM_N, cfg.map_pool_blocks, **SLAM_POOL,
                               seed=3, device=dev, dtype=dtype)
        queries = sim.chain_queries(pool, SLAM_C, seed=5)
        ops = mp.merge_operands(pool, *sim.poses_on_heads(pool, 3.0, seed=7),
                                bench_cloud(dev))
        keep.append((pool, queries, ops))
        fns[f"chain_lookup_{tag}"] = (
            lambda pool=pool, queries=queries: cl.chain_lookup(
                pool.mean, pool.stdev, pool.meta, pool.origin,
                pool.resolution, pool.chain, queries, k=pool.k,
                z_window=cfg.mls_z_window))
        fns[f"block_merge_{tag}"] = (
            lambda pool=pool, ops=ops: bm.block_merge(
                pool.mean, pool.stdev, pool.height, pool.meta, None, *ops, 7,
                k=pool.k, **kw))
    ms, first, second = in_turns(fns, dict.fromkeys(fns, 50))
    print("pool storage, in turns: " + ", ".join(
        f"{name} {ms[name]:.4f} ms ({first[name]:.4f}, {second[name]:.4f})"
        for name in fns))
    return ms


def check_big_kernels(dev, cfg):
    """K2 and K3 against their plain versions at the shape the
    100,000-particle run gives them: a bfloat16 pool of 400,000 blocks of
    40x40x4 slots (25.6 GB), whose element offsets pass 2^31 from block
    335,545 on.  K2 bit for bit; K3 in place on the pool against the
    plain version on a copy of it, compared 25,000 blocks at a time over
    the whole pool: meta equal, fields bitwise equal outside cells that
    several points hit (so every block outside ``blk`` too) and within
    one bfloat16 step inside them.  Both timed against their plain
    versions.  Returns ``((max_abs_err, timing), (max_abs_err,
    timing))``."""
    from slam_eslam_tpu_torch.mapping import map_pool as mp
    from slam_eslam_tpu_torch.models import sim
    from slam_eslam_tpu_torch.ops import block_copy as bc
    from slam_eslam_tpu_torch.ops import block_merge as bm
    from slam_eslam_tpu_torch.ops import chain_lookup as cl

    torch.cuda.reset_peak_memory_stats()
    pool = sim.random_pool(BIG_N, 4 * BIG_N, **SLAM_POOL, seed=13, device=dev,
                           dtype=torch.bfloat16, parts=BIG_PARTS)
    per_block = pool.nx * pool.ny * pool.k
    far = INT32_ELEMENTS // per_block + 1   # blocks from here lie past 2^31
    far_heads = pool.active() >= far
    far_tails = int((pool.chain[:, 1:] >= far).sum())
    print(f"100k pool: {pool.b} blocks of {pool.nx}x{pool.ny}x{pool.k} "
          f"bfloat16, {pool.storage_bytes() / 1e9:.2f} GB; "
          f"{int(far_heads.sum())} heads and {far_tails} chain tails at "
          f"block {far} or above (element offsets past 2^31)")
    if not (int(far_heads.sum()) and far_tails):
        raise RuntimeError("100k pool: no chain entry past 2^31 elements")

    # K2
    queries = sim.chain_queries(pool, SLAM_C, seed=5)
    args = (pool.mean, pool.stdev, pool.meta, pool.origin, pool.resolution,
            pool.chain, queries)
    kw = dict(k=pool.k, z_window=cfg.mls_z_window)
    got = cl.chain_lookup(*args, **kw)
    ref = cl.chain_lookup_reference(*args, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, ref)):
        bad = int((got[0] != ref[0]).sum())
        raise RuntimeError(f"chain_lookup[100k]: differs from its plain "
                           f"version ({bad} found flags)")
    found_far = float(got[0][far_heads].float().mean())
    if not found_far > 0:
        raise RuntimeError("chain_lookup[100k]: no hit past 2^31 elements")
    k2_err = max_abs_diff(got[1:], ref[1:])
    print(f"chain_lookup[100k] N={BIG_N} C={SLAM_C} L={pool.chain.shape[1]}: "
          f"bitwise equal, found {float(got[0].float().mean()):.4f} "
          f"({found_far:.4f} for heads past 2^31)")
    k2 = (k2_err, kernel_times(
        "chain_lookup[100k]", lambda: cl.chain_lookup(*args, **kw),
        lambda: cl.launch(*args, got, **kw), "chain_lookup_kernel",
        lambda: cl.chain_lookup_reference(*args, **kw),
        bound(chain_lookup_bytes(pool, pool.chain, queries,
                                 cfg.mls_z_window)),
        n_call=20, n_plain=3, reps=BIG_GRAPH_REPS))
    del got, ref, args

    # K3
    ops = mp.merge_operands(pool, *sim.poses_on_heads(pool, 3.0, seed=7),
                            bench_cloud(dev))
    blk, lx, ly = ops[:3]
    kw = dict(k=pool.k, patch_thickness=cfg.grid_patch_thickness,
              gap_size=cfg.grid_gap_size)
    kern = [pool.mean, pool.stdev, pool.height, pool.meta]
    plain = [f.clone() for f in kern]
    far_meta = pool.meta[far:].clone()
    bm.block_merge(*kern, None, *ops, 7, **kw)
    bm.block_merge_reference(*plain, None, *ops, 7, **kw)
    torch.cuda.synchronize()
    far_written = int((kern[3][far:] != far_meta).sum())
    if not far_written:
        raise RuntimeError("block_merge[100k]: nothing written past 2^31 "
                           "elements")
    del far_meta
    hits = torch.zeros(pool.b * pool.nx * pool.ny, dtype=torch.int32,
                       device=dev)
    rows = bc.hit_rows(blk, lx, ly, pool.b, pool.nx, pool.ny)
    hits.index_add_(0, rows, torch.ones_like(rows, dtype=torch.int32))
    hits = hits.reshape(pool.b, pool.nx, pool.ny, 1)
    k3_err, multi_cells = 0.0, int((hits > 1).sum())
    step = pool.b // BIG_PARTS
    for lo in range(0, pool.b, step):
        part = slice(lo, lo + step)
        if not torch.equal(kern[3][part], plain[3][part]):
            raise RuntimeError(f"block_merge[100k]: meta differs in blocks "
                               f"{lo}..{lo + step}")
        multi = (hits[part] > 1).expand(-1, -1, -1, pool.k).reshape(
            kern[0][part].shape)
        for fname, a, b in zip(("mean", "stdev", "height"), kern, plain):
            steps = bf16_steps(a[part], b[part])
            if int(steps.max()) > 1 or int((steps * ~multi).max()) > 0:
                raise RuntimeError(
                    f"block_merge[100k] {fname}: blocks {lo}..{lo + step} "
                    f"differ from the plain version outside tolerance")
            k3_err = max(k3_err, float(
                (a[part].float() - b[part].float()).abs().max()))
            del steps
    print(f"block_merge[100k] N={BIG_N} P={lx.shape[1]}: meta equal over "
          f"{pool.b} blocks, fields bitwise equal outside the "
          f"{multi_cells} multi-point cells and within one bfloat16 step "
          f"inside, max_abs_err={k3_err:.3e}; {far_written} slots written "
          f"past 2^31 elements")
    k3 = kernel_times(
        "block_merge[100k]",
        lambda: bm.block_merge(*kern, None, *ops, 7, **kw),
        lambda: bm.launch(*kern, None, *ops, 7, **kw), "block_merge_kernel",
        lambda: bm.block_merge_reference(*plain, None, *ops, 7, **kw),
        bound(*block_merge_bytes(pool, blk, lx, ly)),
        n_call=20, n_plain=3, reps=BIG_GRAPH_REPS)
    print(f"100k pool: peak allocated in this check "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return k2, (k3_err, k3)


def run_bench(argv, label):
    """``slam_eslam_tpu_torch.bench.main(argv)`` in process with every
    launch count at 0 before; returns ``(result, detail, launch counts,
    seconds)``."""
    from slam_eslam_tpu_torch import bench, ops

    detail = {}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    print(f"bench[{label}]: bench {' '.join(argv)}")
    sys.stdout.flush()
    result = bench.main(list(argv), detail)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return result, detail, ops.launch_counts(), seconds


def expect(cond, label, message):
    if not cond:
        raise RuntimeError(f"bench[{label}]: {message}")


def expect_launches(launches, want, label):
    """Launch counts are what the gates predict (they count only on the
    card)."""
    if launches != want:
        raise RuntimeError(f"{label}: launches {launches}, want {want}")


def bench_filter_runs(card):
    """Filter mode at its defaults, then with ``--fold off``."""
    from slam_eslam_tpu_torch.ops import block_copy

    from slam_eslam_tpu_torch.utils import profiling

    # the fold roofline: the wrapper once, then the warm-up and the
    # captured launches of its CUDA graph
    repeats, roofline_iters = 3, (1 + profiling.DEVICE_TIME_WARMUP
                                  + profiling.DEVICE_TIME_REPS)
    result, detail, launches, secs = run_bench([], "filter")
    runs = STEPS * (1 + repeats)
    for key in ("merge_dma_floor_fraction", "merge_us_per_block",
                "merge_unsorted_twin_us_per_block", "fold_kernel_us", "fold_roofline_fraction", "copy_gbps",
                "sol_fraction", "ns_per_query"):
        expect(result[key] is not None and np.isfinite(result[key])
               and result[key] > 0, "filter", f"{key} is {result[key]}")
    expect(result["metric"] == "particle_updates_per_sec_per_chip"
           and result["card"] == card and result["fold_mfu"] is None
           and result["fold_tier"] == [GRID["nx"], GRID["ny"]], "filter",
           f"unexpected result {result}")
    expect(detail["fold"]["launches"] == roofline_iters
           and detail["fold"]["bound_by"] in ("bytes", "operations")
           and detail["fold"]["needed_instructions_per_query"] > 0, "filter",
           f"fold roofline {detail['fold']}")
    floor = detail["merge"]["floor_fraction"]
    expect(0 < floor <= FLOOR_FRACTION_MAX, "filter",
           f"merge floor fraction {floor}: the merge's twin (K7, cells "
           f"mode) must not take longer than the merge")
    want = dict.fromkeys(WRAPPERS, 0)
    expect(detail["run_launches"] == dict(want, contact_fold=runs), "filter",
           f"launches in the timed runs {detail['run_launches']}")
    merge_iters = (4 * 20 + 20) * (1 + 3)
    want.update(contact_fold=runs + roofline_iters, block_merge=merge_iters,
                block_copy=len(block_copy.MODES) * merge_iters)
    expect(launches == want, "filter", f"launches {launches}, want {want}")
    cents = detail["centroids"]
    expect(cents.shape == (STEPS, 3) and bool(torch.isfinite(cents).all())
           and bool(torch.isfinite(detail["state"].particles.weight).all()),
           "filter", "non-finite centroids or weights")
    print(f"bench[filter]: {result['value']} particle-updates/s, "
          f"sol_fraction {result['sol_fraction']}, K1 "
          f"{detail['fold']['us']:.2f} us on the card (a CUDA graph of raw "
          f"launches) against a bound of {detail['fold']['bound_us']:.2f} us "
          f"by {detail['fold']['bound_by']} (fraction "
          f"{detail['fold']['fraction']:.4f}); merge "
          f"{detail['merge']['merge_us_per_block'] * 1e3:.2f} ns/block, its "
          f"twin {detail['merge']['copy_us_per_block'] * 1e3:.2f} ns/block "
          f"(floor fraction {floor:.4f}), the twin unsorted "
          f"{detail['merge']['unsorted_us_per_block'] * 1e3:.2f} ns/block, "
          f"whole-block copy "
          f"{detail['merge']['whole_us_per_block'] * 1e3:.2f} ns/block = "
          f"{detail['merge']['copy_gbps']:.1f} GB/s; launches {launches}; "
          f"{secs:.1f} s [{card}]")
    out = dict(result=result, launches=launches, merge=detail["merge"],
               fold=detail["fold"])

    steps = 20
    result, detail, launches, secs = run_bench(
        ["--fold", "off", "--steps", str(steps)], "fold off")
    want = dict.fromkeys(WRAPPERS, 0)
    expect(detail["run_launches"] == dict(
        want, select_cells=steps * (1 + repeats)), "fold off",
        f"launches in the timed runs {detail['run_launches']}")
    expect(launches["select_cells"] == steps * (1 + repeats)
           and launches["contact_fold"] == roofline_iters, "fold off",
           f"launches {launches}")
    expect(bool(torch.isfinite(detail["centroids"]).all()), "fold off",
           "non-finite centroids")
    print(f"bench[fold off]: {result['value']} particle-updates/s over "
          f"{steps} steps; launches in the runs {detail['run_launches']} "
          f"(K1 only in its own roofline: {launches['contact_fold']}); "
          f"{secs:.1f} s [{card}]")
    out["fold_off"] = dict(result=result, launches=launches)
    return out


def bench_slam_run(card, n, steps, extra, label):
    """SLAM mode on a bfloat16 pool; every run starts from a fresh filter,
    so each fires the same gates."""
    import gc

    argv = slam_args(n, steps, "bfloat16", extra)
    repeats = int(extra[extra.index("--repeats") + 1]) if extra else 3
    torch.cuda.reset_peak_memory_stats()
    result, detail, launches, secs = run_bench(argv, label)
    peak = torch.cuda.max_memory_allocated()
    carry, aux = detail.pop("carry"), detail["aux"]
    pool = carry.pool
    expect(result["metric"] == "slam_frames_per_sec"
           and result["pool_dtype"] == "bfloat16" and result["card"] == card
           and pool.mean.dtype == torch.bfloat16 and pool.b == 4 * n
           and pool.n == n, label, f"unexpected result {result}")
    n_meas, n_map = int(aux["updated"].sum()), int(aux["mapped"].sum())
    want = dict.fromkeys(WRAPPERS, 0)
    want.update(chain_lookup=n_meas * (1 + repeats),
                block_merge=n_map * (1 + repeats))
    expect(launches == want and n_meas and n_map, label,
           f"launches {launches}, gates want {want}")
    patches, failed = check_slam_state(carry, aux, detail["frames"],
                                       f"bench[{label}]")
    expect(failed == 0 and patches == detail["patches"], label,
           f"alloc_failed {failed}, patches {patches}")
    gb = pool.storage_bytes() / 1e9
    print(f"bench[{label}]: {result['value']} frames/s at {n} particles "
          f"over {detail['frames']} frames ({n_meas} measurement, {n_map} "
          f"mapping); pool {pool.b} blocks of {pool.nx}x{pool.ny}x{pool.k} "
          f"bfloat16 = {gb:.2f} GB, peak allocated {peak / 1e9:.2f} GB; "
          f"launches {launches}; patches {patches}, alloc_failed {failed}; "
          f"{secs:.1f} s [{card}]")
    del carry, pool, detail
    gc.collect()
    torch.cuda.empty_cache()
    return dict(result=result, launches=launches, peak=peak, patches=patches,
                n_meas=n_meas, n_map=n_map, pool_gb=gb)


def bf16_path(dev):
    """60 frames at 4,096 particles on a bfloat16 pool: the card against
    the CPU port, and against the float32 pool on the card, on identical
    draws."""
    from slam_eslam_tpu_torch import bench
    from slam_eslam_tpu_torch.filter import streaming
    from slam_eslam_tpu_torch.utils import tree

    cfg16, cfg32 = slam_config("bfloat16"), slam_config()
    z0, frames, full, qs = slam_setup()
    run = bench.make_slam_runner(cfg16)
    dev_err, cents16 = slam_compare(run, cfg16, z0, frames, full, qs, dev,
                                    "bfloat16 pool")
    sub = slice(0, SLAM_CHECK_FRAMES)
    normals, draws = slam_draws(SLAM_CHECK_FRAMES)
    odos = streaming.precompute_odometry(20, tree.to(full, dev), qs.to(dev),
                                         cfg=cfg32)
    carry, aux = run(slam_carry(cfg32, z0, dev, normals),
                     tree.to(frames, dev).at(sub), tree.index(odos, sub),
                     [tree.to(x, dev) for x in draws])
    if carry.pool.mean.dtype != torch.float32:
        raise RuntimeError("bfloat16 pool: the float32 run is not float32")
    diff = float((aux["centroid"] - cents16).abs().max())
    print(f"bfloat16 pool: against the float32 pool on the card over "
          f"{SLAM_CHECK_FRAMES} frames, largest centroid difference "
          f"{diff:.3e} m (no limit: a finding)")
    return dev_err, diff


# ---------------------------------------------------------------- phase 9

def check_merge_packed(dev):
    """P4 against its plain version and against K3 on the unpacked fields,
    at the merge probe's shape and operands; the three timed in turns.
    Returns ``(max_abs_err, the row's times)``."""
    from types import SimpleNamespace

    from slam_eslam_tpu_torch.ops import block_merge as bm
    from slam_eslam_tpu_torch.tools import probe_merge_overhead as probe
    from slam_eslam_tpu_torch.utils import kernel_eff, profiling

    n, p, nx, ny, k = (PROBE[key] for key in ("n", "p", "nx", "ny", "k"))
    fields, blk, points = kernel_eff.merge_benchmark_operands(
        n, p, nx, ny, k, dev)
    lx, ly = points[:2]
    shape = SimpleNamespace(b=fields[0].shape[0], nx=nx, ny=ny, k=k,
                            mean=fields[0])
    kw = dict(k=k, patch_thickness=0.1, gap_size=1.5)
    uidx = probe.UPDATE_IDX
    packed = bm.pack_fields(*fields)
    kern, plain = packed.clone(), packed.clone()
    unpacked = [f.clone() for f in fields]
    bm.block_merge_packed(kern, blk, *points, uidx, nx=nx, **kw)
    bm.block_merge_packed_reference(plain, blk, *points, uidx, nx=nx, **kw)
    bm.block_merge(*unpacked, None, blk, *points, uidx, **kw)
    torch.cuda.synchronize()
    got, ref = bm.packed_fields(kern, nx), bm.packed_fields(plain, nx)
    if not torch.equal(got[3], ref[3]):
        raise RuntimeError(f"block_merge_packed: meta rows differ in "
                           f"{int((got[3] != ref[3]).sum())} words")
    one = one_point_slots(shape, blk, lx, ly)
    max_err = 0.0
    for fname, a, b in zip(("mean", "stdev", "height"), got, ref):
        if not torch.equal(a[one], b[one]):
            raise RuntimeError(f"block_merge_packed {fname}: one-point cells "
                               f"not bitwise equal")
        outside = (a - b).abs() > (MERGE_HEIGHT_ATOL if fname == "height"
                                   else MERGE_RTOL * b.abs())
        if bool(outside.any()):
            raise RuntimeError(f"block_merge_packed {fname}: outside "
                               f"tolerance")
        max_err = max(max_err, float((a - b).abs().max()))
    for fname, a, b in zip(("mean", "stdev", "height", "meta"), got,
                           unpacked):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise RuntimeError(f"block_merge_packed {fname}: differs from "
                               f"the merge on the unpacked fields")
    idle = torch.ones(shape.b, dtype=torch.bool, device=dev)
    idle[blk.long()] = False
    if not torch.equal(kern.view(torch.int32)[idle],
                       packed.view(torch.int32)[idle]):
        raise RuntimeError("block_merge_packed: a block outside blk changed")
    written = int((got[3] != fields[3]).sum())
    if written <= n:
        raise RuntimeError(f"block_merge_packed: only {written} meta words "
                           f"written")
    print(f"block_merge_packed[probe] N={n} P={p} B={shape.b} image "
          f"[{4 * nx},{ny * k}] float32 ({packed.numel() * 4 / 1e6:.1f} MB): "
          f"{written} meta words written, meta equal, one-point cells "
          f"bitwise, max_abs_err={max_err:.3e}; equal bit for bit to "
          f"block_merge on the unpacked fields")
    ms, first, second = in_turns({
        "plain": lambda: bm.block_merge_packed_reference(
            plain, blk, *points, uidx, nx=nx, **kw),
        "unpacked": lambda: bm.block_merge(*unpacked, None, blk, *points,
                                           uidx, **kw),
        "packed": lambda: bm.block_merge_packed(kern, blk, *points, uidx,
                                                nx=nx, **kw),
    }, dict(plain=5, unpacked=50, packed=50))
    b_ms, b_by = bound(*block_merge_bytes(shape, blk, lx, ly))
    packed_launch = lambda: bm.launch_packed(kern, blk, *points, uidx, nx=nx,
                                             **kw)
    unpacked_launch = lambda: bm.launch(*unpacked, None, blk, *points, uidx,
                                        **kw)
    (d_unpacked, d_packed), runs = in_turns_device(unpacked_launch,
                                                   packed_launch)
    prof = profiling.profiler_kernel_time(packed_launch,
                                          "block_merge_kernel") * 1e3
    plain_ms = device_ms_of(lambda: bm.block_merge_packed_reference(
        plain, blk, *points, uidx, nx=nx, **kw))
    print(f"block_merge_packed[probe] device {d_packed:.5f} ms (graph of "
          f"{GRAPH_REPS} launches), {prof:.5f} ms (profiler), block_merge on "
          f"the unpacked fields {d_unpacked:.5f} ms (unpacked, packed, "
          f"packed, unpacked: {', '.join(f'{r:.5f}' for r in runs)}), packed "
          f"/ unpacked {d_packed / d_unpacked:.3f}; calls (events around the "
          f"wrappers) {ms['packed']:.4f} ms ({first['packed']:.4f}, "
          f"{second['packed']:.4f}) and {ms['unpacked']:.4f} ms "
          f"({first['unpacked']:.4f}, {second['unpacked']:.4f}), plain "
          f"{plain_ms:.4f} ms on the card, {ms['plain']:.4f} ms a call, bound "
          f"{b_ms:.5f} ms ({b_by})")
    return max_err, dict(
        ms=d_packed, device_ms=d_packed, device_ms_profiler=prof,
        call_ms=ms["packed"], plain_ms=plain_ms, plain_call_ms=ms["plain"],
        bound_ms=b_ms,
        bound_by=b_by, ms_unpacked_in_turns=d_unpacked,
        call_ms_unpacked_in_turns=ms["unpacked"])


def probe_run():
    """The merge probe in process, at its defaults, with every launch
    count at 0 before.  Returns ``(results, launch counts)``."""
    from slam_eslam_tpu_torch import ops
    from slam_eslam_tpu_torch.tools import probe_merge_overhead as probe

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    sys.stdout.flush()
    results = probe.main([])
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    if list(results) != list(probe.VARIANTS):
        raise RuntimeError(f"merge probe: variants {list(results)}")
    for name, r in results.items():
        if not (np.isfinite(r["ms"]) and r["ms"] > 0 and r["bound_ms"] > 0):
            raise RuntimeError(f"merge probe: {name} took {r['ms']} ms")
    cp = results["copy_packed"]
    if cp["ms"] < cp["bound_ms"]:
        raise RuntimeError(
            f"merge probe: copy_packed took {cp['ms']} ms, less than the "
            f"card needs for its bytes ({cp['bound_ms']} ms)")
    for g in probe.GROUPS:            # kernel K3, timed once
        if results[f"grouped{g}"]["ms"] != results["merge"]["ms"]:
            raise RuntimeError(f"merge probe: grouped{g} is not the merge")
    # _slope_time: chains of 4 * iters and of iters, a warm-up and three
    # repeats each
    per = (4 * 20 + 20) * (1 + 3)
    want = dict.fromkeys(WRAPPERS, 0)
    want.update(block_merge=per, block_copy=3 * per, block_merge_packed=per)
    expect_launches(launches, want, "merge probe")
    return results, launches


def map_labels(frame):
    """Per-wheel terrain labels, on every MAP_LABEL_PERIOD-th frame."""
    return app_labels(frame) if frame % MAP_LABEL_PERIOD == 3 else None


def map_config(**kw):
    """Phase 6's SLAM configuration with everything the mapping API has
    switched on: colours on a float32 pool, the scan match, negative
    information, the slip update, and a camera gate that lets every second
    image through."""
    from slam_eslam_tpu_torch import ContactModelConfig
    from slam_eslam_tpu_torch.config import UpdateThreshold

    return dataclasses.replace(
        slam_config(), map_pool_color=True, use_visual_update=True,
        grid_use_negative_information=True,
        mapping_camera_threshold=UpdateThreshold(MAP_CAMERA_DISTANCE,
                                                 np.pi / 6),
        contact_model=ContactModelConfig(
            contact_point_radius=0.0, min_contacts=2, use_slip_update=True),
        **kw)


def map_setup():
    """The SLAM benchmark's drive with all 20 contact points per frame
    (the application computes its own odometry), a textured 12x16 distance
    image beside every scan, the sensor mounts, and the start map: the
    drive's terrain painted with class colours, which also feeds the hash.
    Everything on the host."""
    from slam_eslam_tpu_torch import bench
    from slam_eslam_tpu_torch.examples.slam_demo import laser_mount
    from slam_eslam_tpu_torch.models import sim

    z0, frames, _, _ = bench.slam_trajectory(SLAM_STEPS, 0)
    n_frames = len(frames)
    h, w = MAP_IMAGE
    rng = np.random.default_rng(9)
    dimg = rng.uniform(0.8, 2.6, (n_frames, h, w)).astype(np.float32)
    dimg[:, 0, 0], dimg[:, 5, 7] = 0.0, 8.0       # invalid, too far
    # terrain classes as the image sees them: class 0 left, 1 in the
    # middle, 2 (which the start map has nowhere) on the right
    tex = np.zeros((h, w, 3), np.float32)
    tex[:, :w // 3, 0] = 1.0
    tex[:, w // 3:2 * w // 3, 1] = 1.0
    tex[:, 2 * w // 3:, 2] = 1.0
    frames = dataclasses.replace(
        frames, dimg=torch.from_numpy(dimg), has_dimg=frames.has_scan.clone(),
        host_has_dimg=frames.host_has_scan.copy(),
        timg=torch.from_numpy(
            np.broadcast_to(tex, (n_frames, h, w, 3)).copy()))
    # the camera of examples/full_demo.py: z forward, tilted 38 deg down
    rot_x = lambda a: np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                                [0, np.sin(a), np.cos(a)]])
    camera = (rot_x(-np.deg2rad(38.0)) @ np.array(
        [[1.0, 0, 0], [0, 0, 1], [0, -1, 0]]), np.array([0.0, 0.20, 0.25]))
    intrinsics = (0.09, 0.09, -0.09 * (w - 1) / 2, -0.09 * (h - 1) / 2)
    env = sim.terrain_grid(
        bench.slam_terrain, nx=SLAM_POOL["nx"], ny=SLAM_POOL["ny"],
        resolution=SLAM_POOL["resolution"], origin=(-5.0, -5.0),
        k=SLAM_POOL["k"], color=app_classes)
    return dict(z0=z0, frames=frames, laser=laser_mount(), camera=camera,
                intrinsics=intrinsics, env=env)


def map_filter(cfg, setup, dev, start):
    """A fresh per-particle filter on the start map with the surface hash,
    its particles set to the Gaussian cloud ``start``."""
    from slam_eslam_tpu_torch import SurfaceHashConfig
    from slam_eslam_tpu_torch.filter.eslam_filter import EmbodiedSlamFilter
    from slam_eslam_tpu_torch.utils import tree

    f = EmbodiedSlamFilter(config=cfg, device=dev).init(
        pose=(np.array([0.0, 0.0, setup["z0"]]), 0.0),
        shared_grid=setup["env"], use_shared_map=False,
        hash_config=SurfaceHashConfig(use_hash=True, period=MAP_HASH_PERIOD))
    f.state = dataclasses.replace(f.state, particles=dataclasses.replace(
        tree.to(start, dev), map_id=f.state.particles.map_id))
    return f


def map_draws(cfg, setup, n_frames):
    """A seeded Gaussian start cloud and, per frame, every draw of the
    loop: ``project``'s, the resampling uniforms and the hash's in-bucket
    draws on reinjection frames.  On the host."""
    from slam_eslam_tpu_torch import SurfaceHashConfig
    from slam_eslam_tpu_torch.filter import pose_estimator as pe
    from slam_eslam_tpu_torch.filter.step import StepDraws
    from slam_eslam_tpu_torch.filter.surface_hash import SurfaceHash

    n = cfg.particle_count
    gen = torch.Generator().manual_seed(4)
    start = pe.init_gaussian(
        n, (0.0, 0.0), 0.0, cfg.initial_translation_error[:2],
        cfg.initial_rotation_error[2], setup["z0"],
        cfg.initial_translation_error[2] + 1e-3, generator=gen)
    h = SurfaceHash.create(
        SurfaceHashConfig(use_hash=True, period=MAP_HASH_PERIOD),
        setup["env"])
    frames, draws = setup["frames"], []
    for i in range(n_frames):
        hash_u = None
        if (i + 1) % MAP_HASH_PERIOD == 0:
            fr = frames.at(i)
            count = int(h._at_bucket(h.bucket_count,
                                     h.bucket(*h.signature(fr.contact, fr.q))))
            hash_u = (torch.rand(n, generator=gen, dtype=torch.float64)
                      * max(count, 1)).long()
        draws.append(StepDraws(pe.ProjectDraws.sample(n, gen, "cpu"),
                               torch.rand(n, generator=gen), hash_u))
    return start, draws


def count_syncs(fn):
    """``fn()`` with host syncs reported as warnings; returns ``(result,
    number of syncs)``."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def map_drive(f, setup, n_frames, labels=None, draws=None, spans=None):
    """The application's loop over the first ``n_frames`` frames (already
    on the filter's device): ``update_contact`` on every frame, host syncs
    forbidden; on a scan frame ``update_scan`` and then
    ``update_distance_image`` with the texture, their host syncs counted.
    ``spans`` collects ``(call, host ms, CUDA events)`` of every mapping
    call.  Returns the gates, the centroids ``[T, 3]`` and the set of
    host-sync counts of the mapping calls whose gate fired."""
    from slam_eslam_tpu_torch.filter.eslam_filter import ContactDraws
    from slam_eslam_tpu_torch.mapping import projection

    frames = setup["frames_on"][f.device.type]
    cuda = f.device.type == "cuda"
    consts = [torch.as_tensor(v, dtype=torch.float32, device=f.device)
              for v in setup["intrinsics"]]
    gates = {"updated": [], "mapped": [], "cam_mapped": []}
    cents, sync_counts = [], set()

    def timed(name, fn):
        if spans is None or not cuda:
            return count_syncs(fn) if cuda else (fn(), 0)
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        t0 = time.perf_counter()
        out, syncs = count_syncs(fn)
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[1].record()
        spans.append((name, out, host_ms, *ev))
        return out, syncs

    for i in range(n_frames):
        fr = frames.at(i)
        pose = (fr.host_q, fr.host_body_pos.astype(np.float64))
        d = None if draws is None else ContactDraws(
            draws[i].project, draws[i].resample_u, draws[i].hash_u)
        if cuda:
            torch.cuda.set_sync_debug_mode("error")
        try:
            gates["updated"].append(f.update_contact(
                pose, fr.contact, None if labels is None else labels(i),
                draws=d, orientation=fr.q))
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode("default")
        mapped = cam = False
        if bool(fr.host_has_scan):
            scan = projection.LaserScan(fr.ranges, fr.start_angle,
                                        fr.angular_resolution)
            mapped, syncs = timed("update_scan", lambda: f.update_scan(
                pose, scan, setup["laser"], orientation=fr.q))
            sync_counts.add(syncs if mapped else 1)
            image = projection.DistanceImage(fr.dimg, *consts)
            cam, syncs = timed(
                "update_distance_image", lambda: f.update_distance_image(
                    pose, image, setup["camera"], texture=fr.timg,
                    orientation=fr.q))
            sync_counts.add(syncs if cam else 1)
        gates["mapped"].append(mapped)
        gates["cam_mapped"].append(cam)
        cents.append(f.get_centroid()[0])
    return ({k: np.array(v, bool) for k, v in gates.items()},
            torch.stack(cents), sync_counts)


def check_map_state(f, cents, label):
    """Finite centroids, weights and pool; some valid patch carries the
    texture's third class, which the start map has nowhere.  Returns the
    patch count."""
    pool = f.pool
    if not (bool(torch.isfinite(cents).all())
            and bool(torch.isfinite(f.state.particles.weight).all())
            and all(bool(torch.isfinite(getattr(pool, name)).all())
                    for name in ("mean", "stdev", "height", "color"))):
        raise RuntimeError(f"{label}: non-finite centroids, weights or pool")
    valid = (pool.meta & 1).bool()
    textured = int((valid & (pool.color.reshape(
        pool.meta.shape + (3,))[..., 2] > 0.5)).sum())
    if not textured:
        raise RuntimeError(f"{label}: no patch carries the texture's colour")
    return int(pool.count_valid()), textured


def map_pass(cfg, setup, dev, start, card, number):
    """One timed pass of the application's loop over all frames from a
    fresh filter, labels included, as ``examples.slam_demo`` drives it:
    launch counts against the gates, one host sync per mapping update,
    the map's state.  Returns the pass's numbers."""
    from slam_eslam_tpu_torch import ops

    n_frames = len(setup["frames"])
    f = map_filter(cfg, setup, dev, start)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    spans = []
    t0 = time.perf_counter()
    gates, cents, sync_counts = map_drive(f, setup, n_frames,
                                          labels=map_labels, spans=spans)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = ops.launch_counts()
    n_meas, n_map, n_cam = (int(gates[k].sum())
                            for k in ("updated", "mapped", "cam_mapped"))
    want = dict.fromkeys(WRAPPERS, 0)
    want.update(chain_lookup=n_meas + n_map, block_merge=n_map + n_cam)
    labelled = sum(map_labels(i) is not None for i in range(n_frames))
    expect_launches(launches, want, "mapping path")
    if n_meas < labelled or n_map != SLAM_STEPS or not 1 < n_cam < n_map:
        raise RuntimeError(f"mapping path: {n_meas} measurement updates, "
                           f"{n_map} laser and {n_cam} camera merges")
    if sync_counts != {1}:
        raise RuntimeError(f"mapping path: {sorted(sync_counts)} host syncs "
                           f"in a mapping update (each makes one, the read "
                           f"of the pool's failure count)")
    if f.update_idx != n_map + n_cam or f.steps != n_frames:
        raise RuntimeError(f"mapping path: update_idx {f.update_idx}, steps "
                           f"{f.steps}")
    patches, textured = check_map_state(f, cents, "mapping path")

    def mean_ms(name, which):
        ms = [which(s) for s in spans if s[0] == name and s[1]]
        return sum(ms) / max(len(ms), 1)

    host = lambda s: s[2]
    device = lambda s: s[3].elapsed_time(s[4])
    reinjected = sum(1 for i, g in enumerate(gates["updated"])
                     if g and (i + 1) % MAP_HASH_PERIOD == 0)
    out = dict(
        elapsed=elapsed, frames=n_frames, launches=launches, n_meas=n_meas,
        n_map=n_map, n_cam=n_cam, patches=patches,
        scan_ms=mean_ms("update_scan", host),
        scan_device_ms=mean_ms("update_scan", device),
        image_ms=mean_ms("update_distance_image", host),
        image_device_ms=mean_ms("update_distance_image", device))
    print(f"mapping path[pass {number}]: {n_frames} frames x {SLAM_N} "
          f"particles in {elapsed:.4f} s = {n_frames / elapsed:.2f} frames/s; "
          f"{n_meas} measurement updates ({labelled} frames with terrain "
          f"labels, {reinjected} hash reinjections), {n_map} laser and "
          f"{n_cam} camera merges; update_scan {out['scan_ms']:.4f} ms on "
          f"the host "
          f"({out['scan_device_ms']:.4f} ms by CUDA events), "
          f"update_distance_image {out['image_ms']:.4f} ms "
          f"({out['image_device_ms']:.4f} ms); one host sync per mapping "
          f"update; launches {launches}; pool "
          f"{f.pool.storage_bytes() / 1e9:.3f} GB, patches {patches}, "
          f"{textured} with the texture's colour [{card}]")
    return out


def map_app_path(dev, card, profile=None):
    from slam_eslam_tpu_torch.config import UpdateThreshold
    from slam_eslam_tpu_torch.utils import tree

    cfg = map_config()
    setup = map_setup()
    setup["frames_on"] = {"cpu": setup["frames"],
                          "cuda": tree.to(setup["frames"], dev)}
    start, draws = map_draws(cfg, setup, MAP_CHECK_FRAMES)

    # ---- the loop as examples.slam_demo drives it, labels included ----
    map_drive(map_filter(cfg, setup, dev, start), setup, MAP_WARM_FRAMES,
              labels=map_labels)                                # warm-up
    # several passes from the same start: host-bound rates spread, so the
    # range is what one run can say
    passes = [map_pass(cfg, setup, dev, start, card, number)
              for number in range(MAP_PASSES)]
    out = dict(passes[0], rates=[o["frames"] / o["elapsed"] for o in passes],
               scan_ms_range=[o["scan_ms"] for o in passes],
               image_ms_range=[o["image_ms"] for o in passes])

    # ---- run_stream against the same frames call by call: a gate that
    # fires on every frame (the stream carries no terrain labels, and it
    # reinjects on every period-th frame where the calls reinject only
    # after a measurement update), identical draws ----
    every = dataclasses.replace(cfg, measurement_threshold=UpdateThreshold(
        0.002, cfg.measurement_threshold.angle))
    draws_d = [tree.to(d, dev) for d in draws]
    host_f = map_filter(every, setup, dev, start)
    g_host, c_host, _ = map_drive(host_f, setup, MAP_CHECK_FRAMES,
                                  draws=draws_d)
    stream_f = map_filter(every, setup, dev, start)
    sub = setup["frames_on"]["cuda"].at(slice(0, MAP_CHECK_FRAMES))
    aux, syncs = count_syncs(lambda: stream_f.run_stream(
        sub, laser2body=setup["laser"], camera2body=setup["camera"],
        camera_intrinsics=setup["intrinsics"], camera_texture=True,
        draws=draws_d))
    if syncs > 1:
        raise RuntimeError(f"run_stream: {syncs} host syncs (one is allowed, "
                           f"the read of the stream's failure count)")
    for name in g_host:
        if not (aux[name] == g_host[name]).all():
            raise RuntimeError(f"run_stream: {name} gates differ from the "
                               f"calls'")
    if not g_host["updated"].all():
        raise RuntimeError("run_stream: the measurement gate did not fire on "
                           "every frame")
    diff = float((aux["centroid"] - c_host).abs().max())
    p_host, p_stream = (int(x.pool.count_valid()) for x in (host_f, stream_f))
    print(f"run_stream: {MAP_CHECK_FRAMES} frames ({int(aux['mapped'].sum())} "
          f"laser, {int(aux['cam_mapped'].sum())} camera merges, "
          f"{MAP_CHECK_FRAMES // MAP_HASH_PERIOD} reinjections) against the "
          f"same frames call by call: max centroid difference {diff:.3e} m, "
          f"patches {p_stream} vs {p_host}, alloc_failed_total "
          f"{int(aux['alloc_failed_total'])}")
    if not diff <= STREAM_ATOL or p_host != p_stream or (
            stream_f.update_idx != host_f.update_idx):
        raise RuntimeError(f"run_stream differs from the calls: centroids by "
                           f"{diff} m, patches {p_stream} vs {p_host}")
    out.update(stream_diff=diff)
    del host_f, stream_f

    # ---- the card against the CPU port, labels included ----
    res = {}
    for d in ("cpu", dev):
        fd = map_filter(cfg, setup, d, start)
        g, c, _ = map_drive(fd, setup, MAP_CHECK_FRAMES, labels=map_labels,
                            draws=draws if d == "cpu" else draws_d)
        res[str(d)] = (g, c.cpu(), int(fd.pool.count_valid()))
        del fd
    (g_cpu, c_cpu, p_cpu), (g_gpu, c_gpu, p_gpu) = res["cpu"], res[str(dev)]
    if any((g_cpu[k] != g_gpu[k]).any() for k in g_cpu):
        raise RuntimeError("mapping path: GPU and CPU gates differ")
    dev_err = float((c_gpu - c_cpu).abs().max())
    print(f"mapping path: GPU vs CPU port over {MAP_CHECK_FRAMES} frames, "
          f"max centroid difference {dev_err:.3e} m, patches {p_gpu} vs "
          f"{p_cpu}")
    if not dev_err <= CENTROID_ATOL:
        raise RuntimeError(f"mapping path: GPU and CPU centroids differ by "
                           f"{dev_err} m")
    if abs(p_gpu - p_cpu) > PATCH_COUNT_RTOL * p_cpu:
        raise RuntimeError(f"mapping path: patch counts {p_gpu} (GPU) and "
                           f"{p_cpu} (CPU) differ")
    out.update(dev_err=dev_err)
    if profile:
        profile_map(cfg, setup, dev, start, Path(profile))
    return out


def shared_camera_merge(dev, card):
    """``update_distance_image`` in shared-map mode at 100,000 particles.
    The shared 400x400 map starts with a hole (no patches) around the
    robot.  One filter merges a textured image of the ground under the
    robot, under its centroid pose: the camera fills the hole with new
    patches.  Its twin merges the same image through a mount
    ``SHARED_FAR`` m to the side, onto terrain no contact reaches.  At the
    next measurement update only the first filter's contacts find
    patches, and its weights differ from the twin's."""
    from slam_eslam_tpu_torch import ops
    from slam_eslam_tpu_torch.mapping import projection
    from slam_eslam_tpu_torch.models import sim
    from slam_eslam_tpu_torch.utils import tree

    cfg = dataclasses.replace(app_config(), log_debug=False)
    z0, poses, css, qs = app_setup()
    css_d, qs_d = tree.to(css, dev), qs.to(dev)
    grid = sim.terrain_grid(bench_terrain, **GRID)
    res, (ox, oy) = GRID["resolution"], GRID["origin"]
    x0, y0 = poses[0][1][:2]
    lo = lambda c, o: max(int((c - SHARED_HOLE - o) / res), 0)
    hi = lambda c, o: int((c + SHARED_HOLE - o) / res) + 1
    hole = np.zeros((GRID["nx"], GRID["ny"]), bool)
    hole[lo(x0, ox):hi(x0, ox), lo(y0, oy):hi(y0, oy)] = True
    grid_d = tree.to(dataclasses.replace(
        grid, valid=grid.valid & ~torch.from_numpy(hole)[..., None]), dev)
    # a camera 0.25 m above the body that looks straight down, and the
    # same camera on a boom SHARED_FAR m to the side
    h, w = MAP_IMAGE
    down = np.diag([1.0, -1.0, -1.0])
    mounts = {"seen": (down, np.array([0.0, 0.0, 0.25])),
              "twin": (down, np.array([0.0, SHARED_FAR, 0.25]))}
    intrinsics = [torch.tensor(v, dtype=torch.float32, device=dev)
                  for v in (0.09, 0.09, -0.09 * (w - 1) / 2,
                            -0.09 * (h - 1) / 2)]

    def image_at(position):
        """A level surface at the terrain's height under the robot."""
        ground = float(bench_terrain(position[0], position[1]))
        return projection.DistanceImage(torch.full(
            (h, w), 0.25 + float(position[2]) - ground, device=dev),
            *intrinsics)

    texture = torch.full((h, w, 3), 0.5, device=dev)
    filters = {name: app_filter(cfg, grid_d, z0, dev) for name in mounts}
    seen, twin = filters["seen"], filters["twin"]
    ops.reset_launch_counts()
    frame, merged_at, contacts = 0, None, {}
    while frame < 40:
        for f in filters.values():
            gate = f.update_contact(poses[frame], tree.index(css_d, frame),
                                    orientation=qs_d[frame])
        frame += 1
        if merged_at is None and gate:
            before = seen.shared_grid
            for name, f in filters.items():
                fired, syncs = count_syncs(lambda: f.update_distance_image(
                    poses[frame - 1], image_at(poses[frame - 1][1]),
                    mounts[name], texture=texture,
                    orientation=qs_d[frame - 1]))
                if not fired or f.update_idx != 1:
                    raise RuntimeError("shared camera merge: the gate did "
                                       "not fire")
            merged_at = frame
        elif merged_at is not None and gate:
            break
        contacts = {name: int(f.last_eval.n_contacts.sum())
                    for name, f in filters.items()}
    after = seen.shared_grid
    in_hole = torch.from_numpy(hole).to(dev)[..., None]
    new = int((after.valid & ~before.valid).sum())
    new_in_hole = int((after.valid & ~before.valid & in_hole).sum())
    coloured = int((after.valid & (after.color[..., 0] == 0.5)).sum())
    twin_in_hole = int((twin.shared_grid.valid & in_hole).sum())
    found = {name: int(f.last_eval.n_contacts.sum())
             for name, f in filters.items()}
    mean_w = 1.0 / N_BENCH
    dw = float((seen.state.particles.weight
                - twin.state.particles.weight).abs().max()) / mean_w
    launches = ops.launch_counts()
    print(f"shared camera merge: {N_BENCH} particles, image {h}x{w} merged "
          f"at frame {merged_at} into the {GRID['nx']}x{GRID['ny']} map: "
          f"{new} new patches ({new_in_hole} in the hole, {coloured} with "
          f"the texture's colour; the twin's merge {SHARED_FAR} m aside left "
          f"{twin_in_hole} there), {syncs} host syncs; contact groups found "
          f"before the merge {contacts}, at the measurement update of frame "
          f"{frame} {found}; weights differ from the twin's by up to {dw:.4f}"
          f" of the mean weight; contact_fold launches "
          f"{launches['contact_fold']} [{card}]")
    if not (new >= h * w // 2 and new_in_hole == new and coloured == new
            and twin_in_hole == 0):
        raise RuntimeError("shared camera merge: the image did not fill the "
                           "hole")
    if contacts != {"seen": 0, "twin": 0} or found["twin"] != 0 or (
            found["seen"] < N_BENCH // 2):
        raise RuntimeError("shared camera merge: the next measurement update "
                           "did not find the new patches")
    if not dw > SHARED_WEIGHT_FLOOR:
        raise RuntimeError(f"shared camera merge: weights differ by {dw} of "
                           f"the mean weight only")
    if not torch.isfinite(seen.state.particles.weight).all():
        raise RuntimeError("shared camera merge: non-finite weights")
    # two filters, a measurement update each at the first frame and at
    # the next frame whose gate fired
    want = dict.fromkeys(WRAPPERS, 0)
    want.update(contact_fold=4)
    expect_launches(launches, want, "shared camera merge")


def phase9(dev, card, profile=None):
    p4_err, p4 = check_merge_packed(dev)
    probe, probe_launches = probe_run()
    print(f"merge probe: merge {probe['merge']['ms']:.4f} ms, merge_packed "
          f"{probe['merge_packed']['ms']:.4f} ms, copy_packed "
          f"{probe['copy_packed']['ms']:.4f} ms (bound "
          f"{probe['copy_packed']['bound_ms']:.4f} ms); launches "
          f"{probe_launches} [{card}]")
    mapping = map_app_path(dev, card, profile)
    shared_camera_merge(dev, card)
    row = ("block_merge_packed", "tools/probe_merge_overhead.py:212",
           probe_launches["block_merge_packed"], p4_err, p4, None,
           {"probe_ms": probe["merge_packed"]["ms"],
            "probe_merge_ms": probe["merge"]["ms"],
            "probe_copy_packed_ms": probe["copy_packed"]["ms"]})
    return row, mapping


def profile_frames(fn, n_frames, label, out, stem):
    """``fn()`` under ``torch.profiler``: the table and the trace into
    ``out`` as ``<stem>_profile.txt`` and ``<stem>_trace.json``, and a line
    with the device's busy share and the launch calls per frame.  Returns
    what ``fn`` returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        result = fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    avg = prof.key_averages()
    # the kernels' own rows only: an operator's row repeats the time of
    # the kernels it launched
    device_us = sum(getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0))
                    for e in avg if e.device_type == DeviceType.CUDA)
    launch_calls = sum(e.count for e in avg
                       if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                    "cudaLaunchKernelExC"))
    table = avg.table(sort_by="cuda_time_total", row_limit=50)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{stem}_profile.txt").write_text(table)
    prof.export_chrome_trace(str(out / f"{stem}_trace.json"))
    print(f"{label} profile: {n_frames} frames in {wall:.4f} s traced, "
          f"device busy {device_us / 1e3:.3f} ms "
          f"({device_us / 1e4 / wall:.2f} %), "
          f"{launch_calls / n_frames:.1f} launch calls per frame")
    print(table[:6000])
    return result


def profile_app(cfg, hcfg, grid_d, z0, poses, frames, qs_l, dev, out):
    f = app_filter(cfg, grid_d, z0, dev, hcfg)
    gates = profile_frames(
        lambda: app_drive(f, poses, frames, qs_l, APP_PROFILE_FRAMES),
        APP_PROFILE_FRAMES, "application", out, "chip_smoke_app")
    print(f"application profile: {sum(gates)} measurement updates")


def profile_slam(run, cfg, z0, frames_d, odos, dev, out):
    from slam_eslam_tpu_torch.utils import tree

    carry = slam_carry(cfg, z0, dev)
    sub = slice(0, SLAM_PROFILE_FRAMES)
    profile_frames(lambda: run(carry, frames_d.at(sub), tree.index(odos, sub)),
                   SLAM_PROFILE_FRAMES, "SLAM", out, "chip_smoke_slam")


def profile_map(cfg, setup, dev, start, out):
    f = map_filter(cfg, setup, dev, start)
    gates, _, _ = profile_frames(
        lambda: map_drive(f, setup, SLAM_PROFILE_FRAMES, labels=map_labels),
        SLAM_PROFILE_FRAMES, "mapping", out, "chip_smoke_map")
    print("mapping profile: " + ", ".join(
        f"{int(g.sum())} {name}" for name, g in gates.items()))


def profile_steps(run, cfg, particles, css_d, qs_d, dev, out, steps=10):
    from torch.profiler import ProfilerActivity, profile

    from slam_eslam_tpu_torch.utils import tree

    state = fresh_state(cfg, particles, dev)
    sub = tree.index(css_d, slice(0, steps))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(state, sub, qs_d[:steps])
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    out.mkdir(parents=True, exist_ok=True)
    (out / "chip_smoke_profile.txt").write_text(table)
    prof.export_chrome_trace(str(out / "chip_smoke_trace.json"))
    print(table[:6000])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile the localisation, SLAM, application "
                         "and mapping paths into DIR")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA GPU: "
                         "torch.cuda.is_available() is False")
    from slam_eslam_tpu_torch import Config
    from slam_eslam_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = nvidia_smi()
    print(f"device: {kind}, count {torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(f"card: {card}")

    t0 = time.perf_counter()
    seconds = _build.load_all(KERNELS)
    print(f"build: {', '.join(f'{k} {v:.2f} s' for k, v in seconds.items())}"
          f" ({time.perf_counter() - t0:.2f} s in parallel)")
    for name in KERNELS:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    max_err, k1 = check_contact_fold(dev, Config())
    res = main_path(dev, args.profile)
    ms_step = res["elapsed"] / STEPS * 1e3
    print(f"main path: {ms_step:.4f} ms/step, "
          f"{N_BENCH * STEPS / res['elapsed']:.1f} particle-updates/s, "
          f"contact_fold {k1['device_ms'] * 1e3:.2f} us/step on the card "
          f"({k1['call_ms'] * 1e3:.2f} us per eager call, plain "
          f"{k1['plain_ms'] * 1e3:.2f} us), final-10 xy error "
          f"{res['final10']:.4f} m [{card}]")

    (k2_err, k2), (k3_err, k3) = check_slam_kernels(dev, slam_config())
    slam = slam_path(dev, args.profile)
    print(f"SLAM path: {slam['frames'] / slam['elapsed']:.2f} frames/s at "
          f"{SLAM_N} particles, {slam['elapsed'] / slam['frames'] * 1e3:.4f}"
          f" ms/frame; chain_lookup {k2['device_ms'] * 1e3:.2f} us (plain "
          f"{k2['plain_ms'] * 1e3:.2f} us), block_merge "
          f"{k3['device_ms'] * 1e3:.2f} us (plain "
          f"{k3['plain_ms'] * 1e3:.2f} us) [{card}]")

    k5_err, k5 = check_select_cells(dev, Config())
    app = app_path(dev, args.profile)
    print(f"application path: {APP_FRAMES / app['elapsed']:.2f} frames/s at "
          f"{N_BENCH} particles, {app['ms_meas']:.4f} ms per measurement "
          f"update ({app['n_meas']} updates); select_cells "
          f"{k5['device_ms'] * 1e3:.2f} us (plain "
          f"{k5['plain_ms'] * 1e3:.2f} us) [{card}]")

    # phase 8
    import gc

    k7_err, k7 = check_block_copy(dev, slam_config())
    (k2b_err, k2b), (k3b_err, k3b) = check_slam_kernels(
        dev, slam_config("bfloat16"), torch.bfloat16)
    print(f"bfloat16 pool: chain_lookup {k2b['device_ms'] * 1e3:.2f} us "
          f"(plain {k2b['plain_ms'] * 1e3:.2f} us, float32 pool "
          f"{k2['device_ms'] * 1e3:.2f} us), block_merge "
          f"{k3b['device_ms'] * 1e3:.2f} us (plain "
          f"{k3b['plain_ms'] * 1e3:.2f} us, float32 pool "
          f"{k3['device_ms'] * 1e3:.2f} us), max_abs_err {k2b_err:.3e} / "
          f"{k3b_err:.3e} [{card}]")
    by_dtype = compare_pool_dtypes(dev, slam_config())
    gc.collect()
    torch.cuda.empty_cache()
    drv = bench_filter_runs(card)
    drv["slam"] = bench_slam_run(card, SLAM_N, SLAM_STEPS, (), "slam bf16")
    bf16_err, bf16_diff = bf16_path(dev)
    gc.collect()
    torch.cuda.empty_cache()
    (k2c_err, k2c), (k3c_err, k3c) = check_big_kernels(
        dev, slam_config("bfloat16"))
    gc.collect()
    torch.cuda.empty_cache()
    drv["big"] = bench_slam_run(card, BIG_N, BIG_STEPS, ("--repeats", "1"),
                             "slam 100k bf16")
    print(f"bench: filter {drv['result']['value']} particle-updates/s; "
          f"SLAM bf16 {drv['slam']['result']['value']} frames/s at {SLAM_N} "
          f"and {drv['big']['result']['value']} frames/s at {BIG_N} "
          f"particles (pool {drv['big']['pool_gb']:.2f} GB, peak "
          f"{drv['big']['peak'] / 1e9:.2f} GB); bf16 vs CPU "
          f"{bf16_err:.3e} m, vs float32 {bf16_diff:.3e} m [{card}]")

    gc.collect()
    torch.cuda.empty_cache()
    p4_row, mapping = phase9(dev, card, args.profile)
    span = lambda xs, digits: f"{min(xs):.{digits}f}-{max(xs):.{digits}f}"
    print(f"mapping path: {span(mapping['rates'], 2)} frames/s over "
          f"{MAP_PASSES} passes at {SLAM_N} particles through "
          f"update_contact, update_scan "
          f"({span(mapping['scan_ms_range'], 4)} ms) and "
          f"update_distance_image ({span(mapping['image_ms_range'], 4)} ms); "
          f"run_stream "
          f"vs calls {mapping['stream_diff']:.3e} m, GPU vs CPU "
          f"{mapping['dev_err']:.3e} m [{card}]")

    f32c, bf16c = k7[""], k7["_bf16"]

    def other(times, tag):
        """A row's times at another storage type or shape, keys tagged."""
        return {f"{key}_{tag}": times[key]
                for key in ("ms", "device_ms_profiler", "call_ms",
                            "plain_ms", "bound_ms")}

    def pool_rows(name, f32, bf16, big, big_err, bf16_err):
        return {**other(bf16, "bf16"), "max_abs_err_bf16": bf16_err,
                "call_ms_in_turns": by_dtype[f"{name}_f32"],
                "call_ms_bf16_in_turns": by_dtype[f"{name}_bf16"],
                "launches_100k": drv["big"]["launches"][name],
                **other(big, "100k"), "max_abs_err_100k": big_err}

    rows = (
        ("contact_fold", "slam_eslam_tpu/ops/pallas_gather.py:578",
         res["launches"], max_err, k1, None, {}),
        ("chain_lookup", "slam_eslam_tpu/ops/pallas_chain.py:36",
         slam["launches"]["chain_lookup"], k2_err, k2, None,
         pool_rows("chain_lookup", k2, k2b, k2c, k2c_err, k2b_err)),
        ("block_merge", "slam_eslam_tpu/ops/pallas_merge.py:211",
         slam["launches"]["block_merge"], k3_err, k3, None,
         pool_rows("block_merge", k3, k3b, k3c, k3c_err, k3b_err)),
        ("select_cells", "slam_eslam_tpu/ops/pallas_gather.py:277",
         app["launches"]["select_cells"], k5_err, k5, None, {}),
        # whole-block mode (what the TPU kernel computes); the cells mode
        # (the merge's twin on this card) and the same rows unsorted
        # (points) beside it
        ("block_copy", "slam_eslam_tpu/utils/kernel_eff.py:177",
         drv["launches"]["block_copy"], k7_err,
         dict(ms=f32c["device"]["whole"], device_ms=f32c["device"]["whole"],
              device_ms_profiler=f32c["profiler"]["whole"],
              call_ms=f32c["call"]["whole"],
              plain_ms=f32c["device"]["plain"],
              plain_call_ms=f32c["call"]["plain"],
              bound_ms=f32c["bound_whole"][0],
              bound_by=f32c["bound_whole"][1]),
         f32c["device"]["library"],
         {"library_call_ms": f32c["call"]["library"],
          "ms_cells": f32c["device"]["cells"],
          "device_ms_profiler_cells": f32c["profiler"]["cells"],
          "call_ms_cells": f32c["call"]["cells"],
          "plain_ms_cells": f32c["device"]["plain_cells"],
          "plain_call_ms_cells": f32c["call"]["plain_cells"],
          "bound_ms_cells": f32c["bound_cells"][0],
          "ms_points": f32c["device"]["points"],
          "device_ms_profiler_points": f32c["profiler"]["points"],
          "call_ms_points": f32c["call"]["points"],
          "bound_ms_points": f32c["bound_points"][0],
          "merge_ms": f32c["device"]["merge"],
          "ms_bf16": bf16c["device"]["whole"],
          "call_ms_bf16": bf16c["call"]["whole"],
          "ms_cells_bf16": bf16c["device"]["cells"],
          "ms_points_bf16": bf16c["device"]["points"],
          "merge_ms_bf16": bf16c["device"]["merge"],
          "library_ms_bf16": bf16c["device"]["library"],
          "library_call_ms_bf16": bf16c["call"]["library"],
          "bound_ms_bf16": bf16c["bound_whole"][0]}),
        p4_row,
    )
    # block_merge_packed is the second entry point of block_merge's source
    source = lambda name: name.removesuffix("_packed")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"slam_eslam_tpu_torch/csrc/{source(name)}.cu",
        "replaces": replaces, "launches": launches, "max_abs_err": err,
        **times, "library_ms": library_ms, **more,
    } for (name, replaces, launches, err, times, library_ms, more)
        in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
