#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py [--profile DIR]
[--prior-scan CU]

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
   steps) through ``filter.step.make_scan_runner`` on the card twice from
   one state and one generator seed, as the eager loop (``graph=False``)
   and as CUDA graphs (``graph=True``: one step captured, replayed 150
   times), each with host syncs forbidden; count K1 and S1 launches in
   each (the graphed run's credited by its replays), print each run's
   ms per step and the host's kernel-launch and graph-launch calls per
   step (``torch.profiler``'s host records of 10 steps), hold the graphed
   run's centroids and every final-state tensor bit for bit to the eager
   run's, check the centroids, and hold the first 20 steps against the
   CPU port fed the same random draws;
5. check the chain lookup (K2) and the block merge (K3) against their
   plain versions at the SLAM benchmark shapes (N = 4,096 particles,
   C = 8 contacts, chains of 3, P = 64 scan points, a 16,384-block pool
   of 40x40x4 cells half full of patches, with empty chain entries) and
   at a ragged N; K3 also at P = 1, 192 (the camera image) and 2,048
   points against its plain version on the CPU, whose run sums go in point
   order as the kernel's do; and time both;
6. drive the SLAM path: 4,096 particles with per-particle maps over 200
   frames (20 laser scans) through ``filter.streaming.
   make_slam_scan_runner`` on the card, as the eager loop and as CUDA
   graphs (one per gate combination met, captured in the warm-up), from
   one state and one generator seed, each with host syncs forbidden;
   count K2, K3 and S1 launches against the measurement and mapping gates
   in each, print each run's ms per frame and host launch calls per frame
   (50 frames traced), hold the graphed run bit for bit to the eager one
   (centroids, best poses, the filter, every pool field with ``meta``, the
   chains, ``alloc_failed``), check that centroids, weights and the pool
   are finite, and hold the first 40 frames against the CPU port fed the
   same random draws;
7. check the unfolded lookup's select (K5) against its plain version,
   bit for bit, at 800,000 queries (100k particles x 8 contacts) on the
   400x400x4 grid, at a ragged count, on a spread cloud with out-of-grid
   queries, at Q = 1, 3, 5 and 800,001 and on views that start 4 bytes
   into a tensor, and time it on the card, back to back and with a cold
   L2; then drive the application API,
   ``EmbodiedSlamFilter.update_contact`` in shared-map mode with
   ``log_debug`` and the surface hash (global init, reinjection), at
   100k particles over the 150 frames of the localisation trajectory
   with host syncs forbidden in every call and the distribution exported
   every 50 frames, twice from one state and seed: eagerly and as CUDA
   graphs (``EmbodiedSlamFilter(graph=True)``: one graph per key of the
   call's host gates, captured at its second meeting); count K5 and S1
   launches in each (one per measurement update, K1 none; the graphed
   run's credited by its replays), print each run's ms per update and
   per other frame (CUDA events and the host clock around every call,
   the graphed run's replayed calls only) and the host's launch calls
   per frame (10 more frames traced), and hold the graphed run's gates,
   state, ``last_eval``, exports and generator bit for bit to the eager
   run's; run 20 frames with Chitta weighting and 20 with the slip
   update on terrain labels, and hold the first 20 frames against the
   CPU port fed the same random draws;
8. check the block copy (K7) against its plain version, bit for bit, at
   the merge benchmark's shape (N = 4,096 particles, P = 64 points,
   blocks of 40x128 slots, a pool of N + 64 blocks) and at a ragged N,
   on float32 and bfloat16 fields, whole blocks and hit cells (sorted
   as the merge visits them, and unsorted), in place and into a second
   pool, and time it beside its plain version, the library call and the
   block merge; check K2 and K3 on a pool stored in bfloat16 at phase
   5's shapes (K3's three other point counts included), and at the
   100,000-particle run's shape (a bfloat16 pool
   of 400,000 blocks, element offsets past 2^31); then run the benchmark
   ``slam_eslam_tpu_torch.bench`` in process: filter mode at its defaults
   (100k particles, 150 steps; K1 launches, the fold and merge rooflines
   with K7), filter mode with ``--fold off`` (K5, no K1), SLAM mode at
   4,096 particles on a bfloat16 pool (200 frames) and SLAM mode at
   100,000 particles on a bfloat16 pool of 400,000 blocks (50 frames),
   every mode on its graphed runner, each SLAM run's last (replayed) run
   held bit for bit to one timed run of the eager runner on the same
   frames, and each SLAM run's peak device memory printed (at 100,000
   particles held below two pools: every repeat refills the runner's one
   pool in place);
   and hold the first 40 SLAM frames on a bfloat16 pool against the CPU
   port and against the float32 pool, fed the same random draws;
9. check the merge on a packed block image (P4, the second entry point of
   K3's source) at the merge probe's shape (N = 4,096 particles, P = 64
   points, N + 64 blocks of 40x40x4 slots in one float32 image of 160 rows
   per block) against its plain version (meta rows equal as int32, fields
   bitwise on one-point cells, K3's tolerance elsewhere) and against K3 on
   the unpacked fields (bit for bit), and time the three in turns; hold P4
   against K3 on the unpacked fields at P = 1, 192 and 2,048 too; run the
   merge probe ``slam_eslam_tpu_torch.tools.probe_merge_overhead`` in
   process at its defaults (every variant prints, ``copy_packed`` not
   below its byte bound, the grouped rows are K3's); then drive the
   application's mapping API, ``EmbodiedSlamFilter`` with per-particle
   maps at 4,096 particles on a colour-carrying float32 pool with the
   scan match, negative information, the slip update on terrain labels
   and the surface hash, the way ``examples.slam_demo`` drives it (four
   timed passes in turns: eager, graphed, graphed, eager):
   ``update_contact`` on each of 200 frames, ``update_scan`` and
   ``update_distance_image`` (a textured 12x16 distance image) on every
   tenth; count K2, K3 and S1 launches against the gates and the host
   syncs of every mapping update (none: the pool's failure count is read
   a call later, without waiting), print ms per frame and the host's
   launch calls per frame, and hold the graphed pass bit for bit to the
   eager one; hold ``run_stream`` against the same 40 frames driven call
   by call, and the card against the CPU port over 40 frames on
   identical draws; merge a distance image into a hole of the shared
   400x400 map at 100,000 particles (``update_distance_image`` in
   shared-map mode), eager and graphed, bit for bit, and check that the
   contacts of the next ``update_contact`` find the new patches, against
   a twin filter that merged the same image 4 m to the side; and run the
   SLAM runner with the camera and the surface hash
   (``make_slam_scan_runner(camera2body=, hash_=)``) over the 200 frames
   at 4,096 particles, eager and graphed (one graph per combination of
   the measurement, laser, camera and hash gates), bit for bit, with
   launches against the gates, ms and launch calls per frame;
10. the loop-closure backend: the pose-graph solvers (dense, DCS, PCG,
   Schur) at 1,024 nodes and ``scan_align`` against the CPU port, each
   solve (at ``dim`` 3), sweep and keyframe-grid merge also as CUDA graphs
   (``utils.graphs.CallGraphs``), bit for bit the eager one, with ms per
   solve by CUDA events and the host's launch calls both ways (no host
   sync in any); the loop-closure demo;
   ``OnlineSlam`` at 4,096 particles in chunks, eager (K2/K3 against the
   gates, a checkpoint resumed bit for bit, the CPU port on the same
   draws) and graphed (the default: ``run_stream``, the keyframe grids
   and sweeps and the solve as CUDA graphs), each chunk's parts timed and
   bit for bit the eager chunk's; and the localisation demo (K5 once a
   step; its step a CUDA graph, bit for bit its eager run);
11. the log runtime and the record -> replay -> report path: build the
   native log library from ``native/eslam_log.cpp`` into
   ``build/torch_kernels/``; write and read back every record type,
   ``select``/``gather``, ``compact``, ``load_stream`` and the feeder;
   ``examples.full_demo`` at 4,096 particles on 16,384 blocks with the
   demo's route (record, ``frames_from_log`` onto the card equal bit for
   bit to the CPU read, ``OnlineSlam`` in chunks of 60 with K2/K3 against
   the gates, graphed (the demo's default on the card) and eager, bit for
   bit, with ms per chunk and launch calls per frame; the first chunk and
   its best particle's map layers against the CPU port on the same
   draws) and on a route of two out-and-back laps that must close a loop;
   ``tools.closure_lab`` on that run's graph, every policy against the
   CPU port; ``examples.replay_demo`` at 100,000 particles, graphed (one
   K1 launch per measurement update, no K5; 20 frames at 4,096 against
   the CPU port); ``viz.render.chain_layers`` on a
   400,000-block bfloat16 pool within 64 MB of device memory.  Nothing is
   written under ``slam_eslam_tpu/``;
12. the measurement tools of ``tools/``, ported
   (``slam_eslam_tpu_torch.tools``), in process on the card at full width,
   depth cut where their defaults would take most of the phase
   (``TOOL_CUTS``): ``bench_kernels`` (K5 at Q = 2,000,000 bit for bit
   against its plain version, beside its bound), ``probe_chain_parity``
   (K2 at 4,096 x 8 equal to the plain chain walk), ``profile_slam`` at
   4,096 and at 100,000 particles on the compiled runner, every traced
   frame a CUDA graph replay (K2 and K3 in the replayed trace's table
   under their kernel names as often as the gates fired; the device
   records the tracer kept against the launches; the block copies' share
   of the replayed device time on a 41 GB float32 pool, the one pool every
   run refills), ``profile_filter`` (graphed: K1 in the replayed trace once
   a step, the records kept) and ``probe_spread`` (graphed, one K1
   launch per measurement update, no K5, bit for bit its eager run),
   ``profile_step`` at its default shape (K5) and at the bench's step
   (K1, 8 contacts), each stage a CUDA graph (finite, bit for bit an
   eager call; device ms of a graph of 20 copies, the profiler's sum of
   its kernels, host ms, launch calls; at the bench's shape the kernels of
   ``project + update_full + centroid`` and ``odometry.update`` against
   the graphed step's from ``profile_filter``), ``stat_map_test batch`` with
   its evaluation graphed and eagerly (raw arrays bit for bit, result
   files identical), ``profile_resample`` (every
   ancestor index brackets its position in the cumsum searched),
   ``bench_pool_ops`` (every row), ``bench_surface_hash`` (the hash's
   valid candidates equal to the CPU port's) and ``ab_pool_dtype`` (both
   pool types' stats finite).  Nothing is written under
   ``slam_eslam_tpu/``;
13. the ordered scan S1 (``csrc/ordered_scan.cu``, the resampling's
   repeatable cumulative sum, one launch a call) bit for bit against its
   plain version on the card and the CPU at 100,000, 1, 127, 129, 100,003,
   8,193 and 2,100,000 elements and, with zeros of both signs, at its
   level and tile boundaries, two calls alike, graph replays and 250
   calls back to back alike, every ancestor bracketing its position;
   timed at 100,000 and 2,100,000 beside its byte bound, ``torch.cumsum``
   (both in CUDA graphs), an empty kernel's launch and, given
   ``--prior-scan``, an earlier source of the scan in turns; and
   ``profile_resample`` with no index moving between two calls; then the
   multi-rank path (``slam_eslam_tpu_torch.parallel``): a world of one
   NCCL rank runs every meshed runner eagerly and as CUDA graphs from the
   same generator state, each bit for bit the unmeshed eager runner, with
   launches counted (a replay credits its graph's) and no host read in a
   graphed run: the localisation runner (100k particles, 150 steps), the
   filter step with the ring-hop resampler (10 forced resamples), the
   SLAM runner (4,096 particles, 200 frames; K2, K3 and S1 launches
   against the gates) with the pool whole (``map_pool_shards`` 1 and 2)
   and split, ``OnlineSlam(mesh=)`` over two chunks, and the meshed PCG
   and Schur solves at 1,024 nodes (against the CPU port too); ``dryrun_multichip(4)`` (NCCL with a card per rank, else four
   gloo ranks sharing this card, ``transport host``, tensors and kernels
   on the card; the split SLAM pool equal to one process with
   ``map_pool_shards = 4``), printing its backend and transport; what
   NCCL does with two ranks on one card (a probe, reported either way);
   and ``tools.bench_scaling --devices 1`` (graphed over NCCL);
14. the row copy K8 (``csrc/row_copy.cu``, the map pool's copy-on-write
   and rollover, two launches a mapping frame) bit for bit against its
   plain version on the card, on the masks of a copy-on-write after a
   resampling and of a rollover of every particle, at the SLAM path's
   pool (4,096 particles, 40 x 40 cells) and the benchmark cell's (1,000
   particles, 10.24 MB blocks), each timed as a kernel row; and at the
   cell's pool 0, 1, 32 and 1,000 masked rows of a 1,000-row call against
   their byte bound;
15. the cloud merge CM (``csrc/cloud_merge.cu``, the merge of a cloud past
   K3's 16,384 points) at the camera benchmark cell's shape: a 640 x 480
   textured distance image of flat ground, through the camera projection,
   under 1,000 poses into a float32 colour pool of 4,000 blocks of 400 x
   400 cells x 4 slots (71.68 GB, heads spread from block 0 to the last),
   one launch counted from a reset, held against the plain version from
   the same start: on the CPU, whose sums go in point order as the
   kernel's, at 40 heads from the first block to the last (mean, height,
   meta and colour bit for bit, stdev within one float32 step), and on the
   card at every head (meta bit for bit, floats to rounding: its sums go
   in ``index_put_``'s order; the placement and cell counters equal), a
   block no head names untouched; timed as a
   kernel row against its bound from ``benchmark/roofline/merge_cloud.py``'s
   counts; and at the laser cell's shape (1,081 points, no colour) CM in
   turns with K3 alone and K3 with its operands.

Every kernel's time is the card's own (``ms`` = ``device_ms``): 200 raw
launches (a kernel module's ``launch``: no check, no allocation) captured
into a CUDA graph and replayed between two CUDA events, so that no Python
runs between two launches.  ``device_ms_profiler`` is the cross-check:
``torch.profiler``'s time of the kernel by its name over 20 eager
launches, which leaves out the gap between two graph nodes (null, and
said, where the tracer kept no device record in any of its sessions: the
kernel ran, the cross-check is missing).  ``call_ms``
is CUDA events around a Python loop of calls of the public wrapper, which
is the wrapper's host time wherever that exceeds the kernel's (what an
eager loop pays per call).  ``plain_ms`` and ``library_ms`` are device
times on the same clock where the plain version, or the one PyTorch call,
captures (reads nothing back, does not synchronise): 20 calls in a CUDA
graph, replayed; where it does not, ``torch.profiler``'s sum of every
kernel it puts on the card, and ``plain_clock`` / ``library_clock`` say
which and why.  ``plain_ms_profiler`` / ``library_ms_profiler`` keep the
profiler's sum beside a graph's reading (``plain_call_ms``,
``library_call_ms``: the events around the calls).  Each time stands beside its bound: the bytes
the call must move (each input read once, each output written once,
counted from this run's inputs) over the card's published memory rate,
or its operations over the published float32 rate (for K1: the
instructions this run's queries need, ``utils.kernel_eff.fold_work``),
whichever takes longer.  K2, K3, K7 ``cells``/``points`` and P4 also stand
beside ``bound_ms_sectors``: the distinct 32-byte sectors their inputs
touch, read and written (``utils.kernel_eff.chain_traffic``,
``merge_traffic``: the card moves sectors, and a scattered 8- or 16-byte
slot row costs one), over the same memory rate, with ``share_sectors``
the bound over the device time.

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
from types import SimpleNamespace

import numpy as np
import torch

N_BENCH = 100_000
N_RAGGED = 100_003
STEPS = 150
CHECK_STEPS = 20
LAUNCH_STEPS = 10        # steps traced for the host's launch calls
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
SLAM_CHECK_FRAMES = 40    # frames held against the CPU port
SLAM_PROFILE_FRAMES = 50
SLAM_LAUNCH_FRAMES = 50    # frames traced for the host's launch calls
# K3 against its plain version: bitwise on cells one point hits; the
# plain version sums multi-point cells with atomics on the card, so
# those agree to float32 rounding: rtol 1e-6 (mean, stdev), atol 1e-6 m
# (height, a difference of two heights)
MERGE_RTOL = 1e-6
MERGE_HEIGHT_ATOL = 1e-6
# GPU vs CPU port: patch counts after 40 frames.  Float32 rounding of
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
           "block_copy", "ordered_scan", "row_copy", "cloud_merge")
# every wrapper that counts launches: block_merge's source has two
WRAPPERS = KERNELS + ("block_merge_packed",)
# published peaks of one H100 SXM at its 700 W limit (NVIDIA's data
# sheet): memory rate, and float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS_F32 = 67e12
# a kernel's device time: raw launches per CUDA graph; the graph's and the
# profiler's readings are said to differ beyond this
GRAPH_REPS = 200
PLAIN_GRAPH_REPS = 20    # calls of a plain version or library call a graph
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
# K3's other point counts (phases 5, 8, 9): one point, the camera image
# (MAP_IMAGE), a long cloud
MERGE_POINTS = (1, 192, 2048)
MAP_CHECK_FRAMES = 40      # frames of the run_stream and CPU port checks
MAP_WARM_FRAMES = 30
MAP_PASSES = 2               # timed passes of the 200 frames a mode, in turns
MAP_LAUNCH_FRAMES = 40       # frames traced for the host's launch calls
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


def runtime_calls(fn, trace=None):
    """The CUDA runtime calls ``fn()`` makes on the host, by name:
    ``torch.profiler``'s host records (the tracer keeps them) of one call
    ending in a device sync.  ``trace`` (a dict) also receives the
    session's wall seconds, the device time of the kernels it traced
    (ms; a profiler that lost device records reads low) and the host
    time of its graph launches (ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    if trace is not None:
        trace.update(wall=wall, device_ms=sum(
            e.self_device_time_total for e in events
            if e.device_type == DeviceType.CUDA) / 1e3, graph_ms=sum(
            e.self_cpu_time_total for e in events
            if "GraphLaunch" in e.key) / 1e3)
    return {e.key: e.count for e in events
            if e.device_type != DeviceType.CUDA and e.key.startswith("cu")}


def host_launches(fn, steps):
    """Per step of ``fn()`` (a run of ``steps`` steps): the host's
    kernel-launch calls, graph-launch calls and copies/memsets, the host
    milliseconds of one graph launch, and the device's busy share of the
    traced run (kernel time over wall time)."""
    trace = {}
    calls = runtime_calls(fn, trace)
    per = lambda *keys: sum(v for k, v in calls.items()
                            if any(key in k for key in keys)) / steps
    graph = per("GraphLaunch")
    return dict(kernel=per("LaunchKernel"), graph=graph,
                copy=per("Memcpy", "Memset"),
                graph_ms=trace["graph_ms"] / max(graph * steps, 1),
                device_ms=trace["device_ms"] / steps,
                busy=trace["device_ms"] / 1e3 / trace["wall"])


def calls_text(calls, unit):
    return (f"per {unit}: host {calls['kernel']:.2f} kernel-launch, "
            f"{calls['graph']:.2f} graph-launch and {calls['copy']:.2f} copy "
            f"calls" + (f" ({calls['graph_ms']:.4f} ms of host time a graph "
                        f"launch)" if calls["graph"] else "")
            + f", device {calls['device_ms']:.4f} ms of kernels (busy "
            f"{calls['busy']:.1%} of the traced run)")


def equal_bits(got, ref):
    """Every tensor of ``got`` equal to ``ref``'s bit for bit
    (``utils.graphs.equal_bits``); returns ``(all equal, tensors
    compared)``."""
    from slam_eslam_tpu_torch.utils import graphs

    return graphs.equal_bits(got, ref)


def device_index(value, dev):
    """An update index as K3's raw launch reads it: a 0-d int32 tensor on
    the card (``ops.block_merge.device_update_idx``)."""
    return torch.full((), value, dtype=torch.int32, device=dev)


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


def sync_free(fn):
    """None if ``fn()`` runs with no host read and no synchronise (once,
    under ``set_sync_debug_mode("error")``), else the first line of what
    it raised."""
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as err:
        return str(err).strip().splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(before)
    return None


def profiler_ms(fn, kernel_name=None, calls=20):
    """``torch.profiler``'s milliseconds per call of ``fn``
    (``profiling.profiler_kernel_time``), or None where the tracer lost
    every device record of its sessions (``ProfilerLostRecords``): the
    kernel ran, only the cross-check is missing, and that is said."""
    from slam_eslam_tpu_torch.utils import profiling

    try:
        return profiling.profiler_kernel_time(fn, kernel_name, calls) * 1e3
    except profiling.ProfilerLostRecords as err:
        print(f"profiler reading not measured "
              f"({kernel_name or 'all kernels'}): {err}")
        return None


def ms_text(ms, digits=5):
    """``ms`` with ``digits`` decimals, or "not measured" for None."""
    return "not measured" if ms is None else f"{ms:.{digits}f}"


def device_ms_of(fn, calls=5, reps=PLAIN_GRAPH_REPS):
    """Device milliseconds per call of ``fn``, a function of many PyTorch
    operations, on the clock of a kernel's ``ms`` where ``fn`` captures:
    ``reps`` calls in a CUDA graph, replayed (``profiling.device_time``).
    ``fn`` captures when it reads nothing back and does not synchronise
    (``sync_free``) and the capture succeeds; else the reading is
    ``torch.profiler``'s sum of every kernel it puts on the card, or,
    where the tracer lost every record, CUDA events around ``calls``
    eager calls, and the clock says which and why.  Returns ``(ms, clock,
    the profiler's ms or None)``: the profiler's reading is kept beside
    the graph's as a cross-check."""
    from slam_eslam_tpu_torch.utils import profiling

    prof = profiler_ms(fn, None, calls)
    reason = sync_free(fn)
    if reason is None:
        stream = torch.cuda.current_stream()
        try:
            return profiling.device_time(fn, reps, replays=3) * 1e3, \
                "graph", prof
        except (RuntimeError, torch.cuda.OutOfMemoryError) as err:
            torch.cuda.set_stream(stream)
            torch.cuda.synchronize()
            reason = f"capture failed: {str(err).strip().splitlines()[0]}"
    if prof is None:
        return cuda_ms(fn, calls), (f"events around {calls} calls (the "
                                    f"profiler lost its records; does not "
                                    f"capture: {reason})"), prof
    return prof, f"profiler (does not capture: {reason})", prof


def kernel_times(label, call, launch, kernel_name, plain, bnd, n_call=50,
                 n_plain=5, reps=GRAPH_REPS, sectors=None):
    """Every time of one kernel row.  ``ms`` = ``device_ms``: ``reps`` raw
    launches (``launch()``: a kernel module's ``launch`` on fixed operands
    and outputs) captured into a CUDA graph and replayed, so no Python
    runs between the launches; ``device_ms_profiler``: the kernel's own
    time by its name (``kernel_name``) from ``torch.profiler`` over 20
    eager launches, without the gap between graph nodes; ``call_ms``: CUDA
    events around a Python loop of ``call()``, the public wrapper (what an
    eager loop pays per call: the wrapper's host time where that exceeds
    the kernel's), in turns with ``plain()``, the plain version
    (``plain_call_ms``); ``plain_ms``: the plain version on the card, from
    a graph where it captures (``device_ms_of``: ``plain_clock`` says
    which clock, ``plain_ms_profiler`` is the profiler's sum of its
    kernels beside it); ``bound_ms``, ``bound_by`` from
    ``bnd``; with ``sectors`` (the 32-byte sectors the call touches) also
    ``bound_ms_sectors`` and its share of ``ms``."""
    from slam_eslam_tpu_torch.utils import profiling

    call_ms, plain_call, runs = alternate(call, plain, n_call, n_plain)
    plain_ms, plain_clock, plain_prof = device_ms_of(plain)
    dev = profiling.device_time(launch, reps) * 1e3
    prof = profiler_ms(launch, kernel_name)
    print(f"{label} device {dev:.5f} ms (graph of {reps} launches), "
          f"{ms_text(prof)} ms (profiler, {kernel_name}); call "
          f"{call_ms:.4f} ms "
          f"({runs[1]:.4f}, {runs[2]:.4f}: events around the wrapper), plain "
          f"{plain_ms:.4f} ms on the card ({plain_clock}; profiler "
          f"{ms_text(plain_prof, 4)}, all its kernels), "
          f"{plain_call:.4f} ms a call ({runs[0]:.4f}, {runs[3]:.4f}), bound "
          f"{bnd[0]:.5f} ms ({bnd[1]}): {bnd[0] / dev:.3f} of the bound")
    if prof is not None and abs(dev - prof) > CROSS_CHECK_RTOL * prof:
        print(f"{label}: graph and profiler readings differ by "
              f"{abs(dev - prof) / prof:.0%}; ms takes the graph's, which "
              f"holds the gap between two graph nodes that a captured step "
              f"pays too; the profiler's is the kernel alone")
    times = dict(ms=dev, device_ms=dev, device_ms_profiler=prof,
                 call_ms=call_ms, plain_ms=plain_ms, plain_clock=plain_clock,
                 plain_ms_profiler=plain_prof, plain_call_ms=plain_call,
                 bound_ms=bnd[0], bound_by=bnd[1])
    if sectors is not None:
        times.update(sector_times(label, sectors, dev))
    return times


def sector_ms(sectors):
    """The least time the card takes to move ``sectors`` 32-byte sectors."""
    from slam_eslam_tpu_torch.utils.kernel_eff import SECTOR_BYTES

    return sectors * SECTOR_BYTES / PEAK_BYTES_PER_S * 1e3


def sector_times(label, sectors, ms):
    """``bound_ms_sectors`` (the sectors a call touches over the memory
    rate) and its share of the device time ``ms``, printed."""
    from slam_eslam_tpu_torch.utils.kernel_eff import SECTOR_BYTES

    b = sector_ms(sectors)
    print(f"{label} sectors {sectors} ({sectors * SECTOR_BYTES / 1e6:.2f} "
          f"MB): bound "
          f"{b:.5f} ms, {b / ms:.3f} of it")
    return dict(sectors=sectors, bound_ms_sectors=b, share_sectors=b / ms)


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
    from slam_eslam_tpu_torch import ops
    from slam_eslam_tpu_torch.filter import pose_estimator as pe
    from slam_eslam_tpu_torch.filter import step as steplib
    from slam_eslam_tpu_torch.mapping.lookup import make_lookup
    from slam_eslam_tpu_torch.utils import tree

    cfg, grid, css, qs, truth, particles = bench_setup(N_BENCH, STEPS)
    lookup = make_lookup(cfg, tree.to(grid, dev))
    css_d, qs_d = tree.to(css, dev), qs.to(dev)
    window = (tree.index(css_d, slice(0, LAUNCH_STEPS)), qs_d[:LAUNCH_STEPS])
    # a contact fold (K1) and an ordered scan (S1) in every step
    want = dict(dict.fromkeys(WRAPPERS, 0), contact_fold=STEPS,
                ordered_scan=STEPS)
    runs = {}
    for mode in ("eager", "graphed"):
        run = steplib.make_scan_runner(cfg, lookup, graph=mode == "graphed")
        # the warm-up; the graphed runner captures its step here
        run(fresh_state(cfg, particles, dev), css_d, qs_d)
        torch.cuda.synchronize()
        state0 = fresh_state(cfg, particles, dev)
        torch.cuda.synchronize()

        ops.reset_launch_counts()
        # any host sync inside the step raises here
        torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            final, cents = run(state0, css_d, qs_d)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        counts = ops.launch_counts()
        if counts != want:
            raise RuntimeError(f"main path[{mode}]: launches {counts} in "
                               f"{STEPS} steps")
        if mode == "graphed" and run.graphs.counts() != dict(
                eager=1, captured=1, replayed=2 * STEPS - 1):
            raise RuntimeError(f"main path[graphed]: steps "
                               f"{run.graphs.counts()}: the timed run did "
                               f"not only replay")
        start = fresh_state(cfg, particles, dev)
        calls = host_launches(lambda: run(start, *window), LAUNCH_STEPS)
        print(f"main path[{mode}]: {STEPS} steps x {N_BENCH} particles in "
              f"{elapsed:.4f} s = {elapsed / STEPS * 1e3:.4f} ms/step, "
              f"contact_fold launches {counts['contact_fold']}, "
              f"ordered_scan launches {counts['ordered_scan']}; "
              f"{calls_text(calls, 'step')}")
        runs[mode] = dict(run=run, final=final, cents=cents,
                          gen=state0.generator, elapsed=elapsed,
                          counts=counts, calls=calls)
    eager, graphed = runs["eager"], runs["graphed"]
    same, n_fields = equal_bits((graphed["cents"], graphed["final"]),
                                (eager["cents"], eager["final"]))
    same_gen = torch.equal(graphed["gen"].get_state(), eager["gen"].get_state())
    print(f"main path: graphed vs eager over {STEPS} steps from one state "
          f"and seed: centroids and {n_fields - 1} final-state tensors equal "
          f"bit for bit: {same}; generator states equal: {same_gen}")
    if not (same and same_gen):
        raise RuntimeError("main path: the graphed run differs from the "
                           "eager run")
    run, cents, final = eager["run"], eager["cents"], eager["final"]
    launches = eager["counts"]["contact_fold"]
    scan_launches = eager["counts"]["ordered_scan"]
    if cents.shape != (STEPS, 3) or not torch.isfinite(cents).all():
        raise RuntimeError("main path: non-finite or misshaped centroids")
    if not torch.isfinite(final.particles.weight).all():
        raise RuntimeError("main path: non-finite particle weights")
    err = np.linalg.norm(cents[:, :2].cpu().numpy() - truth, axis=1)
    final10 = float(err[-10:].mean())

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
    return dict(elapsed=eager["elapsed"], elapsed_graph=graphed["elapsed"],
                launches=launches, scan_launches=scan_launches,
                launches_graphed=graphed["counts"], calls=eager["calls"],
                calls_graph=graphed["calls"], final10=final10,
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


def check_chain_lookup(dev, pool, z_window):
    from slam_eslam_tpu_torch.models import sim
    from slam_eslam_tpu_torch.ops import chain_lookup as cl
    from slam_eslam_tpu_torch.utils.kernel_eff import chain_traffic

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
            traffic = chain_traffic(pool, args[5], args[6], z_window)
            timing = kernel_times(
                "chain_lookup[bench]", lambda: cl.chain_lookup(*args, **kw),
                lambda: cl.launch(*args, outs, **kw), "chain_lookup_kernel",
                lambda: cl.chain_lookup_reference(*args, **kw),
                bound(traffic["bytes"]), sectors=traffic["sectors"])
            timing["sectors_all_levels"] = traffic["sectors_all_levels"]
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


def cloud_of(dev, p, seed=21):
    """A cloud of ``p`` points ahead of the robot, heights near 0.3 m: the
    camera image's lattice for p = 12 x 16 (``MAP_IMAGE``: 0.6-2.1 m
    ahead, 0.9 m to either side), else ``p`` points drawn over 0.3-3.3 m
    ahead and 1.5 m to either side (K3's other point counts)."""
    from slam_eslam_tpu_torch.mapping.mls_grid import PatchCloud

    gen = torch.Generator(dev).manual_seed(seed)
    rand = lambda *s: torch.rand(s, generator=gen, device=dev)
    h, w = MAP_IMAGE
    if p == h * w:
        gx, gy = torch.meshgrid(torch.linspace(0.6, 2.1, h, device=dev),
                                torch.linspace(-0.9, 0.9, w, device=dev),
                                indexing="ij")
        xy = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)
    else:
        xy = torch.stack([0.3 + 3.0 * rand(p), 3.0 * rand(p) - 1.5], -1)
    return PatchCloud.create(
        xy=xy, z=0.3 + 0.02 * torch.randn(p, generator=gen, device=dev),
        stdev=0.01 + 0.04 * rand(p),
        valid=torch.ones(p, dtype=torch.bool, device=dev))


def hit_cells(blk, lx, ly, b, nx, ny):
    """``(in-range points, distinct hit cells)`` of merge operands."""
    from slam_eslam_tpu_torch.ops.block_copy import hit_rows

    rows = hit_rows(blk, lx, ly, b, nx, ny)
    return int(rows.numel()), distinct(rows)


def bf16_steps(a, b):
    """Per-element distance, in bfloat16 steps, of two bfloat16 tensors."""
    return (a.view(torch.int16).long() - b.view(torch.int16).long()).abs()


def check_block_merge(dev, pool, cfg):
    from slam_eslam_tpu_torch.mapping import map_pool as mp
    from slam_eslam_tpu_torch.models import sim
    from slam_eslam_tpu_torch.ops import block_merge as bm
    from slam_eslam_tpu_torch.utils.kernel_eff import merge_traffic

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
            traffic = merge_traffic(pool, blk, lx, ly)
            uidx = device_index(7, dev)
            timing = kernel_times(
                "block_merge[bench]",
                lambda: bm.block_merge(*kern, None, blk, lx, ly, w, wz, 7,
                                       **kw),
                lambda: bm.launch(*kern, None, blk, lx, ly, w, wz, uidx,
                                  **kw),
                "block_merge_kernel",
                lambda: bm.block_merge_reference(*plain, None, blk, lx, ly,
                                                 w, wz, 7, **kw),
                bound(traffic["bytes"], traffic["flops"]),
                sectors=traffic["sectors"])
        del kern, plain
    timing.update(check_merge_points(dev, pool, cfg))
    return max_err, timing


def compact_merge(fields, blk):
    """The blocks ``blk`` (all valid) of ``fields`` as a pool of their own,
    and the block ids into it: the merge of the same points touches the
    same cells with the same sums."""
    ids = torch.arange(blk.shape[0], dtype=torch.int32, device=blk.device)
    return [f.index_select(0, blk.long()) for f in fields], ids


def check_merge_points(dev, pool, cfg):
    """K3 at the other point counts it serves (``MERGE_POINTS``: one
    point, the camera image, a long cloud) on the blocks the SLAM check's
    poses hit: against the plain version on the CPU, whose sums run in
    point order as the kernel's do (the card's plain version sums with
    atomics): meta, mean and height bit for bit, stdev within one step
    (PyTorch's vectorised CPU ``sqrt`` is not correctly rounded); and the
    device time beside the sector bound.  Returns the row's keys."""
    from slam_eslam_tpu_torch.mapping import map_pool as mp
    from slam_eslam_tpu_torch.models import sim
    from slam_eslam_tpu_torch.ops import block_merge as bm
    from slam_eslam_tpu_torch.utils import profiling
    from slam_eslam_tpu_torch.utils.kernel_eff import merge_traffic

    kw = dict(k=pool.k, patch_thickness=cfg.grid_patch_thickness,
              gap_size=cfg.grid_gap_size)
    poses = sim.poses_on_heads(pool, 3.0, seed=7)
    fields = [pool.mean, pool.stdev, pool.height, pool.meta]
    step = lambda a, b: (bf16_steps(a, b) if a.dtype == torch.bfloat16 else
                         (a.view(torch.int32).long()
                          - b.view(torch.int32).long()).abs())
    out = {}
    for p in MERGE_POINTS:
        blk, lx, ly, w, wz = mp.merge_operands(pool, *poses, cloud_of(dev, p))
        sub, ids = compact_merge(fields, blk)
        cpu = [f.cpu() for f in sub]
        bm.block_merge(*sub, None, ids, lx, ly, w, wz, 7, **kw)
        bm.block_merge_reference(*cpu, None, ids.cpu(), lx.cpu(), ly.cpu(),
                                 w.cpu(), wz.cpu(), 7, **kw)
        torch.cuda.synchronize()
        label = f"block_merge[P={p}]"
        for fname, a, b in zip(("mean", "stdev", "height", "meta"), sub, cpu):
            gap = int(step(a.cpu(), b).max())
            if gap > (1 if fname == "stdev" else 0):
                raise RuntimeError(f"{label} {fname}: {gap} steps from the "
                                   f"plain version on the CPU")
        written = int((sub[3].cpu() != pool.meta.index_select(
            0, blk.long()).cpu()).sum())
        if not written:
            raise RuntimeError(f"{label}: nothing written")
        traffic = merge_traffic(pool, blk, lx, ly)
        uidx = device_index(7, dev)
        ms = profiling.device_time(
            lambda: bm.launch(*fields, None, blk, lx, ly, w, wz, uidx,
                              **kw)) * 1e3
        b_ms = bound(traffic["bytes"], traffic["flops"])[0]
        print(f"{label} N={blk.shape[0]} {pool.mean.dtype}: {written} slots "
              f"written, meta, mean and height equal bit for bit to the plain "
              f"version on the CPU, stdev within one step; device {ms:.5f} ms "
              f"(graph of {GRAPH_REPS} launches), bound {b_ms:.5f} ms (bytes)")
        out.update({f"ms_p{p}": ms, f"bound_ms_p{p}": b_ms})
        sec = sector_times(label, traffic["sectors"], ms)
        out.update({f"{key}_p{p}": v for key, v in sec.items()})
    return out


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


def slam_gates_want(aux, cfg, runs=1):
    """K2, K3, S1 and row-copy launches the gates of ``aux`` call for, in
    ``runs`` runs: one K2 and one S1 per measurement update (and one K2
    per mapping frame with the scan match), one K3 and two row copies
    (copy-on-write, rollover) per mapping frame."""
    n_meas, n_map = int(aux["updated"].sum()), int(aux["mapped"].sum())
    return dict(dict.fromkeys(WRAPPERS, 0),
                chain_lookup=runs * (n_meas + (
                    n_map if cfg.use_visual_update else 0)),
                block_merge=runs * n_map, ordered_scan=runs * n_meas,
                row_copy=2 * runs * n_map)


def slam_equal(got, ref):
    """Two SLAM runs ``(carry, aux)`` bit for bit: gates, centroids, best
    poses, the filter, every pool field (``meta`` with its update
    indices), the chains, ``alloc_failed``, the host fields and the
    generator.  Returns ``(equal, tensors compared)``."""
    (gc, ga), (rc, ra) = got, ref
    same, n = equal_bits(
        (ga["centroid"], ga["best_pose"], gc.filter, gc.pool,
         gc.alloc_failed),
        (ra["centroid"], ra["best_pose"], rc.filter, rc.pool,
         rc.alloc_failed))
    same &= all((ga[k] == ra[k]).all() for k in ("updated", "mapped"))
    same &= (gc.update_idx, gc.steps) == (rc.update_idx, rc.steps)
    gens = gc.filter.generator, rc.filter.generator
    same &= None in gens or torch.equal(gens[0].get_state(),
                                        gens[1].get_state())
    return bool(same), n


def slam_path(dev, profile):
    from slam_eslam_tpu_torch import bench, ops
    from slam_eslam_tpu_torch.filter import streaming
    from slam_eslam_tpu_torch.utils import tree

    cfg = slam_config()
    z0, frames, full, qs = slam_setup()
    n_frames = len(frames)
    frames_d = tree.to(frames, dev)
    odos = streaming.precompute_odometry(20, tree.to(full, dev), qs.to(dev),
                                         cfg=cfg)
    window = slice(0, SLAM_LAUNCH_FRAMES)
    runs = {}
    for mode in ("eager", "graphed"):
        run = bench.make_slam_runner(cfg, graph=mode == "graphed")
        if mode == "eager":
            warm = slice(0, 30)
            run(slam_carry(cfg, z0, dev), frames_d.at(warm),
                tree.index(odos, warm))
        else:
            # every gate combination met twice: captured before the timed run
            for _ in range(2):
                run(slam_carry(cfg, z0, dev), frames_d, odos)
                if run.settled():
                    break
        carry0 = slam_carry(cfg, z0, dev)
        torch.cuda.synchronize()

        ops.reset_launch_counts()
        before = run.counts() if mode == "graphed" else None
        # any host sync inside a frame raises here
        torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            carry, aux = run(carry0, frames_d, odos)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = ops.launch_counts()
        del carry0

        n_meas, n_map = int(aux["updated"].sum()), int(aux["mapped"].sum())
        want = slam_gates_want(aux, cfg)
        if launches != want or not n_meas or not n_map:
            raise RuntimeError(f"SLAM path[{mode}]: launches {launches}, "
                               f"gates want {want}")
        if before is not None and (
                run.counts()["eager"], run.counts()["captured"]) != (
                before["eager"], before["captured"]):
            raise RuntimeError(f"SLAM path[graphed]: frames {run.counts()}: "
                               f"the timed run did not only replay")
        patches, failed = check_slam_state(carry, aux, n_frames,
                                           f"SLAM path[{mode}]")
        runs[mode] = dict(run=run, out=(carry, aux), elapsed=elapsed,
                          launches=launches, patches=patches, failed=failed,
                          n_meas=n_meas, n_map=n_map)
        del carry
    eager, graphed = runs["eager"], runs["graphed"]
    same, n_tensors = slam_equal(graphed["out"], eager["out"])
    del graphed["out"], eager["out"]
    for mode, r in runs.items():
        # the graphed runner's pool is its own: traced after the comparison
        start = slam_carry(cfg, z0, dev)
        r["calls"] = host_launches(
            lambda: r["run"](start, frames_d.at(window),
                             tree.index(odos, window)), SLAM_LAUNCH_FRAMES)
        del start
        print(f"SLAM path[{mode}]: {n_frames} frames x {SLAM_N} particles "
              f"in {r['elapsed']:.4f} s = {n_frames / r['elapsed']:.2f} "
              f"frames/s, {r['elapsed'] / n_frames * 1e3:.4f} ms/frame; "
              f"{r['n_meas']} measurement and {r['n_map']} mapping frames; "
              f"launches {r['launches']}; patches {r['patches']}, "
              f"alloc_failed {r['failed']}; "
              f"{calls_text(r['calls'], 'frame')}"
              + (f"; frames {r['run'].counts()}" if mode == "graphed"
                 else ""))
    print(f"SLAM path: graphed vs eager over {n_frames} frames from one "
          f"state and seed: gates, centroids, best poses and {n_tensors - 2} "
          f"filter, pool (meta and chains included) and alloc_failed tensors "
          f"equal bit for bit: {same}")
    if not same:
        raise RuntimeError("SLAM path: the graphed run differs from the "
                           "eager run")
    run = eager["run"]

    # the first frames against the CPU port on the same draws
    dev_err, _ = slam_compare(run, cfg, z0, frames, full, qs, dev,
                              "SLAM path")

    if profile:
        profile_slam(run, cfg, z0, frames_d, odos, dev, Path(profile))
    return dict(elapsed=eager["elapsed"], elapsed_graph=graphed["elapsed"],
                frames=n_frames, launches=eager["launches"],
                launches_graphed=graphed["launches"],
                patches=eager["patches"], failed=eager["failed"],
                dev_err=dev_err, n_meas=eager["n_meas"],
                n_map=eager["n_map"], calls=eager["calls"],
                calls_graph=graphed["calls"])


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


def app_filter(cfg, grid, z0, dev, hash_config=None, particles=None,
               graph=False):
    from slam_eslam_tpu_torch.filter.eslam_filter import EmbodiedSlamFilter
    from slam_eslam_tpu_torch.utils import tree

    f = EmbodiedSlamFilter(config=cfg, device=dev, graph=graph).init(
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
    around it, its host milliseconds (the time to launch its work) and
    whether it replayed a graph, ``exports`` the period-gated
    distributions.  Returns the gate decisions."""
    gates = []
    for i in range(frames):
        if spans is not None:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            replays = f.graphs.counts().get("replayed", 0)
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
            spans.append((*ev, host_ms,
                          f.graphs.counts().get("replayed", 0) > replays))
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


def span_means(spans, gates):
    """Mean device (CUDA events) and host milliseconds of the calls of
    ``spans`` whose gate fired and of those whose gate did not; a graphed
    run's calls that replayed only (its first meetings run eagerly and
    capture)."""
    replays = any(s[3] for s in spans)

    def mean(which, gated):
        ms = [which(s) for s, g in zip(spans, gates)
              if g == gated and (s[3] or not replays)]
        return sum(ms) / max(len(ms), 1)

    device = lambda s: s[0].elapsed_time(s[1])
    host = lambda s: s[2]
    return dict(ms_meas=mean(device, True), ms_plain=mean(device, False),
                host_meas=mean(host, True), host_plain=mean(host, False))


def app_run(mode, cfg, hcfg, grid_d, z0, poses, frames, qs_l, dev, card):
    """The application's APP_FRAMES frames from a fresh filter, eager or
    graphed (``EmbodiedSlamFilter(graph=True)``), host syncs forbidden in
    every call: launches against the gates, ms per frame, the host's
    launch calls per frame (LAUNCH_STEPS more frames traced)."""
    from slam_eslam_tpu_torch import ops

    t0 = time.perf_counter()
    f = app_filter(cfg, grid_d, z0, dev, hcfg, graph=mode == "graphed")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    spans, exports = [], []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    gates = app_drive(f, poses, frames, qs_l, APP_FRAMES, spans=spans,
                      exports=exports)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = ops.launch_counts()
    n_meas = sum(gates)
    # K5 and S1 once per measurement update, K1 none (log_debug); S1 also
    # once per distribution export (the GMM's first mean)
    want = dict(dict.fromkeys(WRAPPERS, 0), select_cells=n_meas,
                ordered_scan=n_meas + len(exports))
    if launches != want or not n_meas:
        raise RuntimeError(f"application path[{mode}]: launches {launches} "
                           f"for {n_meas} measurement updates")
    out = dict(f=f, gates=gates, exports=exports, elapsed=elapsed,
               init_s=init_s, launches=launches, n_meas=n_meas,
               graphs=f.graphs.counts(), **span_means(spans, gates))
    # the calls were checked: the state the launch trace leaves is not
    out["state"] = (graphs_clone(f.state), graphs_clone(f.last_eval))
    out["gen"] = f.state.generator.get_state()
    out["calls"] = host_launches(
        lambda: app_drive(f, poses, frames, qs_l, LAUNCH_STEPS),
        LAUNCH_STEPS)
    print(f"application path[{mode}]: {APP_FRAMES} frames x {N_BENCH} "
          f"particles in {elapsed:.4f} s = {APP_FRAMES / elapsed:.2f} "
          f"frames/s; {n_meas} measurement updates at {out['ms_meas']:.4f} "
          f"ms each (CUDA events; {out['host_meas']:.4f} ms on the host), "
          f"other frames {out['ms_plain']:.4f} ms ({out['host_plain']:.4f} "
          f"ms)" + (" over the replayed calls" if mode == "graphed" else "")
          + f"; launches {launches}; {calls_text(out['calls'], 'frame')}"
          + (f"; calls {out['graphs']}" if mode == "graphed" else "")
          + f" [{card}]")
    return out


def graphs_clone(tree):
    from slam_eslam_tpu_torch.utils import graphs

    return graphs.clone(tree)


def app_path(dev, profile, card=None):
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
    runs = {mode: app_run(mode, cfg, hcfg, grid_d, z0, poses, frames, qs_l,
                          dev, card) for mode in ("eager", "graphed")}
    eager, graphed = runs["eager"], runs["graphed"]
    f = eager["f"]
    same, n_fields = equal_bits(
        (graphed["state"], [d for _, d in graphed["exports"]]),
        (eager["state"], [d for _, d in eager["exports"]]))
    same &= graphed["gates"] == eager["gates"] and [
        i for i, _ in graphed["exports"]] == [i for i, _ in eager["exports"]]
    same_gen = torch.equal(graphed["gen"], eager["gen"])
    print(f"application path: graphed vs eager over {APP_FRAMES} frames "
          f"from one state and seed: gates, the state, last_eval and "
          f"{len(eager['exports'])} distribution exports ({n_fields} "
          f"tensors) equal bit for bit: {same}; generator states equal: "
          f"{same_gen} [{card}]")
    if not (same and same_gen):
        raise RuntimeError("application path: the graphed run differs from "
                           "the eager run")
    del graphed["f"], graphed["state"], eager["state"]
    gates, exports = eager["gates"], eager["exports"]
    n_meas = eager["n_meas"]
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
    launches = {"select_cells": eager["launches"]["select_cells"],
                "contact_fold": eager["launches"]["contact_fold"]}
    print(f"application path: {APP_FRAMES} frames x {N_BENCH} particles in "
          f"{eager['elapsed']:.4f} s = {APP_FRAMES / eager['elapsed']:.2f} "
          f"frames/s eager, {APP_FRAMES / graphed['elapsed']:.2f} graphed; "
          f"{len(exports)} distribution exports, "
          f"{app_reinjections(gates, hcfg)} hash reinjections; hash "
          f"{f.hash.cand_xy.shape[0]} candidates, {int(f.hash.n_valid)} "
          f"valid, init {eager['init_s']:.4f} s")
    del f, eager["f"], exports

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
    return dict(elapsed=eager["elapsed"], launches=launches, n_meas=n_meas,
                ms_meas=eager["ms_meas"], ms_plain=eager["ms_plain"],
                host_meas=eager["host_meas"],
                host_plain=eager["host_plain"], dev_err=dev_err,
                cp_err=cp_err, flips=flips, short=short, graphed=graphed,
                calls=eager["calls"])


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
        # the merge's rows, read and written: the same sectors as its own
        shape = SimpleNamespace(b=fields[0].shape[0], nx=COPY_BLOCK["nx"],
                                ny=COPY_BLOCK["ny"], k=k, mean=fields[0])
        copy_sectors = kernel_eff.merge_traffic(shape, blk, *points[:2])[
            "sectors"]
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
        uidx = device_index(3, dev)
        launches["merge"] = lambda: bm.launch(*fields, None, blk, *points,
                                              uidx, **kw)
        dev_ms = {name: profiling.device_time(f, COPY_GRAPH_REPS) * 1e3
                  for name, f in launches.items()}
        prof_ms = {name: profiler_ms(
            f, "block_merge_kernel" if name == "merge"
            else f"block_copy_{name}_kernel")
            for name, f in launches.items()}
        # the plain versions and the library call on the card: from a graph
        # where they capture, else all their kernels summed by the profiler
        clocks = {}
        for name, fn in (
                ("plain", lambda: bc.block_copy_reference(
                    fields, blk, points, mode="whole", k=k)),
                ("plain_cells", lambda: bc.block_copy_reference(
                    fields, blk, points, mode="cells", k=k)),
                ("library", library)):
            dev_ms[name], clocks[name], prof_ms[name] = device_ms_of(fn)
        print(f"block_copy[bench] {dtype} plain, plain cells, library: "
              + "; ".join(f"{name} {dev_ms[name]:.4f} ms ({clock}; profiler "
                          f"{ms_text(prof_ms[name], 4)})"
                          for name, clock in clocks.items()))
        timing[tag] = dict(call=ms, device=dev_ms, profiler=prof_ms,
                           clock=clocks,
                           bound_whole=b_whole, bound_cells=b_cells,
                           bound_points=b_points, sectors=copy_sectors)
        for mode in ("cells", "points", "merge"):
            sector_times(f"block_copy[bench] {dtype} {mode}", copy_sectors,
                         dev_ms[mode])
        print(f"block_copy[bench] {dtype} device (graph of "
              f"{COPY_GRAPH_REPS} launches / profiler): whole "
              f"{dev_ms['whole']:.4f} / {ms_text(prof_ms['whole'], 4)} ms (bound "
              f"{b_whole[0]:.4f} ms by {b_whole[1]}; plain "
              f"{dev_ms['plain']:.4f}, library {dev_ms['library']:.4f} ms on "
              f"the card), cells "
              f"{dev_ms['cells']:.4f} / {ms_text(prof_ms['cells'], 4)} ms (bound "
              f"{b_cells[0]:.5f} ms; plain {dev_ms['plain_cells']:.4f}), "
              f"points {dev_ms['points']:.4f} / "
              f"{ms_text(prof_ms['points'], 4)} ms (bound {b_points[0]:.5f} ms), "
              f"merge {dev_ms['merge']:.4f} / {ms_text(prof_ms['merge'], 4)} ms; "
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
    from slam_eslam_tpu_torch.utils.kernel_eff import (chain_traffic,
                                                       merge_traffic)

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
    traffic = chain_traffic(pool, pool.chain, queries, cfg.mls_z_window)
    k2 = (k2_err, kernel_times(
        "chain_lookup[100k]", lambda: cl.chain_lookup(*args, **kw),
        lambda: cl.launch(*args, got, **kw), "chain_lookup_kernel",
        lambda: cl.chain_lookup_reference(*args, **kw),
        bound(traffic["bytes"]), n_call=20, n_plain=3, reps=BIG_GRAPH_REPS,
        sectors=traffic["sectors"]))
    k2[1]["sectors_all_levels"] = traffic["sectors_all_levels"]
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
    traffic = merge_traffic(pool, blk, lx, ly)
    uidx = device_index(7, dev)
    k3 = kernel_times(
        "block_merge[100k]",
        lambda: bm.block_merge(*kern, None, *ops, 7, **kw),
        lambda: bm.launch(*kern, None, *ops, uidx, **kw),
        "block_merge_kernel",
        lambda: bm.block_merge_reference(*plain, None, *ops, 7, **kw),
        bound(traffic["bytes"], traffic["flops"]),
        n_call=20, n_plain=3, reps=BIG_GRAPH_REPS, sectors=traffic["sectors"])
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
    expect(detail["warmups"] == 1 and detail["graphs"] == dict(
        eager=1, captured=1, replayed=STEPS * (1 + repeats) - 1), "filter",
        f"warm-up runs {detail['warmups']}, steps {detail['graphs']}: the "
        f"timed runs did not only replay")
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
    # one ordered scan (S1) per resampling update
    expect(detail["run_launches"] == dict(want, contact_fold=runs,
                                          ordered_scan=runs), "filter",
           f"launches in the timed runs {detail['run_launches']}")
    merge_iters = (4 * 20 + 20) * (1 + 3)
    want.update(contact_fold=runs + roofline_iters, block_merge=merge_iters,
                block_copy=len(block_copy.MODES) * merge_iters,
                ordered_scan=runs)
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
          f"graphed steps {detail['graphs']}; {secs:.1f} s [{card}]")
    out = dict(result=result, launches=launches, merge=detail["merge"],
               fold=detail["fold"])

    steps = 20
    result, detail, launches, secs = run_bench(
        ["--fold", "off", "--steps", str(steps)], "fold off")
    want = dict.fromkeys(WRAPPERS, 0)
    expect(detail["run_launches"] == dict(
        want, select_cells=steps * (1 + repeats),
        ordered_scan=steps * (1 + repeats)), "fold off",
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
    so each fires the same gates.  The last (replayed) run is held bit for
    bit to the eager runner from a fresh filter on the same frames."""
    import gc

    from slam_eslam_tpu_torch import bench
    from slam_eslam_tpu_torch.filter import streaming
    from slam_eslam_tpu_torch.utils import tree

    argv = slam_args(n, steps, "bfloat16", extra)
    repeats = int(extra[extra.index("--repeats") + 1]) if extra else 3
    torch.cuda.reset_peak_memory_stats()
    result, detail, launches, secs = run_bench(argv, label)
    peak = torch.cuda.max_memory_allocated()
    carry, aux = detail.pop("carry"), detail["aux"]
    pool = carry.pool
    runs = detail["warmups"] + repeats
    # the last timed run replayed every frame, from a fresh filter: the
    # eager runner on the same frames from a fresh filter gives its bits
    graphed = detail["graphs"]
    expect(graphed["replayed"] >= repeats * detail["frames"], label,
           f"frames {graphed} in {runs} runs: a timed run did not only "
           f"replay")
    cfg = detail["cfg"]
    z0, frames, full, qs = bench.slam_trajectory(steps, CONTACT_CAP)
    dev = pool.meta.device
    gc.collect()       # the bench's graphs and their memory pool
    torch.cuda.empty_cache()
    twin = bench.slam_carry(cfg, z0, dev)
    frames_d = tree.to(frames, dev)
    odos = streaming.precompute_odometry(20, tree.to(full, dev), qs.to(dev),
                                         cfg=cfg)
    # one eager run, after the bench's runs in this process (no warm-up of
    # its own): host syncs forbidden, timed as the bench times a run
    eager_s, ref = bench.timed_run(
        lambda: bench.make_slam_runner(cfg)(twin, frames_d, odos), dev)
    del twin
    same, n_tensors = slam_equal((carry, aux), ref)
    del ref, frames, frames_d
    eager_fps = detail["frames"] / eager_s
    print(f"bench[{label}]: the graphed run vs the eager runner over "
          f"{detail['frames']} frames from a fresh filter: gates, centroids, "
          f"best poses and {n_tensors - 2} filter, pool and alloc_failed "
          f"tensors equal bit for bit: {same} ({detail['warmups']} warm-up "
          f"run(s), frames {graphed}); the eager run "
          f"{eager_s / detail['frames'] * 1e3:.4f} ms/frame = "
          f"{eager_fps:.2f} frames/s, the graphed best "
          f"{min(detail['seconds']) / detail['frames'] * 1e3:.4f} ms/frame")
    expect(same, label, "the graphed run differs from the eager runner")
    expect(result["metric"] == "slam_frames_per_sec"
           and result["pool_dtype"] == "bfloat16" and result["card"] == card
           and pool.mean.dtype == torch.bfloat16 and pool.b == 4 * n
           and pool.n == n, label, f"unexpected result {result}")
    n_meas, n_map = int(aux["updated"].sum()), int(aux["mapped"].sum())
    want = slam_gates_want(aux, cfg, runs)
    expect(launches == want and n_meas and n_map, label,
           f"launches {launches}, gates want {want}")
    patches, failed = check_slam_state(carry, aux, detail["frames"],
                                       f"bench[{label}]")
    expect(failed == 0 and patches == detail["patches"], label,
           f"alloc_failed {failed}, patches {patches}")
    gb = pool.storage_bytes() / 1e9
    if n == BIG_N:
        # a fresh start is written into the runner's pool; at 100,000
        # particles the pool outweighs every other buffer, so a second
        # pool would double the peak (at 4,096 particles the other
        # buffers outweigh the 1.05 GB pool)
        expect(peak < 2 * pool.storage_bytes(), label,
               f"peak allocated {peak / 1e9:.2f} GB holds a second "
               f"{gb:.2f} GB pool")
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
                n_meas=n_meas, n_map=n_map, pool_gb=gb, eager_fps=eager_fps)


def bf16_path(dev):
    """40 frames at 4,096 particles on a bfloat16 pool: the card against
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
    traffic = kernel_eff.merge_traffic(shape, blk, lx, ly)
    b_ms, b_by = bound(traffic["bytes"], traffic["flops"])
    duidx = device_index(uidx, dev)
    packed_launch = lambda: bm.launch_packed(kern, blk, *points, duidx, nx=nx,
                                             **kw)
    unpacked_launch = lambda: bm.launch(*unpacked, None, blk, *points, duidx,
                                        **kw)
    (d_unpacked, d_packed), runs = in_turns_device(unpacked_launch,
                                                   packed_launch)
    prof = profiler_ms(packed_launch, "block_merge_kernel")
    plain_ms, plain_clock, plain_prof = device_ms_of(
        lambda: bm.block_merge_packed_reference(plain, blk, *points, uidx,
                                                nx=nx, **kw))
    print(f"block_merge_packed[probe] device {d_packed:.5f} ms (graph of "
          f"{GRAPH_REPS} launches), {ms_text(prof)} ms (profiler), block_merge on "
          f"the unpacked fields {d_unpacked:.5f} ms (unpacked, packed, "
          f"packed, unpacked: {', '.join(f'{r:.5f}' for r in runs)}), packed "
          f"/ unpacked {d_packed / d_unpacked:.3f}; calls (events around the "
          f"wrappers) {ms['packed']:.4f} ms ({first['packed']:.4f}, "
          f"{second['packed']:.4f}) and {ms['unpacked']:.4f} ms "
          f"({first['unpacked']:.4f}, {second['unpacked']:.4f}), plain "
          f"{plain_ms:.4f} ms on the card ({plain_clock}; profiler "
          f"{ms_text(plain_prof, 4)}), {ms['plain']:.4f} ms a call, bound "
          f"{b_ms:.5f} ms ({b_by})")
    times = dict(
        ms=d_packed, device_ms=d_packed, device_ms_profiler=prof,
        call_ms=ms["packed"], plain_ms=plain_ms, plain_clock=plain_clock,
        plain_ms_profiler=plain_prof, plain_call_ms=ms["plain"],
        bound_ms=b_ms,
        bound_by=b_by, ms_unpacked_in_turns=d_unpacked,
        call_ms_unpacked_in_turns=ms["unpacked"])
    times.update(sector_times("block_merge_packed[probe]", traffic["sectors"],
                              d_packed))
    # K3's other point counts through the packed entry: P4 = K3 on the
    # unpacked fields, bit for bit
    for count in MERGE_POINTS:
        f2, b2, pts2 = kernel_eff.merge_benchmark_operands(
            n, count, nx, ny, k, dev, seed=count)
        image, unpacked = bm.pack_fields(*f2), [f.clone() for f in f2]
        bm.block_merge_packed(image, b2, *pts2, uidx, nx=nx, **kw)
        bm.block_merge(*unpacked, None, b2, *pts2, uidx, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(bm.packed_fields(image, nx), unpacked)):
            raise RuntimeError(f"block_merge_packed[P={count}]: differs from "
                               f"the merge on the unpacked fields")
        t = profiling.device_time(lambda: bm.launch_packed(
            image, b2, *pts2, duidx, nx=nx, **kw)) * 1e3
        print(f"block_merge_packed[P={count}] N={n}: equal bit for bit to "
              f"block_merge on the unpacked fields; device {t:.5f} ms")
        times[f"ms_p{count}"] = t
        del f2, image, unpacked
    return max_err, times


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


def map_filter(cfg, setup, dev, start, graph=False):
    """A fresh per-particle filter on the start map with the surface hash,
    its particles set to the Gaussian cloud ``start``."""
    from slam_eslam_tpu_torch import SurfaceHashConfig
    from slam_eslam_tpu_torch.filter.eslam_filter import EmbodiedSlamFilter
    from slam_eslam_tpu_torch.utils import tree

    f = EmbodiedSlamFilter(config=cfg, device=dev, graph=graph).init(
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
    # the first switch of a process also warns that the mode is a prototype
    syncs = [str(w.message) for w in caught]
    return out, sum("synchroniz" in m and "prototype" not in m for m in syncs)


def map_drive(f, setup, n_frames, labels=None, draws=None, spans=None):
    """The application's loop over the first ``n_frames`` frames (already
    on the filter's device): ``update_contact`` on every frame, host syncs
    forbidden; on a scan frame ``update_scan`` and then
    ``update_distance_image`` with the texture, their host syncs counted.
    ``spans`` collects ``(call, result, host ms, CUDA events, whether it
    replayed a graph)`` of every mapping call.  Returns the gates, the centroids ``[T, 3]`` and the set of
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
        replays = f.graphs.counts().get("replayed", 0)
        ev[0].record()
        t0 = time.perf_counter()
        out, syncs = count_syncs(fn)
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[1].record()
        spans.append((name, out, host_ms, *ev,
                      f.graphs.counts().get("replayed", 0) > replays))
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
            if mapped:
                sync_counts.add(syncs)
            image = projection.DistanceImage(fr.dimg, *consts)
            cam, syncs = timed(
                "update_distance_image", lambda: f.update_distance_image(
                    pose, image, setup["camera"], texture=fr.timg,
                    orientation=fr.q))
            if cam:
                sync_counts.add(syncs)
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


def map_pass(cfg, setup, dev, start, card, number, mode="eager",
             trace=True):
    """One timed pass of the application's loop over all frames from a
    fresh filter, eager or graphed, labels included, as
    ``examples.slam_demo`` drives it: launch counts against the gates, no
    host sync in a mapping update (the pool's failure count is read one
    call later at most, without waiting), the map's state, the host's
    launch calls per frame (``trace``: MAP_LAUNCH_FRAMES more frames under
    ``torch.profiler``).  Returns the pass's numbers and the filter."""
    from slam_eslam_tpu_torch import ops

    n_frames = len(setup["frames"])
    f = map_filter(cfg, setup, dev, start, graph=mode == "graphed")
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
    want.update(chain_lookup=n_meas + n_map, block_merge=n_map + n_cam,
                ordered_scan=n_meas, row_copy=2 * (n_map + n_cam))
    labelled = sum(map_labels(i) is not None for i in range(n_frames))
    expect_launches(launches, want, "mapping path")
    if n_meas < labelled or n_map != SLAM_STEPS or not 1 < n_cam < n_map:
        raise RuntimeError(f"mapping path: {n_meas} measurement updates, "
                           f"{n_map} laser and {n_cam} camera merges")
    if sync_counts != {0}:
        raise RuntimeError(f"mapping path[{mode}]: {sorted(sync_counts)} "
                           f"host syncs in a mapping update (none: the "
                           f"pool's failure count is read without waiting)")
    if f.update_idx != n_map + n_cam or f.steps != n_frames:
        raise RuntimeError(f"mapping path: update_idx {f.update_idx}, steps "
                           f"{f.steps}")
    patches, textured = check_map_state(f, cents, "mapping path")

    def mean_ms(name, which):
        # a graphed pass's calls that replayed (its first meetings run
        # eagerly and capture)
        ms = [which(s) for s in spans
              if s[0] == name and s[1] and (s[5] or mode == "eager")]
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
        image_device_ms=mean_ms("update_distance_image", device),
        gates=gates, cents=cents, f=f, graphs=f.graphs.counts(),
        state=graphs_clone((f.state, f.pool)), update_idx=f.update_idx,
        gen=f.state.generator.get_state())
    out["calls"] = None if not trace else host_launches(
        lambda: map_drive(f, setup, MAP_LAUNCH_FRAMES, labels=map_labels),
        MAP_LAUNCH_FRAMES)
    print(f"mapping path[{mode}, pass {number}]: {n_frames} frames x "
          f"{SLAM_N} particles in {elapsed:.4f} s = {n_frames / elapsed:.2f} "
          f"frames/s, {elapsed / n_frames * 1e3:.4f} ms/frame; "
          f"{n_meas} measurement updates ({labelled} frames with terrain "
          f"labels, {reinjected} hash reinjections), {n_map} laser and "
          f"{n_cam} camera merges; update_scan {out['scan_ms']:.4f} ms on "
          f"the host "
          f"({out['scan_device_ms']:.4f} ms by CUDA events), "
          f"update_distance_image {out['image_ms']:.4f} ms "
          f"({out['image_device_ms']:.4f} ms)"
          + (" over the replayed calls" if mode == "graphed" else "")
          + f"; no host sync in a mapping update; launches {launches}; pool "
          f"{f.pool.storage_bytes() / 1e9:.3f} GB, patches {patches}, "
          f"{textured} with the texture's colour"
          + (f"; {calls_text(out['calls'], 'frame')}" if trace else "")
          + (f"; calls {out['graphs']}" if mode == "graphed" else "")
          + f" [{card}]")
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
    # passes from the same start, eager and graphed in turns: host-bound
    # rates spread, so the range is what one run can say
    order = ["eager", "graphed", "graphed", "eager"][:2 * MAP_PASSES]
    passes = {"eager": [], "graphed": []}
    for number, mode in enumerate(order):
        # the launch calls traced in each mode's last pass
        last = mode not in order[number + 1:]
        passes[mode].append(map_pass(cfg, setup, dev, start, card, number,
                                     mode, trace=last))
        for earlier in passes[mode][:-1]:
            earlier.pop("f", None)
            earlier.pop("state", None)
        torch.cuda.empty_cache()
    e, g = passes["eager"][-1], passes["graphed"][-1]
    same, n_fields = equal_bits((g["state"], g["cents"]),
                                (e["state"], e["cents"]))
    same &= all((g["gates"][k] == e["gates"][k]).all() for k in e["gates"])
    same &= g["update_idx"] == e["update_idx"] and g["launches"] == e[
        "launches"]
    same_gen = torch.equal(g["gen"], e["gen"])
    print(f"mapping path: graphed vs eager over {e['frames']} frames from "
          f"one start: gates, centroids and {n_fields - 1} state and pool "
          f"tensors equal bit for bit: {same}; generator states equal: "
          f"{same_gen}; launches equal: {g['launches'] == e['launches']}")
    if not (same and same_gen):
        raise RuntimeError("mapping path: the graphed run differs from the "
                           "eager run")
    for o in (e, g):
        o.pop("f"), o.pop("state")
    torch.cuda.empty_cache()
    eager = passes["eager"]
    out = dict(eager[-1], rates=[o["frames"] / o["elapsed"] for o in eager],
               scan_ms_range=[o["scan_ms"] for o in eager],
               image_ms_range=[o["image_ms"] for o in eager],
               graphed=dict(
                   rates=[o["frames"] / o["elapsed"]
                          for o in passes["graphed"]],
                   scan_ms_range=[o["scan_ms"] for o in passes["graphed"]],
                   image_ms_range=[o["image_ms"]
                                   for o in passes["graphed"]],
                   launches=g["launches"], calls=g["calls"]))

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


def shared_camera_merge(dev, card, mode="eager"):
    """``update_distance_image`` in shared-map mode at 100,000 particles,
    eager or graphed (the graphs of ``update_contact`` captured before the
    merge read the merged grid, written into its storage).
    The shared 400x400 map starts with a hole (no patches) around the
    robot.  One filter merges a textured image of the ground under the
    robot, under its centroid pose: the camera fills the hole with new
    patches.  Its twin merges the same image through a mount
    ``SHARED_FAR`` m to the side, onto terrain no contact reaches.  At the
    next measurement update only the first filter's contacts find
    patches, and its weights differ from the twin's.  Returns both
    filters' states, grids and generators (copies)."""
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
    filters = {name: app_filter(cfg, grid_d, z0, dev,
                                graph=mode == "graphed") for name in mounts}
    seen, twin = filters["seen"], filters["twin"]
    ops.reset_launch_counts()
    frame, merged_at, contacts = 0, None, {}
    while frame < 40:
        for f in filters.values():
            gate = f.update_contact(poses[frame], tree.index(css_d, frame),
                                    orientation=qs_d[frame])
        frame += 1
        if merged_at is None and gate:
            # a graphed filter merges into its grid's storage
            before = graphs_clone(seen.shared_grid)
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
    print(f"shared camera merge[{mode}]: {N_BENCH} particles, image {h}x{w} "
          f"merged "
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
    want.update(contact_fold=4, ordered_scan=4)
    expect_launches(launches, want, f"shared camera merge[{mode}]")
    return {name: (graphs_clone((f.state, f.shared_grid, f.last_eval)),
                   f.state.generator.get_state())
            for name, f in filters.items()}


def shared_camera_merges(dev, card):
    """The shared-map camera merge eager and graphed, bit for bit."""
    runs = {mode: shared_camera_merge(dev, card, mode)
            for mode in ("eager", "graphed")}
    same, n = equal_bits([v[0] for v in runs["graphed"].values()],
                         [v[0] for v in runs["eager"].values()])
    same_gen = all(torch.equal(runs["graphed"][k][1], runs["eager"][k][1])
                   for k in runs["eager"])
    print(f"shared camera merge: graphed vs eager, both filters' states, "
          f"grids and last_eval ({n} tensors) equal bit for bit: {same}; "
          f"generator states equal: {same_gen}")
    if not (same and same_gen):
        raise RuntimeError("shared camera merge: the graphed run differs "
                           "from the eager run")


def camera_hash_slam(dev, card):
    """``streaming.make_slam_scan_runner`` with the camera (phase 9's
    textured 12x16 image beside every scan, the camera gate letting every
    second one through) and the surface hash (a reinjection every
    MAP_HASH_PERIOD frames) at 4,096 particles over the 200 frames, on the
    mapping path's colour-carrying pool with the scan match and negative
    information: eager and graphed (one graph per combination of the
    measurement, laser, camera and hash gates, captured in warm-up runs)
    from one state and seed, host syncs forbidden in the timed runs; K2,
    K3 and S1 launches against the gates, ms and the host's launch calls
    per frame, the graphed run bit for bit the eager one."""
    from slam_eslam_tpu_torch import ops
    from slam_eslam_tpu_torch.filter import streaming
    from slam_eslam_tpu_torch.utils import tree

    cfg = map_config()
    setup = map_setup()
    frames_d = tree.to(setup["frames"], dev)
    n_frames = len(frames_d)
    start, _ = map_draws(cfg, setup, 0)

    def carry():
        f = map_filter(cfg, setup, dev, start)
        return streaming.StreamingState.create(f.state, f.pool, steps=0), \
            f.hash

    _, hash_ = carry()
    kw = dict(laser2body=setup["laser"], hash_=hash_,
              camera2body=setup["camera"],
              camera_intrinsics=setup["intrinsics"], camera_texture=True)
    window = slice(0, SLAM_LAUNCH_FRAMES)
    runs = {}
    for mode in ("eager", "graphed"):
        run = streaming.make_slam_scan_runner(cfg, graph=mode == "graphed",
                                              **kw)
        # warm-up; the graphed runner meets every gate combination twice
        if mode == "eager":
            run(carry()[0], frames_d.at(slice(0, 30)))
        for _ in range(3 if mode == "graphed" else 0):
            run(carry()[0], frames_d)
            if run.settled():
                break
        c0 = carry()[0]
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        before = run.counts() if mode == "graphed" else None
        torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            out = run(c0, frames_d)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = ops.launch_counts()
        del c0
        aux = out[1]
        n_cam = int(aux["cam_mapped"].sum())
        want = slam_gates_want(aux, cfg)
        want["block_merge"] += n_cam
        want["row_copy"] += 2 * n_cam
        if launches != want or not n_cam:
            raise RuntimeError(f"SLAM camera+hash[{mode}]: launches "
                               f"{launches}, gates want {want}")
        if before is not None and (
                run.counts()["eager"], run.counts()["captured"]) != (
                before["eager"], before["captured"]):
            raise RuntimeError(f"SLAM camera+hash[graphed]: frames "
                               f"{run.counts()}: the timed run did not only "
                               f"replay")
        patches, failed = check_slam_state(out[0], aux, n_frames,
                                           f"SLAM camera+hash[{mode}]")
        runs[mode] = dict(run=run, out=out, elapsed=elapsed,
                          launches=launches, patches=patches, failed=failed)
    (gc_, ga), (ec, ea) = runs["graphed"]["out"], runs["eager"]["out"]
    same, n_tensors = slam_equal((gc_, ga), (ec, ea))
    same &= bool((ga["cam_mapped"] == ea["cam_mapped"]).all())
    same &= all(np.array_equal(getattr(gc_, k), getattr(ec, k))
                for k in ("cam_pos", "cam_q", "map_pos", "ud_pos"))
    combos = sorted({(bool(u), bool(m), bool(c), (i + 1) % MAP_HASH_PERIOD
                      == 0) for i, (u, m, c) in enumerate(zip(
                          ea["updated"], ea["mapped"], ea["cam_mapped"]))})
    print(f"SLAM camera+hash: graphed vs eager over {n_frames} frames from "
          f"one state and seed: gates, centroids, best poses, anchors and "
          f"{n_tensors - 2} filter, pool and alloc_failed tensors equal bit "
          f"for bit: {same}; {len(combos)} gate combinations (measurement, "
          f"laser, camera, hash) met: {combos}")
    if not same:
        raise RuntimeError("SLAM camera+hash: the graphed run differs from "
                           "the eager run")
    n_hash = int(((np.arange(n_frames) + 1) % MAP_HASH_PERIOD == 0).sum())
    for mode, r in runs.items():
        del r["out"]
        # the graphed runner's pool is its own: traced after the comparison
        c1 = carry()[0]
        r["calls"] = host_launches(lambda: r["run"](c1, frames_d.at(window)),
                                   SLAM_LAUNCH_FRAMES)
        del c1
        print(f"SLAM camera+hash[{mode}]: {n_frames} frames x {SLAM_N} "
              f"particles in {r['elapsed']:.4f} s = "
              f"{n_frames / r['elapsed']:.2f} frames/s, "
              f"{r['elapsed'] / n_frames * 1e3:.4f} ms/frame; "
              f"{int(ea['updated'].sum())} measurement, "
              f"{int(ea['mapped'].sum())} laser and "
              f"{int(ea['cam_mapped'].sum())} camera frames, {n_hash} "
              f"reinjections; launches {r['launches']}; patches "
              f"{r['patches']}, alloc_failed {r['failed']}; "
              f"{calls_text(r['calls'], 'frame')}"
              + (f"; frames {r['run'].counts()}" if mode == "graphed"
                 else "") + f" [{card}]")
    return dict(elapsed=runs["eager"]["elapsed"],
                elapsed_graph=runs["graphed"]["elapsed"], frames=n_frames,
                launches=runs["eager"]["launches"],
                launches_graphed=runs["graphed"]["launches"],
                calls=runs["eager"]["calls"],
                calls_graph=runs["graphed"]["calls"])


def phase9(dev, card, profile=None):
    p4_err, p4 = check_merge_packed(dev)
    probe, probe_launches = probe_run()
    print(f"merge probe: merge {probe['merge']['ms']:.4f} ms, merge_packed "
          f"{probe['merge_packed']['ms']:.4f} ms, copy_packed "
          f"{probe['copy_packed']['ms']:.4f} ms (bound "
          f"{probe['copy_packed']['bound_ms']:.4f} ms); launches "
          f"{probe_launches} [{card}]")
    mapping = map_app_path(dev, card, profile)
    shared_camera_merges(dev, card)
    mapping["camera_hash"] = camera_hash_slam(dev, card)
    row = ("block_merge_packed", "tools/probe_merge_overhead.py:212",
           probe_launches["block_merge_packed"], p4_err, p4, None,
           {"probe_ms": probe["merge_packed"]["ms"],
            "probe_merge_ms": probe["merge"]["ms"],
            "probe_copy_packed_ms": probe["copy_packed"]["ms"]})
    return row, mapping


# ---------------------------------------------------------------- phase 10

PG_NODES = 1024
PG_ITERS = 10
PG_CG_ITERS = 64
PG_SEGMENTS, PG_CAP = 8, 32
PG_NODE_ATOL = 1e-3          # m and rad, card vs CPU port
# chi2 history, card vs CPU port: the normal matrix of this 1,024-node ring
# (node 0 pinned) has a condition number of 2.9e5 (dim 3) and 4.0e5 (dim 4)
# at the start, so two float32 factorisations that order their sums
# differently (cuSOLVER, LAPACK) land ~2e-4 apart in the nodes, and chi2,
# quadratic in the residuals, about twice that.  Once a solve has converged
# (DCS: chi2 from ~500 down to ~1e-3), the residuals are within a few
# float32 ulps of the nodes, so chi2 is compared to PG_CHI2_ATOL times the
# history's first value as well
PG_CHI2_RTOL = 1e-3
PG_CHI2_ATOL = 1e-6
ALIGN_CLOUD = 1024           # padded keyframe / probe cloud points
ALIGN_REPS = 20
ONLINE_FRAMES, ONLINE_CHUNK = 200, 50
ONLINE_CHECK_CHUNKS = 2
ONLINE_KEYFRAMES = dict(keyframe_distance=0.1)
SCORE_ATOL = 1e-5
LOCALIZE_STEPS, LOCALIZE_N = 40, 96


def pose_err(a, b):
    """Largest node difference, yaw wrapped (host arrays)."""
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    d[:, -1] = np.arctan2(np.sin(d[:, -1]), np.cos(d[:, -1]))
    return float(np.abs(d).max())


def timed_call(fn):
    """``fn()`` once on the card: ``(result, event ms, host ms, host
    syncs)``."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out, syncs = count_syncs(fn)
    end.record()
    end.synchronize()
    host = (time.perf_counter() - t0) * 1e3
    return out, start.elapsed_time(end), host, syncs


def pose_graph_solvers(dev, card):
    """Dense (plain and DCS), PCG and Schur ``optimize`` on a 1,024-node
    circle graph with loop closures and one outlier closure, ``dim`` 3 and
    4, against the CPU port on the same graph; at dim 3 each also as one
    CUDA graph (``utils.graphs.CallGraphs``, the JAX package's jitted
    solve), bit for bit the eager solve, with ms by CUDA events and the
    host's launch calls both ways."""
    import gc

    from slam_eslam_tpu_torch.backend import pose_graph as pg
    from slam_eslam_tpu_torch.models import sim
    from slam_eslam_tpu_torch.utils import tree

    solvers = {
        "dense": lambda g, cg=None, it=PG_ITERS: pg.optimize(
            g, it, cuda_graphs=cg),
        "dense dcs": lambda g, cg=None, it=PG_ITERS: pg.optimize(
            g, it, robust="dcs", cuda_graphs=cg),
        "pcg": lambda g, cg=None, it=PG_ITERS: pg.optimize_cg(
            g, it, cg_iters=PG_CG_ITERS, cuda_graphs=cg),
        "schur": lambda g, cg=None, it=PG_ITERS: pg.optimize_schur(
            g, it, segments=PG_SEGMENTS, boundary_cap=PG_CAP,
            cuda_graphs=cg),
    }
    out, faults = {}, []
    for dim in (3, 4):
        g_dev, _ = sim.circle_pose_graph(dim, PG_NODES, seed=2,
                                         outlier=True, device=dev)
        g_cpu = tree.to(g_dev, "cpu")
        for name, solve in solvers.items():
            solve(g_dev)                                 # warm-up
            (res, hist), ms, host_ms, syncs = timed_call(
                lambda: solve(g_dev))
            t_cpu = time.perf_counter()
            ref, ref_hist = solve(g_cpu)
            t_cpu = time.perf_counter() - t_cpu
            err = pose_err(res.nodes.cpu(), ref.nodes)
            hist, ref_hist = hist.cpu().numpy(), ref_hist.numpy()
            rel = np.abs(hist - ref_hist) / np.maximum(np.abs(ref_hist),
                                                       1e-30)
            chi2_rel = float(rel.max())
            print(f"pose graph[dim {dim}, {PG_NODES} nodes] {name}: "
                  f"{ms:.4f} ms per optimize on the card (events), "
                  f"{host_ms:.4f} ms host clock, {syncs} host syncs; vs CPU "
                  f"port: nodes {err:.3e}, chi2 rel {chi2_rel:.3e} at "
                  f"iteration {int(rel.argmax())} (chi2 {ref_hist[0]:.6g} -> "
                  f"{ref_hist[-1]:.6g}); the CPU port's solve took "
                  f"{t_cpu:.1f} s [{card}]")
            tag = f"pose graph {name} dim {dim}"
            if not (np.isfinite(hist).all()
                    and bool(torch.isfinite(res.nodes).all())):
                faults.append(f"{tag}: non-finite result")
            if err > PG_NODE_ATOL or not np.allclose(
                    hist, ref_hist, rtol=PG_CHI2_RTOL,
                    atol=PG_CHI2_ATOL * abs(ref_hist[0])):
                faults.append(f"{tag}: card and CPU differ (nodes {err}, "
                              f"chi2 {chi2_rel})")
            if syncs:
                faults.append(f"{tag}: {syncs} host syncs")
            gms = calls = None
            if dim == 3:
                # graphed at dim 3 (dim 4: tests/test_torch_cuda.py)
                gms, calls = graphed_solve(solve, g_dev, res, hist, name,
                                           faults, card)
            out[f"{name} {dim}"] = dict(ms=ms, host_ms=host_ms, syncs=syncs,
                                        err=err, chi2_rel=chi2_rel,
                                        graphed_ms=gms, calls=calls)
            gc.collect()
            torch.cuda.empty_cache()
    if faults:
        raise RuntimeError("; ".join(faults))
    return out


def graphed_solve(solve, g_dev, res, hist, name, faults, card):
    """``solve`` as one CUDA graph (eager at its first call, captured at
    its second): the timed replay bit for bit the eager ``(res, hist)``,
    no host sync; ms by CUDA events and the host's launch calls of one
    graphed solve and of one eager Gauss-Newton iteration (the profiler's
    pass over a whole eager PCG solve, ~27,000 launches, takes seconds;
    the iterations of a solve are alike).  Returns ``(ms, calls)``."""
    from slam_eslam_tpu_torch.utils import graphs

    cg = graphs.CallGraphs(graphs.Capture(), f"pose graph {name}")
    solve(g_dev, cg)                                     # eager meeting
    solve(g_dev, cg)                                     # captured
    (gres, ghist), ms, host_ms, syncs = timed_call(lambda: solve(g_dev, cg))
    equal, _ = equal_bits((gres, ghist), (res, torch.from_numpy(hist).to(
        ghist.device)))
    calls = {"eager": host_launches(lambda: solve(g_dev, None, 1), 1),
             "graphed": host_launches(lambda: solve(g_dev, cg), 1)}
    print(f"pose graph[dim 3, {PG_NODES} nodes] {name} graphed: {ms:.4f} ms "
          f"per optimize (events), {host_ms:.4f} ms host clock, {syncs} host "
          f"syncs, graphs {cg.counts()}; equal bit for bit to the eager "
          f"solve: {equal}; eager "
          f"{calls_text(calls['eager'], 'Gauss-Newton iteration')} "
          f"({PG_ITERS} an optimize); graphed "
          f"{calls_text(calls['graphed'], 'optimize')} [{card}]")
    if syncs or not equal:
        faults.append(f"pose graph {name} graphed: {syncs} host syncs, "
                      f"equal to eager {equal}")
    return ms, calls


def terrain_cloud(terrain, pose, n_valid, seed, dev):
    """A padded ``ALIGN_CLOUD``-point cloud of terrain samples around the
    true ``pose = (x, y, yaw, z)``, in the body frame."""
    from slam_eslam_tpu_torch.mapping.mls_grid import PatchCloud

    rng = np.random.default_rng(seed)
    local = np.zeros((ALIGN_CLOUD, 2), np.float32)
    local[:n_valid] = rng.uniform(-3.0, 3.0, (n_valid, 2))
    c, s = np.cos(pose[2]), np.sin(pose[2])
    wx = c * local[:, 0] - s * local[:, 1] + pose[0]
    wy = s * local[:, 0] + c * local[:, 1] + pose[1]
    z = (terrain(wx, wy) - pose[3]).astype(np.float32)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    return PatchCloud.create(
        xy=f32(local), z=f32(z), stdev=f32(np.full(ALIGN_CLOUD, 0.05)),
        valid=torch.tensor(np.arange(ALIGN_CLOUD) < n_valid, device=dev))


def scan_align_sweeps(dev, card):
    """``KeyframeManager``'s closure sweep (9x9x7 around a 48x48 keyframe
    grid at 0.2 m, k = 2) and a 31x31x7 coarse stage, 1,024-point clouds,
    card against the CPU port; on the card each sweep and the keyframe
    grid's merge also as CUDA graphs (``KeyframeManager(graph=)``, the
    JAX package's jitted seams), bit for bit the eager ones."""
    from slam_eslam_tpu_torch.backend import pose_graph as pg
    from slam_eslam_tpu_torch.backend.keyframes import (Keyframe,
                                                        KeyframeManager)
    from slam_eslam_tpu_torch.examples.loop_closure_demo import terrain

    sweeps = {"fine 9x9x7": dict(search_xy=0.5, steps_xy=9, sigma=0.2,
                                 return_ratio=True),
              "coarse 31x31x7": dict(search_xy=1.5, steps_xy=31, sigma=0.4,
                                     return_ratio=True)}
    out, res = {}, {}
    for d in ("cpu", dev):
        km = KeyframeManager(device=d, graph=False)
        kf_pose = np.array([0.3, -0.2, 0.1])
        kf = Keyframe(0, 0, kf_pose, terrain_cloud(
            terrain, (*kf_pose, 0.2), 900, 11, d), 0.2)
        grid = km._kf_grid(kf)
        probe = terrain_cloud(terrain, (0.5, -0.3, 0.15, 0.2), 800, 12, d)
        if d == dev:
            gkm = KeyframeManager(device=d)      # graphs, the default
            grids = [gkm._kf_grid(kf) for _ in range(3)]
            grid_equal = all(equal_bits(g, grid)[0] for g in grids)
        for name, kw in sweeps.items():
            call = lambda cg=None: pg.scan_align(
                grid, probe, km._f32([0.3, -0.2]), km._f32(0.1),
                km._f32(0.2), search_yaw=0.3, steps_yaw=7, cuda_graphs=cg,
                **kw)
            eager = call()
            res[(str(d), name)] = [float(v) for v in torch.cat(
                [t.reshape(-1) for t in eager]).tolist()]
            if d == dev:
                call()
                ms = cuda_ms(call, ALIGN_REPS)
                cg = gkm.cuda_graphs
                graphed = [call(cg) for _ in range(3)]
                equal = all(equal_bits(g, eager)[0] for g in graphed)
                gms = cuda_ms(lambda: call(cg), ALIGN_REPS)
                lookups = 7 * kw["steps_xy"] ** 2 * ALIGN_CLOUD
                out[name] = dict(ms=ms, lookups_per_s=lookups / ms * 1e3,
                                 graphed_ms=gms, graphed_equal=equal)
    for name in sweeps:
        a, b = res[(str(dev), name)], res[("cpu", name)]
        same = max(abs(x - y) for x, y in zip(a[:3], b[:3])) <= 1e-6
        diffs = [abs(x - y) for x, y in zip(a[3:], b[3:])]
        o = out[name]
        print(f"scan_align[{name}, {ALIGN_CLOUD} points]: best (x, y, yaw) "
              f"= ({a[0]:.4f}, {a[1]:.4f}, {a[2]:.4f}) "
              f"{'equal to' if same else 'DIFFERS from'} the CPU port's, "
              f"score {a[3]:.6f} ratio {a[4]:.4f} (vs CPU {diffs[0]:.2e}, "
              f"{diffs[1]:.2e}); {o['ms']:.4f} ms per sweep, "
              f"{o['lookups_per_s']:.4g} lookups/s; graphed "
              f"{o['graphed_ms']:.4f} ms per sweep, equal bit for bit to "
              f"the eager sweep: {o['graphed_equal']} [{card}]")
        if not same or max(diffs) > SCORE_ATOL or not o["graphed_equal"]:
            raise RuntimeError(f"scan_align {name}: card and CPU differ, or "
                               f"graphed and eager")
    counts = gkm.cuda_graphs.counts()
    print(f"keyframe grid merge graphed: equal bit for bit to the eager "
          f"merge over 3 calls: {grid_equal}; the keyframe graphs {counts} "
          f"[{card}]")
    if not grid_equal or not counts.get("replayed"):
        raise RuntimeError("keyframe grid: graphed and eager differ")
    return out


def closure_demo(dev, card):
    from slam_eslam_tpu_torch.examples.loop_closure_demo import closure_run

    quiet = lambda *a, **k: None
    ref = closure_run("cpu", log=quiet)
    t0 = time.perf_counter()
    got = closure_run(dev, log=quiet)
    seconds = time.perf_counter() - t0
    print(f"loop_closure_demo: closures {got['closures']}, max |y| drift "
          f"{got['err_before']:.4f} m before and {got['err_after']:.4f} m "
          f"after optimisation, {seconds:.3f} s on the card; CPU port "
          f"closures {[c[:2] for c in ref['closures']]} [{card}]")
    if ([c[:2] for c in got["closures"]] != [c[:2] for c in ref["closures"]]
            or not got["closures"]
            or max(abs(a[2] - b[2]) for a, b in zip(
                got["closures"], ref["closures"])) > SCORE_ATOL
            or not got["err_after"] < got["err_before"]):
        raise RuntimeError("loop_closure_demo: closures or drift differ")


def online_slam(cfg, z0, normals, device, graph=False):
    from slam_eslam_tpu_torch.online import OnlineSlam

    s = OnlineSlam(config=cfg, laser2body=(np.eye(3), np.zeros(3)),
                   keyframe_kw=ONLINE_KEYFRAMES, device=device, graph=graph)
    return s.init(pose=(np.array([0.0, 0.0, z0]), 0.0),
                  num_contact_points=20, normal_xy=normals[0].to(device),
                  normal_yaw=normals[1].to(device))


def online_path(dev, card):
    """``OnlineSlam`` at phase 6's geometry over the bench stream (full
    contacts: ``run_stream`` runs the odometry itself), in chunks, eager;
    a checkpoint after the first chunk, restored into a fresh filter that
    runs the second chunk again; then the same chunks graphed (the
    default: ``run_stream``, the keyframe grids and sweeps and the solve
    as CUDA graphs), each chunk and solve bit for bit the eager one."""
    import tempfile

    from slam_eslam_tpu_torch import bench
    from slam_eslam_tpu_torch.filter.eslam_filter import EmbodiedSlamFilter
    from slam_eslam_tpu_torch.ops import block_merge as bm
    from slam_eslam_tpu_torch.ops import chain_lookup as cl
    from slam_eslam_tpu_torch.utils import checkpoint as ckpt
    from slam_eslam_tpu_torch.utils import tree

    cfg = slam_config()
    z0, frames, _, _ = bench.slam_trajectory(ONLINE_FRAMES // 10, 0)
    normals, draws = slam_draws(ONLINE_FRAMES)
    chunks = [(frames.at(slice(c, c + ONLINE_CHUNK)),
               draws[c:c + ONLINE_CHUNK])
              for c in range(0, ONLINE_FRAMES, ONLINE_CHUNK)]
    on_dev = lambda ds: [tree.to(x, dev) for x in ds]
    s = online_slam(cfg, z0, normals, dev)
    stream_s = []
    run_stream = s.filter.run_stream

    def timed_stream(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aux = run_stream(*a, **kw)
        torch.cuda.synchronize()
        stream_s.append(time.perf_counter() - t0)
        return aux

    s.filter.run_stream = timed_stream
    tmp = tempfile.TemporaryDirectory()
    path = Path(tmp.name) / "filter.pt"
    rows, launches, auxes = [], {"chain_lookup": 0, "block_merge": 0}, []
    solved = []
    for c, (fr, dr) in enumerate(chunks):
        cl.chain_lookup.launches = 0
        bm.block_merge.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aux = s.process_chunk(fr, draws=on_dev(dr))
        torch.cuda.synchronize()
        chunk_s = time.perf_counter() - t0
        got = {"chain_lookup": cl.chain_lookup.launches,
               "block_merge": bm.block_merge.launches}
        n_meas, n_map = int(aux["updated"].sum()), int(aux["mapped"].sum())
        want = {"chain_lookup": n_meas + (n_map if cfg.use_visual_update
                                          else 0), "block_merge": n_map}
        if got != want or not n_map:
            raise RuntimeError(f"OnlineSlam chunk {c}: launches {got}, gates "
                               f"want {want}")
        for k in launches:
            launches[k] += got[k]
        t1 = time.perf_counter()
        traj, hist = s.optimize()
        torch.cuda.synchronize()
        opt_s = time.perf_counter() - t1
        n_kf = len(s.keyframes.keyframes)
        if not np.isfinite(traj[:n_kf]).all() or not bool(
                torch.isfinite(hist).all()):
            raise RuntimeError(f"OnlineSlam chunk {c}: non-finite optimize")
        rows.append(dict(stream=stream_s[-1], keyframe=chunk_s - stream_s[-1],
                         optimize=opt_s, keyframes=n_kf, iters=hist.shape[0]))
        solved.append((traj, hist.clone()))
        print(f"OnlineSlam chunk {c}: {ONLINE_CHUNK} frames x {SLAM_N} "
              f"particles, {n_meas} measurement and {n_map} mapping frames, "
              f"launches {got}; run_stream {stream_s[-1] * 1e3:.2f} ms, "
              f"keyframe extraction + alignment "
              f"{(chunk_s - stream_s[-1]) * 1e3:.2f} ms, optimize "
              f"{opt_s * 1e3:.2f} ms ({hist.shape[0]} iterations); "
              f"keyframes {n_kf}, closures {len(s.keyframes.closures)} "
              f"[{card}]")
        auxes.append(aux)
        if c == 0:
            t1 = time.perf_counter()
            ckpt.save_filter(path, s.filter)
            save_s = time.perf_counter() - t1
        if c == 1:
            snap = dict(centroid=aux["centroid"].clone(),
                        best_pose=aux["best_pose"].clone(),
                        particles=tree.tree_map(torch.clone,
                                                s.filter.state.particles),
                        pool={f: getattr(s.filter.pool, f).clone()
                              for f in ("mean", "stdev", "height", "meta",
                                        "origin", "chain", "allocated")},
                        update_idx=s.filter.update_idx)
    n_kf = len(s.keyframes.keyframes)
    _, again = s.optimize()
    if n_kf < 2 or again.shape != (0,):
        raise RuntimeError(f"OnlineSlam: {n_kf} keyframes, second optimize "
                           f"ran {again.shape[0]} iterations")
    kf_frames, kf_poses = list(s.keyframe_frames), [
        k.pose for k in s.keyframes.keyframes]
    print(f"OnlineSlam: {ONLINE_FRAMES} frames in {len(chunks)} chunks of "
          f"{ONLINE_CHUNK}: keyframes at frames {kf_frames}, closures "
          f"{s.keyframes.closures}, launches {launches}, incremental DCS "
          f"optimize finite, second call a no-op [{card}]")
    del s

    # ---- the checkpoint, restored into a fresh filter on the card ----
    size = path.stat().st_size
    g = EmbodiedSlamFilter(config=cfg, device=dev, graph=False).init(
        pose=(np.array([0.5, 0.5, z0]), 0.3), use_shared_map=False,
        num_contact_points=20)
    t1 = time.perf_counter()
    ckpt.restore_filter(path, g)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t1
    tmp.cleanup()
    aux = g.run_stream(tree.to(chunks[1][0], dev),
                       laser2body=(np.eye(3), np.zeros(3)),
                       draws=on_dev(chunks[1][1]))
    differ = [name for name, a, b in (
        ("centroid", aux["centroid"], snap["centroid"]),
        ("best_pose", aux["best_pose"], snap["best_pose"]),
        *((f"particles.{f}", getattr(g.state.particles, f),
           getattr(snap["particles"], f))
          for f in ("x", "y", "yaw", "z", "z_sigma", "weight")),
        *((f"pool.{f}", getattr(g.pool, f), snap["pool"][f])
          for f in snap["pool"])) if not torch.equal(a, b)]
    print(f"checkpoint: {size / 1e6:.1f} MB, save {save_s:.3f} s, restore "
          f"{restore_s:.3f} s; chunk 1 again from the restored filter: "
          + ("equal bit for bit" if not differ else
             f"differs in {differ}") + f" [{card}]")
    if differ and not all(name.startswith(("pool.mean", "pool.stdev",
                                           "pool.height")) for name in differ):
        raise RuntimeError(f"checkpoint resume differs in {differ}")
    del g

    # ---- the first chunks against the CPU port on identical draws ----
    ref = online_slam(cfg, z0, normals, "cpu")
    for c in range(ONLINE_CHECK_CHUNKS):
        fr, dr = chunks[c]
        raux = ref.process_chunk(fr, draws=dr)
        for name in ("updated", "mapped"):
            if not (raux[name] == auxes[c][name]).all():
                raise RuntimeError(f"OnlineSlam chunk {c}: {name} gates "
                                   f"differ from the CPU port's")
        err = float((auxes[c]["centroid"].cpu() - raux["centroid"]).abs()
                    .max())
        if err > CENTROID_ATOL:
            raise RuntimeError(f"OnlineSlam chunk {c}: centroids differ by "
                               f"{err} m")
    n = len(ref.keyframes.keyframes)
    pose_diff = max((float(np.abs(a - b.pose).max())
                     for a, b in zip(kf_poses, ref.keyframes.keyframes)),
                    default=0.0)
    print(f"OnlineSlam: GPU vs CPU port over {ONLINE_CHECK_CHUNKS} chunks: "
          f"keyframe frames {ref.keyframe_frames} (card "
          f"{kf_frames[:n]}), keyframe poses {pose_diff:.3e}, closures "
          f"{ref.keyframes.closures} [{card}]")
    if (ref.keyframe_frames != kf_frames[:n] or pose_diff > CENTROID_ATOL
            or n < 1):
        raise RuntimeError("OnlineSlam: keyframes differ from the CPU port")
    del ref
    graphed = online_graphed(cfg, z0, normals, chunks, auxes, solved, dev,
                             card)
    if graphed["keyframe_frames"] != kf_frames:
        raise RuntimeError("OnlineSlam graphed: keyframes differ")
    return dict(rows=rows, launches=launches, keyframes=len(kf_frames),
                ckpt_mb=size / 1e6, save_s=save_s, restore_s=restore_s,
                differ=differ, graphed=graphed)


def online_graphed(cfg, z0, normals, chunks, auxes, solved, dev, card):
    """The chunks of ``online_path`` through ``OnlineSlam``'s default on
    the card (CUDA graphs for ``run_stream``, the keyframe grids and
    sweeps and the solve): each chunk's parts timed, its outputs and its
    solve bit for bit the eager chunk's (``auxes``, ``solved``)."""
    from slam_eslam_tpu_torch.utils import tree

    s = online_slam(cfg, z0, normals, dev, graph=None)
    stream_s, rows, same = [], [], True
    run_stream = s.filter.run_stream

    def timed_stream(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aux = run_stream(*a, **kw)
        torch.cuda.synchronize()
        stream_s.append(time.perf_counter() - t0)
        return aux

    s.filter.run_stream = timed_stream
    for c, (fr, dr) in enumerate(chunks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aux = s.process_chunk(fr, draws=[tree.to(x, dev) for x in dr])
        torch.cuda.synchronize()
        chunk_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        traj, hist = s.optimize()
        torch.cuda.synchronize()
        opt_s = time.perf_counter() - t1
        equal = (equal_bits((aux["centroid"], aux["best_pose"]),
                            (auxes[c]["centroid"], auxes[c]["best_pose"]))[0]
                 and np.array_equal(traj, solved[c][0])
                 and equal_bits(hist, solved[c][1])[0])
        same = same and equal
        rows.append(dict(stream=stream_s[-1], keyframe=chunk_s - stream_s[-1],
                         optimize=opt_s))
        print(f"OnlineSlam[graphed] chunk {c}: run_stream "
              f"{stream_s[-1] * 1e3:.2f} ms, keyframe extraction + "
              f"alignment {(chunk_s - stream_s[-1]) * 1e3:.2f} ms, optimize "
              f"{opt_s * 1e3:.2f} ms ({hist.shape[0]} iterations); equal bit "
              f"for bit to the eager chunk and solve: {equal} [{card}]")
    runner, = s.filter._runners.values()
    counts = dict(stream=runner.counts(),
                  keyframes=s.keyframes.cuda_graphs.counts(),
                  solve={str(k): v.counts() for k, v in
                         s.keyframes.builder.cuda_graphs.items()})
    print(f"OnlineSlam[graphed]: graphed {s.graphed}, {len(chunks)} chunks "
          f"equal bit for bit to the eager chunks: {same}; graphs {counts} "
          f"[{card}]")
    if not (same and s.graphed):
        raise RuntimeError("OnlineSlam: graphed and eager chunks differ")
    return dict(rows=rows, counts=counts,
                keyframe_frames=list(s.keyframe_frames))


def localize_draws(n, steps, seed=3):
    from slam_eslam_tpu_torch.filter import pose_estimator as pe

    gen = torch.Generator().manual_seed(seed)
    normals = (torch.randn((n, 2), generator=gen),
               torch.randn((n,), generator=gen))
    return normals, [(pe.ProjectDraws.sample(n, gen, "cpu"),
                      torch.rand(n, generator=gen)) for _ in range(steps)]


def localize_run(dev, card):
    """``examples.localize_demo`` in process on one set of draws: its step
    as a CUDA graph (the default on the card) and eagerly, the graphed run
    equal to the eager one bit for bit, K5 once a step in each (credited
    by the replays when graphed), and the centroids against the CPU
    port."""
    from slam_eslam_tpu_torch.examples.localize_demo import localize
    from slam_eslam_tpu_torch.ops import contact_fold as cf
    from slam_eslam_tpu_torch.ops import select_cells as sc

    quiet = lambda *a, **k: None
    draws = localize_draws(LOCALIZE_N, LOCALIZE_STEPS)
    ref = localize(LOCALIZE_STEPS, LOCALIZE_N, "cpu", draws, log=quiet)
    want = {"select_cells": LOCALIZE_STEPS, "contact_fold": 0}
    runs = {}
    for mode, graph in (("eager", False), ("graphed", None)):
        sc.select_cells.launches = 0
        cf.contact_fold.launches = 0
        got = localize(LOCALIZE_STEPS, LOCALIZE_N, dev, draws, log=quiet,
                       graph=graph)
        launches = {"select_cells": sc.select_cells.launches,
                    "contact_fold": cf.contact_fold.launches}
        err = float(np.abs(got["centroids"] - ref["centroids"]).max())
        print(f"localize_demo[{mode}]: {LOCALIZE_STEPS} steps x "
              f"{LOCALIZE_N} particles in {got['seconds']:.3f} s, launches "
              f"{launches}, final-10 mean xy ATE "
              f"{got['errors'][-10:, 0].mean():.4f} m, z "
              f"{got['errors'][-10:, 1].mean():.4f} m; GPU vs CPU port "
              f"{err:.3e} m [{card}]")
        if got["graphed"] != (graph is None):
            raise RuntimeError(f"localize_demo[{mode}]: graphed "
                               f"{got['graphed']}")
        if launches != want:
            raise RuntimeError(f"localize_demo[{mode}]: launches {launches}")
        if not err <= CENTROID_ATOL:
            raise RuntimeError(f"localize_demo[{mode}]: GPU and CPU differ "
                               f"by {err} m")
        runs[mode] = got
    got, eager = runs["graphed"], runs["eager"]
    same = (equal_bits(got["state"], eager["state"])[0]
            and np.array_equal(got["centroids"], eager["centroids"])
            and got["ess"] == eager["ess"]
            and got["resampled"] == eager["resampled"]
            and torch.equal(got["state"].generator.get_state(),
                            eager["state"].generator.get_state()))
    print(f"localize_demo: graphed vs eager over {LOCALIZE_STEPS} steps "
          f"(centroids, ESS, resampling, final state, generator) equal bit "
          f"for bit: {same} [{card}]")
    if not same:
        raise RuntimeError("localize_demo: graphed and eager differ")
    return dict(launches=want, err=err, seconds=got["seconds"],
                eager_seconds=eager["seconds"])


def phase10(dev, card):
    """The loop-closure backend and the full-stack loop on the card."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    parts, t0 = {}, time.perf_counter()

    def part(name, fn):
        nonlocal t0
        res = fn()
        parts[name] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()
        return res

    out = dict(solvers=part("solvers", lambda: pose_graph_solvers(dev, card)),
               align=part("sweeps", lambda: scan_align_sweeps(dev, card)))
    part("closure demo", lambda: closure_demo(dev, card))
    out["online"] = part("OnlineSlam", lambda: online_path(dev, card))
    out["localize"] = part("localize demo", lambda: localize_run(dev, card))
    print(f"phase 10 seconds by part: {parts} [{card}]")
    return out


# ---------------------------------------------------------------------------
# phase 11: the log runtime and the record -> replay -> report path
# ---------------------------------------------------------------------------

# examples.full_demo at the SLAM bench's 4,096 particles and its four blocks
# per particle (a 2.94 GB float32 pool with colour); the rest at the demo's
# defaults: 48 scans, 481 frames, camera and texture, chunks of 60
FULL_DEMO_ARGS = ("--particles", "4096", "--pool-blocks", "16384")
DEMO_LAUNCH_FRAMES = 20              # run_stream frames traced for launches
REPLAY_N = 100_000                   # the application's size (phase 7)
REPLAY_CHECK_N, REPLAY_CHECK_FRAMES = 4096, 20
# the demo's default route closes no loop: one keyframe a chunk gives at
# most 8 keyframes, and the automatic min separation of 8 lets keyframe i
# look only before i - 8 (PERF.md, section 6).  This route drives the
# out-and-back twice (4 legs, 8-step U-turns) at 0.8 rad a step: 961
# frames, 16 chunks of 60, revisits of lap 1 on lap 2
CLOSURE_ROUTE = ("--steps", "96", "--wheel-delta", "0.8", "--legs", "4",
                 "--turn-steps", "8")
LAYER_RISE_MAX = 64 << 20            # bytes chain_layers may add on the card
# chi2 below this is float32 rounding: a consistent chain of a few metres
# leaves residuals of ~1e-7 at an information of 1e4 per edge (the lab's
# policies without priors or closures end there)
CHI2_ZERO = 1e-6


def tree_snapshot(root):
    """``{path: (size, mtime_ns)}`` of every file under ``root``."""
    return {str(p): (p.stat().st_size, p.stat().st_mtime_ns)
            for p in sorted(root.rglob("*")) if p.is_file()}


def native_library(card):
    """(a) The port's own build of ``native/eslam_log.cpp``."""
    from slam_eslam_tpu_torch.io import logio
    from slam_eslam_tpu_torch.ops import _build

    path = logio.library_path()
    t0 = time.perf_counter()
    logio.lib()
    seconds = time.perf_counter() - t0
    if _build.BUILD_DIR not in path.parents or not path.exists():
        raise RuntimeError(f"native log library at {path}, not built under "
                           f"{_build.BUILD_DIR}")
    print(f"native log library: {path.relative_to(Path.cwd())} built in "
          f"{seconds:.2f} s with g++ {' '.join(logio.CXX_FLAGS)} [{card}]")


def log_round_trip(tmp, card):
    """(b) Every record type written and read back equal; select, gather,
    compact, load_stream; the feeder in order."""
    from slam_eslam_tpu_torch.core.state import BodyContactState
    from slam_eslam_tpu_torch.io import logio

    rng = np.random.default_rng(11)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    cs = BodyContactState.create(
        f32(6, 3), contact=f32(6), slip=f32(6),
        group_id=rng.integers(-1, 3, 6).astype(np.int32))
    q, pos, ranges = f32(4), f32(3), f32(180)
    dimg, tex = f32(12, 16), rng.uniform(size=(12, 16, 3)).astype(np.float32)
    intr = (0.09, 0.08, -0.675, -0.44)
    path = tmp / "all.eslg"
    with logio.LogWriter(path) as w:
        w.write_contact_state(cs, 10)
        w.write_orientation(q, 20)
        w.write_scan(ranges, -2.356, 0.026, 30)
        w.write_pose(pos, q, 40)
        w.write_distance_image(dimg, *intr, 50)
        w.write_texture_image(tex, 60)
    faults = []
    with logio.LogReader(path) as r:
        recs = [r.get(i) for i in range(len(r))]
    if [(t, ts) for t, ts, _ in recs] != [(i, 10 * i) for i in range(1, 7)]:
        faults.append(f"record types/timestamps {[rec[:2] for rec in recs]}")
    got = logio.decode_contact_state(recs[0][2])
    for name in ("position", "contact", "slip", "group_id", "valid"):
        if not torch.equal(getattr(got, name), getattr(cs, name)):
            faults.append(f"contact state {name}")
    scan = logio.decode_scan(recs[2][2])
    image = logio.decode_distance_image(recs[4][2])
    for label, a, b in (
            ("orientation", logio.decode_orientation(recs[1][2]), q),
            ("scan", scan[0], ranges),
            ("scan meta", scan[1:], np.float32([-2.356, 0.026])),
            ("pose", np.concatenate(logio.decode_pose(recs[3][2])),
             np.concatenate([pos, q])),
            ("distance image", image[0], dimg),
            ("intrinsics", image[1:], np.float32(intr)),
            ("texture", logio.decode_texture_image(recs[5][2]), tex)):
        if not np.array_equal(np.asarray(a, np.float32), b):
            faults.append(label)

    # a traverse: contact + orientation + pose per frame, a scan and an
    # image on every fourth
    path = tmp / "traverse.eslg"
    n, every = 40, 4
    with logio.LogWriter(path) as w:
        for i in range(n):
            ts = 1000 + 10 * i
            w.write_contact_state(dataclasses.replace(
                cs, position=cs.position + i), ts)
            w.write_orientation([1.0, 0, 0, float(i)], ts)
            w.write_pose([float(i), 0, 0], [1, 0, 0, 0], ts)
            if i % every == every - 1:
                w.write_scan(np.full(8, 2.0 + i), -0.5, 0.1, ts + 1)
                w.write_distance_image(np.full((12, 16), 1.0 + i), *intr,
                                       ts + 1)
    with logio.LogReader(path) as r:
        idx, ts = r.select(logio.ORIENTATION)
        quats = np.frombuffer(r.gather(idx, 16).tobytes(),
                              np.float32).reshape(-1, 4)
        if (r.count_type(logio.CONTACT_STATE) != n
                or not np.array_equal(ts, 1000 + 10 * np.arange(n))
                or not np.array_equal(quats[:, 3], np.arange(n))):
            faults.append("select/gather")
    dst = tmp / "compacted.eslg"
    kept = logio.compact(path, dst, types=(logio.CONTACT_STATE,
                                           logio.ORIENTATION), stride=2)
    with logio.LogReader(dst) as r:
        idx, _ = r.select(logio.CONTACT_STATE)
        second = logio.decode_contact_state(r.get(int(idx[1]))[2])
        if (kept != n or r.count_type(logio.POSE) != 0
                or r.count_type(logio.ORIENTATION) != n // 2
                or not torch.equal(second.position, cs.position + 2)):
            faults.append("compact")
    s = logio.load_stream(path)
    marked = np.arange(every - 1, n, every)
    if (s["contact"].shape != (n, 6) or s["pose"].shape != (n, 7)
            or not np.array_equal(np.nonzero(s["has_scan"])[0], marked)
            or not np.array_equal(np.nonzero(s["has_dimg"])[0], marked)
            or not np.array_equal(s["scan_ranges"][marked, 0], 2.0 + marked)
            or not np.array_equal(s["dimg"][marked, 0, 0], 1.0 + marked)
            or s["dimg_meta"] != tuple(float(np.float32(v)) for v in intr)):
        faults.append("load_stream")
    with logio.LogReader(path) as r, logio.AsyncFeeder(r, slots=4) as feed:
        order = [(t, ts) for t, ts, _ in feed]
    with logio.LogReader(path) as r:
        if order != [r.get(i)[:2] for i in range(len(r))]:
            faults.append("AsyncFeeder order")
    print(f"log round trip: 6 record types equal, select/gather, compact "
          f"({kept} records), load_stream ({n} frames, {len(marked)} scans "
          f"and images), the feeder in order over {len(order)} records"
          + (f"; FAULTS {faults}" if faults else "") + f" [{card}]")
    if faults:
        raise RuntimeError(f"log round trip: {faults}")


def frames_equal(a, b):
    """The ``SlamFrames`` fields that differ between ``a`` and ``b`` (the
    tensors compared on the host, bit for bit)."""
    differ = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "contact":
            differ += [f"contact.{g}" for g in ("position", "contact", "slip",
                                                "group_id", "valid")
                       if not torch.equal(getattr(x, g).cpu(),
                                          getattr(y, g).cpu())]
        elif isinstance(x, torch.Tensor):
            if not torch.equal(x.cpu(), y.cpu()):
                differ.append(f.name)
        elif not np.array_equal(x, y):
            differ.append(f.name)
    return differ


def demo_draws(n, n_frames, seed=5):
    """Seeded start normals and per-frame ``StepDraws``, on the host."""
    from slam_eslam_tpu_torch.filter import pose_estimator as pe
    from slam_eslam_tpu_torch.filter.step import StepDraws

    gen = torch.Generator().manual_seed(seed)
    normals = (torch.randn((n, 2), generator=gen),
               torch.randn((n,), generator=gen))
    return normals, [StepDraws(pe.ProjectDraws.sample(n, gen, "cpu"),
                               torch.rand(n, generator=gen))
                     for _ in range(n_frames)]


def layers_agree(got, ref):
    """``chain_layers`` of the card against the CPU port's: the same
    blocks, cells with a patch within PATCH_COUNT_RTOL, and heights within
    CENTROID_ATOL where both have one.  Returns ``(ok, cells, max height
    difference)``."""
    if len(got) != len(ref):
        return False, None, None
    ok, cells, diff = True, 0, 0.0
    for (z_g, ext_g), (z_r, ext_r) in zip(got, ref):
        f_g, f_r = np.isfinite(z_g), np.isfinite(z_r)
        both = f_g & f_r
        cells += int(f_r.sum())
        if both.any():
            diff = max(diff, float(np.abs(z_g[both] - z_r[both]).max()))
        ok &= (ext_g == ext_r
               and abs(int(f_g.sum()) - int(f_r.sum()))
               <= PATCH_COUNT_RTOL * f_r.sum())
    return ok and diff <= CENTROID_ATOL, cells, diff


def merged_runs(a, b):
    """Two ``full_demo.replay`` results as one run."""
    return dict(centroids=np.concatenate([a["centroids"], b["centroids"]]),
                auxes=a["auxes"] + b["auxes"],
                chunk_s=a["chunk_s"] + b["chunk_s"], wall=a["wall"] + b["wall"])


def demo_launches(slam, run):
    """K2 and K3 launches since the counters were reset, the gates summed
    from a ``full_demo.replay`` run, and the launches the gates want: a
    chain lookup per measurement frame (and per laser mapping frame with
    the scan match), a merge per laser or camera mapping frame."""
    from slam_eslam_tpu_torch.ops import block_merge as bm
    from slam_eslam_tpu_torch.ops import chain_lookup as cl

    launches = {"chain_lookup": cl.chain_lookup.launches,
                "block_merge": bm.block_merge.launches}
    gates = {name: sum(int(a[name].sum()) for a in run["auxes"])
             for name in ("updated", "mapped", "cam_mapped")}
    want = {"chain_lookup": gates["updated"] + (
        gates["mapped"] if slam.filter.config.use_visual_update else 0),
        "block_merge": gates["mapped"] + gates["cam_mapped"]}
    return launches, gates, want


def full_demo_run(dev, card, tmp):
    """(c) ``examples.full_demo``: record, ``frames_from_log`` on the card,
    ``OnlineSlam`` in chunks, eager and graphed (bit for bit), the report;
    K2/K3 launches against the gates, the first chunk and its best
    particle's map layers against the CPU port on the same draws.  Returns
    what (d) and the kernels line need."""
    from slam_eslam_tpu_torch.examples import full_demo as fd
    from slam_eslam_tpu_torch.filter import streaming
    from slam_eslam_tpu_torch.viz import render

    args = fd.parser().parse_args([*FULL_DEMO_ARGS, "--out",
                                   str(tmp / "out")])
    path = tmp / "loop.eslg"
    t0 = time.perf_counter()
    truth = fd.record(path, args, fd.World(args.extent))
    record_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames, ts, intr = streaming.frames_from_log(path, camera=True,
                                                 texture=True, device=dev)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    frames_h, ts_h, intr_h = streaming.frames_from_log(
        path, camera=True, texture=True, device="cpu")
    differ = frames_equal(frames, frames_h)
    print(f"full_demo record: {len(truth)} frames, "
          f"{int(frames.host_has_scan.sum())} scans, "
          f"{int(frames.host_has_dimg.sum())} textured images in "
          f"{record_s:.2f} s ({path.stat().st_size / 1e6:.2f} MB); "
          f"frames_from_log onto the card {read_s * 1e3:.2f} ms, "
          + ("equal bit for bit to the CPU read" if not differ
             and np.array_equal(ts, ts_h) and intr == intr_h
             else f"DIFFERS from the CPU read in {differ}") + f" [{card}]")
    if differ or not np.array_equal(ts, ts_h) or intr != intr_h:
        raise RuntimeError(f"frames_from_log: card and CPU differ {differ}")

    n, chunk = args.particles, args.chunk
    normals, draws = demo_draws(n, len(frames))
    runs = {}
    for mode in ("eager", "graphed"):
        runs[mode] = demo_chunks(fd, args, truth, frames, normals, draws,
                                 dev, card, mode)
    e, g = runs["eager"], runs["graphed"]
    same, n_fields = equal_bits(
        (g["state"], [a["centroid"] for a in g["run"]["auxes"]],
         [a["best_pose"] for a in g["run"]["auxes"]]),
        (e["state"], [a["centroid"] for a in e["run"]["auxes"]],
         [a["best_pose"] for a in e["run"]["auxes"]]))
    same &= all(np.array_equal(ga[k], ea[k]) for ga, ea in zip(
        g["run"]["auxes"], e["run"]["auxes"])
        for k in ("updated", "mapped", "cam_mapped"))
    same &= g["keyframes"] == e["keyframes"] and g["launches"] == e[
        "launches"]
    print(f"full_demo: graphed vs eager OnlineSlam over "
          f"{len(e['run']['auxes'])} chunks: gates, centroids, best poses, "
          f"the filter and pool ({n_fields} tensors), keyframes "
          f"{e['keyframes']} and launches equal bit for bit: {same}; "
          f"run_stream per chunk eager {e['ms']} ms, graphed {g['ms']} ms")
    if not same:
        raise RuntimeError("full_demo: the graphed chunks differ from the "
                           "eager chunks")
    slam, first, best, layers, patches = (e["slam"], e["first"], e["best"],
                                          e["layers"], e["patches"])
    launches = e["launches"]

    # ---- the first chunk against the CPU port on the same draws ----
    ref = fd.make_slam(args, truth[0], "cpu", normals)
    rrun = fd.replay(ref, frames_h.at(slice(0, chunk)), chunk, draws[:chunk],
                     log=lambda *a: None)
    gates_equal = all(np.array_equal(rrun["auxes"][0][name],
                                     e["run"]["auxes"][0][name])
                      for name in ("updated", "mapped", "cam_mapped"))
    err = float(np.abs(rrun["centroids"] - first["centroids"]).max())
    p_cpu = int(ref.filter.pool.count_valid())
    ok_layers, cells, z_diff = layers_agree(
        layers, render.chain_layers(ref.filter.pool, best))
    print(f"full_demo: first chunk GPU vs CPU port: gates "
          f"{'equal' if gates_equal else 'DIFFER'}, centroids {err:.3e} m, "
          f"patches {patches} vs {p_cpu}; "
          f"particle {best}'s chain_layers {len(layers)} blocks, {cells} "
          f"cells with a patch, heights {z_diff:.3e} m apart [{card}]")
    if (not gates_equal or err > CENTROID_ATOL or not ok_layers
            or abs(patches - p_cpu) > PATCH_COUNT_RTOL * p_cpu):
        raise RuntimeError("full_demo: the card and the CPU port differ")
    return dict(launches=launches, result=e["result"], chunk=chunk,
                stream_s=e["stream_s"], keyframe_s=e["keyframe_s"],
                optimize_s=e["optimize_s"], graphed=dict(
                    launches=g["launches"], stream_s=g["stream_s"],
                    calls=g["calls"], result=g["result"]),
                calls=e["calls"])


def demo_chunks(fd, args, truth, frames, normals, draws, dev, card, mode):
    """``examples.full_demo``'s ``OnlineSlam`` over the recorded frames in
    chunks, eager or graphed (``OnlineSlam(graph=True)``, the demo's
    default on the card), on the given draws: K2/K3 launches against the
    gates, the report, run_stream's milliseconds per chunk, the host's
    launch calls per frame of one more chunk."""
    from slam_eslam_tpu_torch import ops
    from slam_eslam_tpu_torch.viz import render

    chunk = args.chunk
    slam = fd.make_slam(args, truth[0], dev, normals,
                        graph=mode == "graphed")
    stream_s, run_stream = [], slam.filter.run_stream

    def timed_stream(*a, **kw):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        aux = run_stream(*a, **kw)
        torch.cuda.synchronize()
        stream_s.append(time.perf_counter() - t1)
        return aux

    slam.filter.run_stream = timed_stream
    ops.reset_launch_counts()
    first = fd.replay(slam, frames.at(slice(0, chunk)), chunk, draws[:chunk])
    best = slam.filter.get_best_particle_index()
    layers = render.chain_layers(slam.filter.pool, best)
    patches = int(slam.filter.pool.count_valid())
    rest = fd.replay(slam, frames.at(slice(chunk, None)), chunk,
                     draws[chunk:])
    run = merged_runs(first, rest)
    launches, gates, want = demo_launches(slam, run)
    result, extra = fd.report(slam, truth, run, args)
    n_chunks = len(run["chunk_s"])
    ms = lambda xs: f"{min(xs) * 1e3:.1f}-{max(xs) * 1e3:.1f}"
    keyframe_s = [c - s for c, s in zip(run["chunk_s"], stream_s)]
    out = dict(slam=slam, first=first, best=best, layers=layers,
               patches=patches, run=run, launches=launches, result=result,
               stream_s=stream_s, keyframe_s=keyframe_s,
               optimize_s=extra["optimize_s"], ms=ms(stream_s),
               keyframes=[tuple(np.round(np.asarray(k), 9).tolist())
                          for k in slam.trajectory()],
               state=graphs_clone((slam.filter.state, slam.filter.pool)))
    slam.filter.run_stream = run_stream
    sub = frames.at(slice(0, DEMO_LAUNCH_FRAMES))
    out["calls"] = host_launches(lambda: run_stream(sub),
                                 DEMO_LAUNCH_FRAMES)
    print(f"full_demo[{mode}]: {result['frames']} frames x "
          f"{args.particles} particles in "
          f"{n_chunks} chunks of {chunk}: {gates['updated']} measurement, "
          f"{gates['mapped']} laser and {gates['cam_mapped']} camera mapping "
          f"frames, launches {launches} (gates want {want}); per chunk "
          f"run_stream {ms(stream_s)} ms (first {stream_s[0] * 1e3:.1f}), "
          f"{sum(stream_s[1:]) / max(len(stream_s) - 1, 1) / chunk * 1e3:.4f}"
          f" ms/frame after the first, keyframes {ms(keyframe_s)} ms; "
          f"optimize (40 iterations) {extra['optimize_s'] * 1e3:.1f} ms; "
          f"{result['keyframes']} keyframes, {result['closures']} closures; "
          f"{result['fps_incl_host']} frames/s; pool "
          f"{slam.filter.pool.storage_bytes() / 1e9:.2f} GB; "
          f"{calls_text(out['calls'], 'frame')} [{card}]")
    if launches != want:
        raise RuntimeError(f"full_demo[{mode}]: launches {launches}, gates "
                           f"want {want}")
    return out


def closure_route_run(dev, card, tmp):
    """(c) continued: ``examples.full_demo`` on CLOSURE_ROUTE at the same
    size, through its generator's draws as a user runs it: K2/K3 against
    the gates, at least one loop closure (each audited against the true
    relative pose in the demo's lines), the graph dumped for (d)."""
    from slam_eslam_tpu_torch.examples import full_demo as fd
    from slam_eslam_tpu_torch.filter import streaming
    from slam_eslam_tpu_torch.ops import block_merge as bm
    from slam_eslam_tpu_torch.ops import chain_lookup as cl

    graph = tmp / "graph.npz"
    args = fd.parser().parse_args([*FULL_DEMO_ARGS, *CLOSURE_ROUTE,
                                   "--save-graph", str(graph),
                                   "--out", str(tmp / "out")])
    path = tmp / "laps.eslg"
    truth = fd.record(path, args, fd.World(args.extent))
    frames, _, _ = streaming.frames_from_log(path, camera=True, texture=True,
                                             device=dev)
    slam = fd.make_slam(args, truth[0], dev)
    cl.chain_lookup.launches = 0
    bm.block_merge.launches = 0
    run = fd.replay(slam, frames, args.chunk, log=lambda *a: None)
    launches, gates, want = demo_launches(slam, run)
    result, extra = fd.report(slam, truth, run, args)
    print(f"full_demo[{' '.join(CLOSURE_ROUTE)}]: {result['frames']} frames "
          f"x {args.particles} particles, route {result['route_m']} m, "
          f"launches {launches} (gates want {want}); {result['keyframes']} "
          f"keyframes, {result['closures']} closures ({result['false_closures']}"
          f" false) of {result['revisit_opportunities']} revisits; kf ATE "
          f"{result['kf_xy_before_m']} -> {result['kf_xy_after_m']} m; "
          f"{result['fps_incl_host']} frames/s, optimize "
          f"{extra['optimize_s'] * 1e3:.1f} ms [{card}]")
    if launches != want:
        raise RuntimeError(f"full_demo laps: launches {launches}, gates "
                           f"want {want}")
    if result["closures"] < 1:
        raise RuntimeError("full_demo laps: no loop closure")
    return dict(graph=graph, launches=launches, result=result)


def closure_lab_run(graph, dev, card):
    """(d) ``tools.closure_lab`` on (c)'s graph: every policy on the card
    against the CPU port (the keyframe ATE within CENTROID_ATOL, the chi2
    history as phase 10 holds it)."""
    from slam_eslam_tpu_torch.tools import closure_lab

    quiet = lambda *a, **k: None
    d = closure_lab.load(graph)
    t0 = time.perf_counter()
    got = closure_lab.lab(d, device=dev, log=quiet)
    seconds = time.perf_counter() - t0
    ref = closure_lab.lab(d, device="cpu", log=quiet)
    faults, ate_diff, chi2_rel = [], 0.0, 0.0
    for (name, ate, hist), (_, r_ate, r_hist) in zip(got, ref):
        ate_diff = max(ate_diff, abs(ate - r_ate))
        above = np.abs(r_hist) > CHI2_ZERO
        if above.any():
            chi2_rel = max(chi2_rel, float(np.max(
                np.abs(hist - r_hist)[above] / np.abs(r_hist[above]))))
        if abs(ate - r_ate) > CENTROID_ATOL or not np.allclose(
                hist, r_hist, rtol=PG_CHI2_RTOL,
                atol=max(PG_CHI2_ATOL * abs(r_hist[0]), CHI2_ZERO)):
            faults.append(f"{name}: ATE {ate} / {r_ate}, chi2 "
                          f"{hist.tolist()} / {r_hist.tolist()}")
    n_nodes = int(d["node_valid"].sum())
    print(f"closure_lab: {len(got)} policies on {n_nodes} keyframes and "
          f"{len(d['closures'])} closures in {seconds:.2f} s on the card; "
          f"kf ATE after {dict((r[0], r[1]) for r in got)['none']:.3f} m "
          f"with every closure, {d['kf_truth'].shape[0]} truth poses; GPU "
          f"vs CPU port: ATE {ate_diff:.3e} m, "
          f"chi2 {chi2_rel:.3e} relative where above {CHI2_ZERO} [{card}]")
    if faults:
        raise RuntimeError(f"closure_lab: card and CPU differ in {faults}")


def replay_draws(n, frames, seed=6):
    """Seeded start normals and one ``ContactDraws`` per frame, host."""
    from slam_eslam_tpu_torch.filter import pose_estimator as pe
    from slam_eslam_tpu_torch.filter.eslam_filter import ContactDraws

    gen = torch.Generator().manual_seed(seed)
    normals = (torch.randn((n, 2), generator=gen),
               torch.randn((n,), generator=gen))
    return normals, [ContactDraws(pe.ProjectDraws.sample(n, gen, "cpu"),
                                  torch.rand(n, generator=gen))
                     for _ in range(frames)]


def replay_run(dev, card, tmp):
    """(e) ``examples.replay_demo`` at 100k particles: one launch of the
    contact fold K1 per measurement update and none of K5 (the filter's
    shared-map lookup folds: ``Config.fold_lookup``, no debug capture, no
    Chitta weighting, no terrain labels); its first frames at 4,096
    particles against the CPU port on the same draws."""
    from slam_eslam_tpu_torch.examples import replay_demo
    from slam_eslam_tpu_torch.ops import contact_fold as cf
    from slam_eslam_tpu_torch.ops import select_cells as sc

    quiet = lambda *a, **k: None
    path = tmp / "replay.eslg"
    n_frames = replay_demo.record(path, 15)
    sc.select_cells.launches = 0
    cf.contact_fold.launches = 0
    got = replay_demo.replay(path, REPLAY_N, dev)
    launches = {"select_cells": sc.select_cells.launches,
                "contact_fold": cf.contact_fold.launches}
    frames = len(got["errors"])
    draws = replay_draws(REPLAY_CHECK_N, REPLAY_CHECK_FRAMES)
    a = replay_demo.replay(path, REPLAY_CHECK_N, dev, draws,
                           REPLAY_CHECK_FRAMES, log=quiet)
    b = replay_demo.replay(path, REPLAY_CHECK_N, "cpu", draws,
                           REPLAY_CHECK_FRAMES, log=quiet)
    err = float(np.abs(a["centroids"] - b["centroids"]).max())
    print(f"replay_demo: {n_frames} frames recorded, {frames} replayed at "
          f"{REPLAY_N} particles in {got['seconds']:.3f} s = "
          f"{frames / got['seconds']:.1f} frames/s, feeder wait "
          f"{got['wait'] / got['seconds']:.2%}; {got['updates']} measurement "
          f"updates, launches {launches}; first {REPLAY_CHECK_FRAMES} frames "
          f"at {REPLAY_CHECK_N} GPU vs CPU port {err:.3e} m [{card}]")
    if launches != {"select_cells": 0, "contact_fold": got["updates"]} \
            or not got["updates"]:
        raise RuntimeError(f"replay_demo: launches {launches} for "
                           f"{got['updates']} measurement updates")
    if not err <= CENTROID_ATOL:
        raise RuntimeError(f"replay_demo: GPU and CPU differ by {err} m")
    return dict(launches=launches, fps=frames / got["seconds"],
                wait=got["wait"] / got["seconds"])


def big_pool_layers(dev, card):
    """(f) ``chain_layers`` of one particle of phase 8's 400,000-block
    bfloat16 pool reads its chain's blocks, never a pool-sized mask."""
    from slam_eslam_tpu_torch.mapping.map_pool import MapPool
    from slam_eslam_tpu_torch.mapping.mls_grid import MLSGrid
    from slam_eslam_tpu_torch.viz import render

    g = SLAM_POOL
    template = MLSGrid.create(g["nx"], g["ny"], g["resolution"],
                              (-5.0, -5.0), g["k"], device=dev)
    pool = MapPool.from_template(template, BIG_N, 4 * BIG_N, g["chain_len"],
                                 with_color=False, dtype=torch.bfloat16,
                                 device=dev)
    last = pool.b - 1
    pool.chain[0, 1] = last
    for blk, z in ((0, 0.25), (last, -0.5)):
        pool.mean[blk, :, 0::g["k"]] = z
        pool.meta[blk, :, 0::g["k"]] |= 1
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    layers = render.chain_layers(pool, 0)
    rise = torch.cuda.max_memory_allocated() - base
    mask_bytes = pool.meta.numel() * pool.meta.element_size()
    heights = [float(np.nanmax(z)) for z, _ in layers]
    print(f"chain_layers[100k bf16]: {pool.b} blocks "
          f"({pool.storage_bytes() / 1e9:.1f} GB), particle 0's {len(layers)} "
          f"layers at heights {heights}, max_memory_allocated rose "
          f"{rise / 1e6:.3f} MB (the whole-pool mask would be "
          f"{mask_bytes / 1e9:.2f} GB) [{card}]")
    if rise >= LAYER_RISE_MAX or heights != [0.25, -0.5]:
        raise RuntimeError(f"chain_layers on the 100k pool: {rise} bytes, "
                           f"heights {heights}")
    return rise


def phase11(dev, card):
    """The log runtime and the record -> replay -> report path."""
    import gc
    import tempfile

    gc.collect()
    torch.cuda.empty_cache()
    jax_pkg = Path(__file__).resolve().parent / "slam_eslam_tpu"
    before = tree_snapshot(jax_pkg)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        native_library(card)
        log_round_trip(tmp, card)
        out = dict(demo=full_demo_run(dev, card, tmp))
        gc.collect()
        torch.cuda.empty_cache()
        out["laps"] = closure_route_run(dev, card, tmp)
        closure_lab_run(out["laps"]["graph"], dev, card)
        gc.collect()
        torch.cuda.empty_cache()
        out["replay"] = replay_run(dev, card, tmp)
    gc.collect()
    torch.cuda.empty_cache()
    out["layer_rise"] = big_pool_layers(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    if tree_snapshot(jax_pkg) != before:
        raise RuntimeError("phase 11 wrote under slam_eslam_tpu/")
    return out


# ---------------------------------------------------------------------------
# phase 12: the measurement tools of tools/ on the card
# ---------------------------------------------------------------------------

# each tool runs in process at full width; depth is cut where a tool's
# defaults would take most of the phase (PERF.md, PR 10, has the default
# runs): profile_slam at 100,000 particles 4 of 10 steps (40 frames; at
# 4,096 5 of 10 steps), probe_spread 50 of 150 steps,
# bench_surface_hash 10 of 20 steps and 1 of 3 repeats, ab_pool_dtype 2 of
# 10 runs and 20 of 120 steps, profile_step 3 of 5 repeats (of its host
# clock; its device time is a graph of 20 copies), stat_map_test 2 of 20 runs and
# 80 of 100 steps (the robot reaches the mapped rows at step 66)
BIG_PROFILE_CUT = ("--steps", "4")
SMALL_PROFILE_CUT = ("--steps", "5")
TOOL_CUTS = {
    "probe_spread": ("--steps", "50"),
    "bench_surface_hash": ("--steps", "10", "--repeats", "1"),
    "ab_pool_dtype": ("--runs", "2", "--steps", "20"),
    "profile_step": ("--repeats", "3"),
    "stat_map_test": ("--runs", "2", "--steps", "80"),
}
# profile_step's two shapes: its default (the unfolded lookup, K5, 20
# contacts) and the bench's step (the fold, K1, contacts compacted to 8)
STEP_SHAPES = {"gather": (),
               "window": ("--lookup", "window", "--contact-cap", "8")}
STEP_GAP_MAX = 0.20     # the stages' sum against the step, said beyond it
# a float32 pool of 4 blocks per particle at 100,000 particles: 400,000
# blocks of 40x40x4 slots x 4 fields = 40.96 GB of the card's 80 GB
TOOLS_BIG_N = 100_000


def check(cond, label, message):
    if not cond:
        raise RuntimeError(f"{label}: {message}")


def run_tool(name, argv, **kw):
    """``slam_eslam_tpu_torch.tools.<name>.main(argv, **kw)`` on the card;
    returns its result, the kernel launches it made and its seconds."""
    import importlib

    from slam_eslam_tpu_torch import ops

    tool = importlib.import_module(f"slam_eslam_tpu_torch.tools.{name}")
    argv = list(argv) + list(TOOL_CUTS.get(name, ()))
    print(f"--- tools.{name} {' '.join(argv)} {kw or ''}", flush=True)
    before = ops.launch_counts()
    t0 = time.perf_counter()
    res = tool.main(argv, **kw)
    seconds = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in ops.launch_counts().items()}
    print(f"tools.{name}: {seconds:.1f} s, launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    gc_cuda()
    return res, launches, seconds


def gc_cuda():
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def trace_rows(res, label, want):
    """Each kernel of ``want`` (name part -> count) once in the tool's
    aggregated table, as often as its gate fired."""
    rows = dict(res["rows_all"])
    for kernel, count in want.items():
        hits = [(name, cnt) for name, (_, cnt) in rows.items()
                if kernel in name]
        check(len(hits) == 1 and hits[0][1] == count > 0, label,
              f"{kernel} rows {hits}, gates {count}")


def records_text(res):
    kept, launched = res["records"]
    return (f"device records {kept:,} of {launched:,} launches "
            f"({launched - kept:,} lost)")


def slam_profile_run(card, n, tmp):
    """``profile_slam`` on the compiled runner: every traced frame a
    replay; K2 and K3 in the replayed trace's table under their kernel
    names, as often as the measurement and mapping gates fired; the
    records the tracer kept against the launches; the block copies'
    share of the replayed device time."""
    res, launches, _ = run_tool("profile_slam", (
        "--particles", str(n), "--trace-dir", str(tmp / f"slam_{n}"),
        "--top", "12") + (BIG_PROFILE_CUT if n == TOOLS_BIG_N
                          else SMALL_PROFILE_CUT))
    label = f"profile_slam[{n}]"
    check(res["kind"] == "device", label, "the trace holds no device event")
    check(res["graphed"] and res["traced"] == {
        "eager": 0, "captured": 0, "replayed": res["frames"]}, label,
        f"the traced run was not all replays: {res['traced']}")
    trace_rows(res, label, {"chain_lookup_kernel": res["fired"],
                            "block_merge_kernel": res["mapped"]})
    runs = res["runs"]
    check(launches["chain_lookup"] == runs * res["fired"]
          and launches["block_merge"] == runs * res["mapped"], label,
          f"launches {launches} over {runs} runs for {res['fired']} "
          f"measurement and {res['mapped']} mapping frames a run")
    check(0.0 < res["copy_share"] < 1.0, label,
          f"block copies' share {res['copy_share']}")
    top = "; ".join(f"{name.split('(')[0][:60]} {ms:.3f} ms x{cnt}"
                    for name, (ms, cnt) in res["rows_all"][:5])
    rate = res["frames"] / res["steady_s"]
    print(f"{label}: graphed, {res['frames']} frames replayed in the trace, "
          f"{res['fired']} measurement and {res['mapped']} mapping frames, "
          f"{rate:.1f} frames/s; device {res['total_ms']:.3f} ms, "
          f"{records_text(res)} [{card}]")
    print(f"{label}: block copies {res['copy_ms']:.3f} ms = "
          f"{res['copy_share']:.2%} of the replayed device time; top: {top} "
          f"[{card}]")
    return res, launches


def lookup_run(name, card, argv=()):
    """``profile_filter`` / ``probe_spread``: the lookup they name ran, one
    K1 launch per measurement update and no K5."""
    from slam_eslam_tpu_torch.tools.profile_filter import FOLD

    res, launches, _ = run_tool(name, argv)
    # profile_filter counts its steady run, probe_spread its one run
    check(res["lookup"] == FOLD and res["launches"]["contact_fold"]
          == res["updates"] > 0 and res["launches"]["select_cells"] == 0,
          name, f"lookup {res['lookup']!r}, launches {res['launches']} for "
                f"{res['updates']} measurement updates")
    print(f"{name}: {res['lookup']}, {res['launches']['contact_fold']} "
          f"contact_fold launches for {res['updates']} measurement updates "
          f"[{card}]")
    if "rows_all" in res:
        # profile_filter's trace: a run of replays, K1 once an update
        check(res["kind"] == "device" and res["graphed"], name,
              f"trace {res['kind']}, graphed {res['graphed']}")
        trace_rows(res, name, {"contact_fold_kernel": res["updates"]})
        print(f"{name}: graphed, {res['updates']} steps replayed in the "
              f"trace, contact_fold_kernel x{res['updates']}; device "
              f"{res['total_ms']:.3f} ms, {records_text(res)} [{card}]")
    return res, launches


def odometry_kernels(dev):
    """``odometry.update`` at ``profile_step``'s bench shape (the step's
    one part that no stage runs): the profiler's sum of its kernels in
    ms, and its kernel-launch calls."""
    from slam_eslam_tpu_torch.filter.step import cfg_odo
    from slam_eslam_tpu_torch.models import odometry as odom
    from slam_eslam_tpu_torch.tools import profile_step

    cfg, _, state, cs, q = profile_step.setup(TOOLS_BIG_N, 8, "window", dev)
    fn = lambda: odom.update(state.odometry, cs, q, cfg_odo(cfg))
    fn()
    return profile_step.kernels_and_launches(fn)


def step_stages(card, dev, step_ms):
    """``profile_step`` at both shapes, each stage a CUDA graph: every
    stage graphed, finite and bit for bit an eager call; its device ms
    (a graph of 20 copies), the profiler's sum of its kernels, host ms
    and launch calls printed.  At the bench's shape the kernels of
    ``project``, ``update_full``, ``centroid`` and ``odometry.update``
    against the graphed step's (``step_ms``: ``profile_filter``'s
    profiler sum a step), the same reading on both sides."""
    from slam_eslam_tpu_torch.tools import profile_step

    out = {}
    for shape, argv in STEP_SHAPES.items():
        label = f"profile_step[{shape}]"
        res, launches, _ = run_tool("profile_step", argv)
        for name, r in res.items():
            check(r["graphed"] and r["finite"] and r["equal"] is True
                  and r["ms"] > 0 and r["kernel_ms"] > 0, label,
                  f"{name}: graphed {r['graphed']}, finite {r['finite']}, "
                  f"equal {r['equal']}, ms {r['ms']}, kernels "
                  f"{r['kernel_ms']}")
            print(f"{label} {name}: device {r['ms']:.5f} ms "
                  f"({profile_step.STAGE_REPS} copies in a graph), kernels "
                  f"{r['kernel_ms']:.5f} ms, host {r['host_ms']:.4f} ms, "
                  f"{r['launches']} launch calls, bound "
                  f"{r['bound_ms']:.5f} ms; graphed vs eager bit for bit "
                  f"[{card}]")
        total = {k: sum(res[st][k] for st in profile_step.STEP_STAGES)
                 for k in ("ms", "kernel_ms", "launches")}
        print(f"{label}: {' + '.join(profile_step.STEP_STAGES)} = "
              f"{total['ms']:.5f} ms device, kernels "
              f"{total['kernel_ms']:.5f} ms, {total['launches']} launch "
              f"calls [{card}]")
        out[shape] = dict(
            stages={k: {f: r[f] for f in ("ms", "kernel_ms", "host_ms",
                                          "launches", "bound_ms")}
                    for k, r in res.items()},
            sum=total, launches=launches)
    # the step is the bench's, so the sum stands against it at the
    # bench's shape alone
    odo_ms, odo_launches = odometry_kernels(dev)
    kernels = out["window"]["sum"]["kernel_ms"] + odo_ms
    gap = kernels / step_ms - 1.0
    print(f"profile_step[window]: odometry.update kernels {odo_ms:.5f} ms, "
          f"{odo_launches} launch calls; stages + odometry.update kernels "
          f"{kernels:.5f} ms against the graphed step's kernels "
          f"{step_ms:.5f} ms (profile_filter): {gap:+.1%}"
          + (f", beyond {STEP_GAP_MAX:.0%}" if abs(gap) > STEP_GAP_MAX
             else "") + f" [{card}]")
    out["window"].update(step_ms=step_ms, odometry_ms=odo_ms,
                         odometry_launches=odo_launches)
    return out


def spread_equal(card):
    """``probe_spread`` graphed (its default on the card, one K1 launch
    an update under replay) against its eager run on the same state and
    generator: every per-step row bit for bit."""
    res, launches = lookup_run("probe_spread", card)
    check(res["graphed"], "probe_spread", "did not run graphed")
    ref, _, _ = run_tool("probe_spread", (), graph=False)
    keys = ("sx", "sy", "ess", "resampled")
    same = all(np.array_equal(res[k], ref[k]) for k in keys)
    print(f"probe_spread: graphed vs eager over {res['updates']} steps "
          f"(extents, ESS, resampling) equal bit for bit: {same} [{card}]")
    check(same, "probe_spread", "graphed and eager runs differ")
    return launches


def stat_map_equal(card, tmp):
    """``stat_map_test batch`` with its evaluation graphed (the default on
    the card) and eagerly: the raw arrays bit for bit, the result files
    byte for byte, and the robot on the mapped rows."""
    runs = {}
    for mode, kw in (("graphed", {}), ("eager", {"graph": False})):
        path = tmp / f"stat_map_{mode}.dat"
        raw, _, seconds = run_tool("stat_map_test", (
            "batch", "--result-file", str(path)), **kw)
        runs[mode] = (raw, path.read_bytes(), seconds)
    (got, got_file, got_s), (ref, ref_file, ref_s) = (runs["graphed"],
                                                      runs["eager"])
    counts = got.pop("graphs")
    check(ref.pop("graphs") is None and counts and counts.get("replayed"),
          "stat_map_test", f"graph counts {counts}")
    same = all(np.array_equal(got[k], ref[k], equal_nan=True) for k in ref)
    mapped = int(np.isfinite(got["map_z"]).sum())
    print(f"stat_map_test: graphed ({got_s:.1f} s, evaluation graphs "
          f"{counts}) vs eager ({ref_s:.1f} s): raw arrays equal bit for "
          f"bit: {same}, result files identical: {got_file == ref_file}; "
          f"{mapped} steps on mapped rows [{card}]")
    check(same and got_file == ref_file and mapped > 0, "stat_map_test",
          "graphed and eager runs differ, or no step reached the map")
    return dict(counts=counts, graphed_s=got_s, eager_s=ref_s)


def phase12(dev, card):
    """The measurement tools of ``tools/``, ported, on the card."""
    import tempfile

    from slam_eslam_tpu_torch.tools import bench_surface_hash

    gc_cuda()
    jax_pkg = Path(__file__).resolve().parent / "slam_eslam_tpu"
    before = tree_snapshot(jax_pkg)
    print(f"phase 12 cuts (depth only): {TOOL_CUTS}, profile_slam at "
          f"{TOOLS_BIG_N} particles {BIG_PROFILE_CUT}")
    out = {"launches": {}}
    launches = out["launches"]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        res, launches["bench_kernels"], _ = run_tool("bench_kernels", ())
        sel = res["select"]
        check(sel["equal"], "bench_kernels", "K5 differs from its plain "
              "version")
        print(f"bench_kernels: K5 at Q = 2,000,000 {sel['ms']:.5f} ms "
              f"against its bound {sel['bound_ms']:.5f} ms "
              f"({sel['bound_ms'] / sel['ms']:.3f} of it), x"
              f"{sel['speedup']:.1f} the gather, bit for bit [{card}]")
        out["k5"] = sel

        res, launches["probe_chain_parity"], _ = run_tool(
            "probe_chain_parity", ())
        check(res["found_equal"] and res["max_dmean"] == 0.0
              == res["max_dstdev"], "probe_chain_parity",
              f"K2 against the plain walk: {res}")
        out["chain"] = res

        for n in (SLAM_N, TOOLS_BIG_N):
            out[f"slam_{n}"], launches[f"profile_slam_{n}"] = (
                slam_profile_run(card, n, tmp))
        res, launches["profile_filter"] = lookup_run(
            "profile_filter", card, ("--trace-dir", str(tmp / "filter")))
        launches["probe_spread"] = spread_equal(card)

        out["stages"] = step_stages(card, dev,
                                    res["total_ms"] / res["updates"])
        launches["profile_step"] = out["stages"]["gather"]["launches"]
        launches["profile_step_window"] = out["stages"]["window"]["launches"]
        out["stat_map"] = stat_map_equal(card, tmp)

        # the tool raises where an index does not bracket its position
        run_tool("profile_resample", ())

        res, _, _ = run_tool("bench_pool_ops", ())
        check(len(res) == 7 and all(ms > 0 for ms in res.values()),
              "bench_pool_ops", f"rows {res}")

        res, launches["bench_surface_hash"], _ = run_tool(
            "bench_surface_hash", ())
        t0 = time.perf_counter()
        cpu_hash, _ = bench_surface_hash.create_hash(400, 16, "cpu")
        cpu_s = time.perf_counter() - t0
        check(int(cpu_hash.n_valid) == res["n_valid_candidates"],
              "bench_surface_hash", f"{res['n_valid_candidates']} valid "
              f"candidates on the card, {int(cpu_hash.n_valid)} on the CPU")
        print(f"bench_surface_hash: {res['n_valid_candidates']} valid "
              f"candidates on the card and on the CPU port (its create "
              f"{cpu_s:.2f} s); reinjection "
              f"{res['reinjection_cost_ms_per_frame']} ms a frame [{card}]")
        out["hash"] = res

        res, launches["ab_pool_dtype"], _ = run_tool("ab_pool_dtype", ())
        stats = [v for d in ("float32", "bfloat16") for v in res[d].values()]
        check(all(np.isfinite(stats)), "ab_pool_dtype", f"stats {res}")
        out["ab"] = res
    gc_cuda()
    if tree_snapshot(jax_pkg) != before:
        raise RuntimeError("phase 12 wrote under slam_eslam_tpu/")
    return out


# ---------------------------------------------------------------- phase 13

SCAN_SIZES = (N_BENCH, 1, 127, 129, N_RAGGED, 8193, 2_100_000)
# the one-launch kernel's level and tile boundaries (4,096 elements a tile)
# and a size with more than 16 tiles per level above the tile
SCAN_EDGES = (2, 16, 17, 256, 257, 4095, 4096, 4097, 65_536, 65_537,
              140_000, 16 * 4096 * 17 + 3)
SCAN_TIMED = (N_BENCH, 2_100_000)
SCAN_REPLAY_SIZES = (1, 4097, N_BENCH, 2_100_000)
SCAN_REPLAYS = 3
SCAN_REPEAT_SIZES = (N_BENCH, 4097)
SCAN_TURN_SIZES = (2_100_000, N_BENCH, 8193, 4096, 5000)
SCAN_REPEATS = 250
# an earlier source of the scan, outside the tree (``--prior-scan PATH``):
# timed in turns with S1 when given
PRIOR_SCAN = None
PRIOR_SMALL = 8192     # the three-launch scan's one-CTA size
DRYRUN_RANKS = 4
PPERMUTE_STEPS = 10     # forced-resample steps of the one-rank ring hop
# one NCCL rank, then two and four ranks sharing the card (host transport)
SCALING_ARGS = ("--devices", "1", "2", "4", "--repeats", "1")


def scan_weights(n, signed=False):
    """Resampling weights of ``n`` particles (a softmax of normal draws
    seeded by ``n``); ``signed`` puts zeros of both signs in the first 15
    elements of every tile of 4,096 and, above two tiles, makes the first
    tile all ``-0.0``."""
    g = torch.Generator().manual_seed(n)
    w = torch.softmax(2.5 * torch.randn((n,), generator=g), 0)
    if signed:
        i = torch.arange(n)
        w = torch.where(i % 4096 < 15,
                        torch.where(i % 3 == 1, 0.0, -0.0), w)
        if n > 2 * 4096:
            w[:4096] = -0.0
    return w


def bitwise(a, b):
    """Equal bit for bit (``-0.0`` is not ``+0.0``)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def launches_per_call(fn, calls=10):
    """Kernel launches, memsets and copies one call of ``fn`` puts on its
    stream: the runtime calls ``torch.profiler`` traces on the host over
    ``calls`` calls (the host's records, which the tracer keeps), and
    their names."""
    fn()
    names = {k: v for k, v in runtime_calls(
        lambda: [fn() for _ in range(calls)]).items()
        if any(s in k for s in ("LaunchKernel", "Memset", "Memcpy"))}
    return sum(names.values()) / calls, names


def prior_scan(path):
    """``make(x, out)``: a launcher of an earlier source of the scan built
    from ``path``, with the C entry ``ordered_scan_launch(x, y, buffer, n,
    stream)``: the three-launch scan's buffer is its row totals above
    PRIOR_SMALL elements, a one-launch scan's its zeroed state of
    ``state_words(n)`` int64 words; one zeroed buffer of its own, as large
    as either, serves both."""
    import ctypes

    from slam_eslam_tpu_torch.ops import _build
    from slam_eslam_tpu_torch.ops import ordered_scan as osc

    lib = _build.library_path(f"ordered_scan_prior_{Path(path).stem}",
                              [path])
    if not lib.exists():
        _build.build_library(lib, _build.nvcc_path(), _build.NVCC_FLAGS,
                             path)
    fn = ctypes.CDLL(str(lib)).ordered_scan_launch
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr, ptr, ptr, ctypes.c_longlong, ptr]
    fn.restype = ctypes.c_int

    def make(x, out):
        n, m, rows = x.shape[0], x.shape[0], 0
        while m > PRIOR_SMALL:
            m = -(-m // 16)
            rows += m
        buffer = torch.zeros(max(-(-rows // 2), osc.state_words(n), 1),
                             dtype=torch.int64, device=x.device)

        def launch():
            err = fn(x.data_ptr(), out.data_ptr(), buffer.data_ptr(), n,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"prior scan {path}: CUDA error {err}")
        return launch
    return make


def scan_exactness(dev):
    """S1 against its plain version bit for bit, on the card and the CPU,
    two calls alike, at SCAN_SIZES on weights and at SCAN_EDGES (and the
    timed sizes) with signed zeros; a graph of one launch replayed
    SCAN_REPLAYS times, each replay the eager result; SCAN_TURN_SIZES in
    turn, larger and smaller launches sharing the state; SCAN_REPEATS calls
    back to back all alike (a ticket or tag left behind would show).
    Returns the largest difference from the plain version on the card."""
    from slam_eslam_tpu_torch.ops import ordered_scan as osc

    max_err = 0.0
    cases = ([(n, False) for n in SCAN_SIZES]
             + [(n, True) for n in SCAN_EDGES + SCAN_TIMED])
    for n, signed in cases:
        w = scan_weights(n, signed)
        wd = w.to(dev)
        a, b = osc.ordered_scan(wd), osc.ordered_scan(wd)
        plain = osc.ordered_scan_reference(wd)
        err = float((a - plain).abs().max())
        max_err = max(max_err, err)
        same, plain_dev = bitwise(a, b), bitwise(a, plain)
        plain_cpu = bitwise(a.cpu(), osc.ordered_scan_reference(w))
        print(f"ordered_scan[{n}{' signed zeros' if signed else ''}]: two "
              f"calls equal {same}, plain version on the card equal "
              f"{plain_dev} (max_abs_err {err:.3e}), on the CPU equal "
              f"{plain_cpu}")
        if not (same and plain_dev and plain_cpu):
            raise RuntimeError(f"ordered_scan[{n}] is not bit for bit its "
                               f"plain version or not repeatable")
    for n in SCAN_REPLAY_SIZES:
        wd = scan_weights(n).to(dev)
        want = osc.ordered_scan(wd)
        out, state = torch.empty_like(wd), osc.device_state(dev, n)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            osc.launch(wd, out, state)
        equal = []
        for _ in range(SCAN_REPLAYS):
            out.zero_()
            graph.replay()
            equal.append(bitwise(out, want))
        print(f"ordered_scan[{n}]: graph replays equal to the eager call "
              f"{equal}")
        check(all(equal), f"ordered_scan[{n}]", f"graph replays {equal}")
        del graph
    # larger and smaller launches in turn share the device's state
    turns = {n: scan_weights(n, True) for n in SCAN_TURN_SIZES}
    turn_want = {n: osc.ordered_scan_reference(w) for n, w in turns.items()}
    turns = {n: w.to(dev) for n, w in turns.items()}
    equal = all(bitwise(osc.ordered_scan(turns[n]).cpu(), turn_want[n])
                for _ in range(3) for n in SCAN_TURN_SIZES)
    print(f"ordered_scan: sizes {SCAN_TURN_SIZES} in turn, three rounds, "
          f"each bit for bit its plain version on the CPU: {equal}")
    check(equal, "ordered_scan", "sizes in turn")
    for n in SCAN_REPEAT_SIZES:
        wd = scan_weights(n).to(dev)
        want = osc.ordered_scan(wd).view(torch.int32)
        differ = torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(SCAN_REPEATS):
            differ += (osc.ordered_scan(wd).view(torch.int32) != want).sum()
        print(f"ordered_scan[{n}]: {SCAN_REPEATS} calls back to back, "
              f"{int(differ)} elements differ from the first")
        check(int(differ) == 0, f"ordered_scan[{n}]",
              f"{int(differ)} elements differ over {SCAN_REPEATS} calls")
    return max_err


def scan_times(dev, card):
    """S1's times: at 100,000 every time of a kernel row
    (``kernel_times``: ``ms`` from a graph of raw launches, the plain
    version from a graph too), ``torch.cumsum`` in a graph and by the
    profiler, an empty kernel as one graph node (``launch_floor_ms``) and
    the launches a call puts on the stream; at 2,100,000 S1 and
    ``torch.cumsum`` in graphs; with PRIOR_SCAN, that earlier source in
    turns with S1 (old, new, new, old) at both sizes, equal to it bit for
    bit."""
    import ctypes

    from slam_eslam_tpu_torch.ops import _build
    from slam_eslam_tpu_torch.ops import ordered_scan as osc
    from slam_eslam_tpu_torch.utils import profiling

    empty = _build.load("ordered_scan").ordered_scan_floor_launch
    empty.argtypes = [ctypes.c_void_p]
    empty.restype = ctypes.c_int
    floor = lambda: empty(torch.cuda.current_stream().cuda_stream)
    check(floor() == 0, "launch floor", "the empty kernel did not launch")
    floor_ms = profiling.device_time(floor) * 1e3
    prior = prior_scan(PRIOR_SCAN) if PRIOR_SCAN else None
    times = {}
    for n in SCAN_TIMED:
        w = scan_weights(n).to(dev)
        out, state = torch.empty_like(w), osc.device_state(dev, n)
        launch = lambda: osc.launch(w, out, state)
        cumsum = lambda: torch.cumsum(w, 0)
        tag = "" if n == N_BENCH else f"_{n // 100_000 * 100}k"
        if n == N_BENCH:
            row = kernel_times(
                f"ordered_scan[{n}]", lambda: osc.ordered_scan(w), launch,
                "scan_tiles", lambda: osc.ordered_scan_reference(w),
                bound(8 * n))
        else:
            ms = profiling.device_time(launch) * 1e3
            row = dict(ms=ms, bound_ms=bound(8 * n)[0])
        lib_ms, lib_clock, lib_prof = device_ms_of(cumsum)
        per_call, names = launches_per_call(launch)
        row.update(library_ms=lib_ms, library_clock=lib_clock,
                   library_ms_profiler=lib_prof,
                   kernel_launches_per_call=per_call)
        if n == N_BENCH:
            row.update(library_call_ms=cuda_ms(cumsum, 50),
                       launch_floor_ms=floor_ms)
        print(f"ordered_scan[{n}]: S1 {row['ms']:.5f} ms (graph), "
              f"{per_call:g} launches a call ({names}); torch.cumsum "
              f"{lib_ms:.5f} ms ({lib_clock}; profiler {ms_text(lib_prof)}); "
              f"bound {row['bound_ms']:.5f} ms; an empty kernel "
              f"{floor_ms:.5f} ms [{card}]")
        check(per_call == 1, f"ordered_scan[{n}]",
              f"{per_call} launches a call, not one")
        if prior is not None:
            old_out = torch.empty_like(w)
            old = prior(w, old_out)
            old()
            launch()
            check(bitwise(old_out, out), f"ordered_scan[{n}]",
                  f"the prior scan {PRIOR_SCAN} gives other bits")
            (old_ms, new_ms), runs = in_turns_device(old, launch)
            old_calls, _ = launches_per_call(old)
            row.update(prior_source=PRIOR_SCAN, prior_ms_in_turns=old_ms,
                       ms_in_turns=new_ms,
                       prior_launches_per_call=old_calls)
            print(f"ordered_scan[{n}]: prior scan {PRIOR_SCAN} "
                  f"{old_ms:.5f} ms ({old_calls:g} launches a call), S1 "
                  f"{new_ms:.5f} ms in "
                  f"turns (old, new, new, old: "
                  f"{', '.join(f'{r:.5f}' for r in runs)}), equal bit for "
                  f"bit [{card}]")
        else:
            row.update(prior_ms_in_turns=None,
                       prior_note="not measured: no --prior-scan")
        times.update({key + tag: value for key, value in row.items()})
    return times


def check_ordered_scan(dev, card):
    """(a) S1: ``scan_exactness``; every ancestor the resampling search
    finds brackets its position in the scan; ``scan_times``;
    profile_resample rerun: no index moves between two calls.  Returns
    ``(max_abs_err, times, library_ms, profile_resample's result)``: the
    error is the largest difference from the plain version on the card
    at any size."""
    from slam_eslam_tpu_torch.core import filter as pf
    from slam_eslam_tpu_torch.tools import profile_resample

    max_err = scan_exactness(dev)
    w, pos = profile_resample.weights_and_positions(N_BENCH, dev)
    idx = pf.resample_from_positions(w, pos)
    mism, worst = profile_resample.check_search(
        idx, profile_resample.searched_cumsum(w), pos)
    print(f"ordered_scan: {N_BENCH} ancestors bracket their positions in "
          f"the scan; a host bisect stops elsewhere at {mism} (at most "
          f"{worst} apart)")
    times = scan_times(dev, card)
    res, launches, _ = run_tool("profile_resample",
                                ("--particles", str(N_BENCH), "--iters",
                                 "50"))
    check(res["differs"] == 0, "profile_resample",
          f"{res['differs']} indices differ between two calls")
    return max_err, times, times.pop("library_ms"), res


def one_rank_world(dev, card):
    """(b) A world of one NCCL rank on the card: every meshed runner run
    eagerly (``graph=False``) and as CUDA graphs (``graph=True``: an NCCL
    mesh captures) from the same generator state, each bit for bit the
    unmeshed eager runner, with the kernels' launches counted (a replay
    credits its graph's; a capture that met a host read would have
    raised): the localisation runner at the benchmark shape, the
    filter step with the ring-hop resampler, the SLAM runner at 4,096
    particles over 200 frames with the pool whole (``map_pool_shards`` 1
    and 2) and split (``shard_pool``), ``OnlineSlam(mesh=)`` over two
    chunks, and the meshed PCG and Schur solves at 1,024 nodes (against
    the CPU port too).  Returns the launches and the runs' seconds."""
    import torch.distributed as dist

    from slam_eslam_tpu_torch import bench, ops
    from slam_eslam_tpu_torch.dryrun import GATE
    from slam_eslam_tpu_torch.filter import step as steplib
    from slam_eslam_tpu_torch.mapping.lookup import make_lookup
    from slam_eslam_tpu_torch.parallel import resample as dres
    from slam_eslam_tpu_torch.parallel import sharding as shd
    from slam_eslam_tpu_torch.utils import tree

    mesh = shd.make_mesh(1, device=dev)
    t = torch.ones(4, device=dev)
    dist.all_reduce(t)
    print(f"one-rank world: {mesh.describe()}; NCCL all_reduce on the card "
          f"{t.tolist()}")
    check(mesh.backend == "nccl" and mesh.transport == "nccl"
          and bool((t == 1).all()), "one-rank world", mesh.describe())
    out = {"mesh": mesh.describe(), "nccl_capture": nccl_capture(dev, card)}

    def counted(fn):
        """``fn()`` with the launches it made, and its seconds (host
        clock ending in a sync)."""
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = {k: v for k, v in ops.launch_counts().items() if v}
        return res, launched, secs

    try:
        cfg, grid, css, qs, _, particles = bench_setup(N_BENCH, STEPS)
        grid_d, css_d, qs_d = tree.to(grid, dev), tree.to(css, dev), qs.to(dev)
        lookup_m = make_lookup(cfg, grid_d, mesh)
        plain = steplib.make_scan_runner(cfg, make_lookup(cfg, grid_d),
                                         graph=False)
        ref = plain(fresh_state(cfg, particles, dev), css_d, qs_d)
        for mode in ("eager", "graphed"):
            meshed = steplib.make_scan_runner(cfg, lookup_m, mesh=mesh,
                                              graph=mode == "graphed")
            state0 = shd.shard_state(fresh_state(cfg, particles, dev), mesh)
            got, launches, secs = counted(
                lambda: meshed(state0, css_d, qs_d))
            equal, _ = equal_bits((got[1], got[0].particles),
                                  (ref[1], ref[0].particles))
            print(f"one-rank world: make_scan_runner(mesh=)[{mode}] {STEPS} "
                  f"steps x {N_BENCH} particles in {secs:.4f} s, equal bit "
                  f"for bit to the unmeshed eager runner: {equal}; launches "
                  f"{launches}"
                  + (f", graphs {meshed.graphs.counts()}"
                     if meshed.graphs else "") + f" [{card}]")
            check(equal and launches.get("contact_fold") == STEPS
                  and launches.get("ordered_scan") == STEPS,
                  f"one-rank localisation {mode}",
                  f"equal {equal}, launches {launches}")
            out[f"localize_{mode}"] = dict(launches=launches, s=secs)
            del got, state0
        del ref

        # the ring-hop resampler in a forced-resample step
        forced = dataclasses.replace(cfg, min_effective=float(N_BENCH))
        runs = {}
        for mode in ("eager", "graphed"):
            step = steplib.make_filter_step(
                forced, lookup_m, mesh=mesh,
                resampler=dres.make_ppermute_resampler(mesh),
                graph=mode == "graphed")

            def steps():
                st = shd.shard_state(fresh_state(forced, particles, dev),
                                     mesh)
                for k in range(PPERMUTE_STEPS):
                    st, _ = step(st, tree.index(css_d, k), qs_d[k], GATE)
                return st.particles

            runs[mode] = counted(steps)
        equal, _ = equal_bits(runs["graphed"][0], runs["eager"][0])
        print(f"one-rank world: make_filter_step(mesh=, ppermute resampler) "
              f"{PPERMUTE_STEPS} forced-resample steps x {N_BENCH}: graphed "
              f"equal bit for bit to eager: {equal}; launches eager "
              f"{runs['eager'][1]}, graphed {runs['graphed'][1]}; "
              f"{runs['eager'][2]:.4f} s eager, {runs['graphed'][2]:.4f} s "
              f"graphed [{card}]")
        check(equal and runs["eager"][1] == runs["graphed"][1]
              and runs["eager"][1].get("contact_fold") == PPERMUTE_STEPS,
              "one-rank ppermute step",
              f"equal {equal}, launches "
              f"{ {m: r[1] for m, r in runs.items()} }")
        out["ppermute"] = {m: r[1:] for m, r in runs.items()}
        del runs

        t0 = time.perf_counter()
        out["slam"] = one_rank_slam(mesh, counted, dev, card)
        t1 = time.perf_counter()
        out["online"] = one_rank_online(mesh, dev, card)
        t2 = time.perf_counter()
        out["solves"] = one_rank_solves(mesh, dev, card)
        print(f"one-rank world seconds: SLAM {t1 - t0:.1f}, OnlineSlam "
              f"{t2 - t1:.1f}, solves {time.perf_counter() - t2:.1f} "
              f"[{card}]")
    finally:
        dist.destroy_process_group()
    return out


def nccl_capture(dev, card):
    """An NCCL collective inside a CUDA graph on the one-rank world: the
    communicator made by an eager call first, then an ``all_reduce`` and an
    ``all_gather_into_tensor`` captured (``async_op=False``) and replayed
    ten times, the watchdog left a second to look at them.  (The mesh's
    own collectives skip NCCL on one rank, so this is the one place the
    card captures one.)"""
    import torch.distributed as dist

    x = torch.arange(4.0, device=dev)
    out = torch.empty(4, device=dev)
    dist.all_reduce(x)
    dist.all_gather_into_tensor(out, x)
    torch.cuda.synchronize()
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            dist.all_reduce(x)
            dist.all_gather_into_tensor(out, x)
            out.add_(1.0)
        for _ in range(10):
            graph.replay()
        torch.cuda.synchronize()
        time.sleep(1.0)
        dist.barrier()
        msg = (f"works: {out.tolist()}, as eager: "
               f"{out.tolist() == [1.0, 2.0, 3.0, 4.0]}")
    except RuntimeError as e:
        msg = "fails: " + " | ".join(str(e).splitlines()[:3])[:600]
    print(f"one-rank world: NCCL all_reduce and all_gather captured in a "
          f"CUDA graph and replayed 10 times: {msg} [{card}]")
    return msg


def one_rank_slam(mesh, counted, dev, card):
    """The SLAM runner on the one-rank mesh, eager and graphed, the pool
    whole (``map_pool_shards`` 1 and 2: range-local allocation on one
    rank) and split (``shard_pool``: the meshed pool's exchanges), each
    against the unmeshed eager runner with the same ``map_pool_shards``:
    pool, chains and centroids bit for bit, K2/K3/S1 launches as the gates
    want."""
    from slam_eslam_tpu_torch import bench
    from slam_eslam_tpu_torch.filter import streaming
    from slam_eslam_tpu_torch.parallel import sharding as shd
    from slam_eslam_tpu_torch.utils import tree

    cfg = slam_config()
    z0, frames, full, qs = slam_setup()
    frames_d = tree.to(frames, dev)
    odos = streaming.precompute_odometry(20, tree.to(full, dev), qs.to(dev),
                                         cfg=cfg)
    layouts = {"pool whole": (cfg, False), "pool split": (cfg, True),
               "pool whole, map_pool_shards 2": (dataclasses.replace(
                   cfg, map_pool_shards=2), False)}
    fields = ("chain", "meta", "mean", "stdev", "height", "origin")
    out, refs = {}, {}
    for name, (c, split) in layouts.items():
        if c.map_pool_shards not in refs:
            refs.clear()
            gc_cuda()
            refs[c.map_pool_shards] = bench.make_slam_runner(c)(
                slam_carry(c, z0, dev), frames_d, odos)
        ref, ref_aux = refs[c.map_pool_shards]
        for mode in ("eager", "graphed"):
            carry = slam_carry(c, z0, dev)
            carry = dataclasses.replace(
                carry, filter=shd.shard_state(carry.filter, mesh),
                pool=shd.shard_pool(carry.pool, mesh) if split
                else carry.pool)
            run = streaming.make_slam_scan_runner(
                c, laser2body=(np.eye(3), np.zeros(3)),
                external_odometry=True, mesh=mesh, graph=mode == "graphed")
            (got, aux), launches, secs = counted(
                lambda: run(carry, frames_d, odos))
            n_meas = int(aux["updated"].sum())
            n_map = int(aux["mapped"].sum())
            want = {"chain_lookup": n_meas + (n_map if c.use_visual_update
                                              else 0),
                    "block_merge": n_map, "ordered_scan": n_meas}
            if not split:   # a meshed pool writes its rows by exchange
                want["row_copy"] = 2 * n_map
            pool = shd.gather_pool(got.pool, mesh)
            equal, _ = equal_bits(
                ([getattr(pool, f) for f in fields], aux["centroid"],
                 aux["best_pose"], got.filter.particles),
                ([getattr(ref.pool, f) for f in fields], ref_aux["centroid"],
                 ref_aux["best_pose"], ref.filter.particles))
            print(f"one-rank world: make_slam_scan_runner(mesh=)[{name}, "
                  f"{mode}] {len(frames)} frames x {SLAM_N} particles in "
                  f"{secs:.4f} s, pool, chains, state and centroids equal "
                  f"bit for bit to the unmeshed eager runner: {equal}; "
                  f"launches {launches} (gates {n_meas} measurement, "
                  f"{n_map} mapping)"
                  + (f", graphs {run.counts()}" if mode == "graphed" else "")
                  + f" [{card}]")
            check(equal and launches == want and n_meas and n_map,
                  f"one-rank SLAM {name} {mode}",
                  f"equal {equal}, launches {launches}, want {want}")
            out[f"{name} {mode}"] = dict(launches=launches, s=secs)
            del got, carry, pool, run
    refs.clear()
    gc_cuda()
    return out


def one_rank_online(mesh, dev, card):
    """``OnlineSlam(mesh=)`` on the one-rank mesh over two chunks of the
    online path's stream, eager and graphed (``run_stream``, keyframe
    grids and sweeps, solve): the same centroids, best poses, state,
    keyframes and solved trajectory bit for bit."""
    from slam_eslam_tpu_torch import bench
    from slam_eslam_tpu_torch.online import OnlineSlam
    from slam_eslam_tpu_torch.parallel import sharding as shd
    from slam_eslam_tpu_torch.utils import tree

    cfg = slam_config()
    z0, frames, _, _ = bench.slam_trajectory(2 * ONLINE_CHUNK // 10, 0)
    normals, draws = slam_draws(2 * ONLINE_CHUNK)
    res = {}
    for mode in ("eager", "graphed"):
        s = OnlineSlam(config=cfg, laser2body=(np.eye(3), np.zeros(3)),
                       keyframe_kw=ONLINE_KEYFRAMES, mesh=mesh, device=dev,
                       graph=mode == "graphed")
        s.init(pose=(np.array([0.0, 0.0, z0]), 0.0), num_contact_points=20,
               normal_xy=normals[0].to(dev), normal_yaw=normals[1].to(dev))
        s.filter.state = shd.shard_state(s.filter.state, mesh)
        seq = []
        for c in range(2):
            sl = slice(c * ONLINE_CHUNK, (c + 1) * ONLINE_CHUNK)
            aux = s.process_chunk(frames.at(sl), draws=[
                tree.to(x, dev) for x in draws[sl]])
            traj, hist = s.optimize()
            seq.append((aux["centroid"], aux["best_pose"],
                        torch.from_numpy(traj), hist))
        res[mode] = (seq, s.filter.state.particles, list(s.keyframe_frames))
        del s
    equal, _ = equal_bits(res["graphed"][:2], res["eager"][:2])
    equal = equal and res["graphed"][2] == res["eager"][2]
    print(f"one-rank world: OnlineSlam(mesh=) 2 chunks of {ONLINE_CHUNK} "
          f"frames x {SLAM_N} particles: graphed equal bit for bit to eager "
          f"(chunks, state, keyframes {res['eager'][2]}, solves): {equal} "
          f"[{card}]")
    check(equal, "one-rank OnlineSlam", f"equal {equal}")
    return dict(keyframes=res["eager"][2])


def one_rank_solves(mesh, dev, card):
    """The meshed PCG and Schur solves at 1,024 nodes on the one-rank
    mesh: eager against the CPU port, graphed bit for bit the eager
    solve, ms per optimize both ways (CUDA events)."""
    from slam_eslam_tpu_torch.backend import pose_graph as pg
    from slam_eslam_tpu_torch.models import sim
    from slam_eslam_tpu_torch.utils import graphs, tree

    g_dev, _ = sim.circle_pose_graph(3, PG_NODES, seed=2, outlier=True,
                                     device=dev)
    g_cpu = tree.to(g_dev, "cpu")
    out = {}
    for name, solve in (
            ("pcg", lambda g, m, cg=None: pg.optimize_cg(
                g, PG_ITERS, cg_iters=PG_CG_ITERS, mesh=m, cuda_graphs=cg)),
            ("schur", lambda g, m, cg=None: pg.optimize_schur(
                g, PG_ITERS, segments=PG_SEGMENTS, boundary_cap=PG_CAP,
                mesh=m, cuda_graphs=cg))):
        solve(g_dev, mesh)                               # warm-up
        (res, hist), ms, _, _ = timed_call(lambda: solve(g_dev, mesh))
        err = pose_err(res.nodes.cpu(), solve(g_cpu, None)[0].nodes)
        cg = graphs.CallGraphs(graphs.Capture(), f"meshed {name}")
        solve(g_dev, mesh, cg)
        solve(g_dev, mesh, cg)
        got, gms, _, _ = timed_call(lambda: solve(g_dev, mesh, cg))
        equal, _ = equal_bits(got, (res, hist))
        print(f"one-rank world: {name}(mesh=) at {PG_NODES} nodes, "
              f"{ms:.4f} ms per optimize eager, {gms:.4f} ms graphed "
              f"(events), graphed equal bit for bit to eager: {equal}, "
              f"graphs {cg.counts()}; vs the CPU port {err:.3e} [{card}]")
        check(err <= PG_NODE_ATOL and equal,
              f"one-rank {name}", f"nodes {err}, equal {equal}")
        out[name] = dict(err=err, ms=ms, graphed_ms=gms)
        del cg
    return out


def nccl_probe(mesh):
    """A rank of the shared-card NCCL probe: one all_reduce."""
    import torch.distributed as dist

    t = torch.full((4,), float(mesh.rank + 1), device=mesh.device)
    dist.all_reduce(t)
    torch.cuda.synchronize(mesh.device)
    return t.tolist()


def shared_card_nccl(card):
    """What NCCL does with two ranks on one card (the reason ranks that
    share a card take gloo): a two-rank NCCL world on card 0, one
    all_reduce, 60 s at most.  Prints and returns the outcome."""
    from slam_eslam_tpu_torch.parallel.distributed import run_world

    try:
        out = run_world(nccl_probe, 2, device="cuda", backend="nccl",
                        timeout=60)
        msg = f"works: all_reduce of 1 and 2 gave {out[0]}"
    except (RuntimeError, TimeoutError) as e:
        lines = [ln.strip() for ln in str(e).splitlines() if ln.strip()]
        said = [ln for ln in lines if "NCCL" in ln or "nccl" in ln]
        msg = "fails: " + " | ".join((said or lines)[-3:])[:600]
    print(f"NCCL with two ranks on one card: {msg} [{card}]", flush=True)
    return msg


# K8 at the benchmark cell's pool (slam_1k_f32: 1,000 particles, 400 x 400
# cells x 4 slots at 0.05 m, float32, no colour; two blocks a particle, so
# every particle can take a copy and then a new head), and the masked rows
# of a 1,000-row call timed there
ROW_CELL_POOL = dict(nx=400, ny=400, k=4, resolution=0.05, chain_len=3)
ROW_CELL_N = 1000
ROW_CELL_PARTS = 20
ROW_SPREAD = (0, 1, 32, 1000)
ROW_SPREAD_REPS = 20


def recorded_row_copies(fn):
    """``fn()`` with every ``ops.row_copy`` call the map pool makes
    recorded instead of run: ``[(fields, dst, src, mask, fill)]``, the
    ``[N]`` operands cloned (the pool's chains and flags still change)."""
    from slam_eslam_tpu_torch.mapping import map_pool as mp

    calls = []
    keep = lambda t: None if t is None else t.clone()

    def record(fields, dst, src, mask, fill=None):
        calls.append((tuple(fields), dst.clone(), keep(src), mask.clone(),
                      None if fill is None else tuple(map(keep, fill))))
        return fields

    real, mp.rc = mp.rc, SimpleNamespace(row_copy=record)
    try:
        fn()
    finally:
        mp.rc = real
    return calls


def own_heads_calls(pool, dev, seed):
    """The map pool's two ``ops.row_copy`` calls of one mapping frame, on
    ``pool`` (chain tails emptied): the copy-on-write after a resampling
    of every particle (``profile_resample``'s weights and strata through
    ``core.filter.resample_from_positions``), then the rollover with every
    particle far off its grid.  Returns ``{"copy": call, "fill": call}``
    as ``recorded_row_copies`` gives them."""
    from slam_eslam_tpu_torch.core import filter as pf
    from slam_eslam_tpu_torch.mapping import map_pool as mp
    from slam_eslam_tpu_torch.tools import profile_resample

    pool.chain[:, 1:] = -1
    w, pos = profile_resample.weights_and_positions(pool.n, dev, seed)
    pool.resample_(pf.resample_from_positions(w, pos))
    far = torch.full((pool.n, 2), 1e4, device=dev)
    copy, fill = recorded_row_copies(lambda: (
        mp.ensure_unique_active(pool), mp.rollover(pool, far, 1.0)))
    return {"copy": copy, "fill": fill}


def row_copy_bytes(call):
    """The bytes one ``ops.row_copy`` call must move: the mask, the
    masked rows' ``dst`` (and ``src``), and per field the masked rows
    written and the rows they come from read once (a source that several
    rows copy, as after a resampling, once; a fill form's own rows; none
    for zeros)."""
    fields, dst, src, mask, fill = call
    m = int(mask.sum())
    fill = fill or (None,) * len(fields)
    read = (int(torch.unique(src[mask]).numel()) if src is not None
            else m)
    moved = sum(f[0].numel() * f.element_size()
                * (m + (read if src is not None or v is not None else 0))
                for f, v in zip(fields, fill))
    return mask.numel() + m * (8 if src is not None else 4) + moved


def row_copy_case(label, call):
    """One recorded call on the card: the kernel against its plain version
    bit for bit from the same pool (raises on a mismatch), then every time
    of a kernel row (``kernel_times``; the plain version reads the mask on
    the host, so its time is the profiler's) with its byte bound."""
    from slam_eslam_tpu_torch.ops import row_copy as rc

    fields, dst, src, mask, fill = call
    want = [f.clone() for f in fields]
    rc.row_copy_reference(want, dst, src, mask, fill)
    rc.row_copy(fields, dst, src, mask, fill)
    same = all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
               for a, b in zip(fields, want))
    del want
    gc_cuda()
    m, n = int(mask.sum()), mask.numel()
    sources = "" if src is None else (
        f" from {int(torch.unique(src[mask]).numel())} sources")
    print(f"row_copy[{label}]: {m} of {n} rows masked{sources}, "
          f"{'copy' if src is not None else 'fill'} form, "
          f"{len(fields)} fields; the kernel equal bit for bit to its plain "
          f"version: {same}")
    check(same, f"row_copy[{label}]", "the kernel differs from its plain "
                                      "version")
    launch_fill = fill or (None,) * len(fields)
    times = kernel_times(
        f"row_copy[{label}]", lambda: rc.row_copy(fields, dst, src, mask,
                                                  fill),
        lambda: rc.launch(fields, dst, src, mask, launch_fill),
        "row_copy_kernel",
        lambda: rc.row_copy_reference(fields, dst, src, mask, fill),
        bound(row_copy_bytes(call)))
    return dict(times, masked_rows=m, rows=n)


def check_row_copy(dev, card):
    """K8 (``csrc/row_copy.cu``): the copy-on-write after a resampling and
    the rollover of one mapping frame (``own_heads_calls``), each against
    its plain version bit for bit and timed (``row_copy_case``), at the
    SLAM path's pool (SLAM_N particles, 40 x 40 cells) and at the benchmark
    cell's (ROW_CELL_N particles, 10.24 MB blocks); at the cell's pool also
    ROW_SPREAD masked rows of one call of ROW_CELL_N rows, the device time
    beside the byte bound (0 rows: the fixed cost).  Returns the row's
    times: the SLAM path's copy-on-write, the rest under suffixes."""
    from slam_eslam_tpu_torch.models import sim
    from slam_eslam_tpu_torch.ops import row_copy as rc
    from slam_eslam_tpu_torch.utils import profiling

    times = {}
    pools = (("", SLAM_N, slam_config().map_pool_blocks, SLAM_POOL, 1),
             ("_cell", ROW_CELL_N, 2 * ROW_CELL_N, ROW_CELL_POOL,
              ROW_CELL_PARTS))
    for tag, n, blocks, shape, parts in pools:
        pool = sim.random_pool(n, blocks, **shape, seed=21, device=dev,
                               parts=parts)
        print(f"row_copy pool ({'the cell' if tag else 'the SLAM path'}): "
              f"{n} particles, "
              f"{blocks} blocks of {pool.nx}x{pool.ny}x{pool.k}, "
              f"{pool.storage_bytes() / blocks / 1e6:.3f} MB a block")
        calls = own_heads_calls(pool, dev, seed=22)
        for form, call in calls.items():
            row = row_copy_case(f"{n} {form}", call)
            suffix = tag + ("" if form == "copy" else "_fill")
            times.update({key + suffix: v for key, v in row.items()})
        if tag:
            fields = calls["copy"][0]
            dst = torch.arange(n, 2 * n, dtype=torch.int32, device=dev)
            src = torch.arange(n, dtype=torch.int32, device=dev)
            for m in ROW_SPREAD:
                mask = torch.zeros(n, dtype=torch.bool, device=dev)
                mask[torch.linspace(0, n - 1, m, device=dev).long()] = True
                ms = profiling.device_time(
                    lambda: rc.launch(fields, dst, src, mask,
                                      (None,) * len(fields)),
                    ROW_SPREAD_REPS, replays=3) * 1e3
                b_ms = bound(row_copy_bytes((fields, dst, src, mask,
                                             None)))[0]
                times.update({f"ms_masked_{m}": ms,
                              f"bound_ms_masked_{m}": b_ms})
                print(f"row_copy[{m} of {n} masked]: {ms:.5f} ms (graph of "
                      f"{ROW_SPREAD_REPS} launches), bound {b_ms:.5f} ms "
                      f"({b_ms / ms:.3f} of it) [{card}]")
        del pool, calls
        gc_cuda()
    return times


# phase 15: the cloud merge CM at the camera cell's shape (slam_cam_1k_f32:
# 1,000 particles, a float32 colour pool of 4,000 blocks of 400 x 400
# cells x 4 slots at 0.05 m, 71.68 GB; a 640 x 480 textured distance
# image), and beside K3 at the laser cell's (1,081 rays, no colour)
CM_N, CM_BLOCKS = 1000, 4000
CM_GRID = dict(nx=400, ny=400, k=4, resolution=0.05)
CM_IMAGE = (480, 640)            # rows, columns
CM_FOV_X = np.radians(60.0)
CM_PITCH = np.radians(38.0)      # down from the direction of travel
CM_MOUNT = (0.0, 0.3, 0.25)      # m: camera to body, body +y ahead
CM_CAMERA_HEIGHT = 0.45          # m above the flat ground
CM_INVALID = 0.03                # share of pixels with no distance
CM_TEMPLATES = 8                 # distinct head contents (random blocks)
CM_GROUP = 25                    # heads the plain version merges at once
CM_CPU_HEADS = 40                # heads held against the CPU's plain version
# the card's plain version adds a cell's points in index_put_'s order, not
# in point order, so its floats (metres, colour in [0, 1]) agree with the
# kernel's to the rounding of sums of hundreds of terms (3.4e-6 read)
CM_CARD_ATOL = 1e-4
CM_REPS = 20                     # launches a graph at the cell's shape
CM_UPDATE = 9
CM_LASER_RAYS = 1081             # slam_1k_f32's Hokuyo UTM-30LX: 270 deg
CM_LASER_REPS = 100


def camera_frame_cloud(dev, seed):
    """The camera cell's cloud: a distance image of flat ground
    CM_CAMERA_HEIGHT below the camera (``drive_camera``'s mount and
    intrinsics), CM_INVALID of its pixels without a distance, a random
    texture, through ``streaming.camera_cloud`` at an upright pose."""
    from slam_eslam_tpu_torch import Config
    from slam_eslam_tpu_torch.filter import streaming
    from slam_eslam_tpu_torch.mapping import projection

    h, w = CM_IMAGE
    s = float(np.tan(CM_FOV_X / 2) / (w / 2))
    cx, cy = -s * (w - 1) / 2, -s * (h - 1) / 2
    a = -CM_PITCH
    pitch = torch.tensor([[1.0, 0.0, 0.0], [0.0, np.cos(a), -np.sin(a)],
                          [0.0, np.sin(a), np.cos(a)]], dtype=torch.float64)
    axes = torch.tensor([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, -1.0, 0.0]],
                        dtype=torch.float64)
    rot = pitch @ axes                                   # camera to body
    u = torch.arange(w, dtype=torch.float64).repeat(h) * s + cx
    v = torch.arange(h, dtype=torch.float64).repeat_interleave(w) * s + cy
    down = -(torch.stack([u, v, torch.ones_like(u)], -1) @ rot.T)[:, 2]
    depth = torch.where(down > 0, CM_CAMERA_HEIGHT / down,
                        torch.full_like(down, float("inf")))
    gen = torch.Generator().manual_seed(seed)
    depth[torch.rand(h * w, generator=gen) < CM_INVALID] = float("nan")
    f32 = dict(dtype=torch.float32, device=dev)
    img = projection.DistanceImage(
        depth.reshape(h, w).to(**f32), *(torch.tensor(c, **f32)
                                        for c in (s, s, cx, cy)))
    texture = torch.rand(h, w, 3, generator=gen).to(dev)
    return streaming.camera_cloud(
        Config(max_sensor_range=3.0), img,
        torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev), rot.to(**f32),
        torch.tensor(CM_MOUNT, **f32), texture)


def laser_cloud(dev):
    """A scan of CM_LASER_RAYS rays over 270 degrees at 1.5-2.5 m,
    projected with an identity mount and orientation."""
    from slam_eslam_tpu_torch.mapping import projection

    a = torch.arange(CM_LASER_RAYS, device=dev, dtype=torch.float32)
    scan = projection.LaserScan(
        2.0 + 0.5 * torch.sin(a / 37.0),
        torch.tensor(-0.75 * np.pi, dtype=torch.float32, device=dev),
        torch.tensor(1.5 * np.pi / (CM_LASER_RAYS - 1), dtype=torch.float32,
                     device=dev))
    pts, valid = projection.scan_to_points(scan, 3.0)
    return projection.project_points(
        pts, valid, torch.eye(3, device=dev), torch.zeros(3, device=dev),
        torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev))


def float_steps(a, b):
    """Per-element distance, in float32 steps, of two float32 tensors of
    one sign per element."""
    return (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()


def cloud_merge_pool(dev):
    """The camera cell's pool (CM_BLOCKS blocks, colour; fields left
    uninitialised but for the heads and block 1) with CM_N heads spread
    over it from block 0 to the last, head ``i`` a copy of template ``i %
    CM_TEMPLATES`` (a ``sim.random_pool`` block with random colour).
    Returns ``(pool, templates, template index of
    each head)``; block 1, no head, holds template 0.  Every block's
    origin puts (0, 0) at its centre."""
    from slam_eslam_tpu_torch.mapping.map_pool import MapPool
    from slam_eslam_tpu_torch.models import sim

    nx, k = CM_GRID["nx"], CM_GRID["k"]
    shape = (CM_BLOCKS, nx, CM_GRID["ny"] * k)
    new = lambda dtype, s=shape: torch.empty(s, dtype=dtype, device=dev)
    heads = torch.linspace(0, CM_BLOCKS - 1, CM_N, device=dev).round().int()
    pool = MapPool(
        mean=new(torch.float32), stdev=new(torch.float32),
        height=new(torch.float32), meta=new(torch.int32),
        color=new(torch.float32, shape[:2] + (shape[2] * 3,)),
        origin=torch.full((CM_BLOCKS, 2), -nx * CM_GRID["resolution"] / 2,
                          device=dev),
        allocated=torch.zeros(CM_BLOCKS, dtype=torch.bool, device=dev),
        chain=torch.full((CM_N, 3), -1, dtype=torch.int32, device=dev),
        resolution=CM_GRID["resolution"], nx=nx, ny=CM_GRID["ny"], k=k)
    pool.chain[:, 0] = heads
    pool.allocated[heads.long()] = True
    tmpl = sim.random_pool(CM_TEMPLATES, CM_TEMPLATES, nx, CM_GRID["ny"],
                           k=k, resolution=CM_GRID["resolution"], seed=41,
                           device=dev)
    gen = torch.Generator(dev).manual_seed(42)
    tmpl.color = torch.rand(tmpl.mean.shape[:2] + (shape[2] * 3,),
                            generator=gen, device=dev)
    which = torch.arange(CM_N, device=dev) % CM_TEMPLATES
    for name in ("mean", "stdev", "height", "meta", "color"):
        field, src = getattr(pool, name), getattr(tmpl, name)
        for lo in range(0, CM_N, 100):
            field.index_copy_(0, heads[lo:lo + 100].long(),
                              src.index_select(0, which[lo:lo + 100]))
        field[1] = src[0]
    return pool, tmpl, which


def cloud_merge_operands(pool, cloud, seed):
    """``cm.cloud_merge``'s operands after the fields, as
    ``map_pool.merge_cloud_all`` hands them over: the CM_N poses within
    5 cm and 2 degrees of (0, 0), lifted to put the ground near the
    templates' slot means (0.3 m)."""
    dev = pool.mean.device
    gen = torch.Generator(dev).manual_seed(seed)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    xy = 0.05 * randn(CM_N, 2)
    yaw = 0.3 + 0.035 * randn(CM_N)
    z = CM_CAMERA_HEIGHT - CM_MOUNT[2] + 0.3 + 0.02 * randn(CM_N)
    zs = 0.05 * torch.rand(CM_N, generator=gen, device=dev)
    return (pool.origin, pool.chain[:, 0].contiguous(),
            xy[:, 0].contiguous(), xy[:, 1].contiguous(), torch.cos(yaw),
            torch.sin(yaw), z, zs, cloud.xy.contiguous(),
            cloud.z.contiguous(), cloud.stdev.contiguous(),
            cloud.valid.contiguous(),
            None if cloud.color is None else cloud.color.contiguous()), yaw


def plain_heads(pool, tmpl, which, args, idx, device, counts=None):
    """The plain version (``cm.cloud_merge_reference``) on ``device`` for
    the particles ``idx``, CM_GROUP at a time, each head started from its
    template, with ``args`` (``cloud_merge_operands``), held against the
    kernel's heads in ``pool``: ``{"differ": {field: elements not equal
    bit for bit}, "stdev_steps": the most float32 steps a stdev differs,
    "max_err": the largest absolute difference of a float field}``;
    ``counts`` adds up the plain version's counters."""
    from slam_eslam_tpu_torch.mapping.map_pool import MapPool
    from slam_eslam_tpu_torch.ops import cloud_merge as cm

    names = ("mean", "stdev", "height", "meta", "color")
    heads = args[1].long()
    to = lambda t: t if t is None else t.to(device)
    cloud = [to(a) for a in args[8:]]
    out = dict(differ=dict.fromkeys(names, 0), stdev_steps=0, max_err=0.0)
    for lo in range(0, len(idx), CM_GROUP):
        sel = idx[lo:lo + CM_GROUP].to(pool.mean.device)
        g = len(sel)
        part = MapPool(**{name: to(getattr(tmpl, name).index_select(
                              0, which[sel])) for name in names},
                       origin=to(pool.origin.index_select(0, heads[sel])),
                       allocated=torch.ones(g, dtype=torch.bool,
                                            device=device),
                       chain=torch.arange(g, dtype=torch.int32,
                                          device=device)[:, None],
                       resolution=pool.resolution, nx=pool.nx, ny=pool.ny,
                       k=pool.k)
        cm.cloud_merge_reference(
            *(getattr(part, name) for name in names), part.origin,
            part.chain[:, 0].contiguous(),
            *(to(a.index_select(0, sel)) for a in args[2:8]), *cloud,
            CM_UPDATE, counts, k=pool.k, resolution=pool.resolution)
        for name in names:
            got = to(getattr(pool, name).index_select(0, heads[sel]))
            want = getattr(part, name)
            bad = got.view(torch.int32) != want.view(torch.int32)
            out["differ"][name] += int(bad.sum())
            if name == "stdev" and bad.any():
                out["stdev_steps"] = max(out["stdev_steps"],
                                         int(float_steps(got, want).max()))
            if name != "meta":
                out["max_err"] = max(out["max_err"],
                                     float((got - want).abs().max()))
        del part, got, want
    return out


def check_cloud_merge(dev, card):
    """CM (``csrc/cloud_merge.cu``) at the camera cell's shape: one call
    of ``cm.cloud_merge`` on the pool of ``cloud_merge_pool`` (its last
    block a head: colour offsets past 2^32), launches counted from a reset
    just before; held against the plain version
    ``cm.cloud_merge_reference`` from the heads' templates with the same
    operands (``plain_heads``): on the CPU, which adds in point order as
    the kernel does, at CM_CPU_HEADS heads from the first to the last
    (mean, height, meta and colour bit for bit, stdev within one float32
    step), and on the card at every head (meta bit for bit, floats within
    CM_CARD_ATOL, the counters equal); block 1, no head, untouched; timed
    as a kernel row with its
    bound from ``benchmark/roofline/merge_cloud.py``'s counts.  Then at
    the laser cell's shape, the merge of CM_LASER_RAYS points under
    CM_N poses into the same heads without colour, in turns: K3 alone, K3
    with its operands (``map_pool.merge_operands``) and CM with its
    bounds, each as ``merge_cloud_all`` runs it."""
    from benchmark.roofline import merge_cloud as roof
    from slam_eslam_tpu_torch import ops
    from slam_eslam_tpu_torch.mapping import map_pool as mp
    from slam_eslam_tpu_torch.ops import block_merge as bm
    from slam_eslam_tpu_torch.ops import cloud_merge as cm
    from slam_eslam_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    pool, tmpl, which = cloud_merge_pool(dev)
    cloud = camera_frame_cloud(dev, seed=43)
    args, yaw = cloud_merge_operands(pool, cloud, seed=44)
    heads = args[1]
    names = ("mean", "stdev", "height", "meta", "color")
    fields = [getattr(pool, name) for name in names]
    kw = dict(k=pool.k, resolution=pool.resolution)
    spare = [f[1].clone() for f in fields]
    valid = int(cloud.valid.sum())
    counters = torch.zeros(2, dtype=torch.int64, device=dev)
    torch.cuda.synchronize()
    print(f"cloud_merge: pool of {CM_BLOCKS} blocks "
          f"({pool.storage_bytes() / 1e9:.2f} GB with colour), {CM_N} heads "
          f"from block {int(heads[0])} to {int(heads[-1])}, a "
          f"{CM_IMAGE[1]}x{CM_IMAGE[0]} image: {valid} valid pixels of "
          f"{cloud.p}; set up in {time.perf_counter() - t0:.1f} s")
    ops.reset_launch_counts()
    cm.cloud_merge(*fields, *args, CM_UPDATE, counters, **kw)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    want = dict(dict.fromkeys(WRAPPERS, 0), cloud_merge=1)
    check(launches == want, "cloud_merge", f"launches {launches}, want "
                                           f"{want}")
    check(all(torch.equal(a, b) for a, b in zip(spare, (f[1] for f in
                                                       fields))),
          "cloud_merge", "block 1, no particle's head, changed")
    del spare

    # the plain version from the heads' templates: on the CPU, whose sums
    # go in point order as the kernel's, for CM_CPU_HEADS heads; on the
    # card for every head
    t1 = time.perf_counter()
    some = torch.linspace(0, CM_N - 1, CM_CPU_HEADS).round().long()
    cpu_diff = plain_heads(pool, tmpl, which, args, some, "cpu")
    t2 = time.perf_counter()
    ref_counts = torch.zeros(2, dtype=torch.int64, device=dev)
    card_diff = plain_heads(pool, tmpl, which, args,
                            torch.arange(CM_N, device=dev), dev, ref_counts)
    gc_cuda()
    same_counts = torch.equal(counters, ref_counts)
    placed, cells = (int(c) for c in counters.cpu())
    print(f"cloud_merge: the kernel against its plain version on the CPU "
          f"over {CM_CPU_HEADS} heads, blocks {int(heads[some[0]])} to "
          f"{int(heads[some[-1]])} ({t2 - t1:.1f} s): elements that differ "
          f"{cpu_diff['differ']} (stdev at most {cpu_diff['stdev_steps']} "
          f"float32 steps), max abs difference {cpu_diff['max_err']:.3e}; "
          f"on the card over {CM_N} heads ({time.perf_counter() - t2:.1f} "
          f"s): {card_diff['differ']}, max abs difference "
          f"{card_diff['max_err']:.3e} (the card's plain version adds a "
          f"cell's points in index_put_'s order); counters {placed} "
          f"placements, {cells} cells written, equal to the plain "
          f"version's: {same_counts}")
    check(all(n == 0 for name, n in cpu_diff["differ"].items()
              if name != "stdev") and cpu_diff["stdev_steps"] <= 1,
          "cloud_merge", "the kernel differs from its plain version on the "
                         "CPU")
    check(card_diff["differ"]["meta"] == 0
          and card_diff["max_err"] <= CM_CARD_ATOL and same_counts,
          "cloud_merge", "the kernel differs from its plain version on the "
                         "card beyond rounding")
    max_err = cpu_diff["max_err"]

    # the bound, from the roofline module's own counts of the cell's work
    origin = pool.origin.index_select(0, heads.long())
    r_placed, r_cells = roof.placements(
        args[2], args[3], yaw, origin, cloud.xy, cloud.valid,
        pool.resolution, pool.nx, pool.ny)
    nbytes = roof.needed_bytes(CM_N, cloud.p, r_cells, pool.k, 4, True)
    flops = roof.needed_ops(r_placed, True)
    bnd = bound(nbytes, flops)
    print(f"cloud_merge: roofline counts {r_placed} placements, {r_cells} "
          f"cells ({nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} G operations): "
          f"bound {bnd[0]:.5f} ms ({bnd[1]})")
    upd = device_index(CM_UPDATE, dev)
    bounds = cm.cloud_bounds(cloud.xy, cloud.valid)
    ops.reset_launch_counts()
    times = kernel_times(
        "cloud_merge[camera cell]",
        lambda: cm.cloud_merge(*fields, *args, upd, **kw),
        lambda: cm.launch(*fields, *args, bounds, upd, **kw),
        "cloud_merge_kernel",
        lambda: cm.cloud_merge_reference(*fields, *args, CM_UPDATE, **kw),
        bnd, n_call=10, n_plain=1, reps=CM_REPS)
    timed = ops.launch_counts()["cloud_merge"]

    # the laser cell's shape: K3 against CM, no colour
    laser = laser_cloud(dev)
    largs, lyaw = cloud_merge_operands(pool, laser, seed=45)
    largs = largs[:-1] + (None,)
    f4 = fields[:4]
    lpool = dataclasses.replace(pool, color=None)
    xy = torch.stack([largs[2], largs[3]], -1)
    k3_ops = mp.merge_operands(lpool, xy, lyaw, largs[6], largs[7], laser)
    fns = {
        "k3": lambda: bm.launch(*f4, None, *k3_ops, upd, None, k=pool.k),
        "k3_operands": lambda: bm.launch(
            *f4, None, *mp.merge_operands(lpool, xy, lyaw, largs[6],
                                          largs[7], laser), upd, None,
            k=pool.k),
        "cm": lambda: cm.launch(*f4, None, *largs,
                                cm.cloud_bounds(largs[8], largs[11]), upd,
                                **kw)}
    order = list(fns) + list(reversed(fns))
    runs = [(name, profiling.device_time(fns[name], CM_LASER_REPS) * 1e3)
            for name in order]
    laser_ms = {name: sum(ms for n, ms in runs if n == name) / 2
                for name in fns}
    l_placed, l_cells = roof.placements(
        largs[2], largs[3], lyaw, origin, laser.xy, laser.valid,
        pool.resolution, pool.nx, pool.ny)
    l_bnd = bound(roof.needed_bytes(CM_N, laser.p, l_cells, pool.k, 4,
                                    False), roof.needed_ops(l_placed, False))
    print(f"cloud_merge vs K3 at the laser cell's shape ({CM_LASER_RAYS} "
          f"points x {CM_N} particles, float32, no colour; graphs of "
          f"{CM_LASER_REPS}, in turns {[(n, round(ms, 5)) for n, ms in runs]}"
          f"): K3 {laser_ms['k3']:.5f} ms alone, "
          f"{laser_ms['k3_operands']:.5f} ms with its operands; CM "
          f"{laser_ms['cm']:.5f} ms with its bounds; bound "
          f"{l_bnd[0]:.5f} ms ({l_bnd[1]}) [{card}]")
    del pool, tmpl, fields, args, k3_ops, lpool, fns
    gc_cuda()
    return dict(times, valid_pixels=valid, points=cloud.p,
                placements=placed, cells_written=cells,
                roofline_placements=r_placed, roofline_cells=r_cells,
                elements_differ=cpu_diff["differ"],
                stdev_steps=cpu_diff["stdev_steps"],
                elements_differ_card=card_diff["differ"],
                max_abs_err_card=card_diff["max_err"], max_abs_err=max_err, launches_check=launches["cloud_merge"],
                launches_timed=timed,
                **{f"laser_ms_{name}": ms for name, ms in laser_ms.items()},
                laser_bound_ms=l_bnd[0], laser_placements=l_placed)


def phase13(dev, card):
    """The ordered scan S1 and the multi-rank path (``parallel/``): (a)
    S1; (b) a world of one NCCL rank; (c) ``dryrun_multichip`` over
    DRYRUN_RANKS ranks (NCCL with a card each, else gloo ranks sharing
    this card, ``transport host``); (d) ``tools.bench_scaling``."""
    from slam_eslam_tpu_torch.dryrun import dryrun_multichip, remote_rows

    t0 = time.perf_counter()
    err, s1, s1_library, resample = check_ordered_scan(dev, card)
    t1 = time.perf_counter()
    world = one_rank_world(dev, card)
    gc_cuda()
    t2 = time.perf_counter()
    ranks = dryrun_multichip(DRYRUN_RANKS, device=dev.type, timeout=300)
    t3 = time.perf_counter()
    print(f"phase 13 seconds: S1 {t1 - t0:.1f}, one-rank world "
          f"{t2 - t1:.1f}, dryrun_multichip {t3 - t2:.1f} [{card}]")
    r0 = ranks[0]
    moved = remote_rows(ranks, "migrate")
    print(f"dryrun_multichip({DRYRUN_RANKS}): backend {r0['backend']}, "
          f"transport {r0['transport']}, ranks on "
          f"{[r['device'] for r in ranks]}"
          f"; rank 0's launches "
          f"{ {k: v for k, v in r0['launches'].items() if v} }; on the "
          f"migrating drive, rows from other ranks {moved} [{card}]")
    check(all(r["launches"]["contact_fold"] > 0
              and r["launches"]["chain_lookup"] > 0
              and r["launches"]["block_merge"] > 0
              and r["launches"]["ordered_scan"] > 0 for r in ranks),
          "dryrun_multichip", "every rank's kernels ran on the card")
    # block rows and chain levels crossed ranks (dryrun_multichip checks
    # this too)
    check(moved.get("block copy", 0) > 0 and moved.get("chain lookup", 0) > 0,
          "dryrun_multichip", f"rows from other ranks {moved}")
    nccl_shared = (shared_card_nccl(card) if torch.cuda.device_count() < 2
                   else "not probed: a card per rank")
    scaling, _, _ = run_tool("bench_scaling", SCALING_ARGS)
    rows = scaling["weak_scaling"]
    print(f"bench_scaling: " + "; ".join(
        f"{k} ranks {v['sec'] * 1e3:.3f} ms ({v['transport']}, "
        f"{'graphed' if v['graphed'] else 'eager'}"
        + (f", note {v['note']}" if "note" in v else "") + ")"
        for k, v in rows.items()) + f" [{card}]")
    check(all(np.isfinite(v["sec"]) for v in rows.values()), "bench_scaling",
          f"rows {rows}")
    secs = time.perf_counter() - t0
    print(f"phase 13: {secs:.1f} s [{card}]")
    return dict(err=err, s1=s1, s1_library=s1_library, resample=resample,
                world=world, dryrun=ranks, scaling=scaling, seconds=secs,
                nccl_shared=nccl_shared)


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
    ap.add_argument("--prior-scan", metavar="CU",
                    help="an earlier source of the ordered scan (outside the "
                         "tree, same C entry): time it in turns with S1")
    args = ap.parse_args()
    global PRIOR_SCAN
    PRIOR_SCAN = args.prior_scan
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

    marks = [time.perf_counter()]

    def phase_done(number):
        """Print the seconds phase ``number`` took."""
        marks.append(time.perf_counter())
        print(f"phase {number}: {marks[-1] - marks[-2]:.1f} s [{card}]")

    max_err, k1 = check_contact_fold(dev, Config())
    phase_done(3)
    res = main_path(dev, args.profile)
    ms_step = res["elapsed"] / STEPS * 1e3
    print(f"main path: eager {ms_step:.4f} ms/step "
          f"({res['calls']['kernel']:.2f} kernel-launch calls a step), "
          f"graphed {res['elapsed_graph'] / STEPS * 1e3:.4f} ms/step "
          f"({res['calls_graph']['kernel']:.2f} kernel-launch and "
          f"{res['calls_graph']['graph']:.2f} graph-launch calls), "
          f"{N_BENCH * STEPS / res['elapsed']:.1f} / "
          f"{N_BENCH * STEPS / res['elapsed_graph']:.1f} particle-updates/s, "
          f"contact_fold {k1['device_ms'] * 1e3:.2f} us/step on the card "
          f"({k1['call_ms'] * 1e3:.2f} us per eager call, plain "
          f"{k1['plain_ms'] * 1e3:.2f} us), final-10 xy error "
          f"{res['final10']:.4f} m [{card}]")

    phase_done(4)
    (k2_err, k2), (k3_err, k3) = check_slam_kernels(dev, slam_config())
    phase_done(5)
    slam = slam_path(dev, args.profile)
    print(f"SLAM path: eager {slam['frames'] / slam['elapsed']:.2f} "
          f"frames/s at {SLAM_N} particles, "
          f"{slam['elapsed'] / slam['frames'] * 1e3:.4f} ms/frame "
          f"({slam['calls']['kernel']:.2f} kernel-launch calls a frame); "
          f"graphed {slam['frames'] / slam['elapsed_graph']:.2f} frames/s, "
          f"{slam['elapsed_graph'] / slam['frames'] * 1e3:.4f} ms/frame "
          f"({slam['calls_graph']['kernel']:.2f} kernel-launch and "
          f"{slam['calls_graph']['graph']:.2f} graph-launch calls); "
          f"chain_lookup {k2['device_ms'] * 1e3:.2f} us (plain "
          f"{k2['plain_ms'] * 1e3:.2f} us), block_merge "
          f"{k3['device_ms'] * 1e3:.2f} us (plain "
          f"{k3['plain_ms'] * 1e3:.2f} us) [{card}]")

    phase_done(6)
    k5_err, k5 = check_select_cells(dev, Config())
    app = app_path(dev, args.profile, card)
    ga = app["graphed"]
    print(f"application path: {APP_FRAMES / app['elapsed']:.2f} frames/s at "
          f"{N_BENCH} particles eager, {app['ms_meas']:.4f} ms per "
          f"measurement update ({app['n_meas']} updates), "
          f"{app['ms_plain']:.4f} ms per other frame, "
          f"{app['calls']['kernel']:.2f} kernel-launch calls a frame; "
          f"graphed {APP_FRAMES / ga['elapsed']:.2f} frames/s, "
          f"{ga['ms_meas']:.4f} / {ga['ms_plain']:.4f} ms per replayed "
          f"update / other frame, {ga['calls']['kernel']:.2f} kernel-launch "
          f"and {ga['calls']['graph']:.2f} graph-launch calls a frame; "
          f"select_cells "
          f"{k5['device_ms'] * 1e3:.2f} us (plain "
          f"{k5['plain_ms'] * 1e3:.2f} us) [{card}]")

    phase_done(7)
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
          f"(eager {drv['slam']['eager_fps']:.2f}) and "
          f"{drv['big']['result']['value']} frames/s at {BIG_N} (eager "
          f"{drv['big']['eager_fps']:.2f}) "
          f"particles (pool {drv['big']['pool_gb']:.2f} GB, peak "
          f"{drv['big']['peak'] / 1e9:.2f} GB); bf16 vs CPU "
          f"{bf16_err:.3e} m, vs float32 {bf16_diff:.3e} m [{card}]")

    gc.collect()
    torch.cuda.empty_cache()
    phase_done(8)
    p4_row, mapping = phase9(dev, card, args.profile)
    span = lambda xs, digits: f"{min(xs):.{digits}f}-{max(xs):.{digits}f}"
    gm, ch = mapping["graphed"], mapping["camera_hash"]
    print(f"mapping path: {span(mapping['rates'], 2)} frames/s eager over "
          f"{MAP_PASSES} passes at {SLAM_N} particles through "
          f"update_contact, update_scan "
          f"({span(mapping['scan_ms_range'], 4)} ms) and "
          f"update_distance_image ({span(mapping['image_ms_range'], 4)} ms), "
          f"{mapping['calls']['kernel']:.2f} kernel-launch calls a frame; "
          f"graphed {span(gm['rates'], 2)} frames/s "
          f"({span(gm['scan_ms_range'], 4)} / "
          f"{span(gm['image_ms_range'], 4)} ms), "
          f"{gm['calls']['kernel']:.2f} kernel-launch and "
          f"{gm['calls']['graph']:.2f} graph-launch calls a frame; "
          f"run_stream "
          f"vs calls {mapping['stream_diff']:.3e} m, GPU vs CPU "
          f"{mapping['dev_err']:.3e} m; SLAM camera+hash "
          f"{ch['elapsed'] / ch['frames'] * 1e3:.4f} ms/frame eager "
          f"({ch['calls']['kernel']:.2f} kernel-launch calls), "
          f"{ch['elapsed_graph'] / ch['frames'] * 1e3:.4f} graphed "
          f"({ch['calls_graph']['kernel']:.2f} and "
          f"{ch['calls_graph']['graph']:.2f}) [{card}]")

    phase_done(9)
    gc.collect()
    torch.cuda.empty_cache()
    p10 = phase10(dev, card)
    online = p10["online"]
    print(f"backend: OnlineSlam {ONLINE_FRAMES} frames at {SLAM_N} particles, "
          f"{online['keyframes']} keyframes, run_stream "
          f"{sum(r['stream'] for r in online['rows']):.3f} s, keyframes "
          f"{sum(r['keyframe'] for r in online['rows']):.3f} s, optimize "
          f"{sum(r['optimize'] for r in online['rows']):.3f} s; dense "
          f"optimize {p10['solvers']['dense 3']['ms']:.3f} ms (graphed "
          f"{p10['solvers']['dense 3']['graphed_ms']:.3f}), PCG "
          f"{p10['solvers']['pcg 3']['ms']:.3f} ms (graphed "
          f"{p10['solvers']['pcg 3']['graphed_ms']:.3f}), Schur "
          f"{p10['solvers']['schur 3']['ms']:.3f} ms (graphed "
          f"{p10['solvers']['schur 3']['graphed_ms']:.3f}) at {PG_NODES} "
          f"nodes; closure sweep {p10['align']['fine 9x9x7']['ms']:.3f} ms "
          f"(graphed {p10['align']['fine 9x9x7']['graphed_ms']:.3f}); "
          f"graphed OnlineSlam optimize "
          f"{sum(r['optimize'] for r in online['graphed']['rows']):.3f} s "
          f"[{card}]")
    phase_done(10)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    p11 = phase11(dev, card)
    p11_s = time.perf_counter() - t0
    demo = p11["demo"]
    per_frame = lambda xs: sum(xs[1:]) / max(len(xs) - 1, 1) / demo[
        "chunk"] * 1e3
    print(f"log replay: full_demo {demo['result']['frames']} frames at "
          f"4096 particles, {demo['result']['fps_incl_host']} frames/s incl. "
          f"host eager, {demo['graphed']['result']['fps_incl_host']} graphed; "
          f"run_stream {per_frame(demo['stream_s']):.4f} ms/frame eager "
          f"({demo['calls']['kernel']:.2f} kernel-launch calls a frame), "
          f"{per_frame(demo['graphed']['stream_s']):.4f} graphed "
          f"({demo['graphed']['calls']['kernel']:.2f} kernel-launch and "
          f"{demo['graphed']['calls']['graph']:.2f} graph-launch calls); "
          f"on two laps {p11['laps']['result']['closures']} closures, "
          f"kf ATE {p11['laps']['result']['kf_xy_before_m']} -> "
          f"{p11['laps']['result']['kf_xy_after_m']} m; replay_demo "
          f"{p11['replay']['fps']:.1f} frames/s at {REPLAY_N} particles, "
          f"feeder wait {p11['replay']['wait']:.2%}; chain_layers on the 100k "
          f"pool +{p11['layer_rise'] / 1e6:.3f} MB; phase 11 {p11_s:.1f} s "
          f"[{card}]")
    t0 = time.perf_counter()
    p12 = phase12(dev, card)
    p12_s = time.perf_counter() - t0
    slam_big = p12[f"slam_{TOOLS_BIG_N}"]
    k2_frame = p12["chain"]["kernel (K2)"]["ms_per_frame"]
    step = p12["stages"]["window"]
    print(f"tools: K5 at Q = 2,000,000 {p12['k5']['ms']:.5f} ms (bound "
          f"{p12['k5']['bound_ms']:.5f} ms); K2 parity 0 at 4096 x 8, "
          f"{k2_frame:.4f} ms/frame; block copies "
          f"{slam_big['copy_share']:.2%} of the replayed device time at "
          f"{TOOLS_BIG_N} particles (float32 pool, graphed; "
          f"{records_text(slam_big)}); reinjection "
          f"{p12['hash']['reinjection_cost_ms_per_frame']} ms a frame; "
          f"bfloat16 - float32 ATE {p12['ab']['delta']['ate_mean']:.3e} m "
          f"over {p12['ab']['config']['runs']} runs; the bench step's "
          f"stages and odometry.update "
          f"{step['sum']['kernel_ms'] + step['odometry_ms']:.4f} ms of "
          f"kernels against the graphed step's {step['step_ms']:.4f} ms; "
          f"phase 12 "
          f"{p12_s:.1f} s [{card}]")
    p13 = phase13(dev, card)
    w13 = p13["world"]
    print(f"multi-rank: S1 {p13['s1']['ms']:.5f} ms at {N_BENCH} (one "
          f"launch, bound {p13['s1']['bound_ms']:.5f} ms, torch.cumsum "
          f"{p13['s1_library']:.5f} ms, both graphs); one NCCL rank: "
          f"localisation {w13['localize_eager']['s']:.3f} s eager, "
          f"{w13['localize_graphed']['s']:.3f} s graphed, and SLAM "
          f"{w13['slam']['pool whole eager']['s']:.3f} s eager, "
          f"{w13['slam']['pool whole graphed']['s']:.3f} s graphed, bit for "
          f"bit unmeshed; dryrun_multichip({DRYRUN_RANKS}) over "
          f"{p13['dryrun'][0]['backend']} ({p13['dryrun'][0]['transport']}); "
          f"phase 13 {p13['seconds']:.1f} s [{card}]")
    gc_cuda()
    t0 = time.perf_counter()
    k8 = check_row_copy(dev, card)
    print(f"row copy: K8 {k8['ms']:.5f} ms for the copy-on-write of "
          f"{k8['masked_rows']} of {SLAM_N} heads after a resampling "
          f"(bound {k8['bound_ms']:.5f} ms, plain {k8['plain_ms']:.5f} ms), "
          f"{k8['ms_cell']:.5f} ms for {k8['masked_rows_cell']} of "
          f"{ROW_CELL_N} heads at the benchmark cell's pool (bound "
          f"{k8['bound_ms_cell']:.5f} ms, plain {k8['plain_ms_cell']:.5f} "
          f"ms), its rollover {k8['ms_cell_fill']:.5f} ms; no row masked "
          f"{k8['ms_masked_0']:.5f} ms; phase 14 "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    gc_cuda()
    t0 = time.perf_counter()
    cmr = check_cloud_merge(dev, card)
    print(f"cloud merge: CM {cmr['ms']:.5f} ms for {cmr['valid_pixels']} "
          f"valid pixels of {cmr['points']} under {CM_N} poses into the "
          f"camera cell's {CM_BLOCKS}-block colour pool (bound "
          f"{cmr['bound_ms']:.5f} ms, {cmr['bound_ms'] / cmr['ms']:.2%} of "
          f"it; plain {cmr['plain_ms']:.5f} ms); at the laser cell's shape "
          f"CM {cmr['laser_ms_cm']:.5f} ms against K3's "
          f"{cmr['laser_ms_k3_operands']:.5f} ms with its operands; phase 15 "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    # each tool's launches, those of its timing loops included
    tool_launches = lambda name, tools: {
        f"launches_{tool}": p12["launches"][tool][name] for tool in tools}
    online_launches = lambda name: {
        "launches_online": online["launches"][name],
        "launches_full_demo": demo["launches"][name],
        # the application's paths as CUDA graphs, credited by the replays
        "launches_graphed_full_demo": demo["graphed"]["launches"][name],
        "launches_graphed_mapping": gm["launches"][name],
        "launches_graphed_camera_hash": ch["launches_graphed"][name],
        "launches_full_demo_laps": p11["laps"]["launches"][name],
        **tool_launches(name, (f"profile_slam_{SLAM_N}",
                               f"profile_slam_{TOOLS_BIG_N}",
                               "probe_chain_parity", "bench_surface_hash",
                               "ab_pool_dtype"))}
    demo_launches = lambda name: {
        "launches_localize_demo": p10["localize"]["launches"][name],
        **({"launches_replay_demo": p11["replay"]["launches"][name]}
           if name in p11["replay"]["launches"] else {}),
        **tool_launches(name, ("profile_filter", "probe_spread",
                               "profile_step", "profile_step_window",
                               "bench_kernels"))}

    f32c, bf16c = k7[""], k7["_bf16"]

    def other(times, tag):
        """A row's times at another storage type or shape, keys tagged."""
        return {f"{key}_{tag}": times[key]
                for key in ("ms", "device_ms_profiler", "call_ms",
                            "plain_ms", "plain_clock", "plain_ms_profiler",
                            "bound_ms", "bound_ms_sectors",
                            "share_sectors")}

    def pool_rows(name, f32, bf16, big, big_err, bf16_err):
        return {**other(bf16, "bf16"), "max_abs_err_bf16": bf16_err,
                "call_ms_in_turns": by_dtype[f"{name}_f32"],
                "call_ms_bf16_in_turns": by_dtype[f"{name}_bf16"],
                "launches_100k": drv["big"]["launches"][name],
                **other(big, "100k"), "max_abs_err_100k": big_err}

    # the graphed main paths' launches, credited by the replays
    graphed = lambda name: {"launches_graphed": (
        res["launches_graphed"] if name in ("contact_fold", "ordered_scan")
        else slam["launches_graphed"])[name]}
    rows = (
        ("contact_fold", "slam_eslam_tpu/ops/pallas_gather.py:578",
         res["launches"], max_err, k1, None,
         {**demo_launches("contact_fold"), **graphed("contact_fold")}),
        ("chain_lookup", "slam_eslam_tpu/ops/pallas_chain.py:36",
         slam["launches"]["chain_lookup"], k2_err, k2, None,
         {**pool_rows("chain_lookup", k2, k2b, k2c, k2c_err, k2b_err),
          **online_launches("chain_lookup"), **graphed("chain_lookup")}),
        ("block_merge", "slam_eslam_tpu/ops/pallas_merge.py:211",
         slam["launches"]["block_merge"], k3_err, k3, None,
         {**pool_rows("block_merge", k3, k3b, k3c, k3c_err, k3b_err),
          **online_launches("block_merge"), **graphed("block_merge")}),
        ("select_cells", "slam_eslam_tpu/ops/pallas_gather.py:277",
         app["launches"]["select_cells"], k5_err, k5, None,
         {**demo_launches("select_cells"),
          "launches_graphed_app": ga["launches"]["select_cells"]}),
        # whole-block mode (what the TPU kernel computes); the cells mode
        # (the merge's twin on this card) and the same rows unsorted
        # (points) beside it
        ("block_copy", "slam_eslam_tpu/utils/kernel_eff.py:177",
         drv["launches"]["block_copy"], k7_err,
         dict(ms=f32c["device"]["whole"], device_ms=f32c["device"]["whole"],
              device_ms_profiler=f32c["profiler"]["whole"],
              call_ms=f32c["call"]["whole"],
              plain_ms=f32c["device"]["plain"],
              plain_clock=f32c["clock"]["plain"],
              plain_ms_profiler=f32c["profiler"]["plain"],
              plain_call_ms=f32c["call"]["plain"],
              bound_ms=f32c["bound_whole"][0],
              bound_by=f32c["bound_whole"][1]),
         f32c["device"]["library"],
         {"library_call_ms": f32c["call"]["library"],
          "library_clock": f32c["clock"]["library"],
          "library_ms_profiler": f32c["profiler"]["library"],
          "plain_clock_cells": f32c["clock"]["plain_cells"],
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
          # the sectors the merge's rows occupy, for cells and points alike
          "bound_ms_sectors_cells": sector_ms(f32c["sectors"]),
          "share_sectors_cells": sector_ms(f32c["sectors"])
          / f32c["device"]["cells"],
          "share_sectors_points": sector_ms(f32c["sectors"])
          / f32c["device"]["points"],
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
        # no TPU kernel: the port's repair of torch.cumsum, in the order of
        # the JAX package's (XLA) cumsum of core/filter.py; one launch a
        # call, timed against torch.cumsum on the same clock (graphs)
        ("ordered_scan", "slam_eslam_tpu/core/filter.py:85",
         res["scan_launches"], p13["err"], p13["s1"], p13["s1_library"],
         {**graphed("ordered_scan"),
          "launches_graphed_slam_path": slam["launches_graphed"][
              "ordered_scan"],
          "launches_graphed_app": ga["launches"]["ordered_scan"],
          "launches_graphed_mapping": gm["launches"]["ordered_scan"],
          "launches_graphed_camera_hash": ch["launches_graphed"][
              "ordered_scan"],
          "launches_slam_path": slam["launches"]["ordered_scan"],
          "launches_one_rank_localisation":
              w13["localize_eager"]["launches"]["ordered_scan"],
          "launches_one_rank_slam":
              w13["slam"]["pool whole eager"]["launches"]["ordered_scan"],
          "launches_graphed_one_rank_localisation":
              w13["localize_graphed"]["launches"]["ordered_scan"],
          "launches_graphed_one_rank_slam":
              w13["slam"]["pool whole graphed"]["launches"]["ordered_scan"]}),
        # no TPU kernel: the port's repair of the pool copies that the JAX
        # package skips with lax.cond(any(mask)), a host read; two launches
        # a mapping frame (copy-on-write, rollover)
        ("row_copy", "slam_eslam_tpu/mapping/map_pool.py:264",
         slam["launches"]["row_copy"], 0.0, k8, None,
         {"launches_graphed": slam["launches_graphed"]["row_copy"],
          "launches_graphed_mapping": gm["launches"]["row_copy"],
          "launches_graphed_camera_hash": ch["launches_graphed"]["row_copy"],
          **{f"launches_{key}": w13["slam"][f"pool whole {mode}"][
              "launches"].get("row_copy", 0)
             for key, mode in (("one_rank_slam", "eager"),
                               ("graphed_one_rank_slam", "graphed"))},
          **tool_launches("row_copy", (f"profile_slam_{SLAM_N}",
                                       f"profile_slam_{TOOLS_BIG_N}",
                                       "ab_pool_dtype"))}),
        # no TPU kernel: the JAX package merges a cloud with K3 on [N, P]
        # operands it builds first; the phase's own launches (no path
        # above merges a cloud past K3's 16,384 points)
        ("cloud_merge", "slam_eslam_tpu/mapping/map_pool.py:496",
         cmr["launches_check"], cmr["max_abs_err"],
         {key: v for key, v in cmr.items() if key != "max_abs_err"}, None,
         {"launches_graphed": slam["launches_graphed"]["cloud_merge"],
          "launches_graphed_mapping": gm["launches"]["cloud_merge"],
          "launches_graphed_camera_hash":
              ch["launches_graphed"]["cloud_merge"]}),
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
