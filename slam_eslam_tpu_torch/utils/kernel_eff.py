"""Per-kernel efficiency measurements for the bench JSON.

Port of ``slam_eslam_tpu.utils.kernel_eff``: the abstract ``sol_fraction``
of the bench models the weighting step as an ideal streaming gather, so
this module measures each hot kernel against ITS OWN bound on the card:

* ``fold_roofline`` -- the contact-fold kernel K1 (``ops.contact_fold``)
  standalone at the bench's operand shapes, its time read on the card
  (a CUDA graph of raw launches), against the larger of the time the
  card needs to move the bytes the call touches and the time it needs for
  the instructions the call's data asks for (counted from the inputs, not
  from the kernel's code).  (The JAX package reports the
  matrix-unit utilisation of its kernel here, ``fold_mfu``; K1 uses no
  matrix unit.)
* ``merge_floor_fraction`` -- the block-merge kernel K3
  (``ops.block_merge``) against its twin: kernel K7 (``ops.block_copy``)
  with the same launch, operands, sort and order of visiting the hit
  cells and the sums and slot rules taken out, so the fraction isolates
  what those cost on top of the merge's sort and traffic.

``chain_traffic`` and ``merge_traffic`` count, from a call's inputs, what
the chain lookup (K2) and the block merge (K3) must move: the useful
bytes and the distinct 32-byte sectors (``SECTOR_BYTES``) they lie in,
the unit the card moves for scattered rows.  They run on any device.

The two measurements need the GPU: a timing taken on the CPU would mean nothing, so they
return ``None`` for ``device="cpu"``, as the JAX functions do off their
accelerator; with no ``device`` given and no CUDA device they raise.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from slam_eslam_tpu_torch.utils.device import entry_device
from slam_eslam_tpu_torch.utils.profiling import (DEVICE_TIME_REPS,
                                                  H100_HBM_GBPS, device_time,
                                                  instruction_bound_seconds)


def _run_seconds(fn, x0, length, device):
    """Seconds for ``length`` chained applications of ``fn`` from ``x0``:
    CUDA events on a GPU, the host clock otherwise."""
    x = x0
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(length):
            x = fn(x)
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(length):
        x = fn(x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e-3


def _slope_time(fn, x0, iters, repeats, device="cpu"):
    """Per-application seconds of ``x -> fn(x)`` from two chain lengths:
    ``(t(4*iters) - t(iters)) / (3*iters)``, each the best of ``repeats``
    after a warm-up, so any constant cost per run (the first launch's
    latency, the event pair) cancels."""
    device = torch.device(device)

    def timed(length):
        _run_seconds(fn, x0, length, device)
        return min(_run_seconds(fn, x0, length, device)
                   for _ in range(repeats))

    return (timed(4 * iters) - timed(iters)) / (3 * iters)


# Instructions of the float32 primitives the contact fold may not
# approximate, as nvcc emits them for sm_90 without --use_fast_math, on the
# path taken when no operand is zero, denormal or huge: an IEEE division
# (a reciprocal estimate, the operand check, five fused multiply-adds, the
# branch on the check), an IEEE square root (a reciprocal-root estimate,
# the operand check and its branch, five multiply-adds), ``expf`` (range
# reduction in five, an exponential estimate, two scalings).
DIV, SQRT, EXP = 8, 8, 8


def fold_costs(k):
    """Instructions the contact fold needs for each thing a call's data
    makes it do, at ``k`` slots a cell (``csrc/contact_fold.cu`` does these
    and no fewer, whatever its layout):

    * ``particles``: the thread's index and bounds check, the loads of the
      origin and the measurement variance, eight stores;
    * ``rows`` (every contact row of every particle): the group id's load
      and compare, the active mask's load, add and test, the loop;
    * ``active`` (rows whose contact is active): three query loads, the
      cell index (two subtractions, multiplications, floors, conversions),
      four bounds comparisons;
    * ``inside`` (the cell lies in the grid): the row's address, its two
      loads, per slot a subtraction, three comparisons and two selects;
    * ``found`` (a slot lies within the z window): picking the slot's mean
      and stdev, zdiff, pose_var and zvar, the square root and its scale,
      the divisions ``zdiff / sc`` and ``lam / sc``, five running sums;
    * ``head`` (``u >= -3``): the erfc form of the Mills ratio, two
      ``expf``, a fifth-degree polynomial and two divisions;
    * ``tail`` (``u < -3``): the continued fraction, eight divisions;
    * ``groups`` (every group of every particle): the validity rule and the
      five totals;
    * ``valid_groups``: the group's three divisions."""
    return {
        "particles": 20,
        "rows": 8,
        "active": 18,
        "inside": 6 + 6 * k,
        "found": 2 * (k - 1) + 3 + SQRT + 1 + 2 * DIV + 5,
        "head": 2 + DIV + 6 + 2 + EXP + 3 + 3 + EXP + 1 + DIV,
        "tail": 1 + 8 * (DIV + 1),
        "groups": 12,
        "valid_groups": 3 * DIV,
    }


def fold_work(packed, queries, act_col, mv, seg, correction, z_window=3.0):
    """What one contact fold's inputs make it do, counted with the plain
    lookup: ``{"particles", "rows", "active", "inside", "found", "head",
    "tail", "groups", "valid_groups"}`` as ``fold_costs`` names them.  A
    group counts as valid when every active member found a patch and one
    did (the rule's third condition, a ratio mass above 1e-9, is not
    evaluated)."""
    from slam_eslam_tpu_torch.mapping import mls_grid

    xq, yq, zq = queries
    c, n = xq.shape
    nx, ny, _ = packed.data.shape
    active = (act_col > 0.5).expand(c, n)
    ix, iy = mls_grid.cells(packed, xq, yq)
    inside = active & (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
    hit, mean, stdev = mls_grid.get_patch_packed_cells(packed, ix, iy, zq,
                                                       z_window)
    found = inside & hit
    u = (zq - mean) / (torch.sqrt(stdev * stdev + mv) * correction)
    tail = found & ~(u >= -3.0)
    groups = int(seg.max()) + 1 if c else 0
    f32 = torch.float32
    ncb = torch.zeros((groups, n), dtype=f32, device=xq.device).index_add_(
        0, seg.long(), found.to(f32))
    acts = torch.zeros((groups, 1), dtype=f32, device=xq.device).index_add_(
        0, seg.long(), (act_col > 0.5).to(f32))
    valid = (ncb >= acts - 0.5) & (ncb > 0.5)
    count = lambda t: int(t.sum())
    return {"particles": n, "rows": c * n, "active": count(active),
            "inside": count(inside), "found": count(found),
            "head": count(found) - count(tail), "tail": count(tail),
            "groups": groups * n, "valid_groups": count(valid)}


def fold_needed_instructions(work, k):
    """Instructions a contact fold with the counts ``work``
    (``fold_work``) needs at ``k`` slots a cell: each count times its
    ``fold_costs``."""
    costs = fold_costs(k)
    return sum(costs[name] * work[name] for name in costs)


def fold_bound(nbytes, work, k):
    """The least time the card could take for a contact fold that moves
    ``nbytes`` and does ``work`` (``fold_work``): the larger of the bytes
    over the H100's memory rate and ``fold_needed_instructions`` over its
    float32 instruction rate.  Returns ``(seconds, "bytes" or
    "operations", the instructions)``."""
    t_bytes = nbytes / (H100_HBM_GBPS * 1e9)
    needed = fold_needed_instructions(work, k)
    t_ops = instruction_bound_seconds(needed)
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", needed)


def fold_roofline(packed, n, iters=DEVICE_TIME_REPS, repeats=5, n_seg=4,
                  correction=1.0, z_window=3.0):
    """Kernel K1 at the bench shape: ``[8, n]`` random in-grid queries
    (C = 8 contact rows in ``n_seg`` groups) against ``packed``.  Its time
    is the card's own (``profiling.device_time``: ``iters`` raw launches
    in a CUDA graph, replayed ``repeats`` times; no Python between the
    launches), beside its bound (``fold_bound``): queries, measurement
    variance and output once each plus one slot row per distinct cell the
    queries touch, over the H100's memory rate, or the instructions these
    queries need over the card's instruction rate, whichever is larger.
    Returns ``{"us", "bound_us", "bound_by", "fraction", "bytes",
    "needed_instructions_per_query", "launches"}``, or ``None`` for a grid
    on the CPU."""
    from slam_eslam_tpu_torch.mapping import mls_grid
    from slam_eslam_tpu_torch.ops import contact_fold as cf

    device = packed.data.device
    if device.type == "cpu":
        return None
    cp = 8
    nx, ny, c2 = packed.data.shape
    gen = torch.Generator(device).manual_seed(0)
    rand = lambda *s: torch.rand(s, generator=gen, device=device)
    origin = packed.origin
    qx = origin[0] + rand(cp, n) * (nx * packed.resolution)
    qy = origin[1] + rand(cp, n) * (ny * packed.resolution)
    qz = 0.1 * torch.randn((cp, n), generator=gen, device=device)
    mv = torch.full((1, n), 0.09, device=device)
    act = torch.ones((cp, 1), device=device)
    seg = (torch.arange(cp, device=device) % n_seg).sort().values.to(
        torch.int32)

    before = cf.contact_fold.launches
    # the wrapper once: it checks the operands and gives the output
    out = cf.contact_fold(packed, (qx, qy, qz), act, mv, seg=seg,
                          correction=correction, z_window=z_window)
    t = device_time(lambda: cf.launch(packed, (qx, qy, qz), act, mv, seg,
                                      out, correction, z_window),
                    iters, repeats)
    ix, iy = mls_grid.cells(packed, qx, qy)
    inside = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
    touched = int(torch.unique((ix.long() * ny + iy.long())[inside]).numel())
    nbytes = (3 * cp * n + n + 8 * n) * 4 + touched * c2 * 4
    work = fold_work(packed, (qx, qy, qz), act, mv, seg, correction,
                     z_window)
    bound, bound_by, needed = fold_bound(nbytes, work, c2 // 2)
    return {"us": t * 1e6, "bound_us": bound * 1e6, "bound_by": bound_by,
            "fraction": bound / t, "bytes": nbytes,
            "needed_instructions_per_query": needed / (cp * n),
            "launches": cf.contact_fold.launches - before}


# the card moves device memory in sectors of this many bytes
SECTOR_BYTES = 32


def _sectors(offsets, length):
    """Distinct ``SECTOR_BYTES`` sectors that byte ranges ``[offset,
    offset + length)`` of one tensor touch (``offsets`` an int64 tensor;
    the tensor's storage starts on a sector, as every PyTorch allocation
    does)."""
    if offsets.numel() == 0:
        return 0
    first = offsets // SECTOR_BYTES
    last = (offsets + length - 1) // SECTOR_BYTES
    span = torch.arange(int((last - first).max()) + 1, device=offsets.device)
    ids = first[:, None] + span
    return int(torch.unique(ids[ids <= last[:, None]]).numel())


def _dense_sectors(nbytes):
    """Sectors of ``nbytes`` contiguous bytes that start on a sector."""
    return -(-nbytes // SECTOR_BYTES)


def _row_sectors(cells, k, sizes):
    """Distinct sectors of the slot rows (``k`` slots) of the flat cells
    ``cells`` (``(block * nx + ix) * ny + iy``, int64) in one field per
    element size of ``sizes``, summed over the fields."""
    cells = torch.unique(cells)
    return sum(_sectors(cells * (k * size), k * size) for size in sizes)


def chain_traffic(pool, chain, queries, z_window):
    """What one chain lookup (kernel K2) must move for these inputs:
    ``{"bytes", "sectors_read", "sectors_written", "sectors",
    "sectors_all_levels"}``.

    ``bytes``: per query its x, y, z and the three outputs; the chain; and
    per level a query reaches (the walk ends at the first hit; an empty or
    void entry is skipped) the block's origin and, where the query lies on
    the block, the cell's mean and meta rows, plus the stdev row where it
    hits (the count behind ``bound_ms``).  ``sectors`` (read + written): the
    distinct 32-byte sectors those reads and the outputs touch, counted
    from the cells' byte offsets in each field (a sector read by several
    queries counts once; an empty level, and the rows of a level whose
    cell lies off its block, count nothing).  ``sectors_all_levels``: the
    same with the origin, mean and meta rows of every level, hit or not
    (what a lookup that loads every level before it selects reads)."""
    from slam_eslam_tpu_torch.mapping.mls_grid import inverse_resolution
    from slam_eslam_tpu_torch.ops import chain_lookup as cl

    xq, yq, zq = queries
    size = pool.mean.element_size()
    k = pool.k
    nq = xq.numel()
    nbytes = nq * (12 + 9) + chain.numel() * 4
    found = torch.zeros_like(xq, dtype=torch.bool)
    size_x, size_y = pool.nx * pool.resolution, pool.ny * pool.resolution
    inv = inverse_resolution(pool.resolution)
    need = {"origin": [], "row": [], "stdev": []}
    every = {"origin": [], "row": []}
    for level in range(chain.shape[1]):
        b = chain[:, level]
        void = (b < 0) | (b >= pool.b)
        bb = torch.where(void, torch.zeros_like(b), b)
        ok = (~void)[:, None] & ~found
        org = pool.origin.index_select(0, bb.long())
        inside = ((xq >= org[:, 0:1]) & (xq < org[:, 0:1] + size_x)
                  & (yq >= org[:, 1:2]) & (yq < org[:, 1:2] + size_y))
        hit, _, _, slot = cl.block_get_patch(
            pool.mean, pool.stdev, pool.meta, pool.origin, pool.resolution,
            bb, xq, yq, zq, k=k, z_window=z_window, with_slot=True)
        hit = hit & ok
        nbytes += int(ok.sum()) * 8
        nbytes += int((ok & inside).sum()) * k * (size + 4)
        nbytes += int(hit.sum()) * k * size
        # the cell the kernel computes, and whether it lies on the block
        ix = torch.floor((xq - org[:, 0:1]) * inv).long()
        iy = torch.floor((yq - org[:, 1:2]) * inv).long()
        on = ((ix >= 0) & (ix < pool.nx) & (iy >= 0) & (iy < pool.ny)
              & (~void)[:, None])
        cell = (bb.long()[:, None] * pool.nx + ix) * pool.ny + iy
        blocks = bb.long()[:, None].expand_as(xq)
        need["origin"].append(blocks[ok])
        need["row"].append(cell[ok & on])
        need["stdev"].append(slot[hit] // k)
        every["origin"].append(blocks[(~void)[:, None].expand_as(xq)])
        every["row"].append(cell[on])
        found |= hit
    cat = lambda parts: torch.cat(parts) if parts else torch.zeros(
        0, dtype=torch.long, device=xq.device)
    dense_read = (3 * _dense_sectors(nq * 4)
                  + _dense_sectors(chain.numel() * 4))
    written = _dense_sectors(nq) + 2 * _dense_sectors(nq * 4)

    def read(origins, rows):
        return (dense_read + _sectors(torch.unique(origins) * 8, 8)
                + _row_sectors(rows, k, (size, 4)))

    sectors_read = (read(cat(need["origin"]), cat(need["row"]))
                    + _row_sectors(cat(need["stdev"]), k, (size,)))
    all_read = (read(cat(every["origin"]), cat(every["row"]))
                + _row_sectors(cat(need["stdev"]), k, (size,)))
    return {"bytes": nbytes, "sectors_read": sectors_read,
            "sectors_written": written, "sectors": sectors_read + written,
            "sectors_all_levels": all_read + written}


def merge_traffic(pool, blk, lx, ly):
    """What one block merge (kernel K3, and P4 on a packed image) must
    move for these operands: ``{"bytes", "flops", "sectors_read",
    "sectors_written", "sectors"}``.

    ``bytes``: the block ids and the four point rows; per distinct hit
    cell the K slots of the four fields read and one slot of each written
    (the count behind ``bound_ms``).  ``flops``: two sums per point, about 50
    per cell for the slot rules, the sort's P log^2 P compares per
    particle.  ``sectors`` (read + written): the distinct 32-byte sectors
    of the block ids and point rows, and of each hit cell's slot row in
    every field (a row of at most 16 bytes lies in one sector; cells that
    share a sector, as neighbours in ``iy`` do, count it once; the written
    slot lies in the sector that was read).  ``pool`` needs ``b, nx, ny,
    k`` and ``mean`` (the float fields' storage type)."""
    from slam_eslam_tpu_torch.ops.block_copy import hit_rows

    n, p = lx.shape
    size = pool.mean.element_size()
    rows = hit_rows(blk, lx, ly, pool.b, pool.nx, pool.ny)
    cells = int(torch.unique(rows).numel())
    nbytes = (n * 4 + 4 * n * p * 4
              + cells * (pool.k * (3 * size + 4) + 3 * size + 4))
    p_pad = 1 << (p - 1).bit_length()
    flops = n * p_pad * (p_pad.bit_length() ** 2) / 2 + 2 * n * p + 50 * cells
    fields = _row_sectors(rows, pool.k, (size, size, size, 4))
    read = _dense_sectors(n * 4) + 4 * _dense_sectors(n * p * 4) + fields
    return {"bytes": nbytes, "flops": flops, "sectors_read": read,
            "sectors_written": fields, "sectors": read + fields}


def merge_benchmark_operands(n=4096, p=64, nx=40, ny=32, k=4, device="cpu",
                             dtype=torch.float32, seed=0):
    """The merge benchmark's synthetic operands, as the JAX function draws
    them from ``numpy.random.default_rng(seed)``: ``(fields, blk,
    points)`` with ``fields = (mean, stdev, height, meta)`` of ``n + 64``
    blocks of ``nx`` x ``ny*k`` slots (the float fields stored as
    ``dtype``), ``blk [n]`` unique block ids and ``points = (lx, ly, w,
    wz)``, ``p`` in-range points per particle."""
    nyk = ny * k
    b = n + 64
    rng = np.random.default_rng(seed)
    dev = lambda a: torch.from_numpy(a).to(device)
    mean = dev(rng.normal(size=(b, nx, nyk)).astype(np.float32)).to(dtype)
    stdev = dev(rng.uniform(0.05, 0.3, size=(b, nx, nyk)).astype(
        np.float32)).to(dtype)
    height = torch.zeros((b, nx, nyk), dtype=dtype, device=device)
    meta = dev((rng.random(size=(b, nx, nyk)) < 0.5).astype(np.int32))
    blk = dev(rng.permutation(b)[:n].astype(np.int32))
    lx = dev(rng.integers(0, nx, size=(n, p)).astype(np.int32))
    ly = dev(rng.integers(0, ny, size=(n, p)).astype(np.int32))
    w = dev(rng.uniform(1.0, 50.0, size=(n, p)).astype(np.float32))
    wz = dev(rng.normal(size=(n, p)).astype(np.float32))
    return (mean, stdev, height, meta), blk, (lx, ly, w, wz)


def merge_floor_fraction(n=4096, p=64, nx=40, ny=32, k=4, iters=20,
                         repeats=3, device=None):
    """Block-merge kernel vs its twin with the body taken out.

    On ``merge_benchmark_operands`` (float32) it times, each with
    ``_slope_time`` and in place:

    * the merge, kernel K3 (``ops.block_merge``);
    * kernel K7 (``ops.block_copy``) in ``"cells"`` mode, the merge's
      launch, operands, sort and cell order with its sums and slot rules
      taken out;
    * K7 in ``"points"`` mode, the same rows with the sort taken out too;
    * K7 in ``"whole"`` mode, the pass-through copy of whole blocks that
      the JAX package's floor is.

    ``floor_fraction = t_cells / t_merge`` is the share of the merge's
    time that its sort and its traffic take, the rest being the sums and
    the slot rules.  It is not the share of traffic alone: the twin keeps
    the merge's sort of the points by cell, because the same rows visited
    unsorted (``unsorted_us_per_block``) take longer than the merge.
    ``copy_gbps`` is the achieved bandwidth of the whole-block copy over
    the 8 field images and the 4 point rows it moves per particle.
    ``None`` for ``device="cpu"``."""
    from slam_eslam_tpu_torch.ops.block_copy import block_copy
    from slam_eslam_tpu_torch.ops.block_merge import block_merge

    device = entry_device(device)
    if device.type == "cpu":
        return None
    fields, blk, points = merge_benchmark_operands(n, p, nx, ny, k, device)
    # the merge's update index on the device, as the SLAM step passes it
    uidx = torch.full((), 3, dtype=torch.int32, device=device)

    def merge(c):
        block_merge(*c, None, blk, *points, uidx, k=k)
        return c

    def copy(mode):
        return lambda c: block_copy(c, blk, points, mode=mode, k=k)

    t_merge = _slope_time(merge, fields, iters, repeats, device)
    t_cells = _slope_time(copy("cells"), fields, iters, repeats, device)
    t_points = _slope_time(copy("points"), fields, iters, repeats, device)
    t_whole = _slope_time(copy("whole"), fields, iters, repeats, device)
    block_bytes = 2 * sum(f.element_size() for f in fields) * nx * ny * k
    bytes_per_step = block_bytes + 4 * p * 4
    return {
        "merge_us_per_block": t_merge / n * 1e6,
        "copy_us_per_block": t_cells / n * 1e6,
        "floor_fraction": t_cells / t_merge,
        "unsorted_us_per_block": t_points / n * 1e6,
        "whole_us_per_block": t_whole / n * 1e6,
        "copy_gbps": bytes_per_step * n / t_whole / 1e9,
    }


def steady_state_tier(particles, contact_extent, resolution, tiers,
                      window):
    """The fold-window tier the JAX package's auto lookup would use for a
    particle cloud: conservative query bbox = particle x/y extent + the
    contact rig's xy reach, in cells; the SMALLEST tier whose (twx, twy)
    strictly covers the span wins, else the full window.  The port has no
    window (its lookups read the whole grid); this is kept so that the
    two benches can report the same key."""
    x, y = (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a) for a in (particles.x, particles.y))
    span_x = (x.max() - x.min() + 2 * contact_extent) / resolution
    span_y = (y.max() - y.min() + 2 * contact_extent) / resolution
    for (twx, twy) in sorted(tuple(tiers), key=lambda t: t[0] * t[1]):
        if span_x < twx and span_y < twy:
            return (twx, twy)
    return tuple(window) if not isinstance(window, int) else (
        window, window)
