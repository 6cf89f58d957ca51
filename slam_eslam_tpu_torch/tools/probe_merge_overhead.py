"""Take the block merge's time apart, on the card.

Counterpart of ``tools/probe_merge_overhead.py`` of the JAX package: the
same variants on the same operands (drawn from the same seed,
``utils.kernel_eff.merge_benchmark_operands``), each a hand-written CUDA
kernel of the port, timed with CUDA events in chains of two lengths
(``utils.kernel_eff._slope_time``):

  merge        the block merge, kernel K3 (``ops.block_merge``)
  copy_all     the same operands, whole blocks passed through (kernel K7,
               ``ops.block_copy``, ``whole`` mode with the point rows)
  copy_fields  the four field operands only, no point operands
  copy_packed  ONE packed ``[B, 4*nx, ny*k]`` field, in and out
  merge_packed the full merge on the packed operand
               (``ops.block_merge.block_merge_packed``)
  grouped4/8/16  the JAX package's G-blocks-per-grid-step merge; on a GPU
               every particle has its own thread block anyway, so these
               are kernel K3 again: it is timed once, and their rows and
               parity lines repeat it

On the TPU the probe asks what a grid step's fixed cost is made of (DMA
count, point DMAs, the body).  On a GPU the merge moves only the cells
its points hit, so ``merge`` against ``copy_*`` compares scattered rows
with streamed blocks, and ``merge`` against ``merge_packed`` asks whether
a cell's four loads and stores are cheaper with a block's four fields
26 KB apart (one image) than a whole field tensor apart.

Beside each time stands the variant's byte bound: the bytes the call must
move (for the merges the hit cells' slot rows and the point rows, for the
copies the blocks in and out) over the H100's memory rate.

Run:  python -m slam_eslam_tpu_torch.tools.probe_merge_overhead
          [--particles 4096] [--only merge,merge_packed] [--cpu]
"""

from __future__ import annotations

import argparse

import torch

from slam_eslam_tpu_torch.ops.block_copy import block_copy, hit_rows
from slam_eslam_tpu_torch.ops.block_merge import (block_merge,
                                                  block_merge_packed,
                                                  pack_fields)
from slam_eslam_tpu_torch.utils.device import card_line, entry_device
from slam_eslam_tpu_torch.utils.kernel_eff import (_slope_time,
                                                   merge_benchmark_operands)
from slam_eslam_tpu_torch.utils.profiling import H100_HBM_GBPS

GROUPS = (4, 8, 16)
VARIANTS = ("merge", "copy_all", "copy_fields", "copy_packed",
            "merge_packed") + tuple(f"grouped{g}" for g in GROUPS)
UPDATE_IDX = 3


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--particles", type=int, default=4096)
    ap.add_argument("--rays", type=int, default=64)
    ap.add_argument("--nx", type=int, default=40)
    ap.add_argument("--ny", type=int, default=40)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--cpu", action="store_true",
                    help="run the kernels' plain versions on the CPU (host "
                         "clock; no device number)")
    ap.add_argument(
        "--only", default="",
        help=f"comma list of variants to run ({', '.join(VARIANTS)}); "
             "empty = all")
    ap.add_argument(
        "--no-parity", action="store_true",
        help="skip the grouped-vs-merge parity check")
    return ap


def merge_bytes(blk, points, b, nx, ny, k):
    """Bytes one merge must move for these operands: the block ids and the
    four point rows, and per distinct hit cell the K slots of the four
    fields read and one slot of each written."""
    lx, ly = points[0], points[1]
    n, p = lx.shape
    cells = int(torch.unique(hit_rows(blk, lx, ly, b, nx, ny)).numel())
    return n * 4 + 4 * n * p * 4 + cells * (k * 16 + 16)


def copy_bytes(n, p, block_elements, with_points):
    """Bytes a whole-block copy must move: the block ids, every block's
    32-bit elements in and out and, with them, the four point rows."""
    return n * 4 + 2 * n * block_elements * 4 + (4 * n * p * 4
                                                 if with_points else 0)


def main(argv=None):
    """Run the probe; prints one line per variant and returns ``{variant:
    {"label", "ms", "bound_ms"}}``."""
    args = parser().parse_args(argv)
    only = set(filter(None, args.only.split(",")))
    unknown = only - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}; choose from "
                         f"{', '.join(VARIANTS)}")
    want = lambda name: not only or name in only
    device = entry_device("cpu" if args.cpu else None)
    n, p, nx, ny, k = args.particles, args.rays, args.nx, args.ny, args.k
    nyk = ny * k
    fields, blk, points = merge_benchmark_operands(n, p, nx, ny, k, device)
    b = fields[0].shape[0]
    packed = pack_fields(*fields)
    merge_kw = dict(k=k, patch_thickness=0.1, gap_size=1.5)
    # the update index on the device, as the SLAM step passes it to K3
    uidx = torch.full((), UPDATE_IDX, dtype=torch.int32, device=device)

    def merge(c):
        block_merge(*c, None, blk, *points, uidx, **merge_kw)
        return c

    def merge_packed(c):
        block_merge_packed(c, blk, *points, uidx, nx=nx, **merge_kw)
        return c

    def copy(with_points):
        return lambda c: block_copy(c, blk, points if with_points else None,
                                    mode="whole", k=k)

    field_elements = 4 * nx * nyk
    b_merge = merge_bytes(blk, points, b, nx, ny, k)
    runs = {
        "merge": ("merge (kernel K3)", merge, fields, b_merge),
        "copy_all": ("copy_all (4 fields + points)", copy(True), fields,
                     copy_bytes(n, p, field_elements, True)),
        "copy_fields": ("copy_fields (4 fields)", copy(False), fields,
                        copy_bytes(n, p, field_elements, False)),
        "copy_packed": ("copy_packed (1 packed field)", copy(False),
                        (packed,), copy_bytes(n, p, field_elements, False)),
        "merge_packed": ("merge_packed (1 packed field)", merge_packed,
                         packed, b_merge),
    }
    grouped = [f"grouped{g}" for g in GROUPS
               if n % g == 0 and want(f"grouped{g}")]

    results = {}
    for name, (label, fn, x0, nbytes) in runs.items():
        if not (want(name) or (name == "merge" and grouped)):
            continue
        # every variant starts from the same pool: they run in place
        x0 = (x0.clone() if isinstance(x0, torch.Tensor)
              else tuple(f.clone() for f in x0))
        seconds = _slope_time(fn, x0, args.iters, 3, device)
        results[name] = {"label": label, "ms": seconds * 1e3,
                         "bound_ms": nbytes / (H100_HBM_GBPS * 1e9) * 1e3}
    if grouped:
        print("# grouped4/8/16 are kernel K3 itself, timed once: a GPU gives "
              "every particle its own thread block, so there is no grid step "
              "to group")
        k3 = results["merge"] if want("merge") else results.pop("merge")
        for name in grouped:
            results[name] = dict(k3, label=f"merge_{name} (= kernel K3)")
            if not args.no_parity:
                print(f"# parity {name}-vs-production: max|dmean|=0.0 "
                      f"max|dmeta|=0 (the same launch)")

    card = card_line(device)
    where = (f"{device}, {card}" if card else
             f"{device}: the kernels' plain versions on the host clock, no "
             f"device number")
    print(f"# {n} particles, P={p}, block [{nx},{nyk}] f32, {where}")
    for name, r in results.items():
        print(f"{r['label']:34s} {r['ms']:8.4f} ms  "
              f"({r['ms'] * 1e3 / n:7.4f} us/block)  byte bound "
              f"{r['bound_ms']:8.5f} ms")
    return results


if __name__ == "__main__":
    main()
