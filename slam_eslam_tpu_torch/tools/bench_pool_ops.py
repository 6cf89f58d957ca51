"""Benchmarks of the map pool's gathers and scatters, by formulation.

Counterpart of ``tools/bench_pool_ops.py`` of the JAX package at its
defaults (4,096 particles x 64 rays = 262,144 entries into a pool of
``N + 64`` blocks of 1,600 cells x 4 slots, 6 fields), with the same
formulations written in PyTorch indexing, in place:

  a) six separate field arrays, one element index per slot
     (advanced indexing and ``index_put_``)
  b) one packed array ``[B, cells*K*6]``, one element index per slot
  c) one packed array ``[B, cells, K*6]``, a row gather and a row scatter
  d) the JAX script's ``lax.gather`` / ``lax.scatter`` of ``K*6``-long
     slices of the flat packed array: in PyTorch that is c's row gather
     and scatter on a ``[B, cells, K*6]`` view of b's array (its row says so)
  pool_copy6: every element of the six fields read and written once

The indices and values come from a seeded torch generator (the JAX script
draws them from JAX keys).  Each row is ``--iters`` iterations on the card
(device time: a CUDA graph of the iterations, replayed), per iteration,
and per entry; with ``--cpu`` the host clock.  These are the library's
gathers and scatters in both packages, no kernel of either.

Run:  python -m slam_eslam_tpu_torch.tools.bench_pool_ops
          [--particles 4096] [--rays 64] [--cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

NOTES = {
    "d_both_flat_slices": "= c's row gather/scatter on a view of the flat "
                          "array (one torch op for both)",
}


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--particles", type=int, default=4096)
    ap.add_argument("--rays", type=int, default=64)
    ap.add_argument("--ncells", type=int, default=1600)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--fields", type=int, default=6)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (host clock)")
    return ap


def draws(n, p, nc, k, nf, device, seed=0):
    """``(blk [M], cell [M], vals [M, K], valsC [M, K*F])`` for ``M = n*p``
    entries, from a seeded generator."""
    gen = torch.Generator(device).manual_seed(seed)
    m = n * p
    blk = torch.randint(0, n, (m,), generator=gen, device=device)
    cell = torch.randint(0, nc, (m,), generator=gen, device=device)
    vals = torch.randn((m, k), generator=gen, device=device)
    vals_c = torch.randn((m, k * nf), generator=gen, device=device)
    return blk, cell, vals, vals_c


def formulations(blk, cell, vals, k, nf):
    """``{row: fn(*arrays) -> arrays}``: one iteration of each formulation,
    updating its arrays in place (a: six ``[B, cells*K]`` fields; b: one
    ``[B, cells*K*F]`` array; c: one ``[B, cells, K*F]``; d: b's array),
    and which arrays each takes (``"fields"``, ``"flat"`` or ``"rank3"``)."""
    rows = blk[:, None]
    idx = cell[:, None] * k + torch.arange(k, device=cell.device)
    idx_c = cell[:, None] * (k * nf) + torch.arange(k * nf,
                                                    device=cell.device)

    def a_gather(*fs):
        acc = 0.0
        for f in fs:
            acc = acc + f[rows, idx]
        # fold the gathered value back so it is used
        fs[0].index_put_((rows, idx), acc * 1e-9, accumulate=True)
        return fs

    def a_scatter(*fs):
        for f in fs:
            f.index_put_((rows, idx), vals)
        return fs

    def a_both(*fs):
        acc = [f[rows, idx] for f in fs]
        for f, a in zip(fs, acc):
            f.index_put_((rows, idx), a + 1.0)
        return fs

    def b_both(f):
        f.index_put_((rows, idx_c), f[rows, idx_c] + 1.0)
        return (f,)

    def c_both(f):
        f.index_put_((blk, cell), f[blk, cell] + 1.0)   # [M, K*F] rows
        return (f,)

    def d_both(f):
        c_both(f.view(f.shape[0], -1, k * nf))
        return (f,)

    def copy_pool(*fs):
        for f in fs:
            f.mul_(1.000001)
        return fs

    return {
        "a_gather6": (a_gather, "fields"),
        "a_scatter6": (a_scatter, "fields"),
        "a_both6": (a_both, "fields"),
        "b_both_packed_scalar": (b_both, "flat"),
        "c_both_rank3_rows": (c_both, "rank3"),
        "d_both_flat_slices": (d_both, "flat"),
        "pool_copy6": (copy_pool, "fields"),
    }


def pool_arrays(kind, b, nc, k, nf, device):
    """Zeroed arrays of one formulation."""
    if kind == "fields":
        return tuple(torch.zeros((b, nc * k), device=device)
                     for _ in range(nf))
    if kind == "flat":
        return (torch.zeros((b, nc * k * nf), device=device),)
    return (torch.zeros((b, nc, k * nf), device=device),)


def main(argv=None):
    """Run the rows; returns ``{row: ms per iteration}``."""
    from slam_eslam_tpu_torch.utils import profiling
    from slam_eslam_tpu_torch.utils.device import card_line, entry_device

    args = parser().parse_args(argv)
    device = entry_device("cpu" if args.cpu else None)
    on_card = device.type == "cuda"
    n, p, nc, k, nf = (args.particles, args.rays, args.ncells, args.k,
                       args.fields)
    b, m, it = n + 64, n * p, args.iters
    blk, cell, vals, _ = draws(n, p, nc, k, nf, device)
    results = {}
    for name, (fn, kind) in formulations(blk, cell, vals, k, nf).items():
        arrays = pool_arrays(kind, b, nc, k, nf, device)
        body = lambda: fn(*arrays)
        if on_card:
            ms = profiling.device_time(body, reps=it, replays=3) * 1e3
        else:
            body()
            t0 = time.perf_counter()
            for _ in range(it):
                body()
            ms = (time.perf_counter() - t0) / it * 1e3
        results[name] = ms
        del arrays
    print(f"# {n} particles x {p} rays = {m} entries; pool "
          f"[{b}, {nc} cells, {k} slots], {nf} fields; {device}"
          + (f" ({card_line(device)}), device time" if on_card
             else ", host clock"))
    for name, ms in results.items():
        per_elem = ms * 1e6 / m  # ns per (row) entry
        print(f"{name:26s} {ms:8.3f} ms   ({per_elem:7.2f} ns/entry)"
              + (f"  {NOTES[name]}" if name in NOTES else ""))
    return results


if __name__ == "__main__":
    main()
