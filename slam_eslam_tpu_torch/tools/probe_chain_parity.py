"""Parity and timing: the chain-lookup kernel (K2) against the plain chain
walk, at the SLAM bench's shapes.

Counterpart of ``tools/probe_chain_parity.py`` of the JAX package: the same
pool and queries, drawn in the same order from
``np.random.default_rng(0)`` (``B = N + 64`` blocks of 40x40 cells x 4
slots, means normal, stdevs in [0.01, 0.21), a coin-flip valid bit with
the horizontal bit set, block origins normal x 2 m, chains of 3 with 20 %
of the entries empty, 50 steps of ``[N, C, 3]`` queries normal x 3 m).
``mapping.map_pool.make_chain_lookup`` runs kernel K2 on CUDA tensors; the
plain walk is ``ops.chain_lookup.chain_lookup_reference``.  The parity line
compares them on step 0 (``found`` equal, and the largest differences of
``mean`` and ``stdev`` where the plain walk found a patch: both must be
0); then both run over the 50 steps, timed on the card as a CUDA graph of
the 50 lookups (device time), or on the host clock with ``--cpu``, where
both rows are the plain walk.

Usage: python -m slam_eslam_tpu_torch.tools.probe_chain_parity [N] [C]
           [--cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

NX, NY, K, L = 40, 40, 4, 3
STEPS = 50
RESOLUTION = 0.25
Z_WINDOW = 3.0


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=4096,
                    help="particles (default 4096)")
    ap.add_argument("c", nargs="?", type=int, default=8,
                    help="queries per particle (default 8)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (both rows the plain walk)")
    return ap


def operands(n, c):
    """The JAX script's pool fields and queries as NumPy arrays, drawn in
    its order: ``(mean, stdev, height, meta, origin, chain, pts)``."""
    b = n + 64
    rng = np.random.default_rng(0)
    mean = rng.normal(size=(b, NX, NY * K)).astype(np.float32)
    stdev = (0.01 + 0.2 * rng.random((b, NX, NY * K))).astype(np.float32)
    height = np.zeros((b, NX, NY * K), np.float32)
    meta = (rng.random((b, NX, NY * K)) < 0.5).astype(np.int32) | 2
    origin = (rng.normal(size=(b, 2)) * 2).astype(np.float32)
    chain = np.where(rng.random((n, L)) < 0.8,
                     rng.integers(0, b, size=(n, L)), -1).astype(np.int32)
    pts = rng.normal(size=(STEPS, n, c, 3)).astype(np.float32) * 3.0
    return mean, stdev, height, meta, origin, chain, pts


def make_pool(arrays, device):
    from slam_eslam_tpu_torch.mapping.map_pool import MapPool

    mean, stdev, height, meta, origin, chain, _ = (
        torch.from_numpy(a).to(device) for a in arrays)
    return MapPool(mean=mean, stdev=stdev, height=height, meta=meta,
                   color=None, origin=origin,
                   allocated=torch.ones(mean.shape[0], dtype=torch.bool,
                                        device=device),
                   chain=chain, resolution=RESOLUTION, nx=NX, ny=NY, k=K)


def plain_walk(pool, map_id, queries):
    """The plain chain walk over the chains of ``map_id``."""
    from slam_eslam_tpu_torch.ops.chain_lookup import chain_lookup_reference

    chain = pool.chain.index_select(0, map_id.long())
    return chain_lookup_reference(pool.mean, pool.stdev, pool.meta,
                                  pool.origin, pool.resolution, chain,
                                  queries, k=pool.k, z_window=Z_WINDOW)


def main(argv=None):
    """Run the probe; returns the parity (``found_equal``, ``max_dmean``,
    ``max_dstdev``, the found counts) and each row's ms per frame and
    M queries/s."""
    from slam_eslam_tpu_torch.mapping.map_pool import make_chain_lookup
    from slam_eslam_tpu_torch.utils import profiling
    from slam_eslam_tpu_torch.utils.device import card_line, entry_device

    args = parser().parse_args(argv)
    device = entry_device("cpu" if args.cpu else None)
    on_card = device.type == "cuda"
    n, c = args.n, args.c
    arrays = operands(n, c)
    pool = make_pool(arrays, device)
    pts = torch.from_numpy(arrays[-1]).to(device)
    steps = [tuple(pts[s, ..., j].contiguous() for j in range(3))
             for s in range(STEPS)]
    map_id = torch.arange(n, dtype=torch.int32, device=device)
    kernel = make_chain_lookup(pool, Z_WINDOW)
    rows = {"plain": lambda qs: plain_walk(pool, map_id, qs),
            "kernel (K2)": lambda qs: kernel(map_id, qs)}
    print(f"# {n} particles x {c} queries, pool [{n + 64}, {NX}, {NY * K}] "
          f"f32, chains of {L}, {device}"
          + (f" ({card_line(device)})" if on_card else
             ": both rows the plain walk, host clock"))

    ref, got = rows["plain"](steps[0]), rows["kernel (K2)"](steps[0])
    found = ref[0]
    same_f = bool(torch.equal(found, got[0]))
    dm = float(torch.where(found, ref[1] - got[1], 0.0).abs().max())
    ds = float(torch.where(found, ref[2] - got[2], 0.0).abs().max())
    nf0, nf1 = int(found.sum()), int(got[0].sum())
    print(f"parity: found {nf0} vs {nf1} equal={same_f} "
          f"max|dmean|={dm:.2e} max|dstdev|={ds:.2e}", flush=True)

    out = dict(found_equal=same_f, max_dmean=dm, max_dstdev=ds,
               found=(nf0, nf1))
    for name, fn in rows.items():
        def body(fn=fn):
            acc = torch.zeros((), device=device)
            for qs in steps:
                f, m, _ = fn(qs)
                acc = acc + torch.where(f, m, 0.0).sum()
            return acc

        t0 = time.perf_counter()
        body()
        profiling.sync()
        first = time.perf_counter() - t0
        if on_card:
            best = profiling.device_time(body, reps=1, replays=3)
        else:
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                body()
                best = min(best, time.perf_counter() - t0)
        out[name] = dict(ms_per_frame=best / STEPS * 1e3,
                         mq_per_s=n * c * STEPS / best / 1e6)
        print(f"{name}: {best / STEPS * 1e3:.4f} ms/frame "
              f"({n * c * STEPS / best / 1e6:.1f}M queries/s) "
              f"first call {first:.1f}s", flush=True)
    return out


if __name__ == "__main__":
    main()
