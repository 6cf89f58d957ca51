"""Time the pieces of the ESS-gated resample.

Counterpart of ``tools/profile_resample.py`` of the JAX package, at 100,000
particles with the same kind of weights (a log-normal concentration,
``softmax(2.5 * normal)``) and stratum positions, both drawn from seeded
torch generators: the ancestor search (``core.filter.
resample_from_positions``, ``torch.searchsorted`` on the cumulative
weights of the ordered scan S1), the particle gather (the ten lanes
packed into one ``[N, 10]`` int32 row gather, beside the port's
``core.filter.take``, ten ``index_select`` calls), the whole gated
resample when it fires, the cumulative sum alone (S1, and
``torch.cumsum`` beside it), a ``[N, 128]`` row gather and a single
``[N]`` gather.  On the card each piece's time is its device time:
``--iters`` calls captured into a CUDA graph and replayed
(``utils.profiling.device_time``); on the CPU, the host clock.

The exactness line holds the search to the bracket that defines it
(``cumsum[i-1] < u <= cumsum[i]`` in the cumsum searched) and counts where
a host binary search of the same cumsum stops elsewhere, which it may only
where the float cumsum dips (the JAX script allows +-1 between its two
searches of one cumsum); it also counts where two calls of
``core.filter.resample_from_positions`` differ, which must be none: S1
adds in one fixed order (``torch.cumsum`` on the card does not, and two of
its sums of the same weights may differ in their last bits).

The JAX rows ``wide block=64/128/256``, ``cumsum+level1 compare-all`` and
``cond(take)`` are workarounds for the TPU (a two-level search where a
binary search's gathers are slow, a ``lax.cond`` around the gather): they
print "no counterpart" with the reason, and nothing imitates them.

Usage: python -m slam_eslam_tpu_torch.tools.profile_resample
           [--particles 100000] [--iters 200] [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from slam_eslam_tpu_torch.ops.ordered_scan import ordered_scan

NO_COUNTERPART = {
    "wide block=64": "the TPU's two-level search; the port searches with "
                     "torch.searchsorted",
    "wide block=128": "as above",
    "wide block=256": "as above",
    "cumsum+level1 compare-all": "level 1 of the TPU's two-level search",
    "cond(take) skip-side": "the port resamples with a device-side select "
                            "and one gather, never a lax.cond",
    "cond(take) fire-side": "as above",
}
# the ten lanes of a particle, in the JAX package's packed order
LANES = ("x", "y", "yaw", "z", "z_sigma", "weight", "mprob", "floating",
         "n_contacts", "map_id")
FLOAT_LANES = 7


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--particles", type=int, default=100_000)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (host clock)")
    return ap


def weights_and_positions(n, device, seed=0):
    """The weights ``softmax(2.5 * normal)`` and the stratum positions
    ``(k + u_k) / n``, from generators seeded ``seed`` and ``seed + 1``."""
    g0 = torch.Generator(device).manual_seed(seed)
    g1 = torch.Generator(device).manual_seed(seed + 1)
    w = torch.softmax(2.5 * torch.randn((n,), generator=g0, device=device),
                      0)
    u = torch.rand((n,), generator=g1, device=device)
    return w, (torch.arange(n, dtype=torch.float32, device=device) + u) / n


def take_packed(particles, idx):
    """``core.filter.take`` with the ten lanes packed into one ``[N, 10]``
    int32 matrix (the float lanes by their bits) and one row gather: the
    JAX package's ``take_packed``."""
    p = particles
    packed = torch.stack(
        [getattr(p, f).view(torch.int32) for f in LANES[:FLOAT_LANES]]
        + [p.floating.to(torch.int32), p.n_contacts.to(torch.int32),
           p.map_id.to(torch.int32)], dim=1)
    g = packed.index_select(0, idx)
    unpack = {f: g[:, i].contiguous().view(torch.float32)
              for i, f in enumerate(LANES[:FLOAT_LANES])}
    return dataclasses.replace(
        p, **unpack, floating=g[:, 7] != 0, n_contacts=g[:, 8].contiguous(),
        map_id=g[:, 9].contiguous())


def searched_cumsum(w):
    """The cumulative weights that ``core.filter.resample_from_positions``
    searches (the ordered scan S1): the last raised to cover 1."""
    cs = ordered_scan(w)
    return torch.cat([cs[:-1], cs[-1:].clamp(min=1.0 + 1e-6)])


def check_search(idx, cs, positions):
    """Hold ancestor indices ``idx`` against the cumulative weights ``cs``
    they were searched in: every index must bracket its position,
    ``cs[i - 1] < u <= cs[i]``, the one answer where ``cs`` rises and one of
    the answers where the float cumsum dips.  Returns the positions where a
    host binary search (NumPy, ``side="left"``) of the same ``cs`` stops
    elsewhere, and the largest distance between the two; raises if an
    index does not bracket its position."""
    idx, cs, pos = (t.cpu().numpy() for t in (idx, cs, positions))
    below = cs[np.maximum(idx - 1, 0)] < pos
    bracketed = ((idx == 0) | below) & (cs[idx] >= pos)
    if not bracketed.all():
        raise RuntimeError(f"searchsorted: {int((~bracketed).sum())} indices "
                           f"do not bracket their position")
    ref = np.clip(np.searchsorted(cs, pos, side="left"), 0, len(cs) - 1)
    d = np.abs(idx - ref)
    return int((d > 0).sum()), int(d.max())


def main(argv=None):
    """Run the pieces; returns ``{row: ms}`` (None for the rows with no
    counterpart), the exactness check's count of positions where the host
    bisect stops elsewhere and their largest distance, and the positions
    where two calls of the library's search differ."""
    from slam_eslam_tpu_torch.core import filter as pf
    from slam_eslam_tpu_torch.core.state import ParticleSet
    from slam_eslam_tpu_torch.utils import profiling
    from slam_eslam_tpu_torch.utils.device import card_line, entry_device

    args = parser().parse_args(argv)
    device = entry_device("cpu" if args.cpu else None)
    on_card = device.type == "cuda"
    n = args.particles
    w, positions = weights_and_positions(n, device)
    particles = ParticleSet.zeros(n, device)
    gen = torch.Generator(device).manual_seed(2)
    idx_sorted = torch.sort(torch.randint(0, n, (n,), generator=gen,
                                          device=device))[0]
    ident = torch.arange(n, device=device)
    u3 = torch.rand((n,), generator=torch.Generator(device).manual_seed(3),
                    device=device)
    nb = -(-n // 128)
    table = torch.randn((nb, 128),
                        generator=torch.Generator(device).manual_seed(4),
                        device=device)
    field = torch.arange(n, dtype=torch.float32, device=device)
    ramp = torch.arange(n, device=device)

    def fires():
        wn, ess = pf.normalize_weights(w)
        idx = torch.where(ess < 1e12, pf.resample_stratified(wn, u3), ident)
        return pf.take(dataclasses.replace(particles, weight=wn), idx)

    def rowgather():
        b = (w[:1] + ramp).to(torch.int64).clamp(0, nb - 1)
        return table.index_select(0, b)

    def onegather():
        i = (w[:1] + ramp).to(torch.int64).clamp(0, n - 1)
        return field.index_select(0, i)

    pieces = {
        "searchsorted (bisect)":
            lambda: pf.resample_from_positions(w, positions),
        "take_packed (random sorted idx)":
            lambda: take_packed(particles, idx_sorted),
        "take_packed (identity idx)": lambda: take_packed(particles, ident),
        "take, ten index_select (random sorted idx)":
            lambda: pf.take(particles, idx_sorted),
        "take, ten index_select (identity idx)":
            lambda: pf.take(particles, ident),
        "normalize+idx-cond+take (fires)": fires,
        "cumsum only": lambda: ordered_scan(w),
        "torch.cumsum (library)": lambda: torch.cumsum(w, 0),
        "row gather [N,128]": rowgather,
        "single [N] f32 gather": onegather,
    }
    order = ["searchsorted (bisect)", "wide block=64", "wide block=128",
             "wide block=256", "take_packed (random sorted idx)",
             "take_packed (identity idx)",
             "take, ten index_select (random sorted idx)",
             "take, ten index_select (identity idx)",
             "normalize+idx-cond+take (fires)", "cumsum only",
             "torch.cumsum (library)", "cumsum+level1 compare-all",
             "row gather [N,128]",
             "single [N] f32 gather", "cond(take) skip-side",
             "cond(take) fire-side"]

    def seconds(fn):
        if on_card:
            return profiling.device_time(fn, reps=args.iters, replays=1)
        fn()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            fn()
        return (time.perf_counter() - t0) / args.iters

    print(f"# {n} particles, {device}" + (
        f" ({card_line(device)}): device time, {args.iters} calls in a "
        f"CUDA graph" if on_card else ": host clock"))
    results = {}
    for name in order:
        if name in NO_COUNTERPART:
            results[name] = None
            print(f"{name:42s}      --- no counterpart: "
                  f"{NO_COUNTERPART[name]}", flush=True)
            continue
        results[name] = seconds(pieces[name]) * 1e3
        print(f"{name:42s} {results[name]:8.3f} ms", flush=True)

    # the search on one cumsum, held to the bracket that defines it and
    # beside a host bisect of the same cumsum; and the library's search
    # against it, which must repeat it bit for bit
    cs = searched_cumsum(w)
    idx = torch.searchsorted(cs, positions).clamp(0, n - 1)
    mismatches, worst = check_search(idx, cs, positions)
    again = pf.resample_from_positions(w, positions)
    differs = int((again != idx).sum())
    print(f"exactness: searchsorted brackets every position "
          f"(cumsum[i-1] < u <= cumsum[i]); {mismatches} stop elsewhere than "
          f"a host bisect of the same cumsum (at most {worst} apart, where "
          f"the float cumsum dips); {differs} differ between two calls of "
          f"core.filter.resample_from_positions", flush=True)
    # the packed gather equals the ten gathers
    a, b = take_packed(particles, idx_sorted), pf.take(particles, idx_sorted)
    if not all(torch.equal(getattr(a, f), getattr(b, f)) for f in LANES):
        raise RuntimeError("take_packed differs from take")
    return dict(ms=results, mismatches=mismatches, max_diff=worst,
                differs=differs)


if __name__ == "__main__":
    main()
