"""Time the filter step stage by stage.

Counterpart of ``tools/profile_step.py`` of the JAX package: project,
the weighting, the full update, resampling alone, the random draws alone
and the centroid, each at 100,000 particles on the 400x400 grid.  The
JAX script jits each stage and times it as one compiled call; here each
stage is one CUDA graph (``utils.graphs.CallGraphs``, a key a stage), by
default on the card (``graph=None`` of ``main``: ``utils.graphs.
resolve``), eagerly on the CPU.  Per stage, graphed:

* ``ms``: the stage's device time, CUDA events around replays of one
  graph of ``STAGE_REPS`` copies of the stage back to back
  (``utils.profiling.device_time``: the kernels of the stage's graph,
  the time between them included, the graph's own launch spread over the
  copies; no input copy, no output clone);
* ``kernel_ms``: the stage's kernels alone, their durations summed by
  ``torch.profiler`` over eager calls, per call (``utils.profiling.
  profiler_kernel_time``), the reading ``tools.profile_filter`` gives the
  step;
* ``host_ms``: the JAX script's reading, the host clock around one call
  (inputs copied in, the graph replayed, the outputs cloned) ending in
  ``torch.cuda.synchronize()``, best of ``--repeats``;
* ``launches``: the kernel-launch calls of an eager call of the stage
  (what its graph replays), from ``torch.profiler``'s host records;
* ``equal``: the graphed outputs against an eager call on the same
  inputs and generator state, bit for bit.

On the CPU the stages run eagerly and print the host clock; ``ms``,
``kernel_ms`` and ``launches`` are None there.  The warm-up runs each
stage eagerly (the kernels' build, the ordered scan's state) before
anything is timed, and the graph's eager meeting and its capture before
the host clock is read.

The JAX script prints XLA's cost analysis beside each stage.  The port
prints in its place the bytes the stage must move (the inputs it reads,
once, and the outputs it writes, once: the particle fields, the draws,
the contacts and the grid rows that the contact queries touch) and, on
the card, the time those bytes take at the card's memory rate
(``utils.profiling.H100_HBM_GBPS``).  On the card it also prints the
sums of ``project``, ``update_full`` and ``centroid``: the localisation
step's stages but ``odometry.update``.

``--lookup gather`` (the default) is the JAX script's unfolded full-grid
lookup: kernel K5 (``select_cells``) on the card.  ``--lookup window`` is
the JAX script's fold lookup: the port's ``make_lookup`` fold, kernel K1
(``contact_fold``), over the whole grid (the port has no window); with
``--contact-cap 8`` it is the bench's step.

Usage: python -m slam_eslam_tpu_torch.tools.profile_step
           [--particles 100000] [--repeats 5] [--lookup gather|window]
           [--contact-cap 0] [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

# the particle fields each stage reads
READS = {
    "project": ("x", "y", "yaw", "z", "z_sigma", "weight"),
    "update_weights": ("x", "y", "yaw", "z", "z_sigma", "weight", "map_id"),
    "update_full": ("x", "y", "yaw", "z", "z_sigma", "weight", "map_id"),
    "resample_only": ("x", "y", "yaw", "z", "z_sigma", "weight", "mprob",
                      "floating", "n_contacts", "map_id"),
    "rng_only": (),
    "centroid": ("x", "y", "yaw", "z", "weight"),
}
# the stages that look the contacts up in the grid
LOOKUPS = ("update_weights", "update_full")
# the stages of the localisation step (all of it but odometry.update)
STEP_STAGES = ("project", "update_full", "centroid")
# copies of a stage in the graph that times it on the card
STAGE_REPS = 20
# kernel launches that the profiler's sum of a stage's kernels spans: it
# profiles as many calls as hold them (a session can lose its first few
# records, and its processing grows with its records)
PROFILED_LAUNCHES = 400
DRAWS = ("project", "update_u", "resample_u")


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--particles", type=int, default=100_000)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions, no "
                         "bound)")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--lookup", choices=["gather", "window"],
                    default="gather",
                    help="gather: the unfolded lookup (K5); window: the "
                         "fold (K1), over the whole grid")
    ap.add_argument("--contact-cap", type=int, default=0,
                    dest="contact_cap")
    return ap


def setup(n, contact_cap, lookup_kind, device):
    """The script's configuration, grid lookup, state (propagating 5 cm
    forward a step), contact state and orientation on ``device``."""
    from slam_eslam_tpu_torch import bench
    from slam_eslam_tpu_torch.config import Config, ContactModelConfig
    from slam_eslam_tpu_torch.filter import pose_estimator as pe
    from slam_eslam_tpu_torch.models import sim as simlib
    from slam_eslam_tpu_torch.utils import geometry, tree

    cfg = dataclasses.replace(
        Config(), particle_count=n, min_effective=n // 5,
        contact_model=ContactModelConfig(contact_point_radius=0.0))
    grid = simlib.terrain_grid(bench.filter_terrain, **bench.FILTER_GRID,
                               device=device)
    lookup = lookup_of(cfg, grid, lookup_kind)
    state = pe.PoseEstimatorState.create(cfg, contact_cap or 20,
                                         device=device)
    f32 = dict(dtype=torch.float32, device=device)
    odo = dataclasses.replace(
        state.odometry, delta_xy=torch.tensor([0.0, 0.05], **f32),
        sigma_xy=torch.tensor([0.01, 0.02], **f32),
        sigma_yaw=torch.tensor(0.01, **f32),
        sigma_z=torch.tensor(0.01, **f32),
        initialized=torch.ones((), dtype=torch.bool, device=device))
    state = dataclasses.replace(
        state, particles=tree.to(bench.filter_particles(n), device),
        odometry=odo)
    sim = simlib.TrajectorySim(bench.filter_terrain, speed=0.05)
    sim.step()
    cs = sim.contact_state()
    if contact_cap:
        cs = cs.compact(contact_cap)
    return (cfg, lookup, state, tree.to(cs, device),
            geometry.quat_identity(device=device))


def lookup_of(cfg, grid, lookup_kind):
    """The lookup ``--lookup`` names on ``grid`` (an ``MLSGrid`` or its
    ``PackedLookup``)."""
    from slam_eslam_tpu_torch.mapping.lookup import (make_lookup,
                                                     shared_grid_lookup)

    return (make_lookup(cfg, grid) if lookup_kind == "window"
            else shared_grid_lookup(grid))


def default_draws(n, device, seed=0):
    """Fixed draws for the stages (the JAX script's stages draw from fixed
    keys): ``project``'s, the full update's resampling uniforms and
    resampling's own."""
    from slam_eslam_tpu_torch.filter import pose_estimator as pe

    gen = torch.Generator(device).manual_seed(seed)
    return dict(project=pe.ProjectDraws.sample(n, gen, device),
                update_u=torch.rand((n,), generator=gen, device=device),
                resample_u=torch.rand((n,), generator=gen, device=device))


def make_stages(cfg, lookup, cs, q, draws, generator):
    """``{stage: fn(state)}``; ``rng_only`` draws from ``generator``."""
    from slam_eslam_tpu_torch.core import filter as pf
    from slam_eslam_tpu_torch.filter import pose_estimator as pe

    n = cfg.particle_count

    def resample_only(s):
        w = pf.normalize_weights(s.particles.weight)[0]
        return pf.take(s.particles,
                       pf.resample_stratified(w, draws["resample_u"]))

    return {
        "project": lambda s: pe.project(s, q, cfg, draws["project"]),
        "update_weights": lambda s: pe.update_weights(s, cs, q, lookup,
                                                      cfg)[0],
        "update_full": lambda s: pe.update(s, cs, q, lookup, cfg,
                                           draws["update_u"])[0],
        "resample_only": resample_only,
        "rng_only": lambda s: torch.randn((n, 2), generator=generator,
                                          device=s.particles.x.device),
        "centroid": lambda s: pe.centroid(s.particles, q),
    }


def stage_inputs(state, cs, q, draws, lookup):
    """Every tensor the stages read, as one tree (``utils.graphs``'
    static inputs): the state, the contacts, the orientation, the draws
    and the lookup's packed tables."""
    return (state, cs, q, tuple(draws[k] for k in DRAWS), lookup.packed)


def graphed_stage(cfg, lookup_kind, name, generator):
    """Stage ``name`` as a function of ``stage_inputs``'s tree: its
    lookup is made on the packed tables it is given, so the graph reads
    no tensor outside its static inputs."""

    def fn(x):
        state, cs, q, draws, packed = x
        return make_stages(cfg, lookup_of(cfg, packed, lookup_kind), cs, q,
                           dict(zip(DRAWS, draws)), generator)[name](state)

    return fn


def tensors(tree_):
    """Every tensor in a tree of dataclasses, tuples and dicts."""
    if isinstance(tree_, torch.Tensor):
        return [tree_]
    if dataclasses.is_dataclass(tree_):
        tree_ = [getattr(tree_, f.name) for f in dataclasses.fields(tree_)]
    elif isinstance(tree_, dict):
        tree_ = list(tree_.values())
    if isinstance(tree_, (list, tuple)):
        return [t for item in tree_ for t in tensors(item)]
    return []


def nbytes(ts):
    return sum(t.numel() * t.element_size() for t in ts)


def touched_row_bytes(state, cs, q, lookup):
    """Bytes of the grid's slot rows that the contact queries of every
    particle touch, each distinct row once."""
    from slam_eslam_tpu_torch.mapping import mls_grid
    from slam_eslam_tpu_torch.models import contact_model as cm

    packed = lookup.packed
    cstate = cm.set_contact_points(cs, q)
    active = cstate.valid & ~(cstate.contact < cm.CONTACT_THRESHOLD)
    rot, trans = state.particles.pose_matrix()
    x, y, _ = cm.world_queries(cstate, rot, trans, 0.0)
    x, y = x[active], y[active]
    ix, iy = mls_grid.cells(packed, x, y)
    nx, ny, k2 = packed.data.shape
    inside = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
    rows = torch.unique((ix.long() * ny + iy.long())[inside]).numel()
    return rows * k2 * 4


def stage_bytes(name, state, out, draws, cs, row_bytes):
    """Bytes stage ``name`` must move: the particle fields it reads, its
    draws, the contacts and grid rows of a lookup, and every output
    tensor that is new (a field passed through is not written)."""
    p = state.particles
    read = nbytes(getattr(p, f) for f in READS[name])
    read += {"project": nbytes(tensors(draws["project"])),
             "update_full": nbytes([draws["update_u"]]),
             "resample_only": nbytes([draws["resample_u"]])}.get(name, 0)
    if name in LOOKUPS:
        read += nbytes(tensors(cs)) + row_bytes
    old = {id(t) for t in tensors(state)}
    written = nbytes(t for t in tensors(out) if id(t) not in old)
    return read + written


def kernels_and_launches(fn):
    """The profiler's sum of the kernels of one call of ``fn()`` in ms
    (over calls that hold ``PROFILED_LAUNCHES`` launches) and its
    kernel-launch calls; on the card only."""
    from slam_eslam_tpu_torch.utils import profiling

    launches = profiling.launch_calls(fn)
    calls = -(-PROFILED_LAUNCHES // max(launches, 1))
    return profiling.profiler_kernel_time(fn, calls=calls) * 1e3, launches


def best_host_s(call, repeats):
    """The host clock around ``call()`` ending in a device sync, best of
    ``repeats``; returns the seconds and the last call's outputs."""
    from slam_eslam_tpu_torch.utils import profiling

    best, out = float("inf"), None
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = call()
        profiling.sync()
        best = min(best, time.perf_counter() - t0)
    return best, out


def main(argv=None, graph=None):
    """Run the stages; returns ``{stage: {"ms", "kernel_ms", "host_ms",
    "launches", "bytes", "bound_ms", "finite", "equal", "graphed",
    "out"}}`` (``ms``, ``kernel_ms``, ``launches`` and ``bound_ms`` None
    off the card, ``equal`` None when eager).  ``graph``: as the port's
    runners take it (None: CUDA graphs on the card, eager on the CPU;
    ``utils.graphs.resolve``)."""
    from slam_eslam_tpu_torch.utils import graphs, profiling
    from slam_eslam_tpu_torch.utils.device import card_line, entry_device

    args = parser().parse_args(argv)
    device = entry_device("cpu" if args.cpu else None)
    n = args.particles
    cfg, lookup, state, cs, q = setup(n, args.contact_cap, args.lookup,
                                      device)
    draws = default_draws(n, device)
    gen = torch.Generator(device).manual_seed(0)
    stages = make_stages(cfg, lookup, cs, q, draws, gen)
    # a host read (torch.unique): outside every capture
    row_bytes = touched_row_bytes(state, cs, q, lookup)
    on_card = device.type == "cuda"
    capture = graphs.resolve(graph, device, what="profile_step")
    cg = (None if capture is None else
          graphs.CallGraphs(capture, "profile_step", generator=gen))
    x = stage_inputs(state, cs, q, draws, lookup)

    print(f"devices: {device}" + (f" ({card_line(device)})" if on_card
                                  else "") + f"  particles: {n}")
    print(f"lookup: --lookup {args.lookup}: "
          + ("the contact fold (kernel K1 contact_fold on the card), over "
             "the whole grid" if args.lookup == "window" else
             "the unfolded full-grid select (kernel K5 select_cells on the "
             "card)"))
    print(("graphed: each stage one CUDA graph; " if cg is not None
           else "eager; ") + (
        f"device = events around {STAGE_REPS} copies of the stage in one "
        f"graph, kernels = the profiler's sum of its kernels, host = host "
        f"clock around one call ending in a sync, launches = kernel-launch "
        f"calls of an eager call" if on_card else
        "host = the host clock around one call ending in a sync"))
    results = {}
    for name, eager in stages.items():
        # the kernels' build and the ordered scan's state, then the
        # stage's launch calls, eagerly
        out = eager(state)
        profiling.sync()
        b = stage_bytes(name, state, out, draws, cs, row_bytes)
        ms = kernel_ms = launches = equal = None
        fn = graphed_stage(cfg, args.lookup, name, gen)
        if on_card:
            kernel_ms, launches = kernels_and_launches(lambda: eager(state))
            ms = profiling.device_time(lambda: fn(x), reps=STAGE_REPS,
                                       generator=gen) * 1e3
        if cg is None:
            host_s, out = best_host_s(lambda: eager(state), args.repeats)
        else:
            call = lambda: cg(name, fn, x)
            call()      # the eager meeting
            call()      # the capture, and a replay
            host_s, out = best_host_s(call, args.repeats)
            drawn = gen.get_state()
            got = call()
            after = gen.get_state()
            gen.set_state(drawn)
            equal = (graphs.equal_bits(got, eager(state))[0]
                     and torch.equal(gen.get_state(), after))
        bound_ms = (b / (profiling.H100_HBM_GBPS * 1e9) * 1e3 if on_card
                    else None)
        finite = all(bool(torch.isfinite(t).all()) for t in tensors(out)
                     if t.is_floating_point())
        results[name] = dict(ms=ms, kernel_ms=kernel_ms,
                             host_ms=host_s * 1e3, launches=launches,
                             bytes=b, bound_ms=bound_ms, finite=finite,
                             equal=equal, graphed=cg is not None, out=out)
        bound = (f"bound={bound_ms:.4f} ms at "
                 f"{profiling.H100_HBM_GBPS:.0f} GB/s" if on_card
                 else "bound: card only")
        timing = (f"{ms:8.4f} ms device, kernels {kernel_ms:.4f} ms, host "
                  f"{host_s * 1e3:.3f} ms, {launches} launch calls"
                  if on_card else f"{host_s * 1e3:8.2f} ms host")
        same = ("" if equal is None
                else f"   graphed vs eager bit for bit: {equal}")
        print(f"{name:>16}: {timing}   bytes={b:.3g} {bound}{same}")
    if on_card:
        total = {k: sum(results[stage][k] for stage in STEP_STAGES)
                 for k in ("ms", "kernel_ms", "launches")}
        print(f"{' + '.join(STEP_STAGES)}: {total['ms']:.4f} ms device, "
              f"kernels {total['kernel_ms']:.4f} ms, {total['launches']} "
              f"launch calls (the localisation step's stages but "
              f"odometry.update)")
    return results


if __name__ == "__main__":
    main()
