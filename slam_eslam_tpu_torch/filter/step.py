"""Filter steps: the per-frame localisation path and a trajectory runner.

Port of ``slam_eslam_tpu.filter.step``: odometry update -> particle
propagation -> (gated) measurement update, the main path of
``EmbodiedSlamFilter::update`` (``EmbodiedSlamFilter.cpp:353-369``).
The JAX ``lax.cond`` gate becomes a device-side ``torch.where`` over
the two states.  No step reads a device value back to the host, so a
step is captured in a CUDA graph: with ``graph=True`` (the counterpart
of the JAX package's ``jax.jit`` and jitted ``lax.scan``) the step is
captured once per input shape and replayed (``utils.graphs``); with
``graph=False`` it runs as a Python loop of eager launches, the
counterpart of ``make_filter_step(jit=False)``.  ``graph=None``, the
default as ``jit=True`` is the JAX package's, resolves at each call:
graphs on a CUDA device with no mesh or an NCCL mesh, the eager loop on
the CPU and on a gloo or host mesh (``utils.graphs.resolve``).

``mesh=`` (``parallel.sharding.make_mesh``) runs a step on this rank's
slice of the particles (``parallel.sharding.shard_state``) with the
global draws; the lookup's kernels (K1, or K5 under ``--fold off``) run
on the rank's own particles against the replicated grid, and the
reductions over particles cross the mesh (``filter.pose_estimator``).
The ring-hop ``resampler`` hook takes ``(u, weights, particles)``.  A
meshed step reads nothing back to the host, so it captures as an
unmeshed one does.
"""

from __future__ import annotations

import dataclasses

import torch

from slam_eslam_tpu_torch.config import Config, OdometryConfig
from slam_eslam_tpu_torch.filter import pose_estimator as pe
from slam_eslam_tpu_torch.models import odometry as odom
from slam_eslam_tpu_torch.utils import graphs, tree


@dataclasses.dataclass
class StepDraws:
    """The random draws of one step: ``project``'s, the resampling
    uniforms ``[N]`` and, where a surface hash reinjects, its in-bucket
    integer draws ``[N]`` (``SurfaceHash.sample_bucket``)."""

    project: pe.ProjectDraws
    resample_u: torch.Tensor
    hash_u: torch.Tensor | None = None


def cfg_odo(cfg: Config):
    return OdometryConfig(seed=cfg.seed)


def _propagate(state, contact_state, orientation, cfg, draws, mesh=None):
    new_odo = odom.update(state.odometry, contact_state, orientation,
                          cfg_odo(cfg))
    state = dataclasses.replace(state, odometry=new_odo)
    return pe.project(state, orientation, cfg,
                      None if draws is None else draws.project, mesh=mesh)


def make_filter_step(cfg: Config, map_lookup, mesh=None, resampler=None,
                     graph=None):
    """Build ``step(state, contact_state, orientation, gate_ref,
    draws=None) -> (state, aux)``.

    The measurement update runs when the accumulated motion
    ``gate_ref = (distance, angle)`` passes
    ``cfg.measurement_threshold`` (``EmbodiedSlamFilter.cpp:360``, with
    the intended distance/angle argument order).  Both outcomes are
    computed and selected on the device.  ``mesh``: the state is this
    rank's (``parallel.sharding.shard_state``) and ``draws`` the global
    ones.  ``resampler``: forwarded to ``pose_estimator.update`` (e.g.
    ``parallel.resample.make_ppermute_resampler(mesh)``).

    ``graph=True`` (CUDA only; a mesh only over NCCL): every call copies
    its inputs into static buffers and replays the step captured at the
    second call with draws given or not (the first runs eagerly);
    ``gate_ref`` is written into a device buffer (two fill kernels from
    host numbers, or a copy of a device tensor).  The state and ``aux``
    returned are new tensors, and the state's generator advances as the
    eager step advances it.  ``graph=None`` (the default): graphed where
    the state's device and the mesh allow it, else eager (module
    docstring).  The step's ``graphs`` is its ``utils.graphs.ScanRunner``,
    None for the eager loop.
    """

    def gated(state, contact_state, orientation, dist, angle, draws):
        state = _propagate(state, contact_state, orientation, cfg, draws,
                           mesh)
        do_update = cfg.measurement_threshold.test(dist, angle)
        updated, aux = pe.update(
            state, contact_state, orientation, map_lookup, cfg,
            None if draws is None else draws.resample_u,
            resampler=resampler, mesh=mesh,
        )
        state = tree.where(do_update, updated, state)
        ess = torch.where(do_update, aux["ess"],
                          torch.full_like(aux["ess"], float("inf")))
        return state, {"ess": ess, "updated": do_update}

    return graphs.runner_for(
        graph, mesh, "make_filter_step",
        lambda capture: _filter_step(gated, capture),
        lambda state, *_: state.step.device)


def _filter_step(gated, capture):
    """``make_filter_step``'s step for a resolved ``graph=``."""
    if capture is False:
        def step(state, contact_state, orientation, gate_ref, draws=None):
            dist, angle = (torch.as_tensor(v, device=state.step.device)
                           for v in gate_ref)
            return gated(state, contact_state, orientation, dist, angle,
                         draws)

        step.graphs = None
        return step

    def body(state, x):
        contact_state, orientation, gate, draws = x
        state, aux = gated(state, contact_state, orientation, gate[0],
                           gate[1], draws)
        return state, (aux["ess"], aux["updated"])

    runner = graphs.ScanRunner(body, capture, "make_filter_step")
    gates = {}

    def graphed(state, contact_state, orientation, gate_ref, draws=None):
        device = state.step.device
        gate = gates.get(device)
        if gate is None:
            gate = gates[device] = torch.zeros(2, device=device)
        for i, v in enumerate(gate_ref):
            if torch.is_tensor(v):
                gate[i].copy_(v)
            else:
                gate[i].fill_(v)
        state, (ess, updated) = runner.run(
            state, [(contact_state, orientation, gate, draws)])
        return state, {"ess": ess[0], "updated": updated[0]}

    graphed.graphs = runner
    return graphed


def make_scan_runner(cfg: Config, map_lookup, mesh=None, graph=None):
    """Roll a trajectory with a measurement update on every step (the
    benchmark regime).

    ``run(state, contact_states, orientations, draws=None)`` takes the
    per-step ``BodyContactState`` stacked along a leading time axis
    (``utils.tree.stack``), ``orientations [T, 4]`` and optionally a
    sequence of T ``StepDraws``.  Returns ``(final_state, centroids
    [T, 3])``.  ``mesh``: as for ``make_filter_step``; the centroids are
    global, the same on every rank.

    ``graph=True`` (CUDA only; a mesh only over NCCL): the step is
    captured once per input shape (draws given or not) and replayed T
    times, the JAX package's jitted ``lax.scan``; each replay's inputs
    are copied from ``contact_states[t]``, ``orientations[t]`` and
    ``draws[t]``.  The result equals the eager loop's bit for bit (the
    state's generator advanced alike); the state returned and the
    centroids are new tensors.  ``graph=None`` (the default): as
    ``make_filter_step``'s.
    """

    def step(state, cs, q, d):
        state = _propagate(state, cs, q, cfg, d, mesh)
        state, _ = pe.update(state, cs, q, map_lookup, cfg,
                             None if d is None else d.resample_u, mesh=mesh)
        c_pos, _ = pe.centroid(state.particles, q,
                               wrap_safe=cfg.wrap_safe_centroid, mesh=mesh)
        return state, c_pos

    return graphs.runner_for(
        graph, mesh, "make_scan_runner",
        lambda capture: _scan_runner(step, capture),
        lambda state, *_: state.step.device)


def _scan_runner(step, capture):
    """``make_scan_runner``'s runner for a resolved ``graph=``."""
    if capture is not False:
        runner = graphs.ScanRunner(lambda s, x: step(s, *x), capture,
                                   "make_scan_runner")

        def graphed(state, contact_states, orientations, draws=None):
            xs = [(tree.index(contact_states, t), orientations[t],
                   None if draws is None else draws[t])
                  for t in range(orientations.shape[0])]
            state, (cents,) = runner.run(state, xs)
            return state, cents

        graphed.graphs = runner
        return graphed

    def run(state, contact_states, orientations, draws=None):
        cents = []
        for t in range(orientations.shape[0]):
            state, c_pos = step(state, tree.index(contact_states, t),
                                orientations[t],
                                None if draws is None else draws[t])
            cents.append(c_pos)
        return state, torch.stack(cents)

    run.graphs = None
    return run
