"""The meshed runners as CUDA graphs, and the default ``graph=None``.

A CUDA graph needs the card, and a captured collective needs NCCL; here
every meshed runner runs on worlds of 2 and 4 gloo ranks
(``tests/torch_mesh_cases.py::mesh_graph_cases``) through the stand-in of
``tests/torch_stand_in.py`` (a capture runs the step and undoes its
writes, a replay runs it again), against the same runner run eagerly on
the same ranks from the same inputs and draws: the filter step with the
gather and the ring-hop resampler, the scan runner, the SLAM runner with
the pool whole on every rank and split by block range (a drive where
particles migrate between ranks), ``OnlineSlam(mesh=)`` (``run_stream``),
and the meshed PCG and Schur solves.  Each must equal the eager meshed
run bit for bit; the split pool's graphed run asks other ranks for the
rows its eager run asks for (``Mesh.remote``, counted on the device).
The fixed-shape exchanges, which read nothing back to the host, are also
held one by one to one process: the ring-hop resample at
``ceil((P - 1) / 2)`` rounds with the weight collapsed onto the first and
onto the last rank, and the split pool's chain lookup, ``fetch_rows``,
copy-on-write and rollover on a migrated drive's pool.

``graph=True`` over a gloo or host mesh raises by name, and ``graph=None``
resolves to graphs only on a CUDA device with no mesh or an NCCL mesh.
"""

import dataclasses

import numpy as np
import pytest
import torch

from slam_eslam_tpu_torch.backend import pose_graph as tpg
from slam_eslam_tpu_torch.backend.keyframes import KeyframeManager
from slam_eslam_tpu_torch.config import Config
from slam_eslam_tpu_torch.filter import step as tstep
from slam_eslam_tpu_torch.filter import streaming as tst
from slam_eslam_tpu_torch.filter.eslam_filter import EmbodiedSlamFilter
from slam_eslam_tpu_torch.online import OnlineSlam
from slam_eslam_tpu_torch.parallel.distributed import run_world
from slam_eslam_tpu_torch.parallel.sharding import Mesh
from slam_eslam_tpu_torch.utils import graphs, tree
import torch_mesh_cases

WORLDS = (2, 4)
N = 32


@pytest.fixture(scope="module")
def worlds():
    return {p: run_world(torch_mesh_cases.mesh_graph_cases, p,
                         args=({"particles": N, "slam": True},),
                         device="cpu", timeout=600) for p in WORLDS}


def every_rank(worlds, ranks, *path):
    for r in worlds[ranks]:
        for key in path:
            r = r[key]
        yield r


@pytest.mark.parametrize("ranks", WORLDS)
@pytest.mark.parametrize("case", ["filter", "filter_ppermute"])
def test_meshed_filter_step_graphed_equals_eager(worlds, ranks, case):
    """Four forced-resample steps, the state gathered after each: equal
    bit for bit."""
    for out in every_rank(worlds, ranks, case):
        assert out["equal"] and out["replayed"] == 3


@pytest.mark.parametrize("ranks", WORLDS)
def test_meshed_scan_runner_graphed_equals_eager(worlds, ranks):
    for out in every_rank(worlds, ranks, "scan"):
        assert out["equal"]
        assert out["counts"] == dict(eager=1, captured=1, replayed=2)


@pytest.mark.parametrize("ranks", WORLDS)
@pytest.mark.parametrize("pool", ["slam_whole", "slam_split"])
def test_meshed_slam_runner_graphed_equals_eager(worlds, ranks, pool):
    """Filter state, chains, every pool field, centroids and best poses
    gathered: equal bit for bit.  Both runs ask other ranks for the same
    rows; the split pool's blocks and chain levels move between ranks."""
    for out in every_rank(worlds, ranks, pool):
        assert out["equal"] and out["mapped"] > 0 and out["replayed"] > 0
        assert out["remote"]["graphed"] == out["remote"]["eager"]
    if pool == "slam_split":
        moved = lambda what: sum(r["remote"]["eager"].get(what, 0)
                                 for r in every_rank(worlds, ranks, pool))
        assert moved("block copy") > 0 and moved("chain lookup") > 0


@pytest.mark.parametrize("ranks", WORLDS)
def test_meshed_online_slam_graphed_equals_eager(worlds, ranks):
    """Two ``OnlineSlam(mesh=)`` chunks through ``run_stream``'s graphs:
    the eager chunks bit for bit."""
    for out in every_rank(worlds, ranks, "online"):
        assert out["equal"] and out["keyframes"] == 2
        assert out["counts"]["replayed"] > 0


@pytest.mark.parametrize("ranks", WORLDS)
@pytest.mark.parametrize("solver", ["cg", "schur"])
def test_meshed_solves_graphed_equal_eager(worlds, ranks, solver):
    """Eager, captured and replayed meshed solves (the third on another
    graph) against the eager meshed solve, bit for bit."""
    for out in every_rank(worlds, ranks, "solves", solver):
        assert out["equal"]
        assert out["counts"] == dict(eager=1, captured=1, replayed=2)


@pytest.mark.parametrize("ranks", WORLDS)
@pytest.mark.parametrize("hot", ["first", "last"])
def test_ppermute_fixed_rounds_equal_eager(worlds, ranks, hot):
    """The weight on one rank: every slot draws from it, ``P - 1`` hops
    away for some rank; the fixed rounds give the single-device
    resample's ancestors and move the payload by them, bit for bit."""
    for out in every_rank(worlds, ranks, "ppermute", hot):
        assert out["equal"]
    nl = N // ranks
    src = np.asarray(out["idx"]) // nl
    assert (src == (0 if hot == "first" else ranks - 1)).all()


@pytest.mark.parametrize("ranks", WORLDS)
def test_fixed_capacity_exchanges_equal_eager(worlds, ranks):
    """The split pool's exchanges, each issued, equal one process's eager
    pool operations bit for bit; the lookup's levels and the fetched rows
    came from other ranks."""
    outs = list(every_rank(worlds, ranks, "fixed_pool"))
    for out in outs:
        assert out["equal"]
        assert {"block copy", "chain lookup", "head origins",
                "t"} <= set(out["issued"])
    moved = {k for out in outs for k in out["remote"]}
    assert {"chain lookup", "t"} <= moved


def gloo(transport="gloo"):
    return Mesh(group=None, size=1, rank=0, device=torch.device("cpu"),
                backend="gloo", transport=transport)


@pytest.mark.parametrize("transport", ["gloo", "host"])
def test_graph_true_on_a_gloo_or_host_mesh_raises(transport):
    mesh = gloo(transport)
    match = f"transport is '{transport}'"
    cfg = Config()
    for make in (tstep.make_filter_step, tstep.make_scan_runner):
        with pytest.raises(ValueError, match=match):
            make(cfg, None, mesh=mesh, graph=True)
    for make in (tst.make_slam_step, tst.make_slam_scan_runner):
        with pytest.raises(ValueError, match=match):
            make(cfg, mesh=mesh, graph=True)
    with pytest.raises(ValueError, match=match):
        OnlineSlam(config=cfg, mesh=mesh, graph=True, device="cpu")
    builder = tpg.PoseGraphBuilder(4, 4, device="cpu")
    with pytest.raises(ValueError, match=match):
        builder.optimize(solver="cg", mesh=mesh, graph=True)


@pytest.mark.parametrize("where, graphed", [
    (("cpu", None), False), (("cuda", None), True),
    (("cuda", "nccl"), True), (("cuda", "gloo"), False),
    (("cuda", "host"), False)])
def test_default_resolves_by_device_and_mesh(where, graphed):
    device, transport = where
    mesh = None if transport is None else dataclasses.replace(
        gloo(transport), backend="nccl" if transport == "nccl" else "gloo")
    capture = graphs.resolve(None, device, mesh)
    assert (capture is not None) == graphed
    assert graphs.supported(device, mesh) == graphed
    if graphed:
        assert isinstance(capture, graphs.Capture)
    assert graphs.resolve(False, device, mesh) is None


def test_default_runs_eagerly_on_the_cpu():
    """``graph=None`` on the CPU: every runner, the filter, ``OnlineSlam``,
    the keyframe manager and the builder resolve to their eager runs."""
    from slam_eslam_tpu_torch.dryrun import GATE, _build

    cfg, lookup, state, cs, q = _build(16, nx=16, ny=16, device="cpu")
    step = tstep.make_filter_step(cfg, lookup)
    step(state, cs, q, GATE)
    assert step.graphs is None
    run = tstep.make_scan_runner(cfg, lookup)
    run(state, tree.stack([cs]), q[None])
    assert run.graphs is None
    assert not EmbodiedSlamFilter(device="cpu").graphed
    assert not KeyframeManager(device="cpu").graphed
    assert not OnlineSlam(device="cpu").graphed
    assert tpg.PoseGraphBuilder(4, 4, device="cpu").graphs_of(None) is None


def test_default_resolves_once_per_runner():
    """A runner built with ``graph=None`` resolves its mode at its first
    call, from its inputs' device, builds once, and refuses a call on
    another device."""
    built = []

    def build(capture):
        built.append(capture)
        runner = lambda device: device.type
        runner.graphs = None if capture is False else capture
        return runner

    runner = graphs.runner_for(None, None, "runner", build,
                               lambda device: device)
    with pytest.raises(AttributeError, match="first call"):
        runner.graphs
    cpu = torch.device("cpu")
    assert runner(cpu) == "cpu" and runner(cpu) == "cpu"
    assert built == [False] and runner.graphs is None
    with pytest.raises(ValueError, match="make a runner for each device"):
        runner(torch.device("meta"))
    assert built == [False]
