"""The functions that the JAX package's tools and demos jit themselves, as
CUDA graphs, on the CPU through the stand-in of ``tests/torch_stand_in.py``:
``tools.profile_step``'s six stages, ``examples.localize_demo``'s step,
``tools.probe_spread``'s scan and ``tools.stat_map_test``'s evaluation.
Each runs eagerly at its first meeting, is "captured" at its second and
"replayed" after, and must equal the eager run bit for bit on the same
inputs and generator state.  ``utils.graphs.CallGraphs(generator=)``
advances its generator as the eager calls do; a grid replaced between two
evaluations is read from its new tensors; ``graph=True`` on the CPU
raises.  The JAX parity of these functions is held in
``tests/test_torch_tools.py`` and ``tests/test_torch_tools_profile.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from slam_eslam_tpu_torch.config import ContactModelConfig
from slam_eslam_tpu_torch.examples import localize_demo
from slam_eslam_tpu_torch.mapping import mls_grid
from slam_eslam_tpu_torch.models import asguard
from slam_eslam_tpu_torch.models import contact_model as cm
from slam_eslam_tpu_torch.tools import probe_spread, profile_step
from slam_eslam_tpu_torch.tools import stat_map_test
from slam_eslam_tpu_torch.utils import geometry, graphs, tree
from torch_stand_in import StandIn, assert_bitwise

torch.set_num_threads(2)

quiet = lambda *a, **k: None


def draw(gen):
    return lambda x: x * 2.0 + torch.randn(x.shape, generator=gen)


@pytest.mark.parametrize("calls", [1, 2, 5])
def test_call_graphs_generator_advances_as_eager_calls(calls):
    """A function drawing from the generator given to ``CallGraphs``: every
    call (eager, captured, replayed) draws what the eager call draws from
    the same state, and the generator ends where the eager calls leave it;
    without ``generator=`` the capture's draws are not undone."""
    x = torch.arange(6.0)
    gen, ref_gen, bare_gen = (torch.Generator().manual_seed(4)
                              for _ in range(3))
    cg = graphs.CallGraphs(StandIn(), "test", generator=gen)
    bare = graphs.CallGraphs(StandIn(), "test")
    outs = [cg("draw", draw(gen), x) for _ in range(calls)]
    refs = [draw(ref_gen)(x) for _ in range(calls)]
    bares = [bare("draw", draw(bare_gen), x) for _ in range(calls)]
    assert_bitwise(outs, refs)
    assert torch.equal(gen.get_state(), ref_gen.get_state())
    assert (torch.equal(bare_gen.get_state(), ref_gen.get_state())
            == (calls == 1))
    if calls > 1:
        assert not torch.equal(bares[1], refs[1])
    assert cg.counts() == {k: v for k, v in dict(
        eager=1, captured=int(calls > 1), replayed=calls - 1).items() if v}


@pytest.fixture(scope="module", params=["gather", "window"])
def stage_setup(request):
    n = 64
    cfg, lookup, state, cs, q = profile_step.setup(n, 8, request.param,
                                                   "cpu")
    draws = profile_step.default_draws(n, "cpu")
    return request.param, cfg, lookup, state, cs, q, draws


@pytest.mark.parametrize("name", list(profile_step.READS))
def test_profile_step_stage_graphed_equals_eager(stage_setup, name):
    """Each stage as a ``CallGraphs`` key over ``stage_inputs``: its
    eager meeting, capture and replays give the eager stage's outputs on
    the same inputs bit for bit, and ``rng_only`` draws what the eager
    stage draws from the same generator state."""
    kind, cfg, lookup, state, cs, q, draws = stage_setup
    gen = torch.Generator().manual_seed(0)
    ref_gen = torch.Generator().manual_seed(0)
    eager = profile_step.make_stages(cfg, lookup, cs, q, draws,
                                     ref_gen)[name]
    stand_in = StandIn()
    cg = graphs.CallGraphs(stand_in, "profile_step", generator=gen)
    fn = profile_step.graphed_stage(cfg, kind, name, gen)
    x = profile_step.stage_inputs(state, cs, q, draws, lookup)
    for _ in range(3):
        assert_bitwise(cg(name, fn, x), eager(state))
    assert torch.equal(gen.get_state(), ref_gen.get_state())
    assert cg.counts() == dict(eager=1, captured=1, replayed=2)
    assert (stand_in.captures, stand_in.replays) == (1, 2)


@pytest.mark.parametrize("lookup", ["gather", "window"])
def test_profile_step_main_runs_its_stages_graphed(lookup, capsys):
    """``main`` through the stand-in: every stage graphed and equal to its
    eager call bit for bit; off the card no device time, no kernel sum, no
    launch count and no bound."""
    res = profile_step.main(["--cpu", "--particles", "48", "--repeats", "2",
                             "--lookup", lookup, "--contact-cap", "8"],
                            graph=StandIn())
    out = capsys.readouterr().out
    assert list(res) == list(profile_step.READS)
    for name, r in res.items():
        assert r["graphed"] and r["equal"] is True and r["finite"]
        assert r["ms"] is None and r["kernel_ms"] is None
        assert r["launches"] is None
        assert r["bound_ms"] is None and r["host_ms"] > 0
        assert (f"{name:>16}: " in out)
    assert out.count("graphed vs eager bit for bit: True") == len(res)
    assert "graphed: each stage one CUDA graph" in out
    # the eager run on the CPU by default
    res = profile_step.main(["--cpu", "--particles", "48", "--repeats",
                             "1"])
    assert not any(r["graphed"] or r["equal"] is not None
                   for r in res.values())


@pytest.mark.parametrize("with_draws", [False, True],
                         ids=["generator", "draws"])
def test_localize_demo_graphed_equals_eager(with_draws):
    """The demo's step as one ``CallGraphs`` key: the per-step centroids,
    ESS, resampling flags, the final state and the generator equal the
    eager loop's bit for bit; the step is captured once."""
    steps, n = 8, 16
    draws = None
    if with_draws:
        from slam_eslam_tpu_torch.filter import pose_estimator as pe

        gen = torch.Generator().manual_seed(3)
        draws = ((torch.randn((n, 2), generator=gen),
                  torch.randn((n,), generator=gen)),
                 [(pe.ProjectDraws.sample(n, gen, "cpu"),
                   torch.rand(n, generator=gen)) for _ in range(steps)])
    stand_in = StandIn()
    got = localize_demo.localize(steps, n, "cpu", draws, log=quiet,
                                 graph=stand_in)
    ref = localize_demo.localize(steps, n, "cpu", draws, log=quiet,
                                 graph=False)
    assert got["graphed"] and not ref["graphed"]
    assert_bitwise(
        (got["state"], torch.from_numpy(got["centroids"]),
         torch.tensor(got["ess"]), torch.tensor(got["resampled"])),
        (ref["state"], torch.from_numpy(ref["centroids"]),
         torch.tensor(ref["ess"]), torch.tensor(ref["resampled"])))
    assert torch.equal(got["state"].generator.get_state(),
                       ref["state"].generator.get_state())
    assert (stand_in.captures, stand_in.replays) == (1, steps - 1)
    assert got["launches"] == ref["launches"] == 0


@pytest.mark.parametrize("with_draws", [False, True],
                         ids=["generator", "draws"])
def test_spread_run_graphed_equals_eager(with_draws):
    """``spread_run`` as a ``ScanRunner``: every per-step row equal to the
    eager loop's bit for bit, the state's generator carried through the
    graph and left where the eager loop leaves it."""
    from slam_eslam_tpu_torch import bench
    from slam_eslam_tpu_torch.filter import pose_estimator as pe
    from slam_eslam_tpu_torch.filter.step import StepDraws
    from slam_eslam_tpu_torch.mapping.lookup import make_lookup
    from slam_eslam_tpu_torch.models import sim as simlib

    n, steps, cap = 24, 5, 8
    cfg = probe_spread.spread_config(n)
    lookup = make_lookup(cfg, simlib.terrain_grid(bench.filter_terrain,
                                                  **bench.FILTER_GRID))
    css, qs, _, _ = bench.filter_trajectory(steps, cap)
    draws = None
    if with_draws:
        gen = torch.Generator().manual_seed(9)
        draws = [StepDraws(pe.ProjectDraws.sample(n, gen, "cpu"),
                           torch.rand(n, generator=gen))
                 for _ in range(steps)]
    states = [pe.PoseEstimatorState.create(cfg, cap, device="cpu")
              for _ in range(2)]
    stand_in = StandIn()
    got, ref = (probe_spread.spread_run(
        cfg, lookup,
        dataclasses.replace(s, particles=bench.filter_particles(n)),
        css, qs, draws, graph=g)
        for s, g in zip(states, (stand_in, False)))
    assert got["graphed"] and not ref["graphed"]
    keys = ("sx", "sy", "ess", "resampled")
    assert_bitwise([torch.from_numpy(got[k]) for k in keys],
                   [torch.from_numpy(ref[k]) for k in keys])
    assert torch.equal(states[0].generator.get_state(),
                       states[1].generator.get_state())
    assert (stand_in.captures, stand_in.replays) == (1, steps - 1)


def test_stat_map_test_batch_graphed_equals_eager(tmp_path):
    """The batch run with its evaluation graphed: the raw arrays equal the
    eager run's bit for bit and the result files are identical."""
    runs = {}
    for name, graph in (("graphed", StandIn()), ("eager", False)):
        path = tmp_path / f"{name}.dat"
        raw = stat_map_test.main(["batch", "--cpu", "--steps", "24",
                                  "--runs", "2", "--result-file",
                                  str(path)], graph=graph)
        runs[name] = (raw, path.read_text())
    (got, got_file), (ref, ref_file) = runs["graphed"], runs["eager"]
    assert ref.pop("graphs") is None
    assert got.pop("graphs") == dict(eager=1, captured=1, replayed=41)
    assert sorted(got) == sorted(ref) == [
        "forward", "height_err", "map_sd", "map_z", "z_vars"]
    assert_bitwise([torch.from_numpy(got[k]) for k in sorted(got)],
                   [torch.from_numpy(ref[k]) for k in sorted(ref)])
    assert got_file == ref_file


def flat_grid(height):
    """A grid around the robot's start with every cell at ``height``."""
    g = mls_grid.MLSGrid.create(80, 80, 0.05, (-2.0, -2.0), k=1,
                                device="cpu")
    xs, ys = np.meshgrid(np.arange(-1.5, 1.5, 0.02),
                         np.arange(-1.5, 1.5, 0.02))
    xy = torch.tensor(np.stack([xs.ravel(), ys.ravel()], 1),
                      dtype=torch.float32)
    m = xy.shape[0]
    return mls_grid.merge_points(g, xy, torch.full((m,), height),
                                 torch.full((m,), 0.02),
                                 torch.ones(m, dtype=torch.bool), 0)


def test_eval_step_reads_a_replaced_grid():
    """Grids replaced between calls (as ``merge_points`` replaces the
    tool's grid every step) go into the graph's static inputs: each
    graphed call answers from the grid it is given, as the eager call
    does, and the answers differ between the grids."""
    cfg = ContactModelConfig(min_contacts=3,
                             contact_likelihood_correction=0.33,
                             contact_point_radius=0.0)
    sim = asguard.AsguardSim()
    sim.step(wheel_delta=0.1)
    cstate = cm.set_contact_points(tree.to(sim.contact_state(), "cpu"),
                                   geometry.quat_identity(device="cpu"))
    z_pos = torch.tensor(sim.position[2] + 0.01, dtype=torch.float32)
    z_var = torch.tensor(0.01)
    stand_in = StandIn()
    graphed = stat_map_test.make_eval_step(0.05, cfg, "cpu", stand_in)
    eager = stat_map_test.make_eval_step(0.05, cfg, "cpu", False)
    assert eager.graphs is None
    answers = []
    for height in (0.0, 0.03, 0.0, 0.05):
        grid = flat_grid(height)
        got = graphed(cstate, grid, z_pos, z_var)
        assert_bitwise(got, eager(cstate, grid, z_pos, z_var))
        assert bool(got[2])
        answers.append(float(got[0]))
    assert answers[0] == answers[2] != answers[1] != answers[3]
    assert (stand_in.captures, stand_in.replays) == (1, 3)


def graph_true_calls():
    args = ["--cpu", "--particles", "16"]
    return {
        "profile_step": lambda: profile_step.main(args + ["--repeats", "1"],
                                                  graph=True),
        "localize_demo": lambda: localize_demo.localize(2, 8, "cpu",
                                                        log=quiet,
                                                        graph=True),
        "probe_spread": lambda: probe_spread.main(args + ["--steps", "2"],
                                                  graph=True),
        "stat_map_test": lambda: stat_map_test.main(
            ["batch", "--cpu", "--steps", "2", "--runs", "1"], graph=True),
    }


@pytest.mark.parametrize("tool", sorted(graph_true_calls()))
def test_graph_true_raises_on_the_cpu(tool, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="CUDA device"):
        graph_true_calls()[tool]()
