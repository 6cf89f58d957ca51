"""The port's profilers (``slam_eslam_tpu_torch.tools.profile_slam``,
``profile_filter``, ``profile_step``, ``profile_resample``,
``probe_spread``) on the CPU at a tiny size, against the JAX package.

``aggregate_trace`` sums the same hand-made trace as the JAX script's
``aggregate_trace`` (rows and total equal), falls back to the host
operators on a trace without device events, and reads a real CPU trace of
the port; the block copies' share counts the kernels of operators nested
in ``index_select`` / ``index_copy_``.  ``profile_step``: every stage but
``rng_only`` (random numbers of two generators cannot agree) equals the
JAX jitted stage on the same state and the same draws within rtol 1e-5
(``--lookup gather``; the fold of ``--lookup window`` only runs here).
``profile_resample``: the port's search against the JAX
``_resample_from_positions(method="bisect")`` on the same weights and
positions, +-1 on at most 5 positions, and its packed gather equal bit for
bit to the JAX ``take_packed``.  ``probe_spread`` fed the JAX draws: cell
extents within 0.05 cells, ESS within rtol 1e-3 and the resample flags
equal, step by step.  Each tool also runs from its command line and prints
the JAX script's lines.
"""

import contextlib
import dataclasses
import gzip
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_eslam_tpu_torch import convert
from slam_eslam_tpu_torch.tools import (probe_spread, profile_filter,
                                        profile_resample, profile_slam,
                                        profile_step)

from torch_jax_draws import (as_dict, jax_tool, project_draws,
                             resample_draws, t)

torch.set_num_threads(2)


# ------------------------------------------------------------ the traces

# (name, category, duration in us) of the hand-made trace's complete events
EVENTS = [("gemm_kernel", "kernel", 40.0), ("gemm_kernel", "kernel", 60.0),
          ("Memcpy HtoD", "gpu_memcpy", 5.5), ("Memset", "gpu_memset", 1.5),
          ("chain_lookup_kernel<4, float>", "kernel", 3.0),
          ("aten::mul", "cpu_op", 70.0), ("cudaLaunchKernel",
                                          "cuda_runtime", 4.0)]


def port_trace(path, events):
    ev = [{"ph": "X", "name": n, "cat": c, "dur": d, "ts": 10.0 * i,
           "pid": 0 if c in ("cpu_op", "cuda_runtime") else 1,
           "tid": 7, "args": {}} for i, (n, c, d) in enumerate(events)]
    path.mkdir(parents=True, exist_ok=True)
    (path / "trace.json").write_text(json.dumps({"traceEvents": ev}))


def jax_trace(path, events):
    """The same events in a ``jax.profiler`` trace: the device's lane is a
    process named for the TPU."""
    ev = [{"ph": "M", "name": "process_name", "pid": 1,
           "args": {"name": "/device:TPU:0"}},
          {"ph": "M", "name": "process_name", "pid": 0,
           "args": {"name": "/host:CPU"}}]
    ev += [{"ph": "X", "name": n, "dur": d, "ts": 10.0 * i,
            "pid": 0 if c in ("cpu_op", "cuda_runtime") else 1, "tid": 7}
           for i, (n, c, d) in enumerate(events)]
    path.mkdir(parents=True, exist_ok=True)
    with gzip.open(path / "host.trace.json.gz", "wt") as fh:
        json.dump({"traceEvents": ev}, fh)


def test_aggregate_trace_sums_the_device_events_as_the_jax_script(tmp_path):
    port_trace(tmp_path / "port", EVENTS)
    jax_trace(tmp_path / "jax", EVENTS)
    rows, total, path, kind = profile_slam.aggregate_trace(tmp_path / "port")
    jrows, jtotal, _ = jax_tool("profile_slam").aggregate_trace(
        str(tmp_path / "jax"))
    assert kind == "device" and path.name == "trace.json"
    assert [(n, (pytest.approx(ms), c)) for n, (ms, c) in jrows] == rows
    assert total == pytest.approx(jtotal) == pytest.approx(0.11)
    assert rows[0] == ("gemm_kernel", (pytest.approx(0.1), 2))
    # top cuts, None keeps every row
    assert len(profile_slam.aggregate_trace(tmp_path / "port", top=2)[0]) == 2
    assert len(profile_slam.aggregate_trace(tmp_path / "port",
                                            top=None)[0]) == 4


def test_aggregate_trace_sums_host_operators_without_a_device(tmp_path):
    host = [e for e in EVENTS if e[1] in ("cpu_op", "cuda_runtime")]
    port_trace(tmp_path, host + [("aten::mul", "cpu_op", 30.0)])
    rows, total, _, kind = profile_slam.aggregate_trace(tmp_path)
    assert kind == "host"
    assert rows == [("aten::mul", (pytest.approx(0.1), 2))]
    assert total == pytest.approx(0.1)


def test_op_share_counts_kernels_inside_the_copy_operators(tmp_path):
    """A kernel counts when its launching operator lies inside an
    ``index_select`` or ``index_copy_`` on the same thread, however deep."""
    cpu = lambda name, ts, dur, eid: {
        "ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur,
        "tid": 1, "pid": 0, "args": {"External id": eid}}
    kern = lambda ts, dur, eid: {
        "ph": "X", "cat": "kernel", "name": "k", "ts": ts, "dur": dur,
        "tid": 7, "pid": 1, "args": {"External id": eid}}
    ev = [cpu("aten::index_select", 0, 100, 1), cpu("aten::gather", 10, 20, 2),
          cpu("aten::index_copy_", 200, 50, 3), cpu("aten::add", 300, 10, 4),
          cpu("aten::index_select", 400, 5, 5),
          kern(0, 30, 2), kern(40, 10, 3), kern(60, 20, 4), kern(80, 40, 9)]
    tmp_path.mkdir(exist_ok=True)
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": ev}))
    ms, share = profile_slam.op_share(tmp_path)
    assert ms == pytest.approx(0.04) and share == pytest.approx(0.4)


def test_op_share_counts_the_row_copy_kernel(tmp_path):
    """The map pool's row-copy kernel (``ops.row_copy``, launched outside
    any operator) counts as a block copy by its name."""
    kern = lambda name, ts, dur: {"ph": "X", "cat": "kernel", "name": name,
                                  "ts": ts, "dur": dur, "tid": 7, "pid": 1,
                                  "args": {}}
    ev = [kern("(anonymous namespace)::row_copy_kernel((anonymous "
               "namespace)::Fields, int const*)", 0, 30),
          kern("block_merge_kernel", 40, 70)]
    tmp_path.mkdir(exist_ok=True)
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": ev}))
    ms, share = profile_slam.op_share(tmp_path)
    assert ms == pytest.approx(0.03) and share == pytest.approx(0.3)


# a body of three launches, as the card traces it: a gather inside an
# ``index_select``, an ``index_copy_`` and an ``add``; (operator,
# enclosing operator or None, kernel, device us)
BODY = [("aten::gather", "aten::index_select", "gather_kernel", 30.0),
        ("aten::index_copy_", None, "index_copy_kernel", 10.0),
        ("aten::add", None, "add_kernel", 20.0)]


def cpu_op(name, ts, dur, eid):
    return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur,
            "tid": 1, "pid": 0, "args": {"External id": eid}}


def runtime(name, ts, eid=None, corr=None):
    args = {} if eid is None else {"External id": eid}
    if corr is not None:
        args["correlation"] = corr
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts,
            "dur": 1, "tid": 1, "pid": 0, "args": args}


def record(name, ts, dur, eid=None, corr=None, cat="kernel"):
    args = {} if eid is None else {"External id": eid}
    if corr is not None:
        args["correlation"] = corr
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": 7, "pid": 1, "args": args}


def span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "tid": 1, "pid": 0, "args": {}}


def body_ops(t0, eid0, launch=True):
    """BODY's operators from ``t0`` (100 us apart), their External ids
    from ``eid0``, and with ``launch`` each kernel's launch call; returns
    the events and the ids of the launching operators."""
    ev, ids = [], []
    for i, (op, outer, _, _) in enumerate(BODY):
        ts, eid = t0 + 100 * i, eid0 + 2 * i
        if outer is not None:
            ev.append(cpu_op(outer, ts, 50, eid + 1))
        ev.append(cpu_op(op, ts + 5, 20, eid))
        if launch:
            ev.append(runtime("cudaLaunchKernel", ts + 10, eid, 700 + eid))
        ids.append(eid)
    return ev, ids


def write_trace(path, events):
    path.mkdir(parents=True, exist_ok=True)
    (path / "trace.json").write_text(json.dumps({"traceEvents": events}))
    return path


def eager_twin(path):
    ev, ids = body_ops(0, 10)
    ev += [record(k, 400 + 50 * i, us, eid=eid, corr=700 + eid)
           for i, ((_, _, k, us), eid) in enumerate(zip(BODY, ids))]
    return write_trace(path, ev)


def captured(path, number=5):
    """A warm-up trace: a launch before the stream capture starts (eager),
    then BODY captured as graph ``number``."""
    ev = [span(f"graph capture {number}", 1000, 500),
          cpu_op("aten::fill_", 1001, 2, 90),
          runtime("cudaLaunchKernel", 1002, 90, 990),
          record("fill_kernel", 1003, 1.0, eid=90, corr=990),
          runtime("cudaStreamBeginCapture", 1004)]
    ops, _ = body_ops(1010, 20)
    ev += ops + [runtime("cudaStreamEndCapture", 1400)]
    return write_trace(path, ev)


def replays(path, kept, number=5, extra=()):
    """One graph launch of graph ``number`` per entry of ``kept`` (the
    indices of BODY's records the tracer kept), each in a replay span."""
    ev = []
    for j, keep in enumerate(kept):
        t0, corr = 5000 * j, 3000 + j
        ev += [span(f"graph replay {number}", t0, 20),
               runtime("cudaGraphLaunch", t0 + 5, corr=corr)]
        ev += [record(BODY[i][2], t0 + 100 + 40 * i, BODY[i][3], corr=corr)
               for i in keep]
    return write_trace(path, ev + list(extra))


def test_replayed_kernels_are_attributed_as_their_eager_twins(tmp_path):
    """A replayed record carries no operator, only its graph launch: it
    takes the operator of the launch its capture recorded in its place,
    so the block copies' share reads as the eager twin's."""
    twin = profile_slam.op_share(eager_twin(tmp_path / "eager"))
    assert twin == (pytest.approx(0.04), pytest.approx(40 / 60))
    cap = captured(tmp_path / "warm-up")
    got = profile_slam.op_share(replays(tmp_path / "replay", [[0, 1, 2]]),
                                captures=(cap,))
    assert got == twin
    # ten replays: ten times the time, the same share
    ms, share = profile_slam.op_share(
        replays(tmp_path / "ten", [[0, 1, 2]] * 10), captures=(cap,))
    assert ms == pytest.approx(0.4) and share == pytest.approx(twin[1])
    # the graph launch's own record count: three launches a replay
    assert profile_slam.device_records(tmp_path / "ten", (cap,)) == (30, 30)


def test_device_records_shortfall_is_printed_and_returned(tmp_path, capsys):
    """Eager launches count one record each, a graph launch the launches
    its capture recorded; the records the tracer lost show as the
    difference, printed beside the device total."""
    cap = captured(tmp_path / "warm-up")
    eager, ids = body_ops(100_000, 40)
    # the tracer kept two of the three eager records
    eager += [record(BODY[i][2], 100_500 + 50 * i, BODY[i][3],
                     eid=ids[i], corr=700 + ids[i]) for i in (0, 2)]
    path = replays(tmp_path / "trace", [[0, 1, 2], [0, 2], [1]],
                   extra=eager)
    kept, launched = profile_slam.device_records(path, (cap,))
    assert (kept, launched) == (2 + 3 + 2 + 1, 3 + 3 * 3)
    rows, total, _, kind = profile_slam.aggregate_trace(path, top=None,
                                                        on_card=True)
    profile_slam.print_table(rows, total, path, kind, (kept, launched))
    assert "(device records 8 of 12 launches)" in capsys.readouterr().out
    # a replay that lost records is attributed by kernel name
    ms, _ = profile_slam.op_share(path, captures=(cap,))
    assert ms == pytest.approx((30 + 10 + 30 + 10 + 30) / 1e3)


def test_a_trace_on_the_card_without_device_records_raises(tmp_path):
    from slam_eslam_tpu_torch.utils.profiling import ProfilerLostRecords

    ev, _ = body_ops(0, 10)
    path = write_trace(tmp_path, ev)
    with pytest.raises(ProfilerLostRecords, match="no device record of 3 "):
        profile_slam.aggregate_trace(path, on_card=True)
    # off the card the host operators are summed, as before
    assert profile_slam.aggregate_trace(path)[3] == "host"


@pytest.mark.parametrize("case", [
    "no capture", "more records", "other kinds", "other kernels",
    "name of two answers"])
def test_an_unattributable_replayed_kernel_raises(tmp_path, case):
    """A replayed record that the traces cannot tie to the launch its
    capture recorded raises: it is never counted as another kernel."""
    cap = captured(tmp_path / "warm-up")
    kept = [[0, 1, 2]]
    extra = []
    if case == "no capture":
        path = replays(tmp_path / "trace", kept, number=6)
    elif case == "more records":
        path = replays(tmp_path / "trace", kept, extra=[
            record("stray_kernel", 180, 1.0, corr=3000)])
    elif case == "other kinds":
        path = replays(tmp_path / "trace", [[0, 1]], extra=[
            record("Memset", 180, 1.0, corr=3000, cat="gpu_memset")])
    elif case == "other kernels":
        path = replays(tmp_path / "trace", [[0, 1, 2], [0, 1]], extra=[
            record("other_kernel", 5180, 1.0, corr=3001)])
    else:
        # a graph whose one kernel name serves a copy and an add, and a
        # replay that lost one of the two
        ev = [span("graph capture 5", 1000, 500),
              runtime("cudaStreamBeginCapture", 1004),
              cpu_op("aten::index_copy_", 1010, 20, 20),
              runtime("cudaLaunchKernel", 1015, 20, 720),
              cpu_op("aten::add", 1110, 20, 22),
              runtime("cudaLaunchKernel", 1115, 22, 722),
              runtime("cudaStreamEndCapture", 1400)]
        cap = write_trace(tmp_path / "warm-up", ev)
        extra = [span("graph replay 5", 0, 20),
                 runtime("cudaGraphLaunch", 5, corr=1),
                 record("elementwise", 100, 5.0, corr=1),
                 record("elementwise", 110, 5.0, corr=1),
                 span("graph replay 5", 9000, 20),
                 runtime("cudaGraphLaunch", 9005, corr=2),
                 record("elementwise", 9100, 5.0, corr=2)]
        path = write_trace(tmp_path / "trace", extra)
    with pytest.raises(profile_slam.UnattributedKernel):
        profile_slam.op_share(path, captures=(cap,))


def test_graph_spans_name_captures_and_replays(tmp_path):
    """Under a profiler every capture and replay of ``utils.graphs`` is a
    span naming its graph (what ties a replayed kernel to its capture);
    without one no span is made."""
    from slam_eslam_tpu_torch.utils import graphs, profiling
    from torch_stand_in import StandIn

    runner = graphs.ScanRunner(lambda c, x: (c * 2 + x, c), StandIn(),
                               "spans")
    xs = [torch.ones(3) * i for i in range(4)]
    assert isinstance(graphs.span("x"), type(contextlib.nullcontext()))
    with profiling.trace(tmp_path):
        runner.run(torch.zeros(3), xs)
        runner.run(torch.zeros(3), xs)
    names = [ev["name"] for ev in profile_slam.complete_events(
        profile_slam.trace_file(tmp_path))
        if ev.get("cat") == "user_annotation"]
    number = int(next(n for n in names if n.startswith(
        graphs.CAPTURE_SPAN))[len(graphs.CAPTURE_SPAN):])
    assert names.count(f"{graphs.CAPTURE_SPAN}{number}") == 1
    # the first step eager, the second captured and replayed, then 6 more
    assert names.count(f"{graphs.REPLAY_SPAN}{number}") == 7
    assert runner.counts() == dict(eager=1, captured=1, replayed=7)


@pytest.fixture(scope="module")
def slam_profile(tmp_path_factory):
    trace_dir = tmp_path_factory.mktemp("slam_trace")
    return profile_slam.main(["--cpu", "--particles", "16", "--steps", "2",
                              "--top", "5", "--trace-dir", str(trace_dir)])


def test_profile_slam_on_a_real_cpu_trace(slam_profile, capsys):
    res = slam_profile
    assert res["kind"] == "host" and res["frames"] == 20
    assert res["mapped"] == 2 and 1 <= res["fired"] <= res["frames"]
    names = dict(res["rows_all"])
    assert names["aten::index_copy_"][1] > 0      # the block copies
    assert sum(ms for ms, _ in names.values()) == pytest.approx(
        res["total_ms"])
    # the plain versions ran: no kernel launched, no device time
    assert not any(res["launches"].values())
    assert (res["copy_ms"], res["copy_share"]) == (0.0, 0.0)


def test_profile_slam_prints_the_jax_scripts_lines(tmp_path, capsys):
    profile_slam.main(["--cpu", "--particles", "8", "--steps", "1", "--top",
                       "4", "--gate", "0,0", "--trace-dir", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    first = [ln for ln in out if ln.startswith("compile+first: ")]
    steady = [ln for ln in out if ln.startswith("steady: ")]
    assert len(first) == len(steady) == 1
    # the 0,0 gate fires on every frame
    assert "measurement fired 10/10, mapped 1" in steady[0]
    assert any(ln.startswith("trace: ") for ln in out)
    assert any(ln.startswith("total host time: ") for ln in out)
    rows = [ln for ln in out if " ms  x" in ln]
    assert len(rows) == 4


def test_profile_filter_runs_and_names_its_lookup(tmp_path, capsys):
    res = profile_filter.main(["--cpu", "--particles", "32", "--steps", "2",
                               "--top", "3", "--trace-dir", str(tmp_path),
                               "--lookup", "gather", "--window", "128x96"])
    out = capsys.readouterr().out
    assert res["lookup"] == profile_filter.FOLD
    assert f"lookup: {profile_filter.FOLD}" in out
    assert "compile+first: " in out and "ns/query" in out
    assert res["kind"] == "host" and res["rows_all"]
    assert "change nothing" in out
    assert "``--window`` are accepted and change nothing" in " ".join(
        profile_filter.__doc__.split())


# ------------------------------------------------------------ profile_step

def jax_stages(n):
    """The JAX script's state, contacts and stages (``--lookup gather``)
    at ``n`` particles, and the draws its stages take."""
    from slam_eslam_tpu.config import Config, ContactModelConfig
    from slam_eslam_tpu.core import filter as pf
    from slam_eslam_tpu.filter import pose_estimator as pe
    from slam_eslam_tpu.mapping.lookup import shared_grid_lookup
    from slam_eslam_tpu.models import sim as simlib
    from slam_eslam_tpu.utils import geometry

    cfg = dataclasses.replace(
        Config(), particle_count=n, min_effective=n // 5,
        contact_model=ContactModelConfig(contact_point_radius=0.0))

    def terrain(x, y):
        return 0.25 * np.sin(1.3 * np.asarray(x)) + 0.2 * np.cos(
            0.9 * np.asarray(y))

    grid = simlib.terrain_grid(terrain, nx=400, ny=400, resolution=0.05,
                               origin=(-10.0, -10.0))
    lookup = shared_grid_lookup(grid)
    state = pe.PoseEstimatorState.create(cfg, 20)
    particles = pe.init_gaussian(jax.random.PRNGKey(0), n, (0.0, 0.0), 0.0,
                                 (0.3, 0.3), 0.05, 0.2, 0.3)
    o = dataclasses.replace(
        state.odometry, delta_xy=jnp.array([0.0, 0.05]),
        sigma_xy=jnp.array([0.01, 0.02]), sigma_yaw=jnp.asarray(0.01),
        sigma_z=jnp.asarray(0.01), initialized=jnp.ones((), bool))
    state = dataclasses.replace(state, particles=particles, odometry=o)
    sim = simlib.TrajectorySim(terrain, speed=0.05)
    sim.step()
    cs = sim.contact_state()
    q = geometry.quat_identity()
    stages = {
        "project": jax.jit(lambda s: pe.project(s, q, cfg)),
        "update_weights": jax.jit(
            lambda s: pe.update_weights(s, cs, q, lookup, cfg)[0]),
        "update_full": jax.jit(lambda s: pe.update(s, cs, q, lookup, cfg)[0]),
        "resample_only": jax.jit(lambda s: pf.take(
            s.particles, pf.resample_stratified(
                jax.random.PRNGKey(0),
                pf.normalize_weights(s.particles.weight)[0], n))),
        "centroid": jax.jit(lambda s: pe.centroid(s.particles, q)),
    }
    draws = dict(project=project_draws(state.key, n)[1],
                 update_u=resample_draws(state.key, n)[1],
                 resample_u=t(jax.random.uniform(jax.random.PRNGKey(0),
                                                 (n,), jnp.float32)))
    return state, cs, stages, draws


def particle_arrays(out):
    p = out.particles if hasattr(out, "particles") else out
    return {f.name: np.asarray(getattr(p, f.name))
            for f in dataclasses.fields(p)}


def test_profile_step_stages_match_the_jax_stages():
    n = 64
    jstate, jcs, jstages, draws = jax_stages(n)
    cfg, lookup, tstate, tcs, q = profile_step.setup(n, 0, "gather", "cpu")
    # the script's deterministic inputs: the contacts and odometry
    np.testing.assert_array_equal(tcs.position.numpy(),
                                  np.asarray(jcs.position))
    for name in ("delta_xy", "sigma_xy", "sigma_yaw", "sigma_z",
                 "initialized"):
        np.testing.assert_array_equal(
            getattr(tstate.odometry, name).numpy(),
            np.asarray(getattr(jstate.odometry, name)), err_msg=name)
    state = convert.pose_estimator_state_from(as_dict(jstate))
    stages = profile_step.make_stages(cfg, lookup, tcs, q, draws,
                                      torch.Generator().manual_seed(0))
    assert set(stages) == set(jstages) | {"rng_only"}
    for name, jfn in jstages.items():
        got, ref = stages[name](state), jfn(jstate)
        if name == "centroid":
            for a, b in zip(got, ref):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-5, atol=1e-6)
            continue
        g, r = particle_arrays(got), particle_arrays(ref)
        for field, val in r.items():
            np.testing.assert_allclose(g[field], val, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name}.{field}")
        if name == "update_weights":
            np.testing.assert_allclose(float(got.max_weight),
                                       float(ref.max_weight), rtol=1e-5)
    assert stages["rng_only"](state).shape == (n, 2)


@pytest.mark.parametrize("lookup", ["gather", "window"])
def test_profile_step_prints_every_stage(lookup, capsys):
    res = profile_step.main(["--cpu", "--particles", "48", "--repeats", "1",
                             "--lookup", lookup, "--contact-cap", "8"])
    out = capsys.readouterr().out
    assert list(res) == list(profile_step.READS)
    for name, r in res.items():
        assert r["finite"] and r["bytes"] > 0 and r["bound_ms"] is None
        assert f"{name:>16}: " in out
    assert out.count("bound: card only") == len(res)
    assert ("K1 contact_fold" in out) == (lookup == "window")
    # project reads six fields and eight draws and writes six fields and
    # the step counter
    assert res["project"]["bytes"] == 48 * (6 + 8 + 6) * 4 + 4
    # the centroid writes a position and a quaternion
    assert res["centroid"]["bytes"] == 48 * 5 * 4 + 7 * 4


# -------------------------------------------------------- profile_resample

def test_profile_resample_search_and_packed_gather_match_jax():
    from slam_eslam_tpu.core import filter as jpf
    from slam_eslam_tpu.core.state import ParticleSet as JParticles

    n = 20_000
    w, pos = profile_resample.weights_and_positions(n, "cpu")
    ref = np.asarray(jpf._resample_from_positions(
        jnp.asarray(w.numpy()), jnp.asarray(pos.numpy()), method="bisect"))
    from slam_eslam_tpu_torch.core import filter as tpf

    got = tpf.resample_from_positions(w, pos)
    d = np.abs(got.numpy() - ref)
    assert d.max() <= 1 and (d > 0).sum() <= 5
    # the tool's check: every index brackets its position in the cumsum
    cs = profile_resample.searched_cumsum(w)
    assert profile_resample.check_search(got, cs, pos) == (0, 0)
    with pytest.raises(RuntimeError, match="do not bracket"):
        profile_resample.check_search(got.roll(1), cs, pos)

    rng = np.random.default_rng(5)
    m = 257
    fields = dict(
        x=rng.normal(size=m), y=rng.normal(size=m), yaw=rng.normal(size=m),
        z=rng.normal(size=m), z_sigma=rng.random(m), weight=rng.random(m),
        mprob=rng.random(m))
    fields = {k: v.astype(np.float32) for k, v in fields.items()}
    fields["x"][3] = np.nan
    fields["weight"][5] = -np.inf
    fields.update(floating=rng.random(m) < 0.5,
                  n_contacts=rng.integers(0, 9, m).astype(np.int32),
                  map_id=rng.integers(0, 999, m).astype(np.int32))
    idx = np.sort(rng.integers(0, m, m)).astype(np.int32)
    jout = jpf.take_packed(JParticles(**{k: jnp.asarray(v) for k, v in
                                         fields.items()}), jnp.asarray(idx))
    tout = profile_resample.take_packed(
        convert.particle_set_from(fields), torch.from_numpy(idx).long())
    for name in fields:
        a = getattr(tout, name).numpy()
        b = np.asarray(getattr(jout, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=name)


def test_profile_resample_prints_every_row(capsys):
    res = profile_resample.main(["--cpu", "--particles", "3000", "--iters",
                                 "1"])
    out = capsys.readouterr().out
    for name in ("searchsorted (bisect)", "take_packed (random sorted idx)",
                 "take_packed (identity idx)",
                 "normalize+idx-cond+take (fires)", "cumsum only",
                 "row gather [N,128]", "single [N] f32 gather"):
        assert res["ms"][name] > 0 and name in out
    for name in profile_resample.NO_COUNTERPART:
        assert res["ms"][name] is None
        assert f"{name:42s}      --- no counterpart: " in out
    assert "exactness: searchsorted brackets every position" in out
    assert res["mismatches"] == res["differs"] == 0


# ------------------------------------------------------------ probe_spread

def jax_spread(n, steps, cap):
    """The JAX script's loop at ``n`` particles; returns its per-step
    ``(sx, sy, ess, resampled)``, its start state and its draws."""
    from slam_eslam_tpu.config import Config, ContactModelConfig
    from slam_eslam_tpu.filter import pose_estimator as pe
    from slam_eslam_tpu.filter.step import cfg_odo
    from slam_eslam_tpu.mapping.lookup import make_lookup
    from slam_eslam_tpu.models import contact_model as cm
    from slam_eslam_tpu.models import odometry as odom
    from slam_eslam_tpu.models import sim as simlib
    from slam_eslam_tpu.utils import geometry
    from slam_eslam_tpu_torch.filter.step import StepDraws

    cfg = dataclasses.replace(
        Config(), particle_count=n, min_effective=n // 5,
        contact_model=ContactModelConfig(contact_point_radius=0.0))

    def terrain(x, y):
        return 0.25 * np.sin(1.3 * np.asarray(x)) + 0.2 * np.cos(
            0.9 * np.asarray(y))

    grid = simlib.terrain_grid(terrain, nx=400, ny=400, resolution=0.05,
                               origin=(-10.0, -10.0))
    lookup = make_lookup(cfg, grid)
    state = pe.PoseEstimatorState.create(cfg, cap)
    state = dataclasses.replace(state, particles=pe.init_gaussian(
        jax.random.PRNGKey(0), n, (0.0, 0.0), 0.0, (0.3, 0.3), 0.05, 0.2,
        0.3))
    sim = simlib.TrajectorySim(terrain, speed=0.05)
    css, qs = [], []
    for _ in range(steps):
        (_, yaw), _ = sim.step()
        css.append(sim.contact_state(noise=0.005).compact(cap))
        qs.append(np.asarray(geometry.quat_from_yaw(np.float32(yaw))))
    contact_states = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *css)
    orientations = jnp.asarray(np.stack(qs), jnp.float32)
    res = 0.05

    def one_step(state, inp):
        cs, q = inp
        state = dataclasses.replace(
            state, odometry=odom.update(state.odometry, cs, q, cfg_odo(cfg)))
        state = pe.project(state, q, cfg)
        cstate = cm.set_contact_points(cs, q)
        p = state.particles
        rot, trans = p.pose_matrix()
        px = cstate.position[:, 0][:, None]
        py = cstate.position[:, 1][:, None]
        pz = cstate.position[:, 2][:, None]
        wx = (rot[:, 0, 0][None] * px + rot[:, 0, 1][None] * py
              + rot[:, 0, 2][None] * pz + trans[:, 0][None])
        wy = (rot[:, 1, 0][None] * px + rot[:, 1, 1][None] * py
              + rot[:, 1, 2][None] * pz + trans[:, 1][None])
        act = (cstate.valid & ~(cstate.contact < cm.CONTACT_THRESHOLD))
        big = 1e9
        sx = (jnp.max(jnp.where(act[:, None], wx, -big))
              - jnp.min(jnp.where(act[:, None], wx, big))) / res
        sy = (jnp.max(jnp.where(act[:, None], wy, -big))
              - jnp.min(jnp.where(act[:, None], wy, big))) / res
        state, aux = pe.update(state, cs, q, lookup, cfg)
        return state, (sx, sy, aux["ess"], aux["resampled"])

    @jax.jit
    def run(state, cs, qs):
        return jax.lax.scan(one_step, state, (cs, qs))

    _, out = run(state, contact_states, orientations)
    key, draws = state.key, []
    for _ in range(steps):
        key, proj = project_draws(key, n)
        key, u = resample_draws(key, n)
        draws.append(StepDraws(proj, u))
    return [np.asarray(a) for a in out], state, css, draws


def test_probe_spread_follows_the_jax_script_on_its_draws():
    n, steps, cap = 24, 6, 8
    (sx, sy, ess, rs), jstate, jcss, draws = jax_spread(n, steps, cap)
    from slam_eslam_tpu_torch import bench

    css, qs, _, _ = bench.filter_trajectory(steps, cap)
    jstacked = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *jcss)
    for name in ("position", "contact", "group_id", "valid"):
        np.testing.assert_array_equal(getattr(css, name).numpy(),
                                      np.asarray(getattr(jstacked, name)))
    from slam_eslam_tpu_torch.mapping.lookup import make_lookup
    from slam_eslam_tpu_torch.models import sim as tsim

    cfg = probe_spread.spread_config(n)
    lookup = make_lookup(cfg, tsim.terrain_grid(bench.filter_terrain,
                                                **bench.FILTER_GRID))
    state = convert.pose_estimator_state_from(as_dict(jstate))
    got = probe_spread.spread_run(cfg, lookup, state, css, qs, draws)
    np.testing.assert_allclose(got["sx"], sx, atol=0.05)
    np.testing.assert_allclose(got["sy"], sy, atol=0.05)
    np.testing.assert_allclose(got["ess"], ess, rtol=1e-3)
    np.testing.assert_array_equal(got["resampled"], rs)
    assert (sx > 1).all() and (sy > 1).all()


def test_probe_spread_prints_the_jax_scripts_lines(capsys):
    res = probe_spread.main(["--cpu", "--particles", "16", "--steps", "4"])
    out = capsys.readouterr().out.splitlines()
    assert f"lookup: {profile_filter.FOLD}" in out
    head = out.index("step sx_cells sy_cells ess resampled")
    rows = out[head + 1:head + 5]
    assert [int(r.split()[0]) for r in rows] == [0, 1, 2, 3]
    assert [ln for ln in out if ln.startswith("# fits (128, ")] == [
        f"# fits (128, {lim}): {res['fits'][lim] * 100:.0f}% of steps"
        for lim in probe_spread.LIMS]
    assert res["updates"] == 4 and res["launches"]["contact_fold"] == 0
