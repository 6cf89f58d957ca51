"""The port's measurement scripts and demo, run on the CPU at a tiny size.

``tools.probe_merge_overhead``: every variant and flag of the JAX
package's ``tools/probe_merge_overhead.py`` runs and prints (the kernels'
plain versions on the host clock: the times mean nothing here, the lines
and the parity do); its operands are those of the JAX script, drawn in the
same order from the same seed.  ``tools.stat_map_test``: the batch rig
against the JAX script's on the same seeds, raw per-step arrays within
1e-5 m (float32 contact model and grid on both sides; the noise comes from
the same numpy generator), and the result file's ten columns.
``examples.slam_demo``: a few steps, scans merged.
``examples.localize_demo``: the JAX demo's loop (40 steps, 96 particles)
run here with its key, and the port's loop fed the same draws: centroids
within 1e-3 m at every step.  ``examples.loop_closure_demo``: the same
closures (index pairs, scores within 1e-5) and y drift (within 1e-4 m)
before and after optimisation as the JAX demo's loop.
``examples.replay_demo``: a tiny run on the CPU, its recording the JAX
demo's records (timestamps aside).  ``examples.full_demo`` on the CPU at
8 particles and 12 steps: it exits 0 and prints the JAX demo's JSON keys; its log reads
bit for bit the same through the JAX ``frames_from_log``; its first chunk
follows the JAX ``OnlineSlam`` of the same configuration on the same log
and the JAX draws (centroids within 1e-3 m, gates and keyframe frames
equal).  ``tools.closure_lab`` on that run's graph: every policy's solve
equals the JAX ``pose_graph.optimize`` / ``optimize_schur`` on the same
edge masks (keyframe ATE and chi2 history within rtol 1e-4), and its edge
classes differ from the JAX lab's exactly on the keyframe-0 -> node-1 yaw
prior of a hand-made graph.
"""

import argparse
import dataclasses
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from slam_eslam_tpu_torch.examples import (full_demo, localize_demo,
                                           loop_closure_demo, replay_demo,
                                           slam_demo)
from slam_eslam_tpu_torch.ops import block_merge as bm
from slam_eslam_tpu_torch.tools import closure_lab
from slam_eslam_tpu_torch.tools import probe_merge_overhead as probe
from slam_eslam_tpu_torch.tools import stat_map_test
from slam_eslam_tpu_torch.utils import kernel_eff

from torch_jax_draws import jax_tool

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
TINY = ["--cpu", "--particles", "16", "--rays", "8", "--nx", "8", "--ny",
        "8", "--k", "4", "--iters", "2"]


def test_probe_prints_every_variant(capsys):
    results = probe.main(TINY)
    out = capsys.readouterr().out
    assert list(results) == list(probe.VARIANTS)
    lines = [ln for ln in out.splitlines() if not ln.startswith("#")]
    assert len(lines) == len(probe.VARIANTS)
    for name, line in zip(probe.VARIANTS, lines):
        assert results[name]["label"] in line
        assert " ms " in line and "us/block" in line and "byte bound" in line
        assert results[name]["ms"] > 0 and results[name]["bound_ms"] > 0
    header = [ln for ln in out.splitlines() if ln.startswith("# 16 particles")]
    assert len(header) == 1 and "P=8, block [8,32] f32, cpu" in header[0]
    # the grouped variants are the merge itself, timed once: their rows
    # repeat its time, and the parity lines are zero
    for g in probe.GROUPS:
        assert results[f"grouped{g}"]["ms"] == results["merge"]["ms"]
        assert (f"# parity grouped{g}-vs-production: max|dmean|=0.0 "
                f"max|dmeta|=0") in out
    assert out.count("# parity grouped") == len(probe.GROUPS)
    assert out.count("are kernel K3 itself") == 1
    # a copy moves whole blocks, a merge only the cells its points hit
    assert results["copy_packed"]["bound_ms"] > results["merge"]["bound_ms"]
    assert results["copy_all"]["bound_ms"] > results["copy_fields"]["bound_ms"]
    assert (results["merge_packed"]["bound_ms"]
            == results["merge"]["bound_ms"])


@pytest.mark.parametrize("only,extra,want", [
    ("merge,merge_packed", [], ["merge", "merge_packed"]),
    ("copy_packed", [], ["copy_packed"]),
    ("grouped4,grouped16", ["--no-parity"], ["grouped4", "grouped16"]),
    ("grouped8", ["--particles", "12"], ["grouped8"]),    # 12 % 8 != 0
])
def test_probe_flags(capsys, only, extra, want):
    results = probe.main(TINY + ["--only", only] + extra)
    out = capsys.readouterr().out
    if "12" in extra:
        assert results == {} and "# parity" not in out
        return
    assert list(results) == want
    assert ("# parity" in out) == (only.startswith("grouped")
                                   and "--no-parity" not in extra)


def test_probe_rejects_unknown_variants():
    with pytest.raises(SystemExit, match="unknown variants"):
        probe.main(TINY + ["--only", "merge,copy_everything"])


def test_probe_operands_are_the_jax_scripts():
    """Same seed, same order of draws as ``tools/probe_merge_overhead.py``
    (lines 64-81), and its packed image."""
    n, p, nx, ny, k = 16, 8, 8, 8, 4
    fields, blk, points = kernel_eff.merge_benchmark_operands(
        n, p, nx, ny, k, "cpu")
    rng = np.random.default_rng(0)
    b, nyk = n + 64, ny * k
    mean = rng.normal(size=(b, nx, nyk)).astype(np.float32)
    stdev = rng.uniform(0.05, 0.3, size=(b, nx, nyk)).astype(np.float32)
    height = np.zeros((b, nx, nyk), np.float32)
    meta = (rng.random(size=(b, nx, nyk)) < 0.5).astype(np.int32)
    ref_blk = rng.permutation(b)[:n].astype(np.int32)
    lx = rng.integers(0, nx, size=(n, p)).astype(np.int32)
    ly = rng.integers(0, ny, size=(n, p)).astype(np.int32)
    w = rng.uniform(1.0, 50.0, size=(n, p)).astype(np.float32)
    wz = rng.normal(size=(n, p)).astype(np.float32)
    for got, ref in zip(fields + (blk,) + tuple(points),
                        (mean, stdev, height, meta, ref_blk, lx, ly, w, wz)):
        np.testing.assert_array_equal(got.numpy(), ref)
    packed = np.concatenate([mean, stdev, height, meta.view(np.float32)], 1)
    np.testing.assert_array_equal(
        bm.pack_fields(*fields).view(torch.int32).numpy(),
        packed.view(np.int32))


def stat_args(tmp_path, name, **kw):
    args = dict(mode="batch", steps=72, runs=2, sigma_step=0.002,
                sigma_body=0.05, sigma_sensor=0.02, sigma_factor=0.33,
                min_contacts=3, result_file=str(tmp_path / f"{name}.dat"),
                seed=3, run_offset=0, save_raw=None, merge_raw=None,
                cpu=True)
    args.update(kw)
    return argparse.Namespace(**args)


def test_stat_map_test_matches_the_jax_script(tmp_path):
    jtool = jax_tool("stat_map_test")
    raw = {}
    for name, tool in (("jax", jtool), ("port", stat_map_test)):
        path = tmp_path / f"{name}.npz"
        tool.run_batch(stat_args(tmp_path, name, save_raw=str(path)))
        raw[name] = dict(np.load(path))
    assert set(raw["port"]) == set(raw["jax"]) == {
        "height_err", "z_vars", "forward", "map_z", "map_sd"}
    for key, ref in raw["jax"].items():
        got = raw["port"][key]
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref),
                                      err_msg=key)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5,
                                   equal_nan=True, err_msg=key)
    # the robot reached the mapped rows, and the runs differ by their seeds
    assert np.isfinite(raw["jax"]["map_z"]).any()
    assert np.abs(raw["jax"]["height_err"][0]
                  - raw["jax"]["height_err"][1]).max() > 1e-4


def test_stat_map_test_result_file(tmp_path, capsys):
    out = tmp_path / "res.dat"
    stat_map_test.main(["batch", "--cpu", "--steps", "6", "--runs", "2",
                        "--result-file", str(out)])
    rows = np.loadtxt(out)
    assert rows.shape == (6, 10)
    np.testing.assert_array_equal(rows[:, 0], np.arange(6))
    assert (np.diff(rows[:, 1]) > 0).all()           # forward distance
    assert (rows[:, 8] <= rows[:, 2]).all() and (rows[:, 2] <= rows[:, 9]).all()
    assert "final height error" in capsys.readouterr().out
    # shards written raw and merged give the same file
    for off in (0, 1):
        stat_map_test.main(["batch", "--cpu", "--steps", "6", "--runs", "1",
                            "--run-offset", str(off), "--save-raw",
                            str(tmp_path / f"shard{off}.npz")])
    merged = tmp_path / "merged.dat"
    stat_map_test.main(["--merge-raw", str(tmp_path / "shard*.npz"),
                        "--result-file", str(merged)])
    np.testing.assert_allclose(np.loadtxt(merged), rows, rtol=1e-12)


def test_slam_demo_runs_on_the_cpu(capsys):
    rows = slam_demo.main(["--cpu", "--steps", "3", "--particles", "8"])
    out = capsys.readouterr().out
    assert len(rows) == 3 and out.count("map_patches=") == 3
    assert "best particle:" in out
    assert rows[0][3] is True                     # the first scan merges
    patches = [r[4] for r in rows]
    assert patches[0] > 0 and patches[-1] >= patches[0]
    assert all(np.isfinite(r[2]) and r[2] < 1.0 for r in rows)


def jax_localize(steps, n):
    """``examples/localize_demo.py``'s loop; returns its centroids and
    the draws it took: the start normals (key 7) and, per step,
    ``project``'s draws and the resampling uniforms of the state key."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from slam_eslam_tpu import Config, ContactModelConfig
    from slam_eslam_tpu.filter import pose_estimator as pe
    from slam_eslam_tpu.mapping.lookup import shared_grid_lookup
    from slam_eslam_tpu.models import sim as simlib
    from slam_eslam_tpu.utils import geometry
    from slam_eslam_tpu_torch.filter import pose_estimator as tpe

    t = lambda a: torch.from_numpy(np.array(a))
    cfg = dataclasses.replace(
        Config(), particle_count=n, min_effective=n // 2,
        contact_model=ContactModelConfig(contact_point_radius=0.0))
    grid = simlib.terrain_grid(localize_demo.terrain, nx=160, ny=160,
                               resolution=0.1, origin=(-8.0, -8.0))
    lookup = shared_grid_lookup(grid)
    sim = simlib.TrajectorySim(localize_demo.terrain, speed=0.06)
    state = pe.PoseEstimatorState.create(cfg, 20)
    kxy, kyaw = jax.random.split(jax.random.PRNGKey(7))
    normals = (t(jax.random.normal(kxy, (n, 2))),
               t(jax.random.normal(kyaw, (n,))))
    state = dataclasses.replace(state, particles=pe.init_gaussian(
        jax.random.PRNGKey(7), n, sim.position[:2], 0.0, (0.4, 0.4), 0.05,
        sim.position[2], 0.3))

    @jax.jit
    def step_fn(state, cs, q, delta_xy, dyaw, dz):
        o = dataclasses.replace(
            state.odometry, delta_xy=delta_xy, delta_yaw=dyaw, delta_z=dz,
            sigma_xy=jnp.array([0.01, 0.02]), sigma_yaw=jnp.asarray(0.01),
            sigma_z=jnp.asarray(0.01), initialized=jnp.ones((), bool))
        state = dataclasses.replace(state, odometry=o)
        state = pe.project(state, q, cfg)
        state, _ = pe.update(state, cs, q, lookup, cfg)
        return state, pe.centroid(state.particles, q)[0]

    cents, per_step = [], []
    for _ in range(steps):
        key, k_delta, k_slip1, k_slip2, k_sxy, k_syaw = jax.random.split(
            state.key, 6)
        k1, k2 = jax.random.split(k_delta)
        normal = lambda k, s: t(jax.random.normal(k, s, jnp.float32))
        uniform = lambda k, s: t(jax.random.uniform(k, s, jnp.float32))
        proj = tpe.ProjectDraws(
            delta_xy=normal(k1, (n, 2)), delta_yaw=normal(k2, (n,)),
            slip=uniform(k_slip1, (n,)), shrink=uniform(k_slip2, (n,)),
            spread_xy=normal(k_sxy, (n, 2)), spread_yaw=normal(k_syaw, (n,)))
        per_step.append((proj, uniform(jax.random.split(key)[1], (n,))))
        (pos, yaw), (d_body, dyaw, dz) = sim.step()
        state, c = step_fn(
            state, sim.contact_state(noise=0.005),
            geometry.quat_from_yaw(jnp.asarray(yaw, jnp.float32)),
            jnp.asarray(d_body, jnp.float32), jnp.asarray(dyaw, jnp.float32),
            jnp.asarray(dz, jnp.float32))
        cents.append(np.asarray(c))
    return np.stack(cents), (normals, per_step)


def test_localize_demo_matches_jax(capsys):
    steps, n = 40, 96
    ref, draws = jax_localize(steps, n)
    got = localize_demo.localize(steps, n, "cpu", draws=draws)
    np.testing.assert_allclose(got["centroids"], ref, atol=1e-3)
    assert got["errors"][-10:, 0].mean() < 0.4
    out = capsys.readouterr().out
    assert "final-10 mean xy ATE" in out and "select_cells" in out
    # the command line, the generators' own draws
    res = localize_demo.main(["--cpu", "--steps", "3", "--particles", "8"])
    assert res["errors"].shape == (3, 2) and res["launches"] == 0


def jax_loop_closure():
    """``examples/loop_closure_demo.py``'s loop."""
    import jax.numpy as jnp

    from slam_eslam_tpu.backend.keyframes import KeyframeManager
    from slam_eslam_tpu.mapping.mls_grid import PatchCloud

    rng = np.random.default_rng(0)

    def scan_cloud(true_pose, n=400):
        local = rng.uniform(-1.5, 1.5, (n, 2)).astype(np.float32)
        c, s = np.cos(true_pose[2]), np.sin(true_pose[2])
        world = np.stack(
            [c * local[:, 0] - s * local[:, 1] + true_pose[0],
             s * local[:, 0] + c * local[:, 1] + true_pose[1]], axis=1)
        z = loop_closure_demo.terrain(world[:, 0], world[:, 1]).astype(
            np.float32)
        return PatchCloud.create(
            xy=jnp.asarray(local), z=jnp.asarray(z - 0.2),
            stdev=jnp.full((n,), 0.05), valid=jnp.ones((n,), bool))

    km = KeyframeManager(keyframe_distance=0.45, closure_radius=1.0,
                         min_separation=4, min_score=0.3, closure_info=2000.0)
    xs = list(np.arange(0, 3.1, 0.5)) + list(np.arange(2.5, -0.1, -0.5))
    drift, believed = 0.0, []
    for x in xs:
        true_pose = np.array([x, 0.0, 0.0])
        belief = true_pose + np.array([0.0, drift, 0.0])
        added, _ = km.maybe_add_keyframe(belief, scan_cloud(true_pose), z=0.2)
        if added:
            drift += 0.06
            believed.append(belief)
    traj, _ = km.optimize(iters=15)
    return (km.closures, np.abs(np.array(believed)[:, 1]).max(),
            np.abs(np.asarray(traj)[: len(believed), 1]).max())


def test_loop_closure_demo_matches_jax(capsys):
    closures, before, after = jax_loop_closure()
    got = loop_closure_demo.main(["--cpu"])
    assert [c[:2] for c in got["closures"]] == [c[:2] for c in closures]
    np.testing.assert_allclose([c[2] for c in got["closures"]],
                               [c[2] for c in closures], atol=1e-5)
    assert abs(got["err_before"] - before) < 1e-12
    assert abs(got["err_after"] - after) < 1e-4
    assert got["closures"] and got["err_after"] < got["err_before"]
    assert "max |y| drift after" in capsys.readouterr().out


def test_replay_demo_runs_on_the_cpu(capsys):
    res = replay_demo.main(["--cpu", "--steps", "2", "--particles", "8"])
    out = capsys.readouterr().out
    assert "recorded 21 frames" in out and "replayed 20 frames" in out
    assert res["errors"].shape == (20,) and np.isfinite(res["errors"]).all()
    assert res["centroids"].shape == (20, 3) and res["updates"] >= 1
    assert 0 <= res["wait"] <= res["seconds"]


def test_replay_demo_records_the_jax_demos_records(tmp_path):
    """The recording of ``examples/replay_demo.py`` (lines 47-64), made
    with the JAX package, holds the port's records (timestamps come from
    the wall clock, so they are left out)."""
    from slam_eslam_tpu.io import logio as jlogio
    from slam_eslam_tpu.models.asguard import AsguardSim as JSim

    path = tmp_path / "port.eslg"
    assert replay_demo.record(path, 2) == 21
    ref = tmp_path / "jax.eslg"
    sim = JSim(terrain=replay_demo.terrain)
    with jlogio.LogWriter(ref) as w:

        def record(s):
            w.write_contact_state(s.contact_state(), 0)
            w.write_orientation([1.0, 0, 0, 0], 0)
            w.write_pose(s.position, [1.0, 0, 0, 0], 0)

        record(sim)
        for _ in range(2):
            sim.step(wheel_delta=0.3, on_substep=record)
    with jlogio.LogReader(path) as a, jlogio.LogReader(ref) as b:
        assert len(a) == len(b) == 63
        for i in range(len(a)):
            (ta, _, pa), (tb, _, pb) = a.get(i), b.get(i)
            assert (ta, pa) == (tb, pb)


DEMO_ARGS = ["--cpu", "--steps", "12", "--particles", "8", "--chunk", "20",
             "--keyframe-distance", "0.1", "--min-separation", "2"]


@pytest.fixture(scope="module")
def demo_run(tmp_path_factory):
    """``full_demo`` run as a module on the CPU, its log and truth kept
    (``--log-cache``) and its graph dumped (``--save-graph``)."""
    tmp = tmp_path_factory.mktemp("full_demo")
    proc = subprocess.run(
        [sys.executable, "-m", "slam_eslam_tpu_torch.examples.full_demo",
         *DEMO_ARGS, "--log-cache", str(tmp / "loop"), "--save-graph",
         str(tmp / "graph.npz"), "--out", str(tmp / "out")],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    return dict(proc=proc, log=tmp / "loop.eslg",
                truth=np.load(tmp / "loop.truth.npy"), graph=tmp / "graph.npz",
                args=full_demo.parser().parse_args(DEMO_ARGS))


def test_full_demo_prints_the_jax_demos_json_keys(demo_run):
    proc = demo_run["proc"]
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1]
    got = json.loads(line)
    src = (REPO / "examples" / "full_demo.py").read_text()
    block = src[src.index("print(json.dumps({"):]
    keys = re.findall(r'^\s+"(\w+)":', block[:block.index("}))")], re.M)
    assert list(got) == keys and len(keys) == 21
    assert got["particles"] == 8 and got["frames"] == 120
    assert got["keyframes"] >= 2 and got["pool_dtype"] == "float32"
    assert "graph dump ->" in proc.stdout
    assert (Path(demo_run["graph"].parent / "out" / "full_demo.png")
            .exists())


def test_full_demo_log_reads_equal_through_jax(demo_run):
    from slam_eslam_tpu.filter import streaming as jst
    from slam_eslam_tpu_torch.filter import streaming

    path = str(demo_run["log"])
    frames, ts, intr = streaming.frames_from_log(path, camera=True,
                                                 texture=True, device="cpu")
    jframes, jts, jintr = jst.frames_from_log(path, camera=True,
                                              texture=True)
    cs = jframes[0]
    pairs = [(getattr(frames.contact, f), getattr(cs, f)) for f in (
        "position", "contact", "slip", "group_id", "valid")]
    pairs += list(zip(
        [frames.q, frames.body_pos, frames.ranges, frames.start_angle,
         frames.angular_resolution, frames.has_scan, frames.dimg,
         frames.has_dimg, frames.timg], [*jframes[1:4], *jframes[4],
                                         *jframes[5:]]))
    assert len(pairs) == 14
    for a, b in pairs:
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(ts, np.asarray(jts))
    assert intr == jintr
    np.testing.assert_allclose(intr, full_demo.rigs()["intrinsics"],
                               atol=1e-6)
    truth = demo_run["truth"]
    assert len(frames) == len(truth) == 121
    np.testing.assert_allclose(frames.host_body_pos, truth[:, :3],
                               atol=1e-6)
    assert frames.host_has_scan.sum() == 12
    assert frames.host_has_dimg.sum() == 6


def to_jax(obj):
    """A port configuration dataclass as the JAX package's."""
    from slam_eslam_tpu import config as jconfig

    cls = getattr(jconfig, type(obj).__name__)
    return cls(**{f.name: (to_jax(v) if dataclasses.is_dataclass(v) else v)
                  for f in dataclasses.fields(obj)
                  for v in [getattr(obj, f.name)]})


def jax_draws(key, updated, n):
    """The JAX filter's key splits of a stream: ``project``'s draws per
    frame, then the resampling uniforms where the measurement gate
    fired."""
    import jax
    import jax.numpy as jnp

    from slam_eslam_tpu_torch.filter import pose_estimator as tpe
    from slam_eslam_tpu_torch.filter.step import StepDraws

    t = lambda a: torch.from_numpy(np.array(a))
    out = []
    for up in updated:
        key, k_delta, k_slip1, k_slip2, k_sxy, k_syaw = jax.random.split(
            key, 6)
        kxy, kyaw = jax.random.split(k_delta)
        normal = lambda k, s: t(jax.random.normal(k, s, jnp.float32))
        uniform = lambda k, s: t(jax.random.uniform(k, s, jnp.float32))
        proj = tpe.ProjectDraws(
            delta_xy=normal(kxy, (n, 2)), delta_yaw=normal(kyaw, (n,)),
            slip=uniform(k_slip1, (n,)), shrink=uniform(k_slip2, (n,)),
            spread_xy=normal(k_sxy, (n, 2)), spread_yaw=normal(k_syaw, (n,)))
        u = None
        if up:
            key, k_rs = jax.random.split(key)
            u = uniform(k_rs, (n,))
        out.append(StepDraws(proj, u))
    return out


def test_full_demo_chunk_follows_jax_online_slam(demo_run):
    """One chunk of the demo's ``OnlineSlam`` against the JAX one built
    with the same configuration, on the same log, fed the JAX draws."""
    import jax

    from slam_eslam_tpu.config import OdometryConfig as JOdometry
    from slam_eslam_tpu.filter import streaming as jst
    from slam_eslam_tpu.online import OnlineSlam as JOnline
    from slam_eslam_tpu_torch.filter import streaming

    args, truth = demo_run["args"], demo_run["truth"]
    path, n, chunk = str(demo_run["log"]), args.particles, args.chunk
    rig = full_demo.rigs()
    js = JOnline(config=to_jax(full_demo.demo_config(args)), submap_scans=3,
                 odometry_config=JOdometry(dist_error_xy=0.35,
                                           const_error_xy=0.004),
                 laser2body=rig["laser"], camera2body=rig["camera"],
                 camera_intrinsics=rig["intrinsics"], camera_texture=True,
                 keyframe_kw=full_demo.keyframe_kw(args))
    js.init(pose=(truth[0][:3], truth[0][3]))
    _, k_init = jax.random.split(jax.random.PRNGKey(js.filter.config.seed))
    kxy, kyaw = jax.random.split(k_init)
    t = lambda a: torch.from_numpy(np.array(a))
    slam = full_demo.make_slam(args, truth[0], "cpu", normals=(
        t(jax.random.normal(kxy, (n, 2))), t(jax.random.normal(kyaw, (n,)))))
    jframes, _, _ = jst.frames_from_log(path, camera=True, texture=True)
    frames, _, _ = streaming.frames_from_log(path, camera=True,
                                             texture=True, device="cpu")
    sl = slice(0, chunk)
    key = js.filter.state.key
    jaux = js.process_chunk(jax.tree_util.tree_map(lambda a: a[sl],
                                                   jframes))
    run = full_demo.replay(slam, frames.at(sl), chunk,
                           jax_draws(key, np.asarray(jaux["updated"]), n))
    taux = run["auxes"][0]
    for name in ("updated", "mapped", "cam_mapped"):
        np.testing.assert_array_equal(taux[name], np.asarray(jaux[name]))
    assert taux["mapped"].any() and taux["cam_mapped"].any()
    np.testing.assert_allclose(run["centroids"], np.asarray(jaux["centroid"]),
                               atol=1e-3)
    assert slam.keyframe_frames == js.keyframe_frames == [chunk - 1]
    np.testing.assert_allclose(slam.keyframes.keyframes[0].pose,
                               js.keyframes.keyframes[0].pose, atol=1e-3)


# chi2 below this is float32 rounding: an exactly consistent chain of a
# few metres leaves residuals of ~1e-7 at an information of 1e4 per edge
CHI2_ZERO = 1e-6


def jax_solve(g, solver, iters, robust, delta):
    import jax.numpy as jnp

    from slam_eslam_tpu.backend import pose_graph as jpg

    graph = jpg.PoseGraph(**{k: jnp.asarray(v) for k, v in g.items()})
    opt = jpg.optimize_schur if solver == "schur" else jpg.optimize
    out, hist = opt(graph, iters=iters, robust=robust, robust_delta=delta)
    return np.asarray(out.nodes), np.asarray(hist)


@pytest.mark.parametrize("solver", ["dense", "schur"])
def test_closure_lab_matches_jax_optimize(demo_run, solver, capsys):
    d = closure_lab.load(demo_run["graph"])
    iters = 5
    got = closure_lab.lab(d, iters=iters, solver=solver, device="cpu")
    assert "kf ATE after" in capsys.readouterr().out
    n_nodes = int(d["node_valid"].sum())
    n_edges = int(d["edge_valid"].sum())
    assert n_nodes >= 4
    classes = closure_lab.classify_edges(
        d["edge_i"][:n_edges], d["edge_j"][:n_edges],
        d["edge_info"][:n_edges])
    assert len(classes["odometry"]) == n_nodes - 1
    assert len(classes["prior"]) == n_nodes - 1
    policies = closure_lab.policies(d, 1.0)
    assert [row[0] for row in got] == [p[0] for p in policies]
    assert len(policies) == 39
    for (name, keep, robust, delta, priors, yaw_scale), (_, ate, hist) in zip(
            policies, got):
        nodes, ref = jax_solve(
            closure_lab.masked_graph(d, classes, keep, priors, yaw_scale),
            solver, iters, robust, delta)
        ref_ate = np.linalg.norm(nodes[:n_nodes, :2] - d["kf_truth"][:, :2],
                                 axis=1).mean()
        np.testing.assert_allclose(ate, ref_ate, rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(hist, ref, rtol=1e-4,
                                   atol=max(1e-6 * abs(ref[0]), CHI2_ZERO),
                                   err_msg=name)


def test_edge_classes_differ_from_the_jax_lab_on_the_first_prior():
    """A hand-made graph of four keyframes: odometry 0-1, 1-2, 2-3, yaw
    priors kf0 -> 1, 2, 3 and a closure 0 -> 3.  The JAX lab
    (``tools/closure_lab.py:83-106``) counts the kf0 -> node-1 prior as
    odometry; the port calls it a prior, and nothing else differs."""
    xy = np.diag([100.0, 100.0, 1e4]).astype(np.float32)
    yaw_only = np.diag([0.0, 0.0, 1e4]).astype(np.float32)
    edges = [(0, 1, xy), (0, 1, yaw_only), (1, 2, xy), (0, 2, yaw_only),
             (2, 3, xy), (0, 3, yaw_only), (0, 3, xy)]
    ei = np.array([e[0] for e in edges], np.int32)
    ej = np.array([e[1] for e in edges], np.int32)
    info = np.stack([e[2] for e in edges])
    mine = closure_lab.classify_edges(ei, ej, info)
    has_xy = info[:, 0, 0] > 0
    jax_lab = dict(odometry=np.nonzero((ej - ei) == 1)[0],
                   prior=np.nonzero(((ej - ei) != 1) & ~has_xy)[0],
                   closure=np.nonzero(((ej - ei) != 1) & has_xy)[0])
    np.testing.assert_array_equal(mine["odometry"], [0, 2, 4])
    np.testing.assert_array_equal(mine["prior"], [1, 3, 5])
    np.testing.assert_array_equal(mine["closure"], [6])
    np.testing.assert_array_equal(mine["closure"], jax_lab["closure"])
    assert set(jax_lab["odometry"]) - set(mine["odometry"]) == {1}
    assert set(mine["prior"]) - set(jax_lab["prior"]) == {1}
    assert not set(mine["odometry"]) - set(jax_lab["odometry"])
    # without priors the first prior goes too; a softer odometry yaw
    # leaves it as it is
    d = dict(nodes=np.zeros((4, 3), np.float32),
             node_valid=np.ones(4, bool), edge_i=ei, edge_j=ej,
             edge_z=np.zeros((7, 3), np.float32), edge_info=info,
             edge_valid=np.ones(7, bool))
    g = closure_lab.masked_graph(d, mine, np.ones(1, bool), priors=False,
                                 yaw_scale=0.1)
    np.testing.assert_array_equal(g["edge_valid"],
                                  [1, 0, 1, 0, 1, 0, 1])
    np.testing.assert_allclose(g["edge_info"][:, 2, 2],
                               [1e3, 1e4, 1e3, 1e4, 1e3, 1e4, 1e4])
