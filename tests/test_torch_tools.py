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
"""

import argparse
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from slam_eslam_tpu_torch.examples import (localize_demo,
                                           loop_closure_demo, slam_demo)
from slam_eslam_tpu_torch.ops import block_merge as bm
from slam_eslam_tpu_torch.tools import probe_merge_overhead as probe
from slam_eslam_tpu_torch.tools import stat_map_test
from slam_eslam_tpu_torch.utils import kernel_eff

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
TINY = ["--cpu", "--particles", "16", "--rays", "8", "--nx", "8", "--ny",
        "8", "--k", "4", "--iters", "2"]


def jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    path = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
    return mod


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
