"""The port's pool-type A/B (``slam_eslam_tpu_torch.tools.ab_pool_dtype``)
against the JAX script on the CPU, on two drives of two steps (20 frames)
at 8 particles.

The JAX script's ``run_dtype`` runs with its streaming runner watched, so
that its inputs and centroids can be read; the port's ``run_dtype`` is fed
the JAX draws (the start normals of ``PRNGKey(3000 + r)`` and every
frame's ``project`` and resampling draws) through its ``draws`` seam.  The
frames, odometry states and ground-truth track equal the JAX script's
within 1e-6 m, the centroids follow it within 1e-3 m, and the JSON line
has its keys.  The JAX script's ground truth is the drive's last position
on every frame (it appends the simulator's one position array, which moves
in place); the port takes every frame's position, so the stats are held
against the JAX centroids and frame positions, and the JAX script's own
stats against the last position.
"""

import argparse
import json

import jax
import numpy as np
import pytest
import torch

from slam_eslam_tpu_torch.tools import ab_pool_dtype

from torch_jax_draws import gaussian_normals, jax_tool, slam_draws

torch.set_num_threads(2)

ARGS = argparse.Namespace(runs=2, steps=2, particles=8, contact_cap=8,
                          contact_noise=0.005, seed_env=True, cpu=True)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX script's float32 drives: per run its carry, frames,
    odometry states and aux, and its stats."""
    import jax.numpy as jnp

    from slam_eslam_tpu.filter import streaming

    jtool = jax_tool("ab_pool_dtype")
    seen, make = [], streaming.make_slam_scan_runner

    def watched(*a, **kw):
        run = make(*a, **kw)

        def spy(carry0, frames, odos):
            carry, aux = run(carry0, frames, odos)
            seen.append(dict(carry0=carry0, frames=frames, odos=odos,
                             aux=aux))
            return carry, aux

        return spy

    streaming.make_slam_scan_runner = watched
    try:
        stats = jtool.run_dtype("float32", ARGS, jax, jnp)
    finally:
        streaming.make_slam_scan_runner = make
    return seen, stats


def stats_of(cents, truth):
    """The script's stats of centroid tracks against ground truths."""
    ates, zerrs = [], []
    for c, gt in zip(cents, truth):
        tail = slice(len(gt) * 2 // 3, None)
        ates.append(np.mean(np.linalg.norm(c[tail, :2] - gt[tail, :2],
                                           axis=1)))
        zerrs.append(c[tail, 2] - gt[tail, 2])
    zerr = np.concatenate(zerrs)
    return dict(ate_mean=np.mean(ates), ate_std=np.std(ates),
                z_err_mean=np.mean(zerr), z_err_std=np.std(zerr))


def test_ab_pool_dtype_follows_the_jax_script(jax_runs):
    seen, ref_stats = jax_runs
    n = ARGS.particles
    draws = []
    for r, run in enumerate(seen):
        _, k_init = jax.random.split(jax.random.PRNGKey(3000 + r))
        draws.append((gaussian_normals(k_init, n), slam_draws(
            run["carry0"].filter.key, n, np.asarray(run["aux"]["updated"]))))
    detail = []
    stats = ab_pool_dtype.run_dtype("float32", ARGS, torch.device("cpu"),
                                    draws=draws, detail=detail)
    assert len(detail) == len(seen) == ARGS.runs
    for got, ref in zip(detail, seen):
        cs, q, pos, ranges, _, has_scan = ref["frames"]
        fr = got["frames"]
        np.testing.assert_allclose(fr.contact.position.numpy(),
                                   np.asarray(cs.position), atol=1e-6)
        np.testing.assert_array_equal(fr.contact.valid.numpy(),
                                      np.asarray(cs.valid))
        np.testing.assert_array_equal(fr.q.numpy(), np.asarray(q))
        np.testing.assert_allclose(fr.body_pos.numpy(), np.asarray(pos),
                                   atol=1e-6)
        np.testing.assert_array_equal(fr.has_scan.numpy(),
                                      np.asarray(has_scan))
        # the ground truth is every frame's body position, in float64
        np.testing.assert_allclose(got["truth"], np.asarray(pos), atol=1e-6)
        assert np.linalg.norm(got["truth"][0] - got["truth"][-1]) > 0.05
        for name in ("delta_xy", "delta_yaw", "delta_z", "sigma_xy",
                     "prev_points", "initialized"):
            np.testing.assert_allclose(
                getattr(got["odos"], name).numpy(),
                np.asarray(getattr(ref["odos"], name)), atol=1e-6,
                err_msg=name)
        np.testing.assert_array_equal(got["updated"],
                                      np.asarray(ref["aux"]["updated"]))
        np.testing.assert_allclose(got["centroids"],
                                   np.asarray(ref["aux"]["centroid"]),
                                   atol=1e-3)
    truth = [np.asarray(run["frames"][2], np.float64) for run in seen]
    cents = [np.asarray(run["aux"]["centroid"], np.float64) for run in seen]
    for key, val in stats_of(cents, truth).items():
        assert stats[key] == pytest.approx(val, abs=1e-3), key
    # the JAX script's stats: against the last position on every frame
    last = [np.broadcast_to(t[-1], t.shape) for t in truth]
    for key, val in stats_of(cents, last).items():
        assert ref_stats[key] == pytest.approx(val, abs=1e-6), key
    assert abs(stats["ate_mean"] - ref_stats["ate_mean"]) > 1e-3


def test_ab_pool_dtype_json_has_the_jax_scripts_keys(capsys):
    res = ab_pool_dtype.main(["--cpu", "--runs", "1", "--steps", "1",
                              "--particles", "8", "--no-seed-env"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == res
    assert set(res) == {"float32", "bfloat16", "delta", "config",
                        "graphed"}
    assert res["graphed"] is False       # the CPU runs the eager loop
    stats = {"ate_mean", "ate_std", "z_err_mean", "z_err_std"}
    assert set(res["float32"]) == set(res["bfloat16"]) == stats | {"wall_s"}
    assert set(res["delta"]) == {"ate_mean", "z_err_mean", "z_err_std"}
    assert res["config"] == {"runs": 1, "steps": 1, "particles": 8}
    assert all(np.isfinite(v) for d in ("float32", "bfloat16")
               for v in res[d].values())
    # the JAX script's flags, with --cpu where it has --tpu
    flags = ab_pool_dtype.parser().format_help()
    for flag in ("--runs", "--steps", "--particles", "--contact-cap",
                 "--contact-noise", "--no-seed-env", "--cpu"):
        assert flag in flags
