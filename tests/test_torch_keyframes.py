"""The port's keyframe manager against ``slam_eslam_tpu.backend.
keyframes`` on the CPU.

Every case of ``tests/test_keyframes.py`` drives both packages' managers
with the same poses and clouds: keyframe counts equal, closures with the
same index pairs and scores within 1e-5, optimised trajectories within
1e-4 (m, rad), and the JAX test's own assertions on the port's result.
The port's closure edges carry the yaw wrapped in float32, as the JAX
package's do.  Also: ``prune_closures`` and ``convert.keyframe_from``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_eslam_tpu.backend.keyframes import KeyframeManager as JKM
from slam_eslam_tpu.mapping.mls_grid import PatchCloud as JCloud
from slam_eslam_tpu_torch import convert
from slam_eslam_tpu_torch.backend.keyframes import KeyframeManager as TKM
from slam_eslam_tpu_torch.mapping.mls_grid import PatchCloud as TCloud

torch.set_num_threads(2)

SCORE_ATOL = 1e-5
TRAJ_ATOL = 1e-4


def terrain(x, y):
    return 0.3 * np.sin(0.9 * np.asarray(x)) + 0.25 * np.cos(
        0.7 * np.asarray(y))


def cloud_arrays(pose, n=400, key=0):
    """Terrain samples around the true pose, in the body frame."""
    rng = np.random.default_rng(key)
    local = rng.uniform(-1.5, 1.5, (n, 2)).astype(np.float32)
    c, s = np.cos(pose[2]), np.sin(pose[2])
    world = np.stack([c * local[:, 0] - s * local[:, 1] + pose[0],
                      s * local[:, 0] + c * local[:, 1] + pose[1]], axis=1)
    z = terrain(world[:, 0], world[:, 1]).astype(np.float32)
    return local, z - np.float32(pose[3])


def clouds(pose, key):
    local, z = cloud_arrays(pose, key=key)
    n = local.shape[0]
    j = JCloud.create(xy=jnp.asarray(local), z=jnp.asarray(z),
                      stdev=jnp.full((n,), 0.05), valid=jnp.ones((n,), bool))
    t = TCloud.create(xy=torch.from_numpy(local), z=torch.from_numpy(z),
                      stdev=torch.full((n,), 0.05),
                      valid=torch.ones((n,), dtype=torch.bool))
    return j, t


def both(**kw):
    return JKM(**kw), TKM(**kw, device="cpu")


def add_both(kms, rep, true_pose, key):
    jc, tc = clouds(true_pose, key)
    (ja, jcl), (ta, tcl) = (
        km.maybe_add_keyframe(rep[:3], c, z=true_pose[3])
        for km, c in zip(kms, (jc, tc)))
    assert ja == ta
    assert (jcl is None) == (tcl is None)
    if jcl is not None:
        assert jcl[:2] == tcl[:2]
        assert abs(jcl[2] - tcl[2]) < SCORE_ATOL
    return ta, tcl


def assert_same_closures(jkm, tkm):
    assert len(jkm.keyframes) == len(tkm.keyframes)
    assert [c[:2] for c in jkm.closures] == [c[:2] for c in tkm.closures]
    np.testing.assert_allclose([c[2] for c in tkm.closures],
                               [c[2] for c in jkm.closures], atol=SCORE_ATOL)
    for jd, td in zip(jkm.closure_details, tkm.closure_details):
        np.testing.assert_allclose(td["corrected"], jd["corrected"],
                                   atol=1e-6)
        assert abs(td["ratio"] - jd["ratio"]) < SCORE_ATOL
        assert td["edge"] == jd["edge"]
    n_e = jkm.builder.n_edges
    assert tkm.builder.n_edges == n_e
    jg, tg = jkm.builder.graph, tkm.builder.graph
    np.testing.assert_allclose(tg.edge_z[:n_e].numpy(),
                               np.asarray(jg.edge_z[:n_e]), atol=1e-6)
    np.testing.assert_allclose(tg.edge_info[:n_e].numpy(),
                               np.asarray(jg.edge_info[:n_e]), rtol=1e-5)


def test_distance_gating():
    kms = both(keyframe_distance=0.5)
    for x, want in ((0.0, True), (0.2, False), (0.6, True)):
        added, _ = add_both(kms, np.array([x, 0.0, 0.0, 0.2]),
                            np.array([x, 0.0, 0.0, 0.2]), 0)
        assert added == want
    assert len(kms[1].keyframes) == 2


def test_loop_closure_on_revisit():
    kms = both(keyframe_distance=0.45, closure_radius=0.8, min_separation=3,
               min_score=0.3)
    xs = list(np.arange(0, 2.6, 0.5)) + list(np.arange(2.0, -0.1, -0.5))
    closures = []
    for i, x in enumerate(xs):
        pose = np.array([x, 0.0, 0.0, 0.2])
        _, cl = add_both(kms, pose, pose, i)
        if cl:
            closures.append(cl)
    assert closures, "revisit should produce a loop closure"
    assert_same_closures(*kms)


def drifted(kms, yaw_prior=False):
    """Out and back with the reported poses drifting in y."""
    xs = list(np.arange(0, 3.1, 0.5)) + list(np.arange(2.5, -0.1, -0.5))
    drift, reported = 0.0, []
    for i, x in enumerate(xs):
        true_pose = np.array([x, 0.0, 0.0, 0.2])
        rep = true_pose.copy()
        rep[1] += drift
        jc, tc = clouds(true_pose, 100 + i)
        yaw = dict(abs_yaw=0.01 * i) if yaw_prior else {}
        added = [km.maybe_add_keyframe(rep[:3], c, z=true_pose[3], **yaw)[0]
                 for km, c in zip(kms, (jc, tc))]
        assert added[0] == added[1]
        if added[1]:
            drift += 0.06
            reported.append(rep)
    assert_same_closures(*kms)
    return reported


def drifted_managers(**kw):
    return both(keyframe_distance=0.45, closure_radius=1.0, min_separation=4,
                min_score=0.3, closure_info=2000.0, **kw)


def assert_same_trajectory(jt, tt, n):
    np.testing.assert_allclose(tt[:n], np.asarray(jt)[:n], atol=TRAJ_ATOL)


@pytest.mark.parametrize("yaw_prior", [False, True],
                         ids=["plain", "yaw-prior"])
def test_closure_corrects_drifted_trajectory(yaw_prior):
    kms = drifted_managers(yaw_prior_info=(50.0 if yaw_prior else 0.0))
    reported = drifted(kms, yaw_prior)
    assert kms[1].closures
    (jt, jh), (tt, th) = (km.optimize(iters=15) for km in kms)
    assert_same_trajectory(jt, tt, len(reported))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4)
    before, after = reported[-1][1], tt[len(reported) - 1][1]
    assert abs(after) < abs(before) * 0.6


def test_incremental_optimize_matches_full():
    full = drifted_managers()
    drifted(full)
    jfull, tfull = (km.optimize(iters=15)[0] for km in full)
    inc = drifted_managers()
    drifted(inc)
    for km in inc:
        km.optimize(iters=15)
        assert km._optimized_edges == km.builder.n_edges
    (ja, jh), (ta, th) = (km.optimize(iters=15, incremental=True)
                          for km in inc)
    assert th.shape == (0,) and jh.shape == (0,)
    n = len(inc[1].keyframes)
    assert_same_trajectory(ja, ta, n)
    np.testing.assert_allclose(ta[:n], tfull[:n], atol=5e-3)


def test_incremental_after_new_edges():
    """New constraints after an optimize: the incremental solve freezes
    the untouched prefix in both packages alike."""
    kms = drifted_managers()
    xs = list(np.arange(0, 3.1, 0.5)) + list(np.arange(2.5, 0.9, -0.5))
    for km in kms:
        km.optimize(iters=5)
    for i, x in enumerate(xs):
        pose = np.array([x, 0.06 * i, 0.0, 0.2])
        add_both(kms, pose, np.array([x, 0.0, 0.0, 0.2]), 200 + i)
        if i == 7:
            for km in kms:
                km.optimize(iters=5, incremental=True)
    (jt, jh), (tt, th) = (km.optimize(iters=8, incremental=True,
                                      robust="dcs") for km in kms)
    assert th.shape == (8,)
    assert_same_trajectory(jt, tt, len(kms[1].keyframes))


def test_cg_solver_path():
    kms = drifted_managers()
    drifted(kms)
    dense = kms[1].optimize(iters=15)[0]
    kms2 = drifted_managers()
    drifted(kms2)
    (jc, _), (tc, _) = (km.optimize(iters=15, solver="cg", cg_iters=64)
                        for km in kms2)
    n = len(kms[1].keyframes)
    assert_same_trajectory(jc, tc, n)
    np.testing.assert_allclose(tc[:n], dense[:n], atol=1e-3)


def test_prune_closures_and_keyframe_from():
    kms = drifted_managers()
    drifted(kms)
    for km in kms:
        for d in km.closure_details[:1]:
            d["corrected"] = d["corrected"] + np.array([3.0, 0.0, 0.0])
    pruned = [km.prune_closures(consist=0.5) for km in kms]
    assert pruned[0] == pruned[1] >= 1
    np.testing.assert_array_equal(
        kms[1].builder.graph.edge_valid.numpy(),
        np.asarray(kms[0].builder.graph.edge_valid))
    jkf = kms[0].keyframes[3]
    tkf = convert.keyframe_from(dict(
        index=jkf.index, node_id=jkf.node_id, pose=jkf.pose, z=jkf.z,
        cloud=jax.tree_util.tree_map(np.asarray,
                                     dataclasses.asdict(jkf.cloud))))
    mine = kms[1].keyframes[3]
    assert (tkf.index, tkf.node_id, tkf.z) == (mine.index, mine.node_id,
                                               mine.z)
    np.testing.assert_array_equal(tkf.pose, mine.pose)
    np.testing.assert_array_equal(tkf.cloud.xy.numpy(), mine.cloud.xy.numpy())
