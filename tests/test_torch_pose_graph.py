"""The port's pose-graph backend against ``slam_eslam_tpu.backend.
pose_graph`` on the CPU.

Every case of ``tests/test_pose_graph.py`` that needs no device mesh runs
on both packages from the same graph (the JAX graph converted with
``convert.pose_graph_from``): the port's nodes must equal the JAX
package's within 1e-4 (m and rad; float32 Gauss-Newton, where XLA and
PyTorch round the einsums and the Cholesky differently), its chi2
history within rtol 1e-4 (atol 1e-4 where chi2 has converged to ~0), and
it must pass the JAX test's own assertions.  The mesh cases run on 8
ranks in ``tests/test_torch_parallel_pose_graph.py``; here one test holds
a one-rank mesh to the local solves.  ``scan_align`` must find the same best
offset, with score and peak ratio within 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_eslam_tpu.backend import pose_graph as jpg
from slam_eslam_tpu.mapping.mls_grid import PatchCloud as JCloud
from slam_eslam_tpu.models import sim as jsim
from slam_eslam_tpu_torch import convert
from slam_eslam_tpu_torch.backend import pose_graph as tpg

torch.set_num_threads(2)

NODE_ATOL = 1e-4
CHI2_RTOL, CHI2_ATOL = 1e-4, 1e-4


def as_dict(pytree):
    return jax.tree_util.tree_map(np.asarray, dataclasses.asdict(pytree))


def port_graph(g):
    return convert.pose_graph_from(as_dict(g), "cpu")


def pose_err(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    d[:, -1] = np.arctan2(np.sin(d[:, -1]), np.cos(d[:, -1]))
    return float(np.abs(d).max())


def assert_same(tg, thist, jg, jhist):
    assert pose_err(tg.nodes.numpy(), jg.nodes) < NODE_ATOL
    np.testing.assert_allclose(thist.numpy(), np.asarray(jhist),
                               rtol=CHI2_RTOL, atol=CHI2_ATOL)


def builders(max_nodes, max_edges):
    return (jpg.PoseGraphBuilder(max_nodes, max_edges),
            tpg.PoseGraphBuilder(max_nodes, max_edges, device="cpu"))


def both_builders(max_nodes, max_edges, nodes, edges, iters):
    """Build the same graph in both packages, optimise both; returns
    ``(port nodes, JAX nodes, port history, JAX history)``."""
    out = []
    for b in builders(max_nodes, max_edges):
        for p in nodes:
            b.add_node(p)
        for i, j, z, info in edges:
            b.add_edge(i, j, z, info=info)
        hist = b.optimize(iters=iters)
        out.append((b.graph.nodes, hist))
    (jn, jh), (tn, th) = out
    tn = tn.numpy()
    assert pose_err(tn, jn) < NODE_ATOL
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=CHI2_RTOL,
                               atol=CHI2_ATOL)
    return tn, th.numpy()


class TestGaussNewton:
    def test_chain_converges_to_odometry(self):
        truth = [(0, 0, 0), (1, 0, 0), (2, 0, 0), (3, 0, 0)]
        rng = np.random.default_rng(0)
        nodes = [np.asarray(t) + (0 if i == 0 else rng.normal(0, 0.2, 3))
                 for i, t in enumerate(truth)]
        edges = [(i, i + 1, (1.0, 0.0, 0.0), None) for i in range(3)]
        tn, hist = both_builders(8, 8, nodes, edges, 10)
        np.testing.assert_allclose(tn[:4], truth, atol=1e-3)
        assert hist[-1] < hist[0] + 1e-9

    def test_loop_closure_corrects_drift(self):
        n_side, drift = 4, 0.08
        poses, meas, cur = [np.zeros(3)], [], np.zeros(3)
        for k in range(n_side * 4):
            z = (1.0, 0.0, np.pi / 2 if (k % n_side) == n_side - 1 else 0.0)
            meas.append(z)
            zd = (z[0] + drift, z[1], z[2] + drift * 0.2)
            c, s = np.cos(cur[2]), np.sin(cur[2])
            cur = np.array([cur[0] + c * zd[0] - s * zd[1],
                            cur[1] + s * zd[0] + c * zd[1], cur[2] + zd[2]])
            poses.append(cur.copy())
        edges = [(k, k + 1, z, None) for k, z in enumerate(meas)]
        edges.append((len(poses) - 1, 0, (0.0, 0.0, 0.0), np.eye(3) * 1000.0))
        assert np.linalg.norm(poses[-1][:2]) > 0.3
        tn, _ = both_builders(32, 32, poses, edges, 15)
        assert np.linalg.norm(tn[len(poses) - 1][:2]) < 0.05
        assert abs(tn[n_side][0] - n_side) < 0.5

    def test_invalid_edges_ignored(self):
        tn, _ = both_builders(4, 4, [(0, 0, 0), (2.0, 0, 0)],
                              [(0, 1, (1.0, 0, 0), None)], 5)
        np.testing.assert_allclose(tn[1], [1.0, 0, 0], atol=1e-3)


def circle_graph(dim, m=16, seed=0):
    """``tests/test_pose_graph.py``'s noisy circle with odometry and three
    closure edges, as a JAX graph, and its ground truth."""
    rng = np.random.default_rng(seed)
    g = jpg.PoseGraph.empty(m, max(64, m + 8), dim=dim)
    th = np.linspace(0, 2 * np.pi, m, endpoint=False)
    cols = [np.cos(th), np.sin(th)]
    if dim == 4:
        cols.append(0.1 * np.sin(2 * th))
    cols.append(th + np.pi / 2)
    gt = np.stack(cols, -1)
    n0 = gt + rng.normal(0, 0.1, gt.shape)
    n0[0] = gt[0]

    def rel(a, b):
        c, s = np.cos(a[-1]), np.sin(a[-1])
        d = b[:2] - a[:2]
        out = [c * d[0] + s * d[1], -s * d[0] + c * d[1]]
        if dim == 4:
            out.append(b[2] - a[2])
        out.append(np.arctan2(np.sin(b[-1] - a[-1]), np.cos(b[-1] - a[-1])))
        return np.array(out)

    pairs = [(k, k + 1) for k in range(m - 1)]
    pairs += [(0, m - 1), (2, m - 2), (1, m // 2)]
    ne = len(pairs)
    g = dataclasses.replace(
        g, nodes=jnp.asarray(n0, jnp.float32),
        node_valid=jnp.ones((m,), bool),
        edge_i=g.edge_i.at[:ne].set(np.array([p[0] for p in pairs])),
        edge_j=g.edge_j.at[:ne].set(np.array([p[1] for p in pairs])),
        edge_z=g.edge_z.at[:ne].set(jnp.asarray(
            np.stack([rel(gt[a], gt[b]) for a, b in pairs]), jnp.float32)),
        edge_info=g.edge_info.at[:ne].set(jnp.eye(dim) * 100.0),
        edge_valid=g.edge_valid.at[:ne].set(True))
    return g, np.asarray(gt, np.float32)


def outlier(g):
    """A high-information closure claiming node 8 sits at node 0 +
    (5, 5)."""
    e = 16 + 3
    return dataclasses.replace(
        g, edge_i=g.edge_i.at[e].set(0), edge_j=g.edge_j.at[e].set(8),
        edge_z=g.edge_z.at[e].set(jnp.array([5.0, 5.0, 0.0])),
        edge_info=g.edge_info.at[e].set(jnp.eye(3) * 100.0),
        edge_valid=g.edge_valid.at[e].set(True))


class TestSolverVariants:
    @pytest.mark.parametrize("dim", [3, 4])
    def test_dense_and_cg_converge(self, dim):
        g, gt = circle_graph(dim)
        tg = port_graph(g)
        jd, jh = jax.jit(lambda g: jpg.optimize(g, 15))(g)
        td, th = tpg.optimize(tg, 15)
        assert_same(td, th, jd, jh)
        assert pose_err(td.nodes, gt) < 1e-3 and float(th[-1]) < 1e-6
        jc, jch = jax.jit(lambda g: jpg.optimize_cg(g, 15, cg_iters=64))(g)
        tc, tch = tpg.optimize_cg(tg, 15, cg_iters=64)
        assert_same(tc, tch, jc, jch)
        assert pose_err(tc.nodes, gt) < 1e-3
        assert pose_err(tc.nodes, td.nodes) < 1e-3

    @pytest.mark.parametrize("dim", [3, 4])
    def test_schur_matches_dense(self, dim):
        g, gt = circle_graph(dim)
        tg = port_graph(g)
        js, jh = jax.jit(lambda g: jpg.optimize_schur(
            g, 15, segments=4, boundary_cap=16))(g)
        ts, th = tpg.optimize_schur(tg, 15, segments=4, boundary_cap=16)
        assert_same(ts, th, js, jh)
        td, _ = tpg.optimize(tg, 15)
        assert pose_err(ts.nodes, gt) < 1e-3
        assert pose_err(ts.nodes, td.nodes) < 1e-3
        assert float(th[-1]) < 1e-5

    def test_schur_1k_nodes_matches_dense(self):
        """1,024 nodes, 8 segments: the port's Schur solve against the JAX
        package's and against the port's dense solve."""
        g, gt = circle_graph(3, m=1024, seed=2)
        tg = port_graph(g)
        js, jh = jax.jit(lambda g: jpg.optimize_schur(
            g, 10, segments=8, boundary_cap=32))(g)
        ts, th = tpg.optimize_schur(tg, 10, segments=8, boundary_cap=32)
        assert_same(ts, th, js, jh)
        td, _ = tpg.optimize(tg, 10)
        assert pose_err(ts.nodes, gt) < 5e-3
        assert pose_err(ts.nodes, td.nodes) < 1e-3

    @pytest.mark.parametrize("kind", ["huber", "dcs"])
    def test_robust_kernel_rejects_outlier_closure(self, kind):
        g, gt = circle_graph(3)
        g = outlier(g)
        tg = port_graph(g)
        naive, _ = tpg.optimize(tg, 15)
        err_naive = pose_err(naive.nodes, gt)
        assert err_naive > 0.5
        tol = 0.05 if kind == "dcs" else err_naive * 0.6
        jr, jh = jax.jit(lambda g: jpg.optimize(
            g, 20, robust=kind, robust_delta=1.0))(g)
        tr, th = tpg.optimize(tg, 20, robust=kind, robust_delta=1.0)
        assert_same(tr, th, jr, jh)
        assert pose_err(tr.nodes, gt) < tol
        jr2, jh2 = jax.jit(lambda g: jpg.optimize_cg(
            g, 20, cg_iters=64, robust=kind, robust_delta=1.0))(g)
        tr2, th2 = tpg.optimize_cg(tg, 20, cg_iters=64, robust=kind,
                                   robust_delta=1.0)
        assert_same(tr2, th2, jr2, jh2)
        assert pose_err(tr2.nodes, gt) < tol
        np.testing.assert_allclose(
            tpg.robust_edge_weights(tg, kind).numpy(),
            np.asarray(jpg.robust_edge_weights(g, kind)), rtol=1e-5)

    def test_fix_mask_freezes_prefix(self):
        g, _ = circle_graph(3)
        tg = port_graph(g)
        fm = np.arange(16) < 8
        jf, jh = jax.jit(lambda g: jpg.optimize(
            g, 10, fix_mask=jnp.asarray(fm)))(g)
        tf, th = tpg.optimize(tg, 10, fix_mask=torch.from_numpy(fm))
        assert_same(tf, th, jf, jh)
        assert pose_err(tf.nodes[:8], tg.nodes[:8]) < 1e-6
        assert not np.allclose(tf.nodes[8:].numpy(), tg.nodes[8:].numpy())

    def test_mesh_raises(self):
        """Nothing raises for a mesh any more: on a one-rank mesh the
        edge-sharded PCG and the segment-sharded Schur solve (and the
        PoseGraphBuilder's PCG) equal the local solves bit for bit; OnlineSlam
        takes the mesh.  Meshes of 8 ranks: tests/test_torch_parallel_
        pose_graph.py."""
        from slam_eslam_tpu_torch.online import OnlineSlam
        from slam_eslam_tpu_torch.parallel.sharding import Mesh

        g, _ = circle_graph(3)
        tg = port_graph(g)
        mesh = Mesh(group=None, size=1, rank=0, device=torch.device("cpu"),
                    backend="gloo", transport="gloo")
        pairs = [(lambda m: tpg.optimize_cg(tg, 2, mesh=m)[0].nodes),
                 (lambda m: tpg.gauss_newton_step_cg(tg, mesh=m)[0].nodes),
                 (lambda m: tpg.optimize_schur(tg, 2, segments=4,
                                               boundary_cap=16,
                                               mesh=m)[0].nodes),
                 (lambda m: tpg.gauss_newton_step_schur(tg, mesh=m)[0].nodes)]
        for call in pairs:
            assert torch.equal(call(mesh), call(None))
        b = tpg.PoseGraphBuilder(device="cpu")
        b.graph = tg
        assert torch.isfinite(b.optimize(iters=1, solver="cg",
                                         mesh=mesh)).all()
        assert OnlineSlam(mesh=mesh, device="cpu").mesh is mesh

    def test_edge_residuals_and_schur_structure(self):
        g, _ = circle_graph(4)
        tg = port_graph(g)
        for got, ref in zip(tpg.edge_residuals(tg), jpg.edge_residuals(g)):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=1e-6, atol=1e-6)
        got = tpg._schur_structure(tg, 4, 16)
        ref = jpg._schur_structure(g, 4, 16)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def terrain(x, y):
    return 0.3 * np.sin(0.8 * np.asarray(x)) + 0.2 * np.cos(
        0.6 * np.asarray(y))


@pytest.mark.parametrize("steps", [(9, 3, 1), (9, 7, 3)],
                         ids=["xy-yaw", "xy-yaw-z"])
def test_scan_align_recovers_offset(steps):
    """``tests/test_pose_graph.py``'s offset recovery (and a sweep with a
    z axis): the same best offset, score and peak ratio within 1e-5."""
    steps_xy, steps_yaw, steps_z = steps
    jgrid = jsim.terrain_grid(terrain, nx=80, ny=80, resolution=0.1,
                              origin=(-4.0, -4.0))
    pts = jax.random.uniform(jax.random.PRNGKey(0), (128, 2), minval=-1.5,
                             maxval=1.5)
    true_dx = jnp.array([0.25, -0.125])
    world = pts + true_dx
    z = jnp.asarray(terrain(np.asarray(world[:, 0]), np.asarray(world[:, 1])),
                    jnp.float32)
    jcloud = JCloud.create(xy=pts, z=z, stdev=jnp.full((128,), 0.05),
                           valid=jnp.ones((128,), bool))
    kw = dict(search_xy=0.5, steps_xy=steps_xy, search_yaw=0.1,
              steps_yaw=steps_yaw, search_z=0.1, steps_z=steps_z,
              return_ratio=True)
    ref = jpg.scan_align(jgrid, jcloud, jnp.zeros(2), jnp.asarray(0.0),
                         jnp.asarray(0.0), **kw)
    got = tpg.scan_align(convert.mls_grid_from(as_dict(jgrid)),
                         convert.patch_cloud_from(as_dict(jcloud)),
                         torch.zeros(2), 0.0, 0.0, **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-6)
    np.testing.assert_allclose(float(got[1]), float(ref[1]), atol=1e-6)
    for a, b in zip(got[2:], ref[2:]):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(true_dx),
                               atol=0.13)
    assert float(got[2]) > 0.5 and float(got[3]) >= 1.0


def test_scan_align_batches_give_the_same_scores(monkeypatch):
    """Batches of sweep poses capped to a few lookups give the values of
    one batch."""
    jgrid = jsim.terrain_grid(terrain, nx=40, ny=40, resolution=0.1,
                              origin=(-2.0, -2.0))
    grid = convert.mls_grid_from(as_dict(jgrid))
    rng = np.random.default_rng(5)
    cloud = convert.patch_cloud_from(as_dict(JCloud.create(
        xy=jnp.asarray(rng.uniform(-1, 1, (50, 2)), jnp.float32),
        z=jnp.asarray(rng.normal(0, 0.2, 50), jnp.float32),
        stdev=jnp.full((50,), 0.05), valid=jnp.asarray(rng.random(50) < 0.8))))
    kw = dict(steps_xy=5, steps_yaw=3, return_ratio=True)
    one = tpg.scan_align(grid, cloud, torch.zeros(2), 0.1, 0.0, **kw)
    monkeypatch.setattr(tpg, "ALIGN_LOOKUPS", 7 * cloud.p)
    many = tpg.scan_align(grid, cloud, torch.zeros(2), 0.1, 0.0, **kw)
    for a, b in zip(one, many):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("dim", [3, 4])
def test_sim_circle_graph_is_the_tests_graph(dim):
    """``models.sim.circle_pose_graph`` (the JAX-free graph of the card's
    checks) is ``tests/test_pose_graph.py``'s circle, outlier included."""
    from slam_eslam_tpu_torch.models import sim as tsim

    g, gt = circle_graph(dim)
    if dim == 3:
        g = outlier(g)
    got, tgt = tsim.circle_pose_graph(dim, outlier=dim == 3, device="cpu")
    np.testing.assert_array_equal(tgt, gt)
    for name, val in as_dict(g).items():
        np.testing.assert_array_equal(getattr(got, name).numpy(), val,
                                      err_msg=name)
