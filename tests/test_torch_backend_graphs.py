"""The backend's jitted seams as CUDA graphs, on the CPU through the
stand-in of ``tests/torch_stand_in.py``.

The JAX package jits ``PoseGraphBuilder.optimize``'s dense and PCG solves
and ``KeyframeManager``'s ``scan_align`` and ``merge_cloud``; the port
captures them (``utils.graphs.CallGraphs``).  Here each runs eagerly at
its first meeting, is "captured" at its second and "replayed" after, and
must equal the eager run bit for bit at every call:

* the dense, DCS-robust, PCG and Schur solves at dim 3 and 4 (the third
  call on another graph: the fields are static inputs, copied in);
* the builder's solve after ``add_node`` / ``add_edge`` replaced the
  graph's tensors between solves;
* ``scan_align`` in both sweep shapes, and the keyframe manager's grids
  and sweeps with and without the coarse stage (two keys of
  ``return_ratio`` and steps), closures and solves included;
* two ``OnlineSlam`` chunks that close a loop, and their solves.

Each is also held to the JAX package on the same inputs within
``tests/test_torch_pose_graph.py``'s and ``tests/test_torch_keyframes.
py``'s tolerances (nodes 1e-4, chi2 rtol 1e-4; scores 1e-5).
"""

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
from slam_eslam_tpu_torch.backend.keyframes import KeyframeManager as TKM
from slam_eslam_tpu_torch.filter import streaming as tst
from slam_eslam_tpu_torch.online import OnlineSlam
from slam_eslam_tpu_torch.utils import graphs
from test_torch_app_graphs import assert_same as assert_same_filter
from test_torch_eslam_filter import (CAMERA, INTRINSICS, LASER, config,
                                     stream_frames)
from test_torch_keyframes import (TRAJ_ATOL, JKM, assert_same_closures,
                                  clouds)
from test_torch_pose_graph import (as_dict, assert_same, circle_graph,
                                   outlier, port_graph, terrain)
from torch_stand_in import StandIn, assert_bitwise

torch.set_num_threads(2)

ITERS = 8
# solver: (the port's solve with cuda_graphs, the JAX package's)
SOLVES = {
    "dense": (lambda g, cg: tpg.optimize(g, ITERS, cuda_graphs=cg),
              lambda g: jpg.optimize(g, ITERS)),
    "dcs": (lambda g, cg: tpg.optimize(g, ITERS, robust="dcs",
                                       cuda_graphs=cg),
            lambda g: jpg.optimize(g, ITERS, robust="dcs")),
    "cg": (lambda g, cg: tpg.optimize_cg(g, ITERS, cg_iters=32,
                                         cuda_graphs=cg),
           lambda g: jpg.optimize_cg(g, ITERS, cg_iters=32)),
    "schur": (lambda g, cg: tpg.optimize_schur(
        g, ITERS, segments=4, boundary_cap=16, cuda_graphs=cg),
        lambda g: jpg.optimize_schur(g, ITERS, segments=4,
                                     boundary_cap=16)),
}


def call_graphs():
    return graphs.CallGraphs(StandIn(), "test")


@pytest.mark.parametrize("dim", [3, 4])
@pytest.mark.parametrize("solver", sorted(SOLVES))
def test_graphed_solve_equals_eager(solver, dim):
    solve, jsolve = SOLVES[solver]
    graphs_in = []
    for seed in (0, 0, 1):
        g, _ = circle_graph(dim, seed=seed)
        if solver == "dcs" and dim == 3:
            g = outlier(g)
        graphs_in.append(g)
    cg = call_graphs()
    for g in graphs_in:
        got = solve(port_graph(g), cg)
        assert_bitwise(got, solve(port_graph(g), None))
        jg, jh = jax.jit(jsolve)(g)
        assert_same(got[0], got[1], jg, jh)
    assert cg.counts() == dict(eager=1, captured=1, replayed=2)


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_graphed_builder_after_new_nodes_and_edges(solver):
    """A builder grown between solves (``add_node`` and ``add_edge`` replace
    the graph's tensors): the graphed solves read the new fields, bit for
    bit the eager builder's, within tolerance of the JAX builder's."""
    stand_in = StandIn()
    builders = [jpg.PoseGraphBuilder(16, 32),
                tpg.PoseGraphBuilder(16, 32, device="cpu"),
                tpg.PoseGraphBuilder(16, 32, device="cpu")]
    rng = np.random.default_rng(3)
    for step in range(4):
        pose = np.array([0.5 * step, 0.05 * rng.normal(), 0.02 * step])
        for b in builders:
            i = b.add_node(pose)
            if i:
                b.add_edge(i - 1, i, (0.5, 0.0, 0.02))
                b.add_edge(0, i, (0.5 * i, 0.0, 0.02 * i),
                           info=np.eye(3) * 10.0)
        hists = [builders[0].optimize(iters=5, solver=solver),
                 builders[1].optimize(iters=5, solver=solver, graph=False),
                 builders[2].optimize(iters=5, solver=solver,
                                      graph=stand_in)]
        assert_bitwise((builders[2].graph, hists[2]),
                       (builders[1].graph, hists[1]))
        assert_same(builders[2].graph, hists[2], builders[0].graph,
                    hists[0])
    cg, = builders[2].cuda_graphs.values()
    assert cg.counts() == dict(eager=1, captured=1, replayed=3)


@pytest.mark.parametrize("steps", [(9, 3, 1), (9, 7, 3)],
                         ids=["xy-yaw", "xy-yaw-z"])
def test_graphed_scan_align_equals_eager(steps):
    """``tests/test_torch_pose_graph.py``'s sweep from three guesses (the
    third another): the eager sweep bit for bit, JAX's within 1e-5."""
    steps_xy, steps_yaw, steps_z = steps
    jgrid = jsim.terrain_grid(terrain, nx=60, ny=60, resolution=0.1,
                              origin=(-3.0, -3.0))
    pts = jax.random.uniform(jax.random.PRNGKey(0), (96, 2), minval=-1.2,
                             maxval=1.2)
    world = pts + jnp.array([0.25, -0.125])
    z = jnp.asarray(terrain(np.asarray(world[:, 0]),
                            np.asarray(world[:, 1])), jnp.float32)
    jcloud = JCloud.create(xy=pts, z=z, stdev=jnp.full((96,), 0.05),
                           valid=jnp.ones((96,), bool))
    grid = convert.mls_grid_from(as_dict(jgrid))
    cloud = convert.patch_cloud_from(as_dict(jcloud))
    kw = dict(search_xy=0.5, steps_xy=steps_xy, search_yaw=0.1,
              steps_yaw=steps_yaw, search_z=0.1, steps_z=steps_z,
              return_ratio=True)
    cg = call_graphs()
    for guess in ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.1, 0.05, 0.02)):
        xy0 = torch.tensor(guess[:2])
        got = tpg.scan_align(grid, cloud, xy0, guess[2], 0.0,
                             cuda_graphs=cg, **kw)
        assert_bitwise(got, tpg.scan_align(grid, cloud, xy0, guess[2], 0.0,
                                           **kw))
        ref = jpg.scan_align(jgrid, jcloud, jnp.asarray(guess[:2]),
                             jnp.asarray(guess[2]), jnp.asarray(0.0), **kw)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                                   atol=1e-6)
        for a, b in zip(got[1:], ref[1:]):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-5,
                                       atol=1e-5)
    assert cg.counts() == dict(eager=1, captured=1, replayed=2)


@pytest.mark.parametrize("coarse", [None, (1.0, 5, 0.3)],
                         ids=["fine", "coarse-to-fine"])
def test_graphed_keyframes_equal_eager(coarse):
    """The drifted out-and-back route of ``tests/test_torch_keyframes.py``
    through three managers (JAX, the port eager, the port graphed): every
    keyframe grid, sweep, closure and solve of the graphed one bit for bit
    the eager one's, both within tolerance of JAX's."""
    kw = dict(keyframe_distance=0.45, closure_radius=1.0, min_separation=4,
              min_score=0.3, closure_info=2000.0, align_coarse=coarse)
    jkm = JKM(**kw)
    eager = TKM(**kw, device="cpu", graph=False)
    graphed = TKM(**kw, device="cpu", graph=StandIn())
    xs = list(np.arange(0, 3.1, 0.5)) + list(np.arange(2.5, -0.1, -0.5))
    drift = 0.0
    for i, x in enumerate(xs):
        true_pose = np.array([x, 0.0, 0.0, 0.2])
        rep = true_pose.copy()
        rep[1] += drift
        jc, tc = clouds(true_pose, 100 + i)
        added, cl = graphed.maybe_add_keyframe(rep[:3], tc, z=0.2)
        assert (added, cl) == eager.maybe_add_keyframe(rep[:3], tc, z=0.2)
        jkm.maybe_add_keyframe(rep[:3], jc, z=0.2)
        drift += 0.06 if added else 0.0
    assert graphed.closures
    assert_same_closures(jkm, graphed)
    assert_bitwise(graphed.builder.graph, eager.builder.graph)
    trajectories = []
    for _ in range(3):
        (t_g, h_g), (t_e, h_e) = (km.optimize(iters=15)
                                  for km in (graphed, eager))
        np.testing.assert_array_equal(t_g, t_e)
        assert_bitwise(h_g, h_e)
        trajectories.append(t_g)
    jt, _ = jkm.optimize(iters=15)
    n = len(graphed.keyframes)
    np.testing.assert_allclose(trajectories[0][:n], np.asarray(jt)[:n],
                               atol=TRAJ_ATOL)
    assert graphed.cuda_graphs.counts()["replayed"] > 0
    cg, = graphed.builder.cuda_graphs.values()
    assert cg.counts() == dict(eager=1, captured=1, replayed=2)


def test_online_slam_closing_chunks_graphed_equal_eager():
    """Two ``OnlineSlam`` chunks whose keyframes close a loop (every gate
    of the closure opened), each followed by the incremental solve:
    through ``run_stream``'s, the keyframe manager's and the builder's
    graphs, bit for bit the eager chunks and solves."""
    n = 16
    cfg = config(particle_count=n, map_pool_blocks=4 * n,
                 map_pool_color=True)
    frames = tst.stack_frames(stream_frames(20)[0])
    gen = torch.Generator().manual_seed(8)
    normals = (torch.randn((n, 2), generator=gen),
               torch.randn((n,), generator=gen))
    kf = dict(keyframe_distance=0.01, min_separation=0, closure_radius=50.0,
              min_score=0.0, min_ratio=0.0, grid_cells=24)
    slams = [OnlineSlam(config=cfg, laser2body=LASER, camera2body=CAMERA,
                        camera_intrinsics=INTRINSICS, keyframe_kw=kf,
                        device="cpu", graph=g).init(
        (np.array([0.0, 0.0, 0.3]), 0.0), normal_xy=normals[0],
        normal_yaw=normals[1]) for g in (False, StandIn())]
    for sl in (slice(0, 10), slice(10, 20)):
        auxes = [s.process_chunk(frames.at(sl)) for s in slams]
        assert_bitwise((auxes[0]["centroid"], auxes[0]["best_pose"]),
                       (auxes[1]["centroid"], auxes[1]["best_pose"]))
        assert_same_filter(slams[0].filter, slams[1].filter)
        (t0, h0), (t1, h1) = (s.optimize(iters=6) for s in slams)
        np.testing.assert_array_equal(t0, t1)
        assert_bitwise(h0, h1)
    closures = [s.keyframes.closures for s in slams]
    assert closures[0] == closures[1] and len(closures[1]) == 1
    assert slams[1].graphed and not slams[0].graphed
    assert slams[1].keyframes.cuda_graphs.counts()["eager"] > 0
