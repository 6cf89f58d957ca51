"""The port's meshed pose-graph solvers on 8 gloo ranks against JAX.

Mirrors ``tests/test_pose_graph.py``'s mesh cases:
``test_sharded_cg_matches_local`` (dim 3 and 4: the PCG with its edges
split over the ranks) and ``test_schur_sharded_matches_local`` (a 256-node
circle, 8 segments over 8 ranks).  The graphs are the JAX tests' (built by
``tests/test_torch_pose_graph.py::circle_graph`` and converted); the
meshed solves run on one world of 8 CPU ranks (``tests/torch_mesh_cases.
py``).  Tolerances are the JAX tests': the meshed solve within 1e-3 (PCG)
or 2e-3 (Schur) of the truth and within 1e-5 of the port's local solve;
and within 1e-4 (m, rad) of the JAX package's local solve, the port's
tolerance against JAX (``tests/test_torch_pose_graph.py``).
"""

import jax
import numpy as np
import pytest

from slam_eslam_tpu.backend import pose_graph as jpg
from slam_eslam_tpu_torch.parallel.distributed import run_world
import torch_mesh_cases
from test_torch_pose_graph import NODE_ATOL, circle_graph, pose_err, port_graph


@pytest.fixture(scope="module")
def world():
    inp, ref = {}, {}
    for dim in (3, 4):
        g, gt = circle_graph(dim)
        inp[f"cg_{dim}"] = port_graph(g)
        jc, _ = jax.jit(lambda g: jpg.optimize_cg(g, 15, cg_iters=64))(g)
        ref[f"cg_{dim}"] = (gt, np.asarray(jc.nodes))
    g, gt = circle_graph(3, m=256, seed=3)
    inp["schur"] = port_graph(g)
    jl, _ = jax.jit(lambda g: jpg.optimize_schur(
        g, 12, segments=8, boundary_cap=32))(g)
    ref["schur"] = (gt, np.asarray(jl.nodes))
    ranks = run_world(torch_mesh_cases.pose_graph_cases, 8, args=(inp,),
                      device="cpu", timeout=600)
    return ranks, ref


@pytest.mark.parametrize("dim", [3, 4])
def test_sharded_cg_matches_local(world, dim):
    ranks, ref = world
    gt, jlocal = ref[f"cg_{dim}"]
    for r in ranks:     # every rank ends with the same nodes
        meshed, local = r[f"cg_{dim}"]
        assert pose_err(meshed, gt) < 1e-3
        assert pose_err(meshed, local) < 1e-5
        assert pose_err(meshed, jlocal) < NODE_ATOL


def test_schur_sharded_matches_local(world):
    ranks, ref = world
    gt, jlocal = ref["schur"]
    for r in ranks:
        meshed, local = r["schur"]
        assert pose_err(meshed, gt) < 2e-3
        assert pose_err(meshed, local) < 1e-5
        assert pose_err(meshed, jlocal) < NODE_ATOL
