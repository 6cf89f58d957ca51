"""The port's mesh on 8 gloo ranks against the JAX single-device oracle.

Mirrors ``tests/test_parallel.py`` case for case: the distributed
resample (``TestDistributedResample``), the ring-hop resample in every
weight-imbalance regime, the stratified scheme and inside a full step
(``TestPpermuteResample``), and the sharded filter step
(``TestShardedFilterStep``).  JAX runs them on 8 virtual devices; the
port runs every case once on one world of 8 CPU ranks
(``parallel.distributed.run_world``, started once for the module; the
rank side is ``tests/torch_mesh_cases.py``), fed the inputs and the JAX
random draws built here.

Tolerances: resample indices and moved payloads exact; ESS rtol 1e-5
(1e-4 for the uniform reset), as the JAX tests; the sharded step's
weights rtol 2e-4 / atol 1e-6 and positions rtol 2e-4 / atol 1e-5
against the JAX step (the JAX test's between its sharded and replicated
steps), and equal bit for bit to the port's single-process step; the
lookup's hits exact and means rtol 1e-6 against the JAX window kernel.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as g
from slam_eslam_tpu.core import filter as jpf
from slam_eslam_tpu.filter import step as jstep
from slam_eslam_tpu.models import sim as jsim
from slam_eslam_tpu_torch import convert
from slam_eslam_tpu_torch.parallel.distributed import run_world
import torch_mesh_cases
from torch_jax_draws import (as_dict, port_config, project_draws,
                             resample_draws)

RANKS = 8
N = 64

CASES = {
    "random": lambda: jax.random.uniform(jax.random.PRNGKey(1), (64,)) + 0.01,
    "collapse_high": lambda: jnp.concatenate(
        [jnp.full((56,), 1e-6), jnp.ones((8,))]),
    "collapse_low": lambda: jnp.concatenate(
        [jnp.ones((8,)), jnp.full((56,), 1e-6)]),
    "degenerate": lambda: jnp.zeros((64,)),
}


def _terrain_window(x, y):
    return 0.25 * np.sin(1.3 * np.asarray(x))


def _inputs():
    """Every case's inputs and its JAX oracle."""
    inp, ref = {}, {}
    u5 = np.asarray(jax.random.uniform(jax.random.PRNGKey(5), ()))
    w = jax.random.uniform(jax.random.PRNGKey(1), (64,)) + 0.01
    wn, ess = jpf.normalize_weights(w)
    inp.update(shard_map_w=np.asarray(w), shard_map_u=u5)
    ref["shard_map"] = (np.asarray(jpf.resample_systematic(
        jax.random.PRNGKey(5), wn, 64)), float(ess))
    w2 = jax.random.uniform(jax.random.PRNGKey(2), (64,)) + 0.01
    wn2, _ = jpf.normalize_weights(w2)
    inp.update(sharded_w=np.asarray(w2), sharded_u=np.asarray(
        jax.random.uniform(jax.random.PRNGKey(7), ())))
    ref["sharded"] = np.asarray(jpf.resample_systematic(
        jax.random.PRNGKey(7), wn2, 64))
    inp["ppermute_w"], inp["ppermute_u"] = {}, u5
    for name, make in CASES.items():
        wc = make()
        wnc, essc = jpf.normalize_weights(wc)
        inp["ppermute_w"][name] = np.asarray(wc, np.float32)
        ref[f"ppermute_{name}"] = (np.asarray(jpf.resample_systematic(
            jax.random.PRNGKey(5), wnc, 64)), float(essc))
    inp["stratified_w"] = np.asarray(w)
    inp["stratified_u"] = np.asarray(jax.random.uniform(
        jax.random.PRNGKey(5), (64,), jnp.float32))
    ref["stratified"] = np.asarray(jpf.resample_stratified(
        jax.random.PRNGKey(5), wn, 64))

    # the flagship step (__graft_entry__._build at 64 particles on 32x32)
    cfg, lookup, state, cs, q = g._build(N, nx=32, ny=32)
    gate = (np.float32(1.0), np.float32(0.0))
    jout, jaux = jstep.make_filter_step(cfg, lookup)(state, cs, q, gate)
    key, proj = project_draws(state.key, N)
    _, u = resample_draws(key, N)
    from slam_eslam_tpu_torch.filter.step import StepDraws

    # _build's grid (its terrain is local to it)
    grid = jsim.terrain_grid(
        lambda x, y: 0.25 * np.sin(1.3 * np.asarray(x)) + 0.2 * np.cos(
            0.9 * np.asarray(y)), nx=32, ny=32, resolution=0.2,
        origin=(-3.2, -3.2))
    wgrid = jsim.terrain_grid(_terrain_window, nx=64, ny=64, resolution=0.1,
                              origin=(-3.2, -3.2))
    pts = jnp.concatenate([
        jax.random.uniform(jax.random.PRNGKey(0), (64, 4, 2), minval=-0.8,
                           maxval=0.8),
        jnp.zeros((64, 4, 1))], axis=-1)
    from slam_eslam_tpu.ops import pallas_gather as pg

    ref["lookup"] = pg.windowed_grid_lookup(
        wgrid, window=32, interpret=True, mxu_dtype=jnp.float32)(None, pts)
    inp.update(
        cfg=port_config(cfg),
        state=convert.pose_estimator_state_from(as_dict(state)),
        contact=convert.body_contact_state_from(as_dict(cs)),
        q=torch.from_numpy(np.array(q)), draws=StepDraws(proj, u),
        grid=convert.mls_grid_from(as_dict(grid)),
        window_grid=convert.mls_grid_from(as_dict(wgrid)),
        points=np.asarray(pts, np.float32))
    ref["step"] = (np.asarray(jout.particles.weight),
                   np.asarray(jout.particles.xy), float(jaux["ess"]))
    # the discount's inputs: 0-4 contacts a particle; seed 115 is a draw
    # where the CPU's pow over 8 values and over all 64 differ, in the
    # factors' powers and in the weights' roots alike
    rng = np.random.default_rng(115)
    inp["discount"] = (rng.random(N) < 0.8,
                       rng.uniform(0.05, 1.0, N).astype(np.float32),
                       rng.integers(0, 5, N).astype(np.int32))
    return inp, ref


@pytest.fixture(scope="module")
def world():
    inp, ref = _inputs()
    ranks = run_world(torch_mesh_cases.parallel_cases, RANKS,
                      args=(inp,), device="cpu", timeout=600)
    return ranks, ref


class TestDistributedResample:
    def test_matches_single_device(self, world):
        ranks, ref = world
        idx, ess = ranks[0]["resample"]["shard_map"]
        np.testing.assert_array_equal(idx, ref["shard_map"][0])
        np.testing.assert_allclose(ess, ref["shard_map"][1], rtol=1e-5)

    def test_jit_path_matches(self, world):
        ranks, ref = world
        np.testing.assert_array_equal(ranks[0]["resample"]["sharded"][0],
                                      ref["sharded"])

    def test_degenerate_weights_uniform_reset(self, world):
        ranks, _ = world
        idx, ess = ranks[0]["resample"]["degenerate"]
        np.testing.assert_allclose(ess, 64.0, rtol=1e-4)
        assert sorted(idx.tolist()) == list(range(64))


class TestPpermuteResample:
    @pytest.mark.parametrize("case", sorted(CASES))
    def test_matches_single_device(self, world, case):
        ranks, ref = world
        for r in ranks:    # every rank gathers the same global result
            idxg, map_id, xy, ess = r["resample"][f"ppermute_{case}"]
            np.testing.assert_array_equal(idxg, ref[f"ppermute_{case}"][0])
            np.testing.assert_array_equal(map_id, idxg)
            np.testing.assert_allclose(xy[:, 0], idxg)
            np.testing.assert_allclose(ess, ref[f"ppermute_{case}"][1],
                                       rtol=1e-5)

    def test_stratified_scheme_matches_reference_statistics(self, world):
        ranks, ref = world
        idxg, moved = ranks[0]["resample"]["stratified"]
        np.testing.assert_array_equal(idxg, ref["stratified"])
        np.testing.assert_array_equal(moved, idxg)

    def test_full_step_with_ppermute_resampler(self, world):
        ranks, _ = world
        st = ranks[0]["step"]["ppermute_step"]
        np.testing.assert_allclose(*st["weight"])
        np.testing.assert_allclose(*st["xy"])


class TestShardedFilterStep:
    def test_windowed_lookup_shard_map(self, world):
        ranks, ref = world
        found, mean = ranks[0]["step"]["lookup"]
        np.testing.assert_array_equal(found, np.asarray(ref["lookup"][0]))
        np.testing.assert_allclose(mean, np.asarray(ref["lookup"][1]),
                                   rtol=1e-6)

    def test_full_step_on_mesh(self, world):
        ranks, _ = world
        for r in ranks:
            f = r["dryrun_filter"]
            assert f["weight_err"] == 0.0 and f["xy_err"] == 0.0, f
            assert np.isfinite(f["ess"])
        assert "8 rank(s), backend gloo, transport gloo" in ranks[0][
            "describe"]

    def test_sharded_matches_replicated(self, world):
        ranks, ref = world
        got = ranks[0]["step"]["meshed"]
        np.testing.assert_allclose(got["weight"], ref["step"][0],
                                   rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(got["xy"], ref["step"][1],
                                   rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(got["ess"], ref["step"][2], rtol=1e-5)

    def test_discount_on_mesh_matches_single_process(self, world):
        """The measurement update's discount on 8 ranks of 8 particles
        equals the single process's over 64, bit for bit: factors,
        contact total and maximum weight."""
        ranks, _ = world
        for r in ranks:
            meshed, single = r["discount"]
            for a, b in zip(meshed, single):
                np.testing.assert_array_equal(a, b)


def test_placements_and_identities():
    """The descriptors and identities of ``parallel.sharding`` (the JAX
    ``particle_sharding``, ``replicated``, ``constrain_*``), and a
    one-rank mesh's shard and gather, which are copies."""
    from slam_eslam_tpu_torch.filter import pose_estimator as tpe
    from slam_eslam_tpu_torch.mapping import map_pool as tmp
    from slam_eslam_tpu_torch.mapping.mls_grid import MLSGrid
    from slam_eslam_tpu_torch.parallel import sharding as shd

    mesh = shd.Mesh(group=None, size=1, rank=0, device=torch.device("cpu"),
                    backend="gloo", transport="gloo")
    assert shd.particle_sharding(mesh).axis == "dp"
    assert shd.replicated(mesh).axis is None
    state = tpe.PoseEstimatorState.create(port_config(g._build(8)[0]), 4,
                                          device="cpu")
    assert shd.constrain_particles(state.particles, mesh) is state.particles
    pool = tmp.MapPool.from_template(MLSGrid.create(4, 4, 0.5, (0.0, 0.0)),
                                     8, 16, 2, with_color=False)
    assert shd.constrain_pool(pool, mesh) is pool
    back = shd.gather_pool(shd.shard_pool(pool, mesh))
    assert back.mesh is None and torch.equal(back.mean, pool.mean)
    assert torch.equal(back.chain, pool.chain)
    got = shd.gather_state(shd.shard_state(state, mesh), mesh).particles
    assert torch.equal(got.x, state.particles.x)
    with pytest.raises(ValueError, match="divide"):
        shd.shard_pool(pool, dataclasses.replace(mesh, size=3))
