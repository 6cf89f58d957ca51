"""Meshed streaming SLAM on 8 gloo ranks against the JAX single-device run.

Mirrors ``tests/test_streaming.py``'s three mesh cases
(``test_sharded_matches_single_device``,
``test_sharded_pool_colocated_matches_single_device``,
``test_sharded_pool_pallas_merge_matches_xla``), and adds a fourth whose
particles migrate between ranks (every measurement resamples, small
grids roll over), so that heads come from other ranks' blocks and chain
tails are looked up remotely: 64 particles over four
Asguard steps (40 frames, a 32-ray scan on every frame), the JAX package
on one device (its draws rebuilt from its keys and fed to the port), the
port on a world of 8 CPU ranks (``tests/torch_mesh_cases.py``), once with
the pool held whole on every rank (``map_pool_shards = 1``) and twice with
the pool split by block range (``map_pool_shards = 8``, the second
without colour).  Rank 0 also runs the port in one process, which the
meshed runs must equal bit for bit (chains, patches, weights, centroids);
that single-process run with ``map_pool_shards = 8`` is the one-device
case against JAX.

Tolerances against JAX are the JAX tests' (its sharded against its
single-device run): chains and valid bits exact; weights rtol 2e-4 /
atol 1e-7; pool means rtol 1e-4 / atol 1e-5; centroids atol 1e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_eslam_tpu.config import Config, ContactModelConfig
from slam_eslam_tpu.filter import streaming as jst
from slam_eslam_tpu.filter.eslam_filter import EmbodiedSlamFilter as JFilter
from slam_eslam_tpu.mapping import map_pool as jmp
from slam_eslam_tpu.mapping.mls_grid import MLSGrid
from slam_eslam_tpu.models.asguard import AsguardSim as JSim
from slam_eslam_tpu_torch import convert
from slam_eslam_tpu_torch.filter import streaming as tst
from slam_eslam_tpu_torch.mapping import map_pool as tmp
from slam_eslam_tpu_torch.parallel.distributed import run_world
import torch_mesh_cases
from torch_jax_draws import as_dict, port_config, slam_draws

RANKS = 8
N = 64
N_RAYS = 32
SCAN_META = (np.float32(-np.pi / 2), np.float32(np.pi / N_RAYS))


def terrain(x, y):
    return 0.15 * np.sin(0.7 * np.asarray(x)) + 0.12 * np.cos(
        0.5 * np.asarray(y))


def _cfg(**kw):
    base = dict(particle_count=N, min_effective=N // 2, grid_size=10.0,
                grid_resolution=0.25, map_pool_blocks=N + 16,
                map_chain_length=3,
                contact_model=ContactModelConfig(contact_point_radius=0.0,
                                                 min_contacts=2))
    return dataclasses.replace(Config(), **{**base, **kw})


# name: (config, pool split by block range, wheel turn per step)
CONFIGS = {
    "replicated": (_cfg(), False, 0.3),
    "colocated": (_cfg(map_pool_shards=8), True, 0.3),
    "merge": (_cfg(map_pool_shards=8, map_pool_color=False), True, 0.3),
    "migrate": (_cfg(map_pool_shards=8, min_effective=float(N),
                     grid_size=2.0, map_pool_blocks=4 * N), True, 1.0),
    # the scan-match weighting on every mapping frame
    "visual": (_cfg(use_visual_update=True), False, 0.3),
    "visual_colocated": (_cfg(map_pool_shards=8, use_visual_update=True),
                         True, 0.3),
}


def _frames(wheel_delta):
    sim = JSim(terrain=terrain)
    q = np.array([1.0, 0, 0, 0], np.float32)
    out = []

    def cb(s):
        out.append((s.contact_state(), q,
                    np.asarray(s.position, np.float32)))

    for _ in range(4):
        sim.step(wheel_delta=wheel_delta, on_substep=cb)
    return out


def _case(cfg, frames):
    """The JAX single-device run and the port's inputs for ``cfg``."""
    f = JFilter(config=cfg)
    f.init(pose=(np.array([0.0, 0.0, JSim(terrain=terrain).position[2]]),
                 0.0), use_shared_map=False)
    ranges = np.full((N_RAYS,), 2.0, np.float32)
    jframes = jst.stack_frames([
        (cs, jnp.asarray(q), jnp.asarray(pos), jnp.asarray(ranges),
         tuple(jnp.asarray(v) for v in SCAN_META), jnp.asarray(True))
        for cs, q, pos in frames])
    carry0 = jst.StreamingState.create(f.state, f.pool)
    jcfg = (dataclasses.replace(cfg, merge_kernel="xla")
            if not cfg.map_pool_color else cfg)
    jc, ja = jst.make_slam_scan_runner(jcfg)(carry0, jframes)
    tframes = tst.stack_frames([
        (convert.body_contact_state_from(as_dict(cs)), q, pos, ranges,
         SCAN_META, True) for cs, q, pos in frames])
    port = {"cfg": port_config(cfg), "frames": tframes,
            "carry": convert.streaming_state_from(as_dict(carry0)),
            "draws": slam_draws(carry0.filter.key, N,
                                np.asarray(ja["updated"]))}
    ref = {"weight": np.asarray(jc.filter.particles.weight),
           "chain": np.asarray(jc.pool.chain),
           "mean": np.asarray(jc.pool.mean, np.float32),
           "valid": np.asarray(jc.pool.valid),
           "centroid": np.asarray(ja["centroid"]),
           "updated": int(np.asarray(ja["updated"]).sum())}
    return port, ref


@pytest.fixture(scope="module")
def world():
    inp, refs = {}, {}
    for name, (cfg, colocated, wheel) in CONFIGS.items():
        port, refs[name] = _case(cfg, _frames(wheel))
        inp[name] = dict(port, colocated=colocated)
    ranks = run_world(torch_mesh_cases.slam_cases, RANKS, args=(inp,),
                      device="cpu", timeout=900)
    return ranks, refs


def assert_against_jax(got, ref):
    np.testing.assert_array_equal(got["chain"], ref["chain"])
    np.testing.assert_allclose(got["weight"], ref["weight"], rtol=2e-4,
                               atol=1e-7)
    np.testing.assert_allclose(got["mean"], ref["mean"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got["centroid"], ref["centroid"], atol=1e-5)


def assert_bitwise(got, single):
    for key in ("chain", "mean", "meta", "weight", "centroid"):
        np.testing.assert_array_equal(got[key], single[key], err_msg=key)
    assert got["alloc_failed"] == single["alloc_failed"]


def test_sharded_matches_single_device(world):
    """Particles and chain rows split over the ranks, blocks whole on every
    rank: the JAX single-device run, and the port's one-process run bit
    for bit."""
    ranks, refs = world
    out = ranks[0]["replicated"]
    assert_against_jax(out["meshed"], refs["replicated"])
    assert_bitwise(out["meshed"], out["single"])
    assert out["meshed"]["updated"] == refs["replicated"]["updated"] > 0
    # the whole pool on every rank
    assert out["meshed"]["rows"] == N + 16


def test_sharded_pool_colocated_matches_single_device(world):
    """The pool split by block range (``map_pool_shards`` = 8 ranks):
    chains equal JAX's, each rank holds B/8 blocks, every particle's head
    lies in its own rank's range, and the run equals the port's
    one-process run with ``map_pool_shards = 8`` bit for bit; blocks came
    from other ranks (resampling migrates particles)."""
    ranks, refs = world
    out = ranks[0]["colocated"]
    assert_against_jax(out["meshed"], refs["colocated"])
    assert_bitwise(out["meshed"], out["single"])
    b = N + 16
    assert {r["colocated"]["meshed"]["rows"] for r in ranks} == {b // 8}
    chain = out["meshed"]["chain"]
    np.testing.assert_array_equal(np.arange(N) // (N // 8),
                                  chain[:, 0] // (b // 8))
    assert all("block copy" in r["colocated"]["remote"] for r in ranks)


def test_sharded_pool_migration_matches_single_device(world):
    """A split pool where every measurement resamples (``min_effective =
    N``) and 2 m grids roll over on a longer drive: particles migrate
    between ranks, so heads
    are re-homed from other ranks' blocks and chain tails are looked up on
    the ranks that hold them.  Against JAX and bit for bit the one-process
    port."""
    ranks, refs = world
    out = ranks[0]["migrate"]
    assert_against_jax(out["meshed"], refs["migrate"])
    assert_bitwise(out["meshed"], out["single"])
    remote = lambda what: sum(r["migrate"]["remote"].get(what, 0)
                              for r in ranks)
    assert remote("block copy") > 0 and remote("chain lookup") > 0


def test_sharded_pool_pallas_merge_matches_xla(world):
    """The merge K3 run shard-locally on a colourless split pool against
    the JAX single-device XLA merge: chains and valid bits exact, means
    within the JAX test's tolerance; bit for bit the one-process port."""
    ranks, refs = world
    out = ranks[0]["merge"]
    got, ref = out["meshed"], refs["merge"]
    np.testing.assert_array_equal(got["chain"], ref["chain"])
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    np.testing.assert_allclose(got["mean"], ref["mean"], rtol=1e-4,
                               atol=1e-5)
    assert_bitwise(got, out["single"])


def test_map_pool_shards_8_on_one_device_matches_jax(world):
    """``map_pool_shards = 8`` in one process (no mesh): range-local
    allocation and re-homing as the JAX package's, same chains."""
    ranks, refs = world
    for name in ("colocated", "merge"):
        single = ranks[0][name]["single"]
        assert_against_jax(single, refs[name])


@pytest.mark.parametrize("name", ["visual", "visual_colocated"])
def test_sharded_visual_update_matches_single_device(world, name):
    """The scan-match weighting (``use_visual_update``) with the pool whole
    on every rank and split by block range: the JAX single-device run, and
    the port's one-process run bit for bit (the weighting's pow is taken
    over every particle, then sliced)."""
    ranks, refs = world
    out = ranks[0][name]
    assert_against_jax(out["meshed"], refs[name])
    assert_bitwise(out["meshed"], out["single"])
    assert out["meshed"]["mapped"] > 0


@pytest.mark.parametrize("shards", [1, 4, 8])
def test_allocate_by_range_matches_jax(shards):
    """``_allocate`` and ``ensure_unique_active`` with block ranges against
    the JAX package's on a pool with shared and foreign heads."""
    rng = np.random.default_rng(shards)
    n, b, length = 32, 64, 3
    chain = rng.integers(-1, b, (n, length)).astype(np.int32)
    chain[:, 0] = rng.integers(0, b, n)
    want = rng.random(n) < 0.6
    jpool = jmp.MapPool.from_template(
        MLSGrid.create(4, 4, 0.5, (0, 0), 4), n, b, length,
        with_color=False, shards=shards)
    jpool = dataclasses.replace(jpool, chain=jnp.asarray(chain))
    tpool = convert.map_pool_from(as_dict(jpool))
    jnew, jfail = jmp._allocate(jpool, jnp.asarray(want), shards=shards)
    tnew, tfail = tmp._allocate(tpool, torch.from_numpy(want), shards)
    np.testing.assert_array_equal(tnew.numpy(), np.asarray(jnew))
    assert int(tfail) == int(jfail)
    jout, jf = jmp.ensure_unique_active(jpool, shards=shards)
    tout, tf = tmp.ensure_unique_active(tpool, shards=shards)
    np.testing.assert_array_equal(tout.chain.numpy(), np.asarray(jout.chain))
    np.testing.assert_array_equal(tout.meta.numpy(), np.asarray(jout.meta))
    assert int(tf) == int(jf)
