"""The port's surface hash against the JAX package's: the plane fit, the
``create`` sweep over a 40 x 40 grid, the footprint signature and its
relevance, candidate sampling and reinjection with the JAX integer
draws injected, and the ``lost_threshold`` health gate.

Candidates, validity, buckets and sort order must be equal, ``z`` within
rtol 1e-6; the plane fit (a closed-form solve against JAX's LU) within
rtol 1e-4.  The expected reinjection count is computed in float32, as
the port and the JAX package truncate it, and asserted on a fixture
whose signature is distinctive.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_eslam_tpu.config import Config, SurfaceHashConfig
from slam_eslam_tpu.filter import pose_estimator as jpe
from slam_eslam_tpu.filter import surface_hash as jsh
from slam_eslam_tpu.models import sim as jsim
from slam_eslam_tpu.utils import geometry as jgeom
from slam_eslam_tpu_torch import convert
from slam_eslam_tpu_torch.filter import surface_hash as tsh
from torch_jax_draws import as_dict, randint_draws, t

torch.set_num_threads(2)

HCFG = SurfaceHashConfig(use_hash=True, slope_bins=10, angular_steps=4)
N = 48


def bumpy_terrain(x, y):
    x, y = np.asarray(x), np.asarray(y)
    return 0.3 * x + 0.25 * np.sin(1.7 * y) + 0.1 * np.cos(2.3 * x + y)


@pytest.fixture(scope="module")
def hashes():
    jgrid = jsim.terrain_grid(bumpy_terrain, nx=40, ny=40, resolution=0.25,
                              origin=(-5.0, -5.0))
    jh = jsh.SurfaceHash.create(HCFG, jgrid)
    th = tsh.SurfaceHash.create(HCFG, convert.mls_grid_from(as_dict(jgrid)))
    return jh, th


def test_fit_plane():
    rng = np.random.default_rng(0)
    pts = rng.normal(0.0, 0.5, (64, 6, 3)).astype(np.float32)
    mask = rng.random((64, 6)) < 0.8
    mask[:, :3] = True
    ref = jsh.fit_plane(jnp.asarray(pts), jnp.asarray(mask))
    got = tsh.fit_plane(t(pts), t(mask))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)
    # an exact plane z = 0.5 x - 0.25 y + 1
    sx, sy = tsh.fit_plane(torch.tensor([[0, 0, 1.0], [1, 0, 1.5],
                                         [0, 1, 0.75], [1, 1, 1.25]]),
                           torch.ones(4, dtype=torch.bool))
    assert abs(float(sx) - 0.5) < 1e-4 and abs(float(sy) + 0.25) < 1e-4


def test_create(hashes):
    jh, th = hashes
    ref = as_dict(jh)
    got = convert.to_numpy(th)
    assert got["cand_xy"].shape == (40 * 40 * 4, 2)
    for name in ("cand_xy", "cand_yaw", "cand_valid", "sorted_idx",
                 "bucket_start", "bucket_count", "n_valid"):
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    # bucket flips of a slope at a bin edge between the closed-form
    # solve and JAX's LU: none on this grid
    flips = int((got["bucket_id"] != ref["bucket_id"]).sum())
    assert flips == 0
    np.testing.assert_allclose(got["cand_z"], ref["cand_z"], rtol=1e-6)
    assert int(got["bucket_count"].sum()) == int(got["n_valid"]) > 0
    # a JAX hash carried into the port is the port's own
    conv = convert.to_numpy(convert.surface_hash_from(ref, HCFG))
    for name, val in got.items():
        if name != "config":
            np.testing.assert_array_equal(conv[name], ref[name])


def contact_states():
    """Conformal contact states at three poses over the bumpy terrain."""
    out = []
    for pos, yaw in (((0.0, 0.0), 0.0), ((1.2, -0.7), 0.6),
                     ((-2.0, 1.5), 2.4)):
        z = bumpy_terrain(*pos) + 0.2
        cs = jsim.conformal_contact_state(np.array([*pos, z]), yaw,
                                          bumpy_terrain)
        q = np.asarray(jgeom.quat_from_yaw(jnp.asarray(yaw, jnp.float32)))
        out.append((cs, q))
    return out


@pytest.mark.parametrize("which", [0, 1, 2])
def test_signature_and_relevance(hashes, which):
    jh, th = hashes
    cs, q = contact_states()[which]
    sig_j = jh.signature(cs, jnp.asarray(q))
    sig_t = th.signature(convert.body_contact_state_from(as_dict(cs)), t(q))
    for a, b in zip(sig_t, sig_j):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(th.relevance(*sig_t)),
                               float(jh.relevance(*sig_j)), rtol=1e-6)


def test_sample_particles(hashes):
    jh, th = hashes
    key = jax.random.PRNGKey(3)
    ref = jh.sample_particles(key, N)
    got = th.sample_particles(N, u=randint_draws(key, N, jh.n_valid))
    for name, val in as_dict(ref).items():
        np.testing.assert_array_equal(getattr(got, name).numpy(), val,
                                      err_msg=name)
    # drawn on the device from a generator: valid candidates
    drawn = th.sample_particles(4096, generator=torch.Generator().manual_seed(0))
    m = int(th.n_valid)
    assert np.isin(drawn.x.numpy(), th.cand_xy[th.sorted_idx[:m].long(), 0])\
        .all()


@pytest.mark.parametrize("slopes", [(0.3, 0.0), (-0.95, 0.95)],
                         ids=["common", "empty"])
def test_sample_bucket(hashes, slopes):
    jh, th = hashes
    key = jax.random.PRNGKey(5)
    sx, sy = (np.float32(s) for s in slopes)
    ids_j, ok_j = jh.sample_bucket(key, jnp.asarray(sx), jnp.asarray(sy), N)
    b = th.bucket(t(sx), t(sy))
    u = randint_draws(key, N, jh.bucket_count[int(b)])
    ids_t, ok_t = th.sample_bucket(t(sx), t(sy), N, u=u)
    assert bool(ok_t) == bool(ok_j) == (slopes == (0.3, 0.0))
    if bool(ok_j):
        np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
        assert th.cand_valid[ids_t].all()


def reinject_world(hcfg):
    """The bumpy grid hashed at 16 headings into 20 x 20 buckets, a
    contact state whose signature falls into a small bucket, 16
    particles with increasing weights and the JAX state.  (On a planar
    terrain many slopes sit exactly on a bucket edge, where the closed
    form and JAX's LU round to different sides.)"""
    grid = jsim.terrain_grid(bumpy_terrain, nx=40, ny=40, resolution=0.25,
                             origin=(-5.0, -5.0))
    jh = jsh.SurfaceHash.create(hcfg, grid)
    cfg = Config(particle_count=16)
    state = jpe.PoseEstimatorState.create(cfg, 20, key=jax.random.PRNGKey(2))
    particles = jpe.init_gaussian(jax.random.PRNGKey(3), 16, (0, 0), 0.0,
                                  (0.1, 0.1), 0.05, 0, 0.1)
    particles = dataclasses.replace(particles,
                                    weight=jnp.linspace(0.01, 1.0, 16))
    state = dataclasses.replace(state, particles=particles)
    cs = jsim.conformal_contact_state(np.array([1.0, 1.0, 0.2]), 0.7,
                                      bumpy_terrain)
    th = tsh.SurfaceHash.create(hcfg, convert.mls_grid_from(as_dict(grid)))
    return jh, th, cfg, state, cs


def reinject_both(jh, th, cfg, jstate, cs):
    q = jgeom.quat_identity()
    ref = jh.reinject(jstate, cs, q, cfg)
    _, k_s = jax.random.split(jstate.key)
    sx, sy = jh.signature(cs, q)
    b = jsh._bucket_index(sx, jh.config.slope_bins) * jh.config.slope_bins \
        + jsh._bucket_index(sy, jh.config.slope_bins)
    u = randint_draws(k_s, 16, jh.bucket_count[b])
    got = th.reinject(convert.pose_estimator_state_from(as_dict(jstate)),
                      convert.body_contact_state_from(as_dict(cs)),
                      t(np.asarray(q)), cfg, u=u)
    for name, val in as_dict(ref.particles).items():
        np.testing.assert_allclose(getattr(got.particles, name).numpy(), val,
                                   rtol=1e-6, err_msg=name)
    rel = np.float32(float(th.relevance(*th.signature(
        convert.body_contact_state_from(as_dict(cs)),
        t(np.asarray(q)))))) ** 3
    return got, rel


def test_reinject_replaces_lowest_weight():
    hcfg = SurfaceHashConfig(use_hash=True, percentage=0.5)
    jh, th, cfg, jstate, cs = reinject_world(hcfg)
    got, rel = reinject_both(jh, th, cfg, jstate, cs)
    assert rel >= 0.8                # the fixture's signature is rare
    expect = int(np.float32(16 * 0.5) * rel)     # truncated in float32
    w0 = np.asarray(jstate.particles.weight)
    w = got.particles.weight.numpy()
    assert (w != w0).sum() == expect > 0
    # the lowest-weight particles were the ones replaced
    assert (w[:expect] != w0[:expect]).all()
    assert got.particles.floating.numpy()[:expect].all()


def test_lost_threshold_gate():
    """A tracking filter (max weight above the threshold) injects
    nothing; a lost one (max weight 0) the full count."""
    hcfg = SurfaceHashConfig(use_hash=True, percentage=0.5,
                             lost_threshold=0.2)
    jh, th, cfg, jstate, cs = reinject_world(hcfg)
    healthy = dataclasses.replace(jstate, max_weight=jnp.asarray(0.9))
    got, _ = reinject_both(jh, th, cfg, healthy, cs)
    np.testing.assert_array_equal(got.particles.weight.numpy(),
                                  np.asarray(jstate.particles.weight))
    lost = dataclasses.replace(jstate, max_weight=jnp.zeros(()))
    got, rel = reinject_both(jh, th, cfg, lost, cs)
    assert rel >= 0.8
    changed = (got.particles.weight.numpy()
               != np.asarray(jstate.particles.weight)).sum()
    assert changed == int(np.float32(16 * 0.5) * rel) > 0
