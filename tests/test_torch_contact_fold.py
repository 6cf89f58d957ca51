"""The port's contact fold (kernel K1's plain version on the CPU) against
the JAX package: its XLA twin ``contact_fold_sums`` on the exact gather,
the Pallas kernel ``window_select_contact`` in interpret mode, and the
port's own unfolded log-space path.

Tolerances: rows d1, d2, sq and pose_var agree to float32 rounding
(rtol 1e-5, plus 1e-6 of the row's largest magnitude for sums that
cancel); n_contacts exactly.  Against the unfolded path the bound is the
fold's Mills-ratio approximation (2e-3 rtol on the weight).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_eslam_tpu.config import Config, ContactModelConfig
from slam_eslam_tpu.core.state import BodyContactState as JContactState
from slam_eslam_tpu.mapping import mls_grid as jgrid
from slam_eslam_tpu.ops import pallas_gather as pg
from slam_eslam_tpu_torch import convert
from slam_eslam_tpu_torch.core.state import BodyContactState
from slam_eslam_tpu_torch.filter import pose_estimator as pe
from slam_eslam_tpu_torch.mapping import mls_grid
from slam_eslam_tpu_torch.mapping.lookup import make_lookup
from slam_eslam_tpu_torch.models import contact_model as cm
from slam_eslam_tpu_torch.ops import contact_fold as cf

torch.set_num_threads(2)

NX = NY = 64
RES = 0.1
ORIGIN = (-3.2, -3.2)
CORRECTION = 0.33
GROUPS = np.array([0, 0, 1, 1, -1, 2, 2, -1], np.int32)
ACTIVE = np.array([1, 1, 1, 0, 1, 1, 1, 1], np.float32)


def terrain(x, y):
    return 0.3 * np.sin(np.asarray(x)) + 0.2 * np.cos(0.7 * np.asarray(y))


def as_dict(pytree):
    return jax.tree_util.tree_map(np.asarray, dataclasses.asdict(pytree))


@pytest.fixture(scope="module")
def jax_grid():
    """A 64x64 grid with 4 slots per cell, some empty, the first near
    the terrain and the others up to 2.5 m away."""
    rng = np.random.default_rng(0)
    g = jgrid.MLSGrid.create(NX, NY, RES, ORIGIN, 4)
    cx = (np.arange(NX) + 0.5) * RES + ORIGIN[0]
    cy = (np.arange(NY) + 0.5) * RES + ORIGIN[1]
    base = terrain(cx[:, None], cy[None, :])
    mean = base[..., None] + np.concatenate(
        [np.zeros((NX, NY, 1)), rng.uniform(-2.5, 2.5, (NX, NY, 3))], -1)
    return dataclasses.replace(
        g,
        mean=jnp.asarray(mean, jnp.float32),
        stdev=jnp.asarray(rng.uniform(0.01, 0.1, (NX, NY, 4)), jnp.float32),
        valid=jnp.asarray(rng.random((NX, NY, 4)) > 0.3),
    )


def queries(n, spread, seed):
    """[8, N] world queries around a particle cloud; ``spread`` puts
    some particles outside the grid.  5% of heights are far off."""
    rng = np.random.default_rng(seed)
    pxy = rng.uniform(-spread, spread, (n, 2))
    offs = rng.uniform(-0.4, 0.4, (8, 2))
    qx = (offs[:, 0:1] + pxy[None, :, 0]).astype(np.float32)
    qy = (offs[:, 1:2] + pxy[None, :, 1]).astype(np.float32)
    qz = terrain(qx, qy) + rng.normal(0.0, 0.05, (8, n))
    far = rng.random((8, n)) < 0.05
    qz = np.where(far, qz + rng.uniform(-4, 4, (8, n)), qz).astype(np.float32)
    mv = rng.uniform(0.01, 0.2, (1, n)).astype(np.float32)
    return qx, qy, qz, mv


def onehot_np():
    seg, s = JContactState.create(np.zeros((8, 3)),
                                  group_id=GROUPS).segments()
    return (np.asarray(seg)[:, None] == np.arange(s)[None, :]).astype(
        np.float32)


def port_fold(jax_grid, qx, qy, qz, mv):
    packed = mls_grid.PackedLookup.from_grid(
        convert.mls_grid_from(as_dict(jax_grid)))
    t = torch.from_numpy
    return cf.contact_fold(
        packed, (t(qx), t(qy), t(qz)), t(ACTIVE[:, None].copy()), t(mv),
        onehot=t(onehot_np()), correction=CORRECTION, z_window=3.0,
    ).numpy()


def assert_rows_close(got, ref):
    assert got.shape == ref.shape
    for r in range(4):
        atol = 1e-6 * np.abs(ref[r]).max()
        np.testing.assert_allclose(got[r], ref[r], rtol=1e-5, atol=atol,
                                   err_msg=f"row {r}")
    np.testing.assert_array_equal(got[4:], ref[4:])


def jax_cells(qx, qy):
    """The JAX fold's cell indices (``windowed_grid_lookup.fold``)."""
    return jax.jit(lambda x, y, o: (
        jnp.floor((x - o[0]) / RES).astype(jnp.int32),
        jnp.floor((y - o[1]) / RES).astype(jnp.int32)))(
            qx, qy, jnp.asarray(ORIGIN, jnp.float32))


class TestPlainFold:
    def test_packed_view_and_select(self, jax_grid):
        qx, qy, qz, _ = queries(200, 4.0, seed=1)
        jp = jgrid.PackedLookup.from_grid(jax_grid)
        tp = mls_grid.PackedLookup.from_grid(
            convert.mls_grid_from(as_dict(jax_grid)))
        np.testing.assert_array_equal(tp.data.numpy(), np.asarray(jp.data))
        ix, iy = jax_cells(qx, qy)
        tix, tiy = mls_grid.cells(tp, torch.from_numpy(qx),
                                  torch.from_numpy(qy))
        np.testing.assert_array_equal(tix.numpy(), np.asarray(ix))
        np.testing.assert_array_equal(tiy.numpy(), np.asarray(iy))
        ref = jgrid.get_patch_packed_cells(jp, ix, iy, jnp.asarray(qz))
        got = mls_grid.get_patch_packed_cells(tp, tix, tiy,
                                              torch.from_numpy(qz))
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        # [..., 3] point queries, and the packed view carried across
        pts = np.stack([qx, qy, qz], -1)
        ref = jax.jit(jgrid.get_patch_packed)(jp, pts)
        carried = convert.packed_lookup_from(as_dict(jp))
        np.testing.assert_array_equal(carried.data.numpy(), tp.data.numpy())
        got = mls_grid.get_patch_packed(carried, torch.from_numpy(pts))
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    @pytest.mark.parametrize("n,spread", [(200, 1.0), (256, 4.0), (37, 2.0)])
    def test_against_xla_twin(self, jax_grid, n, spread):
        qx, qy, qz, mv = queries(n, spread, seed=n)
        jp = jgrid.PackedLookup.from_grid(jax_grid)
        ix, iy = jax_cells(qx, qy)
        f, m, sd = jgrid.get_patch_packed_cells(
            jp, ix.reshape(-1), iy.reshape(-1), jnp.asarray(qz).reshape(-1))
        act = jnp.asarray(ACTIVE[:, None])
        ref = pg.contact_fold_sums(
            f.reshape(8, n), m.reshape(8, n), sd.reshape(8, n),
            jnp.asarray(qz), jnp.broadcast_to(act, (8, n)), jnp.asarray(mv),
            act, jnp.asarray(onehot_np()), CORRECTION)
        got = port_fold(jax_grid, qx, qy, qz, mv)
        assert got[4].max() >= 3  # several valid groups
        assert_rows_close(got, np.asarray(ref))

    @pytest.mark.parametrize("n,spread", [(200, 1.0), (130, 4.0)])
    def test_against_pallas_interpret(self, jax_grid, n, spread):
        """The TPU kernel in interpret mode, with the whole grid as its
        window (so no query can miss it) and f32 one-hot products."""
        qx, qy, qz, mv = queries(n, spread, seed=n + 7)
        ix, iy = (np.asarray(a) for a in jax_cells(qx, qy))
        inb = (ix >= 0) & (ix < NX) & (iy >= 0) & (iy < NY)
        jp = jgrid.PackedLookup.from_grid(jax_grid)
        ref = pg.window_select_contact(
            jp.data, jnp.asarray(np.clip(ix, 0, NX - 1)),
            jnp.asarray(np.clip(iy, 0, NY - 1)), jnp.asarray(qz),
            jnp.asarray(ACTIVE[:, None] * inb), jnp.asarray(mv),
            jnp.asarray(ACTIVE[:, None]), jnp.asarray(onehot_np()),
            correction=CORRECTION, interpret=True, mxu_dtype=jnp.float32,
            tile=128,
        )
        got = port_fold(jax_grid, qx, qy, qz, mv)
        assert_rows_close(got, np.asarray(ref))

    def test_cpu_calls_are_not_kernel_launches(self, jax_grid):
        before = cf.contact_fold.launches
        port_fold(jax_grid, *queries(16, 1.0, seed=2))
        assert cf.contact_fold.launches == before

    def test_rejects_other_devices(self, jax_grid):
        qx, qy, qz, mv = (torch.from_numpy(a).to("meta")
                          for a in queries(4, 1.0, seed=3))
        packed = mls_grid.PackedLookup(
            torch.zeros((2, 2, 8), device="meta"),
            torch.zeros(2, device="meta"), RES)
        with pytest.raises(ValueError):
            cf.contact_fold(packed, (qx, qy, qz), torch.ones(8, 1), mv,
                            onehot=torch.eye(8), correction=CORRECTION)


class TestMillsRatio:
    def test_accuracy_vs_scipy(self):
        stats = pytest.importorskip("scipy.stats")
        u = np.linspace(-30, 12, 50001).astype(np.float32)
        ref = np.exp(stats.norm.logpdf(u) - stats.norm.logcdf(u))
        got = cf.mills_ratio(torch.from_numpy(u)).numpy()
        assert (np.abs(got - ref) / np.abs(ref)).max() < 1e-4

    def test_matches_jax(self):
        u = np.linspace(-30, 12, 4001).astype(np.float32)
        np.testing.assert_allclose(
            cf.mills_ratio(torch.from_numpy(u)).numpy(),
            np.asarray(pg._mills_ratio(jnp.asarray(u))), rtol=2e-6)


def eval_batch(grid, n, spread, fold, seed):
    """``evaluate_pose_batch`` on identity-rotation particles over the
    terrain, through the port's full-grid lookup."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-spread, spread, (n, 2)).astype(np.float32)
    z = terrain(xy[:, 0], xy[:, 1]).astype(np.float32) + 0.1
    rot = torch.eye(3).expand(n, 3, 3)
    trans = torch.from_numpy(np.concatenate([xy, z[:, None]], -1))
    contacts = np.array(
        [[0.2, 0.1, -0.1], [-0.2, 0.1, -0.12], [0.2, -0.1, -0.09],
         [-0.2, -0.1, -0.11], [0.0, 0.2, -0.1], [0.0, -0.2, -0.1],
         [0.1, 0.0, -0.1], [-0.1, 0.0, -0.1]], np.float32)
    state = BodyContactState.create(contacts, group_id=[0, 0, 1, 1, 2, 2,
                                                        3, 3])
    cmc = ContactModelConfig(contact_point_radius=0.0, min_contacts=2,
                             fold_lookup=fold)
    lookup = make_lookup(Config(contact_model=cmc), grid)
    return cm.evaluate_pose_batch(
        state, rot, trans, torch.full((n,), 0.09),
        pe.bind_lookup(lookup, None), cmc)


class TestFoldAgainstUnfolded:
    @pytest.mark.parametrize("n,spread", [(64, 1.0), (64, 6.0), (37, 1.0)])
    def test_mills_bound(self, jax_grid, n, spread):
        grid = convert.mls_grid_from(as_dict(jax_grid))
        a = eval_batch(grid, n, spread, fold=True, seed=n)
        b = eval_batch(grid, n, spread, fold=False, seed=n)
        assert b.measurement_valid.any()
        np.testing.assert_array_equal(a.measurement_valid.numpy(),
                                      b.measurement_valid.numpy())
        np.testing.assert_array_equal(a.n_contacts.numpy(),
                                      b.n_contacts.numpy())
        for name in ("weight", "z_delta", "pose_var"):
            np.testing.assert_allclose(getattr(a, name).numpy(),
                                       getattr(b, name).numpy(), rtol=2e-3,
                                       atol=1e-5, err_msg=name)
        fin = np.isfinite(b.z_var.numpy())
        np.testing.assert_array_equal(fin, np.isfinite(a.z_var.numpy()))
        np.testing.assert_allclose(a.z_var.numpy()[fin],
                                   b.z_var.numpy()[fin], rtol=2e-3)
