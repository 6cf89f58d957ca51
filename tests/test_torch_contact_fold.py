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


def group_ids(c, grouping):
    """Group ids of ``c`` contact rows: the 8-row pattern of ``GROUPS``
    repeated with ids of its own per repeat, or one group for all."""
    if grouping == "one":
        return np.zeros(c, np.int32)
    rows = np.arange(c)
    pattern = GROUPS[rows % 8]
    return np.where(pattern < 0, -1, pattern + 3 * (rows // 8)).astype(
        np.int32)


def queries_c(n, c, seed):
    rng = np.random.default_rng(seed)
    pxy = rng.uniform(-2.0, 2.0, (n, 2))
    offs = rng.uniform(-0.4, 0.4, (c, 2))
    qx = (offs[:, 0:1] + pxy[None, :, 0]).astype(np.float32)
    qy = (offs[:, 1:2] + pxy[None, :, 1]).astype(np.float32)
    qz = terrain(qx, qy) + rng.normal(0.0, 0.05, (c, n))
    far = rng.random((c, n)) < 0.05
    qz = np.where(far, qz + rng.uniform(-4, 4, (c, n)), qz).astype(np.float32)
    mv = rng.uniform(0.01, 0.2, (1, n)).astype(np.float32)
    return qx, qy, qz, mv


class TestSegmentIds:
    """``contact_fold(seg=...)``: the int32 group ids the kernel reads, in
    place of (or beside) the one-hot membership.  On the CPU both reach the
    plain version, which is held against the JAX package's
    ``contact_fold_sums`` on the exact gather (rtol 1e-5, as above)."""

    @pytest.mark.parametrize("c,grouping,active", [
        (1, "pattern", "some"), (8, "pattern", "some"),
        (20, "pattern", "some"), (8, "one", "all"), (20, "one", "some"),
        (8, "pattern", "none"), (1, "one", "none")])
    def test_seg_equals_onehot_and_jax(self, jax_grid, c, grouping, active):
        n = 67
        qx, qy, qz, mv = queries_c(n, c, seed=31 * c + len(grouping))
        gid = group_ids(c, grouping)
        seg, s = JContactState.create(np.zeros((c, 3)),
                                      group_id=gid).segments()
        seg = np.asarray(seg)
        onehot = (seg[:, None] == np.arange(s)[None, :]).astype(np.float32)
        if grouping == "one":
            assert len(set(seg.tolist())) == 1            # S = 1
        act = {"all": np.ones(c, np.float32),
               "none": np.zeros(c, np.float32),
               "some": ACTIVE[np.arange(c) % 8]}[active][:, None].copy()

        jp = jgrid.PackedLookup.from_grid(jax_grid)
        ix, iy = jax_cells(qx, qy)
        f, m, sd = jgrid.get_patch_packed_cells(
            jp, ix.reshape(-1), iy.reshape(-1), jnp.asarray(qz).reshape(-1))
        ref = np.asarray(pg.contact_fold_sums(
            f.reshape(c, n), m.reshape(c, n), sd.reshape(c, n),
            jnp.asarray(qz), jnp.broadcast_to(jnp.asarray(act), (c, n)),
            jnp.asarray(mv), jnp.asarray(act), jnp.asarray(onehot),
            CORRECTION))

        packed = mls_grid.PackedLookup.from_grid(
            convert.mls_grid_from(as_dict(jax_grid)))
        t = torch.from_numpy
        args = (packed, (t(qx), t(qy), t(qz)), t(act), t(mv))
        kw = dict(correction=CORRECTION, z_window=3.0)
        by_onehot = cf.contact_fold(*args, onehot=t(onehot), **kw)
        by_seg = cf.contact_fold(*args, seg=t(seg.astype(np.int32)), **kw)
        both = cf.contact_fold(*args, onehot=t(onehot),
                               seg=t(seg.astype(np.int32)), **kw)
        assert by_seg.shape == (8, n)
        torch.testing.assert_close(by_seg, by_onehot, rtol=0, atol=0)
        torch.testing.assert_close(both, by_onehot, rtol=0, atol=0)
        assert_rows_close(by_seg.numpy(), ref)
        if active == "none":
            assert not by_seg.any()
        else:
            assert by_seg[4].max() >= 1

    def test_segment_ids_invert_the_onehot(self):
        for c in (1, 8, 20):
            seg, s = BodyContactState.create(
                np.zeros((c, 3)), group_id=group_ids(c, "pattern")).segments()
            onehot = (seg[:, None] == torch.arange(s)[None, :]).float()
            got = cf.segment_ids(onehot)
            assert got.dtype == torch.int32
            assert torch.equal(got, seg)

    def test_needs_one_of_them(self, jax_grid):
        packed = mls_grid.PackedLookup.from_grid(
            convert.mls_grid_from(as_dict(jax_grid)))
        qx, qy, qz, mv = (torch.from_numpy(a)
                          for a in queries_c(4, 8, seed=1))
        with pytest.raises(ValueError, match="onehot or seg"):
            cf.contact_fold(packed, (qx, qy, qz), torch.ones(8, 1), mv,
                            correction=CORRECTION)

    def test_the_model_hands_the_fold_its_segment_ids(self, jax_grid):
        """``evaluate_pose_batch`` gives the fold the int32 ids (what the
        kernel reads) and builds no one-hot on the fold path."""
        grid = convert.mls_grid_from(as_dict(jax_grid))
        cmc = ContactModelConfig(contact_point_radius=0.0, min_contacts=2)
        lookup = make_lookup(Config(contact_model=cmc), grid)
        seen = {}
        inner = lookup.fold

        def spy(queries, act_col, mv, **kw):
            seen.update(kw)
            return inner(queries, act_col, mv, **kw)

        lookup.fold = spy
        state = BodyContactState.create(
            np.zeros((8, 3), np.float32) + [0.1, 0.0, -0.1],
            group_id=[0, 0, 1, 1, 2, 2, 3, 3])
        n = 16
        cm.evaluate_pose_batch(
            state, torch.eye(3).expand(n, 3, 3), torch.zeros(n, 3),
            torch.full((n,), 0.09), pe.bind_lookup(lookup, None), cmc)
        assert seen["seg"].dtype == torch.int32
        assert seen["seg"].tolist() == [0, 0, 1, 1, 2, 2, 3, 3]
        assert seen.get("onehot") is None
