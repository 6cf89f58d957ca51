"""The port's offline plots (``viz.render``, ``viz.snapshots``) on the CPU,
held against the JAX package's ``slam_eslam_tpu.viz``.

``tests/test_observability.py::TestViz`` and ``tests/test_streaming.py::
test_snapshot_recorder`` run on the port.  ``chain_layers`` (what
``draw_particle_map`` draws) equals, layer by layer, the arrays the JAX
``draw_particle_map`` hands to ``imshow`` for the same pool carried
across with ``convert.map_pool_from``, stored in float32 and in bfloat16
(NaN where a cell has no patch; exact, as a bfloat16 value widens to
float32 exactly).  Drawing one particle's map never builds the whole
pool's ``valid`` mask: with that property made to raise, the drawing and
the recorder still run.  Every other plot draws the same artists as the
JAX function on the same data.
"""

import dataclasses
import os

import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg", force=True)
import matplotlib.pyplot as plt  # noqa: E402

from slam_eslam_tpu.mapping import map_pool as jmp  # noqa: E402
from slam_eslam_tpu.mapping.mls_grid import MLSGrid as JGrid  # noqa: E402
from slam_eslam_tpu.viz import render as jrender  # noqa: E402
from slam_eslam_tpu_torch import convert  # noqa: E402
from slam_eslam_tpu_torch.config import (Config,  # noqa: E402
                                         ContactModelConfig)
from slam_eslam_tpu_torch.core.distribution import (  # noqa: E402
    export_distribution)
from slam_eslam_tpu_torch.core.state import (BodyContactState,  # noqa: E402
                                             ParticleSet)
from slam_eslam_tpu_torch.filter.eslam_filter import (  # noqa: E402
    EmbodiedSlamFilter)
from slam_eslam_tpu_torch.mapping.map_pool import MapPool  # noqa: E402
from slam_eslam_tpu_torch.mapping.mls_grid import MLSGrid  # noqa: E402
from slam_eslam_tpu_torch.models import sim as simlib  # noqa: E402
from slam_eslam_tpu_torch.models.asguard import AsguardSim  # noqa: E402
from slam_eslam_tpu_torch.viz import render  # noqa: E402
from slam_eslam_tpu_torch.viz.snapshots import (  # noqa: E402
    SnapshotRecorder)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def close_figures():
    yield
    plt.close("all")


class TestViz:
    def test_render_distribution_saves_png(self, tmp_path):
        gen = torch.Generator().manual_seed(0)
        p = ParticleSet.zeros(32).with_xy(torch.randn((32, 2),
                                                      generator=gen))
        p = dataclasses.replace(p, weight=torch.full((32,), 1 / 32))
        cs = BodyContactState.create(np.zeros((4, 3), np.float32))
        d = export_distribution(p, torch.tensor([1.0, 0, 0, 0]), cs,
                                generator=gen)
        grid = simlib.terrain_grid(lambda x, y: 0.1 * np.asarray(x), nx=20,
                                   ny=20, resolution=0.5, origin=(-5.0, -5.0))
        out = render.render_distribution(
            d, path=os.path.join(str(tmp_path), "dist.png"), grid=grid)
        assert os.path.exists(out) and os.path.getsize(out) > 1000

    def test_particle_map_view(self):
        template = MLSGrid.create(10, 10, 0.5, (-2.5, -2.5), 2)
        pool = MapPool.from_template(template, 2, 4)
        ax = render.draw_particle_map(pool, 0)
        assert ax is not None


def terrain(x, y):
    return 0.15 * np.sin(0.7 * np.asarray(x)) + 0.12 * np.cos(
        0.5 * np.asarray(y))


def snapshot_filter(n=8):
    cfg = dataclasses.replace(
        Config(), particle_count=n, min_effective=n // 2, grid_size=10.0,
        grid_resolution=0.25, map_pool_blocks=n + 16, map_chain_length=3,
        contact_model=ContactModelConfig(contact_point_radius=0.0,
                                         min_contacts=2))
    f = EmbodiedSlamFilter(config=cfg, device="cpu")
    sim = AsguardSim(terrain=terrain)
    f.init(pose=(np.array([0.0, 0.0, sim.position[2]]), 0.0),
           use_shared_map=False)
    return f, sim


def drive_recorder(f, sim, rec):
    q = np.array([1.0, 0, 0, 0], np.float32)
    wrote = []
    for _ in range(2):
        sim.step(wheel_delta=0.3, on_substep=lambda s: None)
        f.update_contact((q, sim.position.astype(np.float64)),
                         sim.contact_state())
        wrote.append(rec.maybe(f, truth=sim.position))
    return wrote


def test_snapshot_recorder(tmp_path):
    """Every N-th update writes a frame: particles, trajectories and the
    inspected particle's map."""
    f, sim = snapshot_filter()
    rec = SnapshotRecorder(str(tmp_path / "frames"), every=2)
    wrote = drive_recorder(f, sim, rec)
    assert wrote[0] is not None and wrote[1] is None
    assert os.path.exists(wrote[0])
    assert len(rec.frames) == 1
    assert len(rec._centroid) == len(rec._truth) == 2


def jax_pool(dtype, seed=0, n=6, blocks=15, nx=5, ny=4, k=3):
    """A JAX pool with random patches, part of them valid, chains of
    three with empty entries, and scattered block origins."""
    rng = np.random.default_rng(seed)
    template = JGrid.create(nx, ny, 0.25, (-0.5, 0.75), k)
    pool = jmp.MapPool.from_template(template, n, blocks, 3,
                                     with_color=False, dtype=dtype)
    shape = (blocks, nx, ny * k)
    meta = (rng.integers(0, 64, shape) << 2) | rng.integers(0, 4, shape)
    chain = rng.integers(0, blocks, (n, 3))
    chain[rng.uniform(size=(n, 3)) < 0.3] = -1
    chain[0] = [4, -1, 11]      # an empty level between two blocks
    chain[1] = -1               # no block at all
    return dataclasses.replace(
        pool, mean=jnp.asarray(rng.normal(size=shape), dtype),
        meta=jnp.asarray(meta, jnp.int32),
        origin=jnp.asarray(rng.uniform(-3, 3, (blocks, 2)), jnp.float32),
        chain=jnp.asarray(chain, jnp.int32))


def port_pool(jpool):
    """The JAX pool carried across (``convert.map_pool_from``)."""
    static = ("resolution", "nx", "ny", "k", "color")
    return convert.map_pool_from({
        f.name: (getattr(jpool, f.name) if f.name in static
                 else np.asarray(getattr(jpool, f.name)))
        for f in dataclasses.fields(jpool)})


class FakeAxes:
    """Records ``imshow`` calls (the JAX function's composite layers)."""

    def __init__(self):
        self.layers = []
        self.figure = self

    def imshow(self, z, extent, **kw):
        self.layers.append((np.asarray(z, np.float32), list(extent)))
        return None

    def colorbar(self, *a, **kw):
        pass


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_chain_layers_are_the_jax_composite(dtype, seed):
    jpool = jax_pool(jnp.dtype(dtype), seed)
    pool = port_pool(jpool)
    assert pool.mean.dtype == getattr(torch, dtype)
    drawn = 0
    for i in range(pool.n):
        ax = FakeAxes()
        jrender.draw_particle_map(jpool, i, ax=ax)
        layers = render.chain_layers(pool, i)
        # the JAX function draws the chain tail first, the head on top
        assert len(layers) == len(ax.layers)
        for (z, extent), (z_t, ext_ref) in zip(layers[::-1], ax.layers):
            assert z.dtype == np.float32
            np.testing.assert_array_equal(z.T, z_t)
            np.testing.assert_array_equal(np.float32(extent),
                                          np.float32(ext_ref))
        drawn += len(layers)
    assert drawn > pool.n
    assert render.chain_layers(pool, 1) == []


@pytest.fixture
def no_pool_mask(monkeypatch):
    def whole_pool(self):
        raise AssertionError("built the whole pool's valid mask")

    monkeypatch.setattr(MapPool, "valid", property(whole_pool))


def test_drawing_a_particle_map_never_builds_the_pool_mask(no_pool_mask):
    jpool = jax_pool(jnp.dtype("bfloat16"))
    pool = port_pool(jpool)
    with pytest.raises(AssertionError):
        pool.valid
    ax = render.draw_particle_map(pool, 0)
    assert len(ax.images) == 2


def test_the_recorder_never_builds_the_pool_mask(no_pool_mask, tmp_path):
    f, sim = snapshot_filter()
    rec = SnapshotRecorder(str(tmp_path / "frames"), every=1)
    assert all(drive_recorder(f, sim, rec))


def test_particles_gmm_grid_and_trajectories_match_jax():
    """The same artists as the JAX functions on the same data: scatter
    offsets, sizes and colours, ellipses, the grid image, the lines."""
    rng = np.random.default_rng(3)
    n = 12
    xy = rng.normal(size=(n, 2)).astype(np.float32)
    w = rng.uniform(size=n).astype(np.float32)
    fl = rng.uniform(size=n) < 0.3
    yaw = rng.uniform(-3, 3, n).astype(np.float32)
    p = dataclasses.replace(ParticleSet.zeros(n).with_xy(torch.from_numpy(xy)),
                            weight=torch.from_numpy(w),
                            floating=torch.from_numpy(fl),
                            yaw=torch.from_numpy(yaw))
    jp = _jax_particles(xy, w, fl, yaw)
    means = rng.normal(size=(3, 2))
    covs = np.stack([np.diag(rng.uniform(0.1, 1.0, 2)) for _ in range(3)])
    mix = np.array([0.2, 0.3, 0.5])
    grid = simlib.terrain_grid(terrain, nx=8, ny=6, resolution=0.5,
                               origin=(-2.0, -1.5))
    jgrid = JGrid.create(8, 6, 0.5, (-2.0, -1.5), 4)
    jgrid = dataclasses.replace(jgrid, mean=jnp.asarray(grid.mean.numpy()),
                                valid=jnp.asarray(grid.valid.numpy()))
    traj = rng.normal(size=(5, 3))
    axes = []
    for mod, particles, g in ((render, p, grid), (jrender, jp, jgrid)):
        _, ax = plt.subplots()
        mod.draw_particles(particles, ax=ax, best_index=2)
        mod.draw_gmm(means, covs, mix, ax=ax)
        mod.draw_grid(g, ax=ax)
        mod.draw_trajectories(reference=traj, centroid=traj[::-1], ax=ax)
        axes.append(ax)
    a, b = axes
    sa, sb = a.collections[0], b.collections[0]
    np.testing.assert_array_equal(sa.get_offsets(), sb.get_offsets())
    np.testing.assert_array_equal(sa.get_sizes(), sb.get_sizes())
    np.testing.assert_array_equal(sa.get_facecolors(), sb.get_facecolors())
    assert len(a.patches) == len(b.patches) == 3
    for ea, eb in zip(a.patches, b.patches):
        assert (ea.width, ea.height, ea.angle) == pytest.approx(
            (eb.width, eb.height, eb.angle))
    np.testing.assert_array_equal(a.images[0].get_array(),
                                  b.images[0].get_array())
    assert a.images[0].get_extent() == pytest.approx(
        b.images[0].get_extent())
    for la, lb in zip(a.lines, b.lines):
        np.testing.assert_array_equal(la.get_xydata(), lb.get_xydata())


def _jax_particles(xy, w, fl, yaw):
    from slam_eslam_tpu.core.state import ParticleSet as JParticles

    p = JParticles.zeros(len(w)).with_xy(jnp.asarray(xy))
    return dataclasses.replace(p, weight=jnp.asarray(w),
                               floating=jnp.asarray(fl),
                               yaw=jnp.asarray(yaw))
