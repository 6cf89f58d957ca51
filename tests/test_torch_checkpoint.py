"""Checkpoint / resume of the port (``utils.checkpoint``).

The JAX package's cases (``tests/test_observability.py::TestCheckpoint``,
the checkpoint case of ``tests/test_streaming.py``) and a resume test:
save a filter mid-run, run k frames, restore into a fresh filter and run
the same k frames again: on the CPU every output and the whole state must
come out bit for bit the same.  The draws come from the filter's
``torch.Generator``, so the test also shows that its state is restored.
It runs on a float32 pool and a bfloat16 pool (``run_stream``, with the
copy-on-write and rollover of the per-particle maps) and on a shared grid
(``update_contact``, the restored grid's lookup rebuilt).
"""

import dataclasses

import numpy as np
import pytest
import torch

from slam_eslam_tpu_torch import convert
from slam_eslam_tpu_torch.config import Config, ContactModelConfig
from slam_eslam_tpu_torch.filter import streaming
from slam_eslam_tpu_torch.filter.eslam_filter import EmbodiedSlamFilter
from slam_eslam_tpu_torch.models import sim as simlib
from slam_eslam_tpu_torch.models.asguard import AsguardSim
from slam_eslam_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(2)

N = 16
RAYS = 16
K = 10          # frames run after the save


def terrain(x, y):
    return 0.2 * np.sin(0.8 * np.asarray(x)) + 0.15 * np.cos(
        0.6 * np.asarray(y))


def config(dtype="float32", **kw):
    return dataclasses.replace(
        Config(), particle_count=N, min_effective=0.9 * N, grid_size=2.0,
        grid_resolution=0.25, map_pool_blocks=4 * N, map_chain_length=3,
        map_pool_dtype=dtype,
        contact_model=ContactModelConfig(contact_point_radius=0.0,
                                         min_contacts=2), **kw)


def frames(n):
    sim = AsguardSim(terrain=terrain)
    q = np.array([1.0, 0, 0, 0], np.float32)
    meta = (np.float32(-np.pi / 2), np.float32(np.pi / RAYS))
    out = []
    sim_z = float(sim.position[2])

    def cb(s):
        out.append([s.contact_state(), q, s.position.astype(np.float32),
                    np.full(RAYS, 1.5, np.float32), meta, False])

    while len(out) < n:
        sim.step(wheel_delta=1.0, yaw_rate=0.1, substeps=5, on_substep=cb)
        out[-1][5] = True
    return sim_z, [tuple(fr) for fr in out[:n]]


def pool_filter(dtype, z0, pose=(0.0, 0.0)):
    f = EmbodiedSlamFilter(config=config(dtype), device="cpu")
    return f.init(pose=(np.array([pose[0], pose[1], z0]), 0.1),
                  use_shared_map=False)


def snapshot(f):
    """Every state field as NumPy, the map included."""
    out = convert.to_numpy(f.state)
    out["map"] = convert.to_numpy(f.shared_grid if f.use_shared_map
                                  else f.pool)
    out["host"] = (f.ud_pose.copy(), f.map_pose.copy(), f.stereo_pose.copy(),
                   f.update_idx, f.steps)
    out["draw"] = torch.rand(4, generator=f.state.generator).numpy()
    return out


def assert_equal(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for key in a:
            assert_equal(a[key], b[key], f"{path}.{key}")
    elif isinstance(a, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b)):
            assert_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resume_per_particle_maps(tmp_path, dtype):
    z0, fr = frames(20 + K)
    stream = streaming.stack_frames(fr)
    f = pool_filter(dtype, z0)
    f.run_stream(stream.at(slice(0, 20)))
    assert f.update_idx > 0 and (f.pool.chain[:, 1] >= 0).any()
    path = tmp_path / "filter.pt"
    ckpt.save_filter(path, f)
    rest = stream.at(slice(20, 20 + K))
    aux1 = f.run_stream(rest)
    first = snapshot(f)

    g = pool_filter(dtype, z0, pose=(0.7, -0.4))
    ckpt.restore_filter(path, g)
    assert g.pool.mean.dtype == getattr(torch, dtype)
    aux2 = g.run_stream(rest)
    for name in ("centroid", "best_pose"):
        np.testing.assert_array_equal(aux1[name].numpy(), aux2[name].numpy())
    for name in ("updated", "mapped"):
        np.testing.assert_array_equal(aux1[name], aux2[name])
    assert aux1["mapped"].any() and aux1["updated"].any()
    assert_equal(first, snapshot(g))


def test_resume_shared_grid(tmp_path):
    """Shared-map mode: ``update_contact`` frames, the surface hash off;
    the restored grid answers the next lookups."""
    cfg = dataclasses.replace(config(), particle_count=32,
                              min_effective=16)
    grid = simlib.terrain_grid(terrain, nx=40, ny=40, resolution=0.1,
                               origin=(-2.0, -2.0))
    sim = simlib.TrajectorySim(terrain, speed=0.06)
    steps = []
    for _ in range(12 + K):
        (pos, yaw), _ = sim.step()
        steps.append((sim.contact_state(noise=0.005),
                      np.array([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)],
                               np.float32), pos.copy()))

    def make(pose, grid):
        return EmbodiedSlamFilter(config=cfg, device="cpu").init(
            pose=(pose, 0.0), shared_grid=grid)

    def drive(f, part):
        cents = []
        for cs, q, pos in part:
            f.update_contact((q, pos), cs)
            cents.append(f.get_centroid()[0].numpy())
        return np.stack(cents)

    f = make(np.array([0.0, 0.0, terrain(0.0, 0.0) + 0.2]), grid)
    drive(f, steps[:12])
    path = tmp_path / "shared.pt"
    ckpt.save_filter(path, f)
    c1 = drive(f, steps[12:])
    first = snapshot(f)
    # a fresh filter on a flat map: the restore brings the terrain back
    g = make(np.array([0.5, 0.5, 0.0]), simlib.terrain_grid(
        lambda x, y: 0.0 * x, nx=40, ny=40, resolution=0.1,
        origin=(-2.0, -2.0)))
    ckpt.restore_filter(path, g)
    c2 = drive(g, steps[12:])
    np.testing.assert_array_equal(c1, c2)
    assert_equal(first, snapshot(g))


def test_filter_roundtrip(tmp_path):
    """``tests/test_observability.py::TestCheckpoint``: particles, chains
    and ``update_idx`` survive; the restored filter was ``init``-ed at
    another pose."""
    cfg = dataclasses.replace(
        Config(), particle_count=8, min_effective=4, grid_size=4.0,
        grid_resolution=0.5, map_pool_blocks=12,
        contact_model=ContactModelConfig(contact_point_radius=0.0))
    f = EmbodiedSlamFilter(config=cfg, device="cpu")
    f.init(pose=(np.zeros(3), 0.0), use_shared_map=False)
    f.update_idx = 7
    path = tmp_path / "ckpt"
    ckpt.save_filter(path, f)
    g = EmbodiedSlamFilter(config=cfg, device="cpu")
    g.init(pose=(np.ones(3), 0.3), use_shared_map=False)
    ckpt.restore_filter(path, g)
    np.testing.assert_array_equal(g.state.particles.xy.numpy(),
                                  f.state.particles.xy.numpy())
    np.testing.assert_array_equal(g.pool.chain.numpy(), f.pool.chain.numpy())
    assert g.update_idx == 7


def test_streaming_state_roundtrip(tmp_path):
    """The checkpoint case of ``tests/test_streaming.py``: a
    ``StreamingState`` (filter, pool, gate anchors) through ``save_state``
    / ``restore_state``, anchors and counters included."""
    z0, _ = frames(1)
    f = pool_filter("float32", z0)
    carry = dataclasses.replace(
        streaming.StreamingState.create(f.state, f.pool),
        map_pos=np.array([0.1, 0.2, 0.3], np.float32), update_idx=5,
        steps=9)
    path = tmp_path / "stream.pt"
    ckpt.save_state(path, carry)
    template = streaming.StreamingState.create(
        pool_filter("float32", z0, pose=(1.0, 1.0)).state, f.pool)
    restored = ckpt.restore_state(path, template)
    assert_equal(convert.to_numpy(carry), convert.to_numpy(restored))
    assert restored.update_idx == 5 and restored.steps == 9
