"""CUDA kernel K1 (``csrc/contact_fold.cu``) against its plain PyTorch
version on the card.  Marked ``cuda``; without a CUDA device every test
skips.  This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from slam_eslam_tpu_torch import Config, ContactModelConfig
from slam_eslam_tpu_torch.core.state import BodyContactState
from slam_eslam_tpu_torch.filter import pose_estimator as pe
from slam_eslam_tpu_torch.filter import step as steplib
from slam_eslam_tpu_torch.mapping.lookup import make_lookup
from slam_eslam_tpu_torch.mapping.mls_grid import PackedLookup
from slam_eslam_tpu_torch.models import sim
from slam_eslam_tpu_torch.ops import contact_fold as cf
from slam_eslam_tpu_torch.utils import tree

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def terrain(x, y):
    return 0.25 * np.sin(1.3 * np.asarray(x)) + 0.2 * np.cos(
        0.9 * np.asarray(y))


def fold_case(n, spread, seed, dev, nx=200, ny=160, k=4):
    rng = np.random.default_rng(seed)
    res, origin = 0.05, (-5.0, -4.0)
    cx = (np.arange(nx) + 0.5) * res + origin[0]
    cy = (np.arange(ny) + 0.5) * res + origin[1]
    base = terrain(cx[:, None], cy[None, :])[..., None]
    mean = base + rng.uniform(-2.5, 2.5, (nx, ny, k)) * (np.arange(k) > 0)
    empty = rng.random((nx, ny, k)) < 0.3
    data = np.concatenate([np.where(empty, 0.0, mean),
                           np.where(empty, -1.0,
                                    rng.uniform(0.01, 0.1, (nx, ny, k)))], -1)
    packed = PackedLookup(torch.tensor(data, dtype=torch.float32, device=dev),
                          torch.tensor(origin, device=dev), res)
    pxy = rng.uniform(-spread, spread, (n, 2))
    offs = rng.uniform(-0.4, 0.4, (8, 2))
    qx = offs[:, :1] + pxy[None, :, 0]
    qy = offs[:, 1:] + pxy[None, :, 1]
    qz = terrain(qx, qy) + rng.normal(0, 0.05, (8, n))
    qz = np.where(rng.random((8, n)) < 0.05, qz + rng.uniform(-4, 4, (8, n)),
                  qz)
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    seg, s = BodyContactState.create(
        np.zeros((8, 3)), group_id=[0, 0, 1, 1, -1, 2, 2, -1]).segments()
    onehot = (seg[:, None] == torch.arange(s)[None, :]).float().to(dev)
    act = f(np.array([1, 1, 1, 0, 1, 1, 1, 1])[:, None])
    mv = f(rng.uniform(0.01, 0.2, (1, n)))
    return packed, (f(qx), f(qy), f(qz)), act, mv, onehot


@pytest.mark.parametrize("n,spread,k", [(4096, 1.0, 4), (1001, 6.0, 4),
                                        (777, 2.0, 2), (300, 1.0, 1)])
def test_kernel_matches_plain(dev, n, spread, k):
    packed, q, act, mv, onehot = fold_case(n, spread, n, dev, k=k)
    kw = dict(onehot=onehot, correction=0.33, z_window=3.0)
    before = cf.contact_fold.launches
    got = cf.contact_fold(packed, q, act, mv, **kw)
    assert cf.contact_fold.launches == before + 1
    ref = cf.contact_fold_reference(packed, q, act, mv, **kw)
    torch.cuda.synchronize()
    for r in range(4):
        atol = 1e-5 * float(ref[r].abs().max())
        torch.testing.assert_close(got[r], ref[r], rtol=1e-4, atol=atol)
    assert torch.equal(got[4:], ref[4:])
    assert float(got[4].max()) >= 3


def test_kernel_rejects_bad_operands(dev):
    packed, (qx, qy, qz), act, mv, onehot = fold_case(64, 1.0, 0, dev)
    kw = dict(onehot=onehot, correction=0.33)
    with pytest.raises(ValueError):   # non-contiguous
        cf.contact_fold(packed, (qx.T.contiguous().T, qy, qz), act, mv, **kw)
    with pytest.raises(TypeError):    # float64
        cf.contact_fold(packed, (qx.double(), qy, qz), act, mv, **kw)
    with pytest.raises(ValueError):   # queries on the host
        cf.contact_fold(packed, (qx.cpu(), qy, qz), act, mv, **kw)


def test_steps_match_cpu_port(dev):
    n, steps = 4096, 5
    cfg = dataclasses.replace(
        Config(), particle_count=n, min_effective=n // 2,
        contact_model=ContactModelConfig(contact_point_radius=0.0))
    grid = sim.terrain_grid(terrain, nx=160, ny=160, resolution=0.05,
                            origin=(-4.0, -4.0))
    traj = sim.TrajectorySim(terrain, speed=0.05, yaw_rate=0.02)
    css, qs = [], []
    for _ in range(steps):
        (_, yaw), _ = traj.step()
        css.append(traj.contact_state(noise=0.005).compact(8))
        qs.append(torch.tensor([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)],
                               dtype=torch.float32))
    css, qs = tree.stack(css), torch.stack(qs)
    gen = torch.Generator().manual_seed(0)
    particles = pe.init_gaussian(n, (0.0, 0.0), 0.0, (0.2, 0.2), 0.05, 0.2,
                                 0.3, generator=gen)
    draws = [steplib.StepDraws(pe.ProjectDraws.sample(n, gen, "cpu"),
                               torch.rand(n, generator=gen))
             for _ in range(steps)]
    cents = {}
    for d in ("cpu", dev):
        state = dataclasses.replace(
            pe.PoseEstimatorState.create(cfg, 8, device=d),
            particles=tree.to(particles, d))
        run = steplib.make_scan_runner(cfg, make_lookup(cfg,
                                                        tree.to(grid, d)))
        before = cf.contact_fold.launches
        _, c = run(state, tree.to(css, d), qs.to(d),
                   [tree.to(x, d) for x in draws])
        launched = cf.contact_fold.launches - before
        assert launched == (steps if d == dev else 0)
        cents[str(d)] = c.cpu()
    torch.testing.assert_close(cents[str(dev)], cents["cpu"], rtol=0,
                               atol=1e-4)
