"""Synthetic simulation fixtures, in NumPy.

A jax-free copy of ``slam_eslam_tpu.models.sim`` (``terrain_grid``,
``conformal_contact_state``, ``TrajectorySim``) with the Asguard wheel
geometry of ``models.asguard``, so the benchmark
trajectory can be rebuilt where JAX is not installed.  The grid is
filled with the same float32 arithmetic as the JAX ``merge_points`` of
one measurement into each empty cell.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_eslam_tpu_torch.core.state import BodyContactState
from slam_eslam_tpu_torch.mapping.mls_grid import MLSGrid
from slam_eslam_tpu_torch.models.asguard import (
    FEET_PER_WHEEL, NUM_FEET, NUM_WHEELS, AsguardConfig)
from slam_eslam_tpu_torch.utils import tree


def terrain_grid(terrain, nx, ny, resolution, origin, stdev=0.02, k=4,
                 device=None, color=None):
    """An ``MLSGrid`` holding one patch per cell (slot 0) at
    ``terrain(x, y)`` of the cell centre, with standard deviation
    ``stdev``; ``color(x, y) -> [P, 3]`` paints every slot of each cell
    (a terrain-class RGB for the slip update, ``models.terrain``)."""
    f32 = np.float32
    ix, iy = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    cells = np.stack([ix.ravel(), iy.ravel()], -1).astype(f32)
    xy = (cells + f32(0.5)) * f32(resolution) + np.asarray(origin, f32)
    z = np.asarray(terrain(xy[:, 0], xy[:, 1]), f32)
    # one Gaussian-fused measurement per empty cell: inverse-variance
    # sums of a single point, inserted into the first free slot
    var = np.full_like(z, stdev, dtype=f32) ** 2
    w = f32(1.0) / np.maximum(var, f32(1e-12))
    fused_z = (w * z) / np.maximum(w, f32(1e-30))
    fused_sd = np.sqrt(f32(1.0) / np.maximum(w, f32(1e-30)))

    g = MLSGrid.create(nx, ny, resolution, origin, k)
    g.mean[..., 0] = torch.from_numpy(fused_z.reshape(nx, ny))
    g.stdev[..., 0] = torch.from_numpy(fused_sd.reshape(nx, ny))
    g.valid[..., 0] = True
    if color is not None:
        rgb = np.asarray(color(xy[:, 0], xy[:, 1]), f32).reshape(nx, ny, 1, 3)
        g.color[:] = torch.from_numpy(rgb)
    return g if device is None else tree.to(g, device)


def conformal_contact_state(position, yaw, terrain, config=None, noise=0.0,
                            rng=None):
    """Terrain-conformal contact candidates for a true pose: per wheel,
    the stance foot sits on the terrain under the wheel centre (contact
    1) and the other feet hang above it (contact 0).  Points are in the
    yaw-compensated body frame."""
    config = config or AsguardConfig()
    rng = rng or np.random.default_rng(0)
    centers = config.wheel_centers()
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, -s], [s, c]])

    positions = np.zeros((NUM_FEET, 3), np.float32)
    contact = np.zeros(NUM_FEET, np.float32)
    group = np.repeat(np.arange(NUM_WHEELS), FEET_PER_WHEEL).astype(np.int32)
    for wheel in range(NUM_WHEELS):
        cw = centers[wheel]
        world_xy = rot @ cw[:2] + position[:2]
        ground = terrain(world_xy[0], world_xy[1])
        for j in range(FEET_PER_WHEEL):
            i = wheel * FEET_PER_WHEEL + j
            if j == 0:
                fz = ground - position[2] + rng.normal() * noise
                contact[i] = 1.0
            else:
                fz = ground - position[2] + 0.05 + 0.03 * j
            positions[i] = [cw[0], cw[1], fz]
    return BodyContactState.create(positions, contact=contact, group_id=group)


class TrajectorySim:
    """Ground-truth poses moving along body +y over a terrain."""

    def __init__(self, terrain, speed=0.05, yaw_rate=0.0, seed=0):
        self.terrain = terrain
        self.speed = speed
        self.yaw_rate = yaw_rate
        self.rng = np.random.default_rng(seed)
        self.position = np.zeros(3)
        self.yaw = 0.0
        self.position[2] = terrain(0.0, 0.0) + 0.2

    def step(self):
        """Advance one step; returns the ground truth ``(position, yaw)``
        and the body-frame odometry delta ``(dxy, dyaw, dz)``."""
        c, s = np.cos(self.yaw), np.sin(self.yaw)
        d_body = np.array([0.0, self.speed])
        self.position[:2] += np.array([[c, -s], [s, c]]) @ d_body
        self.yaw += self.yaw_rate
        new_z = self.terrain(self.position[0], self.position[1]) + 0.2
        dz = new_z - self.position[2]
        self.position[2] = new_z
        return (self.position.copy(), self.yaw), (d_body, self.yaw_rate, dz)

    def contact_state(self, noise=0.0):
        return conformal_contact_state(
            self.position, self.yaw, self.terrain, noise=noise, rng=self.rng
        )


def random_pool(n, num_blocks, nx, ny, k=4, resolution=0.25, chain_len=3,
                seed=0, device=None, dtype=torch.float32, parts=1):
    """A seeded ``MapPool`` for kernel checks, made on ``device`` with its
    float fields stored as ``dtype`` (drawn in float32, then rounded, so
    a bfloat16 pool is the float32 pool of the same seed rounded): every
    cell holds a uniform random share of valid slots (half full on
    average, one cell in five full), slot means near 0.3 m (fusable),
    0.5-1.3 m above (gap extension) or 2-3 m above (neither), random
    horizontal bits and update stamps; block origins on a lattice of
    block sizes; unique chain heads and tails of random blocks, a quarter
    of them empty (-1).  The per-slot fields are drawn ``num_blocks /
    parts`` blocks at a time, so that the float32 draws of a pool of tens
    of GB never exist whole (another ``parts``, another pool)."""
    from slam_eslam_tpu_torch.mapping.map_pool import MapPool

    gen = torch.Generator(device or "cpu").manual_seed(seed)
    f32 = dict(dtype=torch.float32, device=device)
    rand = lambda *s: torch.rand(s, generator=gen, **f32)
    randint = lambda lo, hi, *s: torch.randint(
        lo, hi, s, generator=gen, device=device)
    b = num_blocks
    if b % parts:
        raise ValueError(f"{b} blocks do not split into {parts} equal parts")
    step = b // parts
    shape = (step, nx, ny * k)
    field = lambda dt: torch.empty((b, nx, ny * k), dtype=dt, device=device)
    mean, stdev, height, meta = (field(dtype), field(dtype), field(dtype),
                                 field(torch.int32))
    for lo in range(0, b, step):
        kind = rand(*shape)
        mean[lo:lo + step] = 0.3 + torch.where(
            kind < 0.3, 0.03 * torch.randn(shape, generator=gen, **f32),
            torch.where(kind < 0.5, 0.5 + 0.8 * rand(*shape),
                        2.0 + rand(*shape)))
        level = rand(step, nx, ny, 1)
        valid = (rand(step, nx, ny, k) < level).reshape(shape)
        meta[lo:lo + step] = (
            valid.to(torch.int32) | (rand(*shape) < 0.8).to(torch.int32) << 1
            | randint(0, 5, *shape).to(torch.int32) << 2)
    del kind, level, valid
    size = torch.tensor([nx * resolution, ny * resolution], **f32)
    origin = randint(-8, 8, b, 2).to(torch.float32) * size - size / 2
    chain = randint(0, b, n, chain_len).to(torch.int32)
    chain[rand(n, chain_len) < 0.25] = -1
    chain[:, 0] = torch.randperm(b, generator=gen, device=device)[:n].to(
        torch.int32)
    for lo in range(0, b, step):
        stdev[lo:lo + step] = 0.01 + 0.19 * rand(*shape)
        height[lo:lo + step] = 0.3 * rand(*shape) * (rand(*shape) < 0.3)
    pool = MapPool(
        mean=mean, stdev=stdev, height=height, meta=meta,
        color=None, origin=origin,
        allocated=torch.zeros(b, dtype=torch.bool, device=device),
        chain=chain, resolution=float(resolution), nx=nx, ny=ny, k=k)
    pool.allocated = pool.refcounts() > 0
    return pool


def poses_on_heads(pool, spread, seed=0):
    """Particle poses ``(xy [N, 2], yaw, z, z_sigma)`` around the centres
    of their head blocks."""
    device = pool.mean.device
    gen = torch.Generator(device).manual_seed(seed)
    n = pool.n
    rand = lambda *s: torch.rand(s, generator=gen, device=device)
    half = torch.tensor([pool.nx * pool.resolution / 2,
                         pool.ny * pool.resolution / 2], device=device)
    centre = pool.origin.index_select(0, pool.active().long()) + half
    xy = centre + spread * (2 * rand(n, 2) - 1)
    return (xy, (2 * rand(n) - 1) * np.pi,
            0.02 * torch.randn(n, generator=gen, device=device),
            0.05 * rand(n))


def chain_queries(pool, c, seed=0):
    """SoA ``[N, C]`` lookup queries: each near a random level of the
    particle's chain (its head where the level is empty), a band around
    every block reaching past its edges, heights near the slot means or
    far from them."""
    device = pool.mean.device
    gen = torch.Generator(device).manual_seed(seed)
    n, levels = pool.chain.shape
    rand = lambda *s: torch.rand(s, generator=gen, device=device)
    level = torch.randint(0, levels, (n, c), generator=gen, device=device)
    blk = torch.gather(pool.chain, 1, level)
    blk = torch.where(blk >= 0, blk, pool.chain[:, :1]).long()
    org = pool.origin[blk]                                     # [N, C, 2]
    size = pool.nx * pool.resolution
    x = org[..., 0] - 0.3 + (size + 0.6) * rand(n, c)
    y = org[..., 1] - 0.3 + (size + 0.6) * rand(n, c)
    offsets = torch.tensor([0.0, 0.9, 2.5, -1.0], device=device)
    z = (0.3 + offsets[torch.randint(0, 4, (n, c), generator=gen,
                                     device=device)]
         + 0.05 * torch.randn((n, c), generator=gen, device=device))
    return x.contiguous(), y.contiguous(), z.contiguous()


def circle_pose_graph(dim=3, m=16, seed=0, outlier=False, device=None):
    """A seeded noisy circle trajectory as a ``PoseGraph`` (the graph of
    ``tests/test_pose_graph.py``): ``m`` nodes on the unit circle (``dim``
    4 adds z = 0.1 sin(2 theta)) perturbed by N(0, 0.1) except node 0,
    odometry edges between neighbours and closures (0, m-1), (2, m-2),
    (1, m/2), information 100 I, in ``max(64, m + 8)`` edge slots.
    ``outlier`` adds, in slot ``m + 3``, a closure claiming node ``m/2``
    (node 8 at m = 16) sits at node 0 + (5, 5).  Returns ``(graph, ground truth [m, dim]
    float32)``."""
    from slam_eslam_tpu_torch.backend.pose_graph import PoseGraph

    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, m, endpoint=False)
    cols = [np.cos(th), np.sin(th)]
    if dim == 4:
        cols.append(0.1 * np.sin(2 * th))
    cols.append(th + np.pi / 2)
    gt = np.stack(cols, -1)
    n0 = gt + rng.normal(0, 0.1, gt.shape)
    n0[0] = gt[0]

    def rel(a, b):
        c, s = np.cos(a[-1]), np.sin(a[-1])
        d = b[:2] - a[:2]
        out = [c * d[0] + s * d[1], -s * d[0] + c * d[1]]
        if dim == 4:
            out.append(b[2] - a[2])
        out.append(np.arctan2(np.sin(b[-1] - a[-1]), np.cos(b[-1] - a[-1])))
        return np.array(out)

    pairs = [(k, k + 1) for k in range(m - 1)]
    pairs += [(0, m - 1), (2, m - 2), (1, m // 2)]
    z = [rel(gt[a], gt[b]) for a, b in pairs]
    slots = list(range(len(pairs)))
    if outlier:
        pairs.append((0, m // 2))
        z.append(np.array([5.0, 5.0] + [0.0] * (dim - 2)))
        slots.append(m + 3)
    cap = max(64, m + 8)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    g = PoseGraph.empty(m, cap, dim=dim, device=device or "cpu")
    ends = np.zeros((2, cap), np.int32)
    ends[:, slots] = np.array(pairs, np.int32).T
    edge_z = np.zeros((cap, dim), np.float32)
    edge_z[slots] = np.stack(z)
    info = np.zeros((cap, dim, dim), np.float32)
    info[slots] = np.eye(dim) * 100.0
    valid = np.zeros(cap, bool)
    valid[slots] = True
    g.nodes, g.node_valid = f32(n0), g.node_valid | True
    g.edge_i = torch.tensor(ends[0], device=g.nodes.device)
    g.edge_j = torch.tensor(ends[1], device=g.nodes.device)
    g.edge_z, g.edge_info = f32(edge_z), f32(info)
    g.edge_valid = torch.tensor(valid, device=g.nodes.device)
    return g, np.asarray(gt, np.float32)
