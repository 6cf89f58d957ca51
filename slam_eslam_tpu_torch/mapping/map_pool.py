"""Per-particle MLS maps: the copy-on-write block pool.

Port of ``slam_eslam_tpu.mapping.map_pool``.  Every particle owns a
chain of map blocks (most recent first) in one dense pool whose fields
are block images ``[B, nx, ny*K]``: cell ``(ix, iy)`` slot ``s`` sits at
``[b, ix, iy*K + s]``, and ``meta`` packs (valid, horizontal,
update_idx) into one int32 per slot.  Resampling duplicates chains (O(N)
ints, ``MapPool.resample``); before a merge ``ensure_unique_active``
gives every particle a private head block; ``rollover`` starts a fresh
head when a particle leaves its active grid
(``EmbodiedSlamFilter.cpp:179-232``).

Differences from the JAX package, all for the GPU:

* Pool operations update the pool's tensors **in place** (and return
  the pool for the JAX call shape); the pool is the one large object of
  per-particle SLAM (1.68 GB at 4096 particles), so it is never copied.
* Nothing reads device data back to the host.  Where the JAX package
  skips a pool-wide copy with ``lax.cond(any(mask))``, the port copies
  predicated on the device: rows whose mask is off rewrite their own
  source block with its own content, so the cost is O(N) blocks, not
  O(B), and there is no host sync.
* The chain lookup and the merge run kernels K2 (``ops.chain_lookup``)
  and K3 (``ops.block_merge``) on CUDA tensors, their plain versions on
  CPU tensors.  The float fields are stored as float32 or bfloat16
  (``Config.map_pool_dtype``): every read upcasts (exactly), arithmetic
  is float32, a written slot rounds once, lookups return float32.
  Lookups are SoA and carry no colour (the colour chain lookup of the
  per-particle slip update is not ported yet); ``shards > 1`` and
  ``mesh`` belong to the multi-GPU slice and raise
  ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import torch

from slam_eslam_tpu_torch.mapping.mls_grid import (
    META_UIDX_SHIFT, MLSGrid, PatchCloud, inverse_resolution, pack_meta)
from slam_eslam_tpu_torch.ops import block_merge as bm
from slam_eslam_tpu_torch.ops import chain_lookup as cl

_FIELDS = ("mean", "stdev", "height", "meta")


def _single_shard(shards):
    if shards > 1:
        raise NotImplementedError(
            "map_pool_shards > 1 (block-range co-location on a device "
            "mesh) belongs to the port's multi-GPU slice")


@dataclasses.dataclass
class MapPool:
    mean: torch.Tensor          # [B, nx, ny*K] float32 or bfloat16
    stdev: torch.Tensor
    height: torch.Tensor
    meta: torch.Tensor          # [B, nx, ny*K] int32, see pack_meta
    color: torch.Tensor | None  # [B, nx, ny*K*3] as mean, or None
    origin: torch.Tensor        # [B, 2] float32, world xy of cell (0, 0)
    allocated: torch.Tensor     # [B] bool
    chain: torch.Tensor         # [N, L] int32 block ids, head first; -1 empty
    resolution: float
    nx: int
    ny: int
    k: int

    @property
    def valid(self):
        return self.meta & 1

    @property
    def horizontal(self):
        return (self.meta >> 1) & 1

    @property
    def update_idx(self):
        return self.meta >> META_UIDX_SHIFT

    @property
    def b(self):
        return self.mean.shape[0]

    @property
    def n(self):
        return self.chain.shape[0]

    @property
    def chain_len(self):
        return self.chain.shape[1]

    def active(self):
        return self.chain[:, 0]

    def count_valid(self, chunk=16384):
        """Number of valid patch slots in the pool, ``[]`` int64 on the
        device, counted ``chunk`` blocks at a time (``valid.sum()`` would
        make a pool-sized temporary, 10 GB at 400,000 blocks)."""
        total = torch.zeros((), dtype=torch.int64, device=self.meta.device)
        for part in self.meta.split(chunk):
            total += (part & 1).sum()
        return total

    def storage_bytes(self):
        """Bytes of the per-slot fields."""
        return sum(getattr(self, f).numel() * getattr(self, f).element_size()
                   for f in self.data_fields())

    def data_fields(self):
        """The per-slot fields (``color`` only when the pool has one)."""
        return _FIELDS + (("color",) if self.color is not None else ())

    @staticmethod
    def from_template(template: MLSGrid, n_particles, num_blocks,
                      chain_len=4, with_color=True, shards=1, dtype=None,
                      device=None):
        """Every particle starts with its own copy of ``template`` in
        block ``i`` (``PoseEstimator.cpp:47-62``; a prebuilt environment
        grid gives the clone-from-env seed).  ``dtype``: storage dtype of
        the float fields, float32 or bfloat16 (a ``torch.dtype`` or its
        name; default the template's)."""
        _single_shard(shards)
        if num_blocks < n_particles:
            raise ValueError("the pool must hold one block per particle")
        if isinstance(dtype, str):
            dtype = getattr(torch, dtype)
        dtype = dtype or template.mean.dtype
        device = torch.device(device or template.mean.device)
        nx, ny, k = template.nx, template.ny, template.k
        b, n = num_blocks, n_particles

        def tile(x, dt):
            x = x.reshape(nx, -1).to(device=device, dtype=dt)
            out = torch.zeros((b,) + x.shape, dtype=dt, device=device)
            out[:n] = x
            return out

        meta = pack_meta(template.valid, template.horizontal,
                         template.update_idx)
        chain = torch.full((n, chain_len), -1, dtype=torch.int32,
                           device=device)
        chain[:, 0] = torch.arange(n, dtype=torch.int32, device=device)
        allocated = torch.zeros(b, dtype=torch.bool, device=device)
        allocated[:n] = True
        return MapPool(
            mean=tile(template.mean, dtype),
            stdev=tile(template.stdev, dtype),
            height=tile(template.height, dtype),
            meta=tile(meta, torch.int32),
            color=tile(template.color, dtype) if with_color else None,
            origin=template.origin.to(device=device, dtype=torch.float32)
            .expand(b, 2).contiguous(),
            allocated=allocated, chain=chain,
            resolution=template.resolution, nx=nx, ny=ny, k=k,
        )

    def refcounts(self):
        """References to each block over all chain entries ``[B]``."""
        flat = self.chain.reshape(-1).long()
        idx = torch.where(flat >= 0, flat, torch.full_like(flat, self.b))
        counts = torch.zeros(self.b + 1, dtype=torch.int32,
                             device=flat.device)
        counts.scatter_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
        return counts[:self.b]

    def resample(self, idx):
        """Duplicate chains along a resampling index map (O(N) ints; the
        reference deep-copies maps, ``cloneMaps``).  The fields are
        shared with ``self``."""
        return dataclasses.replace(self, chain=self.chain.index_select(0, idx))


def _copy_blocks(pool: MapPool, dst, src, mask):
    """``pool[dst[i]] <- pool[src[i]]`` where ``mask[i]``, in place (unique
    masked ``dst``, none of them a ``src``).  Rows with ``mask`` off copy
    their source onto itself."""
    d = torch.where(mask, dst, src).long()
    s = src.long()
    for f in pool.data_fields():
        a = getattr(pool, f)
        a.index_copy_(0, d, a.index_select(0, s))
    pool.origin.index_copy_(0, d, pool.origin.index_select(0, s))


def _allocate(pool: MapPool, want_mask, shards=1):
    """A distinct free (unreferenced) block for each particle with
    ``want_mask``, lowest ids first.  Returns ``(new_block [N] int32, -1
    where none was free, n_failed [] int32)``."""
    _single_shard(shards)
    free = pool.refcounts() == 0
    order = torch.argsort((~free).to(torch.int8), stable=True)  # frees first
    n_free = free.sum()
    rank = torch.cumsum(want_mask.to(torch.int32), 0) - 1
    ok = want_mask & (rank < n_free)
    picked = order.index_select(0, rank.clamp(0, pool.b - 1).long())
    new_block = torch.where(ok, picked, -1).to(torch.int32)
    n_failed = (want_mask.sum() - ok.sum()).to(torch.int32)
    return new_block, n_failed


def ensure_unique_active(pool: MapPool, shards=1):
    """Copy-on-write: give every particle an exclusively owned head
    block (the lowest-index particle keeps a shared one).  In place;
    returns ``(pool, n_failed)`` -- ``n_failed`` particles stay on a
    shared block because the pool ran out."""
    active = pool.active()
    n = pool.n
    idx = torch.arange(n, dtype=torch.int32, device=active.device)
    owner = torch.full((pool.b,), n, dtype=torch.int32, device=active.device)
    owner.scatter_reduce_(0, active.long(), idx, reduce="amin",
                          include_self=True)
    is_dup = idx != owner.index_select(0, active.long())

    new_block, n_failed = _allocate(pool, is_dup, shards)
    do = new_block >= 0
    _copy_blocks(pool, new_block, active, do)
    head = torch.where(do, new_block, active)
    pool.allocated.index_fill_(0, head.long(), True)
    pool.chain[:, 0] = head
    return pool, n_failed


def rollover(pool: MapPool, xy, threshold, shards=1):
    """Start an empty head grid centred on each particle that left its
    active grid by more than ``threshold`` along x or y
    (``MLSMap::selectActiveGrid``, ``EmbodiedSlamFilter.cpp:195-207``);
    the chain shifts and drops its oldest block.  ``xy [N, 2]``.  In
    place; returns ``(pool, n_failed)``."""
    # half sizes as scalars: a tensor made from host values would be a
    # blocking host-to-device copy
    hx, hy = pool.nx * pool.resolution / 2.0, pool.ny * pool.resolution / 2.0
    active = pool.active()
    org = pool.origin.index_select(0, active.long())
    need = (((xy[:, 0] - (org[:, 0] + hx)).abs() > threshold)
            | ((xy[:, 1] - (org[:, 1] + hy)).abs() > threshold))

    new_block, n_failed = _allocate(pool, need, shards)
    do = new_block >= 0
    d = torch.where(do, new_block, active).long()
    keep = ~do[:, None, None]
    pool.meta.index_copy_(0, d, torch.where(
        keep, pool.meta.index_select(0, d), 0))
    new_origin = torch.stack([xy[:, 0] - hx, xy[:, 1] - hy], dim=-1)
    pool.origin.index_copy_(0, d, torch.where(
        do[:, None], new_origin, pool.origin.index_select(0, d)))
    pool.allocated.index_copy_(0, d, do | pool.allocated.index_select(0, d))
    shifted = torch.cat([new_block[:, None], pool.chain[:, :-1]], dim=1)
    pool.chain.copy_(torch.where(do[:, None], shifted, pool.chain))
    return pool, n_failed


def make_chain_lookup(pool: MapPool, z_window=3.0):
    """The per-particle map lookup of the measurement update:
    ``lookup(map_id [N], (x, y, z) [N, C])`` searches each particle's
    chain head first (``MLSMap::getPatch``) and returns ``(found, mean,
    stdev)``, through kernel K2 on CUDA tensors and its plain version
    (``ops.chain_lookup``) on CPU tensors.  SoA queries, as
    ``evaluate_pose_batch`` passes them; no fold."""

    def lookup(map_id, points):
        xq, yq, zq = (q.contiguous() for q in points)
        return cl.chain_lookup(
            pool.mean, pool.stdev, pool.meta, pool.origin, pool.resolution,
            pool.chain.index_select(0, map_id.long()).contiguous(),
            (xq, yq, zq), k=pool.k, z_window=z_window)

    lookup.batched = True
    lookup.soa = True
    return lookup


def _world_points(cloud_xy, xy, yaw):
    """``[N, P]`` world x, y of body-frame points under each particle."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    px, py = cloud_xy[:, 0], cloud_xy[:, 1]
    wx = c[:, None] * px[None, :] - s[:, None] * py[None, :] + xy[:, 0:1]
    wy = s[:, None] * px[None, :] + c[:, None] * py[None, :] + xy[:, 1:2]
    return wx, wy


def _active_cells(pool: MapPool, wx, wy):
    """Cells of ``[N, P]`` world points in each particle's active block:
    ``(active, ix, iy, in_bounds)``."""
    active = pool.active()
    origin = pool.origin.index_select(0, active.long())
    inv = inverse_resolution(pool.resolution)
    ix = torch.floor((wx - origin[:, 0:1]) * inv).to(torch.int32)
    iy = torch.floor((wy - origin[:, 1:2]) * inv).to(torch.int32)
    inb = (ix >= 0) & (ix < pool.nx) & (iy >= 0) & (iy < pool.ny)
    return active, ix, iy, inb


def merge_operands(pool: MapPool, xy, yaw, z_offset, offset_stdev,
                   cloud: PatchCloud):
    """The block-merge operands of one scan cloud under every particle's
    pose (``map_pool.py:523-553`` of the JAX package): ``(blk [N],
    lx [N, P], ly, w, wz)`` with the cloud placed by each pose, lifted by
    ``z_offset`` and widened by ``offset_stdev``; masked-out points get
    ``lx = nx``, ``ly = ny`` and ``w = 0``."""
    wx, wy = _world_points(cloud.xy, xy, yaw)
    wz = cloud.z[None, :] + z_offset[:, None]
    var = (cloud.stdev ** 2)[None, :] + (offset_stdev ** 2)[:, None]
    active, ix, iy, inb = _active_cells(pool, wx, wy)
    mask = inb & cloud.valid[None, :]
    w = torch.where(mask, 1.0 / var.clamp(min=1e-12), torch.zeros_like(var))
    return (active.contiguous(), torch.where(mask, ix, pool.nx),
            torch.where(mask, iy, pool.ny), w, w * wz)


def merge_cloud_all(pool: MapPool, xy, yaw, z_offset, offset_stdev,
                    cloud: PatchCloud, update_idx, patch_thickness=0.1,
                    gap_size=1.5, mesh=None):
    """Merge one scan cloud into every particle's active grid at once
    (the reference's per-particle ``pgrid->merge(scanMap, C_s2p,
    offsetPatch)``, ``EmbodiedSlamFilter.cpp:222-227``), in place: the
    operands of ``merge_operands`` fused by kernel K3 (CUDA) or its plain
    version (CPU).  ``update_idx`` is a Python int; heads must be unique
    (``ensure_unique_active``).  One kernel serves every pool, colour
    included (``Config.merge_group`` has no counterpart)."""
    if mesh is not None:
        raise NotImplementedError("a device mesh belongs to the port's "
                                  "multi-GPU slice")
    bm.block_merge(
        pool.mean, pool.stdev, pool.height, pool.meta, pool.color,
        *merge_operands(pool, xy, yaw, z_offset, offset_stdev, cloud),
        update_idx, None if pool.color is None else cloud.color.contiguous(),
        k=pool.k, patch_thickness=patch_thickness, gap_size=gap_size)
    return pool


def apply_negative_cloud_all(pool: MapPool, xy, yaw, z_offset, points,
                             mask, z_margin=0.15):
    """Negative information on every particle's active grid, in place
    (``useNegativeInformation`` of the laser projection,
    ``EmbodiedSlamFilter.cpp:160``): free-space samples ``points [F, 3]``
    (``projection.free_space_points``) placed by each particle's pose
    clear the valid bit of every active-block patch within ``z_margin``
    of a sample.  Call after ``ensure_unique_active`` and before
    ``merge_cloud_all``."""
    wx, wy = _world_points(points[:, :2], xy, yaw)
    wz = points[None, :, 2] + z_offset[:, None]                 # [N, F]
    active, ix, iy, inb = _active_cells(pool, wx, wy)
    m = inb & mask[None, :]
    zero = torch.zeros_like(ix)
    nyk = pool.ny * pool.k
    slots = torch.arange(pool.k, device=ix.device)
    flat = ((active.long()[:, None, None] * pool.nx
             + torch.where(m, ix, zero).long()[..., None]) * nyk
            + torch.where(m, iy, zero).long()[..., None] * pool.k
            + slots)                                            # [N, F, K]
    meta = pool.meta.view(-1)
    old = meta[flat]
    means = pool.mean.view(-1)[flat].float()
    hit = (((old & 1) != 0) & ((means - wz[..., None]).abs() <= z_margin)
           & m[..., None])
    # clearing bit 0 never raises a (non-negative) meta word, so a min
    # over all writers keeps every clear
    meta.scatter_reduce_(0, flat.reshape(-1),
                         torch.where(hit, old & ~1, old).reshape(-1),
                         reduce="amin", include_self=True)
    return pool


def match_cloud_all(pool: MapPool, xy, yaw, z_offset, offset_stdev,
                    cloud: PatchCloud, sampling=10, sigma=0.2,
                    z_window=3.0):
    """Per-particle scan-to-map consistency scores ``[N]`` (the
    reference's ``pgrid->match`` loop, ``EmbodiedSlamFilter.cpp:214-221``):
    every ``sampling``-th cloud patch, placed by the particle's pose,
    looked up in its active grid through the chain lookup with a
    one-level chain (kernel K2 on CUDA), scored by a Gaussian on the
    height residual; missing patches score 0 and the sum is normalised
    by the number of valid sampled patches."""
    sel = torch.arange(0, cloud.p, sampling, device=cloud.xy.device)
    sxy, sz = cloud.xy[sel], cloud.z[sel]
    sstd, sval = cloud.stdev[sel], cloud.valid[sel]
    wx, wy = _world_points(sxy, xy, yaw)
    wz = sz[None, :] + z_offset[:, None]                        # [N, Ps]
    found, mean, stdev = cl.chain_lookup(
        pool.mean, pool.stdev, pool.meta, pool.origin, pool.resolution,
        pool.active()[:, None].contiguous(),
        (wx.contiguous(), wy.contiguous(), wz.contiguous()), k=pool.k,
        z_window=z_window)
    var = (sigma ** 2 + stdev ** 2 + (sstd ** 2)[None, :]
           + (offset_stdev ** 2)[:, None])
    score = torch.exp(-0.5 * (wz - mean) ** 2 / var)
    score = torch.where(sval[None, :] & found, score, torch.zeros_like(score))
    return score.sum(dim=1) / sval.sum().clamp(min=1)
