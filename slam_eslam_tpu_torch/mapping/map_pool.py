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
  skips a pool-wide copy with ``lax.cond(any(mask))``, the port reads
  the mask on the device: kernel ``ops.row_copy`` (CUDA tensors) moves
  the masked rows alone, every field and the origins in one launch of a
  fixed shape, so a copy-on-write or rollover costs the blocks that need
  it and a CUDA graph replays it whatever the mask holds.  CPU tensors
  take its plain version (the masked rows picked on the host).
* The chain lookup and the merge run kernels K2 (``ops.chain_lookup``)
  and K3 (``ops.block_merge``; a cloud beyond K3's 16,384 points,
  ``ops.cloud_merge``) on CUDA tensors, their plain versions on CPU
  tensors.  The float fields are stored as float32 or bfloat16
  (``Config.map_pool_dtype``): every read upcasts (exactly), arithmetic
  is float32, a written slot rounds once, lookups return float32.
  The lookup of a colourless pool is SoA; a colour-carrying pool's
  lookup takes ``[N, C, 3]`` points and also returns the hit patch's
  colour: one plain gather by the slot index that K2 returns
  (``ops.chain_lookup.chain_color``).
* ``shards`` (``Config.map_pool_shards``) splits particles and blocks
  into equal ranges, and a particle takes blocks only from its own range
  (the JAX package's co-location).  The allocation depends on
  ``shards``, never on the device count.

**On a device mesh** (``parallel.sharding.shard_pool``, ``shards`` equal
to the mesh size) each rank holds its range of blocks and its particles'
chain rows, with global block ids, and ``pool.mesh`` is set.  The chain
metadata (refcounts, owners, allocation) is computed from all-gathered
chain rows, identically on every rank; a block copy whose source lives on
another rank moves by ``all_to_all`` of block rows; a chain lookup runs K2
on the levels the rank holds and sends the others to their owners, whose
K2 answers on a one-level view, and the answers combine head first; the
merge runs K3 on the rank's own blocks (heads are co-located by
``ensure_unique_active``).  A meshed pool operation reads nothing back
to the host, so it can be captured into a CUDA graph: every exchange
sends each rank the whole request list with the ids it does not own set
to -1 (``Mesh.requests``), and masked writes replace the writes to a
data-dependent set of rows (``_write_rows``).  It equals the
single-device run with the same ``shards`` bit for bit.  A pool held
whole on every rank with particles split (``shards == 1`` on a mesh, the
replicated mode) is driven by ``filter.streaming`` with gathered chain
rows and poses.
"""

from __future__ import annotations

import dataclasses

import torch

# the meta layout's names, where the JAX package's map_pool defines them
from slam_eslam_tpu_torch.mapping.mls_grid import (  # noqa: F401
    META_HORIZONTAL, META_UIDX_SHIFT, META_VALID, MLSGrid, PatchCloud,
    inverse_resolution, pack_meta)
from slam_eslam_tpu_torch.ops import block_merge as bm
from slam_eslam_tpu_torch.ops import chain_lookup as cl
from slam_eslam_tpu_torch.ops import cloud_merge as cm
from slam_eslam_tpu_torch.ops import row_copy as rc
from slam_eslam_tpu_torch.utils import tracing

_FIELDS = ("mean", "stdev", "height", "meta")


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
    # a block-sharded pool: this rank's block range and chain rows
    mesh: object = None

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
        """Blocks of the whole pool (over every rank of a meshed one)."""
        return self.mean.shape[0] * (1 if self.mesh is None
                                     else self.mesh.size)

    @property
    def bl(self):
        """Blocks this rank holds (all of them without a mesh)."""
        return self.mean.shape[0]

    @property
    def block_offset(self):
        """Global id of this rank's first block."""
        return 0 if self.mesh is None else self.mesh.rank * self.bl

    @property
    def s(self):
        """Patch slots per block (``nx * ny * K``)."""
        return self.nx * self.ny * self.k

    @property
    def n(self):
        return self.chain.shape[0]

    @property
    def chain_len(self):
        return self.chain.shape[1]

    def active(self):
        return self.chain[:, 0]

    def field_grid(self, name):
        """A field as ``[B, nx, ny, K]`` (``[B, nx, ny, K, 3]`` for
        ``color``): a view, for the host and the viewers."""
        a = getattr(self, name)
        trail = (3,) if name == "color" else ()
        return a.reshape((self.bl, self.nx, self.ny, self.k) + trail)

    def count_valid(self, chunk=16384):
        """Number of valid patch slots in the pool, ``[]`` int64 on the
        device, counted ``chunk`` blocks at a time (``valid.sum()`` would
        make a pool-sized temporary, 10 GB at 400,000 blocks)."""
        total = torch.zeros((), dtype=torch.int64, device=self.meta.device)
        for part in self.meta.split(chunk):
            total += (part & 1).sum()
        return total if self.mesh is None else self.mesh.all_reduce(total)

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
        grid gives the clone-from-env seed).  ``shards``: particle i's
        first block lies in block range ``i * shards // N``, so a pool of
        ``shards`` ranges starts co-located (``Config.map_pool_shards``).
        ``dtype``: storage dtype of the float fields, float32 or bfloat16
        (a ``torch.dtype`` or its name; default the template's)."""
        if isinstance(dtype, str):
            dtype = getattr(torch, dtype)
        dtype = dtype or template.mean.dtype
        device = torch.device(device or template.mean.device)
        nx, ny, k = template.nx, template.ny, template.k
        b, n = num_blocks, n_particles
        new = lambda dt, *shape: torch.empty(shape, dtype=dt, device=device)
        pool = MapPool(
            mean=new(dtype, b, nx, ny * k), stdev=new(dtype, b, nx, ny * k),
            height=new(dtype, b, nx, ny * k),
            meta=new(torch.int32, b, nx, ny * k),
            color=new(dtype, b, nx, ny * k * 3) if with_color else None,
            origin=new(torch.float32, b, 2),
            allocated=new(torch.bool, b),
            chain=new(torch.int32, n, chain_len),
            resolution=template.resolution, nx=nx, ny=ny, k=k,
        )
        return pool.refill_(template, shards)

    def refill_(self, template: MLSGrid, shards=1):
        """Write ``from_template(template, ...)`` of this pool's own shape
        (particles, blocks, chain length, colour, storage dtype) into this
        pool's tensors, in place: every particle's own copy of
        ``template`` again, with no second pool.  The JAX runner takes its
        carry donated and XLA reuses the buffers; here a graphed runner
        keeps the pool its graphs were captured on, and a fresh start is
        written into it.  Returns ``self``."""
        if self.mesh is not None:
            raise ValueError("refill_ takes a pool without a mesh")
        if ((template.nx, template.ny, template.k, template.resolution)
                != (self.nx, self.ny, self.k, self.resolution)):
            raise ValueError(
                f"a template of {template.nx}x{template.ny}x{template.k} "
                f"cells at {template.resolution} m cannot refill a pool of "
                f"{self.nx}x{self.ny}x{self.k} at {self.resolution} m")
        b, n = self.bl, self.n
        if b < n:
            raise ValueError("the pool must hold one block per particle")
        if shards > 1 and (n % shards or b % shards):
            raise ValueError(f"shards={shards} must divide particles "
                             f"({n}) and blocks ({b})")
        device = self.mean.device
        i = torch.arange(n, dtype=torch.int32, device=device)
        nl, bl = n // max(shards, 1), b // max(shards, 1)
        assign = i if shards <= 1 else (i // nl) * bl + i % nl
        rows = assign.long()
        meta = pack_meta(template.valid, template.horizontal,
                         template.update_idx)
        for name, x in (("mean", template.mean), ("stdev", template.stdev),
                        ("height", template.height), ("meta", meta),
                        ("color", template.color)):
            field = getattr(self, name)
            if field is None:
                continue
            field.zero_()
            field[rows] = x.reshape(self.nx, -1).to(device=device,
                                                    dtype=field.dtype)
        self.origin.copy_(template.origin.to(device=device,
                                             dtype=torch.float32)
                          .expand(b, 2))
        self.allocated.zero_()
        self.allocated.index_fill_(0, rows, True)
        self.chain.fill_(-1)
        self.chain[:, 0] = assign
        return self

    def global_chain(self):
        """Every particle's chain row ``[N, L]``: the rows of every rank
        of a meshed pool, gathered."""
        return (self.chain if self.mesh is None
                else self.mesh.all_gather(self.chain))

    def refcounts(self):
        """References to each block over all chain entries ``[B]`` (of
        every rank's particles on a mesh)."""
        return _refcounts(self.global_chain(), self.b)

    def resample(self, idx, mesh=None):
        """Duplicate chains along a resampling index map (O(N) ints; the
        reference deep-copies maps, ``cloneMaps``).  The fields are
        shared with ``self``.  On a mesh (``mesh``, or the pool's own)
        ``idx`` holds the global source of each of this rank's rows, and
        the chain rows are all-gathered first."""
        mesh = mesh or self.mesh
        chain = self.chain if mesh is None else mesh.all_gather(self.chain)
        return dataclasses.replace(self, chain=chain.index_select(0, idx))

    def resample_(self, idx):
        """``resample`` in place: the new chain rows are written into
        ``self.chain``, whose storage a captured CUDA graph keeps (no
        mesh).  Returns ``self``."""
        if self.mesh is not None:
            raise ValueError("resample_ takes a pool without a mesh")
        self.chain.copy_(self.chain.index_select(0, idx))
        return self


def _copy_blocks(pool: MapPool, dst, src, mask):
    """``pool[dst[i]] <- pool[src[i]]`` where ``mask[i]``, every field and
    the origin, in place (unique masked ``dst``, none of them a ``src``).
    Rows with ``mask`` off are not touched: one ``ops.row_copy`` launch
    moves the masked rows alone (its plain version on CPU tensors).  On a
    mesh ``dst`` lies in this rank's range and ``src`` anywhere
    (``fetch_rows``), written at a fixed shape (``_write_rows``)."""
    if pool.mesh is not None:
        rows = fetch_rows(pool, torch.where(mask, src, -1),
                          pool.data_fields() + ("origin",), "block copy")
        for f, r in rows.items():
            _write_rows(getattr(pool, f), dst - pool.block_offset, r, mask)
        return
    rc.row_copy([getattr(pool, f) for f in pool.data_fields() + ("origin",)],
                dst, src.contiguous(), mask)


def fetch_rows(pool: MapPool, ids, names, what):
    """Rows of global blocks ``ids [M]`` of the fields ``names`` of a
    meshed pool, wherever they live: each rank sends the ids it needs to
    their owners, which send the rows back (``Mesh.requests``, at a fixed
    shape: each owner answers every rank's ``M`` requests, -1 padded; the
    rows asked of other ranks are counted as ``what``).  An id of -1 asks
    nothing and gets an arbitrary row.  Returns ``{name: [M, ...]}``."""
    mesh, bl = pool.mesh, pool.bl
    ids = ids.long()
    owner = torch.where(ids >= 0, ids // bl, 0)
    req = mesh.requests(ids - owner * bl, owner, what).clamp(min=0)
    return {name: mesh.answers(getattr(pool, name).index_select(0, req),
                               owner)
            for name in names}


def _write_rows(field, rows, values, mask):
    """``field[rows[i]] = values[i]`` where ``mask[i]`` (the masked
    ``rows`` unique), in place, at a fixed shape: an entry with ``mask``
    off writes what the first masked entry writes, or, when none is
    masked, row 0 its own content, so no row takes two different
    values."""
    any_ = mask.any()
    first = torch.argmax(mask.to(torch.int8)).reshape(1)
    rows = torch.where(mask, rows, torch.where(
        any_, rows.index_select(0, first)[0], 0)).long()
    fill = torch.where(any_, values.index_select(0, first)[0], field[0])
    field.index_copy_(0, rows, torch.where(
        mask.reshape((-1,) + (1,) * (values.dim() - 1)), values, fill))


def _refcounts(chain, b):
    """References to each of ``b`` blocks over the entries of ``chain``."""
    flat = chain.reshape(-1).long()
    idx = torch.where(flat >= 0, flat, torch.full_like(flat, b))
    counts = torch.zeros(b + 1, dtype=torch.int32, device=flat.device)
    counts.scatter_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return counts[:b]


def _allocate_chains(chain, b, want_mask, shards=1):
    """``_allocate`` over every particle's chain row ``chain [N, L]`` and a
    pool of ``b`` blocks."""
    free = _refcounts(chain, b) == 0
    n = chain.shape[0]
    s = max(shards, 1)
    nl, bl = n // s, b // s
    free_r, want_r = free.reshape(s, bl), want_mask.reshape(s, nl)
    # every range's free blocks first, lowest ids first
    order = torch.argsort((~free_r).to(torch.int8), dim=1, stable=True)
    n_free = free_r.sum(1, keepdim=True)
    rank = torch.cumsum(want_r.to(torch.int32), 1) - 1
    ok = want_r & (rank < n_free)
    picked = order.gather(1, rank.clamp(0, bl - 1).long()) + (
        torch.arange(s, device=chain.device) * bl)[:, None]
    new_block = torch.where(ok, picked, -1).to(torch.int32).reshape(n)
    n_failed = (want_mask.sum() - ok.sum()).to(torch.int32)
    return new_block, n_failed


def _allocate(pool: MapPool, want_mask, shards=1):
    """A distinct free (unreferenced) block for each particle with
    ``want_mask``, lowest ids first; with ``shards`` ranges, particle range
    ``s`` takes blocks of block range ``s`` only.  Returns ``(new_block
    [N] int32, -1 where none was free, n_failed [] int32)``.  On a mesh
    the masks and chain rows of every rank are gathered, every rank
    computes the same allocation, and ``new_block`` is this rank's rows;
    ``n_failed`` counts every rank's particles."""
    mesh = pool.mesh
    if mesh is None:
        return _allocate_chains(pool.chain, pool.b, want_mask, shards)
    if shards != mesh.size:
        raise ValueError(f"a pool split over {mesh.size} ranks allocates in "
                         f"{mesh.size} block ranges, not {shards} "
                         f"(Config.map_pool_shards)")
    new_block, n_failed = _allocate_chains(
        pool.global_chain(), pool.b, mesh.all_gather(want_mask), shards)
    return mesh.local(new_block), n_failed


def ensure_unique_active(pool: MapPool, shards=1):
    """Copy-on-write: give every particle an exclusively owned head
    block (the lowest-index particle keeps a shared one).  With ``shards >
    1`` a head outside the particle's block range (a resample moved the
    particle across ranges) is re-homed into its own range, the
    co-location a meshed merge relies on.  In place; returns ``(pool,
    n_failed)`` -- ``n_failed`` particles stay on a shared or foreign
    block because the pool ran out."""
    chain = pool.global_chain()
    active_all = chain[:, 0]
    n, b = chain.shape[0], pool.b
    dev = active_all.device
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    owner = torch.full((b,), n, dtype=torch.int32, device=dev)
    owner.scatter_reduce_(0, active_all.long(), idx, reduce="amin",
                          include_self=True)
    is_dup = idx != owner.index_select(0, active_all.long())
    if shards > 1:
        is_dup |= (idx // (n // shards)) != (active_all // (b // shards))

    new_block, n_failed = _allocate_chains(chain, b, is_dup, shards)
    active = pool.active()
    if pool.mesh is not None:
        if shards != pool.mesh.size:
            raise ValueError(f"a pool split over {pool.mesh.size} ranks "
                             f"needs shards={pool.mesh.size}")
        new_block = pool.mesh.local(new_block)
    do = new_block >= 0
    _copy_blocks(pool, new_block, active, do)
    _count_rows(do, "pool.heads_copied", n_failed)
    head = torch.where(do, new_block, active)
    if pool.mesh is None:
        pool.allocated.index_fill_(0, head.long(), True)
    else:
        _write_rows(pool.allocated, new_block - pool.block_offset,
                    torch.ones_like(do), do)
    pool.chain[:, 0] = head
    return pool, n_failed


def _count_rows(do, name, n_failed):
    """The tracer's counters of one copy-on-write or rollover
    (``utils.tracing.count``; nothing while no mark is taken): the head
    rows it wrote, the rows ``do`` marks (``ops.row_copy`` writes every
    masked row or traps, and no other), the same rows as ``name``, and the
    particles the pool had no block for.  Counted with sums alone, so
    ``pool.head_rows_moved`` equals ``pool.heads_copied`` plus
    ``pool.heads_started`` by construction."""
    tracing.count("pool.head_rows_moved", do)
    tracing.count(name, do)
    tracing.count("pool.alloc_failed", n_failed)


def _head_origins(pool: MapPool, active):
    """Origins ``[N, 2]`` of the blocks ``active [N]`` (global ids)."""
    if pool.mesh is None:
        return pool.origin.index_select(0, active.long())
    return fetch_rows(pool, active, ("origin",), "head origins")["origin"]


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
    org = _head_origins(pool, active)
    need = (((xy[:, 0] - (org[:, 0] + hx)).abs() > threshold)
            | ((xy[:, 1] - (org[:, 1] + hy)).abs() > threshold))

    new_block, n_failed = _allocate(pool, need, shards)
    do = new_block >= 0
    new_origin = torch.stack([xy[:, 0] - hx, xy[:, 1] - hy], dim=-1)
    if pool.mesh is None:
        # the new heads' meta zeroed and origins set, their rows alone
        rc.row_copy((pool.meta, pool.origin), new_block, None, do,
                    fill=(None, new_origin))
        d = torch.where(do, new_block, active).long()
        pool.allocated.index_copy_(0, d,
                                   do | pool.allocated.index_select(0, d))
    else:
        # every new block lies in this rank's range
        d = new_block - pool.block_offset
        _write_rows(pool.meta, d, pool.meta.new_zeros(
            (1,) + pool.meta.shape[1:]).expand((d.shape[0],)
                                               + pool.meta.shape[1:]), do)
        _write_rows(pool.origin, d, new_origin, do)
        _write_rows(pool.allocated, d, torch.ones_like(do), do)
    _count_rows(do, "pool.heads_started", n_failed)
    shifted = torch.cat([new_block[:, None], pool.chain[:, :-1]], dim=1)
    pool.chain.copy_(torch.where(do[:, None], shifted, pool.chain))
    return pool, n_failed


def _chain_lookup_meshed(pool: MapPool, chain, queries, z_window):
    """K2 over a meshed pool: ``chain [N, L]`` (global ids, this rank's
    particles) and SoA ``queries``.  The levels this rank holds run here;
    every other level goes, with its particle's queries, to the rank that
    holds its block, whose K2 answers on a one-level view; the answers
    combine head first.  Returns ``(found, mean, stdev, color or None)``,
    what ``chain_lookup`` and ``chain_color`` give on the whole pool, bit
    for bit."""
    mesh, off, bl = pool.mesh, pool.block_offset, pool.bl
    n, levels = chain.shape
    xq, yq, zq = queries
    c = xq.shape[1]
    with_color = pool.color is not None
    fields = (pool.mean, pool.stdev, pool.meta, pool.origin, pool.resolution)
    here = (chain >= off) & (chain < off + bl)
    chain_here = torch.where(here, chain - off, -1).to(torch.int32)
    found, mean, stdev, slot = cl.chain_lookup(
        *fields, chain_here.contiguous(), queries, k=pool.k,
        z_window=z_window, with_slot=True)
    # the level of each local hit, from the block of its slot
    blk = torch.div(slot, pool.s, rounding_mode="floor")
    level = torch.argmax(
        (chain_here[:, :, None] == blk[:, None, :]).to(torch.int8), dim=1)
    level = torch.where(found, level, levels)

    # the other levels, on the ranks that hold them: every (particle,
    # level) item goes to every rank with its block id where that rank
    # owns a far level and -1 elsewhere, with its particle's queries; each
    # rank's K2 answers all of them on a one-level view (-1: no hit), and
    # each far item takes its owner's answer.  One rank holds every level,
    # so it sends nothing.
    far = (chain >= 0) & ~here
    rows = torch.arange(n, device=chain.device)[:, None] * (levels + 1)
    cols = torch.arange(c, device=chain.device)
    at_local = ((rows + level) * c + cols).reshape(-1)    # element (p, c)
    parts = None
    if mesh.size > 1:
        ids = chain.reshape(-1).long()                    # item (p, level)
        farf = far.reshape(-1)
        owner = torch.where(farf, ids // bl, 0)
        req = mesh.requests(torch.where(farf, ids - owner * bl, -1), owner,
                            "chain lookup")
        sent = lambda q: mesh.all_to_all(
            q.repeat_interleave(levels, 0)[None].expand(
                (mesh.size,) + (n * levels, c)).reshape(-1, c).contiguous())
        a = cl.chain_lookup(*fields, req.to(torch.int32)[:, None]
                            .contiguous(), tuple(sent(q) for q in queries),
                            k=pool.k, z_window=z_window,
                            with_slot=with_color)
        back = lambda t: mesh.answers(t, owner)
        parts = [back(a[0]), back(a[1]), back(a[2])]
        if with_color:
            parts.append(back(cl.chain_color(pool.color, a[3])))
        farc = farf[:, None]

    # every level's answer [N, L + 1, C] (level L: no local hit), then the
    # first level that hits
    def spread(local, part, trail=()):
        out = local.new_zeros((n * (levels + 1), c) + trail)
        if part is not None:
            mask = farc.reshape(farc.shape + (1,) * len(trail))
            out.view(n, levels + 1, c, *trail)[:, :levels] = torch.where(
                mask, part, torch.zeros((), dtype=part.dtype,
                                        device=part.device)).view(
                n, levels, c, *trail)
        out.view(-1, *trail)[at_local] = local.reshape(-1, *trail)
        return out.view(n, levels + 1, c, *trail)[:, :levels]

    part = lambda i: None if parts is None else parts[i]
    hit = spread(found, part(0))
    first = torch.argmax(hit.to(torch.int8), dim=1, keepdim=True)  # [N,1,C]
    out_found = hit.any(1)
    pick = lambda t: torch.where(out_found, t.gather(1, first)[:, 0],
                                 torch.zeros((), dtype=t.dtype,
                                             device=t.device))
    out = (out_found, pick(spread(mean, part(1))),
           pick(spread(stdev, part(2))))
    if not with_color:
        return out + (None,)
    col = spread(cl.chain_color(pool.color, torch.where(found, slot, -1)),
                 part(3), (3,))
    col = torch.where(out_found[..., None],
                      col.gather(1, first[..., None].expand(-1, -1, -1, 3))
                      [:, 0], 0.0)
    return out + (col,)


def make_chain_lookup(pool: MapPool, z_window=3.0, mesh=None):
    """The per-particle map lookup of the measurement update:
    ``lookup(map_id [N], points)`` searches each particle's chain head
    first (``MLSMap::getPatch``), through kernel K2 on CUDA tensors and
    its plain version (``ops.chain_lookup``) on CPU tensors; no fold.

    On a colourless pool ``points`` are SoA queries ``(x, y, z)``, each
    ``[N, C]``, as ``evaluate_pose_batch`` passes them to a ``soa`` lookup,
    and the result is ``(found, mean, stdev)``.  On a colour-carrying pool
    ``points`` is ``[N, C, 3]`` and the result ``(found, mean, stdev,
    color [N, C, 3])``, as the JAX package's ``chain_lookup`` returns it
    (the slip update reads the terrain class off the patch colour).

    On a mesh (``mesh``, or the pool's own) ``map_id`` holds global
    particle ids and ``pool.chain`` this rank's rows; a meshed pool's
    lookup reaches the levels other ranks hold (``_chain_lookup_meshed``)."""
    with_color = pool.color is not None
    mesh = mesh or pool.mesh

    def lookup(map_id, points):
        if with_color:
            points = points.unbind(-1)
        queries = tuple(q.contiguous() for q in points)
        rows = map_id.long()
        if mesh is not None:
            rows = rows - mesh.rank * pool.n
        chain = pool.chain.index_select(0, rows).contiguous()
        if pool.mesh is not None:
            out = _chain_lookup_meshed(pool, chain, queries, z_window)
            return out if with_color else out[:3]
        out = cl.chain_lookup(pool.mean, pool.stdev, pool.meta, pool.origin,
                              pool.resolution, chain, queries, k=pool.k,
                              z_window=z_window, with_slot=with_color)
        if not with_color:
            return out
        return out[:3] + (cl.chain_color(pool.color, out[3]),)

    lookup.batched = True
    lookup.soa = not with_color
    return lookup


def chain_lookup(pool: MapPool, z_window=3.0):
    """The JAX package's per-particle chain lookup callback:
    ``lookup(particle_idx, points [..., C, 3]) -> (found, mean, stdev,
    color)``, head first, for one particle (a scalar index) or a batch
    (``particle_idx [N]`` with ``points [N, C, 3]``).  ``color`` is zeros
    on a colourless pool.  Through ``make_chain_lookup`` (K2 on CUDA
    tensors)."""
    lk = make_chain_lookup(pool, z_window)

    def lookup(particle_idx, points):
        idx = torch.as_tensor(particle_idx, device=pool.chain.device)
        single = idx.dim() == 0
        pts = torch.as_tensor(points, dtype=torch.float32,
                              device=pool.chain.device)
        if single:
            idx, pts = idx[None], pts[None]
        if pool.color is None:
            f, m, s = lk(idx, tuple(pts.unbind(-1)))
            col = m.new_zeros(m.shape + (3,))
        else:
            f, m, s, col = lk(idx, pts)
        out = (f, m, s, col)
        return tuple(t[0] for t in out) if single else out

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
    ``(active, ix, iy, in_bounds)``, with ``active`` the block's row in
    this rank's fields.  On a mesh a head that lies on another rank (one
    that pool exhaustion left un-homed) has no point in bounds: the rank
    cannot write it, as the JAX package's shard-local merge cannot."""
    active = pool.active()
    here = None
    if pool.mesh is not None:
        active = active - pool.block_offset
        here = (active >= 0) & (active < pool.bl)
        active = torch.where(here, active, 0)
    origin = pool.origin.index_select(0, active.long())
    inv = inverse_resolution(pool.resolution)
    ix = torch.floor((wx - origin[:, 0:1]) * inv).to(torch.int32)
    iy = torch.floor((wy - origin[:, 1:2]) * inv).to(torch.int32)
    inb = (ix >= 0) & (ix < pool.nx) & (iy >= 0) & (iy < pool.ny)
    if here is not None:
        inb &= here[:, None]
    return active, ix, iy, inb


def _merge_heads(pool: MapPool):
    """Each particle's head as a row of this rank's fields, -1 where it
    lies on another rank (one that pool exhaustion left un-homed): the
    rank cannot write it, as the JAX package's shard-local merge cannot."""
    active = pool.active()
    if pool.mesh is None:
        return active
    active = active - pool.block_offset
    return torch.where((active >= 0) & (active < pool.bl), active, -1)


def merge_operands(pool: MapPool, xy, yaw, z_offset, offset_stdev,
                   cloud: PatchCloud):
    """The block-merge operands of one scan cloud under every particle's
    pose (``map_pool.py:523-553`` of the JAX package): ``(blk [N],
    lx [N, P], ly, w, wz)`` with the cloud placed by each pose, lifted by
    ``z_offset`` and widened by ``offset_stdev``; masked-out points get
    ``lx = nx``, ``ly = ny`` and ``w = 0`` (``ops.cloud_merge.operands``,
    which the cloud merge places inside its kernel)."""
    heads = _merge_heads(pool)
    ops = cm.operands(pool.origin, heads, xy[:, 0], xy[:, 1], torch.cos(yaw),
                      torch.sin(yaw), z_offset, offset_stdev, cloud.xy,
                      cloud.z, cloud.stdev, cloud.valid, pool.nx, pool.ny,
                      inverse_resolution(pool.resolution))
    return (heads.clamp(min=0).contiguous(), *ops)


def merge_cloud_all(pool: MapPool, xy, yaw, z_offset, offset_stdev,
                    cloud: PatchCloud, update_idx, patch_thickness=0.1,
                    gap_size=1.5, mesh=None):
    """Merge one scan cloud into every particle's active grid at once
    (the reference's per-particle ``pgrid->merge(scanMap, C_s2p,
    offsetPatch)``, ``EmbodiedSlamFilter.cpp:222-227``), in place: the
    operands of ``merge_operands`` fused by kernel K3 (CUDA) or its plain
    version (CPU).  ``update_idx`` is a Python int or a 0-d int32 tensor
    on the pool's device (what a CUDA graph replays: the merge stamps the
    value the tensor holds then); heads must be unique
    (``ensure_unique_active``).  One kernel serves every pool, colour
    included (``Config.merge_group`` has no counterpart).  A meshed pool
    merges each rank's particles into its own blocks, K3 run shard-locally
    with ``blk = active - rank * B/P`` (JAX ``map_pool.py:581-593``);
    ``mesh`` is accepted for the JAX call shape and the pool's own is
    used.

    A cloud of more than ``block_merge.MAX_POINTS`` points takes kernel
    ``ops.cloud_merge`` instead (its plain version on the CPU): the same
    merge, its operands placed inside the kernel from the cloud ``[P]`` and
    the poses ``[N]``, with no ``[N, P]`` tensor.  While the tracer takes
    marks, that merge counts ``merge.points`` (the valid placements in a
    block) and ``merge.cells`` (the cells written) on the device."""
    if cloud.p <= bm.MAX_POINTS:
        bm.block_merge(
            pool.mean, pool.stdev, pool.height, pool.meta, pool.color,
            *merge_operands(pool, xy, yaw, z_offset, offset_stdev, cloud),
            update_idx,
            None if pool.color is None else cloud.color.contiguous(),
            k=pool.k, patch_thickness=patch_thickness, gap_size=gap_size)
        return pool
    heads = _merge_heads(pool)
    counters = (torch.zeros(2, dtype=torch.int64, device=heads.device)
                if tracing.marking() else None)
    cm.cloud_merge(
        pool.mean, pool.stdev, pool.height, pool.meta, pool.color,
        pool.origin, heads.contiguous(), xy[:, 0].contiguous(),
        xy[:, 1].contiguous(), torch.cos(yaw), torch.sin(yaw),
        z_offset.contiguous(), offset_stdev.contiguous(),
        cloud.xy.contiguous(), cloud.z.contiguous(),
        cloud.stdev.contiguous(), cloud.valid.contiguous(),
        None if pool.color is None else cloud.color.contiguous(),
        update_idx, counters, k=pool.k, resolution=pool.resolution,
        patch_thickness=patch_thickness, gap_size=gap_size)
    if counters is not None:
        tracing.count("merge.points", counters[0])
        tracing.count("merge.cells", counters[1])
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
    heads = pool.active()[:, None].contiguous()
    queries = (wx.contiguous(), wy.contiguous(), wz.contiguous())
    if pool.mesh is not None:
        found, mean, stdev, _ = _chain_lookup_meshed(pool, heads, queries,
                                                     z_window)
    else:
        found, mean, stdev = cl.chain_lookup(
            pool.mean, pool.stdev, pool.meta, pool.origin, pool.resolution,
            heads, queries, k=pool.k, z_window=z_window)
    var = (sigma ** 2 + stdev ** 2 + (sstd ** 2)[None, :]
           + (offset_stdev ** 2)[:, None])
    score = torch.exp(-0.5 * (wz - mean) ** 2 / var)
    score = torch.where(sval[None, :] & found, score, torch.zeros_like(score))
    return score.sum(dim=1) / sval.sum().clamp(min=1)
