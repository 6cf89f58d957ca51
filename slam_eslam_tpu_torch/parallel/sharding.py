"""The device mesh of the port: a process group, one rank per card.

Port of ``slam_eslam_tpu.parallel.sharding``.  The JAX package runs one
controller over global arrays on a 1-D ``('dp',)`` device mesh and lets
XLA insert the collectives.  The port runs SPMD over a
``torch.distributed`` process group instead:

* one rank per card, NCCL where each rank has its own card; gloo on the
  CPU, and gloo where several ranks share one card (``transport="host"``:
  collectives on CUDA tensors are staged through host memory; the
  kernels still run on the card, and every report prints the transport);
* every per-particle leaf is split along its leading axis: rank ``r``
  holds particles ``[r N/P, (r+1) N/P)``.  Maps are replicated (shared
  map) or, in a co-located pool (``Config.map_pool_shards == P``),
  split along the block axis: rank ``r`` holds blocks ``[r B/P, (r+1)
  B/P)`` and its particles' chain rows, the block ids kept global;
* collectives are explicit and live on ``Mesh``: ``all_gather`` of
  weights and payloads, ``all_reduce`` of maxima and the centroid's
  sums, ``ring`` hops (``batch_isend_irecv``) and ``all_to_all`` of
  remote block rows.  No exchange is sized by a value read back to the
  host, so every meshed step can be captured into a CUDA graph (the JAX
  package's exchanges are static-shaped under ``jax.jit`` too): the
  ring-hop resample runs a fixed number of rounds and the pool's
  exchanges send fixed, equal splits padded with -1
  (``Mesh.requests``, ``Mesh.answers``).

``particle_sharding``, ``replicated`` (thin ``Placement`` descriptors),
``constrain_particles`` and ``constrain_pool`` (identities) exist for
parity with the JAX API and no code of the port reads them: there is no
compiler to tell where a value lives, and every meshed function already
takes and returns this rank's slice.  ``gather_state`` and
``gather_pool`` read a global value for tests and the dry run (the
counterpart of ``np.asarray`` on a sharded ``jax.Array``).
"""

from __future__ import annotations

import collections
import dataclasses
import socket

import torch
import torch.distributed as dist

# pool fields whose leading axis is the block axis (JAX sharding.py:77)
_POOL_BLOCK_FIELDS = (
    "mean", "stdev", "height", "meta", "color", "origin", "allocated",
)
# collective-safe integer views of the dtypes a collective moves bit for bit
_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
         torch.float16: torch.int16, torch.float64: torch.int64}


@dataclasses.dataclass(eq=False)
class Mesh:
    """A 1-D ``('dp',)`` mesh: this rank's view of the process group.
    ``transport`` is ``"nccl"`` (a card per rank), ``"gloo"`` (CPU
    tensors) or ``"host"`` (CUDA tensors on gloo, staged through host
    memory: ranks that share a card).  ``remote`` counts the rows a rank
    asked of other ranks, by name (the dry run reports it)."""

    group: object
    size: int
    rank: int
    device: torch.device
    backend: str
    transport: str
    axis: str = "dp"
    # the device counters behind ``remote``, by name
    asked: dict = dataclasses.field(default_factory=dict)

    @property
    def remote(self):
        """Rows this rank asked of other ranks so far, by name (host ints:
        a read of the device counters)."""
        return collections.Counter({k: int(v) for k, v in self.asked.items()})

    def describe(self):
        return (f"{self.size} rank(s), backend {self.backend}, transport "
                f"{self.transport}, device {self.device}")

    # ---- slices ------------------------------------------------------
    def bounds(self, n):
        """``(lo, hi)`` of this rank's slice of a leading axis of ``n``."""
        if n % self.size:
            raise ValueError(f"the mesh size {self.size} must divide the "
                             f"particle count {n}")
        nl = n // self.size
        return self.rank * nl, (self.rank + 1) * nl

    def local(self, t):
        """This rank's slice of a global tensor's leading axis."""
        lo, hi = self.bounds(t.shape[0])
        return t[lo:hi]

    # ---- collectives -------------------------------------------------
    def _out(self, t):
        """``t`` as the collective moves it: an integer view of a float
        (bit for bit on every backend), bool as uint8, on the host for
        the host transport."""
        if t.dtype == torch.bool:
            t = t.to(torch.uint8)
        elif t.dtype in _BITS:
            t = t.view(_BITS[t.dtype])
        t = t.contiguous()
        return t.cpu() if self.transport == "host" else t

    def _in(self, t, like):
        """Undo ``_out``: back to ``like``'s dtype and device."""
        t = t.to(like.device)
        if like.dtype == torch.bool:
            return t != 0
        return t.view(like.dtype) if like.dtype in _BITS else t

    def all_gather(self, t):
        """The ranks' equal-sized ``t`` concatenated along dim 0, in rank
        order: ``[P * n, ...]``."""
        if self.size == 1:
            return t.clone()
        src = self._out(t)
        if self.backend == "nccl":
            out = src.new_empty((self.size * src.shape[0],) + src.shape[1:])
            dist.all_gather_into_tensor(out, src, group=self.group)
        else:
            parts = [torch.empty_like(src) for _ in range(self.size)]
            dist.all_gather(parts, src, group=self.group)
            out = torch.cat(parts)
        return self._in(out, t)

    def all_reduce(self, t, op="sum"):
        """A new tensor: ``t`` reduced over the ranks (``"sum"``,
        ``"max"`` or ``"min"``), in arithmetic, not bit views."""
        if self.size == 1:
            return t.clone()
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}[op]
        src = t.to(torch.int32) if t.dtype == torch.bool else t.clone()
        src = src.cpu() if self.transport == "host" else src
        dist.all_reduce(src, op=red, group=self.group)
        src = src.to(t.device)
        return src != 0 if t.dtype == torch.bool else src

    def all_to_all(self, t):
        """``t`` holds ``P`` equal parts along dim 0; part ``j`` goes to
        rank ``j``; returns the parts received, in rank order."""
        if self.size == 1:
            return t.clone()
        src = self._out(t)
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.group)
        return self._in(out, t)

    def requests(self, ids, owner, name):
        """Send ``ids [M]`` to their owners (``owner [M]``, the rank that
        holds each; -1 ids ask nothing) at a fixed shape: every rank
        receives ``M`` ids from each rank, its own in place and -1
        elsewhere (``all_to_all`` in equal splits), ``[P * M]`` in rank
        order.  The ids asked of other ranks are counted as ``name`` on
        the device (``remote``)."""
        ranks = torch.arange(self.size, device=ids.device)[:, None]
        ask = torch.where(owner[None, :] == ranks, ids[None, :],
                          torch.full_like(ids, -1)[None, :])
        asked = ((ids >= 0) & (owner != self.rank)).sum()
        if name not in self.asked:
            self.asked[name] = torch.zeros_like(asked)
        self.asked[name].add_(asked)
        return self.all_to_all(ask.reshape(-1))

    def answers(self, rows, owner):
        """Undo ``requests``: ``rows [P * M, ...]`` answered to the
        ``P * M`` requests received go back in equal splits, and each of
        this rank's ``M`` ids takes the row of its owner (a gather: no
        sum, so every bit, a signed zero too, arrives as sent)."""
        back = self.all_to_all(rows.contiguous())
        m = owner.shape[0]
        return back.index_select(
            0, owner.long() * m + torch.arange(m, device=owner.device))

    def ring(self, tensors, step):
        """Each tensor of rank ``(rank + step) % P`` (sending this rank's
        to ``(rank - step) % P``), by point-to-point sends in one batch."""
        if self.size == 1 or step % self.size == 0:
            return [t.clone() for t in tensors]
        dst = (self.rank - step) % self.size
        src = (self.rank + step) % self.size
        outs = [self._out(t) for t in tensors]
        bufs = [torch.empty_like(o) for o in outs]
        ops = [dist.P2POp(dist.isend, o, dst, group=self.group, tag=i)
               for i, o in enumerate(outs)]
        ops += [dist.P2POp(dist.irecv, b, src, group=self.group, tag=i)
                for i, b in enumerate(bufs)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [self._in(b, t) for b, t in zip(bufs, tensors)]


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def pick_backend(device, world_size):
    """NCCL where every rank of this host has a card of its own, else gloo
    (the CPU, or several ranks on one card)."""
    device = torch.device(device)
    if device.type != "cuda":
        return "gloo"
    return "nccl" if world_size <= torch.cuda.device_count() else "gloo"


def make_mesh(num_devices=None, devices=None, device=None):
    """The 1-D ``('dp',)`` mesh over the current process group.

    ``device``: this rank's device (``devices``, the JAX argument, may
    name it too): the card unless ``"cpu"`` is asked for, by default the
    current one (``parallel.distributed.initialize`` makes it the rank's
    own).  With no process group yet and ``num_devices``
    None or 1, a one-rank group is started on a free local port (NCCL on
    a card, gloo on the CPU).  ``num_devices`` must otherwise equal the
    group's size."""
    from slam_eslam_tpu_torch.utils.device import entry_device

    if device is None and devices is not None:
        device = devices[0] if isinstance(devices, (list, tuple)) else devices
    device = entry_device(device)
    if not dist.is_initialized():
        if num_devices not in (None, 1):
            raise RuntimeError(
                f"make_mesh({num_devices}) needs a process group of "
                f"{num_devices} ranks: start one per rank with "
                "parallel.distributed.initialize")
        dist.init_process_group(
            pick_backend(device, 1),
            init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
            rank=0)
    size = dist.get_world_size()
    if num_devices is not None and num_devices != size:
        raise ValueError(f"make_mesh({num_devices}) over a process group of "
                         f"{size} ranks")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = dist.get_backend()
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("an NCCL process group needs CUDA devices")
    transport = ("nccl" if backend == "nccl"
                 else "host" if device.type == "cuda" else "gloo")
    return Mesh(group=None, size=size, rank=dist.get_rank(), device=device,
                backend=backend, transport=transport)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a value lives on the mesh: split along ``axis`` (the
    particle or block axis) or, with ``axis`` None, the same on every
    rank.  A descriptor for parity with the JAX package's
    ``NamedSharding``."""

    mesh: Mesh
    axis: str | None


def particle_sharding(mesh):
    return Placement(mesh, mesh.axis)


def replicated(mesh):
    return Placement(mesh, None)


def constrain_particles(particles, mesh):
    """Identity: a meshed function already holds this rank's particles
    (``jax.lax.with_sharding_constraint`` has nothing to tell here)."""
    return particles


def constrain_pool(pool, mesh):
    """Identity, for the reason ``constrain_particles`` gives."""
    return pool


def _slice_particles(particles, mesh):
    from slam_eslam_tpu_torch.utils import tree

    return tree.tree_map(lambda a: mesh.local(a).clone(), particles)


def shard_state(state, mesh):
    """A ``PoseEstimatorState`` held whole on every rank -> this rank's:
    the particle slice, everything else (odometry, counters, generator)
    as it is."""
    if mesh is None:
        return state
    return dataclasses.replace(
        state, particles=_slice_particles(state.particles, mesh))


def gather_state(state, mesh):
    """The global ``PoseEstimatorState`` from every rank's slice."""
    if mesh is None:
        return state
    from slam_eslam_tpu_torch.utils import tree

    return dataclasses.replace(state, particles=tree.tree_map(
        mesh.all_gather, state.particles))


def shard_pool(pool, mesh):
    """A ``MapPool`` held whole on every rank -> this rank's block range
    ``[r B/P, (r+1) B/P)`` of the block fields and its particles' chain
    rows (block ids stay global).  The pool must have been built with
    ``shards == mesh.size`` (``MapPool.from_template``), which starts it
    co-located."""
    if mesh is None:
        return pool
    if pool.b % mesh.size or pool.n % mesh.size:
        raise ValueError(f"{mesh.size} ranks must divide the pool's "
                         f"{pool.b} blocks and {pool.n} particles")
    new = {f: mesh.local(getattr(pool, f)).clone()
           for f in _POOL_BLOCK_FIELDS if getattr(pool, f) is not None}
    return dataclasses.replace(pool, chain=mesh.local(pool.chain).clone(),
                               mesh=mesh, **new)


def gather_pool(pool, mesh=None):
    """The global ``MapPool`` from every rank's block range and chain rows
    (a replicated pool: its chain rows gathered)."""
    mesh = mesh or pool.mesh
    if mesh is None:
        return pool
    if pool.mesh is None:
        return dataclasses.replace(pool, chain=mesh.all_gather(pool.chain))
    new = {f: mesh.all_gather(getattr(pool, f))
           for f in _POOL_BLOCK_FIELDS if getattr(pool, f) is not None}
    return dataclasses.replace(pool, chain=mesh.all_gather(pool.chain),
                               mesh=None, **new)
