"""CUDA graphs: the port's counterpart of the JAX package's compiled runners.

The JAX package never runs its benchmark paths as a loop of host
dispatches: ``filter.step.make_filter_step`` returns ``jax.jit(step)``,
``make_scan_runner`` is one jitted ``lax.scan`` and
``streaming.make_slam_scan_runner`` a jitted, donated ``lax.scan``.  Here
a step's launches are captured into a CUDA graph once per shape and per
gate combination (a *key*), and replayed: the host issues one graph
launch a step in place of the step's few hundred kernel launches.

The discipline (``StepGraphs``):

* A step reads **static buffers**: the carry (the runner's own copy of
  the state, or for a map pool the caller's tensors, updated in place)
  and the per-step inputs, which each step first fills with ``copy_``
  (device to device; ``copy_into`` groups the copies by dtype, one
  ``torch._foreach_copy_`` a group).  The captured region ends by
  writing the new carry back into the carry's own tensors and the step's
  outputs into static output tensors, which the runner copies into its
  per-run ``[T, ...]`` outputs after every step: nothing a caller keeps
  is a view of a static buffer.
* A key's **first meeting runs eagerly** on the static buffers: that run
  builds the kernels (``nvcc``), fills the lazy caches (the extrinsics of
  ``streaming.make_slam_step``, the ordered scan's state) and warms the
  allocator.  The **second meeting captures** and then replays, since a
  capture records the step's work and runs none of it; every later
  meeting replays.  A failed capture raises: nothing falls back to eager.
* Every graph of a runner allocates from **one memory pool**
  (``torch.cuda.graph_pool_handle``): a graph keeps the temporaries of
  its capture for as long as it lives (at 100,000 particles the block
  copies' ``index_select`` of every head block is gigabytes), and graphs
  that never run at once can share them.  One ``Capture`` serves every
  graph of one ``EmbodiedSlamFilter``, its ``run_stream`` runners
  included.
* The state's own ``torch.Generator`` draws inside the graph: the runner
  keeps a static generator, registered with every graph
  (``CUDAGraph.register_generator_state``), loads the caller's
  generator state into it before a run and writes it back after, so a
  replay advances the generator's offset exactly as the eager step does
  and a graphed run draws the numbers an eager run draws from the same
  seed.
* The kernel wrappers count launches on the host (``ops.launch_counts``),
  which a replay never reaches: the launches a capture records are
  credited on every replay, and the capture itself counts none.
* A graph also bakes in the address of every tensor **outside** the carry
  and the inputs that its capture read (a map, a lookup's tables, a
  hash's candidates).  ``StepGraphs(reads=...)`` names them per key; their
  addresses are recorded at the capture and compared at every replay,
  which raises (``StaleRead``) when one moved: what replaces such a
  tensor must write into its storage instead.

``Capture`` is what captures and replays, on the card.  A runner takes
another object with its methods (``graph=`` of the runners), so the CPU
tests can drive the discipline with a stand-in that runs the step at each
replay.

**The default** (``graph=None`` of every runner, ``resolve``): graphs
where they can run, as the JAX package's runners default to
``jit=True``: on a CUDA device with no mesh or an NCCL mesh.  The CPU and
a gloo or ``"host"`` mesh (collectives staged through the host, which no
capture records) run the eager loop; there ``graph=True`` raises.  No
host read sizes a meshed exchange (``parallel.sharding``), so a meshed
step captures as an unmeshed one does.  Every runner, filter and builder
takes its mode from ``resolve``.

``CallGraphs`` is the counterpart of a ``jax.jit`` with static
arguments for a function that is not a step of a runner: the pose-graph
solves and the keyframe alignment, the stages of ``tools.profile_step``,
the step of ``examples.localize_demo`` and the evaluation of
``tools.stat_map_test``, one graph per key of its static arguments.

**Under a profiler** every capture and every replay of a ``StepGraphs``
is a span named ``CAPTURE_SPAN`` / ``REPLAY_SPAN`` and the graph's number
(one number per graph of the process): ``tools.profile_slam`` reads from
a capture's span the launches its graph holds, each with the operator
that made it, and from a replay's span which graph a ``cudaGraphLaunch``
ran.  Without a profiler no span is made.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools

import torch

from slam_eslam_tpu_torch import ops


class Capture:
    """CUDA graphs on the card: ``torch.cuda.CUDAGraph``, one memory pool
    for every graph of the runners (or the filter) that share this
    object; their graphs never run at once."""

    def __init__(self):
        self._pool = None

    def check(self, device, what):
        """Raise unless ``device`` is a CUDA device."""
        if torch.device(device).type != "cuda":
            raise ValueError(
                f"{what}(graph=True) captures CUDA graphs and needs a CUDA "
                f"device, not {device}: the CPU runs the eager loop "
                f"(graph=False, or the default graph=None)")

    def new_graph(self):
        return torch.cuda.CUDAGraph()

    def capture(self, graph, fn, generators=(), writes=()):
        """Record ``fn()`` into ``graph`` with the runner's pool, the
        ``generators`` registered; ``writes`` (the tensors the region
        writes) matter only to a stand-in that runs the region."""
        del writes
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        for gen in generators:
            graph.register_generator_state(gen)
        with torch.cuda.graph(graph, pool=self._pool):
            fn()

    def replay(self, graph):
        graph.replay()


CAPTURE_SPAN = "graph capture "
REPLAY_SPAN = "graph replay "
_GRAPH_NUMBERS = itertools.count()


def span(name):
    """A ``torch.profiler`` span named ``name`` while a profiler runs,
    else nothing (a replay's host time stays as it was)."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


class StaleRead(RuntimeError):
    """A tensor that a captured graph reads was replaced after the
    capture: a replay would read the old storage."""


def capture_of(graph):
    """The capture object a runner's ``graph=`` names: None for False, a
    new ``Capture`` for True, else the object given (a stand-in)."""
    if graph is False or graph is None:
        return None
    return Capture() if graph is True else graph


def supported(device, mesh=None):
    """Whether CUDA graphs run a runner on ``device`` over ``mesh``: a
    CUDA device, and no mesh or one whose collectives are NCCL's."""
    return torch.device(device).type == "cuda" and (
        mesh is None or mesh.transport == "nccl")


def check_mesh(capture, mesh, what):
    """Raise where ``Capture`` would record a collective that is not
    NCCL's (gloo, or the host transport of ranks that share a card); a
    stand-in runs its regions and takes any mesh."""
    if (isinstance(capture, Capture) and mesh is not None
            and mesh.transport != "nccl"):
        raise ValueError(
            f"{what}(graph=True) captures CUDA graphs, which record NCCL "
            f"collectives only, and the mesh's transport is "
            f"{mesh.transport!r}: a gloo or host mesh runs eagerly "
            f"(graph=False, its default)")


def resolve(graph, device, mesh=None, what="graph"):
    """The capture of a runner's ``graph=`` on ``device`` over ``mesh``:
    None (the default) a new ``Capture`` where ``supported``, else None
    (eager); False None; True a new ``Capture``, raising where it cannot
    run; another object (a stand-in) as given."""
    if graph is None:
        return Capture() if supported(device, mesh) else None
    capture = capture_of(graph)
    if capture is not None:
        check_mesh(capture, mesh, what)
        capture.check(device, what)
    return capture


class Deferred:
    """A runner built without a device (``make_filter_step`` and its
    kin) and ``graph=None``: ``build(capture or False)`` makes the runner
    at the first call, of the mode that its inputs' device
    (``device_of(*args)``) resolves to; a later call on another device
    raises.  Attributes are the runner's (``graphs``: None when eager)."""

    def __init__(self, build, mesh, device_of, what):
        self.build, self.mesh, self.device_of = build, mesh, device_of
        self.what = what
        self.runner = self.device = None

    def __call__(self, *args, **kw):
        device = torch.device(self.device_of(*args))
        if self.runner is None:
            capture = resolve(None, device, self.mesh, self.what)
            self.runner = self.build(False if capture is None else capture)
            self.device = device
        elif device != self.device:
            raise ValueError(f"{self.what}: resolved its mode on "
                             f"{self.device} at its first call and is "
                             f"called on {device}: make a runner for each "
                             f"device")
        return self.runner(*args, **kw)

    def __getattr__(self, name):
        runner = self.__dict__.get("runner")
        if runner is None:
            raise AttributeError(f"{name}: the runner's mode resolves at its "
                                 f"first call (graph=None)")
        return getattr(runner, name)


def runner_for(graph, mesh, what, build, device_of):
    """The runner a ``graph=`` names: ``build(capture or False)`` for an
    explicit ``graph`` (True and a stand-in checked against ``mesh``
    here, against the device at the first call), a ``Deferred`` for
    None."""
    if graph is None:
        return Deferred(build, mesh, device_of, what)
    capture = capture_of(graph)
    if capture is not None:
        check_mesh(capture, mesh, what)
    return build(False if capture is None else capture)


def leaves(tree):
    """The tensor fields of a state (dataclasses nested, tuples and lists
    of them), in a fixed order; None and static fields are skipped."""
    out = []

    def visit(t):
        if isinstance(t, torch.Tensor):
            out.append(t)
        elif dataclasses.is_dataclass(t):
            for f in dataclasses.fields(t):
                visit(getattr(t, f.name))
        elif isinstance(t, (tuple, list)):
            for v in t:
                visit(v)

    visit(tree)
    return out


def equal_bits(got, ref):
    """Every tensor of ``got`` equal to ``ref``'s bit for bit, with the
    same dtype and shape (NaNs by their bits, ``-0.0`` not ``+0.0``);
    returns ``(all equal, tensors compared)``."""
    a, b = leaves(got), leaves(ref)
    same = len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(
            x.contiguous().view(-1).view(torch.uint8),
            y.contiguous().view(-1).view(torch.uint8))
        for x, y in zip(a, b))
    return same, len(a)


def structure(tree):
    """Where a state holds None, a tensor or another field (dataclasses
    nested, tuples and lists of them): inputs of one signature but of
    another structure (a draw given in place of another) need static
    buffers of their own."""
    if tree is None or isinstance(tree, torch.Tensor):
        return tree is not None
    if dataclasses.is_dataclass(tree):
        return (type(tree),) + tuple(structure(getattr(tree, f.name))
                                     for f in dataclasses.fields(tree))
    if isinstance(tree, (tuple, list)):
        return tuple(structure(v) for v in tree)
    return type(tree)


def signature(tree):
    """Shapes, dtypes and devices of a state's tensors: what a graph
    captured on static buffers of that state needs to hold again."""
    return tuple((tuple(t.shape), t.dtype, t.device) for t in leaves(tree))


def addresses(tree):
    """The storage addresses of a state's tensors."""
    return tuple(t.data_ptr() for t in leaves(tree))


def copy_into(dst, src):
    """Copy every tensor of ``src`` into the same field of ``dst`` (same
    structure and signature), in place, with one ``_foreach_copy_`` per
    dtype; a field that already is its destination is skipped.  A source
    that shares storage with another destination is cloned first, so no
    copy reads what another has written."""
    pairs = [(d, s) for d, s in zip(leaves(dst), leaves(src), strict=True)
             if not (d is s or (d.data_ptr() == s.data_ptr()
                                and d.stride() == s.stride()))]
    if not pairs:
        return
    written = {d.untyped_storage().data_ptr() for d, _ in pairs}
    groups = collections.defaultdict(lambda: ([], []))
    for d, s in pairs:
        if s.untyped_storage().data_ptr() in written:
            s = s.clone()
        groups[d.dtype][0].append(d)
        groups[d.dtype][1].append(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


def _map(fn, tree):
    """``fn`` on every tensor of a state (the structure of ``leaves``);
    every other field carried over."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def clone(tree):
    """A copy of a state with new tensors (``copy_into`` fresh ones)."""
    out = _map(torch.empty_like, tree)
    copy_into(out, tree)
    return out


def load_generator(static, given):
    """Put ``given``'s state (seed and offset) into ``static``."""
    if static is not None and given is not None and given is not static:
        static.set_state(given.get_state())


def _generator(carry):
    """The generator a carry (a state with a ``generator`` field) draws
    from, or None."""
    return getattr(carry, "generator", None)


def _with_generator(carry, gen):
    if not dataclasses.is_dataclass(carry) or not hasattr(carry,
                                                          "generator"):
        return carry
    return dataclasses.replace(carry, generator=gen)


class ShapeGraphs(dict):
    """A runner's ``StepGraphs``, one per shape of its carry."""

    def settled(self):
        """Every step met so far replays (a warm-up run has captured)."""
        return all(sg.settled() for sg in self.values())

    def counts(self):
        """Steps run eagerly, captured and replayed, over every shape."""
        total = collections.Counter()
        for sg in self.values():
            total.update(sg.counts)
        return dict(total)


class StepGraphs:
    """The graphs of one step function over one set of static buffers.

    ``body(carry, x, key) -> (carry, y)`` is the step's device work for
    the gate combination ``key`` (hashable, decided on the host; one
    graph per key and signature of ``x``): it
    reads the static ``carry`` and inputs ``x`` and returns the new carry
    (tensors of the same signature; a field it updates in place may be
    the static tensor itself) and the step's outputs ``y``.  ``carry`` is
    the static carry, built by the runner (``generator``: the static
    generator it holds, or None).  ``capture``: a ``Capture`` or a
    stand-in.  ``reads(key)``: the tensors outside the carry and the
    inputs that the body of ``key`` reads (a state of them); a replay
    raises ``StaleRead`` where one of them moved since the capture.
    ``writes(key)``: those of them it writes in place, which a capture
    (a stand-in that runs the region) must leave as they were."""

    def __init__(self, body, carry, capture, generator=None, reads=None,
                 writes=None, what="graph"):
        self.body, self.carry, self.capture = body, carry, capture
        self.generator = generator
        self.reads, self.writes, self.what = reads, writes, what
        self.inputs = {}    # signature and structure of x -> static x
        self.outputs = {}   # key -> static y
        self.graphs = {}    # key -> (graph, launches credited a replay,
        #                           addresses of the reads, its number)
        self.met = collections.Counter()
        self.counts = collections.Counter()

    def settled(self):
        """Every key met so far replays (none met only once, eagerly)."""
        return all(k in self.graphs for k in self.met)

    def _static_inputs(self, sig, x):
        if sig not in self.inputs:
            self.inputs[sig] = clone(x)
        static = self.inputs[sig]
        copy_into(static, x)
        return static

    def _region(self, gate, key, x):
        def fn():
            carry, y = self.body(self.carry, x, gate)
            copy_into(self.carry, carry)
            if key not in self.outputs:
                self.outputs[key] = clone(y)
            else:
                copy_into(self.outputs[key], y)
        return fn

    def _addresses(self, gate):
        return () if self.reads is None else addresses(self.reads(gate))

    def _replay(self, key):
        graph, credit, read, number = self.graphs[key]
        now = self._addresses(key[0])
        if now != read:
            moved = sum(a != b for a, b in zip(now, read)) + abs(
                len(now) - len(read))
            raise StaleRead(
                f"{self.what}: {moved} of the {len(read)} tensors that the "
                f"graph of {key[0]} reads outside its carry and inputs were "
                f"replaced since its capture (write into their storage "
                f"instead)")
        before = ops.launch_counts()
        with span(f"{REPLAY_SPAN}{number}"):
            self.capture.replay(graph)
        ops.set_launch_counts({k: v + credit.get(k, 0)
                               for k, v in before.items()})
        self.counts["replayed"] += 1

    def step(self, key, x):
        """One step at ``key`` with inputs ``x``: eager at the first
        meeting of ``key`` with inputs of ``x``'s signature, captured and
        replayed at the second, replayed after.  Returns the static
        outputs (valid until the next step of that key and signature)."""
        sig = (signature(x), structure(x))
        x = self._static_inputs(sig, x)
        gate = key
        key = (gate, sig)
        self.met[key] += 1
        if key in self.graphs:
            self._replay(key)
        elif self.met[key] == 1:
            self._region(gate, key, x)()
            self.counts["eager"] += 1
        else:
            graph = self.capture.new_graph()
            fn = self._region(gate, key, x)
            number = next(_GRAPH_NUMBERS)
            before = ops.launch_counts()
            with span(f"{CAPTURE_SPAN}{number}"):
                self.capture.capture(
                    graph, fn,
                    () if self.generator is None else (self.generator,),
                    leaves(self.carry) + leaves(self.outputs[key])
                    + ([] if self.writes is None
                       else leaves(self.writes(gate))))
            after = ops.launch_counts()
            # a capture records the launches and runs none of them
            ops.set_launch_counts(before)
            self.graphs[key] = (graph, {k: after[k] - before[k]
                                        for k in after},
                                self._addresses(gate), number)
            self.counts["captured"] += 1
            self._replay(key)
        return self.outputs[key]


class ScanRunner:
    """A graphed ``lax.scan``: ``step(carry, x) -> (carry, y)`` rolled over
    a sequence of per-step inputs, one graph per input signature.

    ``run(carry, xs)`` with ``xs`` a sequence of per-step inputs returns
    ``(final carry, ys)``: the final carry a copy of the static one and
    ``ys`` the per-step outputs stacked along a new leading axis, as new
    tensors.  A carry with a ``generator`` field keeps the caller's
    generator, advanced as eager steps advance it."""

    def __init__(self, step, capture, what):
        self.capture, self.what = capture, what
        self.body = lambda carry, x, key: step(carry, x)
        self.per_shape = ShapeGraphs()
        self.settled, self.counts = (self.per_shape.settled,
                                     self.per_shape.counts)

    def graphs(self, carry):
        """The ``StepGraphs`` of ``carry``'s shape, its static carry
        holding ``carry``'s values."""
        sig = signature(carry)
        sg = self.per_shape.get(sig)
        given = _generator(carry)
        if sg is None:
            gen = None if given is None else torch.Generator(given.device)
            sg = StepGraphs(self.body, _with_generator(clone(carry), gen),
                            self.capture, gen)
            self.per_shape[sig] = sg
        else:
            copy_into(sg.carry, carry)
        load_generator(sg.generator, given)
        return sg

    def run(self, carry, xs):
        """Roll ``carry`` over ``xs``, one graph per input signature."""
        if not xs:
            raise ValueError(f"{self.what}: no steps to run")
        self.capture.check(leaves(carry)[0].device, self.what)
        sg = self.graphs(carry)
        ys = None
        for t, x in enumerate(xs):
            y = sg.step(None, x)
            if ys is None:
                ys = [torch.empty((len(xs),) + tuple(v.shape), dtype=v.dtype,
                                  device=v.device) for v in leaves(y)]
            copy_into([row[t] for row in ys], leaves(y))
        given = _generator(carry)
        load_generator(given, sg.generator)
        return _with_generator(clone(sg.carry), given), ys


class CallGraphs:
    """Functions of static inputs as CUDA graphs, one per key: the
    counterpart of ``jax.jit`` with static arguments.

    ``cg(key, fn, x)`` runs ``fn(x)``, device work with no host read, on
    static copies of the tensors of ``x`` (filled with ``copy_`` at every
    call): eagerly at the first meeting of ``key`` and ``x``'s signature,
    captured at the second and replayed after (``StepGraphs``).  ``key``
    is hashable and holds every static argument ``fn`` bakes in (the
    non-tensor fields of ``x`` too: ``x``'s signature holds only its
    tensors' shapes); ``fn`` is kept at the key's first meeting and reads
    no tensor outside ``x``.  Returns ``fn``'s outputs as new tensors.
    ``generator``: the ``torch.Generator`` that the functions draw from
    (the caller's own), registered with every graph, so that a replay
    advances it exactly as an eager call does."""

    def __init__(self, capture, what, generator=None):
        self.fns = {}
        self.steps = StepGraphs(self._body, (), capture, generator,
                                what=what)

    def _body(self, carry, x, key):
        return carry, self.fns[key](x)

    def counts(self):
        """Calls run eagerly, captured and replayed."""
        return dict(self.steps.counts)

    def __call__(self, key, fn, x):
        self.fns.setdefault(key, fn)
        return clone(self.steps.step(key, x))
