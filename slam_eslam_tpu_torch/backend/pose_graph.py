"""Pose-graph backend: loop closures and batched Gauss-Newton.

Port of ``slam_eslam_tpu.backend.pose_graph``.  A planar pose graph over
trajectory keyframes fuses odometry constraints with loop-closure
constraints found by scan-to-map alignment.  The graph is fixed-shape
SoA (``M`` nodes, ``E`` edges with validity masks); residuals and
Jacobians are closed form over all edges at once.  Three solvers share
them: the dense normal equations (edge blocks scatter-added into ``H
[D*M, D*M]``, one Cholesky), a matrix-free block-Jacobi PCG whose
H-matvecs are edge-parallel scatter-adds, and a Schur-complement
partition of the trajectory into segments (batched segment Choleskys,
then the small boundary system).

Edge model (SE(2)): measurement ``z_ij = (dx, dy, dyaw)`` of node j in
node i's frame; residual ``r = (R_i^T (t_j - t_i) - z_t, wrap(yaw_j -
yaw_i - z_yaw))``, weighted by a ``D x D`` information matrix; ``dim=4``
adds z as a frame-independent offset.

The JAX package keeps all of this in XLA (no Pallas kernel), and so does
the port: einsums, scatter-adds and ``torch.linalg``.  For
the card:

* Every solver runs in float32 with TF32 off (the JAX package pins
  ``Precision.HIGHEST``) and, on the card, with cuSOLVER as the linear
  algebra library (MAGMA, which batched factorisations may otherwise
  take, reads the device back and cannot be captured); the caller's
  ``allow_tf32`` and library are restored after.
* The Cholesky is ``cholesky_ex`` + ``cholesky_solve``, which neither
  raise nor read the device back; a factorisation that fails (a matrix
  that is not positive definite) gives NaN, as ``jax.scipy.linalg.solve
  (assume_a="pos")`` does.
* Gauss-Newton iterations and the PCG inner loop are fixed-length Python
  loops with no host read: ``optimize``, ``optimize_cg`` and
  ``optimize_schur`` put no host sync on the card, so a whole solve is
  captured as one CUDA graph: ``cuda_graphs=`` (a ``utils.graphs.
  CallGraphs``) runs it eagerly at the first meeting of its key (the
  solver and its static arguments), captures it at the second and
  replays it after, the graph's fields and ``fix_mask`` copied into
  static inputs at every call; ``PoseGraphBuilder.optimize(graph=)`` and
  the keyframe alignment (``scan_align(cuda_graphs=)``) use it.  The
  JAX package jits these seams.
* The scatter-adds add in index order, the same on every call
  (``utils.scatter.add_at``): a solve repeats bit for bit, graphed or
  not.
  The card matches the CPU within tolerance, not bit for bit.
* ``mesh=`` (``parallel.sharding.make_mesh``; the JAX package's
  ``shard_map``): the graph is held whole on every rank.  The PCG splits
  the edges over the ranks (the edge capacity must divide by the mesh
  size) and ``all_reduce``s every scatter-added product, so each rank
  ends with the same nodes; the Schur solver splits the segments over
  the ranks, ``all_reduce``s their contributions to the boundary system
  and all-gathers their interior deltas.  Equal to the single-rank solve
  up to the order of float sums.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from slam_eslam_tpu_torch.utils import graphs
from slam_eslam_tpu_torch.utils.device import entry_device
from slam_eslam_tpu_torch.utils.scatter import add_at

PIN = 1e9   # diagonal weight that freezes a node


@contextlib.contextmanager
def exact_float32(device=None):
    """Float32 matrix products without TF32 for the duration (solver-grade
    contractions, as the JAX package's ``Precision.HIGHEST``) and, on a
    CUDA ``device``, cuSOLVER for the factorisations and solves (the
    library a CUDA graph captures)."""
    old = torch.backends.cuda.matmul.allow_tf32
    cuda = device is not None and torch.device(device).type == "cuda"
    lib = torch.backends.cuda.preferred_linalg_library() if cuda else None
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        if cuda:
            torch.backends.cuda.preferred_linalg_library("cusolver")
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
        if cuda:
            torch.backends.cuda.preferred_linalg_library(lib)


def wrap_angle(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


@dataclasses.dataclass
class PoseGraph:
    nodes: torch.Tensor       # [M, D] (x, y[, z], yaw) float32
    node_valid: torch.Tensor  # [M] bool
    edge_i: torch.Tensor      # [E] int32
    edge_j: torch.Tensor      # [E] int32
    edge_z: torch.Tensor      # [E, D] relative measurement
    edge_info: torch.Tensor   # [E, D, D] information matrices
    edge_valid: torch.Tensor  # [E] bool

    @staticmethod
    def empty(max_nodes, max_edges, dim=3, device=None):
        """``dim=3``: planar SE(2) nodes (x, y, yaw).  ``dim=4``: the
        filter's state manifold SE(2) x R, (x, y, z, yaw)
        (``PoseParticle.hpp:52-86``); z is a frame-independent offset.
        On the CUDA device unless ``device`` is given."""
        device = entry_device(device)
        f32 = dict(dtype=torch.float32, device=device)
        return PoseGraph(
            nodes=torch.zeros((max_nodes, dim), **f32),
            node_valid=torch.zeros((max_nodes,), dtype=torch.bool,
                                   device=device),
            edge_i=torch.zeros((max_edges,), dtype=torch.int32,
                               device=device),
            edge_j=torch.zeros((max_edges,), dtype=torch.int32,
                               device=device),
            edge_z=torch.zeros((max_edges, dim), **f32),
            edge_info=torch.zeros((max_edges, dim, dim), **f32),
            edge_valid=torch.zeros((max_edges,), dtype=torch.bool,
                                   device=device),
        )

    @property
    def dim(self):
        return self.nodes.shape[1]


def edge_residuals(graph: PoseGraph, edge_sl=slice(None)):
    """Residuals ``[E, D]`` and Jacobians (``[E, D, D]`` with respect to
    node i, ``[E, D, D]`` to node j); ``edge_sl`` restricts the edges."""
    d = graph.dim
    ei = graph.edge_i[edge_sl].long()
    ej = graph.edge_j[edge_sl].long()
    ez = graph.edge_z[edge_sl]
    pi = graph.nodes[ei]
    pj = graph.nodes[ej]
    yaw_c = d - 1  # yaw is always the last component
    ci, si = torch.cos(pi[:, yaw_c]), torch.sin(pi[:, yaw_c])
    dt = pj[:, :2] - pi[:, :2]
    lx = ci * dt[:, 0] + si * dt[:, 1]       # R_i^T dt
    ly = -si * dt[:, 0] + ci * dt[:, 1]
    r_yaw = wrap_angle(pj[:, yaw_c] - pi[:, yaw_c] - ez[:, yaw_c])
    zeros = torch.zeros_like(ci)
    ones = torch.ones_like(ci)
    zc = [zeros] if d == 4 else []

    rows = [lx - ez[:, 0], ly - ez[:, 1]]
    # d r / d (xi, yi, [zi,] yawi), row-major per residual row
    ji_rows = [
        [-ci, -si] + zc + [-si * dt[:, 0] + ci * dt[:, 1]],
        [si, -ci] + zc + [-ci * dt[:, 0] - si * dt[:, 1]],
    ]
    jj_rows = [[ci, si] + zc + [zeros], [-si, ci] + zc + [zeros]]
    if d == 4:
        rows.append(pj[:, 2] - pi[:, 2] - ez[:, 2])
        ji_rows.append([zeros, zeros, -ones, zeros])
        jj_rows.append([zeros, zeros, ones, zeros])
    rows.append(r_yaw)
    ji_rows.append([zeros] * (d - 1) + [-ones])
    jj_rows.append([zeros] * (d - 1) + [ones])

    r = torch.stack(rows, dim=-1)
    ji = torch.stack([torch.stack(row, -1) for row in ji_rows], dim=-2)
    jj = torch.stack([torch.stack(row, -1) for row in jj_rows], dim=-2)
    return r, ji, jj


def _chi2_edges(r, info):
    return torch.einsum("ei,eij,ej->e", r, info, r)


def robust_edge_weights(graph: PoseGraph, kind="huber", delta=1.0):
    """Per-edge robust reweighting factors (iteratively reweighted GN):
    ``'huber'`` w = min(1, delta / sqrt(chi2_e)), a linear tail;
    ``'dcs'`` (Dynamic Covariance Scaling) w = min(1, (2 delta / (delta +
    chi2_e))^2), which saturates spurious closures to ~zero influence."""
    r, _, _ = edge_residuals(graph)
    chi2_e = _chi2_edges(r, graph.edge_info)
    if kind == "huber":
        w = (delta / torch.sqrt(chi2_e.clamp(min=1e-12))).clamp(max=1.0)
    elif kind == "dcs":
        w = ((2.0 * delta / (delta + chi2_e)) ** 2).clamp(max=1.0)
    else:
        raise ValueError(f"unknown robust kernel {kind!r}")
    return torch.where(graph.edge_valid, w, torch.ones_like(w))


def _apply_delta(graph: PoseGraph, delta, fix_mask):
    d = graph.dim
    free = graph.node_valid
    if fix_mask is not None:
        free = free & ~fix_mask
    nodes = graph.nodes + torch.where(free[:, None], delta,
                                      torch.zeros_like(delta))
    nodes[:, d - 1] = wrap_angle(nodes[:, d - 1])
    return dataclasses.replace(graph, nodes=nodes)


def _pin_diag(graph: PoseGraph, fix_first, fix_mask):
    """Pinning weights ``[M]``: PIN freezes a node (the gauge anchor,
    invalid slots and the incremental solve's fixed set)."""
    m = graph.nodes.shape[0]
    zero = torch.zeros((m,), dtype=graph.nodes.dtype,
                       device=graph.nodes.device)
    pin = torch.full_like(zero, PIN)
    diag_pin = zero
    if fix_first:
        first = torch.arange(m, device=zero.device) == 0
        diag_pin = torch.where(first, pin, zero)
    diag_pin = torch.where(graph.node_valid, diag_pin, pin)
    if fix_mask is not None:
        diag_pin = torch.where(fix_mask, pin, diag_pin)
    return diag_pin


def _robustified(graph: PoseGraph, robust, delta):
    if robust is None:
        return graph
    w = robust_edge_weights(graph, robust, delta)
    return dataclasses.replace(graph,
                               edge_info=graph.edge_info * w[:, None, None])


def _edge_terms(graph: PoseGraph, edge_sl=slice(None)):
    """Residuals, Jacobians and the validity-masked information."""
    r, ji, jj = edge_residuals(graph, edge_sl)
    w = graph.edge_valid[edge_sl][:, None, None].to(r.dtype)
    return r, ji, jj, graph.edge_info[edge_sl] * w


def _blocks(ji, jj, info, r):
    """``(Hii, Hij, Hjj, bi, bj)``: the edges' normal-equation blocks."""
    h = lambda a, b: torch.einsum("eki,ekl,elj->eij", a, info, b)
    bv = lambda a: torch.einsum("eki,ekl,el->ei", a, info, r)
    return h(ji, ji), h(ji, jj), h(jj, jj), bv(ji), bv(jj)


def _spd_solve(a, b):
    """``a^-1 b`` for symmetric positive definite ``a [..., n, n]`` and
    ``b [..., n, k]``: NaN where the factorisation fails, and no host
    read."""
    chol, info = torch.linalg.cholesky_ex(a)
    x = torch.cholesky_solve(b, chol)
    ok = (info == 0).reshape(info.shape + (1, 1))
    return torch.where(ok, x, torch.full_like(x, float("nan")))


def _dense(a, rows, cols, d):
    """``[..., rows, cols, D, D]`` blocks -> ``[..., rows*D, cols*D]``."""
    lead = a.shape[:-4]
    return a.transpose(-3, -2).reshape(lead + (rows * d, cols * d))


def gauss_newton_step(graph: PoseGraph, damping=1e-6, fix_first=True,
                      fix_mask=None, robust=None, robust_delta=1.0):
    """One dense GN step: the ``[D*M, D*M]`` normal matrix scatter-added
    from the edge blocks and solved by Cholesky.  ``fix_mask [M]`` freezes
    nodes; ``robust`` ('huber' / 'dcs') reweights the edge information.
    Returns ``(graph', chi2_before)``."""
    with exact_float32(graph.nodes.device):
        out_graph = graph
        graph = _robustified(graph, robust, robust_delta)
        m, d = graph.nodes.shape
        r, ji, jj, info = _edge_terms(graph)
        chi2 = (_chi2_edges(r, graph.edge_info) * graph.edge_valid).sum()
        hii, hij, hjj, bi, bj = _blocks(ji, jj, info, r)

        ei, ej = graph.edge_i.long(), graph.edge_j.long()
        # one scatter each, the blocks in the order of four scatters
        h = add_at(r.new_zeros((m * m, d, d)), torch.cat(
            [ei * m + ei, ei * m + ej, ej * m + ei, ej * m + ej]),
            torch.cat([hii, hij, hij.transpose(-1, -2), hjj]))
        b = _scatter_nodes(m, d, torch.cat([ei, ej]), bi, bj)

        hd = _dense(h.reshape(m, m, d, d), m, m, d)
        pin = _pin_diag(graph, fix_first, fix_mask)[:, None].expand(m, d)
        hd = hd + torch.diag(pin.reshape(-1) + damping)
        delta = _spd_solve(hd, -b.reshape(d * m, 1))
        return _apply_delta(out_graph, delta.reshape(m, d), fix_mask), chi2


def _solve(step, graph, fix_mask, iters, cuda_graphs, key):
    """``iters`` steps ``step(graph, fix_mask) -> (graph, chi2)`` from
    ``graph``: eager launches, or with ``cuda_graphs`` (a
    ``utils.graphs.CallGraphs``) one CUDA graph per ``key`` (the solver
    and its static arguments) whose static inputs are the graph's fields
    and ``fix_mask``.  Returns ``(graph with the solved nodes,
    chi2_history [iters])``."""

    def run(x):
        g, fm = x
        hist = []
        for _ in range(iters):
            g, chi2 = step(g, fm)
            hist.append(chi2)
        return g.nodes, torch.stack(hist)

    x = (graph, fix_mask)
    nodes, hist = run(x) if cuda_graphs is None else cuda_graphs(
        key + (iters,), run, x)
    return dataclasses.replace(graph, nodes=nodes), hist


def optimize(graph: PoseGraph, iters=10, damping=1e-6, fix_mask=None,
             robust=None, robust_delta=1.0, cuda_graphs=None):
    """``iters`` dense GN steps; returns ``(graph, chi2_history
    [iters])``.  ``cuda_graphs``: a ``utils.graphs.CallGraphs`` that runs
    the solve as one CUDA graph (module docstring)."""
    return _solve(lambda g, fm: gauss_newton_step(
        g, damping, fix_mask=fm, robust=robust,
        robust_delta=robust_delta), graph, fix_mask, iters, cuda_graphs,
        ("dense", damping, robust, robust_delta))


# --------------------------------------------------------------------------
# Matrix-free solver (edge-parallel block-Jacobi PCG)
# --------------------------------------------------------------------------

def _scatter_nodes(m, d, eij, vi, vj):
    """Per node, the sum of ``vi`` over the edges it starts and then of
    ``vj`` over those it ends (``eij = cat([ei, ej])``), in one scatter."""
    return add_at(vi.new_zeros((m, d)), eij, torch.cat([vi, vj]))


def gauss_newton_step_cg(graph: PoseGraph, damping=1e-6, fix_first=True,
                         fix_mask=None, cg_iters=32, mesh=None,
                         robust=None, robust_delta=1.0):
    """One GN step with a matrix-free block-Jacobi PCG inner solve: H is
    never materialised; each H-matvec gathers node values at the edge
    ends, applies the per-edge ``D x D`` blocks and scatter-adds.
    ``cg_iters`` iterations always run (no convergence test, no host
    read).  Returns ``(graph', chi2_before)``; the same math as
    ``gauss_newton_step`` up to the CG tolerance.  ``mesh``: this rank
    takes its slice of the edges, and every edge sum is ``all_reduce``d
    (JAX ``pose_graph.py:264-275``)."""
    edge_sl, psum = slice(None), (lambda x: x)
    if mesh is not None:
        edge_sl = slice(*mesh.bounds(graph.edge_i.shape[0]))
        psum = mesh.all_reduce
    with exact_float32(graph.nodes.device):
        out_graph = graph
        graph = _robustified(graph, robust, robust_delta)
        m, d = graph.nodes.shape
        pin = _pin_diag(graph, fix_first, fix_mask) + damping
        r, ji, jj, info = _edge_terms(graph, edge_sl)
        ei = graph.edge_i[edge_sl].long()
        ej = graph.edge_j[edge_sl].long()
        chi2 = psum(_chi2_edges(r, info).sum())

        hii, _, hjj, bi, bj = _blocks(ji, jj, info, r)
        eij = torch.cat([ei, ej])
        b = psum(_scatter_nodes(m, d, eij, bi, bj))  # J^T W r
        # the block diagonal of H for the preconditioner
        diag = add_at(r.new_zeros((m, d, d)), eij, torch.cat([hii, hjj]))
        diag = psum(diag) + pin[:, None, None] * torch.eye(d, dtype=r.dtype,
                                                     device=r.device)
        pre = torch.linalg.inv_ex(diag).inverse          # [M, D, D]

        def matvec(x):
            # y_e = W (Ji xi + Jj xj); scatter Ji^T y, Jj^T y
            ye = torch.einsum(
                "ekl,el->ek", info,
                torch.einsum("ekj,ej->ek", ji, x[ei])
                + torch.einsum("ekj,ej->ek", jj, x[ej]))
            vi = torch.einsum("eki,ek->ei", ji, ye)
            vj = torch.einsum("eki,ek->ei", jj, ye)
            return psum(_scatter_nodes(m, d, eij, vi, vj)) \
                + pin[:, None] * x

        apply_pre = lambda v: torch.einsum("mij,mj->mi", pre, v)

        # PCG for H delta = -b
        x = r.new_zeros((m, d))
        res = -b
        z = apply_pre(res)
        p = z
        for _ in range(cg_iters):
            hp = matvec(p)
            rz = (res * z).sum()
            alpha = rz / (p * hp).sum().clamp(min=1e-30)
            x = x + alpha * p
            res = res - alpha * hp
            z = apply_pre(res)
            beta = (res * z).sum() / rz.clamp(min=1e-30)
            p = z + beta * p
        return _apply_delta(out_graph, x, fix_mask), chi2


def optimize_cg(graph: PoseGraph, iters=10, damping=1e-6, fix_mask=None,
                cg_iters=32, mesh=None, robust=None, robust_delta=1.0,
                cuda_graphs=None):
    """``optimize`` with the matrix-free PCG inner solver (edges split
    over ``mesh``); ``cuda_graphs`` as ``optimize``'s (the ``cg_iters``
    inner loop in the graph too)."""
    return _solve(lambda g, fm: gauss_newton_step_cg(
        g, damping, fix_mask=fm, cg_iters=cg_iters, mesh=mesh,
        robust=robust, robust_delta=robust_delta), graph, fix_mask, iters,
        cuda_graphs, ("cg", damping, cg_iters, mesh, robust, robust_delta))


# --------------------------------------------------------------------------
# Schur-complement trajectory partitioning
# --------------------------------------------------------------------------

def _schur_structure(graph: PoseGraph, segments, boundary_cap):
    """Classify nodes for a ``segments``-way contiguous partition: a node
    is boundary iff a valid edge crosses segments at it (segment seams,
    loop-closure ends).  Returns ``(seg [M], boundary [M] bool, gb [M]
    int64 boundary slot or boundary_cap when none or past the cap,
    n_boundary [])``."""
    m = graph.nodes.shape[0]
    assert m % segments == 0, "segments must divide the node capacity"
    nl = m // segments
    dev = graph.nodes.device
    seg = torch.arange(m, device=dev) // nl
    ei, ej = graph.edge_i.long(), graph.edge_j.long()
    cross = ((seg[ei] != seg[ej]) & graph.edge_valid).to(torch.int32)
    bnd = torch.zeros((m,), dtype=torch.int32, device=dev)
    bnd.scatter_reduce_(0, ei, cross, reduce="amax")
    bnd.scatter_reduce_(0, ej, cross, reduce="amax")
    boundary = bnd > 0
    # stable global boundary slots (cumsum order); overflow -> the spare
    rank = torch.cumsum(bnd, 0) - 1
    gb = torch.where(boundary & (rank < boundary_cap), rank,
                     torch.full_like(rank, boundary_cap))
    return seg, boundary, gb, boundary.sum()


def _add_dropped(target, *parts):
    """``target.at[idx].add(values, mode="drop")`` for each ``(idx,
    values)`` of ``parts`` in turn, in one scatter (the entries of one
    index add in the order given, as one call each would add them):
    ``idx`` is a tuple of index tensors over the leading dims of
    ``target``; an entry with any index out of bounds adds nothing."""
    k = len(parts[0][0])
    lead = target.shape[:k]
    idx = [torch.cat([p[0][i] for p in parts]) for i in range(k)]
    ok = torch.ones_like(idx[0], dtype=torch.bool)
    lin = torch.zeros_like(idx[0])
    for i, size in zip(idx, lead):
        ok &= (i >= 0) & (i < size)
        lin = lin * size + i
    n = int(np.prod(lead))
    flat = target.reshape((n,) + target.shape[k:])
    spare = torch.cat([flat, flat.new_zeros((1,) + flat.shape[1:])])
    add_at(spare, torch.where(ok, lin, torch.full_like(lin, n)),
            torch.cat([p[1] for p in parts]))
    return spare[:n].reshape(target.shape)


def gauss_newton_step_schur(graph: PoseGraph, segments=4, boundary_cap=64,
                            damping=1e-6, fix_first=True, fix_mask=None,
                            mesh=None, robust=None, robust_delta=1.0):
    """One GN step by Schur-complement trajectory partitioning: the node
    axis splits into ``segments`` contiguous blocks; boundary nodes (at
    most ``boundary_cap``) are eliminated last.  (1) per-segment interior
    systems ``A_II^s`` factor in one batched Cholesky ``[S, NL*D,
    NL*D]``; (2) the boundary system ``S_BB = A_BB - sum_s A_BI A_II^-1
    A_IB``; (3) back-substitution gives the interior deltas.  Exact up to
    round-off: matches ``gauss_newton_step``.  Returns ``(graph',
    chi2_before)``.  ``mesh``: each rank factors its slice of the
    segments; their Schur contributions are ``all_reduce``d and their
    interior deltas all-gathered (JAX ``pose_graph.py:432-444``)."""
    with exact_float32(graph.nodes.device):
        out_graph = graph
        graph = _robustified(graph, robust, robust_delta)
        m, d = graph.nodes.shape
        s_n, nb = segments, boundary_cap
        nl = m // s_n
        seg, boundary, gb, _ = _schur_structure(graph, s_n, nb)
        li = torch.arange(m, device=seg.device) % nl   # slot in segment
        pin = _pin_diag(graph, fix_first, fix_mask) + damping

        r, ji, jj, info = _edge_terms(graph)
        ei, ej = graph.edge_i.long(), graph.edge_j.long()
        chi2 = _chi2_edges(r, info).sum()
        hii, hij, hjj, bi, bj = _blocks(ji, jj, info, r)
        hji = hij.transpose(-1, -2)

        def route(node_bnd, s_idx, l_idx, g_idx, drop):
            """(segment, interior slot) or boundary-slot targets; entries
            with ``drop`` go out of bounds."""
            ii = torch.where(drop | node_bnd, s_n, s_idx)
            il = torch.where(drop | node_bnd, nl, l_idx)
            ib = torch.where(drop | ~node_bnd, nb, g_idx)
            return ii, il, ib

        drop = ~graph.edge_valid
        si_seg, si_li, si_gb = route(boundary[ei], seg[ei], li[ei], gb[ei],
                                     drop)
        sj_seg, sj_li, sj_gb = route(boundary[ej], seg[ej], li[ej], gb[ej],
                                     drop)

        # ---- the partitioned blocks (every scatter drops out of bounds)
        same = (si_seg == sj_seg)[:, None, None]
        a_ii = _add_dropped(
            r.new_zeros((s_n, nl, nl, d, d)),
            ((si_seg, si_li, si_li), hii), ((sj_seg, sj_li, sj_li), hjj),
            # intra-segment interior-interior coupling
            ((si_seg, si_li, sj_li),
             torch.where(same, hij, torch.zeros_like(hij))),
            ((sj_seg, sj_li, si_li),
             torch.where(same, hji, torch.zeros_like(hji))))

        a_bb = _add_dropped(
            r.new_zeros((nb, nb, d, d)), ((si_gb, si_gb), hii),
            ((sj_gb, sj_gb), hjj), ((si_gb, sj_gb), hij),
            ((sj_gb, si_gb), hji))

        # interior x boundary coupling [S, NL, NB, D, D]
        a_ib = _add_dropped(r.new_zeros((s_n, nl, nb, d, d)),
                            ((si_seg, si_li, sj_gb), hij),
                            ((sj_seg, sj_li, si_gb), hji))

        b_int = _add_dropped(r.new_zeros((s_n, nl, d)),
                             ((si_seg, si_li), bi), ((sj_seg, sj_li), bj))
        b_bnd = _add_dropped(r.new_zeros((nb, d)), ((si_gb,), bi),
                             ((sj_gb,), bj))

        # pinning: interior slots get their node pin; slots of a boundary
        # node (whose mass lives in A_BB) and padding get a unit diagonal,
        # so the segment factor stays SPD and their delta solves to zero
        pin_ii = torch.where(boundary, torch.ones_like(pin), pin)
        pin_b = add_at(r.new_zeros((nb + 1,)), gb,
                        torch.where(boundary, pin, torch.zeros_like(pin)))
        occupied = torch.zeros((nb + 1,), dtype=torch.bool, device=r.device)
        occupied.index_fill_(0, gb, True)
        pin_b = pin_b[:nb] + torch.where(occupied[:nb], 0.0, 1.0)

        expand = lambda v, n: v[..., None].expand(v.shape + (d,)).reshape(
            v.shape[:-1] + (n * d,))
        a_bb_d = _dense(a_bb, nb, nb, d) + torch.diag(expand(pin_b, nb))
        b_bnd_d = b_bnd.reshape(nb * d)

        # per segment: factor A_II, Y = A_II^-1 A_IB, w = A_II^-1 b_I
        a = _dense(a_ii, nl, nl, d) + torch.diag_embed(
            expand(pin_ii.reshape(s_n, nl), nl))
        c = _dense(a_ib, nl, nb, d)                     # [S, NL*D, NB*D]
        rhs = torch.cat([c, b_int.reshape(s_n, nl * d, 1)], dim=-1)
        psum = lambda x: x
        if mesh is not None:                  # this rank's segments
            seg_sl = slice(*mesh.bounds(s_n))
            a, c, rhs = a[seg_sl], c[seg_sl], rhs[seg_sl]
            psum = mesh.all_reduce
        yw = _spd_solve(a, rhs)
        y, w = yw[..., :-1], yw[..., -1]
        ct = c.transpose(-1, -2)
        s_bb = a_bb_d - psum((ct @ y).sum(0))
        rhs_b = b_bnd_d - psum((ct @ w[..., None])[..., 0].sum(0))
        delta_b = _spd_solve(s_bb, -rhs_b[:, None])[:, 0]
        # back-substitute: delta_I = -w - Y delta_b  (H delta = -b)
        delta_i = -w - torch.einsum("sij,j->si", y, delta_b)
        if mesh is not None:
            delta_i = mesh.all_gather(delta_i)

        # boundary nodes read their slot, interior nodes their segment
        delta_i_nodes = delta_i.reshape(m, d)
        delta_b_nodes = delta_b.reshape(nb, d)[gb.clamp(0, nb - 1)]
        delta = torch.where(boundary[:, None], delta_b_nodes, delta_i_nodes)
        return _apply_delta(out_graph, delta, fix_mask), chi2


def optimize_schur(graph: PoseGraph, iters=10, segments=4, boundary_cap=64,
                   damping=1e-6, fix_mask=None, mesh=None, robust=None,
                   robust_delta=1.0, cuda_graphs=None):
    """``optimize`` with the Schur-partitioned solver (segments split over
    ``mesh``); ``cuda_graphs`` as ``optimize``'s."""
    return _solve(lambda g, fm: gauss_newton_step_schur(
        g, segments=segments, boundary_cap=boundary_cap, damping=damping,
        fix_mask=fm, mesh=mesh, robust=robust,
        robust_delta=robust_delta), graph, fix_mask, iters, cuda_graphs,
        ("schur", segments, boundary_cap, damping, mesh, robust,
         robust_delta))


# --------------------------------------------------------------------------
# Loop-closure detection by scan-to-map alignment
# --------------------------------------------------------------------------

ALIGN_LOOKUPS = 1 << 22   # cloud-point lookups per batch of sweep poses


def scan_align(grid, cloud, xy0, yaw0, z0, search_xy=0.5, search_yaw=0.3,
               steps_xy=9, steps_yaw=7, z_window=3.0, sigma=0.2,
               search_z=0.0, steps_z=1, return_ratio=False,
               ratio_exclusion=0.75, cuda_graphs=None):
    """Grid-search alignment of a scan cloud against an MLS grid around
    an initial pose guess, the loop-closure front end: the
    ``mls_grid.match_cloud`` score (every point sampled) over a (dx, dy,
    dyaw[, dz]) grid, exhaustive correlation instead of iterative ICP.
    Returns ``(best_xy [2], best_yaw [], best_score [])`` and, with
    ``return_ratio``, the peak's distinctiveness: the best score over the
    best score at an xy offset more than ``ratio_exclusion`` m from the
    peak.  ``search_z`` sweeps a vertical offset too (the dz itself is
    discarded).

    The sweep's poses are scored in batches of at most ``ALIGN_LOOKUPS``
    point lookups (the JAX package streams one (dz, dyaw) sheet at a time
    for memory; the values are the same).  The best is the first maximum
    of the flattened ``[z, yaw, x, y]`` sweep, as in the JAX package.
    Everything stays on the grid's device: no host read.

    ``cuda_graphs`` (a ``utils.graphs.CallGraphs``): the sweep as one CUDA
    graph per key of its static arguments (the steps, the search extents,
    ``sigma``, ``return_ratio``, the grid's resolution) and of the
    shapes of the grid and the cloud, the JAX package's jitted
    ``scan_align`` (``static_argnames``); the grid, the cloud and the
    pose guess are its static inputs."""
    dev = cloud.z.device
    f32 = dict(dtype=torch.float32, device=dev)
    x = (grid, cloud, torch.as_tensor(xy0, **f32),
         torch.as_tensor(yaw0, **f32), torch.as_tensor(z0, **f32))
    sweep = lambda x: _sweep(*x, search_xy, search_yaw, steps_xy, steps_yaw,
                             z_window, sigma, search_z, steps_z,
                             return_ratio, ratio_exclusion)
    if cuda_graphs is None:
        return sweep(x)
    return cuda_graphs(
        ("scan_align", search_xy, search_yaw, steps_xy, steps_yaw, z_window,
         sigma, search_z, steps_z, return_ratio, ratio_exclusion,
         grid.resolution), sweep, x)


def _sweep(grid, cloud, xy0, yaw0, z0, search_xy, search_yaw, steps_xy,
           steps_yaw, z_window, sigma, search_z, steps_z, return_ratio,
           ratio_exclusion):
    """``scan_align``'s device work, on device tensors."""
    from slam_eslam_tpu_torch.mapping import mls_grid

    dev = cloud.z.device
    f32 = dict(dtype=torch.float32, device=dev)
    dxs = torch.linspace(-search_xy, search_xy, steps_xy, **f32)
    dyaws = torch.linspace(-search_yaw, search_yaw, steps_yaw, **f32)
    dzs = (torch.linspace(-search_z, search_z, steps_z, **f32)
           if steps_z > 1 else torch.zeros((1,), **f32))
    nz = dzs.shape[0]
    zz, yy, xx, yv = torch.meshgrid(dzs, dyaws, dxs, dxs, indexing="ij")
    th = (yaw0 + yy).reshape(-1)
    c, s = torch.cos(th), torch.sin(th)
    rot = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)],
                      -2)                                    # [K, 2, 2]
    trans = xy0 + torch.stack([xx.reshape(-1), yv.reshape(-1)], -1)
    zoff = z0 + zz.reshape(-1)
    chunk = max(1, ALIGN_LOOKUPS // max(cloud.p, 1))
    flat = torch.cat([
        mls_grid.match_cloud(grid, cloud, rot[k:k + chunk],
                             trans[k:k + chunk], zoff[k:k + chunk], 0.0,
                             sampling=1, sigma=sigma, z_window=z_window)
        for k in range(0, th.shape[0], chunk)])
    assert flat.shape[0] == nz * steps_yaw * steps_xy * steps_xy
    # indices as one-element tensors: indexing by a 0-d device tensor
    # reads it back to the host, which a CUDA graph cannot capture
    best = torch.argmax(flat).reshape(1)
    iy = best % steps_xy
    ixx = (best // steps_xy) % steps_xy
    iyaw = (best // (steps_xy * steps_xy)) % steps_yaw
    dx, dy = dxs.index_select(0, ixx), dxs.index_select(0, iy)
    peak = flat.index_select(0, best)[0]
    out = (xy0 + torch.cat([dx, dy]), yaw0 + dyaws.index_select(0, iyaw)[0],
           peak)
    if not return_ratio:
        return out
    # on self-similar terrain partial-overlap false peaks score close to
    # the true match; a flat score surface is the tell
    k = torch.arange(flat.shape[0], device=dev)
    ox = dxs[(k // steps_xy) % steps_xy]
    oy = dxs[k % steps_xy]
    far = (ox - dx) ** 2 + (oy - dy) ** 2 > ratio_exclusion ** 2
    second = torch.where(far, flat, torch.full_like(flat, -float("inf")))
    ratio = peak / second.max().clamp(min=1e-6)
    return out + (ratio,)


class PoseGraphBuilder:
    """Host-side helper accumulating keyframes and constraints; the graph
    lives on ``device`` (the CUDA device unless given).  ``add_node`` and
    ``add_edge`` replace the graph's tensors; a graphed ``optimize``
    copies them into its static inputs at every call."""

    def __init__(self, max_nodes=256, max_edges=1024, dim=3, device=None):
        self.graph = PoseGraph.empty(max_nodes, max_edges, dim=dim,
                                     device=device)
        self.device = self.graph.nodes.device
        self.dim = dim
        self.n_nodes = 0
        self.n_edges = 0
        self.cuda_graphs = {}   # capture (None: the builder's own) -> graphs

    def _f32(self, a):
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def add_node(self, pose):
        i = self.n_nodes
        g = self.graph
        nodes, valid = g.nodes.clone(), g.node_valid.clone()
        nodes[i] = self._f32(pose)
        valid[i] = True
        self.graph = dataclasses.replace(g, nodes=nodes, node_valid=valid)
        self.n_nodes += 1
        return i

    def add_edge(self, i, j, z, info=None):
        e = self.n_edges
        g = self.graph
        if info is None:
            info = np.eye(self.dim) * 100.0
        fields = {name: getattr(g, name).clone() for name in (
            "edge_i", "edge_j", "edge_z", "edge_info", "edge_valid")}
        fields["edge_i"][e] = int(i)
        fields["edge_j"][e] = int(j)
        fields["edge_z"][e] = self._f32(z)
        fields["edge_info"][e] = self._f32(info)
        fields["edge_valid"][e] = True
        self.graph = dataclasses.replace(g, **fields)
        self.n_edges += 1
        return e

    def graphs_of(self, graph, mesh=None):
        """The ``utils.graphs.CallGraphs`` of ``optimize(graph=...)`` over
        ``mesh``, None for eager launches: the builder's own for None
        (where ``utils.graphs.supported``) and True, kept across calls so
        that a solve of one key replays; one per stand-in."""
        capture = graphs.resolve(graph, self.device, mesh,
                                 "PoseGraphBuilder.optimize")
        if capture is None:
            return None
        own = None if isinstance(capture, graphs.Capture) else capture
        if own not in self.cuda_graphs:
            self.cuda_graphs[own] = graphs.CallGraphs(
                capture, "PoseGraphBuilder.optimize")
        return self.cuda_graphs[own]

    def optimize(self, iters=10, fix_mask=None, solver="dense",
                 cg_iters=32, mesh=None, robust=None, robust_delta=1.0,
                 graph=None):
        """``solver='dense'``: Cholesky of the normal matrix; ``'cg'``:
        matrix-free block-Jacobi PCG.  ``robust``: 'huber'/'dcs' edge
        reweighting.  ``mesh`` splits the PCG's edges over the ranks (the
        dense solve ignores it, as the JAX package's does).  ``graph``:
        the solve as one CUDA graph per key (``graphs_of``; the JAX
        package jits it): None (the default) on a CUDA device with no
        mesh or an NCCL mesh, else eager; True (raises where it cannot
        run); False eager.  Returns the chi2 history."""
        if fix_mask is None:
            fix_mask = torch.zeros((self.graph.nodes.shape[0],),
                                   dtype=torch.bool, device=self.device)
        cuda_graphs = self.graphs_of(graph, mesh if solver == "cg" else None)
        if solver == "cg":
            self.graph, hist = optimize_cg(
                self.graph, iters, fix_mask=fix_mask, cg_iters=cg_iters,
                mesh=mesh, robust=robust, robust_delta=robust_delta,
                cuda_graphs=cuda_graphs)
        else:
            self.graph, hist = optimize(
                self.graph, iters, fix_mask=fix_mask, robust=robust,
                robust_delta=robust_delta, cuda_graphs=cuda_graphs)
        return hist
