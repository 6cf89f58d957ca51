"""Keyframe manager: ties the pose-graph backend into the SLAM loop.

Port of ``slam_eslam_tpu.backend.keyframes``.  During a traverse, call
``maybe_add_keyframe`` with the current pose and scan cloud; the manager

1. stores a keyframe (pose + cloud) every ``keyframe_distance`` metres,
2. chains consecutive keyframes with odometry edges,
3. when the robot re-enters the neighbourhood of an old keyframe
   (candidate gating by distance and minimum index separation), aligns
   the current cloud against an MLS grid built from the old keyframe's
   cloud (``pose_graph.scan_align``) and, if the match passes, adds a
   loop-closure edge,
4. ``optimize()`` runs Gauss-Newton over the graph and returns the
   corrected trajectory.

Host-side orchestration; the grids, sweeps and solves run on the
manager's device (the CUDA device unless ``device`` is given).  The JAX
package's ``jax.jit`` seams around the alignment and the merge
(``static_argnames`` the sweep's steps and ``return_ratio``) are CUDA
graphs here (``graph=``, ``utils.graphs.CallGraphs``): one per key of the
static arguments and the cloud's shape, its inputs (the cloud, the pose
guesses, the grid's origin) copied into static buffers at every call; the
host reads of the score and the ratio follow the sweep outside the graph,
as they follow the jitted sweep.  ``graph=None`` (the default) is graphs
on a CUDA device and eager launches on the CPU.  ``SLAM_DEBUG_CLOSURES``
and ``SLAM_DEBUG_EDGES`` print closure and edge diagnostics, as in the
JAX package.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from slam_eslam_tpu_torch.backend import pose_graph as pgr
from slam_eslam_tpu_torch.mapping import mls_grid
from slam_eslam_tpu_torch.utils import graphs, tree


def wrap32(a):
    """``wrap_angle`` of a host angle, rounded to float32 and wrapped in
    float32 (as the JAX package's ``wrap_angle(jnp.asarray(a))``)."""
    return float(pgr.wrap_angle(torch.tensor(a, dtype=torch.float32)))


@dataclasses.dataclass
class Keyframe:
    index: int
    node_id: int
    pose: np.ndarray       # (x, y, yaw) at insertion
    cloud: object          # PatchCloud in body frame
    z: float


class KeyframeManager:
    def __init__(self, keyframe_distance=0.5, closure_radius=1.0,
                 min_separation=5, min_score=0.35, min_ratio=1.25,
                 grid_resolution=0.2, grid_cells=48,
                 max_nodes=256, max_edges=1024,
                 odom_info=100.0, odom_info_yaw=1e4,
                 closure_info=300.0, closure_info_yaw_scale=0.1,
                 yaw_prior_info=0.0,
                 align_search_xy=0.5, align_search_yaw=0.3,
                 align_steps_xy=9, align_steps_yaw=7,
                 align_sigma=0.2, align_search_z=0.0, align_steps_z=1,
                 align_coarse=None, device=None, graph=None):
        # the alignment score averages over ALL sampled cloud points
        # (misses count 0), so keyframe grids must be coarse enough that
        # the stored cloud covers most cells: the 0.2 m default
        self.kf_dist = keyframe_distance
        self.closure_radius = closure_radius
        self.min_separation = min_separation
        self.min_score = min_score
        # peak-distinctiveness gate: best score over the best far-field
        # score (scan_align(return_ratio=True)); false closures on
        # self-similar terrain ride a flat score surface.  1.0 disables
        self.min_ratio = min_ratio
        self.grid_resolution = grid_resolution
        self.grid_cells = grid_cells
        self.odom_info = odom_info
        # relative yaw between keyframes rides the IMU: odometry edges are
        # yaw-stiff, or the optimiser bends closure misfit into rotation
        self.odom_info_yaw = odom_info_yaw
        self.closure_info = closure_info
        # scan-align yaw comes from a coarse sweep: closure yaw
        # constraints carry proportionally less weight
        self.closure_info_yaw_scale = closure_info_yaw_scale
        # absolute heading prior per node (yaw-only edges to node 0) from
        # the IMU yaw passed as maybe_add_keyframe(abs_yaw=)
        self.yaw_prior_info = yaw_prior_info
        self._yaw0 = None
        # the sweep must cover the odometry drift between revisits
        self.align_search_xy = align_search_xy
        self.align_search_yaw = align_search_yaw
        self.align_steps_xy = align_steps_xy
        self.align_steps_yaw = align_steps_yaw
        self.align_sigma = align_sigma
        self.align_search_z = align_search_z
        self.align_steps_z = align_steps_z
        # coarse-to-fine: (search_xy, steps_xy, sigma) of a wide stage-A
        # sweep whose peak seeds the fine sweep
        self.align_coarse = align_coarse
        self.builder = pgr.PoseGraphBuilder(max_nodes, max_edges,
                                            device=device)
        self.device = self.builder.device
        # the jitted seams: the sweeps and grid merges as CUDA graphs (the
        # solve's graphs are the builder's, ``optimize(graph=)``)
        self.graph = graph
        capture = graphs.resolve(graph, self.device, what="KeyframeManager")
        self.graphed = capture is not None
        self.cuda_graphs = (None if capture is None else graphs.CallGraphs(
            capture, "KeyframeManager"))
        self.keyframes: list[Keyframe] = []
        self.closures: list[tuple] = []
        # per-closure diagnostics (aligned pose, score, ratio), parallel
        # to ``closures``
        self.closure_details: list[dict] = []
        self._optimized_edges = 0  # edges present at the last optimize

    def _rel_pose(self, a, b):
        """Pose of b in a's frame (the yaw wrapped in float32, as the JAX
        package does)."""
        c, s = np.cos(a[2]), np.sin(a[2])
        dt = b[:2] - a[:2]
        return np.array([c * dt[0] + s * dt[1], -s * dt[0] + c * dt[1],
                         wrap32(b[2] - a[2])], dtype=float)

    def _f32(self, a):
        return torch.tensor(np.asarray(a, np.float32), device=self.device)

    def _kf_grid(self, kf: Keyframe):
        """Local MLS grid of a keyframe's cloud, in the world frame."""
        half = self.grid_cells * self.grid_resolution / 2.0
        th = kf.pose[2]
        x = (kf.cloud,
             self._f32([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]),
             self._f32(kf.pose[:2]), self._f32(kf.z),
             self._f32([kf.pose[0] - half, kf.pose[1] - half]))
        cells, res = self.grid_cells, self.grid_resolution

        def merge(x):
            cloud, r, t, z, origin = x
            g = mls_grid.MLSGrid.create(cells, cells, res, origin, k=2,
                                        device=origin.device)
            return mls_grid.merge_cloud(g, cloud, r, t, z, 0.0, 0)

        if self.cuda_graphs is None:
            return merge(x)
        return self.cuda_graphs(("merge_cloud", cells, res), merge, x)

    def maybe_add_keyframe(self, pose_xyyaw, cloud, z=0.0,
                           probe_cloud=None, abs_yaw=None):
        """Returns ``(added, closure_or_None)``.

        ``cloud`` is stored (what later revisits align against: give it
        areal coverage, e.g. a local-map extract); ``probe_cloud`` is what
        aligns against old keyframes now (default ``cloud``)."""
        pose = np.asarray(pose_xyyaw, float)
        if self.keyframes and np.linalg.norm(
                pose[:2] - self.keyframes[-1].pose[:2]) < self.kf_dist:
            return False, None

        cloud = tree.to(cloud, self.device)
        node = self.builder.add_node(pose)
        kf = Keyframe(len(self.keyframes), node, pose, cloud, float(z))
        if self.keyframes:
            prev = self.keyframes[-1]
            self.builder.add_edge(
                prev.node_id, node, self._rel_pose(prev.pose, pose),
                info=np.diag(np.asarray([self.odom_info, self.odom_info,
                                         self.odom_info_yaw], np.float32)))
        if self.yaw_prior_info > 0 and abs_yaw is not None:
            if self._yaw0 is None:
                self._yaw0 = (float(abs_yaw), float(pose[2]))
            else:
                y0_imu, _ = self._yaw0
                self.builder.add_edge(
                    self.keyframes[0].node_id if self.keyframes else 0, node,
                    np.array([0.0, 0.0, wrap32(abs_yaw - y0_imu)]),
                    info=np.diag(np.asarray([0.0, 0.0, self.yaw_prior_info],
                                            np.float32)))
        self.keyframes.append(kf)

        closure = self._try_closure(
            kf, probe_cloud=(kf.cloud if probe_cloud is None
                             else tree.to(probe_cloud, self.device)))
        return True, closure

    def _align(self, grid, cloud, xy0, yaw0, z, **kw):
        return pgr.scan_align(
            grid, cloud, xy0, yaw0, z, search_yaw=self.align_search_yaw,
            steps_yaw=self.align_steps_yaw, search_z=self.align_search_z,
            steps_z=self.align_steps_z, cuda_graphs=self.cuda_graphs, **kw)

    def _try_closure(self, kf: Keyframe, top_k=3, probe_cloud=None):
        if probe_cloud is None:
            probe_cloud = kf.cloud
        cands = []
        for old in self.keyframes[: max(0, kf.index - self.min_separation)]:
            d = np.linalg.norm(kf.pose[:2] - old.pose[:2])
            if d < self.closure_radius:
                cands.append((d, old))
        if not cands:
            return None
        cands.sort(key=lambda t: t[0])

        # align against the closest few candidates and keep the best
        # score: with drift the nearest believed keyframe is often the
        # wrong physical place
        best = None
        for _, old in cands[:top_k]:
            grid = self._kf_grid(old)
            xy0 = self._f32(kf.pose[:2])
            yaw0 = self._f32(kf.pose[2])
            if self.align_coarse is not None:
                csearch, csteps, csigma = self.align_coarse
                xy0, yaw0, _ = self._align(
                    grid, probe_cloud, xy0, yaw0, self._f32(kf.z),
                    search_xy=csearch, steps_xy=csteps, sigma=csigma)
            xy, yaw, score, ratio = self._align(
                grid, probe_cloud, xy0, yaw0, self._f32(kf.z),
                search_xy=self.align_search_xy,
                steps_xy=self.align_steps_xy, sigma=self.align_sigma,
                return_ratio=True)
            score, ratio = torch.stack([score, ratio]).tolist()
            if best is None or score > best[0]:
                best = (score, old, xy, yaw, ratio)
        score, old, xy, yaw, ratio = best
        if score < self.min_score or ratio < self.min_ratio:
            return None
        corrected = np.array(torch.cat([xy, yaw[None]]).tolist())
        if os.environ.get("SLAM_DEBUG_CLOSURES"):
            print(f"closure kf{old.index}<-kf{kf.index}: believed "
                  f"{kf.pose.round(3)} aligned {corrected.round(3)} "
                  f"score {score:.3f} ratio {ratio:.2f}")
        z_rel = self._rel_pose(old.pose, corrected)
        ci = self.closure_info * score
        self.builder.add_edge(
            old.node_id, kf.node_id, z_rel,
            info=np.diag(np.asarray(
                [ci, ci, ci * self.closure_info_yaw_scale], np.float32)))
        self.closures.append((old.index, kf.index, score))
        self.closure_details.append(dict(
            old=old.index, new=kf.index, score=score, ratio=ratio,
            corrected=corrected, believed=kf.pose.copy(),
            edge=self.builder.n_edges - 1))
        return (old.index, kf.index, score)

    def prune_closures(self, consist=1.0, window=2):
        """Median-consistency gate over accepted closures: each closure's
        implied world correction (aligned - believed at the new keyframe)
        should agree with its neighbours'; an inconsistent one is an
        along-track mis-lock even when its score is high.  Invalidates the
        pruned closures' edges and returns the number removed.  Call once
        before ``optimize``."""
        det = self.closure_details
        if len(det) < 3:
            return 0
        deltas = np.stack([d["corrected"][:2] - d["believed"][:2]
                           for d in det])
        med = np.stack([
            np.median(deltas[max(0, i - window):i + window + 1], axis=0)
            for i in range(len(det))])
        bad = np.linalg.norm(deltas - med, axis=1) > consist
        g = self.builder.graph
        ev = g.edge_valid.clone()
        for d, b in zip(det, bad):
            if b:
                ev[d["edge"]] = False
                d["pruned"] = True
        self.builder.graph = dataclasses.replace(g, edge_valid=ev)
        return int(bad.sum())

    def optimize(self, iters=10, incremental=False, margin=3,
                 solver="dense", mesh=None, cg_iters=32, robust=None,
                 robust_delta=1.0):
        """Re-solve the graph; returns ``(trajectory [K, 3] numpy,
        chi2_history)``.

        ``incremental=True`` freezes every node older than (the earliest
        node an edge added since the last optimize touches) - ``margin``
        through the solver's ``fix_mask``, and is a no-op (the cached
        trajectory and an empty history) when nothing new arrived.
        ``solver``: ``'dense'`` or ``'cg'`` (``PoseGraphBuilder.
        optimize``, with this manager's ``graph``)."""
        if os.environ.get("SLAM_DEBUG_EDGES"):
            g = self.builder.graph
            n_e = self.builder.n_edges
            r = pgr.edge_residuals(g)[0].cpu().numpy()
            info = g.edge_info[:n_e].diagonal(dim1=1, dim2=2).cpu().numpy()
            chi = (r[:n_e] ** 2 * info).sum(-1)
            ei, ej = g.edge_i.cpu().numpy(), g.edge_j.cpu().numpy()
            ez = g.edge_z.cpu().numpy()
            for e in np.argsort(-chi)[:10]:
                print(f"edge {int(ei[e])}->{int(ej[e])} chi2 {chi[e]:.1f} "
                      f"resid {r[e].round(3)} z {ez[e].round(3)}")

        fix_mask = None
        if incremental:
            b = self.builder
            if b.n_edges == self._optimized_edges:
                return self.trajectory(), torch.zeros((0,),
                                                      device=self.device)
            new_sl = slice(self._optimized_edges, b.n_edges)
            touched = int(torch.minimum(b.graph.edge_i[new_sl].min(),
                                        b.graph.edge_j[new_sl].min()))
            cut = max(0, touched - margin)
            fix_mask = torch.arange(b.graph.nodes.shape[0],
                                    device=self.device) < cut
        hist = self.builder.optimize(
            iters, fix_mask=fix_mask, solver=solver, mesh=mesh,
            cg_iters=cg_iters, robust=robust, robust_delta=robust_delta,
            graph=self.graph)
        self._optimized_edges = self.builder.n_edges
        return self.trajectory(), hist

    def trajectory(self):
        n = len(self.keyframes)
        return self.builder.graph.nodes[:n].cpu().numpy()
