"""OnlineSlam: the full-stack loop in one object.

Port of ``slam_eslam_tpu.online``.  Three layers around the reference's
filter in one object:

* ``EmbodiedSlamFilter`` in per-particle-map mode, run in chunks of
  frames (``run_stream``: the chain lookup K2 in every measurement frame,
  the block merge K3 in every mapping frame);
* the keyframe manager (revisit detection and scan-to-map closures);
* the pose-graph backend (incremental robust Gauss-Newton).

Typical use::

    slam = OnlineSlam(config=cfg, laser2body=(rot, trans))
    slam.init(pose=(xyz, yaw))
    for chunk in frame_chunks:          # streaming.SlamFrames
        slam.process_chunk(chunk)
    traj, hist = slam.optimize()        # corrected keyframe trajectory

Everything runs on the CUDA device unless ``device`` is given.  With a
device ``mesh`` the filter holds this rank's particles and pool (pass
them through ``parallel.sharding.shard_state`` / ``shard_pool`` after
``init``); every rank runs the same chunks, finds the same best particle
over the mesh, reads its map blocks from the ranks that hold them and
keeps the same keyframes and pose graph.  ``graph=None`` (the default,
as the JAX package jits every seam) runs the chunk as CUDA graphs on a
CUDA device with no mesh or an NCCL mesh (``run_stream``, the keyframe
grids and sweeps, the pose-graph solve) and eagerly on the CPU and over a
gloo or host mesh.  The JAX
package's raw-scan keyframes (its shared-map branch of
``process_chunk``) are not ported: ``run_stream`` raises in shared-map
mode in both packages, so that branch never runs.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_eslam_tpu_torch.backend.keyframes import KeyframeManager
from slam_eslam_tpu_torch.config import Config
from slam_eslam_tpu_torch.core import filter as pf
from slam_eslam_tpu_torch.filter.eslam_filter import EmbodiedSlamFilter
from slam_eslam_tpu_torch.mapping.map_pool import fetch_rows
from slam_eslam_tpu_torch.mapping.mls_grid import PatchCloud
from slam_eslam_tpu_torch.utils import geometry, graphs, tree
from slam_eslam_tpu_torch.utils.device import entry_device

class OnlineSlam:
    """``donate``: the JAX package donates the scan carry per chunk to
    halve peak pool memory; the port's ``run_stream`` always updates the
    pool in place, so the flag is accepted and changes nothing.
    ``submap_scans`` belongs to the raw-scan branch (module docstring); it
    is accepted for the same call shape and read nowhere.  ``graph=True``
    runs every chunk as CUDA graphs: ``run_stream(graph=True)`` (one graph
    per gate combination, captured once and replayed in every later
    chunk), the keyframe grids and sweeps and the solve
    (``KeyframeManager(graph=True)``), each bit for bit its eager run;
    CUDA only, and a mesh only over NCCL.  ``graph=None`` (the default):
    the same where the device and the mesh allow it, else eager;
    ``graphed`` says which."""

    def __init__(self, config: Config = None, laser2body=None,
                 keyframe_kw=None, mesh=None, camera2body=None,
                 camera_intrinsics=None, camera_texture=False,
                 odometry_config=None, submap_scans=1, donate=False,
                 probe_recent=60, device=None, graph=None):
        self.mesh = mesh
        self.graph = graph
        self.graphed = graphs.resolve(graph, entry_device(device), mesh,
                                      "OnlineSlam") is not None
        self.filter = EmbodiedSlamFilter(odometry_config=odometry_config,
                                         config=config, device=device,
                                         graph=graph)
        self.device = self.filter.device
        self.keyframes = KeyframeManager(**(keyframe_kw or {}),
                                         device=self.device, graph=graph)
        self.laser2body = laser2body
        self.camera2body = camera2body
        self.camera_intrinsics = camera_intrinsics
        self.camera_texture = camera_texture
        # global frame index of each accepted keyframe
        self.keyframe_frames = []
        self._frame_base = 0
        # keyframe-cloud recency window (in map update counts): the
        # per-particle map still holds the out-leg terrain at drifted
        # coordinates on a revisit; only patches merged within the last
        # ``probe_recent`` map updates enter keyframe clouds (None: all)
        self.probe_recent = probe_recent

    def init(self, pose, **kw):
        kw.setdefault("use_shared_map", False)
        self.filter.init(pose=pose, **kw)
        return self

    def process_chunk(self, frames, draws=None):
        """Run one ``streaming.SlamFrames`` chunk through ``run_stream``
        (``draws``: one ``step.StepDraws`` per frame, else the filter's
        generator), then offer the end-of-chunk state to the keyframe
        manager: one keyframe opportunity per chunk, at the best
        particle's pose, with its local map as the cloud.  Returns the
        streaming ``aux``."""
        frames = tree.to(frames, self.device)
        aux = self.filter.run_stream(
            frames, laser2body=self.laser2body,
            camera2body=self.camera2body,
            camera_intrinsics=self.camera_intrinsics,
            camera_texture=self.camera_texture, draws=draws, mesh=self.mesh,
            graph=self.graph)
        mapped = aux["mapped"]
        frame_base = self._frame_base
        n_chunk = mapped.shape[0]
        self._frame_base += n_chunk
        if not mapped.any():
            return aux
        # the end-of-chunk state, where the pool, the best particle and
        # its pose are consistent
        p = self.filter.state.particles
        if self.mesh is None:
            bi = self.filter.get_best_particle_index()
        else:
            bi = int(torch.argmax(self.mesh.all_gather(p.weight)))
            p = pf.take(p, torch.tensor([bi], device=self.device), self.mesh)
            bi = 0
        pose = np.array(torch.stack([p.x[bi], p.y[bi], p.yaw[bi],
                                     p.z[bi]]).tolist())
        kf_cloud = self._local_map_cloud(pose, best=bi)
        if kf_cloud is not None:
            abs_yaw = float(geometry.yaw_from_quat(
                torch.from_numpy(frames.host_q[n_chunk - 1])))
            added, _closure = self.keyframes.maybe_add_keyframe(
                pose[:3], kf_cloud, z=float(pose[3]), abs_yaw=abs_yaw)
            if added:
                self.keyframe_frames.append(frame_base + n_chunk - 1)
        return aux

    def _local_map_cloud(self, kf_pose, radius=4.0, max_points=1024,
                         best=None):
        """The best particle's accumulated local map as a body-frame
        ``PatchCloud`` around ``kf_pose`` (the areal keyframe signature the
        closure alignment needs), padded to ``max_points``.  The head
        chain's blocks are gathered on the device in one index per field
        and copied to the host once; the cell de-duplication runs there.
        None when there is no per-particle pool or no patch."""
        pool = self.filter.pool
        if pool is None:
            return None
        if self.mesh is not None:
            # ``best`` is the row of the gathered best particle: its chain
            # comes from every rank's rows
            w = self.mesh.all_gather(self.filter.state.particles.weight)
            chain = pool.resample(torch.argmax(w).reshape(1), self.mesh).chain
            chain = chain[0].cpu().numpy()
        else:
            if best is None:
                best = self.filter.get_best_particle_index()
            chain = pool.chain[best].cpu().numpy()
        blocks = chain[chain >= 0]
        if blocks.size == 0:
            return None
        idx = torch.from_numpy(blocks.astype(np.int64)).to(self.device)
        names = ("meta", "mean", "stdev", "origin")
        if pool.mesh is None:
            rows = {f: getattr(pool, f).index_select(0, idx) for f in names}
        else:
            rows = fetch_rows(pool, idx, names, "keyframe blocks")
        host = lambda f: rows[f].float().cpu().numpy() if f != "meta" \
            else rows[f].cpu().numpy()
        shape = (len(blocks), pool.nx, pool.ny, pool.k)
        metas = host("meta").reshape(shape)
        means = host("mean").reshape(shape)
        stdevs = host("stdev").reshape(shape)
        origins = host("origin")
        cur = int(self.filter.update_idx)
        min_uidx = (cur - self.probe_recent
                    if self.probe_recent is not None else 0)
        pts = []
        seen = np.zeros((0,), np.int64)
        for meta, mean, stdev, origin in zip(metas, means, stdevs, origins):
            # head first: newer grids win
            valid = (meta & 1) != 0
            if min_uidx > 0:
                valid &= (meta >> 2) >= min_uidx
            if not valid.any():
                continue
            ix, iy, sl = np.nonzero(valid)
            wx = (origin[0] + (ix + 0.5) * pool.resolution).astype(
                np.float32)
            wy = (origin[1] + (iy + 0.5) * pool.resolution).astype(
                np.float32)
            key = (np.round(wx / pool.resolution).astype(np.int64)
                   * 1_000_003
                   + np.round(wy / pool.resolution).astype(np.int64))
            # the first slot per cell wins within the block, earlier
            # (newer) chain blocks across blocks
            _, first = np.unique(key, return_index=True)
            keep = np.zeros(len(key), bool)
            keep[first] = True
            if seen.size:
                keep &= ~np.isin(key, seen)
            if not keep.any():
                continue
            seen = np.concatenate([seen, key[keep]])
            pts.append(np.stack([wx[keep], wy[keep], mean[ix, iy, sl][keep],
                                 stdev[ix, iy, sl][keep]], axis=1))
        if not pts:
            return None
        a = np.concatenate(pts).astype(np.float32)
        d = np.hypot(a[:, 0] - kf_pose[0], a[:, 1] - kf_pose[1])
        a = a[d <= radius]
        if a.shape[0] == 0:
            return None
        if a.shape[0] > max_points:
            a = a[np.linspace(0, a.shape[0] - 1, max_points, dtype=int)]
        # one fixed size for every keyframe cloud (match_cloud normalises
        # by the valid count, so padding does not dilute scores)
        n_pts = a.shape[0]
        if n_pts < max_points:
            a = np.concatenate(
                [a, np.zeros((max_points - n_pts, 4), np.float32)])
        # world -> keyframe body frame (yaw-compensated; z relative to
        # the keyframe's believed z, as scan clouds)
        c, s = np.cos(kf_pose[2]), np.sin(kf_pose[2])
        rx = a[:, 0] - kf_pose[0]
        ry = a[:, 1] - kf_pose[1]
        f32 = lambda v: torch.tensor(np.asarray(v), dtype=torch.float32,
                                     device=self.device)
        return PatchCloud.create(
            xy=f32(np.stack([c * rx + s * ry, -s * rx + c * ry], 1)),
            z=f32(a[:, 2] - kf_pose[3]),
            stdev=f32(np.maximum(a[:, 3], 0.01)),
            valid=torch.tensor(np.arange(max_points) < n_pts,
                               device=self.device))

    def optimize(self, iters=10, incremental=True, robust="dcs", **kw):
        """Incremental robust re-solve of the keyframe graph.  Returns
        ``(trajectory [K, 3], chi2_history)``."""
        return self.keyframes.optimize(iters=iters, incremental=incremental,
                                       robust=robust, **kw)

    @property
    def centroid(self):
        return self.filter.get_centroid()

    def trajectory(self):
        return self.keyframes.trajectory()
