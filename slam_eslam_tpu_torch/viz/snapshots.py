"""Periodic rendering of a running filter: the offline counterpart of the
reference's live viewer.

Port of ``slam_eslam_tpu.viz.snapshots``.  The reference renders the
running filter at 10 Hz with click-to-inspect of one particle's map
(``test/testMap.cpp:325-356``, ``viz/ParticleVisualization.cpp:24-36``,
``viz/MapVizEventFilter.hpp:12-114``).  Wired into a drive loop, this
recorder writes a numbered PNG every ``every`` updates: the particle
cloud (weight-scaled, floating/contact colouring), the inspected
particle's composited map chain and the reference-vs-centroid
trajectories.
"""

from __future__ import annotations

import os

import numpy as np


class SnapshotRecorder:
    """Render the filter every ``every`` calls to :meth:`maybe`.

    ``inspect``: ``'best'`` re-picks the max-weight particle each frame
    (the reference's default inspection target), or a fixed particle
    index (the click-to-inspect analog)."""

    def __init__(self, out_dir, every=5, inspect="best", dpi=90):
        self.out_dir = out_dir
        self.every = max(1, every)
        self.inspect = inspect
        self.dpi = dpi
        self.count = 0
        self.frames = []
        self._truth = []
        self._centroid = []
        os.makedirs(out_dir, exist_ok=True)

    def maybe(self, filt, truth=None):
        """Record state; render when the period hits.  ``filt`` is an
        ``EmbodiedSlamFilter``; ``truth`` an optional ground-truth
        position [3].  Returns the written path or None."""
        c_pos, _ = filt.get_centroid()
        self._centroid.append(c_pos.cpu().numpy())
        if truth is not None:
            self._truth.append(np.asarray(truth))
        self.count += 1
        if (self.count - 1) % self.every:
            return None
        return self._render(filt)

    def _render(self, filt):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from slam_eslam_tpu_torch.viz import render

        best = filt.get_best_particle_index()
        idx = best if self.inspect == "best" else self.inspect
        has_map = filt.pool is not None
        n_ax = 2 + has_map
        fig, axes = plt.subplots(1, n_ax, figsize=(6 * n_ax, 6))
        render.draw_particles(filt.state.particles, ax=axes[0],
                              best_index=best)
        axes[0].set_title(f"particles (frame {self.count - 1})")
        render.draw_trajectories(
            reference=np.asarray(self._truth) if self._truth else None,
            centroid=np.asarray(self._centroid), ax=axes[1])
        axes[1].set_title("trajectories")
        if has_map:
            render.draw_particle_map(filt.pool, idx, ax=axes[2])
            axes[2].set_title(f"particle {idx} map")
        path = os.path.join(self.out_dir, f"frame_{len(self.frames):04d}.png")
        fig.savefig(path, dpi=self.dpi, bbox_inches="tight")
        plt.close(fig)
        self.frames.append(path)
        return path
