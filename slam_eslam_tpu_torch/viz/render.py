"""Offline plots (matplotlib): particles, GMM ellipses, grids, one
particle's map, trajectories.

Port of ``slam_eslam_tpu.viz.render``, the headless stand-in for the
reference's Qt/OSG viewer (``viz/ParticleVisualization.cpp:98-128``,
``viz/MapVizEventFilter.hpp``, ``viz/EslamWidget.cpp:16-42``).  Every
function draws onto a given or a new matplotlib ``Axes`` and returns it;
matplotlib is imported only when drawing, so the module imports where
it is not installed.  Tensors may lie on any device: what a plot reads is
copied to the host, and no more than that.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(a):
    """Tensor (any device, any float type) or array-like -> NumPy."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:   # NumPy has no bfloat16
            a = a.float()
        return a.numpy()
    return np.asarray(a)


def _ax(ax):
    if ax is None:
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        _, ax = plt.subplots(figsize=(7, 7))
    return ax


def _top_surface(mean, valid):
    """The highest valid patch per cell ``[..., K] -> [...]``, NaN where a
    cell has none."""
    z = np.where(valid, mean, -np.inf).max(axis=-1)
    return np.where(np.isfinite(z), z, np.nan)


def _extent(origin, nx, ny, resolution):
    return [origin[0], origin[0] + nx * resolution,
            origin[1], origin[1] + ny * resolution]


def draw_particles(particles, ax=None, best_index=None, scale=2000.0):
    """Particle cloud: size ~ weight, red = floating, grey = in contact,
    cyan = inspected/best."""
    ax = _ax(ax)
    xy = _host(particles.xy)
    w = _host(particles.weight)
    floating = _host(particles.floating)
    sizes = 4.0 + scale * w / max(w.sum(), 1e-12) / len(w) * 100.0
    colors = np.where(floating, "red", "grey").astype(object)
    if best_index is not None:
        colors[int(best_index)] = "cyan"
    ax.scatter(xy[:, 0], xy[:, 1], s=sizes, c=list(colors), alpha=0.6,
               edgecolors="none")
    # heading ticks
    yaw = _host(particles.yaw)
    ax.quiver(xy[:, 0], xy[:, 1], np.cos(yaw), np.sin(yaw),
              scale=60, width=0.002, alpha=0.3)
    ax.set_aspect("equal")
    return ax


def draw_gmm(means, covs, weights, ax=None, n_sigma=2.0):
    """GMM uncertainty ellipses (eigendecomposition of each covariance)."""
    from matplotlib.patches import Ellipse

    ax = _ax(ax)
    for mean, cov, w in zip(_host(means), _host(covs), _host(weights)):
        vals, vecs = np.linalg.eigh(cov)
        angle = np.degrees(np.arctan2(vecs[1, 1], vecs[0, 1]))
        ax.add_patch(Ellipse(
            mean, 2 * n_sigma * np.sqrt(max(vals[1], 0)),
            2 * n_sigma * np.sqrt(max(vals[0], 0)),
            angle=angle, fill=False, color="blue",
            alpha=min(1.0, 0.2 + w),
        ))
    return ax


def draw_grid(grid, ax=None, cmap="terrain"):
    """MLS grid heightmap (top patch mean per cell; invalid = NaN)."""
    ax = _ax(ax)
    z = _top_surface(_host(grid.mean), _host(grid.valid))
    im = ax.imshow(z.T, origin="lower", cmap=cmap, interpolation="nearest",
                   extent=_extent(_host(grid.origin), grid.nx, grid.ny,
                                  grid.resolution))
    ax.figure.colorbar(im, ax=ax, shrink=0.8, label="height [m]")
    return ax


def chain_layers(pool, particle_index):
    """One particle's map chain as drawable layers, head first: ``[(z
    [nx, ny] float32, NaN where a cell has no patch; extent [x0, x1, y0,
    y1])]``, one per chain entry that holds a block.

    Only the chain's blocks are gathered on the pool's device and copied
    to the host (the field rows upcast to float32 there): the pool's
    ``valid`` property would build a mask of the whole pool (10 GB at
    400,000 blocks) to draw three blocks."""
    chain = pool.chain[int(particle_index)].cpu().numpy()
    blocks = chain[chain >= 0]
    if blocks.size == 0:
        return []
    idx = torch.from_numpy(blocks.astype(np.int64)).to(pool.mean.device)
    shape = (len(blocks), pool.nx, pool.ny, pool.k)
    mean = pool.mean.index_select(0, idx).float().cpu().numpy()
    valid = (pool.meta.index_select(0, idx) & 1).cpu().numpy() != 0
    z = _top_surface(mean.reshape(shape), valid.reshape(shape))
    origins = pool.origin.index_select(0, idx).cpu().numpy()
    return [(z[i], _extent(origins[i], pool.nx, pool.ny, pool.resolution))
            for i in range(len(blocks))]


def draw_particle_map(pool, particle_index, ax=None, cmap="terrain"):
    """Inspect one particle's map: its grid chain composited head last
    (on top), the single-map view of ``MapVizEventFilter``."""
    ax = _ax(ax)
    layers = chain_layers(pool, particle_index)
    for z, extent in reversed(layers):
        im = ax.imshow(z.T, origin="lower", extent=extent, cmap=cmap,
                       interpolation="nearest")
    if layers:
        ax.figure.colorbar(im, ax=ax, shrink=0.8, label="height [m]")
    return ax


def draw_trajectories(reference=None, centroid=None, ax=None):
    """Reference vs centroid trajectory overlay (EslamWidget's two
    trajectory plugins)."""
    ax = _ax(ax)
    if reference is not None:
        r = _host(reference)
        ax.plot(r[:, 0], r[:, 1], "g-", label="reference", linewidth=1.5)
    if centroid is not None:
        c = _host(centroid)
        ax.plot(c[:, 0], c[:, 1], "b--", label="centroid", linewidth=1.5)
    ax.legend()
    ax.set_aspect("equal")
    return ax


def render_distribution(dist, path=None, grid=None):
    """One-call snapshot: grid + particles + GMM; saved to ``path`` (and
    the path returned) when given, else the figure returned."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    if grid is not None:
        draw_grid(grid, ax=ax)
    draw_particles(dist.particles, ax=ax)
    draw_gmm(dist.gmm_means, dist.gmm_covs, dist.gmm_weights, ax=ax)
    if path:
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig
