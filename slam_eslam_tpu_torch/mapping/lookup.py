"""Map-lookup adapters: the seam between the contact model and the map.

Port of ``slam_eslam_tpu.mapping.lookup`` for the shared-map mode
(``EmbodiedSlamFilter.cpp:73-101``).  The JAX factory picks between an
XLA gather and VMEM-window Pallas kernels with a spread fallback; on a
GPU the whole packed grid (5 MB at the reference's 400x400 cells) sits
in L2, so every ``lookup_mode`` gets the one full-grid lookup and no
query can miss a window.  The packed lookup runs kernel K5
(``ops.select_cells``) on CUDA tensors, and the contact fold kernel K1
(``ops.contact_fold``); the slip update's colour lookup stays a plain
gather (``mls_grid.get_patch``), as in the JAX package.
"""

from __future__ import annotations

from slam_eslam_tpu_torch.mapping import mls_grid
from slam_eslam_tpu_torch.ops.contact_fold import contact_fold
from slam_eslam_tpu_torch.ops.select_cells import select_cells


def shared_grid_lookup(grid, z_window=3.0, packed=True):
    """All particles query one shared grid; ``map_id`` is ignored.

    With ``packed`` (default) the grid is repacked into the
    single-gather ``PackedLookup`` and ``lookup(map_id, points)`` takes
    ``[..., 3]`` points, answered with ``(found, mean, stdev, color)``
    (colour zeros), or SoA ``(x, y, z)`` tensors, answered with
    ``(found, mean, stdev)`` (``lookup.soa``), both through
    ``ops.select_cells``.  ``packed=False`` needs an ``MLSGrid`` and
    answers ``[..., 3]`` points with the patch colours the slip/terrain
    update reads (``mls_grid.get_patch``)."""
    if not (packed or isinstance(grid, mls_grid.PackedLookup)):
        def lookup(map_id, points):
            del map_id
            return mls_grid.get_patch(grid, points, z_window)

        lookup.batched = True
        lookup.soa = False
        return lookup

    pl = (grid if isinstance(grid, mls_grid.PackedLookup)
          else mls_grid.PackedLookup.from_grid(grid))

    def lookup(map_id, points):
        del map_id
        if isinstance(points, tuple):
            return select_cells(pl, points, z_window)
        found, mean, stdev = select_cells(
            pl, (points[..., 0], points[..., 1], points[..., 2]), z_window)
        return found, mean, stdev, mean.new_zeros(mean.shape + (3,))

    lookup.batched = True
    lookup.soa = True
    lookup.packed = pl
    return lookup


def make_lookup(cfg, grid, mesh=None):
    """Shared-grid lookup ``lookup(map_id, points)`` for ``cfg``
    (``shared_grid_lookup``).  ``lookup.fold`` is the contact fold
    (kernel K1 on CUDA tensors).  ``use_slip_update`` returns the
    unpacked colour-carrying lookup, without a fold, as the JAX package
    does.  ``grid`` is an ``MLSGrid`` or a ``PackedLookup``.  On a device
    ``mesh`` the grid is replicated on every rank and the lookup answers
    this rank's particles' queries, K1 (and K5) shard-locally: a query
    reads the grid and nothing of another particle, so nothing crosses
    the mesh (the JAX package's ``shard_map`` of its window kernel)."""
    del mesh  # every rank holds the whole grid
    if cfg.lookup_mode not in ("gather", "window", "auto"):
        raise ValueError(f"unknown lookup_mode {cfg.lookup_mode!r}")
    z_window = cfg.mls_z_window
    if cfg.contact_model.use_slip_update:
        return shared_grid_lookup(grid, z_window, packed=False)
    lookup = shared_grid_lookup(grid, z_window)
    packed = lookup.packed

    def fold(queries, act_col, mv, *, onehot=None, correction, seg=None):
        """``[C, N]`` SoA queries -> ``[8, N]`` per-particle rows
        (``ops.contact_fold.contact_fold``); the groups as ``onehot
        [C, S]``, as int32 ids ``seg [C]``, or both."""
        return contact_fold(packed, queries, act_col, mv, onehot=onehot,
                            correction=correction, z_window=z_window, seg=seg)

    lookup.fold = fold
    return lookup
