"""Map-lookup adapter: the seam between the contact model and the map.

Port of ``slam_eslam_tpu.mapping.lookup.make_lookup`` for the shared-map
mode (``EmbodiedSlamFilter.cpp:73-101``).  The JAX factory picks between
an XLA gather and a VMEM-window Pallas kernel with a spread fallback;
on a GPU the whole packed grid (5 MB at the reference's 400x400 cells)
sits in L2, so every ``lookup_mode`` gets the one full-grid lookup and
no query can miss a window.
"""

from __future__ import annotations

from slam_eslam_tpu_torch.mapping import mls_grid
from slam_eslam_tpu_torch.ops.contact_fold import contact_fold


def make_lookup(cfg, grid):
    """Shared-grid lookup ``lookup(map_id, points)`` for ``cfg``.

    ``points`` is either an ``[..., 3]`` tensor, answered with
    ``(found, mean, stdev, color)``, or SoA ``(x, y, z)`` tensors,
    answered with ``(found, mean, stdev)`` (``lookup.soa``).
    ``lookup.fold`` is the contact fold (kernel K1 on CUDA tensors).
    ``grid`` is an ``MLSGrid`` or a ``PackedLookup``; ``map_id`` is
    ignored.
    """
    if cfg.lookup_mode not in ("gather", "window", "auto"):
        raise ValueError(f"unknown lookup_mode {cfg.lookup_mode!r}")
    if cfg.contact_model.use_slip_update:
        raise NotImplementedError(
            "use_slip_update needs patch colours, which the port's packed "
            "lookup does not carry yet"
        )
    packed = (grid if isinstance(grid, mls_grid.PackedLookup)
              else mls_grid.PackedLookup.from_grid(grid))
    z_window = cfg.mls_z_window

    def lookup(map_id, points):
        del map_id
        if isinstance(points, tuple):
            xq, yq, zq = points
            ix, iy = mls_grid.cells(packed, xq, yq)
            return mls_grid.get_patch_packed_cells(packed, ix, iy, zq,
                                                   z_window)
        return mls_grid.get_patch_packed(packed, points, z_window)

    def fold(queries, act_col, mv, *, onehot, correction):
        """``[C, N]`` SoA queries -> ``[8, N]`` per-particle rows
        (``ops.contact_fold.contact_fold``)."""
        return contact_fold(packed, queries, act_col, mv, onehot=onehot,
                            correction=correction, z_window=z_window)

    lookup.batched = True
    lookup.soa = True
    lookup.fold = fold
    return lookup
