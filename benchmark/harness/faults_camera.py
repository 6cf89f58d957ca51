"""A fault of the camera cell planted in the port underneath a run, for
the harness's tests: the merge takes only the cloud's first
``block_merge.MAX_POINTS`` (16,384) points, as a merge capped at one
CTA's sort would, and drops the rest of the image.  The run's check has
to come out not correct.  ``run.py`` never plants it."""

from __future__ import annotations

import contextlib
import dataclasses

FIRST_POINTS = 16384


@contextlib.contextmanager
def first_points(limit=FIRST_POINTS):
    """Every merge sees only the first ``limit`` points of its cloud, for
    the duration (before the runners are built and captured, so the
    captures hold it)."""
    from slam_eslam_tpu_torch.mapping import map_pool

    real = map_pool.merge_cloud_all

    def fault(pool, xy, yaw, z_offset, offset_stdev, cloud, *a, **kw):
        head = {f.name: getattr(cloud, f.name)[:limit]
                for f in dataclasses.fields(cloud)}
        return real(pool, xy, yaw, z_offset, offset_stdev,
                    dataclasses.replace(cloud, **head), *a, **kw)

    map_pool.merge_cloud_all = fault
    try:
        yield
    finally:
        map_pool.merge_cloud_all = real
