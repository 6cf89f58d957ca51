"""Share of the SLAM stretch's device time in the map pool's block
copies: the kernels that ``index_select``, ``index_copy_`` and ``where``
launch inside the pool's copy-on-write and rollover
(``mapping.map_pool.ensure_unique_active`` and ``rollover``, which the
harness wraps in spans in traced runs), a replayed kernel tied to the
operator its capture recorded (``harness.attribute``), in percent."""

from benchmark.harness import attribute, common


def read(ctx):
    tr = ctx["trace"]
    try:
        recs = attribute.attribute(
            ctx["window_path"], ctx["capture_path"], ctx["copy_ops"],
            ctx["copy_spans"], window=(tr.window[0] * 1e6, tr.window[1] * 1e6))
    except attribute.Unattributed as err:
        common.log(f"block_copy_share.slam: {err}")
        return None
    _, share = attribute.share(recs)
    return None if share is None else share * 100.0
