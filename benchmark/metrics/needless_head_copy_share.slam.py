"""Share of the head rows that the map pool's copy-on-write and rollover
write in the traced stretch's mapping frames with nothing to copy, in
percent: 100 (1 - (heads copied + heads started) / head rows written),
from the pool's counters (``pool.heads_copied``, ``pool.heads_started``,
``pool.head_rows_moved``; ``slam_eslam_tpu_torch.utils.tracing``).  A
row that needs no copy is written with its own content, so this is the
part of the pool's copies that a copy of the needed rows alone saves."""

from benchmark.harness import common, program_trace

NAME = "needless_head_copy_share.slam"


def read(ctx):
    got = program_trace.calls(ctx, NAME)
    if got is None:
        return None
    from slam_eslam_tpu_torch.utils import tracing

    total = {}
    for call in program_trace.mapping(got[0]):
        for name, v in tracing.counts(call.marks).items():
            total[name] = total.get(name, 0) + v
    moved = total.get("pool.head_rows_moved", 0)
    if not moved:
        common.log(f"{NAME}: no head row written in the stretch")
        return None
    needed = (total.get("pool.heads_copied", 0)
              + total.get("pool.heads_started", 0))
    return 100.0 * (1.0 - needed / moved)
