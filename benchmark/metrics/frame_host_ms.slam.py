"""Host milliseconds a SLAM frame spends in the port outside its CUDA
graph's launch: the runner call's span less its ``graph replay N`` spans
(the gates, the carry bound to the static buffers, the inputs copied in,
the results copied out; ``slam_eslam_tpu_torch.utils.tracing``), the mean
over the traced stretch's frames."""

from benchmark.harness import program_trace
from benchmark.harness.trace import REPLAY_SPAN

NAME = "frame_host_ms.slam"


def read(ctx):
    got = program_trace.calls(ctx, NAME)
    if got is None:
        return None
    inside, recs = got
    ids = {c.id for c in inside}
    outside = {c.id: recs.spans[c.span].end - recs.spans[c.span].start
               for c in inside}
    for s in recs.spans:
        if s.call in ids and s.name.startswith(REPLAY_SPAN):
            outside[s.call] -= s.end - s.start
    return sum(outside.values()) / len(outside) * 1e-6
