"""Device milliseconds of a SLAM frame that maps: from the first stage
mark the device writes in the frame to its last
(``slam_eslam_tpu_torch.utils.tracing``), the mean over the traced
stretch's mapping frames (the frames with a ``merge`` stage)."""

from benchmark.harness import common, program_trace

NAME = "mapping_frame_device_ms.slam"


def read(ctx):
    got = program_trace.calls(ctx, NAME)
    if got is None:
        return None
    from slam_eslam_tpu_torch.utils import tracing

    spans = [tracing.extent_ns(c.marks)
             for c in program_trace.mapping(got[0])]
    if not spans or None in spans:
        common.log(f"{NAME}: no mapping frame with its stage marks in the "
                   f"stretch")
        return None
    return sum(spans) / len(spans) * 1e-6
