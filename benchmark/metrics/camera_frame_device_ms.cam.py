"""Device milliseconds of a camera mapping frame: from the first stage
mark the device writes in the frame to its last
(``slam_eslam_tpu_torch.utils.tracing``), the mean over the traced
stretch's camera mapping frames (the frames with a ``camera cloud``
stage)."""

from benchmark.harness import common, program_trace

NAME = "camera_frame_device_ms.cam"


def read(ctx):
    got = program_trace.calls(ctx, NAME)
    if got is None:
        return None
    from slam_eslam_tpu_torch.utils import tracing

    spans = [tracing.extent_ns(c.marks) for c in got[0]
             if "camera cloud" in tracing.stage_ns(c.marks)]
    if not spans or None in spans:
        common.log(f"{NAME}: no camera frame with its stage marks in the "
                   f"stretch")
        return None
    return sum(spans) / len(spans) * 1e-6
