"""Device milliseconds a localisation step spends weighting and
resampling its particles: the port's stage marks ``weights`` and
``resample`` (stamps that the device writes inside each replayed step,
``slam_eslam_tpu_torch.utils.tracing``), summed over the traced stretch's
runner calls, over the steps they ran (one ``project`` stage a step)."""

from benchmark.harness import program_trace

NAME = "update_device_ms.loc"


def read(ctx):
    got = program_trace.calls(ctx, NAME)
    if got is None:
        return None
    from slam_eslam_tpu_torch.utils import tracing

    ns = steps = 0
    for call in got[0]:
        stages = tracing.stage_ns(call.marks)
        ns += stages.get("weights", 0) + stages.get("resample", 0)
        steps += sum(m.name == "project" and m.kind == "enter"
                     for m in call.marks)
    return ns / steps * 1e-6 if steps else None
