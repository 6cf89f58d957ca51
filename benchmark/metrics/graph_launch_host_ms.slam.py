"""Host milliseconds of each CUDA graph launch of the SLAM frame runner:
the mean duration of the port's ``graph replay N`` spans in the traced
stretch (``utils.graphs``)."""

from benchmark.harness.readers import graph_launch_host_ms as read  # noqa: F401
