"""A stand-in for ``utils.graphs.Capture`` on the CPU, shared by the tests
of the port's CUDA graphs: a CUDA graph needs the card, so the tests
drive the runners' buffer discipline through it (injected as their
``graph=``).  At "capture" it runs the region on the static buffers and
then puts back everything the region wrote (the static carry and
outputs, the registered generators), as a real capture records the work
and runs none of it; at each "replay" it runs the region again on those
same buffers.  A region that read its inputs from anywhere but the static
buffers, a carry not written back, an output handed out as a view of a
static buffer or a generator not carried across shows as a difference
from the eager run.  It re-runs the region's Python, so a region that
reads a replaced tensor through an attribute passes here and reads stale
memory on the card: ``StepGraphs(reads=...)`` guards that."""

import torch

from slam_eslam_tpu_torch.utils import graphs


class StandIn:
    """``utils.graphs.Capture``'s methods on the CPU: a capture runs the
    region and restores what it wrote, a replay runs it again.  ``mesh``:
    its counters of rows asked of other ranks (``Mesh.asked``) are
    restored too."""

    def __init__(self, fail=False, mesh=None):
        self.fail, self.captures, self.replays = fail, 0, 0
        self.mesh = mesh

    def check(self, device, what):
        assert torch.device(device).type == "cpu"

    def new_graph(self):
        return {}

    def capture(self, graph, fn, generators=(), writes=()):
        if self.mesh is not None:
            writes = list(writes) + list(self.mesh.asked.values())
        saved = [w.clone() for w in writes]
        states = [g.get_state() for g in generators]
        fn()
        if self.fail:
            raise RuntimeError("capture failed")
        for w, s in zip(writes, saved):
            w.copy_(s)
        for g, s in zip(generators, states):
            g.set_state(s)
        graph["fn"] = fn
        self.captures += 1

    def replay(self, graph):
        graph["fn"]()
        self.replays += 1


def assert_bitwise(got, ref):
    """Every tensor of ``got`` equal to ``ref``'s bit for bit (NaNs by
    their bits), with the same dtype and shape
    (``utils.graphs.equal_bits``)."""
    same, n = graphs.equal_bits(got, ref)
    assert same and n, f"{n} tensors compared, equal: {same}"
