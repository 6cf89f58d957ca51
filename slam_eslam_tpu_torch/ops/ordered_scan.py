"""Ordered scan: kernel S1 and its plain version.

An inclusive float32 prefix sum whose additions happen in one fixed
order, so that it gives the same bits on every call, on the card and on
the CPU.  It replaces ``torch.cumsum`` where the port searches cumulative
weights (``core.filter.resample_from_positions``, ``core.gmm.fit_gmm``,
``tools.profile_resample``): on the card ``torch.cumsum`` of float32 is
not repeatable, and on a device mesh every rank must find the same
ancestors in the same all-gathered weights.  No TPU kernel stands behind
it (the JAX package's XLA cumsum repeats itself).

The order is the JAX package's own on the CPU (XLA's rewrite of a
prefix-sum reduce-window), so the port searches the very cumulative
weights that the JAX package searches: up to ``ROW`` elements a
sequential sum that starts from ``+0.0`` (for two elements or more);
above, the input padded with zeros to rows of ``ROW`` is summed in
sequence inside each row, the row totals are scanned by the same rule,
recursively, and each row then adds the scanned total of the row before
it (row 0 adds ``+0.0``).  So no output of two elements or more is
``-0.0``.  ``ordered_scan_reference`` repeats that order with elementwise
adds, and IEEE addition makes the kernel and it equal bit for bit.

The kernel (``csrc/ordered_scan.cu``) is one launch at every size: a CTA
scans a tile of ``TILE`` elements, publishes three of its sums, and builds
its carry from the sums its predecessors published.  Tiles are handed out
by a ticket, and the ticket and the published sums live in a state buffer
of the device (``state_words``), zeroed once: every launch tags its sums
with its own generation and leaves the ticket reset, so the next launch
needs no clearing, the launch captures into a CUDA graph and repeats on
every replay.  The launches that share a device's state run one after
another: eager calls go on one stream per device (a call from another
stream raises), and a graph holding the kernel is replayed on that
stream and never alongside an eager call.

``ordered_scan`` launches the CUDA kernel for CUDA tensors and runs
``ordered_scan_reference`` for CPU tensors; there is no other route.
``ordered_scan.launches`` counts calls that launched the kernel, one
kernel launch each.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from slam_eslam_tpu_torch.ops import _build

ROW = 16            # kRow of csrc/ordered_scan.cu
TILE = ROW ** 3     # kTile: the elements one CTA scans
MAX_TILES = 32768   # kMaxTiles: the tiles one CTA's look-back holds
MAX_N = TILE * MAX_TILES
STATE_HEADER = 2    # int64 words before the records: ticket, records tagged
RECORD = 3          # int64 words a tile publishes: f, p, e


def tiles(n):
    """CTAs (tiles of ``TILE`` elements) of a launch over ``n``."""
    return -(-n // TILE)


def state_words(n):
    """int64 words of state a launch over ``n`` elements uses: none for
    one tile, else the generation and ticket word, the count of tagged
    records and a record of three tagged sums for every tile."""
    t = tiles(n)
    return 0 if t <= 1 else STATE_HEADER + RECORD * t


def ordered_scan_reference(x):
    """The plain version: the kernel's order of additions, on any device.
    ``x [N]`` float32; returns ``[N]``."""
    n = x.shape[0]
    if n <= ROW:
        cols = list(x.unbind(0))
        if n > 1:
            cols[0] = cols[0] + 0.0
        for j in range(1, n):
            cols[j] = cols[j - 1] + cols[j]
        return torch.stack(cols) if n else x.clone()
    rows = -(-n // ROW)
    p = torch.nn.functional.pad(x, (0, rows * ROW - n)).reshape(rows, ROW)
    cols = [p[:, 0]]
    for j in range(1, ROW):
        cols.append(cols[-1] + p[:, j])
    loc = torch.stack(cols, dim=1)
    tot = ordered_scan_reference(loc[:, -1].contiguous())
    carry = torch.cat([tot.new_zeros(1), tot[:-1]])
    return (loc + carry[:, None]).reshape(-1)[:n]


@functools.cache
def _launcher():
    fn = _build.load("ordered_scan").ordered_scan_launch
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr, ptr, ptr, ctypes.c_longlong, ptr]
    fn.restype = ctypes.c_int
    return fn


# device index -> [state tensor, the stream of its eager launches]
_STATES = {}


def device_state(device, n):
    """The zeroed state of ``device`` for a launch over ``n`` elements,
    grown (outside a capture only) when it is too small.  Raises for an
    eager call from a stream other than the one the state's earlier eager
    calls used: two streams would race on the tickets."""
    need = state_words(n)
    stream = torch.cuda.current_stream(device)
    capturing = torch.cuda.is_current_stream_capturing()
    entry = _STATES.setdefault(device.index, [None, None])
    if not capturing:
        if entry[1] is None:
            entry[1] = stream
        elif entry[1] != stream:
            raise RuntimeError(
                f"ordered_scan on {device} runs on one stream: its state "
                f"serves {entry[1]}, not {stream}")
    if entry[0] is None or entry[0].numel() < need:
        if capturing:
            raise RuntimeError(
                f"ordered_scan's state on {device} holds too few tiles for "
                f"{n} elements: call it once at this size before the "
                f"capture")
        entry[0] = torch.zeros(max(need, STATE_HEADER + RECORD * 32),
                               dtype=torch.int64, device=device)
    return entry[0]


def launch(x, out, state):
    """Launch the kernel on PyTorch's current stream: ``x`` and ``out``
    ``[N]`` float32 and ``state`` (``device_state``) of at least
    ``state_words(N)`` int64 words, on one card, already checked.
    Allocates nothing and reads nothing back: one kernel launch."""
    device = x.device
    with torch.cuda.device(device):
        err = _launcher()(
            x.data_ptr(), out.data_ptr(), state.data_ptr(), x.shape[0],
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ordered_scan kernel launch failed: CUDA error "
                           f"{err}")
    ordered_scan.launches += 1


def ordered_scan(x):
    """Inclusive prefix sum of ``x [N]`` (float32) in the fixed order of
    the module docstring: the same bits on every call and every device."""
    if x.dim() != 1:
        raise ValueError(f"ordered_scan takes a 1-D tensor, got shape "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return ordered_scan_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"ordered_scan runs on CPU or CUDA, not "
                         f"{x.device}")
    n = x.shape[0]
    if n > MAX_N:
        raise ValueError(f"ordered_scan takes at most {MAX_N} elements on "
                         f"the card, got {n}")
    x = x.contiguous()
    _build.check_operand("x", x, (n,), torch.float32, x.device)
    out = torch.empty_like(x)
    if n:
        launch(x, out, device_state(x.device, n))
    return out


ordered_scan.launches = 0
