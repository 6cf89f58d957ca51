"""Chain lookup: kernel K2 and its plain PyTorch version.

Replaces ``slam_eslam_tpu/ops/pallas_chain.py::_chain_kernel`` (through
``chain_lookup_blocks``).  Per particle ``n`` and query ``c``, walk the
particle's map chain ``chain[n, :]`` head first, skipping empty (-1)
entries; in each block run the z-window slot select of the query's
cell (the JAX package's ``map_pool._block_get_patch``); the first level
with a hit gives ``(found, mean, stdev)``, no hit gives ``(False, 0,
0)``.

``chain_lookup`` launches the CUDA kernel (``csrc/chain_lookup.cu``) for
CUDA tensors and runs ``chain_lookup_reference`` for CPU tensors; there
is no other route.  ``chain_lookup.launches`` counts kernel launches.

Patch colour (the slip update's terrain classes on a colour-carrying
pool) is not the kernel's business: in the JAX package a colour pool
never reaches the Pallas chain kernel, its lookup is the XLA gather
``map_pool.chain_lookup``.  Here ``found``, ``mean`` and ``stdev`` of a
colour pool still come from the kernel, which with ``with_slot=True``
also writes the flat index of the slot it selected; ``chain_color`` reads
that slot's colour with one plain ``index_select``, as the shared map's
slip lookup (``mls_grid.get_patch``) gathers its colour.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from slam_eslam_tpu_torch.mapping.mls_grid import inverse_resolution
from slam_eslam_tpu_torch.ops import _build


def block_get_patch(mean, stdev, meta, origin, resolution, blk, xq, yq, zq,
                    *, k, z_window=3.0, with_slot=False):
    """Z-window select in one block per particle: ``blk [N]`` (>= 0),
    queries ``[N, C]``.  Pool fields are ``[B, nx, ny*k]`` with cell
    ``(ix, iy)`` slot ``s`` at ``[b, ix, iy*k + s]``.  Returns
    ``(found, mean, stdev)`` ``[N, C]``; mean and stdev are those of slot
    0 of the (clamped) cell where nothing is found.  ``with_slot`` adds
    the selected slot's index into the flattened fields ``[N, C]``
    (int64)."""
    b, nx, nyk = mean.shape
    ny = nyk // k
    inv = inverse_resolution(resolution)
    blk = blk.long()
    org = origin.index_select(0, blk)                          # [N, 2]
    ix = torch.floor((xq - org[:, 0:1]) * inv).to(torch.int32)
    iy = torch.floor((yq - org[:, 1:2]) * inv).to(torch.int32)
    inb = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
    zero = torch.zeros_like(ix)
    cix = torch.where(inb, ix, zero).long()
    ciy = torch.where(inb, iy, zero).long()
    slots = torch.arange(k, device=ix.device)
    flat = ((blk[:, None, None] * nx + cix[..., None]) * nyk
            + ciy[..., None] * k + slots)                      # [N, C, K]
    means = mean.reshape(-1)[flat].float()
    stdevs = stdev.reshape(-1)[flat].float()
    valids = (meta.reshape(-1)[flat] & 1) != 0
    dist = (means - zq[..., None]).abs()
    cand = valids & (dist <= z_window)
    best = torch.argmin(torch.where(cand, dist,
                                    torch.full_like(dist, float("inf"))),
                        dim=-1, keepdim=True)
    found = inb & cand.any(dim=-1)
    out = (found, torch.gather(means, -1, best)[..., 0],
           torch.gather(stdevs, -1, best)[..., 0])
    if with_slot:
        out += (torch.gather(flat, -1, best)[..., 0],)
    return out


def chain_lookup_reference(mean, stdev, meta, origin, resolution, chain,
                           queries, *, k, z_window=3.0, with_slot=False):
    """The plain version of the kernel (the JAX package's
    ``map_pool.chain_lookup``): one ``block_get_patch`` per chain level,
    first hit wins.  ``with_slot`` adds the hit slot's index into the
    flattened fields ``[N, C]`` (int64, -1 where nothing is found)."""
    xq, yq, zq = queries
    found = torch.zeros(xq.shape, dtype=torch.bool, device=xq.device)
    out_mean = torch.zeros_like(xq, dtype=torch.float32)
    out_stdev = torch.zeros_like(xq, dtype=torch.float32)
    out_slot = torch.full(xq.shape, -1, dtype=torch.int64, device=xq.device)
    for level in range(chain.shape[1]):
        b = chain[:, level]
        ok = b >= 0
        f, m, s, *slot = block_get_patch(
            mean, stdev, meta, origin, resolution,
            torch.where(ok, b, torch.zeros_like(b)), xq, yq, zq, k=k,
            z_window=z_window, with_slot=with_slot)
        use = ok[:, None] & f & ~found
        out_mean = torch.where(use, m, out_mean)
        out_stdev = torch.where(use, s, out_stdev)
        if with_slot:
            out_slot = torch.where(use, slot[0], out_slot)
        found = found | use
    if with_slot:
        return found, out_mean, out_stdev, out_slot
    return found, out_mean, out_stdev


def chain_color(color, slot):
    """Colour ``[N, C, 3]`` (float32) of the slots ``slot [N, C]`` that a
    chain lookup selected in a pool whose colour field is ``color
    [B, nx, ny*k*3]``; zeros where it found none (slot -1).  A plain
    gather on any device (see the module docstring)."""
    got = color.reshape(-1, 3).index_select(0, slot.clamp(min=0).reshape(-1))
    return torch.where((slot >= 0)[..., None],
                       got.reshape(slot.shape + (3,)).float(), 0.0)


@functools.cache
def _launcher():
    fn = _build.load("chain_lookup").chain_lookup_launch
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [ptr] * 12 + [i32] * 8 + [f32] * 2 + [ptr]
    fn.restype = ctypes.c_int
    return fn


def launch(mean, stdev, meta, origin, resolution, chain, queries, outs, *,
           k, z_window=3.0):
    """Launch the kernel on PyTorch's current stream: operands as
    ``chain_lookup`` takes them, already checked, and ``outs = (found,
    mean, stdev)`` or ``(found, mean, stdev, slot)``, each ``[N, C]``,
    given.  Allocates nothing and reads nothing back."""
    xq, yq, zq = queries
    b, nx, nyk = mean.shape
    n, c = xq.shape
    device = mean.device
    slot = outs[3].data_ptr() if len(outs) > 3 else None
    with torch.cuda.device(device):
        err = _launcher()(
            mean.data_ptr(), stdev.data_ptr(), meta.data_ptr(),
            origin.data_ptr(), chain.data_ptr(), xq.data_ptr(),
            yq.data_ptr(), zq.data_ptr(), outs[0].data_ptr(),
            outs[1].data_ptr(), outs[2].data_ptr(), slot,
            n, c, chain.shape[1], b, nx, nyk // k, k,
            int(mean.dtype == torch.bfloat16),
            inverse_resolution(resolution), float(z_window),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"chain_lookup kernel launch failed: CUDA error "
                           f"{err}")
    chain_lookup.launches += 1


def chain_lookup(mean, stdev, meta, origin, resolution, chain, queries, *,
                 k, z_window=3.0, with_slot=False):
    """Chain lookup of SoA queries ``(x, y, z)``, each ``[N, C]`` float32,
    through ``chain [N, L]`` int32 into the pool fields ``mean, stdev``
    (both float32 or both bfloat16) and ``meta`` (int32, bit 0 = valid),
    each ``[B, nx, ny*k]``, with block origins ``origin [B, 2]``.  Returns
    ``(found bool, mean, stdev)``, each ``[N, C]``, float32 whatever the
    pool stores (the upcast is exact, so the result is still bitwise that
    of the plain version on the same pool).  ``with_slot`` adds a fourth
    result, the hit slot's index into the flattened fields ``[N, C]``
    (int64, -1 where nothing is found: what ``chain_color`` gathers by).

    CPU tensors take ``chain_lookup_reference``; CUDA tensors launch the
    kernel, which reads the pool in place."""
    xq, yq, zq = queries
    device = mean.device
    if device.type == "cpu":
        return chain_lookup_reference(mean, stdev, meta, origin, resolution,
                                      chain, queries, k=k, z_window=z_window,
                                      with_slot=with_slot)
    if device.type != "cuda":
        raise ValueError(f"chain_lookup runs on CPU or CUDA, not {device}")
    b, nx, nyk = mean.shape
    n, c = xq.shape
    levels = chain.shape[1] if chain.dim() == 2 else -1
    f32 = torch.float32
    _build.check_operand("mean", mean, (b, nx, nyk), _build.POOL_DTYPES,
                         device, _build.pool_align(mean.dtype, k))
    _build.check_operand("stdev", stdev, (b, nx, nyk), mean.dtype, device,
                         _build.pool_align(mean.dtype, k))
    _build.check_operand("meta", meta, (b, nx, nyk), torch.int32, device,
                         _build.pool_align(torch.int32, k))
    for name, t, shape, dtype in (
            ("origin", origin, (b, 2), f32),
            ("chain", chain, (n, levels), torch.int32),
            ("x", xq, (n, c), f32), ("y", yq, (n, c), f32),
            ("z", zq, (n, c), f32)):
        _build.check_operand(name, t, shape, dtype, device)
    if nyk % k:
        raise ValueError(f"pool lane extent {nyk} is not a multiple of "
                         f"k={k}")
    outs = (torch.empty((n, c), dtype=torch.bool, device=device),
            torch.empty((n, c), dtype=f32, device=device),
            torch.empty((n, c), dtype=f32, device=device))
    if with_slot:
        outs += (torch.empty((n, c), dtype=torch.int64, device=device),)
    launch(mean, stdev, meta, origin, resolution, chain, queries, outs, k=k,
           z_window=z_window)
    return outs


chain_lookup.launches = 0
