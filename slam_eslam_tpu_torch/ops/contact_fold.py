"""Contact fold: kernel K1 and its plain PyTorch version.

Replaces ``slam_eslam_tpu/ops/pallas_gather.py::_fused_select_contact_kernel``
(through ``window_select_contact`` / ``windowed_grid_lookup.fold``).  For
contact-grid ``[C, N]`` world queries against one shared packed grid it
computes, per particle, the five statistics the weighting needs
(``evaluate_pose_batch``, fold branch):

    out[:, i] = (d1, d2, sq, pose_var, n_contacts, 0, 0, 0)

with, over the valid contact groups g of particle i,
``d1 = sum zdiff_g / zvar_g``, ``d2 = sum 1 / zvar_g``,
``sq = sum zdiff_g^2 / zvar_g``, ``pose_var = sum pvar_g`` and
``n_contacts`` the number of valid groups.

``contact_fold`` launches the CUDA kernel (``csrc/contact_fold.cu``) for
CUDA tensors and runs ``contact_fold_reference`` for CPU tensors; there
is no other route.  It checks its operands, allocates the output and
calls ``launch``, the one place the kernel is launched from: ``launch``
takes operands that were checked before and the output, allocates and
checks nothing, so a loop of it can be captured into a CUDA graph
(``utils.profiling.device_time``).  ``contact_fold.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from slam_eslam_tpu_torch.mapping import mls_grid
from slam_eslam_tpu_torch.ops import _build

MILLS_U0 = -3.0
MILLS_CF_DEPTH = 8


def mills_ratio(u):
    """Inverse Mills ratio ``phi(u) / Phi(u)`` (``pallas_gather.
    _mills_ratio``): Abramowitz-Stegun 7.1.26 ``erfc`` for ``u >= -3``,
    the Laplace continued fraction of depth 8 below; max relative error
    5.2e-5 over u in [-30, 12]."""
    u = u.to(torch.float32)
    a = u * -0.7071067811865476                      # -u / sqrt(2)
    x = a.abs()
    t = 1.0 / (1.0 + 0.3275911 * x)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    e = poly * torch.exp(-x * x)
    cphi = 0.5 * torch.where(a >= 0, e, 2.0 - e)      # Phi(u)
    phi = 0.3989422804014327 * torch.exp(-0.5 * u * u)
    lam_a = phi / cphi.clamp(min=1e-38)
    xx = (-u).clamp(min=0.5)
    tcf = xx
    for j in range(MILLS_CF_DEPTH, 0, -1):
        tcf = xx + j / tcf
    return torch.where(u >= MILLS_U0, lam_a, tcf)


def contact_rows(found, mean, stdev, z, av, mv, correction):
    """Per-query group-sum integrands ``(ratio, ratio*zdiff, ratio*zvar,
    ratio*pose_var, contrib)`` (``pallas_gather._contact_rows``,
    ``ContactModel.cpp:160-208``); ``av`` is the 0/1 active mask."""
    zdiff = z - mean
    pose_var = stdev * stdev
    zvar = pose_var + mv
    s = torch.sqrt(zvar) * correction
    ratio = mills_ratio(zdiff / s) / s
    contrib = av * found
    rm = torch.where(contrib > 0.5, ratio, torch.zeros_like(ratio))
    return rm, rm * zdiff, rm * zvar, rm * pose_var, contrib


def contact_group_stats(rm, rz, rv, rp, contrib, act_col, seg_oh):
    """Segment sums, group validity and per-particle totals
    (``pallas_gather._contact_group_stats``).  Inputs are ``[C, N]``;
    ``act_col [C, 1]``, ``seg_oh [C, S]``.  A group is valid when every
    active member found a patch, at least one did, and its ratio mass
    exceeds 1e-9 (``ContactModel.cpp:189-190``).  Returns
    ``(d1, d2, sq, pose_var, n_contacts)``, each ``[N]``."""
    oh = seg_oh[:, :, None]                                    # [C, S, 1]
    seg_sum = lambda v: (v[:, None, :] * oh).sum(0)            # [S, N]
    rsum, zds, zvs, pvs, ncb = (seg_sum(v) for v in (rm, rz, rv, rp,
                                                     contrib))
    act_s = (act_col * seg_oh).sum(0)[:, None]                 # [S, 1]
    ok = (ncb >= act_s - 0.5) & (ncb > 0.5) & (rsum > 1e-9)
    okf = ok.to(torch.float32)
    one = torch.ones_like(rsum)
    safe = torch.where(ok, rsum, one)
    czd = torch.where(ok, zds / safe, torch.zeros_like(zds))   # cp_zdiff
    inv = okf * safe / torch.where(ok, zvs, one)               # 1 / cp_zvar
    return ((czd * inv).sum(0), inv.sum(0), (czd * czd * inv).sum(0),
            (okf * pvs / safe).sum(0), okf.sum(0))


def contact_fold_sums(found, mean, stdev, z, av, mv, act_col, seg_oh,
                      correction):
    """Fold epilogue on ``[C, N]`` lookup results
    (``pallas_gather.contact_fold_sums``).  Returns ``[8, N]`` float32
    rows ``(d1, d2, sq, pose_var, n_contacts, 0, 0, 0)``."""
    rows = contact_rows(
        found.to(torch.float32), mean, stdev.abs(), z, av,
        mv.expand_as(z), correction,
    )
    stats = contact_group_stats(
        *rows, act_col.to(torch.float32), seg_oh.to(torch.float32)
    )
    zeros = torch.zeros_like(stats[0])
    return torch.stack([*stats, zeros, zeros, zeros])


def contact_fold_reference(packed: mls_grid.PackedLookup, queries, act_col,
                           mv, onehot, correction, z_window=3.0):
    """The plain version of the kernel: exact full-grid select
    (``get_patch_packed_cells``) followed by ``contact_fold_sums``."""
    xq, yq, zq = queries
    ix, iy = mls_grid.cells(packed, xq, yq)
    found, mean, stdev = mls_grid.get_patch_packed_cells(
        packed, ix, iy, zq, z_window
    )
    return contact_fold_sums(found, mean, stdev, zq,
                             act_col.expand_as(zq), mv, act_col, onehot,
                             correction)


@functools.cache
def _launcher():
    fn = _build.load("contact_fold").contact_fold_launch
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [ptr] * 9 + [i32] * 5 + [f32] * 3 + [ptr]
    fn.restype = ctypes.c_int
    return fn


def segment_ids(onehot):
    """int32 group id per contact row of a ``[C, S]`` one-hot group
    membership (what ``BodyContactState.segments`` returns first)."""
    return onehot.argmax(dim=1).to(torch.int32)


def launch(packed, queries, act_col, mv, seg, out, correction, z_window=3.0):
    """Launch the kernel on PyTorch's current stream: operands as
    ``contact_fold`` takes them, already checked, ``seg [C]`` int32 and
    ``out [8, N]`` float32 given.  Allocates nothing and reads nothing
    back."""
    xq, yq, zq = queries
    c, n = xq.shape
    nx, ny, k2 = packed.data.shape
    device = out.device
    with torch.cuda.device(device):
        err = _launcher()(
            xq.data_ptr(), yq.data_ptr(), zq.data_ptr(), mv.data_ptr(),
            act_col.data_ptr(), seg.data_ptr(), packed.origin.data_ptr(),
            packed.data.data_ptr(), out.data_ptr(),
            c, n, nx, ny, k2 // 2,
            mls_grid.inverse_resolution(packed.resolution), float(z_window),
            float(correction),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"contact_fold kernel launch failed: CUDA error "
                           f"{err}")
    contact_fold.launches += 1


def contact_fold(packed: mls_grid.PackedLookup, queries, act_col, mv, *,
                 onehot=None, correction, z_window=3.0, seg=None):
    """Contact fold of ``[C, N]`` world queries ``(x, y, z)`` with
    ``act_col [C, 1]`` (0/1 active mask), ``mv [1, N]`` (measurement
    variance) and the group membership, each group a consecutive run of
    contact rows as ``BodyContactState.segments`` builds it: ``onehot
    [C, S]``, or the int32 group ids ``seg [C]`` themselves, or both (the
    kernel reads ``seg`` and skips the ``argmax`` that recovers it from
    ``onehot``; the plain version reads ``onehot``).  Returns ``[8, N]``
    float32.

    CPU tensors take ``contact_fold_reference``; CUDA tensors launch
    the kernel, which reads the grid in place and never pads ``N``."""
    xq, yq, zq = queries
    device = packed.data.device
    if onehot is None and seg is None:
        raise ValueError("contact_fold needs onehot or seg")
    if device.type == "cpu":
        if onehot is None:
            # one column per contact row, as many as there can be groups
            onehot = (seg[:, None] == torch.arange(
                seg.shape[0], dtype=seg.dtype,
                device=seg.device)[None, :]).to(xq.dtype)
        return contact_fold_reference(packed, queries, act_col, mv, onehot,
                                      correction, z_window)
    if device.type != "cuda":
        raise ValueError(f"contact_fold runs on CPU or CUDA, not {device}")
    c, n = xq.shape
    nx, ny, k2 = packed.data.shape
    f32 = torch.float32
    for name, t, shape in (("x", xq, (c, n)), ("y", yq, (c, n)),
                           ("z", zq, (c, n)), ("act_col", act_col, (c, 1)),
                           ("mv", mv, (1, n)),
                           ("packed.origin", packed.origin, (2,))):
        _build.check_operand(name, t, shape, f32, device)
    # at K = 4 a cell's means, and its stdevs, are one 16-byte load
    _build.check_operand("packed.data", packed.data, (nx, ny, k2), f32,
                         device, 16 if k2 == 8 else None)
    if seg is None:
        if (onehot.device != device or onehot.dim() != 2
                or onehot.shape[0] != c):
            raise ValueError(f"onehot must be [C={c}, S] on {device}")
        seg = segment_ids(onehot)
    else:
        _build.check_operand("seg", seg, (c,), torch.int32, device)
    out = torch.empty((8, n), dtype=f32, device=device)
    launch(packed, queries, act_col, mv, seg, out, correction, z_window)
    return out


contact_fold.launches = 0
