"""Plain reference of one localisation step, in PyTorch.

The semantics of the reference filter's main path (``EmbodiedSlamFilter::
update``, ``EmbodiedSlamFilter.cpp:353-369``, with ``PoseEstimator.cpp``
and ``ContactModel.cpp``), written from the published description and
nothing of the program under test: contact odometry, particle
propagation with the sampled deltas, the contact likelihood of every
particle against a shared MLS grid (the patch nearest in height within
the z window, the pdf/cdf contact ratio, the ratio-weighted group
averages, the shape weighting), the Kalman z update, the group-count
discount, normalisation, the ESS gate, stratified resampling and the
weighted centroid.

Everything is a dict of tensors.  ``dtype`` is the arithmetic type
(float64 by default); ``measure_dtype`` the type of the contact-likelihood
arithmetic, a lower one for the control.  The draws are given as tensors,
the same that the program gets.
"""

from __future__ import annotations

import math

import torch

CONTACT_THRESHOLD = 0.2  # ContactModel.cpp:136


# ---------------------------------------------------------------- geometry

def quat_mul(a, b):
    w1, x1, y1, z1 = a.unbind(-1)
    w2, x2, y2, z2 = b.unbind(-1)
    return torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)


def yaw_of(q):
    w, x, y, z = q.unbind(-1)
    return torch.atan2(2 * (x * y + w * z), 1 - 2 * (y * y + z * z))


def quat_yaw(yaw):
    h = 0.5 * yaw
    zero = torch.zeros_like(h)
    return torch.stack([torch.cos(h), zero, zero, torch.sin(h)], -1)


def strip_yaw(q):
    """``R_z(-yaw(q)) q`` (``base::removeYaw``)."""
    return quat_mul(quat_yaw(-yaw_of(q)), q)


def rotate(q, v):
    w, u = q[..., :1], q[..., 1:]
    u = u.expand_as(v)
    uv = torch.linalg.cross(u, v, dim=-1)
    return v + 2 * (w * uv + torch.linalg.cross(u, uv, dim=-1))


def wrap(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


# ---------------------------------------------------------------- odometry

def odometry(odo, cs, q, ocfg):
    """Foot-contact odometry: the weighted mean displacement of the feet
    in contact in both samples, in the yaw-compensated frame, with the
    heading change removed; its error model grows with the distance.
    Leading axes before a contact state's own (frames stacked) are kept:
    each frame is worked out from the ``prev_*`` given with it."""
    pts = rotate(strip_yaw(q)[..., None, :], cs["position"])
    contact = torch.nan_to_num(cs["contact"], nan=1.0)
    thr = ocfg["contact_threshold"]
    init = odo["initialized"]
    both = (init[..., None] & odo["prev_valid"] & cs["valid"]
            & (odo["prev_contact"] > thr) & (contact > thr))
    w = torch.where(both, torch.minimum(odo["prev_contact"], contact),
                    torch.zeros_like(contact))
    wsum = w.sum(-1)
    dyaw = wrap(yaw_of(q) - yaw_of(odo["prev_orientation"]))
    dyaw = torch.where(init, dyaw, torch.zeros_like(dyaw))
    c, s = torch.cos(dyaw)[..., None], torch.sin(dyaw)[..., None]
    turned = torch.stack([c * pts[..., 0] - s * pts[..., 1],
                          s * pts[..., 0] + c * pts[..., 1], pts[..., 2]], -1)
    disp = ((odo["prev_points"] - turned) * w[..., None]).sum(-2)
    disp = torch.where(wsum[..., None] > 0,
                       disp / wsum.clamp(min=1e-9)[..., None],
                       torch.zeros_like(disp))
    dist = torch.linalg.vector_norm(disp[..., :2], dim=-1)
    return {
        "prev_points": pts, "prev_contact": contact,
        "prev_valid": cs["valid"], "prev_orientation": q,
        "initialized": torch.ones_like(init),
        "delta_xy": disp[..., :2], "delta_yaw": dyaw, "delta_z": disp[..., 2],
        "sigma_xy": (ocfg["const_error_xy"]
                     + ocfg["dist_error_xy"] * dist)[..., None].expand(
                         *dist.shape, 2),
        "sigma_yaw": ocfg["const_error_yaw"] + ocfg["dist_error_yaw"] * dist,
        "sigma_z": ocfg["const_error_z"] + ocfg["dist_error_z"] * dist,
    }


def odometry_frames(cs, q, ocfg, closed=False):
    """The odometry state after every frame of a stacked contact stream
    (``cs`` fields ``[T, C, ...]``, ``q [T, 4]``), from an uninitialised
    start, or with ``closed`` of a stream that repeats (the first frame's
    predecessor is the last): each frame's state needs only the frame
    before it."""
    first = {"prev_points": torch.zeros_like(cs["position"][:1]),
             "prev_contact": torch.zeros_like(cs["contact"][:1]),
             "prev_valid": torch.zeros_like(cs["valid"][:1]),
             "prev_orientation": torch.tensor([[1.0, 0.0, 0.0, 0.0]],
                                              dtype=q.dtype, device=q.device),
             "initialized": torch.zeros(1, dtype=torch.bool,
                                        device=q.device)}
    contact = torch.nan_to_num(cs["contact"], nan=1.0)
    if closed:
        first = {"prev_points": rotate(strip_yaw(q[-1:])[:, None],
                                       cs["position"][-1:]),
                 "prev_contact": contact[-1:], "prev_valid": cs["valid"][-1:],
                 "prev_orientation": q[-1:],
                 "initialized": torch.ones(1, dtype=torch.bool,
                                           device=q.device)}
    prev = {
        "prev_points": torch.cat([first["prev_points"], rotate(
            strip_yaw(q[:-1])[:, None], cs["position"][:-1])]),
        "prev_contact": torch.cat([first["prev_contact"], contact[:-1]]),
        "prev_valid": torch.cat([first["prev_valid"], cs["valid"][:-1]]),
        "prev_orientation": torch.cat([first["prev_orientation"], q[:-1]]),
        "initialized": torch.cat([first["initialized"], torch.ones(
            len(q) - 1, dtype=torch.bool, device=q.device)]),
    }
    return odometry(prev, cs, q, ocfg)


# ------------------------------------------------------------- propagation

def propagate(p, odo, q, max_weight, draws, fcfg, spread=True):
    """``PoseEstimator::project`` (``PoseEstimator.cpp:184-242``): each
    particle moves by the odometry delta plus its sampled noise, slips
    along y with probability ``slip_factor``, loses 30 % of its weight
    beyond ``max_yaw_deviation`` of the measured heading, carries z and
    its variance forward, and, when ``spread``, spreads by how far the
    largest measurement weight collapsed."""
    dx = odo["delta_xy"][0] + draws["delta_xy"][:, 0] * odo["sigma_xy"][0]
    dy = odo["delta_xy"][1] + draws["delta_xy"][:, 1] * odo["sigma_xy"][1]
    dyaw = odo["delta_yaw"] + draws["delta_yaw"] * odo["sigma_yaw"]
    dy = torch.where(draws["slip"] < fcfg["slip_factor"], dy * draws["shrink"],
                     dy)
    c, s = torch.cos(p["yaw"]), torch.sin(p["yaw"])
    x = p["x"] + c * dx - s * dy
    y = p["y"] + s * dx + c * dy
    yaw = p["yaw"] + dyaw
    weight = p["weight"]
    if fcfg["max_yaw_deviation"] > 0:
        off = wrap(yaw - yaw_of(q)).abs() > fcfg["max_yaw_deviation"]
        weight = torch.where(off, weight * 0.7, weight)
    z = p["z"] + odo["delta_z"]
    z_sigma = torch.sqrt(p["z_sigma"] ** 2 + 2 * odo["sigma_z"] ** 2)
    if spread and fcfg["spread_threshold"] > 0:
        # weightingFunction(max_weight, 0, threshold, 0): 1 at 0, falling
        # linearly to 0 at the threshold
        m = max_weight
        k = torch.where(m < 0, torch.ones_like(m), torch.where(
            m < fcfg["spread_threshold"],
            1 - m / fcfg["spread_threshold"], torch.zeros_like(m)))
        x = x + draws["spread_xy"][:, 0] * fcfg["spread_translation_factor"] * k
        y = y + draws["spread_xy"][:, 1] * fcfg["spread_translation_factor"] * k
        yaw = yaw + draws["spread_yaw"] * fcfg["spread_rotation_factor"] * k
    return dict(p, x=x, y=y, yaw=yaw, z=z, z_sigma=z_sigma, weight=weight)


# ----------------------------------------------------------- contact model

def groups(group_id):
    """Group of each candidate: runs of one non-negative id, and every
    ``-1`` alone; ``(ids [C] long, count)``."""
    prev = torch.cat([group_id.new_full((1,), -2), group_id[:-1]])
    start = (group_id != prev) | (group_id < 0)
    ids = torch.cumsum(start.long(), 0) - 1
    return ids, int(ids.max()) + 1 if len(ids) else 0


def grid_lookup(grid, x, y, z, z_window):
    """The valid patch of the query's cell nearest in height to ``z``
    within ``z_window`` (the lowest slot on ties): ``(found, mean,
    stdev)``.  A query outside the grid finds nothing."""
    res = grid["resolution"]
    nx, ny, _ = grid["mean"].shape
    ix = torch.floor((x - grid["origin"][0]) / res).long()
    iy = torch.floor((y - grid["origin"][1]) / res).long()
    inside = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
    cx = torch.where(inside, ix, torch.zeros_like(ix))
    cy = torch.where(inside, iy, torch.zeros_like(iy))
    mean = grid["mean"][cx, cy].to(z.dtype)                   # [..., K]
    sd = grid["stdev"][cx, cy].to(z.dtype)
    dist = (mean - z[..., None]).abs()
    ok = grid["valid"][cx, cy] & (dist <= z_window)
    dist = torch.where(ok, dist, torch.full_like(dist, math.inf))
    best = dist.argmin(-1, keepdim=True)
    found = inside & ok.any(-1)
    return (found, mean.gather(-1, best)[..., 0], sd.gather(-1, best)[..., 0])


def contact_weights(p, cs, q, grid, fcfg, dtype):
    """``weigh`` against one shared grid, through the fold when the
    configuration's ``fold_lookup`` asks for it."""
    window = fcfg["mls_z_window"]
    return weigh(p, cs, q, lambda x, y, z: grid_lookup(grid, x, y, z, window),
                 fcfg, dtype, fold=fcfg["contact_model"].get("fold_lookup",
                                                              False))


def mills_ratio_fold(u):
    """``phi(u) / Phi(u)`` as the folded shared-map lookup defines it:
    ``Phi`` from Abramowitz and Stegun's erfc approximation 7.1.26 for
    ``u >= -3``, and below that Laplace's continued fraction of the
    inverse Mills ratio cut at depth 8 (within 5.2e-5 of the exact ratio
    over ``u`` in [-30, 12])."""
    a = -u / math.sqrt(2.0)
    x = a.abs()
    t = 1.0 / (1.0 + 0.3275911 * x)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    e = poly * torch.exp(-x * x)
    cdf = 0.5 * torch.where(a >= 0, e, 2.0 - e)
    pdf = torch.exp(-0.5 * u * u) / math.sqrt(2.0 * math.pi)
    xx = (-u).clamp(min=0.5)
    cf = xx
    for j in range(8, 0, -1):
        cf = xx + j / cf
    return torch.where(u >= -3.0, pdf / cdf.clamp(min=1e-38), cf)


def weigh(p, cs, q, lookup, fcfg, dtype, fold=False):
    """The contact likelihood of every particle
    (``ContactModel::evaluatePose`` + ``evaluateWeight``): the candidates
    to world coordinates, each active one's patch, the contact ratio
    pdf/cdf of its height difference, per group the ratio-weighted
    averages (a group counts when every active member found a patch, one
    did and the ratio mass exceeds 1e-9), and the shape weight
    ``exp(-0.5 sum (d_g - delta)^2 / var_g)``; ``lookup(x, y, z)`` of
    ``[N, C]`` world queries gives ``(found, mean, stdev)``.  Returns per
    particle
    ``(valid, weight, z_delta, z_var, pose_var, n_groups)`` in ``dtype``.
    ``fold``: the contact ratio by ``mills_ratio_fold``, as the folded
    lookup of one shared grid computes it; else exactly."""
    cm = fcfg["contact_model"]
    pos = rotate(strip_yaw(q)[None], cs["position"]).to(dtype)  # [C, 3]
    c, s = torch.cos(p["yaw"]).to(dtype), torch.sin(p["yaw"]).to(dtype)
    px, py = pos[:, 0][None], pos[:, 1][None]
    wx = c[:, None] * px - s[:, None] * py + p["x"].to(dtype)[:, None]
    wy = s[:, None] * px + c[:, None] * py + p["y"].to(dtype)[:, None]
    wz = pos[:, 2][None] + p["z"].to(dtype)[:, None] - cm["contact_point_radius"]
    found, mean, sd = lookup(wx, wy, wz)
    meas_var = (p["z_sigma"] ** 2 + fcfg["measurement_error"] ** 2).to(dtype)
    zdiff = wz - mean
    pose_var = sd * sd
    zvar = pose_var + meas_var[:, None]
    sig = torch.sqrt(zvar) * cm["contact_likelihood_correction"]
    u = zdiff / sig
    if fold:
        ratio = mills_ratio_fold(u) / sig
    else:
        log_pdf = -0.5 * (torch.log(2 * math.pi * sig * sig) + u * u)
        ratio = torch.exp(log_pdf
                          - torch.special.log_ndtr(u.double()).to(dtype))
    active = cs["valid"] & ~(cs["contact"] < CONTACT_THRESHOLD)
    contrib = active[None] & found
    r = torch.where(contrib, ratio, torch.zeros_like(ratio))
    gid, ng = groups(cs["group_id"])
    onehot = (gid[:, None] == torch.arange(ng, device=gid.device)[None]).to(
        dtype)                                                 # [C, G]
    rsum = r @ onehot
    miss = (active[None] & ~found).to(dtype) @ onehot
    any_hit = contrib.to(dtype) @ onehot
    ok = (miss == 0) & (any_hit > 0) & (rsum > 1e-9)
    safe = torch.where(ok, rsum, torch.ones_like(rsum))
    g_zdiff = torch.where(ok, (r * zdiff) @ onehot / safe, torch.zeros_like(rsum))
    g_zvar = torch.where(ok, (r * zvar) @ onehot / safe, torch.ones_like(rsum))
    g_pvar = torch.where(ok, (r * pose_var) @ onehot / safe,
                         torch.zeros_like(rsum))
    inv = torch.where(ok, 1 / g_zvar, torch.zeros_like(rsum))
    d1 = (g_zdiff * inv).sum(-1)
    d2 = inv.sum(-1)
    has = d2 > 0
    delta = d1 / torch.where(has, d2, torch.ones_like(d2))
    log_w = torch.zeros_like(d1)
    if cm["use_shape_update"]:
        log_w = -0.5 * torch.where(ok, (g_zdiff - delta[:, None]) ** 2 * inv,
                                   torch.zeros_like(rsum)).sum(-1)
    n_groups = ok.sum(-1)
    z_var = torch.where(has, 1 / torch.where(has, d2, torch.ones_like(d2)),
                        torch.full_like(d2, math.inf))
    return (n_groups >= cm["min_contacts"], torch.exp(log_w), -delta, z_var,
            g_pvar.sum(-1), n_groups)


# ------------------------------------------------------------------ update

def measure(p, cs, q, max_weight, grid, fcfg, measure_dtype, lookup=None):
    """``PoseEstimator::updateWeights`` (``PoseEstimator.cpp:257-352``):
    the Kalman z update of particles with a valid measurement, the weight
    times the measurement, the group-count discount
    ``mprob (discount * floating)^(4 - groups)``, and the largest
    measurement weight (decayed when no particle saw a contact)."""
    dtype = p["x"].dtype
    valid, meas, z_delta, z_var, pose_var, ng = (
        v.to(dtype) if v.is_floating_point() else v
        for v in (contact_weights(p, cs, q, grid, fcfg, measure_dtype)
                  if lookup is None
                  else weigh(p, cs, q, lookup, fcfg, measure_dtype)))
    zv = p["z_sigma"] ** 2
    n = ng.clamp(min=1).to(dtype)
    pv = pose_var / n
    dv = (zv - pv).clamp(min=1e-9)
    accept = (z_delta / torch.sqrt(dv)).abs() <= 1.0
    new_z = torch.where(accept, p["z"] + zv / (zv + z_var) * z_delta, p["z"])
    new_var = torch.where(accept, pv + (1 - dv / (dv + z_var)) * dv, zv)
    z = torch.where(valid, new_z, p["z"])
    z_sigma = torch.where(valid, torch.sqrt(new_var), p["z_sigma"])
    weight = torch.where(valid, p["weight"] * meas, p["weight"])
    ncp = ng.to(dtype)
    n_valid = valid.sum()
    root = torch.where(valid, meas ** (1 / ncp.clamp(min=1)),
                       torch.zeros_like(meas)).sum()
    floating = torch.where(n_valid > 0, root / n_valid.clamp(min=1),
                           torch.ones_like(root))
    mprob = torch.where(valid, meas, torch.ones_like(meas))
    weight = weight * mprob * (fcfg["discount_factor"] * floating) ** (4 - ncp)
    points = torch.where(valid, ng, torch.zeros_like(ng)).sum()
    top = torch.where(valid, meas, torch.zeros_like(meas)).max()
    max_weight = torch.where(points == 0,
                             max_weight * fcfg["discount_factor"], top)
    return dict(p, z=z, z_sigma=z_sigma, weight=weight), max_weight


def normalize(w):
    total = w.sum()
    ok = (total > 0) & torch.isfinite(total)
    w = torch.where(ok, w / torch.where(ok, total, torch.ones_like(total)),
                    torch.full_like(w, 1.0 / len(w)))
    return w, 1.0 / (w * w).sum()


def resample(p, u, min_effective):
    """ESS-gated stratified resampling (``ParticleFilter.hpp:85-108``):
    slot ``k`` takes the first particle whose cumulative normalised weight
    reaches ``(k + u_k) / N``, with its weight.  Returns ``(particles,
    ess, resampled, ancestors)``."""
    w, ess = normalize(p["weight"])
    n = len(w)
    cum = torch.cumsum(w, 0)
    cum[-1] = torch.clamp(cum[-1], min=1.0)
    pos = (torch.arange(n, device=w.device, dtype=w.dtype) + u.to(w.dtype)) / n
    idx = torch.searchsorted(cum, pos).clamp(max=n - 1)
    fields = ("x", "y", "yaw", "z", "z_sigma")
    if bool(ess < min_effective):
        out = {k: p[k][idx] for k in fields}
        out["weight"] = w[idx]
        return out, ess, True, idx
    return {**{k: p[k] for k in fields}, "weight": w}, ess, False, None


def centroid(p):
    w, _ = normalize(p["weight"])
    return torch.stack([(p["x"] * w).sum(), (p["y"] * w).sum(),
                        (p["z"] * w).sum(), (p["yaw"] * w).sum()])


def step(state, cs, q, draws, grid, fcfg, ocfg, measure_dtype=None):
    """One step: ``(state, centroid [x, y, z, yaw], info)``; ``state`` is
    ``{"particles", "odometry", "max_weight"}``."""
    p = state["particles"]
    measure_dtype = measure_dtype or p["x"].dtype
    odo = odometry(state["odometry"], cs, q, ocfg)
    p = propagate(p, odo, q, state["max_weight"], draws, fcfg)
    p, max_weight = measure(p, cs, q, state["max_weight"], grid, fcfg,
                            measure_dtype)
    p, ess, resampled, _ = resample(p, draws["resample_u"],
                                    fcfg["min_effective"])
    new = {"particles": p, "odometry": odo, "max_weight": max_weight}
    return new, centroid(p), {"ess": float(ess), "resampled": resampled}
