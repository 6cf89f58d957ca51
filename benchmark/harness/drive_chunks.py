"""The ``chunks`` drive: a recorded traverse replayed ahead through the
port's graphed scan runner (``filter.step.make_scan_runner``), in chunks
of ``chunk_steps`` steps dispatched back to back, the state carried from
chunk to chunk and each chunk's poses read to the host.

Set-up builds the lap from the seed (contact states, orientations), the
shared grid, the start cloud and one lap of draws on the card, builds the
runner and warms it up (the first step of a chunk runs eagerly and the
second captures, so one chunk captures everything).  The window starts
from the start cloud at the lap's first step and runs chunks until
``--seconds`` have passed; the last chunk ends it.

After the window the port's captured step is replayed once more, one
step a call, from the state the window handed each chunk (``replay``):
the window reads only centroids, and the replays, which have to return
the window's centroids bit for bit, give the particles behind them.  The
reference then follows the port from the port's own state (``check``):
each chunk's first step and every step of a few chunks drawn from the
seed, the particles (poses, weights and the resampling with the same
draws) and the centroid; and at each chunk's end the step count, the
odometry and the last pose against the state handed on."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import common, metrics, port, trace, traffic
from benchmark.reference import localization as ref


class Lap:
    """The lap's inputs on the card, laid twice end to end so that every
    chunk is one slice, and its draws, one set a lap step."""

    def __init__(self, cfg_file, mix, seed, device, gen):
        route = mix["route"]
        self.host = traffic.lap(cfg_file, route, seed)
        self.steps = route["lap_steps"]
        twice = {k: np.concatenate([v, v]) for k, v in
                 self.host["contacts"].items()}
        self.contacts = port.contact_states(twice, device)
        self.q = torch.from_numpy(
            np.concatenate([self.host["q"], self.host["q"]])).to(device)
        n = cfg_file["particles"]
        self.draws = traffic.draws(self.steps, n, gen, device)
        self.step_draws = [port.step_draws(self.draws, t)
                           for t in range(self.steps)]

    def chunk(self, start, length):
        """``(contact states, orientations, draws)`` of the chunk whose
        first step is lap step ``start``."""
        from slam_eslam_tpu_torch.utils import tree

        sl = slice(start, start + length)
        draws = [self.step_draws[(start + t) % self.steps]
                 for t in range(length)]
        return tree.index(self.contacts, sl), self.q[sl], draws


class Replay:
    """The cell's port and inputs on ``device`` (the card; the CPU only in
    the harness's own tests, with the port's eager loop): ``setup`` once,
    ``inputs(seed)`` for each seed, then ``window`` and ``check``."""

    def __init__(self, cfg_file, mix, device):
        self.cfg_file, self.mix, self.device = cfg_file, mix, device
        self.on_card = device.type == "cuda"
        self.chunk = mix["chunk_steps"]

    def setup(self, clock, seconds=None):
        """The kernels, the shared grid and the runner (``seconds`` sizes
        nothing here: the window repeats the lap)."""
        from slam_eslam_tpu_torch.filter import step as steplib
        from slam_eslam_tpu_torch.mapping.lookup import make_lookup
        clock.part("import")
        self.nvcc_s = load_kernels() if self.on_card else 0.0
        clock.part("kernels")
        cfg_file = self.cfg_file
        self.cfg = port.config(cfg_file)
        m = cfg_file["map"]
        self.grid_arrays = traffic.sims.terrain_grid(
            traffic.sims.terrain(m["terrain"]), m["nx"], m["ny"],
            m["resolution"], m["origin"], m["stdev"], m["k"])
        self.grid = port.grid(self.grid_arrays, self.device)
        self.runner = steplib.make_scan_runner(
            self.cfg, make_lookup(self.cfg, self.grid),
            graph=True if self.on_card else None)

    def inputs(self, seed):
        """The lap, its draws and the start state of ``seed``."""
        self.seed = seed
        gen = traffic.generator(seed, self.device)
        self.lap = Lap(self.cfg_file, self.mix, seed, self.device, gen)
        n = self.cfg_file["particles"]
        cloud = traffic.start_cloud(self.cfg_file, n, gen, self.device)
        c = (self.cfg_file["contacts"]["cap"]
             or self.cfg_file["contacts"]["candidates"])
        self.start = port.filter_state(self.cfg, cloud, c, self.device)
        self.lap_odometry = {}
        common.sync(self.device)

    def warm_up(self):
        """Two chunks: the first captures the step, the second replays."""
        from slam_eslam_tpu_torch import ops

        launches = ops.launch_counts()
        for i in range(2):
            _, cents = self.runner(self.start, *self.lap.chunk(
                i * self.chunk % self.lap.steps, self.chunk))
            cents.cpu()
        common.sync(self.device)
        graphs = self.runner.graphs
        common.log(f"setup: graphs {graphs.counts() if graphs else 'eager'}"
                   f", kernel launches in warm-up "
                   f"{diff(ops.launch_counts(), launches)}")

    def window(self, seconds, trace_path=None):
        """Chunks from the start state until ``seconds`` have passed (and
        the traced chunks, with ``trace_path``, are done)."""
        mix, chunk, lap = self.mix, self.chunk, self.lap
        state, s0 = self.start, 0
        starts, poses, firsts = [], [], []
        traced = range(mix["trace_skip_chunks"],
                       mix["trace_skip_chunks"] + mix["trace_chunks"])
        prof = window_span = None
        t_open = time.perf_counter()
        deadline = t_open + seconds
        k = 0
        while True:
            if trace_path is not None and k == traced.start:
                prof = trace.profiled(trace_path)
                prof.__enter__()
                window_span = torch.profiler.record_function(
                    trace.WINDOW_SPAN)
                window_span.__enter__()
            starts.append(state)
            firsts.append(s0)
            with trace.span("chunk dispatch"):
                state, cents = self.runner(state, *lap.chunk(s0, chunk))
            with trace.span("pose read"):
                poses.append(cents.cpu())
            s0 = (s0 + chunk) % lap.steps
            k += 1
            if prof is not None and k == traced.stop:
                window_span.__exit__(None, None, None)
                prof.__exit__(None, None, None)
                prof = None
            if time.perf_counter() >= deadline and prof is None:
                break
        window_s = time.perf_counter() - t_open
        return {"starts": starts, "firsts": firsts, "end": state,
                "poses": torch.stack(poses), "chunks": k,
                "steps": k * chunk, "window_s": window_s,
                "traced": traced}

    def followed(self, chunks):
        """The ``followed_chunks`` chunks of ``chunks`` drawn from the
        seed, whose every step the check follows."""
        rng = np.random.default_rng(self.seed % (2 ** 63))
        return sorted(int(j) for j in rng.choice(
            chunks, replace=False,
            size=min(chunks, self.mix["followed_chunks"])))

    def replay(self, w):
        """The port's states after the steps the check compares: every
        chunk's first step and every step of the followed chunks.  The
        window reads only the centroids, so the captured step that it
        replayed is replayed once more, one step a call, from the state
        the window handed the chunk; each replayed centroid has to equal
        the window's bit for bit.  Runs before the runner is freed and
        the reference runs; stores ``w["replayed"]`` (``{chunk: [state
        after each step]}``) and ``w["replay_differs"]``."""
        followed = set(self.followed(len(w["starts"])))
        states, differs = {}, 0
        for j, (state, s0) in enumerate(zip(w["starts"], w["firsts"])):
            out = []
            for t in range(self.chunk if j in followed else 1):
                state, cent = self.runner(state, *self.lap.chunk(
                    (s0 + t) % self.lap.steps, 1))
                differs += int(not torch.equal(cent[0].cpu(),
                                               w["poses"][j][t]))
                out.append(state)
            states[j] = out
        common.sync(self.device)
        w["replayed"], w["replay_differs"] = states, differs

    def reference_step(self, state, lt, measure_dtype=None):
        """The reference's step at lap step ``lt`` from the port's state
        ``state``: ``(particles weighed, before the resampling; particles
        after it; whether it resampled; the step's stratum draws)``."""
        fcfg, ocfg, g = reference_inputs(self.cfg_file, self.grid_arrays,
                                         self.device)
        st = port.plain_state(state)
        q = torch.from_numpy(self.lap.host["q"][lt]).to(self.device,
                                                        torch.float64)
        cs = port.plain_contacts(self.lap.host["contacts"], lt, self.device)
        d = traffic.plain_draws(self.lap.draws, lt)
        odo = ref.odometry(st["odometry"], cs, q, ocfg)
        prop = ref.propagate(st["particles"], odo, q, st["max_weight"], d,
                             fcfg)
        weighed, _ = ref.measure(prop, cs, q, st["max_weight"], g, fcfg,
                                 measure_dtype or torch.float64)
        out, _, resampled, _ = ref.resample(weighed, d["resample_u"],
                                            fcfg["min_effective"])
        return weighed, out, resampled, d["resample_u"]

    def odometry(self, s0, dtype=torch.float64):
        """The reference's odometry at the end of the chunk at lap step
        ``s0``, in ``dtype``: that of the chunk's last lap frame, which
        needs only the frame before it (the lap repeats)."""
        if dtype not in self.lap_odometry:
            contacts = port.plain_contacts(self.lap.host["contacts"],
                                           slice(None), "cpu", dtype)
            self.lap_odometry[dtype] = ref.odometry_frames(
                contacts, torch.from_numpy(self.lap.host["q"]).to(dtype),
                self.cfg_file["odometry"], closed=True)
        t = (s0 + self.chunk - 1) % self.lap.steps
        return {k: v[t] for k, v in self.lap_odometry[dtype].items()}

    def check_step(self, before, after, lt, got, gaps, stats, control):
        """One step at lap step ``lt`` against the reference's step from
        the port's state ``before``: the particles the port holds after
        it (``after``; ``particles_apart``) and the centroid the window
        returned (``got``): against the reference's, or, where the
        reference resamples, against the centroid of the particles the
        port holds (which are checked themselves); ``check`` compares the
        median step's gap.  ``control``: the reference in that dtype
        stands in for the port."""
        weighed, out, resampled, u = self.reference_step(before, lt)
        if control is None:
            held = port.plain_state(after)["particles"]
            got = got.double()
        else:
            _, held, _, _ = self.reference_step(before, lt, control)
            got = ref.centroid(held).cpu()[:3]
        want = ref.centroid(held if resampled else out).cpu()[:3]
        stats["centroid_gaps"].append(float((got - want).abs().max()))
        apart = particles_apart(weighed, held, u,
                                self.cfg_file["filter"]["min_effective"],
                                resampled)
        if apart > gaps["particles_apart"]:
            gaps["particles_apart"] = apart
            stats["most_apart_at"] = (lt, resampled)
        stats["steps"] += 1
        stats["resampled"] += int(resampled)

    def check(self, w, control=None):
        """Every chunk against the reference, which follows the port from
        the port's own state: each chunk's first step, and every step of
        the followed chunks (``check_step``); at each chunk's end the
        step count, the odometry and the last pose against the state
        handed on.  The reference restarts from the port's state at every
        step it checks: a particle whose query lies on a cell edge, or
        whose height update is at its acceptance bound, goes the other
        way on the two sides now and then, and a cloud resampled with its
        weights carried is weighed by its heaviest particles, so a
        reference that ran on from its own state would drift apart
        (readings in PERF.md).  ``control``: a dtype in which the
        reference stands in for the port (the control of the
        comparison)."""
        if "replayed" not in w:
            self.replay(w)
        gaps = dict.fromkeys(LIMITS, 0.0)
        stats = {"chunks": len(w["starts"]), "steps": 0, "resampled": 0,
                 "centroid_gaps": []}
        t0 = time.perf_counter()
        ends = w["starts"][1:] + [w["end"]]
        for j, (state, end, s0, got) in enumerate(zip(
                w["starts"], ends, w["firsts"], w["poses"])):
            replayed = w["replayed"][j]
            for t, after in enumerate(replayed):
                self.check_step(state, after, (s0 + t) % self.lap.steps,
                                got[t], gaps, stats, control)
                state = after
            odo = port.plain_state(end)["odometry"]
            last = got[-1].double()
            if control is not None:
                odo = self.odometry(s0, control)
                p = port.plain_state(end, control)["particles"]
                last = ref.centroid(p).double().cpu()[:3]
            gaps["steps_differ"] += int(int(end.step)
                                        - int(w["starts"][j].step)
                                        != self.chunk)
            roll = self.odometry(s0)
            gaps["odometry"] = max(gaps["odometry"], max(
                float((odo[k].double().cpu() - roll[k].double()).abs().max())
                for k in ODOMETRY_FIELDS))
            c = ref.centroid(port.plain_state(end)["particles"]).cpu()
            gaps["last_pose"] = max(gaps["last_pose"], float(
                (last - c[:3]).abs().max()))
        # the median step: a particle at a gate (a cell edge, the
        # heading's or the height update's bound) goes the other way on
        # the two sides now and then and moves one step's weighted mean;
        # ``particles_apart`` counts such particles (PERF.md)
        steps = torch.tensor(stats.pop("centroid_gaps"), dtype=torch.float64)
        gaps["step_centroid"] = float(steps.median())
        stats["step_centroid_max"] = float(steps.max())
        gaps["replay_differs"] = w["replay_differs"]
        # how far the returned poses lie from the lap's true ones (a
        # reading of the traffic, not compared)
        truth = torch.from_numpy(self.lap.host["truth"])
        lts = [(s0 + t) % self.lap.steps for s0 in w["firsts"]
               for t in range(self.chunk)]
        off = (w["poses"].reshape(-1, 3).double() - truth[lts, :3]).abs()
        stats["track_error_xy_m"] = float(off[:, :2].amax(-1).max())
        stats["track_error_z_m"] = float(off[:, 2].max())
        gaps["resampling_unchecked"] = int(stats["resampled"] == 0)
        checks = {name: {"value": gaps[key], "limit": LIMITS[key]}
                  for name, key in CHECKS.items()}
        common.log(f"check: {stats} in {time.perf_counter() - t0:.2f} s; "
                   f"gaps {gaps}")
        return checks


def run(args, cell, cfg_file, mix, clock, device=None):
    """One run of the cell: set-up, the window, the check, the line."""
    device = torch.device("cuda", 0) if device is None else device
    cellrun = Replay(cfg_file, mix, device)
    cellrun.setup(clock)
    cellrun.inputs(args.seed)
    clock.part("inputs")
    cellrun.warm_up()
    clock.part("captures")
    trace_path = None
    if args.trace:
        trace_path = trace.trace_dir() / "window.json"
        warm = trace_path.with_name("warm.json")
        with trace.profiled(warm):
            cellrun.runner(cellrun.start, *cellrun.lap.chunk(0, cellrun.chunk))
        trace.remove(warm)
        clock.part("profiler warm-up")
    if cellrun.on_card:
        torch.cuda.reset_peak_memory_stats()
    setup_s = clock.total()

    w = cellrun.window(args.seconds, trace_path)
    peak = torch.cuda.max_memory_allocated() if cellrun.on_card else 0
    common.log(f"window: {w['chunks']} chunks of {cellrun.chunk} steps, "
               f"{w['steps']} steps in {w['window_s']:.4f} s")
    cellrun.replay(w)
    cellrun.runner = None
    common.sync(device)

    failed = int((~torch.isfinite(w["poses"]).all(-1)).sum())
    checks = cellrun.check(w)
    result = {"correct": failed == 0 and all(
        v["value"] <= v["limit"] for v in checks.values()),
        "attempted": w["steps"], "failed": failed}
    dev_trace = None
    if args.trace:
        tr = trace.Trace(trace_path)
        dev_trace, breakdown = trace.summary(tr)
        traced = w["traced"]
        ctx = {"trace": tr, "steps": len(traced) * cellrun.chunk,
               "k1_bound_s": k1_bounds(
                   cfg_file, cellrun.grid_arrays, cellrun.lap,
                   [w["starts"][i] for i in traced],
                   [w["firsts"][i] for i in traced], device)}
        result["metrics"] = metrics.read(cell, ctx)
        result["breakdown"] = breakdown
        trace.remove_dir(trace_path.parent)
    else:
        n = cfg_file["particles"]
        result["metrics"] = {
            "particle_updates_per_s": {"value": n * w["steps"] / w["window_s"],
                                       "unit": "particle-upd/s"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    result["device"] = (common.device_info(1, peak, dev_trace)
                        if cellrun.on_card else {"platform": "cpu"})
    result["setup"] = dict(clock.parts, nvcc_s=cellrun.nvcc_s)
    return result, checks


def diff(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0)}


def load_kernels():
    """Build (first run in a checkout: ``nvcc``) or load the port's
    kernels; returns the seconds spent building, 0 when all were built."""
    from slam_eslam_tpu_torch.ops import _build

    missing = [k for k in _build.KERNELS if not _build.library_path(k).exists()]
    t0 = time.perf_counter()
    _build.load_all(_build.KERNELS)
    took = time.perf_counter() - t0
    common.log(f"setup: kernels {'built ' + str(missing) if missing else 'found built'}"
               f" in {took:.3f} s")
    return took if missing else 0.0


def reference_inputs(cfg_file, grid_arrays, device):
    fcfg = dict(cfg_file["filter"])
    ocfg = cfg_file["odometry"]
    g = {"mean": torch.from_numpy(grid_arrays["mean"]).to(device),
         "stdev": torch.from_numpy(grid_arrays["stdev"]).to(device),
         "valid": torch.from_numpy(grid_arrays["valid"]).to(device),
         "origin": [float(v) for v in grid_arrays["origin"]],
         "resolution": grid_arrays["resolution"]}
    return fcfg, ocfg, g


# the numbers compared and their limits, set from the readings in PERF.md
CHECKS = {"step_centroid_m": "step_centroid",
          "particles_apart": "particles_apart",
          "chunk_steps_differ": "steps_differ",
          "chunk_end_odometry": "odometry",
          "last_pose_m": "last_pose",
          "replayed_steps_differ": "replay_differs",
          "resampling_unchecked": "resampling_unchecked"}
LIMITS = {"step_centroid": 3e-5, "particles_apart": 2500,
          "steps_differ": 0, "odometry": 1e-4, "last_pose": 3e-4,
          "replay_differs": 0, "resampling_unchecked": 0}
VALUE_TOL = 1e-4     # metres (radians): a particle's x, y, yaw and z
WEIGHT_TOL = 1e-4    # a particle's weight, relative, up to a common factor
# particles lighter than this share of the heaviest weigh nothing that a
# float32 weight can carry
WEIGHT_FLOOR = 1e-20
# strata: a stratum this near its particle's cumulative-weight interval
# may go either way between float32 and float64 sums
STRATUM_TOL = 2
# a copy's x lies this near its original's (float32 against float64)
MATCH_X = 1e-5
MATCH_CANDIDATES = 128
ODOMETRY_FIELDS = ("prev_points", "delta_xy", "delta_yaw", "delta_z",
                   "sigma_xy", "sigma_yaw", "sigma_z")


def k1_bounds(cfg_file, grid_arrays, lap, states, firsts, device):
    """K1's bound for the first step of each traced chunk (the fold's
    inputs there: the propagated particles' contact queries), in seconds
    a launch, averaged; the cloud moves little within a chunk."""
    from benchmark.roofline import fold

    fcfg, ocfg, g = reference_inputs(cfg_file, grid_arrays, device)
    cm = fcfg["contact_model"]
    out = []
    for state, s0 in zip(states, firsts):
        st = port.plain_state(state, torch.float32)
        cs = port.plain_contacts(lap.host["contacts"], s0, device,
                                 torch.float32)
        q = torch.from_numpy(lap.host["q"][s0]).to(device)
        d = traffic.plain_draws(lap.draws, s0, torch.float32)
        odo = ref.odometry(st["odometry"], cs, q, ocfg)
        p = ref.propagate(st["particles"], odo, q, st["max_weight"], d, fcfg)
        pos = ref.rotate(ref.strip_yaw(q)[None], cs["position"])
        c_, s_ = torch.cos(p["yaw"]), torch.sin(p["yaw"])
        qx = c_[None] * pos[:, :1] - s_[None] * pos[:, 1:2] + p["x"][None]
        qy = s_[None] * pos[:, :1] + c_[None] * pos[:, 1:2] + p["y"][None]
        qz = pos[:, 2:3] + p["z"][None] - cm["contact_point_radius"]
        active = cs["valid"] & ~(cs["contact"] < ref.CONTACT_THRESHOLD)
        gid, _ = ref.groups(cs["group_id"])
        mv = p["z_sigma"] ** 2 + fcfg["measurement_error"] ** 2
        work = fold.fold_work(g, (qx, qy, qz), active, mv, gid,
                              cm["contact_likelihood_correction"],
                              fcfg["mls_z_window"])
        out.append(fold.bound_seconds(work, qx.shape[0], qx.shape[1],
                                      g["mean"].shape[2])[0])
    return sum(out) / len(out)


def particles_apart(weighed, held, u, min_effective, resampled):
    """Particles that the port holds after a step otherwise than the
    reference's step with the same draws: a count of particles.
    ``weighed``: the reference's particles before the resampling;
    ``held``: the port's after the step.  Without a resampling slot ``k``
    has to hold particle ``k``; with one, each slot has to hold a copy of
    a weighed particle.  A copy is held within ``VALUE_TOL`` in x, y, yaw
    and z, with the reference's weight within ``WEIGHT_TOL`` up to a
    common factor.  With a resampling, the stratified resampling with the
    draws ``u``, run on the weights the port carries (the reference's,
    scaled, for particles with no copy), has to give each slot the
    particle it copies, within ``STRATUM_TOL`` strata of its interval's
    ends.  The second stage takes the port's weights so that one weight
    that differs (a query on a cell edge) counts once, not in every
    stratum its change shifts."""
    n = len(u)
    fields = ("x", "y", "yaw", "z")
    src = torch.stack([weighed[k] for k in fields], -1)
    dst = torch.stack([held[k].to(src.dtype) for k in fields], -1)
    if resampled:
        anc, dist = nearest(src, dst)
    else:
        anc = torch.arange(n, device=src.device)
        dist = (dst - src).abs().amax(-1)
    copied = dist <= VALUE_TOL
    w_ref = weighed["weight"] / weighed["weight"].sum()
    w_held = held["weight"].to(w_ref.dtype)
    heavy = copied & (w_ref[anc] >= WEIGHT_FLOOR * w_ref.max())
    ratio = w_held / w_ref[anc]
    scale = ratio[heavy].median() if bool(heavy.any()) else ratio.new_ones(())
    weight_off = heavy & ((ratio / scale - 1).abs() > WEIGHT_TOL)
    off = weight_off
    if resampled:
        w = w_ref * scale
        w[anc[copied]] = w_held[copied]
        cum = torch.cumsum(w / w.sum(), 0)
        pos = (torch.arange(n, device=u.device, dtype=cum.dtype)
               + u.to(cum.dtype)) / n
        lo = torch.searchsorted(cum, pos - STRATUM_TOL / n)
        hi = torch.searchsorted(cum, pos + STRATUM_TOL / n).clamp(max=n - 1)
        off = off | (copied & ((anc < lo) | (anc > hi)))
    # a slot that is no copy counts once for each distinct pose it holds
    strays = torch.unique(dst[~copied], dim=0).shape[0]
    return int(torch.unique(anc[off]).numel()) + strays


def nearest(src, dst):
    """For each row of ``dst`` the row of ``src`` nearest by the largest
    difference of a field, among those whose x lies within ``MATCH_X``
    (the first ``MATCH_CANDIDATES`` by x): ``(index, difference)``; a row
    with none gives the difference inf."""
    xs, order = torch.sort(src[:, 0])
    anc = torch.empty(len(dst), dtype=torch.long, device=dst.device)
    dist = torch.empty(len(dst), dtype=src.dtype, device=dst.device)
    span = torch.arange(MATCH_CANDIDATES, device=dst.device)
    for a in range(0, len(dst), 8192):
        d = dst[a:a + 8192]
        lo = torch.searchsorted(xs, d[:, 0].contiguous() - MATCH_X)
        hi = torch.searchsorted(xs, d[:, 0].contiguous() + MATCH_X)
        cand = lo[:, None] + span[None]
        ok = cand < hi[:, None]
        idx = order[cand.clamp(max=len(xs) - 1)]
        gap = (src[idx] - d[:, None]).abs().amax(-1)
        gap = torch.where(ok, gap, torch.full_like(gap, float("inf")))
        best, k = gap.min(-1)
        anc[a:a + 8192] = idx.gather(1, k[:, None])[:, 0]
        dist[a:a + 8192] = best
    return anc, dist


Cell = Replay
