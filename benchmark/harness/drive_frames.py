"""The ``frames`` drive: the robot online.  Frames go one at a time
through the port's graphed SLAM step (``filter.streaming.make_slam_step``,
one CUDA graph per gate combination), and each frame's pose (the centroid
and the best particle) is read to the host before the next frame is
dispatched, as the robot's controller consumes it.  A frame's latency runs
from its dispatch until its pose is on the host.

Set-up makes the traverse (the Asguard rolling straight ahead, one laser
scan cast into the terrain a step, long enough for the traffic's
``max_frames_per_s`` over the window), its odometry (given to the port
as external odometry), the start cloud and a ring of draws from the seed,
the filter with its map pool, and warms every gate combination the
traverse meets up to capture; then the pool is refilled in place and the
window starts from the start cloud.

The check follows the port from its own state at frames drawn from the
seed (``checked_frames``): mapping frames, where the reference rolls the
sampled particles' maps over and merges the scan into them; plain frames;
and measurement frames, some drawn and the first few that resampled,
where the reference weighs every particle through its own chain (read
from the pool's cells around each particle, kept right after the frame)
and holds each slot the port returns to a copy of a weighed particle
with its chain row and weight, and to the ancestor the stratified
resampling with the frame's draws picks (``particles_apart``).  Every
checked frame's centroid and best pose are held to the particles the
port returned."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import common, metrics, port, trace, traffic
from benchmark.harness.drive_chunks import load_kernels
from benchmark.reference import localization as lref
from benchmark.reference import slam as sref

# the numbers compared and their limits, set from the readings in PERF.md
LIMITS = {
    "pose_xy_m": 1e-4, "pose_z_m": 1e-4, "map_cells_differ": 0.03,
    "particles_differ": 30, "chain_rows_differ": 0, "centroid_m": 1e-4,
    "alloc_failed": 0, "gates_differ": 0, "frames_unchecked": 0,
    "resampling_unchecked": 0,
}


def route_frames(cfg_file, mix, seconds, device):
    """The traverse as host arrays: per frame the full contact state, the
    compacted one, ``q``, the body position, the scan's ranges and
    ``has_scan``; as many steps as ``max_frames_per_s`` frames over
    ``seconds`` take."""
    route, laser = mix["route"], cfg_file["laser"]
    height = traffic.sims.terrain(cfg_file["terrain"])
    sim = traffic.sims.AsguardSim(height=height)
    z0 = float(sim.position[2])
    steps = max(route["min_steps"], int(np.ceil(
        seconds * route["max_frames_per_s"] / route["substeps"])))
    pos, full = sim.roll(steps, route["wheel_delta"], route["substeps"])
    cap = cfg_file["contacts"]["cap"]
    comp = traffic.sims.compact(full, cap) if cap else full
    pos = pos.astype(np.float32)
    t = len(pos)
    has_scan = np.zeros(t, bool)
    has_scan[route["substeps"] - 1::route["substeps"]] = True
    rot, trans = traffic.mount(laser)
    ranges = np.full((t, laser["rays"]), laser["max_range"], np.float32)
    ranges[has_scan] = traffic.laser_ranges(
        height, pos[has_scan].astype(np.float64) + trans, rot, laser, device)
    q = np.tile(np.array([1.0, 0.0, 0.0, 0.0], np.float32), (t, 1))
    return {"z0": z0, "full": full, "contacts": comp, "q": q, "pos": pos,
            "ranges": ranges, "has_scan": has_scan}


def gates(cfg_file, r):
    """The host gates of every frame, ``[T, 2]`` (measurement, mapping):
    the configuration's motion thresholds ``[distance, angle]``
    (``EmbodiedSlamFilter.cpp:239-369``), anchors starting far away.  The
    traverse keeps its heading, so no angle passes."""
    (md, _), (mapd, _) = (cfg_file["filter"]["measurement_threshold"],
                          cfg_file["filter"]["mapping_threshold"])
    ud = np.array([1000.0, 0.0, 0.0])
    mp_ = np.array([1000.0, 0.0, 0.0])
    if not (r["q"] == r["q"][0]).all():
        raise ValueError("the gates here take a traverse of one heading")
    out = np.zeros((len(r["pos"]), 2), bool)
    for t, p in enumerate(r["pos"].astype(np.float64)):
        up = np.linalg.norm(p - ud) > md
        mapped = bool(r["has_scan"][t]) and np.linalg.norm(p - mp_) > mapd
        if up:
            ud = p
        if mapped:
            mp_ = p
        out[t] = (up, mapped)
    return out


class Online:
    """The cell's port and inputs on the card: ``setup``, ``inputs(seed)``,
    ``warm_up``, ``window``, ``check``."""

    def __init__(self, cfg_file, mix, device):
        self.cfg_file, self.mix, self.device = cfg_file, mix, device
        self.on_card = device.type == "cuda"
        # traced runs: {frame: (x, y, yaw, head origins)} of the traced
        # mapping frames, for K3's bound
        self.on_mapped = None

    def setup(self, clock, seconds):
        from slam_eslam_tpu_torch.filter import streaming
        clock.part("import")
        self.nvcc_s = load_kernels() if self.on_card else 0.0
        clock.part("kernels")
        self.cfg = port.config(self.cfg_file)
        self.route = route_frames(self.cfg_file, self.mix, seconds,
                                  self.device)
        self.gates = gates(self.cfg_file, self.route)
        r, dev = self.route, self.device
        laser = self.cfg_file["laser"]
        t = len(r["pos"])
        frames = streaming.SlamFrames(
            contact=port.contact_states(r["contacts"], dev),
            q=torch.from_numpy(r["q"]).to(dev),
            body_pos=torch.from_numpy(r["pos"]).to(dev),
            ranges=torch.from_numpy(r["ranges"]).to(dev),
            start_angle=torch.full((t,), laser["start_angle"], device=dev),
            angular_resolution=torch.full((t,), laser["resolution"],
                                          device=dev),
            has_scan=torch.from_numpy(r["has_scan"]).to(dev),
            host_q=r["q"], host_body_pos=r["pos"], host_has_scan=r["has_scan"])
        # the odometry of every frame from the full contact stream, worked
        # out at once (a frame's needs only the frame before it) and given
        # to the port as its external odometry
        cs = port.plain_contacts(r["full"], slice(None), dev)
        self.odo64 = lref.odometry_frames(
            cs, torch.from_numpy(r["q"]).to(dev, torch.float64),
            self.cfg_file["odometry"])
        odos = port.odometry_states(self.odo64)
        from slam_eslam_tpu_torch.utils import tree
        self.frames = [frames.at(i) for i in range(t)]
        self.odos = [tree.index(odos, i) for i in range(t)]
        self.rot, self.trans = traffic.mount(laser)
        self.step = streaming.make_slam_step(
            self.cfg, laser2body=(self.rot, self.trans),
            external_odometry=True, graph=True if self.on_card else None)
        self.pool = None
        common.sync(dev)
        clock.part("route and odometry")

    def fresh(self, normals):
        """A new filter from the start cloud's normals, its pool the one
        the graphs were captured on, refilled in place."""
        from slam_eslam_tpu_torch.filter import streaming
        from slam_eslam_tpu_torch.filter.eslam_filter import EmbodiedSlamFilter

        f = EmbodiedSlamFilter(config=self.cfg, device=self.device).init(
            pose=(np.array([0.0, 0.0, self.route["z0"]]), 0.0),
            use_shared_map=False,
            num_contact_points=self.cfg_file["contacts"]["candidates"],
            normal_xy=normals[0], normal_yaw=normals[1], pool=self.pool)
        self.pool = f.pool
        return streaming.StreamingState.create(f.state, f.pool)

    def inputs(self, seed):
        self.seed = seed
        gen = traffic.generator(seed, self.device)
        n = self.cfg_file["particles"]
        self.normals = (torch.randn((n, 2), generator=gen, device=self.device),
                        torch.randn((n,), generator=gen, device=self.device))
        ring = self.mix["draw_ring"]
        self.draws = traffic.draws(ring, n, gen, self.device)
        self.step_draws = [port.step_draws(self.draws, i) for i in range(ring)]
        self.carry = self.fresh(self.normals)
        common.sync(self.device)

    def frame(self, carry, t):
        return self.step(carry, self.frames[t], self.odos[t],
                         self.step_draws[t % len(self.step_draws)])

    def warm_up(self):
        """Frames of the traverse until every gate combination it meets
        has been met twice (the second captures), then a fresh start."""
        keys = {tuple(g) for g in self.gates}
        met = {}
        carry = self.carry
        for t in range(len(self.frames)):
            key = tuple(self.gates[t])
            met[key] = met.get(key, 0) + 1
            carry, aux = self.frame(carry, t)
            aux["centroid"].cpu()
            if all(met.get(k, 0) >= 2 for k in keys):
                break
        common.log(f"setup: warm-up {t + 1} frames, gate combinations "
                   f"{sorted(met.items())}, graphs "
                   f"{self.step.graphs.counts() if self.step.graphs else 'eager'}")
        del carry, aux
        self.carry = self.fresh(self.normals)
        common.sync(self.device)

    def mapped_from(self):
        """The first frame at which the robot has left the scans' reach of
        its start behind: before it, no particle's map lies under its feet
        and an update weighs nothing."""
        pos = self.route["pos"]
        reach = self.cfg_file["filter"]["max_sensor_range"]
        return int(np.argmax(np.linalg.norm(pos - pos[0], axis=1) > reach))

    def sampled_frames(self, limit):
        """The checked frames among the first ``limit``: of each kind
        (``mapping``, ``measurement``, ``plain``) the number the traffic
        names, drawn from the seed (measurement frames once the maps lie
        under the feet), and the frame from which on the first
        ``checked_frames["resampling"]`` measurement frames that resample
        are checked too; and the first mapping frame after the robot
        has left its start grid's centre by the rollover threshold, where
        the heads roll over (``checked_frames["rollover"]`` of those)."""
        rng = np.random.default_rng(self.seed % (2 ** 63))
        g = self.gates[:limit]
        after = np.arange(len(g)) >= self.mapped_from()
        kinds = {"mapping": np.flatnonzero(~g[:, 0] & g[:, 1]),
                 "measurement": np.flatnonzero(g[:, 0] & ~g[:, 1] & after),
                 "plain": np.flatnonzero(~g[:, 0] & ~g[:, 1])}
        fcfg = self.cfg_file["filter"]
        pos = self.route["pos"][:limit]
        left = (np.abs(pos[:, :2] - pos[0, :2]).max(1)
                > fcfg["grid_size"] / 2.0 * fcfg["grid_threshold"])
        rolls = np.flatnonzero(left & g[:, 1] & ~g[:, 0])
        out = {int(t): "mapping"
               for t in rolls[:self.mix["checked_frames"]["rollover"]]}
        for kind in ("mapping", "measurement", "plain"):
            cand = kinds[kind][kinds[kind] > 0]
            for t in rng.choice(cand, size=min(self.mix["checked_frames"][
                    kind], len(cand)), replace=False):
                out[int(t)] = kind
        self.particle_sample = torch.from_numpy(np.sort(rng.choice(
            self.cfg_file["particles"], self.mix["checked_particles"],
            replace=False))).to(self.device)
        m = kinds["measurement"]
        self.resample_from = int(rng.choice(m[:max(1, len(m) // 4)])) \
            if len(m) else limit
        return out

    def particles(self, carry):
        """The particles, largest weight and chains of a carry (copies)."""
        p = carry.filter.particles
        snap = {k: getattr(p, k).clone()
                for k in ("x", "y", "yaw", "z", "z_sigma", "weight")}
        snap["max_weight"] = carry.filter.max_weight.clone()
        snap["chain"] = carry.pool.chain.clone()
        return snap

    def window(self, seconds, trace_path=None, expected_rate=150.0):
        """Frames from the start until ``seconds`` have passed (and the
        traced frames, with ``trace_path``, are done).  The checked frames
        are drawn among the first ``seconds * expected_rate``, a rate the
        card exceeds."""
        total = len(self.frames)
        sample = self.sampled_frames(min(total, int(seconds * expected_rate)))
        mix = self.mix
        want_resampled = mix["checked_frames"]["resampling"]
        traced = range(mix["trace_skip_frames"],
                       mix["trace_skip_frames"] + mix["trace_frames"])
        n = self.cfg_file["particles"]
        measuring = self.gates[:, 0] & ~self.gates[:, 1]
        measuring[:self.mapped_from()] = False
        carry = self.carry
        lat, reads, snaps = [], [], {}
        resampled = 0
        prof = window_span = None
        t_open = time.perf_counter()
        deadline = t_open + seconds
        t = 0
        while True:
            if t >= total:
                raise RuntimeError(f"the traverse's {total} frames ran out "
                                   f"before the window closed")
            if trace_path is not None and t == traced.start:
                prof = trace.profiled(trace_path)
                prof.__enter__()
                window_span = torch.profiler.record_function(
                    trace.WINDOW_SPAN)
                window_span.__enter__()
            kind = sample.get(t)
            if kind is not None or measuring[t]:
                before = self.particles(carry)
                if kind == "mapping":
                    before["maps"] = pool_maps(carry.pool,
                                               self.particle_sample)
            t0 = time.perf_counter()
            with trace.span("frame dispatch"):
                carry, aux = self.frame(carry, t)
            with trace.span("pose read"):
                got = torch.cat([aux["centroid"], aux["best_pose"],
                                 carry.alloc_failed.reshape(1).float()]).cpu()
            lat.append(time.perf_counter() - t0)
            reads.append(got)
            if measuring[t] and kind is None and resampled < want_resampled \
                    and t >= self.resample_from:
                # a resampling copies particles: their poses repeat
                if int(torch.unique(carry.filter.particles.x).numel()) < n:
                    kind = "measurement"
                    resampled += 1
            if kind is not None:
                after = self.particles(carry)
                if kind == "mapping":
                    after["maps"] = pool_maps(carry.pool, self.particle_sample)
                if kind == "measurement":
                    after["cells"] = block_window(
                        carry.pool, before["chain"],
                        torch.stack([before["x"], before["y"]], -1),
                        mix["snapshot_margin_m"])
                snaps[t] = (kind, before, after,
                            (aux["updated"], aux["mapped"]))
            if (self.on_mapped is not None and aux["mapped"]
                    and t in traced):
                p = carry.filter.particles
                self.on_mapped[t] = (p.x.clone(), p.y.clone(),
                                     p.yaw.clone(), carry.pool.origin
                                     .index_select(0, carry.pool.chain[:, 0]
                                                   .long()))
            t += 1
            if prof is not None and t == traced.stop:
                window_span.__exit__(None, None, None)
                prof.__exit__(None, None, None)
                prof = None
            if time.perf_counter() >= deadline and prof is None:
                break
        window_s = time.perf_counter() - t_open
        self.carry = None
        return {"frames": t, "latency": np.array(lat),
                "reads": torch.stack(reads).numpy(), "snaps": snaps,
                "unchecked": sum(f >= t for f in sample),
                "window_s": window_s, "traced": traced,
                "update_idx": carry.update_idx,
                "alloc_failed": int(carry.alloc_failed)}

    def check(self, w, control=None):
        return check_frames(self, w, control)


def pool_maps(pool, rows):
    """The logical maps of particles ``rows`` of a pool: their chains'
    grids as the reference's dict of ``[S, L, nx, ny, K]`` tensors."""
    chain = pool.chain.index_select(0, rows)                  # [S, L]
    s_, levels = chain.shape
    blk = chain.clamp(min=0).reshape(-1).long()
    shape = (s_, levels, pool.nx, pool.ny, pool.k)
    take = lambda f: f.index_select(0, blk).reshape(shape)
    meta = take(pool.meta)
    return {"mean": take(pool.mean).float(), "stdev": take(pool.stdev).float(),
            "height": take(pool.height).float(), "valid": (meta & 1) != 0,
            "horiz": (meta & 2) != 0, "uidx": meta >> 2,
            "origin": pool.origin.index_select(0, blk).reshape(s_, levels, 2),
            "exists": chain >= 0, "chain": chain}


def block_window(pool, chain, centres, margin):
    """The cells within ``margin`` m of each particle's ``centres [N, 2]``
    (world) in every block of its ``chain [N, L]``, as the reference's
    block grids (``reference.slam.chain_lookup``): ``mean``, ``stdev``,
    ``valid [N * L, W, W, K]``, each block's grid ``origin`` and the
    window's first cell ``lo [N * L, 2]`` in it, the grid's ``extent``
    and ``chain`` as rows of these blocks (-1: no block)."""
    n, levels = chain.shape
    flat = chain.reshape(-1).long()
    b = flat.clamp(min=0)
    res = pool.resolution
    w = int(np.ceil(2 * margin / res)) + 1
    origin = pool.origin.index_select(0, b)
    cen = centres.to(origin.dtype).repeat_interleave(levels, 0)
    lo = torch.floor((cen - margin - origin) / res).long()      # [B, 2]
    ar = torch.arange(w, device=lo.device)
    ix = (lo[:, :1] + ar).clamp(0, pool.nx - 1)                 # [B, W]
    iy = (lo[:, 1:] + ar).clamp(0, pool.ny - 1)
    grid = lambda f: f.view(f.shape[0], pool.nx, pool.ny, pool.k)[
        b[:, None, None], ix[:, :, None], iy[:, None, :]]
    rows = torch.arange(n * levels, device=flat.device)
    return {"mean": grid(pool.mean).float(), "stdev": grid(pool.stdev).float(),
            "valid": (grid(pool.meta) & 1) != 0, "origin": origin,
            "lo": lo, "extent": (pool.nx, pool.ny),
            "chain": torch.where(flat >= 0, rows, -1).view(n, levels)}


def check_frames(cell, w, control=None):
    """Compare each checked frame with the reference (``control``: a dtype
    whose reference stands in for the port's outputs)."""
    dev = cell.device
    f64 = torch.float64
    fcfg = cell.cfg_file["filter"]
    res = fcfg["grid_resolution"]
    snaps = w["snaps"]
    gaps = {k: 0.0 for k in LIMITS}
    gaps["alloc_failed"] = w["alloc_failed"]
    # frames drawn for the check that the window never reached
    gaps["frames_unchecked"] = w["unchecked"]
    r = cell.route
    laser = cell.cfg_file["laser"]
    stats = {"mapping": 0, "measurement": 0, "plain": 0, "resampled": 0,
             "cells": 0}
    t0 = time.perf_counter()
    for t, (kind, before, after, flags) in sorted(snaps.items()):
        stats[kind] += 1
        if tuple(bool(v) for v in flags) != tuple(cell.gates[t]):
            gaps["gates_differ"] += 1
        d = {k: v.to(dev, f64) for k, v in
             traffic.plain_draws(cell.draws, t % cell.mix["draw_ring"]).items()}
        odo = {k: v[t] for k, v in cell.odo64.items()}
        q = torch.from_numpy(r["q"][t]).to(dev, f64)
        p0 = {k: before[k].to(f64) for k in ("x", "y", "yaw", "z", "z_sigma",
                                             "weight")}
        prop = lref.propagate(p0, odo, q, before["max_weight"].to(f64), d,
                              fcfg)
        out = {k: after[k].to(f64) for k in p0}
        if kind == "measurement":
            weighed, want, idx, beyond = measured(
                cell, before, after["cells"], prop, d, t, f64)
            stats["resampled"] += int(idx is not None)
            gaps["frames_unchecked"] += int(beyond > 0)
            chain = after["chain"]
            if control is not None:
                _, ctl, cidx, _ = measured(cell, before, after["cells"], prop,
                                           d, t, control)
                out = {k: v.to(control).to(f64) for k, v in ctl.items()}
                chain = before["chain"].index_select(
                    0, torch.arange(len(out["x"]), device=dev)
                    if cidx is None else cidx)
            apart = particles_apart(weighed, out, chain, before["chain"],
                                    d["resample_u"], fcfg["min_effective"])
            gaps["particles_differ"] = max(gaps["particles_differ"], apart)
            common.log(f"check: frame {t}: the reference resampled "
                       f"{idx is not None}; particles apart {apart}")
        else:
            if control is not None:
                out = {k: v.to(control).to(f64) for k, v in prop.items()}
            gaps["chain_rows_differ"] += 0 if kind == "mapping" else int(
                (after["chain"] != before["chain"]).any(-1).sum())
            gaps["pose_z_m"] = max(gaps["pose_z_m"], float(
                (out["z"] - prop["z"]).abs().max()))
            gaps["pose_xy_m"] = max(gaps["pose_xy_m"], float(torch.sqrt(
                (out["x"] - prop["x"]) ** 2
                + (out["y"] - prop["y"]) ** 2).max()))
        if kind == "mapping":
            cloud = sref.scan_cloud(
                torch.from_numpy(r["ranges"][t]).to(dev),
                laser["start_angle"], laser["resolution"],
                fcfg["max_sensor_range"], q,
                torch.as_tensor(cell.rot, device=dev),
                torch.as_tensor(cell.trans, device=dev),
                f64 if control is None else control)
            cloud = tuple(v.to(f64) if v.is_floating_point() else v
                          for v in cloud)
            rows = cell.particle_sample
            pick = lambda k: prop[k].index_select(0, rows)
            maps0 = {k: (v.to(f64) if v.is_floating_point() else v)
                     for k, v in before["maps"].items() if k != "chain"}
            maps1, _ = sref.own_heads(
                maps0, pick("x"), pick("y"), res,
                fcfg["grid_size"] / 2.0 * fcfg["grid_threshold"])
            uidx = count_maps_before(cell, t)
            want_maps, written = sref.merge(
                maps1, pick("x"), pick("y"), pick("yaw"), pick("z"),
                pick("z_sigma"), cloud, uidx, res,
                fcfg["grid_patch_thickness"], fcfg["grid_gap_size"])
            stats["cells"] += written
            differ = maps_differ(want_maps, after["maps"])
            gaps["map_cells_differ"] = max(gaps["map_cells_differ"],
                                           differ / max(written, 1))
        # the centroid and the best particle the port returned, against
        # its own particles
        got = torch.from_numpy(w["reads"][t]).to(f64)
        if control is not None:
            # the control's answer: the same reduction in its precision
            oc = {k: out[k].to(control) for k in p0}
            wc = oc["weight"] / oc["weight"].sum()
            bc = int(torch.argmax(oc["weight"]))
            got = torch.cat([
                torch.stack([(oc[k] * wc).sum() for k in ("x", "y", "z")]),
                torch.stack([oc[k][bc] for k in ("x", "y", "z", "yaw")]),
            ]).to(f64).cpu()
        own = {k: after[k].to(f64) for k in p0}
        wn = own["weight"] / own["weight"].sum()
        cent = torch.stack([(own[k] * wn).sum() for k in ("x", "y", "z")])
        best = int(torch.argmax(after["weight"]))
        bpose = torch.stack([own[k][best] for k in ("x", "y", "z", "yaw")])
        gaps["centroid_m"] = max(gaps["centroid_m"], float(
            (got[:3] - cent.cpu()).abs().max()),
            float((got[3:7] - bpose.cpu()).abs().max()))
    # a window in none of whose checked frames the reference resampled
    # checked no resampling
    gaps["resampling_unchecked"] = int(stats["resampled"] == 0)
    checks = {name: {"value": gaps[name], "limit": LIMITS[name]}
              for name in LIMITS}
    common.log(f"check: frames {stats} in {time.perf_counter() - t0:.2f} s; "
               f"gaps {gaps}")
    return checks


def measured(cell, before, cells, prop, draws, t, dtype):
    """The reference's measurement frame from the port's particles before
    it: every propagated particle weighed through its own chain (the
    cells ``cells`` the port's pool held there), the Kalman z update, the
    discount and the ESS-gated stratified resampling with the frame's
    draws.  Returns ``(particles weighed, before the resampling; particles
    after the frame; ancestors or None; the queries that fell outside the
    cells kept)``."""
    fcfg = cell.cfg_file["filter"]
    r = cell.route
    f64 = torch.float64
    cs = port.plain_contacts(r["contacts"], t, cell.device)
    q = torch.from_numpy(r["q"][t]).to(cell.device, f64)
    res, window = fcfg["grid_resolution"], fcfg["mls_z_window"]
    beyond = []

    def lookup(x, y, z):
        found, mean, sd, out = sref.chain_lookup(cells, x, y, z, res, window)
        beyond.append(int(out.sum()))
        return found, mean, sd

    weighed, _ = lref.measure(prop, cs, q, before["max_weight"].to(f64),
                              None, fcfg, dtype, lookup=lookup)
    p, _, resampled, idx = lref.resample(weighed, draws["resample_u"],
                                         fcfg["min_effective"])
    return weighed, p, (idx if resampled else None), sum(beyond)


def particles_apart(weighed, out, chain, chain_before, u, min_effective):
    """Particles after a measurement frame that the port holds otherwise
    than the reference, in two stages.  Each slot of ``out`` has to be a
    copy of a weighed particle (pose and height within ``VALUE_TOL``)
    whose chain row it carries, and every copied particle's weight (what
    the slot carries, up to a common factor) has to be the reference's
    within ``WEIGHT_TOL``.  Then the stratified resampling with the
    frame's draws ``u``, run on the weights the port carries (the
    reference's for particles with no copy), has to give each slot the
    particle it copies.  The second stage takes the port's weights so that
    one weight that differs (a query on a cell edge) counts once, not in
    every stratum its change shifts.  A count of slots and particles."""
    src = torch.stack([weighed[k] for k in ("x", "y", "yaw", "z")], -1)
    dst = torch.stack([out[k] for k in ("x", "y", "yaw", "z")], -1)
    dist, anc = torch.cdist(dst, src).min(-1)
    copied = (dist <= VALUE_TOL) & (chain == chain_before.index_select(
        0, anc)).all(-1)
    w_ref = weighed["weight"] / weighed["weight"].sum()
    w = w_ref.clone()
    w[anc] = out["weight"]
    seen = torch.zeros_like(copied)
    seen[anc] = True
    keep = seen & (w_ref >= WEIGHT_FLOOR * w_ref.max())
    ratio = w[keep] / w_ref[keep]
    ratio = ratio / ratio.median()
    weights_apart = int(((ratio - 1).abs() > WEIGHT_TOL).sum())
    # the weights of particles with no copy, scaled as the port's
    w[~seen] = w_ref[~seen] * (w[seen] / w_ref[seen]).median()
    _, _, resampled, idx = lref.resample(
        {k: weighed[k] for k in ("x", "y", "yaw", "z", "z_sigma")}
        | {"weight": w}, u, min_effective)
    if not resampled:
        idx = torch.arange(len(w), device=w.device)
    return int((~copied | (anc != idx)).sum()) + weights_apart


def count_maps_before(cell, t):
    """The update index a merge at frame ``t`` stamps: the mapping frames
    before it."""
    return int(cell.gates[:t, 1].sum())


POOL_SPANS = {"ensure_unique_active": "pool copy-on-write",
              "rollover": "pool rollover"}
COPY_OPS = ("aten::index_select", "aten::index_copy_", "aten::where")


def span_pool_calls():
    """Wrap the map pool's copy-on-write and rollover in harness spans
    (traced runs only), where the streaming step finds them."""
    from slam_eslam_tpu_torch.mapping import map_pool

    for name, label in POOL_SPANS.items():
        fn = getattr(map_pool, name)

        def wrapped(*a, _fn=fn, _label=label, **kw):
            with trace.span(_label):
                return _fn(*a, **kw)

        setattr(map_pool, name, wrapped)


def k3_bound(cell, heads):
    """K3's bound summed over the merges of the traced frames, from the
    particles' poses and head origins there (``heads``)."""
    from benchmark.roofline import merge

    cfg, laser = cell.cfg_file, cell.cfg_file["laser"]
    fcfg = cfg["filter"]
    nx = int(round(fcfg["grid_size"] / fcfg["grid_resolution"]))
    dev = cell.device
    q = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
    total = 0.0
    for t, (x, y, yaw, origin) in heads.items():
        xy, _, _, valid = sref.scan_cloud(
            torch.from_numpy(cell.route["ranges"][t]).to(dev),
            laser["start_angle"], laser["resolution"],
            fcfg["max_sensor_range"], q, torch.as_tensor(cell.rot, device=dev),
            torch.as_tensor(cell.trans, device=dev), torch.float32)
        cells = merge.touched_cells(x, y, yaw, origin, xy, valid,
                                    fcfg["grid_resolution"], nx, nx)
        total += merge.bound_seconds(len(x), len(valid), cells,
                                     fcfg["mls_patches_per_cell"],
                                     torch.finfo(getattr(
                                         torch, fcfg["map_pool_dtype"])).bits
                                     // 8)
    return total


def run(args, cell, cfg_file, mix, clock, device=None):
    """One run of the cell: set-up, the window, the check, the line."""
    device = torch.device("cuda", 0) if device is None else device
    cellrun = Online(cfg_file, mix, device)
    if args.trace:
        span_pool_calls()
    cellrun.setup(clock, args.seconds)
    cellrun.inputs(args.seed)
    clock.part("inputs and pool")
    tdir = trace.trace_dir() if args.trace else None
    if args.trace:
        with trace.profiled(tdir / "warm.json"):
            cellrun.warm_up()
    else:
        cellrun.warm_up()
    clock.part("captures")
    if cellrun.on_card:
        torch.cuda.reset_peak_memory_stats()
    setup_s = clock.total()

    heads = {}
    if args.trace:
        cellrun.on_mapped = heads
    w = cellrun.window(args.seconds,
                       None if tdir is None else tdir / "window.json")
    peak = torch.cuda.max_memory_allocated() if cellrun.on_card else 0
    cellrun.step = cellrun.pool = None
    common.sync(device)
    lat = w["latency"].copy()
    reads = w["reads"]
    failed_rows = ~np.isfinite(reads[:, :7]).all(-1)
    rises = np.diff(np.concatenate([[0.0], reads[:, 7]])) > 0
    failed = int((failed_rows | rises).sum())
    lat[failed_rows | rises] = w["window_s"]
    common.log(f"window: {w['frames']} frames in {w['window_s']:.4f} s, "
               f"alloc_failed {w['alloc_failed']}, median "
               f"{np.median(w['latency']) * 1e3:.4f} ms")
    checks = cellrun.check(w)
    result = {"correct": failed == 0 and all(
        v["value"] <= v["limit"] for v in checks.values()),
        "attempted": w["frames"], "failed": failed}
    dev_trace = None
    if args.trace:
        tr = trace.Trace(tdir / "window.json")
        dev_trace, breakdown = trace.summary(tr)
        ctx = {"trace": tr, "frames": len(w["traced"]),
               "window_path": tdir / "window.json",
               "capture_path": tdir / "warm.json",
               "copy_ops": COPY_OPS, "copy_spans": tuple(POOL_SPANS.values()),
               "k3_bound_s": k3_bound(cellrun, heads)}
        result["metrics"] = metrics.read(cell, ctx)
        result["breakdown"] = breakdown
        trace.remove_dir(tdir)
    else:
        result["metrics"] = {
            "slam_frames_per_s": {"value": w["frames"] / w["window_s"],
                                  "unit": "frames/s"},
            "slam_frame_p95_ms": {"value": float(np.quantile(lat, 0.95))
                                  * 1e3, "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    result["device"] = (common.device_info(1, peak, dev_trace)
                        if cellrun.on_card else {"platform": "cpu"})
    result["setup"] = dict(clock.parts, nvcc_s=cellrun.nvcc_s)
    return result, checks


VALUE_TOL = 1e-4   # metres: a slot's mean, stdev or height; a pose
WEIGHT_TOL = 1e-4  # a particle's weight, relative
# weights below this share of the largest are compared by nobody: float32
# keeps few digits there
WEIGHT_FLOOR = 1e-30


def maps_differ(want, got):
    """Cells of the reference's maps ``want`` that the port's ``got``
    holds otherwise: a level present on one side only or at another
    origin counts all its cells; a cell differs where a slot's valid bit
    differs, or a valid slot's horizontal bit, update stamp, mean, stdev
    or height (by more than ``VALUE_TOL``)."""
    dev = got["mean"].device
    w = {k: v.to(dev) for k, v in want.items()}
    nx, ny = w["mean"].shape[2:4]
    level_bad = ((w["exists"] != got["exists"])
                 | (w["exists"] & ((w["origin"] - got["origin"].to(
                     torch.float64)).abs().max(-1).values > 1e-3)))
    both = w["exists"] & got["exists"] & ~level_bad
    valid = w["valid"]
    slot_bad = (valid != got["valid"]) | (valid & (
        (w["horiz"] != got["horiz"]) | (w["uidx"] != got["uidx"])
        | ((w["mean"] - got["mean"].double()).abs() > VALUE_TOL)
        | ((w["stdev"] - got["stdev"].double()).abs() > VALUE_TOL)
        | ((w["height"] - got["height"].double()).abs() > VALUE_TOL)))
    cell_bad = slot_bad.any(-1) & both[..., None, None]
    return int(cell_bad.sum()) + int(level_bad.sum()) * nx * ny


Cell = Online
