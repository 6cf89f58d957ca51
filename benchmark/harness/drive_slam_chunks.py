"""The ``slam_chunks`` drive: the online traverse replayed ahead through
the port's graphed SLAM scan runner
(``filter.streaming.make_slam_scan_runner``), in chunks of
``chunk_frames`` frames dispatched back to back, the carry handed from
chunk to chunk and each chunk's poses (centroid and best particle) read
to the host at its end: SLAM at the rate the card sets, with no read per
frame.

Set-up is the ``frames`` drive's (``drive_frames``: the traverse, its
scans, odometry, start cloud, draws and pool), with the scan runner in
place of the one-frame step; warm-up runs the traverse in chunks until
every gate combination it meets has been captured.

The window reads only poses, so after it the same runner runs the
traverse once more from the start (``rerun``), in chunks that end just
before each frame the check takes, which then runs as a chunk of its own
with the pool read before and after it: the frames ``drive_frames``'s
check draws from the seed, and the first measurement frames that
resample.  The rerun's poses have to equal the window's bit for bit
(``replayed_frames_differ``), and its frames are held to the reference
by ``drive_frames.check_frames``, with ``slam_1k.online``'s limits."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import (common, drive_camera, drive_frames, metrics,
                               port, trace)
from benchmark.harness.drive_chunks import load_kernels

LIMITS = dict(drive_frames.LIMITS, replayed_frames_differ=0)


class SlamReplay(drive_frames.Online):
    """The cell's port and inputs on the card: ``setup``, ``inputs(seed)``,
    ``warm_up``, ``window``, ``check``."""

    def setup(self, clock, seconds):
        from slam_eslam_tpu_torch.filter import streaming
        clock.part("import")
        self.nvcc_s = load_kernels() if self.on_card else 0.0
        clock.part("kernels")
        self.cfg = port.config(self.cfg_file)
        self.route = drive_frames.route_frames(self.cfg_file, self.mix,
                                               seconds, self.device)
        self.gates = drive_frames.gates(self.cfg_file, self.route)
        r, dev = self.route, self.device
        laser = self.cfg_file["laser"]
        t = len(r["pos"])
        self.stacked = streaming.SlamFrames(
            contact=port.contact_states(r["contacts"], dev),
            q=torch.from_numpy(r["q"]).to(dev),
            body_pos=torch.from_numpy(r["pos"]).to(dev),
            ranges=torch.from_numpy(r["ranges"]).to(dev),
            start_angle=torch.full((t,), laser["start_angle"], device=dev),
            angular_resolution=torch.full((t,), laser["resolution"],
                                          device=dev),
            has_scan=torch.from_numpy(r["has_scan"]).to(dev),
            host_q=r["q"], host_body_pos=r["pos"], host_has_scan=r["has_scan"])
        cs = port.plain_contacts(r["full"], slice(None), dev)
        from benchmark.reference import localization as lref
        self.odo64 = lref.odometry_frames(
            cs, torch.from_numpy(r["q"]).to(dev, torch.float64),
            self.cfg_file["odometry"])
        self.odos = port.odometry_states(self.odo64)
        self.rot, self.trans = drive_frames.traffic.mount(laser)
        self.runner = streaming.make_slam_scan_runner(
            self.cfg, laser2body=(self.rot, self.trans),
            external_odometry=True, graph=True if self.on_card else None)
        self.pool = None
        common.sync(dev)
        clock.part("route and odometry")

    def chunk(self, carry, lo, hi):
        """Frames ``[lo, hi)`` through the runner: ``(carry, aux)``."""
        from slam_eslam_tpu_torch.utils import tree

        ring = self.step_draws
        return self.runner(carry, self.stacked.at(slice(lo, hi)),
                           tree.index(self.odos, slice(lo, hi)),
                           [ring[t % len(ring)] for t in range(lo, hi)])

    @staticmethod
    def poses(aux):
        """A chunk's ``[T, 7]`` poses on the device (centroid, best)."""
        return torch.cat([aux["centroid"], aux["best_pose"]], -1)

    def warm_up(self):
        """Chunks of the traverse until every gate combination it meets
        has been met twice (the second captures), then a fresh start."""
        keys = {tuple(g) for g in self.gates}
        met, end = {}, len(self.gates)
        for t, g in enumerate(self.gates):
            met[tuple(g)] = met.get(tuple(g), 0) + 1
            if all(met.get(k, 0) >= 2 for k in keys):
                end = t + 1
                break
        carry, size = self.carry, self.mix["chunk_frames"]
        for lo in range(0, end, size):
            carry, aux = self.chunk(carry, lo, min(lo + size, end))
            self.poses(aux).cpu()
        graphs = self.runner.graphs
        common.log(f"setup: warm-up {end} frames, gate combinations "
                   f"{sorted(met.items())}, graphs "
                   f"{graphs.counts() if graphs else 'eager'}")
        del carry, aux
        self.carry = self.fresh(self.normals)
        common.sync(self.device)

    def window(self, seconds, trace_path=None, expected_rate=150.0):
        """Chunks from the start until ``seconds`` have passed (and the
        traced chunks, with ``trace_path``, are done).  The frames the
        check takes are drawn among the first ``seconds * expected_rate``
        (``sampled_frames``)."""
        total = len(self.gates)
        self.sample = self.sampled_frames(min(total,
                                              int(seconds * expected_rate)))
        mix, size = self.mix, self.mix["chunk_frames"]
        traced = range(mix["trace_skip_chunks"],
                       mix["trace_skip_chunks"] + mix["trace_chunks"])
        carry = self.carry
        reads = []
        prof = window_span = None
        t_open = time.perf_counter()
        deadline = t_open + seconds
        k = t = 0
        while True:
            if t + size > total:
                raise RuntimeError(f"the traverse's {total} frames ran out "
                                   f"before the window closed")
            if trace_path is not None and k == traced.start:
                prof = trace.profiled(trace_path)
                prof.__enter__()
                window_span = torch.profiler.record_function(
                    trace.WINDOW_SPAN)
                window_span.__enter__()
            with trace.span("chunk dispatch"):
                carry, aux = self.chunk(carry, t, t + size)
            with trace.span("pose read"):
                reads.append(self.poses(aux).cpu())
            t += size
            k += 1
            if prof is not None and k == traced.stop:
                window_span.__exit__(None, None, None)
                prof.__exit__(None, None, None)
                prof = None
            if time.perf_counter() >= deadline and prof is None:
                break
        window_s = time.perf_counter() - t_open
        self.carry = None
        return {"frames": t, "chunks": k, "reads": torch.cat(reads).numpy(),
                "window_s": window_s, "traced": traced,
                "alloc_failed": int(carry.alloc_failed),
                "unchecked": sum(f >= t for f in self.sample)}

    def rerun(self, w):
        """The traverse once more through the same runner from the start
        state, each frame the check takes a chunk of its own with the
        pool read around it (``drive_frames.Online.window``'s snapshots),
        the frames between in chunks of up to ``chunk_frames``.  Stores
        ``w["snaps"]`` and ``w["replayed_frames_differ"]``: the rerun's
        frames whose poses are not the window's bit for bit."""
        self.carry = self.fresh(self.normals)
        carry, size = self.carry, self.mix["chunk_frames"]
        want_resampled = self.mix["checked_frames"]["resampling"]
        n = self.cfg_file["particles"]
        measuring = self.gates[:, 0] & ~self.gates[:, 1]
        measuring[:self.mapped_from()] = False
        sample = {t: kind for t, kind in self.sample.items()
                  if t < w["frames"]}
        last = max(sample, default=-1)
        snaps, out = {}, []
        resampled = t = 0
        while t < w["frames"]:
            searching = resampled < want_resampled
            if t > last and not searching:
                break
            kind = sample.get(t)
            looks = searching and measuring[t] and t >= self.resample_from
            if kind is None and not looks:
                ahead = [f for f in sample if f > t]
                if searching:
                    ahead += [int(f) for f in np.flatnonzero(
                        measuring[t:w["frames"]]) + t
                        if f >= self.resample_from]
                end = min([t + size, w["frames"]] + ahead)
                carry, aux = self.chunk(carry, t, end)
                out.append(self.poses(aux).cpu())
                t = end
                continue
            before = self.particles(carry)
            if kind == "mapping":
                before["maps"] = drive_frames.pool_maps(
                    carry.pool, self.particle_sample)
            carry, aux = self.chunk(carry, t, t + 1)
            out.append(self.poses(aux).cpu())
            if kind is None:
                if drive_camera.resampled_here(carry, n):
                    kind = "measurement"
                    resampled += 1
            if kind is not None:
                after = self.particles(carry)
                if kind == "mapping":
                    after["maps"] = drive_frames.pool_maps(
                        carry.pool, self.particle_sample)
                if kind == "measurement":
                    after["cells"] = drive_frames.block_window(
                        carry.pool, before["chain"],
                        torch.stack([before["x"], before["y"]], -1),
                        self.mix["snapshot_margin_m"])
                snaps[t] = (kind, before, after,
                            (bool(aux["updated"][0]), bool(aux["mapped"][0])))
            t += 1
        common.sync(self.device)
        got = torch.cat(out).numpy() if out else np.zeros((0, 7), np.float32)
        want = w["reads"][:len(got)]
        w["snaps"] = snaps
        w["replayed_frames_differ"] = int(
            (got.view(np.int32) != want.view(np.int32)).any(-1).sum())
        common.log(f"rerun: {len(got)} frames, {len(snaps)} checked, "
                   f"{w['replayed_frames_differ']} not the window's")
        self.carry = None

    def check(self, w, control=None):
        if "snaps" not in w:
            self.rerun(w)
        checks = drive_frames.check_frames(self, w, control)
        checks["replayed_frames_differ"] = {
            "value": w["replayed_frames_differ"],
            "limit": LIMITS["replayed_frames_differ"]}
        return checks


def run(args, cell, cfg_file, mix, clock, device=None):
    """One run of the cell: set-up, the window, the rerun and check, the
    line."""
    device = torch.device("cuda", 0) if device is None else device
    cellrun = SlamReplay(cfg_file, mix, device)
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
    w = cellrun.window(args.seconds,
                       None if tdir is None else tdir / "window.json")
    peak = torch.cuda.max_memory_allocated() if cellrun.on_card else 0
    common.log(f"window: {w['frames']} frames in {w['chunks']} chunks in "
               f"{w['window_s']:.4f} s, alloc_failed {w['alloc_failed']}")
    cellrun.rerun(w)
    cellrun.runner = cellrun.pool = None
    common.sync(device)
    failed = int((~np.isfinite(w["reads"])).any(-1).sum())
    checks = cellrun.check(w)
    result = {"correct": failed == 0 and all(
        v["value"] <= v["limit"] for v in checks.values()),
        "attempted": w["frames"], "failed": failed}
    dev_trace = None
    if args.trace:
        tr = trace.Trace(tdir / "window.json")
        dev_trace, breakdown = trace.summary(tr)
        ctx = {"trace": tr, "frames": len(w["traced"]) * mix["chunk_frames"],
               "window_path": tdir / "window.json",
               "capture_path": tdir / "warm.json"}
        result["metrics"] = metrics.read(cell, ctx)
        result["breakdown"] = breakdown
        trace.remove_dir(tdir)
    else:
        result["metrics"] = {
            "slam_frames_per_s": {"value": w["frames"] / w["window_s"],
                                  "unit": "frames/s"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    result["device"] = (common.device_info(1, peak, dev_trace)
                        if cellrun.on_card else {"platform": "cpu"})
    result["setup"] = dict(clock.parts, nvcc_s=cellrun.nvcc_s)
    return result, checks


Cell = SlamReplay
