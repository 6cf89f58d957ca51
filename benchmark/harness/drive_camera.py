"""The ``camera`` drive: the robot online with a stereo head as its only
mapping sensor.  Frames go one at a time through the port's graphed SLAM
step (``filter.streaming.make_slam_step`` with ``camera2body``,
``camera_intrinsics`` and ``camera_texture``; no laser), each frame's pose
read to the host before the next is dispatched, as the ``frames`` drive
does (``drive_frames``, whose pieces this drive reuses).  A camera frame
uploads its distance image and texture from host memory to the card
inside its dispatch, as a robot's stereo pipeline hands them over.

Set-up makes the traverse (the Asguard rolling straight ahead, one
distance image with its RGB texture a step, cast into the terrain from the
configuration's camera mount: ``images``), its odometry, the start cloud
and a ring of draws from the seed, the filter with its colour-carrying
map pool, and warms every gate combination up to capture.

The check follows ``drive_frames``'s: plain and measurement frames as
there; on a camera mapping frame the reference (``reference.slam_camera``)
takes the sampled particles' head grids before the frame, in a window of
cells around each particle that the camera can reach, rolls them over
where the particle left its grid, merges the frame's image into them and
holds the port's head windows, head origins and chain levels after the
frame to its own (``map_cells_differ``)."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchmark.harness import common, drive_frames, metrics, port, trace, traffic
from benchmark.harness.drive_chunks import load_kernels
from benchmark.reference import localization as lref
from benchmark.reference import slam_camera as cref

# the numbers compared and their limits, set from the readings in PERF.md:
# each above the geometric mean of the largest sound reading (19 runs)
# and the smallest of the control (5 seeds), so that it has more room, as
# a ratio, above the one than below the other
LIMITS = {
    "pose_xy_m": 2e-4, "pose_z_m": 1e-5, "map_cells_differ": 0.05,
    "particles_differ": 80, "chain_rows_differ": 0, "centroid_m": 2e-4,
    "alloc_failed": 0, "gates_differ": 0, "frames_unchecked": 0,
    "resampling_unchecked": 0,
}
VALUE_TOL = drive_frames.VALUE_TOL   # metres, and a colour channel in [0, 1]
# Newton steps of the ray casting (the terrain's slopes stay far below the
# rays' descent, so a handful converge to rounding)
NEWTON_STEPS = 12


def camera_config(cfg_file):
    """The port's ``Config``: the filter group, its camera mapping gate
    ``[distance, angle]`` included."""
    from slam_eslam_tpu_torch.config import UpdateThreshold

    fil = dict(cfg_file["filter"])
    gate = fil.pop("mapping_camera_threshold")
    cfg = port.config(dict(cfg_file, filter=fil))
    return dataclasses.replace(cfg,
                               mapping_camera_threshold=UpdateThreshold(*gate))


def mount(camera):
    """The camera's mount, ``(rot [3, 3] camera to body, trans [3])`` in
    float64: camera z forward along body +y, x along body +x, y down,
    pitched down by ``mount_pitch``, at ``mount_xyz``."""
    a = -camera["mount_pitch"]
    pitch = np.array([[1.0, 0.0, 0.0], [0.0, np.cos(a), -np.sin(a)],
                      [0.0, np.sin(a), np.cos(a)]])
    axes = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, -1.0, 0.0]])
    return pitch @ axes, np.asarray(camera["mount_xyz"], np.float64)


def intrinsics(camera):
    """``(scale_x, scale_y, center_x, center_y)``: square pixels over the
    horizontal field of view, the optical axis at the image's centre."""
    s = np.tan(camera["fov_x"] / 2.0) / (camera["width"] / 2.0)
    return (s, s, -s * (camera["width"] - 1) / 2.0,
            -s * (camera["height"] - 1) / 2.0)


def texture(x, y):
    """The terrain's RGB colour at world ``x, y`` (tensors), in [0, 1]."""
    return torch.stack([0.5 + 0.5 * torch.sin(3.1 * x + 1.7 * y),
                        0.5 + 0.5 * torch.cos(2.3 * x - 1.1 * y),
                        0.5 + 0.5 * torch.sin(1.3 * x) * torch.cos(2.9 * y)],
                       -1)


def images(kind, origins, rot, camera, device, pinned, batch=8):
    """Distance images ``[K, H, W]`` float32 and textures ``[K, H, W, 3]``
    uint8, on the host, from the camera at each of ``origins [K, 3]``
    (world; ``rot``: camera to world): each pixel's ray cast into the
    terrain ``kind`` by Newton's method on the ray's depth, from the depth
    that flat ground at the camera's foot would give; the texture the
    terrain's colour at the hit, in 8 bits.  A ray that does not descend
    reads infinity, which the filter drops."""
    a, kx, b, ky = traffic.sims.TERRAINS[kind]
    h, w = camera["height"], camera["width"]
    sx, sy, cx, cy = intrinsics(camera)
    f = dict(dtype=torch.float64, device=device)
    u = torch.arange(w, **f).repeat(h) * sx + cx
    v = torch.arange(h, **f).repeat_interleave(w) * sy + cy
    d = torch.stack([u, v, torch.ones_like(u)], -1) @ torch.as_tensor(
        rot, **f).T                                          # [P, 3]
    k = len(origins)
    depth = torch.empty((k, h, w), dtype=torch.float32, pin_memory=pinned)
    tex = torch.empty((k, h, w, 3), dtype=torch.uint8, pin_memory=pinned)
    height = lambda x, y: a * torch.sin(kx * x) + b * torch.cos(ky * y)
    for lo in range(0, k, batch):
        o = torch.as_tensor(origins[lo:lo + batch], **f)[:, None, :]
        t = (o[..., 2] - height(o[..., 0], o[..., 1])) / (-d[:, 2])
        for _ in range(NEWTON_STEPS):
            p = o + t[..., None] * d
            fx = p[..., 2] - height(p[..., 0], p[..., 1])
            slope = (d[:, 2] - a * kx * torch.cos(kx * p[..., 0]) * d[:, 0]
                     + b * ky * torch.sin(ky * p[..., 1]) * d[:, 1])
            t = t - fx / slope
        p = o + t[..., None] * d
        t = torch.where((d[:, 2] < 0) & (t > 0), t,
                        torch.full_like(t, float("inf")))
        depth[lo:lo + batch] = t.float().reshape(-1, h, w).cpu()
        col = (texture(p[..., 0], p[..., 1]) * 255.0).round().clamp(0, 255)
        tex[lo:lo + batch] = col.to(torch.uint8).reshape(-1, h, w, 3).cpu()
    return depth, tex


def route_frames(cfg_file, mix, seconds, device):
    """The traverse as host arrays: per frame the full contact state, the
    compacted one, ``q``, the body position and ``has_img`` (each step's
    last frame), and the images of the frames that have one (``depth``,
    ``texture``; ``image_of``: a frame's image, -1 for none); as many
    steps as ``max_frames_per_s`` frames over ``seconds`` take."""
    route, cam = mix["route"], cfg_file["camera"]
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
    has_img = np.zeros(t, bool)
    has_img[route["substeps"] - 1::route["substeps"]] = True
    image_of = np.where(has_img, np.cumsum(has_img) - 1, -1)
    rot, trans = mount(cam)
    depth, tex = images(cfg_file["terrain"],
                        pos[has_img].astype(np.float64) + trans, rot, cam,
                        device, device.type == "cuda")
    q = np.tile(np.array([1.0, 0.0, 0.0, 0.0], np.float32), (t, 1))
    return {"z0": z0, "full": full, "contacts": comp, "q": q, "pos": pos,
            "has_img": has_img, "image_of": image_of, "depth": depth,
            "texture": tex}


def gates(cfg_file, r):
    """The host gates of every frame, ``[T, 2]`` (measurement, camera
    mapping): ``drive_frames.gates`` with the camera's gate and images.
    The traverse keeps its heading, so the camera's anchor moves with the
    body's."""
    fil = dict(cfg_file["filter"],
               mapping_threshold=cfg_file["filter"]["mapping_camera_threshold"])
    return drive_frames.gates(dict(cfg_file, filter=fil),
                              dict(r, has_scan=r["has_img"]))


class Camera(drive_frames.Online):
    """The cell's port and inputs on the card: ``setup``, ``inputs(seed)``,
    ``warm_up``, ``window``, ``check``."""

    def setup(self, clock, seconds):
        from slam_eslam_tpu_torch.filter import streaming
        from slam_eslam_tpu_torch.utils import tree
        clock.part("import")
        self.nvcc_s = load_kernels() if self.on_card else 0.0
        clock.part("kernels")
        self.cfg = camera_config(self.cfg_file)
        self.route = route_frames(self.cfg_file, self.mix, seconds,
                                  self.device)
        self.gates = gates(self.cfg_file, self.route)
        r, dev = self.route, self.device
        cam = self.cfg_file["camera"]
        h, w = cam["height"], cam["width"]
        t = len(r["pos"])
        # what a frame hands the port: the image a camera frame uploads
        self.dimg = torch.zeros((h, w), device=dev)
        self.tex8 = torch.zeros((h, w, 3), dtype=torch.uint8, device=dev)
        self.timg = torch.zeros((h, w, 3), device=dev)
        no_scan = np.zeros(t, bool)
        frames = streaming.SlamFrames(
            contact=port.contact_states(r["contacts"], dev),
            q=torch.from_numpy(r["q"]).to(dev),
            body_pos=torch.from_numpy(r["pos"]).to(dev),
            ranges=torch.zeros((t, 1), device=dev),
            start_angle=torch.zeros(t, device=dev),
            angular_resolution=torch.ones(t, device=dev),
            has_scan=torch.from_numpy(no_scan).to(dev),
            host_q=r["q"], host_body_pos=r["pos"], host_has_scan=no_scan,
            dimg=self.dimg.expand(t, h, w),
            has_dimg=torch.from_numpy(r["has_img"]).to(dev),
            timg=self.timg.expand(t, h, w, 3), host_has_dimg=r["has_img"])
        cs = port.plain_contacts(r["full"], slice(None), dev)
        self.odo64 = lref.odometry_frames(
            cs, torch.from_numpy(r["q"]).to(dev, torch.float64),
            self.cfg_file["odometry"])
        odos = port.odometry_states(self.odo64)
        self.frames = [frames.at(i) for i in range(t)]
        self.odos = [tree.index(odos, i) for i in range(t)]
        self.rot, self.trans = mount(cam)
        self.intrinsics = intrinsics(cam)
        self.step = streaming.make_slam_step(
            self.cfg, camera2body=(self.rot, self.trans),
            camera_intrinsics=self.intrinsics, camera_texture=True,
            external_odometry=True, graph=True if self.on_card else None)
        self.pool = None
        common.sync(dev)
        clock.part("route, images and odometry")

    def upload(self, t):
        """Frame ``t``'s image, if it has one, into the buffers the frame
        hands the port (on the stream, after the frames before it)."""
        k = int(self.route["image_of"][t])
        if k >= 0:
            self.dimg.copy_(self.route["depth"][k], non_blocking=True)
            self.tex8.copy_(self.route["texture"][k], non_blocking=True)
            torch.div(self.tex8, 255.0, out=self.timg)

    def frame(self, carry, t):
        self.upload(t)
        return super().frame(carry, t)

    def image(self, t, dtype=torch.float32):
        """Frame ``t``'s distance image and texture on the card, as the
        port is handed them."""
        k = int(self.route["image_of"][t])
        depth = self.route["depth"][k].to(self.device)
        tex = self.route["texture"][k].to(self.device) / 255.0
        return depth.to(dtype), tex.to(dtype)

    def heads(self, pool, centres):
        """The sampled particles' head grids around ``centres [S, 2]``
        (world): ``{"origin" [S, 2], "lo" [S, 2], "levels" [S, L, 2] (NaN:
        no level), "win": the window of W x W cells from ``lo``}``, cells
        outside the grid held invalid."""
        rows = self.particle_sample
        chain = pool.chain.index_select(0, rows)              # [S, L]
        s_, levels = chain.shape
        b = chain[:, 0].clamp(min=0).long()
        res = pool.resolution
        margin = self.mix["camera_window_m"]
        w = int(np.ceil(2 * margin / res)) + 1
        org = pool.origin.index_select(0, b)
        lo = torch.floor((centres.to(org.dtype) - margin - org) / res).long()
        ar = torch.arange(w, device=lo.device)
        ix, iy = lo[:, :1] + ar, lo[:, 1:] + ar                # [S, W]
        inside = (((ix >= 0) & (ix < pool.nx))[:, :, None]
                  & ((iy >= 0) & (iy < pool.ny))[:, None, :])   # [S, W, W]
        cx, cy = ix.clamp(0, pool.nx - 1), iy.clamp(0, pool.ny - 1)
        grid = lambda f, *trail: f.view(pool.b, pool.nx, pool.ny, pool.k,
                                        *trail)[b[:, None, None],
                                                cx[:, :, None], cy[:, None, :]]
        meta = grid(pool.meta)
        win = {"mean": grid(pool.mean).float(),
               "stdev": grid(pool.stdev).float(),
               "height": grid(pool.height).float(),
               "valid": ((meta & 1) != 0) & inside[..., None],
               "horiz": (meta & 2) != 0, "uidx": meta >> 2,
               "color": grid(pool.color, 3).float()}
        lvl = pool.origin.index_select(0, chain.clamp(min=0).reshape(-1).long())
        lvl = torch.where((chain >= 0).reshape(-1, 1), lvl,
                          torch.full_like(lvl, float("nan")))
        return {"origin": org, "lo": lo, "levels": lvl.view(s_, levels, 2),
                "win": win}

    def window(self, seconds, trace_path=None, expected_rate=150.0):
        """``drive_frames.Online.window`` for the camera: frames from the
        start until ``seconds`` have passed (and the traced frames are
        done), the checked frames' states kept, a camera mapping frame's
        with the sampled particles' head windows."""
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
                    centres = torch.stack([before["x"], before["y"]], -1)
                    centres = centres.index_select(0, self.particle_sample)
                    before["heads"] = self.heads(carry.pool, centres)
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
                if resampled_here(carry, n):
                    kind = "measurement"
                    resampled += 1
            if kind is not None:
                after = self.particles(carry)
                if kind == "mapping":
                    after["heads"] = self.heads(carry.pool, centres)
                if kind == "measurement":
                    after["cells"] = drive_frames.block_window(
                        carry.pool, before["chain"],
                        torch.stack([before["x"], before["y"]], -1),
                        mix["snapshot_margin_m"])
                snaps[t] = (kind, before, after,
                            (aux["updated"], aux["cam_mapped"]))
            if (self.on_mapped is not None and aux["cam_mapped"]
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


def resampled_here(carry, n):
    """Whether the frame just run resampled: a resampling copies particles,
    so two of the ``n`` hold one pose (x, y and yaw; x alone repeats by
    chance in a cloud a few centimetres wide)."""
    p = carry.filter.particles
    poses = torch.stack([p.x, p.y, p.yaw], -1)
    return int(torch.unique(poses, dim=0).shape[0]) < n


def mapping_differ(cell, t, before, after, prop, control):
    """A camera mapping frame's sampled head grids against the reference
    (``control``: the reference with its merge sums in that dtype stands
    in for the port): ``(cells differing, cells written, points of the
    image beyond the windows)``.  A particle whose head origin or chain
    levels differ counts its whole window."""
    fcfg = cell.cfg_file["filter"]
    res = fcfg["grid_resolution"]
    nx = int(round(fcfg["grid_size"] / res))
    f32 = torch.float32
    rows = cell.particle_sample
    pick = lambda k: prop[k].index_select(0, rows).to(f32)
    x, y, yaw, z, zs = (pick(k) for k in ("x", "y", "yaw", "z", "z_sigma"))
    hb, ha = before["heads"], after["heads"]
    origin, rolled = cref.heads(hb["origin"], x, y, res, (nx, nx),
                                fcfg["grid_size"] / 2.0 * fcfg["grid_threshold"])
    levels = cref.rolled_levels(hb["levels"], origin, rolled)
    gap = (levels - ha["levels"]).abs()
    level_bad = (torch.where(levels.isnan() & ha["levels"].isnan(),
                             torch.zeros_like(gap), gap.nan_to_num(1.0))
                 > 1e-3).any(-1).any(-1)
    start = {k: torch.where(
        rolled.view((-1,) + (1,) * (v.dim() - 1)), torch.zeros_like(v), v)
        for k, v in hb["win"].items()}
    depth, tex = cell.image(t)
    q = torch.from_numpy(cell.route["q"][t]).to(cell.device, f32)
    cloud = cref.image_cloud(depth, cell.intrinsics, fcfg["max_sensor_range"],
                             q, torch.as_tensor(cell.rot, device=cell.device),
                             torch.as_tensor(cell.trans, device=cell.device),
                             tex)
    uidx = drive_frames.count_maps_before(cell, t)
    args = (origin, ha["lo"], (nx, nx), x, y, yaw, z, zs, cloud, uidx, res,
            fcfg["grid_patch_thickness"], fcfg["grid_gap_size"])
    want, written, beyond = cref.merge(start, *args)
    got = ha["win"] if control is None else cref.merge(
        start, *args, sum_dtype=control)[0]
    bad = cref.cell_changes(want, got, VALUE_TOL, VALUE_TOL)
    w2 = bad.shape[1] * bad.shape[2]
    return (int(bad.sum()) + int(level_bad.sum()) * w2, written, beyond)


def check_frames(cell, w, control=None):
    """``drive_frames.check_frames`` for the camera: each checked frame
    against the reference (``control``: a dtype whose reference stands in
    for the port's outputs)."""
    dev = cell.device
    f64 = torch.float64
    fcfg = cell.cfg_file["filter"]
    snaps = w["snaps"]
    gaps = {k: 0.0 for k in LIMITS}
    gaps["alloc_failed"] = w["alloc_failed"]
    gaps["frames_unchecked"] = w["unchecked"]
    r = cell.route
    stats = {"mapping": 0, "measurement": 0, "plain": 0, "resampled": 0,
             "cells": 0, "beyond": 0}
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
            weighed, want, idx, beyond = drive_frames.measured(
                cell, before, after["cells"], prop, d, t, f64)
            stats["resampled"] += int(idx is not None)
            gaps["frames_unchecked"] += int(beyond > 0)
            chain = after["chain"]
            if control is not None:
                _, ctl, cidx, _ = drive_frames.measured(
                    cell, before, after["cells"], prop, d, t, control)
                out = {k: v.to(control).to(f64) for k, v in ctl.items()}
                chain = before["chain"].index_select(
                    0, torch.arange(len(out["x"]), device=dev)
                    if cidx is None else cidx)
            apart = drive_frames.particles_apart(
                weighed, out, chain, before["chain"], d["resample_u"],
                fcfg["min_effective"])
            gaps["particles_differ"] = max(gaps["particles_differ"], apart)
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
            differ, written, beyond = mapping_differ(cell, t, before, after,
                                                     prop, control)
            stats["cells"] += written
            stats["beyond"] += beyond
            gaps["frames_unchecked"] += int(beyond > 0)
            gaps["map_cells_differ"] = max(gaps["map_cells_differ"],
                                           differ / max(written, 1))
        got = torch.from_numpy(w["reads"][t]).to(f64)
        if control is not None:
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
    gaps["resampling_unchecked"] = int(stats["resampled"] == 0)
    checks = {name: {"value": gaps[name], "limit": LIMITS[name]}
              for name in LIMITS}
    common.log(f"check: frames {stats} in {time.perf_counter() - t0:.2f} s; "
               f"gaps {gaps}")
    return checks


def merge_bound(cell, heads):
    """The cloud merge's bound summed over the traced camera frames, from
    the particles' poses and head origins there (``heads``) and each
    frame's image (``roofline/merge_cloud.py``)."""
    from benchmark.roofline import merge_cloud

    fcfg = cell.cfg_file["filter"]
    res = fcfg["grid_resolution"]
    nx = int(round(fcfg["grid_size"] / res))
    slot_bytes = torch.finfo(getattr(torch, fcfg["map_pool_dtype"])).bits // 8
    dev = cell.device
    total = 0.0
    for t, (x, y, yaw, origin) in heads.items():
        depth, _ = cell.image(t)
        q = torch.from_numpy(cell.route["q"][t]).to(dev)
        xy, _, _, valid, _ = cref.image_cloud(
            depth, cell.intrinsics, fcfg["max_sensor_range"], q,
            torch.as_tensor(cell.rot, device=dev),
            torch.as_tensor(cell.trans, device=dev))
        placed, cells = merge_cloud.placements(x, y, yaw, origin, xy, valid,
                                               res, nx, nx)
        total += merge_cloud.bound_seconds(
            len(x), len(valid), placed, cells, fcfg["mls_patches_per_cell"],
            slot_bytes, fcfg["map_pool_color"])
    return total


def run(args, cell, cfg_file, mix, clock, device=None):
    """One run of the cell: set-up, the window, the check, the line."""
    device = torch.device("cuda", 0) if device is None else device
    cellrun = Camera(cfg_file, mix, device)
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
    imgs = cellrun.route["has_img"][:w["frames"]]
    common.log(f"window: {w['frames']} frames ({int(imgs.sum())} with an "
               f"image) in {w['window_s']:.4f} s, alloc_failed "
               f"{w['alloc_failed']}, median "
               f"{np.median(w['latency']) * 1e3:.4f} ms, image frames' "
               f"median {np.median(w['latency'][imgs]) * 1e3:.4f} ms")
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
               "cloud_merge_bound_s": merge_bound(cellrun, heads)}
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


Cell = Camera
