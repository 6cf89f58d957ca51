"""The general traffic generator: a traffic mix is a data file
(``benchmark/traffic/<name>.json``) of parameters, and this module makes
the inputs it describes, from a configuration and a seed, as NumPy arrays
(``harness.sims``) and seeded device tensors.

Route kinds (``route.kind``):

* ``lap``: a closed circuit of ``TrajectorySim`` (``speed`` a step along
  body +y, ``yaw_rate`` a step, ``lap_steps`` steps), one terrain-conformal
  contact state a step with the stance feet's height noise
  ``contact_noise`` drawn from the seed, each stance foot standing
  ``stance_steps`` steps where it touched down, compacted to the
  configuration's ``contacts.cap``; the drive repeats the lap.
* ``roll``: the Asguard rolling straight ahead, ``wheel_delta`` rad a
  step in ``substeps`` contact frames, one laser scan on each step's last
  frame, cast into the terrain (``laser_ranges``) from the configuration's
  laser mount; the route is long enough for ``max_frames_per_s`` over
  the window.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from benchmark.harness import sims

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"


def load(name):
    with open(TRAFFIC / f"{name}.json") as fh:
        return json.load(fh)


def stack(states):
    return {k: np.stack([s[k] for s in states]) for k in states[0]}


def quat_yaw(yaw):
    h = 0.5 * np.asarray(yaw, np.float64)
    z = np.zeros_like(h)
    return np.stack([np.cos(h), z, z, np.sin(h)], -1).astype(np.float32)


def lap(cfg_file, route, seed):
    """The lap's inputs: ``{"contacts": stacked contact states [L, C'],
    "q": orientations [L, 4] float32, "truth": true poses [L, 4] (x, y, z,
    yaw)}``."""
    height = sims.terrain(cfg_file["map"]["terrain"])
    sim = sims.TrajectorySim(height, speed=route["speed"],
                             yaw_rate=route["yaw_rate"],
                             seed=seed % (2 ** 63),
                             stance_steps=route.get("stance_steps", 0))
    cap = cfg_file["contacts"]["cap"]
    states, yaws, truth = [], [], []
    for _ in range(route["lap_steps"]):
        (pos, yaw), _ = sim.step()
        cs = sim.contact_state(noise=route["contact_noise"])
        states.append(sims.compact(cs, cap) if cap else cs)
        yaws.append(yaw)
        truth.append([pos[0], pos[1], pos[2], yaw])
    return {"contacts": stack(states), "q": quat_yaw(yaws),
            "truth": np.asarray(truth)}


def start_cloud(cfg_file, n, gen, device):
    """The start cloud from the seeded generator ``gen``: Gaussian xy and
    yaw about the configuration's ``init``, z and its sigma fixed, as
    ``PoseEstimator::init`` (``PoseEstimator.cpp:88-102``) draws it."""
    ini = cfg_file["init"]
    normal = torch.randn((3, n), generator=gen, device=device)
    f = dict(dtype=torch.float32, device=device)
    return {
        "x": ini["mu_xy"][0] + normal[0] * ini["sigma_xy"][0],
        "y": ini["mu_xy"][1] + normal[1] * ini["sigma_xy"][1],
        "yaw": ini["mu_yaw"] + normal[2] * ini["sigma_yaw"],
        "z": torch.full((n,), ini["z"], **f),
        "z_sigma": torch.full((n,), ini["z_sigma"], **f),
    }


def draws(steps, n, gen, device):
    """The random draws of ``steps`` steps of ``n`` particles, in a few
    large calls on the device: standard normals for the odometry noise and
    the spreading, uniforms for the slip test, the slip shrink and the
    resampling strata.  ``{field: [steps, n(, 2)]}``."""
    normal = lambda *s: torch.randn((steps, n) + s, generator=gen,
                                    device=device)
    uniform = lambda: torch.rand((steps, n), generator=gen, device=device)
    return {"delta_xy": normal(2), "delta_yaw": normal(),
            "spread_xy": normal(2), "spread_yaw": normal(),
            "slip": uniform(), "shrink": uniform(), "resample_u": uniform()}


def mount(laser):
    """The laser's mount on the body, ``(rot [3, 3], trans [3])`` in
    float64: turned by ``mount_yaw`` about the body's z, pitched down by
    ``mount_pitch``, at ``mount_xyz``."""
    cy, sy = np.cos(laser["mount_yaw"]), np.sin(laser["mount_yaw"])
    cp, sp = np.cos(laser["mount_pitch"]), np.sin(laser["mount_pitch"])
    yaw = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
    pitch = np.array([[cp, 0.0, sp], [0.0, 1.0, 0.0], [-sp, 0.0, cp]])
    return yaw @ pitch, np.asarray(laser["mount_xyz"], np.float64)


def laser_ranges(height, origins, rot, laser, device, batch=64):
    """The ranges ``[S, R]`` (float32, on the host) of a planar laser
    scan from each of ``origins [S, 3]`` (world), the scan plane turned by
    ``rot [3, 3]`` (laser to world): each ray marched in steps of
    ``cast_step`` m to ``cast_range`` m and its first crossing into the
    terrain ``height`` found by bisection; a ray with no crossing there
    reads ``max_range``, which the filter drops (it keeps ranges under its
    ``max_sensor_range``).  Cast on ``device`` in float64."""
    f = dict(dtype=torch.float64, device=device)
    ang = laser["start_angle"] + torch.arange(laser["rays"], **f) * laser[
        "resolution"]
    d = torch.stack([ang.cos(), ang.sin(), torch.zeros_like(ang)], -1)
    d = d @ torch.as_tensor(rot, **f).T                       # [R, 3]
    step = laser["cast_step"]
    r = torch.arange(1, int(round(laser["cast_range"] / step)) + 1, **f) * step
    out = []
    for lo in range(0, len(origins), batch):
        o = torch.as_tensor(origins[lo:lo + batch], **f)[:, None, :]

        def below(dist):                                      # [B, R, M]
            p = o[..., None, :] + dist[..., None] * d[None, :, None, :]
            return p[..., 2] <= height(p[..., 0], p[..., 1])

        under = below(r.expand(o.shape[0], len(d), len(r)))
        hit = under.any(-1)
        first = under.to(torch.int8).argmax(-1)
        a, b = first * step, (first + 1) * step               # above, below
        for _ in range(40):
            mid = 0.5 * (a + b)
            down = below(mid[..., None])[..., 0]
            a, b = torch.where(down, a, mid), torch.where(down, mid, b)
        out.append(torch.where(hit, 0.5 * (a + b),
                               torch.full_like(a, laser["max_range"])))
    return torch.cat(out).float().cpu().numpy()


def plain_draws(d, t, dtype=torch.float64):
    return {k: v[t].to(dtype) for k, v in d.items()}


def generator(seed, device):
    """The run's seeded generator on ``device`` (any whole seed)."""
    return torch.Generator(device).manual_seed(int(seed) % (2 ** 63))
