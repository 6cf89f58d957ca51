"""The benchmark's copies of the traffic generators against the port's
simulators at the same seed."""

import numpy as np
import pytest
import torch

from benchmark.harness import sims, traffic


def test_terrain_grid_matches_the_ports():
    from slam_eslam_tpu_torch.models import sim

    h = sims.terrain("sine")
    mine = sims.terrain_grid(h, 40, 30, 0.05, (-1.0, -0.5), 0.02, 4)
    ports = sim.terrain_grid(h, 40, 30, 0.05, (-1.0, -0.5), 0.02, 4)
    assert np.array_equal(mine["mean"], ports.mean.numpy())
    assert np.array_equal(mine["stdev"], ports.stdev.numpy())
    assert np.array_equal(mine["valid"], ports.valid.numpy())


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_trajectory_and_contacts_match_the_ports(seed):
    from slam_eslam_tpu_torch.models import sim

    h = sims.terrain("sine")
    a = sims.TrajectorySim(h, speed=0.05, yaw_rate=0.0125, seed=seed)
    b = sim.TrajectorySim(h, speed=0.05, yaw_rate=0.0125, seed=seed)
    for _ in range(30):
        (pa, ya), _ = a.step()
        (pb, yb), _ = b.step()
        assert np.array_equal(pa, pb) and ya == yb
        ca, cb = a.contact_state(noise=0.005), b.contact_state(noise=0.005)
        assert np.array_equal(ca["position"], cb.position.numpy())
        assert np.array_equal(ca["contact"], cb.contact.numpy())
        assert np.array_equal(ca["group_id"], cb.group_id.numpy())
        ka, kb = sims.compact(ca, 8), cb.compact(8)
        assert np.array_equal(ka["position"], kb.position.numpy())
        assert np.array_equal(ka["contact"], kb.contact.numpy())


def test_asguard_matches_the_ports():
    from slam_eslam_tpu_torch.models.asguard import AsguardSim

    h = sims.terrain("sine_slam")
    a, b = sims.AsguardSim(height=h), AsguardSim(terrain=h)
    seen_a, seen_b = [], []
    for _ in range(12):
        a.step(wheel_delta=0.3, on_substep=lambda s: seen_a.append(
            (s.position.copy(), s.contact_state())))
        b.step(wheel_delta=0.3, on_substep=lambda s: seen_b.append(
            (s.position.copy(), s.contact_state())))
    for (pa, ca), (pb, cb) in zip(seen_a, seen_b):
        assert np.array_equal(pa, pb)
        assert np.array_equal(ca["position"], cb.position.numpy())
        assert np.array_equal(ca["contact"], cb.contact.numpy())


def test_footholds_stay_in_the_world_while_in_stance():
    """With ``stance_steps`` the stance feet move backwards in the body
    frame by the step, and a touching-down foot is active for the contact
    model but below the odometry's threshold."""
    h = sims.terrain("sine")
    sim = sims.TrajectorySim(h, speed=0.05, stance_steps=4)
    prev = None
    for _ in range(12):
        (pos, yaw), _ = sim.step()
        cs = sim.contact_state()
        stance = cs["position"][::5]
        world = stance[:, :2] @ np.array(
            [[np.cos(yaw), np.sin(yaw)], [-np.sin(yaw), np.cos(yaw)]]) + pos[:2]
        held = cs["contact"][::5] > 0.5
        if prev is not None:
            both = held & prev[1]
            assert both.any()
            assert np.allclose(world[both], prev[0][both], atol=1e-5)
        assert ((cs["contact"][::5] == 1.0)
                | (cs["contact"][::5] == sims.TOUCHDOWN)).all()
        prev = (world, held)


def test_lap_and_draws_repeat_from_the_seed(cpu):
    from benchmark.tests.conftest import tiny_loc

    cfg, mix = tiny_loc()
    a = traffic.lap(cfg, mix["route"], 11)
    b = traffic.lap(cfg, mix["route"], 11)
    c = traffic.lap(cfg, mix["route"], 12)
    assert all(np.array_equal(a["contacts"][k], b["contacts"][k])
               for k in a["contacts"])
    assert not np.array_equal(a["contacts"]["position"],
                              c["contacts"]["position"])
    assert a["contacts"]["position"].shape == c["contacts"]["position"].shape
    da = traffic.draws(3, 16, traffic.generator(2**31 + 9, cpu), cpu)
    db = traffic.draws(3, 16, traffic.generator(2**31 + 9, cpu), cpu)
    assert all(torch.equal(da[k], db[k]) for k in da)


def test_laser_ranges_end_on_the_terrain():
    """Each ray that returns ends on the terrain; a ray with no crossing
    within the cast range reads the sensor's maximum."""
    laser = {"rays": 91, "start_angle": -2.356194490192345,
             "resolution": 0.05235987755982988, "max_range": 30.0,
             "mount_xyz": [0.0, 0.3, 0.15], "mount_yaw": 1.5707963267948966,
             "mount_pitch": 0.35, "cast_range": 4.0, "cast_step": 0.02}
    h = sims.terrain("sine_slam")
    sim = sims.AsguardSim(height=h)
    rot, trans = traffic.mount(laser)
    origins = np.stack([sim.position + trans, sim.position + trans
                        + np.array([0.4, 1.0, 0.0])])
    ranges = traffic.laser_ranges(h, origins, rot, laser, torch.device("cpu"))
    ang = laser["start_angle"] + np.arange(laser["rays"]) * laser["resolution"]
    d = np.stack([np.cos(ang), np.sin(ang), 0 * ang], -1) @ rot.T
    hit = ranges < laser["cast_range"]
    assert hit.sum() > laser["rays"] // 3 and (ranges[~hit] == 30.0).all()
    for o, r, k in zip(origins, ranges, hit):
        p = o + r[k, None] * d[k]
        assert np.abs(p[:, 2] - h(p[:, 0], p[:, 1])).max() < 1e-5


def test_odometry_frames_match_a_roll_and_the_port():
    """The odometry of every frame worked out at once equals the
    reference's rolled frame by frame and the port's
    ``precompute_odometry`` over the same contact stream."""
    from slam_eslam_tpu_torch.filter import streaming
    from benchmark.harness import port
    from benchmark.reference import localization as ref
    from benchmark.tests.conftest import tiny_slam

    cfg_file, _ = tiny_slam()
    sim = sims.AsguardSim(height=sims.terrain("sine_slam"))
    states = []
    for _ in range(12):
        sim.step(wheel_delta=0.3, substeps=10,
                 on_substep=lambda s: states.append(s.contact_state()))
    full = traffic.stack(states)
    q = np.tile(np.array([1.0, 0.0, 0.0, 0.0], np.float32), (len(states), 1))
    ocfg = cfg_file["odometry"]
    cpu = torch.device("cpu")
    at_once = ref.odometry_frames(
        port.plain_contacts(full, slice(None), cpu),
        torch.from_numpy(q).double(), ocfg)
    c = cfg_file["contacts"]["candidates"]
    odo = {"prev_points": torch.zeros(c, 3, dtype=torch.float64),
           "prev_contact": torch.zeros(c, dtype=torch.float64),
           "prev_valid": torch.zeros(c, dtype=torch.bool),
           "prev_orientation": torch.tensor([1.0, 0, 0, 0],
                                            dtype=torch.float64),
           "initialized": torch.tensor(False)}
    ports = streaming.precompute_odometry(
        c, port.contact_states(full, cpu), torch.from_numpy(q),
        cfg=port.config(cfg_file))
    moved = 0
    for t in range(len(states)):
        odo = ref.odometry(odo, port.plain_contacts(full, t, cpu),
                           torch.from_numpy(q[t]).double(), ocfg)
        for k in ("delta_xy", "delta_yaw", "delta_z", "sigma_xy",
                  "sigma_yaw", "sigma_z"):
            assert torch.allclose(at_once[k][t], odo[k], atol=1e-12)
            assert torch.allclose(getattr(ports, k)[t].double(), odo[k],
                                  atol=1e-6)
        moved += float(odo["delta_xy"].abs().max()) > 1e-4
    assert moved > len(states) // 2


def test_asguard_roll_equals_its_steps():
    """The straight roll at once gives every substep's body position and
    contact state that ``step`` gives one substep at a time."""
    h = sims.terrain("sine_slam")
    a, b = sims.AsguardSim(height=h), sims.AsguardSim(height=h)
    seen = []
    for _ in range(25):
        a.step(wheel_delta=0.3, substeps=10, on_substep=lambda s: seen.append(
            (s.position.copy(), s.contact_state())))
    pos, states = b.roll(25, wheel_delta=0.3, substeps=10)
    assert len(seen) == len(pos)
    for t, (p, cs) in enumerate(seen):
        assert np.allclose(pos[t], p, atol=1e-12)
        for k in cs:
            assert np.array_equal(states[k][t], cs[k])
        one = sims.compact(cs, 8)
        many = sims.compact({k: v[t:t + 1] for k, v in states.items()}, 8)
        assert all(np.array_equal(many[k][0], one[k]) for k in one)
    assert np.allclose(a.position, b.position, atol=1e-12)
