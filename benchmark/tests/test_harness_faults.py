"""The comparison that decides ``correct`` fails where it must: the
control (the reference computed in bfloat16, the precision below the
configuration's float32, put in the port's place) and the timed path
broken underneath the rest of a run, at a size a test run holds."""

import pytest
import torch

from benchmark.harness import common, drive_chunks, drive_frames, faults
from benchmark.tests.conftest import tiny_loc, tiny_slam


def correct(checks):
    return all(c["value"] <= c["limit"] for c in checks.values())


@pytest.fixture(scope="module")
def replay():
    # an ESS gate at every particle resamples every step, so that every
    # chunk's first step checks a resampling
    cfg_file, mix = tiny_loc(n=2048, chunk=20, min_effective=2048)
    r = drive_chunks.Replay(cfg_file, mix, torch.device("cpu"))
    r.setup(common.SetupClock())
    return r


def loc_window(r, seed):
    r.inputs(seed)
    return r.window(1.0)


@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102, 2**31 + 103])
def test_loc_control_is_not_correct(replay, seed):
    w = loc_window(replay, seed)
    assert correct(replay.check(w))
    assert not correct(replay.check(w, control=torch.bfloat16))


def centroids(state, steps):
    p = state.particles
    w = p.weight / p.weight.sum()
    c = torch.stack([(p.x * w).sum(), (p.y * w).sum(), (p.z * w).sum()])
    return c.expand(steps, 3).clone()


def test_loc_state_left_unchanged_is_not_correct(replay, monkeypatch):
    monkeypatch.setattr(replay, "runner", lambda state, cs, q, draws: (
        state, centroids(state, q.shape[0])))
    assert not correct(replay.check(loc_window(replay, 2**31 + 104)))


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_loc_fault_is_not_correct(replay, fault):
    """Half the batch in the centroid, every pose altered where it is
    produced, and a resampling that picks the wrong particles for the
    weights and draws each come out not correct."""
    with faults.planted(fault):
        w = loc_window(replay, 2**31 + 105)
    assert not correct(replay.check(w))


@pytest.fixture(scope="module")
def online():
    cfg_file, mix = tiny_slam(n=32, steps=200)
    cell = drive_frames.Online(cfg_file, mix, torch.device("cpu"))
    cell.setup(common.SetupClock(), 3.0)
    cell.inputs(2**31 + 200)
    cell.warm_up()
    return cell


def slam_window(cell, seed):
    cell.inputs(seed)
    return cell.window(4.0, expected_rate=120.0)


@pytest.mark.parametrize("seed", [2**31 + 201, 2**31 + 202, 2**31 + 203])
def test_slam_control_is_not_correct(online, seed):
    w = slam_window(online, seed)
    assert correct(online.check(w))
    assert not correct(online.check(w, control=torch.bfloat16))


def test_slam_state_left_unchanged_is_not_correct(online, monkeypatch):
    real = online.step

    def frozen(carry, frame, odo, draws):
        _, aux = real(carry, frame, odo, draws)
        return carry, aux

    monkeypatch.setattr(online, "step", frozen)
    assert not correct(online.check(slam_window(online, 2**31 + 204)))


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_slam_fault_is_not_correct(online, fault):
    with faults.planted(fault):
        w = slam_window(online, 2**31 + 205)
    assert not correct(online.check(w))
