"""The ``slam_chunks`` drive at a size a test run holds: the rerun
through the same runner gives the window's poses bit for bit and its
checked frames are correct; the control (the reference in bfloat16 in
the port's place) is not, nor is a runner whose chunks hand on their
carry unchanged."""

import copy

import pytest
import torch

from benchmark.harness import common, drive_slam_chunks, traffic
from benchmark.tests.conftest import tiny_slam


def correct(checks):
    return all(c["value"] <= c["limit"] for c in checks.values())


@pytest.fixture(scope="module")
def replay():
    cfg_file, _ = tiny_slam(n=32, steps=200)
    mix = copy.deepcopy(traffic.load("slam_replay"))
    mix["route"]["min_steps"] = 300
    mix["route"]["max_frames_per_s"] = 0
    mix["chunk_frames"] = 20
    mix["checked_particles"] = 16
    cell = drive_slam_chunks.SlamReplay(cfg_file, mix, torch.device("cpu"))
    cell.setup(common.SetupClock(), 3.0)
    cell.inputs(2**31 + 400)
    cell.warm_up()
    return cell


def window(cell, seed):
    cell.inputs(seed)
    return cell.window(3.0, expected_rate=120.0)


@pytest.mark.parametrize("seed", [2**31 + 401, 2**31 + 402])
def test_chunk_check_and_its_control(replay, seed):
    w = window(replay, seed)
    checks = replay.check(w)
    assert correct(checks), checks
    assert checks["replayed_frames_differ"]["value"] == 0
    assert len(w["snaps"]) >= 8
    assert not correct(replay.check(w, control=torch.bfloat16))


def test_carry_left_unchanged_is_not_correct(replay, monkeypatch):
    real = replay.runner

    def frozen(carry, frames, odos, draws):
        _, aux = real(carry, frames, odos, draws)
        return carry, aux

    monkeypatch.setattr(replay, "runner", frozen)
    assert not correct(replay.check(window(replay, 2**31 + 403)))
