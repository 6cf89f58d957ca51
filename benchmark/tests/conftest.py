"""Fixtures of the benchmark's CPU tests: tiny cells of the two drives."""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def tiny_loc(n=256, chunk=5, min_effective=None):
    from benchmark.harness import traffic

    cfg = json.loads((ROOT / "benchmark/configs/loc_100k.json").read_text())
    cfg["particles"] = n
    cfg["filter"]["particle_count"] = n
    cfg["filter"]["min_effective"] = (n // 5 if min_effective is None
                                      else min_effective)
    mix = copy.deepcopy(traffic.load("replay"))
    mix["chunk_steps"] = chunk
    return cfg, mix


def tiny_slam(n=32, steps=200):
    from benchmark.harness import traffic

    cfg = json.loads((ROOT / "benchmark/configs/slam_1k_f32.json")
                     .read_text())
    cfg["particles"] = cfg["filter"]["particle_count"] = n
    # resamplings often enough for a short window to check some
    cfg["min_effective"] = cfg["filter"]["min_effective"] = 3 * n // 4
    cfg["map_pool_blocks"] = cfg["filter"]["map_pool_blocks"] = 4 * n
    # grids of 5 m at the configuration's resolution, so that the CPU
    # holds the pool
    cfg["filter"]["grid_size"] = 5.0
    # the maps lie under the feet after 1.5 m, so that a short window
    # reaches measurement frames
    cfg["filter"]["max_sensor_range"] = 1.5
    # a sixth of the rays over the same field of view: the ray casting's
    # cost on the CPU
    cfg["laser"]["rays"] = 181
    cfg["laser"]["resolution"] *= 6
    mix = copy.deepcopy(traffic.load("online"))
    mix["route"]["min_steps"] = steps
    mix["route"]["max_frames_per_s"] = 0
    mix["checked_particles"] = min(n, 16)
    return cfg, mix


@pytest.fixture(autouse=True, scope="session")
def one_thread():
    """The tiny cells run the port's eager loop: one thread a test worker
    keeps workers from crowding each other's windows."""
    import torch

    torch.set_num_threads(1)


@pytest.fixture
def cpu():
    import torch

    return torch.device("cpu")
