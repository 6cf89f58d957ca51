"""The roofline arithmetic of the benchmark against hand counts at small
shapes."""

import torch

from benchmark.roofline import fold, merge


def small_grid():
    # 3 x 2 cells of 0.5 m from the origin, K = 2; cell (1, 0) empty
    mean = torch.zeros(3, 2, 2)
    valid = torch.zeros(3, 2, 2, dtype=torch.bool)
    valid[..., 0] = True
    valid[1, 0, 0] = False
    mean[2, 1, 1], valid[2, 1, 1] = 5.0, True
    return {"mean": mean, "stdev": torch.full((3, 2, 2), 0.1),
            "valid": valid, "origin": [0.0, 0.0], "resolution": 0.5}


def test_fold_work_matches_a_hand_count():
    g = small_grid()
    # 2 particles x 4 rows: groups [0, 0, 1, 2]; row 3 inactive
    x = torch.tensor([[0.1, 0.2], [0.6, 0.7], [1.2, 9.0], [0.1, 0.1]])
    y = torch.tensor([[0.1, 0.2], [0.1, 0.2], [0.6, 0.6], [0.1, 0.1]])
    z = torch.tensor([[0.0, 0.0], [0.0, 0.0], [-5.0, 0.0], [0.0, 0.0]])
    active = torch.tensor([True, True, True, False])
    group = torch.tensor([0, 0, 1, 2])
    work = fold.fold_work(g, (x, y, z), active, torch.full((2,), 0.01),
                          group, 0.33, 3.0)
    # active rows: 3 a particle; inside: particle 1's third query is off
    # the grid; found: cell (1, 0) is empty for both, the z of particle
    # 0's third query (-5) misses every slot by more than 3 m
    assert work["rows"] == 8 and work["particles"] == 2
    assert work["active"] == 6 and work["inside"] == 5
    assert work["found"] == 2
    # u = z / (sqrt(0.01 + 0.01) * 0.33) = 0 >= -3 for both: no tail
    assert work["head"] == 2 and work["tail"] == 0
    assert work["groups"] == 6
    # group 0: one member missed in both particles; group 1: particle 0
    # missed, particle 1 off the grid; group 2 has no active member
    assert work["valid_groups"] == 0
    # distinct cells inside: (0,0), (1,0) of both particles, (2,1)
    assert work["touched"] == 3
    assert fold.needed_bytes(work, 4, 2, 2) == (3 * 8 + 2 + 16) * 4 + 3 * 16
    costs = fold.fold_costs(2)
    assert fold.needed_instructions(work, 2) == sum(
        costs[k] * work[k] for k in costs)


def test_fold_bound_is_the_larger_side():
    work = {"particles": 1, "rows": 1, "active": 1, "inside": 1,
            "found": 1, "head": 1, "tail": 0, "groups": 1,
            "valid_groups": 1, "touched": 10 ** 9}
    t, by = fold.bound_seconds(work, 1, 1, 4)
    assert by == "bytes"
    assert abs(t - fold.needed_bytes(work, 1, 1, 4)
               / fold.PEAKS["hbm_bytes_per_s"]) < 1e-15


def test_merge_touched_cells_and_bytes():
    # two particles on a 4 x 4 grid of 1 m: particle 0's three points fall
    # in two cells, particle 1's second point leaves the grid
    pts = torch.tensor([[0.2, 0.2], [0.4, 0.3], [1.5, 0.5]])
    valid = torch.tensor([True, True, True])
    x = torch.tensor([0.0, 2.5])
    y = torch.tensor([0.0, 0.0])
    yaw = torch.zeros(2)
    origin = torch.zeros(2, 2)
    cells = merge.touched_cells(x, y, yaw, origin, pts, valid, 1.0, 4, 4)
    # particle 0: (0, 0) twice and (1, 0); particle 1: x = 2.7 and 2.9
    # in cell 2, x = 4.0 off the grid
    assert cells == 3
    assert merge.needed_bytes(2, 3, cells, 4, 4) == (
        2 * 4 + 4 * 2 * 3 * 4 + 2 * 3 * 4 * 16)
