"""``utils.scatter.add_at``: the port's one float scatter-add adds each
index's values in index order, the same on every call.  On the CPU a
large ``index_put_(accumulate=True)`` is split over threads that race,
so these run with several threads and above the split; the sums must
repeat bit for bit and equal a serial loop (``np.add.at``, which adds
unbuffered in index order, as the JAX package's CPU ``.at[].add``
does).  ``mls_grid.run_sums_rows`` and ``contact_model._segment_sum``
sum through it."""

import numpy as np
import pytest
import torch

from slam_eslam_tpu_torch.mapping import mls_grid
from slam_eslam_tpu_torch.models import contact_model as cm
from slam_eslam_tpu_torch.utils.scatter import add_at

ENTRIES = 200_000
CALLS = 20


@pytest.fixture
def threads():
    """Several intra-op threads for the test (restored after)."""
    before = torch.get_num_threads()
    torch.set_num_threads(max(4, before))
    assert torch.get_num_threads() > 1
    yield torch.get_num_threads()
    torch.set_num_threads(before)


def case(seed, trail=(), slots=500):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, slots, ENTRIES)
    values = rng.standard_normal((ENTRIES,) + trail).astype(np.float32)
    values *= rng.choice(np.float32([1e-4, 1.0, 1e4]), (ENTRIES,) + trail)
    return idx, values, np.zeros((slots,) + trail, np.float32)


@pytest.mark.parametrize("trail", [(), (3,), (3, 3)],
                         ids=["scalar", "vector", "matrix"])
def test_add_at_repeats_bit_for_bit(threads, trail):
    idx, values, zeros = case(1, trail)
    idx_t, values_t = torch.from_numpy(idx), torch.from_numpy(values)
    first = add_at(torch.from_numpy(zeros.copy()), idx_t, values_t)
    for _ in range(CALLS - 1):
        again = add_at(torch.from_numpy(zeros.copy()), idx_t, values_t)
        assert torch.equal(again.view(torch.int32), first.view(torch.int32))


@pytest.mark.parametrize("trail", [(), (3, 3)], ids=["scalar", "matrix"])
def test_add_at_equals_a_serial_loop(threads, trail):
    idx, values, zeros = case(2, trail)
    serial = zeros.copy()
    np.add.at(serial, idx, values)
    got = add_at(torch.from_numpy(zeros.copy()), torch.from_numpy(idx),
                 torch.from_numpy(values))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  serial.view(np.int32))


def test_add_at_adds_into_the_target_in_place():
    target = torch.arange(4, dtype=torch.float32)
    out = add_at(target, torch.tensor([3, 0, 3]),
                 torch.tensor([1.0, 2.0, 4.0]))
    assert out is target
    assert target.tolist() == [2.0, 1.0, 2.0, 8.0]


def test_run_sums_rows_repeats_above_the_split(threads):
    n, p = 400, 512                    # N * P = 204,800 entries
    rng = np.random.default_rng(3)
    lin = torch.from_numpy(rng.integers(0, 40, (n, p)))
    w = torch.from_numpy(rng.uniform(0.1, 1e3, (n, p)).astype(np.float32))
    wz = w * torch.from_numpy(rng.standard_normal((n, p)).astype(np.float32))
    color = torch.from_numpy(rng.uniform(0, 1, (n, p, 3)).astype(np.float32))
    first = mls_grid.run_sums_rows(lin, w, wz, color)
    for _ in range(CALLS - 1):
        again = mls_grid.run_sums_rows(lin, w, wz, color)
        for a, b in zip(again, first, strict=True):
            assert torch.equal(a, b)
    # each run's sums are the serial sums of its entries in point order
    lin_s, order, first_mark, wsum, _, _ = first
    w_s = torch.gather(w, 1, order).numpy()
    seg = np.cumsum(first_mark.numpy(), axis=1) - 1
    for row in range(0, n, 97):
        serial = np.zeros(p, np.float32)
        np.add.at(serial, seg[row], w_s[row])
        np.testing.assert_array_equal(wsum[row].numpy(), serial[seg[row]])


def test_segment_sum_repeats_and_equals_a_serial_loop(threads):
    idx, values, _ = case(4, slots=300)
    seg = torch.from_numpy(idx.astype(np.int32))
    first = cm._segment_sum(torch.from_numpy(values), seg, 300)
    for _ in range(CALLS - 1):
        assert torch.equal(cm._segment_sum(torch.from_numpy(values), seg,
                                           300), first)
    serial = np.zeros(300, np.float32)
    np.add.at(serial, idx, values)
    np.testing.assert_array_equal(first.numpy(), serial)
