"""The ordered scan S1 (``ops/ordered_scan.py``) on the CPU, where its plain
version runs, against the JAX package's cumulative sum.

The scan adds in the order of the JAX package's CPU cumsum (XLA's rewrite
of a prefix-sum reduce-window: rows of 16 summed in sequence, row totals
scanned by the same rule, each row's carry added last), so the plain
version equals ``jnp.cumsum`` bit for bit at every size, across the
one-CTA size (8,192) and into the kernel's recursive levels.  The
resampling search built on it then finds the JAX package's ancestors
exactly (the port searched a ``torch.cumsum`` before: up to +-1 at bracket
edges).  The kernel against this plain version on the card:
``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_eslam_tpu.core import filter as jpf
from slam_eslam_tpu_torch.core import filter as tpf
from slam_eslam_tpu_torch.core import gmm
from slam_eslam_tpu_torch.ops import ordered_scan as osc

SIZES = [1, 2, 15, 16, 17, 127, 129, 255, 256, 257, 4097, 8192, 8193,
         65537, 100_000, 140_000]


@pytest.mark.parametrize("n", SIZES)
def test_plain_version_equals_jax_cumsum(n):
    x = np.random.default_rng(n).gamma(0.3, size=n).astype(np.float32)
    got = osc.ordered_scan(torch.from_numpy(x)).numpy()
    ref = np.asarray(jnp.cumsum(jnp.asarray(x)))
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_scratch_levels():
    assert osc.scratch_size(osc.SMALL) == 0
    assert osc.scratch_size(osc.SMALL + 1) == -(-(osc.SMALL + 1) // 16)
    # 2,100,000 -> 131,250 row totals -> 8,204 -> 513 (one CTA)
    assert osc.scratch_size(2_100_000) == 131_250 + 8_204 + 513
    with pytest.raises(ValueError, match="1-D"):
        osc.ordered_scan(torch.zeros(2, 3))


def test_resample_search_equals_jax_exactly():
    """``core.filter.resample_from_positions`` searches the scan: every
    ancestor equals the JAX package's bisect over its own cumsum."""
    from slam_eslam_tpu_torch.tools import profile_resample

    w, pos = profile_resample.weights_and_positions(20_000, "cpu")
    ref = np.asarray(jpf._resample_from_positions(
        jnp.asarray(w.numpy()), jnp.asarray(pos.numpy()), method="bisect"))
    np.testing.assert_array_equal(tpf.resample_from_positions(w, pos).numpy(),
                                  ref)


def test_gmm_first_draw_searches_the_scan():
    rng = np.random.default_rng(4)
    xy = torch.from_numpy(rng.normal(size=(300, 2)).astype(np.float32))
    w = torch.from_numpy(rng.random(300).astype(np.float32))
    gen = torch.Generator().manual_seed(9)
    u = torch.rand((1,), generator=torch.Generator().manual_seed(9))
    first = int(torch.searchsorted(osc.ordered_scan(w / w.sum()), u))
    a = gmm.fit_gmm(xy, w, n_iters=2, generator=gen)
    b = gmm.fit_gmm(xy, w, n_iters=2, first=first)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
