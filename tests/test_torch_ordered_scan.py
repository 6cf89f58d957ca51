"""The ordered scan S1 (``ops/ordered_scan.py``) on the CPU, where its plain
version runs, against the JAX package's cumulative sum.

The scan adds in the order of the JAX package's CPU cumsum (XLA's rewrite
of a prefix-sum reduce-window: rows of 16 summed in sequence, row totals
scanned by the same rule, each row's carry added last, row 0's carry and
a short scan's start ``+0.0``), so the plain version equals ``jnp.cumsum``
bit for bit at every size, signed zeros included.  The resampling search
built on it then finds the JAX package's ancestors exactly (the port
searched a ``torch.cumsum`` before: up to +-1 at bracket edges).

``one_pass_model`` mirrors what the one-launch kernel
(``csrc/ordered_scan.cu``) computes: tiles of 4,096 elements, the three
sums each tile publishes (its total f, its level-2 partial p at position
14 and its last level-2 element e) and the carries a tile assembles from
its predecessors' records.  It is held to ``jnp.cumsum`` at the level and
tile boundaries; the shortcut of scanning each tile alone and adding the
scanned tile totals is shown not to be.  The kernel against the plain
version on the card: ``tests/test_torch_cuda.py``.
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
# the level and tile boundaries of the one-pass kernel, and a size with
# more than 16 tiles per level above the tile (273 tiles: two levels)
MODEL_SIZES = [16, 17, 256, 257, 4095, 4096, 4097, 8193, 65_536, 65_537,
               100_000, 140_000, 16 * 4096 * 17 + 3]

ROW = osc.ROW
TILE = osc.TILE
F32 = np.float32
PLUS, MINUS = F32(0.0), F32(-0.0)


def bits(a):
    return np.asarray(a, F32).view(np.int32)


def jax_cumsum(x):
    return np.asarray(jnp.cumsum(jnp.asarray(x)))


def running(a):
    """Sums in sequence along the last axis (elementwise IEEE adds)."""
    out = a.copy()
    for j in range(1, a.shape[-1]):
        out[..., j] = out[..., j - 1] + a[..., j]
    return out


def level_prefix(vals, m, k):
    """Element ``k`` of the ordered scan of a level of ``m`` values, of
    which ``vals`` holds the first ``k + 1`` or more: ``+0.0`` for k < 0.
    What a tile's look-back evaluates over the published totals."""
    if k < 0:
        return PLUS
    if m <= ROW:
        return running(np.concatenate([[PLUS], vals[:k + 1]]).astype(F32))[-1]
    r, j = divmod(k, ROW)
    loc = running(vals[ROW * r:ROW * r + j + 1])[-1]
    totals = running(vals[:ROW * r].reshape(r, ROW))[:, -1]
    return F32(loc + level_prefix(totals, -(-m // ROW), r - 1))


def tile_sums(x):
    """The tiles' sums in sequence: level 0 (rows of 16 elements), level 1
    (rows of 16 row totals) and level 2 (the 16 level-1 totals), each
    ``[tiles, ...]``, and the level-2 inputs."""
    n, t = x.shape[0], osc.tiles(x.shape[0])
    pad = np.zeros(t * TILE, F32)
    pad[:n] = x
    loc0 = running(pad.reshape(t, TILE // ROW, ROW))
    loc1 = running(loc0[..., -1].reshape(t, ROW, ROW))
    return loc0, loc1, running(loc1[..., -1]), loc1[..., -1]


def one_pass_model(x):
    """The one-launch kernel's arithmetic on the CPU (numpy float32)."""
    n, t = x.shape[0], osc.tiles(x.shape[0])
    loc0, loc1, loc2, t2 = tile_sums(x)
    # the records: total f, partial p at position 14, last level-2 input e
    f, p, e = loc2[:, -1], loc2[:, -2], t2[:, -1]
    y = np.empty_like(loc0)
    for c in range(t):
        if c == 0:
            carry2, carry1, carry0 = PLUS, PLUS, MINUS if n == 1 else PLUS
        else:
            before = level_prefix(f, t, c - 1)
            second = level_prefix(f, t, c - 2)
            carry2 = before
            carry1 = F32(f[c - 1] + second)
            carry0 = F32(e[c - 1] + F32(p[c - 1] + second))
        rows1 = np.concatenate([[carry1], loc2[c, :-1] + carry2]).astype(F32)
        tot1 = (loc1[c] + rows1[:, None]).reshape(-1)
        rows0 = np.concatenate([[carry0], tot1[:-1]]).astype(F32)
        y[c] = loc0[c] + rows0[:, None]
    return y.reshape(-1)[:n]


def shortcut_model(x):
    """Each tile scanned alone, plus the scanned tile totals before it."""
    n, t = x.shape[0], osc.tiles(x.shape[0])
    f = tile_sums(x)[2][:, -1]
    out = []
    for c in range(t):
        alone = osc.ordered_scan_reference(
            torch.from_numpy(x[c * TILE:(c + 1) * TILE])).numpy()
        out.append(alone + (level_prefix(f, t, c - 1) if c else PLUS))
    return np.concatenate(out)


def signed_weights(n, kind):
    """Weights with signed zeros in row 0 and in every tile's first row;
    ``tile`` also zeroes the whole first tile (negative zeros), so that
    zero totals travel through every level's carry."""
    rng = np.random.default_rng(n)
    x = rng.gamma(0.3, size=n).astype(F32)
    x[rng.random(n) < 0.05] = 0.0
    x[rng.random(n) < 0.05] = -0.0
    for start in range(0, n, TILE):
        row = x[start:start + ROW]
        row[:] = np.where(np.arange(row.shape[0]) % 3 == 1, PLUS, MINUS)
        row[-1:] = rng.gamma(0.3, size=row[-1:].shape)
    if kind == "tile":
        x[:TILE] = -0.0
    return x


@pytest.mark.parametrize("n", SIZES)
def test_plain_version_equals_jax_cumsum(n):
    x = np.random.default_rng(n).gamma(0.3, size=n).astype(np.float32)
    got = osc.ordered_scan(torch.from_numpy(x)).numpy()
    ref = np.asarray(jnp.cumsum(jnp.asarray(x)))
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("kind", ["rows", "tile"])
@pytest.mark.parametrize("n", MODEL_SIZES)
def test_one_pass_model_equals_jax_cumsum(n, kind):
    """The kernel's tiles, records and carries give ``jnp.cumsum`` and
    the plain version bit for bit, signed zeros included."""
    x = signed_weights(n, kind)
    ref = bits(jax_cumsum(x))
    np.testing.assert_array_equal(bits(one_pass_model(x)), ref)
    np.testing.assert_array_equal(
        bits(osc.ordered_scan_reference(torch.from_numpy(x)).numpy()), ref)


@pytest.mark.parametrize("n", [2, 15, 16, 17, 300])
def test_plain_version_signed_zeros(n):
    """All zeros, negative: the JAX package returns ``+0.0`` from two
    elements on, ``-0.0`` for one."""
    x = np.full(n, -0.0, F32)
    got = osc.ordered_scan_reference(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(bits(got), bits(jax_cumsum(x)))
    assert not np.signbit(got).any()
    one = osc.ordered_scan_reference(torch.tensor([-0.0])).numpy()
    assert np.signbit(one).all() and np.signbit(jax_cumsum(one)).all()


@pytest.mark.parametrize("n", [8193, 100_000])
def test_shortcut_is_not_the_order(n):
    """Scanning each tile alone and adding the scanned totals before it
    misses the carry a tile's first row takes from its predecessor's last
    level-2 element: not bit for bit."""
    x = np.random.default_rng(n).gamma(0.3, size=n).astype(F32)
    differ = int((bits(shortcut_model(x)) != bits(jax_cumsum(x))).sum())
    assert differ > n // 10
    np.testing.assert_array_equal(bits(one_pass_model(x)),
                                  bits(jax_cumsum(x)))


def test_scratch_levels():
    """The state a launch uses: none for one tile, else the generation
    and ticket word, the count of tagged records and three words a
    tile."""
    assert osc.tiles(1) == osc.tiles(TILE) == 1
    assert osc.state_words(TILE) == 0
    assert osc.state_words(TILE + 1) == osc.STATE_HEADER + 2 * osc.RECORD
    # 100,000 -> 25 tiles; 2,100,000 -> 513
    assert osc.state_words(100_000) == 2 + 3 * 25
    assert osc.state_words(2_100_000) == 2 + 3 * 513
    assert osc.tiles(osc.MAX_N) == osc.MAX_TILES
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
