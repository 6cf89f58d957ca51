"""The port's kernel and pool benches (``slam_eslam_tpu_torch.tools.
bench_kernels``, ``probe_chain_parity``, ``bench_pool_ops``) and the
surface-hash bench (``bench_surface_hash``) on the CPU at a tiny size,
against the JAX package.

``bench_kernels``: the plain select (K5's plain version) equals the JAX
``get_patch_packed`` (jitted, as the script runs it) on the JAX script's
queries, bit for bit on ``found``, ``mean`` and ``stdev`` (both compute
cells as ``floor((x - origin) * f32(1/res))``).  ``probe_chain_parity``:
its operands are the JAX script's, drawn in the same order from the same
generator, and its plain chain walk equals the JAX
``make_chain_lookup(kernel="xla")`` on them (``found`` equal, mean and
stdev within 1e-6).  ``bench_pool_ops``: one iteration of every
formulation on the same inputs as the JAX script's formulation; gathered
values within rtol 1e-6, scattered entries compared where exactly one
index writes them (duplicates have no defined winner in either package).
``bench_surface_hash``: ``n_valid_candidates`` and the bucket counts of
``SurfaceHash.create`` equal the JAX package's at ``--grid-cells 40
--angles 4``, and the JSON line has the JAX script's keys.
"""

import contextlib
import io
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_eslam_tpu_torch.bench import filter_terrain
from slam_eslam_tpu_torch.mapping import mls_grid
from slam_eslam_tpu_torch.models import sim as tsim
from slam_eslam_tpu_torch.ops import select_cells as sc
from slam_eslam_tpu_torch.tools import (bench_kernels, bench_pool_ops,
                                        bench_surface_hash,
                                        probe_chain_parity)

from torch_jax_draws import jax_tool

torch.set_num_threads(2)


# ------------------------------------------------------------ bench_kernels

def test_plain_select_equals_the_jax_gather_bit_for_bit():
    from slam_eslam_tpu.mapping import mls_grid as jmls
    from slam_eslam_tpu.models import sim as jsim

    q = 50_000
    # the JAX script's queries (bench_kernels.py:92-101)
    pts = jnp.concatenate([
        jax.random.uniform(jax.random.PRNGKey(0), (q, 2), minval=-1.5,
                           maxval=1.5),
        jax.random.uniform(jax.random.PRNGKey(1), (q, 1), minval=-0.5,
                           maxval=0.5)], axis=1)
    jgrid = jsim.terrain_grid(bench_kernels.terrain, **bench_kernels.GRID)
    jpacked = jmls.PackedLookup.from_grid(jgrid)
    ref = jax.jit(lambda p: jmls.get_patch_packed(jpacked, p))(pts)

    grid = tsim.terrain_grid(bench_kernels.terrain, **bench_kernels.GRID)
    np.testing.assert_array_equal(
        grid.mean.numpy(), np.asarray(jgrid.mean))
    packed = mls_grid.PackedLookup.from_grid(grid)
    p = torch.from_numpy(np.array(pts))
    got = sc.select_cells_reference(
        packed, tuple(p[:, j].contiguous() for j in range(3)),
        bench_kernels.Z_WINDOW)
    for a, b in zip(got, ref[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # every query lies within the 3 m window of its cell's one patch
    assert bool(got[0].all())


def test_bench_kernels_prints_one_select_row(capsys):
    res = bench_kernels.main(["--cpu", "--queries", "4000", "--particles",
                              "500"])
    out = capsys.readouterr().out
    assert res["select"]["equal"] and res["select"]["ms"] > 0
    assert out.count("select_cells (K5)") == 1
    assert "bit for bit" in out and "speedup x" in out
    assert out.count("has no counterpart on this card") == 1
    for row in ("lookup/gather", "resample"):
        assert row in out
    # 21 bytes a query and the touched rows, at the card's rate by default
    assert res["select"]["bytes"] > 4000 * 21
    assert res["select"]["bound_ms"] == pytest.approx(
        res["select"]["bytes"] / 3350e9 * 1e3)
    assert "--hbm-gbps" in bench_kernels.parser().format_help()


# ------------------------------------------------------- probe_chain_parity

def jax_operands(n, c):
    """``tools/probe_chain_parity.py:25-51``, in its order."""
    b, nx, ny, k, l, steps = n + 64, 40, 40, 4, 3, 50
    rng = np.random.default_rng(0)
    mean = rng.normal(size=(b, nx, ny * k)).astype(np.float32)
    stdev = (0.01 + 0.2 * rng.random((b, nx, ny * k))).astype(np.float32)
    meta = ((rng.random((b, nx, ny * k)) < 0.5).astype(np.int32)) | 2
    origin = (rng.normal(size=(b, 2)) * 2).astype(np.float32)
    chain = np.where(rng.random((n, l)) < 0.8,
                     rng.integers(0, b, size=(n, l)), -1).astype(np.int32)
    pts = rng.normal(size=(steps, n, c, 3)).astype(np.float32) * 3.0
    return dict(mean=mean, stdev=stdev, meta=meta, origin=origin,
                chain=chain, pts=pts)


def test_chain_parity_operands_and_plain_walk_match_jax():
    from slam_eslam_tpu.mapping import map_pool as jmp

    n, c = 96, 4
    ref = jax_operands(n, c)
    got = probe_chain_parity.operands(n, c)
    names = ("mean", "stdev", "height", "meta", "origin", "chain", "pts")
    for name, arr in zip(names, got):
        if name == "height":
            assert not arr.any()
            continue
        np.testing.assert_array_equal(arr, ref[name], err_msg=name)

    zeros = jnp.zeros(ref["mean"].shape)
    jpool = jmp.MapPool(
        mean=jnp.asarray(ref["mean"]), stdev=jnp.asarray(ref["stdev"]),
        height=zeros, meta=jnp.asarray(ref["meta"]), color=None,
        origin=jnp.asarray(ref["origin"]),
        allocated=jnp.ones((n + 64,), bool), chain=jnp.asarray(ref["chain"]),
        resolution=0.25, nx=40, ny=40, k=4)
    lk = jmp.make_chain_lookup(jpool, 3.0, kernel="xla")
    f0, m0, s0, _ = jax.vmap(lk)(jnp.arange(n), jnp.asarray(ref["pts"][0]))

    pool = probe_chain_parity.make_pool(got, "cpu")
    q = torch.from_numpy(got[-1][0])
    f1, m1, s1 = probe_chain_parity.plain_walk(
        pool, torch.arange(n, dtype=torch.int32),
        tuple(q[..., j].contiguous() for j in range(3)))
    f0 = np.asarray(f0)
    np.testing.assert_array_equal(f1.numpy(), f0)
    np.testing.assert_allclose(np.where(f0, m1.numpy(), 0),
                               np.where(f0, np.asarray(m0), 0), atol=1e-6)
    np.testing.assert_allclose(np.where(f0, s1.numpy(), 0),
                               np.where(f0, np.asarray(s0), 0), atol=1e-6)
    assert 0 < f0.sum() < f0.size


def test_probe_chain_parity_prints_parity_and_rows(capsys):
    res = probe_chain_parity.main(["40", "3", "--cpu"])
    out = capsys.readouterr().out
    assert res["found_equal"] and res["max_dmean"] == res["max_dstdev"] == 0
    assert "parity: found " in out and "equal=True" in out
    assert "max|dmean|=0.00e+00 max|dstdev|=0.00e+00" in out
    for row in ("plain", "kernel (K2)"):
        assert res[row]["ms_per_frame"] > 0
        assert f"{row}: " in out and "M queries/s" in out
    # the defaults are the JAX script's
    args = probe_chain_parity.parser().parse_args([])
    assert (args.n, args.c, args.cpu) == (4096, 8, False)


# ------------------------------------------------------------ bench_pool_ops

def jax_formulations(blk, cell, vals, k, nf):
    """``tools/bench_pool_ops.py:80-151``: one iteration of each."""
    blk, cell, vals = jnp.asarray(blk), jnp.asarray(cell), jnp.asarray(vals)
    idx = cell[:, None] * k + jnp.arange(k)
    idx_c = cell[:, None] * (k * nf) + jnp.arange(k * nf)

    def a_gather(*fs):
        out = [f + 0.0 for f in fs]
        acc = 0.0
        for f in fs:
            acc = acc + f[blk[:, None], idx]
        out[0] = out[0].at[blk[:, None], idx].add(acc * 1e-9)
        return tuple(out)

    def a_scatter(*fs):
        return tuple(f.at[blk[:, None], idx].set(vals) for f in fs)

    def a_both(*fs):
        acc = [f[blk[:, None], idx] for f in fs]
        return tuple(f.at[blk[:, None], idx].set(a + 1.0)
                     for f, a in zip(fs, acc))

    def b_both(f):
        acc = f[blk[:, None], idx_c]
        return (f.at[blk[:, None], idx_c].set(acc + 1.0),)

    def c_both(f):
        acc = f[blk, cell]
        return (f.at[blk, cell].set(acc + 1.0),)

    dnums = jax.lax.GatherDimensionNumbers(
        offset_dims=(1,), collapsed_slice_dims=(0,), start_index_map=(0, 1))
    starts = jnp.stack([blk, cell * (k * nf)], axis=1)
    sdnums = jax.lax.ScatterDimensionNumbers(
        update_window_dims=(1,), inserted_window_dims=(0,),
        scatter_dims_to_operand_dims=(0, 1))

    def d_both(f):
        rows = jax.lax.gather(
            f, starts, dnums, slice_sizes=(1, k * nf),
            mode=jax.lax.GatherScatterMode.PROMISE_IN_BOUNDS)
        return (jax.lax.scatter(
            f, starts, rows + 1.0, sdnums,
            mode=jax.lax.GatherScatterMode.PROMISE_IN_BOUNDS,
            unique_indices=True),)

    def copy_pool(*fs):
        return tuple(f * 1.000001 for f in fs)

    return {"a_gather6": a_gather, "a_scatter6": a_scatter,
            "a_both6": a_both, "b_both_packed_scalar": b_both,
            "c_both_rank3_rows": c_both, "d_both_flat_slices": d_both,
            "pool_copy6": copy_pool}


def writes(shape, rows, cols):
    """How many of the (row, col) index pairs write each element."""
    count = np.zeros(shape, np.int64)
    np.add.at(count, (rows, cols), 1)
    return count


def test_pool_formulations_match_the_jax_scripts():
    n, p, nc, k, nf = 6, 16, 12, 4, 6
    b = n + 64
    blk, cell, vals, _ = (t.numpy() for t in bench_pool_ops.draws(
        n, p, nc, k, nf, "cpu"))
    rng = np.random.default_rng(3)
    init = {"fields": [rng.normal(size=(b, nc * k)).astype(np.float32)
                       for _ in range(nf)],
            "flat": [rng.normal(size=(b, nc * k * nf)).astype(np.float32)]}
    init["rank3"] = [init["flat"][0].reshape(b, nc, k * nf)]
    ours = bench_pool_ops.formulations(
        torch.from_numpy(blk), torch.from_numpy(cell),
        torch.from_numpy(vals), k, nf)
    theirs = jax_formulations(blk, cell, vals, k, nf)
    assert list(ours) == list(theirs)
    # the elements that exactly one index pair writes
    slot = cell[:, None] * k + np.arange(k)
    once = {"fields": writes((b, nc * k), np.repeat(blk, k),
                             slot.reshape(-1)) <= 1,
            "flat": writes((b, nc * k * nf), np.repeat(blk, k * nf),
                           (cell[:, None] * k * nf + np.arange(k * nf))
                           .reshape(-1)) <= 1}
    once["rank3"] = once["flat"].reshape(b, nc, k * nf)
    assert (~once["fields"]).any() and once["fields"].any()
    for name, (fn, kind) in ours.items():
        arrays = [torch.from_numpy(a.copy()) for a in init[kind]]
        got = [a.numpy() for a in fn(*arrays)]
        ref = [np.asarray(a) for a in theirs[name](
            *(jnp.asarray(a) for a in init[kind]))]
        assert len(got) == len(ref), name
        for g, r in zip(got, ref):
            g = g.reshape(r.shape)
            if name in ("a_gather6", "pool_copy6"):
                np.testing.assert_allclose(g, r, rtol=1e-6, err_msg=name)
                continue
            mask = once[kind].reshape(r.shape)
            np.testing.assert_allclose(g[mask], r[mask], rtol=1e-6,
                                       err_msg=name)


def test_bench_pool_ops_prints_every_row(capsys):
    res = bench_pool_ops.main(["--cpu", "--particles", "8", "--rays", "4",
                               "--ncells", "16", "--iters", "2"])
    out = capsys.readouterr().out.splitlines()
    names = ["a_gather6", "a_scatter6", "a_both6", "b_both_packed_scalar",
             "c_both_rank3_rows", "d_both_flat_slices", "pool_copy6"]
    assert list(res) == names
    rows = [ln for ln in out if not ln.startswith("#")]
    assert [ln.split()[0] for ln in rows] == names
    assert all("ns/entry)" in ln for ln in rows)
    assert "= c's row gather" in rows[5]
    assert out[0].startswith("# 8 particles x 4 rays = 32 entries; pool "
                             "[72, 16 cells, 4 slots], 6 fields; cpu")


# -------------------------------------------------------- bench_surface_hash

def test_surface_hash_create_matches_jax():
    from slam_eslam_tpu.config import SurfaceHashConfig
    from slam_eslam_tpu.filter.surface_hash import SurfaceHash
    from slam_eslam_tpu.models import sim as jsim

    g, angles = 40, 4
    h, _ = bench_surface_hash.create_hash(g, angles, "cpu")
    jgrid = jsim.terrain_grid(filter_terrain, nx=g, ny=g,
                              resolution=0.05,
                              origin=(-g * 0.05 / 2, -g * 0.05 / 2))
    jh = SurfaceHash.create(SurfaceHashConfig(angular_steps=angles), jgrid)
    assert int(h.n_valid) == int(jh.n_valid) > 0
    np.testing.assert_array_equal(h.bucket_count.numpy(),
                                  np.asarray(jh.bucket_count))
    assert int(h.bucket_count.sum()) == int(jh.n_valid)


def test_bench_surface_hash_json_has_the_jax_scripts_keys(monkeypatch,
                                                          capsys):
    argv = ["--cpu", "--particles", "8", "--steps", "1", "--repeats", "1",
            "--grid-cells", "8", "--angles", "2"]
    res = bench_surface_hash.main(argv)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == res and res["backend"] == "cpu"
    assert res["create_cells_x_angles"] == 8 * 8 * 2
    monkeypatch.setattr(sys, "argv", ["bench_surface_hash.py"] + argv)
    jtool = jax_tool("bench_surface_hash")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jtool.main()
    ref = json.loads(buf.getvalue().strip().splitlines()[-1])
    # and one key more: whether the runners replayed CUDA graphs
    assert set(res) == set(ref) | {"graphed"}
    assert res["graphed"] is False       # the CPU runs the eager loop
    assert res["n_valid_candidates"] == ref["n_valid_candidates"]


# ------------------------------------------------------ the card by default

@pytest.mark.parametrize("name", [
    "profile_slam", "profile_filter", "profile_step", "profile_resample",
    "probe_spread", "bench_kernels", "probe_chain_parity", "bench_pool_ops",
    "bench_surface_hash", "ab_pool_dtype"])
def test_tools_run_on_the_card_unless_given_cpu(name, monkeypatch):
    """Without ``--cpu`` a tool asks for the CUDA device, and raises where
    there is none, before it does any work."""
    import importlib

    tool = importlib.import_module(f"slam_eslam_tpu_torch.tools.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])
    assert "--cpu" in tool.parser().format_help()
