"""The port's benchmark, ``slam_eslam_tpu_torch.bench``, in process
on the CPU at tiny sizes: one JSON line on stdout with the keys of the JAX
package's ``bench.py``, finite values, the roofline keys null (a time on
the CPU would mean nothing), a ``#`` summary on stderr; every flag of
``bench.py`` parses with its default; the default device needs a CUDA
device and says so.  That the filter mode's runner is the path the JAX
package's runner is held against (same centroids on JAX's draws) is in
``tests/test_torch_step.py``, beside the fixture it needs.
"""

import ast
import json
import math
from pathlib import Path

import pytest
import torch

from slam_eslam_tpu_torch import bench

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent

FILTER_KEYS = {
    "metric", "value", "unit", "vs_baseline", "sol_fraction", "ns_per_query",
    "fold_tier", "fold_mfu", "fold_kernel_us", "fold_roofline_fraction",
    "merge_dma_floor_fraction", "merge_us_per_block",
    "merge_unsorted_twin_us_per_block", "merge_whole_us_per_block",
    "copy_gbps", "card"}
ROOFLINE_KEYS = {
    "fold_mfu", "fold_kernel_us", "fold_roofline_fraction",
    "merge_dma_floor_fraction", "merge_us_per_block",
    "merge_unsorted_twin_us_per_block", "merge_whole_us_per_block",
    "copy_gbps", "card"}
SLAM_KEYS = {"metric", "value", "unit", "vs_baseline", "chain_kernel",
             "merge_kernel", "pool_dtype", "card"}


def run_bench(capsys, *argv, detail=None):
    result = bench.main(list(argv) + ["--device", "cpu"], detail)
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1, out
    assert json.loads(lines[0]) == result
    assert err.startswith("# ") and "device=cpu" in err
    return result, err


@pytest.mark.parametrize("extra", [
    (), ("--fold", "off"), ("--ablate", "nolookup"), ("--ablate", "noupdate"),
    ("--contact-cap", "0", "--min-effective", "0")],
    ids=["default", "fold_off", "nolookup", "noupdate", "cap0_ess0"])
def test_filter_mode(capsys, extra):
    detail = {}
    result, err = run_bench(capsys, "--particles", "256", "--steps", "5",
                            "--repeats", "2", *extra, detail=detail)
    assert set(result) == FILTER_KEYS
    assert result["metric"] == "particle_updates_per_sec_per_chip"
    assert result["unit"] == "particle-updates/s"
    for key in ROOFLINE_KEYS:
        assert result[key] is None, key
    for key in ("value", "vs_baseline", "sol_fraction", "ns_per_query"):
        assert math.isfinite(result[key]) and result[key] >= 0, key
    assert result["value"] > 0
    assert result["vs_baseline"] == pytest.approx(result["value"] / 1e6,
                                                  abs=1e-3)
    assert result["fold_tier"] == [400, 400]        # the whole grid
    assert "256 particles x 5 steps" in err
    assert len(detail["seconds"]) == 2
    cents = detail["centroids"]
    assert cents.shape == (5, 3) and bool(torch.isfinite(cents).all())
    assert bool(torch.isfinite(detail["state"].particles.weight).all())
    assert detail["truth"].shape == (5, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("extra", [(), ("--donate", "--visual")],
                         ids=["default", "donate_visual"])
def test_slam_mode(capsys, dtype, extra):
    detail = {}
    result, err = run_bench(
        capsys, "--mode", "slam", "--particles", "32", "--steps", "2",
        "--repeats", "1", "--pool-dtype", dtype, "--chain-kernel", "pallas",
        *extra, detail=detail)
    assert set(result) == SLAM_KEYS
    assert result["metric"] == "slam_frames_per_sec"
    assert result["unit"] == "frames/s @ 32 particles, per-particle maps"
    assert math.isfinite(result["value"]) and result["value"] > 0
    assert result["vs_baseline"] == pytest.approx(result["value"] / 100,
                                                  abs=1e-3)
    assert (result["chain_kernel"], result["merge_kernel"],
            result["pool_dtype"], result["card"]) == ("pallas", "auto",
                                                      dtype, None)
    assert "20 contact frames (2 scan frames, 2 merges gated in" in err
    pool = detail["carry"].pool
    assert pool.mean.dtype == getattr(torch, dtype)
    assert pool.b == 4 * 32 and pool.chain_len == 3
    assert detail["patches"] == int(pool.valid.sum()) > 0
    assert detail["failed"] == 0
    assert detail["frames"] == 20
    assert detail["aux"]["centroid"].shape == (20, 3)
    assert bool(torch.isfinite(detail["aux"]["centroid"]).all())
    assert bool(torch.isfinite(pool.mean.float()).all())
    assert detail["cfg"].use_visual_update == ("--visual" in extra)


def test_slam_mode_geometry_flags(capsys):
    detail = {}
    run_bench(capsys, "--mode", "slam", "--particles", "16", "--steps", "1",
              "--repeats", "1", "--grid-size", "4", "--grid-res", "0.5",
              "--chain-len", "2", "--pool-blocks", "40", "--contact-cap",
              "6", detail=detail)
    pool = detail["carry"].pool
    assert (pool.nx, pool.ny, pool.b, pool.chain_len) == (8, 8, 40, 2)


def bench_py_flags():
    """``(flag, default)`` of every ``add_argument`` in the JAX package's
    ``bench.py``, read from its source (importing it would need nothing,
    but running it would)."""
    flags = []
    for node in ast.walk(ast.parse((REPO / "bench.py").read_text())):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "add_argument"):
            kw = {k.arg: ast.literal_eval(k.value) for k in node.keywords
                  if k.arg in ("default", "action")}
            default = kw.get("default",
                             False if kw.get("action") == "store_true"
                             else None)
            flags.append((node.args[0].value, default))
    return flags


def test_every_flag_of_bench_py_parses():
    flags = bench_py_flags()
    assert len(flags) == 19
    ap = bench.parser()
    defaults = vars(ap.parse_args([]))
    for flag, default in flags:
        dest = flag.lstrip("-").replace("-", "_")
        assert dest in defaults, flag
        assert defaults[dest] == default, flag
    assert defaults["device"] is None               # the one addition
    assert set(defaults) == {f.lstrip("-").replace("-", "_")
                             for f, _ in flags} | {"device"}
    args = ap.parse_args(
        "--particles 5 --steps 7 --repeats 2 --lookup window --window 64 "
        "--contact-cap 4 --fold off --mode slam --grid-size 8 --grid-res 0.5 "
        "--donate --pool-dtype bfloat16 --chain-kernel xla --merge-kernel "
        "pallas --visual --chain-len 2 --pool-blocks 99 --min-effective 3 "
        "--ablate nolookup --device cpu".split())
    assert (args.lookup, args.window, args.fold, args.donate, args.visual,
            args.pool_blocks) == ("window", 64, "off", True, True, 99)


def test_configs_follow_bench_py():
    ap = bench.parser()
    args = ap.parse_args(["--particles", "1000"])
    cfg = bench.filter_config(args)
    assert (cfg.particle_count, cfg.min_effective, cfg.lookup_mode) == (
        1000, 200, "auto")
    assert cfg.contact_model.fold_lookup
    assert cfg.contact_model.contact_point_radius == 0.0
    args = ap.parse_args(["--particles", "1000", "--mode", "slam",
                          "--pool-dtype", "bfloat16"])
    cfg = bench.slam_config(args)
    assert (cfg.min_effective, cfg.map_pool_blocks, cfg.map_chain_length,
            cfg.map_pool_color, cfg.map_pool_dtype, cfg.grid_size,
            cfg.grid_resolution, cfg.contact_model.min_contacts) == (
        500, 4000, 3, False, "bfloat16", 10.0, 0.25, 2)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this test is about a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--particles", "16", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--mode", "slam", "--particles", "16", "--steps", "1"])
