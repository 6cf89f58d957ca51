"""``run.py`` without a card: an exit code other than 0 and no result,
no CPU fallback; and the cells of ``BENCHMARK.json`` keep the contract's
shape."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def run(*args, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


@pytest.mark.parametrize("cell", ["loc_100k.replay", "slam_1k.online"])
def test_no_card_no_result(cell):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = run("--workload", cell, "--seed", str(2**31 + 3), "--seconds", "1",
              "--trace", "0", env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_alone_it_fails(tmp_path):
    """In a directory holding only ``BENCHMARK.json`` and ``benchmark/``
    the run fails and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run("--workload", "loc_100k.replay", "--seed", "1", "--seconds",
              "1", "--trace", "0", cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_shape():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert (ROOT / c["file"]).exists()
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"]: w for w in bench["workloads"]}
    for w in cells.values():
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "benchmark/traffic" / f"{w['traffic']}.json").exists()
        reported = [m for m in bench["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reported) >= 2
    for m in bench["per_layer"]:
        assert (ROOT / "benchmark/metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in e2e
        assert all(c in cells for c in m["workloads"])
        assert all(c in e2e[m["moves"]].get("workloads", cells)
                   for c in m["workloads"])


def test_configuration_files_state_their_cuts():
    """Every key ``reduced`` names is a top-level key of the configuration
    file, and the scale kept at the top level is the one the port runs."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert all(k in cfg for k in c["reduced"])
        fil = cfg["filter"]
        assert cfg["particles"] == fil["particle_count"]
        for k in ("min_effective", "map_pool_blocks"):
            if k in cfg:
                assert cfg[k] == fil[k]
