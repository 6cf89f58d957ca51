"""Nothing under ``benchmark/`` imports JAX or the JAX package, and the
reference imports nothing of the port: top-level names compared whole."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness import common

BENCH = Path(__file__).resolve().parents[1]


def imported(path):
    """Top-level names of every module ``path`` imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".", 1)[0])
    return out


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not imported(path) & {"jax", "jaxlib", "flax", "slam_eslam_tpu"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = imported(path)
    assert "slam_eslam_tpu_torch" not in names
    assert names <= {"__future__", "math", "torch", "benchmark"}
    text = path.read_text()
    assert "benchmark.harness" not in text


def test_forbidden_modules_compare_whole_names():
    mods = {"jax": 1, "jax.numpy": 1, "jaxlib.x": 1, "slam_eslam_tpu": 1,
            "slam_eslam_tpu.ops": 1, "slam_eslam_tpu_torch": 1,
            "slam_eslam_tpu_torch.ops": 1, "jaxtyping": 1, "flax": 1}
    assert common.forbidden_modules(mods) == sorted(
        ["jax", "jax.numpy", "jaxlib.x", "slam_eslam_tpu",
         "slam_eslam_tpu.ops", "flax"])


def test_the_harness_process_loads_no_jax():
    """A process that imports the harness, both drives and the port's
    modules they use holds no forbidden module."""
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "import benchmark.run, benchmark.calibrate\n"
        "import benchmark.harness.drive_chunks, benchmark.harness.drive_frames\n"
        "import slam_eslam_tpu_torch.filter.step\n"
        "import slam_eslam_tpu_torch.filter.streaming\n"
        "import slam_eslam_tpu_torch.filter.eslam_filter\n"
        "import slam_eslam_tpu_torch.mapping.lookup\n"
        "from benchmark.harness import common\n"
        "print(common.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
