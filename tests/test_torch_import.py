"""The PyTorch port imports no JAX and nothing of the JAX package
``slam_eslam_tpu`` (it keeps its own copy of the configuration): it has
to run where neither is present."""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

MODULES = [
    "slam_eslam_tpu_torch",
    "slam_eslam_tpu_torch.backend.keyframes",
    "slam_eslam_tpu_torch.backend.pose_graph",
    "slam_eslam_tpu_torch.bench",
    "slam_eslam_tpu_torch.config",
    "slam_eslam_tpu_torch.convert",
    "slam_eslam_tpu_torch.core.distribution",
    "slam_eslam_tpu_torch.core.filter",
    "slam_eslam_tpu_torch.core.gmm",
    "slam_eslam_tpu_torch.core.state",
    "slam_eslam_tpu_torch.examples.full_demo",
    "slam_eslam_tpu_torch.examples.localize_demo",
    "slam_eslam_tpu_torch.examples.loop_closure_demo",
    "slam_eslam_tpu_torch.examples.replay_demo",
    "slam_eslam_tpu_torch.examples.slam_demo",
    "slam_eslam_tpu_torch.filter.eslam_filter",
    "slam_eslam_tpu_torch.filter.pose_estimator",
    "slam_eslam_tpu_torch.filter.step",
    "slam_eslam_tpu_torch.filter.streaming",
    "slam_eslam_tpu_torch.filter.surface_hash",
    "slam_eslam_tpu_torch.io.logio",
    "slam_eslam_tpu_torch.mapping.lookup",
    "slam_eslam_tpu_torch.mapping.map_pool",
    "slam_eslam_tpu_torch.mapping.mls_grid",
    "slam_eslam_tpu_torch.mapping.projection",
    "slam_eslam_tpu_torch.models.asguard",
    "slam_eslam_tpu_torch.models.contact_model",
    "slam_eslam_tpu_torch.models.odometry",
    "slam_eslam_tpu_torch.models.sim",
    "slam_eslam_tpu_torch.models.terrain",
    "slam_eslam_tpu_torch.online",
    "slam_eslam_tpu_torch.ops._build",
    "slam_eslam_tpu_torch.ops.block_copy",
    "slam_eslam_tpu_torch.ops.block_merge",
    "slam_eslam_tpu_torch.ops.chain_lookup",
    "slam_eslam_tpu_torch.ops.contact_fold",
    "slam_eslam_tpu_torch.ops.row_copy",
    "slam_eslam_tpu_torch.ops.select_cells",
    "slam_eslam_tpu_torch.tools.ab_pool_dtype",
    "slam_eslam_tpu_torch.tools.bench_kernels",
    "slam_eslam_tpu_torch.tools.bench_pool_ops",
    "slam_eslam_tpu_torch.tools.bench_surface_hash",
    "slam_eslam_tpu_torch.tools.closure_lab",
    "slam_eslam_tpu_torch.tools.convert_dataset",
    "slam_eslam_tpu_torch.tools.probe_chain_parity",
    "slam_eslam_tpu_torch.tools.probe_merge_overhead",
    "slam_eslam_tpu_torch.tools.probe_spread",
    "slam_eslam_tpu_torch.tools.profile_filter",
    "slam_eslam_tpu_torch.tools.profile_resample",
    "slam_eslam_tpu_torch.tools.profile_slam",
    "slam_eslam_tpu_torch.tools.bench_scaling",
    "slam_eslam_tpu_torch.tools.profile_step",
    "slam_eslam_tpu_torch.tools.stat_map_test",
    "slam_eslam_tpu_torch.parallel.sharding",
    "slam_eslam_tpu_torch.parallel.resample",
    "slam_eslam_tpu_torch.parallel.distributed",
    "slam_eslam_tpu_torch.dryrun",
    "slam_eslam_tpu_torch.ops.ordered_scan",
    "slam_eslam_tpu_torch.utils.checkpoint",
    "slam_eslam_tpu_torch.utils.device",
    "slam_eslam_tpu_torch.utils.geometry",
    "slam_eslam_tpu_torch.utils.graphs",
    "slam_eslam_tpu_torch.utils.kernel_eff",
    "slam_eslam_tpu_torch.utils.profiling",
    "slam_eslam_tpu_torch.utils.scatter",
    "slam_eslam_tpu_torch.utils.tracing",
    "slam_eslam_tpu_torch.utils.tree",
    "slam_eslam_tpu_torch.viz.render",
    "slam_eslam_tpu_torch.viz.snapshots",
]


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib',\n"
        "                                    'slam_eslam_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_every_module_of_the_port_is_listed():
    found = set()
    for path in (REPO / "slam_eslam_tpu_torch").rglob("*.py"):
        parts = path.relative_to(REPO).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        found.add(".".join(parts))
    packages = {m for m in found if (REPO / m.replace(".", "/")).is_dir()}
    assert found - packages - {"slam_eslam_tpu_torch"} <= set(MODULES), (
        sorted(found - packages - set(MODULES)))


def test_port_sources_never_import_jax():
    sources = [*(REPO / "slam_eslam_tpu_torch").rglob("*.py"),
               REPO / "chip_smoke.py"]
    for path in sources:
        for line in path.read_text().splitlines():
            words = line.split()
            assert not (words[:1] in (["import"], ["from"])
                        and words[1].split(".")[0] in (
                            "jax", "jaxlib", "slam_eslam_tpu")), (
                f"{path}: {line}")


def test_matplotlib_is_imported_only_to_draw():
    """A GPU host may lack matplotlib: importing the port (its plots and
    demos included) must not need it."""
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "assert 'matplotlib' not in sys.modules\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# JAX modules with no counterpart, and public names a counterpart lacks,
# each by design (ROADMAP.md, Queue 1)
NO_COUNTERPART = {
    # Pallas kernels: their ports are ops/*.py with csrc/*.cu
    "ops/pallas_gather.py", "ops/pallas_chain.py", "ops/pallas_merge.py",
    # XLA's persistent compile cache: ops/_build.py keeps built kernels
    "utils/cache.py",
}
NOT_PORTED = {
    # a TPU gather workaround (one gather of ten bitcast lanes); the port
    # takes ``take`` (tools/profile_resample.py keeps a copy)
    ("core/filter.py", "take_packed"),
    # the TPU matrix unit's utilisation; the port has fold_roofline
    ("utils/kernel_eff.py", "fold_mfu"),
    ("utils/kernel_eff.py", "fold_flops_per_particle"),
    # the stderr progress line and a timing print that nothing read; the
    # port's spans, stage marks and counters are utils/tracing.py
    ("utils/profiling.py", "StepLogger"),
    ("utils/profiling.py", "timed"),
}
JAX_MODULES = sorted(
    str(p.relative_to(REPO / "slam_eslam_tpu"))
    for p in (REPO / "slam_eslam_tpu").rglob("*.py"))


def public_names(path):
    """The public names a module defines at its top level (functions,
    classes, assignments), read from its source: nothing is imported."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            names.update(n.id for t in targets for n in ast.walk(t)
                         if isinstance(n, ast.Name))
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_public_name_has_its_counterpart(rel):
    """Each public top-level name of a module of the JAX package resolves
    on its counterpart under ``slam_eslam_tpu_torch`` (a re-export
    counts); the exceptions are listed above with their reasons."""
    if rel in NO_COUNTERPART:
        assert not (REPO / "slam_eslam_tpu_torch" / rel).exists(), rel
        return
    parts = Path(rel).with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    port = importlib.import_module(".".join(("slam_eslam_tpu_torch",)
                                            + parts))
    wanted = public_names(REPO / "slam_eslam_tpu" / rel)
    missing = sorted(n for n in wanted if not hasattr(port, n)
                     and (rel, n) not in NOT_PORTED)
    assert not missing, f"{port.__name__} lacks {missing}"
    stale = sorted(n for r, n in NOT_PORTED if r == rel and n not in wanted)
    assert not stale, f"listed as not ported but gone from {rel}: {stale}"
