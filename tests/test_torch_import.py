"""The PyTorch port imports no JAX and nothing of the JAX package
``slam_eslam_tpu`` (it keeps its own copy of the configuration): it has
to run where neither is present."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

MODULES = [
    "slam_eslam_tpu_torch",
    "slam_eslam_tpu_torch.bench",
    "slam_eslam_tpu_torch.config",
    "slam_eslam_tpu_torch.convert",
    "slam_eslam_tpu_torch.core.distribution",
    "slam_eslam_tpu_torch.core.filter",
    "slam_eslam_tpu_torch.core.gmm",
    "slam_eslam_tpu_torch.core.state",
    "slam_eslam_tpu_torch.filter.eslam_filter",
    "slam_eslam_tpu_torch.filter.pose_estimator",
    "slam_eslam_tpu_torch.filter.step",
    "slam_eslam_tpu_torch.filter.streaming",
    "slam_eslam_tpu_torch.filter.surface_hash",
    "slam_eslam_tpu_torch.mapping.lookup",
    "slam_eslam_tpu_torch.mapping.map_pool",
    "slam_eslam_tpu_torch.mapping.mls_grid",
    "slam_eslam_tpu_torch.mapping.projection",
    "slam_eslam_tpu_torch.models.asguard",
    "slam_eslam_tpu_torch.models.contact_model",
    "slam_eslam_tpu_torch.models.odometry",
    "slam_eslam_tpu_torch.models.sim",
    "slam_eslam_tpu_torch.models.terrain",
    "slam_eslam_tpu_torch.ops._build",
    "slam_eslam_tpu_torch.ops.block_copy",
    "slam_eslam_tpu_torch.ops.block_merge",
    "slam_eslam_tpu_torch.ops.chain_lookup",
    "slam_eslam_tpu_torch.ops.contact_fold",
    "slam_eslam_tpu_torch.ops.select_cells",
    "slam_eslam_tpu_torch.utils.device",
    "slam_eslam_tpu_torch.utils.geometry",
    "slam_eslam_tpu_torch.utils.kernel_eff",
    "slam_eslam_tpu_torch.utils.profiling",
    "slam_eslam_tpu_torch.utils.tree",
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
