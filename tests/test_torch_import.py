"""The PyTorch port imports no JAX: it has to run where JAX is absent."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

MODULES = [
    "slam_eslam_tpu_torch",
    "slam_eslam_tpu_torch.convert",
    "slam_eslam_tpu_torch.core.filter",
    "slam_eslam_tpu_torch.core.state",
    "slam_eslam_tpu_torch.filter.pose_estimator",
    "slam_eslam_tpu_torch.filter.step",
    "slam_eslam_tpu_torch.mapping.lookup",
    "slam_eslam_tpu_torch.mapping.mls_grid",
    "slam_eslam_tpu_torch.models.contact_model",
    "slam_eslam_tpu_torch.models.odometry",
    "slam_eslam_tpu_torch.models.sim",
    "slam_eslam_tpu_torch.ops._build",
    "slam_eslam_tpu_torch.ops.contact_fold",
    "slam_eslam_tpu_torch.utils.geometry",
    "slam_eslam_tpu_torch.utils.tree",
]


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_never_import_jax():
    for path in (REPO / "slam_eslam_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            assert not (words[:1] in (["import"], ["from"])
                        and words[1].split(".")[0] in ("jax", "jaxlib")), (
                f"{path}: {line}")
