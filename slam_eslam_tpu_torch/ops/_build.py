"""Build, load and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher and is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library at
first use, then loaded with ``ctypes``.  Libraries go to
``build/torch_kernels/`` beside the package, named by a hash of the
source and the flags, so an edited source rebuilds and an unchanged one
is reused.  Nothing here runs at import time.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# every kernel of the port, one ``csrc/<name>.cu`` each
KERNELS = ("contact_fold", "chain_lookup", "block_merge", "select_cells")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path():
    """``nvcc`` from PATH, else ``$CUDA_HOME/bin``, else the toolkit's
    default install location."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in filter(None, (home, "/usr/local/cuda")):
        cand = Path(root) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    raise RuntimeError("nvcc not found: install the CUDA toolkit or set "
                       "CUDA_HOME")


def library_path(name):
    """Where the library built from the current ``csrc/<name>.cu`` goes
    (named by a hash of the source, the shared ``csrc/*.cuh`` headers
    and the flags)."""
    digest = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


@functools.cache
def load(name):
    """Compile ``csrc/<name>.cu`` if needed and return the loaded
    ``ctypes.CDLL``.  Raises with nvcc's output if the build fails."""
    src = CSRC / f"{name}.cu"
    lib = library_path(name)
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed to build {src} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))


def load_all(names=KERNELS):
    """``load`` every kernel in ``names`` (default: all of them) with one
    ``nvcc`` each, all started together.  Returns ``{name: seconds}``,
    each build's wall time (0 for a library that was already built)."""
    def timed(name):
        t0 = time.perf_counter()
        load(name)
        return time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        futures = {name: pool.submit(timed, name) for name in names}
        return {name: f.result() for name, f in futures.items()}


def check_operand(name, t, shape, dtype, device, align=None):
    """Raise unless ``t`` lies on ``device`` with ``dtype`` and ``shape``,
    C-contiguous (and ``align``-byte aligned): what a launcher needs
    before it hands ``t.data_ptr()`` to a kernel."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        if t.dtype == torch.bfloat16:
            raise NotImplementedError(
                f"{name} is bfloat16: the CUDA kernels read float32 "
                "(bf16 pool storage is not ported yet)")
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if align and t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def build_log(name):
    """nvcc's output for the current build of ``name`` (the ``-Xptxas
    -v`` register and spill report); '' before the first build."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
