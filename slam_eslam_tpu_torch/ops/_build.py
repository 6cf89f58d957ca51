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
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# every kernel of the port, one ``csrc/<name>.cu`` each
KERNELS = ("contact_fold", "chain_lookup", "block_merge", "select_cells",
           "block_copy", "ordered_scan", "row_copy")
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


def library_path(name, sources=None, flags=NVCC_FLAGS):
    """Where the library ``name`` built from ``sources`` with ``flags``
    goes, named by a hash of both.  The default sources of a kernel are
    ``csrc/<name>.cu`` and the shared ``csrc/*.cuh`` headers."""
    if sources is None:
        sources = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256()
    for src in sources:
        digest.update(Path(src).read_bytes())
    digest.update(" ".join(flags).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_library(lib, compiler, flags, source):
    """Compile ``source`` with ``compiler`` and ``flags`` into ``lib``
    through a temporary file renamed into place (a failed or concurrent
    build never leaves a partial library), and keep the compiler's output
    beside it.  Raises with that output if the build fails."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([compiler, *flags, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{compiler} failed to build {source} (exit {proc.returncode}):"
            f"\n{proc.stdout}{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)


@functools.cache
def load(name):
    """Compile ``csrc/<name>.cu`` if needed and return the loaded
    ``ctypes.CDLL``.  Raises with nvcc's output if the build fails."""
    lib = library_path(name)
    if not lib.exists():
        build_library(lib, nvcc_path(), NVCC_FLAGS, CSRC / f"{name}.cu")
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
    """Raise unless ``t`` lies on ``device`` with ``dtype`` (one dtype or
    a tuple of allowed ones) and ``shape``, C-contiguous (and
    ``align``-byte aligned): what a launcher needs before it hands
    ``t.data_ptr()`` to a kernel."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    allowed = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in allowed:
        raise TypeError(f"{name} has dtype {t.dtype}, expected "
                        f"{' or '.join(str(d) for d in allowed)}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if align and t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


# storage types of the map pool's float fields that the pool kernels take
POOL_DTYPES = (torch.float32, torch.bfloat16)


def pool_align(dtype, k):
    """Byte alignment the pool kernels need of a field of ``dtype``: at
    K = 4 a cell's slots are one vector load (16 bytes of float32 or
    int32, 8 of bfloat16)."""
    if k != 4:
        return None
    return 8 if dtype == torch.bfloat16 else 16


def build_log(name):
    """nvcc's output for the current build of ``name`` (the ``-Xptxas
    -v`` register and spill report); '' before the first build."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _toolkit_binary(name):
    """A binary of the CUDA toolkit that ``nvcc`` belongs to, or None."""
    found = shutil.which(name)
    if found:
        return found
    cand = Path(nvcc_path()).with_name(name)
    return str(cand) if cand.exists() else None


# one instruction of a `cuobjdump -sass` listing: its address, its opcode
_SASS_LINE = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T\d]\s+)?"
                        r"([A-Z][A-Z0-9_.]*)\s*([^;]*);")


def count_sass(listing, kernel):
    """Count the machine instructions of one kernel in a ``cuobjdump
    -sass`` listing: the first function whose mangled name contains every
    string of ``kernel`` (a string or a tuple of them).  Returns
    ``{"main": the kernel's own instructions, "subroutines": those of the
    out-of-line slow paths that follow them (IEEE division and square
    root call one for denormal operands), "function": the mangled
    name}``; padding (``NOP``) and the closing branch-to-itself do not
    count.  A static count: a loop's body counts once however often it
    runs, and both sides of a branch count, so it says how much code the
    compiler made of the kernel, not how much of it a thread runs."""
    wanted = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    function, lines = None, []
    for line in listing.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            if function is not None:
                break
            if all(w in head.group(1) for w in wanted):
                function = head.group(1)
            continue
        if function is not None:
            m = _SASS_LINE.match(line)
            if m:
                lines.append((int(m.group(1), 16), m.group(2), m.group(3)))
    if function is None:
        raise RuntimeError(f"no kernel matching {wanted} in the SASS listing")
    # a slow path is entered by CALL; the first such target starts the
    # subroutines, which the compiler places after the kernel's own code
    targets = [int(t, 16) for _, op, args in lines if op.startswith("CALL")
               for t in re.findall(r"0x([0-9a-f]+)", args)]
    first_sub = min(targets, default=None)
    counted = [addr for addr, op, args in lines
               if op != "NOP" and not (op == "BRA"
                                       and f"{addr:#x}" in args.split())]
    own = [addr for addr in counted if first_sub is None or addr < first_sub]
    return {"main": len(own), "subroutines": len(counted) - len(own),
            "function": function}


def sass_instructions(name, kernel):
    """``count_sass`` of the built library ``name`` (built first if need
    be); None where the toolkit has no ``cuobjdump``."""
    tool = _toolkit_binary("cuobjdump")
    if tool is None:
        return None
    load(name)
    proc = subprocess.run([tool, "-sass", str(library_path(name))],
                          capture_output=True, text=True, check=True)
    return count_sass(proc.stdout, kernel)
