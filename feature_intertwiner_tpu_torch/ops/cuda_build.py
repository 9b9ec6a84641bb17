"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``csrc/`` has a plain C interface and is compiled on first
use into a shared library under ``build/torch_kernels/`` at the repository
root, for ``sm_90a`` (Hopper). The library's name carries a digest of the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source is rebuilt and a stale library is never loaded. :func:`build`
compiles several sources at once, one ``nvcc`` process each.

Nothing here runs when the module is imported: the CPU tests import every
module on a machine with no ``nvcc``.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

# Every source is compiled without FMA contraction: the plain versions round
# after each multiply and add, and NMS must agree with them bit for bit.
_COMMON_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
                 "-Xptxas=-v")
SOURCES = ("roi_align_fwd", "roi_align_bwd", "nms", "crop_and_resize", "window_sum")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}

# Kernel launches per wrapper, counted where each wrapper launches its
# kernel and nowhere else (plain-version calls on the CPU do not count).
launches: "collections.Counter[str]" = collections.Counter()


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default install location."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    """The library of one source; its name carries a digest of the source,
    every header under ``csrc/`` and the flags."""
    parts = [(CSRC_DIR / f"{name}.cu").read_bytes()]
    parts += [h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh"))]
    parts.append(" ".join(_COMMON_FLAGS).encode())
    digest = hashlib.sha256(b"\0".join(parts)).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source that has no library yet, all ``nvcc``
    processes at once. Returns the compiler's output per compiled source
    (register and shared-memory use from ``-Xptxas=-v``). Raises
    ``RuntimeError`` with that output when a compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = None
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        compiler = compiler or nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [compiler, *_COMMON_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, out))
    logs, failed = {}, []
    for name, proc, tmp, out in jobs:
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    with _lock:
        if name not in _loaded:
            build([name])
            _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return _loaded[name]


def check(err: int, kernel: str) -> None:
    """Raise when a C entry point returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA error {err} at launch")
