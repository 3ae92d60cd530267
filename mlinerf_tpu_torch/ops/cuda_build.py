"""Build the port's native libraries and load them with ctypes.

Each ``csrc/<name>.cu`` is a hand-written CUDA kernel with a plain C
interface; it compiles on its own with ``nvcc`` for ``sm_90a``. Each
``csrc/<name>.cpp`` is a host library (no CUDA) and compiles with ``g++``.
Both land in ``build/lib<name>.so`` at the root of the checkout (the
directory is listed in ``.gitignore``). A library is rebuilt when it is
missing or older than its source. Nothing here runs at import time: a
library is built at its first use, or by :func:`build` up front.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC"]

_LOADED: Dict[str, ctypes.CDLL] = {}


def kernel_names():
    """The CUDA kernels (``csrc/*.cu``)."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _source(name: str) -> Path:
    cu = CSRC_DIR / f"{name}.cu"
    return cu if cu.exists() else CSRC_DIR / f"{name}.cpp"


def _compiler_command(name: str, out: Path) -> List[str]:
    src = _source(name)
    if src.suffix == ".cu":
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
        return [nvcc, *NVCC_FLAGS, "-o", str(out), str(src)]
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: the host library {name} needs a C++ compiler")
    return [gxx, *GXX_FLAGS, "-o", str(out), str(src)]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _is_stale(name: str) -> bool:
    lib = library_path(name)
    return not lib.exists() or lib.stat().st_mtime < _source(name).stat().st_mtime


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named libraries (default: every CUDA kernel), one
    compiler per source, all started together. Returns each one's compiler
    output (for a kernel, register and shared-memory use from ``-Xptxas
    -v``); raises with the compiler's output if a build fails."""
    names = kernel_names() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        if not _is_stale(name):
            continue
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = _compiler_command(name, tmp)
        jobs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("build failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The library, built first if needed."""
    if name not in _LOADED:
        build([name])
        _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return _LOADED[name]
