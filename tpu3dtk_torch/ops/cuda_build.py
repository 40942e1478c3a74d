"""Build and load the port's native libraries.

Each CUDA kernel library is compiled at first use with ``nvcc`` for
Hopper (``sm_90a``), and each host C++ library (the text parser,
``csrc/fastscan.cpp``) with the host compiler ``g++``, into
``build/tpu3dtk_torch/`` under the repository root, keyed by a hash of
its sources and flags, and loaded with ``ctypes``.  The sources expose
plain C entry points, so no build includes PyTorch's headers and each
takes seconds.  A failed build raises with the compiler's output.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = [
    "BUILD_DIR", "CSRC_DIR", "HOST_FLAGS", "NVCC_FLAGS", "find_nvcc",
    "load_host_library", "load_library",
]

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "tpu3dtk_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
HOST_CXX = "g++"
HOST_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()  # guards _build_locks
_build_locks: dict[str, threading.Lock] = {}  # one per library: builds overlap
_loaded: dict[str, ctypes.CDLL] = {}
# nvcc's output (register and shared-memory use) of each library built
# in this process, by library name
build_logs: dict[str, str] = {}


def find_nvcc() -> str:
    """nvcc from PyTorch's CUDA_HOME, else from PATH; raises if absent."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (neither CUDA_HOME/bin/nvcc nor PATH): the "
            "CUDA kernels cannot be built"
        )
    return found


def load_library(name: str, sources: list[str]) -> ctypes.CDLL:
    """Compile the CUDA ``sources`` (file names under csrc/) with nvcc
    into lib<name>-<hash>.so unless that file exists, then load it once
    per process.  Different libraries may be loaded from different
    threads at once: their nvcc runs overlap."""
    return _build_and_load(name, sources, find_nvcc, NVCC_FLAGS)


def load_host_library(name: str, sources: list[str]) -> ctypes.CDLL:
    """As :func:`load_library`, for host C++ ``sources`` built with the
    host compiler (``g++``)."""

    def find_cxx():
        found = shutil.which(HOST_CXX)
        if found is None:
            raise RuntimeError(
                f"{HOST_CXX} not found on PATH: the host library {name} cannot be built"
            )
        return found

    return _build_and_load(name, sources, find_cxx, HOST_FLAGS)


def _build_and_load(name, sources, find_compiler, flags) -> ctypes.CDLL:
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    paths = [CSRC_DIR / s for s in sources]
    digest = hashlib.sha256()
    for p in paths:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    digest.update(" ".join(flags).encode())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    with _lock:
        build_lock = _build_locks.setdefault(name, threading.Lock())
    with build_lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [find_compiler(), *flags, "-o", str(tmp), *map(str, paths)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            build_logs[name] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{os.path.basename(cmd[0])} failed ({proc.returncode}) building {name}:\n"
                    f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _loaded[name] = lib
        return lib
