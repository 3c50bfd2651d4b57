"""Build the CUDA sources under csrc/ with nvcc and load them with ctypes.

Each source is compiled on its own into a shared library with a plain C
interface (no PyTorch headers, so nvcc takes seconds). The library lands
in `_build/<hash>/`, keyed by a hash of the source and the flags, and is
built at first use in a process.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NVCC_TIMEOUT_S = 300


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (on PATH or /usr/local/cuda/bin)")
    return path


def library_path(name: str) -> Path:
    """Where the library built from csrc/<name>.cu lives."""
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_ROOT / key / f"lib{name}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless its library is already built; prints
    the nvcc time and ptxas's register, shared-memory and spill report."""
    out = library_path(name)
    if out.exists():
        return out
    src = CSRC / f"{name}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=NVCC_TIMEOUT_S)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc exited {proc.returncode} building {src.name}:\n{proc.stdout}{proc.stderr}"
        )
    print(f"[build] {src.name}: nvcc {secs:.2f} s\n{proc.stderr.strip()}", flush=True)
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu's library, built if needed."""
    return ctypes.CDLL(str(build(name)))
