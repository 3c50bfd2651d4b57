"""Build the CUDA sources under csrc/ with nvcc and load them with ctypes.

Each source is compiled on its own into a shared library with a plain C
interface (no PyTorch headers, so nvcc takes seconds). The library lands
in `_build/<hash>/`, keyed by a hash of the source, the shared headers
(csrc/*.cuh) and the flags, and is built at first use in a process.
`build_all` starts one nvcc per source at once.
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
    parts = [(CSRC / f"{name}.cu").read_bytes()]
    parts += [p.read_bytes() for p in sorted(CSRC.glob("*.cuh"))]
    parts.append(" ".join(NVCC_FLAGS).encode())
    key = hashlib.sha256(b"\0".join(parts)).hexdigest()[:16]
    return BUILD_ROOT / key / f"lib{name}.so"


def build_all(names) -> dict:
    """Compile csrc/<name>.cu for every name whose library is not built
    yet, one nvcc each, all started together; prints each nvcc time and
    ptxas's register, shared-memory and spill report. Returns
    {name: library path}."""
    outs = {name: library_path(name) for name in names}
    running = []
    for name, out in outs.items():
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running.append((name, out, tmp, proc, time.perf_counter()))
    failed = []
    for name, out, tmp, proc, t0 in running:
        try:
            stdout, stderr = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
            failed.append(f"nvcc timed out after {NVCC_TIMEOUT_S} s building {name}.cu")
            continue
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc exited {proc.returncode} building {name}.cu:\n{stdout}{stderr}")
            continue
        print(f"[build] {name}.cu: nvcc {secs:.2f} s\n{stderr.strip()}", flush=True)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless its library is already built."""
    return build_all([name])[name]


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu's library, built if needed."""
    return ctypes.CDLL(str(build(name)))
