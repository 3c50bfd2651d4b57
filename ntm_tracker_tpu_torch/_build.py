"""Build the CUDA sources under csrc/ with nvcc and load them with ctypes.

Each source is compiled on its own into a shared library with a plain C
interface (no PyTorch headers, so nvcc takes seconds). The library lands
in `_build/<hash>/`, keyed by a hash of the source, the shared headers
(csrc/*.cuh) and the flags, and is built at first use in a process.
`build_all` starts one nvcc per library at once. A library in VARIANTS is
built from another library's source with flags of its own.
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
# library name -> (the csrc/<source>.cu it is built from, its extra nvcc flags)
VARIANTS = {
    "scan_packed_bwd": ("scan_packed", ("-DNTM_PACKED_BACKWARD",)),
    "scan_packed_probe": ("scan_packed", ("-DNTM_PACKED_PROBE",)),
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (on PATH or /usr/local/cuda/bin)")
    return path


def _source_and_flags(name: str) -> tuple:
    source, extra = VARIANTS.get(name, (name, ()))
    return CSRC / f"{source}.cu", (*NVCC_FLAGS, *extra)


def library_path(name: str) -> Path:
    """Where the library `name` (csrc/<name>.cu, or its VARIANTS entry) lives."""
    source, flags = _source_and_flags(name)
    parts = [source.read_bytes()]
    parts += [p.read_bytes() for p in sorted(CSRC.glob("*.cuh"))]
    parts.append(" ".join(flags).encode())
    key = hashlib.sha256(b"\0".join(parts)).hexdigest()[:16]
    return BUILD_ROOT / key / f"lib{name}.so"


def build_all(names) -> dict:
    """Compile the library of every name not built yet (csrc/<name>.cu, or
    its VARIANTS entry), one nvcc each, all started together; prints each nvcc time and
    ptxas's register, shared-memory and spill report. Returns
    {name: library path}."""
    outs = {name: library_path(name) for name in names}
    running = []
    for name, out in outs.items():
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        source, flags = _source_and_flags(name)
        cmd = [_nvcc(), *flags, "-o", str(tmp), str(source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running.append((name, out, tmp, proc, time.perf_counter()))
    failed = []
    for name, out, tmp, proc, t0 in running:
        try:
            stdout, stderr = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
            failed.append(f"nvcc timed out after {NVCC_TIMEOUT_S} s building {name}")
            continue
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc exited {proc.returncode} building {name}:\n{stdout}{stderr}")
            continue
        print(f"[build] {name}: nvcc {secs:.2f} s\n{stderr.strip()}", flush=True)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def build(name: str) -> Path:
    """Compile the library `name` unless it is already built."""
    return build_all([name])[name]


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of the library `name`, built if needed."""
    return ctypes.CDLL(str(build(name)))
