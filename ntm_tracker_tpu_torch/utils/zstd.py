"""Decoding zstd frames with the system's libzstd, bound through ctypes.

The JAX package's orbax checkpoints compress their OCDBT manifests, B+tree
nodes and zarr chunks with zstd (train/ocdbt.py, train/orbax_ckpt.py).
Python has no zstd module before 3.14, and the port installs no wheel: it
binds `libzstd.so.1`, which needs no headers and no build. The library is
loaded at the first decode, not at import.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import threading
from typing import Optional

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()
# ZSTD_getFrameContentSize's sentinels: (unsigned long long)-1 and -2
_CONTENTSIZE_UNKNOWN = 2**64 - 1
_CONTENTSIZE_ERROR = 2**64 - 2


class ZstdError(ValueError):
    """A frame that libzstd could not decode, or no libzstd at all."""


class _Buffer(ctypes.Structure):
    """ZSTD_inBuffer and ZSTD_outBuffer: {void *ptr; size_t size; size_t pos}."""

    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            name = ctypes.util.find_library("zstd") or "libzstd.so.1"
            try:
                # RTLD_DEEPBIND: the library's calls into its own API bind to
                # itself, not to another zstd that a process exports globally
                # (TensorFlow's does, and its older symbols break the frames)
                lib = ctypes.CDLL(name, mode=os.RTLD_LOCAL | getattr(os, "RTLD_DEEPBIND", 0))
            except OSError as e:
                raise ZstdError(f"zstd: cannot load the zstd library ({name}): {e}") from e
            for fn, args, res in (
                ("ZSTD_getFrameContentSize", [ctypes.c_void_p, ctypes.c_size_t], ctypes.c_ulonglong),
                ("ZSTD_createDCtx", [], ctypes.c_void_p),
                ("ZSTD_freeDCtx", [ctypes.c_void_p], ctypes.c_size_t),
                ("ZSTD_decompressStream", [ctypes.c_void_p, ctypes.POINTER(_Buffer), ctypes.POINTER(_Buffer)],
                 ctypes.c_size_t),
                ("ZSTD_isError", [ctypes.c_size_t], ctypes.c_uint),
                ("ZSTD_getErrorName", [ctypes.c_size_t], ctypes.c_char_p),
                ("ZSTD_versionString", [], ctypes.c_char_p),
            ):
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = res
            _LIB = lib
        return _LIB


def version() -> str:
    """The loaded libzstd's version, e.g. "1.5.5"."""
    return _lib().ZSTD_versionString().decode()


def decompress(frame: bytes, where: str = "", max_size: int = 1 << 31) -> bytes:
    """The content of exactly one zstd frame, which may or may not state its
    content size (tensorstore's streaming writer leaves it out). `where`
    names the frame's file and offset in the errors; content beyond
    max_size, bytes after the frame or a frame cut short raise."""
    lib = _lib()
    src = bytes(frame)
    at = where or "the input"
    size = lib.ZSTD_getFrameContentSize(src, len(src))
    if size == _CONTENTSIZE_ERROR:
        raise ZstdError(f"zstd: not a zstd frame at {at} (first bytes {src[:4].hex()}, {len(src)} bytes)")
    if size != _CONTENTSIZE_UNKNOWN and size > max_size:
        raise ZstdError(f"zstd: the frame at {at} states {size} bytes, over {max_size}")
    cap = int(size) if size != _CONTENTSIZE_UNKNOWN else max(4 * len(src), 1 << 16)
    parts = []
    total = 0
    dctx = lib.ZSTD_createDCtx()
    if not dctx:
        raise ZstdError("zstd: ZSTD_createDCtx failed")
    try:
        inb = _Buffer(ctypes.cast(ctypes.c_char_p(src), ctypes.c_void_p), len(src), 0)
        while True:
            out = ctypes.create_string_buffer(max(cap, 1))
            outb = _Buffer(ctypes.cast(out, ctypes.c_void_p), len(out), 0)
            ret = lib.ZSTD_decompressStream(dctx, ctypes.byref(outb), ctypes.byref(inb))
            if lib.ZSTD_isError(ret):
                raise ZstdError(f"zstd: cannot decode the frame at {at}: {lib.ZSTD_getErrorName(ret).decode()}")
            parts.append(out.raw[:outb.pos])
            total += outb.pos
            if total > max_size:
                raise ZstdError(f"zstd: the frame at {at} decodes to over {max_size} bytes")
            if ret == 0:  # the frame is complete
                break
            if inb.pos == inb.size and outb.pos < outb.size:
                raise ZstdError(f"zstd: the frame at {at} is cut short ({len(src)} bytes)")
            cap = max(cap, 1 << 16)
    finally:
        lib.ZSTD_freeDCtx(dctx)
    if inb.pos != len(src):
        raise ZstdError(f"zstd: {len(src) - inb.pos} bytes follow the frame at {at}")
    return b"".join(parts)
