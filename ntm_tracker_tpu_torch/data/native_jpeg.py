"""ctypes binding for the native JPEG decode + resize pipeline
(native/jpeg_pipeline.cpp, built with g++ and -ljpeg by _build.py), the
port's counterpart of ntm_tracker_tpu/data/native_jpeg.py: libjpeg decode
and the TF1-grid bilinear resize in one C++ thread pool, off the GIL.

Raises RuntimeError when the library cannot be built (no g++ or no
libjpeg) or a decode fails; the loader then decodes with PIL
(data/loader.py)."""

from __future__ import annotations

import ctypes
import os
from typing import Sequence, Tuple

import numpy as np

from ntm_tracker_tpu_torch import _build


_ERROR = None  # why the library did not build or load, once it has not


def _get_fn():
    global _ERROR
    if _ERROR is not None:
        raise RuntimeError(_ERROR)
    try:
        fn = _build.load_library("jpeg_pipeline").ntm_decode_resize_batch
    except (RuntimeError, OSError) as e:
        _ERROR = f"native library jpeg_pipeline did not build or load: {e}"
        raise RuntimeError(_ERROR) from e
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
    ]
    return fn


def decode_resize_batch_native(
    paths: Sequence[str], out_hw: Tuple[int, int], num_threads: int = 0
) -> np.ndarray:
    """Decode `paths` and TF1-bilinear-resize each to out_hw.

    Returns float32 [N, out_h, out_w, 3]. num_threads=0 takes one thread
    per core, at most 16."""
    fn = _get_fn()
    n = len(paths)
    out_h, out_w = out_hw
    out = np.empty((n, out_h, out_w, 3), np.float32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    if num_threads <= 0:
        num_threads = min(os.cpu_count() or 8, 16)
    errbuf = ctypes.create_string_buffer(512)
    rc = fn(c_paths, n, out_h, out_w, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            num_threads, errbuf, len(errbuf))
    if rc != 0:
        raise RuntimeError(f"native jpeg pipeline failed: {errbuf.value.decode()}")
    return out
