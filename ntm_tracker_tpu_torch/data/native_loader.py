"""ctypes binding for the native parallel record loader
(native/record_loader.cpp, built with g++ by _build.py), the port's
counterpart of ntm_tracker_tpu/data/native_loader.py.

Raises RuntimeError when the library cannot be built; the loader then
reads the records in Python (data/preprocess.read_frame_record)."""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np

from ntm_tracker_tpu_torch import _build

_IMG_PATH_CAP = 1024


_ERROR = None  # why the library did not build or load, once it has not


def _get_fn():
    global _ERROR
    if _ERROR is not None:
        raise RuntimeError(_ERROR)
    try:
        fn = _build.load_library("record_loader").load_records
    except (RuntimeError, OSError) as e:
        _ERROR = f"native library record_loader did not build or load: {e}"
        raise RuntimeError(_ERROR) from e
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_char_p, ctypes.c_int,
    ]
    return fn


def load_records_native(
    paths: Sequence[str], gt_width: int = 8, num_threads: int = 8
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, List[str]]:
    """Load n frame records in parallel.

    Returns (cropboxes [n,4], bboxes [n,4], offsets [n,2] (y,x),
    gts [n,gt,gt] float32, image paths). Raises RuntimeError if the
    library cannot be built, IOError naming the first record that fails.
    """
    fn = _get_fn()
    n = len(paths)
    gt_elems = gt_width * gt_width
    cropboxes = np.empty((n, 4), np.float32)
    bboxes = np.empty((n, 4), np.float32)
    offsets = np.empty((n, 2), np.float32)
    gts = np.empty((n, gt_elems), np.float32)
    img_buf = ctypes.create_string_buffer(n * _IMG_PATH_CAP)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    as_f32 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))  # noqa: E731
    rc = fn(c_paths, n, gt_elems, as_f32(cropboxes), as_f32(bboxes), as_f32(offsets), as_f32(gts),
            img_buf, num_threads)
    if rc != 0:
        raise IOError(f"native loader failed on record {rc - 1}: {paths[rc - 1]}")
    img_paths = [
        img_buf.raw[i * _IMG_PATH_CAP:(i + 1) * _IMG_PATH_CAP].split(b"\0", 1)[0].decode()
        for i in range(n)
    ]
    return cropboxes, bboxes, offsets, gts.reshape(n, gt_width, gt_width), img_paths
