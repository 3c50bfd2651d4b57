"""Host-side data loader with a prefetch thread (counterpart of
ntm_tracker_tpu/data/loader.py; numpy on the host, the same arrays and
the same frame order).

  host thread:  read .txt/.bin records (native/record_loader.cpp, else
                Python), decode JPEGs (native/jpeg_pipeline.cpp: libjpeg
                plus the TF1 resize, else PIL plus numpy), stack a batch
  prefetch:     PrefetchIterator keeps `prefetch` batches ahead and moves
                each to the device in its worker (`device_put`)
  device:       resize (image_mode "raw"), mean-subtract, crop and resize
                (data/image_ops.py, in OffsetExperiment)

A batch covers batch_size sequences x seq_len frames, flattened to
[B*L, ...] like the reference's get_input(batch*seq_len).

Counters (utils/profiling's registry; `decode_routes()` and
`record_routes()` read them): `decode.<route>.batches|frames|seconds`,
the batches, frames and seconds of decoding (and resizing on the host) by
route ("native", the libjpeg pipeline; "pil"), and `records.<reader>`,
the batches of records read by each reader ("native", record_loader.cpp;
"python"). Spans (on by utils/profiling's rule): `loader.read`,
the worker's wait for a host batch from the wrapped iterator;
`loader.upload`, its `device_put`; `loader.wait`, the consumer's wait for
a batch in `PrefetchIterator.__next__`.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ntm_tracker_tpu_torch.data.preprocess import read_frame_record
from ntm_tracker_tpu_torch.utils import profiling

_DECODERS = ("native", "pil")
_READERS = ("native", "python")


def reset_route_counts() -> None:
    profiling.reset("decode", "records")


def decode_routes() -> dict:
    """{route: {"batches", "frames", "seconds"}} of the routes that decoded."""
    return {r: {k: profiling.counter(f"decode.{r}.{k}") for k in ("batches", "frames", "seconds")}
            for r in _DECODERS if profiling.counter(f"decode.{r}.batches")}


def record_routes() -> dict:
    """{reader: batches} of the readers that read records."""
    return {r: profiling.counter(f"records.{r}") for r in _READERS if profiling.counter(f"records.{r}")}


class FrameBatch(NamedTuple):
    images: np.ndarray     # [B*L, H, W, 3] decoded frames (uint8 raw, float32 resized)
    cropboxes: np.ndarray  # [B*L, 4] float32
    gts: np.ndarray        # [B*L, gt, gt] float32
    y_offsets: np.ndarray  # [B*L] float32
    x_offsets: np.ndarray  # [B*L] float32
    # RAW log-scale of the record's crop-space bbox vs the canonical box,
    # before the cfg.scale_range normalization (the consumer owns the
    # config). Flip-invariant, so reverse_image leaves it alone.
    scales: np.ndarray = None  # [B*L] float32


def tf1_resize_bilinear_np(image: np.ndarray, out_hw) -> np.ndarray:
    """Numpy twin of image_ops.tf1_resize_bilinear (TF1 legacy grid:
    src = i * in/out, not half-pixel centered) for the host decode path.
    The source rows are interpolated along x first, then the output rows
    between them: the JAX package's arithmetic, element for element, with
    the x pass on the source's rows only and the y pass in place."""
    H, W = image.shape[:2]
    out_h, out_w = out_hw
    if (H, W) == (out_h, out_w):
        return image.astype(np.float32)
    ys = np.arange(out_h, dtype=np.float64) * (H / out_h)
    xs = np.arange(out_w, dtype=np.float64) * (W / out_w)
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, H - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    fy = (ys - np.floor(ys)).astype(np.float32)[:, None, None]
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, W - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    fx = (xs - np.floor(xs)).astype(np.float32)[None, :, None]
    img = image.astype(np.float32)
    rows = img[:, x0] * (1 - fx)
    rows += img[:, x1] * fx
    out = rows[y0]
    out *= 1 - fy
    bottom = rows[y1]
    bottom *= fy
    out += bottom
    return out


def _decode_image(path: str, resize_hw=None) -> np.ndarray:
    from PIL import Image

    img = np.asarray(Image.open(path).convert("RGB"), dtype=np.uint8)
    if resize_hw is not None:
        # the reference's in-graph resize_images semantics; float32
        return tf1_resize_bilinear_np(img, resize_hw)
    return img


def _decode_images_parallel(paths: Sequence[str], resize_hw, workers: int = 8, expand: bool = True):
    """Decode (and resize) a batch: the native C++ pipeline when it builds
    (libjpeg decode + TF1 bilinear in one thread pool), else PIL + numpy
    under a Python thread pool. The native pipeline always resizes, so
    uint8 frames (resize_hw None) and single frames take PIL. A frame that
    several records share (one per object in it) is decoded once; with
    expand=False the distinct frames come back once each, with the row of
    each path's frame."""
    t0 = time.perf_counter()
    unique = list(dict.fromkeys(paths))
    out, route = None, "pil"
    if resize_hw is not None and len(paths) > 1:
        try:
            from ntm_tracker_tpu_torch.data.native_jpeg import decode_resize_batch_native

            out, route = decode_resize_batch_native(unique, resize_hw), "native"
        except RuntimeError:
            pass  # no g++/libjpeg, or a JPEG libjpeg refuses: PIL decodes it
    if out is None:
        if len(unique) <= 1:
            out = np.stack([_decode_image(p, resize_hw) for p in unique])
        else:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=min(workers, len(unique))) as ex:
                out = np.stack(list(ex.map(lambda p: _decode_image(p, resize_hw), unique)))
    profiling.count(f"decode.{route}.batches")
    profiling.count(f"decode.{route}.frames", len(unique))
    profiling.count(f"decode.{route}.seconds", time.perf_counter() - t0)
    row = {p: i for i, p in enumerate(unique)}
    index = [row[p] for p in paths]
    if not expand:
        return out, index
    return out[index] if len(unique) < len(paths) else out


def load_record_arrays(frame_paths: Sequence[str], gt_width: int = 8, use_native: bool = True):
    """(cropboxes [N,4], offsets [N,2], gts [N,g,g], all float32, image
    paths, and crop-space bboxes [N,4]) of a list of frame records: the
    native C++ reader when it builds, else the Python one. Shared by the
    image path (load_frame_batch) and the feature cache (load_token_batch)."""
    if use_native:
        try:
            from ntm_tracker_tpu_torch.data.native_loader import load_records_native

            crops, bboxes, offsets, gts, img_paths = load_records_native(frame_paths, gt_width)
            profiling.count("records.native")
            return (np.asarray(crops, np.float32), offsets, gts,
                    list(img_paths), np.asarray(bboxes, np.float32))
        except RuntimeError:
            pass  # no g++: the Python reader
    recs = [read_frame_record(p, gt_width) for p in frame_paths]
    crops = np.asarray([r["cropbox"] for r in recs], np.float32)
    offsets = np.array([[r["y_offset"], r["x_offset"]] for r in recs], np.float32)
    gts = np.stack([r["gt"] for r in recs]).astype(np.float32)
    bboxes = np.asarray([r["bbox"] for r in recs], np.float32)
    profiling.count("records.python")
    return crops, offsets, gts, [r["image_path"] for r in recs], bboxes


def record_log_scales(bboxes: np.ndarray, cropbox_grid: int = 8, bbox_grid: int = 6) -> np.ndarray:
    """[N,4] crop-space bboxes -> [N] raw log-scale targets vs the
    canonical box (geometry.calculate_scale, vectorized); the consumer
    divides by cfg.scale_range."""
    side = bbox_grid / float(cropbox_grid)
    area = np.maximum(
        (bboxes[:, 2] - bboxes[:, 0]) * (bboxes[:, 3] - bboxes[:, 1]),
        np.finfo(np.float32).tiny,
    )
    return (0.5 * np.log(area / (side * side))).astype(np.float32)


def load_shared_frames(
    frame_paths: Sequence[str],
    gt_width: int = 8,
    reverse_image: bool = False,
    decode_resize_hw=(720, 1280),
    use_native: bool = True,
    cropbox_grid: int = 8,
    bbox_grid: int = 6,
):
    """load_frame_batch's records and frames, each distinct frame once:
    (a FrameBatch whose `images` holds the distinct frames, the row of
    each record's frame there). Indexing the images by the rows gives
    load_frame_batch's."""
    if reverse_image and decode_resize_hw is None:
        raise ValueError(
            "reverse_image requires the host-side resize (set "
            "decode_resize_hw): the TF1 resize grid is not flip-equivariant, "
            "so flipping before the device resize breaks reference parity"
        )
    crops, offsets, gts, img_paths, bboxes = load_record_arrays(frame_paths, gt_width, use_native)
    images, index = _decode_images_parallel(img_paths, decode_resize_hw, expand=False)
    xo = -offsets[:, 1] if reverse_image else offsets[:, 1]
    if reverse_image:
        images = np.ascontiguousarray(images[:, :, ::-1])
        c = crops.copy()
        c[:, 1], c[:, 3] = 1.0 - crops[:, 3], 1.0 - crops[:, 1]
        crops = c
    batch = FrameBatch(
        images=images,
        cropboxes=crops,
        gts=gts,
        y_offsets=offsets[:, 0].copy(),
        x_offsets=np.asarray(xo),
        # the grids must be the ones preprocess wrote the records with
        scales=record_log_scales(bboxes, cropbox_grid, bbox_grid),
    )
    return batch, index


def load_frame_batch(
    frame_paths: Sequence[str],
    gt_width: int = 8,
    reverse_image: bool = False,
    decode_resize_hw=(720, 1280),
    use_native: bool = True,
    cropbox_grid: int = 8,
    bbox_grid: int = 6,
) -> FrameBatch:
    """Load B*L frame records and their images on the host.

    reverse_image is the reference's horizontal-flip augmentation
    (direct_offset_output.py:186-187, 203-204): x offsets negate, the
    decoded frame flips and the cropbox's x extent mirrors, which equals
    flipping the crop under the corner-aligned crop_and_resize grid. The
    frame-0 gt indicator is not flipped (nor is it in the reference).

    The flip must come after the host resize: the TF1 resize grid
    (src = i * in/out) is not flip-equivariant, so decode_resize_hw=None
    (the device resize) together with reverse_image is refused.
    """
    batch, index = load_shared_frames(frame_paths, gt_width, reverse_image, decode_resize_hw, use_native,
                                      cropbox_grid, bbox_grid)
    if len(batch.images) < len(index):
        batch = batch._replace(images=batch.images[index])
    return batch


def device_batch(batch, device, predict_scale: bool = False, scale_range: float = 1.0) -> dict:
    """A host batch (a TokenBatch or a FrameBatch) as a dict of tensors on
    `device`: cached tokens go as stored (float16), frames as decoded
    (uint8 raw, float32 resized on the host); the experiment casts to
    float32 on the device. The raw log-scale targets go, divided by
    scale_range, only when the head predicts the scale."""
    b = batch._asdict()
    scales = b.pop("scales")
    if predict_scale:
        b["scales"] = scales / scale_range
    return {k: torch.as_tensor(v).to(device) for k, v in b.items()}


class PrefetchIterator:
    """Wrap a batch iterator with a background thread that keeps
    `prefetch` batches ahead, each passed through `device_put` there. A
    worker's error is raised in the consumer, not taken for the end.
    `waits` holds the seconds the consumer waited in each __next__, timed
    whether spans are on or off (the `loader.wait` spans' timing); the
    worker's reads and device_puts are the `loader.read` and
    `loader.upload` spans, and the worker reads no clock with spans off."""

    def __init__(self, it: Iterator, prefetch: int = 2, device_put=None):
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._sentinel = object()
        self._error: Optional[BaseException] = None
        self.waits: list = []

        def worker():
            try:
                t0 = profiling.stamp()
                for item in it:
                    profiling.record("loader.read", t0)
                    if device_put is not None:
                        with profiling.span("loader.upload"):
                            item = device_put(item)
                    self._q.put(item)
                    t0 = profiling.stamp()
            except BaseException as e:  # noqa: BLE001 -- raised again in __next__
                self._error = e
            finally:
                self._q.put(self._sentinel)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.time_ns()
        item = self._q.get()
        t1 = time.time_ns()
        self.waits.append((t1 - t0) * 1e-9)
        profiling.record("loader.wait", t0, t1)
        if item is self._sentinel:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item


def epoch_batches(seqs, batch_size: int, shuffle: bool, seed: int, epochs: int):
    """The frame paths of each batch, epoch after epoch, in the JAX
    package's order: one random.Random(seed) shuffles the sequences at
    the start of every epoch; a last partial batch is dropped."""
    import random

    from ntm_tracker_tpu_torch.data.sequences import sevenbyseven_get_batch

    rng = random.Random(seed)
    seqs = list(seqs)
    usable = len(seqs) // batch_size * batch_size
    for _ in range(epochs):
        if shuffle:
            rng.shuffle(seqs)
        index = 0
        while index < usable:
            frame_names, index = sevenbyseven_get_batch(index, batch_size, seqs)
            yield frame_names


def batch_iterator(
    seqs,
    batch_size: int,
    gt_width: int = 8,
    shuffle: bool = True,
    seed: int = 42,
    reverse_image: bool = False,
    epochs: int = 1,
    decode_resize_hw=(720, 1280),
    cropbox_grid: int = 8,
    bbox_grid: int = 6,
):
    """Yield a FrameBatch per training step, like the reference's epoch
    loop (direct_offset_output.py:292-353).

    decode_resize_hw=None ships native-size uint8 frames and leaves the
    TF1 720x1280 resize to the device (image_mode "raw"); a batch's frames
    must then share one size."""
    for frame_names in epoch_batches(seqs, batch_size, shuffle, seed, epochs):
        try:
            yield load_frame_batch(
                frame_names, gt_width, reverse_image=reverse_image,
                decode_resize_hw=decode_resize_hw,
                cropbox_grid=cropbox_grid, bbox_grid=bbox_grid,
            )
        except ValueError as e:
            if decode_resize_hw is None and ("stack" in str(e).lower() or "same shape" in str(e).lower()):
                raise ValueError(
                    "device_resize needs uniform frame sizes within a "
                    "batch; use host resize (decode_resize_hw set) for "
                    "mixed-resolution batches"
                ) from e
            raise
