"""Dataset statistics and sequence mining (the reference's older,
pickle-based dataset path: sequence_generator.py, feature_matcher.py,
ilsvrc_visualizer.py — SURVEY.md §2 row 25).

The port's own copy of ntm_tracker_tpu/data/mining.py (numpy only).

  get_statistics          <- ilsvrc_visualizer.py:9-41
  vgg_layer_sizes         <- feature_matcher.py:9-15 (computed analytically,
                             no graph construction needed)
  prior_box_iou_maps      <- feature_matcher.py:17-71 (vectorized numpy
                             instead of the reference's per-pixel loops)
  objframe_statistics     <- sequence_generator.py:24-74
  gen_sequences           <- sequence_generator.py:76-154 (single-object,
                             IoU>threshold subsequence segmentation)
"""

from __future__ import annotations

import functools
import multiprocessing
import os
import pickle
import xml.etree.ElementTree as ET
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np

from ntm_tracker_tpu_torch.data.preprocess import get_img_path_from_anno_path


class Corners(NamedTuple):
    """Axis-aligned pixel bbox, VID XML corner order."""

    xmin: float
    ymin: float
    xmax: float
    ymax: float


class ObjectAnnotation(NamedTuple):
    """One ``<object>`` node of a VID annotation frame."""

    trackid: str
    bbox: Corners


class FrameRecord(NamedTuple):
    """One annotation XML resolved against its image tree."""

    anno_path: str
    image_path: str
    size: Tuple[float, float]  # (width, height)
    objects: List[ObjectAnnotation]


def _parse_statistics_frame(anno_path: str) -> Tuple[Tuple[float, float], List[ObjectAnnotation]]:
    root = ET.parse(anno_path).getroot()
    sizenode = root.find("size")
    size = (float(sizenode.findtext("width")), float(sizenode.findtext("height")))
    objects = [
        ObjectAnnotation(
            trackid=node.findtext("trackid"),
            bbox=Corners(*(float(node.find("bndbox").findtext(c)) for c in Corners._fields)),
        )
        for node in root.iter("object")
    ]
    return size, objects


def get_statistics(
    image_dirs: Sequence[str], anno_dirs: Sequence[str]
) -> List[FrameRecord]:
    """Walk paired annotation/image trees; one FrameRecord per XML frame."""
    records: List[FrameRecord] = []
    for image_dir, anno_dir in zip(image_dirs, anno_dirs):
        for walk_root, _dirs, files in os.walk(anno_dir):
            for filename in sorted(f for f in files if f.endswith(".xml")):
                anno_path = os.path.join(walk_root, filename)
                size, objects = _parse_statistics_frame(anno_path)
                records.append(
                    FrameRecord(
                        anno_path=anno_path,
                        image_path=get_img_path_from_anno_path(
                            anno_path, anno_dir, image_dir
                        ),
                        size=size,
                        objects=objects,
                    )
                )
    return records


def vgg_layer_sizes(input_size: int = 224) -> Dict[str, Tuple[int, int, int, int]]:
    """Feature-map shapes per VGG-16 conv layer at `input_size` — replaces
    the reference's build-a-graph-and-inspect approach."""
    from ntm_tracker_tpu_torch.models.vgg import VGG16_PREFIX

    sizes = {}
    hw = input_size
    for name, out_ch, has_pool in VGG16_PREFIX:
        short = name.split("/")[-1]
        sizes[short] = (None, hw, hw, out_ch)
        if has_pool:
            hw //= 2
    # hw is now the post-pool5 grid (7 at 224 input)
    sizes["pool5"] = (None, hw, hw, 512)
    return sizes


def prior_box_iou_maps(
    layer_dims: Dict[str, tuple],
    layers: Sequence[str],
    img_size: Tuple[float, float],
    bbox: Sequence[Tuple[float, float]],
    threshold: float = 0.5,
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Per-layer IoU of every grid prior box with the gt bbox; returns
    (binary heat_maps at `threshold`, float iou_maps) like
    feature_matcher.matches."""
    heat_maps, ious = [], []
    im_w, im_h = img_size
    (bx0, by0), (bx1, by1) = bbox
    barea = (bx1 - bx0) * (by1 - by0)
    for layer_name in layers:
        _, height, width, _ = layer_dims[layer_name]
        xs = np.arange(width, dtype=np.float64)
        ys = np.arange(height, dtype=np.float64)
        px0 = xs * im_w / width
        px1 = (xs + 1) * im_w / width
        py0 = ys * im_h / height
        py1 = (ys + 1) * im_h / height
        ix = np.maximum(
            np.minimum(px1, bx1)[None, :] - np.maximum(px0, bx0)[None, :], 0
        )
        iy = np.maximum(
            np.minimum(py1, by1)[:, None] - np.maximum(py0, by0)[:, None], 0
        )
        inter = iy * ix  # [H,W]
        parea = (px1 - px0)[None, :] * (py1 - py0)[:, None]
        union = parea + barea - inter
        iou = np.where(inter > 0, inter / union, 0.0)
        ious.append(iou)
        heat_maps.append((iou > threshold).astype(np.float64))
    return heat_maps, ious


_VGG_SIZES = None


def _distrib_match(obj_frame, layers):
    global _VGG_SIZES
    if _VGG_SIZES is None:
        _VGG_SIZES = vgg_layer_sizes()
    seq_dir, frame_name, obj_name, frame_size, bbox = obj_frame
    _, ious = prior_box_iou_maps(_VGG_SIZES, layers, frame_size, bbox)
    return (seq_dir, frame_name, obj_name, frame_size, bbox, ious)


def objframe_statistics(
    image_dirs: Sequence[str],
    anno_dirs: Sequence[str],
    num_workers: int = 7,
    raw_statistics=None,
    layers: Sequence[str] = ("conv4_3",),
) -> list:
    """Flatten per-frame annotations into per-object records and match each
    against the prior grids of `layers` (sequence_generator.py:24-74).
    num_workers > 1 matches in spawned processes."""
    if raw_statistics is None:
        raw_statistics = get_statistics(image_dirs, anno_dirs)
    obj_frames = []
    for record in raw_statistics:
        seq_dir, frame_jpg = os.path.split(record.image_path)
        frame_name, _ = os.path.splitext(frame_jpg)
        for obj in record.objects:
            obj_name = seq_dir + "_" + obj.trackid
            b = obj.bbox
            bbox = [(b.xmin, b.ymin), (b.xmax, b.ymax)]
            obj_frames.append((seq_dir, frame_name, obj_name, record.size, bbox))
    match = functools.partial(_distrib_match, layers=list(layers))
    if num_workers <= 1:
        return [match(f) for f in obj_frames]
    with multiprocessing.get_context("spawn").Pool(num_workers) as pool:
        return pool.map(match, obj_frames, chunksize=1000)


def gen_sequences(obj_frame_statistics: list, iou_threshold: float = 0.5) -> list:
    """Segment per-object frame runs into viable single-object subsequences
    (sequence_generator.py:76-154): a frame survives iff some prior box
    overlaps the gt above threshold; gaps in frame numbering or failed
    frames split the sequence.

    Returns [(seq_dir, obj_name, subseq_id, seq_length, [frames])] where a
    frame is (frame_path, frame_size, bbox, gt_masks)."""
    obj_frame_statistics = sorted(obj_frame_statistics, key=lambda x: x[2] + "_" + x[1])
    last_obj = None
    last_seq = None
    last_frame = None
    ret = []
    seq: list = []
    subseq_id = 0
    for seq_dir, frame_name, obj_name, frame_size, bbox, ious in obj_frame_statistics:
        if not (last_obj and last_obj == obj_name):
            if len(seq) > 0:
                ret.append((last_seq, last_obj, subseq_id, len(seq), seq))
            seq = []
            subseq_id = 0
            last_frame = None
        if last_frame:
            assert int(frame_name) > int(last_frame)
            if int(frame_name) - int(last_frame) > 1:
                if len(seq) > 0:
                    ret.append((seq_dir, obj_name, subseq_id, len(seq), seq))
                    seq = []
                    subseq_id += 1
        count = sum(int(np.sum(iou > iou_threshold)) for iou in ious)
        if count > 0:
            gt = [(iou > 0.5) for iou in ious]
            seq.append(
                (os.path.join(seq_dir, frame_name + ".JPEG"), frame_size, bbox, gt)
            )
        else:
            if len(seq) > 0:
                ret.append((seq_dir, obj_name, subseq_id, len(seq), seq))
                seq = []
                subseq_id += 1
        last_seq = seq_dir
        last_obj = obj_name
        last_frame = frame_name
    if len(seq) > 0:
        ret.append((last_seq, last_obj, subseq_id, len(seq), seq))
    return ret


def mine_and_dump(
    image_dirs, anno_dirs, out_path: str = "generated_sequences.pkl",
    iou_threshold: float = 0.5, num_workers: int = 7, layers=None,
) -> list:
    """sequence_generator.main: statistics -> sequences -> pickle. The
    prior grids are `layers` (conv4_3 when None), passed to the workers
    (the JAX package keeps the last call's in a module global)."""
    stats = objframe_statistics(image_dirs, anno_dirs, num_workers, layers=layers or ("conv4_3",))
    seqs = gen_sequences(stats, iou_threshold)
    with open(out_path, "wb") as f:
        pickle.dump(seqs, f)
    return seqs
