"""The older pickle-based dataset path (generated_sequences.pkl).

The port's own copy of ntm_tracker_tpu/data/pickle_dataset.py.

Feeds the whole-frame experiments (ntm()/ntm_two_step()/lstm_only()) the way
the reference's default_get_batch + read_imgs did (main.py:122-142, 295-316):
full frames resized straight to 224x224 (no crop), gt = the conv4_3
prior-grid mask from sequence mining (data/mining.gen_sequences).

Sequence record shape (mining.gen_sequences):
  (seq_dir, obj_name, subseq_id, seq_length, frames)
  frame = (frame_path, frame_size, bbox, gt_masks)  # gt_masks: [per-layer bool map]
"""

from __future__ import annotations

import pickle
from typing import List, Sequence, Tuple

import numpy as np

from ntm_tracker_tpu_torch.data.loader import _decode_images_parallel


def load_generated_sequences(path: str, min_length: int) -> list:
    """Load generated_sequences.pkl, keeping sequences >= min_length
    (main.py:521-523)."""
    with open(path, "rb") as f:
        seqs = pickle.load(f)
    return [s for s in seqs if s[-2] >= min_length]


def default_get_batch(
    index: int, batch_size: int, seq_length: int, seqs: Sequence
) -> Tuple[List[str], np.ndarray, int]:
    """Frame paths + gt masks for a batch of pickled sequences
    (direct_offset_output.py:122-142 / main.py default_get_batch).

    Returns (frame_names [B*L], real_gts [B, L, F], new_index)."""
    seq_batch = seqs[index : index + batch_size]
    index += batch_size
    frame_names: List[str] = []
    real_gts = []
    for seq_dir, obj_name, subseq_id, seq_len, seq in seq_batch:
        seq = seq[:seq_length]
        frame_names += [x[0] for x in seq]
        real_gts.append(
            np.array([np.reshape(x[-1][0], (-1)) for x in seq], np.float32)
        )
    return frame_names, np.array(real_gts, np.float32), index


def load_wholeframe_batch(
    frame_names: Sequence[str], crop_size: int = 224
) -> np.ndarray:
    """Decode frames and resize straight to crop_size (read_imgs semantics,
    main.py:295-316 — no cropbox). Returns [B*L, S, S, 3] float32."""
    return _decode_images_parallel(frame_names, (crop_size, crop_size))


def active_resize_get_batch(
    index: int, batch_size: int, seq_length: int, seqs: Sequence
) -> Tuple[List[str], np.ndarray, int]:
    """Frame paths + NORMALIZED (y1,x1,y2,x2) gt boxes per frame, for the
    closed-loop active-resize experiment (train/active_resize.py — the
    reference's read_imgs_withbbox intent, main.py:1332-1336).

    Returns (frame_names [B*L], boxes [B, L, 4], new_index)."""
    from ntm_tracker_tpu_torch.data import geometry

    seq_batch = seqs[index : index + batch_size]
    index += batch_size
    frame_names: List[str] = []
    boxes = []
    for _seq_dir, _obj, _sid, _len, seq in seq_batch:
        seq = seq[:seq_length]
        frame_names += [x[0] for x in seq]
        bs = []
        for _path, size, bbox, _gts in seq:
            (x0, y0), (x1, y1) = bbox
            bs.append(geometry.normalize_bbox(size, [y0, x0, y1, x1]))
        boxes.append(bs)
    return frame_names, np.asarray(boxes, np.float32), index
