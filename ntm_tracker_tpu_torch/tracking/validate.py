"""Validation replay: the streaming tracker over validation sequences,
ground-truth regions rebuilt by inverting each frame record's stored crop
transformation (counterpart of ntm_tracker_tpu/tracking/validate.py; the
reference's validate_tracker.py:1-40).

Reports the per-frame IoU between tracked and annotated regions: the
reference defines bb_iou (test_tracker.py:59-83) but never aggregates it;
the means here clamp per frame (demo.mean_clamped_iou). `validate_tracker`
is the `validate` command's body: the pickle of sequences, --limit,
--fleet N and the --serving_npz route.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Tuple

import numpy as np

from ntm_tracker_tpu_torch.data import geometry
from ntm_tracker_tpu_torch.models.core import make_core
from ntm_tracker_tpu_torch.tracking.demo import mean_clamped_iou
from ntm_tracker_tpu_torch.tracking.fleet import FleetTracker
from ntm_tracker_tpu_torch.tracking.tracker import StreamingTracker


def get_image(frame_path: str) -> Tuple[str, Tuple[float, float, float, float]]:
    """Read a frame record (`<frame_path>.txt`: cropbox, bbox in crop space,
    image path) and decode the annotated region back to image coordinates
    (validate_tracker.py:12-24): (image path, (x, y, w, h)) normalized."""
    with open(frame_path + ".txt") as f:
        parts = f.readline().strip().split(",")
    cy1, cx1, cy2, cx2 = (float(v) for v in parts[0:4])
    y1, x1, y2, x2 = (float(v) for v in parts[4:8])
    inv = np.linalg.inv(geometry.calculate_transformation([cy1, cx1, cy2, cx2]))
    y1, x1, y2, x2 = geometry.apply_transformation([y1, x1, y2, x2], inv)
    return parts[8], (x1, y1, x2 - x1, y2 - y1)


def _load_rgb(path: str) -> np.ndarray:
    from PIL import Image

    return np.array(Image.open(path).convert("RGB"))


def _frame_and_gt(seq_path: str, frame_name: str):
    """One frame record -> (image, gt region as absolute pixel corners).
    The gt may be stored normalized (values <= 2) or in pixels; the
    reference's records hold both."""
    imagepath, (gx, gy, gw, gh) = get_image(os.path.join(seq_path, frame_name))
    img = _load_rgb(imagepath)
    H, W = img.shape[:2]
    if max(abs(gx), abs(gy), gw, gh) <= 2.0:
        corners = [gx * W, gy * H, (gx + gw) * W, (gy + gh) * H]
    else:
        corners = [gx, gy, gx + gw, gy + gh]
    return img, corners


def _first_frame(seq_path: str, frame_names):
    imagepath, region = get_image(os.path.join(seq_path, frame_names[0]))
    return _load_rgb(imagepath), region


def replay_sequences(seqs, cfg, vgg_params, params, core=None, log=print, delimiter_first: bool = False,
                     tracker=None, device=None) -> List[List[float]]:
    """Replay each (sequence dir, frame names) pair through one
    StreamingTracker (init() resets its state); returns the raw per-frame
    IoUs of each sequence. Pass `tracker` to replay through a prebuilt one.
    Runs on cuda unless `device` names another device."""
    if tracker is None:
        tracker = StreamingTracker(cfg, vgg_params, params, core or make_core(cfg),
                                   delimiter_first=delimiter_first, device=device)
    all_ious: List[List[float]] = []
    for idx, (seq_path, frame_names) in enumerate(seqs):
        tracker.init(*_first_frame(seq_path, frame_names))
        ious: List[float] = []
        for frame_name in frame_names[1:]:
            img, gt_corners = _frame_and_gt(seq_path, frame_name)
            x, y, w, h = tracker.track(img)
            ious.append(geometry.bb_iou([x, y, x + w, y + h], gt_corners))
        log(f"seq {idx}: mean IoU {mean_clamped_iou(ious):.3f}")
        all_ious.append(ious)
    return all_ious


def replay_sequences_fleet(seqs, cfg, vgg_params, params, core=None, capacity: int = 8, log=print,
                           delimiter_first: bool = False, fleet=None, device=None) -> List[List[float]]:
    """replay_sequences over a FleetTracker: up to `capacity` sequences
    advance per batched frame step, and a finished slot takes the next
    sequence at once (no wave barrier). The same outputs as
    replay_sequences. Pass `fleet` to replay through a prebuilt one."""
    if fleet is None:
        fleet = FleetTracker(cfg, vgg_params, params, capacity=capacity, core=core or make_core(cfg),
                             delimiter_first=delimiter_first, device=device)
    all_ious: List[List[float]] = [[] for _ in seqs]
    active: dict = {}  # slot -> [sequence index, next frame position]
    next_seq = 0

    def finish(slot, seq_idx):
        fleet.remove(slot)
        log(f"seq {seq_idx}: mean IoU {mean_clamped_iou(all_ious[seq_idx]):.3f}")

    def admit():
        nonlocal next_seq
        while next_seq < len(seqs) and len(active) < fleet.capacity:
            idx = next_seq
            next_seq += 1
            seq_path, frame_names = seqs[idx]
            slot = fleet.add(*_first_frame(seq_path, frame_names))
            if len(frame_names) < 2:  # nothing to track
                finish(slot, idx)
                continue
            active[slot] = [idx, 1]

    admit()
    while active:
        images, gt_corners = {}, {}
        for slot, (seq_idx, fi) in active.items():
            seq_path, frame_names = seqs[seq_idx]
            images[slot], gt_corners[slot] = _frame_and_gt(seq_path, frame_names[fi])
        regions = fleet.step(images)
        for slot in list(active):
            seq_idx, fi = active[slot]
            x, y, w, h = regions[slot]
            all_ious[seq_idx].append(geometry.bb_iou([x, y, x + w, y + h], gt_corners[slot]))
            active[slot][1] = fi + 1
            if fi + 1 >= len(seqs[seq_idx][1]):
                del active[slot]
                finish(slot, seq_idx)
        admit()
    return all_ious


def validate_tracker(args) -> List[List[float]]:
    """The validate command's body: load the pickle of (sequence dir, frame
    names), build the tracker (live, on --device, or from --serving_npz),
    replay, print the overall mean IoU. Returns the per-sequence IoUs."""
    from ntm_tracker_tpu_torch import cli
    from ntm_tracker_tpu_torch.config import resolve_device

    fleet_n = int(getattr(args, "fleet", 0) or 0)
    if fleet_n < 0:
        raise SystemExit(f"--fleet wants a positive capacity, got {fleet_n}")
    with open(args.pickle_path, "rb") as f:
        seqs = pickle.load(f)
    limit = int(getattr(args, "limit", 0) or 0)
    if limit > 0:
        # dress rehearsal (MIGRATION.md real-data runbook)
        seqs = seqs[:limit]
        print(f"--limit {limit}: replaying {len(seqs)} sequences")
    dev = resolve_device(getattr(args, "device", None))

    if getattr(args, "serving_npz", ""):
        # the artifact holds the weights, the geometry and the token order;
        # --vgg_int8 is checked against its token path
        model = cli._load_serving_model(args.serving_npz, args, dev)
        if fleet_n:
            if model.meta["batch"] != fleet_n:
                raise SystemExit(
                    f"--fleet {fleet_n} but {args.serving_npz} bakes batch {model.meta['batch']} programs; pass "
                    f"--fleet {model.meta['batch']} or re-export with export-serving --batch {fleet_n}")
            ious = replay_sequences_fleet(seqs, None, None, None, fleet=FleetTracker.from_serving(model))
        else:
            ious = replay_sequences(seqs, None, None, None, tracker=StreamingTracker.from_serving(model))
    else:
        cfg = cli._tracker_config(args, args.core)
        vgg_params = cli._load_vgg(args, dev)
        core = make_core(cfg)
        params = cli._resolve_tracker_weights(args, cfg, core, dev)
        delimiter_first = getattr(args, "delimiter_first", False)
        if fleet_n:
            ious = replay_sequences_fleet(seqs, cfg, vgg_params, params, core, capacity=fleet_n,
                                          delimiter_first=delimiter_first, device=dev)
        else:
            ious = replay_sequences(seqs, cfg, vgg_params, params, core, delimiter_first=delimiter_first,
                                    device=dev)
    flat = [i for s in ious for i in s]
    print(f"overall mean IoU over {len(flat)} frames: {mean_clamped_iou(flat):.4f}")
    return ious
