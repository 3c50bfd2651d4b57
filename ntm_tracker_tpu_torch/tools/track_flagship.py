"""The flagship-width accuracy artifact: TRACK_FLAGSHIP_H100.json
(counterpart of ntm_tracker_tpu/tools/track_flagship.py).

The accuracy artifact (tools/track_artifact.py) trains the demo config
(crop 64, memory 64x12, hidden 100, L=8); the reference trains crop 224,
the 64-token conv4_3 grid, 514-channel tokens, L=20 (1300 cell steps),
memory 128x20, hidden 200 (direct_offset_output.py:21-49, 460). This tool
trains that config on synthetic video until the held-out streaming IoU
stops rising, and records the curves:
  * a fixed dataset of N sequences x L=20 frames (data/synthetic.make_video)
    with the preprocessor's geometry;
  * the frozen VGG once over all N*L crops, the [N*L, 64, 512] tokens kept
    on the card (VGG is frozen, so its tokens are a function of the data):
    each train step is the fused BPTT (B2) alone;
  * full-batch training at B=256, the streaming tracker (crop 224, B1's
    cluster route at B=1 on the card) on held-out clips every eval_every
    steps, until the IoU plateaus or max_steps.

The VGG is random and frozen and the video synthetic: the artifact shows
that the flagship training path learns, not ILSVRC accuracy.

    python -m ntm_tracker_tpu_torch.tools.track_flagship [--out PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ntm_tracker_tpu_torch.config import TrackerConfig, TrainConfig, resolve_device
from ntm_tracker_tpu_torch.data import geometry
from ntm_tracker_tpu_torch.data.synthetic import SCENES, make_video
from ntm_tracker_tpu_torch.models.vgg import init_vgg_params
from ntm_tracker_tpu_torch.tools.track_artifact import device_fields, precision_fields
from ntm_tracker_tpu_torch.tracking.demo import crop_frames, eval_streaming_iou, mean_clamped_iou
from ntm_tracker_tpu_torch.train.experiments import OffsetExperiment, frame_tokens

DEFAULT_OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                           "TRACK_FLAGSHIP_H100.json")

# the IoU curve is flat, then jumps: no plateau is called before this step
PLATEAU_AFTER = 400


def _log(m):
    print(f"track_flagship: {m}", file=sys.stderr, flush=True)


def flagship_config(batch_size: int = 256) -> TrackerConfig:
    """The reference's training config (direct_offset_output.py:21-49):
    TrackerConfig's defaults at B=256, L=20, float32."""
    return TrackerConfig(core="ntm", compute_dtype=torch.float32,
                         train=TrainConfig(batch_size=batch_size, sequence_length=20))


@torch.no_grad()
def build_dataset(cfg, vgg, n_seqs: int, seed: int, chunk: int = 128, device=None) -> dict:
    """A fixed synthetic dataset as tokens on `device`: {"features"
    [N*L, F, C] float32, "gts" [N*L, F], "y_offsets" / "x_offsets" [N*L]},
    the feature-cache batch (OffsetExperiment.batch_features). The crops
    are cut and tokenized on the device, `chunk` frames at a time."""
    dev = resolve_device(device)
    d = cfg.data
    L = cfg.train.sequence_length
    rng = np.random.RandomState(seed)
    init_tb = geometry.initial_transformed_bbox(d.cropbox_grid, d.bbox_grid)
    feats, gts, yos, xos = [], [], [], []
    frames_buf, boxes_buf = [], []

    def flush_chunk():
        if frames_buf:
            crops = crop_frames(np.stack(frames_buf), np.stack(boxes_buf).astype(np.float32), d.crop_size, dev)
            feats.append(frame_tokens(cfg, vgg, crops))
            frames_buf.clear()
            boxes_buf.clear()

    t0 = time.time()
    for s in range(n_seqs):
        frames, boxes = make_video(rng, L)
        cb = geometry.calculate_cropbox(boxes[0], d.cropbox_grid, d.bbox_grid)
        tf = geometry.calculate_transformation(cb)
        for t in range(L):
            tb = geometry.apply_transformation(boxes[t], tf)
            dy, dx = geometry.calculate_offsets(tb, init_tb)
            frames_buf.append(frames[t])
            boxes_buf.append(cb)
            gts.append(np.asarray(geometry.generate_gt(tb, d.gt_width, d.gt_width * d.bbox_grid / d.cropbox_grid),
                                  np.float32).reshape(-1))
            yos.append(dy)
            xos.append(dx)
            if len(frames_buf) >= chunk:
                flush_chunk()
        if (s + 1) % 64 == 0:
            _log(f"dataset: {s + 1}/{n_seqs} sequences ({time.time() - t0:.0f}s)")
    flush_chunk()
    features = torch.cat(feats)
    _log(f"dataset ready: features {tuple(features.shape)} ({features.numel() * 4 / 1e6:.0f} MB on {dev}, "
         f"{time.time() - t0:.0f}s)")
    return {
        "features": features,
        "gts": torch.as_tensor(np.stack(gts), device=dev),
        "y_offsets": torch.as_tensor(np.asarray(yos, np.float32), device=dev),
        "x_offsets": torch.as_tensor(np.asarray(xos, np.float32), device=dev),
    }


def train_to_plateau(cfg, vgg, params, opt_state, batch, *, max_steps: int = 1200, eval_every: int = 100,
                     eval_frames: int = 40, min_gain: float = 0.01, seed: int = 0, scene_frames: int = 24,
                     device=None):
    """Train `cfg`'s OffsetExperiment on `batch` (build_dataset's) from
    (params, opt_state), evaluating the streaming tracker every
    eval_every steps; stop when the best IoU of the last two evals gains
    less than min_gain over the best before them (past PLATEAU_AFTER
    steps), or at max_steps. Then evaluate the final params once more if
    needed, and on every scene. Returns (record, params, opt_state); the
    record holds the curves, steps, stop reason and seconds."""
    dev = resolve_device(device)
    step = OffsetExperiment(cfg, vgg, image_mode="cropped", device=dev).make_train_step()

    def eval_iou(p, frames_n=eval_frames, scene="smooth"):
        return mean_clamped_iou(eval_streaming_iou(cfg, vgg, p, seed, frames_n, scene=scene, device=dev))

    t_eval0 = time.time()
    untrained = eval_iou(params)
    _log(f"untrained IoU {untrained:.3f} ({time.time() - t_eval0:.1f}s)")
    loss_curve, iou_curve = [], [(0, round(untrained, 4))]
    t0 = time.time()
    steps_done = 0
    m = None
    stop_reason = "max_steps"
    for i in range(max_steps):
        params, opt_state, m = step(params, opt_state, batch)
        steps_done = i + 1
        if i % 20 == 0:
            loss_curve.append((i, round(float(m["loss"]), 5)))
            _log(f"step {i} loss {loss_curve[-1][1]:.4f}")
        if steps_done % eval_every == 0:
            iou = eval_iou(params)
            iou_curve.append((steps_done, round(iou, 4)))
            _log(f"step {steps_done}: held-out streaming IoU {iou:.3f}")
            if len(iou_curve) >= 3 and steps_done >= PLATEAU_AFTER:
                prev_best = max(v for _s, v in iou_curve[:-2])
                if max(iou_curve[-1][1], iou_curve[-2][1]) < prev_best + min_gain:
                    stop_reason = "plateau"
                    _log(f"plateau: last two evals {iou_curve[-2][1]:.3f}/{iou_curve[-1][1]:.3f} vs best "
                         f"{prev_best:.3f} (+<{min_gain})")
                    break
    if m is not None:
        float(m["loss"])  # a host read ends the timed span
    train_s = time.time() - t0

    # trained_iou describes the final params
    if iou_curve[-1][0] != steps_done:
        iou_curve.append((steps_done, round(eval_iou(params), 4)))
        _log(f"final eval at step {steps_done}: IoU {iou_curve[-1][1]:.3f}")
    scenes = []
    for scene in SCENES:
        iou = eval_iou(params, scene_frames, scene)
        scenes.append({"scene": scene, "trained_iou": round(iou, 4)})
        _log(f"scene {scene}: trained IoU {iou:.3f}")
    record = {
        "steps": steps_done,
        "stop_reason": stop_reason,
        "train_seconds": round(train_s, 1),
        "step_ms": round(train_s / max(steps_done, 1) * 1e3, 2),
        "untrained_iou": round(untrained, 4),
        "trained_iou": iou_curve[-1][1],
        "best_iou": round(max(v for _s, v in iou_curve), 4),
        "iou_curve": iou_curve,
        "loss_curve": loss_curve,
        "scenes": scenes,
    }
    return record, params, opt_state


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Train the flagship config on synthetic video to a plateau.")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--batch_size", type=int, default=256,
                    help="the training batch, and the dataset's size (full-batch training; eval clips are "
                         "held out by construction)")
    ap.add_argument("--max_steps", type=int, default=1200)
    ap.add_argument("--eval_every", type=int, default=100)
    ap.add_argument("--eval_frames", type=int, default=40)
    ap.add_argument("--min_gain", type=float, default=0.01,
                    help="stop when the best eval IoU gains less than this over the last two evals")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = flagship_config(args.batch_size)
    n = cfg.ntm
    _log(f"flagship config: crop {cfg.data.crop_size}, {cfg.num_features} tokens x {cfg.input_depth} ch, "
         f"L={cfg.train.sequence_length} -> {cfg.total_steps} cell steps, mem {n.mem_size}x{n.mem_dim}, "
         f"hidden {n.controller_hidden_size}, B={cfg.train.batch_size}, on {dev}")
    vgg = init_vgg_params(torch.Generator().manual_seed(0), dev)
    params, opt_state = OffsetExperiment(cfg, vgg, image_mode="cropped", device=dev).init(
        torch.Generator().manual_seed(1))
    t0 = time.time()
    batch = build_dataset(cfg, vgg, args.batch_size, args.seed, device=dev)
    dataset_s = time.time() - t0
    record, _, _ = train_to_plateau(cfg, vgg, params, opt_state, batch, max_steps=args.max_steps,
                                    eval_every=args.eval_every, eval_frames=args.eval_frames,
                                    min_gain=args.min_gain, seed=args.seed, device=dev)
    artifact = {
        **device_fields(dev),
        "precision": precision_fields(),
        "config": {
            "crop_size": cfg.data.crop_size,
            "tokens_per_frame": cfg.tokens_per_frame,
            "input_depth": cfg.input_depth,
            "sequence_length": cfg.train.sequence_length,
            "total_cell_steps": cfg.total_steps,
            "mem_size": n.mem_size,
            "mem_dim": n.mem_dim,
            "hidden": n.controller_hidden_size,
            "read_heads": n.read_head_size,
            "batch_size": cfg.train.batch_size,
            "learning_rate": cfg.train.learning_rate,
        },
        "dataset_seconds": round(dataset_s, 1),
        **record,
        "vgg": "random-init frozen (no VGG checkpoint in the repository)",
        "data": f"synthetic video (data/synthetic.make_video), {args.batch_size} fixed training sequences, "
                "held-out eval clips",
    }
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1)
        f.write("\n")
    _log(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
