"""Int8 tracking accuracy on a trained canonical-config tracker
(counterpart of ntm_tracker_tpu/tools/int8_accuracy.py).

Trains a small NTM tracker at the canonical serving config (224 crop, the
64-token conv4_3 grid, feature_points=None: the only config where the
int8 path applies) on synthetic video, then tracks a held-out clip through
the StreamingTracker on the exact float32 token path and on the opt-in
int8 one (models/vgg_int8.py). Prints one JSON line on stdout; progress
goes to stderr.

Usage: python -m ntm_tracker_tpu_torch.tools.int8_accuracy [steps] [eval_frames] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time


def main(steps: int = 300, eval_frames: int = 40, device=None) -> dict:
    import numpy as np
    import torch

    from ntm_tracker_tpu_torch.config import NTMConfig, TrackerConfig, TrainConfig, resolve_device
    from ntm_tracker_tpu_torch.models.core import make_core
    from ntm_tracker_tpu_torch.models.vgg import init_vgg_params
    from ntm_tracker_tpu_torch.tracking.demo import eval_streaming_iou, mean_clamped_iou, training_batch
    from ntm_tracker_tpu_torch.train.experiments import OffsetExperiment

    dev = resolve_device(device)
    cfg = TrackerConfig(
        ntm=NTMConfig(output_dim=2, mem_size=64, mem_dim=12, controller_hidden_size=100, read_head_size=4),
        train=TrainConfig(batch_size=4, sequence_length=8, learning_rate=1e-4),
    )
    assert cfg.data.crop_size == 224 and cfg.feature_points is None

    rng = np.random.RandomState(0)
    vgg = init_vgg_params(torch.Generator().manual_seed(0), dev)
    core = make_core(cfg)
    exp = OffsetExperiment(cfg, vgg, core=core, image_mode="cropped", device=dev)
    params, opt_state = exp.init(torch.Generator().manual_seed(1))
    step = exp.make_train_step()
    t0 = time.perf_counter()
    m = None
    for i in range(steps):
        params, opt_state, m = step(params, opt_state, training_batch(cfg, rng, dev))
        if i % 50 == 0:
            print(f"step {i} loss {float(m['loss']):.4f}", file=sys.stderr, flush=True)
    if m is not None:
        float(m["loss"])  # a value fetch waits for the device
    train_s = time.perf_counter() - t0

    iou_f32 = mean_clamped_iou(eval_streaming_iou(cfg, vgg, params, 0, eval_frames, device=dev))
    cfg8 = dataclasses.replace(cfg, vgg_int8=True)
    iou_int8 = mean_clamped_iou(eval_streaming_iou(cfg8, vgg, params, 0, eval_frames, device=dev))
    result = {
        "device": dev.type,
        "steps": steps,
        "train_seconds": round(train_s, 1),
        "eval_frames": eval_frames,
        "trained_iou_f32": round(iou_f32, 4),
        "trained_iou_int8": round(iou_int8, 4),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("steps", type=int, nargs="?", default=300)
    ap.add_argument("eval_frames", type=int, nargs="?", default=40)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.steps, a.eval_frames, a.device)
