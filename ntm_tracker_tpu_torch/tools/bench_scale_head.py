"""Measure the scale head's (TrackerConfig.predict_scale) per-scene IoU
payoff (counterpart of ntm_tracker_tpu/tools/bench_scale_head.py).

Trains the demo config twice (offsets-only and predict_scale, the same
seed and budget) and evaluates every synthetic scene with the streaming
tracker: the comparison behind PARITY.md's predict_scale verdict. First
holds B1 (ops/kernels/scan_cell.ntm_scan_fused) at output_dim=3 against
the plain loop, since the B=1 streaming evaluation takes it on cuda; the
trainings take B2 (fused_bptt "auto") on cuda.

    python -m ntm_tracker_tpu_torch.tools.bench_scale_head [steps] [scale_range] [finetune]
        [--device cpu] [--eval_frames N]

steps (400) trains each head; scale_range (0.15) is the tanh -> log-scale
range; finetune (0) adds that many closed-loop steps (train/active_resize)
after the open-loop training. Prints one JSON line last, with the JAX
tool's keys: {"steps", "scale_range", "offsets_only": {scene: iou},
"predict_scale": {scene: iou, "diag", "damped_0.05", "damped_0.02"}[,
"closed_loop": {scene: iou}]}. Progress, and the kernels' launches,
go to stderr.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from ntm_tracker_tpu_torch.benchmarks import kernel_launches
from ntm_tracker_tpu_torch.config import resolve_device
from ntm_tracker_tpu_torch.data.synthetic import SCENES, make_scene, make_video
from ntm_tracker_tpu_torch.models.core import make_core
from ntm_tracker_tpu_torch.models.vgg import init_vgg_params
from ntm_tracker_tpu_torch.tracking.demo import demo_config, eval_streaming_iou, mean_clamped_iou, training_batch
from ntm_tracker_tpu_torch.train.experiments import OffsetExperiment
from ntm_tracker_tpu_torch.train.optim import tree_map

PARITY_TOL = 1e-4


def log(m: str) -> None:
    print(m, file=sys.stderr, flush=True)


def fused_parity(device) -> float:
    """B1 at output_dim=3 against the plain cell loop on the same stream
    (one frame of random tokens at B=1): the last logit's max |diff|;
    raises past PARITY_TOL."""
    from ntm_tracker_tpu_torch.ops.kernels.scan_cell import ntm_scan_fused
    from ntm_tracker_tpu_torch.train.serialize import serialize_streaming_batch

    cfg3 = demo_config(predict_scale=True)
    core3 = make_core(cfg3)
    params3 = core3.init_params(torch.Generator().manual_seed(1), cfg3.input_depth, device)
    toks = torch.randn((1, cfg3.num_features, cfg3.feature_depth), generator=torch.Generator().manual_seed(2))
    stream = serialize_streaming_batch(toks.to(device), None, delimiter_first=False)
    with torch.no_grad():
        state = state0 = core3.init_state(params3, 1)
        for t in range(stream.shape[1]):
            ref_logit, state = core3.step(params3, stream[:, t], state)
        fused, _ = ntm_scan_fused(params3, cfg3.ntm, stream, state0, compute_dtype=cfg3.compute_dtype)
    err = float((fused[:, -1] - ref_logit).abs().max())
    log(f"fused-kernel O=3 parity: max|diff|={err:.3e}")
    if not err < PARITY_TOL:
        raise AssertionError(f"B1 at output_dim=3 disagrees with the plain loop: {err:.3e} >= {PARITY_TOL}")
    return err


def train(exp, params, opt_state, steps: int, tag: str = ""):
    """`steps` train steps on training_batch(RandomState(0)) draws ->
    (params, opt_state, the losses)."""
    step = exp.make_train_step()
    rng = np.random.RandomState(0)
    losses = []
    t0 = time.time()
    for i in range(steps):
        params, opt_state, m = step(params, opt_state, training_batch(exp.cfg, rng, exp.device))
        losses.append(float(m["loss"]))
        if i % 100 == 0:
            log(f"  [{tag}] step {i} loss {losses[-1]:.4f}")
    log(f"  trained {steps} steps in {time.time() - t0:.0f}s")
    return params, opt_state, losses


def scene_ious(cfg, vgg, params, tag: str, device, frames: int, scenes=SCENES) -> dict:
    out = {}
    for scene in scenes:
        iou = mean_clamped_iou(eval_streaming_iou(cfg, vgg, params, 0, frames, scene=scene, device=device))
        out[scene] = round(iou, 4)
        log(f"  [{tag}] scene {scene}: IoU {iou:.4f}")
    return out


def train_and_eval(predict_scale: bool, vgg, steps: int, scale_range: float, device, frames: int):
    """One head trained and evaluated -> (the scenes' IoUs and, for the
    scale head, its diagnosis and damped decodes; params; cfg)."""
    tag = "scale" if predict_scale else "ref"
    cfg = demo_config(predict_scale=predict_scale, scale_range=scale_range)
    exp = OffsetExperiment(cfg, vgg, image_mode="cropped", device=device)
    params, opt_state = exp.init(torch.Generator().manual_seed(1))
    params, _, _ = train(exp, params, opt_state, steps, tag)
    out = scene_ious(cfg, vgg, params, tag, device, frames)
    if predict_scale:
        out["diag"] = diagnose(cfg, exp, params, device, frames)
        # damped decode: serve with a smaller log-scale range than trained
        # (gain serve_range / train_range), for a weak, lagged ds response
        for serve_range in (0.05, 0.02):
            dcfg = dataclasses.replace(cfg, scale_range=serve_range)
            out[f"damped_{serve_range}"] = scene_ious(dcfg, vgg, params, f"scale,damped {serve_range}", device,
                                                      frames, ("smooth", "scale"))
    return out, params, cfg


def diagnose(cfg, exp, params, device, frames: int) -> dict:
    """Is the ds output signal or noise? (1) the correlation of every head
    channel's prediction with its target on held-out training-style
    batches; (2) on the scale scene, the correlation of the tracked box's
    area with the true area over the frames."""
    from ntm_tracker_tpu_torch.tracking.tracker import StreamingTracker

    rng = np.random.RandomState(123)
    preds, tgts = [], []
    with torch.no_grad():
        for _ in range(8):
            b = training_batch(cfg, rng, device)
            p = exp.loss_fn(params, b)[1]["pred_offsets"].cpu().numpy()  # [B, L-1, 3]
            B, L = p.shape[0], p.shape[1] + 1
            t = np.stack([b["y_offsets"], b["x_offsets"], b["scales"]], axis=1).reshape(B, L, 3)[:, 1:]
            preds.append(p.reshape(-1, 3))
            tgts.append(t.reshape(-1, 3))
    preds, tgts = np.concatenate(preds), np.concatenate(tgts)
    corr = [float(np.corrcoef(preds[:, i], tgts[:, i])[0, 1]) for i in range(3)]
    log(f"  [scale] pred-target correlation dy={corr[0]:.3f} dx={corr[1]:.3f} ds={corr[2]:.3f}")

    video, boxes = make_scene(np.random.RandomState(1000), frames, scene="scale")
    H, W = video.shape[1:3]
    tr = StreamingTracker(cfg, exp.vgg_params, params, device=device)
    b0 = boxes[0]
    tr.init(video[0], (b0[1] * W, b0[0] * H, (b0[3] - b0[1]) * W, (b0[2] - b0[0]) * H))
    pred_area, gt_area = [], []
    for t in range(1, frames):
        _, _, w, h = tr.track(video[t])
        pred_area.append(w * h)
        gt = boxes[t]
        gt_area.append((gt[3] - gt[1]) * W * (gt[2] - gt[0]) * H)
    area_corr = float(np.corrcoef(pred_area, gt_area)[0, 1])
    log(f"  [scale] tracked-area vs gt-area corr on scale scene: {area_corr:.3f}")
    return {"corr_dy": round(corr[0], 3), "corr_dx": round(corr[1], 3), "corr_ds": round(corr[2], 3),
            "area_corr": round(area_corr, 3)}


def closed_loop_finetune(cfg, vgg, params, steps: int, device, frames: int) -> dict:
    """Fine-tune the trained cell in the closed loop (train/active_resize):
    each frame is recropped around the model's own previous prediction,
    so the ds supervision is the residual scale error that inference sees."""
    from ntm_tracker_tpu_torch.train.active_resize import ActiveResizeExperiment

    exp = ActiveResizeExperiment(cfg, vgg, device=device)
    ft_params = {"core": params}
    _, opt_state = exp.init(torch.Generator().manual_seed(9))
    opt_state = tree_map(torch.zeros_like, opt_state)  # a fresh optimizer, as the JAX tool's
    step = exp.make_train_step()
    rng = np.random.RandomState(7)
    B, L = cfg.train.batch_size, cfg.train.sequence_length
    H, W = 96, 160
    t0 = time.time()
    for i in range(steps):
        video = np.zeros((B, L, H, W, 3), np.float32)
        boxes = np.zeros((B, L, 4), np.float32)
        for b in range(B):
            video[b], boxes[b] = make_video(rng, L, (H, W), velocity=True, scale_walk=True)
        ft_params, opt_state, m = step(ft_params, opt_state, {"frames": video, "bboxes": boxes})
        if i % 50 == 0:
            log(f"  [closed-loop] step {i} loss {float(m['loss']):.4f}")
    log(f"  closed-loop fine-tuned {steps} steps in {time.time() - t0:.0f}s")
    return scene_ious(cfg, vgg, ft_params["core"], "closed-loop", device, frames)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("steps", nargs="?", type=int, default=400)
    ap.add_argument("scale_range", nargs="?", type=float, default=0.15)
    ap.add_argument("finetune", nargs="?", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: cuda; cpu runs the plain routes)")
    ap.add_argument("--eval_frames", type=int, default=40, help="frames of each evaluation clip (the JAX tool's 40)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    fused_parity(dev)
    vgg = init_vgg_params(torch.Generator().manual_seed(0), dev)
    log("=== offsets-only head (reference contract) ===")
    ref, _, _ = train_and_eval(False, vgg, args.steps, args.scale_range, dev, args.eval_frames)
    log("=== predict_scale head ===")
    scale, params_s, cfg_s = train_and_eval(True, vgg, args.steps, args.scale_range, dev, args.eval_frames)
    result = {"steps": args.steps, "scale_range": args.scale_range, "offsets_only": ref, "predict_scale": scale}
    if args.finetune:
        log("=== closed-loop fine-tune (predict_scale) ===")
        result["closed_loop"] = closed_loop_finetune(cfg_s, vgg, params_s, args.finetune, dev, args.eval_frames)
    log(f"launches: {json.dumps(kernel_launches())}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
