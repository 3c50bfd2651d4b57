"""Self-contained tracking demo on synthetic video: train briefly, then
track a held-out clip and report IoU (counterpart of
ntm_tracker_tpu/tracking/demo.py).

No dataset required: moving-bright-square clips (data/synthetic.py) make
reference-contract training batches (centered first-frame crop, one
transformation per sequence, per-frame Gaussian gt and center offsets,
the offline preprocessor's geometry); the offset pipeline trains on them,
then the streaming tracker (the per-frame recrop loop) tracks a fresh
clip.

    python -m ntm_tracker_tpu_torch.tracking.demo                  # on the card
    python -m ntm_tracker_tpu_torch.tracking.demo --train_steps 0  # untrained
    python -m ntm_tracker_tpu_torch.tracking.demo --device cpu --train_steps 30

The VGG is random and frozen unless --vgg_weights names a converted
checkpoint (.npz with slim names).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ntm_tracker_tpu_torch.config import (
    DataConfig,
    DNCConfig,
    NTMConfig,
    TrackerConfig,
    TrainConfig,
    resolve_device,
)
from ntm_tracker_tpu_torch.data import geometry
from ntm_tracker_tpu_torch.data.image_ops import crop_and_resize
from ntm_tracker_tpu_torch.data.synthetic import make_scene, make_video
from ntm_tracker_tpu_torch.models.core import make_core
from ntm_tracker_tpu_torch.models.vgg import VGG_MEAN
from ntm_tracker_tpu_torch.tracking.tracker import StreamingTracker, _to_device, make_device_track_step


def demo_config(crop_size: int = 64, core: str = "ntm", predict_scale: bool = False,
                scale_range: float = 0.15) -> TrackerConfig:
    """A small flagship-shaped config: crop 64, so conv4_3 is exactly the
    8x8 token grid (all 64 points), gt 8x8, NTM 64x12 (or the DNC twin),
    B=4, L=8. Shared with tools/track_artifact.py, so the artifact measures
    the demo's setup. predict_scale widens the head to (dy, dx, ds)."""
    g = crop_size // 8  # conv4_3's stride is 8
    out = 3 if predict_scale else 2
    return TrackerConfig(
        core=core,
        compute_dtype=torch.float32,
        ntm=NTMConfig(output_dim=out, mem_size=64, mem_dim=12, controller_hidden_size=100, read_head_size=4),
        dnc=DNCConfig(output_dim=out, memory_size=64, word_size=12, num_reads=4, num_writes=1, hidden_size=100),
        data=DataConfig(crop_size=crop_size, gt_width=g),
        train=TrainConfig(batch_size=4, sequence_length=8, learning_rate=1e-4),
        num_features=g * g,
        feature_points=tuple((y, x) for y in range(g) for x in range(g)),
        predict_scale=predict_scale,
        scale_range=scale_range,
    )


def _clip(seed: int, frames_n: int, scene: str):
    """The held-out clip of `seed`: (frames, boxes, (H, W), first region
    x, y, w, h in pixels)."""
    frames, boxes = make_scene(np.random.RandomState(seed + 1000), frames_n, scene=scene)
    H, W = frames.shape[1:3]
    b0 = boxes[0]
    return frames, boxes, (H, W), (b0[1] * W, b0[0] * H, (b0[3] - b0[1]) * W, (b0[2] - b0[0]) * H)


def _iou(region, gt, H: int, W: int) -> float:
    # per-frame values stay raw: bb_iou keeps the reference's unclamped
    # +1-area formula (test_tracker.py:59-83); means clamp
    # (mean_clamped_iou)
    x, y, w, h = region
    return geometry.bb_iou((x, y, x + w, y + h), (gt[1] * W, gt[0] * H, gt[3] * W, gt[2] * H))


def eval_streaming_iou(cfg, vgg, params, seed: int, frames_n: int, core=None, print_every: int = 0,
                       scene: str = "smooth", device=None):
    """A held-out synthetic clip through the streaming tracker (per-frame
    recrop); returns the per-frame IoUs. The one evaluation protocol
    behind the demo and the accuracy artifact. `scene` picks a clip variant
    (data/synthetic.SCENES). Runs on cuda unless `device` names another."""
    frames, boxes, (H, W), region0 = _clip(seed, frames_n, scene)
    tracker = StreamingTracker(cfg, vgg, params, core, device=device)
    tracker.init(frames[0], region0)
    ious = []
    for t in range(1, frames_n):
        ious.append(_iou(tracker.track(frames[t]), boxes[t], H, W))
        if print_every and t % print_every == 0:
            print(f"frame {t}: IoU {ious[-1]:.3f}")
    return ious


def eval_device_iou(cfg, vgg, params, seed: int, frames_n: int, core=None, scene: str = "smooth", loop=None,
                    device=None):
    """eval_streaming_iou's device-resident twin: the same clip through
    make_device_track_step (crop geometry, VGG, cell steps and recrop on
    the device). Returns the per-frame raw IoUs, so the gap between the
    two loops' mean_clamped_iou is the serving accuracy gap the artifact
    tripwires. `loop` is an optional prebuilt (init_fn, step_fn) from
    make_device_track_step, shared across scenes."""
    dev = resolve_device(device)
    frames, boxes, (H, W), (x, y, w, h) = _clip(seed, frames_n, scene)
    core = core or make_core(cfg)
    init_fn, step_fn = loop or make_device_track_step(cfg, core, vgg, params, device=dev)
    # the host loop's first region in the tracker's /(dim-1) normalization
    bbox = np.asarray([[y / (H - 1), x / (W - 1), (y + h) / (H - 1), (x + w) / (W - 1)]], np.float32)
    with torch.no_grad():
        state = _to_device(core.init_state(params, 1), dev)
    state = init_fn(frames[0:1], bbox, state)
    ious = []
    for t in range(1, frames_n):
        region, bbox, state = step_fn(frames[t:t + 1], bbox, state)
        ious.append(_iou(np.asarray(region[0].cpu()), boxes[t], H, W))
    return ious


def mean_clamped_iou(ious) -> float:
    """The aggregate-IoU contract (demo, artifacts, validation replay):
    per-frame values clamp to [0, 1] before the mean, so a disjoint frame
    counts 0 (not bb_iou's negative +1-area value) and a degenerate
    predicted box at most 1. Per-frame lists keep the raw values."""
    if not len(ious):
        return float("nan")
    return float(np.mean([min(1.0, max(0.0, i)) for i in ious]))


def training_batch(cfg, rng: np.random.RandomState, device=None):
    """A reference-contract batch from synthetic clips: centered
    first-frame cropbox, one transformation per sequence, per-frame
    Gaussian gt and center offsets (the preprocessor's geometry). The
    crops are cut on `device` (cuda unless named) with crop_and_resize
    after the mean is subtracted, the math of the streaming tracker's
    crop; they come back there as "images", the labels as numpy."""
    dev = resolve_device(device)
    d = cfg.data
    B, L = cfg.train.batch_size, cfg.train.sequence_length
    init_tb = geometry.initial_transformed_bbox(d.cropbox_grid, d.bbox_grid)
    images, crops, gts, yos, xos, dss = [], [], [], [], [], []
    for b in range(B):
        # the scale head needs clips whose box size moves; half the batch
        # keeps its size, so the head also learns ds = 0
        frames, boxes = make_video(rng, L, scale_walk=cfg.predict_scale and b % 2 == 0)
        cb = geometry.calculate_cropbox(boxes[0], d.cropbox_grid, d.bbox_grid)
        tf = geometry.calculate_transformation(cb)
        for t in range(L):
            tb = geometry.apply_transformation(boxes[t], tf)
            dy, dx = geometry.calculate_offsets(tb, init_tb)
            images.append(frames[t])
            crops.append(cb)
            gts.append(np.asarray(geometry.generate_gt(tb, d.gt_width, d.gt_width * d.bbox_grid / d.cropbox_grid),
                                  np.float32))
            yos.append(dy)
            xos.append(dx)
            if cfg.predict_scale:
                # inside tanh's reach: an 8-frame walk can pass scale_range
                dss.append(float(np.clip(geometry.calculate_scale(tb, init_tb) / cfg.scale_range, -0.95, 0.95)))
    boxes_a = np.stack(crops).astype(np.float32)
    batch = {
        "images": crop_frames(np.stack(images), boxes_a, d.crop_size, dev),
        "cropboxes": boxes_a,
        "gts": np.stack(gts),
        "y_offsets": np.asarray(yos, np.float32),
        "x_offsets": np.asarray(xos, np.float32),
    }
    if cfg.predict_scale:
        batch["scales"] = np.asarray(dss, np.float32)
    return batch


def crop_frames(frames: np.ndarray, cropboxes: np.ndarray, size: int, device) -> torch.Tensor:
    """Frames [n,H,W,3] and cropboxes [n,4] -> mean-subtracted crops
    [n,size,size,3] on `device`: the mean first, so out-of-image samples
    are 0 in network space, as in StreamingTracker's crop."""
    imgs = torch.as_tensor(frames, device=device).float() - torch.as_tensor(VGG_MEAN, device=device)
    boxes = torch.as_tensor(cropboxes, dtype=torch.float32, device=device)
    return crop_and_resize(imgs, boxes, (size, size))


def main(argv=None) -> int:
    from ntm_tracker_tpu_torch.models.vgg import init_vgg_params, load_params_npz
    from ntm_tracker_tpu_torch.train.experiments import OffsetExperiment

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--train_steps", type=int, default=400)
    ap.add_argument("--eval_frames", type=int, default=40)
    ap.add_argument("--crop_size", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: cuda; cpu runs the plain routes)")
    ap.add_argument("--core", default="ntm", choices=("ntm", "dnc"))
    ap.add_argument("--predict_scale", action="store_true",
                    help="the (dy, dx, ds) head: track the box's size too (trains on size-varying clips)")
    ap.add_argument("--eval_scene", default="smooth", help="synthetic eval clip (smooth|scale|fast|texture)")
    ap.add_argument("--vgg_weights", default="",
                    help="converted vgg16 .npz (slim names); default: a random frozen VGG, enough for the "
                         "synthetic demo")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = demo_config(args.crop_size, core=args.core, predict_scale=args.predict_scale)
    rng = np.random.RandomState(args.seed)
    vgg = (load_params_npz(args.vgg_weights, dev) if args.vgg_weights
           else init_vgg_params(torch.Generator().manual_seed(0), dev))
    exp = OffsetExperiment(cfg, vgg, image_mode="cropped", device=dev)
    params, opt_state = exp.init(torch.Generator().manual_seed(1))
    step = exp.make_train_step()
    for i in range(args.train_steps):
        params, opt_state, m = step(params, opt_state, training_batch(cfg, rng, dev))
        if i % 20 == 0 or i == args.train_steps - 1:
            print(f"train step {i}: loss {float(m['loss']):.4f}")

    ious = eval_streaming_iou(cfg, vgg, params, args.seed, args.eval_frames, print_every=10,
                              scene=args.eval_scene, device=dev)
    trained = f"trained {args.train_steps} steps" if args.train_steps else "untrained"
    print(f"mean IoU over {len(ious)} tracked frames: {mean_clamped_iou(ious):.3f} ({trained})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
