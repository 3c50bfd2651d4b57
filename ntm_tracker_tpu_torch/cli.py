"""Command-line interface of the port: `python -m ntm_tracker_tpu_torch
<command>` (counterpart of ntm_tracker_tpu/cli.py, with its flag names and
defaults).

  preprocess       <- preprocess.py (--augment: the repaired augmentation)
  mine-sequences   <- sequence_generator.py (generated_sequences.pkl)
  cache-features   the frozen VGG tokens of every frame record, once
  train-offsets    <- direct_offset_output.py (--core dnc gives
                      direct_offset_output_with_dnc.py); --feature_cache
                      trains on cached tokens

The JAX package's --platform is --device here: cuda unless the caller asks
for another (the CPU runs the plain PyTorch routes). A kernel that fails
to build or launch raises; no command moves to another route on its own.
The JAX package's other commands are not ported (ROADMAP.md, queue A), nor
are the flags of modules the port lacks: they raise naming their item.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from datetime import datetime

_NOT_PORTED = {
    # flag -> the ROADMAP item that ports its module
    "dist_coordinator": "A7", "dist_num_processes": "A7", "dist_process_id": "A7",
    "save_imgs": "A6/A8", "profile_steps": "A8", "shard": "A7",
}


def _refuse_unported(args) -> None:
    for flag, item in _NOT_PORTED.items():
        if getattr(args, flag, None) not in (None, False, ""):
            raise NotImplementedError(f"--{flag}: its module is not ported (ROADMAP.md, item {item})")


def _add_model_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--mem_size", type=int, default=128)
    p.add_argument("--mem_dim", type=int, default=20)
    p.add_argument("--hidden_size", type=int, default=200)
    p.add_argument("--num_layers", type=int, default=1)
    p.add_argument("--read_head_size", type=int, default=4)
    p.add_argument("--write_head_size", type=int, default=1)
    p.add_argument("--write_first", action="store_true")
    p.add_argument("--init_scale", type=float, default=0.05)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 matmul/conv compute (params stay fp32)")
    p.add_argument("--predict_scale", action="store_true",
                   help="the (dy,dx,ds) head: the tracker adapts the box's size "
                   "(output_dim 3; scale targets from the records' crop-space bboxes)")
    p.add_argument("--scale_range", type=float, default=0.15,
                   help="tanh->log-scale range for --predict_scale "
                   "(|log s| <= scale_range per prediction)")


def _add_train_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--num_epochs", type=int, default=1)
    p.add_argument("--sequence_length", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--max_gradient_norm", type=float, default=5.0)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--decay", type=float, default=0.95)
    p.add_argument("--log_dir", default="./log")
    p.add_argument("--tag", default="")
    p.add_argument("--ckpt_path", default="",
                   help="a checkpoint directory (<log dir>/ckpt) to resume "
                   "params and optimizer state from, at its latest step")
    p.add_argument("--log_interval", type=int, default=10)
    p.add_argument("--validation_interval", type=int, default=100)
    p.add_argument("--validation_batch", type=int, default=1)
    p.add_argument("--gt_width", type=int, default=8)
    p.add_argument("--reverse_image", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--dist_coordinator", default=None, help="not ported (ROADMAP.md, item A7)")
    p.add_argument("--dist_num_processes", type=int, default=None, help="not ported (ROADMAP.md, item A7)")
    p.add_argument("--dist_process_id", type=int, default=None, help="not ported (ROADMAP.md, item A7)")
    p.add_argument("--profile_steps", default="", help="not ported (ROADMAP.md, item A8)")


def _centered_grid(gw: int):
    """The stride-2 token grid of side gw centered on the 28x28 conv4_3 map
    (the reference's 7x7/8x8 heatmap variants, main.py:54,80)."""
    start = (28 - 2 * (gw - 1)) // 2
    return tuple((start + 2 * y, start + 2 * x) for y in range(gw) for x in range(gw))


def _tracker_config(args, core: str):
    import torch

    from ntm_tracker_tpu_torch.config import DataConfig, DNCConfig, NTMConfig, TrackerConfig, TrainConfig

    gw = getattr(args, "gt_width", 8)
    grid_kwargs = {} if gw == 8 else {"num_features": gw * gw, "feature_points": _centered_grid(gw)}
    predict_scale = getattr(args, "predict_scale", False)
    out_dim = 3 if predict_scale else 2
    return TrackerConfig(
        core=core,
        **grid_kwargs,
        data=DataConfig(gt_width=gw),
        compute_dtype=torch.bfloat16 if getattr(args, "bf16", False) else torch.float32,
        predict_scale=predict_scale,
        scale_range=getattr(args, "scale_range", TrackerConfig.scale_range),
        ntm=NTMConfig(
            output_dim=out_dim, mem_size=args.mem_size, mem_dim=args.mem_dim,
            controller_hidden_size=args.hidden_size, controller_num_layers=args.num_layers,
            read_head_size=args.read_head_size, write_head_size=args.write_head_size,
            write_first=args.write_first, init_scale=args.init_scale,
        ),
        dnc=DNCConfig(
            output_dim=out_dim, memory_size=args.mem_size, word_size=args.mem_dim,
            num_reads=args.read_head_size, num_writes=args.write_head_size, hidden_size=args.hidden_size,
        ),
        train=TrainConfig(
            batch_size=args.batch_size, sequence_length=args.sequence_length,
            learning_rate=args.learning_rate, decay=args.decay, momentum=args.momentum,
            max_gradient_norm=args.max_gradient_norm, num_epochs=args.num_epochs,
            log_interval=args.log_interval, validation_interval=args.validation_interval,
            validation_batch=args.validation_batch, seed=args.seed,
        ),
    )


def _load_vgg(args, device):
    """VGG params from --vgg_weights (.npz with slim names, or a torchvision
    vgg16 state dict), else a random init (a warning on stderr)."""
    import torch

    from ntm_tracker_tpu_torch.models import vgg

    path = getattr(args, "vgg_weights", "")
    if path.endswith(".npz"):
        return vgg.load_params_npz(path, device)
    if path:
        return vgg.load_params_torch(torch.load(path, map_location="cpu", weights_only=True), device)
    print("WARNING: no --vgg_weights given; using random VGG init", file=sys.stderr)
    return vgg.init_vgg_params(torch.Generator().manual_seed(0), device)


def _sequence_dirs(sequences_dir: str):
    return [os.path.join(sequences_dir, x) for x in sorted(os.listdir(sequences_dir))
            if os.path.isdir(os.path.join(sequences_dir, x))]


def train_offsets(args) -> dict:
    """The train-offsets command's body. Returns what the run did: steps,
    the log dir, the train loop's seconds, the seconds the loop waited on
    the prefetcher for each batch, and the host clock at each train step's
    start."""
    import torch

    from ntm_tracker_tpu_torch.config import resolve_device
    from ntm_tracker_tpu_torch.data.loader import PrefetchIterator, batch_iterator
    from ntm_tracker_tpu_torch.data.sequences import get_valid_sequences
    from ntm_tracker_tpu_torch.train.experiments import OffsetExperiment
    from ntm_tracker_tpu_torch.train.harness import CheckpointManager, train_loop

    _refuse_unported(args)
    dev = resolve_device(args.device)
    cfg = _tracker_config(args, args.core)
    real_log_dir = os.path.abspath(os.path.join(args.log_dir, str(datetime.now()) + args.tag))
    print("real log dir:", real_log_dir)

    feature_cache = args.feature_cache
    if feature_cache:
        # tokens come from the cache; VGG weights only verify its fingerprint
        vgg_params = _load_vgg(args, dev) if args.vgg_weights else None
        if vgg_params is None:
            print("NOTE: feature-cache training without --vgg_weights; cache fingerprint trusted from the manifest")
    else:
        vgg_params = _load_vgg(args, dev)
    dev_resize = args.device_resize
    if dev_resize and args.reverse_image:
        print("NOTE: --reverse_image flips before the resize on the raw "
              "path (TF1 grid is not flip-equivariant); using host resize")
        dev_resize = False
    exp = OffsetExperiment(cfg, vgg_params, image_mode="raw" if dev_resize else "resized", device=dev)
    if feature_cache:
        from ntm_tracker_tpu_torch.data.feature_cache import verify_cache

        verify_cache(exp.cfg, feature_cache, flip=args.reverse_image, vgg_params=vgg_params)
    params, opt_state = exp.init(torch.Generator().manual_seed(cfg.train.seed))

    ckpt = CheckpointManager(os.path.join(real_log_dir, "ckpt"))
    if args.ckpt_path:
        restored = CheckpointManager(args.ckpt_path).restore(
            template={"params": params, "opt_state": opt_state}, map_location="cpu")
        params, opt_state = restored["params"], restored["opt_state"]
        print("restored from", args.ckpt_path)

    _, train_seqs, val_seqs = get_valid_sequences(args.sequences_dir, cfg.train.sequence_length)
    if args.limit > 0:
        train_seqs, val_seqs = train_seqs[:args.limit], val_seqs[:args.limit]
        print(f"--limit {args.limit}: {len(train_seqs)} train / {len(val_seqs)} val sequences kept")
    print(f"{len(train_seqs)} train seqs, {len(val_seqs)} val seqs")
    bs = cfg.train.batch_size
    grids = dict(cropbox_grid=cfg.data.cropbox_grid, bbox_grid=cfg.data.bbox_grid)

    def put(batch):
        """A host batch (a TokenBatch or a FrameBatch) as tensors on the
        device, run in the prefetch worker: cached tokens go as stored
        (float16), frames as decoded (uint8 raw, float32 resized on the
        host); the experiment casts to float32 on the device."""
        b = batch._asdict()
        scales = b.pop("scales")
        if cfg.predict_scale:
            b["scales"] = scales / cfg.scale_range
        return {k: torch.as_tensor(v).to(dev) for k, v in b.items()}

    if feature_cache:
        from ntm_tracker_tpu_torch.data.feature_cache import token_batch_iterator

        def host_batches(seqs, epochs):
            return token_batch_iterator(seqs, bs, feature_cache, args.gt_width, shuffle=True, seed=cfg.train.seed,
                                        reverse_image=args.reverse_image, epochs=epochs, **grids)
    else:
        def host_batches(seqs, epochs):
            return batch_iterator(seqs, bs, args.gt_width, shuffle=True, seed=cfg.train.seed,
                                  reverse_image=args.reverse_image, epochs=epochs,
                                  decode_resize_hw=None if dev_resize else tuple(cfg.data.resize_hw), **grids)

    train_it = PrefetchIterator(host_batches(train_seqs, cfg.train.num_epochs), prefetch=2, device_put=put)
    step = exp.make_train_step()
    step_starts = []

    def timed_step(p, s, b):
        step_starts.append(time.perf_counter())
        return step(p, s, b)

    t0 = time.perf_counter()
    params, opt_state, steps = train_loop(
        timed_step, exp.make_eval_step(), params, opt_state, train_it,
        lambda: (put(b) for b in host_batches(val_seqs, 1)),
        log_dir=real_log_dir,
        validation_interval=cfg.train.validation_interval,
        validation_batch=cfg.train.validation_batch,
        log_interval=cfg.train.log_interval,
        checkpoint=ckpt,
    )
    ckpt.save(steps, {"params": params, "opt_state": opt_state})
    train_s = time.perf_counter() - t0
    print(f"trained {steps} steps; final checkpoint in {real_log_dir}/ckpt")
    return {"steps": steps, "log_dir": real_log_dir, "train_s": train_s,
            "waits": train_it.waits, "step_starts": step_starts}


def cmd_train_offsets(args) -> int:
    train_offsets(args)
    return 0


def cmd_preprocess(args) -> int:
    from ntm_tracker_tpu_torch.config import DataConfig
    from ntm_tracker_tpu_torch.data.preprocess import PreprocessJob, run_preprocess

    job = PreprocessJob(
        annotation_dir=args.annotation_dir,
        image_dir=args.image_dir,
        output_dir=args.output_dir,
        data=DataConfig(
            cropbox_grid=args.cropbox_grid, bbox_grid=args.bbox_grid,
            focus=args.focus, deform_threshold=args.deform_threshold,
            zoom_threshold=args.zoom_threshold,
        ),
    )
    if args.augment:
        from ntm_tracker_tpu_torch.data.augment import run_preprocess_augmented

        n = run_preprocess_augmented(job, seq_length=args.max_sequence_length, seed=args.augment_seed,
                                     num_workers=args.num_workers, limit=args.limit)
    else:
        n = run_preprocess(job, num_workers=args.num_workers, limit=args.limit)
    print(f"generated {n} frames")
    return 0


def cmd_mine_sequences(args) -> int:
    """Annotations -> prior-box IoU matching -> generated_sequences.pkl
    (sequence_generator.py main)."""
    from ntm_tracker_tpu_torch.data.mining import mine_and_dump

    seqs = mine_and_dump(
        args.image_dirs.split(","), args.annotation_dirs.split(","),
        out_path=args.output_pickle, iou_threshold=args.iou_threshold,
        num_workers=args.num_workers, layers=args.layers.split(","),
    )
    print(f"generated {len(seqs)} sequences -> {args.output_pickle}")
    return 0


def cache_features(args) -> list:
    """The cache-features command's body: the frozen VGG tokens of every
    frame record (and, with --reverse_image, of the flipped frames) on
    --device. Returns the manifests."""
    import torch

    from ntm_tracker_tpu_torch.config import TrackerConfig, resolve_device
    from ntm_tracker_tpu_torch.data.feature_cache import build_feature_cache

    _refuse_unported(args)
    dev = resolve_device(args.device)
    cfg = TrackerConfig(compute_dtype=torch.bfloat16 if args.bf16 else torch.float32)
    if args.grid_width != 8:
        gw = args.grid_width
        cfg = dataclasses.replace(cfg, num_features=gw * gw, feature_points=_centered_grid(gw))
    vgg_params = _load_vgg(args, dev)
    seq_dirs = _sequence_dirs(args.sequences_dir)
    manifests = []
    for flip in [False] + ([True] if args.reverse_image else []):
        man = build_feature_cache(
            cfg, vgg_params, seq_dirs, args.cache_dir, flip=flip, store_dtype=args.store_dtype,
            frames_per_batch=args.frames_per_batch, gt_width=args.gt_width, device=dev,
            progress=lambda done, total: print(f"\r{'flip' if flip else 'base'}: {done}/{total} frames",
                                               end="", flush=True),
        )
        print(f"\n{man['num_frames']} frames cached ({man['store_dtype']}, fingerprint {man['fingerprint']})")
        manifests.append(man)
    return manifests


def cmd_cache_features(args) -> int:
    cache_features(args)
    return 0


def build_parser() -> argparse.ArgumentParser:
    from ntm_tracker_tpu_torch.config import DataConfig

    p = argparse.ArgumentParser(prog="ntm_tracker_tpu_torch")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, or cpu for the plain PyTorch routes)")
    sub = p.add_subparsers(dest="command", required=True)

    t = sub.add_parser("train-offsets", help="primary tracker training")
    _add_model_flags(t)
    _add_train_flags(t)
    t.add_argument("--core", choices=["ntm", "dnc"], default="ntm")
    t.add_argument("--sequences_dir", required=True)
    t.add_argument("--vgg_weights", default="", help=".npz (slim names) or a torchvision vgg16 state dict")
    t.add_argument("--save_imgs", action="store_true", help="not ported (ROADMAP.md, items A6/A8)")
    t.add_argument("--device_resize", action="store_true",
                   help="ship native-size uint8 frames and do the 720x1280 "
                   "TF1 resize on the device (same sampling, less "
                   "host->device transfer; needs uniform frame sizes per batch)")
    t.add_argument("--feature_cache", default="",
                   help="train from precomputed VGG tokens (cache-features) "
                   "instead of decoding+convolving frames every step; "
                   "--vgg_weights then only verifies the cache fingerprint")
    t.add_argument("--limit", type=int, default=0,
                   help="dress rehearsal: keep only the first N train and val sequences (0 = all)")
    t.set_defaults(fn=cmd_train_offsets)

    cf = sub.add_parser(
        "cache-features",
        help="precompute the frozen VGG tokens of a cropped dataset for "
        "train-offsets --feature_cache (compute them once, not every step)",
    )
    cf.add_argument("--sequences_dir", required=True)
    cf.add_argument("--cache_dir", required=True)
    cf.add_argument("--vgg_weights", default="")
    cf.add_argument("--gt_width", type=int, default=8)
    cf.add_argument("--grid_width", type=int, default=8,
                    help="token grid side: 8 = the canonical conv43Points "
                    "grid; 7 = the centered stride-2 grid of --gt_width 7")
    cf.add_argument("--store_dtype", choices=["float16", "float32"], default="float16",
                    help="on-disk token dtype (float16 halves size; tokens "
                    "are bounded ReLU activations, well inside f16 range)")
    cf.add_argument("--frames_per_batch", type=int, default=256, help="frames per VGG call")
    cf.add_argument("--reverse_image", action="store_true",
                    help="also cache the horizontally-flipped variant (needed to train with --reverse_image)")
    cf.add_argument("--shard", action="store_true", help="not ported (ROADMAP.md, item A7)")
    cf.add_argument("--bf16", action="store_true",
                    help="bfloat16 VGG compute for the sweep (match the training flag you plan to use)")
    cf.set_defaults(fn=cmd_cache_features)

    pp = sub.add_parser("preprocess", help="build the cropped dataset")
    pp.add_argument("--annotation_dir", required=True)
    pp.add_argument("--image_dir", required=True)
    pp.add_argument("--output_dir", required=True)
    pp.add_argument("--cropbox_grid", type=int, default=DataConfig.cropbox_grid)
    pp.add_argument("--bbox_grid", type=int, default=DataConfig.bbox_grid)
    pp.add_argument("--focus", type=int, default=DataConfig.focus)
    pp.add_argument("--deform_threshold", type=float, default=DataConfig.deform_threshold)
    pp.add_argument("--zoom_threshold", type=float, default=DataConfig.zoom_threshold)
    pp.add_argument("--num_workers", type=int, default=7)
    pp.add_argument("--augment", action="store_true",
                    help="write dilated/jittered augmented sub-sequences "
                    "instead of the plain per-object walk")
    pp.add_argument("--max_sequence_length", type=int, default=20, help="frames per augmented sub-sequence")
    pp.add_argument("--augment_seed", type=int, default=0)
    pp.add_argument("--limit", type=int, default=0,
                    help="dress rehearsal: process only the first N sequence dirs (0 = all)")
    pp.set_defaults(fn=cmd_preprocess)

    ms = sub.add_parser("mine-sequences",
                        help="mine single-object subsequences from VID annotations into generated_sequences.pkl")
    ms.add_argument("--image_dirs", required=True, help="comma-separated image roots")
    ms.add_argument("--annotation_dirs", required=True, help="comma-separated annotation roots")
    ms.add_argument("--output_pickle", default="generated_sequences.pkl")
    ms.add_argument("--iou_threshold", type=float, default=0.5)
    ms.add_argument("--layers", default="conv4_3", help="comma-separated prior grids to match (conv4_3, pool5, ...)")
    ms.add_argument("--num_workers", type=int, default=7)
    ms.set_defaults(fn=cmd_mine_sequences)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
