"""Command-line interface of the port: `python -m ntm_tracker_tpu_torch
<command>` (counterpart of ntm_tracker_tpu/cli.py, with its flag names and
defaults).

  preprocess            <- preprocess.py (--augment: the repaired augmentation)
  mine-sequences        <- sequence_generator.py (generated_sequences.pkl)
  cache-features        the frozen VGG tokens of every frame record, once
  train-offsets         <- direct_offset_output.py (--core dnc gives
                           direct_offset_output_with_dnc.py); --feature_cache
                           trains on cached tokens; --save_imgs writes the
                           memory dashboards (and the crops' grid) at each
                           validation
  train-heatmap         <- main.py's ntm_sevenbyseven / ntm_8by8 / ntm_sequential
  train-wholeframe      <- main.py's ntm() / ntm_two_step()
  train-active-resize   the completed ntm_active_resize (main.py:1294-1422)
  lstm-only             <- main.py's lstm_only()
  sanity-check          <- main.py's sanity_check_compressor (+ PCA, + trained)
  copy-paste            <- main.py's copy_paste()
  dnc-repeat-copy       <- dnc/train.py
  find-validation-batch <- main.py:2299-2320
  inspect-batch         <- the reference's --test_input / --test_read_imgs
  track-vot             VOT-protocol tracking (file mode, native TraX over
                        stdin/stdout, or the trax package); --serving_npz
                        serves an exported artifact
  validate              replay pickled validation sequences (--fleet N
                        batches them; --serving_npz through an artifact)
  convert-vgg           the slim vgg_16.ckpt -> .npz (needs tensorflow)
  convert-ntm           a reference NTM training checkpoint -> .npz
  convert-dnc           a reference DNC training checkpoint -> .npz
  export-serving        the frame step as torch.export programs in one .npz
  bench                 the headline benchmark (benchmarks.py): one JSON line

The JAX package's --platform is --device here: cuda unless the caller asks
for another (the CPU runs the plain PyTorch routes). A kernel that fails
to build or launch raises; no command moves to another route on its own.
In trax mode track-vot's stdout is the protocol's: everything else goes to
stderr.

train-offsets and train-heatmap train data-parallel over torch.distributed
with --dist_coordinator/--dist_num_processes/--dist_process_id (or
NTM_DIST_AUTO=1 under torchrun): one process per GPU, where the JAX
package runs one process over all of a host's chips.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from datetime import datetime

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
    # data parallelism (train-offsets, train-heatmap): one process per GPU;
    # batch_size is the GLOBAL batch, each rank loads batch_size / world
    p.add_argument("--dist_coordinator", default=None,
                   help="coordinator host:port for torch.distributed's process group "
                   "(omit for one process, or set NTM_DIST_AUTO=1 under torchrun)")
    p.add_argument("--dist_num_processes", type=int, default=None)
    p.add_argument("--dist_process_id", type=int, default=None)
    p.add_argument("--profile_steps", default="",
                   help="trace train steps START:STOP with torch.profiler into <log dir>/profile "
                   "(a Chrome/Perfetto trace file)")


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
        vgg_int8=getattr(args, "vgg_int8", False),
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


def _log_dir(args) -> str:
    """The run's log directory: --log_dir/<now><--tag>."""
    return os.path.abspath(os.path.join(args.log_dir, str(datetime.now()) + args.tag))


def _make_experiment(args, cfg, vgg_params, device, device_resize: bool = False):
    """The experiment of a training command: the offsets tracker, or the
    heatmap variants (train-heatmap: output_dim 1 for the sequential stream,
    num_features for the frame stream)."""
    from ntm_tracker_tpu_torch.train.experiments import HeatmapExperiment, OffsetExperiment

    # the host path resizes with the TF1 grid; --device_resize ships raw
    # frames and runs the same grid on the device
    mode = "raw" if device_resize else "resized"
    if getattr(args, "experiment", "offsets") == "offsets":
        return OffsetExperiment(cfg, vgg_params, image_mode=mode, device=device)
    serialization = args.serialization
    out_dim = 1 if serialization == "sequential" else cfg.num_features
    cfg = dataclasses.replace(cfg, ntm=dataclasses.replace(cfg.ntm, output_dim=out_dim),
                              dnc=dataclasses.replace(cfg.dnc, output_dim=out_dim))
    return HeatmapExperiment(cfg, vgg_params, image_mode=mode, device=device, serialization=serialization,
                             compress_dim=args.compress_dim)


def _dashboard_eval(exp, cfg, args, real_log_dir: str):
    """The --save_imgs eval step: one forward (eval_with_views) serves the
    validation loss and the memory dashboards, written at each validation
    batch; batches with frames also get the crops / gt offsets /
    predictions grid (the reference wrote one every step,
    direct_offset_output.py:348)."""
    import numpy as np

    from ntm_tracker_tpu_torch.models.vgg import VGG_MEAN
    from ntm_tracker_tpu_torch.utils.viz import save_imgs, save_memory_panels

    read_heads = cfg.ntm.read_head_size if args.core == "ntm" else cfg.dnc.num_reads
    counter = {"n": 0}

    def eval_step(params, batch):
        aux, views = exp.eval_with_views(params, batch)
        save_memory_panels(views, read_heads, f"step_{counter['n']}_memory", real_log_dir)
        if "pred_offsets" in aux and "images" in batch:
            L = cfg.train.sequence_length
            crops = exp.images_to_crops(batch["images"], batch["cropboxes"]).cpu().numpy() + VGG_MEAN
            B, sz = crops.shape[0] // L, crops.shape[1]
            offsets = np.stack([batch["y_offsets"].cpu().numpy(), batch["x_offsets"].cpu().numpy()],
                               -1).reshape(B, L, 2)
            preds = np.concatenate([np.zeros((B, 1, 2)), aux["pred_offsets"].cpu().numpy()], axis=1)
            save_imgs([np.clip(crops, 0, 255).astype(np.uint8).reshape(B, L, sz, sz, 3), offsets, preds],
                      f"step_{counter['n']}_validation", real_log_dir)
        counter["n"] += 1
        return aux

    return eval_step


class _NoLogger:
    """The metrics logger of a rank that is not rank 0: it writes nothing."""

    def log(self, step: int, **scalars):
        pass


def train_offsets(args) -> dict:
    """The train-offsets and train-heatmap commands' body. Returns what the
    run did: steps, the log dir, the train loop's seconds, the seconds the
    loop waited on the prefetcher for each batch, and the host clock at
    each train step's start.

    Data parallel when --dist_* (or NTM_DIST_AUTO=1) makes a process
    group: the group starts before anything touches the card; each rank
    trains on its own shard of the sequences at batch_size / world rows,
    on its own device with its own prefetcher; the step sums the ranks'
    gradients (parallel/mesh.parallel_train_step) and the validation loss
    is summed over the group as well. Rank 0 writes the logs and
    checkpoints; every rank restores --ckpt_path."""
    import torch.distributed as dist

    from ntm_tracker_tpu_torch.parallel.distributed import initialize_distributed, rank_device

    started_group = not dist.is_initialized()
    initialize_distributed(args.dist_coordinator, args.dist_num_processes, args.dist_process_id,
                           device=args.device)
    started_group = started_group and dist.is_initialized()
    try:
        return _train_offsets(args, rank_device(args.device) if dist.is_initialized() else None)
    finally:
        if started_group:
            dist.destroy_process_group()


def _train_offsets(args, rank_dev) -> dict:
    import torch
    import torch.distributed as dist

    from ntm_tracker_tpu_torch.config import resolve_device
    from ntm_tracker_tpu_torch.data.loader import PrefetchIterator, batch_iterator, device_batch
    from ntm_tracker_tpu_torch.data.sequences import get_valid_sequences
    from ntm_tracker_tpu_torch.parallel.distributed import process_shard_sequences
    from ntm_tracker_tpu_torch.parallel.mesh import Mesh, parallel_train_step
    from ntm_tracker_tpu_torch.train.harness import CheckpointManager, train_loop
    from ntm_tracker_tpu_torch.utils.profiling import parse_profile_steps

    profile_steps = parse_profile_steps(getattr(args, "profile_steps", ""))
    dev = resolve_device(args.device) if rank_dev is None else rank_dev
    group = dist.group.WORLD if dist.is_initialized() else None
    world = dist.get_world_size() if group is not None else 1
    rank = dist.get_rank() if group is not None else 0
    lead = rank == 0
    cfg = _tracker_config(args, args.core)
    real_log_dir = _log_dir(args)
    print("real log dir:", real_log_dir)

    feature_cache = args.feature_cache
    if feature_cache:
        # tokens come from the cache; VGG weights only verify its fingerprint
        vgg_params = _load_vgg(args, dev) if args.vgg_weights else None
        if vgg_params is None:
            print("NOTE: feature-cache training without --vgg_weights; cache fingerprint trusted from the manifest")
    else:
        vgg_params = _load_vgg(args, dev)
    dev_resize = getattr(args, "device_resize", False)
    if dev_resize and args.reverse_image:
        print("NOTE: --reverse_image flips before the resize on the raw "
              "path (TF1 grid is not flip-equivariant); using host resize")
        dev_resize = False
    exp = _make_experiment(args, cfg, vgg_params, dev, dev_resize)
    if feature_cache:
        from ntm_tracker_tpu_torch.data.feature_cache import verify_cache

        # the experiment's config: train-heatmap's gt_width grid needs a
        # cache built with cache-features --grid_width to match
        verify_cache(exp.cfg, feature_cache, flip=args.reverse_image, vgg_params=vgg_params)
    params, opt_state = exp.init(torch.Generator().manual_seed(cfg.train.seed))

    ckpt = CheckpointManager(os.path.join(real_log_dir, "ckpt")) if lead else None
    if args.ckpt_path:
        restored = CheckpointManager(args.ckpt_path).restore(
            template={"params": params, "opt_state": opt_state}, map_location="cpu")
        params, opt_state = restored["params"], restored["opt_state"]
        print("restored from", args.ckpt_path)

    _, train_seqs, val_seqs = get_valid_sequences(args.sequences_dir, cfg.train.sequence_length)
    limit = getattr(args, "limit", 0)
    if limit > 0:
        train_seqs, val_seqs = train_seqs[:limit], val_seqs[:limit]
        print(f"--limit {limit}: {len(train_seqs)} train / {len(val_seqs)} val sequences kept")
    if world > 1:
        # a disjoint shard per rank, the global batch split evenly; the
        # validation set is optional, so a set smaller than the group
        # gives every rank an empty shard instead of killing the run
        train_seqs = process_shard_sequences(train_seqs)
        val_seqs = process_shard_sequences(val_seqs, allow_empty=True)
        if cfg.train.batch_size % world:
            raise SystemExit(f"--batch_size {cfg.train.batch_size} must divide by the {world} processes")
    bs = cfg.train.batch_size // world
    print(f"{len(train_seqs)} train seqs, {len(val_seqs)} val seqs"
          + (f" (process {rank}/{world})" if world > 1 else ""))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if dev.type == "cuda" and torch.cuda.device_count() > local_world:
        print(f"NOTE: using {local_world}/{torch.cuda.device_count()} GPUs: the port trains on one GPU a "
              "process; start one process per GPU (torchrun, --dist_*) to use them all")
    grids = dict(cropbox_grid=cfg.data.cropbox_grid, bbox_grid=cfg.data.bbox_grid)

    def put(batch):
        return device_batch(batch, dev, cfg.predict_scale, cfg.scale_range)

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
    step = parallel_train_step(exp, Mesh((dev,), group))
    eval_local = (_dashboard_eval(exp, exp.cfg, args, real_log_dir) if getattr(args, "save_imgs", False) and lead
                  else exp.make_eval_step())

    def eval_step(p, b):
        aux = eval_local(p, b)
        if group is not None:
            # the global batch's loss: the sum of the ranks'
            loss = aux["loss"].detach().clone()
            dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=group)
            aux = {**aux, "loss": loss}
        return aux

    step_starts = []

    def timed_step(p, s, b):
        step_starts.append(time.perf_counter())
        return step(p, s, b)

    t0 = time.perf_counter()
    params, opt_state, steps = train_loop(
        timed_step, eval_step, params, opt_state, train_it,
        lambda: (put(b) for b in host_batches(val_seqs, 1)),
        log_dir=real_log_dir,
        validation_interval=cfg.train.validation_interval,
        validation_batch=cfg.train.validation_batch,
        log_interval=cfg.train.log_interval,
        checkpoint=ckpt,
        logger=None if lead else _NoLogger(),
        profile_steps=profile_steps if lead else None,
    )
    if lead:
        ckpt.save(steps, {"params": params, "opt_state": opt_state})
        print(f"trained {steps} steps; final checkpoint in {real_log_dir}/ckpt")
    train_s = time.perf_counter() - t0
    return {"steps": steps, "log_dir": real_log_dir, "train_s": train_s,
            "waits": train_it.waits, "step_starts": step_starts, "rank": rank, "world": world,
            "backend": dist.get_backend() if group is not None else None,
            "profile_dir": os.path.join(real_log_dir, "profile") if profile_steps and lead else None}


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

    dev = resolve_device(args.device)
    cfg = TrackerConfig(compute_dtype=torch.bfloat16 if args.bf16 else torch.float32)
    if args.grid_width != 8:
        gw = args.grid_width
        cfg = dataclasses.replace(cfg, num_features=gw * gw, feature_points=_centered_grid(gw))
    vgg_params = _load_vgg(args, dev)
    seq_dirs = _sequence_dirs(args.sequences_dir)
    mesh = None
    if args.shard:
        from ntm_tracker_tpu_torch.parallel.mesh import local_devices, make_mesh

        devices = local_devices(dev)
        mesh = make_mesh(devices, batch_size=args.frames_per_batch)
        print(f"sharding the build over {mesh.size} of {len(devices)} devices")
    manifests = []
    for flip in [False] + ([True] if args.reverse_image else []):
        man = build_feature_cache(
            cfg, vgg_params, seq_dirs, args.cache_dir, flip=flip, store_dtype=args.store_dtype,
            frames_per_batch=args.frames_per_batch, gt_width=args.gt_width, device=dev, mesh=mesh,
            progress=lambda done, total: print(f"\r{'flip' if flip else 'base'}: {done}/{total} frames",
                                               end="", flush=True),
        )
        print(f"\n{man['num_frames']} frames cached ({man['store_dtype']}, fingerprint {man['fingerprint']})")
        manifests.append(man)
    return manifests


def cmd_cache_features(args) -> int:
    cache_features(args)
    return 0


def _restore_params(ckpt_path: str, params):
    """The params of a checkpoint at its latest step (the optimizer state
    left out: the weights-only restore)."""
    from ntm_tracker_tpu_torch.train.harness import CheckpointManager

    return CheckpointManager(ckpt_path).restore(template={"params": params}, partial=True)["params"]


def _pickle_epoch_loop(args, cfg, seqs, make_batch, step, params, opt_state, ckpt, real_log_dir) -> dict:
    """The shuffle / step / log / checkpoint epoch loop of the pickle-dataset
    trainers (the reference's train_and_val shape, main.py:603-693).
    make_batch(index, seqs) -> (device batch, new index). Returns the steps,
    the losses, the host clock at each step's start and the log dir."""
    import random as _random

    rng = _random.Random(cfg.train.seed)
    stepno, losses, starts = 0, [], []
    B = cfg.train.batch_size
    for _epoch in range(cfg.train.num_epochs):
        rng.shuffle(seqs)
        index = 0
        usable = len(seqs) // B * B
        while index < usable:
            batch, index = make_batch(index, seqs)
            starts.append(time.perf_counter())
            params, opt_state, m = step(params, opt_state, batch)
            losses.append(float(m["loss"]))
            if stepno % args.log_interval == 0:
                print(f"{stepno}: loss {losses[-1]:.5f}")
            if stepno and stepno % args.validation_interval == 0:
                ckpt.save(stepno, {"params": params, "opt_state": opt_state})
            stepno += 1
    ckpt.save(stepno, {"params": params, "opt_state": opt_state})
    print(f"trained {stepno} steps; checkpoint in {real_log_dir}/ckpt")
    return {"steps": stepno, "losses": losses, "step_starts": starts, "log_dir": real_log_dir}


def train_wholeframe(args) -> dict:
    """train-wholeframe: ntm()/ntm_two_step() on the pickled mined dataset
    (main.py:780-977, default_get_batch)."""
    import torch

    from ntm_tracker_tpu_torch.config import resolve_device
    from ntm_tracker_tpu_torch.data.pickle_dataset import (
        default_get_batch,
        load_generated_sequences,
        load_wholeframe_batch,
    )
    from ntm_tracker_tpu_torch.train.experiments import WholeFrameExperiment
    from ntm_tracker_tpu_torch.train.harness import CheckpointManager

    dev = resolve_device(args.device)
    cfg = _tracker_config(args, "ntm")
    exp = WholeFrameExperiment(cfg, _load_vgg(args, dev), endpoint=args.feature_layer, two_step=args.two_step,
                               compress_dim=args.compress_dim, device=dev)
    params, opt_state = exp.init(torch.Generator().manual_seed(cfg.train.seed))
    real_log_dir = _log_dir(args)
    ckpt = CheckpointManager(os.path.join(real_log_dir, "ckpt"))
    if args.ckpt_path:
        params = _restore_params(args.ckpt_path, params)
    seqs = load_generated_sequences(args.pickle_path, cfg.train.sequence_length)
    print(f"{len(seqs)} sequences after length filtering")

    def make_batch(index, seqs):
        frame_names, gts, index = default_get_batch(index, cfg.train.batch_size, cfg.train.sequence_length, seqs)
        images = load_wholeframe_batch(frame_names, cfg.data.crop_size)
        return {"images": torch.as_tensor(images, device=dev), "gts": torch.as_tensor(gts, device=dev)}, index

    return _pickle_epoch_loop(args, cfg, seqs, make_batch, exp.make_train_step(), params, opt_state, ckpt,
                              real_log_dir)


def cmd_train_wholeframe(args) -> int:
    train_wholeframe(args)
    return 0


def train_active_resize(args) -> dict:
    """train-active-resize: closed-loop recrop training, the completed form
    of the reference's unfinished ntm_active_resize (main.py:1294-1422)."""
    import torch

    from ntm_tracker_tpu_torch.config import resolve_device
    from ntm_tracker_tpu_torch.data.pickle_dataset import (
        active_resize_get_batch,
        load_generated_sequences,
        load_wholeframe_batch,
    )
    from ntm_tracker_tpu_torch.train.active_resize import ActiveResizeExperiment
    from ntm_tracker_tpu_torch.train.harness import CheckpointManager

    dev = resolve_device(args.device)
    cfg = _tracker_config(args, "ntm")
    exp = ActiveResizeExperiment(cfg, _load_vgg(args, dev), compress_dim=args.compress_dim, device=dev)
    params, opt_state = exp.init(torch.Generator().manual_seed(cfg.train.seed))
    real_log_dir = _log_dir(args)
    ckpt = CheckpointManager(os.path.join(real_log_dir, "ckpt"))
    if args.ckpt_path:
        params = _restore_params(args.ckpt_path, params)
    seqs = load_generated_sequences(args.pickle_path, cfg.train.sequence_length)
    print(f"{len(seqs)} sequences after length filtering")
    B, L, S = cfg.train.batch_size, cfg.train.sequence_length, cfg.data.crop_size

    def make_batch(index, seqs):
        frame_names, boxes, index = active_resize_get_batch(index, B, L, seqs)
        frames = load_wholeframe_batch(frame_names, S)
        return {"frames": torch.as_tensor(frames.reshape(B, L, S, S, 3), device=dev),
                "bboxes": torch.as_tensor(boxes, device=dev)}, index

    return _pickle_epoch_loop(args, cfg, seqs, make_batch, exp.make_train_step(), params, opt_state, ckpt,
                              real_log_dir)


def cmd_train_active_resize(args) -> int:
    train_active_resize(args)
    return 0


def _frame_batch_tokens(cfg, vgg_params, fb, device):
    """A FrameBatch (host-resized frames) -> [B, L, F, C] frozen VGG tokens
    on `device`: preprocess_frame's crops, then frame_tokens."""
    import torch

    from ntm_tracker_tpu_torch.data.image_ops import preprocess_frame
    from ntm_tracker_tpu_torch.train.experiments import frame_tokens

    with torch.no_grad():
        crops = preprocess_frame(torch.as_tensor(fb.images, device=device).float(),
                                 torch.as_tensor(fb.cropboxes, device=device),
                                 resize_hw=cfg.data.resize_hw, crop_size=cfg.data.crop_size)
        feats = frame_tokens(cfg, vgg_params, crops)
    L = cfg.train.sequence_length
    return feats.reshape(feats.shape[0] // L, L, cfg.num_features, cfg.feature_depth)


def cmd_lstm_only(args) -> int:
    """lstm-only: the LSTM baseline on the heatmap task (main.py:695-778)."""
    import torch

    from ntm_tracker_tpu_torch.config import resolve_device
    from ntm_tracker_tpu_torch.data.loader import batch_iterator
    from ntm_tracker_tpu_torch.data.sequences import get_valid_sequences
    from ntm_tracker_tpu_torch.train.experiments import gradient_step
    from ntm_tracker_tpu_torch.train.optim import reference_optimizer
    from ntm_tracker_tpu_torch.train.zoo import (
        compress_features,
        init_compressor,
        init_lstm_baseline,
        lstm_baseline_loss,
    )

    dev = resolve_device(args.device)
    cfg = _tracker_config(args, "ntm")
    vgg_params = _load_vgg(args, dev)
    F = cfg.num_features
    gen = torch.Generator().manual_seed(cfg.train.seed)
    params = {
        "compressor": init_compressor(cfg.feature_depth, args.compress_dim, gen, dev),
        "lstm": init_lstm_baseline(F, args.compress_dim, args.hidden_size, args.num_layers, generator=gen, device=dev),
    }
    opt = reference_optimizer(args.learning_rate, args.decay, args.momentum, 1e-10, args.max_gradient_norm)

    def loss_fn(p, fb):
        feats = compress_features(_frame_batch_tokens(cfg, vgg_params, fb, dev), p["compressor"])
        gts = torch.as_tensor(fb.gts, device=dev).float().reshape(feats.shape[0], feats.shape[1], F)
        loss = lstm_baseline_loss(p["lstm"], feats, gts[:, 0, :], gts)
        return loss, {"loss": loss}

    step = gradient_step(loss_fn, opt)
    opt_state = opt.init(params)
    _, train_seqs, _ = get_valid_sequences(args.sequences_dir, cfg.train.sequence_length)
    for i, fb in enumerate(batch_iterator(train_seqs, cfg.train.batch_size, args.gt_width, seed=cfg.train.seed,
                                          epochs=cfg.train.num_epochs)):
        params, opt_state, m = step(params, opt_state, fb)
        if i % args.log_interval == 0:
            print(f"{i}: loss {float(m['loss']):.5f}")
    return 0


def _trained_compressor(ckpt_path: str, depth: int, compress_dim: int):
    """The compressor of a train-heatmap --compress_dim checkpoint (the
    sanity_check_trained dispatch, main.py:2608-2632), or SystemExit: when
    the checkpoint has none, or one of another width."""
    import numpy as np

    from ntm_tracker_tpu_torch.train.harness import CheckpointManager

    try:
        w = CheckpointManager(ckpt_path).restore(map_location="cpu")["params"]["compressor"]
    except (KeyError, TypeError, ValueError, FileNotFoundError) as e:
        raise SystemExit(f"--compressor_ckpt {ckpt_path} has no [{depth},{compress_dim}] compressor — was it "
                         f"trained with train-heatmap --compress_dim {compress_dim}? ({e})")
    want = (depth, compress_dim)
    if tuple(np.shape(w)) != want:
        raise SystemExit(f"--compressor_ckpt compressor shape {tuple(np.shape(w))} != {want} — it was trained "
                         f"with train-heatmap --compress_dim {np.shape(w)[-1]}, not {compress_dim}")
    return w


def cmd_sanity_check(args) -> int:
    """sanity-check: can the VGG features (raw, compressed by a trained
    compressor, or PCA'd) reproduce the gt heatmap by cosine similarity
    alone, with no training (main.py:1425-1538)? Writes the similarity-vs-gt
    PNG grid."""
    import numpy as np
    import torch

    from ntm_tracker_tpu_torch.config import resolve_device
    from ntm_tracker_tpu_torch.data.loader import load_frame_batch
    from ntm_tracker_tpu_torch.data.sequences import get_valid_sequences, sevenbyseven_get_batch
    from ntm_tracker_tpu_torch.train.zoo import sanity_check_pca, sanity_check_similarity
    from ntm_tracker_tpu_torch.utils.viz import save_imgs

    dev = resolve_device(args.device)
    cfg = _tracker_config(args, "ntm")
    if args.pca and args.compressor_ckpt:
        raise SystemExit("--pca and --compressor_ckpt are mutually exclusive")
    vgg_params = _load_vgg(args, dev)
    _, train_seqs, _ = get_valid_sequences(args.sequences_dir, cfg.train.sequence_length)
    frame_names, _ = sevenbyseven_get_batch(0, cfg.train.batch_size, train_seqs)
    fb = load_frame_batch(frame_names, args.gt_width)
    feats = _frame_batch_tokens(cfg, vgg_params, fb, dev)
    B, L, F = feats.shape[0], feats.shape[1], cfg.num_features
    gts = torch.as_tensor(fb.gts, device=dev).float().reshape(B, L, F)
    name = "sanity_check"
    if args.pca:
        sim = sanity_check_pca(feats.cpu().numpy(), gts, args.compress_dim)
    elif args.compressor_ckpt:
        w = _trained_compressor(args.compressor_ckpt, cfg.feature_depth, args.compress_dim)
        sim = sanity_check_similarity(feats, gts, compressor_w=w.to(dev))
        name = "sanity_check_trained"
    else:
        sim = sanity_check_similarity(feats, gts)
    side = int(round(F ** 0.5))

    def grid(x):
        return x.detach().cpu().numpy().reshape(B, L, side, side, 1) * 255.0

    print("similarity-vs-gt grid written to", save_imgs([grid(sim), grid(gts * F)], name, args.log_dir))
    return 0


def cmd_copy_paste(args) -> int:
    """copy-paste: the NTM copy-paste sanity training (main.py:1540-1644)."""
    import numpy as np
    import torch

    from ntm_tracker_tpu_torch.config import NTMConfig, resolve_device
    from ntm_tracker_tpu_torch.models.ntm_cell import init_ntm_params
    from ntm_tracker_tpu_torch.train.experiments import copy_paste_loss, gradient_step, make_copy_paste_batch
    from ntm_tracker_tpu_torch.train.optim import reference_optimizer

    dev = resolve_device(args.device)
    ncfg = NTMConfig(output_dim=args.width + 1, mem_size=args.mem_size, mem_dim=args.mem_dim,
                     controller_hidden_size=args.hidden_size, controller_num_layers=args.num_layers,
                     read_head_size=args.read_head_size, write_head_size=args.write_head_size,
                     write_first=args.write_first, init_scale=args.init_scale)
    params = init_ntm_params(ncfg, args.width + 1, torch.Generator().manual_seed(args.seed), dev)
    opt = reference_optimizer(args.learning_rate, args.decay, args.momentum, 1e-10, args.max_gradient_norm)

    def loss_fn(p, batch):
        loss = copy_paste_loss(p, ncfg, *batch)
        return loss, {"loss": loss}

    step, opt_state = gradient_step(loss_fn, opt), opt.init(params)
    rng = np.random.RandomState(args.seed)
    for epoch in range(args.num_epochs):
        x, y = make_copy_paste_batch(rng, args.batch_size, args.width, args.sequence_length)
        params, opt_state, m = step(params, opt_state, (torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)))
        print(f"{epoch}: loss {float(m['loss'])}")
    return 0


def cmd_dnc_repeat_copy(args) -> int:
    from ntm_tracker_tpu_torch.train.dnc_trainer import RepeatCopyTrainConfig, train_repeat_copy

    cfg = RepeatCopyTrainConfig(
        hidden_size=args.hidden_size, memory_size=args.memory_size, word_size=args.word_size,
        num_write_heads=args.num_write_heads, num_read_heads=args.num_read_heads, clip_value=args.clip_value,
        max_grad_norm=args.max_grad_norm, learning_rate=args.learning_rate,
        optimizer_epsilon=args.optimizer_epsilon, batch_size=args.batch_size, num_bits=args.num_bits,
        min_length=args.min_length, max_length=args.max_length, min_repeats=args.min_repeats,
        max_repeats=args.max_repeats, num_training_iterations=args.num_training_iterations,
        report_interval=args.report_interval, checkpoint_interval=args.checkpoint_interval,
        checkpoint_dir=args.checkpoint_dir, seed=args.seed,
    )
    train_repeat_copy(cfg, device=args.device)
    return 0


def cmd_find_validation_batch(args) -> int:
    from ntm_tracker_tpu_torch.train.zoo import find_validation_batch

    dump = f"validation_seqs_{args.target_step}.pkl"
    seqs = find_validation_batch(args.sequences_dir, target_step=args.target_step, batch_size=args.batch_size,
                                 min_length=args.sequence_length, validation_interval=args.validation_interval,
                                 seed=args.seed, dump_path=dump)
    print(f"dumped {len(seqs)} sequences to {dump}")
    return 0


def cmd_inspect_batch(args) -> int:
    """inspect-batch: the input pipeline's eyeball harness (the reference's
    --test_input / --test_read_imgs, direct_offset_output.py:227-241,
    main.py:321-341): one batch through the real loader, its record fields
    printed, a PNG grid of the crops, gt heatmaps and offsets written."""
    import numpy as np
    import torch

    from ntm_tracker_tpu_torch.config import DataConfig, resolve_device
    from ntm_tracker_tpu_torch.data.image_ops import preprocess_frame
    from ntm_tracker_tpu_torch.data.loader import batch_iterator
    from ntm_tracker_tpu_torch.data.sequences import get_valid_sequences
    from ntm_tracker_tpu_torch.models.vgg import VGG_MEAN
    from ntm_tracker_tpu_torch.utils.viz import save_imgs

    dev = resolve_device(args.device)
    d = DataConfig()
    seqs, train_seqs, _ = get_valid_sequences(args.sequences_dir, args.sequence_length)
    fb = next(batch_iterator(train_seqs or seqs, args.batch_size, args.gt_width, shuffle=False,
                             reverse_image=args.reverse_image, decode_resize_hw=tuple(d.resize_hw)))
    B, L = args.batch_size, args.sequence_length
    for i in range(min(B * L, args.max_print)):
        print(f"frame {i}: cropbox={np.round(fb.cropboxes[i], 4).tolist()} y_off={fb.y_offsets[i]:+.4f} "
              f"x_off={fb.x_offsets[i]:+.4f} gt_sum={fb.gts[i].sum():.4f}")
    with torch.no_grad():
        crops = preprocess_frame(torch.as_tensor(fb.images, device=dev), torch.as_tensor(fb.cropboxes, device=dev),
                                 resize_hw=d.resize_hw, crop_size=d.crop_size, do_resize=False)
    sz = d.crop_size
    crop_imgs = np.clip(crops.cpu().numpy() + VGG_MEAN, 0, 255).astype(np.uint8).reshape(B, L, sz, sz, 3)
    g = fb.gts.reshape(B, L, args.gt_width, args.gt_width, 1)
    gt_imgs = (g / max(float(g.max()), 1e-9) * 255).astype(np.uint8)
    offsets = np.stack([fb.y_offsets, fb.x_offsets], -1).reshape(B, L, 2)
    print("wrote", save_imgs([crop_imgs, gt_imgs, offsets], "inspect_batch", args.out_dir))
    return 0


# ---- serving and evaluation: track-vot, validate, the converters, export ------

def _load_converted_npz(args, cfg, template_params, device):
    """Converted REFERENCE weights (--ntm_npz / --dnc_npz) on `device`,
    checked against the live model config's tree before serving."""
    from ntm_tracker_tpu_torch.tools.convert_ntm_ckpt import validate_params_like

    ntm_npz = getattr(args, "ntm_npz", "")
    dnc_npz = getattr(args, "dnc_npz", "")
    if ntm_npz and dnc_npz:
        raise SystemExit("pass only one of --ntm_npz / --dnc_npz")
    if ntm_npz:
        if cfg.core != "ntm":
            raise SystemExit("--ntm_npz serves the NTM core; pass --core ntm (or use --dnc_npz for DNC checkpoints)")
        from ntm_tracker_tpu_torch.tools.convert_ntm_ckpt import load_params_npz
        loaded = load_params_npz(ntm_npz, device)
    else:
        if cfg.core != "dnc":
            raise SystemExit("--dnc_npz serves the DNC core; pass --core dnc")
        from ntm_tracker_tpu_torch.tools.convert_dnc_ckpt import load_params_npz
        loaded = load_params_npz(dnc_npz, device)
    validate_params_like(loaded, template_params, flag="--ntm_npz" if ntm_npz else "--dnc_npz")
    return loaded


def _resolve_tracker_weights(args, cfg, core, device):
    """The serving commands' weights (track-vot, validate, export-serving):
    converted reference .npz, else --ckpt_path, else a seeded init."""
    import torch

    from ntm_tracker_tpu_torch.tracking.tracker import _to_device

    params = core.init_params(torch.Generator().manual_seed(0), cfg.input_depth, device)
    if getattr(args, "ntm_npz", "") or getattr(args, "dnc_npz", ""):
        return _load_converted_npz(args, cfg, params, device)
    if args.ckpt_path:
        return _to_device(_restore_params(args.ckpt_path, params), device)
    return params


def _load_serving_model(serving_npz: str, args, device=None):
    """Load an exported artifact on `device`, with --vgg_int8 checked
    against the token path its programs hold: a flag that disagrees with
    the file fails instead of serving the other path."""
    from ntm_tracker_tpu_torch.tools.export_serving import ServingModel

    model = ServingModel(serving_npz, device=device)
    baked = bool(model.meta.get("vgg_int8"))
    if getattr(args, "vgg_int8", False) and not baked:
        raise SystemExit(f"--vgg_int8 requested but {serving_npz} was exported with the exact token path; "
                         "re-export with export-serving --vgg_int8")
    if baked and not getattr(args, "vgg_int8", False):
        print(f"note: {serving_npz} bakes int8 VGG tokens (quantized numerics); exported that way via "
              "export-serving --vgg_int8", file=sys.stderr)
    return model


def _serving_tracker(serving_npz: str, args, device=None):
    """StreamingTracker from an exported artifact (--vgg_int8 checked)."""
    from ntm_tracker_tpu_torch.tracking.tracker import StreamingTracker

    return StreamingTracker.from_serving(_load_serving_model(serving_npz, args, device))


def cmd_track_vot(args) -> int:
    import numpy as np
    from PIL import Image

    from ntm_tracker_tpu_torch.config import resolve_device
    from ntm_tracker_tpu_torch.models.core import make_core
    from ntm_tracker_tpu_torch.tracking import vot
    from ntm_tracker_tpu_torch.tracking.tracker import StreamingTracker

    dev = resolve_device(args.device)
    serving_npz = getattr(args, "serving_npz", "")
    if serving_npz:
        # the artifact holds geometry, token order and weights: the model
        # flags are ignored, --vgg_int8 is checked against it
        tracker = _serving_tracker(serving_npz, args, dev)
    else:
        cfg = _tracker_config(args, args.core)
        vgg_params = _load_vgg(args, dev)
        core = make_core(cfg)
        params = _resolve_tracker_weights(args, cfg, core, dev)
        tracker = StreamingTracker(cfg, vgg_params, params, core,
                                   delimiter_first=getattr(args, "delimiter_first", False), device=dev)

    handle = vot.VOT("rectangle", workdir=args.workdir, mode=getattr(args, "vot_mode", "auto"))
    trax_wire = hasattr(handle, "_trax_native") or hasattr(handle, "_trax")
    selection = handle.region()
    imagefile = handle.frame()
    if not imagefile:
        return 0
    img = np.array(Image.open(imagefile).convert("RGB"))
    tracker.init(img, (selection.x, selection.y, selection.width, selection.height))
    count = 1
    while True:
        imagefile = handle.frame()
        if not imagefile:
            break
        img = np.array(Image.open(imagefile).convert("RGB"))
        x, y, w, h = tracker.track(img)
        handle.report(vot.Rectangle(x, y, w, h))
        count += 1
    handle.quit()
    from ntm_tracker_tpu_torch.utils.profiling import counter

    # in trax mode stdout carries the protocol; the kernels' launch counts
    # are this process's, over the whole session
    print(f"tracked {count} frames (launches: ntm_scan_fused {counter('launches.ntm_scan_fused')}, "
          f"fused_ntm_addressing {counter('launches.fused_ntm_addressing')})",
          file=sys.stderr if trax_wire else sys.stdout)
    return 0


def cmd_validate(args) -> int:
    from ntm_tracker_tpu_torch.tracking.validate import validate_tracker

    validate_tracker(args)
    return 0


def cmd_convert_vgg(args) -> int:
    """vgg_16.ckpt -> .npz (the reference's freeze_vgg workflow,
    freeze_vgg.py:4-16, re-targeted at load_params_npz), then the conv4_3
    self-check on --device."""
    from ntm_tracker_tpu_torch.tools.convert_vgg import activation_stats, convert_vgg_checkpoint

    shapes = convert_vgg_checkpoint(args.ckpt, args.out, require_conv5=args.require_conv5,
                                    expect_sha256=args.expect_sha256 or None)
    for key in sorted(shapes):
        print(f"  {key}  {shapes[key]}")
    print(f"wrote {len(shapes)} arrays to {args.out}")
    stats = activation_stats(args.out, args.device)
    print("conv4_3 self-check on a deterministic ramp image (ImageNet weights give O(10-100) activations; a "
          "wrong/random-looking conversion reads very differently):")
    for k, v in stats.items():
        print(f"  {k}: {v:.4f}")
    return 0


def cmd_convert_ntm(args) -> int:
    """Reference NTM training checkpoint -> the port's parameter .npz
    (tools/convert_ntm_ckpt.py; pass the model flags the checkpoint was
    trained with: every shape is checked against them)."""
    from ntm_tracker_tpu_torch.config import NTMConfig
    from ntm_tracker_tpu_torch.tools.convert_ntm_ckpt import convert_checkpoint, save_params_npz

    ntm_cfg = NTMConfig(output_dim=2, mem_size=args.mem_size, mem_dim=args.mem_dim,
                        controller_hidden_size=args.hidden_size, controller_num_layers=args.num_layers,
                        read_head_size=args.read_head_size, write_head_size=args.write_head_size,
                        write_first=args.write_first)
    params = convert_checkpoint(args.ckpt, ntm_cfg)
    save_params_npz(args.out, params)
    print(f"converted {7 + 2 * len(params['controller'])} cell parameters -> {args.out}")
    print("serve with: track-vot --ntm_npz", args.out)
    return 0


def cmd_convert_dnc(args) -> int:
    """Reference DNC training checkpoint -> the port's parameter .npz
    (tools/convert_dnc_ckpt.py; shapes checked against the model flags)."""
    from ntm_tracker_tpu_torch.config import DNCConfig
    from ntm_tracker_tpu_torch.tools.convert_dnc_ckpt import convert_checkpoint, save_params_npz

    dnc_cfg = DNCConfig(output_dim=2, memory_size=args.mem_size, word_size=args.mem_dim,
                        num_reads=args.read_head_size, num_writes=args.write_head_size, hidden_size=args.hidden_size)
    params = convert_checkpoint(args.ckpt, dnc_cfg)
    save_params_npz(args.out, params)
    print(f"converted controller + 10 interface heads + output linear -> {args.out}")
    print("serve with: track-vot --core dnc --dnc_npz", args.out)
    return 0


def cmd_export_serving(args) -> int:
    """Export the serving frame step (tools/export_serving.py) to one .npz;
    prints the entries, platforms, route, size and seconds."""
    import json

    from ntm_tracker_tpu_torch.config import resolve_device
    from ntm_tracker_tpu_torch.models.core import make_core
    from ntm_tracker_tpu_torch.tools.export_serving import export_serving, save_serving

    # the flag first: a typo must not cost the model build
    device_loop = None
    if getattr(args, "device_loop", ""):
        try:
            h, w = args.device_loop.lower().split("x")
            device_loop = (int(h), int(w))
        except ValueError:
            raise SystemExit(f"--device_loop wants HxW (e.g. 360x640), got {args.device_loop!r}")
        if device_loop[0] < 2 or device_loop[1] < 2:
            raise SystemExit(f"--device_loop frame geometry too small: {args.device_loop}")
    platforms = [x.strip() for x in args.platforms.split(",") if x.strip()] or [resolve_device(args.device).type]
    # the weights live where the first platform's program is traced
    dev = resolve_device(platforms[0])
    cfg = _tracker_config(args, args.core)
    vgg_params = _load_vgg(args, dev)
    core = make_core(cfg)
    params = _resolve_tracker_weights(args, cfg, core, dev)
    t0 = time.perf_counter()
    artifact = export_serving(cfg, core, vgg_params, params, batch=args.batch,
                              delimiter_first=getattr(args, "delimiter_first", False), platforms=platforms,
                              device_loop=device_loop)
    save_serving(args.out, artifact)
    secs = time.perf_counter() - t0
    meta = json.loads(str(artifact["meta"]))
    mb = os.path.getsize(args.out) / 1e6
    tokens = "int8 tokens, " if meta["vgg_int8"] else ""
    entries = "init/first/step"
    if meta["device_loop"]:
        entries += "/dinit/dstep@{}x{}".format(*meta["device_loop"])
    print(f"exported {entries} for platforms {meta['platforms']} (batch {meta['batch']}, {tokens}{meta['core']} "
          f"core, {meta['route']}) -> {args.out} ({mb:.1f} MB) in {secs:.1f} s")
    if meta["batch"] == 1:
        print("serve with: track-vot --serving_npz, or StreamingTracker.from_serving(ServingModel(path))")
    else:
        print(f"serve with: FleetTracker.from_serving(ServingModel(path)) or validate --fleet {meta['batch']} "
              "--serving_npz")
    return 0


def cmd_bench(args) -> int:
    from ntm_tracker_tpu_torch.benchmarks import main as bench_main

    bench_main(device=args.device)
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
    t.add_argument("--save_imgs", action="store_true",
                   help="write the memory dashboards (and, on frames, the crop/gt/prediction grid) as PNGs at "
                   "each validation batch, from one forward (eval_with_views)")
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
    t.set_defaults(fn=cmd_train_offsets, experiment="offsets")

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
    cf.add_argument("--shard", action="store_true",
                    help="split each frame batch over every local device of --device "
                    "(tokens are per frame, so the output is float-equivalent to the single-device build)")
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

    ib = sub.add_parser("inspect-batch",
                        help="input-pipeline eyeball harness (the reference's --test_input/--test_read_imgs): print "
                        "one batch's record fields, write a PNG grid of crops + gt heatmaps + offsets")
    ib.add_argument("--sequences_dir", required=True)
    ib.add_argument("--out_dir", default=".")
    ib.add_argument("--batch_size", type=int, default=1)
    ib.add_argument("--sequence_length", type=int, default=20)
    ib.add_argument("--gt_width", type=int, default=8)
    ib.add_argument("--reverse_image", action="store_true")
    ib.add_argument("--max_print", type=int, default=20)
    ib.set_defaults(fn=cmd_inspect_batch)

    th = sub.add_parser("train-heatmap",
                        help="heatmap-output experiments (ntm_sevenbyseven / ntm_8by8 / ntm_sequential of the "
                        "reference's main.py)")
    _add_model_flags(th)
    _add_train_flags(th)
    th.add_argument("--core", choices=["ntm", "dnc"], default="ntm")
    th.add_argument("--sequences_dir", required=True)
    th.add_argument("--vgg_weights", default="")
    th.add_argument("--serialization", choices=["sequential", "frame"], default="sequential",
                    help="'sequential' is the reference's structure (the per-feature 2F+1 stream, "
                    "main.py:2040-2135); 'frame' is F tokens and a delimiter a frame, the heatmap read at the "
                    "frame delimiters (a variant the reference lacks)")
    th.add_argument("--compress_dim", type=int, default=0,
                    help="1x1-conv input compressor output channels (0=off)")
    th.add_argument("--feature_cache", default="",
                    help="train from precomputed VGG tokens (build with cache-features --grid_width matching "
                    "--gt_width)")
    th.set_defaults(fn=cmd_train_offsets, experiment="heatmap")

    d = sub.add_parser("dnc-repeat-copy", help="DNC repeat-copy training")
    d.add_argument("--hidden_size", type=int, default=64)
    d.add_argument("--memory_size", type=int, default=16)
    d.add_argument("--word_size", type=int, default=16)
    d.add_argument("--num_write_heads", type=int, default=1)
    d.add_argument("--num_read_heads", type=int, default=1)
    d.add_argument("--clip_value", type=float, default=20)
    d.add_argument("--max_grad_norm", type=float, default=50)
    d.add_argument("--learning_rate", type=float, default=1e-4)
    d.add_argument("--optimizer_epsilon", type=float, default=1e-10)
    d.add_argument("--batch_size", type=int, default=16)
    d.add_argument("--num_bits", type=int, default=4)
    d.add_argument("--min_length", type=int, default=1)
    d.add_argument("--max_length", type=int, default=2)
    d.add_argument("--min_repeats", type=int, default=1)
    d.add_argument("--max_repeats", type=int, default=2)
    d.add_argument("--num_training_iterations", type=int, default=100000)
    d.add_argument("--report_interval", type=int, default=100)
    d.add_argument("--checkpoint_interval", type=int, default=-1)
    d.add_argument("--checkpoint_dir", default="/tmp/ntm_tracker_tpu/dnc")
    d.add_argument("--seed", type=int, default=0)
    d.set_defaults(fn=cmd_dnc_repeat_copy)

    c = sub.add_parser("copy-paste",
                       help="NTM copy-paste sanity training (through ntm_tracker_unroll's default route, the "
                       "plain per-step loop, on every device, as the JAX package's)")
    _add_model_flags(c)
    _add_train_flags(c)
    c.add_argument("--width", type=int, default=3)
    c.set_defaults(fn=cmd_copy_paste)

    wf = sub.add_parser("train-wholeframe",
                        help="whole-feature-map experiments ntm()/ntm_two_step() on the pickle-based mined dataset "
                        "(mine-sequences)")
    _add_model_flags(wf)
    _add_train_flags(wf)
    wf.add_argument("--pickle_path", default="generated_sequences.pkl")
    wf.add_argument("--vgg_weights", default="")
    wf.add_argument("--feature_layer", default="conv4/conv4_3",
                    help="feature endpoint; must match the grid the gt masks were mined on (mine-sequences "
                    "--layers): 'conv4/conv4_3' (28x28, the mining default) or 'pool5' (7x7)")
    wf.add_argument("--two_step", action="store_true", help="present/ask protocol (ntm_two_step)")
    wf.add_argument("--compress_dim", type=int, default=128)
    wf.set_defaults(fn=cmd_train_wholeframe)

    ar = sub.add_parser("train-active-resize",
                        help="closed-loop recrop training (the completed form of the reference's unfinished "
                        "ntm_active_resize)")
    _add_model_flags(ar)
    _add_train_flags(ar)
    ar.add_argument("--pickle_path", default="generated_sequences.pkl")
    ar.add_argument("--vgg_weights", default="")
    ar.add_argument("--compress_dim", type=int, default=128)
    ar.set_defaults(fn=cmd_train_active_resize)

    lo = sub.add_parser("lstm-only", help="LSTM baseline on the heatmap task")
    _add_model_flags(lo)
    _add_train_flags(lo)
    lo.add_argument("--sequences_dir", required=True)
    lo.add_argument("--vgg_weights", default="")
    lo.add_argument("--compress_dim", type=int, default=128)
    lo.set_defaults(fn=cmd_lstm_only)

    sc = sub.add_parser("sanity-check", help="cosine-similarity heatmap reproduction check")
    _add_model_flags(sc)
    _add_train_flags(sc)
    sc.add_argument("--sequences_dir", required=True)
    sc.add_argument("--vgg_weights", default="")
    sc.add_argument("--pca", action="store_true")
    sc.add_argument("--compress_dim", type=int, default=128)
    sc.add_argument("--compressor_ckpt", default="",
                    help="checkpoint dir of a train-heatmap --compress_dim run: the check through the TRAINED "
                    "compressor (the reference's sanity_check_trained dispatch, main.py:2608-2632)")
    sc.set_defaults(fn=cmd_sanity_check)

    f = sub.add_parser("find-validation-batch")
    _add_train_flags(f)
    f.add_argument("--sequences_dir", required=True)
    f.add_argument("--target_step", type=int, default=1700)
    f.set_defaults(fn=cmd_find_validation_batch)

    v = sub.add_parser("track-vot", help="VOT-protocol streaming tracking")
    _add_model_flags(v)
    _add_train_flags(v)
    v.add_argument("--core", choices=["ntm", "dnc"], default="ntm")
    v.add_argument("--vgg_weights", default="")
    v.add_argument("--workdir", default=".")
    v.add_argument("--ntm_npz", default="", help="converted reference weights (convert-ntm output); overrides "
                   "--ckpt_path")
    v.add_argument("--dnc_npz", default="", help="converted reference DNC weights (convert-dnc output, requires "
                   "--core dnc); overrides --ckpt_path")
    v.add_argument("--delimiter_first", action="store_true",
                   help="use the reference's streaming token order (delimiter prepended; train/inference mismatch)")
    v.add_argument("--serving_npz", default="",
                   help="serve an exported artifact (export-serving output): weights, geometry and token order come "
                   "from the artifact; model/weight flags are ignored")
    v.add_argument("--vgg_int8", action="store_true",
                   help="the VGG token convs in int8 with exact int32 sums (models/vgg_int8.py; quantized "
                   "numerics, not for parity work)")
    v.add_argument("--vot_mode", choices=["auto", "file", "trax", "trax-lib"], default="auto",
                   help="protocol: file (images.txt/region.txt in --workdir), trax (native TraX wire protocol over "
                   "stdin/stdout, no deps), trax-lib (the optional trax package); auto = trax-lib if importable "
                   "else file")
    v.set_defaults(fn=cmd_track_vot)

    val = sub.add_parser("validate", help="replay pickled validation sequences")
    _add_model_flags(val)
    _add_train_flags(val)
    val.add_argument("--core", choices=["ntm", "dnc"], default="ntm")
    val.add_argument("--vgg_weights", default="")
    val.add_argument("--ntm_npz", default="", help="converted reference weights (convert-ntm output)")
    val.add_argument("--dnc_npz", default="",
                     help="converted reference DNC weights (convert-dnc output, requires --core dnc)")
    val.add_argument("--pickle_path", required=True)
    val.add_argument("--delimiter_first", action="store_true")
    val.add_argument("--serving_npz", default="",
                     help="replay through an exported artifact (export-serving output); model/weight flags are "
                     "ignored")
    val.add_argument("--vgg_int8", action="store_true", help="quantized VGG token convs (see track-vot)")
    val.add_argument("--fleet", type=int, default=0, metavar="N",
                     help="replay up to N sequences per batched frame step (tracking/fleet.py) instead of one at a "
                     "time; with --serving_npz, N must equal the artifact's batch (export-serving --batch N)")
    val.add_argument("--limit", type=int, default=0,
                     help="dress rehearsal: replay only the first N pickled sequences (0 = all)")
    val.set_defaults(fn=cmd_validate)

    cv = sub.add_parser("convert-vgg", help="convert the public slim vgg_16.ckpt to the .npz weight layout")
    cv.add_argument("--ckpt", required=True, help="path to vgg_16.ckpt")
    cv.add_argument("--out", required=True, help="destination .npz")
    cv.add_argument("--require_conv5", action="store_true", help="fail unless the conv5 block is present")
    cv.add_argument("--expect_sha256", default="",
                    help="verify the checkpoint bytes hash to this hex digest before converting (guards against a "
                    "corrupt or wrong download)")
    cv.set_defaults(fn=cmd_convert_vgg)

    cn = sub.add_parser("convert-ntm",
                        help="convert a REFERENCE training checkpoint (TF1 Saver, direct_offset_output graph) into "
                        "the port's NTM params (.npz usable via track-vot/validate --ntm_npz)")
    _add_model_flags(cn)
    cn.add_argument("--ckpt", required=True,
                    help="checkpoint prefix (the model.ckpt-NNN the reference's save_path.txt points at)")
    cn.add_argument("--out", required=True, help="destination .npz")
    cn.set_defaults(fn=cmd_convert_ntm)

    cd = sub.add_parser("convert-dnc",
                        help="convert a REFERENCE DNC training checkpoint (TF1 Saver, direct_offset_output_with_dnc "
                        "graph) into the port's DNC params (.npz usable via track-vot/validate --core dnc --dnc_npz)")
    _add_model_flags(cd)
    cd.add_argument("--ckpt", required=True, help="checkpoint prefix (model.ckpt-NNN)")
    cd.add_argument("--out", required=True, help="destination .npz")
    cd.set_defaults(fn=cmd_convert_dnc)

    es = sub.add_parser("export-serving",
                        help="export the serving frame step (torch.export programs, weights inside) to one .npz "
                        "artifact servable without model code; same weight sources as track-vot")
    _add_model_flags(es)
    _add_train_flags(es)
    es.add_argument("--core", choices=["ntm", "dnc"], default="ntm")
    es.add_argument("--vgg_weights", default="")
    es.add_argument("--ntm_npz", default="", help="converted reference weights (convert-ntm output); overrides "
                    "--ckpt_path")
    es.add_argument("--dnc_npz", default="", help="converted reference DNC weights (requires --core dnc); "
                    "overrides --ckpt_path")
    es.add_argument("--delimiter_first", action="store_true", help="bake the reference's streaming token order in")
    es.add_argument("--vgg_int8", action="store_true", help="bake the int8 VGG token path in (see track-vot)")
    es.add_argument("--batch", type=int, default=1,
                    help="batch of the artifact's init/step (1 = streaming tracker; >1 = a fleet of that capacity)")
    es.add_argument("--device_loop", default="", metavar="HxW",
                    help="also export the device-resident track loop (crop geometry + VGG + cell steps + recrop "
                    "in one program) at this raw-frame geometry, e.g. 360x640 (ServingModel.device_init/"
                    "device_step)")
    es.add_argument("--platforms", default="",
                    help="comma-separated platforms to export for (cuda, cpu); default = --device")
    es.add_argument("--out", required=True, help="destination .npz")
    es.set_defaults(fn=cmd_export_serving)

    b = sub.add_parser("bench", help="headline throughput benchmark")
    b.set_defaults(fn=cmd_bench)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
