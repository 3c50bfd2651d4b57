"""Training-step throughput: the image path against the feature-cache path
(counterpart of ntm_tracker_tpu/tools/bench_train.py, with its flags and
JSON keys; --device in place of --platform).

Times the full train step (loss + BPTT through the L*(F+1)-step stream +
clip + RMSProp, OffsetExperiment.make_train_step) at the flagship config
(direct_offset_output.py:21-49 scaled to a production batch), with the
batch either as decoded crops (`images`: the frozen VGG every step, the
reference's structure; synthetic_offset_batch) or as precomputed tokens
(`tokens`: train-offsets --feature_cache; synthetic_cached_batch). On the
card the NTM core's float32 step takes the fused BPTT kernels (B2); the
DNC core is plain PyTorch. Each mode starts from a fresh copy of the
params and optimizer state. A failure raises.

    python -m ntm_tracker_tpu_torch.tools.bench_train [--batch 32] [--bf16] [--modes images,tokens]
        [--core dnc] [--dnc_remat_chunk N] [--device cpu]

Prints one JSON line per mode: {"mode", "step_ms", "frames_per_sec",
"batch", "seq_len", "compute_dtype", "core", "platform", "launches"}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from ntm_tracker_tpu_torch.config import TrackerConfig, TrainConfig, resolve_device


def main(argv=None) -> int:
    from ntm_tracker_tpu_torch.benchmarks import kernel_launches, launches_since
    from ntm_tracker_tpu_torch.models.vgg import init_vgg_params
    from ntm_tracker_tpu_torch.tools.track_artifact import device_fields
    from ntm_tracker_tpu_torch.train.experiments import (
        OffsetExperiment,
        synthetic_cached_batch,
        synthetic_offset_batch,
    )
    from ntm_tracker_tpu_torch.train.optim import tree_map

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq_len", type=int, default=20)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--modes", default="images,tokens")
    ap.add_argument("--core", default="ntm", choices=("ntm", "dnc"))
    ap.add_argument("--dnc_remat_chunk", type=int, default=None,
                    help="override dnc_unroll's carry-saving chunk (default: auto; 0 = plain per-step saving)")
    ap.add_argument("--device", default=None, help="torch device (default: cuda; cpu runs the plain routes)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    modes = {m for m in args.modes.split(",") if m}
    unknown = modes - {"images", "tokens"}
    if unknown or not modes:
        raise SystemExit(f"--modes must name 'images' and/or 'tokens', got {args.modes!r}")
    cfg = TrackerConfig(
        core=args.core,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        train=TrainConfig(batch_size=args.batch, sequence_length=args.seq_len),
    )
    if args.dnc_remat_chunk is not None:
        cfg = dataclasses.replace(cfg, dnc=dataclasses.replace(cfg.dnc, remat_chunk=args.dnc_remat_chunk))
    vgg = init_vgg_params(torch.Generator().manual_seed(0), dev)
    exp = OffsetExperiment(cfg, vgg, image_mode="cropped", device=dev)
    params, opt_state = exp.init(torch.Generator().manual_seed(1))
    step = exp.make_train_step()
    platform = device_fields(dev)["platform"]

    rng = np.random.RandomState(0)
    n = args.batch * args.seq_len
    batches = {}
    if "images" in modes:
        # the [B*L, 224, 224, 3] crop batch only when the images mode runs
        batches["images"] = exp.device_batch(synthetic_offset_batch(cfg, rng))
    if "tokens" in modes:
        batches["tokens"] = exp.device_batch(synthetic_cached_batch(cfg, rng))

    for mode, batch in batches.items():
        before = kernel_launches()
        p, o = tree_map(torch.clone, params), tree_map(torch.clone, opt_state)
        p, o, m = step(p, o, batch)
        float(m["loss"])
        t0 = time.perf_counter()
        for _ in range(args.iters):
            p, o, m = step(p, o, batch)
        float(m["loss"])  # a host read: the steps are done
        dt = (time.perf_counter() - t0) / args.iters
        print(json.dumps({
            "mode": mode,
            "step_ms": round(dt * 1e3, 2),
            "frames_per_sec": round(n / dt, 1),
            "batch": args.batch,
            "seq_len": args.seq_len,
            "compute_dtype": "bfloat16" if args.bf16 else "float32",
            "core": args.core,
            "platform": platform,
            "launches": launches_since(before),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
