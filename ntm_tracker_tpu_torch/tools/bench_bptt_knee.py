"""The BPTT training knee by batch size, fused against plain (counterpart
of ntm_tracker_tpu/tools/bench_bptt_knee.py, with its flags and JSON
keys).

For each batch size, times one full gradient step of the loss
mean(logits^2) + mean(final M^2) through the whole T=1300 BPTT (the
train-offsets shape: 20 sequences x 65 serialized steps) at the flagship
NTMConfig(), IN=514, on both paths:

  fused: the fused BPTT kernels (B2: ops/kernels/scan_bptt.ntm_scan_fused_bptt,
         the route ntm_tracker_unroll takes under fused_bptt=True), called
         directly so that --tile reaches its forward;
  plain: ntm_tracker_unroll's per-step loop under autograd, each step
         checkpointed (remat): the JAX tool's "xla" path, the remat
         lax.scan under jax.grad.

--tile pins B2's forward rows per block (scan_bptt.forward_rows'
rows_per_block; JAX pinned BATCH_TILE); each fused line reports the tile
the forward ran ("tile", None off the card). Each run ends in a host read
of a gradient. Prints one JSON line per (path, B): {"path", "B", "T",
"tile", "grad_step_ms", "frames_per_sec" (B * T / 65 / step),
"compile_s" (the first call: the kernels' libraries load there),
"launches"}. A failure raises.

    python -m ntm_tracker_tpu_torch.tools.bench_bptt_knee [--batches 32,64,128,256] [--seq 1300]
        [--iters 5] [--tile 2] [--paths fused,plain] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ntm_tracker_tpu_torch.config import NTMConfig, resolve_device

IN = 514


def knee_loss(params, cfg: NTMConfig, tokens: torch.Tensor, state, path: str, tile=None) -> torch.Tensor:
    """mean(logits^2) + mean(final M^2) over tokens [B, T, IN] from `state`,
    on `path` ("fused" or "plain")."""
    from ntm_tracker_tpu_torch.models.ntm_tracker import ntm_tracker_unroll
    from ntm_tracker_tpu_torch.ops.kernels.scan_bptt import ntm_scan_fused_bptt

    if path == "fused":
        logits, final = ntm_scan_fused_bptt(params, cfg, tokens, state, forward_rows_per_block=tile)
    elif path == "plain":
        _, logits, final = ntm_tracker_unroll(params, cfg, tokens, state=state, remat=True, fused_bptt=False)
    else:
        raise ValueError(f"unknown path {path!r} (fused, plain)")
    return torch.mean(logits ** 2) + torch.mean(final["M"] ** 2)


def knee_grads(params, cfg: NTMConfig, tokens: torch.Tensor, state, path: str, tile=None) -> list:
    """The gradient of knee_loss wrt every param, in tree_leaves order
    (zeros for the initial-state params: `state` is a constant, as in
    the JAX tool's jax.grad)."""
    from ntm_tracker_tpu_torch.train.optim import tree_leaves, tree_map

    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = tree_leaves(live)
    grads = torch.autograd.grad(knee_loss(live, cfg, tokens, state, path, tile), leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]


def main(argv=None) -> int:
    from ntm_tracker_tpu_torch.benchmarks import kernel_launches, launches_since
    from ntm_tracker_tpu_torch.models.ntm_cell import init_ntm_params, init_ntm_state
    from ntm_tracker_tpu_torch.ops.kernels.scan_bptt import forward_tile

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batches", default="32,64,128,256")
    ap.add_argument("--seq", type=int, default=1300)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--tile", type=int, default=None, help="B2's forward rows per block (default: forward_rows')")
    ap.add_argument("--paths", default="fused,plain")
    ap.add_argument("--device", default=None, help="torch device (default: cuda; cpu runs the plain routes)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = NTMConfig()  # the flagship
    T = args.seq
    params = init_ntm_params(cfg, IN, torch.Generator().manual_seed(0), dev)
    for B in [int(b) for b in args.batches.split(",")]:
        rs = np.random.RandomState(B)
        tokens = torch.as_tensor(0.3 * rs.standard_normal((B, T, IN)).astype(np.float32), device=dev)
        with torch.no_grad():
            state = init_ntm_state(params, cfg, B)
        for path in args.paths.split(","):
            before = kernel_launches()

            def step():
                return knee_grads(params, cfg, tokens, state, path, args.tile)[0]

            def sync(g):
                return float(g.reshape(-1)[0])

            t0 = time.perf_counter()
            sync(step())
            compile_s = time.perf_counter() - t0
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                for _ in range(args.iters):
                    g = step()
                sync(g)
                best = min(best, (time.perf_counter() - t0) / args.iters)
            tile = forward_tile(cfg, IN, B, dev, args.tile) if path == "fused" and dev.type == "cuda" else None
            print(json.dumps({
                "path": path, "B": B, "T": T, "tile": tile,
                "grad_step_ms": round(best * 1e3, 2),
                "frames_per_sec": round(B * T / 65 / best, 1),
                "compile_s": round(compile_s, 1),
                "launches": launches_since(before),
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
