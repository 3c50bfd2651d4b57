#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ntm_tracker_tpu_torch) on one NVIDIA
H100: builds the CUDA kernels from csrc/ (one nvcc per source, in
parallel), holds each against its plain PyTorch version on the card (B1
on both of its routes: a thread-block cluster per row at small B, B2's
forward tile step without residuals at large B),
drives the streaming tracker's frame step, the batched fleet and the
device-resident loop with NTMConfig.use_pallas (the addressing kernel at
every cell step) and the cached-token training step at full width, holds
the lane-packed kernels against their plain version, B1 and B2 at the
frame and train shapes, and times the kernels, their plain versions, the
frame step, the fleet step on three cell routes, the device loop and the
train step; splits B3's phases with its probe variant (clock64() stamps);
then the accuracy path: the demo config's NTM trains through B2 until its
loss falls and tracks a held-out clip through B1 within the accuracy
artifact's tripwires, the DNC's train step on the card is held against the
CPU's, and the flagship width trains on build_dataset's tokens.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (PATH or /usr/local/cuda/bin) and nvidia-smi.
Every phase prints one flushed line with its elapsed seconds; any failure
raises, so the exit code is non-zero and the final result line is not
printed. Card-only checks of the port live here, not in pytest: the test
suite's conftest imports JAX, which the card's machine does not have.

Output ends with the card's name and power limit (nvidia-smi), one
{"kernels": [...]} JSON line and, last, the {"ok": true, ...} JSON line.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch

T_START = time.perf_counter()
# the whole run, the kernel build included, must end inside this budget
BUDGET_S = 300.0

# f32: the kernel and the plain version sum in different orders; over the 65
# recurrent steps that rounding (~1e-7 relative per op) stays below 1e-5.
F32_TOL = 1e-4
# bf16: both round every matmul result to bf16, but a sum that lands on the
# other side of a rounding boundary flips one bf16 ulp (2^-8 relative) in a
# gate, and the recurrence carries the flip forward.
BF16_TOL = 5e-2

# Gradients, fused BPTT vs autograd of the plain loop: max |kernel - plain|
# <= GRAD_TOL * max |plain|, per gradient tensor. Both sum in f32 in
# different orders: a weight gradient adds up to T*B terms (1.3e3..3.3e5),
# whose rounding grows like sqrt(terms) * 6e-8 (2e-6..4e-5 relative); the
# margin covers cancellation in those sums. The measured error at T=65 and
# at T=1300 is printed beside it.
GRAD_TOL = 1e-3

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

KERNEL_NAME = "scan_cell.ntm_scan_fused"
KERNEL_SOURCE = "ntm_tracker_tpu_torch/csrc/scan_cell.cu"
KERNEL_REPLACES = "ntm_tracker_tpu/ops/pallas/scan_cell.py:42"
BPTT_SOURCE = "ntm_tracker_tpu_torch/csrc/scan_bptt.cu"
BPTT_REPLACES = {
    "forward": "ntm_tracker_tpu/ops/pallas/scan_bptt.py:269",
    "token_projection": "ntm_tracker_tpu/ops/pallas/scan_bptt.py:372",
    "backward": "ntm_tracker_tpu/ops/pallas/scan_bptt.py:312",
    "grad_reduce": "ntm_tracker_tpu/ops/pallas/scan_bptt.py:542",
}
# B2's kernels before their redesign (PERF.md, NVIDIA H100 80GB HBM3 at
# 700 W): the forward at one row per block reading W0's token rows every
# step (PR 8); the backward at one row per block, with no projection and
# dtokens always, and the 64 x 64 reduction (PR 5)
PREVIOUS_MS = {"forward": 161.1, "backward": 383.4, "grad_reduce": 24.7}
# the training slice's shape: the JAX bench's cached-token train step
# (ntm_tracker_tpu/benchmarks.py:646), B=256 rows of L=20 frames
TRAIN_B, TRAIN_L = 256, 20
B8_L = 10
PACKED_SOURCE = "ntm_tracker_tpu_torch/csrc/scan_packed.cu"
ADDR_NAME = "addressing.fused_ntm_addressing"
ADDR_SOURCE = "ntm_tracker_tpu_torch/csrc/addressing.cu"
ADDR_REPLACES = "ntm_tracker_tpu/ops/pallas/addressing.py:45"
# the fleet slice: raw 360x640 frames, the JAX device loop's frame size
# (ntm_tracker_tpu/benchmarks.py:572); the main path at capacity 64
FLEET_HW = (360, 640)
FLEET_CAP, FLEET_STEPS = 64, 10
FLEET_TIME_CAPS = (8, 64, 256)
# fleet (matmul crop, B3 at B=64) vs StreamingTracker (gather crop, B1 at
# B=1) on the first frame, in pixels: float32 rounding of two crop forms,
# two cell routes and cuDNN at two batch sizes, through one frame step
REGION_TOL_PX = 1e-2
# the device loop vs StreamingTracker over its first three recrops, in
# pixels: float32 device geometry against float64 host geometry
# (tests/test_tracking.py's bound for the JAX package's loop)
LOOP_TOL_PX = 5e-2
# the accuracy phase: the demo config's NTM trains ACC_STEPS steps through
# B2, the flagship width ACC_FLAG_STEPS full-batch steps on ACC_FLAG_SEQS
# sequences; each loss must fall (the mean of the last ACC_WINDOW steps
# under the mean of the first). The DNC's train step on the card against
# the same step on the CPU: the loss within DNC_LOSS_RTOL, each gradient
# within GRAD_TOL of its largest magnitude (float32 in other orders, over
# 520 cell steps and the frozen VGG's cuDNN convs against the CPU's).
ACC_STEPS, ACC_WINDOW = 60, 10
ACC_FLAG_SEQS, ACC_FLAG_STEPS, ACC_FLAG_WINDOW = 64, 20, 5
ACC_CLIP_FRAMES, ACC_DNC_FRAMES = 12, 4
DNC_LOSS_RTOL = 1e-4


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] t={time.perf_counter() - T_START:.1f}s {msg}", flush=True)


def check_budget(phase: str) -> None:
    elapsed = time.perf_counter() - T_START
    if elapsed > BUDGET_S:
        raise RuntimeError(f"over budget after phase {phase}: {elapsed:.1f}s > {BUDGET_S}s")


def cuda_ms(fn, iters: int, warmup: int) -> float:
    """Mean device time of fn() in ms, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_abs(a, b) -> float:
    return float((a.detach().double() - b.detach().double()).abs().max())


def state_diffs(logits, state, ref_logits, ref_state) -> dict:
    out = {"logits": max_abs(logits, ref_logits)}
    for key in ("M", "w", "read"):
        out[key] = max_abs(state[key], ref_state[key])
    for l, ((c, h), (rc, rh)) in enumerate(zip(state["controller_state"], ref_state["controller_state"])):
        out[f"c{l}"] = max_abs(c, rc)
        out[f"h{l}"] = max_abs(h, rh)
    return out


def forward_errors(got, ref) -> dict:
    """{part: max |got - ref|} over B2 forward outputs (logits, final
    state, residual streams), both as bptt_forward returns them."""
    (logits, final, res), (r_logits, r_final, r_res) = got, ref
    out = state_diffs(logits, final, r_logits, r_final)
    for name, a, b in zip(("res_M", "res_w", "res_read", "res_c", "res_h"), res, r_res):
        out[name] = max_abs(a, b)
    return out


def same_forward(a, b) -> bool:
    """Whether two B2 forward outputs are the same bits."""
    from ntm_tracker_tpu_torch.ops.kernels.scan_cell import flatten_state

    return (torch.equal(a[0], b[0]) and all(torch.equal(x, y) for x, y in zip(a[2], b[2]))
            and all(torch.equal(x, y) for x, y in zip(flatten_state(a[1]), flatten_state(b[1]))))


def step_element_ops(cfg) -> int:
    """The element operations of one cell step of one row, outside its
    matmuls: the LSTM gates and the addressing, write and read."""
    N, D, H = cfg.mem_size, cfg.mem_dim, cfg.num_heads
    R, W, S = cfg.read_head_size, cfg.write_head_size, cfg.shift_space
    Hc, L = cfg.controller_hidden_size, cfg.controller_num_layers
    return (
        10 * L * Hc                        # LSTM gates
        + 2 * N * D + 2 * H * D            # memory and key norms
        + 3 * H * N * D                    # normalized similarity
        + 6 * H * N                        # softmax and gate
        + 2 * S * H * N + 3 * H * N        # shift and sharpen
        + 4 * W * N * D + 2 * N * D        # erase/add
        + 2 * R * N * D                    # read
    )


def scan_cell_work(cfg, B: int, T: int, IN: int) -> tuple[float, float]:
    """(bytes, operations) the T-step cell loop needs at least: every
    input read once and every output written once, in float32; matmul
    FLOPs (2 per multiply-add) plus the addressing's element operations."""
    N, D, H = cfg.mem_size, cfg.mem_dim, cfg.num_heads
    R, W, S = cfg.read_head_size, cfg.write_head_size, cfg.shift_space
    Hc, L, O = cfg.controller_hidden_size, cfg.controller_num_layers, cfg.output_dim
    P = H * D + 3 * H + S * H + 2 * W * D
    k_rows = [IN + R * D + Hc] + [2 * Hc] * (L - 1)
    weights = sum(k * 4 * Hc + 4 * Hc for k in k_rows) + Hc * P + P + Hc * O + O
    state = N * D + H * N + R * D + 2 * L * Hc
    floats = weights + B * T * IN + 2 * B * state + B * T * O
    per_step = sum(2 * k * 4 * Hc for k in k_rows) + 2 * Hc * P + 2 * Hc * O + step_element_ops(cfg)
    return 4.0 * floats, float(B * T * per_step)


def scan_bptt_work(cfg, B: int, T: int, IN: int, need_dtokens: bool = False, hoisted: bool = True,
                   residuals: bool = True) -> dict:
    """(bytes, operations) per B2 kernel, as scan_cell_work counts them:
    every input read once, every output written once (float32), matmul
    FLOPs at 2 per multiply-add plus the element operations. hoisted counts
    the kernels as the train route and B4 run them: the token projection
    once per step, the forward and the backward's recompute each reading
    it (no token rows of W0 in their products, no tokens read by the
    forward), and without dtokens no token rows in the backward's
    transposed product and no dtokens write. hoisted=False counts kernels
    that do their own token product. residuals=False counts a forward that
    writes no residual streams."""
    N, D, H = cfg.mem_size, cfg.mem_dim, cfg.num_heads
    R, W, S = cfg.read_head_size, cfg.write_head_size, cfg.shift_space
    Hc, L, O = cfg.controller_hidden_size, cfg.controller_num_layers, cfg.output_dim
    P = H * D + 3 * H + S * H + 2 * W * D
    G4 = 4 * Hc
    k_rows = [IN + R * D + Hc] + [2 * Hc] * (L - 1)
    weights = sum(k * G4 + G4 for k in k_rows) + Hc * P + P + Hc * O + O
    state = N * D + H * N + R * D + 2 * L * Hc
    # the forward's products: layer 0 without its token rows when hoisted
    f_rows = [k_rows[0] - (IN if hoisted else 0)] + k_rows[1:]
    fwd_step = sum(2 * k * G4 for k in f_rows) + 2 * Hc * P + 2 * Hc * O + step_element_ops(cfg) + (G4 if hoisted else 0)
    fwd_ops = B * T * fwd_step
    fwd_weights = weights - (IN * G4 if hoisted else 0)
    fwd_floats = (fwd_weights + B * T * (G4 if hoisted else IN) + 2 * B * state + B * T * O
                  + (B * T * state if residuals else 0))    # the residual streams
    t_rows = [k_rows[0] - (0 if need_dtokens else IN)] + k_rows[1:]
    per_step_bwd = (
        sum(2 * k * G4 for k in t_rows) + 2 * Hc * (P + O)  # transposed products
        + 15 * L * Hc                                  # LSTM gate cotangents
        + 4 * R * N * D + (4 * W + 6) * N * D         # read, erase/add
        + (10 + 4 * S) * H * N                         # sharpen, shift, gate, softmax
        + 5 * H * N * D + 5 * N * D                    # keys, normalizer
    )
    bwd_ops = B * T * per_step_bwd + fwd_ops          # plus the recompute
    bwd_weights = weights - (IN * G4 if hoisted and not need_dtokens else 0)
    bwd_floats = (bwd_weights + B * T * (IN + (G4 if hoisted else 0) + state + O) + B * state      # read
                  + B * T * ((IN if need_dtokens else 0) + sum(k_rows) + G4 * L + Hc + P + O)
                  + B * state)                                                                    # written
    reduce = []
    for K, J in [(k, G4) for k in k_rows] + [(Hc, P + O)]:
        M = B * T
        reduce.append((4.0 * (M * K + M * J + (K + 1) * J), 2.0 * M * (K + 1) * J))
    proj = (4.0 * (B * T * IN + IN * G4 + G4 + B * T * G4), 2.0 * B * T * IN * G4)
    return {
        "forward": (4.0 * fwd_floats, float(fwd_ops)),
        "token_projection": proj,
        "backward": (4.0 * bwd_floats, float(bwd_ops)),
        "grad_reduce": (sum(b for b, _ in reduce), sum(o for _, o in reduce)),
    }


def addressing_work(cfg, B: int) -> tuple[float, float]:
    """(bytes, operations) of one B3 call, as scan_cell_work counts them:
    the raw head controls, M and w read once, M, w and read written once
    (float32); the addressing's element operations."""
    N, D, H = cfg.mem_size, cfg.mem_dim, cfg.num_heads
    R, W, S = cfg.read_head_size, cfg.write_head_size, cfg.shift_space
    controls = H * D + 3 * H + S * H + 2 * W * D
    floats = B * (controls + N * D + H * N) + B * (N * D + H * N + R * D)
    per_row = (
        H * D + 2 * W * D + 3 * H + 3 * S * H  # squashed controls
        + 2 * N * D + 2 * H * D                # memory and key norms
        + 3 * H * N * D                        # normalized similarity
        + 6 * H * N                            # softmax and gate
        + 2 * S * H * N + 3 * H * N            # shift and sharpen
        + 4 * W * N * D + 2 * N * D            # erase/add
        + 2 * R * N * D                        # read
    )
    return 4.0 * floats, float(B * per_row)


def device_profile(fn, reps: int) -> dict:
    """torch.profiler over `reps` calls of fn (after one warm-up call):
    per call, the device time of every kernel (busy_ms), of the copies
    (copy_ms), and the kernels with the most device time. busy_ms is None
    when the profiler records no device activity on this machine."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per_name, copy_us, n_kernels = {}, 0.0, 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        if "memcpy" in e.name.lower() or "memset" in e.name.lower():
            copy_us += us
            continue
        per_name[e.name] = per_name.get(e.name, 0.0) + us
        n_kernels += 1
    if not per_name:
        return {"busy_ms": None, "copy_ms": None, "kernels_per_call": 0, "top": []}
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:5]
    return {"busy_ms": sum(per_name.values()) / reps / 1e3, "copy_ms": copy_us / reps / 1e3,
            "kernels_per_call": n_kernels / reps,
            "top": [(name[:60], round(us / reps / 1e3, 4)) for name, us in top]}


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    """(least ms on the card, "bytes" or "operations"): HBM rate vs f32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def named_leaves(params) -> dict:
    out = {}
    for k, v in params.items():
        if k == "controller":
            for l, layer in enumerate(v):
                for kk, vv in layer.items():
                    out[f"controller[{l}].{kk}"] = vv
        else:
            out[k] = v
    return out


def cotangent_loss(logits, final, cot):
    """A scalar that touches every output: logits and each final state part."""
    A, BM, Bw, Br, Bc = cot
    out = (logits * A).sum() + (final["M"] * BM).sum() + (final["w"] * Bw).sum() + (final["read"] * Br).sum()
    for c, h in final["controller_state"]:
        out = out + (c * Bc).sum() + 0.5 * (h * Bc).sum()
    return out


def grads_of(scan, params, ncfg, tokens, cot, state_fn, token_grads=True):
    """(logits, final state, {name: grad}) of cotangent_loss through
    scan(params, cfg, tokens, state), grads wrt every parameter (init_*
    through the state) and, with token_grads, the tokens (else the tokens
    need no gradient, as the training path's cached features)."""
    from ntm_tracker_tpu_torch.train.optim import tree_map

    p = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    tok = tokens.detach().clone().requires_grad_(token_grads)
    logits, final = scan(p, ncfg, tok, state_fn(p))
    leaves = named_leaves(p)
    wrt = [tok, *leaves.values()] if token_grads else list(leaves.values())
    grads = torch.autograd.grad(cotangent_loss(logits, final, cot), wrt, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(wrt, grads)]
    return logits.detach(), final, dict(zip(["tokens", *leaves] if token_grads else list(leaves), grads))


def grad_errors(g, ref) -> dict:
    """{name: max |g - ref| / max |ref|} (absolute where ref is all zero),
    over the names g has."""
    out = {}
    for k, r in ref.items():
        if k not in g:
            continue
        scale = float(r.abs().max())
        out[k] = max_abs(g[k], r) / (scale if scale > 0 else 1.0)
    return out


def synthetic_video(seed: int, frames: int, hw=(720, 1280)) -> tuple[np.ndarray, tuple]:
    """A smooth textured scene with a tinted blob drifting across it, made
    from `seed`; returns (uint8 [frames, H, W, 3], first region x,y,w,h)."""
    rs = np.random.RandomState(seed)
    h, w = hw
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    ph = rs.uniform(0, 2 * np.pi, 3)
    base = np.stack([
        128 + 50 * np.sin(2 * np.pi * (xs / w + 0.3 * np.sin(2 * np.pi * ys / h)) + ph[0]),
        128 + 50 * np.cos(2 * np.pi * (1.3 * ys / h + 0.2 * xs / w) + ph[1]),
        128 + 40 * np.sin(2 * np.pi * (0.7 * xs / w + 0.9 * ys / h) + ph[2]),
    ], axis=-1)
    bw, bh = 160.0, 120.0
    x0, y0 = w / 2 - bw / 2, h / 2 - bh / 2
    vy, vx = rs.uniform(-6, 6, 2)
    tint = rs.uniform(-90, 90, 3)
    out = np.empty((frames, h, w, 3), np.uint8)
    for t in range(frames):
        cy, cx = y0 + bh / 2 + vy * t, x0 + bw / 2 + vx * t
        blob = np.exp(-(((ys - cy) / (bh / 2)) ** 2 + ((xs - cx) / (bw / 2)) ** 2))
        out[t] = np.clip(base + blob[..., None] * tint, 0, 255).astype(np.uint8)
    return out, (x0, y0, bw, bh)


def scan_case(ncfg, B: int, T: int, seed: int, dev: torch.device, IN: int) -> tuple:
    """(params, tokens [B, T, IN], cotangents) for a whole-sequence scan
    case, made from `seed`: the seeded init with every parameter nudged so
    that the zero biases' gradients are not trivial."""
    from ntm_tracker_tpu_torch.models.ntm_cell import init_ntm_params
    from ntm_tracker_tpu_torch.train.optim import tree_map

    rs = np.random.RandomState(seed)
    params = init_ntm_params(ncfg, IN, torch.Generator().manual_seed(seed))
    # break the symmetry of the zero biases so that their grads are not trivial
    params = tree_map(lambda t: (t + torch.tensor(
        rs.uniform(-0.05, 0.05, tuple(t.shape)).astype(np.float32))).to(dev), params)
    tokens = torch.tensor(rs.uniform(-1, 1, (B, T, IN)).astype(np.float32), device=dev)
    shapes = [(B, T, ncfg.output_dim), (B, ncfg.mem_size, ncfg.mem_dim), (B, ncfg.num_heads, ncfg.mem_size),
              (B, ncfg.read_head_size, ncfg.mem_dim), (B, ncfg.controller_hidden_size)]
    cot = [torch.tensor(rs.uniform(-1, 1, sh).astype(np.float32), device=dev) for sh in shapes]
    return params, tokens, cot


def wconv_zero_case(dev: torch.device, IN: int) -> tuple:
    """The flagship at B=2, T=1 with heads that make w_conv exactly one-hot
    (one live memory slot, a huge beta, g = 1, one shift weight): (cfg, B,
    params, tokens, cot, state_fn, head-control column slices, (entries
    exactly 0, entries exactly 1))."""
    from ntm_tracker_tpu_torch.config import NTMConfig
    from ntm_tracker_tpu_torch.models.ntm_cell import HEAD_PARAM_ORDER, head_param_sizes, init_ntm_state, ntm_cell_step

    ncfg, B = NTMConfig(), 2
    params, tokens, cot = scan_case(ncfg, B, 1, 320, dev, IN)
    sizes, cols, o = head_param_sizes(ncfg), {}, 0
    for key in HEAD_PARAM_ORDER:
        cols[key] = slice(o, o + sizes[key])
        o += sizes[key]
    hw, hb = params["heads_w"].clone(), params["heads_b"].clone()
    for key in ("k", "beta", "g", "sw"):
        hw[:, cols[key]] = 0.0
    hb[cols["k"]] = 3.0        # k_d = tanh(3) for every d
    hb[cols["beta"]] = 1000.0  # content weights one-hot on the one live slot
    hb[cols["g"]] = 40.0       # g = 1.0 exactly: w_g = w_c
    hb[cols["sw"]] = torch.tensor([0.0, 300.0, 0.0] * ncfg.num_heads, device=dev)  # one shift
    params["heads_w"], params["heads_b"] = hw, hb
    M0 = torch.zeros(B, ncfg.mem_size, ncfg.mem_dim, device=dev)
    M0[:, 7, :] = 1.0

    def zero_state(p):
        st = init_ntm_state(p, ncfg, B)
        st["M"] = M0
        return st

    with torch.no_grad():
        dbg = ntm_cell_step(params, ncfg, tokens[:, 0], zero_state(params), with_debug=True)[3]
    n_zero, n_one = int((dbg["w_conv"] == 0).sum()), int((dbg["w_conv"] == 1).sum())
    if n_zero + n_one != dbg["w_conv"].numel() or n_one != B * ncfg.num_heads:
        raise AssertionError(f"the zero case does not make w_conv one-hot ({n_zero} zeros, {n_one} ones)")
    return ncfg, B, params, tokens, cot, zero_state, cols, (n_zero, n_one)


def bptt_cases() -> dict:
    """The training kernels' cases: {name: (cfg, B, T)}."""
    from ntm_tracker_tpu_torch.config import NTMConfig

    return {
        "a_flagship": (NTMConfig(), 1, 1300),
        "b_flagship": (NTMConfig(), 70, 65),
        "c_2layer_2write_s5_writefirst": (NTMConfig(controller_num_layers=2, write_head_size=2, shift_range=2,
                                                    write_first=True), 3, 65),
        "d_slotwise": (NTMConfig(slotwise_cosine=True), 3, 65),
    }


def packed_wide_cases() -> dict:
    """B4's cases past its runs of slots, {name: (cfg, B, T)}: more than
    ADDR_MAX_SLOTS slots (the lane-per-slot phases; the forward's chains'
    scratch), also slotwise, write-first with two write heads at S = 5;
    and a shift wider than memory (its offsets taken mod N)."""
    from ntm_tracker_tpu_torch.config import NTMConfig

    return {
        "f_n320": (NTMConfig(mem_size=320), 3, 65),
        "g_n300_2write_s5_writefirst_slotwise": (NTMConfig(mem_size=300, write_head_size=2, shift_range=2,
                                                           write_first=True, slotwise_cosine=True), 3, 33),
        "h_n3_s5": (NTMConfig(mem_size=3, shift_range=2), 3, 65),
    }


def phase_bptt(dev: torch.device, IN: int) -> dict:
    """B2 against its plain version on the card, on five cases: the
    forward at every tile that fits against bptt_forward_reference on the
    same projection (logits, final state and residual streams, the same
    bits on a rerun), and the whole route (autograd Function) against
    autograd through the plain loop: logits, final state and every
    gradient, with the forward at each tile and the backward at one and
    two rows per block (where two fit), and the flagship cases also with
    tokens that need no gradient (the backward then computes no dtokens);
    and B1's trainable wrapper against the same plain version. Returns the
    tiles each case ran at and the forward's largest error."""
    from ntm_tracker_tpu_torch.config import NTMConfig
    from ntm_tracker_tpu_torch.models.ntm_cell import init_ntm_state
    from ntm_tracker_tpu_torch.ops.kernels import scan_bptt
    from ntm_tracker_tpu_torch.ops.kernels.scan_bptt import ntm_scan_fused_bptt, ntm_scan_fused_bptt_reference
    from ntm_tracker_tpu_torch.ops.kernels.scan_cell import MAX_SMEM_BYTES, ntm_scan_fused_trainable

    def compare(name, ncfg, B, T, scan, params, tokens, cot, state_fn, variants=((None, None, True),)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pl, pf, pg = grads_of(ntm_scan_fused_bptt_reference, params, ncfg, tokens, cot, state_fn)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        worst, kg = 0.0, None
        for frows, brows, token_grads in variants:
            kscan = scan if (frows, brows) == (None, None) else functools.partial(
                scan, forward_rows_per_block=frows, backward_rows_per_block=brows)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            kl, kf, kg = grads_of(kscan, params, ncfg, tokens, cot, state_fn, token_grads)
            torch.cuda.synchronize()
            kernel_ms = 1e3 * (time.perf_counter() - t0)
            fwd = max(state_diffs(kl, kf, pl, pf).values())
            gerr = grad_errors(kg, pg)
            finite = all(bool(torch.isfinite(g).all()) for g in kg.values())
            gw = max(gerr, key=gerr.get)
            tag = "" if (frows, brows) == (None, None) else f" rows {frows}/{brows}, token grads {token_grads}"
            log("bptt", f"{name} B={B} T={T}{tag}: fwd max_abs={fwd:.3e} (tol {F32_TOL:g}); grads max rel={gerr[gw]:.3e} "
                        f"at {gw} (tol {GRAD_TOL:g}, {len(gerr)} gradients); finite={finite}; fwd+bwd {kernel_ms:.1f} ms, "
                        f"plain {plain_ms:.1f} ms (host clock, first call)")
            if not finite or fwd > F32_TOL or gerr[gw] > GRAD_TOL:
                raise AssertionError(f"{name}{tag}: the kernels disagree with the plain version")
            worst = max(worst, gerr[gw])
        return {"grad_rel": worst, "grads": kg}

    def forward_check(name, ncfg, B, T, params, tokens, state) -> float:
        layer0 = params["controller"][0]
        with torch.no_grad():
            proj = scan_bptt.token_projection(tokens, layer0["kernel"], layer0["bias"])
            perr = max_abs(proj, scan_bptt.token_projection_reference(tokens, layer0["kernel"], layer0["bias"]))
            ref = scan_bptt.bptt_forward_reference(params, ncfg, tokens, state, proj)
            worst = 0.0
            for rows in fwd_tiles(ncfg):
                got = scan_bptt.bptt_forward(params, ncfg, tokens, state, proj, rows_per_block=rows)
                same = same_forward(got, scan_bptt.bptt_forward(params, ncfg, tokens, state, proj, rows_per_block=rows))
                err = forward_errors(got, ref)
                w = max(err, key=err.get)
                log("bptt", f"{name} B={B} T={T} forward at {rows} rows per block vs its plain version on the same "
                            f"projection (projection vs plain {perr:.2e}): max_abs {err[w]:.3e} at {w} (tol {F32_TOL:g}, "
                            f"logits, final state, five residual streams); same bits on a rerun {same}")
                if err[w] > F32_TOL or perr > F32_TOL or not same:
                    raise AssertionError(f"{name}: the forward at {rows} rows disagrees with its plain version")
                worst = max(worst, err[w])
        return worst

    def bwd_tiles(ncfg):
        return [r for r in scan_bptt.BACKWARD_ROWS if scan_bptt.smem_bytes(ncfg, IN, True, r) <= MAX_SMEM_BYTES]

    def fwd_tiles(ncfg):
        return [r for r in scan_bptt.FORWARD_ROWS if scan_bptt.smem_bytes(ncfg, IN, False, r) <= MAX_SMEM_BYTES]

    cases = bptt_cases()
    out, ran, fwd_ran, fwd_worst = {}, {}, {}, 0.0
    for i, (name, (ncfg, B, T)) in enumerate(cases.items()):
        params, tokens, cot = scan_case(ncfg, B, T, 300 + i, dev, IN)
        fwd_worst = max(fwd_worst, forward_check(name, ncfg, B, T, params, tokens, init_ntm_state(params, ncfg, B)))
        ran[name], fwd_ran[name] = bwd_tiles(ncfg), fwd_tiles(ncfg)
        variants = ([(r, None, True) for r in fwd_ran[name]]
                    + [(None, r, g) for r in ran[name] for g in ((True, False) if "flagship" in name else (True,))])
        out[name] = compare(name, ncfg, B, T, ntm_scan_fused_bptt, params, tokens, cot,
                            lambda p, ncfg=ncfg, B=B: init_ntm_state(p, ncfg, B), variants)
    log("bptt", f"f32 gradient error vs T: T=65 (B=70) {out['b_flagship']['grad_rel']:.3e}, "
                f"T=1300 (B=1) {out['a_flagship']['grad_rel']:.3e} relative (tol {GRAD_TOL:g}); forward rows per block "
                f"run per case {fwd_ran}; backward rows per block {ran} (two backward rows do not fit the two-layer "
                f"case's shared memory)")

    # e: w_conv exactly one-hot at T=1: every w_conv entry is 0 or 1, so the
    # gamma gradient is exactly 0 (log 1 = 0, and 0 where w_conv == 0)
    ncfg, B, params, tokens, cot, zero_state, cols, (n_zero, n_one) = wconv_zero_case(dev, IN)
    fwd_worst = max(fwd_worst, forward_check("e_wconv_zero", ncfg, B, 1, params, tokens, zero_state(params)))
    ran["e_wconv_zero"], fwd_ran["e_wconv_zero"] = bwd_tiles(ncfg), fwd_tiles(ncfg)
    for rows in ran["e_wconv_zero"]:
        res = compare(f"e_wconv_zero rows {rows}", ncfg, B, 1, functools.partial(
            ntm_scan_fused_bptt, backward_rows_per_block=rows), params, tokens, cot, zero_state)
        g_gamma = (res["grads"]["heads_b"][cols["gamma"]], res["grads"]["heads_w"][:, cols["gamma"]])
        if any(bool((g != 0).any()) for g in g_gamma):
            raise AssertionError("d/dgamma must be exactly 0 where w_conv is 0 or 1")
    log("bptt", f"e_wconv_zero: {n_zero} w_conv entries exactly 0, {n_one} exactly 1; kernel dgamma "
                f"(heads_b, heads_w gamma columns) exactly 0 and every gradient finite at rows {ran['e_wconv_zero']}")

    # B1 with gradients: the kernel's forward, autograd of the plain loop behind it
    ncfg, B, T = NTMConfig(), 2, 65
    params, tokens, cot = scan_case(ncfg, B, T, 330, dev, IN)
    compare("scan_cell.ntm_scan_fused_trainable", ncfg, B, T, lambda p, c, t, st: ntm_scan_fused_trainable(p, c, t, st),
            params, tokens, cot, lambda p: init_ntm_state(p, ncfg, B))
    return {"backward": ran, "forward": fwd_ran, "forward_max_abs_err": fwd_worst}


def reset_counts() -> None:
    """Set B1's launch counts (in all, by route) and the token projection's
    to 0: both B1 routes launch the projection first."""
    from ntm_tracker_tpu_torch.ops.kernels.scan_bptt import token_projection
    from ntm_tracker_tpu_torch.ops.kernels.scan_cell import ntm_scan_fused

    ntm_scan_fused.launches = token_projection.launches = 0
    for route in ntm_scan_fused.launches_by_route:
        ntm_scan_fused.launches_by_route[route] = 0


def phase_cluster_info(dev: torch.device, IN: int) -> dict:
    """B1's cluster route as the card sees it: the cluster size, one CTA's
    shared memory (the wrapper's count held equal to the kernel's own), its
    registers and local bytes per thread (cudaFuncGetAttributes), the
    clusters resident at once (cudaOccupancyMaxActiveClusters), and which
    configs' slices fit; the tile route's shared memory beside it."""
    from ntm_tracker_tpu_torch.config import NTMConfig
    from ntm_tracker_tpu_torch.ops.kernels import scan_bptt, scan_cell

    ncfg = NTMConfig()
    occ = scan_cell.cluster_occupancy(ncfg, IN, dev)
    c_bytes = scan_cell._library().ntm_scan_cluster_smem_bytes(*scan_cell._dims(ncfg, IN), scan_cell.CLUSTER_SIZE)
    two = NTMConfig(controller_num_layers=2, write_first=True, shift_range=2, write_head_size=2)
    fits = {name: scan_cell.cluster_smem_bytes(c, IN) for name, c in (("flagship", ncfg), ("2layer_2write_s5", two))}
    log("cluster", f"cluster route: {scan_cell.CLUSTER_SIZE} CTAs of {scan_cell.NT_THREADS} threads per batch row; "
                   f"shared memory per CTA {occ['smem_bytes']} B (the wrapper's count {fits['flagship']} B, the kernel's "
                   f"{c_bytes} B; limit {scan_cell.MAX_SMEM_BYTES} B); {occ['registers']} registers and "
                   f"{occ['local_bytes']} local bytes per thread; cudaOccupancyMaxActiveClusters "
                   f"{occ['max_active_clusters']} on {scan_bptt.sm_count(dev)} SMs; the two-layer, two-write config needs "
                   f"{fits['2layer_2write_s5']} B per CTA (the tile route); tile route shared memory per block "
                   + ", ".join(f"{r} rows {scan_bptt.smem_bytes(ncfg, IN, False, r)} B" for r in scan_bptt.FORWARD_ROWS))
    if not occ["smem_bytes"] == fits["flagship"] == c_bytes or occ["max_active_clusters"] < 1:
        raise AssertionError("the cluster route's shared memory counts disagree, or the card holds no cluster")
    return {"cluster_size": scan_cell.CLUSTER_SIZE, **occ, "sms": scan_bptt.sm_count(dev),
            "smem_bytes_2layer_2write_s5": fits["2layer_2write_s5"]}


def route_times(dev: torch.device, smi: str, IN: int, batches=(1, 8, 16, 24, 32, 40, 48, 64), T: int = 65) -> dict:
    """B1 on both routes at the flagship config, T = 65, at each B (CUDA
    events, two turns of 10 calls each, the projection included), with the
    route the rule picks: {B: {"cluster", "tile", "rule"}}."""
    from ntm_tracker_tpu_torch.config import NTMConfig
    from ntm_tracker_tpu_torch.models.ntm_cell import init_ntm_params, init_ntm_state
    from ntm_tracker_tpu_torch.ops.kernels.scan_cell import route_for, run_route

    ncfg = NTMConfig()
    params = init_ntm_params(ncfg, IN, torch.Generator().manual_seed(140), dev)
    out = {}
    with torch.no_grad():
        for B in batches:
            state = init_ntm_state(params, ncfg, B)
            toks = torch.tensor(np.random.RandomState(141).randn(B, T, IN).astype(np.float32), device=dev)
            ms = {r: [] for r in ("cluster", "tile")}
            for rep in range(2):
                for r in (("cluster", "tile") if rep == 0 else ("tile", "cluster")):
                    ms[r].append(cuda_ms(lambda r=r: run_route(r, params, ncfg, toks, state), iters=10, warmup=2))
            out[B] = {r: float(np.mean(v)) for r, v in ms.items()}
            out[B]["rule"] = route_for(ncfg, B, IN, dev)
    log("times", f"{smi}: B1 by route at T={T} (flagship, the projection included; CUDA events, 2 x 10 calls in "
                 f"turns): " + "; ".join(f"B={B} cluster {v['cluster']:.4f} ms, tile {v['tile']:.4f} ms (rule: "
                                         f"{v['rule']})" for B, v in out.items()))
    return out


def addressing_inputs(ncfg, B: int, seed: int, dev: torch.device) -> list:
    """B3's nine inputs as the cell step hands them over: the head controls
    are views into one [B, P] tensor (torch.split, then reshape), M_prev
    and w_prev a plausible memory and softmaxed weights."""
    from ntm_tracker_tpu_torch.models.ntm_cell import HEAD_PARAM_ORDER, head_param_sizes

    rs = np.random.RandomState(seed)
    N, D, H = ncfg.mem_size, ncfg.mem_dim, ncfg.num_heads
    W, S = ncfg.write_head_size, ncfg.shift_space
    sizes = head_param_sizes(ncfg)
    ctl = torch.tensor(rs.randn(B, sum(sizes.values())).astype(np.float32), device=dev)
    k, beta, g, sw, gamma, erase, add = torch.split(ctl, [sizes[n] for n in HEAD_PARAM_ORDER], dim=1)
    M = torch.tensor(np.tanh(rs.randn(B, N, D)).astype(np.float32), device=dev)
    w = torch.softmax(torch.tensor(rs.randn(B, H, N).astype(np.float32), device=dev), dim=-1)
    return [k.reshape(B, H, D), beta, g, sw.reshape(B, H, S), gamma, erase.reshape(B, W, D),
            add.reshape(B, W, D), M, w]


def addressing_probe_split(dev: torch.device, smi: str) -> dict:
    """B3's per-phase split on the card: its probe variant (clock64() by
    thread 0 after every block barrier, and inside head 0's chain) at B = 1
    and 64 on the flagship config, each block's cycles per span (mean and
    max over the blocks of the last of 20 calls) converted to us by the SM
    clock (cudaDevAttrClockRate); beside it the device time of an empty
    kernel (torch.profiler), the floor of any one-launch B3. The probe's
    outputs are held to the default kernel's bits."""
    from ntm_tracker_tpu_torch.config import NTMConfig
    from ntm_tracker_tpu_torch.ops.kernels import addressing

    ncfg = NTMConfig()
    kw = dict(read_heads=ncfg.read_head_size, write_first=ncfg.write_first, slotwise=ncfg.slotwise_cosine)
    khz = addressing.sm_clock_khz(dev)
    split = {}
    with torch.no_grad():
        for B in (1, FLEET_CAP):
            args = addressing_inputs(ncfg, B, 450 + B, dev)
            for _ in range(20):
                out, spans = addressing.addressing_probe(*args, **kw)
            if not all(torch.equal(a, b) for a, b in zip(out, addressing.fused_ntm_addressing(*args, **kw))):
                raise AssertionError("B3's probe variant disagrees with the default kernel")
            split[B] = {name: {"cycles": float(v.double().mean()), "max_cycles": int(v.max()),
                               "us": float(v.double().mean()) / khz * 1e3} for name, v in spans.items()}
            total = sum(p["cycles"] for name, p in split[B].items() if not name.startswith("chain"))
            log("probe", f"{smi}: B3 at B={B} (flagship; SM clock {khz / 1e3:.0f} MHz, cudaDevAttrClockRate; mean "
                         f"over {B} blocks): " + "; ".join(f"{name} {p['cycles']:.0f} cyc {p['us']:.3f} us"
                                                           for name, p in split[B].items())
                         + f"; entry to the end {total:.0f} cyc {total / khz * 1e3:.3f} us")
        prof = device_profile(lambda: addressing.empty_launch(dev), reps=200)
        empty_ms = prof["busy_ms"]
    log("probe", f"{smi}: an empty kernel launch: "
                 f"{'not measured' if empty_ms is None else f'{empty_ms * 1e3:.3f} us'} of device time "
                 f"(torch.profiler, 200 launches)")
    return {"sm_clock_khz": khz, "phases": {str(B): v for B, v in split.items()}, "empty_launch_ms": empty_ms}


def phase_addressing(dev: torch.device, smi: str) -> dict:
    """B3 against its plain version on the card: the flagship shape at
    B = 1, 64 and 256 and four variants (M, w and read within F32_TOL, the
    same bits on a rerun); its gradient through the autograd Function
    against autograd of the plain version; then its time alone beside the
    plain version's and the bound."""
    from ntm_tracker_tpu_torch.config import NTMConfig
    from ntm_tracker_tpu_torch.ops.kernels.addressing import (
        _library,
        addressing_smem_bytes,
        fused_ntm_addressing,
        fused_ntm_addressing_reference,
    )

    def kw(ncfg):
        return dict(read_heads=ncfg.read_head_size, write_first=ncfg.write_first, slotwise=ncfg.slotwise_cosine)

    cases = {
        "a_flagship_b1": (NTMConfig(), 1),
        "b_flagship_b64": (NTMConfig(), 64),
        "c_flagship_b256": (NTMConfig(), 256),
        "d_write_first": (NTMConfig(write_first=True), 8),
        "e_slotwise": (NTMConfig(slotwise_cosine=True), 8),
        "f_2write_s5": (NTMConfig(write_head_size=2, shift_range=2), 8),
        "g_n16_d8": (NTMConfig(mem_size=16, mem_dim=8, read_head_size=2), 8),
    }
    worst, failed = 0.0, []
    # the wrapper's count of B3's shared memory against the kernel's own
    for ncfg, _ in cases.values():
        dims = (ncfg.mem_size, ncfg.mem_dim, ncfg.num_heads, ncfg.read_head_size, ncfg.write_head_size,
                ncfg.shift_space)
        mirror, kernel = addressing_smem_bytes(*dims), _library().ntm_addressing_smem_bytes(*dims)
        if mirror != kernel:
            raise AssertionError(f"B3's shared memory: the wrapper counts {mirror} B, the kernel {kernel} B")
    with torch.no_grad():
        for i, (name, (ncfg, B)) in enumerate(cases.items()):
            args = addressing_inputs(ncfg, B, 400 + i, dev)
            got = fused_ntm_addressing(*args, **kw(ncfg))
            torch.cuda.synchronize()
            again = fused_ntm_addressing(*args, **kw(ncfg))
            ref = fused_ntm_addressing_reference(*args, **kw(ncfg))
            errs = [max_abs(a, b) for a, b in zip(got, ref)]
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            finite = all(bool(torch.isfinite(t).all()) for t in got)
            log("addressing", f"{name} B={B} N={ncfg.mem_size} D={ncfg.mem_dim} H={ncfg.num_heads} W={ncfg.write_head_size} "
                              f"S={ncfg.shift_space}: max_abs M {errs[0]:.3e} w {errs[1]:.3e} read {errs[2]:.3e} "
                              f"(tol {F32_TOL:g}); same bits on a rerun {same}; finite {finite}")
            if name.startswith(("a_", "b_", "c_")):
                worst = max(worst, *errs)
            if max(errs) > F32_TOL or not same or not finite:
                failed.append(name)

    # the gradient: the Function's backward is autograd of the plain version
    ncfg, B = NTMConfig(), 8
    args = addressing_inputs(ncfg, B, 420, dev)
    rs = np.random.RandomState(421)
    cot = [torch.tensor(rs.randn(*shape).astype(np.float32), device=dev)
           for shape in ((B, ncfg.mem_size, ncfg.mem_dim), (B, ncfg.num_heads, ncfg.mem_size),
                         (B, ncfg.read_head_size, ncfg.mem_dim))]

    def grads(fn):
        leaves = [t.detach().clone().requires_grad_() for t in args]
        loss = sum((o * c).sum() for o, c in zip(fn(*leaves, **kw(ncfg)), cot))
        return torch.autograd.grad(loss, leaves)

    before = fused_ntm_addressing.launches
    gk = grads(fused_ntm_addressing)
    through_kernel = fused_ntm_addressing.launches - before
    gp = grads(fused_ntm_addressing_reference)
    gerr = max(max_abs(a, b) for a, b in zip(gk, gp))
    log("addressing", f"gradient B={B} through the autograd Function ({through_kernel} launch) vs autograd of the plain "
                      f"version, every input: max_abs {gerr:.3e} (tol {F32_TOL:g})")
    if through_kernel != 1 or gerr > F32_TOL:
        failed.append("gradient")
    if failed:
        raise AssertionError(f"B3 disagrees with its plain version: {failed}")

    times = {}
    with torch.no_grad():
        for B in (1, 64, 256):
            args = addressing_inputs(NTMConfig(), B, 430, dev)
            k_ms = cuda_ms(lambda: fused_ntm_addressing(*args, **kw(NTMConfig())), iters=200, warmup=10)
            p_ms = cuda_ms(lambda: fused_ntm_addressing_reference(*args, **kw(NTMConfig())), iters=50, warmup=5)
            b_ms, b_by = bound(*addressing_work(NTMConfig(), B))
            prof = device_profile(lambda: fused_ntm_addressing(*args, **kw(NTMConfig())), reps=50)
            dev_ms = prof["busy_ms"]
            times[B] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "device_ms": dev_ms}
            log("times", f"{smi}: B3 at B={B} (flagship): {k_ms:.4f} ms per call (CUDA events over 200 calls, "
                         f"the wrapper's host work included), kernel alone on the card "
                         f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'} (torch.profiler, 50 calls), "
                         f"plain {p_ms:.4f} ms, bound {b_ms * 1e3:.4f} us by {b_by}")
    probe = addressing_probe_split(dev, smi)
    return {"max_abs_err": worst, "grad_err": gerr, "times": times, "probe": probe}


def fleet_regions(n: int, hw=FLEET_HW) -> list:
    """n (x, y, w, h) regions on a grid over the frame, 16 to a row."""
    H, W = hw
    return [(16.0 + (i % 16) * (W - 96) / 16, 16.0 + (i // 16 % 16) * (H - 80) / 16, 64.0, 48.0)
            for i in range(n)]


def normalized_bboxes(regions, hw=FLEET_HW) -> np.ndarray:
    """(x, y, w, h) pixel regions -> [n, 4] y1x1y2x2 in the tracker's
    /(dim-1) normalization, the device loop's input."""
    H, W = hw
    return np.asarray([[y / (H - 1), x / (W - 1), (y + h) / (H - 1), (x + w) / (W - 1)]
                       for x, y, w, h in regions], np.float32)


def phase_fleet(dev: torch.device, smi: str, cfg, vgg, params) -> dict:
    """The fleet slice at full width with NTMConfig.use_pallas: FleetTracker
    at capacity 64 on 360x640 frames (64 adds, 10 fleet steps) and
    make_device_track_step at B=64 (init and 10 steps), each run with the
    launch counts set to 0 before it and read after it. Then the first
    fleet step against the plain per-step route on the same crops and
    state, two slots against StreamingTracker, the device loop's drift
    against StreamingTracker, and the times of the fleet step on three
    cell routes and of the device loop."""
    import copy

    from ntm_tracker_tpu_torch.models.core import make_core
    from ntm_tracker_tpu_torch.ops.kernels.addressing import fused_ntm_addressing
    from ntm_tracker_tpu_torch.ops.kernels.scan_bptt import token_projection
    from ntm_tracker_tpu_torch.ops.kernels.scan_cell import ntm_scan_fused
    from ntm_tracker_tpu_torch.tracking.fleet import FleetTracker
    from ntm_tracker_tpu_torch.tracking.tracker import StreamingTracker, build_frame_step, make_device_track_step

    T = cfg.tokens_per_frame
    cfg_p = dataclasses.replace(cfg, ntm=dataclasses.replace(cfg.ntm, use_pallas=True))
    video, _ = synthetic_video(seed=1, frames=1 + FLEET_STEPS, hw=FLEET_HW)
    regions = fleet_regions(FLEET_CAP)
    kernels = (ntm_scan_fused, fused_ntm_addressing)
    failed = []

    # ---- the main path: the fleet at capacity 64 --------------------------------
    fleet = FleetTracker(cfg_p, vgg, params, capacity=FLEET_CAP, device=dev)
    first_call = []
    rest = fleet._step_rest

    def recording_rest(crops, state):
        out = rest(crops, state)
        if not first_call:
            first_call.append((crops, state, out))
        return out

    fleet._step_rest = recording_rest
    reset_counts()
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slots = [fleet.add(video[0], r) for r in regions]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    outs = [fleet.step({s: video[t] for s in slots}) for t in range(1, 1 + FLEET_STEPS)]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    fleet_counts = {k.__name__: k.launches for k in kernels}
    fleet_counts["token_projection"] = token_projection.launches
    fleet_routes = dict(ntm_scan_fused.launches_by_route)
    expected = {"ntm_scan_fused": FLEET_CAP, "fused_ntm_addressing": T * FLEET_STEPS, "token_projection": FLEET_CAP}
    arr = np.asarray([[out[s] for s in slots] for out in outs], np.float64)
    log("fleet", f"FleetTracker use_pallas=True capacity {FLEET_CAP} on {FLEET_HW[0]}x{FLEET_HW[1]} frames: {FLEET_CAP} adds "
                 f"{t1 - t0:.2f}s, {FLEET_STEPS} steps {t2 - t1:.2f}s; launches {fleet_counts} (expected {expected}: B1 once "
                 f"per add at B=1, after its projection; B3 {T} times per fleet step), B1 by route {fleet_routes}; "
                 f"regions {arr.shape}, finite {bool(np.isfinite(arr).all())}, slot 0 {[round(v, 2) for v in arr[-1, 0]]}")
    if (fleet_counts != expected or fleet_routes != {"cluster": FLEET_CAP, "tile": 0}
            or not np.isfinite(arr).all()):
        failed.append("fleet launches or regions")

    # the first fleet step against the plain per-step route (use_pallas off)
    # on the same weights, crops and state
    crops0, state0, (off0, st0) = first_call[0]
    cfg_plain = dataclasses.replace(cfg, fused_inference=False)
    _, rest_plain = build_frame_step(cfg_plain, make_core(cfg_plain), vgg, params, device=dev)
    off_p, st_p = rest_plain(crops0, state0)
    diffs = state_diffs(off0[:, None], st0, off_p[:, None], st_p)
    log("fleet", f"first fleet step, B3 route vs the plain per-step route on the same crops and state: "
                 + " ".join(f"{k}={v:.2e}" for k, v in diffs.items()) + f" (tol {F32_TOL:g}; logits = offsets)")
    if max(diffs.values()) > F32_TOL:
        failed.append("fleet step vs plain route")

    # ---- the main path: the device-resident loop at B=64 ------------------------
    frames = [torch.as_tensor(np.stack([video[t]] * FLEET_CAP)).to(dev) for t in range(1 + FLEET_STEPS)]
    core_p = make_core(cfg_p)
    init_fn, step_fn = make_device_track_step(cfg_p, core_p, vgg, params, device=dev)
    bbox = torch.as_tensor(normalized_bboxes(regions), device=dev)
    state = core_p.init_state(params, FLEET_CAP)
    reset_counts()
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = init_fn(frames[0], bbox, state)
    loop_regions = []
    for t in range(1, 1 + FLEET_STEPS):
        region, bbox, state = step_fn(frames[t], bbox, state)
        loop_regions.append(region)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    loop_counts = {k.__name__: k.launches for k in kernels}
    loop_counts["token_projection"] = token_projection.launches
    loop_expected = {"ntm_scan_fused": 0, "fused_ntm_addressing": T * (1 + FLEET_STEPS), "token_projection": 0}
    loop_arr = torch.stack(loop_regions).cpu().double().numpy()
    log("fleet", f"make_device_track_step use_pallas=True B={FLEET_CAP}: init + {FLEET_STEPS} steps {loop_s:.2f}s; "
                 f"launches {loop_counts} (expected {loop_expected}); finite {bool(np.isfinite(loop_arr).all())}")
    if loop_counts != loop_expected or not np.isfinite(loop_arr).all():
        failed.append("device loop launches or regions")

    # two slots against a StreamingTracker each (B1 at B=1, gather crop)
    drift = {}
    for slot in (0, FLEET_CAP * 37 // 64):
        trk = StreamingTracker(cfg_p, vgg, params, device=dev)
        trk.init(video[0], regions[slot])
        host = np.asarray([trk.track(video[t]) for t in range(1, 1 + FLEET_STEPS)], np.float64)
        fleet_err = float(np.abs(arr[0, slot] - host[0]).max())
        loop_err = float(np.abs(loop_arr[:3, slot] - host[:3]).max())
        drift[slot] = np.abs(loop_arr[:, slot] - host).max(axis=1)
        log("fleet", f"slot {slot} vs StreamingTracker: fleet first frame max |region diff| {fleet_err:.3e} px "
                     f"(tol {REGION_TOL_PX:g}); device loop first 3 frames {loop_err:.3e} px (tol {LOOP_TOL_PX:g}); "
                     f"device loop drift per frame over {FLEET_STEPS} frames (px, not held) "
                     f"{[float(f'{v:.3g}') for v in drift[slot]]}; fleet drift {np.abs(arr[:, slot] - host).max():.3e} px")
        if fleet_err > REGION_TOL_PX or loop_err > LOOP_TOL_PX:
            failed.append(f"slot {slot} vs StreamingTracker")
    if failed:
        raise AssertionError(f"fleet phase: {failed}")
    check_budget("fleet")

    # ---- times: the fleet step on three cell routes, and the device loop --------
    routes = {
        "B1": dataclasses.replace(cfg, fused_inference=True),
        "plain": dataclasses.replace(cfg, fused_inference=False),
        "B3": dataclasses.replace(cfg_p, fused_inference=False),
    }
    fleet_ms = {}
    for cap in FLEET_TIME_CAPS:
        regs = fleet_regions(cap)
        base = FleetTracker(routes["B1"], vgg, params, capacity=cap, device=dev)
        caps_slots = [base.add(video[0], r) for r in regs]
        fleets = {}
        for name, c in routes.items():
            f = FleetTracker(c, vgg, params, capacity=cap, device=dev)
            f.state, f._tracks = base.state, copy.deepcopy(base._tracks)
            f.step({s: video[1] for s in caps_slots})  # warm-up
            fleets[name] = f
        ms = {name: [] for name in routes}
        for rep in range(3):  # routes in turns, so drift in the card's clocks spreads evenly
            for name in (list(routes) if rep % 2 == 0 else list(routes)[::-1]):
                torch.cuda.synchronize()
                s0 = time.perf_counter()
                fleets[name].step({s: video[1 + (1 + rep) % FLEET_STEPS] for s in caps_slots})
                torch.cuda.synchronize()
                ms[name].append(1e3 * (time.perf_counter() - s0))
        fleet_ms[cap] = {name: float(np.median(v)) for name, v in ms.items()}
        log("times", f"{smi}: fleet step at capacity {cap} (np.stack + upload + crop + VGG + 65 cell steps + decode), "
                     f"median of 3: " + ", ".join(f"{n} {fleet_ms[cap][n]:.2f} ms = {cap / fleet_ms[cap][n] * 1e3:.1f} "
                                                  f"tracked frames/s" for n in routes))
        if cap == FLEET_CAP:
            for name, f in fleets.items():
                prof = device_profile(lambda f=f: f.step({s: video[1] for s in caps_slots}), reps=2)
                idle = None if prof["busy_ms"] is None else 1 - prof["busy_ms"] / fleet_ms[cap][name]
                log("profile", f"{smi}: fleet step capacity {cap} route {name}: kernels {prof['busy_ms']} ms and copies "
                               f"{prof['copy_ms']} ms of device time per step ({prof['kernels_per_call']:.0f} kernels), "
                               f"idle share {idle} of the {fleet_ms[cap][name]:.2f} ms step; top kernels {prof['top']}")
        del base, fleets
        check_budget("fleet times")

    # the frame step alone, crops already on the card: the cell route's
    # share without the fleet's host work (stack, upload, decode)
    steps = {name: build_frame_step(c, make_core(c), vgg, params, device=dev)[1] for name, c in routes.items()}
    frame_ms = {}
    for cap in FLEET_TIME_CAPS:
        crops = torch.tensor(np.random.RandomState(cap).uniform(-120, 120, (cap, cfg.data.crop_size, cfg.data.crop_size, 3)).astype(np.float32),
                             device=dev)
        st0 = core_p.init_state(params, cap)
        ms = {name: [] for name in routes}
        for name in routes:
            steps[name](crops, st0)  # warm-up
        for rep in range(3):
            for name in (list(routes) if rep % 2 == 0 else list(routes)[::-1]):
                torch.cuda.synchronize()
                s0 = time.perf_counter()
                steps[name](crops, st0)
                torch.cuda.synchronize()
                ms[name].append(1e3 * (time.perf_counter() - s0))
        frame_ms[cap] = {name: float(np.median(v)) for name, v in ms.items()}
        log("times", f"{smi}: frame step alone at B={cap} (crops on the card: VGG + 65 cell steps), median of 3: "
                     + ", ".join(f"{n} {frame_ms[cap][n]:.2f} ms" for n in routes))
        del crops

    loop_ms = {}
    for cap in (64, 256):
        dframes = [torch.as_tensor(np.stack([video[t % len(video)]] * cap)).to(dev) for t in range(4)]
        init_fn, step_fn = make_device_track_step(cfg_p, core_p, vgg, params, device=dev)
        bb = torch.as_tensor(normalized_bboxes(fleet_regions(cap)), device=dev)
        st = init_fn(dframes[0], bb, core_p.init_state(params, cap))
        _, bb, st = step_fn(dframes[1], bb, st)  # warm-up
        times = []
        for t in range(3):
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            _, bb, st = step_fn(dframes[1 + t], bb, st)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - s0))
        loop_ms[cap] = float(np.median(times))
        prof = device_profile(lambda: step_fn(dframes[2], bb, st), reps=2)
        idle = None if prof["busy_ms"] is None else 1 - prof["busy_ms"] / loop_ms[cap]
        log("times", f"{smi}: device loop step (B3 route) at B={cap}, frames on the card: median of 3 "
                     f"{loop_ms[cap]:.2f} ms = {cap / loop_ms[cap] * 1e3:.1f} frames/s; kernels {prof['busy_ms']} ms of "
                     f"device time per step ({prof['kernels_per_call']:.0f} kernels), idle share {idle}; "
                     f"top kernels {prof['top']}")
        del dframes
    check_budget("fleet times")
    return {"fleet_counts": fleet_counts, "fleet_routes": fleet_routes, "loop_counts": loop_counts,
            "fleet_ms": fleet_ms, "loop_ms": loop_ms, "frame_ms": frame_ms}


def offsets_grads(exp, params, batch, dtype=torch.float32):
    """The offsets loss of OffsetExperiment.loss_fn through exp's unroll
    route, and its gradient: (loss, logits, grads in tree_leaves order,
    forward ms, backward ms by CUDA events). dtype=float64 runs the plain
    loop in double precision, as a referee for the two float32 routes."""
    from ntm_tracker_tpu_torch.train.optim import tree_leaves, tree_map
    from ntm_tracker_tpu_torch.train.serialize import offsets_loss, serialize_tokens

    cfg, L = exp.cfg, exp.cfg.train.sequence_length
    live = tree_map(lambda t: t.detach().to(dtype).requires_grad_(), params)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    features = exp.batch_features(batch).to(dtype)
    B = features.shape[0]
    tokens = serialize_tokens(features, batch["gts"].to(dtype).reshape(B, L, cfg.num_features)[:, 0])
    logits, _ = exp.core.unroll(live, tokens)
    loss = offsets_loss(logits, exp._targets(batch, B).to(dtype), cfg.num_features)
    ev[1].record()
    grads = torch.autograd.grad(loss, tree_leaves(live))
    ev[2].record()
    torch.cuda.synchronize()
    return float(loss.detach()), logits.detach(), grads, ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])


def step_errors(params, fused, plain) -> dict:
    """Fused vs plain train step from the same params: each is (loss,
    grads in tree_leaves order, params after, opt state after). The step
    the optimizer applies is opt_state["mom"] (new params = params - mom);
    new minus old params also carries the f32 rounding of that
    subtraction, up to half an ulp of the parameter on each side, so it is
    printed with that share beside it and not held."""
    from ntm_tracker_tpu_torch.train.optim import tree_leaves

    names = list(named_leaves(params))
    (lf, gf, qf, sf), (lp, gp, qp, sp) = fused, plain
    grad = grad_errors(dict(zip(names, gf)), dict(zip(names, gp)))
    step = grad_errors(dict(zip(names, tree_leaves(sf["mom"]))), dict(zip(names, tree_leaves(sp["mom"]))))
    p0 = tree_leaves(params)
    diff = grad_errors({k: a - b for k, a, b in zip(names, tree_leaves(qf), p0)},
                       {k: a - b for k, a, b in zip(names, tree_leaves(qp), p0)})
    wd = max(diff, key=diff.get)
    i = names.index(wd)
    ulp = float(np.spacing(np.float32(float(p0[i].abs().max())))) / max(float(tree_leaves(sp["mom"])[i].abs().max()), 1e-30)
    return {"loss": abs(lf - lp) / max(1.0, abs(lp)), "grad": grad, "step": step,
            "grad_abs": max(max_abs(a, b) for a, b in zip(gf, gp)),
            "diff": (wd, diff[wd], ulp)}


def report_step(tag: str, err: dict) -> None:
    gw, sw = max(err["grad"], key=err["grad"].get), max(err["step"], key=err["step"].get)
    wd, dv, ulp = err["diff"]
    log("train", f"{tag}: loss rel {err['loss']:.2e} (tol {F32_TOL:g}); raw gradients max rel {err['grad'][gw]:.2e} "
                 f"at {gw}, max abs {err['grad_abs']:.3e}; optimizer step (mom) max rel {err['step'][sw]:.2e} at {sw} "
                 f"(tol {GRAD_TOL:g} each); new minus old params max rel {dv:.2e} at {wd}, where ulp(max|p|) / "
                 f"max|step| = {ulp:.2e} (f32 rounding of p - step, not held)")
    if err["loss"] > F32_TOL or err["grad"][gw] > GRAD_TOL or err["step"][sw] > GRAD_TOL:
        raise AssertionError(f"{tag}: the fused train step disagrees with the plain one")


def phase_train(dev: torch.device, smi: str, IN: int) -> dict:
    """The training slice at full width: OffsetExperiment on cached tokens,
    B=256 rows of L=20 frames (T=1300), through the fused BPTT kernels;
    the main path's first step held against the plain autograd step from
    the same params at the same shape (and again at B=8); then the
    kernels' own times."""
    from ntm_tracker_tpu_torch.config import TrackerConfig, TrainConfig
    from ntm_tracker_tpu_torch.models.ntm_cell import init_ntm_state
    from ntm_tracker_tpu_torch.ops.kernels import scan_bptt
    from ntm_tracker_tpu_torch.ops.kernels.scan_cell import ntm_scan_fused, route_for, run_route
    from ntm_tracker_tpu_torch.train.experiments import OffsetExperiment, synthetic_cached_batch
    from ntm_tracker_tpu_torch.train.optim import tree_leaves, tree_map
    from ntm_tracker_tpu_torch.train.serialize import serialize_tokens

    base = TrackerConfig(train=TrainConfig(batch_size=TRAIN_B, sequence_length=TRAIN_L))
    ncfg, L = base.ntm, base.ntm.controller_num_layers
    exp = OffsetExperiment(base, None, device=dev)  # fused_bptt="auto": the kernels on cuda at f32
    params, opt_state = exp.init(torch.Generator().manual_seed(1))
    t0 = time.perf_counter()
    batch = exp.device_batch(synthetic_cached_batch(base, np.random.RandomState(0)))
    log("train", f"synthetic cached batch B={TRAIN_B} L={TRAIN_L} (float16 tokens {tuple(batch['features'].shape)}) "
                 f"made and uploaded in {time.perf_counter() - t0:.1f}s")
    train_step, eval_step = exp.make_train_step(), exp.make_eval_step()
    kernels = (ntm_scan_fused, scan_bptt.bptt_forward, scan_bptt.token_projection, scan_bptt.bptt_backward,
               scan_bptt.grad_reduce)

    # ---- the main path: 1 warm-up + 3 timed train steps, 1 eval step -----------
    reset_counts()
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    p1, s1, m = train_step(params, opt_state, batch)
    p, s = p1, s1
    losses, step_ms = [float(m["loss"])], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, s, m = train_step(p, s, batch)
        losses.append(float(m["loss"]))
        step_ms.append(1e3 * (time.perf_counter() - t0))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aux = eval_step(p, batch)
    eval_loss = float(aux["loss"])
    eval_ms = 1e3 * (time.perf_counter() - t0)
    counts = {k.__name__: k.launches for k in kernels}
    eval_routes = dict(ntm_scan_fused.launches_by_route)
    expected = {"ntm_scan_fused": 1, "bptt_forward": 4, "token_projection": 5, "bptt_backward": 4,
                "grad_reduce": 4 * (L + 1)}
    log("train", f"main path launches {counts} (expected {expected}: a projection per train step and one for the "
                 f"eval step's B1; each grad_reduce call is two kernels, the partial sums and their fixed-order sum; "
                 f"one call per LSTM layer and one for the head and output linears together); B1 by route "
                 f"{eval_routes}")
    if counts != expected or eval_routes != {"cluster": 0, "tile": 1}:
        raise AssertionError("the training path did not run through the kernels as expected")
    # an update far below a parameter's ulp leaves it as it was (init_w's
    # gradient is small), so the check is on the parameters as a whole
    changed = {k: int((a != b).sum()) for k, a, b in zip(named_leaves(p), tree_leaves(params), tree_leaves(p))}
    if not (np.isfinite(losses).all() and np.isfinite(eval_loss) and changed["controller[0].kernel"] > 0):
        raise AssertionError(f"bad training run: losses {losses}, eval {eval_loss}, elements changed {changed}")
    log("train", f"elements changed by the 4 steps, per parameter: {changed}")
    step = float(np.median(step_ms))
    log("train", f"{smi}: fused train step B={TRAIN_B} T={base.total_steps} "
                 f"steps {[round(t, 3) for t in step_ms]} ms, median {step:.3f} ms = "
                 f"{TRAIN_B * TRAIN_L / step * 1e3:.1f} trained frames/s; losses {[round(v, 6) for v in losses]}; "
                 f"peak {peak_gb:.2f} GB; eval step (B1, no residuals) {eval_ms:.3f} ms, loss {eval_loss:.6f}")
    check_budget("train")

    # ---- the main path's first step against the plain autograd step at B=256 ------
    opt = exp.optimizer()
    floss, flogits, fgrads, _, _ = offsets_grads(exp, params, batch)
    expp = OffsetExperiment(dataclasses.replace(base, train=dataclasses.replace(base.train, fused_bptt=False)),
                            None, device=dev)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ploss, plogits, pgrads, plain_fwd, plain_bwd = offsets_grads(expp, params, batch)
    it = iter(pgrads)
    qp, sp = opt.update(tree_map(lambda _: next(it), params), opt_state, params)
    torch.cuda.synchronize()
    plain_step = 1e3 * (time.perf_counter() - t0)
    log("train", f"{smi}: plain autograd train step B={TRAIN_B} T={base.total_steps} (remat full: each step checkpointed) "
                 f"{plain_step:.1f} ms = {TRAIN_B * TRAIN_L / plain_step * 1e3:.1f} frames/s "
                 f"(forward {plain_fwd:.1f} ms, backward {plain_bwd:.1f} ms, CUDA events); "
                 f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; loss {ploss:.6f}")
    fwd_err256 = max_abs(flogits, plogits)
    err256 = step_errors(params, (losses[0], fgrads, p1, s1), (ploss, pgrads, qp, sp))
    with torch.no_grad():
        eval0 = float(eval_step(params, batch)["loss"])
    eval_err = abs(eval0 - ploss) / max(1.0, abs(ploss))
    log("train", f"B={TRAIN_B} T={base.total_steps}: fused (B2) logits vs plain max_abs {fwd_err256:.3e} (tol {F32_TOL:g}); "
                 f"B2 loss {floss:.6f}, main path's first step {losses[0]:.6f}, plain {ploss:.6f}; eval step (B1) "
                 f"loss from the same params {eval0:.6f}, rel {eval_err:.2e} (tol {F32_TOL:g})")
    report_step(f"B={TRAIN_B} main path's first step vs plain", err256)
    if fwd_err256 > F32_TOL or eval_err > F32_TOL or abs(floss - losses[0]) > F32_TOL * max(1.0, abs(ploss)):
        raise AssertionError("the fused forward disagrees with the plain one at the main path's shape")
    # both float32 routes against the plain loop in float64: which of them
    # carries the gap between them
    t0 = time.perf_counter()
    g64 = offsets_grads(expp, params, batch, torch.float64)[2]
    names = list(named_leaves(params))
    vs64 = {tag: grad_errors(dict(zip(names, g)), dict(zip(names, g64))) for tag, g in (("fused", fgrads), ("plain", pgrads))}
    log("train", f"B={TRAIN_B} gradients vs the plain loop in float64 ({time.perf_counter() - t0:.1f}s), max rel per "
                 f"parameter, fused / plain float32: "
                 + ", ".join(f"{k} {vs64['fused'][k]:.2e} / {vs64['plain'][k]:.2e}" for k in names))
    worst64 = max(vs64["fused"].values())
    if worst64 > GRAD_TOL:
        raise AssertionError(f"the fused gradients are {worst64:.2e} from the float64 ones (tol {GRAD_TOL:g})")
    f64_err = {"fused": worst64, "plain": max(vs64["plain"].values())}
    del fgrads, pgrads, g64, qp, sp
    check_budget("train")

    # ---- one fused step against one plain autograd step at B=8 --------------------
    # at L=B8_L frames (T=650), half the main path's depth: the plain step's
    # eager loop costs ~14 s a pass at T=1300, and the B=256 step above is
    # held at the full depth
    cfg8 = dataclasses.replace(base, train=dataclasses.replace(base.train, batch_size=8, sequence_length=B8_L,
                                                               fused_bptt=True))
    cfg8p = dataclasses.replace(cfg8, train=dataclasses.replace(cfg8.train, fused_bptt=False))
    batch8 = exp.device_batch(synthetic_cached_batch(cfg8, np.random.RandomState(1)))
    runs, ms8 = {}, {}
    for tag, c in (("fused", cfg8), ("plain", cfg8p)):
        e = OffsetExperiment(c, None, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q, s8, mm = e.make_train_step()(params, opt_state, batch8)
        ms8[tag] = 1e3 * (time.perf_counter() - t0)
        runs[tag] = (float(mm["loss"]), offsets_grads(e, params, batch8)[2], q, s8)
    report_step(f"B=8 T={cfg8.total_steps} one step fused vs plain autograd (remat full), "
                f"step {ms8['fused']:.1f} ms fused vs {ms8['plain']:.1f} ms plain (host clock)",
                step_errors(params, runs["fused"], runs["plain"]))
    del runs
    check_budget("train")

    # ---- the kernels alone at the main path's shape ---------------------------------
    with torch.no_grad():
        feats = exp.batch_features(batch)
        tokens = serialize_tokens(feats, batch["gts"].float().reshape(TRAIN_B, TRAIN_L, -1)[:, 0]).contiguous()
        state = init_ntm_state(params, ncfg, TRAIN_B)
        B, T, _ = tokens.shape
        b1_route = route_for(ncfg, B, IN, dev)
        b1_logits, b1_final = ntm_scan_fused(params, ncfg, tokens, state)
        b1_err = max_abs(b1_logits, plogits)
        b1_ms = cuda_ms(lambda: ntm_scan_fused(params, ncfg, tokens, state), iters=2, warmup=0)
        # the other route at this shape (the rule does not pick it here)
        other = "cluster" if b1_route == "tile" else "tile"
        b1_ms_by_route = {b1_route: b1_ms,
                          other: cuda_ms(lambda: run_route(other, params, ncfg, tokens, state), iters=1, warmup=0)}
        # the token projection, its plain version and one library call, in
        # turns
        W0, b0 = params["controller"][0]["kernel"], params["controller"][0]["bias"]
        proj = scan_bptt.token_projection(tokens, W0, b0)
        proj_err = max_abs(proj, scan_bptt.token_projection_reference(tokens, W0, b0))
        proj_same = torch.equal(proj, scan_bptt.token_projection(tokens, W0, b0))
        proj_fns = {
            "kernel": lambda: scan_bptt.token_projection(tokens, W0, b0),
            "plain": lambda: scan_bptt.token_projection_reference(tokens, W0, b0),
            "torch.addmm": lambda: torch.addmm(b0, tokens.reshape(B * T, IN), W0[:IN]),
        }
        proj_ms_by = {name: [] for name in proj_fns}
        for rep in range(2):
            for name in (list(proj_fns) if rep == 0 else list(proj_fns)[::-1]):
                proj_ms_by[name].append(cuda_ms(proj_fns[name], iters=5, warmup=1))
        proj_ms, proj_plain_ms, proj_lib_ms = (float(np.mean(v)) for v in proj_ms_by.values())
        proj_tile = scan_bptt.gemm_tile(B * T, W0.shape[1])
        # the forward on that projection: against its plain version at
        # every tile, the same bits on a rerun, then timed at every tile
        fwd_rows = scan_bptt.forward_tile(ncfg, IN, B, dev)
        t0 = time.perf_counter()
        fwd_ref = scan_bptt.bptt_forward_reference(params, ncfg, tokens, state, proj)
        fwd_ref_s = time.perf_counter() - t0
        fwd_err, fwd_same = {}, True
        for r in scan_bptt.FORWARD_ROWS:
            got = scan_bptt.bptt_forward(params, ncfg, tokens, state, proj, rows_per_block=r)
            fwd_same = fwd_same and same_forward(got, scan_bptt.bptt_forward(params, ncfg, tokens, state, proj,
                                                                             rows_per_block=r))
            fwd_err[r] = max(forward_errors(got, fwd_ref).values())
            del got
        del fwd_ref
        fwd_ms_by = {r: cuda_ms(lambda r=r: scan_bptt.bptt_forward(params, ncfg, tokens, state, proj, rows_per_block=r),
                                iters=2, warmup=1) for r in scan_bptt.FORWARD_ROWS}
        fwd_ms = fwd_ms_by[fwd_rows]
        logits, final, res = scan_bptt.bptt_forward(params, ncfg, tokens, state, proj)
        # B1's tile route is B2's forward tile step without the residuals:
        # on the same projection, the same bits
        b1_same_b2 = torch.equal(b1_logits, logits) and all(
            torch.equal(a, b) for a, b in zip(scan_bptt.flatten_state(b1_final), scan_bptt.flatten_state(final)))
        del b1_logits, b1_final
        dlogits = torch.randn_like(logits) * 1e-2
        dfinal = tree_map(torch.zeros_like, final)
        # the backward on the same projection: as the route runs it (its
        # tile, no dtokens), and at one row per block and with dtokens
        rows = scan_bptt.backward_tile(ncfg, IN, B, dev)
        variants = {f"rows {rows}, no dtokens (the route)": (rows, False), f"rows {rows}, dtokens": (rows, True),
                    "rows 1, no dtokens": (1, False), "rows 1, dtokens": (1, True)}
        rec_variants = {}
        for name, (r, need) in variants.items():
            rec_variants[name] = cuda_ms(lambda: scan_bptt.bptt_backward(
                params, ncfg, tokens, proj, res, dlogits, dfinal, need_dtokens=need, rows_per_block=r),
                iters=2, warmup=1)
        bwd_ms = rec_variants[list(variants)[0]]
        _, dst, ops = scan_bptt.bptt_backward(params, ncfg, tokens, proj, res, dlogits, dfinal, need_dtokens=False)
        _, dst2, ops2 = scan_bptt.bptt_backward(params, ncfg, tokens, proj, res, dlogits, dfinal, need_dtokens=False)
        KIN = IN + ncfg.read_head_size * ncfg.mem_dim + ncfg.controller_hidden_size
        # li's last columns are row padding the kernel never writes
        bwd_same = (all(torch.equal(a, b) for a, b in zip(scan_bptt.flatten_state(dst), scan_bptt.flatten_state(dst2)))
                    and torch.equal(ops[0][..., :KIN], ops2[0][..., :KIN])
                    and all(torch.equal(a, b) for a, b in zip(ops[1:], ops2[1:])))
        del dst2, ops2, res, proj
        li, dgates, ctrl, dctl = ops
        Hc = ncfg.controller_hidden_size
        products = [(li[0], dgates[0], KIN), (ctrl, dctl, Hc)]
        red_ms = cuda_ms(lambda: [scan_bptt.grad_reduce(a, g, k) for a, g, k in products], iters=5, warmup=1)
        red_plain_ms = cuda_ms(lambda: [scan_bptt.grad_reduce_reference(a, g, k) for a, g, k in products],
                               iters=5, warmup=1)
        red_lib_ms = cuda_ms(lambda: [torch.matmul(a[:, :k].T, g) for a, g, k in products], iters=5, warmup=1)
        red_abs = red_rel = 0.0
        red_same = True
        for a, g, k in products:
            ref = scan_bptt.grad_reduce_reference(a, g, k)
            got = scan_bptt.grad_reduce(a, g, k)
            e = max_abs(got, ref)
            red_abs, red_rel = max(red_abs, e), max(red_rel, e / float(ref.abs().max()))
            red_same = red_same and torch.equal(got, scan_bptt.grad_reduce(a, g, k))
        tiles = {f"{k + 1}x{g.shape[1]}": list(scan_bptt.gemm_tile(k + 1, g.shape[1])) for _, g, k in products}
        del ops, li, dgates, ctrl, dctl, products
    b1_bound = bound(*scan_cell_work(ncfg, B, T, IN))
    log("times", f"{smi}: B1 (the eval step's kernel) at B={B} T={T}: route {b1_route} {b1_ms:.3f} ms (the projection "
                 f"included), {other} route {b1_ms_by_route[other]:.3f} ms, bound {b1_bound[0]:.3f} ms by {b1_bound[1]}; "
                 f"logits vs the plain loop's max_abs {b1_err:.3e} (tol {F32_TOL:g}); logits and final state the same "
                 f"bits as B2's forward at {fwd_rows} rows per block on the same projection: {b1_same_b2}")
    if b1_err > F32_TOL or b1_route != "tile" or not b1_same_b2:
        raise AssertionError("B1 disagrees with the plain loop or with B2's forward at the training shape, or did not "
                             "take the tile route")
    work = scan_bptt_work(ncfg, B, T, IN)
    log("times", f"{smi}: B2 token projection at B={B} T={T} (once per train step, in the forward), CUDA events, "
                 f"two turns: kernel ({proj_tile[0]}x{proj_tile[1]} tile) {proj_ms:.3f} ms, plain "
                 f"{proj_plain_ms:.3f} ms, torch.addmm {proj_lib_ms:.3f} ms; kernel / torch.addmm = "
                 f"{proj_ms / proj_lib_ms:.3f}; max_abs vs plain {proj_err:.3e}, same bits on a rerun {proj_same}")
    log("times", f"{smi}: B2 forward at B={B} T={T} on the projection, by rows per block: "
                 + ", ".join(f"{r}: {v:.3f} ms" for r, v in fwd_ms_by.items())
                 + f" (the route: {fwd_rows}; before: {PREVIOUS_MS['forward']} ms, one row per block, the token rows "
                 f"read every step); vs its plain version ({fwd_ref_s:.1f} s) max_abs "
                 + ", ".join(f"{r}: {v:.3e}" for r, v in fwd_err.items())
                 + f" (tol {F32_TOL:g}: logits, final state, residuals); same bits on a rerun {fwd_same}; shared "
                 f"memory per block " + ", ".join(f"{r} rows {scan_bptt.smem_bytes(ncfg, IN, False, r)} B"
                                                   for r in scan_bptt.FORWARD_ROWS))
    log("times", f"{smi}: B2 backward at B={B} T={T} on the projection: "
                 + "; ".join(f"{k} {v:.3f} ms" for k, v in rec_variants.items())
                 + f" (before: {PREVIOUS_MS['backward']} ms: one row per block, no projection, dtokens); same bits "
                 f"on a rerun: {bwd_same}; its shared memory per block "
                 + ", ".join(f"{r} rows {scan_bptt.smem_bytes(ncfg, IN, True, r)} B" for r in scan_bptt.BACKWARD_ROWS))
    log("times", f"{smi}: B2 reduction (L+1={L + 1} calls, two kernels each; tiles {tiles}) {red_ms:.3f} ms "
                 f"(before: {PREVIOUS_MS['grad_reduce']} ms); torch.matmul on the same products {red_lib_ms:.3f} ms; "
                 f"plain {red_plain_ms:.3f} ms; plain train step: forward {plain_fwd:.1f} ms, backward {plain_bwd:.1f} ms; "
                 f"reduction vs plain max_abs {red_abs:.3e}, rel {red_rel:.3e} (tol 1e-4), same bits on a rerun: {red_same}")
    for name, (nb, no) in work.items():
        ms, by = bound(nb, no)
        log("times", f"B2 {name} bound {ms:.3f} ms by {by} ({nb / 1e9:.3f} GB, {no / 1e9:.3f} GFLOP)")
    if red_rel > 1e-4 or not red_same:
        raise AssertionError("the reduction kernel disagrees with its plain version or is not deterministic")
    if proj_err > F32_TOL or not proj_same or not bwd_same:
        raise AssertionError("the token projection disagrees with its plain version, or the projection or the "
                             "backward is not deterministic")
    if max(fwd_err.values()) > F32_TOL or not fwd_same:
        raise AssertionError("the forward disagrees with its plain version at the main path's shape, or is not "
                             "deterministic")
    check_budget("times")
    gw = max(err256["grad"], key=err256["grad"].get)
    return {
        "counts": counts, "step_ms": step, "eval_ms": eval_ms, "plain_step_ms": plain_step, "peak_gb": peak_gb,
        "forward": (fwd_ms, plain_fwd, None), "backward": (bwd_ms, plain_bwd, None),
        "token_projection": (proj_ms, proj_plain_ms, proj_lib_ms),
        "grad_reduce": (red_ms, red_plain_ms, red_lib_ms), "work": work, "grad_vs_f64": f64_err,
        "errors": {"forward": (max(fwd_err.values()), None), "backward": (err256["grad_abs"], err256["grad"][gw]),
                   "token_projection": (proj_err, None), "grad_reduce": (red_abs, red_rel)},
        "forward_rows": fwd_rows, "forward_ms_by_rows": fwd_ms_by, "logits_vs_plain": fwd_err256,
        "projection_tile": proj_tile,
        "backward_rows": rows, "recurrence_variants": rec_variants, "reduce_tiles": tiles,
        "b1": {"launches": counts["ntm_scan_fused"], "B": B, "T": T, "ms": b1_ms, "bound_ms": b1_bound[0],
               "bound_by": b1_bound[1], "max_abs_err": b1_err, "route": b1_route, "ms_by_route": b1_ms_by_route,
               "same_bits_as_b2_forward": b1_same_b2},
        "eval_routes": eval_routes,
        "inputs": (params, ncfg, tokens),
    }


def initial_state_referee(params, ncfg, tokens, state, dlogits, dfinal, grad_names, b2, b4, rows: int = 4) -> dict:
    """Which of B2 and B4 carries their gap on the initial-state
    gradients: both kernels' gradients (b2, b4, in grad_names order, on the
    same params, tokens, state and cotangents) and the plain loop's in
    float32 against the plain loop in float64, on the `rows` batch rows
    where the kernels differ most on c0. A row's initial-state gradient
    depends on that row alone, so the plain loops run those rows only.
    Returns, per initial-state tensor, max |x - float64| / max |float64|
    over those rows for each of B2, B4 and the plain float32 loop, and the
    rows."""
    from ntm_tracker_tpu_torch.ops.kernels import scan_bptt
    from ntm_tracker_tpu_torch.ops.kernels.scan_cell import ntm_scan_fused_reference
    from ntm_tracker_tpu_torch.train.optim import tree_map

    L = ncfg.controller_num_layers
    names = ["M0", "w0", "read0", *[f"c0[{l}]" for l in range(L)], *[f"h0[{l}]" for l in range(L)]]
    at = [grad_names.index(n) for n in names]
    c0 = grad_names.index("c0[0]")
    gap = (b4[c0].double() - b2[c0].double()).abs().reshape(b4[c0].shape[0], -1).amax(1)
    pick = torch.topk(gap, rows).indices.sort().values
    t0 = time.perf_counter()

    def plain(dtype):
        with torch.enable_grad():
            p = tree_map(lambda t: t.detach().to(dtype), params)
            leaves = [t[pick].detach().to(dtype).requires_grad_() for t in scan_bptt.flatten_state(state)]
            st = {"M": leaves[0], "w": leaves[1], "read": leaves[2],
                  "controller_state": list(zip(leaves[3:3 + L], leaves[3 + L:3 + 2 * L]))}
            logits, final = ntm_scan_fused_reference(p, ncfg, tokens[pick].to(dtype), st)
            loss = (logits * dlogits[pick].to(dtype)).sum() + sum(
                (a * b[pick].to(dtype)).sum() for a, b in zip(scan_bptt.flatten_state(final),
                                                              scan_bptt.flatten_state(dfinal)))
            return torch.autograd.grad(loss, leaves)

    g64, g32 = plain(torch.float64), plain(torch.float32)
    out = {}
    for name, i, g, h in zip(names, at, g64, g32):
        scale = max(float(g.abs().max()), 1e-30)
        out[name] = {"b2": max_abs(b2[i][pick], g) / scale, "b4": max_abs(b4[i][pick], g) / scale,
                     "plain_f32": max_abs(h, g) / scale}
    log("packed", f"initial-state gradients at B={tokens.shape[0]} T={tokens.shape[1]} on rows {pick.tolist()} (the "
                  f"{rows} where B4 and B2 differ most on c0; {time.perf_counter() - t0:.1f}s) against the plain loop in "
                  f"float64, max rel B2 / B4 / the plain loop in float32: "
                  + ", ".join(f"{k} {v['b2']:.2e} / {v['b4']:.2e} / {v['plain_f32']:.2e}" for k, v in out.items()))
    return {"rows": pick.tolist(), "max_rel": out}


def packed_tiles(ncfg, IN: int, backward: bool) -> list:
    """The tiles (rows per block) B4's forward or backward is instantiated
    at that fit this config's shared memory."""
    from ntm_tracker_tpu_torch.ops.kernels import scan_packed
    from ntm_tracker_tpu_torch.ops.kernels.scan_cell import MAX_SMEM_BYTES

    sizes = scan_packed.BACKWARD_ROWS if backward else scan_packed.FORWARD_ROWS
    return [r for r in sizes if scan_packed.packed_smem_bytes(ncfg, IN, backward, r) <= MAX_SMEM_BYTES]


def packed_smem_check(IN: int) -> dict:
    """B4's shared memory: scan_packed.packed_smem_bytes (the Python mirror
    the tile rule reads) against the kernel's own ntm_packed_smem_bytes at
    every instantiated tile, on the flagship and the check cases' configs;
    raises where they differ. Returns the flagship's bytes by tile."""
    from ntm_tracker_tpu_torch.config import NTMConfig
    from ntm_tracker_tpu_torch.ops.kernels import scan_packed

    cfgs = {"flagship": NTMConfig(), **{name: c for name, (c, _, _) in bptt_cases().items()},
            **{name: c for name, (c, _, _) in packed_wide_cases().items()},
            "n33_s5": NTMConfig(mem_size=33, mem_dim=8, shift_range=2, write_first=True),
            "n196_slotwise": NTMConfig(mem_size=196, mem_dim=12, slotwise_cosine=True)}
    flagship, checked = {}, 0
    for name, c in cfgs.items():
        for bwd, sizes in ((False, scan_packed.FORWARD_ROWS), (True, scan_packed.BACKWARD_ROWS)):
            for rows in sizes:
                mirror, kernel = scan_packed.packed_smem_bytes(c, IN, bwd, rows), scan_packed.smem_bytes(c, IN, bwd, rows)
                if mirror != kernel:
                    raise AssertionError(f"packed shared memory {name} backward={bwd} rows {rows}: the mirror says "
                                         f"{mirror} B, the kernel {kernel} B")
                checked += 1
                if name == "flagship":
                    flagship[f"{'backward' if bwd else 'forward'}_rows_{rows}"] = kernel
    log("packed", f"shared memory per block, the mirror equal to the kernel's at {checked} (config, kernel, tile) "
                  f"points; flagship (bytes): {flagship}")
    return flagship


def packed_tile_sweep(dev: torch.device, smi: str, IN: int = 514, batches=(64, 132, 256, 512), T: int = 1300) -> dict:
    """B4's forward (on the projection, without residuals), forward with
    residuals and backward (without dtokens) at every instantiated tile and
    each batch, T=1300, flagship config, CUDA events; and the tile each
    batch gets from scan_packed.tile_rows on this card. The sweep that
    fixes the rule (PERF.md); chip_smoke's main run times B=256 alone.
    Alone: python3 -c "import chip_smoke as c, torch;
    c.packed_tile_sweep(torch.device('cuda'), 'card')" """
    from ntm_tracker_tpu_torch.config import NTMConfig
    from ntm_tracker_tpu_torch.models.ntm_cell import init_ntm_state
    from ntm_tracker_tpu_torch.ops.kernels import scan_bptt, scan_packed
    from ntm_tracker_tpu_torch.train.optim import tree_map

    ncfg = NTMConfig()
    out = {}
    for B in batches:
        params, tokens, _ = scan_case(ncfg, B, T, 350 + B, dev, IN)
        gen = torch.Generator(device=dev).manual_seed(B)
        with torch.no_grad():
            state = init_ntm_state(params, ncfg, B)
            layer0 = params["controller"][0]
            proj = scan_bptt.token_projection(tokens, layer0["kernel"], layer0["bias"])
            ms = {"forward": {}, "forward_residuals": {}, "backward": {}}
            for rows in packed_tiles(ncfg, IN, False):
                ms["forward"][rows] = cuda_ms(lambda: scan_packed.packed_forward(params, ncfg, tokens, state, proj, rows),
                                              iters=2, warmup=1)
                ms["forward_residuals"][rows] = cuda_ms(lambda: scan_packed.packed_forward_residuals(
                    params, ncfg, tokens, state, proj, rows), iters=2, warmup=1)
            logits, final, res = scan_packed.packed_forward_residuals(params, ncfg, tokens, state, proj)
            dlogits = torch.randn(logits.shape, generator=gen, device=dev) * 1e-2
            dfinal = tree_map(lambda t: torch.randn(t.shape, generator=gen, device=dev) * 1e-2, final)
            for rows in packed_tiles(ncfg, IN, True):
                ms["backward"][rows] = cuda_ms(lambda: scan_packed.packed_backward(
                    params, ncfg, tokens, proj, res, dlogits, dfinal, False, rows), iters=2, warmup=1)
            del res, proj, logits, final
        rule = {"forward": scan_packed.tile_for(ncfg, IN, B, dev, None, False),
                "backward": scan_packed.tile_for(ncfg, IN, B, dev, None, True)}
        out[B] = {"ms": ms, "rule": rule}
        log("sweep", f"{smi}: B4 at B={B} T={T} by rows per block (CUDA events, 2 launches): "
                     + "; ".join(f"{k} " + ", ".join(f"{r}: {v:.3f} ms" for r, v in ms[k].items()) for k in ms)
                     + f"; the rule's tiles {rule}")
    return out


def packed_probe_split(dev, smi, params, ncfg, tokens, state, proj, res, dlogits, dfinal, ms) -> dict:
    """Where B4's step goes: the probe variants (scan_packed.packed_probe,
    block 0's clock64() between barriers) of the forward and the backward
    at PROBE_ROWS rows per block, as us per step at the SM's rated clock and
    as shares of the phase's cycles, beside the kernels' own times per
    step (ms, CUDA events at the same tile)."""
    from ntm_tracker_tpu_torch.ops.kernels import scan_packed
    from ntm_tracker_tpu_torch.ops.kernels.addressing import sm_clock_khz

    T = tokens.shape[1]
    khz = sm_clock_khz(dev)
    fwd, bwd = scan_packed.packed_probe(params, ncfg, tokens, state, proj, res, dlogits, dfinal)
    out = {}
    for name, cyc, kernel_ms in (("forward", fwd, ms["forward"][scan_packed.PROBE_ROWS]),
                                 ("backward", bwd, ms["backward"][scan_packed.PROBE_ROWS])):
        total = sum(cyc.values())
        us = {k: v / T / khz * 1e3 for k, v in cyc.items()}
        out[name] = {"us_per_step": us, "share": {k: v / total for k, v in cyc.items()},
                     "kernel_us_per_step": kernel_ms / T * 1e3, "sm_clock_khz": khz}
        log("probe", f"{smi}: B4 {name} at {scan_packed.PROBE_ROWS} rows, B={tokens.shape[0]} T={T}: us per step at "
                     f"{khz / 1e3:.0f} MHz " + ", ".join(f"{k} {v:.2f}" for k, v in us.items())
                     + f"; sum {sum(us.values()):.2f} against the kernel's {kernel_ms / T * 1e3:.2f} (CUDA events)")
    return out


def phase_packed(dev: torch.device, smi: str, IN: int, train: dict) -> dict:
    """The lane-packed kernels (B4) against their plain version and against
    the row kernels, the counterpart of tests/hw_check_pallas.py's
    check_packed: (a) phase_bptt's five cases and packed_wide_cases' three,
    forward and every gradient, at one row per block, the rule's tiles and
    the largest tiles that fit, the flagship cases also without token
    gradients; (b) the frame path's
    shape B=1, T=65 against B1; (c) the train path's shape B=256, T=1300 on
    phase_train's params and tokens against B2's kernels, the same bits on
    a rerun, the backward without dtokens the same bits as with them but
    for dtokens, both kernels' initial-state gradients against float64,
    and the times at every tile beside B2's, the plain version's and the
    bounds; (d) the shared-memory mirror against the kernel; the token
    projection's launches on B4's path. No main path launches B4 (checked:
    its counts are 0 on entry); the launches are this phase's own."""
    from ntm_tracker_tpu_torch.config import NTMConfig
    from ntm_tracker_tpu_torch.models.ntm_cell import init_ntm_state
    from ntm_tracker_tpu_torch.ops.kernels import scan_bptt, scan_packed
    from ntm_tracker_tpu_torch.ops.kernels.scan_cell import ntm_scan_fused
    from ntm_tracker_tpu_torch.train.optim import tree_map

    kernels = (scan_packed.packed_forward, scan_packed.packed_forward_residuals, scan_packed.packed_backward)
    entry = {k.__name__: k.launches for k in kernels}
    if any(entry.values()):
        raise AssertionError(f"a main path launched B4: {entry}")
    smem = packed_smem_check(IN)
    worst = {"fwd_abs": 0.0, "grad_rel": 0.0}

    # ---- (a) the kernels against the plain version ---------------------------------
    def compare(name, ncfg, B, T, params, tokens, cot, state_fn, tiles):
        pl, pf, pg = grads_of(scan_packed.ntm_scan_packed_reference, params, ncfg, tokens, cot, state_fn)
        out = []
        for rows, brows, token_grads in tiles:
            scan = functools.partial(scan_packed.ntm_scan_packed_bptt, rows_per_block=rows,
                                     backward_rows_per_block=brows)
            kl, kf, kg = grads_of(scan, params, ncfg, tokens, cot, state_fn, token_grads)
            with torch.no_grad():
                nl, nf = scan_packed.ntm_scan_packed(params, ncfg, tokens, state_fn(params), rows_per_block=rows)
            fwd = max(max(state_diffs(kl, kf, pl, pf).values()), max(state_diffs(nl, nf, pl, pf).values()))
            gerr = grad_errors(kg, pg)
            finite = all(bool(torch.isfinite(g).all()) for g in [kl, nl, *kg.values()])
            gw = max(gerr, key=gerr.get)
            tile = (f"{scan_packed.tile_for(ncfg, IN, B, dev, rows, False)}/"
                    f"{scan_packed.tile_for(ncfg, IN, B, dev, brows, True)}")
            log("packed", f"{name} B={B} T={T} rows {tile} ({'the rule' if rows is None else 'forced'}), token grads "
                          f"{token_grads}: forward max_abs {fwd:.3e} (tol {F32_TOL:g}); grads max rel {gerr[gw]:.3e} at "
                          f"{gw} (tol {GRAD_TOL:g}, {len(gerr)} gradients); finite {finite}")
            if not finite or fwd > F32_TOL or gerr[gw] > GRAD_TOL:
                raise AssertionError(f"{name}: the packed kernels disagree with their plain version")
            worst["fwd_abs"] = max(worst["fwd_abs"], fwd)
            worst["grad_rel"] = max(worst["grad_rel"], gerr[gw])
            out.append(kg)
        return out

    def case_tiles(ncfg, flagship):
        # one row per block (the control), the rule's tiles, the largest that fit
        big = (max(packed_tiles(ncfg, IN, False)), max(packed_tiles(ncfg, IN, True)))
        tiles = [(1, 1, True), (None, None, True), (*big, True)]
        return tiles + ([(*big, False)] if flagship else [])

    for i, (name, (ncfg, B, T)) in enumerate(bptt_cases().items()):
        params, tokens, cot = scan_case(ncfg, B, T, 300 + i, dev, IN)
        compare(name, ncfg, B, T, params, tokens, cot, lambda p, ncfg=ncfg, B=B: init_ntm_state(p, ncfg, B),
                case_tiles(ncfg, "flagship" in name))
    ncfg, B, params, tokens, cot, zero_state, cols, _ = wconv_zero_case(dev, IN)
    for kg in compare("e_wconv_zero", ncfg, B, 1, params, tokens, cot, zero_state, case_tiles(ncfg, False)):
        if (kg["heads_b"][cols["gamma"]] != 0).any() or (kg["heads_w"][:, cols["gamma"]] != 0).any():
            raise AssertionError("packed: d/dgamma must be exactly 0 where w_conv is 0 or 1")
    log("packed", "e_wconv_zero: packed dgamma exactly 0 at every tile")
    for i, (name, (ncfg, B, T)) in enumerate(packed_wide_cases().items()):
        params, tokens, cot = scan_case(ncfg, B, T, 320 + i, dev, IN)
        compare(name, ncfg, B, T, params, tokens, cot, lambda p, ncfg=ncfg, B=B: init_ntm_state(p, ncfg, B),
                case_tiles(ncfg, False))
    check_budget("packed")

    # ---- (b) the frame path's shape: B=1, T=65, against B1 -------------------------
    ncfg = NTMConfig()
    params, tokens, _ = scan_case(ncfg, 1, 65, 340, dev, IN)
    state = init_ntm_state(params, ncfg, 1)
    frame, fwd_tiles = {}, packed_tiles(ncfg, IN, False)
    with torch.no_grad():
        b1_logits, b1_final = ntm_scan_fused(params, ncfg, tokens, state)
        for rows in fwd_tiles:
            lo, fi = scan_packed.ntm_scan_packed(params, ncfg, tokens, state, rows_per_block=rows)
            err = max(state_diffs(lo, fi, b1_logits, b1_final).values())
            worst["fwd_abs"] = max(worst["fwd_abs"], err)
            if err > F32_TOL:
                raise AssertionError(f"packed forward at rows {rows} disagrees with B1 at B=1, T=65: {err:.3e}")
            frame[rows] = {"max_abs_err_vs_b1": err}
        # in turns: B1, packed at each tile, and back (each with its projection)
        order = ["b1", *fwd_tiles]
        ms = {k: [] for k in order}
        for rep in range(2):
            for key in (order if rep == 0 else order[::-1]):
                fn = (lambda: ntm_scan_fused(params, ncfg, tokens, state)) if key == "b1" else (
                    lambda r=key: scan_packed.ntm_scan_packed(params, ncfg, tokens, state, rows_per_block=r))
                ms[key].append(cuda_ms(fn, iters=50, warmup=3))
        plain = cuda_ms(lambda: scan_packed.ntm_scan_packed_reference(params, ncfg, tokens, state), iters=3, warmup=1)
    b_ms, b_by = bound(*scan_cell_work(ncfg, 1, 65, IN))
    rule1 = scan_packed.tile_for(ncfg, IN, 1, dev, None, False)
    for rows in fwd_tiles:
        frame[rows]["ms"] = float(np.mean(ms[rows]))
    frame_out = {"B": 1, "T": 65, "ms": frame[rule1]["ms"], "rows_per_block": rule1,
                 "ms_by_rows_per_block": {str(r): f["ms"] for r, f in frame.items()},
                 "row_kernel_ms": float(np.mean(ms["b1"])), "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                 "max_abs_err_vs_b1": max(f["max_abs_err_vs_b1"] for f in frame.values())}
    log("times", f"{smi}: B=1 T=65: packed forward with its projection "
                 + ", ".join(f"rows {r} {f['ms']:.4f} ms" for r, f in frame.items())
                 + f", B1 {frame_out['row_kernel_ms']:.4f} ms (CUDA events, 50 launches, two turns); plain {plain:.3f} "
                 f"ms; bound {b_ms:.6f} ms by {b_by}; vs B1 max_abs {frame_out['max_abs_err_vs_b1']:.3e} "
                 f"(tol {F32_TOL:g})")
    check_budget("packed")

    # ---- (c) the train path's shape: B=256, T=1300, against B2 ---------------------
    params, ncfg, tokens = train["inputs"]
    B, T, _ = tokens.shape
    gen = torch.Generator(device=dev).manual_seed(7)
    rule = (scan_packed.tile_for(ncfg, IN, B, dev, None, False), scan_packed.tile_for(ncfg, IN, B, dev, None, True))
    tiles = ((1, 1), rule)
    with torch.no_grad():
        state = init_ntm_state(params, ncfg, B)
        # B2 as the train route runs it: one projection, the forward and
        # the backward on it (here with dtokens, to hold B4's against them)
        layer0 = params["controller"][0]
        proj = scan_bptt.token_projection(tokens, layer0["kernel"], layer0["bias"])
        logits, final, res = scan_bptt.bptt_forward(params, ncfg, tokens, state, proj)
        dlogits = torch.randn(logits.shape, generator=gen, device=dev) * 1e-2
        dfinal = tree_map(lambda t: torch.randn(t.shape, generator=gen, device=dev) * 1e-2, final)
        dtok, dst, ops = scan_bptt.bptt_backward(params, ncfg, tokens, proj, res, dlogits, dfinal)
        del res
        ref = [dtok, *scan_bptt.flatten_state(dst), *scan_bptt.weight_grads(ncfg, IN, ops)]
        del ops
        L = ncfg.controller_num_layers
        grad_names = ["tokens", "M0", "w0", "read0", *[f"c0[{l}]" for l in range(L)], *[f"h0[{l}]" for l in range(L)],
                      *[f"controller[{l}].kernel" for l in range(L)], *[f"controller[{l}].bias" for l in range(L)],
                      "heads_w", "heads_b", "out_w", "out_b"]

        def packed_run(rows, brows, need_dtokens=True):
            lo, fi, res = scan_packed.packed_forward_residuals(params, ncfg, tokens, state, proj, rows)
            dt, ds, ops = scan_packed.packed_backward(params, ncfg, tokens, proj, res, dlogits, dfinal, need_dtokens,
                                                      brows)
            del res
            return lo, fi, [dt, *scan_bptt.flatten_state(ds), *scan_bptt.weight_grads(ncfg, IN, ops)]

        train_out = {}
        for rows, brows in tiles:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            lo, fi, got = packed_run(rows, brows)
            peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
            fwd = max(state_diffs(lo, fi, logits, final).values())
            rel = {name: max_abs(g, r) / max(float(r.abs().max()), 1e-30) for name, g, r in zip(grad_names, got, ref)}
            gw = max(rel, key=rel.get)
            gerr = rel[gw]
            gabs = max(max_abs(g, r) for g, r in zip(got, ref))
            again = packed_run(rows, brows)
            same = (torch.equal(lo, again[0]) and all(torch.equal(a, b) for a, b in zip(got, again[2]))
                    and all(torch.equal(a, b) for a, b in zip(scan_bptt.flatten_state(fi),
                                                              scan_bptt.flatten_state(again[1]))))
            # without dtokens: every other output the same bits
            bare = packed_run(rows, brows, need_dtokens=False)
            same_bare = bare[2][0] is None and all(torch.equal(a, b) for a, b in zip(got[1:], bare[2][1:]))
            del again, bare
            finite = bool(torch.isfinite(lo).all()) and all(bool(torch.isfinite(g).all()) for g in got)
            log("packed", f"B={B} T={T} rows {rows}/{brows} vs B2's kernels: forward max_abs {fwd:.3e} (tol {F32_TOL:g}); "
                          f"gradients (tokens, initial state, weights) max rel {gerr:.3e} at {gw} (tol {GRAD_TOL:g}); "
                          f"same bits on a rerun {same}; without dtokens the rest the same bits {same_bare}; finite "
                          f"{finite}; peak {peak_gb:.2f} GB above the inputs (forward with residuals + backward + "
                          f"reduction)")
            if fwd > F32_TOL or gerr > GRAD_TOL or not same or not same_bare or not finite:
                raise AssertionError(f"packed kernels at rows {rows}/{brows} disagree with B2 at B={B}, T={T}")
            worst["fwd_abs"] = max(worst["fwd_abs"], fwd)
            worst["grad_rel"] = max(worst["grad_rel"], gerr)
            worst["grad_abs_train"] = max(worst.get("grad_abs_train", 0.0), gabs)
            train_out[(rows, brows)] = {"peak_gb": peak_gb, "fwd_abs": fwd, "grad_rel": gerr}
            if (rows, brows) == rule:
                referee = initial_state_referee(params, ncfg, tokens, state, dlogits, dfinal, grad_names, ref, got)
            del got, lo, fi
            check_budget("packed")
        # every instantiated tile, each kernel's launches back to back
        ms = {"forward": {}, "forward_residuals": {}, "backward": {}}
        for rows in packed_tiles(ncfg, IN, False):
            ms["forward"][rows] = cuda_ms(lambda: scan_packed.packed_forward(params, ncfg, tokens, state, proj, rows),
                                          iters=2, warmup=1)
            ms["forward_residuals"][rows] = cuda_ms(lambda: scan_packed.packed_forward_residuals(
                params, ncfg, tokens, state, proj, rows), iters=2, warmup=0)
        _, _, res = scan_packed.packed_forward_residuals(params, ncfg, tokens, state, proj, rule[0])
        for brows in packed_tiles(ncfg, IN, True):
            ms["backward"][brows] = cuda_ms(lambda: scan_packed.packed_backward(
                params, ncfg, tokens, proj, res, dlogits, dfinal, False, brows), iters=2, warmup=1)
        ms["backward_dtokens"] = cuda_ms(lambda: scan_packed.packed_backward(
            params, ncfg, tokens, proj, res, dlogits, dfinal, True, rule[1]), iters=2, warmup=0)
        probe = packed_probe_split(dev, smi, params, ncfg, tokens, state, proj, res, dlogits, dfinal, ms)
        _, _, ops = scan_packed.packed_backward(params, ncfg, tokens, proj, res, dlogits, dfinal, False, rule[1])
        del res
        # the reduction on B4's operands, timed two ways: as phase_train
        # times B2's (the two grad_reduce calls of the flagship's one layer,
        # 5 launches after 1 warm-up), which `reduction` compares with B2's
        # in this run; and through weight_grads, 2 launches without a
        # warm-up, as the packed phase timed it before li's rows were
        # padded (`reduction_weight_grads`, to compare with such runs)
        li, dgates, ctrl, dctl = ops
        kin = IN + ncfg.read_head_size * ncfg.mem_dim + ncfg.controller_hidden_size
        products = [(li[0], dgates[0], kin), (ctrl, dctl, ncfg.controller_hidden_size)]
        ms["reduction_weight_grads"] = cuda_ms(lambda: scan_bptt.weight_grads(ncfg, IN, ops), iters=2, warmup=0)
        ms["reduction"] = cuda_ms(lambda: [scan_bptt.grad_reduce(a, g, k) for a, g, k in products], iters=5, warmup=1)
        del ops, li, dgates, ctrl, dctl, products, proj
        log("times", f"{smi}: B={B} T={T} packed kernels by rows per block (CUDA events; the forwards on the "
                     f"projection, the backward without dtokens): "
                     + "; ".join(f"{k} " + ", ".join(f"{r}: {v:.3f} ms" for r, v in ms[k].items())
                                 for k in ("forward", "forward_residuals", "backward"))
                     + f"; backward with dtokens at {rule[1]} rows {ms['backward_dtokens']:.3f} ms; reduction "
                     f"{ms['reduction']:.3f} ms as B2's is timed (B2's {train['grad_reduce'][0]:.3f}), through "
                     f"weight_grads {ms['reduction_weight_grads']:.3f} ms (2 launches, no warm-up); the rule's tiles "
                     f"{rule[0]}/"
                     f"{rule[1]}; the projection {train['token_projection'][0]:.3f} ms (phase train)")
        del ref, dtok, dst, logits, final

    # the plain version at the same shape: forward without gradients, and
    # forward and backward of its autograd
    with torch.no_grad():
        plain_fwd = cuda_ms(lambda: scan_packed.ntm_scan_packed_reference(params, ncfg, tokens, state), iters=1, warmup=0)
    live = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda.reset_peak_memory_stats()
    lo, fi = scan_packed.ntm_scan_packed_reference(live, ncfg, tokens, init_ntm_state(live, ncfg, B))
    loss = (lo * dlogits).sum() + sum((a * b).sum() for a, b in zip(scan_bptt.flatten_state(fi),
                                                                    scan_bptt.flatten_state(dfinal)))
    ev[1].record()
    torch.autograd.grad(loss, [live["heads_w"], live["controller"][0]["kernel"]])
    ev[2].record()
    torch.cuda.synchronize()
    plain_res_fwd, plain_bwd = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    plain_peak = torch.cuda.max_memory_allocated() / 1e9
    del lo, fi, loss, live
    # B4's kernels read the projection (no token rows of W0); the backward
    # as timed writes no dtokens
    work = scan_bptt_work(ncfg, B, T, IN)
    bounds = {"forward": bound(*scan_bptt_work(ncfg, B, T, IN, residuals=False)["forward"]),
              "forward_residuals": bound(*work["forward"]), "backward": bound(*work["backward"]),
              "reduction": bound(*work["grad_reduce"])}
    log("times", f"{smi}: B={B} T={T} plain packed version: forward {plain_fwd:.1f} ms (no gradients); recording "
                 f"gradients forward {plain_res_fwd:.1f} ms, backward {plain_bwd:.1f} ms (CUDA events, peak "
                 f"{plain_peak:.1f} GB); bounds "
                 + ", ".join(f"{k} {v[0]:.3f} ms by {v[1]}" for k, v in bounds.items())
                 + f"; B2: projection {train['token_projection'][0]:.3f} ms, forward {train['forward'][0]:.3f} ms, "
                 f"backward {train['backward'][0]:.3f} ms, reduction {train['grad_reduce'][0]:.3f} ms; B1 "
                 f"{train['b1']['ms']:.3f} ms (phase train)")

    # ---- (d) B4's path: the projection launched once per call -------------------------
    phase_counts = {k.__name__: k.launches for k in kernels}
    ncfg = NTMConfig()
    params, tokens, cot = scan_case(ncfg, 2, 65, 360, dev, IN)
    for k in kernels:
        k.launches = 0
    proj0 = scan_bptt.token_projection.launches
    with torch.no_grad():
        scan_packed.ntm_scan_packed(params, ncfg, tokens, init_ntm_state(params, ncfg, 2))
    grads_of(scan_packed.ntm_scan_packed_bptt, params, ncfg, tokens, cot, lambda p: init_ntm_state(p, ncfg, 2), False)
    path = {"token_projection": scan_bptt.token_projection.launches - proj0,
            **{k.__name__: k.launches for k in kernels}}
    expected = {"token_projection": 2, "packed_forward": 1, "packed_forward_residuals": 1, "packed_backward": 1}
    log("packed", f"B4's path, one forward and one train step (fwd + bwd, tokens without gradients): launches {path} "
                  f"(expected {expected}); launches in this phase before it {phase_counts}")
    if path != expected or min(phase_counts.values()) == 0:
        raise AssertionError("B4's path did not launch one projection per call, or a packed kernel was not launched")
    check_budget("packed")
    rule_by_batch = {str(b): {"forward": scan_packed.tile_for(NTMConfig(), IN, b, dev, None, False),
                              "backward": scan_packed.tile_for(NTMConfig(), IN, b, dev, None, True)}
                     for b in (1, 64, 132, 133, 256, 264, 265, 512)}
    return {"counts": path, "phase_counts": phase_counts, "probe": probe, "frame": frame_out, "train": train_out,
            "ms": ms, "rule": rule, "rule_by_batch": rule_by_batch, "worst": worst,
            "plain": {"forward": plain_fwd, "forward_residuals": plain_res_fwd, "backward": plain_bwd},
            "bounds": bounds, "smem": smem, "B": B, "T": T, "initial_state_referee": referee}



def loss_fell(losses: list, window: int) -> tuple:
    """(mean of the first `window` losses, mean of the last `window`)."""
    return float(np.mean(losses[:window])), float(np.mean(losses[-window:]))


def kernel_counts() -> dict:
    """The launch counts of B1 (and by route) and of B2's four wrappers."""
    from ntm_tracker_tpu_torch.ops.kernels import scan_bptt
    from ntm_tracker_tpu_torch.ops.kernels.scan_cell import ntm_scan_fused

    out = {"ntm_scan_fused": ntm_scan_fused.launches, "ntm_scan_fused_by_route": dict(ntm_scan_fused.launches_by_route)}
    for name in ("bptt_forward", "token_projection", "bptt_backward", "grad_reduce"):
        out[name] = getattr(scan_bptt, name).launches
    return out


def reset_all_counts() -> None:
    from ntm_tracker_tpu_torch.ops.kernels import scan_bptt

    reset_counts()
    for name in ("bptt_forward", "token_projection", "bptt_backward", "grad_reduce"):
        getattr(scan_bptt, name).launches = 0


def phase_accuracy(dev: torch.device, smi: str) -> dict:
    """The accuracy path on the card: (a) the demo config's NTM trains
    ACC_STEPS steps through B2 on synthetic clips, its loss must fall, then
    tracks a held-out clip through the streaming tracker (B1's cluster
    route) and the device loop, held to the artifact's tripwires; (b) the
    DNC's train step on the card against the same step on the CPU, then a
    DNC StreamingTracker; (c) the flagship width: build_dataset, then
    ACC_FLAG_STEPS full-batch steps whose loss must fall."""
    from ntm_tracker_tpu_torch.data.synthetic import make_video
    from ntm_tracker_tpu_torch.models.core import make_core
    from ntm_tracker_tpu_torch.models.vgg import init_vgg_params
    from ntm_tracker_tpu_torch.tools.track_artifact import DEVICE_IOU_GAP_MAX, STEP1_FRAC_MAX, serve_precision_drift
    from ntm_tracker_tpu_torch.tools.track_flagship import build_dataset, flagship_config
    from ntm_tracker_tpu_torch.tracking.demo import (
        demo_config, eval_device_iou, eval_streaming_iou, mean_clamped_iou, training_batch,
    )
    from ntm_tracker_tpu_torch.tracking.tracker import StreamingTracker
    from ntm_tracker_tpu_torch.train.experiments import OffsetExperiment
    from ntm_tracker_tpu_torch.train.optim import tree_leaves, tree_map
    from ntm_tracker_tpu_torch.train.serialize import offsets_loss, serialize_tokens

    out = {}
    # ---- (a) the demo config's NTM ------------------------------------------
    cfg = demo_config()
    vgg = init_vgg_params(torch.Generator().manual_seed(0), dev)
    exp = OffsetExperiment(cfg, vgg, image_mode="cropped", device=dev)
    params, opt_state = exp.init(torch.Generator().manual_seed(1))
    step = exp.make_train_step()
    rng = np.random.RandomState(0)
    reset_all_counts()
    losses = []
    t0 = time.perf_counter()
    for i in range(ACC_STEPS):
        params, opt_state, m = step(params, opt_state, training_batch(cfg, rng, dev))
        losses.append(m["loss"])  # read at the end: the next batch is made while the card steps
        if i % 10 == 0 or i == ACC_STEPS - 1:
            log("accuracy", f"demo NTM step {i}: loss {float(losses[-1]):.4f}")
    losses = [float(v) for v in losses]
    train_s = time.perf_counter() - t0
    train_counts = kernel_counts()
    first, last = loss_fell(losses, ACC_WINDOW)
    log("accuracy", f"{smi}: demo NTM (B={cfg.train.batch_size}, T={cfg.total_steps}, memory "
                    f"{cfg.ntm.mem_size}x{cfg.ntm.mem_dim}, hidden {cfg.ntm.controller_hidden_size}): {ACC_STEPS} steps "
                    f"in {train_s:.2f}s ({train_s / ACC_STEPS * 1e3:.1f} ms a step, batch made on the host and cropped "
                    f"on the card); loss mean of the first {ACC_WINDOW} {first:.4f}, of the last {last:.4f}; "
                    f"launches {train_counts}")
    if not last < first or not np.isfinite(losses).all():
        raise AssertionError(f"the demo NTM's loss did not fall: {first:.4f} -> {last:.4f}")
    if not (train_counts["bptt_forward"] == train_counts["bptt_backward"] == train_counts["token_projection"]
            == ACC_STEPS and train_counts["grad_reduce"] > 0 and train_counts["ntm_scan_fused"] == 0):
        raise AssertionError(f"the demo train steps did not each run B2 once: {train_counts}")

    reset_all_counts()
    t0 = time.perf_counter()
    host = eval_streaming_iou(cfg, vgg, params, 0, ACC_CLIP_FRAMES, device=dev)
    host_s = time.perf_counter() - t0
    host_counts = kernel_counts()
    reset_all_counts()
    device = eval_device_iou(cfg, vgg, params, 0, ACC_CLIP_FRAMES, device=dev)
    loop_counts = kernel_counts()
    core = make_core(cfg)
    drift_px, drift_frac, step1_px, step1_frac = serve_precision_drift(cfg, core, vgg, params, 0, ACC_CLIP_FRAMES,
                                                                       device=dev)
    gap = abs(mean_clamped_iou(host) - mean_clamped_iou(device))
    log("accuracy", f"{smi}: demo NTM after {ACC_STEPS} steps, a {ACC_CLIP_FRAMES}-frame clip: host mean IoU "
                    f"{mean_clamped_iou(host):.4f} ({host_s / ACC_CLIP_FRAMES * 1e3:.2f} ms a frame), device loop "
                    f"{mean_clamped_iou(device):.4f}, gap {gap:.4f} (tripwire {DEVICE_IOU_GAP_MAX}); drift step 1 "
                    f"{step1_px:.4f} px = {step1_frac:.5f} of the diagonal (tripwire {STEP1_FRAC_MAX}), trajectory "
                    f"{drift_px:.4f} px; B1 launches host {host_counts['ntm_scan_fused_by_route']}, device loop "
                    f"{loop_counts['ntm_scan_fused_by_route']}")
    if step1_frac > STEP1_FRAC_MAX or gap > DEVICE_IOU_GAP_MAX or not np.isfinite(host + device).all():
        raise AssertionError(f"an accuracy tripwire fired: step-1 drift {step1_frac}, IoU gap {gap}")
    for counts in (host_counts, loop_counts):
        if counts["ntm_scan_fused_by_route"] != {"cluster": ACC_CLIP_FRAMES, "tile": 0}:
            raise AssertionError(f"the clip did not run B1's cluster route once a frame: {counts}")
    out["ntm"] = {"losses": losses, "train_s": train_s, "host_iou": mean_clamped_iou(host),
                  "device_iou": mean_clamped_iou(device), "gap": gap, "step1_frac": step1_frac,
                  "train_counts": train_counts, "host_counts": host_counts, "loop_counts": loop_counts}
    check_budget("accuracy_ntm")

    # ---- (b) the DNC: the card's train step against the CPU's ---------------
    # float32 on both sides: the train step's loss. The gradients are held in
    # float64 on both sides, from the same tokens: the allocation's sort
    # makes the DNC's gradient jump where two slots' usages tie to within
    # rounding (the derivative of a slot's allocation takes the usages
    # sorted before it), so two float32 runs, or two runs on inputs that
    # differ by rounding, that order a near-tie apart differ by ~1e-3 of a
    # gradient's largest entry however right both are.
    dcfg = demo_config(core="dnc")
    cpu = torch.device("cpu")
    dexp = OffsetExperiment(dcfg, vgg, image_mode="cropped", device=dev)
    dparams, dopt = dexp.init(torch.Generator().manual_seed(2))
    dbatch = training_batch(dcfg, np.random.RandomState(1), dev)
    cexp = OffsetExperiment(dcfg, tree_map(lambda t: t.to(cpu), vgg), image_mode="cropped", device=cpu)
    to_cpu = functools.partial(tree_map, lambda t: t.to(cpu))
    cbatch = {k: v.to(cpu) if isinstance(v, torch.Tensor) else v for k, v in dbatch.items()}

    # the card's VGG tokens, given to both sides: the DNC's gradient jumps
    # at near-tied usages even in float64 when the inputs differ (the
    # convs' float32 rounding on two devices, ~1e-6)
    with torch.no_grad():
        features = dexp.batch_features(dexp.device_batch(dbatch)).double()

    def loss_and_grads(e, p, b):
        """The train step's loss and gradients in float64 on `features`."""
        live = tree_map(lambda t: t.detach().double().requires_grad_(), p)
        b = e.device_batch(b)
        f = features.to(e.device)
        B, L = f.shape[0], dcfg.train.sequence_length
        tokens = serialize_tokens(f, b["gts"].double().reshape(B, L, -1)[:, 0])
        state = tree_map(lambda t: t.double(), e.core.init_state(p, B))
        logits, _ = e.core.unroll(live, tokens, state)
        loss = offsets_loss(logits, e._targets(b, B).double(), dcfg.num_features)
        return float(loss.detach()), torch.autograd.grad(loss, tree_leaves(live))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d_new, _, d_m = dexp.make_train_step()(dparams, dopt, dbatch)
    d_loss = float(d_m["loss"])
    card_s = time.perf_counter() - t0
    with torch.no_grad():
        c_loss = float(cexp.loss_fn(to_cpu(dparams), cbatch)[0])
    t0 = time.perf_counter()
    d64_loss, d64_grads = loss_and_grads(dexp, dparams, dbatch)
    card64_s = time.perf_counter() - t0
    c64_loss, c64_grads = loss_and_grads(cexp, to_cpu(dparams), cbatch)
    loss_rel = abs(d_loss - c_loss) / abs(c_loss)
    loss64_rel = abs(d64_loss - c64_loss) / abs(c64_loss)
    grad_rel = max(max_abs(g.cpu(), r) / max(float(r.abs().max()), 1e-30) for g, r in zip(d64_grads, c64_grads))
    log("accuracy", f"{smi}: demo DNC train step (B={dcfg.train.batch_size}, T={dcfg.total_steps}, memory "
                    f"{dcfg.dnc.memory_size}x{dcfg.dnc.word_size}, plain PyTorch) card vs CPU: float32 loss "
                    f"{d_loss:.6f} / {c_loss:.6f}, rel {loss_rel:.2e} (tol {DNC_LOSS_RTOL:g}); float64 on the same "
                    f"tokens: loss rel {loss64_rel:.2e}, gradients max rel {grad_rel:.2e} (tol {GRAD_TOL:g}); float32 against "
                    f"float64 loss rel {abs(d_loss - c64_loss) / abs(c64_loss):.2e}; the train step on the card "
                    f"{card_s:.2f}s, float64 loss and gradients on the card {card64_s:.2f}s")
    if loss_rel > DNC_LOSS_RTOL or loss64_rel > DNC_LOSS_RTOL or grad_rel > GRAD_TOL:
        raise AssertionError(f"the DNC's train step on the card disagrees with the CPU's: loss {loss_rel:.2e} "
                             f"(float64 {loss64_rel:.2e}), gradients {grad_rel:.2e}")
    reset_all_counts()
    trk = StreamingTracker(dcfg, vgg, d_new, device=dev)
    frames, boxes = make_video(np.random.RandomState(3), 1 + ACC_DNC_FRAMES)
    H, W = frames.shape[1:3]
    b0 = boxes[0]
    trk.init(frames[0], (b0[1] * W, b0[0] * H, (b0[3] - b0[1]) * W, (b0[2] - b0[0]) * H))
    frame_ms = []
    for t in range(1, 1 + ACC_DNC_FRAMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        region = trk.track(frames[t])
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    dnc_counts = kernel_counts()
    log("accuracy", f"{smi}: DNC StreamingTracker {ACC_DNC_FRAMES} frames of {frames.shape[1]}x{frames.shape[2]}: "
                    f"{', '.join(f'{v:.1f}' for v in frame_ms)} ms a frame (65 plain DNC steps each), region[-1] "
                    f"{[round(float(v), 2) for v in region]}; kernel launches {dnc_counts}")
    if not np.isfinite(region).all() or dnc_counts["ntm_scan_fused"] or dnc_counts["bptt_forward"]:
        raise AssertionError("the DNC tracker's output is not finite, or it launched an NTM kernel")
    out["dnc"] = {"loss_rel": loss_rel, "loss64_rel": loss64_rel, "grad64_rel": grad_rel, "step_s": card_s,
                  "frame_ms": frame_ms}
    check_budget("accuracy_dnc")

    # ---- (c) the flagship width ---------------------------------------------
    fcfg = flagship_config(ACC_FLAG_SEQS)
    fvgg = init_vgg_params(torch.Generator().manual_seed(0), dev)
    fexp = OffsetExperiment(fcfg, fvgg, image_mode="cropped", device=dev)
    fparams, fopt = fexp.init(torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fbatch = build_dataset(fcfg, fvgg, ACC_FLAG_SEQS, 0, device=dev)
    torch.cuda.synchronize()
    dataset_s = time.perf_counter() - t0
    fstep = fexp.make_train_step()
    reset_all_counts()
    flosses, step_ms = [], []
    for i in range(ACC_FLAG_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fparams, fopt, m = fstep(fparams, fopt, fbatch)
        flosses.append(float(m["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    flag_counts = kernel_counts()
    first, last = loss_fell(flosses, ACC_FLAG_WINDOW)
    log("accuracy", f"{smi}: flagship width B={ACC_FLAG_SEQS} T={fcfg.total_steps}: build_dataset "
                    f"{tuple(fbatch['features'].shape)} in {dataset_s:.2f}s; {ACC_FLAG_STEPS} full-batch steps, "
                    f"step p50 {np.median(step_ms):.2f} ms; loss {flosses[0]:.3f} -> {flosses[-1]:.3f} (mean of the "
                    f"first {ACC_FLAG_WINDOW} {first:.3f}, of the last {last:.3f}); launches {flag_counts}")
    if not last < first or not np.isfinite(flosses).all():
        raise AssertionError(f"the flagship-width loss did not fall: {first:.3f} -> {last:.3f}")
    if flag_counts["bptt_forward"] != ACC_FLAG_STEPS or flag_counts["bptt_backward"] != ACC_FLAG_STEPS:
        raise AssertionError(f"the flagship-width steps did not each run B2 once: {flag_counts}")
    out["flagship"] = {"losses": flosses, "step_ms": step_ms, "dataset_s": dataset_s, "counts": flag_counts}
    check_budget("accuracy")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr, flush=True)
        return 2

    from ntm_tracker_tpu_torch import _build
    from ntm_tracker_tpu_torch.config import NTMConfig, TrackerConfig
    from ntm_tracker_tpu_torch.data import geometry
    from ntm_tracker_tpu_torch.data.image_ops import crop_and_resize
    from ntm_tracker_tpu_torch.models.core import make_core
    from ntm_tracker_tpu_torch.models.ntm_cell import init_ntm_params, init_ntm_state
    from ntm_tracker_tpu_torch.models.vgg import VGG_MEAN, extract_features, init_vgg_params, vgg16_features
    from ntm_tracker_tpu_torch.ops.kernels.scan_bptt import token_projection
    from ntm_tracker_tpu_torch.ops.kernels.scan_cell import (
        CLUSTER_WAVES, flatten_state, ntm_scan_fused, ntm_scan_fused_reference, run_route,
    )
    from ntm_tracker_tpu_torch.tracking.tracker import (
        StreamingTracker, build_frame_step, first_frame_gt, region_geometry,
    )
    from ntm_tracker_tpu_torch.train.experiments import frame_tokens

    dev = torch.device("cuda")

    # ---- 1. device ---------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log("device", f"torch {torch.__version__} cuda {torch.version.cuda}; {kind}; nvidia-smi: {smi}")
    check_budget("device")

    # ---- 2. build ----------------------------------------------------------
    # one nvcc per library, all started together (scan_packed.cu builds
    # three: its forward, its backward, their probe variants); every build
    # ends before the first timed phase
    t0 = time.perf_counter()
    paths = _build.build_all(["scan_cell", "scan_bptt", "addressing", "scan_packed", "scan_packed_bwd",
                              "scan_packed_probe"])
    for name in paths:
        _build.load_library(name)
    log("build", f"all libraries ready in {time.perf_counter() - t0:.2f}s (parallel nvcc; "
                 f"{', '.join(p.name for p in paths.values())})")
    check_budget("build")

    # ---- 3. kernel vs plain version on the card ----------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    IN = TrackerConfig().input_depth
    cluster = phase_cluster_info(dev, IN)
    # (cfg, B, compute dtype, route): None = the route the rule picks
    # (ntm_scan_fused), else that route forced (run_route)
    cases = {
        "a_flagship_b1": (NTMConfig(), 1, None, None),
        "b_flagship_b4": (NTMConfig(), 4, None, None),
        "c_2layer_writefirst_s5_2w": (
            NTMConfig(controller_num_layers=2, write_first=True, shift_range=2, write_head_size=2), 1, None, None),
        "d_flagship_bf16": (NTMConfig(), 1, torch.bfloat16, None),
        "e_flagship_b16_cluster": (NTMConfig(), 16, None, "cluster"),
        "f_flagship_b16": (NTMConfig(), 16, None, None),
        "h_flagship_b64": (NTMConfig(), 64, None, None),
        "g_flagship_b4_bf16_tile": (NTMConfig(), 4, torch.bfloat16, "tile"),
    }
    flagship_err, case_routes = None, {}
    for i, (name, (ncfg, B, cd, forced)) in enumerate(cases.items()):
        gen = torch.Generator().manual_seed(100 + i)
        params = init_ntm_params(ncfg, IN, gen, dev)
        state = init_ntm_state(params, ncfg, B)
        toks = torch.tensor(np.random.RandomState(200 + i).randn(B, 65, IN).astype(np.float32), device=dev)
        before = dict(ntm_scan_fused.launches_by_route)
        run = (functools.partial(ntm_scan_fused, params, ncfg, toks, state, compute_dtype=cd) if forced is None
               else functools.partial(run_route, forced, params, ncfg, toks, state, cd))
        logits, final = run()
        torch.cuda.synchronize()
        route = [r for r, n in ntm_scan_fused.launches_by_route.items() if n != before[r]]
        again = run()
        same = torch.equal(logits, again[0]) and all(
            torch.equal(a, b) for a, b in zip(flatten_state(final), flatten_state(again[1])))
        ref_logits, ref_final = ntm_scan_fused_reference(params, ncfg, toks, state, compute_dtype=cd)
        diffs = state_diffs(logits, final, ref_logits, ref_final)
        tol = BF16_TOL if cd == torch.bfloat16 else F32_TOL
        worst = max(diffs.values())
        finite = bool(torch.isfinite(logits).all())
        case_routes[name] = route[0] if len(route) == 1 else route
        log("kernel", f"{name} B={B} T=65 IN={IN} route {case_routes[name]} ({'forced' if forced else 'the rule'}) "
                      f"max_abs={worst:.3e} tol={tol:g} finite={finite} same bits on a rerun {same} "
                      + " ".join(f"{k}={v:.2e}" for k, v in diffs.items()))
        if not finite or worst > tol or not same or len(route) != 1:
            raise AssertionError(f"{name}: kernel disagrees with the plain version ({worst:.3e} > {tol}), is not "
                                 f"deterministic, or ran no single route ({route})")
        if name == "a_flagship_b1":
            flagship_err = worst
            flag_args = (params, ncfg, toks, state)
    expected_routes = {"a_flagship_b1": "cluster", "b_flagship_b4": "cluster", "c_2layer_writefirst_s5_2w": "tile",
                       "d_flagship_bf16": "cluster", "e_flagship_b16_cluster": "cluster",
                       "f_flagship_b16": "cluster" if 16 <= CLUSTER_WAVES * cluster["max_active_clusters"] else "tile",
                       "g_flagship_b4_bf16_tile": "tile",
                       "h_flagship_b64": "cluster" if 64 <= CLUSTER_WAVES * cluster["max_active_clusters"] else "tile"}
    if case_routes != expected_routes:
        raise AssertionError(f"routes {case_routes}, expected {expected_routes}")
    # T = 0 echoes the state and launches nothing
    params, ncfg, toks, state = flag_args
    before = ntm_scan_fused.launches
    logits0, state0 = ntm_scan_fused(params, ncfg, toks[:, :0], state)
    if state0 is not state or tuple(logits0.shape) != (1, 0, ncfg.output_dim) or ntm_scan_fused.launches != before:
        raise AssertionError("T=0 must echo the state without a launch")
    log("kernel", "T=0 echo ok")
    check_budget("kernel")

    # ---- 3b. the training kernels (B2) vs their plain version -----------------
    bptt_tiles = phase_bptt(dev, IN)
    check_budget("bptt")

    # ---- 3c. the addressing kernel (B3) vs its plain version, and its times ----
    addr = phase_addressing(dev, smi)
    check_budget("addressing")

    # ---- 4. the frame step end to end ----------------------------------------
    cfg = TrackerConfig()
    gen = torch.Generator().manual_seed(0)
    vgg = init_vgg_params(gen, dev)
    params = init_ntm_params(cfg.ntm, cfg.input_depth, gen, dev)
    n_track = 8
    video, region0 = synthetic_video(seed=0, frames=1 + n_track)
    trk = StreamingTracker(cfg, vgg, params, device="cuda")
    init_bbox = geometry.initial_transformed_bbox(cfg.data.cropbox_grid, cfg.data.bbox_grid)

    reset_counts()
    trk.init(video[0], region0)
    per_frame = [ntm_scan_fused.launches]
    cropboxes, offsets, regions = [list(trk.cropbox)], [], []
    for t in range(1, 1 + n_track):
        cropboxes.append(list(trk.cropbox))
        regions.append(trk.track(video[t]))
        offsets.append([trk.output_bbox[0] - init_bbox[0], trk.output_bbox[1] - init_bbox[1]])
        per_frame.append(ntm_scan_fused.launches)
    main_path_launches = ntm_scan_fused.launches
    frame_routes = dict(ntm_scan_fused.launches_by_route)
    frame_proj = token_projection.launches
    if per_frame != list(range(1, 2 + n_track)):
        raise AssertionError(f"kernel launches per frame {per_frame}: expected one per frame")
    if frame_routes != {"cluster": 1 + n_track, "tile": 0} or frame_proj != 1 + n_track:
        raise AssertionError(f"the frame path ran B1's routes {frame_routes} and {frame_proj} projections: expected "
                             f"the cluster route and one projection per frame")
    offsets = np.asarray(offsets)
    if offsets.shape != (n_track, 2) or not np.isfinite(offsets).all() or not np.isfinite(regions).all():
        raise AssertionError(f"bad tracker output: offsets {offsets}")

    # the same crops through the plain loop on the card
    plain_cfg = dataclasses.replace(cfg, fused_inference=False)
    step_first, step_rest = build_frame_step(plain_cfg, make_core(plain_cfg), vgg, params, device=dev)
    mean = torch.as_tensor(VGG_MEAN, device=dev)

    def crop(frame, box):
        img = torch.as_tensor(frame, device=dev).float() - mean
        return crop_and_resize(img[None], torch.tensor([box], dtype=torch.float32, device=dev),
                               (cfg.data.crop_size, cfg.data.crop_size))

    nb, _, tr = region_geometry(cfg.data, (video.shape[2], video.shape[1]), region0)
    gt = torch.as_tensor(first_frame_gt(cfg, nb, tr).reshape(1, -1), device=dev)
    with torch.no_grad():
        pstate = init_ntm_state(trk.params, cfg.ntm, 1)
    _, pstate = step_first(crop(video[0], cropboxes[0]), gt, pstate)
    plain_offsets = []
    for t in range(1, 1 + n_track):
        off, pstate = step_rest(crop(video[t], cropboxes[t]), pstate)
        plain_offsets.append(off[0].cpu().numpy())
    off_err = float(np.abs(offsets - np.asarray(plain_offsets, np.float64)).max())
    log("frame", f"StreamingTracker full width: init + {n_track} frames, launches per frame "
                 f"{np.diff([0] + per_frame).tolist()} (B1 by route {frame_routes}, projections {frame_proj}), offsets[-1]={offsets[-1].tolist()} "
                 f"region[-1]={[round(float(v), 2) for v in regions[-1]]}; fused vs plain loop on the same crops: "
                 f"max_abs(offsets)={off_err:.3e} tol={F32_TOL:g}")
    if off_err > F32_TOL:
        raise AssertionError(f"fused frame step disagrees with the plain loop: {off_err:.3e}")

    # the receptive-field slice gives the full map's tokens
    c0 = crop(video[0], cropboxes[0])
    with torch.no_grad():
        fast = frame_tokens(cfg, vgg, c0)
        full = extract_features(vgg16_features(vgg, c0))
    tok_err = max_abs(fast, full) / max(float(full.abs().max()), 1e-30)
    log("frame", f"conv4_3 tokens slice vs full map: rel max_abs={tok_err:.3e} tol=1e-4 shape={tuple(fast.shape)}")
    if tuple(fast.shape) != (1, 64, 512) or tok_err > 1e-4:
        raise AssertionError("VGG token paths disagree")
    check_budget("frame")

    # ---- 5. times --------------------------------------------------------------
    params, ncfg, toks, state = flag_args
    kernel_ms = cuda_ms(lambda: ntm_scan_fused(params, ncfg, toks, state), iters=100, warmup=5)
    plain_ms = cuda_ms(lambda: ntm_scan_fused_reference(params, ncfg, toks, state), iters=10, warmup=2)
    layer0 = params["controller"][0]
    proj_ms = cuda_ms(lambda: token_projection(toks, layer0["kernel"], layer0["bias"]), iters=100, warmup=5)
    # the cluster route's time per cell step: B1 at B=1 less its projection
    step_us = (kernel_ms - proj_ms) / toks.shape[1] * 1e3
    nbytes, nops = scan_cell_work(ncfg, 1, 65, IN)
    bound_ms = max(nbytes / HBM_BYTES_PER_S, nops / F32_FLOP_PER_S) * 1e3
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S > nops / F32_FLOP_PER_S else "operations"
    log("times", f"{smi}: scan_cell B=1 T=65 kernel {kernel_ms:.4f} ms (100 calls, the projection and the cluster "
                 f"route, L2 warm), plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms by {bound_by} "
                 f"({nbytes / 1e6:.3f} MB, {nops / 1e6:.3f} MFLOP); the projection alone {proj_ms:.4f} ms, so "
                 f"{step_us:.3f} us per cell step on the cluster route")
    by_route = route_times(dev, smi, IN)

    with torch.no_grad():
        vgg_ms = cuda_ms(lambda: frame_tokens(cfg, vgg, c0), iters=20, warmup=3)
    log("times", f"{smi}: VGG-16 conv4_3 tokens B=1 (204x204 slice, cuDNN, TF32 off) {vgg_ms:.4f} ms")

    def frame_p50(tracker, n=20):
        times = []
        for t in range(n):
            torch.cuda.synchronize()
            s = time.perf_counter()
            tracker.track(video[1 + t % n_track])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - s) * 1e3)
        return float(np.median(times))

    fused_p50 = frame_p50(trk)
    plain_trk = StreamingTracker(plain_cfg, vgg, params, device="cuda")
    plain_trk.init(video[0], region0)
    plain_p50 = frame_p50(plain_trk)
    log("times", f"{smi}: frame step p50 at B=1 (track(): crop + VGG + 65 cell steps + decode, "
                 f"cudnn/matmul TF32 off) fused {fused_p50:.3f} ms, plain loop {plain_p50:.3f} ms")
    check_budget("times")

    # ---- 6. the fleet slice at full width (use_pallas: B3), and its times -----
    fleet = phase_fleet(dev, smi, cfg, vgg, params)

    # ---- 7. the training slice at full width, and the B2 kernels' times -------
    train = phase_train(dev, smi, IN)

    # ---- 7b. the lane-packed kernels (B4) at the frame and train shapes -------
    packed = phase_packed(dev, smi, IN, train)

    # ---- 7c. the accuracy path: training learns, the trackers track ---------
    accuracy = phase_accuracy(dev, smi)

    # ---- 8. result -----------------------------------------------------------
    # B1 runs on every main path: `launches` is the frame path's count; the
    # fleet's (its adds at B=1), the device loop's, the train path's (its
    # eval step), the route each took, both routes' times and B1's numbers
    # at the training shape beside it. `source` is the cluster route's; the
    # tile route's kernel is B2's forward (BPTT_SOURCE)
    kernels = [{
        "name": KERNEL_NAME, "route": "cuda", "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": main_path_launches, "max_abs_err": flagship_err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "launches_by_path": {"frame_step": main_path_launches, "fleet": fleet["fleet_counts"]["ntm_scan_fused"],
                             "device_loop": fleet["loop_counts"]["ntm_scan_fused"], "train": train["b1"]["launches"],
                             "accuracy_clip": accuracy["ntm"]["host_counts"]["ntm_scan_fused"],
                             "accuracy_device_loop": accuracy["ntm"]["loop_counts"]["ntm_scan_fused"],
                             "accuracy_demo_train": accuracy["ntm"]["train_counts"]["ntm_scan_fused"],
                             "accuracy_flagship_train": accuracy["flagship"]["counts"]["ntm_scan_fused"]},
        "route_by_path": {"frame_step": frame_routes, "fleet": fleet["fleet_routes"],
                          "device_loop": {"cluster": 0, "tile": 0}, "train": train["eval_routes"]},
        "ms_by_route": {"T65": {str(B): v for B, v in by_route.items()},
                        f"B{train['b1']['B']}_T{train['b1']['T']}": train["b1"]["ms_by_route"]},
        "routes_in_kernel_cases": case_routes, "cluster": cluster, "tile_route_source": BPTT_SOURCE,
        "cluster_step_us": step_us, "projection_ms_b1": proj_ms, "cluster_waves": CLUSTER_WAVES,
        "train_shape": {k: v for k, v in train["b1"].items() if k != "launches"},
    }]
    bptt = {}
    for name, launches in (("forward", "bptt_forward"), ("token_projection", "token_projection"),
                           ("backward", "bptt_backward"), ("grad_reduce", "grad_reduce")):
        ms, plain, lib = train[name]
        b_ms, b_by = bound(*train["work"][name])
        abs_err, rel_err = train["errors"][name]
        bptt[name] = {
            "name": f"scan_bptt.{name}", "route": "cuda", "source": BPTT_SOURCE, "replaces": BPTT_REPLACES[name],
            "launches": train["counts"][launches], "max_abs_err": abs_err, "max_rel_err": rel_err, "ms": ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
            "launches_on_accuracy_path": {"demo_train": accuracy["ntm"]["train_counts"][launches],
                                          "flagship_train": accuracy["flagship"]["counts"][launches],
                                          "clip": accuracy["ntm"]["host_counts"][launches]},
        }
        kernels.append(bptt[name])
    bptt["forward"].update({
        "rows_per_block": train["forward_rows"], "ms_by_rows_per_block": {str(r): v for r, v in
                                                                         train["forward_ms_by_rows"].items()},
        "rows_per_block_in_phase_bptt": bptt_tiles["forward"], "max_abs_err_phase_bptt": bptt_tiles["forward_max_abs_err"],
        "train_logits_vs_plain_step": train["logits_vs_plain"], "reads": "the token projection (no token rows of W0)",
    })
    bptt["token_projection"].update({
        "launched_in": "_ScanBPTT.forward, once per train step (the forward and the backward both read it), and "
                       "first in every B1 call (its two routes read it)",
        "launches_by_path": {"frame_step": frame_proj, "fleet": fleet["fleet_counts"]["token_projection"],
                             "device_loop": fleet["loop_counts"]["token_projection"],
                             "train": train["counts"]["token_projection"]},
        "tile": list(train["projection_tile"]),
        "ratio_to_library": train["token_projection"][0] / train["token_projection"][2],
    })
    # the main path's gradients against the plain loop in float64, both routes
    bptt["backward"].update({
        "max_rel_err_vs_float64": train["grad_vs_f64"], "rows_per_block": train["backward_rows"],
        "needs_dtokens": False, "ms_by_variant": train["recurrence_variants"],
        "rows_per_block_in_phase_bptt": bptt_tiles["backward"],
    })
    bptt["grad_reduce"].update({
        "kernels_per_launch": 2,  # ntm_grad_partial_kernel, then ntm_grad_sum_kernel
        "tile": train["reduce_tiles"],
    })
    # B3 at the fleet's batch (64); its times at B=1 and 256 beside them
    at64 = addr["times"][FLEET_CAP]
    kernels.append({
        "name": ADDR_NAME, "route": "cuda", "source": ADDR_SOURCE, "replaces": ADDR_REPLACES,
        "launches": fleet["fleet_counts"]["fused_ntm_addressing"],
        "launches_by_path": {"fleet": fleet["fleet_counts"]["fused_ntm_addressing"],
                             "device_loop": fleet["loop_counts"]["fused_ntm_addressing"]},
        "max_abs_err": addr["max_abs_err"], "grad_max_abs_err": addr["grad_err"], "ms": at64["ms"],
        "plain_ms": at64["plain_ms"], "bound_ms": at64["bound_ms"], "bound_by": at64["bound_by"], "library_ms": None,
        "device_ms": at64["device_ms"],
        "times_by_batch": {str(b): t for b, t in addr["times"].items()},
        "phases": addr["probe"]["phases"], "sm_clock_khz": addr["probe"]["sm_clock_khz"],
        "empty_launch_ms": addr["probe"]["empty_launch_ms"],
    })
    # B4 at the train path's shape (B=256, T=1300) and the rule's tiles. No
    # main path launches it: `launches` is its own path's count (phase
    # packed (d): one forward, one train step), beside the whole phase's
    default = packed["rule"]
    at = packed["train"]
    need_dtokens_ms = {"with": packed["ms"]["backward_dtokens"], "without": packed["ms"]["backward"][default[1]]}
    for name, line, row_ms in (("forward", 225, train["b1"]["ms"]), ("forward_residuals", 290, train["forward"][0]),
                               ("backward", 336, train["backward"][0])):
        b_ms, b_by = packed["bounds"][name]
        fn = {"forward": "packed_forward", "forward_residuals": "packed_forward_residuals",
              "backward": "packed_backward"}[name]
        rows = default[1] if name == "backward" else default[0]
        entry = {
            "name": f"scan_packed.{name}", "route": "cuda", "source": PACKED_SOURCE,
            "replaces": f"ntm_tracker_tpu/ops/pallas/scan_packed.py:{line}", "launches": packed["counts"][fn],
            "launches_in_phase": packed["phase_counts"][fn], "launches_on_main_paths": 0,
            "max_abs_err": packed["worst"]["grad_abs_train"] if name == "backward" else packed["worst"]["fwd_abs"],
            "max_rel_err": packed["worst"]["grad_rel"], "ms": packed["ms"][name][rows],
            "plain_ms": packed["plain"][name], "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "rows_per_block": rows, "ms_rows_1": packed["ms"][name][1], "row_kernel_ms": row_ms,
            "ms_by_rows_per_block": {str(r): v for r, v in packed["ms"][name].items()},
            "B": packed["B"], "T": packed["T"], "tile_rule": packed["rule_by_batch"],
            "need_dtokens_ms": need_dtokens_ms, "initial_state_vs_float64": packed["initial_state_referee"],
            "projection_launches_on_path": packed["counts"]["token_projection"],
        }
        if name != "forward_residuals":
            entry["phases"] = packed["probe"][name]
        if name != "backward":
            entry["with_projection_ms"] = entry["ms"] + train["token_projection"][0]
        if name == "forward":
            entry["frame_shape"] = packed["frame"]
        if name == "backward":
            entry["reduction_ms"] = {"packed_operands": packed["ms"]["reduction"],
                                     "row_kernels": train["grad_reduce"][0],
                                     "packed_operands_weight_grads": packed["ms"]["reduction_weight_grads"]}
            entry["peak_gb"] = {"rows_1": at[(1, 1)]["peak_gb"], f"rows_{rows}": at[default]["peak_gb"]}
            entry["smem_bytes"] = packed["smem"]
        kernels.append(entry)
    log("train", f"{smi}: the train step at B={train['b1']['B']} T={train['b1']['T']}: {train['step_ms']:.3f} ms = "
                 f"{TRAIN_B * TRAIN_L / train['step_ms'] * 1e3:.1f} trained frames/s, peak {train['peak_gb']:.2f} GB")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
