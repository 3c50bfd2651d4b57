#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ntm_tracker_tpu_torch) on one NVIDIA
H100: builds the CUDA kernels from csrc/, holds each against its plain
PyTorch version on the card, drives the streaming tracker's frame step at
full width, and times the kernel, its plain version and the frame step.

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

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

KERNEL_NAME = "scan_cell.ntm_scan_fused"
KERNEL_SOURCE = "ntm_tracker_tpu_torch/csrc/scan_cell.cu"
KERNEL_REPLACES = "ntm_tracker_tpu/ops/pallas/scan_cell.py:42"


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
    return float((a.float() - b.float()).abs().max())


def state_diffs(logits, state, ref_logits, ref_state) -> dict:
    out = {"logits": max_abs(logits, ref_logits)}
    for key in ("M", "w", "read"):
        out[key] = max_abs(state[key], ref_state[key])
    for l, ((c, h), (rc, rh)) in enumerate(zip(state["controller_state"], ref_state["controller_state"])):
        out[f"c{l}"] = max_abs(c, rc)
        out[f"h{l}"] = max_abs(h, rh)
    return out


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
    per_step = (
        sum(2 * k * 4 * Hc for k in k_rows) + 2 * Hc * P + 2 * Hc * O  # matmuls
        + 10 * L * Hc                      # LSTM gates
        + 2 * N * D + 2 * H * D            # memory and key norms
        + 3 * H * N * D                    # normalized similarity
        + 6 * H * N                        # softmax and gate
        + 2 * S * H * N + 3 * H * N        # shift and sharpen
        + 4 * W * N * D + 2 * N * D        # erase/add
        + 2 * R * N * D                    # read
    )
    return 4.0 * floats, float(B * T * per_step)


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
    from ntm_tracker_tpu_torch.ops.kernels.scan_cell import ntm_scan_fused, ntm_scan_fused_reference
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
    t0 = time.perf_counter()
    lib_path = _build.build("scan_cell")
    _build.load_library("scan_cell")
    log("build", f"scan_cell ready in {time.perf_counter() - t0:.2f}s ({lib_path.name})")
    check_budget("build")

    # ---- 3. kernel vs plain version on the card ----------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    IN = TrackerConfig().input_depth
    cases = {
        "a_flagship_b1": (NTMConfig(), 1, None),
        "b_flagship_b4": (NTMConfig(), 4, None),
        "c_2layer_writefirst_s5_2w": (
            NTMConfig(controller_num_layers=2, write_first=True, shift_range=2, write_head_size=2), 1, None),
        "d_flagship_bf16": (NTMConfig(), 1, torch.bfloat16),
    }
    flagship_err = None
    for i, (name, (ncfg, B, cd)) in enumerate(cases.items()):
        gen = torch.Generator().manual_seed(100 + i)
        params = init_ntm_params(ncfg, IN, gen, dev)
        state = init_ntm_state(params, ncfg, B)
        toks = torch.tensor(np.random.RandomState(200 + i).randn(B, 65, IN).astype(np.float32), device=dev)
        logits, final = ntm_scan_fused(params, ncfg, toks, state, compute_dtype=cd)
        torch.cuda.synchronize()
        ref_logits, ref_final = ntm_scan_fused_reference(params, ncfg, toks, state, compute_dtype=cd)
        diffs = state_diffs(logits, final, ref_logits, ref_final)
        tol = BF16_TOL if cd == torch.bfloat16 else F32_TOL
        worst = max(diffs.values())
        finite = bool(torch.isfinite(logits).all())
        log("kernel", f"{name} B={B} T=65 IN={IN} max_abs={worst:.3e} tol={tol:g} finite={finite} "
                      + " ".join(f"{k}={v:.2e}" for k, v in diffs.items()))
        if not finite or worst > tol:
            raise AssertionError(f"{name}: kernel disagrees with the plain version ({worst:.3e} > {tol})")
        if name == "a_flagship_b1":
            flagship_err = worst
            flag_args = (params, ncfg, toks, state)
    # T = 0 echoes the state and launches nothing
    params, ncfg, toks, state = flag_args
    before = ntm_scan_fused.launches
    logits0, state0 = ntm_scan_fused(params, ncfg, toks[:, :0], state)
    if state0 is not state or tuple(logits0.shape) != (1, 0, ncfg.output_dim) or ntm_scan_fused.launches != before:
        raise AssertionError("T=0 must echo the state without a launch")
    log("kernel", "T=0 echo ok")
    check_budget("kernel")

    # ---- 4. the frame step end to end ----------------------------------------
    cfg = TrackerConfig()
    gen = torch.Generator().manual_seed(0)
    vgg = init_vgg_params(gen, dev)
    params = init_ntm_params(cfg.ntm, cfg.input_depth, gen, dev)
    n_track = 8
    video, region0 = synthetic_video(seed=0, frames=1 + n_track)
    trk = StreamingTracker(cfg, vgg, params, device="cuda")
    init_bbox = geometry.initial_transformed_bbox(cfg.data.cropbox_grid, cfg.data.bbox_grid)

    ntm_scan_fused.launches = 0
    trk.init(video[0], region0)
    per_frame = [ntm_scan_fused.launches]
    cropboxes, offsets, regions = [list(trk.cropbox)], [], []
    for t in range(1, 1 + n_track):
        cropboxes.append(list(trk.cropbox))
        regions.append(trk.track(video[t]))
        offsets.append([trk.output_bbox[0] - init_bbox[0], trk.output_bbox[1] - init_bbox[1]])
        per_frame.append(ntm_scan_fused.launches)
    main_path_launches = ntm_scan_fused.launches
    if per_frame != list(range(1, 2 + n_track)):
        raise AssertionError(f"kernel launches per frame {per_frame}: expected one per frame")
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
                 f"{np.diff([0] + per_frame).tolist()}, offsets[-1]={offsets[-1].tolist()} "
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
    nbytes, nops = scan_cell_work(ncfg, 1, 65, IN)
    bound_ms = max(nbytes / HBM_BYTES_PER_S, nops / F32_FLOP_PER_S) * 1e3
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S > nops / F32_FLOP_PER_S else "operations"
    log("times", f"{smi}: scan_cell B=1 T=65 kernel {kernel_ms:.4f} ms (100 launches, L2 warm), "
                 f"plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms by {bound_by} "
                 f"({nbytes / 1e6:.3f} MB, {nops / 1e6:.3f} MFLOP)")

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

    # ---- 6. result -----------------------------------------------------------
    kernels = [{
        "name": KERNEL_NAME, "route": "cuda", "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": main_path_launches, "max_abs_err": flagship_err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
