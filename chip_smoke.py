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
train step; reads the JAX package's full-width orbax checkpoint in the
repository with the port alone (every leaf's checksum), resumes its train
step through B2 against the JAX package's recorded loss and gradient norm,
and tracks from its weights through B1; splits B3's phases with its probe
variant (clock64() stamps); then the accuracy path: the demo config's NTM
trains through B2 until its
loss falls and tracks a held-out clip through B1 within the accuracy
artifact's tripwires, the DNC's train step on the card is held against the
CPU's, and the flagship width trains on build_dataset's tokens; then the
real-data path through the CLI on a synthetic VID tree: preprocess,
cache-features (tokens against the CPU's), train-offsets on cached tokens
(step 0's loss against the CPU's, B2's and B1's launches counted) and on
decoded frames (host and device resize), a resume from a checkpoint and
one from the JAX package's orbax checkpoint;
then, in the same tree, the experiment lab through the CLI: train-heatmap
(both serializations, B2 with the tokens' gradient under the compressor),
train-wholeframe and train-active-resize (B2 once a frame) on a pickle
mine-sequences makes, train-offsets --save_imgs (the dashboards through B1
a chunk), dnc-repeat-copy and the legacy NTM, each training path's first
step against the plain route on the card; then serving and data
parallelism; and last the bench path: benchmarks.main (the `bench`
subcommand) at reduced sizes, its JSON line and launches held, and
tools/bench_train.py, bench_bptt_knee.py and profile_train.py as CLI
subprocesses, each line's launches held.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (PATH or /usr/local/cuda/bin), nvidia-smi and
libzstd.so.1. Every phase prints one flushed line with its elapsed
seconds, and a [phases] line before the result gives each phase's; any
failure raises, so the exit code is non-zero and the final result line is not
printed. Card-only checks of the port live here, not in pytest: the test
suite's conftest imports JAX, which the card's machine does not have.

Output ends with the card's name and power limit (nvidia-smi), one
{"kernels": [...]} JSON line and, last, the {"ok": true, ...} JSON line.
"""

from __future__ import annotations

import atexit
import dataclasses
import functools
import importlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ntm_tracker_tpu_torch.benchmarks import kernel_launches
from ntm_tracker_tpu_torch.utils.profiling import counter, reset as reset_counters

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
# the B=8 fused-vs-plain check's depth (T = 65 B8_L), cut from 4 for room
B8_L = 2
PACKED_SOURCE = "ntm_tracker_tpu_torch/csrc/scan_packed.cu"
ADDR_NAME = "addressing.fused_ntm_addressing"
ADDR_SOURCE = "ntm_tracker_tpu_torch/csrc/addressing.cu"
ADDR_REPLACES = "ntm_tracker_tpu/ops/pallas/addressing.py:45"
# the fleet slice: raw 360x640 frames, the JAX device loop's frame size
# (ntm_tracker_tpu/benchmarks.py:572); the main path at capacity 64
FLEET_HW = (360, 640)
FLEET_CAP, FLEET_STEPS = 64, 10
# capacities 8 and 256 (the device loop's B=256, the fleet profile's B1 and
# plain routes) were cut from the timing sweeps to make room for the serving
# phase; PERF.md keeps their last numbers
FLEET_TIME_CAPS = (FLEET_CAP,)
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
# (ACC_STEPS was 60, ACC_FLAG_STEPS 20 and ACC_DNC_L 3 before the parallel
# phase took their room)
ACC_STEPS, ACC_WINDOW = 40, 10
ACC_FLAG_SEQS, ACC_FLAG_STEPS, ACC_FLAG_WINDOW = 64, 10, 5
ACC_CLIP_FRAMES, ACC_DNC_FRAMES = 12, 4
# the DNC's card-against-CPU train step runs ACC_DNC_L frames a clip (T =
# 130), not the demo's 8: its eager step is host dispatch, ~0.5 s a frame on
# each side
ACC_DNC_L = 2
DNC_LOSS_RTOL = 1e-4
# the data phase: a synthetic VID tree (seqname, split, (width, height),
# frames, objects; an object is a track, so a sequence dir after
# preprocess): 8 train tracks at 1280x720, 8 val tracks at 640x360 (the
# TF1 resize), driven through the port's CLI at TrackerConfig()'s width.
# The cached run trains DATA_EPOCHS steps at B = DATA_B (one an epoch), the
# raw-frame runs DATA_RAW_STEPS at B = DATA_RAW_B over the first
# DATA_RAW_LIMIT train tracks (more steps than the prefetcher's 2 batches
# ahead, so its wait shows). Tokens: the card's against the CPU's on the
# same crops (float32 VGG, TF32 off), <= 1e-4 of the largest; step 0's
# loss on the card against the CPU's, <= 1e-4, and so the resumed run's
# first validation and the device resize's step 0 against the host's.
DATA_SEQS = (
    ("ILSVRC2015_train_00000000", "train", (1280, 720), 24, 4),
    ("ILSVRC2015_train_00000001", "train", (1280, 720), 24, 4),
    ("ILSVRC2015_val_00000000", "val", (640, 360), 24, 8),
)
DATA_B, DATA_EPOCHS = 8, 10
DATA_RAW_B, DATA_RAW_STEPS, DATA_RAW_LIMIT = 2, 6, 6
DATA_TOKEN_FRAMES = 4
DATA_TOL = 1e-4
# the lab phase, at TrackerConfig()'s width: train-heatmap (both
# serializations; sequential T = 64 + 19 x 129 = 2,515, frame T = 1,300) and
# train-offsets --save_imgs (the dashboards' chunked unroll_states) at B =
# LAB_B, L = LAB_L on the data phase's float16 cache, LAB_STEPS steps each;
# train-wholeframe (pool5, IN 49 x 128 + 49 = 6,321, +1 two-step) and
# train-active-resize (LAB_AR_L frames, T = 65 a frame) at B = LAB_PICKLE_B
# for LAB_PICKLE_EPOCHS epochs on a pickle mine-sequences makes from a VID
# tree of the phase's own (LAB_SEQS, its boxes on pool5's prior cells);
# dnc-repeat-copy at its defaults, LAB_DNC_ITERS iterations; one
# legacy_ntm_unroll_batched. Each training path's first step is held
# against the plain route on the card at depth LAB_CHECK_L (the loss within
# F32_TOL, each gradient within GRAD_TOL of its largest); the DNC's step-0
# loss and the legacy NTM against the CPU's (DNC_LOSS_RTOL, LEGACY_TOL).
LAB_B, LAB_L, LAB_STEPS, LAB_CHECK_L = 8, 20, 3, 2
LAB_SEQS, LAB_FRAMES, LAB_SIDE = 2, 24, 448
LAB_PICKLE_B, LAB_PICKLE_EPOCHS, LAB_AR_L = 2, 2, 4
LAB_DNC_ITERS = 3
LAB_LEGACY_B, LAB_LEGACY_T = 4, 20
# a gradient that vanishes in exact arithmetic (the sequential stream's
# output bias: the softmax over one channel's F steps ignores a shift) is
# rounding on both routes, held under this share of the largest gradient
LAB_ZERO_TOL = 1e-5
LEGACY_TOL = 1e-5
# the serving phase, at TrackerConfig()'s width on the CLI's seeded weights:
# export-serving for cuda at batch 1 and at SERVE_FLEET with the device loop
# at FLEET_HW; a SERVE_CLIP-frame clip through the artifact and the live
# routes (offsets within F32_TOL on the same crops); track-vot over TraX
# pipes (regions within SERVE_REGION_TOL_PX of the in-process tracker's);
# validate --fleet SERVE_FLEET on SERVE_FLEET of the data phase's val
# tracks cut to SERVE_VAL_FRAMES frames, through the artifact (IoUs within
# SERVE_IOU_TOL of the live plain route's replay) and live (B1 in the adds:
# its ~1e-7 from the plain route grows through the recrops of a tracker on
# random weights, so only each track's first IoU is held); int8 tokens, the card's against the CPU's, within
# INT8_TOL of the largest (both sum exactly in int32: float32 rounding of
# the dequantization is what differs) and their cosine to the exact path
# above INT8_COS (the JAX package's bar); train-offsets --profile_steps.
# (SERVE_VAL_FRAMES was 8 before the orbax phase took its room)
SERVE_CLIP, SERVE_FLEET, SERVE_VAL_FRAMES = 12, 8, 5
# the packed phase holds B4 against its plain version on phase_bptt's cases
# at T <= PACKED_CHECK_T (cut from 1,300 to make room for the parallel
# phase: phase_bptt holds B2 against the plain loop at T = 1,300, and
# packed (c) holds B4 against B2 at B = 256, T = 1,300)
PACKED_CHECK_T = 260
# B4's kernels recording gradients and the packed plain version's autograd
# are timed against each other at B = 256 on the first PACKED_PLAIN_T
# steps (the plain autograd at T = 1,300 takes 9-11 s)
PACKED_PLAIN_T = 130
SERVE_REGION_TOL_PX = 1e-2
# validate's witness of the closed loop's growth: the first box moved this
# share of the frame's width (validate's first regions are normalized)
SERVE_NUDGE = 1e-4
SERVE_IOU_TOL = 1e-3
INT8_TOL, INT8_COS = 1e-6, 0.995
INT8_TIME_B = (1, 64)

# the parallel phase, at TrackerConfig()'s width: (a) two gloo ranks on the
# one card (NCCL refuses two ranks on one device), DP_STEPS steps of
# parallel_train_step at a global batch of DP_B (DP_B / 2 a rank), L =
# DP_L (T = 260) on tokens drawn on the card from DP_SEED, against one
# process at the global batch: the loss within F32_TOL (relative), the
# pre-clip gradients within GRAD_TOL of their largest; (b) train-offsets at
# world size 1 over NCCL against the same command without --dist_*, every
# step's loss within PAR_LOSS_TOL (relative); (c) cache-features --shard
# against the data phase's float32 cache (base), DATA_TOL; (d) FleetTracker
# over a mesh at capacity PAR_FLEET_CAP for PAR_FLEET_FRAMES frames
# (B1 in the adds and the steps): its first shard against a meshless fleet
# of that shard's slots, F32_TOL (the same batch), and the whole against
# the meshless fleet within REGION_TOL_PX (its shards run VGG and B1 at
# half the batch: float32 rounding that three recrops carry); (e)
# one plain-route train step at B = PAR_KNOB_B, L = PAR_KNOB_L with layout
# "dn" and remat "dots" against "nd" / "full" (F32_TOL, GRAD_TOL), and a
# "dn" forward with use_pallas, B3 once a step, against the plain "nd"
# forward (F32_TOL); (f) tools/bench_scale_head at SCALE_HEAD_STEPS steps a
# head, SCALE_HEAD_FRAMES frames a clip.
DP_B, DP_L, DP_STEPS, DP_SEED = 16, 4, 2, 11
# the one card stands in for PAR_SHARDS local devices where one process
# splits its work: each rank's mesh in (a), the sharded cache build (c)
# and the sharded fleet (d) run PAR_SHARDS shards on cuda:0
PAR_SHARDS = 2
PAR_LOSS_TOL = 1e-6
PAR_FLEET_CAP, PAR_FLEET_FRAMES = 8, 3
PAR_KNOB_B, PAR_KNOB_L = 4, 2
SCALE_HEAD_STEPS, SCALE_HEAD_FRAMES = 5, 12

# the bench phase: (a) benchmarks.main in-process at BENCH_KW (the JAX
# bench's sizes cut: a sweep of 128 -> 256, 3 timed steps a pass, 20
# latency frames, the cached train step at B=256, L=20 for 2 steps, the
# device loop 3 steps a pass (both were 5, cut for room);
# no TRACK artifact); its JSON line carries
# every key of the JAX bench's (JAX_BENCH_KEYS, ntm_tracker_tpu/
# benchmarks.py:490-516). (b) the three measurement tools as CLI
# subprocesses at BENCH_TOOLS' sizes, run beside the accuracy and data
# phases, whose times go into no kernel's entry; each JSON line's launches
# held to the counts its variant implies.
BENCH_KW = dict(sweep_max=256, iters=3, latency_frames=20, train_iters=2, device_loop_iters=3, track_artifact=False)
# the measured fields of the bench's JSON line that go into the kernels line
BENCH_MEASURED = ("value", "best_batch", "pipelined_frame_ms_b1", "pipelined_frame_ms_b1_med", "p10_roundtrip_ms_b1",
                  "p50_roundtrip_ms_b1", "p90_roundtrip_ms_b1", "roundtrip_n", "device_loop_frames_per_sec",
                  "train_frames_per_sec_cached", "train_step_ms_cached")
JAX_BENCH_KEYS = (
    "metric", "value", "unit", "vs_baseline", "pipelined_frame_ms_b1", "pipelined_frame_ms_b1_med",
    "p10_roundtrip_ms_b1", "p50_roundtrip_ms_b1", "p90_roundtrip_ms_b1", "roundtrip_n", "best_batch",
    "headline_variant", "frames_per_sec_weights_as_args", "frame_gflops", "achieved_tflops", "mfu",
    "device_loop_frames_per_sec", "train_frames_per_sec_cached", "train_step_ms_cached", "train_mfu",
    "budget_skipped", "platform",
)
BENCH_TOOLS = {
    "bench_train": ["--modes", "images,tokens", "--batch", "2", "--seq_len", "2", "--iters", "1"],
    "bench_bptt_knee": ["--batches", "8", "--seq", "65", "--iters", "1", "--paths", "fused,plain"],
    "profile_train": ["--batch", "8", "--seq_len", "1", "--iters", "1", "--variants",
                      "fused_bptt_f32,fused_fwd_f32,f32_pallas_fwd,abl_none,lstm_only_f32"],
}


# B4's libraries, built beside the others and needed first by the packed phase
PACKED_LIBRARIES = ("scan_packed", "scan_packed_bwd", "scan_packed_probe")
# the nice value of B1's, B2's and B3's compilers and of the CPU workers,
# and of the work needed only later (B4's compilers, the serving exports):
# main's thread first
BUILD_NICE, LATER_NICE = 10, 19
# the orbax phase: the JAX package's full-width checkpoint that the
# repository carries (tests/make_orbax_fixture.py writes it and its JSON
# record), read by the port alone; the resumed B2 step within
# ORBAX_LOSS_RTOL (loss) and ORBAX_GNORM_RTOL (pre-clip global gradient
# norm) of the JAX package's recorded step on the same batch (float32 on
# both sides, JAX's on a CPU at "highest" matmul precision: other sums in
# other orders over T=130 steps), and of the plain route on the card at
# F32_TOL / GRAD_TOL; StreamingTracker from the restored params for
# ORBAX_FRAMES frames on B1 against the plain loop (F32_TOL). The data
# phase's (f) resumes train-offsets from the same directory.
ORBAX_DIR = os.path.join("tests", "fixtures", "orbax_ntm_full")
ORBAX_LOSS_RTOL, ORBAX_GNORM_RTOL = 1e-4, 1e-3
ORBAX_FRAMES = 8
# plain references that no kernel runs and no check needs at once (float64
# referees, the CPU's losses) run in CPU_WORKERS spawned processes of
# CPU_THREADS threads each, beside the card's phases; each check reads its
# result where it is made
CPU_WORKERS, CPU_THREADS = 2, 2
# seconds of each check_budget step since the one before (a name that
# recurs adds up), printed on one line before the kernels line
PHASE_S: dict = {}
_PHASE_MARK = [T_START]


def _cpu_worker_init() -> None:
    os.nice(BUILD_NICE)
    torch.set_num_threads(CPU_THREADS)


def start_cpu_pool():
    """The CPU workers (spawned: this process holds a CUDA context and
    threads); shut down at exit."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(CPU_WORKERS, mp_context=multiprocessing.get_context("spawn"),
                               initializer=_cpu_worker_init)
    atexit.register(pool.shutdown, cancel_futures=True)
    return pool


def offload(pool, fn, *args):
    """fn(*args) in the CPU pool: a future; pool=None runs it now (a phase
    run alone)."""
    from concurrent.futures import Future

    if pool is not None:
        return pool.submit(fn, *args)
    done = Future()
    done.set_result(fn(*args))
    return done


def cpu_offsets_loss(cfg, params, batch) -> tuple:
    """(OffsetExperiment.loss_fn's loss on the CPU, seconds): the data
    phase's CPU reference."""
    from ntm_tracker_tpu_torch.train.experiments import OffsetExperiment

    t0 = time.perf_counter()
    with torch.no_grad():
        loss = float(OffsetExperiment(cfg, None, device="cpu").loss_fn(params, batch)[0])
    return loss, time.perf_counter() - t0


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] t={time.perf_counter() - T_START:.1f}s {msg}", flush=True)


def check_budget(phase: str) -> None:
    now = time.perf_counter()
    PHASE_S[phase] = PHASE_S.get(phase, 0.0) + now - _PHASE_MARK[0]
    _PHASE_MARK[0] = now
    elapsed = now - T_START
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


def bptt_case_inputs(name: str, dev: torch.device, IN: int) -> tuple:
    """(cfg, B, T, params, tokens, cotangents, state_fn) of phase_bptt's
    case `name` on `dev`: one of bptt_cases() (seed 300 + its index),
    "e_wconv_zero" (wconv_zero_case) or "b1_trainable" (the flagship at
    B=2, T=65, seed 330)."""
    from ntm_tracker_tpu_torch.config import NTMConfig
    from ntm_tracker_tpu_torch.models.ntm_cell import init_ntm_state

    if name == "e_wconv_zero":
        ncfg, B, params, tokens, cot, zero_state, _, _ = wconv_zero_case(dev, IN)
        return ncfg, B, 1, params, tokens, cot, zero_state
    cases = bptt_cases()
    ncfg, B, T = cases[name] if name in cases else (NTMConfig(), 2, 65)
    seed = 300 + list(cases).index(name) if name in cases else 330
    params, tokens, cot = scan_case(ncfg, B, T, seed, dev, IN)
    return ncfg, B, T, params, tokens, cot, lambda p: init_ntm_state(p, ncfg, B)


def bptt_plain_reference(name: str, IN: int) -> tuple:
    """Autograd through the plain loop (ntm_scan_fused_bptt_reference) on
    phase_bptt's case `name`, on the CPU from the same seeded inputs
    (phase_bptt's references, run in the CPU pool from the start): (logits,
    final state, {name: grad}, seconds)."""
    from ntm_tracker_tpu_torch.ops.kernels.scan_bptt import ntm_scan_fused_bptt_reference
    from ntm_tracker_tpu_torch.train.optim import tree_map

    t0 = time.perf_counter()
    ncfg, _, _, params, tokens, cot, state_fn = bptt_case_inputs(name, torch.device("cpu"), IN)
    logits, final, grads = grads_of(ntm_scan_fused_bptt_reference, params, ncfg, tokens, cot, state_fn)
    return logits, tree_map(lambda t: t.detach(), final), grads, time.perf_counter() - t0


def start_bptt_references(IN: int, pool) -> dict:
    """bptt_plain_reference of every phase_bptt case, submitted to `pool`:
    {name: future}."""
    return {name: offload(pool, bptt_plain_reference, name, IN)
            for name in (*bptt_cases(), "e_wconv_zero", "b1_trainable")}


def phase_bptt(dev: torch.device, IN: int, plain: dict) -> dict:
    """B2 against its plain version, on five cases: the forward at every
    tile that fits against bptt_forward_reference on the same projection
    on the card (logits, final state and residual streams, the same bits
    on a rerun), and the whole route (autograd Function) against autograd
    through the plain loop on the CPU (`plain`: start_bptt_references'
    futures): logits, final state and every gradient, with the forward at
    each tile and the backward at one and two rows per block (where two
    fit), and the flagship cases also with tokens that need no gradient
    (the backward then computes no dtokens); and B1's trainable wrapper
    against the same plain version. Returns the tiles each case ran at and
    the forward's largest error."""
    from ntm_tracker_tpu_torch.ops.kernels import scan_bptt
    from ntm_tracker_tpu_torch.ops.kernels.scan_bptt import ntm_scan_fused_bptt
    from ntm_tracker_tpu_torch.ops.kernels.scan_cell import MAX_SMEM_BYTES, ntm_scan_fused_trainable
    from ntm_tracker_tpu_torch.train.optim import tree_map

    def compare(name, case, inputs, scan, variants=((None, None, True),)):
        ncfg, B, T, params, tokens, cot, state_fn = inputs
        t0 = time.perf_counter()
        pl, pf, pg, plain_s = plain[case].result()
        wait_s = time.perf_counter() - t0
        pl, pf, pg = (tree_map(lambda t: t.to(dev), x) for x in (pl, pf, pg))
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
                        f"plain on the CPU {plain_s:.2f} s (a CPU worker; waited {wait_s:.2f} s)")
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

    out, ran, fwd_ran, fwd_worst = {}, {}, {}, 0.0
    for name in bptt_cases():
        inputs = bptt_case_inputs(name, dev, IN)
        ncfg, B, T, params, tokens, _, state_fn = inputs
        fwd_worst = max(fwd_worst, forward_check(name, ncfg, B, T, params, tokens, state_fn(params)))
        ran[name], fwd_ran[name] = bwd_tiles(ncfg), fwd_tiles(ncfg)
        variants = ([(r, None, True) for r in fwd_ran[name]]
                    + [(None, r, g) for r in ran[name] for g in ((True, False) if "flagship" in name else (True,))])
        out[name] = compare(name, name, inputs, ntm_scan_fused_bptt, variants)
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
        res = compare(f"e_wconv_zero rows {rows}", "e_wconv_zero", (ncfg, B, 1, params, tokens, cot, zero_state),
                      functools.partial(ntm_scan_fused_bptt, backward_rows_per_block=rows))
        g_gamma = (res["grads"]["heads_b"][cols["gamma"]], res["grads"]["heads_w"][:, cols["gamma"]])
        if any(bool((g != 0).any()) for g in g_gamma):
            raise AssertionError("d/dgamma must be exactly 0 where w_conv is 0 or 1")
    log("bptt", f"e_wconv_zero: {n_zero} w_conv entries exactly 0, {n_one} exactly 1; kernel dgamma "
                f"(heads_b, heads_w gamma columns) exactly 0 and every gradient finite at rows {ran['e_wconv_zero']}")

    # B1 with gradients: the kernel's forward, autograd of the plain loop behind it
    compare("scan_cell.ntm_scan_fused_trainable", "b1_trainable", bptt_case_inputs("b1_trainable", dev, IN),
            lambda p, c, t, st: ntm_scan_fused_trainable(p, c, t, st))
    return {"backward": ran, "forward": fwd_ran, "forward_max_abs_err": fwd_worst}


def zero_launches(*fns) -> None:
    """Set the wrappers' launch counts to 0 (B1's by route with its own)."""
    reset_counters(*(f"launches.{fn.__name__}" for fn in fns))


def reset_counts() -> None:
    """Set B1's launch counts (in all, by route) and the token projection's
    to 0: both B1 routes launch the projection first."""
    from ntm_tracker_tpu_torch.ops.kernels.scan_bptt import token_projection
    from ntm_tracker_tpu_torch.ops.kernels.scan_cell import ntm_scan_fused

    zero_launches(ntm_scan_fused, token_projection)


def frame_path(cfg, vgg, params, video, region0, dev: torch.device) -> dict:
    """StreamingTracker at B=1 from `params` on `video`: init on its first
    frame, then track each later one on B1's cluster route (one launch and
    one projection a frame, checked), and the same crops through the plain
    loop (build_frame_step with fused_inference=False): the offsets within
    F32_TOL. The launch counts are set to 0 first (and held on cuda only)."""
    from ntm_tracker_tpu_torch.data import geometry
    from ntm_tracker_tpu_torch.data.image_ops import crop_and_resize
    from ntm_tracker_tpu_torch.models.core import make_core
    from ntm_tracker_tpu_torch.models.ntm_cell import init_ntm_state
    from ntm_tracker_tpu_torch.models.vgg import VGG_MEAN
    from ntm_tracker_tpu_torch.tracking.tracker import (
        StreamingTracker, build_frame_step, first_frame_gt, region_geometry,
    )

    n_track = len(video) - 1
    trk = StreamingTracker(cfg, vgg, params, device=dev)
    init_bbox = geometry.initial_transformed_bbox(cfg.data.cropbox_grid, cfg.data.bbox_grid)
    reset_counts()
    trk.init(video[0], region0)
    per_frame = [kernel_launches()["ntm_scan_fused"]]
    cropboxes, offsets, regions = [list(trk.cropbox)], [], []
    for t in range(1, 1 + n_track):
        cropboxes.append(list(trk.cropbox))
        regions.append(trk.track(video[t]))
        offsets.append([trk.output_bbox[0] - init_bbox[0], trk.output_bbox[1] - init_bbox[1]])
        per_frame.append(kernel_launches()["ntm_scan_fused"])
    b1_launches = kernel_launches()["ntm_scan_fused"]
    routes = kernel_launches()["ntm_scan_fused_by_route"]
    proj = kernel_launches()["token_projection"]
    if dev.type == "cuda" and per_frame != list(range(1, 2 + n_track)):
        raise AssertionError(f"kernel launches per frame {per_frame}: expected one per frame")
    if dev.type == "cuda" and (routes != {"cluster": 1 + n_track, "tile": 0} or proj != 1 + n_track):
        raise AssertionError(f"the frame path ran B1's routes {routes} and {proj} projections: expected "
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
    if off_err > F32_TOL:
        raise AssertionError(f"fused frame step disagrees with the plain loop: {off_err:.3e}")
    return {"trk": trk, "plain_cfg": plain_cfg, "crop": crop, "cropboxes": cropboxes, "per_frame": per_frame,
            "launches": b1_launches, "routes": routes, "proj": proj, "offsets": offsets, "regions": regions,
            "off_err": off_err}


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


def route_times(dev: torch.device, smi: str, IN: int, batches=(1, 64), T: int = 65) -> dict:
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

    before = kernel_launches()["fused_ntm_addressing"]
    gk = grads(fused_ntm_addressing)
    through_kernel = kernel_launches()["fused_ntm_addressing"] - before
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
    zero_launches(*kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slots = [fleet.add(video[0], r) for r in regions]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    outs = [fleet.step({s: video[t] for s in slots}) for t in range(1, 1 + FLEET_STEPS)]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    fleet_counts = {k.__name__: kernel_launches()[k.__name__] for k in kernels}
    fleet_counts["token_projection"] = kernel_launches()["token_projection"]
    fleet_routes = kernel_launches()["ntm_scan_fused_by_route"]
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
    zero_launches(*kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = init_fn(frames[0], bbox, state)
    loop_regions = []
    for t in range(1, 1 + FLEET_STEPS):
        region, bbox, state = step_fn(frames[t], bbox, state)
        loop_regions.append(region)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    loop_counts = {k.__name__: kernel_launches()[k.__name__] for k in kernels}
    loop_counts["token_projection"] = kernel_launches()["token_projection"]
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
            for name, f in (("B3", fleets["B3"]),):  # the fleet main path's route
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
    for cap in (FLEET_CAP,):
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


def train_reference(dev: torch.device) -> dict:
    """The training slice's inputs and its plain references, in plain
    PyTorch (no kernel of the port), so that main runs them while nvcc
    builds: the config, params, optimizer state, the device batch (cached
    tokens, B=256 rows of L=20 frames, drawn on the card: the host draws
    only the labels) and the plain autograd train step from those params on
    that batch (loss, logits, gradients, params and optimizer state after,
    its times and peak memory)."""
    from ntm_tracker_tpu_torch.config import TrackerConfig, TrainConfig
    from ntm_tracker_tpu_torch.train.experiments import OffsetExperiment, device_cached_batch
    from ntm_tracker_tpu_torch.train.optim import tree_map

    base = TrackerConfig(train=TrainConfig(batch_size=TRAIN_B, sequence_length=TRAIN_L))
    exp = OffsetExperiment(base, None, device=dev)  # fused_bptt="auto": the kernels on cuda at f32
    params, opt_state = exp.init(torch.Generator().manual_seed(1))
    t0 = time.perf_counter()
    # synthetic_cached_batch's layout and range, without its host draws (it
    # first draws and drops an image batch's worth of numbers, 770M at this
    # shape, to keep the JAX package's order)
    batch = device_cached_batch(base, 0, dev)
    batch_s = time.perf_counter() - t0
    expp = OffsetExperiment(dataclasses.replace(base, train=dataclasses.replace(base.train, fused_bptt=False)),
                            None, device=dev)
    # torch.utils.checkpoint (remat) imports torch._dynamo at its first call,
    # 8-13 s on the card's machines: first, so that the step's times are its own
    importlib.import_module("torch._dynamo")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, logits, grads, fwd_ms, bwd_ms = offsets_grads(expp, params, batch)
    it = iter(grads)
    q, s = exp.optimizer().update(tree_map(lambda _: next(it), params), opt_state, params)
    torch.cuda.synchronize()
    plain = {"loss": loss, "logits": logits, "grads": grads, "params": q, "opt_state": s, "fwd_ms": fwd_ms,
             "bwd_ms": bwd_ms, "step_ms": 1e3 * (time.perf_counter() - t0),
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    return {"base": base, "exp": exp, "params": params, "opt_state": opt_state, "batch": batch, "batch_s": batch_s,
            "plain": plain}


def phase_train(dev: torch.device, smi: str, IN: int, ref: dict) -> dict:
    """The training slice at full width: OffsetExperiment on cached tokens,
    B=256 rows of L=20 frames (T=1300), through the fused BPTT kernels;
    the main path's first step held against the plain autograd step from
    the same params at the same shape (`ref`'s: train_reference), and
    again at B=8, where both are held against the plain loop in float64;
    then the kernels' own times."""
    from ntm_tracker_tpu_torch.models.ntm_cell import init_ntm_state
    from ntm_tracker_tpu_torch.ops.kernels import scan_bptt
    from ntm_tracker_tpu_torch.ops.kernels.scan_cell import ntm_scan_fused, route_for, run_route
    from ntm_tracker_tpu_torch.train.experiments import OffsetExperiment, synthetic_cached_batch
    from ntm_tracker_tpu_torch.train.optim import tree_leaves, tree_map
    from ntm_tracker_tpu_torch.train.serialize import serialize_tokens

    base, exp, batch, plain = ref["base"], ref["exp"], ref["batch"], ref["plain"]
    params, opt_state = ref["params"], ref["opt_state"]
    ncfg, L = base.ntm, base.ntm.controller_num_layers
    log("train", f"synthetic cached batch B={TRAIN_B} L={TRAIN_L} (float16 tokens {tuple(batch['features'].shape)}) "
                 f"made on the card in {ref['batch_s']:.1f}s (while the kernels built)")
    train_step, eval_step = exp.make_train_step(), exp.make_eval_step()
    kernels = (ntm_scan_fused, scan_bptt.bptt_forward, scan_bptt.token_projection, scan_bptt.bptt_backward,
               scan_bptt.grad_reduce)

    # ---- the main path: 1 train step, 1 eval step ---------------------------------
    # (the step is timed in the bench phase: benchmarks.main's cached train
    # step at the same shape)
    reset_counts()
    zero_launches(*kernels)
    torch.cuda.reset_peak_memory_stats()
    p1, s1, m = train_step(params, opt_state, batch)
    losses = [float(m["loss"])]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aux = eval_step(p1, batch)
    eval_loss = float(aux["loss"])
    eval_ms = 1e3 * (time.perf_counter() - t0)
    counts = {k.__name__: kernel_launches()[k.__name__] for k in kernels}
    eval_routes = kernel_launches()["ntm_scan_fused_by_route"]
    expected = {"ntm_scan_fused": 1, "bptt_forward": 1, "token_projection": 2, "bptt_backward": 1,
                "grad_reduce": L + 1}
    log("train", f"main path launches {counts} (expected {expected}: a projection per train step and one for the "
                 f"eval step's B1; each grad_reduce call is two kernels, the partial sums and their fixed-order sum; "
                 f"one call per LSTM layer and one for the head and output linears together); B1 by route "
                 f"{eval_routes}")
    if counts != expected or eval_routes != {"cluster": 0, "tile": 1}:
        raise AssertionError("the training path did not run through the kernels as expected")
    # an update far below a parameter's ulp leaves it as it was (init_w's
    # gradient is small), so the check is on the parameters as a whole
    changed = {k: int((a != b).sum()) for k, a, b in zip(named_leaves(p1), tree_leaves(params), tree_leaves(p1))}
    if not (np.isfinite(losses).all() and np.isfinite(eval_loss) and changed["controller[0].kernel"] > 0):
        raise AssertionError(f"bad training run: losses {losses}, eval {eval_loss}, elements changed {changed}")
    log("train", f"elements changed by the step, per parameter: {changed}")
    log("train", f"fused train step B={TRAIN_B} T={base.total_steps}: loss {losses[0]:.6f}; peak {peak_gb:.2f} GB; "
                 f"eval step (B1, no residuals) {eval_ms:.3f} ms, loss {eval_loss:.6f}")
    check_budget("train")

    # ---- the main path's first step against the plain autograd step at B=256 ------
    floss, flogits, fgrads, _, _ = offsets_grads(exp, params, batch)
    ploss, plogits, pgrads, qp, sp = (plain[k] for k in ("loss", "logits", "grads", "params", "opt_state"))
    plain_step, plain_fwd, plain_bwd = plain["step_ms"], plain["fwd_ms"], plain["bwd_ms"]
    log("train", f"{smi}: plain autograd train step B={TRAIN_B} T={base.total_steps} (remat full: each step checkpointed; "
                 f"while the kernels built, the compilers niced) {plain_step:.1f} ms = "
                 f"{TRAIN_B * TRAIN_L / plain_step * 1e3:.1f} frames/s (forward {plain_fwd:.1f} ms, backward "
                 f"{plain_bwd:.1f} ms, CUDA events); peak {plain['peak_gb']:.2f} GB; loss {ploss:.6f}")
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
    del fgrads, pgrads, qp, sp
    ref.pop("plain")
    check_budget("train")

    # ---- one fused step against one plain autograd step at B=8 --------------------
    # at L=B8_L frames (T=130), a tenth of the main path's depth: the plain
    # step's eager loop costs ~14 s a pass at T=1300, and the B=256 step
    # above is held at the full depth
    cfg8 = dataclasses.replace(base, train=dataclasses.replace(base.train, batch_size=8, sequence_length=B8_L,
                                                               fused_bptt=True))
    cfg8p = dataclasses.replace(cfg8, train=dataclasses.replace(cfg8.train, fused_bptt=False))
    batch8 = exp.device_batch(synthetic_cached_batch(cfg8, np.random.RandomState(1)))
    runs, ms8, exps = {}, {}, {}
    for tag, c in (("fused", cfg8), ("plain", cfg8p)):
        e = exps[tag] = OffsetExperiment(c, None, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q, s8, mm = e.make_train_step()(params, opt_state, batch8)
        ms8[tag] = 1e3 * (time.perf_counter() - t0)
        runs[tag] = (float(mm["loss"]), offsets_grads(e, params, batch8)[2], q, s8)
    report_step(f"B=8 T={cfg8.total_steps} one step fused vs plain autograd (remat full), "
                f"step {ms8['fused']:.1f} ms fused vs {ms8['plain']:.1f} ms plain (host clock)",
                step_errors(params, runs["fused"], runs["plain"]))
    # both float32 routes against the plain loop in float64, here at B=8
    # (at the main path's shape it cost 23-65 s of host dispatch): which of
    # them carries the gap between them
    t0 = time.perf_counter()
    g64 = offsets_grads(exps["plain"], params, batch8, torch.float64)[2]
    names = list(named_leaves(params))
    vs64 = {tag: grad_errors(dict(zip(names, runs[tag][1])), dict(zip(names, g64))) for tag in ("fused", "plain")}
    log("train", f"B=8 T={cfg8.total_steps} gradients vs the plain loop in float64 ({time.perf_counter() - t0:.1f}s), "
                 f"max rel per parameter, fused / plain float32: "
                 + ", ".join(f"{k} {vs64['fused'][k]:.2e} / {vs64['plain'][k]:.2e}" for k in names))
    worst64 = max(vs64["fused"].values())
    if worst64 > GRAD_TOL:
        raise AssertionError(f"the fused gradients are {worst64:.2e} from the float64 ones (tol {GRAD_TOL:g})")
    f64_err = {"fused": worst64, "plain": max(vs64["plain"].values()), "B": 8, "T": cfg8.total_steps}
    del runs, g64
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
        # timed at the route's tile only (the other tiles' times were cut
        # for room; their last numbers are in PERF.md)
        fwd_ms_by = {r: cuda_ms(lambda r=r: scan_bptt.bptt_forward(params, ncfg, tokens, state, proj, rows_per_block=r),
                                iters=2, warmup=1) for r in (fwd_rows,)}
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
        # tile, no dtokens), and with dtokens (one row per block was cut
        # from the timings for room; its last numbers are in PERF.md)
        rows = scan_bptt.backward_tile(ncfg, IN, B, dev)
        variants = {f"rows {rows}, no dtokens (the route)": (rows, False), f"rows {rows}, dtokens": (rows, True)}
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
        "counts": counts, "eval_ms": eval_ms, "plain_step_ms": plain_step, "peak_gb": peak_gb,
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


def plain_initial_state_grads(params, ncfg, tokens, state, dlogits, dfinal) -> tuple:
    """The plain loop's initial-state gradients in float64 and in float32
    on the CPU (state as scan_bptt.flatten_state lists its tensors), and
    the seconds they took: initial_state_referee's references."""
    from ntm_tracker_tpu_torch.ops.kernels import scan_bptt
    from ntm_tracker_tpu_torch.ops.kernels.scan_cell import ntm_scan_fused_reference
    from ntm_tracker_tpu_torch.train.optim import tree_map

    L = ncfg.controller_num_layers
    t0 = time.perf_counter()

    def plain(dtype):
        with torch.enable_grad():
            p = tree_map(lambda t: t.detach().to(dtype), params)
            leaves = [t.detach().to(dtype).requires_grad_() for t in state]
            st = {"M": leaves[0], "w": leaves[1], "read": leaves[2],
                  "controller_state": list(zip(leaves[3:3 + L], leaves[3 + L:3 + 2 * L]))}
            logits, final = ntm_scan_fused_reference(p, ncfg, tokens.to(dtype), st)
            loss = (logits * dlogits.to(dtype)).sum() + sum(
                (a * b.to(dtype)).sum() for a, b in zip(scan_bptt.flatten_state(final), dfinal))
            return torch.autograd.grad(loss, leaves)

    return plain(torch.float64), plain(torch.float32), time.perf_counter() - t0


def initial_state_referee(params, ncfg, tokens, state, dlogits, dfinal, grad_names, b2, b4, pool=None,
                          rows: int = 4):
    """Which of B2 and B4 carries their gap on the initial-state
    gradients: both kernels' gradients (b2, b4, in grad_names order, on the
    same params, tokens, state and cotangents) and the plain loop's in
    float32 against the plain loop in float64, on the `rows` batch rows
    where the kernels differ most on c0. A row's initial-state gradient
    depends on that row alone, so the plain loops run those rows only, on
    the CPU, in `pool` (plain_initial_state_grads). Returns a function
    that waits for them and returns, per initial-state tensor, max |x -
    float64| / max |float64| over those rows for each of B2, B4 and the
    plain float32 loop, and the rows."""
    from ntm_tracker_tpu_torch.ops.kernels import scan_bptt
    from ntm_tracker_tpu_torch.train.optim import tree_map

    L = ncfg.controller_num_layers
    names = ["M0", "w0", "read0", *[f"c0[{l}]" for l in range(L)], *[f"h0[{l}]" for l in range(L)]]
    at = [grad_names.index(n) for n in names]
    c0 = grad_names.index("c0[0]")
    gap = (b4[c0].double() - b2[c0].double()).abs().reshape(b4[c0].shape[0], -1).amax(1)
    pick = torch.topk(gap, rows).indices.sort().values
    cpu = functools.partial(tree_map, lambda t: t.detach().cpu())
    job = offload(pool, plain_initial_state_grads, cpu(params), ncfg, tokens[pick].cpu(),
                  [t[pick].cpu() for t in scan_bptt.flatten_state(state)], dlogits[pick].cpu(),
                  [t[pick].cpu() for t in scan_bptt.flatten_state(dfinal)])
    b2_rows, b4_rows = [b2[i][pick].cpu() for i in at], [b4[i][pick].cpu() for i in at]

    def finish() -> dict:
        g64, g32, secs = job.result()
        out = {}
        for name, g, h, k2, k4 in zip(names, g64, g32, b2_rows, b4_rows):
            scale = max(float(g.abs().max()), 1e-30)
            out[name] = {"b2": max_abs(k2, g) / scale, "b4": max_abs(k4, g) / scale,
                         "plain_f32": max_abs(h, g) / scale}
        log("packed", f"initial-state gradients at B={tokens.shape[0]} T={tokens.shape[1]} on rows {pick.tolist()} "
                      f"(the {rows} where B4 and B2 differ most on c0; the plain loops on the CPU beside the later "
                      f"phases, {secs:.1f}s) against the plain loop in float64, max rel B2 / B4 / the plain loop in "
                      f"float32: " + ", ".join(f"{k} {v['b2']:.2e} / {v['b4']:.2e} / {v['plain_f32']:.2e}"
                                               for k, v in out.items()))
        return {"rows": pick.tolist(), "max_rel": out}

    return finish


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


def phase_orbax(dev: torch.device, smi: str) -> dict:
    """The JAX package's orbax checkpoints, read by the port alone (no JAX,
    orbax or tensorstore on this machine): (a) the full-width fixture at
    ORBAX_DIR, every leaf's sha256 against its record, the read's ms and
    MB/s (host work, the files warm in the page cache); (b) restored into
    OffsetExperiment(TrackerConfig())'s template on `dev`, one train step
    through B2 on the record's batch: the loss and the pre-clip gradient
    norm against the JAX package's (ORBAX_LOSS_RTOL, ORBAX_GNORM_RTOL) and
    the step against the plain route on the card (report_step); (c)
    StreamingTracker from the restored params on B1's cluster route against
    the plain loop (frame_path)."""
    import hashlib

    from ntm_tracker_tpu_torch.config import TrackerConfig
    from ntm_tracker_tpu_torch.models.vgg import init_vgg_params
    from ntm_tracker_tpu_torch.train.experiments import OffsetExperiment, gradient_step
    from ntm_tracker_tpu_torch.train.harness import CheckpointManager
    from ntm_tracker_tpu_torch.train.optim import global_norm, tree_leaves
    from ntm_tracker_tpu_torch.utils import zstd

    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(here, ORBAX_DIR)
    with open(path + ".json") as f:
        record = json.load(f)
    step_dir = os.path.join(path, str(record["step"]))

    def flat(tree, prefix=()):
        if isinstance(tree, dict):
            return {p: v for k in tree for p, v in flat(tree[k], prefix + (str(k),)).items()}
        if isinstance(tree, (list, tuple)):
            return {p: v for i, x in enumerate(tree) for p, v in flat(x, prefix + (str(i),)).items()}
        return {"/".join(prefix): tree}

    # ---- (a) every leaf against its record -------------------------------------
    read_s = []
    for _ in range(2):  # the first read also loads libzstd
        t0 = time.perf_counter()
        raw = CheckpointManager(path).restore(record["step"])
        read_s.append(time.perf_counter() - t0)
    leaves = flat(raw)
    got = {p: None if v is None else hashlib.sha256(v.contiguous().numpy().tobytes()).hexdigest()
           for p, v in leaves.items()}
    want = {r["path"]: r["sha256"] for r in record["leaves"]}
    disk = sum(os.path.getsize(os.path.join(d, n)) for d, _, names in os.walk(step_dir) for n in names)
    tensor_b = sum(v.numel() * v.element_size() for v in leaves.values() if v is not None)
    same = got == want
    log("orbax", f"{ORBAX_DIR} step {record['step']} (written by {record['written_by']}) read by the port alone "
                 f"(libzstd {zstd.version()}): {len(got)} leaves, {tensor_b / 1e6:.3f} MB of tensors from "
                 f"{disk / 1e6:.3f} MB of files, warm, in {read_s[0] * 1e3:.1f} ms then {read_s[1] * 1e3:.1f} ms "
                 f"= {disk / 1e6 / read_s[1]:.1f} MB/s of files, {tensor_b / 1e6 / read_s[1]:.1f} MB/s of tensors "
                 f"(host); every sha256 equal to the record: {same}")
    if not same:
        raise AssertionError(f"the fixture's leaves differ from its record: "
                             f"{sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))}")
    check_budget("orbax_read")

    # ---- (b) one B2 step from the restored params and optimizer state ----------
    nb = record["next_batch"]
    base = TrackerConfig()
    cfg = dataclasses.replace(base, train=dataclasses.replace(base.train, batch_size=nb["batch_size"],
                                                              sequence_length=nb["sequence_length"]))
    exp = OffsetExperiment(cfg, None, device=dev)  # fused_bptt="auto": B2 on cuda at f32
    params, opt_state = exp.init(torch.Generator().manual_seed(0))
    restored = CheckpointManager(path).restore(record["step"], template={"params": params, "opt_state": opt_state})
    params, opt_state = restored["params"], restored["opt_state"]
    with np.load(os.path.join(os.path.dirname(path), nb["file"])) as z:
        batch = exp.device_batch({k: z[k] for k in z.files})
    reset_all_counts()
    q, s, m = gradient_step(exp.loss_fn, exp.optimizer(), keep_grads=True)(params, opt_state, batch)
    loss, gnorm = float(m["loss"]), float(global_norm(m["grads"]))
    counts = kernel_launches()
    expp = OffsetExperiment(dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, fused_bptt=False)), None,
                            device=dev)
    qp, sp, mp = gradient_step(expp.loss_fn, expp.optimizer(), keep_grads=True)(params, opt_state, batch)
    loss_rel = abs(loss - record["loss"]) / abs(record["loss"])
    gnorm_rel = abs(gnorm - record["grad_norm"]) / abs(record["grad_norm"])
    expected = {"ntm_scan_fused": 0, "bptt_forward": 1, "token_projection": 1, "bptt_backward": 1,
                "grad_reduce": cfg.ntm.controller_num_layers + 1}
    log("orbax", f"{smi}: restored into OffsetExperiment(TrackerConfig())'s template on {dev}, one train step at "
                 f"B={cfg.train.batch_size} T={cfg.total_steps} on the record's batch: loss {loss:.8f} / JAX's "
                 f"{record['loss']:.8f}, rel {loss_rel:.2e} (tol {ORBAX_LOSS_RTOL:g}); pre-clip gradient norm "
                 f"{gnorm:.6f} / JAX's {record['grad_norm']:.6f}, rel {gnorm_rel:.2e} (tol {ORBAX_GNORM_RTOL:g}); "
                 f"launches {counts} (expected {expected})")
    report_step(f"orbax: the resumed step, B2 vs the plain route on the card at B={cfg.train.batch_size}",
                step_errors(params, (loss, tree_leaves(m["grads"]), q, s),
                            (float(mp["loss"]), tree_leaves(mp["grads"]), qp, sp)))
    if loss_rel > ORBAX_LOSS_RTOL or gnorm_rel > ORBAX_GNORM_RTOL or not np.isfinite([loss, gnorm]).all():
        raise AssertionError(f"the resumed step is off the JAX package's: loss rel {loss_rel:.2e}, "
                             f"gradient norm rel {gnorm_rel:.2e}")
    if dev.type == "cuda" and {k: counts[k] for k in expected} != expected:
        raise AssertionError(f"the resumed step did not run through B2 as expected: {counts}")
    check_budget("orbax_step")

    # ---- (c) the streaming tracker from the restored params --------------------
    vgg = init_vgg_params(torch.Generator().manual_seed(0), dev)
    video, region0 = synthetic_video(seed=0, frames=1 + ORBAX_FRAMES)
    reset_all_counts()
    fp = frame_path(base, vgg, params, video, region0, dev)
    tracker_counts = kernel_launches()
    log("orbax", f"StreamingTracker B=1 from the restored params: init + {ORBAX_FRAMES} frames, launches "
                 f"{tracker_counts}; region[-1]={[round(float(v), 2) for v in fp['regions'][-1]]}; fused vs plain "
                 f"loop on the same crops: max_abs(offsets)={fp['off_err']:.3e} (tol {F32_TOL:g})")
    # frame_path holds B1's counts; the tracker trains nothing
    if dev.type == "cuda" and any(tracker_counts[k] for k in ("bptt_forward", "bptt_backward", "grad_reduce")):
        raise AssertionError(f"the tracker from the restored params launched a training kernel: {tracker_counts}")
    check_budget("orbax")
    return {"read_ms": [1e3 * t for t in read_s], "file_mb": disk / 1e6, "tensor_mb": tensor_b / 1e6,
            "loss_rel": loss_rel, "grad_norm_rel": gnorm_rel, "step_counts": counts, "tracker_counts": tracker_counts}


def phase_packed(dev: torch.device, smi: str, IN: int, train: dict, pool=None) -> dict:
    """The lane-packed kernels (B4) against their plain version and against
    the row kernels, the counterpart of tests/hw_check_pallas.py's
    check_packed: (a) phase_bptt's five cases and packed_wide_cases' three,
    forward and every gradient, at one row per block, the rule's tiles and
    the largest tiles that fit, the flagship cases also without token
    gradients; (b) the frame path's
    shape B=1, T=65 against B1; (c) the train path's shape B=256, T=1300 on
    phase_train's params and tokens against B2's kernels, the same bits on
    a rerun, the backward without dtokens the same bits as with them but
    for dtokens, both kernels' initial-state gradients against float64
    (the plain loops in `pool`: "referee" is the function that waits for
    them), and the times at the rule's tiles beside B2's and the bounds, and at
    T=PACKED_PLAIN_T beside the plain version's on the same inputs; (d) the shared-memory mirror against the kernel; the token
    projection's launches on B4's path. No main path launches B4 (checked:
    its counts are 0 on entry); the launches are this phase's own."""
    from ntm_tracker_tpu_torch.config import NTMConfig
    from ntm_tracker_tpu_torch.models.ntm_cell import init_ntm_state
    from ntm_tracker_tpu_torch.ops.kernels import scan_bptt, scan_packed
    from ntm_tracker_tpu_torch.ops.kernels.scan_cell import ntm_scan_fused
    from ntm_tracker_tpu_torch.train.optim import tree_map

    kernels = (scan_packed.packed_forward, scan_packed.packed_forward_residuals, scan_packed.packed_backward)
    entry = {k.__name__: counter(f"launches.{k.__name__}") for k in kernels}
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
        T = min(T, PACKED_CHECK_T)
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
                referee = initial_state_referee(params, ncfg, tokens, state, dlogits, dfinal, grad_names, ref, got,
                                                pool)
            del got, lo, fi
            check_budget("packed")
        # one row per block, the rule's tiles and the probe's (the other
        # tiles' times were cut for room; their last numbers are in
        # PERF.md), each kernel's launches back to back
        ms = {"forward": {}, "forward_residuals": {}, "backward": {}}
        for rows in sorted({1, rule[0], scan_packed.PROBE_ROWS}):
            ms["forward"][rows] = cuda_ms(lambda: scan_packed.packed_forward(params, ncfg, tokens, state, proj, rows),
                                          iters=2, warmup=1)
            ms["forward_residuals"][rows] = cuda_ms(lambda: scan_packed.packed_forward_residuals(
                params, ncfg, tokens, state, proj, rows), iters=2, warmup=0)
        _, _, res = scan_packed.packed_forward_residuals(params, ncfg, tokens, state, proj, rule[0])
        for brows in sorted({1, rule[1], scan_packed.PROBE_ROWS}):
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

    # the plain version: its runs at T=1,300 (2.6 s without gradients,
    # 11-13 s recording them) were cut for room (PERF.md keeps their
    # times), so the kernels and the plain version are timed against each
    # other on the first PACKED_PLAIN_T steps of the same params and tokens
    with torch.no_grad():
        Ts = PACKED_PLAIN_T
        tok_s, dlog_s = tokens[:, :Ts].contiguous(), dlogits[:, :Ts].contiguous()
        proj_s = scan_bptt.token_projection(tok_s, layer0["kernel"], layer0["bias"])
        plain_fwd = cuda_ms(lambda: scan_packed.ntm_scan_packed_reference(params, ncfg, tok_s, state), iters=1, warmup=0)
        short = {"forward": cuda_ms(lambda: scan_packed.packed_forward(params, ncfg, tok_s, state, proj_s, rule[0]),
                                    iters=2, warmup=1),
                 "forward_residuals": cuda_ms(lambda: scan_packed.packed_forward_residuals(
                     params, ncfg, tok_s, state, proj_s, rule[0]), iters=2, warmup=1)}
        _, _, res = scan_packed.packed_forward_residuals(params, ncfg, tok_s, state, proj_s, rule[0])
        short["backward"] = cuda_ms(lambda: scan_packed.packed_backward(
            params, ncfg, tok_s, proj_s, res, dlog_s, dfinal, False, rule[1]), iters=2, warmup=1)
        del res, proj_s
    live = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    lo, fi = scan_packed.ntm_scan_packed_reference(live, ncfg, tok_s, init_ntm_state(live, ncfg, B))
    loss = (lo * dlog_s).sum() + sum((a * b).sum() for a, b in zip(scan_bptt.flatten_state(fi),
                                                                   scan_bptt.flatten_state(dfinal)))
    ev[1].record()
    torch.autograd.grad(loss, [live["heads_w"], live["controller"][0]["kernel"]])
    ev[2].record()
    torch.cuda.synchronize()
    plain_short = {"forward": plain_fwd, "forward_residuals": ev[0].elapsed_time(ev[1]),
                   "backward": ev[1].elapsed_time(ev[2])}
    del lo, fi, loss, live, tok_s, dlog_s
    # B4's kernels read the projection (no token rows of W0); the backward
    # as timed writes no dtokens
    work = scan_bptt_work(ncfg, B, T, IN)
    bounds = {"forward": bound(*scan_bptt_work(ncfg, B, T, IN, residuals=False)["forward"]),
              "forward_residuals": bound(*work["forward"]), "backward": bound(*work["backward"]),
              "reduction": bound(*work["grad_reduce"])}
    work_s = scan_bptt_work(ncfg, B, Ts, IN)
    bounds_short = {"forward": bound(*scan_bptt_work(ncfg, B, Ts, IN, residuals=False)["forward"]),
                    "forward_residuals": bound(*work_s["forward"]), "backward": bound(*work_s["backward"])}
    log("times", f"{smi}: B={B} T={Ts} (phase train's params and tokens' first steps) plain packed version: forward "
                 f"{plain_fwd:.1f} ms without gradients; recording gradients forward {plain_short['forward_residuals']:.1f} "
                 f"ms, backward {plain_short['backward']:.1f} ms; the kernels at rows {rule[0]}/{rule[1]}: forward "
                 f"{short['forward']:.3f} ms, with residuals {short['forward_residuals']:.3f} ms, backward "
                 f"{short['backward']:.3f} ms (bounds "
                 + ", ".join(f"{k} {v[0]:.3f} ms by {v[1]}" for k, v in bounds_short.items()) + "); bounds at "
                 f"T={T} " + ", ".join(f"{k} {v[0]:.3f} ms by {v[1]}" for k, v in bounds.items())
                 + f"; B2: projection {train['token_projection'][0]:.3f} ms, forward {train['forward'][0]:.3f} ms, "
                 f"backward {train['backward'][0]:.3f} ms, reduction {train['grad_reduce'][0]:.3f} ms; B1 "
                 f"{train['b1']['ms']:.3f} ms (phase train)")

    # ---- (d) B4's path: the projection launched once per call -------------------------
    phase_counts = {k.__name__: counter(f"launches.{k.__name__}") for k in kernels}
    ncfg = NTMConfig()
    params, tokens, cot = scan_case(ncfg, 2, 65, 360, dev, IN)
    zero_launches(*kernels)
    proj0 = kernel_launches()["token_projection"]
    with torch.no_grad():
        scan_packed.ntm_scan_packed(params, ncfg, tokens, init_ntm_state(params, ncfg, 2))
    grads_of(scan_packed.ntm_scan_packed_bptt, params, ncfg, tokens, cot, lambda p: init_ntm_state(p, ncfg, 2), False)
    path = {"token_projection": kernel_launches()["token_projection"] - proj0,
            **{k.__name__: counter(f"launches.{k.__name__}") for k in kernels}}
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
            "short": {"T": Ts, "ms": short, "plain_ms": plain_short,
                                                       "bounds": bounds_short},
            "bounds": bounds, "smem": smem, "B": B, "T": T, "referee": referee}



def loss_fell(losses: list, window: int) -> tuple:
    """(mean of the first `window` losses, mean of the last `window`)."""
    return float(np.mean(losses[:window])), float(np.mean(losses[-window:]))


def reset_all_counts() -> None:
    from ntm_tracker_tpu_torch.ops.kernels import scan_bptt

    reset_counts()
    zero_launches(*(getattr(scan_bptt, name) for name in ("bptt_forward", "token_projection", "bptt_backward",
                                                          "grad_reduce")))


def dnc_loss_and_grads(exp, p, batch, features) -> tuple:
    """The DNC check's train-step loss and gradients (tree_leaves order) in
    float64 on `features` (the card's VGG tokens of the batch), through
    exp's device."""
    from ntm_tracker_tpu_torch.train.optim import tree_leaves, tree_map
    from ntm_tracker_tpu_torch.train.serialize import offsets_loss, serialize_tokens

    cfg = exp.cfg
    live = tree_map(lambda t: t.detach().double().requires_grad_(), p)
    b = exp.device_batch(batch)
    f = features.to(exp.device)
    B, L = f.shape[0], cfg.train.sequence_length
    tokens = serialize_tokens(f, b["gts"].double().reshape(B, L, -1)[:, 0])
    state = tree_map(lambda t: t.double(), exp.core.init_state(p, B))
    logits, _ = exp.core.unroll(live, tokens, state)
    loss = offsets_loss(logits, exp._targets(b, B).double(), cfg.num_features)
    return float(loss.detach()), torch.autograd.grad(loss, tree_leaves(live))


def dnc_check_inputs(dev: torch.device) -> dict:
    """The inputs of phase_accuracy's DNC check, made on the card: the
    demo DNC config at ACC_DNC_L frames a clip, the experiment on the demo
    VGG (seed 0), params and optimizer state (seed 2), a training batch
    (seed 1) and the card's VGG tokens of it in float64 (given to both
    sides: the DNC's gradient jumps at near-tied usages even in float64
    when the inputs differ, as the convs' float32 rounding on two devices
    makes them, ~1e-6)."""
    from ntm_tracker_tpu_torch.models.vgg import init_vgg_params
    from ntm_tracker_tpu_torch.tracking.demo import demo_config, training_batch
    from ntm_tracker_tpu_torch.train.experiments import OffsetExperiment

    dcfg = demo_config(core="dnc")
    dcfg = dataclasses.replace(dcfg, train=dataclasses.replace(dcfg.train, sequence_length=ACC_DNC_L))
    vgg = init_vgg_params(torch.Generator().manual_seed(0), dev)
    dexp = OffsetExperiment(dcfg, vgg, image_mode="cropped", device=dev)
    dparams, dopt = dexp.init(torch.Generator().manual_seed(2))
    dbatch = training_batch(dcfg, np.random.RandomState(1), dev)
    with torch.no_grad():
        features = dexp.batch_features(dexp.device_batch(dbatch)).double()
    return {"cfg": dcfg, "exp": dexp, "params": dparams, "opt_state": dopt, "batch": dbatch, "features": features}


def dnc_cpu_reference(dcfg, params, batch, features) -> tuple:
    """The DNC check's CPU side (CPU tensors in, run in the CPU pool): the
    train step's float32 loss on the CPU (its VGG on the batch's crops),
    the float64 loss and gradients on `features`, and the seconds taken."""
    from ntm_tracker_tpu_torch.models.vgg import init_vgg_params
    from ntm_tracker_tpu_torch.train.experiments import OffsetExperiment

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    cexp = OffsetExperiment(dcfg, init_vgg_params(torch.Generator().manual_seed(0), cpu), image_mode="cropped",
                            device=cpu)
    with torch.no_grad():
        loss = float(cexp.loss_fn(params, batch)[0])
    loss64, grads64 = dnc_loss_and_grads(cexp, params, batch, features)
    return loss, loss64, grads64, time.perf_counter() - t0


def start_dnc_check(dev: torch.device, pool) -> dict:
    """dnc_check_inputs, with the CPU side submitted to `pool` at once (a
    2-thread worker needs a few times the inline time, so it starts phases
    ahead of the check): the inputs and "cpu", its future."""
    from ntm_tracker_tpu_torch.train.optim import tree_map

    inputs = dnc_check_inputs(dev)
    batch = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in inputs["batch"].items()}
    inputs["cpu"] = offload(pool, dnc_cpu_reference, inputs["cfg"], tree_map(lambda t: t.cpu(), inputs["params"]),
                            batch, inputs["features"].cpu())
    return inputs


def phase_accuracy(dev: torch.device, smi: str, dnc: dict) -> dict:
    """The accuracy path on the card: (a) the demo config's NTM trains
    ACC_STEPS steps through B2 on synthetic clips, its loss must fall, then
    tracks a held-out clip through the streaming tracker (B1's cluster
    route) and the device loop, held to the artifact's tripwires; (b) the
    DNC's train step on the card against the same step on the CPU (`dnc`:
    start_dnc_check's), then a DNC StreamingTracker; (c) the flagship
    width: build_dataset, then ACC_FLAG_STEPS full-batch steps whose loss
    must fall."""
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
    train_counts = kernel_launches()
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
    host_counts = kernel_launches()
    reset_all_counts()
    device = eval_device_iou(cfg, vgg, params, 0, ACC_CLIP_FRAMES, device=dev)
    loop_counts = kernel_launches()
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
    dcfg, dexp, dparams, dopt, dbatch = (dnc[k] for k in ("cfg", "exp", "params", "opt_state", "batch"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d_new, _, d_m = dexp.make_train_step()(dparams, dopt, dbatch)
    d_loss = float(d_m["loss"])
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    d64_loss, d64_grads = dnc_loss_and_grads(dexp, dparams, dbatch, dnc["features"])
    card64_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    c_loss, c64_loss, c64_grads, cpu_s = dnc["cpu"].result()
    wait_s = time.perf_counter() - t0
    loss_rel = abs(d_loss - c_loss) / abs(c_loss)
    loss64_rel = abs(d64_loss - c64_loss) / abs(c64_loss)
    grad_rel = max(max_abs(g.cpu(), r) / max(float(r.abs().max()), 1e-30) for g, r in zip(d64_grads, c64_grads))
    log("accuracy", f"{smi}: demo DNC train step (B={dcfg.train.batch_size}, T={dcfg.total_steps}, memory "
                    f"{dcfg.dnc.memory_size}x{dcfg.dnc.word_size}, plain PyTorch) card vs CPU: float32 loss "
                    f"{d_loss:.6f} / {c_loss:.6f}, rel {loss_rel:.2e} (tol {DNC_LOSS_RTOL:g}); float64 on the same "
                    f"tokens: loss rel {loss64_rel:.2e}, gradients max rel {grad_rel:.2e} (tol {GRAD_TOL:g}); float32 against "
                    f"float64 loss rel {abs(d_loss - c64_loss) / abs(c64_loss):.2e}; the train step on the card "
                    f"{card_s:.2f}s, float64 loss and gradients on the card {card64_s:.2f}s; the CPU side in a CPU "
                    f"worker {cpu_s:.2f}s, started phases ahead, waited {wait_s:.2f}s here")
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
    dnc_counts = kernel_launches()
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
    flag_counts = kernel_launches()
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


def run_periods_ms(run: dict) -> tuple:
    """(median ms between consecutive train-step starts after the first,
    seconds waited on the prefetcher before step 0, the share of the run
    from step 0's start to the last step's that the loop waited on the
    prefetcher): a period holds the step, the loss read that logs it and
    the wait for the next batch; the first also holds the validation."""
    starts, waits = run["step_starts"], run["waits"]
    periods = np.diff(starts[1:]) * 1e3 if len(starts) > 2 else np.diff(starts) * 1e3
    window = starts[-1] - starts[0]
    return float(np.median(periods)), float(waits[0]), float(sum(waits[1:len(starts)]) / window)


def phase_data(dev: torch.device, smi: str, root: str = None, pool=None) -> dict:
    """The real-data training path through the port's CLI, at
    TrackerConfig()'s width, on a synthetic VID tree built here: (a)
    preprocess, also --augment; (b) cache-features: float16, base and flip,
    of every record; float32, base and flip, of the records that (d) and
    the token check read; 4 frames' tokens against the CPU's on the same
    crops; (c) train-offsets --feature_cache: step 0's loss against the
    CPU's from the same params and batch, B2 once a step, B1 once in the
    validation; (d) train-offsets on decoded frames, host and device
    resize: the step-0 batch's tokens against the float32 cache's, the two
    runs' step-0 losses against each other; (e) a resume from (c)'s
    checkpoint, its first validation against the CPU's from the restored
    params; (f) one step resumed from the JAX package's orbax directory
    (ORBAX_DIR), B2 once and B1 once, its loss finite. The CPU's losses of
    (c) and (e) run in `pool` beside (d)-(f). The tree is built under
    `root` and left there for the lab phase; root=None builds it in a
    temporary directory, removed after."""
    import os
    import shutil
    import tempfile

    from ntm_tracker_tpu_torch import cli
    from ntm_tracker_tpu_torch.data import loader
    from ntm_tracker_tpu_torch.data.feature_cache import load_token_batch, token_batch_iterator
    from ntm_tracker_tpu_torch.data.image_ops import preprocess_frame
    from ntm_tracker_tpu_torch.data.sequences import get_valid_sequences
    from ntm_tracker_tpu_torch.data.synthetic_vid import write_vid_tree
    from ntm_tracker_tpu_torch.models.vgg import init_vgg_params
    from ntm_tracker_tpu_torch.train.experiments import OffsetExperiment, frame_tokens
    from ntm_tracker_tpu_torch.train.harness import CheckpointManager

    d = str(dev)
    cpu = torch.device("cpu")
    L, B = TRAIN_L, DATA_B
    parser = cli.build_parser()
    out = {}
    own = root is None
    root = tempfile.mkdtemp(prefix="ntm_data_") if own else root
    cwd = os.getcwd()
    # relative paths inside the tree: the train/val split reads the path
    os.chdir(root)
    try:
        # ---- (a) the tree and preprocess ---------------------------------------
        t0 = time.perf_counter()
        write_vid_tree(".", seed=0, sequences=DATA_SEQS)
        tree_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cli.main(["--device", d, "preprocess", "--annotation_dir", "Annotations", "--image_dir", "Data",
                  "--output_dir", "cropped", "--num_workers", "1"])
        cli.main(["--device", d, "preprocess", "--annotation_dir", "Annotations", "--image_dir", "Data",
                  "--output_dir", "augmented", "--num_workers", "1", "--augment", "--max_sequence_length", str(L)])
        pre_s = time.perf_counter() - t0
        records = sum(n * objects for _, _, _, n, objects in DATA_SEQS)
        written = sum(len(files) for _, _, files in os.walk("cropped")) // 2
        _, train, val = get_valid_sequences("cropped", L)
        _, aug_train, _ = get_valid_sequences("augmented", L)
        log("data", f"synthetic VID tree {[(s[0], s[2], s[3], s[4]) for s in DATA_SEQS]} in "
                    f"{tree_s:.2f}s; preprocess (and --augment) {pre_s:.2f}s: {written} records of {records}, "
                    f"{len(train)} train / {len(val)} val sequences of {L} frames, {len(aug_train)} augmented")
        if written != records or len(train) < B or len(val) < B or not aug_train:
            raise AssertionError(f"preprocess kept {written} of {records} records, {len(train)} train and "
                                 f"{len(val)} val sequences (B={B}), {len(aug_train)} augmented")
        check_budget("data_preprocess")

        # ---- (b) cache-features ------------------------------------------------
        args = parser.parse_args(["train-offsets", "--sequences_dir", "cropped", "--sequence_length", str(L)])
        cfg, seed = cli._tracker_config(args, "ntm"), args.seed
        # 4 records' tokens (2 train, 2 val: the resize) and the raw route's
        # step-0 batch: the float32 cache holds only their sequences
        frames = [os.path.join(train[0][0], train[0][1][0]), os.path.join(train[-1][0], train[-1][1][-1]),
                  os.path.join(val[0][0], val[0][1][0]), os.path.join(val[-1][0], val[-1][1][-1])][:DATA_TOKEN_FRAMES]
        names = next(loader.epoch_batches(train[:DATA_RAW_LIMIT], DATA_RAW_B, True, seed, 1))
        os.mkdir("cropped_f32")
        for seq in sorted({os.path.dirname(f) for f in frames + list(names)}):
            os.symlink(os.path.abspath(seq), os.path.join("cropped_f32", os.path.basename(seq)))
        loader.reset_route_counts()
        builds = {}
        for store, seqs_dir in (("float16", "cropped"), ("float32", "cropped_f32")):
            args = parser.parse_args(["--device", d, "cache-features", "--sequences_dir", seqs_dir, "--cache_dir",
                                      f"cache_{store}", "--store_dtype", store, "--reverse_image",
                                      "--frames_per_batch", str(records)])
            t0 = time.perf_counter()
            mans = cli.cache_features(args)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            secs = time.perf_counter() - t0
            n = sum(m["num_frames"] for m in mans)
            builds[store] = {"s": secs, "frames": n, "frames_per_s": n / secs}
        decode = loader.decode_routes()
        from ntm_tracker_tpu_torch.data import native_jpeg

        try:
            native_jpeg._get_fn()
            native_note = "built"
        except RuntimeError as e:
            native_note = str(e).splitlines()[0][:160]

        fb = loader.load_frame_batch(frames, decode_resize_hw=tuple(cfg.data.resize_hw))
        vgg = init_vgg_params(torch.Generator().manual_seed(0), dev)
        vgg_cpu = init_vgg_params(torch.Generator().manual_seed(0), cpu)
        with torch.no_grad():
            crops = preprocess_frame(torch.as_tensor(fb.images, device=dev), torch.as_tensor(fb.cropboxes, device=dev),
                                     resize_hw=cfg.data.resize_hw, crop_size=cfg.data.crop_size, do_resize=False)
            card = frame_tokens(cfg, vgg, crops).cpu().numpy()
            plain = frame_tokens(cfg, vgg_cpu, crops.cpu()).numpy()
        cached32 = load_token_batch(frames, 8, "cache_float32").features
        cached16 = load_token_batch(frames, 8, "cache_float16").features.astype(np.float32)
        scale = float(np.abs(plain).max())
        tok_err = float(np.abs(cached32 - plain).max()) / scale
        card_err = float(np.abs(card - cached32).max()) / scale
        f16_err = float(np.abs(cached16 - cached32).max()) / scale
        ms_frame = {r: c["seconds"] / max(c["frames"], 1) * 1e3 for r, c in decode.items()}
        log("data", f"{smi}: cache-features (VGG on the card, TF32 off, frames_per_batch {records}, base + flip): "
                    f"float16, every record: {builds['float16']['frames']} frames in {builds['float16']['s']:.2f}s = "
                    f"{builds['float16']['frames_per_s']:.1f} frames/s; float32, the checked records' sequences: "
                    f"{builds['float32']['frames']} in {builds['float32']['s']:.2f}s = "
                    f"{builds['float32']['frames_per_s']:.1f} frames/s; decode + resize by route (unique frames a "
                    f"batch) {decode}, ms a frame { {r: round(v, 3) for r, v in ms_frame.items()} }; native jpeg "
                    f"pipeline: {native_note}; record reader {loader.record_routes()}")
        log("data", f"cached float32 tokens of {len(frames)} records against the CPU's VGG on the same crops: rel "
                    f"max_abs {tok_err:.2e} (tol {DATA_TOL:g}); the card's on these {len(frames)} crops alone "
                    f"{card_err:.2e} (cuDNN's algorithm differs with the batch); float16 cache vs float32 {f16_err:.2e}")
        if tok_err > DATA_TOL or card_err > DATA_TOL or f16_err > 1e-3 or not np.isfinite(plain).all():
            raise AssertionError(f"cached tokens disagree: vs CPU {tok_err:.2e}, vs the card's {card_err:.2e}, "
                                 f"float16 {f16_err:.2e}")
        out.update(builds=builds, decode=decode, decode_ms_frame=ms_frame, native_jpeg=native_note,
                   token_rel_err=tok_err, f16_rel_err=f16_err, record_routes=loader.record_routes())
        check_budget("data_cache")

        # ---- (c) train-offsets --feature_cache -----------------------------------
        common = ["--sequences_dir", "cropped", "--sequence_length", str(L), "--log_interval", "1",
                  "--validation_interval", "1000"]
        args = parser.parse_args(["--device", d, "train-offsets", *common, "--feature_cache", "cache_float16",
                                  "--batch_size", str(B), "--num_epochs", str(DATA_EPOCHS), "--log_dir", "log_cached"])
        reset_all_counts()
        run = cli.train_offsets(args)
        counts = kernel_launches()
        step_ms, wait0_s, wait_share = run_periods_ms(run)
        recs = [json.loads(line) for line in open(os.path.join(run["log_dir"], "metrics.jsonl"))]
        losses = [r["train_loss"] for r in recs if "train_loss" in r]
        val_losses = [r["val_loss"] for r in recs if "val_loss" in r]
        # step 0 on the CPU: the params of the step-0 checkpoint, the first batch
        ckpt_dir = os.path.join(run["log_dir"], "ckpt")
        ckpt = CheckpointManager(ckpt_dir)
        params0 = ckpt.restore(0, map_location=cpu)["params"]
        tb = next(token_batch_iterator(train, B, "cache_float16", 8, shuffle=True, seed=seed, epochs=1))
        batch = {k: getattr(tb, k) for k in ("features", "gts", "y_offsets", "x_offsets")}
        cpu_step0 = offload(pool, cpu_offsets_loss, cfg, params0, batch)
        evals = len(val_losses)
        log("data", f"{smi}: train-offsets --feature_cache B={B} L={L}: {run['steps']} steps, step {step_ms:.2f} ms "
                    f"(median, the loss read every step); waiting on the prefetcher {wait0_s * 1e3:.2f} ms before step "
                    f"0, then {wait_share:.2%} of the run from step 0's start to the last step's; loss "
                    f"{losses[0]:.4f} -> {losses[-1]:.4f}, val {val_losses}; launches {counts}")
        steps = run["steps"]
        if not np.isfinite(losses + val_losses).all() or steps != DATA_EPOCHS * (len(train) // B):
            raise AssertionError(f"the cached run: losses {losses}, {steps} steps")
        if dev.type == "cuda" and not (
                counts["bptt_forward"] == counts["bptt_backward"] == steps and counts["grad_reduce"] == 2 * steps
                and counts["token_projection"] == steps + evals and counts["ntm_scan_fused"] == evals == 1):
            raise AssertionError(f"the cached run did not launch B2 once a step and B1 once a validation: {counts}")
        out["cached"] = {"steps": steps, "step_ms": step_ms, "wait0_ms": wait0_s * 1e3, "wait_share": wait_share,
                         "losses": losses, "counts": counts}
        check_budget("data_cached")

        # ---- (d) train-offsets on decoded frames, host and device resize ---------
        fb = loader.load_frame_batch(names, decode_resize_hw=tuple(cfg.data.resize_hw))
        exp = OffsetExperiment(cfg, vgg, image_mode="resized", device=dev)
        with torch.no_grad():
            toks = exp.batch_features(exp.device_batch({"images": fb.images, "cropboxes": fb.cropboxes}))
        cached = load_token_batch(names, 8, "cache_float32").features
        raw_err = float(np.abs(toks.reshape(cached.shape).cpu().numpy() - cached).max()) / float(np.abs(cached).max())
        raw = {}
        epochs = DATA_RAW_STEPS // (DATA_RAW_LIMIT // DATA_RAW_B)
        for name, extra in (("host_resize", []), ("device_resize", ["--device_resize"])):
            args = parser.parse_args(["--device", d, "train-offsets", *common, "--batch_size", str(DATA_RAW_B),
                                      "--limit", str(DATA_RAW_LIMIT), "--num_epochs", str(epochs),
                                      "--log_dir", f"log_{name}", *extra])
            loader.reset_route_counts()
            reset_all_counts()
            run = cli.train_offsets(args)
            counts = kernel_launches()
            step_ms, wait0_s, wait_share = run_periods_ms(run)
            recs = [json.loads(line) for line in open(os.path.join(run["log_dir"], "metrics.jsonl"))]
            rl = [r["train_loss"] for r in recs if "train_loss" in r]
            raw[name] = {"steps": run["steps"], "step_ms": step_ms, "wait0_ms": wait0_s * 1e3, "wait_share": wait_share,
                         "losses": rl, "counts": counts,
                         "decode": loader.decode_routes()}
            log("data", f"{smi}: train-offsets on decoded frames ({name}) B={DATA_RAW_B} L={L}: {run['steps']} steps, "
                        f"step {step_ms:.2f} ms (median; VGG on the card every step); waiting on the prefetcher "
                        f"{wait0_s * 1e3:.2f} ms before step 0, then {wait_share:.2%} of the run from step 0's start "
                        f"to the last step's; losses {[round(v, 4) for v in rl]}; decode {raw[name]['decode']}; "
                        f"launches {counts}")
            if (run["steps"] != DATA_RAW_STEPS or not np.isfinite(rl).all()
                    or (dev.type == "cuda" and counts["bptt_forward"] != DATA_RAW_STEPS)):
                raise AssertionError(f"the raw-frame run ({name}) took {run['steps']} steps: {counts}")
        resize_rel = abs(raw["device_resize"]["losses"][0] - raw["host_resize"]["losses"][0]) / abs(
            raw["host_resize"]["losses"][0])
        log("data", f"the raw route's step-0 batch: VGG tokens on the card against the float32 cache's for the "
                    f"same {len(names)} records: rel max_abs {raw_err:.2e} (tol {DATA_TOL:g}); step 0's loss with "
                    f"the device resize against the host resize's: rel {resize_rel:.2e} (tol {DATA_TOL:g})")
        if raw_err > DATA_TOL or resize_rel > DATA_TOL:
            raise AssertionError(f"the raw route disagrees: tokens against the cache's {raw_err:.2e}, step 0's loss "
                                 f"device against host resize {resize_rel:.2e}")
        out["raw"] = raw
        out["raw_token_rel_err"] = raw_err
        out["raw_resize_loss_rel"] = resize_rel
        check_budget("data_raw")

        # ---- (e) resume from (c)'s checkpoint ------------------------------------
        args = parser.parse_args(["--device", d, "train-offsets", *common, "--validation_interval", "1",
                                  "--feature_cache", "cache_float16", "--batch_size", str(B), "--num_epochs", "1",
                                  "--ckpt_path", ckpt_dir, "--log_dir", "log_resumed"])
        last = ckpt.restore(ckpt.latest_step(), map_location=cpu)["params"]
        reset_all_counts()
        resumed = cli.train_offsets(args)
        counts = kernel_launches()
        recs = [json.loads(line) for line in open(os.path.join(resumed["log_dir"], "metrics.jsonl"))]
        val0 = next(r["val_loss"] for r in recs if "val_loss" in r)
        vb = next(token_batch_iterator(val, B, "cache_float16", 8, shuffle=True, seed=seed, epochs=1))
        vbatch = {k: getattr(vb, k) for k in ("features", "gts", "y_offsets", "x_offsets")}
        cpu_val = offload(pool, cpu_offsets_loss, cfg, last, vbatch)
        with torch.no_grad():
            card_val = float(exp.make_eval_step()(ckpt.restore(ckpt.latest_step())["params"], vbatch)["loss"])
        log("data", f"{smi}: resumed from step {ckpt.latest_step()}'s checkpoint: {resumed['steps']} more step(s); "
                    f"its first validation {val0:.6f}, the card's eval step's from the restored params on the same "
                    f"batch {card_val:.6f}; launches {counts}")
        if resumed["steps"] != len(train) // B or abs(val0 - card_val) > 1e-6 * abs(card_val):
            raise AssertionError(f"the resumed run: {resumed['steps']} steps, validation {val0} vs the card's eval "
                                 f"step's {card_val}")
        out["resumed"] = {"steps": resumed["steps"], "counts": counts}
        check_budget("data_resume")

        # ---- (f) resume from the JAX package's full-width orbax checkpoint ------
        jax_ckpt = os.path.join(os.path.dirname(os.path.abspath(__file__)), ORBAX_DIR)
        args = parser.parse_args(["--device", d, "train-offsets", *common, "--feature_cache", "cache_float16",
                                  "--batch_size", str(B), "--num_epochs", "1", "--limit", str(B),
                                  "--ckpt_path", jax_ckpt, "--log_dir", "log_orbax"])
        reset_all_counts()
        run = cli.train_offsets(args)
        counts = kernel_launches()
        recs = [json.loads(line) for line in open(os.path.join(run["log_dir"], "metrics.jsonl"))]
        jl = [r["train_loss"] for r in recs if "train_loss" in r]
        jv = [r["val_loss"] for r in recs if "val_loss" in r]
        log("data", f"{smi}: train-offsets --ckpt_path {ORBAX_DIR} (the JAX package's orbax directory) B={B} L={L}: "
                    f"{run['steps']} step(s), losses {jl}, val {jv}; launches {counts}")
        if run["steps"] != 1 or not np.isfinite(jl + jv).all() or len(jl) != 1:
            raise AssertionError(f"the run resumed from the orbax directory: {run['steps']} steps, losses {jl}")
        if dev.type == "cuda" and not (
                counts["bptt_forward"] == counts["bptt_backward"] == 1 and counts["grad_reduce"] == 2
                and counts["ntm_scan_fused"] == len(jv) == 1 and counts["token_projection"] == 2):
            raise AssertionError(f"the run resumed from the orbax directory did not launch B2 once and B1 once: "
                                 f"{counts}")
        out["orbax_resume"] = {"steps": run["steps"], "losses": jl, "counts": counts}

        # ---- the CPU's references of (c) and (e), computed beside (d)-(f) -------
        (cpu_loss, cpu_s), (ref_val, val_s) = cpu_step0.result(), cpu_val.result()
        loss_rel = abs(out["cached"]["losses"][0] - cpu_loss) / abs(cpu_loss)
        val_rel = abs(val0 - ref_val) / abs(ref_val)
        log("data", f"the CPU from the same params and batch (its plain loop in a worker, {cpu_s:.1f}s and "
                    f"{val_s:.1f}s): (c)'s step 0 {out['cached']['losses'][0]:.6f} / {cpu_loss:.6f}, rel "
                    f"{loss_rel:.2e}; (e)'s first validation {val0:.6f} / {ref_val:.6f}, rel {val_rel:.2e} "
                    f"(tol {DATA_TOL:g} each)")
        if loss_rel > DATA_TOL or val_rel > DATA_TOL:
            raise AssertionError(f"the card's losses disagree with the CPU's: (c) step 0 rel {loss_rel:.2e}, (e) "
                                 f"validation rel {val_rel:.2e}")
        out["cached"]["loss_rel_cpu"], out["resumed"]["val_rel_cpu"] = loss_rel, val_rel
        check_budget("data")
    finally:
        os.chdir(cwd)
        if own:
            shutil.rmtree(root, ignore_errors=True)
    return out


def lab_vid_tree(root: str) -> None:
    """LAB_SEQS train sequences of LAB_FRAMES frames, LAB_SIDE square, one
    object each: pool5's prior cell at row and column 3 of 7, drifting half
    a pixel a frame (its IoU with that cell stays above mine-sequences'
    0.5, so every frame is kept)."""
    from ntm_tracker_tpu_torch.data.synthetic_vid import write_vid_sequence

    rng = np.random.RandomState(5)
    cell = LAB_SIDE // 7
    for k in range(LAB_SEQS):
        tracks = np.array([[[3 * cell, 3 * cell + t // 2, 4 * cell, 4 * cell + t // 2]] for t in range(LAB_FRAMES)])
        write_vid_sequence(root, f"ILSVRC2015_train_{k:08d}", "train", (LAB_SIDE, LAB_SIDE), tracks, rng)


def lab_grads(exp, params, batch) -> tuple:
    """(loss, {path: grad}, ms) of exp.loss_fn's gradient wrt every param
    (interop.py's paths; zeros where the loss does not reach), host clock
    around it, ending in a sync."""
    from ntm_tracker_tpu_torch.interop import flatten_params
    from ntm_tracker_tpu_torch.train.optim import tree_leaves, tree_map

    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _ = exp.loss_fn(live, batch)
    grads = torch.autograd.grad(loss, tree_leaves(live), allow_unused=True)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    fill = iter([torch.zeros_like(p) if g is None else g for p, g in zip(tree_leaves(live), grads)])
    return float(loss.detach()), flatten_params(tree_map(lambda _: next(fill), live)), ms


def lab_first_step(tag: str, exp, plain_exp, params, batch, zero=()) -> dict:
    """The first step's loss and gradients through exp (fused_bptt "auto":
    B2 on the card) against plain_exp (fused_bptt False: the plain loop on
    the card), from the same params and batch; `zero` names gradients that
    vanish in exact arithmetic (LAB_ZERO_TOL)."""
    reset_all_counts()
    loss, g, ms = lab_grads(exp, params, batch)
    counts = kernel_launches()
    ploss, pg, pms = lab_grads(plain_exp, params, batch)
    largest = max(float(np.abs(v).max()) for v in pg.values())
    rel = {k: float(np.abs(g[k] - v).max()) / max(float(np.abs(v).max()), 1e-30) for k, v in pg.items() if k not in zero}
    worst = max(rel, key=rel.get)
    zero_err = max([float(max(np.abs(g[k]).max(), np.abs(pg[k]).max())) / largest for k in zero] or [0.0])
    loss_rel = abs(loss - ploss) / abs(ploss)
    log("lab", f"{tag} first step at L={LAB_CHECK_L}, B2 against the plain loop on the card from the same params and "
               f"batch: loss {loss:.6f} / {ploss:.6f} rel {loss_rel:.2e} (tol {F32_TOL:g}); gradients max rel "
               f"{rel[worst]:.2e} at {worst} (tol {GRAD_TOL:g} of each one's largest)"
               + (f", {list(zero)} (zero in exact arithmetic) {zero_err:.2e} of the largest (tol {LAB_ZERO_TOL:g})"
                  if zero else "") + f"; loss + gradients {ms:.1f} ms fused, {pms:.1f} ms plain; launches {counts}")
    if loss_rel > F32_TOL or rel[worst] > GRAD_TOL or zero_err > LAB_ZERO_TOL or (
            exp.device.type == "cuda" and counts["bptt_forward"] < 1):
        raise AssertionError(f"{tag}: the first step through B2 disagrees with the plain route or ran no B2")
    return {"loss_rel": loss_rel, "grad_rel": rel[worst], "grad_worst": worst, "zero_rel": zero_err,
            "ms": ms, "plain_ms": pms, "counts": counts}


def phase_lab(dev: torch.device, smi: str, root: str) -> dict:
    """The experiment lab through the port's CLI on the card, in the data
    phase's tree (`root`, its float16 token cache): (a) train-heatmap
    --serialization sequential, (b) --serialization frame --compress_dim 128
    (B2 computes the tokens' gradient), (c) train-wholeframe at pool5, plain
    and --two_step, on a pickle mine-sequences makes from the phase's VID
    tree, (d) train-active-resize there (B2 once a frame, the state and its
    cotangents chained), (e) train-offsets --save_imgs (one validation's
    views through B1 in chunks; its loss against the eval step's), (f)
    dnc-repeat-copy (step 0's loss against the CPU's), (g)
    legacy_ntm_unroll_batched against the CPU's. (a)-(d): the first step
    against the plain route on the card at LAB_CHECK_L, then the path at full
    depth for its step ms and launches."""
    import os

    from ntm_tracker_tpu_torch import cli
    from ntm_tracker_tpu_torch.data.feature_cache import token_batch_iterator
    from ntm_tracker_tpu_torch.data.pickle_dataset import (
        active_resize_get_batch, default_get_batch, load_generated_sequences, load_wholeframe_batch,
    )
    from ntm_tracker_tpu_torch.data.sequences import get_valid_sequences
    from ntm_tracker_tpu_torch.models import legacy_ntm
    from ntm_tracker_tpu_torch.models.vgg import init_vgg_params
    from ntm_tracker_tpu_torch.train.active_resize import ActiveResizeExperiment
    from ntm_tracker_tpu_torch.train.dnc_trainer import RepeatCopyTrainConfig, repeat_copy_loss, repeat_copy_setup
    from ntm_tracker_tpu_torch.train.experiments import HeatmapExperiment, WholeFrameExperiment
    from ntm_tracker_tpu_torch.train.harness import CheckpointManager
    from ntm_tracker_tpu_torch.train.optim import tree_map

    d, cpu = str(dev), torch.device("cpu")
    parser = cli.build_parser()
    out, counts = {}, {}
    cwd = os.getcwd()
    os.chdir(root)
    try:
        vgg = init_vgg_params(torch.Generator().manual_seed(0), dev)

        def plain(exp):
            cfg = exp.cfg
            return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, fused_bptt=False))

        def at_depth(cfg, L, B):
            return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, sequence_length=L, batch_size=B))

        # ---- (a), (b) train-heatmap ------------------------------------------------
        common = ["--sequences_dir", "cropped", "--feature_cache", "cache_float16", "--batch_size", str(LAB_B),
                  "--log_interval", "1", "--validation_interval", "1000"]
        _, train, _ = get_valid_sequences("cropped", LAB_L)
        for tag, extra, zero in (("heatmap_sequential", ["--serialization", "sequential"], ["core.out_b"]),
                                 ("heatmap_frame_compressor", ["--serialization", "frame", "--compress_dim", "128"],
                                  [])):
            # the first step against the plain route, at L = LAB_CHECK_L
            args = parser.parse_args(["--device", d, "train-heatmap", *common, *extra, "--sequence_length",
                                      str(LAB_CHECK_L)])
            cfg = cli._tracker_config(args, "ntm")
            exp = cli._make_experiment(args, cfg, None, dev)
            params, _ = exp.init(torch.Generator().manual_seed(2))
            _, short, _ = get_valid_sequences("cropped", LAB_CHECK_L)
            tb = next(token_batch_iterator(short, LAB_B, "cache_float16", 8, shuffle=True, seed=0))
            batch = exp.device_batch({k: getattr(tb, k) for k in ("features", "gts", "y_offsets", "x_offsets")})
            pexp = HeatmapExperiment(plain(exp), None, device=dev, serialization=exp.serialization,
                                     compress_dim=exp.compress_dim)
            check = lab_first_step(tag, exp, pexp, params, batch, zero=zero)
            # the path at full depth through the CLI
            args = parser.parse_args(["--device", d, "train-heatmap", *common, *extra, "--sequence_length",
                                      str(LAB_L), "--num_epochs", str(LAB_STEPS), "--log_dir", f"log_{tag}"])
            reset_all_counts()
            run = cli.train_offsets(args)
            counts[tag] = kernel_launches()
            recs = [json.loads(line) for line in open(os.path.join(run["log_dir"], "metrics.jsonl"))]
            losses = [r["train_loss"] for r in recs if "train_loss" in r]
            vals = [r["val_loss"] for r in recs if "val_loss" in r]
            step_ms = run_periods_ms(run)[0]
            c, steps = counts[tag], run["steps"]
            T = (64 + (LAB_L - 1) * 129) if "sequential" in tag else LAB_L * 65
            IN = (exp.compress_dim or 512) + (3 if exp.serialization == "sequential" else 2)
            log("lab", f"{smi}: train-heatmap {' '.join(extra)} B={LAB_B} L={LAB_L} (T={T}, IN {IN}, output_dim "
                       f"{exp.cfg.ntm.output_dim}): {steps} steps, step {step_ms:.2f} ms (median, the "
                       f"loss read every step); losses {[round(v, 4) for v in losses]}, validation {vals}; "
                       f"launches {c}")
            if steps != LAB_STEPS * (len(train) // LAB_B) or not np.isfinite(losses + vals).all() or (
                    dev.type == "cuda" and not (c["bptt_forward"] == c["bptt_backward"] == steps
                                                and c["grad_reduce"] == 2 * steps and c["ntm_scan_fused"] == len(vals)
                                                and c["token_projection"] == steps + len(vals))):
                raise AssertionError(f"train-heatmap {extra}: {steps} steps, launches {c}")
            out[tag] = {"check": check, "steps": steps, "step_ms": step_ms, "losses": losses, "val": vals, "T": T,
                        "IN": IN}
            check_budget(f"lab_{tag}")

        # ---- (c), (d) the pickle trainers on mine-sequences' pickle ---------------
        lab_vid_tree("lab_vid")
        cli.main(["--device", d, "mine-sequences", "--image_dirs", "lab_vid/Data", "--annotation_dirs",
                  "lab_vid/Annotations", "--output_pickle", "lab.pkl", "--layers", "pool5", "--num_workers", "1"])
        mined = load_generated_sequences("lab.pkl", LAB_L)
        if len(mined) != LAB_SEQS:
            raise AssertionError(f"mine-sequences kept {len(mined)} sequences of >= {LAB_L} frames, not {LAB_SEQS}")
        pickle_common = ["--pickle_path", "lab.pkl", "--batch_size", str(LAB_PICKLE_B), "--log_interval", "1",
                         "--num_epochs", str(LAB_PICKLE_EPOCHS)]
        for tag, command, extra in (("wholeframe", "train-wholeframe", ["--feature_layer", "pool5"]),
                                    ("wholeframe_two_step", "train-wholeframe",
                                     ["--feature_layer", "pool5", "--two_step"]),
                                    ("active_resize", "train-active-resize", [])):
            L = LAB_L if command == "train-wholeframe" else LAB_AR_L
            args = parser.parse_args(["--device", d, command, *pickle_common, *extra, "--sequence_length",
                                      str(LAB_CHECK_L)])
            cfg = cli._tracker_config(args, "ntm")
            seqs = load_generated_sequences("lab.pkl", LAB_CHECK_L)
            if command == "train-wholeframe":
                exp = WholeFrameExperiment(cfg, vgg, endpoint="pool5", two_step="--two_step" in extra, device=dev)
                pexp = WholeFrameExperiment(plain(exp), vgg, endpoint="pool5", two_step=exp.two_step, device=dev)
                names, gts, _ = default_get_batch(0, LAB_PICKLE_B, LAB_CHECK_L, seqs)
                batch = {"images": torch.as_tensor(load_wholeframe_batch(names, 224), device=dev),
                         "gts": torch.as_tensor(gts, device=dev)}
            else:
                exp = ActiveResizeExperiment(cfg, vgg, compress_dim=128, device=dev)
                pexp = ActiveResizeExperiment(plain(exp), vgg, compress_dim=128, device=dev)
                names, boxes, _ = active_resize_get_batch(0, LAB_PICKLE_B, LAB_CHECK_L, seqs)
                frames = load_wholeframe_batch(names, 224).reshape(LAB_PICKLE_B, LAB_CHECK_L, 224, 224, 3)
                batch = {"frames": torch.as_tensor(frames, device=dev), "bboxes": torch.as_tensor(boxes, device=dev)}
            params, _ = exp.init(torch.Generator().manual_seed(3))
            check = lab_first_step(tag, exp, pexp, params, batch)
            args = parser.parse_args(["--device", d, command, *pickle_common, *extra, "--sequence_length", str(L),
                                      "--log_dir", f"log_{tag}"])
            reset_all_counts()
            run = (cli.train_wholeframe if command == "train-wholeframe" else cli.train_active_resize)(args)
            counts[tag] = c = kernel_launches()
            steps, losses = run["steps"], run["losses"]
            step_ms = float(np.median(np.diff(run["step_starts"]))) * 1e3
            per = 1 if command == "train-wholeframe" else L
            IN = 49 * 128 + 49 + (1 if "two_step" in tag else 0) if command == "train-wholeframe" else 130
            T = (2 * L - 1 if "two_step" in tag else L) if command == "train-wholeframe" else 65
            log("lab", f"{smi}: {command} {' '.join(extra)} B={LAB_PICKLE_B} L={L} (IN {IN}, T {T}"
                       f"{' a frame' if per > 1 else ''}, output_dim {exp.cfg.ntm.output_dim}): {steps} steps, step "
                       f"{step_ms:.2f} ms (median; the batch decoded and VGG run each step); losses "
                       f"{[round(v, 4) for v in losses]}; launches {c}")
            if steps != LAB_PICKLE_EPOCHS * (LAB_SEQS // LAB_PICKLE_B) or not np.isfinite(losses).all() or (
                    dev.type == "cuda" and not (c["bptt_forward"] == c["bptt_backward"] == c["token_projection"]
                                                == per * steps and c["grad_reduce"] == 2 * per * steps
                                                and c["ntm_scan_fused"] == 0)):
                raise AssertionError(f"{command} {extra}: {steps} steps, launches {c}")
            out[tag] = {"check": check, "steps": steps, "step_ms": step_ms, "losses": losses, "IN": IN, "T": T}
            check_budget(f"lab_{tag}")

        # ---- (e) train-offsets --save_imgs: the dashboards through B1 in chunks ---
        args = parser.parse_args(["--device", d, "train-offsets", *common, "--sequence_length", str(LAB_L),
                                  "--num_epochs", "1", "--save_imgs", "--log_dir", "log_save_imgs"])
        reset_all_counts()
        t0 = time.perf_counter()
        run = cli.train_offsets(args)
        run_s = time.perf_counter() - t0
        counts["save_imgs"] = c = kernel_launches()
        recs = [json.loads(line) for line in open(os.path.join(run["log_dir"], "metrics.jsonl"))]
        val0 = next(r["val_loss"] for r in recs if "val_loss" in r)
        pngs = sorted(f for f in os.listdir(run["log_dir"]) if f.endswith(".png"))
        sizes = [os.path.getsize(os.path.join(run["log_dir"], f)) for f in pngs]
        T = LAB_L * 65
        stride = -(-T // 256)
        chunks = T // stride + (1 if T % stride else 0)
        ckpt = CheckpointManager(os.path.join(run["log_dir"], "ckpt"))
        exp = cli._make_experiment(args, cli._tracker_config(args, "ntm"), None, dev)
        _, _, val = get_valid_sequences("cropped", LAB_L)
        vb = next(token_batch_iterator(val, LAB_B, "cache_float16", 8, shuffle=True, seed=args.seed, epochs=1))
        vbatch = {k: getattr(vb, k) for k in ("features", "gts", "y_offsets", "x_offsets")}
        params0 = ckpt.restore(0)["params"]
        reset_all_counts()
        eval_loss = float(exp.make_eval_step()(params0, vbatch)["loss"])
        eval_counts = kernel_launches()
        rel = abs(val0 - eval_loss) / abs(eval_loss)
        log("lab", f"{smi}: train-offsets --save_imgs B={LAB_B} L={LAB_L} (T={T}): {run['steps']} step and one "
                   f"validation through eval_with_views (unroll_states at stride {stride}: {chunks} B1 calls) in "
                   f"{run_s:.2f}s; PNGs {dict(zip(pngs, sizes))}; launches {c}; the views' validation loss "
                   f"{val0:.6f} against the eval step's (one B1 call, {eval_counts['ntm_scan_fused_by_route']}) "
                   f"{eval_loss:.6f}, rel {rel:.2e} (tol {F32_TOL:g})")
        if pngs != ["step_0_memory.png"] or min(sizes) <= 0 or rel > F32_TOL or (
                dev.type == "cuda" and not (c["ntm_scan_fused"] == chunks and c["bptt_forward"] == run["steps"]
                                            and c["token_projection"] == chunks + run["steps"])):
            raise AssertionError(f"--save_imgs: PNGs {pngs}, launches {c}, validation rel {rel:.2e}")
        out["save_imgs"] = {"chunks": chunks, "stride": stride, "s": run_s, "val_rel_eval": rel, "pngs": sizes}
        check_budget("lab_save_imgs")

        # ---- (f) dnc-repeat-copy ---------------------------------------------------
        rcfg = RepeatCopyTrainConfig(seed=0)
        task, dcfg, params, _ = repeat_copy_setup(rcfg, dev)
        batch = task.sample()
        card = float(repeat_copy_loss(params, dcfg, batch, dev))
        host = float(repeat_copy_loss(tree_map(lambda t: t.to(cpu), params), dcfg, batch, cpu))
        loss_rel = abs(card - host) / abs(host)
        t0 = time.perf_counter()
        cli.main(["--device", d, "dnc-repeat-copy", "--num_training_iterations", str(LAB_DNC_ITERS),
                  "--report_interval", str(LAB_DNC_ITERS)])
        dnc_s = time.perf_counter() - t0
        log("lab", f"{smi}: dnc-repeat-copy at its defaults (memory 16x16, LSTM-64, batch 16, T "
                   f"{task.max_total_length}): {LAB_DNC_ITERS} iterations in {dnc_s:.2f}s ("
                   f"{dnc_s / LAB_DNC_ITERS * 1e3:.1f} ms each, plain PyTorch); step 0's loss on the card {card:.6f}, "
                   f"on the CPU from the same params and batch {host:.6f}, rel {loss_rel:.2e} (tol {DNC_LOSS_RTOL:g})")
        if loss_rel > DNC_LOSS_RTOL:
            raise AssertionError(f"dnc-repeat-copy: step 0's loss on the card {card} against the CPU's {host}")
        out["dnc_repeat_copy"] = {"loss_rel": loss_rel, "s": dnc_s}

        # ---- (g) the legacy NTM ----------------------------------------------------
        lcfg = legacy_ntm.LegacyNTMConfig()
        lparams = legacy_ntm.init_legacy_params(lcfg, 514, torch.Generator().manual_seed(4))
        rs = np.random.RandomState(6)
        inputs = rs.randn(LAB_LEGACY_B, LAB_LEGACY_T, 514).astype(np.float32)
        targets = rs.rand(LAB_LEGACY_B, lcfg.num_features).astype(np.float32)
        with torch.no_grad():
            t0 = time.perf_counter()
            on_card = legacy_ntm.legacy_ntm_unroll_batched(tree_map(lambda t: t.to(dev), lparams), lcfg,
                                                           torch.as_tensor(inputs, device=dev),
                                                           torch.as_tensor(targets, device=dev))
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            on_card = tree_map(lambda t: t.to(cpu), on_card)
            on_cpu = legacy_ntm.legacy_ntm_unroll_batched(lparams, lcfg, torch.as_tensor(inputs),
                                                          torch.as_tensor(targets))
        errs = {"outputs": max_abs(on_card[0], on_cpu[0]), "logits": max_abs(on_card[1], on_cpu[1]),
                **{k: max_abs(on_card[2][k], v) for k, v in on_cpu[2].items()}}
        worst = max(errs, key=errs.get)
        log("lab", f"{smi}: legacy_ntm_unroll_batched at LegacyNTMConfig() (memory 128x20, 10 layers of 100) B="
                   f"{LAB_LEGACY_B} T={LAB_LEGACY_T} IN=514 on the card in {card_s:.2f}s; against the CPU's max abs "
                   f"{errs[worst]:.2e} at {worst} (tol {LEGACY_TOL:g})")
        if errs[worst] > LEGACY_TOL or not torch.isfinite(on_card[1]).all():
            raise AssertionError(f"the legacy NTM on the card disagrees with the CPU's: {errs}")
        out["legacy"] = {"max_abs": errs[worst], "s": card_s}
        check_budget("lab")
    finally:
        os.chdir(cwd)
    out["counts"] = counts
    return out


def cli_subprocess(dev: torch.device, work: str, tag: str, argv: list, stdin: bool = False, nice: int = 0,
                   module: str = "ntm_tracker_tpu_torch"):
    """`python -m <module> --device <dev> <argv>` from this checkout
    (module=None: `python <argv>`): (process, log file). Its stderr (and stdout, unless stdin is
    asked for: a TraX server's stdout is its wire) goes to <work>/<tag>.log,
    since a full pipe would block it. TF32 off through the libraries' own
    switch (the CLI keeps PyTorch's defaults; the in-process references run
    with it off). Killed at exit if still running."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""),
               NVIDIA_TF32_OVERRIDE="0")
    log_f = open(os.path.join(work, f"{tag}.log"), "w+")
    cmd = [sys.executable, "-m", module, "--device", str(dev), *argv] if module else [sys.executable, *argv]
    proc = subprocess.Popen(cmd, cwd=here,
                            env=env, stdin=subprocess.PIPE if stdin else subprocess.DEVNULL,
                            stdout=subprocess.PIPE if stdin else log_f, stderr=log_f, text=True,
                            preexec_fn=(lambda: os.nice(nice)) if nice else None)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    atexit.register(stop)
    return proc, log_f


def finish_subprocess(tag: str, proc, log_f, timeout: float = 300) -> str:
    """Wait for a cli_subprocess; its log, or raise with the log's tail."""
    code = proc.wait(timeout=timeout)
    log_f.seek(0)
    text = log_f.read()
    if code != 0:
        raise AssertionError(f"{tag} exited {code}: {text[-3000:]}")
    return text


def start_serving_exports(dev: torch.device, work: str) -> dict:
    """`export-serving` for cuda at batch 1 and at batch SERVE_FLEET with the
    device loop, each a CLI subprocess, started with the parallel ranks
    after the packed phase (a CPU-heavy trace: beside the build it slowed
    main's plain references), at LATER_NICE: {tag: (process, log file,
    artifact path)}."""
    import os

    out = {}
    for tag, extra in (("b1", []), (f"b{SERVE_FLEET}", ["--batch", str(SERVE_FLEET), "--device_loop",
                                                       f"{FLEET_HW[0]}x{FLEET_HW[1]}"])):
        path = os.path.join(work, f"serving_{tag}.npz")
        out[tag] = (*cli_subprocess(dev, work, f"export_{tag}", ["export-serving", *extra, "--out", path],
                                    nice=LATER_NICE), path)
    return out


def start_trax_servers(dev: torch.device, work: str, exports: dict) -> dict:
    """`track-vot --vot_mode trax`, live and on the batch-1 artifact (its
    export waited for), started a phase early: each takes ~10-20 s to reach
    the card and then waits on its stdin. {tag: (process, log file)}."""
    proc, log_f, b1_path = exports["b1"]
    finish_subprocess("export_b1", proc, log_f)
    return {tag: cli_subprocess(dev, work, f"track_vot_{tag}", ["track-vot", "--vot_mode", "trax", *extra], stdin=True)
            for tag, extra in (("live", []), ("artifact", ["--serving_npz", b1_path]))}


def trax_session(proc, paths, region) -> list:
    """Drive a `track-vot --vot_mode trax` process over its pipes: hello,
    initialize on paths[0], one frame per later path, quit. Returns the
    reported regions; raises if any stdout line is not a TraX message."""
    from ntm_tracker_tpu_torch.tracking.trax_protocol import format_message, parse_message

    def read():
        line = proc.stdout.readline()
        msg = parse_message(line)
        if msg is None:
            raise AssertionError(f"track-vot wrote a non-protocol line on stdout: {line!r}")
        return msg

    if read()[0] != "hello":
        raise AssertionError("track-vot sent no hello")
    proc.stdin.write(format_message("initialize", ["file://" + paths[0], ",".join(map(str, region))]) + "\n")
    proc.stdin.flush()
    if read()[0] != "state":
        raise AssertionError("no state after initialize")
    regions = []
    for p in paths[1:]:
        proc.stdin.write(format_message("frame", [p]) + "\n")
        proc.stdin.flush()
        mtype, args, _ = read()
        if mtype != "state":
            raise AssertionError(f"expected state, got {mtype}")
        regions.append([float(v) for v in args[0].split(",")])
    proc.stdin.write(format_message("quit", []) + "\n")
    proc.stdin.close()
    rest = proc.stdout.read().splitlines()
    if [parse_message(line) and parse_message(line)[0] for line in rest] != ["quit"]:
        raise AssertionError(f"track-vot's stdout after the session: {rest!r}")
    return regions


def crop_edge_samples(cropbox, image_wh, n: int) -> int:
    """Rows plus columns of an n x n crop_and_resize of `cropbox`
    (normalized y1, x1, y2, x2) that sample outside the image, by its
    float32 sample coordinates (data/image_ops._sample_coords)."""
    W, H = image_wh
    count = 0
    for lo, hi, size in ((cropbox[0], cropbox[2], H), (cropbox[1], cropbox[3], W)):
        lo, hi = np.float32(lo), np.float32(hi)
        c = lo * np.float32(size - 1) + np.arange(n, dtype=np.float32) * ((hi - lo) * np.float32(size - 1) /
                                                                        np.float32(n - 1))
        count += int(((c < 0) | (c > size - 1)).sum())
    return count


def edge_witness(ious: dict, recorded: dict) -> dict:
    """Where the live (B1) and plain replays' IoUs part: per track, the
    first step whose IoU gap passes SERVE_IOU_TOL, and the crop's
    out-of-frame sample count on both routes at every step up to it (the
    replays admit all SERVE_FLEET tracks at once, track i in slot i).
    'edge_step_first' counts the tracks whose counts differ at or before
    that step: a row of samples that crossed the frame's edge on one route
    and not on the other."""
    live, plain = np.asarray(ious["live_edges"]), np.asarray(ious["plain"])
    tracks = {}
    for i in range(live.shape[0]):
        over = np.nonzero(np.abs(live[i] - plain[i]) > SERVE_IOU_TOL)[0]
        if not len(over):
            continue
        t = int(over[0])
        tracks[i] = {"step": t, "gap": float(abs(live[i, t] - plain[i, t])),
                     "edges_live": [recorded["live_edges"].edges[s][i] for s in range(t + 1)],
                     "edges_plain": [recorded["plain"].edges[s][i] for s in range(t + 1)]}
    return {"tracks_parted": len(tracks), "edge_step_first": sum(v["edges_live"] != v["edges_plain"]
                                                                 for v in tracks.values()),
            "live_replay_vs_validate": float(np.abs(live - np.asarray(ious["live"])).max()), "by_track": tracks}


def phase_serving(dev: torch.device, smi: str, root: str = None, exports: dict = None, trax: dict = None) -> dict:
    """The serving and evaluation path on the card, at TrackerConfig()'s
    width on the CLI's seeded weights: (a) export-serving for cuda at batch 1
    and at batch SERVE_FLEET with --device_loop 360x640 (CLI subprocesses
    that main starts after the packed phase, start_serving_exports, and the TraX
    servers before the lab phase, start_trax_servers; started here when
    `exports` / `trax` is None); a SERVE_CLIP-frame clip through the live B1
    tracker, then its crops through the batch-1 artifact and the live plain
    route (offsets within F32_TOL of both, no B1 launch in the artifact); the
    batch-8 artifact's step, dinit and dstep against the live plain step and
    device loop; the artifact's step ms against the live B1 frame step at
    B=1; (b) track-vot --vot_mode trax in two subprocesses over pipes, live
    and --serving_npz, started early, their regions against the in-process
    trackers'; (c) validate --fleet 8 on the data phase's val tracks
    (`root`, its "cropped" records), live and through the artifact: the
    artifact's IoUs against the live plain route's replay, and each track's
    first against the live run's, within SERVE_IOU_TOL, and the live-vs-plain gap frame by frame;
    (d) int8 tokens on the card against the CPU's, the cosine to the float32 path,
    and int8 vs float32 token ms at B = 1 and 64; (e) train-offsets
    --profile_steps 1:2 on the float16 cache. root=None builds a tree of its
    own (preprocess + cache-features)."""
    import os
    import pickle
    import re
    import shutil
    import tempfile

    from PIL import Image

    from ntm_tracker_tpu_torch import cli
    from ntm_tracker_tpu_torch.data.image_ops import crop_and_resize
    from ntm_tracker_tpu_torch.data.sequences import get_valid_sequences
    from ntm_tracker_tpu_torch.models.core import make_core
    from ntm_tracker_tpu_torch.models.vgg import VGG_MEAN, vgg16_conv43_tokens
    from ntm_tracker_tpu_torch.models.vgg_int8 import vgg16_conv43_tokens_int8
    from ntm_tracker_tpu_torch.ops.kernels.addressing import fused_ntm_addressing
    from ntm_tracker_tpu_torch.tools.export_serving import ServingModel
    from ntm_tracker_tpu_torch.tracking import validate as tval
    from ntm_tracker_tpu_torch.tracking.fleet import FleetTracker
    from ntm_tracker_tpu_torch.tracking.tracker import (
        StreamingTracker, build_frame_step, first_frame_gt, make_device_track_step, region_geometry,
    )
    from ntm_tracker_tpu_torch.train.optim import tree_map

    class EdgeRecordingFleet(FleetTracker):
        """A FleetTracker that records, before each step, crop_edge_samples
        of every stepped slot's crop: self.edges[step][slot]. nudge moves
        each added track's first (normalized) region that far right."""

        nudge = 0.0

        def add(self, image, region_xywh):
            x, y, w, h = region_xywh
            return super().add(image, (x + self.nudge, y, w, h))

        def step(self, images):
            n = self.cfg.data.crop_size
            self.edges = getattr(self, "edges", []) + [{
                i: crop_edge_samples(self._tracks[i].cropbox, self._tracks[i].image_size, n)
                for i in self.active if i in images}]
            return super().step(images)

    d = str(dev)
    parser = cli.build_parser()
    out, counts = {}, {}
    own = root is None
    root = tempfile.mkdtemp(prefix="ntm_serve_") if own else root
    work = tempfile.mkdtemp(prefix="ntm_serve_work_")
    cwd = os.getcwd()
    procs = {}

    def reset():
        reset_all_counts()
        zero_launches(fused_ntm_addressing)

    def b1_b3_launches():
        n = kernel_launches()
        return {"ntm_scan_fused": n["ntm_scan_fused"], "fused_ntm_addressing": n["fused_ntm_addressing"]}

    try:
        if own:
            from ntm_tracker_tpu_torch.data.synthetic_vid import write_vid_tree

            os.chdir(root)
            write_vid_tree(".", seed=0, sequences=DATA_SEQS)
            cli.main(["--device", d, "preprocess", "--annotation_dir", "Annotations", "--image_dir", "Data",
                      "--output_dir", "cropped", "--num_workers", "1"])
            cli.main(["--device", d, "cache-features", "--sequences_dir", "cropped", "--cache_dir", "cache_float16"])
        os.chdir(root)
        t_phase = time.perf_counter()

        # ---- (a) the exports (started phases ahead), then track-vot ----------------
        video, region0 = synthetic_video(seed=3, frames=1 + SERVE_CLIP, hw=FLEET_HW)
        paths = []
        for t in range(1 + SERVE_CLIP):
            paths.append(os.path.join(work, f"{t:08d}.png"))
            Image.fromarray(video[t]).save(paths[-1])
        exports = exports or start_serving_exports(dev, work)
        trax_servers = trax or start_trax_servers(dev, work, exports)
        procs.update({f"export_{tag}": e[:2] for tag, e in exports.items()})
        procs.update({f"track_vot_{tag}": t for tag, t in trax_servers.items()})
        t0 = time.perf_counter()
        out["export"] = {}
        for tag, (proc, log_f, path) in exports.items():
            printed = finish_subprocess(f"export_{tag}", proc, log_f)
            found = re.search(r"for platforms \['cuda'\] .*\) -> \S+ \(([0-9.]+) MB\) in ([0-9.]+) s", printed)
            if found is None:
                raise AssertionError(f"export-serving ({tag}) printed no cuda export: {printed[-2000:]}")
            out["export"][tag] = {"seconds": float(found.group(2)), "mb": float(found.group(1)), "path": path}
        wait_s = time.perf_counter() - t0
        b1_path, b8_path = out["export"]["b1"]["path"], out["export"][f"b{SERVE_FLEET}"]["path"]
        t0 = time.perf_counter()
        m1 = ServingModel(b1_path, dev)
        load_s = time.perf_counter() - t0
        log("serving", f"export-serving for cuda (CLI subprocesses started phases ahead; waited {wait_s:.2f}s "
                       f"here): batch 1 {out['export']['b1']['seconds']:.2f}s {out['export']['b1']['mb']:.1f} MB; "
                       f"batch {SERVE_FLEET} + device loop {FLEET_HW[0]}x{FLEET_HW[1]} "
                       f"{out['export'][f'b{SERVE_FLEET}']['seconds']:.2f}s "
                       f"{out['export'][f'b{SERVE_FLEET}']['mb']:.1f} MB; batch 1 loaded in {load_s:.2f}s; route: "
                       f"{m1.meta['route']}")
        out["export"]["b1"]["load_s"] = load_s

        # the CLI's seeded weights, in process, for the live routes
        args = parser.parse_args(["--device", d, "track-vot"])
        cfg = cli._tracker_config(args, "ntm")
        core = make_core(cfg)
        vgg = cli._load_vgg(args, dev)
        params = cli._resolve_tracker_weights(args, cfg, core, dev)
        plain_cfg = dataclasses.replace(cfg, fused_inference=False)
        plain_core = make_core(plain_cfg)

        reset()
        live = StreamingTracker(cfg, vgg, params, core, device=dev)
        live.init(video[0], region0)
        boxes = [list(live.cropbox)]
        for t in range(1, 1 + SERVE_CLIP):
            boxes.append(list(live.cropbox))
            live.track(video[t])
        counts["serving_clip_live"] = b1_b3_launches()
        mean = torch.as_tensor(VGG_MEAN, device=dev)

        def crop(frame, box):
            img = torch.as_tensor(frame, device=dev).float() - mean
            return crop_and_resize(img[None], torch.tensor([box], dtype=torch.float32, device=dev),
                                   (cfg.data.crop_size, cfg.data.crop_size))

        crops = [crop(video[t], boxes[t]) for t in range(1 + SERVE_CLIP)]
        nb, _, tr = region_geometry(cfg.data, (video.shape[2], video.shape[1]), region0)
        gt = torch.as_tensor(first_frame_gt(cfg, nb, tr).reshape(1, -1), device=dev)
        offs = {}
        for tag, (first, rest) in {
            "b1_route": build_frame_step(cfg, core, vgg, params, device=dev),
            "plain": build_frame_step(plain_cfg, plain_core, vgg, params, device=dev),
            "artifact": (m1.first, m1.step),
        }.items():
            reset()
            if tag == "artifact":
                state = m1.init_state()
            else:
                with torch.no_grad():
                    state = core.init_state(params, 1)
            _, state = first(crops[0], gt, state)
            offs[tag] = []
            for t in range(1, 1 + SERVE_CLIP):
                o, state = rest(crops[t], state)
                offs[tag].append(o[0].cpu().numpy())
            offs[tag] = np.asarray(offs[tag], np.float64)
            counts[f"serving_clip_{tag}"] = b1_b3_launches()
        err_plain = float(np.abs(offs["artifact"] - offs["plain"]).max())
        err_b1 = float(np.abs(offs["artifact"] - offs["b1_route"]).max())
        log("serving", f"{SERVE_CLIP}-frame clip at {FLEET_HW[0]}x{FLEET_HW[1]}, the same crops: artifact vs live "
                       f"plain route max_abs(offsets)={err_plain:.3e}, vs live B1 route {err_b1:.3e} (tol "
                       f"{F32_TOL:g}); launches {counts}")
        if not np.isfinite(offs["artifact"]).all() or max(err_plain, err_b1) > F32_TOL:
            raise AssertionError(f"the artifact disagrees with the live frame step: {err_plain:.3e}, {err_b1:.3e}")
        if counts["serving_clip_artifact"]["ntm_scan_fused"] != 0 or counts["serving_clip_b1_route"][
                "ntm_scan_fused"] != 1 + SERVE_CLIP or counts["serving_clip_live"]["ntm_scan_fused"] != 1 + SERVE_CLIP:
            raise AssertionError(f"B1 launches on the serving clip {counts}: expected one a frame live, none in the "
                                 "artifact")
        out["clip"] = {"artifact_vs_plain": err_plain, "artifact_vs_b1": err_b1}

        # the artifact's step against the live B1 frame step at B=1
        step_b1 = build_frame_step(cfg, core, vgg, params, device=dev)[1]
        plain_step = build_frame_step(plain_cfg, plain_core, vgg, params, device=dev)[1]
        with torch.no_grad():
            st = core.init_state(params, 1)
        leaves = m1.init_state()
        art_ms = cuda_ms(lambda: m1.step(crops[1], leaves), iters=5, warmup=1)
        live_ms = cuda_ms(lambda: step_b1(crops[1], st), iters=20, warmup=3)
        plain_ms = cuda_ms(lambda: plain_step(crops[1], st), iters=5, warmup=1)
        log("times", f"{smi}: frame step at B=1 (crop on the card, VGG + 65 cell steps): artifact {art_ms:.3f} ms "
                     f"(plain cell loop as one scan), live B1 route {live_ms:.3f} ms, live plain loop {plain_ms:.3f} ms "
                     f"(CUDA events, host dispatch included)")
        out["step_ms"] = {"artifact": art_ms, "live_b1": live_ms, "live_plain": plain_ms}
        check_budget("serving_clip")

        # ---- (d) int8 tokens: the card against the CPU, and their times -------------
        c2 = torch.cat(crops[:2])
        cpu_vgg = tree_map(lambda t: t.cpu(), vgg)
        with torch.no_grad():
            t_card = vgg16_conv43_tokens_int8(vgg, c2)
            t_cpu = vgg16_conv43_tokens_int8(cpu_vgg, c2.cpu())
            t_f32 = vgg16_conv43_tokens(vgg, c2)
        # why the scale divides by a tensor: a Python scalar divisor makes the
        # CUDA kernel multiply by its reciprocal (not held, counted)
        amax = torch.rand(1 << 20, device=dev) * 300
        recip_ulps = int((amax / 127.0 != amax / amax.new_full((), 127.0)).sum())
        int8_err = max_abs(t_card.cpu(), t_cpu) / float(t_cpu.abs().max())
        cos = torch.nn.functional.cosine_similarity(t_card, t_f32, dim=-1, eps=1e-12)
        int8_ms = {}
        for B in INT8_TIME_B:
            cb = torch.cat([crops[i % len(crops)] for i in range(B)])
            with torch.no_grad():
                int8_ms[B] = {
                    "int8": cuda_ms(lambda: vgg16_conv43_tokens_int8(vgg, cb), iters=5, warmup=1),
                    "f32": cuda_ms(lambda: vgg16_conv43_tokens(vgg, cb), iters=5, warmup=1),
                }
        log("serving", f"int8 tokens B=2 (im2col + torch._int_mm on both): card vs CPU rel max_abs={int8_err:.3e} "
                       f"(tol {INT8_TOL:g}); cosine to float32 min {float(cos.min()):.5f} (bar {INT8_COS}); x / 127.0 "
                       f"differs from x / tensor(127.0) on the card in {recip_ulps} of {amax.numel()} values")
        log("times", f"{smi}: VGG conv4_3 tokens (204x204 slice, CUDA events, TF32 off): " + "; ".join(
            f"B={B} int8 {v['int8']:.3f} ms, float32 {v['f32']:.3f} ms" for B, v in int8_ms.items()))
        if int8_err > INT8_TOL or float(cos.min()) <= INT8_COS:
            raise AssertionError(f"int8 tokens: card vs CPU {int8_err:.3e}, cosine {float(cos.min()):.5f}")
        out["int8"] = {"card_vs_cpu": int8_err, "cos_min": float(cos.min()), "ms": int8_ms,
                       "scalar_divisor_ulps": recip_ulps}

        # ---- (e) train-offsets --profile_steps ---------------------------------------
        reset()
        run = cli.train_offsets(parser.parse_args(
            ["--device", d, "train-offsets", "--sequences_dir", "cropped", "--feature_cache", "cache_float16",
             "--batch_size", str(DATA_B), "--sequence_length", str(TRAIN_L), "--num_epochs", "3",
             "--validation_interval", "1000", "--log_interval", "1", "--profile_steps", "1:2",
             "--log_dir", os.path.join(work, "log_profile")]))
        counts["serving_profile_train"] = kernel_launches()
        trace = os.path.join(run["profile_dir"], "steps_1_2.pt.trace.json")
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        steps_seen = sorted({e["name"] for e in events if str(e.get("name", "")).startswith("train_step_")})
        n_kernels = sum(1 for e in events if e.get("cat") == "kernel")
        log("serving", f"train-offsets --profile_steps 1:2 ({run['steps']} steps at B={DATA_B}): "
                       f"{os.path.basename(trace)} {os.path.getsize(trace) / 1e6:.2f} MB, ranges {steps_seen}, "
                       f"{n_kernels} kernel events on the card; launches {counts['serving_profile_train']}")
        if steps_seen != ["train_step_1", "train_step_2"] or run["steps"] < 3 or not n_kernels:
            raise AssertionError(f"the profile window traced {steps_seen} over {run['steps']} steps, {n_kernels} "
                                 "kernel events")
        out["profile"] = {"trace_mb": os.path.getsize(trace) / 1e6, "kernel_events": n_kernels}
        check_budget("serving_int8_profile")

        # ---- (a) the batch-8 artifact: step, dinit and dstep against the live routes ------
        t0 = time.perf_counter()
        m8 = ServingModel(b8_path, dev)
        B = SERVE_FLEET
        out["export"][f"b{B}"]["load_s"] = time.perf_counter() - t0
        crops8 = torch.cat([crops[1 + i % SERVE_CLIP] for i in range(B)])
        step8 = build_frame_step(cfg, core, vgg, params, device=dev)[1]
        with torch.no_grad():
            st8 = core.init_state(params, B)
        reset()
        o_live, _ = step8(crops8, st8)
        o_art, _ = m8.step(crops8, m8.init_state())
        step8_err = max_abs(o_art, o_live)
        # [T, B, H, W, 3]: the tracks share each frame, each from its own box
        frames8 = torch.as_tensor(synthetic_video(seed=4, frames=4, hw=FLEET_HW)[0], device=dev)[:, None].expand(
            -1, B, -1, -1, -1).contiguous()
        init_fn, step_fn = make_device_track_step(cfg, core, vgg, params, device=dev)
        bbox_l = bbox_a = torch.as_tensor(normalized_bboxes(fleet_regions(B)), device=dev)
        with torch.no_grad():
            st_l = init_fn(frames8[0], bbox_l, core.init_state(params, B))
        lv_a = m8.device_init(frames8[0], bbox_a, m8.init_state())
        loop_err = 0.0
        for t in range(1, 4):
            r_l, bbox_l, st_l = step_fn(frames8[t], bbox_l, st_l)
            r_a, bbox_a, lv_a = m8.device_step(frames8[t], bbox_a, lv_a)
            loop_err = max(loop_err, max_abs(r_a, r_l))
        counts["serving_b8_live_and_artifact"] = b1_b3_launches()
        log("serving", f"the batch-{B} artifact, loaded in {out['export'][f'b{B}']['load_s']:.2f}s: step vs the live "
                       f"frame step at B={B} (the "
                       f"plain loop by the rule) max_abs(offsets)={step8_err:.3e} (tol {F32_TOL:g}); dinit + 3 dstep vs "
                       f"make_device_track_step regions {loop_err:.3e} px (tol {SERVE_REGION_TOL_PX:g})")
        if step8_err > F32_TOL or loop_err > SERVE_REGION_TOL_PX:
            raise AssertionError("the batch-8 artifact disagrees with the live routes")
        out["b8"] = {"step_err": step8_err, "loop_err_px": loop_err}

        # ---- (c) validate --fleet 8, live and through the artifact ------------------
        _, _, val = get_valid_sequences("cropped", SERVE_VAL_FRAMES)
        seqs = [(p, names[:SERVE_VAL_FRAMES]) for p, names in val[:SERVE_FLEET]]
        pkl = os.path.join(work, "val.pkl")
        with open(pkl, "wb") as f:
            pickle.dump(seqs, f)
        ious = {}
        for tag, extra in (("live", []), ("artifact", ["--serving_npz", b8_path])):
            reset()
            t0 = time.perf_counter()
            ious[tag] = tval.validate_tracker(parser.parse_args(
                ["--device", d, "validate", "--pickle_path", pkl, "--fleet", str(SERVE_FLEET), *extra]))
            counts[f"serving_validate_{tag}"] = dict(b1_b3_launches(), seconds=time.perf_counter() - t0)
        # the artifact's route, live: the same fleet on the plain cell loop;
        # it and a second live replay record, before each step, how many of
        # every crop's sample rows and columns fall outside the frame
        # (crop_and_resize gives those 0: a step in the box's coordinates)
        # (one more plain replay starts each track SERVE_NUDGE to the right:
        # the closed loop's own growth of a small difference, without B1)
        recorded = {}
        for tag, c, k, nudge in (("plain", plain_cfg, plain_core, 0.0), ("live_edges", cfg, core, 0.0),
                                 ("plain_nudged", plain_cfg, plain_core, SERVE_NUDGE)):
            recorded[tag] = EdgeRecordingFleet(c, vgg, params, capacity=SERVE_FLEET, core=k, device=dev)
            recorded[tag].nudge = nudge
            ious[tag] = tval.replay_sequences_fleet(seqs, None, None, None, log=lambda m: None, fleet=recorded[tag])
        edge_gap = edge_witness(ious, recorded)
        nudged = np.abs(np.asarray(ious.pop("plain_nudged")) - np.asarray(ious["plain"])).max(axis=0).tolist()
        val_w = next(size[0] for _, split, size, _, _ in DATA_SEQS if split == "val")
        del ious["live_edges"]
        flat = {k: np.asarray([i for s in v for i in s]) for k, v in ious.items()}
        iou_err = float(np.abs(flat["artifact"] - flat["plain"]).max())
        first_err = max(abs(a[0] - b[0]) for a, b in zip(ious["live"], ious["artifact"]))
        live_err = float(np.abs(flat["live"] - flat["artifact"]).max())
        # frame by frame, the largest gap over the tracks: live (B1 in the
        # adds) against the live plain route and against the artifact
        by_frame = {k: np.abs(np.asarray(ious["live"]) - np.asarray(ious[k])).max(axis=0).tolist()
                    for k in ("plain", "artifact")}
        log("serving", f"validate --fleet {SERVE_FLEET}: {len(seqs)} val tracks x {SERVE_VAL_FRAMES} frames, mean IoU "
                       f"live {flat['live'].mean():.4f} artifact {flat['artifact'].mean():.4f}; artifact vs the live "
                       f"plain route's replay max |diff| {iou_err:.3e}, vs live (B1 adds) on each track's first frame "
                       f"{first_err:.3e} (tol {SERVE_IOU_TOL:g} both), over all frames {live_err:.3e} (not held); "
                       f"live vs plain IoU gap by frame " + " ".join(f"{v:.3e}" for v in by_frame["plain"]) +
                       "; live vs artifact by frame " + " ".join(f"{v:.3e}" for v in by_frame["artifact"]) +
                       f"; the plain route vs itself from a first box {SERVE_NUDGE:g} of the frame's width "
                       f"({SERVE_NUDGE * (val_w - 1):.4f} px at {val_w}) to the right, by frame " +
                       " ".join(f"{v:.3e}" for v in nudged) +
                       f"; launches {counts['serving_validate_live']} live, {counts['serving_validate_artifact']} "
                       f"artifact; the edge witness {edge_gap}")
        if len(seqs) != SERVE_FLEET or len(flat["live"]) != len(seqs) * (SERVE_VAL_FRAMES - 1) or \
                max(iou_err, first_err) > SERVE_IOU_TOL or counts["serving_validate_live"]["ntm_scan_fused"] != \
                len(seqs) or counts["serving_validate_artifact"]["ntm_scan_fused"] != 0:
            raise AssertionError(f"validate --fleet: {len(flat['live'])} IoUs, |diff| {iou_err:.3e} / {first_err:.3e}, "
                                 f"launches {counts}")
        out["validate"] = {"artifact_vs_plain": iou_err, "artifact_vs_live_first": first_err,
                           "artifact_vs_live_all": live_err, "live_gap_by_frame": by_frame, "edge_witness": edge_gap,
                           "plain_nudged_gap_by_frame": nudged,
                           "mean_iou": {k: float(v.mean()) for k, v in flat.items()}}
        # ---- (b) track-vot over TraX pipes, live and from the artifact (last: the ------
        # ---- processes need ~20 s to reach the card) ---------------------------------
        t0 = time.perf_counter()
        # the two sessions at once, each from a thread of its own
        with ThreadPoolExecutor(2) as pool:
            served = {tag: pool.submit(trax_session, procs[f"track_vot_{tag}"][0], paths, region0)
                      for tag in ("live", "artifact")}
            served = {tag: np.asarray(s.result()) for tag, s in served.items()}
        for tag in ("live", "artifact"):
            proc, log_f = procs[f"track_vot_{tag}"]
            # the session's own launch counts, from track-vot's closing line
            # on its stderr
            said = re.search(r"tracked (\d+) frames \(launches: ntm_scan_fused (\d+), fused_ntm_addressing (\d+)\)",
                             finish_subprocess(f"track_vot_{tag}", proc, log_f, timeout=120))
            if said is None or int(said.group(1)) != 1 + SERVE_CLIP:
                raise AssertionError(f"track-vot ({tag}) reported no launch counts for its {1 + SERVE_CLIP} frames")
            counts[f"serving_track_vot_{tag}"] = {"ntm_scan_fused": int(said.group(2)),
                                                  "fused_ntm_addressing": int(said.group(3))}
        trax_s = time.perf_counter() - t0
        # the in-process trackers over the same decoded frames (the regions'
        # reference; their launches are this process's, not track-vot's)
        decoded = [np.array(Image.open(p).convert("RGB")) for p in paths]
        ref = {}
        for tag, trk in (("live", StreamingTracker(cfg, vgg, params, core, device=dev)),
                         ("artifact", StreamingTracker.from_serving(m1))):
            reset()
            trk.init(decoded[0], region0)
            ref[tag] = np.asarray([trk.track(f) for f in decoded[1:]])
            counts[f"serving_streaming_tracker_inprocess_{tag}"] = b1_b3_launches()
        trax_err = {k: float(np.abs(served[k] - ref[k]).max()) for k in served}
        live_vs_art = float(np.abs(served["live"] - served["artifact"]).max())
        log("serving", f"track-vot --vot_mode trax over pipes, two processes started before the lab phase (both sessions "
                       f"at once, {trax_s:.2f}s): {SERVE_CLIP} states each, stdout only protocol lines; regions vs the "
                       f"in-process tracker live {trax_err['live']:.3e} px, artifact {trax_err['artifact']:.3e} px (tol "
                       f"{SERVE_REGION_TOL_PX:g}); live vs artifact {live_vs_art:.3e} px (not held); track-vot's own "
                       f"launches {counts['serving_track_vot_live']} live, {counts['serving_track_vot_artifact']} "
                       f"artifact; the in-process trackers' {counts['serving_streaming_tracker_inprocess_live']} live, "
                       f"{counts['serving_streaming_tracker_inprocess_artifact']} artifact")
        if max(trax_err.values()) > SERVE_REGION_TOL_PX or any(
                counts[f"serving_{who}live"]["ntm_scan_fused"] != 1 + SERVE_CLIP or
                counts[f"serving_{who}artifact"]["ntm_scan_fused"] != 0
                for who in ("track_vot_", "streaming_tracker_inprocess_")):
            raise AssertionError(f"track-vot: regions vs the in-process tracker {trax_err}, launches {counts}")
        out["track_vot"] = {"session_s": trax_s, "err_px": trax_err, "live_vs_artifact_px": live_vs_art}
        out["phase_s"] = time.perf_counter() - t_phase
        check_budget("serving")
    finally:
        for proc, log_f in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log_f.close()
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
        if own:
            shutil.rmtree(root, ignore_errors=True)
    out["counts"] = counts
    return out

def dp_config():
    from ntm_tracker_tpu_torch.config import TrackerConfig, TrainConfig

    return TrackerConfig(train=TrainConfig(batch_size=DP_B, sequence_length=DP_L))


def dp_batch(cfg, dev: torch.device, n: int = DP_B * DP_L, seed: int = DP_SEED) -> dict:
    """A cached-token batch of n rows drawn on the card from `seed` (the
    feature cache's float16 tokens at conv4_3's scale): every process that
    draws it holds the same bits."""
    g = torch.Generator(device=dev).manual_seed(seed)
    gw = cfg.data.gt_width
    gts = torch.rand(n, gw, gw, generator=g, device=dev)
    return {"features": (torch.rand(n, cfg.num_features, cfg.feature_depth, generator=g, device=dev) * 40).half(),
            "gts": gts / gts.sum(dim=(1, 2), keepdim=True),
            "y_offsets": (torch.rand(n, generator=g, device=dev) - 0.5) * 0.4,
            "x_offsets": (torch.rand(n, generator=g, device=dev) - 0.5) * 0.4}


def dp_worker(rank: int, world: int, port: int, out: str, device: str = "cuda") -> None:
    """One rank of phase_parallel (a): a gloo group of `world` ranks, all on
    the card (cuda:0: rank % 1), DP_STEPS steps of parallel_train_step on
    this rank's rows of dp_batch over a mesh of PAR_SHARDS shards on that
    card (the chunks' gradients summed, then the group's all_reduce); saves
    the losses, the reduced pre-clip
    gradients, the params and B1/B2's launches to `out`. Imports only the
    port. Run as `python -c "import chip_smoke; chip_smoke.dp_worker(...)"`."""
    import torch.distributed as dist

    from ntm_tracker_tpu_torch.parallel.distributed import initialize_distributed, rank_device
    from ntm_tracker_tpu_torch.parallel.mesh import make_mesh, parallel_train_step
    from ntm_tracker_tpu_torch.train.experiments import OffsetExperiment
    from ntm_tracker_tpu_torch.train.optim import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo", device=device) != (world > 1):
        raise AssertionError("the group did not start")
    dev = rank_device(device)
    cfg = dp_config()
    exp = OffsetExperiment(cfg, None, device=dev)
    params, opt_state = exp.init(torch.Generator().manual_seed(DP_SEED))
    per = DP_B * DP_L // world
    local = {k: v[rank * per:(rank + 1) * per] for k, v in dp_batch(cfg, dev).items()}
    mesh = make_mesh([dev] * PAR_SHARDS)
    step = parallel_train_step(exp, mesh, keep_grads=True)
    reset_all_counts()
    losses, grads, ms = [], [], []
    for _ in range(DP_STEPS):
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, local)
        losses.append(float(m["loss"]))  # a host read: the step has ended
        ms.append((time.perf_counter() - t0) * 1e3)
        grads.append(tree_map(lambda t: t.cpu(), m["grads"]))
    torch.save({"losses": losses, "grads": grads, "params": tree_map(lambda t: t.cpu(), params), "ms": ms,
                "counts": kernel_launches(), "device": str(dev), "mesh": [str(d) for d in mesh.devices],
                "backend": dist.get_backend(), "world": dist.get_world_size()}, out)
    dist.destroy_process_group()


def start_parallel_subprocesses(dev: torch.device, work: str) -> dict:
    """phase_parallel's subprocesses, started a few phases early (each
    takes ~8 s to reach the card): (a)'s two gloo ranks and (f)'s
    tools/bench_scale_head. {tag: (process, log file[, out path])}."""
    import os
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    out = {}
    for rank in range(2):
        path = os.path.join(work, f"dp_rank{rank}.pt")
        code = f"import chip_smoke; chip_smoke.dp_worker({rank}, 2, {port}, {path!r}, {str(dev)!r})"
        out[f"rank{rank}"] = (*cli_subprocess(dev, work, f"dp_rank{rank}", ["-c", code], module=None), path)
    out["scale_head"] = cli_subprocess(dev, work, "scale_head", [str(SCALE_HEAD_STEPS), "0.15", "0", "--eval_frames",
                                                                 str(SCALE_HEAD_FRAMES)],
                                       module="ntm_tracker_tpu_torch.tools.bench_scale_head")
    return out


def start_bench_tools(dev: torch.device, work: str, after: list) -> tuple:
    """phase_bench's (b): tools/bench_train, tools/bench_bptt_knee and
    tools/profile_train at BENCH_TOOLS' sizes, each a CLI subprocess, run
    beside the accuracy and data phases: a thread starts them once the
    processes `after` (the parallel phase's ranks, whose train steps are
    timed) have exited, and join_bench_tools waits for them before the lab
    phase's timings.
    (thread, {tool: (process, log file)}, a list that gets the tools' start
    time), both filled by the thread."""
    import threading

    tools, started = {}, []

    def run():
        for proc in after:
            proc.wait()
        started.append(time.perf_counter())
        tools.update({tool: cli_subprocess(dev, work, tool, argv, module=f"ntm_tracker_tpu_torch.tools.{tool}")
                      for tool, argv in BENCH_TOOLS.items()})

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread, tools, started


def join_bench_tools(started_tools: tuple) -> dict:
    """Wait for start_bench_tools' subprocesses: {tool: (process, log file)}."""
    thread, tools, started = started_tools
    t0 = time.perf_counter()
    thread.join(timeout=max(10.0, BUDGET_S - (t0 - T_START)))
    if thread.is_alive():
        raise AssertionError("the parallel phase's ranks did not exit, so the bench tools never started")
    for proc, _ in tools.values():
        proc.wait(timeout=max(10.0, BUDGET_S - (time.perf_counter() - T_START)))
    log("bench", f"the tools started at t={started[0] - T_START:.1f}s (after the parallel ranks exited); "
                 f"waited {time.perf_counter() - t0:.1f}s for them after the data phase")
    check_budget("bench_tools_join")
    return tools


def bench_tool_expected(tool: str, line: dict) -> dict:
    """The launches a BENCH_TOOLS JSON line implies, by wrapper (B2's four,
    B1, B3). A train step through B2 at one LSTM layer: one projection, one
    forward, one backward, two reduction calls (the layer, then the head
    and output linears). Each line times 1 untimed + `--iters` (1) calls,
    bench_bptt_knee 1 + 3 passes."""
    def b2(steps):
        return {"token_projection": steps, "bptt_forward": steps, "bptt_backward": steps, "grad_reduce": 2 * steps}

    zero = {"ntm_scan_fused": 0, "token_projection": 0, "bptt_forward": 0, "bptt_backward": 0, "grad_reduce": 0,
            "fused_ntm_addressing": 0}
    if tool == "bench_train":
        return {**zero, **b2(2)}
    if tool == "bench_bptt_knee":
        return {**zero, **(b2(4) if line["path"] == "fused" else {})}
    variant = line["variant"]
    if variant == "fused_bptt_f32":
        return {**zero, **b2(2)}
    if variant == "fused_fwd_f32":  # B1 after its projection, B=8: the cluster route
        return {**zero, "ntm_scan_fused": 2, "token_projection": 2}
    if variant == "f32_pallas_fwd":  # B3 once a cell step, again in each checkpointed step's recompute
        return {**zero, "fused_ntm_addressing": 2 * 2 * 65}
    return zero


def grads_rel(got, ref) -> tuple:
    """(the largest of each gradient's max |got - ref| / max |ref|, its leaf)."""
    from ntm_tracker_tpu_torch.train.optim import tree_leaves

    rel = [max_abs(g, r) / max(float(r.abs().max()), 1e-30) for g, r in zip(tree_leaves(got), tree_leaves(ref))]
    i = int(np.argmax(rel))
    return rel[i], i


def phase_parallel(dev: torch.device, smi: str, root: str, procs: dict) -> dict:
    """Data parallelism and the scan knobs at TrackerConfig()'s width, in
    the data phase's tree (`root`): (a) the two gloo ranks (dp_worker,
    started early), each over PAR_SHARDS shards: bit-equal to each other,
    against one process at the global batch in one chunk, B2 once a shard
    a step a rank; (b) train-offsets at world size 1 over NCCL against the
    run without --dist_*, every step's loss; (c) cache-features --shard
    over PAR_SHARDS shards against the float32 cache; (d) the fleet over
    PAR_SHARDS shards against the meshless one; (e) layout "dn" and remat
    "dots" against "nd" / "full" on the plain route, with peak memory, and
    "dn" with use_pallas through B3; (f) tools/bench_scale_head's JSON and
    launches."""
    import os

    from ntm_tracker_tpu_torch import cli
    from ntm_tracker_tpu_torch.config import TrainConfig
    from ntm_tracker_tpu_torch.models.ntm_cell import init_ntm_params
    from ntm_tracker_tpu_torch.models.vgg import init_vgg_params
    from ntm_tracker_tpu_torch.models.ntm_tracker import ntm_tracker_unroll
    from ntm_tracker_tpu_torch.ops.kernels.addressing import fused_ntm_addressing
    from ntm_tracker_tpu_torch.parallel.mesh import Mesh, parallel_train_step
    from ntm_tracker_tpu_torch.tracking.fleet import FleetTracker
    from ntm_tracker_tpu_torch.train.experiments import OffsetExperiment, gradient_step
    from ntm_tracker_tpu_torch.train.optim import tree_leaves

    t_phase = time.perf_counter()
    d = str(dev)
    parser = cli.build_parser()
    out, counts = {}, {}

    # ---- (a) two gloo ranks on the card against one process -------------------------
    cfg = dp_config()
    exp = OffsetExperiment(cfg, None, device=dev)
    params, opt_state = exp.init(torch.Generator().manual_seed(DP_SEED))
    batch = dp_batch(cfg, dev)
    single = parallel_train_step(exp, Mesh((dev,)), keep_grads=True)
    ref_losses, ref_grads = [], []
    reset_all_counts()
    for _ in range(DP_STEPS):
        params, opt_state, m = single(params, opt_state, batch)
        ref_losses.append(float(m["loss"]))
        ref_grads.append(m["grads"])
    counts["parallel_single_process"] = kernel_launches()
    ranks = []
    for r in range(2):
        proc, log_f, path = procs[f"rank{r}"]
        finish_subprocess(f"dp_rank{r}", proc, log_f, timeout=max(10.0, BUDGET_S - (time.perf_counter() - T_START)))
        ranks.append(torch.load(path, weights_only=False))
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(ranks[0]["params"]), tree_leaves(ranks[1]["params"])))
    same = same and ranks[0]["losses"] == ranks[1]["losses"] and all(
        torch.equal(a, b) for s in range(DP_STEPS) for a, b in zip(tree_leaves(ranks[0]["grads"][s]),
                                                                    tree_leaves(ranks[1]["grads"][s])))
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"], ref_losses)]
    grad_rel = [grads_rel(ranks[0]["grads"][s], [g.cpu() for g in tree_leaves(ref_grads[s])])[0]
                for s in range(DP_STEPS)]
    per_rank = {f"rank{r}": ranks[r]["counts"] for r in range(2)}
    n = DP_STEPS * PAR_SHARDS
    expected = {"bptt_forward": n, "bptt_backward": n, "grad_reduce": 2 * n, "token_projection": n,
                "ntm_scan_fused": 0}
    log("parallel", f"{smi}: (a) 2 gloo ranks on {ranks[0]['device']} ({ranks[0]['backend']}, world "
                    f"{ranks[0]['world']}, mesh {ranks[0]['mesh']}), {DP_STEPS} steps at B={DP_B // 2} a rank "
                    f"({DP_B // 2 // PAR_SHARDS} a shard) of a "
                    f"global {DP_B}, L={DP_L} (T={DP_L * 65}): ranks bit-equal {same}; losses {ranks[0]['losses']} "
                    f"against one process {ref_losses}: rel {[f'{x:.2e}' for x in loss_rel]} (tol {F32_TOL:g}); "
                    f"pre-clip gradients rel {[f'{x:.2e}' for x in grad_rel]} of their largest (tol {GRAD_TOL:g}); "
                    f"step ms rank 0 {[round(x, 2) for x in ranks[0]['ms']]}, rank 1 "
                    f"{[round(x, 2) for x in ranks[1]['ms']]}; launches a rank {per_rank}")
    if not same or max(loss_rel) > F32_TOL or max(grad_rel) > GRAD_TOL or dev.type == "cuda" and any(
            {k: c[k] for k in expected} != expected for c in per_rank.values()):
        raise AssertionError(f"the two ranks: bit-equal {same}, loss rel {loss_rel}, grads rel {grad_rel}, launches "
                             f"{per_rank} (expected {expected} a rank)")
    counts.update({f"parallel_gloo_{k}": c for k, c in per_rank.items()})
    out["gloo"] = {"loss_rel": loss_rel, "grad_rel": grad_rel, "ms": {k: ranks[r]["ms"] for r, k in
                                                                      enumerate(per_rank)}}
    del exp, params, opt_state, batch, ref_grads
    check_budget("parallel_gloo")

    cwd = os.getcwd()
    os.chdir(root)
    try:
        # ---- (b) train-offsets over NCCL at world size 1 ------------------------------
        import socket

        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
        sock.close()
        common = ["--device", d, "train-offsets", "--sequences_dir", "cropped", "--sequence_length", str(DP_L),
                  "--batch_size", str(DATA_B), "--feature_cache", "cache_float16", "--num_epochs", "2",
                  "--log_interval", "1", "--validation_interval", "1000"]
        runs = {}
        for tag, extra in (("plain", []), ("nccl", ["--dist_coordinator", f"127.0.0.1:{port}",
                                                    "--dist_num_processes", "1", "--dist_process_id", "0"])):
            reset_all_counts()
            run = cli.train_offsets(parser.parse_args([*common, "--log_dir", f"log_par_{tag}", *extra]))
            recs = [json.loads(line) for line in open(os.path.join(run["log_dir"], "metrics.jsonl"))]
            runs[tag] = {"losses": [r["train_loss"] for r in recs if "train_loss" in r],
                         "val": [r["val_loss"] for r in recs if "val_loss" in r], "counts": kernel_launches(),
                         "backend": run["backend"], "world": run["world"], "steps": run["steps"]}
        rels = [abs(a - b) / abs(b) for a, b in zip(runs["nccl"]["losses"], runs["plain"]["losses"])]
        c = runs["nccl"]["counts"]
        log("parallel", f"{smi}: (b) train-offsets B={DATA_B} L={DP_L}, {runs['nccl']['steps']} steps: --dist_* at "
                        f"world {runs['nccl']['world']} over {runs['nccl']['backend']}: losses {runs['nccl']['losses']}, "
                        f"val {runs['nccl']['val']}; without: {runs['plain']['losses']}, val {runs['plain']['val']}; "
                        f"rel by step {[f'{x:.2e}' for x in rels]} (tol {PAR_LOSS_TOL:g}); launches {c}")
        steps = runs["nccl"]["steps"]
        if (runs["nccl"]["backend"] != ("nccl" if dev.type == "cuda" else "gloo") or max(rels) > PAR_LOSS_TOL
                or steps != runs["plain"]["steps"] or len(rels) != steps or steps < 2
                or len(runs["nccl"]["losses"]) != len(runs["plain"]["losses"])
                or not np.isfinite(runs["nccl"]["losses"]).all()
                or dev.type == "cuda" and ((c["bptt_forward"], c["bptt_backward"], c["grad_reduce"])
                                           != (steps, steps, 2 * steps) or c["ntm_scan_fused"] != len(runs["nccl"]["val"]))):
            raise AssertionError(f"train-offsets over NCCL: {runs}")
        counts["parallel_train_offsets_nccl"] = c
        out["nccl"] = {"loss_rel": rels, "losses": runs["nccl"]["losses"]}
        check_budget("parallel_nccl")

        # ---- (c) cache-features --shard --------------------------------------------
        from ntm_tracker_tpu_torch.parallel import mesh as mesh_mod

        records = sum(n * objects for _, _, _, n, objects in DATA_SEQS)
        # the CLI splits over every local card: the one card stands in for
        # PAR_SHARDS of them, so the build runs PAR_SHARDS shards on it
        real_local, real_make, built = mesh_mod.local_devices, mesh_mod.make_mesh, []
        mesh_mod.local_devices = lambda device=None: [dev] * PAR_SHARDS
        mesh_mod.make_mesh = lambda *a, **k: built.append(real_make(*a, **k)) or built[-1]
        t0 = time.perf_counter()
        try:
            cli.cache_features(parser.parse_args(["--device", d, "cache-features", "--sequences_dir", "cropped_f32",
                                                  "--cache_dir", "cache_shard32", "--store_dtype", "float32",
                                                  "--frames_per_batch", str(records), "--shard"]))
            torch.cuda.synchronize()
        finally:
            mesh_mod.local_devices, mesh_mod.make_mesh = real_local, real_make
        shard_s = time.perf_counter() - t0
        worst, scale, n_files = 0.0, 0.0, 0
        for sub, _, files in os.walk(os.path.join("cache_float32", "base")):
            for f in files:
                if f.endswith(".npy"):
                    ref = np.load(os.path.join(sub, f))
                    got = np.load(os.path.join("cache_shard32", os.path.relpath(os.path.join(sub, f), "cache_float32")))
                    worst, scale, n_files = max(worst, float(np.abs(got - ref).max())), max(scale, float(
                        np.abs(ref).max())), n_files + 1
        shard_rel = worst / max(scale, 1e-30)
        shards = [[str(x) for x in m.devices] for m in built]
        log("parallel", f"{smi}: (c) cache-features --shard over {shards} ({records} frames a batch), float32, base: "
                        f"{n_files} token files in {shard_s:.2f}s against the data phase's unsharded cache: rel max_abs "
                        f"{shard_rel:.2e} (tol {DATA_TOL:g})")
        if n_files == 0 or shard_rel > DATA_TOL or [len(m) for m in shards] != [PAR_SHARDS]:
            raise AssertionError(f"the sharded cache disagrees: {shard_rel:.2e} over {n_files} files, meshes {shards}")
        out["shard"] = {"rel": shard_rel, "files": n_files, "s": shard_s}
    finally:
        os.chdir(cwd)
    check_budget("parallel_shard")

    # ---- (d) the fleet over PAR_SHARDS shards of the card ---------------------------
    from ntm_tracker_tpu_torch.config import TrackerConfig

    tcfg = TrackerConfig()
    fcfg = dataclasses.replace(tcfg, fused_inference=True)
    gen = torch.Generator().manual_seed(0)
    vgg = init_vgg_params(gen, dev)
    nparams = init_ntm_params(tcfg.ntm, tcfg.input_depth, gen, dev)
    video, _ = synthetic_video(seed=5, frames=1 + PAR_FLEET_FRAMES, hw=FLEET_HW)
    regions = fleet_regions(PAR_FLEET_CAP)
    mesh = Mesh((dev,) * PAR_SHARDS)
    offsets = {}
    # "half": a meshless fleet of the first shard's slots, which that shard
    # should match bit for bit (the same batch)
    half = PAR_FLEET_CAP // PAR_SHARDS
    for tag, cap, kw in (("mesh", PAR_FLEET_CAP, {"mesh": mesh}), ("plain", PAR_FLEET_CAP, {"device": dev}),
                         ("half", half, {"device": dev})):
        reset_all_counts()
        fleet = FleetTracker(fcfg, vgg, nparams, capacity=cap, **kw)
        slots = [fleet.add(video[0], r) for r in regions[:cap]]
        stepped = [fleet.step({s: video[t] for s in slots}) for t in range(1, 1 + PAR_FLEET_FRAMES)]
        offsets[tag] = np.asarray([[out[s] for s in slots] for out in stepped])
        counts[f"parallel_fleet_{tag}"] = kernel_launches()
    fleet_err = float(np.abs(offsets["mesh"] - offsets["plain"]).max())
    half_err = float(np.abs(offsets["mesh"][:, :half] - offsets["half"]).max())
    log("parallel", f"{smi}: (d) FleetTracker(mesh={[str(x) for x in mesh.devices]}) capacity "
                    f"{PAR_FLEET_CAP}, {PAR_FLEET_FRAMES} frames at {FLEET_HW[0]}x{FLEET_HW[1]}: the first shard against "
                    f"a meshless fleet of its {half} slots max_abs {half_err:.3e} px (tol {F32_TOL:g}); the whole "
                    f"against the meshless fleet of {PAR_FLEET_CAP} max_abs {fleet_err:.3e} px (tol {REGION_TOL_PX:g}); "
                    f"launches {counts['parallel_fleet_mesh']}")
    if half_err > F32_TOL or fleet_err > REGION_TOL_PX or not np.isfinite(offsets["mesh"]).all() or \
            dev.type == "cuda" and \
            counts["parallel_fleet_mesh"]["ntm_scan_fused"] != PAR_FLEET_CAP + PAR_SHARDS * PAR_FLEET_FRAMES:
        raise AssertionError(f"the sharded fleet disagrees: {fleet_err:.3e} (first shard {half_err:.3e}), "
                             f"{counts['parallel_fleet_mesh']}")
    out["fleet"] = {"max_abs_px": fleet_err, "first_shard_vs_half_fleet_px": half_err}
    del vgg, nparams, video
    check_budget("parallel_fleet")

    # ---- (e) layout "dn" and remat "dots" on the plain route --------------------------
    knobs = {}
    batch = dp_batch(tcfg, dev, n=PAR_KNOB_B * PAR_KNOB_L, seed=DP_SEED + 1)
    # the first step measured reads a low peak whatever its knobs (an order
    # effect, PERF.md): "dn" goes first, "full" and "dots" after it
    for layout, remat, tag in (("dn", "full", "dn/full"), ("nd", "full", "nd/full"), ("nd", "dots", "nd/dots")):
        kcfg = dataclasses.replace(tcfg, train=TrainConfig(batch_size=PAR_KNOB_B, sequence_length=PAR_KNOB_L,
                                                            fused_bptt=False, scan_layout=layout, remat_policy=remat))
        kexp = OffsetExperiment(kcfg, None, device=dev)
        kp, ko = kexp.init(torch.Generator().manual_seed(3))
        kstep = gradient_step(kexp.loss_fn, kexp.optimizer(), keep_grads=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        _, _, m = kstep(kp, ko, batch)
        torch.cuda.synchronize()
        knobs[tag] = {"loss": float(m["loss"]), "grads": m["grads"], "ms": (time.perf_counter() - t0) * 1e3,
                      "peak_mb": (torch.cuda.max_memory_allocated() - base) / 1e6}
    ref = knobs["nd/full"]
    for k, v in knobs.items():
        v["loss_rel"] = abs(v["loss"] - ref["loss"]) / abs(ref["loss"])
        v["grad_rel"] = grads_rel([g for g in tree_leaves(v["grads"])], tree_leaves(ref["grads"]))[0]
    log("parallel", f"{smi}: (e) one plain-route train step at B={PAR_KNOB_B} L={PAR_KNOB_L} (T={PAR_KNOB_L * 65}) "
                    f"by layout/remat against nd/full: " + "; ".join(
                        f"{k} loss rel {v['loss_rel']:.2e}, grads rel {v['grad_rel']:.2e}, {v['ms']:.1f} ms, peak "
                        f"{v['peak_mb']:.1f} MB above the inputs" for k, v in knobs.items())
                    + f" (tol {F32_TOL:g} / {GRAD_TOL:g})")
    if any(v["loss_rel"] > F32_TOL or v["grad_rel"] > GRAD_TOL for v in knobs.values()):
        raise AssertionError("layout dn / remat dots disagree with nd / full")
    out["knobs"] = {tag: {k: v[k] for k in ("loss_rel", "grad_rel", "ms", "peak_mb")} for tag, v in knobs.items()}
    del knobs, ref, batch
    # "dn" runs the "nd" step, so use_pallas sends its addressing to B3
    T = PAR_KNOB_L * 65
    kparams, ktokens, _ = scan_case(tcfg.ntm, PAR_KNOB_B, T, 361, dev, tcfg.input_depth)
    reset_all_counts()
    zero_launches(fused_ntm_addressing)
    with torch.no_grad():
        _, dn_logits, _ = ntm_tracker_unroll(kparams, dataclasses.replace(tcfg.ntm, use_pallas=True), ktokens,
                                             remat=False, layout="dn")
        counts["parallel_dn_use_pallas"] = kernel_launches()
        _, nd_logits, _ = ntm_tracker_unroll(kparams, tcfg.ntm, ktokens, remat=False, layout="nd")
    dn_err = max_abs(dn_logits, nd_logits)
    log("parallel", f"{smi}: (e) layout dn with use_pallas at B={PAR_KNOB_B} T={T}: B3 launches "
                    f"{counts['parallel_dn_use_pallas']['fused_ntm_addressing']}, logits against the plain nd forward "
                    f"max_abs {dn_err:.3e} (tol {F32_TOL:g})")
    if dn_err > F32_TOL or dev.type == "cuda" and counts["parallel_dn_use_pallas"]["fused_ntm_addressing"] != T:
        raise AssertionError(f"layout dn with use_pallas: {dn_err:.3e}, {counts['parallel_dn_use_pallas']}")
    out["knobs"]["dn_use_pallas"] = {"max_abs": dn_err, "b3_launches": kernel_launches()["fused_ntm_addressing"]}
    del kparams, ktokens, dn_logits, nd_logits
    check_budget("parallel_knobs")

    # ---- (f) tools/bench_scale_head ---------------------------------------------------
    proc, log_f = procs["scale_head"]
    text = finish_subprocess("scale_head", proc, log_f, timeout=max(10.0, BUDGET_S - (time.perf_counter() - T_START)))
    lines = text.strip().splitlines()
    result = json.loads(lines[-1])
    parity = [ln for ln in lines if ln.startswith("fused-kernel O=3 parity")]
    launches = json.loads(next(ln for ln in lines if ln.startswith("launches: "))[len("launches: "):])
    keys = {"steps", "scale_range", "offsets_only", "predict_scale"}
    log("parallel", f"{smi}: (f) bench_scale_head {SCALE_HEAD_STEPS} steps a head, {SCALE_HEAD_FRAMES}-frame clips: "
                    f"{parity}; offsets_only {result['offsets_only']}; predict_scale "
                    f"{ {k: v for k, v in result['predict_scale'].items() if k not in ('diag',)} }, diag "
                    f"{result['predict_scale']['diag']}; launches {launches}")
    if set(result) != keys or len(parity) != 1 or dev.type == "cuda" and (
            launches["ntm_scan_fused"] == 0 or launches["bptt_forward"] != 2 * SCALE_HEAD_STEPS):
        raise AssertionError(f"bench_scale_head: keys {set(result)}, parity {parity}, launches {launches}")
    counts["parallel_scale_head"] = launches
    out["scale_head"] = result
    out["counts"] = counts
    out["s"] = time.perf_counter() - t_phase
    log("parallel", f"the phase in {out['s']:.1f}s (its subprocesses started before the accuracy phase)")
    check_budget("parallel")
    return out


def phase_bench(dev: torch.device, smi: str, tools: dict) -> dict:
    """The bench path: (a) benchmarks.main in-process at BENCH_KW, its JSON
    line parsed from its stdout and held (every JAX key, in the JAX order;
    the headline, the B=1 roundtrip, the train step and the device loop
    finite and positive; both MFUs in (0, 1]; B1 once a B=1 frame on the
    cluster route, B2 once a train step; no B3); (b) the three tools
    started by start_bench_tools: rc 0, one JSON line a mode, path or
    variant, no error, each line's launches as bench_tool_expected says."""
    import contextlib
    import io
    import math

    from ntm_tracker_tpu_torch import benchmarks
    from ntm_tracker_tpu_torch.ops.kernels.addressing import fused_ntm_addressing

    t0 = time.perf_counter()
    reset_all_counts()
    zero_launches(fused_ntm_addressing)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        returned = benchmarks.main(device=dev, deadline=time.time() + 3600, **BENCH_KW)
    counts = benchmarks.kernel_launches()
    bench_s = time.perf_counter() - t0
    lines = out.getvalue().strip().splitlines()
    result = json.loads(lines[-1])
    frames = BENCH_KW["latency_frames"]
    steps = BENCH_KW["train_iters"] + 1
    b1 = 1 + 4 * frames  # the untimed frame, the roundtrip frames, three pipelined passes
    expected = {"ntm_scan_fused": b1, "ntm_scan_fused_by_route": {"cluster": b1, "tile": 0},
                "token_projection": b1 + steps, "bptt_forward": steps, "bptt_backward": steps,
                "grad_reduce": 2 * steps, "fused_ntm_addressing": 0}
    keys = [k for k in result if k in JAX_BENCH_KEYS]
    positive = {k: result[k] for k in ("value", "p50_roundtrip_ms_b1", "train_step_ms_cached",
                                       "device_loop_frames_per_sec")}
    fractions = {k: result[k] for k in ("mfu", "train_mfu")}
    log("bench", f"{smi}: benchmarks.main({', '.join(f'{k}={v}' for k, v in BENCH_KW.items())}) in {bench_s:.1f}s: "
                 f"{lines[-1]}")
    log("bench", f"launches {counts} (expected {expected}: B1 once a B=1 frame on the cluster route, after its "
                 f"projection; B2 once a train step, {steps} steps; the sweep and the device loop at B >= 128 run the "
                 f"plain cell loop by the rule)")
    failed = []
    if result != returned or len(lines) != 1:
        failed.append(f"{len(lines)} stdout lines, or the printed line is not main's result")
    if keys != list(JAX_BENCH_KEYS):
        failed.append(f"the JAX keys in order: {keys}")
    if not all(isinstance(v, (int, float)) and math.isfinite(v) and v > 0 for v in positive.values()):
        failed.append(f"not finite and positive: {positive}")
    if not all(isinstance(v, float) and 0 < v <= 1 for v in fractions.values()):
        failed.append(f"MFU outside (0, 1]: {fractions}")
    if result["platform"] != "gpu" or not result["card"] or not result["power_limit"] or result["budget_skipped"]:
        failed.append("platform, card, power limit or a skipped phase")
    if counts != expected:
        failed.append(f"launches {counts}")

    # (b) the tools, run beside the accuracy and data phases
    tool_lines = {}
    for tool, (proc, log_f) in tools.items():
        text = finish_subprocess(tool, proc, log_f)
        got = [json.loads(line) for line in text.splitlines() if line.startswith("{")]
        want = {"bench_train": 2, "bench_bptt_knee": 2, "profile_train": 5}[tool]
        tool_lines[tool] = got
        for line in got:
            launches = {k: v for k, v in line["launches"].items() if k != "ntm_scan_fused_by_route"}
            exp = bench_tool_expected(tool, line)
            if "error" in line or launches != exp:
                failed.append(f"{tool}: {line} (expected launches {exp})")
        tag = {"bench_train": "mode", "bench_bptt_knee": "path", "profile_train": "variant"}[tool]
        log("bench", f"{smi}: tools/{tool}.py {' '.join(BENCH_TOOLS[tool])}: "
                     + "; ".join(f"{line[tag]} {line.get('step_ms', line.get('grad_step_ms'))} ms, launches "
                                 + json.dumps({k: v for k, v in line['launches'].items() if v and k != 'ntm_scan_fused_by_route'})
                                 for line in got))
        if len(got) != want:
            failed.append(f"{tool}: {len(got)} JSON lines, expected {want}")
    fused_fwd = next(line for line in tool_lines["profile_train"] if line["variant"] == "fused_fwd_f32")
    if fused_fwd["launches"]["ntm_scan_fused_by_route"] != {"cluster": 2, "tile": 0}:
        failed.append(f"profile_train fused_fwd_f32 ran B1's routes {fused_fwd['launches']['ntm_scan_fused_by_route']}")
    log("bench", f"phase {time.perf_counter() - t0:.1f}s (the bench {bench_s:.1f}s; the tools ran beside the accuracy "
                 f"and data phases, so their ms are taken on a shared card)")
    if failed:
        raise AssertionError(f"bench phase: {failed}")
    check_budget("bench")
    return {"result": result, "counts": counts, "tools": tool_lines, "seconds": time.perf_counter() - t0}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr, flush=True)
        return 2

    from ntm_tracker_tpu_torch import _build
    from ntm_tracker_tpu_torch.config import NTMConfig, TrackerConfig
    from ntm_tracker_tpu_torch.models.ntm_cell import init_ntm_params, init_ntm_state
    from ntm_tracker_tpu_torch.models.vgg import extract_features, init_vgg_params, vgg16_features
    from ntm_tracker_tpu_torch.ops.kernels.scan_bptt import token_projection
    from ntm_tracker_tpu_torch.ops.kernels.scan_cell import (
        CLUSTER_WAVES, flatten_state, ntm_scan_fused, ntm_scan_fused_reference, run_route,
    )
    from ntm_tracker_tpu_torch.tracking.tracker import StreamingTracker
    from ntm_tracker_tpu_torch.train.experiments import frame_tokens

    dev = torch.device("cuda")
    cpu_pool = start_cpu_pool()
    # the bptt phase's plain references, in the CPU pool from now
    bptt_plain = start_bptt_references(TrackerConfig().input_depth, cpu_pool)

    # ---- 1. device ---------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log("device", f"torch {torch.__version__} cuda {torch.version.cuda}; {kind}; nvidia-smi: {smi}")
    check_budget("device")
    # the serving phase's exports need no kernel: CLI subprocesses from now on
    import tempfile

    serve_work = tempfile.mkdtemp(prefix="ntm_serve_exports_")

    # ---- 2. build ----------------------------------------------------------
    # one nvcc per library: B1's, B2's and B3's together, then B4's three
    # together (scan_packed.cu: its forward, its backward, their probe
    # variants; PACKED_LIBRARIES), needed first by the packed phase (with
    # all six, the serving exports and the CPU workers beside it, the main
    # thread's plain step ran 1.6x slower); meanwhile the train phase's
    # inputs and its plain step at the main path's shape, plain PyTorch on
    # the idle card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    def build_niced(names, nice):
        # Linux keeps a nice value per thread, and the compilers inherit
        # this thread's: the plain step's host dispatch, and later the
        # phases', goes first, then B1's, B2's and B3's compilers, then
        # B4's (needed a few phases later)
        os.setpriority(os.PRIO_PROCESS, 0, nice)
        return _build.build_all(names)

    compile_pool = ThreadPoolExecutor(1)
    built = compile_pool.submit(build_niced, ["scan_cell", "scan_bptt", "addressing"], BUILD_NICE)
    built_packed = compile_pool.submit(build_niced, list(PACKED_LIBRARIES), LATER_NICE)
    compile_pool.shutdown(wait=False)
    ref = train_reference(dev)
    ref_s = time.perf_counter() - t0
    paths = built.result()
    for name in paths:
        _build.load_library(name)
    log("build", f"B1's, B2's and B3's libraries ready in {time.perf_counter() - t0:.2f}s (parallel nvcc, B4's "
                 f"next; {', '.join(p.name for p in paths.values())}); the train phase's batch and plain "
                 f"B={TRAIN_B} step meanwhile in {ref_s:.2f}s (the step {ref['plain']['step_ms'] / 1e3:.2f}s)")
    check_budget("build")
    # the accuracy phase's DNC check: its CPU side in the CPU pool from now
    dnc = start_dnc_check(dev, cpu_pool)

    # ---- 3. kernel vs plain version on the card ----------------------------
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
        before = kernel_launches()["ntm_scan_fused_by_route"]
        run = (functools.partial(ntm_scan_fused, params, ncfg, toks, state, compute_dtype=cd) if forced is None
               else functools.partial(run_route, forced, params, ncfg, toks, state, cd))
        logits, final = run()
        torch.cuda.synchronize()
        route = [r for r, n in kernel_launches()["ntm_scan_fused_by_route"].items() if n != before[r]]
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
    before = kernel_launches()["ntm_scan_fused"]
    logits0, state0 = ntm_scan_fused(params, ncfg, toks[:, :0], state)
    if (state0 is not state or tuple(logits0.shape) != (1, 0, ncfg.output_dim)
            or kernel_launches()["ntm_scan_fused"] != before):
        raise AssertionError("T=0 must echo the state without a launch")
    log("kernel", "T=0 echo ok")
    check_budget("kernel")

    # ---- 3b. the training kernels (B2) vs their plain version -----------------
    bptt_tiles = phase_bptt(dev, IN, bptt_plain)
    del bptt_plain
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
    fp = frame_path(cfg, vgg, params, video, region0, dev)
    trk, plain_cfg, crop, cropboxes = fp["trk"], fp["plain_cfg"], fp["crop"], fp["cropboxes"]
    main_path_launches, frame_routes, frame_proj = fp["launches"], fp["routes"], fp["proj"]
    log("frame", f"StreamingTracker full width: init + {n_track} frames, launches per frame "
                 f"{np.diff([0] + fp['per_frame']).tolist()} (B1 by route {frame_routes}, projections {frame_proj}), "
                 f"offsets[-1]={fp['offsets'][-1].tolist()} "
                 f"region[-1]={[round(float(v), 2) for v in fp['regions'][-1]]}; "
                 f"fused vs plain loop on the same crops: max_abs(offsets)={fp['off_err']:.3e} tol={F32_TOL:g}")

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

    # ---- 4a. the JAX package's orbax checkpoint: read, resumed, served -------
    orbax = phase_orbax(dev, smi)

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
    train = phase_train(dev, smi, IN, ref)

    # ---- 7b. the lane-packed kernels (B4) at the frame and train shapes -------
    for name in built_packed.result():
        _build.load_library(name)
    log("build", f"B4's libraries ready at t={time.perf_counter() - T_START:.1f}s")
    packed = phase_packed(dev, smi, IN, train, cpu_pool)

    import shutil
    import tempfile

    # ---- 7c. the accuracy path: training learns, the trackers track ---------
    # ---- 7d. the real-data path: preprocess, cache-features, train-offsets ----
    # ---- 7e. the experiment lab, on the data path's tree and token cache -----
    # ---- 7f. serving and evaluation, on the same tree -----------------------
    # ---- 7g. data parallelism and the scan knobs, on the same tree ---------
    # the parallel phase's ranks, then the bench tools, run beside the
    # accuracy and data phases, which put no timing into the kernels line
    tree = tempfile.mkdtemp(prefix="ntm_data_")
    par_work = tempfile.mkdtemp(prefix="ntm_parallel_")
    try:
        # the subprocesses share the card: hand back this process's cached blocks
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info(dev)
        log("accuracy", f"before the subprocesses: {free / 1e9:.1f} GB free of {total / 1e9:.1f} GB, this process "
                        f"{torch.cuda.memory_reserved(dev) / 1e9:.2f} GB reserved")
        par_procs = start_parallel_subprocesses(dev, par_work)
        serve_exports = start_serving_exports(dev, serve_work)
        bench_tools = start_bench_tools(dev, par_work, [par_procs[f"rank{r}"][0] for r in range(2)])
        accuracy = phase_accuracy(dev, smi, dnc)
        data = phase_data(dev, smi, tree, cpu_pool)
        bench_tools = join_bench_tools(bench_tools)
        trax_servers = start_trax_servers(dev, serve_work, serve_exports)
        lab = phase_lab(dev, smi, tree)
        serving = phase_serving(dev, smi, tree, serve_exports, trax_servers)
        parallel = phase_parallel(dev, smi, tree, par_procs)
        # ---- 7h. the bench subcommand and the measurement tools ------------
        bench = phase_bench(dev, smi, bench_tools)
    finally:
        shutil.rmtree(tree, ignore_errors=True)
        shutil.rmtree(serve_work, ignore_errors=True)
        shutil.rmtree(par_work, ignore_errors=True)
    # the packed phase's referee, computed beside the phases since
    packed["initial_state_referee"] = packed.pop("referee")()
    check_budget("packed_referee_join")
    data_counts = {"data_cached_train": data["cached"]["counts"], "data_raw_host_resize":
                   data["raw"]["host_resize"]["counts"], "data_raw_device_resize": data["raw"]["device_resize"]["counts"],
                   "data_resume": data["resumed"]["counts"], "data_orbax_resume": data["orbax_resume"]["counts"]}
    lab_counts = {f"lab_{k}": c for k, c in lab["counts"].items()}
    serving_counts = serving["counts"]
    parallel_counts = parallel["counts"]
    # the bench path's launches: benchmarks.main's, and each tool line's
    tag_of = {"bench_train": "mode", "bench_bptt_knee": "path", "profile_train": "variant"}
    bench_counts = {"bench": bench["counts"], **{f"{tool}_{line[tag_of[tool]]}": line["launches"]
                                                 for tool, lines in bench["tools"].items() for line in lines}}

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
                             "accuracy_flagship_train": accuracy["flagship"]["counts"]["ntm_scan_fused"],
                             "orbax_tracker": orbax["tracker_counts"]["ntm_scan_fused"],
                             "orbax_resumed_step": orbax["step_counts"]["ntm_scan_fused"],
                             **{k: c["ntm_scan_fused"] for k, c in data_counts.items()},
                             **{k: c["ntm_scan_fused"] for k, c in lab_counts.items()},
                             **{k: c["ntm_scan_fused"] for k, c in serving_counts.items()},
                             **{k: c["ntm_scan_fused"] for k, c in parallel_counts.items()},
                             **{k: c["ntm_scan_fused"] for k, c in bench_counts.items()}},
        "route_by_path": {"frame_step": frame_routes, "fleet": fleet["fleet_routes"],
                          "device_loop": {"cluster": 0, "tile": 0}, "train": train["eval_routes"],
                          "orbax_tracker": orbax["tracker_counts"]["ntm_scan_fused_by_route"],
                          **{k: c["ntm_scan_fused_by_route"] for k, c in data_counts.items()},
                          **{k: c["ntm_scan_fused_by_route"] for k, c in lab_counts.items()},
                          **{k: c["ntm_scan_fused_by_route"] for k, c in parallel_counts.items()},
                          **{k: c["ntm_scan_fused_by_route"] for k, c in bench_counts.items()}},
        "lab_dashboard_chunks": lab["save_imgs"]["chunks"],
        "ms_by_route": {"T65": {str(B): v for B, v in by_route.items()},
                        f"B{train['b1']['B']}_T{train['b1']['T']}": train["b1"]["ms_by_route"]},
        "routes_in_kernel_cases": case_routes, "cluster": cluster, "tile_route_source": BPTT_SOURCE,
        "cluster_step_us": step_us, "projection_ms_b1": proj_ms, "cluster_waves": CLUSTER_WAVES,
        "train_shape": {k: v for k, v in train["b1"].items() if k != "launches"},
        "serving": {k: v for k, v in serving.items() if k != "counts"},
        "parallel": {k: v for k, v in parallel.items() if k != "counts"},
        "bench": {k: bench["result"][k] for k in BENCH_MEASURED}, "bench_phase_s": bench["seconds"],
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
            "launches_on_data_path": {k: c[launches] for k, c in data_counts.items()},
            "launches_on_orbax_path": {"orbax_resumed_step": orbax["step_counts"][launches],
                                       "orbax_tracker": orbax["tracker_counts"][launches]},
            "launches_on_lab_path": {k: c[launches] for k, c in lab_counts.items()},
            "launches_on_serving_path": {"serving_profile_train": serving_counts["serving_profile_train"][launches]},
            "launches_on_parallel_path": {k: c[launches] for k, c in parallel_counts.items()},
            "launches_on_bench_path": {k: c[launches] for k, c in bench_counts.items()},
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
                             "device_loop": fleet["loop_counts"]["fused_ntm_addressing"],
                             **{k: c.get("fused_ntm_addressing", 0) for k, c in serving_counts.items()},
                             "parallel_dn_use_pallas": parallel_counts["parallel_dn_use_pallas"]["fused_ntm_addressing"],
                             **{k: c["fused_ntm_addressing"] for k, c in bench_counts.items()}},
        "max_abs_err": addr["max_abs_err"], "grad_max_abs_err": addr["grad_err"], "ms": at64["ms"],
        "plain_ms": at64["plain_ms"], "bound_ms": at64["bound_ms"], "bound_by": at64["bound_by"], "library_ms": None,
        "device_ms": at64["device_ms"],
        "times_by_batch": {str(b): t for b, t in addr["times"].items()},
        "phases": addr["probe"]["phases"], "sm_clock_khz": addr["probe"]["sm_clock_khz"],
        "empty_launch_ms": addr["probe"]["empty_launch_ms"],
    })
    # B4 at B=256 and the rule's tiles, at T=PACKED_PLAIN_T beside its plain
    # version on the same inputs (the train path's T=1300 under
    # at_train_shape). No
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
            "plain_ms": None, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "rows_per_block": rows, "ms_rows_1": packed["ms"][name][1], "row_kernel_ms": row_ms,
            "ms_by_rows_per_block": {str(r): v for r, v in packed["ms"][name].items()},
            "B": packed["B"], "T": packed["T"], "tile_rule": packed["rule_by_batch"],
            "need_dtokens_ms": need_dtokens_ms, "initial_state_vs_float64": packed["initial_state_referee"],
            "projection_launches_on_path": packed["counts"]["token_projection"],
        }
        if name != "forward_residuals":
            entry["phases"] = packed["probe"][name]
        if name != "backward":
            entry["with_projection_ms"] = entry["ms"] + train["token_projection"][0]
        # the kernel, its plain version and the bound on the same inputs at
        # T=PACKED_PLAIN_T; the train shape's times under at_train_shape
        sh = packed["short"]
        entry["at_train_shape"] = {k: entry.pop(k) for k in ("ms_rows_1", "row_kernel_ms", "ms_by_rows_per_block",
                                                             "with_projection_ms") if k in entry}
        entry["at_train_shape"].update({k: entry[k] for k in ("B", "T", "ms", "bound_ms", "bound_by")})
        entry.update({"T": sh["T"], "ms": sh["ms"][name], "plain_ms": sh["plain_ms"][name],
                      "bound_ms": sh["bounds"][name][0], "bound_by": sh["bounds"][name][1]})
        if name == "forward":
            entry["frame_shape"] = packed["frame"]
        if name == "backward":
            entry["reduction_ms"] = {"packed_operands": packed["ms"]["reduction"],
                                     "row_kernels": train["grad_reduce"][0],
                                     "packed_operands_weight_grads": packed["ms"]["reduction_weight_grads"]}
            entry["peak_gb"] = {"rows_1": at[(1, 1)]["peak_gb"], f"rows_{rows}": at[default]["peak_gb"]}
            entry["smem_bytes"] = packed["smem"]
        kernels.append(entry)
    # B2 on the lab's paths: its first steps against the plain route, and
    # the shapes it ran
    bptt["backward"]["lab_first_steps"] = {k: {f: v["check"][f] for f in ("loss_rel", "grad_rel", "ms", "plain_ms")}
                                           for k, v in lab.items() if isinstance(v, dict) and "check" in v}
    step_ms = bench["result"]["train_step_ms_cached"]
    log("train", f"{smi}: the train step at B={train['b1']['B']} T={train['b1']['T']} (the bench's): {step_ms:.2f} ms = "
                 f"{TRAIN_B * TRAIN_L / step_ms * 1e3:.1f} trained frames/s, peak {train['peak_gb']:.2f} GB")
    cpu_pool.shutdown()
    log("phases", json.dumps({"seconds": {k: round(v, 2) for k, v in PHASE_S.items()},
                              "total": round(time.perf_counter() - T_START, 2), "budget": BUDGET_S}))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
