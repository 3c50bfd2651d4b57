"""The headline benchmark: the `bench` subcommand's body (counterpart of
ntm_tracker_tpu/benchmarks.py, with its phases, sizes and JSON keys).

Reports throughput (tracked frames/s/card) from a batch sweep of the
frame step, the analytic model FLOPs per frame, achieved TFLOP/s and MFU
against the card's bf16 peak (the headline runs the VGG in bf16), two
latency numbers at B=1 (`pipelined_frame_ms_b1`, the steady-state time a
frame when frames are queued back to back, and the `*_roundtrip_ms_b1`
percentiles, each frame ending in a host read of its offsets), the
cached-token train step (B2, float32, TF32 off) with its MFU against the
card's float32 peak, and the device-resident loop's frames/s. One JSON
line, printed last on stdout; everything else goes to stderr.

    python -m ntm_tracker_tpu_torch bench          (the card; --device cpu: a tiny smoke)

Against the JAX bench:
  * `headline_variant` is always "weights-as-args", and
    `frames_per_sec_weights_as_args` equals `value`: the JAX bench re-ran
    its best batch with the weights compiled in as constants (XLA constant
    folding, in a child process with a persistent compile cache). Eager
    PyTorch has no such program, so there is nothing to re-measure.
  * The sweep's ceiling is also capped by memory: the frame step's
    activation bytes per frame (`frame_activation_bytes`) against 80% of
    the card's free memory. No out-of-memory error is caught.
  * No phase catches a failure: a kernel that fails to build or launch
    raises, and `bench` exits non-zero.
  * The regression tripwire reads the newest BENCH_r*.json as JAX's does,
    but compares only with a record of this card (platform "gpu", the
    same device_kind); the repo's BENCH_r*.json are TPU records.
  * The accuracy artifact goes to TRACK_BENCH.json at the repo root
    (tools/track_artifact.write_artifact; the card is recorded inside),
    after the JSON line, with NTM_TRACK_STEPS training steps (400).
The wall-clock budget (NTM_BENCH_BUDGET_S, 1500 s) gates each secondary
phase as in JAX, with the card's own phase estimates.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from ntm_tracker_tpu_torch.config import TrackerConfig, TrainConfig, resolve_device

# Wall-clock held back from the bench budget for the TRACK artifact
# (tools/track_artifact.py): its evaluation reserve for each of its three
# records (track_artifact._EVAL_RESERVE_S, 240 s) plus the NTM core's and
# the scale head's 400-step trainings, 31.0 s and 31.3 s in
# TRACK_H100.json (NVIDIA H100 80GB HBM3, 700.00 W). The DNC core's eager
# train step takes ~7.9 s there (3169.3 s for 400 steps), so under the
# default budget its record stops at the deadline (`budget_truncated`):
# the reserve is a floor, not a promise, as in JAX.
_TRACK_RESERVE_S = 3 * 240.0 + 31.0 + 31.3

# Each secondary phase's estimate in seconds on the card, with margin over
# the full bench run recorded in PERF.md (NVIDIA H100 80GB HBM3, 700.00 W:
# the cached train step 14.0 s, most of it the batch's host draws, since
# made on the card; the device loop at B=1024 18.5 s; the sweep over four
# batches 40.0 s).
_EST_S = {"cached_train": 25.0, "device_loop": 30.0, "sweep_batch": 30.0}

# Regression tripwire against the previous recorded bench of this card:
# if any field both runs measured drops by more than this fraction, bench
# exits non-zero after printing the JSON line and writing the artifact.
_REGRESSION_FRAC = 0.15

# higher-is-better fields the tripwire compares when both runs have them
_TRIPWIRE_FIELDS = (
    "value",
    "mfu",
    "frames_per_sec_weights_as_args",
    "device_loop_frames_per_sec",
    "train_frames_per_sec_cached",
    "train_mfu",
)

# value/mfu depend on the headline variant; a record of another variant is
# compared without them
_VARIANT_DEPENDENT = ("value", "mfu")

# The sweep's ceiling: the largest batch whose frame-step activations take
# at most this share of the card's free memory.
_MEMORY_SHARE = 0.8

# the sweep's first batch, and the cached train step's (B, L): the JAX bench's
SWEEP_START = 128
TRAIN_SHAPE = (256, 20)


def _latest_bench_record(root: str):
    """(round_n, path) of the newest BENCH_r*.json at `root`, or (0, None)."""
    import glob
    import re

    best_n, best_path = 0, None
    for f in glob.glob(os.path.join(root, "BENCH_r*.json")):
        m = re.search(r"BENCH_r(\d+)\.json$", f)
        if m and int(m.group(1)) > best_n:
            best_n, best_path = int(m.group(1)), f
    return best_n, best_path


def _previous_bench_metrics(root: str):
    """(round_n, metrics) from the newest BENCH_r*.json, or (None, None).
    A record holds {"parsed": {...}} when its JSON line was parsed;
    otherwise the line is in "tail" (possibly head-truncated) and the
    fields are recovered by regex."""
    import re

    best_n, best_path = _latest_bench_record(root)
    if best_path is None:
        return None, None
    try:
        with open(best_path) as f:
            rec = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None, None
    parsed = rec.get("parsed")
    if isinstance(parsed, dict):
        return best_n, parsed
    tail = rec.get("tail") or ""
    metrics = {}
    for key in _TRIPWIRE_FIELDS:
        hits = re.findall(
            rf'"{key}": (null|-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?)', tail)
        if hits and hits[-1] != "null":
            try:
                metrics[key] = float(hits[-1])
            except ValueError:
                pass
    variant = re.findall(r'"headline_variant": "([a-z-]+)"', tail)
    if variant:
        metrics["headline_variant"] = variant[-1]
    return best_n, metrics


def _bench_record_device(path: str):
    """(platform, device_kind) a BENCH_r*.json record names, from its parsed
    line or its tail; None where it names none."""
    import re

    with open(path) as f:
        rec = json.load(f)
    parsed = rec.get("parsed")
    if isinstance(parsed, dict):
        return parsed.get("platform"), parsed.get("device_kind")
    tail = rec.get("tail") or ""
    found = [re.findall(rf'"{key}": "([^"]*)"', tail) for key in ("platform", "device_kind")]
    return tuple(hits[-1] if hits else None for hits in found)


def _comparable_previous(root: str, platform: str, device_kind: str):
    """(round_n, metrics, note): the newest BENCH_r*.json's metrics when it
    records this platform and card, else metrics None and why."""
    prev_n, prev = _previous_bench_metrics(root)
    if prev is None:
        return prev_n, None, "no previous BENCH_r*.json"
    device = _bench_record_device(_latest_bench_record(root)[1])
    if device != (platform, device_kind):
        return prev_n, None, (f"no previous record of this card (BENCH_r{prev_n:02d} names platform {device[0]!r}, "
                              f"device_kind {device[1]!r})")
    return prev_n, prev, ""


def _bench_regressions(result: dict, prev: dict,
                       frac: float = _REGRESSION_FRAC) -> list:
    """[(field, prev, cur), ...] where a field both runs measured dropped
    by more than `frac` (all tripwire fields are higher-is-better)."""
    out = []
    for key in _TRIPWIRE_FIELDS:
        p, c = prev.get(key), result.get(key)
        if p is None or c is None:
            continue
        if p > 0 and c < p * (1.0 - frac):
            out.append((key, p, c))
    return out


# Dense peak TFLOP/s (no sparsity) by torch.cuda.get_device_name substring,
# from NVIDIA's H100 data sheet: bf16 on the tensor cores, float32 outside
# them (TF32 off).
_PEAK_TFLOPS = {
    "H100 80GB HBM3": {torch.bfloat16: 989.4, torch.float32: 67.0},  # SXM5
    "H100 PCIe": {torch.bfloat16: 756.0, torch.float32: 51.0},
}


def _chip_peak_tflops(device, dtype: torch.dtype = torch.bfloat16) -> float | None:
    """The card's dense peak TFLOP/s in `dtype` (bfloat16 or float32);
    `device` is a torch.device or a device name. None for an unknown card
    or a device that is not a card."""
    if isinstance(device, str):
        name = device
    else:
        device = torch.device(device)
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else ""
    for key, peaks in _PEAK_TFLOPS.items():
        if key in name:
            return peaks[dtype]
    return None


def _fast_conv43(cfg) -> bool:
    """Whether the frame step takes the receptive-field slice
    (vgg16_conv43_tokens: VALID convs on 204x204)."""
    return bool(getattr(cfg, "fast_conv43", False)) and cfg.feature_points is None and cfg.data.crop_size == 224


# the fast path's output side of each conv (valid convs on the 204x204 slice)
_FAST_SIDES = {
    "conv1/conv1_1": 202, "conv1/conv1_2": 200,
    "conv2/conv2_1": 98, "conv2/conv2_2": 96,
    "conv3/conv3_1": 46, "conv3/conv3_2": 44, "conv3/conv3_3": 42,
    "conv4/conv4_1": 19, "conv4/conv4_2": 17, "conv4/conv4_3": 15,
}


def _vgg_layers(cfg):
    """(in side, in channels, out side, out channels) of each conv from
    conv1_1 to conv4_3 on one crop."""
    from ntm_tracker_tpu_torch.models.vgg import VGG16_PREFIX

    fast = _fast_conv43(cfg)
    hw = cfg.data.crop_size
    side_in, in_ch = (204 if fast else hw), 3
    out = []
    for name, out_ch, has_pool in VGG16_PREFIX:
        side = _FAST_SIDES[name] if fast else hw
        out.append((side_in, in_ch, side, out_ch))
        in_ch = out_ch
        if name == "conv4/conv4_3":
            break
        if has_pool:
            hw //= 2
            side //= 2
        side_in = side
    return out


def frame_flops(cfg) -> float:
    """Analytic FLOPs of one tracked frame: VGG conv1..conv4_3 on the
    crop_size^2 crop + tokens_per_frame NTM cell steps (matmul terms; the
    elementwise/addressing tail is <1%). Accounts for the fast conv4 path
    (vgg16_conv43_tokens: VALID convs on the token grid's receptive
    field, 19/17/15 output sides at conv4 instead of 28)."""
    from ntm_tracker_tpu_torch.tools.profile_train import cell_step_flops

    total = 0.0
    for _, in_ch, side, out_ch in _vgg_layers(cfg):
        total += 2.0 * side * side * 9 * in_ch * out_ch  # 3x3 conv MACs x2
    total += cfg.tokens_per_frame * cell_step_flops(cfg)
    return total


def frame_activation_bytes(cfg) -> int:
    """Device bytes one crop holds at the frame step's peak, as
    models/vgg._conv_relu allocates them: the float32 crop, then at the
    largest conv its float32 input beside its output (bf16 compute: the
    bf16 product, its float32 copy plus the bias, and the ReLU's float32
    result, 2 + 4 + 4 bytes an element; float32: the product and the
    ReLU, 4 + 4). The cell loop's state is a few KB a row."""
    out_bytes = 10 if cfg.compute_dtype == torch.bfloat16 else 8
    crop = cfg.data.crop_size ** 2 * 3 * 4
    return crop + max(4 * s_in * s_in * c_in + out_bytes * s * s * c for s_in, c_in, s, c in _vgg_layers(cfg))


def sweep_ceiling(cfg, start: int, ceiling: int, free_bytes: int) -> int:
    """The sweep's largest batch: start doubled while it stays within
    `ceiling` and its frame-step activations (frame_activation_bytes) fit
    in _MEMORY_SHARE of `free_bytes`; at least `start`."""
    per_frame = frame_activation_bytes(cfg)
    B = start
    while 2 * B <= ceiling and 2 * B * per_frame <= _MEMORY_SHARE * free_bytes:
        B *= 2
    return B


def _headline_setup(device=None):
    """The headline benchmark's model: TrackerConfig's NTM core at bf16
    compute, VGG and cell weights from fixed seeds, on `device`."""
    from ntm_tracker_tpu_torch.models.core import make_core
    from ntm_tracker_tpu_torch.models.vgg import init_vgg_params

    dev = resolve_device(device)
    cfg = TrackerConfig(core="ntm", compute_dtype=torch.bfloat16,
                        train=TrainConfig(batch_size=1, sequence_length=20))
    core = make_core(cfg)
    vgg_params = init_vgg_params(torch.Generator().manual_seed(0), dev)
    params = core.init_params(torch.Generator().manual_seed(1), cfg.input_depth, dev)
    return cfg, core, vgg_params, params


def _sync(t: torch.Tensor) -> None:
    """Wait for the device and read a value of `t` on the host."""
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    t.reshape(-1)[:1].cpu()


def kernel_launches() -> dict:
    """The launch counts of the port's kernel wrappers: B1 (in all and by
    route), B2's four and B3."""
    from ntm_tracker_tpu_torch.ops.kernels import scan_bptt
    from ntm_tracker_tpu_torch.ops.kernels.addressing import fused_ntm_addressing
    from ntm_tracker_tpu_torch.ops.kernels.scan_cell import ntm_scan_fused

    out = {"ntm_scan_fused": ntm_scan_fused.launches, "ntm_scan_fused_by_route": dict(ntm_scan_fused.launches_by_route)}
    for name in ("token_projection", "bptt_forward", "bptt_backward", "grad_reduce"):
        out[name] = getattr(scan_bptt, name).launches
    out["fused_ntm_addressing"] = fused_ntm_addressing.launches
    return out


def launches_since(before: dict) -> dict:
    """kernel_launches() less an earlier reading of it."""
    now = kernel_launches()
    out = {k: v - before[k] for k, v in now.items() if k != "ntm_scan_fused_by_route"}
    out["ntm_scan_fused_by_route"] = {r: n - before["ntm_scan_fused_by_route"][r]
                                      for r, n in now["ntm_scan_fused_by_route"].items()}
    return out


def main(deadline: float | None = None, device=None, sweep_max: int = 4096, iters: int = 20,
         latency_frames: int = 50, train_iters: int = 10, device_loop_iters: int = 20,
         track_artifact: bool = True) -> dict:
    """Run the bench on `device` (cuda unless the caller passes another)
    and print its JSON line last on stdout; returns the line's dict. The
    keywords are the JAX bench's sizes: the sweep's ceiling (it starts at
    SWEEP_START), `iters` timed steps a pass (best of 3 passes), the B=1
    frames of the roundtrip percentiles (and of each pipelined pass), the
    cached train step's timed steps (at TRAIN_SHAPE), the device loop's
    timed steps a pass, and whether the TRACK artifact follows. On the CPU it
    times one small batch (B=4) and skips the rest, as JAX's does. Exits
    with SystemExit(3) after everything is written when the tripwire
    fires."""
    from ntm_tracker_tpu_torch.tools.track_artifact import device_fields
    from ntm_tracker_tpu_torch.tracking.tracker import build_frame_step

    if deadline is None:
        deadline = time.time() + float(os.environ.get("NTM_BENCH_BUDGET_S", "1500"))

    def remaining() -> float:
        return deadline - time.time()

    skipped: list = []

    def gate(name: str, est_s: float) -> bool:
        """True if phase `name` (estimated est_s) fits without eating the
        TRACK reserve; logs and records the skip otherwise."""
        if remaining() > est_s + _TRACK_RESERVE_S:
            return True
        print(f"bench: budget: skipping {name} (remaining {remaining():.0f}s < est {est_s:.0f}s + "
              f"track reserve {_TRACK_RESERVE_S:.0f}s)", file=sys.stderr)
        skipped.append(name)
        return False

    t_phase = time.time()

    def phase_done(name: str) -> None:
        nonlocal t_phase, counts
        now = time.time()
        print(f"bench: phase {name}: {now - t_phase:.1f}s (remaining {deadline - now:.0f}s); its launches "
              f"{json.dumps(launches_since(counts))}", file=sys.stderr)
        t_phase, counts = now, kernel_launches()

    dev = resolve_device(device)
    fields = device_fields(dev)
    platform = fields["platform"]
    counts = kernel_launches()
    cfg, core, vgg_params, params = _headline_setup(dev)
    side = cfg.data.crop_size
    rng = np.random.RandomState(0)

    def bench_batch(B, iters, warmup=3):
        _, step_rest = build_frame_step(cfg, core, vgg_params, params, device=dev)
        # bound the host transient: tile a 64-sample block (identical tiles
        # cost the convs the same)
        nb = min(B, 64)
        block = rng.rand(nb, side, side, 3).astype(np.float32) * 150 - 75
        if B > nb:
            block = np.tile(block, (-(-B // nb), 1, 1, 1))[:B]
        crops = torch.as_tensor(block, device=dev)
        state = core.init_state(params, B)
        for _ in range(warmup):
            offsets, state = step_rest(crops, state)
        _sync(offsets)
        # best of 3 passes, each ending in a host read of the offsets
        best_dt = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(iters):
                offsets, state = step_rest(crops, state)
            _sync(offsets)
            best_dt = min(best_dt, time.perf_counter() - t0)
        return B * iters / best_dt, best_dt / iters

    lat_p10 = lat_ms = lat_p90 = device_ms = device_ms_med = float("nan")
    lat_n = 0
    if platform == "cpu":  # a smoke at a tiny size
        throughput, _ = bench_batch(B=4, iters=3, warmup=1)
        best_batch = 4
    else:
        # throughput at large batch (many concurrent tracks per card),
        # doubling the batch until the gain is under 3%
        free, total = torch.cuda.mem_get_info(dev)
        ceiling = sweep_ceiling(cfg, SWEEP_START, sweep_max, free)
        print(f"bench: sweep ceiling B={ceiling} (asked {sweep_max}): the frame step holds "
              f"{frame_activation_bytes(cfg) / 1e6:.1f} MB a frame at its peak, {_MEMORY_SHARE:.0%} of "
              f"{free / 1e9:.1f} GB free of {total / 1e9:.1f} GB", file=sys.stderr)
        best, best_batch = 0.0, 0
        B = SWEEP_START
        while B <= ceiling:
            torch.cuda.reset_peak_memory_stats(dev)
            fps, step_s = bench_batch(B, iters=iters)
            print(f"bench: sweep B={B}: {fps:.1f} frames/s ({step_s * 1e3:.2f} ms a step), peak "
                  f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB allocated", file=sys.stderr)
            if fps > best * 1.03:
                best, best_batch = fps, B
                B *= 2
            else:
                break
            if remaining() < _TRACK_RESERVE_S + _EST_S["sweep_batch"]:
                print(f"bench: budget: stopping the batch sweep at B={best_batch} (remaining "
                      f"{remaining():.0f}s)", file=sys.stderr)
                break
        throughput = best
        phase_done("headline_sweep")
        # single-stream latency at B=1 (B1's cluster route), with dispersion
        _, step_rest = build_frame_step(cfg, core, vgg_params, params, device=dev)
        crop1 = torch.as_tensor(rng.rand(1, side, side, 3).astype(np.float32), device=dev)
        state = core.init_state(params, 1)
        offsets, state = step_rest(crop1, state)
        _sync(offsets)
        lats = []
        for _ in range(latency_frames):
            t0 = time.perf_counter()
            offsets, state = step_rest(crop1, state)
            _sync(offsets)
            lats.append(time.perf_counter() - t0)
        lat_p10, lat_ms, lat_p90 = (float(np.percentile(lats, q) * 1e3) for q in (10, 50, 90))
        lat_n = len(lats)
        # steady-state pipelined time a frame: the best of 3 passes, and the
        # median pass for the spread
        pass_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(latency_frames):
                offsets, state = step_rest(crop1, state)
            _sync(offsets)
            pass_ms.append((time.perf_counter() - t0) / latency_frames * 1e3)
        device_ms = min(pass_ms)
        device_ms_med = float(np.median(pass_ms))
        phase_done("latency_b1")

    # training throughput from the feature cache (train-offsets
    # --feature_cache: the 1300-step BPTT without the VGG)
    train_fps = train_ms = None
    if platform != "cpu" and gate("cached_train", _EST_S["cached_train"]):
        train_fps, train_ms = _cached_train_throughput(*TRAIN_SHAPE, iters=train_iters, device=dev)
        phase_done("cached_train")

    # the device-resident closed loop (crop geometry + VGG + cell steps +
    # recrop feedback, make_device_track_step) at the sweep's best batch
    devloop_fps = None
    if platform != "cpu" and gate("device_loop", _EST_S["device_loop"]):
        devloop_fps = _device_loop_throughput(cfg, core, vgg_params, params, best_batch, iters=device_loop_iters,
                                              device=dev)
        phase_done("device_loop")

    headline_variant = "weights-as-args"
    throughput_args = throughput
    flops = frame_flops(cfg)
    achieved_tflops = throughput * flops / 1e12
    peak = _chip_peak_tflops(dev, torch.bfloat16)
    train_peak = _chip_peak_tflops(dev, torch.float32)

    def r(v, nd):
        return round(v, nd) if v == v else None

    result = {
        "metric": "tracked_frames_per_sec_per_chip",
        "value": round(float(throughput), 1),
        "unit": "frames/s",
        "vs_baseline": round(float(throughput) / 1000.0, 3),
        "pipelined_frame_ms_b1": r(device_ms, 3),
        "pipelined_frame_ms_b1_med": r(device_ms_med, 3),
        "p10_roundtrip_ms_b1": r(lat_p10, 3),
        "p50_roundtrip_ms_b1": r(lat_ms, 3),
        "p90_roundtrip_ms_b1": r(lat_p90, 3),
        "roundtrip_n": lat_n or None,
        "best_batch": best_batch,
        "headline_variant": headline_variant,
        "frames_per_sec_weights_as_args": round(float(throughput_args), 1),
        "frame_gflops": round(flops / 1e9, 2),
        "achieved_tflops": round(achieved_tflops, 1),
        "mfu": round(achieved_tflops / peak, 3) if peak else None,
        "device_loop_frames_per_sec": round(float(devloop_fps), 1) if devloop_fps else None,
        "train_frames_per_sec_cached": round(train_fps, 1) if train_fps else None,
        "train_step_ms_cached": round(train_ms, 2) if train_ms else None,
        "train_mfu": _train_mfu(train_ms, train_peak, *TRAIN_SHAPE) if train_ms else None,
        "budget_skipped": skipped or None,
        "platform": platform,
        "device_kind": fields["device_kind"],
        "card": fields["card"],
        "power_limit": fields["power_limit"],
        "mfu_peak_tflops": peak,
        "mfu_peak_dtype": "bfloat16",
        "train_mfu_peak_tflops": train_peak,
        "train_mfu_peak_dtype": "float32",
    }
    print(json.dumps(result))
    sys.stdout.flush()

    # the regression tripwire against the previous recorded bench of this
    # card: checked now, raised after the artifact
    regressions = []
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if platform != "cpu":
        prev_n, prev, note = _comparable_previous(root, platform, fields["device_kind"])
        if prev is None:
            print(f"bench: regression check: {note}", file=sys.stderr)
        else:
            prev_variant = prev.get("headline_variant", "weights-as-args")
            if prev_variant != headline_variant:
                prev = {k: v for k, v in prev.items() if k not in _VARIANT_DEPENDENT}
                print(f"bench: regression check: headline variant differs ({prev_variant} -> {headline_variant}); "
                      "value/mfu excluded from the comparison", file=sys.stderr)
            regressions = _bench_regressions(result, prev)
            compared = [k for k in _TRIPWIRE_FIELDS if prev.get(k) is not None and result.get(k) is not None]
            print(f"bench: regression check vs BENCH_r{prev_n:02d}: compared {compared}: "
                  + ("; ".join(f"{k} {p:g} -> {c:g} REGRESSED >{_REGRESSION_FRAC:.0%}" for k, p, c in regressions)
                     or "all within bounds"), file=sys.stderr)

    # the accuracy artifact, after the JSON line so that a timeout cannot
    # cost the run its benchmark line
    if platform != "cpu" and track_artifact:
        _write_track_artifact(deadline=deadline - 15, device=dev)
        phase_done("track_artifact")

    if regressions:
        print("bench: REGRESSION TRIPWIRE: exiting nonzero (metric JSON and TRACK artifact are already written)",
              file=sys.stderr)
        raise SystemExit(3)
    return result


def _device_loop_throughput(cfg, core, vgg_params, params, B: int, H: int = 360, W: int = 640,
                            iters: int = 20, device=None) -> float:
    """Frames/s of the closed device loop (make_device_track_step) at batch
    B over raw HxW frames already on the device: the crop geometry, the
    crop and the recrop feedback that the frame-step number excludes.
    Best of 3 passes, each ending in a host read of the regions."""
    from ntm_tracker_tpu_torch.tracking.tracker import make_device_track_step

    dev = resolve_device(device)
    init_fn, step_fn = make_device_track_step(cfg, core, vgg_params, params, device=dev)
    rng = np.random.RandomState(1)
    nb = min(B, 16)  # bound host scratch; identical tiles cost the same
    block = (rng.rand(nb, H, W, 3) * 255).astype(np.float32)
    frames = torch.as_tensor(np.tile(block, (-(-B // nb), 1, 1, 1))[:B] if B > nb else block, device=dev)
    bbox = torch.tensor([[0.3, 0.3, 0.6, 0.6]], device=dev).repeat(B, 1)
    state = init_fn(frames, bbox, core.init_state(params, B))
    region, bbox, state = step_fn(frames, bbox, state)
    _sync(region)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            region, bbox, state = step_fn(frames, bbox, state)
        _sync(region)
        best = min(best, time.perf_counter() - t0)
    return B * iters / best


def _train_mfu(train_ms: float, peak_tflops: float | None, B: int, L: int):
    """Canonical 3x-forward matmul FLOPs of the measured cached train step
    (the same B and L as _cached_train_throughput; remat recompute not
    credited) against `peak_tflops`. The step computes in float32 with
    TF32 off, so main passes the card's float32 peak; the JAX bench put
    its float32 step against the TPU's bf16 peak."""
    if not peak_tflops:
        return None
    from ntm_tracker_tpu_torch.tools.profile_train import train_step_flops

    cfg = TrackerConfig(train=TrainConfig(batch_size=B, sequence_length=L))
    achieved = train_step_flops(cfg) / (train_ms / 1e3) / 1e12
    return round(achieved / peak_tflops, 4)


def _write_track_artifact(deadline: float | None = None, device=None):
    """TRACK_BENCH.json at the repo root (the card in its header; the
    repo's TRACK_r*.json and TRACK_H100.json are other runs' records).
    NTM_TRACK_STEPS overrides the training steps (400); `deadline` stops
    each core's training early so that the artifact completes."""
    from ntm_tracker_tpu_torch.tools.track_artifact import write_artifact

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    steps = int(os.environ.get("NTM_TRACK_STEPS", "400"))
    write_artifact(os.path.join(root, "TRACK_BENCH.json"), steps, deadline=deadline, device=device)


def _cached_train_throughput(B: int = 256, L: int = 20, iters: int = 10, device=None, base=None):
    """The full train step (gradients through the 1300-step BPTT, clip,
    RMSProp) on precomputed tokens, the train-offsets --feature_cache path:
    (frames/s, step ms). On cuda at float32 the step takes B2
    (fused_bptt "auto"); nothing falls back. `base` is the config whose
    train shape is set to (B, L) (TrackerConfig() by default)."""
    from ntm_tracker_tpu_torch.train.experiments import OffsetExperiment, device_cached_batch

    base = TrackerConfig() if base is None else base
    cfg = dataclasses.replace(base, train=dataclasses.replace(base.train, batch_size=B, sequence_length=L))
    exp = OffsetExperiment(cfg, None, image_mode="cropped", device=device)
    params, opt_state = exp.init(torch.Generator().manual_seed(1))
    step = exp.make_train_step()
    # drawn on the device, outside the timed steps (the host draws of
    # synthetic_cached_batch took ~10 s at B=256, L=20)
    batch = device_cached_batch(cfg, 0, exp.device)
    p, o, m = step(params, opt_state, batch)
    _sync(m["loss"])
    t0 = time.perf_counter()
    for _ in range(iters):
        p, o, m = step(p, o, batch)
    _sync(m["loss"])
    dt = (time.perf_counter() - t0) / iters
    return B * L / dt, dt * 1e3


if __name__ == "__main__":
    main()
