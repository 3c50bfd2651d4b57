"""The accuracy artifact: TRACK_H100.json (counterpart of
ntm_tracker_tpu/tools/track_artifact.py, with its record keys).

Runs the synthetic-video demo pipeline (tracking/demo.py: fixed seed,
fixed steps) for both memory cores and records untrained and trained
streaming IoU. Per core:
  * untrained / trained mean IoU on the demo's "smooth" held-out clip;
  * `scenes[]`: the same on every data/synthetic.SCENES variant (scale
    change, fast motion, texture), so a regression cannot hide in one
    easy scene;
  * `device_iou` (and per scene): the same clips through the
    device-resident loop (make_device_track_step); the worst |device -
    host| mean-IoU gap above DEVICE_IOU_GAP_MAX sets `device_iou_breach`;
  * `budget_truncated`, with no trained-IoU fields, when a deadline
    stopped training below the _MIN_TRAIN_STEPS floor;
  * the serving-precision probe: the trained tracker through the
    host-geometry loop and the device loop on one clip, at PyTorch's
    default precision settings. `drift_px` / `drift_frac` are the worst
    per-frame region deviation over the trajectory (pixels, and over the
    first gt box's diagonal), advisory; `drift_step1_px` /
    `drift_step1_frac` the deviation at the first tracked frame, where
    both loops start from the same state. `drift_step1_frac` above
    STEP1_FRAC_MAX sets `drift_breach`.
After the two cores, `scale_head` runs the NTM core with the (dy, dx, ds)
head (TrackerConfig.predict_scale) under the same protocol.

Each record is written to disk as it grows (after training, after the
scene sweep, after the probe), a deadline stops training at a step
boundary, and a tripwire raises only after every record is on disk.
`--stages` runs some of the records and `--resume` keeps the complete
ones that a run of the same protocol left, so the artifact can be made in
parts (the DNC's eager train step takes seconds on the card).
Training goes through OffsetExperiment.make_train_step: the fused BPTT
kernels (B2) for the NTM on the card, with no fallback; the DNC is plain
PyTorch. Progress goes to stderr.

    python -m ntm_tracker_tpu_torch.tools.track_artifact [--out PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ntm_tracker_tpu_torch.config import resolve_device
from ntm_tracker_tpu_torch.data.synthetic import SCENES, make_video
from ntm_tracker_tpu_torch.models.core import make_core
from ntm_tracker_tpu_torch.models.vgg import init_vgg_params
from ntm_tracker_tpu_torch.tracking.demo import (
    demo_config,
    eval_device_iou,
    eval_streaming_iou,
    mean_clamped_iou,
    training_batch,
)
from ntm_tracker_tpu_torch.tracking.tracker import StreamingTracker, _to_device, make_device_track_step
from ntm_tracker_tpu_torch.train.experiments import OffsetExperiment

# The one-step tripwire: both loops enter frame 1 from the same state, so
# the deviation there is the implementation and precision mismatch of one
# step (crop, VGG, cell steps, decode, recrop). An implementation fault
# shows at tens of pixels; rounding stays far under a pixel. 0.05 of the
# gt box's diagonal (~3.9 px on the demo clip).
STEP1_FRAC_MAX = 0.05

# Advisory ceiling for the whole trajectory's drift, recorded, not
# asserted: rounding compounds through the recrop feedback, so no bound on
# it separates a fault from chance.
DRIFT_FRAC_MAX = 0.15

# The serving-accuracy tripwire: the worst |mean IoU(device loop) - mean
# IoU(host loop)| over the scenes. The mean clamped IoU of a trained
# tracker is stable where per-frame trajectories are not.
DEVICE_IOU_GAP_MAX = 0.05

# Seconds kept out of a deadline for the trained evals, the scene sweep
# and the probe.
_EVAL_RESERVE_S = 240.0

# The fewest training steps for a record to carry trained-accuracy fields
# (the demo config's IoU plateaus by ~200 steps); a deadline-truncated run
# below it records `budget_truncated` instead.
_MIN_TRAIN_STEPS = 200

DEFAULT_OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                           "TRACK_H100.json")


def _log(msg: str) -> None:
    print(f"track_artifact: {msg}", file=sys.stderr, flush=True)


def device_fields(dev: torch.device) -> dict:
    """platform, device_kind, and on cuda the card's name and power limit
    as `nvidia-smi --query-gpu=name,power.limit` gives them."""
    if dev.type != "cuda":
        return {"platform": dev.type, "device_kind": "", "card": None, "power_limit": None}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
    name, limit = (v.strip() for v in smi[dev.index or 0].rsplit(",", 1))
    return {"platform": "gpu", "device_kind": torch.cuda.get_device_name(dev), "card": name,
            "power_limit": limit}


def precision_fields() -> dict:
    """The float32 precision settings the run used (PyTorch's defaults
    unless a caller changed them)."""
    return {"float32_matmul_precision": torch.get_float32_matmul_precision(),
            "cudnn_allow_tf32": bool(torch.backends.cudnn.allow_tf32)}


def eval_iou(cfg, vgg, params, seed: int, frames_n: int, scene: str = "smooth", device=None) -> float:
    """Mean clamped streaming-tracker IoU over a held-out clip: the demo's
    protocol (tracking/demo.eval_streaming_iou)."""
    return mean_clamped_iou(eval_streaming_iou(cfg, vgg, params, seed, frames_n, scene=scene, device=device))


def serve_precision_drift(cfg, core, vgg, params, seed: int, frames_n: int = 12, loop=None, device=None):
    """|region| deviation between the host-geometry streaming loop and the
    device-resident loop on one clip, with the given (trained) weights.
    Returns (drift_px, drift_frac, step1_px, step1_frac): the worst
    per-frame deviation over the trajectory and the one at the first
    tracked frame, in pixels and over the first gt box's diagonal."""
    dev = resolve_device(device)
    frames, boxes = make_video(np.random.RandomState(seed + 2000), frames_n)
    H, W = frames.shape[1:3]
    b0 = boxes[0]
    region0 = (b0[1] * W, b0[0] * H, (b0[3] - b0[1]) * W, (b0[2] - b0[0]) * H)
    box_diag = float(np.hypot(region0[2], region0[3]))

    host = StreamingTracker(cfg, vgg, params, core, device=dev)
    host.init(frames[0], region0)
    host_regions = [host.track(frames[t]) for t in range(1, frames_n)]

    init_fn, step_fn = loop or make_device_track_step(cfg, core, vgg, params, device=dev)
    x, y, w, h = region0
    bbox = np.asarray([[y / (H - 1), x / (W - 1), (y + h) / (H - 1), (x + w) / (W - 1)]], np.float32)
    with torch.no_grad():
        state = _to_device(core.init_state(params, 1), dev)
    state = init_fn(frames[0:1], bbox, state)
    drift = step1 = 0.0
    for t in range(1, frames_n):
        region, bbox, state = step_fn(frames[t:t + 1], bbox, state)
        d = float(np.abs(region[0].cpu().numpy() - np.asarray(host_regions[t - 1])).max())
        if t == 1:
            step1 = d
        drift = max(drift, d)
    return drift, drift / box_diag, step1, step1 / box_diag


def run_core(core: str, train_steps: int, seed: int = 0, eval_frames: int = 40, drift_frames: int = 12,
             scene_frames: int = 24, deadline: float | None = None, flush=None, predict_scale: bool = False,
             label: str | None = None, device=None) -> dict:
    """Train and evaluate one memory core; returns its record.

    `deadline` (absolute time.time()) stops training at a step boundary,
    keeping _EVAL_RESERVE_S for the evals; `flush(record)` is called after
    each change, so partial progress is on disk. predict_scale runs the
    (dy, dx, ds) head on size-varying training clips."""
    dev = resolve_device(device)
    cfg = demo_config(core=core, predict_scale=predict_scale)
    name = label or core
    rng = np.random.RandomState(seed)
    vgg = init_vgg_params(torch.Generator().manual_seed(0), dev)
    mcore = make_core(cfg)
    exp = OffsetExperiment(cfg, vgg, core=mcore, image_mode="cropped", device=dev)
    params, opt_state = exp.init(torch.Generator().manual_seed(1))

    def iou(p, frames_n, scene="smooth"):
        return eval_iou(cfg, vgg, p, seed, frames_n, scene=scene, device=dev)

    untrained = iou(params, eval_frames)
    _log(f"{name}: untrained IoU {untrained:.3f}")
    scenes = []
    for scene in SCENES:
        u = untrained if scene == "smooth" and scene_frames == eval_frames else iou(params, scene_frames, scene)
        scenes.append({"scene": scene, "untrained_iou": round(u, 4)})

    step = exp.make_train_step()
    t0 = time.perf_counter()
    m = None
    steps_done = 0
    for i in range(train_steps):
        if deadline is not None and i % 10 == 0 and i > 0 and time.time() > deadline - _EVAL_RESERVE_S:
            _log(f"{name}: budget: stopping training at step {i} (deadline reserve {_EVAL_RESERVE_S:.0f}s)")
            break
        params, opt_state, m = step(params, opt_state, training_batch(cfg, rng, dev))
        steps_done = i + 1
        if i % 100 == 0:
            _log(f"{name}: step {i} loss {float(m['loss']):.4f}")
    if m is not None:
        float(m["loss"])  # a host read ends the timed span
    train_s = time.perf_counter() - t0

    # below the floor a record publishes no trained accuracy
    truncated = steps_done < min(_MIN_TRAIN_STEPS, train_steps)
    out = {"core": core, "steps": steps_done, "untrained_iou": round(untrained, 4),
           "train_seconds": round(train_s, 1), "scenes": scenes}
    if truncated:
        out["budget_truncated"] = True
        _log(f"{name}: budget_truncated: {steps_done} steps is below the {_MIN_TRAIN_STEPS}-step floor; "
             "no trained-IoU fields are recorded")
    if predict_scale:
        out["predict_scale"] = True
    if flush is not None:
        flush(out)

    if not truncated:
        trained = iou(params, eval_frames)
        out["trained_iou"] = round(trained, 4)
        _log(f"{name}: trained IoU {trained:.3f} ({steps_done} steps, {train_s:.0f}s)")
        if flush is not None:
            flush(out)
        for rec in scenes:
            scene = rec["scene"]
            t = trained if scene == "smooth" and scene_frames == eval_frames else iou(params, scene_frames, scene)
            rec["trained_iou"] = round(t, 4)
            _log(f"{name}: scene {scene}: IoU {rec['untrained_iou']:.3f} -> {rec['trained_iou']:.3f}")
        if flush is not None:
            flush(out)

    loop = make_device_track_step(cfg, mcore, vgg, params, device=dev)
    drift_px, drift_frac, step1_px, step1_frac = serve_precision_drift(
        cfg, mcore, vgg, params, seed, frames_n=drift_frames, loop=loop, device=dev)
    out["drift_px"] = round(drift_px, 4)
    out["drift_frac"] = round(drift_frac, 4)
    out["drift_step1_px"] = round(step1_px, 4)
    out["drift_step1_frac"] = round(step1_frac, 4)
    out["drift_breach"] = bool(step1_frac > STEP1_FRAC_MAX)
    _log(f"{name}: serving drift: step 1 {step1_px:.4f} px ({step1_frac:.4f} of the gt box's diagonal, "
         f"tripwire {STEP1_FRAC_MAX}); trajectory {drift_px:.4f} px ({drift_frac:.4f}, advisory)"
         + (" - BREACH" if out["drift_breach"] else ""))
    if flush is not None:
        flush(out)

    # serving accuracy: every trained scene through the device loop
    if not truncated:
        worst_gap = 0.0
        for rec in scenes:
            d_iou = mean_clamped_iou(eval_device_iou(cfg, vgg, params, seed, scene_frames, core=mcore,
                                                     scene=rec["scene"], loop=loop, device=dev))
            rec["device_iou"] = round(d_iou, 4)
            worst_gap = max(worst_gap, abs(d_iou - rec["trained_iou"]))
        d_main = (scenes[0]["device_iou"] if scene_frames == eval_frames
                  else mean_clamped_iou(eval_device_iou(cfg, vgg, params, seed, eval_frames, core=mcore,
                                                        scene="smooth", loop=loop, device=dev)))
        out["device_iou"] = round(float(d_main), 4)
        worst_gap = max(worst_gap, abs(float(d_main) - out["trained_iou"]))
        out["device_iou_gap"] = round(worst_gap, 4)
        out["device_iou_breach"] = bool(worst_gap > DEVICE_IOU_GAP_MAX)
        _log(f"{name}: device-loop IoU {out['device_iou']:.3f} vs host {out['trained_iou']:.3f}; worst scene gap "
             f"{worst_gap:.4f} (tripwire {DEVICE_IOU_GAP_MAX})" + (" - BREACH" if out["device_iou_breach"] else ""))
        if flush is not None:
            flush(out)
    return out


def _artifact_fidelity(artifact: dict) -> int:
    """The fewest steps across an artifact's core records (0 for a
    missing, partial or malformed one: always replaceable)."""
    try:
        cores = artifact.get("cores") or []
        if len(cores) < 2:
            return 0
        return min(int(c.get("steps", 0)) for c in cores)
    except (AttributeError, TypeError, ValueError):
        return 0


def _existing_fidelity(out_path: str) -> int:
    if not os.path.exists(out_path):
        return 0
    try:
        with open(out_path) as f:
            return _artifact_fidelity(json.load(f))
    except (OSError, json.JSONDecodeError):
        return 0


CORES = ("ntm", "dnc")
STAGES = CORES + ("scale_head",)


def _complete(record) -> bool:
    """A record whose every stage ran: its last field is written."""
    return isinstance(record, dict) and "drift_breach" in record and (
        record.get("budget_truncated", False) or "device_iou_breach" in record)


def _resumable(out_path: str, header: dict) -> dict:
    """The complete records {stage: record} of the artifact at out_path
    (or its .partial, where a run left one), when it was made by the same
    protocol on the same device; raises for another protocol."""
    for path in (out_path + ".partial", out_path):
        if os.path.exists(path):
            with open(path) as f:
                old = json.load(f)
            mismatched = {k: (old.get(k), v) for k, v in header.items() if old.get(k) != v}
            if mismatched:
                raise ValueError(f"cannot resume {path}: it was made with {mismatched}")
            records = {c["core"]: c for c in old.get("cores", []) if _complete(c)}
            if _complete(old.get("scale_head")):
                records["scale_head"] = old["scale_head"]
            _log(f"resume: keeping the complete records {sorted(records)} of {path}")
            return records
    return {}


def write_artifact(out_path: str = DEFAULT_OUT, train_steps: int = 400, eval_frames: int = 40,
                   drift_frames: int = 12, scene_frames: int = 24, deadline: float | None = None,
                   force: bool = False, device=None, stages=STAGES, resume: bool = False) -> dict:
    """Write the artifact for both cores and the scale head; raises after
    every record is on disk if a tripwire fired.

    `stages` names the records to run (the cores "ntm" and "dnc", then
    "scale_head"). resume=True first keeps the complete records that a run
    of the same protocol left at out_path (or its .partial) and runs only
    the named stages they lack, so the artifact can be made in parts.

    Overwrite guard: when out_path already holds an artifact, the run
    writes to `out_path + ".partial"` and replaces out_path only if its
    fidelity (the fewest steps across cores) is at least the old one's;
    force=True always replaces."""
    dev = resolve_device(device)
    header = {**device_fields(dev), "train_steps": train_steps, "eval_frames": eval_frames,
              "drift_frames": drift_frames, "scene_frames": scene_frames}
    records = _resumable(out_path, header) if resume else {}
    existing = 0 if force else _existing_fidelity(out_path)
    target = out_path + ".partial" if existing > 0 else out_path
    if existing > 0:
        _log(f"overwrite guard: {out_path} holds a fidelity-{existing} artifact; writing to {target} until this "
             "run proves equal or better")

    artifact = {**header, "precision": precision_fields(), "cores": []}

    def keep(stage, record):
        records[stage] = record
        artifact["cores"] = [records[c] for c in CORES if c in records]
        if "scale_head" in records:
            artifact["scale_head"] = records["scale_head"]
        with open(target, "w") as f:
            json.dump(artifact, f, indent=1)
            f.write("\n")

    todo = [c for c in CORES if c in stages and c not in records]
    for idx, core in enumerate(todo):
        # the remaining budget split evenly over the cores still to run
        core_deadline = None
        if deadline is not None:
            core_deadline = time.time() + (deadline - time.time()) / (len(todo) - idx)
        rec = run_core(core, train_steps, eval_frames=eval_frames, drift_frames=drift_frames,
                       scene_frames=scene_frames, deadline=core_deadline,
                       flush=lambda r, _c=core: keep(_c, r), device=dev)
        keep(core, rec)

    # the scale head last, and only when the budget fits a full record
    if "scale_head" in stages and "scale_head" not in records:
        if deadline is None or deadline - time.time() > _EVAL_RESERVE_S + 90:
            rec = run_core("ntm", train_steps, eval_frames=eval_frames, drift_frames=drift_frames,
                           scene_frames=scene_frames, deadline=deadline, flush=lambda r: keep("scale_head", r),
                           predict_scale=True, label="ntm+scale", device=dev)
            keep("scale_head", rec)
        else:
            _log(f"budget: skipping the scale-head stage ({deadline - time.time():.0f}s left)")
            keep("scale_head", {"skipped": "budget"})
    elif records:
        keep(*next(iter(records.items())))  # a resumed artifact, written at target as it is

    final_path = target
    if existing > 0:
        new_fid = _artifact_fidelity(artifact)
        if new_fid >= existing:
            os.replace(target, out_path)
            final_path = out_path
            _log(f"overwrite guard: new fidelity {new_fid} >= existing {existing}; promoted {target} -> {out_path}")
        else:
            _log(f"overwrite guard: refusing to overwrite {out_path} (fidelity {existing}) with this run's "
                 f"fidelity-{new_fid} record, kept at {target}; --force overrides")
    _log(f"wrote {final_path}")
    breached = [
        (c["core"], kind)
        for c in artifact["cores"] + [dict(artifact.get("scale_head", {}), core="ntm+scale")]
        for kind, flag in (("drift_step1", "drift_breach"), ("device_iou", "device_iou_breach"))
        if c.get(flag)
    ]
    if breached:
        raise RuntimeError(f"serving tripwire(s) fired: {breached} (drift_step1_frac > {STEP1_FRAC_MAX} and/or "
                           f"device-host IoU gap > {DEVICE_IOU_GAP_MAX}); see {final_path}")
    return artifact


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Write the accuracy artifact (both cores and the scale head).")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--train_steps", type=int, default=400)
    ap.add_argument("--eval_frames", type=int, default=40)
    ap.add_argument("--drift_frames", type=int, default=12)
    ap.add_argument("--scene_frames", type=int, default=24)
    ap.add_argument("--budget_s", type=float, default=None,
                    help="wall-clock budget; training stops early at a step boundary to keep the artifact whole")
    ap.add_argument("--force", action="store_true",
                    help="overwrite an existing artifact even when this run's fidelity is lower")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--stages", nargs="+", choices=STAGES, default=list(STAGES),
                    help="the records to run (default: all)")
    ap.add_argument("--resume", action="store_true",
                    help="keep the complete records that a run of this protocol left at --out (or its .partial) "
                         "and run only the stages they lack")
    args = ap.parse_args(argv)
    write_artifact(args.out, args.train_steps, eval_frames=args.eval_frames, drift_frames=args.drift_frames,
                   scene_frames=args.scene_frames,
                   deadline=time.time() + args.budget_s if args.budget_s else None,
                   force=args.force, device=args.device, stages=tuple(args.stages), resume=args.resume)
    return 0


if __name__ == "__main__":
    sys.exit(main())
