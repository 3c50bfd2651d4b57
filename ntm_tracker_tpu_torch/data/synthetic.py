"""Synthetic moving-bright-square video clips: a bright square over noise
whose normalized (y1,x1,y2,x2) gt box is known exactly; the toy task of
the tracking demo (tracking/demo.py) and the accuracy artifacts
(tools/track_artifact.py, tools/track_flagship.py).

The port's own copy of ntm_tracker_tpu/data/synthetic.py (numpy only):
the same seed gives the same arrays, bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def make_video(
    rng: np.random.RandomState,
    n_frames: int,
    hw: Tuple[int, int] = (180, 320),
    velocity: bool = True,
    scale_walk: bool = False,
):
    """(frames [L,H,W,3] float32 RGB, boxes [L,4] normalized y1,x1,y2,x2).

    velocity=True: smooth random-velocity motion (the demo's clip);
    velocity=False: per-frame positional jitter (the active-resize toy);
    scale_walk=True: the target's size also does a multiplicative random
    walk (up to ~4%/frame) — the training-data counterpart of the scale
    head (TrackerConfig.predict_scale), drawn AFTER the position draws so
    scale_walk=False clips are bit-identical to before the flag existed."""
    H, W = hw
    frames = (rng.rand(n_frames, H, W, 3) * 40).astype(np.float32)
    boxes = np.zeros((n_frames, 4), np.float32)
    if velocity:
        cy, cx = rng.uniform(0.4, 0.6, 2)
    else:
        cy, cx = rng.uniform(0.35, 0.65, 2)
    half = rng.uniform(0.08, 0.12)
    vy = vx = 0.0
    for t in range(n_frames):
        if velocity:
            vy = np.clip(vy + rng.uniform(-0.01, 0.01), -0.02, 0.02)
            vx = np.clip(vx + rng.uniform(-0.01, 0.01), -0.02, 0.02)
            cy = float(np.clip(cy + vy, 0.25, 0.75))
            cx = float(np.clip(cx + vx, 0.25, 0.75))
        else:
            cy = float(np.clip(cy + rng.uniform(-0.02, 0.02), 0.2, 0.8))
            cx = float(np.clip(cx + rng.uniform(-0.02, 0.02), 0.2, 0.8))
        if scale_walk and t > 0:
            half = float(
                np.clip(half * np.exp(rng.uniform(-0.04, 0.04)), 0.05, 0.18)
            )
        boxes[t] = (cy - half, cx - half, cy + half, cx + half)
        y0, y1 = int((cy - half) * H), int((cy + half) * H)
        x0, x1 = int((cx - half) * W), int((cx + half) * W)
        frames[t, y0:y1, x0:x1] = 220.0
    return frames, boxes


SCENES = ("smooth", "scale", "fast", "texture")


def make_scene(
    rng: np.random.RandomState,
    n_frames: int,
    scene: str = "smooth",
    hw: Tuple[int, int] = (180, 320),
):
    """Named scene variants for the accuracy artifact (its
    cores[].scenes[]), so accuracy regressions cannot hide in one easy
    clip:

      * "smooth"  — make_video's random-velocity clip (the demo default);
      * "scale"   — the target's size oscillates ±40% over the clip;
      * "fast"    — 3x the velocity/acceleration caps of "smooth";
      * "texture" — high-frequency, high-contrast background texture
        plus a non-flat target.

    Same return contract as make_video."""
    if scene == "smooth":
        return make_video(rng, n_frames, hw)
    if scene not in SCENES:
        raise ValueError(f"unknown scene {scene!r}; choose from {SCENES}")
    H, W = hw
    if scene == "texture":
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
        grating = (np.sin(xx * 0.9) * np.sin(yy * 0.9) * 0.5 + 0.5) * 120
        bg = grating[None] + rng.rand(n_frames, H, W).astype(np.float32) * 70
        frames = np.repeat(bg[..., None], 3, axis=-1)
    else:
        frames = (rng.rand(n_frames, H, W, 3) * 40).astype(np.float32)
    boxes = np.zeros((n_frames, 4), np.float32)
    cy, cx = rng.uniform(0.4, 0.6, 2)
    half0 = rng.uniform(0.08, 0.12)
    vcap, acap = (0.06, 0.03) if scene == "fast" else (0.02, 0.01)
    vy = vx = 0.0
    for t in range(n_frames):
        vy = float(np.clip(vy + rng.uniform(-acap, acap), -vcap, vcap))
        vx = float(np.clip(vx + rng.uniform(-acap, acap), -vcap, vcap))
        cy = float(np.clip(cy + vy, 0.2, 0.8))
        cx = float(np.clip(cx + vx, 0.2, 0.8))
        half = half0
        if scene == "scale":
            half = half0 * (1.0 + 0.4 * np.sin(2.0 * np.pi * t / max(n_frames - 1, 1)))
        boxes[t] = (cy - half, cx - half, cy + half, cx + half)
        y0, y1 = int((cy - half) * H), int((cy + half) * H)
        x0, x1 = int((cx - half) * W), int((cx + half) * W)
        if scene == "texture":
            ph, pw = max(y1 - y0, 1), max(x1 - x0, 1)
            patch = 150.0 + (np.arange(ph)[:, None] + np.arange(pw)[None, :]) % 2 * 70.0
            frames[t, y0:y1, x0:x1] = patch[..., None]
        else:
            frames[t, y0:y1, x0:x1] = 220.0
    return frames, boxes
