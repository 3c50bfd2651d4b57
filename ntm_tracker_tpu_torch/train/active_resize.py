"""Active-resize (closed-loop recrop) training (counterpart of
ntm_tracker_tpu/train/active_resize.py), the completed form of the
reference's unfinished `ntm_active_resize` (main.py:1294-1422).

Each frame is cropped around the box the model predicted on the previous
frame, the closed loop the online tracker runs at inference. A loop over
frames carries (cell state, current normalized bbox):
    cropbox   = cropbox_of(bbox)                  (the 8/6 enlargement)
    crop      = crop_and_resize(frame_t, cropbox)
    tokens    = the frozen VGG's conv4_3 grid (+ the optional 1x1 compressor)
    stream    = [F tokens, delimiter] (+ the frame-0 gt indicator)
    offsets   = tanh(the last logit) of the frame's F+1 steps
    loss_t    = 0.5 * sum((offsets - the gt offsets in the CURRENT crop)^2)
    next bbox = the canonical box shifted by the PREDICTED offsets, back in
                image coordinates, cut from the graph (.detach(), JAX's
                stop_gradient): BPTT runs through the memory across
                frames, not through the crop geometry.

The frame's F+1 steps are one core.unroll from the carried state (JAX's
inner scan over core.step computes the same function): on cuda the NTM
core takes B2 once a frame, the next frame's state cotangents entering its
backward. Memory grows linearly with L: each frame's B2 call keeps its own
residuals (a state per step, (F+1) x B of them) and its projection until
the backward frees them, so a step holds L frames' residuals at its peak,
with no per-frame checkpoint (JAX's jax.checkpoint(step)) needed on an
80 GB card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ntm_tracker_tpu_torch.config import TrackerConfig, resolve_device, validate_head
from ntm_tracker_tpu_torch.data.geometry_jnp import (
    canonical_box,
    center_log_scale,
    center_offsets,
    cropbox_of,
    scale_box,
    to_crop_space,
    to_image_space,
)
from ntm_tracker_tpu_torch.data.image_ops import crop_and_resize
from ntm_tracker_tpu_torch.models.core import MemoryCore, make_core
from ntm_tracker_tpu_torch.models.vgg import VGG_MEAN
from ntm_tracker_tpu_torch.tracking.tracker import canonical_first_frame_gt
from ntm_tracker_tpu_torch.train.experiments import frame_tokens, gradient_step
from ntm_tracker_tpu_torch.train.optim import TFRMSProp, reference_optimizer
from ntm_tracker_tpu_torch.train.serialize import serialize_streaming_batch
from ntm_tracker_tpu_torch.train.zoo import compress_features, init_compressor


@dataclasses.dataclass
class ActiveResizeExperiment:
    """Closed-loop recrop training over whole frames and per-frame gt
    boxes. Runs on `device`: cuda unless the caller passes another."""

    cfg: TrackerConfig
    vgg_params: Any
    compress_dim: int = 0
    core: MemoryCore = None  # type: ignore[assignment]
    device: Any = None

    def __post_init__(self):
        validate_head(self.cfg)
        if self.core is None:
            self.core = make_core(self.cfg)
        self.device = resolve_device(self.device)

    @property
    def input_size(self) -> int:
        return (self.compress_dim or self.cfg.feature_depth) + 2

    def init(self, generator: Optional[torch.Generator] = None):
        params = {"core": self.core.init_params(generator, self.input_size, self.device)}
        if self.compress_dim:
            params["compressor"] = init_compressor(self.cfg.feature_depth, self.compress_dim, generator, self.device)
        return params, self.optimizer().init(params)

    def optimizer(self) -> TFRMSProp:
        t = self.cfg.train
        return reference_optimizer(t.learning_rate, t.decay, t.momentum, 1e-10, t.max_gradient_norm)

    def _frame_tokens(self, params, crops: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            toks = frame_tokens(self.cfg, self.vgg_params, crops)  # [B,F,C]
        if self.compress_dim:
            toks = compress_features(toks, params["compressor"])
        return toks

    def _frame_offsets(self, params, crops: torch.Tensor, gt_heat: Optional[torch.Tensor], state):
        """One frame through the core: crops [B,S,S,3] (mean subtracted),
        gt_heat [B,F] or None -> ((dy, dx[, ds]) [B, head], new state)."""
        stream = serialize_streaming_batch(self._frame_tokens(params, crops), gt_heat, delimiter_first=False)
        logits, state = self.core.unroll(params["core"], stream, state)
        return torch.tanh(logits[:, -1]), state

    def loss_fn(self, params, batch: Dict[str, Any]) -> Tuple[torch.Tensor, Dict]:
        """batch: frames [B,L,S,S,3] whole RGB frames (read_imgs: resized to
        crop_size), bboxes [B,L,4] normalized (y1,x1,y2,x2) gt boxes."""
        cfg, d, dev = self.cfg, self.cfg.data, self.device
        frames = torch.as_tensor(batch["frames"], device=dev).float() - torch.as_tensor(VGG_MEAN, device=dev)
        gt_boxes = torch.as_tensor(batch["bboxes"], device=dev).float()
        B, L = frames.shape[:2]
        canon = canonical_box(d.cropbox_grid, d.bbox_grid, device=dev)

        def crop(frame, cropbox):
            return crop_and_resize(frame, cropbox, (d.crop_size, d.crop_size))

        # frame 0: cropped around the gt box, with the target indicator (the
        # canonical centered heatmap, the same for every sample)
        bbox = gt_boxes[:, 0]
        heat0 = torch.as_tensor(canonical_first_frame_gt(cfg), device=dev)[None].expand(B, -1)
        state = self.core.init_state(params["core"], B)
        _, state = self._frame_offsets(params, crop(frames[:, 0], cropbox_of(bbox, d.cropbox_grid, d.bbox_grid)),
                                       heat0, state)
        loss = frames.new_zeros(())
        for t in range(1, L):
            cb = cropbox_of(bbox, d.cropbox_grid, d.bbox_grid)
            outs, state = self._frame_offsets(params, crop(frames[:, t], cb), None, state)
            gt_crop = to_crop_space(gt_boxes[:, t], cb)
            target = center_offsets(gt_crop, canon)
            if cfg.predict_scale:
                target = torch.cat([target, (center_log_scale(gt_crop, canon) / cfg.scale_range)[:, None]], dim=-1)
                base = scale_box(canon.expand(B, 4), torch.exp(outs[:, 2] * cfg.scale_range))
                dyx = outs[:, :2]
            else:
                base, dyx = canon[None], outs
            loss = loss + 0.5 * torch.sum((outs - target) ** 2)
            # the PREDICTION decoded into the next frame's recrop; the
            # gradient flows through the memory, not the crop geometry
            bbox = to_image_space(base + torch.cat([dyx, dyx], dim=-1), cb).detach()
        return loss, {"loss": loss, "final_bbox": bbox}

    def make_train_step(self):
        return gradient_step(self.loss_fn, self.optimizer())


def synthetic_active_batch(cfg: TrackerConfig, rng: np.random.RandomState,
                           frame_hw: Optional[Tuple[int, int]] = None) -> Dict[str, np.ndarray]:
    """A moving bright square on noise, a learnable closed-loop toy (the
    shared clip generator, data/synthetic.py), drawn in the JAX package's
    order."""
    from ntm_tracker_tpu_torch.data.synthetic import make_video

    B, L = cfg.train.batch_size, cfg.train.sequence_length
    H, W = frame_hw or (cfg.data.crop_size, cfg.data.crop_size)
    frames = np.zeros((B, L, H, W, 3), np.float32)
    boxes = np.zeros((B, L, 4), np.float32)
    for b in range(B):
        frames[b], boxes[b] = make_video(rng, L, (H, W), velocity=False, scale_walk=cfg.predict_scale)
    return {"frames": frames, "bboxes": boxes}
