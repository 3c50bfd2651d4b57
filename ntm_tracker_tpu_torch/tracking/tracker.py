"""Streaming online tracker: one frame step per frame
(counterpart of ntm_tracker_tpu/tracking/tracker.py).

    frame step: (crop [B,224,224,3], state) ->
        VGG conv4_3 -> 64 tokens -> 65-token stream
        -> 65 NTM cell steps (one B1 launch, or 65 cell steps each with
           one B3 launch under NTMConfig.use_pallas)
        -> tanh(last logit) = (dy, dx), new state

StreamingTracker keeps the bbox decode and re-crop geometry on the host
(numpy), as the reference's test_tracker.py:252-329 does;
make_device_track_step runs the same geometry on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ntm_tracker_tpu_torch.config import TrackerConfig, float32_matmul_precision, resolve_device, validate_head
from ntm_tracker_tpu_torch.data import geometry
from ntm_tracker_tpu_torch.data.geometry_jnp import canonical_box, cropbox_of, scale_box, to_image_space
from ntm_tracker_tpu_torch.data.image_ops import crop_and_resize, crop_and_resize_mm
from ntm_tracker_tpu_torch.models.core import MemoryCore, make_core
from ntm_tracker_tpu_torch.models.vgg import VGG_MEAN
from ntm_tracker_tpu_torch.ops.kernels.scan_cell import ntm_scan_fused
from ntm_tracker_tpu_torch.train.experiments import frame_tokens
from ntm_tracker_tpu_torch.train.optim import tree_map
from ntm_tracker_tpu_torch.train.serialize import serialize_streaming_batch


def _to_device(tree, device):
    return tree_map(lambda t: t.to(device), tree)


def use_fused_kernel(cfg: TrackerConfig, batch: int, device: torch.device) -> bool:
    """The frame step's cell route. Auto (fused_inference=None) takes the
    fused kernel at B=1 on cuda for the NTM core when no matmul-precision
    override is set (the JAX rule, tracker.py:89-99, with the TPU read as
    cuda); True forces it at any batch (on CPU tensors the wrapper runs its
    plain version); False forces the plain loop."""
    if cfg.fused_inference is None:
        return (
            batch == 1 and cfg.core == "ntm" and device.type == "cuda"
            and cfg.cell_matmul_precision is None
        )
    return bool(cfg.fused_inference) and cfg.core == "ntm"


def build_frame_step(
    cfg: TrackerConfig,
    core: MemoryCore,
    vgg_params: Any,
    params: Any,
    delimiter_first: bool = False,
    device=None,
):
    """Create the whole-frame step on `device` (cuda unless the caller
    passes another; raises when cuda is absent). Weights are moved there.

    Returns (step_first, step_rest):
      step_first(crops [B,H,W,3] mean-subtracted, gt [B,F] or None, state)
        -> (offsets [B, head_dim], new state)
      step_rest(crops, state) -> (offsets, new state)

    delimiter_first=False matches the training serialization (prediction
    read at the delimiter step); True is the reference's streaming order.
    """
    validate_head(cfg)
    dev = resolve_device(device)
    vgg_params = _to_device(vgg_params, dev)
    params = _to_device(params, dev)
    F = cfg.num_features

    @torch.no_grad()
    def step_first(crops: torch.Tensor, gt: Optional[torch.Tensor], state):
        B = crops.shape[0]
        toks = frame_tokens(cfg, vgg_params, crops.float())
        stream = serialize_streaming_batch(
            toks, None if gt is None else gt.reshape(B, F), delimiter_first=delimiter_first
        )
        if use_fused_kernel(cfg, B, dev):
            logits, final_state = ntm_scan_fused(
                params, cfg.ntm, stream, state, compute_dtype=cfg.compute_dtype
            )
            return torch.tanh(logits[:, -1]), final_state
        with float32_matmul_precision(cfg.cell_matmul_precision):
            logits, final_state = core.unroll(params, stream, state, remat=False, fused_bptt=False)
        return torch.tanh(logits[:, -1]), final_state

    def step_rest(crops: torch.Tensor, state):
        return step_first(crops, None, state)

    return step_first, step_rest


def make_device_track_step(
    cfg: TrackerConfig,
    core: MemoryCore,
    vgg_params: Any,
    params: Any,
    delimiter_first: bool = False,
    device=None,
):
    """Device-resident per-frame tracking: the crop geometry, the crop
    (crop_and_resize_mm), the frame step and the recrop all on the device,
    for frames that already live there; no host round trip per frame
    (counterpart of ntm_tracker_tpu/tracking/tracker.py:183-298).

    The geometry follows StreamingTracker's, including the reference's
    (dim-1)/dim decode quirk (regions are decoded with *dim and
    re-normalized with /(dim-1), so each recrop scales the box by
    dim/(dim-1)) and the predict_scale decode. Runs on cuda unless
    `device` names another device.

    Returns (init_fn, step_fn):
      init_fn(frames [B,H,W,3] raw RGB, bbox0 [B,4] y1x1y2x2 in the
              tracker's /(dim-1) normalization, state) -> state
      step_fn(frames, bbox, state) ->
              (region [B,4] x,y,w,h pixels, next_bbox [B,4], state)
    Frames may be tensors (uint8 or float) or numpy arrays.
    """
    dev = resolve_device(device)
    d = cfg.data
    canon = canonical_box(d.cropbox_grid, d.bbox_grid, device=dev)
    heat0 = torch.as_tensor(canonical_first_frame_gt(cfg), device=dev)
    mean = torch.as_tensor(VGG_MEAN, device=dev)
    step_first, _ = build_frame_step(cfg, core, vgg_params, params, delimiter_first=delimiter_first,
                                     device=dev)

    def crop(frames: torch.Tensor, cropbox: torch.Tensor) -> torch.Tensor:
        return crop_and_resize_mm(frames.float() - mean, cropbox, (d.crop_size, d.crop_size))

    @torch.no_grad()
    def init_fn(frames, bbox0, state):
        frames = torch.as_tensor(frames, device=dev)
        bbox0 = torch.as_tensor(bbox0, dtype=torch.float32, device=dev)
        crops = crop(frames, cropbox_of(bbox0, d.cropbox_grid, d.bbox_grid))
        _, state = step_first(crops, heat0[None].expand(crops.shape[0], -1), state)
        return state

    @torch.no_grad()
    def step_fn(frames, bbox, state):
        frames = torch.as_tensor(frames, device=dev)
        bbox = torch.as_tensor(bbox, dtype=torch.float32, device=dev)
        H, W = frames.shape[1:3]
        cb = cropbox_of(bbox, d.cropbox_grid, d.bbox_grid)
        offsets, state = step_first(crop(frames, cb), None, state)
        # the device twin of decode_head: optional scale about the canonical
        # center, then the (dy, dx) shift
        if cfg.predict_scale:
            base = scale_box(canon.expand(offsets.shape[0], 4), torch.exp(offsets[:, 2] * cfg.scale_range))
            offsets = offsets[:, :2]
        else:
            base = canon[None]
        img_box = to_image_space(base + torch.cat([offsets, offsets], dim=-1), cb)
        y1, x1, y2, x2 = img_box.unbind(-1)
        region = torch.stack([x1 * W, y1 * H, (x2 - x1) * W, (y2 - y1) * H], dim=-1)
        # the reference's decode/renormalize round trip: pixels = box * dim,
        # the next normalization divides by (dim - 1)
        quirk = torch.tensor([H / (H - 1.0), W / (W - 1.0), H / (H - 1.0), W / (W - 1.0)],
                             dtype=torch.float32, device=dev)
        return region, img_box * quirk, state

    return init_fn, step_fn


# -- host-side crop/decode geometry ----------------------------------------

def decode_head(cfg, init_bbox, outputs: np.ndarray):
    """Head outputs -> crop-space box: (dy, dx) shift the canonical box;
    with cfg.predict_scale a third output ds first scales it about its
    center by exp(ds * scale_range)."""
    if cfg.predict_scale:
        dy, dx, ds = (float(v) for v in outputs)
        init_bbox = geometry.scale_bbox(init_bbox, float(np.exp(ds * cfg.scale_range)))
    else:
        dy, dx = (float(v) for v in outputs)
    return geometry.offset_bbox(init_bbox, (dy, dx))


def region_geometry(cfg_data, image_size, region_xywh):
    """(normalized_bbox, cropbox, transformation) for a tracked region
    (test_tracker.py:301-329). region is (x, y, w, h); values all < 1 are
    taken as already normalized."""
    x1, y1, w, h = region_xywh
    normalized = x1 < 1 and y1 < 1 and w < 1 and h < 1
    bbox = (y1, x1, y1 + h, x1 + w)
    width, height = image_size
    nb = bbox if normalized else geometry.normalize_bbox((width, height), bbox)
    cropbox = geometry.calculate_cropbox(nb, cfg_data.cropbox_grid, cfg_data.bbox_grid)
    return nb, cropbox, geometry.calculate_transformation(cropbox)


def decode_region(transformation, image_size, normalized_bbox):
    """Cropbox-space bbox -> (x, y, w, h) pixel region via the inverse crop
    transform (test_tracker.py:257-272)."""
    y1, x1, y2, x2 = geometry.apply_transformation(normalized_bbox, np.linalg.inv(transformation))
    w, h = image_size
    return (x1 * w, y1 * h, (x2 - x1) * w, (y2 - y1) * h)


def canonical_first_frame_gt(cfg) -> np.ndarray:
    """The frame-0 indicator when the gt box is the box the crop was built
    around: a per-config constant [num_features] float32."""
    d = cfg.data
    gt_side = int(round(cfg.num_features ** 0.5))
    half = d.bbox_grid / float(d.cropbox_grid) / 2.0
    return geometry.generate_gt(
        (0.5 - half, 0.5 - half, 0.5 + half, 0.5 + half),
        gt_side, gt_side * d.bbox_grid / d.cropbox_grid,
    ).astype(np.float32).reshape(-1)


def first_frame_gt(cfg, normalized_bbox, transformation) -> np.ndarray:
    """The frame-0 Gaussian target indicator (test_tracker.py:384-394),
    on a sqrt(num_features)-sided grid."""
    d = cfg.data
    gt_side = int(round(cfg.num_features ** 0.5))
    return geometry.generate_gt(
        geometry.apply_transformation(normalized_bbox, transformation),
        gt_side, gt_side * d.bbox_grid / d.cropbox_grid,
    ).astype(np.float32)


@dataclasses.dataclass
class StreamingTracker:
    """Host-side tracking loop: crop geometry + one frame step per frame.

    init(first frame, region) then track(frame) per frame, re-cropping
    around the previous prediction each time (test_tracker.py:301-329).
    Runs on cuda unless `device` names another device."""

    cfg: TrackerConfig
    vgg_params: Any
    params: Any
    core: Optional[MemoryCore] = None
    delimiter_first: bool = False
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.core is None:
            self.core = make_core(self.cfg)
        self.params = _to_device(self.params, self.device)
        self._step_first, self._step_rest = build_frame_step(
            self.cfg, self.core, self.vgg_params, self.params,
            delimiter_first=self.delimiter_first, device=self.device,
        )
        self._mean = torch.as_tensor(VGG_MEAN, device=self.device)

    def _crop(self, image: np.ndarray) -> torch.Tensor:
        # mean-subtract BEFORE cropping, so out-of-image samples are 0 in
        # network space (test_tracker.py:350-354)
        img = torch.as_tensor(image, device=self.device).float() - self._mean
        box = torch.as_tensor(self.cropbox, dtype=torch.float32, device=self.device)
        size = self.cfg.data.crop_size
        return crop_and_resize(img[None], box[None], (size, size))

    def _update_bbox(self, image_size, region_xywh):
        self.normalized_bbox, self.cropbox, self.transformation = region_geometry(
            self.cfg.data, image_size, region_xywh
        )

    def init(self, image: np.ndarray, region_xywh) -> None:
        """First frame: build the state, present the target-indicated frame."""
        h, w, _ = image.shape
        self.image_size = (w, h)
        self._update_bbox(self.image_size, region_xywh)
        gt = first_frame_gt(self.cfg, self.normalized_bbox, self.transformation)
        with torch.no_grad():
            state = self.core.init_state(self.params, 1)
        _, self.state = self._step_first(
            self._crop(image), torch.as_tensor(gt.reshape(1, -1), device=self.device), state
        )

    def track(self, image: np.ndarray):
        """One frame: crop around the previous box, step, decode, re-crop.
        Returns the (x, y, w, h) pixel region."""
        offsets, self.state = self._step_rest(self._crop(image), self.state)
        d = self.cfg.data
        init_bbox = geometry.initial_transformed_bbox(d.cropbox_grid, d.bbox_grid)
        self.output_bbox = decode_head(self.cfg, init_bbox, offsets[0].cpu().numpy())
        region = decode_region(self.transformation, self.image_size, self.output_bbox)
        self._update_bbox(self.image_size, region)
        return region
