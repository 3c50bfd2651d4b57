"""The offset tracker's experiment: loss, train step and eval step
(counterpart of ntm_tracker_tpu/train/experiments.py:33-198, :265-321).

Batches are dicts of numpy arrays or tensors in the loader's layout; the
experiment moves them to its device. Images go through the frozen VGG
("cropped", "resized" or "raw" frames) or arrive as cached tokens
("features", the feature-cache path, float16 on disk).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from ntm_tracker_tpu_torch.config import TrackerConfig, resolve_device, validate_head
from ntm_tracker_tpu_torch.data.image_ops import preprocess_frame
from ntm_tracker_tpu_torch.models.core import MemoryCore, make_core
from ntm_tracker_tpu_torch.models.vgg import extract_features, vgg16_conv43_tokens, vgg16_features
from ntm_tracker_tpu_torch.train.optim import TFRMSProp, reference_optimizer, tree_leaves, tree_map
from ntm_tracker_tpu_torch.train.serialize import gather_delimiter_outputs, offsets_loss, serialize_tokens

IMAGE_MODES = ("raw", "resized", "cropped")


def frame_tokens(cfg: TrackerConfig, vgg_params, crops: torch.Tensor) -> torch.Tensor:
    """[N, crop, crop, 3] mean-subtracted crops -> [N, F, C] frozen VGG
    tokens. Takes the exact receptive-field slice (vgg16_conv43_tokens)
    whenever it applies."""
    if cfg.vgg_int8:
        raise NotImplementedError("vgg_int8: the int8 VGG path is not ported")
    if cfg.fast_conv43 and cfg.feature_points is None and crops.shape[1] == crops.shape[2] == 224:
        return vgg16_conv43_tokens(vgg_params, crops, compute_dtype=cfg.compute_dtype)
    feats = vgg16_features(vgg_params, crops, compute_dtype=cfg.compute_dtype)
    if cfg.feature_points is None:
        return extract_features(feats)
    return extract_features(feats, list(cfg.feature_points))


@dataclasses.dataclass
class OffsetExperiment:
    """VID crops -> VGG tokens -> memory core -> per-frame (dy, dx[, ds])
    offsets with the L2-on-tanh loss. Runs on `device`: cuda unless the
    caller passes another (raises when cuda is asked for and absent)."""

    cfg: TrackerConfig
    vgg_params: Any
    core: MemoryCore = None  # type: ignore[assignment]
    image_mode: str = "cropped"
    device: Any = None

    def __post_init__(self):
        validate_head(self.cfg)
        if self.image_mode not in IMAGE_MODES:
            raise ValueError(f"image_mode must be one of {IMAGE_MODES}, got {self.image_mode!r}")
        if self.core is None:
            self.core = make_core(self.cfg)
        self.device = resolve_device(self.device)

    # ---- parameter/optimizer construction -------------------------------
    def init(self, generator: torch.Generator | None = None):
        """(params, opt_state) on the experiment's device."""
        params = self.core.init_params(generator, self.cfg.input_depth, self.device)
        return params, self.optimizer().init(params)

    def optimizer(self) -> TFRMSProp:
        t = self.cfg.train
        return reference_optimizer(t.learning_rate, t.decay, t.momentum, 1e-10, t.max_gradient_norm)

    def device_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The batch as tensors on the experiment's device (dtypes kept)."""
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}

    def _targets(self, batch: Dict[str, torch.Tensor], B: int) -> torch.Tensor:
        """[B, L, head_dim] supervision: (dy, dx) center offsets, plus the
        normalized log-scale target when cfg.predict_scale."""
        L = self.cfg.train.sequence_length
        t = torch.stack([batch["y_offsets"], batch["x_offsets"]], dim=1).float().reshape(B, L, 2)
        if self.cfg.predict_scale:
            t = torch.cat([t, batch["scales"].float().reshape(B, L, 1)], dim=-1)
        return t

    # ---- forward pieces --------------------------------------------------
    def images_to_crops(self, images: torch.Tensor, cropboxes: torch.Tensor) -> torch.Tensor:
        """[B*L, H, W, 3] frames -> [B*L, 224, 224, 3] mean-subtracted crops
        ("cropped" frames are crops already)."""
        if self.image_mode == "cropped":
            return images.float()
        d = self.cfg.data
        return preprocess_frame(images, cropboxes, resize_hw=d.resize_hw, crop_size=d.crop_size,
                                do_resize=self.image_mode == "raw")

    def crops_to_tokens(self, crops: torch.Tensor, vgg_params=None) -> torch.Tensor:
        """[B*L, 224, 224, 3] -> [B, L, 64, 512] frozen VGG tokens."""
        with torch.no_grad():
            toks = frame_tokens(self.cfg, self.vgg_params if vgg_params is None else vgg_params, crops)
        L = self.cfg.train.sequence_length
        return toks.reshape(toks.shape[0] // L, L, self.cfg.num_features, self.cfg.feature_depth)

    def batch_features(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """[B, L, F, C] float32 tokens: the cached "features", or the frozen
        VGG over the batch's "images" and "cropboxes"."""
        cfg = self.cfg
        if "features" in batch:
            f = batch["features"].float()
            L = cfg.train.sequence_length
            return f.reshape(f.shape[0] // L, L, cfg.num_features, cfg.feature_depth)
        return self.crops_to_tokens(self.images_to_crops(batch["images"], batch["cropboxes"]))

    def loss_fn(self, params: Any, batch: Dict[str, Any]) -> Tuple[torch.Tensor, Dict]:
        cfg = self.cfg
        batch = self.device_batch(batch)
        L = cfg.train.sequence_length
        features = self.batch_features(batch)
        B = features.shape[0]
        gts = batch["gts"].float().reshape(B, L, cfg.num_features)
        tokens = serialize_tokens(features, gts[:, 0, :])
        logits, _ = self.core.unroll(params, tokens)
        loss = offsets_loss(logits, self._targets(batch, B), cfg.num_features)
        preds = torch.tanh(gather_delimiter_outputs(logits, cfg.num_features))
        return loss, {"loss": loss, "pred_offsets": preds}

    # ---- steps -----------------------------------------------------------
    def make_train_step(self) -> Callable:
        """train_step(params, opt_state, batch) -> (params, opt_state,
        {"loss"}): the loss's gradient, clipped, through TF RMSProp. Which
        cell route it takes follows cfg.train.fused_bptt; a kernel that
        fails to build or launch raises."""
        opt = self.optimizer()

        def train_step(params, opt_state, batch):
            leaves = tree_leaves(params)
            live = tree_map(lambda p: p.detach().requires_grad_(), params)
            loss, _ = self.loss_fn(live, batch)
            grads = torch.autograd.grad(loss, tree_leaves(live), allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
            it = iter(grads)
            params, opt_state = opt.update(tree_map(lambda _: next(it), params), opt_state, params)
            return params, opt_state, {"loss": loss.detach()}

        return train_step

    def make_eval_step(self) -> Callable:
        """eval_step(params, batch) -> {"loss", "pred_offsets"}, without
        gradients (on cuda the fused route takes the residual-free kernel)."""

        @torch.no_grad()
        def eval_step(params, batch):
            _, aux = self.loss_fn(params, batch)
            return aux

        return eval_step


def synthetic_offset_batch(cfg: TrackerConfig, rng: np.random.RandomState,
                           image_mode: str = "cropped") -> Dict[str, np.ndarray]:
    """A fabricated batch with the loader's layout, drawn from `rng` in
    the JAX package's order (same seed, same arrays)."""
    B, L = cfg.train.batch_size, cfg.train.sequence_length
    d = cfg.data
    n = B * L
    if image_mode == "cropped":
        images = rng.rand(n, d.crop_size, d.crop_size, 3).astype(np.float32) * 50
    elif image_mode == "resized":
        images = (rng.rand(n, *d.resize_hw, 3) * 255).astype(np.float32)
    else:
        images = (rng.rand(n, 360, 640, 3) * 255).astype(np.float32)
    batch = {
        "images": images,
        "cropboxes": np.tile(np.array([0.2, 0.2, 0.8, 0.8], np.float32), (n, 1)),
    }
    batch.update(_synthetic_labels(cfg, rng))
    return batch


def _synthetic_labels(cfg: TrackerConfig, rng: np.random.RandomState) -> Dict[str, np.ndarray]:
    n = cfg.train.batch_size * cfg.train.sequence_length
    gw = cfg.data.gt_width
    gts = rng.rand(n, gw, gw).astype(np.float32)
    gts /= gts.sum(axis=(1, 2), keepdims=True)
    out = {
        "gts": gts,
        "y_offsets": (rng.rand(n).astype(np.float32) - 0.5) * 0.4,
        "x_offsets": (rng.rand(n).astype(np.float32) - 0.5) * 0.4,
    }
    if cfg.predict_scale:
        out["scales"] = (rng.rand(n).astype(np.float32) - 0.5) * 0.8
    return out


def synthetic_cached_batch(cfg: TrackerConfig, rng: np.random.RandomState) -> Dict[str, np.ndarray]:
    """A fabricated pre-tokenized batch with the feature-cache layout:
    float16 conv4_3-scale tokens instead of images, drawn from `rng` in the
    JAX package's order. The JAX function draws (and drops) a "cropped"
    image batch first; this one draws the same numbers in chunks instead
    of holding them (3 GB at B=256, L=20)."""
    n = cfg.train.batch_size * cfg.train.sequence_length
    todo = n * cfg.data.crop_size * cfg.data.crop_size * 3
    while todo:
        step = min(todo, 1 << 24)
        rng.rand(step)
        todo -= step
    batch = _synthetic_labels(cfg, rng)
    batch["features"] = (rng.rand(n, cfg.num_features, cfg.feature_depth) * 40).astype(np.float16)
    return batch
