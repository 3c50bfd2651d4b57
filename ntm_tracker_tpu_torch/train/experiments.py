"""The experiments (counterpart of ntm_tracker_tpu/train/experiments.py):
the offset tracker (NTM or DNC core) with its memory dashboards, the
heatmap experiments, the whole-frame experiments and the copy-paste
sanity task.

Batches are dicts of numpy arrays or tensors in the loader's layout; the
experiment moves them to its device. Images go through the frozen VGG
("cropped", "resized" or "raw" frames) or arrive as cached tokens
("features", the feature-cache path, float16 on disk). The port has no
counterpart of disable_fused_bptt / train_step_with_bptt_fallback: a
kernel that fails to build or launch raises, and no step moves to the
plain route on its own.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ntm_tracker_tpu_torch.config import TrackerConfig, resolve_device, validate_head
from ntm_tracker_tpu_torch.data.image_ops import preprocess_frame
from ntm_tracker_tpu_torch.models.core import MemoryCore, make_core, unroll_states
from ntm_tracker_tpu_torch.models.ntm_tracker import ntm_tracker_unroll
from ntm_tracker_tpu_torch.models.vgg import VGG_MEAN, extract_features, vgg16_conv43_tokens, vgg16_features
from ntm_tracker_tpu_torch.train.optim import TFRMSProp, reference_optimizer, tree_leaves, tree_map
from ntm_tracker_tpu_torch.train.serialize import (
    gather_delimiter_outputs,
    heatmap_loss,
    offsets_loss,
    serialize_tokens,
)
from ntm_tracker_tpu_torch.train.zoo import (
    compress_features,
    init_compressor,
    sequential_ce_loss,
    serialize_sequential_tokens,
    whole_frame_ce_loss,
    whole_frame_tokens,
)
from ntm_tracker_tpu_torch.utils import profiling

IMAGE_MODES = ("raw", "resized", "cropped")


def frame_tokens(cfg: TrackerConfig, vgg_params, crops: torch.Tensor) -> torch.Tensor:
    """[N, crop, crop, 3] mean-subtracted crops -> [N, F, C] frozen VGG
    tokens. Takes the exact receptive-field slice (vgg16_conv43_tokens)
    whenever it applies, and its int8 twin (models/vgg_int8.py) under
    cfg.vgg_int8, which exists only there."""
    if cfg.fast_conv43 and cfg.feature_points is None and crops.shape[1] == crops.shape[2] == 224:
        if cfg.vgg_int8:
            from ntm_tracker_tpu_torch.models.vgg_int8 import vgg16_conv43_tokens_int8

            return vgg16_conv43_tokens_int8(vgg_params, crops)
        return vgg16_conv43_tokens(vgg_params, crops, compute_dtype=cfg.compute_dtype)
    if cfg.vgg_int8:
        # never serve the exact path when the quantized one was asked for
        raise ValueError(
            "vgg_int8=True requires the canonical fast-conv43 config (fast_conv43=True, feature_points=None, "
            f"224x224 crops); got crop {crops.shape[1]}x{crops.shape[2]}, feature_points="
            f"{'custom' if cfg.feature_points is not None else 'None'}, fast_conv43={cfg.fast_conv43}"
        )
    feats = vgg16_features(vgg_params, crops, compute_dtype=cfg.compute_dtype)
    if cfg.feature_points is None:
        return extract_features(feats)
    return extract_features(feats, list(cfg.feature_points))


def gradient_step(loss_fn: Callable, opt: TFRMSProp, reduce: Optional[Callable] = None,
                  keep_grads: bool = False) -> Callable:
    """train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss"[, "grads"]}): loss_fn(params, batch) -> (loss, aux)
    differentiated wrt every param (a param the loss does not reach gets a
    zero gradient), then opt's clip and TF RMSProp. reduce(grads, loss) ->
    (grads, loss), when given, runs between the gradient and the update,
    on the gradients in tree_leaves order (parallel/mesh.py's all-reduce
    over the process group). keep_grads adds the gradients the update
    took, before its clip, under "grads". A step is the span `train.step`
    (utils/profiling): the host's time to issue it."""

    def train_step(params, opt_state, batch):
        with profiling.span("train.step"):
            leaves = tree_leaves(params)
            live = tree_map(lambda p: p.detach().requires_grad_(), params)
            loss, _ = loss_fn(live, batch)
            grads = torch.autograd.grad(loss, tree_leaves(live), allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
            loss = loss.detach()
            if reduce is not None:
                grads, loss = reduce(grads, loss)
            fill = iter(grads)
            grad_tree = tree_map(lambda _: next(fill), params)
            params, opt_state = opt.update(grad_tree, opt_state, params)
        metrics = {"loss": loss}
        if keep_grads:
            metrics["grads"] = grad_tree
        return params, opt_state, metrics

    return train_step


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

    # subclasses with other heads (HeatmapExperiment) skip the (dy, dx[, ds])
    # output_dim check
    _offsets_head = True

    def __post_init__(self):
        if self._offsets_head:
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
        batch = self.device_batch(batch)
        tokens, core_params = self._tokens(params, batch)
        logits, _ = self.core.unroll(core_params, tokens)
        aux = self._eval_aux_from_logits(logits, batch)
        return aux["loss"], aux

    # ---- steps -----------------------------------------------------------
    def make_train_step(self) -> Callable:
        """train_step(params, opt_state, batch) -> (params, opt_state,
        {"loss"}): the loss's gradient, clipped, through TF RMSProp. Which
        cell route it takes follows cfg.train.fused_bptt; a kernel that
        fails to build or launch raises."""
        return gradient_step(self.loss_fn, self.optimizer())

    def make_eval_step(self) -> Callable:
        """eval_step(params, batch) -> the loss's aux, without gradients (on
        cuda the fused route takes B1)."""

        @torch.no_grad()
        def eval_step(params, batch):
            _, aux = self.loss_fn(params, batch)
            return aux

        return eval_step

    # ---- the memory dashboards --------------------------------------------
    def _tokens(self, params, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Any]:
        """(the token stream, the core's params) of a device batch."""
        cfg = self.cfg
        features = self.batch_features(batch)
        B = features.shape[0]
        gts = batch["gts"].float().reshape(B, cfg.train.sequence_length, cfg.num_features)
        return serialize_tokens(features, gts[:, 0, :]), params

    @torch.no_grad()
    def memory_states(self, params, batch: Dict[str, Any], stride: Optional[int] = None,
                      max_snapshots: int = 256) -> dict:
        """The memory observables over the token stream, for the
        dashboards (the reference's Ms/ws/reads summaries,
        main.py:1186-1214): {"M": [B,T//stride,N,D], "w": ..., "read": ...}.
        stride=None takes the least stride that keeps at most
        max_snapshots snapshots."""
        tokens, core_params = self._tokens(params, self.device_batch(batch))
        if stride is None:
            stride = max(1, -(-tokens.shape[1] // max_snapshots))
        _, views, _ = unroll_states(self.core, core_params, tokens, stride=stride)
        return views

    @torch.no_grad()
    def eval_with_views(self, params, batch: Dict[str, Any], max_snapshots: int = 256) -> Tuple[Dict, Dict]:
        """(the eval aux, the memory views) from ONE forward: the tokens and
        the T-step unroll serve the validation loss and the dashboards (the
        --save_imgs path)."""
        batch = self.device_batch(batch)
        tokens, core_params = self._tokens(params, batch)
        stride = max(1, -(-tokens.shape[1] // max_snapshots))
        logits, views, _ = unroll_states(self.core, core_params, tokens, stride=stride, full_logits=True)
        return self._eval_aux_from_logits(logits, batch), views

    def _eval_aux_from_logits(self, logits: torch.Tensor, batch) -> Dict:
        """The loss and its aux from the full [B, T, out] logits; the
        heatmap experiments override it."""
        cfg = self.cfg
        B = logits.shape[0]
        loss = offsets_loss(logits, self._targets(batch, B), cfg.num_features)
        preds = torch.tanh(gather_delimiter_outputs(logits, cfg.num_features))
        return {"loss": loss, "pred_offsets": preds}


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


def device_cached_batch(cfg: TrackerConfig, seed: int, device) -> Dict[str, torch.Tensor]:
    """synthetic_cached_batch's layout and ranges on `device` (float16 tokens
    in [0, 40)), without its host draws: the labels from
    RandomState(seed), the tokens drawn on the device from a generator
    seeded with `seed`. Not the JAX package's numbers; the bench's and the
    smoke's set-up (at B=256, L=20 the host draws take ~10 s)."""
    n = cfg.train.batch_size * cfg.train.sequence_length
    device = torch.device(device)
    labels = _synthetic_labels(cfg, np.random.RandomState(seed))
    batch = {k: torch.as_tensor(v, device=device) for k, v in labels.items()}
    batch["features"] = (torch.rand(n, cfg.num_features, cfg.feature_depth, device=device,
                                    generator=torch.Generator(device=device).manual_seed(seed)) * 40).half()
    return batch


@dataclasses.dataclass
class HeatmapExperiment(OffsetExperiment):
    """The heatmap-output variants: the core emits per-location logits and
    the loss is softmax CE against the gt heatmap at the gathered steps.

    serialization="sequential": the reference's structure (ntm_sevenbyseven,
        ntm_8by8, ntm_sequential: the per-feature 2F+1 token stream, a
        scalar output at each feature-delimiter step, main.py:1646-2297,
        :979-1291); output_dim 1.
    serialization="frame": F tokens and a delimiter a frame, the F-wide
        heatmap read at the delimiter steps (a variant the reference lacks,
        20x fewer steps, the same loss); output_dim num_features.
    compress_dim > 0 adds the learned 1x1-conv input compressor; its weight
    is params["compressor"] and trains with the core (on cuda the fused
    BPTT then computes the tokens' gradient).
    """

    serialization: str = "sequential"
    compress_dim: int = 0
    _offsets_head = False

    def init(self, generator: torch.Generator | None = None):
        depth = self.compress_dim or self.cfg.feature_depth
        # + feature delimiter, frame delimiter, target (sequential) or
        # + delimiter, target (frame)
        input_size = depth + (3 if self.serialization == "sequential" else 2)
        params = {"core": self.core.init_params(generator, input_size, self.device)}
        if self.compress_dim:
            params["compressor"] = init_compressor(self.cfg.feature_depth, self.compress_dim, generator, self.device)
        return params, self.optimizer().init(params)

    def _tokens(self, params, batch):
        cfg = self.cfg
        features = self.batch_features(batch)
        if self.compress_dim:
            features = compress_features(features, params["compressor"])
        B = features.shape[0]
        gts = batch["gts"].float().reshape(B, cfg.train.sequence_length, cfg.num_features)
        if self.serialization == "sequential":
            return serialize_sequential_tokens(features, gts[:, 0, :]), params["core"]
        return serialize_tokens(features, gts[:, 0, :]), params["core"]

    def _eval_aux_from_logits(self, logits: torch.Tensor, batch) -> Dict:
        cfg = self.cfg
        gts = batch["gts"].float().reshape(logits.shape[0], cfg.train.sequence_length, cfg.num_features)
        if self.serialization == "sequential":
            loss = sequential_ce_loss(logits, gts, cfg.num_features)
        else:
            loss = heatmap_loss(logits, gts, cfg.num_features)
        return {"loss": loss}


# ---------------------------------------------------------------------------
# the copy-paste sanity task (main.py:1540-1644): a random bit pattern, a
# delimiter, then the NTM reproduces the pattern; it checks the memory core
# apart from tracking
# ---------------------------------------------------------------------------


def make_copy_paste_batch(rng: np.random.RandomState, batch: int, width: int,
                          length: int) -> Tuple[np.ndarray, np.ndarray]:
    """(inputs [B, 2L+1, width+1], labels [B, 2L+1, width+1])."""
    bits = rng.randint(0, 2, size=(batch, width, length)).astype(np.float32)
    inp = np.concatenate([bits, np.zeros((batch, 1, length), np.float32)], 1)
    delim = np.concatenate([np.zeros((batch, width, 1), np.float32), np.ones((batch, 1, 1), np.float32)], 1)
    pad = np.zeros_like(inp)
    labels = np.concatenate([pad, np.zeros_like(delim), inp], 2)
    inputs = np.concatenate([inp, delim, pad], 2)
    return inputs.transpose(0, 2, 1), labels.transpose(0, 2, 1)


def copy_paste_loss(params, cfg, inputs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Log loss on sigmoids (tf.losses.log_loss, main.py:1612), through
    ntm_tracker_unroll's default route, the plain loop (as JAX's, whose
    default fused_bptt is False), on any device."""
    _, logits, _ = ntm_tracker_unroll(params, cfg, inputs)
    p = torch.sigmoid(logits)
    eps = 1e-7
    return -torch.mean(labels * torch.log(p + eps) + (1 - labels) * torch.log(1 - p + eps))


@dataclasses.dataclass
class WholeFrameExperiment:
    """The original ntm()/ntm_two_step() experiments (main.py:780-977):
    the whole feature map presented each frame (with the two-step
    present/ask protocol when two_step), CE against softmax(gt heatmap), fed
    by the pickled mined dataset (data/pickle_dataset.py).

    endpoint="pool5" is the 7x7 (49-feature) grid these experiments ran on;
    the learned 1x1-conv compressor shrinks the channels before the
    flatten (main.py:710-715, always on in the reference). Runs on `device`:
    cuda unless the caller passes another."""

    cfg: TrackerConfig
    vgg_params: Any
    endpoint: str = "pool5"
    two_step: bool = False
    compress_dim: int = 128
    core: MemoryCore = None  # type: ignore[assignment]
    device: Any = None

    def __post_init__(self):
        from ntm_tracker_tpu_torch.data.mining import vgg_layer_sizes

        _, h, w, _ = vgg_layer_sizes(self.cfg.data.crop_size)[self.endpoint.split("/")[-1]]
        self.num_features = h * w
        # two_step adds the "background" output bit (main.py:891)
        out_dim = self.num_features + (1 if self.two_step else 0)
        self.cfg = dataclasses.replace(
            self.cfg,
            ntm=dataclasses.replace(self.cfg.ntm, output_dim=out_dim),
            dnc=dataclasses.replace(self.cfg.dnc, output_dim=out_dim),
        )
        if self.core is None:
            self.core = make_core(self.cfg)
        self.device = resolve_device(self.device)

    def init(self, generator: torch.Generator | None = None):
        F = self.num_features
        # the flat features + the indicator (+ the ask/present switch bit)
        input_size = F * self.compress_dim + F + (1 if self.two_step else 0)
        params = {
            "core": self.core.init_params(generator, input_size, self.device),
            "compressor": init_compressor(self.cfg.feature_depth, self.compress_dim, generator, self.device),
        }
        return params, self.optimizer().init(params)

    def optimizer(self) -> TFRMSProp:
        t = self.cfg.train
        return reference_optimizer(t.learning_rate, t.decay, t.momentum, 1e-10, t.max_gradient_norm)

    def features(self, images) -> torch.Tensor:
        """[B*L, S, S, 3] frames (read_imgs: resized, not cropped) -> [B, L,
        h*w, C] frozen VGG features at the endpoint, the VGG mean subtracted
        after the resize (main.py:311)."""
        L = self.cfg.train.sequence_length
        images = torch.as_tensor(images, device=self.device).float() - torch.as_tensor(VGG_MEAN, device=self.device)
        with torch.no_grad():
            feats = vgg16_features(self.vgg_params, images, endpoint=self.endpoint,
                                   compute_dtype=self.cfg.compute_dtype)
        BL, h, w, C = feats.shape
        return feats.reshape(BL // L, L, h * w, C)

    def loss_fn(self, params, batch):
        feats = compress_features(self.features(batch["images"]), params["compressor"])
        gts = torch.as_tensor(batch["gts"], device=self.device).float()
        if gts.shape[-1] != self.num_features:
            raise ValueError(
                f"gt masks have {gts.shape[-1]} features but endpoint {self.endpoint!r} yields "
                f"{self.num_features}; mine-sequences --layers must match --feature_layer")
        gts = gts.reshape(feats.shape[0], self.cfg.train.sequence_length, self.num_features)
        tokens = whole_frame_tokens(feats, gts[:, 0, :], self.two_step)
        logits, _ = self.core.unroll(params["core"], tokens)
        loss = whole_frame_ce_loss(logits, gts, self.two_step)
        return loss, {"loss": loss}

    def make_train_step(self) -> Callable:
        return gradient_step(self.loss_fn, self.optimizer())
