"""The multi-experiment lab: the reference's main.py experiments
(counterpart of ntm_tracker_tpu/train/zoo.py):

  * ntm()/ntm_two_step() whole-frame presentation  <- main.py:780-977
  * ntm_sequential() per-feature two-step stream   <- main.py:979-1291
  * ntm_sevenbyseven()/ntm_8by8() heatmap CE       <- main.py:1646-2297
  * lstm_only() baseline                           <- main.py:695-778
  * the learned 1x1-conv input compressor          <- main.py:1005-1012
  * sanity_check_compressor (+ the PCA variant)    <- main.py:1425-1538
  * find_validation_batch                          <- main.py:2299-2320

(copy_paste lives in train/experiments.py.) The PCA of sanity_check_pca
is a centred SVD here (the card's machine has no sklearn): the cosine
check it feeds does not change when a component flips sign, so it matches
sklearn's exact solvers.
"""

from __future__ import annotations

import pickle
import random as _random
from typing import Any, Dict, Optional

import numpy as np
import torch

from ntm_tracker_tpu_torch.config import NTMConfig
from ntm_tracker_tpu_torch.models.ntm_tracker import ntm_tracker_unroll, two_step_inputs
from ntm_tracker_tpu_torch.ops.lstm import init_lstm_params, multi_lstm_step, zero_lstm_state
from ntm_tracker_tpu_torch.ops.memory import batched_smooth_cosine_similarity
from ntm_tracker_tpu_torch.train.serialize import heatmap_loss, serialize_tokens

# ---------------------------------------------------------------------------
# the input compressor (a 1x1 conv over channels, xavier init), main.py:1005-1012
# ---------------------------------------------------------------------------


def init_compressor(in_channels: int, compress_dim: int, generator: Optional[torch.Generator] = None,
                    device=None) -> torch.Tensor:
    """Xavier/Glorot-uniform [C_in, C_out] (tf.contrib.layers.xavier_initializer)."""
    limit = float(np.sqrt(6.0 / (in_channels + compress_dim)))
    return ((2 * torch.rand(in_channels, compress_dim, generator=generator) - 1) * limit).to(device)


def compress_features(features: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The 1x1 conv as a product on the channel axis: [..., C] -> [..., D]."""
    return features @ w


# ---------------------------------------------------------------------------
# the sequential serialization, main.py:1040-1105
# token order: frame 0's F feature tokens; then per frame t >= 1
#   [frame delimiter] + [feature, feature delimiter] * F
# channels: [C | feature delim | frame delim | target]
# ---------------------------------------------------------------------------


def serialize_sequential_tokens(features: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """features [B,L,F,C], target [B,F] -> [B, F+(L-1)(2F+1), C+3]."""
    B, L, F, C = features.shape
    padded = torch.cat([features, features.new_zeros(B, L, F, 2)], dim=3)          # [B,L,F,C+2]
    feature_delim = features.new_zeros(B, L - 1, F, C + 2)
    feature_delim[..., C] = 1.0
    # each feature token followed by a feature delimiter
    inter = torch.cat([padded[:, 1:], feature_delim], dim=3).reshape(B, L - 1, 2 * F, C + 2)
    frame_delim = features.new_zeros(B, L - 1, 1, C + 2)
    frame_delim[..., C + 1] = 1.0
    per_frame = torch.cat([frame_delim, inter], dim=2)                              # [B,L-1,2F+1,C+2]
    stream = torch.cat([padded[:, 0], per_frame.reshape(B, (L - 1) * (2 * F + 1), C + 2)], dim=1)
    total = sequential_total_steps(F, L)
    tgt = torch.cat([target.to(features.dtype), features.new_zeros(B, total - F)], dim=1)
    return torch.cat([stream, tgt[..., None]], dim=2)


def sequential_gather(logits: torch.Tensor, num_features: int) -> torch.Tensor:
    """The per-feature predictions at the feature-delimiter steps
    (main.py:1219-1232): logits [B,T,1] -> [B, L-1, F]."""
    B, F = logits.shape[0], num_features
    x = logits[:, F:, 0]                                   # drop frame 0
    L1 = x.shape[1] // (2 * F + 1)
    x = x.reshape(B, L1, 2 * F + 1)[:, :, 1:]              # drop the frame delimiter
    return x.reshape(B, L1, F, 2)[:, :, :, 1]              # keep the feature-delimiter slot


def sequential_ce_loss(logits: torch.Tensor, gts: torch.Tensor, num_features: int) -> torch.Tensor:
    """Softmax CE summed over frames 1..L-1, / (L-1) (main.py:1242-1247)."""
    out = sequential_gather(logits, num_features)
    return -torch.sum(gts[:, 1:, :] * torch.log_softmax(out, dim=-1)) / out.shape[1]


def sequential_total_steps(num_features: int, sequence_length: int) -> int:
    return num_features + (sequence_length - 1) * (2 * num_features + 1)


# ---------------------------------------------------------------------------
# the whole-frame presentation (ntm / ntm_two_step), main.py:780-977
# ---------------------------------------------------------------------------


def whole_frame_tokens(features: torch.Tensor, target: torch.Tensor, two_step: bool) -> torch.Tensor:
    """features [B,L,F,C] flattened per frame; target [B,F], the indicator
    on frame 0 only (ntm_tracker_new.py:123-190)."""
    B, L, F, C = features.shape
    flat = features.reshape(B, L, F * C)
    if two_step:
        return two_step_inputs(flat, target)
    dummy = torch.zeros_like(target)
    return torch.stack([torch.cat([flat[:, t], target if t == 0 else dummy], dim=1) for t in range(L)], dim=1)


def whole_frame_ce_loss(logits: torch.Tensor, gts: torch.Tensor, two_step: bool) -> torch.Tensor:
    """CE(logits, softmax(labels)) with the reference's label layout.

    two_step=False (ntm(), main.py:844-850): labels = softmax(gt) per
    frame, over L*B; logits [B,L,F].
    two_step=True (ntm_two_step(), main.py:916-956): output dim F+1 (the
    "background" bit); the 2L-1 steps' labels are [0...0, 1] on frame 0's
    step and every present step, [gt_t, 0] on each ask step, softmaxed,
    over (2L-1)*B; logits [B, 2L-1, F+1].
    """
    B, L, F = gts.shape
    if two_step:
        zeros, ones = gts.new_zeros, gts.new_ones
        background = torch.cat([zeros(B, L - 1, F), ones(B, L - 1, 1)], dim=2)
        gt_aug = torch.cat([gts[:, 1:, :], zeros(B, L - 1, 1)], dim=2)
        pairs = torch.stack([background, gt_aug], dim=2).reshape(B, 2 * (L - 1), F + 1)
        first = torch.cat([zeros(B, 1, F), ones(B, 1, 1)], dim=2)
        labels = torch.cat([first, pairs], dim=1)
        denom = (2 * L - 1) * B
    else:
        labels, denom = gts, L * B
    labels = torch.softmax(labels, dim=-1)
    return -torch.sum(labels * torch.log_softmax(logits, dim=-1)) / denom


# ---------------------------------------------------------------------------
# the lstm_only baseline, main.py:695-778
# ---------------------------------------------------------------------------


def init_lstm_baseline(num_features: int, compress_dim: int, hidden_size: int, num_layers: int,
                       init_scale: float = 0.1, generator: Optional[torch.Generator] = None,
                       device=None) -> Dict[str, Any]:
    in_dim = num_features * compress_dim + num_features  # features + indicator
    return {
        "lstm": init_lstm_params(in_dim, hidden_size, num_layers, init_scale, generator, device),
        "softmax_w": ((2 * torch.rand(hidden_size, num_features, generator=generator) - 1) * init_scale).to(device),
        "softmax_b": torch.zeros(num_features, device=device),
    }


def lstm_baseline_forward(params: Dict[str, Any], features: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """features [B,L,F,D] (compressed), target [B,F] -> logits [B,L,F]."""
    B, L, F, D = features.shape
    flat = features.reshape(B, L, F * D)
    state = zero_lstm_state(B, params["softmax_w"].shape[0], len(params["lstm"]), device=features.device)
    dummy = torch.zeros_like(target)
    outs = []
    for t in range(L):
        out, state = multi_lstm_step(params["lstm"], torch.cat([flat[:, t], target if t == 0 else dummy], dim=1),
                                     state)
        outs.append(out)
    return torch.stack(outs, dim=1) @ params["softmax_w"] + params["softmax_b"]


def lstm_baseline_loss(params, features, target, gts) -> torch.Tensor:
    """CE(logits, softmax(gt)) / L (main.py:763-765)."""
    logits = lstm_baseline_forward(params, features, target)
    return -torch.sum(torch.softmax(gts, dim=-1) * torch.log_softmax(logits, dim=-1)) / logits.shape[1]


# ---------------------------------------------------------------------------
# sanity checks, main.py:1425-1538
# ---------------------------------------------------------------------------


def sanity_check_similarity(features: torch.Tensor, gts: torch.Tensor,
                            compressor_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Can cosine similarity alone reproduce the gt heatmap? Frame 0's
    target-weighted feature is matched against every location of every
    frame: features [B,L,F,C], gts [B,L,F] -> similarity [B,L,F]
    (main.py:1466-1483)."""
    if compressor_w is not None:
        features = compress_features(features, compressor_w)
    B, L, F, C = features.shape
    first = torch.einsum("bf,bfc->bc", gts[:, 0, :], features[:, 0])[:, None, :]
    return batched_smooth_cosine_similarity(features.reshape(B, L * F, C), first).reshape(B, L, F)


def sanity_check_pca(features: np.ndarray, gts: torch.Tensor, compress_dim: int) -> torch.Tensor:
    """The PCA variant (main.py:1512-1528): the features projected on their
    first compress_dim principal components (a centred SVD on the host, in
    float64), then the same cosine check."""
    B, L, F, C = features.shape
    flat = np.reshape(np.asarray(features, np.float64), (B * L * F, C))
    centred = flat - flat.mean(axis=0)
    _, _, vt = np.linalg.svd(centred, full_matrices=False)
    reduced = (centred @ vt[:compress_dim].T).astype(np.float32)
    return sanity_check_similarity(torch.as_tensor(reduced.reshape(B, L, F, compress_dim), device=gts.device), gts)


# ---------------------------------------------------------------------------
# find_validation_batch, main.py:2299-2320
# ---------------------------------------------------------------------------


def find_validation_batch(sequences_dir: str, target_step: int = 1700, batch_size: int = 1, min_length: int = 20,
                          validation_interval: int = 100, seed: int = 42, dump_path: Optional[str] = None):
    """Replay the reference's training-loop RNG schedule (one shared
    random.Random alternating train and val shuffles, main.py:2299-2320) to
    recover which validation batch a reference run used at `target_step`.
    It reconstructs reference runs: this package's train loop draws its
    train and validation batches from streams of their own."""
    from ntm_tracker_tpu_torch.data.sequences import get_valid_sequences

    rng = _random.Random(seed)
    _, train_seqs, val_seqs = get_valid_sequences(sequences_dir, min_length)
    train_seqs = train_seqs[:len(train_seqs) // batch_size * batch_size]
    val_seqs = val_seqs[:len(val_seqs) // batch_size * batch_size]
    rng.shuffle(train_seqs)
    for step in range(target_step + 1):
        if step % validation_interval == 0:
            rng.shuffle(val_seqs)
        if step == target_step:
            break
    if dump_path:
        with open(dump_path, "wb") as f:
            pickle.dump(val_seqs, f)
    return val_seqs


# ---------------------------------------------------------------------------
# the heatmap experiments' loss (sevenbyseven / 8by8)
# ---------------------------------------------------------------------------


def heatmap_loss_fn(params, ncfg: NTMConfig, features: torch.Tensor, gts: torch.Tensor,
                    compressor_w: Optional[torch.Tensor] = None, sequential: bool = False) -> torch.Tensor:
    """The heatmap experiments' loss: features [B,L,F,C], gts [B,L,F].

    sequential=False: the frame-token stream (F+1 a frame), the CE at the
    delimiter steps (ntm_sevenbyseven/ntm_8by8, main.py:1919-1923).
    sequential=True: the per-feature stream (ntm_sequential, main.py:1242-1247).
    The unroll is ntm_tracker_unroll's default, the plain loop.
    """
    if compressor_w is not None:
        features = compress_features(features, compressor_w)
    F = features.shape[2]
    if sequential:
        _, logits, _ = ntm_tracker_unroll(params, ncfg, serialize_sequential_tokens(features, gts[:, 0, :]))
        return sequential_ce_loss(logits, gts, F)
    _, logits, _ = ntm_tracker_unroll(params, ncfg, serialize_tokens(features, gts[:, 0, :]))
    return heatmap_loss(logits, gts, F)
