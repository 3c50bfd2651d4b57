"""Token-stream serialization, the offsets loss and the heatmap loss
(counterpart of ntm_tracker_tpu/train/serialize.py).

Channel layout [C features | delimiter bit | target bit]; one delimiter
token per frame; the target channel carries frame 0's gt heatmap on its
feature tokens.
"""

from __future__ import annotations

from typing import Optional

import torch


def serialize_tokens(features: torch.Tensor, target_heatmap: torch.Tensor) -> torch.Tensor:
    """features [B, L, F, C], target_heatmap [B, F] -> [B, L*(F+1), C+2],
    each frame's delimiter token last."""
    B, L, F, C = features.shape
    feat = torch.cat([features, features.new_zeros(B, L, F, 1)], dim=3)
    delim = features.new_zeros(B, L, 1, C + 1)
    delim[..., C] = 1.0
    toks = torch.cat([feat, delim], dim=2).reshape(B, L * (F + 1), C + 1)
    target = torch.cat(
        [target_heatmap.to(features.dtype), features.new_zeros(B, (L - 1) * (F + 1) + 1)],
        dim=1,
    )
    return torch.cat([toks, target[..., None]], dim=2)


def serialize_streaming_batch(
    features: torch.Tensor,
    target_heatmap: Optional[torch.Tensor],
    delimiter_first: bool = True,
) -> torch.Tensor:
    """One frame's F+1 tokens per batch row: features [B, F, C] and
    target_heatmap [B, F] or None -> [B, F+1, C+2]. delimiter_first=True
    is the reference's streaming order (test_tracker.py:384-405); False
    is the training order."""
    B, F, C = features.shape
    if target_heatmap is None:
        tgt = features.new_zeros(B, F, 1)
    else:
        tgt = target_heatmap.reshape(B, F, 1).to(features.dtype)
    feat = torch.cat([features, features.new_zeros(B, F, 1), tgt], dim=2)
    delim = features.new_zeros(B, 1, C + 2)
    delim[:, 0, C] = 1.0
    if delimiter_first:
        return torch.cat([delim, feat], dim=1)
    return torch.cat([feat, delim], dim=1)


def serialize_streaming_frame(
    features: torch.Tensor, target_heatmap: Optional[torch.Tensor]
) -> torch.Tensor:
    """Unbatched streaming order (delimiter first); [F, C] -> [F+1, C+2]."""
    tgt = None if target_heatmap is None else target_heatmap[None]
    return serialize_streaming_batch(features[None], tgt, delimiter_first=True)[0]


def gather_delimiter_outputs(logits: torch.Tensor, num_features: int) -> torch.Tensor:
    """Predictions at each frame's delimiter step, frames 1..L-1
    (direct_offset_output.py:581-593): [B, L*(F+1), out] -> [B, L-1, out]."""
    B, T, out = logits.shape
    F1 = num_features + 1
    L = T // F1
    rest = logits[:, F1:, :].reshape(B, L - 1, F1, out)
    return rest[:, :, num_features, :]


def offsets_loss(logits: torch.Tensor, offsets: torch.Tensor, num_features: int) -> torch.Tensor:
    """0.5 * sum((tanh(delimiter_logits) - offsets[:, 1:])^2)
    (direct_offset_output.py:593-606); offsets [B, L, out]."""
    pred = torch.tanh(gather_delimiter_outputs(logits, num_features))
    diff = pred - offsets[:, 1:, :]
    return 0.5 * torch.sum(diff * diff)


def heatmap_loss(logits: torch.Tensor, gts: torch.Tensor, num_features: int) -> torch.Tensor:
    """Softmax cross-entropy against the gt heatmaps at the delimiter
    steps, over (L-1) (main.py:1919-1923): logits [B, L*(F+1), F], gts
    [B, L, F] (frames 1..L-1 are the targets)."""
    out = gather_delimiter_outputs(logits, num_features)
    ce = -torch.sum(gts[:, 1:, :] * torch.log_softmax(out, dim=-1), dim=-1)
    return torch.sum(ce) / out.shape[1]
