"""Experiment pieces (counterpart of ntm_tracker_tpu/train/experiments.py).
This slice holds only `frame_tokens`, which the tracker shares with
training."""

from __future__ import annotations

import torch

from ntm_tracker_tpu_torch.config import TrackerConfig
from ntm_tracker_tpu_torch.models.vgg import extract_features, vgg16_conv43_tokens, vgg16_features


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
