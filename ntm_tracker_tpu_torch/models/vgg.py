"""Frozen VGG-16 feature extractor, conv1_1 .. conv4_3
(counterpart of ntm_tracker_tpu/models/vgg.py).

Public layout as in the JAX package: images [B,H,W,3] (mean-subtracted
RGB) in, features [B,h,w,C] or tokens [B,64,512] out. Inside, NCHW, and
the convolutions are torch.nn.functional.conv2d (cuDNN on the card).
Parameters are {layer name: {"weights": [out,in,3,3] (OIHW), "biases":
[out]}}; interop.py converts the JAX package's HWIO weights.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# (name, out_channels, followed_by_pool)
VGG16_PREFIX: List[Tuple[str, int, bool]] = [
    ("conv1/conv1_1", 64, False),
    ("conv1/conv1_2", 64, True),
    ("conv2/conv2_1", 128, False),
    ("conv2/conv2_2", 128, True),
    ("conv3/conv3_1", 256, False),
    ("conv3/conv3_2", 256, False),
    ("conv3/conv3_3", 256, True),
    ("conv4/conv4_1", 512, False),
    ("conv4/conv4_2", 512, False),
    ("conv4/conv4_3", 512, True),
    ("conv5/conv5_1", 512, False),
    ("conv5/conv5_2", 512, False),
    ("conv5/conv5_3", 512, True),
]


def _net_def_through_conv43() -> List[Tuple[int, int, int, str]]:
    """(kernel, stride, pad, name) for the conv1_1..conv4_3 prefix, derived
    from VGG16_PREFIX: the geometry table receptive_field() and
    project_receptive_field() walk (receptive_field_sizes.py's net
    definition through conv4_3, which has no pool4)."""
    out: List[Tuple[int, int, int, str]] = []
    for name, _ch, pooled in VGG16_PREFIX[:10]:  # conv1_1 .. conv4_3
        short = name.split("/")[-1]
        out.append((3, 1, 1, short))  # every VGG conv is 3x3/s1/p1
        if pooled and short != "conv4_3":
            out.append((2, 2, 0, "pool" + short[4]))
    return out


NET_DEF: List[Tuple[int, int, int, str]] = _net_def_through_conv43()

# VGG preprocessing mean, RGB (direct_offset_output.py:58-59)
VGG_MEAN = np.array([123.68, 116.78, 103.94], dtype=np.float32)

# The 8x8 stride-2 grid on the 28x28 conv4_3 map used as NTM tokens
# (receptive_field_sizes.py:135-143), row-major.
CONV43_POINTS: List[Tuple[int, int]] = [
    (y, x) for y in range(6, 21, 2) for x in range(6, 21, 2)
]

Params = Dict[str, Dict[str, torch.Tensor]]


def init_vgg_params(generator: Optional[torch.Generator] = None, device=None) -> Params:
    """He-normal random init, zero biases (for tests and smoke runs)."""
    params: Params = {}
    in_ch = 3
    for name, out_ch, _ in VGG16_PREFIX:
        w = torch.randn(out_ch, in_ch, 3, 3, generator=generator) * (2.0 / (9 * in_ch)) ** 0.5
        params[name] = {"weights": w.to(device), "biases": torch.zeros(out_ch, device=device)}
        in_ch = out_ch
    return params


def load_params_npz(path: str, device=None) -> Params:
    """VGG params from a .npz with slim checkpoint names
    (`vgg_16/<block>/<layer>/weights` [3,3,in,out] HWIO, `/biases` [out]),
    the JAX package's convert-vgg output; the weights come out OIHW. conv5
    may be missing (it serves only the pool5 endpoint)."""
    data = np.load(path)
    params: Params = {}
    for name, out_ch, _ in VGG16_PREFIX:
        key = f"vgg_16/{name}/weights"
        if key not in data:
            if name.startswith("conv5"):
                continue
            raise KeyError(key)
        w = np.asarray(data[key], np.float32)
        if w.ndim != 4 or w.shape[-1] != out_ch:
            raise ValueError(f"{key} has shape {w.shape}, expected [3, 3, in, {out_ch}]")
        params[name] = {
            "weights": torch.tensor(np.ascontiguousarray(w.transpose(3, 2, 0, 1)), device=device),
            "biases": torch.tensor(np.asarray(data[f"vgg_16/{name}/biases"], np.float32), device=device),
        }
    return params


# torchvision vgg16's `features` index of each VGG16_PREFIX conv
_TORCHVISION_FEATURES = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]


def load_params_torch(state_dict, device=None) -> Params:
    """VGG params from a torchvision vgg16 state dict (`features.<i>.weight`
    [out,in,3,3] OIHW, `features.<i>.bias`), the layout the port keeps. conv5
    may be missing (it serves only the pool5 endpoint)."""
    params: Params = {}
    for (name, out_ch, _), i in zip(VGG16_PREFIX, _TORCHVISION_FEATURES):
        key = f"features.{i}.weight"
        if key not in state_dict:
            if name.startswith("conv5"):
                continue
            raise KeyError(key)
        w = torch.as_tensor(state_dict[key], dtype=torch.float32)
        if w.ndim != 4 or w.shape[0] != out_ch:
            raise ValueError(f"{key} has shape {tuple(w.shape)}, expected [{out_ch}, in, 3, 3]")
        params[name] = {
            "weights": w.contiguous().to(device),
            "biases": torch.as_tensor(state_dict[f"features.{i}.bias"], dtype=torch.float32).to(device),
        }
    return params


def _conv_relu(x, w, b, compute_dtype=None, padding: int = 1):
    """3x3 conv + bias + ReLU on NCHW. With a compute_dtype the operands
    are cast to it and the bias is added in float32."""
    if compute_dtype is None or compute_dtype == torch.float32:
        return F.relu(F.conv2d(x, w, b, padding=padding))
    y = F.conv2d(x.to(compute_dtype), w.to(compute_dtype), padding=padding)
    return F.relu(y.float() + b[:, None, None])


def vgg16_features(
    params: Params,
    images: torch.Tensor,
    endpoint: str = "conv4/conv4_3",
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The VGG prefix with SAME convs on images [B,H,W,3]; returns the ReLU
    activation at `endpoint` as [B,h,w,C] ([B,28,28,512] for conv4_3 at
    224). endpoint="pool5" gives the pooled conv5_3 map."""
    want_pool5 = endpoint == "pool5"
    stop_at = "conv5/conv5_3" if want_pool5 else endpoint
    valid = {name for name, _, _ in VGG16_PREFIX} | {"pool5"}
    if endpoint not in valid:
        raise ValueError(f"unknown endpoint {endpoint!r}; use one of {sorted(valid)}")
    x = images.permute(0, 3, 1, 2)
    for name, _, has_pool in VGG16_PREFIX:
        if name not in params:
            raise KeyError(f"VGG params missing {name!r} (needed for endpoint {endpoint!r})")
        p = params[name]
        x = _conv_relu(x, p["weights"], p["biases"], compute_dtype)
        if name == stop_at:
            if want_pool5:
                x = F.max_pool2d(x, 2, 2)
            break
        if has_pool:
            x = F.max_pool2d(x, 2, 2)
    return x.float().permute(0, 2, 3, 1)


def vgg16_conv43_tokens(
    params: Params,
    images: torch.Tensor,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The 64 CONV43_POINTS tokens of 224x224 images [B,224,224,3] as
    [B,64,512], computed with VALID convs on the 204x204 slice
    [6:210, 6:210]: the grid's receptive field stays interior through
    every conv and pool, so SAME padding never takes part and the tokens
    equal extract_features(vgg16_features(images)) (models/vgg.py of the
    JAX package derives the ranges)."""
    if images.shape[1] != 224 or images.shape[2] != 224:
        raise ValueError(f"fast conv4_3 token path expects 224x224 crops, got {tuple(images.shape)}")
    x = images[:, 6:210, 6:210, :].permute(0, 3, 1, 2)
    for name, _, has_pool in VGG16_PREFIX:
        p = params[name]
        x = _conv_relu(x, p["weights"], p["biases"], compute_dtype, padding=0)
        if name == "conv4/conv4_3":
            break
        if has_pool:
            x = F.max_pool2d(x, 2, 2)
    # 15x15 == conv4_3 rows 6..20; stride 2 = the 8x8 grid
    x = x[:, :, ::2, ::2].float()
    B, C = x.shape[0], x.shape[1]
    return x.reshape(B, C, -1).transpose(1, 2)


def extract_features(
    feature_map: torch.Tensor,
    points: Sequence[Tuple[int, int]] = tuple(CONV43_POINTS),
) -> torch.Tensor:
    """Gather grid points of a [B,h,w,C] map into tokens [B,len(points),C]."""
    pts = list(points)
    H, W = feature_map.shape[1], feature_map.shape[2]
    if max(p[0] for p in pts) >= H or max(p[1] for p in pts) >= W:
        raise ValueError(f"feature grid points out of bounds for a {H}x{W} feature map")
    ys = torch.tensor([p[0] for p in pts], device=feature_map.device)
    xs = torch.tensor([p[1] for p in pts], device=feature_map.device)
    return feature_map[:, ys, xs, :]


def project_receptive_field(y: int, x: int, layer: str = "conv4_3", input_size: int = 224, clamp: bool = True):
    """Input-space receptive-field box of feature pixel (y, x) at `layer`
    (projectRF, receptive_field_sizes.py:38-102): walk the layers backward,
    expanding [lo, hi] by each kernel/stride/pad. Returns ((ymin, xmin),
    (ymax, xmax)) inclusive pixel coords, clamped to the image like the
    reference's `rectify` (:132-133)."""
    idx = next(i for i, (_, _, _, n) in enumerate(NET_DEF) if n == layer)
    y0 = y1 = y
    x0 = x1 = x
    for k, s, p, _name in reversed(NET_DEF[: idx + 1]):
        y0 = y0 * s - p
        x0 = x0 * s - p
        y1 = y1 * s - p + (k - 1)
        x1 = x1 * s - p + (k - 1)
    if clamp:
        y0, x0 = max(y0, 0), max(x0, 0)
        y1, x1 = min(y1, input_size - 1), min(x1, input_size - 1)
    return ((y0, x0), (y1, x1))


def receptive_field(net_def=None, input_size: int = 224):
    """Receptive field, absolute stride and blob size per layer
    (receptive_field_sizes.py:20-30): [(rf, stride, size, name)], from the
    data layer on."""
    if net_def is None:
        net_def = NET_DEF
    r, s = 1, 1
    rows = [(1, 1, input_size, "data")]
    size = input_size
    for k, rs, p, name in net_def:
        r = r + (k - 1) * s
        s = s * rs
        size = (size - k + 2 * p) // rs + 1
        rows.append((r, s, size, name))
    return rows
