"""Opt-in int8 VGG token path (counterpart of
ntm_tracker_tpu/models/vgg_int8.py): the int8 twin of
vgg.vgg16_conv43_tokens, for quantization-numerics experiments and the
serving commands' --vgg_int8.

It mirrors the exact receptive-field-sliced path (the 204x204 slice, VALID
convs, the 8x8 stride-2 grid on conv4_3) with

  * per-output-channel symmetric int8 weights (scale = max|W[o]| / 127),
  * per-sample dynamic symmetric int8 activations (scale = max|x| / 127
    over each batch element: a sample's tokens never depend on its
    batchmates, so the fleet and validate get the B=1 tracker's values),
  * exact int32 accumulation, dequantized to float32 in the JAX package's
    order (y * (sx * sw)), then bias, ReLU and pool.

The convolutions are not a Pallas kernel in the JAX package (XLA lowers
its s8 x s8 -> s32 conv), so they run on a library call here: an im2col of
the int8 activations (9 shifted slices, NHWC) and torch._int_mm (cuBLASLt
s8 x s8 -> s32 on the card), on every device; K = 9 C_in is padded to a
multiple of 8 (conv1_1 has K = 27). The int32 sums are exact, so the
tokens agree across devices up to the float32 dequantization. A float32
conv would not be exact here: the sums reach ~7.4e7, past 2^24.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ntm_tracker_tpu_torch.models.vgg import VGG16_PREFIX


def _over_127(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-12) / 127, an IEEE division as in the JAX package: a
    Python scalar divisor would make PyTorch's CUDA kernel multiply by its
    reciprocal, one ulp off at times, and a scale one ulp off moves
    roundings in every later layer (2% of the tokens' range on the card)."""
    return torch.clamp(amax, min=1e-12) / amax.new_full((), 127.0)


def quantize_weights(w: torch.Tensor):
    """Per-output-channel symmetric int8 of OIHW weights: (w_q int8
    [O,I,3,3], scale float32 [O])."""
    scale = _over_127(w.abs().amax(dim=(1, 2, 3)))
    w_q = torch.clamp(torch.round(w / scale[:, None, None, None]), -127, 127).to(torch.int8)
    return w_q, scale


def quantize_activations(x: torch.Tensor):
    """Per-sample dynamic symmetric int8 of x [B,H,W,C]: (x_q int8, scale
    float32 [B])."""
    scale = _over_127(x.abs().amax(dim=(1, 2, 3)))
    x_q = torch.clamp(torch.round(x / scale[:, None, None, None]), -127, 127).to(torch.int8)
    return x_q, scale


def conv_int32(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """VALID 3x3 conv of int8 x_q [B,H,W,C] with int8 OIHW w_q, summed
    exactly: int32 [B,H-2,W-2,O]."""
    B, H, W, C = x_q.shape
    O = w_q.shape[0]
    Ho, Wo = H - 2, W - 2
    K = 9 * C
    pad = -K % 8
    # im2col in (dy, dx, c) order; the zero columns pad K for cuBLASLt
    cols = [x_q[:, dy:dy + Ho, dx:dx + Wo, :] for dy in range(3) for dx in range(3)]
    if pad:
        cols.append(x_q.new_zeros(B, Ho, Wo, pad))
    a = torch.cat(cols, dim=3).reshape(B * Ho * Wo, K + pad)
    wt = w_q.permute(0, 2, 3, 1).reshape(O, K)
    if pad:
        wt = torch.cat([wt, wt.new_zeros(O, pad)], dim=1)
    return torch._int_mm(a, wt.t()).reshape(B, Ho, Wo, O)


def _conv_relu_int8(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """VALID 3x3 conv with both operands quantized to int8 on the fly, int32
    sums, dequantized to float32, + bias, ReLU. x [B,H,W,C] float32."""
    x_q, sx = quantize_activations(x)
    w_q, sw = quantize_weights(w)
    y = conv_int32(x_q, w_q)
    y = y.float() * (sx[:, None, None, None] * sw)
    return F.relu(y + b)


def vgg16_conv43_tokens_int8(params: Dict[str, Dict[str, torch.Tensor]], images: torch.Tensor) -> torch.Tensor:
    """Int8 twin of vgg.vgg16_conv43_tokens: images [B,224,224,3]
    (mean-subtracted) -> tokens [B,64,512], from the ordinary float32 OIHW
    params. Not the exact path's numbers: per-token cosine ~0.99 or better
    against it."""
    if images.shape[1] != 224 or images.shape[2] != 224:
        raise ValueError(f"int8 conv4_3 token path expects 224x224 crops, got {tuple(images.shape)}")
    x = images[:, 6:210, 6:210, :].float()
    for name, _, has_pool in VGG16_PREFIX:
        p = params[name]
        x = _conv_relu_int8(x, p["weights"], p["biases"])
        if name == "conv4/conv4_3":
            break
        if has_pool:
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    assert x.shape[1] == x.shape[2] == 15, x.shape
    x = x[:, ::2, ::2, :]
    B, h, w, C = x.shape
    return x.reshape(B, h * w, C)
