"""tf.image.crop_and_resize and TF-1 resize_images with TF's bilinear
sampling, the same crop as two batched matrix products, and the
reference's frame pipeline (counterpart of
ntm_tracker_tpu/data/image_ops.py:30-190).

For output size S and normalized box [y1,x1,y2,x2] the sample rows are
    in_y = y1*(H-1) + i * (y2-y1)*(H-1)/(S-1)
(corner-aligned inside the box); samples outside the image get the
extrapolation value. This is neither roi_align nor F.interpolate, which
sample at other points. TF-1 resize_images (bilinear, align_corners=False)
samples in_y = i * (H_in / H_out), not at half-pixel centres.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ntm_tracker_tpu_torch.config import float32_matmul_precision
from ntm_tracker_tpu_torch.models.vgg import VGG_MEAN


def tf1_resize_bilinear(image: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """TF-1.x resize_images(..., BILINEAR, align_corners=False) of
    [H, W, C] or [B, H, W, C] images, clamped at the bottom/right edge;
    returns float32."""
    H, W = image.shape[-3], image.shape[-2]
    out_h, out_w = out_hw
    dev = image.device
    ys = torch.arange(out_h, dtype=torch.float32, device=dev) * (H / out_h)
    xs = torch.arange(out_w, dtype=torch.float32, device=dev) * (W / out_w)
    y0 = torch.floor(ys).long().clamp(0, H - 1)
    y1 = (y0 + 1).clamp(0, H - 1)
    fy = (ys - torch.floor(ys))[:, None, None]
    x0 = torch.floor(xs).long().clamp(0, W - 1)
    x1 = (x0 + 1).clamp(0, W - 1)
    fx = (xs - torch.floor(xs))[None, :, None]
    img = image.float()
    rows0, rows1 = img[..., y0, :, :], img[..., y1, :, :]
    top = rows0[..., x0, :] * (1 - fx) + rows0[..., x1, :] * fx
    bot = rows1[..., x0, :] * (1 - fx) + rows1[..., x1, :] * fx
    return top * (1 - fy) + bot * fy


def _sample_coords(lo: torch.Tensor, hi: torch.Tensor, out_n: int, size: int) -> torch.Tensor:
    """[B] box edges -> [B, out_n] source coordinates along one axis."""
    if out_n > 1:
        step = (hi - lo) * (size - 1) / (out_n - 1)
        ar = torch.arange(out_n, dtype=torch.float32, device=lo.device)
        return lo[:, None] * (size - 1) + ar[None, :] * step[:, None]
    return (0.5 * (lo + hi) * (size - 1))[:, None]


def crop_and_resize(
    images: torch.Tensor,
    boxes: torch.Tensor,
    crop_size: Tuple[int, int],
    extrapolation_value: float = 0.0,
) -> torch.Tensor:
    """One box per image: images [B,H,W,C], boxes [B,4] normalized
    [y1,x1,y2,x2] (may leave [0,1]) -> [B, out_h, out_w, C] float32."""
    B, H, W, C = images.shape
    out_h, out_w = crop_size
    boxes = boxes.float()
    in_y = _sample_coords(boxes[:, 0], boxes[:, 2], out_h, H)  # [B, oh]
    in_x = _sample_coords(boxes[:, 1], boxes[:, 3], out_w, W)  # [B, ow]
    valid_y = (in_y >= 0) & (in_y <= H - 1)
    valid_x = (in_x >= 0) & (in_x <= W - 1)

    fl_y, fl_x = torch.floor(in_y), torch.floor(in_x)
    y0 = fl_y.long().clamp(0, H - 1)
    yh = (y0 + 1).clamp(0, H - 1)
    x0 = fl_x.long().clamp(0, W - 1)
    xh = (x0 + 1).clamp(0, W - 1)
    fy = (in_y - fl_y)[:, :, None, None]
    fx = (in_x - fl_x)[:, None, :, None]

    img = images.float()
    bi = torch.arange(B, device=images.device)[:, None, None]

    def at(yi, xi):
        return img[bi, yi[:, :, None], xi[:, None, :]]  # [B, oh, ow, C]

    top = at(y0, x0) * (1 - fx) + at(y0, xh) * fx
    bot = at(yh, x0) * (1 - fx) + at(yh, xh) * fx
    out = top * (1 - fy) + bot * fy
    mask = (valid_y[:, :, None] & valid_x[:, None, :])[..., None]
    return torch.where(mask, out, torch.full_like(out, extrapolation_value))


def _interp_matrix(lo: torch.Tensor, hi: torch.Tensor, out_n: int, size: int):
    """[B, out_n, size] bilinear weights along one axis at the gather
    path's sample coordinates, zero for samples outside the image, and the
    [B, out_n] validity of each sample."""
    coords = _sample_coords(lo, hi, out_n, size)
    grid = torch.arange(size, dtype=torch.float32, device=lo.device)
    w = torch.clamp_min(1.0 - (coords[..., None] - grid).abs(), 0.0)
    valid = (coords >= 0) & (coords <= size - 1)
    return w * valid[..., None], valid


def crop_and_resize_mm(
    images: torch.Tensor,
    boxes: torch.Tensor,
    crop_size: Tuple[int, int],
    extrapolation_value: float = 0.0,
) -> torch.Tensor:
    """`crop_and_resize` as two batched matrix products (the device-loop
    and fleet crop; ntm_tracker_tpu/data/image_ops.py:110-169).

    An axis-aligned bilinear crop is separable: out = Wy @ img @ Wx^T, with
    Wy [out_h, H] and Wx [out_w, W] holding each output row's and column's
    two bilinear weights (max(0, 1 - |in - grid|) is the gather path's
    (1-f, f) pair in exact arithmetic) at the gather path's exact sample
    coordinates. The products read the frame once, where the gather form
    reads it with four dependent gathers per output pixel. They run at
    float32 matmul precision "highest" (no TF32), which keeps the crop
    within float32 rounding of the gather form: a lower-precision crop
    breached the tracker's drift tripwire in the JAX package.

    images [B,H,W,C], boxes [B,4] normalized [y1,x1,y2,x2] ->
    [B, out_h, out_w, C] float32."""
    B, H, W, C = images.shape
    out_h, out_w = crop_size
    boxes = boxes.float()
    Wy, vy = _interp_matrix(boxes[:, 0], boxes[:, 2], out_h, H)  # [B, out_h, H]
    Wx, vx = _interp_matrix(boxes[:, 1], boxes[:, 3], out_w, W)  # [B, out_w, W]
    img = images.float()
    with float32_matmul_precision("highest"):
        tmp = torch.einsum("biy,byxc->bixc", Wy, img)
        out = torch.einsum("bjx,bixc->bijc", Wx, tmp)
    mask = (vy[:, :, None] & vx[:, None, :])[..., None]
    if extrapolation_value == 0.0:
        return out * mask
    return torch.where(mask, out, torch.full_like(out, extrapolation_value))


def preprocess_frame(
    image: torch.Tensor,
    cropbox: torch.Tensor,
    resize_hw: Tuple[int, int] = (720, 1280),
    crop_size: int = 224,
    do_resize: bool = True,
) -> torch.Tensor:
    """The reference's frame pipeline (direct_offset_output.py:194-201):
    resize to 720x1280, subtract the VGG mean, crop_and_resize to 224.
    image [H, W, 3] (uint8 or float) with cropbox [4], or a batch
    [B, H, W, 3] with [B, 4]; returns float32 mean-subtracted crops."""
    if image.dim() == 3:
        return preprocess_frame(image[None], cropbox[None], resize_hw, crop_size, do_resize)[0]
    img = image.float()
    if do_resize:
        img = tf1_resize_bilinear(img, resize_hw)
    img = img - torch.as_tensor(VGG_MEAN, device=img.device)
    return crop_and_resize(img, cropbox, (crop_size, crop_size))
