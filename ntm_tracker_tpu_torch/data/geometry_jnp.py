"""Batched tensor twins of the host geometry in data/geometry.py, for the
crop and decode math that runs on the device (the device-resident
tracking step, tracking/tracker.make_device_track_step).

The counterpart of ntm_tracker_tpu/data/geometry_jnp.py, kept at the same
relative path (and name) so the two packages line up; here the functions
take and return torch tensors. Boxes are [..., 4] (y1, x1, y2, x2).
"""

from __future__ import annotations

import torch


def cropbox_of(bbox: torch.Tensor, cropbox_grid: int, bbox_grid: int) -> torch.Tensor:
    """[B,4] bbox -> the enlarged cropbox (calculate_cropbox: ratio
    cropbox_grid / bbox_grid about the center)."""
    ratio = cropbox_grid / float(bbox_grid)
    y1, x1, y2, x2 = bbox.unbind(-1)
    yc, xc = (y1 + y2) / 2.0, (x1 + x2) / 2.0
    hh, hw = ratio * (y2 - y1) / 2.0, ratio * (x2 - x1) / 2.0
    return torch.stack([yc - hh, xc - hw, yc + hh, xc + hw], dim=-1)


def to_crop_space(bbox: torch.Tensor, cropbox: torch.Tensor) -> torch.Tensor:
    """Image-space [B,4] box -> cropbox-relative coordinates (the affine of
    calculate_transformation / apply_transformation)."""
    cy1, cx1, cy2, cx2 = cropbox.unbind(-1)
    h, w = cy2 - cy1, cx2 - cx1
    y1, x1, y2, x2 = bbox.unbind(-1)
    return torch.stack([(y1 - cy1) / h, (x1 - cx1) / w, (y2 - cy1) / h, (x2 - cx1) / w], dim=-1)


def to_image_space(bbox: torch.Tensor, cropbox: torch.Tensor) -> torch.Tensor:
    """Inverse of to_crop_space."""
    cy1, cx1, cy2, cx2 = cropbox.unbind(-1)
    h, w = cy2 - cy1, cx2 - cx1
    y1, x1, y2, x2 = bbox.unbind(-1)
    return torch.stack([cy1 + y1 * h, cx1 + x1 * w, cy1 + y2 * h, cx1 + x2 * w], dim=-1)


def canonical_box(cropbox_grid: int, bbox_grid: int, device=None) -> torch.Tensor:
    """The centered init box every offset is relative to, float32 [4]."""
    half = bbox_grid / float(cropbox_grid) / 2.0
    return torch.tensor([0.5 - half, 0.5 - half, 0.5 + half, 0.5 + half], dtype=torch.float32,
                        device=device)


def center_offsets(bbox_crop: torch.Tensor, canon: torch.Tensor) -> torch.Tensor:
    """[B,4] crop-space box -> [B,2] (dy, dx) center delta from the
    canonical box (calculate_offsets)."""
    y = (bbox_crop[:, 0] + bbox_crop[:, 2]) / 2.0 - (canon[0] + canon[2]) / 2.0
    x = (bbox_crop[:, 1] + bbox_crop[:, 3]) / 2.0 - (canon[1] + canon[3]) / 2.0
    return torch.stack([y, x], dim=-1)


def center_log_scale(bbox_crop: torch.Tensor, canon: torch.Tensor) -> torch.Tensor:
    """[B,4] crop-space box -> [B] isotropic log-scale against the
    canonical box (calculate_scale, the scale head's target)."""
    area = (bbox_crop[:, 2] - bbox_crop[:, 0]) * (bbox_crop[:, 3] - bbox_crop[:, 1])
    canon_area = (canon[2] - canon[0]) * (canon[3] - canon[1])
    return 0.5 * torch.log(area / canon_area)


def scale_box(bbox: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """Scale [...,4] boxes about their own centers by per-box factors [...]
    (scale_bbox, the scale head's decode)."""
    y1, x1, y2, x2 = bbox.unbind(-1)
    yc, xc = (y1 + y2) / 2.0, (x1 + x2) / 2.0
    hh, hw = factor * (y2 - y1) / 2.0, factor * (x2 - x1) / 2.0
    return torch.stack([yc - hh, xc - hw, yc + hh, xc + hw], dim=-1)
