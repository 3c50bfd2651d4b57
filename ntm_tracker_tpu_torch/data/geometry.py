"""Bounding-box / crop geometry and Gaussian ground-truth heatmaps.

The port's own copy of ntm_tracker_tpu/data/geometry.py (numpy only, so
the two packages share no import).

Exact numpy re-expression of the reference preprocess.py geometry:
  normalize_bbox            <- preprocess.py:73-79   (divides by dim-1!)
  calculate_cropbox         <- preprocess.py:81-103  (ratio cropbox/bbox grid)
  calculate_offsets         <- preprocess.py:105-110 (center delta, (-1,1))
  offset_bbox               <- preprocess.py:116-119
  calculate_transformation  <- preprocess.py:121-134 (affine to unit square)
  apply_transformation      <- preprocess.py:136-149
  bbox_legal                <- preprocess.py:159-188 (deform/zoom gates)
  matlab_style_gauss2D      <- preprocess.py:191-203 (fspecial equivalence)
  discrete_gauss            <- preprocess.py:205-221
  generate_gt               <- preprocess.py:229-240 (sigma = bbox_grid/focus)

All bboxes are [y1, x1, y2, x2]; normalized coordinates unless noted.
Float64 throughout, matching the reference's on-disk float64 heatmaps
(preprocess.py:322).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

Box = Sequence[float]


def normalize_bbox(size: Tuple[int, int], bbox: Sequence[int]) -> list[float]:
    """Pixel bbox -> normalized by (dim - 1). size is (width, height)."""
    width, height = size
    y1, x1, y2, x2 = bbox
    return [
        y1 / float(height - 1),
        x1 / float(width - 1),
        y2 / float(height - 1),
        x2 / float(width - 1),
    ]


def calculate_cropbox(normalbbox: Box, cropbox_grid: int, bbox_grid: int) -> list[float]:
    """Enlarge the bbox about its center by cropbox_grid/bbox_grid (8/6)."""
    y1, x1, y2, x2 = normalbbox
    ratio = cropbox_grid / float(bbox_grid)
    x_center = (x1 + x2) / 2
    cropwidth = ratio * (x2 - x1)
    y_center = (y1 + y2) / 2
    cropheight = ratio * (y2 - y1)
    return [
        y_center - cropheight / 2,
        x_center - cropwidth / 2,
        y_center + cropheight / 2,
        x_center + cropwidth / 2,
    ]


def calculate_offsets(transformed_bbox: Box, init_transformed_bbox: Box) -> Tuple[float, float]:
    """(dy, dx) of the bbox center vs the canonical centered box."""
    y1, x1, y2, x2 = transformed_bbox
    x, y = (x1 + x2) / 2, (y1 + y2) / 2
    y1, x1, y2, x2 = init_transformed_bbox
    x0, y0 = (x1 + x2) / 2, (y1 + y2) / 2
    return (y - y0, x - x0)


def offset_bbox(init_transformed_bbox: Box, offsets: Tuple[float, float]) -> Tuple[float, float, float, float]:
    dy, dx = offsets
    y1, x1, y2, x2 = init_transformed_bbox
    return (y1 + dy, x1 + dx, y2 + dy, x2 + dx)


def calculate_scale(transformed_bbox: Box, init_transformed_bbox: Box) -> float:
    """Isotropic log-scale of the bbox vs the canonical box: 0.5 * log of
    the area ratio (= log of the sqrt-area side ratio).

    BEYOND-REFERENCE: the reference's head is offsets-only
    (direct_offset_output.py output_dim=2), which freezes the tracked box
    size at its first-frame value — the scale-head target this function
    computes is the training counterpart of `scale_bbox` at decode time
    (TrackerConfig.predict_scale)."""
    y1, x1, y2, x2 = transformed_bbox
    iy1, ix1, iy2, ix2 = init_transformed_bbox
    return 0.5 * float(
        np.log(((y2 - y1) * (x2 - x1)) / ((iy2 - iy1) * (ix2 - ix1)))
    )


def scale_bbox(bbox: Box, factor: float) -> Tuple[float, float, float, float]:
    """Scale a bbox about its own center (the scale-head decode;
    inverse of `calculate_scale` for isotropic boxes)."""
    y1, x1, y2, x2 = bbox
    yc, xc = (y1 + y2) / 2, (x1 + x2) / 2
    hh, hw = factor * (y2 - y1) / 2, factor * (x2 - x1) / 2
    return (yc - hh, xc - hw, yc + hh, xc + hw)


def calculate_transformation(cropbox: Box) -> np.ndarray:
    """3x3 affine mapping the cropbox to [0,0,1,1] (x-major homogeneous)."""
    y1, x1, y2, x2 = cropbox
    width = x2 - x1
    height = y2 - y1
    return np.array(
        [
            [1 / width, 0, -x1 / width],
            [0, 1 / height, -y1 / height],
            [0, 0, 1],
        ]
    )


def apply_transformation(normalbbox: Box, transformation: np.ndarray) -> list[float]:
    """Map a normalized bbox through the affine (image space -> crop space)."""
    y1, x1, y2, x2 = normalbbox
    p1 = transformation @ np.array([x1, y1, 1.0])
    p2 = transformation @ np.array([x2, y2, 1.0])
    return [p1[1], p1[0], p2[1], p2[0]]


def initial_transformed_bbox(cropbox_grid: int, bbox_grid: int) -> list[float]:
    """The canonical centered box in crop space (preprocess.py:283-288,
    test_tracker.py:227-239)."""
    half = bbox_grid / float(cropbox_grid) / 2
    return [0.5 - half, 0.5 - half, 0.5 + half, 0.5 + half]


def bbox_legal(
    normalbbox: Box,
    cropbox: Box,
    cropbox_grid: int,
    bbox_grid: int,
    deform_threshold: float,
    zoom_threshold: float,
) -> bool:
    """bbox must stay inside the cropbox with bounded deformation and zoom."""
    within_bound = (
        normalbbox[0] >= cropbox[0]
        and normalbbox[1] >= cropbox[1]
        and normalbbox[2] <= cropbox[2]
        and normalbbox[3] <= cropbox[3]
    )

    y1, x1, y2, x2 = normalbbox
    w, h = x2 - x1, y2 - y1
    y1, x1, y2, x2 = cropbox
    cw, ch = x2 - x1, y2 - y1

    whr, hwr = w / h / (cw / ch), h / w / (ch / cw)
    deformed = hwr > 1 + deform_threshold or whr > 1 + deform_threshold

    ratio = bbox_grid / float(cropbox_grid)
    ub, lb = ratio * (1 + zoom_threshold), ratio * (1 - zoom_threshold)
    zoomed = w / cw > ub or w / cw < lb or h / ch > ub or h / ch < lb

    return within_bound and (not deformed) and (not zoomed)


def matlab_style_gauss2D(shape=(3, 3), sigma: float = 0.5) -> np.ndarray:
    """Same result as MATLAB fspecial('gaussian', shape, sigma)."""
    m, n = [(ss - 1.0) / 2.0 for ss in shape]
    y, x = np.ogrid[-m : m + 1, -n : n + 1]
    h = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    sumh = h.sum()
    if sumh != 0:
        h /= sumh
    return h


def discrete_gauss(center=(0.5, 0.5), shape=(7, 7), sigma: float = 0.75) -> np.ndarray:
    """Discrete Gaussian centered at `center` (normalized) on a `shape` grid."""
    cx, cy = [a * b for a, b in zip(center, shape)]
    w, h = shape
    y, x = np.ogrid[-cy + 0.5 : h - cy + 0.5, -cx + 0.5 : w - cx + 0.5]
    h = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    sumh = h.sum()
    if sumh != 0:
        h /= sumh
    return h


def generate_gt(normalbbox: Box, cropbox_grid: int, bbox_grid: int, focus=3) -> np.ndarray:
    """Gaussian gt heatmap for a transformed bbox; sigma = bbox_grid/focus.

    Reference quirks reproduced here: (a) only the FIRST frame passes
    FLAGS.focus (an INT, default 4); later frames use the default focus=3
    (preprocess.py:291-292 vs :308-309); (b) preprocess.py has no
    `from __future__ import division`, so with int operands the sigma is
    FLOOR-divided under Python 2 (6//4=1 for the first frame, 6//3=2 after).
    Pass a float focus to opt out of the floor."""
    y1, x1, y2, x2 = normalbbox
    cx = (x1 + x2) / 2.0
    cy = (y1 + y2) / 2.0
    if isinstance(bbox_grid, (int, np.integer)) and isinstance(focus, (int, np.integer)):
        sigma = bbox_grid // focus
    else:
        sigma = bbox_grid / focus
    return discrete_gauss((cx, cy), (cropbox_grid, cropbox_grid), sigma)


def bb_iou(boxA: Box, boxB: Box) -> float:
    """IoU of [x1,y1,x2,y2] pixel boxes (test_tracker.py:59-83, including the
    reference's +1 pixel-area convention)."""
    xA = max(boxA[0], boxB[0])
    yA = max(boxA[1], boxB[1])
    xB = min(boxA[2], boxB[2])
    yB = min(boxA[3], boxB[3])
    interArea = (xB - xA + 1) * (yB - yA + 1)
    boxAArea = (boxA[2] - boxA[0] + 1) * (boxA[3] - boxA[1] + 1)
    boxBArea = (boxB[2] - boxB[0] + 1) * (boxB[3] - boxB[1] + 1)
    return interArea / float(boxAArea + boxBArea - interArea)
