"""Visualizers (counterpart of ntm_tracker_tpu/utils/viz.py):

  save_imgs           <- direct_offset_output.py:61-92 (a grid of per-step
                         inputs / gt offsets / predictions)
  memory_panels       <- main.py:1186-1214 (the memory-over-time images)
  save_memory_panels     the four panels of one batch element as a PNG
  label_vot_sequence  <- vot_visualizer.py:8-69 (gt polygons drawn on a VOT
                         sequence directory)

The JAX package draws with matplotlib; the card's machine has PIL and no
matplotlib, so the same grid (rows = the arrays x the batch, columns = the
steps) and the same panels are drawn here with PIL and numpy.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

# the grid's cell for an offset plot when no image sets the size, and the
# memory panels' width, in pixels
OFFSET_CELL = 96
PANEL_WIDTH = 1024
# viridis at five stops (matplotlib's), interpolated linearly
_VIRIDIS = np.array([[68, 1, 84], [59, 82, 139], [33, 145, 140], [94, 201, 98], [253, 231, 37]], np.float64)


def _viridis(x: np.ndarray) -> np.ndarray:
    """[H, W] -> [H, W, 3] uint8, x min-max scaled to [0, 1] first."""
    x = np.asarray(x, np.float64)
    span = x.max() - x.min()
    x = (x - x.min()) / span if span > 0 else np.zeros_like(x)
    pos = x * (len(_VIRIDIS) - 1)
    lo = np.clip(np.floor(pos).astype(int), 0, len(_VIRIDIS) - 2)
    frac = (pos - lo)[..., None]
    return (_VIRIDIS[lo] * (1 - frac) + _VIRIDIS[lo + 1] * frac).round().astype(np.uint8)


def _image_cell(img: np.ndarray, cell: int):
    from PIL import Image

    img = np.squeeze(img)
    if img.dtype != np.uint8:
        img = img.astype(np.uint8)
    return Image.fromarray(img).convert("RGB").resize((cell, cell), Image.NEAREST)


def _offset_cell(dyx, cell: int):
    """The offset (dy, dx) as a red dot in the unit box [-0.5, 0.5]^2,
    plotted at (dx, -dy) as the reference's plot does."""
    from PIL import Image, ImageDraw

    im = Image.new("RGB", (cell, cell), "white")
    draw = ImageDraw.Draw(im)
    draw.rectangle([0, 0, cell - 1, cell - 1], outline=(160, 160, 160))
    x, y = (float(dyx[1]) + 0.5) * cell, (float(dyx[0]) + 0.5) * cell
    draw.ellipse([x - 3, y - 3, x + 3, y + 3], fill=(255, 0, 0))
    return im


def save_imgs(imgs: Sequence[np.ndarray], filename: str, savedir: str) -> str:
    """Write a PNG grid: rows = batch x image sets, columns = sequence steps.

    Each element of `imgs` is [batch, length, H, W, C] (drawn as an image)
    or [batch, length, 2] (an offset, drawn as a point in the unit box, y
    flipped: the reference plots (dx, -dy))."""
    from PIL import Image

    batch, length = imgs[0].shape[0], imgs[0].shape[1]
    sides = [max(img.shape[2], img.shape[3]) for img in imgs if img.ndim > 3]
    cell = max(sides) if sides else OFFSET_CELL
    grid = Image.new("RGB", (length * cell, len(imgs) * batch * cell), "white")
    for b in range(batch):
        for set_idx, img in enumerate(imgs):
            row = b * len(imgs) + set_idx
            for t in range(length):
                tile = _image_cell(img[b, t], cell) if img.ndim > 3 else _offset_cell(img[b, t], cell)
                grid.paste(tile, (t * cell, row * cell))
    os.makedirs(savedir, exist_ok=True)
    path = os.path.join(savedir, filename + ".png")
    grid.save(path)
    return path


def memory_panels(M: np.ndarray, w: np.ndarray, read: np.ndarray, read_heads: int) -> dict:
    """The reference's memory-over-time summary images (main.py:1186-1214)
    of ONE batch element.

    Args:
      M:    [T, N, D] memory snapshots
      w:    [T, H, N] head weights (read heads first)
      read: [T, R, D] read vectors
    Returns a dict of 2D arrays:
      'M'        [N, T*D]      the memory timeline (main.py:1188-1190)
      'w_reads'  [R*N, T]      the read weights' trajectories (:1196-1197)
      'w_writes' [(H-R)*N, T]  the write weights' trajectories (:1198-1199)
      'reads'    [R*D, T]      the read vectors' timeline (:1209-1210)
    """
    T, N, D = M.shape
    H, R = w.shape[1], read_heads
    return {
        "M": np.transpose(M, (1, 0, 2)).reshape(N, T * D),
        "w_reads": np.transpose(w[:, :R, :], (1, 2, 0)).reshape(R * N, T),
        "w_writes": np.transpose(w[:, R:, :], (1, 2, 0)).reshape((H - R) * N, T),
        "reads": np.transpose(read, (1, 2, 0)).reshape(R * D, T),
    }


def save_memory_panels(views: dict, read_heads: int, filename: str, savedir: str, batch_index: int = 0) -> str:
    """Write a PNG of the four memory dashboards of one batch element: each
    panel titled, its values in viridis, scaled to PANEL_WIDTH wide
    (nearest neighbour), stacked top to bottom.

    views: {"M": [B,T,N,D], "w": [B,T,H,N], "read": [B,T,R,D]}, as
    models.core.unroll_states returns them (tensors or arrays)."""
    from PIL import Image, ImageDraw

    def host(x):
        return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)

    b = batch_index
    panels = memory_panels(host(views["M"][b]), host(views["w"][b]), host(views["read"][b]), read_heads)
    title_h = 14
    tiles = []
    for name, img in panels.items():
        rows = max(img.shape[0], 1)
        height = int(np.clip(rows * 2, 64, 320))
        tile = Image.new("RGB", (PANEL_WIDTH, title_h + height), "white")
        ImageDraw.Draw(tile).text((4, 1), name, fill=(0, 0, 0))
        if img.size:
            tile.paste(Image.fromarray(_viridis(img)).resize((PANEL_WIDTH, height), Image.NEAREST), (0, title_h))
        tiles.append(tile)
    sheet = Image.new("RGB", (PANEL_WIDTH, sum(t.height for t in tiles)), "white")
    y = 0
    for tile in tiles:
        sheet.paste(tile, (0, y))
        y += tile.height
    os.makedirs(savedir, exist_ok=True)
    path = os.path.join(savedir, filename + ".png")
    sheet.save(path)
    return path


def label_vot_sequence(data_path: str) -> str:
    """Draw groundtruth.txt's polygons onto every frame of a VOT sequence
    directory; writes to <data_path>/labeled/ (vot_visualizer.py)."""
    from PIL import Image, ImageDraw

    images = sorted(x for x in os.listdir(data_path) if x.endswith(".jpg"))
    if not images:
        raise ValueError("the given dir does not contain any images")
    gt_frames = []
    with open(os.path.join(data_path, "groundtruth.txt")) as f:
        for line in f:
            coords = [float(v) for v in line.strip().split(",")]
            gt_frames.append([(coords[2 * i], coords[2 * i + 1]) for i in range(len(coords) // 2)])
    if len(gt_frames) != len(images):
        raise ValueError(f"groundtruth.txt has {len(gt_frames)} lines for {len(images)} frames")
    output_dir = os.path.join(data_path, "labeled")
    os.makedirs(output_dir, exist_ok=True)
    for img_name, bbox in zip(images, gt_frames):
        img = Image.open(os.path.join(data_path, img_name))
        ImageDraw.Draw(img).polygon(bbox)
        img.save(os.path.join(output_dir, img_name))
    return output_dir
