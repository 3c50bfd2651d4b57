"""A synthetic ILSVRC2015-VID tree made from a seed: annotation XML in
VID's format (`Annotations/VID/<split>/<seq>/<frame>.xml`) and JPEG frames
(`Data/VID/<split>/<seq>/<frame>.JPEG`), for drives of the data path
(`preprocess` -> `cache-features` -> `train-offsets`) without the dataset.

Each object of a sequence (a track, and after preprocess a sequence
directory of its own) is a bright textured box that drifts and breathes
slowly over a smooth noise background, little enough per frame that
preprocess's deform and zoom gates keep every frame.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np

# (seqname, split, (width, height), frames[, objects, default 1])
DEFAULT_SEQUENCES: Tuple[tuple, ...] = (
    ("ILSVRC2015_train_00000000", "train", (1280, 720), 24),
    ("ILSVRC2015_train_00000001", "train", (1280, 720), 24),
    ("ILSVRC2015_val_00000000", "val", (640, 360), 24),
)

_XML = """<annotation>
\t<folder>VID/{split}/{seqname}</folder>
\t<filename>{frame:06d}</filename>
\t<size>
\t\t<width>{w}</width>
\t\t<height>{h}</height>
\t</size>
{objects}</annotation>
"""

_OBJECT = """\t<object>
\t\t<trackid>{trackid}</trackid>
\t\t<name>n00000000</name>
\t\t<bndbox>
\t\t\t<xmax>{xmax}</xmax>
\t\t\t<xmin>{xmin}</xmin>
\t\t\t<ymax>{ymax}</ymax>
\t\t\t<ymin>{ymin}</ymin>
\t\t</bndbox>
\t\t<occluded>0</occluded>
\t\t<generated>0</generated>
\t</object>
"""


def object_boxes(rng: np.random.RandomState, n: int, w: int, h: int) -> np.ndarray:
    """[n, 4] integer pixel boxes (ymin, xmin, ymax, xmax): a slow drift
    with a size change of at most 1% a frame."""
    cy, cx = rng.uniform(0.4, 0.6) * h, rng.uniform(0.4, 0.6) * w
    bh, bw = rng.uniform(0.2, 0.3) * h, rng.uniform(0.15, 0.25) * w
    vy, vx = rng.uniform(-0.001, 0.001, 2) * (h, w)
    out = np.zeros((n, 4), np.int64)
    for t in range(n):
        s = 1.0 + 0.01 * np.sin(t / 4.0)
        out[t] = [round(cy + vy * t - s * bh / 2), round(cx + vx * t - s * bw / 2),
                  round(cy + vy * t + s * bh / 2), round(cx + vx * t + s * bw / 2)]
    return out


def render_frame(rng: np.random.RandomState, w: int, h: int, boxes) -> np.ndarray:
    """[h, w, 3] uint8: smooth noise (an 8x upsampled random field) with a
    bright noisy box for each of `boxes`."""
    small = rng.rand((h + 7) // 8, (w + 7) // 8, 3) * 120 + 40
    img = np.repeat(np.repeat(small, 8, axis=0), 8, axis=1)[:h, :w]
    for y0, x0, y1, x1 in boxes:
        img[y0:y1, x0:x1] = 200 + rng.rand(y1 - y0, x1 - x0, 3) * 55
    return img.astype(np.uint8)


def write_vid_sequence(root: str, seqname: str, split: str, size: Tuple[int, int], tracks: np.ndarray,
                       rng: np.random.RandomState, quality: int = 90) -> None:
    """One sequence of the tree under `root`: tracks [frames, objects, 4]
    integer pixel boxes (ymin, xmin, ymax, xmax), an XML and a JPEG a frame."""
    from PIL import Image

    w, h = size
    adir = os.path.join(root, "Annotations", "VID", split, seqname)
    idir = os.path.join(root, "Data", "VID", split, seqname)
    os.makedirs(adir, exist_ok=True)
    os.makedirs(idir, exist_ok=True)
    for t, boxes in enumerate(np.asarray(tracks).tolist()):
        xml = "".join(_OBJECT.format(trackid=k, ymin=b[0], xmin=b[1], ymax=b[2], xmax=b[3])
                      for k, b in enumerate(boxes))
        with open(os.path.join(adir, f"{t:06d}.xml"), "w") as f:
            f.write(_XML.format(split=split, seqname=seqname, frame=t, w=w, h=h, objects=xml))
        Image.fromarray(render_frame(rng, w, h, boxes)).save(os.path.join(idir, f"{t:06d}.JPEG"), quality=quality)


def write_vid_tree(root: str, seed: int = 0, sequences: Sequence = DEFAULT_SEQUENCES,
                   quality: int = 90) -> Tuple[str, str]:
    """Write the tree under `root`; returns (annotation_dir, image_dir)."""
    rng = np.random.RandomState(seed)
    for seqname, split, (w, h), n, *objects in sequences:
        tracks = np.stack([object_boxes(rng, n, w, h) for _ in range(objects[0] if objects else 1)], axis=1)
        write_vid_sequence(root, seqname, split, (w, h), tracks, rng, quality)
    return os.path.join(root, "Annotations"), os.path.join(root, "Data")
