"""utils/viz.py on the CPU: the memory panels' arrays against the JAX
package's memory_panels, the PNGs' geometry and content (the JAX package
draws with matplotlib, the port with PIL: the files are held to their
size, cells and marks, not to bytes), and label_vot_sequence's frames
against the JAX package's (both draw with PIL)."""

import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from ntm_tracker_tpu.utils import viz as jviz
from ntm_tracker_tpu_torch.utils import viz as tviz


def test_memory_panels_match_jax():
    T, N, D, H, R = 5, 8, 4, 3, 2
    rs = np.random.RandomState(0)
    M, w, read = rs.rand(T, N, D), rs.rand(T, H, N), rs.rand(T, R, D)
    got, want = tviz.memory_panels(M, w, read, R), jviz.memory_panels(M, w, read, R)
    assert list(got) == list(want) == ["M", "w_reads", "w_writes", "reads"]
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(got["M"][:, 2 * D:3 * D], M[2])


def test_save_memory_panels_png(tmp_path):
    rs = np.random.RandomState(1)
    views = {"M": torch.tensor(rs.rand(2, 6, 8, 4)), "w": torch.tensor(rs.rand(2, 6, 3, 8)),
             "read": torch.tensor(rs.rand(2, 6, 2, 4))}
    path = tviz.save_memory_panels(views, read_heads=2, filename="mem_0", savedir=str(tmp_path / "d"), batch_index=1)
    assert path == str(tmp_path / "d" / "mem_0.png") and os.path.getsize(path) > 0
    img = np.asarray(Image.open(path))
    assert img.shape[1] == tviz.PANEL_WIDTH and img.shape[0] >= 4 * 64
    # viridis pixels, not a blank sheet
    assert len(np.unique(img.reshape(-1, 3), axis=0)) > 16


def test_save_imgs_grid(tmp_path):
    B, L, S = 2, 3, 16
    rs = np.random.RandomState(2)
    crops = (rs.rand(B, L, S, S, 3) * 255).astype(np.uint8)
    heat = (rs.rand(B, L, 4, 4, 1) * 255).astype(np.uint8)
    offsets = np.zeros((B, L, 2), np.float32)
    offsets[1, 2] = (0.25, -0.25)  # dy, dx
    path = tviz.save_imgs([crops, heat, offsets], "grid", str(tmp_path))
    img = np.asarray(Image.open(path).convert("RGB"))
    assert img.shape == (3 * B * S, L * S, 3)
    np.testing.assert_array_equal(img[:S, :S], crops[0, 0])          # row 0, step 0
    # batch 1's offsets row, step 2: the dot at (dx, -dy) in the unit box
    cell = img[5 * S:6 * S, 2 * S:3 * S]
    ys, xs = np.nonzero((cell[..., 0] == 255) & (cell[..., 1] == 0))
    assert abs(ys.mean() - 0.75 * S) <= 1 and abs(xs.mean() - 0.25 * S) <= 1
    # offsets alone: the default cell
    only = np.asarray(Image.open(tviz.save_imgs([offsets], "pts", str(tmp_path))))
    assert only.shape[:2] == (B * tviz.OFFSET_CELL, L * tviz.OFFSET_CELL)


def test_label_vot_sequence_matches_jax(tmp_path):
    rs = np.random.RandomState(3)
    src = tmp_path / "jax"
    src.mkdir()
    for i in range(3):
        Image.fromarray((rs.rand(40, 60, 3) * 255).astype(np.uint8)).save(src / f"{i:08d}.jpg")
    (src / "groundtruth.txt").write_text("\n".join(f"{5 + i},5,30,6,29,20,4,19" for i in range(3)))
    shutil.copytree(src, tmp_path / "port")
    jout = jviz.label_vot_sequence(str(src))
    tout = tviz.label_vot_sequence(str(tmp_path / "port"))
    names = sorted(os.listdir(jout))
    assert names == sorted(os.listdir(tout)) and len(names) == 3
    for name in names:
        np.testing.assert_array_equal(np.asarray(Image.open(os.path.join(tout, name))),
                                      np.asarray(Image.open(os.path.join(jout, name))))
    with pytest.raises(ValueError, match="does not contain any images"):
        tviz.label_vot_sequence(str(tmp_path))
