"""Convert the public slim vgg_16.ckpt into the .npz the port loads
(models/vgg.py:load_params_npz; counterpart of
ntm_tracker_tpu/tools/convert_vgg.py, the same archive).

TensorFlow is needed once, offline, to read the checkpoint:

    python -m ntm_tracker_tpu_torch --device cpu convert-vgg --ckpt vgg_16.ckpt --out vgg16.npz

Keys in the archive keep the slim names ('vgg_16/conv1/conv1_1/weights',
HWIO [3,3,in,out]; '/biases' [out]), so either package's `load_params_npz`
reads it (the port transposes to OIHW on load).
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, Optional

import numpy as np

from ntm_tracker_tpu_torch.models.vgg import VGG16_PREFIX


def checkpoint_sha256(ckpt_path: str) -> str:
    """sha256 of the checkpoint's data bytes: the file itself (V1 single-
    file ckpt, the public vgg_16.ckpt layout) or, for V2 checkpoints, the
    sorted .index/.data-* shards concatenated."""
    h = hashlib.sha256()
    if os.path.isfile(ckpt_path):
        paths = [ckpt_path]
    else:
        import glob

        paths = sorted(glob.glob(ckpt_path + ".index") + glob.glob(ckpt_path + ".data-*"))
        if not paths:
            raise FileNotFoundError(f"no checkpoint files at {ckpt_path}")
    for p in paths:
        with open(p, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
    return h.hexdigest()


def activation_stats(npz_path: str, device=None) -> Dict[str, float]:
    """conv4_3 activation statistics on a deterministic ramp image: a quick
    self-check that converted weights give ImageNet-scale features (a
    random-init VGG reads very differently). Runs on cuda unless `device`
    names another device."""
    import torch

    from ntm_tracker_tpu_torch.config import resolve_device
    from ntm_tracker_tpu_torch.models.vgg import load_params_npz, vgg16_features

    dev = resolve_device(device)
    params = load_params_npz(npz_path, dev)
    # deterministic mean-subtracted ramp, [-110, 110]-ish like real inputs
    y = np.linspace(-110.0, 110.0, 224, dtype=np.float32)
    img = np.stack(
        [np.add.outer(y, y[::-1] * 0.5), np.add.outer(y * 0.3, y), np.add.outer(-y, y * 0.8)], axis=-1
    )[None]
    with torch.no_grad():
        act = vgg16_features(params, torch.as_tensor(img, device=dev)).cpu().numpy()
    return {
        "conv43_mean": float(act.mean()),
        "conv43_std": float(act.std()),
        "conv43_max": float(act.max()),
        "conv43_sparsity": float((act == 0).mean()),
    }


def convert_vgg_checkpoint(
    ckpt_path: str, out_path: str, require_conv5: bool = False, expect_sha256: Optional[str] = None,
) -> Dict[str, tuple]:
    """Read a slim vgg_16 checkpoint and write the .npz.

    Args:
      ckpt_path: path to vgg_16.ckpt (the public slim release or any
        checkpoint with 'vgg_16/<block>/<layer>/{weights,biases}' tensors).
      out_path: destination .npz.
      require_conv5: fail if the conv5 block is absent (it is only needed
        for the pool5 endpoint; conv1-conv4_3 archives are valid).
      expect_sha256: verify the checkpoint bytes hash to this hex digest
        before conversion (guards against a wrong or corrupt download).
    Returns:
      {key: shape} of the arrays written.
    """
    if expect_sha256:
        want = expect_sha256.lower()
        got = checkpoint_sha256(ckpt_path)
        if got != want:
            raise ValueError(
                f"checkpoint sha256 mismatch: {ckpt_path} hashes to\n  {got}\nexpected\n  {want}\n"
                "— wrong/corrupt download? (the public vgg_16.ckpt is in vgg_16_2016_08_28.tar.gz)"
            )
    try:
        import tensorflow as tf  # local import: TF is an offline-only dependency
    except ImportError as e:
        raise ImportError(
            "convert-vgg needs tensorflow to read the checkpoint; run this step on a machine with TF "
            "installed. The resulting .npz is TF-free"
        ) from e

    reader = tf.train.load_checkpoint(ckpt_path)
    arrays: Dict[str, np.ndarray] = {}
    for name, out_ch, _ in VGG16_PREFIX:
        for kind in ("weights", "biases"):
            key = f"vgg_16/{name}/{kind}"
            if not reader.has_tensor(key):
                if name.startswith("conv5") and not require_conv5:
                    continue
                raise KeyError(f"checkpoint {ckpt_path} has no tensor {key}")
            value = reader.get_tensor(key)
            if kind == "weights" and value.ndim != 4:
                raise ValueError(f"{key}: expected HWIO conv kernel, got {value.shape}")
            if value.shape[-1] != out_ch:
                raise ValueError(f"{key}: trailing dim {value.shape[-1]} != {out_ch}")
            arrays[key] = value.astype(np.float32)
    np.savez(out_path, **arrays)
    return {k: v.shape for k, v in arrays.items()}
