"""Small utilities of the reference's utils.py / utility.py / ops.py legacy
paths (counterpart of ntm_tracker_tpu/utils/misc.py):

  pairwise_add              <- utility.py:4-44
  decaying_softmax          <- utility.py:47-59
  progress                  <- utils.py:14-31
  circular_convolution_1d   <- ops.py:244-275 (the legacy gather form)
"""

from __future__ import annotations

import math
import sys
from typing import Optional

import numpy as np
import torch


def pairwise_add(u: torch.Tensor, v: Optional[torch.Tensor] = None, is_batch: bool = False) -> torch.Tensor:
    """All pairwise sums of two vectors: out[i, j] = u[i] + v[j]."""
    if v is None:
        v = u
    if is_batch:
        return u[..., :, None] + v[..., None, :]
    return u[:, None] + v[None, :]


def decaying_softmax(shape, axis: int) -> np.ndarray:
    """Constant softmax-of-reversed-range weights broadcast to `shape`."""
    max_val = shape[axis]
    weights = np.arange(1, max_val + 1, dtype=np.float32)[::-1]
    weights = np.exp(weights) / np.sum(np.exp(weights))
    bshape = [1] * len(shape)
    bshape[axis] = max_val
    return np.zeros(shape, np.float32) + np.reshape(weights, bshape)


def circular_convolution_1d(v: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The legacy circular convolution (ops.py:244-275) with SYMMETRIC
    offsets: out[..., i] = sum_j v[..., (i + kshift - j) % N] * k[..., j],
    kshift = floor(K / 2). v [..., N], k [..., K] (leading dims broadcast;
    the reference's form is unbatched)."""
    size, ksize = v.shape[-1], k.shape[-1]
    kshift = int(math.floor(ksize / 2.0))
    idx = torch.tensor([[(i + j) % size for j in range(kshift, -kshift - 1, -1)] for i in range(size)],
                       device=v.device)
    return torch.sum(v[..., idx] * k[..., None, :], dim=-1)


def progress(current: float, total: float, width: int = 40, out=sys.stdout) -> None:
    """Text progress bar (utils.py:14-31)."""
    frac = 0.0 if total == 0 else current / total
    done = int(round(width * frac))
    out.write("\r[{}{}] {:.1f}%".format("#" * done, "-" * (width - done), frac * 100))
    out.flush()
