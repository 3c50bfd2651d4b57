"""External-memory math of the NTM cell (counterpart of ntm_tracker_tpu/ops/memory.py).

The contracts are those of the reference `ops.py`:
  * l2 normalization floors the SQUARED norm at 1e-12, as TF's
    l2_normalize does (`F.normalize` floors the norm itself, so it is not
    used here)
  * batched_smooth_cosine_similarity normalizes each mem_dim row ACROSS
    slots (the executed reference, ops.py:147-150); the slotwise form is
    the textbook cosine
  * circular-convolution offsets follow the Python-2 floor division:
    {-2,-1,0} for S=3, not {-1,0,1}
  * sharpen divides by sum + 1e-3
  * the legacy model's forms (ops.py:161-178, :216-242, :277-304):
    smooth_cosine_similarity with the +1e-3 norm smoothing,
    circular_shift and outer_product
"""

from __future__ import annotations

import torch

# TF tf.nn.l2_normalize epsilon (floor on the squared norm).
_L2_NORMALIZE_EPS = 1e-12


def _l2_normalize(x: torch.Tensor, dim: int) -> torch.Tensor:
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp_min(sq, _L2_NORMALIZE_EPS))


def batched_smooth_cosine_similarity(memory: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """memory [B,N,D], keys [B,H,D] -> [B,H,N], with memory normalized
    across slots (the reference's executed quirk)."""
    mem_n = _l2_normalize(memory, dim=1)
    key_n = _l2_normalize(keys, dim=2)
    return torch.einsum("bhd,bnd->bhn", key_n, mem_n)


def batched_slotwise_cosine_similarity(memory: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """True cosine similarity: each memory slot vector normalized."""
    mem_n = _l2_normalize(memory, dim=2)
    key_n = _l2_normalize(keys, dim=2)
    return torch.einsum("bhd,bnd->bhn", key_n, mem_n)


def smooth_cosine_similarity(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The legacy form (ops.py:161-178): dot / (|m| |v| + 1e-3).
    m [..., N, D], v [..., D] -> [..., N] (the reference's is unbatched)."""
    m_norm = torch.sqrt(torch.sum(m * m, dim=-1))
    v_norm = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    return (m @ v[..., None])[..., 0] / (m_norm * v_norm + 1e-3)


def circular_shift(x: torch.Tensor, shift: int) -> torch.Tensor:
    """result[..., i] = x[..., (i + shift) % N]  (ops.py:216-242)."""
    return torch.roll(x, -shift, dims=-1)


def circular_convolution_shifts(shift_space: int) -> list[int]:
    """Offsets of the reference's stack-of-shifts conv (ops.py:204-209):
    [-2,-1,0] for S=3 and [-3,-2,-1,0,1] for S=5."""
    start = -((shift_space + 1) // 2)
    return list(range(start, shift_space + start))


def batched_circular_convolution(tensor: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """out[b,h,i] = sum_j kernel[b,h,j] * tensor[b,h,(i + s_j) % N].

    tensor [B,H,N], kernel [B,H,S] -> [B,H,N]."""
    shifts = circular_convolution_shifts(kernel.shape[-1])
    out = torch.zeros_like(tensor)
    for j, s in enumerate(shifts):
        out = out + kernel[..., j : j + 1] * torch.roll(tensor, -s, dims=-1)
    return out


def sharpen(w: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """w^gamma / (sum w^gamma + 1e-3); w [B,H,N] >= 0, gamma [B,H,1]."""
    powed = torch.pow(w, gamma)
    return powed / (torch.sum(powed, dim=2, keepdim=True) + eps)


def weighted_softmax(activations: torch.Tensor, strengths: torch.Tensor, strength_op) -> torch.Tensor:
    """softmax(activations * strength_op(strengths)[..., None]) over the
    last axis (the DNC's content weighting, dnc/addressing.py:39-55).
    activations [B,H,N], strengths [B,H]."""
    return torch.softmax(activations * strength_op(strengths)[..., None], dim=-1)


def outer_product(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched outer product: [..., n] x [..., m] -> [..., n, m]
    (ops.py:277-304)."""
    return u[..., :, None] * v[..., None, :]
