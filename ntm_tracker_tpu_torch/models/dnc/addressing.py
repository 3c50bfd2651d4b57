"""DNC addressing: cosine content weights, temporal linkage, usage and
allocation (counterpart of ntm_tracker_tpu/models/dnc/addressing.py; the
reference's dnc/addressing.py).

The contracts are the reference's: epsilon 1e-6 (:28), no gradient
through the write weights into the usage (:302), allocation by sorted
usage (:376-405). Two points of the port:

  * The sort puts the lower slot first among equal usages, as
    jax.lax.top_k does (torch.topk gives no such order). The initial usage
    is all zeros, so step 0 is all ties: the order decides which slot the
    first write allocates. A stable descending torch.sort keeps it.
  * The allocation is unsorted by scattering each sorted value back to its
    slot: the inverse permutation that jnp.argsort(indices) builds.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ntm_tracker_tpu_torch.ops.memory import weighted_softmax

# dnc/addressing.py:28
EPSILON = 1e-6


class TemporalLinkageState(NamedTuple):
    """link [B, num_writes, N, N]; precedence_weights [B, num_writes, N]."""

    link: torch.Tensor
    precedence_weights: torch.Tensor


@functools.lru_cache(maxsize=None)
def _off_diagonal(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """1 - I [n, n], made once per shape and device."""
    return 1.0 - torch.eye(n, dtype=dtype, device=device)


def _vector_norms(m: torch.Tensor) -> torch.Tensor:
    """sqrt(sum(m^2) + eps) over the last axis, kept (dnc/addressing.py:34-36)."""
    return torch.sqrt(torch.sum(m * m, dim=2, keepdim=True) + EPSILON)


def cosine_weights(memory: torch.Tensor, keys: torch.Tensor, strengths: torch.Tensor,
                   strength_op=F.softplus) -> torch.Tensor:
    """Content addressing: memory [B,N,W], keys [B,H,W], strengths [B,H]
    -> [B,H,N] (dnc/addressing.py:58-105)."""
    dot = keys @ memory.transpose(1, 2)
    norm = _vector_norms(keys) * _vector_norms(memory).transpose(1, 2)
    return weighted_softmax(dot / (norm + EPSILON), strengths, strength_op)


def temporal_linkage_update(write_weights: torch.Tensor,
                            prev_state: TemporalLinkageState) -> TemporalLinkageState:
    """The link graphs and precedence weights after a write of
    write_weights [B, num_writes, N] (dnc/addressing.py:133-240)."""
    w_i = write_weights[..., :, None]
    w_j = write_weights[..., None, :]
    prev_p_j = prev_state.precedence_weights[..., None, :]
    link = (1 - w_i - w_j) * prev_state.link + w_i * prev_p_j
    # no self-links (dnc/addressing.py:212-218)
    link = link * _off_diagonal(link.shape[-1], link.dtype, link.device)
    write_sum = torch.sum(write_weights, dim=2, keepdim=True)
    precedence = (1 - write_sum) * prev_state.precedence_weights + write_weights
    return TemporalLinkageState(link=link, precedence_weights=precedence)


def directional_read_weights(link: torch.Tensor, prev_read_weights: torch.Tensor,
                             forward: bool) -> torch.Tensor:
    """Read weights one step along the links: link [B, num_writes, N, N],
    prev_read_weights [B, num_reads, N] -> [B, num_reads, num_writes, N]
    (dnc/addressing.py:155-181)."""
    # [B, 1, R, N] @ [B, Wh, N, N] -> [B, Wh, R, N] -> [B, R, Wh, N]
    return (prev_read_weights[:, None] @ (link.transpose(-1, -2) if forward else link)).transpose(1, 2)


def usage_update(write_weights: torch.Tensor, free_gate: torch.Tensor,
                 read_weights: torch.Tensor, prev_usage: torch.Tensor) -> torch.Tensor:
    """The usage u_t from the previous step's write weights [B, Wh, N] and
    read weights [B, R, N], the free gate [B, R] and prev_usage [B, N]
    (dnc/addressing.py:279-305, 342-374). No gradient flows through the
    write weights (:302)."""
    write_weights = write_weights.detach()
    usage = prev_usage + (1 - prev_usage) * (1 - torch.prod(1 - write_weights, dim=1))
    phi = torch.prod(1 - free_gate[..., None] * read_weights, dim=1)
    return usage * phi


def _allocation(usage: torch.Tensor) -> torch.Tensor:
    """Allocation weighting [B, N] by sorted usage [B, N]
    (dnc/addressing.py:376-405)."""
    usage = EPSILON + (1 - EPSILON) * usage
    # descending non-usage, the lower slot first on ties (jax.lax.top_k's order)
    sorted_nonusage, indices = torch.sort(1 - usage, dim=1, descending=True, stable=True)
    sorted_usage = 1 - sorted_nonusage
    # exclusive cumulative product: 1 first
    prod_sorted_usage = torch.cat(
        [torch.ones_like(sorted_usage[:, :1]), torch.cumprod(sorted_usage[:, :-1], dim=1)], dim=1)
    sorted_allocation = sorted_nonusage * prod_sorted_usage
    # unsort: each value back to its slot
    return torch.zeros_like(sorted_allocation).scatter(1, indices, sorted_allocation)


def write_allocation_weights(usage: torch.Tensor, write_gates: torch.Tensor,
                             num_writes: int) -> torch.Tensor:
    """Allocation weights [B, num_writes, N] for each write head, the usage
    updated between heads as if the earlier ones wrote
    (dnc/addressing.py:307-340). usage [B, N], write_gates [B, num_writes]."""
    write_gates = write_gates[..., None]
    allocation_weights = []
    for i in range(num_writes):
        aw = _allocation(usage)
        allocation_weights.append(aw)
        usage = usage + (1 - usage) * write_gates[:, i, :] * aw
    return torch.stack(allocation_weights, dim=1)
