"""DNC MemoryAccess: read-write memory addressed by content, usage and
temporal links (counterpart of ntm_tracker_tpu/models/dnc/access.py; the
reference's dnc/access.py).

The reference's ten per-head interface linears (:160-218) are one matmul
whose output is split in `_interface_sizes` order, as in the JAX package
(each slice has its own columns of the weight, so the math is the same).
`erase_and_write` (:32-63), `_write_weights` (:220-257) and
`_read_weights` (:259-303) keep the reference's formulas. The state is
the AccessState NamedTuple (:28).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ntm_tracker_tpu_torch.config import DNCConfig
from ntm_tracker_tpu_torch.models.dnc.addressing import (
    TemporalLinkageState,
    cosine_weights,
    directional_read_weights,
    temporal_linkage_update,
    usage_update,
    write_allocation_weights,
)


class AccessState(NamedTuple):
    memory: torch.Tensor         # [B, N, W]
    read_weights: torch.Tensor   # [B, R, N]
    write_weights: torch.Tensor  # [B, Wh, N]
    linkage: TemporalLinkageState
    usage: torch.Tensor          # [B, N]


def _interface_sizes(cfg: DNCConfig) -> Dict[str, int]:
    """Column layout of the fused interface linear (dnc/access.py:160-218)."""
    R, Wh, W = cfg.num_reads, cfg.num_writes, cfg.word_size
    return {
        "write_vectors": Wh * W,
        "erase_vectors": Wh * W,
        "free_gate": R,
        "allocation_gate": Wh,
        "write_gate": Wh,
        "read_mode": R * (1 + 2 * Wh),
        "write_keys": Wh * W,
        "write_strengths": Wh,
        "read_keys": R * W,
        "read_strengths": R,
    }


def truncated_normal(shape, std: float, generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
    """Normal(0, 1) truncated to [-2, 2], times std (sonnet's initializer;
    seeded draws differ from the JAX package's, tests carry weights across
    with interop.py)."""
    t = torch.nn.init.trunc_normal_(torch.empty(shape), 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * std).to(device)


def init_access_params(cfg: DNCConfig, input_size: int, generator: Optional[torch.Generator] = None,
                       device=None) -> Dict[str, Any]:
    """The fused interface linear: truncated normal scaled by
    1/sqrt(fan_in) (snt.Linear's default), zero bias."""
    total = sum(_interface_sizes(cfg).values())
    return {"interface_w": truncated_normal((input_size, total), input_size ** -0.5, generator, device),
            "interface_b": torch.zeros(total, device=device)}


def init_access_state(cfg: DNCConfig, batch: int, device=None) -> AccessState:
    """All zeros (snt.RNNCore.initial_state's default)."""
    N, W, R, Wh = cfg.memory_size, cfg.word_size, cfg.num_reads, cfg.num_writes

    def z(*shape):
        return torch.zeros(*shape, device=device)

    return AccessState(
        memory=z(batch, N, W),
        read_weights=z(batch, R, N),
        write_weights=z(batch, Wh, N),
        linkage=TemporalLinkageState(link=z(batch, Wh, N, N), precedence_weights=z(batch, Wh, N)),
        usage=z(batch, N),
    )


def _read_inputs(params: Dict[str, Any], cfg: DNCConfig, inputs: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The interface vector split into its named controls (dnc/access.py:160-218)."""
    R, Wh, W = cfg.num_reads, cfg.num_writes, cfg.word_size
    B = inputs.shape[0]
    sizes = _interface_sizes(cfg)
    fused = inputs @ params["interface_w"] + params["interface_b"]
    out = dict(zip(sizes, torch.split(fused, list(sizes.values()), dim=1)))
    return {
        "write_vectors": out["write_vectors"].reshape(B, Wh, W),
        "erase_vectors": torch.sigmoid(out["erase_vectors"]).reshape(B, Wh, W),
        "free_gate": torch.sigmoid(out["free_gate"]),
        "allocation_gate": torch.sigmoid(out["allocation_gate"]),
        "write_gate": torch.sigmoid(out["write_gate"]),
        "read_mode": torch.softmax(out["read_mode"].reshape(B, R, 1 + 2 * Wh), dim=-1),
        "write_content_keys": out["write_keys"].reshape(B, Wh, W),
        "write_content_strengths": out["write_strengths"],
        "read_content_keys": out["read_keys"].reshape(B, R, W),
        "read_content_strengths": out["read_strengths"],
    }


def erase_and_write(memory: torch.Tensor, address: torch.Tensor, reset_weights: torch.Tensor,
                    values: torch.Tensor) -> torch.Tensor:
    """M * prod_h(1 - w_h^T e_h) + sum_h w_h^T a_h (dnc/access.py:32-63):
    memory [B,N,W], address [B,Wh,N], reset_weights and values [B,Wh,W]."""
    weighted_resets = address[..., :, :, None] * reset_weights[..., :, None, :]
    reset_gate = torch.prod(1 - weighted_resets, dim=1)
    return memory * reset_gate + address.transpose(1, 2) @ values


def _write_weights(cfg: DNCConfig, inputs: Dict[str, torch.Tensor], memory: torch.Tensor,
                   usage: torch.Tensor) -> torch.Tensor:
    """dnc/access.py:220-257."""
    write_content = cosine_weights(memory, inputs["write_content_keys"], inputs["write_content_strengths"])
    write_alloc = write_allocation_weights(
        usage, inputs["allocation_gate"] * inputs["write_gate"], cfg.num_writes)
    ag = inputs["allocation_gate"][..., None]
    wg = inputs["write_gate"][..., None]
    return wg * (ag * write_alloc + (1 - ag) * write_content)


def _read_weights(cfg: DNCConfig, inputs: Dict[str, torch.Tensor], memory: torch.Tensor,
                  prev_read_weights: torch.Tensor, link: torch.Tensor) -> torch.Tensor:
    """dnc/access.py:259-303."""
    Wh = cfg.num_writes
    content = cosine_weights(memory, inputs["read_content_keys"], inputs["read_content_strengths"])
    forward = directional_read_weights(link, prev_read_weights, forward=True)
    backward = directional_read_weights(link, prev_read_weights, forward=False)
    mode = inputs["read_mode"]
    backward_mode, forward_mode, content_mode = mode[:, :, :Wh], mode[:, :, Wh:2 * Wh], mode[:, :, 2 * Wh]
    return (content_mode[..., None] * content
            + torch.sum(forward_mode[..., None] * forward, dim=2)
            + torch.sum(backward_mode[..., None] * backward, dim=2))


def memory_access_step(params: Dict[str, Any], cfg: DNCConfig, inputs: torch.Tensor,
                       prev_state: AccessState) -> Tuple[torch.Tensor, AccessState]:
    """One MemoryAccess step (dnc/access.py:113-158): the controller's
    output [B, input_size] -> (read words [B, R, W], the next AccessState)."""
    ctl = _read_inputs(params, cfg, inputs)
    usage = usage_update(prev_state.write_weights, ctl["free_gate"], prev_state.read_weights, prev_state.usage)
    write_weights = _write_weights(cfg, ctl, prev_state.memory, usage)
    memory = erase_and_write(prev_state.memory, write_weights, ctl["erase_vectors"], ctl["write_vectors"])
    linkage = temporal_linkage_update(write_weights, prev_state.linkage)
    read_weights = _read_weights(cfg, ctl, memory, prev_state.read_weights, linkage.link)
    read_words = read_weights @ memory
    return read_words, AccessState(memory=memory, read_weights=read_weights, write_weights=write_weights,
                                   linkage=linkage, usage=usage)
