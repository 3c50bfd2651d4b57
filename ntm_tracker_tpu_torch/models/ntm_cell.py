"""The NTM cell as a function: (params, state, x) -> (y, logit, state)
(counterpart of ntm_tracker_tpu/models/ntm_cell.py).

Parameters are a dict of float32 tensors in the JAX package's layout and
names (`controller[l].kernel [in+Hc, 4Hc]`, `heads_w [Hc, P]`,
`init_M [N, D]`, ...), so interop.py moves weights across unchanged.
State is {'M' [B,N,D], 'w' [B,H,N], 'read' [B,R,D],
'controller_state' [(c, h)] per layer}, all contiguous float32.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from ntm_tracker_tpu_torch.config import NTMConfig
from ntm_tracker_tpu_torch.ops.kernels.addressing import fused_ntm_addressing
from ntm_tracker_tpu_torch.ops.lstm import init_lstm_params, matmul, multi_lstm_step, zero_lstm_state
from ntm_tracker_tpu_torch.ops.memory import (
    batched_circular_convolution,
    batched_slotwise_cosine_similarity,
    batched_smooth_cosine_similarity,
    sharpen,
)

NTMState = Dict[str, Any]

HEAD_PARAM_ORDER = ("k", "beta", "g", "sw", "gamma", "erase", "add")


def head_param_sizes(cfg: NTMConfig) -> Dict[str, int]:
    """Widths of the fused head-parameter linear's outputs, in
    HEAD_PARAM_ORDER (ntm_cell.py:113-126)."""
    h = cfg.num_heads
    return {
        "k": cfg.mem_dim * h,
        "beta": h,
        "g": h,
        "sw": cfg.shift_space * h,
        "gamma": h,
        "erase": cfg.mem_dim * cfg.write_head_size,
        "add": cfg.mem_dim * cfg.write_head_size,
    }


def init_ntm_params(
    cfg: NTMConfig,
    input_size: int,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> Dict[str, Any]:
    """Seeded parameters: uniform(-init_scale, init_scale) weights, zero
    biases. input_size is the token width before the read vectors are
    appended. (Seeded inits differ from the JAX package's; tests carry
    weights across with interop.py.)"""
    total_head = sum(head_param_sizes(cfg).values())
    hc, s = cfg.controller_hidden_size, cfg.init_scale

    def uniform(*shape):
        return ((2 * torch.rand(*shape, generator=generator) - 1) * s).to(device)

    return {
        "controller": init_lstm_params(
            input_size + cfg.read_head_size * cfg.mem_dim, hc,
            cfg.controller_num_layers, s, generator, device,
        ),
        "heads_w": uniform(hc, total_head),
        "heads_b": torch.zeros(total_head, device=device),
        "out_w": uniform(hc, cfg.output_dim),
        "out_b": torch.zeros(cfg.output_dim, device=device),
        "init_M": uniform(cfg.mem_size, cfg.mem_dim),
        "init_w": uniform(cfg.num_heads, cfg.mem_size),
        "init_read": uniform(cfg.read_head_size, cfg.mem_dim),
    }


def init_ntm_state(params: Dict[str, Any], cfg: NTMConfig, batch: int) -> NTMState:
    """The learnable initial state, squashed and repeated over the batch
    (ntm_cell.py:284-315). Contiguous, as the fused kernel requires."""
    def rep(x):
        return x.unsqueeze(0).repeat((batch,) + (1,) * x.dim())

    return {
        "M": rep(torch.tanh(params["init_M"])),
        "w": rep(torch.sigmoid(params["init_w"])),
        "read": rep(torch.tanh(params["init_read"])),
        "controller_state": zero_lstm_state(
            batch, cfg.controller_hidden_size, cfg.controller_num_layers,
            device=params["init_M"].device,
        ),
    }


def ntm_cell_step(
    params: Dict[str, Any],
    cfg: NTMConfig,
    inputs: torch.Tensor,
    state: NTMState,
    compute_dtype: Optional[torch.dtype] = None,
    with_debug: bool = False,
):
    """One NTM step.

    Args:
      inputs: [B, input_size] serialized token.
      compute_dtype: matmul dtype (ops/lstm.matmul); None = float32.
      with_debug: also return a dict of the addressing intermediates
        (always the eager math, as in JAX, even with cfg.use_pallas).
    Returns:
      (output [B,out] softmaxed, logit [B,out], new_state[, debug]).

    cfg.use_pallas sends the addressing and memory update after the head
    linear to ops/kernels/addressing.fused_ntm_addressing (the kernel on
    cuda, its plain version on the CPU).
    """
    M_prev, w_prev, read_prev = state["M"], state["w"], state["read"]
    B = inputs.shape[0]
    R, W, H, D = cfg.read_head_size, cfg.write_head_size, cfg.num_heads, cfg.mem_dim

    ctrl_in = torch.cat([inputs, read_prev.reshape(B, R * D)], dim=1)
    ctrl_out, ctrl_state = multi_lstm_step(
        params["controller"], ctrl_in, state["controller_state"],
        forget_bias=0.0, compute_dtype=compute_dtype,
    )

    controls = matmul(ctrl_out, params["heads_w"], compute_dtype) + params["heads_b"]
    sizes = head_param_sizes(cfg)
    k, beta, g, sw, gamma, erase, add = torch.split(
        controls, [sizes[n] for n in HEAD_PARAM_ORDER], dim=1
    )
    logit = matmul(ctrl_out, params["out_w"], compute_dtype) + params["out_b"]
    output = torch.softmax(logit, dim=-1)

    if cfg.use_pallas and not with_debug:
        M, w, read = fused_ntm_addressing(
            k.reshape(B, H, D), beta, g, sw.reshape(B, H, cfg.shift_space), gamma,
            erase.reshape(B, W, D), add.reshape(B, W, D), M_prev, w_prev,
            read_heads=R, write_first=cfg.write_first, slotwise=cfg.slotwise_cosine,
        )
        return output, logit, {"M": M, "w": w, "read": read, "controller_state": ctrl_state}

    k = torch.tanh(k.reshape(B, H, D))
    cos_fn = (
        batched_slotwise_cosine_similarity if cfg.slotwise_cosine
        else batched_smooth_cosine_similarity
    )
    similarity = cos_fn(M_prev, k)
    beta = torch.nn.functional.softplus(beta)[..., None]
    w_content = torch.softmax(similarity * beta, dim=-1)
    g = torch.sigmoid(g)[..., None]
    w_gated = w_content * g + w_prev * (1.0 - g)
    sw = torch.softmax(sw.reshape(B, H, cfg.shift_space), dim=-1)
    w_conv = batched_circular_convolution(w_gated, sw)
    gamma = (torch.nn.functional.softplus(gamma) + 1.0)[..., None]
    w = sharpen(w_conv, gamma)

    w_read = w[:, :R, :]
    w_write = w[:, R:, :]

    # erase/add write (ntm_cell.py:193-210), product/sum over write heads
    erase = torch.sigmoid(erase.reshape(B, W, D))
    add = torch.tanh(add.reshape(B, W, D))
    w_write_e = w_write[..., :, None]  # [B,W,N,1]
    M_erase = torch.prod(1.0 - w_write_e * erase[:, :, None, :], dim=1)
    M_write = torch.sum(w_write_e * add[:, :, None, :], dim=1)
    M = M_prev * M_erase + M_write

    read_src = M if cfg.write_first else M_prev
    read = torch.einsum("brn,bnd->brd", w_read, read_src)

    new_state = {"M": M, "w": w, "read": read, "controller_state": ctrl_state}
    if with_debug:
        debug = {
            "k": k, "beta": beta, "g": g, "sw": sw, "gamma": gamma,
            "similarity": similarity, "w_content_focused": w_content,
            "w_gated": w_gated, "w_conv": w_conv, "w": w,
            "erase": erase, "add": add, "M_erase": M_erase, "M_write": M_write,
        }
        return output, logit, new_state, debug
    return output, logit, new_state


def cell_loop(
    params: Dict[str, Any],
    cfg: NTMConfig,
    tokens: torch.Tensor,
    state: NTMState,
    compute_dtype: Optional[torch.dtype] = None,
    remat: bool = False,
) -> Tuple[torch.Tensor, NTMState]:
    """T cell steps over tokens [B, T, IN] as a Python loop over
    ntm_cell_step with cfg as given (use_pallas included): (logits
    [B, T, out], final state). remat=True wraps each step in
    torch.utils.checkpoint when gradients are recorded (the backward
    recomputes the step instead of keeping its activations)."""

    def step(x, carry):
        _, logit, new_state = ntm_cell_step(params, cfg, x, carry, compute_dtype)
        return logit, new_state

    checkpointed = remat and torch.is_grad_enabled()
    logits = [tokens.new_zeros(tokens.shape[0], 0, cfg.output_dim)]
    for t in range(tokens.shape[1]):
        if checkpointed:
            logit, state = torch.utils.checkpoint.checkpoint(step, tokens[:, t], state, use_reentrant=False)
        else:
            logit, state = step(tokens[:, t], state)
        logits.append(logit[:, None])
    return torch.cat(logits, dim=1), state
