"""DNC core: LSTM controller, MemoryAccess and an output linear
(counterpart of ntm_tracker_tpu/models/dnc/dnc.py; the reference's
dnc/dnc.py:36-142):

    controller input = concat(x, previous read words)        (:106-107)
    output           = Linear(concat(controller out, reads))  (:118-121)
    clip_value clamps the controller's output and state and the output
    (:78-82, 112-113)

The sonnet LSTM controller adds forget_bias=1.0 (snt.LSTM's default), not
the NTM cell's 0. No hand-written kernel: each step is plain PyTorch, on
the card as on the CPU.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.utils.checkpoint

from ntm_tracker_tpu_torch.config import DNCConfig
from ntm_tracker_tpu_torch.models.dnc.access import (
    AccessState,
    init_access_params,
    init_access_state,
    memory_access_step,
    truncated_normal,
)
from ntm_tracker_tpu_torch.ops.lstm import multi_lstm_step, zero_lstm_state
from ntm_tracker_tpu_torch.train.optim import tree_map


class DNCState(NamedTuple):
    access_output: torch.Tensor  # [B, R, W] read words
    access_state: AccessState
    controller_state: Any        # [(c, h)], one layer


def init_dnc_params(cfg: DNCConfig, input_size: int, generator: Optional[torch.Generator] = None,
                    device=None) -> Dict[str, Any]:
    """Seeded parameters with the JAX package's names and shapes: sonnet's
    truncated normal scaled by 1/sqrt(fan_in) on the controller kernel
    [input_size + R*W + hidden, 4 hidden], the interface and the output
    linear; zero biases. input_size is the token width."""
    R, W, Hc = cfg.num_reads, cfg.word_size, cfg.hidden_size
    ctrl_in = input_size + R * W
    out_in = Hc + R * W
    return {
        "controller": [{
            "kernel": truncated_normal((ctrl_in + Hc, 4 * Hc), (ctrl_in + Hc) ** -0.5, generator, device),
            "bias": torch.zeros(4 * Hc, device=device),
        }],
        "access": init_access_params(cfg, Hc, generator, device),
        "out_w": truncated_normal((out_in, cfg.output_dim), out_in ** -0.5, generator, device),
        "out_b": torch.zeros(cfg.output_dim, device=device),
    }


def init_dnc_state(cfg: DNCConfig, batch: int, device=None) -> DNCState:
    """Zeros everywhere (dnc/dnc.py:129-134)."""
    return DNCState(
        access_output=torch.zeros(batch, cfg.num_reads, cfg.word_size, device=device),
        access_state=init_access_state(cfg, batch, device),
        controller_state=zero_lstm_state(batch, cfg.hidden_size, 1, device=device),
    )


def _clip(x: torch.Tensor, clip_value: float) -> torch.Tensor:
    if clip_value and clip_value > 0:
        return torch.clamp(x, -clip_value, clip_value)
    return x


def dnc_step(params: Dict[str, Any], cfg: DNCConfig, inputs: torch.Tensor,
             prev_state: DNCState) -> Tuple[torch.Tensor, DNCState]:
    """One DNC step (dnc/dnc.py:84-127): inputs [B, input_size] ->
    (output [B, output_dim], next state)."""
    B = inputs.shape[0]
    ctrl_in = torch.cat([inputs.reshape(B, -1), prev_state.access_output.reshape(B, -1)], dim=1)
    ctrl_out, ctrl_state = multi_lstm_step(params["controller"], ctrl_in, prev_state.controller_state,
                                           forget_bias=1.0)
    ctrl_out = _clip(ctrl_out, cfg.clip_value)
    ctrl_state = tree_map(lambda t: _clip(t, cfg.clip_value), ctrl_state)
    access_output, access_state = memory_access_step(params["access"], cfg, ctrl_out, prev_state.access_state)
    output = torch.cat([ctrl_out, access_output.reshape(B, -1)], dim=1) @ params["out_w"] + params["out_b"]
    return _clip(output, cfg.clip_value), DNCState(access_output, access_state, ctrl_state)


def dnc_unroll(params: Dict[str, Any], cfg: DNCConfig, inputs: torch.Tensor, state: Optional[DNCState] = None,
               remat: bool = True, time_major: bool = False,
               remat_chunk: Optional[int] = None, loop: Optional[Callable] = None) -> Tuple[torch.Tensor, DNCState]:
    """The DNC over a sequence, inputs [B, T, D] ([T, B, D] if time_major)
    -> (outputs in the same layout, final state); the reference runs it
    in tf.nn.dynamic_rnn (dnc/train.py:69-91).

    remat=True checkpoints every step when gradients are recorded
    (torch.utils.checkpoint: the backward recomputes a step from its saved
    input state, as jax.checkpoint does in the JAX package's scan).
    remat_chunk=C > 0 also checkpoints chunks of C steps, so only every
    C-th state persists and the backward replays one chunk at a time
    (T/C saved states + C transient ones); 0 keeps one state per step.
    Gradients are the same either way. The port's auto (None) is 0: the
    state saved per step is dominated by the link matrix [B, Wh, N, N],
    21.8 GB over T=1300 at B=256, N=128, which an 80 GB card holds. (The
    JAX package's auto switches to C=65 past 2 GB, a rule made for a TPU's
    16 GB.) loop, when given, runs the steps instead: loop(step, xs
    [T, B, D], state) -> (outs [T, B, out], state)."""
    xs = inputs if time_major else inputs.transpose(0, 1)
    T = xs.shape[0]
    if state is None:
        state = init_dnc_state(cfg, xs.shape[1], device=xs.device)
    chunk = remat_chunk or 0
    checkpointed = remat and torch.is_grad_enabled()

    def step(x, carry):
        return dnc_step(params, cfg, x, carry)

    def run(carry, x_seq):
        outs = []
        for x in x_seq:
            if checkpointed:
                out, carry = torch.utils.checkpoint.checkpoint(step, x, carry, use_reentrant=False)
            else:
                out, carry = step(x, carry)
            outs.append(out)
        return torch.stack(outs), carry

    if loop is not None and T:
        # the caller's loop (tools/export_serving: one scan)
        outputs, state = loop(step, xs, state)
    elif checkpointed and chunk and T >= chunk:
        pieces = []
        for start in range(0, T - T % chunk, chunk):
            out, state = torch.utils.checkpoint.checkpoint(run, state, xs[start:start + chunk],
                                                           use_reentrant=False)
            pieces.append(out)
        if T % chunk:
            out, state = run(state, xs[T - T % chunk:])
            pieces.append(out)
        outputs = torch.cat(pieces)
    elif T:
        outputs, state = run(state, xs)
    else:
        outputs = xs.new_zeros(0, xs.shape[1], cfg.output_dim)
    return (outputs if time_major else outputs.transpose(0, 1)), state
