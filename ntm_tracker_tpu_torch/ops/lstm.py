"""Stacked-LSTM controller with TF BasicLSTMCell semantics
(counterpart of ntm_tracker_tpu/ops/lstm.py).

    gates = concat([x, h], 1) @ W + b      (gate order i, j, f, o)
    c' = c * sigmoid(f + forget_bias) + sigmoid(i) * tanh(j)
    h' = tanh(c') * sigmoid(o)

with forget_bias = 0. State is a list of (c, h) pairs, one per layer.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

LSTMState = List[Tuple[torch.Tensor, torch.Tensor]]


def matmul(a: torch.Tensor, b: torch.Tensor, compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """a @ b under the compute-dtype policy: operands rounded to
    compute_dtype, products summed in float32, the result rounded to
    compute_dtype and returned as float32. That is what a bf16 matrix unit
    with float32 accumulation returns, computed the same way on any
    device, so the CUDA kernel can be held to it."""
    if compute_dtype is None or compute_dtype == torch.float32:
        return a @ b
    out = a.to(compute_dtype).float() @ b.to(compute_dtype).float()
    return out.to(compute_dtype).float()


def init_lstm_params(
    input_size: int,
    hidden_size: int,
    num_layers: int,
    init_scale: float = 0.05,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> list[dict[str, torch.Tensor]]:
    """Uniform(-init_scale, init_scale) kernels [in + hidden, 4 hidden],
    zero biases."""
    params = []
    in_dim = input_size
    for _ in range(num_layers):
        k = torch.rand(in_dim + hidden_size, 4 * hidden_size, generator=generator)
        params.append({
            "kernel": ((2 * k - 1) * init_scale).to(device),
            "bias": torch.zeros(4 * hidden_size, device=device),
        })
        in_dim = hidden_size
    return params


def zero_lstm_state(batch: int, hidden_size: int, num_layers: int, device=None) -> LSTMState:
    return [
        (torch.zeros(batch, hidden_size, device=device),
         torch.zeros(batch, hidden_size, device=device))
        for _ in range(num_layers)
    ]


def lstm_cell_step(
    params: dict[str, torch.Tensor],
    x: torch.Tensor,
    state: Tuple[torch.Tensor, torch.Tensor],
    forget_bias: float = 0.0,
    compute_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One BasicLSTMCell step. x: [B, in], state: ([B,H], [B,H])."""
    c, h = state
    gates = matmul(torch.cat([x, h], dim=1), params["kernel"], compute_dtype) + params["bias"]
    i, j, f, o = torch.chunk(gates, 4, dim=1)
    new_c = c * torch.sigmoid(f + forget_bias) + torch.sigmoid(i) * torch.tanh(j)
    new_h = torch.tanh(new_c) * torch.sigmoid(o)
    return new_h, (new_c, new_h)


def multi_lstm_step(
    params: Sequence[dict[str, torch.Tensor]],
    x: torch.Tensor,
    state: LSTMState,
    forget_bias: float = 0.0,
    compute_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, LSTMState]:
    """Stacked LSTM (MultiRNNCell) step: each layer feeds the next."""
    new_state: LSTMState = []
    out = x
    for layer_params, layer_state in zip(params, state):
        out, s = lstm_cell_step(layer_params, out, layer_state, forget_bias, compute_dtype)
        new_state.append(s)
    return out, new_state
