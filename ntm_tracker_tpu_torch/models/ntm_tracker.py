"""Sequence unroll of the NTM cell (counterpart of
ntm_tracker_tpu/models/ntm_tracker.py).

`ntm_tracker_unroll` runs the cell over a serialized token stream: an
eager loop over ntm_cell_step (models/ntm_cell.cell_loop, which keeps
`use_pallas`, so each step's addressing goes to the B3 kernel when the
config asks for it), with torch.utils.checkpoint standing in for
jax.checkpoint (a selective policy for "dots"), or the whole-sequence
training kernels (ops/kernels/scan_bptt.py) when `fused_bptt` routes
there.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ntm_tracker_tpu_torch.config import NTMConfig
from ntm_tracker_tpu_torch.models.ntm_cell import NTMState, cell_loop, init_ntm_params, init_ntm_state, ntm_cell_step
from ntm_tracker_tpu_torch.ops.kernels.scan_bptt import ntm_scan_fused_bptt


def use_fused_bptt(fused_bptt, inputs: torch.Tensor, compute_dtype=None) -> bool:
    """Resolve `fused_bptt` (True, False or "auto") for these inputs.

    "auto" takes the fused kernels for cuda tensors at float32 compute, at
    any batch, and the plain loop on the CPU or at bf16. (The JAX rule, one
    TPU chip at B >= 64, was set by TPU compile times and tiles; PERF.md
    records the card run behind this one.) True with bf16 compute raises:
    the kernels are float32 only."""
    if isinstance(fused_bptt, str) and fused_bptt != "auto":
        # a typo'd string would otherwise be truthy and take the kernels
        raise ValueError(f"fused_bptt must be True, False or 'auto', got {fused_bptt!r}")
    f32 = compute_dtype is None or compute_dtype == torch.float32
    if fused_bptt == "auto":
        return inputs.device.type == "cuda" and f32
    if fused_bptt and not f32:
        raise ValueError("fused_bptt supports float32 compute only")
    return bool(fused_bptt)


def ntm_tracker_unroll(
    params: Dict[str, Any],
    cfg: NTMConfig,
    inputs: torch.Tensor,
    state: Optional[NTMState] = None,
    remat: bool | str = True,
    compute_dtype: Optional[torch.dtype] = None,
    layout: str = "nd",
    fused_bptt: bool | str = False,
    loop: Optional[Callable] = None,
) -> Tuple[torch.Tensor, torch.Tensor, NTMState]:
    """Run the cell over inputs [B, T, input_size].

    Returns (outputs [B,T,out] softmaxed, logits [B,T,out], final_state);
    state defaults to the learnable initial state.

    remat: True / "full" checkpoints every step (the backward recomputes
    it); "dots" keeps each step's matrix products and recomputes the rest
    (jax.checkpoint_policies.dots_saveable); False / "none" keeps every
    intermediate. layout="dn" runs the "nd" loop: JAX's "dn" carries the
    memory transposed for the TPU's 128-lane tiles, the same math, and
    the state goes in and comes out [B,N,D] either way. jax.lax.scan's
    `unroll` has no counterpart in an eager loop. With fused_bptt routed
    to the kernels (see use_fused_bptt) remat does not apply. loop
    replaces the per-step route's Python loop (models/ntm_cell.cell_loop).
    """
    if layout not in ("nd", "dn"):
        raise ValueError(f"unknown scan layout {layout!r}")
    if remat not in (True, False, "full", "none", "dots"):
        raise ValueError(f"unknown remat policy {remat!r}")
    if state is None:
        state = init_ntm_state(params, cfg, inputs.shape[0])
    if use_fused_bptt(fused_bptt, inputs, compute_dtype):
        logits, final_state = ntm_scan_fused_bptt(params, cfg, inputs, state)
    else:
        # the per-step route keeps cfg as given: use_pallas reaches B3
        logits, final_state = cell_loop(params, cfg, inputs, state, compute_dtype, remat=remat, loop=loop)
    return torch.softmax(logits, dim=-1), logits, final_state


def make_streaming_step(params, cfg: NTMConfig, compute_dtype=None):
    """A single-token step for online tracking: (x [B, in], state) ->
    (output, logit, new_state)."""

    def step(x, state):
        return ntm_cell_step(params, cfg, x, state, compute_dtype)

    return step


def two_step_inputs(inputs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The legacy two-step present/ask token stream
    (ntm_tracker_new.py:149-182): frame 0 is one (0-switch, frame, target)
    token; each later frame is (0-switch, frame, 0-target) then
    (1-switch, 0-frame, 0-target).

    inputs [B, L, D], target [B, Dt] -> [B, 2L-1, 1+D+Dt]."""
    B, L, D = inputs.shape
    Dt = target.shape[-1]
    zero_switch = inputs.new_zeros(B, 1)
    one_switch = inputs.new_ones(B, 1)
    dummy_input = inputs.new_zeros(B, D)
    dummy_target = inputs.new_zeros(B, Dt)
    toks = [torch.cat([zero_switch, inputs[:, 0], target.to(inputs.dtype)], dim=1)]
    for t in range(1, L):
        toks.append(torch.cat([zero_switch, inputs[:, t], dummy_target], dim=1))
        toks.append(torch.cat([one_switch, dummy_input, dummy_target], dim=1))
    return torch.stack(toks, dim=1)


def init_tracker(generator: Optional[torch.Generator], cfg: NTMConfig, input_size: int, device=None):
    """(params, init_state_fn) with init_state_fn(batch) -> state."""
    params = init_ntm_params(cfg, input_size, generator, device)
    return params, functools.partial(init_ntm_state, params, cfg)
