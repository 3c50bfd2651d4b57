"""The MemoryCore facade: the NTM and DNC cores behind one functional
bundle (counterpart of ntm_tracker_tpu/models/core.py). The reference's
two training entries differ only in the recurrent core
(direct_offset_output.py, direct_offset_output_with_dnc.py)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from ntm_tracker_tpu_torch.config import TrackerConfig
from ntm_tracker_tpu_torch.models import ntm_cell
from ntm_tracker_tpu_torch.models.dnc import dnc as dnc_mod
from ntm_tracker_tpu_torch.models.ntm_tracker import ntm_tracker_unroll


@dataclasses.dataclass(frozen=True)
class MemoryCore:
    """Functional bundle: params/state constructors, unroll, single step,
    in the JAX package's field order (build it by keyword)."""

    # init_params(generator, input_size, device=None) -> params: JAX's
    # (rng, input_size) order, a torch.Generator (or None) in the rng's place
    init_params: Callable[..., Any]
    # init_state(params, batch) -> state
    init_state: Callable[[Any, int], Any]
    # unroll(params, inputs [B,T,D], state=None, remat=True, fused_bptt=None)
    #   -> (logits [B,T,out], state)
    unroll: Callable[..., Tuple[torch.Tensor, Any]]
    # step(params, x [B,D], state) -> (logit [B,out], state)
    step: Callable[..., Tuple[torch.Tensor, Any]]
    # state_view(state) -> {"M" [B,N,D], "w" [B,H,N], "read" [B,R,D]}: the
    # memory observables both cores expose for the dashboards (the
    # reference's Ms/ws/reads image summaries, main.py:1186-1214)
    state_view: Callable[[Any], dict] = None  # type: ignore[assignment]


def unroll_states(core: MemoryCore, params: Any, inputs: torch.Tensor, state: Any = None, stride: int = 1,
                  full_logits: bool = False) -> Tuple[torch.Tensor, dict, Any]:
    """Unroll while recording the memory observables every `stride` steps
    (the reference stacks them for every step, main.py:1186-1214; here
    only each chunk's last state is kept, T // stride snapshots).

    JAX's nested scan over core.step becomes a loop over chunks of
    `stride` steps, each a core.unroll from the carried state: the same
    function, and on cuda under torch.no_grad() the NTM core takes B1 once
    a chunk (fused_bptt "auto"), not one eager cell step a token. Both
    cores' unroll takes a state, so no chunk falls back to core.step.

    inputs [B,T,D]. When stride does not divide T, the last T % stride
    steps advance the state and record nothing. Returns (logits: [B,
    T//stride, out], each snapshot step's, or [B,T,out] with
    full_logits=True, so one unroll serves the loss and the dashboards;
    views {"M": [B,T//stride,N,D], "w": ..., "read": ...}; the state after
    all T steps)."""
    B, T, _ = inputs.shape
    if not 1 <= stride <= T:
        raise ValueError(f"stride={stride} out of range for T={T}")
    if state is None:
        state = core.init_state(params, B)
    n_chunks = T // stride
    logits, views = [], []
    for c in range(n_chunks):
        # a chunk of [B, T, D] is strided: the kernels take contiguous tokens
        chunk_logits, state = core.unroll(params, inputs[:, c * stride:(c + 1) * stride].contiguous(), state)
        logits.append(chunk_logits if full_logits else chunk_logits[:, -1:])
        views.append(core.state_view(state))
    if T % stride:
        tail_logits, state = core.unroll(params, inputs[:, n_chunks * stride:].contiguous(), state)
        if full_logits:
            logits.append(tail_logits)
    stacked = {k: torch.stack([v[k] for v in views], dim=1) for k in views[0]}
    return torch.cat(logits, dim=1), stacked, state


def make_core(cfg: TrackerConfig, loop: Optional[Callable] = None) -> MemoryCore:
    """The config's memory core. loop, when given, runs unroll's steps in
    place of the eager Python loop: loop(step, xs [T, B, D], state) ->
    (outs [T, B, out], state) (tools/export_serving passes
    models/traced_loop.scan_steps)."""
    if cfg.core == "dnc":
        return _dnc_core(cfg, loop)
    if cfg.core != "ntm":
        raise ValueError(f"unknown core: {cfg.core!r}")
    ncfg = cfg.ntm

    def init_params(generator, input_size, device=None):
        return ntm_cell.init_ntm_params(ncfg, input_size, generator, device)

    def init_state(params, batch):
        return ntm_cell.init_ntm_state(params, ncfg, batch)

    def step(params, x, state):
        _, logit, new_state = ntm_cell.ntm_cell_step(
            params, ncfg, x, state, compute_dtype=cfg.compute_dtype
        )
        return logit, new_state

    def unroll(params, inputs, state=None, remat=True, fused_bptt=None):
        # remat=True defers to the config's policy; False stays False.
        # fused_bptt=None defers to the config (cfg.train.fused_bptt).
        # cfg.train.scan_unroll is jax.lax.scan's unroll factor: the eager
        # loop has none, so it is not read.
        _, logits, final = ntm_tracker_unroll(
            params, ncfg, inputs, state=state,
            remat=cfg.train.remat_policy if remat is True else remat,
            compute_dtype=cfg.compute_dtype,
            layout=cfg.train.scan_layout,
            fused_bptt=cfg.train.fused_bptt if fused_bptt is None else fused_bptt,
            loop=loop,
        )
        return logits, final

    def state_view(state):
        return {"M": state["M"], "w": state["w"], "read": state["read"]}

    return MemoryCore(init_params=init_params, init_state=init_state, unroll=unroll, step=step,
                      state_view=state_view)


def _dnc_core(cfg: TrackerConfig, loop: Optional[Callable]) -> MemoryCore:
    dcfg = cfg.dnc

    def init_params(generator, input_size, device=None):
        return dnc_mod.init_dnc_params(dcfg, input_size, generator, device)

    def init_state(params, batch):
        # the DNC's initial state is all zeros (dnc/dnc.py:129-134)
        return dnc_mod.init_dnc_state(dcfg, batch, device=params["out_w"].device)

    def unroll(params, inputs, state=None, remat=True, fused_bptt=None):
        # no fused kernel serves the DNC: fused_bptt is not read
        return dnc_mod.dnc_unroll(params, dcfg, inputs, state=state, remat=remat,
                                  remat_chunk=dcfg.remat_chunk, loop=loop)

    def step(params, x, state):
        return dnc_mod.dnc_step(params, dcfg, x, state)

    def state_view(state):
        acc = state.access_state
        return {"M": acc.memory, "w": torch.cat([acc.read_weights, acc.write_weights], dim=1),
                "read": state.access_output}

    return MemoryCore(init_params=init_params, init_state=init_state, unroll=unroll, step=step,
                      state_view=state_view)
