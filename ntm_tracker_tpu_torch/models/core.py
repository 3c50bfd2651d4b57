"""The MemoryCore facade (counterpart of ntm_tracker_tpu/models/core.py),
NTM only: the DNC core is not ported yet."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from ntm_tracker_tpu_torch.config import TrackerConfig
from ntm_tracker_tpu_torch.models import ntm_cell


@dataclasses.dataclass(frozen=True)
class MemoryCore:
    """Functional bundle: params/state constructors, single step, unroll."""

    # init_params(input_size, generator=None, device=None) -> params
    init_params: Callable[..., Any]
    # init_state(params, batch) -> state
    init_state: Callable[[Any, int], Any]
    # step(params, x [B,D], state) -> (logit [B,out], state)
    step: Callable[..., Tuple[torch.Tensor, Any]]
    # unroll(params, inputs [B,T,D], state=None) -> (logits [B,T,out], state)
    unroll: Callable[..., Tuple[torch.Tensor, Any]]


def make_core(cfg: TrackerConfig) -> MemoryCore:
    if cfg.core == "dnc":
        raise NotImplementedError("the DNC core is not ported yet")
    if cfg.core != "ntm":
        raise ValueError(f"unknown core: {cfg.core!r}")
    ncfg = cfg.ntm

    def init_params(input_size, generator=None, device=None):
        return ntm_cell.init_ntm_params(ncfg, input_size, generator, device)

    def init_state(params, batch):
        return ntm_cell.init_ntm_state(params, ncfg, batch)

    def step(params, x, state):
        _, logit, new_state = ntm_cell.ntm_cell_step(
            params, ncfg, x, state, compute_dtype=cfg.compute_dtype
        )
        return logit, new_state

    def unroll(params, inputs, state=None):
        if state is None:
            state = init_state(params, inputs.shape[0])
        logits = [inputs.new_zeros(inputs.shape[0], 0, ncfg.output_dim)]
        for t in range(inputs.shape[1]):
            logit, state = step(params, inputs[:, t], state)
            logits.append(logit[:, None])
        return torch.cat(logits, dim=1), state

    return MemoryCore(init_params, init_state, step, unroll)
