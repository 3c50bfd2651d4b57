"""The MemoryCore facade: the NTM and DNC cores behind one functional
bundle (counterpart of ntm_tracker_tpu/models/core.py). The reference's
two training entries differ only in the recurrent core
(direct_offset_output.py, direct_offset_output_with_dnc.py)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

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
    # JAX's state_view(state) -> {"M", "w", "read"}, the memory observables
    # its dashboards read: None until the dashboards are ported (ROADMAP.md,
    # item A6)
    state_view: Callable[[Any], dict] = None  # type: ignore[assignment]


def make_core(cfg: TrackerConfig) -> MemoryCore:
    if cfg.core == "dnc":
        return _dnc_core(cfg)
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
        )
        return logits, final

    return MemoryCore(init_params=init_params, init_state=init_state, unroll=unroll, step=step)


def _dnc_core(cfg: TrackerConfig) -> MemoryCore:
    dcfg = cfg.dnc

    def init_params(generator, input_size, device=None):
        return dnc_mod.init_dnc_params(dcfg, input_size, generator, device)

    def init_state(params, batch):
        # the DNC's initial state is all zeros (dnc/dnc.py:129-134)
        return dnc_mod.init_dnc_state(dcfg, batch, device=params["out_w"].device)

    def unroll(params, inputs, state=None, remat=True, fused_bptt=None):
        # no fused kernel serves the DNC: fused_bptt is not read
        return dnc_mod.dnc_unroll(params, dcfg, inputs, state=state, remat=remat,
                                  remat_chunk=dcfg.remat_chunk)

    def step(params, x, state):
        return dnc_mod.dnc_step(params, dcfg, x, state)

    return MemoryCore(init_params=init_params, init_state=init_state, unroll=unroll, step=step)
