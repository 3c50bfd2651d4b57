"""Lane-packed whole-sequence NTM kernels: the cell loop and its BPTT with
each row's memory packed d-major as [D*N] (lane l = d*N + n), run over a
tile of batch rows per CUDA block.

Counterpart of ntm_tracker_tpu/ops/pallas/scan_packed.py:ntm_scan_packed
and ntm_scan_packed_bptt. The JAX kernels hold the whole batch in one
tile; csrc/scan_packed.cu reads that for what it does and gives each
block `rows_per_block` batch rows, so every weight element read from L2
serves the whole tile. Routes, for CUDA tensors:
  * `ntm_scan_packed`: the packed forward (one launch, counted);
  * `ntm_scan_packed_bptt` with gradients recorded: the autograd Function
    below, which launches the packed forward with residual streams, and
    in its backward the packed reverse-time kernel and B2's deterministic
    weight-gradient reduction (ops/kernels/scan_bptt.weight_grads);
    without gradients it runs `ntm_scan_packed`.
CPU tensors run `ntm_scan_packed_reference`, plain PyTorch on the packed
layout; other devices raise. f32 only. Both functions take and return the
state in the cell layout (M [B, N, D]). The init_* parameters reach their
gradients through the state argument (build it with init_ntm_state under
the same autograd graph).

No path of the port routes here: as in the JAX package, these kernels are
a measured alternative to the row kernels (scan_cell, scan_bptt).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch

from ntm_tracker_tpu_torch.config import NTMConfig
from ntm_tracker_tpu_torch.models.ntm_cell import HEAD_PARAM_ORDER, head_param_sizes
from ntm_tracker_tpu_torch.ops.kernels.scan_bptt import _dims, _ptr_array, weight_grads
from ntm_tracker_tpu_torch.ops.kernels.scan_cell import (
    MAX_SMEM_BYTES,
    _check,
    _stream,
    check_inputs,
    flatten_scan_args,
    flatten_state,
    unflatten_scan_args,
    unflatten_state,
)
from ntm_tracker_tpu_torch.ops.lstm import multi_lstm_step
from ntm_tracker_tpu_torch.ops.memory import circular_convolution_shifts

# the tile sizes csrc/scan_packed.cu instantiates, for the forward kernels
# and for the backward: 1 (one row per block, the control) up to the
# largest that fits the flagship config in one block's shared memory
FORWARD_ROWS = (1, 4, 8)
BACKWARD_ROWS = (1, 2, 4)


def pack_memory(M: torch.Tensor) -> torch.Tensor:
    """[B, N, D] -> [B, D*N], lane d*N + n (scan_packed.py:609-610)."""
    B, N, D = M.shape
    return M.transpose(1, 2).reshape(B, D * N)


def unpack_memory(Mp: torch.Tensor, N: int) -> torch.Tensor:
    """[B, D*N] -> [B, N, D]."""
    B = Mp.shape[0]
    return Mp.reshape(B, -1, N).transpose(1, 2).contiguous()


def _packed_step(params, cfg: NTMConfig, x, Mp, w, read, ctrl_state):
    """One cell step on the packed memory Mp [B, D*N]: (logit, Mp, w,
    read [B, R*D], controller state)."""
    B = x.shape[0]
    N, D, H = cfg.mem_size, cfg.mem_dim, cfg.num_heads
    R, W, S = cfg.read_head_size, cfg.write_head_size, cfg.shift_space
    ctrl_out, ctrl_state = multi_lstm_step(params["controller"], torch.cat([x, read], dim=1), ctrl_state)
    controls = ctrl_out @ params["heads_w"] + params["heads_b"]
    sizes = head_param_sizes(cfg)
    k, beta, g, sw, gamma, erase, add = torch.split(controls, [sizes[n] for n in HEAD_PARAM_ORDER], dim=1)
    logit = ctrl_out @ params["out_w"] + params["out_b"]

    M3 = Mp.view(B, D, N)
    if cfg.slotwise_cosine:
        # the slot-vector cosine: a norm over d for each n
        m_inv = torch.rsqrt(torch.clamp_min((M3 * M3).sum(1, keepdim=True), 1e-12))   # [B, 1, N]
    else:
        # the reference's across-slot quirk: a norm over n for each d
        m_inv = torch.rsqrt(torch.clamp_min((M3 * M3).sum(2, keepdim=True), 1e-12))   # [B, D, 1]
    Mtn = M3 * m_inv
    k = torch.tanh(k.view(B, H, D))
    k_inv = torch.rsqrt(torch.clamp_min((k * k).sum(2, keepdim=True), 1e-12))          # [B, H, 1]
    sim = torch.einsum("bhd,bdn->bhn", k, Mtn) * k_inv                                 # sums over d
    w_c = torch.softmax(sim * torch.nn.functional.softplus(beta)[:, :, None], dim=-1)
    g = torch.sigmoid(g)[:, :, None]
    w_g = w_c * g + w * (1.0 - g)
    sw = torch.softmax(sw.view(B, H, S), dim=-1)
    w_conv = torch.zeros_like(w_g)
    for j, s in enumerate(circular_convolution_shifts(S)):
        # pltpu.roll(w_g, (-s) % N) (scan_packed.py:180)
        w_conv = w_conv + sw[:, :, j:j + 1] * torch.roll(w_g, -s, dims=-1)
    powed = torch.pow(w_conv, (torch.nn.functional.softplus(gamma) + 1.0)[:, :, None])
    w = powed / (powed.sum(-1, keepdim=True) + 1e-3)

    ww = w[:, R:, None, :]                                       # [B, W, 1, N]
    er = torch.prod(1.0 - ww * torch.sigmoid(erase).view(B, W, D, 1), dim=1)   # [B, D, N]
    ad = torch.sum(ww * torch.tanh(add).view(B, W, D, 1), dim=1)
    M3_new = M3 * er + ad
    src = M3_new if cfg.write_first else M3
    read = torch.einsum("brn,bdn->brd", w[:, :R], src).reshape(B, R * D)     # sums over n
    return logit, M3_new.reshape(B, D * N), w, read, ctrl_state


def ntm_scan_packed_reference(
    params: Dict[str, Any],
    cfg: NTMConfig,
    tokens: torch.Tensor,
    state: Dict[str, Any],
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The plain version: T steps of the packed math in plain PyTorch
    (per-d sums over n and per-n sums over d are reductions over
    Mp.view(B, D, N); broadcasts are views). Its gradient is autograd."""
    B, T, _ = tokens.shape
    N, R, D = cfg.mem_size, cfg.read_head_size, cfg.mem_dim
    Mp, w, read, ctrl = pack_memory(state["M"]), state["w"], state["read"].reshape(B, R * D), state["controller_state"]
    logits = [tokens.new_zeros(B, 0, cfg.output_dim)]
    for t in range(T):
        logit, Mp, w, read, ctrl = _packed_step(params, cfg, tokens[:, t], Mp, w, read, ctrl)
        logits.append(logit[:, None])
    final = {"M": unpack_memory(Mp, N), "w": w, "read": read.reshape(B, R, D), "controller_state": ctrl}
    return torch.cat(logits, dim=1), final


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ntm_tracker_tpu_torch._build import load_library

    lib = load_library("scan_packed")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ntm_packed_smem_bytes.argtypes = [i32] * 12
    lib.ntm_packed_smem_bytes.restype = i32
    lib.ntm_packed_fwd_launch.argtypes = [ptr] * 23 + [i32] * 16 + [ptr]
    lib.ntm_packed_fwd_launch.restype = i32
    lib.ntm_packed_bwd_launch.argtypes = [ptr] * 28 + [i32] * 16 + [ptr]
    lib.ntm_packed_bwd_launch.restype = i32
    return lib


def tile_rows(smem_bytes, rows_per_block: Optional[int], backward: bool) -> int:
    """The tile a launch uses. smem_bytes(rows) is the block's shared
    memory at that tile. An explicit rows_per_block must be instantiated
    and fit (else this raises); None takes the largest instantiated tile
    that fits."""
    sizes = BACKWARD_ROWS if backward else FORWARD_ROWS
    kind = "backward" if backward else "forward"
    if rows_per_block is not None and rows_per_block not in sizes:
        raise ValueError(f"the packed {kind} kernel takes rows_per_block in {sizes}, got {rows_per_block}")
    for rows in sorted(sizes, reverse=True) if rows_per_block is None else [rows_per_block]:
        smem = smem_bytes(rows)
        if smem <= MAX_SMEM_BYTES:
            return rows
    raise ValueError(f"config needs {smem} B of shared memory per block at {rows} rows per block in the "
                     f"packed {kind} kernel, above {MAX_SMEM_BYTES}")


def smem_bytes(cfg: NTMConfig, IN: int, backward: bool, rows: int) -> int:
    """The dynamic shared memory one block of the kernel takes at `rows`
    rows per block (the kernel's own ntm_packed_smem_bytes)."""
    return _library().ntm_packed_smem_bytes(*_dims(cfg, IN), int(backward), rows)


def tile_for(cfg: NTMConfig, IN: int, rows_per_block: Optional[int], backward: bool) -> int:
    """The tile a launch of the forward or backward kernel uses for this
    config and token width (tile_rows against the kernel's own sizes)."""
    return tile_rows(lambda rows: smem_bytes(cfg, IN, backward, rows), rows_per_block, backward)


def _forward(params, cfg: NTMConfig, tokens: torch.Tensor, state, residuals: bool, rows_per_block):
    check_inputs(params, cfg, tokens, state)
    B, T, IN = tokens.shape
    device = tokens.device
    N, D, H = cfg.mem_size, cfg.mem_dim, cfg.num_heads
    R, Hc, L, O = cfg.read_head_size, cfg.controller_hidden_size, cfg.controller_num_layers, cfg.output_dim
    rows = tile_for(cfg, IN, rows_per_block, backward=False)
    lib = _library()
    logits = torch.empty(B, T, O, device=device)
    M = torch.empty(B, N, D, device=device)
    w = torch.empty(B, H, N, device=device)
    read = torch.empty(B, R, D, device=device)
    c_out = torch.empty(L, B, Hc, device=device)
    h_out = torch.empty(L, B, Hc, device=device)
    res = None
    if residuals:
        res = (torch.empty(B, T, D * N, device=device), torch.empty(B, T, H, N, device=device),
               torch.empty(B, T, R * D, device=device), torch.empty(B, T, L, Hc, device=device),
               torch.empty(B, T, L, Hc, device=device))
    ctrl = params["controller"]
    index, stream = _stream(device)
    err = lib.ntm_packed_fwd_launch(
        tokens.data_ptr(), _ptr_array([layer["kernel"] for layer in ctrl]),
        _ptr_array([layer["bias"] for layer in ctrl]),
        params["heads_w"].data_ptr(), params["heads_b"].data_ptr(),
        params["out_w"].data_ptr(), params["out_b"].data_ptr(),
        state["M"].data_ptr(), state["w"].data_ptr(), state["read"].data_ptr(),
        _ptr_array([c for c, _ in state["controller_state"]]),
        _ptr_array([h for _, h in state["controller_state"]]),
        logits.data_ptr(), M.data_ptr(), w.data_ptr(), read.data_ptr(),
        c_out.data_ptr(), h_out.data_ptr(), *([r.data_ptr() for r in res] if res else [None] * 5),
        B, T, *_dims(cfg, IN), int(cfg.write_first), int(cfg.slotwise_cosine), rows, index, stream,
    )
    if err != 0:
        raise RuntimeError(f"scan_packed forward kernel launch failed: CUDA error {err}")
    final = {"M": M, "w": w, "read": read, "controller_state": [(c_out[l], h_out[l]) for l in range(L)]}
    return logits, final, res


def packed_forward(params, cfg: NTMConfig, tokens: torch.Tensor, state, rows_per_block: Optional[int] = None):
    """Launch the packed forward (no residuals): (logits [B,T,O], final
    state). One launch, counted in `packed_forward.launches`."""
    logits, final, _ = _forward(params, cfg, tokens, state, False, rows_per_block)
    packed_forward.launches += 1
    return logits, final


packed_forward.launches = 0


def packed_forward_residuals(params, cfg: NTMConfig, tokens: torch.Tensor, state,
                             rows_per_block: Optional[int] = None):
    """Launch the packed forward that streams residuals: (logits, final
    state, residuals (Mp [B,T,D*N], w [B,T,H,N], read [B,T,R*D],
    c [B,T,L,Hc], h [B,T,L,Hc]): each step's input state, memory packed).
    One launch, counted in `packed_forward_residuals.launches`."""
    out = _forward(params, cfg, tokens, state, True, rows_per_block)
    packed_forward_residuals.launches += 1
    return out


packed_forward_residuals.launches = 0


def packed_backward(params, cfg: NTMConfig, tokens: torch.Tensor, res, dlogits: torch.Tensor, dfinal,
                    rows_per_block: Optional[int] = None):
    """Launch the packed reverse-time kernel.

    dfinal holds the cotangents of the final state (the state dict's
    layout). Returns (dtokens [B,T,IN], dstate0 (state layout), operands)
    where operands = (li [L, B*T, KINmax], dgates [L, B*T, 4Hc],
    ctrl [B*T, Hc], dctl [B*T, P+O]: the head-control cotangents, then the
    logits'), bptt_backward's layout, feed scan_bptt.weight_grads. One
    launch, counted in `packed_backward.launches`."""
    B, T, IN = tokens.shape
    device = tokens.device
    N, D, H = cfg.mem_size, cfg.mem_dim, cfg.num_heads
    R, Hc, L, O = cfg.read_head_size, cfg.controller_hidden_size, cfg.controller_num_layers, cfg.output_dim
    P = sum(head_param_sizes(cfg).values())
    KM = max(IN + R * D + Hc, 2 * Hc)
    rows = tile_for(cfg, IN, rows_per_block, backward=True)
    _check("dlogits", dlogits, (B, T, O), device)
    _check("dM", dfinal["M"], (B, N, D), device)
    _check("dw", dfinal["w"], (B, H, N), device)
    _check("dread", dfinal["read"], (B, R, D), device)
    for name, t, shape in zip(("res_M", "res_w", "res_read", "res_c", "res_h"), res,
                              ((B, T, D * N), (B, T, H, N), (B, T, R * D), (B, T, L, Hc), (B, T, L, Hc))):
        _check(name, t, shape, device)
    dc_T = torch.stack([c for c, _ in dfinal["controller_state"]])
    dh_T = torch.stack([h for _, h in dfinal["controller_state"]])
    _check("dc", dc_T, (L, B, Hc), device)
    _check("dh", dh_T, (L, B, Hc), device)
    lib = _library()
    dM0 = torch.empty(B, N, D, device=device)
    dw0 = torch.empty(B, H, N, device=device)
    dread0 = torch.empty(B, R, D, device=device)
    dc0 = torch.empty(L, B, Hc, device=device)
    dh0 = torch.empty(L, B, Hc, device=device)
    dtokens = torch.empty(B, T, IN, device=device)
    li = torch.empty(L, B * T, KM, device=device)
    dgates = torch.empty(L, B * T, 4 * Hc, device=device)
    ctrl_out = torch.empty(B * T, Hc, device=device)
    dctl = torch.empty(B * T, P + O, device=device)
    ctrl = params["controller"]
    index, stream = _stream(device)
    err = lib.ntm_packed_bwd_launch(
        tokens.data_ptr(), _ptr_array([layer["kernel"] for layer in ctrl]),
        _ptr_array([layer["bias"] for layer in ctrl]),
        params["heads_w"].data_ptr(), params["heads_b"].data_ptr(),
        params["out_w"].data_ptr(), params["out_b"].data_ptr(),
        *[r.data_ptr() for r in res], dlogits.data_ptr(),
        dfinal["M"].data_ptr(), dfinal["w"].data_ptr(), dfinal["read"].data_ptr(),
        dc_T.data_ptr(), dh_T.data_ptr(),
        dM0.data_ptr(), dw0.data_ptr(), dread0.data_ptr(), dc0.data_ptr(), dh0.data_ptr(),
        dtokens.data_ptr(), li.data_ptr(), dgates.data_ptr(), ctrl_out.data_ptr(), dctl.data_ptr(),
        B, T, *_dims(cfg, IN), int(cfg.write_first), int(cfg.slotwise_cosine), rows, index, stream,
    )
    if err != 0:
        raise RuntimeError(f"scan_packed backward kernel launch failed: CUDA error {err}")
    packed_backward.launches += 1
    dstate0 = {"M": dM0, "w": dw0, "read": dread0,
               "controller_state": [(dc0[l], dh0[l]) for l in range(L)]}
    return dtokens, dstate0, (li, dgates, ctrl_out, dctl)


packed_backward.launches = 0


class _PackedBPTT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, L, rows_fwd, rows_bwd, tokens, *flat):
        params, state = unflatten_scan_args(flat, L)
        logits, final, res = packed_forward_residuals(params, cfg, tokens, state, rows_fwd)
        ctx.cfg, ctx.L, ctx.rows_bwd, ctx.res = cfg, L, rows_bwd, res
        ctx.save_for_backward(tokens, *flat)
        # distinct tensors, so that no output is a view of another
        return (logits, *[t.clone() for t in flatten_state(final)])

    @staticmethod
    def backward(ctx, dlogits, *dfinal):
        cfg, L = ctx.cfg, ctx.L
        tokens, *flat = ctx.saved_tensors
        params, _ = unflatten_scan_args(flat, L)
        # the residuals are freed as soon as the backward kernel has read them
        res, ctx.res = ctx.res, None
        if res is None:
            raise RuntimeError("the packed BPTT backward runs once per forward (no retain_graph)")
        dlogits = dlogits.contiguous()
        dtokens, dstate0, operands = packed_backward(
            params, cfg, tokens, res, dlogits, unflatten_state([d.contiguous() for d in dfinal], L), ctx.rows_bwd,
        )
        del res
        grads = [*flatten_state(dstate0), *weight_grads(cfg, tokens.shape[2], operands)]
        return (None, None, None, None, dtokens, *grads)


def _f32_only(tokens: torch.Tensor) -> None:
    if tokens.dtype != torch.float32:
        raise ValueError(f"the packed kernels take float32 tensors, got {tokens.dtype}")


def ntm_scan_packed(
    params: Dict[str, Any],
    cfg: NTMConfig,
    tokens: torch.Tensor,
    state: Dict[str, Any],
    rows_per_block: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """T NTM steps with the packed forward (f32, no gradients).

    Args:
      tokens: [B, T, IN] float32; params and state (cell layout) on the
        tokens' device, float32 and contiguous.
      rows_per_block: the kernel's tile (FORWARD_ROWS); None = the largest
        that fits the config's shared memory.
    Returns:
      (logits [B, T, output_dim], final state). CPU tensors run the plain
      version; CUDA tensors launch the kernel (packed_forward) or raise.
    """
    _f32_only(tokens)
    if cfg.use_pallas:
        cfg = dataclasses.replace(cfg, use_pallas=False)
    B, T, _ = tokens.shape
    if T == 0:
        return tokens.new_zeros(B, 0, cfg.output_dim), state
    device = tokens.device
    if device.type == "cpu":
        return ntm_scan_packed_reference(params, cfg, tokens, state)
    if device.type != "cuda":
        raise ValueError(f"ntm_scan_packed runs on cuda or cpu tensors, got {device}")
    return packed_forward(params, cfg, tokens, state, rows_per_block)


def ntm_scan_packed_bptt(
    params: Dict[str, Any],
    cfg: NTMConfig,
    tokens: torch.Tensor,
    state: Dict[str, Any],
    rows_per_block: Optional[int] = None,
    backward_rows_per_block: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """T NTM steps, differentiable wrt params, tokens and the initial state.

    Same contract as scan_bptt.ntm_scan_fused_bptt (d/dgamma of pow at
    w_conv == 0 is 0). rows_per_block / backward_rows_per_block pick the
    forward's and the backward's tiles (None = the largest that fits). See the
    module docstring for the route each device and grad mode takes.
    """
    _f32_only(tokens)
    if cfg.use_pallas:
        cfg = dataclasses.replace(cfg, use_pallas=False)  # as scan_packed.py:916-919
    B, T, _ = tokens.shape
    if T == 0:
        return tokens.new_zeros(B, 0, cfg.output_dim), state
    device = tokens.device
    if device.type == "cpu":
        return ntm_scan_packed_reference(params, cfg, tokens, state)
    if device.type != "cuda":
        raise ValueError(f"ntm_scan_packed_bptt runs on cuda or cpu tensors, got {device}")
    flat = flatten_scan_args(params, state)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in [tokens, *flat])):
        return packed_forward(params, cfg, tokens, state, rows_per_block)
    L = cfg.controller_num_layers
    logits, *final = _PackedBPTT.apply(cfg, L, rows_per_block, backward_rows_per_block, tokens, *flat)
    return logits, unflatten_state(final, L)
