"""Whole-sequence NTM BPTT: the training path's T cell steps with a fused
forward and a hand-derived backward in CUDA.

Counterpart of ntm_tracker_tpu/ops/pallas/scan_bptt.py:ntm_scan_fused_bptt.
`ntm_scan_fused_bptt` takes, for CUDA tensors:
  * with gradients recorded: the autograd Function below, which launches
    csrc/scan_bptt.cu's forward (residual streams of each step's input
    state), and in its backward the reverse-time kernel and one reduction
    launch per weight matrix (no float atomics: fixed summation order);
  * without (torch.no_grad(), or no input that requires grad): B1, the
    residual-free ntm_scan_fused kernel, as scan_bptt.py:866-875 does.
CPU tensors run `ntm_scan_fused_bptt_reference`, autograd through the
plain loop. Other devices raise. f32 only.

The init_* parameters reach their gradients through the state argument:
build it with init_ntm_state under the same autograd graph.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Any, Dict, Tuple

import torch

from ntm_tracker_tpu_torch.config import NTMConfig
from ntm_tracker_tpu_torch.models.ntm_cell import head_param_sizes
from ntm_tracker_tpu_torch.ops.kernels.scan_cell import (
    MAX_SMEM_BYTES,
    _check,
    _stream,
    check_inputs,
    flatten_scan_args,
    flatten_state,
    ntm_scan_fused,
    ntm_scan_fused_reference,
    unflatten_scan_args,
    unflatten_state,
)

# the reduction kernel's row block and output tile (csrc/scan_bptt.cu RM, RT)
REDUCE_ROWS = 16
REDUCE_TILE = 64
# blocks the reduction aims to launch: 8 resident per SM on the H100's 132
REDUCE_TARGET_BLOCKS = 8 * 132


# The plain version: autograd through the plain loop over ntm_cell_step
# (torch's pow also gives 0 for d/dgamma where w_conv == 0), with
# use_pallas stripped as JAX's is (ntm_tracker_tpu/ops/pallas/scan_bptt.py:914-917).
ntm_scan_fused_bptt_reference = ntm_scan_fused_reference


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ntm_tracker_tpu_torch._build import load_library

    lib = load_library("scan_bptt")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ntm_bptt_smem_bytes.argtypes = [i32] * 11
    lib.ntm_bptt_smem_bytes.restype = i32
    lib.ntm_bptt_fwd_launch.argtypes = [ptr] * 23 + [i32] * 15 + [ptr]
    lib.ntm_bptt_fwd_launch.restype = i32
    lib.ntm_bptt_bwd_launch.argtypes = [ptr] * 28 + [i32] * 15 + [ptr]
    lib.ntm_bptt_bwd_launch.restype = i32
    lib.ntm_grad_reduce_launch.argtypes = [ptr, i32, ptr, i32, i32, i32, i32, i32, i32, ptr, ptr, i32, ptr]
    lib.ntm_grad_reduce_launch.restype = i32
    return lib


def _ptr_array(tensors):
    arr = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    return ctypes.cast(arr, ctypes.c_void_p)


def _dims(cfg: NTMConfig, IN: int) -> Tuple[int, ...]:
    return (IN, cfg.mem_size, cfg.mem_dim, cfg.num_heads, cfg.read_head_size,
            cfg.write_head_size, cfg.shift_space, cfg.controller_hidden_size,
            cfg.controller_num_layers, cfg.output_dim)


def _check_smem(lib, cfg: NTMConfig, IN: int, backward: bool) -> None:
    smem = lib.ntm_bptt_smem_bytes(*_dims(cfg, IN), int(backward))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"config needs {smem} B of shared memory per block, above {MAX_SMEM_BYTES}")


def bptt_forward(params, cfg: NTMConfig, tokens: torch.Tensor, state):
    """Launch the forward kernel that streams residuals.

    Returns (logits [B,T,O], final state, residuals (M [B,T,N,D],
    w [B,T,H,N], read [B,T,R*D], c [B,T,L,Hc], h [B,T,L,Hc]): each step's
    input state). One launch, counted in `bptt_forward.launches`."""
    check_inputs(params, cfg, tokens, state)
    B, T, IN = tokens.shape
    device = tokens.device
    N, D, H = cfg.mem_size, cfg.mem_dim, cfg.num_heads
    R, Hc, L, O = cfg.read_head_size, cfg.controller_hidden_size, cfg.controller_num_layers, cfg.output_dim
    lib = _library()
    _check_smem(lib, cfg, IN, backward=False)
    logits = torch.empty(B, T, O, device=device)
    M = torch.empty(B, N, D, device=device)
    w = torch.empty(B, H, N, device=device)
    read = torch.empty(B, R, D, device=device)
    c_out = torch.empty(L, B, Hc, device=device)
    h_out = torch.empty(L, B, Hc, device=device)
    res = (torch.empty(B, T, N, D, device=device), torch.empty(B, T, H, N, device=device),
           torch.empty(B, T, R * D, device=device), torch.empty(B, T, L, Hc, device=device),
           torch.empty(B, T, L, Hc, device=device))
    ctrl = params["controller"]
    index, stream = _stream(device)
    err = lib.ntm_bptt_fwd_launch(
        tokens.data_ptr(), _ptr_array([layer["kernel"] for layer in ctrl]),
        _ptr_array([layer["bias"] for layer in ctrl]),
        params["heads_w"].data_ptr(), params["heads_b"].data_ptr(),
        params["out_w"].data_ptr(), params["out_b"].data_ptr(),
        state["M"].data_ptr(), state["w"].data_ptr(), state["read"].data_ptr(),
        _ptr_array([c for c, _ in state["controller_state"]]),
        _ptr_array([h for _, h in state["controller_state"]]),
        logits.data_ptr(), M.data_ptr(), w.data_ptr(), read.data_ptr(),
        c_out.data_ptr(), h_out.data_ptr(), *[r.data_ptr() for r in res],
        B, T, *_dims(cfg, IN), int(cfg.write_first), int(cfg.slotwise_cosine), index, stream,
    )
    if err != 0:
        raise RuntimeError(f"scan_bptt forward kernel launch failed: CUDA error {err}")
    bptt_forward.launches += 1
    final = {"M": M, "w": w, "read": read, "controller_state": [(c_out[l], h_out[l]) for l in range(L)]}
    return logits, final, res


bptt_forward.launches = 0


def bptt_backward(params, cfg: NTMConfig, tokens: torch.Tensor, res, dlogits: torch.Tensor, dfinal):
    """Launch the reverse-time kernel.

    dfinal holds the cotangents of the final state (the state dict's
    layout). Returns (dtokens [B,T,IN], dstate0 (state layout), operands)
    where operands = (li [L, B*T, KINmax], dgates [L, B*T, 4Hc],
    ctrl [B*T, Hc], dctl [B*T, P]) feed the weight-gradient reduction.
    One launch, counted in `bptt_backward.launches`."""
    B, T, IN = tokens.shape
    device = tokens.device
    N, D, H = cfg.mem_size, cfg.mem_dim, cfg.num_heads
    R, Hc, L, O = cfg.read_head_size, cfg.controller_hidden_size, cfg.controller_num_layers, cfg.output_dim
    P = sum(head_param_sizes(cfg).values())
    KM = max(IN + R * D + Hc, 2 * Hc)
    _check("dlogits", dlogits, (B, T, O), device)
    _check("dM", dfinal["M"], (B, N, D), device)
    _check("dw", dfinal["w"], (B, H, N), device)
    _check("dread", dfinal["read"], (B, R, D), device)
    dc_T = torch.stack([c for c, _ in dfinal["controller_state"]])
    dh_T = torch.stack([h for _, h in dfinal["controller_state"]])
    _check("dc", dc_T, (L, B, Hc), device)
    _check("dh", dh_T, (L, B, Hc), device)
    lib = _library()
    _check_smem(lib, cfg, IN, backward=True)
    dM0 = torch.empty(B, N, D, device=device)
    dw0 = torch.empty(B, H, N, device=device)
    dread0 = torch.empty(B, R, D, device=device)
    dc0 = torch.empty(L, B, Hc, device=device)
    dh0 = torch.empty(L, B, Hc, device=device)
    dtokens = torch.empty(B, T, IN, device=device)
    li = torch.empty(L, B * T, KM, device=device)
    dgates = torch.empty(L, B * T, 4 * Hc, device=device)
    ctrl_out = torch.empty(B * T, Hc, device=device)
    dctl = torch.empty(B * T, P, device=device)
    ctrl = params["controller"]
    index, stream = _stream(device)
    err = lib.ntm_bptt_bwd_launch(
        tokens.data_ptr(), _ptr_array([layer["kernel"] for layer in ctrl]),
        _ptr_array([layer["bias"] for layer in ctrl]),
        params["heads_w"].data_ptr(), params["heads_b"].data_ptr(),
        params["out_w"].data_ptr(), params["out_b"].data_ptr(),
        *[r.data_ptr() for r in res], dlogits.data_ptr(),
        dfinal["M"].data_ptr(), dfinal["w"].data_ptr(), dfinal["read"].data_ptr(),
        dc_T.data_ptr(), dh_T.data_ptr(),
        dM0.data_ptr(), dw0.data_ptr(), dread0.data_ptr(), dc0.data_ptr(), dh0.data_ptr(),
        dtokens.data_ptr(), li.data_ptr(), dgates.data_ptr(), ctrl_out.data_ptr(), dctl.data_ptr(),
        B, T, *_dims(cfg, IN), int(cfg.write_first), int(cfg.slotwise_cosine), index, stream,
    )
    if err != 0:
        raise RuntimeError(f"scan_bptt backward kernel launch failed: CUDA error {err}")
    bptt_backward.launches += 1
    dstate0 = {"M": dM0, "w": dw0, "read": dread0,
               "controller_state": [(dc0[l], dh0[l]) for l in range(L)]}
    return dtokens, dstate0, (li, dgates, ctrl_out, dctl)


bptt_backward.launches = 0


def reduce_chunks(M: int, K: int, J: int) -> Tuple[int, int]:
    """(chunks, rows per chunk) the reduction splits its M rows into: a
    function of the shape only, so the summation order, and the result's
    bits, are the same on every run."""
    tiles = math.ceil(J / REDUCE_TILE) * math.ceil((K + 1) / REDUCE_TILE)
    chunks = max(1, min(math.ceil(M / REDUCE_ROWS), math.ceil(REDUCE_TARGET_BLOCKS / tiles)))
    rows = math.ceil(math.ceil(M / chunks) / REDUCE_ROWS) * REDUCE_ROWS
    return math.ceil(M / rows), rows


def grad_reduce(A: torch.Tensor, G: torch.Tensor, K: int) -> torch.Tensor:
    """[A[:, :K]^T G ; sum_m G[m]] over the M rows: a weight gradient
    [K, J] with its bias gradient as row K. A [M, >=K] and G [M, J] are
    contiguous float32 on cuda. One launch, counted in
    `grad_reduce.launches`."""
    M, J = G.shape
    device = G.device
    if A.dim() != 2 or A.shape[0] != M or A.shape[1] < K:
        raise ValueError(f"A has shape {tuple(A.shape)}, expected [{M}, >={K}]")
    _check("A", A, tuple(A.shape), device)
    _check("G", G, (M, J), device)
    chunks, rows = reduce_chunks(M, K, J)
    part = torch.empty(chunks, K + 1, J, device=device)
    out = torch.empty(K + 1, J, device=device)
    index, stream = _stream(device)
    err = _library().ntm_grad_reduce_launch(
        A.data_ptr(), A.shape[1], G.data_ptr(), J, M, K, J, chunks, rows,
        part.data_ptr(), out.data_ptr(), index, stream,
    )
    if err != 0:
        raise RuntimeError(f"scan_bptt reduction kernel launch failed: CUDA error {err}")
    grad_reduce.launches += 1
    return out


grad_reduce.launches = 0


def grad_reduce_reference(A: torch.Tensor, G: torch.Tensor, K: int) -> torch.Tensor:
    """The plain version of grad_reduce."""
    return torch.cat([A[:, :K].T @ G, G.sum(0, keepdim=True)], dim=0)


class _ScanBPTT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, L, tokens, *flat):
        params, state = unflatten_scan_args(flat, L)
        logits, final, res = bptt_forward(params, cfg, tokens, state)
        ctx.cfg, ctx.L, ctx.res = cfg, L, res
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
            raise RuntimeError("the fused BPTT backward runs once per forward (no retain_graph)")
        dtokens, dstate0, (li, dgates, ctrl, dctl) = bptt_backward(
            params, cfg, tokens, res, dlogits.contiguous(),
            unflatten_state([d.contiguous() for d in dfinal], L),
        )
        del res
        B, T, IN = tokens.shape
        R, D, Hc = cfg.read_head_size, cfg.mem_dim, cfg.controller_hidden_size
        dkernels, dbiases = [], []
        for l in range(L):
            K = (IN + R * D if l == 0 else Hc) + Hc
            g = grad_reduce(li[l], dgates[l], K)
            dkernels.append(g[:K])
            dbiases.append(g[K])
        gh = grad_reduce(ctrl, dctl, Hc)
        go = grad_reduce(ctrl, dlogits.reshape(B * T, cfg.output_dim).contiguous(), Hc)
        grads = [*flatten_state(dstate0), *dkernels, *dbiases, gh[:Hc], gh[Hc], go[:Hc], go[Hc]]
        return (None, None, dtokens, *grads)


def ntm_scan_fused_bptt(
    params: Dict[str, Any],
    cfg: NTMConfig,
    tokens: torch.Tensor,
    state: Dict[str, Any],
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """T NTM steps, differentiable wrt params, tokens and the initial state.

    Args:
      tokens: [B, T, IN] float32; params and state on the tokens' device,
        float32 and contiguous.
    Returns:
      (logits [B, T, output_dim], final state). See the module docstring
      for the route each device and grad mode takes.
    """
    B, T, _ = tokens.shape
    if T == 0:
        return tokens.new_zeros(B, 0, cfg.output_dim), state
    device = tokens.device
    if device.type == "cpu":
        return ntm_scan_fused_bptt_reference(params, cfg, tokens, state)
    if device.type != "cuda":
        raise ValueError(f"ntm_scan_fused_bptt runs on cuda or cpu tensors, got {device}")
    flat = flatten_scan_args(params, state)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in [tokens, *flat])):
        return ntm_scan_fused(params, cfg, tokens, state)
    L = cfg.controller_num_layers
    logits, *final = _ScanBPTT.apply(cfg, L, tokens, *flat)
    return logits, unflatten_state(final, L)
