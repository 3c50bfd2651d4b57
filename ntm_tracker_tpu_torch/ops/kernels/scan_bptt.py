"""Whole-sequence NTM BPTT: the training path's T cell steps with a fused
forward and a hand-derived backward in CUDA.

Counterpart of ntm_tracker_tpu/ops/pallas/scan_bptt.py:ntm_scan_fused_bptt.
`ntm_scan_fused_bptt` takes, for CUDA tensors:
  * with gradients recorded: the autograd Function below. Its forward
    launches csrc/scan_bptt.cu's token projection (the layer-0 product of
    every step's token, X W0[:IN] + b0, at once) and the forward over a
    tile of 1, 2 or 4 batch rows per block, which takes layer 0's token
    part from the projection and streams residuals (each step's input
    state). Its backward hands the same projection to the reverse-time
    kernel over a tile of 1 or 2 batch rows per block, then launches one
    reduction per weight matrix (no float atomics: fixed summation
    order). The backward computes the tokens' gradient only when the
    tokens require one (the training path's cached features do not);
  * without (torch.no_grad(), or no input that requires grad): B1,
    ntm_scan_fused, as scan_bptt.py:866-875 does (at the train shape its
    tile route: this module's projection and forward without residuals).
CPU tensors run `ntm_scan_fused_bptt_reference`, autograd through the
plain loop. Other devices raise. f32 only (B1's tile route alone takes
bf16, through `_forward_launch`).

The init_* parameters reach their gradients through the state argument:
build it with init_ntm_state under the same autograd graph.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ntm_tracker_tpu_torch.config import NTMConfig
from ntm_tracker_tpu_torch.models.ntm_cell import head_param_sizes, ntm_cell_step
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
from ntm_tracker_tpu_torch.utils import profiling

# the GEMM kernels' slab of contraction rows (csrc/scan_bptt.cu GK) and
# their block tiles (rows, columns), with the blocks of each resident per
# SM: GemmWide 80 x 160 (10 x 10 per thread) and GemmSquare 128 x 128
# (8 x 8 per thread)
REDUCE_ROWS = 16
GEMM_TILES = {(80, 160): 3, (128, 128): 2}
# the reduction's row chunks hold at least this many rows, and fill the
# card's waves at least this well where the shape allows
MIN_CHUNK_ROWS = 256
MIN_WAVE_FILL = 0.99
# the H100 SXM's SM count, for shape-only planning off the card
H100_SMS = 132
# rows per block the forward and the backward kernels are instantiated at
FORWARD_ROWS = (1, 2, 4)
BACKWARD_ROWS = (1, 2)


# The plain version: autograd through the plain loop over ntm_cell_step
# (torch's pow also gives 0 for d/dgamma where w_conv == 0), with
# use_pallas stripped as JAX's is (ntm_tracker_tpu/ops/pallas/scan_bptt.py:914-917).
ntm_scan_fused_bptt_reference = ntm_scan_fused_reference


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ntm_tracker_tpu_torch._build import load_library

    lib = load_library("scan_bptt")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ntm_bptt_smem_bytes.argtypes = [i32] * 12
    lib.ntm_bptt_smem_bytes.restype = i32
    lib.ntm_bptt_fwd_launch.argtypes = [ptr] * 23 + [i32] * 17 + [ptr]
    lib.ntm_bptt_fwd_launch.restype = i32
    lib.ntm_bptt_bwd_launch.argtypes = [ptr] * 29 + [i32] * 17 + [ptr]
    lib.ntm_bptt_bwd_launch.restype = i32
    lib.ntm_token_proj_launch.argtypes = [ptr, i32, ptr, i32, ptr, i32, i32, i32, i32, ptr, i32, ptr]
    lib.ntm_token_proj_launch.restype = i32
    lib.ntm_grad_reduce_launch.argtypes = [ptr, i32, ptr, i32, i32, i32, i32, i32, i32, i32, ptr, ptr, i32, ptr]
    lib.ntm_grad_reduce_launch.restype = i32
    return lib


def _ptr_array(tensors):
    arr = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    return ctypes.cast(arr, ctypes.c_void_p)


def _dims(cfg: NTMConfig, IN: int) -> Tuple[int, ...]:
    return (IN, cfg.mem_size, cfg.mem_dim, cfg.num_heads, cfg.read_head_size,
            cfg.write_head_size, cfg.shift_space, cfg.controller_hidden_size,
            cfg.controller_num_layers, cfg.output_dim)


def smem_bytes(cfg: NTMConfig, IN: int, backward: bool, rows: int = 1) -> int:
    """The dynamic shared memory one block of the forward or the backward
    takes at `rows` rows per block (the kernel's own ntm_bptt_smem_bytes)."""
    return _library().ntm_bptt_smem_bytes(*_dims(cfg, IN), int(backward), rows)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's SM count (132 on an H100 SXM)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _explicit_rows(kind: str, sizes, rows_per_block: int, fits: Callable[[int], bool]) -> int:
    if rows_per_block not in sizes:
        raise ValueError(f"the {kind} kernel takes rows_per_block in {sizes}, got {rows_per_block}")
    if not fits(rows_per_block):
        raise ValueError(f"{rows_per_block} rows per block do not fit the {kind}'s shared memory "
                         f"({MAX_SMEM_BYTES} B) at this config")
    return rows_per_block


def forward_rows(B: int, rows_per_block: Optional[int], fits: Callable[[int], bool], sms: int) -> int:
    """The forward's tile: rows_per_block if given (it must be in
    FORWARD_ROWS and fit, else this raises); otherwise, of the tiles in
    FORWARD_ROWS that fit, the fewest rows whose ceil(B / rows) blocks
    fill the card's `sms` SMs no more than once (2 at B=256 on an H100,
    the fastest there: PERF.md), or the most rows where none does.
    Only B=256 was measured: whether 4 rows in one wave beat 2 rows in two
    waves above 2 * sms rows (B > 264 on an H100) is not known.
    fits(rows) says whether a block of that many rows fits in shared
    memory."""
    if rows_per_block is not None:
        return _explicit_rows("forward", FORWARD_ROWS, rows_per_block, fits)
    fitting = [r for r in FORWARD_ROWS if fits(r)]
    if not fitting:
        raise ValueError(f"one row per block does not fit the forward's shared memory ({MAX_SMEM_BYTES} B) "
                         f"at this config")
    one_wave = [r for r in fitting if math.ceil(B / r) <= sms]
    return one_wave[0] if one_wave else fitting[-1]


def backward_rows(B: int, rows_per_block: Optional[int], fits: Callable[[int], bool], sms: int) -> int:
    """The backward's tile: rows_per_block if given (it must be in
    BACKWARD_ROWS and fit, else this raises); otherwise 1 while one row
    per block fills no more than the card's `sms` SMs once (B <= sms), and
    2 above, or 1 where two rows do not fit. fits(rows) says whether a
    block of that many rows fits in shared memory."""
    if rows_per_block is not None:
        return _explicit_rows("backward", BACKWARD_ROWS, rows_per_block, fits)
    rows = 1 if B <= sms else 2
    if fits(rows):
        return rows
    if fits(1):
        return 1
    raise ValueError(f"one row per block does not fit the backward's shared memory ({MAX_SMEM_BYTES} B) at this config")


def forward_tile(cfg: NTMConfig, IN: int, B: int, device: torch.device, rows_per_block: Optional[int] = None) -> int:
    """forward_rows for this config on `device` (its SM count and the
    kernel's own shared-memory sizes)."""
    return forward_rows(B, rows_per_block, lambda r: smem_bytes(cfg, IN, False, r) <= MAX_SMEM_BYTES,
                        sm_count(device))


def backward_tile(cfg: NTMConfig, IN: int, B: int, device: torch.device, rows_per_block: Optional[int] = None) -> int:
    """backward_rows for this config on `device` (its SM count and the
    kernel's own shared-memory sizes)."""
    return backward_rows(B, rows_per_block, lambda r: smem_bytes(cfg, IN, True, r) <= MAX_SMEM_BYTES,
                         sm_count(device))


def bptt_forward(params, cfg: NTMConfig, tokens: torch.Tensor, state, proj: torch.Tensor,
                 rows_per_block: Optional[int] = None):
    """Launch the forward kernel that streams residuals.

    proj [B*T, 4Hc] is token_projection's output for these tokens and
    layer 0's weights: layer 0's token part of every step (the kernel
    reads no token). rows_per_block picks the tile (forward_rows).
    Returns (logits [B,T,O], final state, residuals (M [B,T,N,D],
    w [B,T,H,N], read [B,T,R*D], c [B,T,L,Hc], h [B,T,L,Hc]): each step's
    input state). One launch, counted in `launches.bptt_forward`; CPU
    tensors run bptt_forward_reference."""
    check_inputs(params, cfg, tokens, state)
    B, T, IN = tokens.shape
    device = tokens.device
    N, D, H = cfg.mem_size, cfg.mem_dim, cfg.num_heads
    R, Hc, L, O = cfg.read_head_size, cfg.controller_hidden_size, cfg.controller_num_layers, cfg.output_dim
    _check("proj", proj, (B * T, 4 * Hc), device)
    if device.type == "cpu":
        return bptt_forward_reference(params, cfg, tokens, state, proj)
    out = _forward_launch(params, cfg, tokens, state, proj, forward_tile(cfg, IN, B, device, rows_per_block))
    profiling.count("launches.bptt_forward")
    return out


def _forward_launch(params, cfg: NTMConfig, tokens: torch.Tensor, state, proj: torch.Tensor, rows: int,
                    residuals: bool = True, bf16: bool = False):
    """bptt_forward's launch at `rows` rows per block, inputs checked.
    residuals=False launches the same tile step without the residual
    streams (B1's tile route, scan_cell.run_route; the third result is then
    None), which alone takes bf16=True: the weights rounded to bf16 by the
    caller, proj the rounded operands' product without b0."""
    if bf16 and residuals:
        raise ValueError("the forward with residuals (the training path) is float32 only")
    B, T, IN = tokens.shape
    device = tokens.device
    N, D, H = cfg.mem_size, cfg.mem_dim, cfg.num_heads
    R, Hc, L, O = cfg.read_head_size, cfg.controller_hidden_size, cfg.controller_num_layers, cfg.output_dim
    logits = torch.empty(B, T, O, device=device)
    M = torch.empty(B, N, D, device=device)
    w = torch.empty(B, H, N, device=device)
    read = torch.empty(B, R, D, device=device)
    c_out = torch.empty(L, B, Hc, device=device)
    h_out = torch.empty(L, B, Hc, device=device)
    res = (torch.empty(B, T, N, D, device=device), torch.empty(B, T, H, N, device=device),
           torch.empty(B, T, R * D, device=device), torch.empty(B, T, L, Hc, device=device),
           torch.empty(B, T, L, Hc, device=device)) if residuals else None
    c0 = torch.stack([c for c, _ in state["controller_state"]])
    h0 = torch.stack([h for _, h in state["controller_state"]])
    ctrl = params["controller"]
    index, stream = _stream(device)
    err = _library().ntm_bptt_fwd_launch(
        proj.data_ptr(), _ptr_array([layer["kernel"] for layer in ctrl]),
        _ptr_array([layer["bias"] for layer in ctrl]),
        params["heads_w"].data_ptr(), params["heads_b"].data_ptr(),
        params["out_w"].data_ptr(), params["out_b"].data_ptr(),
        state["M"].data_ptr(), state["w"].data_ptr(), state["read"].data_ptr(), c0.data_ptr(), h0.data_ptr(),
        logits.data_ptr(), M.data_ptr(), w.data_ptr(), read.data_ptr(),
        c_out.data_ptr(), h_out.data_ptr(), *([r.data_ptr() for r in res] if residuals else [None] * 5),
        B, T, *_dims(cfg, IN), int(cfg.write_first), int(cfg.slotwise_cosine), int(bf16), rows, index, stream,
    )
    if err != 0:
        raise RuntimeError(f"scan_bptt forward kernel launch failed: CUDA error {err}")
    final = {"M": M, "w": w, "read": read, "controller_state": [(c_out[l], h_out[l]) for l in range(L)]}
    return logits, final, res


def bptt_forward_reference(params, cfg: NTMConfig, tokens: torch.Tensor, state, proj: torch.Tensor):
    """The plain version of bptt_forward: the plain loop over ntm_cell_step
    with layer 0's token product taken from proj (its kernel cut to the
    [read | h] rows, proj's step row as the bias), without gradients.
    Returns what bptt_forward returns, in its layout."""
    B, T, IN = tokens.shape
    L = cfg.controller_num_layers
    if cfg.use_pallas:
        cfg = dataclasses.replace(cfg, use_pallas=False)
    layer0 = params["controller"][0]
    proj = proj.reshape(B, T, -1)
    res, logits = [], []
    with torch.no_grad():
        for t in range(T):
            res.append((state["M"], state["w"], state["read"].reshape(B, -1),
                        torch.stack([c for c, _ in state["controller_state"]], 1),
                        torch.stack([h for _, h in state["controller_state"]], 1)))
            p_t = dict(params, controller=[dict(layer0, kernel=layer0["kernel"][IN:], bias=proj[:, t])]
                       + list(params["controller"][1:]))
            _, logit, state = ntm_cell_step(p_t, cfg, tokens[:, t, :0], state)
            logits.append(logit)
    res = tuple(torch.stack(r, 1).contiguous() for r in zip(*res))
    return torch.stack(logits, 1), state, res


def token_projection(tokens: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """X W0[:IN] + b0 over every step: [B*T, 4Hc] from tokens [B, T, IN]
    and layer 0's kernel [IN + R*D + Hc, 4Hc] and bias [4Hc], the token
    part of each step's layer-0 product. One launch of csrc/scan_bptt.cu's
    GEMM, counted in `launches.token_projection`; CPU tensors run
    token_projection_reference."""
    B, T, IN = tokens.shape
    device = tokens.device
    G4 = kernel.shape[1]
    _check("tokens", tokens, (B, T, IN), device)
    _check("kernel", kernel, (kernel.shape[0], G4), device)
    _check("bias", bias, (G4,), device)
    if kernel.shape[0] < IN:
        raise ValueError(f"kernel has {kernel.shape[0]} rows, fewer than the token width {IN}")
    if device.type == "cpu":
        return token_projection_reference(tokens, kernel, bias)
    out = torch.empty(B * T, G4, device=device)
    index, stream = _stream(device)
    err = _library().ntm_token_proj_launch(
        tokens.data_ptr(), IN, kernel.data_ptr(), G4, bias.data_ptr(), B * T, IN, G4,
        gemm_tile(B * T, G4)[0], out.data_ptr(), index, stream,
    )
    if err != 0:
        raise RuntimeError(f"scan_bptt token projection launch failed: CUDA error {err}")
    profiling.count("launches.token_projection")
    return out


def token_projection_reference(tokens: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The plain version of token_projection."""
    IN = tokens.shape[2]
    return tokens.reshape(-1, IN) @ kernel[:IN] + bias


def bptt_backward(params, cfg: NTMConfig, tokens: torch.Tensor, proj: torch.Tensor, res, dlogits: torch.Tensor,
                  dfinal, need_dtokens: bool = True, rows_per_block: Optional[int] = None):
    """Launch the reverse-time kernel.

    proj [B*T, 4Hc] is token_projection's output for these tokens and
    layer 0's weights (the token part of every step's layer-0 product).
    dfinal holds the cotangents of the final state (the state dict's
    layout). Returns (dtokens [B,T,IN] or None, dstate0 (state layout),
    operands) where operands = (li [L, B*T, KINmax rounded up to 4: 16-byte
    rows, the padding columns unwritten], dgates [L, B*T, 4Hc],
    ctrl [B*T, Hc], dctl [B*T, P+O]: the head-control cotangents, then the
    logits') feed weight_grads.
    need_dtokens=False computes, writes and allocates no dtokens.
    rows_per_block picks the tile (backward_rows). One launch, counted in
    `launches.bptt_backward`."""
    B, T, IN = tokens.shape
    device = tokens.device
    N, D, H = cfg.mem_size, cfg.mem_dim, cfg.num_heads
    R, Hc, L, O = cfg.read_head_size, cfg.controller_hidden_size, cfg.controller_num_layers, cfg.output_dim
    P = sum(head_param_sizes(cfg).values())
    KM = math.ceil(max(IN + R * D + Hc, 2 * Hc) / 4) * 4  # 16-byte rows for the reduction's loads
    _check("dlogits", dlogits, (B, T, O), device)
    _check("dM", dfinal["M"], (B, N, D), device)
    _check("dw", dfinal["w"], (B, H, N), device)
    _check("dread", dfinal["read"], (B, R, D), device)
    dc_T = torch.stack([c for c, _ in dfinal["controller_state"]])
    dh_T = torch.stack([h for _, h in dfinal["controller_state"]])
    _check("dc", dc_T, (L, B, Hc), device)
    _check("dh", dh_T, (L, B, Hc), device)
    _check("proj", proj, (B * T, 4 * Hc), device)
    rows = backward_tile(cfg, IN, B, device, rows_per_block)
    ctrl = params["controller"]
    dM0 = torch.empty(B, N, D, device=device)
    dw0 = torch.empty(B, H, N, device=device)
    dread0 = torch.empty(B, R, D, device=device)
    dc0 = torch.empty(L, B, Hc, device=device)
    dh0 = torch.empty(L, B, Hc, device=device)
    dtokens = torch.empty(B, T, IN, device=device) if need_dtokens else None
    li = torch.empty(L, B * T, KM, device=device)
    dgates = torch.empty(L, B * T, 4 * Hc, device=device)
    ctrl_out = torch.empty(B * T, Hc, device=device)
    dctl = torch.empty(B * T, P + O, device=device)
    index, stream = _stream(device)
    err = _library().ntm_bptt_bwd_launch(
        tokens.data_ptr(), proj.data_ptr(),
        _ptr_array([layer["kernel"] for layer in ctrl]), _ptr_array([layer["bias"] for layer in ctrl]),
        params["heads_w"].data_ptr(), params["heads_b"].data_ptr(),
        params["out_w"].data_ptr(), params["out_b"].data_ptr(),
        *[r.data_ptr() for r in res], dlogits.data_ptr(),
        dfinal["M"].data_ptr(), dfinal["w"].data_ptr(), dfinal["read"].data_ptr(),
        dc_T.data_ptr(), dh_T.data_ptr(),
        dM0.data_ptr(), dw0.data_ptr(), dread0.data_ptr(), dc0.data_ptr(), dh0.data_ptr(),
        None if dtokens is None else dtokens.data_ptr(), li.data_ptr(), dgates.data_ptr(),
        ctrl_out.data_ptr(), dctl.data_ptr(),
        B, T, *_dims(cfg, IN), int(cfg.write_first), int(cfg.slotwise_cosine), int(need_dtokens), rows,
        index, stream,
    )
    if err != 0:
        raise RuntimeError(f"scan_bptt backward kernel launch failed: CUDA error {err}")
    profiling.count("launches.bptt_backward")
    dstate0 = {"M": dM0, "w": dw0, "read": dread0,
               "controller_state": [(dc0[l], dh0[l]) for l in range(L)]}
    return dtokens, dstate0, (li, dgates, ctrl_out, dctl)


def gemm_tile(rows: int, cols: int) -> Tuple[int, int]:
    """The GEMM kernels' block tile (a key of GEMM_TILES) for a [rows,
    cols] output: the one that pads it least."""
    return min(GEMM_TILES, key=lambda t: math.ceil(rows / t[0]) * t[0] * math.ceil(cols / t[1]) * t[1])


def gemm_tiles(rows: int, cols: int) -> int:
    """How many block tiles cover a [rows, cols] output at gemm_tile's tile."""
    bm, bn = gemm_tile(rows, cols)
    return math.ceil(rows / bm) * math.ceil(cols / bn)


def wave_fill(blocks: int, slots: int) -> float:
    """The share of `slots`-block waves that `blocks` blocks fill."""
    return blocks / (math.ceil(blocks / slots) * slots)


def reduce_chunks(M: int, K: int, J: int, sms: int = H100_SMS) -> Tuple[int, int]:
    """(chunks, rows per chunk) the reduction splits its M rows into: a
    function of the shape (and the card's SM count) only, so the summation
    order, and the result's bits, are the same on every run. The fewest
    chunks whose tiles x chunks blocks fill whole waves of the card
    (MIN_WAVE_FILL), each chunk at least MIN_CHUNK_ROWS rows where M
    allows; rows per chunk is a multiple of REDUCE_ROWS."""
    tiles = gemm_tiles(K + 1, J)
    slots = sms * GEMM_TILES[gemm_tile(K + 1, J)]
    most = max(1, M // MIN_CHUNK_ROWS)
    fills = [(wave_fill(tiles * c, slots), c) for c in range(1, most + 1)]
    good = [c for f, c in fills if f >= MIN_WAVE_FILL]
    chunks = good[0] if good else max(fills, key=lambda fc: (fc[0], -fc[1]))[1]
    rows = math.ceil(math.ceil(M / chunks) / REDUCE_ROWS) * REDUCE_ROWS
    return math.ceil(M / rows), rows


def grad_reduce(A: torch.Tensor, G: torch.Tensor, K: int) -> torch.Tensor:
    """[A[:, :K]^T G ; sum_m G[m]] over the M rows: a weight gradient
    [K, J] with its bias gradient as row K. A [M, >=K] and G [M, J] are
    contiguous float32 on cuda. One launch (two kernels: the chunks'
    partial sums, then their sum in order), counted in
    `launches.grad_reduce`."""
    M, J = G.shape
    device = G.device
    if A.dim() != 2 or A.shape[0] != M or A.shape[1] < K:
        raise ValueError(f"A has shape {tuple(A.shape)}, expected [{M}, >={K}]")
    _check("A", A, tuple(A.shape), device)
    _check("G", G, (M, J), device)
    chunks, rows = reduce_chunks(M, K, J, sm_count(device))
    part = torch.empty(chunks, K + 1, J, device=device)
    out = torch.empty(K + 1, J, device=device)
    index, stream = _stream(device)
    err = _library().ntm_grad_reduce_launch(
        A.data_ptr(), A.shape[1], G.data_ptr(), J, M, K, J, gemm_tile(K + 1, J)[0], chunks, rows,
        part.data_ptr(), out.data_ptr(), index, stream,
    )
    if err != 0:
        raise RuntimeError(f"scan_bptt reduction kernel launch failed: CUDA error {err}")
    profiling.count("launches.grad_reduce")
    return out


def grad_reduce_reference(A: torch.Tensor, G: torch.Tensor, K: int) -> torch.Tensor:
    """The plain version of grad_reduce."""
    return torch.cat([A[:, :K].T @ G, G.sum(0, keepdim=True)], dim=0)


def weight_grads(cfg: NTMConfig, IN: int, operands) -> list:
    """The parameter gradients from a backward kernel's operands
    (bptt_backward's or scan_packed.packed_backward's), through grad_reduce:
    [dkernel[l]..., dbias[l]..., dheads_w, dheads_b, dout_w, dout_b]
    (flatten_scan_args' order). dctl [B*T, P+O] holds the head-control
    cotangents, then the logits', so one reduction serves both linears."""
    li, dgates, ctrl, dctl = operands
    R, D, Hc, L = cfg.read_head_size, cfg.mem_dim, cfg.controller_hidden_size, cfg.controller_num_layers
    P = sum(head_param_sizes(cfg).values())
    dkernels, dbiases = [], []
    for l in range(L):
        K = (IN + R * D if l == 0 else Hc) + Hc
        g = grad_reduce(li[l], dgates[l], K)
        dkernels.append(g[:K])
        dbiases.append(g[K])
    g = grad_reduce(ctrl, dctl, Hc)
    gh, go = g[:, :P].contiguous(), g[:, P:].contiguous()
    return [*dkernels, *dbiases, gh[:Hc], gh[Hc], go[:Hc], go[Hc]]


class _ScanBPTT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, L, rows_fwd, rows_bwd, tokens, *flat):
        params, state = unflatten_scan_args(flat, L)
        layer0 = params["controller"][0]
        # the token part of every step's layer-0 product, once: the forward
        # reads it, and it is kept for the backward
        proj = token_projection(tokens, layer0["kernel"], layer0["bias"])
        logits, final, res = bptt_forward(params, cfg, tokens, state, proj, rows_per_block=rows_fwd)
        ctx.cfg, ctx.L, ctx.rows_bwd, ctx.res, ctx.proj = cfg, L, rows_bwd, res, proj
        ctx.save_for_backward(tokens, *flat)
        # distinct tensors, so that no output is a view of another
        return (logits, *[t.clone() for t in flatten_state(final)])

    @staticmethod
    def backward(ctx, dlogits, *dfinal):
        cfg, L = ctx.cfg, ctx.L
        tokens, *flat = ctx.saved_tensors
        params, _ = unflatten_scan_args(flat, L)
        # the residuals and the projection are freed as soon as the backward
        # kernel has read them
        res, proj, ctx.res, ctx.proj = ctx.res, ctx.proj, None, None
        if res is None:
            raise RuntimeError("the fused BPTT backward runs once per forward (no retain_graph)")
        dlogits = dlogits.contiguous()
        dtokens, dstate0, operands = bptt_backward(
            params, cfg, tokens, proj, res, dlogits, unflatten_state([d.contiguous() for d in dfinal], L),
            need_dtokens=ctx.needs_input_grad[4], rows_per_block=ctx.rows_bwd,
        )
        del res, proj
        grads = [*flatten_state(dstate0), *weight_grads(cfg, tokens.shape[2], operands)]
        return (None, None, None, None, dtokens, *grads)


def ntm_scan_fused_bptt(
    params: Dict[str, Any],
    cfg: NTMConfig,
    tokens: torch.Tensor,
    state: Dict[str, Any],
    forward_rows_per_block: Optional[int] = None,
    backward_rows_per_block: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """T NTM steps, differentiable wrt params, tokens and the initial state.

    Args:
      tokens: [B, T, IN] float32; params and state on the tokens' device,
        float32 and contiguous.
      forward_rows_per_block, backward_rows_per_block: the forward and
        backward kernels' tiles (FORWARD_ROWS, BACKWARD_ROWS); None =
        forward_rows' and backward_rows' choice from B and the card's SM
        count.
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
    logits, *final = _ScanBPTT.apply(cfg, L, forward_rows_per_block, backward_rows_per_block, tokens, *flat)
    return logits, unflatten_state(final, L)
