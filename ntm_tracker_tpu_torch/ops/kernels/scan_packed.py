"""Lane-packed whole-sequence NTM kernels: the cell loop and its BPTT with
each row's memory packed d-major (lane d*N + n), run over a tile of batch
rows per CUDA block.

Counterpart of ntm_tracker_tpu/ops/pallas/scan_packed.py:ntm_scan_packed
and ntm_scan_packed_bptt. The JAX kernels hold the whole batch in one
tile; csrc/scan_packed.cu reads that for what it does and gives each
block a tile of batch rows, so every weight element read from L2 serves
the whole tile. Routes, for CUDA tensors:
  * `ntm_scan_packed`: scan_bptt's token projection (X W0[:IN] + b0 over
    all steps, one launch), then the packed forward on it (one launch);
  * `ntm_scan_packed_bptt` with gradients recorded: the autograd Function
    below, which launches the projection and the packed forward with
    residual streams, keeps the projection for its backward, and there
    launches the packed reverse-time kernel (dtokens only when the tokens
    need a gradient) and B2's deterministic weight-gradient reduction
    (scan_bptt.weight_grads); without gradients it runs the forward as
    `ntm_scan_packed` does.
CPU tensors run `ntm_scan_packed_reference`, plain PyTorch on the packed
layout; other devices raise. f32 only. Both functions take and return the
state in the cell layout (M [B, N, D]). The init_* parameters reach their
gradients through the state argument (build it with init_ntm_state under
the same autograd graph). The tile each kernel runs at comes from B and
the card's SM count (`tile_rows`), its shared memory from
`packed_smem_bytes`, a mirror of the kernel's own layout; a config whose
one-row block does not fit raises.

No path of the port routes here: as in the JAX package, these kernels are
a measured alternative to the row kernels (scan_cell, scan_bptt).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ntm_tracker_tpu_torch.config import NTMConfig
from ntm_tracker_tpu_torch.models.ntm_cell import HEAD_PARAM_ORDER, head_param_sizes
from ntm_tracker_tpu_torch.ops.kernels import scan_bptt
from ntm_tracker_tpu_torch.ops.kernels.addressing import ADDR_MAX_SLOTS, addr_stride
from ntm_tracker_tpu_torch.ops.kernels.scan_bptt import _dims, _ptr_array, sm_count, weight_grads
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

# the tile sizes csrc/scan_packed.cu instantiates (rows per block), for the
# forward kernels and for the backward
FORWARD_ROWS = (1, 2, 3, 4)
BACKWARD_ROWS = (1, 2, 3)
# the kernels' threads per block (csrc/ntm_step.cuh NT)
PACKED_THREADS = 512


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



# ---- the kernels' layout and tiles -------------------------------------------------

def _take4(o: int, n: int) -> Tuple[int, int]:
    """(offset, next free) of an array of n floats at the first 16-byte
    boundary from o (csrc/scan_packed.cu take4)."""
    at = (o + 3) // 4 * 4
    return at, at + n


def packed_smem_floats(cfg: NTMConfig, IN: int, backward: bool, rows: int) -> int:
    """Floats of one block's shared memory at `rows` rows per block: a
    mirror of csrc/scan_packed.cu make_packed_layout (chip_smoke.py holds
    it equal to the kernel's ntm_packed_smem_bytes). Each row keeps the
    memory [D][Np] and the weights [H][Np] (Np = addr_stride(N)), the read,
    c and h, the gates (every layer's in the backward), the raw head
    controls, phase (a)'s outputs (tanh(k) [H][Dp], the normalizer and its
    sums [Dp], |k|^2, four scalars a head, the sharpen's denominators, the
    shift weights, erase and add); the backward adds the chains'
    intermediates (new, content and shifted weights, the similarity) [H][Np]
    each, the slotwise normalizer and its sums [Np] each, the new c, the
    carries (dw [H][Np], dM and d M_prev [D][Np] each, dread, dc, dh), the
    control, controller-output and logit cotangents, d|k|^2 and the step's
    token (staged for li). Past ADDR_MAX_SLOTS slots the forward adds the
    chains' scratch [H][Np]. Each array starts on 16 bytes, each row too;
    the tile's [read | h] or [h_below | h] input [K][rows] follows the
    rows."""
    N, D, H = cfg.mem_size, cfg.mem_dim, cfg.num_heads
    R, W, S = cfg.read_head_size, cfg.write_head_size, cfg.shift_space
    Hc, L, O = cfg.controller_hidden_size, cfg.controller_num_layers, cfg.output_dim
    Np, Dp, P = addr_stride(N), (D + 3) // 4 * 4, sum(head_param_sizes(cfg).values())
    sizes = [D * Np, H * Np, R * D, L * Hc, L * Hc, (L if backward else 1) * 4 * Hc, P,
             H * Dp, Dp, Dp, H, 4 * H, H, H * S, W * D, W * D]
    if backward:
        sizes += [H * Np] * 4 + [Np, Np, L * Hc, H * Np, D * Np, D * Np, P, R * D, L * Hc, L * Hc, Hc, O, H, IN]
    elif N > ADDR_MAX_SLOTS:
        sizes.append(H * Np)
    o = 0
    for n in sizes:
        _, o = _take4(o, n)
    row = (o + 3) // 4 * 4
    return rows * row + max(R * D + Hc, 2 * Hc) * rows


def packed_smem_bytes(cfg: NTMConfig, IN: int, backward: bool, rows: int) -> int:
    """The dynamic shared memory one block of the forward or the backward
    takes at `rows` rows per block (packed_smem_floats in bytes)."""
    return 4 * packed_smem_floats(cfg, IN, backward, rows)


def tile_rows(B: int, rows_per_block: Optional[int], fits: Callable[[int], bool], sms: int, backward: bool) -> int:
    """The tile a launch of the forward or the backward uses at batch B on
    a card of `sms` SMs. An explicit rows_per_block must be instantiated
    (FORWARD_ROWS, BACKWARD_ROWS) and fit (else this raises); None takes,
    of the instantiated tiles that fit, the one whose ceil(B / rows) blocks
    fill the card in the fewest waves, and of those the fewest rows: a
    block's step takes longer with more rows, but less than in proportion
    (PERF.md: the sweep at B = 64, 132, 256 and 512). fits(rows) says
    whether a block of that many rows fits in shared memory."""
    sizes = BACKWARD_ROWS if backward else FORWARD_ROWS
    kind = "backward" if backward else "forward"
    if rows_per_block is not None:
        if rows_per_block not in sizes:
            raise ValueError(f"the packed {kind} kernel takes rows_per_block in {sizes}, got {rows_per_block}")
        if not fits(rows_per_block):
            raise ValueError(f"{rows_per_block} rows per block of the packed {kind} kernel need shared memory "
                             f"above {MAX_SMEM_BYTES} B at this config")
        return rows_per_block
    fitting = [r for r in sizes if fits(r)]
    if not fitting:
        raise ValueError(f"one row per block of the packed {kind} kernel needs shared memory above "
                         f"{MAX_SMEM_BYTES} B at this config")
    return min(fitting, key=lambda r: (math.ceil(math.ceil(B / r) / sms), r))


def tile_for(cfg: NTMConfig, IN: int, B: int, device: torch.device, rows_per_block: Optional[int],
             backward: bool) -> int:
    """tile_rows for this config and batch on `device` (its SM count)."""
    return tile_rows(B, rows_per_block, lambda r: packed_smem_bytes(cfg, IN, backward, r) <= MAX_SMEM_BYTES,
                     sm_count(device), backward)


# ---- the launches ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library(name: str = "scan_packed") -> ctypes.CDLL:
    """A library built from csrc/scan_packed.cu (_build.VARIANTS; three
    nvcc runs that go in parallel): scan_packed holds the forward's entry
    point, scan_packed_bwd the backward's, scan_packed_probe both kernels'
    probe variants; each has ntm_packed_smem_bytes."""
    from ntm_tracker_tpu_torch._build import load_library

    lib = load_library(name)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ntm_packed_smem_bytes.argtypes = [i32] * 12
    lib.ntm_packed_smem_bytes.restype = i32
    if name != "scan_packed_bwd":
        lib.ntm_packed_fwd_launch.argtypes = [ptr] * 23 + [i32] * 15 + [ptr, i32, ptr]
        lib.ntm_packed_fwd_launch.restype = i32
    if name != "scan_packed":
        lib.ntm_packed_bwd_launch.argtypes = [ptr] * 29 + [i32] * 16 + [ptr, i32, ptr]
        lib.ntm_packed_bwd_launch.restype = i32
    return lib


def smem_bytes(cfg: NTMConfig, IN: int, backward: bool, rows: int) -> int:
    """The dynamic shared memory the kernel's own ntm_packed_smem_bytes
    gives for one block at `rows` rows per block (-1: not instantiated)."""
    return _library().ntm_packed_smem_bytes(*_dims(cfg, IN), int(backward), rows)


def _forward(params, cfg: NTMConfig, tokens: torch.Tensor, state, proj: torch.Tensor, residuals: bool,
             rows_per_block, probe: Optional[torch.Tensor] = None):
    check_inputs(params, cfg, tokens, state)
    B, T, IN = tokens.shape
    device = tokens.device
    N, D, H = cfg.mem_size, cfg.mem_dim, cfg.num_heads
    R, Hc, L, O = cfg.read_head_size, cfg.controller_hidden_size, cfg.controller_num_layers, cfg.output_dim
    _check("proj", proj, (B * T, 4 * Hc), device)
    rows = tile_for(cfg, IN, B, device, rows_per_block, backward=False)
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
    err = _library("scan_packed" if probe is None else "scan_packed_probe").ntm_packed_fwd_launch(
        proj.data_ptr(), _ptr_array([layer["kernel"] for layer in ctrl]),
        _ptr_array([layer["bias"] for layer in ctrl]),
        params["heads_w"].data_ptr(), params["heads_b"].data_ptr(),
        params["out_w"].data_ptr(), params["out_b"].data_ptr(),
        state["M"].data_ptr(), state["w"].data_ptr(), state["read"].data_ptr(),
        _ptr_array([c for c, _ in state["controller_state"]]),
        _ptr_array([h for _, h in state["controller_state"]]),
        logits.data_ptr(), M.data_ptr(), w.data_ptr(), read.data_ptr(),
        c_out.data_ptr(), h_out.data_ptr(), *([r.data_ptr() for r in res] if res else [None] * 5),
        B, T, *_dims(cfg, IN), int(cfg.write_first), int(cfg.slotwise_cosine), rows,
        None if probe is None else probe.data_ptr(), index, stream,
    )
    if err != 0:
        raise RuntimeError(f"scan_packed forward kernel launch failed: CUDA error {err}")
    final = {"M": M, "w": w, "read": read, "controller_state": [(c_out[l], h_out[l]) for l in range(L)]}
    return logits, final, res


def packed_forward(params, cfg: NTMConfig, tokens: torch.Tensor, state, proj: torch.Tensor,
                   rows_per_block: Optional[int] = None):
    """Launch the packed forward (no residuals) on proj [B*T, 4Hc], the
    token projection of these tokens and layer 0's weights (the kernel
    reads no token): (logits [B,T,O], final state). rows_per_block picks
    the tile (tile_rows). One launch, counted in `packed_forward.launches`."""
    logits, final, _ = _forward(params, cfg, tokens, state, proj, False, rows_per_block)
    packed_forward.launches += 1
    return logits, final


packed_forward.launches = 0


def packed_forward_residuals(params, cfg: NTMConfig, tokens: torch.Tensor, state, proj: torch.Tensor,
                             rows_per_block: Optional[int] = None):
    """Launch the packed forward that streams residuals, on proj as
    packed_forward takes it: (logits, final state, residuals (Mp [B,T,D*N],
    w [B,T,H,N], read [B,T,R*D], c [B,T,L,Hc], h [B,T,L,Hc]): each step's
    input state, memory packed). One launch, counted in
    `packed_forward_residuals.launches`."""
    out = _forward(params, cfg, tokens, state, proj, True, rows_per_block)
    packed_forward_residuals.launches += 1
    return out


packed_forward_residuals.launches = 0


def packed_backward(params, cfg: NTMConfig, tokens: torch.Tensor, proj: torch.Tensor, res, dlogits: torch.Tensor,
                    dfinal, need_dtokens: bool = True, rows_per_block: Optional[int] = None):
    """Launch the packed reverse-time kernel.

    proj is the forward's token projection (the recompute's layer-0 token
    part); dfinal holds the cotangents of the final state (the state
    dict's layout). Returns (dtokens [B,T,IN] or None, dstate0 (state
    layout), operands) where operands = (li [L, B*T, KINmax rounded up to
    4: 16-byte rows, the padding columns unwritten], dgates [L, B*T, 4Hc],
    ctrl [B*T, Hc], dctl [B*T, P+O]: the head-control cotangents, then the
    logits'), bptt_backward's layout, feed scan_bptt.weight_grads.
    need_dtokens=False computes, writes and allocates no dtokens.
    rows_per_block picks the tile (tile_rows). One launch, counted in
    `packed_backward.launches`."""
    out = _backward(params, cfg, tokens, proj, res, dlogits, dfinal, need_dtokens, rows_per_block)
    packed_backward.launches += 1
    return out


def _backward(params, cfg: NTMConfig, tokens: torch.Tensor, proj: torch.Tensor, res, dlogits: torch.Tensor,
              dfinal, need_dtokens: bool, rows_per_block: Optional[int], probe: Optional[torch.Tensor] = None):
    B, T, IN = tokens.shape
    device = tokens.device
    N, D, H = cfg.mem_size, cfg.mem_dim, cfg.num_heads
    R, Hc, L, O = cfg.read_head_size, cfg.controller_hidden_size, cfg.controller_num_layers, cfg.output_dim
    P = sum(head_param_sizes(cfg).values())
    KM = math.ceil(max(IN + R * D + Hc, 2 * Hc) / 4) * 4  # 16-byte rows for the reduction's loads
    rows = tile_for(cfg, IN, B, device, rows_per_block, backward=True)
    _check("proj", proj, (B * T, 4 * Hc), device)
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
    ctrl = params["controller"]
    index, stream = _stream(device)
    err = _library("scan_packed_bwd" if probe is None else "scan_packed_probe").ntm_packed_bwd_launch(
        tokens.data_ptr(), proj.data_ptr(), _ptr_array([layer["kernel"] for layer in ctrl]),
        _ptr_array([layer["bias"] for layer in ctrl]),
        params["heads_w"].data_ptr(), params["heads_b"].data_ptr(),
        params["out_w"].data_ptr(), params["out_b"].data_ptr(),
        *[r.data_ptr() for r in res], dlogits.data_ptr(),
        dfinal["M"].data_ptr(), dfinal["w"].data_ptr(), dfinal["read"].data_ptr(),
        dc_T.data_ptr(), dh_T.data_ptr(),
        dM0.data_ptr(), dw0.data_ptr(), dread0.data_ptr(), dc0.data_ptr(), dh0.data_ptr(),
        None if dtokens is None else dtokens.data_ptr(), li.data_ptr(), dgates.data_ptr(),
        ctrl_out.data_ptr(), dctl.data_ptr(),
        B, T, *_dims(cfg, IN), int(cfg.write_first), int(cfg.slotwise_cosine), int(need_dtokens), rows,
        None if probe is None else probe.data_ptr(), index, stream,
    )
    if err != 0:
        raise RuntimeError(f"scan_packed backward kernel launch failed: CUDA error {err}")
    dstate0 = {"M": dM0, "w": dw0, "read": dread0,
               "controller_state": [(dc0[l], dh0[l]) for l in range(L)]}
    return dtokens, dstate0, (li, dgates, ctrl_out, dctl)


packed_backward.launches = 0

# the probe variants' phases (csrc/scan_packed.cu Probe: thread 0 of block
# 0, clock64() after each barrier): per step, each layer's products and
# gate updates summed, then the addressing's phases; the backward's first
# five are its recompute
PROBE_PHASES_FORWARD = ("products", "lstm", "head_linear", "a_prep", "b_chains", "c_write_read")
PROBE_PHASES_BACKWARD = ("products", "lstm", "head_linear", "a_prep", "b_chains", "vjp_write", "vjp_chains",
                         "vjp_keys", "head_linears", "gate_cotangents", "lstm_products_and_load")
PROBE_ROWS = 2


def packed_probe(params, cfg: NTMConfig, tokens: torch.Tensor, state, proj: torch.Tensor, res, dlogits: torch.Tensor,
                 dfinal) -> Tuple[Dict[str, int], Dict[str, int]]:
    """The probe variants of the forward (without residuals) and the
    backward (without dtokens) at PROBE_ROWS rows per block, on
    packed_forward's and packed_backward's inputs: ({phase: cycles} of the
    forward, of the backward), block 0's clock64() cycles per phase summed
    over the steps. The variants live in a library of their own
    (scan_packed_probe). Not counted in the launches;
    CUDA tensors only."""
    fwd, bwd = (torch.zeros(len(PROBE_PHASES_BACKWARD), dtype=torch.int64, device=tokens.device) for _ in range(2))
    _forward(params, cfg, tokens, state, proj, False, PROBE_ROWS, fwd)
    _backward(params, cfg, tokens, proj, res, dlogits, dfinal, False, PROBE_ROWS, bwd)
    fwd, bwd = fwd.tolist(), bwd.tolist()
    return dict(zip(PROBE_PHASES_FORWARD, fwd)), dict(zip(PROBE_PHASES_BACKWARD, bwd))


def _project(params, tokens: torch.Tensor) -> torch.Tensor:
    """scan_bptt's token projection of these tokens for layer 0 (one launch)."""
    layer0 = params["controller"][0]
    return scan_bptt.token_projection(tokens, layer0["kernel"], layer0["bias"])


class _PackedBPTT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, L, rows_fwd, rows_bwd, tokens, *flat):
        params, state = unflatten_scan_args(flat, L)
        # the token part of every step's layer-0 product, once: the forward
        # reads it, and it is kept for the backward's recompute
        proj = _project(params, tokens)
        logits, final, res = packed_forward_residuals(params, cfg, tokens, state, proj, rows_fwd)
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
            raise RuntimeError("the packed BPTT backward runs once per forward (no retain_graph)")
        dlogits = dlogits.contiguous()
        dtokens, dstate0, operands = packed_backward(
            params, cfg, tokens, proj, res, dlogits, unflatten_state([d.contiguous() for d in dfinal], L),
            need_dtokens=ctx.needs_input_grad[4], rows_per_block=ctx.rows_bwd,
        )
        del res, proj
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
      rows_per_block: the kernel's tile (FORWARD_ROWS); None = tile_rows'
        choice from B and the card's SM count.
    Returns:
      (logits [B, T, output_dim], final state). CPU tensors run the plain
      version; CUDA tensors launch the token projection and the kernel
      (packed_forward) or raise.
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
    check_inputs(params, cfg, tokens, state)
    return packed_forward(params, cfg, tokens, state, _project(params, tokens), rows_per_block)


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
    forward's and the backward's tiles (None = tile_rows' choice). See the
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
        return ntm_scan_packed(params, cfg, tokens, state, rows_per_block)
    check_inputs(params, cfg, tokens, state)
    L = cfg.controller_num_layers
    logits, *final = _PackedBPTT.apply(cfg, L, rows_per_block, backward_rows_per_block, tokens, *flat)
    return logits, unflatten_state(final, L)
