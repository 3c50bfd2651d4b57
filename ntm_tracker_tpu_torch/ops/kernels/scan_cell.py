"""Whole-sequence NTM cell loop: T cell steps in one CUDA launch.

Counterpart of ntm_tracker_tpu/ops/pallas/scan_cell.py:ntm_scan_fused and
ntm_scan_fused_trainable. `ntm_scan_fused` launches csrc/scan_cell.cu for
CUDA tensors and runs `ntm_scan_fused_reference`, the plain PyTorch loop
over ntm_cell_step, for CPU tensors. Both return (logits [B, T,
output_dim], final state) with the state layout of models/ntm_cell.py.
`ntm_scan_fused_trainable` adds gradients: the kernel's forward, and a
backward through autograd of the plain loop.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch

from ntm_tracker_tpu_torch.config import NTMConfig
from ntm_tracker_tpu_torch.models.ntm_cell import cell_loop, head_param_sizes

# the kernel's limits: layer pointers travel in fixed arrays, and one
# block's dynamic shared memory is capped by the card (H100: 227 KB)
MAX_LAYERS = 8
MAX_SMEM_BYTES = 232448


def ntm_scan_fused_reference(
    params: Dict[str, Any],
    cfg: NTMConfig,
    tokens: torch.Tensor,
    state: Dict[str, Any],
    compute_dtype: Optional[torch.dtype] = None,
    remat: bool = False,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The plain version: models/ntm_cell.cell_loop with use_pallas off,
    as the JAX kernel's own reference strips it (the whole-sequence kernels
    ignore the flag). remat=True checkpoints each step when gradients are
    recorded."""
    if cfg.use_pallas:
        cfg = dataclasses.replace(cfg, use_pallas=False)
    return cell_loop(params, cfg, tokens, state, compute_dtype, remat)


def flatten_scan_args(params: Dict[str, Any], state: Dict[str, Any]) -> List[torch.Tensor]:
    """The tensors a whole-sequence kernel reads besides the tokens, in one
    list: M, w, read, c[l]..., h[l]..., kernel[l]..., bias[l]...,
    heads_w, heads_b, out_w, out_b (the inputs of the autograd Functions)."""
    ctrl = params["controller"]
    return [
        state["M"], state["w"], state["read"],
        *[c for c, _ in state["controller_state"]], *[h for _, h in state["controller_state"]],
        *[layer["kernel"] for layer in ctrl], *[layer["bias"] for layer in ctrl],
        params["heads_w"], params["heads_b"], params["out_w"], params["out_b"],
    ]


def unflatten_scan_args(flat, L: int) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Inverse of flatten_scan_args: (params without init_*, state)."""
    M, w, read = flat[:3]
    cs, hs = flat[3:3 + L], flat[3 + L:3 + 2 * L]
    kernels, biases = flat[3 + 2 * L:3 + 3 * L], flat[3 + 3 * L:3 + 4 * L]
    heads_w, heads_b, out_w, out_b = flat[3 + 4 * L:]
    params = {
        "controller": [{"kernel": k, "bias": b} for k, b in zip(kernels, biases)],
        "heads_w": heads_w, "heads_b": heads_b, "out_w": out_w, "out_b": out_b,
    }
    state = {"M": M, "w": w, "read": read, "controller_state": list(zip(cs, hs))}
    return params, state


def flatten_state(state: Dict[str, Any]) -> List[torch.Tensor]:
    """M, w, read, c[l]..., h[l]... (the outputs of the autograd Functions
    after the logits)."""
    cs = [c for c, _ in state["controller_state"]]
    hs = [h for _, h in state["controller_state"]]
    return [state["M"], state["w"], state["read"], *cs, *hs]


def unflatten_state(flat, L: int) -> Dict[str, Any]:
    M, w, read = flat[:3]
    return {"M": M, "w": w, "read": read,
            "controller_state": list(zip(flat[3:3 + L], flat[3 + L:3 + 2 * L]))}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ntm_tracker_tpu_torch._build import load_library

    lib = load_library("scan_cell")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ntm_scan_cell_launch.argtypes = [ptr] * 18 + [i32] * 16 + [ptr]
    lib.ntm_scan_cell_launch.restype = i32
    lib.ntm_scan_cell_smem_bytes.argtypes = [i32] * 9
    lib.ntm_scan_cell_smem_bytes.restype = i32
    return lib


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, tokens on {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_inputs(params, cfg: NTMConfig, tokens: torch.Tensor, state) -> None:
    """Raise unless params, tokens and state are what the whole-sequence
    kernels take: the config's shapes, float32, contiguous, one device."""
    B, T, IN = tokens.shape
    device = tokens.device
    N, D, H = cfg.mem_size, cfg.mem_dim, cfg.num_heads
    R, W, S = cfg.read_head_size, cfg.write_head_size, cfg.shift_space
    Hc, L, O = cfg.controller_hidden_size, cfg.controller_num_layers, cfg.output_dim
    P = sum(head_param_sizes(cfg).values())
    if not 1 <= L <= MAX_LAYERS:
        raise ValueError(f"the kernels take 1..{MAX_LAYERS} controller layers, got {L}")
    ctrl = params["controller"]
    if len(ctrl) != L or len(state["controller_state"]) != L:
        raise ValueError(f"expected {L} controller layers in params and state")
    _check("tokens", tokens, (B, T, IN), device)
    for l, layer in enumerate(ctrl):
        k_in = (IN + R * D if l == 0 else Hc) + Hc
        _check(f"controller[{l}].kernel", layer["kernel"], (k_in, 4 * Hc), device)
        _check(f"controller[{l}].bias", layer["bias"], (4 * Hc,), device)
    _check("heads_w", params["heads_w"], (Hc, P), device)
    _check("heads_b", params["heads_b"], (P,), device)
    _check("out_w", params["out_w"], (Hc, O), device)
    _check("out_b", params["out_b"], (O,), device)
    _check("M", state["M"], (B, N, D), device)
    _check("w", state["w"], (B, H, N), device)
    _check("read", state["read"], (B, R, D), device)
    for l, (c, h) in enumerate(state["controller_state"]):
        _check(f"c[{l}]", c, (B, Hc), device)
        _check(f"h[{l}]", h, (B, Hc), device)



def ntm_scan_fused(
    params: Dict[str, Any],
    cfg: NTMConfig,
    tokens: torch.Tensor,
    state: Dict[str, Any],
    compute_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run T NTM cell steps.

    Args:
      tokens: [B, T, IN] float32; state: the ntm_cell state dict; params
        and state on the tokens' device, float32 and contiguous.
      compute_dtype: None/float32, or bfloat16 (matmul operands and results
        rounded through bf16, float32 sums, as ops/lstm.matmul).
    Returns:
      (logits [B, T, output_dim], final state). CPU tensors run the plain
      version; CUDA tensors launch the kernel (one launch, counted in
      `ntm_scan_fused.launches`) or raise.
    """
    B, T, IN = tokens.shape
    if T == 0:
        # nothing to run: echo the state, as the JAX kernel does
        return tokens.new_zeros(B, 0, cfg.output_dim), state
    device = tokens.device
    if device.type == "cpu":
        return ntm_scan_fused_reference(params, cfg, tokens, state, compute_dtype)
    if device.type != "cuda":
        raise ValueError(f"ntm_scan_fused runs on cuda or cpu tensors, got {device}")
    return _launch(params, cfg, tokens, state, compute_dtype)


def _stream(device: torch.device) -> Tuple[int, int]:
    """(device index, the current stream's handle) for a launch."""
    return device.index, torch.cuda.current_stream(device).cuda_stream


def _launch(params, cfg: NTMConfig, tokens: torch.Tensor, state, compute_dtype) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Check the inputs and launch csrc/scan_cell.cu (counted)."""
    B, T, IN = tokens.shape
    device = tokens.device
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"the kernel takes float32 or bfloat16 compute, got {compute_dtype}")
    N, D, H = cfg.mem_size, cfg.mem_dim, cfg.num_heads
    R, W, S = cfg.read_head_size, cfg.write_head_size, cfg.shift_space
    Hc, L, O = cfg.controller_hidden_size, cfg.controller_num_layers, cfg.output_dim
    check_inputs(params, cfg, tokens, state)
    ctrl = params["controller"]
    lib = _library()
    smem = lib.ntm_scan_cell_smem_bytes(IN, N, D, H, R, W, S, Hc, L)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"config needs {smem} B of shared memory per block, above {MAX_SMEM_BYTES}"
        )

    logits = torch.empty(B, T, O, device=device)
    M = torch.empty(B, N, D, device=device)
    w = torch.empty(B, H, N, device=device)
    read = torch.empty(B, R, D, device=device)
    c_out = torch.empty(L, B, Hc, device=device)
    h_out = torch.empty(L, B, Hc, device=device)

    def ptrs(tensors):
        return (ctypes.c_void_p * L)(*[t.data_ptr() for t in tensors])

    lstm_w = ptrs([layer["kernel"] for layer in ctrl])
    lstm_b = ptrs([layer["bias"] for layer in ctrl])
    c0 = ptrs([c for c, _ in state["controller_state"]])
    h0 = ptrs([h for _, h in state["controller_state"]])
    err = lib.ntm_scan_cell_launch(
        tokens.data_ptr(), ctypes.cast(lstm_w, ctypes.c_void_p),
        ctypes.cast(lstm_b, ctypes.c_void_p),
        params["heads_w"].data_ptr(), params["heads_b"].data_ptr(),
        params["out_w"].data_ptr(), params["out_b"].data_ptr(),
        state["M"].data_ptr(), state["w"].data_ptr(), state["read"].data_ptr(),
        ctypes.cast(c0, ctypes.c_void_p), ctypes.cast(h0, ctypes.c_void_p),
        logits.data_ptr(), M.data_ptr(), w.data_ptr(), read.data_ptr(),
        c_out.data_ptr(), h_out.data_ptr(),
        B, T, IN, N, D, H, R, W, S, Hc, L, O,
        int(cfg.write_first), int(cfg.slotwise_cosine),
        int(compute_dtype == torch.bfloat16), *_stream(device),
    )
    if err != 0:
        raise RuntimeError(f"scan_cell kernel launch failed: CUDA error {err}")
    ntm_scan_fused.launches += 1
    final_state = {
        "M": M, "w": w, "read": read,
        "controller_state": [(c_out[l], h_out[l]) for l in range(L)],
    }
    return logits, final_state


ntm_scan_fused.launches = 0


class _ScanTrainable(torch.autograd.Function):
    """Forward: ntm_scan_fused (the kernel on cuda). Backward: autograd of
    the plain loop at the same compute dtype, re-run from the saved inputs
    (the kernel keeps no residuals)."""

    @staticmethod
    def forward(ctx, cfg, L, compute_dtype, bwd_remat, tokens, *flat):
        params, state = unflatten_scan_args(flat, L)
        logits, final = ntm_scan_fused(params, cfg, tokens, state, compute_dtype=compute_dtype)
        ctx.cfg, ctx.L, ctx.compute_dtype, ctx.bwd_remat = cfg, L, compute_dtype, bwd_remat
        ctx.save_for_backward(tokens, *flat)
        # distinct tensors, so that no output is a view of another
        return (logits, *[t.clone() for t in flatten_state(final)])

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[4:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need) for t, need in zip(saved, needs)]
            params, state = unflatten_scan_args(inputs[1:], ctx.L)
            logits, final = ntm_scan_fused_reference(
                params, ctx.cfg, inputs[0], state, ctx.compute_dtype, remat=ctx.bwd_remat
            )
            outs = [logits, *flatten_state(final)]
            wanted = [t for t in inputs if t.requires_grad]
            got = iter(torch.autograd.grad(outs, wanted, grads, allow_unused=True)) if wanted else iter(())
        return (None, None, None, None, *[next(got) if t.requires_grad else None for t in inputs])


def ntm_scan_fused_trainable(
    params: Dict[str, Any],
    cfg: NTMConfig,
    tokens: torch.Tensor,
    state: Dict[str, Any],
    bwd_remat: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """ntm_scan_fused with gradients wrt params, tokens and the initial
    state (ntm_tracker_tpu/ops/pallas/scan_cell.py:387): the forward runs
    the kernel (its plain version on CPU tensors), the backward re-runs the
    plain loop at the same compute_dtype and takes its autograd, with every
    step checkpointed when bwd_remat. A train step thus costs the kernel's
    forward plus the plain forward and backward."""
    B, T, _ = tokens.shape
    if T == 0:
        return tokens.new_zeros(B, 0, cfg.output_dim), state
    L = cfg.controller_num_layers
    logits, *final = _ScanTrainable.apply(
        cfg, L, compute_dtype, bwd_remat, tokens, *flatten_scan_args(params, state)
    )
    return logits, unflatten_state(final, L)
