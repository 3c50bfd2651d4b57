"""One NTM cell step's addressing and memory update in one CUDA launch
(B3; counterpart of ntm_tracker_tpu/ops/pallas/addressing.py:
fused_ntm_addressing).

Everything the cell does after the head-parameter linear: tanh(k), the
cosine against memory (across-slot, or slotwise), the softplus-beta
softmax, the sigmoid gate, the circular shift with the Python-2 offsets,
the gamma-power sharpen with +1e-3, the erase/add write, and the read
before or after the write. All head controls come in raw (pre-activation).

`fused_ntm_addressing` launches csrc/addressing.cu for CUDA tensors and
runs `fused_ntm_addressing_reference`, the same math in plain PyTorch, for
CPU tensors. Its gradient is that of the plain version: the backward
recomputes `fused_ntm_addressing_reference` from the saved inputs and
takes its autograd. That is the reference's design (JAX's custom VJP runs
the jnp math, addressing.py:177-202, and it has no backward kernel), not a
fallback. The kernel is deterministic (no atomics), so a checkpointed
step's recompute gets the same bits.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ntm_tracker_tpu_torch.ops.memory import (
    batched_circular_convolution,
    batched_slotwise_cosine_similarity,
    batched_smooth_cosine_similarity,
    sharpen,
)

# one block's dynamic shared memory on the card (H100: 227 KB)
MAX_SMEM_BYTES = 232448

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def fused_ntm_addressing_reference(k, beta, g, sw, gamma, erase, add, M_prev, w_prev, *,
                                   read_heads: int, write_first: bool = False,
                                   slotwise: bool = False) -> Outputs:
    """The plain version (the math of JAX's _jnp_addressing,
    addressing.py:136-173): (M [B,N,D], w [B,H,N], read [B,R,D])."""
    R = read_heads
    cos = batched_slotwise_cosine_similarity if slotwise else batched_smooth_cosine_similarity
    sim = cos(M_prev, torch.tanh(k))
    w_c = torch.softmax(sim * torch.nn.functional.softplus(beta)[..., None], dim=-1)
    g_s = torch.sigmoid(g)[..., None]
    w_g = w_c * g_s + w_prev * (1 - g_s)
    w = sharpen(batched_circular_convolution(w_g, torch.softmax(sw, dim=-1)),
                (torch.nn.functional.softplus(gamma) + 1.0)[..., None])
    e, a = torch.sigmoid(erase), torch.tanh(add)
    w_write = w[:, R:, :, None]  # [B,W,N,1]
    M_erase = torch.prod(1 - w_write * e[:, :, None, :], dim=1)
    M_write = torch.sum(w_write * a[:, :, None, :], dim=1)
    M = M_prev * M_erase + M_write
    src = M if write_first else M_prev
    read = torch.einsum("brn,bnd->brd", w[:, :R, :], src)
    return M, w, read


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ntm_tracker_tpu_torch._build import load_library

    lib = load_library("addressing")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ntm_addressing_launch.argtypes = [ptr] * 12 + [i32] * 9 + [i32] * 9 + [i32, ptr]
    lib.ntm_addressing_launch.restype = i32
    lib.ntm_addressing_smem_bytes.argtypes = [i32] * 6
    lib.ntm_addressing_smem_bytes.restype = i32
    return lib


def _rows(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> Tuple[torch.Tensor, int]:
    """(t, its batch-row stride) once each row's elements are contiguous.
    The head controls are views into the fused [B, P] linear output, whose
    rows already are, so they pass without a copy; other layouts are made
    contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, M_prev on {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    expect = 1
    for size, stride in reversed(list(zip(t.shape[1:], t.stride()[1:]))):
        if size != 1 and stride != expect:
            t = t.contiguous()
            break
        expect *= size
    return t, (t.stride(0) if t.shape[0] > 1 else expect)


def _launch(k, beta, g, sw, gamma, erase, add, M_prev, w_prev, R: int, write_first: bool,
            slotwise: bool) -> Outputs:
    """Check the inputs and launch csrc/addressing.cu (counted)."""
    device = M_prev.device
    B, N, D = M_prev.shape
    H, S, W = k.shape[1], sw.shape[-1], erase.shape[1]
    if not 0 <= R <= H or W != H - R:
        raise ValueError(f"read_heads={R} with {H} heads and {W} write heads")
    shapes = {"k": (B, H, D), "beta": (B, H), "g": (B, H), "sw": (B, H, S), "gamma": (B, H),
              "erase": (B, W, D), "add": (B, W, D), "M_prev": (B, N, D), "w_prev": (B, H, N)}
    args = dict(zip(shapes, (k, beta, g, sw, gamma, erase, add, M_prev, w_prev)))
    rows = {name: _rows(name, args[name], shape, device) for name, shape in shapes.items()}
    lib = _library()
    smem = lib.ntm_addressing_smem_bytes(N, D, H, R, W, S)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"config needs {smem} B of shared memory per block, above {MAX_SMEM_BYTES}")
    M = torch.empty(B, N, D, device=device)
    w = torch.empty(B, H, N, device=device)
    read = torch.empty(B, R, D, device=device)
    err = lib.ntm_addressing_launch(
        *[t.data_ptr() for t, _ in rows.values()], M.data_ptr(), w.data_ptr(), read.data_ptr(),
        *[s for _, s in rows.values()], B, N, D, H, R, W, S, int(write_first), int(slotwise),
        device.index, torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"addressing kernel launch failed: CUDA error {err}")
    fused_ntm_addressing.launches += 1
    return M, w, read


class _Addressing(torch.autograd.Function):
    """Forward: the kernel. Backward: autograd of the plain version,
    recomputed from the saved inputs (JAX's custom VJP)."""

    @staticmethod
    def forward(ctx, R, write_first, slotwise, *inputs):
        ctx.R, ctx.write_first, ctx.slotwise = R, write_first, slotwise
        ctx.save_for_backward(*inputs)
        return _launch(*inputs, R, write_first, slotwise)

    @staticmethod
    def backward(ctx, *grads):
        needs = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, needs)]
            outs = fused_ntm_addressing_reference(*inputs, read_heads=ctx.R, write_first=ctx.write_first,
                                                  slotwise=ctx.slotwise)
            wanted = [t for t in inputs if t.requires_grad]
            got = iter(torch.autograd.grad(outs, wanted, grads, allow_unused=True))
        return (None, None, None, *[next(got) if t.requires_grad else None for t in inputs])


def fused_ntm_addressing(k: torch.Tensor, beta: torch.Tensor, g: torch.Tensor, sw: torch.Tensor,
                         gamma: torch.Tensor, erase: torch.Tensor, add: torch.Tensor,
                         M_prev: torch.Tensor, w_prev: torch.Tensor, *, read_heads: int,
                         write_first: bool = False, slotwise: bool = False) -> Outputs:
    """One step's addressing and memory update, from raw head controls.

    Args (float32): k [B,H,D], beta/g/gamma [B,H], sw [B,H,S],
      erase/add [B,W,D], M_prev [B,N,D], w_prev [B,H,N]; W = H - read_heads.
    Returns:
      (M [B,N,D], w [B,H,N], read [B,R,D]). CPU tensors run the plain
      version; CUDA tensors launch the kernel (counted in
      `fused_ntm_addressing.launches`) or raise. Differentiable wrt every
      input.
    """
    inputs = (k, beta, g, sw, gamma, erase, add, M_prev, w_prev)
    kw = dict(read_heads=read_heads, write_first=write_first, slotwise=slotwise)
    device = M_prev.device
    if device.type == "cpu":
        return fused_ntm_addressing_reference(*inputs, **kw)
    if device.type != "cuda":
        raise ValueError(f"fused_ntm_addressing runs on cuda or cpu tensors, got {device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _Addressing.apply(read_heads, write_first, slotwise, *inputs)
    return _launch(*inputs, read_heads, write_first, slotwise)


fused_ntm_addressing.launches = 0
