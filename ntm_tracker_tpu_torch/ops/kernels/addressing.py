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

`addressing_split_reference` is the plain emulation of how the kernel's
phases (csrc/ntm_step.cuh ntm_addressing(), which B1's cluster route
shares) split the work: a warp per head with a run of slots per lane, the
shift's shuffles across run boundaries, the transposed and padded memory.
The tests hold it to JAX's kernel; nothing on the card calls it.
`addressing_probe` runs the kernel's probe variant (chip_smoke.py).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from ntm_tracker_tpu_torch.ops.memory import (
    batched_circular_convolution,
    batched_slotwise_cosine_similarity,
    batched_smooth_cosine_similarity,
    sharpen,
)
from ntm_tracker_tpu_torch.utils import profiling

# one block's dynamic shared memory on the card (H100: 227 KB)
MAX_SMEM_BYTES = 232448
# threads per block of B3's kernel (csrc/addressing.cu NT_ADDR)
ADDR_THREADS = 512
# the most slots the head chains hold: 32 lanes of 8 (csrc/ntm_step.cuh)
ADDR_MAX_SLOTS = 256

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def addr_stride(N: int) -> int:
    """The slot stride of the phases' transposed memory and weight rows
    (csrc/ntm_step.cuh addr_stride): N rounded up to 4, plus 4 where that is
    a multiple of 32."""
    Np = (N + 3) // 4 * 4
    return Np + 4 if Np % 32 == 0 else Np


def addr_run(N: int) -> int:
    """Slots per lane in a head chain: the fewest of 1, 2, 4, 8 that cover
    N with 32 lanes (csrc/ntm_step.cuh addr_run)."""
    return 1 if N <= 32 else 2 if N <= 64 else 4 if N <= 128 else 8


def addressing_supported(N: int, S: int) -> bool:
    """Whether the phases take this config: at most ADDR_MAX_SLOTS slots,
    and a shift that wraps at most once (S <= N)."""
    return 1 <= N <= ADDR_MAX_SLOTS and 1 <= S <= N


def addressing_smem_floats(N: int, D: int, H: int, R: int, W: int, S: int, warps: int) -> int:
    """Floats of the phases' shared arrays (csrc/ntm_step.cuh
    make_addr_layout; chip_smoke.py holds B3's count equal): the memory
    [D][Np], the weights [H][Np], tanh(k) [H][Dp] and the normalizer [Dp]
    (Dp: D rounded up to 4), four scalars per head, the raw head controls,
    the shift weights [H][S], erase and add [W][D], and each read warp's D
    rows of 33 partial sums."""
    Np, Dp = addr_stride(N), (D + 3) // 4 * 4
    controls = H * D + 3 * H + S * H + 2 * W * D
    return D * Np + H * Np + H * Dp + Dp + 4 * H + controls + H * S + 2 * W * D + min(R, warps) * D * 33


def addressing_smem_bytes(N: int, D: int, H: int, R: int, W: int, S: int) -> int:
    """B3's dynamic shared memory per block (csrc/addressing.cu
    ntm_addressing_smem_bytes)."""
    return 4 * addressing_smem_floats(N, D, H, R, W, S, ADDR_THREADS // 32)


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


def shift_sources(N: int, S: int, lane: int, i: int, j: int) -> Tuple[int, int]:
    """(source lane, its element) of the slot that offset j of the circular
    shift reads for slot lane * RL + i, by the head chain's shuffle plan
    (csrc/ntm_step.cuh head_chain): the element index the source lane
    offers is the same on every lane within a wrap class."""
    RL = addr_run(N)
    o = j - (S + 1) // 2
    raw = lane * RL + i + o
    cls = 1 if raw < 0 else (-1 if raw >= N else 0)
    return ((raw + cls * N) // RL) & 31, (i + o + cls * N) % RL


def _warp_sum(x: torch.Tensor) -> torch.Tensor:
    """The butterfly warp_sum of csrc/ntm_step.cuh over the last dim (32
    lanes): after five xor steps every lane holds the same total."""
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        x = x + x[..., lanes ^ off]
    return x[..., 0]


def _lane_total(parts: torch.Tensor) -> torch.Tensor:
    """csrc/ntm_step.cuh lane_total over dim 1 (32 lanes): four runs of
    eight in lane order, then (run 0 + run 1) + (run 2 + run 3)."""
    q = []
    for r in range(4):
        acc = parts[:, 8 * r]
        for j in range(1, 8):
            acc = acc + parts[:, 8 * r + j]
        q.append(acc)
    return (q[0] + q[1]) + (q[2] + q[3])


def addressing_split_reference(k, beta, g, sw, gamma, erase, add, M_prev, w_prev, *, read_heads: int,
                               write_first: bool = False, slotwise: bool = False,
                               warps: int = ADDR_THREADS // 32) -> Outputs:
    """The kernel's work split in plain PyTorch (csrc/ntm_step.cuh
    ntm_addressing() with `warps` warps a block): the memory transposed
    into rows of addr_stride(N) floats with zero columns past N; phase (a)'s
    per-head tanh(k), |k|^-1 and shift weights and the across-slot
    normalizer from each lane's four slots of a row and a warp sum; then
    warp w runs heads w, w + warps, ..., each lane holding slots lane * RL
    .. lane * RL + RL - 1 (RL = addr_run(N)): the similarity, the softmax
    and the sharpen's sums as warp sums of the lanes' sums, the shift's
    inputs taken, as the shuffles take them, from the source lane's element
    (shift_sources), pow as exp2(gamma * log2(x)), a read head's read as
    each lane's partial sums added by lane_total; then the erase/add write
    and, write_first, the read of the new memory. Same arguments and results as
    fused_ntm_addressing_reference."""
    B, N, D = M_prev.shape
    H, S, W, R = k.shape[1], sw.shape[-1], erase.shape[1], read_heads
    if not addressing_supported(N, S):
        raise ValueError(f"the addressing kernel takes 1 <= N <= {ADDR_MAX_SLOTS} slots and S <= N, got N={N}, S={S}")
    Np, RL = addr_stride(N), addr_run(N)
    lanes = torch.arange(32)
    n0 = lanes * RL
    slots = n0[:, None] + torch.arange(RL)           # [32, RL]
    valid = slots < N
    in_row = (slots < Np) & (n0 < N)[:, None]        # what a lane's run loads hold
    Mt = M_prev.new_zeros(B, D, Np)
    Mt[:, :, :N] = M_prev.transpose(1, 2)
    ws = M_prev.new_zeros(B, H, Np)
    softplus = torch.nn.functional.softplus
    zero = M_prev.new_zeros(())

    def run(row):
        """A row [B, Np] as the lanes' runs [B, 32, RL]."""
        return torch.where(in_row, row[:, slots.clamp(max=Np - 1)], zero)

    def read(wn):
        """sum_n w[n] M[n][d] for every d, as a read head's warp takes it:
        each lane's sum over its run into its column, added by lane_total."""
        return _lane_total(torch.stack([(wn * run(Mt[:, d])).sum(-1) for d in range(D)], -1))

    # (a) the normalizer: each lane's four slots of a row, then a warp sum
    quads = Mt.reshape(B, D, Np // 4, 4)
    sq = quads[..., 3] ** 2
    for c in (2, 1, 0):
        sq = quads[..., c] * quads[..., c] + sq
    per_lane = M_prev.new_zeros(B, D, 32)
    for q in range(0, (N + 3) // 4):
        per_lane[:, :, q % 32] = per_lane[:, :, q % 32] + sq[:, :, q]
    minv = torch.rsqrt(torch.clamp_min(_warp_sum(per_lane), 1e-12))       # [B, D]
    kt = torch.tanh(k)                                                     # [B, H, D]
    kss = M_prev.new_zeros(B, H, 32)
    for d in range(D):
        kss[:, :, d % 32] = kss[:, :, d % 32] + kt[:, :, d] * kt[:, :, d]
    kinv = torch.rsqrt(torch.clamp_min(_warp_sum(kss), 1e-12))             # [B, H]
    smx = sw.amax(-1, keepdim=True)
    swv = torch.exp(sw - smx) * (1 / torch.exp(sw - smx).sum(-1, keepdim=True))

    reads = M_prev.new_zeros(B, R, D)
    shift0, exact = -((S + 1) // 2), N % RL == 0
    for warp in range(min(warps, H)):
        for h in range(warp, H, warps):
            bt, gt = softplus(beta[:, h])[:, None, None], torch.sigmoid(g[:, h])[:, None, None]
            gm = (softplus(gamma[:, h]) + 1.0)[:, None, None]
            wp = torch.where(valid, w_prev[:, h][:, slots.clamp(max=N - 1)], zero)
            kd = kt[:, h] if slotwise else kt[:, h] * minv
            sim, nrm = torch.zeros_like(wp), torch.zeros_like(wp)
            for d in range(D):
                m = run(Mt[:, d])
                sim = sim + kd[:, d, None, None] * m
                nrm = nrm + m * m
            scale = torch.rsqrt(torch.clamp_min(nrm, 1e-12)) * kinv[:, h, None, None] if slotwise else \
                kinv[:, h, None, None]
            x = sim * scale * bt
            mx = torch.where(valid, x, zero - torch.inf).amax((1, 2), keepdim=True)
            ex = torch.where(valid, torch.exp(x - mx), zero)
            tinv = 1 / _warp_sum(ex.sum(-1))[:, None, None]
            wg = torch.where(valid, ex * tinv * gt + wp * (1 - gt), zero)
            conv = torch.zeros_like(wg)
            for j in range(S):
                swj = swv[:, h, j, None]
                o = shift0 + j
                for i in range(RL):
                    raw = n0 + i + o
                    cls = torch.where(raw < 0, 1, torch.where(raw >= N, -1, 0))
                    src = torch.div(raw + cls * N, RL, rounding_mode="floor") & 31
                    v = wg[:, :, (i + o) % RL][:, src]
                    if not exact:
                        vp, vm = wg[:, :, (i + o + N) % RL][:, src], wg[:, :, (i + o - N) % RL][:, src]
                        v = torch.where(cls > 0, vp, torch.where(cls < 0, vm, v))
                    conv[:, :, i] = conv[:, :, i] + swj * v
            pw = torch.where(valid, torch.exp2(gm * torch.log2(conv)), zero)
            wn = pw * (1 / (_warp_sum(pw.sum(-1)) + 1e-3))[:, None, None]
            ws[:, h, :N] = wn.reshape(B, 32 * RL)[:, :N]
            if not write_first and h < R:
                reads[:, h] = read(wn)
    er, ad = torch.sigmoid(erase), torch.tanh(add)
    ww = ws[:, R:, :N, None]                                     # [B, W, N, 1]
    ek, ak = torch.ones_like(M_prev), torch.zeros_like(M_prev)
    for wh in range(W):
        ek = ek * (1 - ww[:, wh] * er[:, wh, None, :])
        ak = ak + ww[:, wh] * ad[:, wh, None, :]
    M = M_prev * ek + ak
    if write_first:
        Mt[:, :, :N] = M.transpose(1, 2)
        for h in range(R):
            reads[:, h] = read(run(ws[:, h]))
    return M, ws[:, :, :N].clone(), reads


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ntm_tracker_tpu_torch._build import load_library

    lib = load_library("addressing")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ntm_addressing_launch.argtypes = [ptr] * 12 + [i32] * 9 + [i32] * 9 + [i32, ptr]
    lib.ntm_addressing_launch.restype = i32
    lib.ntm_addressing_smem_bytes.argtypes = [i32] * 6
    lib.ntm_addressing_smem_bytes.restype = i32
    lib.ntm_addressing_probe_launch.argtypes = [ptr] * 12 + [i32] * 9 + [i32] * 9 + [i32, ptr, ptr]
    lib.ntm_addressing_probe_launch.restype = i32
    lib.ntm_addressing_probe_slots.restype = i32
    lib.ntm_sm_clock_khz.argtypes = [i32]
    lib.ntm_sm_clock_khz.restype = i32
    lib.ntm_empty_launch.argtypes = [i32, ptr]
    lib.ntm_empty_launch.restype = i32
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
            slotwise: bool, stamps: Optional[torch.Tensor] = None) -> Outputs:
    """Check the inputs and launch csrc/addressing.cu (counted), or with
    `stamps` its probe variant (not counted)."""
    device = M_prev.device
    B, N, D = M_prev.shape
    H, S, W = k.shape[1], sw.shape[-1], erase.shape[1]
    if not 0 <= R <= H or W != H - R:
        raise ValueError(f"read_heads={R} with {H} heads and {W} write heads")
    shapes = {"k": (B, H, D), "beta": (B, H), "g": (B, H), "sw": (B, H, S), "gamma": (B, H),
              "erase": (B, W, D), "add": (B, W, D), "M_prev": (B, N, D), "w_prev": (B, H, N)}
    args = dict(zip(shapes, (k, beta, g, sw, gamma, erase, add, M_prev, w_prev)))
    rows = {name: _rows(name, args[name], shape, device) for name, shape in shapes.items()}
    if not addressing_supported(N, S):
        raise ValueError(f"the addressing kernel takes 1 <= N <= {ADDR_MAX_SLOTS} slots and S <= N, got N={N}, S={S}")
    lib = _library()
    smem = lib.ntm_addressing_smem_bytes(N, D, H, R, W, S)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"config needs {smem} B of shared memory per block, above {MAX_SMEM_BYTES}")
    M = torch.empty(B, N, D, device=device)
    w = torch.empty(B, H, N, device=device)
    read = torch.empty(B, R, D, device=device)
    args = (*[t.data_ptr() for t, _ in rows.values()], M.data_ptr(), w.data_ptr(), read.data_ptr(),
            *[s for _, s in rows.values()], B, N, D, H, R, W, S, int(write_first), int(slotwise),
            device.index, torch.cuda.current_stream(device).cuda_stream)
    if stamps is None:
        err = lib.ntm_addressing_launch(*args)
    else:
        err = lib.ntm_addressing_probe_launch(*args, stamps.data_ptr())
    if err != 0:
        raise RuntimeError(f"addressing kernel launch failed: CUDA error {err}")
    if stamps is None:
        profiling.count("launches.fused_ntm_addressing")
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
      `launches.fused_ntm_addressing`) or raise. Differentiable wrt every
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


# ---- the per-phase probe (chip_smoke.py) -------------------------------------

# the probe's spans (csrc/addressing.cu PROBE_SLOTS): name -> (from stamp,
# to stamp). Stamps 0-5 are thread 0's at entry and after each block
# barrier (the load, phases (a), (b), the write, the end); stamps 6-10 are
# thread 0's inside head 0's chain in phase (b), and its last span is the
# wait at phase (b)'s barrier.
PROBE_SPANS = {
    "load": (0, 1), "(a) heads' preparation, normalizer": (1, 2), "(b) head chains": (2, 3), "(c) write": (3, 4),
    "(c) read after the write, memory out": (4, 5),
    "chain: similarity": (2, 6), "chain: softmax, gate": (6, 7), "chain: shift": (7, 8),
    "chain: sharpen, store w": (8, 9), "chain: read": (9, 10), "chain: wait at the barrier": (10, 3),
}


def addressing_probe(k, beta, g, sw, gamma, erase, add, M_prev, w_prev, *, read_heads: int,
                     write_first: bool = False, slotwise: bool = False) -> Tuple[Outputs, Dict[str, torch.Tensor]]:
    """B3's probe variant on CUDA tensors: the same outputs, and each
    block's clock64() cycles per span ({name: int64 [B]}, PROBE_SPANS).
    Not counted in `launches.fused_ntm_addressing`."""
    B, device = M_prev.shape[0], M_prev.device
    stamps = torch.zeros(B, _library().ntm_addressing_probe_slots(), dtype=torch.int64, device=device)
    out = _launch(k, beta, g, sw, gamma, erase, add, M_prev, w_prev, read_heads, write_first, slotwise, stamps)
    torch.cuda.synchronize(device)
    stamps = stamps.cpu()
    return out, {name: stamps[:, b] - stamps[:, a] for name, (a, b) in PROBE_SPANS.items()}


def sm_clock_khz(device: torch.device) -> int:
    """The SM clock the probe's cycles convert by (cudaDevAttrClockRate)."""
    return _library().ntm_sm_clock_khz(device.index or 0)


def empty_launch(device: torch.device) -> None:
    """Launch an empty kernel on the current stream: the floor of any
    one-launch B3."""
    err = _library().ntm_empty_launch(device.index or 0, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")
