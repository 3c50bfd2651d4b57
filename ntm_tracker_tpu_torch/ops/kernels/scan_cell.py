"""Whole-sequence NTM cell loop: T cell steps, B1 of the port's kernels.

Counterpart of ntm_tracker_tpu/ops/pallas/scan_cell.py:ntm_scan_fused and
ntm_scan_fused_trainable. `ntm_scan_fused` runs `ntm_scan_fused_reference`,
the plain PyTorch loop over ntm_cell_step, for CPU tensors. For CUDA
tensors it launches scan_bptt.token_projection (layer 0's token part of
every step, one GEMM) and then one of two routes, chosen by `scan_route`
from B, the card's SM count and the config's shared memory:
  * "cluster" (small B: the frame step, the fleet's adds): csrc/scan_cell.cu,
    a thread-block cluster of CLUSTER_SIZE CTAs per batch row, each CTA
    holding its slices of the recurrent weights in shared memory;
  * "tile" (large B: the eval step): csrc/scan_bptt.cu's forward tile step
    without residual streams, forward_rows' rows per block.
Both return (logits [B, T, output_dim], final state) with the state layout
of models/ntm_cell.py. `ntm_scan_fused_trainable` adds gradients: the
kernels' forward, and a backward through autograd of the plain loop.

The plain versions of the routes' pieces (`split_projection_reference`,
`cluster_weight_slices` and its inverse, `cluster_step_reference`,
`cluster_scan_reference`) serve the tests; nothing on the card calls them.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from ntm_tracker_tpu_torch.config import NTMConfig
from ntm_tracker_tpu_torch.models.ntm_cell import HEAD_PARAM_ORDER, cell_loop, head_param_sizes
from ntm_tracker_tpu_torch.ops.kernels.addressing import (
    addressing_smem_floats,
    addressing_supported,
    fused_ntm_addressing_reference,
)
from ntm_tracker_tpu_torch.utils import profiling

# the kernels' limits: layer pointers travel in fixed arrays, and one
# block's dynamic shared memory is capped by the card (H100: 227 KB)
MAX_LAYERS = 8
MAX_SMEM_BYTES = 232448
# threads per CTA (csrc/ntm_step.cuh NT)
NT_THREADS = 512
# CTAs per batch row on the cluster route: the largest portable cluster
CLUSTER_SIZE = 8
# the cluster route runs while its B clusters fit the card in this many
# waves (scan_route: the crossover measured on the H100)
CLUSTER_WAVES = 3


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
    lib.ntm_scan_cluster_launch.argtypes = [ptr] * 18 + [i32] * 17 + [ptr]
    lib.ntm_scan_cluster_launch.restype = i32
    lib.ntm_scan_cluster_smem_bytes.argtypes = [i32] * 11
    lib.ntm_scan_cluster_smem_bytes.restype = i32
    lib.ntm_scan_cluster_occupancy.argtypes = [i32] * 12 + [ptr]
    lib.ntm_scan_cluster_occupancy.restype = i32
    return lib


def _bptt():
    """ops/kernels/scan_bptt.py, imported where it is used: it imports
    this module. Both routes run its token projection; the tile route is
    its forward kernel without residuals."""
    from ntm_tracker_tpu_torch.ops.kernels import scan_bptt

    return scan_bptt


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


# ---- the route: a cluster of CTAs per row, or a tile of rows per block -------

def _recurrent_rows(cfg: NTMConfig) -> List[int]:
    """Each layer's recurrent kernel rows: [read | h] for layer 0 (its token
    rows come from the projection), [h_below | h] above."""
    R, D, Hc = cfg.read_head_size, cfg.mem_dim, cfg.controller_hidden_size
    return [R * D + Hc] + [2 * Hc] * (cfg.controller_num_layers - 1)


def _row_state_floats(cfg: NTMConfig) -> int:
    """The floats of one batch row's state in a CTA's shared memory
    (csrc/scan_cell.cu make_slice, before the weights): the addressing's
    arrays (make_addr_layout: the memory transposed, the weights, the head
    controls, their scratch) and the cell state."""
    addressing = addressing_smem_floats(cfg.mem_size, cfg.mem_dim, cfg.num_heads, cfg.read_head_size,
                                        cfg.write_head_size, cfg.shift_space, NT_THREADS // 32)
    return addressing + cfg.controller_num_layers * cfg.controller_hidden_size


def cluster_smem_bytes(cfg: NTMConfig, IN: int, C: int = CLUSTER_SIZE) -> int:
    """One CTA's dynamic shared memory at cluster size C
    (csrc/scan_cell.cu make_slice; chip_smoke.py holds the two equal): the
    row's state, its slices of the weights with rows of odd stride, their
    biases, two gather vectors and the warps' partial gate sums. IN does
    not enter it (the token rows live in the projection)."""
    R, D, Hc, L, O = (cfg.read_head_size, cfg.mem_dim, cfg.controller_hidden_size,
                      cfg.controller_num_layers, cfg.output_dim)
    P = sum(head_param_sizes(cfg).values())
    U, Pc = math.ceil(Hc / C), math.ceil(P / C)
    floats = (math.ceil(_row_state_floats(cfg) / 4) * 4
              + sum(4 * U * (k | 1) for k in _recurrent_rows(cfg))
              + (Pc + O) * (Hc | 1) + L * 4 * U + Pc + O
              + 2 * (R * D + L * Hc) + (NT_THREADS // 32) * 4 * U)
    return 4 * floats


# B1's routes, each counted in `launches.ntm_scan_fused.<route>`
ROUTES = ("cluster", "tile")


def scan_route(B: int, sms: int, cluster_smem: int, max_clusters: Optional[int] = None,
               C: int = CLUSTER_SIZE, max_smem: int = MAX_SMEM_BYTES) -> str:
    """B1's route: "cluster" (a cluster of C CTAs per batch row,
    csrc/scan_cell.cu) while one CTA's slices, cluster_smem bytes, fit its
    shared memory and the B clusters fit the card in CLUSTER_WAVES waves:
    B <= CLUSTER_WAVES * max_clusters, the card's
    cudaOccupancyMaxActiveClusters (15 clusters of 8 on an H100 SXM), or
    sms // C clusters where that is not known. Else "tile" (B2's forward
    tile step without residuals, csrc/scan_bptt.cu). The crossover,
    measured by chip_smoke.py's route times (NVIDIA H100 80GB HBM3 at 700 W,
    flagship config, T = 65, the projection included; cluster / tile, ms):
    0.63 / 2.14 at B = 1, 1.16-1.19 / 2.19-2.20 at B = 16 and 24 (two
    waves), 1.70-1.77 / 2.23-2.27 at B = 32 and 40 (three), 2.27 / 2.28 at
    B = 48 (four: a tie), 2.82 / 2.28 at B = 64 (five): a wave takes ~0.55
    ms, the tile route ~2.2 (PERF.md)."""
    clusters = max_clusters if max_clusters is not None else sms // C
    return "cluster" if cluster_smem <= max_smem and B <= CLUSTER_WAVES * clusters else "tile"


def route_for(cfg: NTMConfig, B: int, IN: int, device: torch.device) -> str:
    """scan_route for this config on `device`: its SM count, and where the
    slices fit, the clusters it holds at once (raises where it holds none).
    A config the cluster kernel's addressing does not take
    (addressing_supported) takes the tile route."""
    if not addressing_supported(cfg.mem_size, cfg.shift_space):
        return "tile"
    sms = _bptt().sm_count(device)
    smem = cluster_smem_bytes(cfg, IN)
    clusters = max_active_clusters(cfg, IN, device) if smem <= MAX_SMEM_BYTES else None
    return scan_route(B, sms, smem, clusters)


@functools.lru_cache(maxsize=None)
def cluster_occupancy(cfg: NTMConfig, IN: int, device: torch.device, C: int = CLUSTER_SIZE) -> Dict[str, int]:
    """What the card makes of the cluster kernel at this config:
    {"max_active_clusters" (cudaOccupancyMaxActiveClusters), "registers"
    and "local_bytes" per thread, "smem_bytes" per CTA}."""
    out = (ctypes.c_int * 4)()
    err = _library().ntm_scan_cluster_occupancy(*_dims(cfg, IN), C, device.index or 0,
                                                 ctypes.cast(out, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"scan_cell cluster occupancy query failed: CUDA error {err}")
    return dict(zip(("max_active_clusters", "registers", "local_bytes", "smem_bytes"), out))


def max_active_clusters(cfg: NTMConfig, IN: int, device: torch.device) -> int:
    """The clusters of CLUSTER_SIZE CTAs the card holds at once at this
    config; raises, with the numbers, where it holds none."""
    occ = cluster_occupancy(cfg, IN, device)
    if occ["max_active_clusters"] == 0:
        raise RuntimeError(f"the card cannot hold one cluster of {CLUSTER_SIZE} CTAs of {NT_THREADS} threads and "
                           f"{occ['smem_bytes']} B of shared memory ({occ['registers']} registers per thread): "
                           f"cudaOccupancyMaxActiveClusters is 0")
    return occ["max_active_clusters"]


def _dims(cfg: NTMConfig, IN: int) -> Tuple[int, ...]:
    return (IN, cfg.mem_size, cfg.mem_dim, cfg.num_heads, cfg.read_head_size,
            cfg.write_head_size, cfg.shift_space, cfg.controller_hidden_size,
            cfg.controller_num_layers, cfg.output_dim)


# ---- the plain versions of the routes' pieces (the tests use them) -----------

def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _is_bf16(compute_dtype: Optional[torch.dtype]) -> bool:
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"the kernels take float32 or bfloat16 compute, got {compute_dtype}")
    return compute_dtype == torch.bfloat16


def split_projection_reference(tokens: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                               compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Layer 0's token part of every step [B*T, 4Hc], as both routes take
    it: X W0[:IN] + b0 at float32 (token_projection_reference); at bf16 the
    rounded operands' product without b0, which the kernels add after
    rounding each gate's whole sum."""
    IN = tokens.shape[2]
    if _is_bf16(compute_dtype):
        return _bf16(tokens.reshape(-1, IN)) @ _bf16(kernel[:IN])
    return _bptt().token_projection_reference(tokens, kernel, bias)


def cluster_weight_slices(params: Dict[str, Any], cfg: NTMConfig, C: int) -> List[Dict[str, Any]]:
    """The cluster kernel's slices, CTA by CTA (the plain version of its
    loads). CTA r holds the hidden units r*U .. r*U + n - 1 (U = ceil(Hc /
    C); n = U but for the last CTAs, fewer or none) and the head-linear
    columns r*Pc .. (Pc = ceil(P / C); the last runs shorter or empty):
    "lstm" [4U, K_l] per layer, the recurrent kernel's gate columns
    transposed (row q*U + u holds column q*Hc + r*U + u: gate q of unit
    r*U + u; layer 0 without its token rows; rows past Hc zero), "lstm_b"
    [4U] likewise, "heads_w" [n_cols, Hc] (transposed), "heads_b",
    "units" (first, count) and "cols" (first, count)."""
    Hc = cfg.controller_hidden_size
    P = params["heads_w"].shape[1]
    U, Pc = math.ceil(Hc / C), math.ceil(P / C)
    rec = [layer["kernel"][layer["kernel"].shape[0] - k:] for layer, k in zip(params["controller"],
                                                                            _recurrent_rows(cfg))]
    slices = []
    for r in range(C):
        u0, n = r * U, max(0, min(U, Hc - r * U))
        p0, m = r * Pc, max(0, min(Pc, P - r * Pc))
        cols = torch.tensor([q * Hc + u0 + u for q in range(4) for u in range(U)])
        live = torch.tensor([u < n for q in range(4) for u in range(U)])
        cols = torch.where(live, cols, 0)

        def gate_rows(t):
            return torch.where(live, t[..., cols], torch.zeros((), dtype=t.dtype))

        slices.append({
            "lstm": [gate_rows(k).T.contiguous() for k in rec],
            "lstm_b": [gate_rows(layer["bias"]) for layer in params["controller"]],
            "heads_w": params["heads_w"][:, p0:p0 + m].T.contiguous(),
            "heads_b": params["heads_b"][p0:p0 + m],
            "units": (u0, n), "cols": (p0, m),
        })
    return slices


def cluster_weights_from_slices(slices: List[Dict[str, Any]], cfg: NTMConfig) -> Dict[str, Any]:
    """The inverse of cluster_weight_slices: {"controller": [{"kernel"
    (the recurrent rows: layer 0 without its token rows), "bias"}],
    "heads_w", "heads_b"}."""
    Hc = cfg.controller_hidden_size
    U = slices[0]["lstm"][0].shape[0] // 4
    controller = []
    for l in range(cfg.controller_num_layers):
        k = slices[0]["lstm"][l].new_zeros(slices[0]["lstm"][l].shape[1], 4 * Hc)
        b = k.new_zeros(4 * Hc)
        for sl in slices:
            u0, n = sl["units"]
            for q in range(4):
                k[:, q * Hc + u0:q * Hc + u0 + n] = sl["lstm"][l][q * U:q * U + n].T
                b[q * Hc + u0:q * Hc + u0 + n] = sl["lstm_b"][l][q * U:q * U + n]
        controller.append({"kernel": k, "bias": b})
    return {"controller": controller, "heads_w": torch.cat([sl["heads_w"].T for sl in slices], 1),
            "heads_b": torch.cat([sl["heads_b"] for sl in slices])}


def cluster_step_reference(slices, params, cfg: NTMConfig, proj_t: torch.Tensor, state,
                           compute_dtype: Optional[torch.dtype] = None):
    """One cell step as the cluster kernel splits it (the plain emulation):
    each CTA's gates from its slices (the f32 sum of the rounded operands,
    plus proj_t's row [B, 4Hc] for layer 0), its units' c and h, the h of
    every CTA gathered before the next layer; each CTA's head-linear
    columns gathered into the head controls; the logits from the output
    linear; then the addressing, read and write (the same on every CTA's
    copy, so done once here). Returns (logits [B, O], new state)."""
    bf = _is_bf16(compute_dtype)
    rnd = _bf16 if bf else (lambda t: t)
    R, W, D, H = cfg.read_head_size, cfg.write_head_size, cfg.mem_dim, cfg.num_heads
    B = proj_t.shape[0]
    read = state["read"].reshape(B, R * D)
    old = state["controller_state"]
    new_c, new_h = [], []
    for l, (c, h) in enumerate(old):
        x = rnd(torch.cat([read if l == 0 else new_h[l - 1], h], 1))
        c_parts, h_parts = [], []
        for sl in slices:
            u0, n = sl["units"]
            U = sl["lstm"][l].shape[0] // 4
            rows = [q * U + u for q in range(4) for u in range(n)]
            s = (x @ rnd(sl["lstm"][l]).T)[:, rows]
            b = sl["lstm_b"][l][rows]
            if l > 0:
                g = (rnd(s) if bf else s) + b
            else:
                p = proj_t[:, [q * cfg.controller_hidden_size + u0 + u for q in range(4) for u in range(n)]]
                g = _bf16(s + p) + b if bf else s + p
            i, j, f, o = torch.chunk(g, 4, dim=1)
            cu = c[:, u0:u0 + n] * torch.sigmoid(f) + torch.sigmoid(i) * torch.tanh(j)
            c_parts.append(cu)
            h_parts.append(torch.tanh(cu) * torch.sigmoid(o))
        new_c.append(torch.cat(c_parts, 1))
        new_h.append(torch.cat(h_parts, 1))
    ctrl = rnd(new_h[-1])

    def linear(w_t, b):
        s = ctrl @ rnd(w_t)
        return (_bf16(s) if bf else s) + b

    controls = torch.cat([linear(sl["heads_w"].T, sl["heads_b"]) for sl in slices], 1)
    logits = linear(params["out_w"], params["out_b"])
    sizes = head_param_sizes(cfg)
    k, beta, g, sw, gamma, erase, add = torch.split(controls, [sizes[n] for n in HEAD_PARAM_ORDER], dim=1)
    M, w, read = fused_ntm_addressing_reference(
        k.reshape(B, H, D), beta, g, sw.reshape(B, H, cfg.shift_space), gamma,
        erase.reshape(B, W, D), add.reshape(B, W, D), state["M"], state["w"],
        read_heads=R, write_first=cfg.write_first, slotwise=cfg.slotwise_cosine,
    )
    return logits, {"M": M, "w": w, "read": read, "controller_state": list(zip(new_c, new_h))}


def cluster_scan_reference(params, cfg: NTMConfig, tokens: torch.Tensor, state, C: int = 1,
                           compute_dtype: Optional[torch.dtype] = None):
    """T steps of cluster_step_reference at cluster size C on
    split_projection_reference's rows: the plain version of the cluster
    route. At C = 1 it is the split product alone: every step's gates are
    the token projection plus the recurrent part [read | h] W0[IN:], as
    both routes compute them. Returns (logits [B, T, O], final state)."""
    B, T, _ = tokens.shape
    layer0 = params["controller"][0]
    proj = split_projection_reference(tokens, layer0["kernel"], layer0["bias"], compute_dtype).reshape(B, T, -1)
    slices = cluster_weight_slices(params, cfg, C)
    logits = []
    with torch.no_grad():
        for t in range(T):
            logit, state = cluster_step_reference(slices, params, cfg, proj[:, t], state, compute_dtype)
            logits.append(logit)
    return torch.stack(logits, 1), state


# ---- the wrapper ----------------------------------------------------------------

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
      version; CUDA tensors run the token projection, then scan_route's
      route (run_route: counted in `launches.ntm_scan_fused`, one per
      call, and in `launches.ntm_scan_fused.<route>`), or raise.
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
    out = run_route(route_for(cfg, B, IN, device), params, cfg, tokens, state, compute_dtype)
    profiling.count("launches.ntm_scan_fused")
    return out


def _stream(device: torch.device) -> Tuple[int, int]:
    """(device index, the current stream's handle) for a launch."""
    return device.index, torch.cuda.current_stream(device).cuda_stream


def run_route(route: str, params, cfg: NTMConfig, tokens: torch.Tensor, state,
              compute_dtype: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """B1 on CUDA tensors by the given route: the token projection
    (scan_bptt.token_projection; at bf16 on the tokens and W0[:IN] rounded
    on the card, with a zero bias), then "cluster" (csrc/scan_cell.cu) or
    "tile" (csrc/scan_bptt.cu's forward without residuals, at
    forward_tile's rows per block; at bf16 on weights rounded on the card).
    Counted in `launches.ntm_scan_fused.<route>`; ntm_scan_fused
    calls it with scan_route's choice."""
    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r}")
    bf = _is_bf16(compute_dtype)
    check_inputs(params, cfg, tokens, state)
    B, T, IN = tokens.shape
    device = tokens.device
    if device.type != "cuda":
        raise ValueError(f"the routes run on cuda tensors, got {device}")
    bptt = _bptt()
    layer0 = params["controller"][0]
    if bf:
        proj = bptt.token_projection(_bf16(tokens), _bf16(layer0["kernel"]), torch.zeros_like(layer0["bias"]))
    else:
        proj = bptt.token_projection(tokens, layer0["kernel"], layer0["bias"])
    if route == "cluster":
        out = _cluster_launch(params, cfg, tokens, state, proj, bf)
    else:
        weights = params
        if bf:
            weights = dict(params, heads_w=_bf16(params["heads_w"]), out_w=_bf16(params["out_w"]),
                           controller=[dict(layer, kernel=_bf16(layer["kernel"])) for layer in params["controller"]])
        logits, final, _ = bptt._forward_launch(weights, cfg, tokens, state, proj,
                                                bptt.forward_tile(cfg, IN, B, device), residuals=False, bf16=bf)
        out = (logits, final)
    profiling.count(f"launches.ntm_scan_fused.{route}")
    return out


def _cluster_launch(params, cfg: NTMConfig, tokens: torch.Tensor, state, proj: torch.Tensor,
                    bf: bool) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Launch csrc/scan_cell.cu's cluster kernel, one cluster of
    CLUSTER_SIZE CTAs per batch row, inputs checked."""
    B, T, IN = tokens.shape
    device = tokens.device
    N, D, H = cfg.mem_size, cfg.mem_dim, cfg.num_heads
    R, Hc, L, O = cfg.read_head_size, cfg.controller_hidden_size, cfg.controller_num_layers, cfg.output_dim
    _check("proj", proj, (B * T, 4 * Hc), device)
    if not addressing_supported(N, cfg.shift_space):
        raise ValueError(f"the cluster route's addressing does not take N={N}, S={cfg.shift_space}")
    smem = cluster_smem_bytes(cfg, IN)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"a cluster of {CLUSTER_SIZE} needs {smem} B of shared memory per CTA at this config, "
                         f"above {MAX_SMEM_BYTES}")
    max_active_clusters(cfg, IN, device)
    logits = torch.empty(B, T, O, device=device)
    M = torch.empty(B, N, D, device=device)
    w = torch.empty(B, H, N, device=device)
    read = torch.empty(B, R, D, device=device)
    c_out = torch.empty(L, B, Hc, device=device)
    h_out = torch.empty(L, B, Hc, device=device)
    c0 = torch.stack([c for c, _ in state["controller_state"]])
    h0 = torch.stack([h for _, h in state["controller_state"]])
    ctrl = params["controller"]
    lstm_w = (ctypes.c_void_p * L)(*[layer["kernel"].data_ptr() for layer in ctrl])
    lstm_b = (ctypes.c_void_p * L)(*[layer["bias"].data_ptr() for layer in ctrl])
    err = _library().ntm_scan_cluster_launch(
        proj.data_ptr(), ctypes.cast(lstm_w, ctypes.c_void_p), ctypes.cast(lstm_b, ctypes.c_void_p),
        params["heads_w"].data_ptr(), params["heads_b"].data_ptr(),
        params["out_w"].data_ptr(), params["out_b"].data_ptr(),
        state["M"].data_ptr(), state["w"].data_ptr(), state["read"].data_ptr(), c0.data_ptr(), h0.data_ptr(),
        logits.data_ptr(), M.data_ptr(), w.data_ptr(), read.data_ptr(), c_out.data_ptr(), h_out.data_ptr(),
        B, T, *_dims(cfg, IN), int(cfg.write_first), int(cfg.slotwise_cosine), int(bf), CLUSTER_SIZE,
        *_stream(device),
    )
    if err != 0:
        raise RuntimeError(f"scan_cell cluster kernel launch failed: CUDA error {err}")
    final_state = {
        "M": M, "w": w, "read": read,
        "controller_state": [(c_out[l], h_out[l]) for l in range(L)],
    }
    return logits, final_state


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
