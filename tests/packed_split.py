"""The plain emulation of how csrc/scan_packed.cu splits a step, for the
tests: the token projection plus the recurrent product, the addressing's
phases over a tile of rows with each lane's run of slots, the shift's
shuffle plan, the write and the read as warp sums. The design tests hold
it to JAX's interpret-mode packed kernels; nothing on the card calls it.
It covers the runs (N <= ADDR_MAX_SLOTS), not the kernels' lane-per-slot
phases past them."""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from ntm_tracker_tpu_torch.config import NTMConfig
from ntm_tracker_tpu_torch.models.ntm_cell import HEAD_PARAM_ORDER, head_param_sizes
from ntm_tracker_tpu_torch.ops.kernels import scan_bptt
from ntm_tracker_tpu_torch.ops.kernels.addressing import ADDR_MAX_SLOTS, _warp_sum, addr_run
from ntm_tracker_tpu_torch.ops.lstm import multi_lstm_step
from ntm_tracker_tpu_torch.ops.memory import circular_convolution_shifts


def _lane_groups(x: torch.Tensor) -> torch.Tensor:
    """A row [..., n] as each lane's slots in the kernels' phases (a) and
    (c), a lane per four slots: [..., 32, G*4], lane l holding slots
    4l..4l+3, 128+4l.., in the order it sums them (zeros past the row)."""
    n = x.shape[-1]
    G = max(1, math.ceil(n / 128))
    x = torch.nn.functional.pad(x, (0, G * 128 - n))
    return x.reshape(*x.shape[:-1], G, 32, 4).transpose(-3, -2).reshape(*x.shape[:-1], 32, G * 4)


def _lane_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_n a[n] b[n] as a phase-(c) warp takes it: each lane's fused
    multiply-adds over its slots in order, then the butterfly warp sum."""
    ga, gb = _lane_groups(a), _lane_groups(b)
    p = ga[..., 0] * gb[..., 0]
    for i in range(1, ga.shape[-1]):
        p = p + ga[..., i] * gb[..., i]
    return _warp_sum(p)


def shifted_source(N: int, o: int, lane: int, i: int) -> Tuple[int, int]:
    """(source lane, its element) that slot lane * RL + i reads for the
    value at slot (lane * RL + i + o) mod N (RL = addr_run(N)), by the
    chains' shuffle plan (csrc/scan_packed.cu shifted_run): the forward
    shift takes the offsets o of the Python-2 shifts, its VJP the same
    offsets negated, each first taken mod N as C's % takes it (its sign
    kept), so that |o| < N. The element index is the same on every lane
    within a wrap class."""
    RL = addr_run(N)
    o = int(math.fmod(o, N))
    raw = lane * RL + i + o
    cls = 1 if raw < 0 else (-1 if raw >= N else 0)
    return ((raw + cls * N) // RL) & 31, (i + o + cls * N) % RL


def _runs(row: torch.Tensor, N: int) -> torch.Tensor:
    """A padded row [b, Np] as the chains' lanes hold it: [b, 32, RL], lane
    l the slots l*RL .. l*RL + RL - 1 (zeros past N)."""
    RL = addr_run(N)
    slots = torch.arange(32)[:, None] * RL + torch.arange(RL)
    return torch.where(slots < N, row[:, slots.clamp(max=N - 1)], row.new_zeros(()))


def _chain(cfg: NTMConfig, Mt, kt, minv, kinv, bt, gt, gm, swv, wprev):
    """Phase (b), one head over a tile of rows (csrc/scan_packed.cu
    packed_chain): Mt [b, D, N], kt [b, D], minv [b, D] (ones slotwise),
    the head's scalars [b], its shift weights [b, S], w_prev [b, N] ->
    the new weights [b, N]. Each lane holds a run of addr_run(N) slots; the
    softmax's and the sharpen's sums are warp sums of the lanes' sums, the
    shift's inputs come from the source lane's element (shift_sources)."""
    N, S = cfg.mem_size, cfg.shift_space
    RL = addr_run(N)
    n0 = torch.arange(32) * RL
    valid = (n0[:, None] + torch.arange(RL)) < N
    zero = Mt.new_zeros(())
    sim = nrm = 0.0
    for d in range(Mt.shape[1]):
        m = _runs(Mt[:, d], N)
        sim = sim + (kt[:, d] * minv[:, d])[:, None, None] * m
        nrm = nrm + m * m
    u = sim * torch.rsqrt(torch.clamp_min(nrm, 1e-12)) if cfg.slotwise_cosine else sim
    x = u * kinv[:, None, None] * bt[:, None, None]
    mx = torch.where(valid, x, zero - torch.inf).amax((1, 2), keepdim=True)
    e = torch.where(valid, torch.exp(x - mx), zero)
    wc = e * (1 / _warp_sum(e.sum(-1)))[:, None, None]
    g = gt[:, None, None]
    wg = torch.where(valid, wc * g + _runs(wprev, N) * (1 - g), zero)
    conv = torch.zeros_like(wg)
    for j, o in enumerate(circular_convolution_shifts(S)):
        src = torch.tensor([[shifted_source(N, o, lane, i) for i in range(RL)] for lane in range(32)])
        conv = conv + swv[:, j, None, None] * wg[:, src[..., 0], src[..., 1]]
    p = torch.where(valid, torch.pow(conv, gm[:, None, None]), zero)
    wn = p * (1 / (_warp_sum(p.sum(-1)) + 1e-3))[:, None, None]
    return wn.reshape(wn.shape[0], 32 * RL)[:, :N]


def _split_step(params, cfg: NTMConfig, proj_t, Mt, w, read, ctrl_state):
    """One step of a tile of rows as the kernels split it: Mt [b, D, N]."""
    b = Mt.shape[0]
    N, D, H = cfg.mem_size, cfg.mem_dim, cfg.num_heads
    R, W, S, L = cfg.read_head_size, cfg.write_head_size, cfg.shift_space, cfg.controller_num_layers
    IN = params["controller"][0]["kernel"].shape[0] - R * D - cfg.controller_hidden_size
    # the stacked LSTM, layer 0 on the projection plus [read | h_0] W0[IN:]
    layer0 = params["controller"][0]
    cut = [dict(layer0, kernel=layer0["kernel"][IN:], bias=proj_t)] + list(params["controller"][1:])
    ctrl_out, ctrl_state = multi_lstm_step(cut, read, ctrl_state)
    controls = ctrl_out @ params["heads_w"] + params["heads_b"]
    sizes = head_param_sizes(cfg)
    k, beta, g, sw, gamma, erase, add = torch.split(controls, [sizes[n] for n in HEAD_PARAM_ORDER], dim=1)
    logit = ctrl_out @ params["out_w"] + params["out_b"]
    softplus = torch.nn.functional.softplus

    # (a) per head tanh(k) and |k|^-1 (lane d's square, a warp sum), the
    # scalar controls and the shift softmax; per pair of memory rows the
    # across-slot normalizer (a lane per four slots, a warp sum); erase, add
    kt = torch.tanh(k.reshape(b, H, D))
    sq = kt * kt
    lanes = torch.nn.functional.pad(sq, (0, 32 * math.ceil(D / 32) - D)).reshape(b, H, -1, 32).sum(2)
    kinv = torch.rsqrt(torch.clamp_min(_warp_sum(lanes), 1e-12))                        # [b, H]
    if cfg.slotwise_cosine:
        minv = Mt.new_ones(b, D)
    else:
        q = _lane_groups(Mt)                                                              # [b, D, 32, 4G]
        part = 0.0
        for gi in range(0, q.shape[-1], 4):
            part = part + (q[..., gi] * q[..., gi] + (q[..., gi + 1] * q[..., gi + 1] + (
                q[..., gi + 2] * q[..., gi + 2] + q[..., gi + 3] * q[..., gi + 3])))
        minv = torch.rsqrt(torch.clamp_min(_warp_sum(part), 1e-12))                      # [b, D]
    smx = sw.reshape(b, H, S).amax(-1, keepdim=True)
    ex = torch.exp(sw.reshape(b, H, S) - smx)
    swv = ex * (1 / ex.sum(-1, keepdim=True))
    bt, gt, gm = softplus(beta), torch.sigmoid(g), softplus(gamma) + 1.0

    # (b) a chain per (row, head)
    w = torch.stack([_chain(cfg, Mt, kt[:, h], minv, kinv[:, h], bt[:, h], gt[:, h], gm[:, h], swv[:, h], w[:, h])
                     for h in range(H)], 1)                                              # [b, H, N]

    # (c) per (row, memory row d): the erase/add write, then each read
    # head's read of the old (or, write-first, the new) memory as a warp sum
    er, ad = torch.sigmoid(erase).reshape(b, W, D), torch.tanh(add).reshape(b, W, D)
    ek, ak = torch.ones_like(Mt), torch.zeros_like(Mt)
    for wh in range(W):
        ww = w[:, R + wh, None, :]
        ek = ek * (1 - ww * er[:, wh, :, None])
        ak = ak + ww * ad[:, wh, :, None]
    M_new = Mt * ek + ak
    src = M_new if cfg.write_first else Mt
    read = _lane_dot(w[:, :R, None, :], src[:, None]).reshape(b, R * D)
    return logit, M_new, w, read, ctrl_state


def packed_split_reference(
    params: Dict[str, Any],
    cfg: NTMConfig,
    tokens: torch.Tensor,
    state: Dict[str, Any],
    rows: int = 1,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The kernels' work split in plain PyTorch (csrc/scan_packed.cu,
    ntm_scan_packed's route): the token projection over all steps
    (scan_bptt.token_projection_reference), then the batch in tiles of
    `rows` rows, each step of a tile: layer 0's gates as the projection
    plus [read | h_0] W0[IN:], the other layers and the head linear; phase
    (a)'s tanh(k), |k|^-1 and normalizer from the lanes' sums; a chain per
    (row, head) with each lane a run of addr_run(N) slots, the shift's
    inputs taken as the shuffles take them; phase (c)'s erase/add write and
    the read as a warp sum of the lanes' sums. Differentiable (autograd); same arguments
    and results as ntm_scan_packed_reference."""
    B, T, IN = tokens.shape
    N, D, R = cfg.mem_size, cfg.mem_dim, cfg.read_head_size
    if N > ADDR_MAX_SLOTS:
        raise ValueError(f"the runs of slots cover 1 <= N <= {ADDR_MAX_SLOTS} slots, got N={N} (the kernels "
                         f"take more with a lane per slot, which this does not emulate)")
    layer0 = params["controller"][0]
    proj = scan_bptt.token_projection_reference(tokens, layer0["kernel"], layer0["bias"]).reshape(B, T, -1)
    out_logits, finals = [], []
    for b0 in range(0, B, rows):
        tile = slice(b0, min(B, b0 + rows))
        Mt = state["M"][tile].transpose(1, 2)
        w, read = state["w"][tile], state["read"][tile].reshape(-1, R * D)
        ctrl = [(c[tile], h[tile]) for c, h in state["controller_state"]]
        logits = []
        for t in range(T):
            logit, Mt, w, read, ctrl = _split_step(params, cfg, proj[tile, t], Mt, w, read, ctrl)
            logits.append(logit)
        out_logits.append(torch.stack(logits, 1))
        finals.append((Mt.transpose(1, 2), w, read.reshape(-1, R, D), ctrl))
    final = {"M": torch.cat([f[0] for f in finals]), "w": torch.cat([f[1] for f in finals]),
             "read": torch.cat([f[2] for f in finals]),
             "controller_state": [(torch.cat([f[3][l][0] for f in finals]), torch.cat([f[3][l][1] for f in finals]))
                                  for l in range(cfg.controller_num_layers)]}
    return torch.cat(out_logits), final
