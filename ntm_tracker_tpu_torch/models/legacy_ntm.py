"""The legacy NTM tracker (the reference's ntm.py; counterpart of
ntm_tracker_tpu/models/legacy_ntm.py).

The reference's older model, whose math differs from the newer cell
(models/ntm_cell.py):

  * a per-gate LSTM controller: separate input/forget/output/update
    linears per layer; layer 0's gate input is
    [x, target, o_prev, read_0..read_{R-1}] (ntm.py:171-213); no forget
    bias, and the cell state never enters the gates
  * separate linears per head for k/g/s_w/beta/gamma (+erase/add)
    (ntm.py:221-270)
  * the smooth cosine with the +1e-3 norm smoothing (ops.py:161-178)
  * SYMMETRIC circular-shift offsets, the gather convolution
    (ops.py:244-275)
  * the sharpen WITHOUT the +1e-3: w = w^gamma / sum(w^gamma)
    (ntm.py:259-260)
  * the target indicator is a controller input of its own, fed on step 0
    and zero afterwards (ntm.py:69-75)
  * a learnable initial state (ntm.py:273-332): tanh(M), tanh(read),
    tanh(output/hidden), softmax(read_w/write_w) from raw values that
    start at the reversed range [N..1], so the first attention peaks at
    slot 0

The JAX package writes the step unbatched and batches it with jax.vmap;
here the step is batched tensor code ([B, ...] throughout), and the
unbatched entry points add and drop a batch axis of one. The parameter
tree has the JAX names, so interop.py carries it across.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ntm_tracker_tpu_torch.ops.memory import smooth_cosine_similarity
from ntm_tracker_tpu_torch.utils.misc import circular_convolution_1d

GATES = ("input", "forget", "output", "update")


@dataclasses.dataclass(frozen=True)
class LegacyNTMConfig:
    """ntm.py:14-39 constructor defaults."""

    num_features: int = 64          # target-indicator width == output_dim
    mem_size: int = 128
    mem_dim: int = 20
    shift_range: int = 1
    controller_dim: int = 100
    controller_layer_size: int = 10
    write_head_size: int = 1
    read_head_size: int = 1

    @property
    def shift_space(self) -> int:
        return 2 * self.shift_range + 1


def init_legacy_params(cfg: LegacyNTMConfig, input_size: int, generator: Optional[torch.Generator] = None,
                       init_scale: float = 0.1, device=None) -> Dict[str, Any]:
    """Parameter tree with the JAX package's names and shapes: uniform
    (-init_scale, init_scale) weights, zero biases, the reversed-range raw
    initial weights (ops.py:112-121)."""
    C, D, N, S = cfg.controller_dim, cfg.mem_dim, cfg.mem_size, cfg.shift_space
    R, W, L = cfg.read_head_size, cfg.write_head_size, cfg.controller_layer_size

    def uniform(*shape):
        return ((2 * torch.rand(*shape, generator=generator) - 1) * init_scale).to(device)

    def zeros(n):
        return torch.zeros(n, device=device)

    controller: List[Dict[str, Dict[str, torch.Tensor]]] = []
    for layer in range(L):
        in_l = (input_size + cfg.num_features + C + R * D) if layer == 0 else 2 * C
        controller.append({g: {"w": uniform(in_l, C), "b": zeros(C)} for g in GATES})

    def head(is_write: bool) -> Dict[str, torch.Tensor]:
        p = {}
        for name, width in (("k", D), ("g", 1), ("sw", S), ("beta", 1), ("gamma", 1)):
            p[f"{name}_w"], p[f"{name}_b"] = uniform(C, width), zeros(width)
        if is_write:
            for name in ("erase", "add"):
                p[f"{name}_w"], p[f"{name}_b"] = uniform(C, D), zeros(D)
        return p

    range_init = torch.arange(N, 0, -1, dtype=torch.float32, device=device)
    read_heads = [head(False) for _ in range(R)]
    write_heads = [head(True) for _ in range(W)]
    return {
        "controller": controller,
        "read_heads": read_heads,
        "write_heads": write_heads,
        "out_w": uniform(C, cfg.num_features),
        "out_b": zeros(cfg.num_features),
        "init": {
            "M": uniform(N * D),
            "read_w": range_init.expand(R, N).clone(),
            "read": uniform(R, D),
            "write_w": range_init.expand(W, N).clone(),
            "output": uniform(L, C),
            "hidden": uniform(L, C),
        },
    }


def init_legacy_state(params: Dict[str, Any], cfg: LegacyNTMConfig, batch: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Squash the learnable raw initial state (ntm.py:273-332). batch=None
    gives the unbatched state, as JAX's; else each entry gets a leading
    batch axis (a broadcast, so gradients reach the raw params)."""
    init = params["init"]
    state = {
        "M": torch.tanh(init["M"]).reshape(cfg.mem_size, cfg.mem_dim),
        "read_w": torch.softmax(init["read_w"], dim=-1),
        "write_w": torch.softmax(init["write_w"], dim=-1),
        "read": torch.tanh(init["read"]),
        "output": torch.tanh(init["output"]),
        "hidden": torch.tanh(init["hidden"]),
    }
    if batch is None:
        return state
    return {k: v.expand(batch, *v.shape) for k, v in state.items()}


def _linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return x @ w + b


def _head_weights(p: Dict[str, torch.Tensor], M_prev: torch.Tensor, w_prev: torch.Tensor,
                  last_output: torch.Tensor) -> torch.Tensor:
    """One head's addressing chain (ntm.py:221-260), batched: M_prev
    [B,N,D], w_prev [B,N], last_output [B,C] -> [B,N]."""
    k = torch.tanh(_linear(last_output, p["k_w"], p["k_b"]))
    g = torch.sigmoid(_linear(last_output, p["g_w"], p["g_b"]))                 # [B,1]
    s_w = torch.softmax(_linear(last_output, p["sw_w"], p["sw_b"]), dim=-1)
    beta = F.softplus(_linear(last_output, p["beta_w"], p["beta_b"]))
    gamma = F.softplus(_linear(last_output, p["gamma_w"], p["gamma_b"])) + 1.0

    sim = smooth_cosine_similarity(M_prev, k)                                   # +1e-3 smoothing
    content = torch.softmax(sim * beta, dim=-1)
    gated = content * g + w_prev * (1.0 - g)
    conv = circular_convolution_1d(gated, s_w)                                  # symmetric offsets
    powed = torch.pow(conv, gamma)
    return powed / torch.sum(powed, dim=-1, keepdim=True)                      # no +1e-3 (ntm.py:260)


def _step(params: Dict[str, Any], cfg: LegacyNTMConfig, x: torch.Tensor, target: torch.Tensor,
          state: Dict[str, torch.Tensor]):
    """One batched step: x [B,IN], target [B,F], state with a batch axis."""
    M_prev = state["M"]
    B = x.shape[0]

    outputs, hiddens = [], []
    for layer, gates in enumerate(params["controller"]):
        o_prev, h_prev = state["output"][:, layer], state["hidden"][:, layer]
        if layer == 0:
            gin = torch.cat([x, target, o_prev, state["read"].reshape(B, -1)], dim=1)
        else:
            gin = torch.cat([outputs[-1], o_prev], dim=1)
        i = torch.sigmoid(_linear(gin, gates["input"]["w"], gates["input"]["b"]))
        f = torch.sigmoid(_linear(gin, gates["forget"]["w"], gates["forget"]["b"]))
        o = torch.sigmoid(_linear(gin, gates["output"]["w"], gates["output"]["b"]))
        update = torch.tanh(_linear(gin, gates["update"]["w"], gates["update"]["b"]))
        hid = f * h_prev + i * update
        outputs.append(o * torch.tanh(hid))
        hiddens.append(hid)
    last_output = outputs[-1]

    # memory (ntm.py:113-169): reads and writes both address M_prev
    read_w = torch.stack([_head_weights(p, M_prev, state["read_w"][:, r], last_output)
                          for r, p in enumerate(params["read_heads"])], dim=1)
    read = torch.einsum("bnd,brn->brd", M_prev, read_w)

    erases, writes = torch.ones_like(M_prev), torch.zeros_like(M_prev)
    write_ws = []
    for wh, p in enumerate(params["write_heads"]):
        w_w = _head_weights(p, M_prev, state["write_w"][:, wh], last_output)
        erase = torch.sigmoid(_linear(last_output, p["erase_w"], p["erase_b"]))
        add = torch.tanh(_linear(last_output, p["add_w"], p["add_b"]))
        erases = erases * (1.0 - w_w[:, :, None] * erase[:, None, :])
        writes = writes + w_w[:, :, None] * add[:, None, :]
        write_ws.append(w_w)
    M = M_prev * erases + writes

    logit = _linear(last_output, params["out_w"], params["out_b"])
    new_state = {
        "M": M, "read_w": read_w, "write_w": torch.stack(write_ws, dim=1), "read": read,
        "output": torch.stack(outputs, dim=1), "hidden": torch.stack(hiddens, dim=1),
    }
    return torch.softmax(logit, dim=-1), logit, new_state


def legacy_ntm_step(params: Dict[str, Any], cfg: LegacyNTMConfig, x: torch.Tensor, target: torch.Tensor,
                    state: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """One step: (output [..., F] softmaxed, logit [..., F], new state).
    x [IN] and target [F] with the unbatched state, as JAX's; or x [B,IN]
    and target [B,F] with a batched state."""
    if x.dim() == 2:
        return _step(params, cfg, x, target, state)
    out, logit, new = _step(params, cfg, x[None], target[None], {k: v[None] for k, v in state.items()})
    return out[0], logit[0], {k: v[0] for k, v in new.items()}


def legacy_ntm_unroll_batched(params: Dict[str, Any], cfg: LegacyNTMConfig, inputs: torch.Tensor,
                              targets: torch.Tensor, remat: bool = False):
    """The tracker over a batch of sequences (ntm.py:41-111): inputs
    [B,T,IN], targets [B,F], presented on step 0 only; the state starts
    from the learnable initial state. remat=True checkpoints each step when
    gradients are recorded (torch.utils.checkpoint for jax.checkpoint).
    Returns (outputs [B,T,F], logits [B,T,F], final state with a batch
    axis)."""
    B, T, _ = inputs.shape
    state = init_legacy_state(params, cfg, B)
    zero = torch.zeros_like(targets)
    checkpointed = remat and torch.is_grad_enabled()

    def step(x, tgt, carry):
        return _step(params, cfg, x, tgt, carry)

    outs, logits = [], []
    for t in range(T):
        tgt = targets if t == 0 else zero
        if checkpointed:
            out, logit, state = torch.utils.checkpoint.checkpoint(step, inputs[:, t], tgt, state, use_reentrant=False)
        else:
            out, logit, state = step(inputs[:, t], tgt, state)
        outs.append(out)
        logits.append(logit)
    return torch.stack(outs, dim=1), torch.stack(logits, dim=1), state


def legacy_ntm_unroll(params: Dict[str, Any], cfg: LegacyNTMConfig, inputs: torch.Tensor, target: torch.Tensor,
                      remat: bool = False):
    """Unbatched, as the reference: inputs [T,IN], target [F] ->
    (outputs [T,F], logits [T,F], final state)."""
    outs, logits, final = legacy_ntm_unroll_batched(params, cfg, inputs[None], target[None], remat=remat)
    return outs[0], logits[0], {k: v[0] for k, v in final.items()}
