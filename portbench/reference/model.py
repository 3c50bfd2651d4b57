"""The plain reference of the offset tracker's train step, written in
plain PyTorch from the published model: the token serialization, the NTM
cell (ntm_cell.py, ops.py), the L2-on-tanh loss, the global-norm clip and
TF's RMSProp (direct_offset_output.py:581-626).

It imports nothing of the port and uses no kernel of its own. Weights
come from portbench/weights.py in the layout the port reads.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

@contextlib.contextmanager
def precision(tf32: bool):
    """float32 products, in TF32 on the card where `tf32` (the control's
    precision), else at full float32."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def frame_stream(tokens: torch.Tensor, indicator: Optional[torch.Tensor]) -> torch.Tensor:
    """One frame's tokens [B, F, C] -> [B, F+1, C+2] in the training order:
    each feature token [feature | 0 | target], the delimiter [0 | 1 | 0]
    last. indicator [B, F] or None (zeros)."""
    B, Fn, C = tokens.shape
    tgt = tokens.new_zeros(B, Fn, 1) if indicator is None else indicator.reshape(B, Fn, 1)
    feat = torch.cat([tokens, tokens.new_zeros(B, Fn, 1), tgt], dim=2)
    delim = tokens.new_zeros(B, 1, C + 2)
    delim[:, 0, C] = 1.0
    return torch.cat([feat, delim], dim=1)


def sequence_stream(features: torch.Tensor, indicator: torch.Tensor) -> torch.Tensor:
    """A training row's tokens [B, L, F, C] and frame 0's indicator [B, F]
    -> [B, L*(F+1), C+2] (direct_offset_output.py's serialization)."""
    B, L, Fn, C = features.shape
    frames = [frame_stream(features[:, i], indicator if i == 0 else None) for i in range(L)]
    return torch.cat(frames, dim=1)


# -- the NTM cell --------------------------------------------------------------

def _lstm(layer: Dict, x, c, h, forget_bias: float):
    gates = torch.cat([x, h], dim=1) @ layer["kernel"] + layer["bias"]
    i, j, f, o = gates.chunk(4, dim=1)
    c = c * torch.sigmoid(f + forget_bias) + torch.sigmoid(i) * torch.tanh(j)
    return torch.tanh(c) * torch.sigmoid(o), c


def _l2n(x, dim):
    return x * torch.rsqrt(torch.clamp_min((x * x).sum(dim=dim, keepdim=True), 1e-12))


def ntm_initial_state(params: Dict, n: dict, batch: int) -> Dict:
    def rep(x):
        return x[None].expand(batch, *x.shape).contiguous()

    zeros = [torch.zeros(batch, n["controller_hidden_size"], device=params["init_M"].device)
             for _ in range(2 * n["controller_num_layers"])]
    return {"M": rep(torch.tanh(params["init_M"])), "w": rep(torch.sigmoid(params["init_w"])),
            "read": rep(torch.tanh(params["init_read"])), "c": zeros[0::2], "h": zeros[1::2]}


def ntm_step(params: Dict, n: dict, x: torch.Tensor, s: Dict):
    """One NTM cell step (ntm_cell.py): the LSTM controller on [x, reads],
    the head controls, content addressing with memory rows normalized
    across slots (ops.py:147-150, as executed), interpolation, the shift
    with offsets {-2,-1,0} for 3 slots, sharpening w^g/(sum+1e-3), then
    erase/add and the reads of the previous memory."""
    B = x.shape[0]
    R, Wh, D, N = n["read_head_size"], n["write_head_size"], n["mem_dim"], n["mem_size"]
    H, S = R + Wh, 2 * n["shift_range"] + 1
    inp = torch.cat([x, s["read"].reshape(B, R * D)], dim=1)
    cs, hs = [], []
    for layer, c, h in zip(params["controller"], s["c"], s["h"]):
        inp, c = _lstm(layer, inp, c, h, 0.0)
        cs.append(c)
        hs.append(inp)
    ctl = inp @ params["heads_w"] + params["heads_b"]
    logit = inp @ params["out_w"] + params["out_b"]
    k, beta, g, sw, gamma, erase, add = torch.split(ctl, [D * H, H, H, S * H, H, D * Wh, D * Wh], dim=1)
    k = torch.tanh(k.reshape(B, H, D))
    sim = torch.einsum("bhd,bnd->bhn", _l2n(k, 2), _l2n(s["M"], 1))
    wc = torch.softmax(sim * F.softplus(beta)[..., None], dim=-1)
    g = torch.sigmoid(g)[..., None]
    wg = wc * g + s["w"] * (1 - g)
    sw = torch.softmax(sw.reshape(B, H, S), dim=-1)
    start = -((S + 1) // 2)
    wconv = sum(sw[..., j:j + 1] * torch.roll(wg, -(start + j), dims=-1) for j in range(S))
    p = torch.pow(wconv, (F.softplus(gamma) + 1.0)[..., None])
    w = p / (p.sum(dim=2, keepdim=True) + 1e-3)
    ww = w[:, R:, :, None]
    erase = torch.sigmoid(erase.reshape(B, Wh, 1, D))
    add = torch.tanh(add.reshape(B, Wh, 1, D))
    M = s["M"] * torch.prod(1 - ww * erase, dim=1) + torch.sum(ww * add, dim=1)
    read = torch.einsum("brn,bnd->brd", w[:, :R], M if n["write_first"] else s["M"])
    return logit, {"M": M, "w": w, "read": read, "c": cs, "h": hs}


# -- the core over a sequence ---------------------------------------------------

def initial_state(conf: dict, params: Dict, batch: int, device) -> Dict:
    return ntm_initial_state(params, conf["ntm"], batch)


def unroll(conf: dict, params: Dict, tokens: torch.Tensor, state: Dict):
    """The core over tokens [B, T, IN]: (logits [B, T, out], final state)."""
    logits = []
    for t in range(tokens.shape[1]):
        logit, state = ntm_step(params, conf["ntm"], tokens[:, t], state)
        logits.append(logit)
    return torch.stack(logits, dim=1), state


# -- training --------------------------------------------------------------------

def offsets_loss(conf: dict, logits: torch.Tensor, y_off: torch.Tensor, x_off: torch.Tensor) -> torch.Tensor:
    """0.5 * sum((tanh(delimiter logit) - offsets)^2) over frames 1..L-1
    (direct_offset_output.py:581-606). y_off, x_off [B, L]."""
    F1 = conf["num_features"] + 1
    B, T, out = logits.shape
    pred = torch.tanh(logits.reshape(B, T // F1, F1, out)[:, 1:, -1, :])
    target = torch.stack([y_off, x_off], dim=-1)[:, 1:]
    return 0.5 * ((pred - target) ** 2).sum()


def leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def rebuild(tree, values):
    it = iter(values)

    def go(t):
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(go(v) for v in t)
        return next(it)

    return go(tree)


def train_gradients(conf: dict, params: Dict, batch: Dict, sequence_length: int, block_rows: int,
                    need_grads: bool = True):
    """(loss, gradients as a list in leaves() order, or None without
    need_grads) of one cached-token batch, summed over blocks of
    `block_rows` rows (the loss is a sum over rows)."""
    Fn, C = conf["num_features"], conf["feature_depth"]
    feats = batch["features"].float()
    B = feats.shape[0] // sequence_length
    feats = feats.reshape(B, sequence_length, Fn, C)
    gts = batch["gts"].float().reshape(B, sequence_length, Fn)
    y_off = batch["y_offsets"].float().reshape(B, sequence_length)
    x_off = batch["x_offsets"].float().reshape(B, sequence_length)
    total, grads = 0.0, None
    for at in range(0, B, block_rows):
        rows = slice(at, min(B, at + block_rows))
        live = [p.detach().clone().requires_grad_(need_grads) for p in leaves(params)]
        tree = rebuild(params, live)
        with torch.set_grad_enabled(need_grads):
            tokens = sequence_stream(feats[rows], gts[rows, 0])
            logits, _ = unroll(conf, tree, tokens, initial_state(conf, tree, tokens.shape[0], tokens.device))
            loss = offsets_loss(conf, logits, y_off[rows], x_off[rows])
        if need_grads:
            g = torch.autograd.grad(loss, live, allow_unused=True)
            g = [torch.zeros_like(p) if gi is None else gi for p, gi in zip(live, g)]
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        total = total + loss.detach()
        del logits, loss, tokens
    return total, grads


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    return grads if norm < max_norm else [g / norm * max_norm for g in grads]


def rmsprop(opt: dict, params: List[torch.Tensor], grads: List[torch.Tensor], ms, mom):
    """tf.train.RMSPropOptimizer: ms from ones, eps inside the sqrt."""
    d, m, lr, eps = opt["decay"], opt["momentum"], opt["learning_rate"], opt["epsilon"]
    ms = [d * s + (1 - d) * g * g for s, g in zip(ms, grads)]
    mom = [m * v + lr * g / torch.sqrt(s + eps) for v, s, g in zip(mom, ms, grads)]
    return [p - v for p, v in zip(params, mom)], ms, mom
