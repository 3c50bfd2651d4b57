"""Weights made on the card from the seed, in a few large draws of one
torch.Generator, in the parameter layout that both the port and the
reference read: the NTM cell's dict of float32 tensors, with the
published initializer, uniform(-init_scale, init_scale) with zero biases
(direct_offset_output.py:42); no checkpoint is in the repository.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench.counts import head_param_width, input_depth

SEED_MASK = (1 << 64) - 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one named stream of draws of a seed
    (any whole number: it is folded into 64 bits)."""
    return torch.Generator(device=device).manual_seed((seed * 1_000_003 + stream) & SEED_MASK)


def _split(flat: torch.Tensor, shapes: List[Tuple[int, ...]]) -> List[torch.Tensor]:
    out, at = [], 0
    for shape in shapes:
        n = 1
        for s in shape:
            n *= s
        out.append(flat[at:at + n].reshape(shape).clone())
        at += n
    return out


def ntm_weights(conf: dict, seed: int, device) -> Dict:
    n = conf["ntm"]
    hidden, scale = n["controller_hidden_size"], n["init_scale"]
    heads = n["read_head_size"] + n["write_head_size"]
    p = head_param_width(n)
    ins = [input_depth(conf) + n["read_head_size"] * n["mem_dim"]] + [hidden] * (n["controller_num_layers"] - 1)
    shapes = [(d + hidden, 4 * hidden) for d in ins]
    shapes += [(hidden, p), (hidden, n["output_dim"]), (n["mem_size"], n["mem_dim"]),
                (heads, n["mem_size"]), (n["read_head_size"], n["mem_dim"])]
    total = sum(a * b for a, b in shapes)
    flat = (torch.rand(total, generator=generator(seed, 2, device), device=device) * 2 - 1) * scale
    parts = _split(flat, shapes)
    layers = len(ins)

    def zeros(k):
        return torch.zeros(k, device=device)

    return {
        "controller": [{"kernel": parts[i], "bias": zeros(4 * hidden)} for i in range(layers)],
        "heads_w": parts[layers], "heads_b": zeros(p),
        "out_w": parts[layers + 1], "out_b": zeros(n["output_dim"]),
        "init_M": parts[layers + 2], "init_w": parts[layers + 3], "init_read": parts[layers + 4],
    }


def core_weights(conf: dict, seed: int, device) -> Dict:
    return ntm_weights(conf, seed, device)
