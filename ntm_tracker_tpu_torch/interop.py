"""Carry weights between the JAX package and the port.

A flat dict of numpy arrays is the interchange format (it is also what
`np.savez` writes). Parameter keys are the JAX pytree's paths, a dict's
entries joined by `.` and a list's indexed `[i]`: the NTM's
`controller[l].kernel` [in+Hc, 4Hc] (gate order i, j, f, o),
`controller[l].bias`, `heads_w`, `heads_b`, `out_w`, `out_b`,
`init_M` [N, D], `init_w` [H, N], `init_read` [R, D]; the DNC's
`controller[0].kernel` / `.bias`, `access.interface_w`,
`access.interface_b`, `out_w` and `out_b` (the repeat-copy DNC's too);
the legacy NTM's `controller[l].<gate>.w` / `.b`, `read_heads[r].k_w`, ...,
`write_heads[w].erase_w`, ..., `init.M`, ...; the lab's trees nest a core's
under `core.` beside `compressor` [C, D], or the LSTM baseline's
`lstm.lstm[l].kernel` / `.bias` and `lstm.softmax_w` / `_b` beside it. VGG keys are
`<layer>/weights` in the JAX package's HWIO layout and `<layer>/biases`
(`conv1/conv1_1/weights`, ...); the port holds VGG weights as OIHW.
Optimizer state (TF RMSProp's `ms` and `mom`, trees shaped like the
params of either core) flattens to `ms/<param key>` and `mom/<param key>`.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

_PATH = re.compile(r"([^.\[\]]+)|\[(\d+)\]")


def flatten_params(tree: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A parameter tree (the JAX pytree, or the port's: nested dicts and
    lists of arrays) -> flat float32 numpy dict keyed by path: a dict's
    entries as `<outer>.<inner>`, a list's as `<name>[i]`
    (`controller[0].kernel`, `access.interface_w`, `core.heads_w`,
    `read_heads[1].k_w`, `controller[0].input.w`)."""
    flat: Dict[str, np.ndarray] = {}

    def walk(prefix: str, value: Any) -> None:
        if isinstance(value, Mapping):
            for k, v in value.items():
                walk(f"{prefix}.{k}" if prefix else str(k), v)
        elif isinstance(value, (list, tuple)):
            for i, v in enumerate(value):
                walk(f"{prefix}[{i}]", v)
        else:
            flat[prefix] = _np(value)

    walk("", tree)
    return flat


def params_from_flat(flat: Mapping[str, np.ndarray], device=None) -> Dict[str, Any]:
    """Flat numpy dict -> the port's parameter tree (float32 tensors on
    `device`): the inverse of flatten_params. A list's entries must be
    numbered 0..n-1."""
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = [name if name else int(index) for name, index in _PATH.findall(key)]
        node = root
        for part, nxt in zip(parts[:-1], parts[1:]):
            node = node.setdefault(part, {} if isinstance(nxt, str) else _Indexed())
        node[parts[-1]] = torch.tensor(np.asarray(value, np.float32), device=device)
    return _lists(root, "")


class _Indexed(dict):
    """A list's entries by index, while params_from_flat fills them in."""


def _lists(node: Any, where: str) -> Any:
    """The tree with each _Indexed node as a list."""
    if not isinstance(node, dict):
        return node
    if isinstance(node, _Indexed):
        if sorted(node) != list(range(len(node))):
            raise ValueError(f"{where or 'the root'}: list entries are not numbered 0..n-1: {sorted(node)}")
        return [_lists(node[i], f"{where}[{i}]") for i in range(len(node))]
    return {k: _lists(v, f"{where}.{k}" if where else k) for k, v in node.items()}


# the cores' trees flatten the same way
flatten_ntm_params = flatten_dnc_params = flatten_params
ntm_params_from_flat = dnc_params_from_flat = params_from_flat


def _rmsprop_trees(opt_state: Any):
    """(ms, mom) of the port's {"ms", "mom"} dict, or of the JAX package's
    optimizer state: a TFRMSPropState, or an optax chain holding one (as
    orbax restores it, the state a {"ms", "mom"} dict in a list). The trees
    are shaped like the params, of either core."""
    if isinstance(opt_state, Mapping):
        return opt_state["ms"], opt_state["mom"]
    if hasattr(opt_state, "ms") and hasattr(opt_state, "mom"):
        return opt_state.ms, opt_state.mom
    for part in opt_state:
        if hasattr(part, "ms") and hasattr(part, "mom"):
            return part.ms, part.mom
        if isinstance(part, Mapping) and "ms" in part and "mom" in part:  # a chain read back from orbax
            return part["ms"], part["mom"]
    raise ValueError("no TF RMSProp state (ms, mom) found in the optimizer state")


def flatten_opt_state(opt_state: Any) -> Dict[str, np.ndarray]:
    """TF RMSProp state (the port's or the JAX package's) -> flat float32
    numpy dict with `ms/...` and `mom/...` keys."""
    ms, mom = _rmsprop_trees(opt_state)
    flat = {f"ms/{k}": v for k, v in flatten_params(ms).items()}
    flat.update({f"mom/{k}": v for k, v in flatten_params(mom).items()})
    return flat


def opt_state_from_flat(flat: Mapping[str, np.ndarray], device=None) -> Dict[str, Any]:
    """Flat numpy dict -> the port's optimizer state {"ms", "mom"}, each
    shaped like the params."""
    out = {}
    for name in ("ms", "mom"):
        prefix = f"{name}/"
        out[name] = params_from_flat(
            {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}, device
        )
    return out


def flatten_vgg_params(tree: Mapping[str, Mapping[str, Any]], layout: str = "HWIO") -> Dict[str, np.ndarray]:
    """VGG params -> flat numpy dict in HWIO. layout names the weights'
    layout in `tree`: "HWIO" for the JAX package's, "OIHW" for the port's."""
    if layout not in ("HWIO", "OIHW"):
        raise ValueError(f"layout must be HWIO or OIHW, got {layout!r}")
    flat = {}
    for name, p in tree.items():
        w = _np(p["weights"])
        flat[f"{name}/weights"] = w if layout == "HWIO" else w.transpose(2, 3, 1, 0)
        flat[f"{name}/biases"] = _np(p["biases"])
    return flat


def vgg_params_from_flat(flat: Mapping[str, np.ndarray], device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Flat HWIO numpy dict -> the port's VGG params (OIHW tensors)."""
    params: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, value in flat.items():
        name, kind = key.rsplit("/", 1)
        arr = np.asarray(value, np.float32)
        if kind == "weights":
            arr = np.ascontiguousarray(arr.transpose(3, 2, 0, 1))
        elif kind != "biases":
            raise ValueError(f"unexpected VGG key {key!r}")
        params.setdefault(name, {})[kind] = torch.tensor(arr, device=device)
    return params


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)
