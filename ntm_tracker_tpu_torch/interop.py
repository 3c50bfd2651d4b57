"""Carry weights between the JAX package and the port.

A flat dict of numpy arrays is the interchange format (it is also what
`np.savez` writes). NTM keys keep the JAX pytree names:
`controller[l].kernel` [in+Hc, 4Hc] (gate order i, j, f, o),
`controller[l].bias`, `heads_w`, `heads_b`, `out_w`, `out_b`,
`init_M` [N, D], `init_w` [H, N], `init_read` [R, D]. DNC keys are
`controller[0].kernel` / `.bias`, `access.interface_w`, `access.interface_b`,
`out_w` and `out_b`. VGG keys are
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

_CTRL = re.compile(r"controller\[(\d+)\]\.(kernel|bias)$")


def flatten_params(tree: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """NTM or DNC params (the JAX pytree, or the port's dict) -> flat
    float32 numpy dict: `controller[l].kernel`, a nested dict's leaves as
    `<name>.<leaf>` (the DNC's `access.interface_w`), the rest by name."""
    flat = {}
    for key, value in tree.items():
        if key == "controller":
            for layer, p in enumerate(value):
                flat[f"controller[{layer}].kernel"] = _np(p["kernel"])
                flat[f"controller[{layer}].bias"] = _np(p["bias"])
        elif isinstance(value, Mapping):
            flat.update({f"{key}.{k}": _np(v) for k, v in value.items()})
        else:
            flat[key] = _np(value)
    return flat


def params_from_flat(flat: Mapping[str, np.ndarray], device=None) -> Dict[str, Any]:
    """Flat numpy dict -> the port's NTM or DNC params (float32 tensors on
    `device`)."""
    params: Dict[str, Any] = {}
    layers: Dict[int, Dict[str, torch.Tensor]] = {}
    for key, value in flat.items():
        m = _CTRL.match(key)
        t = torch.tensor(np.asarray(value, np.float32), device=device)
        if m:
            layers.setdefault(int(m.group(1)), {})[m.group(2)] = t
        elif "." in key:
            outer, inner = key.split(".", 1)
            params.setdefault(outer, {})[inner] = t
        else:
            params[key] = t
    if sorted(layers) != list(range(len(layers))):
        raise ValueError(f"controller layers are not numbered 0..n-1: {sorted(layers)}")
    params["controller"] = [layers[i] for i in range(len(layers))]
    return params


# the two cores' trees flatten the same way
flatten_ntm_params = flatten_dnc_params = flatten_params
ntm_params_from_flat = dnc_params_from_flat = params_from_flat


def _rmsprop_trees(opt_state: Any):
    """(ms, mom) of the port's {"ms", "mom"} dict, or of the JAX package's
    optimizer state: a TFRMSPropState, or an optax chain holding one. The
    trees are shaped like the params, of either core."""
    if isinstance(opt_state, Mapping):
        return opt_state["ms"], opt_state["mom"]
    if hasattr(opt_state, "ms") and hasattr(opt_state, "mom"):
        return opt_state.ms, opt_state.mom
    for part in opt_state:
        if hasattr(part, "ms") and hasattr(part, "mom"):
            return part.ms, part.mom
    raise ValueError("no TF RMSProp state (ms, mom) found in the optimizer state")


def flatten_opt_state(opt_state: Any) -> Dict[str, np.ndarray]:
    """TF RMSProp state (the port's or the JAX package's) -> flat float32
    numpy dict with `ms/...` and `mom/...` keys."""
    ms, mom = _rmsprop_trees(opt_state)
    flat = {f"ms/{k}": v for k, v in flatten_params(ms).items()}
    flat.update({f"mom/{k}": v for k, v in flatten_params(mom).items()})
    return flat


def opt_state_from_flat(flat: Mapping[str, np.ndarray], device=None) -> Dict[str, Any]:
    """Flat numpy dict -> the port's optimizer state {"ms", "mom"}."""
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
