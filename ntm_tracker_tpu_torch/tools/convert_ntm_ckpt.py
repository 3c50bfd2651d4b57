"""Convert a REFERENCE NTM training checkpoint into the port's parameter
tree (counterpart of ntm_tracker_tpu/tools/convert_ntm_ckpt.py; the same
mapping and the same .npz keys, so a file written by either package loads
in the other).

The reference saves TF1 `Saver` checkpoints of the `ntm_offsets` training
graph (direct_offset_output.py:260,329-333). Their variables map 1:1 onto
`models/ntm_cell.init_ntm_params`' tree:

  <root>/ntm-cell/addressing/weights|biases  -> heads_w / heads_b
      (the ONE fused head-param linear; ntm_cell.py:124-130 — note
       _linear IGNORES its scope= argument and names every variable
       weights/biases under the AMBIENT scope, ntm_cell.py:354-366)
  <root>/ntm-cell/weights|biases             -> out_w / out_b
      (the output head, created at the ntm-cell scope level, :220)
  <root>/init_state/M|w|read                 -> init_M / init_w / init_read
      (learnable initial state, raw values; squashing happens at
       init_ntm_state time on both sides, :292-308)
  .../lstm-controller/cell_i/basic_lstm_cell/kernel|bias
                                             -> controller[i] kernel/bias
      (BasicLSTMCell gate order i,j,f,o and [in+H, 4H] layout match
       ops/lstm.py exactly — pinned by the LSTMBlockCell golden; older TF
       releases named these weights/biases, accepted too)

RMSProp slot variables, global_step and anything else are skipped (and
reported). The mapping itself is pure numpy; only the CLI entry needs
TensorFlow (tf.train.load_checkpoint) to read the checkpoint files.

End-to-end proof: tests/test_tf_parity.py::test_convert_reference_checkpoint
converts a REAL Saver round-trip of the executed reference cell and matches
its rollout at <=1e-4 (fixture from tests/gen_tf_goldens.py);
tests/test_torch_convert.py holds the port's conversion to the same golden.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ntm_tracker_tpu_torch.config import NTMConfig
from ntm_tracker_tpu_torch.models.ntm_cell import head_param_sizes

_LSTM_RE = re.compile(
    r"(?:^|/)(?:cell_(\d+)/)?basic_lstm_cell/(kernel|weights|bias|biases)$"
)


def classify_variable(
    name: str, shape: Tuple[int, ...], cfg: NTMConfig
) -> Optional[tuple]:
    """Checkpoint variable name -> tree address, or None to skip."""
    if name.endswith("addressing/weights"):
        return ("heads_w",)
    if name.endswith("addressing/biases"):
        return ("heads_b",)
    if name.endswith("init_state/M"):
        return ("init_M",)
    if name.endswith("init_state/w"):
        return ("init_w",)
    if name.endswith("init_state/read"):
        return ("init_read",)
    m = _LSTM_RE.search(name)
    if m:
        layer = int(m.group(1) or 0)
        kind = "kernel" if m.group(2) in ("kernel", "weights") else "bias"
        return ("controller", layer, kind)
    # the bare output-head linear at the ntm-cell scope level: disambiguate
    # from unrelated weights by shape
    if name.endswith("weights") and tuple(shape) == (
        cfg.controller_hidden_size, cfg.output_dim,
    ):
        return ("out_w",)
    if name.endswith("biases") and tuple(shape) == (cfg.output_dim,):
        return ("out_b",)
    return None


def convert_ntm_variables(
    variables: Dict[str, np.ndarray], cfg: NTMConfig, verbose: bool = False
) -> Dict[str, Any]:
    """{checkpoint var name: array} -> the init_ntm_params tree."""
    L = cfg.controller_num_layers
    out: Dict[str, Any] = {"controller": [dict() for _ in range(L)]}
    skipped = []
    claimed: Dict[tuple, str] = {}  # tree address -> checkpoint var name
    for name, arr in variables.items():
        addr = classify_variable(name, np.shape(arr), cfg)
        if addr is None:
            skipped.append(name)
            continue
        if addr in claimed:
            # e.g. an unrelated same-shape '*weights' variable matching the
            # output-head shape fallback: last-write-wins would silently
            # substitute the real head, and the completeness check below
            # could never notice — fail loudly instead
            raise ValueError(
                f"checkpoint variables {claimed[addr]!r} and {name!r} both "
                f"map to tree address {addr}; the checkpoint layout is "
                f"ambiguous (is an unrelated variable shaped like the "
                f"output head?)"
            )
        claimed[addr] = name
        arr = np.asarray(arr, np.float32)
        if addr[0] == "controller":
            _, layer, kind = addr
            if layer >= L:
                raise ValueError(
                    f"{name}: controller layer {layer} but config has {L}"
                )
            out["controller"][layer][kind] = arr
        else:
            out[addr[0]] = arr
    if verbose and skipped:
        print(f"skipped {len(skipped)} non-cell variables "
              f"(optimizer slots etc.): {sorted(skipped)[:5]}...")

    # completeness + shape validation against the config
    Hc, P = cfg.controller_hidden_size, sum(head_param_sizes(cfg).values())
    expect = {
        "heads_w": (Hc, P),
        "heads_b": (P,),
        "out_w": (Hc, cfg.output_dim),
        "out_b": (cfg.output_dim,),
        "init_M": (cfg.mem_size, cfg.mem_dim),
        "init_w": (cfg.num_heads, cfg.mem_size),
        "init_read": (cfg.read_head_size, cfg.mem_dim),
    }
    for key, shape in expect.items():
        if key not in out:
            raise ValueError(f"checkpoint is missing the {key} variable "
                             f"(expected suffix map in module docstring)")
        if tuple(out[key].shape) != shape:
            raise ValueError(
                f"{key}: checkpoint shape {out[key].shape} != config {shape}"
            )
    for i, layer in enumerate(out["controller"]):
        for kind in ("kernel", "bias"):
            if kind not in layer:
                raise ValueError(f"controller layer {i} missing {kind}")
        if layer["kernel"].shape[1] != 4 * Hc:
            raise ValueError(
                f"controller {i} kernel {layer['kernel'].shape} does not "
                f"match 4*hidden={4 * Hc}"
            )
    return out


# ---- npz round trip (so inference hosts never need TensorFlow) ------------

def save_params_npz(path: str, params: Dict[str, Any]) -> None:
    flat = {}
    for k, v in params.items():
        if k == "controller":
            for i, layer in enumerate(v):
                for kind, arr in layer.items():
                    flat[f"controller.{i}.{kind}"] = np.asarray(arr)
        else:
            flat[k] = np.asarray(v)
    np.savez(path, **flat)


def load_params_npz(path: str, device=None) -> Dict[str, Any]:
    """The .npz of save_params_npz (or of the JAX package's) as the port's
    parameter tree of float32 tensors on `device`."""
    import torch

    data = np.load(path)
    layers: Dict[int, Dict[str, Any]] = {}
    out: Dict[str, Any] = {}
    for k in data.files:
        t = torch.tensor(np.asarray(data[k], np.float32), device=device)
        if k.startswith("controller."):
            _, i, kind = k.split(".")
            layers.setdefault(int(i), {})[kind] = t
        else:
            out[k] = t
    out["controller"] = [layers[i] for i in sorted(layers)]
    return out


def convert_checkpoint(ckpt_path: str, cfg: NTMConfig, verbose: bool = True):
    """Read a TF checkpoint from disk (requires tensorflow) and convert."""
    try:
        from tensorflow.compat.v1.train import load_checkpoint  # lazy: TF-only step
    except ImportError as e:
        raise ImportError(
            "convert-ntm needs tensorflow to read the checkpoint; run this step on a machine with TF "
            "installed. The .npz it writes loads without TF (track-vot/validate --ntm_npz)"
        ) from e

    reader = load_checkpoint(ckpt_path)
    variables = {
        name: reader.get_tensor(name)
        for name in reader.get_variable_to_shape_map()
    }
    return convert_ntm_variables(variables, cfg, verbose=verbose)


def validate_params_like(params: Dict[str, Any], template: Dict[str, Any],
                         flag: str = "--ntm_npz") -> None:
    """Loaded params must match the model's template tree structurally
    and shape-for-shape — fail fast with a named message instead of an
    opaque shape error deep in the cell (used by --ntm_npz and
    --dnc_npz loads; `flag` names the offending option in errors)."""
    from ntm_tracker_tpu_torch.interop import flatten_params

    p_paths = {k: tuple(np.shape(v)) for k, v in flatten_params(params).items()}
    t_paths = {k: tuple(np.shape(v)) for k, v in flatten_params(template).items()}
    missing = sorted(set(t_paths) - set(p_paths))
    extra = sorted(set(p_paths) - set(t_paths))
    if missing or extra:
        raise ValueError(
            f"{flag} params do not match the model config: "
            f"missing {missing or 'none'}, unexpected {extra or 'none'} "
            f"(check the model flags match the converted checkpoint's)"
        )
    for k in t_paths:
        if p_paths[k] != t_paths[k]:
            raise ValueError(
                f"{flag} {k}: shape {p_paths[k]} != model config "
                f"{t_paths[k]} (check mem_size/mem_dim/hidden_size/"
                f"read_head_size/... match the converted checkpoint's)"
            )
