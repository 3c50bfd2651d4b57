"""Convert a REFERENCE DNC training checkpoint into the port's parameter
tree (counterpart of ntm_tracker_tpu/tools/convert_dnc_ckpt.py; the same
mapping and the same .npz keys, so a file written by either package loads
in the other).

The reference's DNC twin builds sonnet modules (`dnc.DNC(access_config,
controller_config, output_size, clip_value)`,
direct_offset_output_with_dnc.py:66-88) whose `tf.train.Saver` variables
are scoped by the sonnet-v1 templates:

  dnc/lstm/w_gates | b_gates         -> controller[0] kernel / bias
      (sonnet gated_rnn.LSTM: gates = [x|h] @ w + b split (i, j, f, o),
       forget_bias 1 — the exact gate math the dnccore executed-golden pins,
       tests/gen_tf_goldens.py::gen_dnc_core_goldens)
  dnc/memory_access/<head>/w | b     -> columns of access.interface_w / _b
      (the TEN interface linears of dnc/access.py:160-218; this framework
       fuses them into ONE [H, total] matrix — column blocks laid out in
       models/dnc/access._interface_sizes order)
  dnc/output_linear/w | b            -> out_w / out_b
      (dnc/dnc.py:119-122)

Names are suffix-matched, so checkpoints whose core was built under an
extra enclosing scope (e.g. `rnn/dnc/...` from tf.nn.dynamic_rnn) convert
too. Optimizer slot variables and global_step are skipped (and reported).

End-to-end proof: tests/test_tf_parity.py::test_convert_reference_dnc_checkpoint
converts a REAL Saver round trip of the executed reference DNC core and
matches its rollout at <=1e-4 (fixture from tests/gen_tf_goldens.py);
tests/test_torch_convert.py holds the port's conversion to the same golden.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

import numpy as np

from ntm_tracker_tpu_torch.config import DNCConfig
from ntm_tracker_tpu_torch.models.dnc.access import _interface_sizes

_LSTM_RE = re.compile(r"(?:^|/)lstm/(w_gates|b_gates)$")
_ACCESS_RE = re.compile(r"(?:^|/)memory_access/([a-z_]+)/(w|b)$")
_OUT_RE = re.compile(r"(?:^|/)output_linear/(w|b)$")


def classify_variable(name: str, cfg: DNCConfig) -> Optional[tuple]:
    """Checkpoint variable name -> conversion address, or None to skip."""
    m = _LSTM_RE.search(name)
    if m:
        return ("controller", 0, "kernel" if m.group(1) == "w_gates" else "bias")
    m = _ACCESS_RE.search(name)
    if m and m.group(1) in _interface_sizes(cfg):
        return ("interface", m.group(1), m.group(2))
    m = _OUT_RE.search(name)
    if m:
        return ("out_w",) if m.group(1) == "w" else ("out_b",)
    return None


def convert_dnc_variables(
    variables: Dict[str, np.ndarray], cfg: DNCConfig, verbose: bool = False
) -> Dict[str, Any]:
    """{checkpoint var name: array} -> the init_dnc_params tree."""
    H = cfg.hidden_size
    sizes = _interface_sizes(cfg)
    heads: Dict[str, Dict[str, np.ndarray]] = {}
    out: Dict[str, Any] = {}
    ctrl: Dict[str, np.ndarray] = {}
    skipped = []
    claimed: Dict[tuple, str] = {}
    for name, arr in variables.items():
        addr = classify_variable(name, cfg)
        if addr is None:
            skipped.append(name)
            continue
        if addr in claimed:
            raise ValueError(
                f"checkpoint variables {claimed[addr]!r} and {name!r} both "
                f"map to {addr}; the checkpoint layout is ambiguous"
            )
        claimed[addr] = name
        arr = np.asarray(arr, np.float32)
        if addr[0] == "controller":
            ctrl[addr[2]] = arr
        elif addr[0] == "interface":
            heads.setdefault(addr[1], {})[addr[2]] = arr
        else:
            out[addr[0]] = arr
    if verbose and skipped:
        print(f"skipped {len(skipped)} non-core variables "
              f"(optimizer slots etc.): {sorted(skipped)[:5]}...")

    # -- completeness + shape validation ---------------------------------
    for kind in ("kernel", "bias"):
        if kind not in ctrl:
            raise ValueError(
                f"checkpoint is missing the controller LSTM {kind} "
                "(expected a dnc/lstm/w_gates|b_gates variable)"
            )
    if ctrl["kernel"].shape[1] != 4 * H or ctrl["bias"].shape != (4 * H,):
        raise ValueError(
            f"controller gates shaped {ctrl['kernel'].shape}/"
            f"{ctrl['bias'].shape} do not match 4*hidden={4 * H}"
        )
    for key in ("out_w", "out_b"):
        if key not in out:
            raise ValueError(
                f"checkpoint is missing {key} (expected dnc/output_linear/"
                f"{'w' if key == 'out_w' else 'b'})"
            )
    out_in = H + cfg.num_reads * cfg.word_size
    if tuple(out["out_w"].shape) != (out_in, cfg.output_dim):
        raise ValueError(
            f"out_w: checkpoint shape {out['out_w'].shape} != config "
            f"({out_in}, {cfg.output_dim}) — check hidden_size/num_reads/"
            "word_size/output_dim match the checkpoint's flags"
        )
    w_blocks, b_blocks = [], []
    for head, size in sizes.items():  # fused column order is _interface_sizes
        if head not in heads or set(heads[head]) != {"w", "b"}:
            raise ValueError(
                f"checkpoint is missing the memory_access/{head} linear "
                f"(have {sorted(heads)})"
            )
        w, b = heads[head]["w"], heads[head]["b"]
        if w.shape != (H, size) or b.shape != (size,):
            raise ValueError(
                f"memory_access/{head}: checkpoint shapes {w.shape}/{b.shape}"
                f" != config ({H}, {size}) — check memory flags"
            )
        w_blocks.append(w)
        b_blocks.append(b)
    return {
        "controller": [dict(ctrl)],
        "access": {
            "interface_w": np.concatenate(w_blocks, axis=1),
            "interface_b": np.concatenate(b_blocks, axis=0),
        },
        "out_w": out["out_w"],
        "out_b": out["out_b"],
    }


# ---- npz round trip (inference hosts never need TensorFlow) ---------------

def save_params_npz(path: str, params: Dict[str, Any]) -> None:
    flat = {
        "access.interface_w": np.asarray(params["access"]["interface_w"]),
        "access.interface_b": np.asarray(params["access"]["interface_b"]),
        "out_w": np.asarray(params["out_w"]),
        "out_b": np.asarray(params["out_b"]),
    }
    for i, layer in enumerate(params["controller"]):
        for kind, arr in layer.items():
            flat[f"controller.{i}.{kind}"] = np.asarray(arr)
    np.savez(path, **flat)


def load_params_npz(path: str, device=None) -> Dict[str, Any]:
    """The .npz of save_params_npz (or of the JAX package's) as the port's
    parameter tree of float32 tensors on `device`."""
    import torch

    data = np.load(path)
    layers: Dict[int, Dict[str, Any]] = {}
    out: Dict[str, Any] = {"access": {}}
    for k in data.files:
        t = torch.tensor(np.asarray(data[k], np.float32), device=device)
        if k.startswith("controller."):
            _, i, kind = k.split(".")
            layers.setdefault(int(i), {})[kind] = t
        elif k.startswith("access."):
            out["access"][k.split(".", 1)[1]] = t
        else:
            out[k] = t
    out["controller"] = [layers[i] for i in sorted(layers)]
    return out


def convert_checkpoint(ckpt_path: str, cfg: DNCConfig, verbose: bool = True):
    """Read a TF checkpoint from disk (requires tensorflow) and convert."""
    try:
        from tensorflow.compat.v1.train import load_checkpoint  # lazy: TF-only step
    except ImportError as e:
        raise ImportError(
            "convert-dnc needs tensorflow to read the checkpoint; run this step on a machine with TF "
            "installed. The .npz it writes loads without TF (track-vot/validate --core dnc --dnc_npz)"
        ) from e

    reader = load_checkpoint(ckpt_path)
    variables = {
        name: reader.get_tensor(name)
        for name in reader.get_variable_to_shape_map()
    }
    return convert_dnc_variables(variables, cfg, verbose=verbose)
