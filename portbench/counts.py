"""Analytic operation and byte counts, and the card's peaks: the yardstick
of every roofline and MFU metric.

The counts take a configuration file's dict (configs/<name>.json) and
count the work that the shapes need, whatever implements it, so a later
change to a kernel leaves them true. Frozen copies of the port's own
counts are kept beside them (`frame_flops`, `cell_step_flops`,
`train_step_flops`: ntm_tracker_tpu_torch/benchmarks.py and
tools/profile_train.py as of this benchmark's first version), and
portbench/tests/test_portbench_counts.py pins their values.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# Dense peaks from NVIDIA's H100 data sheet (no sparsity), keyed by a
# substring of torch.cuda.get_device_name(): float32 outside the tensor
# cores (TF32 off), bf16 on them, and HBM bytes/s.
PEAKS = {
    "H100 80GB HBM3": {"float32": 67.0e12, "bfloat16": 989.4e12, "hbm_bytes_per_s": 3.35e12},  # SXM5
    "H100 PCIe": {"float32": 51.0e12, "bfloat16": 756.0e12, "hbm_bytes_per_s": 2.0e12},
}


def peaks(device_name: str) -> Dict[str, float] | None:
    """The peaks of the card named `device_name`, or None for a card the
    table does not hold."""
    for key, value in PEAKS.items():
        if key in device_name:
            return value
    return None


# VGG-16 conv1_1 .. conv4_3: (name, out channels, followed by a 2x2 pool)
VGG_CONV43: List[Tuple[str, int, bool]] = [
    ("conv1/conv1_1", 64, False), ("conv1/conv1_2", 64, True),
    ("conv2/conv2_1", 128, False), ("conv2/conv2_2", 128, True),
    ("conv3/conv3_1", 256, False), ("conv3/conv3_2", 256, False), ("conv3/conv3_3", 256, True),
    ("conv4/conv4_1", 512, False), ("conv4/conv4_2", 512, False), ("conv4/conv4_3", 512, False),
]

# The output side of each conv when the 8x8 token grid of a 224x224 crop
# is computed with VALID convs on its 204x204 receptive field (the port's
# fast path, models/vgg.vgg16_conv43_tokens): conv4_3 at 15x15, of which
# the grid takes every second row and column.
FAST_SIDES = {
    "conv1/conv1_1": 202, "conv1/conv1_2": 200,
    "conv2/conv2_1": 98, "conv2/conv2_2": 96,
    "conv3/conv3_1": 46, "conv3/conv3_2": 44, "conv3/conv3_3": 42,
    "conv4/conv4_1": 19, "conv4/conv4_2": 17, "conv4/conv4_3": 15,
}
def vgg_layers(sides: Dict[str, int] = FAST_SIDES) -> List[Tuple[int, int, int, int]]:
    """(input side, input channels, output side, output channels) of each
    conv, conv1_1 first, on one 224x224 crop."""
    out, side_in, in_ch = [], 204, 3
    for name, out_ch, pooled in VGG_CONV43:
        side = sides[name]
        out.append((side_in, in_ch, side, out_ch))
        in_ch = out_ch
        side_in = side // 2 if pooled else side
    return out


def vgg_flops(sides: Dict[str, int] = FAST_SIDES) -> float:
    """Multiply-add FLOPs (x2) of the 3x3 convs of one crop."""
    return sum(2.0 * s * s * 9 * ci * co for _, ci, s, co in vgg_layers(sides))


def head_param_width(ntm: dict) -> int:
    """Columns of the NTM's fused head linear (k, beta, g, shift, gamma for
    every head; erase and add for the write heads)."""
    h = ntm["read_head_size"] + ntm["write_head_size"]
    return ntm["mem_dim"] * h + 3 * h + (2 * ntm["shift_range"] + 1) * h + 2 * ntm["mem_dim"] * ntm["write_head_size"]


def input_depth(conf: dict) -> int:
    """Token width: the conv4_3 channels, a delimiter bit and a target bit."""
    return conf["feature_depth"] + 2


def tokens_per_frame(conf: dict) -> int:
    return conf["num_features"] + 1


def cell_step_flops(conf: dict) -> float:
    """Matmul FLOPs of one NTM cell step at batch 1 (frozen copy of
    tools/profile_train.cell_step_flops): the LSTM gates, the head and
    output linears, and the addressing's products."""
    n = conf["ntm"]
    hidden = n["controller_hidden_size"]
    ins = [input_depth(conf) + n["read_head_size"] * n["mem_dim"]] + [hidden] * (n["controller_num_layers"] - 1)
    flops = sum(2.0 * (d + hidden) * 4 * hidden for d in ins)
    flops += 2.0 * hidden * head_param_width(n)
    flops += 2.0 * hidden * n["output_dim"]
    flops += 2.0 * (n["read_head_size"] + n["write_head_size"]) * n["mem_size"] * n["mem_dim"] * 4
    return flops


def frame_flops(conf: dict) -> float:
    """Frozen copy of benchmarks.frame_flops: the fast path's convs (conv4_3
    at 15x15) and tokens_per_frame NTM cell steps. 16.21 GFLOP for
    ntm_offsets."""
    return vgg_flops(FAST_SIDES) + tokens_per_frame(conf) * cell_step_flops(conf)


def train_step_flops(conf: dict, batch: int, sequence_length: int) -> float:
    """Frozen copy of tools/profile_train.train_step_flops: 3x the forward
    cell FLOPs (forward, input gradient, weight gradient) over every token
    of every row. 1.439 TFLOP for ntm_offsets at B=256, L=20."""
    return 3.0 * cell_step_flops(conf) * sequence_length * tokens_per_frame(conf) * batch


def ntm_weight_bytes(conf: dict) -> float:
    """float32 bytes of the NTM cell's parameters."""
    n = conf["ntm"]
    hidden, layers = n["controller_hidden_size"], n["controller_num_layers"]
    ins = [input_depth(conf) + n["read_head_size"] * n["mem_dim"]] + [hidden] * (layers - 1)
    count = sum((d + hidden) * 4 * hidden + 4 * hidden for d in ins)
    p = head_param_width(n)
    count += hidden * p + p + hidden * n["output_dim"] + n["output_dim"]
    count += n["mem_size"] * n["mem_dim"] + (n["read_head_size"] + n["write_head_size"]) * n["mem_size"]
    count += n["read_head_size"] * n["mem_dim"]
    return 4.0 * count


def ntm_state_bytes(conf: dict, batch: int) -> float:
    """float32 bytes of the NTM state of `batch` rows."""
    n = conf["ntm"]
    heads = n["read_head_size"] + n["write_head_size"]
    count = n["mem_size"] * n["mem_dim"] + heads * n["mem_size"] + n["read_head_size"] * n["mem_dim"]
    count += 2 * n["controller_hidden_size"] * n["controller_num_layers"]
    return 4.0 * batch * count


def b2_counts(conf: dict, batch: int, sequence_length: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of B2 over one train step: train_step_flops, and the
    float32 tokens read once, the weights read and their gradients
    written once, the logits written and their gradients read once."""
    T = sequence_length * tokens_per_frame(conf)
    flops = train_step_flops(conf, batch, sequence_length)
    nbytes = 4.0 * batch * T * input_depth(conf) + 2 * ntm_weight_bytes(conf)
    nbytes += 2 * 4.0 * batch * T * conf["ntm"]["output_dim"] + 2 * ntm_state_bytes(conf, batch)
    return flops, nbytes


def least_seconds(flops: float, nbytes: float, card: Dict[str, float]) -> Tuple[float, str]:
    """(the least time the card could take, which of "compute" or "bytes"
    bounds it), at the float32 peak and the HBM rate."""
    t_ops, t_bytes = flops / card["float32"], nbytes / card["hbm_bytes_per_s"]
    return (t_ops, "compute") if t_ops >= t_bytes else (t_bytes, "bytes")
