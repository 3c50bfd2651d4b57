"""Typed configuration, field for field the one of ntm_tracker_tpu/config.py.

Same dataclasses, fields and defaults; `TrackerConfig.compute_dtype` is a
torch dtype.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class NTMConfig:
    """NTM cell hyper-parameters (ntm_cell.py:18-50, direct_offset_output.py:21-27)."""

    output_dim: int = 2
    mem_size: int = 128
    mem_dim: int = 20
    shift_range: int = 1
    controller_hidden_size: int = 200
    controller_num_layers: int = 1
    read_head_size: int = 4
    write_head_size: int = 1
    write_first: bool = False
    init_scale: float = 0.05  # direct_offset_output.py:42
    # each cell step's addressing and memory update through the single-step
    # kernel ops/kernels/addressing.py (csrc/addressing.cu on cuda; the JAX
    # package's ops/pallas/addressing.py); the whole-sequence kernels ignore it
    use_pallas: bool = False
    # False reproduces the reference's EXECUTED content addressing, which
    # l2-normalizes each mem_dim row ACROSS slots (ops.py:147-150); True is
    # the slot-vector cosine
    slotwise_cosine: bool = False

    @property
    def num_heads(self) -> int:
        return self.read_head_size + self.write_head_size

    @property
    def shift_space(self) -> int:
        return 2 * self.shift_range + 1


@dataclasses.dataclass(frozen=True)
class DNCConfig:
    """DNC core hyper-parameters (dnc/dnc.py:42-76, direct_offset_output_with_dnc.py:22-30)."""

    output_dim: int = 2
    memory_size: int = 128
    word_size: int = 20
    num_reads: int = 4
    num_writes: int = 1
    hidden_size: int = 200
    clip_value: float = 20.0
    # checkpoint chunks of C steps in training (models/dnc/dnc.dnc_unroll);
    # None is the port's auto, 0: one saved state per step
    remat_chunk: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Data-layer geometry (preprocess.py:514-526, direct_offset_output.py:44-46)."""

    cropbox_grid: int = 8
    bbox_grid: int = 6
    # an INT on purpose: the reference floor-divides bbox_grid // focus
    # (see data/geometry.generate_gt)
    focus: int = 4
    gt_width: int = 8
    crop_size: int = 224
    resize_hw: Tuple[int, int] = (720, 1280)
    deform_threshold: float = 0.1
    zoom_threshold: float = 0.1


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-loop knobs (direct_offset_output.py:30-48,611-626)."""

    batch_size: int = 1
    sequence_length: int = 20
    learning_rate: float = 1e-4
    decay: float = 0.95
    momentum: float = 0.9
    epsilon: float = 1e-10      # TF RMSPropOptimizer default
    max_gradient_norm: float = 5.0
    num_epochs: int = 1
    log_interval: int = 10
    validation_interval: int = 100
    validation_batch: int = 1
    seed: int = 42
    scan_unroll: int = 1
    remat_policy: str = "full"
    scan_layout: str = "nd"
    fused_bptt: bool | str = "auto"


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Assembled experiment config for the offset tracker."""

    core: str = "ntm"  # "ntm" | "dnc"
    ntm: NTMConfig = dataclasses.field(default_factory=NTMConfig)
    dnc: DNCConfig = dataclasses.field(default_factory=DNCConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    num_features: int = 64      # 8x8 conv4_3 subsample
    feature_depth: int = 512    # conv4_3 channels
    # (y,x) grid points on the endpoint feature map; None = the canonical
    # conv43 8x8 grid
    feature_points: Optional[Tuple[Tuple[int, int], ...]] = None
    # matmul dtype of the cell and the VGG; params are always float32
    compute_dtype: torch.dtype = torch.float32
    # frame-step cell route: None = auto (the fused kernel at B=1 on cuda,
    # the plain loop otherwise), False = the plain loop, True = the fused
    # kernel (NTM core only)
    fused_inference: Optional[bool] = None
    # float32 matmul precision for the plain loop's cell steps
    # (torch.set_float32_matmul_precision values); None = leave as set.
    # "auto" never routes around it to the kernel.
    cell_matmul_precision: Optional[str] = None
    # conv4_3 tokens from the 204x204 receptive-field slice (exact)
    fast_conv43: bool = True
    # the int8 VGG serving mode (models/vgg_int8.py)
    vgg_int8: bool = False
    # the beyond-reference scale head: a third tanh output ds scales the
    # decoded box by exp(ds * scale_range)
    predict_scale: bool = False
    scale_range: float = 0.15

    @property
    def head_dim(self) -> int:
        """Output-head width the pipelines expect from the active core."""
        return 3 if self.predict_scale else 2

    @property
    def input_depth(self) -> int:
        # 512 + frame-delimiter bit + target-indicator bit
        return self.feature_depth + 2

    @property
    def tokens_per_frame(self) -> int:
        return self.num_features + 1

    @property
    def total_steps(self) -> int:
        return self.train.sequence_length * self.tokens_per_frame


def validate_head(cfg: TrackerConfig) -> None:
    """Fail fast when the active core's output layer does not match the
    decode contract (2 = offsets head, 3 = predict_scale head)."""
    core_cfg = cfg.ntm if cfg.core == "ntm" else cfg.dnc
    if core_cfg.output_dim != cfg.head_dim:
        raise ValueError(
            f"{cfg.core} output_dim={core_cfg.output_dim} but "
            f"predict_scale={cfg.predict_scale} needs {cfg.head_dim} "
            "(set NTMConfig/DNCConfig output_dim to match)"
        )


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: cuda unless the caller names
    another. Raises when cuda is asked for (or implied) and absent; an
    entry point never moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return dev


@contextlib.contextmanager
def float32_matmul_precision(precision: Optional[str]):
    """Set torch.set_float32_matmul_precision for the block (None: leave
    it as set); "highest" keeps float32 products out of TF32."""
    if precision is None:
        yield
        return
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(precision)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)
