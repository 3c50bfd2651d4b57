"""The system under test: the one module of the benchmark that imports the
port (`ntm_tracker_tpu_torch`). It builds the port's configuration from a
configuration file's dict and hands the entry point to the runners in
kinds/.
"""

from __future__ import annotations

import torch

from ntm_tracker_tpu_torch.config import DataConfig, NTMConfig, TrackerConfig, TrainConfig
from ntm_tracker_tpu_torch.train.experiments import OffsetExperiment

__all__ = ["OffsetExperiment", "tracker_config", "set_precision"]


def tracker_config(conf: dict, batch_size: int = 1, sequence_length: int = 20) -> TrackerConfig:
    """The port's TrackerConfig for a configuration file's dict."""
    data = dict(conf["data"])
    data["resize_hw"] = tuple(data["resize_hw"])
    opt = conf["optimizer"]
    routes = conf["routes"]
    train = TrainConfig(batch_size=batch_size, sequence_length=sequence_length,
                        learning_rate=opt["learning_rate"], decay=opt["decay"], momentum=opt["momentum"],
                        epsilon=opt["epsilon"], max_gradient_norm=opt["max_gradient_norm"],
                        fused_bptt=routes["fused_bptt"])
    return TrackerConfig(core=conf["core"], data=DataConfig(**data), train=train, ntm=NTMConfig(**conf["ntm"]),
                         num_features=conf["num_features"], feature_depth=conf["feature_depth"],
                         fast_conv43=conf["fast_conv43"], fused_inference=routes["fused_inference"],
                         compute_dtype=torch.float32)


def set_precision(conf: dict) -> None:
    """Float32 products as the configuration states them: TF32 on or off
    for matmuls and for cuDNN."""
    p = conf["precision"]
    if p["dtype"] != "float32":
        raise ValueError(f"unsupported precision {p['dtype']!r}")
    torch.backends.cuda.matmul.allow_tf32 = bool(p["tf32_matmul"])
    torch.backends.cudnn.allow_tf32 = bool(p["tf32_cudnn"])
