"""Training harness: the step loop with validation first, JSONL metrics and
checkpoints (counterpart of ntm_tracker_tpu/train/harness.py).

Checkpoints are `torch.save` files of {"params", "opt_state"} (any tree of
tensors) at <directory>/<step>.pt, with the reference's save_path.txt
breadcrumb naming the latest one (direct_offset_output.py:329-333).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import time
from typing import Any, Callable, Iterable, Optional

import torch

_CKPT = re.compile(r"^(\d+)\.pt$")


@dataclasses.dataclass
class MetricLogger:
    """Scalar metrics as JSON lines in <log_dir>/metrics.jsonl."""

    log_dir: str

    def __post_init__(self):
        os.makedirs(self.log_dir, exist_ok=True)
        self._f = open(os.path.join(self.log_dir, "metrics.jsonl"), "a")

    def log(self, step: int, **scalars):
        rec = {"step": step, "time": time.time()}
        for k, v in scalars.items():
            rec[k] = float(v)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


class CheckpointManager:
    """save / restore / latest_step over torch.save files."""

    def __init__(self, directory: str, max_to_keep: int = 1000):
        self._dir = os.path.abspath(directory)
        self._max_to_keep = max_to_keep
        os.makedirs(self._dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"{step}.pt")

    def steps(self) -> list:
        return sorted(int(m.group(1)) for m in map(_CKPT.match, os.listdir(self._dir)) if m)

    def save(self, step: int, state: Any):
        tmp = self._path(step) + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self._path(step))
        for old in self.steps()[:-self._max_to_keep]:
            os.remove(self._path(old))
        with open(os.path.join(self._dir, "save_path.txt"), "w") as f:
            f.write(os.path.join(self._dir, str(step)))

    def restore(self, step: Optional[int] = None, map_location=None) -> Any:
        """The saved tree of `step` (default: the latest), its tensors on
        map_location (default: where they were saved)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self._dir}")
        return torch.load(self._path(step), map_location=map_location, weights_only=True)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None


def train_loop(
    train_step: Callable,
    eval_step: Optional[Callable],
    params: Any,
    opt_state: Any,
    train_batches: Iterable,
    val_batches_fn: Optional[Callable[[], Iterable]] = None,
    *,
    log_dir: str = "./log",
    validation_interval: int = 100,
    validation_batch: int = 1,
    log_interval: int = 10,
    checkpoint: Optional[CheckpointManager] = None,
    logger: Optional[MetricLogger] = None,
    max_steps: Optional[int] = None,
    profile_steps: Optional[tuple] = None,
):
    """The reference's epoch/step loop shape: at every validation interval
    (step 0 first) validate and checkpoint, then train. Returns
    (params, opt_state, steps run). profile_steps needs utils/profiling,
    which is not ported: it raises."""
    if profile_steps is not None:
        raise NotImplementedError("profile_steps: utils/profiling is not ported (ROADMAP.md, item A16)")
    logger = logger or MetricLogger(log_dir)
    step = 0
    for batch in train_batches:
        if max_steps is not None and step >= max_steps:
            break
        if step % validation_interval == 0:
            if eval_step and val_batches_fn:
                accumu, count = 0.0, 0
                for vb in val_batches_fn():
                    aux = eval_step(params, vb)
                    accumu += float(aux["loss"])
                    count += 1
                    if count >= validation_batch:
                        break
                if count:
                    logger.log(step, val_loss=accumu / count)
            # checkpoint on the interval even with no validation split
            if checkpoint is not None:
                checkpoint.save(step, {"params": params, "opt_state": opt_state})
        params, opt_state, metrics = train_step(params, opt_state, batch)
        if step % log_interval == 0:
            logger.log(step, train_loss=metrics["loss"])
        step += 1
    return params, opt_state, step
