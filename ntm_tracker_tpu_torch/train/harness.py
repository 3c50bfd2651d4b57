"""Training harness: the step loop with validation first, JSONL metrics and
checkpoints (counterpart of ntm_tracker_tpu/train/harness.py).

Checkpoints are `torch.save` files of {"params", "opt_state"} (any tree of
tensors) at <directory>/<step>.pt, with the reference's save_path.txt
breadcrumb naming the latest one (direct_offset_output.py:329-333). A
NamedTuple (the DNC's states) is saved as a dict of its fields, as orbax
saves it for the JAX package; a restore with a template rebuilds it.
"""

from __future__ import annotations

import contextlib
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
        torch.save(_saveable(state), tmp)
        os.replace(tmp, self._path(step))
        for old in self.steps()[:-self._max_to_keep]:
            os.remove(self._path(old))
        with open(os.path.join(self._dir, "save_path.txt"), "w") as f:
            f.write(os.path.join(self._dir, str(step)))

    def restore(self, step: Optional[int] = None, template: Any = None, partial: bool = False,
                map_location=None) -> Any:
        """The saved tree of `step` (default: the latest), its tensors on
        map_location (default: where they were saved). With a template the
        tree comes back in the template's structure, NamedTuples included,
        each tensor on its template tensor's device; the saved tree must
        have the template's keys, or with partial=True hold them (a
        subtree, such as the params without the optimizer state: the
        weights-only restore of inference)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self._dir}")
        raw = torch.load(self._path(step), map_location=map_location, weights_only=True)
        if template is None:
            return raw
        return _extract(template, raw, partial, "")

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None


def _saveable(tree: Any) -> Any:
    """The tree with every NamedTuple as a dict of its fields."""
    if isinstance(tree, dict):
        return {k: _saveable(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: _saveable(v) for f, v in zip(tree._fields, tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_saveable(v) for v in tree)
    return tree


def _extract(tmpl: Any, value: Any, partial: bool, where: str) -> Any:
    """`value` in the structure of `tmpl` (see CheckpointManager.restore)."""
    if isinstance(tmpl, dict) or (isinstance(tmpl, tuple) and hasattr(tmpl, "_fields")):
        keys = tmpl._fields if isinstance(tmpl, tuple) else list(tmpl)
        if not isinstance(value, dict):
            raise ValueError(f"restore: {where or 'the root'} is a {type(value).__name__}, the template's a mapping")
        missing = [k for k in keys if k not in value]
        extra = [k for k in value if k not in keys]
        if missing or (extra and not partial):
            raise ValueError(f"restore: at {where or 'the root'} the checkpoint lacks {missing} "
                             f"and has {extra} beyond the template (partial=True takes a subtree)")
        items = [_extract(t, value[k], partial, f"{where}/{k}")
                 for k, t in zip(keys, tmpl if isinstance(tmpl, tuple) else tmpl.values())]
        return type(tmpl)(*items) if isinstance(tmpl, tuple) else dict(zip(keys, items))
    if isinstance(tmpl, (list, tuple)):
        if not isinstance(value, (list, tuple)) or len(value) != len(tmpl):
            raise ValueError(f"restore: at {where} the template holds a sequence of {len(tmpl)}, "
                             f"the checkpoint {value!r:.80}")
        return type(tmpl)(_extract(t, v, partial, f"{where}[{i}]") for i, (t, v) in enumerate(zip(tmpl, value)))
    if isinstance(tmpl, torch.Tensor):
        if not isinstance(value, torch.Tensor) or value.shape != tmpl.shape:
            raise ValueError(f"restore: at {where} the template's tensor has shape {tuple(tmpl.shape)}, "
                             f"the checkpoint holds {getattr(value, 'shape', value)!r}")
        return value.to(tmpl.device)
    return value


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
    (params, opt_state, steps run). profile_steps=(start, stop) traces that
    window of steps with torch.profiler into <log_dir>/profile
    (utils/profiling.StepWindowProfiler), each step a named range."""
    logger = logger or MetricLogger(log_dir)
    profiler = None
    if profile_steps is not None:
        from ntm_tracker_tpu_torch.utils.profiling import StepWindowProfiler

        profiler = StepWindowProfiler(os.path.join(log_dir, "profile"), *profile_steps)
    step = 0
    try:
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
            with profiler.before_step(step) if profiler is not None else contextlib.nullcontext():
                params, opt_state, metrics = train_step(params, opt_state, batch)
            if profiler is not None:
                profiler.after_step(step)
            if step % log_interval == 0:
                logger.log(step, train_loss=metrics["loss"])
            step += 1
    finally:
        if profiler is not None:
            profiler.close()
    return params, opt_state, step
