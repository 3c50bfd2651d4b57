"""Standalone DNC repeat-copy trainer (counterpart of
ntm_tracker_tpu/train/dnc_trainer.py; the reference's dnc/train.py).

Its defaults: memory 16x16, 1 read and 1 write head, LSTM-64, batch 16,
global-norm clip 50, then TF RMSProp (lr 1e-4, decay 0.9, momentum 0, eps
1e-10), a report every 100 iterations (dnc/train.py:30-66). Training
resumes from the latest checkpoint in checkpoint_dir when checkpointing
is on (the reference's CheckpointSaverHook, :130-144). The DNC is plain
PyTorch (no kernel serves it); the trainer runs on cuda unless the caller
passes another device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ntm_tracker_tpu_torch.config import DNCConfig, resolve_device
from ntm_tracker_tpu_torch.models.dnc.dnc import dnc_unroll, init_dnc_params
from ntm_tracker_tpu_torch.models.dnc.repeat_copy import RepeatCopy, masked_sigmoid_cross_entropy
from ntm_tracker_tpu_torch.train.optim import TFRMSProp, tree_leaves, tree_map


@dataclasses.dataclass
class RepeatCopyTrainConfig:
    """dnc/train.py:30-66 defaults."""

    hidden_size: int = 64
    memory_size: int = 16
    word_size: int = 16
    num_write_heads: int = 1
    num_read_heads: int = 1
    clip_value: float = 20.0
    max_grad_norm: float = 50.0
    learning_rate: float = 1e-4
    optimizer_epsilon: float = 1e-10
    batch_size: int = 16
    num_bits: int = 4
    min_length: int = 1
    max_length: int = 2
    min_repeats: int = 1
    max_repeats: int = 2
    num_training_iterations: int = 100_000
    report_interval: int = 100
    checkpoint_interval: int = -1  # -1 disables, like the flag default
    checkpoint_dir: str = "/tmp/tf/dnc"
    seed: Optional[int] = None


def repeat_copy_setup(cfg: RepeatCopyTrainConfig, device=None):
    """(task, DNC config, initial params on `device`, optimizer): the params
    drawn from torch.Generator().manual_seed(seed or 0) on the CPU, so every
    device starts from the same weights."""
    task = RepeatCopy(num_bits=cfg.num_bits, batch_size=cfg.batch_size, min_length=cfg.min_length,
                      max_length=cfg.max_length, min_repeats=cfg.min_repeats, max_repeats=cfg.max_repeats,
                      seed=cfg.seed)
    dcfg = DNCConfig(output_dim=task.target_size, memory_size=cfg.memory_size, word_size=cfg.word_size,
                     num_reads=cfg.num_read_heads, num_writes=cfg.num_write_heads, hidden_size=cfg.hidden_size,
                     clip_value=cfg.clip_value)
    params = init_dnc_params(dcfg, task.obs_size, torch.Generator().manual_seed(cfg.seed or 0), device)
    # tf.train.RMSPropOptimizer's defaults after the clip: decay 0.9,
    # momentum 0 (dnc/train.py:123-124 passes only lr and epsilon)
    opt = TFRMSProp(cfg.learning_rate, decay=0.9, momentum=0.0, epsilon=cfg.optimizer_epsilon,
                    max_gradient_norm=cfg.max_grad_norm)
    return task, dcfg, params, opt


def repeat_copy_loss(params, dcfg: DNCConfig, batch, device) -> torch.Tensor:
    """The masked loss of one sampled batch (dynamic_rnn time-major,
    dnc/train.py:80-85)."""
    obs, targ, mask = (torch.as_tensor(x, device=device) for x in batch)
    logits, _ = dnc_unroll(params, dcfg, obs, time_major=True)
    return masked_sigmoid_cross_entropy(logits, targ, mask)


def train_repeat_copy(cfg: RepeatCopyTrainConfig = RepeatCopyTrainConfig(), num_iterations: Optional[int] = None,
                      log=print, device=None):
    """Train the DNC on repeat-copy; returns (params, losses)."""
    dev = resolve_device(device)
    task, dcfg, params, opt = repeat_copy_setup(cfg, dev)
    opt_state = opt.init(params)

    ckpt, start_iter = None, 0
    if cfg.checkpoint_interval > 0:
        from ntm_tracker_tpu_torch.train.harness import CheckpointManager

        ckpt = CheckpointManager(cfg.checkpoint_dir, max_to_keep=5)
        latest = ckpt.latest_step()
        if latest is not None:
            restored = ckpt.restore(latest, template={"params": params, "opt_state": opt_state})
            params, opt_state, start_iter = restored["params"], restored["opt_state"], latest
            log(f"resumed from checkpoint step {latest}")

    def step(p, s, batch):
        live = tree_map(lambda t: t.detach().requires_grad_(), p)
        loss = repeat_copy_loss(live, dcfg, batch, dev)
        grads = torch.autograd.grad(loss, tree_leaves(live), allow_unused=True)
        fill = iter([torch.zeros_like(t) if g is None else g for t, g in zip(tree_leaves(p), grads)])
        p, s = opt.update(tree_map(lambda _: next(fill), p), s, p)
        return p, s, loss.detach()

    total = num_iterations if num_iterations is not None else cfg.num_training_iterations
    losses, accum = [], 0.0
    for it in range(start_iter, total):
        batch = task.sample()
        params, opt_state, loss = step(params, opt_state, batch)
        accum += float(loss)
        losses.append(float(loss))
        if (it + 1) % cfg.report_interval == 0:
            # a human-readable obs / target / model-output sample with
            # every report (dnc/train.py:151-156)
            with torch.no_grad():
                logits, _ = dnc_unroll(params, dcfg, torch.as_tensor(batch.observations, device=dev),
                                       time_major=True)
            rounded = torch.round(torch.sigmoid(logits)).cpu().numpy() * batch.mask[..., None]
            sample = task.to_human_readable(batch, rounded)
            log(f"{it + 1}: avg training loss {accum / cfg.report_interval:.4f}\n{sample}")
            accum = 0.0
        if ckpt is not None and (it + 1) % cfg.checkpoint_interval == 0:
            ckpt.save(it + 1, {"params": params, "opt_state": opt_state})
    return params, losses
