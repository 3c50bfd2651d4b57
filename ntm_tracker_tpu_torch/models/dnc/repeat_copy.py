"""Repeat-copy task: the DNC's unit-of-work benchmark (counterpart of
ntm_tracker_tpu/models/dnc/repeat_copy.py; the reference's
dnc/repeat_copy.py).

A host-side numpy sampler draws fixed-max-shape batches from a seeded
np.random.RandomState in the JAX package's order, so both packages sample
the same batches from the same seed; the mask (:334-340) carries the
variable lengths. Layout is the reference's, time-major [T, B, C]:
  obs channels  = num_bits + start marker + normalized num-repeats (:261-266)
  targ channels = num_bits + end marker
  mask[t, b] = 1 iff the prediction at (t, b) is penalized
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch


class DatasetTensors(NamedTuple):
    observations: np.ndarray  # [T, B, num_bits+2]
    target: np.ndarray        # [T, B, num_bits+1]
    mask: np.ndarray          # [T, B]


@dataclasses.dataclass
class RepeatCopy:
    """Host-side generator of repeat-copy batches (dnc/repeat_copy.py:115-392)."""

    num_bits: int = 6
    batch_size: int = 1
    min_length: int = 1
    max_length: int = 1
    min_repeats: int = 1
    max_repeats: int = 2
    norm_max: float = 10.0
    log_prob_in_bits: bool = False
    time_average_cost: bool = False
    seed: Optional[int] = None

    def __post_init__(self):
        self._rng = np.random.RandomState(self.seed)

    @property
    def target_size(self) -> int:
        return self.num_bits + 1

    @property
    def obs_size(self) -> int:
        return self.num_bits + 2

    @property
    def max_total_length(self) -> int:
        # total = sub_len * (reps + 1) + 3 (:275)
        return self.max_length * (self.max_repeats + 1) + 3

    def _normalise(self, val):
        return val / self.norm_max

    def _unnormalise(self, val):
        return val * self.norm_max

    def sample(self) -> DatasetTensors:
        """One batch with static shape [max_total_length, B, C]."""
        T, B = self.max_total_length, self.batch_size
        full_obs, full_targ = self.obs_size, self.target_size
        start_flag_idx, reps_channel_idx = full_obs - 2, full_obs - 1

        obs = np.zeros((T, B, full_obs), np.float32)
        targ = np.zeros((T, B, full_targ), np.float32)
        mask = np.zeros((T, B), np.float32)
        for b in range(B):
            sub_len = self._rng.randint(self.min_length, self.max_length + 1)
            reps = self._rng.randint(self.min_repeats, self.max_repeats + 1)
            pattern = self._rng.randint(0, 2, size=(sub_len, self.num_bits)).astype(np.float32)

            # observation: start flag, pattern, num-repeats flag (:307-320)
            obs[0, b, start_flag_idx] = 1.0
            obs[1:1 + sub_len, b, :self.num_bits] = pattern
            obs[1 + sub_len, b, reps_channel_idx] = self._normalise(float(reps))
            obs_end = sub_len + 2

            # target: the pattern repeated, then the end flag, from obs_end
            # (:322-339); the mask covers that span (:334-336)
            rep_len = sub_len * reps
            targ[obs_end:obs_end + rep_len, b, :self.num_bits] = np.tile(pattern, (reps, 1))
            targ[obs_end + rep_len, b, self.target_size - 1] = 1.0
            mask[obs_end:obs_end + rep_len + 1, b] = 1.0
        return DatasetTensors(obs, targ, mask)

    def cost(self, logits, targ, mask):
        return masked_sigmoid_cross_entropy(logits, targ, mask, time_average=self.time_average_cost,
                                            log_prob_in_bits=self.log_prob_in_bits)

    def to_human_readable(self, data: DatasetTensors, model_output=None, whole_batch=False) -> str:
        obs = np.asarray(data.observations)
        reps_flag = np.round(self._unnormalise(obs[:, :, -1:]))
        obs = np.concatenate([obs[:, :, :-1], reps_flag], axis=2)
        return bitstring_readable(data._replace(observations=obs), self.batch_size, model_output, whole_batch)


def masked_sigmoid_cross_entropy(logits: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                                 time_average: bool = False, log_prob_in_bits: bool = False) -> torch.Tensor:
    """Masked Bernoulli NLL (dnc/repeat_copy.py:29-66), time-major [T,B,C]."""
    # sigmoid xent: max(x, 0) - x z + log1p(exp(-|x|))
    xent = torch.clamp_min(logits, 0) - logits * target + torch.log1p(torch.exp(-torch.abs(logits)))
    loss_batch = torch.sum(torch.sum(xent, dim=2) * mask, dim=0)
    if time_average:
        loss_batch = loss_batch / (torch.sum(mask, dim=0) + np.finfo(np.float32).eps)
    loss = torch.sum(loss_batch) / logits.shape[1]
    if log_prob_in_bits:
        loss = loss / np.log(2.0)
    return loss


def bitstring_readable(data: DatasetTensors, batch_size: int, model_output=None, whole_batch=False) -> str:
    """ASCII view of a batch (dnc/repeat_copy.py:69-112)."""

    def _readable(datum):
        return "+" + " ".join(["-" if x == 0 else "%d" % x for x in datum]) + "+"

    obs_batch, targ_batch = np.asarray(data.observations), np.asarray(data.target)
    batch_strings = []
    for b in range(batch_size) if whole_batch else range(1):
        obs, targ = obs_batch[:, b, :], targ_batch[:, b, :]
        strings = [
            "Observations:\n" + "\n".join(_readable(obs[:, i]) for i in range(obs.shape[1])),
            "Targets:\n" + "\n".join(_readable(targ[:, i]) for i in range(targ.shape[1])),
        ]
        if model_output is not None:
            output = np.asarray(model_output)[:, b, :]
            strings.append("Model Output:\n" + "\n".join(_readable(output[:, i]) for i in range(targ.shape[1])))
        batch_strings.append("\n\n".join(strings))
    return "\n" + "\n\n\n\n".join(batch_strings)
