"""utils/profiling.py (the port's torch.profiler hooks) against the JAX
package's parse_profile_steps, and the trace a step window writes:
train_loop's profile_steps=(1, 2) traces steps 1 and 2 and no other
(mirroring tests/test_training_e2e.py::test_train_loop_profile_window)."""

import json
import os

import pytest
import torch

from ntm_tracker_tpu.utils import profiling as jprof
from ntm_tracker_tpu_torch.train.harness import train_loop
from ntm_tracker_tpu_torch.utils import profiling


@pytest.mark.parametrize("spec", ["1:2", "7", "", "0:0", "120:130"])
def test_parse_profile_steps_matches_jax(spec):
    assert profiling.parse_profile_steps(spec) == jprof.parse_profile_steps(spec)


def test_parse_profile_steps_rejects_three_fields():
    with pytest.raises(ValueError, match="START:STOP"):
        profiling.parse_profile_steps("1:2:3")


def _step_names(path):
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"] if str(e.get("name", "")).startswith("train_step")}


def test_train_loop_traces_its_window(tmp_path):
    def train_step(params, opt_state, batch):
        return params + batch.sum(), opt_state, {"loss": batch.sum()}

    batches = [torch.ones(2) * i for i in range(4)]
    params, _, steps = train_loop(train_step, None, torch.zeros(()), None, iter(batches), log_dir=str(tmp_path),
                                  profile_steps=(1, 2), validation_interval=100)
    assert steps == 4 and float(params) == 12.0
    path = tmp_path / "profile" / "steps_1_2.pt.trace.json"
    assert os.listdir(tmp_path / "profile") == [path.name]
    assert _step_names(path) == {"train_step_1", "train_step_2"}


def test_window_cut_short_is_still_written(tmp_path):
    prof = profiling.StepWindowProfiler(str(tmp_path), 1, 5)
    for step in range(3):
        with prof.before_step(step):
            torch.ones(3).sum()
        prof.after_step(step)
    prof.close()
    prof.close()  # idempotent
    assert prof.trace_path.endswith("steps_1_5.pt.trace.json")
    assert _step_names(prof.trace_path) == {"train_step_1", "train_step_2"}
    with pytest.raises(ValueError, match="stop 0 < start 1"):
        profiling.StepWindowProfiler(str(tmp_path), 1, 0)


def test_profile_trace_block(tmp_path):
    with profiling.profile_trace(str(tmp_path / "block")):
        torch.ones(4).mul(2)
    assert os.listdir(tmp_path / "block") == ["trace.pt.trace.json"]
    with profiling.profile_trace(str(tmp_path / "off"), enabled=False):
        pass
    assert not (tmp_path / "off").exists()
