"""The host's time to issue one train step: the program's `train.step`
span (train/experiments.py:gradient_step) over the traced steps, its
seconds over its count. The steps are traced under the harness's
torch.profiler, whose cost per op is in the reading (PERF.md §3)."""

from portbench import spans


def read(m):
    return spans.mean_ms("train.step")
