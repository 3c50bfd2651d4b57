"""Profiling hooks on torch.profiler (counterpart of
ntm_tracker_tpu/utils/profiling.py): a trace over a block or over a
window of training steps, written as a Chrome/Perfetto trace file
(chrome://tracing, ui.perfetto.dev; TensorBoard's profile plugin reads the
same JSON). The card's activity (kernels, copies) is recorded when cuda is
available, the host's always."""

from __future__ import annotations

import contextlib
import os


def _activities():
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _trace_path(log_dir: str, tag: str) -> str:
    os.makedirs(log_dir, exist_ok=True)
    return os.path.join(log_dir, f"{tag}.pt.trace.json")


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """Trace a block into <log_dir>/trace.pt.trace.json:
    `with profile_trace('./profile'): run_steps()`."""
    if not enabled:
        yield
        return
    import torch

    with torch.profiler.profile(activities=_activities()) as prof:
        yield
    prof.export_chrome_trace(_trace_path(log_dir, "trace"))


class StepWindowProfiler:
    """Trace a window of training steps.

    Drive it from a step loop: `prof.before_step(step)` starts the trace
    when `step == start` and returns a record_function context naming the
    step (or a null context outside the window); `prof.after_step(step)`
    stops the trace after the last window step and writes
    <log_dir>/steps_<start>_<stop>.pt.trace.json. Used by
    train.harness.train_loop's `profile_steps=(start, stop)` and the CLI's
    `--profile_steps a:b`.
    """

    def __init__(self, log_dir: str, start: int, stop: int):
        if stop < start:
            raise ValueError(f"profile window stop {stop} < start {start}")
        self.log_dir = log_dir
        self.start = start
        self.stop = stop
        self._prof = None
        self.trace_path = None

    def before_step(self, step: int):
        import torch

        if step == self.start and self._prof is None:
            self._prof = torch.profiler.profile(activities=_activities())
            self._prof.__enter__()
        if self._prof is not None:
            return torch.profiler.record_function(f"train_step_{step}")
        return contextlib.nullcontext()

    def after_step(self, step: int) -> None:
        if self._prof is not None and step >= self.stop:
            self.close()

    def close(self) -> None:
        """Stop the trace and write it (also when the loop ended inside the
        window)."""
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        self.trace_path = _trace_path(self.log_dir, f"steps_{self.start}_{self.stop}")
        prof.export_chrome_trace(self.trace_path)


def parse_profile_steps(spec: str):
    """'120:130' -> (120, 130); '50' -> (50, 50); '' -> None."""
    if not spec:
        return None
    parts = spec.split(":")
    if len(parts) == 1:
        a = b = int(parts[0])
    elif len(parts) == 2:
        a, b = int(parts[0]), int(parts[1])
    else:
        raise ValueError(f"bad --profile_steps {spec!r}; use START:STOP")
    return (a, b)
