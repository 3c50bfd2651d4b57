"""The reader of the program's spans, metrics/host_step_ms.train.py
(portbench/spans.py): on a hand-made registry, None where the registry
lacks the span or the program lacks the registry, and through the harness
on the CPU: a traced train run (the cell's published widths, its traffic
cut to a few rows and frames) reads the `train.step` spans of its traced
steps alone, which the harness's profiler turned on."""

import math
import time

import pytest

from portbench import harness, spans
from portbench.trace import Summary
from portbench.tests.test_portbench_faults import SEED, SMALL
from ntm_tracker_tpu_torch.utils import profiling

CELL = "ntm_offsets.train_b256"


@pytest.fixture
def registry():
    profiling.disable()
    profiling.reset()
    yield profiling
    profiling.disable()
    profiling.reset()


def measured():
    run = harness.make_run(harness.manifest(), CELL, 1, 1.0, True, "cpu")
    return harness.Measured(run=run, device_name="cpu", card=None, setup_s=1.0, durations=[0.5], work=240,
                            window_s=0.5, trace=Summary(span_s=2.0, busy_s=1.0, kernels=[], idle_gaps=[], steps=2))


def test_the_reader_reads_the_programs_train_step(registry, monkeypatch):
    read = harness.metric_reader("host_step_ms.train")
    assert read(measured()) is None
    registry.enable()
    registry.record("train.step", 0, 4_000_000)
    registry.record("train.step", 10, 2_000_010)
    registry.record("loader.wait", 0, 9_000_000)
    assert read(measured()) == pytest.approx(3.0)
    monkeypatch.setattr(spans, "registry", lambda: None)
    assert read(measured()) is None


def test_a_traced_train_run_reads_its_traced_steps_alone(registry):
    man = harness.manifest()
    run = harness.make_run(man, CELL, SEED, 0.5, True, "cpu")
    run.traffic.update(SMALL, trace_steps=2)
    _, m, numbers, peak = harness.measure(run, time.time())
    line = harness.result_line(man, m, numbers, peak)
    steps = registry.snapshot()["spans"]["train.step"]
    assert line["correct"] and steps["count"] == 2, (line["checks"], steps)
    value = line["metrics"]["host_step_ms.train"]["value"]
    assert math.isfinite(value) and value == pytest.approx(1e3 * steps["seconds"] / 2)
