"""utils/profiling.py (the port's torch.profiler hooks) against the JAX
package's parse_profile_steps, and the trace a step window writes:
train_loop's profile_steps=(1, 2) traces steps 1 and 2 and no other
(mirroring tests/test_training_e2e.py::test_train_loop_profile_window).
The span-and-counter registry: off, a span is one shared null context
that reads no clock; on, spans are summed per name with their thread; a
profiler turns its own thread's spans on, on its clock; the loader's
spans; a step window's trace holds the worker thread's spans."""

import json
import os
import sys
import threading
import time

import pytest
import torch

from ntm_tracker_tpu.utils import profiling as jprof
from ntm_tracker_tpu_torch.data import loader
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


# ---- the span-and-counter registry --------------------------------------------------


@pytest.fixture
def registry():
    """A cleared registry with spans off, left cleared and off."""
    profiling.disable()
    profiling.reset()
    yield profiling
    profiling.disable()
    profiling.reset()


def _in_thread(fn):
    t = threading.Thread(target=fn, name="worker-under-test")
    t.start()
    t.join(10)
    assert not t.is_alive()


def _no_clock(monkeypatch):
    def boom():
        raise AssertionError("a clock was read")

    monkeypatch.setattr(time, "time_ns", boom)
    monkeypatch.setattr(time, "perf_counter", boom)
    monkeypatch.setattr(time, "perf_counter_ns", boom)


def test_spans_off_are_one_shared_null_context_and_read_no_clock(registry, monkeypatch):
    assert registry.span("a") is registry.span("b")
    _no_clock(monkeypatch)
    with registry.span("a"):
        with registry.span("b"):
            pass
    registry.record("c", 0, 10)

    def work():
        with registry.span("in_thread"):
            pass
        registry.record("in_thread", 0, 10)

    _in_thread(work)
    monkeypatch.undo()
    snap = registry.snapshot()
    assert snap["spans"] == {} and snap["recent"] == []


def test_prefetch_worker_reads_no_clock_with_spans_off(registry, monkeypatch):
    """Off, the worker's reads and uploads take no clock reading (a read
    there is raised in the consumer); the consumer's `waits` are kept."""
    real = time.time_ns

    def main_thread_only():
        if threading.current_thread() is not threading.main_thread():
            raise AssertionError("the worker read a clock")
        return real()

    monkeypatch.setattr(time, "time_ns", main_thread_only)
    it = loader.PrefetchIterator(iter(range(3)), prefetch=2, device_put=lambda x: x + 1)
    assert list(it) == [1, 2, 3] and len(it.waits) == 4
    monkeypatch.undo()
    assert registry.snapshot()["spans"] == {}


def test_spans_on_sum_per_name_and_keep_their_thread(registry):
    registry.enable()
    with registry.span("outer"):
        for _ in range(3):
            with registry.span("inner"):
                time.sleep(0.002)

    def work():
        with registry.span("in_thread"):
            time.sleep(0.002)

    _in_thread(work)
    snap = registry.snapshot()
    assert snap["spans"]["inner"]["count"] == 3 and snap["spans"]["outer"]["count"] == 1
    assert snap["spans"]["outer"]["seconds"] >= snap["spans"]["inner"]["seconds"] >= 0.006
    inner = [s for s in snap["recent"] if s.name == "inner"]
    assert abs(sum(s.end_ns - s.start_ns for s in inner) * 1e-9 - snap["spans"]["inner"]["seconds"]) < 1e-9
    (worker,) = [s for s in snap["recent"] if s.name == "in_thread"]
    assert worker.thread_name == "worker-under-test" and worker.thread_id != threading.get_native_id()
    assert {s.thread_id for s in inner} == {threading.get_native_id()}
    [outer] = [s for s in snap["recent"] if s.name == "outer"]
    assert all(outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns for s in inner)


def test_snapshot_and_reset(registry):
    registry.enable()
    with registry.span("train.step"):
        pass
    registry.record("loader.wait", 100, 350)
    registry.count("launches.ntm_scan_fused")
    registry.count("launches.ntm_scan_fused.tile", 2)
    registry.count("launches.ntm_scan_fused_x")
    snap = registry.snapshot()
    assert snap["spans"]["loader.wait"] == {"count": 1, "seconds": pytest.approx(250e-9)}
    assert registry.counter("launches.ntm_scan_fused.tile") == 2 and registry.counter("absent") == 0
    registry.count("launches.ntm_scan_fused")
    assert snap["counters"]["launches.ntm_scan_fused"] == 1  # a copy
    registry.reset("launches.ntm_scan_fused", "loader")
    snap = registry.snapshot()
    assert snap["counters"] == {"launches.ntm_scan_fused_x": 1}
    assert set(snap["spans"]) == {"train.step"}
    registry.reset()
    assert registry.snapshot() == {"spans": {}, "counters": {}, "recent": []}


def test_counters_are_always_on_and_lose_no_update(registry):
    """16 threads (more than the cores) adding at a shortened switch
    interval: the total is exact."""
    assert registry.span("a") is registry.span("b")  # spans off
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [registry.count("hits") for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert registry.counter("hits") == 16 * 2000


def test_a_profiler_turns_its_threads_spans_on_on_its_clock(registry):
    with registry.span("warm"):
        pass
    assert registry.snapshot()["spans"] == {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with registry.span("warm"):
            pass
        for _ in range(5):
            with registry.span("main_span"):
                torch.ones(8).sum()

        def work():
            with registry.span("thread_span"):
                pass

        _in_thread(work)
    spans = registry.snapshot()["spans"]
    assert spans["main_span"]["count"] == 5 and "thread_span" not in spans
    base = prof.profiler.kineto_results.trace_start_ns()
    theirs = sorted(base + e.time_range.start * 1e3 for e in prof.events() if e.name == "main_span")
    mine = sorted(s.start_ns for s in registry.snapshot()["recent"] if s.name == "main_span")
    # one clock: the spans start within 0.1 ms of their events (the least
    # gap of five, which a preemption between the two stamps cannot widen)
    assert len(theirs) == 5 and min(abs(a - b) for a, b in zip(mine, theirs)) < 1e5, (mine, theirs)


def test_prefetch_spans_time_the_wait_and_the_reads(registry):
    def sleepy():
        for i in range(2):
            time.sleep(0.25)
            yield i

    registry.enable()
    it = loader.PrefetchIterator(sleepy(), prefetch=2, device_put=lambda x: x + 10)
    assert list(it) == [10, 11]
    spans = registry.snapshot()["spans"]
    assert spans["loader.wait"]["seconds"] >= 0.25 and spans["loader.wait"]["count"] == 3
    assert spans["loader.read"]["count"] == 2 and spans["loader.read"]["seconds"] >= 0.5
    assert spans["loader.upload"]["count"] == 2
    assert abs(sum(it.waits) - spans["loader.wait"]["seconds"]) < 1e-6


def test_profile_steps_trace_holds_the_workers_spans(registry, tmp_path):
    """train_loop's window over a PrefetchIterator whose worker predates
    the profiler: its loader.read spans are in the trace, in a row of
    their own, inside the window; the flag is off again after it."""
    def batches():
        for i in range(8):
            time.sleep(0.03)
            yield torch.ones(2) * i

    def train_step(params, opt_state, batch):
        time.sleep(0.1)
        return params + batch.sum(), opt_state, {"loss": batch.sum()}

    it = loader.PrefetchIterator(batches(), prefetch=2)
    train_loop(train_step, None, torch.zeros(()), None, it, log_dir=str(tmp_path), profile_steps=(1, 2),
               validation_interval=100)
    assert profiling.span("a") is profiling.span("b")  # off again
    with open(tmp_path / "profile" / "steps_1_2.pt.trace.json") as f:
        events = json.load(f)["traceEvents"]
    steps = [e for e in events if str(e.get("name", "")).startswith("train_step_") and e.get("ph") == "X"]
    reads = [e for e in events if e.get("name") == "loader.read" and e.get("cat") == "program_span"]
    waits = [e for e in events if e.get("name") == "loader.wait" and e.get("cat") == "program_span"]
    (row,) = {e["tid"] for e in reads}
    assert waits and {e["tid"] for e in waits} == {"spans: MainThread"} and row != "spans: MainThread"
    lo = min(e["ts"] for e in steps)
    hi = max(e["ts"] + e["dur"] for e in steps)
    assert all(e["ts"] + e["dur"] > lo and e["ts"] < hi + 1e3 for e in reads)
    assert any(e.get("ph") == "M" and e.get("args", {}).get("name") == row for e in events)
