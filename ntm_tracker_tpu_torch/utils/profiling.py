"""Profiling hooks (counterpart of ntm_tracker_tpu/utils/profiling.py): the
program's spans and counters, and torch.profiler traces over a block or
over a window of training steps, written as a Chrome/Perfetto trace file
(chrome://tracing, ui.perfetto.dev; TensorBoard's profile plugin reads the
same JSON). The card's activity (kernels, copies) is recorded when cuda is
available, the host's always.

Spans and counters live in one registry of the process:

- `span(name)` times a block. It is on while the program's flag is set
  (`enable()` / `disable()`), and in a thread where a torch.profiler
  session records. When on it opens `torch.profiler.record_function(name)`,
  so the block lands in any trace of the card, and adds its host time to
  the registry; when off it returns one shared null context and reads no
  clock. `record(name, start_ns, end_ns)` adds a span the caller timed
  itself, under the same rule; `stamp()` is its start, None (and no
  clock read) when spans are off. Torch's profiler records only the threads
  it was started in, so a worker's spans reach a trace through the
  registry alone (the flag, which every thread sees).
- `count(name, n)` adds to a counter; counters are always on.
- `snapshot()` reads the registry (each span name's count and seconds,
  the counters, the last `RECENT_SPANS` spans); `reset()` clears it.

Span times are `time.time_ns()`: the wall clock in nanoseconds since the
epoch, which torch.profiler stamps its host events with (an event's
`time_range.start` is microseconds after the session's
`kineto_results.trace_start_ns()`; a Chrome trace's `ts` is microseconds
after its `baseTimeNanoseconds`), so no offset is needed.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Dict, NamedTuple, Optional

import torch

# how many of the last spans the registry keeps for a trace's exporter
RECENT_SPANS = 16384


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread_id: int      # threading.get_native_id()
    thread_name: str


_lock = threading.Lock()
_on = False
_counters: Dict[str, float] = {}
_spans: Dict[str, list] = {}  # name -> [count, seconds]
_recent: "collections.deque[Span]" = collections.deque(maxlen=RECENT_SPANS)
_NULL = contextlib.nullcontext()


def enable() -> None:
    """Turn spans on in every thread."""
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def _add(name: str, start_ns: int, end_ns: int) -> None:
    t = threading.current_thread()
    with _lock:
        entry = _spans.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += (end_ns - start_ns) * 1e-9
        _recent.append(Span(name, start_ns, end_ns, threading.get_native_id(), t.name))


class _Timed:
    __slots__ = ("name", "start_ns", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        self._range.__exit__(*exc)
        _add(self.name, self.start_ns, end_ns)
        return False


def _spans_on() -> bool:
    return _on or torch.autograd._profiler_enabled()


def span(name: str):
    """A context that times its block as span `name` when spans are on
    (the module docstring), else the shared null context."""
    if not _spans_on():
        return _NULL
    return _Timed(name)


def stamp() -> Optional[int]:
    """time.time_ns() when spans are on, else None (no clock read): the
    start of a span that `record` ends."""
    return time.time_ns() if _spans_on() else None


def record(name: str, start_ns: Optional[int], end_ns: Optional[int] = None) -> None:
    """Add a span timed by the caller (time.time_ns(); the end, where not
    given, now), when spans are on and the start was taken (not None)."""
    if start_ns is not None and _spans_on():
        _add(name, start_ns, time.time_ns() if end_ns is None else end_ns)


def count(name: str, n: float = 1) -> None:
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counter(name: str) -> float:
    return _counters.get(name, 0)


def reset(*names: str) -> None:
    """Clear the registry; given names, only the spans and counters of
    each name and of the names under it (`name.*`)."""
    with _lock:
        if not names:
            _counters.clear()
            _spans.clear()
            _recent.clear()
            return
        for table in (_counters, _spans):
            for key in [k for k in table if any(k == n or k.startswith(n + ".") for n in names)]:
                del table[key]


def snapshot() -> dict:
    """{"spans": {name: {"count", "seconds"}}, "counters": {name: value},
    "recent": [Span, ...] (oldest first)}."""
    with _lock:
        return {"spans": {k: {"count": c, "seconds": s} for k, (c, s) in _spans.items()},
                "counters": dict(_counters), "recent": list(_recent)}


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _trace_path(log_dir: str, tag: str) -> str:
    os.makedirs(log_dir, exist_ok=True)
    return os.path.join(log_dir, f"{tag}.pt.trace.json")


def _write_spans(path: str, spans) -> None:
    """Write registry spans into a Chrome trace that torch.profiler
    exported, on its clock: a row for each thread's spans
    ("spans: <thread name>"), beside the rows the profiler recorded."""
    with open(path) as f:
        trace = json.load(f)
    # absent in traces whose `ts` is microseconds since the epoch
    base = trace.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    rows = {}
    for s in spans:
        rows.setdefault(s.thread_id, f"spans: {s.thread_name}")
        trace["traceEvents"].append({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
                                     "tid": rows[s.thread_id], "ts": (s.start_ns - base) / 1e3,
                                     "dur": (s.end_ns - s.start_ns) / 1e3})
    for row in rows.values():
        trace["traceEvents"].append({"ph": "M", "name": "thread_name", "pid": pid, "tid": row,
                                     "args": {"name": row}})
    with open(path, "w") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """Trace a block into <log_dir>/trace.pt.trace.json:
    `with profile_trace('./profile'): run_steps()`."""
    if not enabled:
        yield
        return
    with torch.profiler.profile(activities=_activities()) as prof:
        yield
    prof.export_chrome_trace(_trace_path(log_dir, "trace"))


class StepWindowProfiler:
    """Trace a window of training steps.

    Drive it from a step loop: `prof.before_step(step)` starts the trace
    when `step == start` and returns a record_function context naming the
    step (or a null context outside the window); `prof.after_step(step)`
    stops the trace after the last window step and writes
    <log_dir>/steps_<start>_<stop>.pt.trace.json. The program's spans are
    on over the window, and those of every thread (the loader's worker
    too) are written into the trace in rows of their own. Used by
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
        self._was_on = False
        self._start_ns = 0
        self.trace_path = None

    def before_step(self, step: int):
        if step == self.start and self._prof is None:
            self._was_on = _on
            enable()
            self._start_ns = time.time_ns()
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
        end_ns = time.time_ns()
        if not self._was_on:
            disable()
        self.trace_path = _trace_path(self.log_dir, f"steps_{self.start}_{self.stop}")
        prof.export_chrome_trace(self.trace_path)
        _write_spans(self.trace_path, [s for s in snapshot()["recent"]
                                             if s.end_ns > self._start_ns and s.start_ns < end_ns])


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
