"""Runs one cell once: finds the cell's configuration, traffic, runner,
limits and metric readers by name, sets up, measures a window of closed-
loop steps, checks the answers against the plain reference, and prints
the result line.

The runners (kinds/<kind>.py) give `Runner(run)` with `setup()`,
`step()` (one timed call; returns its units of work), `release()` (frees
the program) and `compare(tf32=False)` (the numbers compared); a runner
may add `finish_window()` (called when the window closes, inside it) and
has `trace_steps`, the steps of the traced span.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from portbench import counts, nojax

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent


class NoCard(RuntimeError):
    """The machine lacks the cards the cell asks for."""


@dataclasses.dataclass
class Run:
    workload: Dict[str, Any]
    conf: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: torch.device


@dataclasses.dataclass
class Measured:
    """What the metric readers (metrics/<name>.py) read."""

    run: Run
    device_name: str
    card: Optional[Dict[str, float]]
    setup_s: float
    durations: List[float]   # each timed step's wall seconds
    work: int                # units of work in the window
    window_s: float          # the window on the host's clock
    trace: Any = None        # portbench.trace.Summary of the span traced before the window (--trace 1)


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_json(kind: str, name: str, bench: Path = BENCH) -> dict:
    """portbench/<kind>/<name>.json."""
    return json.loads((bench / kind / f"{name}.json").read_text())


def runner_class(kind: str):
    return importlib.import_module(f"portbench.kinds.{kind}").Runner


def metric_reader(name: str, bench: Path = BENCH):
    """The `read(measured)` of portbench/metrics/<name>.py."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_of(man: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of `workload` reports: the end-to-end ones with
    --trace 0, the per-layer ones with --trace 1."""
    group = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in group if "workloads" not in m or workload in m["workloads"]]


def make_run(man: dict, workload: str, seed: int, seconds: float, trace: bool, device,
             bench: Path = BENCH) -> Run:
    w = _by_name(man["workloads"], workload, "workload")
    c = _by_name(man["configs"], w["config"], "config")
    conf = json.loads((bench.parent / c["file"]).read_text())
    return Run(workload=w, conf=conf, traffic=load_json("traffic", w["traffic"], bench),
               limits=load_json("limits", workload, bench), seed=seed, seconds=seconds, trace=trace,
               device=torch.device(device))


def require_cards(chips: int) -> None:
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device is available")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards, the machine has {torch.cuda.device_count()}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(run: Run, process_start: float):
    """Set up, trace `trace_steps` steps (with run.trace), run the window,
    release the program, compare. -> (runner, Measured, numbers, peak
    device bytes)."""
    from portbench import program, trace as tracing

    program.set_precision(run.conf)
    drv = runner_class(run.traffic["kind"])(run)
    drv.setup()
    _sync(run.device)
    setup_s = time.time() - process_start
    summary = None
    if run.trace:
        # the traced span first, then the window: the profiler's start and
        # its reading of the trace stay out of the window's time
        steps = 0
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(tracing.SPAN_NAME):
                while steps < drv.trace_steps:
                    drv.step()
                    steps += 1
                _sync(run.device)
        summary = tracing.summarize(prof)
        summary.steps = steps
        del prof
    durations, work = [], 0
    t_start = time.perf_counter()
    deadline = t_start + run.seconds
    while True:
        t0 = time.perf_counter()
        work += drv.step()
        t1 = time.perf_counter()
        durations.append(t1 - t0)
        if t1 >= deadline:
            break
    if hasattr(drv, "finish_window"):
        drv.finish_window()
    _sync(run.device)
    window_s = time.perf_counter() - t_start
    found = nojax.forbidden_loaded()
    if found:
        raise nojax.Forbidden(found)
    name = torch.cuda.get_device_name(run.device) if run.device.type == "cuda" else "cpu"
    m = Measured(run=run, device_name=name, card=counts.peaks(name), setup_s=setup_s, durations=durations,
                 work=work, window_s=window_s, trace=summary)
    peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    drv.release()
    numbers = drv.compare()
    return drv, m, numbers, peak


def result_line(man: dict, m: Measured, numbers: Dict[str, float], peak: int, bench: Path = BENCH) -> dict:
    run = m.run
    limits = run.limits
    checks = {k: {"value": numbers.get(k, float("nan")), "limit": limits[k]["limit"]} for k in limits}
    passed = {k: (isinstance(c["value"], float) and c["value"] <= c["limit"]) for k, c in checks.items()}
    metrics = {}
    for spec in metrics_of(man, run.workload["name"], run.trace):
        value = metric_reader(spec["name"], bench)(m)
        if value is None:
            if not run.trace:
                raise RuntimeError(f"end-to-end metric {spec['name']} read nothing")
            continue
        if not math.isfinite(value):
            raise RuntimeError(f"metric {spec['name']} read {value}")
        metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    device = {"platform": "gpu" if run.device.type == "cuda" else run.device.type, "kind": m.device_name,
              "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": all(passed.values()), "attempted": m.work,
           "failed": sum(1 for ok in passed.values() if not ok), "metrics": metrics, "device": device}
    if m.trace is not None:
        device["busy_s"] = m.trace.busy_s
        device["window_s"] = m.trace.span_s
        out["breakdown"] = {"device_ops": [[n, s] for n, s in m.trace.top_ops(10)],
                            "idle_gaps": [[n, s] for n, s in m.trace.idle_gaps]}
    out["checks"] = checks
    return out


def main(workload: str, seed: int, seconds: float, trace: bool, process_start: float) -> int:
    man = manifest()
    run = make_run(man, workload, seed, seconds, trace, "cuda")
    try:
        require_cards(run.workload["chips"])
    except NoCard as e:
        print(f"portbench: {e}; no result", file=sys.stderr)
        return 3
    _, m, numbers, peak = measure(run, process_start)
    line = result_line(man, m, numbers, peak)
    found = nojax.forbidden_loaded()
    if found:
        raise nojax.Forbidden(found)
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
