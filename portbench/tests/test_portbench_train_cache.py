"""The feature-cache cell (kinds/train_cache.py) on the CPU: its readers
of the program's loader spans on a hand-made registry, and runs through
the harness at the cell's published widths with its traffic cut to a few
rows, frames and sequences: a sound run is correct with `batch_gap` 0 and
its traced run reads the four span metrics; half the batch, and a loader
that hands over another frame's tokens, come out not correct. The cache
set-up wrote is gone after the run, and the loader's thread has ended.
On the card (`-m card`): the control fails and the program passes on
three seeds at the cell's own size.

The cell is not in BENCHMARK.json (its rate and its set-up spread past
half their bounds, PERF.md §4); `manifest()` adds the entries that would
put it there: the cell, its name in the workloads of `train_frames_per_s`
and `host_step_ms.train`, and the three loader metrics.
"""

import json
import math
import os
import threading
import time

import pytest
import torch

from portbench import harness, spans
from portbench.kinds import train_cache
from portbench.tests.test_portbench_faults import SEED, train_half_the_batch
from portbench.trace import Summary
from ntm_tracker_tpu_torch.utils import profiling

CELL = "ntm_offsets.train_feature_cache"
SMALL = dict(batch=4, sequence_length=3, sequences=8, reference_block_rows=4, trace_steps=2)
LOADER_METRICS = ("prefetch_wait_share.train_cache", "loader_ms.train_cache", "upload_ms.train_cache")
CELL_ENTRY = {"name": CELL, "config": "ntm_offsets", "traffic": "train_feature_cache", "chips": 1,
              "why": "the B=256, L=20 train step fed by train-offsets --feature_cache's loader from a 512-sequence "
                     "cache on tmpfs, closed loop: .npy reads, stack, upload, prefetch"}
CARD_SEEDS = (4_100_000_001, 4_100_000_002, 4_100_000_003)


def manifest():
    """BENCHMARK.json with the cell's entries (the module docstring)."""
    man = harness.manifest()
    if CELL in [w["name"] for w in man["workloads"]]:
        return man
    man["workloads"].append(CELL_ENTRY)
    for m in man["end_to_end"] + man["per_layer"]:
        if m["name"] in ("train_frames_per_s", "host_step_ms.train"):
            m["workloads"].append(CELL)
    man["per_layer"] += [{"name": name, "unit": unit, "better": "lower", "source": "program_span", "layer": "loader",
                          "moves": "train_frames_per_s", "workloads": [CELL]}
                         for name, unit in zip(LOADER_METRICS, ("%", "ms", "ms"))]
    return man


@pytest.fixture
def registry():
    profiling.disable()
    profiling.reset()
    yield profiling
    profiling.disable()
    profiling.reset()


def run_cell(trace=False, fault=None, monkeypatch=None, seed=SEED, device="cpu", seconds=0.5, small=True):
    man = manifest()
    run = harness.make_run(man, CELL, seed, seconds, trace, device)
    if small:
        run.traffic.update(SMALL)
    if fault is not None:
        fault(monkeypatch)
    drv, m, numbers, peak = harness.measure(run, time.time())
    assert not os.path.exists(drv.dir)
    assert not any(t.name.endswith("(worker)") for t in threading.enumerate())  # the loader's thread ended
    line = harness.result_line(man, m, numbers, peak)
    line["control"] = drv.compare(tf32=True) if device == "cuda" else None
    return line


def measured():
    run = harness.make_run(manifest(), CELL, 1, 1.0, True, "cpu")
    return harness.Measured(run=run, device_name="cpu", card=None, setup_s=1.0, durations=[0.5], work=240,
                            window_s=0.5, trace=Summary(span_s=2.0, busy_s=1.0, kernels=[], idle_gaps=[], steps=2))


def test_the_readers_read_the_loaders_spans(registry, monkeypatch):
    readers = {name: harness.metric_reader(name) for name in LOADER_METRICS}
    assert all(read(measured()) is None for read in readers.values())
    registry.enable()
    registry.record("loader.wait", 0, 500_000_000)
    registry.record("loader.wait", 0, 300_000_000)
    registry.record("loader.read", 0, 900_000_000)
    registry.record("loader.read", 0, 700_000_000)
    registry.record("loader.upload", 0, 60_000_000)
    assert readers["prefetch_wait_share.train_cache"](measured()) == pytest.approx(40.0)
    assert readers["loader_ms.train_cache"](measured()) == pytest.approx(800.0)
    assert readers["upload_ms.train_cache"](measured()) == pytest.approx(60.0)
    m = measured()
    m.trace = None
    assert readers["prefetch_wait_share.train_cache"](m) is None
    monkeypatch.setattr(spans, "registry", lambda: None)
    assert all(read(measured()) is None for read in readers.values())


def test_a_sound_cache_run_is_correct_and_its_batches_are_what_set_up_wrote(registry):
    line = run_cell()
    assert line["correct"] and line["checks"]["batch_gap"]["value"] == 0.0, line["checks"]
    assert registry.snapshot()["spans"] == {}  # the flag stays off without --trace


def test_a_traced_cache_run_reads_the_loaders_spans_of_its_traced_steps(registry):
    line = run_cell(trace=True)
    assert line["correct"], line["checks"]
    found = registry.snapshot()["spans"]
    assert found["train.step"]["count"] == SMALL["trace_steps"] and found["loader.wait"]["count"] == 2
    for name in LOADER_METRICS + ("host_step_ms.train",):
        assert math.isfinite(line["metrics"][name]["value"]), name
    assert 0 < line["metrics"]["prefetch_wait_share.train_cache"]["value"] <= 100
    assert not profiling._on


def another_frames_tokens(monkeypatch):
    """The loader hands over each batch with its first frame's tokens
    taken from its second frame."""
    from ntm_tracker_tpu_torch.data import feature_cache

    orig = feature_cache.load_token_batch

    def load(frame_paths, *a, **k):
        b = orig(frame_paths, *a, **k)
        b.features[0] = b.features[1]
        return b

    monkeypatch.setattr(feature_cache, "load_token_batch", load)


@pytest.mark.parametrize("fault", [train_half_the_batch, another_frames_tokens])
def test_a_broken_cache_run_is_not_correct(fault, monkeypatch, registry):
    line = run_cell(fault=fault, monkeypatch=monkeypatch)
    assert not line["correct"], line["checks"]
    if fault is another_frames_tokens:
        assert line["checks"]["batch_gap"]["value"] > 1.0, line["checks"]


def test_the_cache_lies_on_tmpfs_where_the_machine_has_one():
    parent = train_cache.cache_parent(1 << 20)
    assert os.path.isdir(parent)
    if train_cache._tmpfs(train_cache.SHM):
        assert train_cache._tmpfs(parent)


def test_the_cells_entries_keep_the_manifests_rules():
    man = manifest()
    reported = [m["name"] for m in man["end_to_end"] if CELL in m.get("workloads", [CELL])]
    assert reported == ["train_frames_per_s", "setup_s"] and len(CELL_ENTRY["why"]) <= 200
    assert [m["name"] for m in harness.metrics_of(man, CELL, True)] == ["host_step_ms.train", *LOADER_METRICS]


@pytest.mark.card
def test_the_control_fails_and_the_program_passes():
    """The reference in TF32 in the program's place at B=256, L=20 on three
    seeds (about 80 s a seed)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    limits = harness.make_run(manifest(), CELL, 1, 1.0, False, "cpu").limits
    for seed in CARD_SEEDS:
        line = run_cell(seed=seed, device="cuda", seconds=3.0, small=False)
        program = {k: c["value"] for k, c in line["checks"].items()}
        print(json.dumps({"seed": seed, "program": program, "control": line["control"]}), flush=True)
        assert line["correct"], line["checks"]
        assert line["control"]["loss_gap"] > limits["loss_gap"]["limit"], line["control"]
