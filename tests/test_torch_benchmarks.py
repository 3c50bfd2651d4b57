"""benchmarks.py and the FLOP counts of tools/profile_train.py on the CPU,
against the JAX package's ntm_tracker_tpu.benchmarks and
ntm_tracker_tpu.tools.profile_train: the FLOP counts equal JAX's exactly
(pure arithmetic on the config), the regression tripwire's functions give
JAX's results on the same BENCH_r*.json fixtures
(tests/test_benchmarks.py's), the port compares only with a record of its
own card, the peak table, the secondary phases at a tiny config, and
main's JSON line (its keys a superset of the JAX line's, in its order)."""

import ast
import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

from ntm_tracker_tpu import benchmarks as jbench
from ntm_tracker_tpu import config as jconfig
from ntm_tracker_tpu.tools import profile_train as jprofile
from ntm_tracker_tpu_torch import benchmarks as bench
from ntm_tracker_tpu_torch import config as tconfig
from ntm_tracker_tpu_torch.models.core import make_core
from ntm_tracker_tpu_torch.models.vgg import init_vgg_params
from ntm_tracker_tpu_torch.tools import profile_train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = tuple((y, x) for y in range(0, 28, 4) for x in range(0, 28, 4))

# (TrackerConfig overrides, NTMConfig overrides, DataConfig overrides)
FLOP_CONFIGS = {
    "default": ({}, {}, {}),
    "no_fast_conv43": ({"fast_conv43": False}, {}, {}),
    "feature_points": ({"feature_points": GRID, "num_features": len(GRID)}, {}, {}),
    "crop_256": ({}, {}, {"crop_size": 256}),
    "two_layers": ({}, {"controller_num_layers": 2}, {}),
}


def both_configs(top, ntm, data, train=None):
    """The same TrackerConfig in the JAX package and in the port."""
    train = train or {}
    return tuple(m.TrackerConfig(ntm=m.NTMConfig(**ntm), data=m.DataConfig(**data),
                                 train=m.TrainConfig(**train), **top) for m in (jconfig, tconfig))


@pytest.mark.parametrize("name", list(FLOP_CONFIGS))
def test_flop_counts_equal_jax(name):
    top, ntm, data = FLOP_CONFIGS[name]
    jcfg, tcfg = both_configs(top, ntm, data, {"batch_size": 256, "sequence_length": 20})
    assert bench.frame_flops(tcfg) == jbench.frame_flops(jcfg)
    assert profile_train.cell_step_flops(tcfg) == jprofile.cell_step_flops(jcfg)
    assert profile_train.train_step_flops(tcfg) == jprofile.train_step_flops(jcfg)
    assert profile_train._mfu(tcfg, 217.0, 67.0) == jprofile._mfu(jcfg, 217.0, 67.0)


def test_train_mfu_is_jax_formula_over_the_given_peak():
    assert bench._train_mfu(217.0, 67.0, 256, 20) == jbench._train_mfu(217.0, 67.0, 256, 20)
    assert bench._train_mfu(217.0, None, 256, 20) is None


def _record(path, kind):
    """tests/test_benchmarks.py's fixtures: a parsed record, or the r4
    shape (parsed null, the JSON line head-truncated in tail)."""
    if kind == "parsed":
        (path / "BENCH_r03.json").write_text(json.dumps({"parsed": {"value": 8000.0, "mfu": 0.6}}))
        (path / "BENCH_r02.json").write_text(json.dumps({"parsed": {"value": 100.0}}))
    elif kind == "tail":
        tail = ('hip", "value": 8020.6, "unit": "frames/s", "mfu": 0.66, '
                '"device_loop_frames_per_sec": null, '
                '"train_frames_per_sec_cached": null, "train_mfu": null, '
                '"platform": "tpu"}\nsome trailing log line\n')
        (path / "BENCH_r04.json").write_text(json.dumps({"parsed": None, "tail": tail}))
    elif kind == "variant_tail":
        tail = '"value": 7000.5, "headline_variant": "baked-constants", "train_mfu": 0.0123, "mfu": 1e-3}'
        (path / "BENCH_r07.json").write_text(json.dumps({"parsed": None, "tail": tail}))
    elif kind == "broken":
        (path / "BENCH_r09.json").write_text("{not json")


@pytest.mark.parametrize("kind", ["parsed", "tail", "variant_tail", "broken", "none"])
def test_tripwire_reads_records_as_jax(tmp_path, kind):
    _record(tmp_path, kind)
    root = str(tmp_path)
    assert bench._latest_bench_record(root) == jbench._latest_bench_record(root)
    assert bench._previous_bench_metrics(root) == jbench._previous_bench_metrics(root)


REGRESSION_CASES = [
    ({"value": 7200.0, "mfu": 0.66, "train_frames_per_sec_cached": None}, None),
    ({"value": 4000.0, "mfu": 0.66}, None),
    ({"value": 8100.0, "mfu": 0.66, "train_frames_per_sec_cached": 15000.0}, None),
    ({"value": 0.0, "mfu": 0.1, "train_mfu": 0.2, "device_loop_frames_per_sec": 10.0}, 0.5),
]


@pytest.mark.parametrize("case", range(len(REGRESSION_CASES)))
def test_regressions_as_jax(case):
    prev = {"value": 8000.0, "mfu": 0.66, "train_frames_per_sec_cached": 24000.0, "train_mfu": 0.3,
            "device_loop_frames_per_sec": 5000.0}
    result, frac = REGRESSION_CASES[case]
    kw = {} if frac is None else {"frac": frac}
    assert bench._bench_regressions(result, prev, **kw) == jbench._bench_regressions(result, prev, **kw)


def test_compares_only_with_a_record_of_this_card(tmp_path):
    card = "NVIDIA H100 80GB HBM3"
    _record(tmp_path, "tail")  # a TPU record
    n, prev, note = bench._comparable_previous(str(tmp_path), "gpu", card)
    assert (n, prev) == (4, None) and "no previous record of this card" in note
    line = {"value": 900.0, "mfu": 0.02, "platform": "gpu", "device_kind": card}
    (tmp_path / "BENCH_r05.json").write_text(json.dumps({"parsed": line}))
    assert bench._comparable_previous(str(tmp_path), "gpu", card) == (5, line, "")
    assert bench._comparable_previous(str(tmp_path), "gpu", "NVIDIA H100 PCIe")[1] is None
    # the same line, head-truncated into the tail
    tail = "log line\n" + json.dumps(line)[1:] + "\n"
    (tmp_path / "BENCH_r06.json").write_text(json.dumps({"parsed": None, "tail": tail}))
    n, prev, _ = bench._comparable_previous(str(tmp_path), "gpu", card)
    assert n == 6 and prev == {"value": 900.0, "mfu": 0.02}
    assert bench._comparable_previous(str(tmp_path / "empty"), "gpu", card)[1:] == (None, "no previous BENCH_r*.json")


def test_repo_records_are_not_this_cards():
    assert bench._comparable_previous(ROOT, "gpu", "NVIDIA H100 80GB HBM3")[1] is None


@pytest.mark.parametrize("name, dtype, peak", [
    ("NVIDIA H100 80GB HBM3", torch.bfloat16, 989.4),
    ("NVIDIA H100 80GB HBM3", torch.float32, 67.0),
    ("NVIDIA H100 PCIe", torch.bfloat16, 756.0),
    ("NVIDIA H100 PCIe", torch.float32, 51.0),
    ("NVIDIA A100-SXM4-80GB", torch.bfloat16, None),
])
def test_peak_table(name, dtype, peak):
    assert bench._chip_peak_tflops(name, dtype) == peak


def test_peak_of_the_cpu_is_none():
    assert bench._chip_peak_tflops(torch.device("cpu")) is None


def test_sweep_ceiling_from_activation_bytes():
    cfg = tconfig.TrackerConfig(compute_dtype=torch.bfloat16)
    per = bench.frame_activation_bytes(cfg)
    # conv1_2 at the fast path's sides: its float32 input (202^2 x 64) and
    # 10 bytes an element of its output (200^2 x 64), beside the crop
    assert per == 224 * 224 * 3 * 4 + 4 * 202 * 202 * 64 + 10 * 200 * 200 * 64
    assert bench.sweep_ceiling(cfg, 128, 4096, int(1024 * per / 0.8) + 1) == 1024
    assert bench.sweep_ceiling(cfg, 128, 4096, int(1023 * per / 0.8)) == 512
    assert bench.sweep_ceiling(cfg, 128, 256, 10 ** 15) == 256
    assert bench.sweep_ceiling(cfg, 128, 4096, 0) == 128
    f32 = bench.frame_activation_bytes(tconfig.TrackerConfig())
    assert f32 == 224 * 224 * 3 * 4 + 4 * 202 * 202 * 64 + 8 * 200 * 200 * 64


def tiny_cfg():
    """tests/test_benchmarks.py's tiny config."""
    g = 4
    return tconfig.TrackerConfig(
        core="ntm",
        ntm=tconfig.NTMConfig(mem_size=16, mem_dim=8, controller_hidden_size=24, read_head_size=2),
        data=tconfig.DataConfig(crop_size=8 * g, gt_width=g),
        num_features=g * g,
        feature_points=tuple((y, x) for y in range(g) for x in range(g)),
    )


def tiny_setup(device=None):
    cfg = tiny_cfg()
    core = make_core(cfg)
    vgg = init_vgg_params(torch.Generator().manual_seed(0), device)
    params = core.init_params(torch.Generator().manual_seed(1), cfg.input_depth, device)
    return cfg, core, vgg, params


def test_device_loop_throughput_runs():
    fps = bench._device_loop_throughput(*tiny_setup("cpu"), B=2, H=48, W=64, iters=1, device="cpu")
    assert np.isfinite(fps) and fps > 0


def test_cached_train_throughput_runs():
    fps, ms = bench._cached_train_throughput(2, 2, iters=1, device="cpu", base=tiny_cfg())
    assert np.isfinite(fps) and fps > 0 and ms > 0


def _jax_result_keys():
    """The keys of the JAX bench's JSON line, in order (its `result` dict
    literal in main)."""
    tree = ast.parse(open(jbench.__file__).read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    node = next(n for n in ast.walk(main) if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", "") == "result")
    return [k.value for k in node.value.keys]


def test_main_on_the_cpu_prints_the_jax_keys(monkeypatch, capsys):
    monkeypatch.setattr(bench, "_headline_setup", tiny_setup)
    tracks = {p: os.path.getmtime(p) for p in glob.glob(os.path.join(ROOT, "TRACK_*.json"))}
    result = bench.main(device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == result
    keys, jax_keys = list(result), _jax_result_keys()
    assert keys[:len(jax_keys)] == jax_keys
    assert result["platform"] == "cpu" and result["best_batch"] == 4 and result["value"] > 0
    assert result["headline_variant"] == "weights-as-args"
    assert result["frames_per_sec_weights_as_args"] == result["value"]
    assert result["mfu"] is None and result["train_mfu"] is None and result["p50_roundtrip_ms_b1"] is None
    assert result["frame_gflops"] == round(jbench.frame_flops(dataclasses.replace(
        jconfig.TrackerConfig(), ntm=jconfig.NTMConfig(mem_size=16, mem_dim=8, controller_hidden_size=24,
                                                       read_head_size=2),
        data=jconfig.DataConfig(crop_size=32, gt_width=4), num_features=16,
        feature_points=tiny_cfg().feature_points)) / 1e9, 2)
    assert {p: os.path.getmtime(p) for p in glob.glob(os.path.join(ROOT, "TRACK_*.json"))} == tracks
