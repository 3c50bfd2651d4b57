"""The harness on the CPU: the manifest's names, the files found by name
(a new one with no edit), the traffic and weights from the seed, the
no-JAX check, the plain reference against the port's plain path at tiny
sizes (and a lower precision failing it)."""

import copy
import json
import re
import shutil
from pathlib import Path

import pytest
import torch

from portbench import harness, nojax, traffic, weights
from portbench.reference import model

BENCH = Path(__file__).resolve().parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SEED = 2 ** 33 + 12345


@pytest.fixture(scope="module")
def man():
    return harness.manifest()


def tiny_ntm():
    conf = json.loads((BENCH / "configs" / "ntm_offsets.json").read_text())
    conf["ntm"].update(mem_size=8, mem_dim=4, controller_hidden_size=16, read_head_size=2)
    return conf


# -- the manifest ------------------------------------------------------------

def test_manifest_names_units_and_keys(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [e["name"] for group in ("configs", "workloads", "end_to_end", "per_layer") for e in man[group]]
    assert all(NAME.match(n) for n in names), names
    assert len(names) == len(set(names))
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["reduced"] == []
    e2e = {m["name"]: m for m in man["end_to_end"]}
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in man["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in man["workloads"]}
    for m in man["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for cell in cells:
        reported = [m["name"] for m in man["end_to_end"] if cell in m.get("workloads", cells)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in m["workloads"] for m in man["per_layer"])
    assert len(json.dumps(man)) < 64 * 1024


def test_every_cell_finds_its_files_by_name(man):
    for w in man["workloads"]:
        run = harness.make_run(man, w["name"], 1, 1.0, False, "cpu")
        assert run.conf["name"] == w["config"]
        assert harness.runner_class(run.traffic["kind"]) is not None
        assert set(run.limits) and all("limit" in v for v in run.limits.values())
        for m in harness.metrics_of(man, w["name"], False) + harness.metrics_of(man, w["name"], True):
            assert callable(harness.metric_reader(m["name"]))
    for path in (BENCH / "metrics").glob("*.py"):
        assert callable(harness.metric_reader(path.stem))


def test_a_new_cell_and_metric_are_found_without_an_edit(man, tmp_path):
    """A later change adds a configuration, a traffic mix, a cell's limits
    and a metric as files and entries; no file that is there changes."""
    bench = tmp_path / "portbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    conf = json.loads((bench / "configs" / "ntm_offsets.json").read_text())
    conf["name"] = "ntm_dummy"
    (bench / "configs" / "ntm_dummy.json").write_text(json.dumps(conf))
    t = json.loads((bench / "traffic" / "train_b256.json").read_text())
    t["batch"] = 8
    (bench / "traffic" / "train_b8.json").write_text(json.dumps(t))
    (bench / "limits" / "ntm_dummy.train_b8.json").write_text(
        (bench / "limits" / "ntm_offsets.train_b256.json").read_text())
    (bench / "metrics" / "dummy_ms.train.py").write_text("def read(m):\n    return 1.5\n")
    new = copy.deepcopy(man)
    new["configs"].append({"name": "ntm_dummy", "source": "x", "file": "portbench/configs/ntm_dummy.json",
                           "reduced": [], "why": "x"})
    new["workloads"].append({"name": "ntm_dummy.train_b8", "config": "ntm_dummy", "traffic": "train_b8",
                             "chips": 1, "why": "x"})
    new["per_layer"].append({"name": "dummy_ms.train", "unit": "ms", "better": "lower", "source": "program_span",
                             "layer": "host loop", "moves": "train_frames_per_s",
                             "workloads": ["ntm_dummy.train_b8"]})
    run = harness.make_run(new, "ntm_dummy.train_b8", 1, 1.0, True, "cpu", bench=bench)
    assert run.traffic["batch"] == 8 and run.conf["name"] == "ntm_dummy"
    assert [m["name"] for m in harness.metrics_of(new, "ntm_dummy.train_b8", True)] == ["dummy_ms.train"]
    assert harness.metric_reader("dummy_ms.train", bench)(None) == 1.5


# -- traffic and weights from the seed ---------------------------------------

def test_cached_batches_are_deterministic_in_the_seed():
    conf = tiny_ntm()
    a = traffic.cached_batches(conf, 2, 3, 2, SEED, "cpu")
    b = traffic.cached_batches(conf, 2, 3, 2, SEED, "cpu")
    c = traffic.cached_batches(conf, 2, 3, 2, SEED + 1, "cpu")
    for x, y, z in zip(a, b, c):
        for k in x:
            assert torch.equal(x[k], y[k]) and x[k].shape == z[k].shape
        assert not torch.equal(x["features"], z["features"])
    assert a[0]["features"].dtype == torch.float16 and a[0]["features"].shape == (6, 64, 512)
    assert not torch.equal(a[0]["features"], a[1]["features"])
    assert torch.allclose(a[0]["gts"].sum(dim=(1, 2)), torch.ones(6))


def test_weights_are_deterministic_in_the_seed():
    conf = tiny_ntm()
    a, b = weights.core_weights(conf, SEED, "cpu"), weights.core_weights(conf, SEED, "cpu")
    c = weights.core_weights(conf, SEED + 1, "cpu")
    la, lb, lc = model.leaves(a), model.leaves(b), model.leaves(c)
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert any(not torch.equal(x, z) for x, z in zip(la, lc))


# -- the no-JAX check -----------------------------------------------------------

def test_nojax_compares_top_level_names_whole():
    assert nojax.forbidden_loaded(["jax.numpy", "numpy"]) == ["jax"]
    assert nojax.forbidden_loaded(["ntm_tracker_tpu.cli"]) == ["ntm_tracker_tpu"]
    assert nojax.forbidden_loaded(["jaxlib", "flax.linen"]) == ["flax", "jaxlib"]
    assert nojax.forbidden_loaded(["ntm_tracker_tpu_torch.cli", "ntm_tracker_tpu_torch", "jaxtyping"]) == []


def test_the_benchmark_imports_no_jax():
    import ast

    for path in BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in nojax.FORBIDDEN, (path, n)
    for path in (BENCH / "reference").rglob("*.py"):
        assert "ntm_tracker_tpu" not in path.read_text(), path


# -- the reference against the port's plain path ----------------------------------

def state_dict(state):
    """The port's carried NTM state as the reference's named tensors."""
    ctrl = state["controller_state"]
    return {"M": state["M"], "w": state["w"], "read": state["read"],
            "c": [c for c, _ in ctrl], "h": [h for _, h in ctrl]}


def state_gap(program, reference):
    """The worst state tensor's largest element gap, over its largest
    magnitude in the reference."""
    flat = {}
    for name, state in (("p", program), ("r", reference)):
        for k, v in state.items():
            for i, t in enumerate(v if isinstance(v, list) else [v]):
                flat[(name, k, i)] = t
    return max(float((flat[("p", k, i)] - t).abs().max()) / (float(t.abs().max()) or 1.0)
               for (side, k, i), t in flat.items() if side == "r")

def _port_cfg(conf):
    from portbench import program

    return program.tracker_config(conf)


def test_reference_core_equals_the_port_and_bf16_fails():
    from ntm_tracker_tpu_torch.models.core import make_core

    conf = tiny_ntm()
    params = weights.core_weights(conf, SEED, "cpu")
    x = torch.rand(3, 30, 514, generator=torch.Generator().manual_seed(1)) * 40
    port = make_core(_port_cfg(conf))
    logits_p, state_p = port.unroll(params, x, port.init_state(params, 3), remat=False, fused_bptt=False)
    logits_r, state_r = model.unroll(conf, params, x, model.initial_state(conf, params, 3, "cpu"))
    gap = state_gap(state_dict(state_p), state_r)
    assert (logits_p - logits_r).abs().max() <= 1e-5 and gap <= 1e-5
    bf = model.rebuild(params, [p.bfloat16().float() for p in model.leaves(params)])
    logits_b, state_b = model.unroll(conf, bf, x.bfloat16().float(), model.initial_state(conf, bf, 3, "cpu"))
    assert (logits_b - logits_r).abs().max() > 1e-3 or state_gap(state_b, state_r) > 1e-3


def test_reference_train_step_equals_the_port():
    from portbench import program

    conf = tiny_ntm()
    cfg = program.tracker_config(conf, batch_size=2, sequence_length=3)
    exp = program.OffsetExperiment(cfg, None, device="cpu")
    params = weights.core_weights(conf, SEED, "cpu")
    opt = exp.optimizer()
    batch = traffic.cached_batches(conf, 2, 3, 1, SEED, "cpu")[0]
    new, _, metrics = exp.make_train_step()(params, opt.init(params), batch)
    loss, grads = model.train_gradients(conf, params, batch, 3, 2)
    grads = model.clip_by_global_norm(grads, 5.0)
    leaves = model.leaves(params)
    ref, _, _ = model.rmsprop(conf["optimizer"], leaves, grads, [torch.ones_like(p) for p in leaves],
                              [torch.zeros_like(p) for p in leaves])
    assert float(metrics["loss"]) == pytest.approx(float(loss), rel=1e-6)
    for p, r, p0 in zip(model.leaves(new), ref, leaves):
        assert (p - r).abs().max() <= 1e-6 * max(1e-8, float((r - p0).abs().max())) + 1e-9
