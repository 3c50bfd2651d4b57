"""tools/track_artifact.py on the CPU, the counterparts of
tests/test_track_artifact.py: the write path at miniature sizes (every
record key, the core order, the scene sweep, the probe and both
tripwires far from firing: on the CPU both loops are float32), the
budget floor, the overwrite guard, the staged and resumed runs, and the
default output path (none of the JAX package's artifacts)."""

import dataclasses
import json
import os
import time

import pytest
import torch

import ntm_tracker_tpu_torch.tools.track_artifact as ta
from ntm_tracker_tpu_torch.tracking.demo import demo_config

SCENES = ["smooth", "scale", "fast", "texture"]
# every key of the JAX package's TRACK_r05.json core record
CORE_KEYS = {"core", "steps", "untrained_iou", "train_seconds", "scenes", "trained_iou", "drift_px", "drift_frac",
             "drift_step1_px", "drift_step1_frac", "drift_breach", "device_iou", "device_iou_gap",
             "device_iou_breach"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run thousands of small ops, which
    stall on thread hand-offs when the run's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _check_record(c, steps):
    assert CORE_KEYS <= set(c)
    assert c["steps"] == steps and c["train_seconds"] >= 0.0
    # means clamp per frame, so they live in [0, 1]
    assert 0.0 <= c["untrained_iou"] <= 1.0 and 0.0 <= c["trained_iou"] <= 1.0
    assert [s["scene"] for s in c["scenes"]] == SCENES
    for s in c["scenes"]:
        assert all(0.0 <= s[k] <= 1.0 for k in ("untrained_iou", "trained_iou", "device_iou"))
    assert 0.0 <= c["drift_step1_frac"] < ta.STEP1_FRAC_MAX
    assert 0.0 <= c["drift_step1_px"] <= c["drift_px"] + 1e-9 and c["drift_frac"] < 1e3
    assert c["drift_breach"] is False
    assert 0.0 <= c["device_iou"] <= 1.0 and c["device_iou_gap"] < ta.DEVICE_IOU_GAP_MAX
    assert c["device_iou_breach"] is False


def test_write_artifact_smoke(tmp_path):
    out = tmp_path / "TRACK_smoke.json"
    artifact = ta.write_artifact(str(out), train_steps=1, eval_frames=3, drift_frames=3, scene_frames=3,
                                 device="cpu")
    assert json.loads(out.read_text()) == artifact
    assert artifact["platform"] == "cpu" and {"device_kind", "card", "power_limit"} <= set(artifact)
    assert artifact["train_steps"] == 1
    assert [c["core"] for c in artifact["cores"]] == ["ntm", "dnc"]
    for c in artifact["cores"]:
        _check_record(c, 1)
    sh = artifact["scale_head"]
    assert sh["core"] == "ntm" and sh["predict_scale"] is True
    _check_record(sh, 1)


def _narrow_demo_config(**kw):
    """The demo config with L=2 and a narrow NTM: the budget logic's test
    trains ten steps."""
    cfg = demo_config(**kw)
    return dataclasses.replace(cfg, ntm=dataclasses.replace(cfg.ntm, mem_size=16, controller_hidden_size=16),
                               train=dataclasses.replace(cfg.train, sequence_length=2))


def test_budget_floor_truncates_honestly(monkeypatch):
    """A deadline-starved run below _MIN_TRAIN_STEPS records
    budget_truncated and no trained-accuracy fields."""
    monkeypatch.setattr(ta, "demo_config", _narrow_demo_config)
    rec = ta.run_core("ntm", train_steps=400, eval_frames=3, drift_frames=3, scene_frames=3,
                      deadline=time.time(), device="cpu")  # already expired: stops at step 10
    assert rec["budget_truncated"] is True
    assert 0 < rec["steps"] < ta._MIN_TRAIN_STEPS
    assert "trained_iou" not in rec and all("trained_iou" not in s for s in rec["scenes"])
    assert 0.0 <= rec["untrained_iou"] <= 1.0 and "drift_step1_frac" in rec


def _stub_run_core(steps, calls=None):
    def run(core, train_steps, flush=None, predict_scale=False, label=None, **kw):
        if calls is not None:
            calls.append("scale_head" if predict_scale else core)
        rec = {"core": core, "steps": steps, "untrained_iou": 0.1, "trained_iou": 0.5, "train_seconds": 0.0,
               "scenes": [], "drift_px": 0.0, "drift_frac": 0.0, "drift_step1_px": 0.0, "drift_step1_frac": 0.0,
               "drift_breach": False, "device_iou": 0.5, "device_iou_gap": 0.0, "device_iou_breach": False}
        if predict_scale:
            rec["predict_scale"] = True
        if flush is not None:
            flush(rec)
        return rec
    return run


def _existing(path, steps=400):
    path.write_text(json.dumps({"cores": [{"core": "ntm", "steps": steps}, {"core": "dnc", "steps": steps}]}))


class TestOverwriteGuard:
    def test_refuses_lower_fidelity(self, tmp_path, monkeypatch):
        out = tmp_path / "TRACK.json"
        _existing(out, steps=400)
        before = out.read_text()
        monkeypatch.setattr(ta, "run_core", _stub_run_core(10))
        ta.write_artifact(str(out), train_steps=10, device="cpu")
        assert out.read_text() == before  # the better artifact stays
        partial = json.loads((tmp_path / "TRACK.json.partial").read_text())
        assert partial["cores"][0]["steps"] == 10

    def test_promotes_equal_or_better(self, tmp_path, monkeypatch):
        out = tmp_path / "TRACK.json"
        _existing(out, steps=100)
        monkeypatch.setattr(ta, "run_core", _stub_run_core(400))
        ta.write_artifact(str(out), train_steps=400, device="cpu")
        assert json.loads(out.read_text())["cores"][0]["steps"] == 400
        assert not os.path.exists(str(out) + ".partial")

    def test_force_overrides(self, tmp_path, monkeypatch):
        out = tmp_path / "TRACK.json"
        _existing(out, steps=400)
        monkeypatch.setattr(ta, "run_core", _stub_run_core(10))
        ta.write_artifact(str(out), train_steps=10, force=True, device="cpu")
        assert json.loads(out.read_text())["cores"][0]["steps"] == 10

    def test_malformed_or_partial_existing_is_overwritable(self, tmp_path, monkeypatch):
        out = tmp_path / "TRACK.json"
        out.write_text("{not json")
        monkeypatch.setattr(ta, "run_core", _stub_run_core(10))
        ta.write_artifact(str(out), train_steps=10, device="cpu")
        assert json.loads(out.read_text())["cores"][0]["steps"] == 10
        out.write_text(json.dumps({"cores": [{"core": "ntm", "steps": 400}]}))  # one core: fidelity 0
        ta.write_artifact(str(out), train_steps=10, device="cpu")
        assert len(json.loads(out.read_text())["cores"]) == 2


def test_stages_then_resume_make_one_artifact(tmp_path, monkeypatch):
    out = tmp_path / "TRACK.json"
    calls = []
    monkeypatch.setattr(ta, "run_core", _stub_run_core(400, calls))
    ta.write_artifact(str(out), train_steps=400, device="cpu", stages=("ntm", "scale_head"))
    first = json.loads(out.read_text())
    assert [c["core"] for c in first["cores"]] == ["ntm"] and first["scale_head"]["predict_scale"]
    assert calls == ["ntm", "scale_head"]
    art = ta.write_artifact(str(out), train_steps=400, device="cpu", resume=True)
    assert calls == ["ntm", "scale_head", "dnc"]  # only the missing stage ran
    assert [c["core"] for c in art["cores"]] == ["ntm", "dnc"] and json.loads(out.read_text()) == art
    assert art["cores"][0] == first["cores"][0] and art["scale_head"] == first["scale_head"]
    # another protocol's artifact is not resumed
    with pytest.raises(ValueError, match="cannot resume"):
        ta.write_artifact(str(out), train_steps=10, device="cpu", resume=True)


def test_default_output_is_none_of_the_jax_artifacts():
    root = os.path.dirname(os.path.dirname(os.path.abspath(ta.__file__)))
    root = os.path.dirname(root)
    assert os.path.dirname(ta.DEFAULT_OUT) == root
    name = os.path.basename(ta.DEFAULT_OUT)
    assert name == "TRACK_H100.json"
    assert not name.startswith("TRACK_r0") and name not in ("TRACK.json", "TRACK_FLAGSHIP.json")
    from ntm_tracker_tpu_torch.tools import track_flagship

    assert os.path.basename(track_flagship.DEFAULT_OUT) == "TRACK_FLAGSHIP_H100.json"
    assert os.path.dirname(track_flagship.DEFAULT_OUT) == root
