"""train/harness.py: checkpoints (torch.save of {"params", "opt_state"}
with the save_path.txt breadcrumb), the JSONL metric logger, and
train_loop over a few tiny OffsetExperiment steps, validation first."""

import json
import os

import numpy as np
import pytest
import torch

from ntm_tracker_tpu_torch.config import DataConfig, NTMConfig, TrackerConfig, TrainConfig
from ntm_tracker_tpu_torch.train.experiments import OffsetExperiment, synthetic_cached_batch
from ntm_tracker_tpu_torch.train.harness import CheckpointManager, MetricLogger, train_loop
from ntm_tracker_tpu_torch.train.optim import tree_leaves

TINY = TrackerConfig(
    ntm=NTMConfig(mem_size=8, mem_dim=4, controller_hidden_size=8, read_head_size=1),
    num_features=4, feature_depth=6, data=DataConfig(gt_width=2, crop_size=8),
    train=TrainConfig(batch_size=2, sequence_length=3, learning_rate=1e-2),
)


def _experiment():
    exp = OffsetExperiment(TINY, None, device="cpu")
    params, opt_state = exp.init(torch.Generator().manual_seed(0))
    return exp, params, opt_state


def _same_tree(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def test_checkpoint_round_trip(tmp_path):
    _, params, opt_state = _experiment()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    mgr.save(0, {"params": params, "opt_state": opt_state})
    later = {k: (v if k == "controller" else v + 1) for k, v in params.items()}
    mgr.save(5, {"params": later, "opt_state": opt_state})
    assert mgr.latest_step() == 5
    with open(tmp_path / "ckpt" / "save_path.txt") as f:
        assert f.read() == os.path.join(str(tmp_path / "ckpt"), "5")
    got = mgr.restore()
    assert _same_tree(got["params"], later) and _same_tree(got["opt_state"], opt_state)
    assert _same_tree(mgr.restore(0)["params"], params)
    # a new manager over the same directory sees the same checkpoints
    assert CheckpointManager(str(tmp_path / "ckpt")).latest_step() == 5


def test_checkpoint_keeps_at_most_max_to_keep(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (0, 10, 20):
        mgr.save(step, {"x": torch.tensor([float(step)])})
    assert mgr.steps() == [10, 20]
    assert float(mgr.restore()["x"]) == 20.0


def test_metric_logger_writes_json_lines(tmp_path):
    log = MetricLogger(str(tmp_path / "logs"))
    log.log(0, train_loss=torch.tensor(1.5))
    log.log(3, val_loss=0.25, other=np.float32(2.0))
    log.close()
    with open(tmp_path / "logs" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [0, 3]
    assert recs[0]["train_loss"] == 1.5 and recs[1]["val_loss"] == 0.25 and recs[1]["other"] == 2.0
    assert all(isinstance(r["time"], float) for r in recs)


def test_train_loop_validates_first_then_trains(tmp_path):
    exp, params, opt_state = _experiment()
    train_step, eval_step = exp.make_train_step(), exp.make_eval_step()
    calls = []

    def counted_train(p, s, b):
        calls.append("train")
        return train_step(p, s, b)

    def counted_eval(p, b):
        calls.append("eval")
        return eval_step(p, b)

    batches = [synthetic_cached_batch(TINY, np.random.RandomState(i)) for i in range(5)]
    val = [synthetic_cached_batch(TINY, np.random.RandomState(100 + i)) for i in range(3)]
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    new_params, new_state, steps = train_loop(
        counted_train, counted_eval, params, opt_state, iter(batches), lambda: iter(val),
        log_dir=str(tmp_path / "log"), validation_interval=2, validation_batch=2, log_interval=1,
        checkpoint=mgr, max_steps=4,
    )
    assert steps == 4
    # validation (2 batches) at steps 0 and 2, each before that step trains
    assert calls == ["eval", "eval", "train", "train", "eval", "eval", "train", "train"]
    assert mgr.steps() == [0, 2]
    assert _same_tree(mgr.restore(0)["params"], params)
    assert not _same_tree(new_params, params)
    with open(tmp_path / "log" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [(r["step"], sorted(k for k in r if k.endswith("loss"))) for r in recs] == [
        (0, ["val_loss"]), (0, ["train_loss"]), (1, ["train_loss"]),
        (2, ["val_loss"]), (2, ["train_loss"]), (3, ["train_loss"]),
    ]
    assert all(np.isfinite(r.get("train_loss", r.get("val_loss"))) for r in recs)
    # training lowers the loss on the batches it trains on
    after = exp.make_eval_step()(new_params, batches[0])["loss"]
    before = exp.make_eval_step()(params, batches[0])["loss"]
    assert float(after) < float(before)


def test_train_loop_refuses_profiling(tmp_path):
    exp, params, opt_state = _experiment()
    with pytest.raises(NotImplementedError, match="profiling"):
        train_loop(exp.make_train_step(), None, params, opt_state, [], log_dir=str(tmp_path),
                   profile_steps=(1, 2))


def test_checkpoint_restores_onto_another_device_map(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"params": {"w": torch.ones(2)}})
    got = mgr.restore(map_location="cpu")
    assert got["params"]["w"].device.type == "cpu"
