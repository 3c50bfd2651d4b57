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
    """A profile window that ends before it starts is refused; a window the
    loop never reaches writes nothing."""
    exp, params, opt_state = _experiment()
    with pytest.raises(ValueError, match="stop 1 < start 2"):
        train_loop(exp.make_train_step(), None, params, opt_state, [], log_dir=str(tmp_path),
                   profile_steps=(2, 1))
    train_loop(exp.make_train_step(), None, params, opt_state, [], log_dir=str(tmp_path), profile_steps=(1, 2))
    assert not (tmp_path / "profile").exists()


def test_checkpoint_restores_onto_another_device_map(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"params": {"w": torch.ones(2)}})
    got = mgr.restore(map_location="cpu")
    assert got["params"]["w"].device.type == "cpu"


def _dnc_tree(seed: int):
    """A full checkpoint of the DNC: params, the optimizer state and a
    DNCState (NamedTuples nested two deep)."""
    from ntm_tracker_tpu_torch.config import DNCConfig
    from ntm_tracker_tpu_torch.models.dnc.dnc import init_dnc_params, init_dnc_state
    from ntm_tracker_tpu_torch.train.optim import tree_map

    dcfg = DNCConfig(memory_size=6, word_size=3, num_reads=2, hidden_size=5)
    g = torch.Generator().manual_seed(seed)
    params = init_dnc_params(dcfg, 7, g)
    state = tree_map(lambda t: t + torch.rand(t.shape, generator=g), init_dnc_state(dcfg, 2))
    opt = {"ms": tree_map(torch.ones_like, params), "mom": tree_map(torch.zeros_like, params)}
    return {"params": params, "opt_state": opt, "state": state}


def test_partial_restore_of_params_and_namedtuple_states(tmp_path):
    from ntm_tracker_tpu_torch.models.dnc.dnc import DNCState

    full = _dnc_tree(0)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(3, full)
    template = _dnc_tree(1)
    # params only, from a checkpoint that also holds opt_state and state
    got = mgr.restore(template={"params": template["params"]}, partial=True)
    assert list(got) == ["params"] and _same_tree(got["params"], full["params"])
    # the DNC's state comes back as its NamedTuples
    got = mgr.restore(template={"state": template["state"]}, partial=True)
    assert isinstance(got["state"], DNCState)
    assert type(got["state"].access_state) is type(full["state"].access_state)
    assert type(got["state"].access_state.linkage) is type(full["state"].access_state.linkage)
    assert _same_tree(got["state"], full["state"])
    # the whole tree with its template; without one, NamedTuples are field dicts (as orbax keeps them)
    assert _same_tree(mgr.restore(template=template), full)
    raw = mgr.restore()
    assert isinstance(raw["state"], dict) and list(raw["state"]) == list(DNCState._fields)
    # a template that is not the checkpoint's tree, without partial=True, raises
    with pytest.raises(ValueError, match="partial=True"):
        mgr.restore(template={"params": template["params"]})
    with pytest.raises(ValueError, match="shape"):
        bad = _dnc_tree(2)
        bad["params"]["out_b"] = torch.zeros(9)
        mgr.restore(template={"params": bad["params"]}, partial=True)
    with pytest.raises(ValueError, match="lacks"):
        mgr.restore(template={"extra": torch.zeros(1)}, partial=True)


def sorted_leaves(tree) -> list:
    """The leaves in jax.tree_util's order: dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in sorted_leaves(v)]
    return [tree]


def test_partial_restore_matches_the_jax_package(tmp_path):
    """The same tree saved by the JAX package's CheckpointManager (orbax)
    and by the port's, restored params-only and state-only from each in
    its own package: the same arrays and the same NamedTuple structure."""
    import jax

    from ntm_tracker_tpu.models.dnc import dnc as jdnc
    from ntm_tracker_tpu.train.harness import CheckpointManager as JCheckpointManager
    from ntm_tracker_tpu_torch.train.optim import tree_map

    full = _dnc_tree(0)
    as_np = lambda tree: tree_map(lambda t: t.numpy(), tree)  # noqa: E731

    from ntm_tracker_tpu.models.dnc import access as jaccess
    from ntm_tracker_tpu.models.dnc import addressing as jaddressing

    jax_types = {"DNCState": jdnc.DNCState, "AccessState": jaccess.AccessState,
                 "TemporalLinkageState": jaddressing.TemporalLinkageState}

    def to_jax_state(s):
        """The port's state as the JAX package's NamedTuples of numpy arrays."""
        if isinstance(s, torch.Tensor):
            return s.numpy()
        if hasattr(s, "_fields"):
            return jax_types[type(s).__name__](*map(to_jax_state, s))
        return type(s)(map(to_jax_state, s))

    jtree = {"params": as_np(full["params"]), "opt_state": as_np(full["opt_state"]),
             "state": to_jax_state(full["state"])}
    jmgr = JCheckpointManager(str(tmp_path / "jax"))
    jmgr.save(3, jtree)
    mgr = CheckpointManager(str(tmp_path / "port"))
    mgr.save(3, full)
    tmpl = _dnc_tree(1)
    jtmpl = {"params": as_np(tmpl["params"]), "state": to_jax_state(tmpl["state"])}
    for key in ("params", "state"):
        got = mgr.restore(template={key: tmpl[key]}, partial=True)[key]
        ref = jmgr.restore(template={key: jtmpl[key]}, partial=True)[key]
        got_leaves = [t.numpy() for t in sorted_leaves(got)]
        ref_leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(ref)]
        assert len(got_leaves) == len(ref_leaves)
        for a, b in zip(got_leaves, ref_leaves):
            np.testing.assert_array_equal(a, b)
        if key == "state":
            assert got._fields == ref._fields and got.access_state._fields == ref.access_state._fields
