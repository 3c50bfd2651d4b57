"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run on the CPU (the cell's configuration at its published widths, its
traffic cut to a few rows and frames, its own limits), once sound and
once for each fault the cell can have: a step that returns its state
unchanged; half of the batch left out, the mean taken over the rest; an
answer (the loss) altered where it is produced; and one leaf's gradient
scaled by 1.01 inside the step. (No cell spans chips, so none can leave
out an exchange between them.)

Half the batch and the scaled gradient are also read at the cell's own
size on the card (`-m card`).
"""

import json
import time

import pytest
import torch

from portbench import harness

SEED = 2 ** 32 + 977
CARD_SEEDS = (4_200_000_001, 4_200_000_002, 4_200_000_003)

SMALL = dict(batch=4, sequence_length=3, pool=3, reference_block_rows=4, trace_steps=1)


def run_cell(workload, fault=None, monkeypatch=None, seed=SEED, device="cpu", seconds=0.5, small=True):
    man = harness.manifest()
    run = harness.make_run(man, workload, seed, seconds, False, device)
    if small:
        run.traffic.update(SMALL)
    if fault is not None:
        fault(monkeypatch)
    _, m, numbers, peak = harness.measure(run, time.time())
    return harness.result_line(man, m, numbers, peak)


def _wrap_train_step(monkeypatch, wrap):
    from portbench import program

    orig = program.OffsetExperiment.make_train_step
    monkeypatch.setattr(program.OffsetExperiment, "make_train_step", lambda self: wrap(self, orig(self)))


def train_state_unchanged(monkeypatch):
    def wrap(exp, step):
        def broken(params, opt_state, batch):
            _, _, metrics = step(params, opt_state, batch)
            return params, opt_state, metrics
        return broken
    _wrap_train_step(monkeypatch, wrap)


def train_half_the_batch(monkeypatch):
    from portbench import program

    orig = program.OffsetExperiment.loss_fn

    def loss_fn(self, params, batch):
        n = len(batch["y_offsets"]) // 2
        L = self.cfg.train.sequence_length
        half = {k: v[: (n // L) * L] for k, v in batch.items()}
        loss, aux = orig(self, params, half)
        return loss * 2, aux

    monkeypatch.setattr(program.OffsetExperiment, "loss_fn", loss_fn)


def train_answer_altered(monkeypatch):
    def wrap(exp, step):
        def broken(params, opt_state, batch):
            params, opt_state, metrics = step(params, opt_state, batch)
            return params, opt_state, {"loss": metrics["loss"] * 1.01}
        return broken
    _wrap_train_step(monkeypatch, wrap)


def train_gradient_scaled(monkeypatch):
    """The largest leaf's gradient (the controller's kernel, from B2's
    reduction) x 1.01 before the clip and the update."""
    from ntm_tracker_tpu_torch.train import optim

    orig = optim.TFRMSProp.update

    def update(self, grads, state, params):
        leaves = optim.tree_leaves(grads)
        big = max(range(len(leaves)), key=lambda i: leaves[i].numel())
        fill = iter([g * 1.01 if i == big else g for i, g in enumerate(leaves)])
        return orig(self, optim.tree_map(lambda _: next(fill), grads), state, params)

    monkeypatch.setattr(optim.TFRMSProp, "update", update)


def test_a_sound_train_run_is_correct():
    line = run_cell("ntm_offsets.train_b256")
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("fault", [train_state_unchanged, train_half_the_batch, train_answer_altered,
                                   train_gradient_scaled])
def test_a_broken_train_run_is_not_correct(fault, monkeypatch):
    line = run_cell("ntm_offsets.train_b256", fault, monkeypatch)
    assert not line["correct"], line["checks"]


@pytest.mark.card
@pytest.mark.parametrize("fault", [train_half_the_batch, train_gradient_scaled])
def test_a_broken_train_run_at_the_cells_size_is_not_correct(fault, monkeypatch):
    """The fault at B=256, L=20 on three seeds (about 40 s a seed)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for seed in CARD_SEEDS:
        line = run_cell("ntm_offsets.train_b256", fault, monkeypatch, seed=seed, device="cuda", seconds=2.0,
                        small=False)
        print(json.dumps({"fault": fault.__name__, "seed": seed, "checks": line["checks"]}), flush=True)
        assert not line["correct"], line["checks"]
