"""The DNC's repeat-copy task and trainer on the CPU: the sampled batches
bit for bit against the JAX package's from the same seed, the masked loss
and the readable view against JAX's, and three train_repeat_copy
iterations from JAX's initial weights (carried by interop.py through the
trainer's resume): the losses and the params against JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntm_tracker_tpu.models.dnc import repeat_copy as jrc
from ntm_tracker_tpu.train import dnc_trainer as jtr
from ntm_tracker_tpu_torch.interop import flatten_opt_state, flatten_params, opt_state_from_flat, params_from_flat
from ntm_tracker_tpu_torch.models.dnc import repeat_copy as trc
from ntm_tracker_tpu_torch.train import dnc_trainer as ttr
from ntm_tracker_tpu_torch.train.harness import CheckpointManager

# the masked loss: one sum of float32 terms in another order
LOSS_TOL = 1e-6
# three train steps of the DNC (T = 9 cell steps a batch): the losses and
# the params after them
TRAIN_TOL = 1e-4
# the params' three updates (each ~lr = 1e-4 wide, so TRAIN_TOL alone would
# not see them), against the largest: RMSProp divides each gradient by
# its running rms, so a gradient's float32 error passes through at its
# relative size
UPDATE_TOL = 1e-2
TINY = dict(hidden_size=16, memory_size=8, word_size=8, num_bits=3, batch_size=4, report_interval=2, seed=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the DNC step is hundreds of small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("kw", [dict(num_bits=4, batch_size=3, min_length=1, max_length=3, seed=0),
                                dict(num_bits=6, batch_size=5, max_length=2, min_repeats=2, max_repeats=4, seed=7)],
                         ids=["short", "repeats"])
def test_batches_bit_for_bit(kw):
    jtask, ttask = jrc.RepeatCopy(**kw), trc.RepeatCopy(**kw)
    assert ttask.max_total_length == jtask.max_total_length and ttask.obs_size == jtask.obs_size
    for _ in range(4):
        for got, want in zip(ttask.sample(), jtask.sample()):
            np.testing.assert_array_equal(got, np.asarray(want))
    assert ttask.to_human_readable(ttask.sample(), whole_batch=True) == jtask.to_human_readable(
        jtask.sample(), whole_batch=True)


@pytest.mark.parametrize("time_average,bits", [(False, False), (True, False), (False, True)])
def test_masked_loss_against_jax(time_average, bits):
    rng = np.random.RandomState(2)
    logits = rng.randn(7, 3, 5).astype(np.float32) * 3
    target = rng.randint(0, 2, (7, 3, 5)).astype(np.float32)
    mask = rng.randint(0, 2, (7, 3)).astype(np.float32)
    want = float(jrc.masked_sigmoid_cross_entropy(jnp.asarray(logits), jnp.asarray(target), jnp.asarray(mask),
                                                  time_average, bits))
    got = float(trc.masked_sigmoid_cross_entropy(torch.tensor(logits), torch.tensor(target), torch.tensor(mask),
                                                 time_average, bits))
    assert abs(got - want) <= LOSS_TOL * abs(want)
    assert float(trc.masked_sigmoid_cross_entropy(torch.ones(4, 1, 2) * 5, torch.zeros(4, 1, 2),
                                                  torch.zeros(4, 1))) == 0.0


def test_three_iterations_against_jax(tmp_path):
    logs = {"jax": [], "port": []}
    jparams, jlosses = jtr.train_repeat_copy(jtr.RepeatCopyTrainConfig(**TINY), num_iterations=3,
                                             log=logs["jax"].append)
    # the port starts from JAX's initial weights and optimizer state: a
    # step-0 checkpoint, which the trainer resumes from
    task, dcfg, _, _ = ttr.repeat_copy_setup(ttr.RepeatCopyTrainConfig(**TINY), "cpu")
    jcfg = jtr.RepeatCopyTrainConfig(**TINY)
    from ntm_tracker_tpu.config import DNCConfig as JDNCConfig
    from ntm_tracker_tpu.models.dnc.dnc import init_dnc_params as jinit
    from ntm_tracker_tpu.train.optim import tf_rmsprop

    jp0 = jinit(jax.random.PRNGKey(jcfg.seed), JDNCConfig(
        output_dim=task.target_size, memory_size=jcfg.memory_size, word_size=jcfg.word_size,
        num_reads=1, num_writes=1, hidden_size=jcfg.hidden_size, clip_value=jcfg.clip_value), task.obs_size)
    js0 = tf_rmsprop(1e-4).init(jp0)
    CheckpointManager(str(tmp_path)).save(0, {"params": params_from_flat(flatten_params(jp0)),
                                               "opt_state": opt_state_from_flat(flatten_opt_state(js0))})
    tparams, tlosses = ttr.train_repeat_copy(
        ttr.RepeatCopyTrainConfig(**TINY, checkpoint_interval=1000, checkpoint_dir=str(tmp_path)),
        num_iterations=3, log=logs["port"].append, device="cpu")
    np.testing.assert_allclose(tlosses, jlosses, rtol=TRAIN_TOL)
    got, want, start = flatten_params(tparams), flatten_params(jparams), flatten_params(jp0)
    assert got.keys() == want.keys()
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, atol=TRAIN_TOL, err_msg=key)
        # the three updates themselves, against the largest of JAX's
        moved = w - start[key]
        np.testing.assert_allclose(got[key] - start[key], moved, atol=UPDATE_TOL * np.abs(moved).max(), err_msg=key)
    assert logs["port"][0] == "resumed from checkpoint step 0"
    # the report at iteration 2: its average loss and readable sample
    assert logs["port"][1].split("\n")[0][:30] == logs["jax"][0].split("\n")[0][:30]
    assert "Model Output:" in logs["port"][1]


def test_trainer_needs_a_card_unless_told_cpu():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttr.train_repeat_copy(ttr.RepeatCopyTrainConfig(**TINY), num_iterations=1)
