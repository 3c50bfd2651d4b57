"""tools/track_flagship.py on the CPU against the JAX package's:
flagship_config field by field, build_dataset's tokens and labels at two
sequences, and one step of the train-to-plateau loop at a narrowed
config (its loss against JAX's train step on the same batch and params,
the record's keys), with the weights carried across by interop.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntm_tracker_tpu.models.vgg import init_vgg_params as jinit_vgg
from ntm_tracker_tpu.tools import track_flagship as jflag
from ntm_tracker_tpu.tracking import demo as jdemo
from ntm_tracker_tpu.train import experiments as jexp
from ntm_tracker_tpu_torch.interop import (
    flatten_params,
    flatten_vgg_params,
    opt_state_from_flat,
    flatten_opt_state,
    params_from_flat,
    vgg_params_from_flat,
)
from ntm_tracker_tpu_torch.tools import track_flagship as tflag
from ntm_tracker_tpu_torch.tracking import demo as tdemo

from tests.test_torch_demo import _fields

# tokens: the crops differ by float32 rounding of their sample coordinates
# (tests/test_torch_demo.py's CROP_ATOL), which the frozen VGG carries to
# ~5e-6 of the largest token
TOKEN_RTOL = 1e-4
# the offsets loss over T = 2 x 3 x 65 steps, float32 in other orders
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run thousands of small ops, which
    stall on thread hand-offs when the run's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _narrow(mod):
    """The demo's config at B=2, L=3: the flagship loop's narrow twin."""
    cfg = mod.demo_config()
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, batch_size=2, sequence_length=3))


def test_flagship_config_matches_jax():
    for b in (256, 64):
        got, want = _fields(tflag.flagship_config(b)), _fields(jflag.flagship_config(b))
        assert got == want and got["train"]["batch_size"] == b and got["compute_dtype"] == "float32"


def _dataset_pair():
    jcfg, tcfg = _narrow(jdemo), _narrow(tdemo)
    jvgg = jinit_vgg(jax.random.PRNGKey(0))
    vgg = vgg_params_from_flat(flatten_vgg_params(jvgg))
    return jcfg, tcfg, jvgg, vgg, jflag.build_dataset(jcfg, jvgg, 2, 0), tflag.build_dataset(tcfg, vgg, 2, 0,
                                                                                            device="cpu")


def test_build_dataset_matches_jax():
    jcfg, _, _, _, want, got = _dataset_pair()
    assert set(got) == set(want)
    assert tuple(got["features"].shape) == (2 * 3, jcfg.num_features, jcfg.feature_depth)
    ref = np.asarray(want["features"])
    np.testing.assert_allclose(got["features"].numpy(), ref, atol=TOKEN_RTOL * float(np.abs(ref).max()), rtol=0)
    for k in ("gts", "y_offsets", "x_offsets"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_one_step_of_the_loop_matches_jax():
    jcfg, tcfg, jvgg, vgg, _, batch = _dataset_pair()
    jx = jexp.OffsetExperiment(jcfg, jvgg, image_mode="cropped")
    jparams, jopt = jx.init(jax.random.PRNGKey(1))
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    _, _, jm = jax.jit(jx.make_train_step())(jparams, jopt, jbatch)
    params = params_from_flat(flatten_params(jparams))
    opt_state = opt_state_from_flat(flatten_opt_state(jopt))
    record, new_params, _ = tflag.train_to_plateau(tcfg, vgg, params, opt_state, batch, max_steps=1, eval_every=1,
                                                    eval_frames=3, scene_frames=3, device="cpu")
    assert record["loss_curve"][0][0] == 0
    # the curve keeps 5 decimals
    np.testing.assert_allclose(record["loss_curve"][0][1], float(jm["loss"]), rtol=LOSS_RTOL, atol=5e-6)
    assert record["steps"] == 1 and record["stop_reason"] == "max_steps"
    assert [s for s, _ in record["iou_curve"]] == [0, 1]
    assert record["trained_iou"] == record["iou_curve"][-1][1] and record["best_iou"] >= record["trained_iou"]
    assert [s["scene"] for s in record["scenes"]] == ["smooth", "scale", "fast", "texture"]
    assert all(0.0 <= v <= 1.0 for _, v in record["iou_curve"])
    assert record["train_seconds"] >= 0 and record["step_ms"] > 0
    assert not torch.equal(new_params["out_w"], params["out_w"])  # the step moved the weights
