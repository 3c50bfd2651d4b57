"""The training slice on the CPU: offsets_loss against the forward_v1
fixture; OffsetExperiment at full width (NTM 128x20, 4+1 heads, hidden 200,
input 514) with sequence_length=2 (T=130), B=2, on synthetic_cached_batch:
loss and every gradient against JAX's value_and_grad(loss_fn), three
train steps (params and optimizer state after each) and the eval step;
the synthetic batches and the frame modes against the JAX functions."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntm_tracker_tpu import config as jconfig
from ntm_tracker_tpu.models import vgg as jvgg
from ntm_tracker_tpu.train import experiments as jexp
from ntm_tracker_tpu.train.serialize import gather_delimiter_outputs as jgather
from ntm_tracker_tpu_torch import config as tconfig
from ntm_tracker_tpu_torch.interop import (
    flatten_ntm_params,
    flatten_opt_state,
    flatten_vgg_params,
    ntm_params_from_flat,
    opt_state_from_flat,
    vgg_params_from_flat,
)
from ntm_tracker_tpu_torch.train import experiments as texp
from ntm_tracker_tpu_torch.train.optim import tree_leaves, tree_map
from ntm_tracker_tpu_torch.train.serialize import gather_delimiter_outputs, offsets_loss

from tests.fixture_params import seeded_vgg_params

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
B, L = 2, 2
# float32 on both sides over T=130 recurrent steps at full width, summed in
# other orders by XLA and PyTorch's CPU kernels (each ~1e-7 relative):
LOSS_RTOL = 1e-5
# gradients: |port - jax| <= GRAD_ATOL * max|jax| + GRAD_RTOL * |jax|
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3
# params after a step differ by the update's error: a 1e-3 share of the
# learning rate (1e-4), the update's scale
PARAM_ATOL = 1e-7


def _configs(**train):
    """(JAX TrackerConfig, port TrackerConfig), the same fields."""
    jcfg = jconfig.TrackerConfig(train=jconfig.TrainConfig(batch_size=B, sequence_length=L, **train))
    tcfg = tconfig.TrackerConfig(train=tconfig.TrainConfig(batch_size=B, sequence_length=L, **train))
    return jcfg, tcfg


def _torch_params(jparams):
    return ntm_params_from_flat(flatten_ntm_params(jparams))


def _assert_tree(got_flat, ref_flat, atol_scale, rtol, what):
    assert set(got_flat) == set(ref_flat)
    for k, r in ref_flat.items():
        scale = float(np.abs(r).max())
        np.testing.assert_allclose(got_flat[k], r, atol=atol_scale * max(scale, 1e-12), rtol=rtol,
                                   err_msg=f"{what} {k}")


def test_offsets_loss_matches_fixture():
    fix = np.load(os.path.join(FIXTURES, "forward_v1.npz"))
    # the fixture's inputs, made as tests/gen_fixtures.py makes them
    logits = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (1, 15, 2)))
    offs = np.asarray(jax.random.normal(jax.random.PRNGKey(6), (1, 3, 2)) * 0.2)
    got = offsets_loss(torch.tensor(logits), torch.tensor(offs), 4)
    np.testing.assert_allclose(float(got), float(fix["offsets_loss"]), rtol=1e-6)
    np.testing.assert_array_equal(gather_delimiter_outputs(torch.tensor(logits), 4).numpy(),
                                  np.asarray(jgather(jnp.asarray(logits), 4)))


@pytest.mark.parametrize("predict_scale", [False, True], ids=["offsets", "scale"])
def test_synthetic_batches_match_jax(predict_scale):
    jcfg, tcfg = _configs()
    data = dict(resize_hw=(24, 40), crop_size=16)
    jcfg = dataclasses.replace(jcfg, predict_scale=predict_scale, data=jconfig.DataConfig(**data))
    tcfg = dataclasses.replace(tcfg, predict_scale=predict_scale, data=tconfig.DataConfig(**data))
    want = jexp.synthetic_cached_batch(jcfg, np.random.RandomState(3))
    got = texp.synthetic_cached_batch(tcfg, np.random.RandomState(3))
    assert set(got) == set(want) and got["features"].dtype == np.float16
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    for mode in texp.IMAGE_MODES:
        want = jexp.synthetic_offset_batch(jcfg, np.random.RandomState(4), mode)
        got = texp.synthetic_offset_batch(tcfg, np.random.RandomState(4), mode)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{mode} {k}")


def _full_width():
    jcfg, tcfg = _configs()
    jx = jexp.OffsetExperiment(jcfg, None)
    tx = texp.OffsetExperiment(tcfg, None, device="cpu")
    jparams, jopt_state = jx.init(jax.random.PRNGKey(0))
    batch = texp.synthetic_cached_batch(tcfg, np.random.RandomState(0))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    return jx, tx, jparams, jopt_state, batch, jbatch


def test_full_width_loss_and_grads_match_jax():
    jx, tx, jparams, _, batch, jbatch = _full_width()
    assert jx.cfg.total_steps == 130 and jx.cfg.input_depth == 514
    (jloss, jaux), jgrads = jax.value_and_grad(jx.loss_fn, has_aux=True)(jparams, jbatch)
    params = tree_map(lambda t: t.requires_grad_(), _torch_params(jparams))
    loss, aux = tx.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    it = iter(grads)
    grads = tree_map(lambda _: next(it), params)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(aux["pred_offsets"].detach().numpy(), np.asarray(jaux["pred_offsets"]), atol=1e-5)
    _assert_tree(flatten_ntm_params(grads), flatten_ntm_params(jgrads), GRAD_ATOL, GRAD_RTOL, "gradient of")


def test_full_width_train_and_eval_steps_match_jax():
    jx, tx, jparams, jopt_state, batch, jbatch = _full_width()
    jstep, tstep = jax.jit(jx.make_train_step()), tx.make_train_step()
    params = _torch_params(jparams)
    opt_state = opt_state_from_flat(flatten_opt_state(jopt_state))
    for step in range(3):
        jparams, jopt_state, jm = jstep(jparams, jopt_state, jbatch)
        params, opt_state, m = tstep(params, opt_state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_RTOL, err_msg=f"step {step}")
        got = flatten_ntm_params(params)
        for k, r in flatten_ntm_params(jparams).items():
            np.testing.assert_allclose(got[k], r, atol=PARAM_ATOL, err_msg=f"step {step} {k}")
        got, want = flatten_opt_state(opt_state), flatten_opt_state(jopt_state)
        _assert_tree({k: v for k, v in got.items() if k.startswith("mom/")},
                     {k: v for k, v in want.items() if k.startswith("mom/")}, GRAD_ATOL, GRAD_RTOL, f"step {step}")
        for k in want:
            if k.startswith("ms/"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=f"step {step} {k}")
    jaux = jx.make_eval_step()(jparams, jbatch)
    aux = tx.make_eval_step()(params, batch)
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=LOSS_RTOL)


def test_train_step_routes_through_fused_bptt_only_on_cuda():
    """On the CPU, fused_bptt="auto" and False give the same step, bit for bit."""
    _, tcfg = _configs()
    cfg_false = dataclasses.replace(tcfg, train=dataclasses.replace(tcfg.train, fused_bptt=False))
    small = dict(ntm=tconfig.NTMConfig(mem_size=8, mem_dim=4, controller_hidden_size=8, read_head_size=1),
                 num_features=4, feature_depth=6, data=tconfig.DataConfig(gt_width=2, crop_size=8))
    a = texp.OffsetExperiment(dataclasses.replace(tcfg, **small), None, device="cpu")
    b = texp.OffsetExperiment(dataclasses.replace(cfg_false, **small), None, device="cpu")
    params, opt_state = a.init(torch.Generator().manual_seed(0))
    batch = texp.synthetic_cached_batch(a.cfg, np.random.RandomState(0))
    pa, sa, ma = a.make_train_step()(params, opt_state, batch)
    pb, sb, mb = b.make_train_step()(params, opt_state, batch)
    assert torch.equal(ma["loss"], mb["loss"])
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(pa), tree_leaves(pb)))


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    _, tcfg = _configs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        texp.OffsetExperiment(tcfg, None)


def test_cropped_frames_give_jax_tokens():
    """The "cropped" image mode: the frozen VGG's tokens, at full width."""
    jcfg, tcfg = _configs()
    np_vgg = seeded_vgg_params(jvgg.VGG16_PREFIX)
    jvgg_params = {k: {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in np_vgg.items()}
    jx = jexp.OffsetExperiment(dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train, batch_size=1)),
                               jvgg_params)
    tx = texp.OffsetExperiment(dataclasses.replace(tcfg, train=dataclasses.replace(tcfg.train, batch_size=1)),
                               vgg_params_from_flat(flatten_vgg_params(np_vgg)), device="cpu")
    batch = texp.synthetic_offset_batch(tx.cfg, np.random.RandomState(5), "cropped")
    want = np.asarray(jx.batch_features({k: jnp.asarray(v) for k, v in batch.items()}))
    got = tx.batch_features(tx.device_batch(batch)).numpy()
    assert got.shape == (1, L, 64, 512)
    # the VGG tests' tolerance: 1e-5 of the largest activation
    np.testing.assert_allclose(got, want, atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("mode", ["raw", "resized"])
def test_frame_modes_give_jax_crops(mode):
    jcfg, tcfg = _configs()
    data = dict(resize_hw=(24, 40), crop_size=16)
    jcfg = dataclasses.replace(jcfg, data=jconfig.DataConfig(**data))
    tcfg = dataclasses.replace(tcfg, data=tconfig.DataConfig(**data))
    jx = jexp.OffsetExperiment(jcfg, None, image_mode=mode)
    tx = texp.OffsetExperiment(tcfg, None, image_mode=mode, device="cpu")
    rs = np.random.RandomState(6)
    images = (rs.rand(3, 30, 52, 3) * 255).astype(np.float32)
    boxes = np.array([[0.1, 0.2, 0.7, 0.9], [-0.2, 0.0, 0.5, 1.2], [0.3, 0.3, 0.4, 0.35]], np.float32)
    want = np.asarray(jx.images_to_crops(jnp.asarray(images), jnp.asarray(boxes)))
    got = tx.images_to_crops(torch.tensor(images), torch.tensor(boxes)).numpy()
    assert got.shape == (3, 16, 16, 3)
    # bilinear weights of 255-scale pixels in float32: a few ulps of 255
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_targets_carry_the_scale_head():
    jcfg, tcfg = _configs()
    jcfg = dataclasses.replace(jcfg, predict_scale=True, ntm=jconfig.NTMConfig(output_dim=3))
    tcfg = dataclasses.replace(tcfg, predict_scale=True, ntm=tconfig.NTMConfig(output_dim=3))
    batch = texp.synthetic_cached_batch(tcfg, np.random.RandomState(8))
    want = np.asarray(jexp.OffsetExperiment(jcfg, None)._targets({k: jnp.asarray(v) for k, v in batch.items()}, B))
    tx = texp.OffsetExperiment(tcfg, None, device="cpu")
    np.testing.assert_array_equal(tx._targets(tx.device_batch(batch), B).numpy(), want)
    with pytest.raises(ValueError, match="image_mode"):
        texp.OffsetExperiment(tcfg, None, image_mode="bogus", device="cpu")
