"""Closed-loop active-resize training on the CPU: the loss, the final box
and every gradient against the JAX package's ActiveResizeExperiment from
the same weights (interop.py) and batch. The port runs each frame as one
core.unroll from the carried state (the plain route here; B2 once a frame
on cuda), JAX as a per-step scan over core.step: the same function. Also
the synthetic batch bit for bit, the scale head's variant, one train step
and the in-graph geometry against the host's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntm_tracker_tpu import config as jconfig
from ntm_tracker_tpu.models.vgg import init_vgg_params as jinit_vgg
from ntm_tracker_tpu.train import active_resize as jar
from ntm_tracker_tpu_torch import config as tconfig
from ntm_tracker_tpu_torch.data import geometry
from ntm_tracker_tpu_torch.interop import flatten_params, flatten_vgg_params, vgg_params_from_flat
from ntm_tracker_tpu_torch.train import active_resize as tar

from tests.torch_lab_helpers import assert_loss_and_grads, jax_value_and_grad, port_value_and_grad, to_port

POINTS = ((1, 1), (1, 2), (2, 1), (2, 2))
# the tokens come from the frozen VGG on each side (XLA's convs against
# PyTorch's, ~1e-6 apart): the initial state's gradients, ~1e-5 of the
# largest, carry that at up to 1.6e-4 of their own largest entry, so each
# gradient is held within 1e-3 of its own largest (chip_smoke.py's bound)
GRAD_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the plain loop is thousands of small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def vggs():
    jvgg = jinit_vgg(jax.random.PRNGKey(0))
    return jvgg, vgg_params_from_flat(flatten_vgg_params(jvgg))


def _cfgs(batch=2, seq_len=4, predict_scale=False):
    def build(mod):
        return mod.TrackerConfig(
            core="ntm",
            ntm=mod.NTMConfig(output_dim=3 if predict_scale else 2, mem_size=16, mem_dim=8,
                              controller_hidden_size=24, read_head_size=2),
            data=mod.DataConfig(crop_size=32, gt_width=2),
            train=mod.TrainConfig(batch_size=batch, sequence_length=seq_len, learning_rate=1e-3),
            num_features=4, feature_points=POINTS, predict_scale=predict_scale)
    return build(jconfig), build(tconfig)


@pytest.mark.parametrize("compress_dim,predict_scale", [(8, False), (0, False), (8, True)],
                         ids=["compressor", "raw", "scale_head"])
def test_loss_bbox_and_gradients_against_jax(vggs, compress_dim, predict_scale):
    jvgg, tvgg = vggs
    jcfg, tcfg = _cfgs(predict_scale=predict_scale)
    jx = jar.ActiveResizeExperiment(jcfg, jvgg, compress_dim=compress_dim)
    tx = tar.ActiveResizeExperiment(tcfg, tvgg, compress_dim=compress_dim, device="cpu")
    jparams, jopt = jx.init(jax.random.PRNGKey(1))
    batch = tar.synthetic_active_batch(tcfg, np.random.RandomState(0), (48, 64))
    jbatch = jar.synthetic_active_batch(jcfg, np.random.RandomState(0), (48, 64))
    for k in batch:
        np.testing.assert_array_equal(batch[k], jbatch[k])
    jl, jaux, jg = jax_value_and_grad(jx.loss_fn, jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    params = to_port(jparams)
    loss, aux, grads = port_value_and_grad(tx.loss_fn, params, batch)
    assert_loss_and_grads(loss, grads, jl, jg, grad_tol=GRAD_TOL)
    np.testing.assert_allclose(aux["final_bbox"].detach().numpy(), np.asarray(jaux["final_bbox"]), atol=1e-5)
    assert not aux["final_bbox"].requires_grad
    # one train step's update
    jnew, _, _ = jax.jit(jx.make_train_step())(jparams, jopt, {k: jnp.asarray(v) for k, v in batch.items()})
    new, _, m = tx.make_train_step()(params, tx.optimizer().init(params), batch)
    got, ref, start = flatten_params(new), flatten_params(jnew), flatten_params(jparams)
    for key, r in ref.items():
        moved = r - start[key]
        np.testing.assert_allclose(got[key] - start[key], moved, atol=1e-2 * max(np.abs(moved).max(), 1e-12),
                                   err_msg=key)


def test_closed_loop_recrop_moves_with_the_params(vggs):
    """The crop of frame t > 0 follows the prediction: two inits, two final
    boxes on the same data."""
    _, tvgg = vggs
    _, tcfg = _cfgs()
    tx = tar.ActiveResizeExperiment(tcfg, tvgg, compress_dim=8, device="cpu")
    batch = tar.synthetic_active_batch(tcfg, np.random.RandomState(3), (48, 64))
    boxes = [tx.loss_fn(tx.init(torch.Generator().manual_seed(s))[0], batch)[1]["final_bbox"] for s in (1, 7)]
    assert not torch.allclose(boxes[0], boxes[1])


def test_geometry_twins_match_the_host():
    b = torch.tensor([[0.3, 0.4, 0.5, 0.7], [0.1, 0.2, 0.6, 0.9]])
    cb = tar.cropbox_of(b, 8, 6)
    np.testing.assert_allclose(cb[0].numpy(), geometry.calculate_cropbox([0.3, 0.4, 0.5, 0.7], 8, 6), atol=1e-6)
    tb = tar.to_crop_space(b, cb)
    ref = geometry.apply_transformation([0.3, 0.4, 0.5, 0.7], geometry.calculate_transformation(
        geometry.calculate_cropbox([0.3, 0.4, 0.5, 0.7], 8, 6)))
    np.testing.assert_allclose(tb[0].numpy(), np.asarray(ref, np.float32), atol=1e-5)
    np.testing.assert_allclose(tar.to_image_space(tb, cb).numpy(), b.numpy(), atol=1e-6)
    np.testing.assert_allclose(tar.canonical_box(8, 6).numpy(), geometry.initial_transformed_bbox(8, 6), atol=1e-7)


def test_needs_a_card_unless_told_cpu():
    _, tcfg = _cfgs()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tar.ActiveResizeExperiment(tcfg, None)
