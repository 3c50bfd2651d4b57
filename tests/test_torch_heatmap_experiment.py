"""HeatmapExperiment (both serializations, with and without the
compressor), the copy-paste task and WholeFrameExperiment (plain and
two-step) on the CPU: the loss and every gradient against the JAX
package's value_and_grad from the same weights (interop.py) and batch, and
one train step's params."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntm_tracker_tpu import config as jconfig
from ntm_tracker_tpu.models.ntm_cell import init_ntm_params as jinit_ntm
from ntm_tracker_tpu.models.vgg import init_vgg_params as jinit_vgg
from ntm_tracker_tpu.train import experiments as jexp
from ntm_tracker_tpu_torch import config as tconfig
from ntm_tracker_tpu_torch.interop import flatten_params, flatten_vgg_params, vgg_params_from_flat
from ntm_tracker_tpu_torch.train import experiments as texp

from tests.torch_lab_helpers import assert_loss_and_grads, jax_value_and_grad, port_value_and_grad, to_port

POINTS = ((1, 1), (1, 2), (2, 1), (2, 2))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the plain loop is thousands of small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(out_dim, crop=32, **over):
    def build(mod):
        return mod.TrackerConfig(
            core="ntm",
            ntm=mod.NTMConfig(output_dim=out_dim, mem_size=16, mem_dim=8, controller_hidden_size=24, read_head_size=2),
            data=mod.DataConfig(crop_size=crop, resize_hw=(48, 64), gt_width=2),
            train=mod.TrainConfig(batch_size=2, sequence_length=3),
            num_features=4, feature_points=POINTS, **over)
    return build(jconfig), build(tconfig)


@pytest.mark.parametrize("serialization", ["sequential", "frame"])
@pytest.mark.parametrize("compress_dim", [0, 8], ids=["raw", "compressor"])
def test_heatmap_loss_and_gradients(serialization, compress_dim):
    jcfg, tcfg = _cfgs(1 if serialization == "sequential" else 4)
    jx = jexp.HeatmapExperiment(jcfg, None, serialization=serialization, compress_dim=compress_dim)
    tx = texp.HeatmapExperiment(tcfg, None, serialization=serialization, compress_dim=compress_dim, device="cpu")
    jparams, jopt = jx.init(jax.random.PRNGKey(1))
    batch = texp.synthetic_cached_batch(tcfg, np.random.RandomState(0))
    jl, _, jg = jax_value_and_grad(jx.loss_fn, jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    params = to_port(jparams)
    loss, aux, grads = port_value_and_grad(tx.loss_fn, params, batch)
    assert set(aux) == {"loss"}
    assert_loss_and_grads(loss, grads, jl, jg, zero=["core.out_b"] if serialization == "sequential" else [])
    # the port's own init has JAX's tree
    tparams, _ = tx.init(torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in flatten_params(tparams).items()} == {
        k: v.shape for k, v in flatten_params(jparams).items()}
    # one train step: the params move as JAX's do
    jnew, _, _ = jax.jit(jx.make_train_step())(jparams, jopt, {k: jnp.asarray(v) for k, v in batch.items()})
    new, _, m = tx.make_train_step()(params, tx.optimizer().init(params), batch)
    assert abs(float(m["loss"]) - float(jl)) <= 1e-5 * abs(float(jl))
    got, ref, start = flatten_params(new), flatten_params(jnew), flatten_params(jparams)
    for key, r in ref.items():
        if serialization == "sequential" and key == "core.out_b":
            continue  # its gradient is rounding (tests/torch_lab_helpers.py, ZERO_TOL)
        moved = r - start[key]
        np.testing.assert_allclose(got[key] - start[key], moved, atol=1e-2 * max(np.abs(moved).max(), 1e-12),
                                   err_msg=key)


def test_copy_paste_batch_and_loss():
    rs_j, rs_t = np.random.RandomState(5), np.random.RandomState(5)
    x, y = texp.make_copy_paste_batch(rs_t, 3, 4, 5)
    jx, jy = jexp.make_copy_paste_batch(rs_j, 3, 4, 5)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    kw = dict(output_dim=5, mem_size=16, mem_dim=8, controller_hidden_size=24, read_head_size=2)
    jp = jinit_ntm(jax.random.PRNGKey(2), jconfig.NTMConfig(**kw), 5)

    def jloss(p, b):
        loss = jexp.copy_paste_loss(p, jconfig.NTMConfig(**kw), b[0], b[1])
        return loss, {}

    def tloss(p, b):
        return texp.copy_paste_loss(p, tconfig.NTMConfig(**kw), torch.tensor(b[0]), torch.tensor(b[1])), {}

    jl, _, jg = jax_value_and_grad(jloss, jp, (jnp.asarray(x), jnp.asarray(y)))
    loss, _, grads = port_value_and_grad(tloss, to_port(jp), (x, y))
    assert_loss_and_grads(loss, grads, jl, jg)


@pytest.mark.parametrize("two_step", [False, True], ids=["plain", "two_step"])
def test_whole_frame_loss_and_gradients(two_step):
    """pool5 at 64x64 crops: a 2x2 grid (F = 4), the compressor at 8
    channels, IN = 4*8 + 4 (+1 two-step)."""
    jcfg, tcfg = _cfgs(2, crop=64)
    jvgg = jinit_vgg(jax.random.PRNGKey(0))
    tvgg = vgg_params_from_flat(flatten_vgg_params(jvgg))
    jx = jexp.WholeFrameExperiment(jcfg, jvgg, two_step=two_step, compress_dim=8)
    tx = texp.WholeFrameExperiment(tcfg, tvgg, two_step=two_step, compress_dim=8, device="cpu")
    assert tx.num_features == jx.num_features == 4 and tx.cfg.ntm.output_dim == jx.cfg.ntm.output_dim
    jparams, _ = jx.init(jax.random.PRNGKey(3))
    rs = np.random.RandomState(4)
    batch = {"images": (rs.rand(6, 64, 64, 3) * 255).astype(np.float32),
             "gts": (rs.rand(2, 3, 4) > 0.5).astype(np.float32)}
    jl, _, jg = jax_value_and_grad(jx.loss_fn, jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, _, grads = port_value_and_grad(tx.loss_fn, to_port(jparams), batch)
    assert_loss_and_grads(loss, grads, jl, jg)
    with pytest.raises(ValueError, match="--layers must match"):
        tx.loss_fn(to_port(jparams), {"images": batch["images"], "gts": np.zeros((2, 3, 9), np.float32)})


def test_lab_experiments_need_a_card_unless_told_cpu():
    _, tcfg = _cfgs(4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            texp.HeatmapExperiment(tcfg, None, serialization="frame")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            texp.WholeFrameExperiment(dataclasses.replace(tcfg, data=tconfig.DataConfig(crop_size=64)), None)
