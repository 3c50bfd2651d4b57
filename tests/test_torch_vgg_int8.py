"""models/vgg_int8.py on the CPU against the JAX package's int8 token path
(ntm_tracker_tpu/models/vgg_int8.py, XLA's s8 x s8 -> s32 convs) on the
same weights and crops: the tokens within 1e-6 of the largest, the int32
sums of torch._int_mm over an im2col equal to an exact float64 conv,
per-sample scales independent of batchmates, the quantizers against JAX's, and the
token cosine against the exact path above JAX's bar (tests/test_vgg.py:208)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntm_tracker_tpu.models import vgg_int8 as jint8
from ntm_tracker_tpu.models.vgg import init_vgg_params as jinit_vgg
from ntm_tracker_tpu_torch.config import TrackerConfig
from ntm_tracker_tpu_torch.interop import flatten_vgg_params, vgg_params_from_flat
from ntm_tracker_tpu_torch.models import vgg_int8
from ntm_tracker_tpu_torch.models.vgg import vgg16_conv43_tokens
from ntm_tracker_tpu_torch.train.experiments import frame_tokens

# int32 sums are exact on both sides; what differs is float32 rounding in
# the dequantization and the bias add, and a rounding tie that lands the
# other way in a requantization moves one token by a quantum's share
TOKEN_TOL = 1e-6
COS_MIN = 0.995


@pytest.fixture(scope="module")
def weights():
    jv = jinit_vgg(jax.random.PRNGKey(0))
    return jv, vgg_params_from_flat(flatten_vgg_params(jv))


@pytest.fixture(scope="module")
def crops():
    return np.random.RandomState(1).uniform(-120.0, 130.0, (2, 224, 224, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def port_tokens(weights, crops):
    _, tv = weights
    with torch.no_grad():
        return vgg_int8.vgg16_conv43_tokens_int8(tv, torch.tensor(crops))


def test_tokens_match_jax(weights, crops, port_tokens):
    jv, _ = weights
    want = np.asarray(jax.jit(jint8.vgg16_conv43_tokens_int8)(jv, jnp.asarray(crops)))
    got = port_tokens.numpy()
    assert got.shape == want.shape == (2, 64, 512)
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    assert err <= TOKEN_TOL, err


@pytest.mark.parametrize("c_in", [3, 16])
def test_conv_int32_sums_exact(c_in):
    """The im2col + torch._int_mm sums against a float64 conv of the same
    integers (exact: every |sum| < 2^53), at full-range operands; C_in = 3
    pads K = 27 to 32."""
    g = torch.Generator().manual_seed(c_in)
    x_q = torch.randint(-127, 128, (2, 9, 11, c_in), generator=g, dtype=torch.int8)
    w_q = torch.randint(-127, 128, (24, c_in, 3, 3), generator=g, dtype=torch.int8)
    got = vgg_int8.conv_int32(x_q, w_q)
    want = torch.nn.functional.conv2d(x_q.permute(0, 3, 1, 2).double(), w_q.double()).permute(0, 2, 3, 1)
    assert got.dtype == torch.int32 and got.shape == (2, 7, 9, 24)
    assert torch.equal(got.double(), want)


def test_close_to_the_exact_path(weights, crops, port_tokens):
    _, tv = weights
    with torch.no_grad():
        t32 = vgg16_conv43_tokens(tv, torch.tensor(crops)).numpy()
    t8 = port_tokens.numpy()
    cos = (t32 * t8).sum(-1) / (np.linalg.norm(t32, axis=-1) * np.linalg.norm(t8, axis=-1) + 1e-12)
    rel = np.linalg.norm(t8 - t32) / np.linalg.norm(t32)
    assert cos.min() > COS_MIN, cos.min()
    assert rel < 0.09, rel


def test_batch_independent(weights, crops, port_tokens):
    """Per-sample activation scales: a crop's tokens do not change with a
    batchmate of ten times its range."""
    _, tv = weights
    a = torch.tensor(crops[:1])
    with torch.no_grad():
        paired = vgg_int8.vgg16_conv43_tokens_int8(tv, torch.cat([a, a * 10.0]))
    assert torch.equal(paired[:1], port_tokens[:1])


def test_quantizers_match_jax():
    rng = np.random.RandomState(2)
    w = (rng.randn(3, 3, 8, 16) * 0.3).astype(np.float32)  # HWIO
    jq, js = jint8._quantize_weights(jnp.asarray(w))
    tq, ts = vgg_int8.quantize_weights(torch.tensor(w.transpose(3, 2, 0, 1)))
    assert tq.dtype == torch.int8 and ts.shape == (16,)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # a tie: 0.5 and 1.5 quanta round half to even on both sides
    x = np.array([[[[127.0, 0.5, 1.5, -2.5]]]], np.float32)
    jxq, jxs = jint8._quantize_activations(jnp.asarray(x))
    txq, txs = vgg_int8.quantize_activations(torch.tensor(x))
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(txs.numpy(), np.asarray(jxs))
    assert txq.flatten().tolist() == [127, 0, 2, -2]


def test_frame_tokens_dispatch(weights, crops, port_tokens):
    _, tv = weights
    cfg = dataclasses.replace(TrackerConfig(), vgg_int8=True)
    with torch.no_grad():
        assert torch.equal(frame_tokens(cfg, tv, torch.tensor(crops)), port_tokens)
    with pytest.raises(ValueError, match="canonical"):
        frame_tokens(cfg, tv, torch.zeros(1, 64, 64, 3))
    with pytest.raises(ValueError, match="224x224"):
        vgg_int8.vgg16_conv43_tokens_int8(tv, torch.zeros(1, 64, 64, 3))
