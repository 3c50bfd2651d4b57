"""The port's memory, LSTM and image ops (crop, TF-1 resize, the frame
pipeline) vs the JAX package and the executed TF goldens, on the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntm_tracker_tpu.data import image_ops as jimage
from ntm_tracker_tpu.ops import lstm as jlstm
from ntm_tracker_tpu.ops import memory as jmem
from ntm_tracker_tpu_torch.data import image_ops as timage
from ntm_tracker_tpu_torch.ops import lstm as tlstm
from ntm_tracker_tpu_torch.ops import memory as tmem

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
# float32 on both sides; the frameworks sum in different orders
F32_TOL = 1e-5


@pytest.fixture(scope="module")
def ops_g():
    return np.load(os.path.join(FIXTURES, "tf_goldens_ops.npz"))


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("slotwise", [False, True])
def test_cosine_matches_jax(slotwise):
    mem, keys = _rand(0, 3, 16, 8), _rand(1, 3, 5, 8)
    mem[1, :, 2] = 0.0  # a zero row/column exercises the squared-norm floor
    jf = jmem.batched_slotwise_cosine_similarity if slotwise else jmem.batched_smooth_cosine_similarity
    tf = tmem.batched_slotwise_cosine_similarity if slotwise else tmem.batched_smooth_cosine_similarity
    np.testing.assert_allclose(tf(_t(mem), _t(keys)).numpy(), np.asarray(jf(jnp.asarray(mem), jnp.asarray(keys))),
                               atol=F32_TOL)


def test_l2_floor_is_on_the_squared_norm():
    # TF's l2_normalize: x * rsqrt(max(sum x^2, 1e-12)); a norm of 1e-7 is
    # below the floor, so the result is x * 1e6, not x / 1e-7
    x = torch.tensor([[1e-7, 0.0]])
    np.testing.assert_allclose(tmem._l2_normalize(x, 1).numpy(), [[1e-1, 0.0]], rtol=1e-6)


def test_cosine_golden(ops_g):
    got = tmem.batched_smooth_cosine_similarity(_t(ops_g["ops_cos_memory"]), _t(ops_g["ops_cos_keys"]))
    np.testing.assert_allclose(got.numpy(), ops_g["ops_cos_out"], atol=1e-5)


@pytest.mark.parametrize("S", [3, 5])
def test_circular_convolution_golden_and_jax(ops_g, S):
    assert tmem.circular_convolution_shifts(S) == jmem.circular_convolution_shifts(S)
    x, k = ops_g[f"ops_conv{S}_tensor"], ops_g[f"ops_conv{S}_kernel"]
    got = tmem.batched_circular_convolution(_t(x), _t(k)).numpy()
    np.testing.assert_allclose(got, ops_g[f"ops_conv{S}_out"], atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jmem.batched_circular_convolution(jnp.asarray(x), jnp.asarray(k))),
                               atol=F32_TOL)


def test_sharpen_matches_jax():
    w = np.abs(_rand(2, 2, 3, 16))
    gamma = 1.0 + np.abs(_rand(3, 2, 3, 1))
    np.testing.assert_allclose(tmem.sharpen(_t(w), _t(gamma)).numpy(),
                               np.asarray(jmem.sharpen(jnp.asarray(w), jnp.asarray(gamma))), rtol=1e-5, atol=1e-7)


def test_lstm_gate_golden(ops_g):
    params = {"kernel": _t(ops_g["lstm_kernel"]), "bias": _t(ops_g["lstm_bias"])}
    _, (c, h) = tlstm.lstm_cell_step(params, _t(ops_g["lstm_x"]), (_t(ops_g["lstm_c"]), _t(ops_g["lstm_h"])))
    np.testing.assert_allclose(c.numpy(), ops_g["lstm_new_c"], atol=1e-6)
    np.testing.assert_allclose(h.numpy(), ops_g["lstm_new_h"], atol=1e-6)


# bf16: both sides round operands and results to bf16 with float32 sums;
# only the summation order differs, which can flip the last bf16 bit
# (2^-8 relative) of an output of magnitude ~1
@pytest.mark.parametrize("compute_dtype,tol", [(None, F32_TOL), ("bf16", 1e-2)])
def test_multi_lstm_matches_jax(compute_dtype, tol):
    params = jlstm.init_lstm_params(jax.random.PRNGKey(0), 12, 8, 2, init_scale=0.3)
    x = _rand(4, 3, 12)
    state = [(_rand(5 + i, 3, 8), _rand(7 + i, 3, 8)) for i in range(2)]
    jcd, tcd = (jnp.bfloat16, torch.bfloat16) if compute_dtype else (None, None)
    jout, jstate = jlstm.multi_lstm_step(params, jnp.asarray(x), [tuple(map(jnp.asarray, s)) for s in state],
                                         compute_dtype=jcd)
    tparams = [{k: _t(v) for k, v in p.items()} for p in params]
    tout, tstate = tlstm.multi_lstm_step(tparams, _t(x), [tuple(map(_t, s)) for s in state], compute_dtype=tcd)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=tol)
    for (tc, th), (jc, jh) in zip(tstate, jstate):
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=tol)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=tol)


def test_bf16_matmul_policy():
    # operands and result rounded through bf16, sums in float32
    a, b = _rand(8, 4, 64), _rand(9, 64, 5)
    got = tlstm.matmul(_t(a), _t(b), torch.bfloat16)
    ab = torch.tensor(a).bfloat16().double() @ torch.tensor(b).bfloat16().double()
    np.testing.assert_array_equal(got.numpy(), ab.bfloat16().float().numpy())
    assert got.dtype == torch.float32


@pytest.mark.parametrize("hw", [(14, 14), (7, 9), (1, 5)])
def test_crop_and_resize_matches_jax_and_golden(ops_g, hw):
    imgs, boxes = ops_g["car_images"], ops_g["car_boxes"]
    got = timage.crop_and_resize(_t(imgs), _t(boxes), hw).numpy()
    ref = np.asarray(jimage.crop_and_resize(jnp.asarray(imgs), jnp.asarray(boxes), hw))
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-6)
    if f"car_out_{hw[0]}x{hw[1]}" in ops_g:
        np.testing.assert_allclose(got, ops_g[f"car_out_{hw[0]}x{hw[1]}"], atol=1e-3, rtol=1e-5)


def test_crop_and_resize_extrapolates_outside_the_image():
    img = np.full((1, 10, 12, 3), 7.0, np.float32)
    box = np.array([[-0.5, -0.5, 0.5, 0.5]], np.float32)
    got = timage.crop_and_resize(_t(img), _t(box), (6, 6), extrapolation_value=-1.0).numpy()
    ref = np.asarray(jimage.crop_and_resize(jnp.asarray(img), jnp.asarray(box), (6, 6), extrapolation_value=-1.0))
    np.testing.assert_allclose(got, ref, atol=1e-5)
    assert (got == -1.0).any() and (got == 7.0).any()


def test_image_ops_match_jax():
    rs = np.random.RandomState(7)
    img = (rs.rand(13, 21, 3) * 255).astype(np.uint8)
    for hw in [(26, 42), (7, 9), (13, 21)]:
        np.testing.assert_allclose(timage.tf1_resize_bilinear(torch.tensor(img), hw).numpy(),
                                   np.asarray(jimage.tf1_resize_bilinear(jnp.asarray(img), hw)), atol=1e-4)
    batch = np.stack([img, img[::-1]])
    np.testing.assert_allclose(timage.tf1_resize_bilinear(torch.tensor(batch), (5, 8)).numpy(),
                               np.asarray(jimage.tf1_resize_bilinear(jnp.asarray(batch), (5, 8))), atol=1e-4)
    box = np.array([0.1, -0.1, 0.8, 0.9], np.float32)
    got = timage.preprocess_frame(torch.tensor(img), torch.tensor(box), resize_hw=(26, 42), crop_size=10)
    want = jimage.preprocess_frame(jnp.asarray(img), jnp.asarray(box), resize_hw=(26, 42), crop_size=10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
