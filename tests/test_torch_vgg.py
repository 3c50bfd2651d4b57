"""The port's VGG-16 prefix vs the JAX package and the executed TF conv
golden, on the CPU, with the golden's seeded weights carried across."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixture_params import seeded_vgg_image, seeded_vgg_params
from ntm_tracker_tpu.models import vgg as jvgg
from ntm_tracker_tpu_torch.interop import flatten_vgg_params, vgg_params_from_flat
from ntm_tracker_tpu_torch.models import vgg as tvgg

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
# float32 convs (reductions over up to 4608 terms) through 10 layers,
# summed in different orders by XLA, TF and PyTorch's CPU convolutions:
# relative to the largest activation (measured: 2.8e-6 between the
# port's CPU convs and the TF golden, 0.9e-6 between float64 and XLA)
REL_TOL = 1e-5


@pytest.fixture(scope="module")
def weights():
    np_params = seeded_vgg_params(jvgg.VGG16_PREFIX)
    jax_params = {k: {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in np_params.items()}
    return jax_params, vgg_params_from_flat(flatten_vgg_params(np_params))


def _assert_rel(got, ref, tol=REL_TOL):
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max())
    assert scale > 0
    np.testing.assert_allclose(np.asarray(got), ref, atol=tol * scale)


def test_constants_match_jax():
    assert tvgg.VGG16_PREFIX == jvgg.VGG16_PREFIX
    assert tvgg.CONV43_POINTS == jvgg.CONV43_POINTS
    np.testing.assert_array_equal(tvgg.VGG_MEAN, jvgg.VGG_MEAN)


def test_conv43_tokens_match_jax_at_224(weights):
    jax_params, t_params = weights
    img = np.random.RandomState(5).uniform(-120, 130, (1, 224, 224, 3)).astype(np.float32)
    ref = jvgg.vgg16_conv43_tokens(jax_params, jnp.asarray(img))
    with torch.no_grad():
        got = tvgg.vgg16_conv43_tokens(t_params, torch.tensor(img))
        full = tvgg.extract_features(tvgg.vgg16_features(t_params, torch.tensor(img)))
    assert tuple(got.shape) == (1, 64, 512)
    _assert_rel(got.numpy(), ref)
    # the receptive-field slice gives the full map's tokens
    _assert_rel(got.numpy(), full.numpy(), 1e-6)


def test_features_match_executed_tf_golden(weights):
    jax_params, t_params = weights
    g = np.load(os.path.join(FIXTURES, "tf_goldens_ops.npz"))
    with torch.no_grad():
        got = tvgg.vgg16_features(t_params, torch.tensor(seeded_vgg_image())).numpy()
    ref = g["vgg_conv43"]
    assert got.shape == ref.shape
    _assert_rel(got, ref)
    _assert_rel(got, jvgg.vgg16_features(jax_params, jnp.asarray(seeded_vgg_image())))


def test_custom_points_and_bounds():
    fmap = np.random.RandomState(6).randn(2, 5, 6, 3).astype(np.float32)
    pts = [(0, 1), (4, 5), (2, 2)]
    np.testing.assert_array_equal(tvgg.extract_features(torch.tensor(fmap), pts).numpy(),
                                  np.asarray(jvgg.extract_features(jnp.asarray(fmap), pts)))
    with pytest.raises(ValueError):
        tvgg.extract_features(torch.tensor(fmap), [(5, 0)])
    with pytest.raises(ValueError):
        tvgg.vgg16_features({}, torch.zeros(1, 32, 32, 3), endpoint="conv9")
    with pytest.raises(ValueError):
        tvgg.vgg16_conv43_tokens({}, torch.zeros(1, 200, 224, 3))


def test_seeded_init_shapes():
    params = tvgg.init_vgg_params(torch.Generator().manual_seed(0))
    in_ch = 3
    for name, out_ch, _ in tvgg.VGG16_PREFIX:
        assert tuple(params[name]["weights"].shape) == (out_ch, in_ch, 3, 3)
        in_ch = out_ch
