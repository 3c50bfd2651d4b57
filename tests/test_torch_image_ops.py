"""data/image_ops.crop_and_resize_mm, the fleet's and the device loop's
crop, on the CPU: against the JAX package's (at Precision.HIGHEST, as its
fleet and device loop run it) and against the port's gather crop, with
the cases of tests/test_image_ops.py:121-160."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntm_tracker_tpu.data.image_ops import crop_and_resize_mm as jax_crop_mm
from ntm_tracker_tpu_torch.data.image_ops import crop_and_resize, crop_and_resize_mm

# float32 on both sides, 0..255 pixels: the products sum two nonzero terms
# per output in another order than the gather's lerp (a few ulps of 255)
MM_ATOL = 1e-4

BOXES = np.array([
    [0.1, 0.2, 0.7, 0.9],
    [-0.2, -0.1, 0.5, 0.6],   # spills past the top-left
    [0.4, 0.5, 1.3, 1.2],     # spills past the bottom-right
    [0.0, 0.0, 1.0, 1.0],     # the whole frame
], np.float32)


def _images(seed, shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32) * 255


@pytest.mark.parametrize("crop", [(24, 16), (7, 9)])
def test_matches_jax_and_the_gather_crop(crop):
    imgs = _images(7, (4, 37, 53, 3))
    want = np.asarray(jax_crop_mm(jnp.asarray(imgs), jnp.asarray(BOXES), crop, precision=jax.lax.Precision.HIGHEST))
    got = crop_and_resize_mm(torch.tensor(imgs), torch.tensor(BOXES), crop)
    gather = crop_and_resize(torch.tensor(imgs), torch.tensor(BOXES), crop)
    assert got.shape == (4, *crop, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=MM_ATOL)
    np.testing.assert_allclose(got.numpy(), gather.numpy(), atol=MM_ATOL)
    # the spilled boxes really reach outside the frame
    assert (got[1, 0] == 0).all() and (got[2, -1] == 0).all()


def test_extrapolation_value():
    imgs = torch.tensor(_images(8, (1, 10, 10, 1)))
    boxes = torch.tensor([[-1.0, -1.0, -0.2, -0.2]])  # wholly outside
    out = crop_and_resize_mm(imgs, boxes, (4, 4), extrapolation_value=7.5)
    np.testing.assert_allclose(out.numpy(), 7.5)
    partly = torch.tensor([[-0.5, -0.5, 0.5, 0.5]])
    got = crop_and_resize_mm(imgs, partly, (5, 5), extrapolation_value=-3.0)
    want = crop_and_resize(imgs, partly, (5, 5), extrapolation_value=-3.0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=MM_ATOL)


def test_single_pixel_output():
    imgs = _images(9, (2, 9, 9, 2))
    boxes = np.array([[0.2, 0.2, 0.6, 0.6], [0.0, 0.0, 1.0, 1.0]], np.float32)
    got = crop_and_resize_mm(torch.tensor(imgs), torch.tensor(boxes), (1, 1))
    want = np.asarray(jax_crop_mm(jnp.asarray(imgs), jnp.asarray(boxes), (1, 1), precision=jax.lax.Precision.HIGHEST))
    np.testing.assert_allclose(got.numpy(), want, atol=MM_ATOL)
    np.testing.assert_allclose(got.numpy(), crop_and_resize(torch.tensor(imgs), torch.tensor(boxes), (1, 1)).numpy(),
                               atol=MM_ATOL)


def test_uint8_frames_and_precision_restored():
    imgs = (np.random.RandomState(10).rand(2, 20, 30, 3) * 255).astype(np.uint8)
    before = torch.get_float32_matmul_precision()
    got = crop_and_resize_mm(torch.tensor(imgs), torch.tensor(BOXES[:2]), (8, 8))
    assert torch.get_float32_matmul_precision() == before
    want = crop_and_resize(torch.tensor(imgs), torch.tensor(BOXES[:2]), (8, 8))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=MM_ATOL)
