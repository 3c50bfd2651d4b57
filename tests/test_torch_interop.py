"""Weights carried between the JAX package and the port survive the round
trip bit for bit."""

import jax
import numpy as np
import pytest
import torch

from ntm_tracker_tpu.config import NTMConfig as JNTMConfig
from ntm_tracker_tpu.models.ntm_cell import init_ntm_params
from ntm_tracker_tpu.models.vgg import init_vgg_params
from ntm_tracker_tpu_torch.interop import (
    flatten_ntm_params,
    flatten_vgg_params,
    ntm_params_from_flat,
    vgg_params_from_flat,
)


@pytest.mark.parametrize("layers", [1, 2])
def test_ntm_round_trip(layers, tmp_path):
    cfg = JNTMConfig(mem_size=16, mem_dim=8, controller_hidden_size=16, controller_num_layers=layers)
    jp = init_ntm_params(jax.random.PRNGKey(3), cfg, 12)
    flat = flatten_ntm_params(jp)
    assert f"controller[{layers - 1}].kernel" in flat and "init_M" in flat
    # through an .npz, as weights travel between hosts
    np.savez(tmp_path / "ntm.npz", **flat)
    loaded = dict(np.load(tmp_path / "ntm.npz"))
    tp = ntm_params_from_flat(loaded)
    assert len(tp["controller"]) == layers
    assert tuple(tp["controller"][0]["kernel"].shape) == tuple(jp["controller"][0]["kernel"].shape)
    assert all(t.dtype == torch.float32 for t in flatten_tensors(tp))
    back = flatten_ntm_params(tp)
    assert back.keys() == flat.keys()
    for key in flat:
        np.testing.assert_array_equal(back[key], np.asarray(flat[key]), err_msg=key)


def flatten_tensors(params):
    for key, value in params.items():
        if key == "controller":
            for layer in value:
                yield from layer.values()
        else:
            yield value


def test_controller_layers_must_be_numbered_from_zero():
    with pytest.raises(ValueError):
        ntm_params_from_flat({"controller[1].kernel": np.zeros((2, 4)), "controller[1].bias": np.zeros(4)})


def test_vgg_round_trip_hwio_to_oihw():
    jp = init_vgg_params(jax.random.PRNGKey(4))
    flat = flatten_vgg_params(jp)
    tp = vgg_params_from_flat(flat)
    w_hwio = np.asarray(jp["conv2/conv2_1"]["weights"])  # [3,3,64,128]
    w_oihw = tp["conv2/conv2_1"]["weights"]
    assert tuple(w_oihw.shape) == (128, 64, 3, 3) and w_oihw.is_contiguous()
    np.testing.assert_array_equal(w_oihw.numpy()[5, 7, 1, 2], w_hwio[1, 2, 7, 5])
    back = flatten_vgg_params(tp, layout="OIHW")
    assert back.keys() == flat.keys()
    for key in flat:
        np.testing.assert_array_equal(back[key], flat[key], err_msg=key)
    with pytest.raises(ValueError):
        flatten_vgg_params(tp, layout="NHWC")
