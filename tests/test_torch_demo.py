"""tracking/demo.py on the CPU against the JAX package's: demo_config field
by field, the mean_clamped_iou contract (tests/test_demo.py:17),
training_batch's arrays, and eval_streaming_iou / eval_device_iou per
frame for the NTM, the DNC and the scale head, with the weights carried
across by interop.py."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ntm_tracker_tpu.models.core import make_core as jmake_core
from ntm_tracker_tpu.models.vgg import init_vgg_params as jinit_vgg
from ntm_tracker_tpu.tracking import demo as jdemo
from ntm_tracker_tpu_torch.interop import flatten_params, flatten_vgg_params, params_from_flat, vgg_params_from_flat
from ntm_tracker_tpu_torch.tracking import demo as tdemo

# The crops: the same bilinear formula in float32 on both sides, but XLA
# may fuse a sample coordinate's multiply-add where PyTorch rounds twice:
# one ulp of a coordinate (~1.5e-5 px at 320 px) times the largest step
# between neighbouring pixels of the clip (220: the square's edge).
CROP_ATOL = 5e-3
# Per-frame IoU over a 5-frame clip: float32 in other orders through four
# recrops moves a region by ~1e-3 px, an IoU by ~1e-3.
IOU_ATOL = 5e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run thousands of small ops, which
    stall on thread hand-offs when the run's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fields(cfg):
    """A config as nested plain values (the dtype by name)."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = _fields(v)
        elif f.name == "compute_dtype":
            out[f.name] = str(v).rsplit(".", 1)[-1].replace("'>", "")
        else:
            out[f.name] = v
    return out


@pytest.mark.parametrize("kw", [{}, {"core": "dnc"}, {"predict_scale": True}, {"crop_size": 32, "scale_range": 0.2}],
                         ids=["ntm", "dnc", "scale", "crop32"])
def test_demo_config_matches_jax(kw):
    got, want = _fields(tdemo.demo_config(**kw)), _fields(jdemo.demo_config(**kw))
    assert got == want
    assert got["compute_dtype"] == "float32"


def test_mean_clamped_iou_contract():
    assert tdemo.mean_clamped_iou([0.5, -31.8, 1.0]) == 0.5
    assert tdemo.mean_clamped_iou([-5.0, -5.0]) == 0.0
    assert tdemo.mean_clamped_iou([5.44, 0.5]) == 0.75
    assert np.isnan(tdemo.mean_clamped_iou([]))
    for ious in ([0.1, 0.9, -2.0], [1.5, 0.25]):
        assert tdemo.mean_clamped_iou(ious) == jdemo.mean_clamped_iou(ious)


@pytest.mark.parametrize("predict_scale", [False, True], ids=["offsets", "scale"])
def test_training_batch_matches_jax(predict_scale):
    jcfg, tcfg = jdemo.demo_config(predict_scale=predict_scale), tdemo.demo_config(predict_scale=predict_scale)
    want = jdemo.training_batch(jcfg, np.random.RandomState(3))
    got = tdemo.training_batch(tcfg, np.random.RandomState(3), device="cpu")
    assert set(got) == set(want)
    assert isinstance(got["images"], torch.Tensor) and got["images"].dtype == torch.float32
    np.testing.assert_allclose(got["images"].numpy(), np.asarray(want["images"]), atol=CROP_ATOL, rtol=0)
    for k in set(want) - {"images"}:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    # the rng's state after the batch is the same: the next batch's clips are
    rs_j, rs_t = np.random.RandomState(4), np.random.RandomState(4)
    jdemo.training_batch(jcfg, rs_j)
    tdemo.training_batch(tcfg, rs_t, device="cpu")
    assert rs_j.rand() == rs_t.rand()


def test_training_batch_contract():
    """tests/test_demo.py's contract: the loader's layout, the first frame
    centered (offset 0, gt peaked at the grid center), mean-subtracted."""
    cfg = tdemo.demo_config(crop_size=32)
    batch = tdemo.training_batch(cfg, np.random.RandomState(0), device="cpu")
    B, L, d = cfg.train.batch_size, cfg.train.sequence_length, cfg.data
    assert tuple(batch["images"].shape) == (B * L, d.crop_size, d.crop_size, 3)
    assert batch["gts"].shape == (B * L, d.gt_width, d.gt_width)
    np.testing.assert_allclose(batch["y_offsets"].reshape(B, L)[:, 0], 0.0, atol=1e-6)
    np.testing.assert_allclose(batch["x_offsets"].reshape(B, L)[:, 0], 0.0, atol=1e-6)
    g0 = batch["gts"].reshape(B, L, d.gt_width, d.gt_width)[0, 0]
    peak = np.unravel_index(g0.argmax(), g0.shape)
    c = (d.gt_width - 1) / 2
    assert abs(peak[0] - c) <= 0.5 and abs(peak[1] - c) <= 0.5
    assert float(batch["images"].mean()) < 50.0


@pytest.mark.parametrize("kw", [{}, {"core": "dnc"}, {"predict_scale": True}], ids=["ntm", "dnc", "scale"])
def test_eval_ious_match_jax(kw):
    jcfg, tcfg = jdemo.demo_config(**kw), tdemo.demo_config(**kw)
    jvgg = jinit_vgg(jax.random.PRNGKey(0))
    jparams = jmake_core(jcfg).init_params(jax.random.PRNGKey(1), jcfg.input_depth)
    vgg, params = vgg_params_from_flat(flatten_vgg_params(jvgg)), params_from_flat(flatten_params(jparams))
    want = jdemo.eval_streaming_iou(jcfg, jvgg, jparams, 0, 5)
    got = tdemo.eval_streaming_iou(tcfg, vgg, params, 0, 5, device="cpu")
    assert len(got) == 4
    np.testing.assert_allclose(got, want, atol=IOU_ATOL, rtol=0)
    want = jdemo.eval_device_iou(jcfg, jvgg, jparams, 0, 5)
    got_dev = tdemo.eval_device_iou(tcfg, vgg, params, 0, 5, device="cpu")
    np.testing.assert_allclose(got_dev, want, atol=IOU_ATOL, rtol=0)
    # the two loops of the port track alike on the CPU (both float32)
    assert abs(tdemo.mean_clamped_iou(got_dev) - tdemo.mean_clamped_iou(got)) < 0.05


def test_demo_main_runs_on_the_cpu(capsys):
    assert tdemo.main(["--device", "cpu", "--train_steps", "1", "--eval_frames", "3"]) == 0
    out = capsys.readouterr().out
    assert "train step 0: loss" in out and "mean IoU over 2 tracked frames" in out


def test_load_params_npz_matches_jax(tmp_path):
    """The demo's --vgg_weights loader: slim names, HWIO on disk, OIHW in
    the port; conv5 may be missing (tests/test_vgg.py's archives)."""
    from ntm_tracker_tpu.models.vgg import VGG16_PREFIX, load_params_npz as jload
    from ntm_tracker_tpu_torch.models.vgg import load_params_npz

    rs = np.random.RandomState(0)
    arrays = {}
    for name, out_ch, _ in VGG16_PREFIX:
        if name.startswith("conv5"):
            continue
        arrays[f"vgg_16/{name}/weights"] = rs.randn(3, 3, 2, out_ch).astype(np.float32)
        arrays[f"vgg_16/{name}/biases"] = rs.randn(out_ch).astype(np.float32)
    path = str(tmp_path / "vgg.npz")
    np.savez(path, **arrays)
    got, want = load_params_npz(path), jload(path)
    assert set(got) == set(want) and not any(k.startswith("conv5") for k in got)
    assert tuple(got["conv1/conv1_1"]["weights"].shape) == (64, 2, 3, 3)
    flat_got, flat_want = flatten_vgg_params(got, layout="OIHW"), flatten_vgg_params(want)
    for k in flat_want:
        np.testing.assert_array_equal(flat_got[k], flat_want[k], err_msg=k)
    del arrays["vgg_16/conv4/conv4_3/biases"], arrays["vgg_16/conv4/conv4_3/weights"]
    np.savez(path, **arrays)
    with pytest.raises(KeyError):
        load_params_npz(path)


def test_scale_head_train_step_matches_jax():
    """One train step of the demo config's scale head (at L=2) on a
    training_batch, from the same params: the loss, the params after the
    step and the RMSProp state against JAX's (tests/test_torch_experiment.py's
    bounds; the loss, a sum of small squared residuals, also within 1e-6).
    The offsets head's step is held at full width there."""
    predict_scale = True
    from ntm_tracker_tpu.train import experiments as jexp
    from ntm_tracker_tpu_torch.interop import flatten_opt_state, opt_state_from_flat
    from ntm_tracker_tpu_torch.train import experiments as texp

    def narrow(mod):
        cfg = mod.demo_config(predict_scale=predict_scale)
        return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, sequence_length=2))

    jcfg, tcfg = narrow(jdemo), narrow(tdemo)
    jvgg = jinit_vgg(jax.random.PRNGKey(0))
    jx = jexp.OffsetExperiment(jcfg, jvgg, image_mode="cropped")
    tx = texp.OffsetExperiment(tcfg, vgg_params_from_flat(flatten_vgg_params(jvgg)), image_mode="cropped",
                               device="cpu")
    jparams, jopt = jx.init(jax.random.PRNGKey(1))
    batch = tdemo.training_batch(tcfg, np.random.RandomState(2), device="cpu")
    jbatch = {k: np.asarray(v) for k, v in batch.items()}
    jparams2, jopt2, jm = jax.jit(jx.make_train_step())(jparams, jopt, jbatch)
    params, opt_state, m = tx.make_train_step()(params_from_flat(flatten_params(jparams)),
                                                opt_state_from_flat(flatten_opt_state(jopt)), batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5, atol=1e-6)
    got, want = flatten_params(params), flatten_params(jparams2)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-7, rtol=0, err_msg=k)
    got, want = flatten_opt_state(opt_state), flatten_opt_state(jopt2)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4 * max(float(np.abs(want[k]).max()), 1e-12),
                                   rtol=1e-3, err_msg=k)
