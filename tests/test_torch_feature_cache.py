"""The port's feature cache (data/feature_cache.py) against the JAX
package's: the same fingerprints for the same VGG weights, caches that
either package builds and the other verifies and loads, tokens within
1e-5 of the largest, and the refusals (stale fingerprint, duplicate
basenames, the data-parallel build)."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntm_tracker_tpu.config import TrackerConfig as JTrackerConfig
from ntm_tracker_tpu.data import feature_cache as jfc
from ntm_tracker_tpu.models.vgg import init_vgg_params
from ntm_tracker_tpu_torch import interop
from ntm_tracker_tpu_torch.config import DataConfig, DNCConfig, NTMConfig, TrackerConfig, TrainConfig
from ntm_tracker_tpu_torch.data import feature_cache as fc
from ntm_tracker_tpu_torch.data.loader import batch_iterator, load_frame_batch
from ntm_tracker_tpu_torch.data.sequences import get_valid_sequences
from ntm_tracker_tpu_torch.train.experiments import OffsetExperiment

from tests.test_experiment import tiny_cfg

SEQ_LEN = 4
POINTS = ((1, 1), (1, 2), (2, 1), (2, 2))


def port_tiny_cfg(batch=1, seq_len=SEQ_LEN) -> TrackerConfig:
    """tests/test_experiment.tiny_cfg in the port's config."""
    return TrackerConfig(
        ntm=NTMConfig(output_dim=2, mem_size=16, mem_dim=8, controller_hidden_size=32, read_head_size=2),
        dnc=DNCConfig(output_dim=2, memory_size=16, word_size=8, num_reads=2, num_writes=1, hidden_size=32),
        data=DataConfig(crop_size=32, resize_hw=(48, 64), gt_width=2),
        train=TrainConfig(batch_size=batch, sequence_length=seq_len),
        num_features=4, feature_points=POINTS,
    )


@pytest.fixture(scope="module")
def vgg():
    """(the JAX package's VGG params, the same weights in the port's layout)."""
    jv = init_vgg_params(jax.random.PRNGKey(0))
    return jv, interop.vgg_params_from_flat(interop.flatten_vgg_params(jv))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Frame records (.txt/.bin) with 2x2 gts over real JPEGs in three
    sequences (two train, one val); returns the dataset's root, in which
    the tests run with relative paths (the split reads the path)."""
    from PIL import Image

    root = str(tmp_path_factory.mktemp("ds"))
    rng = np.random.RandomState(7)
    for seq in ("train_seq00_0", "train_seq01_0", "val_seq00_0"):
        img_dir = os.path.join(root, "imgs", seq)
        seq_dir = os.path.join(root, "cropped", seq)
        os.makedirs(img_dir)
        os.makedirs(seq_dir)
        for i in range(5):
            Image.fromarray((rng.rand(36, 64, 3) * 255).astype(np.uint8)).save(
                os.path.join(img_dir, f"{i:06d}.JPEG"), quality=95)
            crop = [0.2 + 0.01 * i, 0.25, 0.8 + 0.01 * i, 0.85]
            bbox = [0.125 + 0.01 * i, 0.125, 0.875, 0.875 - 0.01 * i]
            with open(os.path.join(seq_dir, f"{i:06d}.txt"), "w") as f:
                f.write(",".join([str(v) for v in crop + bbox]
                                 + [os.path.join("imgs", seq, f"{i:06d}.JPEG"), str(0.02 * i), str(-0.015 * i)]))
            gt = rng.rand(2, 2)
            (gt / gt.sum()).astype(np.float64).tofile(os.path.join(seq_dir, f"{i:06d}.bin"))
    return root


@pytest.fixture
def seq_dirs(dataset, monkeypatch):
    monkeypatch.chdir(dataset)
    return [os.path.join("cropped", s) for s in sorted(os.listdir("cropped"))]


def build_port(cfg, vgg_t, seq_dirs, cache, **kw):
    return fc.build_feature_cache(cfg, vgg_t, seq_dirs, cache, gt_width=2, device="cpu", **kw)


def build_jax(cfg, vgg_j, seq_dirs, cache, **kw):
    return jfc.build_feature_cache(cfg, vgg_j, seq_dirs, cache, gt_width=2, **kw)


def grid7(cfg, points):
    return dataclasses.replace(cfg, num_features=49, feature_points=points)


@pytest.mark.parametrize("variant", ["f32", "bf16", "grid7", "int8"])
@pytest.mark.parametrize("flip", [False, True])
def test_fingerprints_equal_jax(vgg, variant, flip):
    from ntm_tracker_tpu.cli import _centered_grid

    jv, tv = vgg
    jcfg, tcfg = JTrackerConfig(), TrackerConfig()
    if variant == "bf16":
        jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.bfloat16)
        tcfg = dataclasses.replace(tcfg, compute_dtype=torch.bfloat16)
    elif variant == "grid7":
        jcfg, tcfg = grid7(jcfg, _centered_grid(7)), grid7(tcfg, _centered_grid(7))
    elif variant == "int8":
        jcfg, tcfg = dataclasses.replace(jcfg, vgg_int8=True), dataclasses.replace(tcfg, vgg_int8=True)
    fp = fc.cache_fingerprint(tcfg, tv, flip)
    assert fp == jfc.cache_fingerprint(jcfg, jv, flip)
    assert fp != fc.cache_fingerprint(tcfg, tv, not flip)


def test_dtype_names():
    assert fc.dtype_name(torch.float32) == "float32" and fc.dtype_name(torch.bfloat16) == "bfloat16"
    assert fc.dtype_name(np.float16) == "float16"


def test_caches_built_by_either_package_load_in_the_other(vgg, seq_dirs, tmp_path):
    jv, tv = vgg
    tcfg, jcfg = port_tiny_cfg(), tiny_cfg("ntm", batch=1, seq_len=SEQ_LEN)
    pc, jc = str(tmp_path / "port"), str(tmp_path / "jax")
    man = build_port(tcfg, tv, seq_dirs, pc, store_dtype="float32", frames_per_batch=4)
    jman = build_jax(jcfg, jv, seq_dirs, jc, store_dtype="float32", frames_per_batch=4)
    assert man == jman and man["num_frames"] == 15
    with open(os.path.join(pc, "base", "manifest.json"), "rb") as a, open(os.path.join(jc, "base", "manifest.json"), "rb") as b:
        assert a.read() == b.read()
    # each verifies the other's cache against its own weights
    fc.verify_cache(tcfg, jc, vgg_params=tv)
    jfc.verify_cache(jcfg, pc, vgg_params=jv)

    # the same files: tokens within 1e-5 of the largest
    for s in seq_dirs:
        for f in sorted(os.listdir(os.path.join(pc, "base", os.path.basename(s)))):
            a = np.load(os.path.join(pc, "base", os.path.basename(s), f))
            b = np.load(os.path.join(jc, "base", os.path.basename(s), f))
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (4, 512)
            np.testing.assert_allclose(a, b, atol=1e-5 * np.abs(b).max())

    _, train, _ = get_valid_sequences("cropped", SEQ_LEN)
    kw = dict(gt_width=2, shuffle=True, seed=3, epochs=2)
    for cache in (pc, jc):
        port_batches = list(fc.token_batch_iterator(train, 1, cache, **kw))
        jax_batches = list(jfc.token_batch_iterator(train, 1, cache, **kw))
        assert len(port_batches) == len(jax_batches) == 4
        for a, b in zip(port_batches, jax_batches):
            for name in a._fields:
                np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)


def test_float16_storage_and_flip(vgg, seq_dirs, tmp_path):
    _, tv = vgg
    cfg = port_tiny_cfg()
    c32, c16 = str(tmp_path / "c32"), str(tmp_path / "c16")
    build_port(cfg, tv, seq_dirs, c32, store_dtype="float32", frames_per_batch=8)
    man = build_port(cfg, tv, seq_dirs, c16, store_dtype="float16", frames_per_batch=3, flip=True)
    assert man["store_dtype"] == "float16" and man["flip"] is True
    assert os.path.isdir(os.path.join(c16, "flip")) and not os.path.exists(os.path.join(c16, "base"))
    _, train, _ = get_valid_sequences("cropped", SEQ_LEN)
    frames = [os.path.join(s, f) for s, fs in train for f in fs]
    tb = fc.load_token_batch(frames, 2, c16, reverse_image=True)
    assert tb.features.dtype == np.float16
    # the flipped tokens are the VGG's on the flipped frames
    fb = load_frame_batch(frames, 2, reverse_image=True, decode_resize_hw=(48, 64))
    exp = OffsetExperiment(cfg, tv, image_mode="resized", device="cpu")
    direct = exp.batch_features({"images": torch.as_tensor(fb.images),
                                 "cropboxes": torch.as_tensor(fb.cropboxes)}).reshape(tb.features.shape).numpy()
    np.testing.assert_allclose(tb.features.astype(np.float32), direct, rtol=1e-3, atol=1e-3 * np.abs(direct).max())
    np.testing.assert_array_equal(tb.x_offsets, fb.x_offsets)
    base = fc.load_token_batch(frames, 2, c32)
    np.testing.assert_array_equal(tb.y_offsets, base.y_offsets)
    np.testing.assert_array_equal(tb.x_offsets, -base.x_offsets)


def test_cached_tokens_and_loss_match_the_image_path(vgg, seq_dirs, tmp_path):
    """The port's counterpart of tests/test_feature_cache.py::
    test_cached_tokens_and_loss_match_direct_path."""
    _, tv = vgg
    cfg = port_tiny_cfg()
    cache = str(tmp_path / "cache")
    build_port(cfg, tv, seq_dirs, cache, store_dtype="float32", frames_per_batch=4)
    _, train, _ = get_valid_sequences("cropped", SEQ_LEN)
    fb = next(batch_iterator(train, 1, 2, shuffle=False, decode_resize_hw=(48, 64)))
    tb = next(fc.token_batch_iterator(train, 1, cache, 2, shuffle=False))
    for name in ("gts", "y_offsets", "x_offsets", "scales"):
        np.testing.assert_array_equal(getattr(tb, name), getattr(fb, name))
    exp = OffsetExperiment(cfg, tv, image_mode="resized", device="cpu")
    image_batch = {"images": fb.images, "cropboxes": fb.cropboxes, "gts": fb.gts,
                   "y_offsets": fb.y_offsets, "x_offsets": fb.x_offsets}
    token_batch = {"features": tb.features, "gts": tb.gts, "y_offsets": tb.y_offsets, "x_offsets": tb.x_offsets}
    direct = exp.batch_features(exp.device_batch(image_batch)).numpy()
    np.testing.assert_allclose(direct.reshape(tb.features.shape), tb.features, atol=1e-5 * np.abs(direct).max())
    params, _ = exp.init(torch.Generator().manual_seed(1))
    l_img = float(exp.loss_fn(params, image_batch)[0])
    l_tok = float(exp.loss_fn(params, token_batch)[0])
    assert abs(l_img - l_tok) <= 1e-5 * abs(l_img)


def test_refusals(vgg, seq_dirs, tmp_path):
    _, tv = vgg
    cfg = port_tiny_cfg()
    cache = str(tmp_path / "cache")
    build_port(cfg, tv, seq_dirs, cache, store_dtype="float32")
    stale = {k: dict(v) for k, v in tv.items()}
    stale["conv1/conv1_1"]["biases"] = stale["conv1/conv1_1"]["biases"] + 1e-3
    with pytest.raises(ValueError, match="stale"):
        fc.verify_cache(cfg, cache, vgg_params=stale)
    with pytest.raises(ValueError, match="tokens but the config expects"):
        fc.verify_cache(dataclasses.replace(cfg, num_features=9), cache)
    with pytest.raises(FileNotFoundError, match="--reverse_image"):
        fc.verify_cache(cfg, cache, flip=True)
    os.makedirs("other/train_seq00_0")
    with pytest.raises(ValueError, match="duplicate basenames"):
        build_port(cfg, tv, seq_dirs + ["other/train_seq00_0"], str(tmp_path / "dup"))
    with pytest.raises(NotImplementedError, match="A7"):
        build_port(cfg, tv, seq_dirs, str(tmp_path / "m"), mesh=object())
    with pytest.raises(ValueError, match="store_dtype"):
        build_port(cfg, tv, seq_dirs, str(tmp_path / "d"), store_dtype="bfloat16")
    with pytest.raises(ValueError, match="no frame records"):
        build_port(cfg, tv, ["other/train_seq00_0"], str(tmp_path / "e"))
    with open(os.path.join(cache, "base", "manifest.json")) as f:
        assert json.load(f)["fingerprint"] == fc.cache_fingerprint(cfg, tv, False)


def test_torchvision_state_dict_loads_as_the_jax_package_loads_it(vgg, tmp_path):
    """models/vgg.load_params_torch: a torchvision vgg16 state dict gives
    the JAX package's weights (its HWIO = our OIHW transposed), so both
    fingerprint it alike; the CLI's .pth route reads it."""
    from ntm_tracker_tpu.models.vgg import load_params_torch as jload
    from ntm_tracker_tpu_torch.cli import _load_vgg, build_parser
    from ntm_tracker_tpu_torch.models.vgg import load_params_torch

    _, tv = vgg
    idx = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21]  # conv1_1 .. conv4_3: conv5 may be absent
    sd = {}
    for i, (name, p) in zip(idx, list(tv.items())[:10]):
        sd[f"features.{i}.weight"], sd[f"features.{i}.bias"] = p["weights"], p["biases"]
    ours = load_params_torch(sd)
    ref = jload({k: v.numpy() for k, v in sd.items()})
    assert list(ours) == list(ref) and len(ours) == 10
    for name in ours:
        np.testing.assert_array_equal(ours[name]["weights"].numpy(), np.asarray(ref[name]["weights"]).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(ours[name]["biases"].numpy(), np.asarray(ref[name]["biases"]))
    cfg = TrackerConfig()
    assert fc.cache_fingerprint(cfg, ours, False) == jfc.cache_fingerprint(JTrackerConfig(), ref, False)
    path = str(tmp_path / "vgg16.pth")
    torch.save(sd, path)
    args = build_parser().parse_args(["--device", "cpu", "cache-features", "--sequences_dir", ".", "--cache_dir", ".",
                                      "--vgg_weights", path])
    loaded = _load_vgg(args, "cpu")
    assert all(torch.equal(loaded[n]["weights"], ours[n]["weights"]) for n in ours)
    sd.pop("features.0.weight")
    with pytest.raises(KeyError, match="features.0.weight"):
        load_params_torch(sd)
