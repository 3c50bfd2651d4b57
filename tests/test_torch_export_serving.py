"""tools/export_serving.py of the port on the CPU (mirroring
tests/test_export_serving.py): the artifact's first/step/dinit/dstep
against the live frame step and device loop (atol 1e-5, the JAX bar),
against the JAX package's artifact exported from the same weights on the
same inputs (1e-4), the StreamingTracker driven from the artifact, the
meta (the declared plain route), and the refusals: a JAX artifact, a
missing platform, a TPU platform, a missing device loop."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntm_tracker_tpu import config as jconfig
from ntm_tracker_tpu.models.core import make_core as jmake_core
from ntm_tracker_tpu.models.vgg import init_vgg_params as jinit_vgg
from ntm_tracker_tpu.tools import export_serving as jes
from ntm_tracker_tpu_torch import config as tconfig
from ntm_tracker_tpu_torch.interop import flatten_params, flatten_vgg_params, params_from_flat, vgg_params_from_flat
from ntm_tracker_tpu_torch.models.core import make_core
from ntm_tracker_tpu_torch.tools import export_serving as es
from ntm_tracker_tpu_torch.tracking.tracker import StreamingTracker, build_frame_step, make_device_track_step

LIVE_ATOL = 1e-5  # tests/test_export_serving.py:73-90
JAX_ATOL = 1e-4
H, W = 48, 64


def tiny_cfg(mod, core="ntm", **over):
    """tests/test_export_serving.py:tiny_cfg in either package: crop 32, a
    4x4 grid of conv4_3 tokens."""
    g = 4
    return mod.TrackerConfig(
        core=core,
        ntm=mod.NTMConfig(mem_size=16, mem_dim=8, controller_hidden_size=24, read_head_size=2),
        dnc=mod.DNCConfig(output_dim=2, memory_size=16, word_size=8, num_reads=2, num_writes=1, hidden_size=24),
        data=mod.DataConfig(crop_size=8 * g, gt_width=g),
        num_features=g * g,
        feature_points=tuple((y, x) for y in range(g) for x in range(g)),
        **over,
    )


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    jcfg = tiny_cfg(jconfig)
    jcore = jmake_core(jcfg)
    jvgg = jinit_vgg(jax.random.PRNGKey(0))
    jp = jcore.init_params(jax.random.PRNGKey(1), jcfg.input_depth)
    cfg = tiny_cfg(tconfig)
    return (jcfg, jcore, jvgg, jp), (cfg, make_core(cfg), vgg_params_from_flat(flatten_vgg_params(jvgg)),
                                     params_from_flat(flatten_params(jp)))


@pytest.fixture(scope="module")
def exported(models, tmp_path_factory):
    _, (cfg, core, vgg, params) = models
    path = str(tmp_path_factory.mktemp("export") / "serving.npz")
    es.save_serving(path, es.export_serving(cfg, core, vgg, params, batch=1, platforms=["cpu"],
                                            device_loop=(H, W)))
    return path


@pytest.fixture(scope="module")
def exported_jax(models, tmp_path_factory):
    (jcfg, jcore, jvgg, jp), _ = models
    path = str(tmp_path_factory.mktemp("export_jax") / "serving_jax.npz")
    jes.save_serving(path, jes.export_serving(jcfg, jcore, jvgg, jp, batch=1, device_loop=(H, W)))
    return path


def _inputs(seed, S=32, F=16):
    rng = np.random.RandomState(seed)
    return ([rng.rand(1, S, S, 3).astype(np.float32) * 100 - 50 for _ in range(4)],
            rng.rand(1, F).astype(np.float32))


def _leaf_err(a, b):
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max()) for x, y in zip(a, b))


def test_first_and_steps_match_live(models, exported):
    _, (cfg, core, vgg, params) = models
    model = es.ServingModel(exported, device="cpu")
    step_first, step_rest = build_frame_step(cfg, core, vgg, params, device="cpu")
    crops, gt = _inputs(0)
    with torch.no_grad():
        live_state = core.init_state(params, 1)
    live_off, live_state = step_first(torch.tensor(crops[0]), torch.tensor(gt), live_state)
    off, leaves = model.first(crops[0], gt, model.init_state())
    np.testing.assert_allclose(off.numpy(), live_off.numpy(), rtol=0, atol=LIVE_ATOL)
    for crop in crops[1:]:
        live_off, live_state = step_rest(torch.tensor(crop), live_state)
        off, leaves = model.step(crop, leaves)
        np.testing.assert_allclose(off.numpy(), live_off.numpy(), rtol=0, atol=LIVE_ATOL)
    assert len(leaves) == 5  # M, controller (c, h), read, w: the JAX tree order
    assert _leaf_err(leaves, es.state_leaves(live_state)) <= LIVE_ATOL


def _loop_inputs():
    rng = np.random.RandomState(7)
    frames = (rng.rand(4, H, W, 3) * 255).astype(np.float32)
    x, y, w, h = 20.0, 12.0, 18.0, 14.0
    bbox0 = np.asarray([[y / (H - 1), x / (W - 1), (y + h) / (H - 1), (x + w) / (W - 1)]], np.float32)
    return frames, bbox0


def test_device_loop_matches_live(models, exported):
    _, (cfg, core, vgg, params) = models
    model = es.ServingModel(exported, device="cpu")
    assert model.has_device_loop and model.meta["device_loop"] == [H, W]
    frames, bbox0 = _loop_inputs()
    init_fn, step_fn = make_device_track_step(cfg, core, vgg, params, device="cpu")
    with torch.no_grad():
        state_l = init_fn(frames[0:1], bbox0, core.init_state(params, 1))
    bbox_l = torch.tensor(bbox0)
    leaves = model.device_init(frames[0:1], bbox0, model.init_state())
    bbox_s = bbox0
    for t in range(1, 4):
        region_l, bbox_l, state_l = step_fn(frames[t:t + 1], bbox_l, state_l)
        region_s, bbox_s, leaves = model.device_step(frames[t:t + 1], bbox_s, leaves)
        np.testing.assert_allclose(region_s.numpy(), region_l.numpy(), rtol=0, atol=LIVE_ATOL)
        np.testing.assert_allclose(bbox_s.numpy(), bbox_l.numpy(), rtol=0, atol=LIVE_ATOL)


def test_matches_the_jax_artifact(exported, exported_jax):
    """The two packages' artifacts from the same weights, on the same
    inputs: offsets and every state leaf (the same leaf order)."""
    mine, theirs = es.ServingModel(exported, device="cpu"), jes.ServingModel(exported_jax)
    crops, gt = _inputs(3)
    off_t, leaves_t = mine.first(crops[0], gt, mine.init_state())
    off_j, leaves_j = theirs.first(crops[0], gt, theirs.init_state())
    np.testing.assert_allclose(off_t.numpy(), off_j, rtol=0, atol=JAX_ATOL)
    for crop in crops[1:]:
        off_t, leaves_t = mine.step(crop, leaves_t)
        off_j, leaves_j = theirs.step(crop, leaves_j)
        np.testing.assert_allclose(off_t.numpy(), off_j, rtol=0, atol=JAX_ATOL)
    assert [tuple(x.shape) for x in leaves_t] == [tuple(x.shape) for x in leaves_j]
    assert _leaf_err(leaves_t, leaves_j) <= JAX_ATOL
    # the device loop on the same inputs: both artifacts take JAX's box each
    # step (fed back, the two boxes drift apart through the recrops)
    frames, bbox0 = _loop_inputs()
    lt = mine.device_init(frames[0:1], bbox0, mine.init_state())
    lj = theirs.device_init(frames[0:1], bbox0, theirs.init_state())
    bbox = bbox0
    for t in range(1, 4):
        rt, bt, lt = mine.device_step(frames[t:t + 1], bbox, lt)
        rj, bj, lj = theirs.device_step(frames[t:t + 1], bbox, lj)
        np.testing.assert_allclose(rt.numpy(), rj, rtol=0, atol=JAX_ATOL)
        np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=0, atol=JAX_ATOL)
        bbox = np.asarray(bj)
    meta_t, meta_j = mine.meta, theirs.meta
    for key in ("batch", "first_batch", "crop_size", "num_features", "core", "data", "feature_points",
                "delimiter_first", "predict_scale", "scale_range", "vgg_int8", "device_loop", "state_leaves"):
        assert meta_t[key] == meta_j[key], key


def test_meta_declares_the_route(exported):
    meta = es.ServingModel(exported, device="cpu").meta
    assert meta["format"] == "ntm-tracker-serving-torch-v1" and meta["platforms"] == ["cpu"]
    assert "plain cell loop" in meta["route"] and meta["batch"] == 1
    assert es.config_from_meta(meta).data == tiny_cfg(tconfig).data


def test_streaming_tracker_from_serving_matches_live(models, exported):
    from ntm_tracker_tpu_torch.data.synthetic import make_video

    _, (cfg, core, vgg, params) = models
    frames, boxes = make_video(np.random.RandomState(7), 5, (60, 80))
    fh, fw = frames.shape[1:3]
    b0 = boxes[0]
    region0 = (b0[1] * fw, b0[0] * fh, (b0[3] - b0[1]) * fw, (b0[2] - b0[0]) * fh)
    live = StreamingTracker(cfg, vgg, params, core, device="cpu")
    live.init(frames[0], region0)
    served = StreamingTracker.from_serving(es.ServingModel(exported, device="cpu"))
    served.init(frames[0], region0)
    assert served.cfg.data == cfg.data and served.device.type == "cpu"
    for t in range(1, 5):
        np.testing.assert_allclose(served.track(frames[t]), live.track(frames[t]), rtol=0, atol=1e-4)


def test_refusals(exported, exported_jax, tmp_path):
    with pytest.raises(ValueError, match="JAX package's serving artifact"):
        es.ServingModel(exported_jax, device="cpu")
    # an artifact without this device's programs
    with np.load(exported) as z:
        kept = {k: z[k] for k in z.files if not k.endswith(".cpu")}
    np.savez(tmp_path / "cuda_only.npz", **kept)
    with pytest.raises(ValueError, match="no program for cpu"):
        es.ServingModel(str(tmp_path / "cuda_only.npz"), device="cpu")
    np.savez(tmp_path / "other.npz", meta=np.asarray('{"format": "something-else"}'))
    with pytest.raises(ValueError, match="not a serving artifact"):
        es.ServingModel(str(tmp_path / "other.npz"), device="cpu")
    cfg = tiny_cfg(tconfig)
    with pytest.raises(ValueError, match="unknown export platform 'tpu'"):
        es.export_serving(cfg, make_core(cfg), {}, {}, platforms=["tpu"])
    with pytest.raises(ValueError, match="too small"):
        es.export_serving(cfg, make_core(cfg), {}, {}, platforms=["cpu"], device_loop=(1, 64))


def test_portable_pins_the_plain_route():
    cfg = tiny_cfg(tconfig, fused_inference=True)
    cfg = dataclasses.replace(cfg, ntm=dataclasses.replace(cfg.ntm, use_pallas=True))
    p = es._portable(cfg)
    assert p.fused_inference is False and p.ntm.use_pallas is False
    plain = tiny_cfg(tconfig, fused_inference=False)
    assert es._portable(plain) is plain


def test_state_leaves_round_trip():
    from ntm_tracker_tpu_torch.models.dnc.dnc import init_dnc_state

    cfg = tiny_cfg(tconfig, core="dnc")
    state = init_dnc_state(cfg.dnc, 2)
    leaves = es.state_leaves(state)
    back = es.state_from_leaves(state, [t + 1 for t in leaves])
    assert type(back) is type(state) and type(back.access_state) is type(state.access_state)
    assert all(torch.equal(a, b + 1) for a, b in zip(es.state_leaves(back), leaves))
    ntm = {"w": torch.zeros(1), "M": torch.ones(1), "controller_state": [(torch.full((1,), 2.0), torch.full((1,), 3.0))],
           "read": torch.full((1,), 4.0)}
    assert [float(t) for t in es.state_leaves(ntm)] == [1.0, 2.0, 3.0, 4.0, 0.0]
    assert list(es.state_from_leaves(ntm, es.state_leaves(ntm))) == list(ntm)
    with pytest.raises(ValueError, match="more state leaves"):
        es.state_from_leaves(ntm, es.state_leaves(ntm) + [torch.zeros(1)])


def test_dnc_artifact_matches_live(tmp_path):
    """The DNC core exports too: its sort-based allocation inside the
    traced scan, no per-step checkpoint (the frame step runs remat=False)."""
    cfg = tiny_cfg(tconfig, core="dnc")
    core = make_core(cfg)
    gen = torch.Generator().manual_seed(0)
    from ntm_tracker_tpu_torch.models.vgg import init_vgg_params

    vgg, params = init_vgg_params(gen), core.init_params(gen, cfg.input_depth)
    path = str(tmp_path / "dnc.npz")
    es.save_serving(path, es.export_serving(cfg, core, vgg, params, batch=1, platforms=["cpu"]))
    model = es.ServingModel(path, device="cpu")
    assert model.meta["core"] == "dnc" and not model.has_device_loop
    with pytest.raises(ValueError, match="device_loop"):
        model.device_step(np.zeros((1, 8, 8, 3)), np.zeros((1, 4)), model.init_state())
    step_first, step_rest = build_frame_step(cfg, core, vgg, params, device="cpu")
    crops, gt = _inputs(5)
    with torch.no_grad():
        live_state = core.init_state(params, 1)
    live_off, live_state = step_first(torch.tensor(crops[0]), torch.tensor(gt), live_state)
    off, leaves = model.first(crops[0], gt, model.init_state())
    np.testing.assert_allclose(off.numpy(), live_off.numpy(), rtol=0, atol=LIVE_ATOL)
    for crop in crops[1:3]:
        live_off, live_state = step_rest(torch.tensor(crop), live_state)
        off, leaves = model.step(crop, leaves)
        np.testing.assert_allclose(off.numpy(), live_off.numpy(), rtol=0, atol=LIVE_ATOL)
    assert _leaf_err(leaves, es.state_leaves(live_state)) <= LIVE_ATOL
