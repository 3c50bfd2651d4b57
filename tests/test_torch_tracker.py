"""The port's streaming tracker vs the JAX package's and vs the executed
reference tracker loop, on the CPU; plus the frame step's routing and
serialization."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixture_params import (
    TRACKER_LOOP_CONFIG,
    TRACKER_LOOP_REGION0,
    seeded_loop_cell_params,
    seeded_loop_video,
    seeded_vgg_params,
)
from ntm_tracker_tpu import config as jconfig
from ntm_tracker_tpu.models.core import make_core as jmake_core
from ntm_tracker_tpu.models.vgg import VGG16_PREFIX, init_vgg_params as jinit_vgg
from ntm_tracker_tpu.tracking import tracker as jtracker
from ntm_tracker_tpu.train import serialize as jser
from ntm_tracker_tpu_torch import config as tconfig
from ntm_tracker_tpu_torch.interop import (
    flatten_ntm_params,
    flatten_vgg_params,
    ntm_params_from_flat,
    vgg_params_from_flat,
)
from ntm_tracker_tpu_torch.models.core import make_core
from ntm_tracker_tpu_torch.tracking import tracker as ttracker
from ntm_tracker_tpu_torch.train import serialize as tser

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
# the bound the JAX package's own tracker loop is held to against the
# executed reference: 1e-4 relative on the trajectory (pixels for regions,
# normalized units for boxes), atol for near-zero coordinates
LOOP_RTOL = LOOP_ATOL = 1e-4


def _tiny_kwargs():
    return dict(
        ntm=dict(output_dim=2, mem_size=16, mem_dim=8, controller_hidden_size=32, read_head_size=2),
        data=dict(crop_size=32, resize_hw=(48, 64), gt_width=2),
        num_features=4,
        feature_points=((1, 1), (1, 2), (2, 1), (2, 2)),
    )


def _cfgs(**over):
    kw = _tiny_kwargs()

    def build(mod):
        return mod.TrackerConfig(ntm=mod.NTMConfig(**kw["ntm"]), data=mod.DataConfig(**kw["data"]),
                                 num_features=kw["num_features"], feature_points=kw["feature_points"], **over)

    return build(jconfig), build(tconfig)


def _smooth_video(frames=5, hw=(90, 120)):
    h, w = hw
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    base = np.stack([128 + 50 * np.sin(2 * np.pi * (xs / w + 0.3 * ys / h)),
                     128 + 50 * np.cos(2 * np.pi * 1.3 * ys / h),
                     128 + 40 * np.sin(2 * np.pi * (0.7 * xs / w + 0.9 * ys / h))], axis=-1)
    out = []
    for t in range(frames):
        blob = np.exp(-(((ys - 40 - 2 * t) / 12) ** 2 + ((xs - 55 - 3 * t) / 16) ** 2))
        out.append(np.clip(base + blob[..., None] * [80.0, -60.0, 40.0], 0, 255).astype(np.uint8))
    return out


def _run(trk, video, region0):
    trk.init(video[0], region0)
    out = {"regions": [], "boxes": [], "cropboxes": [list(trk.cropbox)]}
    for frame in video[1:]:
        out["regions"].append(list(trk.track(frame)))
        out["boxes"].append(list(trk.output_bbox))
        out["cropboxes"].append(list(trk.cropbox))
    return {k: np.asarray(v, np.float64) for k, v in out.items()}


def test_streaming_tracker_matches_jax():
    jcfg, tcfg = _cfgs()
    jcore = jmake_core(jcfg)
    jvgg = jinit_vgg(jax.random.PRNGKey(0))
    jp = jcore.init_params(jax.random.PRNGKey(1), jcfg.input_depth)
    video, region0 = _smooth_video(), (40.0, 28.0, 32.0, 24.0)
    ref = _run(jtracker.StreamingTracker(jcfg, jvgg, jp, jcore), video, region0)
    got = _run(ttracker.StreamingTracker(tcfg, vgg_params_from_flat(flatten_vgg_params(jvgg)),
                                         ntm_params_from_flat(flatten_ntm_params(jp)), device="cpu"),
               video, region0)
    assert np.abs(np.diff(ref["cropboxes"], axis=0)).max() > 1e-4  # the loop moved
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], rtol=LOOP_RTOL, atol=LOOP_ATOL, err_msg=key)


def test_tracker_loop_matches_executed_reference():
    """Full width (224 crops, VGG to conv4_3, NTM 128x20, 4+1 heads,
    hidden 200), reference streaming order, vs the reference's own
    NTMTracker executed end to end (tests/gen_tracker_loop_golden.py)."""
    g = np.load(os.path.join(FIXTURES, "tf_goldens_tracker_loop.npz"))
    c = TRACKER_LOOP_CONFIG
    cfg = tconfig.TrackerConfig(ntm=tconfig.NTMConfig(
        mem_size=c["mem_size"], mem_dim=c["mem_dim"], shift_range=c["shift_range"],
        controller_hidden_size=c["hidden"], controller_num_layers=c["num_layers"],
        read_head_size=c["read_heads"], write_head_size=c["write_heads"]))
    sp = seeded_loop_cell_params()
    flat = {k: v for k, v in sp.items() if not k.startswith("ctrl_")}
    for layer in range(c["num_layers"]):
        flat[f"controller[{layer}].kernel"] = sp[f"ctrl_kernel_{layer}"]
        flat[f"controller[{layer}].bias"] = sp[f"ctrl_bias_{layer}"]
    trk = ttracker.StreamingTracker(cfg, vgg_params_from_flat(flatten_vgg_params(seeded_vgg_params(VGG16_PREFIX))),
                                    ntm_params_from_flat(flat), delimiter_first=True, device="cpu")
    got = _run(trk, seeded_loop_video(), TRACKER_LOOP_REGION0)
    for ours, theirs in (("regions", "loop_regions"), ("boxes", "loop_output_bboxes"),
                         ("cropboxes", "loop_cropboxes")):
        assert got[ours].shape == g[theirs].shape
        np.testing.assert_allclose(got[ours], g[theirs], rtol=LOOP_RTOL, atol=LOOP_ATOL, err_msg=ours)


@pytest.mark.parametrize("B", [1, 2])
def test_fused_route_on_cpu_equals_plain_loop(B):
    # fused_inference=True on CPU tensors runs the wrapper's plain version
    _, tcfg = _cfgs()
    core = make_core(tcfg)
    gen = torch.Generator().manual_seed(0)
    from ntm_tracker_tpu_torch.models.vgg import init_vgg_params

    vgg, params = init_vgg_params(gen), core.init_params(gen, tcfg.input_depth)
    crops = torch.tensor(np.random.RandomState(2).uniform(-100, 100, (B, 32, 32, 3)).astype(np.float32))
    gt = torch.full((B, tcfg.num_features), 0.25)
    outs = []
    for fused in (True, False):
        cfg = dataclasses.replace(tcfg, fused_inference=fused)
        first, rest = ttracker.build_frame_step(cfg, core, vgg, params, device="cpu")
        off, state = first(crops, gt, core.init_state(params, B))
        off2, state = rest(crops, state)
        outs.append((off, off2, state["M"]))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert tuple(outs[0][1].shape) == (B, 2) and bool((outs[0][1].abs() <= 1).all())


def test_routing_rule():
    _, cfg = _cfgs()
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    use = ttracker.use_fused_kernel
    assert use(cfg, 1, cuda) and not use(cfg, 2, cuda) and not use(cfg, 1, cpu)
    assert not use(dataclasses.replace(cfg, cell_matmul_precision="highest"), 1, cuda)
    assert not use(dataclasses.replace(cfg, core="dnc"), 1, cuda)
    forced = dataclasses.replace(cfg, fused_inference=True)
    assert use(forced, 4, cuda) and use(forced, 4, cpu)
    assert not use(dataclasses.replace(cfg, fused_inference=False), 1, cuda)


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    _, cfg = _cfgs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttracker.build_frame_step(cfg, make_core(cfg), {}, {})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttracker.StreamingTracker(cfg, {}, {})
    # the DNC core is ported: its StreamingTracker needs a card too
    dnc = dataclasses.replace(cfg, core="dnc")
    assert make_core(dnc).init_params is not None
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttracker.StreamingTracker(dnc, {}, {})
    with pytest.raises(ValueError, match="unknown core"):
        make_core(dataclasses.replace(cfg, core="lstm"))


@pytest.mark.parametrize("with_target,delimiter_first", [(True, True), (True, False), (False, False)])
def test_streaming_serialization_matches_jax(with_target, delimiter_first):
    feats = np.random.RandomState(3).randn(2, 4, 6).astype(np.float32)
    tgt = np.random.RandomState(4).rand(2, 4).astype(np.float32) if with_target else None
    ref = jser.serialize_streaming_batch(jnp.asarray(feats), None if tgt is None else jnp.asarray(tgt),
                                         delimiter_first=delimiter_first)
    got = tser.serialize_streaming_batch(torch.tensor(feats), None if tgt is None else torch.tensor(tgt),
                                         delimiter_first=delimiter_first)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        tser.serialize_streaming_frame(torch.tensor(feats[0]), None).numpy(),
        np.asarray(jser.serialize_streaming_frame(jnp.asarray(feats[0]), None)))


def test_training_serialization_matches_jax():
    feats = np.random.RandomState(5).randn(2, 3, 4, 6).astype(np.float32)
    tgt = np.random.RandomState(6).rand(2, 4).astype(np.float32)
    np.testing.assert_array_equal(tser.serialize_tokens(torch.tensor(feats), torch.tensor(tgt)).numpy(),
                                  np.asarray(jser.serialize_tokens(jnp.asarray(feats), jnp.asarray(tgt))))


@pytest.mark.parametrize("predict_scale", [False, True])
def test_host_geometry_matches_jax(predict_scale):
    jcfg, tcfg = _cfgs(predict_scale=predict_scale)
    region, size = (40.0, 28.0, 32.0, 24.0), (120, 90)
    jg = jtracker.region_geometry(jcfg.data, size, region)
    tg = ttracker.region_geometry(tcfg.data, size, region)
    np.testing.assert_array_equal(np.asarray(tg[1]), np.asarray(jg[1]))
    np.testing.assert_array_equal(tg[2], jg[2])
    np.testing.assert_array_equal(ttracker.first_frame_gt(tcfg, tg[0], tg[2]),
                                  jtracker.first_frame_gt(jcfg, jg[0], jg[2]))
    np.testing.assert_array_equal(ttracker.canonical_first_frame_gt(tcfg),
                                  jtracker.canonical_first_frame_gt(jcfg))
    out = np.array([0.1, -0.2, 0.3][: tcfg.head_dim])
    init_bbox = (0.1, 0.1, 0.9, 0.9)
    np.testing.assert_array_equal(ttracker.decode_head(tcfg, init_bbox, out),
                                  jtracker.decode_head(jcfg, init_bbox, out))
    np.testing.assert_array_equal(ttracker.decode_region(tg[2], size, (0.2, 0.3, 0.6, 0.7)),
                                  jtracker.decode_region(jg[2], size, (0.2, 0.3, 0.6, 0.7)))


def test_config_defaults_match_jax():
    def fields(obj):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}

    for name in ("NTMConfig", "DNCConfig", "DataConfig", "TrainConfig"):
        assert fields(getattr(tconfig, name)()) == fields(getattr(jconfig, name)()), name
    jt, tt = fields(jconfig.TrackerConfig()), fields(tconfig.TrackerConfig())
    assert jt.keys() == tt.keys()
    assert tt.pop("compute_dtype") == torch.float32 and jt.pop("compute_dtype") == jnp.float32
    for key in ("ntm", "dnc", "data", "train"):
        assert fields(tt.pop(key)) == fields(jt.pop(key))
    assert tt == jt
    with pytest.raises(ValueError):
        tconfig.validate_head(tconfig.TrackerConfig(predict_scale=True))
