"""tracking/fleet.FleetTracker, tracking/tracker.make_device_track_step and
the data/geometry_jnp twins on the CPU, with NTMConfig.use_pallas off and
on: against the port's StreamingTracker (mirroring tests/test_fleet.py and
tests/test_tracking.py:147-220) and against the JAX package's fleet and
device loop for the same weights and frames."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ntm_tracker_tpu.ops.pallas.addressing as jfa
from ntm_tracker_tpu import config as jconfig
from ntm_tracker_tpu.data import geometry_jnp as jgeo
from ntm_tracker_tpu.models.core import make_core as jmake_core
from ntm_tracker_tpu.models.vgg import init_vgg_params as jinit_vgg
from ntm_tracker_tpu.tracking.fleet import FleetTracker as JFleetTracker
from ntm_tracker_tpu.tracking.tracker import make_device_track_step as jmake_device_track_step
from ntm_tracker_tpu_torch import config as tconfig
from ntm_tracker_tpu_torch.data import geometry, geometry_jnp
from ntm_tracker_tpu_torch.interop import (
    flatten_ntm_params,
    flatten_vgg_params,
    ntm_params_from_flat,
    vgg_params_from_flat,
)
from ntm_tracker_tpu_torch.models.core import make_core
from ntm_tracker_tpu_torch.ops.kernels import addressing
from ntm_tracker_tpu_torch.parallel.mesh import make_mesh
from ntm_tracker_tpu_torch.tracking.fleet import FleetTracker
from ntm_tracker_tpu_torch.tracking.tracker import StreamingTracker, make_device_track_step
from ntm_tracker_tpu_torch.utils import profiling

# Fleet (matmul crop) vs StreamingTracker (gather crop), both float32 on
# the CPU: the crops differ by float32 rounding (3e-5 of 255), which one
# frame step carries into the regions at well under 1e-3 px.
FLEET_RTOL, FLEET_ATOL = 1e-4, 1e-3
# Against the JAX package (XLA on the CPU, the same float32 math in other
# orders), one or two frame steps deep.
JAX_RTOL, JAX_ATOL = 1e-4, 1e-3
# The device loop against the host loop over five recrops: float32 device
# geometry against float64 host geometry, tests/test_tracking.py's bound.
LOOP_RTOL, LOOP_ATOL = 1e-4, 0.05
# B tracks in one device loop vs B loops of one: tests/test_tracking.py's bound
BATCH_RTOL, BATCH_ATOL = 1e-5, 1e-4


def _cfgs(use_pallas=False, **over):
    """tests/test_fleet.py:tiny_cfg, in both packages."""
    def build(mod):
        return mod.TrackerConfig(
            core="ntm",
            ntm=mod.NTMConfig(output_dim=3 if over.get("predict_scale") else 2, mem_size=16, mem_dim=8,
                              controller_hidden_size=32, read_head_size=2, use_pallas=use_pallas),
            data=mod.DataConfig(crop_size=32, resize_hw=(48, 64), gt_width=2),
            train=mod.TrainConfig(batch_size=1, sequence_length=2),
            num_features=4,
            feature_points=((1, 1), (1, 2), (2, 1), (2, 2)),
            **over,
        )

    return build(jconfig), build(tconfig)


def _setup(use_pallas=False, **over):
    jcfg, tcfg = _cfgs(use_pallas, **over)
    jcore = jmake_core(jcfg)
    jvgg = jinit_vgg(jax.random.PRNGKey(0))
    jp = jcore.init_params(jax.random.PRNGKey(1), jcfg.input_depth)
    tvgg = vgg_params_from_flat(flatten_vgg_params(jvgg))
    tp = ntm_params_from_flat(flatten_ntm_params(jp))
    return (jcfg, jcore, jvgg, jp), (tcfg, make_core(tcfg), tvgg, tp)


@pytest.fixture
def jax_kernel_interpreted(monkeypatch):
    """JAX's use_pallas path in interpret mode on the CPU
    (tests/test_pallas_addressing.py:109-121)."""
    orig = jfa.fused_ntm_addressing
    monkeypatch.setattr(jfa, "fused_ntm_addressing", lambda *a, **k: orig(*a, **dict(k, interpret=True)))


def _img(seed, h, w):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


PALLAS = pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "use_pallas"])


@PALLAS
def test_matches_single_tracker(use_pallas):
    _, (cfg, core, vgg, params) = _setup(use_pallas)
    rng = np.random.RandomState(0)
    img_a = (rng.rand(100, 160, 3) * 255).astype(np.uint8)
    img_b = (rng.rand(80, 120, 3) * 255).astype(np.uint8)
    region_a, region_b = (60.0, 30.0, 40.0, 30.0), (40.0, 20.0, 30.0, 24.0)
    fleet = FleetTracker(cfg, vgg, params, capacity=4, core=core, device="cpu")
    sa, sb = fleet.add(img_a, region_a), fleet.add(img_b, region_b)
    out = fleet.step({sa: img_a, sb: img_b})
    for slot, img, region in ((sa, img_a, region_a), (sb, img_b, region_b)):
        single = StreamingTracker(cfg, vgg, params, core, device="cpu")
        single.init(img, region)
        np.testing.assert_allclose(out[slot], single.track(img), rtol=FLEET_RTOL, atol=FLEET_ATOL)


@PALLAS
def test_mesh_of_two_devices_equals_the_meshless_fleet(use_pallas):
    """FleetTracker(mesh=) with two CPU devices: slots 0-1 on the first,
    2-3 on the second, each a fleet of its own; the regions equal the
    meshless fleet's over three frames (the same per-row math in batches
    of 2 against 4: BATCH_RTOL/ATOL), through a removal and a re-add."""
    _, (cfg, core, vgg, params) = _setup(use_pallas)
    imgs = [_img(10 + i, 64, 96) for i in range(4)]
    regions = [(30.0 + 4 * i, 20.0, 20.0, 16.0) for i in range(3)]
    plain = FleetTracker(cfg, vgg, params, capacity=4, core=core, device="cpu")
    sharded = FleetTracker(cfg, vgg, params, capacity=4, core=core, mesh=make_mesh(["cpu", "cpu"]))
    assert len(sharded.shards) == 2 and [f.capacity for f in sharded.shards] == [2, 2]
    for f in (plain, sharded):
        assert [f.add(imgs[0], r) for r in regions] == [0, 1, 2]
    for t in range(1, 4):
        if t == 2:
            for f in (plain, sharded):
                f.remove(1)
                assert f.active == [0, 2] and f.add(imgs[0], (44.0, 24.0, 20.0, 16.0)) == 1
        frames = {s: imgs[t] for s in (0, 1, 2)}
        a, b = plain.step(frames), sharded.step(frames)
        assert set(a) == set(b) == {0, 1, 2}
        for s in a:
            np.testing.assert_allclose(b[s], a[s], rtol=BATCH_RTOL, atol=BATCH_ATOL)
    with pytest.raises(ValueError, match="capacity 3 must divide over the 2-device mesh"):
        FleetTracker(cfg, vgg, params, capacity=3, core=core, mesh=make_mesh(["cpu", "cpu"]))
    one = FleetTracker(cfg, vgg, params, capacity=2, core=core, mesh=make_mesh(["cpu"]))
    assert one.shards is None and one.device.type == "cpu"


@PALLAS
def test_slot_reuse_and_isolation(use_pallas):
    _, (cfg, core, vgg, params) = _setup(use_pallas)
    img = _img(1, 64, 96)
    fleet = FleetTracker(cfg, vgg, params, capacity=2, core=core, device="cpu")
    s0 = fleet.add(img, (30.0, 20.0, 20.0, 16.0))
    s1 = fleet.add(img, (50.0, 30.0, 20.0, 16.0))
    assert sorted([s0, s1]) == [0, 1]
    fleet.remove(s0)
    assert fleet.active == [s1]
    fresh = fleet._fresh_state(1)
    assert torch.equal(fleet.state["M"][s0], fresh["M"][0])
    assert torch.equal(fleet.state["controller_state"][0][1][s0], fresh["controller_state"][0][1][0])
    s2 = fleet.add(img, (10.0, 10.0, 20.0, 16.0))
    assert s2 == s0
    out = fleet.step({s1: img, s2: img})
    assert set(out) == {s1, s2}
    for r in out.values():
        assert np.isfinite(r).all()


@PALLAS
def test_capacity_enforced(use_pallas):
    _, (cfg, core, vgg, params) = _setup(use_pallas)
    img = np.zeros((64, 96, 3), np.uint8)
    fleet = FleetTracker(cfg, vgg, params, capacity=1, core=core, device="cpu")
    fleet.add(img, (30.0, 20.0, 20.0, 16.0))
    with pytest.raises(RuntimeError, match="full"):
        fleet.add(img, (10.0, 10.0, 20.0, 16.0))


@PALLAS
def test_skipped_track_state_preserved(use_pallas):
    _, (cfg, core, vgg, params) = _setup(use_pallas)
    img = _img(2, 64, 96)
    fleet = FleetTracker(cfg, vgg, params, capacity=2, core=core, device="cpu")
    s0 = fleet.add(img, (30.0, 20.0, 20.0, 16.0))
    s1 = fleet.add(img, (50.0, 30.0, 20.0, 16.0))
    held = fleet.state
    m_before = held["M"][s1].clone()
    fleet.step({s0: img})  # s1 active but given no frame
    assert torch.equal(fleet.state["M"][s1], m_before)
    assert not torch.allclose(fleet.state["M"][s0], m_before)
    # the step wrote out of place: the state held before it is unchanged
    assert torch.equal(held["M"][s1], m_before) and fleet.state["M"] is not held["M"]


@PALLAS
def test_fleet_matches_jax_fleet(use_pallas, request):
    if use_pallas:
        request.getfixturevalue("jax_kernel_interpreted")
    (jcfg, jcore, jvgg, jp), (cfg, core, vgg, params) = _setup(use_pallas)
    imgs = [_img(3 + i, 64, 96) for i in range(3)] + [_img(6, 80, 120)]
    regions = [(20.0 + 4 * i, 12.0, 24.0, 20.0) for i in range(4)]
    jf = JFleetTracker(jcfg, jvgg, jp, capacity=5, core=jcore)
    tf = FleetTracker(cfg, vgg, params, capacity=5, core=core, device="cpu")
    js = [jf.add(im, r) for im, r in zip(imgs, regions)]
    ts = [tf.add(im, r) for im, r in zip(imgs, regions)]
    assert js == ts
    for frames in ({s: im for s, im in zip(ts, imgs)}, {s: im for s, im in zip(ts[1:], imgs[1:])}):
        jout, tout = jf.step(frames), tf.step(frames)
        assert set(jout) == set(tout)
        for s in tout:
            np.testing.assert_allclose(tout[s], jout[s], rtol=JAX_RTOL, atol=JAX_ATOL)
    for key in ("M", "w", "read"):
        np.testing.assert_allclose(tf.state[key].numpy(), np.asarray(jf.state[key]), atol=1e-5, err_msg=key)


def _norm(region, H, W):
    x, y, w, h = region
    return [y / (H - 1), x / (W - 1), (y + h) / (H - 1), (x + w) / (W - 1)]


@pytest.mark.parametrize("use_pallas,predict_scale", [(False, False), (True, False), (False, True)],
                         ids=["plain", "use_pallas", "predict_scale"])
def test_device_loop_matches_streaming_tracker_and_jax(use_pallas, predict_scale, request):
    if use_pallas:
        request.getfixturevalue("jax_kernel_interpreted")
    over = dict(predict_scale=True) if predict_scale else {}
    (jcfg, jcore, jvgg, jp), (cfg, core, vgg, params) = _setup(use_pallas, **over)
    H, W = 90, 160
    frames = (np.random.RandomState(0).rand(6, H, W, 3) * 255).astype(np.float32)
    region0 = (60.0, 30.0, 40.0, 30.0)

    host = StreamingTracker(cfg, vgg, params, core, device="cpu")
    host.init(frames[0], region0)
    host_regions = [host.track(frames[t]) for t in range(1, 6)]

    init_fn, step_fn = make_device_track_step(cfg, core, vgg, params, device="cpu")
    bbox = torch.tensor([_norm(region0, H, W)])
    state = init_fn(torch.tensor(frames[0:1]), bbox, core.init_state(params, 1))
    got = []
    for t in range(1, 6):
        region, bbox, state = step_fn(torch.tensor(frames[t:t + 1]), bbox, state)
        got.append(region[0].numpy())
    np.testing.assert_allclose(np.asarray(got), np.asarray(host_regions), rtol=LOOP_RTOL, atol=LOOP_ATOL)

    jinit, jstep = jmake_device_track_step(jcfg, jcore, jvgg, jp)
    jbbox = jnp.asarray([_norm(region0, H, W)], jnp.float32)
    jstate = jinit(frames[0:1], jbbox, jcore.init_state(jp, 1))
    want = []
    for t in range(1, 6):
        jregion, jbbox, jstate = jstep(frames[t:t + 1], jbbox, jstate)
        want.append(np.asarray(jregion[0]))
    # the first recrop agrees as one frame step does; over five chained
    # recrops an untrained cell amplifies the float32 rounding of both
    # device loops (tests/test_tracking.py's note), so the whole trajectory
    # is held at the loop bound
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=JAX_RTOL, atol=JAX_ATOL)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=LOOP_RTOL, atol=LOOP_ATOL)


@PALLAS
def test_device_loop_batched_tracks_are_independent(use_pallas):
    _, (cfg, core, vgg, params) = _setup(use_pallas)
    H, W, T, N = 60, 80, 4, 3
    frames = (np.random.RandomState(1).rand(N, T, H, W, 3) * 255).astype(np.float32)
    regions0 = [(30.0, 15.0, 20.0, 16.0), (20.0, 10.0, 24.0, 20.0), (40.0, 25.0, 16.0, 12.0)]
    init_fn, step_fn = make_device_track_step(cfg, core, vgg, params, device="cpu")
    bbox = torch.tensor([_norm(r, H, W) for r in regions0])
    state = init_fn(torch.tensor(frames[:, 0]), bbox, core.init_state(params, N))
    batched = []
    for t in range(1, T):
        region, bbox, state = step_fn(torch.tensor(frames[:, t]), bbox, state)
        batched.append(region.numpy())
    for i in range(N):
        bbox1 = torch.tensor([_norm(regions0[i], H, W)])
        state1 = init_fn(torch.tensor(frames[i, 0:1]), bbox1, core.init_state(params, 1))
        for t in range(1, T):
            region1, bbox1, state1 = step_fn(torch.tensor(frames[i, t:t + 1]), bbox1, state1)
            np.testing.assert_allclose(batched[t - 1][i], region1[0].numpy(), rtol=BATCH_RTOL, atol=BATCH_ATOL)


def test_geometry_twins_match_jax_and_numpy():
    rs = np.random.RandomState(4)
    y1, x1 = rs.uniform(0.0, 0.5, (2, 5))
    bbox = np.stack([y1, x1, y1 + rs.uniform(0.1, 0.4, 5), x1 + rs.uniform(0.1, 0.4, 5)], -1).astype(np.float32)
    factor = rs.uniform(0.7, 1.4, 5).astype(np.float32)
    tb, jb = torch.tensor(bbox), jnp.asarray(bbox)
    cb = geometry_jnp.cropbox_of(tb, 8, 6)
    jcb = jgeo.cropbox_of(jb, 8, 6)
    canon, jcanon = geometry_jnp.canonical_box(8, 6), jgeo.canonical_box(8, 6)
    pairs = {
        "cropbox_of": (cb, jcb),
        "to_crop_space": (geometry_jnp.to_crop_space(tb, cb), jgeo.to_crop_space(jb, jcb)),
        "to_image_space": (geometry_jnp.to_image_space(tb, cb), jgeo.to_image_space(jb, jcb)),
        "canonical_box": (canon, jcanon),
        "center_offsets": (geometry_jnp.center_offsets(tb, canon), jgeo.center_offsets(jb, jcanon)),
        "center_log_scale": (geometry_jnp.center_log_scale(tb, canon), jgeo.center_log_scale(jb, jcanon)),
        "scale_box": (geometry_jnp.scale_box(tb, torch.tensor(factor)), jgeo.scale_box(jb, jnp.asarray(factor))),
    }
    for name, (got, want) in pairs.items():
        assert got.dtype == torch.float32, name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7, err_msg=name)
    # the host geometry (float64) they stand in for
    init = geometry.initial_transformed_bbox(8, 6)
    np.testing.assert_allclose(canon.numpy(), init, atol=1e-7)
    for i in range(5):
        np.testing.assert_allclose(cb[i].numpy(), geometry.calculate_cropbox(bbox[i], 8, 6), atol=1e-6)
        tr = geometry.calculate_transformation(cb[i].double().numpy())
        crop = geometry.apply_transformation(bbox[i], tr)
        np.testing.assert_allclose(pairs["to_crop_space"][0][i].numpy(), crop, atol=1e-6)
        back = geometry_jnp.to_image_space(pairs["to_crop_space"][0][i:i + 1], cb[i:i + 1])[0]
        np.testing.assert_allclose(back.numpy(), geometry.apply_transformation(crop, np.linalg.inv(tr)), atol=1e-6)
        np.testing.assert_allclose(pairs["center_offsets"][0][i].numpy(), geometry.calculate_offsets(bbox[i], init),
                                   atol=1e-6)
        np.testing.assert_allclose(float(pairs["center_log_scale"][0][i]), geometry.calculate_scale(bbox[i], init),
                                   atol=1e-5)
        np.testing.assert_allclose(pairs["scale_box"][0][i].numpy(), geometry.scale_bbox(bbox[i], float(factor[i])),
                                   atol=1e-6)


def test_new_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    _, (cfg, core, vgg, params) = _setup()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FleetTracker(cfg, vgg, params, capacity=2, core=core)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_device_track_step(cfg, core, vgg, params)


@PALLAS
def test_cpu_fleet_never_launches(use_pallas):
    _, (cfg, core, vgg, params) = _setup(use_pallas)
    img = _img(5, 64, 96)
    fleet = FleetTracker(cfg, vgg, params, capacity=2, core=core, device="cpu")
    fleet.step({fleet.add(img, (30.0, 20.0, 20.0, 16.0)): img})
    assert profiling.counter("launches.fused_ntm_addressing") == 0


# ---- the fleet from an exported artifact (export-serving --batch N) -------------


@pytest.fixture(scope="module")
def exported_b2(tmp_path_factory):
    from ntm_tracker_tpu_torch.tools.export_serving import export_serving, save_serving

    _, (cfg, core, vgg, params) = _setup()
    path = str(tmp_path_factory.mktemp("export_b2") / "serving_b2.npz")
    save_serving(path, export_serving(cfg, core, vgg, params, batch=2, platforms=["cpu"]))
    return path


def test_fleet_from_serving_matches_live_fleet(exported_b2):
    """A batch-2 artifact drives the fleet with no model code: first at B=1
    (each add), init/step at the capacity; the same regions as the live
    fleet on the plain route, and a freed slot comes back fresh."""
    from ntm_tracker_tpu_torch.tools.export_serving import ServingModel

    _, (cfg, core, vgg, params) = _setup()
    model = ServingModel(exported_b2, device="cpu")
    assert model.meta["batch"] == 2 and model.meta["first_batch"] == 1
    img_a, img_b = _img(3, 60, 80), _img(4, 50, 70)
    region_a, region_b = (30.0, 15.0, 20.0, 16.0), (20.0, 10.0, 16.0, 12.0)
    plain = dataclasses.replace(cfg, fused_inference=False)
    live = FleetTracker(plain, vgg, params, capacity=2, core=make_core(plain), device="cpu")
    la, lb = live.add(img_a, region_a), live.add(img_b, region_b)
    served = FleetTracker.from_serving(model)
    assert served.capacity == 2 and served.device.type == "cpu"
    sa, sb = served.add(img_a, region_a), served.add(img_b, region_b)
    for _ in range(3):
        live_out = live.step({la: img_a, lb: img_b})
        served_out = served.step({sa: img_a, sb: img_b})
        np.testing.assert_allclose(served_out[sa], live_out[la], rtol=0, atol=1e-4)
        np.testing.assert_allclose(served_out[sb], live_out[lb], rtol=0, atol=1e-4)
    # an omitted slot keeps its state; a freed slot is reset from the baked init
    before = [t.clone() for t in served.state]
    served.step({sa: img_a})
    assert all(torch.equal(x[sb], y[sb]) for x, y in zip(served.state, before))
    served.remove(sa)
    assert all(torch.equal(x[sa], y[0]) for x, y in zip(served.state, served._fresh_state(1)))
    assert served.add(img_a, region_a) == sa


def test_serving_refusals(exported_b2):
    from ntm_tracker_tpu_torch.tools.export_serving import ServingModel

    _, (cfg, *_rest) = _setup()
    model = ServingModel(exported_b2, device="cpu")
    with pytest.raises(ValueError, match="batch-1"):
        StreamingTracker.from_serving(model)
    with pytest.raises(ValueError, match="bakes batch 2"):
        FleetTracker(cfg, None, None, capacity=4, serving_model=model)
    with pytest.raises(ValueError, match="mesh-sharded fleets need the live frame step"):
        FleetTracker(cfg, None, None, capacity=2, mesh=make_mesh(["cpu"]), serving_model=model)
