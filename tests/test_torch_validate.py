"""tracking/validate.py on the CPU against the JAX package's: get_image on
frame records, replay_sequences and replay_sequences_fleet (capacity 2
over three sequences, so a finished slot is refilled) on a tiny dataset
of PNG frames and .txt records written here (the record layout of
tests/test_cli_smoke.py's `dataset` fixture), with the weights carried
across by interop.py."""

import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from ntm_tracker_tpu import config as jconfig
from ntm_tracker_tpu.models.core import make_core as jmake_core
from ntm_tracker_tpu.models.vgg import init_vgg_params as jinit_vgg
from ntm_tracker_tpu.tracking import validate as jval
from ntm_tracker_tpu_torch import config as tconfig
from ntm_tracker_tpu_torch.interop import flatten_params, flatten_vgg_params, params_from_flat, vgg_params_from_flat
from ntm_tracker_tpu_torch.tracking import validate as tval

# per-frame IoU after up to three recrops, float32 in other orders
# (tests/test_torch_fleet.py's regions agree to ~1e-3 px)
IOU_ATOL = 1e-3
H, W = 48, 64
CROPBOX = [0.1, 0.15, 0.9, 0.85]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run thousands of small ops, which
    stall on thread hand-offs when the run's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs():
    def build(mod):
        return mod.TrackerConfig(
            core="ntm",
            ntm=mod.NTMConfig(mem_size=16, mem_dim=8, controller_hidden_size=32, read_head_size=2),
            data=mod.DataConfig(crop_size=32, resize_hw=(48, 64), gt_width=2),
            train=mod.TrainConfig(batch_size=1, sequence_length=2),
            num_features=4,
            feature_points=((1, 1), (1, 2), (2, 1), (2, 2)),
        )
    return build(jconfig), build(tconfig)


@pytest.fixture(scope="module")
def seqs(tmp_path_factory):
    """Three sequences (4, 3 and 1 frames): a bright square drifting over
    noise; records hold the cropbox, the box in crop space, the image."""
    root = tmp_path_factory.mktemp("val")
    rs = np.random.RandomState(5)
    out = []
    for s, n in enumerate((4, 3, 1)):
        seq = root / f"val_seq{s}"
        seq.mkdir()
        names = []
        for i in range(n):
            img = (rs.rand(H, W, 3) * 60).astype(np.uint8)
            y0, x0 = 14 + 2 * i + s, 20 + 3 * i
            img[y0:y0 + 16, x0:x0 + 20] = 230
            path = str(seq / f"{i:06d}.png")
            Image.fromarray(img).save(path)
            cy1, cx1, cy2, cx2 = CROPBOX
            # the box in crop space: (image coordinate - crop origin) / crop size
            box = [(y0 / H - cy1) / (cy2 - cy1), (x0 / W - cx1) / (cx2 - cx1),
                   ((y0 + 16) / H - cy1) / (cy2 - cy1), ((x0 + 20) / W - cx1) / (cx2 - cx1)]
            (seq / f"{i:06d}.txt").write_text(",".join(str(v) for v in CROPBOX + box + [path, "0.0", "0.0"]))
            names.append(f"{i:06d}")
        out.append((str(seq), names))
    return out


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    jvgg = jinit_vgg(jax.random.PRNGKey(0))
    jparams = jmake_core(jcfg).init_params(jax.random.PRNGKey(1), jcfg.input_depth)
    return (jcfg, jvgg, jparams), (tcfg, vgg_params_from_flat(flatten_vgg_params(jvgg)),
                                   params_from_flat(flatten_params(jparams)))


def test_get_image_matches_jax(seqs):
    for seq_path, names in seqs:
        for name in names:
            path = os.path.join(seq_path, name)
            got, want = tval.get_image(path), jval.get_image(path)
            assert got[0] == want[0] and got[0].endswith(f"{name}.png")
            np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-12)
            # the record's box decodes back to the drawn square, normalized
            x, y, w, h = got[1]
            assert 0 < x < 1 and 0 < y < 1 and abs(w - 20 / W) < 1e-6 and abs(h - 16 / H) < 1e-6


def test_replay_sequences_matches_jax(seqs, models):
    (jcfg, jvgg, jparams), (tcfg, vgg, params) = models
    logs = []
    want = jval.replay_sequences(seqs, jcfg, jvgg, jparams, log=lambda m: None)
    got = tval.replay_sequences(seqs, tcfg, vgg, params, log=logs.append, device="cpu")
    assert [len(s) for s in got] == [3, 2, 0]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=IOU_ATOL, rtol=0)
    assert len(logs) == 3 and logs[0].startswith("seq 0: mean IoU")


def test_replay_sequences_fleet_matches_jax(seqs, models):
    (jcfg, jvgg, jparams), (tcfg, vgg, params) = models
    want = jval.replay_sequences_fleet(seqs, jcfg, jvgg, jparams, capacity=2, log=lambda m: None)
    got = tval.replay_sequences_fleet(seqs, tcfg, vgg, params, capacity=2, log=lambda m: None, device="cpu")
    assert [len(s) for s in got] == [3, 2, 0]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=IOU_ATOL, rtol=0)
    # the fleet replays what the one-at-a-time replay does
    single = tval.replay_sequences(seqs, tcfg, vgg, params, log=lambda m: None, device="cpu")
    for g, s in zip(got, single):
        np.testing.assert_allclose(g, s, atol=IOU_ATOL, rtol=0)
