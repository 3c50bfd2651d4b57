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


# ---- the validate command against the JAX package's validate_tracker -------------

CLI_MODEL = ["--mem_size", "16", "--mem_dim", "8", "--hidden_size", "24", "--read_head_size", "2"]


@pytest.fixture(scope="module")
def cli_files(seqs, tmp_path_factory):
    """The pickle of the sequences, and one set of weights both packages'
    CLIs load: JAX-initialized NTM params as a convert-ntm .npz (--ntm_npz)
    and VGG weights under the slim names (--vgg_weights)."""
    import pickle

    from ntm_tracker_tpu import cli as jcli
    from ntm_tracker_tpu.tools.convert_ntm_ckpt import save_params_npz

    root = tmp_path_factory.mktemp("validate_cli")
    with open(root / "val.pkl", "wb") as f:
        pickle.dump(seqs, f)
    args = jcli.build_parser().parse_args(["validate", "--pickle_path", "x", *CLI_MODEL])
    jcfg = jcli._tracker_config(args, "ntm")
    save_params_npz(str(root / "ntm.npz"), jmake_core(jcfg).init_params(jax.random.PRNGKey(3), jcfg.input_depth))
    vgg = flatten_vgg_params(jinit_vgg(jax.random.PRNGKey(0)))
    np.savez(root / "vgg.npz", **{f"vgg_16/{k}": v for k, v in vgg.items()})
    return root


def _weight_flags(cli_files):
    return ["--ntm_npz", str(cli_files / "ntm.npz"), "--vgg_weights", str(cli_files / "vgg.npz"), *CLI_MODEL]


@pytest.fixture(scope="module")
def artifacts(cli_files):
    """Each package's batch-1 artifact (export-serving) from the same weight
    files."""
    from ntm_tracker_tpu import cli as jcli
    from ntm_tracker_tpu_torch import cli

    for mod, name in ((cli, "port.npz"), (jcli, "jax.npz")):
        prefix = ["--device", "cpu"] if mod is cli else []
        args = mod.build_parser().parse_args([*prefix, "export-serving", *_weight_flags(cli_files), "--out",
                                              str(cli_files / name)])
        assert args.fn(args) == 0
    return str(cli_files / "port.npz"), str(cli_files / "jax.npz")


def _jax_validate(argv, monkeypatch):
    """JAX's validate_tracker on argv; returns the IoUs its replay made."""
    from ntm_tracker_tpu import cli as jcli

    got = []
    for name in ("replay_sequences", "replay_sequences_fleet"):
        orig = getattr(jval, name)

        def record(*a, _orig=orig, **k):
            got.append(_orig(*a, **dict(k, log=lambda m: None)))
            return got[-1]

        monkeypatch.setattr(jval, name, record)
    assert jval.validate_tracker(jcli.build_parser().parse_args(argv)) == 0
    return got[0]


@pytest.mark.parametrize("extra", [["--limit", "2"], ["--fleet", "2"], ["--serving_npz"]],
                         ids=["limit", "fleet", "serving_npz"])
def test_validate_command_matches_jax(cli_files, artifacts, monkeypatch, capsys, extra):
    from ntm_tracker_tpu_torch import cli

    base = ["validate", "--pickle_path", str(cli_files / "val.pkl")]
    if extra == ["--serving_npz"]:
        mine, theirs = base + ["--serving_npz", artifacts[0]], base + ["--serving_npz", artifacts[1]]
    else:
        mine = theirs = base + _weight_flags(cli_files) + extra
    args = cli.build_parser().parse_args(["--device", "cpu", *mine])
    got = tval.validate_tracker(args)
    printed = capsys.readouterr().out
    assert "overall mean IoU over" in printed
    if extra[0] == "--limit":
        assert "--limit 2: replaying 2 sequences" in printed
    want = _jax_validate(theirs, monkeypatch)
    assert [len(s) for s in got] == [len(s) for s in want] == ([3, 2] if extra[0] == "--limit" else [3, 2, 0])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=IOU_ATOL, rtol=0)


def test_validate_command_refusals(cli_files, artifacts):
    from ntm_tracker_tpu_torch import cli

    base = ["--device", "cpu", "validate", "--pickle_path", str(cli_files / "val.pkl")]
    with pytest.raises(SystemExit, match="positive capacity"):
        cli.main([*base, "--fleet", "-1"])
    with pytest.raises(SystemExit, match="bakes batch 1"):
        cli.main([*base, "--serving_npz", artifacts[0], "--fleet", "2"])
    with pytest.raises(SystemExit, match="exact token path"):
        cli.main([*base, "--serving_npz", artifacts[0], "--vgg_int8"])
    with pytest.raises(ValueError, match="JAX package's serving artifact"):
        cli.main([*base, "--serving_npz", artifacts[1]])
    with pytest.raises(SystemExit, match="only one of"):
        cli.main([*base, "--ntm_npz", "a.npz", "--dnc_npz", "b.npz"])
