"""The port's converters (tools/convert_{ntm,dnc}_ckpt.py, convert_vgg.py)
and models/vgg.py's receptive-field helpers against the JAX package's and
the executed-TF goldens: the NTM and DNC conversions of a real Saver round
trip reproduce the reference's rollout at tests/test_tf_parity.py's
tolerance through the .npz round trip, .npz files written by either package
load in the other, the error cases of tests/test_convert_{ntm,dnc}.py, and
convert-vgg through TensorFlow (skipped where TF is absent, as
tests/test_vgg_convert.py is)."""

import os

import numpy as np
import pytest
import torch

from ntm_tracker_tpu import config as jconfig
from ntm_tracker_tpu.models import vgg as jvgg
from ntm_tracker_tpu.tools import convert_dnc_ckpt as jdnc
from ntm_tracker_tpu.tools import convert_ntm_ckpt as jntm
from ntm_tracker_tpu_torch import cli
from ntm_tracker_tpu_torch import config as tconfig
from ntm_tracker_tpu_torch.interop import flatten_params
from ntm_tracker_tpu_torch.models import vgg as tvgg
from ntm_tracker_tpu_torch.models.dnc.access import _interface_sizes
from ntm_tracker_tpu_torch.models.dnc.dnc import dnc_step, init_dnc_state
from ntm_tracker_tpu_torch.models.ntm_cell import head_param_sizes, init_ntm_state
from ntm_tracker_tpu_torch.models.ntm_tracker import ntm_tracker_unroll
from ntm_tracker_tpu_torch.tools import convert_dnc_ckpt as tdnc
from ntm_tracker_tpu_torch.tools import convert_ntm_ckpt as tntm

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
TOL = 1e-4  # tests/test_tf_parity.py's bound (BASELINE.json's north star)


def _flat(tree):
    return flatten_params(tree)


def _same_tree(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


# ---- the NTM converter ------------------------------------------------------------


def _ntm_golden():
    g = np.load(os.path.join(FIXTURES, "tf_goldens_ckpt_convert.npz"))
    B, steps, IN, N, D, Hc, L, R, W = [int(x) for x in g["ckptcv_config"]]
    kw = dict(output_dim=2, mem_size=N, mem_dim=D, controller_hidden_size=Hc, controller_num_layers=L,
              read_head_size=R, write_head_size=W)
    variables = {str(name): g[f"ckptcv_var_{i}"] for i, name in enumerate(g["ckptcv_names"])}
    return g, B, variables, tconfig.NTMConfig(**kw), jconfig.NTMConfig(**kw)


def test_ntm_checkpoint_reproduces_the_reference_rollout(tmp_path):
    g, B, variables, cfg, jcfg = _ntm_golden()
    params = tntm.convert_ntm_variables(variables, cfg)
    _same_tree(params, jntm.convert_ntm_variables(variables, jcfg))
    tntm.save_params_npz(str(tmp_path / "ntm.npz"), params)
    params = tntm.load_params_npz(str(tmp_path / "ntm.npz"), "cpu")
    tokens = torch.tensor(np.asarray(g["ckptcv_inputs"]).swapaxes(0, 1))  # [B, T, IN]
    with torch.no_grad():
        _, logits, _ = ntm_tracker_unroll(params, cfg, tokens, state=init_ntm_state(params, cfg, B), remat=False)
    ref = np.asarray(g["ckptcv_logits"]).swapaxes(0, 1)
    worst = float(np.abs(logits.numpy() - ref).max())
    assert worst <= TOL, worst


def test_ntm_npz_loads_in_either_package(tmp_path):
    _, _, variables, cfg, jcfg = _ntm_golden()
    mine, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tntm.save_params_npz(mine, tntm.convert_ntm_variables(variables, cfg))
    jntm.save_params_npz(theirs, jntm.convert_ntm_variables(variables, jcfg))
    assert sorted(np.load(mine).files) == sorted(np.load(theirs).files)
    _same_tree(tntm.load_params_npz(theirs, "cpu"), jntm.load_params_npz(mine))
    _same_tree(tntm.load_params_npz(mine, "cpu"), jntm.load_params_npz(theirs))


def _ntm_cfg(**kw):
    base = dict(output_dim=2, mem_size=16, mem_dim=8, controller_hidden_size=24, controller_num_layers=1,
                read_head_size=2, write_head_size=1)
    base.update(kw)
    return tconfig.NTMConfig(**base), jconfig.NTMConfig(**base)


def _fake_ntm_ckpt(cfg, rng):
    """tests/test_convert_ntm.py's fabricated checkpoint."""
    Hc = cfg.controller_hidden_size
    P = sum(head_param_sizes(cfg).values())
    kin = 10 + cfg.read_head_size * cfg.mem_dim + Hc
    v = {
        "ntm-tracker/ntm-cell/addressing/weights": rng.rand(Hc, P),
        "ntm-tracker/ntm-cell/addressing/biases": rng.rand(P),
        "ntm-tracker/ntm-cell/weights": rng.rand(Hc, cfg.output_dim),
        "ntm-tracker/ntm-cell/biases": rng.rand(cfg.output_dim),
        "ntm-tracker/init_state/M": rng.rand(cfg.mem_size, cfg.mem_dim),
        "ntm-tracker/init_state/w": rng.rand(cfg.num_heads, cfg.mem_size),
        "ntm-tracker/init_state/read": rng.rand(cfg.read_head_size, cfg.mem_dim),
        "ntm-tracker/ntm-cell/lstm-controller/cell_0/basic_lstm_cell/kernel": rng.rand(kin, 4 * Hc),
        "ntm-tracker/ntm-cell/lstm-controller/cell_0/basic_lstm_cell/bias": rng.rand(4 * Hc),
    }
    return {k: a.astype(np.float32) for k, a in v.items()}


def _ntm_case(case, rng):
    cfg, jcfg = _ntm_cfg()
    v = _fake_ntm_ckpt(cfg, rng)
    if case == "missing":
        del v["ntm-tracker/init_state/M"]
        return v, _ntm_cfg(), "init_M"
    if case == "wrong_shape":
        return v, _ntm_cfg(controller_hidden_size=32), "heads_w"
    if case == "duplicate":
        v["some-other-scope/weights"] = rng.rand(cfg.controller_hidden_size, cfg.output_dim).astype(np.float32)
        return v, (cfg, jcfg), "both"
    if case == "deep_layer":
        v["ntm-tracker/ntm-cell/lstm-controller/cell_1/basic_lstm_cell/kernel"] = rng.rand(4, 96).astype(np.float32)
        return v, (cfg, jcfg), "controller layer 1"
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["missing", "wrong_shape", "duplicate", "deep_layer"])
def test_ntm_error_cases_match_jax(case):
    v, (cfg, jcfg), match = _ntm_case(case, np.random.RandomState(0))
    with pytest.raises(ValueError, match=match) as mine:
        tntm.convert_ntm_variables(v, cfg)
    with pytest.raises(ValueError) as theirs:
        jntm.convert_ntm_variables(v, jcfg)
    assert str(mine.value) == str(theirs.value).replace("pytree address", "tree address")


def test_ntm_skips_slots_and_accepts_old_lstm_names():
    cfg, jcfg = _ntm_cfg()
    rng = np.random.RandomState(1)
    v = _fake_ntm_ckpt(cfg, rng)
    v["ntm-tracker/ntm-cell/addressing/weights/RMSProp"] = rng.rand(3, 3).astype(np.float32)
    v["global_step"] = np.int64(1700)
    k = v.pop("ntm-tracker/ntm-cell/lstm-controller/cell_0/basic_lstm_cell/kernel")
    v["ntm-tracker/ntm-cell/lstm-controller/cell_0/basic_lstm_cell/weights"] = k
    _same_tree(tntm.convert_ntm_variables(v, cfg), jntm.convert_ntm_variables(v, jcfg))
    for name, shape in (("a/ntm-cell/addressing/weights", (24, 1)), ("a/lstm-controller/cell_1/basic_lstm_cell/kernel",
                        (48, 96)), ("a/init_state/read", (2, 8)), ("a/addressing/weights/RMSProp", (24, 1)),
                        ("x/weights", (24, 2)), ("x/biases", (2,))):
        assert tntm.classify_variable(name, shape, cfg) == jntm.classify_variable(name, shape, jcfg)


def test_validate_params_like_names_the_flag():
    cfg, _ = _ntm_cfg()
    from ntm_tracker_tpu_torch.models.ntm_cell import init_ntm_params

    template = init_ntm_params(cfg, 10, torch.Generator().manual_seed(0))
    tntm.validate_params_like(template, template)
    small = init_ntm_params(_ntm_cfg(mem_size=8)[0], 10, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="--ntm_npz init_M"):
        tntm.validate_params_like(small, template)
    with pytest.raises(ValueError, match="--dnc_npz params do not match"):
        tntm.validate_params_like({"out_w": template["out_w"]}, template, flag="--dnc_npz")


def test_convert_checkpoint_reads_a_real_saver_checkpoint(tmp_path):
    tf_mod = pytest.importorskip("tensorflow")
    tf = tf_mod.compat.v1
    _, _, variables, cfg, jcfg = _ntm_golden()
    with tf.Graph().as_default(), tf.Session() as sess:
        for name, value in variables.items():
            tf.get_variable(name, initializer=tf.constant(value))
        sess.run(tf.global_variables_initializer())
        path = tf.train.Saver().save(sess, str(tmp_path / "model.ckpt"))
    _same_tree(tntm.convert_checkpoint(path, cfg, verbose=False), jntm.convert_checkpoint(path, jcfg, verbose=False))


# ---- the DNC converter -------------------------------------------------------------


def test_dnc_checkpoint_reproduces_the_reference_rollout(tmp_path):
    g = np.load(os.path.join(FIXTURES, "tf_goldens_dnc_ckpt_convert.npz"))
    B, N, W, R, Wh, IN, HID, OUT, T = [int(x) for x in g["dncckpt_config"]]
    kw = dict(memory_size=N, word_size=W, num_reads=R, num_writes=Wh, hidden_size=HID, output_dim=OUT,
              clip_value=float(g["dncckpt_clip"]))
    cfg, jcfg = tconfig.DNCConfig(**kw), jconfig.DNCConfig(**kw)
    variables = {str(n): np.asarray(g[f"dncckpt_var_{i}"]) for i, n in enumerate(g["dncckpt_names"])}
    # non-core variables are skipped, and dynamic_rnn's extra 'rnn/' scope converts
    variables["global_step"] = np.int64(2600)
    variables["dnc/lstm/w_gates/RMSProp"] = np.zeros((3, 3), np.float32)
    variables = {(f"rnn/{k}" if k.startswith("dnc/") else k): v for k, v in variables.items()}
    params = tdnc.convert_dnc_variables(variables, cfg)
    _same_tree(params, jdnc.convert_dnc_variables(variables, jcfg))
    tdnc.save_params_npz(str(tmp_path / "dnc.npz"), params)
    jdnc.save_params_npz(str(tmp_path / "dnc_jax.npz"), jdnc.convert_dnc_variables(variables, jcfg))
    _same_tree(tdnc.load_params_npz(str(tmp_path / "dnc_jax.npz"), "cpu"), jdnc.load_params_npz(str(tmp_path / "dnc.npz")))
    params = tdnc.load_params_npz(str(tmp_path / "dnc.npz"), "cpu")
    state = init_dnc_state(cfg, B)
    outs = []
    with torch.no_grad():
        for t in range(T):
            out, state = dnc_step(params, cfg, torch.tensor(np.asarray(g["dncckpt_inputs"][t])), state)
            outs.append(out.numpy())
    worst = float(np.abs(np.stack(outs) - g["dncckpt_outputs"]).max())
    assert worst <= TOL, worst


def _dnc_cfg(**kw):
    base = dict(output_dim=2, memory_size=16, word_size=6, num_reads=3, num_writes=1, hidden_size=14)
    base.update(kw)
    return tconfig.DNCConfig(**base), jconfig.DNCConfig(**base)


def _fake_dnc_ckpt(cfg, rng):
    """tests/test_convert_dnc.py's fabricated checkpoint."""
    H = cfg.hidden_size
    ctrl_in = 11 + cfg.num_reads * cfg.word_size + H
    v = {
        "dnc/lstm/w_gates": rng.rand(ctrl_in, 4 * H), "dnc/lstm/b_gates": rng.rand(4 * H),
        "dnc/output_linear/w": rng.rand(H + cfg.num_reads * cfg.word_size, cfg.output_dim),
        "dnc/output_linear/b": rng.rand(cfg.output_dim),
    }
    for head, size in _interface_sizes(cfg).items():
        v[f"dnc/memory_access/{head}/w"] = rng.rand(H, size)
        v[f"dnc/memory_access/{head}/b"] = rng.rand(size)
    return {k: a.astype(np.float32) for k, a in v.items()}


@pytest.mark.parametrize("case", ["fused", "missing_head", "wrong_hidden", "duplicate", "no_output"])
def test_dnc_cases_match_jax(case):
    cfg, jcfg = _dnc_cfg()
    v = _fake_dnc_ckpt(cfg, np.random.RandomState(0))
    if case == "fused":
        _same_tree(tdnc.convert_dnc_variables(v, cfg), jdnc.convert_dnc_variables(v, jcfg))
        return
    match = {"missing_head": "free_gate", "wrong_hidden": "4\\*hidden", "duplicate": "both",
             "no_output": "out_w"}[case]
    if case == "missing_head":
        del v["dnc/memory_access/free_gate/w"]
    elif case == "wrong_hidden":
        cfg, jcfg = _dnc_cfg(hidden_size=20)
    elif case == "duplicate":
        v["other/dnc/lstm/w_gates"] = v["dnc/lstm/w_gates"].copy()
    else:
        del v["dnc/output_linear/w"]
    with pytest.raises(ValueError, match=match) as mine:
        tdnc.convert_dnc_variables(v, cfg)
    with pytest.raises(ValueError) as theirs:
        jdnc.convert_dnc_variables(v, jcfg)
    assert str(mine.value) == str(theirs.value)
    for name in ("rnn/dnc/lstm/w_gates", "dnc/memory_access/read_keys/w", "dnc/output_linear/b",
                 "dnc/lstm/w_gates/RMSProp", "dnc/memory_access/not_a_head/w"):
        assert tdnc.classify_variable(name, cfg) == jdnc.classify_variable(name, jcfg)


def test_convert_commands_parse_and_serve_flags():
    a = cli.build_parser().parse_args(["convert-ntm", "--ckpt", "c", "--out", "o.npz"])
    assert a.fn is cli.cmd_convert_ntm
    a = cli.build_parser().parse_args(["convert-dnc", "--ckpt", "c", "--out", "o.npz"])
    assert a.fn is cli.cmd_convert_dnc
    assert cli.build_parser().parse_args(["track-vot", "--core", "dnc", "--dnc_npz", "d.npz"]).dnc_npz == "d.npz"
    assert cli.build_parser().parse_args(["validate", "--pickle_path", "p", "--ntm_npz", "o.npz"]).ntm_npz == "o.npz"


# ---- receptive fields --------------------------------------------------------------


def test_receptive_field_matches_jax():
    assert tvgg.NET_DEF == jvgg.NET_DEF
    assert tvgg.receptive_field() == jvgg.receptive_field()
    assert tvgg.receptive_field(input_size=64) == jvgg.receptive_field(input_size=64)
    for y, x in [(0, 0), (6, 6), (20, 20), (27, 27), (13, 3)]:
        for layer in ("conv4_3", "pool2", "conv1_1"):
            for clamp in (True, False):
                assert (tvgg.project_receptive_field(y, x, layer, clamp=clamp)
                        == jvgg.project_receptive_field(y, x, layer, clamp=clamp))
    # the token grid's corner sees the 204x204 slice vgg16_conv43_tokens convolves
    assert tvgg.project_receptive_field(6, 6, clamp=False)[0] == (6, 6)
    assert tvgg.project_receptive_field(20, 20, clamp=False)[1] == (209, 209)


# ---- convert-vgg through TensorFlow ------------------------------------------------


@pytest.fixture(scope="module")
def mini_vgg_ckpt(tmp_path_factory):
    """A fabricated vgg_16 checkpoint with the real variable names and shapes
    (conv1..conv4_3 only: the conv5-less case the converter accepts)."""
    tf = pytest.importorskip("tensorflow").compat.v1
    root = tmp_path_factory.mktemp("vggckpt")
    rs = np.random.RandomState(11)
    values = {}
    with tf.Graph().as_default(), tf.Session() as sess:
        in_ch = 3
        for name, out_ch, _ in tvgg.VGG16_PREFIX[:10]:
            w = rs.normal(0, np.sqrt(2.0 / (9 * in_ch)), (3, 3, in_ch, out_ch)).astype(np.float32)
            b = rs.uniform(-0.05, 0.05, (out_ch,)).astype(np.float32)
            values[f"vgg_16/{name}/weights"], values[f"vgg_16/{name}/biases"] = w, b
            with tf.variable_scope(f"vgg_16/{name}"):
                tf.get_variable("weights", initializer=tf.constant(w))
                tf.get_variable("biases", initializer=tf.constant(b))
            in_ch = out_ch
        sess.run(tf.global_variables_initializer())
        path = tf.train.Saver().save(sess, str(root / "vgg_16.ckpt"))
    return path, values


def test_convert_vgg_command_matches_jax(mini_vgg_ckpt, tmp_path, capsys):
    from ntm_tracker_tpu.tools.convert_vgg import activation_stats as jstats
    from ntm_tracker_tpu.tools.convert_vgg import checkpoint_sha256 as jsha
    from ntm_tracker_tpu.tools.convert_vgg import convert_vgg_checkpoint as jconvert
    from ntm_tracker_tpu_torch.tools.convert_vgg import activation_stats, checkpoint_sha256

    path, values = mini_vgg_ckpt
    digest = checkpoint_sha256(path)
    assert digest == jsha(path)
    out = str(tmp_path / "vgg16.npz")
    assert cli.main(["--device", "cpu", "convert-vgg", "--ckpt", path, "--out", out, "--expect_sha256",
                     digest.upper()]) == 0
    printed = capsys.readouterr().out
    assert "wrote 20 arrays" in printed and "conv43_mean" in printed
    theirs = str(tmp_path / "jax.npz")
    assert jconvert(path, theirs) == {k: tuple(v.shape) for k, v in values.items()}
    a, b = np.load(out), np.load(theirs)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
    # the port loads it as OIHW; the self-check agrees with JAX's
    params = tvgg.load_params_npz(out)
    np.testing.assert_array_equal(params["conv1/conv1_1"]["weights"].numpy(),
                                  values["vgg_16/conv1/conv1_1/weights"].transpose(3, 2, 0, 1))
    mine, ref = activation_stats(out, "cpu"), jstats(theirs)
    for k in ref:
        assert abs(mine[k] - ref[k]) <= 1e-4 * max(1.0, abs(ref[k])), (k, mine[k], ref[k])
    with pytest.raises(ValueError, match="sha256 mismatch"):
        cli.main(["--device", "cpu", "convert-vgg", "--ckpt", path, "--out", str(tmp_path / "bad.npz"),
                  "--expect_sha256", "0" * 64])
    assert not os.path.exists(tmp_path / "bad.npz")
    with pytest.raises(KeyError, match="conv5"):
        cli.main(["--device", "cpu", "convert-vgg", "--ckpt", path, "--out", str(tmp_path / "x.npz"),
                  "--require_conv5"])
