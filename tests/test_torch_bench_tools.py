"""tools/bench_bptt_knee.py, tools/profile_train.py and tools/bench_train.py
on the CPU: the knee loss's gradients on both paths against jax.grad of
the JAX tool's loss (the JAX package's weights carried by interop.py), the
bf16 matmul with a bf16 backward against the JAX tool's custom VJP, the
ablation cell with no skips against the port's cell step, every ablation's
gradient step, and each tool's main(argv) at one step.

Tolerances: the knee's gradients within 1e-5 of each gradient's largest
entry (float32, the same math summed in other orders over 13 steps); the
bf16 product and its gradients within 2e-2 of their largest (both sides
round the operands to bf16 and sum in float32); the ablation cell within
1e-6 of the cell step (the same float32 operations)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntm_tracker_tpu.config import NTMConfig as JNTMConfig
from ntm_tracker_tpu.models.ntm_cell import init_ntm_params as jinit_ntm_params
from ntm_tracker_tpu.models.ntm_cell import init_ntm_state as jinit_ntm_state
from ntm_tracker_tpu.models.ntm_tracker import ntm_tracker_unroll as jax_unroll
from ntm_tracker_tpu.tools import profile_train as jprofile
from ntm_tracker_tpu_torch.config import NTMConfig
from ntm_tracker_tpu_torch.interop import flatten_params, params_from_flat
from ntm_tracker_tpu_torch.models.ntm_cell import init_ntm_params, init_ntm_state, ntm_cell_step
from ntm_tracker_tpu_torch.tools import bench_bptt_knee, bench_train, profile_train

KW = dict(output_dim=2, mem_size=16, mem_dim=8, controller_hidden_size=12,
          controller_num_layers=2, read_head_size=2, write_head_size=1)
B, T, IN = 2, 13, 7
KNEE_TOL = 1e-5
BF16_TOL = 2e-2
CELL_TOL = 1e-6


@pytest.mark.parametrize("path", ["fused", "plain"])
def test_knee_loss_gradients_match_jax(path):
    jcfg, tcfg = JNTMConfig(**KW), NTMConfig(**KW)
    jp = jinit_ntm_params(jax.random.PRNGKey(3), jcfg, IN)
    tokens = (0.3 * np.random.RandomState(B).standard_normal((B, T, IN))).astype(np.float32)

    def jloss(p, x, state):
        _, logits, final = jax_unroll(p, jcfg, x, state=state, remat=True, fused_bptt=False)
        return jnp.mean(logits ** 2) + jnp.mean(final["M"] ** 2)

    jgrads = flatten_params(jax.grad(jloss)(jp, jnp.asarray(tokens), jinit_ntm_state(jp, jcfg, B)))
    params = params_from_flat(flatten_params(jp))
    with torch.no_grad():
        state = init_ntm_state(params, tcfg, B)
    grads = bench_bptt_knee.knee_grads(params, tcfg, torch.tensor(tokens), state, path)
    got = dict(zip(flatten_params(params), (g.numpy() for g in grads)))
    assert got.keys() == jgrads.keys()
    for k, r in jgrads.items():
        np.testing.assert_allclose(got[k], r, rtol=0, atol=KNEE_TOL * float(np.abs(r).max()), err_msg=k)


def test_knee_unknown_path_raises():
    params = init_ntm_params(NTMConfig(**KW), IN, torch.Generator().manual_seed(0))
    state = init_ntm_state(params, NTMConfig(**KW), 1)
    with pytest.raises(ValueError, match="path"):
        bench_bptt_knee.knee_loss(params, NTMConfig(**KW), torch.zeros(1, 2, IN), state, "xla")


def test_mm_bf16_matches_jax_custom_vjp():
    rs = np.random.RandomState(0)
    a, w, cot = (rs.standard_normal(s).astype(np.float32) for s in ((6, 40), (40, 9), (6, 9)))
    jmm = jprofile._mm_bf16()
    jout, jvjp = jax.vjp(jmm, jnp.asarray(a), jnp.asarray(w))
    jda, jdw = jvjp(jnp.asarray(cot))
    ta, tw = torch.tensor(a, requires_grad=True), torch.tensor(w, requires_grad=True)
    out = profile_train._mm_bf16()(ta, tw)
    da, dw = torch.autograd.grad(out, (ta, tw), torch.tensor(cot))
    assert out.dtype == da.dtype == dw.dtype == torch.float32
    for got, ref in ((out, jout), (da, jda), (dw, jdw)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0, atol=BF16_TOL * float(np.abs(ref).max()))


def _cell_inputs(seed=0):
    cfg = NTMConfig(**KW)
    params = init_ntm_params(cfg, IN, torch.Generator().manual_seed(seed))
    # a state away from the initial one: three steps of the cell
    x = torch.tensor(np.random.RandomState(seed).standard_normal((4, B, IN)).astype(np.float32))
    state = init_ntm_state(params, cfg, B)
    for t in range(3):
        _, _, state = ntm_cell_step(params, cfg, x[t], state)
    return cfg, params, x[3], state


def test_ablation_cell_without_skips_is_the_cell_step():
    cfg, params, x, state = _cell_inputs()
    _, ref_logit, ref = ntm_cell_step(params, cfg, x, state)
    logit, got = profile_train.ablation_cell(params, cfg, x, state)
    torch.testing.assert_close(logit, ref_logit, rtol=0, atol=CELL_TOL)
    for k in ("M", "w", "read"):
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=CELL_TOL)
    for (c, h), (rc, rh) in zip(got["controller_state"], ref["controller_state"]):
        torch.testing.assert_close(c, rc, rtol=0, atol=CELL_TOL)
        torch.testing.assert_close(h, rh, rtol=0, atol=CELL_TOL)


@pytest.mark.parametrize("name", list(profile_train.ABLATIONS) + ["abl_bf16_vjp"])
def test_every_ablation_takes_a_gradient_step(name):
    cfg = NTMConfig(**KW)
    params = init_ntm_params(cfg, IN, torch.Generator().manual_seed(1))
    xs = torch.tensor(np.random.RandomState(1).rand(5, B, IN).astype(np.float32))
    skips = profile_train.ABLATIONS.get(name, frozenset())
    mm = profile_train._mm_bf16() if name == "abl_bf16_vjp" else profile_train._mm_f32_policy
    live = {k: ([{kk: t.requires_grad_() for kk, t in layer.items()} for layer in v] if k == "controller"
                else v.requires_grad_()) for k, v in params.items()}
    loss = profile_train.ablation_loss(live, cfg, xs, skips, mm)
    leaves = [t for layer in live["controller"] for t in layer.values()] + [
        v for k, v in live.items() if k != "controller"]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert torch.isfinite(loss)
    assert all(g is None or bool(torch.isfinite(g).all()) for g in grads)
    assert grads[0] is not None and float(grads[0].abs().max()) > 0


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]


@pytest.mark.parametrize("core", ["ntm", "dnc"])
def test_bench_train_main_on_the_cpu(core, capsys):
    argv = ["--modes", "tokens", "--batch", "1", "--seq_len", "1", "--iters", "1", "--device", "cpu", "--core", core]
    assert bench_train.main(argv) == 0
    (line,) = _lines(capsys)
    assert set(line) == {"mode", "step_ms", "frames_per_sec", "batch", "seq_len", "compute_dtype", "core", "platform",
                         "launches"}
    assert (line["mode"], line["core"], line["platform"], line["batch"]) == ("tokens", core, "cpu", 1)
    assert line["step_ms"] > 0 and line["launches"]["bptt_forward"] == 0


def test_profile_train_main_on_the_cpu(capsys):
    names = ["baseline_f32_full", "abl_no_cos", "lstm_only_f32", "f32_unroll13"]
    argv = ["--variants", ",".join(names), "--batch", "1", "--seq_len", "1", "--iters", "1", "--device", "cpu"]
    assert profile_train.main(argv) == 0
    lines = _lines(capsys)
    assert [line["variant"] for line in lines] == names
    for line in lines:
        assert "error" not in line and line["step_ms"] > 0
    assert set(lines[0]) == {"variant", "step_ms", "frames_per_sec", "train_mfu", "launches"}
    assert lines[0]["train_mfu"] is None  # no peak for the CPU
    assert set(lines[1]) == {"variant", "step_ms", "launches"}
    assert lines[3]["unroll_ignored"] is True and "unroll_ignored" not in lines[0]


def test_profile_train_unknown_variant_exits_nonzero(capsys):
    assert profile_train.main(["--variants", "no_such", "--device", "cpu"]) == 1
    assert _lines(capsys) == [{"variant": "no_such", "error": "unknown variant"}]


def test_bench_bptt_knee_main_on_the_cpu(capsys):
    assert bench_bptt_knee.main(["--batches", "1,2", "--seq", "2", "--iters", "1", "--device", "cpu"]) == 0
    lines = _lines(capsys)
    assert [(line["path"], line["B"]) for line in lines] == [("fused", 1), ("plain", 1), ("fused", 2), ("plain", 2)]
    for line in lines:
        assert line["T"] == 2 and line["tile"] is None and line["grad_step_ms"] > 0
