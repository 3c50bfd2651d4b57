"""The training scan (ops/kernels/scan_bptt.py) on the CPU: the wrapper's
plain version against jax.grad of the JAX package's jnp scan and against
its fused BPTT kernel in interpret mode, on logits, the final state, every
parameter gradient (init_* through init_ntm_state), the token gradients;
the fused_bptt routing. The CUDA kernels are held against the plain
version on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntm_tracker_tpu.models.ntm_cell import init_ntm_state as jinit_state
from ntm_tracker_tpu.ops.pallas.scan_bptt import ntm_scan_fused_bptt as jax_fused_bptt
from ntm_tracker_tpu_torch import _build
from ntm_tracker_tpu_torch.interop import flatten_ntm_params, ntm_params_from_flat
from ntm_tracker_tpu_torch.models.ntm_cell import HEAD_PARAM_ORDER, head_param_sizes, init_ntm_state
from ntm_tracker_tpu_torch.models.ntm_tracker import ntm_tracker_unroll, use_fused_bptt
from ntm_tracker_tpu_torch.ops.kernels import scan_bptt
from ntm_tracker_tpu_torch.ops.kernels.scan_bptt import ntm_scan_fused_bptt
from ntm_tracker_tpu_torch.ops.kernels.scan_cell import ntm_scan_fused
from ntm_tracker_tpu_torch.utils import profiling

from tests.pallas_harness import B, CONFIGS, jnp_unroll, make_loss, setup_case
from tests.torch_grad_parity import (
    FWD_TOL,
    LOSS_RTOL,
    assert_grads,
    case,
    jax_value_and_grad,
    port_cfg,
    port_value_and_grad,
    torch_cot,
)

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plain_version_matches_jax_grad_and_pallas_interpret(name):
    jcfg, tcfg, params, tokens, cot = case(name)
    value, logits, final, grads = port_value_and_grad(ntm_scan_fused_bptt, tcfg, params, tokens, cot)

    # forward values against the jnp scan
    jlogits, jfinal = jnp_unroll(params, jcfg, tokens, jinit_state(params, jcfg, B))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=FWD_TOL)
    for key in ("M", "w", "read"):
        np.testing.assert_allclose(final[key].detach().numpy(), np.asarray(jfinal[key]), atol=FWD_TOL, err_msg=key)
    for (c, h), (jc, jh) in zip(final["controller_state"], jfinal["controller_state"]):
        np.testing.assert_allclose(c.detach().numpy(), np.asarray(jc), atol=FWD_TOL)
        np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), atol=FWD_TOL)

    # every gradient against jax.grad of the jnp scan ...
    v_ref, g_ref = jax_value_and_grad(lambda p, t, s: jnp_unroll(p, jcfg, t, s), jcfg, params, tokens, cot)
    np.testing.assert_allclose(value, v_ref, rtol=LOSS_RTOL)
    assert_grads(grads, g_ref)
    # ... and against the JAX package's own fused kernel, run as its tests run it
    v_pl, g_pl = jax_value_and_grad(
        lambda p, t, s: jax_fused_bptt(p, jcfg, t, s, interpret=True), jcfg, params, tokens, cot
    )
    np.testing.assert_allclose(value, v_pl, rtol=LOSS_RTOL)
    assert_grads(grads, g_pl)
    for key in ("init_M", "init_w", "init_read"):
        assert np.abs(grads[key]).max() > 0, key


def _one_hot_wconv_case():
    """flagship_shape with heads that make w_conv exactly one-hot at T=1:
    one live memory slot, a huge beta, g = 1 and one shift weight."""
    jcfg = CONFIGS["flagship_shape"]
    params, _state, tokens, cot = setup_case(jcfg, seed=11)
    tokens = tokens[:, :1]
    cot = (cot[0][:, :1],) + tuple(cot[1:])
    sizes, cols, o = head_param_sizes(port_cfg(jcfg)), {}, 0
    for key in HEAD_PARAM_ORDER:
        cols[key] = slice(o, o + sizes[key])
        o += sizes[key]
    hw, hb = np.array(params["heads_w"]), np.array(params["heads_b"])
    for key in ("k", "beta", "g", "sw"):
        hw[:, cols[key]] = 0.0
    hb[cols["k"]], hb[cols["beta"]], hb[cols["g"]] = 3.0, 1000.0, 40.0
    hb[cols["sw"]] = np.tile([0.0, 300.0, 0.0], jcfg.num_heads)
    params = dict(params, heads_w=jnp.asarray(hw), heads_b=jnp.asarray(hb))
    M0 = np.zeros((B, jcfg.mem_size, jcfg.mem_dim), np.float32)
    M0[:, 5, :] = 1.0
    return jcfg, params, tokens, cot, M0, cols


def test_gamma_gradient_is_zero_where_w_conv_is_zero():
    """The kernel contract (scan_bptt.py:28-31): d/dgamma of w_conv^gamma is
    0 where w_conv == 0. Here w_conv is exactly one-hot, so every gamma
    gradient is exactly 0 (log 1 = 0 on the hot entry). The installed
    torch and JAX both give 0 for d/dy 0^y as well, so the plain version
    agrees with jax.grad of the jnp scan and with the JAX fused kernel."""
    jcfg, params, tokens, cot, M0, cols = _one_hot_wconv_case()
    tcfg = port_cfg(jcfg)

    def jloss(unroll):
        return lambda p, t: make_loss(unroll, cot)(p, t, dict(jinit_state(p, jcfg, B), M=jnp.asarray(M0)))

    g_jnp = jax.grad(jloss(lambda p, t, s: jnp_unroll(p, jcfg, t, s)), argnums=(0, 1))(params, tokens)
    g_ref = jax.grad(jloss(lambda p, t, s: jax_fused_bptt(p, jcfg, t, s, interpret=True)), argnums=(0, 1))(
        params, tokens)

    tp = ntm_params_from_flat(flatten_ntm_params(params))
    leaves = [tp["heads_w"], tp["heads_b"], tp["controller"][0]["kernel"], tp["init_w"]]
    for t in leaves:
        t.requires_grad_()
    tok = torch.tensor(np.asarray(tokens)).requires_grad_()
    state = dict(init_ntm_state(tp, tcfg, B), M=torch.tensor(M0))
    logits, final = ntm_scan_fused_bptt(tp, tcfg, tok, state)
    A, BM, Bw, Br, Bc = torch_cot(cot)
    loss = (logits * A).sum() + (final["M"] * BM).sum() + (final["w"] * Bw).sum() + (final["read"] * Br).sum()
    for c, h in final["controller_state"]:
        loss = loss + (c * Bc).sum() + 0.5 * (h * Bc).sum()
    g_hw, g_hb, g_k, g_iw, g_tok = torch.autograd.grad(loss, leaves + [tok])
    for g in (g_hw, g_hb, g_k, g_iw, g_tok):
        assert torch.isfinite(g).all()
    assert (g_hb[cols["gamma"]] == 0).all() and (g_hw[:, cols["gamma"]] == 0).all()
    got = {"heads_w": g_hw.numpy(), "heads_b": g_hb.numpy(), "controller[0].kernel": g_k.numpy(),
           "init_w": g_iw.numpy(), "tokens": g_tok.numpy()}
    for g in (g_jnp, g_ref):
        ref = flatten_ntm_params(g[0])
        ref = {k: ref[k] for k in got if k != "tokens"}
        ref["tokens"] = np.asarray(g[1])
        assert_grads(got, ref)


def test_cpu_tensors_take_the_plain_version_without_launches():
    _, tcfg, params, tokens, cot = case("flagship_shape")
    before = profiling.snapshot()["counters"]
    port_value_and_grad(ntm_scan_fused_bptt, tcfg, params, tokens, cot)
    with torch.no_grad():
        tp = ntm_params_from_flat(flatten_ntm_params(params))
        ntm_scan_fused_bptt(tp, tcfg, torch.tensor(np.asarray(tokens)), init_ntm_state(tp, tcfg, B))
    assert profiling.snapshot()["counters"] == before


def test_other_devices_raise():
    _, tcfg, params, tokens, _ = case("flagship_shape")
    tp = ntm_params_from_flat(flatten_ntm_params(params))
    meta = torch.zeros(B, 3, 10, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ntm_scan_fused_bptt(tp, tcfg, meta, init_ntm_state(tp, tcfg, B))


def test_fused_bptt_routing():
    x = torch.zeros(2, 3, 10)
    # "auto": the kernels only for cuda tensors at float32 compute
    assert not use_fused_bptt("auto", x)
    assert not use_fused_bptt("auto", x, torch.bfloat16)
    assert not use_fused_bptt(False, x)
    assert use_fused_bptt(True, x, torch.float32)
    with pytest.raises(ValueError, match="True, False or 'auto'"):
        use_fused_bptt("yes", x)
    with pytest.raises(ValueError, match="float32 compute only"):
        use_fused_bptt(True, x, torch.bfloat16)
    _, tcfg, params, tokens, _ = case("flagship_shape")
    tp = ntm_params_from_flat(flatten_ntm_params(params))
    tok = torch.tensor(np.asarray(tokens))
    with pytest.raises(ValueError, match="True, False or 'auto'"):
        ntm_tracker_unroll(tp, tcfg, tok, fused_bptt="fused")
    with pytest.raises(ValueError, match="float32 compute only"):
        ntm_tracker_unroll(tp, tcfg, tok, fused_bptt=True, compute_dtype=torch.bfloat16)
    # on the CPU "auto" is the plain loop, bit for bit
    _, lo_auto, fin_auto = ntm_tracker_unroll(tp, tcfg, tok, fused_bptt="auto")
    _, lo_plain, fin_plain = ntm_tracker_unroll(tp, tcfg, tok, fused_bptt=False)
    assert torch.equal(lo_auto, lo_plain) and torch.equal(fin_auto["M"], fin_plain["M"])


def test_reduction_chunks_are_a_function_of_the_shape():
    for M, K, J in [(1, 0, 1), (7, 10, 3), (332_800, 794, 800), (332_800, 200, 170), (332_800, 200, 2)]:
        chunks, rows = scan_bptt.reduce_chunks(M, K, J)
        assert rows % scan_bptt.REDUCE_ROWS == 0 and chunks * rows >= M > (chunks - 1) * rows
        assert (chunks, rows) == scan_bptt.reduce_chunks(M, K, J)
    rs = np.random.RandomState(0)
    A, G = torch.tensor(rs.randn(9, 6).astype(np.float32)), torch.tensor(rs.randn(9, 4).astype(np.float32))
    out = scan_bptt.grad_reduce_reference(A, G, 5)
    np.testing.assert_allclose(out.numpy(), np.concatenate([A.numpy()[:, :5].T @ G.numpy(), G.numpy().sum(0)[None]]),
                               rtol=1e-5, atol=1e-6)


def test_kernel_source_builds_without_pytorch_headers():
    src = (_build.CSRC / "scan_bptt.cu").read_text()
    assert "torch/extension.h" not in src and "#include <torch" not in src
    assert '#include "ntm_step.cuh"' in src and '#include "ntm_step.cuh"' in (_build.CSRC / "scan_cell.cu").read_text()
    for fn in ("ntm_bptt_fwd_launch", "ntm_bptt_bwd_launch", "ntm_grad_reduce_launch", "ntm_bptt_smem_bytes"):
        assert f'extern "C" int {fn}' in src
    # no float atomics in the gradient path
    assert "atomicAdd" not in src and "atomicAdd" not in (_build.CSRC / "ntm_step.cuh").read_text()
    path = _build.library_path("scan_bptt")
    assert path.parent.parent == _build.BUILD_ROOT and path.name == "libscan_bptt.so"
