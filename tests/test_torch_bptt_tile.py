"""The training kernels' tiled design (ops/kernels/scan_bptt.py and
csrc/scan_bptt.cu) on the CPU: the hoisted token projection against the
JAX package's LSTM gates; the autograd Function with its launches replaced
by plain stand-ins, against jax.grad of the JAX package's fused BPTT
kernel in interpret mode: one projection per step, launched in the forward
and handed to the backward, and no dtokens unless the tokens need a
gradient; the reduction's row chunks; the backward's tile rule; the kernel
source. The CUDA kernels are held against their plain versions on the
card by chip_smoke.py."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntm_tracker_tpu.ops.lstm import lstm_cell_step as jax_lstm_cell_step
from ntm_tracker_tpu.ops.pallas.scan_bptt import ntm_scan_fused_bptt as jax_fused_bptt
from ntm_tracker_tpu_torch import _build
from ntm_tracker_tpu_torch.interop import flatten_ntm_params, ntm_params_from_flat
from ntm_tracker_tpu_torch.models.ntm_cell import head_param_sizes, init_ntm_state, ntm_cell_step
from ntm_tracker_tpu_torch.ops.kernels import scan_bptt
from ntm_tracker_tpu_torch.ops.kernels.scan_cell import flatten_scan_args, flatten_state, unflatten_state

from tests.pallas_harness import B, CONFIGS, IN, setup_case
from tests.torch_grad_parity import assert_grads, jax_value_and_grad, port_cfg, port_loss, torch_cot

# one token projection plus the recurrent product against one product of
# the whole layer input: float32 sums over IN + R*D + Hc terms in two
# groupings
GATES_RTOL = 1e-6


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_token_projection_plus_recurrent_part_gives_the_jax_gates(name):
    jcfg = CONFIGS[name]
    params, state, tokens, _ = setup_case(jcfg, seed=21)
    layer = params["controller"][0]
    x = np.asarray(tokens[:, 2])
    read = np.random.RandomState(5).uniform(-1, 1, (B, jcfg.read_head_size * jcfg.mem_dim)).astype(np.float32)
    c, h = (np.asarray(a) for a in state["controller_state"][0])
    h = h + np.float32(0.3)  # a nonzero recurrent input

    # the JAX package's gates on [x; r; h], and its new (c, h)
    kernel, bias = np.asarray(layer["kernel"]), np.asarray(layer["bias"])
    j_gates = np.asarray(jnp.concatenate([x, read, h], axis=1) @ layer["kernel"] + layer["bias"])
    _, (j_c, j_h) = jax_lstm_cell_step(layer, jnp.concatenate([x, read], axis=1), (jnp.asarray(c), jnp.asarray(h)))

    # the port's hoisted route: the projection of the tokens over all steps,
    # then [r; h] W0[IN:] per step
    proj = scan_bptt.token_projection_reference(torch.tensor(np.asarray(tokens)), torch.tensor(kernel),
                                                torch.tensor(bias)).reshape(B, -1, kernel.shape[1])
    gates = proj[:, 2] + torch.tensor(np.concatenate([read, h], axis=1)) @ torch.tensor(kernel[IN:])
    scale = np.abs(j_gates).max()
    np.testing.assert_allclose(gates.numpy(), j_gates, rtol=GATES_RTOL, atol=GATES_RTOL * scale)
    i_, j_, f_, o_ = torch.chunk(gates, 4, dim=1)
    new_c = torch.tensor(c) * torch.sigmoid(f_) + torch.sigmoid(i_) * torch.tanh(j_)
    new_h = torch.tanh(new_c) * torch.sigmoid(o_)
    np.testing.assert_allclose(new_c.numpy(), np.asarray(j_c), rtol=GATES_RTOL, atol=GATES_RTOL)
    np.testing.assert_allclose(new_h.numpy(), np.asarray(j_h), rtol=GATES_RTOL, atol=GATES_RTOL)


# ---- plain CPU stand-ins for the launches of _ScanBPTT -------------------------

def plain_token_projection(tokens, kernel, bias):
    """token_projection's plain version; records each projection it makes."""
    out = scan_bptt.token_projection_reference(tokens, kernel, bias)
    plain_token_projection.made.append(out)
    return out


def plain_bptt_forward(params, cfg, tokens, state, proj, rows_per_block=None):
    """bptt_forward's plain version (logits, final, residuals: each step's
    input state); records the projection it was handed."""
    plain_bptt_forward.projs.append(proj)
    return scan_bptt.bptt_forward_reference(params, cfg, tokens, state, proj)


def plain_bptt_backward(params, cfg, tokens, proj, res, dlogits, dfinal, need_dtokens=True, rows_per_block=None):
    """bptt_backward's outputs by autograd of the plain cell step from the
    residual initial state, in the kernel's layout (dctl: the head-control
    cotangents, then the logits'). Each step's LSTM biases and head bias
    carry a zero probe [B, width], so the gradients of the probes are the
    gate and head-control cotangents. Checks that proj is the token
    projection of these tokens; records need_dtokens in `calls` and the
    projection it was handed in `projs`."""
    layer = params["controller"][0]
    torch.testing.assert_close(proj, scan_bptt.token_projection_reference(tokens, layer["kernel"], layer["bias"]),
                               rtol=0, atol=0)
    plain_bptt_backward.calls.append(need_dtokens)
    plain_bptt_backward.projs.append(proj)
    with torch.enable_grad():  # an autograd Function's backward runs without it
        return _plain_bptt_backward(params, cfg, tokens, res, dlogits, dfinal, need_dtokens)


def _plain_bptt_backward(params, cfg, tokens, res, dlogits, dfinal, need_dtokens):
    Bn, T, _ = tokens.shape
    L, Hc, R, D = cfg.controller_num_layers, cfg.controller_hidden_size, cfg.read_head_size, cfg.mem_dim
    P = sum(head_param_sizes(cfg).values())
    KM = -(-max(tokens.shape[2] + R * D + Hc, 2 * Hc) // 4) * 4
    M0, w0, read0, c0, h0 = (r[:, 0].detach().clone() for r in res)
    leaves = [M0, w0, read0.reshape(Bn, R, D), *[c0[:, l].clone() for l in range(L)],
              *[h0[:, l].clone() for l in range(L)]]
    for t in leaves:
        t.requires_grad_()
    tok = tokens.detach().clone().requires_grad_(need_dtokens)
    state = unflatten_state(leaves, L)
    loss, li, ctrl, probes = 0.0, [], [], []
    for t in range(T):
        zs = [torch.zeros(Bn, 4 * Hc, requires_grad=True) for _ in range(L)]
        y = torch.zeros(Bn, P, requires_grad=True)
        p_t = dict(params, heads_b=params["heads_b"] + y,
                   controller=[dict(layer, bias=layer["bias"] + z) for layer, z in zip(params["controller"], zs)])
        _, logit, new = ntm_cell_step(p_t, cfg, tok[:, t], state)
        hs_prev = [h for _, h in state["controller_state"]]
        hs_new = [h for _, h in new["controller_state"]]
        li.append([torch.cat([tok[:, t], state["read"].flatten(1), hs_prev[0]], 1)]
                  + [torch.cat([hs_new[l - 1], hs_prev[l]], 1) for l in range(1, L)])
        ctrl.append(hs_new[-1])
        probes.append((zs, y))
        loss = loss + (logit * dlogits[:, t]).sum()
        state = new
    loss = loss + sum((a * b).sum() for a, b in zip(flatten_state(state), flatten_state(dfinal)))
    wrt = leaves + [z for zs, _ in probes for z in zs] + [y for _, y in probes] + ([tok] if need_dtokens else [])
    grads = list(torch.autograd.grad(loss, wrt))
    dstate0 = unflatten_state(grads[:3 + 2 * L], L)
    dz = grads[3 + 2 * L:3 + 2 * L + T * L]
    dy = grads[3 + 2 * L + T * L:3 + 2 * L + T * L + T]

    def rows(per_step):  # [T][B, K] -> [B*T, K], row b*T + t
        return torch.stack(per_step, 1).reshape(Bn * T, -1).detach()

    li_ops = torch.zeros(L, Bn * T, KM)
    for l in range(L):
        v = rows([li[t][l] for t in range(T)])
        li_ops[l, :, :v.shape[1]] = v
    dgates = torch.stack([rows([dz[t * L + l] for t in range(T)]) for l in range(L)])
    dtokens = grads[-1] if need_dtokens else None
    dctl = torch.cat([rows(list(dy)), dlogits.reshape(Bn * T, -1)], 1)
    return dtokens, dstate0, (li_ops, dgates, rows(ctrl), dctl)


@pytest.fixture
def stand_ins(monkeypatch):
    plain_token_projection.made = []
    plain_bptt_forward.projs = []
    plain_bptt_backward.calls, plain_bptt_backward.projs = [], []
    monkeypatch.setattr(scan_bptt, "token_projection", plain_token_projection)
    monkeypatch.setattr(scan_bptt, "bptt_forward", plain_bptt_forward)
    monkeypatch.setattr(scan_bptt, "bptt_backward", plain_bptt_backward)
    monkeypatch.setattr(scan_bptt, "grad_reduce", scan_bptt.grad_reduce_reference)
    return plain_bptt_backward.calls


def function_route(params, tcfg, tokens, state):
    """T steps through _ScanBPTT, the CUDA route's autograd Function."""
    L = tcfg.controller_num_layers
    logits, *final = scan_bptt._ScanBPTT.apply(tcfg, L, None, None, tokens, *flatten_scan_args(params, state))
    return logits, unflatten_state(final, L)


@pytest.mark.parametrize("name", ["flagship_shape", "two_layer_two_write_s2_wf"])
def test_function_computes_dtokens_only_when_the_tokens_need_them(name, stand_ins):
    jcfg = CONFIGS[name]
    tcfg = port_cfg(jcfg)
    params, _state, tokens, cot = setup_case(jcfg, seed=31)
    _, g_ref = jax_value_and_grad(lambda p, t, s: jax_fused_bptt(p, jcfg, t, s, interpret=True),
                                  jcfg, params, tokens, cot)

    tp = ntm_params_from_flat(flatten_ntm_params(params))
    names = list(flatten_ntm_params(params))
    leaves = [tp["controller"][int(n[11:n.index("]")])][n.split(".")[-1]] if n.startswith("controller[") else tp[n]
              for n in names]
    for t in leaves:
        t.requires_grad_()
    loss = port_loss(function_route, tcfg, torch_cot(cot))

    # tokens that need no gradient (the training path's cached features)
    tok = torch.tensor(np.asarray(tokens))
    value, _, _ = loss(tp, tok)
    value.backward()
    assert stand_ins == [False] and tok.grad is None
    got = {n: t.grad.numpy() for n, t in zip(names, leaves)}
    assert_grads(got, {n: g_ref[n] for n in names})

    # tokens that need one: dtokens as JAX's
    for t in leaves:
        t.grad = None
    tok = torch.tensor(np.asarray(tokens)).requires_grad_()
    value, _, _ = loss(tp, tok)
    grads = torch.autograd.grad(value, leaves + [tok])
    assert stand_ins == [False, True]
    got = {n: g.numpy() for n, g in zip(names + ["tokens"], grads)}
    assert_grads(got, g_ref)


@pytest.mark.parametrize("name", ["flagship_shape", "slotwise"])
def test_function_projects_once_in_the_forward_and_hands_the_backward_that_tensor(name, stand_ins):
    jcfg = CONFIGS[name]
    tcfg = port_cfg(jcfg)
    params, _state, tokens, cot = setup_case(jcfg, seed=41)
    _, g_ref = jax_value_and_grad(lambda p, t, s: jax_fused_bptt(p, jcfg, t, s, interpret=True),
                                  jcfg, params, tokens, cot)
    tp = ntm_params_from_flat(flatten_ntm_params(params))
    names = list(flatten_ntm_params(params))
    leaves = [tp["controller"][int(n[11:n.index("]")])][n.split(".")[-1]] if n.startswith("controller[") else tp[n]
              for n in names]
    for t in leaves:
        t.requires_grad_()
    tok = torch.tensor(np.asarray(tokens)).requires_grad_()
    value, _, _ = port_loss(function_route, tcfg, torch_cot(cot))(tp, tok)

    # the forward made the step's one projection and read it
    made = plain_token_projection.made
    assert len(made) == 1 and len(plain_bptt_forward.projs) == 1 and plain_bptt_forward.projs[0] is made[0]
    assert plain_bptt_backward.projs == []
    grads = torch.autograd.grad(value, leaves + [tok])
    # the backward launched no projection of its own: it read the forward's
    assert len(plain_token_projection.made) == 1
    assert len(plain_bptt_backward.projs) == 1 and plain_bptt_backward.projs[0] is made[0]
    assert stand_ins == [True]
    assert_grads({n: g.numpy() for n, g in zip(names + ["tokens"], grads)}, g_ref)


# ---- the reduction's row chunks --------------------------------------------------

TRAIN_SHAPES = [(332_800, 794, 800), (332_800, 200, 170), (332_800, 200, 2)]


@pytest.mark.parametrize("M,K,J", [(1, 0, 1), (7, 10, 3), (1300, 794, 800), (4550, 200, 170)] + TRAIN_SHAPES)
def test_reduction_chunks_cover_every_row_once(M, K, J):
    chunks, rows = scan_bptt.reduce_chunks(M, K, J)
    assert rows % scan_bptt.REDUCE_ROWS == 0
    # chunk c covers rows [c*rows, min(M, (c+1)*rows)): every row once, none empty
    covered = np.zeros(M, np.int64)
    for c in range(chunks):
        covered[c * rows:min(M, (c + 1) * rows)] += 1
    assert (covered == 1).all() and (chunks - 1) * rows < M
    # a function of the shape (and the SM count) only
    assert scan_bptt.reduce_chunks(M, K, J) == (chunks, rows)
    assert scan_bptt.reduce_chunks(M, K, J, sms=scan_bptt.H100_SMS) == (chunks, rows)


@pytest.mark.parametrize("M,K,J", TRAIN_SHAPES)
def test_reduction_fills_whole_waves_at_the_train_shapes(M, K, J):
    chunks, rows = scan_bptt.reduce_chunks(M, K, J)
    slots = scan_bptt.H100_SMS * scan_bptt.GEMM_TILES[scan_bptt.gemm_tile(K + 1, J)]
    assert scan_bptt.wave_fill(scan_bptt.gemm_tiles(K + 1, J) * chunks, slots) >= scan_bptt.MIN_WAVE_FILL
    assert rows >= scan_bptt.MIN_CHUNK_ROWS


def test_gemm_tile_pads_least():
    def padded(rows, cols, t):
        return -(-rows // t[0]) * t[0] * -(-cols // t[1]) * t[1]

    # layer 0's 795 x 800 outputs and the projection's: no tile pads them by more than 1%
    for rows, cols in [(795, 800), (332_800, 800)]:
        assert padded(rows, cols, scan_bptt.gemm_tile(rows, cols)) <= 1.01 * rows * cols
    for rows, cols in [(795, 800), (201, 172), (201, 170), (201, 2), (332_800, 800), (5, 5)]:
        t = scan_bptt.gemm_tile(rows, cols)
        assert all(padded(rows, cols, t) <= padded(rows, cols, u) for u in scan_bptt.GEMM_TILES)
        assert scan_bptt.gemm_tiles(rows, cols) * t[0] * t[1] == padded(rows, cols, t)


# ---- the backward's tile rule -------------------------------------------------------

def test_backward_rows_from_batch_and_sm_count():
    fits = lambda rows: True  # noqa: E731
    assert scan_bptt.backward_rows(1, None, fits, 132) == 1
    assert scan_bptt.backward_rows(132, None, fits, 132) == 1
    assert scan_bptt.backward_rows(133, None, fits, 132) == 2
    assert scan_bptt.backward_rows(256, None, fits, 132) == 2
    assert scan_bptt.backward_rows(256, 1, fits, 132) == 1
    # a config where two rows do not fit: the rule falls back to one
    assert scan_bptt.backward_rows(256, None, lambda rows: rows == 1, 132) == 1


def test_backward_rows_raise_for_a_tile_that_does_not_fit():
    with pytest.raises(ValueError, match="do not fit"):
        scan_bptt.backward_rows(256, 2, lambda rows: rows == 1, 132)
    with pytest.raises(ValueError, match="rows_per_block in"):
        scan_bptt.backward_rows(256, 3, lambda rows: True, 132)
    with pytest.raises(ValueError, match="does not fit"):
        scan_bptt.backward_rows(8, None, lambda rows: False, 132)


# ---- the kernel source -----------------------------------------------------------------

def test_bptt_source_is_plain_c_with_no_float_atomics():
    src = (_build.CSRC / "scan_bptt.cu").read_text()
    assert "torch/extension.h" not in src and "#include <torch" not in src and "ATen" not in src
    for fn in ("ntm_bptt_fwd_launch", "ntm_bptt_bwd_launch", "ntm_token_proj_launch", "ntm_grad_reduce_launch",
               "ntm_bptt_smem_bytes"):
        assert f'extern "C" int {fn}' in src
    # the train route's forward is the tiled kernel with residuals at every
    # instantiated tile, B1's tile route the same kernel without them; the
    # old one-row loop (ntm_scan_kernel) is gone
    for rows in scan_bptt.FORWARD_ROWS:
        assert f"launch_tiles(ntm_bptt_fwd_kernel<{rows}, true>" in src
        assert f"launch_tiles(ntm_bptt_fwd_kernel<{rows}, false>" in src
    for rows in scan_bptt.BACKWARD_ROWS:
        assert f"launch_tiles(ntm_bptt_bwd_kernel<{rows}>" in src
    assert "ntm_scan_kernel" not in src and "launch_scan" not in src
    # both recurrences run one tile step, so the recompute's gates are the
    # forward's (the forward's bf16 switch is B1's tile route alone)
    assert "tile_step<RT, true, kBf16>" in src and "tile_step<RT, false>" in src
    for text in (src, (_build.CSRC / "ntm_step.cuh").read_text()):
        assert not re.search(r"\batomic\w*\s*\(", text)  # no atomicAdd, atomicCAS, ...
    # f32 only: no tensor-core (TF32) instruction in the GEMMs
    assert not re.search(r"\bw?mma[.:_ ]|\.tf32", src)
