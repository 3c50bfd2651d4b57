"""The lane-packed kernels' design (csrc/scan_packed.cu, ops/kernels/
scan_packed.py) on the CPU: the plain emulation of how the kernels split a
step, tests/packed_split.py's `packed_split_reference` (the token projection plus the recurrent
[read | h] product, the addressing's runs of slots over a tile of rows,
the shift's shuffle plan, the write and the read as warp sums), against the JAX package's ntm_scan_packed and
ntm_scan_packed_bptt in interpret mode (as tests/test_pallas_packed.py
runs them), forward and gradients; the autograd Function with its launches
replaced by plain stand-ins: one projection, made in the forward and
handed to the backward, dtokens only when the tokens need a gradient, and
the weight gradients from li's padded rows; the shuffle plan for the
shift's offsets and their negation; the tile rule; the shared-memory
mirror, with the scratch the lane-per-slot phases add past 256 slots. The
CUDA kernels are held against their plain version on the card by
chip_smoke.py."""

import functools
import math
import re

import numpy as np
import pytest
import torch

from ntm_tracker_tpu.config import NTMConfig as JNTMConfig
from ntm_tracker_tpu.models.ntm_cell import init_ntm_state as jinit_state
from ntm_tracker_tpu.ops.pallas.scan_packed import ntm_scan_packed as jax_packed
from ntm_tracker_tpu.ops.pallas.scan_packed import ntm_scan_packed_bptt as jax_packed_bptt
from ntm_tracker_tpu_torch import _build
from ntm_tracker_tpu_torch.config import NTMConfig
from ntm_tracker_tpu_torch.interop import flatten_ntm_params, ntm_params_from_flat
from ntm_tracker_tpu_torch.models.ntm_cell import init_ntm_params, init_ntm_state
from ntm_tracker_tpu_torch.ops.kernels import scan_bptt, scan_packed
from ntm_tracker_tpu_torch.ops.kernels.addressing import addr_run, addr_stride
from ntm_tracker_tpu_torch.ops.kernels.scan_cell import MAX_SMEM_BYTES, flatten_scan_args, unflatten_state
from ntm_tracker_tpu_torch.ops.memory import circular_convolution_shifts

from tests.packed_split import packed_split_reference, shifted_source
from tests.pallas_harness import B, CONFIGS, setup_case
from tests.test_torch_bptt_tile import _plain_bptt_backward
from tests.torch_grad_parity import (
    assert_grads,
    jax_value_and_grad,
    port_cfg,
    port_loss,
    port_value_and_grad,
    torch_cot,
)

# tests/test_pallas_addressing.py's bound for a kernel against the jnp math
# (tests/test_torch_addressing_design.py holds B3's emulation to it): the
# emulation sums in the kernels' orders, JAX's kernel in its own
SPLIT_ATOL = 2e-6
SOURCE = _build.CSRC / "scan_packed.cu"

# the harness's configs (slotwise; write-first with two write heads and
# two layers at S = 5), two whose memory the chains' runs do not divide:
# N = 33 (runs of 2, the shift's three wrap classes) and N = 70 (runs of 4),
# and a shift wider than memory (S = 5 over N = 3: its offsets wrap mod N)
EXTRA = {
    "n33_s5_write_first": JNTMConfig(output_dim=2, mem_size=33, mem_dim=8, controller_hidden_size=16,
                                     controller_num_layers=1, read_head_size=2, write_head_size=1,
                                     shift_range=2, write_first=True),
    "n70_slotwise": JNTMConfig(output_dim=2, mem_size=70, mem_dim=6, controller_hidden_size=16,
                               controller_num_layers=1, read_head_size=2, write_head_size=1,
                               slotwise_cosine=True),
    "n3_s5": JNTMConfig(output_dim=2, mem_size=3, mem_dim=6, controller_hidden_size=16, controller_num_layers=1,
                        read_head_size=2, write_head_size=1, shift_range=2),
}
ALL = {**CONFIGS, **EXTRA}


@functools.lru_cache(maxsize=None)
def jax_case(name):
    """(JAX config, port config, params, tokens, cotangents, JAX's packed
    forward (logits, final state), (value, grads) of JAX's packed BPTT),
    all in interpret mode, once per config."""
    jcfg = ALL[name]
    params, _state, tokens, cot = setup_case(jcfg, seed=50 + sorted(ALL).index(name))
    fwd = jax_packed(params, jcfg, tokens, jinit_state(params, jcfg, B), interpret=True)
    vg = jax_value_and_grad(lambda p, t, s: jax_packed_bptt(p, jcfg, t, s, interpret=True), jcfg, params, tokens, cot)
    return jcfg, port_cfg(jcfg), params, tokens, cot, fwd, vg


def split_scan(rows):
    return lambda p, c, t, s: packed_split_reference(p, c, t, s, rows=rows)


@pytest.mark.parametrize("rows", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(ALL))
def test_split_forward_matches_jax_packed(name, rows):
    _, tcfg, params, tokens, _, (jlogits, jfinal), _ = jax_case(name)
    tp = ntm_params_from_flat(flatten_ntm_params(params))
    with torch.no_grad():
        logits, final = packed_split_reference(tp, tcfg, torch.tensor(np.asarray(tokens)), init_ntm_state(tp, tcfg, B),
                                               rows=rows)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=SPLIT_ATOL)
    for key in ("M", "w", "read"):
        np.testing.assert_allclose(final[key].numpy(), np.asarray(jfinal[key]), atol=SPLIT_ATOL, err_msg=key)
    for (c, h), (jc, jh) in zip(final["controller_state"], jfinal["controller_state"]):
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=SPLIT_ATOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=SPLIT_ATOL)


@pytest.mark.parametrize("name", sorted(ALL))
def test_split_gradients_match_jax_packed_bptt(name):
    _, tcfg, params, tokens, cot, _, (v_ref, g_ref) = jax_case(name)
    value, _, _, grads = port_value_and_grad(split_scan(2), tcfg, params, tokens, cot)
    np.testing.assert_allclose(value, v_ref, rtol=1e-5)
    assert_grads(grads, g_ref)


@pytest.mark.parametrize("N", [1, 3, 16, 31, 32, 33, 63, 64, 65, 70, 100, 128, 129, 196, 255, 256])
def test_shift_plan_reads_the_offsets_and_their_negation(N):
    # the forward shift reads slot (n + s_j) mod N for the Python-2 offsets
    # s_j, its VJP slot (n - s_j) mod N: every (lane, slot of its run) by
    # the plan's source lane and element, also where the shift is wider
    # than memory
    RL = addr_run(N)
    for S in (1, 3, 5, 7):
        for o in sorted({s for s in circular_convolution_shifts(S)} | {-s for s in circular_convolution_shifts(S)}):
            for lane in range(32):
                for i in range(RL):
                    n = lane * RL + i
                    if n >= N:
                        continue
                    src, e = shifted_source(N, o, lane, i)
                    assert 0 <= e < RL and src * RL + e == (n + o) % N


# ---- the autograd Function with plain stand-ins for its launches ---------------------

def plain_projection(tokens, kernel, bias):
    """token_projection's plain version; records each projection it makes."""
    out = scan_bptt.token_projection_reference(tokens, kernel, bias)
    plain_projection.made.append(out)
    return out


def plain_forward_residuals(params, cfg, tokens, state, proj, rows_per_block=None):
    """packed_forward_residuals' plain version: B2's plain forward on the
    projection, its memory residuals packed [B, T, D*N]; records the
    projection it was handed."""
    plain_forward_residuals.projs.append(proj)
    logits, final, res = scan_bptt.bptt_forward_reference(params, cfg, tokens, state, proj)
    Bn, T, N, D = res[0].shape
    return logits, final, (res[0].transpose(2, 3).reshape(Bn, T, D * N), *res[1:])


def plain_backward(params, cfg, tokens, proj, res, dlogits, dfinal, need_dtokens=True, rows_per_block=None):
    """packed_backward's outputs by autograd of the plain cell step from
    the residual initial state (tests/test_torch_bptt_tile.py's stand-in),
    in the kernel's layout: li's rows padded to 16 bytes, the padding
    filled with NaN (the reduction must not read it). Checks that proj is
    the projection of these tokens; records need_dtokens and proj."""
    layer = params["controller"][0]
    torch.testing.assert_close(proj, scan_bptt.token_projection_reference(tokens, layer["kernel"], layer["bias"]),
                               rtol=0, atol=0)
    plain_backward.calls.append(need_dtokens)
    plain_backward.projs.append(proj)
    Bn, T, _ = res[0].shape
    N, D = cfg.mem_size, cfg.mem_dim
    res = (res[0].reshape(Bn, T, D, N).transpose(2, 3), *res[1:])
    with torch.enable_grad():  # an autograd Function's backward runs without it
        dtokens, dstate0, (li, dgates, ctrl, dctl) = _plain_bptt_backward(
            params, cfg, tokens, res, dlogits, dfinal, need_dtokens)
    kin = tokens.shape[2] + cfg.read_head_size * D + cfg.controller_hidden_size
    li[..., kin:] = float("nan")
    return dtokens, dstate0, (li, dgates, ctrl, dctl)


@pytest.fixture
def stand_ins(monkeypatch):
    plain_projection.made = []
    plain_forward_residuals.projs = []
    plain_backward.calls, plain_backward.projs = [], []
    monkeypatch.setattr(scan_bptt, "token_projection", plain_projection)
    monkeypatch.setattr(scan_packed, "packed_forward_residuals", plain_forward_residuals)
    monkeypatch.setattr(scan_packed, "packed_backward", plain_backward)
    monkeypatch.setattr(scan_bptt, "grad_reduce", scan_bptt.grad_reduce_reference)
    return plain_backward.calls


def function_route(params, tcfg, tokens, state):
    """T steps through _PackedBPTT, the CUDA route's autograd Function."""
    L = tcfg.controller_num_layers
    logits, *final = scan_packed._PackedBPTT.apply(tcfg, L, None, None, tokens, *flatten_scan_args(params, state))
    return logits, unflatten_state(final, L)


def port_leaves(params):
    tp = ntm_params_from_flat(flatten_ntm_params(params))
    names = list(flatten_ntm_params(params))
    leaves = [tp["controller"][int(n[11:n.index("]")])][n.split(".")[-1]] if n.startswith("controller[") else tp[n]
              for n in names]
    for t in leaves:
        t.requires_grad_()
    return tp, names, leaves


@pytest.mark.parametrize("name", ["flagship_shape", "two_layer_two_write_s2_wf"])
def test_function_computes_dtokens_only_when_the_tokens_need_them(name, stand_ins):
    _, tcfg, params, tokens, cot, _, (_, g_ref) = jax_case(name)
    tp, names, leaves = port_leaves(params)
    loss = port_loss(function_route, tcfg, torch_cot(cot))

    # tokens that need no gradient (the training path's cached features)
    tok = torch.tensor(np.asarray(tokens))
    value, _, _ = loss(tp, tok)
    value.backward()
    assert stand_ins == [False] and tok.grad is None
    assert_grads({n: t.grad.numpy() for n, t in zip(names, leaves)}, {n: g_ref[n] for n in names})

    # tokens that need one: dtokens as JAX's
    for t in leaves:
        t.grad = None
    tok = torch.tensor(np.asarray(tokens)).requires_grad_()
    value, _, _ = loss(tp, tok)
    grads = torch.autograd.grad(value, leaves + [tok])
    assert stand_ins == [False, True]
    assert_grads({n: g.numpy() for n, g in zip(names + ["tokens"], grads)}, g_ref)


@pytest.mark.parametrize("name", ["flagship_shape", "slotwise"])
def test_function_projects_once_in_the_forward_and_hands_the_backward_that_tensor(name, stand_ins):
    _, tcfg, params, tokens, cot, _, (_, g_ref) = jax_case(name)
    tp, names, leaves = port_leaves(params)
    tok = torch.tensor(np.asarray(tokens)).requires_grad_()
    value, _, _ = port_loss(function_route, tcfg, torch_cot(cot))(tp, tok)

    # the forward made the step's one projection and read it
    made = plain_projection.made
    assert len(made) == 1 and len(plain_forward_residuals.projs) == 1 and plain_forward_residuals.projs[0] is made[0]
    assert plain_backward.projs == []
    grads = torch.autograd.grad(value, leaves + [tok])
    # the backward launched no projection of its own: it read the forward's
    assert len(plain_projection.made) == 1
    assert len(plain_backward.projs) == 1 and plain_backward.projs[0] is made[0]
    assert stand_ins == [True]
    assert_grads({n: g.numpy() for n, g in zip(names + ["tokens"], grads)}, g_ref)


@pytest.mark.parametrize("name", ["flagship_shape", "two_layer_two_write_s2_wf"])
def test_weight_grads_on_padded_li_give_the_jax_gradients(name, monkeypatch):
    # the backward's operands with li's rows padded to 16 bytes (NaN in the
    # padding) reduce to JAX's weight gradients
    _, tcfg, params, tokens, cot, _, (_, g_ref) = jax_case(name)
    monkeypatch.setattr(scan_bptt, "grad_reduce", scan_bptt.grad_reduce_reference)
    plain_backward.calls, plain_backward.projs = [], []
    plain_forward_residuals.projs = []
    tp = ntm_params_from_flat(flatten_ntm_params(params))
    tok = torch.tensor(np.asarray(tokens))
    layer0 = tp["controller"][0]
    proj = scan_bptt.token_projection_reference(tok, layer0["kernel"], layer0["bias"])
    state = init_ntm_state(tp, tcfg, B)
    with torch.no_grad():
        logits, final, res = plain_forward_residuals(tp, tcfg, tok, state, proj)
    A, BM, Bw, Br, Bc = torch_cot(cot)
    dfinal = {"M": BM, "w": Bw, "read": Br, "controller_state": [(Bc, 0.5 * Bc)] * tcfg.controller_num_layers}
    _, _, operands = plain_backward(tp, tcfg, tok, proj, res, A, dfinal, need_dtokens=False)
    li = operands[0]
    IN, kin = tok.shape[2], tok.shape[2] + tcfg.read_head_size * tcfg.mem_dim + tcfg.controller_hidden_size
    assert li.shape[2] == math.ceil(max(kin, 2 * tcfg.controller_hidden_size) / 4) * 4 and li.shape[2] % 4 == 0
    assert torch.isnan(li[..., kin:]).all()
    got = scan_bptt.weight_grads(tcfg, IN, operands)
    L = tcfg.controller_num_layers
    names = ([f"controller[{l}].kernel" for l in range(L)] + [f"controller[{l}].bias" for l in range(L)]
             + ["heads_w", "heads_b", "out_w", "out_b"])
    assert_grads({n: g.numpy() for n, g in zip(names, got)}, {n: g_ref[n] for n in names})


# ---- the tile rule and the shared memory -------------------------------------------

# (B, SMs) -> (forward rows, backward rows) at the flagship config: the
# fewest waves, then the fewest rows (4 backward rows do not fit)
TILE_CASES = {
    (1, 132): (1, 1), (64, 132): (1, 1), (132, 132): (1, 1), (133, 132): (2, 2), (256, 132): (2, 2),
    (264, 132): (2, 2), (265, 132): (3, 3), (396, 132): (3, 3), (397, 132): (4, 2), (512, 132): (4, 2),
    (1000, 132): (4, 3), (256, 64): (4, 2), (17, 16): (2, 2),
}


@pytest.mark.parametrize("B_sms", list(TILE_CASES), ids=lambda c: f"B{c[0]}_sms{c[1]}")
def test_tile_rule_from_batch_and_sm_count(B_sms):
    B_, sms = B_sms
    cfg = NTMConfig()
    got = tuple(scan_packed.tile_rows(B_, None, lambda r, bwd=bwd: scan_packed.packed_smem_bytes(cfg, 514, bwd, r)
                                      <= MAX_SMEM_BYTES, sms, bwd) for bwd in (False, True))
    assert got == TILE_CASES[B_sms]


def test_explicit_tiles_must_be_instantiated_and_fit():
    fits_two = lambda rows: rows <= 2  # noqa: E731
    assert scan_packed.tile_rows(256, 1, fits_two, 132, True) == 1
    assert scan_packed.tile_rows(512, None, fits_two, 132, False) == 2  # the largest that fits
    assert scan_packed.tile_rows(512, None, lambda rows: rows == 1, 132, True) == 1
    with pytest.raises(ValueError, match="shared memory"):
        scan_packed.tile_rows(256, 3, fits_two, 132, False)
    with pytest.raises(ValueError, match="shared memory"):
        scan_packed.tile_rows(8, None, lambda rows: False, 132, True)
    for rows, backward in ((5, False), (4, True), (0, False)):
        with pytest.raises(ValueError, match="rows_per_block in"):
            scan_packed.tile_rows(256, rows, lambda r: True, 132, backward)


def test_shared_memory_mirror_gives_the_flagship_bytes():
    # a forward row at the flagship: the memory 20 x 132, the weights 5 x 132,
    # read 80, c and h 200 each, the gates 800, 170 controls (172: each
    # array starts on 16 bytes), tanh(k) 5 x 20, the normalizer and its sums
    # 20 each, |k|^2 5 (8), 4 x 5 scalars, the denominators 5 (8), the shift
    # weights 15 (16), erase and add 20 each: 4,984 floats; the tile's input
    # [read | h] or [h | h] 400 floats a row. A backward row adds the
    # chains' four [5][132] arrays, the slotwise normalizer and sums 132
    # each, the new c 200, dw 5 x 132, dM and d M_prev 20 x 132 each, d
    # controls 172, dread 80, dc, dh and d ctrl 200 each, d logits 2 (4),
    # d|k|^2 5 (8) and the token 514 (516): 15,408 floats
    cfg = NTMConfig()
    fwd = [scan_packed.packed_smem_bytes(cfg, 514, False, r) for r in scan_packed.FORWARD_ROWS]
    bwd = [scan_packed.packed_smem_bytes(cfg, 514, True, r) for r in scan_packed.BACKWARD_ROWS]
    assert fwd == [4 * (4984 + 400) * r for r in (1, 2, 3, 4)] == [21536, 43072, 64608, 86144]
    assert bwd == [4 * (15408 + 400) * r for r in (1, 2, 3)] == [63232, 126464, 189696]
    assert max(bwd) <= MAX_SMEM_BYTES < scan_packed.packed_smem_bytes(cfg, 514, True, 4)
    assert max(fwd) <= MAX_SMEM_BYTES


def test_kernel_source_instantiates_the_tiles_and_hoists_the_token_product():
    src = SOURCE.read_text()
    fwd = re.search(r"fwd_rows_ok\(int rows\) \{ return (.*?); \}", src).group(1)
    bwd = re.search(r"bwd_rows_ok\(int rows\) \{ return (.*?); \}", src).group(1)
    assert sorted(int(v) for v in re.findall(r"rows == (\d+)", fwd)) == list(scan_packed.FORWARD_ROWS)
    assert sorted(int(v) for v in re.findall(r"rows == (\d+)", bwd)) == list(scan_packed.BACKWARD_ROWS)
    # layer 0's recurrent product runs over W0's rows IN.. on the projection;
    # the backward skips the token rows unless asked for dtokens
    assert "a.wt.lstm_w[l] + (l == 0 ? (size_t)IN * G4 : 0)" in src
    assert "a.proj[bt_of(r) * G4 + j]" in src
    assert "(l == 0 && !a.need_dtokens) ? IN : 0" in src
    # the sharpen in powf, as scan_bptt.cu has it (exp2f of gamma * log2f
    # cost the initial-state gradients an order of magnitude on the card),
    # and the VJP recomputes the forward's p with the same call, on the runs
    # and a lane per slot alike; exp2f(log2f) only in the VJP's derivative
    # factor w_conv^(gamma - 1), which the recurrence does not carry (powf
    # there measured slower and no closer to float64)
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    assert "powf(conv[i], gm)" in code and "powf(wcv[i], gam)" in code
    assert "powf(c, gm)" in code and "powf(conv[n], gm)" in code and "powf(x, gam)" in code
    assert re.findall(r"exp2f\((.*?)\)\s*:", code) == ["gm1 * log2f(wcv[i])", "gm1 * log2f(x)"]
    assert code.count("exp2f(") == 2 and code.count("log2f(") == 2


def test_packed_kernels_take_configs_beyond_the_runs(monkeypatch):
    # more than 256 slots, or a shift wider than memory: no raise before the
    # launch. Past 256 slots the phases run with a lane per slot (the
    # kernel's *_wide functions, dispatched on N > ADDR_MAX_SLOTS) and the
    # forward adds its chains' scratch, [H][Np] floats a row; the runs'
    # emulation covers N <= 256 only
    src = SOURCE.read_text()
    for fn in ("packed_chain_wide<kBwd>", "packed_write_read_wide<RT>", "vjp_write_wide", "packed_chain_vjp_wide",
               "vjp_keys_wide"):
        assert src.count(f"{fn}(dm, a.fl, ROWP(") == 1, fn
    assert src.count("N > ADDR_MAX_SLOTS)") == 5
    assert "N <= ADDR_MAX_SLOTS" not in src and "S <= N" not in src
    assert "shifted_run<RL>(wg, (shift0 + j) % N, N, v)" in src and "-(shift0 + j) % N" in src
    assert not hasattr(scan_packed, "_check_config")
    wide = NTMConfig(mem_size=300, mem_dim=4, controller_hidden_size=8)
    runs = NTMConfig(mem_size=256, mem_dim=4, controller_hidden_size=8)
    got = {c.mem_size: [scan_packed.packed_smem_floats(c, 5, bwd, 1) for bwd in (False, True)] for c in (wide, runs)}
    for bwd in (False, True):
        fits = lambda r, bwd=bwd: scan_packed.packed_smem_bytes(wide, 5, bwd, r) <= MAX_SMEM_BYTES  # noqa: E731
        assert scan_packed.tile_rows(8, None, fits, 132, bwd) == 1
    monkeypatch.setattr(scan_packed, "ADDR_MAX_SLOTS", 512)
    for c in (wide, runs):
        scratch = c.num_heads * addr_stride(c.mem_size) if c.mem_size > 256 else 0
        assert got[c.mem_size] == [scan_packed.packed_smem_floats(c, 5, False, 1) + scratch,
                                   scan_packed.packed_smem_floats(c, 5, True, 1)]
    params = init_ntm_params(wide, 5, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="runs of slots"):
        packed_split_reference(params, wide, torch.zeros(1, 2, 5), init_ntm_state(params, wide, 1))
