"""B2's forward over a tile of rows, fed by the token projection
(ops/kernels/scan_bptt.py: bptt_forward, token_projection) on the CPU: the
plain version bptt_forward_reference, fed token_projection_reference,
against the JAX package's forward with residual streams
(ntm_tracker_tpu/ops/pallas/scan_bptt.py:_fwd_call in interpret mode) on
every harness config: logits, the final state and all five residual
streams; the wrappers' CPU route; the forward's tile rule. The CUDA kernel
is held against the plain version on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntm_tracker_tpu.models.ntm_cell import init_ntm_state as jinit_state
from ntm_tracker_tpu.ops.pallas.scan_bptt import _fwd_call
from ntm_tracker_tpu_torch.interop import flatten_ntm_params, ntm_params_from_flat
from ntm_tracker_tpu_torch.models.ntm_cell import init_ntm_state
from ntm_tracker_tpu_torch.ops.kernels import scan_bptt
from ntm_tracker_tpu_torch.utils import profiling

from tests.pallas_harness import B, CONFIGS, setup_case
from tests.torch_grad_parity import FWD_TOL, port_cfg

# logits, final state and residuals against the JAX kernel: float32 over 7
# steps, layer 0's gates summed in two groups (the projection, then
# [read | h]) against one product of [x | read | h] in JAX
# (test_pallas_bptt.py's forward tolerance)
RES_TOL = FWD_TOL


def port_case(name, seed):
    jcfg = CONFIGS[name]
    params, _state, tokens, _cot = setup_case(jcfg, seed=seed)
    tp = ntm_params_from_flat(flatten_ntm_params(params))
    return jcfg, port_cfg(jcfg), params, tp, tokens


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_reference_matches_the_jax_forward_with_residuals(name):
    jcfg, tcfg, params, tp, tokens = port_case(name, seed=51)
    jlogits, jfinal, (Mh, wh, readh, ch, hh) = _fwd_call(params, jcfg, tokens, jinit_state(params, jcfg, B),
                                                         interpret=True)

    tok = torch.tensor(np.asarray(tokens))
    layer0 = tp["controller"][0]
    proj = scan_bptt.token_projection_reference(tok, layer0["kernel"], layer0["bias"])
    logits, final, res = scan_bptt.bptt_forward_reference(tp, tcfg, tok, init_ntm_state(tp, tcfg, B), proj)

    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=RES_TOL)
    for key in ("M", "w", "read"):
        np.testing.assert_allclose(final[key].numpy(), np.asarray(jfinal[key]), atol=RES_TOL, err_msg=key)
    for (c, h), (jc, jh) in zip(final["controller_state"], jfinal["controller_state"]):
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=RES_TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=RES_TOL)

    # JAX keeps the streams [T, Bp, ...] with M transposed and c, h
    # [T, L, Bp, Hc], its batch padded to the tile; the port's are
    # [B, T, ...]: M [B, T, N, D], c and h [B, T, L, Hc]
    want = (np.transpose(np.asarray(Mh)[:, :B], (1, 0, 3, 2)), np.transpose(np.asarray(wh)[:, :B], (1, 0, 2, 3)),
            np.transpose(np.asarray(readh)[:, :B], (1, 0, 2)), np.transpose(np.asarray(ch)[:, :, :B], (2, 0, 1, 3)),
            np.transpose(np.asarray(hh)[:, :, :B], (2, 0, 1, 3)))
    for stream, got, ref in zip(("M", "w", "read", "c", "h"), res, want):
        assert tuple(got.shape) == ref.shape, stream
        np.testing.assert_allclose(got.numpy(), ref, atol=RES_TOL, err_msg=f"residual stream {stream}")


def test_cpu_tensors_take_the_plain_versions_without_launches():
    _jcfg, tcfg, _params, tp, tokens = port_case("two_layer_two_write_s2_wf", seed=52)
    tok = torch.tensor(np.asarray(tokens))
    layer0 = tp["controller"][0]
    state = init_ntm_state(tp, tcfg, B)
    before = (profiling.counter("launches.token_projection"), profiling.counter("launches.bptt_forward"))
    proj = scan_bptt.token_projection(tok, layer0["kernel"], layer0["bias"])
    assert torch.equal(proj, scan_bptt.token_projection_reference(tok, layer0["kernel"], layer0["bias"]))
    logits, final, res = scan_bptt.bptt_forward(tp, tcfg, tok, state, proj)
    r_logits, r_final, r_res = scan_bptt.bptt_forward_reference(tp, tcfg, tok, state, proj)
    assert torch.equal(logits, r_logits) and torch.equal(final["M"], r_final["M"])
    assert all(torch.equal(a, b) for a, b in zip(res, r_res))
    assert (profiling.counter("launches.token_projection"), profiling.counter("launches.bptt_forward")) == before
    with pytest.raises(ValueError, match="proj has shape"):
        scan_bptt.bptt_forward(tp, tcfg, tok, state, proj[1:])
    with pytest.raises(ValueError, match="fewer than the token width"):
        scan_bptt.token_projection(tok, layer0["kernel"][:3], layer0["bias"])


def test_forward_reference_takes_the_token_part_from_proj():
    """The plain forward reads the tokens only through proj: zero tokens
    with the real tokens' projection give the real tokens' result."""
    _jcfg, tcfg, _params, tp, tokens = port_case("flagship_shape", seed=53)
    tok = torch.tensor(np.asarray(tokens))
    layer0 = tp["controller"][0]
    proj = scan_bptt.token_projection_reference(tok, layer0["kernel"], layer0["bias"])
    state = init_ntm_state(tp, tcfg, B)
    got = scan_bptt.bptt_forward_reference(tp, tcfg, torch.zeros_like(tok), state, proj)
    want = scan_bptt.bptt_forward_reference(tp, tcfg, tok, state, proj)
    assert torch.equal(got[0], want[0]) and all(torch.equal(a, b) for a, b in zip(got[2], want[2]))


# ---- the forward's tile rule ------------------------------------------------------

def test_forward_rows_from_batch_and_sm_count():
    fits = lambda rows: True  # noqa: E731
    # the fewest rows whose blocks fill the card no more than once
    assert scan_bptt.forward_rows(1, None, fits, 132) == 1
    assert scan_bptt.forward_rows(132, None, fits, 132) == 1
    assert scan_bptt.forward_rows(133, None, fits, 132) == 2
    assert scan_bptt.forward_rows(256, None, fits, 132) == 2
    assert scan_bptt.forward_rows(264, None, fits, 132) == 2
    assert scan_bptt.forward_rows(265, None, fits, 132) == 4
    assert scan_bptt.forward_rows(256, None, fits, 100) == 4
    # no tile fills the card once: the most rows that fit
    assert scan_bptt.forward_rows(1024, None, fits, 132) == 4


def test_forward_rows_honour_an_override():
    fits = lambda rows: True  # noqa: E731
    for rows in scan_bptt.FORWARD_ROWS:
        assert scan_bptt.forward_rows(256, rows, fits, 132) == rows
        assert scan_bptt.forward_rows(3, rows, fits, 132) == rows


def test_forward_rows_raise_for_a_tile_that_does_not_fit():
    with pytest.raises(ValueError, match="do not fit the forward"):
        scan_bptt.forward_rows(256, 4, lambda rows: rows < 4, 132)
    with pytest.raises(ValueError, match="rows_per_block in"):
        scan_bptt.forward_rows(256, 3, lambda rows: True, 132)
    with pytest.raises(ValueError, match="does not fit"):
        scan_bptt.forward_rows(8, None, lambda rows: False, 132)


def test_forward_rows_fall_back_to_a_smaller_tile():
    # 600 rows fill the card once only at 8 rows; 4 do not fit, so 2
    assert scan_bptt.forward_rows(600, None, lambda rows: rows < 4, 132) == 2
    # 256 rows want 2; where only one fits, 1
    assert scan_bptt.forward_rows(256, None, lambda rows: rows == 1, 132) == 1
