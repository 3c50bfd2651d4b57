"""models/ntm_tracker.py and the MemoryCore unroll on the CPU: the eager
unroll with remat "full"/"none" against the plain loop and against the
JAX package's ntm_tracker_unroll (values and jax.grad), the two-step
token stream, the streaming step, and the unroll's knobs
(tests/test_torch_scan_layout.py holds layout="dn" and remat="dots" to
JAX's)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntm_tracker_tpu.config import NTMConfig as JNTMConfig
from ntm_tracker_tpu.models.ntm_cell import init_ntm_params
from ntm_tracker_tpu.models.ntm_tracker import ntm_tracker_unroll as jax_unroll
from ntm_tracker_tpu.models.ntm_tracker import two_step_inputs as jax_two_step
from ntm_tracker_tpu_torch.config import NTMConfig, TrackerConfig, TrainConfig
from ntm_tracker_tpu_torch.interop import flatten_ntm_params, ntm_params_from_flat
from ntm_tracker_tpu_torch.models import core as core_mod
from ntm_tracker_tpu_torch.models.core import make_core
from ntm_tracker_tpu_torch.models.ntm_cell import init_ntm_state, ntm_cell_step
from ntm_tracker_tpu_torch.models.ntm_tracker import (
    init_tracker,
    make_streaming_step,
    ntm_tracker_unroll,
    two_step_inputs,
)
from ntm_tracker_tpu_torch.ops.kernels.scan_cell import ntm_scan_fused_reference

KW = dict(output_dim=2, mem_size=16, mem_dim=8, controller_hidden_size=12,
          controller_num_layers=2, read_head_size=2, write_head_size=1)
B, T, IN = 2, 9, 7
# float32, the same step math summed in other orders over 9 steps
FWD_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 3e-5, 2e-4  # tests/test_pallas_bptt.py's gradient tolerance


def _setup():
    jcfg, tcfg = JNTMConfig(**KW), NTMConfig(**KW)
    jp = init_ntm_params(jax.random.PRNGKey(3), jcfg, IN)
    tokens = np.random.RandomState(4).uniform(-1, 1, (B, T, IN)).astype(np.float32)
    return jcfg, tcfg, jp, tokens


def _torch_loss_and_grads(tcfg, jp, tokens, **kw):
    params = ntm_params_from_flat(flatten_ntm_params(jp))
    names = list(flatten_ntm_params(jp))
    leaves = [params["controller"][int(n[11:n.index("]")])][n.split(".")[-1]] if n.startswith("controller[")
              else params[n] for n in names]
    for t in leaves:
        t.requires_grad_()
    outputs, logits, final = ntm_tracker_unroll(params, tcfg, torch.tensor(tokens), **kw)
    loss = (logits ** 2).sum() + final["M"].sum() + outputs[..., 0].sum()
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), logits.detach(), final, dict(zip(names, (g.numpy() for g in grads)))


@pytest.mark.parametrize("remat", [True, "full", False, "none"])
def test_unroll_matches_jax_values_and_grads(remat):
    jcfg, tcfg, jp, tokens = _setup()

    def jloss(p):
        outputs, logits, final = jax_unroll(p, jcfg, jnp.asarray(tokens), remat=remat)
        return (logits ** 2).sum() + final["M"].sum() + outputs[..., 0].sum(), logits

    (jl, jlogits), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    loss, logits, _, grads = _torch_loss_and_grads(tcfg, jp, tokens, remat=remat)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=FWD_TOL)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for k, r in flatten_ntm_params(jg).items():
        scale = max(1e-3, float(np.abs(r).max()))
        np.testing.assert_allclose(grads[k], r, atol=GRAD_ATOL * scale, rtol=GRAD_RTOL, err_msg=k)


def test_remat_gives_the_plain_loop_bit_for_bit():
    _, tcfg, jp, tokens = _setup()
    full = _torch_loss_and_grads(tcfg, jp, tokens, remat="full")
    none = _torch_loss_and_grads(tcfg, jp, tokens, remat="none")
    assert torch.equal(full[1], none[1]) and torch.equal(full[0], none[0])
    for k in full[3]:
        np.testing.assert_array_equal(full[3][k], none[3][k], err_msg=k)
    params = ntm_params_from_flat(flatten_ntm_params(jp))
    plain, _ = ntm_scan_fused_reference(params, tcfg, torch.tensor(tokens), init_ntm_state(params, tcfg, B))
    assert torch.equal(plain, full[1])


def test_unported_knobs_raise():
    """The JAX package's knobs all run (remat "dots", layout "dn": the
    plain loop's logits within FWD_TOL); an unknown one raises."""
    _, tcfg, jp, tokens = _setup()
    params = ntm_params_from_flat(flatten_ntm_params(jp))
    x = torch.tensor(tokens)
    _, ref, _ = ntm_tracker_unroll(params, tcfg, x)
    for kw in ({"remat": "dots"}, {"layout": "dn"}, {"remat": "dots", "layout": "dn"}):
        _, logits, _ = ntm_tracker_unroll(params, tcfg, x, **kw)
        np.testing.assert_allclose(logits.numpy(), ref.numpy(), atol=FWD_TOL, err_msg=str(kw))
    with pytest.raises(ValueError, match="remat"):
        ntm_tracker_unroll(params, tcfg, x, remat="some")
    with pytest.raises(ValueError, match="layout"):
        ntm_tracker_unroll(params, tcfg, x, layout="xy")


def test_two_step_inputs_match_jax():
    rs = np.random.RandomState(5)
    inputs = rs.randn(3, 4, 6).astype(np.float32)
    target = rs.rand(3, 5).astype(np.float32)
    got = two_step_inputs(torch.tensor(inputs), torch.tensor(target))
    want = jax_two_step(jnp.asarray(inputs), jnp.asarray(target))
    assert tuple(got.shape) == (3, 7, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_streaming_step_is_the_cell_step():
    _, tcfg, jp, tokens = _setup()
    params = ntm_params_from_flat(flatten_ntm_params(jp))
    state = init_ntm_state(params, tcfg, B)
    step = make_streaming_step(params, tcfg)
    out, logit, new = step(torch.tensor(tokens[:, 0]), state)
    out2, logit2, new2 = ntm_cell_step(params, tcfg, torch.tensor(tokens[:, 0]), state)
    assert torch.equal(logit, logit2) and torch.equal(out, out2) and torch.equal(new["M"], new2["M"])
    params2, init_state = init_tracker(torch.Generator().manual_seed(0), tcfg, IN)
    st = init_state(3)
    assert st["M"].shape == (3, tcfg.mem_size, tcfg.mem_dim) and params2["heads_w"].shape[0] == 12


def test_core_unroll_takes_the_config_and_its_overrides(monkeypatch):
    _, tcfg, jp, tokens = _setup()
    params = ntm_params_from_flat(flatten_ntm_params(jp))
    x = torch.tensor(tokens)
    cfg = TrackerConfig(ntm=tcfg, train=TrainConfig(remat_policy="dots", scan_layout="dn"))
    core = make_core(cfg)
    seen = []
    real = core_mod.ntm_tracker_unroll

    def spy(*args, **kwargs):
        seen.append((kwargs["remat"], kwargs["layout"]))
        return real(*args, **kwargs)

    monkeypatch.setattr(core_mod, "ntm_tracker_unroll", spy)
    core.unroll(params, x)                      # remat=True defers to the config's policy
    logits, _ = core.unroll(params, x, remat=False)  # ... and False stays False
    monkeypatch.undo()
    assert seen == [("dots", "dn"), (False, "dn")]
    with pytest.raises(ValueError, match="fused_bptt"):
        core.unroll(params, x, remat=False, fused_bptt="sometimes")
    cfg = dataclasses.replace(cfg, train=TrainConfig(fused_bptt="bogus", scan_layout="dn"))
    with pytest.raises(ValueError, match="fused_bptt"):
        make_core(cfg).unroll(params, x)
    plain, _ = make_core(cfg).unroll(params, x, remat=False, fused_bptt=False)
    assert torch.equal(plain, logits)
