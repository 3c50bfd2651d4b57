"""The port's NTM cell vs the JAX package and the executed TF cell goldens,
on the CPU. Weights always cross over through interop (seeded inits
differ between the frameworks)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntm_tracker_tpu.config import NTMConfig as JNTMConfig
from ntm_tracker_tpu.models import ntm_cell as jcell
from ntm_tracker_tpu.models.ntm_tracker import ntm_tracker_unroll
from ntm_tracker_tpu_torch.config import NTMConfig, TrackerConfig
from ntm_tracker_tpu_torch.interop import flatten_ntm_params, ntm_params_from_flat
from ntm_tracker_tpu_torch.models import ntm_cell as tcell
from ntm_tracker_tpu_torch.models.core import make_core

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
# float32 on both sides; different summation orders, a few steps deep
F32_TOL = 2e-5
# the executed-reference bound the JAX package itself is held to
GOLDEN_TOL = 1e-4

CONFIGS = {
    "default-ish": dict(output_dim=2, mem_size=16, mem_dim=8, controller_hidden_size=16,
                        read_head_size=2, write_head_size=1),
    "multilayer-writefirst-s5": dict(output_dim=3, mem_size=8, mem_dim=4, controller_hidden_size=8,
                                     controller_num_layers=2, read_head_size=1, write_head_size=2,
                                     shift_range=2, write_first=True),
    "slotwise-cosine": dict(output_dim=2, mem_size=16, mem_dim=8, controller_hidden_size=16,
                            read_head_size=2, write_head_size=1, slotwise_cosine=True),
}


def _pair(kw, input_size=10, seed=0):
    jcfg, tcfg = JNTMConfig(**kw), NTMConfig(**kw)
    jp = jcell.init_ntm_params(jax.random.PRNGKey(seed), jcfg, input_size)
    return jcfg, tcfg, jp, ntm_params_from_flat(flatten_ntm_params(jp))


def _assert_state_close(tstate, jstate, atol, err=""):
    for key in ("M", "w", "read"):
        np.testing.assert_allclose(tstate[key].numpy(), np.asarray(jstate[key]), atol=atol, err_msg=err + key)
    for (tc, th), (jc, jh) in zip(tstate["controller_state"], jstate["controller_state"]):
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=atol, err_msg=err + "c")
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=atol, err_msg=err + "h")


def test_head_param_sizes_and_shapes_match_jax():
    for kw in CONFIGS.values():
        jcfg, tcfg, jp, tp = _pair(kw)
        assert tcell.head_param_sizes(tcfg) == jcell.head_param_sizes(jcfg)
        own = tcell.init_ntm_params(tcfg, 10, torch.Generator().manual_seed(0))
        assert {k: v.shape for k, v in flatten_ntm_params(own).items()} == \
            {k: v.shape for k, v in flatten_ntm_params(jp).items()}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_cell_step_matches_jax(name):
    jcfg, tcfg, jp, tp = _pair(CONFIGS[name])
    B = 3
    x = np.random.RandomState(1).randn(B, 10).astype(np.float32)
    jout, jlogit, jstate, jdbg = jcell.ntm_cell_step(
        jp, jcfg, jnp.asarray(x), jcell.init_ntm_state(jp, jcfg, B), with_debug=True)
    tstate0 = tcell.init_ntm_state(tp, tcfg, B)
    assert all(t.is_contiguous() for t in (tstate0["M"], tstate0["w"], tstate0["read"]))
    tout, tlogit, tstate, tdbg = tcell.ntm_cell_step(tp, tcfg, torch.tensor(x), tstate0, with_debug=True)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=F32_TOL)
    np.testing.assert_allclose(tlogit.numpy(), np.asarray(jlogit), atol=F32_TOL)
    _assert_state_close(tstate, jstate, F32_TOL)
    for key in ("similarity", "w_content_focused", "w_gated", "w_conv", "w", "M_erase", "M_write"):
        np.testing.assert_allclose(tdbg[key].numpy(), np.asarray(jdbg[key]), atol=F32_TOL, err_msg=key)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_unroll_matches_jax(name):
    jcfg, tcfg, jp, tp = _pair(CONFIGS[name])
    x = np.random.RandomState(2).randn(2, 9, 10).astype(np.float32)
    _, jlogits, jfinal = ntm_tracker_unroll(jp, jcfg, jnp.asarray(x), remat=False)
    core = make_core(TrackerConfig(ntm=tcfg))
    tlogits, tfinal = core.unroll(tp, torch.tensor(x))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=F32_TOL)
    _assert_state_close(tfinal, jfinal, F32_TOL)


def test_use_pallas_is_not_ported():
    """(Named when use_pallas raised.) The flag is ported now: on CPU
    tensors the step takes the addressing kernel's plain version, which
    gives the flag-off step's numbers (tests/test_torch_addressing.py holds
    it against JAX's kernel)."""
    _, tcfg, _, tp = _pair(dict(CONFIGS["default-ish"], use_pallas=True))
    x = torch.tensor(np.random.RandomState(5).randn(2, 10).astype(np.float32))
    state = tcell.init_ntm_state(tp, tcfg, 2)
    got = tcell.ntm_cell_step(tp, tcfg, x, state)
    want = tcell.ntm_cell_step(tp, dataclasses.replace(tcfg, use_pallas=False), x, state)
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), atol=F32_TOL)
    _assert_state_close(got[2], want[2], F32_TOL)


def _golden(fixture):
    g = np.load(os.path.join(FIXTURES, fixture))
    (batch, steps, _in, mem_size, mem_dim, shift_range, hidden, num_layers, read_heads,
     write_heads, write_first) = [int(v) for v in g["config"]]
    cfg = NTMConfig(output_dim=2, mem_size=mem_size, mem_dim=mem_dim, shift_range=shift_range,
                    controller_hidden_size=hidden, controller_num_layers=num_layers,
                    read_head_size=read_heads, write_head_size=write_heads, write_first=bool(write_first))
    flat = {k[len("param_"):]: g[k] for k in g.files if k.startswith("param_") and "ctrl" not in k}
    for layer in range(num_layers):
        flat[f"controller[{layer}].kernel"] = g[f"param_ctrl_kernel_{layer}"]
        flat[f"controller[{layer}].bias"] = g[f"param_ctrl_bias_{layer}"]
    return g, cfg, ntm_params_from_flat(flat), batch, steps


@pytest.mark.parametrize("fixture", ["tf_goldens_cell.npz", "tf_goldens_cell_variant.npz"])
def test_rollout_matches_executed_reference(fixture):
    """65 streamed steps of the executed reference NTMCell: every logit and
    the full state at the checkpointed steps."""
    g, cfg, params, batch, steps = _golden(fixture)
    state = tcell.init_ntm_state(params, cfg, batch)
    ckpt = [int(v) for v in g["ckpt_steps"]]
    worst = 0.0
    with torch.no_grad():
        for t in range(steps):
            _, logit, state = tcell.ntm_cell_step(params, cfg, torch.tensor(g["inputs"][t]), state)
            worst = max(worst, float(np.abs(logit.numpy() - g["logits"][t]).max()))
            if t in ckpt:
                i = ckpt.index(t)
                for key in ("M", "w", "read"):
                    np.testing.assert_allclose(state[key].numpy(), g[f"state{i}_{key}"], atol=GOLDEN_TOL,
                                               err_msg=f"{key} step {t}")
                flat_ctrl = torch.cat([torch.cat([c, h], 1) for c, h in state["controller_state"]], 1)
                np.testing.assert_allclose(flat_ctrl.numpy(), g[f"state{i}_controller_state"], atol=GOLDEN_TOL)
    assert worst <= GOLDEN_TOL / 2, worst


def test_first_step_intermediates_match_executed_reference():
    g, cfg, params, batch, _ = _golden("tf_goldens_cell.npz")
    *_, dbg = tcell.ntm_cell_step(params, cfg, torch.tensor(g["inputs"][0]),
                                  tcell.init_ntm_state(params, cfg, batch), with_debug=True)
    for key in ("similarity", "w_content_focused", "w_gated", "w_conv", "w"):
        np.testing.assert_allclose(dbg[key].numpy(), g["dbg0_" + key], atol=1e-5, err_msg=key)
