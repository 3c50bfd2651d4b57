"""The scan knobs the JAX package made for the TPU's layout, on the CPU:
layout="dn" (JAX carries the memory transposed, [B, mem_dim, mem_size],
for the TPU's 128-lane tiles; the port runs its "nd" loop, the same math)
and remat="dots" (a selective checkpoint that keeps the matrix products),
against the JAX package's functions with the same knobs and against the
port's "nd" / "full".

Tolerances: float32, the same math summed in other orders. Values at
1e-5 absolute (test_torch_ntm_tracker.py's FWD_TOL); the loss at rtol
1e-5; each gradient within 1e-5 of its largest magnitude against JAX's
unroll with the same knobs and against the port's "nd" / "full"."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntm_tracker_tpu.config import NTMConfig as JNTMConfig
from ntm_tracker_tpu.models import ntm_cell as jcell
from ntm_tracker_tpu.models.ntm_tracker import ntm_tracker_unroll as jax_unroll
from ntm_tracker_tpu.ops import memory as jmem
from ntm_tracker_tpu_torch.config import NTMConfig
from ntm_tracker_tpu_torch.interop import flatten_ntm_params, ntm_params_from_flat
from ntm_tracker_tpu_torch.models import ntm_cell
from ntm_tracker_tpu_torch.ops import memory

from tests.test_torch_ntm_tracker import IN, KW, _torch_loss_and_grads

FWD_TOL = 1e-5
REL = 1e-5


def _cfgs(**kw):
    return JNTMConfig(**{**KW, **kw}), NTMConfig(**{**KW, **kw})


def _assert_rel(got: dict, ref: dict):
    for k, r in ref.items():
        r = np.asarray(r)
        scale = max(float(np.abs(r).max()), 1e-30)
        err = float(np.abs(np.asarray(got[k]) - r).max())
        assert err <= REL * scale, (k, err, scale)


@pytest.mark.parametrize("slotwise", [False, True])
def test_jax_dn_cosines_equal_the_port_cosines(slotwise):
    rs = np.random.RandomState(0)
    mem = rs.randn(3, 16, 8).astype(np.float32)
    keys = rs.randn(3, 5, 8).astype(np.float32)
    mem_dn = np.ascontiguousarray(mem.transpose(0, 2, 1))
    name = "slotwise" if slotwise else "smooth"
    port = getattr(memory, f"batched_{name}_cosine_similarity")
    jax_dn = getattr(jmem, f"batched_{name}_cosine_similarity_dn")
    got = port(torch.tensor(mem), torch.tensor(keys)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_dn(jnp.asarray(mem_dn), jnp.asarray(keys))), atol=FWD_TOL)


@pytest.mark.parametrize("slotwise,write_first", [(False, False), (True, False), (False, True)])
def test_jax_dn_step_equals_the_port_step(slotwise, write_first):
    """JAX's ntm_cell_step_dn is the port's ntm_cell_step with the memory
    transposed, so layout="dn" runs the port's step."""
    jcfg, tcfg = _cfgs(slotwise_cosine=slotwise, write_first=write_first)
    jp = jcell.init_ntm_params(jax.random.PRNGKey(3), jcfg, IN)
    params = ntm_params_from_flat(flatten_ntm_params(jp))
    x = np.random.RandomState(4).uniform(-1, 1, (2, IN)).astype(np.float32)
    jstate = jcell.state_to_dn(jcell.init_ntm_state(jp, jcfg, 2))
    state = ntm_cell.init_ntm_state(params, tcfg, 2)
    # two steps, so the second reads a written memory
    for _ in range(2):
        jout, jlogit, jstate = jcell.ntm_cell_step_dn(jp, jcfg, jnp.asarray(x), jstate)
        out, logit, state = ntm_cell.ntm_cell_step(params, tcfg, torch.tensor(x), state)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=FWD_TOL)
    np.testing.assert_allclose(logit.numpy(), np.asarray(jlogit), atol=FWD_TOL)
    np.testing.assert_allclose(state["M"].numpy(), np.asarray(jstate["M_dn"]).transpose(0, 2, 1), atol=FWD_TOL)
    for k in ("w", "read"):
        np.testing.assert_allclose(state[k].numpy(), np.asarray(jstate[k]), atol=FWD_TOL, err_msg=k)


def test_dn_layout_keeps_the_addressing_kernel(monkeypatch):
    """use_pallas with layout="dn" sends every step's addressing to B3's
    wrapper (its plain version here), and the logits equal JAX's "dn"
    unroll, which runs its plain addressing."""
    jcfg, tcfg = _cfgs(use_pallas=True)
    jp = jcell.init_ntm_params(jax.random.PRNGKey(3), jcfg, IN)
    params = ntm_params_from_flat(flatten_ntm_params(jp))
    tokens = np.random.RandomState(4).uniform(-1, 1, (2, 5, IN)).astype(np.float32)
    calls = []
    addressing = ntm_cell.fused_ntm_addressing
    monkeypatch.setattr(ntm_cell, "fused_ntm_addressing", lambda *a, **k: calls.append(1) or addressing(*a, **k))
    from ntm_tracker_tpu_torch.models.ntm_tracker import ntm_tracker_unroll

    _, logits, _ = ntm_tracker_unroll(params, tcfg, torch.tensor(tokens), remat=False, layout="dn")
    assert len(calls) == tokens.shape[1]
    _, jlogits, _ = jax_unroll(jp, jcfg, jnp.asarray(tokens), remat=False, layout="dn")
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=FWD_TOL)


@pytest.mark.parametrize("layout,remat", [("dn", "full"), ("dn", "none"), ("nd", "dots"), ("dn", "dots")])
def test_unroll_knobs_equal_jax_and_nd_full(layout, remat):
    jcfg, tcfg = _cfgs()
    jp = jcell.init_ntm_params(jax.random.PRNGKey(3), jcfg, IN)
    tokens = np.random.RandomState(4).uniform(-1, 1, (2, 9, IN)).astype(np.float32)

    def jloss(p):
        outputs, logits, final = jax_unroll(p, jcfg, jnp.asarray(tokens), remat=remat, layout=layout)
        return (logits ** 2).sum() + final["M"].sum() + outputs[..., 0].sum(), logits

    (jl, jlogits), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    loss, logits, final, grads = _torch_loss_and_grads(tcfg, jp, tokens, remat=remat, layout=layout)
    assert "M_dn" not in final and tuple(final["M"].shape) == (2, tcfg.mem_size, tcfg.mem_dim)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=FWD_TOL)
    np.testing.assert_allclose(float(loss), float(jl), rtol=REL)
    _assert_rel(grads, flatten_ntm_params(jg))
    base_loss, base_logits, _, base_grads = _torch_loss_and_grads(tcfg, jp, tokens, remat="full", layout="nd")
    np.testing.assert_allclose(logits.numpy(), base_logits.numpy(), atol=FWD_TOL)
    np.testing.assert_allclose(float(loss), float(base_loss), rtol=REL)
    _assert_rel(grads, base_grads)
    # "dn" runs the "nd" loop, and dots recomputes the same ops on the same
    # inputs: the same bits
    assert torch.equal(logits, base_logits) and all(np.array_equal(grads[k], base_grads[k]) for k in grads)


def test_dots_saves_the_products_and_recomputes_the_rest():
    """The policy keeps aten mm/addmm/bmm outputs and recomputes the rest
    (jax.checkpoint_policies.dots_saveable); a kept product is not run
    again in the backward."""
    from torch.utils.checkpoint import CheckpointPolicy

    assert ntm_cell._dots_policy(None, torch.ops.aten.mm.default) == CheckpointPolicy.MUST_SAVE
    assert ntm_cell._dots_policy(None, torch.ops.aten.bmm.default) == CheckpointPolicy.MUST_SAVE
    assert ntm_cell._dots_policy(None, torch.ops.aten.tanh.default) == CheckpointPolicy.PREFER_RECOMPUTE
    _, tcfg = _cfgs()
    params = ntm_cell.init_ntm_params(tcfg, IN, torch.Generator().manual_seed(0))
    leaves = [params["heads_w"].requires_grad_(), params["out_w"].requires_grad_()]
    x = torch.randn(2, 3, IN, generator=torch.Generator().manual_seed(1))
    from torch.utils._python_dispatch import TorchDispatchMode

    from ntm_tracker_tpu_torch.models.ntm_tracker import ntm_tracker_unroll

    counts, by_remat = {}, {}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            counts[func] = counts.get(func, 0) + 1
            return func(*args, **(kwargs or {}))

    for remat in ("full", "dots"):
        _, logits, _ = ntm_tracker_unroll(params, tcfg, x, remat=remat)
        counts.clear()
        with Count():
            torch.autograd.grad(logits.sum(), leaves)
        by_remat[remat] = dict(counts)

    def products(c):
        return c.get(torch.ops.aten.addmm.default, 0) + c.get(torch.ops.aten.mm.default, 0)

    assert products(by_remat["dots"]) < products(by_remat["full"])
