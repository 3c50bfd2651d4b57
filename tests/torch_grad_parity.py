"""Shared by the port's whole-sequence scan tests (test_torch_scan_bptt.py,
test_torch_scan_cell.py): the tests/pallas_harness.py cases carried to the
port, the every-output cotangent loss in torch, value-and-grad on both
sides, and the gradient tolerance the JAX package holds its own kernel to."""

import dataclasses
import zlib

import jax
import numpy as np
import torch

from ntm_tracker_tpu.config import NTMConfig as JNTMConfig
from ntm_tracker_tpu.models.ntm_cell import init_ntm_state as jinit_state
from ntm_tracker_tpu_torch.config import NTMConfig
from ntm_tracker_tpu_torch.interop import flatten_ntm_params, ntm_params_from_flat
from ntm_tracker_tpu_torch.models.ntm_cell import init_ntm_state

from tests.pallas_harness import B, CONFIGS, make_loss, setup_case

# The tolerance tests/test_pallas_bptt.py holds the JAX kernel to against
# jax.grad: |port - ref| <= GRAD_ATOL * max(1e-3, max|ref|) + GRAD_RTOL * |ref|
# per gradient. Both sides are float32 sums over 7 steps in other orders.
GRAD_ATOL, GRAD_RTOL = 3e-5, 2e-4
FWD_TOL = 1e-5   # logits and final state (test_pallas_bptt.py's forward check)
LOSS_RTOL = 1e-5


def port_cfg(jcfg: JNTMConfig) -> NTMConfig:
    return NTMConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(NTMConfig)})


def torch_cot(cot):
    return [torch.tensor(np.asarray(c)) for c in cot]


def port_loss(scan, tcfg, cot):
    """tests/pallas_harness.make_loss in torch, with the state built from
    the params so that the init_* gradients flow."""
    A, BM, Bw, Br, Bc = cot

    def loss(params, tokens):
        logits, final = scan(params, tcfg, tokens, init_ntm_state(params, tcfg, tokens.shape[0]))
        out = (logits * A).sum() + (final["M"] * BM).sum() + (final["w"] * Bw).sum() + (final["read"] * Br).sum()
        for c, h in final["controller_state"]:
            out = out + (c * Bc).sum() + 0.5 * (h * Bc).sum()
        return out, logits, final

    return loss


def port_value_and_grad(scan, tcfg, jparams, tokens, cot):
    params = ntm_params_from_flat(flatten_ntm_params(jparams))
    flat_names = list(flatten_ntm_params(jparams))
    leaves = []
    for name in flat_names:
        if name.startswith("controller["):
            layer, kind = int(name[11:name.index("]")]), name.split(".")[-1]
            leaves.append(params["controller"][layer][kind])
        else:
            leaves.append(params[name])
    for t in leaves:
        t.requires_grad_()
    tok = torch.tensor(np.asarray(tokens)).requires_grad_()
    value, logits, final = port_loss(scan, tcfg, torch_cot(cot))(params, tok)
    grads = torch.autograd.grad(value, leaves + [tok])
    g = {n: gr.numpy() for n, gr in zip(flat_names, grads)}
    g["tokens"] = grads[-1].numpy()
    return float(value.detach()), logits.detach(), final, g


def jax_value_and_grad(unroll, jcfg, params, tokens, cot):
    def loss(p, t):
        return make_loss(unroll, cot)(p, t, jinit_state(p, jcfg, B))

    value, (gp, gt) = jax.value_and_grad(loss, argnums=(0, 1))(params, tokens)
    g = flatten_ntm_params(gp)
    g["tokens"] = np.asarray(gt)
    return float(value), g


def assert_grads(got, ref):
    assert set(got) == set(ref)
    for name, r in ref.items():
        r = np.asarray(r)
        scale = max(1e-3, float(np.abs(r).max()))
        np.testing.assert_allclose(got[name], r, atol=GRAD_ATOL * scale, rtol=GRAD_RTOL,
                                   err_msg=f"gradient of {name}")


def case(name):
    jcfg = CONFIGS[name]
    params, _state, tokens, cot = setup_case(jcfg, seed=zlib.crc32(name.encode()) % 1000)
    return jcfg, port_cfg(jcfg), params, tokens, cot
