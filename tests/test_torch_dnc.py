"""The DNC core on the CPU: models/dnc (addressing, access, dnc) against
the JAX package's functions on the same inputs, forward and gradients;
against the TF goldens (tests/test_tf_parity.py's DNC cases) and the
forward_v1 fixture's dnc_* keys; the DNC MemoryCore and one DNC
OffsetExperiment train step (loss, gradients, RMSProp update) against
JAX's; the NamedTuple state through tree_map, _to_device and the fleet's
row writes; the DNC through StreamingTracker, FleetTracker and the device
loop."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntm_tracker_tpu import config as jconfig
from ntm_tracker_tpu.models.dnc import access as jacc
from ntm_tracker_tpu.models.dnc import addressing as jadr
from ntm_tracker_tpu.models.dnc import dnc as jdnc
from ntm_tracker_tpu.train import experiments as jexp
from ntm_tracker_tpu_torch import config as tconfig
from ntm_tracker_tpu_torch.interop import (
    dnc_params_from_flat,
    flatten_dnc_params,
    flatten_opt_state,
    opt_state_from_flat,
)
from ntm_tracker_tpu_torch.models.core import make_core
from ntm_tracker_tpu_torch.models.dnc import access as tacc
from ntm_tracker_tpu_torch.models.dnc import addressing as tadr
from ntm_tracker_tpu_torch.models.dnc import dnc as tdnc
from ntm_tracker_tpu_torch.models.vgg import init_vgg_params
from ntm_tracker_tpu_torch.tracking import fleet as tfleet
from ntm_tracker_tpu_torch.tracking.tracker import StreamingTracker, _to_device, make_device_track_step
from ntm_tracker_tpu_torch.train import experiments as texp
from ntm_tracker_tpu_torch.train.optim import tree_leaves, tree_map

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
# one addressing function, float32 on both sides in other orders
ADDR_ATOL = 1e-6
# a few steps of the core (tests/test_tf_parity.py's DNC bound)
STEP_ATOL = 1e-5
# gradients: max |port - jax| <= GRAD_TOL * max |jax|, per tensor; float32
# sums in other orders over a dozen steps
GRAD_TOL = 1e-4
# the train step: the offsets loss over T=2*5=10 steps, its gradients, and
# RMSProp's step (tests/test_torch_experiment.py's bounds)
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-7

KW = dict(output_dim=3, memory_size=16, word_size=6, num_reads=2, num_writes=2, hidden_size=20)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run thousands of small ops, which
    stall on thread hand-offs when the run's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _rs(seed):
    return np.random.RandomState(seed)


def _weights(shape, seed, power=1.0):
    """Rows of weights over the last axis (softmax-like, summing to < 1)."""
    w = _rs(seed).rand(*shape).astype(np.float32) ** power
    return (w / (w.sum(-1, keepdims=True) * 1.25)).astype(np.float32)


def _grad_tree(fn, tree):
    live = tree_map(lambda t: t.detach().clone().requires_grad_(), tree)
    out = fn(live)
    grads = torch.autograd.grad(out, tree_leaves(live), allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(tree_leaves(live), grads)]


def _assert_grads(got, want, what):
    for i, (g, r) in enumerate(zip(got, want)):
        r = np.asarray(r)
        scale = max(float(np.abs(r).max()), 1e-12)
        np.testing.assert_allclose(g.numpy(), r, atol=GRAD_TOL * scale, rtol=0, err_msg=f"{what} [{i}]")


# ---- addressing ---------------------------------------------------------------

def test_cosine_weights_forward_and_grads():
    mem, keys = _rs(0).randn(3, 16, 6).astype(np.float32), _rs(1).randn(3, 2, 6).astype(np.float32)
    strengths = _rs(2).randn(3, 2).astype(np.float32)
    got = tadr.cosine_weights(_t(mem), _t(keys), _t(strengths))
    want = jadr.cosine_weights(jnp.asarray(mem), jnp.asarray(keys), jnp.asarray(strengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ADDR_ATOL)
    cot = _rs(3).randn(3, 2, 16).astype(np.float32)
    jg = jax.grad(lambda a: jnp.sum(jadr.cosine_weights(*a) * cot))(
        (jnp.asarray(mem), jnp.asarray(keys), jnp.asarray(strengths)))
    tg = _grad_tree(lambda a: torch.sum(tadr.cosine_weights(*a) * _t(cot)), (_t(mem), _t(keys), _t(strengths)))
    _assert_grads(tg, jg, "cosine_weights")


def test_temporal_linkage_and_directional_reads():
    B, Wh, N, R = 2, 2, 16, 3
    ww = _weights((B, Wh, N), 0)
    link = _rs(1).rand(B, Wh, N, N).astype(np.float32) * 0.1
    prec = _weights((B, Wh, N), 2)
    rw = _weights((B, R, N), 3)
    jstate = jadr.temporal_linkage_update(jnp.asarray(ww), jadr.TemporalLinkageState(jnp.asarray(link),
                                                                                      jnp.asarray(prec)))
    tstate = tadr.temporal_linkage_update(_t(ww), tadr.TemporalLinkageState(_t(link), _t(prec)))
    assert type(tstate) is tadr.TemporalLinkageState
    np.testing.assert_allclose(tstate.link.numpy(), np.asarray(jstate.link), atol=ADDR_ATOL)
    np.testing.assert_allclose(tstate.precedence_weights.numpy(), np.asarray(jstate.precedence_weights),
                               atol=ADDR_ATOL)
    assert np.all(np.diagonal(tstate.link.numpy(), axis1=2, axis2=3) == 0)
    for forward in (True, False):
        got = tadr.directional_read_weights(tstate.link, _t(rw), forward)
        want = jadr.directional_read_weights(jstate.link, jnp.asarray(rw), forward)
        assert tuple(got.shape) == (B, R, Wh, N)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ADDR_ATOL)


def test_usage_update_stops_the_write_gradient_and_keeps_zero_factors():
    B, Wh, R, N = 2, 2, 3, 16
    ww, rw = _weights((B, Wh, N), 0), _weights((B, R, N), 1)
    # a read weight of 1 under a free gate of 1: a factor (1 - 1) = 0 in
    # the retention product, whose gradient must still flow
    rw[0, 1, :] = 0.0
    rw[0, 1, 5] = 1.0
    free = _rs(2).rand(B, R).astype(np.float32)
    free[0, 1] = 1.0
    usage = _rs(3).rand(B, N).astype(np.float32)
    args = (ww, free, rw, usage)
    got = tadr.usage_update(*map(_t, args))
    want = jadr.usage_update(*map(jnp.asarray, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ADDR_ATOL)
    cot = _rs(4).randn(B, N).astype(np.float32)
    jg = jax.grad(lambda a: jnp.sum(jadr.usage_update(*a) * cot))(tuple(map(jnp.asarray, args)))
    tg = _grad_tree(lambda a: torch.sum(tadr.usage_update(*a) * _t(cot)), tuple(map(_t, args)))
    assert float(tg[0].abs().max()) == 0.0  # no gradient through the write weights
    assert float(tg[1][0, 1].abs()) > 0 and float(tg[2][0, 1].abs().max()) > 0  # through the zero factor
    _assert_grads(tg, jg, "usage_update")


@pytest.mark.parametrize("usage_kind", ["all_zero", "repeated", "random"])
def test_allocation_orders_ties_as_top_k(usage_kind):
    B, N = 3, 16
    if usage_kind == "all_zero":
        usage = np.zeros((B, N), np.float32)  # step 0: every slot ties
    elif usage_kind == "repeated":
        usage = np.round(_rs(5).rand(B, N) * 3).astype(np.float32) / 3  # 4 distinct values
    else:
        usage = _rs(6).rand(B, N).astype(np.float32)
    got = tadr._allocation(_t(usage))
    want = np.asarray(jadr._allocation(jnp.asarray(usage)))
    np.testing.assert_allclose(got.numpy(), want, atol=ADDR_ATOL)
    if usage_kind == "all_zero":
        # top_k's order: the lowest slot is allocated first
        assert int(got.argmax(-1)[0]) == 0 and float(got[0, 0]) > 0.99
    cot = _rs(7).randn(B, N).astype(np.float32)
    jg = jax.grad(lambda u: jnp.sum(jadr._allocation(u) * cot))(jnp.asarray(usage))
    tg = _grad_tree(lambda u: torch.sum(tadr._allocation(u) * _t(cot)), _t(usage))
    _assert_grads(tg, [jg], f"_allocation {usage_kind}")


@pytest.mark.parametrize("usage_kind", ["all_zero", "repeated"])
def test_write_allocation_weights_two_heads(usage_kind):
    B, N = 2, 16
    usage = (np.zeros((B, N), np.float32) if usage_kind == "all_zero"
             else np.round(_rs(8).rand(B, N) * 2).astype(np.float32) / 2)
    gates = _rs(9).rand(B, 2).astype(np.float32)
    got = tadr.write_allocation_weights(_t(usage), _t(gates), 2)
    want = jadr.write_allocation_weights(jnp.asarray(usage), jnp.asarray(gates), 2)
    assert tuple(got.shape) == (B, 2, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ADDR_ATOL)
    cot = _rs(10).randn(B, 2, N).astype(np.float32)
    jg = jax.grad(lambda a: jnp.sum(jadr.write_allocation_weights(*a, 2) * cot))(
        (jnp.asarray(usage), jnp.asarray(gates)))
    tg = _grad_tree(lambda a: torch.sum(tadr.write_allocation_weights(*a, 2) * _t(cot)), (_t(usage), _t(gates)))
    _assert_grads(tg, jg, f"write_allocation_weights {usage_kind}")


# ---- access and the core --------------------------------------------------------
#
# Slots whose usage ties exactly (never written, or written alike) hold the
# same memory rows, links and weights, so a state is defined up to a
# relabeling of those slots. Exact ties are ordered alike on both sides
# (the lowest slot first); past step 0, the allocation's cumulative
# products make some tied slots' simulated usages differ from the others
# by one float32 ulp, and whether a product rounds to that ulp differs
# between XLA (or TF) and PyTorch, so the two can label a tie group
# differently. Outputs and read words do not depend on the labels and are
# compared as they are; states are compared after each side's slots are
# matched (`_slot_permutation`).


def _slot_signature(state) -> np.ndarray:
    """[B, N, K]: what a memory slot holds in an AccessState (its row of
    memory, usage, precedence, and the read and write weights on it)."""
    mem = np.asarray(state.memory)
    parts = [mem, np.asarray(state.usage)[..., None], np.asarray(state.linkage.precedence_weights).transpose(0, 2, 1),
             np.asarray(state.read_weights).transpose(0, 2, 1), np.asarray(state.write_weights).transpose(0, 2, 1)]
    return np.concatenate([p.reshape(mem.shape[0], mem.shape[1], -1) for p in parts], axis=-1)


def _slot_permutation(got, want) -> np.ndarray:
    """[B, N]: for each of want's slots the slot of got that holds the same
    contents (closest signature, each slot taken once)."""
    g, w = _slot_signature(got), _slot_signature(want)
    perm = np.zeros(g.shape[:2], np.int64)
    for b in range(g.shape[0]):
        free = list(range(g.shape[1]))
        for j in range(g.shape[1]):
            i = min(free, key=lambda i: float(np.abs(g[b, i] - w[b, j]).max()))
            perm[b, j] = i
            free.remove(i)
    return perm


def _relabel(state, perm):
    """An AccessState with its slots taken in `perm`'s order."""
    def take(x, axis):
        x = np.asarray(x)
        idx = perm.reshape(perm.shape[:1] + (1,) * (axis - 1) + perm.shape[1:] + (1,) * (x.ndim - axis - 1))
        return np.take_along_axis(x, np.broadcast_to(idx, x.shape[:axis] + perm.shape[1:] + x.shape[axis + 1:]),
                                  axis)
    link = take(take(state.linkage.link, 2), 3)
    return tacc.AccessState(take(state.memory, 1), take(state.read_weights, 2), take(state.write_weights, 2),
                            tadr.TemporalLinkageState(link, take(state.linkage.precedence_weights, 2)),
                            take(state.usage, 1))


def _assert_access_state(got, want, atol):
    """got == want up to a relabeling of slots, within atol."""
    got = tacc.AccessState(*[tadr.TemporalLinkageState(*map(_np, v)) if isinstance(v, tuple) else _np(v)
                             for v in got])
    rel = _relabel(got, _slot_permutation(got, want))
    for name, g, w in (("memory", rel.memory, want.memory), ("read_weights", rel.read_weights, want.read_weights),
                       ("write_weights", rel.write_weights, want.write_weights), ("link", rel.linkage.link,
                       want.linkage.link), ("precedence", rel.linkage.precedence_weights,
                       want.linkage.precedence_weights), ("usage", rel.usage, want.usage)):
        np.testing.assert_allclose(g, np.asarray(w), atol=atol, err_msg=name)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_dnc_state(got, want, atol):
    np.testing.assert_allclose(_np(got.access_output), np.asarray(want.access_output), atol=atol)
    for (c, h), (jc, jh) in zip(got.controller_state, want.controller_state):
        np.testing.assert_allclose(_np(c), np.asarray(jc), atol=atol)
        np.testing.assert_allclose(_np(h), np.asarray(jh), atol=atol)
    _assert_access_state(got.access_state, want.access_state, atol)

def _access_params(seed, cfg, input_size):
    jp = jacc.init_access_params(jax.random.PRNGKey(seed), cfg, input_size)
    jp["interface_b"] = jnp.asarray(_rs(seed).randn(*jp["interface_b"].shape).astype(np.float32) * 0.1)
    return jp, {k: _t(v) for k, v in jp.items()}


def test_memory_access_step_forward_and_grads():
    jcfg, tcfg = jconfig.DNCConfig(**KW), tconfig.DNCConfig(**KW)
    jp, tp = _access_params(0, jcfg, 20)
    x = _rs(1).randn(3, 6, 20).astype(np.float32)
    jstate, tstate = jacc.init_access_state(jcfg, 3), tacc.init_access_state(tcfg, 3)
    for t in range(6):
        jr, jstate = jacc.memory_access_step(jp, jcfg, jnp.asarray(x[:, t]), jstate)
        tr, tstate = tacc.memory_access_step(tp, tcfg, _t(x[:, t]), tstate)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=STEP_ATOL, err_msg=f"step {t}")
    _assert_access_state(tstate, jstate, STEP_ATOL)

    def jloss(p, xs):
        s, total = jacc.init_access_state(jcfg, 3), 0.0
        for t in range(4):
            r, s = jacc.memory_access_step(p, jcfg, xs[:, t], s)
            total = total + jnp.sum(r * r) + jnp.sum(s.usage)
        return total

    def tloss(a):
        p, xs = a
        s, total = tacc.init_access_state(tcfg, 3), 0.0
        for t in range(4):
            r, s = tacc.memory_access_step(p, tcfg, xs[:, t], s)
            total = total + torch.sum(r * r) + torch.sum(s.usage)
        return total

    jg = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tg = _grad_tree(tloss, (tp, _t(x)))
    _assert_grads(tg, [jg[0]["interface_w"], jg[0]["interface_b"], jg[1]], "memory_access_step")


def _dnc_pair(seed=7, input_size=9, **over):
    kw = {**KW, **over}
    jcfg, tcfg = jconfig.DNCConfig(**kw), tconfig.DNCConfig(**kw)
    jp = jdnc.init_dnc_params(jax.random.PRNGKey(seed), jcfg, input_size)
    return jcfg, tcfg, jp, dnc_params_from_flat(flatten_dnc_params(jp))


def test_dnc_step_matches_jax():
    jcfg, tcfg, jp, tp = _dnc_pair()
    x = _rs(2).randn(3, 5, 9).astype(np.float32) * 3
    jstate, tstate = jdnc.init_dnc_state(jcfg, 3), tdnc.init_dnc_state(tcfg, 3)
    for t in range(5):
        jo, jstate = jdnc.dnc_step(jp, jcfg, jnp.asarray(x[:, t]), jstate)
        to, tstate = tdnc.dnc_step(tp, tcfg, _t(x[:, t]), tstate)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=STEP_ATOL, err_msg=f"step {t}")
    assert isinstance(tstate, tdnc.DNCState) and isinstance(tstate.access_state, tacc.AccessState)
    _assert_dnc_state(tstate, jstate, STEP_ATOL)


@pytest.mark.parametrize("remat,remat_chunk", [(False, 0), (True, 0), (True, 4)],
                         ids=["plain", "per_step", "chunks_of_4"])
def test_dnc_unroll_forward_and_grads(remat, remat_chunk):
    """Forward against JAX's at the same remat settings; gradients against
    the gradient of JAX's plain unroll, and the same bits as the port's
    plain unroll. (JAX's rematerialized DNC gradient can differ from its
    plain one: XLA compiles the recompute apart from the forward, and
    where a tie group's order falls on a float32 ulp the recompute may
    label the group otherwise than the forward did, here 2.6e-2 on
    interface_b. The port's checkpoint reruns the forward's own kernels.)"""
    jcfg, tcfg, jp, tp = _dnc_pair(remat_chunk=remat_chunk)
    x = _rs(3).randn(2, 10, 9).astype(np.float32) * 3  # 10 = two chunks of 4 and a tail of 2
    cot = _rs(4).randn(2, 10, 3).astype(np.float32)
    jo, jf = jdnc.dnc_unroll(jp, jcfg, jnp.asarray(x), remat=remat, remat_chunk=remat_chunk)
    to, tf = tdnc.dnc_unroll(tp, tcfg, _t(x), remat=remat, remat_chunk=remat_chunk)
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), atol=STEP_ATOL)
    _assert_dnc_state(tf, jf, STEP_ATOL)

    def jloss(p):
        o, f = jdnc.dnc_unroll(p, jcfg, jnp.asarray(x), remat=False)
        return jnp.sum(o * cot) + jnp.sum(f.access_state.memory)

    def tloss(p, **kw):
        o, f = tdnc.dnc_unroll(p, tcfg, _t(x), **kw)
        return torch.sum(o * _t(cot)) + torch.sum(f.access_state.memory)

    def flat(grads):
        it = iter(grads)
        return flatten_dnc_params(tree_map(lambda _: next(it), tp))

    jg = flatten_dnc_params(jax.grad(jloss)(jp))
    tg = flat(_grad_tree(functools.partial(tloss, remat=remat, remat_chunk=remat_chunk), tp))
    plain = flat(_grad_tree(functools.partial(tloss, remat=False), tp))
    assert set(tg) == set(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], atol=GRAD_TOL * max(float(np.abs(jg[k]).max()), 1e-12), rtol=0,
                                   err_msg=k)
        np.testing.assert_array_equal(tg[k], plain[k], err_msg=k)


def test_dnc_unroll_time_major_and_empty():
    _, tcfg, _, tp = _dnc_pair()
    x = _t(_rs(5).randn(2, 4, 9))
    o, f = tdnc.dnc_unroll(tp, tcfg, x, remat=False)
    o_tm, f_tm = tdnc.dnc_unroll(tp, tcfg, x.transpose(0, 1), remat=False, time_major=True)
    torch.testing.assert_close(o_tm.transpose(0, 1), o, rtol=0, atol=0)
    o0, f0 = tdnc.dnc_unroll(tp, tcfg, x[:, :0], remat=False)
    assert tuple(o0.shape) == (2, 0, 3) and float(f0.access_state.memory.abs().max()) == 0


def test_init_dnc_params_shapes_match_jax():
    jcfg, tcfg, jp, _ = _dnc_pair()
    tp = tdnc.init_dnc_params(tcfg, 9, torch.Generator().manual_seed(0))
    jf, tf = flatten_dnc_params(jp), flatten_dnc_params(tp)
    assert {k: v.shape for k, v in tf.items()} == {k: v.shape for k, v in jf.items()}
    # truncated normal at 2 std of 1/sqrt(fan_in)
    fan_in = 9 + 2 * 6 + 20
    assert np.abs(tf["controller[0].kernel"]).max() <= 2 * fan_in ** -0.5 + 1e-6
    assert not tf["controller[0].bias"].any() and not tf["out_b"].any()


# ---- the TF goldens and the forward_v1 fixture -------------------------------------

@pytest.fixture(scope="module")
def ops_g():
    return np.load(os.path.join(FIXTURES, "tf_goldens_ops.npz"))


def test_addressing_matches_executed_reference(ops_g):
    g = ops_g
    np.testing.assert_allclose(
        tadr.cosine_weights(_t(g["dnc_memory"]), _t(g["dnc_keys"]), _t(g["dnc_strengths"])).numpy(),
        g["dnc_cw"], atol=1e-6)
    nxt = tadr.temporal_linkage_update(_t(g["dnc_write_w"]),
                                       tadr.TemporalLinkageState(_t(g["dnc_prev_link"]), _t(g["dnc_prev_prec"])))
    np.testing.assert_allclose(nxt.link.numpy(), g["dnc_link"], atol=1e-6)
    np.testing.assert_allclose(nxt.precedence_weights.numpy(), g["dnc_prec"], atol=1e-6)
    rw = _t(g["dnc_read_w"])
    np.testing.assert_allclose(tadr.directional_read_weights(nxt.link, rw, True).numpy(), g["dnc_fwd"], atol=1e-6)
    np.testing.assert_allclose(tadr.directional_read_weights(nxt.link, rw, False).numpy(), g["dnc_bwd"], atol=1e-6)
    usage = tadr.usage_update(_t(g["dnc_write_w"]), _t(g["dnc_free_gate"]), rw, _t(g["dnc_prev_usage"]))
    np.testing.assert_allclose(usage.numpy(), g["dnc_usage"], atol=1e-6)
    alloc = tadr.write_allocation_weights(_t(g["dnc_prev_usage"]), _t(g["dnc_write_gates"]), num_writes=2)
    np.testing.assert_allclose(alloc.numpy(), g["dnc_alloc"], atol=1e-6)


def test_memory_access_matches_executed_reference(ops_g):
    g = ops_g
    B, N, W, R, Wh, IN, T = [int(x) for x in g["dncacc_config"]]
    cfg = tconfig.DNCConfig(memory_size=N, word_size=W, num_reads=R, num_writes=Wh)
    names = list(tacc._interface_sizes(cfg))
    params = {"interface_w": _t(np.concatenate([g[f"dncacc_{n}_w"] for n in names], axis=1)),
              "interface_b": _t(np.concatenate([g[f"dncacc_{n}_b"] for n in names]))}
    state, reads = tacc.init_access_state(cfg, B), []
    for t in range(T):
        r, state = tacc.memory_access_step(params, cfg, _t(g["dncacc_inputs"][t]), state)
        reads.append(r.numpy())
    np.testing.assert_allclose(np.stack(reads), g["dncacc_reads"], atol=1e-5)
    want = tacc.AccessState(g["dncacc_final_memory"], g["dncacc_final_read_weights"],
                            g["dncacc_final_write_weights"],
                            tadr.TemporalLinkageState(g["dncacc_final_link"], g["dncacc_final_precedence"]),
                            g["dncacc_final_usage"])
    _assert_access_state(state, want, 1e-5)


def test_dnc_core_matches_executed_reference():
    g = np.load(os.path.join(FIXTURES, "tf_goldens_dnc_core.npz"))
    B, N, W, R, Wh, IN, HID, OUT, T = [int(x) for x in g["dnccore_config"]]
    cfg = tconfig.DNCConfig(memory_size=N, word_size=W, num_reads=R, num_writes=Wh, hidden_size=HID,
                            output_dim=OUT, clip_value=float(g["dnccore_clip"]))
    names = list(tacc._interface_sizes(cfg))
    params = {
        "controller": [{"kernel": _t(g["dnccore_var_lstm__w_gates"]), "bias": _t(g["dnccore_var_lstm__b_gates"])}],
        "access": {"interface_w": _t(np.concatenate([g[f"dnccore_var_{n}__w"] for n in names], axis=1)),
                   "interface_b": _t(np.concatenate([g[f"dnccore_var_{n}__b"] for n in names]))},
        "out_w": _t(g["dnccore_var_output_linear__w"]),
        "out_b": _t(g["dnccore_var_output_linear__b"]),
    }
    state, outs = tdnc.init_dnc_state(cfg, B), []
    for t in range(T):
        o, state = tdnc.dnc_step(params, cfg, _t(g["dnccore_inputs"][t]), state)
        outs.append(o.numpy())
    np.testing.assert_allclose(np.stack(outs), g["dnccore_outputs"], atol=1e-5)
    np.testing.assert_allclose(state.access_output.numpy(), g["dnccore_final_access_output"], atol=1e-5)
    np.testing.assert_allclose(state.access_state.memory.numpy(), g["dnccore_final_memory"], atol=1e-5)
    np.testing.assert_allclose(state.access_state.usage.numpy(), g["dnccore_final_usage"], atol=1e-5)
    np.testing.assert_allclose(state.access_state.linkage.link.numpy(), g["dnccore_final_link"], atol=1e-5)
    c, h = state.controller_state[0]  # the golden's is (hidden, cell)
    np.testing.assert_allclose(h.numpy(), g["dnccore_final_ctrl_hidden"], atol=1e-5)
    np.testing.assert_allclose(c.numpy(), g["dnccore_final_ctrl_cell"], atol=1e-5)


def test_dnc_unroll_matches_forward_v1_fixture():
    fix = np.load(os.path.join(FIXTURES, "forward_v1.npz"))
    # the fixture's parameters and inputs, made as tests/gen_fixtures.py makes them
    cfg = dict(output_dim=3, memory_size=16, word_size=6, num_reads=2, num_writes=1, hidden_size=20,
               clip_value=20.0)
    jp = jdnc.init_dnc_params(jax.random.PRNGKey(7), jconfig.DNCConfig(**cfg), 9)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(8), (2, 6, 9)))
    outs, final = tdnc.dnc_unroll(dnc_params_from_flat(flatten_dnc_params(jp)), tconfig.DNCConfig(**cfg), _t(x))
    np.testing.assert_allclose(outs.numpy(), fix["dnc_outputs"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(final.access_state.memory.numpy(), fix["dnc_final_memory"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(final.access_state.usage.numpy(), fix["dnc_final_usage"], rtol=1e-5, atol=1e-6)


# ---- the core facade and the train step ---------------------------------------------

def _tracker_cfgs(**over):
    def build(mod):
        return mod.TrackerConfig(
            core="dnc",
            dnc=mod.DNCConfig(output_dim=2, memory_size=8, word_size=4, num_reads=2, num_writes=1, hidden_size=12),
            data=mod.DataConfig(crop_size=32, resize_hw=(48, 64), gt_width=2),
            train=mod.TrainConfig(batch_size=2, sequence_length=2),
            num_features=4, feature_depth=16,
            feature_points=((1, 1), (1, 2), (2, 1), (2, 2)),
            **over,
        )
    return build(jconfig), build(tconfig)


def test_make_core_runs_the_dnc():
    _, tcfg = _tracker_cfgs()
    core = make_core(tcfg)
    params = core.init_params(torch.Generator().manual_seed(0), tcfg.input_depth)
    state = core.init_state(params, 3)
    assert isinstance(state, tdnc.DNCState) and core.state_view is None
    x = _t(_rs(0).randn(3, 2, tcfg.input_depth))
    logit, stepped = core.step(params, x[:, 0], state)
    logits, final = core.unroll(params, x[:, :1], state, remat=False)
    assert torch.equal(logits[:, 0], logit)
    assert torch.equal(final.access_state.memory, stepped.access_state.memory)
    assert tuple(logits.shape) == (3, 1, 2)


def test_dnc_train_step_matches_jax():
    jcfg, tcfg = _tracker_cfgs()
    jx = jexp.OffsetExperiment(jcfg, None)
    tx = texp.OffsetExperiment(tcfg, None, device="cpu")
    jparams, jopt = jx.init(jax.random.PRNGKey(0))
    params = dnc_params_from_flat(flatten_dnc_params(jparams))
    opt_state = opt_state_from_flat(flatten_opt_state(jopt))
    batch = texp.synthetic_cached_batch(tcfg, _rs(0))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    (jloss, _), jgrads = jax.value_and_grad(jx.loss_fn, has_aux=True)(jparams, jbatch)
    tg = _grad_tree(lambda p: tx.loss_fn(p, batch)[0], params)
    it = iter(tg)
    tg = flatten_dnc_params(tree_map(lambda _: next(it), params))
    for k, r in flatten_dnc_params(jgrads).items():
        np.testing.assert_allclose(tg[k], r, atol=GRAD_TOL * max(float(np.abs(r).max()), 1e-12), rtol=0,
                                   err_msg=f"gradient of {k}")

    jparams, jopt, jm = jax.jit(jx.make_train_step())(jparams, jopt, jbatch)
    params, opt_state, m = tx.make_train_step()(params, opt_state, batch)
    np.testing.assert_allclose(float(m["loss"]), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    got = flatten_dnc_params(params)
    for k, r in flatten_dnc_params(jparams).items():
        np.testing.assert_allclose(got[k], r, atol=PARAM_ATOL, err_msg=k)
    got, want = flatten_opt_state(opt_state), flatten_opt_state(jopt)
    assert set(got) == set(want) and any(k.startswith("mom/access.") for k in got)
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-12)
        np.testing.assert_allclose(got[k], want[k], atol=GRAD_TOL * scale, rtol=1e-5, err_msg=k)


# ---- the NamedTuple state through the tree helpers, the trackers ---------------------

def test_tree_helpers_keep_namedtuple_states():
    _, tcfg = _tracker_cfgs()
    state = tdnc.init_dnc_state(tcfg.dnc, 3)
    doubled = tree_map(lambda t: t + 2.0, state)
    assert type(doubled) is tdnc.DNCState and type(doubled.access_state) is tacc.AccessState
    assert type(doubled.access_state.linkage) is tadr.TemporalLinkageState
    assert isinstance(doubled.controller_state, list) and isinstance(doubled.controller_state[0], tuple)
    assert all(float(t.min()) == 2.0 for t in tree_leaves(doubled))
    summed = tree_map(torch.add, doubled, doubled)
    assert type(summed.access_state) is tacc.AccessState and float(summed.access_state.usage.max()) == 4.0
    moved = _to_device(doubled, torch.device("cpu"))
    assert type(moved) is tdnc.DNCState and type(moved.access_state.linkage) is tadr.TemporalLinkageState
    assert [tuple(a.shape) for a in tree_leaves(moved)] == [tuple(a.shape) for a in tree_leaves(state)]


def test_fleet_write_rows_keeps_the_dnc_state():
    _, tcfg = _tracker_cfgs()
    state = tdnc.init_dnc_state(tcfg.dnc, 4)
    source = tree_map(lambda t: torch.ones(2, *t.shape[1:]), tdnc.init_dnc_state(tcfg.dnc, 2))
    out = tfleet._write_rows(state, torch.tensor([1, 3]), source)
    assert type(out) is tdnc.DNCState and type(out.access_state.linkage) is tadr.TemporalLinkageState
    for leaf in tree_leaves(out):
        np.testing.assert_array_equal(leaf[[1, 3]].numpy(), 1.0)
        np.testing.assert_array_equal(leaf[[0, 2]].numpy(), 0.0)
    assert float(state.access_state.memory.abs().max()) == 0.0  # out of place


def test_dnc_runs_through_the_trackers():
    """StreamingTracker, FleetTracker (two slots) and the device loop run
    the DNC core, and agree on the same frames."""
    _, tcfg = _tracker_cfgs()
    tcfg = dataclasses.replace(tcfg, feature_depth=512)
    gen = torch.Generator().manual_seed(0)
    vgg = init_vgg_params(gen)
    core = make_core(tcfg)
    params = core.init_params(gen, tcfg.input_depth)
    rs = _rs(11)
    frames = (rs.rand(3, 48, 64, 3) * 255).astype(np.float32)
    region = (20.0, 14.0, 18.0, 16.0)
    trk = StreamingTracker(tcfg, vgg, params, device="cpu")
    trk.init(frames[0], region)
    host = [trk.track(f) for f in frames[1:]]
    fleet = tfleet.FleetTracker(tcfg, vgg, params, capacity=2, device="cpu")
    a, b = fleet.add(frames[0], region), fleet.add(frames[0], region)
    assert type(fleet.state) is tdnc.DNCState
    for t, f in enumerate(frames[1:]):
        out = fleet.step({a: f, b: f})
        np.testing.assert_allclose(out[a], host[t], rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(out[b], host[t], rtol=1e-4, atol=1e-3)
    fleet.remove(a)
    init_fn, step_fn = make_device_track_step(tcfg, core, vgg, params, device="cpu")
    H, W = 48, 64
    x, y, w, h = region
    bbox = np.asarray([[y / (H - 1), x / (W - 1), (y + h) / (H - 1), (x + w) / (W - 1)]], np.float32)
    state = init_fn(frames[0:1], bbox, core.init_state(params, 1))
    assert type(state) is tdnc.DNCState
    for t, f in enumerate(frames[1:]):
        reg, bbox, state = step_fn(f[None], bbox, state)
        np.testing.assert_allclose(reg[0].numpy(), host[t], rtol=1e-4, atol=0.05)
