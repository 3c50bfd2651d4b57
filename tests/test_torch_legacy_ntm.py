"""The legacy NTM on the CPU: utils/misc.py and the legacy memory ops
against the JAX package's functions; legacy_ntm_unroll(_batched) and its
gradients against JAX's from the same weights (interop.py); both executed
reference goldens (tf_goldens_legacy*.npz) at tests/test_tf_parity.py's
tolerance."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntm_tracker_tpu.models import legacy_ntm as jleg
from ntm_tracker_tpu.ops import memory as jmem
from ntm_tracker_tpu.utils import misc as jmisc
from ntm_tracker_tpu_torch.interop import flatten_params, params_from_flat
from ntm_tracker_tpu_torch.models import legacy_ntm as tleg
from ntm_tracker_tpu_torch.ops import memory as tmem
from ntm_tracker_tpu_torch.train.optim import tree_leaves, tree_map
from ntm_tracker_tpu_torch.utils import misc as tmisc

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
# tests/test_tf_parity.py's tolerance for the goldens, and the bound for a
# dozen float32 steps summed in other orders
TOL = 1e-5
# gradients: max |port - jax| <= GRAD_TOL * max |jax|, per tensor
GRAD_TOL = 1e-4
KW = dict(num_features=4, mem_size=16, mem_dim=8, controller_dim=12, controller_layer_size=2,
          read_head_size=2, write_head_size=1)
IN = 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the step is hundreds of small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _both(seed=0):
    jcfg, tcfg = jleg.LegacyNTMConfig(**KW), tleg.LegacyNTMConfig(**KW)
    jp = jleg.init_legacy_params(jax.random.PRNGKey(seed), jcfg, IN)
    return jcfg, tcfg, jp, params_from_flat(flatten_params(jp))


def _t(x):
    return torch.tensor(np.asarray(x))


def test_misc_against_jax():
    rs = np.random.RandomState(0)
    v, k = rs.rand(9).astype(np.float32), rs.rand(3).astype(np.float32)
    np.testing.assert_allclose(tmisc.circular_convolution_1d(_t(v), _t(k)).numpy(),
                               np.asarray(jmisc.circular_convolution_1d(jnp.asarray(v), jnp.asarray(k))), atol=1e-6)
    # batched rows give each row's unbatched result
    vb, kb = rs.rand(3, 9).astype(np.float32), rs.rand(3, 5).astype(np.float32)
    got = tmisc.circular_convolution_1d(_t(vb), _t(kb)).numpy()
    for b in range(3):
        np.testing.assert_allclose(got[b], np.asarray(jmisc.circular_convolution_1d(vb[b], kb[b])), atol=1e-6)
    u, w = rs.rand(4).astype(np.float32), rs.rand(5).astype(np.float32)
    np.testing.assert_array_equal(tmisc.pairwise_add(_t(u), _t(w)).numpy(), np.asarray(jmisc.pairwise_add(u, w)))
    np.testing.assert_array_equal(tmisc.pairwise_add(_t(vb), is_batch=True).numpy(),
                                  np.asarray(jmisc.pairwise_add(vb, is_batch=True)))
    np.testing.assert_array_equal(tmisc.decaying_softmax((2, 5, 3), 1), jmisc.decaying_softmax((2, 5, 3), 1))


def test_legacy_memory_ops_against_jax():
    rs = np.random.RandomState(1)
    m, v = rs.randn(16, 8).astype(np.float32), rs.randn(8).astype(np.float32)
    np.testing.assert_allclose(tmem.smooth_cosine_similarity(_t(m), _t(v)).numpy(),
                               np.asarray(jmem.smooth_cosine_similarity(m, v)), atol=1e-6)
    mb, vb = rs.randn(3, 16, 8).astype(np.float32), rs.randn(3, 8).astype(np.float32)
    got = tmem.smooth_cosine_similarity(_t(mb), _t(vb)).numpy()
    for b in range(3):
        np.testing.assert_allclose(got[b], np.asarray(jmem.smooth_cosine_similarity(mb[b], vb[b])), atol=1e-6)
    x = rs.randn(2, 7).astype(np.float32)
    for s in (-3, 0, 2, 9):
        np.testing.assert_array_equal(tmem.circular_shift(_t(x), s).numpy(), np.asarray(jmem.circular_shift(x, s)))
    np.testing.assert_array_equal(tmem.outer_product(_t(mb[:, 0]), _t(vb)).numpy(),
                                  np.asarray(jmem.outer_product(mb[:, 0], vb)))


def test_init_state_and_step_against_jax():
    jcfg, tcfg, jp, tp = _both()
    jstate, tstate = jleg.init_legacy_state(jp, jcfg), tleg.init_legacy_state(tp, tcfg)
    for key, ref in jstate.items():
        np.testing.assert_allclose(tstate[key].numpy(), np.asarray(ref), atol=1e-7, err_msg=key)
    # the reversed-range raw weights: the first attention peaks at slot 0
    assert (tstate["read_w"].argmax(-1) == 0).all() and (np.diff(tstate["write_w"].numpy(), axis=-1) < 0).all()
    x = np.random.RandomState(2).randn(IN).astype(np.float32)
    tgt = np.ones(4, np.float32)
    jout, jlogit, jnew = jleg.legacy_ntm_step(jp, jcfg, jnp.asarray(x), jnp.asarray(tgt), jstate)
    tout, tlogit, tnew = tleg.legacy_ntm_step(tp, tcfg, _t(x), _t(tgt), tstate)
    np.testing.assert_allclose(tlogit.numpy(), np.asarray(jlogit), atol=TOL)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=TOL)
    for key, ref in jnew.items():
        assert tuple(tnew[key].shape) == ref.shape
        np.testing.assert_allclose(tnew[key].numpy(), np.asarray(ref), atol=TOL, err_msg=key)
    # the sharpen has no +1e-3: each head's weights sum to 1
    np.testing.assert_allclose(tnew["read_w"].sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_batched_unroll_and_gradients_against_jax(remat):
    jcfg, tcfg, jp, tp = _both(seed=3)
    B, T = 3, 5
    rs = np.random.RandomState(4)
    inputs, targets = rs.randn(B, T, IN).astype(np.float32), rs.randn(B, 4).astype(np.float32)
    labels = np.eye(4, dtype=np.float32)[rs.randint(0, 4, (B, T))]

    def jloss(p):
        outs, logits, final = jleg.legacy_ntm_unroll_batched(p, jcfg, jnp.asarray(inputs), jnp.asarray(targets))
        return -jnp.mean(jnp.sum(labels * jnp.log(outs + 1e-8), -1)), (outs, logits, final)

    (jl, (jouts, jlogits, jfinal)), jgrads = jax.value_and_grad(jloss, has_aux=True)(jp)
    live = tree_map(lambda p: p.detach().requires_grad_(), tp)
    outs, logits, final = tleg.legacy_ntm_unroll_batched(live, tcfg, _t(inputs), _t(targets), remat=remat)
    loss = -torch.mean(torch.sum(_t(labels) * torch.log(outs + 1e-8), -1))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=TOL)
    np.testing.assert_allclose(outs.detach().numpy(), np.asarray(jouts), atol=TOL)
    for key, ref in jfinal.items():
        np.testing.assert_allclose(final[key].detach().numpy(), np.asarray(ref), atol=TOL, err_msg=key)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=TOL)
    it = iter(torch.autograd.grad(loss, tree_leaves(live)))
    got, ref = flatten_params(tree_map(lambda _: next(it), live)), flatten_params(jgrads)
    assert got.keys() == ref.keys()
    for key, r in ref.items():
        np.testing.assert_allclose(got[key], r, atol=GRAD_TOL * max(float(np.abs(r).max()), 1e-12), err_msg=key)
    # the learnable initial state gets a gradient (ntm.py:273-332)
    assert float(np.abs(ref["init.M"]).sum()) > 0


def test_unbatched_unroll_is_a_batch_of_one():
    jcfg, tcfg, jp, tp = _both(seed=5)
    rs = np.random.RandomState(6)
    inputs, target = rs.randn(4, IN).astype(np.float32), rs.randn(4).astype(np.float32)
    jouts, jlogits, jfinal = jleg.legacy_ntm_unroll(jp, jcfg, jnp.asarray(inputs), jnp.asarray(target))
    outs, logits, final = tleg.legacy_ntm_unroll(tp, tcfg, _t(inputs), _t(target))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=TOL)
    for key, ref in jfinal.items():
        assert tuple(final[key].shape) == ref.shape
        np.testing.assert_allclose(final[key].numpy(), np.asarray(ref), atol=TOL, err_msg=key)


def _golden_params(g, layers, read_heads, write_heads):
    """The fixture's weights as the legacy tree (test_tf_parity.py's layout)."""
    def head(prefix, is_write):
        parts = ["k", "g", "sw", "beta", "gamma"] + (["erase", "add"] if is_write else [])
        return {f"{part}_{s}": _t(g[f"param_{prefix}_{part}_{s}"]) for part in parts for s in ("w", "b")}

    return {
        "controller": [{gg: {"w": _t(g[f"param_ctrl_{layer}_{gg}_w"]), "b": _t(g[f"param_ctrl_{layer}_{gg}_b"])}
                        for gg in tleg.GATES} for layer in range(layers)],
        "read_heads": [head(f"read{r}", False) for r in range(read_heads)],
        "write_heads": [head(f"write{w}", True) for w in range(write_heads)],
        "out_w": _t(g["param_out_w"]), "out_b": _t(g["param_out_b"]),
        "init": {k: _t(g[f"param_init_{k}"]) for k in ("M", "read_w", "read", "write_w", "output", "hidden")},
    }


@pytest.mark.parametrize("fixture", ["tf_goldens_legacy.npz", "tf_goldens_legacy_variant.npz"])
def test_rollout_matches_executed_reference(fixture):
    g = np.load(os.path.join(FIXTURES, fixture))
    (_steps, _input_size, num_features, mem_size, mem_dim, shift_range, controller_dim, layers, read_heads,
     write_heads) = [int(x) for x in g["config"]]
    cfg = tleg.LegacyNTMConfig(num_features=num_features, mem_size=mem_size, mem_dim=mem_dim,
                               shift_range=shift_range, controller_dim=controller_dim,
                               controller_layer_size=layers, write_head_size=write_heads,
                               read_head_size=read_heads)
    params = _golden_params(g, layers, read_heads, write_heads)
    outs, logits, final = tleg.legacy_ntm_unroll(params, cfg, _t(g["inputs"]), _t(g["target"]))
    np.testing.assert_allclose(logits.numpy(), g["logits"], atol=TOL)
    np.testing.assert_allclose(outs.numpy(), g["outputs"], atol=TOL)
    for key in ("M", "read_w", "write_w", "read", "output", "hidden"):
        np.testing.assert_allclose(final[key].numpy(), g[f"final_{key}"], atol=TOL, err_msg=key)


def test_init_params_shapes_match_jax():
    jcfg, tcfg = jleg.LegacyNTMConfig(**KW), tleg.LegacyNTMConfig(**KW)
    ref = flatten_params(jleg.init_legacy_params(jax.random.PRNGKey(0), jcfg, IN))
    got = flatten_params(tleg.init_legacy_params(tcfg, IN, torch.Generator().manual_seed(0)))
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in ref.items()}
    np.testing.assert_array_equal(got["init.read_w"], ref["init.read_w"])
