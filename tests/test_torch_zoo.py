"""train/zoo.py on the CPU, every function against the JAX package's on
the same numpy-seeded inputs and weights (interop.py): the compressor, the
sequential stream and its CE, the whole-frame tokens and CE (plain and
two-step), the LSTM baseline and its gradients, both sanity checks (the
PCA at a size where sklearn takes an exact solver), find_validation_batch's
order, heatmap_loss_fn both ways, and serialize.heatmap_loss."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntm_tracker_tpu.config import NTMConfig as JNTMConfig
from ntm_tracker_tpu.models.ntm_cell import init_ntm_params
from ntm_tracker_tpu.train import serialize as jser
from ntm_tracker_tpu.train import zoo as jzoo
from ntm_tracker_tpu_torch.config import NTMConfig as TNTMConfig
from ntm_tracker_tpu_torch.interop import flatten_params, params_from_flat
from ntm_tracker_tpu_torch.train import serialize as tser
from ntm_tracker_tpu_torch.train import zoo as tzoo
from ntm_tracker_tpu_torch.train.optim import tree_leaves, tree_map

B, L, F, C = 2, 3, 4, 6
# float32 on both sides, in other orders
TOL = 1e-5
# gradients: max |port - jax| <= GRAD_TOL * max |jax|, per tensor
GRAD_TOL = 1e-4


def feats(seed=0):
    return np.random.RandomState(seed).rand(B, L, F, C).astype(np.float32)


def gts(seed=1):
    g = np.random.RandomState(seed).rand(B, L, F).astype(np.float32)
    return g / g.sum(-1, keepdims=True)


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy() if isinstance(got, torch.Tensor) else got,
                               np.asarray(want), atol=tol, rtol=tol)


def test_compressor():
    w = np.asarray(jzoo.init_compressor(jax.random.PRNGKey(0), C, 3))
    _close(tzoo.compress_features(_t(feats()), _t(w)), jzoo.compress_features(feats(), w))
    tw = tzoo.init_compressor(C, 3, torch.Generator().manual_seed(0))
    limit = np.sqrt(6.0 / (C + 3))
    assert tuple(tw.shape) == (C, 3) and float(tw.abs().max()) <= limit


def test_sequential_stream_and_loss():
    toks = tzoo.serialize_sequential_tokens(_t(feats()), _t(gts()[:, 0]))
    ref = jzoo.serialize_sequential_tokens(feats(), gts()[:, 0])
    assert toks.shape == ref.shape == (B, tzoo.sequential_total_steps(F, L), C + 3)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(ref))
    T = tzoo.sequential_total_steps(F, L)
    logits = np.random.RandomState(2).randn(B, T, 1).astype(np.float32)
    np.testing.assert_array_equal(tzoo.sequential_gather(_t(logits), F).numpy(),
                                  np.asarray(jzoo.sequential_gather(logits, F)))
    _close(tzoo.sequential_ce_loss(_t(logits), _t(gts()), F), jzoo.sequential_ce_loss(logits, gts(), F))


@pytest.mark.parametrize("two_step", [False, True], ids=["plain", "two_step"])
def test_whole_frame_tokens_and_loss(two_step):
    toks = tzoo.whole_frame_tokens(_t(feats()), _t(gts()[:, 0]), two_step)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jzoo.whole_frame_tokens(feats(), gts()[:, 0], two_step)))
    steps, out = (2 * L - 1, F + 1) if two_step else (L, F)
    logits = np.random.RandomState(3).randn(B, steps, out).astype(np.float32)
    _close(tzoo.whole_frame_ce_loss(_t(logits), _t(gts()), two_step),
           jzoo.whole_frame_ce_loss(logits, gts(), two_step))


def test_lstm_baseline_and_gradients():
    D = 3
    jp = jzoo.init_lstm_baseline(jax.random.PRNGKey(0), F, D, 16, 2)
    tp = params_from_flat(flatten_params(jp))
    shapes = {k: v.shape for k, v in flatten_params(tzoo.init_lstm_baseline(F, D, 16, 2)).items()}
    assert shapes == {k: v.shape for k, v in flatten_params(jp).items()}
    cf = np.random.RandomState(3).rand(B, L, F, D).astype(np.float32)
    _close(tzoo.lstm_baseline_forward(tp, _t(cf), _t(gts()[:, 0])), jzoo.lstm_baseline_forward(jp, cf, gts()[:, 0]))
    jl, jg = jax.value_and_grad(jzoo.lstm_baseline_loss)(jp, cf, gts()[:, 0], gts())
    live = tree_map(lambda p: p.detach().requires_grad_(), tp)
    loss = tzoo.lstm_baseline_loss(live, _t(cf), _t(gts()[:, 0]), _t(gts()))
    _close(loss, jl)
    fill = iter(torch.autograd.grad(loss, tree_leaves(live)))
    got, ref = flatten_params(tree_map(lambda _: next(fill), live)), flatten_params(jg)
    for key, r in ref.items():
        np.testing.assert_allclose(got[key], r, atol=GRAD_TOL * np.abs(r).max(), err_msg=key)


def test_sanity_check_similarity():
    f, g = feats(4), gts(5)
    _close(tzoo.sanity_check_similarity(_t(f), _t(g)), jzoo.sanity_check_similarity(jnp.asarray(f), jnp.asarray(g)))
    w = np.random.RandomState(6).randn(C, 3).astype(np.float32)
    _close(tzoo.sanity_check_similarity(_t(f), _t(g), _t(w)),
           jzoo.sanity_check_similarity(jnp.asarray(f), jnp.asarray(g), jnp.asarray(w)))
    # location 2 repeats frame 0's target feature in every frame: the peak
    target = np.zeros((B, L, F), np.float32)
    target[:, 0, 2] = 1.0
    f[:, :, 2] = f[:, :1, 2]
    assert (tzoo.sanity_check_similarity(_t(f), _t(target)).argmax(-1) == 2).all()


def test_sanity_check_pca_matches_sklearn():
    """96 rows of 6 features: sklearn's svd_solver="auto" takes an exact
    solver at this size (no randomized SVD)."""
    f = np.random.RandomState(7).rand(2, 3, 16, C).astype(np.float32)
    g = np.random.RandomState(8).rand(2, 3, 16).astype(np.float32)
    for dim in (2, 4):
        _close(tzoo.sanity_check_pca(f, _t(g), dim), jzoo.sanity_check_pca(f, jnp.asarray(g), dim), tol=1e-4)


def test_find_validation_batch_order(tmp_path):
    for name, n in [("train_a", 20), ("train_b", 20), ("val_b", 20), ("val_c", 20), ("val_d", 25)]:
        d = tmp_path / name
        d.mkdir()
        for i in range(n):
            (d / f"{i:06d}.txt").write_text("x")
    for step in (0, 150, 300):
        got = tzoo.find_validation_batch(str(tmp_path), target_step=step, min_length=20, seed=7,
                                         dump_path=str(tmp_path / "port.pkl"))
        want = jzoo.find_validation_batch(str(tmp_path), target_step=step, min_length=20, seed=7)
        assert got == want
    assert (tmp_path / "port.pkl").stat().st_size > 0


@pytest.mark.parametrize("sequential", [False, True], ids=["frame", "sequential"])
def test_heatmap_loss_fn(sequential):
    out = 1 if sequential else F
    kw = dict(output_dim=out, mem_size=8, mem_dim=4, controller_hidden_size=16, read_head_size=1)
    jp = init_ntm_params(jax.random.PRNGKey(0), JNTMConfig(**kw), 3 + 3 if sequential else 3 + 2)
    w = np.random.RandomState(9).randn(C, 3).astype(np.float32) * 0.3
    want = jzoo.heatmap_loss_fn(jp, JNTMConfig(**kw), jnp.asarray(feats()), jnp.asarray(gts()), jnp.asarray(w),
                                sequential=sequential)
    got = tzoo.heatmap_loss_fn(params_from_flat(flatten_params(jp)), TNTMConfig(**kw), _t(feats()), _t(gts()), _t(w),
                               sequential=sequential)
    _close(got, want)


def test_heatmap_loss():
    logits = np.random.RandomState(10).randn(B, L * (F + 1), F).astype(np.float32)
    _close(tser.heatmap_loss(_t(logits), _t(gts()), F), jser.heatmap_loss(logits, gts(), F))
