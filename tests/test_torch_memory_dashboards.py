"""The memory dashboards on the CPU: models/core.unroll_states for both
cores (stride dividing T and not, full_logits) against the JAX package's,
from the same weights (interop.py) and inputs; state_view; and the
experiments' memory_states and eval_with_views (one forward for the loss
and the views), whose aux equals make_eval_step's, for the offset tracker
and both heatmap serializations."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntm_tracker_tpu import config as jconfig
from ntm_tracker_tpu.models import core as jcore
from ntm_tracker_tpu.train import experiments as jexp
from ntm_tracker_tpu_torch import config as tconfig
from ntm_tracker_tpu_torch.interop import flatten_params
from ntm_tracker_tpu_torch.models import core as tcore
from ntm_tracker_tpu_torch.train import experiments as texp
from ntm_tracker_tpu_torch.train.optim import tree_leaves

from tests.test_torch_dnc import _assert_dnc_state
from tests.torch_lab_helpers import to_port

# float32 over a dozen cell steps, summed in other orders
TOL = 1e-5
POINTS = ((1, 1), (1, 2), (2, 1), (2, 2))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the cores' steps are hundreds of small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(core, **over):
    def build(mod):
        return mod.TrackerConfig(
            core=core,
            ntm=mod.NTMConfig(mem_size=8, mem_dim=4, controller_hidden_size=12, read_head_size=2, write_head_size=1),
            dnc=mod.DNCConfig(memory_size=8, word_size=4, hidden_size=12, num_reads=2, num_writes=1),
            train=mod.TrainConfig(sequence_length=2, batch_size=2), **over)
    return build(jconfig), build(tconfig)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _match_slots(views, jviews):
    """The DNC's views with each snapshot's memory slots put in the order
    of JAX's: tied slots may be labeled differently on the two sides (see
    tests/test_torch_dnc.py), so each of JAX's slots takes the port's slot
    with the closest (memory row, head weights) signature."""
    M, w = _np(views["M"]).copy(), _np(views["w"]).copy()
    jM, jw = np.asarray(jviews["M"]), np.asarray(jviews["w"])
    for b in range(M.shape[0]):
        for s in range(M.shape[1]):
            g = np.concatenate([M[b, s], w[b, s].T], axis=1)
            want = np.concatenate([jM[b, s], jw[b, s].T], axis=1)
            free, perm = list(range(g.shape[0])), []
            for j in range(g.shape[0]):
                i = min(free, key=lambda i: float(np.abs(g[i] - want[j]).max()))
                perm.append(i)
                free.remove(i)
            M[b, s], w[b, s] = M[b, s][perm], w[b, s][:, perm]
    return {"M": M, "w": w, "read": _np(views["read"])}


@pytest.mark.parametrize("core_name", ["ntm", "dnc"])
@pytest.mark.parametrize("T,stride,full", [(12, 3, False), (10, 3, False), (10, 4, True), (7, 7, True), (5, 1, False)],
                         ids=["divides", "tail", "tail_full_logits", "one_chunk", "every_step"])
def test_unroll_states_against_jax(core_name, T, stride, full):
    jcfg, tcfg = _cfgs(core_name)
    jc, tc = jcore.make_core(jcfg), tcore.make_core(tcfg)
    jparams = jc.init_params(jax.random.PRNGKey(0), 6)
    params = to_port(jparams)
    inputs = np.random.RandomState(T + stride).randn(2, T, 6).astype(np.float32)
    jlogits, jviews, jfinal = jcore.unroll_states(jc, jparams, jnp.asarray(inputs), stride=stride, full_logits=full)
    logits, views, final = tcore.unroll_states(tc, params, torch.tensor(inputs), stride=stride, full_logits=full)
    assert tuple(logits.shape) == jlogits.shape == ((2, T, 2) if full else (2, T // stride, 2))
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), atol=TOL)
    matched = _match_slots(views, jviews) if core_name == "dnc" else views
    for key in ("M", "w", "read"):
        assert tuple(views[key].shape) == jviews[key].shape, key
        np.testing.assert_allclose(_np(matched[key]), np.asarray(jviews[key]), atol=TOL, err_msg=key)
    if core_name == "dnc":
        _assert_dnc_state(final, jfinal, TOL)
    else:
        got, want = flatten_params(final), flatten_params(jfinal)
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_allclose(got[key], want[key], atol=TOL, err_msg=key)
    # the final state is the plain unroll's, the last snapshot its view
    _, plain = tc.unroll(params, torch.tensor(inputs))
    for got, want in zip(tree_leaves(final), tree_leaves(plain)):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    if T % stride == 0:
        for key, v in tc.state_view(final).items():
            assert torch.equal(views[key][:, -1], v)
    with pytest.raises(ValueError, match="out of range"):
        tcore.unroll_states(tc, params, torch.tensor(inputs), stride=T + 1)


def _exp_cfgs(**ntm):
    def build(mod):
        return mod.TrackerConfig(
            core="ntm", ntm=mod.NTMConfig(mem_size=8, mem_dim=4, controller_hidden_size=12, read_head_size=2, **ntm),
            data=mod.DataConfig(crop_size=32, gt_width=2), train=mod.TrainConfig(sequence_length=2, batch_size=2),
            num_features=4, feature_points=POINTS)
    return build(jconfig), build(tconfig)


def test_offsets_memory_states_and_eval_with_views():
    jcfg, tcfg = _exp_cfgs()
    jx, tx = jexp.OffsetExperiment(jcfg, None), texp.OffsetExperiment(tcfg, None, device="cpu")
    jparams, _ = jx.init(jax.random.PRNGKey(1))
    params = to_port(jparams)
    batch = texp.synthetic_cached_batch(tcfg, np.random.RandomState(0))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    views = tx.memory_states(params, batch, max_snapshots=4)
    jviews = jx.memory_states(jparams, jbatch, max_snapshots=4)
    # T = 2 * 5 = 10: stride ceil(10 / 4) = 3, floor(10 / 3) = 3 snapshots
    assert views["M"].shape[1] == 3 and tuple(views["M"].shape[2:]) == (8, 4)
    aux, views2 = tx.eval_with_views(params, batch, max_snapshots=4)
    jaux, _ = jx.eval_with_views(jparams, jbatch, max_snapshots=4)
    ref = tx.make_eval_step()(params, batch)
    assert set(aux) == set(ref) == {"loss", "pred_offsets"}
    for key in aux:
        torch.testing.assert_close(aux[key], ref[key], atol=1e-6, rtol=0)
        np.testing.assert_allclose(_np(aux[key]), np.asarray(jaux[key]), atol=TOL)
    for key in views:
        torch.testing.assert_close(views2[key], views[key], atol=1e-6, rtol=0)
        np.testing.assert_allclose(_np(views[key]), np.asarray(jviews[key]), atol=TOL)


@pytest.mark.parametrize("serialization", ["frame", "sequential"])
def test_heatmap_eval_with_views(serialization):
    """eval_with_views takes the heatmap loss, not the offsets loss (whose
    gather does not fit the heatmap streams)."""
    jcfg, tcfg = _exp_cfgs(output_dim=1 if serialization == "sequential" else 4)
    jx = jexp.HeatmapExperiment(jcfg, None, serialization=serialization, compress_dim=3)
    tx = texp.HeatmapExperiment(tcfg, None, serialization=serialization, compress_dim=3, device="cpu")
    jparams, _ = jx.init(jax.random.PRNGKey(2))
    params = to_port(jparams)
    batch = texp.synthetic_cached_batch(tcfg, np.random.RandomState(1))
    aux, views = tx.eval_with_views(params, batch, max_snapshots=4)
    jaux, jviews = jx.eval_with_views(jparams, {k: jnp.asarray(v) for k, v in batch.items()}, max_snapshots=4)
    ref = tx.make_eval_step()(params, batch)
    torch.testing.assert_close(aux["loss"], ref["loss"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=TOL)
    assert views["M"].shape[1] <= 4 and views["M"].shape == jviews["M"].shape
    np.testing.assert_allclose(_np(views["w"]), np.asarray(jviews["w"]), atol=TOL)
