"""B3, the single-step addressing kernel (ops/kernels/addressing.py), on
the CPU: its plain version against JAX's Pallas kernel run in interpret
mode (as tests/test_pallas_addressing.py runs it), the cell step and the
unroll with NTMConfig.use_pallas against JAX's, and the routes that must
(and must not) reach it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ntm_tracker_tpu.ops.pallas.addressing as jfa
from ntm_tracker_tpu.config import NTMConfig as JNTMConfig
from ntm_tracker_tpu.models import ntm_cell as jcell
from ntm_tracker_tpu.models.ntm_tracker import ntm_tracker_unroll as jax_unroll
from ntm_tracker_tpu_torch.config import NTMConfig, TrackerConfig
from ntm_tracker_tpu_torch.interop import flatten_ntm_params, ntm_params_from_flat
from ntm_tracker_tpu_torch.models import ntm_cell as tcell
from ntm_tracker_tpu_torch.models.core import make_core
from ntm_tracker_tpu_torch.models.ntm_tracker import ntm_tracker_unroll
from ntm_tracker_tpu_torch.ops.kernels import addressing, scan_bptt, scan_cell
from ntm_tracker_tpu_torch.tracking.tracker import build_frame_step
from ntm_tracker_tpu_torch.utils import profiling

# tests/test_pallas_addressing.py's bound for the kernel against the jnp math
KERNEL_ATOL = 2e-6
# the cell step with and without the flag: the same math, other sum orders
STEP_ATOL = 1e-6
# tests/test_pallas_addressing.py:129-161's gradient bound through the unroll
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5

CELL_KW = dict(output_dim=3, mem_size=16, mem_dim=8, controller_hidden_size=16, read_head_size=2)


def _raw(seed, B, H, D, W, S, N=16):
    """tests/test_pallas_addressing.py:_raw_params, as numpy."""
    r = np.random.RandomState(seed)
    out = dict(k=r.randn(B, H, D), beta=r.randn(B, H), g=r.randn(B, H), sw=r.randn(B, H, S),
               gamma=r.randn(B, H), erase=r.randn(B, W, D), add=r.randn(B, W, D),
               M_prev=r.randn(B, N, D) * 0.5)
    out = {k: v.astype(np.float32) for k, v in out.items()}
    out["w_prev"] = np.asarray(jax.nn.softmax(jnp.asarray(r.randn(B, H, N)), -1), np.float32)
    return out


def _both(p, R, write_first, slotwise=False):
    order = ("k", "beta", "g", "sw", "gamma", "erase", "add", "M_prev", "w_prev")
    want = jfa.fused_ntm_addressing(*[jnp.asarray(p[k]) for k in order], read_heads=R,
                                    write_first=write_first, slotwise=slotwise, interpret=True)
    got = addressing.fused_ntm_addressing(*[torch.tensor(p[k]) for k in order], read_heads=R,
                                          write_first=write_first, slotwise=slotwise)
    return got, want


@pytest.mark.parametrize("slotwise", [False, True])
@pytest.mark.parametrize("write_first", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_matches_jax_kernel(seed, write_first, slotwise):
    B, H, D, W, S = 3, 5, 8, 1, 3
    got, want = _both(_raw(seed, B, H, D, W, S), H - W, write_first, slotwise)
    for name, a, b in zip(("M", "w", "read"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=KERNEL_ATOL, err_msg=name)


def test_multi_write_heads_match_jax_kernel():
    B, H, D, W, S = 2, 4, 6, 2, 5
    got, want = _both(_raw(3, B, H, D, W, S), H - W, False)
    for name, a, b in zip(("M", "w", "read"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=KERNEL_ATOL, err_msg=name)


def test_cpu_tensors_never_launch():
    before = profiling.counter("launches.fused_ntm_addressing")
    _both(_raw(4, 2, 5, 8, 1, 3), 4, False)
    assert profiling.counter("launches.fused_ntm_addressing") == before == 0


def _cell_pair(**over):
    kw = dict(CELL_KW, **over)
    jcfg = JNTMConfig(**kw)
    jp = jcell.init_ntm_params(jax.random.PRNGKey(0), jcfg, 6)
    return jcfg, NTMConfig(**kw), jp, ntm_params_from_flat(flatten_ntm_params(jp))


@pytest.fixture
def jax_kernel_interpreted(monkeypatch):
    """Route JAX's use_pallas path through interpret mode on the CPU
    (tests/test_pallas_addressing.py:109-121)."""
    orig = jfa.fused_ntm_addressing

    def interp(*args, **kw):
        return orig(*args, **dict(kw, interpret=True))

    monkeypatch.setattr(jfa, "fused_ntm_addressing", interp)


@pytest.mark.parametrize("write_first", [False, True])
def test_cell_step_with_flag_matches_jax_and_flag_off(jax_kernel_interpreted, write_first):
    jcfg, tcfg, jp, tp = _cell_pair(write_first=write_first)
    jcfg_p, tcfg_p = (dataclasses.replace(c, use_pallas=True) for c in (jcfg, tcfg))
    x = np.random.RandomState(1).randn(2, 6).astype(np.float32)
    jstate = jcell.init_ntm_state(jp, jcfg, 2)
    _, jl, js = jcell.ntm_cell_step(jp, jcfg_p, jnp.asarray(x), jstate)
    tstate = tcell.init_ntm_state(tp, tcfg, 2)
    _, tl, ts = tcell.ntm_cell_step(tp, tcfg_p, torch.tensor(x), tstate)
    _, ol, os_ = tcell.ntm_cell_step(tp, tcfg, torch.tensor(x), tstate)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=STEP_ATOL)
    for key in ("M", "w", "read"):
        np.testing.assert_allclose(ts[key].numpy(), np.asarray(js[key]), atol=KERNEL_ATOL, err_msg=key)
        np.testing.assert_allclose(ts[key].numpy(), os_[key].numpy(), atol=STEP_ATOL, err_msg=key)
    np.testing.assert_array_equal(tl.numpy(), ol.numpy())


def test_with_debug_takes_the_eager_path(monkeypatch):
    _, tcfg, _, tp = _cell_pair(use_pallas=True)
    calls = []
    monkeypatch.setattr(tcell, "fused_ntm_addressing", lambda *a, **k: calls.append(1))
    x = torch.tensor(np.random.RandomState(2).randn(2, 6).astype(np.float32))
    out = tcell.ntm_cell_step(tp, tcfg, x, tcell.init_ntm_state(tp, tcfg, 2), with_debug=True)
    assert len(out) == 4 and not calls
    assert {"similarity", "w_conv", "M_erase", "M_write"} <= set(out[3])
    plain = tcell.ntm_cell_step(tp, dataclasses.replace(tcfg, use_pallas=False), x,
                                tcell.init_ntm_state(tp, tcfg, 2), with_debug=True)
    for key in ("M", "w", "read"):
        assert torch.equal(out[2][key], plain[2][key])


@pytest.mark.parametrize("remat", [False, "full"])
def test_unroll_grads_with_flag_match_jax(jax_kernel_interpreted, remat):
    kw = dict(output_dim=2, mem_size=16, mem_dim=8, controller_hidden_size=16, read_head_size=2)
    jcfg, tcfg = JNTMConfig(**kw, use_pallas=True), NTMConfig(**kw, use_pallas=True)
    jp = jcell.init_ntm_params(jax.random.PRNGKey(0), JNTMConfig(**kw), 6)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 5, 6)), np.float32)

    def jloss(p):
        _, logits, _ = jax_unroll(p, jcfg, jnp.asarray(x), remat=False)
        return jnp.sum(jnp.tanh(logits) ** 2)

    jg = flatten_ntm_params(jax.grad(jloss)(jp))
    tp = ntm_params_from_flat(flatten_ntm_params(jp))
    names = list(jg)
    leaves = [tp["controller"][int(n[11:n.index("]")])][n.split(".")[-1]] if n.startswith("controller[")
              else tp[n] for n in names]
    for t in leaves:
        t.requires_grad_()
    _, logits, _ = ntm_tracker_unroll(tp, tcfg, torch.tensor(x), remat=remat)
    grads = torch.autograd.grad(torch.sum(torch.tanh(logits) ** 2), leaves)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[name]), rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)


def _spy(monkeypatch):
    calls = []
    real = tcell.fused_ntm_addressing

    def spy(*a, **k):
        calls.append(a[0].shape[0])
        return real(*a, **k)

    monkeypatch.setattr(tcell, "fused_ntm_addressing", spy)
    return calls


def test_flagged_unroll_and_plain_frame_step_reach_b3(monkeypatch):
    """C1: use_pallas reaches the addressing kernel on every per-step
    route: T calls for a T-step unroll, 65 for the frame step's plain
    route (64 feature tokens and the delimiter)."""
    calls = _spy(monkeypatch)
    _, tcfg, _, tp = _cell_pair(use_pallas=True)
    x = torch.tensor(np.random.RandomState(3).randn(2, 7, 6).astype(np.float32))
    ntm_tracker_unroll(tp, tcfg, x)
    assert calls == [2] * 7
    core = make_core(TrackerConfig(ntm=tcfg))
    calls.clear()
    core.unroll(tp, x, remat=False)
    assert calls == [2] * 7

    calls.clear()
    cfg = TrackerConfig(ntm=NTMConfig(use_pallas=True), fused_inference=False)
    core = make_core(cfg)
    gen = torch.Generator().manual_seed(0)
    from ntm_tracker_tpu_torch.models.vgg import init_vgg_params

    vgg, params = init_vgg_params(gen), core.init_params(gen, cfg.input_depth)
    first, _ = build_frame_step(cfg, core, vgg, params, device="cpu")
    crops = torch.tensor(np.random.RandomState(4).uniform(-100, 100, (2, 224, 224, 3)).astype(np.float32))
    first(crops, None, core.init_state(params, 2))
    assert calls == [2] * cfg.tokens_per_frame


def test_whole_sequence_plain_versions_strip_the_flag(monkeypatch):
    """B1's and B2's plain versions ignore use_pallas, as the kernels do
    (and as JAX's references do): no addressing call, the flag-off numbers."""
    calls = _spy(monkeypatch)
    _, tcfg, _, tp = _cell_pair(use_pallas=True)
    x = torch.tensor(np.random.RandomState(5).randn(2, 4, 6).astype(np.float32))
    state = tcell.init_ntm_state(tp, tcfg, 2)
    off = dataclasses.replace(tcfg, use_pallas=False)
    for fn in (scan_cell.ntm_scan_fused_reference, scan_bptt.ntm_scan_fused_bptt_reference,
               scan_cell.ntm_scan_fused, scan_bptt.ntm_scan_fused_bptt):
        logits, _ = fn(tp, tcfg, x, state)
        assert torch.equal(logits, fn(tp, off, x, state)[0])
    assert calls == []
