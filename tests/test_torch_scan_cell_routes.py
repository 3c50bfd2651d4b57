"""B1's two CUDA routes, through their plain versions on the CPU: the split
product (the token projection plus the recurrent part, as both routes
compute every gate) and the cluster route's emulation (each CTA's slices
of the weights, its gates and head-linear columns, gathered step by step)
against the JAX package's Pallas kernel in interpret mode; the slicing and
its inverse; the route rule; and the refusal of CUDA tensors without a
card. The kernels themselves are held against the plain version on the
card by chip_smoke.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ntm_tracker_tpu.config import NTMConfig as JNTMConfig
from ntm_tracker_tpu.models.ntm_cell import init_ntm_params, init_ntm_state as jinit_state
from ntm_tracker_tpu.ops.pallas.scan_cell import ntm_scan_fused as jax_scan_fused
from ntm_tracker_tpu_torch.config import NTMConfig
from ntm_tracker_tpu_torch.interop import flatten_ntm_params, ntm_params_from_flat
from ntm_tracker_tpu_torch.models.ntm_cell import head_param_sizes, init_ntm_state
from ntm_tracker_tpu_torch.models.ntm_cell import init_ntm_params as init_torch_params
from ntm_tracker_tpu_torch.ops.kernels import scan_bptt
from ntm_tracker_tpu_torch.ops.kernels.scan_cell import (
    CLUSTER_SIZE,
    MAX_SMEM_BYTES,
    cluster_scan_reference,
    cluster_smem_bytes,
    cluster_weight_slices,
    cluster_weights_from_slices,
    ntm_scan_fused,
    scan_route,
    split_projection_reference,
)

B, T, IN = 3, 7, 10
CONFIGS = {
    # the flagship's structure (one layer, 4 read heads and 1 write head,
    # shift range 1) at narrow widths: P = 86 head-linear columns, split
    # 22 + 22 + 22 + 20 over 4 CTAs
    "flagship_shape": dict(output_dim=2, mem_size=16, mem_dim=8, controller_hidden_size=16,
                           read_head_size=4, write_head_size=1),
    # two layers, two write heads, shift range 2, read after the write;
    # Hc = 10 hidden units split 3 + 3 + 3 + 1 over 4 CTAs
    "two_layer_writefirst": dict(output_dim=3, mem_size=16, mem_dim=8, controller_hidden_size=10,
                                 controller_num_layers=2, read_head_size=2, write_head_size=2,
                                 shift_range=2, write_first=True),
}
# float32: both sides sum in float32 in other orders over 7 steps
F32_TOL = 1e-5
# bf16: both round every matmul result to bf16; a sum on the other side of
# a rounding boundary flips one bf16 ulp (2^-8 relative), carried forward
BF16_TOL = 5e-2


def _params(name):
    """(torch config, JAX params, the same params in torch, tokens), made
    from a seed, with every bias nudged off zero."""
    kw = CONFIGS[name]
    jcfg = JNTMConfig(**kw)
    rs = np.random.RandomState(7)
    jp = jax.tree.map(lambda a: jnp.asarray(np.asarray(a) + rs.uniform(-0.1, 0.1, np.shape(a)).astype(np.float32)),
                      init_ntm_params(jax.random.PRNGKey(3), jcfg, IN))
    tokens = rs.uniform(-1, 1, (B, T, IN)).astype(np.float32)
    return NTMConfig(**kw), jcfg, jp, ntm_params_from_flat(flatten_ntm_params(jp)), tokens


@functools.lru_cache(maxsize=None)
def _jax_reference(name, bf16):
    """JAX's Pallas kernel in interpret mode: (logits, final state) as numpy."""
    _, jcfg, jp, _, tokens = _params(name)
    logits, state = jax_scan_fused(jp, jcfg, jnp.asarray(tokens), jinit_state(jp, jcfg, B), interpret=True,
                                   compute_dtype=jnp.bfloat16 if bf16 else None)
    return np.asarray(logits), jax.tree.map(np.asarray, state)


def _compare(logits, state, ref, atol):
    ref_logits, ref_state = ref
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=atol)
    for key in ("M", "w", "read"):
        np.testing.assert_allclose(state[key].numpy(), ref_state[key], atol=atol, err_msg=key)
    for (c, h), (rc, rh) in zip(state["controller_state"], ref_state["controller_state"]):
        np.testing.assert_allclose(c.numpy(), rc, atol=atol)
        np.testing.assert_allclose(h.numpy(), rh, atol=atol)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_split_product_matches_pallas_interpret(name, bf16):
    # C = 1: every gate is the projection's row plus [read | h] W0[IN:]
    tcfg, _, _, tp, tokens = _params(name)
    logits, state = cluster_scan_reference(tp, tcfg, torch.tensor(tokens), init_ntm_state(tp, tcfg, B), 1,
                                           torch.bfloat16 if bf16 else None)
    _compare(logits, state, _jax_reference(name, bf16), BF16_TOL if bf16 else F32_TOL)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("C", [2, 4])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_cluster_emulation_matches_pallas_interpret(name, C, bf16):
    tcfg, _, _, tp, tokens = _params(name)
    logits, state = cluster_scan_reference(tp, tcfg, torch.tensor(tokens), init_ntm_state(tp, tcfg, B), C,
                                           torch.bfloat16 if bf16 else None)
    _compare(logits, state, _jax_reference(name, bf16), BF16_TOL if bf16 else F32_TOL)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_split_projection(bf16):
    tcfg, _, _, tp, tokens = _params("flagship_shape")
    kernel, bias = tp["controller"][0]["kernel"], tp["controller"][0]["bias"]
    got = split_projection_reference(torch.tensor(tokens), kernel, bias, torch.bfloat16 if bf16 else None)
    x = torch.tensor(tokens).reshape(B * T, IN)
    if bf16:
        # the rounded operands' product, without the bias (added after each
        # gate's whole sum is rounded)
        want = x.to(torch.bfloat16).double() @ kernel[:IN].to(torch.bfloat16).double()
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    else:
        np.testing.assert_array_equal(got.numpy(), scan_bptt.token_projection_reference(
            torch.tensor(tokens), kernel, bias).numpy())
    assert tuple(got.shape) == (B * T, 4 * tcfg.controller_hidden_size)


@pytest.mark.parametrize("C", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_weight_slices_round_trip(name, C):
    tcfg, _, _, tp, _ = _params(name)
    slices = cluster_weight_slices(tp, tcfg, C)
    back = cluster_weights_from_slices(slices, tcfg)
    for layer, orig in zip(back["controller"], tp["controller"]):
        rows = layer["kernel"].shape[0]
        assert torch.equal(layer["kernel"], orig["kernel"][orig["kernel"].shape[0] - rows:])
        assert torch.equal(layer["bias"], orig["bias"])
    assert torch.equal(back["heads_w"], tp["heads_w"]) and torch.equal(back["heads_b"], tp["heads_b"])
    # layer 0's slices hold the recurrent rows [read | h] only
    R, D, Hc = tcfg.read_head_size, tcfg.mem_dim, tcfg.controller_hidden_size
    assert back["controller"][0]["kernel"].shape[0] == R * D + Hc
    # every unit and head column held by exactly one CTA, in order
    assert sum(sl["units"][1] for sl in slices) == Hc
    assert [sl["cols"][0] for sl in slices if sl["cols"][1]] == np.cumsum(
        [0] + [sl["cols"][1] for sl in slices if sl["cols"][1]])[:-1].tolist()


@pytest.mark.parametrize("name, C, units, cols", [
    # the flagship: Hc = 200, P = 170 at the cluster size of the route
    ("flagship", 8, [25] * 8, [22] * 7 + [16]),
    ("flagship_shape", 4, [4] * 4, [22, 22, 22, 20]),
    ("two_layer_writefirst", 4, [3, 3, 3, 1], [24] * 4),
    ("two_layer_writefirst", 8, [2] * 5 + [0] * 3, [12] * 8),
])
def test_uneven_slices(name, C, units, cols):
    if name == "flagship":
        tcfg = NTMConfig()
        tp = init_torch_params(tcfg, 514, torch.Generator().manual_seed(0))
    else:
        tcfg, _, _, tp, _ = _params(name)
    slices = cluster_weight_slices(tp, tcfg, C)
    assert [sl["units"][1] for sl in slices] == units
    assert [sl["cols"][1] for sl in slices] == cols
    assert sum(cols) == sum(head_param_sizes(tcfg).values())
    # a CTA's gate rows past its units are zero
    U = slices[-1]["lstm"][0].shape[0] // 4
    for sl in slices:
        n = sl["units"][1]
        for q in range(4):
            assert not sl["lstm"][0][q * U + n:(q + 1) * U].any()


@pytest.mark.parametrize("B_, sms, smem, clusters, route", [
    (1, 132, 166864, 15, "cluster"),      # the frame step at the flagship config on an H100 SXM
    (15, 132, 166864, 15, "cluster"),     # one wave of 15 clusters of 8
    (16, 132, 166864, 15, "cluster"),     # two waves
    (45, 132, 166864, 15, "cluster"),     # three waves still beat the tile route (PERF.md)
    (46, 132, 166864, 15, "tile"),        # four waves
    (64, 132, 166864, 15, "tile"),
    (256, 132, 166864, 15, "tile"),       # the eval step
    (1, 132, 338488, None, "tile"),       # two layers, two write heads: the slices do not fit
    (48, 132, 166864, None, "cluster"),   # off the card: 132 // 8 = 16 clusters a wave
    (49, 132, 166864, None, "tile"),
    (1, 132, MAX_SMEM_BYTES, 15, "cluster"),
    (1, 132, MAX_SMEM_BYTES + 4, 15, "tile"),
])
def test_route_choice(B_, sms, smem, clusters, route):
    assert scan_route(B_, sms, smem, clusters) == route


def test_cluster_shared_memory():
    # the count the kernel reports on the card (chip_smoke.py holds them
    # equal): the flagship fits a cluster of 8, the two-layer, two-write
    # config does not and takes the tile route
    assert CLUSTER_SIZE == 8
    assert cluster_smem_bytes(NTMConfig(), 514) == 166864 <= MAX_SMEM_BYTES
    two = NTMConfig(controller_num_layers=2, write_first=True, shift_range=2, write_head_size=2)
    assert cluster_smem_bytes(two, 514) == 338488 > MAX_SMEM_BYTES
    # the weights' share shrinks with the cluster
    assert cluster_smem_bytes(NTMConfig(), 514, 4) > cluster_smem_bytes(NTMConfig(), 514, 8)


def test_cuda_tensors_without_a_card_raise():
    # a CUDA tensor never falls back to the plain version: without a card
    # the route cannot be chosen, and the call raises
    tcfg, _, _, tp, tokens = _params("flagship_shape")
    before = (ntm_scan_fused.launches, dict(ntm_scan_fused.launches_by_route))
    with FakeTensorMode():
        def on_cuda(t):
            return torch.empty(t.shape, device="cuda")

        params = {k: (on_cuda(v) if isinstance(v, torch.Tensor) else
                      [{kk: on_cuda(vv) for kk, vv in layer.items()} for layer in v])
                  for k, v in tp.items()}
        toks = on_cuda(torch.tensor(tokens))
        assert toks.device.type == "cuda"
        with pytest.raises((RuntimeError, AssertionError)):
            ntm_scan_fused(params, tcfg, toks, init_ntm_state(params, tcfg, B))
    assert (ntm_scan_fused.launches, ntm_scan_fused.launches_by_route) == before
