"""The lane-packed scan (ops/kernels/scan_packed.py) on the CPU: its plain
version, written on the packed [B, D*N] layout, against the JAX package's
ntm_scan_packed and ntm_scan_packed_bptt in interpret mode and against the
jnp scan (logits, final state, every gradient, init_* through
init_ntm_state), against the port's row-layout plain versions (B1's and
B2's), the d/dgamma contract, the routes and the tile sizes. The CUDA
kernels are held against the plain version on the card by chip_smoke.py."""

import dataclasses
import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntm_tracker_tpu.models.ntm_cell import init_ntm_state as jinit_state
from ntm_tracker_tpu.ops.pallas.scan_packed import ntm_scan_packed as jax_packed
from ntm_tracker_tpu.ops.pallas.scan_packed import ntm_scan_packed_bptt as jax_packed_bptt
from ntm_tracker_tpu_torch import _build
from ntm_tracker_tpu_torch.interop import flatten_ntm_params, ntm_params_from_flat
from ntm_tracker_tpu_torch.models.ntm_cell import init_ntm_params, init_ntm_state
from ntm_tracker_tpu_torch.ops.kernels import scan_bptt, scan_packed
from ntm_tracker_tpu_torch.ops.kernels.scan_bptt import ntm_scan_fused_bptt
from ntm_tracker_tpu_torch.ops.kernels.scan_cell import ntm_scan_fused_reference
from ntm_tracker_tpu_torch.ops.kernels.scan_packed import (
    BACKWARD_ROWS,
    FORWARD_ROWS,
    ntm_scan_packed,
    ntm_scan_packed_bptt,
    ntm_scan_packed_reference,
    pack_memory,
    tile_rows,
    unpack_memory,
)
from ntm_tracker_tpu_torch.utils import profiling

from tests.pallas_harness import B, CONFIGS, jnp_unroll
from tests.test_torch_scan_bptt import _one_hot_wconv_case
from tests.torch_grad_parity import (
    FWD_TOL,
    LOSS_RTOL,
    assert_grads,
    case,
    jax_value_and_grad,
    port_value_and_grad,
    torch_cot,
)

SOURCE = _build.CSRC / "scan_packed.cu"


@functools.lru_cache(maxsize=None)
def jax_reference(name):
    """JAX's packed kernels in interpret mode, once per config: (forward
    logits and final state, (value, grads) of the packed BPTT pair)."""
    jcfg, _, params, tokens, cot = case(name)
    fwd = jax_packed(params, jcfg, tokens, jinit_state(params, jcfg, B), interpret=True)
    vg = jax_value_and_grad(lambda p, t, s: jax_packed_bptt(p, jcfg, t, s, interpret=True), jcfg, params, tokens, cot)
    return fwd, vg


def assert_state_close(logits, final, ref_logits, ref_final, tol):
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref_logits), atol=tol)
    for key in ("M", "w", "read"):
        np.testing.assert_allclose(final[key].detach().numpy(), np.asarray(ref_final[key]), atol=tol, err_msg=key)
    for (c, h), (rc, rh) in zip(final["controller_state"], ref_final["controller_state"]):
        np.testing.assert_allclose(c.detach().numpy(), np.asarray(rc), atol=tol)
        np.testing.assert_allclose(h.detach().numpy(), np.asarray(rh), atol=tol)


def port_inputs(name):
    _, tcfg, params, tokens, _ = case(name)
    tp = ntm_params_from_flat(flatten_ntm_params(params))
    return tcfg, tp, torch.tensor(np.asarray(tokens))


def test_pack_memory_lane_order():
    """Lane d*N + n, as scan_packed.py:609-610 packs it."""
    M = np.random.RandomState(0).randn(3, 16, 8).astype(np.float32)
    Mp = pack_memory(torch.tensor(M))
    np.testing.assert_array_equal(Mp.numpy(), np.asarray(jnp.swapaxes(jnp.asarray(M), 1, 2).reshape(3, 128)))
    assert Mp[1, 5 * 16 + 3] == M[1, 3, 5]
    np.testing.assert_array_equal(unpack_memory(Mp, 16).numpy(), M)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plain_forward_matches_jax_packed_and_jnp(name):
    jcfg, _, params, tokens, _ = case(name)
    tcfg, tp, tok = port_inputs(name)
    with torch.no_grad():
        logits, final = ntm_scan_packed(tp, tcfg, tok, init_ntm_state(tp, tcfg, B))
    (jlogits, jfinal), _ = jax_reference(name)
    assert_state_close(logits, final, jlogits, jfinal, FWD_TOL)
    rlogits, rfinal = jnp_unroll(params, jcfg, tokens, jinit_state(params, jcfg, B))
    assert_state_close(logits, final, rlogits, rfinal, FWD_TOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plain_gradients_match_jax_packed_bptt(name):
    _, tcfg, params, tokens, cot = case(name)
    value, _, _, grads = port_value_and_grad(ntm_scan_packed_bptt, tcfg, params, tokens, cot)
    _, (v_ref, g_ref) = jax_reference(name)
    np.testing.assert_allclose(value, v_ref, rtol=LOSS_RTOL)
    assert_grads(grads, g_ref)
    for key in ("init_M", "init_w", "init_read"):
        assert np.abs(grads[key]).max() > 0, key


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plain_version_matches_the_row_plain_versions(name):
    """The packed layout against B1's plain loop (forward) and B2's plain
    version (value and every gradient) on the same inputs."""
    _, tcfg, params, tokens, cot = case(name)
    tcfg, tp, tok = port_inputs(name)
    with torch.no_grad():
        state = init_ntm_state(tp, tcfg, B)
        got = ntm_scan_packed_reference(tp, tcfg, tok, state)
        ref = ntm_scan_fused_reference(tp, tcfg, tok, state)
    assert_state_close(*got, *ref, FWD_TOL)
    v, _, _, g = port_value_and_grad(ntm_scan_packed_bptt, tcfg, params, tokens, cot)
    v_row, _, _, g_row = port_value_and_grad(ntm_scan_fused_bptt, tcfg, params, tokens, cot)
    np.testing.assert_allclose(v, v_row, rtol=LOSS_RTOL)
    assert_grads(g, g_row)


def test_gamma_gradient_is_zero_where_w_conv_is_zero():
    """d/dgamma of w_conv^gamma is 0 where w_conv == 0 (scan_packed.py:905):
    with w_conv exactly one-hot every gamma gradient is exactly 0, and the
    gradients agree with B2's plain version."""
    jcfg, params, tokens, cot, M0, cols = _one_hot_wconv_case()
    _, tcfg, _, _, _ = case("flagship_shape")

    def grads(scan):
        tp = ntm_params_from_flat(flatten_ntm_params(params))
        leaves = [tp["heads_w"], tp["heads_b"], tp["controller"][0]["kernel"], tp["init_w"]]
        for t in leaves:
            t.requires_grad_()
        tok = torch.tensor(np.asarray(tokens)).requires_grad_()
        logits, final = scan(tp, tcfg, tok, dict(init_ntm_state(tp, tcfg, B), M=torch.tensor(M0)))
        A, BM, Bw, Br, Bc = torch_cot(cot)
        loss = (logits * A).sum() + (final["M"] * BM).sum() + (final["w"] * Bw).sum() + (final["read"] * Br).sum()
        for c, h in final["controller_state"]:
            loss = loss + (c * Bc).sum() + 0.5 * (h * Bc).sum()
        return torch.autograd.grad(loss, leaves + [tok])

    got, ref = grads(ntm_scan_packed_bptt), grads(ntm_scan_fused_bptt)
    for g in got:
        assert torch.isfinite(g).all()
    assert (got[1][cols["gamma"]] == 0).all() and (got[0][:, cols["gamma"]] == 0).all()
    names = ("heads_w", "heads_b", "controller[0].kernel", "init_w", "tokens")
    assert_grads({n: g.numpy() for n, g in zip(names, got)}, {n: g.numpy() for n, g in zip(names, ref)})


@pytest.mark.parametrize("batch", [1, 5])
def test_batches_off_the_tile(batch):
    """B=1 and a B that no tile divides: the plain version against B1's
    plain loop and B2's gradients (the kernels mask the ragged last tile;
    chip_smoke.py holds them at B=1 and B=70)."""
    tcfg, _, _ = port_inputs("flagship_shape")
    rs = np.random.RandomState(batch)
    tp = init_ntm_params(tcfg, 10, torch.Generator().manual_seed(batch))
    tok = torch.tensor(rs.uniform(-1, 1, (batch, 6, 10)).astype(np.float32))
    assert batch == 1 or (batch % max(FORWARD_ROWS) and batch % max(BACKWARD_ROWS))

    def run(scan):
        leaves = [tp["heads_w"], tp["init_M"], tp["controller"][0]["kernel"]]
        live = [t.detach().clone().requires_grad_() for t in leaves]
        p = dict(tp, heads_w=live[0], init_M=live[1], controller=[dict(tp["controller"][0], kernel=live[2])])
        tk = tok.clone().requires_grad_()
        logits, final = scan(p, tcfg, tk, init_ntm_state(p, tcfg, batch))
        loss = logits.square().sum() + final["M"].sum() + final["read"].square().sum()
        return logits.detach(), final["M"].detach(), torch.autograd.grad(loss, live + [tk])

    lp, mp, gp = run(ntm_scan_packed_bptt)
    lr, mr, gr = run(ntm_scan_fused_bptt)
    np.testing.assert_allclose(lp.numpy(), lr.numpy(), atol=FWD_TOL)
    np.testing.assert_allclose(mp.numpy(), mr.numpy(), atol=FWD_TOL)
    assert_grads({str(i): g.numpy() for i, g in enumerate(gp)}, {str(i): g.numpy() for i, g in enumerate(gr)})


def test_use_pallas_leaves_the_numbers():
    """The whole-sequence kernels ignore the flag (scan_packed.py:916-919)."""
    _, tcfg, params, tokens, cot = case("flagship_shape")
    v, lo, _, g = port_value_and_grad(ntm_scan_packed_bptt, tcfg, params, tokens, cot)
    flagged = dataclasses.replace(tcfg, use_pallas=True)
    v_f, lo_f, _, g_f = port_value_and_grad(ntm_scan_packed_bptt, flagged, params, tokens, cot)
    assert v == v_f and torch.equal(lo, lo_f)
    for k in g:
        np.testing.assert_array_equal(g[k], g_f[k])


def test_cpu_tensors_take_the_plain_version_without_launches():
    _, tcfg, params, tokens, cot = case("flagship_shape")
    counters = (scan_packed.packed_forward, scan_packed.packed_forward_residuals, scan_packed.packed_backward,
                scan_bptt.grad_reduce)
    before = [profiling.counter(f"launches.{f.__name__}") for f in counters]
    port_value_and_grad(ntm_scan_packed_bptt, tcfg, params, tokens, cot)
    tcfg, tp, tok = port_inputs("flagship_shape")
    with torch.no_grad():
        ntm_scan_packed(tp, tcfg, tok, init_ntm_state(tp, tcfg, B))
        ntm_scan_packed_bptt(tp, tcfg, tok, init_ntm_state(tp, tcfg, B))
    assert [profiling.counter(f"launches.{f.__name__}") for f in counters] == before


@pytest.mark.parametrize("fn", [ntm_scan_packed, ntm_scan_packed_bptt], ids=lambda f: f.__name__)
def test_other_devices_and_dtypes_raise(fn):
    tcfg, tp, _ = port_inputs("flagship_shape")
    state = init_ntm_state(tp, tcfg, B)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fn(tp, tcfg, torch.zeros(B, 3, 10, device="meta"), state)
    with pytest.raises(ValueError, match="float32"):
        fn(tp, tcfg, torch.zeros(B, 3, 10, dtype=torch.float64), state)
    # T = 0 echoes the state
    logits, final = fn(tp, tcfg, torch.zeros(B, 0, 10), state)
    assert final is state and tuple(logits.shape) == (B, 0, tcfg.output_dim)


def test_tile_sizes_match_the_kernel_instantiations():
    """The default tile is, of the instantiations that fit the block's
    shared memory, the one whose blocks fill the card in the fewest waves,
    then the fewest rows; an explicit tile must be instantiated and fit."""
    limit = scan_packed.MAX_SMEM_BYTES

    def fits(per_row):
        return lambda rows: per_row * rows <= limit

    assert tile_rows(256, None, fits(limit // 8), 132, backward=False) == 2
    assert tile_rows(512, None, fits(limit // 8), 132, backward=False) == 4
    assert tile_rows(512, None, fits(limit // 3), 132, backward=False) == 2
    assert tile_rows(100, None, fits(limit // 3), 132, backward=True) == 1
    assert tile_rows(256, 1, fits(limit // 8), 132, backward=True) == 1
    with pytest.raises(ValueError, match="shared memory above"):
        tile_rows(256, 4, fits(limit // 3), 132, backward=False)
    with pytest.raises(ValueError, match="shared memory above"):
        tile_rows(256, None, fits(limit + 1), 132, backward=True)
    for rows, backward in ((5, False), (4, True), (0, True)):
        with pytest.raises(ValueError, match="rows_per_block"):
            tile_rows(256, rows, fits(1), 132, backward)
    src = SOURCE.read_text()
    fwd = re.search(r"fwd_rows_ok\(int rows\) \{ return (.*?); \}", src).group(1)
    bwd = re.search(r"bwd_rows_ok\(int rows\) \{ return (.*?); \}", src).group(1)
    assert sorted(int(v) for v in re.findall(r"rows == (\d+)", fwd)) == sorted(FORWARD_ROWS)
    assert sorted(int(v) for v in re.findall(r"rows == (\d+)", bwd)) == sorted(BACKWARD_ROWS)
    for rows in FORWARD_ROWS:
        assert f"launch_fwd<{rows}>" in src
    for rows in BACKWARD_ROWS:
        assert f"launch_bwd<{rows}>" in src


def test_kernel_source_builds_without_pytorch_headers():
    src = SOURCE.read_text()
    assert "torch/extension.h" not in src and "#include <torch" not in src
    assert '#include "ntm_step.cuh"' in src
    for fn in ("ntm_packed_fwd_launch", "ntm_packed_bwd_launch", "ntm_packed_smem_bytes"):
        assert f'extern "C" int {fn}' in src
    # no float atomics, and sums are sums: no 0/1 selector matrices
    assert "atomicAdd" not in src
    for selector in ("E_dn", "A_d", "A_n", "SELS"):
        assert not re.search(rf"\b{selector}\b", src), selector
    path = _build.library_path("scan_packed")
    assert path.parent.parent == _build.BUILD_ROOT and path.name == "libscan_packed.so"
    # the backward's entry point and the probe variants: the same source,
    # each with its own flag and library
    for name, flag in (("scan_packed_bwd", "-DNTM_PACKED_BACKWARD"), ("scan_packed_probe", "-DNTM_PACKED_PROBE")):
        variant = _build.library_path(name)
        assert variant.name == f"lib{name}.so" and variant.parent != path.parent
        assert _build.VARIANTS[name] == ("scan_packed", (flag,))
    assert "#ifdef NTM_PACKED_PROBE" in src and "#elif defined(NTM_PACKED_BACKWARD)" in src
    assert src.count("#if NTM_PACKED_FWD_ENTRY") == src.count("#if NTM_PACKED_BWD_ENTRY") == 1
