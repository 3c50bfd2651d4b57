"""The fused NTM scan's plain version vs the JAX package's Pallas kernel in
interpret mode, on the CPU, plus the wrapper's device routing, and its
trainable wrapper's gradients against the JAX one's. The CUDA kernel
itself is held against the plain version on the card by chip_smoke.py."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntm_tracker_tpu.config import NTMConfig as JNTMConfig
from ntm_tracker_tpu.models.ntm_cell import init_ntm_params, init_ntm_state as jinit_state
from ntm_tracker_tpu.ops.pallas.scan_cell import ntm_scan_fused as jax_scan_fused
from ntm_tracker_tpu.ops.pallas.scan_cell import ntm_scan_fused_trainable as jax_trainable
from ntm_tracker_tpu_torch import _build
from ntm_tracker_tpu_torch.config import NTMConfig
from ntm_tracker_tpu_torch.interop import flatten_ntm_params, ntm_params_from_flat
from ntm_tracker_tpu_torch.models.ntm_cell import init_ntm_state
from ntm_tracker_tpu_torch.ops.kernels.scan_cell import (
    ntm_scan_fused,
    ntm_scan_fused_reference,
    ntm_scan_fused_trainable,
)

from tests import torch_grad_parity as parity

# the three configs of tests/test_pallas_scan.py
CONFIGS = {
    "default-ish": dict(output_dim=2, mem_size=16, mem_dim=8, controller_hidden_size=16,
                        controller_num_layers=1, read_head_size=2, write_head_size=1),
    "multilayer-writefirst-s5": dict(output_dim=3, mem_size=8, mem_dim=4, controller_hidden_size=8,
                                     controller_num_layers=2, read_head_size=1, write_head_size=2,
                                     shift_range=2, write_first=True),
    "slotwise-cosine": dict(output_dim=2, mem_size=16, mem_dim=8, controller_hidden_size=16,
                            controller_num_layers=1, read_head_size=2, write_head_size=1,
                            slotwise_cosine=True),
}
# float32: the tolerance tests/test_pallas_scan.py holds the kernel to
F32_TOL = 2e-5
# bf16: both sides round operands and matmul results to bf16 with float32
# sums (the Pallas kernel emulates it the same way); the summation order
# differs, which can flip a last bf16 bit (2^-8) and carry it forward
BF16_TOL = 2e-2


def _setup(kw, B=2, T=7, IN=10):
    jcfg, tcfg = JNTMConfig(**kw), NTMConfig(**kw)
    jp = init_ntm_params(jax.random.PRNGKey(0), jcfg, IN)
    tp = ntm_params_from_flat(flatten_ntm_params(jp))
    tokens = np.random.RandomState(1).randn(B, T, IN).astype(np.float32)
    return jcfg, tcfg, jp, tp, tokens


def _compare(tl, ts, jl, js, atol):
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol)
    for key in ("M", "w", "read"):
        np.testing.assert_allclose(ts[key].numpy(), np.asarray(js[key]), atol=atol, err_msg=key)
    assert len(ts["controller_state"]) == len(js["controller_state"])
    for (tc, th), (jc, jh) in zip(ts["controller_state"], js["controller_state"]):
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=atol)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=atol)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_plain_version_matches_pallas_interpret(name, bf16):
    jcfg, tcfg, jp, tp, tokens = _setup(CONFIGS[name])
    jl, js = jax_scan_fused(jp, jcfg, jnp.asarray(tokens), jinit_state(jp, jcfg, 2), interpret=True,
                            compute_dtype=jnp.bfloat16 if bf16 else None)
    # the wrapper on CPU tensors runs the plain version
    tl, ts = ntm_scan_fused(tp, tcfg, torch.tensor(tokens), init_ntm_state(tp, tcfg, 2),
                            compute_dtype=torch.bfloat16 if bf16 else None)
    _compare(tl, ts, jl, js, BF16_TOL if bf16 else F32_TOL)


def test_zero_steps_echo_the_state():
    jcfg, tcfg, jp, tp, tokens = _setup(CONFIGS["default-ish"], T=0)
    jl, js = jax_scan_fused(jp, jcfg, jnp.asarray(tokens), jinit_state(jp, jcfg, 2), interpret=True)
    state = init_ntm_state(tp, tcfg, 2)
    before = ntm_scan_fused.launches
    tl, ts = ntm_scan_fused(tp, tcfg, torch.tensor(tokens), state)
    assert ts is state and tuple(tl.shape) == tuple(jl.shape) == (2, 0, 2)
    assert ntm_scan_fused.launches == before
    _compare(tl, ts, jl, js, F32_TOL)


def test_cpu_tensors_do_not_count_as_launches():
    _, tcfg, _, tp, tokens = _setup(CONFIGS["default-ish"])
    before = ntm_scan_fused.launches
    tl, _ = ntm_scan_fused(tp, tcfg, torch.tensor(tokens), init_ntm_state(tp, tcfg, 2))
    rl, _ = ntm_scan_fused_reference(tp, tcfg, torch.tensor(tokens), init_ntm_state(tp, tcfg, 2))
    assert ntm_scan_fused.launches == before
    np.testing.assert_array_equal(tl.numpy(), rl.numpy())


def test_other_devices_raise():
    # neither the CPU's plain version nor a launch: the wrapper refuses
    _, tcfg, _, tp, tokens = _setup(CONFIGS["default-ish"])
    meta = {k: (v.to("meta") if isinstance(v, torch.Tensor) else v) for k, v in tp.items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        ntm_scan_fused(meta, tcfg, torch.tensor(tokens, device="meta"), {})


def test_kernel_source_builds_without_pytorch_headers():
    # the build route: nvcc on a plain-C source for sm_90a, loaded by ctypes
    src = (_build.CSRC / "scan_cell.cu").read_text()
    assert "torch/extension.h" not in src and "#include <torch" not in src
    assert 'extern "C" int ntm_scan_cluster_launch' in src
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    path = _build.library_path("scan_cell")
    assert path.parent.parent == _build.BUILD_ROOT and path.name == "libscan_cell.so"
    # the build directory is git-ignored
    ignore = (pathlib.Path(__file__).resolve().parents[1] / ".gitignore").read_text().split()
    assert "ntm_tracker_tpu_torch/_build/" in ignore


@pytest.mark.parametrize("bwd_remat", [False, True], ids=["saved", "remat"])
@pytest.mark.parametrize("name", sorted(parity.CONFIGS))
def test_trainable_matches_jax(name, bwd_remat):
    jcfg, tcfg, params, tokens, cot = parity.case(name)
    scan = lambda p, c, t, s: ntm_scan_fused_trainable(p, c, t, s, bwd_remat=bwd_remat)
    value, _, _, grads = parity.port_value_and_grad(scan, tcfg, params, tokens, cot)
    v_ref, g_ref = parity.jax_value_and_grad(
        lambda p, t, s: jax_trainable(p, jcfg, t, s, interpret=True, bwd_remat=bwd_remat),
        jcfg, params, tokens, cot,
    )
    np.testing.assert_allclose(value, v_ref, rtol=parity.LOSS_RTOL)
    parity.assert_grads(grads, g_ref)


def test_trainable_zero_steps_echo_the_state():
    _, tcfg, params, tokens, _ = parity.case("flagship_shape")
    tp = ntm_params_from_flat(flatten_ntm_params(params))
    state = init_ntm_state(tp, tcfg, parity.B)
    logits, out = ntm_scan_fused_trainable(tp, tcfg, torch.zeros(parity.B, 0, 10), state)
    assert out is state and tuple(logits.shape) == (parity.B, 0, tcfg.output_dim)
