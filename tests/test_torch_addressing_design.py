"""The addressing phases' work split (csrc/ntm_step.cuh ntm_addressing(),
which B3's kernel in csrc/addressing.cu and B1's cluster route in
csrc/scan_cell.cu both run), on the CPU: its plain emulation,
`addressing_split_reference`, against JAX's Pallas kernel run in interpret
mode (as tests/test_pallas_addressing.py runs it) and against the port's
plain version, on configs that reach each part of the split; the shift's
shuffle plan against the Python-2 offsets; the shared-memory mirrors
against the card's budget; and the configs the phases refuse."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import ntm_tracker_tpu.ops.pallas.addressing as jfa
from ntm_tracker_tpu_torch.config import NTMConfig
from ntm_tracker_tpu_torch.ops.kernels import addressing
from ntm_tracker_tpu_torch.ops.kernels.scan_cell import (
    CLUSTER_SIZE,
    MAX_SMEM_BYTES,
    NT_THREADS,
    cluster_smem_bytes,
    route_for,
    scan_route,
)
from ntm_tracker_tpu_torch.ops.memory import circular_convolution_shifts
from ntm_tracker_tpu_torch.utils import profiling

# tests/test_pallas_addressing.py's bound for the kernel against the jnp
# math (tests/test_torch_addressing.py holds the plain version to it)
KERNEL_ATOL = 2e-6
ORDER = ("k", "beta", "g", "sw", "gamma", "erase", "add", "M_prev", "w_prev")
# the warps of B3's block and of a cluster CTA
WARPS = addressing.ADDR_THREADS // 32

# (N, D, H, W, S, B, write_first, slotwise, warps): the flagship shape
# (runs of 4 slots), its flags, two write heads at S = 5 (offsets -3..1),
# N = 16 (a slot per lane, 16 lanes), N = 100 (25 lanes of 4), more heads
# than warps (a warp runs two or three chains), N = 33 (runs of 2 that do
# not divide N: the shift's three wrap classes), N = 196 (runs of 8, the
# last run cut by the row stride)
CASES = {
    "flagship": (128, 20, 5, 1, 3, 2, False, False, WARPS),
    "slotwise": (128, 20, 5, 1, 3, 2, False, True, WARPS),
    "write_first": (128, 20, 5, 1, 3, 2, True, False, WARPS),
    "two_writes_s5": (128, 20, 6, 2, 5, 2, False, False, WARPS),
    "n16_d8": (16, 8, 3, 1, 3, 3, False, False, WARPS),
    "n100": (100, 20, 5, 1, 3, 2, False, False, WARPS),
    "heads_over_warps": (64, 12, 18, 2, 3, 2, False, False, WARPS),
    "heads_over_few_warps_write_first": (32, 8, 9, 1, 3, 2, True, True, 4),
    "n33_uneven_runs_s5": (33, 8, 4, 1, 5, 2, True, False, WARPS),
    "n196_runs_of_8": (196, 12, 3, 1, 5, 2, False, True, WARPS),
}


def _inputs(seed, N, D, H, W, S, B):
    r = np.random.RandomState(seed)
    p = dict(k=r.randn(B, H, D), beta=r.randn(B, H), g=r.randn(B, H), sw=r.randn(B, H, S),
             gamma=r.randn(B, H), erase=r.randn(B, W, D), add=r.randn(B, W, D), M_prev=r.randn(B, N, D) * 0.5)
    logits = r.randn(B, H, N)
    w = np.exp(logits - logits.max(-1, keepdims=True))
    p["w_prev"] = w / w.sum(-1, keepdims=True)
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_split_matches_jax_kernel_and_plain_version(name):
    N, D, H, W, S, B, write_first, slotwise, warps = CASES[name]
    p = _inputs(list(CASES).index(name), N, D, H, W, S, B)
    kw = dict(read_heads=H - W, write_first=write_first, slotwise=slotwise)
    want = jfa.fused_ntm_addressing(*[jnp.asarray(p[k]) for k in ORDER], **kw, interpret=True)
    args = [torch.tensor(p[k]) for k in ORDER]
    got = addressing.addressing_split_reference(*args, **kw, warps=warps)
    plain = addressing.fused_ntm_addressing_reference(*args, **kw)
    for out, a, b, c in zip(("M", "w", "read"), got, want, plain):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=KERNEL_ATOL, err_msg=f"{name} {out} vs JAX")
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=KERNEL_ATOL, err_msg=f"{name} {out} vs plain")


@pytest.mark.parametrize("N", [1, 3, 16, 31, 32, 33, 63, 64, 65, 100, 127, 128, 129, 196, 255, 256])
def test_shift_plan_reads_the_python2_offsets(N):
    # every (lane, slot of its run, offset j) reads slot (n + shift_j) mod N,
    # with the shifts {-2, -1, 0} at S = 3 and {-3, ..., 1} at S = 5
    RL = addressing.addr_run(N)
    assert 32 * RL >= N and (RL == 1 or 32 * RL // 2 < N)
    for S in (1, 3, 5, 7):
        if S > N:
            continue
        shifts = circular_convolution_shifts(S)
        for lane in range(32):
            for i in range(RL):
                n = lane * RL + i
                if n >= N:
                    continue
                for j in range(S):
                    src, e = addressing.shift_sources(N, S, lane, i, j)
                    assert 0 <= e < RL and src * RL + e == (n + shifts[j]) % N


def test_layout_mirrors_and_the_cluster_budget():
    # the slot stride: rows of 16 bytes, never a multiple of 32 floats
    assert [addressing.addr_stride(n) for n in (16, 33, 96, 100, 128, 256)] == [16, 36, 100, 100, 132, 260]
    assert [addressing.addr_run(n) for n in (1, 32, 33, 64, 65, 128, 129, 256)] == [1, 1, 2, 2, 4, 4, 8, 8]
    # B3 at the flagship: Mt 20 x 132, w 5 x 132, tanh(k) 5 x 20, the
    # normalizer 20, 4 x 5 scalars, 170 controls, 5 x 3 shift weights,
    # erase and add 2 x 20, and 4 read warps' 20 x 33 partial sums
    floats = 2640 + 660 + 100 + 20 + 20 + 170 + 15 + 40 + 4 * 660
    assert addressing.addressing_smem_bytes(128, 20, 5, 4, 1, 3) == 4 * floats == 25220
    # the flagship's CTA still fits and still takes the cluster route at B=1
    flagship = cluster_smem_bytes(NTMConfig(), 514)
    assert flagship == 166864 <= MAX_SMEM_BYTES
    assert scan_route(1, 132, flagship, 15) == "cluster"
    assert NT_THREADS // 32 == WARPS and CLUSTER_SIZE == 8


def test_configs_the_phases_refuse():
    # more than 256 slots, or a shift wider than memory: B3 raises before
    # any launch, and B1 takes the tile route
    assert addressing.addressing_supported(256, 3) and addressing.addressing_supported(3, 3)
    assert not addressing.addressing_supported(257, 3) and not addressing.addressing_supported(2, 3)
    with pytest.raises(ValueError):
        addressing.addressing_split_reference(*[torch.tensor(v) for v in _inputs(0, 300, 4, 2, 1, 3, 1).values()],
                                              read_heads=1)
    before = profiling.counter("launches.fused_ntm_addressing")
    with FakeTensorMode():
        p = {k: torch.empty(v.shape, device="cuda") for k, v in _inputs(0, 300, 4, 2, 1, 3, 1).items()}
        with pytest.raises(ValueError, match="slots"):
            addressing._launch(*[p[k] for k in ORDER], 1, False, False)
    assert profiling.counter("launches.fused_ntm_addressing") == before
    assert route_for(NTMConfig(mem_size=300), 1, 514, torch.device("cuda")) == "tile"
    assert route_for(NTMConfig(mem_size=2, shift_range=2), 1, 514, torch.device("cuda")) == "tile"
