"""Train-step profiling sweep: attribute the cached-token BPTT's time
(counterpart of ntm_tracker_tpu/tools/profile_train.py, with its variants
and JSON keys).

The feature-cache training step (train-offsets --feature_cache) is the
memory core's 1300-step BPTT alone. This sweep times the full step
(loss + gradients + clip + RMSProp) across the knobs:

  * remat policy: "full" (each cell step checkpointed), "dots" (the
    matrix products kept, the rest recomputed) or "none";
  * compute dtype: float32 or bf16 (the cell's matmuls round their
    operands to bf16 and sum in float32: ops/lstm.matmul);
  * the scan layout ("dn" runs the "nd" step: models/ntm_tracker.py) and
    the scan unroll factor, which an eager loop does not have: the unroll
    variants run the same step and say so ("unroll_ignored": true);
  * the addressing kernel (B3, NTMConfig.use_pallas) once a cell step,
    under autograd, and the fused BPTT kernels (B2, fused_bptt=True);
  * forward-only (the loss, no gradients), an LSTM-only BPTT, B1 over the
    whole sequence at the training shape (fused_fwd_*), and the ablations
    (measure_ablation: a plain cell with components replaced by
    pass-throughs, ABLATIONS; abl_bf16_vjp with bf16 products both ways).

Prints one JSON line per variant: {"variant", "step_ms", "frames_per_sec",
"train_mfu"} (the ablations, fused_fwd_* and the two bounds: {"variant",
"step_ms"}), plus "launches", the kernels the variant launched. train_mfu
counts the canonical 3x-forward matmul FLOPs (fwd + 2x bwd, remat
recompute not credited) against the card's peak in the variant's compute
dtype: bf16 on the tensor cores for the bf16 variants, float32 (TF32 off)
for the rest (the JAX tool divided every variant by the TPU's bf16 peak). A
failure raises; an unknown variant prints {"variant", "error"} and the
tool exits 1 after the rest.

    python -m ntm_tracker_tpu_torch.tools.profile_train --batch 256 [--variants a,b] [--device cpu]
        [--trace DIR]   (a torch.profiler trace of the baseline step)
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
import torch.utils.checkpoint

from ntm_tracker_tpu_torch.benchmarks import _chip_peak_tflops, _sync, kernel_launches, launches_since
from ntm_tracker_tpu_torch.config import NTMConfig, TrackerConfig, TrainConfig, resolve_device


def cell_step_flops(cfg) -> float:
    """Matmul FLOPs of ONE forward cell step at batch 1 (the >99% terms)."""
    from ntm_tracker_tpu_torch.models.ntm_cell import head_param_sizes

    n = cfg.ntm
    ctrl_in = cfg.input_depth + n.read_head_size * n.mem_dim
    hidden = n.controller_hidden_size
    per_step = 0.0
    ins = [ctrl_in] + [hidden] * (n.controller_num_layers - 1)
    for d in ins:
        per_step += 2.0 * (d + hidden) * 4 * hidden  # LSTM gates
    P = sum(head_param_sizes(n).values())
    per_step += 2.0 * hidden * P                      # fused head unpack
    per_step += 2.0 * hidden * n.output_dim           # output head
    per_step += 2.0 * n.num_heads * n.mem_size * n.mem_dim * 4  # addressing
    return per_step


def train_step_flops(cfg) -> float:
    """Canonical training FLOPs of one optimizer step: 3x the forward
    matmul math (fwd + dL/dx + dL/dW) over every token of every sample."""
    return 3.0 * cell_step_flops(cfg) * cfg.total_steps * cfg.train.batch_size


def _mfu(cfg, step_ms: float, peak_tflops: float | None) -> float | None:
    if not peak_tflops or step_ms != step_ms:
        return None
    achieved = train_step_flops(cfg) / (step_ms / 1e3) / 1e12
    return round(achieved / peak_tflops, 4)


def _timed(fn, iters: int) -> float:
    """ms a call of fn() (which returns a tensor) over `iters` calls, after
    one untimed call; each run ends in a host read."""
    _sync(fn())
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    _sync(out)
    return (time.perf_counter() - t0) / iters * 1e3


def _grads(loss_fn, params):
    """fn() for _timed: the gradient of loss_fn(params) wrt every param
    leaf that it reaches (the first leaf's returned: the first layer's
    kernel, which every loss here reaches)."""
    from ntm_tracker_tpu_torch.train.optim import tree_leaves, tree_map

    def run():
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        return torch.autograd.grad(loss_fn(live), tree_leaves(live), allow_unused=True)[0]

    return run


def measure_step(cfg, iters: int = 8, forward_only: bool = False, trace_dir: str | None = None,
                 device=None) -> float:
    """Time the cached-token train step (or, forward_only, the loss alone)
    for a config. Returns ms."""
    from ntm_tracker_tpu_torch.train.experiments import OffsetExperiment, synthetic_cached_batch
    from ntm_tracker_tpu_torch.utils.profiling import profile_trace

    exp = OffsetExperiment(cfg, None, image_mode="cropped", device=device)
    params, opt_state = exp.init(torch.Generator().manual_seed(1))
    batch = exp.device_batch(synthetic_cached_batch(cfg, np.random.RandomState(0)))
    if forward_only:
        def loss():
            with torch.no_grad():
                return exp.loss_fn(params, batch)[0]

        return _timed(loss, iters)

    step = exp.make_train_step()
    carry = [params, opt_state]

    def train():
        carry[0], carry[1], m = step(carry[0], carry[1], batch)
        return m["loss"]

    if trace_dir:
        _sync(train())  # the first step (the kernels' libraries load) stays out of the trace
        with profile_trace(trace_dir):
            _sync(train())
    return _timed(train, iters)


def measure_lstm_only(cfg, iters: int = 8, device=None) -> float:
    """Grad step of a pure LSTM over the same steps and widths: the
    controller-only lower bound (everything above it is addressing and
    memory)."""
    from ntm_tracker_tpu_torch.ops.lstm import init_lstm_params, multi_lstm_step, zero_lstm_state

    dev = resolve_device(device)
    n = cfg.ntm
    B, T = cfg.train.batch_size, cfg.total_steps
    ctrl_in = cfg.input_depth + n.read_head_size * n.mem_dim
    params = init_lstm_params(ctrl_in, n.controller_hidden_size, n.controller_num_layers,
                              generator=torch.Generator().manual_seed(0), device=dev)
    xs = torch.as_tensor(np.random.RandomState(0).rand(T, B, ctrl_in).astype(np.float32), device=dev)
    dt = cfg.compute_dtype

    def body(p, x, carry):
        return multi_lstm_step(p, x.to(dt), carry)

    def loss(p):
        carry = zero_lstm_state(B, n.controller_hidden_size, n.controller_num_layers, device=dev)
        outs = []
        for t in range(T):
            out, carry = torch.utils.checkpoint.checkpoint(body, p, xs[t], carry, use_reentrant=False)
            outs.append(out)
        return torch.mean(torch.stack(outs).float() ** 2)

    return _timed(_grads(loss, params), iters)


class _MMBF16(torch.autograd.Function):
    """a @ w with bf16 operands and float32 sums, whose backward also
    multiplies in bf16: autograd of `a.bfloat16() @ w.bfloat16()` would
    run the cotangent products against a float32 cotangent."""

    @staticmethod
    def forward(ctx, a, w):
        a16, w16 = a.bfloat16(), w.bfloat16()
        ctx.save_for_backward(a16, w16)
        return _mm_f32(a16, w16)

    @staticmethod
    def backward(ctx, g):
        a16, w16 = ctx.saved_tensors
        g16 = g.bfloat16()
        return _mm_f32(g16, w16.t()), _mm_f32(a16.t(), g16)


def _mm_f32(x16: torch.Tensor, y16: torch.Tensor) -> torch.Tensor:
    """The product of two bf16 matrices as float32 sums: cuBLAS's bf16 GEMM
    with a float32 output on the card; on the CPU the same sums from the
    operands widened (a product of two bf16 values is exact in float32)."""
    if x16.is_cuda:
        return torch.mm(x16, y16, out_dtype=torch.float32)
    return x16.float() @ y16.float()


def _mm_bf16():
    """The bf16 matmul whose backward also runs in bf16 (_MMBF16.apply)."""
    return _MMBF16.apply


def _mm_f32_policy(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return a @ w


def ablation_cell(params, n: NTMConfig, x: torch.Tensor, state, skips=frozenset(), mm=_mm_f32_policy):
    """One NTM cell step (models/ntm_cell.ntm_cell_step at float32, no
    write_first, the executed cosine) with the components in `skips`
    replaced by cheap pass-throughs (the numbers are meaningless as a
    model; the deltas against no skips attribute the backward's cost):

      'cos'     similarity = mean of M rows (skips l2_normalize + einsum)
      'shift'   w_conv = w_gated (skips the roll-stack conv)
      'sharpen' w = w_conv (skips pow/normalize)
      'write'   M = M_prev (skips the erase/add outer products)
      'read'    read = prev read (skips the read einsum)
      'gate'    w_gated = w_content (skips the interpolation)

    Returns (logit, new state)."""
    from ntm_tracker_tpu_torch.models.ntm_cell import HEAD_PARAM_ORDER, head_param_sizes
    from ntm_tracker_tpu_torch.ops.memory import (
        batched_circular_convolution,
        batched_smooth_cosine_similarity,
        sharpen,
    )

    F = torch.nn.functional
    B = x.shape[0]
    R, W, H, D = n.read_head_size, n.write_head_size, n.num_heads, n.mem_dim
    M_prev, w_prev, read_prev = state["M"], state["w"], state["read"]
    out, ctrl_state = torch.cat([x, read_prev.reshape(B, R * D)], dim=1), []
    for lp, (c, h) in zip(params["controller"], state["controller_state"]):
        gates = mm(torch.cat([out, h], dim=1), lp["kernel"]) + lp["bias"]
        i, j, f, o = torch.chunk(gates, 4, dim=1)
        nc = c * torch.sigmoid(f) + torch.sigmoid(i) * torch.tanh(j)
        out = torch.tanh(nc) * torch.sigmoid(o)
        ctrl_state.append((nc, out))
    mc = mm(out, params["heads_w"]) + params["heads_b"]
    sizes = head_param_sizes(n)
    parts = dict(zip(HEAD_PARAM_ORDER, torch.split(mc, [sizes[k] for k in HEAD_PARAM_ORDER], dim=1)))
    logit = mm(out, params["out_w"]) + params["out_b"]

    k = torch.tanh(parts["k"].reshape(B, H, D))
    if "cos" in skips:
        similarity = torch.mean(M_prev, dim=2)[:, None, :] + torch.mean(k, dim=2)[..., None]
    else:
        similarity = batched_smooth_cosine_similarity(M_prev, k)
    beta = F.softplus(parts["beta"])[..., None]
    w_content = torch.softmax(similarity * beta, dim=-1)
    if "gate" in skips:
        w_gated = w_content
    else:
        g = torch.sigmoid(parts["g"])[..., None]
        w_gated = w_content * g + w_prev * (1.0 - g)
    if "shift" in skips:
        w_conv = w_gated
    else:
        sw = torch.softmax(parts["sw"].reshape(B, H, n.shift_space), dim=-1)
        w_conv = batched_circular_convolution(w_gated, sw)
    if "sharpen" in skips:
        w = w_conv
    else:
        gamma = (F.softplus(parts["gamma"]) + 1.0)[..., None]
        w = sharpen(w_conv, gamma)
    w_read, w_write = w[:, :R, :], w[:, R:, :]
    if "write" in skips:
        M = M_prev
    else:
        erase = torch.sigmoid(parts["erase"].reshape(B, W, D))
        add = torch.tanh(parts["add"].reshape(B, W, D))
        w_write_e = w_write[..., :, None]
        M_erase = torch.prod(1.0 - w_write_e * erase[:, :, None, :], dim=1)
        M_write = torch.sum(w_write_e * add[:, :, None, :], dim=1)
        M = M_prev * M_erase + M_write
    read = read_prev if "read" in skips else torch.einsum("brn,bnd->brd", w_read, M_prev)
    return logit, {"M": M, "w": w, "read": read, "controller_state": ctrl_state}


def ablation_loss(params, n: NTMConfig, xs: torch.Tensor, skips=frozenset(), mm=_mm_f32_policy) -> torch.Tensor:
    """mean(logits^2) of ablation_cell over xs [T, B, IN] from the learnable
    initial state, each step checkpointed (the JAX tool's jax.checkpoint
    around the scan body)."""
    from ntm_tracker_tpu_torch.models.ntm_cell import init_ntm_state

    def body(x, carry):
        return ablation_cell(params, n, x, carry, skips, mm)

    state = init_ntm_state(params, n, xs.shape[1])
    logits = []
    for t in range(xs.shape[0]):
        logit, state = torch.utils.checkpoint.checkpoint(body, xs[t], state, use_reentrant=False)
        logits.append(logit)
    return torch.mean(torch.stack(logits) ** 2)


def measure_ablation(cfg, skips: frozenset, iters: int = 8, bf16_vjp: bool = False, device=None) -> float:
    """Grad-step ms of the BPTT over ablation_cell with `skips` replaced;
    bf16_vjp multiplies in bf16 both ways (_mm_bf16)."""
    from ntm_tracker_tpu_torch.models.ntm_cell import init_ntm_params

    dev = resolve_device(device)
    n = cfg.ntm
    B, T = cfg.train.batch_size, cfg.total_steps
    params = init_ntm_params(n, cfg.input_depth, torch.Generator().manual_seed(0), dev)
    xs = torch.as_tensor(np.random.RandomState(0).rand(T, B, cfg.input_depth).astype(np.float32), device=dev)
    mm = _mm_bf16() if bf16_vjp else _mm_f32_policy
    return _timed(_grads(lambda p: ablation_loss(p, n, xs, skips, mm), params), iters)


def measure_fused_fwd(cfg, iters: int = 8, dtype=None, device=None) -> float:
    """B1 (ops/kernels/scan_cell.ntm_scan_fused) over the whole sequence at
    the training shape, no gradients: the forward's cost alone."""
    from ntm_tracker_tpu_torch.models.ntm_cell import init_ntm_params, init_ntm_state
    from ntm_tracker_tpu_torch.ops.kernels.scan_cell import ntm_scan_fused

    dev = resolve_device(device)
    n = cfg.ntm
    B, T = cfg.train.batch_size, cfg.total_steps
    params = init_ntm_params(n, cfg.input_depth, torch.Generator().manual_seed(0), dev)
    state = init_ntm_state(params, n, B)
    xs = torch.as_tensor(np.random.RandomState(0).rand(B, T, cfg.input_depth).astype(np.float32), device=dev)

    def run():
        with torch.no_grad():
            logits, _ = ntm_scan_fused(params, n, xs, state, compute_dtype=dtype or torch.float32)
            return torch.mean(logits ** 2)

    return _timed(run, iters)


ABLATIONS = {
    "abl_none": frozenset(),
    "abl_no_cos": frozenset({"cos"}),
    "abl_no_shift": frozenset({"shift"}),
    "abl_no_sharpen": frozenset({"sharpen"}),
    "abl_no_write": frozenset({"write"}),
    "abl_no_read": frozenset({"read"}),
    "abl_no_gate": frozenset({"gate"}),
    "abl_ctrl_only": frozenset({"cos", "shift", "sharpen", "write", "read", "gate"}),
    "abl_no_memory_side": frozenset({"cos", "write", "read"}),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seq_len", type=int, default=20)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--variants", default="all", help="comma list or 'all'")
    ap.add_argument("--trace", default="", help="write a torch.profiler trace of the baseline step to this directory")
    ap.add_argument("--device", default=None, help="torch device (default: cuda; cpu runs the plain routes)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def make_cfg(dtype=torch.float32, remat="full", unroll=1, pallas=False, layout="nd", bptt=False):
        return TrackerConfig(
            compute_dtype=dtype,
            ntm=NTMConfig(use_pallas=pallas),
            train=TrainConfig(batch_size=args.batch, sequence_length=args.seq_len, remat_policy=remat,
                              scan_unroll=unroll, scan_layout=layout, fused_bptt=bptt),
        )

    bf16 = torch.bfloat16
    variants = {
        "fused_bptt_f32": dict(bptt=True),
        "dn_layout_f32": dict(layout="dn"),
        "dn_layout_bf16": dict(layout="dn", dtype=bf16),
        "dn_layout_f32_dots": dict(layout="dn", remat="dots"),
        "baseline_f32_full": dict(),
        "f32_dots": dict(remat="dots"),
        "f32_none": dict(remat="none"),
        "f32_unroll13": dict(unroll=13),
        "f32_dots_unroll13": dict(remat="dots", unroll=13),
        "bf16_full": dict(dtype=bf16),
        "bf16_dots": dict(dtype=bf16, remat="dots"),
        "bf16_dots_unroll13": dict(dtype=bf16, remat="dots", unroll=13),
        "f32_pallas_fwd": dict(pallas=True),
        "bf16_pallas_fwd": dict(dtype=bf16, pallas=True),
    }
    selected = list(variants) if args.variants == "all" else args.variants.split(",")

    def measure(name):
        """(ms, the config whose train_mfu the line reports, or None for a
        {"variant", "step_ms"} line), or None for an unknown variant."""
        if name in ("forward_only_f32", "forward_only_bf16"):
            cfg = make_cfg(dtype=bf16 if name.endswith("bf16") else torch.float32)
            return measure_step(cfg, args.iters, forward_only=True, device=dev), cfg
        if name == "lstm_only_f32":
            cfg = make_cfg()
            return measure_lstm_only(cfg, args.iters, device=dev), cfg
        if name == "abl_bf16_vjp":
            return measure_ablation(make_cfg(), frozenset(), args.iters, bf16_vjp=True, device=dev), None
        if name in ("fused_fwd_f32", "fused_fwd_bf16"):
            dtype = bf16 if name.endswith("bf16") else torch.float32
            return measure_fused_fwd(make_cfg(), args.iters, dtype=dtype, device=dev), None
        if name in ABLATIONS:
            return measure_ablation(make_cfg(), ABLATIONS[name], args.iters, device=dev), None
        if name in variants:
            cfg = make_cfg(**variants[name])
            trace = args.trace if name == "baseline_f32_full" else ""
            return measure_step(cfg, args.iters, trace_dir=trace or None, device=dev), cfg
        return None

    def emit(name, full=True):
        before = kernel_launches()
        got = measure(name)
        if got is None:
            print(json.dumps({"variant": name, "error": "unknown variant"}), flush=True)
            return False
        ms, cfg = got
        out = {"variant": name, "step_ms": round(ms, 2)}
        if full and cfg is not None:
            out["frames_per_sec"] = round(args.batch * args.seq_len / (ms / 1e3), 1)
            out["train_mfu"] = _mfu(cfg, ms, _chip_peak_tflops(dev, cfg.compute_dtype))
            if cfg.train.scan_unroll != 1:
                out["unroll_ignored"] = True
        out["launches"] = launches_since(before)
        print(json.dumps(out), flush=True)
        return True

    ok = [emit(name) for name in selected]
    # the two bounds, always useful
    if args.variants == "all":
        ok += [emit(name, full=False) for name in ("forward_only_f32", "lstm_only_f32")]
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
