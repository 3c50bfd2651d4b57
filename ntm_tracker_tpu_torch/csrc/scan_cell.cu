// T NTM cell steps in one launch: the streaming tracker's per-frame cell loop.
//
// Replaces ntm_tracker_tpu/ops/pallas/scan_cell.py:_step_kernel (the Pallas
// body of ntm_scan_fused). Each step: stacked LSTM on [x | read | h], the
// fused head linear, tanh(k), cosine against memory (across-slot or
// slotwise), softplus-beta softmax, sigmoid gate, circular shift with the
// Python-2 offsets, gamma-sharpen with +1e-3, erase/add write, read before
// or after the write, and the output linear.
//
// What bounds it on an H100: at B=1 the work is a serial chain of 65
// dependent steps, and each step's dominant cost is one GEMV against the
// [IN + R*D + Hc, 4*Hc] LSTM kernel (3.2 MB f32 at the flagship config).
// One thread block runs the whole chain on one SM, so the time is set by
// how fast one SM pulls those weights out of the 50 MB L2 each step, not
// by HBM or by the card's FLOP rate (both are far from reached).
// The design keeps everything but the weights resident: M, w, read, c, h,
// the concatenated LSTM input, the gates and the head controls live in
// shared memory for all T steps; weights are read as coalesced GEMVs, one
// output column per thread, from global memory (they stay in L2); softmaxes
// and sums are warp-shuffle reductions; phases are separated by
// __syncthreads(). Batch rows are independent blocks.
// Splitting each step's GEMV across a thread-block cluster (distributed
// shared memory) to use more than one SM's L2 bandwidth is later work.
//
// compute_dtype=bf16 is reproduced as the JAX package does it
// (scan_cell.py:71-86): matmul operands rounded to bf16, products summed in
// f32, the sum rounded to bf16; everything else stays f32.
//
// The step math lives in ntm_step.cuh, shared with the training kernels
// (scan_bptt.cu). Plain C interface (no PyTorch headers): built by nvcc
// into a shared library and called through ctypes
// (ntm_tracker_tpu_torch/_build.py).

#include "ntm_step.cuh"

extern "C" int ntm_scan_cell_smem_bytes(int IN, int N, int D, int H, int R, int W,
                                        int S, int Hc, int L) {
  const Dims dm{IN, N, D, H, R, W, S, Hc, L, 1};
  return make_layout(dm, false).total * (int)sizeof(float);
}

// Launches one block of NT threads per batch row on `stream`. The pointer
// arrays lstm_w, lstm_b, c0 and h0 are host arrays of L device pointers.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int ntm_scan_cell_launch(
    const void* tokens, const void* const* lstm_w, const void* const* lstm_b,
    const void* heads_w, const void* heads_b, const void* out_w, const void* out_b,
    const void* M0, const void* w0, const void* read0, const void* const* c0,
    const void* const* h0, void* logits, void* M, void* w, void* read, void* c,
    void* h, int B, int T, int IN, int N, int D, int H, int R, int W, int S, int Hc,
    int L, int O, int write_first, int slotwise, int bf16, int device,
    void* stream) {
  if (L < 1 || L > MAX_LAYERS) return (int)cudaErrorInvalidValue;
  const Dims dm{IN, N, D, H, R, W, S, Hc, L, O};
  const Flags fl{write_first, slotwise, bf16};
  const ScanArgs a = make_scan_args(tokens, lstm_w, lstm_b, heads_w, heads_b, out_w, out_b,
                                    M0, w0, read0, c0, h0, logits, M, w, read, c, h, B, T,
                                    dm, fl);
  return launch_scan(a, device, stream);
}
