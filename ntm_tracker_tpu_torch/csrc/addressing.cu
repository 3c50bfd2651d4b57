// One NTM cell step's addressing and memory update in one launch (B3).
//
// Replaces ntm_tracker_tpu/ops/pallas/addressing.py:_kernel (:45), the
// Pallas body of fused_ntm_addressing: from the raw head controls, tanh(k),
// cosine against memory (across-slot or slotwise), softplus-beta softmax,
// sigmoid gate, circular shift with the Python-2 offsets, gamma-sharpen
// with +1e-3, erase/add write, and the read before or after the write.
//
// What bounds it on an H100: almost nothing but the launch. A row moves
// 26.6 KB at the flagship config (controls, M and w in; M, w and read out)
// and does ~75k operations, so the bound from bytes is 8 ns at B=1 and 2 us
// at B=256 (3.35 TB/s), below the few microseconds a launch costs. The
// design therefore keeps to one launch per cell step and one pass over
// memory: one block of NT threads per batch row loads the row's controls,
// M and w into shared memory, runs the same addressing phases as the
// whole-sequence kernels (ntm_addressing() in ntm_step.cuh: threads over
// slots, a warp per head for the softmax, shift and sharpen reductions),
// and writes M, w and read once. M and w are updated in place in shared
// memory, as in the forward scan. No atomics: a rerun gives the same bits.
// The TPU kernel's batch tiling (bb in 64/32/...) was a VMEM limit and is
// not copied; its [B,D,N] transpose was a lane choice, and this kernel
// reads the standard [B,N,D] layout directly.
//
// The head controls arrive as views into the fused [B, P] head linear:
// each row's elements are contiguous, and each tensor has its own row
// stride, so no copy is made before the launch.
//
// Plain C interface (no PyTorch headers): built by nvcc into a shared
// library and called through ctypes (ntm_tracker_tpu_torch/_build.py).

#include "ntm_step.cuh"

#define N_CONTROLS 7

struct AddressingArgs {
  const float* ctl[N_CONTROLS];  // k, beta, g, sw, gamma, erase, add (raw)
  int ctl_stride[N_CONTROLS];    // their batch-row strides, in floats
  const float* M_prev;           // [B, N, D] rows
  const float* w_prev;           // [B, H, N] rows
  int M_stride, w_stride;
  float* M;                      // [B, N, D]
  float* w;                      // [B, H, N]
  float* read;                   // [B, R, D]
  Dims dm;
  Flags fl;
};

// No controller: the layout keeps only the addressing arrays (the LSTM's
// arrays have zero size, the input buffer R*D floats).
inline Dims addressing_dims(int N, int D, int H, int R, int W, int S) {
  return Dims{0, N, D, H, R, W, S, 0, 0, 0};
}

__global__ void __launch_bounds__(NT) ntm_addressing_kernel(const AddressingArgs a) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const Dims dm = a.dm;
  const int N = dm.N, D = dm.D, H = dm.H, R = dm.R, W = dm.W, S = dm.S;
  const Layout lay = make_layout(dm, false);

  // the controls, in the fused linear's column order
  const int width[N_CONTROLS] = {H * D, H, H, H * S, H, W * D, W * D};
  float* ctl = smem + lay.ctl;
  int off = 0;
#pragma unroll
  for (int c = 0; c < N_CONTROLS; ++c) {
    const float* src = a.ctl[c] + (size_t)b * a.ctl_stride[c];
    for (int i = tid; i < width[c]; i += NT) ctl[off + i] = src[i];
    off += width[c];
  }
  const float* Mp = a.M_prev + (size_t)b * a.M_stride;
  const float* wp = a.w_prev + (size_t)b * a.w_stride;
  for (int i = tid; i < N * D; i += NT) smem[lay.M_in + i] = Mp[i];
  for (int i = tid; i < H * N; i += NT) smem[lay.w_in + i] = wp[i];
  __syncthreads();

  ntm_addressing(dm, a.fl, smem, lay);

  for (int i = tid; i < N * D; i += NT) a.M[(size_t)b * N * D + i] = smem[lay.M_out + i];
  for (int i = tid; i < H * N; i += NT) a.w[(size_t)b * H * N + i] = smem[lay.w_out + i];
  for (int i = tid; i < R * D; i += NT) a.read[(size_t)b * R * D + i] = smem[lay.read_out + i];
}

extern "C" int ntm_addressing_smem_bytes(int N, int D, int H, int R, int W, int S) {
  return make_layout(addressing_dims(N, D, H, R, W, S), false).total * (int)sizeof(float);
}

// Launches one block of NT threads per batch row on `stream`. Returns the
// CUDA error code of the launch (0 = launched).
extern "C" int ntm_addressing_launch(
    const void* k, const void* beta, const void* g, const void* sw, const void* gamma,
    const void* erase, const void* add, const void* M_prev, const void* w_prev, void* M,
    void* w, void* read, int k_stride, int beta_stride, int g_stride, int sw_stride,
    int gamma_stride, int erase_stride, int add_stride, int M_stride, int w_stride, int B,
    int N, int D, int H, int R, int W, int S, int write_first, int slotwise, int device,
    void* stream) {
  if (B < 1 || R < 0 || W < 0 || R + W != H) return (int)cudaErrorInvalidValue;
  AddressingArgs a;
  const void* ctl[N_CONTROLS] = {k, beta, g, sw, gamma, erase, add};
  const int strides[N_CONTROLS] = {k_stride,     beta_stride,  g_stride,  sw_stride,
                                   gamma_stride, erase_stride, add_stride};
  for (int c = 0; c < N_CONTROLS; ++c) {
    a.ctl[c] = (const float*)ctl[c];
    a.ctl_stride[c] = strides[c];
  }
  a.M_prev = (const float*)M_prev;
  a.w_prev = (const float*)w_prev;
  a.M_stride = M_stride;
  a.w_stride = w_stride;
  a.M = (float*)M;
  a.w = (float*)w;
  a.read = (float*)read;
  a.dm = addressing_dims(N, D, H, R, W, S);
  a.fl = Flags{write_first, slotwise, 0};
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int smem = make_layout(a.dm, false).total * (int)sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(ntm_addressing_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  ntm_addressing_kernel<<<B, NT, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
