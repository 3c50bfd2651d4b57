// One NTM cell step's addressing and memory update in one launch (B3).
//
// Replaces ntm_tracker_tpu/ops/pallas/addressing.py:_kernel (:45), the
// Pallas body of fused_ntm_addressing: from the raw head controls, tanh(k),
// cosine against memory (across-slot or slotwise), softplus-beta softmax,
// sigmoid gate, circular shift with the Python-2 offsets, gamma-sharpen
// with +1e-3, erase/add write, and the read before or after the write.
//
// What bounds it on an H100: almost nothing but latency. A row moves 26.6
// KB at the flagship config (controls, M and w in; M, w and read out) and
// does ~75k operations, so the bound from bytes is 8 ns at B=1 and 2 us at
// B=256 (3.35 TB/s), below the ~0.9 us an empty launch takes (PERF.md).
// The time goes to chains of dependent steps inside one row, so the design
// keeps one launch per cell step, one block of NT_ADDR threads per batch
// row, and as few block barriers as it can:
// - the load: each thread issues all its global loads (the seven control
//   views in one pass, M and w_prev in 16-byte loads) before its first
//   shared store, so the row waits for one round trip; M lands transposed
//   (Mt[d][n], ntm_step.cuh's layout);
// - the phases of ntm_addressing() (ntm_step.cuh): each warp one job of
//   the heads' preparation and the normalizer; a warp per head runs its
//   chain in registers and stores its new w (and, read first, its read)
//   straight to the outputs; the write in place, a warp per memory row;
//   then the new memory to the output in [N, D] order, 16-byte stores.
// No atomics: a rerun gives the same bits. The TPU kernel's batch tiling
// (bb in 64/32/...) was a VMEM limit and is not copied, nor its [B,D,N]
// HBM layout: the outputs keep [B,N,D] and the transpose lives in shared
// memory.
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

// No controller: only the addressing's dimensions are set.
inline Dims addressing_dims(int N, int D, int H, int R, int W, int S) {
  return Dims{0, N, D, H, R, W, S, 0, 0, 0};
}

// threads per block: phase (a) gives each warp one job at the flagship
// config (5 heads, 10 pairs of memory rows, erase and add); two blocks fit
// an SM (__launch_bounds__), so B = 256 takes one wave
#define NT_ADDR 512

// kProbe: the per-phase probe (ntm_addressing_probe_launch), which stamps
// clock64() into stamps[b * PROBE_SLOTS + i]: 0 at entry, 1 after the load,
// 2..5 after the phases (ntm_addressing), 6..10 inside head 0's chain
#define PROBE_SLOTS 16
template <bool kProbe>
__global__ void __launch_bounds__(NT_ADDR, 2) ntm_addressing_kernel(const AddressingArgs a, long long* stamps) {
  extern __shared__ __align__(16) float smem[];
  long long* st = kProbe ? stamps + (size_t)blockIdx.x * PROBE_SLOTS : nullptr;
  if constexpr (kProbe)
    if (threadIdx.x == 0) st[0] = clock64();
  const int b = blockIdx.x, tid = threadIdx.x;
  const Dims dm = a.dm;
  const int N = dm.N, D = dm.D, H = dm.H, R = dm.R, ND = N * D, HN = H * N;
  const AddrLayout al = make_addr_layout(dm, NT_ADDR / 32);
  const int Np = al.Np;
  const float* Mp = a.M_prev + (size_t)b * a.M_stride;
  const float* wp = a.w_prev + (size_t)b * a.w_stride;

  // The load: every thread issues its global loads (one element of each
  // control view, up to two float4 of M and one of w_prev) before its first
  // shared store, so the row waits for one round trip; wider configs and
  // unaligned rows take the loops after it.
  const int width[N_CONTROLS] = {H * D, H, H, H * dm.S, H, dm.W * D, dm.W * D};
  const bool vecM = (reinterpret_cast<size_t>(Mp) & 15) == 0 && (ND & 3) == 0;
  const bool vecW = (reinterpret_cast<size_t>(wp) & 15) == 0 && (N & 3) == 0;
  float cv[N_CONTROLS];
#pragma unroll
  for (int c = 0; c < N_CONTROLS; ++c)
    cv[c] = tid < width[c] ? __ldg(a.ctl[c] + (size_t)b * a.ctl_stride[c] + tid) : 0.f;
  float4 mv[2], wv;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = (tid + r * NT_ADDR) * 4;
    mv[r] = vecM && i < ND ? __ldg(reinterpret_cast<const float4*>(Mp + i)) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  wv = vecW && tid * 4 < HN ? __ldg(reinterpret_cast<const float4*>(wp + tid * 4)) : make_float4(0.f, 0.f, 0.f, 0.f);
  // every load above issues before any store below
  asm volatile("" ::: "memory");

  int off = 0;
#pragma unroll
  for (int c = 0; c < N_CONTROLS; ++c) {
    if (tid < width[c]) smem[al.ctl + off + tid] = cv[c];
    for (int i = tid + NT_ADDR; i < width[c]; i += NT_ADDR)
      smem[al.ctl + off + i] = __ldg(a.ctl[c] + (size_t)b * a.ctl_stride[c] + i);
    off += width[c];
  }
  // M transposed into Mt, w_prev into rows of Np; their columns n >= N zero
  if (vecM) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = (tid + r * NT_ADDR) * 4;
      if (i < ND) {
        const float vv[4] = {mv[r].x, mv[r].y, mv[r].z, mv[r].w};
        int n = i / D, d = i - n * D;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          smem[al.Mt + d * Np + n] = vv[c];
          if (++d == D) {
            d = 0;
            ++n;
          }
        }
      }
    }
  }
  for (int i = vecM ? 2 * NT_ADDR * 4 + tid : tid; i < ND; i += NT_ADDR) {
    const int n = i / D, d = i - n * D;
    smem[al.Mt + d * Np + n] = __ldg(Mp + i);
  }
  if (vecW && tid * 4 < HN) {
    const int h = tid * 4 / N, n = tid * 4 - h * N;
    *reinterpret_cast<float4*>(smem + al.w + h * Np + n) = wv;
  }
  for (int i = vecW ? NT_ADDR * 4 + tid : tid; i < HN; i += NT_ADDR) {
    const int h = i / N, n = i - h * N;
    smem[al.w + h * Np + n] = __ldg(wp + i);
  }
  const int pad = Np - N;
  for (int i = tid; i < (D + H) * pad; i += NT_ADDR) {
    const int r = i / pad, c = N + i - r * pad;
    smem[(r < D ? al.Mt + r * Np : al.w + (r - D) * Np) + c] = 0.f;
  }
  AddrOut out;
  out.w_copy = a.w + (size_t)b * HN;
  out.read = a.read + (size_t)b * R * D;
  out.M_copy = a.M + (size_t)b * ND;
  __syncthreads();
  if constexpr (kProbe)
    if (tid == 0) st[1] = clock64();

  ntm_addressing<NT_ADDR, kProbe>(dm, a.fl, smem, al, out, kProbe ? st + 2 : nullptr);
}

extern "C" int ntm_addressing_smem_bytes(int N, int D, int H, int R, int W, int S) {
  return make_addr_layout(addressing_dims(N, D, H, R, W, S), NT_ADDR / 32).total * (int)sizeof(float);
}

template <bool kProbe>
static int launch(const void* const* ctl, const int* strides, const void* M_prev, const void* w_prev, void* M,
                  void* w, void* read, int M_stride, int w_stride, int B, int N, int D, int H, int R, int W, int S,
                  int write_first, int slotwise, int device, void* stream, long long* stamps) {
  // a warp holds at most ADDR_MAX_SLOTS slots; the shift wraps at most once
  if (B < 1 || R < 0 || W < 0 || R + W != H || N < 1 || N > ADDR_MAX_SLOTS || S < 1 || S > N)
    return (int)cudaErrorInvalidValue;
  AddressingArgs a;
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
  const int smem = ntm_addressing_smem_bytes(N, D, H, R, W, S);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(ntm_addressing_kernel<kProbe>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  ntm_addressing_kernel<kProbe><<<B, NT_ADDR, smem, (cudaStream_t)stream>>>(a, stamps);
  return (int)cudaGetLastError();
}

// Launches one block of NT_ADDR threads per batch row on `stream`. Returns the
// CUDA error code of the launch (0 = launched).
extern "C" int ntm_addressing_launch(
    const void* k, const void* beta, const void* g, const void* sw, const void* gamma,
    const void* erase, const void* add, const void* M_prev, const void* w_prev, void* M,
    void* w, void* read, int k_stride, int beta_stride, int g_stride, int sw_stride,
    int gamma_stride, int erase_stride, int add_stride, int M_stride, int w_stride, int B,
    int N, int D, int H, int R, int W, int S, int write_first, int slotwise, int device,
    void* stream) {
  const void* ctl[N_CONTROLS] = {k, beta, g, sw, gamma, erase, add};
  const int strides[N_CONTROLS] = {k_stride,     beta_stride,  g_stride,  sw_stride,
                                   gamma_stride, erase_stride, add_stride};
  return launch<false>(ctl, strides, M_prev, w_prev, M, w, read, M_stride, w_stride, B, N, D, H, R, W, S,
                       write_first, slotwise, device, stream, nullptr);
}

// The same launch through the probe variant: every block stamps clock64()
// at each phase boundary into stamps [B, PROBE_SLOTS] (int64; slot 0 at
// entry, the last slot used after the outputs are stored).
extern "C" int ntm_addressing_probe_launch(
    const void* k, const void* beta, const void* g, const void* sw, const void* gamma,
    const void* erase, const void* add, const void* M_prev, const void* w_prev, void* M,
    void* w, void* read, int k_stride, int beta_stride, int g_stride, int sw_stride,
    int gamma_stride, int erase_stride, int add_stride, int M_stride, int w_stride, int B,
    int N, int D, int H, int R, int W, int S, int write_first, int slotwise, int device,
    void* stream, void* stamps) {
  const void* ctl[N_CONTROLS] = {k, beta, g, sw, gamma, erase, add};
  const int strides[N_CONTROLS] = {k_stride,     beta_stride,  g_stride,  sw_stride,
                                   gamma_stride, erase_stride, add_stride};
  return launch<true>(ctl, strides, M_prev, w_prev, M, w, read, M_stride, w_stride, B, N, D, H, R, W, S,
                      write_first, slotwise, device, stream, (long long*)stamps);
}

extern "C" int ntm_addressing_probe_slots() { return PROBE_SLOTS; }

// The SM clock the probe's cycles convert by, in kHz (cudaDevAttrClockRate).
extern "C" int ntm_sm_clock_khz(int device) {
  int khz = 0;
  return cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, device) == cudaSuccess ? khz : -1;
}

// An empty kernel: its device time is the floor that any one-launch B3
// can reach, beside the byte bound.
__global__ void ntm_empty_kernel() {}

extern "C" int ntm_empty_launch(int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  ntm_empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
