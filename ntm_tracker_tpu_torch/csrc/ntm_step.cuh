// The NTM cell step's shared pieces: the dimensions and weight pointers,
// the shared-memory layout of one batch row, the addressing phases, the
// tile product and the cp.async helpers. scan_cell.cu (B1's cluster
// route), scan_bptt.cu (B2's kernels and B1's tile route), addressing.cu
// (B3) and scan_packed.cu (B4) include it.
//
// Each step: stacked LSTM on [x | read | h], the fused head linear,
// tanh(k), cosine against memory (across-slot or slotwise), softplus-beta
// softmax, sigmoid gate, circular shift with the Python-2 offsets,
// gamma-sharpen with +1e-3, erase/add write, read before or after the
// write, and the output linear (ntm_tracker_tpu/ops/pallas/scan_cell.py:
// _step_kernel, scan_bptt.py:_forward_math).
//
// A batch row's state lives in shared memory (make_layout). The forward
// kernels update it in place (the *_in and *_out arrays alias, safe
// because every phase that overwrites a state array runs after the last
// phase that reads it); the backward kernels keep them apart. Every
// intermediate the backward needs stays in its own shared array.
//
// compute_dtype=bf16 is reproduced as the JAX package does it
// (scan_cell.py:71-86): matmul operands rounded to bf16, products summed in
// f32, the sum rounded to bf16; everything else stays f32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define NT 512
#define NWARPS (NT / 32)
#define MAX_LAYERS 8

struct Dims {
  int IN, N, D, H, R, W, S, Hc, L, O;
};

struct Weights {
  const float* lstm_w[MAX_LAYERS];  // layer l: [in_l + Hc, 4*Hc]
  const float* lstm_b[MAX_LAYERS];  // [4*Hc]
  const float* heads_w;             // [Hc, P]
  const float* heads_b;             // [P]
  const float* out_w;               // [Hc, O]
  const float* out_b;               // [O]
};

struct Flags {
  int write_first, slotwise, bf16;
};

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// width of the fused head-parameter linear (k, beta, g, sw, gamma, erase, add)
__host__ __device__ inline int head_width(const Dims& d) {
  return d.H * d.D + 3 * d.H + d.S * d.H + 2 * d.W * d.D;
}

// the widest layer input [x | read | h] or [h_below | h]
__host__ __device__ inline int kin_max(const Dims& d) {
  return imax(d.IN + d.R * d.D + d.Hc, 2 * d.Hc);
}

// Offsets (in floats) of the shared-memory arrays; one definition serves
// the host (sizing) and the device (carving).
struct Layout {
  // the step's state (in == out in the forward kernels)
  int M_in, w_in, read_in, c_in, h_in, M_out, w_out, read_out, c_out, h_out;
  // the step's intermediates
  int inp, gates, ctl, mss, minv, k, kss, kinv, beta, g, gamma, sw, denom;
  int u, sim, wc, wg, wconv, powed, erase, add;
  // backward only: cotangent carries and scratch
  int dM, dMp, dtmp, dw, dwh, dwconv, du, dread, dc, dh, dctl, dctrl, dli, dgates, dlogit,
      dkss, dss;
  int total;
};

__host__ __device__ inline int take(int& o, int n) {
  const int at = o;
  o += n;
  return at;
}

__host__ __device__ inline Layout make_layout(const Dims& d, bool backward) {
  const int ND = d.N * d.D, HN = d.H * d.N, RD = d.R * d.D, LH = d.L * d.Hc;
  const int P = head_width(d), NDm = imax(d.N, d.D);
  Layout s;
  int o = 0;
  s.M_in = take(o, ND);
  s.w_in = take(o, HN);
  s.read_in = take(o, RD);
  s.c_in = take(o, LH);
  s.h_in = take(o, LH);
  if (backward) {
    s.M_out = take(o, ND);
    s.w_out = take(o, HN);
    s.read_out = take(o, RD);
    s.c_out = take(o, LH);
    s.h_out = take(o, LH);
  } else {
    s.M_out = s.M_in;
    s.w_out = s.w_in;
    s.read_out = s.read_in;
    s.c_out = s.c_in;
    s.h_out = s.h_in;
  }
  s.inp = take(o, kin_max(d));
  s.gates = take(o, d.L * 4 * d.Hc);
  s.ctl = take(o, P);
  s.mss = take(o, NDm);
  s.minv = take(o, NDm);
  s.k = take(o, d.H * d.D);
  s.kss = take(o, d.H);
  s.kinv = take(o, d.H);
  s.beta = take(o, d.H);
  s.g = take(o, d.H);
  s.gamma = take(o, d.H);
  s.sw = take(o, d.H * d.S);
  s.denom = take(o, d.H);
  s.u = take(o, HN);
  s.sim = take(o, HN);
  s.wc = take(o, HN);
  s.wg = take(o, HN);
  s.wconv = take(o, HN);
  s.powed = take(o, HN);
  s.erase = take(o, d.W * d.D);
  s.add = take(o, d.W * d.D);
  if (backward) {
    s.dM = take(o, ND);
    s.dMp = take(o, ND);
    s.dtmp = take(o, ND);
    s.dw = take(o, HN);
    s.dwh = take(o, HN);
    s.dwconv = take(o, HN);
    s.du = take(o, HN);
    s.dread = take(o, RD);
    s.dc = take(o, LH);
    s.dh = take(o, LH);
    s.dctl = take(o, P);
    s.dctrl = take(o, d.Hc);
    s.dli = take(o, kin_max(d));
    s.dgates = take(o, 4 * d.Hc);
    s.dlogit = take(o, d.O);
    s.dkss = take(o, d.H);
    s.dss = take(o, NDm);
  } else {
    s.dM = s.dMp = s.dtmp = s.dw = s.dwh = s.dwconv = s.du = s.dread = s.dc = s.dh = -1;
    s.dctl = s.dctrl = s.dli = s.dgates = s.dlogit = s.dkss = s.dss = -1;
  }
  s.total = o;
  return s;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
// a matmul's sum plus its bias under the compute dtype: bf16 rounds the
// sum first, then adds the bias in f32 (the JAX package's mm, then + b)
__device__ __forceinline__ float mm_bias(float acc, float bias, bool bf16) {
  return (bf16 ? bf16_round(acc) : acc) + bias;
}
__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }
__device__ __forceinline__ float softplus_f(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
// Python-style modulo into [0, N)
__device__ __forceinline__ int wrap(int i, int N) {
  i %= N;
  return i < 0 ? i + N : i;
}

// cp.async copies from global to shared memory (Ampere and later): 4 or
// 16 bytes, committed in groups; cp_async_wait<n> returns once at most n
// groups are still in flight.
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_f32x4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// ---- a product over a tile of RT batch rows (scan_bptt.cu's forward and
// backward, scan_packed.cu) -----------------------------------------------------

// acc[c][r] = sum_k xT[k*RT + r] * Wm[k*ld + col[c]] for the tile's RT rows
// and NC columns col[c] = min(j0 + c*NT, ncol - 1): each weight element is
// loaded once and used RT times, and each tile-input load serves NC
// columns. NC > 1 keeps NC independent weight loads in flight per k, so
// the 4*Hc = 800 LSTM columns take one pass of 512 threads, not two; the
// loop over k is unrolled UNROLL times, so NC * UNROLL loads are in flight.
template <int RT, int NC, int UNROLL = 4>
__device__ __forceinline__ void tile_dot(const float* __restrict__ Wm, int ld, int j0, int ncol, const float* xT,
                                         int K, float (&acc)[NC][RT]) {
  const float* wc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    wc[c] = Wm + min(j0 + c * NT, ncol - 1);
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[c][r] = 0.f;
  }
#pragma unroll UNROLL
  for (int k = 0; k < K; ++k) {
    float wv[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) wv[c] = __ldg(wc[c] + (size_t)k * ld);
    const float* xk = xT + k * RT;
    if constexpr (RT % 4 == 0) {
#pragma unroll
      for (int r = 0; r < RT; r += 4) {
        const float4 xv = *reinterpret_cast<const float4*>(xk + r);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc[c][r] = fmaf(xv.x, wv[c], acc[c][r]);
          acc[c][r + 1] = fmaf(xv.y, wv[c], acc[c][r + 1]);
          acc[c][r + 2] = fmaf(xv.z, wv[c], acc[c][r + 2]);
          acc[c][r + 3] = fmaf(xv.w, wv[c], acc[c][r + 3]);
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float xv = xk[r];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[c][r] = fmaf(xv, wv[c], acc[c][r]);
      }
    }
  }
}

// ---- the addressing phases of one step: B3 (addressing.cu) and B1's cluster
// route (scan_cell.cu) --------------------------------------------------------
//
// Everything after the head linear for one batch row, by one block of NTH
// threads, in phases split by block barriers:
//  (a) a job per warp: per head, tanh(k) by lanes over d and |k|^-1 by a
//      warp sum, the scalar controls (softplus beta, sigmoid g, softplus
//      gamma + 1) and the shift weights' softmax by lanes over j; per pair
//      of memory rows, the across-slot normalizer |M[:, d]|^-1 by warp
//      sums; erase and add squashed.
//  (b) a warp per head runs the rest of its chain in registers, each lane
//      holding a run of RL consecutive slots (RL = 4 at N = 128): the
//      similarity, the softplus-beta softmax, the gate, the circular shift
//      with the Python-2 offsets (slots across run boundaries by warp
//      shuffles), the gamma-sharpen and its +1e-3, and, where the read
//      comes first, the head's read. Warp reductions take the place of
//      block barriers.
//  (c) the erase/add write in place, a warp per memory row and a lane per
//      four slots; then, after one more barrier, where the read comes
//      after the write, that read, and B3's copy of the new memory to its
//      output.
// Memory lives transposed in shared memory, Mt[d][n] with row stride Np
// (addr_stride): a lane's run of slots is one 16-byte load, a warp's 32
// runs one conflict-free 512-byte row; the [N, D]-order copies read it
// with at most 3-way conflicts at D = 20. The columns n >= N of Mt and of
// the weights' rows hold zeros. A read warp adds its lanes' partial sums
// of D values through its own scratch rows of 33 floats (lane_total).
// A warp issues in order and stalls at the first use of a value still in
// flight, and here most phases run a few warps on dependent chains, so
// every job issues its loads before it uses any: shared loads at clamped
// indices with masks after (a load under a condition compiles to a branch
// that waits for it), loops over D four rows at a time. B3's probe
// (chip_smoke.py) splits the phases' cycles.
// pow(x, gamma) is exp2f(gamma * log2f(x)) (x >= 0, gamma >= 1: x = 0
// gives 0); each softmax element's expf is computed once.
// Nothing depends on the block's rank or on timing: blocks that run the
// phases on the same inputs get the same bits (the cluster route's copies).

// the slot stride of Mt and of the weights' rows: N rounded up to 4 floats,
// and 4 more where that is a multiple of 32 (rows then start 4 banks apart)
__host__ __device__ inline int addr_stride(int N) {
  const int Np = (N + 3) & ~3;
  return Np % 32 == 0 ? Np + 4 : Np;
}

// slots per lane: the fewest of 1, 2, 4, 8 that cover N with 32 lanes
__host__ __device__ inline int addr_run(int N) { return N <= 32 ? 1 : N <= 64 ? 2 : N <= 128 ? 4 : 8; }
#define ADDR_MAX_SLOTS 256

// Offsets (in floats) of the addressing's shared arrays, from o.
struct AddrLayout {
  int Np;      // row stride of Mt and w
  int Mt;      // [D][Np] the memory, transposed
  int w;       // [H][Np] the head weights
  int ctl;     // [P] the raw head controls, in the fused linear's column order
  int Dp;      // D rounded up to 4: the row stride of kt, the length of minv
  int kt;      // [H][Dp] tanh(k), zero past D
  int hs;      // [H][4] softplus beta, sigmoid g, softplus gamma + 1, |tanh k|^-1
  int swv;     // [H][S] the shift weights
  int minv;    // [Dp] the across-slot normalizer (1 slotwise), zero past D
  int er, ad;  // [W][D] squashed erase and add
  int red;     // [min(R, warps)][D][33] a read warp's lanes' partial sums
  int total;
};

__host__ __device__ inline AddrLayout make_addr_layout(const Dims& d, int warps, int o = 0) {
  AddrLayout s;
  const int rw = d.R < warps ? d.R : warps;
  s.Np = addr_stride(d.N);
  s.Dp = (d.D + 3) & ~3;
  o = (o + 3) & ~3;
  s.Mt = take(o, d.D * s.Np);
  s.w = take(o, d.H * s.Np);
  s.kt = take(o, d.H * s.Dp);
  s.minv = take(o, s.Dp);
  s.hs = take(o, 4 * d.H);
  s.ctl = take(o, head_width(d));
  s.swv = take(o, d.H * d.S);
  s.er = take(o, d.W * d.D);
  s.ad = take(o, d.W * d.D);
  s.red = take(o, rw * d.D * 33);
  s.total = o;
  return s;
}

// Where the phases put what the caller keeps outside shared memory.
struct AddrOut {
  float* w_copy;  // [H][N] a copy of the new weights, or nullptr
  float* read;    // [R][D]
  float* M_copy;  // [N][D] a copy of the new memory, or nullptr
};

// RL consecutive floats from shared memory, in 16-byte loads where RL >= 4
// (a run of 8's second half only where `second`, else zeros)
template <int RL>
__device__ __forceinline__ void load_run(const float* p, float (&v)[RL], bool second) {
  if constexpr (RL == 1) {
    v[0] = p[0];
  } else if constexpr (RL == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < RL; i += 4) {
      const float4 t = (i == 0 || second) ? *reinterpret_cast<const float4*>(p + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      v[i] = t.x;
      v[i + 1] = t.y;
      v[i + 2] = t.z;
      v[i + 3] = t.w;
    }
  }
}

template <int RL>
__device__ __forceinline__ void store_run(float* p, const float (&v)[RL], bool second) {
  if constexpr (RL == 1) {
    p[0] = v[0];
  } else if constexpr (RL == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < RL; i += 4)
      if (i == 0 || second) *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

// rows d0 .. d0 + 3 of the lane's run (rows past D repeat row D - 1)
template <int RL>
__device__ __forceinline__ void load_rows4(const float* run, int Np, int d0, int D, float (&m)[4][RL], bool second) {
#pragma unroll
  for (int c = 0; c < 4; ++c) load_run<RL>(run + min(d0 + c, D - 1) * Np, m[c], second);
}

// v[e] for an index e that is the same on every lane (no local memory)
template <int RL>
__device__ __forceinline__ float pick(const float (&v)[RL], int e) {
  float r = v[0];
#pragma unroll
  for (int i = 1; i < RL; ++i) r = e == i ? v[i] : r;
  return r;
}

// the sum of red's row d over the 32 lanes: four runs of eight lanes, each
// in lane order, then (run 0 + run 1) + (run 2 + run 3)
__device__ __forceinline__ float lane_total(const float* red, int d) {
  float q[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    q[r] = red[d * 33 + 8 * r];
#pragma unroll
    for (int j = 1; j < 8; ++j) q[r] += red[d * 33 + 8 * r + j];
  }
  return (q[0] + q[1]) + (q[2] + q[3]);
}

// out[d] = sum over the warp's lanes of sum_i wv[i] * Mt[d][n0 + i]
// (d < D): each lane's partials into its column of red, then lane d adds
// row d. wv is zero where the lane holds no slot.
template <int RL>
__device__ __forceinline__ void warp_read(int D, const float* __restrict__ Mt, int Np, const float (&wv)[RL],
                                          float* __restrict__ red, float* __restrict__ out) {
  const int lane = threadIdx.x & 31, n0 = lane * RL;
  const bool second = n0 + 4 < Np;
  const float* run = Mt + (n0 < Np ? n0 : 0);
  for (int d0 = 0; d0 < D; d0 += 4) {
    float m[4][RL];
    load_rows4<RL>(run, Np, d0, D, m, second);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float p = 0.f;
#pragma unroll
      for (int i = 0; i < RL; ++i) p = fmaf(wv[i], m[c][i], p);
      if (d0 + c < D) red[(d0 + c) * 33 + lane] = p;
    }
  }
  __syncwarp();
  for (int d = lane; d < D; d += 32) out[d] = lane_total(red, d);
  __syncwarp();
}

// Phase (a), job j of one warp: j < H the head j's preparation; then the
// pairs of memory rows' normalizer (across-slot only); last erase and add
// and the normalizer's padding (and its ones, slotwise). Each job issues
// its shared loads before it uses any (clamped indices, masks after).
__device__ __forceinline__ void addr_prep(const Dims& dm, const Flags& fl, float* smem, const float* Mt,
                                          const AddrLayout& al, int j) {
  const int lane = threadIdx.x & 31;
  const int N = dm.N, D = dm.D, H = dm.H, S = dm.S, W = dm.W, Np = al.Np, Dp = al.Dp;
  const float* ctl = smem + al.ctl;
  const int pairs = fl.slotwise ? 0 : (D + 1) / 2;
  if (j < H) {
    const int h = j;
    const int oBeta = H * D, oGamma = H * D + 2 * H + S * H;
    const float* swr = ctl + H * D + 2 * H + h * S;
    // lanes 0, 1, 2: softplus beta, sigmoid g, softplus gamma + 1 (both
    // functions on every lane, no divergence); lanes over d: tanh(k); lanes
    // over j: the shift weights' softmax
    const float x = ctl[lane == 0 ? oBeta + h : lane == 1 ? oBeta + H + h : oGamma + h];
    const float kr = ctl[h * D + min(lane, D - 1)];
    const float sr = swr[min(lane, S - 1)];
    const float ex = expf(-fabsf(x));
    const float sp = fmaxf(x, 0.f) + log1pf(ex), sg = 1.f / (1.f + expf(-x));
    const float kt = lane < D ? tanhf(kr) : 0.f;
    float sraw = lane < S ? sr : __int_as_float(0xff800000);
    for (int k = lane + 32; k < S; k += 32) sraw = fmaxf(sraw, swr[k]);
    const float smx = warp_max(sraw);
    const float e0 = lane < S ? expf(sr - smx) : 0.f;
    float se = e0;
    for (int k = lane + 32; k < S; k += 32) se += expf(swr[k] - smx);
    float kss = kt * kt;
    for (int d = lane + 32; d < Dp; d += 32) {
      const float t = d < D ? tanhf(ctl[h * D + d]) : 0.f;
      smem[al.kt + h * Dp + d] = t;
      kss = fmaf(t, t, kss);
    }
    const float sinv = 1.f / warp_sum(se);
    kss = warp_sum(kss);
    if (lane < Dp) smem[al.kt + h * Dp + lane] = kt;
    if (lane < 3) smem[al.hs + 4 * h + lane] = lane == 0 ? sp : lane == 1 ? sg : sp + 1.f;
    if (lane == 3) smem[al.hs + 4 * h + 3] = rsqrtf(fmaxf(kss, 1e-12f));
    if (lane < S) smem[al.swv + h * S + lane] = e0 * sinv;
    for (int k = lane + 32; k < S; k += 32) smem[al.swv + h * S + k] = expf(swr[k] - smx) * sinv;
  } else if (j < H + pairs) {
    // rows d0 and d0 + 1: a lane per four slots, then warp sums
    const int d0 = 2 * (j - H), d1 = min(d0 + 1, D - 1);
    float s0 = 0.f, s1 = 0.f;
    for (int n = lane * 4; n < N; n += 128) {
      const float4 a = *reinterpret_cast<const float4*>(Mt + d0 * Np + n);
      const float4 b = *reinterpret_cast<const float4*>(Mt + d1 * Np + n);
      s0 += fmaf(a.x, a.x, fmaf(a.y, a.y, fmaf(a.z, a.z, a.w * a.w)));
      s1 += fmaf(b.x, b.x, fmaf(b.y, b.y, fmaf(b.z, b.z, b.w * b.w)));
    }
    s0 = warp_sum(s0);
    s1 = warp_sum(s1);
    if (lane == 0) {
      smem[al.minv + d0] = rsqrtf(fmaxf(s0, 1e-12f));
      smem[al.minv + d1] = rsqrtf(fmaxf(s1, 1e-12f));
    }
  } else if (j == H + pairs) {
    const float* raw = ctl + head_width(dm) - 2 * W * D;
    for (int i = lane; i < W * D; i += 32) {
      const float e = raw[i], a = raw[W * D + i];
      smem[al.er + i] = sigmoid_f(e);
      smem[al.ad + i] = tanhf(a);
    }
    for (int d = fl.slotwise ? lane : D + lane; d < Dp; d += 32) smem[al.minv + d] = d < D ? 1.f : 0.f;
  }
}

// Phase (b): head h's chain by one warp. Leaves the new weights in w's row
// h (and out.w_copy), and with read_now the head's read in out.read (the
// warp's scratch slot `warp` of red).
template <int RL, bool kProbe>
__device__ __forceinline__ void head_chain(const Dims& dm, const Flags& fl, float* smem, const AddrLayout& al,
                                           const AddrOut& out, int h, bool read_now, long long* stamps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* Mt = smem + al.Mt;
  const int N = dm.N, D = dm.D, S = dm.S, Np = al.Np;
  const float* kt = smem + al.kt + h * al.Dp;
  const float* minv = smem + al.minv;
  const int n0 = lane * RL;
  const bool live = n0 < N, second = n0 + 4 < Np;
  const float* run = Mt + (live ? n0 : 0);
  float* wrow = smem + al.w + h * Np;
#define CHAIN_STAMP(i) \
  if constexpr (kProbe) \
    if (threadIdx.x == 0 && h == 0) stamps[i] = clock64();

  const float bt = smem[al.hs + 4 * h], gt = smem[al.hs + 4 * h + 1];
  const float gm = smem[al.hs + 4 * h + 2], kinv = smem[al.hs + 4 * h + 3];
  float wp[RL];
  load_run<RL>(wrow + (live ? n0 : 0), wp, second);

  // the similarity: u[n] = sum_d tanh(k)[d] minv[d] M[n][d] (minv = 1
  // slotwise), and slotwise |M[n, :]|^2; kt and minv are zero past D
  float sim[RL], nrm[RL];
#pragma unroll
  for (int i = 0; i < RL; ++i) sim[i] = nrm[i] = 0.f;
  for (int d0 = 0; d0 < D; d0 += 4) {
    float m[4][RL];
    load_rows4<RL>(run, Np, d0, D, m, second);
    const float4 k4 = *reinterpret_cast<const float4*>(kt + d0);
    const float4 v4 = *reinterpret_cast<const float4*>(minv + d0);
    const float kd[4] = {k4.x * v4.x, k4.y * v4.y, k4.z * v4.z, k4.w * v4.w};
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int i = 0; i < RL; ++i) {
        sim[i] = fmaf(kd[c], m[c][i], sim[i]);
        if (d0 + c < D) nrm[i] = fmaf(m[c][i], m[c][i], nrm[i]);
      }
  }
  CHAIN_STAMP(0)

  // the softplus-beta softmax over slots and the interpolation gate
  const float ninf = __int_as_float(0xff800000);
  float mx = ninf;
#pragma unroll
  for (int i = 0; i < RL; ++i) {
    sim[i] *= fl.slotwise ? rsqrtf(fmaxf(nrm[i], 1e-12f)) * kinv : kinv;
    if (n0 + i < N) mx = fmaxf(mx, sim[i] * bt);
  }
  mx = warp_max(mx);
  float wg[RL], tot = 0.f;
#pragma unroll
  for (int i = 0; i < RL; ++i) {
    const float e = expf(sim[i] * bt - mx);
    wg[i] = n0 + i < N ? e : 0.f;
    tot += wg[i];
  }
  const float tinv = 1.f / warp_sum(tot);
#pragma unroll
  for (int i = 0; i < RL; ++i) wg[i] = n0 + i < N ? (wg[i] * tinv) * gt + wp[i] * (1.f - gt) : 0.f;
  CHAIN_STAMP(1)

  // the circular shift: conv[n] = sum_j sw[j] wg[(n + shift0 + j) mod N]. Slot
  // m = n0 + i + o (wrapped) is element m % RL of lane m / RL; the element
  // index is the same on every lane for each wrap class (none, +N, -N):
  // one shuffle where RL divides N (the classes agree), else three
  const int shift0 = -((S + 1) / 2);
  const float* swv = smem + al.swv + h * S;
  float conv[RL];
#pragma unroll
  for (int i = 0; i < RL; ++i) conv[i] = 0.f;
  if (N % RL == 0) {
    for (int j = 0; j < S; ++j) {
      const float swj = swv[j];
      const int o = shift0 + j;
      float v[RL];
#pragma unroll
      for (int i = 0; i < RL; ++i) {
        const int raw = n0 + i + o;
        const unsigned m = raw < 0 ? raw + N : (raw >= N ? raw - N : raw);
        v[i] = __shfl_sync(0xffffffffu, pick<RL>(wg, (i + o) & (RL - 1)), (m / RL) & 31);
      }
#pragma unroll
      for (int i = 0; i < RL; ++i) conv[i] = fmaf(swj, v[i], conv[i]);
    }
  } else {
    for (int j = 0; j < S; ++j) {
      const float swj = swv[j];
      const int o = shift0 + j;
      float v[RL];
#pragma unroll
      for (int i = 0; i < RL; ++i) {
        const int raw = n0 + i + o;
        const int cls = raw < 0 ? 1 : (raw >= N ? -1 : 0);
        const int src = ((raw + cls * N) / RL) & 31;
        const float v0 = __shfl_sync(0xffffffffu, pick<RL>(wg, (i + o) & (RL - 1)), src);
        const float vp = __shfl_sync(0xffffffffu, pick<RL>(wg, (i + o + N) & (RL - 1)), src);
        const float vm = __shfl_sync(0xffffffffu, pick<RL>(wg, (i + o - N) & (RL - 1)), src);
        v[i] = cls > 0 ? vp : (cls < 0 ? vm : v0);
      }
#pragma unroll
      for (int i = 0; i < RL; ++i) conv[i] = fmaf(swj, v[i], conv[i]);
    }
  }
  CHAIN_STAMP(2)

  // the gamma-sharpen, +1e-3 in the denominator
  float wn[RL], ptot = 0.f;
#pragma unroll
  for (int i = 0; i < RL; ++i) {
    const float p = exp2f(gm * log2f(conv[i]));
    wn[i] = n0 + i < N ? p : 0.f;
    ptot += wn[i];
  }
  const float pinv = 1.f / (warp_sum(ptot) + 1e-3f);
#pragma unroll
  for (int i = 0; i < RL; ++i) wn[i] *= pinv;
  if (n0 < Np) store_run<RL>(wrow + n0, wn, second);
  if (out.w_copy != nullptr)
#pragma unroll
    for (int i = 0; i < RL; ++i)
      if (n0 + i < N) out.w_copy[h * N + n0 + i] = wn[i];
  CHAIN_STAMP(3)

  if (read_now) warp_read<RL>(D, Mt, Np, wn, smem + al.red + warp * D * 33, out.read + h * D);
  CHAIN_STAMP(4)
#undef CHAIN_STAMP
}

// The erase/add product of four slots n .. n + 3 of row d:
// M * prod_wh (1 - w_wh e_wh[d]) + sum_wh w_wh a_wh[d]
__device__ __forceinline__ float4 erase_add4(float4 m, const float* smem, const AddrLayout& al, const Dims& dm,
                                             int d, int n) {
  float4 ek = make_float4(1.f, 1.f, 1.f, 1.f), ak = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int wh = 0; wh < dm.W; ++wh) {
    const float4 w = *reinterpret_cast<const float4*>(smem + al.w + (dm.R + wh) * al.Np + n);
    const float e = smem[al.er + wh * dm.D + d], a = smem[al.ad + wh * dm.D + d];
    ek.x *= 1.f - w.x * e;
    ek.y *= 1.f - w.y * e;
    ek.z *= 1.f - w.z * e;
    ek.w *= 1.f - w.w * e;
    ak.x = fmaf(w.x, a, ak.x);
    ak.y = fmaf(w.y, a, ak.y);
    ak.z = fmaf(w.z, a, ak.z);
    ak.w = fmaf(w.w, a, ak.w);
  }
  return make_float4(m.x * ek.x + ak.x, m.y * ek.y + ak.y, m.z * ek.z + ak.z, m.w * ek.w + ak.w);
}

// Phase (c): the write in place, a warp per memory row, a lane per four
// slots.
template <int NTH>
__device__ __forceinline__ void addr_write(const Dims& dm, float* smem, const AddrLayout& al) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = warp; d < dm.D; d += NTH / 32)
    for (int n = lane * 4; n < dm.N; n += 128) {
      float4* p = reinterpret_cast<float4*>(smem + al.Mt + d * al.Np + n);
      *p = erase_add4(*p, smem, al, dm, d, n);
    }
}

// Mt copied to out [N][D], each thread four consecutive elements at a time
// (16-byte stores where N*D is a multiple of 4)
template <int NTH>
__device__ __forceinline__ void addr_copy_out(const Dims& dm, const float* smem, const AddrLayout& al, float* out) {
  const int D = dm.D, ND = dm.N * D, Np = al.Np;
  for (int i = threadIdx.x * 4; i < ND; i += NTH * 4) {
    int n = i / D, d = i - n * D;
    float v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      v[c] = smem[al.Mt + d * Np + min(n, dm.N - 1)];
      if (++d == D) {
        d = 0;
        ++n;
      }
    }
    if ((ND & 3) == 0) {
      *reinterpret_cast<float4*>(out + i) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (i + c < ND) out[i + c] = v[c];
    }
  }
}

template <int NTH, int RL, bool kProbe>
__device__ __forceinline__ void addr_phases(const Dims& dm, const Flags& fl, float* smem, const AddrLayout& al,
                                            const AddrOut& out, long long* stamps) {
  constexpr int NW = NTH / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int D = dm.D, H = dm.H, R = dm.R;
#define PHASE_STAMP(i) \
  if constexpr (kProbe) \
    if (threadIdx.x == 0) stamps[i] = clock64();
  // (a) the heads' preparation, the normalizer, erase and add
  const int jobs = H + (fl.slotwise ? 0 : (D + 1) / 2) + 1;
  for (int j = warp; j < jobs; j += NW) addr_prep(dm, fl, smem, smem + al.Mt, al, j);
  __syncthreads();
  PHASE_STAMP(0)
  // (b) the head chains
  for (int h = warp; h < H; h += NW)
    head_chain<RL, kProbe>(dm, fl, smem, al, out, h, !fl.write_first && h < R, kProbe ? stamps + 4 : nullptr);
  __syncthreads();
  PHASE_STAMP(1)
  // (c) the write; then the read after it and the copy of the new memory
  addr_write<NTH>(dm, smem, al);
  if (fl.write_first || out.M_copy != nullptr) {
    __syncthreads();
    PHASE_STAMP(2)
    if (fl.write_first)
      for (int h = warp; h < R; h += NW) {
        const int n0 = lane * RL;
        float wv[RL] = {};
        if (n0 < al.Np) load_run<RL>(smem + al.w + h * al.Np + n0, wv, n0 + 4 < al.Np);
        warp_read<RL>(D, smem + al.Mt, al.Np, wv, smem + al.red + warp * D * 33, out.read + h * D);
      }
    if (out.M_copy != nullptr) addr_copy_out<NTH>(dm, smem, al, out.M_copy);
  }
  if (out.M_copy == nullptr || kProbe) __syncthreads();
  PHASE_STAMP(3)
#undef PHASE_STAMP
}

// One step's addressing, write and read for one batch row by the block's
// NTH threads. Enters after a barrier that published the raw controls, Mt
// and w (in al's layout, their columns n >= N zero); leaves the new w and
// Mt in place and the read in out.read, with copies in out.w_copy and
// out.M_copy where set. Without out.M_copy (B1's cluster route) it returns
// after a barrier that publishes everything. kProbe: stamps[0..3] after
// phase (a), (b), the write and the end, stamps[4..8] inside head 0's
// chain (thread 0).
template <int NTH, bool kProbe = false>
__device__ __forceinline__ void ntm_addressing(const Dims& dm, const Flags& fl, float* smem, const AddrLayout& al,
                                               const AddrOut& out, long long* stamps = nullptr) {
  switch (addr_run(dm.N)) {
    case 1:
      addr_phases<NTH, 1, kProbe>(dm, fl, smem, al, out, stamps);
      break;
    case 2:
      addr_phases<NTH, 2, kProbe>(dm, fl, smem, al, out, stamps);
      break;
    case 4:
      addr_phases<NTH, 4, kProbe>(dm, fl, smem, al, out, stamps);
      break;
    default:
      addr_phases<NTH, 8, kProbe>(dm, fl, smem, al, out, stamps);
  }
}
