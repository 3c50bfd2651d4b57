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
// Plain C interface (no PyTorch headers): built by nvcc into a shared
// library and called through ctypes (ntm_tracker_tpu_torch/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define NT 512
#define NWARPS (NT / 32)
#define MAX_LAYERS 8

struct ScanArgs {
  const float* tokens;              // [B, T, IN]
  const float* lstm_w[MAX_LAYERS];  // layer l: [in_l + Hc, 4*Hc]
  const float* lstm_b[MAX_LAYERS];  // [4*Hc]
  const float* heads_w;             // [Hc, P]
  const float* heads_b;             // [P]
  const float* out_w;               // [Hc, O]
  const float* out_b;               // [O]
  const float* M0;                  // [B, N, D]
  const float* w0;                  // [B, H, N]
  const float* read0;               // [B, R, D]
  const float* c0[MAX_LAYERS];      // [B, Hc]
  const float* h0[MAX_LAYERS];      // [B, Hc]
  float* logits;                    // [B, T, O]
  float* M;                         // [B, N, D]
  float* w;                         // [B, H, N]
  float* read;                      // [B, R, D]
  float* c;                         // [L, B, Hc]
  float* h;                         // [L, B, Hc]
  int B, T, IN, N, D, H, R, W, S, Hc, L, O;
  int write_first, slotwise, bf16;
};

// Offsets (in floats) of the shared-memory arrays; one definition serves
// the host (sizing) and the device (carving).
struct Layout {
  int inp, gates, c, h, controls, M, w, sim, read, minv, k, kinv, beta, g,
      gamma, sw, erase, add, total;
};

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline Layout make_layout(int IN, int N, int D, int H, int R,
                                              int W, int S, int Hc, int L) {
  const int P = H * D + 3 * H + S * H + 2 * W * D;
  Layout s;
  int o = 0;
  s.inp = o;      o += imax(IN + R * D + Hc, 2 * Hc);
  s.gates = o;    o += 4 * Hc;
  s.c = o;        o += L * Hc;
  s.h = o;        o += L * Hc;
  s.controls = o; o += P;
  s.M = o;        o += N * D;
  s.w = o;        o += H * N;
  s.sim = o;      o += H * N;
  s.read = o;     o += R * D;
  s.minv = o;     o += imax(N, D);
  s.k = o;        o += H * D;
  s.kinv = o;     o += H;
  s.beta = o;     o += H;
  s.g = o;        o += H;
  s.gamma = o;    o += H;
  s.sw = o;       o += H * S;
  s.erase = o;    o += W * D;
  s.add = o;      o += W * D;
  s.total = o;
  return s;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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

// out[j] = bias[j] + sum_k in[k] * Wm[k, j] for j < ncol, one column per
// thread; consecutive threads read consecutive columns (coalesced).
__device__ __forceinline__ void gemv(const float* __restrict__ Wm,
                                     const float* __restrict__ bias,
                                     const float* in, int K, int ncol,
                                     float* out, int bf16) {
  for (int j = threadIdx.x; j < ncol; j += NT) {
    float acc = 0.f;
    if (bf16) {
      for (int k = 0; k < K; ++k)
        acc = fmaf(bf16_round(in[k]), bf16_round(__ldg(Wm + (size_t)k * ncol + j)), acc);
      acc = bf16_round(acc);
    } else {
#pragma unroll 8
      for (int k = 0; k < K; ++k) acc = fmaf(in[k], __ldg(Wm + (size_t)k * ncol + j), acc);
    }
    out[j] = acc + __ldg(bias + j);
  }
}

__global__ void __launch_bounds__(NT, 1) ntm_scan_cell_kernel(const ScanArgs a) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int IN = a.IN, N = a.N, D = a.D, H = a.H, R = a.R, W = a.W, S = a.S;
  const int Hc = a.Hc, L = a.L, O = a.O, T = a.T;
  const Layout lay = make_layout(IN, N, D, H, R, W, S, Hc, L);
  float* inp = smem + lay.inp;
  float* gates = smem + lay.gates;
  float* cs = smem + lay.c;
  float* hs = smem + lay.h;
  float* ctl = smem + lay.controls;
  float* Ms = smem + lay.M;
  float* ws = smem + lay.w;
  float* sim = smem + lay.sim;
  float* rd = smem + lay.read;
  float* minv = smem + lay.minv;
  float* ks = smem + lay.k;
  float* kinv = smem + lay.kinv;
  float* beta = smem + lay.beta;
  float* gg = smem + lay.g;
  float* gamma = smem + lay.gamma;
  float* sw = smem + lay.sw;
  float* erase = smem + lay.erase;
  float* add = smem + lay.add;

  // offsets of the fused head-parameter unpack (k, beta, g, sw, gamma, erase, add)
  const int oBeta = H * D, oG = oBeta + H, oSw = oG + H, oGamma = oSw + S * H;
  const int oErase = oGamma + H, oAdd = oErase + W * D;
  const int P = oAdd + W * D;
  const int RD = R * D, shift0 = -((S + 1) / 2);

  for (int i = tid; i < N * D; i += NT) Ms[i] = a.M0[(size_t)b * N * D + i];
  for (int i = tid; i < H * N; i += NT) ws[i] = a.w0[(size_t)b * H * N + i];
  for (int i = tid; i < RD; i += NT) rd[i] = a.read0[(size_t)b * RD + i];
  for (int l = 0; l < L; ++l)
    for (int i = tid; i < Hc; i += NT) {
      cs[l * Hc + i] = a.c0[l][(size_t)b * Hc + i];
      hs[l * Hc + i] = a.h0[l][(size_t)b * Hc + i];
    }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // ---- stacked LSTM controller ------------------------------------------
    const float* x = a.tokens + ((size_t)b * T + t) * IN;
    for (int i = tid; i < IN; i += NT) inp[i] = x[i];
    for (int i = tid; i < RD; i += NT) inp[IN + i] = rd[i];
    for (int i = tid; i < Hc; i += NT) inp[IN + RD + i] = hs[i];
    __syncthreads();
    for (int l = 0; l < L; ++l) {
      const int K = (l == 0 ? IN + RD : Hc) + Hc;
      gemv(a.lstm_w[l], a.lstm_b[l], inp, K, 4 * Hc, gates, a.bf16);
      __syncthreads();
      for (int j = tid; j < Hc; j += NT) {
        const float ig = gates[j], jg = gates[Hc + j], fg = gates[2 * Hc + j],
                    og = gates[3 * Hc + j];
        const float c_new = cs[l * Hc + j] * sigmoid_f(fg) + sigmoid_f(ig) * tanhf(jg);
        const float h_new = tanhf(c_new) * sigmoid_f(og);
        cs[l * Hc + j] = c_new;
        hs[l * Hc + j] = h_new;
        if (l + 1 < L) {
          inp[j] = h_new;
          inp[Hc + j] = hs[(l + 1) * Hc + j];
        }
      }
      __syncthreads();
    }
    const float* ctrl = hs + (L - 1) * Hc;

    // ---- head controls and the output linear ---------------------------------
    gemv(a.heads_w, a.heads_b, ctrl, Hc, P, ctl, a.bf16);
    for (int o = warp; o < O; o += NWARPS) {
      float acc = 0.f;
      for (int k = lane; k < Hc; k += 32) {
        const float wv = __ldg(a.out_w + (size_t)k * O + o);
        acc = a.bf16 ? fmaf(bf16_round(ctrl[k]), bf16_round(wv), acc) : fmaf(ctrl[k], wv, acc);
      }
      acc = warp_sum(acc);
      if (lane == 0)
        a.logits[((size_t)b * T + t) * O + o] =
            (a.bf16 ? bf16_round(acc) : acc) + __ldg(a.out_b + o);
    }
    __syncthreads();

    // ---- squashed head parameters and the memory normalizer ----------------
    for (int i = tid; i < H * D; i += NT) ks[i] = tanhf(ctl[i]);
    for (int i = tid; i < W * D; i += NT) {
      erase[i] = sigmoid_f(ctl[oErase + i]);
      add[i] = tanhf(ctl[oAdd + i]);
    }
    for (int hh = tid; hh < H; hh += NT) {
      beta[hh] = softplus_f(ctl[oBeta + hh]);
      gg[hh] = sigmoid_f(ctl[oG + hh]);
      gamma[hh] = softplus_f(ctl[oGamma + hh]) + 1.f;
      const float* s_raw = ctl + oSw + hh * S;
      float mx = s_raw[0];
      for (int j = 1; j < S; ++j) mx = fmaxf(mx, s_raw[j]);
      float tot = 0.f;
      for (int j = 0; j < S; ++j) tot += expf(s_raw[j] - mx);
      for (int j = 0; j < S; ++j) sw[hh * S + j] = expf(s_raw[j] - mx) / tot;
    }
    if (a.slotwise) {
      // rsqrt(max(|M[n,:]|^2, 1e-12)) per slot
      for (int n = tid; n < N; n += NT) {
        float sq = 0.f;
        for (int d = 0; d < D; ++d) sq = fmaf(Ms[n * D + d], Ms[n * D + d], sq);
        minv[n] = rsqrtf(fmaxf(sq, 1e-12f));
      }
    } else {
      // the executed reference: each mem_dim row normalized across slots
      for (int d = warp; d < D; d += NWARPS) {
        float sq = 0.f;
        for (int n = lane; n < N; n += 32) sq = fmaf(Ms[n * D + d], Ms[n * D + d], sq);
        sq = warp_sum(sq);
        if (lane == 0) minv[d] = rsqrtf(fmaxf(sq, 1e-12f));
      }
    }
    __syncthreads();
    for (int hh = tid; hh < H; hh += NT) {
      float sq = 0.f;
      for (int d = 0; d < D; ++d) sq = fmaf(ks[hh * D + d], ks[hh * D + d], sq);
      kinv[hh] = rsqrtf(fmaxf(sq, 1e-12f));
    }
    __syncthreads();

    // ---- content similarity -------------------------------------------------
    for (int i = tid; i < H * N; i += NT) {
      const int hh = i / N, n = i - hh * N;
      float acc = 0.f;
      for (int d = 0; d < D; ++d) {
        const float m = Ms[n * D + d] * (a.slotwise ? minv[n] : minv[d]);
        acc = fmaf(ks[hh * D + d] * kinv[hh], m, acc);
      }
      sim[i] = acc;
    }
    __syncthreads();

    // ---- softplus-beta softmax and the interpolation gate (warp per head) --
    for (int hh = warp; hh < H; hh += NWARPS) {
      float* row = sim + hh * N;
      const float bt = beta[hh], gt = gg[hh];
      float mx = __int_as_float(0xff800000);  // -inf
      for (int n = lane; n < N; n += 32) mx = fmaxf(mx, row[n] * bt);
      mx = warp_max(mx);
      float tot = 0.f;
      for (int n = lane; n < N; n += 32) tot += expf(row[n] * bt - mx);
      tot = warp_sum(tot);
      for (int n = lane; n < N; n += 32) {
        const float wc = expf(row[n] * bt - mx) / tot;
        row[n] = wc * gt + ws[hh * N + n] * (1.f - gt);
      }
    }
    __syncthreads();

    // ---- circular shift and gamma-sharpen (warp per head) -------------------
    for (int hh = warp; hh < H; hh += NWARPS) {
      const float* row = sim + hh * N;
      const float gm = gamma[hh];
      float tot = 0.f;
      for (int n = lane; n < N; n += 32) {
        float conv = 0.f;
        for (int j = 0; j < S; ++j) {
          int src = (n + shift0 + j) % N;
          if (src < 0) src += N;
          conv = fmaf(sw[hh * S + j], row[src], conv);
        }
        const float p = powf(conv, gm);
        ws[hh * N + n] = p;
        tot += p;
      }
      tot = warp_sum(tot) + 1e-3f;
      for (int n = lane; n < N; n += 32) ws[hh * N + n] = ws[hh * N + n] / tot;
    }
    __syncthreads();

    // ---- read (before or after the write) and the erase/add write -----------
    for (int pass = 0; pass < 2; ++pass) {
      const bool do_read = (pass == 0) != (a.write_first != 0);
      if (do_read) {
        for (int o = warp; o < RD; o += NWARPS) {
          const int r = o / D, d = o - r * D;
          float acc = 0.f;
          for (int n = lane; n < N; n += 32) acc = fmaf(ws[r * N + n], Ms[n * D + d], acc);
          acc = warp_sum(acc);
          if (lane == 0) rd[o] = acc;
        }
      } else {
        for (int i = tid; i < N * D; i += NT) {
          const int n = i / D, d = i - n * D;
          float er = 1.f, ad = 0.f;
          for (int wh = 0; wh < W; ++wh) {
            const float ww = ws[(R + wh) * N + n];
            er *= 1.f - ww * erase[wh * D + d];
            ad = fmaf(ww, add[wh * D + d], ad);
          }
          Ms[i] = Ms[i] * er + ad;
        }
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < N * D; i += NT) a.M[(size_t)b * N * D + i] = Ms[i];
  for (int i = tid; i < H * N; i += NT) a.w[(size_t)b * H * N + i] = ws[i];
  for (int i = tid; i < RD; i += NT) a.read[(size_t)b * RD + i] = rd[i];
  for (int l = 0; l < L; ++l)
    for (int i = tid; i < Hc; i += NT) {
      a.c[((size_t)l * a.B + b) * Hc + i] = cs[l * Hc + i];
      a.h[((size_t)l * a.B + b) * Hc + i] = hs[l * Hc + i];
    }
}

extern "C" int ntm_scan_cell_smem_bytes(int IN, int N, int D, int H, int R, int W,
                                        int S, int Hc, int L) {
  return make_layout(IN, N, D, H, R, W, S, Hc, L).total * (int)sizeof(float);
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
  if (L < 1 || L > MAX_LAYERS || B < 1 || T < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  ScanArgs a;
  a.tokens = (const float*)tokens;
  for (int l = 0; l < MAX_LAYERS; ++l) {
    a.lstm_w[l] = l < L ? (const float*)lstm_w[l] : nullptr;
    a.lstm_b[l] = l < L ? (const float*)lstm_b[l] : nullptr;
    a.c0[l] = l < L ? (const float*)c0[l] : nullptr;
    a.h0[l] = l < L ? (const float*)h0[l] : nullptr;
  }
  a.heads_w = (const float*)heads_w;
  a.heads_b = (const float*)heads_b;
  a.out_w = (const float*)out_w;
  a.out_b = (const float*)out_b;
  a.M0 = (const float*)M0;
  a.w0 = (const float*)w0;
  a.read0 = (const float*)read0;
  a.logits = (float*)logits;
  a.M = (float*)M;
  a.w = (float*)w;
  a.read = (float*)read;
  a.c = (float*)c;
  a.h = (float*)h;
  a.B = B; a.T = T; a.IN = IN; a.N = N; a.D = D; a.H = H; a.R = R; a.W = W;
  a.S = S; a.Hc = Hc; a.L = L; a.O = O;
  a.write_first = write_first; a.slotwise = slotwise; a.bf16 = bf16;
  const int smem = ntm_scan_cell_smem_bytes(IN, N, D, H, R, W, S, Hc, L);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(ntm_scan_cell_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  ntm_scan_cell_kernel<<<B, NT, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
