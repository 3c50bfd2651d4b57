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

// The addressing phases of one step, everything after the head linear:
// from the raw head controls in ctl (the fused linear's column order k,
// beta, g, sw, gamma, erase, add) and M_in / w_in, the new w_out, read_out
// and M_out, with every intermediate kept in its shared array. B1's
// cluster kernel (scan_cell.cu) and B3's kernel (addressing.cu) run it. Enters
// after a __syncthreads() that published ctl, M_in and w_in; returns after
// one that publishes the outputs.
__device__ __forceinline__ void ntm_addressing(const Dims& dm, const Flags& fl, float* smem,
                                               const Layout& lay) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = dm.N, D = dm.D, H = dm.H, R = dm.R, W = dm.W, S = dm.S;
  const float* M_in = smem + lay.M_in;
  const float* w_in = smem + lay.w_in;
  float* M_out = smem + lay.M_out;
  float* w_out = smem + lay.w_out;
  float* read_out = smem + lay.read_out;
  const float* ctl = smem + lay.ctl;
  float* mss = smem + lay.mss;
  float* minv = smem + lay.minv;
  float* ks = smem + lay.k;
  float* kss = smem + lay.kss;
  float* kinv = smem + lay.kinv;
  float* beta = smem + lay.beta;
  float* gg = smem + lay.g;
  float* gamma = smem + lay.gamma;
  float* sw = smem + lay.sw;
  float* denom = smem + lay.denom;
  float* u = smem + lay.u;
  float* sim = smem + lay.sim;
  float* wc = smem + lay.wc;
  float* wg = smem + lay.wg;
  float* wconv = smem + lay.wconv;
  float* powed = smem + lay.powed;
  float* erase = smem + lay.erase;
  float* add = smem + lay.add;

  // offsets of the fused head-parameter unpack (k, beta, g, sw, gamma, erase, add)
  const int oBeta = H * D, oG = oBeta + H, oSw = oG + H, oGamma = oSw + S * H;
  const int oErase = oGamma + H, oAdd = oErase + W * D;
  const int RD = R * D, shift0 = -((S + 1) / 2);

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
  if (fl.slotwise) {
    // rsqrt(max(|M[n,:]|^2, 1e-12)) per slot
    for (int n = tid; n < N; n += NT) {
      float sq = 0.f;
      for (int d = 0; d < D; ++d) sq = fmaf(M_in[n * D + d], M_in[n * D + d], sq);
      mss[n] = sq;
      minv[n] = rsqrtf(fmaxf(sq, 1e-12f));
    }
  } else {
    // the executed reference: each mem_dim row normalized across slots
    for (int d = warp; d < D; d += NWARPS) {
      float sq = 0.f;
      for (int n = lane; n < N; n += 32) sq = fmaf(M_in[n * D + d], M_in[n * D + d], sq);
      sq = warp_sum(sq);
      if (lane == 0) {
        mss[d] = sq;
        minv[d] = rsqrtf(fmaxf(sq, 1e-12f));
      }
    }
  }
  __syncthreads();
  for (int hh = tid; hh < H; hh += NT) {
    float sq = 0.f;
    for (int d = 0; d < D; ++d) sq = fmaf(ks[hh * D + d], ks[hh * D + d], sq);
    kss[hh] = sq;
    kinv[hh] = rsqrtf(fmaxf(sq, 1e-12f));
  }
  __syncthreads();

  // ---- content similarity: u = k . Mtn, sim = u * |k|^-1 ----------------------
  for (int i = tid; i < H * N; i += NT) {
    const int hh = i / N, n = i - hh * N;
    float acc = 0.f;
    for (int d = 0; d < D; ++d) {
      const float m = M_in[n * D + d] * (fl.slotwise ? minv[n] : minv[d]);
      acc = fmaf(ks[hh * D + d], m, acc);
    }
    u[i] = acc;
    sim[i] = acc * kinv[hh];
  }
  __syncthreads();

  // ---- softplus-beta softmax and the interpolation gate (warp per head) --
  for (int hh = warp; hh < H; hh += NWARPS) {
    const float* row = sim + hh * N;
    const float bt = beta[hh], gt = gg[hh];
    float mx = __int_as_float(0xff800000);  // -inf
    for (int n = lane; n < N; n += 32) mx = fmaxf(mx, row[n] * bt);
    mx = warp_max(mx);
    float tot = 0.f;
    for (int n = lane; n < N; n += 32) tot += expf(row[n] * bt - mx);
    tot = warp_sum(tot);
    for (int n = lane; n < N; n += 32) {
      const float wcv = expf(row[n] * bt - mx) / tot;
      wc[hh * N + n] = wcv;
      wg[hh * N + n] = wcv * gt + w_in[hh * N + n] * (1.f - gt);
    }
  }
  __syncthreads();

  // ---- circular shift and gamma-sharpen (warp per head) -------------------
  for (int hh = warp; hh < H; hh += NWARPS) {
    const float gm = gamma[hh];
    float tot = 0.f;
    for (int n = lane; n < N; n += 32) {
      float conv = 0.f;
      for (int j = 0; j < S; ++j)
        conv = fmaf(sw[hh * S + j], wg[hh * N + wrap(n + shift0 + j, N)], conv);
      const float p = powf(conv, gm);
      wconv[hh * N + n] = conv;
      powed[hh * N + n] = p;
      tot += p;
    }
    tot = warp_sum(tot) + 1e-3f;
    if (lane == 0) denom[hh] = tot;
    for (int n = lane; n < N; n += 32) w_out[hh * N + n] = powed[hh * N + n] / tot;
  }
  __syncthreads();

  // ---- read (before or after the write) and the erase/add write -----------
  for (int pass = 0; pass < 2; ++pass) {
    const bool do_read = (pass == 0) != (fl.write_first != 0);
    if (do_read) {
      const float* src = fl.write_first ? M_out : M_in;
      for (int o = warp; o < RD; o += NWARPS) {
        const int r = o / D, d = o - r * D;
        float acc = 0.f;
        for (int n = lane; n < N; n += 32) acc = fmaf(w_out[r * N + n], src[n * D + d], acc);
        acc = warp_sum(acc);
        if (lane == 0) read_out[o] = acc;
      }
    } else {
      for (int i = tid; i < N * D; i += NT) {
        const int n = i / D, d = i - n * D;
        float er = 1.f, ad = 0.f;
        for (int wh = 0; wh < W; ++wh) {
          const float ww = w_out[(R + wh) * N + n];
          er *= 1.f - ww * erase[wh * D + d];
          ad = fmaf(ww, add[wh * D + d], ad);
        }
        M_out[i] = M_in[i] * er + ad;
      }
    }
    __syncthreads();
  }
}
