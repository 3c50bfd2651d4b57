// T NTM cell steps in one launch on a thread-block cluster per batch row:
// B1's cluster route, the streaming tracker's per-frame cell loop at small
// B (ntm_tracker_tpu_torch/ops/kernels/scan_cell.py).
//
// Replaces ntm_tracker_tpu/ops/pallas/scan_cell.py:_step_kernel (the Pallas
// body of ntm_scan_fused). Each step: stacked LSTM on [x | read | h], the
// fused head linear, tanh(k), cosine against memory (across-slot or
// slotwise), softplus-beta softmax, sigmoid gate, circular shift with the
// Python-2 offsets, gamma-sharpen with +1e-3, erase/add write, read before
// or after the write, and the output linear. B1's other route, for large B,
// is scan_bptt.cu's ntm_bptt_fwd_kernel<RT, false> (a tile of rows per
// block); both take layer 0's token part from scan_bptt.cu's token
// projection, launched first over every step of the call.
//
// What bounds it on an H100: at B=1 the work is a serial chain of T
// dependent steps, each far below the card's FLOP and HBM rates. A single
// block reading the [IN + R*D + Hc, 4*Hc] LSTM kernel (2.5 MB at the
// flagship config) and the head linear from L2 every step is held to one
// SM's L2 read rate, ~57 us a step (PERF.md). The design removes those
// reads from the chain:
// - The token rows W0[:IN] leave the recurrence: proj = X W0[:IN] (+ b0)
//   for every step at once, a GEMM, before this kernel.
// - A cluster of C CTAs on neighbouring SMs owns one batch row. CTA r
//   copies its slices into its own shared memory once per launch
//   (cp.async): each layer's recurrent kernel (W0[IN:] for layer 0) cut to
//   the four gate columns {u, Hc+u, 2Hc+u, 3Hc+u} of its U = ceil(Hc / C)
//   hidden units, transposed so that row q*U + u holds gate q of unit
//   r*U + u; their biases; a run of Pc = ceil(P / C) head-linear columns
//   (the last runs may be shorter or empty: 7 x 22 + 16 of P = 170 at C =
//   8); and the output linear. At the flagship config and C = 8 that is
//   132 KB, beside the row's 27 KB of state (the addressing's arrays,
//   make_addr_layout, and the cell state), 167 KB in all.
// - Each step, CTA r: (1) computes its units' gates from shared memory,
//   the lanes of a warp one gate row each and the warps a run of the
//   gathered [read | h] each (no shuffles; the partial sums are added in
//   warp order), plus proj's row (its loads issued before the product),
//   then the units' c and h; (2) writes its h into every CTA's gather
//   vector of the next step through distributed shared memory, then
//   cluster.sync() (once per layer: layer l+1 reads layer l's new h); (3)
//   computes its head-linear columns, a warp per column, and writes them
//   into every CTA's head controls, rank 0 also the logits, then
//   cluster.sync(); (4) runs the addressing, read and erase/add write
//   (ntm_addressing() of ntm_step.cuh) on its own copy of M and w, so every
//   CTA has the new read vector without a third exchange.
// - What bounds it now (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W;
//   PERF.md): ~9 us a step at B=1. The addressing's phases (ntm_step.cuh,
//   the same as B3's: ~4 us of them for one row) take a little under half
//   of it; the gate product, the head linear and the two cluster barriers
//   the rest.
// - Every CTA computes the same addressing on the same bits in the same
//   order: nothing in it depends on the rank, so the copies of M, w and
//   read never drift apart. Each gate and head control is computed by one
//   CTA and copied, never recomputed elsewhere.
// - The gather vectors are double-buffered by step parity: a CTA writes
//   step t+1's h while others may still read step t's, and the barriers of
//   step t order every write against the last read of the buffer it
//   overwrites (the head controls: the layer barriers of step t+1 come
//   after every CTA's addressing of step t).
//
// compute_dtype=bf16 is reproduced as the JAX package does it
// (scan_cell.py:71-86): the slices are rounded to bf16 once, as they are
// loaded; the products' inputs are rounded as they are read; proj is then
// the rounded tokens' product with the rounded W0[:IN], without b0, and
// each gate is the f32 sum proj + recurrent part, rounded once, plus b0
// (mm_bias); everything else stays f32.
//
// Plain C interface (no PyTorch headers): built by nvcc into a shared
// library and called through ctypes (ntm_tracker_tpu_torch/_build.py).

#include <cooperative_groups.h>

#include "ntm_step.cuh"

namespace cg = cooperative_groups;

// the largest portable cluster
#define MAX_CLUSTER 8

struct ClusterArgs {
  const float* proj;  // [B*T, 4*Hc] layer 0's token part of every step
  Weights wt;
  const float* M0;    // [B, N, D]
  const float* w0;    // [B, H, N]
  const float* read0; // [B, R*D]
  const float* c0;    // [L, B, Hc]
  const float* h0;    // [L, B, Hc]
  float* logits;      // [B, T, O]
  float* M;           // [B, N, D] the final state
  float* w;           // [B, H, N]
  float* read;        // [B, R*D]
  float* c;           // [L, B, Hc]
  float* h;           // [L, B, Hc]
  Dims dm;
  Flags fl;
  int B, T, C;
};

// A CTA's shared memory: the row's addressing state (make_addr_layout: the
// memory transposed, w, the head controls, their scratch), its cell state
// c, then its share of the weights and the row's gather vectors (offsets in
// floats). The matmul operands come first, in one run (bf16 rounds it at
// load), then their biases. Slice rows have an odd stride, so the
// transposing copies spread over the banks, and so do a warp's lanes
// reading one gate row each.
struct Slice {
  AddrLayout al;             // Mt [D][Np], w [H][Np], the head controls, their scratch
  int c;                     // [L][Hc] the cell state
  int U, Pc;                 // hidden units and head-linear columns per CTA
  int wl[MAX_LAYERS];        // layer l's gate rows [4U][kl[l]]
  int kl[MAX_LAYERS];        // their stride: the layer's recurrent inputs K_l, made odd
  int ldh;                   // Hc made odd: the stride of the two below
  int hw;                    // head-linear columns [Pc][ldh]
  int ow;                    // the output linear [O][ldh]
  int bl;                    // the gate rows' biases [L][4U]
  int hb, ob;                // the head columns' biases [Pc], the output's [O]
  int xs[2];                 // step parity's gather vector [read | h_0 | ... | h_{L-1}]
  int part;                  // [NWARPS][4U] the warps' partial gate sums
  int total;
};

__host__ __device__ inline Slice make_slice(const Dims& d, int C) {
  const int RD = d.R * d.D, Hc = d.Hc;
  Slice s;
  s.al = make_addr_layout(d, NWARPS);
  int o = s.al.total;
  s.c = take(o, d.L * Hc);
  s.U = (Hc + C - 1) / C;
  s.Pc = (head_width(d) + C - 1) / C;
  o = (o + 3) & ~3;
  for (int l = 0; l < MAX_LAYERS; ++l) {
    s.kl[l] = (l == 0 ? RD + Hc : 2 * Hc) | 1;
    s.wl[l] = l < d.L ? take(o, 4 * s.U * s.kl[l]) : -1;
  }
  s.ldh = Hc | 1;
  s.hw = take(o, s.Pc * s.ldh);
  s.ow = take(o, d.O * s.ldh);
  s.bl = take(o, d.L * 4 * s.U);
  s.hb = take(o, s.Pc);
  s.ob = take(o, d.O);
  s.xs[0] = take(o, RD + d.L * Hc);
  s.xs[1] = take(o, RD + d.L * Hc);
  s.part = take(o, NWARPS * 4 * s.U);
  s.total = o;
  return s;
}

// sum_k x1[k] w[k] over k < K1 plus sum_k x2[k] w[K1 + k] over k < K2, by
// one warp: lanes over k in order, then warp_sum (every lane gets the
// sum). bf16 rounds the inputs (the slice rows were rounded at load).
__device__ __forceinline__ float row_dot(const float* w, const float* x1, int K1, const float* x2, int K2,
                                         bool bf16) {
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int k = lane; k < K1; k += 32) acc = fmaf(bf16 ? bf16_round(x1[k]) : x1[k], w[k], acc);
  for (int k = lane; k < K2; k += 32) acc = fmaf(bf16 ? bf16_round(x2[k]) : x2[k], w[K1 + k], acc);
  return warp_sum(acc);
}

// part[w * nrow + j] = sum over warp w's run of k of x[k] * Ws[j * ld + k]
// for the nrow rows j, x = [x1 (K1 values) | x2], K values in all: each
// warp takes ceil(K / NWARPS) consecutive k in order, its lanes the rows
// lane, lane + 32, lane + 64 and lane + 96 at once (four sums in flight;
// x[k] is one broadcast read for all of them). bf16 rounds the inputs
// (the rows were rounded at load).
__device__ __forceinline__ void gate_partials(const float* Ws, int ld, int nrow, const float* x1, int K1,
                                              const float* x2, int K, bool bf16, float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kc = (K + NWARPS - 1) / NWARPS, k0 = warp * kc, k1 = min(K, k0 + kc);
  for (int j0 = 0; j0 < nrow; j0 += 128) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const float* wr[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) wr[p] = Ws + (size_t)min(j0 + p * 32 + lane, nrow - 1) * ld;
    for (int k = k0; k < k1; ++k) {
      const float xv = k < K1 ? x1[k] : x2[k - K1];
      const float xr = bf16 ? bf16_round(xv) : xv;
#pragma unroll
      for (int p = 0; p < 4; ++p) acc[p] = fmaf(xr, wr[p][k], acc[p]);
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int j = j0 + p * 32 + lane;
      if (j < nrow) part[warp * nrow + j] = acc[p];
    }
  }
}

// T cell steps of batch row blockIdx.x / C by the C CTAs of its cluster.
__global__ void __launch_bounds__(NT, 1) ntm_scan_cluster_kernel(const ClusterArgs a) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Dims dm = a.dm;
  const int IN = dm.IN, N = dm.N, D = dm.D, H = dm.H, Hc = dm.Hc, L = dm.L, O = dm.O;
  const int RD = dm.R * D, ND = N * D, HN = H * N, G4 = 4 * Hc, P = head_width(dm);
  const int T = a.T, B = a.B, C = a.C;
  const int rank = (int)cluster.block_rank(), b = blockIdx.x / C;
  const bool bf = a.fl.bf16 != 0;
  const Slice sl = make_slice(dm, C);
  const AddrLayout& al = sl.al;
  const int Np = al.Np;
  const int U = sl.U, u0 = rank * U, nU = max(0, min(U, Hc - u0));
  const int p0 = rank * sl.Pc, nP = max(0, min(sl.Pc, P - p0));
  const int ldh = sl.ldh;

  // ---- once per launch: this CTA's slices and the row's initial state -------
  for (int l = 0; l < L; ++l) {
    const int K = l == 0 ? RD + Hc : 2 * Hc, ld = sl.kl[l];
    const float* src = a.wt.lstm_w[l] + (l == 0 ? (size_t)IN * G4 : 0);
    float* dst = smem + sl.wl[l];
    // consecutive threads copy runs of U contiguous columns of a kernel row
    for (int e = tid; e < K * 4 * U; e += NT) {
      const int k = e / (4 * U), j = e - k * 4 * U, q = j / U, u = j - q * U;
      if (u < nU)
        cp_async_f32(dst + j * ld + k, src + (size_t)k * G4 + q * Hc + u0 + u);
      else
        dst[j * ld + k] = 0.f;
    }
    for (int j = tid; j < 4 * U; j += NT) {
      const int q = j / U, u = j - q * U;
      smem[sl.bl + l * 4 * U + j] = u < nU ? a.wt.lstm_b[l][q * Hc + u0 + u] : 0.f;
    }
  }
  for (int e = tid; e < Hc * sl.Pc; e += NT) {
    const int k = e / sl.Pc, j = e - k * sl.Pc;
    if (j < nP)
      cp_async_f32(smem + sl.hw + j * ldh + k, a.wt.heads_w + (size_t)k * P + p0 + j);
    else
      smem[sl.hw + j * ldh + k] = 0.f;
  }
  for (int j = tid; j < sl.Pc; j += NT) smem[sl.hb + j] = j < nP ? a.wt.heads_b[p0 + j] : 0.f;
  for (int e = tid; e < Hc * O; e += NT) {
    const int k = e / O, o = e - k * O;
    cp_async_f32(smem + sl.ow + o * ldh + k, a.wt.out_w + e);
  }
  for (int o = tid; o < O; o += NT) smem[sl.ob + o] = a.wt.out_b[o];
  cp_async_commit();
  // M transposed into Mt and w into rows of stride Np (their columns n >= N
  // zero), both updated in place; read and every layer's h in step 0's
  // gather vector
  float* x0 = smem + sl.xs[0];
  for (int i = tid; i < ND; i += NT) {
    const int n = i / D, d = i - n * D;
    smem[al.Mt + d * Np + n] = a.M0[(size_t)b * ND + i];
  }
  for (int i = tid; i < H * Np; i += NT) {
    const int hh = i / Np, n = i - hh * Np;
    smem[al.w + i] = n < N ? a.w0[(size_t)b * HN + hh * N + n] : 0.f;
  }
  for (int i = tid; i < D * (Np - N); i += NT) {
    const int d = i / (Np - N);
    smem[al.Mt + d * Np + N + i - d * (Np - N)] = 0.f;
  }
  for (int i = tid; i < RD; i += NT) x0[i] = a.read0[(size_t)b * RD + i];
  for (int i = tid; i < L * Hc; i += NT) {
    const int l = i / Hc, j = i - l * Hc;
    x0[RD + i] = a.h0[((size_t)l * B + b) * Hc + j];
    smem[sl.c + i] = a.c0[((size_t)l * B + b) * Hc + j];
  }
  // the addressing's outputs: the new read into the next step's gather vector
  AddrOut out;
  out.w_copy = out.M_copy = nullptr;
  cp_async_wait<0>();
  __syncthreads();
  if (bf) {
    // the matmul operands rounded once, at load (one run, from the first
    // layer's rows to the output linear's end; not the biases)
    for (int i = sl.wl[0] + tid; i < sl.bl; i += NT) smem[i] = bf16_round(smem[i]);
  }
  // every CTA of the cluster has started (and holds its slices) before any
  // writes into another's shared memory
  cluster.sync();

  for (int t = 0; t < T; ++t) {
    const float* xin = smem + sl.xs[t & 1];
    float* xout = smem + sl.xs[(t & 1) ^ 1];
    const size_t bt = (size_t)b * T + t;
    // this CTA's units' token part of layer 0, in flight across the product
    float pj[4] = {0.f, 0.f, 0.f, 0.f};
    if (tid < nU)
      for (int q = 0; q < 4; ++q) pj[q] = __ldg(a.proj + bt * G4 + q * Hc + u0 + tid);

    // ---- (1, 2) the stacked LSTM: this CTA's units, their h to every CTA --------
    for (int l = 0; l < L; ++l) {
      // [read | h_0] of step t for layer 0; [h_{l-1} of step t+1 | h_l of step t] above
      const float* x1 = l == 0 ? xin : xout + RD + (l - 1) * Hc;
      const int K1 = l == 0 ? RD : Hc, ld = sl.kl[l];
      const float* Wl = smem + sl.wl[l];
      gate_partials(Wl, ld, 4 * U, x1, K1, xin + RD + l * Hc, K1 + Hc, bf, smem + sl.part);
      __syncthreads();
      if (tid < nU) {
        const float* part = smem + sl.part;
        const float* bias = smem + sl.bl + l * 4 * U;
        float g[4];
        for (int q = 0; q < 4; ++q) {
          float s = 0.f;
          for (int w = 0; w < NWARPS; ++w) s += part[w * 4 * U + q * U + tid];
          if (l > 0)
            g[q] = mm_bias(s, bias[q * U + tid], bf);
          else if (bf)  // proj without b0: the rounded sum, then the bias
            g[q] = mm_bias(s + pj[q], bias[q * U + tid], true);
          else  // proj holds b0
            g[q] = s + pj[q];
        }
        const int unit = u0 + tid;
        float* c = smem + sl.c + l * Hc + unit;
        const float c_new = *c * sigmoid_f(g[2]) + sigmoid_f(g[0]) * tanhf(g[1]);
        const float h_new = tanhf(c_new) * sigmoid_f(g[3]);
        *c = c_new;
        for (int s = 0; s < C; ++s) cluster.map_shared_rank(xout, s)[RD + l * Hc + unit] = h_new;
      }
      cluster.sync();
    }

    // ---- (3) this CTA's head-linear columns to every CTA; rank 0 the logits ------
    const float* ctrl = xout + RD + (L - 1) * Hc;
    for (int j = warp; j < nP; j += NWARPS) {
      const float v = mm_bias(row_dot(smem + sl.hw + j * ldh, ctrl, Hc, nullptr, 0, bf), smem[sl.hb + j], bf);
      if (lane < C) cluster.map_shared_rank(smem + al.ctl, lane)[p0 + j] = v;
    }
    if (rank == 0)
      // from the last warp down: the head columns keep the first ones busy
      for (int o = NWARPS - 1 - warp; o < O; o += NWARPS) {
        const float acc = row_dot(smem + sl.ow + o * ldh, ctrl, Hc, nullptr, 0, bf);
        if (lane == 0) a.logits[bt * O + o] = mm_bias(acc, smem[sl.ob + o], bf);
      }
    cluster.sync();

    // ---- (4) the addressing, read and write on this CTA's own copy -------------
    out.read = xout;
    ntm_addressing<NT>(dm, a.fl, smem, al, out);
  }

  // ---- the final state: rank 0 the shared parts, every CTA its units' c ------
  const float* xf = smem + sl.xs[T & 1];
  const float* Mf = smem + al.Mt;
  if (rank == 0) {
    for (int i = tid; i < ND; i += NT) {
      const int n = i / D, d = i - n * D;
      a.M[(size_t)b * ND + i] = Mf[d * Np + n];
    }
    for (int i = tid; i < HN; i += NT) {
      const int hh = i / N, n = i - hh * N;
      a.w[(size_t)b * HN + i] = smem[al.w + hh * Np + n];
    }
    for (int i = tid; i < RD; i += NT) a.read[(size_t)b * RD + i] = xf[i];
    for (int i = tid; i < L * Hc; i += NT) {
      const int l = i / Hc, j = i - l * Hc;
      a.h[((size_t)l * B + b) * Hc + j] = xf[RD + i];
    }
  }
  if (nU > 0)
    for (int i = tid; i < L * nU; i += NT) {
      const int l = i / nU, u = i - l * nU;
      a.c[((size_t)l * B + b) * Hc + u0 + u] = smem[sl.c + l * Hc + u0 + u];
    }
}

// ---- plain C entry points ---------------------------------------------------

static Dims dims_of(int IN, int N, int D, int H, int R, int W, int S, int Hc, int L, int O) {
  return Dims{IN, N, D, H, R, W, S, Hc, L, O};
}

// Dynamic shared memory per CTA at cluster size C.
extern "C" int ntm_scan_cluster_smem_bytes(int IN, int N, int D, int H, int R, int W, int S, int Hc, int L,
                                           int O, int C) {
  return make_slice(dims_of(IN, N, D, H, R, W, S, Hc, L, O), C).total * (int)sizeof(float);
}

// A launch configuration of `clusters` clusters of C CTAs; attr is the
// caller's storage for its one attribute.
static cudaLaunchConfig_t cluster_config(int clusters, int C, int smem, cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * C, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

static cudaError_t set_cluster_smem(int smem) {
  return cudaFuncSetAttribute(ntm_scan_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// What the card makes of the kernel at cluster size C: out[0] the clusters
// that can be resident at once (cudaOccupancyMaxActiveClusters; 0 = it
// cannot run), out[1] registers per thread, out[2] local (spill) bytes
// per thread, out[3] dynamic shared memory per CTA. Returns the CUDA error.
extern "C" int ntm_scan_cluster_occupancy(int IN, int N, int D, int H, int R, int W, int S, int Hc, int L,
                                          int O, int C, int device, int* out) {
  if (C < 1 || C > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int smem = ntm_scan_cluster_smem_bytes(IN, N, D, H, R, W, S, Hc, L, O, C);
  if ((err = set_cluster_smem(smem)) != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  if ((err = cudaFuncGetAttributes(&fa, ntm_scan_cluster_kernel)) != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(1, C, smem, 0, &attr);
  int clusters = 0;
  if ((err = cudaOccupancyMaxActiveClusters(&clusters, ntm_scan_cluster_kernel, &cfg)) != cudaSuccess)
    return (int)err;
  out[0] = clusters;
  out[1] = fa.numRegs;
  out[2] = (int)fa.localSizeBytes;
  out[3] = smem;
  return 0;
}

// One cluster of C CTAs per batch row on `stream`. proj holds layer 0's
// token part per step [B*T, 4*Hc] (scan_bptt.cu's ntm_token_proj_launch:
// X W0[:IN] + b0, or at bf16 the rounded operands' X W0[:IN] without b0);
// c0, h0, c and h are stacked [L, B, Hc]; lstm_w and lstm_b are host arrays
// of L device pointers. Returns the CUDA error of the launch (0 =
// launched; a cluster the card refuses returns its error).
extern "C" int ntm_scan_cluster_launch(
    const void* proj, const void* const* lstm_w, const void* const* lstm_b, const void* heads_w,
    const void* heads_b, const void* out_w, const void* out_b, const void* M0, const void* w0,
    const void* read0, const void* c0, const void* h0, void* logits, void* M, void* w, void* read,
    void* c, void* h, int B, int T, int IN, int N, int D, int H, int R, int W, int S, int Hc, int L,
    int O, int write_first, int slotwise, int bf16, int C, int device, void* stream) {
  // a CTA's units are finished by one thread each
  // (and the addressing's limits: a warp holds at most ADDR_MAX_SLOTS
  // slots, the shift wraps at most once)
  if (L < 1 || L > MAX_LAYERS || B < 1 || T < 1 || C < 1 || C > MAX_CLUSTER || (Hc + C - 1) / C > NT ||
      proj == nullptr || N < 1 || N > ADDR_MAX_SLOTS || S < 1 || S > N)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  ClusterArgs a;
  a.proj = (const float*)proj;
  for (int l = 0; l < MAX_LAYERS; ++l) {
    a.wt.lstm_w[l] = l < L ? (const float*)lstm_w[l] : nullptr;
    a.wt.lstm_b[l] = l < L ? (const float*)lstm_b[l] : nullptr;
  }
  a.wt.heads_w = (const float*)heads_w;
  a.wt.heads_b = (const float*)heads_b;
  a.wt.out_w = (const float*)out_w;
  a.wt.out_b = (const float*)out_b;
  a.M0 = (const float*)M0;
  a.w0 = (const float*)w0;
  a.read0 = (const float*)read0;
  a.c0 = (const float*)c0;
  a.h0 = (const float*)h0;
  a.logits = (float*)logits;
  a.M = (float*)M;
  a.w = (float*)w;
  a.read = (float*)read;
  a.c = (float*)c;
  a.h = (float*)h;
  a.dm = dims_of(IN, N, D, H, R, W, S, Hc, L, O);
  a.fl = Flags{write_first, slotwise, bf16};
  a.B = B;
  a.T = T;
  a.C = C;
  const int smem = make_slice(a.dm, C).total * (int)sizeof(float);
  if ((err = set_cluster_smem(smem)) != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(B, C, smem, (cudaStream_t)stream, &attr);
  if ((err = cudaLaunchKernelEx(&cfg, ntm_scan_cluster_kernel, a)) != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
