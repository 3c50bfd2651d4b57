// Lane-packed whole-sequence NTM kernels over a tile of batch rows: the
// cell loop, the same loop with residual streams, and its reverse-time
// backward.
//
// Replaces ntm_tracker_tpu/ops/pallas/scan_packed.py: _packed_fwd_kernel
// (:225, ntm_scan_packed), _packed_fwd_res_kernel (:290) and
// _packed_bwd_kernel (:336, ntm_scan_packed_bptt). The weight-gradient
// accumulation that _packed_bwd_kernel does in place is left to the
// deterministic reduction of scan_bptt.cu (ntm_grad_reduce_launch): this
// kernel writes the same per-(row, step) operands as ntm_bptt_bwd_kernel.
//
//   forward   packed_fwd_kernel<RT, kResiduals>: one block of NT threads
//             owns RT batch rows and runs their T steps with the state in
//             shared memory; kResiduals also writes each step's INPUT
//             state (memory packed) to [B, T, ...] residual streams.
//   backward  packed_bwd_kernel<RT>: one block per RT rows walks
//             t = T-1 .. 0, reloads each step's input state from the
//             residuals, recomputes the step (packed_step<RT, true>, the
//             forward's own step code) and applies the VJPs of the chain,
//             carrying dM, dw, dread, dc and dh in shared memory.
//
// The layout is the TPU kernel's: each row's memory is packed d-major,
// Mt[d][n], here with a row stride of Np = addr_stride(N) floats (N rounded
// up to 4, the columns past N zero), and the residual stream res_M is
// [B, T, D*N], lane d*N + n. No 0/1 selector matrices: on the TPU they
// turned a sum into an MXU product; here a sum is a sum.
//
// What bounds it on an H100, and what the design does about it:
// - Every step re-reads the LSTM kernel and the head linear from L2, once
//   per tile of RT rows (one weight load serves the tile's rows), and the
//   products are latency-bound on those loads: the forward's products give
//   each lane pair four columns (16-byte loads) and one half of K each, the
//   backward's transposed products a warp kRows weight rows with every
//   load of a row issued before any is used. Layer 0's token rows W0[:IN]
//   (1.6 MB of the 2.5 MB at the flagship config) leave the recurrence:
//   both kernels take layer 0's token part from scan_bptt.cu's token
//   projection (proj = X W0[:IN] + b0 over all steps, launched by the
//   caller), so the recurrent product runs over [read | h] (K = R*D + Hc =
//   280 rows), and the forward reads no token. The backward's transposed
//   product skips W0[:IN] too unless the caller asks for dtokens, and the
//   next step's residuals arrive by cp.async while it runs.
// - The rest of a step is a chain of barrier-separated phases over the
//   tile's rows. The addressing is B3's design (ntm_step.cuh
//   ntm_addressing()) spread over the tile, in B4's own d-major layout:
//   (a) a warp per job over all the tile's rows (a head's tanh(k), |k|^-1,
//   scalar controls and shift softmax; a pair of memory rows' across-slot
//   normalizer; erase and add), (b) a warp per (row, head) chain, each lane
//   a run of addr_run(N) consecutive slots (the similarity from float4 loads
//   of Mt[d][n..n+3], the softmax, the gate, the shift by warp shuffles on
//   the plan of addressing.py's shift_sources, the sharpen in powf, as
//   scan_bptt.cu has it, and its VJP's recompute of p too: B3's
//   exp2f(gamma * log2f(x)) put B4's initial-state gradients 5e-4 from
//   float64 at the training shape, powf 3e-5 to 7e-5; the VJP's derivative
//   factor w_conv^(gamma - 1), which the recurrence does not carry, keeps
//   exp2f(log2f)), (c) the erase/add write and the read, a warp
//   per (row, memory row d) with lanes over slots (the read, from the old
//   or the new memory, is then a warp sum per read head, and the
//   write-first order costs no extra phase). The read writes the next
//   step's layer-0 input directly; phase (a) copies h_0 there.
// - The backward's addressing VJPs run the same way: a warp per (row, d)
//   for the read source, the erase/add and the normalizer (sums over n,
//   contiguous), a warp per (row, head) chain in registers for the sharpen,
//   the shift (the same shuffle plan, offsets negated for the transposed
//   shift), the gate and the softmax; the carries are written where they
//   are computed (the transposed products write dh, dread and dctrl
//   directly), and the next step's residuals load in the last phase.
// - Barriers per step (one LSTM layer, the read first): the forward 11 ->
//   6 (gates, LSTM, head linear, (a), (b), (c)); the backward 18 -> 11
//   (the recompute's gates, LSTM, head linear, (a), (b); the read/write
//   VJP, the head chains, the keys and normalizer, the head linears, the
//   gate cotangents, the transposed product with the next load). A further
//   LSTM layer adds 2 to the forward and 4 to the backward; write-first
//   adds none. The probe variants (kProbe, at kProbeRows rows, in a library
//   of their own: -DNTM_PACKED_PROBE) clock each phase (chip_smoke.py's
//   [probe] lines).
// - Shared memory bounds the tile: at the flagship config a row of the
//   forward keeps ~20 KB and a row of the backward ~60 KB (the memory, its
//   two cotangents and the intermediates of the chains), so the forward is
//   instantiated at 1, 2, 3 and 4 rows per block, the backward at 1, 2
//   and 3; the wrapper picks the tile from B and the SM count.
//
// Each product sums its K terms in one order whatever RT is, and every
// reduction has one fixed order (butterfly warp sums), so a row's numbers
// do not depend on the tile. d/dgamma of w_conv^gamma is taken as 0 where
// w_conv == 0, as scan_bptt.cu does. Past ADDR_MAX_SLOTS slots the runs
// do not fit a lane's registers: the same phases then run with a lane per
// slot and the chains' intermediates in shared memory (the *_wide
// functions; the forward adds a scratch row per head). A shift wider than
// memory wraps its offsets mod N. f32 only. Plain C
// interface (no PyTorch headers): built by nvcc into a shared library and
// called through ctypes (ntm_tracker_tpu_torch/_build.py).

#include "ntm_step.cuh"

// weight loads in flight per thread in the tile products: the forward
// products' k loop (pair_dot) and the transposed products' rows (rows_dot)
constexpr int kPairUnroll = 8;
constexpr int kRows = 4;

__host__ __device__ inline int take4(int& o, int n) {
  o = (o + 3) & ~3;
  const int at = o;
  o += n;
  return at;
}

// Offsets (in floats) of one row's shared arrays (row r starts at r * row),
// each 16-byte aligned; the tile-shared layer input, transposed [K][RT],
// follows the RT rows.
struct PackedLayout {
  int Np, Dp;                                       // slot stride, D rounded up to 4
  int Mt, w, read, c, h, gates, ctl;                // the state ([D][Np], [H][Np]) and the step's products
  int kt, minv, mss, kss, hs, den, swv, er, ad;     // phase (a)'s outputs, den from (b)
  // backward only: the chains' intermediates, the carries and the cotangents
  int wn, wc, wconv, u, nmi, nss, cn, dw, dM, dMp, dctl, dread, dc, dh, dctrl, dlogit, dkss, tok;
  int scr;                                          // the forward past ADDR_MAX_SLOTS: the chains' scratch
  int row, xT, total;
};

__host__ __device__ inline PackedLayout make_packed_layout(const Dims& d, bool bwd, int RT) {
  const int HN_ = d.H * addr_stride(d.N), RD = d.R * d.D, LH = d.L * d.Hc;
  PackedLayout s;
  s.Np = addr_stride(d.N);
  s.Dp = (d.D + 3) & ~3;
  int o = 0;
  s.Mt = take4(o, d.D * s.Np);
  s.w = take4(o, HN_);
  s.read = take4(o, RD);
  s.c = take4(o, LH);
  s.h = take4(o, LH);
  s.gates = take4(o, (bwd ? d.L : 1) * 4 * d.Hc);
  s.ctl = take4(o, head_width(d));
  s.kt = take4(o, d.H * s.Dp);
  s.minv = take4(o, s.Dp);
  s.mss = take4(o, s.Dp);
  s.kss = take4(o, d.H);
  s.hs = take4(o, 4 * d.H);
  s.den = take4(o, d.H);
  s.swv = take4(o, d.H * d.S);
  s.er = take4(o, d.W * d.D);
  s.ad = take4(o, d.W * d.D);
  if (bwd) {
    s.wn = take4(o, HN_);
    s.wc = take4(o, HN_);
    s.wconv = take4(o, HN_);
    s.u = take4(o, HN_);
    s.nmi = take4(o, s.Np);
    s.nss = take4(o, s.Np);
    s.cn = take4(o, LH);
    s.dw = take4(o, HN_);
    s.dM = take4(o, d.D * s.Np);
    s.dMp = take4(o, d.D * s.Np);
    s.dctl = take4(o, head_width(d));
    s.dread = take4(o, RD);
    s.dc = take4(o, LH);
    s.dh = take4(o, LH);
    s.dctrl = take4(o, d.Hc);
    s.dlogit = take4(o, d.O);
    s.dkss = take4(o, d.H);
    s.tok = take4(o, d.IN);
    s.scr = -1;
  } else {
    s.wn = s.wc = s.wconv = s.u = s.nmi = s.nss = s.cn = s.dw = s.dM = s.dMp = -1;
    s.dctl = s.dread = s.dc = s.dh = s.dctrl = s.dlogit = s.dkss = s.tok = -1;
    s.scr = d.N > ADDR_MAX_SLOTS ? take4(o, HN_) : -1;
  }
  s.row = (o + 3) & ~3;
  s.xT = RT * s.row;
  s.total = s.xT + imax(RD + d.Hc, 2 * d.Hc) * RT;
  return s;
}

// li's row stride: the widest layer input rounded up to 4 floats (16-byte
// rows for the reduction's loads, as scan_bptt.cu's)
__host__ __device__ inline int li_stride(const Dims& d) { return (kin_max(d) + 3) & ~3; }

// The probe variant's per-phase clock: thread 0 of block 0 reads clock64()
// after each barrier and adds the cycles since the last read to the
// phase's slot, over all the steps; flush writes the slots. The kernels'
// default instances carry the empty Probe<false>.
constexpr int kProbeSlots = 11;
constexpr int kProbeRows = 2;
template <bool kOn>
struct Probe {
  __device__ void mark(int) {}
  __device__ void flush(long long*) {}
};
template <>
struct Probe<true> {
  long long last = 0, acc[kProbeSlots] = {};
  __device__ Probe() {
    if (threadIdx.x == 0) last = clock64();
  }
  __device__ void mark(int i) {
    if (threadIdx.x != 0) return;
    const long long now = clock64();
    acc[i] += now - last;
    last = now;
  }
  __device__ void flush(long long* out) {
    if (threadIdx.x == 0 && blockIdx.x == 0)
      for (int i = 0; i < kProbeSlots; ++i) out[i] = acc[i];
  }
};

struct PackedArgs {
  const float* proj;            // [B*T, 4*Hc] X W0[:IN] + b0
  const float* tokens;          // [B, T, IN]; the backward's li only
  Weights wt;
  const float* M0;              // [B, N, D]
  const float* w0;              // [B, H, N]
  const float* read0;           // [B, R, D]
  const float* c0[MAX_LAYERS];  // [B, Hc]
  const float* h0[MAX_LAYERS];  // [B, Hc]
  float* logits;                // [B, T, O]
  float* M;                     // [B, N, D]
  float* w;                     // [B, H, N]
  float* read;                  // [B, R, D]
  float* c;                     // [L, B, Hc]
  float* h;                     // [L, B, Hc]
  // residual streams of each step's INPUT state (written by the forward
  // with residuals, read by the backward)
  float* res_M;                 // [B, T, D*N] packed
  float* res_w;                 // [B, T, H, N]
  float* res_read;              // [B, T, R*D]
  float* res_c;                 // [B, T, L, Hc]
  float* res_h;                 // [B, T, L, Hc]
  // backward only
  const float* dlogits;         // [B, T, O]
  const float* dM_T;            // [B, N, D] cotangents of the final state
  const float* dw_T;            // [B, H, N]
  const float* dread_T;         // [B, R*D]
  const float* dc_T;            // [L, B, Hc]
  const float* dh_T;            // [L, B, Hc]
  float* dM0;                   // [B, N, D] cotangents of the initial state
  float* dw0;                   // [B, H, N]
  float* dread0;                // [B, R*D]
  float* dc0;                   // [L, B, Hc]
  float* dh0;                   // [L, B, Hc]
  float* dtokens;               // [B, T, IN], written only when need_dtokens
  float* li;                    // [L, B*T, li_stride] each layer's input
  float* dgates;                // [L, B*T, 4*Hc] each layer's gate cotangents
  float* ctrl;                  // [B*T, Hc] the controller output
  float* dctl;                  // [B*T, P+O] the head-control cotangents, then the logits'
  long long* probe;             // [kProbeSlots] the probe variant's cycles per phase
  Dims dm;
  Flags fl;
  int B, T, need_dtokens;
};

#define ROWP(r, f) (smem + (r) * lay.row + lay.f)

__device__ __forceinline__ float dot4(float4 a, float4 b, float p) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, p))));
}
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

// The step's products over the tile's rows, latency-bound on L2 (each
// weight is read once per step for the tile): they keep many loads in
// flight per thread, in 16-byte loads where the layout allows.

// out[r][j] = sum_k xT[k*RT + r] W[k*ld + j] for the tile's RT rows and
// the columns j < ncol, written through put(j, r, sum) for r < nr: a lane
// pair per V consecutive columns (V = 4 where ld, ncol and W allow 16-byte
// loads, else 1), lane 2i + h summing k over one half of K, the halves
// added by a shuffle (the first half's sum, then the second's). Each sum's
// order does not depend on RT.
template <int RT, int V, class Put>
__device__ __forceinline__ void pair_dot(const float* __restrict__ W, int ld, int ncol, const float* xT, int K, int nr,
                                         const Put& put) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, half = lane & 1;
  const int ng = (ncol + V - 1) / V, kh = (K + 1) / 2;
  const int k0 = half ? kh : 0, k1 = half ? K : kh;
  for (int gb = warp * 16; gb < ng; gb += NT / 2) {
    const int g = gb + (lane >> 1), gc = min(g, ng - 1);
    const float* wp = W + (size_t)gc * V;
    float acc[RT][V];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < V; ++c) acc[r][c] = 0.f;
#pragma unroll kPairUnroll
    for (int k = k0; k < k1; ++k) {
      float w[V];
      if constexpr (V == 4) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(wp + (size_t)k * ld));
        w[0] = t.x, w[1] = t.y, w[2] = t.z, w[3] = t.w;
      } else {
        w[0] = __ldg(wp + (size_t)k * ld);
      }
      const float* xk = xT + k * RT;
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float x = xk[r];
#pragma unroll
        for (int c = 0; c < V; ++c) acc[r][c] = fmaf(x, w[c], acc[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < V; ++c) {
        const float other = __shfl_xor_sync(0xffffffffu, acc[r][c], 1);
        acc[r][c] = half ? other + acc[r][c] : acc[r][c] + other;
      }
    if (half == 0 && g < ng)
      for (int r = 0; r < nr; ++r)
#pragma unroll
        for (int c = 0; c < V; ++c)
          if (g * V + c < ncol) put(g * V + c, r, acc[r][c]);
  }
}

template <int RT, class Put>
__device__ __forceinline__ void tile_product(const float* __restrict__ W, int ld, int ncol, const float* xT, int K,
                                             int nr, const Put& put) {
  if ((ld % 4 == 0) && (ncol % 4 == 0) && ((size_t)W % 16 == 0))
    pair_dot<RT, 4>(W, ld, ncol, xT, K, nr, put);
  else
    pair_dot<RT, 1>(W, ld, ncol, xT, K, nr, put);
}

// acc[i][r] += g_r[j] * W[k_i * ld + j] summed over this lane's columns j <
// ncol (V consecutive columns at a time: lane, lane + 32, ... in groups of
// V), for the kRows weight rows k_i = k0 + i * NWARPS (rows at or past kend
// repeat row kend - 1; the caller drops them) and the tile's RT rows, g_r
// at g + r * row (16-byte aligned). The caller sums acc across the warp.
// The loads of U column groups of every row are issued before any is used
// (a row is short: a loop over it would wait at each group).
template <int RT, int V>
__device__ __forceinline__ void rows_dot_v(const float* __restrict__ W, int ld, int k0, int kend, int ncol,
                                           const float* g, int row, float (&acc)[kRows][RT]) {
  static_assert(V == 4 || V == 1, "16-byte or 4-byte loads");
  constexpr int U = V == 4 ? 4 : 8;
  const int lane = threadIdx.x & 31;
  const float* wr[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) wr[i] = W + (size_t)min(k0 + i * NWARPS, kend - 1) * ld;
  for (int jb = lane * V; jb < ncol; jb += 32 * V * U) {
    float wv[U][kRows][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = min(jb + u * 32 * V, ncol - V);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if constexpr (V == 4) {
          const float4 t = __ldg(reinterpret_cast<const float4*>(wr[i] + j));
          wv[u][i][0] = t.x, wv[u][i][1] = t.y, wv[u][i][2] = t.z, wv[u][i][3] = t.w;
        } else {
          wv[u][i][0] = __ldg(wr[i] + j);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = jb + u * 32 * V;
      if (j >= ncol) break;
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        float gv[V];
        if constexpr (V == 4) {
          const float4 t = *reinterpret_cast<const float4*>(g + r * row + j);
          gv[0] = t.x, gv[1] = t.y, gv[2] = t.z, gv[3] = t.w;
        } else {
          gv[0] = g[r * row + j];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int c = 0; c < V; ++c) acc[i][r] = fmaf(gv[c], wv[u][i][c], acc[i][r]);
      }
    }
  }
}

// rows_dot_v in 16-byte loads where ld, ncol and W allow them
template <int RT>
__device__ __forceinline__ void rows_dot(const float* __restrict__ W, int ld, int k0, int kend, int ncol,
                                         const float* g, int row, float (&acc)[kRows][RT]) {
  if ((ld % 4 == 0) && (ncol % 4 == 0) && ((size_t)W % 16 == 0))
    rows_dot_v<RT, 4>(W, ld, k0, kend, ncol, g, row, acc);
  else
    rows_dot_v<RT, 1>(W, ld, k0, kend, ncol, g, row, acc);
}

// The head and output linears' transposed product in one pass: acc[i][r] +=
// sum_j [dctl_r | dlogit_r][j] [heads_w[k_i] | out_w[k_i]][j] over this
// lane's j < P + O (j = lane, lane + 32, ...), rows as rows_dot_v's.
template <int RT>
__device__ __forceinline__ void heads_dot(const Weights& wt, int P, int O, int k0, int kend, const float* dctl,
                                          const float* dlogit, int row, float (&acc)[kRows][RT]) {
  constexpr int U = 8;
  const int lane = threadIdx.x & 31, ncol = P + O;
  int kr[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) kr[i] = min(k0 + i * NWARPS, kend - 1);
  for (int jb = lane; jb < ncol; jb += 32 * U) {
    float wv[U][kRows];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = min(jb + u * 32, ncol - 1);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        wv[u][i] = j < P ? __ldg(wt.heads_w + (size_t)kr[i] * P + j) : __ldg(wt.out_w + (size_t)kr[i] * O + j - P);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = jb + u * 32;
      if (j >= ncol) break;
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float gv = j < P ? dctl[r * row + j] : dlogit[r * row + j - P];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][r] = fmaf(gv, wv[u][i], acc[i][r]);
      }
    }
  }
}

// ---- the addressing over a tile of rows ------------------------------------------

// Phase (a), job j of one row (row: its arrays' base): j < H the head j's
// tanh(k), |k|^2 and its inverse root, softplus beta, sigmoid g, softplus
// gamma + 1 and the shift weights' softmax; then the pairs of memory rows'
// across-slot normalizer and sums; last erase and add squashed and the
// normalizer's padding (its ones, slotwise). ntm_step.cuh addr_prep's
// arithmetic, keeping |k|^2 and |M[d]|^2 for the backward.
__device__ __forceinline__ void packed_prep(const Dims& dm, const Flags& fl, float* row, const PackedLayout& lay,
                                            int j) {
  const int lane = threadIdx.x & 31;
  const int N = dm.N, D = dm.D, H = dm.H, S = dm.S, W = dm.W, Np = lay.Np, Dp = lay.Dp;
  const float* ctl = row + lay.ctl;
  const float* Mt = row + lay.Mt;
  const int pairs = fl.slotwise ? 0 : (D + 1) / 2;
  if (j < H) {
    const int h = j;
    const int oBeta = H * D, oGamma = H * D + 2 * H + S * H;
    const float* swr = ctl + H * D + 2 * H + h * S;
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
      row[lay.kt + h * Dp + d] = t;
      kss = fmaf(t, t, kss);
    }
    const float sinv = 1.f / warp_sum(se);
    kss = warp_sum(kss);
    if (lane < Dp) row[lay.kt + h * Dp + lane] = kt;
    if (lane < 3) row[lay.hs + 4 * h + lane] = lane == 0 ? sp : lane == 1 ? sg : sp + 1.f;
    if (lane == 3) row[lay.hs + 4 * h + 3] = rsqrtf(fmaxf(kss, 1e-12f));
    if (lane == 4) row[lay.kss + h] = kss;
    if (lane < S) row[lay.swv + h * S + lane] = e0 * sinv;
    for (int k = lane + 32; k < S; k += 32) row[lay.swv + h * S + k] = expf(swr[k] - smx) * sinv;
  } else if (j < H + pairs) {
    // rows d0 and d0 + 1: a lane per four slots, then warp sums
    const int d0 = 2 * (j - H), d1 = min(d0 + 1, D - 1);
    float s0 = 0.f, s1 = 0.f;
    for (int n = lane * 4; n < N; n += 128) {
      const float4 a = ld4(Mt + d0 * Np + n);
      const float4 b = ld4(Mt + d1 * Np + n);
      s0 += fmaf(a.x, a.x, fmaf(a.y, a.y, fmaf(a.z, a.z, a.w * a.w)));
      s1 += fmaf(b.x, b.x, fmaf(b.y, b.y, fmaf(b.z, b.z, b.w * b.w)));
    }
    s0 = warp_sum(s0);
    s1 = warp_sum(s1);
    if (lane == 0) {
      row[lay.minv + d0] = rsqrtf(fmaxf(s0, 1e-12f));
      row[lay.minv + d1] = rsqrtf(fmaxf(s1, 1e-12f));
      row[lay.mss + d0] = s0;
      row[lay.mss + d1] = s1;
    }
  } else if (j == H + pairs) {
    const float* raw = ctl + head_width(dm) - 2 * W * D;
    for (int i = lane; i < W * D; i += 32) {
      const float e = raw[i], a = raw[W * D + i];
      row[lay.er + i] = sigmoid_f(e);
      row[lay.ad + i] = tanhf(a);
    }
    for (int d = fl.slotwise ? lane : D + lane; d < Dp; d += 32) row[lay.minv + d] = d < D ? 1.f : 0.f;
  }
}

// out[i] = v at slot (n0 + i + o) mod N (|o| <= N), v held as each lane's
// run of RL slots: slot m is element m % RL of lane m / RL, and the element
// index is the same on every lane within a wrap class (none, +N, -N): one
// shuffle where RL divides N (the classes agree), else three. Lanes whose
// slots are past N get values they mask.
template <int RL>
__device__ __forceinline__ void shifted_run(const float (&v)[RL], int o, int N, float (&out)[RL]) {
  const int n0 = (threadIdx.x & 31) * RL;
#pragma unroll
  for (int i = 0; i < RL; ++i) {
    const int raw = n0 + i + o;
    if (N % RL == 0) {
      const unsigned m = raw < 0 ? raw + N : (raw >= N ? raw - N : raw);
      out[i] = __shfl_sync(0xffffffffu, pick<RL>(v, (i + o) & (RL - 1)), (m / RL) & 31);
    } else {
      const int cls = raw < 0 ? 1 : (raw >= N ? -1 : 0);
      const int src = ((raw + cls * N) / RL) & 31;
      const float v0 = __shfl_sync(0xffffffffu, pick<RL>(v, (i + o) & (RL - 1)), src);
      const float vp = __shfl_sync(0xffffffffu, pick<RL>(v, (i + o + N) & (RL - 1)), src);
      const float vm = __shfl_sync(0xffffffffu, pick<RL>(v, (i + o - N) & (RL - 1)), src);
      out[i] = cls > 0 ? vp : (cls < 0 ? vm : v0);
    }
  }
}

// Phase (b): head h's chain of one row by one warp, each lane a run of RL
// slots: the similarity u[n] = sum_d tanh(k)[d] minv[d] M[d][n] (slotwise:
// minv = 1, then u scaled by |M[:, n]|^-1), sim = u |k|^-1, the softplus-
// beta softmax, the gate, the shift, the gamma-sharpen with its +1e-3. The
// forward leaves the new weights in place of w's row h; the backward's
// recompute (kBwd) leaves w (the step's input) and keeps the new weights
// (wn), the content weights (wc), the shifted weights (wconv), u, the
// sharpen's denominator and, slotwise, each slot's |M[:, n]|^2 and its
// inverse root.
template <int RL, bool kBwd>
__device__ __forceinline__ void packed_chain(const Dims& dm, const Flags& fl, float* row, const PackedLayout& lay,
                                             int h) {
  const int lane = threadIdx.x & 31;
  const int N = dm.N, D = dm.D, S = dm.S, Np = lay.Np;
  const float* kt = row + lay.kt + h * lay.Dp;
  const float* minv = row + lay.minv;
  const int n0 = lane * RL;
  const bool live = n0 < N, second = n0 + 4 < Np;
  const int at = live ? n0 : 0;
  const float* run = row + lay.Mt + at;
  float* wrow = row + lay.w + h * Np;
  const float bt = row[lay.hs + 4 * h], gt = row[lay.hs + 4 * h + 1];
  const float gm = row[lay.hs + 4 * h + 2], kinv = row[lay.hs + 4 * h + 3];
  float wp[RL];
  load_run<RL>(wrow + at, wp, second);

  float sim[RL], nrm[RL];
#pragma unroll
  for (int i = 0; i < RL; ++i) sim[i] = nrm[i] = 0.f;
  for (int d0 = 0; d0 < D; d0 += 4) {
    float m[4][RL];
    load_rows4<RL>(run, Np, d0, D, m, second);
    const float4 k4 = ld4(kt + d0);
    const float4 v4 = ld4(minv + d0);
    const float kd[4] = {k4.x * v4.x, k4.y * v4.y, k4.z * v4.z, k4.w * v4.w};
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int i = 0; i < RL; ++i) {
        sim[i] = fmaf(kd[c], m[c][i], sim[i]);
        if (d0 + c < D) nrm[i] = fmaf(m[c][i], m[c][i], nrm[i]);
      }
  }

  // the softplus-beta softmax over slots and the interpolation gate
  const float ninf = __int_as_float(0xff800000);
  float u[RL], mx = ninf;
#pragma unroll
  for (int i = 0; i < RL; ++i) {
    u[i] = fl.slotwise ? sim[i] * rsqrtf(fmaxf(nrm[i], 1e-12f)) : sim[i];
    sim[i] = u[i] * kinv;
    if (n0 + i < N) mx = fmaxf(mx, sim[i] * bt);
  }
  mx = warp_max(mx);
  float wc[RL], tot = 0.f;
#pragma unroll
  for (int i = 0; i < RL; ++i) {
    const float e = expf(sim[i] * bt - mx);
    wc[i] = n0 + i < N ? e : 0.f;
    tot += wc[i];
  }
  const float tinv = 1.f / warp_sum(tot);
  float wg[RL];
#pragma unroll
  for (int i = 0; i < RL; ++i) {
    wc[i] *= tinv;
    wg[i] = n0 + i < N ? wc[i] * gt + wp[i] * (1.f - gt) : 0.f;
  }

  // the circular shift: conv[n] = sum_j sw[j] wg[(n + shift0 + j) mod N]
  const int shift0 = -((S + 1) / 2);
  const float* swv = row + lay.swv + h * S;
  float conv[RL];
#pragma unroll
  for (int i = 0; i < RL; ++i) conv[i] = 0.f;
  for (int j = 0; j < S; ++j) {
    const float swj = swv[j];
    float v[RL];
    shifted_run<RL>(wg, (shift0 + j) % N, N, v);
#pragma unroll
    for (int i = 0; i < RL; ++i) conv[i] = fmaf(swj, v[i], conv[i]);
  }

  // the gamma-sharpen, +1e-3 in the denominator; powf, not exp2f(gamma *
  // log2f(x)): the product's rounding, |gamma log2 x| 2^-24 relative, put
  // the initial-state gradients 5e-4 from float64 (chip_smoke.py's referee)
  float wn[RL], ptot = 0.f;
#pragma unroll
  for (int i = 0; i < RL; ++i) {
    const float p = powf(conv[i], gm);
    wn[i] = n0 + i < N ? p : 0.f;
    ptot += wn[i];
  }
  const float den = warp_sum(ptot) + 1e-3f;
  const float pinv = 1.f / den;
#pragma unroll
  for (int i = 0; i < RL; ++i) wn[i] *= pinv;
  if (!live) return;
  if constexpr (kBwd) {
    float cv[RL], uv[RL];
#pragma unroll
    for (int i = 0; i < RL; ++i) {
      cv[i] = n0 + i < N ? conv[i] : 0.f;
      uv[i] = n0 + i < N ? u[i] : 0.f;
    }
    store_run<RL>(row + lay.wn + h * Np + n0, wn, second);
    store_run<RL>(row + lay.wc + h * Np + n0, wc, second);
    store_run<RL>(row + lay.wconv + h * Np + n0, cv, second);
    store_run<RL>(row + lay.u + h * Np + n0, uv, second);
    if (lane == 0) row[lay.den + h] = den;
    if (fl.slotwise && h == 0) {
      float mi[RL], ss[RL];
#pragma unroll
      for (int i = 0; i < RL; ++i) {
        ss[i] = n0 + i < N ? nrm[i] : 0.f;
        mi[i] = n0 + i < N ? rsqrtf(fmaxf(nrm[i], 1e-12f)) : 0.f;
      }
      store_run<RL>(row + lay.nmi + n0, mi, second);
      store_run<RL>(row + lay.nss + n0, ss, second);
    }
  } else {
    store_run<RL>(wrow + n0, wn, second);
  }
}

// slot (m) mod N for any m
__device__ __forceinline__ int wrap_slot(int m, int N) {
  m %= N;
  return m < 0 ? m + N : m;
}

// packed_chain past ADDR_MAX_SLOTS slots: its formulas with a lane per slot
// (n = lane, lane + 32, ...) and the intermediates in shared memory. The
// forward keeps u, then exp, then the shifted weights in its scratch row
// and the gated weights in w's row h, which then takes the new weights;
// the backward's recompute keeps u, the content weights and the shifted
// weights in the rows its VJPs read, and the gated weights in wn's row h
// until the new weights replace them.
template <bool kBwd>
__device__ __forceinline__ void packed_chain_wide(const Dims& dm, const Flags& fl, float* row,
                                                  const PackedLayout& lay, int h) {
  const int lane = threadIdx.x & 31;
  const int N = dm.N, D = dm.D, S = dm.S, Np = lay.Np;
  const float* kt = row + lay.kt + h * lay.Dp;
  const float* minv = row + lay.minv;
  const float* Mt = row + lay.Mt;
  float* wrow = row + lay.w + h * Np;
  float* u = row + (kBwd ? lay.u : lay.scr) + h * Np;
  float* ex = kBwd ? row + lay.wc + h * Np : u;
  float* conv = kBwd ? row + lay.wconv + h * Np : u;
  float* gated = kBwd ? row + lay.wn + h * Np : wrow;
  const float bt = row[lay.hs + 4 * h], gt = row[lay.hs + 4 * h + 1];
  const float gm = row[lay.hs + 4 * h + 2], kinv = row[lay.hs + 4 * h + 3];
  float mx = __int_as_float(0xff800000);
  for (int n = lane; n < N; n += 32) {
    float sim = 0.f, nrm = 0.f;
    for (int d = 0; d < D; ++d) {
      const float m = Mt[d * Np + n];
      sim = fmaf(kt[d] * minv[d], m, sim);
      nrm = fmaf(m, m, nrm);
    }
    const float un = fl.slotwise ? sim * rsqrtf(fmaxf(nrm, 1e-12f)) : sim;
    u[n] = un;
    if (kBwd && fl.slotwise && h == 0) {
      row[lay.nmi + n] = rsqrtf(fmaxf(nrm, 1e-12f));
      row[lay.nss + n] = nrm;
    }
    mx = fmaxf(mx, un * kinv * bt);
  }
  mx = warp_max(mx);
  float tot = 0.f;
  for (int n = lane; n < N; n += 32) {
    const float e = expf(u[n] * kinv * bt - mx);
    ex[n] = e;
    tot += e;
  }
  const float tinv = 1.f / warp_sum(tot);
  for (int n = lane; n < N; n += 32) {
    const float wc = ex[n] * tinv;
    if (kBwd) ex[n] = wc;
    gated[n] = wc * gt + wrow[n] * (1.f - gt);
  }
  __syncwarp();
  const int shift0 = -((S + 1) / 2);
  const float* swv = row + lay.swv + h * S;
  float ptot = 0.f;
  for (int n = lane; n < N; n += 32) {
    float c = 0.f;
    for (int j = 0; j < S; ++j) c = fmaf(swv[j], gated[wrap_slot(n + shift0 + j, N)], c);
    conv[n] = c;
    ptot += powf(c, gm);
  }
  const float den = warp_sum(ptot) + 1e-3f;
  const float pinv = 1.f / den;
  __syncwarp();  // every lane has read the gated weights
  for (int n = lane; n < N; n += 32) gated[n] = powf(conv[n], gm) * pinv;
  if (kBwd && lane == 0) row[lay.den + h] = den;
}

// Phase (c) of the forward, memory row d of one row by one warp, a lane per
// four slots: the erase/add write M = M * prod_wh (1 - w_wh e_wh[d]) +
// sum_wh w_wh a_wh[d] in place, and each read head's read[d] = sum_n
// w[n] src[n] with src the old memory (or the new, write-first), as a warp
// sum of the lanes' sums; the read also lands in the next step's layer-0
// input (xT row rh * D + d, column r).
template <int RT>
__device__ __forceinline__ void packed_write_read(const Dims& dm, const Flags& fl, float* row, const PackedLayout& lay,
                                                  int d, float* xT, int r) {
  const int lane = threadIdx.x & 31;
  const int N = dm.N, D = dm.D, R = dm.R, W = dm.W, Np = lay.Np;
  constexpr int G = ADDR_MAX_SLOTS / 128;  // a lane's groups of four slots
  float4 src[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int n = min(lane * 4 + 128 * g, Np - 4);
    float* p = row + lay.Mt + d * Np + n;
    const float4 m = ld4(p);
    float4 ek = make_float4(1.f, 1.f, 1.f, 1.f), ak = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int wh = 0; wh < W; ++wh) {
      const float4 w = ld4(row + lay.w + (R + wh) * Np + n);
      const float e = row[lay.er + wh * D + d], a = row[lay.ad + wh * D + d];
      ek.x *= 1.f - w.x * e;
      ek.y *= 1.f - w.y * e;
      ek.z *= 1.f - w.z * e;
      ek.w *= 1.f - w.w * e;
      ak.x = fmaf(w.x, a, ak.x);
      ak.y = fmaf(w.y, a, ak.y);
      ak.z = fmaf(w.z, a, ak.z);
      ak.w = fmaf(w.w, a, ak.w);
    }
    const float4 mn = make_float4(m.x * ek.x + ak.x, m.y * ek.y + ak.y, m.z * ek.z + ak.z, m.w * ek.w + ak.w);
    const bool mine = lane * 4 + 128 * g < N;
    src[g] = mine ? (fl.write_first ? mn : m) : make_float4(0.f, 0.f, 0.f, 0.f);
    if (mine) st4(p, mn);
  }
  for (int rh0 = 0; rh0 < R; rh0 += 4) {
    float part[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float* wr = row + lay.w + min(rh0 + k, R - 1) * Np;
      float p = 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) p = dot4(ld4(wr + min(lane * 4 + 128 * g, Np - 4)), src[g], p);
      part[k] = p;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) part[k] = warp_sum(part[k]);
    if (lane == 0)
      for (int k = 0; k < 4 && rh0 + k < R; ++k) {
        row[lay.read + (rh0 + k) * D + d] = part[k];
        xT[((rh0 + k) * D + d) * RT + r] = part[k];
      }
  }
}

// packed_write_read past ADDR_MAX_SLOTS slots, a lane per slot: the reads
// of the old memory, the write, or (write-first) the write, then the reads.
template <int RT>
__device__ __forceinline__ void packed_write_read_wide(const Dims& dm, const Flags& fl, float* row,
                                                       const PackedLayout& lay, int d, float* xT, int r) {
  const int lane = threadIdx.x & 31;
  const int N = dm.N, D = dm.D, R = dm.R, W = dm.W, Np = lay.Np;
  float* Md = row + lay.Mt + d * Np;
  const auto reads = [&]() {
    for (int rh = 0; rh < R; ++rh) {
      const float* wr = row + lay.w + rh * Np;
      float p = 0.f;
      for (int n = lane; n < N; n += 32) p = fmaf(wr[n], Md[n], p);
      p = warp_sum(p);
      if (lane == 0) {
        row[lay.read + rh * D + d] = p;
        xT[(rh * D + d) * RT + r] = p;
      }
    }
  };
  if (!fl.write_first) reads();
  for (int n = lane; n < N; n += 32) {
    float ek = 1.f, ak = 0.f;
    for (int wh = 0; wh < W; ++wh) {
      const float w = row[lay.w + (R + wh) * Np + n];
      ek *= 1.f - w * row[lay.er + wh * D + d];
      ak = fmaf(w, row[lay.ad + wh * D + d], ak);
    }
    Md[n] = Md[n] * ek + ak;
  }
  if (fl.write_first) reads();
}

// ---- the step ---------------------------------------------------------------------

// One cell step of the tile's nr live rows (rows b0 .. b0+nr-1), shared by
// the forward and the backward's recompute. Enters after a __syncthreads()
// that published the input state and xT = the tile's [read | h_0]
// (layer 0's input; its token part comes from proj). The forward (kBwd =
// false) updates the state in place, writes the logits and leaves xT = the
// next step's [read | h_0]; it returns after phase (c)'s barrier. The
// backward's recompute (kBwd) keeps the input state and every intermediate
// its VJPs read, writes the weight-gradient operands li (layers > 0) and
// ctrl, skips the write, the read and the logits, and returns after phase
// (b)'s barrier.
template <int RT, int RL, bool kBwd>
__device__ __forceinline__ void packed_chains(const PackedArgs& a, float* smem, const PackedLayout& lay, int nr) {
  const int warp = threadIdx.x >> 5, H = a.dm.H;
  for (int q = warp; q < nr * H; q += NWARPS) packed_chain<RL, kBwd>(a.dm, a.fl, ROWP(q / H, Mt) - lay.Mt, lay, q % H);
}

template <int RT, bool kBwd, class Pr>
__device__ __forceinline__ void packed_step(const PackedArgs& a, float* smem, const PackedLayout& lay, int b0, int nr,
                                            int t, Pr& pr) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Dims& dm = a.dm;
  const int IN = dm.IN, D = dm.D, H = dm.H, RD = dm.R * dm.D;
  const int Hc = dm.Hc, L = dm.L, O = dm.O, T = a.T, G4 = 4 * Hc;
  const int P = head_width(dm), KM = li_stride(dm);
  const size_t BT = (size_t)a.B * T, bt0 = (size_t)b0 * T + t;
  float* xT = smem + lay.xT;
  const auto bt_of = [&](int r) { return bt0 + (size_t)r * T; };

  // the backward's weight-gradient operand li = [x | read | h_0] of layer 0
  if (kBwd) {
    const int K0 = RD + Hc;
    for (int i = tid; i < nr * K0; i += NT) {
      const int r = i / K0, k = i - r * K0;
      a.li[bt_of(r) * KM + IN + k] = xT[k * RT + r];
    }
    for (int i = tid; i < nr * IN; i += NT) {
      const int r = i / IN, k = i - r * IN;
      a.li[bt_of(r) * KM + k] = ROWP(r, tok)[k];
    }
  }

  // ---- the stacked LSTM: layer 0 on proj + [read | h_0] W0[IN:] -----------
  for (int l = 0; l < L; ++l) {
    const int K = l == 0 ? RD + Hc : 2 * Hc;
    const float* Wl = a.wt.lstm_w[l] + (l == 0 ? (size_t)IN * G4 : 0);
    const int go = kBwd ? l * G4 : 0;
    tile_product<RT>(Wl, G4, G4, xT, K, nr, [&](int j, int r, float v) {
      const float base = l == 0 ? a.proj[bt_of(r) * G4 + j] : __ldg(a.wt.lstm_b[l] + j);
      ROWP(r, gates)[go + j] = v + base;
    });
    __syncthreads();
    pr.mark(0);
    for (int i = tid; i < nr * Hc; i += NT) {
      const int r = i / Hc, j = i - r * Hc;
      const float* gl = ROWP(r, gates) + go;
      const float c_new = ROWP(r, c)[l * Hc + j] * sigmoid_f(gl[2 * Hc + j]) + sigmoid_f(gl[j]) * tanhf(gl[Hc + j]);
      const float h_new = tanhf(c_new) * sigmoid_f(gl[3 * Hc + j]);
      xT[j * RT + r] = h_new;  // the next layer's (or the head linear's) input
      if (l + 1 < L) {
        const float h_next = ROWP(r, h)[(l + 1) * Hc + j];
        xT[(Hc + j) * RT + r] = h_next;
        if (kBwd) {
          float* li = a.li + ((size_t)(l + 1) * BT + bt_of(r)) * KM;
          li[j] = h_new;
          li[Hc + j] = h_next;
        }
      } else if (kBwd) {
        a.ctrl[bt_of(r) * Hc + j] = h_new;
      }
      if (kBwd) {
        ROWP(r, cn)[l * Hc + j] = c_new;
      } else {
        ROWP(r, c)[l * Hc + j] = c_new;
        ROWP(r, h)[l * Hc + j] = h_new;
      }
    }
    __syncthreads();
    pr.mark(1);
  }

  // ---- the head controls (and, in the forward, the logits) ----------------
  tile_product<RT>(a.wt.heads_w, P, P, xT, Hc, nr,
                   [&](int j, int r, float v) { ROWP(r, ctl)[j] = v + __ldg(a.wt.heads_b + j); });
  if (!kBwd)
    // a warp per logit column, from the last warp down (the head product
    // keeps the first ones busy); lanes over the controller output
    for (int o = NWARPS - 1 - warp; o < O; o += NWARPS) {
      float acc[RT];
      for (int r = 0; r < RT; ++r) acc[r] = 0.f;
      for (int k = lane; k < Hc; k += 32) {
        const float wv = __ldg(a.wt.out_w + (size_t)k * O + o);
        for (int r = 0; r < RT; ++r) acc[r] = fmaf(xT[k * RT + r], wv, acc[r]);
      }
      for (int r = 0; r < RT; ++r) acc[r] = warp_sum(acc[r]);
      if (lane == 0)
        for (int r = 0; r < nr; ++r) a.logits[bt_of(r) * O + o] = acc[r] + __ldg(a.wt.out_b + o);
    }
  __syncthreads();
  pr.mark(2);

  // ---- (a) the heads' preparation, the normalizer, erase and add ----------
  const int J = H + (a.fl.slotwise ? 0 : (D + 1) / 2) + 1;
  for (int q = warp; q < nr * J; q += NWARPS) packed_prep(dm, a.fl, ROWP(q / J, Mt) - lay.Mt, lay, q % J);
  if (!kBwd)
    for (int i = tid; i < nr * Hc; i += NT) {
      const int r = i / Hc, j = i - r * Hc;
      xT[(RD + j) * RT + r] = ROWP(r, h)[j];  // the next step's h_0
    }
  __syncthreads();
  pr.mark(3);

  // ---- (b) the head chains -------------------------------------------------
  if (dm.N > ADDR_MAX_SLOTS) {
    for (int q = warp; q < nr * H; q += NWARPS) packed_chain_wide<kBwd>(dm, a.fl, ROWP(q / H, Mt) - lay.Mt, lay, q % H);
  } else {
    switch (addr_run(dm.N)) {
      case 1:
        packed_chains<RT, 1, kBwd>(a, smem, lay, nr);
        break;
      case 2:
        packed_chains<RT, 2, kBwd>(a, smem, lay, nr);
        break;
      case 4:
        packed_chains<RT, 4, kBwd>(a, smem, lay, nr);
        break;
      default:
        packed_chains<RT, 8, kBwd>(a, smem, lay, nr);
    }
  }
  __syncthreads();
  pr.mark(4);

  // ---- (c) the write and the read (the forward) ----------------------------
  if constexpr (!kBwd) {
    for (int q = warp; q < nr * D; q += NWARPS) {
      if (dm.N > ADDR_MAX_SLOTS)
        packed_write_read_wide<RT>(dm, a.fl, ROWP(q / D, Mt) - lay.Mt, lay, q % D, xT, q / D);
      else
        packed_write_read<RT>(dm, a.fl, ROWP(q / D, Mt) - lay.Mt, lay, q % D, xT, q / D);
    }
    __syncthreads();
    pr.mark(5);
  }
}

// T cell steps of the rows blockIdx.x*RT .. +RT-1 (the last tile masked to
// B) with the state resident in shared memory. kResiduals also streams
// each step's input state, memory packed, to global memory.
template <int RT, bool kResiduals, bool kProbe = false>
__global__ void __launch_bounds__(NT, 1) packed_fwd_kernel(const PackedArgs a) {
  extern __shared__ float smem[];
  Probe<kProbe> pr;
  const int tid = threadIdx.x;
  const Dims dm = a.dm;
  const int N = dm.N, D = dm.D, H = dm.H, Hc = dm.Hc, L = dm.L, T = a.T, B = a.B;
  const int ND = N * D, HN = H * N, RD = dm.R * D, LH = L * Hc;
  const PackedLayout lay = make_packed_layout(dm, false, RT);
  const int Np = lay.Np;
  const int b0 = blockIdx.x * RT, nr = min(RT, B - b0);
  float* xT = smem + lay.xT;

  // rows past B and the columns past N stay zero
  for (int i = tid; i < lay.total; i += NT) smem[i] = 0.f;
  __syncthreads();
  for (int i = tid; i < nr * ND; i += NT) {
    const int r = i / ND, l = i - r * ND, n = l / D, d = l - n * D;
    ROWP(r, Mt)[d * Np + n] = a.M0[(size_t)(b0 + r) * ND + l];
  }
  for (int i = tid; i < nr * HN; i += NT) {
    const int r = i / HN, q = i - r * HN, h = q / N, n = q - h * N;
    ROWP(r, w)[h * Np + n] = a.w0[(size_t)(b0 + r) * HN + q];
  }
  for (int i = tid; i < nr * RD; i += NT) {
    const int r = i / RD, q = i - r * RD;
    const float v = a.read0[(size_t)(b0 + r) * RD + q];
    ROWP(r, read)[q] = v;
    xT[q * RT + r] = v;
  }
  for (int i = tid; i < nr * LH; i += NT) {
    const int r = i / LH, q = i - r * LH, l = q / Hc, j = q - l * Hc;
    ROWP(r, c)[q] = a.c0[l][(size_t)(b0 + r) * Hc + j];
    const float hv = a.h0[l][(size_t)(b0 + r) * Hc + j];
    ROWP(r, h)[q] = hv;
    if (l == 0) xT[(RD + j) * RT + r] = hv;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    if (kResiduals) {
      // the step's input state; the step overwrites these arrays only
      // after its first barrier
      for (int i = tid; i < nr * ND; i += NT) {
        const int r = i / ND, l = i - r * ND, d = l / N, n = l - d * N;
        a.res_M[((size_t)(b0 + r) * T + t) * ND + l] = ROWP(r, Mt)[d * Np + n];
      }
      for (int i = tid; i < nr * HN; i += NT) {
        const int r = i / HN, q = i - r * HN, h = q / N, n = q - h * N;
        a.res_w[((size_t)(b0 + r) * T + t) * HN + q] = ROWP(r, w)[h * Np + n];
      }
      for (int i = tid; i < nr * RD; i += NT) {
        const int r = i / RD, q = i - r * RD;
        a.res_read[((size_t)(b0 + r) * T + t) * RD + q] = ROWP(r, read)[q];
      }
      for (int i = tid; i < nr * LH; i += NT) {
        const int r = i / LH, q = i - r * LH;
        a.res_c[((size_t)(b0 + r) * T + t) * LH + q] = ROWP(r, c)[q];
        a.res_h[((size_t)(b0 + r) * T + t) * LH + q] = ROWP(r, h)[q];
      }
    }
    packed_step<RT, false>(a, smem, lay, b0, nr, t, pr);
  }
  pr.flush(a.probe);

  for (int i = tid; i < nr * ND; i += NT) {
    const int r = i / ND, l = i - r * ND, n = l / D, d = l - n * D;
    a.M[(size_t)(b0 + r) * ND + l] = ROWP(r, Mt)[d * Np + n];
  }
  for (int i = tid; i < nr * HN; i += NT) {
    const int r = i / HN, q = i - r * HN, h = q / N, n = q - h * N;
    a.w[(size_t)(b0 + r) * HN + q] = ROWP(r, w)[h * Np + n];
  }
  for (int i = tid; i < nr * RD; i += NT) a.read[(size_t)b0 * RD + i] = ROWP(i / RD, read)[i % RD];
  for (int i = tid; i < nr * LH; i += NT) {
    const int r = i / LH, q = i - r * LH, l = q / Hc, j = q - l * Hc;
    a.c[((size_t)l * B + b0 + r) * Hc + j] = ROWP(r, c)[q];
    a.h[((size_t)l * B + b0 + r) * Hc + j] = ROWP(r, h)[q];
  }
}

// ---- the backward -------------------------------------------------------------------

// The read and erase/add VJPs over memory row d of one row, a lane per four
// slots (dM holds d M_new from the step after): the read source's
// cotangent dsrc = sum_rh dread[rh, d] w_rh (joining d M_new where the read
// comes after the write), d M_new kept in dM for the write heads' chains,
// the cotangent through the write d M_prev = dsrc (read first) + d M_new *
// prod_wh (1 - w_wh e_wh[d]) into dMp, and each write head's erase and add
// cotangents (warp sums over n) into dctl. scan_bptt.cu's formulas and
// their order.
__device__ __forceinline__ void vjp_write(const Dims& dm, const Flags& fl, float* row, const PackedLayout& lay, int d) {
  const int lane = threadIdx.x & 31;
  const int N = dm.N, D = dm.D, H = dm.H, R = dm.R, W = dm.W, S = dm.S, Np = lay.Np;
  const int oErase = H * D + 3 * H + S * H, oAdd = oErase + W * D;
  const bool wf = fl.write_first != 0;
  constexpr int G = ADDR_MAX_SLOTS / 128;  // a lane's groups of four slots
  const float* wn = row + lay.wn;
  const float* er = row + lay.er;
  int at[G];
  bool mine[G];
  float4 m[G], dmn[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    at[g] = min(lane * 4 + 128 * g, Np - 4);
    mine[g] = lane * 4 + 128 * g < N;
    m[g] = ld4(row + lay.Mt + d * Np + at[g]);
    dmn[g] = ld4(row + lay.dM + d * Np + at[g]);
  }
  // the read source's cotangent, read heads four at a time
  float4 ds[G];
#pragma unroll
  for (int g = 0; g < G; ++g) ds[g] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int rh0 = 0; rh0 < R; rh0 += 4) {
    float4 w[4][G];
    float gr[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int rh = min(rh0 + k, R - 1);
      gr[k] = row[lay.dread + rh * D + d];
#pragma unroll
      for (int g = 0; g < G; ++g) w[k][g] = ld4(wn + rh * Np + at[g]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (rh0 + k >= R) break;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        ds[g].x = fmaf(gr[k], w[k][g].x, ds[g].x);
        ds[g].y = fmaf(gr[k], w[k][g].y, ds[g].y);
        ds[g].z = fmaf(gr[k], w[k][g].z, ds[g].z);
        ds[g].w = fmaf(gr[k], w[k][g].w, ds[g].w);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float4 ek = make_float4(1.f, 1.f, 1.f, 1.f);
    for (int wh = 0; wh < W; ++wh) {
      const float4 w = ld4(wn + (R + wh) * Np + at[g]);
      const float e = er[wh * D + d];
      ek.x *= 1.f - w.x * e;
      ek.y *= 1.f - w.y * e;
      ek.z *= 1.f - w.z * e;
      ek.w *= 1.f - w.w * e;
    }
    if (wf) dmn[g] = make_float4(dmn[g].x + ds[g].x, dmn[g].y + ds[g].y, dmn[g].z + ds[g].z, dmn[g].w + ds[g].w);
    const float4 fr = wf ? make_float4(0.f, 0.f, 0.f, 0.f) : ds[g];
    if (!mine[g]) continue;
    st4(row + lay.dM + d * Np + at[g], dmn[g]);
    st4(row + lay.dMp + d * Np + at[g], make_float4(fr.x + dmn[g].x * ek.x, fr.y + dmn[g].y * ek.y,
                                                    fr.z + dmn[g].z * ek.z, fr.w + dmn[g].w * ek.w));
  }
  for (int wh = 0; wh < W; ++wh) {
    float de = 0.f, da = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (!mine[g]) continue;
      const float4 ww = ld4(wn + (R + wh) * Np + at[g]);
      float4 oth = make_float4(1.f, 1.f, 1.f, 1.f);
      for (int wo = 0; wo < W; ++wo) {
        if (wo == wh) continue;
        const float4 w = ld4(wn + (R + wo) * Np + at[g]);
        const float e = er[wo * D + d];
        oth.x *= 1.f - w.x * e;
        oth.y *= 1.f - w.y * e;
        oth.z *= 1.f - w.z * e;
        oth.w *= 1.f - w.w * e;
      }
      const float4 q = dmn[g], mg = m[g];
      de -= q.x * mg.x * oth.x * ww.x;
      de -= q.y * mg.y * oth.y * ww.y;
      de -= q.z * mg.z * oth.z * ww.z;
      de -= q.w * mg.w * oth.w * ww.w;
      da = fmaf(q.x, ww.x, da);
      da = fmaf(q.y, ww.y, da);
      da = fmaf(q.z, ww.z, da);
      da = fmaf(q.w, ww.w, da);
    }
    de = warp_sum(de);
    da = warp_sum(da);
    if (lane == 0) {
      const float e = er[wh * D + d], ad = row[lay.ad + wh * D + d];
      row[lay.dctl + oErase + wh * D + d] = de * e * (1.f - e);
      row[lay.dctl + oAdd + wh * D + d] = da * (1.f - ad * ad);
    }
  }
}

// vjp_write past ADDR_MAX_SLOTS slots, a lane per slot.
__device__ __forceinline__ void vjp_write_wide(const Dims& dm, const Flags& fl, float* row, const PackedLayout& lay,
                                               int d) {
  const int lane = threadIdx.x & 31;
  const int N = dm.N, D = dm.D, H = dm.H, R = dm.R, W = dm.W, S = dm.S, Np = lay.Np;
  const int oErase = H * D + 3 * H + S * H, oAdd = oErase + W * D;
  const bool wf = fl.write_first != 0;
  const float* wn = row + lay.wn;
  const float* er = row + lay.er;
  const float* Md = row + lay.Mt + d * Np;
  float* dM = row + lay.dM + d * Np;
  for (int n = lane; n < N; n += 32) {
    float ds = 0.f, ek = 1.f;
    for (int rh = 0; rh < R; ++rh) ds = fmaf(row[lay.dread + rh * D + d], wn[rh * Np + n], ds);
    for (int wh = 0; wh < W; ++wh) ek *= 1.f - wn[(R + wh) * Np + n] * er[wh * D + d];
    const float dmn = wf ? dM[n] + ds : dM[n];
    dM[n] = dmn;
    row[lay.dMp + d * Np + n] = (wf ? 0.f : ds) + dmn * ek;
  }
  for (int wh = 0; wh < W; ++wh) {
    float de = 0.f, da = 0.f;
    for (int n = lane; n < N; n += 32) {
      const float ww = wn[(R + wh) * Np + n];
      float oth = 1.f;
      for (int wo = 0; wo < W; ++wo)
        if (wo != wh) oth *= 1.f - wn[(R + wo) * Np + n] * er[wo * D + d];
      de -= dM[n] * Md[n] * oth * ww;
      da = fmaf(dM[n], ww, da);
    }
    de = warp_sum(de);
    da = warp_sum(da);
    if (lane == 0) {
      const float e = er[wh * D + d], ad = row[lay.ad + wh * D + d];
      row[lay.dctl + oErase + wh * D + d] = de * e * (1.f - e);
      row[lay.dctl + oAdd + wh * D + d] = da * (1.f - ad * ad);
    }
  }
}

// Head h's chain VJP of one row by one warp, each lane a run of RL slots:
// the new weights' cotangent dwh (the carry dw plus, for a read head, sum_d
// dread[h, d] src[d][n], for a write head its erase/add terms over d), then
// the sharpen, the shift, the gate and the softmax. Leaves the carry to
// the step before in dw's row h, the similarity's cotangent d u in u's row
// h, d|k|^2 in dkss and the scalar controls' and the shift logits'
// cotangents in dctl. scan_bptt.cu's formulas and their order.
template <int RL>
__device__ __forceinline__ void packed_chain_vjp(const Dims& dm, const Flags& fl, float* row, const PackedLayout& lay,
                                                 int h) {
  const int lane = threadIdx.x & 31;
  const int N = dm.N, D = dm.D, H = dm.H, R = dm.R, W = dm.W, S = dm.S, Np = lay.Np;
  const int oBeta = H * D, oG = oBeta + H, oSw = oG + H, oGamma = oSw + S * H;
  const int n0 = lane * RL;
  const bool live = n0 < N, second = n0 + 4 < Np;
  const int at = live ? n0 : 0;
  const float* Mrun = row + lay.Mt + at;
  const float* wn = row + lay.wn;
  const float* er = row + lay.er;
  const float* ad = row + lay.ad;

  float dwh[RL];
  load_run<RL>(row + lay.dw + h * Np + at, dwh, second);
  if (h < R) {
    const float* dr = row + lay.dread + h * D;
    for (int d = 0; d < D; ++d) {
      float src[RL];
      load_run<RL>(Mrun + d * Np, src, second);
      if (fl.write_first) {
        // the read source is the new memory: M * prod (1 - w e) + sum w a
        float ek[RL], ak[RL];
#pragma unroll
        for (int i = 0; i < RL; ++i) ek[i] = 1.f, ak[i] = 0.f;
        for (int wh = 0; wh < W; ++wh) {
          float w[RL];
          load_run<RL>(wn + (R + wh) * Np + at, w, second);
          const float e = er[wh * D + d], a = ad[wh * D + d];
#pragma unroll
          for (int i = 0; i < RL; ++i) {
            ek[i] *= 1.f - w[i] * e;
            ak[i] = fmaf(w[i], a, ak[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < RL; ++i) src[i] = src[i] * ek[i] + ak[i];
      }
      const float g = dr[d];
#pragma unroll
      for (int i = 0; i < RL; ++i) dwh[i] = fmaf(g, src[i], dwh[i]);
    }
  } else {
    const int wh = h - R;
    for (int d = 0; d < D; ++d) {
      float m[RL], dmn[RL], oth[RL];
      load_run<RL>(Mrun + d * Np, m, second);
      load_run<RL>(row + lay.dM + d * Np + at, dmn, second);
#pragma unroll
      for (int i = 0; i < RL; ++i) oth[i] = 1.f;
      for (int wo = 0; wo < W; ++wo) {
        if (wo == wh) continue;
        float w[RL];
        load_run<RL>(wn + (R + wo) * Np + at, w, second);
        const float e = er[wo * D + d];
#pragma unroll
        for (int i = 0; i < RL; ++i) oth[i] *= 1.f - w[i] * e;
      }
      const float e = er[wh * D + d], a = ad[wh * D + d];
#pragma unroll
      for (int i = 0; i < RL; ++i) {
        const float dfac = dmn[i] * m[i] * oth[i];
        dwh[i] = dwh[i] - dfac * e + dmn[i] * a;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RL; ++i)
    if (n0 + i >= N) dwh[i] = 0.f;

  // sharpen: w = p / (sum p + 1e-3), p = w_conv ^ gamma
  const float gam = row[lay.hs + 4 * h + 2], inv_den = 1.f / row[lay.den + h];
  float wcv[RL], p[RL];
  load_run<RL>(row + lay.wconv + h * Np + at, wcv, second);
  float s1 = 0.f;
#pragma unroll
  for (int i = 0; i < RL; ++i) {
    p[i] = n0 + i < N ? powf(wcv[i], gam) : 0.f;  // the forward's p, bit for bit
    s1 = fmaf(dwh[i], p[i], s1);
  }
  s1 = warp_sum(s1);
  const float gm1 = gam - 1.f;
  float dwconv[RL], dgam = 0.f;
#pragma unroll
  for (int i = 0; i < RL; ++i) {
    const float dp = dwh[i] * inv_den - s1 * inv_den * inv_den;
    // the derivative factor w_conv^(gamma - 1) by exp2f(log2f): it enters
    // the step's gradient once and is not carried through the recurrence
    // as p is; with powf (H100 80GB HBM3, 700 W, the flagship at B=256)
    // the chains' VJP phase took 9.1 us a step against 7.8, and
    // chip_smoke.py's initial-state referee read 6.6-7.0e-5 against
    // 3.2-4.1e-5
    const float pw1 = gm1 > 0.f ? exp2f(gm1 * log2f(wcv[i])) : 1.f;
    dwconv[i] = n0 + i < N ? dp * gam * pw1 : 0.f;
    if (n0 + i < N && wcv[i] > 0.f) dgam += dp * p[i] * logf(wcv[i]);
  }
  dgam = warp_sum(dgam);

  // circular shift: w_conv[n] = sum_j sw_j w_g[n + s_j]
  const float gt = row[lay.hs + 4 * h + 1];
  float wc[RL], wp[RL], wg[RL];
  load_run<RL>(row + lay.wc + h * Np + at, wc, second);
  load_run<RL>(row + lay.w + h * Np + at, wp, second);
#pragma unroll
  for (int i = 0; i < RL; ++i) wg[i] = n0 + i < N ? wc[i] * gt + wp[i] * (1.f - gt) : 0.f;
  const int shift0 = -((S + 1) / 2);
  const float* swv = row + lay.swv + h * S;
  float* dctl = row + lay.dctl;
  float dot_sw = 0.f;
  for (int j = 0; j < S; ++j) {
    float v[RL];
    shifted_run<RL>(wg, (shift0 + j) % N, N, v);
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < RL; ++i) acc = fmaf(dwconv[i], v[i], acc);
    acc = warp_sum(acc);
    dot_sw = fmaf(acc, swv[j], dot_sw);
    if (lane == 0) dctl[oSw + h * S + j] = acc;  // d sw_j, finished below
  }
  float dwg[RL];
#pragma unroll
  for (int i = 0; i < RL; ++i) dwg[i] = 0.f;
  for (int j = 0; j < S; ++j) {
    float v[RL];
    shifted_run<RL>(dwconv, -(shift0 + j) % N, N, v);
    const float swj = swv[j];
#pragma unroll
    for (int i = 0; i < RL; ++i) dwg[i] = fmaf(swj, v[i], dwg[i]);
  }

  // gate: w_g = w_c g + w_prev (1 - g); content softmax w_c = softmax(sim
  // beta), sim = u |k|^-1
  const float bt = row[lay.hs + 4 * h], ki = row[lay.hs + 4 * h + 3];
  float u[RL];
  load_run<RL>(row + lay.u + h * Np + at, u, second);
  float dg = 0.f, cdot = 0.f, dwc[RL], carry[RL];
#pragma unroll
  for (int i = 0; i < RL; ++i) {
    const bool v = n0 + i < N;
    dwc[i] = v ? dwg[i] * gt : 0.f;
    carry[i] = v ? dwg[i] * (1.f - gt) : 0.f;
    if (v) {
      dg = fmaf(dwg[i], wc[i] - wp[i], dg);
      cdot = fmaf(dwc[i], wc[i], cdot);
    }
  }
  dg = warp_sum(dg);
  cdot = warp_sum(cdot);
  float dbeta = 0.f, dki = 0.f, du[RL];
#pragma unroll
  for (int i = 0; i < RL; ++i) {
    const float ds = (dwc[i] - cdot) * wc[i];
    const float dsim = ds * bt;
    if (n0 + i < N) {
      dbeta = fmaf(ds, u[i] * ki, dbeta);
      dki = fmaf(dsim, u[i], dki);
    }
    du[i] = n0 + i < N ? dsim * ki : 0.f;
  }
  dbeta = warp_sum(dbeta);
  dki = warp_sum(dki);
  if (live) {
    store_run<RL>(row + lay.dw + h * Np + n0, carry, second);
    store_run<RL>(row + lay.u + h * Np + n0, du, second);
  }
  if (lane == 0) {
    const float* ctl = row + lay.ctl;
    row[lay.dkss + h] = row[lay.kss + h] > 1e-12f ? dki * -0.5f * ki * ki * ki : 0.f;
    for (int j = 0; j < S; ++j) dctl[oSw + h * S + j] = (dctl[oSw + h * S + j] - dot_sw) * swv[j];
    dctl[oBeta + h] = dbeta * sigmoid_f(ctl[oBeta + h]);
    dctl[oG + h] = dg * gt * (1.f - gt);
    dctl[oGamma + h] = dgam * sigmoid_f(ctl[oGamma + h]);
  }
}

// packed_chain_vjp past ADDR_MAX_SLOTS slots, a lane per slot, its
// intermediates in shared memory: dw's row h takes the new weights'
// cotangent, then the gated weights (the shift's input), then the carry;
// wconv's row h takes d w_conv; the transposed shift is taken twice (for
// the gate's and the softmax's sums, then for each slot's cotangents).
__device__ __forceinline__ void packed_chain_vjp_wide(const Dims& dm, const Flags& fl, float* row,
                                                      const PackedLayout& lay, int h) {
  const int lane = threadIdx.x & 31;
  const int N = dm.N, D = dm.D, H = dm.H, R = dm.R, W = dm.W, S = dm.S, Np = lay.Np;
  const int oBeta = H * D, oG = oBeta + H, oSw = oG + H, oGamma = oSw + S * H;
  const float* Mt = row + lay.Mt;
  const float* wn = row + lay.wn;
  const float* er = row + lay.er;
  const float* ad = row + lay.ad;
  const float* wc = row + lay.wc + h * Np;
  const float* wp = row + lay.w + h * Np;
  float* dw = row + lay.dw + h * Np;
  float* wcv = row + lay.wconv + h * Np;
  float* u = row + lay.u + h * Np;

  float s1 = 0.f;
  const float gam = row[lay.hs + 4 * h + 2], inv_den = 1.f / row[lay.den + h];
  for (int n = lane; n < N; n += 32) {
    float g = dw[n];
    if (h < R) {
      for (int d = 0; d < D; ++d) {
        float src = Mt[d * Np + n];
        if (fl.write_first) {
          float ek = 1.f, ak = 0.f;
          for (int wh = 0; wh < W; ++wh) {
            const float w = wn[(R + wh) * Np + n];
            ek *= 1.f - w * er[wh * D + d];
            ak = fmaf(w, ad[wh * D + d], ak);
          }
          src = src * ek + ak;
        }
        g = fmaf(row[lay.dread + h * D + d], src, g);
      }
    } else {
      const int wh = h - R;
      for (int d = 0; d < D; ++d) {
        const float m = Mt[d * Np + n], dmn = row[lay.dM + d * Np + n];
        float oth = 1.f;
        for (int wo = 0; wo < W; ++wo)
          if (wo != wh) oth *= 1.f - wn[(R + wo) * Np + n] * er[wo * D + d];
        const float dfac = dmn * m * oth;
        g = g - dfac * er[wh * D + d] + dmn * ad[wh * D + d];
      }
    }
    dw[n] = g;
    s1 = fmaf(g, powf(wcv[n], gam), s1);
  }
  s1 = warp_sum(s1);

  // sharpen, then the gated weights into dw's row for the shift's sums
  const float gm1 = gam - 1.f, gt = row[lay.hs + 4 * h + 1];
  float dgam = 0.f;
  for (int n = lane; n < N; n += 32) {
    const float x = wcv[n], p = powf(x, gam);
    const float dp = dw[n] * inv_den - s1 * inv_den * inv_den;
    const float pw1 = gm1 > 0.f ? exp2f(gm1 * log2f(x)) : 1.f;
    if (x > 0.f) dgam += dp * p * logf(x);
    wcv[n] = dp * gam * pw1;
    dw[n] = wc[n] * gt + wp[n] * (1.f - gt);
  }
  dgam = warp_sum(dgam);
  __syncwarp();

  const int shift0 = -((S + 1) / 2);
  const float* swv = row + lay.swv + h * S;
  float* dctl = row + lay.dctl;
  float dot_sw = 0.f;
  for (int j = 0; j < S; ++j) {
    float acc = 0.f;
    for (int n = lane; n < N; n += 32) acc = fmaf(wcv[n], dw[wrap_slot(n + shift0 + j, N)], acc);
    acc = warp_sum(acc);
    dot_sw = fmaf(acc, swv[j], dot_sw);
    if (lane == 0) dctl[oSw + h * S + j] = acc;  // d sw_j, finished below
  }
  const auto dwg_at = [&](int n) {
    float v = 0.f;
    for (int j = 0; j < S; ++j) v = fmaf(swv[j], wcv[wrap_slot(n - shift0 - j, N)], v);
    return v;
  };
  float dg = 0.f, cdot = 0.f;
  for (int n = lane; n < N; n += 32) {
    const float g = dwg_at(n);
    dg = fmaf(g, wc[n] - wp[n], dg);
    cdot = fmaf(g * gt, wc[n], cdot);
  }
  dg = warp_sum(dg);
  cdot = warp_sum(cdot);
  __syncwarp();  // every lane has read the gated weights

  const float bt = row[lay.hs + 4 * h], ki = row[lay.hs + 4 * h + 3];
  float dbeta = 0.f, dki = 0.f;
  for (int n = lane; n < N; n += 32) {
    const float g = dwg_at(n);
    const float ds = (g * gt - cdot) * wc[n];
    const float dsim = ds * bt;
    dbeta = fmaf(ds, u[n] * ki, dbeta);
    dki = fmaf(dsim, u[n], dki);
    u[n] = dsim * ki;
    dw[n] = g * (1.f - gt);
  }
  dbeta = warp_sum(dbeta);
  dki = warp_sum(dki);
  if (lane == 0) {
    const float* ctl = row + lay.ctl;
    row[lay.dkss + h] = row[lay.kss + h] > 1e-12f ? dki * -0.5f * ki * ki * ki : 0.f;
    for (int j = 0; j < S; ++j) dctl[oSw + h * S + j] = (dctl[oSw + h * S + j] - dot_sw) * swv[j];
    dctl[oBeta + h] = dbeta * sigmoid_f(ctl[oBeta + h]);
    dctl[oG + h] = dg * gt * (1.f - gt);
    dctl[oGamma + h] = dgam * sigmoid_f(ctl[oGamma + h]);
  }
}

// The keys and the normalizer over memory row d of one row, a lane per four
// slots, after the chains: d Mtn[d][n] = sum_h du[h][n] tanh(k)[h, d] (kept
// in dM), each head's key cotangent sum_n du[h][n] M[d][n] minv (warp
// sums) into dctl; across-slot, the normalizer's cotangent for row d and
// the carry dM = dMp + d Mtn minv[d] + 2 M dss[d]. scan_bptt.cu's formulas
// and their order. A lane's groups of four slots sit in registers, and
// each chunk of four heads' loads is issued before any is used.
__device__ __forceinline__ void vjp_keys(const Dims& dm, const Flags& fl, float* row, const PackedLayout& lay, int d) {
  const int lane = threadIdx.x & 31;
  const int N = dm.N, D = dm.D, H = dm.H, Np = lay.Np, Dp = lay.Dp;
  const bool slotwise = fl.slotwise != 0;
  constexpr int G = ADDR_MAX_SLOTS / 128;  // a lane's groups of four slots
  const float* du = row + lay.u;
  const float* kt = row + lay.kt;
  const float mi_d = row[lay.minv + d];
  int at[G];
  bool mine[G];
  float4 m[G], mm[G], dmt[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    at[g] = min(lane * 4 + 128 * g, Np - 4);
    mine[g] = lane * 4 + 128 * g < N;
    m[g] = ld4(row + lay.Mt + d * Np + at[g]);
    const float4 mi = slotwise ? ld4(row + lay.nmi + at[g]) : make_float4(mi_d, mi_d, mi_d, mi_d);
    mm[g] = make_float4(m[g].x * mi.x, m[g].y * mi.y, m[g].z * mi.z, m[g].w * mi.w);
    dmt[g] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int h0 = 0; h0 < H; h0 += 4) {
    float4 gv[4][G];
    float kv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int h = min(h0 + k, H - 1);
      kv[k] = kt[h * Dp + d];
#pragma unroll
      for (int g = 0; g < G; ++g) gv[k][g] = ld4(du + h * Np + at[g]);
    }
    float part[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool live = h0 + k < H;
      float p = 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (!mine[g]) continue;
        p = fmaf(gv[k][g].x, mm[g].x, p);
        p = fmaf(gv[k][g].y, mm[g].y, p);
        p = fmaf(gv[k][g].z, mm[g].z, p);
        p = fmaf(gv[k][g].w, mm[g].w, p);
        if (live) {
          dmt[g].x = fmaf(gv[k][g].x, kv[k], dmt[g].x);
          dmt[g].y = fmaf(gv[k][g].y, kv[k], dmt[g].y);
          dmt[g].z = fmaf(gv[k][g].z, kv[k], dmt[g].z);
          dmt[g].w = fmaf(gv[k][g].w, kv[k], dmt[g].w);
        }
      }
      part[k] = p;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) part[k] = warp_sum(part[k]);
    if (lane == 0)
      for (int k = 0; k < 4 && h0 + k < H; ++k) {
        const int h = h0 + k;
        const float kt_v = kt[h * Dp + d];
        row[lay.dctl + h * D + d] = (part[k] + 2.f * kt_v * row[lay.dkss + h]) * (1.f - kt_v * kt_v);
      }
  }
  float sacc = 0.f;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (!mine[g]) continue;
    st4(row + lay.dM + d * Np + at[g], dmt[g]);
    sacc = fmaf(dmt[g].x, m[g].x, sacc);
    sacc = fmaf(dmt[g].y, m[g].y, sacc);
    sacc = fmaf(dmt[g].z, m[g].z, sacc);
    sacc = fmaf(dmt[g].w, m[g].w, sacc);
  }
  if (slotwise) return;
  sacc = warp_sum(sacc);
  const float dss = row[lay.mss + d] > 1e-12f ? sacc * -0.5f * mi_d * mi_d * mi_d : 0.f;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (!mine[g]) continue;
    const float4 mp = ld4(row + lay.dMp + d * Np + at[g]);
    st4(row + lay.dM + d * Np + at[g],
        make_float4(mp.x + dmt[g].x * mi_d + 2.f * m[g].x * dss, mp.y + dmt[g].y * mi_d + 2.f * m[g].y * dss,
                    mp.z + dmt[g].z * mi_d + 2.f * m[g].z * dss, mp.w + dmt[g].w * mi_d + 2.f * m[g].w * dss));
  }
}

// vjp_keys past ADDR_MAX_SLOTS slots, a lane per slot.
__device__ __forceinline__ void vjp_keys_wide(const Dims& dm, const Flags& fl, float* row, const PackedLayout& lay,
                                              int d) {
  const int lane = threadIdx.x & 31;
  const int N = dm.N, D = dm.D, H = dm.H, Np = lay.Np, Dp = lay.Dp;
  const bool slotwise = fl.slotwise != 0;
  const float* du = row + lay.u;
  const float* kt = row + lay.kt;
  const float* Md = row + lay.Mt + d * Np;
  float* dM = row + lay.dM + d * Np;
  const float mi_d = row[lay.minv + d];
  for (int h = 0; h < H; ++h) {
    float p = 0.f;
    for (int n = lane; n < N; n += 32) p = fmaf(du[h * Np + n], Md[n] * (slotwise ? row[lay.nmi + n] : mi_d), p);
    p = warp_sum(p);
    if (lane == 0) {
      const float kt_v = kt[h * Dp + d];
      row[lay.dctl + h * D + d] = (p + 2.f * kt_v * row[lay.dkss + h]) * (1.f - kt_v * kt_v);
    }
  }
  float sacc = 0.f;
  for (int n = lane; n < N; n += 32) {
    float dmt = 0.f;
    for (int h = 0; h < H; ++h) dmt = fmaf(du[h * Np + n], kt[h * Dp + d], dmt);
    dM[n] = dmt;
    sacc = fmaf(dmt, Md[n], sacc);
  }
  if (slotwise) return;
  sacc = warp_sum(sacc);
  const float dss = row[lay.mss + d] > 1e-12f ? sacc * -0.5f * mi_d * mi_d * mi_d : 0.f;
  for (int n = lane; n < N; n += 32) dM[n] = row[lay.dMp + d * Np + n] + dM[n] * mi_d + 2.f * Md[n] * dss;
}

// Unit j of layer l's LSTM step of one row, backwards: from dctrl, the
// cotangent of its new h from above (the head linears or the layer above),
// and the carries dh, dc, the gate cotangents over the gates and the carry
// dc to the step before. scan_bptt.cu's formulas and their order.
__device__ __forceinline__ void gate_vjp(float* row, const PackedLayout& lay, int Hc, int l, int j, float dctrl) {
  float* gl = row + lay.gates + l * 4 * Hc;  // the gate cotangents overwrite the gates
  const float si = sigmoid_f(gl[j]), tj = tanhf(gl[Hc + j]);
  const float sf = sigmoid_f(gl[2 * Hc + j]), so = sigmoid_f(gl[3 * Hc + j]);
  const float tc = tanhf(row[lay.cn + l * Hc + j]);
  const float dnh = dctrl + row[lay.dh + l * Hc + j];
  const float dnc = row[lay.dc + l * Hc + j] + dnh * so * (1.f - tc * tc);
  gl[j] = dnc * tj * si * (1.f - si);
  gl[Hc + j] = dnc * si * (1.f - tj * tj);
  gl[2 * Hc + j] = dnc * row[lay.c + l * Hc + j] * sf * (1.f - sf);
  gl[3 * Hc + j] = dnh * tc * so * (1.f - so);
  row[lay.dc + l * Hc + j] = dnc * sf;  // the carry
}

// Issues the cp.async copies of step t's inputs for the tile (the caller
// commits and waits): the state (the memory into Mt's stride), layer 0's
// input [read | h_0] into xT, the tokens (for li) and the logits'
// cotangents; 16-byte copies where the rows allow.
template <int RT>
__device__ __forceinline__ void load_step_async(const PackedArgs& a, float* smem, const PackedLayout& lay, int b0,
                                                int nr, int t) {
  const int tid = threadIdx.x;
  const Dims& dm = a.dm;
  const int IN = dm.IN, N = dm.N, D = dm.D, H = dm.H, RD = dm.R * dm.D, Hc = dm.Hc, L = dm.L, O = dm.O, T = a.T;
  const int ND = N * D, HN = H * N, LH = L * Hc, Np = lay.Np, K0 = RD + Hc;
  float* xT = smem + lay.xT;
  const auto bt_of = [&](int r) { return (size_t)(b0 + r) * T + t; };
  // [X][N] rows of global memory into [X][Np] rows of shared memory
  const auto rows_in = [&](int f, const float* src, int n_all) {
    if (N % 4 == 0) {
      const int q4 = n_all / 4;
      for (int i = tid; i < nr * q4; i += NT) {
        const int r = i / q4, l = (i - r * q4) * 4, x = l / N, n = l - x * N;
        cp_async_f32x4(smem + r * lay.row + f + x * Np + n, src + bt_of(r) * n_all + l);
      }
    } else {
      for (int i = tid; i < nr * n_all; i += NT) {
        const int r = i / n_all, l = i - r * n_all, x = l / N, n = l - x * N;
        cp_async_f32(smem + r * lay.row + f + x * Np + n, src + bt_of(r) * n_all + l);
      }
    }
  };
  // rows of n floats, as they are
  const auto flat_in = [&](int f, const float* src, int n) {
    if (n % 4 == 0) {
      for (int i = tid; i < nr * n / 4; i += NT) {
        const int r = i / (n / 4), q = (i - r * (n / 4)) * 4;
        cp_async_f32x4(smem + r * lay.row + f + q, src + bt_of(r) * n + q);
      }
    } else {
      for (int i = tid; i < nr * n; i += NT) {
        const int r = i / n, q = i - r * n;
        cp_async_f32(smem + r * lay.row + f + q, src + bt_of(r) * n + q);
      }
    }
  };
  rows_in(lay.Mt, a.res_M, ND);
  rows_in(lay.w, a.res_w, HN);
  flat_in(lay.c, a.res_c, LH);
  flat_in(lay.h, a.res_h, LH);
  flat_in(lay.tok, a.tokens, IN);
  flat_in(lay.dlogit, a.dlogits, O);
  for (int i = tid; i < nr * K0; i += NT) {
    const int r = i / K0, k = i - r * K0;
    cp_async_f32(xT + k * RT + r, k < RD ? a.res_read + bt_of(r) * RD + k : a.res_h + bt_of(r) * LH + k - RD);
  }
}

template <int RT, int RL>
__device__ __forceinline__ void chains_vjp(const PackedArgs& a, float* smem, const PackedLayout& lay, int nr) {
  const int warp = threadIdx.x >> 5, H = a.dm.H;
  for (int q = warp; q < nr * H; q += NWARPS) packed_chain_vjp<RL>(a.dm, a.fl, ROWP(q / H, Mt) - lay.Mt, lay, q % H);
}

// The reverse-time walk of RT rows per block: the VJPs of scan_bptt.cu's
// ntm_bptt_bwd_kernel on the packed layout, over the tile.
template <int RT, bool kProbe = false>
__global__ void __launch_bounds__(NT, 1) packed_bwd_kernel(const PackedArgs a) {
  extern __shared__ float smem[];
  Probe<kProbe> pr;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Dims dm = a.dm;
  const int IN = dm.IN, N = dm.N, D = dm.D, H = dm.H, R = dm.R;
  const int Hc = dm.Hc, L = dm.L, O = dm.O, T = a.T, B = a.B;
  const int ND = N * D, HN = H * N, RD = R * D, LH = L * Hc, G4 = 4 * Hc;
  const int P = head_width(dm);
  const PackedLayout lay = make_packed_layout(dm, true, RT);
  const int Np = lay.Np;
  const int b0 = blockIdx.x * RT, nr = min(RT, B - b0);
  const size_t BT = (size_t)B * T;
  const bool slotwise = a.fl.slotwise != 0;

  for (int i = tid; i < lay.total; i += NT) smem[i] = 0.f;
  __syncthreads();
  for (int i = tid; i < nr * ND; i += NT) {
    const int r = i / ND, l = i - r * ND, n = l / D, d = l - n * D;
    ROWP(r, dM)[d * Np + n] = a.dM_T[(size_t)(b0 + r) * ND + l];
  }
  for (int i = tid; i < nr * HN; i += NT) {
    const int r = i / HN, q = i - r * HN, h = q / N, n = q - h * N;
    ROWP(r, dw)[h * Np + n] = a.dw_T[(size_t)(b0 + r) * HN + q];
  }
  for (int i = tid; i < nr * RD; i += NT) ROWP(i / RD, dread)[i % RD] = a.dread_T[(size_t)b0 * RD + i];
  for (int i = tid; i < nr * LH; i += NT) {
    const int r = i / LH, q = i - r * LH, l = q / Hc, j = q - l * Hc;
    ROWP(r, dc)[q] = a.dc_T[((size_t)l * B + b0 + r) * Hc + j];
    ROWP(r, dh)[q] = a.dh_T[((size_t)l * B + b0 + r) * Hc + j];
  }
  load_step_async<RT>(a, smem, lay, b0, nr, T - 1);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    const auto bt_of = [&](int r) { return (size_t)(b0 + r) * T + t; };
    // ---- recompute the step from its residual input state ----------------
    packed_step<RT, true>(a, smem, lay, b0, nr, t, pr);

    // ---- the read and erase/add VJPs, a warp per (row, memory row) --------
    for (int q = warp; q < nr * D; q += NWARPS) {
      if (N > ADDR_MAX_SLOTS)
        vjp_write_wide(dm, a.fl, ROWP(q / D, Mt) - lay.Mt, lay, q % D);
      else
        vjp_write(dm, a.fl, ROWP(q / D, Mt) - lay.Mt, lay, q % D);
    }
    __syncthreads();
    pr.mark(5);

    // ---- the head chains' VJPs, a warp per (row, head) ---------------------
    if (N > ADDR_MAX_SLOTS) {
      for (int q = warp; q < nr * H; q += NWARPS) packed_chain_vjp_wide(dm, a.fl, ROWP(q / H, Mt) - lay.Mt, lay, q % H);
    } else {
      switch (addr_run(N)) {
        case 1:
          chains_vjp<RT, 1>(a, smem, lay, nr);
          break;
        case 2:
          chains_vjp<RT, 2>(a, smem, lay, nr);
          break;
        case 4:
          chains_vjp<RT, 4>(a, smem, lay, nr);
          break;
        default:
          chains_vjp<RT, 8>(a, smem, lay, nr);
      }
    }
    __syncthreads();
    pr.mark(6);

    // ---- the keys and the normalizer, a warp per (row, memory row) --------
    for (int q = warp; q < nr * D; q += NWARPS) {
      if (N > ADDR_MAX_SLOTS)
        vjp_keys_wide(dm, a.fl, ROWP(q / D, Mt) - lay.Mt, lay, q % D);
      else
        vjp_keys(dm, a.fl, ROWP(q / D, Mt) - lay.Mt, lay, q % D);
    }
    __syncthreads();
    pr.mark(7);

    // ---- the head and output linears, the top layer's gate cotangents;
    // slotwise, the normalizer per slot --------------------------------------
    for (int i = tid; i < nr * (P + O); i += NT) {
      const int r = i / (P + O), q = i - r * (P + O);
      a.dctl[bt_of(r) * (P + O) + q] = q < P ? ROWP(r, dctl)[q] : ROWP(r, dlogit)[q - P];
    }
    // d ctrl = heads_w @ dctl + out_w @ dlogit: a warp per kRows rows of
    // heads_w and out_w, lanes over their columns
    for (int k = warp; k < Hc; k += kRows * NWARPS) {
      float acc[kRows][RT] = {};
      heads_dot<RT>(a.wt, P, O, k, Hc, smem + lay.dctl, smem + lay.dlogit, lay.row, acc);
      for (int i = 0; i < kRows; ++i)
        for (int r = 0; r < RT; ++r) acc[i][r] = warp_sum(acc[i][r]);
      if (lane == 0)
        for (int i = 0; i < kRows && k + i * NWARPS < Hc; ++i)
          for (int r = 0; r < nr; ++r) ROWP(r, dctrl)[k + i * NWARPS] = acc[i][r];
    }
    if (slotwise)
      for (int i = tid; i < nr * N; i += NT) {
        const int r = i / N, n = i - r * N;
        float* dM = ROWP(r, dM);
        const float* M = ROWP(r, Mt);
        float acc = 0.f;
        for (int d = 0; d < D; ++d) acc = fmaf(dM[d * Np + n], M[d * Np + n], acc);
        const float mi = ROWP(r, nmi)[n];
        const float dss = ROWP(r, nss)[n] > 1e-12f ? acc * -0.5f * mi * mi * mi : 0.f;
        for (int d = 0; d < D; ++d)
          dM[d * Np + n] = ROWP(r, dMp)[d * Np + n] + dM[d * Np + n] * mi + 2.f * M[d * Np + n] * dss;
      }
    __syncthreads();
    pr.mark(8);

    // ---- stacked LSTM, top layer first ---------------------------------------
    for (int l = L - 1; l >= 0; --l) {
      const int go = l * G4, in_l = l == 0 ? IN + RD : Hc, K = in_l + Hc;
      for (int i = tid; i < nr * Hc; i += NT) {
        const int r = i / Hc, j = i - r * Hc;
        gate_vjp(ROWP(r, Mt) - lay.Mt, lay, Hc, l, j, ROWP(r, dctrl)[j]);
      }
      __syncthreads();
      pr.mark(9);
      for (int i = tid; i < nr * G4; i += NT) {
        const int r = i / G4, q = i - r * G4;
        a.dgates[((size_t)l * BT + bt_of(r)) * G4 + q] = ROWP(r, gates)[go + q];
      }
      // the step before's inputs land while the product runs
      if (l == 0 && t > 0) {
        load_step_async<RT>(a, smem, lay, b0, nr, t - 1);
        cp_async_commit();
      }
      // d layer input = W_l @ dgates: a warp per kRows input rows, lanes over
      // the gates, one weight load for the tile's rows; each row's sum goes
      // where it is carried (dh, dread, the layer below's dctrl) or, for
      // the token rows when asked, to dtokens
      const int k_lo = (l == 0 && !a.need_dtokens) ? IN : 0;
      for (int k = k_lo + warp; k < K; k += kRows * NWARPS) {
        float acc[kRows][RT] = {};
        rows_dot<RT>(a.wt.lstm_w[l], G4, k, K, G4, smem + lay.gates + go, lay.row, acc);
        for (int i = 0; i < kRows; ++i)
          for (int r = 0; r < RT; ++r) acc[i][r] = warp_sum(acc[i][r]);
        if (lane == 0)
          for (int i = 0; i < kRows && k + i * NWARPS < K; ++i) {
            const int kk = k + i * NWARPS;
            for (int r = 0; r < nr; ++r) {
              const float v = acc[i][r];
              if (kk >= in_l)
                ROWP(r, dh)[l * Hc + kk - in_l] = v;
              else if (l > 0)
                ROWP(r, dctrl)[kk] = v;
              else if (kk >= IN)
                ROWP(r, dread)[kk - IN] = v;
              else
                a.dtokens[bt_of(r) * IN + kk] = v;
            }
          }
      }
      if (l == 0 && t > 0) cp_async_wait<0>();
      __syncthreads();
      pr.mark(10);
    }
  }
  pr.flush(a.probe);

  for (int i = tid; i < nr * ND; i += NT) {
    const int r = i / ND, l = i - r * ND, n = l / D, d = l - n * D;
    a.dM0[(size_t)(b0 + r) * ND + l] = ROWP(r, dM)[d * Np + n];
  }
  for (int i = tid; i < nr * HN; i += NT) {
    const int r = i / HN, q = i - r * HN, h = q / N, n = q - h * N;
    a.dw0[(size_t)(b0 + r) * HN + q] = ROWP(r, dw)[h * Np + n];
  }
  for (int i = tid; i < nr * RD; i += NT) a.dread0[(size_t)b0 * RD + i] = ROWP(i / RD, dread)[i % RD];
  for (int i = tid; i < nr * LH; i += NT) {
    const int r = i / LH, q = i - r * LH, l = q / Hc, j = q - l * Hc;
    a.dc0[((size_t)l * B + b0 + r) * Hc + j] = ROWP(r, dc)[q];
    a.dh0[((size_t)l * B + b0 + r) * Hc + j] = ROWP(r, dh)[q];
  }
}

#undef ROWP

// ---- launch ---------------------------------------------------------------

template <typename Kernel>
inline int launch_tile(Kernel kernel, const PackedArgs& a, int rows, int smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (a.B + rows - 1) / rows;
  kernel<<<blocks, NT, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// This source builds three libraries (_build.py's VARIANTS), each nvcc run
// beside the others: scan_packed holds the forward's entry point,
// scan_packed_bwd (-DNTM_PACKED_BACKWARD) the backward's, and
// scan_packed_probe (-DNTM_PACKED_PROBE) both, launching the probe
// variants alone (kProbeRows rows, the forward without residuals, a.probe
// set). Each has ntm_packed_smem_bytes. A kernel is instantiated only in
// the libraries whose entry point launches it.
#ifdef NTM_PACKED_PROBE
constexpr bool kProbeBuild = true;
#define NTM_PACKED_FWD_ENTRY 1
#define NTM_PACKED_BWD_ENTRY 1
#elif defined(NTM_PACKED_BACKWARD)
constexpr bool kProbeBuild = false;
#define NTM_PACKED_FWD_ENTRY 0
#define NTM_PACKED_BWD_ENTRY 1
#else
constexpr bool kProbeBuild = false;
#define NTM_PACKED_FWD_ENTRY 1
#define NTM_PACKED_BWD_ENTRY 0
#endif

template <int RT>
inline int launch_fwd(const PackedArgs& a, bool residuals, int device, void* stream) {
  const int smem = make_packed_layout(a.dm, false, RT).total * (int)sizeof(float);
  if constexpr (kProbeBuild) {
    if constexpr (RT == kProbeRows) return launch_tile(packed_fwd_kernel<RT, false, true>, a, RT, smem, device, stream);
    return (int)cudaErrorInvalidValue;
  } else {
    return residuals ? launch_tile(packed_fwd_kernel<RT, true>, a, RT, smem, device, stream)
                     : launch_tile(packed_fwd_kernel<RT, false>, a, RT, smem, device, stream);
  }
}

template <int RT>
inline int launch_bwd(const PackedArgs& a, int device, void* stream) {
  const int smem = make_packed_layout(a.dm, true, RT).total * (int)sizeof(float);
  if constexpr (kProbeBuild) {
    if constexpr (RT == kProbeRows) return launch_tile(packed_bwd_kernel<RT, true>, a, RT, smem, device, stream);
    return (int)cudaErrorInvalidValue;
  } else {
    return launch_tile(packed_bwd_kernel<RT>, a, RT, smem, device, stream);
  }
}

inline void set_weights(PackedArgs& a, int L, const void* const* lstm_w, const void* const* lstm_b,
                        const void* heads_w, const void* heads_b, const void* out_w, const void* out_b) {
  for (int l = 0; l < MAX_LAYERS; ++l) {
    a.wt.lstm_w[l] = l < L ? (const float*)lstm_w[l] : nullptr;
    a.wt.lstm_b[l] = l < L ? (const float*)lstm_b[l] : nullptr;
  }
  a.wt.heads_w = (const float*)heads_w;
  a.wt.heads_b = (const float*)heads_b;
  a.wt.out_w = (const float*)out_w;
  a.wt.out_b = (const float*)out_b;
}

// The tile sizes instantiated: forward 1, 2, 3 and 4 rows, backward 1, 2 and 3.
inline bool fwd_rows_ok(int rows) { return rows == 1 || rows == 2 || rows == 3 || rows == 4; }
inline bool bwd_rows_ok(int rows) { return rows == 1 || rows == 2 || rows == 3; }

inline bool dims_ok(int B, int T, int N, int S, int L) {
  return L >= 1 && L <= MAX_LAYERS && B >= 1 && T >= 1 && N >= 1 && S >= 1;
}

// Dynamic shared memory of one block at `rows` rows per block, or -1 if
// the kernel is not instantiated at that tile.
extern "C" int ntm_packed_smem_bytes(int IN, int N, int D, int H, int R, int W, int S, int Hc, int L, int O,
                                     int backward, int rows) {
  if (!(backward ? bwd_rows_ok(rows) : fwd_rows_ok(rows))) return -1;
  const Dims dm{IN, N, D, H, R, W, S, Hc, L, O};
  return make_packed_layout(dm, backward != 0, rows).total * (int)sizeof(float);
}

#if NTM_PACKED_FWD_ENTRY
// The packed forward: ntm_bptt_fwd_launch's arguments (proj in place of
// the tokens); the five residual outputs are all null (no residuals) or
// all set (packed_fwd_kernel<RT, true>). probe, set in the probe build
// and only there, takes the probe variant's kProbeSlots cycle counts
// (kProbeRows rows, no residuals).
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int ntm_packed_fwd_launch(
    const void* proj, const void* const* lstm_w, const void* const* lstm_b,
    const void* heads_w, const void* heads_b, const void* out_w, const void* out_b,
    const void* M0, const void* w0, const void* read0, const void* const* c0,
    const void* const* h0, void* logits, void* M, void* w, void* read, void* c,
    void* h, void* res_M, void* res_w, void* res_read, void* res_c, void* res_h, int B,
    int T, int IN, int N, int D, int H, int R, int W, int S, int Hc, int L, int O,
    int write_first, int slotwise, int rows, void* probe, int device, void* stream) {
  const bool residuals = res_M != nullptr;
  if (!dims_ok(B, T, N, S, L) || !fwd_rows_ok(rows) || residuals != (res_w && res_read && res_c && res_h) ||
      kProbeBuild != (probe != nullptr) || (probe && (rows != kProbeRows || residuals)))
    return (int)cudaErrorInvalidValue;
  PackedArgs a = {};
  a.proj = (const float*)proj;
  set_weights(a, L, lstm_w, lstm_b, heads_w, heads_b, out_w, out_b);
  for (int l = 0; l < L; ++l) {
    a.c0[l] = (const float*)c0[l];
    a.h0[l] = (const float*)h0[l];
  }
  a.M0 = (const float*)M0;
  a.w0 = (const float*)w0;
  a.read0 = (const float*)read0;
  a.logits = (float*)logits;
  a.M = (float*)M;
  a.w = (float*)w;
  a.read = (float*)read;
  a.c = (float*)c;
  a.h = (float*)h;
  a.res_M = (float*)res_M;
  a.res_w = (float*)res_w;
  a.res_read = (float*)res_read;
  a.res_c = (float*)res_c;
  a.res_h = (float*)res_h;
  a.dm = Dims{IN, N, D, H, R, W, S, Hc, L, O};
  a.fl = Flags{write_first, slotwise, 0};
  a.B = B;
  a.T = T;
  a.probe = (long long*)probe;
  return rows == 1   ? launch_fwd<1>(a, residuals, device, stream)
         : rows == 2 ? launch_fwd<2>(a, residuals, device, stream)
         : rows == 3 ? launch_fwd<3>(a, residuals, device, stream)
                     : launch_fwd<4>(a, residuals, device, stream);
}
#endif

#if NTM_PACKED_BWD_ENTRY
// The packed backward: ntm_bptt_bwd_launch's arguments (residuals with
// the memory packed [B, T, D*N]; li's rows li_stride floats) plus the tile.
// need_dtokens = 0 skips W0[:IN]'s rows in the transposed product and
// writes no dtokens (it may then be null). probe as the forward's.
extern "C" int ntm_packed_bwd_launch(
    const void* tokens, const void* proj, const void* const* lstm_w, const void* const* lstm_b,
    const void* heads_w, const void* heads_b, const void* out_w, const void* out_b,
    const void* res_M, const void* res_w, const void* res_read, const void* res_c,
    const void* res_h, const void* dlogits, const void* dM_T, const void* dw_T,
    const void* dread_T, const void* dc_T, const void* dh_T, void* dM0, void* dw0,
    void* dread0, void* dc0, void* dh0, void* dtokens, void* li, void* dgates, void* ctrl,
    void* dctl, int B, int T, int IN, int N, int D, int H, int R, int W, int S, int Hc,
    int L, int O, int write_first, int slotwise, int need_dtokens, int rows, void* probe, int device,
    void* stream) {
  if (!dims_ok(B, T, N, S, L) || !bwd_rows_ok(rows) || (need_dtokens && !dtokens) || kProbeBuild != (probe != nullptr) ||
      (probe && rows != kProbeRows))
    return (int)cudaErrorInvalidValue;
  PackedArgs a = {};
  a.tokens = (const float*)tokens;
  a.proj = (const float*)proj;
  set_weights(a, L, lstm_w, lstm_b, heads_w, heads_b, out_w, out_b);
  a.res_M = (float*)res_M;
  a.res_w = (float*)res_w;
  a.res_read = (float*)res_read;
  a.res_c = (float*)res_c;
  a.res_h = (float*)res_h;
  a.dlogits = (const float*)dlogits;
  a.dM_T = (const float*)dM_T;
  a.dw_T = (const float*)dw_T;
  a.dread_T = (const float*)dread_T;
  a.dc_T = (const float*)dc_T;
  a.dh_T = (const float*)dh_T;
  a.dM0 = (float*)dM0;
  a.dw0 = (float*)dw0;
  a.dread0 = (float*)dread0;
  a.dc0 = (float*)dc0;
  a.dh0 = (float*)dh0;
  a.dtokens = (float*)dtokens;
  a.li = (float*)li;
  a.dgates = (float*)dgates;
  a.ctrl = (float*)ctrl;
  a.dctl = (float*)dctl;
  a.dm = Dims{IN, N, D, H, R, W, S, Hc, L, O};
  a.fl = Flags{write_first, slotwise, 0};
  a.B = B;
  a.T = T;
  a.need_dtokens = need_dtokens;
  a.probe = (long long*)probe;
  return rows == 1   ? launch_bwd<1>(a, device, stream)
         : rows == 2 ? launch_bwd<2>(a, device, stream)
                     : launch_bwd<3>(a, device, stream);
}
#endif
