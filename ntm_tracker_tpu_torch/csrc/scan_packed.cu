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
//             residuals, recomputes the step (packed_step<RT, true>) and
//             applies the VJPs of the chain, carrying dM, dw, dread, dc
//             and dh in shared memory.
//
// The layout is the TPU kernel's: each row's memory is packed d-major,
// lane l = d*N + n. The sums over n for each d (the read, the across-slot
// norms, the key and erase/add gradients) run over contiguous addresses,
// a warp per (row, d); the sums over d for each n (the slotwise norm, the
// cosine) are strided, a thread per (row, n). No 0/1 selector matrices:
// on the TPU they turned a sum into an MXU product; here a sum is a sum.
//
// What bounds it on an H100: B1 and B2 run one block per row, and every
// step re-reads the [IN+R*D+Hc, 4*Hc] LSTM kernel (2.5 MB at the flagship
// config) from L2, once per row: at B=256, 132 blocks at a time pull
// ~6 TB/s out of L2, and the aggregate L2 read rate sets the time. Here a
// block holds RT rows and reads each weight element once per step for all
// of them (tile_dot: one weight load, RT fused multiply-adds against the
// tile's inputs kept transposed [K][RT] in shared memory; two columns per
// thread, so the 800 LSTM columns take one pass of the block). The L2 traffic
// per step drops by RT and the block does RT times the arithmetic per
// byte; ceil(B/RT) blocks are used. The residuals (14.7 KB per row per
// step) and the reduction operands (~8 KB) go to HBM. RT is bounded by
// shared memory: at the flagship config a row takes 25.5 KB in the
// forward and 53.3 KB in the backward (intermediates that are cheap to
// recompute, such as the new weights, the gated weights and the new
// memory, are recomputed instead of kept), so the forward is instantiated
// at RT = 1, 4 and 8, the backward at 1, 2 and 4 (a deeper controller
// takes more per row); the wrapper's default is the largest that fits.
// RT = 1 is the control: the packed layout without the sharing.
//
// d/dgamma of w_conv^gamma is taken as 0 where w_conv == 0, as
// scan_bptt.cu does. f32 only. Plain C interface (no PyTorch headers):
// built by nvcc into a shared library and called through ctypes
// (ntm_tracker_tpu_torch/_build.py).

#include "ntm_step.cuh"

// Offsets (in floats) of one row's shared arrays; row r starts at r * row.
// The tile-shared [KIN][RT] layer input (the layer-input cotangent in the
// backward) follows the RT rows.
struct PackedLayout {
  int M, w, read, c, h, gates, ctl, mss, minv, k, kss, kinv, beta, g, gamma, sw, denom;
  int erase, add;
  int sim, tmp;  // forward: content similarity / gated weights, powed weights
  // backward: the recomputed step and the cotangents
  int cn, hn, u, wc, wconv, powed, dM, dw, dwh, du, dread, dc, dh, dctrl, dlogit, dkss, dss;
  int row, xT, total;
};

__host__ __device__ inline PackedLayout make_packed_layout(const Dims& d, bool bwd, int RT) {
  const int ND = d.N * d.D, HN = d.H * d.N, RD = d.R * d.D, LH = d.L * d.Hc;
  const int NDm = imax(d.N, d.D);
  PackedLayout s;
  int o = 0;
  s.M = take(o, ND);
  s.w = take(o, HN);
  s.read = take(o, RD);
  s.c = take(o, LH);
  s.h = take(o, LH);
  s.gates = take(o, (bwd ? d.L : 1) * 4 * d.Hc);
  s.ctl = take(o, head_width(d));  // the backward overwrites it with its cotangent
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
  s.erase = take(o, d.W * d.D);
  s.add = take(o, d.W * d.D);
  if (bwd) {
    s.sim = s.tmp = -1;
    s.cn = take(o, LH);
    s.hn = take(o, LH);
    s.u = take(o, HN);
    s.wc = take(o, HN);
    s.wconv = take(o, HN);
    s.powed = take(o, HN);
    s.dM = take(o, ND);
    s.dw = take(o, HN);
    s.dwh = take(o, HN);
    s.du = take(o, HN);
    s.dread = take(o, RD);
    s.dc = take(o, LH);
    s.dh = take(o, LH);
    s.dctrl = take(o, d.Hc);
    s.dlogit = take(o, d.O);
    s.dkss = take(o, d.H);
    s.dss = take(o, NDm);
  } else {
    s.sim = take(o, HN);
    s.tmp = take(o, HN);
    s.cn = s.hn = s.u = s.wc = s.wconv = s.powed = s.dM = s.dw = s.dwh = s.du = -1;
    s.dread = s.dc = s.dh = s.dctrl = s.dlogit = s.dkss = s.dss = -1;
  }
  s.row = (o + 3) & ~3;  // 16-byte rows
  s.xT = RT * s.row;
  s.total = s.xT + kin_max(d) * RT;
  return s;
}

struct PackedArgs {
  const float* tokens;          // [B, T, IN]
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
  float* dtokens;               // [B, T, IN]
  float* li;                    // [L, B*T, KINmax] each layer's input
  float* dgates;                // [L, B*T, 4*Hc] each layer's gate cotangents
  float* ctrl;                  // [B*T, Hc] the controller output
  float* dctl;                  // [B*T, P+O] the head-control cotangents, then the logits'
  Dims dm;
  Flags fl;
  int B, T;
};

#define ROWP(r, f) (smem + (r) * lay.row + lay.f)

// acc[r] = sum_j g_r[j] * Wrow[j] over j < ncol (a transposed product: a
// warp per weight row, lanes over j), summed across the warp; g_r is row
// r's shared array at g + r * row.
template <int RT>
__device__ __forceinline__ void tile_dot_t(const float* __restrict__ Wrow, int ncol, const float* g, int row,
                                           float (&acc)[RT]) {
  const int lane = threadIdx.x & 31;
  for (int j = lane; j < ncol; j += 32) {
    const float wv = __ldg(Wrow + j);
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r] = fmaf(g[r * row + j], wv, acc[r]);
  }
#pragma unroll
  for (int r = 0; r < RT; ++r) acc[r] = warp_sum(acc[r]);
}

// One cell step of the tile's nr live rows (rows b0 .. b0+nr-1). The
// forward (kBwd = false) updates the state in place and writes the
// logits. The backward's recompute (kBwd = true) keeps the input state
// and every intermediate its VJPs read, writes the weight-gradient
// operands li and ctrl, and skips the write, the read and the logits,
// which the backward does not need. Enters after a __syncthreads() that
// published the state; returns after one.
template <int RT, bool kBwd>
__device__ void packed_step(const PackedArgs& a, float* smem, const PackedLayout& lay, int b0, int nr, int t) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Dims& dm = a.dm;
  const int IN = dm.IN, N = dm.N, D = dm.D, H = dm.H, R = dm.R, W = dm.W, S = dm.S;
  const int Hc = dm.Hc, L = dm.L, O = dm.O, B = a.B, T = a.T;
  const int ND = N * D, HN = H * N, RD = R * D, HD = H * D, WD = W * D;
  const int P = head_width(dm), KM = kin_max(dm);
  const int oBeta = HD, oG = oBeta + H, oSw = oG + H, oGamma = oSw + S * H;
  const int oErase = oGamma + H, oAdd = oErase + WD;
  const int shift0 = -((S + 1) / 2);
  const bool slotwise = a.fl.slotwise != 0;
  float* xT = smem + lay.xT;

  // ---- stacked LSTM controller; layer 0's input [x | read | h_0] ----------
  const int K0 = IN + RD + Hc;
  for (int i = tid; i < nr * K0; i += NT) {
    const int r = i / K0, k = i - r * K0;
    const size_t bt = (size_t)(b0 + r) * T + t;
    float v;
    if (k < IN)
      v = a.tokens[bt * IN + k];
    else if (k < IN + RD)
      v = ROWP(r, read)[k - IN];
    else
      v = ROWP(r, h)[k - IN - RD];
    xT[k * RT + r] = v;
    if (kBwd) a.li[bt * KM + k] = v;
  }
  __syncthreads();
  for (int l = 0; l < L; ++l) {
    const int K = (l == 0 ? IN + RD : Hc) + Hc;
    const int go = kBwd ? l * 4 * Hc : 0;
    for (int j0 = tid; j0 < 4 * Hc; j0 += 2 * NT) {
      float acc[2][RT];
      tile_dot<RT, 2>(a.wt.lstm_w[l], 4 * Hc, j0, 4 * Hc, xT, K, acc);
      for (int c = 0; c < 2; ++c) {
        const int j = j0 + c * NT;
        if (j >= 4 * Hc) break;
        const float bj = __ldg(a.wt.lstm_b[l] + j);
        for (int r = 0; r < nr; ++r) ROWP(r, gates)[go + j] = acc[c][r] + bj;
      }
    }
    __syncthreads();
    for (int i = tid; i < nr * Hc; i += NT) {
      const int r = i / Hc, j = i - r * Hc;
      const float* gl = ROWP(r, gates) + go;
      const float c_new = ROWP(r, c)[l * Hc + j] * sigmoid_f(gl[2 * Hc + j]) + sigmoid_f(gl[j]) * tanhf(gl[Hc + j]);
      const float h_new = tanhf(c_new) * sigmoid_f(gl[3 * Hc + j]);
      if (l + 1 < L) {
        const float h_next = ROWP(r, h)[(l + 1) * Hc + j];
        xT[j * RT + r] = h_new;
        xT[(Hc + j) * RT + r] = h_next;
        if (kBwd) {
          float* li = a.li + ((size_t)(l + 1) * B * T + (size_t)(b0 + r) * T + t) * KM;
          li[j] = h_new;
          li[Hc + j] = h_next;
        }
      }
      if (kBwd) {
        ROWP(r, cn)[l * Hc + j] = c_new;
        ROWP(r, hn)[l * Hc + j] = h_new;
      } else {
        ROWP(r, c)[l * Hc + j] = c_new;
        ROWP(r, h)[l * Hc + j] = h_new;
      }
    }
    __syncthreads();
  }

  // ---- head controls (and, in the forward, the output linear) -------------
  const int hoff = (L - 1) * Hc;
  for (int i = tid; i < nr * Hc; i += NT) {
    const int r = i / Hc, k = i - r * Hc;
    const float v = kBwd ? ROWP(r, hn)[hoff + k] : ROWP(r, h)[hoff + k];
    xT[k * RT + r] = v;
    if (kBwd) a.ctrl[((size_t)(b0 + r) * T + t) * Hc + k] = v;
  }
  __syncthreads();
  for (int j = tid; j < (kBwd ? P : P + O); j += NT) {
    float acc[1][RT];
    if (j < P) {
      tile_dot<RT, 1>(a.wt.heads_w, P, j, P, xT, Hc, acc);
      const float bj = __ldg(a.wt.heads_b + j);
      for (int r = 0; r < nr; ++r) ROWP(r, ctl)[j] = acc[0][r] + bj;
    } else {
      const int o = j - P;
      tile_dot<RT, 1>(a.wt.out_w, O, o, O, xT, Hc, acc);
      const float bo = __ldg(a.wt.out_b + o);
      for (int r = 0; r < nr; ++r) a.logits[((size_t)(b0 + r) * T + t) * O + o] = acc[0][r] + bo;
    }
  }
  __syncthreads();

  // ---- squashed head parameters and the memory normalizer ----------------
  for (int i = tid; i < nr * HD; i += NT) {
    const int r = i / HD, q = i - r * HD;
    ROWP(r, k)[q] = tanhf(ROWP(r, ctl)[q]);
  }
  for (int i = tid; i < nr * WD; i += NT) {
    const int r = i / WD, q = i - r * WD;
    ROWP(r, erase)[q] = sigmoid_f(ROWP(r, ctl)[oErase + q]);
    ROWP(r, add)[q] = tanhf(ROWP(r, ctl)[oAdd + q]);
  }
  for (int i = tid; i < nr * H; i += NT) {
    const int r = i / H, hh = i - r * H;
    const float* ctl = ROWP(r, ctl);
    ROWP(r, beta)[hh] = softplus_f(ctl[oBeta + hh]);
    ROWP(r, g)[hh] = sigmoid_f(ctl[oG + hh]);
    ROWP(r, gamma)[hh] = softplus_f(ctl[oGamma + hh]) + 1.f;
    const float* s_raw = ctl + oSw + hh * S;
    float mx = s_raw[0];
    for (int j = 1; j < S; ++j) mx = fmaxf(mx, s_raw[j]);
    float tot = 0.f;
    for (int j = 0; j < S; ++j) tot += expf(s_raw[j] - mx);
    for (int j = 0; j < S; ++j) ROWP(r, sw)[hh * S + j] = expf(s_raw[j] - mx) / tot;
  }
  if (slotwise) {
    // rsqrt(max(sum_d M[d, n]^2, 1e-12)) per slot: strided over d
    for (int i = tid; i < nr * N; i += NT) {
      const int r = i / N, n = i - r * N;
      const float* Mr = ROWP(r, M);
      float sq = 0.f;
      for (int d = 0; d < D; ++d) sq = fmaf(Mr[d * N + n], Mr[d * N + n], sq);
      ROWP(r, mss)[n] = sq;
      ROWP(r, minv)[n] = rsqrtf(fmaxf(sq, 1e-12f));
    }
  } else {
    // the executed reference: each mem_dim row normalized across slots,
    // a contiguous sum over n
    for (int q = warp; q < nr * D; q += NWARPS) {
      const int r = q / D, d = q - r * D;
      const float* Md = ROWP(r, M) + d * N;
      float sq = 0.f;
      for (int n = lane; n < N; n += 32) sq = fmaf(Md[n], Md[n], sq);
      sq = warp_sum(sq);
      if (lane == 0) {
        ROWP(r, mss)[d] = sq;
        ROWP(r, minv)[d] = rsqrtf(fmaxf(sq, 1e-12f));
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < nr * H; i += NT) {
    const int r = i / H, hh = i - r * H;
    const float* kr = ROWP(r, k) + hh * D;
    float sq = 0.f;
    for (int d = 0; d < D; ++d) sq = fmaf(kr[d], kr[d], sq);
    ROWP(r, kss)[hh] = sq;
    ROWP(r, kinv)[hh] = rsqrtf(fmaxf(sq, 1e-12f));
  }
  __syncthreads();

  // ---- content similarity: u[h, n] = sum_d k[h, d] * Mtn[d, n] ------------
  for (int i = tid; i < nr * HN; i += NT) {
    const int r = i / HN, q = i - r * HN, hh = q / N, n = q - hh * N;
    const float* Mr = ROWP(r, M);
    const float* kr = ROWP(r, k) + hh * D;
    const float* mi = ROWP(r, minv);
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc = fmaf(kr[d], Mr[d * N + n] * (slotwise ? mi[n] : mi[d]), acc);
    if (kBwd)
      ROWP(r, u)[q] = acc;
    else
      ROWP(r, sim)[q] = acc * ROWP(r, kinv)[hh];
  }
  __syncthreads();

  // ---- softmax, gate, shift and sharpen: a warp per (row, head) -----------
  for (int q = warp; q < nr * H; q += NWARPS) {
    const int r = q / H, hh = q - r * H, o = hh * N;
    const float bt = ROWP(r, beta)[hh], gt = ROWP(r, g)[hh], ki = ROWP(r, kinv)[hh];
    const float* wp = ROWP(r, w) + o;
    const float* ur = kBwd ? ROWP(r, u) + o : nullptr;
    float* simr = kBwd ? nullptr : ROWP(r, sim) + o;
    // the gated weights: in place over sim in the forward, in du (free
    // until the backward's head phase) in the recompute
    float* wgr = kBwd ? ROWP(r, du) + o : simr;
    float mx = __int_as_float(0xff800000);  // -inf
    for (int n = lane; n < N; n += 32) mx = fmaxf(mx, (kBwd ? ur[n] * ki : simr[n]) * bt);
    mx = warp_max(mx);
    float tot = 0.f;
    for (int n = lane; n < N; n += 32) tot += expf((kBwd ? ur[n] * ki : simr[n]) * bt - mx);
    tot = warp_sum(tot);
    for (int n = lane; n < N; n += 32) {
      const float wcv = expf((kBwd ? ur[n] * ki : simr[n]) * bt - mx) / tot;
      if (kBwd) ROWP(r, wc)[o + n] = wcv;
      wgr[n] = wcv * gt + wp[n] * (1.f - gt);
    }
    __syncwarp();
    const float gm = ROWP(r, gamma)[hh];
    const float* swr = ROWP(r, sw) + hh * S;
    float* pw = kBwd ? ROWP(r, powed) + o : ROWP(r, tmp) + o;
    float s = 0.f;
    for (int n = lane; n < N; n += 32) {
      float conv = 0.f;
      for (int j = 0; j < S; ++j) conv = fmaf(swr[j], wgr[wrap(n + shift0 + j, N)], conv);
      const float p = powf(conv, gm);
      if (kBwd) ROWP(r, wconv)[o + n] = conv;
      pw[n] = p;
      s += p;
    }
    s = warp_sum(s) + 1e-3f;
    if (lane == 0) ROWP(r, denom)[hh] = s;
    if (!kBwd)
      for (int n = lane; n < N; n += 32) ROWP(r, w)[o + n] = pw[n] / s;
  }
  __syncthreads();

  // ---- read (before or after the write) and the erase/add write -----------
  if constexpr (!kBwd) for (int pass = 0; pass < 2; ++pass) {
    const bool do_read = (pass == 0) != (a.fl.write_first != 0);
    if (do_read) {
      for (int q = warp; q < nr * RD; q += NWARPS) {
        const int r = q / RD, p = q - r * RD, rh = p / D, d = p - rh * D;
        const float* wr = ROWP(r, w) + rh * N;
        const float* Md = ROWP(r, M) + d * N;
        float acc = 0.f;
        for (int n = lane; n < N; n += 32) acc = fmaf(wr[n], Md[n], acc);
        acc = warp_sum(acc);
        if (lane == 0) ROWP(r, read)[p] = acc;
      }
    } else {
      for (int i = tid; i < nr * ND; i += NT) {
        const int r = i / ND, l = i - r * ND, d = l / N, n = l - d * N;
        const float* wr = ROWP(r, w) + R * N;
        float er = 1.f, ad = 0.f;
        for (int wh = 0; wh < W; ++wh) {
          const float ww = wr[wh * N + n];
          er *= 1.f - ww * ROWP(r, erase)[wh * D + d];
          ad = fmaf(ww, ROWP(r, add)[wh * D + d], ad);
        }
        float* Mr = ROWP(r, M);
        Mr[l] = Mr[l] * er + ad;
      }
    }
    __syncthreads();
  }
}

// T cell steps of the rows blockIdx.x*RT .. +RT-1 (the last tile masked to
// B) with the state resident in shared memory. kResiduals also streams
// each step's input state, memory packed, to global memory.
template <int RT, bool kResiduals>
__global__ void __launch_bounds__(NT, 1) packed_fwd_kernel(const PackedArgs a) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const Dims dm = a.dm;
  const int N = dm.N, D = dm.D, H = dm.H, Hc = dm.Hc, L = dm.L, T = a.T, B = a.B;
  const int ND = N * D, HN = H * N, RD = dm.R * D, LH = L * Hc;
  const PackedLayout lay = make_packed_layout(dm, false, RT);
  const int b0 = blockIdx.x * RT, nr = min(RT, B - b0);

  // rows past B stay zero: the tile products read their (zero) inputs
  for (int i = tid; i < lay.total; i += NT) smem[i] = 0.f;
  __syncthreads();
  for (int i = tid; i < nr * ND; i += NT) {
    const int r = i / ND, l = i - r * ND, n = l / D, d = l - n * D;
    ROWP(r, M)[d * N + n] = a.M0[(size_t)(b0 + r) * ND + l];
  }
  for (int i = tid; i < nr * HN; i += NT) ROWP(i / HN, w)[i % HN] = a.w0[(size_t)b0 * HN + i];
  for (int i = tid; i < nr * RD; i += NT) ROWP(i / RD, read)[i % RD] = a.read0[(size_t)b0 * RD + i];
  for (int i = tid; i < nr * LH; i += NT) {
    const int r = i / LH, q = i - r * LH, l = q / Hc, j = q - l * Hc;
    ROWP(r, c)[q] = a.c0[l][(size_t)(b0 + r) * Hc + j];
    ROWP(r, h)[q] = a.h0[l][(size_t)(b0 + r) * Hc + j];
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    if (kResiduals) {
      // the step's input state; the step overwrites these arrays only
      // after its first two barriers
      for (int i = tid; i < nr * ND; i += NT) {
        const int r = i / ND, l = i - r * ND;
        a.res_M[((size_t)(b0 + r) * T + t) * ND + l] = ROWP(r, M)[l];
      }
      for (int i = tid; i < nr * HN; i += NT) {
        const int r = i / HN, q = i - r * HN;
        a.res_w[((size_t)(b0 + r) * T + t) * HN + q] = ROWP(r, w)[q];
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
    packed_step<RT, false>(a, smem, lay, b0, nr, t);
  }

  for (int i = tid; i < nr * ND; i += NT) {
    const int r = i / ND, l = i - r * ND, n = l / D, d = l - n * D;
    a.M[(size_t)(b0 + r) * ND + l] = ROWP(r, M)[d * N + n];
  }
  for (int i = tid; i < nr * HN; i += NT) a.w[(size_t)b0 * HN + i] = ROWP(i / HN, w)[i % HN];
  for (int i = tid; i < nr * RD; i += NT) a.read[(size_t)b0 * RD + i] = ROWP(i / RD, read)[i % RD];
  for (int i = tid; i < nr * LH; i += NT) {
    const int r = i / LH, q = i - r * LH, l = q / Hc, j = q - l * Hc;
    a.c[((size_t)l * B + b0 + r) * Hc + j] = ROWP(r, c)[q];
    a.h[((size_t)l * B + b0 + r) * Hc + j] = ROWP(r, h)[q];
  }
}

// The reverse-time walk of RT rows per block: the VJPs of
// scan_bptt.cu's ntm_bptt_bwd_kernel on the packed layout, over the tile.
template <int RT>
__global__ void __launch_bounds__(NT, 1) packed_bwd_kernel(const PackedArgs a) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Dims dm = a.dm;
  const int IN = dm.IN, N = dm.N, D = dm.D, H = dm.H, R = dm.R, W = dm.W, S = dm.S;
  const int Hc = dm.Hc, L = dm.L, O = dm.O, T = a.T, B = a.B;
  const int ND = N * D, HN = H * N, RD = R * D, LH = L * Hc, HD = H * D, WD = W * D;
  const int P = head_width(dm);
  const int oBeta = HD, oG = oBeta + H, oSw = oG + H, oGamma = oSw + S * H;
  const int oErase = oGamma + H, oAdd = oErase + WD;
  const int shift0 = -((S + 1) / 2);
  const bool wf = a.fl.write_first != 0, slotwise = a.fl.slotwise != 0;
  const PackedLayout lay = make_packed_layout(dm, true, RT);
  const int b0 = blockIdx.x * RT, nr = min(RT, B - b0);
  float* xT = smem + lay.xT;

  // the step's new weights, recomputed from the kept sharpen terms
  auto wnew = [&](int r, int hh, int n) { return ROWP(r, powed)[hh * N + n] / ROWP(r, denom)[hh]; };
  // d read-source [d, n] = sum_r dread[r, d] * w_r[n]
  auto dsrc = [&](int r, int d, int n) {
    float acc = 0.f;
    for (int rh = 0; rh < R; ++rh) acc = fmaf(ROWP(r, dread)[rh * D + d], wnew(r, rh, n), acc);
    return acc;
  };
  // d Mtn [d, n] = sum_h du[h, n] * k[h, d]
  auto dmtn = [&](int r, int d, int n) {
    float acc = 0.f;
    for (int hh = 0; hh < H; ++hh) acc = fmaf(ROWP(r, du)[hh * N + n], ROWP(r, k)[hh * D + d], acc);
    return acc;
  };
  // the erase factor prod_wh (1 - w_wh[n] * e_wh[d]), without head `skip`
  auto erase_prod = [&](int r, int d, int n, int skip) {
    float er = 1.f;
    for (int wh = 0; wh < W; ++wh)
      if (wh != skip) er *= 1.f - wnew(r, R + wh, n) * ROWP(r, erase)[wh * D + d];
    return er;
  };

  for (int i = tid; i < lay.total; i += NT) smem[i] = 0.f;
  __syncthreads();
  for (int i = tid; i < nr * ND; i += NT) {
    const int r = i / ND, l = i - r * ND, n = l / D, d = l - n * D;
    ROWP(r, dM)[d * N + n] = a.dM_T[(size_t)(b0 + r) * ND + l];
  }
  for (int i = tid; i < nr * HN; i += NT) ROWP(i / HN, dw)[i % HN] = a.dw_T[(size_t)b0 * HN + i];
  for (int i = tid; i < nr * RD; i += NT) ROWP(i / RD, dread)[i % RD] = a.dread_T[(size_t)b0 * RD + i];
  for (int i = tid; i < nr * LH; i += NT) {
    const int r = i / LH, q = i - r * LH, l = q / Hc, j = q - l * Hc;
    ROWP(r, dc)[q] = a.dc_T[((size_t)l * B + b0 + r) * Hc + j];
    ROWP(r, dh)[q] = a.dh_T[((size_t)l * B + b0 + r) * Hc + j];
  }

  for (int t = T - 1; t >= 0; --t) {
    // ---- recompute the step from its residual input state ----------------
    for (int i = tid; i < nr * ND; i += NT) {
      const int r = i / ND, l = i - r * ND;
      ROWP(r, M)[l] = a.res_M[((size_t)(b0 + r) * T + t) * ND + l];
    }
    for (int i = tid; i < nr * HN; i += NT) {
      const int r = i / HN, q = i - r * HN;
      ROWP(r, w)[q] = a.res_w[((size_t)(b0 + r) * T + t) * HN + q];
    }
    for (int i = tid; i < nr * RD; i += NT) {
      const int r = i / RD, q = i - r * RD;
      ROWP(r, read)[q] = a.res_read[((size_t)(b0 + r) * T + t) * RD + q];
    }
    for (int i = tid; i < nr * LH; i += NT) {
      const int r = i / LH, q = i - r * LH;
      ROWP(r, c)[q] = a.res_c[((size_t)(b0 + r) * T + t) * LH + q];
      ROWP(r, h)[q] = a.res_h[((size_t)(b0 + r) * T + t) * LH + q];
    }
    for (int i = tid; i < nr * O; i += NT) {
      const int r = i / O, o = i - r * O;
      ROWP(r, dlogit)[o] = a.dlogits[((size_t)(b0 + r) * T + t) * O + o];
    }
    __syncthreads();
    packed_step<RT, true>(a, smem, lay, b0, nr, t);

    // ---- read: read[r, d] = sum_n w_r[n] * src[d, n] ------------------------
    for (int i = tid; i < nr * HN; i += NT) {
      const int r = i / HN, q = i - r * HN, hh = q / N, n = q - hh * N;
      float acc = ROWP(r, dw)[q];
      if (hh < R) {
        const float* Mr = ROWP(r, M);
        for (int d = 0; d < D; ++d) {
          float src = Mr[d * N + n];
          if (wf) {
            float er = 1.f, ad = 0.f;
            for (int wh = 0; wh < W; ++wh) {
              const float ww = wnew(r, R + wh, n);
              er *= 1.f - ww * ROWP(r, erase)[wh * D + d];
              ad = fmaf(ww, ROWP(r, add)[wh * D + d], ad);
            }
            src = src * er + ad;
          }
          acc = fmaf(ROWP(r, dread)[hh * D + d], src, acc);
        }
      }
      ROWP(r, dwh)[q] = acc;
    }
    if (wf) {
      // the read source is the new memory: its cotangent joins d M_new
      for (int i = tid; i < nr * ND; i += NT) {
        const int r = i / ND, l = i - r * ND, d = l / N, n = l - d * N;
        ROWP(r, dM)[l] += dsrc(r, d, n);
      }
    }
    __syncthreads();

    // ---- erase/add: M_new = M_prev * er + ad (dM now holds d M_new) --------
    for (int i = tid; i < nr * W * N; i += NT) {
      const int r = i / (W * N), q = i - r * W * N, wh = q / N, n = q - wh * N;
      const float* Mr = ROWP(r, M);
      const float* dMr = ROWP(r, dM);
      float acc = ROWP(r, dwh)[(R + wh) * N + n];
      for (int d = 0; d < D; ++d) {
        const float dfac = dMr[d * N + n] * Mr[d * N + n] * erase_prod(r, d, n, wh);
        acc = acc - dfac * ROWP(r, erase)[wh * D + d] + dMr[d * N + n] * ROWP(r, add)[wh * D + d];
      }
      ROWP(r, dwh)[(R + wh) * N + n] = acc;
    }
    for (int q = warp; q < nr * WD; q += NWARPS) {
      const int r = q / WD, p = q - r * WD, wh = p / D, d = p - wh * D;
      const float* Md = ROWP(r, M) + d * N;
      const float* dMd = ROWP(r, dM) + d * N;
      float de = 0.f, da = 0.f;
      for (int n = lane; n < N; n += 32) {
        const float ww = wnew(r, R + wh, n);
        de -= dMd[n] * Md[n] * erase_prod(r, d, n, wh) * ww;
        da = fmaf(dMd[n], ww, da);
      }
      de = warp_sum(de);
      da = warp_sum(da);
      if (lane == 0) {
        const float e = ROWP(r, erase)[p], ad = ROWP(r, add)[p];
        ROWP(r, ctl)[oErase + p] = de * e * (1.f - e);
        ROWP(r, ctl)[oAdd + p] = da * (1.f - ad * ad);
      }
    }
    __syncthreads();

    // ---- per-head addressing: a warp per (row, head) ----------------------
    for (int q = warp; q < nr * H; q += NWARPS) {
      const int r = q / H, hh = q - r * H, o = hh * N;
      float* dctl = ROWP(r, ctl);  // the head-control cotangent, over the raw controls
      float* dwh = ROWP(r, dwh) + o;
      float* du = ROWP(r, du) + o;
      float* dw = ROWP(r, dw) + o;
      const float* pw = ROWP(r, powed) + o;
      const float* wconv = ROWP(r, wconv) + o;
      const float* wc = ROWP(r, wc) + o;
      const float* wp = ROWP(r, w) + o;
      const float* ur = ROWP(r, u) + o;
      const float* swr = ROWP(r, sw) + hh * S;
      const float gam = ROWP(r, gamma)[hh], inv_den = 1.f / ROWP(r, denom)[hh];
      // sharpen: w = p / (sum p + 1e-3), p = w_conv ^ gamma; d w_conv over dwh
      float s1 = 0.f;
      for (int n = lane; n < N; n += 32) s1 = fmaf(dwh[n], pw[n], s1);
      s1 = warp_sum(s1);
      float dgam = 0.f;
      for (int n = lane; n < N; n += 32) {
        const float dp = dwh[n] * inv_den - s1 * inv_den * inv_den;
        const float wcv = wconv[n];
        dwh[n] = dp * gam * powf(wcv, gam - 1.f);
        if (wcv > 0.f) dgam += dp * pw[n] * logf(wcv);
      }
      dgam = warp_sum(dgam);
      __syncwarp();
      // circular shift: w_conv[n] = sum_j sw_j * w_g[n + s_j]
      const float gt = ROWP(r, g)[hh];
      float dot_sw = 0.f;
      for (int j = 0; j < S; ++j) {
        const int s = shift0 + j;
        float acc = 0.f;
        for (int n = lane; n < N; n += 32) {
          const int m = wrap(n + s, N);
          acc = fmaf(dwh[n], wc[m] * gt + wp[m] * (1.f - gt), acc);
        }
        acc = warp_sum(acc);
        dot_sw = fmaf(acc, swr[j], dot_sw);
        if (lane == 0) dctl[oSw + hh * S + j] = acc;  // d sw_j, finished below
      }
      // gate: w_g = w_c * g + w_prev * (1 - g)
      float dg = 0.f, cdot = 0.f;
      for (int n = lane; n < N; n += 32) {
        float dwg = 0.f;
        for (int j = 0; j < S; ++j) dwg = fmaf(swr[j], dwh[wrap(n - (shift0 + j), N)], dwg);
        const float dwc = dwg * gt;
        dw[n] = dwg * (1.f - gt);  // the carry to the step before
        dg = fmaf(dwg, wc[n] - wp[n], dg);
        cdot = fmaf(dwc, wc[n], cdot);
        du[n] = dwc;
      }
      dg = warp_sum(dg);
      cdot = warp_sum(cdot);
      // content softmax w_c = softmax(sim * beta), sim = u * kinv
      const float bt = ROWP(r, beta)[hh], ki = ROWP(r, kinv)[hh];
      float dbeta = 0.f, dki = 0.f;
      for (int n = lane; n < N; n += 32) {
        const float ds = (du[n] - cdot) * wc[n];
        const float dsim = ds * bt;
        dbeta = fmaf(ds, ur[n] * ki, dbeta);
        dki = fmaf(dsim, ur[n], dki);
        du[n] = dsim * ki;
      }
      dbeta = warp_sum(dbeta);
      dki = warp_sum(dki);
      if (lane == 0) {
        ROWP(r, dkss)[hh] = ROWP(r, kss)[hh] > 1e-12f ? dki * -0.5f * ki * ki * ki : 0.f;
        for (int j = 0; j < S; ++j) dctl[oSw + hh * S + j] = (dctl[oSw + hh * S + j] - dot_sw) * swr[j];
        dctl[oBeta + hh] = dbeta * sigmoid_f(dctl[oBeta + hh]);
        dctl[oG + hh] = dg * gt * (1.f - gt);
        dctl[oGamma + hh] = dgam * sigmoid_f(dctl[oGamma + hh]);
      }
    }
    __syncthreads();

    // ---- keys (u[h, n] = sum_d k[h, d] Mtn[d, n]) and the normalizer -------
    for (int q = warp; q < nr * HD; q += NWARPS) {
      const int r = q / HD, p = q - r * HD, hh = p / D, d = p - hh * D;
      const float* dur = ROWP(r, du) + hh * N;
      const float* Md = ROWP(r, M) + d * N;
      const float* mi = ROWP(r, minv);
      float acc = 0.f;
      for (int n = lane; n < N; n += 32) acc = fmaf(dur[n], Md[n] * (slotwise ? mi[n] : mi[d]), acc);
      acc = warp_sum(acc);
      if (lane == 0) {
        const float kv = ROWP(r, k)[p];
        ROWP(r, ctl)[p] = (acc + 2.f * kv * ROWP(r, dkss)[hh]) * (1.f - kv * kv);
      }
    }
    if (slotwise) {
      for (int i = tid; i < nr * N; i += NT) {
        const int r = i / N, n = i - r * N;
        const float* Mr = ROWP(r, M);
        float acc = 0.f;
        for (int d = 0; d < D; ++d) acc = fmaf(dmtn(r, d, n), Mr[d * N + n], acc);
        const float mi = ROWP(r, minv)[n];
        ROWP(r, dss)[n] = ROWP(r, mss)[n] > 1e-12f ? acc * -0.5f * mi * mi * mi : 0.f;
      }
    } else {
      for (int q = warp; q < nr * D; q += NWARPS) {
        const int r = q / D, d = q - r * D;
        const float* Md = ROWP(r, M) + d * N;
        float acc = 0.f;
        for (int n = lane; n < N; n += 32) acc = fmaf(dmtn(r, d, n), Md[n], acc);
        acc = warp_sum(acc);
        const float mi = ROWP(r, minv)[d];
        if (lane == 0) ROWP(r, dss)[d] = ROWP(r, mss)[d] > 1e-12f ? acc * -0.5f * mi * mi * mi : 0.f;
      }
    }
    __syncthreads();

    // ---- d M_prev (the carry), and the head and output linears -------------
    for (int i = tid; i < nr * ND; i += NT) {
      const int r = i / ND, l = i - r * ND, d = l / N, n = l - d * N;
      const int j = slotwise ? n : d;
      float* dMr = ROWP(r, dM);
      const float from_read = wf ? 0.f : dsrc(r, d, n);
      dMr[l] = from_read + dMr[l] * erase_prod(r, d, n, -1) + dmtn(r, d, n) * ROWP(r, minv)[j] +
               2.f * ROWP(r, M)[l] * ROWP(r, dss)[j];
    }
    for (int i = tid; i < nr * (P + O); i += NT) {
      const int r = i / (P + O), q = i - r * (P + O);
      a.dctl[((size_t)(b0 + r) * T + t) * (P + O) + q] = q < P ? ROWP(r, ctl)[q] : ROWP(r, dlogit)[q - P];
    }
    for (int k = warp; k < Hc; k += NWARPS) {
      float acc[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r] = 0.f;
      // rows past nr hold zero cotangents
      const float* hw = a.wt.heads_w + (size_t)k * P;
      const float* ow = a.wt.out_w + (size_t)k * O;
      for (int j = lane; j < P; j += 32) {
        const float wv = __ldg(hw + j);
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] = fmaf(ROWP(r, ctl)[j], wv, acc[r]);
      }
      for (int o = lane; o < O; o += 32) {
        const float wv = __ldg(ow + o);
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] = fmaf(ROWP(r, dlogit)[o], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r] = warp_sum(acc[r]);
      if (lane == 0)
        for (int r = 0; r < nr; ++r) ROWP(r, dctrl)[k] = acc[r];
    }
    __syncthreads();

    // ---- stacked LSTM, top layer first ---------------------------------------
    for (int l = L - 1; l >= 0; --l) {
      const int go = l * 4 * Hc, in_l = l == 0 ? IN + RD : Hc, K = in_l + Hc;
      for (int i = tid; i < nr * Hc; i += NT) {
        const int r = i / Hc, j = i - r * Hc;
        float* gl = ROWP(r, gates) + go;  // the gate cotangents overwrite the gates
        const float si = sigmoid_f(gl[j]), tj = tanhf(gl[Hc + j]);
        const float sf = sigmoid_f(gl[2 * Hc + j]), so = sigmoid_f(gl[3 * Hc + j]);
        const float tc = tanhf(ROWP(r, cn)[l * Hc + j]);
        const float dnh = ROWP(r, dctrl)[j] + ROWP(r, dh)[l * Hc + j];
        const float dnc = ROWP(r, dc)[l * Hc + j] + dnh * so * (1.f - tc * tc);
        gl[j] = dnc * tj * si * (1.f - si);
        gl[Hc + j] = dnc * si * (1.f - tj * tj);
        gl[2 * Hc + j] = dnc * ROWP(r, c)[l * Hc + j] * sf * (1.f - sf);
        gl[3 * Hc + j] = dnh * tc * so * (1.f - so);
        ROWP(r, dc)[l * Hc + j] = dnc * sf;  // the carry
      }
      __syncthreads();
      for (int i = tid; i < nr * 4 * Hc; i += NT) {
        const int r = i / (4 * Hc), j = i - r * 4 * Hc;
        a.dgates[((size_t)l * B * T + (size_t)(b0 + r) * T + t) * 4 * Hc + j] = ROWP(r, gates)[go + j];
      }
      // d layer input = W_l @ dgates (a warp per input row), into xT
      for (int k = warp; k < K; k += NWARPS) {
        float acc[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] = 0.f;
        tile_dot_t<RT>(a.wt.lstm_w[l] + (size_t)k * 4 * Hc, 4 * Hc, smem + lay.gates + go, lay.row, acc);
        if (lane == 0)
          for (int r = 0; r < nr; ++r) xT[k * RT + r] = acc[r];
      }
      __syncthreads();
      for (int i = tid; i < nr * Hc; i += NT) {
        const int r = i / Hc, j = i - r * Hc;
        ROWP(r, dh)[l * Hc + j] = xT[(in_l + j) * RT + r];  // the carry
        if (l > 0) ROWP(r, dctrl)[j] = xT[j * RT + r];
      }
      if (l == 0) {
        for (int i = tid; i < nr * IN; i += NT) {
          const int r = i / IN, k = i - r * IN;
          a.dtokens[((size_t)(b0 + r) * T + t) * IN + k] = xT[k * RT + r];
        }
        for (int i = tid; i < nr * RD; i += NT) {
          const int r = i / RD, p = i - r * RD;
          ROWP(r, dread)[p] = xT[(IN + p) * RT + r];  // the carry
        }
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < nr * ND; i += NT) {
    const int r = i / ND, l = i - r * ND, n = l / D, d = l - n * D;
    a.dM0[(size_t)(b0 + r) * ND + l] = ROWP(r, dM)[d * N + n];
  }
  for (int i = tid; i < nr * HN; i += NT) a.dw0[(size_t)b0 * HN + i] = ROWP(i / HN, dw)[i % HN];
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

template <int RT>
inline int launch_fwd(const PackedArgs& a, bool residuals, int device, void* stream) {
  const int smem = make_packed_layout(a.dm, false, RT).total * (int)sizeof(float);
  return residuals ? launch_tile(packed_fwd_kernel<RT, true>, a, RT, smem, device, stream)
                   : launch_tile(packed_fwd_kernel<RT, false>, a, RT, smem, device, stream);
}

template <int RT>
inline int launch_bwd(const PackedArgs& a, int device, void* stream) {
  const int smem = make_packed_layout(a.dm, true, RT).total * (int)sizeof(float);
  return launch_tile(packed_bwd_kernel<RT>, a, RT, smem, device, stream);
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

// The tile sizes instantiated: forward 1, 4 and 8 rows, backward 1, 2 and 4.
inline bool fwd_rows_ok(int rows) { return rows == 1 || rows == 4 || rows == 8; }
inline bool bwd_rows_ok(int rows) { return rows == 1 || rows == 2 || rows == 4; }

// Dynamic shared memory of one block at `rows` rows per block, or -1 if
// the kernel is not instantiated at that tile.
extern "C" int ntm_packed_smem_bytes(int IN, int N, int D, int H, int R, int W, int S, int Hc, int L, int O,
                                     int backward, int rows) {
  if (!(backward ? bwd_rows_ok(rows) : fwd_rows_ok(rows))) return -1;
  const Dims dm{IN, N, D, H, R, W, S, Hc, L, O};
  return make_packed_layout(dm, backward != 0, rows).total * (int)sizeof(float);
}

// The packed forward: ntm_bptt_fwd_launch's arguments; the five residual
// outputs are all null (no residuals) or all set (packed_fwd_kernel<RT,
// true>). Returns the CUDA error code of the launch (0 = launched).
extern "C" int ntm_packed_fwd_launch(
    const void* tokens, const void* const* lstm_w, const void* const* lstm_b,
    const void* heads_w, const void* heads_b, const void* out_w, const void* out_b,
    const void* M0, const void* w0, const void* read0, const void* const* c0,
    const void* const* h0, void* logits, void* M, void* w, void* read, void* c,
    void* h, void* res_M, void* res_w, void* res_read, void* res_c, void* res_h, int B,
    int T, int IN, int N, int D, int H, int R, int W, int S, int Hc, int L, int O,
    int write_first, int slotwise, int rows, int device, void* stream) {
  const bool residuals = res_M != nullptr;
  if (L < 1 || L > MAX_LAYERS || B < 1 || T < 1 || !fwd_rows_ok(rows) ||
      residuals != (res_w && res_read && res_c && res_h))
    return (int)cudaErrorInvalidValue;
  PackedArgs a = {};
  a.tokens = (const float*)tokens;
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
  return rows == 1   ? launch_fwd<1>(a, residuals, device, stream)
         : rows == 4 ? launch_fwd<4>(a, residuals, device, stream)
                     : launch_fwd<8>(a, residuals, device, stream);
}

// The packed backward: ntm_bptt_bwd_launch's arguments (residuals with
// the memory packed [B, T, D*N]) plus the tile.
extern "C" int ntm_packed_bwd_launch(
    const void* tokens, const void* const* lstm_w, const void* const* lstm_b,
    const void* heads_w, const void* heads_b, const void* out_w, const void* out_b,
    const void* res_M, const void* res_w, const void* res_read, const void* res_c,
    const void* res_h, const void* dlogits, const void* dM_T, const void* dw_T,
    const void* dread_T, const void* dc_T, const void* dh_T, void* dM0, void* dw0,
    void* dread0, void* dc0, void* dh0, void* dtokens, void* li, void* dgates, void* ctrl,
    void* dctl, int B, int T, int IN, int N, int D, int H, int R, int W, int S, int Hc,
    int L, int O, int write_first, int slotwise, int rows, int device, void* stream) {
  if (L < 1 || L > MAX_LAYERS || B < 1 || T < 1 || !bwd_rows_ok(rows)) return (int)cudaErrorInvalidValue;
  PackedArgs a = {};
  a.tokens = (const float*)tokens;
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
  return rows == 1   ? launch_bwd<1>(a, device, stream)
         : rows == 2 ? launch_bwd<2>(a, device, stream)
                     : launch_bwd<4>(a, device, stream);
}
