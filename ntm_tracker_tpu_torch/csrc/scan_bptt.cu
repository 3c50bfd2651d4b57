// Whole-sequence NTM BPTT for training: a token projection, a forward
// kernel that streams residuals, a backward kernel that walks the steps in
// reverse, and a reduction kernel for the parameter gradients.
//
// Replaces ntm_tracker_tpu/ops/pallas/scan_bptt.py: _fwd_res_kernel (the
// forward with residual streams), _bwd_kernel (the hand-derived backward)
// and the parameter-gradient accumulation that _bwd_kernel does in place.
//
//   projection  ntm_token_proj_kernel: proj = X W0[:IN] + b0 over all B*T
//               steps at once, the token part of every step's layer-0
//               product, which does not depend on the recurrence. One
//               launch per train step, before the forward; the forward and
//               the backward both read it.
//   forward     ntm_bptt_fwd_kernel<RT, true>: one block per tile of RT
//               batch rows walks t = 0 .. T-1. Each step writes the rows'
//               INPUT state (M, w, read, c, h) to [B, T, ...] residual
//               streams, then runs tile_step: layer 0's gates from proj plus
//               [read | h] W0[IN:], the other layers and the head and
//               output linears as tile products, the addressing, read and
//               erase/add write of all the tile's rows at once.
//   backward    ntm_bptt_bwd_kernel<RT>: one block per tile of RT batch
//               rows walks t = T-1 .. 0. Each step reloads the rows' input
//               state from the residuals, recomputes the step with the
//               forward's tile_step (the same gates, bit for bit), applies
//               the VJPs of the whole chain (read, erase/add, sharpen with
//               the +1e-3 normalizer, Py2-offset shift, gate, beta-softmax,
//               cosine across slots or slotwise, tanh(k), the head and output
//               linears, the stacked LSTM) and carries dM, dw, dread, dc, dh
//               in shared memory to the step before. It writes dstate0,
//               dtokens only when asked, and per step the operands of the
//               weight gradients: each layer's input and gate cotangents, the
//               controller output and the head-control and logit cotangents
//               side by side.
//   reduce      ntm_grad_partial_kernel + ntm_grad_sum_kernel: dW = A^T G
//               over the B*T rows, with a column of ones appended to A for
//               the bias. Each block owns one output tile of one row chunk
//               and sums its rows in order; the second kernel adds the
//               chunks in order. No atomics: the gradients are the same bits
//               on every run.
//
// d/dgamma of w_conv^gamma is taken as 0 where w_conv == 0 (the limit;
// the formula p * log(w_conv) gives 0 * -inf there), as scan_bptt.py:28-31
// does.
//
// What bounds it on an H100, and what the design does about it (times:
// chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W, B=256, T=1300):
// - Each step of the forward and the backward is a serial chain of small
//   phases on one SM per tile. Every step reads the LSTM kernel and the
//   head linear from L2: the aggregate L2 read rate, not HBM or the FLOP
//   rate, sets the time. Both recurrences cut those bytes two ways: a tile
//   of RT rows reads each weight once per step for all its rows
//   (tile_dot in ntm_step.cuh, rows_dot_t below), and the token rows
//   W0[:IN] (1.6 MB of the 2.5 MB) leave the recurrence for the
//   projection, a GEMM over all steps that reads them once. The backward's
//   transposed product skips them too unless the caller asks for dtokens
//   (the training path's tokens are cached features that need none). Per
//   step and tile the forward reads W0[IN:] (0.9 MB) and the head linear
//   (0.14 MB) once; the backward reads W0[IN:] twice.
// - Shared memory bounds the tile: a row of the forward keeps ~39 KB at
//   the flagship config (its state in place, make_layout(dm, false)), so
//   four rows fit in one block; a row of the backward keeps ~105 KB, so
//   two fit (one of the two-layer, two-write-head config).
// - The rest of a step is its barrier-separated element phases (11 in
//   the forward, ~40 in the backward), each over the tile's rows at once.
//   Two rows per block fill the card once at B=256 and run fastest: the
//   forward takes 54 ms (90 at one row, 86 at four; 161 before, one row
//   per block reading the token rows every step), the backward 142 ms.
// - The projection and the reduction are f32 GEMMs bound by the FMA rate
//   (SIMT, no tensor cores): register-tiled outer products fed through
//   shared memory, the next slab loading while this one multiplies. The
//   projection takes 7.2 ms against torch.addmm's 6.4, the reduction
//   11.3 ms against torch.matmul's 11.7.
//
// B1's tile route (ops/kernels/scan_cell.py) is the projection and
// ntm_bptt_fwd_kernel<RT, false>: the same tile step without the residual
// streams, so its logits and final state are the same bits as B2's
// forward on the same projection. It alone takes compute_dtype=bf16: the
// caller rounds the tokens and the weights to bf16 on the card and hands
// the projection a zero bias, and tile_step rounds the products' inputs
// and sums (mm_bias).
//
// The training path is f32 only (no TF32): it raises for a bf16 compute
// dtype.
//
// Plain C interface (no PyTorch headers): built by nvcc into a shared
// library and called through ctypes (ntm_tracker_tpu_torch/_build.py).

#include "ntm_step.cuh"

struct BwdArgs {
  const float* tokens;    // [B, T, IN]
  const float* proj;      // [B*T, 4*Hc] X W0[:IN] + b0
  Weights wt;
  const float* res_M;     // [B, T, N, D]
  const float* res_w;     // [B, T, H, N]
  const float* res_read;  // [B, T, R*D]
  const float* res_c;     // [B, T, L, Hc]
  const float* res_h;     // [B, T, L, Hc]
  const float* dlogits;   // [B, T, O]
  const float* dM_T;      // [B, N, D] cotangents of the final state
  const float* dw_T;      // [B, H, N]
  const float* dread_T;   // [B, R*D]
  const float* dc_T;      // [L, B, Hc]
  const float* dh_T;      // [L, B, Hc]
  float* dM0;             // [B, N, D] cotangents of the initial state
  float* dw0;             // [B, H, N]
  float* dread0;          // [B, R*D]
  float* dc0;             // [L, B, Hc]
  float* dh0;             // [L, B, Hc]
  float* dtokens;         // [B, T, IN], written only when need_dtokens
  float* li;              // [L, B*T, KINmax rounded up to 4] each layer's input
  float* dgates;          // [L, B*T, 4*Hc] each layer's gate cotangents
  float* ctrl;            // [B*T, Hc] the controller output
  float* dctl;            // [B*T, P+O] the head-control cotangents, then the logits'
  Dims dm;
  Flags fl;
  int B, T, need_dtokens;
};

// The forward's arguments: the initial state, its outputs (logits, the
// final state) and the five [B, T, ...] residual streams of each step's
// input state.
struct FwdArgs {
  const float* proj;  // [B*T, 4*Hc] X W0[:IN] + b0
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
  float* res_M;       // [B, T, N, D]
  float* res_w;       // [B, T, H, N]
  float* res_read;    // [B, T, R*D]
  float* res_c;       // [B, T, L, Hc]
  float* res_h;       // [B, T, L, Hc]
  Dims dm;
  Flags fl;
  int B, T;
};

// Offsets (in floats) of a tile of RT rows: RT rows of make_layout(dm,
// backward), each rounded to 16 bytes (row r starts at r * row), then the
// tile's layer input, transposed [K][RT], where K is the widest product
// input of the step ([read | h], the token part coming from the
// projection, or [h_below | h]).
struct Tile {
  int row, xT, total;
};

__host__ __device__ inline Tile make_tile(const Dims& d, int RT, bool backward) {
  Tile s;
  s.row = (make_layout(d, backward).total + 3) & ~3;
  s.xT = RT * s.row;
  s.total = s.xT + imax(d.R * d.D + d.Hc, 2 * d.Hc) * RT;
  return s;
}

// The step's products keep many weight loads in flight: PROD_UNROLL
// iterations of tile_dot's k loop, and of two weight rows per warp in the
// backward's transposed products (rows_dot_t).
constexpr int PROD_UNROLL = 8;

// acc[i][r] += g_r[j] * W[k_i * ld + j] summed over this lane's j < ncol
// (j = lane, lane + 32, ...), for the NR weight rows k_i = k0 + i*NWARPS
// (rows at or past kend repeat row kend - 1; the caller drops them) and
// the tile's RT rows, g_r at g + r * row. Each lane keeps NR * PROD_UNROLL
// weight loads in flight; the caller sums acc across the warp.
template <int RT, int NR>
__device__ __forceinline__ void rows_dot_t(const float* __restrict__ W, int ld, int k0, int kend, int ncol,
                                           const float* g, int row, float (&acc)[NR][RT]) {
  const int lane = threadIdx.x & 31;
  const float* wr[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) wr[i] = W + (size_t)min(k0 + i * NWARPS, kend - 1) * ld;
#pragma unroll PROD_UNROLL
  for (int j = lane; j < ncol; j += 32) {
    float wv[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) wv[i] = __ldg(wr[i] + j);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const float gv = g[r * row + j];
#pragma unroll
      for (int i = 0; i < NR; ++i) acc[i][r] = fmaf(gv, wv[i], acc[i][r]);
    }
  }
}

// The addressing over the tile's nr rows at once, row r's arrays (make_layout)
// at smem + r * row, every intermediate kept for the backward;
// a warp per (row, head) runs the softmax, gate, shift and sharpen of its
// head in one phase. The forward (full) also does the read and the
// erase/add write in the configured order; the backward's recompute skips
// what it does not read: the read itself, and the new memory unless the
// read comes after the write. Enters after a __syncthreads() that
// published ctl, M_in and w_in; returns after one that publishes the
// outputs and intermediates.
__device__ __forceinline__ void addressing_tile(const Dims& dm, const Flags& fl, float* smem, const Layout& lay,
                                                int row, int nr, bool full) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = dm.N, D = dm.D, H = dm.H, R = dm.R, W = dm.W, S = dm.S;
  const int HD = H * D, WD = W * D, HN = H * N, ND = N * D;
  const int oBeta = HD, oG = oBeta + H, oSw = oG + H, oGamma = oSw + S * H;
  const int oErase = oGamma + H, oAdd = oErase + WD;
  const int shift0 = -((S + 1) / 2);
#define AP(r, f) (smem + (r) * row + lay.f)

  // ---- squashed head parameters and the memory normalizer ----------------
  for (int i = tid; i < nr * HD; i += NT) {
    const int r = i / HD, q = i - r * HD;
    AP(r, k)[q] = tanhf(AP(r, ctl)[q]);
  }
  for (int i = tid; i < nr * WD; i += NT) {
    const int r = i / WD, q = i - r * WD;
    AP(r, erase)[q] = sigmoid_f(AP(r, ctl)[oErase + q]);
    AP(r, add)[q] = tanhf(AP(r, ctl)[oAdd + q]);
  }
  for (int i = tid; i < nr * H; i += NT) {
    const int r = i / H, hh = i - r * H;
    const float* ctl = AP(r, ctl);
    AP(r, beta)[hh] = softplus_f(ctl[oBeta + hh]);
    AP(r, g)[hh] = sigmoid_f(ctl[oG + hh]);
    AP(r, gamma)[hh] = softplus_f(ctl[oGamma + hh]) + 1.f;
    const float* s_raw = ctl + oSw + hh * S;
    float mx = s_raw[0];
    for (int j = 1; j < S; ++j) mx = fmaxf(mx, s_raw[j]);
    float tot = 0.f;
    for (int j = 0; j < S; ++j) tot += expf(s_raw[j] - mx);
    for (int j = 0; j < S; ++j) AP(r, sw)[hh * S + j] = expf(s_raw[j] - mx) / tot;
  }
  if (fl.slotwise) {
    for (int i = tid; i < nr * N; i += NT) {
      const int r = i / N, n = i - r * N;
      const float* M = AP(r, M_in);
      float sq = 0.f;
      for (int d = 0; d < D; ++d) sq = fmaf(M[n * D + d], M[n * D + d], sq);
      AP(r, mss)[n] = sq;
      AP(r, minv)[n] = rsqrtf(fmaxf(sq, 1e-12f));
    }
  } else {
    for (int p = warp; p < nr * D; p += NWARPS) {
      const int r = p / D, d = p - r * D;
      const float* M = AP(r, M_in);
      float sq = 0.f;
      for (int n = lane; n < N; n += 32) sq = fmaf(M[n * D + d], M[n * D + d], sq);
      sq = warp_sum(sq);
      if (lane == 0) {
        AP(r, mss)[d] = sq;
        AP(r, minv)[d] = rsqrtf(fmaxf(sq, 1e-12f));
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < nr * H; i += NT) {
    const int r = i / H, hh = i - r * H;
    const float* ks = AP(r, k) + hh * D;
    float sq = 0.f;
    for (int d = 0; d < D; ++d) sq = fmaf(ks[d], ks[d], sq);
    AP(r, kss)[hh] = sq;
    AP(r, kinv)[hh] = rsqrtf(fmaxf(sq, 1e-12f));
  }
  __syncthreads();

  // ---- content similarity: u = k . Mtn, sim = u * |k|^-1 ----------------------
  for (int i = tid; i < nr * HN; i += NT) {
    const int r = i / HN, q = i - r * HN, hh = q / N, n = q - hh * N;
    const float* M = AP(r, M_in);
    const float* ks = AP(r, k) + hh * D;
    const float* minv = AP(r, minv);
    float acc = 0.f;
    for (int d = 0; d < D; ++d) {
      const float m = M[n * D + d] * (fl.slotwise ? minv[n] : minv[d]);
      acc = fmaf(ks[d], m, acc);
    }
    AP(r, u)[q] = acc;
    AP(r, sim)[q] = acc * AP(r, kinv)[hh];
  }
  __syncthreads();

  // ---- softmax, gate, shift and sharpen: a warp per (row, head) ------------
  for (int q = warp; q < nr * H; q += NWARPS) {
    const int r = q / H, hh = q - r * H, o = hh * N;
    const float* sim = AP(r, sim) + o;
    const float* w_in = AP(r, w_in) + o;
    float* wc = AP(r, wc) + o;
    float* wg = AP(r, wg) + o;
    const float bt = AP(r, beta)[hh], gt = AP(r, g)[hh];
    float mx = __int_as_float(0xff800000);  // -inf
    for (int n = lane; n < N; n += 32) mx = fmaxf(mx, sim[n] * bt);
    mx = warp_max(mx);
    float tot = 0.f;
    for (int n = lane; n < N; n += 32) tot += expf(sim[n] * bt - mx);
    tot = warp_sum(tot);
    for (int n = lane; n < N; n += 32) {
      const float wcv = expf(sim[n] * bt - mx) / tot;
      wc[n] = wcv;
      wg[n] = wcv * gt + w_in[n] * (1.f - gt);
    }
    __syncwarp();
    const float gm = AP(r, gamma)[hh];
    const float* sw = AP(r, sw) + hh * S;
    float* wconv = AP(r, wconv) + o;
    float* powed = AP(r, powed) + o;
    float ps = 0.f;
    for (int n = lane; n < N; n += 32) {
      float conv = 0.f;
      for (int j = 0; j < S; ++j) conv = fmaf(sw[j], wg[wrap(n + shift0 + j, N)], conv);
      const float pw = powf(conv, gm);
      wconv[n] = conv;
      powed[n] = pw;
      ps += pw;
    }
    ps = warp_sum(ps) + 1e-3f;
    if (lane == 0) AP(r, denom)[hh] = ps;
    float* w_out = AP(r, w_out) + o;
    for (int n = lane; n < N; n += 32) w_out[n] = powed[n] / ps;
  }
  __syncthreads();

  // ---- the read (a warp per (row, read output)) and the erase/add write, in
  // the configured order; in place in the forward's layout, so the phase
  // that overwrites M runs after the read of the old M ----------------------
  for (int pass = 0; pass < 2; ++pass) {
    const bool do_read = (pass == 0) != (fl.write_first != 0);
    if (do_read) {
      if (!full) continue;
      const float* src = fl.write_first ? AP(0, M_out) : AP(0, M_in);
      for (int p = warp; p < nr * R * D; p += NWARPS) {
        const int r = p / (R * D), o = p - r * (R * D), rh = o / D, d = o - rh * D;
        const float* w_out = AP(r, w_out) + rh * N;
        const float* sr = src + r * row;
        float acc = 0.f;
        for (int n = lane; n < N; n += 32) acc = fmaf(w_out[n], sr[n * D + d], acc);
        acc = warp_sum(acc);
        if (lane == 0) AP(r, read_out)[o] = acc;
      }
    } else {
      if (!full && !fl.write_first) continue;
      for (int i = tid; i < nr * ND; i += NT) {
        const int r = i / ND, q = i - r * ND, n = q / D, d = q - n * D;
        const float* w_out = AP(r, w_out);
        float er = 1.f, ad = 0.f;
        for (int wh = 0; wh < W; ++wh) {
          const float ww = w_out[(R + wh) * N + n];
          er *= 1.f - ww * AP(r, erase)[wh * D + d];
          ad = fmaf(ww, AP(r, add)[wh * D + d], ad);
        }
        AP(r, M_out)[q] = AP(r, M_in)[q] * er + ad;
      }
    }
    __syncthreads();
  }
#undef AP
}

// What tile_step reads and writes outside shared memory: the projection,
// the weights, and per step either the logits (the forward) or the weight
// gradient's operands li and ctrl (the backward's recompute, which also
// copies the step's token into li).
struct StepIO {
  const float* proj;    // [B*T, 4*Hc]
  Weights wt;
  const float* tokens;  // [B, T, IN]; backward only
  float* li;            // [L, B*T, KM]; backward only
  float* ctrl;          // [B*T, Hc]; backward only
  float* logits;        // [B*T, O]; forward only
  size_t BT;            // B*T, li's layer stride in rows
  int KM;               // li's row stride
};

// One cell step of the tile's nr rows (row r's arrays at smem + r * row),
// from their input state (M_in, w_in, read_in, c_in, h_in) to their new
// state and the step's intermediates: layer 0's gates from proj plus
// [read | h] W0[IN:] (the token rows are never read), the other layers and
// the head controls as tile products over xT ([K][RT], rows past nr zero),
// then addressing_tile. Row r's step is bt0 + r * T in the [B*T, ...]
// streams. kFwd: the forward (logits, the read and the write); else the
// backward's recompute (li, ctrl; the read skipped). Each product sums its
// K terms in order whatever RT is, so both get the same gates. kBf16 (the
// forward of B1's tile route only): compute_dtype=bf16, the products'
// inputs rounded as they enter xT, the weights already rounded by the
// caller, proj without b0, and each product's sum rounded before its bias
// (mm_bias); a template switch, so the f32 instances are the same code as
// without it. Enters after a __syncthreads() that published the input
// state; returns after one that publishes the outputs.
template <int RT, bool kFwd, bool kBf16 = false>
__device__ __forceinline__ void tile_step(const StepIO& io, const Dims& dm, const Flags& fl, float* smem,
                                          const Layout& lay, int row, float* xT, int nr, size_t bt0, int T) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int IN = dm.IN, Hc = dm.Hc, L = dm.L, O = dm.O, RD = dm.R * dm.D, G4 = 4 * Hc;
  const int P = head_width(dm), K0 = RD + Hc;
  static_assert(kFwd || !kBf16, "the backward's recompute is float32 only");
  constexpr bool bf = kBf16;
  const auto bt_of = [&](int r) { return bt0 + (size_t)r * T; };
  const auto in_round = [&](float v) { return bf ? bf16_round(v) : v; };
#define SP(r, f) (smem + (r) * row + lay.f)

  // layer 0's input [read | h], transposed (the token part comes from the
  // projection), and in the backward the weight gradient's operand
  // li = [x | read | h]
  for (int i = tid; i < nr * K0; i += NT) {
    const int r = i / K0, k = i - r * K0;
    const float v = k < RD ? SP(r, read_in)[k] : SP(r, h_in)[k - RD];
    xT[k * RT + r] = in_round(v);
    if (!kFwd) io.li[bt_of(r) * io.KM + IN + k] = v;
  }
  if (!kFwd)
    for (int i = tid; i < nr * IN; i += NT) {
      const int r = i / IN, k = i - r * IN;
      io.li[bt_of(r) * io.KM + k] = io.tokens[bt_of(r) * IN + k];
    }
  __syncthreads();

  // ---- the stacked LSTM ---------------------------------------------------------
  for (int l = 0; l < L; ++l) {
    const int K = l == 0 ? K0 : 2 * Hc;
    // layer 0's product takes only W0's rows IN.. (read, h)
    const float* Wl = io.wt.lstm_w[l] + (l == 0 ? (size_t)IN * G4 : 0);
    for (int j0 = tid; j0 < G4; j0 += 2 * NT) {
      float acc[2][RT];
      tile_dot<RT, 2, PROD_UNROLL>(Wl, G4, j0, G4, xT, K, acc);
      for (int c = 0; c < 2; ++c) {
        const int j = j0 + c * NT;
        if (j >= G4) break;
        for (int r = 0; r < nr; ++r) {
          const float base = l == 0 ? io.proj[bt_of(r) * G4 + j] : __ldg(io.wt.lstm_b[l] + j);
          if constexpr (bf)  // proj without b0: the rounded sum, then the bias
            SP(r, gates)[l * G4 + j] = l == 0 ? mm_bias(acc[c][r] + base, __ldg(io.wt.lstm_b[0] + j), true)
                                              : mm_bias(acc[c][r], base, true);
          else
            SP(r, gates)[l * G4 + j] = acc[c][r] + base;
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < nr * Hc; i += NT) {
      const int r = i / Hc, j = i - r * Hc;
      const float* gl = SP(r, gates) + l * G4;
      const float c_new = SP(r, c_in)[l * Hc + j] * sigmoid_f(gl[2 * Hc + j]) + sigmoid_f(gl[j]) * tanhf(gl[Hc + j]);
      const float h_new = tanhf(c_new) * sigmoid_f(gl[3 * Hc + j]);
      if (l + 1 < L) {
        const float h_next = SP(r, h_in)[(l + 1) * Hc + j];
        xT[j * RT + r] = in_round(h_new);
        xT[(Hc + j) * RT + r] = in_round(h_next);
        if (!kFwd) {
          float* li = io.li + ((size_t)(l + 1) * io.BT + bt_of(r)) * io.KM;
          li[j] = h_new;
          li[Hc + j] = h_next;
        }
      }
      SP(r, c_out)[l * Hc + j] = c_new;
      SP(r, h_out)[l * Hc + j] = h_new;
    }
    __syncthreads();
  }

  // ---- the head controls and the output linear, then the addressing ---------
  const int hoff = (L - 1) * Hc;
  for (int i = tid; i < nr * Hc; i += NT) {
    const int r = i / Hc, k = i - r * Hc;
    const float v = SP(r, h_out)[hoff + k];
    xT[k * RT + r] = in_round(v);
    if (!kFwd) io.ctrl[bt_of(r) * Hc + k] = v;
  }
  __syncthreads();
  for (int j = tid; j < P; j += NT) {
    float acc[1][RT];
    tile_dot<RT, 1, PROD_UNROLL>(io.wt.heads_w, P, j, P, xT, Hc, acc);
    const float bj = __ldg(io.wt.heads_b + j);
    for (int r = 0; r < nr; ++r) SP(r, ctl)[j] = mm_bias(acc[0][r], bj, bf);
  }
  if (kFwd)
    // a warp per logit column, from the last warp down (the head product
    // keeps the first ones busy); lanes over the controller output
    for (int o = NWARPS - 1 - warp; o < O; o += NWARPS) {
      float acc[RT];
      for (int r = 0; r < RT; ++r) acc[r] = 0.f;
      for (int k = lane; k < Hc; k += 32) {
        const float wv = __ldg(io.wt.out_w + (size_t)k * O + o);
        for (int r = 0; r < RT; ++r) acc[r] = fmaf(xT[k * RT + r], wv, acc[r]);
      }
      for (int r = 0; r < RT; ++r) acc[r] = warp_sum(acc[r]);
      if (lane == 0)
        for (int r = 0; r < nr; ++r) io.logits[bt_of(r) * O + o] = mm_bias(acc[r], __ldg(io.wt.out_b + o), bf);
    }
  __syncthreads();
  addressing_tile(dm, fl, smem, lay, row, nr, kFwd);
#undef SP
}

#define RP(r, f) (smem + (r) * tile.row + lay.f)

// T cell steps of the tile's rows b0 .. b0 + nr - 1 with their state
// resident in shared memory (in place: make_layout(dm, false)). kRes:
// each step's input state streamed to the residuals first (B2's forward);
// without, the same steps and nothing else (B1's tile route, which alone
// takes kBf16).
template <int RT, bool kRes, bool kBf16 = false>
__global__ void __launch_bounds__(NT, 1) ntm_bptt_fwd_kernel(const FwdArgs a) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const Dims dm = a.dm;
  const int N = dm.N, D = dm.D, H = dm.H, Hc = dm.Hc, L = dm.L, T = a.T, B = a.B;
  const int RD = dm.R * D, ND = N * D, HN = H * N, LH = L * Hc;
  const Layout lay = make_layout(dm, false);
  const Tile tile = make_tile(dm, RT, false);
  const int b0 = blockIdx.x * RT, nr = min(RT, B - b0);
  float* xT = smem + tile.xT;
  const StepIO io{a.proj, a.wt, nullptr, nullptr, nullptr, a.logits, (size_t)B * T, 0};

  // rows past B stay zero: the tile products read their (zero) inputs
  for (int i = tid; i < tile.total; i += NT) smem[i] = 0.f;
  __syncthreads();
  for (int i = tid; i < nr * ND; i += NT) RP(i / ND, M_in)[i % ND] = a.M0[(size_t)b0 * ND + i];
  for (int i = tid; i < nr * HN; i += NT) RP(i / HN, w_in)[i % HN] = a.w0[(size_t)b0 * HN + i];
  for (int i = tid; i < nr * RD; i += NT) RP(i / RD, read_in)[i % RD] = a.read0[(size_t)b0 * RD + i];
  for (int i = tid; i < nr * LH; i += NT) {
    const int r = i / LH, q = i - r * LH, l = q / Hc, j = q - l * Hc;
    RP(r, c_in)[q] = a.c0[((size_t)l * B + b0 + r) * Hc + j];
    RP(r, h_in)[q] = a.h0[((size_t)l * B + b0 + r) * Hc + j];
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // the step's input state; tile_step overwrites it only after its
    // first barrier
    const size_t bt0 = (size_t)b0 * T + t;
    if constexpr (kRes) {
      for (int i = tid; i < nr * ND; i += NT) {
        const int r = i / ND, q = i - r * ND;
        a.res_M[(bt0 + (size_t)r * T) * ND + q] = RP(r, M_in)[q];
      }
      for (int i = tid; i < nr * HN; i += NT) {
        const int r = i / HN, q = i - r * HN;
        a.res_w[(bt0 + (size_t)r * T) * HN + q] = RP(r, w_in)[q];
      }
      for (int i = tid; i < nr * RD; i += NT) {
        const int r = i / RD, q = i - r * RD;
        a.res_read[(bt0 + (size_t)r * T) * RD + q] = RP(r, read_in)[q];
      }
      for (int i = tid; i < nr * LH; i += NT) {
        const int r = i / LH, q = i - r * LH;
        a.res_c[(bt0 + (size_t)r * T) * LH + q] = RP(r, c_in)[q];
        a.res_h[(bt0 + (size_t)r * T) * LH + q] = RP(r, h_in)[q];
      }
    }
    tile_step<RT, true, kBf16>(io, dm, a.fl, smem, lay, tile.row, xT, nr, bt0, T);
  }

  for (int i = tid; i < nr * ND; i += NT) a.M[(size_t)b0 * ND + i] = RP(i / ND, M_out)[i % ND];
  for (int i = tid; i < nr * HN; i += NT) a.w[(size_t)b0 * HN + i] = RP(i / HN, w_out)[i % HN];
  for (int i = tid; i < nr * RD; i += NT) a.read[(size_t)b0 * RD + i] = RP(i / RD, read_out)[i % RD];
  for (int i = tid; i < nr * LH; i += NT) {
    const int r = i / LH, q = i - r * LH, l = q / Hc, j = q - l * Hc;
    a.c[((size_t)l * B + b0 + r) * Hc + j] = RP(r, c_out)[q];
    a.h[((size_t)l * B + b0 + r) * Hc + j] = RP(r, h_out)[q];
  }
}

template <int RT>
__global__ void __launch_bounds__(NT, 1) ntm_bptt_bwd_kernel(const BwdArgs a) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Dims dm = a.dm;
  const int IN = dm.IN, N = dm.N, D = dm.D, H = dm.H, R = dm.R, W = dm.W, S = dm.S;
  const int Hc = dm.Hc, L = dm.L, O = dm.O, T = a.T, B = a.B;
  const int RD = R * D, ND = N * D, HN = H * N, LH = L * Hc, HD = H * D, WD = W * D, G4 = 4 * Hc;
  const int P = head_width(dm), KM = (kin_max(dm) + 3) & ~3;  // li's row stride: 16-byte rows
  const int oBeta = HD, oG = oBeta + H, oSw = oG + H, oGamma = oSw + S * H;
  const int oErase = oGamma + H, oAdd = oErase + WD;
  const int shift0 = -((S + 1) / 2);
  const bool wf = a.fl.write_first != 0, slotwise = a.fl.slotwise != 0;
  const Layout lay = make_layout(dm, true);
  const Tile tile = make_tile(dm, RT, true);
  const int b0 = blockIdx.x * RT, nr = min(RT, B - b0);
  float* xT = smem + tile.xT;
  const StepIO io{a.proj, a.wt, a.tokens, a.li, a.ctrl, nullptr, (size_t)B * T, KM};

  // rows past B stay zero: the tile products read their (zero) inputs
  for (int i = tid; i < tile.total; i += NT) smem[i] = 0.f;
  __syncthreads();
  for (int i = tid; i < nr * ND; i += NT) RP(i / ND, dM)[i % ND] = a.dM_T[(size_t)b0 * ND + i];
  for (int i = tid; i < nr * HN; i += NT) RP(i / HN, dw)[i % HN] = a.dw_T[(size_t)b0 * HN + i];
  for (int i = tid; i < nr * RD; i += NT) RP(i / RD, dread)[i % RD] = a.dread_T[(size_t)b0 * RD + i];
  for (int i = tid; i < nr * LH; i += NT) {
    const int r = i / LH, q = i - r * LH, l = q / Hc, j = q - l * Hc;
    RP(r, dc)[q] = a.dc_T[((size_t)l * B + b0 + r) * Hc + j];
    RP(r, dh)[q] = a.dh_T[((size_t)l * B + b0 + r) * Hc + j];
  }

  for (int t = T - 1; t >= 0; --t) {
    // row r's step index into the [B, T, ...] and [B*T, ...] streams
    auto bt_of = [&](int r) { return (size_t)(b0 + r) * T + t; };

    // ---- reload the step's input state from the residuals ------------------
    for (int i = tid; i < nr * ND; i += NT) {
      const int r = i / ND, q = i - r * ND;
      RP(r, M_in)[q] = a.res_M[bt_of(r) * ND + q];
    }
    for (int i = tid; i < nr * HN; i += NT) {
      const int r = i / HN, q = i - r * HN;
      RP(r, w_in)[q] = a.res_w[bt_of(r) * HN + q];
    }
    for (int i = tid; i < nr * RD; i += NT) {
      const int r = i / RD, q = i - r * RD;
      RP(r, read_in)[q] = a.res_read[bt_of(r) * RD + q];
    }
    for (int i = tid; i < nr * LH; i += NT) {
      const int r = i / LH, q = i - r * LH;
      RP(r, c_in)[q] = a.res_c[bt_of(r) * LH + q];
      RP(r, h_in)[q] = a.res_h[bt_of(r) * LH + q];
    }
    for (int i = tid; i < nr * O; i += NT) {
      const int r = i / O, o = i - r * O;
      RP(r, dlogit)[o] = a.dlogits[bt_of(r) * O + o];
    }
    __syncthreads();

    // ---- recompute the step over the tile, as the forward ran it ------------
    tile_step<RT, false>(io, dm, a.fl, smem, lay, tile.row, xT, nr, (size_t)b0 * T + t, T);

    // ---- read: read[r,d] = sum_n w_r[n] * src[n,d] ------------------------
    for (int i = tid; i < nr * HN; i += NT) {
      const int r = i / HN, q = i - r * HN, hh = q / N, n = q - hh * N;
      const float* src = wf ? RP(r, M_out) : RP(r, M_in);
      const float* dread = RP(r, dread);
      float acc = RP(r, dw)[q];
      if (hh < R)
        for (int d = 0; d < D; ++d) acc = fmaf(dread[hh * D + d], src[n * D + d], acc);
      RP(r, dwh)[q] = acc;
    }
    for (int i = tid; i < nr * ND; i += NT) {
      const int r = i / ND, q = i - r * ND, n = q / D, d = q - n * D;
      const float* wn = RP(r, w_out);
      const float* dread = RP(r, dread);
      float acc = 0.f;
      for (int rh = 0; rh < R; ++rh) acc = fmaf(dread[rh * D + d], wn[rh * N + n], acc);
      RP(r, dtmp)[q] = acc;  // d read-source
    }
    __syncthreads();

    // ---- erase/add: M_new = M_prev * er + ad ------------------------------
    for (int i = tid; i < nr * ND; i += NT) {
      const int r = i / ND, q = i - r * ND, n = q / D, d = q - n * D;
      const float* wn = RP(r, w_out);
      const float* erase = RP(r, erase);
      float* dM = RP(r, dM);
      const float dt = RP(r, dtmp)[q];
      const float dmn = dM[q] + (wf ? dt : 0.f);
      float er = 1.f;
      for (int wh = 0; wh < W; ++wh) er *= 1.f - wn[(R + wh) * N + n] * erase[wh * D + d];
      RP(r, dMp)[q] = (wf ? 0.f : dt) + dmn * er;
      dM[q] = dmn;
    }
    __syncthreads();
    for (int i = tid; i < nr * W * N; i += NT) {
      const int r = i / (W * N), q = i - r * W * N, wh = q / N, n = q - wh * N;
      const float* wn = RP(r, w_out);
      const float* erase = RP(r, erase);
      const float* add = RP(r, add);
      const float* dM = RP(r, dM);
      const float* Mp = RP(r, M_in);
      float acc = RP(r, dwh)[(R + wh) * N + n];
      for (int d = 0; d < D; ++d) {
        float others = 1.f;
        for (int wo = 0; wo < W; ++wo)
          if (wo != wh) others *= 1.f - wn[(R + wo) * N + n] * erase[wo * D + d];
        const float dfac = dM[n * D + d] * Mp[n * D + d] * others;
        acc = acc - dfac * erase[wh * D + d] + dM[n * D + d] * add[wh * D + d];
      }
      RP(r, dwh)[(R + wh) * N + n] = acc;
    }
    for (int p = warp; p < nr * WD; p += NWARPS) {
      const int r = p / WD, q = p - r * WD, wh = q / D, d = q - wh * D;
      const float* wn = RP(r, w_out);
      const float* erase = RP(r, erase);
      const float* dM = RP(r, dM);
      const float* Mp = RP(r, M_in);
      float de = 0.f, da = 0.f;
      for (int n = lane; n < N; n += 32) {
        const float ww = wn[(R + wh) * N + n];
        float others = 1.f;
        for (int wo = 0; wo < W; ++wo)
          if (wo != wh) others *= 1.f - wn[(R + wo) * N + n] * erase[wo * D + d];
        de -= dM[n * D + d] * Mp[n * D + d] * others * ww;
        da = fmaf(dM[n * D + d], ww, da);
      }
      de = warp_sum(de);
      da = warp_sum(da);
      if (lane == 0) {
        const float e = erase[q], ad = RP(r, add)[q];
        RP(r, dctl)[oErase + q] = de * e * (1.f - e);
        RP(r, dctl)[oAdd + q] = da * (1.f - ad * ad);
      }
    }
    __syncthreads();

    // ---- per-head addressing: a warp per (row, head) ----------------------
    for (int q = warp; q < nr * H; q += NWARPS) {
      const int r = q / H, hh = q - r * H, o = hh * N;
      const float* dwh = RP(r, dwh) + o;
      const float* powed = RP(r, powed) + o;
      const float* wconv = RP(r, wconv) + o;
      const float* wg = RP(r, wg) + o;
      const float* wc = RP(r, wc) + o;
      const float* wp = RP(r, w_in) + o;
      const float* sim = RP(r, sim) + o;
      const float* u = RP(r, u) + o;
      const float* sw = RP(r, sw) + hh * S;
      const float* ctl = RP(r, ctl);
      float* dwconv = RP(r, dwconv) + o;
      float* dw = RP(r, dw) + o;
      float* du = RP(r, du) + o;
      float* dctl = RP(r, dctl);
      const float gam = RP(r, gamma)[hh], inv_den = 1.f / RP(r, denom)[hh];
      // sharpen: w = p / (sum p + 1e-3), p = w_conv ^ gamma
      float s1 = 0.f;
      for (int n = lane; n < N; n += 32) s1 = fmaf(dwh[n], powed[n], s1);
      s1 = warp_sum(s1);
      float dgam = 0.f;
      for (int n = lane; n < N; n += 32) {
        const float dp = dwh[n] * inv_den - s1 * inv_den * inv_den;
        const float wcv = wconv[n];
        dwconv[n] = dp * gam * powf(wcv, gam - 1.f);
        if (wcv > 0.f) dgam += dp * powed[n] * logf(wcv);
      }
      dgam = warp_sum(dgam);
      __syncwarp();
      // circular shift: w_conv[n] = sum_j sw_j * w_g[n + s_j]
      float dot_sw = 0.f;
      for (int j = 0; j < S; ++j) {
        const int s = shift0 + j;
        float acc = 0.f;
        for (int n = lane; n < N; n += 32) acc = fmaf(dwconv[n], wg[wrap(n + s, N)], acc);
        acc = warp_sum(acc);
        dot_sw = fmaf(acc, sw[j], dot_sw);
        if (lane == 0) dctl[oSw + hh * S + j] = acc;  // d sw_j, finished below
      }
      // gate: w_g = w_c * g + w_prev * (1 - g)
      const float gt = RP(r, g)[hh];
      float dg = 0.f, cdot = 0.f;
      for (int n = lane; n < N; n += 32) {
        float dwg = 0.f;
        for (int j = 0; j < S; ++j) dwg = fmaf(sw[j], dwconv[wrap(n - (shift0 + j), N)], dwg);
        const float dwc = dwg * gt;
        dw[n] = dwg * (1.f - gt);  // the carry to the step before
        dg = fmaf(dwg, wc[n] - wp[n], dg);
        cdot = fmaf(dwc, wc[n], cdot);
        du[n] = dwc;
      }
      dg = warp_sum(dg);
      cdot = warp_sum(cdot);
      // content softmax w_c = softmax(sim * beta), sim = u * kinv
      const float bt = RP(r, beta)[hh], ki = RP(r, kinv)[hh];
      float dbeta = 0.f, dki = 0.f;
      for (int n = lane; n < N; n += 32) {
        const float ds = (du[n] - cdot) * wc[n];
        const float dsim = ds * bt;
        dbeta = fmaf(ds, sim[n], dbeta);
        dki = fmaf(dsim, u[n], dki);
        du[n] = dsim * ki;
      }
      dbeta = warp_sum(dbeta);
      dki = warp_sum(dki);
      if (lane == 0) {
        RP(r, dkss)[hh] = RP(r, kss)[hh] > 1e-12f ? dki * -0.5f * ki * ki * ki : 0.f;
        for (int j = 0; j < S; ++j) dctl[oSw + hh * S + j] = (dctl[oSw + hh * S + j] - dot_sw) * sw[j];
        dctl[oBeta + hh] = dbeta * sigmoid_f(ctl[oBeta + hh]);
        dctl[oG + hh] = dg * gt * (1.f - gt);
        dctl[oGamma + hh] = dgam * sigmoid_f(ctl[oGamma + hh]);
      }
    }
    __syncthreads();

    // ---- keys and the normalized memory: u[h,n] = sum_d k[h,d] Mtn[n,d] --
    for (int i = tid; i < nr * ND; i += NT) {
      const int r = i / ND, q = i - r * ND, n = q / D, d = q - n * D;
      const float* du = RP(r, du);
      const float* ks = RP(r, k);
      float acc = 0.f;
      for (int hh = 0; hh < H; ++hh) acc = fmaf(du[hh * N + n], ks[hh * D + d], acc);
      RP(r, dtmp)[q] = acc;  // d Mtn
    }
    for (int p = warp; p < nr * HD; p += NWARPS) {
      const int r = p / HD, q = p - r * HD, hh = q / D, d = q - hh * D;
      const float* du = RP(r, du);
      const float* Mp = RP(r, M_in);
      const float* minv = RP(r, minv);
      float acc = 0.f;
      for (int n = lane; n < N; n += 32)
        acc = fmaf(du[hh * N + n], Mp[n * D + d] * (slotwise ? minv[n] : minv[d]), acc);
      acc = warp_sum(acc);
      if (lane == 0) {
        const float kv = RP(r, k)[q];
        RP(r, dctl)[q] = (acc + 2.f * kv * RP(r, dkss)[hh]) * (1.f - kv * kv);
      }
    }
    __syncthreads();

    // ---- memory normalizer: Mtn = M_prev * rsqrt(max(sum M^2, 1e-12)) ---
    if (slotwise) {
      for (int i = tid; i < nr * N; i += NT) {
        const int r = i / N, n = i - r * N;
        const float* dtmp = RP(r, dtmp);
        const float* Mp = RP(r, M_in);
        float acc = 0.f;
        for (int d = 0; d < D; ++d) acc = fmaf(dtmp[n * D + d], Mp[n * D + d], acc);
        const float mi = RP(r, minv)[n];
        RP(r, dss)[n] = RP(r, mss)[n] > 1e-12f ? acc * -0.5f * mi * mi * mi : 0.f;
      }
    } else {
      for (int p = warp; p < nr * D; p += NWARPS) {
        const int r = p / D, d = p - r * D;
        const float* dtmp = RP(r, dtmp);
        const float* Mp = RP(r, M_in);
        float acc = 0.f;
        for (int n = lane; n < N; n += 32) acc = fmaf(dtmp[n * D + d], Mp[n * D + d], acc);
        acc = warp_sum(acc);
        const float mi = RP(r, minv)[d];
        if (lane == 0) RP(r, dss)[d] = RP(r, mss)[d] > 1e-12f ? acc * -0.5f * mi * mi * mi : 0.f;
      }
    }
    __syncthreads();
    for (int i = tid; i < nr * ND; i += NT) {
      const int r = i / ND, q = i - r * ND, n = q / D, d = q - n * D;
      const int j = slotwise ? n : d;
      RP(r, dM)[q] = RP(r, dMp)[q] + RP(r, dtmp)[q] * RP(r, minv)[j] + 2.f * RP(r, M_in)[q] * RP(r, dss)[j];  // the carry
    }

    // ---- head and output linears: controls = ctrl @ heads_w + heads_b ------
    // the head-control cotangents and, beside them, the logits': one
    // reduction gives both linears' weight gradients
    for (int i = tid; i < nr * (P + O); i += NT) {
      const int r = i / (P + O), q = i - r * (P + O);
      a.dctl[bt_of(r) * (P + O) + q] = q < P ? RP(r, dctl)[q] : RP(r, dlogit)[q - P];
    }
    // d ctrl = heads_w @ dctl + out_w @ dlogit: a warp per two rows of
    // heads_w and out_w, lanes over the columns
    for (int k = warp; k < Hc; k += 2 * NWARPS) {
      float acc[2][RT] = {};
      rows_dot_t<RT, 2>(a.wt.heads_w, P, k, Hc, P, RP(0, dctl), tile.row, acc);
      rows_dot_t<RT, 2>(a.wt.out_w, O, k, Hc, O, RP(0, dlogit), tile.row, acc);
      for (int i = 0; i < 2; ++i)
        for (int r = 0; r < RT; ++r) acc[i][r] = warp_sum(acc[i][r]);
      if (lane == 0)
        for (int i = 0; i < 2 && k + i * NWARPS < Hc; ++i)
          for (int r = 0; r < nr; ++r) RP(r, dctrl)[k + i * NWARPS] = acc[i][r];
    }
    __syncthreads();

    // ---- stacked LSTM, top layer first --------------------------------------
    for (int l = L - 1; l >= 0; --l) {
      const int in_l = l == 0 ? IN + RD : Hc, K = in_l + Hc;
      for (int i = tid; i < nr * Hc; i += NT) {
        const int r = i / Hc, j = i - r * Hc;
        const float* gl = RP(r, gates) + l * G4;
        float* dgates = RP(r, dgates);
        const float si = sigmoid_f(gl[j]), tj = tanhf(gl[Hc + j]);
        const float sf = sigmoid_f(gl[2 * Hc + j]), so = sigmoid_f(gl[3 * Hc + j]);
        const float tc = tanhf(RP(r, c_out)[l * Hc + j]);
        const float dnh = RP(r, dctrl)[j] + RP(r, dh)[l * Hc + j];
        const float dnc = RP(r, dc)[l * Hc + j] + dnh * so * (1.f - tc * tc);
        dgates[j] = dnc * tj * si * (1.f - si);
        dgates[Hc + j] = dnc * si * (1.f - tj * tj);
        dgates[2 * Hc + j] = dnc * RP(r, c_in)[l * Hc + j] * sf * (1.f - sf);
        dgates[3 * Hc + j] = dnh * tc * so * (1.f - so);
        RP(r, dc)[l * Hc + j] = dnc * sf;  // the carry
      }
      __syncthreads();
      // the weight gradient's operand: this layer's gate cotangents
      for (int i = tid; i < nr * G4; i += NT) {
        const int r = i / G4, q = i - r * G4;
        a.dgates[((size_t)l * B * T + bt_of(r)) * G4 + q] = RP(r, dgates)[q];
      }
      // d layer input = W_l @ dgates: a warp per input row, lanes over the
      // gates, one weight load for the tile's rows. Layer 0's token rows
      // only when the caller wants dtokens.
      const int k_lo = (l == 0 && !a.need_dtokens) ? IN : 0;
      for (int k = k_lo + warp; k < K; k += 2 * NWARPS) {
        float acc[2][RT] = {};
        rows_dot_t<RT, 2>(a.wt.lstm_w[l], G4, k, K, G4, RP(0, dgates), tile.row, acc);
        for (int i = 0; i < 2; ++i)
          for (int r = 0; r < RT; ++r) acc[i][r] = warp_sum(acc[i][r]);
        if (lane == 0)
          for (int i = 0; i < 2 && k + i * NWARPS < K; ++i)
            for (int r = 0; r < nr; ++r) RP(r, dli)[k + i * NWARPS] = acc[i][r];
      }
      __syncthreads();
      for (int i = tid; i < nr * Hc; i += NT) {
        const int r = i / Hc, j = i - r * Hc;
        RP(r, dh)[l * Hc + j] = RP(r, dli)[in_l + j];  // the carry
      }
      if (l == 0) {
        if (a.need_dtokens)
          for (int i = tid; i < nr * IN; i += NT) {
            const int r = i / IN, k = i - r * IN;
            a.dtokens[bt_of(r) * IN + k] = RP(r, dli)[k];
          }
        for (int i = tid; i < nr * RD; i += NT) {
          const int r = i / RD, q = i - r * RD;
          RP(r, dread)[q] = RP(r, dli)[IN + q];  // the carry
        }
      } else {
        for (int i = tid; i < nr * Hc; i += NT) {
          const int r = i / Hc, j = i - r * Hc;
          RP(r, dctrl)[j] = RP(r, dli)[j];
        }
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < nr * ND; i += NT) a.dM0[(size_t)b0 * ND + i] = RP(i / ND, dM)[i % ND];
  for (int i = tid; i < nr * HN; i += NT) a.dw0[(size_t)b0 * HN + i] = RP(i / HN, dw)[i % HN];
  for (int i = tid; i < nr * RD; i += NT) a.dread0[(size_t)b0 * RD + i] = RP(i / RD, dread)[i % RD];
  for (int i = tid; i < nr * LH; i += NT) {
    const int r = i / LH, q = i - r * LH, l = q / Hc, j = q - l * Hc;
    a.dc0[((size_t)l * B + b0 + r) * Hc + j] = RP(r, dc)[q];
    a.dh0[((size_t)l * B + b0 + r) * Hc + j] = RP(r, dh)[q];
  }
}

#undef RP

// ---- f32 GEMM core: the reduction (TN) and the token projection (NN) -------
// A block of TY x TX threads owns a (TY*TM) x (TX*TN) output tile and keeps
// TM x TN accumulators per thread. Thread (ty, tx) owns the rows 4ty..4ty+3
// of each run of 4*TY rows (and 2ty, 2ty+1 of a last run of 2*TY when
// TM % 4 == 2), and the same pattern of columns in tx, so a float4 read of
// a stage row serves TX threads from contiguous bytes (no bank conflicts).
// A k-step reads TM + TN floats from shared memory per thread for TM * TN
// FMAs: at 8 x 8 the SM's 128 B/clock of shared memory only just keeps up
// with its FMA rate, at 10 x 10 it has a fifth to spare. The contraction
// runs in slabs of GK rows through a ring of GSTAGES stages of dynamic
// shared memory filled by cp.async: slab i+GSTAGES-1 loads while slab i
// multiplies, and each k-step's fragments load while the one before
// multiplies. A stage holds As[GK][BM + 4] and Bs[GK][BN + 4], both indexed
// [contraction][output]. An operand whose rows are 16-byte aligned (kVec)
// loads in 16-byte copies, others in 4-byte copies.
#define GK 16
#define GSTAGES 3

template <int TM_, int TN_, int TY_, int TX_, int MINB_>
struct Gemm {
  static constexpr int TM = TM_, TN = TN_, TY = TY_, TX = TX_, THREADS = TY_ * TX_;
  static constexpr int BM = TM_ * TY_, BN = TN_ * TX_, MINB = MINB_;
  static constexpr int SA = GK * (BM + 4), SB = GK * (BN + 4);  // floats per stage
  static constexpr int SMEM = GSTAGES * (SA + SB) * (int)sizeof(float);
  static_assert(TM % 4 != 1 && TM % 4 != 3 && TN % 4 != 1 && TN % 4 != 3, "runs of 4 and 2");
};

// the two tiles the host picks from, both measured on the H100 against
// other thread tiles, slab depths and ring sizes: 80 x 160 at 10 x 10 per
// thread (128 threads, three blocks per SM) and 128 x 128 at 8 x 8 (256
// threads, two blocks per SM)
using GemmWide = Gemm<10, 10, 8, 16, 2>;
using GemmSquare = Gemm<8, 8, 16, 16, 2>;

// dst[r * (BW + 4) + c] = src[(m0 + r) * ld + c0 + c] for the GK x BW slab,
// by NT_ threads: rows m0 + r < m_end and columns c0 + c < ncols; kOnes
// puts 1 at column ncols (the bias's column of ones), everything else is 0.
template <int BW, int NT_, bool kVec, bool kOnes>
__device__ __forceinline__ void load_slab(float* dst, const float* __restrict__ src, int ld, int m0, int m_end,
                                          int c0, int ncols) {
  if constexpr (kVec) {
    for (int e = threadIdx.x; e < GK * BW / 4; e += NT_) {
      const int r = e / (BW / 4), c = 4 * (e - r * (BW / 4)), m = m0 + r, k = c0 + c;
      float* d = dst + r * (BW + 4) + c;
      if (m < m_end && k + 3 < ncols) {
        cp_async_f32x4(d, src + (size_t)m * ld + k);
      } else {
        for (int q = 0; q < 4; ++q) {
          if (m < m_end && k + q < ncols)
            cp_async_f32(d + q, src + (size_t)m * ld + k + q);
          else
            d[q] = kOnes && m < m_end && k + q == ncols ? 1.f : 0.f;
        }
      }
    }
  } else {
    for (int e = threadIdx.x; e < GK * BW; e += NT_) {
      const int r = e / BW, c = e - r * BW, m = m0 + r, k = c0 + c;
      float* d = dst + r * (BW + 4) + c;
      if (m < m_end && k < ncols)
        cp_async_f32(d, src + (size_t)m * ld + k);
      else
        *d = kOnes && m < m_end && k == ncols ? 1.f : 0.f;
    }
  }
}

// the output row (or column) of fragment element e of a thread at
// coordinate t, with TT elements per thread and NTT threads along the edge
template <int TT, int NTT>
__device__ __forceinline__ int frag_at(int t, int e) {
  return e < TT / 4 * 4 ? e / 4 * 4 * NTT + 4 * t + e % 4 : TT / 4 * 4 * NTT + 2 * t + e % 4;
}

template <int TT, int NTT>
__device__ __forceinline__ void load_frag(const float* row, int t, float (&f)[TT]) {
#pragma unroll
  for (int s = 0; s < TT / 4; ++s) {
    const float4 v = *reinterpret_cast<const float4*>(row + s * 4 * NTT + 4 * t);
    f[4 * s] = v.x, f[4 * s + 1] = v.y, f[4 * s + 2] = v.z, f[4 * s + 3] = v.w;
  }
  if constexpr (TT % 4 == 2) {
    const float2 v = *reinterpret_cast<const float2*>(row + TT / 4 * 4 * NTT + 2 * t);
    f[TT - 2] = v.x, f[TT - 1] = v.y;
  }
}

// acc = sum over nslabs slabs of As^T Bs, the stages at smem (As) and
// smem + GSTAGES * SA (Bs); load(a, b, slab) issues the slab's cp.async
// copies (and plain stores for padding) into the stage at a and b.
template <class C, class Load>
__device__ __forceinline__ void gemm_mainloop(int nslabs, const Load& load, float* smem,
                                              float (&acc)[C::TM][C::TN]) {
  const int tx = threadIdx.x % C::TX, ty = threadIdx.x / C::TX;
  float* As = smem;
  float* Bs = smem + GSTAGES * C::SA;
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int q = 0; q < C::TN; ++q) acc[i][q] = 0.f;
#pragma unroll
  for (int s = 0; s < GSTAGES - 1; ++s) {
    if (s < nslabs) load(As + s * C::SA, Bs + s * C::SB, s);
    cp_async_commit();
  }
  for (int it = 0; it < nslabs; ++it) {
    cp_async_wait<GSTAGES - 2>();
    __syncthreads();  // slab `it` is in; every thread is done with slab it-1
    const int nxt = it + GSTAGES - 1;
    if (nxt < nslabs) load(As + (nxt % GSTAGES) * C::SA, Bs + (nxt % GSTAGES) * C::SB, nxt);
    cp_async_commit();
    const float* a = As + (it % GSTAGES) * C::SA;
    const float* b = Bs + (it % GSTAGES) * C::SB;
    float av[2][C::TM], bv[2][C::TN];
    load_frag<C::TM, C::TY>(a, ty, av[0]);
    load_frag<C::TN, C::TX>(b, tx, bv[0]);
#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      if (kk + 1 < GK) {
        load_frag<C::TM, C::TY>(a + (kk + 1) * (C::BM + 4), ty, av[(kk + 1) & 1]);
        load_frag<C::TN, C::TX>(b + (kk + 1) * (C::BN + 4), tx, bv[(kk + 1) & 1]);
      }
#pragma unroll
      for (int i = 0; i < C::TM; ++i)
#pragma unroll
        for (int q = 0; q < C::TN; ++q) acc[i][q] = fmaf(av[kk & 1][i], bv[kk & 1][q], acc[i][q]);
    }
  }
  cp_async_wait<0>();
}

// part[chunk, k, j] = sum over the chunk's rows m of A1[m, k] * G[m, j],
// where A1 is A[:, :K] with a column of ones appended (k = K, the bias).
template <class C, bool kVecA, bool kVecG>
__global__ void __launch_bounds__(C::THREADS, C::MINB) ntm_grad_partial_kernel(
    const float* __restrict__ A, int lda, const float* __restrict__ G, int ldg, int M, int K, int J,
    int rows_per_chunk, float* __restrict__ part) {
  extern __shared__ __align__(16) float gsm[];
  const int k0 = blockIdx.y * C::BM, j0 = blockIdx.x * C::BN, chunk = blockIdx.z;
  const int m_begin = chunk * rows_per_chunk, m_end = min(M, m_begin + rows_per_chunk);
  const auto load = [&](float* as, float* bs, int slab) {
    const int m0 = m_begin + slab * GK;
    load_slab<C::BM, C::THREADS, kVecA, true>(as, A, lda, m0, m_end, k0, K);
    load_slab<C::BN, C::THREADS, kVecG, false>(bs, G, ldg, m0, m_end, j0, J);
  };
  float acc[C::TM][C::TN];
  gemm_mainloop<C>(max(0, (m_end - m_begin + GK - 1) / GK), load, gsm, acc);
  const int tx = threadIdx.x % C::TX, ty = threadIdx.x / C::TX;
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int k = k0 + frag_at<C::TM, C::TY>(ty, i);
#pragma unroll
    for (int q = 0; q < C::TN; ++q) {
      const int j = j0 + frag_at<C::TN, C::TX>(tx, q);
      if (k <= K && j < J) part[((size_t)chunk * (K + 1) + k) * J + j] = acc[i][q];
    }
  }
}

__global__ void ntm_grad_sum_kernel(const float* __restrict__ part, int chunks, int size,
                                    float* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < size; i += gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int c = 0; c < chunks; ++c) acc += part[(size_t)c * size + i];
    out[i] = acc;
  }
}

// out[m, j] = bias[j] + sum_k X[m, k] * Wm[k, j] for m < M, j < J, k < K.
// The X slab is loaded transposed (As[k][m]): consecutive threads take
// consecutive k of one row, 4-byte copies scattered into the stage.
template <class C, bool kVecW>
__global__ void __launch_bounds__(C::THREADS, C::MINB) ntm_token_proj_kernel(
    const float* __restrict__ X, int ldx, const float* __restrict__ Wm, int ldw,
    const float* __restrict__ bias, int M, int K, int J, float* __restrict__ out) {
  extern __shared__ __align__(16) float gsm[];
  const int j0 = blockIdx.x * C::BN, m0 = blockIdx.y * C::BM;
  const auto load = [&](float* as, float* bs, int slab) {
    const int kb = slab * GK;
    for (int e = threadIdx.x; e < GK * C::BM; e += C::THREADS) {
      const int kk = e % GK, c = e / GK, m = m0 + c, k = kb + kk;
      float* d = as + kk * (C::BM + 4) + c;
      if (m < M && k < K)
        cp_async_f32(d, X + (size_t)m * ldx + k);
      else
        *d = 0.f;
    }
    load_slab<C::BN, C::THREADS, kVecW, false>(bs, Wm, ldw, kb, K, j0, J);
  };
  float acc[C::TM][C::TN];
  gemm_mainloop<C>((K + GK - 1) / GK, load, gsm, acc);
  const int tx = threadIdx.x % C::TX, ty = threadIdx.x / C::TX;
  // fragment columns come in runs of 4 (and 2) contiguous columns
  const bool vec_out = J % 4 == 0;
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int m = m0 + frag_at<C::TM, C::TY>(ty, i);
    if (m >= M) continue;
    float* orow = out + (size_t)m * J;
#pragma unroll
    for (int q = 0; q < C::TN; q += 4) {
      const int j = j0 + frag_at<C::TN, C::TX>(tx, q), n = min(4, C::TN - q);
      if (n == 4 && vec_out && j + 3 < J) {
        const float4 b4 = __ldg(reinterpret_cast<const float4*>(bias + j));
        *reinterpret_cast<float4*>(orow + j) =
            make_float4(acc[i][q] + b4.x, acc[i][q + 1] + b4.y, acc[i][q + 2] + b4.z, acc[i][q + 3] + b4.w);
      } else {
        for (int u = 0; u < n; ++u)
          if (j + u < J) orow[j + u] = acc[i][q + u] + __ldg(bias + j + u);
      }
    }
  }
}

// ---- plain C entry points ---------------------------------------------------

// Dynamic shared memory per block of the forward or the backward at `rows`
// rows per block.
extern "C" int ntm_bptt_smem_bytes(int IN, int N, int D, int H, int R, int W, int S, int Hc,
                                   int L, int O, int backward, int rows) {
  const Dims dm{IN, N, D, H, R, W, S, Hc, L, O};
  return make_tile(dm, rows, backward != 0).total * (int)sizeof(float);
}

static Weights make_weights(const void* const* lstm_w, const void* const* lstm_b, const void* heads_w,
                            const void* heads_b, const void* out_w, const void* out_b, int L) {
  Weights wt;
  for (int l = 0; l < MAX_LAYERS; ++l) {
    wt.lstm_w[l] = l < L ? (const float*)lstm_w[l] : nullptr;
    wt.lstm_b[l] = l < L ? (const float*)lstm_b[l] : nullptr;
  }
  wt.heads_w = (const float*)heads_w;
  wt.heads_b = (const float*)heads_b;
  wt.out_w = (const float*)out_w;
  wt.out_b = (const float*)out_b;
  return wt;
}

// Launch a tile kernel with ceil(B / rows) blocks of NT threads.
template <class Kernel, class Args>
static int launch_tiles(Kernel kernel, const Args& a, int rows, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(a.B + rows - 1) / rows, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The forward: one block per `rows` (1, 2 or 4) batch rows. proj holds
// layer 0's token part per step [B*T, 4*Hc] (ntm_token_proj_launch's
// output: X W0[:IN] + b0, or at bf16 the rounded operands' X W0[:IN]
// without b0); the initial and final c and h are stacked [L, B, Hc];
// lstm_w and lstm_b are host arrays of L device pointers. With the five
// residual pointers set, B2's forward (f32 only); with all five null, B1's
// tile route, which also takes bf16 (the weights rounded by the caller).
extern "C" int ntm_bptt_fwd_launch(
    const void* proj, const void* const* lstm_w, const void* const* lstm_b, const void* heads_w,
    const void* heads_b, const void* out_w, const void* out_b, const void* M0, const void* w0,
    const void* read0, const void* c0, const void* h0, void* logits, void* M, void* w, void* read,
    void* c, void* h, void* res_M, void* res_w, void* res_read, void* res_c, void* res_h, int B,
    int T, int IN, int N, int D, int H, int R, int W, int S, int Hc, int L, int O,
    int write_first, int slotwise, int bf16, int rows, int device, void* stream) {
  const int nres = (res_M != nullptr) + (res_w != nullptr) + (res_read != nullptr) + (res_c != nullptr) +
                   (res_h != nullptr);
  if (L < 1 || L > MAX_LAYERS || B < 1 || T < 1 || (rows != 1 && rows != 2 && rows != 4) || proj == nullptr ||
      (nres != 0 && nres != 5) || (nres == 5 && bf16))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  FwdArgs a;
  a.proj = (const float*)proj;
  a.wt = make_weights(lstm_w, lstm_b, heads_w, heads_b, out_w, out_b, L);
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
  a.res_M = (float*)res_M;
  a.res_w = (float*)res_w;
  a.res_read = (float*)res_read;
  a.res_c = (float*)res_c;
  a.res_h = (float*)res_h;
  a.dm = Dims{IN, N, D, H, R, W, S, Hc, L, O};
  a.fl = Flags{write_first, slotwise, bf16};
  a.B = B;
  a.T = T;
  const int smem = make_tile(a.dm, rows, false).total * (int)sizeof(float);
  const cudaStream_t st = (cudaStream_t)stream;
  if (nres == 5) {
    if (rows == 1) return launch_tiles(ntm_bptt_fwd_kernel<1, true>, a, 1, smem, st);
    if (rows == 2) return launch_tiles(ntm_bptt_fwd_kernel<2, true>, a, 2, smem, st);
    return launch_tiles(ntm_bptt_fwd_kernel<4, true>, a, 4, smem, st);
  }
  if (bf16) {
    if (rows == 1) return launch_tiles(ntm_bptt_fwd_kernel<1, false, true>, a, 1, smem, st);
    if (rows == 2) return launch_tiles(ntm_bptt_fwd_kernel<2, false, true>, a, 2, smem, st);
    return launch_tiles(ntm_bptt_fwd_kernel<4, false, true>, a, 4, smem, st);
  }
  if (rows == 1) return launch_tiles(ntm_bptt_fwd_kernel<1, false>, a, 1, smem, st);
  if (rows == 2) return launch_tiles(ntm_bptt_fwd_kernel<2, false>, a, 2, smem, st);
  return launch_tiles(ntm_bptt_fwd_kernel<4, false>, a, 4, smem, st);
}

// The backward: one block per `rows` (1 or 2) batch rows. The final-state
// cotangents and the initial-state cotangents of c and h are stacked
// [L, B, Hc]; lstm_w is a host array of L device pointers. proj holds
// X W0[:IN] + b0 per step [B*T, 4*Hc] (ntm_token_proj_launch's output);
// dtokens is written only when need_dtokens.
extern "C" int ntm_bptt_bwd_launch(
    const void* tokens, const void* proj, const void* const* lstm_w, const void* const* lstm_b,
    const void* heads_w, const void* heads_b, const void* out_w, const void* out_b,
    const void* res_M, const void* res_w, const void* res_read, const void* res_c,
    const void* res_h, const void* dlogits, const void* dM_T, const void* dw_T,
    const void* dread_T, const void* dc_T, const void* dh_T, void* dM0, void* dw0,
    void* dread0, void* dc0, void* dh0, void* dtokens, void* li, void* dgates, void* ctrl,
    void* dctl, int B, int T, int IN, int N, int D, int H, int R, int W, int S, int Hc,
    int L, int O, int write_first, int slotwise, int need_dtokens, int rows, int device,
    void* stream) {
  if (L < 1 || L > MAX_LAYERS || B < 1 || T < 1 || (rows != 1 && rows != 2) || proj == nullptr ||
      (need_dtokens && dtokens == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  BwdArgs a;
  a.tokens = (const float*)tokens;
  a.proj = (const float*)proj;
  a.wt = make_weights(lstm_w, lstm_b, heads_w, heads_b, out_w, out_b, L);
  a.res_M = (const float*)res_M;
  a.res_w = (const float*)res_w;
  a.res_read = (const float*)res_read;
  a.res_c = (const float*)res_c;
  a.res_h = (const float*)res_h;
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
  const int smem = make_tile(a.dm, rows, true).total * (int)sizeof(float);
  const cudaStream_t st = (cudaStream_t)stream;
  return rows == 1 ? launch_tiles(ntm_bptt_bwd_kernel<1>, a, 1, smem, st)
                   : launch_tiles(ntm_bptt_bwd_kernel<2>, a, 2, smem, st);
}

static bool aligned16(const void* p, int ld) { return ((size_t)p % 16 == 0) && ld % 4 == 0; }

template <class C, class F>
static cudaError_t set_smem(F kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
}

template <class C>
static int launch_proj(cudaStream_t st, const float* X, int ldx, const float* Wm, int ldw, const float* bias,
                       int M, int K, int J, float* out) {
  if ((M + C::BM - 1) / C::BM > 65535) return (int)cudaErrorInvalidValue;
  // the column tiles of one row tile are neighbours: X's rows are read
  // from HBM once and then from L2
  const dim3 grid((J + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM);
  const auto kernel = aligned16(Wm, ldw) ? ntm_token_proj_kernel<C, true> : ntm_token_proj_kernel<C, false>;
  const cudaError_t err = set_smem<C>(kernel);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, C::THREADS, C::SMEM, st>>>(X, ldx, Wm, ldw, bias, M, K, J, out);
  return (int)cudaGetLastError();
}

// out [M, J] = X [M, K] (row stride ldx) @ Wm [K, J] (row stride ldw) +
// bias [J], on the block tile whose row edge is `tile` (GemmWide's 80 or
// GemmSquare's 128).
extern "C" int ntm_token_proj_launch(const void* X, int ldx, const void* Wm, int ldw,
                                     const void* bias, int M, int K, int J, int tile, void* out,
                                     int device, void* stream) {
  if (M < 1 || K < 1 || J < 1 || (tile != GemmWide::BM && tile != GemmSquare::BM) || (size_t)bias % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  if (tile == GemmWide::BM)
    return launch_proj<GemmWide>(st, (const float*)X, ldx, (const float*)Wm, ldw, (const float*)bias, M, K, J,
                                 (float*)out);
  return launch_proj<GemmSquare>(st, (const float*)X, ldx, (const float*)Wm, ldw, (const float*)bias, M, K, J,
                                 (float*)out);
}

template <class C>
static int launch_partial(cudaStream_t st, const float* A, int lda, const float* G, int ldg, int M, int K,
                          int J, int chunks, int rows_per_chunk, float* part) {
  const dim3 grid((J + C::BN - 1) / C::BN, (K + 1 + C::BM - 1) / C::BM, chunks);
  const bool va = aligned16(A, lda), vg = aligned16(G, ldg);
  const auto kernel = va ? (vg ? ntm_grad_partial_kernel<C, true, true> : ntm_grad_partial_kernel<C, true, false>)
                         : (vg ? ntm_grad_partial_kernel<C, false, true> : ntm_grad_partial_kernel<C, false, false>);
  const cudaError_t err = set_smem<C>(kernel);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, C::THREADS, C::SMEM, st>>>(A, lda, G, ldg, M, K, J, rows_per_chunk, part);
  return (int)cudaGetLastError();
}

// out [K+1, J] = [A^T G ; sum_m G] over M rows, on the block tile whose
// row edge is `tile` (GemmWide's 80 or GemmSquare's 128), in `chunks` row
// chunks of rows_per_chunk (a multiple of GK) summed in order; part is
// scratch of chunks * (K+1) * J floats.
extern "C" int ntm_grad_reduce_launch(const void* A, int lda, const void* G, int ldg, int M,
                                      int K, int J, int tile, int chunks, int rows_per_chunk,
                                      void* part, void* out, int device, void* stream) {
  if (M < 1 || K < 0 || J < 1 || (tile != GemmWide::BM && tile != GemmSquare::BM) || chunks < 1 ||
      rows_per_chunk < 1 || rows_per_chunk % GK != 0 || (long long)chunks * rows_per_chunk < M)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  const int e = tile == GemmWide::BM
      ? launch_partial<GemmWide>(st, (const float*)A, lda, (const float*)G, ldg, M, K, J, chunks, rows_per_chunk,
                                 (float*)part)
      : launch_partial<GemmSquare>(st, (const float*)A, lda, (const float*)G, ldg, M, K, J, chunks, rows_per_chunk,
                                   (float*)part);
  if (e != 0) return e;
  const int size = (K + 1) * J;
  const int blocks = (size + 255) / 256 < 1024 ? (size + 255) / 256 : 1024;
  ntm_grad_sum_kernel<<<blocks, 256, 0, st>>>((const float*)part, chunks, size, (float*)out);
  return (int)cudaGetLastError();
}
