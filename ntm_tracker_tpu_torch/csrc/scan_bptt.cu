// Whole-sequence NTM BPTT for training: a forward kernel that streams
// residuals, a backward kernel that walks the steps in reverse, and a
// reduction kernel for the parameter gradients.
//
// Replaces ntm_tracker_tpu/ops/pallas/scan_bptt.py: _fwd_res_kernel (the
// forward with residual streams), _bwd_kernel (the hand-derived backward)
// and the parameter-gradient accumulation that _bwd_kernel does in place.
//
//   forward   ntm_scan_kernel<true> (ntm_step.cuh): B1's loop, one block
//             per batch row, plus each step's INPUT state (M, w, read, c,
//             h) written to [B, T, ...] residual streams.
//   backward  ntm_bptt_bwd_kernel: one block per batch row walks
//             t = T-1 .. 0. Each step reloads its input state from the
//             residuals, recomputes the step's intermediates with the same
//             ntm_step() as the forward, then applies the VJPs of the whole
//             chain (read, erase/add, sharpen with the +1e-3 normalizer,
//             Py2-offset shift, gate, beta-softmax, cosine across slots or
//             slotwise, tanh(k), the head and output linears, the stacked
//             LSTM) and carries dM, dw, dread, dc, dh in shared memory to
//             the step before. It writes dtokens, dstate0, and per step the
//             operands of the weight gradients: each layer's input and
//             gate cotangents, the controller output and the head-control
//             cotangents.
//   reduce    ntm_grad_partial_kernel + ntm_grad_sum_kernel: dW = A^T G
//             over the B*T rows, with a row of ones appended to A for the
//             bias. Each block owns one 64x64 output tile of one row chunk
//             and sums its rows in order; the second kernel adds the chunks
//             in order. No atomics: the gradients are the same bits on
//             every run.
//
// d/dgamma of w_conv^gamma is taken as 0 where w_conv == 0 (the limit;
// the formula p * log(w_conv) gives 0 * -inf there), as scan_bptt.py:28-31
// does.
//
// What bounds it on an H100: each step of both kernels is a serial chain of
// small phases on one SM per row, and each step reads the [IN+R*D+Hc, 4*Hc]
// LSTM kernel (2.5 MB at the flagship config) from L2 once in the forward
// and twice in the backward (the recompute and the transposed product).
// With one block per SM resident (512 threads at up to 128 registers), the
// card runs 132 rows at a time and the aggregate L2 read rate, not HBM or
// the FLOP rate, sets the time. The residual streams (14.7 KB per row per
// step) and the reduction operands (~8 KB per row per step) go to HBM,
// which has room for them at B=256, T=1300 (about 7.5 GB in all).
//
// f32 only: the training path raises for a bf16 compute dtype.
//
// Plain C interface (no PyTorch headers): built by nvcc into a shared
// library and called through ctypes (ntm_tracker_tpu_torch/_build.py).

#include "ntm_step.cuh"

struct BwdArgs {
  const float* tokens;    // [B, T, IN]
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
  float* dtokens;         // [B, T, IN]
  float* li;              // [L, B*T, KINmax] each layer's input
  float* dgates;          // [L, B*T, 4*Hc] each layer's gate cotangents
  float* ctrl;            // [B*T, Hc] the controller output
  float* dctl;            // [B*T, P] the head-control cotangents
  Dims dm;
  Flags fl;
  int B, T;
};

__global__ void __launch_bounds__(NT, 1) ntm_bptt_bwd_kernel(const BwdArgs a) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Dims dm = a.dm;
  const int IN = dm.IN, N = dm.N, D = dm.D, H = dm.H, R = dm.R, W = dm.W, S = dm.S;
  const int Hc = dm.Hc, L = dm.L, O = dm.O, T = a.T, B = a.B;
  const int RD = R * D, ND = N * D, HN = H * N, LH = L * Hc;
  const int P = head_width(dm), KM = kin_max(dm);
  const int oBeta = H * D, oG = oBeta + H, oSw = oG + H, oGamma = oSw + S * H;
  const int oErase = oGamma + H, oAdd = oErase + W * D;
  const int shift0 = -((S + 1) / 2);
  const bool wf = a.fl.write_first != 0, slotwise = a.fl.slotwise != 0;
  const Layout lay = make_layout(dm, true);
  // the step's input state (from the residuals) and recomputed output state
  float* Mp = smem + lay.M_in;
  float* wp = smem + lay.w_in;
  float* rp = smem + lay.read_in;
  float* cp = smem + lay.c_in;
  float* hp = smem + lay.h_in;
  const float* Mn = smem + lay.M_out;
  const float* wn = smem + lay.w_out;
  const float* cn = smem + lay.c_out;
  const float* hn = smem + lay.h_out;
  // the recomputed intermediates
  const float* ctl = smem + lay.ctl;
  const float* mss = smem + lay.mss;
  const float* minv = smem + lay.minv;
  const float* ks = smem + lay.k;
  const float* kss = smem + lay.kss;
  const float* kinv = smem + lay.kinv;
  const float* beta = smem + lay.beta;
  const float* gg = smem + lay.g;
  const float* gamma = smem + lay.gamma;
  const float* sw = smem + lay.sw;
  const float* denom = smem + lay.denom;
  const float* u = smem + lay.u;
  const float* sim = smem + lay.sim;
  const float* wc = smem + lay.wc;
  const float* wg = smem + lay.wg;
  const float* wconv = smem + lay.wconv;
  const float* powed = smem + lay.powed;
  const float* erase = smem + lay.erase;
  const float* add = smem + lay.add;
  // cotangents
  float* dM = smem + lay.dM;        // carry: d M_t, then d M_new of the step
  float* dMp = smem + lay.dMp;      // d M_prev accumulator
  float* dtmp = smem + lay.dtmp;    // d read-source, then d Mtn
  float* dw = smem + lay.dw;        // carry: d w_t
  float* dwh = smem + lay.dwh;      // d w of the step's heads
  float* dwconv = smem + lay.dwconv;
  float* du = smem + lay.du;        // d w_c scratch, then d u
  float* dread = smem + lay.dread;  // carry: d read_t
  float* dc = smem + lay.dc;        // carry: d c_t per layer
  float* dh = smem + lay.dh;        // carry: d h_t per layer
  float* dctl = smem + lay.dctl;
  float* dctrl = smem + lay.dctrl;  // d of the current layer's output h
  float* dli = smem + lay.dli;
  float* dgates = smem + lay.dgates;
  float* dlogit = smem + lay.dlogit;
  float* dkss = smem + lay.dkss;
  float* dss = smem + lay.dss;

  for (int i = tid; i < ND; i += NT) dM[i] = a.dM_T[(size_t)b * ND + i];
  for (int i = tid; i < HN; i += NT) dw[i] = a.dw_T[(size_t)b * HN + i];
  for (int i = tid; i < RD; i += NT) dread[i] = a.dread_T[(size_t)b * RD + i];
  for (int l = 0; l < L; ++l)
    for (int i = tid; i < Hc; i += NT) {
      dc[l * Hc + i] = a.dc_T[((size_t)l * B + b) * Hc + i];
      dh[l * Hc + i] = a.dh_T[((size_t)l * B + b) * Hc + i];
    }

  for (int t = T - 1; t >= 0; --t) {
    const size_t bt = (size_t)b * T + t;
    const float* x = a.tokens + bt * IN;

    // ---- recompute the step from its residual input state ----------------
    for (int i = tid; i < ND; i += NT) Mp[i] = a.res_M[bt * ND + i];
    for (int i = tid; i < HN; i += NT) wp[i] = a.res_w[bt * HN + i];
    for (int i = tid; i < RD; i += NT) rp[i] = a.res_read[bt * RD + i];
    for (int i = tid; i < LH; i += NT) {
      cp[i] = a.res_c[bt * LH + i];
      hp[i] = a.res_h[bt * LH + i];
    }
    for (int i = tid; i < O; i += NT) dlogit[i] = a.dlogits[bt * O + i];
    __syncthreads();
    ntm_step(a.wt, dm, a.fl, smem, lay, x, nullptr);

    // ---- read: read[r,d] = sum_n w_r[n] * src[n,d] ------------------------
    const float* src = wf ? Mn : Mp;
    for (int i = tid; i < HN; i += NT) {
      const int hh = i / N, n = i - hh * N;
      float acc = dw[i];
      if (hh < R)
        for (int d = 0; d < D; ++d) acc = fmaf(dread[hh * D + d], src[n * D + d], acc);
      dwh[i] = acc;
    }
    for (int i = tid; i < ND; i += NT) {
      const int n = i / D, d = i - n * D;
      float acc = 0.f;
      for (int r = 0; r < R; ++r) acc = fmaf(dread[r * D + d], wn[r * N + n], acc);
      dtmp[i] = acc;
    }
    __syncthreads();

    // ---- erase/add: M_new = M_prev * er + ad ------------------------------
    for (int i = tid; i < ND; i += NT) {
      const int n = i / D, d = i - n * D;
      const float dmn = dM[i] + (wf ? dtmp[i] : 0.f);
      float er = 1.f;
      for (int wh = 0; wh < W; ++wh) er *= 1.f - wn[(R + wh) * N + n] * erase[wh * D + d];
      dMp[i] = (wf ? 0.f : dtmp[i]) + dmn * er;
      dM[i] = dmn;
    }
    __syncthreads();
    for (int i = tid; i < W * N; i += NT) {
      const int wh = i / N, n = i - wh * N;
      float acc = dwh[(R + wh) * N + n];
      for (int d = 0; d < D; ++d) {
        float others = 1.f;
        for (int wo = 0; wo < W; ++wo)
          if (wo != wh) others *= 1.f - wn[(R + wo) * N + n] * erase[wo * D + d];
        const float dfac = dM[n * D + d] * Mp[n * D + d] * others;
        acc = acc - dfac * erase[wh * D + d] + dM[n * D + d] * add[wh * D + d];
      }
      dwh[(R + wh) * N + n] = acc;
    }
    for (int p = warp; p < W * D; p += NWARPS) {
      const int wh = p / D, d = p - wh * D;
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
        const float e = erase[p], ad = add[p];
        dctl[oErase + p] = de * e * (1.f - e);
        dctl[oAdd + p] = da * (1.f - ad * ad);
      }
    }
    __syncthreads();

    // ---- per-head addressing (warp per head) ------------------------------
    for (int hh = warp; hh < H; hh += NWARPS) {
      const int o = hh * N;
      const float gam = gamma[hh], inv_den = 1.f / denom[hh];
      // sharpen: w = p / (sum p + 1e-3), p = w_conv ^ gamma
      float s1 = 0.f;
      for (int n = lane; n < N; n += 32) s1 = fmaf(dwh[o + n], powed[o + n], s1);
      s1 = warp_sum(s1);
      float dgam = 0.f;
      for (int n = lane; n < N; n += 32) {
        const float dp = dwh[o + n] * inv_den - s1 * inv_den * inv_den;
        const float wcv = wconv[o + n];
        dwconv[o + n] = dp * gam * powf(wcv, gam - 1.f);
        if (wcv > 0.f) dgam += dp * powed[o + n] * logf(wcv);
      }
      dgam = warp_sum(dgam);
      __syncwarp();
      // circular shift: w_conv[n] = sum_j sw_j * w_g[n + s_j]
      float dot_sw = 0.f;
      for (int j = 0; j < S; ++j) {
        const int s = shift0 + j;
        float acc = 0.f;
        for (int n = lane; n < N; n += 32) acc = fmaf(dwconv[o + n], wg[o + wrap(n + s, N)], acc);
        acc = warp_sum(acc);
        dot_sw = fmaf(acc, sw[hh * S + j], dot_sw);
        if (lane == 0) dctl[oSw + hh * S + j] = acc;  // d sw_j, finished below
      }
      // gate: w_g = w_c * g + w_prev * (1 - g)
      const float gt = gg[hh];
      float dg = 0.f, cdot = 0.f;
      for (int n = lane; n < N; n += 32) {
        float dwg = 0.f;
        for (int j = 0; j < S; ++j)
          dwg = fmaf(sw[hh * S + j], dwconv[o + wrap(n - (shift0 + j), N)], dwg);
        const float dwc = dwg * gt;
        dw[o + n] = dwg * (1.f - gt);  // the carry to the step before
        dg = fmaf(dwg, wc[o + n] - wp[o + n], dg);
        cdot = fmaf(dwc, wc[o + n], cdot);
        du[o + n] = dwc;
      }
      dg = warp_sum(dg);
      cdot = warp_sum(cdot);
      // content softmax w_c = softmax(sim * beta), sim = u * kinv
      const float bt = beta[hh], ki = kinv[hh];
      float dbeta = 0.f, dki = 0.f;
      for (int n = lane; n < N; n += 32) {
        const float ds = (du[o + n] - cdot) * wc[o + n];
        const float dsim = ds * bt;
        dbeta = fmaf(ds, sim[o + n], dbeta);
        dki = fmaf(dsim, u[o + n], dki);
        du[o + n] = dsim * ki;
      }
      dbeta = warp_sum(dbeta);
      dki = warp_sum(dki);
      if (lane == 0) {
        dkss[hh] = kss[hh] > 1e-12f ? dki * -0.5f * ki * ki * ki : 0.f;
        for (int j = 0; j < S; ++j) {
          const float swj = sw[hh * S + j];
          dctl[oSw + hh * S + j] = (dctl[oSw + hh * S + j] - dot_sw) * swj;
        }
        dctl[oBeta + hh] = dbeta * sigmoid_f(ctl[oBeta + hh]);
        dctl[oG + hh] = dg * gt * (1.f - gt);
        dctl[oGamma + hh] = dgam * sigmoid_f(ctl[oGamma + hh]);
      }
    }
    __syncthreads();

    // ---- keys and the normalized memory: u[h,n] = sum_d k[h,d] Mtn[n,d] --
    for (int i = tid; i < ND; i += NT) {
      const int n = i / D, d = i - n * D;
      float acc = 0.f;
      for (int hh = 0; hh < H; ++hh) acc = fmaf(du[hh * N + n], ks[hh * D + d], acc);
      dtmp[i] = acc;  // d Mtn
    }
    for (int p = warp; p < H * D; p += NWARPS) {
      const int hh = p / D, d = p - hh * D;
      float acc = 0.f;
      for (int n = lane; n < N; n += 32)
        acc = fmaf(du[hh * N + n], Mp[n * D + d] * (slotwise ? minv[n] : minv[d]), acc);
      acc = warp_sum(acc);
      if (lane == 0) {
        const float kv = ks[p];
        dctl[p] = (acc + 2.f * kv * dkss[hh]) * (1.f - kv * kv);
      }
    }
    __syncthreads();

    // ---- memory normalizer: Mtn = M_prev * rsqrt(max(sum M^2, 1e-12)) ---
    if (slotwise) {
      for (int n = tid; n < N; n += NT) {
        float acc = 0.f;
        for (int d = 0; d < D; ++d) acc = fmaf(dtmp[n * D + d], Mp[n * D + d], acc);
        const float mi = minv[n];
        dss[n] = mss[n] > 1e-12f ? acc * -0.5f * mi * mi * mi : 0.f;
      }
    } else {
      for (int d = warp; d < D; d += NWARPS) {
        float acc = 0.f;
        for (int n = lane; n < N; n += 32) acc = fmaf(dtmp[n * D + d], Mp[n * D + d], acc);
        acc = warp_sum(acc);
        const float mi = minv[d];
        if (lane == 0) dss[d] = mss[d] > 1e-12f ? acc * -0.5f * mi * mi * mi : 0.f;
      }
    }
    __syncthreads();
    for (int i = tid; i < ND; i += NT) {
      const int n = i / D, d = i - n * D;
      const int j = slotwise ? n : d;
      dM[i] = dMp[i] + dtmp[i] * minv[j] + 2.f * Mp[i] * dss[j];  // the carry
    }

    // ---- head and output linears: controls = ctrl @ heads_w + heads_b ------
    const float* ctrl = hn + (L - 1) * Hc;
    for (int i = tid; i < Hc; i += NT) a.ctrl[bt * Hc + i] = ctrl[i];
    for (int i = tid; i < P; i += NT) a.dctl[bt * P + i] = dctl[i];
    for (int k = warp; k < Hc; k += NWARPS) {
      float acc = 0.f;
      for (int j = lane; j < P; j += 32) acc = fmaf(dctl[j], __ldg(a.wt.heads_w + (size_t)k * P + j), acc);
      for (int o = lane; o < O; o += 32) acc = fmaf(dlogit[o], __ldg(a.wt.out_w + (size_t)k * O + o), acc);
      acc = warp_sum(acc);
      if (lane == 0) dctrl[k] = acc;
    }
    __syncthreads();

    // ---- stacked LSTM, top layer first --------------------------------------
    for (int l = L - 1; l >= 0; --l) {
      const float* gl = smem + lay.gates + l * 4 * Hc;
      const int in_l = l == 0 ? IN + RD : Hc, K = in_l + Hc;
      for (int j = tid; j < Hc; j += NT) {
        const float si = sigmoid_f(gl[j]), tj = tanhf(gl[Hc + j]);
        const float sf = sigmoid_f(gl[2 * Hc + j]), so = sigmoid_f(gl[3 * Hc + j]);
        const float tc = tanhf(cn[l * Hc + j]);
        const float dnh = dctrl[j] + dh[l * Hc + j];
        const float dnc = dc[l * Hc + j] + dnh * so * (1.f - tc * tc);
        dgates[j] = dnc * tj * si * (1.f - si);
        dgates[Hc + j] = dnc * si * (1.f - tj * tj);
        dgates[2 * Hc + j] = dnc * cp[l * Hc + j] * sf * (1.f - sf);
        dgates[3 * Hc + j] = dnh * tc * so * (1.f - so);
        dc[l * Hc + j] = dnc * sf;  // the carry
      }
      __syncthreads();
      // the weight gradient's operands: this layer's input and gate cotangents
      float* li_row = a.li + ((size_t)l * B * T + bt) * KM;
      for (int i = tid; i < K; i += NT) {
        float v;
        if (l == 0)
          v = i < IN ? x[i] : (i < IN + RD ? rp[i - IN] : hp[i - IN - RD]);
        else
          v = i < Hc ? hn[(l - 1) * Hc + i] : hp[l * Hc + i - Hc];
        li_row[i] = v;
      }
      float* dg_row = a.dgates + ((size_t)l * B * T + bt) * 4 * Hc;
      for (int i = tid; i < 4 * Hc; i += NT) dg_row[i] = dgates[i];
      // d layer input = W_l @ dgates (warp per input row, coalesced over gates)
      const float* Wl = a.wt.lstm_w[l];
      for (int k = warp; k < K; k += NWARPS) {
        float acc = 0.f;
        for (int j = lane; j < 4 * Hc; j += 32) acc = fmaf(dgates[j], __ldg(Wl + (size_t)k * 4 * Hc + j), acc);
        acc = warp_sum(acc);
        if (lane == 0) dli[k] = acc;
      }
      __syncthreads();
      for (int i = tid; i < Hc; i += NT) dh[l * Hc + i] = dli[in_l + i];  // the carry
      if (l == 0) {
        for (int i = tid; i < IN; i += NT) a.dtokens[bt * IN + i] = dli[i];
        for (int i = tid; i < RD; i += NT) dread[i] = dli[IN + i];  // the carry
      } else {
        for (int i = tid; i < Hc; i += NT) dctrl[i] = dli[i];
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < ND; i += NT) a.dM0[(size_t)b * ND + i] = dM[i];
  for (int i = tid; i < HN; i += NT) a.dw0[(size_t)b * HN + i] = dw[i];
  for (int i = tid; i < RD; i += NT) a.dread0[(size_t)b * RD + i] = dread[i];
  for (int l = 0; l < L; ++l)
    for (int i = tid; i < Hc; i += NT) {
      a.dc0[((size_t)l * B + b) * Hc + i] = dc[l * Hc + i];
      a.dh0[((size_t)l * B + b) * Hc + i] = dh[l * Hc + i];
    }
}

// ---- parameter-gradient reduction --------------------------------------------
// out[k, j] = sum_m A[m, k] * G[m, j] for k < K, and out[K, j] = sum_m G[m, j]
// (the bias), over m < M. One block per 64x64 tile of out and chunk of rows;
// 256 threads, each owning a 4x4 set of outputs strided by 16.
#define RT 64
#define RM 16
#define RNT 256

__global__ void __launch_bounds__(RNT) ntm_grad_partial_kernel(
    const float* __restrict__ A, int lda, const float* __restrict__ G, int ldg, int M, int K,
    int J, int rows_per_chunk, float* __restrict__ part) {
  __shared__ float As[RM][RT];
  __shared__ float Gs[RM][RT];
  const int k0 = blockIdx.y * RT, j0 = blockIdx.x * RT, chunk = blockIdx.z;
  const int m_begin = chunk * rows_per_chunk;
  const int m_end = min(M, m_begin + rows_per_chunk);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4];
  for (int i = 0; i < 4; ++i)
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
  for (int m0 = m_begin; m0 < m_end; m0 += RM) {
    for (int e = threadIdx.x; e < RM * RT; e += RNT) {
      const int r = e / RT, c = e - r * RT, m = m0 + r, kk = k0 + c, jj = j0 + c;
      const bool row = m < m_end;
      As[r][c] = row && kk < K ? A[(size_t)m * lda + kk] : (row && kk == K ? 1.f : 0.f);
      Gs[r][c] = row && jj < J ? G[(size_t)m * ldg + jj] : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < RM; ++r) {
      float av[4], gv[4];
      for (int i = 0; i < 4; ++i) av[i] = As[r][ty + 16 * i];
      for (int q = 0; q < 4; ++q) gv[q] = Gs[r][tx + 16 * q];
      for (int i = 0; i < 4; ++i)
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(av[i], gv[q], acc[i][q]);
    }
    __syncthreads();
  }
  for (int i = 0; i < 4; ++i)
    for (int q = 0; q < 4; ++q) {
      const int k = k0 + ty + 16 * i, j = j0 + tx + 16 * q;
      if (k <= K && j < J) part[((size_t)chunk * (K + 1) + k) * J + j] = acc[i][q];
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

extern "C" int ntm_bptt_smem_bytes(int IN, int N, int D, int H, int R, int W, int S, int Hc,
                                   int L, int O, int backward) {
  const Dims dm{IN, N, D, H, R, W, S, Hc, L, O};
  return make_layout(dm, backward != 0).total * (int)sizeof(float);
}

// The forward with residual streams: ntm_scan_cell_launch's arguments plus
// the five [B, T, ...] residual outputs. f32 only.
extern "C" int ntm_bptt_fwd_launch(
    const void* tokens, const void* const* lstm_w, const void* const* lstm_b,
    const void* heads_w, const void* heads_b, const void* out_w, const void* out_b,
    const void* M0, const void* w0, const void* read0, const void* const* c0,
    const void* const* h0, void* logits, void* M, void* w, void* read, void* c,
    void* h, void* res_M, void* res_w, void* res_read, void* res_c, void* res_h, int B,
    int T, int IN, int N, int D, int H, int R, int W, int S, int Hc, int L, int O,
    int write_first, int slotwise, int device, void* stream) {
  if (L < 1 || L > MAX_LAYERS) return (int)cudaErrorInvalidValue;
  const Dims dm{IN, N, D, H, R, W, S, Hc, L, O};
  const Flags fl{write_first, slotwise, 0};
  ScanArgs a = make_scan_args(tokens, lstm_w, lstm_b, heads_w, heads_b, out_w, out_b, M0, w0,
                              read0, c0, h0, logits, M, w, read, c, h, B, T, dm, fl);
  a.res_M = (float*)res_M;
  a.res_w = (float*)res_w;
  a.res_read = (float*)res_read;
  a.res_c = (float*)res_c;
  a.res_h = (float*)res_h;
  return launch_scan<true>(a, device, stream);
}

// The backward: one block per batch row. The final-state cotangents and the
// initial-state cotangents of c and h are stacked [L, B, Hc]; lstm_w is a
// host array of L device pointers.
extern "C" int ntm_bptt_bwd_launch(
    const void* tokens, const void* const* lstm_w, const void* const* lstm_b,
    const void* heads_w, const void* heads_b, const void* out_w, const void* out_b,
    const void* res_M, const void* res_w, const void* res_read, const void* res_c,
    const void* res_h, const void* dlogits, const void* dM_T, const void* dw_T,
    const void* dread_T, const void* dc_T, const void* dh_T, void* dM0, void* dw0,
    void* dread0, void* dc0, void* dh0, void* dtokens, void* li, void* dgates, void* ctrl,
    void* dctl, int B, int T, int IN, int N, int D, int H, int R, int W, int S, int Hc,
    int L, int O, int write_first, int slotwise, int device, void* stream) {
  if (L < 1 || L > MAX_LAYERS || B < 1 || T < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  BwdArgs a;
  a.tokens = (const float*)tokens;
  for (int l = 0; l < MAX_LAYERS; ++l) {
    a.wt.lstm_w[l] = l < L ? (const float*)lstm_w[l] : nullptr;
    a.wt.lstm_b[l] = l < L ? (const float*)lstm_b[l] : nullptr;
  }
  a.wt.heads_w = (const float*)heads_w;
  a.wt.heads_b = (const float*)heads_b;
  a.wt.out_w = (const float*)out_w;
  a.wt.out_b = (const float*)out_b;
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
  const int smem = make_layout(a.dm, true).total * (int)sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(ntm_bptt_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
  }
  ntm_bptt_bwd_kernel<<<B, NT, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// out [K+1, J] = [A^T G ; sum_m G] over M rows, in `chunks` row chunks of
// rows_per_chunk (a multiple of 16) summed in order; part is scratch of
// chunks * (K+1) * J floats.
extern "C" int ntm_grad_reduce_launch(const void* A, int lda, const void* G, int ldg, int M,
                                      int K, int J, int chunks, int rows_per_chunk, void* part,
                                      void* out, int device, void* stream) {
  if (M < 1 || K < 0 || J < 1 || chunks < 1 || rows_per_chunk < 1 || rows_per_chunk % RM != 0 ||
      (long long)chunks * rows_per_chunk < M)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((J + RT - 1) / RT, (K + 1 + RT - 1) / RT, chunks);
  ntm_grad_partial_kernel<<<grid, RNT, 0, (cudaStream_t)stream>>>(
      (const float*)A, lda, (const float*)G, ldg, M, K, J, rows_per_chunk, (float*)part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int size = (K + 1) * J;
  const int blocks = (size + 255) / 256 < 1024 ? (size + 255) / 256 : 1024;
  ntm_grad_sum_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>((const float*)part, chunks, size,
                                                               (float*)out);
  return (int)cudaGetLastError();
}
