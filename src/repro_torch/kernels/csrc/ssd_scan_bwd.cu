// K9b: the backward of the Mamba2 SSD chunked scan (K9), for sm_90a.
//
// Replaces no TPU kernel: the reference has no VJP for its Pallas scan
// (repro/kernels/ssd_scan.py) and trains by autodiff of the jnp scan
// repro/models/mamba.py:71 ssd_chunked.  K9b computes the same gradients
// (dx, ddt, dA, dB, dC), chunk-parallel like the forward.  Per (b, h) and
// chunk of Q positions, with cum = cumsum(dt * A), total = cum_{Q-1}, S
// the state entering the chunk, G the gradient of the state leaving it,
// att[q,t] = C_q.B_t e^(cum_q - cum_t) dt_t and dAtt[q,t] = dy_q.x_t for
// t <= q, w_t = e^(total - cum_t) dt_t:
//
//   G_c  = e^total G_{c+1} + sum_q e^cum_q dy_q^T C_q               K9bs
//   dx_t = sum_{q>=t} att[q,t] dy_q + w_t G B_t                     K9bx
//   dC_q = sum_t dCB[q,t] B_t + sum_h e^cum_q S^T dy_q              K9bc
//   dB_t = sum_q dCB[q,t] C_q + sum_h w_t G^T x_t                   K9bc
//          dCB[q,t] = sum_h dAtt[q,t] e^(cum_q - cum_t) dt_t
//   dcum_q = sum_t dAtt.att[q,t] - sum_t dAtt.att[t,q] + e^cum_q dy_q.S C_q
//            - w_q x_q.G B_q  (+ sum_t w_t x_t.G B_t + e^total <G, S> on
//            the chunk's last row)
//   ddt_t = sum_q dAtt[q,t] C_q.B_t e^(cum_q - cum_t)
//           + e^(total - cum_t) x_t.G B_t + A sum_{q>=t} dcum_q       K9bx
//   dA    = sum over (b, chunk, q) of dcum_q sum_{t<=q} dt_t        K9ba
//
// (kernels/ssd_scan.py ssd_chunk_grads_plain is the same arithmetic in
// plain PyTorch.)  The masked decays are *selected* away, never
// multiplied by a 0/1 mask: e^(cum_q - cum_t) for t > q overflows fp32.
//
// Launches, in order, on the caller's stream (one counted call):
//   tc route (bf16, P and N multiples of 16; the wrapper first runs K9s
//   and K9s reversed -- K9bs -- from csrc/ssd_scan.cu on the tensor
//   cores, for S and G as bf16 hi + lo scratches):
//     K9bx ssd_bwd_chunk_tc_kernel, per (b, chunk, group of up to 8
//         heads), the heads in order, on mma.sync: dx, ddt, the chunk's
//         dA share, and dCB summed over the group's heads into an fp32
//         partial (design at the kernel);
//     K9bc ssd_bwd_bc_tc_kernel, per (b, chunk, 64 columns of N): dC and
//         dB, the heads in order, then the groups' dCB partials;
//   fp32 route (fp32, and bf16 shapes outside the tc range), CUDA-core
//   fp32 FMAs from shared memory:
//     ssd_pass_kernel<T, false>: the states entering each chunk (fp32);
//     K9bs ssd_pass_kernel<T, true>: the same pass backwards over the
//         chunks on (dy e^cum, C) from dstate, storing each G_{c+1};
//     K9bg ssd_bwd_state_kernel<T>, per (b, h, chunk): G B^T (an fp32
//         scratch), x_t . G B_t, dy_q . S C_q, <G, S>;
//     K9bx ssd_bwd_chunk_kernel<T>, per (b, chunk, group of heads): C B^T
//         once, per head dAtt in strips of 32 rows, dx, ddt, dA share,
//         dCB over the group's heads;
//     K9bc ssd_bwd_bc_kernel<T>, per (b, chunk, 64 columns of N);
//   both: K9ba ssd_bwd_da_kernel, dA, the (b, chunk) shares in order.
// No atomics: every sum runs in a fixed order, so two calls give the same
// bits.  B and C are shared by every head (one group), which is why dB
// and dC are a sum over heads: K9bc owns each output row and walks the
// heads itself.
//
// Ragged S and padded rows: positions past S, and rows between Q and the
// padded chunk, load as dt = 0 and x = B = C = dy = 0 (the forward's
// padding); their gradients are not stored, and cum there equals cum at
// the last real row, so the carry and dA stay exact.
//
// Bound on the H100: at B=4, S=4096, H=64, P=64, N=128, Q=128 the
// gradients need 121 GFLOP (the causal half of the Q^2 products, six
// QPN products a (b, h, chunk)) and must move 0.43 GB (x, dy, dx read or
// written once, B, C, dB, dC, dt, ddt): 0.128 ms, by bytes.  The tc route
// also moves its scratches (S and G written and read, 4 x 268 MB) and
// recomputes C B^T per head; its fp32 products enter the tensor cores as
// bf16 hi + lo pairs (two or three products each), as the forward's do.

#include "common.cuh"

namespace repro {
namespace {

constexpr int BT = 256;            // threads per block
constexpr int B_MAX_Q = 128, B_MAX_P = 64, B_MAX_N = 128;
constexpr int RS = 32;             // query rows per strip (K9bx)
constexpr int KT = 32;             // N columns per k-tile (K9bg, K9bx)
constexpr int NTILE = 64;          // N columns per K9bc block
constexpr int MAX_HG = 8;          // heads per K9bx block

// the chunk as the kernels hold it: 16 rows, or whole strips of 32
__host__ __device__ constexpr int bqpad(int q) {
  return q <= 16 ? 16 : (q + RS - 1) / RS * RS;
}

struct BwdArgs {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const void* dy;
  const float* dstate;   // (B, H, P, N) contiguous, or null (zeros)
  const void* states;    // S entering each chunk and G leaving it: fp32
  const void* dstates;   // (B, H, nc, P, N), or (pair) bf16 hi + lo
  int pair;              // pairs (B, H, nc, 2, P, N), the tc route's
  float* gb;             // (B, H, nc*Q, P): G B^T
  float* uu;             // (B, H, nc*Q): x_t . G B_t
  float* vv;             // (B, H, nc*Q): dy_q . S C_q
  float* gs;             // (B, H, nc): <G, S>
  float* dcb;            // (B, nc, ngroups, QP, QP): dCB per head group
  float* dap;            // (B, H, nc): dA shares
  void* dx;
  float* ddt;
  float* dA;
  void* dB;
  void* dC;
  int Bsz, H, S, P, N, Q, nc, HG;
  long long xs_b, xs_h, xs_s;     // strides (elements)
  long long ys_b, ys_h, ys_s;     // dy
  long long xg_b, xg_h, xg_s;     // dx
  long long ds_b, ds_h, ds_s;     // dt
  long long es_b, es_h, es_s;     // ddt
  long long bs_b, bs_s, cs_b, cs_s;
  long long dbs_b, dbs_s, dcs_b, dcs_s;
};

// entry e of chunk `chunk`'s (P, N) state (or state gradient) in `st`
__device__ __forceinline__ float state_at(const BwdArgs& a, const void* st,
                                          size_t chunk, int e) {
  const size_t pn = (size_t)a.P * a.N;
  if (a.pair) {
    const bf16* s = static_cast<const bf16*>(st) + chunk * 2 * pn;
    return __bfloat162float(s[e]) + __bfloat162float(s[pn + e]);
  }
  return static_cast<const float*>(st)[chunk * pn + e];
}

// (one warp) cum = cumsum(d * A) and, if cdt, cumsum(d) over n <= 128
// positions (lane l holds 4l..4l+3); returns the total in every lane.
__device__ float warp_cumsum(const float* d, int n, float A, float* cum,
                             float* cdt) {
  const int lane = threadIdx.x & 31;
  float v[4], c[4], run = 0.f, crun = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = 4 * lane + i;
    const float x = t < n ? d[t] : 0.f;
    run += x * A;
    crun += x;
    v[i] = run;
    c[i] = crun;
  }
  float incl = run, cincl = crun;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, off);
    const float cu = __shfl_up_sync(0xffffffffu, cincl, off);
    if (lane >= off) {
      incl += u;
      cincl += cu;
    }
  }
  const float excl = incl - run, cexcl = cincl - crun;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = 4 * lane + i;
    if (t < n) {
      cum[t] = v[i] + excl;
      if (cdt) cdt[t] = c[i] + cexcl;
    }
  }
  __syncwarp();
  return __shfl_sync(0xffffffffu, incl, 31);
}

// a fixed-order sum over the warp (every lane gets it)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// dt of positions [base, base + valid) of (b, h), zeros up to n
__device__ __forceinline__ void load_dt(float* s, const float* dtp,
                                        long long ds_s, int base, int valid,
                                        int n) {
  for (int t = threadIdx.x; t < n; t += BT)
    s[t] = t < valid ? dtp[(base + t) * ds_s] : 0.f;
}

// --------------------------------------------------------- the state pass
//
// Block (b*H + h, 32-row slice of P).  Forward (REV false): the state
// entering each chunk, S_{c+1} = e^total S_c + (x w)^T B, into a.states
// (fp32).  Backward (REV true, K9bs): G_c = e^total G_{c+1} +
// (dy e^cum)^T C from dstate, storing G_{c+1} at c into a.dstates.  Each
// thread holds a 4 x 4 tile of the (PS, N) carry in registers.
template <typename T, bool REV>
__global__ void __launch_bounds__(BT) ssd_pass_kernel(BwdArgs a) {
  extern __shared__ float sm[];
  const int P = a.P, N = a.N, Q = a.Q, S = a.S, nc = a.nc;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int p0 = blockIdx.y * 32, PS = min(32, P - p0);
  float* sU = sm;                 // Q x PS: x w, or dy e^cum
  float* sV = sU + Q * PS;        // Q x N: B, or C
  float* sDt = sV + Q * N;        // Q
  float* sCum = sDt + Q;          // Q
  float* sW = sCum + Q;           // Q
  float* sTot = sW + Q;           // 1

  const int tid = threadIdx.x;
  const int mt = PS / 4, nt = N / 4;
  const bool act = tid < mt * nt;
  const int mi = act ? tid / nt : 0, ni = act ? tid % nt : 0;
  const T* up = static_cast<const T*>(REV ? a.dy : a.x) +
                b * (REV ? a.ys_b : a.xs_b) + h * (REV ? a.ys_h : a.xs_h) +
                p0;
  const long long us = REV ? a.ys_s : a.xs_s;
  const T* vp = static_cast<const T*>(REV ? a.Cm : a.Bm) +
                b * (REV ? a.cs_b : a.bs_b);
  const long long vs = REV ? a.cs_s : a.bs_s;
  const float* dtp = a.dt + b * a.ds_b + h * a.ds_h;
  const float A_h = a.A[h];
  float* out = static_cast<float*>(
      const_cast<void*>(REV ? a.dstates : a.states));

  float st[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + mi + i * mt, n = ni + j * nt;
      st[i][j] = REV && act && a.dstate
                     ? a.dstate[((size_t)(b * a.H + h) * P + p) * N + n]
                     : 0.f;
    }

  for (int k = 0; k < nc; ++k) {
    const int c = REV ? nc - 1 - k : k;
    const int base = c * Q, valid = min(Q, S - base);
    __syncthreads();   // the previous chunk's reads are done
    load_dt(sDt, dtp, a.ds_s, base, valid, Q);
    __syncthreads();
    if (tid < 32) {
      const float total = warp_cumsum(sDt, Q, A_h, sCum, nullptr);
      for (int t = tid; t < Q; t += 32)
        sW[t] = REV ? expf(sCum[t]) : expf(total - sCum[t]) * sDt[t];
      if (tid == 0) sTot[0] = total;
    }
    __syncthreads();
    for (int i = tid; i < Q * PS; i += BT) {
      const int t = i / PS, pp = i % PS;
      sU[i] = t < valid ? to_float(up[(base + t) * us + pp]) * sW[t] : 0.f;
    }
    for (int i = tid; i < Q * N; i += BT) {
      const int t = i / N, n = i % N;
      sV[i] = t < valid ? to_float(vp[(base + t) * vs + n]) : 0.f;
    }
    __syncthreads();
    if (act) {
      float* o = out + ((size_t)(b * a.H + h) * nc + c) * P * N;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          o[(p0 + mi + i * mt) * N + ni + j * nt] = st[i][j];
      float acc[4][4];
      zero(acc);
      mac<4, 4, false, false>(acc, sU, PS, sV, N, mi, mt, ni, nt, Q);
      const float decay = expf(sTot[0]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = decay * st[i][j] + acc[i][j];
    }
  }
}

__host__ __device__ inline size_t pass_smem(int q, int n) {
  return ((size_t)q * 32 + (size_t)q * n + 3 * (size_t)q + 4) * 4;
}

// -------------------------------------------------- K9bg: the state terms

// floats of K9bg's k-tiles, which x and dy replace after the product
__host__ __device__ inline size_t state_floats(int qp, int p) {
  const size_t tiles = (size_t)2 * (qp + p) * (KT + 1);
  const size_t rows = (size_t)2 * qp * p;
  return tiles > rows ? tiles : rows;
}
//
// Block (b*H + h)*nc + c.  G B^T and S C^T over k-tiles of N, each thread
// two 4 x 4 tiles of the (QP, P) products; G B^T to a.gb, x . G B^T and
// dy . S C^T by row (a.uu, a.vv), <G, S> (a.gs), each summed in a fixed
// order.
template <typename T>
__global__ void __launch_bounds__(BT) ssd_bwd_state_kernel(BwdArgs a) {
  extern __shared__ float sm[];
  const int P = a.P, N = a.N, Q = a.Q, S = a.S, nc = a.nc;
  const int QP = bqpad(Q), LK = KT + 1;
  const int c = blockIdx.x % nc, bh = blockIdx.x / nc;
  const int b = bh / a.H, h = bh % a.H;
  const int base = c * Q, valid = min(Q, S - base);
  float* sB = sm;                 // QP x LK
  float* sC = sB + QP * LK;       // QP x LK
  float* sG = sC + QP * LK;       // P x LK
  float* sS = sG + P * LK;        // P x LK
  float* sX = sm;                 // QP x P, after the k-tiles
  float* sDy = sX + QP * P;       // QP x P
  float* sPart = sm + state_floats(QP, P);    // QP x P/4: dy . S C^T
  float* sPartU = sPart + QP * (B_MAX_P / 4); // QP x P/4: x . G B^T
  float* sRed = sPartU + QP * (B_MAX_P / 4);  // 8 warp sums

  const int tid = threadIdx.x;
  const int mt = QP / 4, nt = P / 4, items = mt * nt;
  const size_t chunk = (size_t)bh * nc + c;
  const T* bp = static_cast<const T*>(a.Bm) + b * a.bs_b + base * a.bs_s;
  const T* cp = static_cast<const T*>(a.Cm) + b * a.cs_b + base * a.cs_s;

  float gb[2][4][4], sc[2][4][4];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    zero(gb[s]);
    zero(sc[s]);
  }
  for (int k0 = 0; k0 < N; k0 += KT) {
    const int kt = min(KT, N - k0);
    __syncthreads();
    for (int i = tid; i < QP * kt; i += BT) {
      const int t = i / kt, k = i % kt;
      const bool ok = t < valid;
      sB[t * LK + k] = ok ? to_float(bp[t * a.bs_s + k0 + k]) : 0.f;
      sC[t * LK + k] = ok ? to_float(cp[t * a.cs_s + k0 + k]) : 0.f;
    }
    for (int i = tid; i < P * kt; i += BT) {
      const int p = i / kt, k = i % kt;
      sG[p * LK + k] = state_at(a, a.dstates, chunk, p * N + k0 + k);
      sS[p * LK + k] = state_at(a, a.states, chunk, p * N + k0 + k);
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int item = tid + s * BT;
      if (item >= items) continue;
      const int mi = item / nt, ni = item % nt;
      mac<4, 4, true, true>(gb[s], sB, LK, sG, LK, mi, mt, ni, nt, kt);
      mac<4, 4, true, true>(sc[s], sC, LK, sS, LK, mi, mt, ni, nt, kt);
    }
  }
  __syncthreads();   // the k-tiles are done: x, dy go where B and C were
  const T* xp = static_cast<const T*>(a.x) + b * a.xs_b + h * a.xs_h +
                base * a.xs_s;
  const T* dyp = static_cast<const T*>(a.dy) + b * a.ys_b + h * a.ys_h +
                 base * a.ys_s;
  for (int i = tid; i < QP * P; i += BT) {
    const int t = i / P, p = i % P;
    const bool ok = t < valid;
    sX[i] = ok ? to_float(xp[t * a.xs_s + p]) : 0.f;
    sDy[i] = ok ? to_float(dyp[t * a.ys_s + p]) : 0.f;
  }
  __syncthreads();
  float* gbp = a.gb + ((size_t)bh * nc * Q + base) * P;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int item = tid + s * BT;
    if (item >= items) continue;
    const int mi = item / nt, ni = item % nt;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = mi + i * mt;
      float part = 0.f, part_u = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = ni + j * nt;
        if (t < Q) gbp[t * P + p] = gb[s][i][j];
        part += sDy[t * P + p] * sc[s][i][j];
        part_u += sX[t * P + p] * gb[s][i][j];
      }
      sPart[t * nt + ni] = part;
      sPartU[t * nt + ni] = part_u;
    }
  }
  // <G, S>: each thread a fixed stride of the entries, then the warps
  float gsum = 0.f;
  for (int e = tid; e < P * N; e += BT)
    gsum += state_at(a, a.dstates, chunk, e) * state_at(a, a.states, chunk, e);
  gsum = warp_sum(gsum);
  if ((tid & 31) == 0) sRed[tid >> 5] = gsum;
  __syncthreads();
  for (int t = tid; t < Q; t += BT) {
    float v = 0.f, u = 0.f;
    for (int ni = 0; ni < nt; ++ni) {
      v += sPart[t * nt + ni];
      u += sPartU[t * nt + ni];
    }
    a.vv[(size_t)bh * nc * Q + base + t] = v;
    a.uu[(size_t)bh * nc * Q + base + t] = u;
  }
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < BT / 32; ++w) s += sRed[w];
    a.gs[chunk] = s;
  }
}

__host__ __device__ inline size_t state_smem(int qp, int p) {
  return (state_floats(qp, p) + (size_t)2 * qp * (B_MAX_P / 4) + 8) * 4;
}

// (warp 0) a head's chunk from its per-position sums: dcum_t =
// row_t - col_t + e^cum_t v_t - w_t u_t (+ sum_t w_t u_t + e^total <G, S>
// on the last row), ddt_t = dir_t + e^(total - cum_t) u_t + A sum_{q>=t}
// dcum_q (stored for t < valid), and the chunk's dA share
// sum_t dcum_t cumsum(dt)_t (a.dap); lane l positions 4l..4l+3, every
// sum in a fixed order.
__device__ void finalize_head(const BwdArgs& a, int QP, int valid, int b,
                              int h, int c, const float* sRow,
                              const float* sCol, const float* sDir,
                              const float* sU, const float* sV,
                              const float* sCum, const float* sDt,
                              const float* sCdt, float total, float gs) {
  const int lane = threadIdx.x & 31;
  const size_t bh = (size_t)b * a.H + h;
  float w[4], dc[4], wu = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = 4 * lane + i;
    w[i] = t < QP ? expf(total - sCum[t]) * sDt[t] : 0.f;
    wu += t < QP ? w[i] * sU[t] : 0.f;
  }
  const float dtot = warp_sum(wu) + expf(total) * gs;
  float loc = 0.f, da = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = 4 * lane + i;
    dc[i] = t < QP ? sRow[t] - sCol[t] + expf(sCum[t]) * sV[t] -
                         w[i] * sU[t] + (t == QP - 1 ? dtot : 0.f)
                   : 0.f;
    loc += dc[i];
    da += t < QP ? dc[i] * sCdt[t] : 0.f;
  }
  // suffix sums over the lanes: s = sum of loc over lanes >= lane
  float s = loc;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_down_sync(0xffffffffu, s, off);
    if (lane + off < 32) s += v;
  }
  float rev = s - loc;   // lanes past this one
  const float A_h = a.A[h];
  float* ddtp = a.ddt + b * a.es_b + h * a.es_h + (size_t)c * a.Q * a.es_s;
#pragma unroll
  for (int i = 3; i >= 0; --i) {
    const int t = 4 * lane + i;
    rev += dc[i];
    if (t < valid)
      ddtp[t * a.es_s] = sDir[t] + expf(total - sCum[t]) * sU[t] + A_h * rev;
  }
  da = warp_sum(da);
  if (lane == 0) a.dap[bh * a.nc + c] = da;
}

// ------------------------------------------ K9bx: the per-chunk gradients
//
// Block (b*nc + c)*ngroups + group: chunk c of batch row b for heads
// h0..h0+HG-1, in order.  C B^T (QP x QP) once, into shared memory; per
// head, strips of RS query rows: dAtt = dy x^T (4 x 4 tiles), then per
// entry att, the dCB share (added to the group's dCB in shared memory:
// each entry has one owner thread) and the dcum / ddt partial sums, which
// a second step adds up in a fixed order; dx += att^T dy (4 x 8 tiles, in
// registers over the strips).  Last, warp 0 forms dcum, its reverse
// cumsum, ddt and the chunk's dA share.
template <typename T>
__global__ void __launch_bounds__(BT, 1) ssd_bwd_chunk_kernel(BwdArgs a) {
  extern __shared__ float sm[];
  const int P = a.P, N = a.N, Q = a.Q, S = a.S, nc = a.nc, H = a.H;
  const int QP = bqpad(Q), R = QP < RS ? QP : RS;
  const int LDP = P + 1, LDA = QP + 1;
  const int ngroups = (H + a.HG - 1) / a.HG;
  const int grp = blockIdx.x % ngroups;
  const int c = (blockIdx.x / ngroups) % nc;
  const int b = blockIdx.x / (ngroups * nc);
  const int h0 = grp * a.HG, G = min(a.HG, H - h0);
  const int base = c * Q, valid = min(Q, S - base);
  float* sCB = sm;                     // QP x QP
  float* sDCB = sCB + QP * QP;         // QP x QP
  float* sX = sDCB + QP * QP;          // QP x LDP
  float* sDy = sX + QP * LDP;          // QP x LDP
  float* sAtt = sDy + QP * LDP;        // R x LDA
  float* sRowP = sAtt + R * LDA;       // R x 32
  float* sColP = sRowP + R * 32;       // 8 x QP
  float* sDirP = sColP + 8 * QP;       // 8 x QP
  float* sDt = sDirP + 8 * QP;         // QP each, below
  float* sCum = sDt + QP;
  float* sCdt = sCum + QP;
  float* sRow = sCdt + QP;
  float* sCol = sRow + QP;
  float* sDir = sCol + QP;
  float* sU = sDir + QP;
  float* sV = sU + QP;
  float* sTot = sV + QP;               // 1

  const int tid = threadIdx.x;

  // ---- C B^T over k-tiles of N (C's tile where x goes, B's where dy;
  // tiles no wider than P, so that they fit there)
  {
    const int KC = P < KT ? P : KT;
    const int mt = QP / 8, items = mt * mt;
    const int mi = tid / mt, ni = tid % mt;
    float acc[8][8];
    zero(acc);
    const T* bp = static_cast<const T*>(a.Bm) + b * a.bs_b + base * a.bs_s;
    const T* cp = static_cast<const T*>(a.Cm) + b * a.cs_b + base * a.cs_s;
    for (int k0 = 0; k0 < N; k0 += KC) {
      const int kt = min(KC, N - k0);
      __syncthreads();
      for (int i = tid; i < QP * kt; i += BT) {
        const int t = i / kt, k = i % kt;
        const bool ok = t < valid;
        sX[t * (KC + 1) + k] = ok ? to_float(cp[t * a.cs_s + k0 + k]) : 0.f;
        sDy[t * (KC + 1) + k] = ok ? to_float(bp[t * a.bs_s + k0 + k]) : 0.f;
      }
      __syncthreads();
      if (tid < items)
        mac<8, 8, true, true>(acc, sX, KC + 1, sDy, KC + 1, mi, mt, ni, mt,
                              kt);
    }
    if (tid < items)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          sCB[(mi + i * mt) * QP + ni + j * mt] = acc[i][j];
    for (int i = tid; i < QP * QP; i += BT) sDCB[i] = 0.f;
  }

  // dx tiles: 4 rows (t) x 8 columns (p)
  const int dmt = QP / 4, dnt = P / 8, ditems = dmt * dnt;
  const int dmi = tid < ditems ? tid / dnt : 0;
  const int dni = tid < ditems ? tid % dnt : 0;

  for (int g = 0; g < G; ++g) {
    const int h = h0 + g;
    const size_t bh = (size_t)b * H + h;
    const float A_h = a.A[h];
    __syncthreads();   // the previous head (or C B^T) is done
    load_dt(sDt, a.dt + b * a.ds_b + h * a.ds_h, a.ds_s, base, valid, QP);
    {
      const T* xp = static_cast<const T*>(a.x) + b * a.xs_b + h * a.xs_h +
                    base * a.xs_s;
      const T* yp = static_cast<const T*>(a.dy) + b * a.ys_b + h * a.ys_h +
                    base * a.ys_s;
      for (int i = tid; i < QP * P; i += BT) {
        const int t = i / P, p = i % P;
        const bool ok = t < valid;
        sX[t * LDP + p] = ok ? to_float(xp[t * a.xs_s + p]) : 0.f;
        sDy[t * LDP + p] = ok ? to_float(yp[t * a.ys_s + p]) : 0.f;
      }
    }
    for (int t = tid; t < QP; t += BT) {
      sU[t] = t < Q ? a.uu[bh * nc * Q + base + t] : 0.f;
      sV[t] = t < Q ? a.vv[bh * nc * Q + base + t] : 0.f;
      sCol[t] = 0.f;
      sDir[t] = 0.f;
    }
    __syncthreads();
    if (tid < 32) {
      const float total = warp_cumsum(sDt, QP, A_h, sCum, sCdt);
      if (tid == 0) sTot[0] = total;
    }
    const float* gbp = a.gb + (bh * nc * Q + base) * P;
    __syncthreads();

    float dx[4][8];
    zero(dx);
    for (int r0 = 0; r0 < QP; r0 += R) {
      const int ncols = r0 + R;
      const int smt = R / 4, snt = ncols / 4;
      if (tid < smt * snt) {
        const int mi = tid / snt, ni = tid % snt;
        float acc[4][4];
        zero(acc);
        mac<4, 4, true, true>(acc, sDy + r0 * LDP, LDP, sX, LDP, mi, smt, ni,
                              snt, P);
        float colp[4] = {0.f, 0.f, 0.f, 0.f}, dirp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = r0 + mi + i * smt;
          const float cq = sCum[q];
          float rowp = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int t = ni + j * snt;
            float at = 0.f, dcb = 0.f, dr = 0.f;
            if (t <= q) {   // select: e^(cq - cum_t) overflows above
              const float e = expf(cq - sCum[t]), cb = sCB[q * QP + t];
              const float d = sDt[t];
              at = cb * e * d;
              dcb = acc[i][j] * e * d;
              dr = acc[i][j] * cb * e;
            }
            sAtt[(q - r0) * LDA + t] = at;
            sDCB[q * QP + t] += dcb;
            const float da = acc[i][j] * at;
            rowp += da;
            colp[j] += da;
            dirp[j] += dr;
          }
          sRowP[(q - r0) * 32 + ni] = rowp;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sColP[mi * QP + ni + j * snt] = colp[j];
          sDirP[mi * QP + ni + j * snt] = dirp[j];
        }
      }
      // att columns past this strip's last row are zero
      for (int i = tid; i < R * (QP - ncols); i += BT)
        sAtt[(i / (QP - ncols)) * LDA + ncols + i % (QP - ncols)] = 0.f;
      __syncthreads();
      for (int r = tid; r < R; r += BT) {
        float s = 0.f;
        for (int ni = 0; ni < snt; ++ni) s += sRowP[r * 32 + ni];
        sRow[r0 + r] = s;
      }
      for (int t = tid; t < ncols; t += BT) {
        float s = 0.f, d = 0.f;
        for (int mi = 0; mi < smt; ++mi) {
          s += sColP[mi * QP + t];
          d += sDirP[mi * QP + t];
        }
        sCol[t] += s;
        sDir[t] += d;
      }
      if (tid < ditems)
        mac<4, 8, false, false>(dx, sAtt, LDA, sDy + r0 * LDP, LDP, dmi, dmt,
                                dni, dnt, R);
      __syncthreads();   // sAtt and the partials are rewritten next strip
    }

    const float total = sTot[0];
    // dx = att^T dy + w_t (G B^T)_t
    if (tid < ditems) {
      T* dxp = static_cast<T*>(a.dx) + b * a.xg_b + h * a.xg_h +
               base * a.xg_s;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = dmi + i * dmt;
        if (t >= valid) continue;
        const float w = expf(total - sCum[t]) * sDt[t];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int p = dni + j * dnt;
          dxp[t * a.xg_s + p] = from_float<T>(dx[i][j] + w * gbp[t * P + p]);
        }
      }
    }
    if (tid < 32)
      finalize_head(a, QP, valid, b, h, c, sRow, sCol, sDir, sU, sV, sCum,
                    sDt, sCdt, total, a.gs[bh * nc + c]);
  }
  __syncthreads();
  float* out = a.dcb + (size_t)blockIdx.x * QP * QP;
  for (int i = tid; i < QP * QP; i += BT) out[i] = sDCB[i];
}

__host__ __device__ inline size_t chunk_smem(int qp, int p) {
  const int r = qp < RS ? qp : RS;
  return ((size_t)2 * qp * qp + (size_t)2 * qp * (p + 1) +
          (size_t)r * (qp + 1) + (size_t)r * 32 + (size_t)16 * qp +
          (size_t)8 * qp + 4) * 4;
}

// ------------------------- K9bx on the tensor cores (tc), K9bg folded in
//
// The tc route's per-chunk gradients (bf16, P and N multiples of 16, S
// and G the scratches' hi + lo pairs): block (b*nc + c)*ngroups + group,
// 8 warps.  Warp w owns the chunk's 16-row tile w twice: as query rows q
// (row pass, key tiles jp <= w) and as key rows t (column pass, query
// tiles jq >= w), so each warp does 9 of the causal tile products at
// Q = 128.  C and B load once; per head, in order, x, dy, dt and S's and
// G's pairs by cp.async, warp 0 scans cum, then on mma.sync:
//   row pass: C.B^T and dy.x^T tiles; att, the row sums of dAtt.att,
//     and dCB = dAtt e^(cum_q - cum_t) dt_t summed over the group's heads
//     in registers; S C^T (the pair: two products) and v = dy . S C^T;
//   column pass: B.C^T and x.dy^T tiles; att^T, its row sums (the column
//     sums of dAtt.att) and the direct ddt term; dx += att^T dy, att^T
//     split hi + lo; G B^T (the pair), u = x . G B^T, dx += w G B^T,
//     stored;
//   warp 0: finalize_head.
// The group's dCB is written once, as K9bc's fp32 partial.
__host__ __device__ inline size_t chunk_tc_smem(int qp, int p, int n) {
  const size_t halves = (size_t)2 * qp * (n + 8) + (size_t)2 * qp * (p + 8) +
                        (size_t)4 * p * (n + 8);
  return halves * 2 + ((size_t)8 * qp + 16) * 4;
}

__global__ void __launch_bounds__(BT, 1) ssd_bwd_chunk_tc_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int P = a.P, N = a.N, Q = a.Q, S = a.S, nc = a.nc, H = a.H;
  const int QP = qpad16(Q), DQ = bqpad(Q), NT16 = QP / 16;
  const int LDN = N + 8, LDP = P + 8;
  const int ngroups = (H + a.HG - 1) / a.HG;
  const int grp = blockIdx.x % ngroups;
  const int c = (blockIdx.x / ngroups) % nc;
  const int b = blockIdx.x / (ngroups * nc);
  const int h0 = grp * a.HG, G = min(a.HG, H - h0);
  const int base = c * Q, valid = min(Q, S - base);
  const size_t pn = (size_t)P * N;
  bf16* sC = reinterpret_cast<bf16*>(smem_raw);   // QP x LDN
  bf16* sB = sC + QP * LDN;                       // QP x LDN
  bf16* sX = sB + QP * LDN;                       // QP x LDP
  bf16* sY = sX + QP * LDP;                       // QP x LDP: dy
  bf16* sSh = sY + QP * LDP;                      // P x LDN, each pair half
  bf16* sSl = sSh + P * LDN;
  bf16* sGh = sSl + P * LDN;
  bf16* sGl = sGh + P * LDN;
  float* sDt = reinterpret_cast<float*>(sGl + P * LDN);   // QP each
  float* sCum = sDt + QP;
  float* sCdt = sCum + QP;
  float* sRow = sCdt + QP;
  float* sCol = sRow + QP;
  float* sDir = sCol + QP;
  float* sU = sDir + QP;
  float* sV = sU + QP;
  float* sRed = sV + QP;       // 8 warp sums of <G, S>
  float* sTot = sRed + 8;      // total, <G, S>

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int m = warp;
  const bool active = m < NT16;
  const int r0 = 16 * m + gq, r1 = r0 + 8;

  cp_rows(sC, LDN, static_cast<const bf16*>(a.Cm) + b * a.cs_b +
          base * a.cs_s, a.cs_s, QP, valid, N);
  cp_rows(sB, LDN, static_cast<const bf16*>(a.Bm) + b * a.bs_b +
          base * a.bs_s, a.bs_s, QP, valid, N);
  cp_async_commit();

  float dcb[16][4];   // dCB rows r0, r1, key columns 8j..8j+7 (j = n8 tile)
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dcb[j][e] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = h0 + g;
    const size_t chunk = ((size_t)b * H + h) * nc + c;
    __syncthreads();   // the previous head is done with every buffer
    cp_rows(sX, LDP, static_cast<const bf16*>(a.x) + b * a.xs_b +
            h * a.xs_h + base * a.xs_s, a.xs_s, QP, valid, P);
    cp_rows(sY, LDP, static_cast<const bf16*>(a.dy) + b * a.ys_b +
            h * a.ys_h + base * a.ys_s, a.ys_s, QP, valid, P);
    const bf16* sp = static_cast<const bf16*>(a.states) + chunk * 2 * pn;
    const bf16* gp = static_cast<const bf16*>(a.dstates) + chunk * 2 * pn;
    cp_rows(sSh, LDN, sp, N, P, P, N);
    cp_rows(sSl, LDN, sp + pn, N, P, P, N);
    cp_rows(sGh, LDN, gp, N, P, P, N);
    cp_rows(sGl, LDN, gp + pn, N, P, P, N);
    {
      const float* dtp = a.dt + b * a.ds_b + h * a.ds_h + base * a.ds_s;
      for (int t = tid; t < QP; t += BT) {
        const bool ok = t < valid;
        cp_async4(sDt + t, ok ? dtp + t * a.ds_s : a.dt, ok);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (warp == 0) {
      const float total = warp_cumsum(sDt, QP, a.A[h], sCum, sCdt);
      if (lane == 0) sTot[0] = total;
    }
    {   // <G, S>, each thread a fixed stride of the entries, then the warps
      float gs = 0.f;
      for (int e = tid; e < P * N; e += BT) {
        const int i = (e / N) * LDN + e % N;
        gs += (__bfloat162float(sGh[i]) + __bfloat162float(sGl[i])) *
              (__bfloat162float(sSh[i]) + __bfloat162float(sSl[i]));
      }
      gs = warp_sum(gs);
      if (lane == 0) sRed[warp] = gs;
    }
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int w = 0; w < BT / 32; ++w) s += sRed[w];
      sTot[1] = s;
    }
    const float total = sTot[0];
    if (active) {
      const float c0 = sCum[r0], c1 = sCum[r1];
      const float d0 = sDt[r0], d1 = sDt[r1];
      // ---- row pass: query rows r0, r1; key tiles jp <= m
      float rowp[2] = {0.f, 0.f};
#pragma unroll
      for (int jp = 0; jp < 8; ++jp) {
        if (jp > m) break;
        float cbt[2][4], dat[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) cbt[j][e] = dat[j][e] = 0.f;
        for (int kk = 0; kk < N / 16; ++kk) {
          uint32_t af[4], bb[4];
          ldsm_x4(af, a_addr(sC, LDN, 16 * m, 16 * kk, lane));
          ldsm_x4(bb, b_addr(sB, LDN, 16 * jp, 16 * kk, lane));
          mma_bf16(cbt[0], af, bb[0], bb[1]);
          mma_bf16(cbt[1], af, bb[2], bb[3]);
        }
        for (int kk = 0; kk < P / 16; ++kk) {
          uint32_t af[4], bb[4];
          ldsm_x4(af, a_addr(sY, LDP, 16 * m, 16 * kk, lane));
          ldsm_x4(bb, b_addr(sX, LDP, 16 * jp, 16 * kk, lane));
          mma_bf16(dat[0], af, bb[0], bb[1]);
          mma_bf16(dat[1], af, bb[2], bb[3]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = 16 * jp + 8 * j + 2 * tq + (e & 1);
            const int q = e < 2 ? r0 : r1;
            if (t <= q) {   // select: e^(cum_q - cum_t) overflows above
              const float dec = expf((e < 2 ? c0 : c1) - sCum[t]);
              const float d = sDt[t];
              rowp[e >> 1] += dat[j][e] * cbt[j][e] * dec * d;
              dcb[2 * jp + j][e] += dat[j][e] * dec * d;
            }
          }
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        rowp[k] += __shfl_xor_sync(0xffffffffu, rowp[k], 1);
        rowp[k] += __shfl_xor_sync(0xffffffffu, rowp[k], 2);
      }
      // S C^T (the pair) for rows r0, r1, and v = dy . S C^T
      {
        float sc[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
        for (int kk = 0; kk < N / 16; ++kk) {
          uint32_t af[4];
          ldsm_x4(af, a_addr(sC, LDN, 16 * m, 16 * kk, lane));
#pragma unroll
          for (int pp = 0; pp < 4; ++pp) {
            if (16 * pp >= P) break;
            uint32_t bh[4], bl[4];
            ldsm_x4(bh, b_addr(sSh, LDN, 16 * pp, 16 * kk, lane));
            ldsm_x4(bl, b_addr(sSl, LDN, 16 * pp, 16 * kk, lane));
            mma_bf16(sc[2 * pp], af, bh[0], bh[1]);
            mma_bf16(sc[2 * pp + 1], af, bh[2], bh[3]);
            mma_bf16(sc[2 * pp], af, bl[0], bl[1]);
            mma_bf16(sc[2 * pp + 1], af, bl[2], bl[3]);
          }
        }
        float vp[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (8 * j >= P) break;
          const int col = 8 * j + 2 * tq;
          const float2 y0 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(sY + r0 * LDP + col));
          const float2 y1 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(sY + r1 * LDP + col));
          vp[0] += y0.x * sc[j][0] + y0.y * sc[j][1];
          vp[1] += y1.x * sc[j][2] + y1.y * sc[j][3];
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          vp[k] += __shfl_xor_sync(0xffffffffu, vp[k], 1);
          vp[k] += __shfl_xor_sync(0xffffffffu, vp[k], 2);
        }
        if (tq == 0) {
          sRow[r0] = rowp[0];
          sRow[r1] = rowp[1];
          sV[r0] = vp[0];
          sV[r1] = vp[1];
        }
      }

      // ---- column pass: key rows t = r0, r1; query tiles jq >= m
      float dx[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dx[j][e] = 0.f;
      float colp[2] = {0.f, 0.f}, dirp[2] = {0.f, 0.f};
      for (int jq = m; jq < NT16; ++jq) {
        float cbt[2][4], dat[2][4], at[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) cbt[j][e] = dat[j][e] = 0.f;
        for (int kk = 0; kk < N / 16; ++kk) {
          uint32_t af[4], bb[4];
          ldsm_x4(af, a_addr(sB, LDN, 16 * m, 16 * kk, lane));
          ldsm_x4(bb, b_addr(sC, LDN, 16 * jq, 16 * kk, lane));
          mma_bf16(cbt[0], af, bb[0], bb[1]);
          mma_bf16(cbt[1], af, bb[2], bb[3]);
        }
        for (int kk = 0; kk < P / 16; ++kk) {
          uint32_t af[4], bb[4];
          ldsm_x4(af, a_addr(sX, LDP, 16 * m, 16 * kk, lane));
          ldsm_x4(bb, b_addr(sY, LDP, 16 * jq, 16 * kk, lane));
          mma_bf16(dat[0], af, bb[0], bb[1]);
          mma_bf16(dat[1], af, bb[2], bb[3]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = 16 * jq + 8 * j + 2 * tq + (e & 1);
            const int t = e < 2 ? r0 : r1;
            at[j][e] = 0.f;
            if (q >= t) {   // select: e^(cum_q - cum_t) overflows below
              const float dec = expf(sCum[q] - (e < 2 ? c0 : c1));
              at[j][e] = cbt[j][e] * dec * (e < 2 ? d0 : d1);
              colp[e >> 1] += dat[j][e] * at[j][e];
              dirp[e >> 1] += dat[j][e] * cbt[j][e] * dec;
            }
          }
        // dx += att^T dy: att^T's tile as the A operand of one k16 step
        uint32_t hi[4], lo[4];
        split_frag(at[0], at[1], hi, lo);
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          if (16 * pp >= P) break;
          uint32_t bx[4];
          ldsm_x4_t(bx, bt_addr(sY, LDP, 16 * jq, 16 * pp, lane));
          mma_pair(dx[2 * pp], dx[2 * pp + 1], hi, lo, bx);
        }
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        colp[k] += __shfl_xor_sync(0xffffffffu, colp[k], 1);
        colp[k] += __shfl_xor_sync(0xffffffffu, colp[k], 2);
        dirp[k] += __shfl_xor_sync(0xffffffffu, dirp[k], 1);
        dirp[k] += __shfl_xor_sync(0xffffffffu, dirp[k], 2);
      }
      // G B^T (the pair) for rows t, u = x . G B^T, dx += w G B^T
      {
        float gb[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) gb[j][e] = 0.f;
        for (int kk = 0; kk < N / 16; ++kk) {
          uint32_t af[4];
          ldsm_x4(af, a_addr(sB, LDN, 16 * m, 16 * kk, lane));
#pragma unroll
          for (int pp = 0; pp < 4; ++pp) {
            if (16 * pp >= P) break;
            uint32_t bh[4], bl[4];
            ldsm_x4(bh, b_addr(sGh, LDN, 16 * pp, 16 * kk, lane));
            ldsm_x4(bl, b_addr(sGl, LDN, 16 * pp, 16 * kk, lane));
            mma_bf16(gb[2 * pp], af, bh[0], bh[1]);
            mma_bf16(gb[2 * pp + 1], af, bh[2], bh[3]);
            mma_bf16(gb[2 * pp], af, bl[0], bl[1]);
            mma_bf16(gb[2 * pp + 1], af, bl[2], bl[3]);
          }
        }
        const float w0 = expf(total - c0) * d0, w1 = expf(total - c1) * d1;
        float up[2] = {0.f, 0.f};
        bf16* dxp = static_cast<bf16*>(a.dx) + b * a.xg_b + h * a.xg_h +
                    base * a.xg_s;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (8 * j >= P) break;
          const int col = 8 * j + 2 * tq;
          const float2 x0 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(sX + r0 * LDP + col));
          const float2 x1 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(sX + r1 * LDP + col));
          up[0] += x0.x * gb[j][0] + x0.y * gb[j][1];
          up[1] += x1.x * gb[j][2] + x1.y * gb[j][3];
          if (r0 < valid)
            *reinterpret_cast<__nv_bfloat162*>(dxp + r0 * a.xg_s + col) =
                __floats2bfloat162_rn(dx[j][0] + w0 * gb[j][0],
                                      dx[j][1] + w0 * gb[j][1]);
          if (r1 < valid)
            *reinterpret_cast<__nv_bfloat162*>(dxp + r1 * a.xg_s + col) =
                __floats2bfloat162_rn(dx[j][2] + w1 * gb[j][2],
                                      dx[j][3] + w1 * gb[j][3]);
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          up[k] += __shfl_xor_sync(0xffffffffu, up[k], 1);
          up[k] += __shfl_xor_sync(0xffffffffu, up[k], 2);
        }
        if (tq == 0) {
          sCol[r0] = colp[0];
          sCol[r1] = colp[1];
          sDir[r0] = dirp[0];
          sDir[r1] = dirp[1];
          sU[r0] = up[0];
          sU[r1] = up[1];
        }
      }
    }
    __syncthreads();
    if (warp == 0)
      finalize_head(a, QP, valid, b, h, c, sRow, sCol, sDir, sU, sV, sCum,
                    sDt, sCdt, total, sTot[1]);
  }
  // the group's dCB (zeros above the diagonal tile), K9bc's partial
  if (active) {
    float* out = a.dcb + (size_t)blockIdx.x * DQ * DQ;
#pragma unroll
    for (int jp = 0; jp < 8; ++jp) {
      if (jp >= NT16) break;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 16 * jp + 8 * j + 2 * tq;
        const bool on = jp <= m;
        out[r0 * DQ + col] = on ? dcb[2 * jp + j][0] : 0.f;
        out[r0 * DQ + col + 1] = on ? dcb[2 * jp + j][1] : 0.f;
        out[r1 * DQ + col] = on ? dcb[2 * jp + j][2] : 0.f;
        out[r1 * DQ + col + 1] = on ? dcb[2 * jp + j][3] : 0.f;
      }
    }
  }
}

// ------------------------------------------------------ K9bc: dB and dC

// floats of K9bc's two phases' buffers, which share the same memory
__host__ __device__ inline size_t bc_floats(int qp, int p) {
  const size_t ph1 = (size_t)qp * (qp + 1) + (size_t)2 * qp * NTILE;
  const size_t ph2 = (size_t)2 * qp * (p + 1) + (size_t)2 * B_MAX_P * NTILE;
  return ph1 > ph2 ? ph1 : ph2;
}
//
// Block (b*nc + c)*ntiles + tile: rows of chunk c, N columns n0..n0+NW.
// First the groups' dCB summed in order, times B (dC) and, transposed,
// times C (dB); then per head in order (e^cum dy) S and (w x) G over P.
// Each thread holds 4 x 8 tiles of both outputs.
template <typename T>
__global__ void __launch_bounds__(BT, 1) ssd_bwd_bc_kernel(BwdArgs a) {
  extern __shared__ float sm[];
  const int P = a.P, N = a.N, Q = a.Q, S = a.S, nc = a.nc, H = a.H;
  const int QP = bqpad(Q), LDD = QP + 1, LDP = P + 1;
  const int ntiles = (N + NTILE - 1) / NTILE;
  const int tile = blockIdx.x % ntiles;
  const int c = (blockIdx.x / ntiles) % nc;
  const int b = blockIdx.x / (ntiles * nc);
  const int n0 = tile * NTILE, NW = min(NTILE, N - n0);
  const int base = c * Q, valid = min(Q, S - base);
  const int ngroups = (H + a.HG - 1) / a.HG;
  // phase 1
  float* sD = sm;                      // QP x LDD
  float* sBt = sD + QP * LDD;          // QP x NW
  float* sCt = sBt + QP * NTILE;       // QP x NW
  // phase 2 (over phase 1)
  float* sXs = sm;                     // QP x LDP
  float* sYs = sXs + QP * LDP;         // QP x LDP
  float* sG = sYs + QP * LDP;          // P x NW
  float* sS = sG + B_MAX_P * NTILE;    // P x NW
  float* sDt = sm + bc_floats(QP, P);  // QP each, past both phases
  float* sCum = sDt + QP;
  float* sW = sCum + QP;
  float* sE = sW + QP;

  const int tid = threadIdx.x;
  const int mt = QP / 4, nt = NW / 8;
  const bool act = tid < mt * nt;
  const int mi = act ? tid / nt : 0, ni = act ? tid % nt : 0;
  float dC[4][8], dB[4][8];
  zero(dC);
  zero(dB);

  {
    const float* part = a.dcb + ((size_t)(b * nc + c) * ngroups) * QP * QP;
    for (int i = tid; i < QP * QP; i += BT) {
      float s = 0.f;
      for (int g = 0; g < ngroups; ++g) s += part[(size_t)g * QP * QP + i];
      sD[(i / QP) * LDD + i % QP] = s;
    }
    const T* bp = static_cast<const T*>(a.Bm) + b * a.bs_b + base * a.bs_s;
    const T* cp = static_cast<const T*>(a.Cm) + b * a.cs_b + base * a.cs_s;
    for (int i = tid; i < QP * NW; i += BT) {
      const int t = i / NW, n = i % NW;
      const bool ok = t < valid;
      sBt[i] = ok ? to_float(bp[t * a.bs_s + n0 + n]) : 0.f;
      sCt[i] = ok ? to_float(cp[t * a.cs_s + n0 + n]) : 0.f;
    }
    __syncthreads();
    if (act) {
      mac<4, 8, true, false>(dC, sD, LDD, sBt, NW, mi, mt, ni, nt, QP);
      mac<4, 8, false, false>(dB, sD, LDD, sCt, NW, mi, mt, ni, nt, QP);
    }
  }

  for (int h = 0; h < H; ++h) {
    const size_t chunk = ((size_t)b * H + h) * nc + c;
    __syncthreads();   // the previous head's (or phase 1's) reads are done
    load_dt(sDt, a.dt + b * a.ds_b + h * a.ds_h, a.ds_s, base, valid, QP);
    __syncthreads();
    if (tid < 32) {
      const float total = warp_cumsum(sDt, QP, a.A[h], sCum, nullptr);
      for (int t = tid; t < QP; t += 32) {
        sW[t] = expf(total - sCum[t]) * sDt[t];
        sE[t] = expf(sCum[t]);
      }
    }
    __syncthreads();
    const T* xp = static_cast<const T*>(a.x) + b * a.xs_b + h * a.xs_h +
                  base * a.xs_s;
    const T* yp = static_cast<const T*>(a.dy) + b * a.ys_b + h * a.ys_h +
                  base * a.ys_s;
    for (int i = tid; i < QP * P; i += BT) {
      const int t = i / P, p = i % P;
      const bool ok = t < valid;
      sXs[t * LDP + p] = ok ? to_float(xp[t * a.xs_s + p]) * sW[t] : 0.f;
      sYs[t * LDP + p] = ok ? to_float(yp[t * a.ys_s + p]) * sE[t] : 0.f;
    }
    for (int i = tid; i < P * NW; i += BT) {
      const int p = i / NW, n = i % NW;
      sG[i] = state_at(a, a.dstates, chunk, p * N + n0 + n);
      sS[i] = state_at(a, a.states, chunk, p * N + n0 + n);
    }
    __syncthreads();
    if (act) {
      mac<4, 8, true, false>(dC, sYs, LDP, sS, NW, mi, mt, ni, nt, P);
      mac<4, 8, true, false>(dB, sXs, LDP, sG, NW, mi, mt, ni, nt, P);
    }
  }

  if (act) {
    T* cp = static_cast<T*>(a.dC) + b * a.dcs_b + base * a.dcs_s + n0;
    T* bp = static_cast<T*>(a.dB) + b * a.dbs_b + base * a.dbs_s + n0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = mi + i * mt;
      if (t >= valid) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = ni + j * nt;
        cp[t * a.dcs_s + n] = from_float<T>(dC[i][j]);
        bp[t * a.dbs_s + n] = from_float<T>(dB[i][j]);
      }
    }
  }
}

__host__ __device__ inline size_t bc_smem(int qp, int p) {
  return (bc_floats(qp, p) + 4 * (size_t)qp) * 4;
}

// ------------------------------------------ K9bc on the tensor cores (tc)
//
// The tc route's K9bc (bf16, P and N multiples of 16, S and G as the
// scratches' hi + lo pairs): block (b*nc + c)*ntiles + tile, 8 warps,
// warp w the chunk's rows 16w..16w+15, N columns n0..n0+tcn (64, else
// 32, else 16: the widest that divides N).  Per head in order, dC += (e^cum dy) S and
// dB += (w x) G on mma.sync: dy's and x's rows scaled in registers and
// split into bf16 hi + lo, times S's and G's pairs, three products each
// (hi.hi, hi.lo, lo.hi); each warp scans the head's dt itself (no block
// barrier for it), and the next head's rows and pair tiles load by
// cp.async meanwhile.  Then dCB (the groups' partials summed in order,
// fp32 in shared memory, split hi + lo) times B and, transposed, times C.

__host__ __device__ inline int bc_tc_cols(int n) {
  return n % 64 == 0 ? 64 : n % 32 == 0 ? 32 : 16;
}

// bytes of one head's buffer: x and dy rows, G's and S's pair tiles, dt
__host__ __device__ inline size_t bc_tc_buf(int qp, int p, int tcn) {
  return ((size_t)2 * qp * (p + 8) + (size_t)4 * p * (tcn + 8)) * 2 +
         (size_t)qp * 4;
}

__host__ __device__ inline size_t bc_tc_smem(int qp, int p, int tcn) {
  const size_t heads = 2 * bc_tc_buf(qp, p, tcn);
  const size_t intra = (size_t)qp * (qp + 1) * 4 + (size_t)2 * qp * (tcn + 8) * 2;
  return heads > intra ? heads : intra;
}

__global__ void __launch_bounds__(BT, 1) ssd_bwd_bc_tc_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int P = a.P, N = a.N, Q = a.Q, S = a.S, nc = a.nc, H = a.H;
  const int QP = qpad16(Q), DQ = bqpad(Q), LDD = QP + 1;
  const int tcn = bc_tc_cols(N), ntiles = N / tcn;
  const int LDP = P + 8, LDT = tcn + 8;
  const int tile = blockIdx.x % ntiles;
  const int c = (blockIdx.x / ntiles) % nc;
  const int b = blockIdx.x / (ntiles * nc);
  const int n0 = tile * tcn;
  const int base = c * Q, valid = min(Q, S - base);
  const int ngroups = (H + a.HG - 1) / a.HG;
  const size_t buf_bytes = bc_tc_buf(QP, P, tcn);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const bool active = 16 * warp < QP;
  const int r0 = 16 * warp + gq, r1 = r0 + 8;
  const size_t pn = (size_t)P * N;
  const bf16* sg = static_cast<const bf16*>(a.states);
  const bf16* gg = static_cast<const bf16*>(a.dstates);

  auto xbuf = [&](int i) {
    return reinterpret_cast<bf16*>(smem_raw + i * buf_bytes);
  };
  // buffer i: x, dy (QP x LDP), G hi, G lo, S hi, S lo (P x LDT), dt (QP)
  auto load_head = [&](int h, int i) {
    bf16* sx = xbuf(i);
    bf16* sy = sx + QP * LDP;
    bf16* pair = sy + QP * LDP;
    cp_rows(sx, LDP, static_cast<const bf16*>(a.x) + b * a.xs_b +
            h * a.xs_h + base * a.xs_s, a.xs_s, QP, valid, P);
    cp_rows(sy, LDP, static_cast<const bf16*>(a.dy) + b * a.ys_b +
            h * a.ys_h + base * a.ys_s, a.ys_s, QP, valid, P);
    const size_t off = (((size_t)b * H + h) * nc + c) * 2 * pn + n0;
    cp_rows(pair, LDT, gg + off, N, P, P, tcn);
    cp_rows(pair + P * LDT, LDT, gg + off + pn, N, P, P, tcn);
    cp_rows(pair + 2 * P * LDT, LDT, sg + off, N, P, P, tcn);
    cp_rows(pair + 3 * P * LDT, LDT, sg + off + pn, N, P, P, tcn);
    float* sdt = reinterpret_cast<float*>(pair + 4 * P * LDT);
    const float* dtp = a.dt + b * a.ds_b + h * a.ds_h + base * a.ds_s;
    for (int t = tid; t < QP; t += BT) {
      const bool ok = t < valid;
      cp_async4(sdt + t, ok ? dtp + t * a.ds_s : a.dt, ok);
    }
    cp_async_commit();
  };

  float dC[8][4], dB[8][4];   // n8 tiles of the tcn <= 64 columns
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dC[j][e] = dB[j][e] = 0.f;

  load_head(0, 0);
  for (int h = 0; h < H; ++h) {
    const int i = h & 1;
    cp_async_wait<0>();
    __syncthreads();   // head h has landed; head h - 1 is done everywhere
    if (h + 1 < H) load_head(h + 1, i ^ 1);
    if (!active) continue;
    const bf16* sx = xbuf(i);
    const bf16* sy = sx + QP * LDP;
    const bf16* pair = sy + QP * LDP;
    const float* sdt = reinterpret_cast<const float*>(pair + 4 * P * LDT);
    // cum = cumsum(dt * A) over the chunk, lane l positions 4l..4l+3; the
    // factors of this thread's rows r0, r1: e^cum and w = e^(total-cum) dt
    const float A_h = a.A[h];
    float v[4], run = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int t = 4 * lane + k;
      run += t < QP ? sdt[t] * A_h : 0.f;
      v[k] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += u;
    }
    const float excl = incl - run;
    const float total = __shfl_sync(0xffffffffu, incl, 31);
    float cr[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = j ? r1 : r0;
      float got[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        got[k] = __shfl_sync(0xffffffffu, v[k] + excl, r >> 2);
      const int k = r & 3;
      cr[j] = k == 0 ? got[0] : k == 1 ? got[1] : k == 2 ? got[2] : got[3];
    }
    const float e0 = expf(cr[0]), e1 = expf(cr[1]);
    const float w0 = expf(total - cr[0]) * sdt[r0];
    const float w1 = expf(total - cr[1]) * sdt[r1];
    const bf16* gh = pair;
    const bf16* gl = pair + P * LDT;
    const bf16* sh = pair + 2 * P * LDT;
    const bf16* sl = pair + 3 * P * LDT;
    for (int kk = 0; kk < P / 16; ++kk) {
      uint32_t ya[4], xa[4], yh[4], yl[4], xh[4], xl[4];
      ldsm_x4(ya, a_addr(sy, LDP, 16 * warp, 16 * kk, lane));
      ldsm_x4(xa, a_addr(sx, LDP, 16 * warp, 16 * kk, lane));
      // a0, a2: row r0; a1, a3: row r1
      scale_split(ya[0], make_float2(e0, e0), yh[0], yl[0]);
      scale_split(ya[1], make_float2(e1, e1), yh[1], yl[1]);
      scale_split(ya[2], make_float2(e0, e0), yh[2], yl[2]);
      scale_split(ya[3], make_float2(e1, e1), yh[3], yl[3]);
      scale_split(xa[0], make_float2(w0, w0), xh[0], xl[0]);
      scale_split(xa[1], make_float2(w1, w1), xh[1], xl[1]);
      scale_split(xa[2], make_float2(w0, w0), xh[2], xl[2]);
      scale_split(xa[3], make_float2(w1, w1), xh[3], xl[3]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (16 * np >= tcn) break;
        uint32_t bh[4], bl[4];
        ldsm_x4_t(bh, bt_addr(sh, LDT, 16 * kk, 16 * np, lane));
        ldsm_x4_t(bl, bt_addr(sl, LDT, 16 * kk, 16 * np, lane));
        mma_pair(dC[2 * np], dC[2 * np + 1], yh, yl, bh);
        mma_bf16(dC[2 * np], yh, bl[0], bl[1]);
        mma_bf16(dC[2 * np + 1], yh, bl[2], bl[3]);
        ldsm_x4_t(bh, bt_addr(gh, LDT, 16 * kk, 16 * np, lane));
        ldsm_x4_t(bl, bt_addr(gl, LDT, 16 * kk, 16 * np, lane));
        mma_pair(dB[2 * np], dB[2 * np + 1], xh, xl, bh);
        mma_bf16(dB[2 * np], xh, bl[0], bl[1]);
        mma_bf16(dB[2 * np + 1], xh, bl[2], bl[3]);
      }
    }
  }

  // the intra-chunk terms: dCB (fp32, the groups summed in order) times B
  // for dC, transposed times C for dB; B's and C's tiles by cp.async
  cp_async_wait<0>();
  __syncthreads();   // every head's buffers are free
  float* sD = reinterpret_cast<float*>(smem_raw);
  bf16* sBt = reinterpret_cast<bf16*>(sD + QP * LDD);
  bf16* sCt = sBt + QP * LDT;
  cp_rows(sBt, LDT, static_cast<const bf16*>(a.Bm) + b * a.bs_b +
          base * a.bs_s + n0, a.bs_s, QP, valid, tcn);
  cp_rows(sCt, LDT, static_cast<const bf16*>(a.Cm) + b * a.cs_b +
          base * a.cs_s + n0, a.cs_s, QP, valid, tcn);
  cp_async_commit();
  {
    const float* part = a.dcb + ((size_t)(b * nc + c) * ngroups) * DQ * DQ;
    for (int e = tid; e < QP * QP; e += BT) {
      const int q = e / QP, t = e % QP;
      float s = 0.f;
      for (int g = 0; g < ngroups; ++g)
        s += part[(size_t)g * DQ * DQ + q * DQ + t];
      sD[q * LDD + t] = s;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (active) {
    for (int kk = 0; kk < QP / 16; ++kk) {
      const int k0 = 16 * kk + 2 * tq;
      uint32_t dh[4], dl[4], th[4], tl[4];
      // A = dCB rows r0, r1 (dC); A = dCB^T, i.e. dCB[k][r] (dB)
      split_bf16(sD[r0 * LDD + k0], sD[r0 * LDD + k0 + 1], dh[0], dl[0]);
      split_bf16(sD[r1 * LDD + k0], sD[r1 * LDD + k0 + 1], dh[1], dl[1]);
      split_bf16(sD[r0 * LDD + k0 + 8], sD[r0 * LDD + k0 + 9], dh[2], dl[2]);
      split_bf16(sD[r1 * LDD + k0 + 8], sD[r1 * LDD + k0 + 9], dh[3], dl[3]);
      split_bf16(sD[k0 * LDD + r0], sD[(k0 + 1) * LDD + r0], th[0], tl[0]);
      split_bf16(sD[k0 * LDD + r1], sD[(k0 + 1) * LDD + r1], th[1], tl[1]);
      split_bf16(sD[(k0 + 8) * LDD + r0], sD[(k0 + 9) * LDD + r0], th[2],
                 tl[2]);
      split_bf16(sD[(k0 + 8) * LDD + r1], sD[(k0 + 9) * LDD + r1], th[3],
                 tl[3]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (16 * np >= tcn) break;
        uint32_t bb[4];
        ldsm_x4_t(bb, bt_addr(sBt, LDT, 16 * kk, 16 * np, lane));
        mma_pair(dC[2 * np], dC[2 * np + 1], dh, dl, bb);
        ldsm_x4_t(bb, bt_addr(sCt, LDT, 16 * kk, 16 * np, lane));
        mma_pair(dB[2 * np], dB[2 * np + 1], th, tl, bb);
      }
    }
    bf16* cp = static_cast<bf16*>(a.dC) + b * a.dcs_b + base * a.dcs_s + n0;
    bf16* bp = static_cast<bf16*>(a.dB) + b * a.dbs_b + base * a.dbs_s + n0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (8 * j >= tcn) break;
      const int col = 8 * j + 2 * tq;
      if (r0 < valid) {
        *reinterpret_cast<__nv_bfloat162*>(cp + r0 * a.dcs_s + col) =
            __floats2bfloat162_rn(dC[j][0], dC[j][1]);
        *reinterpret_cast<__nv_bfloat162*>(bp + r0 * a.dbs_s + col) =
            __floats2bfloat162_rn(dB[j][0], dB[j][1]);
      }
      if (r1 < valid) {
        *reinterpret_cast<__nv_bfloat162*>(cp + r1 * a.dcs_s + col) =
            __floats2bfloat162_rn(dC[j][2], dC[j][3]);
        *reinterpret_cast<__nv_bfloat162*>(bp + r1 * a.dbs_s + col) =
            __floats2bfloat162_rn(dB[j][2], dB[j][3]);
      }
    }
  }
}

// K9ba: dA[h] = the (b, chunk) shares of head h, summed in order
__global__ void ssd_bwd_da_kernel(BwdArgs a) {
  for (int h = blockIdx.x * BT + threadIdx.x; h < a.H; h += gridDim.x * BT) {
    float s = 0.f;
    for (int b = 0; b < a.Bsz; ++b)
      for (int c = 0; c < a.nc; ++c)
        s += a.dap[((size_t)b * a.H + h) * a.nc + c];
    a.dA[h] = s;
  }
}

// workspace layout, in floats, each piece on 256 bytes
struct Workspace {
  size_t states, dstates, gb, uu, vv, gs, dcb, dap, total;
};

__host__ Workspace workspace(int B, int H, int S, int P, int N, int Q,
                             int nc, int HG, bool own_states) {
  auto up = [](size_t n) { return (n + 63) / 64 * 64; };
  const size_t bhc = (size_t)B * H * nc, qp = bqpad(Q);
  const int ngroups = (H + HG - 1) / HG;
  Workspace w;
  size_t off = 0;
  w.states = off;
  off += own_states ? up(bhc * P * N) : 0;
  w.dstates = off;
  off += own_states ? up(bhc * P * N) : 0;
  // the CUDA-core route's K9bg -> K9bx handoff (the tc route's K9bx does
  // K9bg's work itself)
  w.gb = off;
  off += own_states ? up(bhc * Q * P) : 0;
  w.uu = off;
  off += own_states ? up(bhc * Q) : 0;
  w.vv = off;
  off += own_states ? up(bhc * Q) : 0;
  w.gs = off;
  off += own_states ? up(bhc) : 0;
  w.dcb = off;
  off += up((size_t)B * nc * ngroups * qp * qp);
  w.dap = off;
  off += up(bhc);
  w.total = off;
  return w;
}

template <typename K>
cudaError_t set_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

#define RET_IF(e)                          \
  do {                                     \
    const cudaError_t err_ = (e);          \
    if (err_ != cudaSuccess) return err_;  \
  } while (0)

template <typename T>
cudaError_t launch_bwd(BwdArgs a, bool own_states, cudaStream_t st) {
  const int qp = bqpad(a.Q);
  const dim3 pass_grid(a.Bsz * a.H, (a.P + 31) / 32);
  const size_t ps = pass_smem(a.Q, a.N);
  if (own_states) {
    RET_IF(set_smem(ssd_pass_kernel<T, false>, ps));
    ssd_pass_kernel<T, false><<<pass_grid, BT, ps, st>>>(a);
    RET_IF(cudaGetLastError());
    RET_IF(set_smem(ssd_pass_kernel<T, true>, ps));
    ssd_pass_kernel<T, true><<<pass_grid, BT, ps, st>>>(a);
    RET_IF(cudaGetLastError());
  }

  const int ngroups = (a.H + a.HG - 1) / a.HG;
  if (a.pair) {   // the tc route: bf16, P and N multiples of 16
    const size_t cs = chunk_tc_smem(qpad16(a.Q), a.P, a.N);
    RET_IF(set_smem(ssd_bwd_chunk_tc_kernel, cs));
    ssd_bwd_chunk_tc_kernel<<<a.Bsz * a.nc * ngroups, BT, cs, st>>>(a);
  } else {
    const size_t ss = state_smem(qp, a.P);
    RET_IF(set_smem(ssd_bwd_state_kernel<T>, ss));
    ssd_bwd_state_kernel<T><<<a.Bsz * a.H * a.nc, BT, ss, st>>>(a);
    RET_IF(cudaGetLastError());
    const size_t cs = chunk_smem(qp, a.P);
    RET_IF(set_smem(ssd_bwd_chunk_kernel<T>, cs));
    ssd_bwd_chunk_kernel<T><<<a.Bsz * a.nc * ngroups, BT, cs, st>>>(a);
  }
  RET_IF(cudaGetLastError());

  if (a.pair) {   // the tc route: bf16, P and N multiples of 16
    const int tcn = bc_tc_cols(a.N);
    const size_t bs = bc_tc_smem(qpad16(a.Q), a.P, tcn);
    RET_IF(set_smem(ssd_bwd_bc_tc_kernel, bs));
    ssd_bwd_bc_tc_kernel<<<a.Bsz * a.nc * (a.N / tcn), BT, bs, st>>>(a);
  } else {
    const size_t bs = bc_smem(qp, a.P);
    RET_IF(set_smem(ssd_bwd_bc_kernel<T>, bs));
    const int ntiles = (a.N + NTILE - 1) / NTILE;
    ssd_bwd_bc_kernel<T><<<a.Bsz * a.nc * ntiles, BT, bs, st>>>(a);
  }
  RET_IF(cudaGetLastError());

  ssd_bwd_da_kernel<<<(a.H + BT - 1) / BT, BT, 0, st>>>(a);
  return cudaGetLastError();
}

bool bwd_shape_ok(int S, int P, int N, int chunk) {
  return S > 0 && chunk >= 1 && chunk <= B_MAX_Q && P >= 8 && P <= B_MAX_P &&
         P % 8 == 0 && N >= 8 && N <= B_MAX_N && N % 8 == 0;
}

}  // namespace
}  // namespace repro

// Bytes of K9b's fp32 workspace for this shape (own_states: the fp32
// route, whose entering states K9b computes itself), into *out.
extern "C" int repro_ssd_scan_bwd_workspace(int B, int H, int S, int P, int N,
                                            int chunk, int own_states,
                                            long long* out) {
  using namespace repro;
  if (B <= 0 || H <= 0 || !bwd_shape_ok(S, P, N, chunk))
    return cudaErrorInvalidValue;
  const int Q = chunk < S ? chunk : S, nc = (S + Q - 1) / Q;
  *out = (long long)workspace(B, H, S, P, N, Q, nc, H < MAX_HG ? H : MAX_HG,
                              own_states != 0).total * 4;
  return cudaSuccess;
}

// K9b.  x, dy (B, H, S, P) in dtype (0 float32, 1 bfloat16), dt (B, H, S)
// fp32, A (H,) fp32, B, C (B, S, N) in dtype; dstate (B, H, P, N) fp32
// contiguous or null; pair 1: states and dstates are the tc route's K9s
// and reversed-K9s scratches (B, H, nc, 2, P, N) bf16; pair 0: both null,
// K9b computes them (fp32) into the workspace, dstate seeding the
// reverse pass; workspace: repro_ssd_scan_bwd_workspace's bytes.  Outputs
// dx (like x), ddt (like dt, fp32), dA (H,) fp32, dB, dC (like B) in
// dtype.  Strides (elements): x, dy, dx, dt, ddt (b, h, s); B, C, dB, dC
// (b, s); every last dimension unit-stride.  Returns the first launch
// error.
extern "C" int repro_ssd_scan_bwd(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* dy, const void* dstate, const void* states,
    const void* dstates, void* workspace_ptr, void* dx, void* ddt, void* dA, void* dB, void* dC,
    int B, int H, int S, int P, int N, int chunk, int pair, long long xs_b,
    long long xs_h, long long xs_s, long long ys_b, long long ys_h,
    long long ys_s, long long xg_b, long long xg_h, long long xg_s,
    long long ds_b, long long ds_h, long long ds_s, long long es_b,
    long long es_h, long long es_s, long long bs_b, long long bs_s,
    long long cs_b, long long cs_s, long long dbs_b, long long dbs_s,
    long long dcs_b, long long dcs_s, int dtype, void* stream) {
  using namespace repro;
  if (B <= 0 || H <= 0) return cudaSuccess;
  if (!bwd_shape_ok(S, P, N, chunk) || dtype < 0 || dtype > 1 ||
      (pair && (!states || !dstates || dtype != 1 || P % 16 || N % 16)))
    return cudaErrorInvalidValue;
  const int Q = chunk < S ? chunk : S, nc = (S + Q - 1) / Q;
  const int HG = H < MAX_HG ? H : MAX_HG;
  const bool own = !pair;
  const Workspace w = workspace(B, H, S, P, N, Q, nc, HG, own);
  float* ws = static_cast<float*>(workspace_ptr);
  BwdArgs a{x,
            static_cast<const float*>(dt),
            static_cast<const float*>(A),
            Bm,
            Cm,
            dy,
            static_cast<const float*>(dstate),
            own ? static_cast<const void*>(ws + w.states) : states,
            own ? static_cast<const void*>(ws + w.dstates) : dstates,
            pair,
            ws + w.gb,
            ws + w.uu,
            ws + w.vv,
            ws + w.gs,
            ws + w.dcb,
            ws + w.dap,
            dx,
            static_cast<float*>(ddt),
            static_cast<float*>(dA),
            dB,
            dC,
            B, H, S, P, N, Q, nc, HG,
            xs_b, xs_h, xs_s, ys_b, ys_h, ys_s, xg_b, xg_h, xg_s,
            ds_b, ds_h, ds_s, es_b, es_h, es_s,
            bs_b, bs_s, cs_b, cs_s, dbs_b, dbs_s, dcs_b, dcs_s};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd<float>(a, own, st);
  return launch_bwd<bf16>(a, own, st);
}
