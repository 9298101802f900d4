// K1, K1-lse, K2 and K3 at the head-width pair (576, 512), for sm_90a:
// the absorbed MLA route at DeepSeek-V2's full width.
//
// Replaces, at this pair, the Pallas TPU kernels of
// repro/kernels/flash_attention.py: _fwd_kernel (:134, pallas_call :437;
// K1 and K1-lse), _bwd_dq_kernel (:451, :713) and _bwd_dkv_kernel (:494,
// :760; K2) and _bwd_fused_kernel (:541, :669; K3).  The reference's
// models/attention.py _mla_absorbed_flash sends one kv head of width
// rkv + dr = 512 + 64 = 576, k = [c_kv, k_rope] and v = c_kv (512), shared
// by all 128 query heads (G 128), through those kernels.  The numerics are
// flash_attention.cu's and flash_attention_bwd.cu's: s = (q . k) / sqrt(hd)
// with fp32 sums, masked scores -1e30, natural-log lse = m + log(max(l,
// 1e-37)), P = exp(s - lse), dS = P (dP - delta) with delta computed by
// the caller, and in bf16 P and dS fed to the tensor cores as a bf16 hi +
// lo pair.  attn_pair (common.cuh) sends every (hd, hd_v) past the other
// pairs, up to (576, 512), here; the loaders zero-fill the columns past
// the true widths and the loops skip the k16 steps that hold only zeros.
//
// Why the other pairs' kernels do not stretch to this width: a block may
// opt into 232,448 B of shared memory and a thread holds at most 255
// registers.  K1's tiles at BQ = BK = 64 take 357,376 B (bf16) and
// 443,136 B (fp32); a warp's 16 output rows of 512 fp32 columns take 256
// registers a thread before S, P or Q; the dkv block's dK (576) and dV
// (512) take 544 fp32 a thread; and the dkv grid, (Sk / 64, B * KH), is 64
// blocks for 132 SMs at the training micro-batch (B 1, KH 1, S 4096).  So:
//
// bf16, tensor cores (mma.sync.m16n8k16, fp32 sums), eight warps a block:
//   K1   a 64-row q tile, four row groups of 16 rows, two warps each.  The
//        two warps of a row group split the 576-wide sum of S = Q K^T
//        (18 k16 steps each) and add their halves through shared memory
//        (16 fp32 a thread; a + b == b + a in IEEE arithmetic, so both
//        warps hold the same bits of S, m and P); each then owns 256 of
//        O's 512 columns (128 fp32 a thread) and adds P V for them.  Q's
//        fragments are read from shared memory at each kv tile (as at
//        (192, 128)).  K and V tiles of 32 rows, double-buffered: Q 64 x
//        584 + 2 x (32 x 584 + 32 x 520) bf16 and the 16 KB exchange is
//        232,448 B, the whole opt-in.
//   K2 dq   a 64-row q tile, four row groups of two warps: one warp of a
//        group computes S = Q K^T (576 deep), the other dP = dO V^T (512
//        deep), over a 32-row kv tile, and they swap them through shared
//        memory; both then form the same dS and each adds dS K into 288 of
//        dq's 576 columns (144 fp32 a thread).  One kv stage (228,352 B).
//   K2 dkv, K3   a 32-row kv tile, two row groups of 16 kv rows, four
//        warps each.  Of a group's four warps, two split the sum of S^T =
//        K Q^T and two that of dP^T = V dO^T over a 32-row q tile; the
//        four partials go through shared memory and every warp adds them
//        in one fixed order, so all four hold the same P^T and dS^T.  Each
//        warp then owns 128 of dV's columns and 144 of dK's (136 fp32 a
//        thread) and adds P^T dO and dS^T Q for them.  The q and dO tiles
//        are double-buffered (228,864 B).  K3 then writes dS^T (bf16 hi +
//        lo) over the exchange buffer, and the eight warps add the tile's
//        dQ = dS K (16 q rows x 144 columns each) into the fp32 dq buffer
//        with two-wide atomics.
// fp32, CUDA cores (the card's fp32 checks hold the kernels to 1e-4 of the
// plain versions, which TF32 tensor cores would not meet), 256 threads as
// a 16 x 16 grid (ty, tx), operands in shared memory with rows padded to
// an odd stride: K1 32 q rows by 32 kv rows (217,472 B); K2 dq 32 q rows
// by 16 kv rows (211,456 B); K2 dkv and K3 16 kv rows by 32 q rows
// (213,760 B), one kv row a ty, dK and dV columns tx + 16 j.
//
// The dkv grid fills the card: its blocks take the kv tiles of one kv
// head times `splits` slices of its query heads, (splits, Sk / rows,
// B * KH), splits chosen by the wrapper from the shapes alone
// (autotune.wide_dkv_splits; 5 slices of 26 heads at B 1, S 4096 in
// bf16: 640 blocks).  A block writes its fp32 dK and dV partial sums over
// its heads to a workspace (splits, B * KH * Sk, hd) + (splits, B * KH *
// Sk, hd_v), and dkv_reduce_kernel adds the slices in slice order and
// casts: no atomics, a fixed order, so K2 gives the same bits on every
// run and K3's dk and dv, from the same code, equal K2's.  Each dkv block
// walks its q tiles from the last down and its heads inside each q tile,
// so the blocks of all kv tiles read the same q tile of every head at
// about the same time (one 32-row q tile of 128 heads is 8.9 MB of q and
// dO in bf16, which the 50 MB L2 holds) instead of each streaming all of
// q: 128 heads of q and dO at S 4096 are 1.14 GB, re-read once for every
// kv tile they meet.
//
// Bound on the H100 (989 TFLOP/s bf16; kernels/counts.py attention_work,
// computed, not measured): at B 1, H 128, KH 1, S 4096, causal, K1-lse
// does 2.34 TFLOP (2.36 ms), K2 dq 3.57 (3.61 ms), K2 dkv 4.67 (4.73 ms)
// and K3 5.91 (5.98 ms); all are compute-bound (q, k, v, dO and the
// outputs are about 2.3 GB at most, 0.7 ms at 3.35 TB/s).  The design is
// the simple one; the next steps are wgmma with TMA-fed tiles, one K/V
// tile for the absorbed route (there v is k's first 512 columns), and for
// K3 fewer dq atomics.

#include "common.cuh"

namespace repro {
namespace {

constexpr int WNT = 256;   // eight warps: every kernel here

// ------------------------------------------------- bf16: tensor cores

constexpr int F_BQ = 64, F_BK = 32;    // K1: q rows, kv rows of a tile
constexpr int DQ_BQ = 64, DQ_BK = 32;  // K2 dq
constexpr int KV_BK = 32, KV_BQ = 32;  // K2 dkv, K3: kv rows, q rows

template <int HD, int HDV>
constexpr size_t tc_fwd_bytes() {
  return ((size_t)F_BQ * (HD + 8) + (size_t)2 * F_BK * (HD + 8) +
          (size_t)2 * F_BK * (HDV + 8)) * sizeof(bf16) +
         (size_t)8 * (F_BK / 8) * 32 * sizeof(float4);
}

template <int HD, int HDV>
constexpr size_t tc_dq_bytes() {
  return ((size_t)DQ_BQ * (HD + 8 + HDV + 8) +
          (size_t)DQ_BK * (HD + 8 + HDV + 8)) * sizeof(bf16) +
         (size_t)8 * (DQ_BK / 8) * 32 * sizeof(float4);
}

template <int HD, int HDV>
constexpr size_t tc_dkv_bytes() {
  return ((size_t)KV_BK * (HD + 8 + HDV + 8) +
          (size_t)2 * KV_BQ * (HD + 8 + HDV + 8)) * sizeof(bf16) +
         (size_t)4 * KV_BQ * sizeof(float) +
         (size_t)8 * (KV_BQ / 8) * 32 * sizeof(float4);
}

static_assert(tc_fwd_bytes<576, 512>() <= 232448, "K1 tiles");
static_assert(tc_dq_bytes<576, 512>() <= 232448, "K2 dq tiles");
static_assert(tc_dkv_bytes<576, 512>() <= 232448, "K2 dkv tiles");

// Hand a warp's accumulator fragments to the warps of its group through
// shared memory: slot w holds warp w's N n8 tiles, lane-major, so a lane
// reads its own fragment positions of another warp.
template <int N>
__device__ __forceinline__ void put_frags(float4* x, int warp, int lane,
                                          const float (&f)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
    x[(warp * N + n) * 32 + lane] = make_float4(f[n][0], f[n][1], f[n][2],
                                                f[n][3]);
}

template <int N>
__device__ __forceinline__ void add_frags(float (&f)[N][4], const float4* x,
                                          int warp, int lane) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const float4 y = x[(warp * N + n) * 32 + lane];
    f[n][0] += y.x;
    f[n][1] += y.y;
    f[n][2] += y.z;
    f[n][3] += y.w;
  }
}

// f (16 rows x 8N columns of one warp) += A[r0.., k16 steps ks_lo..ks_hi)
// B[n.., same]^T, A and B row-major bf16 tiles with row stride ld
template <int N>
__device__ __forceinline__ void mma_rows(float (&f)[N][4], const bf16* A,
                                         const bf16* B, int ld, int r0,
                                         int ks_lo, int ks_hi, int lane) {
  for (int ks = ks_lo; ks < ks_hi; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, a_addr(A, ld, r0, ks * 16, lane));
#pragma unroll
    for (int np = 0; np < N / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, b_addr(B, ld, np * 16, ks * 16, lane));
      mma_bf16(f[2 * np], a, b[0], b[1]);
      mma_bf16(f[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// K1: one block per (b*H + h, 64-row q tile); q tiles heaviest first
template <int HD, int HDV>
__global__ void __launch_bounds__(WNT, 1)
flash_fwd_wide_tc_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         float* __restrict__ lse, int H, int G, int Sq,
                         int Sk, int hd, int hd_v, int q_offset, int causal,
                         int window, float scale) {
  constexpr int BQ = F_BQ, BK = F_BK, LD = HD + 8, LDV = HDV + 8;
  constexpr int NK = BK / 8;                 // n8 tiles of a warp's S
  constexpr int KSH = (HD / 16 + 1) / 2;     // k16 steps a warp sums
  constexpr int CW = HDV / 2, ND = CW / 8;   // a warp's output columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);   // BQ x LD
  bf16* sK = sQ + BQ * LD;                         // 2 stages of BK x LD
  bf16* sV = sK + 2 * BK * LD;                     // 2 stages of BK x LDV
  float4* sX = reinterpret_cast<float4*>(sV + 2 * BK * LDV);  // partials

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ch = warp & 1, w0 = (warp >> 1) * 16;
  const int bh = blockIdx.x;                          // b * H + h
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int bkv = (bh / H) * (H / G) + (bh % H) / G;  // b * KH + h / G
  const bf16* kp = k + (size_t)bkv * Sk * hd;
  const bf16* vp = v + (size_t)bkv * Sk * hd_v;
  const int q_rows = min(BQ, Sq - q0);
  const int row0 = q_offset + q0;   // global position of tile row 0
  int kv_begin = 0, kv_end = Sk;
  if (causal) kv_end = min(Sk, row0 + BQ);
  if (window > 0) kv_begin = max(0, row0 - window + 1);
  const int kt0 = (kv_begin / BK) * BK;
  const int n_it = kv_end > kt0 ? (kv_end - kt0 + BK - 1) / BK : 0;
  // this warp's half of S's sum and of O's columns
  const int ks_lo = ch * KSH, ks_hi = min((hd + 15) / 16, ks_lo + KSH);
  const int c_lo = ch * CW;

  cp_tile<HD, BQ, LD, WNT>(sQ, q + ((size_t)bh * Sq + q0) * hd, q_rows, hd);
  if (n_it > 0) {
    cp_tile<HD, BK, LD, WNT>(sK, kp + (size_t)kt0 * hd, Sk - kt0, hd);
    cp_tile<HDV, BK, LDV, WNT>(sV, vp + (size_t)kt0 * hd_v, Sk - kt0, hd_v);
  }
  cp_async_commit();

  float acc[ND][4];
  zero(acc);
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1, k0 = kt0 + it * BK;
    if (it + 1 < n_it) {   // prefetch the next kv tile into the other stage
      const int nk0 = k0 + BK;
      cp_tile<HD, BK, LD, WNT>(sK + (st ^ 1) * BK * LD,
                               kp + (size_t)nk0 * hd, Sk - nk0, hd);
      cp_tile<HDV, BK, LDV, WNT>(sV + (st ^ 1) * BK * LDV,
                                 vp + (size_t)nk0 * hd_v, Sk - nk0, hd_v);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Ks = sK + st * BK * LD;
    const bf16* Vs = sV + st * BK * LDV;

    // this warp's half of S = Q K^T, then the other half from its partner
    float s[NK][4];
    zero(s);
    mma_rows(s, sQ, Ks, LD, w0, ks_lo, ks_hi, lane);
    put_frags(sX, warp, lane, s);
    __syncthreads();
    add_frags(s, sX, warp ^ 1, lane);

    const bool full = k0 + BK <= Sk &&
                      (!causal || k0 + BK - 1 <= row0) &&
                      (window <= 0 || row0 + BQ - 1 - k0 < window);
    if (full) {
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= scale;
    } else {
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + w0 + g + 8 * (e >> 1);
          const int col = k0 + n * 8 + 2 * t + (e & 1);
          s[n][e] = is_live(row, col, Sk, causal, window) ? s[n][e] * scale
                                                          : NEG_INF;
        }
    }

    // online softmax on the fragments: a row lives in the 4 lanes of a quad
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = __expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = __expf(s[n][e] - m[e >> 1]);
        rs[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O[:, c_lo..] += P V: P as a bf16 hi + lo pair, V^T by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_frag(s[2 * kk], s[2 * kk + 1], hi, lo);
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        const int c0 = c_lo + np * 16;
        if (c0 < hd_v) {
          uint32_t b[4];
          ldsm_x4_t(b, bt_addr(Vs, LDV, kk * 16, c0, lane));
          mma_pair(acc[2 * np], acc[2 * np + 1], hi, lo, b);
        }
      }
    }
    __syncthreads();   // this stage and sX are read; the next may land
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = w0 + g + 8 * i;
    if (r >= q_rows) continue;
    const float den = fmaxf(l[i], 1e-37f);
    if (lse != nullptr && ch == 0 && t == 0)
      lse[(size_t)bh * Sq + q0 + r] = m[i] + logf(den);
    bf16* out = o + ((size_t)bh * Sq + q0 + r) * hd_v;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int c = c_lo + n * 8 + 2 * t;
      if (c < hd_v)
        *reinterpret_cast<__nv_bfloat162*>(out + c) = __floats2bfloat162_rn(
            acc[n][2 * i] / den, acc[n][2 * i + 1] / den);
    }
  }
}

// K2 dq: one block per (64-row q tile, b*H + h)
template <int HD, int HDV>
__global__ void __launch_bounds__(WNT, 1)
tc_bwd_dq_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dq,
                      int H, int G, int Sq, int Sk, int hd, int hd_v,
                      int q_offset, int causal, int window, float scale) {
  constexpr int BQ = DQ_BQ, BK = DQ_BK, LD = HD + 8, LDV = HDV + 8;
  constexpr int NK = BK / 8;
  constexpr int CW = HD / 2, ND = CW / 8;   // a warp's dq columns
  static_assert(CW % 16 == 0, "dq columns a warp: whole k16 pairs");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);   // BQ x LD
  bf16* sO = sQ + BQ * LD;                         // BQ x LDV, dO
  bf16* sK = sO + BQ * LDV;                        // BK x LD
  bf16* sV = sK + BK * LD;                         // BK x LDV
  float4* sX = reinterpret_cast<float4*>(sV + BK * LDV);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ch = warp & 1, w0 = (warp >> 1) * 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y;                          // b * H + h
  const int bkv = (bh / H) * (H / G) + (bh % H) / G;  // b * KH + h / G
  const bf16* kp = k + (size_t)bkv * Sk * hd;
  const bf16* vp = v + (size_t)bkv * Sk * hd_v;
  const int q_rows = min(BQ, Sq - q0);
  const int row0 = q_offset + q0;
  int kv_begin = 0, kv_end = Sk;
  if (causal) kv_end = min(Sk, row0 + BQ);
  if (window > 0) kv_begin = max(0, row0 - window + 1);
  // warp ch 0 computes S over hd, ch 1 dP over hd_v
  const int ks_hi = ch == 0 ? (hd + 15) / 16 : (hd_v + 15) / 16;
  const int c_lo = ch * CW;

  cp_tile<HD, BQ, LD, WNT>(sQ, q + ((size_t)bh * Sq + q0) * hd, q_rows, hd);
  cp_tile<HDV, BQ, LDV, WNT>(sO, dout + ((size_t)bh * Sq + q0) * hd_v,
                             q_rows, hd_v);
  cp_async_commit();
  float rl[2], rd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = w0 + g + 8 * i;
    rl[i] = r < q_rows ? lse[(size_t)bh * Sq + q0 + r] : 0.f;
    rd[i] = r < q_rows ? delta[(size_t)bh * Sq + q0 + r] : 0.f;
  }
  float acc[ND][4];
  zero(acc);

  for (int k0 = (kv_begin / BK) * BK; k0 < kv_end; k0 += BK) {
    __syncthreads();   // the previous tile's reads of sK, sV, sX are done
    cp_tile<HD, BK, LD, WNT>(sK, kp + (size_t)k0 * hd, Sk - k0, hd);
    cp_tile<HDV, BK, LDV, WNT>(sV, vp + (size_t)k0 * hd_v, Sk - k0, hd_v);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // own: S (ch 0) or dP (ch 1); swap with the partner
    float x[NK][4];
    zero(x);
    if (ch == 0)
      mma_rows(x, sQ, sK, LD, w0, 0, ks_hi, lane);
    else
      mma_rows(x, sO, sV, LDV, w0, 0, ks_hi, lane);
    put_frags(sX, warp, lane, x);
    __syncthreads();
    // dS = P (dP - delta) into x, the scale applied at the end
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      const float4 y4 = sX[((warp ^ 1) * NK + n) * 32 + lane];
      const float y[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float sv = ch == 0 ? x[n][e] : y[e];
        const float dpv = ch == 0 ? y[e] : x[n][e];
        const int row = row0 + w0 + g + 8 * i;
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const float sm =
            is_live(row, col, Sk, causal, window) ? sv * scale : NEG_INF;
        x[n][e] = expf(sm - rl[i]) * (dpv - rd[i]);
      }
    }
    // dQ[:, c_lo..] += dS K: dS from registers (hi + lo), K^T by
    // ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_frag(x[2 * kk], x[2 * kk + 1], hi, lo);
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        const int c0 = c_lo + np * 16;
        if (c0 < hd) {
          uint32_t b[4];
          ldsm_x4_t(b, bt_addr(sK, LD, kk * 16, c0, lane));
          mma_pair(acc[2 * np], acc[2 * np + 1], hi, lo, b);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = w0 + g + 8 * i;
    if (r >= q_rows) continue;
    bf16* out = dq + ((size_t)bh * Sq + q0 + r) * hd;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int c = c_lo + n * 8 + 2 * t;
      if (c < hd)
        *reinterpret_cast<__nv_bfloat162*>(out + c) = __floats2bfloat162_rn(
            acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale);
    }
  }
}

// dq[i..i+1] += (x, y), one two-wide fp32 atomic (sm_90)
__device__ __forceinline__ void atomic_add2(float* p, float x, float y) {
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(x, y));
}

// K2 dk/dv (FUSED false) and K3 (FUSED true): one block per (head slice,
// 32-row kv tile, b*KH + kh); fp32 partial dK, dV of the slice into ws
template <int HD, int HDV, bool FUSED>
__global__ void __launch_bounds__(WNT, 1)
tc_bwd_dkv_wide_kernel(const bf16* __restrict__ q,
                       const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       float* __restrict__ ws, float* __restrict__ dq_acc,
                       int H, int G, int Sq, int Sk, int hd, int hd_v,
                       int q_offset, int causal, int window, float scale,
                       int splits) {
  constexpr int TK = KV_BK, TQ = KV_BQ, LD = HD + 8, LDV = HDV + 8;
  constexpr int LDS = TQ + 8;               // K3's dS^T row stride
  constexpr int NQ = TQ / 8;                // n8 tiles of S^T
  constexpr int KS2 = HD / 32, KSV2 = HDV / 32;   // k16 steps a warp sums
  constexpr int VW = HDV / 4, KW = HD / 4;  // a warp's dV, dK columns
  constexpr int NDV = VW / 8, NDK = KW / 8;
  static_assert(VW % 16 == 0 && KW % 16 == 0 && HD % 32 == 0 &&
                HDV % 32 == 0, "column and depth shares: whole k16 steps");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);   // TK x LD
  bf16* sV = sK + TK * LD;                         // TK x LDV
  bf16* sQ = sV + TK * LDV;                        // 2 stages of TQ x LD
  bf16* sO = sQ + 2 * TQ * LD;                     // 2 stages of TQ x LDV
  float* sL = reinterpret_cast<float*>(sO + 2 * TQ * LDV);   // 2 x TQ lse
  float* sD = sL + 2 * TQ;                                    // 2 x TQ delta
  float4* sX = reinterpret_cast<float4*>(sD + 2 * TQ);       // partials
  // K3's dS^T, hi and lo, over the partials once every warp has read them
  bf16* sSh = reinterpret_cast<bf16*>(sX);                    // TK x LDS
  bf16* sSl = sSh + TK * LDS;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp & 1, cq = warp >> 1, w0 = rg * 16;
  const int split = blockIdx.x, k0 = blockIdx.y * TK, bkv = blockIdx.z;
  const int KH = H / G;
  const int hps = (G + splits - 1) / splits, h_lo = split * hps;
  const int nh = max(0, min(G, h_lo + hps) - h_lo);
  const int bh0 = (bkv / KH) * H + (bkv % KH) * G + h_lo;
  const int kv_rows = min(TK, Sk - k0);

  // q rows whose masks keep some column of this kv tile
  int q_lo = 0, q_hi = Sq;
  if (causal) q_lo = max(0, k0 - q_offset);
  if (window > 0) q_hi = min(Sq, k0 + kv_rows - 1 + window - q_offset);
  const int qt0 = (q_lo / TQ) * TQ;
  const int n_qt = q_hi > qt0 ? (q_hi - qt0 + TQ - 1) / TQ : 0;
  const int n_it = nh * n_qt;

  // warps cq 0, 1 sum S^T over halves of hd; cq 2, 3 dP^T over halves of
  // hd_v
  const bool is_s = cq < 2;
  const int ks_half = is_s ? KS2 : KSV2;
  const int ks_lo = (cq & 1) * ks_half;
  const int ks_hi = min(is_s ? (hd + 15) / 16 : (hd_v + 15) / 16,
                        ks_lo + ks_half);

  cp_tile<HD, TK, LD, WNT>(sK, k + ((size_t)bkv * Sk + k0) * hd, kv_rows, hd);
  cp_tile<HDV, TK, LDV, WNT>(sV, v + ((size_t)bkv * Sk + k0) * hd_v, kv_rows,
                             hd_v);
  // iteration it: q tile qt0 + (n_qt - 1 - it / nh) * TQ (the last first),
  // head bh0 + it % nh
  auto prefetch = [&](int it, int stage) {
    const int q0 = qt0 + (n_qt - 1 - it / nh) * TQ, bh = bh0 + it % nh;
    const size_t row = (size_t)bh * Sq + q0;
    cp_tile<HD, TQ, LD, WNT>(sQ + stage * TQ * LD, q + row * hd, Sq - q0, hd);
    cp_tile<HDV, TQ, LDV, WNT>(sO + stage * TQ * LDV, dout + row * hd_v,
                               Sq - q0, hd_v);
    cp_vals<TQ, WNT>(sL + stage * TQ, lse + row, Sq - q0);
    cp_vals<TQ, WNT>(sD + stage * TQ, delta + row, Sq - q0);
  };
  if (n_it > 0) prefetch(0, 0);
  cp_async_commit();

  float adk[NDK][4], adv[NDV][4];
  zero(adk);
  zero(adv);

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) {
      prefetch(it + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = qt0 + (n_qt - 1 - it / nh) * TQ, bh = bh0 + it % nh;
    const int q_rows = min(TQ, Sq - q0);
    const bf16* Qs = sQ + st * TQ * LD;
    const bf16* Os = sO + st * TQ * LDV;
    const float* Ls = sL + st * TQ;
    const float* Ds = sD + st * TQ;

    // partials of S^T = K Q^T and dP^T = V dO^T (kv rows w0.., q columns)
    float x[NQ][4];
    zero(x);
    if (is_s)
      mma_rows(x, sK, Qs, LD, w0, ks_lo, ks_hi, lane);
    else
      mma_rows(x, sV, Os, LDV, w0, ks_lo, ks_hi, lane);
    put_frags(sX, warp, lane, x);
    __syncthreads();
    // every warp of the row group adds them in one order: S^T = (cq 0) +
    // (cq 1), dP^T = (cq 2) + (cq 3)
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      const float4 a = sX[((rg + 0) * NQ + n) * 32 + lane];
      const float4 b = sX[((rg + 2) * NQ + n) * 32 + lane];
      const float4 c = sX[((rg + 4) * NQ + n) * 32 + lane];
      const float4 d = sX[((rg + 6) * NQ + n) * 32 + lane];
      s[n][0] = a.x + b.x;
      s[n][1] = a.y + b.y;
      s[n][2] = a.z + b.z;
      s[n][3] = a.w + b.w;
      dp[n][0] = c.x + d.x;
      dp[n][1] = c.y + d.y;
      dp[n][2] = c.z + d.z;
      dp[n][3] = c.w + d.w;
    }
    // P^T and dS^T = P^T (dP^T - delta), unscaled, in place
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qr = n * 8 + 2 * t + (e & 1);
        const int col = k0 + w0 + g + 8 * (e >> 1);
        const bool live = qr < q_rows && is_live(q_offset + q0 + qr, col, Sk,
                                                 causal, window);
        const float p = expf((live ? s[n][e] * scale : NEG_INF) - Ls[qr]);
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - Ds[qr]);
      }
    if (FUSED) __syncthreads();   // every warp has read sX: dS^T may land
    // dV[:, cq*VW..] += P^T dO, dK[:, cq*KW..] += dS^T Q
#pragma unroll
    for (int kq = 0; kq < TQ / 16; ++kq) {
      uint32_t ph[4], pl[4], dh[4], dl[4];
      split_frag(s[2 * kq], s[2 * kq + 1], ph, pl);
      split_frag(dp[2 * kq], dp[2 * kq + 1], dh, dl);
      if (FUSED && cq == 0) {   // dS^T to shared memory for the tile's dQ
        uint32_t* rh = reinterpret_cast<uint32_t*>(sSh + (w0 + g) * LDS +
                                                   kq * 16 + 2 * t);
        uint32_t* rlo = reinterpret_cast<uint32_t*>(sSl + (w0 + g) * LDS +
                                                    kq * 16 + 2 * t);
        rh[0] = dh[0];
        rh[8 * LDS / 2] = dh[1];
        rh[4] = dh[2];
        rh[8 * LDS / 2 + 4] = dh[3];
        rlo[0] = dl[0];
        rlo[8 * LDS / 2] = dl[1];
        rlo[4] = dl[2];
        rlo[8 * LDS / 2 + 4] = dl[3];
      }
#pragma unroll
      for (int np = 0; np < NDV / 2; ++np) {
        const int c0 = cq * VW + np * 16;
        if (c0 < hd_v) {
          uint32_t bb[4];
          ldsm_x4_t(bb, bt_addr(Os, LDV, kq * 16, c0, lane));
          mma_pair(adv[2 * np], adv[2 * np + 1], ph, pl, bb);
        }
      }
#pragma unroll
      for (int np = 0; np < NDK / 2; ++np) {
        const int c0 = cq * KW + np * 16;
        if (c0 < hd) {
          uint32_t bb[4];
          ldsm_x4_t(bb, bt_addr(Qs, LD, kq * 16, c0, lane));
          mma_pair(adk[2 * np], adk[2 * np + 1], dh, dl, bb);
        }
      }
    }

    if (FUSED) {
      // the tile's dQ = dS K: warp (rq, cq) takes q rows rq*16.. and dq
      // columns cq*KW..; A = dS from the [kv][q] dS^T tile by
      // ldmatrix.trans, B = K from [kv][d]
      const int rq = warp & 1;
      __syncthreads();   // every dS^T row is in shared memory
      uint32_t hi[TK / 16][4], lo[TK / 16][4];
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        ldsm_x4_t(hi[kk], at_addr(sSh, LDS, kk * 16, rq * 16, lane));
        ldsm_x4_t(lo[kk], at_addr(sSl, LDS, kk * 16, rq * 16, lane));
      }
#pragma unroll
      for (int nc = 0; nc < KW / 16; ++nc) {
        const int c0 = cq * KW + nc * 16;
        if (c0 >= hd) break;
        float part[2][4];
        zero(part);
#pragma unroll
        for (int kk = 0; kk < TK / 16; ++kk) {
          uint32_t bb[4];
          ldsm_x4_t(bb, bt_addr(sK, LD, kk * 16, c0, lane));
          mma_pair(part[0], part[1], hi[kk], lo[kk], bb);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = rq * 16 + g + 8 * i;
          if (r >= q_rows) continue;
          float* out = dq_acc + ((size_t)bh * Sq + q0 + r) * hd;
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int c = c0 + n * 8 + 2 * t;
            if (c < hd)
              atomic_add2(out + c, part[n][2 * i] * scale,
                          part[n][2 * i + 1] * scale);
          }
        }
      }
    }
    __syncthreads();   // this stage and sX are read; the next may land
  }
  cp_async_wait<0>();

  // this slice's partial sums of dK (unscaled) and dV
  const size_t n_rows = (size_t)gridDim.z * Sk;   // B * KH * Sk
  float* wk = ws + (size_t)split * n_rows * hd;
  float* wv = ws + (size_t)splits * n_rows * hd + (size_t)split * n_rows * hd_v;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = w0 + g + 8 * i;
    if (r >= kv_rows) continue;
    const size_t row = (size_t)bkv * Sk + k0 + r;
#pragma unroll
    for (int n = 0; n < NDK; ++n) {
      const int c = cq * KW + n * 8 + 2 * t;
      if (c < hd)
        *reinterpret_cast<float2*>(wk + row * hd + c) =
            make_float2(adk[n][2 * i], adk[n][2 * i + 1]);
    }
#pragma unroll
    for (int n = 0; n < NDV; ++n) {
      const int c = cq * VW + n * 8 + 2 * t;
      if (c < hd_v)
        *reinterpret_cast<float2*>(wv + row * hd_v + c) =
            make_float2(adv[n][2 * i], adv[n][2 * i + 1]);
    }
  }
}

// ------------------------------------------------------ fp32: CUDA cores

template <int HD, int HDV>
constexpr size_t f32_fwd_bytes() {
  return (size_t)(32 * (HD + 1) + 32 * (HD + 1) + 32 * HDV + 32 * 33) *
         sizeof(float);
}

template <int HD, int HDV>
constexpr size_t f32_dq_bytes() {
  return (size_t)(32 * (HD + 1) + 32 * (HDV + 1) + 16 * (HD + 1) +
                  16 * (HDV + 1) + 32 * 17) *
         sizeof(float);
}

template <int HD, int HDV>
constexpr size_t f32_dkv_bytes() {
  return (size_t)(16 * (HD + 1) + 16 * (HDV + 1) + 32 * (HD + 1) +
                  32 * (HDV + 1) + 2 * 16 * 33 + 2 * 32) *
         sizeof(float);
}

static_assert(f32_fwd_bytes<576, 512>() <= 232448, "fp32 K1 tiles");
static_assert(f32_dq_bytes<576, 512>() <= 232448, "fp32 K2 dq tiles");
static_assert(f32_dkv_bytes<576, 512>() <= 232448, "fp32 K2 dkv tiles");

// K1: one block per (32-row q tile, b*H + h); thread (ty, tx) owns q rows
// 2ty, 2ty+1, score columns tx, tx+16 and output columns tx + 16j
template <int HD, int HDV>
__global__ void __launch_bounds__(WNT, 1)
flash_fwd_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int H, int G, int Sq, int Sk,
                      int hd, int hd_v, int q_offset, int causal, int window,
                      float scale) {
  constexpr int BQ = 32, BK = 32, LDQ = HD + 1, LDP = BK + 1, NJ = HDV / 16;
  extern __shared__ float smem[];
  float* sQ = smem;            // BQ x LDQ, pre-scaled
  float* sK = sQ + BQ * LDQ;   // BK x LDQ
  float* sV = sK + BK * LDQ;   // BK x HDV
  float* sP = sV + BK * HDV;   // BQ x LDP probabilities

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y;
  const int bkv = (bh / H) * (H / G) + (bh % H) / G;
  const float* kp = k + (size_t)bkv * Sk * hd;
  const float* vp = v + (size_t)bkv * Sk * hd_v;
  load_rows<float, HD, BQ, LDQ, WNT>(sQ, q + ((size_t)bh * Sq + q0) * hd,
                                     min(BQ, Sq - q0), scale, hd);
  const int row0 = q_offset + q0;
  int kv_begin = 0, kv_end = Sk;
  if (causal) kv_end = min(Sk, row0 + BQ);
  if (window > 0) kv_begin = max(0, row0 - window + 1);

  float m[2], l[2], acc[2][NJ];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = (kv_begin / BK) * BK; k0 < kv_end; k0 += BK) {
    __syncthreads();   // sQ written; the previous tile's reads are done
    const int kv_rows = min(BK, Sk - k0);
    load_rows<float, HD, BK, LDQ, WNT>(sK, kp + (size_t)k0 * hd, kv_rows,
                                       1.f, hd);
    load_rows<float, HDV, BK, HDV, WNT>(sV, vp + (size_t)k0 * hd_v, kv_rows,
                                        1.f, hd_v);
    __syncthreads();

    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 8
    for (int d = 0; d < hd; ++d) {
      const float a0 = sQ[(2 * ty) * LDQ + d], a1 = sQ[(2 * ty + 1) * LDQ + d];
      const float b0 = sK[tx * LDQ + d], b1 = sK[(tx + 16) * LDQ + d];
      s[0][0] = fmaf(a0, b0, s[0][0]);
      s[0][1] = fmaf(a0, b1, s[0][1]);
      s[1][0] = fmaf(a1, b0, s[1][0]);
      s[1][1] = fmaf(a1, b1, s[1][1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 2 * ty + i;
      float tmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (!is_live(row, k0 + tx + 16 * j, Sk, causal, window))
          s[i][j] = NEG_INF;
        tmax = fmaxf(tmax, s[i][j]);
      }
      // the 16 lanes sharing ty hold one row
#pragma unroll
      for (int off = 8; off; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m[i], tmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(2 * ty + i) * LDP + tx + 16 * j] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float p0 = sP[(2 * ty) * LDP + kk], p1 = sP[(2 * ty + 1) * LDP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = sV[kk * HDV + tx + 16 * j];
        acc[0][j] = fmaf(p0, vv, acc[0][j]);
        acc[1][j] = fmaf(p1, vv, acc[1][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + 2 * ty + i;
    if (r >= Sq) continue;
    const float den = fmaxf(l[i], 1e-37f);
    if (lse != nullptr && tx == 0) lse[(size_t)bh * Sq + r] = m[i] + logf(den);
    float* op = o + ((size_t)bh * Sq + r) * hd_v;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (tx + 16 * j < hd_v) op[tx + 16 * j] = acc[i][j] / den;
  }
}

// K2 dq: one block per (32-row q tile, b*H + h); thread (ty, tx) owns q
// rows 2ty, 2ty+1, score column tx of a 16-row kv tile and dq columns tx +
// 16j
template <int HD, int HDV>
__global__ void __launch_bounds__(WNT, 1)
flash_bwd_dq_wide_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, int H, int G, int Sq, int Sk,
                         int hd, int hd_v, int q_offset, int causal,
                         int window, float scale) {
  constexpr int BQ = 32, BK = 16, LD = HD + 1, LDV = HDV + 1, LDS = BK + 1,
                NJ = HD / 16;
  extern __shared__ float smem[];
  float* sQ = smem;            // BQ x LD, pre-scaled
  float* sO = sQ + BQ * LD;    // BQ x LDV, dO
  float* sK = sO + BQ * LDV;   // BK x LD
  float* sV = sK + BK * LD;    // BK x LDV
  float* sS = sV + BK * LDV;   // BQ x LDS, dS

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y;
  const int bkv = (bh / H) * (H / G) + (bh % H) / G;
  const float* kp = k + (size_t)bkv * Sk * hd;
  const float* vp = v + (size_t)bkv * Sk * hd_v;
  const int q_rows = min(BQ, Sq - q0);
  load_rows<float, HD, BQ, LD, WNT>(sQ, q + ((size_t)bh * Sq + q0) * hd,
                                    q_rows, scale, hd);
  load_rows<float, HDV, BQ, LDV, WNT>(
      sO, dout + ((size_t)bh * Sq + q0) * hd_v, q_rows, 1.f, hd_v);
  float rl[2], rd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + 2 * ty + i;
    rl[i] = r < Sq ? lse[(size_t)bh * Sq + r] : 0.f;
    rd[i] = r < Sq ? delta[(size_t)bh * Sq + r] : 0.f;
  }
  const int row0 = q_offset + q0;
  int kv_begin = 0, kv_end = Sk;
  if (causal) kv_end = min(Sk, row0 + BQ);
  if (window > 0) kv_begin = max(0, row0 - window + 1);

  float acc[2][NJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int k0 = (kv_begin / BK) * BK; k0 < kv_end; k0 += BK) {
    __syncthreads();   // sQ, sO written; the previous tile's reads done
    const int kv_rows = min(BK, Sk - k0);
    load_rows<float, HD, BK, LD, WNT>(sK, kp + (size_t)k0 * hd, kv_rows, 1.f,
                                      hd);
    load_rows<float, HDV, BK, LDV, WNT>(sV, vp + (size_t)k0 * hd_v, kv_rows,
                                        1.f, hd_v);
    __syncthreads();

    float s[2] = {0.f, 0.f}, dp[2] = {0.f, 0.f};
#pragma unroll 8
    for (int d = 0; d < hd; ++d) {
      const float b = sK[tx * LD + d];
      s[0] = fmaf(sQ[(2 * ty) * LD + d], b, s[0]);
      s[1] = fmaf(sQ[(2 * ty + 1) * LD + d], b, s[1]);
    }
#pragma unroll 8
    for (int d = 0; d < hd_v; ++d) {
      const float b = sV[tx * LDV + d];
      dp[0] = fmaf(sO[(2 * ty) * LDV + d], b, dp[0]);
      dp[1] = fmaf(sO[(2 * ty + 1) * LDV + d], b, dp[1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 2 * ty + i;
      const float sv =
          is_live(row, k0 + tx, Sk, causal, window) ? s[i] : NEG_INF;
      sS[(2 * ty + i) * LDS + tx] =
          expf(sv - rl[i]) * (dp[i] - rd[i]) * scale;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float w0 = sS[(2 * ty) * LDS + kk], w1 = sS[(2 * ty + 1) * LDS + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kv = sK[kk * LD + tx + 16 * j];
        acc[0][j] = fmaf(w0, kv, acc[0][j]);
        acc[1][j] = fmaf(w1, kv, acc[1][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + 2 * ty + i;
    if (r >= Sq) continue;
    float* out = dq + ((size_t)bh * Sq + r) * hd;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (tx + 16 * j < hd) out[tx + 16 * j] = acc[i][j];
  }
}

// K2 dk/dv and K3: one block per (head slice, 16-row kv tile, b*KH + kh);
// thread (ty, tx) owns kv row ty, q columns tx, tx+16 of the transposed
// score tile and dK, dV columns tx + 16j; fp32 partial sums into ws
template <int HD, int HDV, bool FUSED>
__global__ void __launch_bounds__(WNT, 1)
flash_bwd_dkv_wide_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ ws, float* __restrict__ dq_acc,
                          int H, int G, int Sq, int Sk, int hd, int hd_v,
                          int q_offset, int causal, int window, float scale,
                          int splits) {
  constexpr int BK = 16, TQ = 32, LD = HD + 1, LDV = HDV + 1, LDT = TQ + 1,
                NJ = HD / 16, NJV = HDV / 16, JC = 9;
  static_assert(NJ % JC == 0, "K3's dq columns: whole chunks");
  extern __shared__ float smem[];
  float* sK = smem;            // BK x LD
  float* sV = sK + BK * LD;    // BK x LDV
  float* sQ = sV + BK * LDV;   // TQ x LD, pre-scaled
  float* sO = sQ + TQ * LD;    // TQ x LDV, dO
  float* sP = sO + TQ * LDV;   // BK x LDT, P^T
  float* sD = sP + BK * LDT;   // BK x LDT, P^T (dP^T - delta)
  float* sL = sD + BK * LDT;   // TQ, lse of the q tile
  float* sDl = sL + TQ;        // TQ, delta of the q tile

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int split = blockIdx.x, k0 = blockIdx.y * BK, bkv = blockIdx.z;
  const int KH = H / G;
  const int hps = (G + splits - 1) / splits, h_lo = split * hps;
  const int nh = max(0, min(G, h_lo + hps) - h_lo);
  const int bh0 = (bkv / KH) * H + (bkv % KH) * G + h_lo;
  const int kv_rows = min(BK, Sk - k0);
  load_rows<float, HD, BK, LD, WNT>(sK, k + ((size_t)bkv * Sk + k0) * hd,
                                    kv_rows, 1.f, hd);
  load_rows<float, HDV, BK, LDV, WNT>(sV, v + ((size_t)bkv * Sk + k0) * hd_v,
                                      kv_rows, 1.f, hd_v);

  int q_lo = 0, q_hi = Sq;
  if (causal) q_lo = max(0, k0 - q_offset);
  if (window > 0) q_hi = min(Sq, k0 + kv_rows - 1 + window - q_offset);
  const int qt0 = (q_lo / TQ) * TQ;
  const int n_qt = q_hi > qt0 ? (q_hi - qt0 + TQ - 1) / TQ : 0;

  float adk[NJ], adv[NJV];
#pragma unroll
  for (int j = 0; j < NJ; ++j) adk[j] = 0.f;
#pragma unroll
  for (int j = 0; j < NJV; ++j) adv[j] = 0.f;

  // q tiles from the last down, the slice's heads inside each
  for (int it = 0; it < nh * n_qt; ++it) {
    const int q0 = qt0 + (n_qt - 1 - it / nh) * TQ, bh = bh0 + it % nh;
    __syncthreads();   // the previous tile's reads are done
    const int q_rows = min(TQ, Sq - q0);
    load_rows<float, HD, TQ, LD, WNT>(sQ, q + ((size_t)bh * Sq + q0) * hd,
                                      q_rows, scale, hd);
    load_rows<float, HDV, TQ, LDV, WNT>(
        sO, dout + ((size_t)bh * Sq + q0) * hd_v, q_rows, 1.f, hd_v);
    for (int r = tid; r < TQ; r += WNT) {
      sL[r] = r < q_rows ? lse[(size_t)bh * Sq + q0 + r] : 0.f;
      sDl[r] = r < q_rows ? delta[(size_t)bh * Sq + q0 + r] : 0.f;
    }
    __syncthreads();

    // transposed tiles: s[j] = S[q col tx+16j][kv row ty]
    float s[2] = {0.f, 0.f}, dp[2] = {0.f, 0.f};
#pragma unroll 8
    for (int d = 0; d < hd; ++d) {
      const float a = sK[ty * LD + d];
      s[0] = fmaf(a, sQ[tx * LD + d], s[0]);
      s[1] = fmaf(a, sQ[(tx + 16) * LD + d], s[1]);
    }
#pragma unroll 8
    for (int d = 0; d < hd_v; ++d) {
      const float a = sV[ty * LDV + d];
      dp[0] = fmaf(a, sO[tx * LDV + d], dp[0]);
      dp[1] = fmaf(a, sO[(tx + 16) * LDV + d], dp[1]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int qr = tx + 16 * j;
      const bool live = qr < q_rows && is_live(q_offset + q0 + qr, k0 + ty,
                                               Sk, causal, window);
      const float p = expf((live ? s[j] : NEG_INF) - sL[qr]);
      sP[ty * LDT + qr] = p;
      sD[ty * LDT + qr] = p * (dp[j] - sDl[qr]);
    }
    __syncthreads();

    // dv += P^T dO, dk += dS^T q (q pre-scaled: the reference's dS . q)
#pragma unroll 2
    for (int qq = 0; qq < TQ; ++qq) {
      const float pv = sP[ty * LDT + qq], dsv = sD[ty * LDT + qq];
#pragma unroll
      for (int j = 0; j < NJV; ++j)
        adv[j] = fmaf(pv, sO[qq * LDV + tx + 16 * j], adv[j]);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        adk[j] = fmaf(dsv, sQ[qq * LD + tx + 16 * j], adk[j]);
    }

    if (FUSED) {
      // dq[q0 + 2ty + i][tx + 16j] += sum over the tile's kv rows of dS *
      // scale * k, in chunks of JC columns
#pragma unroll
      for (int jc = 0; jc < NJ; jc += JC) {
        float part[2][JC];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < JC; ++j) part[i][j] = 0.f;
#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
          const float w0 = sD[kk * LDT + 2 * ty] * scale,
                      w1 = sD[kk * LDT + 2 * ty + 1] * scale;
#pragma unroll
          for (int j = 0; j < JC; ++j) {
            const float kv = sK[kk * LD + tx + 16 * (jc + j)];
            part[0][j] = fmaf(w0, kv, part[0][j]);
            part[1][j] = fmaf(w1, kv, part[1][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = 2 * ty + i;
          if (r >= q_rows) continue;
          float* out = dq_acc + ((size_t)bh * Sq + q0 + r) * hd;
#pragma unroll
          for (int j = 0; j < JC; ++j) {
            const int c = tx + 16 * (jc + j);
            if (c < hd) atomicAdd(out + c, part[i][j]);
          }
        }
      }
    }
  }

  if (ty >= kv_rows) return;
  const size_t n_rows = (size_t)gridDim.z * Sk;   // B * KH * Sk
  const size_t row = (size_t)bkv * Sk + k0 + ty;
  float* wk = ws + ((size_t)split * n_rows + row) * hd;
  float* wv = ws + (size_t)splits * n_rows * hd +
              ((size_t)split * n_rows + row) * hd_v;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    if (tx + 16 * j < hd) wk[tx + 16 * j] = adk[j];
#pragma unroll
  for (int j = 0; j < NJV; ++j)
    if (tx + 16 * j < hd_v) wv[tx + 16 * j] = adv[j];
}

// ----------------------------------------------------- the slices' sum

// dk = (sum of the slices' dK partials) * kscale, dv = sum of the dV
// partials, each added in slice order; nk = B*KH*Sk*hd, nv = B*KH*Sk*hd_v
template <typename T>
__global__ void __launch_bounds__(WNT)
dkv_reduce_kernel(const float* __restrict__ ws, T* __restrict__ dk,
                  T* __restrict__ dv, long long nk, long long nv, int splits,
                  float kscale) {
  const long long n = nk + nv;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    if (i < nk) {
      for (int s = 0; s < splits; ++s) acc += ws[s * nk + i];
      dk[i] = from_float<T>(acc * kscale);
    } else {
      const long long j = i - nk;
      for (int s = 0; s < splits; ++s) acc += ws[splits * nk + s * nv + j];
      dv[j] = from_float<T>(acc);
    }
  }
}

// Set the kernel's shared-memory limit, then either report its blocks per
// SM (occupancy non-null) or launch it on `grid`.
template <typename Kern, typename... Args>
cudaError_t run(Kern kern, int* occupancy, dim3 grid, size_t smem,
                cudaStream_t st, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (occupancy != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, kern, WNT,
                                                         smem);
  kern<<<grid, WNT, smem, st>>>(args...);
  return cudaGetLastError();
}

constexpr int HD_W = 576, HDV_W = 512;   // the pair's compiled widths

}  // namespace

cudaError_t wide_fwd(const void* q, const void* k, const void* v, void* o,
                     float* lse, int B, int H, int KH, int Sq, int Sk,
                     int hd, int hd_v, int q_offset, int causal, int window,
                     float scale, int dtype, int* occupancy,
                     cudaStream_t st) {
  const int G = H / KH;
  if (dtype == 0)
    return run(flash_fwd_wide_kernel<HD_W, HDV_W>, occupancy,
               dim3((Sq + 31) / 32, B * H), f32_fwd_bytes<HD_W, HDV_W>(), st,
               static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<float*>(o), lse, H,
               G, Sq, Sk, hd, hd_v, q_offset, causal, window, scale);
  if (dtype == 1)
    return run(flash_fwd_wide_tc_kernel<HD_W, HDV_W>, occupancy,
               dim3(B * H, (Sq + F_BQ - 1) / F_BQ),
               tc_fwd_bytes<HD_W, HDV_W>(), st, static_cast<const bf16*>(q),
               static_cast<const bf16*>(k), static_cast<const bf16*>(v),
               static_cast<bf16*>(o), lse, H, G, Sq, Sk, hd, hd_v, q_offset,
               causal, window, scale);
  return cudaErrorInvalidValue;
}

cudaError_t wide_bwd(int which, const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dq, void* dk, void* dv, float* ws, int splits,
                     int B, int H, int KH, int Sq, int Sk, int hd, int hd_v,
                     int q_offset, int causal, int window, float scale,
                     int dtype, int* occupancy, cudaStream_t st) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const int G = H / KH;
  if (which == 0) {
    if (dtype == 0)
      return run(flash_bwd_dq_wide_kernel<HD_W, HDV_W>, occupancy,
                 dim3((Sq + 31) / 32, B * H), f32_dq_bytes<HD_W, HDV_W>(),
                 st, static_cast<const float*>(q),
                 static_cast<const float*>(k), static_cast<const float*>(v),
                 static_cast<const float*>(dout), lse, delta,
                 static_cast<float*>(dq), H, G, Sq, Sk, hd, hd_v, q_offset,
                 causal, window, scale);
    return run(tc_bwd_dq_wide_kernel<HD_W, HDV_W>, occupancy,
               dim3((Sq + DQ_BQ - 1) / DQ_BQ, B * H),
               tc_dq_bytes<HD_W, HDV_W>(), st, static_cast<const bf16*>(q),
               static_cast<const bf16*>(k), static_cast<const bf16*>(v),
               static_cast<const bf16*>(dout), lse, delta,
               static_cast<bf16*>(dq), H, G, Sq, Sk, hd, hd_v, q_offset,
               causal, window, scale);
  }
  const int rows = dtype == 0 ? 16 : KV_BK;   // kv rows of a dkv block
  const int n_kt = (Sk + rows - 1) / rows;
  if (occupancy == nullptr &&
      (splits < 1 || splits > 65535 || n_kt > 65535 || B * KH > 65535 ||
       ws == nullptr || (which == 2 && dq == nullptr)))
    return cudaErrorInvalidValue;
  const dim3 grid(splits, n_kt, B * KH);
  float* dq_acc = which == 2 ? static_cast<float*>(dq) : nullptr;
  cudaError_t err;
  if (dtype == 0) {
    auto kern = which == 1 ? flash_bwd_dkv_wide_kernel<HD_W, HDV_W, false>
                           : flash_bwd_dkv_wide_kernel<HD_W, HDV_W, true>;
    err = run(kern, occupancy, grid, f32_dkv_bytes<HD_W, HDV_W>(), st,
              static_cast<const float*>(q), static_cast<const float*>(k),
              static_cast<const float*>(v), static_cast<const float*>(dout),
              lse, delta, ws, dq_acc, H, G, Sq, Sk, hd, hd_v, q_offset,
              causal, window, scale, splits);
  } else {
    auto kern = which == 1 ? tc_bwd_dkv_wide_kernel<HD_W, HDV_W, false>
                           : tc_bwd_dkv_wide_kernel<HD_W, HDV_W, true>;
    err = run(kern, occupancy, grid, tc_dkv_bytes<HD_W, HDV_W>(), st,
              static_cast<const bf16*>(q), static_cast<const bf16*>(k),
              static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
              lse, delta, ws, dq_acc, H, G, Sq, Sk, hd, hd_v, q_offset,
              causal, window, scale, splits);
  }
  if (err != cudaSuccess || occupancy != nullptr) return err;
  // the slices' sum: the bf16 kernel leaves dK unscaled, the fp32 one
  // took the scale into q
  const long long nk = (long long)B * KH * Sk * hd;
  const long long nv = (long long)B * KH * Sk * hd_v;
  const long long want = (nk + nv + WNT - 1) / WNT;
  const int blocks = (int)(want < 132 * 8 ? want : 132 * 8);
  if (dtype == 0)
    dkv_reduce_kernel<float><<<blocks, WNT, 0, st>>>(
        ws, static_cast<float*>(dk), static_cast<float*>(dv), nk, nv, splits,
        1.f);
  else
    dkv_reduce_kernel<bf16><<<blocks, WNT, 0, st>>>(
        ws, static_cast<bf16*>(dk), static_cast<bf16*>(dv), nk, nv, splits,
        scale);
  return cudaGetLastError();
}

}  // namespace repro
