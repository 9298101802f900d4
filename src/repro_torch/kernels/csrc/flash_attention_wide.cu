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
// pairs, up to (576, 512), here; TMA and the loaders zero-fill the columns
// past the true widths.  v may be k's first hd_v columns (the absorbed
// route hands v = k[..., :512]): its row stride ldv is then k's.
//
// What bounds them: at B 1, H 128, KH 1, S 4096, causal (kernels/counts.py
// attention_work, computed, not measured) K1-lse does 2.34 TFLOP (2.36 ms
// at 989 TFLOP/s), K2 dq 3.57 (3.61 ms), K2 dkv 4.67 (4.73 ms) and K3
// 5.91 (5.98 ms); q, k, v, dO and the outputs are about 2.3 GB at most,
// 0.7 ms at 3.35 TB/s.  All are compute-bound, so the bf16 K1 and K3 (and
// K2's dk/dv, K3's code) are built on wgmma, the one route to the card's
// tensor-core rate, fed by TMA (csrc/hopper.cuh): a producer warpgroup's
// first thread keeps a two-stage ring of 128-byte-swizzled tiles in
// flight on mbarriers, two or three consumer warpgroups run wgmma on
// them, with setmaxnreg moving the producer's registers to them.  The hi
// + lo pairs cost a second wgmma for each product that takes P or dS, so
// the design does ~1.3x (K1) and ~1.9x (K3) the counted FLOPs.
//
// Limits of one SM: 232,448 B of shared memory and, after setmaxnreg,
// 240 registers a consumer thread.  O (64 x 512 fp32) is 256 registers a
// thread for one warpgroup, so two consumer warpgroups share a 64-row
// block, each holding 256 of the 512 columns (128 fp32).  Q (64 x 576) is
// 73,728 B.
//
// K1 (flash_fwd_wide_tc_kernel): a 64-row q tile of one head.  S = Q K^T
//   is 576 deep; each consumer sums half of the depth (18 k16 steps of
//   m64 x BK) and the two trade halves through shared memory (a + b == b
//   + a: both then hold the same bits of S, m, l and P), so P stays in
//   registers as the A operand of P V and no row maximum or P crosses
//   between them.  The two arrangements that split S by its columns
//   instead (half of each kv tile a warpgroup, or FlashMLA's alternate
//   kv tiles) each make both warpgroups read all of Q's depth from
//   shared memory for their S, where the depth split reads it once per
//   kv row, and they trade P (hi + lo) and the row maxima, where this one
//   trades fp32 partials: at 48 kv rows ~272 KB of shared-memory traffic
//   a tile against ~332 KB for the column split, under the ~2,400 cycles
//   of tensor-core work.  The column splits were not built and measured.
//   Where v is k's first 512 columns (SV), the producer loads only the K
//   tile and P V reads V's columns out of it: 48 kv rows a stage, nine
//   64-column boxes (Q 73,728 B + 2 x 55,296 B + the 24,576 B trade),
//   where separate K and V tiles (V's own TMA map and stages) fit 32.  A
//   warp skips O's rescale when none of its rows' maxima moved.
// K2 dk/dv and K3's dk, dv: 64-row kv tiles; the q tiles of a head slice
//   from the last down and the slice's heads inside each q tile (one 32-
//   row q tile of 128 heads is 8.9 MB of q and dO, which the 50 MB L2
//   holds; all kv tiles' blocks meet it at about the same time), walked
//   in whole 64-row tiles.  dK (64 x 576) and dV (64 x 512) in fp32 are
//   69,632 values, more than an SM's 65,536 registers, so two kernels
//   share the tile's sums, each walking the q tiles once: the dV block
//   (tc_bwd_dv_wide_kernel) splits S^T = K Q^T's depth between its
//   consumers as K1 does and adds P^T dO (256 columns each); the dK
//   block (tc_bwd_dk_wide_kernel) has consumer 1 sum S^T and dP^T = V
//   dO^T and form dS^T, which it hands to consumer 0 through shared
//   memory, and both add dS^T Q: consumer 0 into columns 0..255 and
//   512..575 (160 fp32, with no score work beside them: 128 + 32 and the
//   scores' registers do not fit 240), consumer 1 into 256..511 (whole
//   boxes, which an MN-major operand needs).  Each writes its slice's
//   fp32 partial into the workspace, and dkv_reduce_kernel adds the
//   slices in slice order: no atomics, and K2's dk, dv are K3's bits (K2
//   launches the same kernels with the dS output off).  The slices
//   (autotune.wide_dkv_splits) aim at about four blocks an SM.  A
//   cluster of the two blocks fed by TMA multicast (one load of each q /
//   dO tile for both) ran slower on an H100 (scripts/torch_wide_variants.py
//   --variants, dkv_cluster): 30.6 ms for K2's dk/dv at 1 x 4096 against
//   these two kernels' 22.3, the blocks of a cluster walking in step, so
//   the lighter dV block waits on the dK block.
// K3's dq: the dK block writes dS^T (hi, lo) of every (head, 64-row q
//   tile, 64-row kv tile) pair into a workspace, and
//   tc_bwd_dq_ds_wide_kernel sums dq = scale . dS K for each (head,
//   64-row q tile) over its kv tiles in order (three consumers of 192
//   columns; dS as an MN-major A, K's tile by TMA, shared by the 128
//   heads in L2): no atomics, the same bits on every run.  The workspace
//   holds the pairs of a run of q tiles (a pass, autotune.wide_ds_passes)
//   under autotune.WIDE_DS_CAP; the dK blocks of a later pass resume
//   their partial dK from the workspace, so the sums run in K2's order.
// fp32, CUDA cores (the card's fp32 checks hold the kernels to 1e-4 of the
// plain versions, which TF32 tensor cores would not meet), 256 threads as
// a 16 x 16 grid (ty, tx), operands in shared memory with rows padded to
// an odd stride: K1 32 q rows by 32 kv rows (217,472 B); K2 dq 32 q rows
// by 16 kv rows (211,456 B); K2 dkv and K3 16 kv rows by 32 q rows
// (213,760 B), one kv row a ty, dK and dV columns tx + 16 j; K3's dq by
// atomics.  K2 dq in bf16 keeps mma.sync (eight warps, a 64-row q tile,
// one warp of a row group sums S, the other dP, over a 32-row kv tile).

#include "hopper.cuh"

namespace repro {
namespace {

constexpr int WNT = 256;   // eight warps: the fp32 kernels and K2 dq

// ---------------------------------------------- bf16 K2 dq (mma.sync)

constexpr int DQ_BQ = 64, DQ_BK = 32;

template <int HD, int HDV>
constexpr size_t tc_dq_bytes() {
  return ((size_t)DQ_BQ * (HD + 8 + HDV + 8) +
          (size_t)DQ_BK * (HD + 8 + HDV + 8)) * sizeof(bf16) +
         (size_t)8 * (DQ_BK / 8) * 32 * sizeof(float4);
}
static_assert(tc_dq_bytes<576, 512>() <= 232448, "K2 dq tiles");

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


// K2 dq: one block per (64-row q tile, b*H + h)
template <int HD, int HDV>
__global__ void __launch_bounds__(WNT, 1)
tc_bwd_dq_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dq,
                      int H, int G, int Sq, int Sk, int hd, int hd_v,
                      int ldv, int q_offset, int causal, int window,
                      float scale) {
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
  const bf16* vp = v + (size_t)bkv * Sk * ldv;
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
    cp_tile<HDV, BK, LDV, WNT>(sV, vp + (size_t)k0 * ldv, Sk - k0, hd_v,
                               ldv);
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

// Hand a warpgroup's accumulator to the other consumer warpgroup through
// shared memory: slot w holds warpgroup w's registers, thread-major, so
// thread t reads the same (row, column) positions of the other's.
template <int R>
__device__ __forceinline__ void put_acc(float4* x, int w, int t,
                                        const float (&d)[R]) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j)
    x[(w * (R / 4) + j) * WG + t] =
        make_float4(d[4 * j], d[4 * j + 1], d[4 * j + 2], d[4 * j + 3]);
}

template <int R>
__device__ __forceinline__ void get_acc(float (&d)[R], const float4* x, int w,
                                        int t) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    const float4 y = x[(w * (R / 4) + j) * WG + t];
    d[4 * j] = y.x;
    d[4 * j + 1] = y.y;
    d[4 * j + 2] = y.z;
    d[4 * j + 3] = y.w;
  }
}

// The 64-row kv tiles [lo, hi) that the 64-row q tile at q0 meets; the
// dS workspace of K3 holds one tile pair for each (autotune.wide_kv_tiles)
__device__ __forceinline__ void ds_kv_tiles(int q0, int q_offset, int Sk,
                                            int causal, int window, int& lo,
                                            int& hi) {
  const int row0 = q_offset + q0;
  int kv_begin = 0, kv_end = Sk;
  if (causal) kv_end = min(Sk, row0 + 64);
  if (window > 0) kv_begin = max(0, row0 - window + 1);
  lo = kv_begin / 64;
  hi = kv_end > kv_begin ? (kv_end + 63) / 64 : lo;
}

// tile pairs of the 64-row q tiles [qa, qb) (tile indices)
__device__ __forceinline__ int ds_pairs(int qa, int qb, int q_offset, int Sk,
                                        int causal, int window) {
  int n = 0;
  for (int qt = qa; qt < qb; ++qt) {
    int lo, hi;
    ds_kv_tiles(qt * 64, q_offset, Sk, causal, window, lo, hi);
    n += hi - lo;
  }
  return n;
}

// -------------------------------------------------- K1 / K1-lse (wgmma)

constexpr int F_BQ = 64;   // q rows of a K1 block: wgmma's M
// kv rows of a stage: 48 where v is k's prefix (one tile for both), 32
// where v comes apart
template <bool SV> constexpr int f_bk() { return SV ? 48 : 32; }

// setmaxnreg moves registers inside a block's own allocation: ptxas gives
// the three-warpgroup kernels (K1, dV, dK) 168 registers a thread, the
// producer warpgroup hands back 168 - 24 a thread and the two consumers
// take 240 - 168 (a consumer's half of O, 64 x 256 fp32, is 128 of them);
// the dq kernel's four warpgroups start at 128, its three consumers take
// 160.  A consumer asking for more than its producer gave back would wait
// forever.
static_assert(WG * (168 - 24) >= 2 * WG * (240 - 168), "K1, dV, dK registers");
static_assert(WG * (128 - 24) >= 3 * WG * (160 - 128), "K3 dq registers");
static_assert(F_BQ * 512 / (2 * WG) == 128, "a consumer's half of O");

template <bool SV>
constexpr size_t k1_bytes() {
  return SMEM_ALIGN + (size_t)F_BQ * HD_BOXES * BOX * 2 +
         (size_t)2 * f_bk<SV>() * (HD_BOXES + (SV ? 0 : HDV_BOXES)) * BOX * 2 +
         (size_t)2 * F_BQ * f_bk<SV>() * 4 + 8 * 8;
}
static_assert(k1_bytes<true>() <= 232448, "K1 tiles, v k's prefix");
static_assert(k1_bytes<false>() <= 232448, "K1 tiles, v apart");

// K1: one block per (b*H + h, 64-row q tile), q tiles heaviest first.
// Warpgroups 0, 1 consume, warpgroup 2's first thread feeds TMA.
template <int BK, bool SV>
__global__ void __launch_bounds__(3 * WG, 1)
flash_fwd_wide_tc_kernel(const __grid_constant__ CUtensorMap tmq,
                         const __grid_constant__ CUtensorMap tmk,
                         const __grid_constant__ CUtensorMap tmv,
                         bf16* __restrict__ o, float* __restrict__ lse,
                         int H, int G, int Sq, int Sk, int hd, int hd_v,
                         int q_offset, int causal, int window, float scale) {
  constexpr int NS = BK / 2;           // S registers a thread: BK / 8 n8
  constexpr int KSTAGE = HD_BOXES * BK * BOX, VSTAGE = HDV_BOXES * BK * BOX;
  bf16* sQ = smem_tiles();                  // 9 boxes of 64 rows
  bf16* sK = sQ + HD_BOXES * F_BQ * BOX;               // 2 stages
  bf16* sV = sK + 2 * KSTAGE;                          // 2 stages (not SV)
  float4* sX = reinterpret_cast<float4*>(sV + (SV ? 0 : 2 * VSTAGE));
  uint64_t* bars = reinterpret_cast<uint64_t*>(sX + 2 * (NS / 4) * WG);
  uint64_t *qbar = bars, *full = bars + 1, *empty = bars + 3;

  const int bh = blockIdx.x;                          // b * H + h
  const int q0 = (gridDim.y - 1 - blockIdx.y) * F_BQ;
  const int bkv = (bh / H) * (H / G) + (bh % H) / G;  // b * KH + h / G
  const int row0 = q_offset + q0;
  int kv_begin = 0, kv_end = Sk;
  if (causal) kv_end = min(Sk, row0 + F_BQ);
  if (window > 0) kv_begin = max(0, row0 - window + 1);
  const int kt0 = (kv_begin / BK) * BK;
  const int n_it = kv_end > kt0 ? (kv_end - kt0 + BK - 1) / BK : 0;

  init_ring(bars, 1, 2 * WG);
  const int wg = warpgroup();

  if (wg == 2) {   // the producer
    reg_dealloc<24>();
    if (threadIdx.x == 2 * WG) {
      mbar_expect(qbar, HD_BOXES * F_BQ * BOX * 2);
      for (int b = 0; b < HD_BOXES; ++b)
        tma_load(sQ + b * F_BQ * BOX, tmq, qbar, b * BOX, q0, bh);
      for (int it = 0; it < n_it; ++it) {
        const int st = it & 1, k0 = kt0 + it * BK;
        mbar_wait(&empty[st], ((it >> 1) & 1) ^ 1);
        mbar_expect(&full[st], (KSTAGE + (SV ? 0 : VSTAGE)) * 2);
        for (int b = 0; b < HD_BOXES; ++b)
          tma_load(sK + st * KSTAGE + b * BK * BOX, tmk, &full[st], b * BOX,
                   k0, bkv);
        if (!SV)
          for (int b = 0; b < HDV_BOXES; ++b)
            tma_load(sV + st * VSTAGE + b * BK * BOX, tmv, &full[st],
                     b * BOX, k0, bkv);
      }
    }
  } else {         // a consumer: half of S's depth, half of O's columns
    reg_alloc<240>();
    const int t = threadIdx.x % WG, lane = t & 31;
    const int g = lane >> 2, tq = lane & 3, r_lo = (t >> 5) * 16 + g;
    const int nks = (hd + 15) / 16, ks_lo = wg * ((nks + 1) / 2);
    const int ks_hi = min(nks, ks_lo + (nks + 1) / 2);
    float acc[128];
    zero_acc(acc);
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    mbar_wait(qbar, 0);

    for (int it = 0; it < n_it; ++it) {
      const int st = it & 1, k0 = kt0 + it * BK;
      const bf16* Ks = sK + st * KSTAGE;
      const bf16* Vs = SV ? Ks : sV + st * VSTAGE;
      mbar_wait(&full[st], (it >> 1) & 1);

      // this warpgroup's half of S = Q K^T, then the other's
      float s[NS];
      zero_acc(s);
      fence_regs(s);
      wgmma_fence();
      for (int ks = ks_lo; ks < ks_hi; ++ks)
        wgmma_ss<0, 0>(s, kmaj(sQ, F_BQ, ks), kmaj(Ks, BK, ks));
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);
      wg_pair_sync(1);   // the other has read the previous tile's half
      put_acc(sX, wg, t, s);
      wg_pair_sync(2);
      {
        float y[NS];
        get_acc(y, sX, wg ^ 1, t);
#pragma unroll
        for (int i = 0; i < NS; ++i) s[i] += y[i];   // a + b == b + a
      }

      const bool full_tile = k0 + BK <= Sk &&
                             (!causal || k0 + BK - 1 <= row0) &&
                             (window <= 0 || row0 + F_BQ - 1 - k0 < window);
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int row = row0 + r_lo + 8 * ((i >> 1) & 1);
        const int col = k0 + 8 * (i >> 2) + 2 * tq + (i & 1);
        s[i] = full_tile || is_live(row, col, Sk, causal, window)
                   ? s[i] * scale : NEG_INF;
      }
      // online softmax: a row lives in the 4 lanes of a quad
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < NS; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        alpha[i] = __expf(m[i] - mx[i]);
        m[i] = mx[i];
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        s[i] = __expf(s[i] - m[(i >> 1) & 1]);
        rs[(i >> 1) & 1] += s[i];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
      // O's rescale, skipped by a warp whose rows kept their maxima (x 1
      // is exact): 128 multiplies a thread a tile
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f))
#pragma unroll
        for (int i = 0; i < 128; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // O[:, 256 wg ..] += P V: P as a bf16 hi + lo pair from registers,
      // V's columns 256 wg.. (four boxes) MN-major
      uint32_t hi[BK / 16][4], lo[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) frag_pair(s, kk, hi[kk], lo[kk]);
      fence_regs(hi);
      fence_regs(lo);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t vd = mnmaj(Vs, BK, 4 * wg, kk);
        wgmma_rs<1>(acc, hi[kk], vd);
        wgmma_rs<1>(acc, lo[kk], vd);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc);
      mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
    const int q_rows = min(F_BQ, Sq - q0);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r_lo + 8 * i;
      if (r >= q_rows) continue;
      const float den = fmaxf(l[i], 1e-37f);
      if (lse != nullptr && wg == 0 && tq == 0)
        lse[(size_t)bh * Sq + q0 + r] = m[i] + logf(den);
      bf16* out = o + ((size_t)bh * Sq + q0 + r) * hd_v;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int c = 256 * wg + 8 * j + 2 * tq;
        if (c < hd_v)
          *reinterpret_cast<__nv_bfloat162*>(out + c) = __floats2bfloat162_rn(
              acc[4 * j + 2 * i] / den, acc[4 * j + 2 * i + 1] / den);
      }
    }
  }
}

// --------------------------------------------- K2 dk/dv and K3 (wgmma)

constexpr int KV_T = 64;   // kv rows of a dk / dv block: wgmma's M
constexpr int DV_TQ = 32;  // q rows of a stage of the dV block
// q rows of a stage of the dK block: 16 where v comes apart (its own tile)
template <bool SV> constexpr int dk_tq() { return SV ? 32 : 16; }

constexpr size_t dv_bytes() {
  return SMEM_ALIGN + (size_t)KV_T * HD_BOXES * BOX * 2 +
         (size_t)2 * DV_TQ * (HD_BOXES + HDV_BOXES) * BOX * 2 +
         (size_t)2 * KV_T * DV_TQ * 4 + 8 * 8;
}
// K and (where v comes apart) V; two q / dO stages; consumer 1's S^T
// scratch (fp32) and the dS^T it hands over (bf16 hi + lo); lse, delta
template <bool SV>
constexpr size_t dk_bytes() {
  return SMEM_ALIGN + (size_t)KV_T * (HD_BOXES + (SV ? 0 : HDV_BOXES)) * BOX * 2 +
         (size_t)2 * dk_tq<SV>() * (HD_BOXES + HDV_BOXES) * BOX * 2 +
         (size_t)KV_T * dk_tq<SV>() * 4 + (size_t)KV_T * dk_tq<SV>() * 2 * 2 +
         (size_t)4 * dk_tq<SV>() * 4 + 8 * 8;
}
static_assert(dv_bytes() <= 232448, "dV tiles");
static_assert(dk_bytes<true>() <= 232448, "dK tiles, v k's prefix");
static_assert(dk_bytes<false>() <= 232448, "dK tiles, v apart");

// The q tiles a dk / dv block walks for its 64-row kv tile at k0: rows
// [*qt0, *qt0 + n * TQ) in TQ-row tiles, whole 64-row tiles (so that K3
// writes both halves of every dS tile pair the dq pass reads), inside the
// pass's rows [pa, pb).
template <int TQ>
__device__ __forceinline__ int dkv_q_tiles(int k0, int kv_rows, int Sq,
                                           int q_offset, int causal,
                                           int window, int pa, int pb,
                                           int* qt0) {
  int q_lo = 0, q_hi = Sq;
  if (causal) q_lo = max(0, k0 - q_offset);
  if (window > 0) q_hi = min(Sq, k0 + kv_rows - 1 + window - q_offset);
  const int lo = max(pa, (q_lo / 64) * 64);
  const int hi = min(pb, (q_hi + 63) / 64 * 64);
  *qt0 = lo;
  return q_hi > q_lo && hi > lo ? (hi - lo) / TQ : 0;
}

// dK / dV block's head slice: (first b*H + h, heads)
__device__ __forceinline__ int slice_heads(int bkv, int H, int G, int split,
                                           int splits, int* bh0) {
  const int KH = H / G;
  const int hps = (G + splits - 1) / splits, h_lo = split * hps;
  *bh0 = (bkv / KH) * H + (bkv % KH) * G + h_lo;
  return max(0, min(G, h_lo + hps) - h_lo);
}

// dV: one block per (head slice, 64-row kv tile, b*KH + kh).  Both
// consumers sum half of S^T = K Q^T's depth and trade halves; each adds
// P^T dO into 256 of dV's columns.  The slice's fp32 partial dV goes to
// ws (after the splits' dK partials).
__global__ void __launch_bounds__(3 * WG, 1)
tc_bwd_dv_wide_kernel(const __grid_constant__ CUtensorMap tmk,
                      const __grid_constant__ CUtensorMap tmq,
                      const __grid_constant__ CUtensorMap tmo,
                      const float* __restrict__ lse, float* __restrict__ ws,
                      int H, int G, int Sq, int Sk, int hd, int hd_v,
                      int q_offset, int causal, int window, float scale,
                      int splits) {
  constexpr int TQ = DV_TQ, NS = TQ / 2;
  constexpr int QSTAGE = HD_BOXES * TQ * BOX, OSTAGE = HDV_BOXES * TQ * BOX;
  bf16* sK = smem_tiles();
  bf16* sQ = sK + HD_BOXES * KV_T * BOX;   // 2 stages
  bf16* sO = sQ + 2 * QSTAGE;              // 2 stages of dO
  float4* sX = reinterpret_cast<float4*>(sO + 2 * OSTAGE);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sX + 2 * (NS / 4) * WG);
  uint64_t *kbar = bars, *full = bars + 1, *empty = bars + 3;

  const int split = blockIdx.x, k0 = blockIdx.y * KV_T, bkv = blockIdx.z;
  int bh0, qt0;
  const int nh = slice_heads(bkv, H, G, split, splits, &bh0);
  const int kv_rows = min(KV_T, Sk - k0);
  const int n_qt = dkv_q_tiles<TQ>(k0, kv_rows, Sq, q_offset, causal,
                                   window, 0, Sq + 63, &qt0);
  const int n_it = nh * n_qt;

  init_ring(bars, 1, 2 * WG);
  const int wg = warpgroup();

  if (wg == 2) {
    reg_dealloc<24>();
    if (threadIdx.x == 2 * WG) {
      mbar_expect(kbar, HD_BOXES * KV_T * BOX * 2);
      for (int b = 0; b < HD_BOXES; ++b)
        tma_load(sK + b * KV_T * BOX, tmk, kbar, b * BOX, k0, bkv);
      // iteration it: q tile qt0 + (n_qt - 1 - it / nh) * TQ (the last
      // first), head bh0 + it % nh
      for (int it = 0; it < n_it; ++it) {
        const int st = it & 1;
        const int q0 = qt0 + (n_qt - 1 - it / nh) * TQ, bh = bh0 + it % nh;
        mbar_wait(&empty[st], ((it >> 1) & 1) ^ 1);
        mbar_expect(&full[st], (QSTAGE + OSTAGE) * 2);
        for (int b = 0; b < HD_BOXES; ++b)
          tma_load(sQ + st * QSTAGE + b * TQ * BOX, tmq, &full[st], b * BOX,
                   q0, bh);
        for (int b = 0; b < HDV_BOXES; ++b)
          tma_load(sO + st * OSTAGE + b * TQ * BOX, tmo, &full[st], b * BOX,
                   q0, bh);
      }
    }
  } else {
    reg_alloc<240>();
    const int t = threadIdx.x % WG, lane = t & 31;
    const int g = lane >> 2, tq = lane & 3, r_lo = (t >> 5) * 16 + g;
    const int nks = (hd + 15) / 16, ks_lo = wg * ((nks + 1) / 2);
    const int ks_hi = min(nks, ks_lo + (nks + 1) / 2);
    float adv[128];
    zero_acc(adv);
    mbar_wait(kbar, 0);

    for (int it = 0; it < n_it; ++it) {
      const int st = it & 1;
      const int q0 = qt0 + (n_qt - 1 - it / nh) * TQ, bh = bh0 + it % nh;
      float ls[NS / 2];   // lse of this thread's q columns
#pragma unroll
      for (int i = 0; i < NS / 2; ++i) {
        const int qc = q0 + 8 * (i >> 1) + 2 * tq + (i & 1);
        ls[i] = qc < Sq ? lse[(size_t)bh * Sq + qc] : 0.f;
      }
      const bf16* Qs = sQ + st * QSTAGE;
      mbar_wait(&full[st], (it >> 1) & 1);

      float s[NS];   // S^T: kv rows, q columns
      zero_acc(s);
      fence_regs(s);
      wgmma_fence();
      for (int ks = ks_lo; ks < ks_hi; ++ks)
        wgmma_ss<0, 0>(s, kmaj(sK, KV_T, ks), kmaj(Qs, TQ, ks));
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);
      wg_pair_sync(1);
      put_acc(sX, wg, t, s);
      wg_pair_sync(2);
      {
        float y[NS];
        get_acc(y, sX, wg ^ 1, t);
#pragma unroll
        for (int i = 0; i < NS; ++i) s[i] += y[i];
      }
      // P^T, masked
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int qr = 8 * (i >> 2) + 2 * tq + (i & 1);
        const int col = k0 + r_lo + 8 * ((i >> 1) & 1);
        const bool live = q0 + qr < Sq &&
                          is_live(q_offset + q0 + qr, col, Sk, causal, window);
        s[i] = expf((live ? s[i] * scale : NEG_INF) -
                    ls[((i >> 2) << 1) | (i & 1)]);
      }
      // dV[:, 256 wg ..] += P^T dO
      uint32_t hi[TQ / 16][4], lo[TQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < TQ / 16; ++kk) frag_pair(s, kk, hi[kk], lo[kk]);
      const bf16* Os = sO + st * OSTAGE;
      fence_regs(hi);
      fence_regs(lo);
      fence_regs(adv);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TQ / 16; ++kk) {
        const uint64_t od = mnmaj(Os, TQ, 4 * wg, kk);
        wgmma_rs<1>(adv, hi[kk], od);
        wgmma_rs<1>(adv, lo[kk], od);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(adv);
      mbar_arrive(&empty[st]);
    }

    // this slice's partial dV (the splits' dK partials come first in ws)
    const size_t n_rows = (size_t)gridDim.z * Sk;   // B * KH * Sk
    float* wv = ws + (size_t)splits * n_rows * hd +
                (size_t)split * n_rows * hd_v;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r_lo + 8 * i;
      if (r >= kv_rows) continue;
      float* out = wv + ((size_t)bkv * Sk + k0 + r) * hd_v;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int c = 256 * wg + 8 * j + 2 * tq;
        if (c < hd_v)
          *reinterpret_cast<float2*>(out + c) =
              make_float2(adv[4 * j + 2 * i], adv[4 * j + 2 * i + 1]);
      }
    }
  }
}

// Columns c0 + 8 j + 2 tq (+1) of a dK block's accumulator (wgmma's
// layout, R / 4 n8 blocks) and the slice's fp32 partial dK in ws: STORE
// writes them, else reads them back (a later pass resuming the sum).
template <bool STORE, int R>
__device__ __forceinline__ void dk_part(float* wk, int bkv, int Sk, int k0,
                                        int kv_rows, int hd, int c0, int r_lo,
                                        int tq, float (&a)[R]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_lo + 8 * i;
    if (r >= kv_rows) continue;
    float* row = wk + ((size_t)bkv * Sk + k0 + r) * hd;
#pragma unroll
    for (int j = 0; j < R / 4; ++j) {
      const int c = c0 + 8 * j + 2 * tq;
      if (c >= hd) continue;
      if (STORE) {
        *reinterpret_cast<float2*>(row + c) =
            make_float2(a[4 * j + 2 * i], a[4 * j + 2 * i + 1]);
      } else {
        const float2 v = *reinterpret_cast<const float2*>(row + c);
        a[4 * j + 2 * i] = v.x;
        a[4 * j + 2 * i + 1] = v.y;
      }
    }
  }
}

// dK (K2's dk half, and K3's with DS): one block per (head slice, 64-row
// kv tile, b*KH + kh).  Consumer 1 sums S^T = K Q^T (into its own
// scratch) and dP^T = V dO^T, forms dS^T = P^T (dP^T - delta) as a bf16
// hi + lo pair and hands it to consumer 0 through shared memory; both add
// dS^T Q, consumer 0 into dK's columns 0..255 and 512..575 (160 fp32 a
// thread, and no score work beside them), consumer 1 into 256..511 (128).
// Consumer 0's product overlaps consumer 1's next scores.  With DS,
// consumer 0 writes dS^T into the pass's dS workspace for
// tc_bwd_dq_ds_wide_kernel.  Only the q rows [pa, pb) are walked; `carry`
// resumes the slice's partial dK that an earlier pass left in ws.
template <int TQ, bool SV, bool DS>
__global__ void __launch_bounds__(3 * WG, 1)
tc_bwd_dk_wide_kernel(const __grid_constant__ CUtensorMap tmk,
                      const __grid_constant__ CUtensorMap tmv,
                      const __grid_constant__ CUtensorMap tmq,
                      const __grid_constant__ CUtensorMap tmo,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ ws, bf16* __restrict__ ds,
                      int H, int G, int Sq, int Sk, int hd, int hd_v,
                      int q_offset, int causal, int window, float scale,
                      int splits, int pa, int pb, int pass_pairs,
                      int carry) {
  constexpr int NS = TQ / 2, NK = TQ / 16;
  constexpr int KTILE = HD_BOXES * KV_T * BOX;
  constexpr int QSTAGE = HD_BOXES * TQ * BOX, OSTAGE = HDV_BOXES * TQ * BOX;
  bf16* sK = smem_tiles();
  bf16* sV = sK + KTILE;                         // not SV: V's own tile
  bf16* sQ = sV + (SV ? 0 : HDV_BOXES * KV_T * BOX);   // 2 stages
  bf16* sO = sQ + 2 * QSTAGE;                    // 2 stages of dO
  float4* sS = reinterpret_cast<float4*>(sO + 2 * OSTAGE);  // consumer 1's S^T
  uint32_t* sP = reinterpret_cast<uint32_t*>(sS + (NS / 4) * WG);  // dS^T
  float* sL = reinterpret_cast<float*>(sP + NK * 8 * WG);  // 2 x TQ lse
  float* sD = sL + 2 * TQ;                                 // 2 x TQ delta
  uint64_t* bars = reinterpret_cast<uint64_t*>(sD + 2 * TQ);
  uint64_t *kbar = bars, *full = bars + 1, *empty = bars + 3;

  const int split = blockIdx.x, k0 = blockIdx.y * KV_T, bkv = blockIdx.z;
  const int kt = blockIdx.y;
  int bh0, qt0;
  const int nh = slice_heads(bkv, H, G, split, splits, &bh0);
  const int kv_rows = min(KV_T, Sk - k0);
  const int n_qt = dkv_q_tiles<TQ>(k0, kv_rows, Sq, q_offset, causal,
                                   window, pa, pb, &qt0);
  const int n_it = nh * n_qt;
  const size_t n_rows = (size_t)gridDim.z * Sk;   // B * KH * Sk
  float* wk = ws + (size_t)split * n_rows * hd;
  if (n_it == 0 && carry) return;   // an earlier pass holds the partial
  // iteration it: q tile qt0 + (n_qt - 1 - it / nh) * TQ (the last
  // first), head bh0 + it % nh
  auto q_of = [&](int it) { return qt0 + (n_qt - 1 - it / nh) * TQ; };
  auto bh_of = [&](int it) { return bh0 + it % nh; };

  init_ring(bars, 1, 2 * WG);
  const int wg = warpgroup();

  if (wg == 2) {
    reg_dealloc<24>();
    if (threadIdx.x == 2 * WG) {
      mbar_expect(kbar, (KTILE + (SV ? 0 : HDV_BOXES * KV_T * BOX)) * 2);
      for (int b = 0; b < HD_BOXES; ++b)
        tma_load(sK + b * KV_T * BOX, tmk, kbar, b * BOX, k0, bkv);
      if (!SV)
        for (int b = 0; b < HDV_BOXES; ++b)
          tma_load(sV + b * KV_T * BOX, tmv, kbar, b * BOX, k0, bkv);
      for (int it = 0; it < n_it; ++it) {
        const int st = it & 1, q0 = q_of(it), bh = bh_of(it);
        mbar_wait(&empty[st], ((it >> 1) & 1) ^ 1);
        mbar_expect(&full[st], (QSTAGE + OSTAGE) * 2);
        for (int b = 0; b < HD_BOXES; ++b)
          tma_load(sQ + st * QSTAGE + b * TQ * BOX, tmq, &full[st], b * BOX,
                   q0, bh);
        for (int b = 0; b < HDV_BOXES; ++b)
          tma_load(sO + st * OSTAGE + b * TQ * BOX, tmo, &full[st], b * BOX,
                   q0, bh);
      }
    }
    return;
  }
  reg_alloc<240>();
  const int t = threadIdx.x % WG, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3, r_lo = (t >> 5) * 16 + g;
  // consumer 0 puts the q rows' lse and delta in shared memory one tile
  // ahead of consumer 1, which forms dS^T with them
  auto stage_ld = [&](int it) {
    if (t < TQ) {
      const int q = q_of(it) + t, b = it & 1;
      const size_t row = (size_t)bh_of(it) * Sq + q;
      sL[b * TQ + t] = q < Sq ? lse[row] : 0.f;
      sD[b * TQ + t] = q < Sq ? delta[row] : 0.f;
    }
  };
  if (wg == 0 && n_it > 0) stage_ld(0);
  wg_pair_sync(3);
  mbar_wait(kbar, 0);

  if (wg == 0) {
    float adk[128], adk8[32];
    zero_acc(adk);
    zero_acc(adk8);
    if (carry) {
      dk_part<false>(wk, bkv, Sk, k0, kv_rows, hd, 0, r_lo, tq, adk);
      dk_part<false>(wk, bkv, Sk, k0, kv_rows, hd, 512, r_lo, tq, adk8);
    }
    int slot_qt = -1, slot0 = 0;   // K3: the dS tile pair's slot
    for (int it = 0; it < n_it; ++it) {
      const int st = it & 1, q0 = q_of(it), bh = bh_of(it);
      if (it + 1 < n_it) stage_ld(it + 1);
      wg_pair_sync(1);   // consumer 1's dS^T of this tile is in sP
      uint32_t hi[NK][4], lo[NK][4];
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          hi[kk][e] = sP[(kk * 8 + e) * WG + t];
          lo[kk][e] = sP[(kk * 8 + 4 + e) * WG + t];
        }
      if (it + 1 < n_it) wg_pair_arrive(2);   // sP may be written again
      if (DS) {
        // dS^T into the pass's workspace: tile pair (bh, q tile, kv
        // tile) of 64 kv rows by 64 q columns, hi then lo
        const int qt = q0 / 64;
        if (qt != slot_qt) {
          int lo_t, hi_t;
          ds_kv_tiles(qt * 64, q_offset, Sk, causal, window, lo_t, hi_t);
          slot_qt = qt;
          slot0 = ds_pairs(pa / 64, qt, q_offset, Sk, causal, window) + kt -
                  lo_t;
        }
        bf16* tile = ds + ((size_t)bh * pass_pairs + slot0) * 2 * 64 * 64;
#pragma unroll
        for (int kk = 0; kk < NK; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // fragment register e: kv row r_lo (+8 for e odd), q columns
            // 16 kk + 2 tq (+8 for e >= 2)
            const int r = r_lo + 8 * (e & 1);
            const int c = q0 % 64 + 16 * kk + 2 * tq + 8 * (e >> 1);
            *reinterpret_cast<uint32_t*>(tile + r * 64 + c) = hi[kk][e];
            *reinterpret_cast<uint32_t*>(tile + 64 * 64 + r * 64 + c) =
                lo[kk][e];
          }
      }
      const bf16* Qs = sQ + st * QSTAGE;
      mbar_wait(&full[st], (it >> 1) & 1);
      fence_regs(hi);
      fence_regs(lo);
      fence_regs(adk);
      fence_regs(adk8);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const uint64_t qa = mnmaj(Qs, TQ, 0, kk), qb = mnmaj(Qs, TQ, 8, kk);
        wgmma_rs<1>(adk, hi[kk], qa);
        wgmma_rs<1>(adk, lo[kk], qa);
        wgmma_rs<1>(adk8, hi[kk], qb);
        wgmma_rs<1>(adk8, lo[kk], qb);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(adk);
      fence_regs(adk8);
      mbar_arrive(&empty[st]);
    }
    // this slice's partial dK (unscaled), to be resumed or summed
    dk_part<true>(wk, bkv, Sk, k0, kv_rows, hd, 0, r_lo, tq, adk);
    dk_part<true>(wk, bkv, Sk, k0, kv_rows, hd, 512, r_lo, tq, adk8);
  } else {
    float adk[128];
    zero_acc(adk);
    if (carry) dk_part<false>(wk, bkv, Sk, k0, kv_rows, hd, 256, r_lo, tq, adk);
    const int nks = (hd + 15) / 16, nvs = (hd_v + 15) / 16;
    const bf16* Vt = SV ? sK : sV;
    for (int it = 0; it < n_it; ++it) {
      const int st = it & 1, q0 = q_of(it);
      const bf16* Qs = sQ + st * QSTAGE;
      const bf16* Os = sO + st * OSTAGE;
      mbar_wait(&full[st], (it >> 1) & 1);
      // S^T over hd into this warpgroup's scratch, then dP^T over hd_v
      float x[NS];
      zero_acc(x);
      fence_regs(x);
      wgmma_fence();
      for (int ks = 0; ks < nks; ++ks)
        wgmma_ss<0, 0>(x, kmaj(sK, KV_T, ks), kmaj(Qs, TQ, ks));
      wgmma_commit();
      wgmma_wait();
      fence_regs(x);
      put_acc(sS, 0, t, x);
      zero_acc(x);
      fence_regs(x);
      wgmma_fence();
      for (int ks = 0; ks < nvs; ++ks)
        wgmma_ss<0, 0>(x, kmaj(Vt, KV_T, ks), kmaj(Os, TQ, ks));
      wgmma_commit();
      wgmma_wait();
      fence_regs(x);
      // dS^T = P^T (dP^T - delta), unscaled, into x
      const float* Ls = sL + st * TQ;
      const float* Ds = sD + st * TQ;
#pragma unroll
      for (int j = 0; j < NS / 4; ++j) {
        const float4 s4 = sS[j * WG + t];
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e, qr = 8 * j + 2 * tq + (e & 1);
          const int col = k0 + r_lo + 8 * (e >> 1);
          const bool live = q0 + qr < Sq && is_live(q_offset + q0 + qr, col,
                                                    Sk, causal, window);
          const float p = expf((live ? sv[e] * scale : NEG_INF) - Ls[qr]);
          x[i] = p * (x[i] - Ds[qr]);
        }
      }
      uint32_t hi[NK][4], lo[NK][4];
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) frag_pair(x, kk, hi[kk], lo[kk]);
      if (it > 0) wg_pair_sync(2);   // consumer 0 has read the last dS^T
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sP[(kk * 8 + e) * WG + t] = hi[kk][e];
          sP[(kk * 8 + 4 + e) * WG + t] = lo[kk][e];
        }
      wg_pair_sync(1);
      fence_regs(hi);
      fence_regs(lo);
      fence_regs(adk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const uint64_t qa = mnmaj(Qs, TQ, 4, kk);
        wgmma_rs<1>(adk, hi[kk], qa);
        wgmma_rs<1>(adk, lo[kk], qa);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(adk);
      mbar_arrive(&empty[st]);
    }
    dk_part<true>(wk, bkv, Sk, k0, kv_rows, hd, 256, r_lo, tq, adk);
  }
}

// K3's dq = scale * sum over kv tiles of dS K, one block per (64-row q
// tile of the pass, b*H + h): dS (hi and lo, as the dK blocks wrote it,
// kv rows by q columns: MN-major A) and K's tile by TMA, the kv tiles in
// order, no atomics.  Warpgroups 0..2 each own 192 of dq's columns (three
// boxes), warpgroup 3's first thread feeds TMA.
constexpr size_t dq_bytes() {
  return SMEM_ALIGN + (size_t)2 * (2 * 64 * 64 + KV_T * HD_BOXES * BOX) * 2 +
         8 * 8;
}
static_assert(dq_bytes() <= 232448, "K3 dq tiles");

__global__ void __launch_bounds__(4 * WG, 1)
tc_bwd_dq_ds_wide_kernel(const __grid_constant__ CUtensorMap tmds,
                         const __grid_constant__ CUtensorMap tmk,
                         bf16* __restrict__ dq, int H, int G, int Sq, int Sk,
                         int hd, int q_offset, int causal, int window,
                         float scale, int pa, int pass_pairs) {
  constexpr int DSTILE = 64 * 64, KTILE = HD_BOXES * KV_T * BOX;
  constexpr int STAGE = 2 * DSTILE + KTILE;
  bf16* sS = smem_tiles();   // 2 stages: dS hi, dS lo, K
  uint64_t* bars = reinterpret_cast<uint64_t*>(sS + 2 * STAGE);
  uint64_t *full = bars, *empty = bars + 2;

  const int qt = pa / 64 + blockIdx.x, q0 = qt * 64, bh = blockIdx.y;
  const int bkv = (bh / H) * (H / G) + (bh % H) / G;
  int kt_lo, kt_hi;
  ds_kv_tiles(q0, q_offset, Sk, causal, window, kt_lo, kt_hi);
  const int n_it = kt_hi - kt_lo;

  init_ring(bars, 0, 3 * WG);
  const int wg = warpgroup();

  if (wg == 3) {
    reg_dealloc<24>();
    if (threadIdx.x == 3 * WG) {
      const int slot0 = ds_pairs(pa / 64, qt, q_offset, Sk, causal, window);
      for (int it = 0; it < n_it; ++it) {
        const int st = it & 1;
        bf16* S = sS + st * STAGE;
        mbar_wait(&empty[st], ((it >> 1) & 1) ^ 1);
        mbar_expect(&full[st], STAGE * 2);
        // rows of the workspace's (rows, 64) view: tile pair, then hi / lo
        const int row = (int)(((size_t)bh * pass_pairs + slot0 + it) * 2) * 64;
        tma_load(S, tmds, &full[st], 0, row, 0);
        tma_load(S + DSTILE, tmds, &full[st], 0, row + 64, 0);
        for (int b = 0; b < HD_BOXES; ++b)
          tma_load(S + 2 * DSTILE + b * KV_T * BOX, tmk, &full[st], b * BOX,
                   (kt_lo + it) * KV_T, bkv);
      }
    }
  } else {
    reg_alloc<160>();
    const int t = threadIdx.x % WG, lane = t & 31;
    const int g = lane >> 2, tq = lane & 3, r_lo = (t >> 5) * 16 + g;
    float acc[96];
    zero_acc(acc);
    for (int it = 0; it < n_it; ++it) {
      const int st = it & 1;
      const bf16* S = sS + st * STAGE;
      mbar_wait(&full[st], (it >> 1) & 1);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t kd = mnmaj(S + 2 * DSTILE, KV_T, 3 * wg, kk);
        wgmma_ss<1, 1>(acc, mnmaj(S, 64, 0, kk), kd);
        wgmma_ss<1, 1>(acc, mnmaj(S + DSTILE, 64, 0, kk), kd);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc);
      mbar_arrive(&empty[st]);
    }
    const int q_rows = min(64, Sq - q0);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r_lo + 8 * i;
      if (r >= q_rows) continue;
      bf16* out = dq + ((size_t)bh * Sq + q0 + r) * hd;
#pragma unroll
      for (int j = 0; j < 24; ++j) {
        const int c = 192 * wg + 8 * j + 2 * tq;
        if (c < hd)
          *reinterpret_cast<__nv_bfloat162*>(out + c) = __floats2bfloat162_rn(
              acc[4 * j + 2 * i] * scale, acc[4 * j + 2 * i + 1] * scale);
      }
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
                      int hd, int hd_v, int ldv, int q_offset, int causal,
                      int window, float scale) {
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
  const float* vp = v + (size_t)bkv * Sk * ldv;
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
    load_rows<float, HDV, BK, HDV, WNT>(sV, vp + (size_t)k0 * ldv, kv_rows,
                                        1.f, hd_v, ldv);
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
                         int hd, int hd_v, int ldv, int q_offset, int causal,
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
  const float* vp = v + (size_t)bkv * Sk * ldv;
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
    load_rows<float, HDV, BK, LDV, WNT>(sV, vp + (size_t)k0 * ldv, kv_rows,
                                        1.f, hd_v, ldv);
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
                          int ldv, int q_offset, int causal, int window,
                          float scale, int splits) {
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
  load_rows<float, HDV, BK, LDV, WNT>(sV, v + ((size_t)bkv * Sk + k0) * ldv,
                                      kv_rows, 1.f, hd_v, ldv);

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


constexpr int HD_W = 576, HDV_W = 512;   // the pair's compiled widths

// K1 bf16 at the pair: v is k's first hd_v columns (sv) or a tensor of its
// own with row stride ldv
template <bool SV>
cudaError_t launch_fwd_tc(const void* q, const void* k, const void* v,
                          void* o, float* lse, int B, int H, int KH, int Sq,
                          int Sk, int hd, int hd_v, int ldv, int q_offset,
                          int causal, int window, float scale,
                          int* occupancy, cudaStream_t st) {
  constexpr int BK = f_bk<SV>();
  CUtensorMap mq{}, mk{}, mv{};
  if (occupancy == nullptr &&
      (!tile_map(&mq, q, hd, Sq, B * H, hd, (long long)Sq * hd, F_BQ) ||
       !tile_map(&mk, k, hd, Sk, B * KH, hd, (long long)Sk * hd, BK) ||
       (!SV && !tile_map(&mv, v, hd_v, Sk, B * KH, ldv, (long long)Sk * ldv,
                         BK))))
    return cudaErrorInvalidValue;
  return run(flash_fwd_wide_tc_kernel<BK, SV>, occupancy,
             dim3(B * H, (Sq + F_BQ - 1) / F_BQ), 3 * WG, k1_bytes<SV>(), st,
             mq, mk, SV ? mk : mv, static_cast<bf16*>(o), lse, H, H / KH, Sq,
             Sk, hd, hd_v, q_offset, causal, window, scale);
}

// K2 dk/dv (ds null) and K3's dk, dv and dq in bf16 at the pair: the dV
// kernel over every q tile, then per pass the dK kernel and (K3) the dq
// kernel over its q rows, then the slices' sum
template <bool SV>
cudaError_t launch_bwd_tc(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, void* dq, void* dk, void* dv,
                          float* ws, int splits, void* ds, const int* passes,
                          int n_pass, int B, int H, int KH, int Sq, int Sk,
                          int hd, int hd_v, int ldv, int q_offset,
                          int causal, int window, float scale,
                          int* occupancy, cudaStream_t st) {
  constexpr int TQ = dk_tq<SV>();
  const int G = H / KH, n_kt = (Sk + KV_T - 1) / KV_T;
  const int rows_all = (Sq + 63) / 64 * 64;
  const dim3 grid(splits, n_kt, B * KH);
  if (occupancy != nullptr)
    return run(tc_bwd_dk_wide_kernel<TQ, SV, true>, occupancy, grid, 3 * WG,
               dk_bytes<SV>(), st, CUtensorMap{}, CUtensorMap{},
               CUtensorMap{}, CUtensorMap{}, lse, delta, ws,
               static_cast<bf16*>(ds), H, G, Sq, Sk, hd, hd_v, q_offset,
               causal, window, scale, splits, 0, 0, 0, 0);
  CUtensorMap mk{}, mv{}, mq{}, mo{}, mqt{}, mot{}, mds{};
  const long long qs = (long long)Sq * hd, os = (long long)Sq * hd_v;
  if (!tile_map(&mk, k, hd, Sk, B * KH, hd, (long long)Sk * hd, KV_T) ||
      (!SV && !tile_map(&mv, v, hd_v, Sk, B * KH, ldv, (long long)Sk * ldv,
                        KV_T)) ||
      !tile_map(&mq, q, hd, Sq, B * H, hd, qs, DV_TQ) ||
      !tile_map(&mo, dout, hd_v, Sq, B * H, hd_v, os, DV_TQ) ||
      !tile_map(&mqt, q, hd, Sq, B * H, hd, qs, TQ) ||
      !tile_map(&mot, dout, hd_v, Sq, B * H, hd_v, os, TQ))
    return cudaErrorInvalidValue;
  cudaError_t err = run(tc_bwd_dv_wide_kernel, nullptr, grid, 3 * WG,
                        dv_bytes(), st, mk, mq, mo, lse, ws, H, G, Sq, Sk,
                        hd, hd_v, q_offset, causal, window, scale, splits);
  if (err != cudaSuccess) return err;
  if (ds == nullptr)
    return run(tc_bwd_dk_wide_kernel<TQ, SV, false>, nullptr, grid, 3 * WG,
               dk_bytes<SV>(), st, mk, SV ? mk : mv, mqt, mot, lse, delta,
               ws, static_cast<bf16*>(nullptr), H, G, Sq, Sk, hd, hd_v,
               q_offset, causal, window, scale, splits, 0, rows_all, 0, 0);
  // the workspace as rows of 64 dS values: the largest pass's pairs
  int most = 0;
  for (int p = 0; p < n_pass; ++p) most = max(most, passes[3 * p + 2]);
  if (most > 0 && !tile_map(&mds, ds, 64, (long long)B * H * most * 2 * 64,
                            1, 64, (long long)B * H * most * 2 * 64 * 64, 64))
    return cudaErrorInvalidValue;
  for (int p = 0; p < n_pass; ++p) {
    const int pa = passes[3 * p], pb = passes[3 * p + 1];
    const int pairs = passes[3 * p + 2];
    err = run(tc_bwd_dk_wide_kernel<TQ, SV, true>, nullptr, grid, 3 * WG,
              dk_bytes<SV>(), st, mk, SV ? mk : mv, mqt, mot, lse, delta, ws,
              static_cast<bf16*>(ds), H, G, Sq, Sk, hd, hd_v, q_offset,
              causal, window, scale, splits, pa, pb, pairs, int(p > 0));
    if (err != cudaSuccess) return err;
    err = run(tc_bwd_dq_ds_wide_kernel, nullptr,
              dim3((pb - pa) / 64, B * H), 4 * WG, dq_bytes(), st, mds, mk,
              static_cast<bf16*>(dq), H, G, Sq, Sk, hd, q_offset, causal,
              window, scale, pa, pairs);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

cudaError_t wide_fwd(const void* q, const void* k, const void* v, void* o,
                     float* lse, int B, int H, int KH, int Sq, int Sk,
                     int hd, int hd_v, int ldv, int q_offset, int causal,
                     int window, float scale, int dtype, int* occupancy,
                     cudaStream_t st) {
  const int G = H / KH;
  if (dtype == 0)
    return run(flash_fwd_wide_kernel<HD_W, HDV_W>, occupancy,
               dim3((Sq + 31) / 32, B * H), WNT,
               f32_fwd_bytes<HD_W, HDV_W>(), st,
               static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<float*>(o), lse, H,
               G, Sq, Sk, hd, hd_v, ldv, q_offset, causal, window, scale);
  if (dtype != 1) return cudaErrorInvalidValue;
  if (v == k && ldv == hd)   // v is k's first hd_v columns: one tile
    return launch_fwd_tc<true>(q, k, v, o, lse, B, H, KH, Sq, Sk, hd, hd_v,
                               ldv, q_offset, causal, window, scale,
                               occupancy, st);
  return launch_fwd_tc<false>(q, k, v, o, lse, B, H, KH, Sq, Sk, hd, hd_v,
                              ldv, q_offset, causal, window, scale, occupancy,
                              st);
}

cudaError_t wide_bwd(int which, const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dq, void* dk, void* dv, float* ws, int splits,
                     void* ds, const int* passes, int n_pass, int B, int H,
                     int KH, int Sq, int Sk, int hd, int hd_v, int ldv,
                     int q_offset, int causal, int window, float scale,
                     int dtype, int* occupancy, cudaStream_t st) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const int G = H / KH;
  if (which == 0) {
    if (dtype == 0)
      return run(flash_bwd_dq_wide_kernel<HD_W, HDV_W>, occupancy,
                 dim3((Sq + 31) / 32, B * H), WNT,
                 f32_dq_bytes<HD_W, HDV_W>(), st,
                 static_cast<const float*>(q), static_cast<const float*>(k),
                 static_cast<const float*>(v),
                 static_cast<const float*>(dout), lse, delta,
                 static_cast<float*>(dq), H, G, Sq, Sk, hd, hd_v, ldv,
                 q_offset, causal, window, scale);
    return run(tc_bwd_dq_wide_kernel<HD_W, HDV_W>, occupancy,
               dim3((Sq + DQ_BQ - 1) / DQ_BQ, B * H), WNT,
               tc_dq_bytes<HD_W, HDV_W>(), st, static_cast<const bf16*>(q),
               static_cast<const bf16*>(k), static_cast<const bf16*>(v),
               static_cast<const bf16*>(dout), lse, delta,
               static_cast<bf16*>(dq), H, G, Sq, Sk, hd, hd_v, ldv, q_offset,
               causal, window, scale);
  }
  const int rows = dtype == 0 ? 16 : KV_T;   // kv rows of a dkv block
  const int n_kt = (Sk + rows - 1) / rows;
  if (occupancy == nullptr &&
      (splits < 1 || splits > 65535 || n_kt > 65535 || B * KH > 65535 ||
       ws == nullptr || (which == 2 && dq == nullptr) ||
       (which == 2 && dtype == 1 && (ds == nullptr || n_pass < 1))))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if (dtype == 0) {
    auto kern = which == 1 ? flash_bwd_dkv_wide_kernel<HD_W, HDV_W, false>
                           : flash_bwd_dkv_wide_kernel<HD_W, HDV_W, true>;
    err = run(kern, occupancy, dim3(splits, n_kt, B * KH), WNT,
              f32_dkv_bytes<HD_W, HDV_W>(), st,
              static_cast<const float*>(q), static_cast<const float*>(k),
              static_cast<const float*>(v), static_cast<const float*>(dout),
              lse, delta, ws, which == 2 ? static_cast<float*>(dq) : nullptr,
              H, G, Sq, Sk, hd, hd_v, ldv, q_offset, causal, window, scale,
              splits);
  } else {
    void* d = which == 2 ? ds : nullptr;
    err = v == k && ldv == hd
              ? launch_bwd_tc<true>(q, k, v, dout, lse, delta, dq, dk, dv, ws,
                                    splits, d, passes, n_pass, B, H, KH, Sq,
                                    Sk, hd, hd_v, ldv, q_offset, causal,
                                    window, scale, occupancy, st)
              : launch_bwd_tc<false>(q, k, v, dout, lse, delta, dq, dk, dv,
                                     ws, splits, d, passes, n_pass, B, H, KH,
                                     Sq, Sk, hd, hd_v, ldv, q_offset, causal,
                                     window, scale, occupancy, st);
  }
  if (err != cudaSuccess || occupancy != nullptr) return err;
  // the slices' sum: the bf16 kernels leave dK unscaled, the fp32 one
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
