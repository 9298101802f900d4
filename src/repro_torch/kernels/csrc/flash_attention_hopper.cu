// K1, K1-lse, K2's dk/dv and K3 in bf16 at the head-width pairs (64, 64)
// and (128, 128), for sm_90a: the attention of the dense main path.
//
// Replaces, at these pairs in bf16, the Pallas TPU kernels of
// repro/kernels/flash_attention.py: _fwd_kernel (:134, pallas_call :437;
// K1 and K1-lse), _bwd_dkv_kernel (:494, :760; K2's dk/dv) and
// _bwd_fused_kernel (:541, :669; K3).  K2's dq pass (_bwd_dq_kernel) keeps
// its mma.sync kernel (flash_attention_bwd.cu), fp32 its CUDA-core ones.
// attn_pair (common.cuh) sends every (hd, hd_v) up to (64, 64) to the HD
// 64 build (hd 32 of the reduced configs, MLA's reduced (48, 32)) and up
// to (128, 128) to HD 128 (hd 120, h2o-danube3-4b's); TMA zero-fills the
// columns past the true widths, the rows past Sq and Sk, and the stores
// write the true columns only.
//
// The numerics are those of the mma.sync kernels these replace: s = (q .
// k) * scale with fp32 sums, masked scores -1e30; K1 takes __expf of s -
// m (the difference first, so that a masked s = m = -1e30 gives 1), the
// rescale __expf(m_old - m_new), the denominator floored at 1e-37, lse =
// m + log(max(l, 1e-37)) written once a row; the backward P^T = expf(s^T
// scale - lse), dS^T = P^T (dP^T - delta) with delta from the caller, dK
// scaled at the end, dq summed in fp32 (K3: reduce-adds into the
// caller's buffer in no fixed order, reproducible only to fp32
// rounding).  P and dS enter their
// products as a bf16 hi + lo pair (ROADMAP's documented divergence), so
// each product that takes them is two wgmma.
//
// What bounds them: at smollm-360m's train step (B 4, H 15, KH 5, S 4096,
// hd 64, causal; kernels/counts.py attention_work, computed) K1-lse does
// 128.9 GFLOP (0.130 ms at 989 TFLOP/s) and K3 322 GFLOP (0.326 ms)
// against ~138 MB of inputs and outputs (0.04 ms at 3.35 TB/s); at
// arctic-480b's (56 heads over 8, hd 128) K1-lse 0.97 ms, K3 2.43: all
// compute-bound.  So the kernels are wgmma (the only route to the card's
// tensor-core rate) on tiles that TMA lays down with the 128-byte swizzle
// (hopper.cuh): FlashAttention-3's shape, kept simple.  The hi + lo pairs
// make the tensor cores do 1.5x K1's counted FLOPs and 1.6x K3's.
//
// K1 (flash_fwd_hopper_kernel): one block per (b*H + h, 128-row q tile),
//   the q tiles heaviest first (the last, with the most kv tiles under the
//   causal mask, launch first).  Three warpgroups: the producer's first
//   thread loads the Q tile once and K, V tiles of HK = 128 rows through a
//   two-stage ring of mbarriers (full: the bytes; empty: the consumers'
//   256 arrivals), then the warpgroup hands its registers back
//   (setmaxnreg); each consumer owns 64 q rows: S = Q K^T is m64 n128 from
//   shared memory (HD/16 k16 steps), the online softmax runs on the
//   accumulators (a row in the 4 lanes of a quad), O += P V takes P as a
//   register A (hi, then lo; m64 n{HD}, 8 k16 steps), V's tile MN-major.
//   Query head h reads the kv matrix b*KH + h/G.  The kv range comes from
//   causal, the window and q_offset (tiles that no real row of the q tile
//   meets are not visited); the masks run only on the tiles an edge cuts;
//   each consumer's rows are its own, so no fp32 crosses between them.
//   Each consumer runs a tile's S, softmax and P V in turn, while the
//   other consumer's work fills the tensor cores.  Issuing the next
//   tile's S beside this tile's P V (FlashAttention-3's overlap inside a
//   warpgroup) was not faster on the H100 (PERF.md).
//   Shared memory: Q 128 x HD + 2 stages x (K + V) 128 x HD, bf16: 164,928
//   B at HD 128 (BK 128 kept: the consumers' O, S and P fit 240 registers
//   without spills, see PERF.md), 83,008 B at HD 64; 1 block an SM.
// K2's dk/dv and K3 (tc_bwd_hopper_kernel<HD, DQ>): one block per (b*KH +
//   kh, 128-row kv tile), heaviest first (the first kv tiles meet the most
//   q tiles under the causal mask).  K and V's 128 rows are loaded once;
//   the block walks the G query heads of kv head kh and, for each, its
//   live 64-row q tiles in order, so the GQA sum stays in the block and dK,
//   dV need no atomics.  The producer warp streams Q and dO by TMA, and
//   lse and delta beside them (its 32 lanes store them and arrive), through
//   a two-stage ring.  Each consumer owns 64 kv rows: S^T = K Q^T and dP^T
//   = V dO^T (m64 n64 from shared memory), P^T and dS^T in registers, dS^T
//   as bf16 hi and lo tiles into shared memory in the 128-byte swizzle
//   (fence.proxy.async, then the warpgroup's own barrier), dV += P^T dO
//   (P^T a register A), dK += dS^T Q (dS^T from shared memory: K-major),
//   and with DQ (K3) dQ += dS K over the block's 128 kv rows, one 64-
//   column box each (at HD 64 the consumers take turns, a q tile each):
//   dS MN-major from both consumers' tiles (two named barriers of the
//   pair guard them), K's box MN-major, the fp32 box staged in shared
//   memory as dq's tensor map lays it out and added to the caller's fp32
//   dq buffer by a TMA reduce-add (cp.reduce.async.bulk.tensor; two
//   staging tiles a consumer, so one drains while the next fills).  One
//   add a dq element per 128 kv rows, half the per-element atomicAdd's
//   adds of a 64-row design, and off the SM's instruction stream: with
//   atomicAdd, K3 at arctic's G 7 took 20.94 ms against dk/dv's 7.26
//   (probe, PERF.md).  K2's dk/dv is the same kernel with the dQ part
//   compiled out: dk, dv are K3's bits.  Shared memory: K, V 128 x HD, 2
//   stages of Q and dO 64 x HD, the four dS^T tiles (32 KB), lse and
//   delta: 165,952 B at HD 128, 100,416 B at HD 64; K3 adds the staging
//   tiles (64 KB): 231,488 and 165,952 B; 1 block an SM.
// Registers: the 384-thread blocks get 168 a thread from ptxas; the
// producer warpgroup hands back 168 - 24 and each consumer takes 240 (the
// wide kernels' split, hopper.cuh).  Descriptors are made from pointers
// the compiler cannot see through (opaque) inside the loops: hoisted, they
// held ~100 registers and the HD 128 backward spilled 104-344 B; now no
// kernel spills.  ptxas's report and the SASS (HGMMA, no HMMA) are
// printed by chip_smoke.py; PERF.md keeps them.

#include "hopper.cuh"

namespace repro {
namespace {

constexpr int HQ = 128;   // q rows of a K1 block: two consumers of 64
constexpr int HK = 128;   // kv rows of a K1 stage and of a dk/dv block
constexpr int TQ = 64;    // q rows of a dk/dv stage

static_assert(WG * (168 - 24) >= 2 * WG * (240 - 168), "K1, dk/dv registers");

// Q, two stages of K and V, the ring's five mbarriers
template <int HD>
constexpr size_t fwd_bytes() {
  return SMEM_ALIGN + (size_t)HQ * HD * 2 + (size_t)2 * 2 * HK * HD * 2 +
         8 * 8;
}
// K, V; two stages of Q and dO; the consumers' dS^T hi and lo tiles;
// K3's fp32 dQ staging, two 64 x 64 tiles a consumer; two stages of lse
// and delta; the ring's five mbarriers
template <int HD, bool DQ>
constexpr size_t bwd_bytes() {
  return SMEM_ALIGN + (size_t)2 * HK * HD * 2 + (size_t)2 * 2 * TQ * HD * 2 +
         (size_t)4 * 64 * 64 * 2 + (DQ ? (size_t)4 * 64 * 64 * 4 : 0) +
         (size_t)2 * 2 * TQ * 4 + 8 * 8;
}
// autotune.hopper_smem_bytes mirrors these sums
static_assert(fwd_bytes<64>() == 83008 && fwd_bytes<128>() == 164928,
              "K1 tiles");
static_assert(bwd_bytes<64, false>() == 100416 &&
                  bwd_bytes<128, false>() == 165952,
              "K2 dk/dv tiles");
static_assert(bwd_bytes<64, true>() == 165952 &&
                  bwd_bytes<128, true>() == 231488,
              "K3 tiles");
static_assert(fwd_bytes<128>() <= 232448 && bwd_bytes<128, true>() <= 232448,
              "one block's shared memory");

// The kernels' tile ranges, also run on the host by
// repro_hopper_ranges, which holds autotune.hopper_kv_tiles,
// hopper_q_tiles and hopper_q_order against them.  A range: its first
// row and its tiles.
struct Range {
  int first, n;
};

// The HK-row kv tiles that some real row of K1's q tile at q0 (q0 up to
// min(q0 + HQ, Sq)) meets under causal, the window and q_offset
__host__ __device__ inline Range fwd_kv_range(int q0, int Sq, int Sk,
                                              int q_offset, int causal,
                                              int window) {
  int kv_begin = 0, kv_end = Sk;
  if (causal) kv_end = min(Sk, q_offset + min(q0 + HQ, Sq));
  if (window > 0) kv_begin = max(0, q_offset + q0 - window + 1);
  const int kt0 = (kv_begin / HK) * HK;
  return {kt0, kv_end > kv_begin ? (kv_end - kt0 + HK - 1) / HK : 0};
}

// K1's q tile of block row y of ny: the last first, the heaviest under
// the causal mask
__host__ __device__ inline int fwd_q_row(int y, int ny) {
  return (ny - 1 - y) * HQ;
}

// The TQ-row q tiles with a row that meets a real kv row of the dk/dv
// block at k0 (k0 up to min(k0 + HK, Sk))
__host__ __device__ inline Range bwd_q_range(int k0, int Sq, int Sk,
                                             int q_offset, int causal,
                                             int window) {
  const int kv_rows = min(HK, Sk - k0);
  int q_lo = 0, q_hi = Sq;
  if (causal) q_lo = max(0, k0 - q_offset);
  if (window > 0) q_hi = min(Sq, k0 + kv_rows - 1 + window - q_offset);
  const int qt0 = (q_lo / TQ) * TQ;
  return {qt0, q_hi > q_lo ? (q_hi - qt0 + TQ - 1) / TQ : 0};
}

// ----------------------------------------------------------------- K1

template <int HD>
__global__ void __launch_bounds__(3 * WG, 1)
flash_fwd_hopper_kernel(const __grid_constant__ CUtensorMap tmq,
                        const __grid_constant__ CUtensorMap tmk,
                        const __grid_constant__ CUtensorMap tmv,
                        bf16* __restrict__ o, float* __restrict__ lse, int H,
                        int G, int Sq, int Sk, int hd_v, int q_offset,
                        int causal, int window, float scale) {
  constexpr int BK = HK;           // kv rows of a stage
  constexpr int NB = HD / BOX;     // 64-column boxes of a row
  constexpr int NS = BK / 2;       // S registers a thread
  constexpr int NO = HD / 2;       // O registers a thread
  constexpr int STAGE = BK * HD;   // elements of a K (or V) stage
  bf16* sQ = smem_tiles();         // NB boxes of HQ rows
  bf16* sK = sQ + HQ * HD;         // 2 stages, NB boxes of BK rows
  bf16* sV = sK + 2 * STAGE;       // 2 stages
  uint64_t* bars = reinterpret_cast<uint64_t*>(sV + 2 * STAGE);
  uint64_t *qbar = bars, *full = bars + 1, *empty = bars + 3;

  const int bh = blockIdx.x;                          // b * H + h
  const int q0 = fwd_q_row(blockIdx.y, gridDim.y);   // heaviest first
  const int bkv = (bh / H) * (H / G) + (bh % H) / G;  // b * KH + h / G
  const int row0 = q_offset + q0;
  const Range kv = fwd_kv_range(q0, Sq, Sk, q_offset, causal, window);
  const int kt0 = kv.first, n_it = kv.n;

  init_ring(bars, 1, 2 * WG);
  const int wg = warpgroup();

  if (wg == 2) {   // the producer
    reg_dealloc<24>();
    if (threadIdx.x == 2 * WG) {
      mbar_expect(qbar, HQ * HD * 2);
      for (int b = 0; b < NB; ++b)
        tma_load(sQ + b * HQ * BOX, tmq, qbar, b * BOX, q0, bh);
      for (int it = 0; it < n_it; ++it) {
        const int st = it & 1, k0 = kt0 + it * BK;
        mbar_wait(&empty[st], ((it >> 1) & 1) ^ 1);
        mbar_expect(&full[st], 2 * STAGE * 2);
        for (int b = 0; b < NB; ++b) {
          tma_load(sK + st * STAGE + b * BK * BOX, tmk, &full[st], b * BOX,
                   k0, bkv);
          tma_load(sV + st * STAGE + b * BK * BOX, tmv, &full[st], b * BOX,
                   k0, bkv);
        }
      }
    }
    return;
  }
  reg_alloc<240>();   // a consumer: 64 q rows
  const int t = threadIdx.x % WG, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3, r_lo = (t >> 5) * 16 + g;
  const int rowc = row0 + 64 * wg;   // global position of its row 0
  float acc[NO];
  zero_acc(acc);
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];

  // S = Q K^T of the tile in stage st over HD columns, issued and committed
  auto issue_qk = [&](float (&s)[NS], int st) {
    const bf16* Qc = opaque(sQ + wg * 64 * BOX);   // its rows of each box
    const bf16* Ks = opaque(sK + st * STAGE);
    zero_acc(s);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      wgmma_ss<0, 0>(s, kmaj(Qc, HQ, ks), kmaj(Ks, BK, ks));
    wgmma_commit();
  };
  // scale and mask S of the tile at k0 (masks only where the causal edge,
  // the window edge or Sk cuts this consumer's part of it), then the
  // online softmax: a row lives in the 4 lanes of a quad; s becomes P, m
  // and l move on, alpha is O's rescale
  auto softmax = [&](float (&s)[NS], int k0) {
    const bool full_tile = k0 + BK <= Sk &&
                           (!causal || k0 + BK - 1 <= rowc) &&
                           (window <= 0 || rowc + 63 - k0 < window);
    if (full_tile) {
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] *= scale;
    } else {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int row = rowc + r_lo + 8 * ((i >> 1) & 1);
        const int col = k0 + 8 * (i >> 2) + 2 * tq + (i & 1);
        s[i] = is_live(row, col, Sk, causal, window) ? s[i] * scale : NEG_INF;
      }
    }
    float mx[2] = {m[0], m[1]}, rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NS; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
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
  };

  float s[NS];
  uint32_t hi[BK / 16][4], lo[BK / 16][4];   // P of the tile at P V next
  // O += P V of the tile in stage st: P as a bf16 hi + lo pair from
  // registers, V MN-major; issued and committed
  auto issue_pv = [&](int st) {
    const bf16* Vs = opaque(sV + st * STAGE);
    fence_regs(hi);
    fence_regs(lo);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t vd = mnmaj(Vs, BK, 0, kk);
      wgmma_rs<1>(acc, hi[kk], vd);
      wgmma_rs<1>(acc, lo[kk], vd);
    }
    wgmma_commit();
  };
  // O's rescale, skipped by a warp whose rows kept their maxima (x 1 is
  // exact), and P's split into the A operand of the next P V
  auto rescale_split = [&]() {
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f))
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) frag_pair(s, kk, hi[kk], lo[kk]);
  };
  mbar_wait(qbar, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    mbar_wait(&full[st], (it >> 1) & 1);
    issue_qk(s, st);
    wgmma_wait();
    fence_regs(s);
    softmax(s, kt0 + it * BK);
    rescale_split();
    issue_pv(st);
    wgmma_wait();
    fence_regs(acc);
    mbar_arrive(&empty[st]);
  }

  // each lane holds a quarter of its rows' sums
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const int qc = q0 + 64 * wg;   // this consumer's first q row
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = qc + r_lo + 8 * i;
    if (r >= Sq) continue;
    const float den = fmaxf(l[i], 1e-37f);
    if (lse != nullptr && tq == 0) lse[(size_t)bh * Sq + r] = m[i] + logf(den);
    bf16* out = o + ((size_t)bh * Sq + r) * hd_v;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      const int c = 8 * j + 2 * tq;
      if (c < hd_v)
        *reinterpret_cast<__nv_bfloat162*>(out + c) = __floats2bfloat162_rn(
            acc[4 * j + 2 * i] / den, acc[4 * j + 2 * i + 1] / den);
    }
  }
}

// ------------------------------------------------- K2 dk/dv and K3

// Byte offset of (row r, bf16 column c) in a 64 x 64 bf16 tile held in the
// 128-byte swizzle that TMA writes and wgmma's descriptors read: 16-byte
// chunk c / 8 of row r sits at chunk (c / 8) ^ (r % 8).
__device__ __forceinline__ uint32_t sw_off(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

template <int HD, bool DQ>
__global__ void __launch_bounds__(3 * WG, 1)
tc_bwd_hopper_kernel(const __grid_constant__ CUtensorMap tmk,
                     const __grid_constant__ CUtensorMap tmv,
                     const __grid_constant__ CUtensorMap tmq,
                     const __grid_constant__ CUtensorMap tmo,
                     const __grid_constant__ CUtensorMap tmdq,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int H, int G, int Sq, int Sk,
                     int hd, int hd_v, int q_offset, int causal, int window,
                     float scale) {
  constexpr int NB = HD / BOX;    // 64-column boxes of a row
  constexpr int NS = TQ / 2;      // S^T (and dP^T) registers a thread
  constexpr int NA = HD / 2;      // dK (and dV) registers a thread
  constexpr int QSTAGE = TQ * HD;
  constexpr int DS = 64 * 64;     // a dS^T tile: 64 kv rows by 64 q
  bf16* sK = smem_tiles();        // NB boxes of HK rows
  bf16* sV = sK + HK * HD;
  bf16* sQ = sV + HK * HD;        // 2 stages, NB boxes of TQ rows
  bf16* sO = sQ + 2 * QSTAGE;     // 2 stages of dO
  bf16* sS = sO + 2 * QSTAGE;     // dS^T hi, lo of consumer 0, then 1
  // K3: each consumer's two fp32 staging tiles of a 64 x 64 dQ box, as
  // two 32-column boxes of dq's fp32 tensor map
  float* sR = reinterpret_cast<float*>(sS + 4 * DS);
  float* sL = sR + (DQ ? 4 * 64 * 64 : 0);   // 2 x TQ lse
  float* sD = sL + 2 * TQ;                   // 2 x TQ delta
  uint64_t* bars = reinterpret_cast<uint64_t*>(sD + 2 * TQ);
  uint64_t *kbar = bars, *full = bars + 1, *empty = bars + 3;

  const int bkv = blockIdx.x, k0 = blockIdx.y * HK;   // b * KH + kh
  const int KH = H / G;
  const int bh0 = (bkv / KH) * H + (bkv % KH) * G;    // b * H + kh * G
  const Range qr = bwd_q_range(k0, Sq, Sk, q_offset, causal, window);
  const int qt0 = qr.first, n_qt = qr.n, n_it = G * n_qt;
  // iteration it: head bh0 + it / n_qt, q tile qt0 + (it % n_qt) * TQ

  init_ring(bars, 1, 2 * WG, 32);
  const int wg = warpgroup();

  if (wg == 2) {   // the producer: its first warp
    reg_dealloc<24>();
    if (threadIdx.x >= 2 * WG + 32) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_expect(kbar, 2 * HK * HD * 2);
      for (int b = 0; b < NB; ++b) {
        tma_load(sK + b * HK * BOX, tmk, kbar, b * BOX, k0, bkv);
        tma_load(sV + b * HK * BOX, tmv, kbar, b * BOX, k0, bkv);
      }
    }
    for (int it = 0; it < n_it; ++it) {
      const int st = it & 1, bh = bh0 + it / n_qt;
      const int q0 = qt0 + (it % n_qt) * TQ;
      mbar_wait(&empty[st], ((it >> 1) & 1) ^ 1);
      for (int i = lane; i < TQ; i += 32) {   // zeros past Sq
        const int q = q0 + i;
        sL[st * TQ + i] = q < Sq ? lse[(size_t)bh * Sq + q] : 0.f;
        sD[st * TQ + i] = q < Sq ? delta[(size_t)bh * Sq + q] : 0.f;
      }
      if (lane == 0) {
        mbar_expect(&full[st], 2 * QSTAGE * 2);
        for (int b = 0; b < NB; ++b) {
          tma_load(sQ + st * QSTAGE + b * TQ * BOX, tmq, &full[st], b * BOX,
                   q0, bh);
          tma_load(sO + st * QSTAGE + b * TQ * BOX, tmo, &full[st], b * BOX,
                   q0, bh);
        }
      } else {
        mbar_arrive(&full[st]);   // this lane's lse and delta are stored
      }
    }
    return;
  }
  reg_alloc<240>();   // a consumer: 64 kv rows
  const int t = threadIdx.x % WG, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3, r_lo = (t >> 5) * 16 + g;
  const int kc = k0 + 64 * wg;   // its first kv row
  float adk[NA], adv[NA];
  zero_acc(adk);
  zero_acc(adv);
  int staged = 0;   // K3: dQ boxes this consumer has handed to TMA
  // S^T = K Q^T over HD and dP^T = V dO^T over HD (v zero-filled past
  // hd_v) of the tile in stage st, kv rows by q columns: issued and
  // committed
  auto issue_sdp = [&](float (&s)[NS], float (&dp)[NS], int st) {
    const bf16* Qs = opaque(sQ + st * QSTAGE);
    const bf16* Os = opaque(sO + st * QSTAGE);
    const bf16* Kc = opaque(sK + wg * 64 * BOX);   // its rows of K's boxes
    const bf16* Vc = opaque(sV + wg * 64 * BOX);
    zero_acc(s);
    zero_acc(dp);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      wgmma_ss<0, 0>(s, kmaj(Kc, HK, ks), kmaj(Qs, TQ, ks));
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      wgmma_ss<0, 0>(dp, kmaj(Vc, HK, ks), kmaj(Os, TQ, ks));
    wgmma_commit();
  };
  float s[NS], dp[NS];
  mbar_wait(kbar, 0);

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1, bh = bh0 + it / n_qt;
    const int q0 = qt0 + (it % n_qt) * TQ;
    const bf16* Qs = opaque(sQ + st * QSTAGE);
    const bf16* Os = opaque(sO + st * QSTAGE);
    bf16* Sh = opaque(sS + 2 * wg * DS);           // its dS^T, hi
    bf16* Sl = Sh + DS;                            // and lo
    const float* Ls = sL + st * TQ;
    const float* Ds = sD + st * TQ;
    mbar_wait(&full[st], (it >> 1) & 1);
    issue_sdp(s, dp, st);
    wgmma_wait();
    fence_regs(s);
    fence_regs(dp);

    // P^T and dS^T = P^T (dP^T - delta), unscaled; masks only where an
    // edge cuts this consumer's part of the tile
    const bool full_tile = q0 + TQ <= Sq && kc + 64 <= Sk &&
                           (!causal || kc + 63 <= q_offset + q0) &&
                           (window <= 0 || q_offset + q0 + TQ - 1 - kc < window);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int qr = 8 * (i >> 2) + 2 * tq + (i & 1);   // q column
      const int col = kc + r_lo + 8 * ((i >> 1) & 1);    // kv row
      const bool live = full_tile ||
                        (q0 + qr < Sq &&
                         is_live(q_offset + q0 + qr, col, Sk, causal, window));
      const float p = expf((live ? s[i] * scale : NEG_INF) - Ls[qr]);
      s[i] = p;
      dp[i] = p * (dp[i] - Ds[qr]);
    }
    // K3: the other consumer's dQ of the last tile has read this one's
    // dS^T tiles
    if (DQ && it > 0) wg_pair_sync(1);
    // dS^T into its two swizzled tiles, hi and lo, for dK and dQ
#pragma unroll
    for (int j = 0; j < NS / 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t hi, lo;
        split_bf16(dp[4 * j + 2 * h], dp[4 * j + 2 * h + 1], hi, lo);
        const uint32_t off = sw_off(r_lo + 8 * h, 8 * j + 2 * tq);
        *reinterpret_cast<uint32_t*>(reinterpret_cast<char*>(Sh) + off) = hi;
        *reinterpret_cast<uint32_t*>(reinterpret_cast<char*>(Sl) + off) = lo;
      }
    fence_async_smem();
    // both consumers' dS^T (K3's dQ reads both) or this one's are stored
    if (DQ)
      wg_pair_sync(2);
    else
      wg_sync(1 + wg);

    // dV += P^T dO (P^T a register A, hi + lo), dK += dS^T Q (dS^T from
    // shared memory, hi + lo); dO and Q MN-major
    uint32_t phi[TQ / 16][4], plo[TQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < TQ / 16; ++kk) frag_pair(s, kk, phi[kk], plo[kk]);
    fence_regs(phi);
    fence_regs(plo);
    fence_regs(adv);
    fence_regs(adk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TQ / 16; ++kk) {
      const uint64_t od = mnmaj(Os, TQ, 0, kk);
      wgmma_rs<1>(adv, phi[kk], od);
      wgmma_rs<1>(adv, plo[kk], od);
    }
#pragma unroll
    for (int kk = 0; kk < TQ / 16; ++kk) {
      const uint64_t qd = mnmaj(Qs, TQ, 0, kk);
      wgmma_ss<0, 1>(adk, kmaj(Sh, 64, kk), qd);
      wgmma_ss<0, 1>(adk, kmaj(Sl, 64, kk), qd);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(adv);
    fence_regs(adk);
    mbar_arrive(&empty[st]);   // Q, dO, lse and delta are read

    if (DQ) {
      // dQ[:, 64 b ..] += dS K over the block's 128 kv rows, box b by
      // consumer (b + it) % 2: A = dS (q rows by kv rows) from both
      // consumers' dS^T tiles, MN-major; B = K's box b, MN-major.  The
      // fp32 box goes through a staging tile to a TMA reduce-add into
      // dq's fp32 buffer.
      const bf16* S0 = opaque(sS);
      const bf16* Kb = opaque(sK);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if (((b + it) & 1) != wg) continue;
        float aq[32];
        zero_acc(aq);
        fence_regs(aq);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HK / 16; ++kk) {
          const bf16* St = S0 + (kk >> 2) * 2 * DS;   // consumer kk / 4's
          const uint64_t kd = mnmaj(Kb, HK, b, kk);
          wgmma_ss<1, 1>(aq, mnmaj(St, 64, 0, kk & 3), kd);
          wgmma_ss<1, 1>(aq, mnmaj(St + DS, 64, 0, kk & 3), kd);
        }
        wgmma_commit();
        wgmma_wait();
        fence_regs(aq);
        float* R = sR + (2 * wg + (staged & 1)) * 64 * 64;
        if (t == 0) bulk_wait_read<1>();   // this buffer's last reduce read it
        wg_sync(3 + wg);
        // (q row r, column c) of the box at half c / 32, swizzled
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r_lo + 8 * h, c = 8 * j + 2 * tq;
            float* half = R + (c >> 5) * 64 * 32;
            const uint32_t off = r * 128 + ((((c & 31) >> 2) ^ r) & 7) * 16 +
                                 (c & 3) * 4;
            *reinterpret_cast<float2*>(reinterpret_cast<char*>(half) + off) =
                make_float2(aq[4 * j + 2 * h] * scale,
                            aq[4 * j + 2 * h + 1] * scale);
          }
        fence_async_smem();
        wg_sync(3 + wg);
        if (t == 0) {
          tma_reduce_add(tmdq, R, 64 * b, q0, bh);
          tma_reduce_add(tmdq, R + 64 * 32, 64 * b + 32, q0, bh);
          bulk_commit();
        }
        ++staged;
      }
    }
  }
  if (DQ && t == 0) bulk_wait_all();   // the reduces are done with sR

  // dK (scaled) and dV of this consumer's kv rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = kc + r_lo + 8 * i;
    if (r >= Sk) continue;
    const size_t row = (size_t)bkv * Sk + r;
#pragma unroll
    for (int j = 0; j < NA / 4; ++j) {
      const int c = 8 * j + 2 * tq;
      if (c < hd)
        *reinterpret_cast<__nv_bfloat162*>(dk + row * hd + c) =
            __floats2bfloat162_rn(adk[4 * j + 2 * i] * scale,
                                  adk[4 * j + 2 * i + 1] * scale);
      if (c < hd_v)
        *reinterpret_cast<__nv_bfloat162*>(dv + row * hd_v + c) =
            __floats2bfloat162_rn(adv[4 * j + 2 * i], adv[4 * j + 2 * i + 1]);
    }
  }
}

// ------------------------------------------------------------------ host

// The tensor maps of n bf16 matrices of rows x cols (row stride cols),
// boxes of box_rows rows; an empty kv length maps one row, which no block
// loads.
bool map_of(CUtensorMap* m, const void* p, int cols, int rows, int n,
            int box_rows) {
  const int r = max(rows, 1);
  return tile_map(m, p, cols, r, n, cols, (long long)r * cols, box_rows);
}

template <int HD>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int H, int KH, int Sq, int Sk,
                       int hd, int hd_v, int q_offset, int causal, int window,
                       float scale, int* occupancy, cudaStream_t st) {
  CUtensorMap mq{}, mk{}, mv{};
  if (occupancy == nullptr &&
      (!map_of(&mq, q, hd, Sq, B * H, HQ) ||
       !map_of(&mk, k, hd, Sk, B * KH, HK) ||
       !map_of(&mv, v, hd_v, Sk, B * KH, HK)))
    return cudaErrorInvalidValue;
  return run(flash_fwd_hopper_kernel<HD>, occupancy,
             dim3(B * H, (Sq + HQ - 1) / HQ), 3 * WG, fwd_bytes<HD>(), st, mq,
             mk, mv, static_cast<bf16*>(o), lse, H, H / KH, Sq, Sk, hd_v,
             q_offset, causal, window, scale);
}

template <int HD, bool DQ>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, float* dq_acc,
                       int B, int H, int KH, int Sq, int Sk, int hd, int hd_v,
                       int q_offset, int causal, int window, float scale,
                       int* occupancy, cudaStream_t st) {
  CUtensorMap mk{}, mv{}, mq{}, mo{}, mdq{};
  if (occupancy == nullptr &&
      (!map_of(&mk, k, hd, Sk, B * KH, HK) ||
       !map_of(&mv, v, hd_v, Sk, B * KH, HK) ||
       !map_of(&mq, q, hd, Sq, B * H, TQ) ||
       !map_of(&mo, dout, hd_v, Sq, B * H, TQ) ||
       (DQ && !tile_map(&mdq, dq_acc, hd, Sq, B * H, hd, (long long)Sq * hd,
                        64, true))))
    return cudaErrorInvalidValue;
  return run(tc_bwd_hopper_kernel<HD, DQ>, occupancy,
             dim3(B * KH, (Sk + HK - 1) / HK), 3 * WG, bwd_bytes<HD, DQ>(),
             st, mk, mv, mq, mo, mdq, lse, delta, static_cast<bf16*>(dk),
             static_cast<bf16*>(dv), H, H / KH, Sq, Sk, hd, hd_v, q_offset,
             causal, window, scale);
}

}  // namespace

cudaError_t hopper_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int H, int KH, int Sq, int Sk,
                       int hd, int hd_v, int q_offset, int causal, int window,
                       float scale, int* occupancy, cudaStream_t st) {
  const int pair = attn_pair(hd, hd_v);
  if (occupancy == nullptr && (Sq + HQ - 1) / HQ > 65535)
    return cudaErrorInvalidValue;
  if (pair == 0)
    return launch_fwd<64>(q, k, v, o, lse, B, H, KH, Sq, Sk, hd, hd_v,
                          q_offset, causal, window, scale, occupancy, st);
  if (pair == 1)
    return launch_fwd<128>(q, k, v, o, lse, B, H, KH, Sq, Sk, hd, hd_v,
                           q_offset, causal, window, scale, occupancy, st);
  return cudaErrorInvalidValue;
}

cudaError_t hopper_bwd(int fused, const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, float* dq_acc,
                       int B, int H, int KH, int Sq, int Sk, int hd, int hd_v,
                       int q_offset, int causal, int window, float scale,
                       int* occupancy, cudaStream_t st) {
  const int pair = attn_pair(hd, hd_v);
  if (occupancy == nullptr &&
      ((Sk + HK - 1) / HK > 65535 || (fused && dq_acc == nullptr)))
    return cudaErrorInvalidValue;
  if (pair == 0)
    return fused ? launch_bwd<64, true>(q, k, v, dout, lse, delta, dk, dv,
                                        dq_acc, B, H, KH, Sq, Sk, hd, hd_v,
                                        q_offset, causal, window, scale,
                                        occupancy, st)
                 : launch_bwd<64, false>(q, k, v, dout, lse, delta, dk, dv,
                                         dq_acc, B, H, KH, Sq, Sk, hd, hd_v,
                                         q_offset, causal, window, scale,
                                         occupancy, st);
  if (pair == 1)
    return fused ? launch_bwd<128, true>(q, k, v, dout, lse, delta, dk, dv,
                                         dq_acc, B, H, KH, Sq, Sk, hd, hd_v,
                                         q_offset, causal, window, scale,
                                         occupancy, st)
                 : launch_bwd<128, false>(q, k, v, dout, lse, delta, dk, dv,
                                          dq_acc, B, H, KH, Sq, Sk, hd, hd_v,
                                          q_offset, causal, window, scale,
                                          occupancy, st);
  return cudaErrorInvalidValue;
}

}  // namespace repro

// The kernels' tile ranges run on the host for n cases of six ints each,
// two ints out a case: which 0, K1's kv tiles of (q0, Sq, Sk, q_offset,
// causal, window) as (first kv row, tiles); 1, the dk/dv block's q tiles
// of (k0, Sq, Sk, q_offset, causal, window) as (first q row, tiles); 2,
// K1's q row of block row y of ny, (y, ny, ...) as (q0, 0).  The card
// tests hold autotune's mirror of them against these.
extern "C" int repro_hopper_ranges(int which, int n, const int* args,
                                   int* out) {
  for (int i = 0; i < n; ++i) {
    const int* a = args + 6 * i;
    repro::Range r{0, 0};
    if (which == 0)
      r = repro::fwd_kv_range(a[0], a[1], a[2], a[3], a[4], a[5]);
    else if (which == 1)
      r = repro::bwd_q_range(a[0], a[1], a[2], a[3], a[4], a[5]);
    else if (which == 2)
      r.first = repro::fwd_q_row(a[0], a[1]);
    else
      return cudaErrorInvalidValue;
    out[2 * i] = r.first;
    out[2 * i + 1] = r.n;
  }
  return cudaSuccess;
}
