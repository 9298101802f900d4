// K4f and K4b: whole-sequence ("mega") causal / sliding-window GQA
// attention, forward and backward, for sm_90a.
//
// Replace the Pallas TPU kernels of repro/kernels/flash_attention.py:
//   K4f  _fwd_mega_kernel (:243, pallas_call :295 in _fwd_mega_call),
//   K4b  _bwd_mega_kernel (:312, pallas_call :350 in _bwd_mega_call),
// and their batch-tiled variants (_bt, :272).  The TPU kernels take the
// whole (B, KH) problem in one grid step: one batched product per
// matmul, a softmax over whole score rows under the additive -1e30 mask
// of _mega_amask, and a backward whose contraction over the g*sq rows is
// the GQA group sum.  On Hopper the same function becomes one thread
// block per (batch, kv head) that holds the kv head's whole K and V in
// shared memory, read from device memory once for all G*Sq query rows
// of its G query heads (the tiled K1-K3 reload them for every q tile of
// every head).  The block's shared memory is the caller's sum,
// repro_torch/kernels/autotune.py mega_smem_bytes; each block traps if
// that is less than its layout below needs.  Numerics are K1's and
// K2's: s = (q . k) * scale with fp32 sums, masked scores -1e30, the
// denominator floored at 1e-37, lse = m + log(max(l, 1e-37)) (the
// convention K1 and K2/K3 read), P = exp(s - lse), dS = P (dP - delta).
// Ragged Sq and Sk need no padding; rows are global positions q_offset +
// i for the causal mask and the window.
//
// bf16 inputs: tensor cores (mega_fwd_tc_kernel, mega_bwd_tc_kernel),
// mma.sync.m16n8k16 with fp32 sums and operands from ldmatrix.  K and V
// sit in shared memory for the whole Sk, rounded up to 64 rows
// (zero-filled past Sk; columns hd..HD zero-filled for a head narrower
// than its compiled width 64 or 128), loaded once by 16-byte cp.async.
// Their rows are unpadded: each 16-byte chunk of a row is XORed with the
// row's index mod 8 (swz below), so the eight rows an ldmatrix phase
// reads fall in eight bank groups without the 16 B a row that padding
// costs.  At hd 64 and Sk 256 K and V take 65,536 B.
//   K4f  128 threads.  Each warp walks the G*Sq query rows on its own, 16
//        rows (a "slice") at a time, in snake order (snake_at: over two
//        steps each warp meets one slice from each end of a run of
//        eight, so the causal work of the warps evens out).  It copies a
//        slice's q into its own 16-row buffer, takes the A fragments into
//        registers with ldmatrix, and starts the next slice's copy into
//        the same buffer while it computes, so q streams with no block
//        barrier.  Per 64-column kv tile up to the slice's diagonal and
//        from its window's start it runs K1's tile (flash_fwd_tc_kernel):
//        S = Q K^T, the online softmax on the accumulator fragments, P V
//        with P as a bf16 hi + lo pair (P rounded once put K1's output a
//        bf16 ulp off at every large |o|).  16-column chunks that the
//        causal edge, the window's start or Sk leave wholly dead are
//        skipped in both products.  Shared memory at hd 64: 65,536 + 4
//        warps x 2,048 B of q = 73,728 B, three blocks an SM, so B*KH =
//        320 blocks run in one wave of 396 slots on 132 SMs.
//   K4b  K2's two tensor-core kernels (flash_attention_bwd.cu
//        tc_bwd_dkv_kernel and tc_bwd_dq_kernel) fused into one launch
//        over the resident K and V, their tiles and summation order
//        kept.  Phase 1, kv tiles outer: each warp owns 16 rows of a
//        64-row kv tile, with dK and dV in fp32 registers; its four-warp
//        group streams the live q tiles (64 rows at hd 64, 32 at hd 128)
//        of all G heads, with their dO, lse and delta, through a cp.async
//        double buffer that runs on across the group's kv tiles, and
//        recomputes P^T and dS^T = P^T (dP^T - delta) to add dV += P^T
//        dO, dK += dS^T q; the tile's dk and dv are written once.  Phase
//        2, query slices outer: each warp walks 16-row q slices in snake
//        order on its own (q, dO, lse and delta double-buffered per
//        warp), keeps dq in registers and adds dq += dS K over the live
//        kv tiles (64 rows at hd 64, 32 at hd 128), recomputing S and dP,
//        then writes the slice's dq once.  P and dS enter their products
//        as bf16 hi + lo pairs, as in K2/K3 (scripts/torch_bwd_rounding.py).
//        No atomics and no global scratch: each output element is summed
//        by one thread in K2's order, so K4b gives the same bits on every
//        run, and the same bits as K2 (dead 16-row chunks that it skips
//        add exact zeros in K2).  At hd 64 a block is two four-warp
//        groups (256 threads), which take the kv tiles in snake order in
//        phase 1: at 225 registers a thread the SM holds eight warps, and
//        320 four-warp blocks at two an SM took 1.21 waves (the last 56
//        blocks ran alone), where 320 eight-warp blocks keep every SM's
//        warps busy to the end.  At hd 128 a block is one group.  Shared
//        memory: K and V plus the larger phase's stream, which the two
//        phases share: 65,536 + 67,584 = 133,120 B at hd 64 and Sk 256.
//   Both kernels issue a k16 step's ldmatrix loads before its mma (the
//   compiler keeps the inline asm's order, so an mma right after its load
//   waits for it), mask by each row's live column range (row_span: two
//   compares an entry, where is_live's runtime flags cost several) and,
//   in K4f, scale the output by one reciprocal a row.  Each accumulator
//   takes its products in K2's order.
// Bound on the H100 at the short-sequence training shape (B=64, H=15,
// KH=5, S=256, hd=64, bf16, causal; 32,896 live pairs per head): K4f's
// 4*hd FLOP per live pair and head are 8.08 GFLOP (8 us of bf16 tensor
// cores) against 83.9 MB of q, k, v and o (25 us at 3.35 TB/s), so the
// function is bound by bytes; K4b's 10*hd are 20.2 GFLOP (20 us) against
// ~138 MB (41 us), bytes again.  With the hi + lo pairs the tensor cores
// do 1.5x (K4f) and 2x (K4b, which also recomputes S and dP for dq) the
// reference count; mma.sync with the softmax issued beside it is bound
// by each warp's latency here (12 warps an SM for K4f, 8 for K4b), far
// above either bound.

// fp32 inputs keep the CUDA-core kernels (mega_fwd_kernel,
// mega_bwd_kernel): the card's fp32 comparisons hold K4 to 1e-4 of the
// plain version, which TF32 tensor cores would not meet.  They walk the
// G*Sq rows in strips of R rows (R = 8 * RPT, autotune.mega_rows):
//   K4f  per strip: q (scale folded in) into shared memory, the whole
//        live score row s = q.k, row max m, p = exp(s - m),
//        l = max(sum p, 1e-37), o = p.V / l and, with an lse pointer,
//        lse = m + log l.
//   K4b  per strip: P = exp(s - lse), dP = dO.V^T,
//        dS = P * (dP - delta); the strip's whole dq rows
//        dq = scale * dS.K are written once; then dV += P^T.dO and
//        dK += dS^T.(q*scale) into fp32 dK/dV held in shared memory for
//        the whole kv head, written once at the end.  Every element of
//        dK/dV is summed over the strips in strip order and over a
//        strip's rows in row order by one thread at a time.
// The causal mask and the window become the strip's live column range
// [c_lo, c_hi); inside it each entry is masked by index and a masked
// entry's probability is selected to zero.  All arithmetic is fp32 FMAs
// from shared memory, bound by their issue rate.  Threads: 256 a block,
// 8 warps.  In the row phases warp w owns strip rows w*RPT .. w*RPT +
// RPT - 1 and lane l the score columns c_lo + l + 32j of a 128-column
// pass (4 columns a lane), or the head columns l + 32j; a warp reads and
// writes only its own rows of the score strip, so those phases meet at
// __syncwarp.  In K4b's dK/dV phase warp w owns 4 kv columns per pass
// and lane l the head columns l + 32j.  K and V rows are padded by one
// 32-bit word (hd+1 fp32 values) so the 32 lanes reading one column each
// hit 32 banks.

#include "common.cuh"

namespace repro {
namespace {

constexpr int NT = 256, NW = NT / 32;
constexpr int JN = 4;    // score columns a lane takes in one pass
constexpr int CPT = 4;   // kv columns a warp takes in one dK/dV pass

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

constexpr size_t SMEM_OPTIN = 232448;   // H100 per-block opt-in maximum

// Trap unless the launch gave the block `need` bytes of dynamic shared
// memory: the size is the caller's sum, the layout is the kernel's.
__device__ __forceinline__ void require_smem(size_t need) {
  unsigned have;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(have));
  if (need > have) __trap();
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return make_float2(p[0], p[1]);
}

// Copy `rows` rows of HD elements into shared memory unconverted, with
// row stride LDK.
template <int HD, int LDK>
__device__ __forceinline__ void load_kv(float* dst, const float* src,
                                        int rows) {
  constexpr int V = 16 / sizeof(float);
  constexpr int PER_ROW = HD / V;
  for (int idx = threadIdx.x; idx < rows * PER_ROW; idx += NT) {
    const int r = idx / PER_ROW;
    const int c = (idx % PER_ROW) * V;
    const uint4 raw =
        *reinterpret_cast<const uint4*>(src + (size_t)r * HD + c);
    const float* e = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) dst[r * LDK + c + i] = e[i];
  }
}

struct Strip {
  int rows;    // valid rows of the strip (the last one may be ragged)
  int p_lo;    // global position of strip row 0
  int c_lo;    // live columns [c_lo, c_hi)
  int c_hi;
};

__device__ __forceinline__ Strip make_strip(int i0, int R, int Sq, int Sk,
                                            int q_offset, int causal,
                                            int window) {
  Strip st;
  st.rows = min(R, Sq - i0);
  st.p_lo = q_offset + i0;
  const int p_hi = st.p_lo + st.rows - 1;
  st.c_lo = window > 0 ? max(0, st.p_lo - window + 1) : 0;
  st.c_hi = causal ? min(Sk, p_hi + 1) : Sk;
  return st;
}

// Two score-like products of the warp's RPT rows against one 128-column
// pass starting at cb: s[i][j] = A[row i] . X[col], and with TWO also
// t[i][j] = B[row i] . Y[col].  A, B: rows of HD; X, Y: rows of LDK.
// Columns past Sk read row Sk - 1 (their results are not used).
template <int HD, int LDK, int RPT, bool TWO>
__device__ __forceinline__ void strip_products(
    const float* A, const float* Bm, const float* X, const float* Y, int row0,
    int cb, int Sk, float (&s)[RPT][JN], float (&t)[RPT][JN]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < JN; ++j) s[i][j] = t[i][j] = 0.f;
  int col[JN];
#pragma unroll
  for (int j = 0; j < JN; ++j) col[j] = min(cb + lane + 32 * j, Sk - 1);
#pragma unroll 4
  for (int d = 0; d < HD; d += 2) {
    float2 a[RPT], b[RPT], x[JN], y[JN];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      a[i] = *reinterpret_cast<const float2*>(A + (row0 + i) * HD + d);
      if constexpr (TWO)
        b[i] = *reinterpret_cast<const float2*>(Bm + (row0 + i) * HD + d);
    }
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      x[j] = ld2(X + col[j] * LDK + d);
      if constexpr (TWO) y[j] = ld2(Y + col[j] * LDK + d);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        s[i][j] = fmaf(a[i].x, x[j].x, fmaf(a[i].y, x[j].y, s[i][j]));
        if constexpr (TWO)
          t[i][j] = fmaf(b[i].x, y[j].x, fmaf(b[i].y, y[j].y, t[i][j]));
      }
  }
}

// ------------------------------------------------------------------ K4f

template <int HD, int RPT>
__global__ void __launch_bounds__(NT)
mega_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o,
                float* __restrict__ lse, int G, int Sq, int Sk,
                int q_offset, int causal, int window, float scale) {
  constexpr int R = RPT * NW, LDK = HD + 1, ND = HD / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t kv_bytes = align16((size_t)Sk * LDK * sizeof(float));
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = reinterpret_cast<float*>(smem + kv_bytes);
  float* sQ = reinterpret_cast<float*>(smem + 2 * kv_bytes);   // R x HD
  float* sS = sQ + R * HD;                                      // R x Sk
  require_smem(2 * kv_bytes + align16((size_t)R * HD * 4) +
               (size_t)R * Sk * 4);

  const int bkv = blockIdx.x;            // b * KH + kh
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * RPT;
  load_kv<HD, LDK>(sK, k + (size_t)bkv * Sk * HD, Sk);
  load_kv<HD, LDK>(sV, v + (size_t)bkv * Sk * HD, Sk);

  for (int g = 0; g < G; ++g) {
    for (int i0 = 0; i0 < Sq; i0 += R) {
      const Strip st = make_strip(i0, R, Sq, Sk, q_offset, causal, window);
      // index of strip row 0 among the (B, H, Sq) rows: H = KH * G
      const size_t base = ((size_t)bkv * G + g) * Sq + i0;
      __syncthreads();   // K/V loaded; the previous strip's sQ reads done
      load_rows<float, HD, R, HD, NT>(sQ, q + base * HD, st.rows, scale);
      __syncthreads();

      for (int cb = st.c_lo; cb < st.c_hi; cb += 32 * JN) {
        float s[RPT][JN], unused[RPT][JN];
        strip_products<HD, LDK, RPT, false>(sQ, nullptr, sK, nullptr,
                                               row0, cb, Sk, s, unused);
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < JN; ++j) {
            const int c = cb + lane + 32 * j;
            const int r = row0 + i;
            if (c < st.c_hi) {
              const bool live = r < st.rows &&
                                is_live(st.p_lo + r, c, Sk, causal, window);
              sS[r * Sk + c] = live ? s[i][j] : NEG_INF;
            }
          }
      }
      __syncwarp();

      // whole-row softmax of the warp's rows
      float m[RPT], l[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        float* srow = sS + (row0 + i) * Sk;
        float mx = NEG_INF;
        for (int c = st.c_lo + lane; c < st.c_hi; c += 32)
          mx = fmaxf(mx, srow[c]);
#pragma unroll
        for (int off = 16; off; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        float sum = 0.f;
        for (int c = st.c_lo + lane; c < st.c_hi; c += 32) {
          const float sv = srow[c];
          const float p = sv == NEG_INF ? 0.f : expf(sv - mx);
          srow[c] = p;
          sum += p;
        }
#pragma unroll
        for (int off = 16; off; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        m[i] = mx;
        l[i] = fmaxf(sum, 1e-37f);
      }
      __syncwarp();

      // o = p . V over the live columns
      float acc[RPT][ND];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int c = st.c_lo; c < st.c_hi; ++c) {
        float p[RPT], vv[ND];
#pragma unroll
        for (int i = 0; i < RPT; ++i) p[i] = sS[(row0 + i) * Sk + c];
#pragma unroll
        for (int j = 0; j < ND; ++j)
          vv[j] = sV[c * LDK + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < ND; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = row0 + i;
        if (r >= st.rows) continue;
        if (lse != nullptr && lane == 0) lse[base + r] = m[i] + logf(l[i]);
        float* orow = o + (base + r) * HD;
#pragma unroll
        for (int j = 0; j < ND; ++j)
          orow[lane + 32 * j] = acc[i][j] / l[i];
      }
    }
  }
}

// ------------------------------------------------------------------ K4b

template <int HD, int RPT>
__global__ void __launch_bounds__(NT)
mega_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq,
                float* __restrict__ dk, float* __restrict__ dv, int G, int Sq,
                int Sk, int q_offset, int causal, int window, float scale) {
  constexpr int R = RPT * NW, LDK = HD + 1, ND = HD / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t kv_bytes = align16((size_t)Sk * LDK * sizeof(float));
  const size_t acc_bytes = align16((size_t)Sk * HD * 4);
  const size_t row_bytes = align16((size_t)R * HD * 4);
  const size_t score_bytes = align16((size_t)R * Sk * 4);
  unsigned char* p = smem;
  float* sK = reinterpret_cast<float*>(p);                p += kv_bytes;
  float* sV = reinterpret_cast<float*>(p);                p += kv_bytes;
  float* sdK = reinterpret_cast<float*>(p);       p += acc_bytes;
  float* sdV = reinterpret_cast<float*>(p);       p += acc_bytes;
  float* sQ = reinterpret_cast<float*>(p);        p += row_bytes;    // scaled
  float* sO = reinterpret_cast<float*>(p);        p += row_bytes;    // dO
  float* sP = reinterpret_cast<float*>(p);        p += score_bytes;  // P
  float* sD = reinterpret_cast<float*>(p);        p += score_bytes;  // dS
  float* sL = reinterpret_cast<float*>(p);        p += align16(R * 4);
  float* sDl = reinterpret_cast<float*>(p);
  require_smem((size_t)(p - smem) + R * 4);

  const int bkv = blockIdx.x;            // b * KH + kh
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * RPT;
  load_kv<HD, LDK>(sK, k + (size_t)bkv * Sk * HD, Sk);
  load_kv<HD, LDK>(sV, v + (size_t)bkv * Sk * HD, Sk);
  for (int i = threadIdx.x; i < Sk * HD; i += NT) sdK[i] = sdV[i] = 0.f;

  for (int g = 0; g < G; ++g) {
    for (int i0 = 0; i0 < Sq; i0 += R) {
      const Strip st = make_strip(i0, R, Sq, Sk, q_offset, causal, window);
      const size_t base = ((size_t)bkv * G + g) * Sq + i0;
      __syncthreads();   // the previous strip's dK/dV pass is done
      load_rows<float, HD, R, HD, NT>(sQ, q + base * HD, st.rows, scale);
      load_rows<float, HD, R, HD, NT>(sO, dout + base * HD, st.rows, 1.f);
      for (int r = threadIdx.x; r < R; r += NT) {
        sL[r] = r < st.rows ? lse[base + r] : 0.f;
        sDl[r] = r < st.rows ? delta[base + r] : 0.f;
      }
      __syncthreads();

      // P and dS of the warp's rows over the live columns
      for (int cb = st.c_lo; cb < st.c_hi; cb += 32 * JN) {
        float s[RPT][JN], dp[RPT][JN];
        strip_products<HD, LDK, RPT, true>(sQ, sO, sK, sV, row0, cb, Sk,
                                              s, dp);
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < JN; ++j) {
            const int c = cb + lane + 32 * j;
            const int r = row0 + i;
            if (c < st.c_hi) {
              const bool live = r < st.rows &&
                                is_live(st.p_lo + r, c, Sk, causal, window);
              const float pr = live ? expf(s[i][j] - sL[r]) : 0.f;
              sP[r * Sk + c] = pr;
              sD[r * Sk + c] = pr * (dp[i][j] - sDl[r]);
            }
          }
      }
      __syncwarp();

      // the warp's whole dq rows: scale * dS . K, written once
      {
        float acc[RPT][ND];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < ND; ++j) acc[i][j] = 0.f;
#pragma unroll 4
        for (int c = st.c_lo; c < st.c_hi; ++c) {
          float w[RPT], kv[ND];
#pragma unroll
          for (int i = 0; i < RPT; ++i) w[i] = sD[(row0 + i) * Sk + c];
#pragma unroll
          for (int j = 0; j < ND; ++j)
            kv[j] = sK[c * LDK + lane + 32 * j];
#pragma unroll
          for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int j = 0; j < ND; ++j)
              acc[i][j] = fmaf(w[i], kv[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = row0 + i;
          if (r >= st.rows) continue;
          float* drow = dq + (base + r) * HD;
#pragma unroll
          for (int j = 0; j < ND; ++j)
            drow[lane + 32 * j] = acc[i][j] * scale;
        }
      }
      __syncthreads();   // every row's P and dS written

      // dV += P^T dO, dK += dS^T (q * scale): warp w takes CPT columns a
      // pass, lane the head columns lane + 32j; rows summed in order
      for (int cb = st.c_lo + warp * CPT; cb < st.c_hi; cb += NW * CPT) {
        float adk[CPT][ND], adv[CPT][ND];
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc)
#pragma unroll
          for (int j = 0; j < ND; ++j) adk[cc][j] = adv[cc][j] = 0.f;
        const int ncol = min(CPT, st.c_hi - cb);
        for (int r = 0; r < st.rows; ++r) {
          float pv[CPT], dsv[CPT], ov[ND], qv[ND];
#pragma unroll
          for (int cc = 0; cc < CPT; ++cc) {
            pv[cc] = cc < ncol ? sP[r * Sk + cb + cc] : 0.f;
            dsv[cc] = cc < ncol ? sD[r * Sk + cb + cc] : 0.f;
          }
#pragma unroll
          for (int j = 0; j < ND; ++j) {
            ov[j] = sO[r * HD + lane + 32 * j];
            qv[j] = sQ[r * HD + lane + 32 * j];
          }
#pragma unroll
          for (int cc = 0; cc < CPT; ++cc)
#pragma unroll
            for (int j = 0; j < ND; ++j) {
              adv[cc][j] = fmaf(pv[cc], ov[j], adv[cc][j]);
              adk[cc][j] = fmaf(dsv[cc], qv[j], adk[cc][j]);
            }
        }
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) {
          if (cc >= ncol) break;
#pragma unroll
          for (int j = 0; j < ND; ++j) {
            const int e = (cb + cc) * HD + lane + 32 * j;
            sdK[e] += adk[cc][j];
            sdV[e] += adv[cc][j];
          }
        }
      }
    }
  }
  __syncthreads();
  float* dkp = dk + (size_t)bkv * Sk * HD;
  float* dvp = dv + (size_t)bkv * Sk * HD;
  for (int i = threadIdx.x; i < Sk * HD; i += NT) {
    dkp[i] = sdK[i];
    dvp[i] = sdV[i];
  }
}

// ------------------------------------------------- bf16: tensor cores

constexpr int TC_NT = 128, TC_NW = TC_NT / 32;   // four warps
constexpr int TC_TILE = 64;   // kv rows of a K4f / K4b phase-1 tile; K and
                              // V are resident rounded up to it
constexpr int SLICE = 16;     // query rows a warp takes at once

__host__ __device__ constexpr int round_tile(int n) {
  return (n + TC_TILE - 1) / TC_TILE * TC_TILE;
}

// Element offset of (row r, column c) in a tile of rows of W bf16 (W 64
// or 128; c a multiple of 8): the row's 16-byte chunk c / 8 is XORed
// with r % 8 inside its group of eight, so the eight rows that one
// ldmatrix phase reads at one logical chunk sit in eight bank groups.
template <int W>
__device__ __forceinline__ int swz(int r, int c) {
  const int ch = c >> 3;
  return r * W + ((ch & ~7) | ((ch ^ r) & 7)) * 8;
}

// ldmatrix addresses of one 16 x 16 step at (r0, c0) in a swizzled tile,
// the patterns of common.cuh: a_sw for A from [m][k] and for B^T from
// [k][n] (a_addr, bt_addr), b_sw for B from [n][k] and A^T from [k][m]
// (b_addr, at_addr)
template <int W>
__device__ __forceinline__ const bf16* a_sw(const bf16* s, int r0, int c0,
                                            int lane) {
  return s + swz<W>(r0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                    c0 + (lane >> 4) * 8);
}
template <int W>
__device__ __forceinline__ const bf16* b_sw(const bf16* s, int r0, int c0,
                                            int lane) {
  return s + swz<W>(r0 + (lane & 7) + (lane >> 4) * 8,
                    c0 + ((lane >> 3) & 1) * 8);
}

// Rows [0, rows) of a (rows, hd) bf16 array into a swizzled W-wide tile
// by 16-byte cp.async, thread `tid` of `nt` taking every nt-th chunk;
// rows at or past `valid` and columns hd..W are zero-filled unread.
template <int W>
__device__ __forceinline__ void cp_rows_sw(bf16* dst, const bf16* src,
                                           int rows, int valid, int hd,
                                           int tid, int nt) {
  constexpr int CH = W / 8;
  for (int idx = tid; idx < rows * CH; idx += nt) {
    const int r = idx / CH, c = (idx % CH) * 8;
    const bool ok = r < valid && c < hd;
    cp_async16(dst + swz<W>(r, c), ok ? src + (size_t)r * hd + c : src, ok);
  }
}

// n fp32 values (lse or delta rows), zeros at or past `valid`
__device__ __forceinline__ void cp_floats(float* dst, const float* src,
                                          int n, int valid, int tid,
                                          int nt) {
  for (int i = tid; i < n; i += nt)
    cp_async4(dst + i, i < valid ? src + i : src, i < valid);
}

// The live entries of one row of an accumulator fragment, as an
// inclusive range [lo, hi] of n * 8 + (e & 1): with the lane's 2t and the
// tile's first column taken off, entry (n, e) of the row is live iff it
// lies in the range.  For a query row `row` against kv columns from k0:
// col < Sk, col <= row when causal, row - col < window when windowed
// (the reference's _tile_mask, is_live in common.cuh).
struct Span {
  int lo, hi;
  __device__ __forceinline__ bool has(int c) const {
    return c >= lo && c <= hi;
  }
};
__device__ __forceinline__ Span row_span(int row, int k0, int t, int Sk,
                                         int causal, int window) {
  const int hi = causal ? min(Sk - 1, row) : Sk - 1;
  const int lo = window > 0 ? row - window + 1 : -(1 << 30);
  return {lo - k0 - 2 * t, hi - k0 - 2 * t};
}

// The item (query slice or kv tile) that worker w of n takes at its step
// i: the n workers take n consecutive items, in reverse order on odd
// steps, so that over two steps each worker meets one item from each end
// of a run of 2n and the causal work of the workers evens out.
// Increasing in i.
__device__ __forceinline__ int snake_at(int i, int w, int n) {
  return i * n + ((i & 1) ? n - 1 - w : w);
}

// Barrier of the 128 threads of four-warp group `grp` (named barrier
// 1 + grp; __syncthreads is barrier 0).
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + grp) : "memory");
}

// K4f's block: K, V (whole Sk, rounded up), then each warp's q slice
template <int HD>
__host__ __device__ constexpr size_t fwd_tc_bytes(int sk) {
  return ((size_t)2 * round_tile(sk) * HD + (size_t)TC_NW * SLICE * HD) * 2;
}

// K4b's tiles, K2's (TcTiles in flash_attention_bwd.cu): phase 1 streams
// TQ-row q tiles past each 64-row kv tile, phase 2 walks TK-row kv tiles
// for each 16-row q slice.  GROUPS four-warp groups a block (two at HD
// 64, where the registers leave room for eight warps an SM but not for
// three four-warp blocks): each group streams its own kv tiles' q tiles
// in phase 1, and all NW warps walk the slices in phase 2.
template <int HD>
struct BwdTc {
  static constexpr int TQ = HD == 64 ? 64 : 32;
  static constexpr int TK = HD == 64 ? 64 : 32;
  static constexpr int GROUPS = HD == 64 ? 2 : 1;
  static constexpr int NW = 4 * GROUPS, THREADS = 32 * NW;
  // a group's two stages of q, dO (TQ x HD bf16 each), lse, delta (TQ
  // fp32 each)
  static constexpr size_t PHASE1 =
      2 * ((size_t)2 * TQ * HD * 2 + 2 * TQ * 4);
  // one slice's q, dO (16 x HD bf16 each), lse, delta (16 fp32 each)
  static constexpr size_t SLICE_BYTES =
      (size_t)2 * SLICE * HD * 2 + 2 * SLICE * 4;
  static constexpr size_t PHASE2 = (size_t)NW * 2 * SLICE_BYTES;
  static constexpr size_t STREAM = GROUPS * PHASE1 > PHASE2 ? GROUPS * PHASE1
                                                            : PHASE2;
  __host__ __device__ static constexpr size_t bytes(int sk) {
    return (size_t)2 * round_tile(sk) * HD * 2 + STREAM;
  }
};

// K4f on tensor cores: one block per (batch, kv head)
template <int HD>
__global__ void __launch_bounds__(TC_NT, HD == 64 ? 3 : 1)
mega_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o,
                   float* __restrict__ lse, int G, int Sq, int Sk, int hd,
                   int q_offset, int causal, int window, float scale) {
  constexpr int KS = HD / 16, NK = TC_TILE / 8, ND = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  require_smem(fwd_tc_bytes<HD>(Sk));
  const int skp = round_tile(Sk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);   // skp x HD, swizzled
  bf16* sV = sK + (size_t)skp * HD;                // skp x HD, swizzled
  bf16* sQ = sV + (size_t)skp * HD + warp * SLICE * HD;   // this warp's

  const int bkv = blockIdx.x;   // b * KH + kh; its heads are bkv * G + gi
  cp_rows_sw<HD>(sK, k + (size_t)bkv * Sk * hd, skp, Sk, hd, threadIdx.x,
                 TC_NT);
  cp_rows_sw<HD>(sV, v + (size_t)bkv * Sk * hd, skp, Sk, hd, threadIdx.x,
                 TC_NT);
  cp_async_commit();

  // slice s: head s / nsl of the group, rows (s % nsl) * SLICE ..
  const int nsl = (Sq + SLICE - 1) / SLICE, n_sl = G * nsl;
  auto load_q = [&](int s) {
    const int i0 = (s % nsl) * SLICE;
    const size_t row = ((size_t)bkv * G + s / nsl) * Sq + i0;
    cp_rows_sw<HD>(sQ, q + row * hd, SLICE, Sq - i0, hd, lane, 32);
  };
  if (snake_at(0, warp, TC_NW) < n_sl) load_q(snake_at(0, warp, TC_NW));
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();   // every thread's rows of K and V have landed

  for (int i_s = 0, s = snake_at(0, warp, TC_NW); s < n_sl;
       s = snake_at(++i_s, warp, TC_NW)) {
    const int i0 = (s % nsl) * SLICE, q_rows = min(SLICE, Sq - i0);
    const size_t row = ((size_t)bkv * G + s / nsl) * Sq + i0;
    uint32_t qf[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      ldsm_x4(qf[ks], a_sw<HD>(sQ, 0, ks * 16, lane));
    __syncwarp();   // every lane holds its fragments: the buffer refills
    const int next = snake_at(i_s + 1, warp, TC_NW);
    if (next < n_sl) load_q(next);
    cp_async_commit();

    const int row0 = q_offset + i0;   // global position of slice row 0
    int kv_begin = 0, kv_end = Sk;
    if (causal) kv_end = min(Sk, row0 + SLICE);
    if (window > 0) kv_begin = max(0, row0 - window + 1);
    float acc[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

    for (int k0 = (kv_begin / TC_TILE) * TC_TILE; k0 < kv_end;
         k0 += TC_TILE) {
      // the tile's 16-column chunks [c_lo, c_hi) hold every live column
      const int c_lo = max(0, kv_begin - k0) / 16;
      const int c_hi = (min(TC_TILE, kv_end - k0) + 15) / 16;
      float s_[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s_[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {   // a k16 step's loads, then mma
        uint32_t b[NK / 2][4];
#pragma unroll
        for (int np = 0; np < NK / 2; ++np)
          if (np >= c_lo && np < c_hi)
            ldsm_x4(b[np], b_sw<HD>(sK, k0 + np * 16, ks * 16, lane));
#pragma unroll
        for (int np = 0; np < NK / 2; ++np)
          if (np >= c_lo && np < c_hi) {
            mma_bf16(s_[2 * np], qf[ks], b[np][0], b[np][1]);
            mma_bf16(s_[2 * np + 1], qf[ks], b[np][2], b[np][3]);
          }
      }
      // scale in fp32; mask only where the causal edge, the window edge
      // or Sk cuts the tile (skipped chunks are always cut)
      const bool full = k0 + TC_TILE <= Sk &&
                        (!causal || k0 + TC_TILE - 1 <= row0) &&
                        (window <= 0 || row0 + SLICE - 1 - k0 < window);
      if (full) {
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s_[n][e] *= scale;
      } else {
        const Span sp[2] = {row_span(row0 + g, k0, t, Sk, causal, window),
                            row_span(row0 + g + 8, k0, t, Sk, causal,
                                     window)};
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s_[n][e] = sp[e >> 1].has(n * 8 + (e & 1)) ? s_[n][e] * scale
                                                       : NEG_INF;
      }

      // online softmax on the fragments: a row lives in a quad's 4 lanes
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s_[n][0], s_[n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s_[n][2], s_[n][3]));
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
          s_[n][e] = __expf(s_[n][e] - m[e >> 1]);
          rs[e >> 1] += s_[n][e];
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

      // O += P V: P from registers as a bf16 hi + lo pair, V^T by
      // ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < TC_TILE / 16; ++kk) {
        if (kk < c_lo || kk >= c_hi) continue;
        uint32_t hi[4], lo[4], b[ND / 2][4];
        split_frag(s_[2 * kk], s_[2 * kk + 1], hi, lo);
#pragma unroll
        for (int np = 0; np < ND / 2; ++np)
          ldsm_x4_t(b[np], a_sw<HD>(sV, k0 + kk * 16, np * 16, lane));
#pragma unroll
        for (int np = 0; np < ND / 2; ++np)
          mma_pair(acc[2 * np], acc[2 * np + 1], hi, lo, b[np]);
      }
    }

    // each lane holds a quarter of its rows' sums
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = g + 8 * i;
      if (r >= q_rows) continue;
      const float den = fmaxf(l[i], 1e-37f), inv = 1.f / den;
      if (lse != nullptr && t == 0) lse[row + r] = m[i] + logf(den);
      bf16* out = o + (row + r) * hd;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int c = n * 8 + 2 * t;
        if (c < hd)
          *reinterpret_cast<__nv_bfloat162*>(out + c) = __floats2bfloat162_rn(
              acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
      }
    }
    cp_async_wait<0>();
    __syncwarp();   // the next slice's q has landed for every lane
  }
}

// K4b on tensor cores: one block per (batch, kv head)
template <int HD>
__global__ void __launch_bounds__(BwdTc<HD>::THREADS, 1)
mega_bwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int G,
                   int Sq, int Sk, int hd, int q_offset, int causal,
                   int window, float scale) {
  using C = BwdTc<HD>;
  constexpr int TQ = C::TQ, TK = C::TK, KS = HD / 16, ND = HD / 8;
  constexpr int NQ = TQ / 8, NK = TK / 8, NG = C::GROUPS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  require_smem(C::bytes(Sk));
  const int skp = round_tile(Sk), n_kt = skp / TC_TILE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  // phase 1: group grp, its thread gtid, the warp's 16 rows of a kv tile
  const int grp = warp >> 2, gtid = threadIdx.x & 127, w0 = (warp & 3) * 16;
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);   // skp x HD, swizzled
  bf16* sV = sK + (size_t)skp * HD;                // skp x HD, swizzled
  unsigned char* stream = smem_raw + (size_t)2 * skp * HD * 2;

  const int bkv = blockIdx.x;   // b * KH + kh; its heads are bkv * G + gi
  cp_rows_sw<HD>(sK, k + (size_t)bkv * Sk * hd, skp, Sk, hd, threadIdx.x,
                 C::THREADS);
  cp_rows_sw<HD>(sV, v + (size_t)bkv * Sk * hd, skp, Sk, hd, threadIdx.x,
                 C::THREADS);
  cp_async_commit();

  // ---- phase 1: dK, dV.  Group grp takes kv tiles snake_at(m, grp, NG),
  // m = 0, 1, ..., with two stages of q, dO, lse, delta of its own.
  bf16* sQ = reinterpret_cast<bf16*>(stream + grp * C::PHASE1);
                                                 // 2 x TQ x HD, swizzled
  bf16* sO = sQ + 2 * TQ * HD;                   // 2 x TQ x HD, swizzled
  float* sL = reinterpret_cast<float*>(sO + 2 * TQ * HD);   // 2 x TQ
  float* sD = sL + 2 * TQ;                                   // 2 x TQ

  const int n_m = (n_kt + NG - 1) / NG;   // the group's kv tile steps
  // the q tiles [qt0, qt0 + n_qt * TQ) whose masks keep some column of kv
  // tile j (K2's q_lo / q_hi); none past the last kv tile
  auto q_tiles = [&](int j, int& qt0, int& n_qt) {
    qt0 = n_qt = 0;
    if (j >= n_kt) return;
    const int k0 = j * TC_TILE, k_last = min(Sk, k0 + TC_TILE) - 1;
    int q_lo = 0, q_hi = Sq;
    if (causal) q_lo = max(0, k0 - q_offset);
    if (window > 0) q_hi = min(Sq, k_last + window - q_offset);
    qt0 = (q_lo / TQ) * TQ;
    n_qt = q_hi > qt0 ? (q_hi - qt0 + TQ - 1) / TQ : 0;
  };
  // iteration (m, it) of the group's kv tile step m: head it / n_qt, q
  // tile it % n_qt, in K2's order; `advance` steps to the next one over
  // the steps that have any (m reaches n_m past the last)
  auto advance = [&](int& m, int& it) {
    int qt0, n_qt;
    q_tiles(snake_at(m, grp, NG), qt0, n_qt);
    if (++it < G * n_qt) return;
    it = 0;
    for (++m; m < n_m; ++m) {
      q_tiles(snake_at(m, grp, NG), qt0, n_qt);
      if (n_qt > 0) return;
    }
  };
  auto issue = [&](int m, int it, int stage) {
    int qt0, n_qt;
    q_tiles(snake_at(m, grp, NG), qt0, n_qt);
    const int q0 = qt0 + (it % n_qt) * TQ;
    const size_t row = ((size_t)bkv * G + it / n_qt) * Sq + q0;
    cp_rows_sw<HD>(sQ + stage * TQ * HD, q + row * hd, TQ, Sq - q0, hd,
                   gtid, 128);
    cp_rows_sw<HD>(sO + stage * TQ * HD, dout + row * hd, TQ, Sq - q0, hd,
                   gtid, 128);
    cp_floats(sL + stage * TQ, lse + row, TQ, Sq - q0, gtid, 128);
    cp_floats(sD + stage * TQ, delta + row, TQ, Sq - q0, gtid, 128);
  };
  int nm = 0, nit = -1, stage = 0;   // the next iteration to issue
  advance(nm, nit);
  if (nm < n_m) issue(nm, nit, 0);
  cp_async_commit();
  cp_async_wait<1>();   // this thread's K and V rows (the issue may fly)
  __syncthreads();      // every thread's K and V rows have landed

  for (int m = 0; m < n_m; ++m) {
    const int j = snake_at(m, grp, NG);
    int qt0, n_qt;
    q_tiles(j, qt0, n_qt);
    const int k0 = j * TC_TILE, kv_rows = min(TC_TILE, Sk - k0);
    float adk[ND][4], adv[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;

    for (int it = 0; it < G * n_qt; ++it) {
      const int st = stage;   // (m, it) was issued into it
      advance(nm, nit);
      if (nm < n_m) {
        issue(nm, nit, st ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      group_sync(grp);
      stage ^= 1;
      const int q0 = qt0 + (it % n_qt) * TQ, q_rows = min(TQ, Sq - q0);
      const int p0 = q_offset + q0;   // global position of q tile row 0
      const bf16* Qs = sQ + st * TQ * HD;
      const bf16* Os = sO + st * TQ * HD;
      const float* Ls = sL + st * TQ;
      const float* Ds = sD + st * TQ;
      // the warp's live 16-row q chunks: causal drops those wholly before
      // its first kv row, Sq those past the edge
      const int c_lo = causal ? max(0, k0 + w0 - p0) / 16 : 0;
      const int c_hi = min(TQ / 16, (q_rows + 15) / 16);

      // transposed tiles: s[n][e] = S[q col n*8 + 2t + (e&1)][kv row
      // w0 + g + 8(e>>1)]
      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {   // a k16 step's loads, then mma
        uint32_t ak[4], av[4], b[NQ / 2][4];
        ldsm_x4(ak, a_sw<HD>(sK, k0 + w0, ks * 16, lane));
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np)
          if (np >= c_lo && np < c_hi)
            ldsm_x4(b[np], b_sw<HD>(Qs, np * 16, ks * 16, lane));
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np)
          if (np >= c_lo && np < c_hi) {
            mma_bf16(s[2 * np], ak, b[np][0], b[np][1]);
            mma_bf16(s[2 * np + 1], ak, b[np][2], b[np][3]);
          }
        ldsm_x4(av, a_sw<HD>(sV, k0 + w0, ks * 16, lane));
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np)
          if (np >= c_lo && np < c_hi)
            ldsm_x4(b[np], b_sw<HD>(Os, np * 16, ks * 16, lane));
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np)
          if (np >= c_lo && np < c_hi) {
            mma_bf16(dp[2 * np], av, b[np][0], b[np][1]);
            mma_bf16(dp[2 * np + 1], av, b[np][2], b[np][3]);
          }
      }
      // P^T and dS^T = P^T (dP^T - delta), unscaled, in place.  The
      // thread's kv rows kr keep the q rows qr < q_rows with kr < Sk,
      // kr <= p0 + qr when causal, p0 + qr - kr < window when windowed.
      Span sp[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int kr = k0 + w0 + g + 8 * i;
        int lo = causal ? kr - p0 : 0, hi = q_rows - 1;
        if (window > 0) hi = min(hi, kr + window - 1 - p0);
        if (kr >= Sk) hi = -1;
        sp[i] = {lo - 2 * t, hi - 2 * t};
      }
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qr = n * 8 + 2 * t + (e & 1);
          const bool live = sp[e >> 1].has(n * 8 + (e & 1));
          const float p = expf((live ? s[n][e] * scale : NEG_INF) - Ls[qr]);
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - Ds[qr]);
        }
      // dV += P^T dO, dK += dS^T Q: A from registers (hi + lo), B by
      // ldmatrix.trans from the [q][d] tiles
#pragma unroll
      for (int kq = 0; kq < TQ / 16; ++kq) {
        if (kq < c_lo || kq >= c_hi) continue;
        uint32_t hi[4], lo[4], b[ND / 2][4];
        split_frag(s[2 * kq], s[2 * kq + 1], hi, lo);
#pragma unroll
        for (int np = 0; np < ND / 2; ++np)
          ldsm_x4_t(b[np], a_sw<HD>(Os, kq * 16, np * 16, lane));
#pragma unroll
        for (int np = 0; np < ND / 2; ++np)
          mma_pair(adv[2 * np], adv[2 * np + 1], hi, lo, b[np]);
        split_frag(dp[2 * kq], dp[2 * kq + 1], hi, lo);
#pragma unroll
        for (int np = 0; np < ND / 2; ++np)
          ldsm_x4_t(b[np], a_sw<HD>(Qs, kq * 16, np * 16, lane));
#pragma unroll
        for (int np = 0; np < ND / 2; ++np)
          mma_pair(adk[2 * np], adk[2 * np + 1], hi, lo, b[np]);
      }
      group_sync(grp);   // this stage is read; the next issue may land
    }

    // the kv tile's dk and dv, written once (zeros where no q row reaches)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = w0 + g + 8 * i;
      if (r >= kv_rows) continue;
      const size_t off = ((size_t)bkv * Sk + k0 + r) * hd;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int c = n * 8 + 2 * t;
        if (c >= hd) continue;
        *reinterpret_cast<__nv_bfloat162*>(dk + off + c) =
            __floats2bfloat162_rn(adk[n][2 * i] * scale,
                                  adk[n][2 * i + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + c) =
            __floats2bfloat162_rn(adv[n][2 * i], adv[n][2 * i + 1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // phase 1's stages are read; K and V visible to all

  // ---- phase 2: dq.  Each warp double-buffers its own slices.
  unsigned char* wbase = stream + (size_t)warp * 2 * C::SLICE_BYTES;
  const int nsl = (Sq + SLICE - 1) / SLICE, n_sl = G * nsl;
  auto slice_q = [&](int st) {
    return reinterpret_cast<bf16*>(wbase + st * C::SLICE_BYTES);
  };
  auto load_slice = [&](int s, int st) {
    const int i0 = (s % nsl) * SLICE;
    const size_t row = ((size_t)bkv * G + s / nsl) * Sq + i0;
    bf16* Qs = slice_q(st);
    bf16* Os = Qs + SLICE * HD;
    float* Ls = reinterpret_cast<float*>(Os + SLICE * HD);
    cp_rows_sw<HD>(Qs, q + row * hd, SLICE, Sq - i0, hd, lane, 32);
    cp_rows_sw<HD>(Os, dout + row * hd, SLICE, Sq - i0, hd, lane, 32);
    cp_floats(Ls, lse + row, SLICE, Sq - i0, lane, 32);
    cp_floats(Ls + SLICE, delta + row, SLICE, Sq - i0, lane, 32);
  };
  if (snake_at(0, warp, C::NW) < n_sl)
    load_slice(snake_at(0, warp, C::NW), 0);
  cp_async_commit();

  for (int i_s = 0, s = snake_at(0, warp, C::NW); s < n_sl;
       s = snake_at(++i_s, warp, C::NW)) {
    const int st = i_s & 1, next = snake_at(i_s + 1, warp, C::NW);
    if (next < n_sl) {
      load_slice(next, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();   // this slice has landed for every lane
    const int i0 = (s % nsl) * SLICE, q_rows = min(SLICE, Sq - i0);
    const size_t row = ((size_t)bkv * G + s / nsl) * Sq + i0;
    const bf16* Qs = slice_q(st);
    const bf16* Os = Qs + SLICE * HD;
    const float* Ls = reinterpret_cast<const float*>(Os + SLICE * HD);
    const float rl[2] = {Ls[g], Ls[g + 8]};
    const float rd[2] = {Ls[SLICE + g], Ls[SLICE + g + 8]};
    const int row0 = q_offset + i0;   // global position of slice row 0
    int kv_begin = 0, kv_end = Sk;
    if (causal) kv_end = min(Sk, row0 + SLICE);
    if (window > 0) kv_begin = max(0, row0 - window + 1);
    float acc[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    for (int kk0 = (kv_begin / TK) * TK; kk0 < kv_end; kk0 += TK) {
      const int c_lo = max(0, kv_begin - kk0) / 16;
      const int c_hi = (min(TK, kv_end - kk0) + 15) / 16;
      float s_[NK][4], dp[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s_[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {   // a k16 step's loads, then mma
        uint32_t aq[4], ao[4], b[NK / 2][4];
        ldsm_x4(aq, a_sw<HD>(Qs, 0, ks * 16, lane));
#pragma unroll
        for (int np = 0; np < NK / 2; ++np)
          if (np >= c_lo && np < c_hi)
            ldsm_x4(b[np], b_sw<HD>(sK, kk0 + np * 16, ks * 16, lane));
#pragma unroll
        for (int np = 0; np < NK / 2; ++np)
          if (np >= c_lo && np < c_hi) {
            mma_bf16(s_[2 * np], aq, b[np][0], b[np][1]);
            mma_bf16(s_[2 * np + 1], aq, b[np][2], b[np][3]);
          }
        ldsm_x4(ao, a_sw<HD>(Os, 0, ks * 16, lane));
#pragma unroll
        for (int np = 0; np < NK / 2; ++np)
          if (np >= c_lo && np < c_hi)
            ldsm_x4(b[np], b_sw<HD>(sV, kk0 + np * 16, ks * 16, lane));
#pragma unroll
        for (int np = 0; np < NK / 2; ++np)
          if (np >= c_lo && np < c_hi) {
            mma_bf16(dp[2 * np], ao, b[np][0], b[np][1]);
            mma_bf16(dp[2 * np + 1], ao, b[np][2], b[np][3]);
          }
      }
      // P = exp(s - lse), dS = P (dP - delta), the scale applied at the end
      const Span sp[2] = {row_span(row0 + g, kk0, t, Sk, causal, window),
                          row_span(row0 + g + 8, kk0, t, Sk, causal, window)};
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float sv =
              sp[i].has(n * 8 + (e & 1)) ? s_[n][e] * scale : NEG_INF;
          dp[n][e] = expf(sv - rl[i]) * (dp[n][e] - rd[i]);
        }
      // dQ += dS K: dS from registers (hi + lo), K^T by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        if (kk < c_lo || kk >= c_hi) continue;
        uint32_t hi[4], lo[4], b[ND / 2][4];
        split_frag(dp[2 * kk], dp[2 * kk + 1], hi, lo);
#pragma unroll
        for (int np = 0; np < ND / 2; ++np)
          ldsm_x4_t(b[np], a_sw<HD>(sK, kk0 + kk * 16, np * 16, lane));
#pragma unroll
        for (int np = 0; np < ND / 2; ++np)
          mma_pair(acc[2 * np], acc[2 * np + 1], hi, lo, b[np]);
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = g + 8 * i;
      if (r >= q_rows) continue;
      bf16* out = dq + (row + r) * hd;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int c = n * 8 + 2 * t;
        if (c < hd)
          *reinterpret_cast<__nv_bfloat162*>(out + c) = __floats2bfloat162_rn(
              acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale);
      }
    }
    __syncwarp();   // this stage is read; the issue after next may land
  }
}

struct MegaArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int B, H, KH, Sq, Sk, hd, q_offset, causal, window, rows, smem;
  int* occupancy;   // non-null: report blocks per SM instead of launching
};

// Set the kernel's shared-memory limit, then either report its blocks
// per SM (a.occupancy) or launch one block per (batch, kv head).
template <int THREADS, typename Kern, typename... Args>
cudaError_t run(Kern kern, const MegaArgs& a, cudaStream_t stream,
                Args... args) {
  if (a.smem <= 0 || (size_t)a.smem > SMEM_OPTIN)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return err;
  if (a.occupancy != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(a.occupancy, kern,
                                                         THREADS, a.smem);
  kern<<<a.B * a.KH, THREADS, a.smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int HD, int RPT>
cudaError_t launch_f32(int bwd, const MegaArgs& a, void* o, float* lse,
                       void* dq, void* dk, void* dv, cudaStream_t st) {
  const float *q = static_cast<const float*>(a.q),
              *k = static_cast<const float*>(a.k),
              *v = static_cast<const float*>(a.v);
  const float scale = 1.0f / sqrtf((float)HD);
  const int G = a.H / a.KH;
  if (bwd)
    return run<NT>(mega_bwd_kernel<HD, RPT>, a, st, q, k, v,
                   static_cast<const float*>(a.dout), a.lse, a.delta,
                   static_cast<float*>(dq), static_cast<float*>(dk),
                   static_cast<float*>(dv), G, a.Sq, a.Sk, a.q_offset,
                   a.causal, a.window, scale);
  return run<NT>(mega_fwd_kernel<HD, RPT>, a, st, q, k, v,
                 static_cast<float*>(o), lse, G, a.Sq, a.Sk, a.q_offset,
                 a.causal, a.window, scale);
}

template <int HD>
cudaError_t dispatch_rows(int bwd, const MegaArgs& a, void* o, float* lse,
                          void* dq, void* dk, void* dv, cudaStream_t st) {
  switch (a.rows) {
    case 8:
      return launch_f32<HD, 1>(bwd, a, o, lse, dq, dk, dv, st);
    case 16:
      return launch_f32<HD, 2>(bwd, a, o, lse, dq, dk, dv, st);
    case 32:
      return launch_f32<HD, 4>(bwd, a, o, lse, dq, dk, dv, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// bf16 at the compiled width HD (64 or 128) for any hd <= HD; the scale
// 1/sqrt(hd) of the true width, in double and then rounded to fp32 as the
// tiled kernels' wrapper computes it
template <int HD>
cudaError_t launch_tc(int bwd, const MegaArgs& a, void* o, float* lse,
                      void* dq, void* dk, void* dv, cudaStream_t st) {
  if (a.rows != TC_TILE) return cudaErrorInvalidValue;
  const bf16 *q = static_cast<const bf16*>(a.q),
             *k = static_cast<const bf16*>(a.k),
             *v = static_cast<const bf16*>(a.v);
  const float scale = (float)(1.0 / sqrt((double)a.hd));
  const int G = a.H / a.KH;
  if (bwd)
    return run<BwdTc<HD>::THREADS>(mega_bwd_tc_kernel<HD>, a, st, q, k, v,
                      static_cast<const bf16*>(a.dout), a.lse, a.delta,
                      static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                      static_cast<bf16*>(dv), G, a.Sq, a.Sk, a.hd,
                      a.q_offset, a.causal, a.window, scale);
  return run<TC_NT>(mega_fwd_tc_kernel<HD>, a, st, q, k, v,
                    static_cast<bf16*>(o), lse, G, a.Sq, a.Sk, a.hd,
                    a.q_offset, a.causal, a.window, scale);
}

cudaError_t dispatch(int bwd, const MegaArgs& a, void* o, float* lse,
                     void* dq, void* dk, void* dv, int dtype,
                     cudaStream_t st) {
  if (a.B <= 0 || a.H <= 0 || a.Sq <= 0) return cudaSuccess;
  if (a.KH <= 0 || a.H % a.KH || a.Sk <= 0) return cudaErrorInvalidValue;
  if (dtype == 0 && a.hd == 64)
    return dispatch_rows<64>(bwd, a, o, lse, dq, dk, dv, st);
  if (dtype == 0 && a.hd == 128)
    return dispatch_rows<128>(bwd, a, o, lse, dq, dk, dv, st);
  if (dtype == 1 && a.hd % 8 == 0 && a.hd >= 8 && a.hd <= 128)
    return a.hd <= 64 ? launch_tc<64>(bwd, a, o, lse, dq, dk, dv, st)
                      : launch_tc<128>(bwd, a, o, lse, dq, dk, dv, st);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro

// dtype: 0 = float32 (CUDA cores, hd 64 or 128), 1 = bfloat16 (tensor
// cores, hd a multiple of 8 up to 128).  q, o (B,H,Sq,hd), k/v
// (B,KH,Sk,hd), all contiguous; lse (B,H,Sq) fp32, or null for the
// forward without it; rows the fp32 strip (8, 16 or 32) or the bf16 tile
// (64), and smem the block's dynamic shared memory,
// autotune.mega_smem_bytes (at most the opt-in maximum).  Returns the
// launch's cudaError_t.
extern "C" int repro_flash_mega_fwd(const void* q, const void* k,
                                    const void* v, void* o, void* lse, int B,
                                    int H, int KH, int Sq, int Sk, int hd,
                                    int q_offset, int causal, int window,
                                    int dtype, int rows, int smem,
                                    void* stream) {
  const repro::MegaArgs a{q,  k,  v,  nullptr, nullptr, nullptr,
                          B,  H,  KH, Sq,      Sk,      hd,
                          q_offset, causal, window, rows, smem, nullptr};
  return repro::dispatch(0, a, o, static_cast<float*>(lse), nullptr, nullptr,
                         nullptr, dtype, static_cast<cudaStream_t>(stream));
}

// As above plus dout (like q) and lse, delta (B,H,Sq) fp32; dq (like q),
// dk, dv (like k) are written once each.
extern "C" int repro_flash_mega_bwd(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq, void* dk, void* dv, int B,
                                    int H, int KH, int Sq, int Sk, int hd,
                                    int q_offset, int causal, int window,
                                    int dtype, int rows, int smem,
                                    void* stream) {
  const repro::MegaArgs a{q, k, v, dout, static_cast<const float*>(lse),
                          static_cast<const float*>(delta), B, H, KH, Sq,
                          Sk, hd, q_offset, causal, window, rows, smem,
                          nullptr};
  return repro::dispatch(1, a, nullptr, nullptr, dq, dk, dv, dtype,
                         static_cast<cudaStream_t>(stream));
}

// *blocks = the K4f (bwd = 0) or K4b blocks one SM holds at once with
// this strip or tile and shared memory, as the CUDA runtime's occupancy
// calculator gives it for the compiled kernel.
extern "C" int repro_flash_mega_occupancy(int bwd, int hd, int dtype,
                                          int rows, int smem, int* blocks) {
  const repro::MegaArgs a{nullptr, nullptr, nullptr, nullptr, nullptr,
                          nullptr, 1, 1, 1, 1, 1, hd, 0, 0, 0, rows, smem,
                          blocks};
  return repro::dispatch(bwd, a, nullptr, nullptr, nullptr, nullptr, nullptr,
                         dtype, nullptr);
}
